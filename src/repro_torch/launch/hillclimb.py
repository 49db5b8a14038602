"""Plan hillclimbing over the dry run (the port of
``repro/launch/hillclimb.py``).

Each named variant is a (config transform, plan transform) pair applied to
one of the chosen (arch x shape) pairs; the dry run (``launch/dryrun.py``)
traces it again and records the roofline terms, giving hypothesis ->
change -> before/after.  A variant the port cannot run (a plan its
``ParallelPlan`` or executor refuses, a trace that fails) is an ``error``
record with the refusal's message.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --pair qwen3 --variant baseline
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --all --out results/hillclimb.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs import get_config
from repro_torch.core.telemetry import sanitize_record
from repro_torch.launch.dryrun import default_plan, dryrun_one

# the chosen pairs: most collective-bound / worst useful-flops ratio /
# most representative of the paper's technique (dense Megatron TP + ZeRO-1)
PAIRS = {
    "arctic": ("arctic-480b", "train_4k"),
    "seamless": ("seamless-m4t-medium", "train_4k"),
    "qwen3": ("qwen3-32b", "train_4k"),
    "qwen3_decode": ("qwen3-32b", "decode_32k"),
    "llama4_prefill": ("llama4-maverick-400b-a17b", "prefill_32k"),
}


def _v(cfg_fn=None, plan_fn=None, note=""):
    return {"cfg": cfg_fn, "plan": plan_fn, "note": note}


VARIANTS = {
    "baseline": _v(note="paper-faithful megatron_tp + zero1, gas=1"),
    "pad_vocab256": _v(
        cfg_fn=lambda c: dataclasses.replace(c, vocab_pad_multiple=256),
        note="pad embedding/lm-head so vocab shards over model axis"),
    "ep_model": _v(
        plan_fn=lambda p: dataclasses.replace(
            p, rule_overrides=(("experts", "model"), ("expert_mlp", None))),
        note="expert parallelism over the model axis instead of data"),
    "embed_replicated": _v(
        plan_fn=lambda p: dataclasses.replace(
            p, rule_overrides=(("vocab", None),)),
        note="replicate the (small-vocab) embedding: kills gather all-reduces"),
    "ep_model+embed_repl": _v(
        plan_fn=lambda p: dataclasses.replace(
            p, rule_overrides=(("experts", "model"), ("expert_mlp", None),
                               ("vocab", None))),
        note="both expert-parallel-on-model and replicated embedding"),
    "fsdp": _v(
        plan_fn=lambda p: dataclasses.replace(p, rules="fsdp"),
        note="ZeRO-3/FSDP-style parameter sharding over data"),
    "gas4": _v(
        plan_fn=lambda p: dataclasses.replace(p, gas=4),
        note="4 gradient-accumulation microbatches (paper's GAS knob)"),
    "seq_shard": _v(
        plan_fn=lambda p: dataclasses.replace(
            p, rule_overrides=(("seq", "model"),)),
        note="sequence-parallel residual stream (Megatron-SP flavoured)"),
    "zero0": _v(
        plan_fn=lambda p: dataclasses.replace(p, zero=0),
        note="replicated optimizer states (paper's ZeRO-1 ablation)"),
    # MemoryPlan points: the ZeRO stage ladder (core/memplan.py) — each
    # step trades a collective pattern for 1/dp of a state class
    "zero2": _v(
        plan_fn=lambda p: dataclasses.replace(p, zero=2),
        note="ZeRO-2: fp32 grad accumulator sharded over data — each "
             "microbatch's gradient reduce-scattered into the rank's block "
             "instead of all-reducing full grads"),
    "zero3": _v(
        plan_fn=lambda p: dataclasses.replace(p, zero=3),
        note="ZeRO-3: every param leaf sharded over data on its first "
             "divisible free dim; each leaf all-gathered on use"),
    # CommPlan points (core/commplan.py): low-bandwidth zero=3 collectives
    "zero3_qcomm": _v(
        plan_fn=lambda p: dataclasses.replace(p, zero=3, qcomm="gather"),
        note="int8 block-quantized weight all-gathers: ~3.6x fewer bytes "
             "on the wire per gather (int8 payload + fp32 scale per block)"),
    "zero3_overlap": _v(
        plan_fn=lambda p: dataclasses.replace(p, zero=3, overlap=True),
        note="per-chunk weight gathers issued a chunk ahead of the "
             "layer stack's compute"),
    "zero3_qcomm_overlap": _v(
        plan_fn=lambda p: dataclasses.replace(p, zero=3, qcomm="gather",
                                              overlap=True),
        note="quantized + overlapped gathers combined"),
    # ExpertPlan points (core/expertplan.py): a real "expert" mesh axis with
    # capacity-factor token all-to-all dispatch — vs the rule-override
    # flavours above that re-map the experts logical axis onto model/data
    "ep2": _v(
        plan_fn=lambda p: dataclasses.replace(p, dp=8, ep=2),
        note="expert parallelism 2-way on a dedicated mesh axis: expert "
             "weights sharded E/2 per group, tokens all-to-all'd at "
             "capacity C (dp8 x ep2 x tp16 keeps 256 devices)"),
    "ep4": _v(
        plan_fn=lambda p: dataclasses.replace(p, dp=4, ep=4),
        note="4-way expert parallelism (dp4 x ep4 x tp16): E/4 experts "
             "resident per group, 4x less expert-weight memory per device"),
    "moe_dp_attn": _v(
        plan_fn=lambda p: dataclasses.replace(
            p, rule_overrides=(("heads", None), ("kv_heads", None),
                               ("mlp", None), ("act_heads", None),
                               ("act_mlp", None))),
        note="drop TP on attention/dense blocks (EP already shards the "
             "experts = the bulk of params); kills per-layer TP all-reduces"),
    "kv_int8": _v(
        cfg_fn=lambda c: dataclasses.replace(c, kv_quant=True),
        note="int8 KV cache with per-token/head scales (serving)"),
    "fsdp_seq": _v(
        plan_fn=lambda p: dataclasses.replace(
            p, rule_overrides=(("heads", None), ("kv_heads", None),
                               ("mlp", None), ("act_heads", None),
                               ("act_mlp", None), ("seq", "model"),
                               ("embed", "data"))),
        note="FSDP weight sharding (over data) + sequence-parallel "
             "activations (over model) — replaces Megatron TP entirely"),
    "moe_dp_attn+seq": _v(
        plan_fn=lambda p: dataclasses.replace(
            p, rule_overrides=(("heads", None), ("kv_heads", None),
                               ("mlp", None), ("act_heads", None),
                               ("act_mlp", None), ("seq", "model"))),
        note="dp attention + sequence sharded over the idle model axis"),
    # 3D plans: real (dp, tp, pp) points of the paper's search space, run
    # through the same executor
    "pp2_gas8": _v(
        plan_fn=lambda p: dataclasses.replace(p, pp=2, dp=16, tp=16, gas=8),
        note="2 pipeline stages x dp16 x tp16; gas=8 microbatches "
             "saturate the pipe (bubble 1/9)"),
    "pp4_gas8": _v(
        plan_fn=lambda p: dataclasses.replace(p, pp=4, dp=8, tp=16, gas=8),
        note="4 pipeline stages x dp8 x tp16 (deeper pipe, bubble 3/11)"),
    "pp2_v2": _v(
        plan_fn=lambda p: dataclasses.replace(p, pp=2, dp=16, tp=16, gas=8,
                                              virtual_stages=2),
        note="interleaved virtual staging: 4 logical stages round-robin "
             "on 2 ranks; the bubble shrinks to (p-1)/(v*m+p-1) a wave "
             "(core/bubble.py:wave_bubble_fraction) at the cost of 2x more, "
             "half-sized cross-stage transfers"),
    # ComputePolicy points: recompute policy x fused kernels (the compute-
    # path axis of the search space; see core/compute.py)
    "remat_selective": _v(
        plan_fn=lambda p: dataclasses.replace(p, remat="selective"),
        note="save the products without batch dims: the backward skips "
             "recomputing the heavy dots"),
    "remat_none": _v(
        plan_fn=lambda p: dataclasses.replace(p, remat="none"),
        note="no rematerialization: max memory, zero recompute — the fast "
             "point when it fits (compare memory_analysis peak)"),
    "remat_selective+gas4": _v(
        plan_fn=lambda p: dataclasses.replace(p, remat="selective", gas=4),
        note="selective recompute with 4 microbatches: GAS shrinks the live "
             "activation set, buying back selective's extra residency"),
    "kernels_fused": _v(
        plan_fn=lambda p: dataclasses.replace(p, kernels=True),
        note="the CUDA norm/MLP-gate/attention/CE kernels on the train path "
             "(a meta trace reaches no kernel: refused by the dry run)"),
}


def run_variant(pair: str, variant: str, out: str | None = None) -> dict:
    arch, shape = PAIRS[pair]
    spec = VARIANTS[variant]
    tag = f"{pair}:{variant}"
    try:
        cfg = get_config(arch)
        if spec["cfg"]:
            cfg = spec["cfg"](cfg)
        plan = default_plan(False)
        if spec["plan"]:
            plan = spec["plan"](plan)
    except Exception as e:          # a plan ParallelPlan refuses
        rec = {"arch": arch, "shape": shape, "status": "error", "tag": tag,
               "error": f"{type(e).__name__}: {e}"}
        print(f"[ERROR] {arch} x {shape} ({tag}): {e}")
    else:
        rec = dryrun_one(arch, shape, multi_pod=False, plan=plan, cfg=cfg, tag=tag)
    rec["variant"] = variant
    rec["note"] = spec["note"]
    if out and rec.get("status") == "ok":
        with open(out, "a") as f:
            f.write(json.dumps(sanitize_record(rec)) + "\n")
    elif out:
        with open(out, "a") as f:
            f.write(json.dumps(sanitize_record(
                {"pair": pair, "variant": variant,
                 "status": rec.get("status"),
                 "error": rec.get("error")})) + "\n")
    return rec


PLAN_MATRIX = {
    "qwen3": ["baseline", "pad_vocab256", "seq_shard", "gas4", "fsdp", "zero0",
              "zero2", "zero3", "zero3_qcomm", "zero3_overlap",
              "zero3_qcomm_overlap",
              "moe_dp_attn+seq", "fsdp_seq", "pp2_gas8", "pp4_gas8",
              "pp2_v2", "remat_selective", "remat_none",
              "remat_selective+gas4"],
    "qwen3_decode": ["baseline", "kv_int8"],
    "llama4_prefill": ["baseline", "seq_shard", "kv_int8"],
    # pp variants apply to every family: the encdec pair searches the
    # pipelined points too (arctic's 35 layers don't tile pp=2 — its plan
    # stays 2D)
    "seamless": ["baseline", "pad_vocab256", "embed_replicated",
                 "pp2_gas8"],
    "arctic": ["baseline", "ep_model", "embed_replicated", "ep_model+embed_repl",
               "pad_vocab256", "moe_dp_attn", "moe_dp_attn+seq", "seq_shard",
               "fsdp_seq", "ep2", "ep4"],
}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", choices=sorted(PAIRS), default=None)
    ap.add_argument("--variant", choices=sorted(VARIANTS), default="baseline")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.all:
        return [run_variant(pair, v, args.out)
                for pair, variants in PLAN_MATRIX.items() for v in variants]
    return [run_variant(args.pair or "qwen3", args.variant, args.out)]


if __name__ == "__main__":
    main()
