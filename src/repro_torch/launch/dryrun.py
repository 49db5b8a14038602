"""Dry run: trace every (architecture x input shape) on the production plans
without the ranks, and read what one rank computes, moves and holds (the
port of ``repro/launch/dryrun.py``).

The reference lowers and compiles its step for 256 or 512 virtual XLA
devices and reads the compiled module.  The port runs its own step once,
on the meta device (shapes and dtypes, no data), as rank 0 of a
``torch.distributed`` group on the "fake" backend of ``plan.n_devices``
ranks (its collectives return at once), and counts per rank:

  * ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``'s
    total (the products and attention);
  * ``bytes_per_device``: every op's input and output bytes, views and the
    collectives aside (:class:`TraceCounter`), the analogue of
    the reference's HLO traffic;
  * ``collective_bytes`` and ``comm_bytes``: the executor's own counters
    (``runtime/collectives.py:comm_bytes``), ``comm_bytes`` by the port's
    kinds and ``collective_bytes`` under the reference's kind names;
  * ``memory_analysis.peak_bytes``: the peak of the live storage bytes, the
    state and batch the step starts from included (:class:`TraceCounter`);
  * ``trace_s``, the seconds the trace took.

``roofline`` prices the three counts on the H100 (``analysis/roofline.py``).
The analytic fields of a train shape (``tokens``, ``state_bytes``,
``activation_bytes_estimate``, ``flops_per_step``, ``predicted``, for the moe
family ``moe_drop_predicted`` and ``moe_drop_measured``, ``model_flops``)
are the reference's.

Plans: the production plan is dp 16 x tp 16 ("16x16", 256 ranks), or
dp 32 x tp 16 with ``--multi-pod`` ("2x16x16", 512 ranks: the pod folds
into dp); ``--pp/--dp/--tp/--ep/--node/--zero/--gas/--qcomm/--overlap/
--virtual-stages`` build an explicit one.  A plan the executor refuses is a
``status: "error"`` record with the refusal's message.  Prefill and decode
shapes trace the dp serve engine's path, the only one the port serves:
whole weights on a rank and ceil(global_batch / chips) rows (``"plan":
"dp"``; the plan's tp, pp and ZeRO do not apply, and its rule_overrides
are refused, as the engine refuses them).  The trace refuses
``kernels=True``: a meta tensor reaches no kernel, and the plain versions'
memory is not the kernels'.

``--measure`` runs a one-rank record's plan for real on the card (kernels
as the plan says) for 3 steps and adds ``measured``: the peak of
``torch.cuda.max_memory_allocated``, the median step seconds and the FLOPs
``FlopCounterMode`` counts in one real step, with the card's name and power
limit.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_single.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --arch yi-6b --layers 8 --shape train_4k \\
      --dp 1 --tp 1 --gas 2 --global-batch 8 --seq-len 2048 --measure      # on a card
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import time
import traceback
import weakref
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import roofline as rl
from repro_torch.configs import ASSIGNED, PAPER, get_config
from repro_torch.configs.shapes import SHAPES, InputShape, applicable
from repro_torch.core import compute as cmp
from repro_torch.core import costmodel as cm
from repro_torch.core import expertplan as epl
from repro_torch.core import telemetry as tel
from repro_torch.launch.mesh import BACKEND, mesh_for_plan
from repro_torch.launch.train import extra_specs
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import collectives
from repro_torch.runtime.collectives import MeshGroups
from repro_torch.runtime.serve_loop import build_decode_step
from repro_torch.runtime.train_loop import (ParallelPlan, build_model, build_train_step,
                                            init_train_state, train_state_bytes)

META = torch.device("meta")
MEASURE_STEPS = 3
# the port's collective kinds under the reference's (analysis/hlo_cost.py) names
REF_KIND = {"all-reduce": "all-reduce", "all-gather": "all-gather",
            "zero3_gather": "all-gather", "pipe_gather": "all-gather",
            "reduce-scatter": "reduce-scatter", "pipe_scatter": "reduce-scatter",
            "send": "collective-permute", "all-to-all": "all-to-all",
            "all-to-all-mask": "all-to-all"}
# the collectives' namespace: their bytes are the executor's counters'
_COLLECTIVES = "c10d"


def default_plan(multi_pod: bool, *, zero: int | None = None, gas: int = 1,
                 rules: str = "megatron_tp") -> ParallelPlan:
    """The production plan: dp 16 x tp 16, the second pod's 256 ranks on
    dp (dp 32) with ``multi_pod``; bf16 over fp32 masters, kernels off."""
    return ParallelPlan(dp=32 if multi_pod else 16, tp=16, rules=rules, zero=zero, gas=gas,
                        precision="bf16")


def plan_mesh_name(plan: ParallelPlan, multi_pod: bool = False) -> str:
    ep = plan.ep
    if plan.node > 1:
        ep_s = f"xep{ep}" if ep > 1 else ""
        return f"node{plan.node}x{plan.pp}x{plan.dp}{ep_s}x{plan.tp}"
    if ep > 1:
        return f"pipe{plan.pp}x{plan.dp}xep{ep}x{plan.tp}"
    if plan.pp > 1:
        return f"pipe{plan.pp}x{plan.dp}x{plan.tp}"
    if multi_pod and plan.dp % 2 == 0:
        return f"2x{plan.dp // 2}x{plan.tp}"
    return f"{plan.dp}x{plan.tp}"


class TraceCounter(TorchDispatchMode):
    """Counts, over the ops dispatched while it is on, the bytes they read
    and write (``bytes``: each op's input and output tensors, views and the
    collectives aside) and the peak of the live storage bytes
    (``peak``).  A storage is live from the first op that makes a tensor on
    it (or :meth:`hold`) until the last such tensor dies, views counted
    once; a tensor autograd saves for the backward keeps its Python object,
    and so its storage, alive until the graph frees it.  A data-dependent
    read (``bool`` or ``.item()`` of a meta tensor) returns True for a
    bool, else 1: the trace takes the finite-gradient branch of the step."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, list] = {}      # storage id -> [bytes, tensors]
        self._tensors: dict[int, int] = {}        # tensor id -> storage id

    def hold(self, tensors) -> None:
        """Count tensors made before the trace (the state, the batch)."""
        for t in tensors:
            if isinstance(t, torch.Tensor):
                self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        if id(t) in self._tensors:
            return
        st = t.untyped_storage()
        key = st._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [st.nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        self._tensors[id(t)] = key
        weakref.finalize(t, self._release, id(t), key)

    def _release(self, tid: int, key: int) -> None:
        del self._tensors[tid]
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            return True if args[0].dtype == torch.bool else 1
        out = func(*args, **kwargs)
        outs = [t for t in torch.utils._pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func.namespace != _COLLECTIVES and not func.is_view:
            ins = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


def _state_tensors(tree: Any) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _state_tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _batch(cfg, rows: int, seq: int, device: torch.device) -> dict:
    """A train or prefill batch of ``rows`` rows (random on a card, empty on
    meta), with the family's dense inputs (``launch/train.py:extra_specs``)."""
    specs = {"tokens": ((seq,), np.int32), **(extra_specs(cfg) or {})}
    out = {}
    for k, (shape, dtype) in specs.items():
        dt = torch.int32 if dtype == np.int32 else torch.float32
        if device.type == "meta":
            out[k] = torch.empty((rows, *shape), dtype=dt, device=device)
        elif dt == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, (rows, *shape), dtype=dt, device=device)
        else:
            out[k] = 0.1 * torch.randn((rows, *shape), device=device)
    return out


def _program(cfg, shape: InputShape, plan: ParallelPlan, chips: int, device: torch.device):
    """(one step of the record's program as a callable, the tensors it
    starts from).  A train shape runs ``build_train_step`` (over the plan's
    mesh of ``chips`` ranks, or unsharded at one rank), a prefill or decode
    shape the dp engine's model on its rows of the batch."""
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(0)
    if shape.kind == "train":
        opt = AdamWConfig()
        if chips > 1:
            mesh = mesh_for_plan(plan, device)
            model, mesh_arg = build_model(cfg, plan, mesh), mesh
        else:
            model, mesh_arg = Model(cfg, torch.float32, device=device), None
        state = init_train_state(model, opt, plan, gen)
        step = build_train_step(model, opt, plan, mesh_arg)
        batch = _batch(cfg, shape.global_batch, shape.seq_len, device)
        return (lambda: step(state, batch)), _state_tensors(state) + list(batch.values())
    if plan.rule_overrides:
        raise NotImplementedError("serving takes no rule_overrides: the dp engine holds "
                                  "whole weights and each rank's rows "
                                  "(runtime/serve_loop.py:serve_mesh)")
    rows = math.ceil(shape.global_batch / chips)
    model = Model(cfg, torch.bfloat16, compute=plan.compute_policy(), device=device).init(gen)
    weights = list(model.parameters())
    if shape.kind == "prefill":
        batch = _batch(cfg, rows, shape.seq_len, device)

        def prefill():
            with torch.no_grad():
                return model.prefill(batch, shape.seq_len)
        return prefill, weights + list(batch.values())
    cache = model.init_cache(rows, shape.seq_len)
    tick = {"token": torch.zeros((shape.global_batch, 1), dtype=torch.int32, device=device)}
    if cfg.family == "encdec":
        tick["memory"] = torch.zeros((shape.global_batch, cfg.enc_seq_len, cfg.d_model),
                                     dtype=torch.bfloat16, device=device)
    if chips > 1:
        dp = ParallelPlan(dp=chips, zero=0)
        step = build_decode_step(model, MeshGroups.from_mesh(mesh_for_plan(dp, device)),
                                 rows=slice(0, rows))
    else:
        step = build_decode_step(model)
    return (lambda: step(cache, tick)), weights + _state_tensors(cache) + list(tick.values())


def trace_record(cfg, shape: InputShape, plan: ParallelPlan, chips: int) -> dict:
    """The traced fields of one step of the record's program on the meta
    device, as rank 0 of a fake group of ``chips`` ranks when ``chips`` > 1
    (created here and destroyed before returning)."""
    if plan.kernels:
        raise ValueError("kernels=True: a meta tensor reaches no CUDA kernel, and the plain "
                         "versions' memory is not the kernels'; trace with kernels off "
                         "(--measure runs the plan's kernels on a card)")
    if chips > 1 and dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; a default "
                           "group exists already")
    t0 = time.perf_counter()
    if chips > 1:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group(BACKEND["meta"], store=FakeStore(), rank=0, world_size=chips)
    try:
        run, held = _program(cfg, shape, plan, chips, META)
        counter = TraceCounter()
        counter.hold(held)
        del held
        collectives.reset_comm_bytes()
        with FlopCounterMode(display=False) as flops, counter:
            out = run()
        del out
        comm = collectives.comm_bytes()
    finally:
        if chips > 1:
            dist.destroy_process_group()
    coll: dict[str, float] = {}
    for kind, b in comm.items():
        if kind != "total" and b:
            coll[REF_KIND[kind]] = coll.get(REF_KIND[kind], 0.0) + float(b)
    return {"flops_per_device": float(flops.get_total_flops()),
            "bytes_per_device": float(counter.bytes),
            "collective_bytes": coll,
            "comm_bytes": {k: float(v) for k, v in comm.items()},
            "collective_bytes_total": float(comm["total"]),
            "memory_analysis": {"peak_bytes": counter.peak},
            "trace_s": time.perf_counter() - t0}


def card_identity() -> str:
    """``nvidia-smi``'s name and power limit of the card, or what failed."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def measure_record(cfg, shape: InputShape, plan: ParallelPlan) -> dict:
    """The record's program for real on the card (one rank, kernels as the
    plan says), ``MEASURE_STEPS`` steps: the peak allocated bytes over them
    (from the state the first starts from), the median step seconds and
    ``FlopCounterMode``'s FLOPs of the first."""
    if plan.n_devices != 1:
        raise ValueError(f"--measure runs one rank; this plan has {plan.n_devices}")
    device = torch.device("cuda", torch.cuda.current_device())
    run, held = _program(cfg, shape, plan, 1, device)
    del held
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    secs = []
    flops = 0.0
    for i in range(MEASURE_STEPS):
        t0 = time.perf_counter()
        if i == 0:
            with FlopCounterMode(display=False) as fc:
                run()
            flops = float(fc.get_total_flops())
        else:
            run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return {"peak_bytes": torch.cuda.max_memory_allocated(device),
            "step_s": float(np.median(secs)), "step_s_all": secs, "flops": flops,
            "steps": MEASURE_STEPS, "card": card_identity()}


def dryrun_one(arch: str, shape: str | InputShape, *, multi_pod: bool,
               plan: ParallelPlan | None = None, verbose: bool = True,
               cfg=None, tag: str = "", measure: bool = False) -> dict:
    """One record: ``skipped`` where ``applicable`` says so, ``error`` (with
    the refusal's message) where a plan is refused or the trace fails, else
    ``ok`` with the analytic and traced fields (and ``measured`` with
    ``measure``)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    ok, reason = applicable(cfg, shape)
    mesh_name = plan_mesh_name(plan or default_plan(multi_pod), multi_pod)
    if not ok:
        if verbose:
            print(f"[skip] {arch} x {shape.name} ({mesh_name}): {reason}")
        return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    try:
        plan = plan or default_plan(multi_pod)
        chips = plan.n_devices
        rec: dict[str, Any] = {
            "schema": tel.SCHEMA, "arch": arch, "shape": shape.name, "chips": chips,
            "mesh": mesh_name, "kind": shape.kind,
            "plan": (plan.rules + (f"+zero{plan.zero}" if plan.zero else "")
                     if shape.kind == "train" else "dp"),
            "zero": plan.zero, "gas": plan.gas, "remat": plan.remat,
            "kernels": plan.kernels, "node": plan.node, "qcomm": plan.qcomm,
            "overlap": plan.overlap, "ep": plan.ep}
        if tag:
            rec["tag"] = tag
        if shape.kind == "train":
            rec["tokens"] = shape.global_batch * shape.seq_len
            rec["activation_bytes_estimate"] = cmp.activation_bytes_estimate(
                cfg, shape.global_batch, shape.seq_len, plan.compute_policy(),
                dp=plan.node * plan.dp, tp=plan.tp, pp=plan.pp, gas=plan.gas)
            rec["state_bytes"] = train_state_bytes(cfg, plan)
            rec["flops_per_step"] = cm.train_step_flops(
                cfg, shape.global_batch, shape.seq_len).total
            try:
                rec["predicted"] = tel.predicted_block(cm.predict_step(
                    cfg, plan, shape.global_batch, shape.seq_len))
            except Exception:           # the reference's record keeps an empty block
                rec["predicted"] = {}
            if cfg.family == "moe":
                _, g = moe_mod.group_shape(shape.global_batch, shape.seq_len)
                rec["moe_drop_predicted"] = epl.predicted_drop_fraction(
                    cfg.top_k, cfg.n_experts, cfg.capacity_factor, g)
                rec["moe_drop_measured"] = moe_mod.simulated_drop_fraction(
                    cfg, shape.global_batch, shape.seq_len)
        else:
            rec["tokens"] = shape.global_batch * (shape.seq_len if shape.kind == "prefill"
                                                  else 1)
        traced = trace_record(cfg, shape, plan, chips)
        flops = traced["flops_per_device"]
        terms = rl.roofline_terms(flops, traced["bytes_per_device"],
                                  traced["collective_bytes_total"], chips)
        mf = rl.model_flops(cfg, tokens=rec["tokens"], kind=shape.kind)
        rec.update(status="ok", **traced, roofline=terms.as_dict(), model_flops=mf,
                   useful_flops_ratio=(mf / (flops * chips)) if flops else None)
        if measure:
            rec["measured"] = measure_record(cfg, shape, plan)
        if verbose:
            peak = traced["memory_analysis"]["peak_bytes"]
            sb = rec.get("state_bytes")
            sb_s = (f" | zero{sb['zero']}: param {sb['param_bytes']/1e9:.2f}GB "
                    f"grad {sb['grad_bytes']/1e9:.2f}GB opt {sb['opt_bytes']/1e9:.2f}GB"
                    if sb else "")
            useful = rec["useful_flops_ratio"]
            print(f"[ok] {arch} x {shape.name} ({mesh_name}): trace {traced['trace_s']:.1f}s | "
                  f"compute {terms.compute_s*1e3:.2f}ms mem {terms.memory_s*1e3:.2f}ms "
                  f"coll {terms.collective_s*1e3:.2f}ms -> {terms.dominant}-bound | "
                  f"useful-flops ratio {useful and round(useful, 3)} | "
                  f"peak {peak/1e9:.2f}GB{sb_s}")
            if measure:
                m = rec["measured"]
                print(f"     measured on {m['card']}: peak {m['peak_bytes']/1e9:.3f}GB "
                      f"(traced {peak/1e9:.3f}GB), FLOPs {m['flops']:.4g} (traced {flops:.4g}), "
                      f"median step {m['step_s']:.4f}s")
    except Exception as e:
        rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()}
        if verbose:
            print(f"[ERROR] {arch} x {shape.name} ({mesh_name}): {e}")
    return rec


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(set(ASSIGNED + PAPER) | {"all"}), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES) + ["all"], default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all archs x shapes (single-pod unless --both-meshes)")
    ap.add_argument("--pp", type=int, default=1, help="pipeline stages")
    ap.add_argument("--virtual-stages", type=int, default=1,
                    help="interleaved virtual stages per pipe rank (pp>1)")
    ap.add_argument("--gas", type=int, default=1,
                    help="microbatches (= pipeline in-flight count when pp>1)")
    ap.add_argument("--zero", type=int, choices=(0, 1, 2, 3), default=None,
                    help="ZeRO stage (default 1); the record's state_bytes shows the shrink")
    ap.add_argument("--dp", type=int, default=None,
                    help="data-parallel ways of an explicit plan (default 16)")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel ways of an explicit plan (default 16)")
    ap.add_argument("--node", type=int, default=1, help="hierarchical node-axis ways")
    ap.add_argument("--ep", type=int, default=1, help="expert-parallel ways (moe only)")
    ap.add_argument("--qcomm", choices=("none", "gather", "both"), default="none",
                    help="int8 block-quantized zero=3 collectives")
    ap.add_argument("--overlap", action="store_true",
                    help="overlap zero=3 weight gathers with compute (pp=1)")
    ap.add_argument("--layers", type=int, default=None, help="override n_layers")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="override the shape's global batch")
    ap.add_argument("--seq-len", type=int, default=None, help="override the shape's seq len")
    ap.add_argument("--measure", action="store_true",
                    help="also run a one-rank plan for 3 steps on the card")
    ap.add_argument("--out", default=None, help="append JSON records here")
    args = ap.parse_args(argv)

    archs = (ASSIGNED if (args.all or args.arch in (None, "all")) else [args.arch])
    shapes = sorted(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    explicit_plan = (args.pp > 1 or args.gas > 1 or args.virtual_stages > 1
                     or args.dp is not None or args.tp is not None
                     or args.zero is not None or args.node > 1 or args.ep > 1
                     or args.qcomm != "none" or args.overlap)

    def plan_for(mp: bool):
        if not explicit_plan:
            return None                 # default_plan(mp) inside dryrun_one
        pod = 2 if (mp and args.pp == 1) else 1     # the pod folds into dp
        return ParallelPlan(dp=(16 if args.dp is None else args.dp) * pod,
                            tp=16 if args.tp is None else args.tp, pp=args.pp, ep=args.ep,
                            node=args.node, qcomm=args.qcomm, overlap=args.overlap,
                            virtual_stages=args.virtual_stages, gas=args.gas,
                            precision="bf16", zero=args.zero)

    records = []
    for arch in archs:
        cfg = get_config(arch)
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        for name in shapes:
            shape = dataclasses.replace(
                SHAPES[name], global_batch=args.global_batch or SHAPES[name].global_batch,
                seq_len=args.seq_len or SHAPES[name].seq_len)
            for mp in meshes:
                try:
                    plan = plan_for(mp)
                except (ValueError, NotImplementedError) as e:   # refused: an error record
                    rec = {"arch": arch, "shape": name, "mesh": "?", "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                    print(f"[ERROR] {arch} x {name}: {rec['error']}")
                else:
                    rec = dryrun_one(arch, shape, multi_pod=mp, plan=plan, cfg=cfg,
                                     measure=args.measure)
                records.append(rec)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(tel.sanitize_record(rec)) + "\n")
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
