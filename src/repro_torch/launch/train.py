"""Training launcher (the plan flags of ``repro/launch/train.py``):
synthetic packed batches through ``build_train_step``, one line per logged
step with loss, grad_norm and tokens/s, and MFU against the ``--machine``
peak (the global step's FLOPs over the wall time x the peak x the ranks;
``core/telemetry.py``) on the card or when telemetry output is asked for.
Runs on the card unless ``--device cpu``.

Every step goes through ``core/telemetry.py:Telemetry``: ``--log-jsonl
PATH`` writes its records (one compile record, then a step record each:
MFU, the drift against ``costmodel.predict_step``, on a card the peak
memory, under a mesh the collective bytes, at pp > 1 the measured idle
share of the pipeline),
``--trace PATH`` the pipeline timeline of the run
(``analysis/trace.py``).  Rank 0 writes both; each rank's peak memory (and
pipeline sweep times) reaches it by one gather at the end of a logged
step.  The records are appended to PATH: remove it before a rerun.
``python -m repro_torch.analysis.report --telemetry PATH`` renders the
records.  ``--ckpt-dir DIR`` resumes from the latest checkpoint in DIR
(``checkpointing/checkpoint.py``, the reference's format; under a mesh the
blocks of any plan's save) and saves every ``--ckpt-every`` steps; the
resumed run skips the batches the restored steps took, so it continues the
uninterrupted run's data.

Under ``torchrun`` / ``python -m torch.distributed.run`` (one process per
rank; nccl on the cards, gloo with ``--device cpu``) it runs the sharded
executor over a (pp, dp, tp) mesh: ``--pp`` (the gas microbatches are the
pipeline's), ``--virtual-stages``, ``--dp``, ``--tp``, ``--zero`` 0-3 and
``--rules``; rank 0 prints.  pp x dp x tp must be the number of ranks.
``--tp`` splits the heads and the MLP of every family (the moe family's
expert MLPs on their d_ff); ``--ep`` splits the moe family's experts over
an expert axis (the mesh is then (pp, dp, ep, tp), the batch's rows over
data then expert; with ``--reduced`` the expert count is kept divisible by
ep, as the reference's launcher keeps it); ``--rules tp_only`` keeps the
batch off the data axis (every data rank takes the whole batch).  The moe
family's step line also carries ``moe_aux`` and ``moe_drop`` (and the step
records carry them).  The CommPlan (``runtime/qcollect.py``): ``--node``
leads the mesh with a node axis (rows split over node, then data; the ZeRO
gathers and reduce-scatters in an inter-node and an intra-node phase),
``--qcomm gather|both`` and ``--comm-block`` quantize the ZeRO 3 weight
gathers to int8 blocks, ``--overlap`` issues each chunk of layers' gathers
a chunk ahead; node x pp x dp x ep x tp must be the number of ranks.
Every plan but qcomm and every ``--remat`` prints the same losses as one
device (qcomm within a few per cent: the forward sees int8-rounded
weights).  The encdec family's batches carry synthetic ``frames``
(enc_seq_len, frontend_dim) a row beside the tokens (``extra_specs``); at
pp > 1 every pipe rank encodes them (``runtime/pipeline.py``).  The vlm
family's carry ``patches`` (num_patches, frontend_dim) a row, projected
and prepended to the text on pipe rank 0:

  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \
      --device cpu --arch yi-6b --reduced --dp 2 --tp 2 --zero 3 --precision fp32
  python -m torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.train \
      --device cpu --arch zamba2-2.7b --reduced --layers 4 --tp 2 --precision fp32
  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \
      --device cpu --arch yi-6b --reduced --pp 2 --dp 2 --gas 2 --precision fp32
  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \
      --device cpu --arch arctic-480b --reduced --ep 2 --dp 2 --gas 2 --precision fp32
  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \
      --device cpu --arch yi-6b --reduced --node 2 --dp 2 --zero 3 --qcomm gather \
      --overlap --gas 2 --precision fp32
  python -m torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.train \
      --device cpu --arch seamless-m4t-medium --reduced --layers 4 --pp 2 --gas 2 \
      --precision fp32
  python -m torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.train \
      --device cpu --arch internvl2-2b --reduced --layers 4 --pp 2 --gas 2 \
      --precision fp32
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch yi-6b --dp 4 --zero 3 --steps 5 --global-batch 8 --gas 2 \
      --seq-len 2048 --precision bf16 --kernels

One device, without a launcher:

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --layers 8 \
      --steps 5 --global-batch 8 --gas 2 --seq-len 2048 --precision bf16 --kernels
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-1.4b \
      --steps 5 --global-batch 8 --gas 2 --seq-len 2048 --precision bf16 --kernels
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
      --steps 5 --global-batch 8 --gas 2 --seq-len 2048 --precision bf16 --kernels
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch yi-6b \
      --reduced --steps 5 --global-batch 4 --seq-len 32 --precision fp32 \
      --remat selective --log-jsonl build/run.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpointing import (latest_step, restore_checkpoint, save_checkpoint,
                                       state_shardings)
from repro_torch.configs import ASSIGNED, PAPER, get_config
from repro_torch.core import telemetry
from repro_torch.data import SyntheticCorpus, make_batch_iterator
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.launch.mesh import init_distributed, mesh_for_plan
from repro_torch.runtime import collectives, pipeline
from repro_torch.runtime.train_loop import (ParallelPlan, build_model, build_train_step,
                                            init_train_state, train_state_bytes)


def rank_readings(device: torch.device, world: int, pipelined: bool) -> list[dict]:
    """Each rank's peak device memory since the last reset (0 off a card)
    and, when ``pipelined``, its last pipeline sweep
    (``runtime/pipeline.py:walk_reading``; zeros otherwise), on every rank:
    one all-gather over the default group (none at world 1)."""
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    w = (pipeline.walk_reading() if pipelined
         else {"applications": 0, "busy_s": 0.0, "wall_s": 0.0})
    mine = torch.tensor([peak, w["applications"], round(w["busy_s"] * 1e9),
                         round(w["wall_s"] * 1e9)], dtype=torch.int64, device=device)
    rows = [mine]
    if world > 1:
        rows = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(rows, mine)
    return [{"peak": r[0], "applications": r[1], "busy_s": r[2] / 1e9, "wall_s": r[3] / 1e9}
            for r in (row.tolist() for row in rows)]


def step_extras(plan: ParallelPlan, device: torch.device, world: int, sharded: bool,
                gather: bool = True) -> dict:
    """The telemetry fields of a step beyond its metrics: under a mesh
    (``sharded``) the collective bytes this rank moved; with ``gather``
    every rank's peak memory (on a card) and at pp > 1 the measured
    pipeline (one gather), else this rank's peak alone."""
    out = {}
    if sharded:
        out["comm_bytes"] = collectives.comm_bytes()
    if gather:
        ranks = rank_readings(device, world, plan.pp > 1)
        if device.type == "cuda":
            out["peak_bytes"] = [r["peak"] for r in ranks]
        if plan.pp > 1:
            out["pipeline"] = telemetry.pipeline_fields(
                plan.pp, plan.gas, plan.virtual_stages, ranks)
    elif device.type == "cuda":
        out["peak_bytes"] = [torch.cuda.max_memory_allocated(device)]
    return out


def extra_specs(cfg) -> dict | None:
    """The family's dense inputs a row, as the reference's launcher makes
    them: the encdec family's synthetic ``frames`` (enc_seq_len,
    frontend_dim) fp32, the vlm family's ``patches`` (num_patches,
    frontend_dim) fp32."""
    if cfg.family == "encdec":
        return {"frames": ((cfg.enc_seq_len, cfg.frontend_dim), np.float32)}
    if cfg.family == "vlm":
        return {"patches": ((cfg.num_patches, cfg.frontend_dim), np.float32)}
    return None


def draw_extras(cfg, rng: np.random.RandomState) -> dict | None:
    """One request's :func:`extra_specs` inputs, each 0.1 x a standard
    normal of its shape from ``rng``, as the reference's serve launcher
    draws them; None for a family with none."""
    specs = extra_specs(cfg)
    if specs is None:
        return None
    return {k: 0.1 * rng.randn(*shape).astype(dtype) for k, (shape, dtype) in specs.items()}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ASSIGNED + PAPER), default="yi-6b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant of the architecture")
    ap.add_argument("--layers", type=int, default=None, help="override n_layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--gas", type=int, default=1)
    ap.add_argument("--precision", choices=["bf16", "fp16", "fp32"], default="fp32")
    ap.add_argument("--remat", choices=["full", "selective", "none"], default="full",
                    help="full = save layer boundaries only; selective = also save "
                         "the products without batch dims; none = save everything")
    ap.add_argument("--kernels", action="store_true",
                    help="the norms (RMSNorm or LayerNorm), the MLP input half "
                         "(SwiGLU or GELU), attention, the grouped expert MLP, the "
                         "SSD and wkv scans and CE in the CUDA kernels")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel ranks")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks")
    ap.add_argument("--pp", type=int, default=1, help="pipeline ranks")
    ap.add_argument("--ep", type=int, default=1,
                    help="expert-parallel ranks (the moe family's experts split over "
                         "them, tokens moved by an all-to-all); ep must divide n_experts")
    ap.add_argument("--virtual-stages", type=int, default=1,
                    help="logical stages per pipeline rank (interleaved)")
    ap.add_argument("--zero", type=int, choices=[0, 1, 2, 3], default=None,
                    help="ZeRO stage (default 1)")
    ap.add_argument("--rules", default="megatron_tp",
                    choices=["megatron_tp", "fsdp", "dp_only", "tp_only"])
    ap.add_argument("--qcomm", choices=["none", "gather", "both"], default="none",
                    help="CommPlan quantized collectives (zero=3 only): gather = int8 "
                         "block-quantize the weight all-gathers; both = also "
                         "fake-quantize the gradient's reduce-scattered block")
    ap.add_argument("--comm-block", type=int, default=32,
                    help="qcomm quantization block size (last-dim elements per int8 "
                         "scale group)")
    ap.add_argument("--overlap", action="store_true",
                    help="overlap zero=3 per-chunk weight gathers with the layer-stack "
                         "compute (pp=1 only)")
    ap.add_argument("--node", type=int, default=1,
                    help="hierarchical node axis ways: ZeRO gathers and reduce-scatters "
                         "split into inter-node + intra-node phases over a (node, pipe, "
                         "data, model) mesh")
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from the latest checkpoint here and save every "
                         "--ckpt-every steps (checkpointing/checkpoint.py)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-jsonl", default=None, metavar="PATH",
                    help="write the telemetry records (core/telemetry.py) here")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the pipeline timeline (analysis/trace.py) here")
    ap.add_argument("--machine", choices=sorted(telemetry.MACHINES), default="h100",
                    help="the peak MFU is read against and the drift's costmodel machine")
    ap.add_argument("--drift-threshold", type=float, default=10.0,
                    help="warn when the rolling measured/predicted step time leaves "
                         "[1/x, x] (with telemetry output only)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    overrides = {"n_layers": args.layers} if args.layers else {}
    cfg = (cfg.reduced(ep=args.ep, **overrides) if args.reduced
           else dataclasses.replace(cfg, **overrides))
    plan = ParallelPlan(dp=args.dp, tp=args.tp, pp=args.pp, ep=args.ep, node=args.node,
                        virtual_stages=args.virtual_stages, zero=args.zero, rules=args.rules,
                        qcomm=args.qcomm, overlap=args.overlap, comm_block=args.comm_block,
                        gas=args.gas, precision=args.precision, remat=args.remat,
                        kernels=args.kernels)
    mesh, world, rank0 = None, 1, True
    if "WORLD_SIZE" in os.environ:             # a torch.distributed launcher's rank
        init_distributed(device)
        mesh = mesh_for_plan(plan, device)
        model = build_model(cfg, plan, mesh)
        device, world, rank0 = model.device, dist.get_world_size(), dist.get_rank() == 0
    elif plan.n_devices > 1:
        raise SystemExit(f"node x pp x dp x ep x tp = {plan.n_devices} ranks: run under "
                         "torchrun / python -m torch.distributed.run")
    else:
        model = Model(cfg, torch.float32, device=device)
    say = print if rank0 else (lambda *a, **k: None)
    say(f"arch={cfg.name} params={model.n_params():,} device={device} ranks={world} "
        f"{f'node={plan.node} ' if plan.node > 1 else ''}"
        f"pp={plan.pp} v={plan.virtual_stages} dp={plan.dp} "
        f"{f'ep={plan.ep} ' if plan.ep > 1 else ''}tp={plan.tp} "
        f"zero={plan.zero if mesh else '-'} "
        f"{f'qcomm={plan.qcomm} ' if plan.qcomm != 'none' else ''}"
        f"{'overlap ' if plan.overlap else ''}"
        f"gas={plan.gas} precision={plan.precision} remat={plan.remat} "
        f"kernels={plan.kernels}", flush=True)
    opt = AdamWConfig(lr=cosine_schedule(args.lr, 10, args.steps))
    state = init_train_state(model, opt, plan,
                             torch.Generator(device=device).manual_seed(args.seed))
    start, shardings = 0, state_shardings(model, plan)
    if args.ckpt_dir and (s := latest_step(args.ckpt_dir)) is not None:
        state = restore_checkpoint(args.ckpt_dir, s, state, shardings)
        start = s
        say(f"restored step {s} from {args.ckpt_dir}", flush=True)
    step_fn = build_train_step(model, opt, plan, mesh)
    it = make_batch_iterator(SyntheticCorpus(vocab_size=cfg.vocab_size, seed=args.seed),
                             seq_len=args.seq_len, global_batch=args.global_batch,
                             extra_specs=extra_specs(cfg))
    for _ in range(start):                     # the batches the restored steps took
        next(it)
    tele_on = bool(args.log_jsonl or args.trace)
    tele = telemetry.Telemetry(
        cfg, plan, args.global_batch, args.seq_len, machine=args.machine,
        jsonl=args.log_jsonl if rank0 else None,
        drift_threshold=args.drift_threshold if tele_on and rank0 else float("inf"))
    on_card = device.type == "cuda"
    records = []
    t_start = time.perf_counter()
    for i in range(start, args.steps):
        batch = next(it)
        collectives.reset_comm_bytes()
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        (state, metrics), wall = telemetry.timed_call(step_fn, state, batch)
        if i == start:
            tele.record_compile(device=device, devices=world,
                                state_bytes=train_state_bytes(cfg, plan),
                                compile_s=time.perf_counter() - t_start)
        logged = (i + 1) % args.log_every == 0 or i + 1 == args.steps
        extra = step_extras(plan, device, world, mesh is not None, gather=logged)
        rec = tele.step(i + 1, wall, metrics, **extra)
        out = {"step": rec["step"], "loss": rec["loss"], "grad_norm": rec["grad_norm"],
               "wall_s": wall, "tokens_per_s": rec["tokens_per_s"]}
        if on_card:
            out["mfu"] = rec["mfu"]
        moe = ""
        if cfg.family == "moe":
            out.update(moe_aux=rec["moe_aux"], moe_drop=rec["moe_drop"])
            moe = f" moe_aux {rec['moe_aux']:.4f} moe_drop {rec['moe_drop']:.4f}"
        records.append(out)
        if logged:
            say(tele.console_line(rec, with_mfu=on_card or tele_on) + moe, flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1, state, shardings)
    if args.trace and rank0:
        from repro_torch.analysis import trace as trace_mod
        tr = trace_mod.build_trace(plan.pp, plan.gas, plan.virtual_stages, tele.step_walls,
                                   meta={"arch": cfg.name, "plan": telemetry.plan_dict(plan)})
        trace_mod.write_trace(tr, args.trace)
        say(f"wrote pipeline trace to {args.trace} ({len(tr['traceEvents'])} events)")
    tele.close()
    if mesh is not None:
        dist.destroy_process_group()
    return records


if __name__ == "__main__":
    main()
