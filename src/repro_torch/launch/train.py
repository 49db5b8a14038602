"""Training launcher (the plan flags of ``repro/launch/train.py``):
synthetic packed batches through ``build_train_step``, one line per logged
step with loss, grad_norm, tokens/s and MFU against the H100's bf16 peak
(the global step's FLOPs over the wall time x the peak x the ranks).  Runs
on the card unless ``--device cpu``.

Under ``torchrun`` / ``python -m torch.distributed.run`` (one process per
rank; nccl on the cards, gloo with ``--device cpu``) it runs the sharded
executor over a (pp, dp, tp) mesh: ``--pp`` (the gas microbatches are the
pipeline's), ``--virtual-stages``, ``--dp``, ``--tp``, ``--zero`` 0-3 and
``--rules``; rank 0 prints.  pp x dp x tp must be the number of ranks.
Plans that still raise, naming ROADMAP.md: ep, node, qcomm, overlap, tp on
the hybrid and rwkv families, ``--rules tp_only`` at dp > 1 (it keeps the
batch off the data axis), ``--remat selective``.  Every plan prints the
same losses as one device:

  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \
      --device cpu --arch yi-6b --reduced --dp 2 --tp 2 --zero 3 --precision fp32
  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \
      --device cpu --arch yi-6b --reduced --pp 2 --dp 2 --gas 2 --precision fp32
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
      --reduced --steps 5 --global-batch 4 --seq-len 32 --precision fp32
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import ASSIGNED, PAPER, get_config
from repro_torch.core import costmodel
from repro_torch.data import SyntheticCorpus, make_batch_iterator
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.launch.mesh import init_distributed, mesh_for_plan
from repro_torch.runtime.train_loop import (ParallelPlan, build_model, build_train_step,
                                            init_train_state)


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
                    help="full = save layer boundaries only; none = save "
                         "everything; selective is not ported yet")
    ap.add_argument("--kernels", action="store_true",
                    help="the norms (RMSNorm or LayerNorm), the MLP input half "
                         "(SwiGLU or GELU), attention, the SSD scan and CE in the "
                         "CUDA kernels")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel ranks")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks (dense family)")
    ap.add_argument("--pp", type=int, default=1, help="pipeline ranks")
    ap.add_argument("--virtual-stages", type=int, default=1,
                    help="logical stages per pipeline rank (interleaved)")
    ap.add_argument("--zero", type=int, choices=[0, 1, 2, 3], default=None,
                    help="ZeRO stage (default 1)")
    ap.add_argument("--rules", default="megatron_tp",
                    choices=["megatron_tp", "fsdp", "dp_only", "tp_only"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    overrides = {"n_layers": args.layers} if args.layers else {}
    cfg = cfg.reduced(**overrides) if args.reduced else dataclasses.replace(cfg, **overrides)
    plan = ParallelPlan(dp=args.dp, tp=args.tp, pp=args.pp,
                        virtual_stages=args.virtual_stages, zero=args.zero, rules=args.rules,
                        gas=args.gas, precision=args.precision, remat=args.remat,
                        kernels=args.kernels)
    mesh, world, rank0 = None, 1, True
    if "WORLD_SIZE" in os.environ:             # a torch.distributed launcher's rank
        init_distributed(device)
        mesh = mesh_for_plan(plan, device)
        model = build_model(cfg, plan, mesh)
        device, world, rank0 = model.device, dist.get_world_size(), dist.get_rank() == 0
    elif plan.n_devices > 1:
        raise SystemExit(f"pp x dp x tp = {plan.n_devices} ranks: run under torchrun / "
                         "python -m torch.distributed.run")
    else:
        model = Model(cfg, torch.float32, device=device)
    say = print if rank0 else (lambda *a, **k: None)
    say(f"arch={cfg.name} params={model.n_params():,} device={device} ranks={world} "
        f"pp={plan.pp} v={plan.virtual_stages} dp={plan.dp} tp={plan.tp} "
        f"zero={plan.zero if mesh else '-'} "
        f"gas={plan.gas} precision={plan.precision} remat={plan.remat} "
        f"kernels={plan.kernels}", flush=True)
    opt = AdamWConfig(lr=cosine_schedule(args.lr, 10, args.steps))
    state = init_train_state(model, opt, plan,
                             torch.Generator(device=device).manual_seed(args.seed))
    step_fn = build_train_step(model, opt, plan, mesh)
    it = make_batch_iterator(SyntheticCorpus(vocab_size=cfg.vocab_size, seed=args.seed),
                             seq_len=args.seq_len, global_batch=args.global_batch)
    flops = costmodel.train_step_flops(cfg, args.global_batch, args.seq_len).total
    tokens = args.global_batch * args.seq_len
    records = []
    for i in range(args.steps):
        batch = next(it)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        rec = {"step": i + 1, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]), "wall_s": wall,
               "tokens_per_s": tokens / wall}
        if device.type == "cuda":
            rec["mfu"] = costmodel.mfu(flops, wall, costmodel.H100.peak_flops * world)
        records.append(rec)
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            mfu = f" mfu {100 * rec['mfu']:.2f}%" if "mfu" in rec else ""
            say(f"step {rec['step']:5d} loss {rec['loss']:.4f} grad_norm "
                f"{rec['grad_norm']:.4f} {rec['tokens_per_s']:,.0f} tok/s{mfu}",
                flush=True)
    if mesh is not None:
        dist.destroy_process_group()
    return records


if __name__ == "__main__":
    main()
