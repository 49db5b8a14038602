"""Training launcher (the single-device flags of ``repro/launch/train.py``):
synthetic packed batches through ``build_train_step``, one line per logged
step with loss, grad_norm, tokens/s and MFU against the H100's bf16 peak.
Runs on the card unless ``--device cpu``.

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
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ASSIGNED, PAPER, get_config
from repro_torch.core import costmodel
from repro_torch.data import SyntheticCorpus, make_batch_iterator
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.runtime.train_loop import (ParallelPlan, build_train_step,
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
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    overrides = {"n_layers": args.layers} if args.layers else {}
    cfg = cfg.reduced(**overrides) if args.reduced else dataclasses.replace(cfg, **overrides)
    plan = ParallelPlan(gas=args.gas, precision=args.precision, remat=args.remat,
                        kernels=args.kernels)
    model = Model(cfg, torch.float32, device=device)
    print(f"arch={cfg.name} params={model.n_params():,} device={device} "
          f"gas={plan.gas} precision={plan.precision} remat={plan.remat} "
          f"kernels={plan.kernels}", flush=True)
    opt = AdamWConfig(lr=cosine_schedule(args.lr, 10, args.steps))
    state = init_train_state(model, opt, plan,
                             torch.Generator(device=device).manual_seed(args.seed))
    step_fn = build_train_step(model, opt, plan)
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
            rec["mfu"] = costmodel.mfu(flops, wall, costmodel.H100.peak_flops)
        records.append(rec)
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            mfu = f" mfu {100 * rec['mfu']:.2f}%" if "mfu" in rec else ""
            print(f"step {rec['step']:5d} loss {rec['loss']:.4f} grad_norm "
                  f"{rec['grad_norm']:.4f} {rec['tokens_per_s']:,.0f} tok/s{mfu}",
                  flush=True)
    return records


if __name__ == "__main__":
    main()
