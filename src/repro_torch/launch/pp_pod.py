"""Cross-pod pipeline parallelism, dry run (the port of
``repro/launch/pp_pod.py``; the paper's "PP across slow links").

The two pods are the two ranks of the pipe axis (the layers split in half);
microbatches cross the pod boundary as the pipeline ring's sends
(point to point, once a microbatch a direction: the pattern the paper
recommends for the slowest links), while tp and dp stay inside each pod.
The full train step (gradient accumulation, ZeRO, mixed precision) is
traced as ``launch/dryrun.py`` traces it, as rank 0 of a fake group of
512 ranks; the cross-pod figure is the ring's send bytes
(``runtime/collectives.py``'s ``send``, the reference's
``collective-permute``).

  PYTHONPATH=src python -m repro_torch.launch.pp_pod --arch yi-6b --gas 8
"""
from __future__ import annotations

import argparse
import json

from repro_torch.analysis import roofline as rl
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import trace_record
from repro_torch.runtime.train_loop import ParallelPlan


def pp_pod_plan(*, gas: int, tp: int = 16, precision: str = "fp32",
                zero: int | None = None) -> ParallelPlan:
    """2 pods as 2 pipeline stages; tp and dp fill the 16 x 16 grid inside
    each.  fp32 by default, as the reference's (whose host compiler
    check-fails on some bf16 all-reduces)."""
    return ParallelPlan(pp=2, dp=256 // tp, tp=tp, gas=gas,
                        precision=precision, zero=zero)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--gas", type=int, default=8)
    ap.add_argument("--tp", type=int, default=16)
    ap.add_argument("--zero", type=int, choices=(0, 1, 2, 3), default=None,
                    help="ZeRO stage across the intra-pod data axis "
                         "(cross-pod traffic stays the pipeline's sends)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    plan = pp_pod_plan(gas=args.gas, tp=args.tp, zero=args.zero)
    shape = SHAPES[args.shape]
    traced = trace_record(cfg, shape, plan, plan.n_devices)
    terms = rl.roofline_terms(traced["flops_per_device"], traced["bytes_per_device"],
                              traced["collective_bytes_total"], plan.n_devices)
    coll = traced["collective_bytes"]
    pperm = coll.get("collective-permute", 0.0)
    print(f"[ok] pp-on-pod {args.arch} x {args.shape} "
          f"(pp2 x dp{plan.dp} x tp{plan.tp}, gas={args.gas}): "
          f"trace {traced['trace_s']:.1f}s | "
          f"compute {terms.compute_s*1e3:.1f}ms mem {terms.memory_s*1e3:.1f}ms "
          f"coll {terms.collective_s*1e3:.1f}ms | "
          f"cross-pod ppermute {pperm/1e9:.1f}GB of "
          f"{traced['collective_bytes_total']/1e9:.1f}GB total collectives")
    rec = {"tag": f"pp_pod:{args.arch}:{args.shape}:gas{args.gas}",
           "status": "ok", "mesh": f"pipe2_data{plan.dp}_model{plan.tp}",
           "zero": plan.zero, "roofline": terms.as_dict(), "collective_bytes": coll}
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


if __name__ == "__main__":
    main()
