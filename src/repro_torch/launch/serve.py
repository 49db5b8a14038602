"""Serving launcher (port of ``repro/launch/serve.py``): the continuous-batching
ServeEngine over synthetic Poisson traffic, reporting per-request latency /
TTFT percentiles and goodput.  Runs on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-1.4b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --cache-len 512
  PYTHONPATH=src python -m repro_torch.launch.serve --arch arctic-480b --reduced \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --reduced \
      --device cpu --dtype fp32 --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
      --cache-len 8192               # a 4096-position sliding-window ring a slot
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --kv-quant
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch yi-6b --reduced --device cpu --dp 2 --log-jsonl build/serve.jsonl

``--kv-quant`` serves from the int8 KV cache; ``--dp N`` (under a launcher of
N processes) serves data-parallel slots, each rank holding its slots'
cache; ``--log-jsonl`` appends one telemetry ``request`` record per finished
request (rank 0's).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ASSIGNED, PAPER, get_config
from repro_torch.core.compute import ComputePolicy
from repro_torch.core.telemetry import JsonlSink
from repro_torch.launch.train import draw_extras
from repro_torch.models.model import Model
from repro_torch.runtime.serve_engine import Request, ServeEngine

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def synthetic_requests(cfg, n: int, *, rate: float | None = None,
                       prompt_lens: tuple[int, int] = (4, 16),
                       max_new: tuple[int, int] = (4, 16),
                       temperature: float = 0.0, top_p: float = 1.0,
                       seed: int = 0) -> list[Request]:
    """Poisson arrivals at ``rate`` req/s (all at t=0 when None), uniform
    prompt and new-token lengths, per-request seeds, and the family's
    dense inputs (``launch/train.py:draw_extras``: the encdec family's
    ``frames``, the vlm family's ``patches``) from the same stream."""
    rng = np.random.RandomState(seed)
    t = 0.0
    reqs = []
    for rid in range(n):
        if rate:
            t += float(rng.exponential(1.0 / rate))
        length = int(rng.randint(prompt_lens[0], prompt_lens[1] + 1))
        n_new = int(rng.randint(max_new[0], max_new[1] + 1))
        prompt = rng.randint(0, cfg.vocab_size, size=length).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=prompt, max_new_tokens=n_new,
                            temperature=temperature, top_p=top_p,
                            seed=seed + rid, arrival=t, extras=draw_extras(cfg, rng)))
    return reqs


def summarize(records: list[dict]) -> dict:
    """Latency/TTFT percentiles + goodput (completed tokens over the
    makespan, first arrival to last completion)."""
    lat = [r["t_done"] - r["t_arrival"] for r in records]
    ttft = [r["t_first_token"] - r["t_arrival"] for r in records]
    total = sum(r["n_generated"] for r in records)
    makespan = max(r["t_done"] for r in records) - min(r["t_arrival"] for r in records)
    return {
        "n_requests": len(records),
        "completed_tokens": int(total),
        "makespan_s": float(makespan),
        "goodput_tok_s": float(total / makespan) if makespan > 0 else 0.0,
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p99_s": float(np.percentile(ttft, 99)),
        "evictions": int(sum(r["evictions"] for r in records)),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ASSIGNED + PAPER), default="yi-6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=None,
                    help="Poisson arrival rate (req/s); default: all at t=0")
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--static", action="store_true",
                    help="static-batch baseline (no slot refill mid-flight)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel slots over a dp-way mesh (a launcher of dp "
                         "processes)")
    ap.add_argument("--kv-quant", action="store_true", help="the int8 KV cache")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-jsonl", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="default: bf16 on the card, fp32 on the CPU")
    ap.add_argument("--kernels", action=argparse.BooleanOptionalAction, default=True,
                    help="the norms, the MLP input half, the grouped expert MLP, "
                         "prefill attention, the SSD scan and the mamba decode "
                         "step in the CUDA kernels")
    args = ap.parse_args()

    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype or ("bf16" if device.type == "cuda" else "fp32")]
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    mesh = plan = None
    rank = 0
    if args.dp > 1:
        import torch.distributed as dist

        from repro_torch.launch.mesh import init_distributed, mesh_for_plan
        from repro_torch.runtime.train_loop import ParallelPlan

        init_distributed(device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        plan = ParallelPlan(dp=args.dp, zero=0)
        mesh = mesh_for_plan(plan, device)
        rank = dist.get_rank()
    model = Model(cfg, dtype, compute=ComputePolicy(kernels=args.kernels),
                  device=device)
    model.init(torch.Generator(device=device).manual_seed(args.seed))

    sink = JsonlSink(args.log_jsonl) if args.log_jsonl and rank == 0 else None
    engine = ServeEngine(model, n_slots=args.n_slots, cache_len=args.cache_len,
                         block_size=args.block_size, continuous=not args.static,
                         mesh=mesh, plan=plan, telemetry_sink=sink)
    reqs = synthetic_requests(
        cfg, args.requests, rate=args.rate, prompt_lens=(4, args.cache_len // 4),
        max_new=(2, args.max_new), temperature=args.temperature,
        top_p=args.top_p, seed=args.seed)

    mode = "static" if args.static else "continuous"
    cache = (f"paged pool: {engine.n_blocks}x{engine.block_size} blocks" if engine.paged
             else f"slot-swap cache: {args.n_slots}x{args.cache_len} positions")
    quant = ", int8 KV" if cfg.kv_quant else ""
    if rank == 0:
        print(f"{cfg.name} [{cfg.family}] {mode} batching, {args.n_slots} slots "
              f"over dp={args.dp}, {cache}{quant}, {device.type} "
              f"{str(dtype).removeprefix('torch.')}, kernels={args.kernels}")
    t0 = time.monotonic()
    engine.run(reqs)
    wall = time.monotonic() - t0
    if sink is not None:
        sink.close()
    if mesh is not None:
        dist.destroy_process_group()
    if rank != 0:
        return
    s = summarize(engine.records)
    print(f"{s['n_requests']} requests, {s['completed_tokens']} tokens in "
          f"{wall:.2f}s wall ({engine.n_ticks} decode ticks, "
          f"{engine.n_prefills} prefills, {s['evictions']} evictions)")
    print(f"goodput {s['goodput_tok_s']:,.1f} tok/s | latency p50 "
          f"{s['latency_p50_s'] * 1e3:.0f} ms p99 "
          f"{s['latency_p99_s'] * 1e3:.0f} ms | ttft p50 "
          f"{s['ttft_p50_s'] * 1e3:.0f} ms p99 {s['ttft_p99_s'] * 1e3:.0f} ms")
    if sink is not None:
        print(f"request records -> {args.log_jsonl}")


if __name__ == "__main__":
    main()
