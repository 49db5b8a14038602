"""What a one-rank process group costs the train step: gpt-1.4b at
chip_smoke's train shape (24 layers, full width, 8 x 2048 tokens, gas 2,
bf16 over fp32 masters, remat full, kernels on) as the unsharded model
(no process group) and as the sharded model over a one-rank nccl group at
ZeRO 3 (every leaf gathered on use) and at ZeRO 0 (the Megatron pair and
the dp all-reduce of a unit mesh, no gathers), in turns: single, zero3,
zero0, zero0, zero3, single.  Each turn runs a warm-up step, times two
steps (synchronized wall time) and profiles one (device time, idle share,
peak memory); the last line gives each sharded variant's median step
time over single's and the kernels whose device time differs most from
single's.

  python3 tools/one_rank_overhead.py        (one CUDA card, from the repo root)
"""
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch.mesh import init_distributed, mesh_for_plan  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.train_loop import (ParallelPlan, build_model,  # noqa: E402
                                            build_train_step, init_train_state)

ARCH = "gpt-1.4b"
ORDER = ("single", "zero3", "zero0", "zero0", "zero3", "single")


def device_ms(fn) -> tuple[float, dict]:
    """Wall seconds of ``fn`` and its device ms by kernel name."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return wall, by_name


def turn(variant: str, cfg, kw: dict, batches: list) -> dict:
    if variant == "single":
        plan, mesh = ParallelPlan(**kw), None
        model = Model(cfg, torch.float32, device="cuda")
    else:
        plan = ParallelPlan(zero=int(variant[-1]), **kw)
        mesh = mesh_for_plan(plan, torch.device("cuda", torch.cuda.current_device()))
        model = build_model(cfg, plan, mesh)
    opt = AdamWConfig(lr=cs.TRAIN_LR)
    state = init_train_state(model, opt, plan, torch.Generator(device="cuda").manual_seed(0))
    step = build_train_step(model, opt, plan, mesh)
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, batches[0])
    times = []
    for b in batches[1:3]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall, by_name = device_ms(lambda: step(state, batches[3]))
    busy = sum(by_name.values())
    out = {"variant": variant, "step_s": times, "loss0": float(m["loss"]),
           "profiled_wall_s": wall, "device_busy_ms": busy,
           "device_idle_share": 1 - busy / 1e3 / wall,
           "device_kernels_ms": by_name,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del state, step, model
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("one_rank_overhead: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.build_all()
    init_distributed(torch.device("cuda"), cs._process_group_file("one_rank_overhead"), 0, 1)
    cfg = cs.train_config(ARCH)
    kw = dict(gas=cs.TRAIN["gas"], precision="bf16", remat="full", kernels=True)
    batches = cs._batches(cfg.vocab_size, cs.TRAIN["seq_len"], cs.TRAIN["global_batch"], 4)
    runs = []
    for variant in ORDER:
        r = turn(variant, cfg, kw, batches)
        runs.append(r)
        cs.emit({k: v for k, v in r.items() if k != "device_kernels_ms"})
    dist.destroy_process_group()

    def pooled(variant: str, key: str):
        return [r[key] for r in runs if r["variant"] == variant]

    def kernels(variant: str) -> dict:
        rs = [r["device_kernels_ms"] for r in runs if r["variant"] == variant]
        names = set().union(*rs)
        return {n: statistics.mean(r.get(n, 0.0) for r in rs) for n in names}

    single_s = statistics.median(t for ts in pooled("single", "step_s") for t in ts)
    single_k = kernels("single")
    summary = {"arch": ARCH, "layers": cfg.n_layers, "plan": kw,
               "single_median_step_s": single_s,
               "single_device_busy_ms": statistics.mean(pooled("single", "device_busy_ms"))}
    for variant in ("zero3", "zero0"):
        med = statistics.median(t for ts in pooled(variant, "step_s") for t in ts)
        k = kernels(variant)
        diff = {n: k.get(n, 0.0) - single_k.get(n, 0.0) for n in set(k) | set(single_k)}
        summary[variant] = {
            "median_step_s": med, "over_single": med / single_s - 1,
            "device_busy_ms": statistics.mean(pooled(variant, "device_busy_ms")),
            "device_idle_share": statistics.mean(pooled(variant, "device_idle_share")),
            "peak_mem_gb": pooled(variant, "peak_mem_gb"),
            "kernel_ms_over_single": [
                {"name": n[:90], "ms": d}
                for n, d in sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:12]]}
    summary["single_device_idle_share"] = statistics.mean(pooled("single",
                                                                 "device_idle_share"))
    cs.emit(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
