"""The readings behind the step-0 limits of ``chip_smoke.py``'s train phase.

  python3 tools/step0_limits.py [--arch yi-6b|gpt-1.4b|zamba2-2.7b|rwkv6-1.6b|arctic-480b|
                                        seamless-m4t-medium|internvl2-2b]
                                       (one CUDA card, from the repo root)

The train phase holds step 0 of each arch (full width; yi-6b at 8 layers,
gpt-1.4b at all 24, zamba2-2.7b at 18 of 54, rwkv6-1.6b at all 24,
arctic-480b at 2 of 35 with 8 of its 128 experts, seamless-m4t-medium at
all 12 + 12 with its synthetic frames, internvl2-2b at all 24 with its
synthetic patches; bf16
compute over fp32 masters,
remat full, gas 2 microbatches of 4 x 2048 tokens) with kernels=True against
kernels=False, in loss and grad_norm.  This script measures what that
comparison can tell apart:

  * sound: the relative kernels-on vs kernels-off difference at step 0 for
    several weight seeds, each with its own batch;
  * planted: the same difference on seed 0 when one kernel is wrong in a
    single 64-row tile at the step's grid (its output there zeroed after the
    real kernel ran): the MLP input half (swiglu or gelu_mlp), for gpt-1.4b
    and seamless-m4t-medium the layernorm forward, for zamba2-2.7b the SSD scan forward, for
    arctic-480b the grouped expert MLP's forward (rows of expert 0), the flash
    forward, the dQ kernel, and the dK/dV kernel; for rwkv6-1.6b (no
    attention, no MLP kernel) the wkv scan forward and the rmsnorm forward;
    for internvl2-2b also the rmsnorm forward and the CE kernel (its lse
    zeroed on 64 text rows).

Each reading is one JSON line; the last line gives the largest sound and the
smallest planted difference per metric.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SEEDS = (0, 1, 2)
TILE = slice(1024, 1088)            # one 64-row tile in the middle of the grid


def planted(fn, outputs: tuple[int, ...], index: tuple):
    """``fn`` with ``index`` of the given outputs zeroed after it ran."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        for i in outputs:
            (out[i] if isinstance(out, tuple) else out)[index] = 0
        return out
    return wrapped


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(cs.TRAIN_LAYERS), default="yi-6b")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step0_limits: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import (_build, cross_entropy as ce, flash_attention as fa,
                                     gelu_mlp as gm,
                                     grouped_mlp as gp, layernorm as ln, rmsnorm as rn,
                                     ssd_scan as ssd, swiglu as sg, wkv_scan as wkv)
    from repro_torch.models.model import Model
    from repro_torch.runtime.train_loop import ParallelPlan

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cfg = cs.train_config(args.arch)
    gb, gas, S = cs.TRAIN["global_batch"], cs.TRAIN["gas"], cs.TRAIN["seq_len"]
    model = Model(cfg, torch.float32, device="cuda")
    batches = cs._batches(cfg.vocab_size, S, gb, len(SEEDS), cfg)
    plans = {k: ParallelPlan(gas=gas, precision="bf16", remat="full", kernels=k)
             for k in (True, False)}

    def step0(seed: int, kernels: bool) -> dict:
        return cs._run_steps(model, plans[kernels], [batches[seed]], seed)[0]

    def rel(on: dict, off: dict) -> dict:
        return {key: abs(on[key] - off[key]) / abs(off[key])
                for key in ("loss", "grad_norm")}

    off0 = None
    sound = []
    for seed in SEEDS:
        off = step0(seed, False)
        off0 = off0 or off
        r = rel(step0(seed, True), off)
        sound.append(r)
        cs.emit({"reading": "sound", "arch": args.arch, "seed": seed, **r})

    if cfg.family == "rwkv":
        faults = {"wkv_scan forward, tokens 1024:1088 of sequence 0":
                      (wkv, "wkv_scan_cuda", (0,), (0, TILE)),
                  "rmsnorm forward, rows 1024:1088 of sequence 0":
                      (rn, "rmsnorm_cuda", (0,), (0, TILE))}
    elif cfg.act == "swiglu":
        faults = {"swiglu forward, rows 1024:1088": (sg, "swiglu_cuda", (0,), (TILE,))}
    else:
        faults = {"gelu_mlp forward, rows 1024:1088": (gm, "gelu_mlp_cuda", (0,), (TILE,)),
                  "layernorm forward, rows 1024:1088 of sequence 0":
                      (ln, "layernorm_cuda", (0,), (0, TILE))}
    if cfg.family == "hybrid":
        faults["ssd_scan forward, tokens 1024:1088 of sequence 0"] = (
            ssd, "ssd_scan_cuda", (0,), (0, TILE))
    if cfg.family == "moe":
        faults["grouped_mlp forward, rows 1024:1088 of expert 0"] = (
            gp, "grouped_mlp_cuda", (0,), (0, TILE))
    if cfg.family == "vlm":
        faults["rmsnorm forward, positions 1024:1088 of sequence 0"] = (
            rn, "rmsnorm_cuda", (0,), (0, TILE))
        faults["cross_entropy lse, text rows 1024:1088"] = (
            ce, "cross_entropy_cuda", (0,), (TILE,))
    faults.update({} if cfg.family == "rwkv" else {
        "flash forward, query rows 1024:1088 of head 0":
            (fa, "flash_attention_fwd_cuda", (0,), (0, TILE, 0)),
        "flash dQ, query rows 1024:1088 of head 0":
            (fa, "flash_attention_bwd_cuda", (0,), (0, TILE, 0)),
        "flash dK/dV, key rows 1024:1088 of kv head 0":
            (fa, "flash_attention_bwd_cuda", (1, 2), (0, TILE, 0)),
    })
    planted_rel = []
    for name, (mod, attr, outputs, index) in faults.items():
        real = getattr(mod, attr)
        setattr(mod, attr, planted(real, outputs, index))
        try:
            r = rel(step0(0, True), off0)
        finally:
            setattr(mod, attr, real)
        planted_rel.append(r)
        cs.emit({"reading": "planted", "arch": args.arch, "fault": name, **r})

    card = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    # a planted fault that makes a metric non-finite fails the train phase's
    # finite check whatever the limit: the smallest finite reading bounds it
    summary = {key: {"sound_max": max(r[key] for r in sound),
                     "planted_min": min((r[key] for r in planted_rel
                                         if math.isfinite(r[key])), default=None),
                     "planted_non_finite": sum(not math.isfinite(r[key])
                                               for r in planted_rel)}
               for key in ("loss", "grad_norm")}
    cs.emit({"arch": args.arch, "summary": summary, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
