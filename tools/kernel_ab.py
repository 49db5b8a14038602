"""A/B of one bf16 kernel source on the card: the port's build of
``src/repro_torch/csrc/<kernel>.cu`` against another version of that source
(the same C entries and signatures), in one process and in turns (port,
other, other, port), so that both meet the same card, clocks and host.

  python3 tools/kernel_ab.py swiglu OTHER.cu
  python3 tools/kernel_ab.py gelu_mlp OTHER.cu --serve gpt-1.4b
  python3 tools/kernel_ab.py flash_attention_bwd OTHER.cu
  python3 tools/kernel_ab.py grouped_mlp OTHER.cu --serve llama4-maverick-400b-a17b
  python3 tools/kernel_ab.py ssd_scan OTHER.cu [--fp32-train]
  python3 tools/kernel_ab.py wkv_scan OTHER.cu [--fp32-train]
                                       (one CUDA card, from the repo root)

OTHER.cu is built with the port's ``nvcc`` flags and
``-I src/repro_torch/csrc`` (it may include the port's headers); a scan's
also has the ``<kernel>_scratch`` entry that sizes its scratch.  For each
shape of the kernel's timed rows in ``chip_smoke.py`` it prints both
versions' times (``chip_smoke.Timer``: the median of CUDA-event times with
the L2 flushed before each launch; each version the mean of its two
turns), their ratio, and whether their outputs are bit-identical; for the
flash backward each of its two kernels (dQ, dK/dV) apart; for the grouped
expert MLP at all 128 experts of llama4-maverick and arctic, with masks from
the model's router on random gates (``chip_smoke.routed_mask``); for the
SSD scan (bf16) and the wkv scan at every case of ``chip_smoke._ssd_cases``
and ``_wkv_cases``, y and the final state, and each version's device time
by kernel (``torch.profiler``) at the first case.  With ``--fp32-train`` it
also runs the check that opens ``chip_smoke.phase_train`` (the arch's
reduced fp32 model, 5 steps with kernels on against kernels off) under each
version and prints every step's relative loss and grad_norm difference.  With
``--serve ARCH`` it also serves ARCH at full width and depth in bf16
(``ServeEngine``, 4 slots) and reads the kernel's device time per decode
tick from ``torch.profiler`` (``chip_smoke._profile``) in the same turns:
the kernel in place, between the model's other kernels, with no flush.
Each reading is one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# chip_smoke.py's timed rows: (N, d, F) of the GEMMs; (B, Hq, Hkv, hd) of
# the flash backward (causal, 2048 tokens: yi-6b at B = 1 and 4, gpt-1.4b,
# zamba2)
SHAPES = {"swiglu": [(512, 4096, 11008), (4, 4096, 11008), (8192, 4096, 11008),
                     (256, 4096, 11008), (256, 5120, 8192), (4, 5120, 8192),
                     (256, 7168, 4864), (4, 7168, 4864)],
          "gelu_mlp": [(8192, cs.GPT_D, cs.GPT_F), (256, cs.GPT_D, cs.GPT_F),
                       (4, cs.GPT_D, cs.GPT_F)],
          "flash_attention_bwd": [(1, 32, 4, 128), (4, 32, 4, 128),
                                  (4, cs.GPT_HEADS, cs.GPT_HEADS, cs.GPT_HD), (4, 32, 32, 80)],
          # (arch, act, G groups of g tokens): a 256-token prefill, decode at 4 slots
          "grouped_mlp": [(cs.LLAMA4, "swiglu", 1, 256), (cs.LLAMA4, "swiglu", 4, 1),
                          (cs.ARCTIC, "swiglu", 1, 256), (cs.ARCTIC, "swiglu", 4, 1),
                          (cs.ARCTIC, "gelu", 1, 256)],
          # (B, T, chunk): chip_smoke.py's timed scan rows
          "ssd_scan": cs._ssd_cases(), "wkv_scan": cs._wkv_cases()}
# the wrapper module, its library loader and the C entries it calls
WRAPPER = {"swiglu": ("swiglu", "_lib", ("swiglu_fwd",)),
           "gelu_mlp": ("gelu_mlp", "_lib", ("gelu_mlp_fwd",)),
           "flash_attention_bwd": ("flash_attention", "_bwd_lib",
                                   ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")),
           "grouped_mlp": ("grouped_mlp", "_lib", ("grouped_mlp_fwd",)),
           "ssd_scan": ("ssd_scan", "_lib", ("ssd_scan_fwd", "ssd_scan_scratch")),
           "wkv_scan": ("wkv_scan", "_lib", ("wkv_scan_fwd", "wkv_scan_scratch"))}


def build_other(kernel: str, src: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "ab" / f"{kernel}-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def with_other(kernel: str, module, other: ctypes.CDLL, fn):
    """``fn()`` with the module's library swapped for ``other``."""
    _, loader, entries = WRAPPER[kernel]
    own = getattr(module, loader)
    for entry in entries:
        getattr(other, entry).argtypes = getattr(own(), entry).argtypes
        getattr(other, entry).restype = getattr(own(), entry).restype
    setattr(module, loader, lambda: other)
    try:
        return fn()
    finally:
        setattr(module, loader, own)


def in_turns(kernel: str, module, other: ctypes.CDLL, measure) -> tuple[float, float]:
    """(port, other): ``measure()`` with the module's library, then the
    other's twice, then the module's; each the mean of its two turns."""
    a = measure()
    b, c = (with_other(kernel, module, other, measure) for _ in range(2))
    d = measure()
    return (a + d) / 2, (b + c) / 2


def flash_bwd_turns(module, other: ctypes.CDLL) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer()
    for B, Hq, Hkv, hd in SHAPES["flash_attention_bwd"]:
        q, do = (cs.randn(gen, B, 2048, Hq, hd, dtype=torch.bfloat16) for _ in range(2))
        k, v = (cs.randn(gen, B, 2048, Hkv, hd, dtype=torch.bfloat16) for _ in range(2))
        o, lse = module.flash_attention_fwd_cuda(q, k, v, causal=True)
        args, grads = module.bwd_args(q, k, v, o, lse, do, causal=True)

        def both():
            module.launch_bwd_dq(args)
            module.launch_bwd_dkv(args)
            return [g.clone() for g in grads]

        same = all(torch.equal(a, b) for a, b in
                   zip(both(), with_other("flash_attention_bwd", module, other, both)))
        for name, launch in (("dq", module.launch_bwd_dq), ("dkv", module.launch_bwd_dkv)):
            port_ms, other_ms = in_turns("flash_attention_bwd", module, other,
                                         lambda: timer(lambda: launch(args)))
            cs.emit({"kernel": f"flash_attention_bwd_{name}", "shape": [B, 2048, Hq, Hkv, hd],
                     "port_ms": port_ms, "other_ms": other_ms,
                     "port_over_other": port_ms / other_ms, "bit_identical": same})
        del q, k, v, do, o, lse, args, grads
        torch.cuda.empty_cache()


def grouped_turns(module, other: ctypes.CDLL) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_capacity

    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer()
    weights = {}
    for arch, act, G, g in SHAPES["grouped_mlp"]:
        cfg = get_config(arch)
        E, d, F = cfg.n_experts, cfg.d_model, cfg.d_ff
        if arch not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            weights[arch] = [torch.randn(*shape, generator=gen, device="cuda",
                                         dtype=torch.bfloat16).mul_(shape[1] ** -0.5)
                             for shape in ((E, d, F), (E, d, F), (E, F, d))]
        w1, w3, w2 = weights[arch]
        w3 = w3 if act == "swiglu" else None
        C = moe_capacity(g, cfg)
        mask = cs.routed_mask(gen, G, g, E, cfg.top_k, C)
        x = cs.randn(gen, E, G * C, d, dtype=torch.bfloat16)

        def call():
            return module.grouped_mlp_cuda(x, w1, w3, w2, mask, act)

        port_out = call()
        port_ms, other_ms = in_turns("grouped_mlp", module, other, lambda: timer(call))
        same = torch.equal(port_out, with_other("grouped_mlp", module, other, call))
        cs.emit({"kernel": "grouped_mlp", "arch": arch, "act": act,
                 "shape": [E, G * C, d, F], "experts_with_a_slot": int(mask.ne(0).any(1).sum()),
                 "port_ms": port_ms, "other_ms": other_ms,
                 "port_over_other": port_ms / other_ms, "bit_identical": same})


def scan_turns(kernel: str, module, other: ctypes.CDLL) -> None:
    """The SSD scan (bf16, zamba2's 80 heads) or the wkv scan (rwkv6's 32)
    at chip_smoke.py's cases."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer()
    with torch.no_grad():
        for B, T, chunk in SHAPES[kernel]:
            args = (cs.ssd_inputs(gen, B, T, torch.bfloat16) if kernel == "ssd_scan"
                    else cs.wkv_inputs(gen, B, T))
            call = getattr(module, f"{kernel}_cuda")
            port_out = call(*args, chunk)
            port_ms, other_ms = in_turns(kernel, module, other,
                                         lambda: timer(lambda: call(*args, chunk)))
            other_out = with_other(kernel, module, other, lambda: call(*args, chunk))
            same = all(torch.equal(a, b) for a, b in zip(port_out, other_out))
            row = {"kernel": kernel, "shape": [B, T, chunk], "port_ms": port_ms,
                   "other_ms": other_ms, "port_over_other": port_ms / other_ms,
                   "bit_identical": same}
            if (B, T, chunk) == SHAPES[kernel][0]:
                def by_kernel():
                    prof = cs._profile(lambda: [call(*args, chunk) for _ in range(10)])
                    return {k["name"]: k["device_ms"] / 10 for k in prof["top_kernels"]}
                row["port_ms_by_kernel"] = by_kernel()
                row["other_ms_by_kernel"] = with_other(kernel, module, other, by_kernel)
            cs.emit(row)


def fp32_train_turns(kernel: str, module, other: ctypes.CDLL) -> None:
    """The reduced fp32 train check of ``chip_smoke.phase_train`` (kernels
    on vs off over 5 steps) with the port's source, then the other."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.runtime.train_loop import ParallelPlan

    arch = {"ssd_scan": cs.ZAMBA, "wkv_scan": cs.RWKV}[kernel]
    cfg = get_config(arch).reduced(**cs.REDUCED[arch])
    model = Model(cfg, torch.float32, device="cuda")
    batches = cs._batches(cfg.vocab_size, 256, 4, 5)

    def run(kernels: bool):
        return cs._run_steps(model, ParallelPlan(gas=2, precision="fp32", kernels=kernels),
                             batches, 1)

    off = run(False)
    for version, on in (("port", run(True)),
                        ("other", with_other(kernel, module, other, lambda: run(True)))):
        cs.emit({"kernel": kernel, "fp32_train": cfg.name, "version": version,
                 "rtol": cs.TRAIN_FP32_RTOL,
                 "rel_by_step": [{k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm")}
                                 for a, b in zip(on, off)]})


def kernel_turns(kernel: str, module, other: ctypes.CDLL) -> None:
    if kernel == "flash_attention_bwd":
        flash_bwd_turns(module, other)
        return
    if kernel == "grouped_mlp":
        grouped_turns(module, other)
        return
    if kernel in ("ssd_scan", "wkv_scan"):
        scan_turns(kernel, module, other)
        return
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer()
    for N, d, F in SHAPES[kernel]:
        x = cs.randn(gen, N, d, dtype=torch.bfloat16)
        ws = [cs.randn(gen, d, F, dtype=torch.bfloat16, scale=d ** -0.5)
              for _ in range(2 if kernel == "swiglu" else 1)]
        call = getattr(module, f"{kernel}_cuda")
        port_out = call(x, *ws)
        port_ms, other_ms = in_turns(kernel, module, other,
                                     lambda: timer(lambda: call(x, *ws)))
        same = torch.equal(port_out, with_other(kernel, module, other, lambda: call(x, *ws)))
        cs.emit({"kernel": kernel, "shape": [N, d, F], "port_ms": port_ms,
                 "other_ms": other_ms, "port_over_other": port_ms / other_ms,
                 "bit_identical": same})


def serve_turns(kernel: str, module, other: ctypes.CDLL, arch: str, ticks: int = 8) -> None:
    from repro_torch.core.compute import ComputePolicy
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve_engine import Request, ServeEngine

    group = next(g for g, keys in cs.PROFILE_GROUPS
                 if any(k.startswith(kernel) or kernel.startswith(k) for k in keys))
    cfg = cs.serve_config(arch)
    model = Model(cfg, torch.bfloat16, compute=ComputePolicy(kernels=True), device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(0)
    engine = ServeEngine(model, n_slots=4, cache_len=512, block_size=16)
    for i in range(4):
        engine.submit(Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, 64).astype(np.int32),
                              max_new_tokens=6 * ticks))
    engine.step()                                      # 4 prefills + 1 tick
    readings = []

    def per_tick() -> float:
        prof = cs._profile(lambda: [engine.step() for _ in range(ticks)])
        readings.append(prof)
        return prof["device_ms_by_group"][group] / ticks

    per_tick()                                         # warm both versions up
    port_ms, other_ms = in_turns(kernel, module, other, per_tick)
    cs.emit({"kernel": kernel, "serve": arch, "ticks_per_turn": ticks,
             "port_device_ms_per_tick": port_ms, "other_device_ms_per_tick": other_ms,
             "port_over_other": port_ms / other_ms,
             "decode_device_ms_per_tick": [r["device_busy_s"] * 1e3 / ticks
                                           for r in readings[1:]]})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("kernel", choices=sorted(SHAPES))
    ap.add_argument("other", type=Path)
    ap.add_argument("--serve", help="also A/B the kernel's device time per decode tick "
                                    "when serving this arch")
    ap.add_argument("--fp32-train", action="store_true",
                    help="a scan: also the reduced fp32 train step's kernels-on-vs-off drift "
                         "under each version")
    args = ap.parse_args()
    if args.serve and args.kernel == "flash_attention_bwd":
        ap.error("--serve: serving runs no backward")
    if args.serve and args.kernel in ("ssd_scan", "wkv_scan"):
        ap.error("--serve: a decode tick runs no scan")
    if args.fp32_train and args.kernel not in ("ssd_scan", "wkv_scan"):
        ap.error("--fp32-train: the scans only")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import importlib

    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.build_all((args.kernel,) if args.kernel != "flash_attention_bwd"
                     else ("flash_attention", args.kernel))
    module = importlib.import_module(f"repro_torch.kernels.{WRAPPER[args.kernel][0]}")
    other = build_other(args.kernel, args.other)
    kernel_turns(args.kernel, module, other)
    if args.fp32_train:
        torch.backends.cudnn.allow_tf32 = False
        fp32_train_turns(args.kernel, module, other)
    if args.serve:
        serve_turns(args.kernel, module, other, args.serve)
    return 0


if __name__ == "__main__":
    sys.exit(main())
