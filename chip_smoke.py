"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (each prints one JSON line; any failure ends the run non-zero):
  1. device + build: the card's name and power limit, ``nvcc`` builds of
     every ``src/repro_torch/csrc/*.cu`` for sm_90a, all started at once;
  2. kernels: each CUDA kernel against its plain PyTorch version on the same
     inputs, at the main path's shapes in bf16 and fp32, plus small fp32
     flavour cases (window, softcap, q_offset, non-causal, G, hd 64);
  3. serve: yi-6b at full width in bf16 with kernels=True through
     ``ServeEngine`` (8 requests, 4 slots, paged pool); the kernels' launch
     counters must rise; the logits are held against a kernels=False run on
     the card, and a reduced fp32 model against kernels=False tightly;
  4. the ``kernels`` line: per kernel its launches in phase 3, its error,
     and the kernel / plain / library / bound times in ms.
The last line is the result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the rate of the unit that runs them (tensor cores for bf16, FFMA for fp32).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TPU_SOURCES = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:22",
    "swiglu": "src/repro/kernels/swiglu.py:24",
    "flash_attention": "src/repro/kernels/flash_attention.py:48",
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations"


class Timer:
    """Median of per-launch CUDA-event times, with L2 flushed (a 256 MB
    write, outside the timed events) before each launch."""

    def __init__(self, iters: int = 10):
        self.iters = iters
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def max_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out.float() - ref.float()).abs().max())


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor, *, rtol: float,
                atol: float, why: str, scale: torch.Tensor | None = None,
                scale_tol: float = 0.0) -> float:
    """|out - ref| <= atol + rtol*|ref| (+ scale_tol*scale) elementwise, else
    raise; ``scale`` is an elementwise error scale the caller derives from the
    kernel's own rounding (flash: P@|V|)."""
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: shape {tuple(out.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite output")
    diff = (out.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    rule = f"|d| <= {atol:g} + {rtol:g}*|ref|"
    if scale is not None:
        limit = limit + scale_tol * scale.float()
        rule += f" + {scale_tol:g}*(P@|V|)"
    err = float(diff.max())
    worst = float((diff / limit).max())
    emit({"phase": "kernel_check", "case": name, "max_abs_err": err,
          "worst_share_of_limit": worst, "rule": rule, "why": why})
    if worst > 1:
        raise AssertionError(f"{name}: max abs err {err}, {worst:.2f}x its limit ({rule})")
    return err


def randn(gen, *shape, dtype, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# bf16 outputs: kernel and plain version both round an fp32 result to bf16,
# so they may differ by one bf16 ULP, at most 2^-7 of the value.
BF16_ULP = 2.0 ** -7
TOL = {  # dtype -> (rtol, atol), and the reason
    "rmsnorm": {torch.bfloat16: (1.1 * BF16_ULP, 1e-5), torch.float32: (1e-5, 1e-5),
                "why": "same fp32 formula, other summation order; bf16: one "
                       "ULP between the two output roundings"},
    "swiglu": {torch.bfloat16: (1.1 * BF16_ULP, 1e-3), torch.float32: (1e-4, 1e-4),
               "why": "fp32: FFMA vs cuBLAS summation order over d; bf16: held "
                      "against the plain version on the same inputs in fp32 "
                      "(the kernel keeps both products in fp32): one ULP "
                      "between the output roundings, 1e-3 for summation order"},
    "flash_attention": {torch.bfloat16: (1.1 * BF16_ULP, 1e-5),
                        torch.float32: (5e-5, 5e-5),
                        "why": "fp32: other exp/summation order over up to 2048 "
                               "keys; bf16: one ULP between the output roundings, "
                               "plus the kernel's rounding of P to bf16 for P@V "
                               "(FA-2), at most 2^-8 of each p, so 2^-8*(P@|V|)"},
}
# flash bf16: the bound on the P-rounding term, with 10% margin
FLASH_P_TOL = 1.1 * 2.0 ** -8


def phase_kernels(timer: Timer) -> dict:
    from repro_torch.kernels import flash_attention as fa, rmsnorm as rn, swiglu as sg
    from repro_torch.kernels.ref import flash_attention_ref, rmsnorm_ref, swiglu_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}

    # rmsnorm (2048, 4096): the prefill norm of 2048 tokens of yi-6b
    for dtype in (torch.bfloat16, torch.float32):
        rtol, atol = TOL["rmsnorm"][dtype]
        x = randn(gen, 2048, 4096, dtype=dtype)
        w = (1 + 0.1 * torch.randn(4096, generator=gen, device="cuda")).to(dtype)
        err = check_close(f"rmsnorm {dtype} (2048, 4096)", rn.rmsnorm_cuda(x, w, 1e-5),
                          rmsnorm_ref(x, w, 1e-5), rtol=rtol, atol=atol,
                          why=TOL["rmsnorm"]["why"])
        if dtype == torch.bfloat16:
            nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
            b, by = bound_ms(nbytes, 4 * x.numel(), torch.float32)
            rows["rmsnorm"] = {
                "shape": "x (2048, 4096) bf16", "max_abs_err": err,
                "rtol": rtol, "atol": atol,
                "ms": timer(lambda: rn.rmsnorm_cuda(x, w, 1e-5)),
                "plain_ms": timer(lambda: rmsnorm_ref(x, w, 1e-5)),
                "library_ms": (timer(lambda: F.rms_norm(x, (4096,), w, 1e-5))
                               if hasattr(F, "rms_norm") else None),
                "library_call": "F.rms_norm", "bound_ms": b, "bound_by": by}

    def check_swiglu(name, x, w1, w3):
        """bf16: against the plain version on the same values in fp32, rounded
        to bf16 once (the kernel's own arithmetic); fp32: directly."""
        rtol, atol = TOL["swiglu"][x.dtype]
        ref = swiglu_ref(x.float(), w1.float(), w3.float()).to(x.dtype)
        return check_close(name, sg.swiglu_cuda(x, w1, w3), ref, rtol=rtol,
                           atol=atol, why=TOL["swiglu"]["why"])

    # swiglu: prefill (512 tokens) and decode (4 slots) of yi-6b's MLP gate
    swiglu_cases = []
    for N in (512, 4):
        for dtype in (torch.bfloat16, torch.float32):
            rtol, atol = TOL["swiglu"][dtype]
            x = randn(gen, N, 4096, dtype=dtype)
            w1 = randn(gen, 4096, 11008, dtype=dtype, scale=4096 ** -0.5)
            w3 = randn(gen, 4096, 11008, dtype=dtype, scale=4096 ** -0.5)
            err = check_swiglu(f"swiglu {dtype} ({N}, 4096)x(4096, 11008)",
                               x, w1, w3)
            if dtype == torch.bfloat16:
                nbytes = (x.numel() + w1.numel() + w3.numel() + N * 11008) * 2
                b, by = bound_ms(nbytes, 4 * N * 4096 * 11008, dtype)
                swiglu_cases.append({
                    "shape": f"x ({N}, 4096), w1/w3 (4096, 11008) bf16",
                    "max_abs_err": err, "rtol": rtol, "atol": atol,
                    "ms": timer(lambda: sg.swiglu_cuda(x, w1, w3)),
                    "plain_ms": timer(lambda: swiglu_ref(x, w1, w3)),
                    "library_ms": timer(lambda: F.silu(x @ w1) * (x @ w3)),
                    "library_call": "F.silu(x@w1)*(x@w3), a cuBLAS composition",
                    "bound_ms": b, "bound_by": by})
            del x, w1, w3
    rows["swiglu"] = {**swiglu_cases[0], "cases": swiglu_cases[1:]}

    # flash attention: causal prefill of 2048 tokens, yi-6b heads
    def flash_case(name, B, Sq, Skv, Hq, Hkv, hd, dtype, **kw):
        q = randn(gen, B, Sq, Hq, hd, dtype=dtype)
        k = randn(gen, B, Skv, Hkv, hd, dtype=dtype)
        v = randn(gen, B, Skv, Hkv, hd, dtype=dtype)
        out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ref, ref_lse = flash_attention_ref(qt, kt, vt, return_lse=True, **kw)
        rtol, atol = TOL["flash_attention"][dtype]
        scale = None
        if dtype == torch.bfloat16:                 # P@|V|, in fp32
            scale = flash_attention_ref(qt.float(), kt.float(), vt.float().abs(),
                                        **kw).transpose(1, 2)
        err = check_close(name, out, ref.transpose(1, 2), rtol=rtol, atol=atol,
                          why=TOL["flash_attention"]["why"], scale=scale,
                          scale_tol=FLASH_P_TOL)
        if dtype == torch.float32:
            seen = torch.isfinite(ref_lse)
            check_close(name + " lse", lse[seen], ref_lse[seen], rtol=1e-4, atol=1e-4,
                        why="fp32 log-sum-exp, other summation order")
        return err, (q, k, v)

    flash = {}
    for dtype in (torch.bfloat16, torch.float32):
        rtol, atol = TOL["flash_attention"][dtype]
        err, (q, k, v) = flash_case(f"flash {dtype} (1, 2048, 32q/4kv, 128) causal",
                                    1, 2048, 2048, 32, 4, 128, dtype, causal=True)
        if dtype == torch.bfloat16:
            S, hd = 2048, 128
            pairs = S * (S + 1) // 2                    # unmasked (q, k) pairs
            nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + 32 * S * 4
            b, by = bound_ms(nbytes, 4 * hd * pairs * 32, dtype)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            try:
                lib_ms = timer(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
            except TypeError:                           # torch without enable_gqa
                lib_ms = None
            flash = {
                "shape": "q (1, 2048, 32, 128), k/v (1, 2048, 4, 128) bf16 causal",
                "max_abs_err": err, "rtol": rtol, "atol": atol,
                "p_rounding_tol": FLASH_P_TOL,
                "ms": timer(lambda: fa.flash_attention_fwd_cuda(q, k, v, causal=True)),
                "plain_ms": timer(lambda: flash_attention_ref(qt, kt, vt, causal=True)),
                "library_ms": lib_ms,
                "library_call": "F.scaled_dot_product_attention(enable_gqa=True)",
                "bound_ms": b, "bound_by": by}
    rows["flash_attention"] = flash

    small = [  # (name, B, Sq, Skv, Hq, Hkv, hd, kwargs)
        ("window 64", 2, 256, 256, 4, 2, 128, dict(causal=True, sliding_window=64)),
        ("softcap 30", 1, 192, 192, 4, 4, 128, dict(causal=True, softcap=30.0)),
        ("q_offset 192, Sq<Skv", 2, 64, 256, 8, 2, 128, dict(causal=True, q_offset=192)),
        ("non-causal, ragged", 1, 100, 200, 4, 2, 128, dict(causal=False)),
        ("G=1", 1, 128, 128, 4, 4, 64, dict(causal=True)),
        ("G=8, hd 64", 1, 130, 130, 8, 1, 64, dict(causal=True)),
        ("window + q_offset", 1, 96, 160, 4, 2, 64,
         dict(causal=True, sliding_window=48, q_offset=64)),
    ]
    for name, B, Sq, Skv, Hq, Hkv, hd, kw in small:
        for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            flash_case(f"flash {tag} {name} (B{B}, Sq{Sq}, Skv{Skv}, {Hq}q/{Hkv}kv, {hd})",
                       B, Sq, Skv, Hq, Hkv, hd, dtype, **kw)
    # ragged rows for the other two kernels
    for dtype in (torch.bfloat16, torch.float32):
        x = randn(gen, 37, 256, dtype=dtype)
        w1 = randn(gen, 256, 520, dtype=dtype, scale=1 / 16)
        w3 = randn(gen, 256, 520, dtype=dtype, scale=1 / 16)
        check_swiglu(f"swiglu {dtype} ragged (37, 256)x(256, 520)", x, w1, w3)
        rtol, atol = TOL["rmsnorm"][dtype]
        w = (1 + 0.1 * torch.randn(256, generator=gen, device="cuda")).to(dtype)
        check_close(f"rmsnorm {dtype} (37, 256)", rn.rmsnorm_cuda(x, w, 1e-5),
                    rmsnorm_ref(x, w, 1e-5), rtol=rtol, atol=atol,
                    why=TOL["rmsnorm"]["why"])
    return rows


# ---------------------------------------------------------------------------
# phase 3: serve yi-6b at full width
# ---------------------------------------------------------------------------

# yi-6b bf16 last-token logits, kernels on vs off: max |d| over the logit range
LOGITS_REL_TOL = 0.05


def phase_serve(card: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.compute import ComputePolicy
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve_engine import Request, ServeEngine
    from repro_torch.runtime.serve_loop import greedy_generate

    # a reduced model in fp32: kernels=True against kernels=False, tightly
    red = Model(get_config("yi-6b").reduced(), torch.float32,
                compute=ComputePolicy(kernels=True), device="cuda")
    red.init(torch.Generator(device="cuda").manual_seed(1))
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, 512, (2, 40))).cuda()
    lk, _ = red.prefill({"tokens": toks}, 64)
    gk = greedy_generate(red, toks, 8, 64)
    red.compute = ComputePolicy(kernels=False)
    lp, _ = red.prefill({"tokens": toks}, 64)
    gp = greedy_generate(red, toks, 8, 64)
    check_close("yi-6b reduced fp32 prefill logits, kernels on vs off", lk, lp,
                rtol=1e-4, atol=1e-4,
                why="fp32 through 2 layers; the kernels only change summation order")
    if not torch.equal(gk, gp):
        raise AssertionError(f"reduced fp32 greedy tokens differ: {gk} vs {gp}")
    del red

    cfg = get_config("yi-6b")
    t0 = time.perf_counter()
    model = Model(cfg, torch.bfloat16, compute=ComputePolicy(kernels=True), device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.randint(64, 257, 8)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=32) for i, p in enumerate(prompts)]
    engine = ServeEngine(model, n_slots=4, cache_len=512, block_size=16)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    if sorted(out) != list(range(8)) or any(len(t) != 32 for t in out.values()):
        raise AssertionError("engine did not return 32 tokens for each of 8 requests")

    # request 0 against kernels=False on the card: last-token prefill logits
    # and the greedy stream
    p0 = torch.from_numpy(prompts[0].astype(np.int64))[None].cuda()
    lk, _ = model.prefill({"tokens": p0}, 512)
    model.compute = ComputePolicy(kernels=False)
    lp, _ = model.prefill({"tokens": p0}, 512)
    gp = greedy_generate(model, p0, 32, 512)[0].cpu().numpy()
    model.compute = ComputePolicy(kernels=True)
    rel = max_err(lk, lp) / float(lp.abs().max())
    agree = float(np.mean(gp == out[0]))
    first_diverge = int(np.argmax(gp != out[0])) if agree < 1 else 32
    recs = engine.records
    ttft = [r["t_first_token"] - r["t_arrival"] for r in recs]
    res = {"phase": "serve", "arch": cfg.name, "params": model.n_params(),
           "dtype": "bf16", "kernels": True, "n_slots": 4, "cache_len": 512,
           "block_size": 16, "requests": len(recs),
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "generated_tokens": int(sum(len(t) for t in out.values())),
           "init_s": t_init, "wall_s": wall, "ticks": engine.n_ticks,
           "ttft_first_s": float(min(ttft)), "ttft_p50_s": float(np.median(ttft)),
           "prefill_tok_s": engine.n_prefill_tokens / engine.prefill_s,
           "decode_tok_s": engine.n_decode_tokens / engine.decode_s,
           "launches": launches,
           "logits_vs_plain_max_abs_err": max_err(lk, lp),
           "logits_vs_plain_rel_err": rel, "logits_rel_tol": LOGITS_REL_TOL,
           "logits_tol_why": "bf16 through 32 layers; the kernels keep the gate "
                             "products in fp32 and round P in attention; about "
                             "2% of the logit range on an H100",
           "greedy_agree_vs_plain": agree, "greedy_first_divergence": first_diverge,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    emit(res)
    if not torch.isfinite(lk).all() or rel > LOGITS_REL_TOL:
        raise AssertionError(f"yi-6b logits kernels on vs off: rel err {rel}")
    phase_profile(model, prompts, card)
    return launches


# ---------------------------------------------------------------------------
# phase 3b: where the time goes (torch.profiler over prefill and decode)
# ---------------------------------------------------------------------------

def _profile(fn) -> dict:
    """Wall time of ``fn`` (synchronized), the device time summed over the
    kernels the profiler saw, the device's idle share, the ported kernels'
    share and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    if not by_name:
        return {"wall_s": wall, "device_busy_s": "not measured",
                "device_idle_share": "not measured"}
    busy = sum(ms for ms, _ in by_name.values()) / 1e3
    ported = sum(ms for name, (ms, _) in by_name.items()
                 if any(k in name for k in ("rmsnorm_kernel", "swiglu_", "flash_fwd_")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1 - busy / wall,
            "ported_kernels_share_of_busy": ported / 1e3 / busy,
            "top_kernels": [{"name": name[:70], "device_ms": ms, "calls": n}
                            for name, (ms, n) in top]}


def phase_profile(model, prompts, card: str) -> None:
    from repro_torch.runtime.serve_engine import Request, ServeEngine

    p = torch.from_numpy(prompts[0][:64].astype(np.int64))[None].cuda()
    p = torch.cat([p] * 4, dim=1)                      # one 256-token prompt
    prefill = _profile(lambda: model.prefill({"tokens": p}, 256))
    engine = ServeEngine(model, n_slots=4, cache_len=512, block_size=16)
    for i in range(4):
        engine.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=16))
    engine.step()                                      # 4 prefills + 1 tick
    ticks = 8

    def decode():
        for _ in range(ticks):
            engine.step()
    dec = _profile(decode)
    emit({"phase": "profile", "arch": "yi-6b", "dtype": "bf16", "kernels": True,
          "prefill_256_tokens": prefill, "decode_ticks": ticks, "n_slots": 4,
          "decode": dec, "decode_ms_per_tick": dec["wall_s"] / ticks * 1e3,
          "card": card})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    report = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "ptxas": {name: [ln.strip() for ln in r["log"].splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, r in report.items()}})

    timer = Timer()
    rows = phase_kernels(timer)
    del timer
    torch.cuda.empty_cache()
    launches = phase_serve(card)

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
         "replaces": TPU_SOURCES[name], "launches": launches[name], **rows[name],
         "card": card}
        for name in ("rmsnorm", "swiglu", "flash_attention")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
