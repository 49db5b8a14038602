"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (each prints JSON lines; any failure ends the run non-zero):
  1. device + build: the card's name and power limit, ``nvcc`` builds of
     every ``src/repro_torch/csrc/*.cu`` for sm_90a, all started at once;
  2. kernels: each CUDA kernel against its plain PyTorch version on the same
     inputs, at the main paths' shapes in bf16 and fp32 (serve prefill and
     decode; the train step's microbatch of 4 x 2048 tokens), plus small
     flavour cases (flash forward and backward: window, softcap, q_offset,
     non-causal ragged, G = 1, G = 8 at hd 64; CE: ragged N, valid_vocab <
     V, labels in the last partial block), then the kernel / plain /
     library / bound times;
  3. serve: yi-6b at full width in bf16 with kernels=True through
     ``ServeEngine`` (8 requests, 4 slots, paged pool); the serving kernels'
     launch counters must rise; the logits are held against a kernels=False
     run on the card, and a reduced fp32 model against kernels=False
     tightly; then a ``torch.profiler`` pass over prefill and decode;
  4. train: a reduced fp32 yi-6b (2 layers, hd 128) with kernels on vs off
     over 5 steps, tightly; then yi-6b at full width and 8 layers, bf16
     compute over fp32 master weights, remat full, kernels=True, 5 steps of
     global batch 8 (gas 2, 2048 tokens); all six kernels' counters must
     rise; the same steps with kernels=False from the same weights and
     batches, step 0 held to a bf16 limit; a ``torch.profiler`` pass over
     one step;
  5. the ``kernels`` line: per kernel its launches in the train step (and
     in serving), its error, and the kernel / plain / library / bound times.
The last line is the result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
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
# kernel -> (its CUDA source, the TPU kernel it replaces)
KERNELS = {
    "rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:22"),
    "swiglu": ("swiglu.cu", "src/repro/kernels/swiglu.py:24"),
    "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:48"),
    "flash_attention_bwd_dq": ("flash_attention_bwd.cu",
                               "src/repro/kernels/flash_attention.py:166"),
    "flash_attention_bwd_dkv": ("flash_attention_bwd.cu",
                                "src/repro/kernels/flash_attention.py:223"),
    "cross_entropy": ("cross_entropy.cu", "src/repro/kernels/cross_entropy.py:33"),
}
SERVE_KERNELS = ("rmsnorm", "swiglu", "flash_attention")


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
                atol: float, why: str, terms: tuple = ()) -> float:
    """|out - ref| <= atol + rtol*|ref| + the sum of tol*scale over ``terms``
    elementwise, else raise; each term (scale, tol, name) is an elementwise
    error scale the caller derives from the kernel's own arithmetic (flash:
    P@|V| for its rounding of P)."""
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: shape {tuple(out.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite output")
    diff = (out.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    rule = f"|d| <= {atol:g} + {rtol:g}*|ref|"
    for scale, tol, scale_name in terms:
        limit = limit + tol * scale.float()
        rule += f" + {tol:g}*({scale_name})"
    err = float(diff.max())
    share = diff / limit
    worst = float(share.max())
    at = [int(i) for i in np.unravel_index(int(share.argmax()), share.shape)]
    emit({"phase": "kernel_check", "case": name, "max_abs_err": err,
          "worst_share_of_limit": worst, "worst_at": at, "rule": rule, "why": why})
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


FLASH_FLAVOURS = [  # small cases of both flash checks: (name, B, Sq, Skv, Hq, Hkv, hd, kw)
    ("window 64", 2, 256, 256, 4, 2, 128, dict(causal=True, sliding_window=64)),
    ("softcap 30", 1, 192, 192, 4, 4, 128, dict(causal=True, softcap=30.0)),
    ("q_offset 192, Sq<Skv", 2, 64, 256, 8, 2, 128, dict(causal=True, q_offset=192)),
    ("non-causal, ragged", 1, 100, 200, 4, 2, 128, dict(causal=False)),
    ("G=1", 1, 128, 128, 4, 4, 64, dict(causal=True)),
    ("G=8, hd 64", 1, 130, 130, 8, 1, 64, dict(causal=True)),
    ("window + q_offset", 1, 96, 160, 4, 2, 64,
     dict(causal=True, sliding_window=48, q_offset=64)),
    ("window + q_offset + softcap", 1, 96, 160, 4, 2, 64,
     dict(causal=True, sliding_window=48, q_offset=64, softcap=20.0)),
]


def phase_kernels(timer: Timer) -> dict:
    from repro_torch.kernels import flash_attention as fa, rmsnorm as rn, swiglu as sg
    from repro_torch.kernels.ref import flash_attention_ref, rmsnorm_ref, swiglu_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}

    # rmsnorm: the prefill norm of 2048 tokens of yi-6b, and the train
    # step's 4 x 2048 rows
    for rows_n, dtype in ((2048, torch.bfloat16), (2048, torch.float32),
                          (8192, torch.bfloat16), (8192, torch.float32)):
        rtol, atol = TOL["rmsnorm"][dtype]
        x = randn(gen, rows_n, 4096, dtype=dtype)
        w = (1 + 0.1 * torch.randn(4096, generator=gen, device="cuda")).to(dtype)
        err = check_close(f"rmsnorm {dtype} ({rows_n}, 4096)", rn.rmsnorm_cuda(x, w, 1e-5),
                          rmsnorm_ref(x, w, 1e-5), rtol=rtol, atol=atol,
                          why=TOL["rmsnorm"]["why"])
        if rows_n == 2048 and dtype == torch.bfloat16:
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

    # swiglu: prefill (512 tokens), decode (4 slots) and the train step's
    # microbatch (4 x 2048 tokens) of yi-6b's MLP gate
    swiglu_cases = []
    for N in (512, 4, 8192):
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
                          why=TOL["flash_attention"]["why"],
                          terms=() if scale is None else ((scale, FLASH_P_TOL, "P@|V|"),))
        if dtype == torch.float32:
            seen = torch.isfinite(ref_lse)
            check_close(name + " lse", lse[seen], ref_lse[seen], rtol=1e-4, atol=1e-4,
                        why="fp32 log-sum-exp, other summation order")
        return err, (q, k, v)

    # flash attention: causal prefill of 2048 tokens (B = 1) and the train
    # step's microbatch (B = 4), yi-6b heads
    flash_rows = []
    for B in (1, 4):
        for dtype in (torch.bfloat16, torch.float32):
            rtol, atol = TOL["flash_attention"][dtype]
            err, (q, k, v) = flash_case(f"flash {dtype} ({B}, 2048, 32q/4kv, 128) causal",
                                        B, 2048, 2048, 32, 4, 128, dtype, causal=True)
            if dtype != torch.bfloat16:
                continue
            S, hd = 2048, 128
            pairs = B * 32 * S * (S + 1) // 2           # unmasked (q, k) pairs
            nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + B * 32 * S * 4
            b, by = bound_ms(nbytes, 4 * hd * pairs, dtype)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            try:
                lib_ms = timer(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
            except TypeError:                           # torch without enable_gqa
                lib_ms = None
            flash_rows.append({
                "shape": f"q ({B}, 2048, 32, 128), k/v ({B}, 2048, 4, 128) bf16 causal",
                "max_abs_err": err, "rtol": rtol, "atol": atol,
                "p_rounding_tol": FLASH_P_TOL,
                "ms": timer(lambda: fa.flash_attention_fwd_cuda(q, k, v, causal=True)),
                "plain_ms": timer(lambda: flash_attention_ref(qt, kt, vt, causal=True)),
                "library_ms": lib_ms,
                "library_call": "F.scaled_dot_product_attention(enable_gqa=True)",
                "bound_ms": b, "bound_by": by})
            del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    rows["flash_attention"] = {**flash_rows[0], "cases": flash_rows[1:]}

    for name, B, Sq, Skv, Hq, Hkv, hd, kw in FLASH_FLAVOURS:
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
# phase 2b: the training slice's kernels (flash backward, blocked CE)
# ---------------------------------------------------------------------------

# flash backward: the kernel rounds P (for dV) and dS (for dQ and dK) to bf16
# before its products, at most 2^-8 of each value, so its error is bounded
# by 2^-8 times the products of the absolute values (|dS|@|K|*scale,
# |dS|^T@|Q|*scale, P^T@|dO|, from the plain version), plus the rounding of
# the output to bf16 (2^-8 of the value); 10% margin on both.  The rest is
# fp32 summation order over up to 16k terms: 1e-4 of the same scale.  fp32
# runs FFMA only: 1e-5 of the value and 1e-4 of the scale.  A dropped
# 64-key tile moves a gradient by a few percent of its scale.  Both dtypes:
# dS = P*(dP - delta) takes the difference of two fp32 sums of up to 128
# exact products, which cancel where dS is near 0 (query row 0 of a causal
# head exactly: O = V_0); another summation order moves each by at most
# 128*2^-24 of its absolute sum, so dQ and dK also get 128*2^-24 of
# C@|K|*scale and C^T@|Q|*scale, C = P*(|dO|@|V|^T + rowsum|dO*O|).
FLASH_BWD_TOL = {torch.bfloat16: (1.1 * 2.0 ** -8, 1.1 * 2.0 ** -8 + 1e-4),
                 torch.float32: (1e-5, 1e-4)}
FLASH_BWD_CANCEL_TOL = 128 * 2.0 ** -24
FLASH_BWD_WHY = ("bf16: P and dS rounded to bf16 inside the kernel, bounded by "
                 "2^-8 of the absolute-value products, and one rounding of the "
                 "output; fp32: FFMA, summation order; both: the cancelling "
                 "difference dP - delta in another summation order")
# CE: the kernel and the plain version both form fp32 sums of the same exact
# products (bf16 x bf16 is exact in fp32), in another order over d: 2e-5 of
# |h|@|w| (the label's column for the label logit, the row's largest for the
# lse), far below the ~3% of the mass that one missed 2048-column block takes.
CE_SCALE_TOL = 2e-5
CE_WHY = "fp32 sums of exact products in another order over d"


def flash_bwd_case(name, gen, B, Sq, Skv, Hq, Hkv, hd, dtype, **kw):
    """Forward kernel, then the two backward kernels against
    ``flash_attention_bwd_ref`` on the same q, k, v, o, lse and dO."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    q = randn(gen, B, Sq, Hq, hd, dtype=dtype)
    k = randn(gen, B, Skv, Hkv, hd, dtype=dtype)
    v = randn(gen, B, Skv, Hkv, hd, dtype=dtype)
    do = randn(gen, B, Sq, Hq, hd, dtype=dtype)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    ref, scales, cancel = flash_attention_bwd_ref(
        *(t.float().transpose(1, 2) for t in (q, k, v, o)), lse,
        do.float().transpose(1, 2), return_scales=True, **kw)
    rtol, stol = FLASH_BWD_TOL[dtype]
    terms = (((scales[0], stol, "|dS|@|K|*scale"),
              (cancel[0], FLASH_BWD_CANCEL_TOL, "C@|K|*scale")),
             ((scales[1], stol, "|dS|^T@|Q|*scale"),
              (cancel[1], FLASH_BWD_CANCEL_TOL, "C^T@|Q|*scale")),
             ((scales[2], stol, "P^T@|dO|"),))
    del scales, cancel
    errs = []
    for gname, out, r, gterms in zip(("dq", "dk", "dv"), grads, ref, terms):
        errs.append(check_close(f"{name} {gname}", out, r.transpose(1, 2), rtol=rtol,
                                atol=1e-6, why=FLASH_BWD_WHY,
                                terms=tuple((sc.transpose(1, 2), tol, sn)
                                            for sc, tol, sn in gterms)))
    return errs, (q, k, v, o, lse, do)


def ce_case(name, gen, N, d, V, dtype, valid_vocab=None, labels=None):
    """The CE kernel against ``cross_entropy_ref`` on the same h, w, labels."""
    from repro_torch.kernels import cross_entropy as ce
    from repro_torch.kernels.ref import cross_entropy_ref

    h = randn(gen, N, d, dtype=dtype)
    w = randn(gen, d, V, dtype=dtype, scale=d ** -0.5)
    if labels is None:
        labels = torch.randint(0, valid_vocab or V, (N,), generator=gen, device="cuda")
    lse, ll = ce.cross_entropy_cuda(h, w, labels, valid_vocab)
    rlse, rll = cross_entropy_ref(h, w, labels, valid_vocab)
    absw = h.float().abs() @ w.float().abs()
    if valid_vocab is not None:
        absw[:, valid_vocab:] = 0
    lab_scale = torch.gather(absw, 1, labels.long()[:, None])[:, 0]
    e1 = check_close(f"{name} lse", lse, rlse, rtol=0, atol=1e-6, why=CE_WHY,
                     terms=((absw.amax(1), CE_SCALE_TOL, "max |h|@|w|"),))
    e2 = check_close(f"{name} label_logit", ll, rll, rtol=0, atol=1e-6, why=CE_WHY,
                     terms=((lab_scale, CE_SCALE_TOL, "|h|@|w| at label"),))
    return max(e1, e2), (h, w, labels)


def flash_bwd_times(timer: Timer, errs: list, q, k, v, o, lse, do) -> tuple[dict, dict]:
    """The dQ and dK/dV rows of the kernels line at q's shape (causal)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    B, S, Hq, hd = q.shape
    pairs = B * Hq * S * (S + 1) // 2               # unmasked (q, k) pairs
    args, _ = fa.bwd_args(q, k, v, o, lse, do, causal=True)
    qt, kt, vt, ot, dot = (t.transpose(1, 2) for t in (q, k, v, o, do))
    plain_ms = timer(lambda: flash_attention_bwd_ref(qt, kt, vt, ot, lse, dot))
    try:
        ql, kl, vl = (t.detach().requires_grad_() for t in (qt, kt, vt))
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
        lib_ms = timer(lambda: torch.autograd.grad(out, (ql, kl, vl), dot,
                                                   retain_graph=True))
    except TypeError:                               # torch without enable_gqa
        lib_ms = None
    el = q.element_size()
    common = {"shape": f"q/o/dO ({B}, {S}, {Hq}, {hd}), k/v ({B}, {S}, {k.shape[2]}, "
                       f"{hd}) bf16 causal",
              "plain_ms": plain_ms, "plain_call": "flash_attention_bwd_ref (dq, dk, dv)",
              "library_ms": lib_ms,
              "library_call": "SDPA(enable_gqa=True) backward on a retained graph "
                              "(dq, dk and dv together)",
              "bwd_bound_ms": bound_ms(0, 5 * 2 * hd * pairs, q.dtype)[0]}
    # dQ: S, dP and dS@K over the unmasked pairs; reads Q, K, V, dO, LSE,
    # delta and writes dQ
    b, by = bound_ms(el * (3 * q.numel() + 2 * k.numel()) + 8 * B * Hq * S,
                     3 * 2 * hd * pairs, q.dtype)
    dq = {**common, "max_abs_err": errs[0], "ms": timer(lambda: fa.launch_bwd_dq(args)),
          "bound_ms": b, "bound_by": by}
    # dK/dV: S^T, dP^T, dS^T@Q and P^T@dO; writes dK and dV
    b, by = bound_ms(el * (2 * q.numel() + 4 * k.numel()) + 8 * B * Hq * S,
                     4 * 2 * hd * pairs, q.dtype)
    dkv = {**common, "max_abs_err": max(errs[1:]),
           "ms": timer(lambda: fa.launch_bwd_dkv(args)), "bound_ms": b, "bound_by": by}
    return dq, dkv


def phase_kernels_train(timer: Timer) -> dict:
    from repro_torch.kernels import cross_entropy as ce
    from repro_torch.kernels.ref import cross_entropy_ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    # flash backward at the forward's timed shape (B = 1) and the train
    # step's microbatch (B = 4): causal S = 2048, yi-6b heads
    timed = []
    for B in (1, 4):
        for dtype in (torch.bfloat16, torch.float32):
            errs, tensors = flash_bwd_case(
                f"flash bwd {dtype} ({B}, 2048, 32q/4kv, 128) causal", gen, B, 2048, 2048,
                32, 4, 128, dtype, causal=True)
            if dtype == torch.bfloat16:
                timed.append(flash_bwd_times(timer, errs, *tensors))
            del tensors
            torch.cuda.empty_cache()
    rows = {"flash_attention_bwd_dq": {**timed[0][0], "cases": [timed[1][0]]},
            "flash_attention_bwd_dkv": {**timed[0][1], "cases": [timed[1][1]]}}
    for name, B, Sq, Skv, Hq_, Hkv, hd_, kw in FLASH_FLAVOURS:
        for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            flash_bwd_case(f"flash bwd {tag} {name} (B{B}, Sq{Sq}, Skv{Skv}, "
                           f"{Hq_}q/{Hkv}kv, {hd_})", gen, B, Sq, Skv, Hq_, Hkv, hd_,
                           dtype, **kw)

    # CE at the train step's shape: a microbatch of 4 x 2047 tokens of yi-6b
    N, d, V = 4 * 2047, 4096, 64000
    for dtype in (torch.bfloat16, torch.float32):
        err, (h, w, labels) = ce_case(f"ce {dtype} ({N}, {d})x({d}, {V})", gen, N, d, V,
                                      dtype)
        if dtype == torch.bfloat16:
            b, by = bound_ms(2 * (h.numel() + w.numel()) + 8 * N + 8 * N,
                             2 * N * d * V, dtype)
            rows["cross_entropy"] = {
                "shape": f"h ({N}, {d}), w ({d}, {V}) bf16", "max_abs_err": err,
                "ms": timer(lambda: ce.cross_entropy_cuda(h, w, labels)),
                "plain_ms": timer(lambda: cross_entropy_ref(h, w, labels)),
                "plain_call": "cross_entropy_ref (materialized fp32 logits)",
                "library_ms": timer(lambda: F.cross_entropy(
                    (h @ w).float(), labels, reduction="none")),
                "library_call": "F.cross_entropy on (h @ w).float()",
                "bound_ms": b, "bound_by": by}
        del h, w, labels
    torch.cuda.empty_cache()
    V2 = 1000   # not a multiple of the 128-column tile; last chunk partial
    labels = torch.tensor([996, 999, 0, 640] * 250, device="cuda")[:1000]
    for dtype in (torch.bfloat16, torch.float32):
        ce_case(f"ce {dtype} ragged (1000, 256)x(256, {V2}), valid 997, last-block labels",
                gen, 1000, 256, V2, dtype, valid_vocab=997, labels=labels)
        ce_case(f"ce {dtype} ragged (37, 512)x(512, 2056), 2 chunks", gen, 37, 512, 2056,
                dtype)
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
    launches = {k: ops.launch_counts()[k] for k in SERVE_KERNELS}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched on the serve path: {launches}")
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

# device-time groups of the profile, by kernel name (first match wins)
PROFILE_GROUPS = (
    ("rmsnorm kernel", ("rmsnorm_kernel",)),
    ("swiglu kernel", ("swiglu_",)),
    ("flash fwd kernel", ("flash_fwd_",)),
    ("flash bwd kernels", ("flash_bwd_",)),
    ("ce kernels", ("ce_partial_", "ce_merge_")),
    ("fp32 GEMMs", ("f32f32_f32f32", "sgemm")),
    ("other GEMMs", ("gemm", "nvjet", "cutlass")),
)
PORTED = {"rmsnorm kernel", "swiglu kernel", "flash fwd kernel", "flash bwd kernels",
          "ce kernels"}


def _profile(fn) -> dict:
    """Wall time of ``fn`` (synchronized), the device time summed over the
    kernels the profiler saw, the device's idle share, the ported kernels'
    share, the device time by group and the top kernels by device time."""
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
    groups: dict[str, float] = {}
    for name, (ms, _) in by_name.items():
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)),
                     "elementwise and other")
        groups[group] = groups.get(group, 0.0) + ms
    ported = sum(ms for g, ms in groups.items() if g in PORTED)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1 - busy / wall,
            "ported_kernels_share_of_busy": ported / 1e3 / busy,
            "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
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


# ---------------------------------------------------------------------------
# phase 4: the training step of yi-6b at full width
# ---------------------------------------------------------------------------

# fp32 reduced model, kernels on vs off: the kernels change only summation
# order, and AdamW's normalisation carries that into the weights; over 5
# steps the CPU tests see ~5e-7.
TRAIN_FP32_RTOL = 1e-4
# bf16 yi-6b (8 layers), step 0 kernels on vs off, relative; set from the
# readings of tools/step0_limits.py (NVIDIA H100 80GB HBM3, 700 W; 3 weight
# seeds, each with its own batch).  Sound runs differ by at most 1.27e-5 in
# loss and 6.65e-4 in grad_norm (seed 0, the one run here, is the largest);
# the limits are about 1.5x those.  One 64-row tile of a kernel's output zeroed
# moves grad_norm by 8.9e-3 (swiglu forward) and 1.4e-3 (dK/dV), which fail
# here; in the flash forward or dQ it moves it by 7.1e-4 and 6.7e-4, inside
# the sound spread, and the loss by less than the spread for every fault:
# phase 2 holds those kernels at the step's shapes.
TRAIN_BF16_LOSS_RTOL = 2e-5
TRAIN_BF16_GNORM_RTOL = 1e-3
TRAIN = dict(layers=8, global_batch=8, gas=2, seq_len=2048, steps=5)
TRAIN_LR = 1e-4


def _batches(vocab: int, seq_len: int, global_batch: int, n: int) -> list:
    from repro_torch.data import SyntheticCorpus, make_batch_iterator

    it = make_batch_iterator(SyntheticCorpus(vocab_size=vocab, seed=0),
                             seq_len=seq_len, global_batch=global_batch, prefetch=0)
    return [next(it) for _ in range(n)]


def _run_steps(model, plan, batches, seed: int) -> list[dict]:
    """Fresh train state from ``seed``, then one step per batch; per step its
    metrics and synchronized wall time."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_loop import build_train_step, init_train_state

    opt = AdamWConfig(lr=TRAIN_LR)
    state = init_train_state(model, opt, plan,
                             torch.Generator(device="cuda").manual_seed(seed))
    step = build_train_step(model, opt, plan)
    out = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "step_s": time.perf_counter() - t0})
    del state
    return out


def phase_train(card: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import costmodel
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_loop import (ParallelPlan, build_train_step,
                                                init_train_state)

    # reduced yi-6b in fp32 with hd 128: kernels on vs off, tightly
    red_cfg = get_config("yi-6b").reduced(head_dim=128)
    red = Model(red_cfg, torch.float32, device="cuda")
    rb = _batches(red_cfg.vocab_size, 256, 4, 5)
    runs = {k: _run_steps(red, ParallelPlan(gas=2, precision="fp32", kernels=k), rb, 1)
            for k in (True, False)}
    for i, (a, b) in enumerate(zip(runs[True], runs[False])):
        for key in ("loss", "grad_norm"):
            rel = abs(a[key] - b[key]) / abs(b[key])
            if not np.isfinite(a[key]) or rel > TRAIN_FP32_RTOL:
                raise AssertionError(f"reduced fp32 train step {i} {key}: kernels "
                                     f"{a[key]} vs plain {b[key]} (rel {rel:.2e})")
    emit({"phase": "train_reduced_fp32", "arch": red_cfg.name, "head_dim": 128,
          "steps": 5, "gas": 2, "seq_len": 256, "global_batch": 4,
          "kernels_on": runs[True], "kernels_off": runs[False],
          "rtol": TRAIN_FP32_RTOL})
    del red
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=TRAIN["layers"])
    gb, gas, S = TRAIN["global_batch"], TRAIN["gas"], TRAIN["seq_len"]
    model = Model(cfg, torch.float32, device="cuda")
    batches = _batches(cfg.vocab_size, S, gb, TRAIN["steps"])
    plan = ParallelPlan(gas=gas, precision="bf16", remat="full", kernels=True)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    on = _run_steps(model, plan, batches, 0)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops = costmodel.train_step_flops(cfg, gb, S).total
    for r in on:
        r["tokens_per_s"] = gb * S / r["step_s"]
        r["mfu"] = costmodel.mfu(flops, r["step_s"], costmodel.H100.peak_flops)
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched in the train step: {launches}")
    per_layer_mb = cfg.n_layers * gas * TRAIN["steps"]
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        if launches[name] != per_layer_mb:
            raise AssertionError(f"{name}: {launches[name]} launches, expected one per "
                                 f"layer per microbatch ({per_layer_mb})")
    if not all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in on):
        raise AssertionError(f"non-finite train metrics: {on}")
    opt = AdamWConfig(lr=TRAIN_LR)
    pstate = init_train_state(model, opt, plan)        # the weights as they are
    pstep = build_train_step(model, opt, plan)
    prof = _profile(lambda: pstep(pstate, batches[0]))
    del pstate
    torch.cuda.empty_cache()
    off = _run_steps(model, ParallelPlan(gas=gas, precision="bf16", remat="full",
                                         kernels=False), batches, 0)
    rel_loss = abs(on[0]["loss"] - off[0]["loss"]) / off[0]["loss"]
    rel_gn = abs(on[0]["grad_norm"] - off[0]["grad_norm"]) / off[0]["grad_norm"]
    med = float(np.median([r["step_s"] for r in on[1:]]))
    res = {"phase": "train", "arch": cfg.name, "layers": cfg.n_layers,
           "params": model.n_params(), "precision": "bf16 compute, fp32 master",
           "remat": "full", "kernels": True, "global_batch": gb, "gas": gas,
           "seq_len": S, "steps": on, "median_step_s": med,
           "median_tokens_per_s": gb * S / med,
           "median_mfu": costmodel.mfu(flops, med, costmodel.H100.peak_flops),
           "flops_per_step": flops, "peak_mem_gb": peak, "launches": launches,
           "kernels_off_steps": off, "step0_loss_rel_diff": rel_loss,
           "step0_grad_norm_rel_diff": rel_gn,
           "loss_rtol": TRAIN_BF16_LOSS_RTOL, "grad_norm_rtol": TRAIN_BF16_GNORM_RTOL,
           "profile_one_step": prof, "card": card}
    emit(res)
    if rel_loss > TRAIN_BF16_LOSS_RTOL or rel_gn > TRAIN_BF16_GNORM_RTOL:
        raise AssertionError(f"yi-6b step 0 kernels on vs off: loss rel {rel_loss:.2e}, "
                             f"grad_norm rel {rel_gn:.2e}")
    return launches



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
    rows.update(phase_kernels_train(timer))
    del timer
    torch.cuda.empty_cache()
    serve_launches = phase_serve(card)
    torch.cuda.empty_cache()
    train_launches = phase_train(card)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
         "replaces": replaces, "launches": train_launches[name],
         "launches_serve": serve_launches.get(name, 0), **rows[name], "card": card}
        for name, (src, replaces) in KERNELS.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
