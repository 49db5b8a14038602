"""Blocked cross-entropy: the CUDA kernel of ``csrc/cross_entropy.cu``
(ported from ``repro/kernels/cross_entropy.py:_ce_kernel``), its plain
version, and the ``torch.autograd.Function`` of the per-token losses.

The kernel returns per-token (lse, label_logit) in fp32 without writing the
(N, V) logits to memory.  The Function's forward is the kernel for a CUDA
tensor (or raises) and ``kernels/ref.py:cross_entropy_ref`` for a CPU
tensor; it saves (h, w, labels, lse), and its backward is plain torch on
both (``kernels/ref.py:cross_entropy_bwd_ref``), chunked over tokens as the
reference's ``_ce_tokens_bwd``.  ``launches`` counts the kernel's launches.

The kernel reduces each tile of logits to one (max, sumexp) pair per row
and a second pass merges a row's pairs into its lse; :func:`partials_ref`
and :func:`merge_ref` are that algebra in plain torch, and ``TILE_M``,
``TILE_N`` and :func:`n_partials` mirror the C entry's tiling, for the
tests and ``chip_smoke.py``.

The bf16 kernel reads W through a TMA map, whose row stride must be a
multiple of 16 bytes: V % 8 == 0.  A vocab that is not (seamless-m4t's
256206, and its 128103-column shard at tp = 2) is handed to the kernel as
W with zero columns up to the next multiple of 8 (:func:`pad_vocab`, one
copy of W a call) and ``valid_vocab`` at most the true V, which the kernel
masks: the pad columns never enter the logsumexp, and the backward, on the
unpadded W, never sees them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.compute import kernel_forward
from repro_torch.kernels import _build
from repro_torch.kernels.ref import cross_entropy_bwd_ref, cross_entropy_ref

launches = 0
NEG_INF = -1e30
# The bf16 kernel's tile (csrc/cross_entropy.cu: 128 token rows x 256 vocab
# columns, taken in kernels/tiling.py's tile_order) and the vocab columns
# behind each (max, sumexp) partial of a row: a tile's in bf16, a block's
# 2048-column chunk in fp32.
TILE_M, TILE_N = 128, 256
VOCAB_CHUNK = {torch.bfloat16: TILE_N, torch.float32: 2048}
# the bf16 kernel's vocab multiple: a TMA row stride of 16 bytes
VOCAB_ALIGN = 8


def pad_vocab(w: torch.Tensor) -> torch.Tensor:
    """``w`` (d, V) with zero columns up to the next multiple of ``VOCAB_ALIGN``
    (``w`` itself when V is one already): what the bf16 kernel takes, with
    ``valid_vocab`` <= V masking the pad."""
    V = w.shape[1]
    if V % VOCAB_ALIGN == 0:
        return w
    out = w.new_zeros((w.shape[0], V + (-V % VOCAB_ALIGN)))
    out[:, :V] = w
    return out


def n_partials(V: int, dtype: torch.dtype) -> int:
    """(max, sumexp) partials a row (csrc/cross_entropy.cu:
    ``cross_entropy_partials``)."""
    return -(-V // VOCAB_CHUNK[dtype])


def partials_ref(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                 valid_vocab: int | None = None, chunk: int = TILE_N):
    """The kernel's first pass in plain torch, in h's dtype: per ``chunk``
    columns of h @ w, each row's max over the columns below ``valid_vocab``
    (-1e30 if none) and its sumexp against that max (0 if none), as
    (m, s) of shape (partials, N); and each row's label logit, taken from
    the chunk that holds the label (-1e30 if the label is masked)."""
    logits = h @ w
    N, V = logits.shape
    vv = V if valid_vocab is None else valid_vocab
    valid = torch.arange(V, device=h.device) < vv
    ms, ss = [], []
    for c0 in range(0, V, chunk):
        x = logits[:, c0:c0 + chunk]
        ok = valid[c0:c0 + chunk]
        m = torch.where(ok, x, torch.full_like(x, -torch.inf)).amax(1)
        m = torch.where(torch.isfinite(m), m, torch.full_like(m, NEG_INF))
        ss.append(torch.where(ok, torch.exp(x - m[:, None]), torch.zeros_like(x)).sum(1))
        ms.append(m)
    lab = labels.long()
    ll = torch.gather(logits, 1, lab[:, None])[:, 0]
    ll = torch.where(lab < vv, ll, torch.full_like(ll, NEG_INF))
    return torch.stack(ms), torch.stack(ss), ll


def merge_ref(m: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The kernel's second pass (csrc/cross_entropy.cu: ``ce_merge_kernel``):
    each row's partials folded in order as a running (max, sumexp),
    skipping those with sumexp 0; lse = max + log(sumexp), -1e30 if none."""
    run_m = torch.full_like(m[0], NEG_INF)
    run_s = torch.zeros_like(s[0])
    for mc, sc in zip(m, s):
        use = sc > 0
        new_m = torch.where(use, torch.maximum(run_m, mc), run_m)
        run_s = torch.where(use, run_s * torch.exp(run_m - new_m) + sc * torch.exp(mc - new_m),
                            run_s)
        run_m = new_m
    return torch.where(run_s > 0, run_m + torch.log(run_s), torch.full_like(run_m, NEG_INF))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("cross_entropy")
    lib.cross_entropy_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                                      + [ctypes.c_void_p])
    lib.cross_entropy_fwd.restype = ctypes.c_int
    lib.cross_entropy_partials.argtypes = [ctypes.c_int] * 2
    lib.cross_entropy_partials.restype = ctypes.c_int
    lib.cross_entropy_tile.argtypes = []
    lib.cross_entropy_tile.restype = ctypes.c_int
    return lib


def tiling_cuda(V: int, dtype: torch.dtype) -> tuple[tuple[int, int], int]:
    """The bf16 tile and the partials a row that the C entry reports (to
    hold ``TILE_M``, ``TILE_N`` and :func:`n_partials` to it on the card)."""
    lib = _lib()
    code = lib.cross_entropy_tile()
    parts = lib.cross_entropy_partials(V, 1 if dtype == torch.bfloat16 else 0)
    return (code >> 16, code & 0xFFFF), parts


def cross_entropy_cuda(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                       valid_vocab: int | None = None):
    """h: (N, d), w: (d, V) on the card in one dtype, labels: (N,) ints ->
    (lse (N,), label_logit (N,)) fp32; columns >= ``valid_vocab`` are masked.
    A bf16 W whose V is no multiple of 8 is padded (:func:`pad_vocab`)."""
    global launches
    code = _build.dtype_code(h)
    N, d = h.shape
    V = w.shape[1]
    vv = V if valid_vocab is None else valid_vocab
    if (not h.is_cuda or w.dtype != h.dtype or w.device != h.device
            or w.shape[0] != d or labels.shape != (N,) or labels.device != h.device
            or labels.dtype.is_floating_point or not 0 < vv <= V):
        raise ValueError(f"cross_entropy: h {h.dtype} {tuple(h.shape)}, w {w.dtype} "
                         f"{tuple(w.shape)}, labels {labels.dtype} "
                         f"{tuple(labels.shape)}, valid_vocab {valid_vocab}")
    if h.dtype == torch.bfloat16:
        if d % 8:
            raise ValueError(f"cross_entropy: bf16 needs d % 8 == 0, got d={d}")
        w = pad_vocab(w)
        V = w.shape[1]
    h, w = _build.aligned(h), _build.aligned(w)
    labels = labels.to(torch.int64).contiguous()
    lse = torch.empty(N, dtype=torch.float32, device=h.device)
    label_logit = torch.full((N,), NEG_INF, dtype=torch.float32, device=h.device)
    partial = torch.empty((n_partials(V, h.dtype), N, 2), dtype=torch.float32,
                          device=h.device)
    lib = _lib()
    err = lib.cross_entropy_fwd(h.data_ptr(), w.data_ptr(), labels.data_ptr(),
                                lse.data_ptr(), label_logit.data_ptr(),
                                partial.data_ptr(), N, d, V, vv, code,
                                _build.stream_of(h))
    _build.check(lib, err, "cross_entropy_fwd")
    launches += 1
    return lse, label_logit


class CrossEntropyTokens(torch.autograd.Function):
    @staticmethod
    @kernel_forward
    def forward(ctx, h, w, labels, valid_vocab):
        if h.device.type == "cpu":
            lse, ll = cross_entropy_ref(h, w, labels, valid_vocab)
        else:
            lse, ll = cross_entropy_cuda(h, w, labels, valid_vocab)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.valid_vocab = valid_vocab
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        dh, dw = cross_entropy_bwd_ref(h, w, labels, lse, g, ctx.valid_vocab)
        return dh, dw, None, None


def cross_entropy_tokens(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                         valid_vocab: int | None = None) -> torch.Tensor:
    """Per-token losses (N,) fp32; differentiable in h and w."""
    return CrossEntropyTokens.apply(h, w, labels, valid_vocab)
