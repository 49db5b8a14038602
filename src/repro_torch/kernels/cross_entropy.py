"""Blocked cross-entropy: the CUDA kernel of ``csrc/cross_entropy.cu``
(ported from ``repro/kernels/cross_entropy.py:_ce_kernel``), its plain
version, and the ``torch.autograd.Function`` of the per-token losses.

The kernel returns per-token (lse, label_logit) in fp32 without writing the
(N, V) logits to memory.  The Function's forward is the kernel for a CUDA
tensor (or raises) and ``kernels/ref.py:cross_entropy_ref`` for a CPU
tensor; it saves (h, w, labels, lse), and its backward is plain torch on
both (``kernels/ref.py:cross_entropy_bwd_ref``), chunked over tokens as the
reference's ``_ce_tokens_bwd``.  ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import cross_entropy_bwd_ref, cross_entropy_ref

launches = 0
VOCAB_CHUNK = 2048   # vocab columns per block; must match csrc/cross_entropy.cu


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("cross_entropy")
    lib.cross_entropy_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                                      + [ctypes.c_void_p])
    lib.cross_entropy_fwd.restype = ctypes.c_int
    return lib


def cross_entropy_cuda(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                       valid_vocab: int | None = None):
    """h: (N, d), w: (d, V) on the card in one dtype, labels: (N,) ints ->
    (lse (N,), label_logit (N,)) fp32; columns >= ``valid_vocab`` are masked."""
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
    if h.dtype == torch.bfloat16 and (d % 32 or V % 8):
        raise ValueError(f"cross_entropy: bf16 needs d % 32 == 0 and V % 8 == 0, "
                         f"got d={d}, V={V}")
    h, w = _build.aligned(h), _build.aligned(w)
    labels = labels.to(torch.int64).contiguous()
    lse = torch.empty(N, dtype=torch.float32, device=h.device)
    label_logit = torch.full((N,), -1e30, dtype=torch.float32, device=h.device)
    n_chunks = -(-V // VOCAB_CHUNK)
    partial = torch.empty((n_chunks, N, 2), dtype=torch.float32, device=h.device)
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
