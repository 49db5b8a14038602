"""Fused LayerNorm: the CUDA forward kernel of ``csrc/layernorm.cu`` (ported
from ``repro/kernels/layernorm.py:_layernorm_kernel``), its plain version,
and the ``torch.autograd.Function`` that carries the gradient.

The Function's forward is the kernel for a CUDA tensor (or raises) and the
plain version for a CPU tensor; its backward is the reference's fp32
formula in plain torch (``kernels/ref.py:layernorm_bwd_ref``) on both, from
the saved x and w, as the reference's backward is jnp.  ``launches`` counts
the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.compute import kernel_forward
from repro_torch.kernels import _build
from repro_torch.kernels.ref import layernorm_bwd_ref, layernorm_ref

launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("layernorm")
    lib.layernorm_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                                          ctypes.c_float, ctypes.c_int,
                                                          ctypes.c_void_p]
    lib.layernorm_fwd.restype = ctypes.c_int
    return lib


def layernorm_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """x: (..., d) on the card, w/b: (d,) of x's dtype -> x's shape and dtype."""
    global launches
    code = _build.dtype_code(x)
    d = x.shape[-1]
    if (not x.is_cuda or any(t.device != x.device or t.dtype != x.dtype
                             or t.shape != (d,) for t in (w, b))):
        raise ValueError(f"layernorm: x {x.dtype} {tuple(x.shape)} on {x.device}, "
                         f"w {w.dtype} {tuple(w.shape)} on {w.device}, "
                         f"b {b.dtype} {tuple(b.shape)} on {b.device}")
    if (d * x.element_size()) % 16:
        raise ValueError(f"layernorm: d={d} is not a whole number of 16-byte vectors")
    x2 = _build.aligned(x.reshape(-1, d))
    w, b = _build.aligned(w), _build.aligned(b)
    y = torch.empty_like(x2)
    lib = _lib()
    err = lib.layernorm_fwd(x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                            x2.shape[0], d, eps, code, _build.stream_of(x))
    _build.check(lib, err, "layernorm_fwd")
    launches += 1
    return y.reshape(x.shape)


class LayerNorm(torch.autograd.Function):
    @staticmethod
    @kernel_forward
    def forward(ctx, x, w, b, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        ctx.b_dtype = b.dtype
        if x.device.type == "cpu":
            return layernorm_ref(x, w, b, eps)
        return layernorm_cuda(x, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw, db = layernorm_bwd_ref(x, w, g, ctx.eps)
        return dx, dw, db.to(ctx.b_dtype), None


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d), w/b: (d,); differentiable in x, w and b."""
    return LayerNorm.apply(x, w, b, eps)
