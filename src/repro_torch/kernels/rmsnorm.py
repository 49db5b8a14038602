"""Fused RMSNorm: the CUDA forward kernel of ``csrc/rmsnorm.cu`` (ported
from ``repro/kernels/rmsnorm.py:_rmsnorm_kernel``), its plain version, and
the ``torch.autograd.Function`` that carries the gradient.

The Function's forward is the kernel for a CUDA tensor (or raises) and the
plain version for a CPU tensor; its backward is the reference's fp32
formula in plain torch (``kernels/ref.py:rmsnorm_bwd_ref``) on both, as the
reference's backward is jnp.  ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.compute import kernel_forward
from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_bwd_ref, rmsnorm_ref

launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    lib.rmsnorm_fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                ctypes.c_int, ctypes.c_void_p]
    lib.rmsnorm_fwd.restype = ctypes.c_int
    return lib


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x: (..., d) on the card, w: (d,) of x's dtype -> x's shape and dtype."""
    global launches
    code = _build.dtype_code(x)
    d = x.shape[-1]
    if not x.is_cuda or w.device != x.device or w.dtype != x.dtype or w.shape != (d,):
        raise ValueError(f"rmsnorm: x {x.dtype} {tuple(x.shape)} on {x.device}, "
                         f"w {w.dtype} {tuple(w.shape)} on {w.device}")
    if (d * x.element_size()) % 16:
        raise ValueError(f"rmsnorm: d={d} is not a whole number of 16-byte vectors")
    x2 = _build.aligned(x.reshape(-1, d))
    w = _build.aligned(w)
    y = torch.empty_like(x2)
    lib = _lib()
    err = lib.rmsnorm_fwd(x2.data_ptr(), w.data_ptr(), y.data_ptr(), x2.shape[0],
                          d, eps, code, _build.stream_of(x))
    _build.check(lib, err, "rmsnorm_fwd")
    launches += 1
    return y.reshape(x.shape)


class RMSNorm(torch.autograd.Function):
    @staticmethod
    @kernel_forward
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        if x.device.type == "cpu":
            return rmsnorm_ref(x, w, eps)
        return rmsnorm_cuda(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd_ref(x, w, g, ctx.eps)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d), w: (d,); differentiable in x and w."""
    return RMSNorm.apply(x, w, eps)
