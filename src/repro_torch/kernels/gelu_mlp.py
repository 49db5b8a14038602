"""Fused GELU-MLP input half, gelu_tanh(x @ w1): the CUDA forward kernel of
``csrc/gelu_mlp.cu`` (ported from ``repro/kernels/gelu_mlp.py:_gelu_mlp_kernel``),
its plain version, and the ``torch.autograd.Function`` that carries the
gradient.

The Function's forward is the kernel for a CUDA tensor (or raises) and the
plain version for a CPU tensor.  It saves only (x, w1); its backward
recomputes the product in fp32 in plain torch
(``kernels/ref.py:gelu_mlp_in_bwd_ref``), as the reference's jnp backward
does, so the pre-activation is never kept.  ``launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.compute import kernel_forward
from repro_torch.kernels import _build
from repro_torch.kernels.ref import gelu_mlp_in_bwd_ref, gelu_mlp_in_ref
from repro_torch.kernels.tiling import gemm_tile

launches = 0

# The bf16 tile widths of csrc/gelu_mlp.cu at N >= 64, the widest first
# (kernels/tiling.py)
WIDTHS = (256, 192, 128)


def gelu_mlp_tile(N: int, F: int, n_sm: int) -> tuple[int, int]:
    """(rows, columns) of the bf16 kernel's tile for an (N, d) x (d, F)
    call on a card with ``n_sm`` SMs (csrc/gelu_mlp.cu: ``gelu_mlp_fwd``)."""
    return gemm_tile(N, F, n_sm, WIDTHS)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gelu_mlp")
    lib.gelu_mlp_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.gelu_mlp_fwd.restype = ctypes.c_int
    lib.gelu_mlp_tile.argtypes = [ctypes.c_int] * 3
    lib.gelu_mlp_tile.restype = ctypes.c_int
    return lib


def gelu_mlp_tile_cuda(N: int, F: int, n_sm: int) -> tuple[int, int]:
    """The tile the C entry chooses, read from the library (to hold
    :func:`gelu_mlp_tile` to it on the card)."""
    code = _lib().gelu_mlp_tile(N, F, n_sm)
    return code >> 16, code & 0xFFFF


def gelu_mlp_cuda(x2d: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """x2d: (N, d), w1: (d, F), both on the card in one dtype -> (N, F)."""
    global launches
    code = _build.dtype_code(x2d)
    N, d = x2d.shape
    F = w1.shape[-1]
    if not x2d.is_cuda or w1.shape != (d, F) or w1.dtype != x2d.dtype or w1.device != x2d.device:
        raise ValueError(f"gelu_mlp: x {x2d.dtype} {tuple(x2d.shape)} on {x2d.device}, "
                         f"w1 {w1.dtype} {tuple(w1.shape)} on {w1.device}")
    if x2d.dtype == torch.bfloat16 and (d % 8 or F % 8):
        raise ValueError(f"gelu_mlp: bf16 needs d and F multiples of 8, got {d}, {F}")
    x2d, w1 = _build.aligned(x2d), _build.aligned(w1)
    out = torch.empty((N, F), dtype=x2d.dtype, device=x2d.device)
    lib = _lib()
    err = lib.gelu_mlp_fwd(x2d.data_ptr(), w1.data_ptr(), out.data_ptr(), N, d, F, code,
                           _build.stream_of(x2d))
    _build.check(lib, err, "gelu_mlp_fwd")
    launches += 1
    return out


class GeluMLP(torch.autograd.Function):
    @staticmethod
    @kernel_forward
    def forward(ctx, x2d, w1):
        ctx.save_for_backward(x2d, w1)
        if x2d.device.type == "cpu":
            return gelu_mlp_in_ref(x2d, w1)
        return gelu_mlp_cuda(x2d, w1)

    @staticmethod
    def backward(ctx, g):
        return gelu_mlp_in_bwd_ref(*ctx.saved_tensors, g)


def gelu_mlp_in(x2d: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """x2d: (N, d), w1: (d, F) -> gelu_tanh(x2d @ w1) (N, F); differentiable
    in both."""
    return GeluMLP.apply(x2d, w1)
