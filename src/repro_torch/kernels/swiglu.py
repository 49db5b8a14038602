"""Fused SwiGLU gate, silu(x @ w1) * (x @ w3): the CUDA forward kernel of
``csrc/swiglu.cu`` (ported from ``repro/kernels/swiglu.py:_swiglu_kernel``),
its plain version, and the ``torch.autograd.Function`` that carries the
gradient.

The Function's forward is the kernel for a CUDA tensor (or raises) and the
plain version for a CPU tensor.  It saves only (x, w1, w3); its backward
recomputes both products in fp32 in plain torch
(``kernels/ref.py:swiglu_bwd_ref``), as the reference's jnp backward does.
``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.compute import kernel_forward
from repro_torch.kernels import _build
from repro_torch.kernels.ref import swiglu_bwd_ref, swiglu_ref
from repro_torch.kernels.tiling import gemm_tile

launches = 0

# The bf16 tile widths of csrc/swiglu.cu at N >= 64, 128 first (kernels/tiling.py)
WIDTHS = (128, 192)


def swiglu_tile(N: int, F: int, n_sm: int) -> tuple[int, int]:
    """(rows, columns) of the bf16 kernel's tile for an (N, d) x (d, F)
    call on a card with ``n_sm`` SMs (csrc/swiglu.cu: ``swiglu_fwd``)."""
    return gemm_tile(N, F, n_sm, WIDTHS)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("swiglu")
    lib.swiglu_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.swiglu_fwd.restype = ctypes.c_int
    lib.swiglu_tile.argtypes = [ctypes.c_int] * 3
    lib.swiglu_tile.restype = ctypes.c_int
    return lib


def swiglu_tile_cuda(N: int, F: int, n_sm: int) -> tuple[int, int]:
    """The tile the C entry chooses, read from the library (to hold
    :func:`swiglu_tile` to it on the card)."""
    code = _lib().swiglu_tile(N, F, n_sm)
    return code >> 16, code & 0xFFFF


def swiglu_cuda(x2d: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """x2d: (N, d), w1/w3: (d, F), all on the card in one dtype -> (N, F)."""
    global launches
    code = _build.dtype_code(x2d)
    N, d = x2d.shape
    F = w1.shape[1]
    if (not x2d.is_cuda or w1.shape != (d, F) or w3.shape != (d, F)
            or {w1.dtype, w3.dtype} != {x2d.dtype}
            or w1.device != x2d.device or w3.device != x2d.device):
        raise ValueError(f"swiglu: x {x2d.dtype} {tuple(x2d.shape)}, w1 {w1.dtype} "
                         f"{tuple(w1.shape)}, w3 {w3.dtype} {tuple(w3.shape)}")
    if x2d.dtype == torch.bfloat16 and (d % 8 or F % 8):
        raise ValueError(f"swiglu: bf16 needs d and F multiples of 8, got {d}, {F}")
    x2d, w1, w3 = (_build.aligned(t) for t in (x2d, w1, w3))
    out = torch.empty((N, F), dtype=x2d.dtype, device=x2d.device)
    lib = _lib()
    err = lib.swiglu_fwd(x2d.data_ptr(), w1.data_ptr(), w3.data_ptr(), out.data_ptr(),
                         N, d, F, code, _build.stream_of(x2d))
    _build.check(lib, err, "swiglu_fwd")
    launches += 1
    return out


class SwiGLU(torch.autograd.Function):
    @staticmethod
    @kernel_forward
    def forward(ctx, x2d, w1, w3):
        ctx.save_for_backward(x2d, w1, w3)
        if x2d.device.type == "cpu":
            return swiglu_ref(x2d, w1, w3)
        return swiglu_cuda(x2d, w1, w3)

    @staticmethod
    def backward(ctx, g):
        return swiglu_bwd_ref(*ctx.saved_tensors, g)


def swiglu(x2d: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """x2d: (N, d), w1/w3: (d, F) -> (N, F); differentiable in all three."""
    return SwiGLU.apply(x2d, w1, w3)
