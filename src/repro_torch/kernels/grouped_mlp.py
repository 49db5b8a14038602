"""Grouped expert MLP, per expert e: mask_e * (act(mask_e * x_e) @ w2_e) with
act the SwiGLU gate or the tanh GELU: the CUDA forward kernels of
``csrc/grouped_mlp.cu`` (ported from both bodies of
``repro/kernels/grouped_mlp.py``, ``_swiglu_kernel`` and ``_gelu_kernel``),
its plain version, and the ``torch.autograd.Function`` that carries the
gradient.

The Function's forward is the kernel for a CUDA tensor (or raises) and the
plain version for a CPU tensor: the moe family's serving and, through
``models/moe.py``, its train step (under remat full its forward runs again
in the backward's recompute).  It saves only (x, weights, mask); its
backward recomputes h in fp32 in plain torch
(``kernels/ref.py:grouped_mlp_bwd_ref``), as the reference's jnp backward
(``repro/kernels/grouped_mlp.py:_grouped_bwd``, not a Pallas kernel) does;
a backward kernel is ROADMAP.md's Queue 2.  ``launches`` counts the kernel's launches (one per call: the live
row-tile list, the gate and the down kernel of one entry).

``grouped_items_cuda`` returns the bf16 kernels' work order as the C entry
computes it on the card, for ``chip_smoke.py`` to hold against its mirror
``kernels/tiling.py:grouped_order``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.compute import kernel_forward
from repro_torch.kernels import _build
from repro_torch.kernels.ref import grouped_mlp_bwd_ref, grouped_mlp_ref
from repro_torch.kernels.tiling import GROUPED_COLS, GROUPED_ROWS, cdiv

ACTS = {"swiglu": 0, "gelu": 1}   # the act codes of csrc/grouped_mlp.cu
launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("grouped_mlp")
    lib.grouped_mlp_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.grouped_mlp_fwd.restype = ctypes.c_int
    lib.grouped_mlp_items.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.grouped_mlp_items.restype = ctypes.c_int
    return lib


def scratch_floats(E: int, N: int, F: int) -> int:
    """The C entry's scratch: h (E, N, F) in fp32 (bf16: its hi and lo
    planes in the same bytes), then the count and list of the live row
    tiles."""
    return E * N * F + E * cdiv(N, GROUPED_ROWS) + 1


def grouped_mlp_cuda(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor | None,
                     w2: torch.Tensor, mask: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    """x: (E, N, d), w1/w3: (E, d, F), w2: (E, F, d), all on the card in one
    dtype (w3 None for ``act="gelu"``); mask: (E, N) of 0/1 in any float
    dtype -> (E, N, d) in x's dtype."""
    global launches
    code = _build.dtype_code(x)
    E, N, d = x.shape
    F = w1.shape[-1]
    w3 = w3 if act == "swiglu" else None   # the C entry refuses swiglu without it
    weights = [(w, s) for w, s in ((w1, (E, d, F)), (w2, (E, F, d)), (w3, (E, d, F)))
               if w is not None]
    if (not x.is_cuda
            or any(w.shape != shape or w.dtype != x.dtype or w.device != x.device
                   for w, shape in weights)
            or mask.shape != (E, N) or not mask.is_floating_point()
            or mask.device != x.device):
        raise ValueError(
            f"grouped_mlp ({act}): x {x.dtype} {tuple(x.shape)} on {x.device}, "
            + ", ".join(f"w {w.dtype} {tuple(w.shape)} on {w.device}" for w, _ in weights)
            + f", mask {mask.dtype} {tuple(mask.shape)}")
    if x.dtype == torch.bfloat16 and (d % 8 or F % 8):
        raise ValueError(f"grouped_mlp: bf16 needs d and F multiples of 8, got {d}, {F}")
    x, w1, w2 = (_build.aligned(t) for t in (x, w1, w2))
    w3 = None if w3 is None else _build.aligned(w3)
    mask = mask.to(torch.float32).contiguous()
    h = torch.empty(scratch_floats(E, N, F), dtype=torch.float32, device=x.device)
    out = torch.empty((E, N, d), dtype=x.dtype, device=x.device)
    lib = _lib()
    err = lib.grouped_mlp_fwd(x.data_ptr(), w1.data_ptr(), None if w3 is None else w3.data_ptr(),
                              w2.data_ptr(), mask.data_ptr(), h.data_ptr(), out.data_ptr(),
                              E, N, d, F, ACTS.get(act, -1), code,
                              _build.stream_of(x))
    _build.check(lib, err, "grouped_mlp_fwd")
    launches += 1
    return out


def grouped_items_cuda(mask: torch.Tensor, cols: int) -> list[tuple[int, int, int]]:
    """(expert, row tile, column tile) of each work item of the bf16 gate
    (cols = F) or down product (cols = d), in the order the persistent grid
    takes them, as the C entry lists them from the (E, N) mask on the card."""
    if not mask.is_cuda or mask.dim() != 2:
        raise ValueError(f"grouped_items_cuda: an (E, N) mask on the card, got "
                         f"{tuple(mask.shape)} on {mask.device}")
    E, N = mask.shape
    row_tiles, col_tiles = E * cdiv(N, GROUPED_ROWS), cdiv(cols, GROUPED_COLS)
    mask = mask.to(torch.float32).contiguous()
    live = torch.empty(row_tiles + 1, dtype=torch.int32, device=mask.device)
    items = torch.empty((row_tiles * col_tiles, 3), dtype=torch.int32, device=mask.device)
    lib = _lib()
    err = lib.grouped_mlp_items(mask.data_ptr(), live.data_ptr(), items.data_ptr(), E, N,
                                cols, _build.stream_of(mask))
    _build.check(lib, err, "grouped_mlp_items")
    return [tuple(t) for t in items[:int(live[0]) * col_tiles].tolist()]


class GroupedMLP(torch.autograd.Function):
    @staticmethod
    @kernel_forward
    def forward(ctx, x, w1, w3, w2, mask, act):
        ctx.act = act
        ctx.save_for_backward(x, w1, w3, w2, mask)
        if x.device.type == "cpu":
            return grouped_mlp_ref(x, w1, w3, w2, mask, act)
        return grouped_mlp_cuda(x, w1, w3, w2, mask, act)

    @staticmethod
    def backward(ctx, g):
        return (*grouped_mlp_bwd_ref(*ctx.saved_tensors, g, act=ctx.act), None)


def grouped_mlp(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor | None,
                w2: torch.Tensor, mask: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    """x: (E, N, d) -> (E, N, d); differentiable in x and the weights, the
    mask gets a zero gradient."""
    return GroupedMLP.apply(x, w1, w3, w2, mask, act)
