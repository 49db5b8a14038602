"""Mamba-2 chunked SSD scan and the fused single-token mamba decode step: the
CUDA kernels of ``csrc/ssd_scan.cu`` (ported from
``repro/kernels/ssd_scan.py:_scan_kernel`` and ``_decode_kernel``), their
plain versions, and the ``torch.autograd.Function`` of the scan.

The scan's kernel is chunk-parallel (the design is in the source's note):
a chunk-local pass, the carry in chunk order into a scratch of chunk states,
and the read-out; chunks of 8 or fewer take a token walk.
``ssd_scan_staged`` is the same three passes in plain torch, which the CPU
tests hold against the reference; ``kernels/tiling.py`` mirrors the work
division, which ``chip_smoke.py`` holds to the C entries (``scan_items_cuda``,
``tri_tiles_cuda``); the wrapper sizes the scratch with the C entry
``ssd_scan_scratch``.

The scan's Function saves only its inputs.  Its forward is the kernel for a
CUDA tensor (or raises) and the plain version for a CPU tensor; its backward
recomputes the plain chunk loop (``kernels/ref.py:ssd_scan_ref``) under
autograd from the saved inputs on both, as the reference's ``custom_vjp``
runs ``jax.vjp`` over its jnp oracle.  The decode step serves only and has
no backward.  It has a pure entry (``mamba_decode_step``: a fresh state)
and an in-place one (``mamba_decode_step_``: the new state written over the
cache's, in the rows of the active slots only), on the card one kernel
launch either way; the in-place wrapper raises on a state it cannot update
where it lies (not contiguous, not 16-byte aligned, not fp32) rather than
update a copy.  ``launches`` and ``launches_decode`` count the two
kernels' launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.compute import kernel_forward
from repro_torch.kernels import _build
from repro_torch.kernels.ref import mamba_decode_ref, mamba_decode_ref_, ssd_scan_ref

HEAD_DIM, STATE = 64, 64    # the (P, N) that csrc/ssd_scan.cu is built for
CONV_K = 4                  # the decode step's conv taps it is built for
MAX_CHUNK = 128
launches = 0
launches_decode = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                                 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                                    ctypes.c_void_p])
    lib.ssd_scan_fwd.restype = ctypes.c_int
    out = ctypes.POINTER(ctypes.c_int)
    lib.ssd_scan_items.argtypes = [ctypes.c_int] * 4 + [out, ctypes.c_int]
    lib.ssd_scan_tiles.argtypes = [ctypes.c_int, ctypes.c_int, out, ctypes.c_int]
    lib.ssd_scan_scratch.argtypes = [ctypes.c_int] * 4
    lib.ssd_scan_scratch.restype = ctypes.c_longlong
    lib.mamba_decode_fwd.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p])
    lib.mamba_decode_fwd.restype = ctypes.c_int
    return lib


def check_chunk(T: int, chunk: int) -> None:
    if chunk < 1 or chunk > MAX_CHUNK or chunk & (chunk - 1) or T < 1 or T % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} must be a power of two <= "
                         f"{MAX_CHUNK} that divides T={T}")


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                  A_log: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, H, P) bf16 or fp32 on the card (any strides with unit stride
    on P), dt: (B, T, H), Bm/Cm: (B, T, N) in x's dtype (unit stride on N),
    A_log: (H,) -> (y (B, T, H, P) in x's dtype, state (B, H, P, N) fp32)."""
    global launches
    code = _build.dtype_code(x)
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if (not x.is_cuda or any(t.device != x.device for t in (dt, Bm, Cm, A_log))
            or dt.shape != (B, T, H) or Bm.shape != (B, T, N) or Cm.shape != (B, T, N)
            or {Bm.dtype, Cm.dtype} != {x.dtype} or A_log.shape != (H,)):
        raise ValueError(f"ssd_scan: x {x.dtype} {tuple(x.shape)} on {x.device}, dt "
                         f"{tuple(dt.shape)}, B {Bm.dtype} {tuple(Bm.shape)}, C "
                         f"{Cm.dtype} {tuple(Cm.shape)}, A_log {tuple(A_log.shape)}")
    if (P, N) != (HEAD_DIM, STATE):
        raise ValueError(f"ssd_scan: built for (P, N) = {(HEAD_DIM, STATE)}, got {(P, N)}")
    check_chunk(T, chunk)
    # four elements a vector load: unit stride on the last dim, the others
    # multiples of 4, 16-byte aligned data (the model's slices of its conv
    # output are; anything else is copied)
    x, Bm, Cm = (t if t.stride(-1) == 1 and all(s % 4 == 0 for s in t.stride()[:-1])
                 and t.data_ptr() % 16 == 0 else _build.aligned(t) for t in (x, Bm, Cm))
    dt, A_log = dt.float(), A_log.float().contiguous()   # no-ops for the model's fp32 dt
    y = torch.empty((B, T, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 10)(*x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                                       *Cm.stride()[:2])
    lib = _lib()
    n_scratch = lib.ssd_scan_scratch(B, T, H, chunk)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device) if n_scratch else None
    err = lib.ssd_scan_fwd(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                           A_log.data_ptr(), y.data_ptr(), state.data_ptr(),
                           None if scratch is None else scratch.data_ptr(), B, T, H, P, N,
                           chunk, strides, code, _build.stream_of(x))
    _build.check(lib, err, "ssd_scan_fwd")
    launches += 1
    return y, state


def scan_items_cuda(B: int, T: int, H: int, chunk: int) -> list[tuple[int, ...]]:
    """The blocks the C entry launches for (B, T, H) at ``chunk`` (as
    ``tiling.scan_items``)."""
    return _build.int_triples(_lib().ssd_scan_items, B, T, H, chunk)


def tri_tiles_cuda(chunk: int, dtype: torch.dtype = torch.float32) -> list[tuple[int, ...]]:
    """The read-out kernel's C B^T tiles in the order it takes them: in fp32
    (thread, ti, tj) of its 4 x 4 tiles (as ``tiling.ssd_tri_tiles``), in
    bf16 (warp, strip, jt) of its 16 x 8 mma tiles (``tiling.ssd_mma_tiles``)."""
    code = _build.dtype_code(torch.empty(0, dtype=dtype))
    return _build.int_triples(_lib().ssd_scan_tiles, chunk, code)


def ssd_scan_staged(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                    A_log: torch.Tensor, *, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's three passes in plain torch, fp32, for the CPU tests
    (nothing on the main path calls it): (1) per chunk c, D_c = sum_j x_j
    dt_j e^{total - cum_j} B_j^T and e^{total_c}; (2) the carry S_c =
    e^{total_c} S_{c-1} + D_c in chunk order, keeping each S_{c-1}; (3) y =
    e^{cum} (C S_{c-1}) + W x.  Returns what ``ssd_scan_ref`` returns."""
    Bsz, T, H, P = x.shape
    N, Q = Bm.shape[-1], chunk
    check_chunk(T, Q)
    nc = T // Q
    xs = x.float().reshape(Bsz, nc, Q, H, P)
    dts = dt.float().reshape(Bsz, nc, Q, H)
    Bs, Cs = (t.float().reshape(Bsz, nc, Q, N) for t in (Bm, Cm))
    cum = torch.cumsum(dts * -torch.exp(A_log.float()), dim=2)      # (B, nc, Q, H)
    total = cum[:, :, -1]
    wdec = dts * torch.exp(total[:, :, None] - cum)
    D = torch.einsum("bcjn,bcjhp->bchnp", Bs, xs * wdec[..., None])  # (B, nc, H, N, P)
    et = torch.exp(total)
    S = torch.zeros(Bsz, H, N, P, dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(S)
        S = et[:, c, :, None, None] * S + D[:, c]
    S_prev = torch.stack(prev, 1)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))[..., None]
    gap = cum[:, :, :, None] - cum[:, :, None]                       # (B, nc, i, j, H)
    W = (torch.einsum("bcin,bcjn->bcij", Cs, Bs)[..., None]
         * torch.exp(torch.where(tri, gap, -torch.inf)) * dts[:, :, None])
    y = (torch.exp(cum)[..., None] * torch.einsum("bcin,bchnp->bcihp", Cs, S_prev)
         + torch.einsum("bcijh,bcjhp->bcihp", W, xs))
    return y.reshape(Bsz, T, H, P).to(x.dtype), S.transpose(-1, -2)


class SSDScan(torch.autograd.Function):
    @staticmethod
    @kernel_forward
    def forward(ctx, x, dt, Bm, Cm, A_log, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, Bm, Cm, A_log)
        if x.device.type == "cpu":
            return ssd_scan_ref(x, dt, Bm, Cm, A_log, chunk=chunk)
        return ssd_scan_cuda(x, dt, Bm, Cm, A_log, chunk)

    @staticmethod
    def backward(ctx, gy, gs):
        inputs = [t.detach().requires_grad_(t.is_floating_point())
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, state = ssd_scan_ref(*inputs, chunk=ctx.chunk)
            grads = torch.autograd.grad((y, state), inputs, (gy, gs), allow_unused=True)
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             A_log: torch.Tensor, *, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, H, P) in x's dtype, final state (B, H, P, N) fp32) of the
    chunked scan; differentiable in every input."""
    check_chunk(x.shape[1], chunk)
    return SSDScan.apply(x, dt, Bm, Cm, A_log, chunk)


def _decode(window, conv_w, conv_b, dt_raw, dt_bias, A_log, D, state, out, active,
            H: int, P: int) -> torch.Tensor:
    """One launch of the decode kernel after the wrapper's checks: y (B, H, P)
    fp32 for every slot; the new state into ``out``'s rows of the active
    slots (``out`` is ``state`` itself in place, else a buffer apart)."""
    global launches_decode
    B, K, ch = window.shape
    N = state.shape[-1] if state.ndim == 4 else -1
    dev = window.get_device()
    if (not window.is_cuda
            or any(t.get_device() != dev
                   for t in (conv_w, conv_b, dt_raw, dt_bias, A_log, D, state))
            or conv_w.dtype != window.dtype or conv_b.dtype != window.dtype
            or (conv_w.shape, conv_b.shape, dt_raw.shape, dt_bias.shape, A_log.shape,
                D.shape, state.shape) != ((K, ch), (ch,), (B, H), (H,), (H,), (H,),
                                          (B, H, P, N))
            or state.dtype != torch.float32 or ch != H * P + 2 * N
            or active is not None and (active.dtype != torch.bool or active.shape != (B,)
                                       or active.get_device() != dev)):
        raise ValueError(
            f"mamba_decode_step: window {window.dtype} {tuple(window.shape)} on "
            f"{window.device}, conv_w {tuple(conv_w.shape)}, conv_b {tuple(conv_b.shape)}, "
            f"dt_raw {tuple(dt_raw.shape)}, state {state.dtype} {tuple(state.shape)}, "
            f"active {None if active is None else (active.dtype, tuple(active.shape))}, "
            f"H {H}, P {P}")
    if (P, N, K) != (HEAD_DIM, STATE, CONV_K):
        raise ValueError(f"mamba_decode_step: built for (P, N, K) = "
                         f"{(HEAD_DIM, STATE, CONV_K)}, got {(P, N, K)}")
    code = _build.dtype_code(window)
    if not (dt_raw.dtype == dt_bias.dtype == A_log.dtype == D.dtype):
        dt_raw, dt_bias, A_log, D = (t.float() for t in (dt_raw, dt_bias, A_log, D))
    if dt_raw.stride(-1) != 1:
        dt_raw = dt_raw.contiguous()
    # named, so that a copy lives until the kernel is enqueued
    window, conv_w, conv_b, dt_bias, A_log, D = (
        t.contiguous() for t in (window, conv_w, conv_b, dt_bias, A_log, D))
    y = torch.empty((B, H, P), dtype=torch.float32, device=window.device)
    lib = _lib()
    err = lib.mamba_decode_fwd(window.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
                               dt_raw.data_ptr(), dt_bias.data_ptr(), A_log.data_ptr(),
                               D.data_ptr(), state.data_ptr(), y.data_ptr(), out.data_ptr(),
                               None if active is None else active.data_ptr(),
                               B, K, ch, H, P, N, dt_raw.stride(0), code,
                               _build.dtype_code(dt_raw), _build.stream_of(window))
    _build.check(lib, err, "mamba_decode_fwd")
    launches_decode += 1
    return y


def mamba_decode_cuda(window, conv_w, conv_b, dt_raw, dt_bias, A_log, D, state, *,
                      n_heads: int, head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """window: (B, K, ch) bf16 or fp32 on the card, conv_w (K, ch) and conv_b
    (ch,) in its dtype; dt_raw (B, H) (unit stride on H, any row stride),
    dt_bias/A_log/D (H,) bf16 or fp32 (read in fp32 in the kernel, as the
    reference casts them); state (B, H, P, N) fp32 -> (y (B, H, P) fp32, new
    state in a fresh (B, H, P, N) fp32)."""
    state = _build.aligned(state) if state.dtype == torch.float32 else state
    new_state = torch.empty_like(state)
    y = _decode(window, conv_w, conv_b, dt_raw, dt_bias, A_log, D, state, new_state, None,
                n_heads, head_dim)
    return y, new_state


def mamba_decode_cuda_(window, conv_w, conv_b, dt_raw, dt_bias, A_log, D, state,
                       active=None, *, n_heads: int, head_dim: int) -> torch.Tensor:
    """The in-place step on the card: the inputs of :func:`mamba_decode_cuda`
    and ``active`` ((B,) bool, or None: every slot) -> y (B, H, P) fp32; the
    new state is written over ``state`` in the active slots' rows, and an
    inactive slot's rows are not written.  ``state`` must be the tensor to
    update: contiguous, 16-byte aligned fp32, or this raises (a copy would
    take the update and leave ``state`` as it was)."""
    if (state.dtype != torch.float32 or not state.is_contiguous()
            or state.data_ptr() % 16):
        raise ValueError(f"mamba_decode_step_: the state must be contiguous, 16-byte "
                         f"aligned fp32 to be updated in place, got {state.dtype} strides "
                         f"{state.stride()} at {state.data_ptr() % 16} bytes past 16")
    return _decode(window, conv_w, conv_b, dt_raw, dt_bias, A_log, D, state, state, active,
                   n_heads, head_dim)


def mamba_decode_step(window, conv_w, conv_b, dt_raw, dt_bias, A_log, D, state, *,
                      n_heads: int, head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused decode step: (y (B, H, P) fp32, new state (B, H, P, N) fp32,
    a fresh tensor: ``state`` is left as it was).  Serving only: no
    gradient."""
    if window.device.type == "cpu":
        return mamba_decode_ref(window, conv_w, conv_b, dt_raw, dt_bias, A_log, D, state,
                                n_heads=n_heads, head_dim=head_dim)
    return mamba_decode_cuda(window, conv_w, conv_b, dt_raw, dt_bias, A_log, D, state,
                             n_heads=n_heads, head_dim=head_dim)


def mamba_decode_step_(window, conv_w, conv_b, dt_raw, dt_bias, A_log, D, state,
                       active=None, *, n_heads: int, head_dim: int) -> torch.Tensor:
    """One fused decode step in place: y (B, H, P) fp32; the new state is
    written over ``state`` in the rows of the active slots (every slot when
    ``active`` is None) and an inactive slot's rows stay bit for bit.
    Serving only: no gradient."""
    if window.device.type == "cpu":
        return mamba_decode_ref_(window, conv_w, conv_b, dt_raw, dt_bias, A_log, D, state,
                                 active, n_heads=n_heads, head_dim=head_dim)
    return mamba_decode_cuda_(window, conv_w, conv_b, dt_raw, dt_bias, A_log, D, state,
                              active, n_heads=n_heads, head_dim=head_dim)
