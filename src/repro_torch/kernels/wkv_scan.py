"""RWKV-6 chunked wkv scan and the fused single-token wkv decode step: the CUDA
kernels of ``csrc/wkv_scan.cu`` (ported from
``repro/kernels/wkv_scan.py:_scan_kernel`` and ``_decode_kernel``), their
plain versions, and the ``torch.autograd.Function`` of the scan.

The scan's kernel is chunk-parallel (the design is in the source's note):
a chunk-local pass, the carry in chunk order into a scratch of chunk states,
and the read-out; chunks of 8 or fewer take a token walk.
``wkv_scan_staged`` is the same three passes in plain torch, which the CPU
tests hold against the reference; ``kernels/tiling.py`` mirrors the work
division, which ``chip_smoke.py`` holds to the C entries (``scan_items_cuda``,
``score_pairs_cuda``); the wrapper sizes the scratch with the C entry
``wkv_scan_scratch``.

The scan's Function saves only its inputs.  Its forward is the kernel for a
CUDA tensor (or raises) and the plain version for a CPU tensor; its backward
recomputes the plain chunk loop (``kernels/ref.py:wkv_scan_ref``) under
autograd from the saved inputs on both, as the reference's ``custom_vjp``
runs ``jax.vjp`` over its jnp oracle.  The decode step serves only and has
no backward.  It has a pure entry (``wkv_decode_step``: a fresh state)
and an in-place one (``wkv_decode_step_``: the new state written over the
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
from repro_torch.kernels.ref import wkv_decode_ref, wkv_decode_ref_, wkv_scan_ref

HEAD_DIM = 64               # the K = V that csrc/wkv_scan.cu is built for
MAX_CHUNK = 32
launches = 0
launches_decode = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv_scan")
    lib.wkv_scan_fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.wkv_scan_fwd.restype = ctypes.c_int
    out = ctypes.POINTER(ctypes.c_int)
    lib.wkv_scan_items.argtypes = [ctypes.c_int] * 4 + [out, ctypes.c_int]
    lib.wkv_scan_pairs.argtypes = [ctypes.c_int, out, ctypes.c_int]
    lib.wkv_scan_scratch.argtypes = [ctypes.c_int] * 4
    lib.wkv_scan_scratch.restype = ctypes.c_longlong
    lib.wkv_decode_fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.wkv_decode_fwd.restype = ctypes.c_int
    return lib


def check_chunk(T: int, chunk: int) -> None:
    if chunk < 1 or chunk > MAX_CHUNK or chunk & (chunk - 1) or T < 1 or T % chunk:
        raise ValueError(f"wkv_scan: chunk {chunk} must be a power of two <= "
                         f"{MAX_CHUNK} that divides T={T}")


def _fp32(*ts: torch.Tensor) -> list[torch.Tensor]:
    """Contiguous, 16-byte aligned fp32 (no copy for the model's fp32
    contiguous operands)."""
    return [t if t.dtype == torch.float32 and t.is_contiguous() and not t.data_ptr() % 16
            else _build.aligned(t.float()) for t in ts]


def wkv_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                  u: torch.Tensor, state: torch.Tensor,
                  chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/w: (B, T, H, K), v: (B, T, H, V), u: (H, K), state: (B, H, K, V)
    on the card, read in fp32 -> (y (B, T, H, V) fp32, final state
    (B, H, K, V) fp32)."""
    global launches
    B, T, H, K = r.shape
    V = v.shape[-1]
    if (not r.is_cuda or any(t.device != r.device for t in (k, v, w, u, state))
            or k.shape != r.shape or w.shape != r.shape or v.shape != (B, T, H, V)
            or u.shape != (H, K) or state.shape != (B, H, K, V)):
        raise ValueError(f"wkv_scan: r {tuple(r.shape)} on {r.device}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)}, "
                         f"state {tuple(state.shape)}")
    if (K, V) != (HEAD_DIM, HEAD_DIM):
        raise ValueError(f"wkv_scan: built for K = V = {HEAD_DIM}, got {(K, V)}")
    check_chunk(T, chunk)
    r, k, v, w, u, state = _fp32(r, k, v, w, u, state)
    y = torch.empty((B, T, H, V), dtype=torch.float32, device=r.device)
    out = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    lib = _lib()
    n_scratch = lib.wkv_scan_scratch(B, T, H, chunk)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=r.device) if n_scratch else None
    err = lib.wkv_scan_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                           u.data_ptr(), state.data_ptr(), y.data_ptr(), out.data_ptr(),
                           None if scratch is None else scratch.data_ptr(),
                           B, T, H, K, V, chunk, _build.stream_of(r))
    _build.check(lib, err, "wkv_scan_fwd")
    launches += 1
    return y, out


def scan_items_cuda(B: int, T: int, H: int, chunk: int) -> list[tuple[int, ...]]:
    """The blocks the C entry launches for (B, T, H) at ``chunk`` (as
    ``tiling.scan_items``)."""
    return _build.int_triples(_lib().wkv_scan_items, B, T, H, chunk)


def score_pairs_cuda(chunk: int) -> list[tuple[int, ...]]:
    """(thread, t, i) of the read-out kernel's scores (as
    ``tiling.wkv_score_pairs``)."""
    return _build.int_triples(_lib().wkv_scan_pairs, chunk)


def wkv_scan_staged(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                    u: torch.Tensor, state: torch.Tensor, *,
                    chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's three passes in plain torch, fp32, for the CPU tests
    (nothing on the main path calls it): (1) per chunk c, D_c = sum_i (k_i
    e^{total - cum_i})^T v_i and e^{total_c}; (2) the carry S_c =
    e^{total_c} S_{c-1} + D_c in chunk order from ``state``, keeping each
    S_{c-1}; (3) y = (r e^{cum_{t-1}}) S_{c-1} + the scores' and the bonus'
    terms.  Returns what ``wkv_scan_ref`` returns."""
    B, T, H, K = r.shape
    V, Q = v.shape[-1], chunk
    check_chunk(T, Q)
    nc = T // Q
    rs, ks, lw = (t.float().reshape(B, nc, Q, H, K) for t in (r, k, torch.log(w.float())))
    vs = v.float().reshape(B, nc, Q, H, V)
    cum = torch.cumsum(lw, dim=2)                                    # (B, nc, Q, H, K)
    cum_prev = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], 2)
    total = cum[:, :, -1]
    D = torch.einsum("bcihk,bcihv->bchkv", ks * torch.exp(total[:, :, None] - cum), vs)
    et = torch.exp(total)
    S = state.float()
    prev = []
    for c in range(nc):
        prev.append(S)
        S = et[:, c, ..., None] * S + D[:, c]
    S_prev = torch.stack(prev, 1)                                    # (B, nc, H, K, V)
    y = torch.einsum("bcthk,bchkv->bcthv", rs * torch.exp(cum_prev), S_prev)
    lt = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=r.device), -1)[..., None, None]
    gap = torch.where(lt, cum_prev[:, :, :, None] - cum[:, :, None], -torch.inf)
    score = torch.einsum("bcthk,bcihk,bctihk->bctih", rs, ks, torch.exp(gap))
    y = (y + torch.einsum("bctih,bcihv->bcthv", score, vs)
         + torch.einsum("bcthk,bcthv->bcthv", rs * (u.float() * ks), vs))
    return y.reshape(B, T, H, V), S


class WKVScan(torch.autograd.Function):
    @staticmethod
    @kernel_forward
    def forward(ctx, r, k, v, w, u, state, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(r, k, v, w, u, state)
        if r.device.type == "cpu":
            return wkv_scan_ref(r, k, v, w, u, state, chunk=chunk)
        return wkv_scan_cuda(r, k, v, w, u, state, chunk)

    @staticmethod
    def backward(ctx, gy, gs):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, state = wkv_scan_ref(*inputs, chunk=ctx.chunk)
            grads = torch.autograd.grad((y, state), inputs, (gy, gs), allow_unused=True)
        return (*grads, None)


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state: torch.Tensor, *,
             chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, H, V) fp32, final state (B, H, K, V) fp32) of the chunked
    scan; differentiable in every input."""
    check_chunk(r.shape[1], chunk)
    return WKVScan.apply(r, k, v, w, u, state, chunk)


def _decode(r, k, v, w, u, state, out, active) -> torch.Tensor:
    """One launch of the decode kernel after the wrapper's checks: out
    (B, H, V) fp32 for every slot; the new state into ``out``'s rows of the
    active slots (``out`` is ``state`` itself in place, else a buffer
    apart)."""
    global launches_decode
    B, H, K = r.shape
    V = v.shape[-1]
    dev = r.get_device()
    if (not r.is_cuda or any(t.get_device() != dev for t in (k, v, w, u, state))
            or (k.shape, w.shape, v.shape, u.shape, state.shape)
            != (r.shape, r.shape, (B, H, V), (H, K), (B, H, K, V))
            or active is not None and (active.dtype != torch.bool or active.shape != (B,)
                                       or active.get_device() != dev)):
        raise ValueError(f"wkv_decode_step: r {tuple(r.shape)} on {r.device}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}, state {tuple(state.shape)}, active "
                         f"{None if active is None else (active.dtype, tuple(active.shape))}")
    if (K, V) != (HEAD_DIM, HEAD_DIM):
        raise ValueError(f"wkv_decode_step: built for K = V = {HEAD_DIM}, got {(K, V)}")
    r, k, v, w, u = _fp32(r, k, v, w, u)
    y = torch.empty((B, H, V), dtype=torch.float32, device=r.device)
    lib = _lib()
    err = lib.wkv_decode_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                             u.data_ptr(), state.data_ptr(), y.data_ptr(), out.data_ptr(),
                             None if active is None else active.data_ptr(), B, H, K, V,
                             _build.stream_of(r))
    _build.check(lib, err, "wkv_decode_fwd")
    launches_decode += 1
    return y


def wkv_decode_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                    u: torch.Tensor, state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/w: (B, H, K), v: (B, H, V), u: (H, K), state (B, H, K, V) on the
    card, read in fp32 -> (out (B, H, V) fp32, new state in a fresh
    (B, H, K, V) fp32)."""
    state = _fp32(state)[0]
    new_state = torch.empty_like(state)
    return _decode(r, k, v, w, u, state, new_state, None), new_state


def wkv_decode_cuda_(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                     u: torch.Tensor, state: torch.Tensor,
                     active: torch.Tensor | None = None) -> torch.Tensor:
    """The in-place step on the card: the inputs of :func:`wkv_decode_cuda`
    and ``active`` ((B,) bool, or None: every slot) -> out (B, H, V) fp32;
    the new state is written over ``state`` in the active slots' rows, and
    an inactive slot's rows are not written.  ``state`` must be the tensor
    to update: contiguous, 16-byte aligned fp32, or this raises (a copy
    would take the update and leave ``state`` as it was)."""
    if (state.dtype != torch.float32 or not state.is_contiguous()
            or state.data_ptr() % 16):
        raise ValueError(f"wkv_decode_step_: the state must be contiguous, 16-byte "
                         f"aligned fp32 to be updated in place, got {state.dtype} strides "
                         f"{state.stride()} at {state.data_ptr() % 16} bytes past 16")
    return _decode(r, k, v, w, u, state, state, active)


def wkv_decode_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                    u: torch.Tensor, state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused decode step: (out (B, H, V) fp32, new state (B, H, K, V)
    fp32, a fresh tensor: ``state`` is left as it was).  Serving only: no
    gradient."""
    if r.device.type == "cpu":
        return wkv_decode_ref(r, k, v, w, u, state)
    return wkv_decode_cuda(r, k, v, w, u, state)


def wkv_decode_step_(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                     u: torch.Tensor, state: torch.Tensor,
                     active: torch.Tensor | None = None) -> torch.Tensor:
    """One fused decode step in place: out (B, H, V) fp32; the new state is
    written over ``state`` in the rows of the active slots (every slot when
    ``active`` is None) and an inactive slot's rows stay bit for bit.
    Serving only: no gradient."""
    if r.device.type == "cpu":
        return wkv_decode_ref_(r, k, v, w, u, state, active)
    return wkv_decode_cuda_(r, k, v, w, u, state, active)
