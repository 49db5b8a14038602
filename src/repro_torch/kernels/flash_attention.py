"""FlashAttention on the model's (B, S, H, hd) layout: the CUDA forward
kernel of ``csrc/flash_attention.cu`` (ported from
``repro/kernels/flash_attention.py:_fwd_kernel``), the dQ and dK/dV kernels
of ``csrc/flash_attention_bwd.cu`` (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``),
their plain versions, and the ``torch.autograd.Function`` that joins them.

The Function saves (q, k, v, o, lse) from the forward.  For CUDA tensors its
forward and backward launch the kernels or raise; for CPU tensors they take
the plain versions (``kernels/ref.py``).  ``launches``, ``launches_bwd_dq``
and ``launches_bwd_dkv`` count the three kernels' launches.

The bf16 kernels are persistent Hopper kernels (TMA into a shared-memory
ring, ``wgmma``, a producer warp and two consumer warpgroups) sharing the
tiling of ``csrc/flash_common.cuh``.  Their host-side choices are mirrored
here: the forward's and the dQ kernel's items and their order
(``chunk_pairs``, ``work_order``), the key tiles an item walks
(``key_tiles``), the dK/dV kernel's items (``dkv_chunk``,
``dkv_work_order``) and the query tiles they walk (``query_tiles``), and
which tiles take the mask (``edge_tile``, ``dkv_edge_tile``);
``chip_smoke.py`` holds them to the C entries (``flash_fwd_chunk``,
``flash_bwd_item``, ``flash_bwd_edge``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.compute import kernel_forward
from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

HEAD_DIMS = (64, 80, 88, 128)   # the head dims csrc/flash_attention*.cu are built for
launches = 0
launches_bwd_dq = 0
launches_bwd_dkv = 0

# The bf16 forward's work, as csrc/flash_attention.cu lays it out: an item
# is BLOCK_M query rows of one (b, h), whose two warpgroups of 64 rows walk
# key tiles of BLOCK_N; a persistent grid of one block per SM takes the
# items in ``work_order``, each block the next one as it comes free.
BLOCK_M = 128
BLOCK_N = 128
L2_CHUNK_BYTES = 16 << 20
# The bf16 backward's (csrc/flash_attention_bwd.cu): the dQ kernel takes the
# forward's items and order and walks key tiles of DQ_BLOCK_N; a dK/dV item
# is DKV_BLOCK_N keys of one (b, KV head), whose two warpgroups of 64 keys
# walk the DKV_BLOCK_M-row query tiles of each of the G query heads.
DQ_BLOCK_N = 64
DKV_BLOCK_N = 128
DKV_BLOCK_M = 64
WG_ROWS = 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def chunk_pairs(B: int, Hq: int, Hkv: int, Skv: int, hd: int) -> int:
    """(b, h) pairs per chunk of the work order (``chunk_pairs``): whole
    GQA groups whose K and V (bf16, hd padded to 16) fit L2_CHUNK_BYTES,
    spread evenly over the chunks."""
    G, pairs = Hq // Hkv, B * Hq
    group_bytes = 2 * Skv * _cdiv(hd, 16) * 16 * 2
    most = max(1, L2_CHUNK_BYTES // max(group_bytes, 1)) * G
    if most >= pairs:
        return pairs
    per = _cdiv(pairs, _cdiv(pairs, most))
    return _cdiv(per, G) * G


def work_order(B: int, Sq: int, Hq: int, chunk: int, causal: bool,
               block: int = BLOCK_M) -> list[tuple[int, int, int]]:
    """(q0, h, b) of each item of ``block`` rows in order (``q_item``): the
    (b, h) pairs, b-major, in chunks of ``chunk``; within a chunk query tile
    by query tile, the last (longest) first when causal, then pair by
    pair."""
    nq, pairs = _cdiv(Sq, block), B * Hq
    order = []
    for first in range(0, pairs, chunk):
        size = min(chunk, pairs - first)
        for qi in range(nq):
            qt = nq - 1 - qi if causal else qi
            order += [(qt * block, pair % Hq, pair // Hq)
                      for pair in range(first, first + size)]
    return order


def key_tiles(q0: int, Sq: int, Skv: int, *, causal: bool, window: int | None,
              q_offset: int, block_n: int = BLOCK_N) -> list[int]:
    """The first key of each tile of ``block_n`` keys that an item of
    BLOCK_M query rows walks (``key_range``; the dQ kernel's with
    DQ_BLOCK_N), in the order it walks them: from the last tile back to the
    first."""
    hi = min(Skv, min(q0 + BLOCK_M, Sq) + q_offset) if causal else Skv
    lo = max(0, q0 + q_offset - window + 1) if window else 0
    start = lo // block_n * block_n
    n = _cdiv(hi - start, block_n) if hi > start else 0
    return [start + (n - 1 - i) * block_n for i in range(n)]


def edge_tile(k0: int, r_lo: int, Sq: int, Skv: int, *, causal: bool,
              window: int | None, q_offset: int, block_n: int = BLOCK_N) -> bool:
    """Whether the warpgroup of query rows [r_lo, r_lo + 64) masks the key
    tile [k0, k0 + block_n) (``rows_edge``: a tile that crosses the Skv
    edge, the causal diagonal or the window's start); other tiles skip the
    mask."""
    r_hi = max(min(r_lo + WG_ROWS, Sq), r_lo + 1)
    return (k0 + block_n > Skv or (causal and k0 + block_n - 1 > r_lo + q_offset)
            or bool(window) and k0 <= r_hi - 1 + q_offset - window)


def dkv_chunk(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, hd: int, sms: int) -> int:
    """(b, KV head) pairs per chunk of the dK/dV order (``dkv_chunk``): as
    many as keep their G heads' Q and dO (bf16, hd padded to 16) within
    L2_CHUNK_BYTES, but at least two waves of items on ``sms`` blocks,
    spread evenly over the chunks."""
    pairs = B * Hkv
    per = max(1, L2_CHUNK_BYTES // max(2 * (Hq // Hkv) * Sq * _cdiv(hd, 16) * 16 * 2, 1))
    per = max(per, _cdiv(2 * sms, _cdiv(Skv, DKV_BLOCK_N)))
    return pairs if per >= pairs else _cdiv(pairs, _cdiv(pairs, per))


def dkv_work_order(B: int, Hkv: int, Skv: int, chunk: int) -> list[tuple[int, int, int]]:
    """(k0, hk, b) of each dK/dV item in order (``dkv_work_of``): the
    (b, hk) pairs, b-major, in chunks of ``chunk``; within a chunk key tile
    by key tile from the first (under a causal mask the longest), pair by
    pair."""
    return work_order(B, Skv, Hkv, chunk, causal=False, block=DKV_BLOCK_N)


def query_tiles(k0: int, Sq: int, Skv: int, *, causal: bool, window: int | None,
                q_offset: int) -> list[int]:
    """The first row of each DKV_BLOCK_M-row query tile that the dK/dV item
    of keys [k0, k0 + DKV_BLOCK_N) walks for each query head
    (``query_range``), in order."""
    k1 = min(k0 + DKV_BLOCK_N, Skv)
    lo = max(0, k0 - q_offset) if causal else 0
    hi = min(Sq, max(0, k1 - 1 + window - q_offset)) if window else Sq
    start = lo // DKV_BLOCK_M * DKV_BLOCK_M
    return list(range(start, hi, DKV_BLOCK_M)) if hi > start else []


def dkv_edge_tile(q0: int, kw: int, Sq: int, Skv: int, *, causal: bool,
                  window: int | None, q_offset: int) -> bool:
    """Whether the warpgroup of keys [kw, kw + 64) masks the query tile
    [q0, q0 + 64) (``keys_edge``: a tile that crosses the Sq or Skv edge,
    the causal diagonal or the window's end); other tiles skip the mask."""
    return (q0 + WG_ROWS > Sq or kw + WG_ROWS > Skv
            or (causal and kw + WG_ROWS - 1 > q0 + q_offset)
            or bool(window) and q0 + WG_ROWS - 1 + q_offset - kw >= window)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float,
           ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_fwd_chunk.argtypes = [ctypes.c_int] * 5
    lib.flash_fwd_chunk.restype = ctypes.c_int
    return lib


def chunk_pairs_cuda(B: int, Hq: int, Hkv: int, Skv: int, hd: int) -> int:
    """The chunk the C entry chooses, read from the library (to hold
    :func:`chunk_pairs` to it on the card)."""
    return _lib().flash_fwd_chunk(B, Hq, Hkv, Skv, hd)


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    for fn in (lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkv):
        fn.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
            + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
               ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.flash_bwd_item.argtypes = [ctypes.c_int] * 12 + [ctypes.POINTER(ctypes.c_int)]
    lib.flash_bwd_item.restype = ctypes.c_int
    lib.flash_bwd_edge.argtypes = [ctypes.c_int] * 8
    lib.flash_bwd_edge.restype = ctypes.c_int
    return lib


def bwd_items_cuda(kernel: str, B: int, Hq: int, Hkv: int, Sq: int, Skv: int, hd: int,
                   sms: int, *, causal: bool, window: int | None,
                   q_offset: int) -> list[tuple]:
    """The records of every item of the bf16 ``"dq"`` or ``"dkv"`` kernel on
    ``sms`` SMs in the order the library takes them, (q0, h, b, kstart,
    ntiles) or (k0, hk, b, qstart, nq) (to hold the mirrors to it on the
    card)."""
    fn, code = _bwd_lib().flash_bwd_item, {"dq": 0, "dkv": 1}[kernel]
    args = (B, Hq, Hkv, Sq, Skv, hd, int(causal), window or 0, q_offset, sms)
    out = (ctypes.c_int * 5)()
    records = []
    for item in range(fn(code, -1, *args, out)):
        fn(code, item, *args, out)
        records.append(tuple(out))
    return records


def bwd_edge_cuda(kernel: str, a: int, b: int, Sq: int, Skv: int, *, causal: bool,
                  window: int | None, q_offset: int) -> bool:
    """Whether the library's ``"dq"`` kernel masks the key tile from ``b`` for
    the query rows from ``a``, or its ``"dkv"`` kernel the query tile from
    ``b`` for the keys from ``a``."""
    return bool(_bwd_lib().flash_bwd_edge({"dq": 0, "dkv": 1}[kernel], a, b, Sq, Skv,
                                          int(causal), window or 0, q_offset))


def _head_contiguous(t: torch.Tensor) -> torch.Tensor:
    """Unit stride on hd and 16-byte aligned rows, as the kernel reads them."""
    vec = 16 // t.element_size()
    if (t.stride(-1) != 1 or any(s % vec for s in t.stride()[:3])
            or t.data_ptr() % 16):
        return _build.aligned(t)
    return t


def _check_args(q, k, v, sliding_window, softcap):
    B, Sq, Hq, hd = q.shape
    if (not q.is_cuda or {k.dtype, v.dtype} != {q.dtype} or k.device != q.device
            or v.device != q.device or v.shape != k.shape or k.shape[0] != B
            or k.shape[3] != hd or Hq % k.shape[2]):
        raise ValueError(f"flash_attention: q {q.dtype} {tuple(q.shape)}, "
                         f"k {k.dtype} {tuple(k.shape)}, v {v.dtype} {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if sliding_window is not None and sliding_window <= 0:
        raise ValueError(f"flash_attention: sliding_window={sliding_window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap={softcap}")
    return _build.dtype_code(q)


def flash_attention_fwd_cuda(q, k, v, *, causal=True, sliding_window=None,
                             softcap=None, q_offset=0):
    """q: (B, Sq, Hq, hd), k/v: (B, Skv, Hkv, hd) on the card in one dtype ->
    (O like q, LSE (B, Hq, Sq) fp32)."""
    global launches
    code = _check_args(q, k, v, sliding_window, softcap)
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    q, k, v = (_head_contiguous(t) for t in (q, k, v))
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
    lib = _lib()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, Hq, Hkv, Sq, Skv, hd, strides, int(causal), sliding_window or 0,
        softcap or 0.0, int(q_offset), float(1.0 / np.sqrt(hd)), code,
        _build.stream_of(q))
    _build.check(lib, err, "flash_attention_fwd")
    launches += 1
    return o, lse


def bwd_args(q, k, v, o, lse, do, *, causal=True, sliding_window=None,
             softcap=None, q_offset=0):
    """The C arguments of both backward kernels and the gradients they will
    fill, (dq like q, dk/dv like k and v, in their dtype), for the attention
    whose forward gave ``o`` and ``lse`` (B, Hq, Sq) fp32 and the output
    cotangent ``do`` like q.  delta = rowsum(dO*O) is a plain torch op here,
    as the reference computes it outside its kernels."""
    code = _check_args(q, k, v, sliding_window, softcap)
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    if (o.shape != q.shape or do.shape != q.shape or lse.shape != (B, Hq, Sq)
            or lse.dtype != torch.float32 or not (o.is_cuda and do.is_cuda)):
        raise ValueError(f"flash_attention bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {lse.dtype} {tuple(lse.shape)}")
    do = do.to(q.dtype)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    q, k, v, do = (_head_contiguous(t) for t in (q, k, v, do))
    lse = lse.contiguous()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    strides = (ctypes.c_longlong * 21)(
        *(s for t in (q, k, v, do, dq, dk, dv) for s in t.stride()[:3]))
    # the tensors ride along so that they outlive the launches
    args = ((q, k, v, do, lse, delta, dq, dk, dv),
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             B, Hq, Hkv, Sq, Skv, hd, strides, int(causal), sliding_window or 0,
             softcap or 0.0, int(q_offset), float(1.0 / np.sqrt(hd)), code,
             _build.stream_of(q)))
    return args, (dq, dk, dv)


def launch_bwd_dq(args) -> None:
    """One launch of the dQ kernel (``_bwd_dq_kernel``) on :func:`bwd_args`."""
    global launches_bwd_dq
    lib = _bwd_lib()
    _build.check(lib, lib.flash_attention_bwd_dq(*args[1]), "flash_attention_bwd_dq")
    launches_bwd_dq += 1


def launch_bwd_dkv(args) -> None:
    """One launch of the dK/dV kernel (``_bwd_dkv_kernel``) on :func:`bwd_args`."""
    global launches_bwd_dkv
    lib = _bwd_lib()
    _build.check(lib, lib.flash_attention_bwd_dkv(*args[1]), "flash_attention_bwd_dkv")
    launches_bwd_dkv += 1


def flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw):
    """(dq, dk, dv) on the card: delta, then the dQ and the dK/dV kernels."""
    args, grads = bwd_args(q, k, v, o, lse, do, **kw)
    launch_bwd_dq(args)
    launch_bwd_dkv(args)
    return grads


def _bhsd(*ts):
    return tuple(t.transpose(1, 2) for t in ts)


class FlashAttention(torch.autograd.Function):
    @staticmethod
    @kernel_forward
    def forward(ctx, q, k, v, causal, sliding_window, softcap, q_offset):
        kw = dict(causal=causal, sliding_window=sliding_window, softcap=softcap,
                  q_offset=q_offset)
        if q.device.type == "cpu":
            o, lse = flash_attention_ref(*_bhsd(q, k, v), return_lse=True, **kw)
            o = o.transpose(1, 2)
        else:
            o, lse = flash_attention_fwd_cuda(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = _bhsd(*flash_attention_bwd_ref(*_bhsd(q, k, v, o), lse,
                                                   do.transpose(1, 2), **ctx.kw))
        else:
            grads = flash_attention_bwd_cuda(q, k, v, o, lse, do, **ctx.kw)
        return (*grads, None, None, None, None)


def flash_attention(q, k, v, *, causal=True, sliding_window=None, softcap=None,
                    q_offset=0):
    """(B, Sq, Hq, hd) attention output; GQA reads KV head h // (Hq/Hkv).
    Differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, causal, sliding_window, softcap, q_offset)
