"""FlashAttention-2 forward: the CUDA kernel of ``csrc/flash_attention.cu``
(ported from ``repro/kernels/flash_attention.py:_fwd_kernel``) and its plain
version, on the model's (B, S, H, hd) layout.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (64, 128)
launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float,
           ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _head_contiguous(t: torch.Tensor) -> torch.Tensor:
    """Unit stride on hd and 16-byte aligned rows, as the kernel reads them."""
    vec = 16 // t.element_size()
    if (t.stride(-1) != 1 or any(s % vec for s in t.stride()[:3])
            or t.data_ptr() % 16):
        return _build.aligned(t)
    return t


def flash_attention_fwd_cuda(q, k, v, *, causal=True, sliding_window=None,
                             softcap=None, q_offset=0):
    """q: (B, Sq, Hq, hd), k/v: (B, Skv, Hkv, hd) on the card in one dtype ->
    (O like q, LSE (B, Hq, Sq) fp32)."""
    global launches
    code = _build.dtype_code(q)
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    if (not q.is_cuda or {k.dtype, v.dtype} != {q.dtype} or k.device != q.device
            or v.device != q.device or v.shape != k.shape or k.shape[0] != B
            or k.shape[3] != hd or Hq % Hkv):
        raise ValueError(f"flash_attention: q {q.dtype} {tuple(q.shape)}, "
                         f"k {k.dtype} {tuple(k.shape)}, v {v.dtype} {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if sliding_window is not None and sliding_window <= 0:
        raise ValueError(f"flash_attention: sliding_window={sliding_window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap={softcap}")
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


def flash_attention(q, k, v, *, causal=True, sliding_window=None, softcap=None,
                    q_offset=0):
    """(B, Sq, Hq, hd) attention output; GQA reads KV head h // (Hq/Hkv)."""
    if q.device.type == "cpu":
        out = flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, sliding_window=sliding_window, softcap=softcap,
            q_offset=q_offset)
        return out.transpose(1, 2)
    return flash_attention_fwd_cuda(q, k, v, causal=causal,
                                    sliding_window=sliding_window,
                                    softcap=softcap, q_offset=q_offset)[0]
