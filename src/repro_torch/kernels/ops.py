"""Public kernel entry points with the signatures and layouts of
``repro/kernels/ops.py``.

Each entry is differentiable through its ``torch.autograd.Function``: it
takes its plain PyTorch version for a CPU tensor and launches its
hand-written CUDA kernel for a CUDA tensor, or raises; nothing falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cross_entropy as ce
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gelu_mlp as gm
from repro_torch.kernels import grouped_mlp as gp
from repro_torch.kernels import layernorm as ln
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import swiglu as sg
from repro_torch.kernels import wkv_scan as wkv

# kernel name -> (module, name of its launch counter)
KERNEL_COUNTERS = {
    "flash_attention": (fa, "launches"),
    "flash_attention_bwd_dq": (fa, "launches_bwd_dq"),
    "flash_attention_bwd_dkv": (fa, "launches_bwd_dkv"),
    "rmsnorm": (rn, "launches"),
    "swiglu": (sg, "launches"),
    "layernorm": (ln, "launches"),
    "gelu_mlp": (gm, "launches"),
    "cross_entropy": (ce, "launches"),
    "grouped_mlp": (gp, "launches"),
    "ssd_scan": (ssd, "launches"),
    "mamba_decode_step": (ssd, "launches_decode"),
    "wkv_scan": (wkv, "launches"),
    "wkv_decode_step": (wkv, "launches_decode"),
}


def flash_attention(
    q: torch.Tensor,   # (B, Sq, Hq, hd) — model layout
    k: torch.Tensor,   # (B, Skv, Hkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: int | None = None,
    softcap: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """FlashAttention over the model's (B, S, H, hd) layout; the kernels read
    it through strides, so no transposes are made on the card."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"query heads {q.shape[2]} not a multiple of KV "
                         f"heads {k.shape[2]}")
    return fa.flash_attention(q, k, v, causal=causal,
                              sliding_window=sliding_window, softcap=softcap,
                              q_offset=q_offset)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return rn.rmsnorm(x, w, eps)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    return ln.layernorm(x, w, b, eps)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """Fused silu(x@w1) * (x@w3); x: (..., d)."""
    shape = x.shape
    out = sg.swiglu(x.reshape(-1, shape[-1]), w1, w3)
    return out.reshape(*shape[:-1], w1.shape[1])


def gelu_mlp_in(x: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """Fused gelu(x@w1) (tanh approximation); x: (..., d)."""
    shape = x.shape
    out = gm.gelu_mlp_in(x.reshape(-1, shape[-1]), w1)
    return out.reshape(*shape[:-1], w1.shape[1])


def cross_entropy_tokens(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                         valid_vocab: int | None = None) -> torch.Tensor:
    """Per-token CE losses (N,) fp32, the train path's entry (callers apply
    their own loss mask and normalisation); the (N, V) logits are never
    written whole."""
    return ce.cross_entropy_tokens(h, w, labels, valid_vocab)


def cross_entropy(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                  valid_vocab: int | None = None) -> torch.Tensor:
    """Mean blocked CE over the tokens."""
    return cross_entropy_tokens(h, w, labels, valid_vocab).mean()


def grouped_mlp(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor | None,
                w2: torch.Tensor, mask: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    """Grouped expert MLP over the expert-major slot layout: x (E, N, d),
    w1/w3 (E, d, F), w2 (E, F, d), mask (E, N) -> (E, N, d).  Masked
    (padded-capacity) slots give zero output and zero weight gradients.
    ``act`` in {"swiglu", "gelu"}; differentiable."""
    if act == "swiglu":
        if w3 is None:
            raise ValueError("act='swiglu' needs w3")
    elif act != "gelu":
        raise ValueError(f"unsupported grouped-MLP act {act!r}")
    return gp.grouped_mlp(x, w1, w3 if act == "swiglu" else None, w2, mask, act)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             A_log: torch.Tensor, *, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused mamba2 chunked SSD scan: x (B, T, H, P), dt (B, T, H), Bm/Cm
    (B, T, N), A_log (H,) -> (y (B, T, H, P) in x's dtype, final state
    (B, H, P, N) fp32).  ``chunk`` must be a power of two <= 128 dividing T
    (``tiling.pick_chunk``); differentiable."""
    return ssd.ssd_scan(x, dt, Bm, Cm, A_log, chunk=chunk)


def mamba_decode_step(window: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                      dt_raw: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
                      D: torch.Tensor, state: torch.Tensor, *, n_heads: int,
                      head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused single-token mamba decode chain (conv window -> gate -> state
    update -> read-out): window (B, K, ch), state (B, H, P, N) fp32 ->
    (y (B, H, P) fp32, new state in a fresh tensor).  Serving only."""
    return ssd.mamba_decode_step(window, conv_w, conv_b, dt_raw, dt_bias, A_log, D,
                                 state, n_heads=n_heads, head_dim=head_dim)


def mamba_decode_step_(window: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                       dt_raw: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
                       D: torch.Tensor, state: torch.Tensor,
                       active: torch.Tensor | None = None, *, n_heads: int,
                       head_dim: int) -> torch.Tensor:
    """:func:`mamba_decode_step` in place: y (B, H, P) fp32; the new state is
    written over ``state`` in the rows of the slots that ``active`` ((B,)
    bool, or None: all) marks, the others' rows left bit for bit.  On the
    card ``state`` must be contiguous, 16-byte aligned fp32.  Serving
    only."""
    return ssd.mamba_decode_step_(window, conv_w, conv_b, dt_raw, dt_bias, A_log, D,
                                  state, active, n_heads=n_heads, head_dim=head_dim)


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state: torch.Tensor, *,
             chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused rwkv chunked wkv scan: r/k/w (B, T, H, K), v (B, T, H, V),
    u (H, K), state (B, H, K, V) -> (y (B, T, H, V) fp32, final state).  All
    operands are computed in fp32 (as the reference recurrence); ``chunk``
    must be a power of two <= 32 dividing T (``tiling.pick_chunk``);
    differentiable."""
    return wkv.wkv_scan(r, k, v, w, u, state, chunk=chunk)


def wkv_decode_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                    u: torch.Tensor, state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused single-token rwkv time-mix core step: r/k/w (B, H, K) fp32,
    v (B, H, V) fp32, u (H, K), state (B, H, K, V) fp32 -> (out (B, H, V)
    fp32, new state in a fresh tensor).  Serving only."""
    return wkv.wkv_decode_step(r, k, v, w, u, state)


def wkv_decode_step_(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                     u: torch.Tensor, state: torch.Tensor,
                     active: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`wkv_decode_step` in place: out (B, H, V) fp32; the new state is
    written over ``state`` in the rows of the slots that ``active`` ((B,)
    bool, or None: all) marks, the others' rows left bit for bit.  On the
    card ``state`` must be contiguous, 16-byte aligned fp32.  Serving
    only."""
    return wkv.wkv_decode_step_(r, k, v, w, u, state, active)


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNEL_COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNEL_COUNTERS.values():
        setattr(mod, attr, 0)
