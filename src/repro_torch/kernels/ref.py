"""Plain PyTorch versions of the ported kernels (``repro/kernels/ref.py``).

They are the CPU path of the kernel wrappers and the oracle that the CUDA
kernels are held against on the card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def flash_attention_ref(
    q: torch.Tensor,   # (B, Hq, Sq, hd)
    k: torch.Tensor,   # (B, Hkv, Skv, hd)
    v: torch.Tensor,   # (B, Hkv, Skv, hd)
    *,
    causal: bool = True,
    sliding_window: int | None = None,
    softcap: float | None = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Returns O in q's dtype (and, with ``return_lse``, the fp32 row
    log-sum-exp (B, Hq, Sq)); a row that sees no key gives 0."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if G > 1:
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
    scale = 1.0 / np.sqrt(hd)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Skv, device=q.device)
    mask = None
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    if sliding_window is not None:
        w = qpos[:, None] - kpos[None, :] < sliding_window
        mask = w if mask is None else mask & w
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)  # fully masked rows
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def swiglu_ref(x: torch.Tensor, w1: torch.Tensor,
               w3: torch.Tensor) -> torch.Tensor:
    """Fused gate: silu(x@w1) * (x@w3), the products in x's dtype."""
    a = x @ w1
    b = x @ w3
    return (F.silu(a.float()) * b.float()).to(x.dtype)
