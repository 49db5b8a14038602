"""Common neural-net layers (port of ``repro/models/layers.py``): norms, RoPE,
GQA attention, MLPs and the KV-cache write.  Plain functions on tensors and
nested parameter dicts, in the JAX package's layouts.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.compute import ComputePolicy, checkpointed, resolve as resolve_policy
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import layernorm_ref, rmsnorm_ref, swiglu_ref
from repro_torch.runtime.collectives import sum_over_model

# queries per block of the plain attention: bounds the (chunk x Skv) scores
Q_CHUNK = 1024

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

rms_norm = rmsnorm_ref
layer_norm = layernorm_ref


def rms_norm_split(x: torch.Tensor, weight: torch.Tensor, eps: float, group=None
                   ) -> torch.Tensor:
    """RMSNorm over a last dim that is split over the ranks of ``group``
    (each holds its block of x and of the weight): the mean square of the
    whole dim is the ranks' fp32 mean squares summed over the group
    (``collectives.sum_over_model``, whose backward sums the ranks'
    gradients of it) over their count (a one-rank group: the ops of
    :func:`rms_norm`); without a group, :func:`rms_norm`."""
    if group is None:
        return rms_norm(x, weight, eps)
    x32 = x.float()
    var = sum_over_model(x32.square().mean(dim=-1, keepdim=True), group)
    n = dist.get_world_size(group)
    if n > 1:
        var = var / n
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def apply_norm(x: torch.Tensor, params: dict, kind: str, eps: float,
               use_kernel: bool = False) -> torch.Tensor:
    if kind == "rmsnorm":
        if use_kernel:
            return kernel_ops.rmsnorm(x, params["scale"], eps)
        return rms_norm(x, params["scale"], eps)
    if use_kernel:
        return kernel_ops.layernorm(x, params["scale"], params["bias"], eps)
    return layer_norm(x, params["scale"], params["bias"], eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=16)
def _rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    # kept on the device: a copy from pageable host memory per call would
    # synchronize the stream twice per layer
    return torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: broadcastable to (..., S)."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * freqs       # (..., S, hd/2)
    angles = angles[..., None, :]                        # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _attend_block(q, k, v, q_positions, kv_positions, *, causal, sliding_window,
                  softcap, scale):
    """q (B, Cq, Hkv, G, hd), k/v (B, Skv, Hkv, hd); positions (S,) or (B, S)."""
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    qp = q_positions if q_positions.ndim == 2 else q_positions[None]
    kvp = kv_positions if kv_positions.ndim == 2 else kv_positions[None]
    mask = None
    if causal:
        # kv_positions < 0 marks not-yet-written ring-buffer slots
        mask = (kvp[:, None, :] <= qp[:, :, None]) & (kvp[:, None, :] >= 0)
    if sliding_window is not None:
        win = qp[:, :, None] - kvp[:, None, :] < sliding_window
        mask = win if mask is None else (mask & win)
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def attention(
    q: torch.Tensor,            # (B, Sq, Hq, hd)
    k: torch.Tensor,            # (B, Skv, Hkv, hd)
    v: torch.Tensor,            # (B, Skv, Hkv, hd)
    *,
    causal: bool = True,
    q_offset: torch.Tensor | int = 0,
    sliding_window: int | None = None,
    softcap: float | None = None,
    kv_positions: torch.Tensor | None = None,
    policy: ComputePolicy | None = None,
) -> torch.Tensor:
    """GQA attention.  ``q_offset`` is the absolute position of q[:, 0] on
    the KV timeline: an int, or a (B,) tensor when every slot sits at its
    own position.  ``kv_positions`` overrides ``arange(Skv)`` (negative =
    not yet written).  ``policy.kernels`` takes the flash kernel under the JAX package's condition: no ``kv_positions``, more
    than one query and an int ``q_offset``."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of KV heads {Hkv}")
    pol = resolve_policy(policy)
    if (pol.kernels and kv_positions is None and Sq > 1
            and isinstance(q_offset, int)):
        return kernel_ops.flash_attention(
            q, k, v, causal=causal, sliding_window=sliding_window,
            softcap=softcap, q_offset=q_offset)
    G = Hq // Hkv
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(B, Sq, Hkv, G, hd)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=q.device)
    ar = torch.arange(Sq, device=q.device)
    if isinstance(q_offset, torch.Tensor) and q_offset.ndim == 1:
        q_positions = q_offset[:, None] + ar[None, :]
    else:
        q_positions = ar + q_offset

    def block(qc, pc):
        return _attend_block(qc, k, v, pc, kv_positions, causal=causal,
                             sliding_window=sliding_window, softcap=softcap,
                             scale=scale)

    if Sq <= Q_CHUNK or Sq % Q_CHUNK != 0 or q_positions.ndim == 2:
        out = block(qg, q_positions)
    else:
        # always checkpointed under autograd, whatever the remat policy:
        # saving each chunk's (Q_CHUNK x Skv) probabilities would bring back
        # the footprint the chunking exists to avoid
        chunk = checkpointed(block)
        out = torch.cat([chunk(qg[:, i:i + Q_CHUNK], q_positions[i:i + Q_CHUNK])
                         for i in range(0, Sq, Q_CHUNK)], dim=1)
    return out.reshape(B, Sq, Hq, hd)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    return swiglu_ref(x, w1, w3) @ w2


def gelu_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    return F.gelu(x @ w1, approximate="tanh") @ w2


def mlp(x: torch.Tensor, params: dict, act: str, use_kernel: bool = False) -> torch.Tensor:
    if act == "swiglu":
        if use_kernel:
            return kernel_ops.swiglu(x, params["w1"], params["w3"]) @ params["w2"]
        return swiglu(x, params["w1"], params["w3"], params["w2"])
    if use_kernel:
        # the w2 product stays a plain matmul, as it is jnp outside the
        # kernel in the reference
        return kernel_ops.gelu_mlp_in(x, params["w1"]) @ params["w2"]
    return gelu_mlp(x, params["w1"], params["w2"])


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def cache_update(cache_k: torch.Tensor, cache_v: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, pos: torch.Tensor,
                 active: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Write (B, 1, ...) new entries at position ``pos`` of (B, S, ...)
    caches, in place: the KV (B, S, Hkv, hd), or an int8 cache's scales
    (B, S, Hkv).  ``pos`` is a scalar (whole-batch decode) or a (B,) vector
    (every slot writes its own position); an ``active`` (B,) mask keeps the
    entries of inactive slots as they were."""
    b = torch.arange(cache_k.shape[0], device=cache_k.device)
    p = pos.long().expand(cache_k.shape[0])
    for cache, new in ((cache_k, k), (cache_v, v)):
        new = new[:, 0].to(cache.dtype)
        if active is not None:
            keep = active.reshape(-1, *([1] * (new.ndim - 1)))
            new = torch.where(keep, new, cache[b, p])
        cache[b, p] = new
    return cache_k, cache_v


# ---------------------------------------------------------------------------
# int8 KV-cache quantization (per-token, per-head absmax scales)
# ---------------------------------------------------------------------------

def kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., hd) -> (int8 values, fp32 scale over the trailing dim), the
    rule of ``repro/models/layers.py:kv_quantize``: absmax / 127 with a
    1e-8 floor, round half to even, clip to +-127."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)
