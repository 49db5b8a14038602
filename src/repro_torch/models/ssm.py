"""Mamba-2 (SSD) blocks, the state-space layers of zamba2 (port of
``repro/models/ssm.py``).

Training and prefill run the chunked SSD algorithm (intra-chunk masked
products and an inter-chunk recurrent carry); under ``policy.kernels`` the
whole scan is the SSD kernel (``kernels/ssd_scan.py``) at the same chunk
size.  Decode is the O(1) single-step recurrence over the carried
(H, P, N) state, which it updates in place in the active slots' rows;
under ``policy.kernels`` its conv-window, gate, state update and read-out
run as one fused kernel.  The gated ``rms_norm(y * silu(z))`` stays
plain, as it is in the reference.
"""
from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.compute import ComputePolicy, resolve as resolve_policy
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import mamba_decode_ref_, ssd_scan_ref
from repro_torch.kernels.tiling import SSD_CHUNK, pick_chunk
from repro_torch.models import blocks, layers
from repro_torch.models.blocks import norm_spec
from repro_torch.models.common import ModelConfig, Spec


def d_inner(cfg: ModelConfig) -> int:
    return 2 * cfg.d_model


def n_ssm_heads(cfg: ModelConfig) -> int:
    di = d_inner(cfg)
    if di % cfg.ssm_head_dim:
        raise ValueError(f"d_inner {di} is not a multiple of ssm_head_dim "
                         f"{cfg.ssm_head_dim}")
    return di // cfg.ssm_head_dim


def conv_channels(cfg: ModelConfig) -> int:
    return d_inner(cfg) + 2 * cfg.ssm_state


def mamba_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = d_inner(cfg)
    H = n_ssm_heads(cfg)
    N = cfg.ssm_state
    K = cfg.conv_kernel
    proj_out = 2 * di + 2 * N + H   # z, x, B, C, dt
    return {
        "ln": norm_spec(d, cfg.norm),
        "in_proj": Spec((d, proj_out), ("embed", "ssm_heads")),
        "conv_w": Spec((K, di + 2 * N), ("conv", "ssm_heads"), scale=0.5),
        "conv_b": Spec((di + 2 * N,), ("ssm_heads",), init="zeros"),
        "A_log": Spec((H,), ("ssm_heads",), init="arange_neg"),
        "D": Spec((H,), ("ssm_heads",), init="ones"),
        "dt_bias": Spec((H,), ("ssm_heads",), init="zeros"),
        "norm": Spec((di,), ("ssm_heads",), init="ones"),
        "out_proj": Spec((di, d), ("ssm_heads", "embed")),
    }


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    """in_proj output -> (z, xbc = concat(x, B, C) for the conv, dt)."""
    di = d_inner(cfg)
    N = cfg.ssm_state
    return torch.split(proj, [di, di + 2 * N, n_ssm_heads(cfg)], dim=-1)


def _split_xbc(xbc: torch.Tensor, cfg: ModelConfig):
    di = d_inner(cfg)
    N = cfg.ssm_state
    return torch.split(xbc, [di, N, N], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, kernel K small: a sum of shifted slices."""
    K = w.shape[0]
    T = xbc.shape[1]
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    out = b
    for k in range(K):
        out = out + w[k] * xp[:, k:k + T]
    return F.silu(out)


def _ssd_chunked(x, dt, Bm, Cm, A_log, *, chunk: int,
                 policy: ComputePolicy | None = None):
    """Chunked SSD scan: x (B, T, H, P), dt (B, T, H), Bm/Cm (B, T, N),
    A_log (H,) -> (y (B, T, H, P), final state (B, H, P, N) fp32).  The
    plain chunk loop runs each chunk body under the policy's remat wrapper;
    ``policy.kernels`` takes the SSD kernel at the same chunk size."""
    pol = resolve_policy(policy)
    if pol.kernels:
        return kernel_ops.ssd_scan(x, dt, Bm, Cm, A_log, chunk=chunk)
    return ssd_scan_ref(x, dt, Bm, Cm, A_log, chunk=chunk, wrap=pol.checkpoint)


def _mamba_seq(params: dict, x: torch.Tensor, cfg: ModelConfig, pol: ComputePolicy):
    """Full-sequence mamba2 block with residual -> (out, pre-conv xbc, final
    SSD state)."""
    B, T, d = x.shape
    H, P = n_ssm_heads(cfg), cfg.ssm_head_dim
    h = layers.apply_norm(x, params["ln"], cfg.norm, cfg.rms_eps, use_kernel=pol.kernels)
    z, xbc, dt_raw = _split_proj(h @ params["in_proj"], cfg)
    xin, Bm, Cm = _split_xbc(_causal_conv(xbc, params["conv_w"], params["conv_b"]), cfg)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    xh = xin.reshape(B, T, H, P)
    y, state = _ssd_chunked(xh, dt, Bm, Cm, params["A_log"],
                            chunk=pick_chunk(T, SSD_CHUNK), policy=pol)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, T, 2 * d)
    y = layers.rms_norm(y * F.silu(z), params["norm"], cfg.rms_eps)
    return x + y @ params["out_proj"], xbc, state


def mamba_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                policy: ComputePolicy | None = None) -> torch.Tensor:
    """Full-sequence mamba2 block with residual; x: (B, T, d)."""
    return _mamba_seq(params, x, cfg, resolve_policy(policy))[0]


def segment_body(cfg: ModelConfig, policy: ComputePolicy | None = None):
    """The layer body over one mamba2 layer's weights: the SSD state is
    sequence-level and layer-local in training, so nothing is carried."""
    def body(lp: dict, x: torch.Tensor) -> torch.Tensor:
        return mamba_block(lp, x, cfg, policy=policy)
    return body


def hybrid_segment_body(cfg: ModelConfig, policy: ComputePolicy | None,
                        shared_params: dict, cast: Callable[[dict], dict]):
    """The body of one zamba2 "super" unit: its ``hybrid_attn_every`` mamba
    layers, then the weight-tied shared attention + MLP block.
    ``shared_params`` is the one set of shared weights (storage dtype;
    ``cast`` gives the compute dtype inside each remat wrapper), closed over
    by every unit, so autograd sums the units' gradients into it, as
    ``Segment.tied`` does in the reference.  Each mamba layer and the shared
    application runs under the policy's remat wrapper."""
    pol = resolve_policy(policy)
    mamba = segment_body(cfg, pol)
    shared = blocks.segment_body(cfg, pol)
    mamba_step = pol.checkpoint(lambda lp, x: mamba(cast(lp), x))
    shared_step = pol.checkpoint(lambda sp, x: shared(cast(sp), x))

    def body(lps: list[dict], x: torch.Tensor) -> torch.Tensor:
        for lp in lps:
            x = mamba_step(lp, x)
        return shared_step(shared_params, x)
    return body


def mamba_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  policy: ComputePolicy | None = None):
    """Like mamba_block, and also the decode cache {"conv": the last K-1
    pre-conv inputs (B, K-1, ch), zero-padded in front for a prompt shorter
    than that, as the causal conv pads it; "state": (B, H, P, N) fp32}."""
    K = cfg.conv_kernel
    out, xbc, state = _mamba_seq(params, x, cfg, resolve_policy(policy))
    conv = xbc[:, max(xbc.shape[1] - (K - 1), 0):]
    if conv.shape[1] < K - 1:
        conv = F.pad(conv, (0, 0, K - 1 - conv.shape[1], 0))
    return out, {"conv": conv, "state": state}


def mamba_decode(params: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig,
                 policy: ComputePolicy | None = None, active: torch.Tensor | None = None):
    """Single-token decode: x (B, 1, d), cache {"conv": (B, K-1, ch),
    "state": (B, H, P, N) fp32} -> (out, {"conv", "state"}).  The state leaf
    is updated in place, in the rows of the slots that ``active`` ((B,)
    bool, or None: all) marks, and returned as the same tensor; the conv
    window comes back fresh (the caller merges it).  ``policy.kernels``
    runs the conv-window, gate, state update and read-out chain as one
    fused kernel."""
    pol = resolve_policy(policy)
    B, _, d = x.shape
    H, P = n_ssm_heads(cfg), cfg.ssm_head_dim
    h = layers.apply_norm(x, params["ln"], cfg.norm, cfg.rms_eps, use_kernel=pol.kernels)
    z, xbc, dt_raw = _split_proj((h @ params["in_proj"])[:, 0], cfg)   # (B, ...)
    # the window stays a fresh concat: the H blocks of a slot all read its
    # shared B and C channels, so a roll in place would race
    window = torch.cat([cache["conv"], xbc[:, None, :].to(cache["conv"].dtype)], dim=1)
    step = kernel_ops.mamba_decode_step_ if pol.kernels else mamba_decode_ref_
    y = step(window, params["conv_w"], params["conv_b"], dt_raw, params["dt_bias"],
             params["A_log"], params["D"], cache["state"], active, n_heads=H, head_dim=P)
    y = y.reshape(B, 1, 2 * d).to(x.dtype)
    y = layers.rms_norm(y * F.silu(z[:, None, :]), params["norm"], cfg.rms_eps)
    return x + y @ params["out_proj"], {"conv": window[:, 1:], "state": cache["state"]}


def mamba_cache_specs(cfg: ModelConfig, batch: int, dtype=None) -> dict:
    H, P, N = n_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state
    K = cfg.conv_kernel
    return {
        "conv": Spec((batch, K - 1, conv_channels(cfg)),
                     ("cache_batch", None, "ssm_heads"), init="zeros", dtype=dtype),
        "state": Spec((batch, H, P, N), ("cache_batch", "ssm_heads", None, None),
                      init="zeros", dtype=torch.float32),
    }
