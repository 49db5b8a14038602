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

``tp`` (a model-group process group, training only) runs a layer on the
rank's heads.  The fused ``in_proj`` is not one head split: its columns are
[z | x | B | C | dt], and a rank holds [z_k | x_k | B | C | dt_k], its heads'
parts and the B and C columns whole (ngroups 1: every head reads them);
the conv's channels [x | B | C] likewise [x_k | B | C] (:func:`head_pieces`,
the one map every reader of a rank's block takes).  The B and C columns
and channels pass through ``collectives.copy_to_model``, since each rank's
heads give part of their gradient.  ``A_log``, ``D``, ``dt_bias``, ``norm``
and ``out_proj``'s rows split on head boundaries; the gated RMSNorm over all
of d_inner sums its squares over the group (``layers.rms_norm_split``), and
``out_proj`` is row-parallel (``collectives.reduce_from_model``).
"""
from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.compute import ComputePolicy, resolve as resolve_policy
from repro_torch.core.sharding import Pieces
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import mamba_decode_ref_, ssd_scan_ref
from repro_torch.kernels.tiling import SSD_CHUNK, pick_chunk
from repro_torch.models import blocks, layers
from repro_torch.models.blocks import norm_spec
from repro_torch.models.common import ModelConfig, Spec
from repro_torch.runtime.collectives import copy_to_model, reduce_from_model


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


def head_pieces(cfg: ModelConfig) -> dict[str, Pieces]:
    """How the model axis lays out the head dim of the mamba2 leaves that
    do not split evenly under tensor parallelism: ``in_proj``'s columns
    [z | x | B | C | dt] and the conv's channels [x | B | C], each rank
    holding its heads' part of z, x and dt and the B and C columns whole.
    The other ``ssm_heads`` leaves split evenly on head boundaries."""
    di, N, H = d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg)
    conv = Pieces(((di, True), (2 * N, False)))
    return {"in_proj": Pieces(((di, True), (di, True), (2 * N, False), (H, True))),
            "conv_w": conv, "conv_b": conv}


def _split_proj(proj: torch.Tensor, cfg: ModelConfig, H: int):
    """in_proj output over H heads -> (z, xbc = concat(x, B, C) for the
    conv, dt)."""
    di = H * cfg.ssm_head_dim
    N = cfg.ssm_state
    return torch.split(proj, [di, di + 2 * N, H], dim=-1)


def _split_xbc(xbc: torch.Tensor, cfg: ModelConfig, H: int):
    di = H * cfg.ssm_head_dim
    N = cfg.ssm_state
    return torch.split(xbc, [di, N, N], dim=-1)


def _shared_cols(w: torch.Tensor, start: int, n: int, tp) -> torch.Tensor:
    """``w`` with its last-dim columns [start, start + n), which every rank
    of ``tp`` holds and uses whole, through ``copy_to_model`` (their
    gradient summed over the group); ``w`` itself without tp."""
    if tp is None:
        return w
    return torch.cat([w[..., :start], copy_to_model(w[..., start:start + n], tp),
                      w[..., start + n:]], dim=-1)


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


def _mamba_seq(params: dict, x: torch.Tensor, cfg: ModelConfig, pol: ComputePolicy,
               tp=None):
    """Full-sequence mamba2 block with residual -> (out, pre-conv xbc, final
    SSD state), over the heads the weights hold (all, or the rank's under
    ``tp``: see the module docstring)."""
    B, T, _ = x.shape
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    H = params["A_log"].shape[-1]
    di = H * P
    h = layers.apply_norm(x, params["ln"], cfg.norm, cfg.rms_eps, use_kernel=pol.kernels)
    if tp is not None:
        h = copy_to_model(h, tp)
    in_proj = _shared_cols(params["in_proj"], 2 * di, 2 * N, tp)
    conv_w, conv_b = (_shared_cols(params[k], di, 2 * N, tp) for k in ("conv_w", "conv_b"))
    z, xbc, dt_raw = _split_proj(h @ in_proj, cfg, H)
    xin, Bm, Cm = _split_xbc(_causal_conv(xbc, conv_w, conv_b), cfg, H)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    xh = xin.reshape(B, T, H, P)
    y, state = _ssd_chunked(xh, dt, Bm, Cm, params["A_log"],
                            chunk=pick_chunk(T, SSD_CHUNK), policy=pol)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, T, di)
    y = layers.rms_norm_split(y * F.silu(z), params["norm"], cfg.rms_eps, tp)
    out = y @ params["out_proj"]
    if tp is not None:
        out = reduce_from_model(out, tp)
    return x + out, xbc, state


def mamba_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                policy: ComputePolicy | None = None, tp=None) -> torch.Tensor:
    """Full-sequence mamba2 block with residual; x: (B, T, d)."""
    return _mamba_seq(params, x, cfg, resolve_policy(policy), tp)[0]


def segment_body(cfg: ModelConfig, policy: ComputePolicy | None = None, tp=None):
    """The layer body over one mamba2 layer's weights (the rank's heads
    under ``tp``): the SSD state is sequence-level and layer-local in
    training, so nothing is carried."""
    def body(lp: dict, x: torch.Tensor) -> torch.Tensor:
        return mamba_block(lp, x, cfg, policy=policy, tp=tp)
    return body


def hybrid_segment_body(cfg: ModelConfig, policy: ComputePolicy | None,
                        shared_params: dict, cast: Callable[[dict], dict], tp=None):
    """The body of one zamba2 "super" unit: its ``hybrid_attn_every`` mamba
    layers, then the weight-tied shared attention + MLP block.
    ``shared_params`` is the one set of shared weights (storage dtype;
    ``cast`` gives the compute dtype inside each remat wrapper), closed over
    by every unit, so autograd sums the units' gradients into it, as
    ``Segment.tied`` does in the reference.  Each mamba layer and the shared
    application runs under the policy's remat wrapper; under ``tp`` the
    mamba layers on the rank's heads and the shared block as Megatron's
    pair (``blocks.segment_body``)."""
    pol = resolve_policy(policy)
    mamba = segment_body(cfg, pol, tp)
    shared = blocks.segment_body(
        cfg, pol, par=blocks.Parallel({} if tp is None else {"attn": tp, "mlp": tp}))
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
    z, xbc, dt_raw = _split_proj((h @ params["in_proj"])[:, 0], cfg, H)   # (B, ...)
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
