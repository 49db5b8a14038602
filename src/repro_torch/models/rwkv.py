"""RWKV-6 ("Finch") blocks: time-mix with data-dependent decay and
channel-mix (port of ``repro/models/rwkv.py``).

Attention-free: the recurrent state is (H, K, V) per layer, O(1) in
sequence length.  Training and prefill of 8 tokens or more run the chunked
wkv (log-space per-channel decays, intra-chunk scores and an inter-chunk
carry) at ``pick_chunk(T, WKV_CHUNK)``; under ``policy.kernels`` the whole
scan is the wkv kernel (``kernels/wkv_scan.py``).  Shorter inputs loop
the O(1) single-step form, under ``policy.kernels`` the fused decode-step
kernel; a decode tick takes that step in place on the cache's state, in
the active slots' rows.  Time-mix's norm takes the rmsnorm kernel under
``policy.kernels``; channel-mix's norm and ``ln_x`` stay plain, as they
are in the reference.

``tp`` (a model-group process group, training only) runs a block on the
rank's heads.  Time-mix: ``wr``/``wk``/``wv``/``wg`` and ``w_lora_b`` are
column-parallel (the rank's heads), ``w0``, ``u`` and ``ln_x`` split on head
boundaries, ``wo`` is row-parallel (``collectives.reduce_from_model``); the
normed input enters through ``collectives.copy_to_model``, and so do the
replicated ``mu_*`` and ``w_lora_a``, which are used inside the region (each
rank's heads give part of their gradient); ``ln_x``, an RMSNorm over all of
d, sums its squares over the group (``layers.rms_norm_split``).
Channel-mix: ``wk`` is column-parallel on d_ff and ``wv`` row-parallel, and
``wr`` column-parallel on d, so ``r`` holds the rank's d / tp columns: the
partial ``k @ wv`` is reduce-scattered over d, multiplied by the rank's
``r`` and all-gathered (``collectives.reduce_scatter_to_model``,
``all_gather_from_model``: the bytes of one all-reduce).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.compute import ComputePolicy, resolve as resolve_policy
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import wkv_decode_ref, wkv_decode_ref_, wkv_scan_ref
from repro_torch.kernels.tiling import WKV_CHUNK, pick_chunk
from repro_torch.models import layers
from repro_torch.models.blocks import norm_spec
from repro_torch.models.common import ModelConfig, Spec
from repro_torch.runtime.collectives import (
    all_gather_from_model, copy_to_model, reduce_from_model, reduce_scatter_to_model,
)

LORA_RANK = 64


def rwkv_head_dim(cfg: ModelConfig) -> int:
    return cfg.resolved_head_dim


def n_rwkv_heads(cfg: ModelConfig) -> int:
    hd = rwkv_head_dim(cfg)
    if cfg.d_model % hd:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of head_dim {hd}")
    return cfg.d_model // hd


def rwkv_specs(cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    r = min(LORA_RANK, d)
    tm = {
        "ln": norm_spec(d, cfg.norm),
        "mu_r": Spec((d,), ("embed",), init="zeros"),
        "mu_k": Spec((d,), ("embed",), init="zeros"),
        "mu_v": Spec((d,), ("embed",), init="zeros"),
        "mu_w": Spec((d,), ("embed",), init="zeros"),
        "mu_g": Spec((d,), ("embed",), init="zeros"),
        "wr": Spec((d, d), ("embed", "heads")),
        "wk": Spec((d, d), ("embed", "heads")),
        "wv": Spec((d, d), ("embed", "heads")),
        "wg": Spec((d, d), ("embed", "heads")),
        "wo": Spec((d, d), ("heads", "embed")),
        "w0": Spec((d,), ("heads",), init="zeros"),
        "w_lora_a": Spec((d, r), ("embed", None), scale=0.01),
        "w_lora_b": Spec((r, d), (None, "heads"), scale=0.01),
        "u": Spec((d,), ("heads",), init="zeros"),
        "ln_x": Spec((d,), ("heads",), init="ones"),
    }
    cm = {
        "ln": norm_spec(d, cfg.norm),
        "mu_r": Spec((d,), ("embed",), init="zeros"),
        "mu_k": Spec((d,), ("embed",), init="zeros"),
        "wr": Spec((d, d), ("embed", "heads")),
        "wk": Spec((d, ff), ("embed", "mlp")),
        "wv": Spec((ff, d), ("mlp", "embed")),
    }
    return {"tm": tm, "cm": cm}


def _lerp(x: torch.Tensor, x_prev: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (x_prev - x) * mu


def _shared(t: torch.Tensor, tp) -> torch.Tensor:
    """A replicated leaf used inside the tensor-parallel region: its
    gradient is summed over ``tp`` (``copy_to_model``); itself without tp."""
    return t if tp is None else copy_to_model(t, tp)


def _decay(p: dict, xw: torch.Tensor, tp=None) -> torch.Tensor:
    """Data-dependent per-channel decay in (0, 1): exp(-exp(w)), fp32."""
    w = p["w0"] + torch.tanh(xw @ _shared(p["w_lora_a"], tp)) @ p["w_lora_b"]
    return torch.exp(-torch.exp(w.float()))


def _wkv_chunked(r, k, v, w, u, state, chunk: int, policy: ComputePolicy | None = None):
    """Chunked wkv: r/k/w (B, T, H, K), v (B, T, H, V), u (H, K), state
    (B, H, K, V) -> (y (B, T, H, V) fp32, final state).  The plain chunk
    loop runs each chunk body under the policy's remat wrapper;
    ``policy.kernels`` takes the wkv kernel at the same chunk size."""
    pol = resolve_policy(policy)
    if pol.kernels:
        return kernel_ops.wkv_scan(r, k, v, w, u, state, chunk=chunk)
    return wkv_scan_ref(r, k, v, w, u, state, chunk=chunk, wrap=pol.checkpoint)


def _time_mix_core(r, k, v, w, u, state):
    """One step. r/k/w: (B, H, K); v: (B, H, V); u: (H, K); state: (B, H, K, V)."""
    return wkv_decode_ref(r, k, v, w, u, state)


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], H, x.shape[-1] // H)


def _local_heads(p: dict, cfg: ModelConfig) -> int:
    """The heads a time-mix's weights hold (all, or the rank's under tp)."""
    return p["u"].shape[-1] // rwkv_head_dim(cfg)


def time_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor, state: torch.Tensor,
             cfg: ModelConfig, policy: ComputePolicy | None = None, *,
             in_place: bool = False, active: torch.Tensor | None = None, tp=None):
    """x: (B, T, d); x_prev: (B, d) the token before x[:, 0]; state:
    (B, H, K, V) over the heads the weights hold (the rank's under ``tp``).
    Returns (x + the time-mix output, the last normed token (B, d), the new
    state (B, H, K, V) fp32, a fresh tensor).  With ``in_place`` (serving's
    decode tick, T = 1) the step writes the new state over ``state`` (fp32)
    in the rows of the slots that ``active`` ((B,) bool, or None: all) marks
    and returns ``state`` itself; autograd and prefill take the pure form."""
    pol = resolve_policy(policy)
    B, T, _ = x.shape
    H = _local_heads(p, cfg)
    d = H * rwkv_head_dim(cfg)
    h = layers.apply_norm(x, p["ln"], cfg.norm, cfg.rms_eps, use_kernel=pol.kernels)
    if tp is not None:
        h = copy_to_model(h, tp)
    hs = torch.cat([x_prev[:, None, :], h[:, :-1, :]], dim=1)        # shifted
    xr, xk, xv, xw, xg = (_lerp(h, hs, _shared(p[m], tp))
                          for m in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"))
    r = _heads(xr @ p["wr"], H).float()
    k = _heads(xk @ p["wk"], H).float()
    v = _heads(xv @ p["wv"], H).float()
    g = F.silu(xg @ p["wg"])
    w = _heads(_decay(p, xw, tp), H)                                   # (B, T, H, K) fp32
    u = _heads(p["u"].float(), H)                                      # (H, K)

    if in_place:
        if T != 1:
            raise ValueError(f"time_mix: the in-place step takes one token, got T={T}")
        step_ = kernel_ops.wkv_decode_step_ if pol.kernels else wkv_decode_ref_
        y = step_(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, state, active)
        y = y.reshape(B, 1, d).to(x.dtype)
    elif T >= 8:
        y, state = _wkv_chunked(r, k, v, w, u, state.float(), pick_chunk(T, WKV_CHUNK),
                                policy=pol)
        y = y.reshape(B, T, d).to(x.dtype)
    else:
        step = kernel_ops.wkv_decode_step if pol.kernels else _time_mix_core
        state = state.float()
        outs = []
        for t in range(T):
            out, state = step(r[:, t], k[:, t], v[:, t], w[:, t], u, state)
            outs.append(out)
        y = torch.stack(outs, dim=1).reshape(B, T, d).to(x.dtype)
    y = layers.rms_norm_split(y, p["ln_x"], cfg.rms_eps, tp) * g
    out = y @ p["wo"]
    if tp is not None:
        out = reduce_from_model(out, tp)
    return x + out, h[:, -1, :], state


def channel_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor, cfg: ModelConfig, tp=None):
    h = layers.apply_norm(x, p["ln"], cfg.norm, cfg.rms_eps)
    if tp is not None:
        h = copy_to_model(h, tp)
    hs = torch.cat([x_prev[:, None, :], h[:, :-1, :]], dim=1)
    r = torch.sigmoid(_lerp(h, hs, _shared(p["mu_r"], tp)) @ p["wr"])
    k = torch.square(torch.relu(_lerp(h, hs, _shared(p["mu_k"], tp)) @ p["wk"]))
    if tp is None:
        return x + r * (k @ p["wv"]), h[:, -1, :]
    kv = reduce_scatter_to_model(k @ p["wv"], -1, tp)        # the rank's d / tp columns
    return x + all_gather_from_model(r * kv, -1, tp), h[:, -1, :]


def _zero_carry(x: torch.Tensor, cfg: ModelConfig,
                heads: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The token before the sequence (zeros) and the zero wkv state of
    ``heads`` heads (all by default)."""
    B, _, d = x.shape
    hd = rwkv_head_dim(cfg)
    return (torch.zeros((B, d), dtype=x.dtype, device=x.device),
            torch.zeros((B, heads or n_rwkv_heads(cfg), hd, hd), dtype=torch.float32,
                        device=x.device))


def rwkv_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
               policy: ComputePolicy | None = None, tp=None) -> torch.Tensor:
    zeros_prev, state0 = _zero_carry(x, cfg, _local_heads(params["tm"], cfg))
    x, _, _ = time_mix(params["tm"], x, zeros_prev, state0, cfg, policy=policy, tp=tp)
    x, _ = channel_mix(params["cm"], x, zeros_prev, cfg, tp)
    return x


def segment_body(cfg: ModelConfig, policy: ComputePolicy | None = None, tp=None):
    """The layer body over one rwkv block's weights (the rank's heads under
    ``tp``): the wkv state is sequence-level and layer-local in training
    (each layer starts from zero at t = 0), so nothing is carried."""
    def body(lp: dict, x: torch.Tensor) -> torch.Tensor:
        return rwkv_block(lp, x, cfg, policy=policy, tp=tp)
    return body


def rwkv_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 policy: ComputePolicy | None = None):
    """Like rwkv_block, and also the decode cache {"x_tm", "x_cm": the last
    normed token of each mix (B, d); "state": (B, H, K, V) fp32}."""
    zeros_prev, state0 = _zero_carry(x, cfg)
    x, tm_prev, state = time_mix(params["tm"], x, zeros_prev, state0, cfg, policy=policy)
    x, cm_prev = channel_mix(params["cm"], x, zeros_prev, cfg)
    return x, {"x_tm": tm_prev, "x_cm": cm_prev, "state": state}


def rwkv_decode(params: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig,
                policy: ComputePolicy | None = None, active: torch.Tensor | None = None):
    """x: (B, 1, d), cache {"x_tm", "x_cm", "state"} -> (out, the new cache
    leaves).  The state leaf is updated in place, in the rows of the slots
    that ``active`` ((B,) bool, or None: all) marks, and returned as the
    same tensor; the last tokens come back fresh (the caller merges them).
    ``policy.kernels`` runs the time-mix core step as one fused kernel."""
    xo, tm_prev, state = time_mix(params["tm"], x, cache["x_tm"], cache["state"], cfg,
                                  policy=policy, in_place=True, active=active)
    xo, cm_prev = channel_mix(params["cm"], xo, cache["x_cm"], cfg)
    return xo, {"x_tm": tm_prev, "x_cm": cm_prev, "state": state}


def rwkv_cache_specs(cfg: ModelConfig, batch: int, dtype=None) -> dict:
    d = cfg.d_model
    H = n_rwkv_heads(cfg)
    hd = rwkv_head_dim(cfg)
    return {
        "x_tm": Spec((batch, d), ("cache_batch", "embed"), init="zeros", dtype=dtype),
        "x_cm": Spec((batch, d), ("cache_batch", "embed"), init="zeros", dtype=dtype),
        "state": Spec((batch, H, hd, hd), ("cache_batch", "ssm_heads", None, None),
                      init="zeros", dtype=torch.float32),
    }
