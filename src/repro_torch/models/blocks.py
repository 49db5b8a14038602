"""Transformer blocks of ``repro/models/blocks.py``: self-attention (GQA,
RoPE, optional qk-norm and softcap) for training and prefill, for per-slot
cached decode and for decode over a paged KV pool, cross-attention over an
encoder's memory (the encdec decoder), the MLP block, and
``segment_body``, the layer body of the training stacks.
Under ``policy.kernels`` every RMSNorm or LayerNorm and every SwiGLU gate or
GELU input half runs in its CUDA kernel, in training, prefill and decode,
and full-sequence attention runs in the flash kernels (forward and
backward); decode attention over the cache stays plain PyTorch, as does
the int8 KV cache's quantizer (``layers.kv_quantize``; the reference's is
jnp, with no Pallas body).

``tp`` (a model-group process group, training only) runs a block on the
rank's Megatron shards: column-parallel ``wq``/``wk``/``wv`` and ``w1``/``w3``
(the rank's heads and d_ff columns; their input through
``collectives.copy_to_model``), row-parallel ``wo`` and ``w2`` (their
partial sums all-reduced by ``collectives.reduce_from_model``).  Where tp
exceeds the kv heads (:func:`kv_heads_replicated`) every model rank
holds ``wk``/``wv`` whole and projects the one kv head its query heads
share, the weights through ``copy_to_model``.  Norms,
RoPE and qk-norm stay replicated; the qk-norm scales pass through
``copy_to_model`` as well, since each rank's heads give part of their
gradient, and so does a cross block's memory on its way into ``wk``/``wv``.
A block without ``tp`` runs whole on every model rank.

``sp`` (the model group, where the plan puts the sequence on the model
axis) runs the block on the rank's shard of the sequence, positions
[r S/tp, (r + 1) S/tp), as Megatron's sequence parallelism does: the norm
and the residual add on the shard; a Megatron-split block gathers the
sequence in front of its column-parallel products
(``collectives.all_gather_to_model``, whose backward reduce-scatters) and
reduce-scatters the row-parallel partial sums back onto the shard
(``reduce_scatter_to_model``) in place of the all-reduce; a whole MLP runs
on the shard as it is; a whole attention takes the shard's queries, RoPE'd
at their absolute positions, against K and V gathered over the sequence
(``q_offset`` r S/tp; the backward reduce-scatters dK and dV).  Under
``sp`` no weight passes ``copy_to_model``: every leaf that is whole over
the model group takes a partial gradient, which the train step sums over
the group (``runtime/train_loop.py``).  :class:`Parallel` carries a
stack's blocks' groups and ``sp`` to its layer bodies.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.compute import ComputePolicy, resolve as resolve_policy
from repro_torch.models import layers
from repro_torch.models.common import ModelConfig, Spec
from repro_torch.runtime.collectives import (
    all_gather_to_model, copy_to_model, reduce_from_model, reduce_scatter_to_model,
)


@dataclasses.dataclass(frozen=True)
class Parallel:
    """How a layer stack's blocks run over the model group: ``split``
    {block: the model group} of its Megatron-split blocks, by the block's
    path under the stack ("attn", "mlp", "cross", "dense.attn",
    "dense.mlp", "moe" for the experts' d_ff, "moe.shared", "moe.dense");
    a block it does not name runs whole.  ``experts`` is the model group
    where the moe experts themselves are on the model axis (E/tp whole
    experts a rank, ``models/moe.py:moe_block``), ``seq`` the model group
    where the sequence is (the module docstring's ``sp``)."""
    split: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    experts: Any = None
    seq: Any = None

    def tp(self, block: str):
        """The group of ``block`` if it is Megatron-split, else None."""
        return self.split.get(block)


def enter(h: torch.Tensor, tp, sp) -> torch.Tensor:
    """A split block's input to its column-parallel products: ``h`` itself
    through ``copy_to_model``, or under ``sp`` the sequence gathered; a
    whole block's (``tp`` None) as it is."""
    if tp is None:
        return h
    return copy_to_model(h, tp) if sp is None else all_gather_to_model(h, 1, tp)


def leave(out: torch.Tensor, tp, sp) -> torch.Tensor:
    """A split block's row-parallel partial sums all-reduced, or under
    ``sp`` reduce-scattered onto the rank's shard of the sequence."""
    if tp is None:
        return out
    return reduce_from_model(out, tp) if sp is None else reduce_scatter_to_model(out, 1, tp)


def weight(w: torch.Tensor, tp, sp) -> torch.Tensor:
    """A whole weight that a split block's ranks each use in part: through
    ``copy_to_model`` (its gradient summed over the group here), or under
    ``sp`` as it is (the train step sums every whole leaf's gradient)."""
    return w if tp is None or sp is not None else copy_to_model(w, tp)


def seq_offset(sp, s: int) -> int:
    """The absolute position of the rank's first token under ``sp``
    (shards of ``s`` positions), 0 without it."""
    return 0 if sp is None else dist.get_rank(sp) * s


def norm_spec(d: int, kind: str, axis: str = "embed") -> dict:
    spec = {"scale": Spec((d,), (axis,), init="ones")}
    if kind == "layernorm":
        spec["bias"] = Spec((d,), (axis,), init="zeros")
    return spec


def attn_specs(cfg: ModelConfig, *, cross: bool = False) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    spec = {
        "ln": norm_spec(d, cfg.norm),
        "wq": Spec((d, hq * hd), ("embed", "heads")),
        "wk": Spec((d, hkv * hd), ("embed", "kv_heads")),
        "wv": Spec((d, hkv * hd), ("embed", "kv_heads")),
        "wo": Spec((hq * hd, d), ("heads", "embed")),
    }
    if cfg.qk_norm and not cross:
        spec["q_norm"] = Spec((hd,), ("head_dim",), init="ones")
        spec["k_norm"] = Spec((hd,), ("head_dim",), init="ones")
    return spec


def kv_heads_replicated(cfg: ModelConfig, tp: int) -> bool:
    """Whether ``wk``/``wv`` stay whole over a model group of ``tp`` ranks:
    tp above the kv head count and a multiple of it, the query heads
    splitting over tp.  Each model rank then projects the one kv head its
    query heads share, as Megatron replicates kv heads
    (``models/model.py:kv_replicated`` names the leaves)."""
    kv = cfg.n_kv_heads
    return tp > kv and tp % kv == 0 and cfg.n_heads % tp == 0


def _project_qkv(params: dict, xq: torch.Tensor, xkv: torch.Tensor,
                 cfg: ModelConfig, use_kernel: bool = False, tp=None, sp=None):
    """q, k, v over the heads the weights hold (all, or the rank's under tp)."""
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    hd = cfg.resolved_head_dim
    wk, wv = params["wk"], params["wv"]
    if tp is not None and kv_heads_replicated(cfg, dist.get_world_size(tp)):
        # the one kv head the rank's query heads share; each rank's part of
        # its gradient summed over the group
        j = dist.get_rank(tp) * cfg.n_kv_heads // dist.get_world_size(tp)
        wk = weight(wk, tp, sp)[:, j * hd:(j + 1) * hd]
        wv = weight(wv, tp, sp)[:, j * hd:(j + 1) * hd]
    q = (xq @ params["wq"]).reshape(B, Sq, -1, hd)
    k = (xkv @ wk).reshape(B, Skv, -1, hd)
    v = (xkv @ wv).reshape(B, Skv, -1, hd)
    if "q_norm" in params:
        qs, ks = params["q_norm"], params["k_norm"]
        qs, ks = weight(qs, tp, sp), weight(ks, tp, sp)
        q = layers.apply_norm(q, {"scale": qs}, "rmsnorm", cfg.rms_eps, use_kernel)
        k = layers.apply_norm(k, {"scale": ks}, "rmsnorm", cfg.rms_eps, use_kernel)
    return q, k, v


def self_attn_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor | None = None, causal: bool = True,
                    return_kv: bool = False,
                    policy: ComputePolicy | None = None, tp=None, sp=None):
    """Full-sequence (prefill) self attention with residual; with
    ``return_kv`` also the RoPE'd K and V that prefill places in the cache.
    ``tp`` and ``sp`` as the module docstring says."""
    pol = resolve_policy(policy)
    h = layers.apply_norm(x, params["ln"], cfg.norm, cfg.rms_eps,
                          use_kernel=pol.kernels)
    whole_sp = tp is None and sp is not None
    h = enter(h, tp, sp)
    q, k, v = _project_qkv(params, h, h, cfg, pol.kernels, tp, sp)
    # under sp a whole block's queries are the shard's, at its positions
    off = seq_offset(sp, x.shape[1]) if whole_sp else 0
    if cfg.pos == "rope":
        pos = positions if positions is not None else torch.arange(
            off, off + q.shape[1], device=x.device)
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)
    if whole_sp:
        k, v = all_gather_to_model(k, 1, sp), all_gather_to_model(v, 1, sp)
    out = layers.attention(
        q, k, v, causal=causal, q_offset=off,
        sliding_window=cfg.sliding_window if causal else None,
        softcap=cfg.attn_logit_softcap, policy=pol)
    out = leave(out.reshape(*q.shape[:2], -1) @ params["wo"], tp, sp)
    out = x + out
    if return_kv:
        return out, k, v
    return out


def self_attn_decode(params: dict, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, cfg: ModelConfig,
                     policy: ComputePolicy | None = None,
                     active: torch.Tensor | None = None):
    """One-token cached attention; ``cache`` = {"k", "v"} of (B, C, Hkv, hd)
    (C may be a ring; an int8 cache adds the (B, C, Hkv) "k_scale" and
    "v_scale") is written in place.  ``pos`` is a scalar (lockstep batch) or
    a (B,) vector (a position per slot); the rows of slots that ``active``
    (B,) marks inactive are left as they were."""
    pol = resolve_policy(policy)
    h = layers.apply_norm(x, params["ln"], cfg.norm, cfg.rms_eps,
                          use_kernel=pol.kernels)
    q, k, v = _project_qkv(params, h, h, cfg, pol.kernels)
    batched = pos.ndim == 1
    if cfg.pos == "rope":
        p = pos[:, None] if batched else pos[None]
        q = layers.apply_rope(q, p, cfg.rope_theta)
        k = layers.apply_rope(k, p, cfg.rope_theta)
    clen = cache["k"].shape[1]
    slot = torch.remainder(pos, clen)
    if "k_scale" in cache:
        (kq, ks), (vq, vs) = layers.kv_quantize(k), layers.kv_quantize(v)
        ck, cv = layers.cache_update(cache["k"], cache["v"], kq, vq, slot, active)
        cks, cvs = layers.cache_update(cache["k_scale"], cache["v_scale"], ks, vs, slot,
                                       active)
        k_att = layers.kv_dequantize(ck, cks, q.dtype)
        v_att = layers.kv_dequantize(cv, cvs, q.dtype)
        new_cache = {"k": ck, "v": cv, "k_scale": cks, "v_scale": cvs}
    else:
        ck, cv = layers.cache_update(cache["k"], cache["v"], k, v, slot, active)
        k_att, v_att = ck.to(q.dtype), cv.to(q.dtype)
        new_cache = {"k": ck, "v": cv}
    # absolute position held by each ring slot (negative = not yet written)
    slots = torch.arange(clen, device=x.device)
    if batched:
        kv_positions = pos[:, None] - torch.remainder(pos[:, None] - slots[None, :], clen)
    else:
        kv_positions = pos - torch.remainder(pos - slots, clen)
    out = layers.attention(q, k_att, v_att, causal=True,
                           q_offset=pos, sliding_window=cfg.sliding_window,
                           softcap=cfg.attn_logit_softcap,
                           kv_positions=kv_positions)
    out = x + out.reshape(x.shape[0], 1, -1) @ params["wo"]
    return out, new_cache


def paged_attn_decode(params: dict, x: torch.Tensor, cache: dict,
                      block_table: torch.Tensor, pos: torch.Tensor,
                      cfg: ModelConfig, active: torch.Tensor | None = None,
                      policy: ComputePolicy | None = None):
    """One-token attention over a paged KV pool: ``cache`` = {"k", "v"} of
    (n_blocks, bs, Hkv, hd), ``block_table`` (B, max_blocks) maps a slot's
    logical block j (positions [j*bs, (j+1)*bs)) to a physical block.  The
    new token's KV is written into the pool in place before the gather, so
    position ``pos`` itself is attended; inactive slots write to block 0,
    the reserved garbage block.  An int8 pool's "k_scale" and "v_scale"
    blocks (n_blocks, bs, Hkv) take the new token's scales the same way."""
    pol = resolve_policy(policy)
    if cfg.sliding_window is not None:
        raise ValueError("paged KV pool serves full-attention caches; "
                         "SWA rings are fixed-size (whole-slot swap)")
    h = layers.apply_norm(x, params["ln"], cfg.norm, cfg.rms_eps,
                          use_kernel=pol.kernels)
    q, k, v = _project_qkv(params, h, h, cfg, pol.kernels)
    if cfg.pos == "rope":
        q = layers.apply_rope(q, pos[:, None], cfg.rope_theta)
        k = layers.apply_rope(k, pos[:, None], cfg.rope_theta)
    B = x.shape[0]
    ck, cv = cache["k"], cache["v"]
    bs = ck.shape[1]
    b = torch.arange(B, device=x.device)
    phys = block_table[b, torch.div(pos, bs, rounding_mode="floor")].long()
    if active is not None:
        phys = torch.where(active, phys, 0)
    off = torch.remainder(pos, bs).long()
    skv = block_table.shape[1] * bs
    bt = block_table.long()
    if "k_scale" in cache:
        (kq, ks), (vq, vs) = layers.kv_quantize(k), layers.kv_quantize(v)
        cks, cvs = cache["k_scale"], cache["v_scale"]
        ck[phys, off], cv[phys, off] = kq[:, 0], vq[:, 0]
        cks[phys, off], cvs[phys, off] = ks[:, 0], vs[:, 0]
        new_cache = {"k": ck, "v": cv, "k_scale": cks, "v_scale": cvs}
        gk = layers.kv_dequantize(ck[bt], cks[bt], q.dtype)
        gv = layers.kv_dequantize(cv[bt], cvs[bt], q.dtype)
    else:
        ck[phys, off] = k[:, 0].to(ck.dtype)
        cv[phys, off] = v[:, 0].to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        gk, gv = ck[bt].to(q.dtype), cv[bt].to(q.dtype)
    gk = gk.reshape(B, skv, *ck.shape[2:])
    gv = gv.reshape(B, skv, *cv.shape[2:])
    out = layers.attention(q, gk, gv, causal=True, q_offset=pos,
                           softcap=cfg.attn_logit_softcap,
                           kv_positions=torch.arange(skv, device=x.device))
    out = x + out.reshape(B, 1, -1) @ params["wo"]
    return out, new_cache


def cross_attn_block(params: dict, x: torch.Tensor, memory: torch.Tensor,
                     cfg: ModelConfig, policy: ComputePolicy | None = None,
                     tp=None) -> torch.Tensor:
    """Cross attention with residual (``repro/models/blocks.py:
    cross_attn_block``): queries from ``x`` (B, S, d), keys and values from
    the encoder's ``memory`` (B, T, d), non-causal, no RoPE."""
    pol = resolve_policy(policy)
    h = layers.apply_norm(x, params["ln"], cfg.norm, cfg.rms_eps,
                          use_kernel=pol.kernels)
    q, k, v = _project_qkv(params, enter(h, tp, None), enter(memory, tp, None), cfg,
                           pol.kernels, tp)
    out = layers.attention(q, k, v, causal=False, policy=pol)
    B, S = x.shape[:2]
    return x + leave(out.reshape(B, S, -1) @ params["wo"], tp, None)


def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    spec = {
        "ln": norm_spec(d, cfg.norm),
        "w1": Spec((d, ff), ("embed", "mlp")),
        "w2": Spec((ff, d), ("mlp", "embed")),
    }
    if cfg.act == "swiglu":
        spec["w3"] = Spec((d, ff), ("embed", "mlp"))
    return spec


def mlp_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
              policy: ComputePolicy | None = None, tp=None, sp=None) -> torch.Tensor:
    """The MLP with residual: whole (on the shard under ``sp``) or on the
    rank's d_ff columns under ``tp``."""
    pol = resolve_policy(policy)
    h = layers.apply_norm(x, params["ln"], cfg.norm, cfg.rms_eps,
                          use_kernel=pol.kernels)
    out = layers.mlp(enter(h, tp, sp), params, cfg.act, use_kernel=pol.kernels)
    return x + leave(out, tp, sp)


def segment_body(cfg: ModelConfig, policy: ComputePolicy | None, *, causal: bool = True,
                 cross: bool = False, par: Parallel | None = None):
    """The layer body of a training stack (``repro/models/blocks.py:
    segment_body``): attention block then MLP block, on one layer's slice of
    the stacked weights (each block on its Megatron shards where ``par``
    splits it, and on the rank's sequence shard under ``par.seq``).  The
    encdec encoder takes ``causal=False``; its decoder takes ``cross=True``
    and a cross-attention block over ``memory`` between the two, which the
    body then takes as a third argument (the program's ``memory`` carry)."""
    par = par or Parallel()

    def body(lp: dict, x: torch.Tensor, memory: torch.Tensor | None = None) -> torch.Tensor:
        x = self_attn_block(lp["attn"], x, cfg, causal=causal, policy=policy,
                            tp=par.tp("attn"), sp=par.seq)
        if cross:
            x = cross_attn_block(lp["cross"], x, memory, cfg, policy=policy,
                                 tp=par.tp("cross"))
        return mlp_block(lp["mlp"], x, cfg, policy=policy, tp=par.tp("mlp"), sp=par.seq)
    return body
