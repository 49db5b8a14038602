"""Top-level Model, the dense subset of ``repro/models/model.py``, as an
``nn.Module`` that holds its weights.

  * ``param_specs()``  — declarative tree (shapes/axes/init); its dotted
    paths (``layers.attn.wq``, ``layers.mlp.w1``, …) are the state_dict keys,
    so weights carry over from the JAX pytree 1:1 (``repro_torch.interop``)
  * ``init(generator)`` — draw the weights from an explicit generator
  * ``prefill(batch, cache_len, lens=)`` — full-sequence forward + KV cache
  * ``decode_step(cache, batch)`` — one serving step, per-slot ``pos``,
    ``active`` and a paged ``block_table``
  * ``cache_specs`` / ``paged_cache_specs`` / ``init_cache``

Weights keep the JAX layout (``x @ W`` with W (d_in, d_out), per-layer
leaves stacked on a leading ``L`` dim) and are stored in the compute dtype.
Caches are dicts of tensors that decode updates in place (the JAX package
returns new arrays; in place saves a copy of the KV cache per step).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.core.compute import ComputePolicy, resolve as resolve_policy
from repro_torch.models import blocks, layers
from repro_torch.models.common import (
    ModelConfig, Spec, flatten_specs, init_leaf, init_params, param_count,
    spec_tree_map,
)


def stack_specs(tree: Any, n: int) -> Any:
    return spec_tree_map(
        lambda s: dataclasses.replace(s, shape=(n,) + s.shape, axes=("layers",) + s.axes),
        tree)


def check_supported(cfg: ModelConfig, policy: ComputePolicy) -> None:
    """The slice of the JAX package this port covers; the rest raises."""
    where = "is not ported yet (see ROADMAP.md, Queue 1)"
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} {where}")
    if cfg.sliding_window is not None:
        raise NotImplementedError(f"sliding-window ring caches {where}")
    if cfg.kv_quant:
        raise NotImplementedError(f"the int8 KV cache {where}")
    if cfg.pos not in ("rope", "none"):
        raise NotImplementedError(f"pos={cfg.pos!r} {where}")
    if policy.kernels and (cfg.norm != "rmsnorm" or cfg.act != "swiglu"):
        raise NotImplementedError(
            f"kernels=True for norm={cfg.norm!r}, act={cfg.act!r}: the LayerNorm "
            "and GELU-MLP kernels are not ported yet (see ROADMAP.md, Queue 2)")


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter or cache tree (views)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


class _Tree(nn.Module):
    """A node of the parameter tree: its children are sub-trees and leaves."""


def _as_dict(module: nn.Module) -> dict:
    out: dict[str, Any] = dict(module._parameters)
    for name, child in module.named_children():
        out[name] = _as_dict(child)
    return out


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 compute: ComputePolicy | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.compute = resolve_policy(compute)
        check_supported(cfg, self.compute)
        self.device = resolve_device(device)
        for path, spec in flatten_specs(self.param_specs()):
            *parents, leaf = path.split(".")
            node: nn.Module = self
            for name in parents:
                if not hasattr(node, name):
                    node.add_module(name, _Tree())
                node = getattr(node, name)
            node.register_parameter(leaf, nn.Parameter(
                torch.empty(spec.shape, dtype=spec.dtype or dtype, device=self.device),
                requires_grad=False))

    # ------------------------------------------------------------------
    # Specs / init
    # ------------------------------------------------------------------
    def param_specs(self) -> dict:
        cfg = self.cfg
        d, V = cfg.d_model, cfg.padded_vocab
        specs: dict[str, Any] = {
            "embed": Spec((V, d), ("vocab", "embed"), scale=0.02),
            "final_norm": blocks.norm_spec(d, cfg.norm),
            "layers": stack_specs({"attn": blocks.attn_specs(cfg),
                                   "mlp": blocks.mlp_specs(cfg)}, cfg.n_layers),
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = Spec((d, V), ("embed", "vocab"), scale=0.02)
        return specs

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None) -> "Model":
        """Draw every weight with the JAX package's init rules, leaf by leaf
        in state_dict order, from ``generator`` (on the model's device)."""
        params = dict(self.named_parameters())
        for path, spec in flatten_specs(self.param_specs()):
            params[path].copy_(init_leaf(spec, generator, self.device, self.dtype))
        return self

    def n_params(self) -> int:
        return param_count(self.param_specs())

    def params(self) -> dict:
        """The weights as a nested dict shaped like the JAX pytree."""
        return _as_dict(self)

    def _unembed_matrix(self, params: dict) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def _logits(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        """Final norm + unembedding of (B, d) rows -> (B, vocab) fp32."""
        cfg = self.cfg
        h = layers.apply_norm(h, params["final_norm"], cfg.norm, cfg.rms_eps,
                              use_kernel=self.compute.kernels)
        return (h @ self._unembed_matrix(params)).float()[..., :cfg.vocab_size]

    # ------------------------------------------------------------------
    # Caches
    # ------------------------------------------------------------------
    @property
    def paged_cacheable(self) -> bool:
        return self.cfg.family == "dense" and self.cfg.sliding_window is None

    def _kv_specs(self, lead: tuple[int, ...], axes: tuple[str, ...]) -> dict:
        cfg = self.cfg
        shape = (cfg.n_layers, *lead, cfg.n_kv_heads, cfg.resolved_head_dim)
        full_axes = ("layers", *axes, "cache_heads", "head_dim")
        return {"k": Spec(shape, full_axes, init="zeros"),
                "v": Spec(shape, full_axes, init="zeros")}

    def cache_specs(self, batch: int, cache_len: int) -> dict:
        return {"pos": Spec((), (), init="zeros", dtype=torch.int32),
                "layers": self._kv_specs((batch, cache_len),
                                         ("cache_batch", "cache_seq"))}

    def paged_cache_specs(self, n_slots: int, n_blocks: int, block_size: int) -> dict:
        """The KV pool of the serve engine: ``n_blocks`` physical blocks of
        ``block_size`` positions shared by the slots through a block table;
        ``pos`` is a per-slot vector."""
        return {"pos": Spec((n_slots,), ("cache_batch",), init="zeros",
                            dtype=torch.int32),
                "layers": self._kv_specs((n_blocks, block_size),
                                         ("cache_blocks", "cache_seq"))}

    def init_cache(self, batch: int, cache_len: int) -> dict:
        return init_params(self.cache_specs(batch, cache_len), None,
                           self.device, self.dtype)

    # ------------------------------------------------------------------
    # Prefill
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, batch: dict, cache_len: int,
                lens: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
        """Returns (last-token logits (B, V) fp32, cache at pos=S).

        ``lens`` (B,) — true lengths of right-padded prompts: logits are
        read at ``lens - 1``, the cache holds only real positions, and
        ``cache["pos"]`` becomes the per-slot vector ``lens``."""
        cfg = self.cfg
        params = self.params()
        x = params["embed"][batch["tokens"].long()]
        B, S = x.shape[:2]
        if lens is None:
            total = None
            cache: dict[str, Any] = {"pos": torch.tensor(S, dtype=torch.int32,
                                                         device=self.device)}
        else:
            total = lens.to(device=self.device, dtype=torch.int32)
            cache = {"pos": total}
        kv = init_params(self._kv_specs((B, cache_len), ("cache_batch", "cache_seq")),
                         None, self.device, self.dtype)
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            x, k, v = blocks.self_attn_block(lp["attn"], x, cfg, causal=True,
                                             return_kv=True, policy=self.compute)
            x = blocks.mlp_block(lp["mlp"], x, cfg, policy=self.compute)
            kv["k"][i] = _ring_place(k, cache_len, total)
            kv["v"][i] = _ring_place(v, cache_len, total)
        cache["layers"] = kv
        last = x[:, -1] if total is None else x[torch.arange(B, device=x.device),
                                               total.long() - 1]
        return self._logits(params, last), cache

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, cache: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """One serving step: batch = {"token": (B, 1)}, optionally "active"
        (B,) bool (inactive slots do not advance ``pos``; their paged writes
        go to block 0) and "block_table" (B, max_blocks) for the paged pool
        of :meth:`paged_cache_specs`.  ``cache["pos"]`` is a scalar or a (B,)
        vector.  The KV leaves are updated in place; returns (logits (B, V)
        fp32, cache with the advanced ``pos``)."""
        cfg = self.cfg
        params = self.params()
        pos = cache["pos"]
        active = batch.get("active")
        bt = batch.get("block_table")
        if active is not None and bt is None:
            raise NotImplementedError(
                "slot-swap caches (active without a block table) are not "
                "ported yet (see ROADMAP.md)")
        x = params["embed"][batch["token"].long()]
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            kvc = _layer(cache["layers"], i)
            if bt is not None:
                x, _ = blocks.paged_attn_decode(lp["attn"], x, kvc, bt, pos, cfg,
                                                active=active, policy=self.compute)
            else:
                x, _ = blocks.self_attn_decode(lp["attn"], x, kvc, pos, cfg,
                                               policy=self.compute)
            x = blocks.mlp_block(lp["mlp"], x, cfg, policy=self.compute)
        step = 1 if active is None else active.to(pos.dtype)
        new_cache = {"pos": pos + step, "layers": cache["layers"]}
        return self._logits(params, x[:, 0]), new_cache


def _ring_place(x: torch.Tensor, clen: int,
                lens: torch.Tensor | None = None) -> torch.Tensor:
    """Place full-sequence entries (B, S, ...) into a length-``clen`` cache,
    slot(t) = t % clen (``repro/models/model.py:_ring_place``).  With
    per-request ``lens``, slot s holds timeline position
    t(s) = (lens-1) - ((lens-1-s) mod clen), zero where t < 0."""
    B, S = x.shape[:2]
    if lens is None:
        if S == clen:
            return x
        out = x.new_zeros((B, clen, *x.shape[2:]))
        if S < clen:
            out[:, :S] = x
        else:
            out[:, np.arange(S - clen, S) % clen] = x[:, S - clen:]
        return out
    last = lens.long()[:, None] - 1                              # (B, 1)
    slots = torch.arange(clen, device=x.device)[None, :]         # (1, clen)
    t = last - torch.remainder(last - slots, clen)               # (B, clen)
    gathered = x[torch.arange(B, device=x.device)[:, None], t.clamp(0, S - 1)]
    keep = (t >= 0).reshape(B, clen, *([1] * (x.ndim - 2)))
    return torch.where(keep, gathered, torch.zeros((), dtype=x.dtype, device=x.device))
