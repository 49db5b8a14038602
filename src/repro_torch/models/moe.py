"""Mixture-of-Experts FFN with grouped, capacity-bounded dispatch: the
single-device part of ``repro/models/moe.py``.

Tokens are grouped per sequence (sequences longer than 8192 tokens split
into chunks of at most 4096), and each group routes its tokens to the top-k
of ``n_experts`` experts, each of which holds C slots per group
(``core/expertplan.py:capacity``).  Dispatch and combine are gathers through
a slot -> token index map, so their cost follows the tokens, not
tokens x experts x slots.

``policy.kernels`` runs the expert MLPs in the grouped CUDA kernel
(``kernels/grouped_mlp.py``; its plain version on CPU tensors) over the
expert-major (E, G*C, d) layout with the slot mask applied inside;
otherwise the einsums in the compute dtype.

Supports top-1 routing with a shared expert (llama4-maverick), top-2
routing with a parallel dense residual MLP (arctic), the switch-style
load-balance auxiliary loss and the measured dropped-assignment fraction.
Expert parallelism (``ExpertDispatch``, the ``ep`` plan axis) waits for the
parallel executor (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import expertplan as epl
from repro_torch.core.compute import ComputePolicy, resolve as resolve_policy
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers
from repro_torch.models.blocks import mlp_specs, norm_spec
from repro_torch.models.common import ModelConfig, Spec


def moe_specs(cfg: ModelConfig) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    spec: dict[str, Any] = {
        "ln": norm_spec(d, cfg.norm),
        "router": Spec((d, E), ("embed", None), scale=0.02),
        "w1": Spec((E, d, ff), ("experts", "embed", "expert_mlp")),
        "w2": Spec((E, ff, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.act == "swiglu":
        spec["w3"] = Spec((E, d, ff), ("experts", "embed", "expert_mlp"))
    # the sub-MLPs keep the reference's unused "ln" leaves: moe_block applies
    # them to the MoE norm's output, and the weight carry-over is strict
    if cfg.shared_expert:
        spec["shared"] = mlp_specs(cfg, d_ff=cfg.dense_d_ff or ff)
    if cfg.moe_dense_residual:
        spec["dense"] = mlp_specs(cfg, d_ff=cfg.dense_d_ff or ff)
    return spec


def group_shape(batch: int, seq: int, target: int = 4096) -> tuple[int, int]:
    """(n_groups, group_size) for a (batch, seq) token grid: one routing group
    per sequence; sequences longer than 2*target split into the largest
    chunk <= target that divides them.  Grouping is a reshape of (B, S)."""
    g = seq
    if g > 2 * target:
        g = target
        while seq % g != 0:
            g -= 1
    return batch * (seq // g), g


def moe_capacity(group_size: int, cfg: ModelConfig) -> int:
    return epl.capacity(group_size, cfg.top_k, cfg.n_experts, cfg.capacity_factor)


def _route(gates: torch.Tensor, top_k: int, capacity: int):
    """gates: (G, g, E) fp32 softmax probabilities.

    Returns per k the (expert, slot, keep, weight) of each token, each
    (G, g); the slot -> token map (G, E*C) with its validity mask; and the
    aux loss.  All k = 0 assignments take capacity before any k = 1
    assignment (``counts`` carries across k), in token order within a k.
    ``torch.topk`` and ``jax.lax.top_k`` may order tied gates differently;
    fp32 softmax gates of real activations do not tie."""
    G, g, E = gates.shape
    C = capacity
    topk_vals, topk_idx = torch.topk(gates, top_k, dim=-1)          # (G, g, K)
    topk_vals = topk_vals / topk_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    counts = torch.zeros((G, E), dtype=torch.long, device=gates.device)
    assignments = []
    for k in range(top_k):
        e_k = topk_idx[:, :, k]                                     # (G, g)
        onehot = F.one_hot(e_k, E)                                  # (G, g, E)
        pos = onehot.cumsum(1) - 1 + counts[:, None, :]
        p_k = pos.gather(-1, e_k[..., None])[..., 0]
        assignments.append((e_k, p_k, p_k < C, topk_vals[:, :, k]))
        counts = counts + onehot.sum(1)

    # slot -> token map; dropped assignments land in the extra bucket at E*C
    EC = E * C
    slot_to_token = torch.zeros((G, EC + 1), dtype=torch.long, device=gates.device)
    slot_valid = torch.zeros((G, EC + 1), dtype=torch.bool, device=gates.device)
    rows = torch.arange(G, device=gates.device)[:, None]
    token_ids = torch.arange(g, device=gates.device).expand(G, g)
    for e_k, p_k, keep, _ in assignments:
        s = torch.where(keep, e_k * C + p_k, EC)
        slot_to_token[rows, s] = token_ids
        slot_valid[rows, s] = True

    # switch load-balance loss: E * sum_e f_e p_e, the mean over groups
    top1 = F.one_hot(topk_idx[:, :, 0], E).float()
    aux = E * (top1.mean(1) * gates.mean(1)).sum(-1).mean()
    return assignments, slot_to_token[:, :EC], slot_valid[:, :EC], aux


def _expert_mlps(params: dict, expert_in: torch.Tensor, slot_valid: torch.Tensor,
                 cfg: ModelConfig, pol: ComputePolicy) -> torch.Tensor:
    """(G, E, C, d) expert slots -> (G, E, C, d) expert outputs."""
    G, E, C, d = expert_in.shape
    if pol.kernels:
        xs = expert_in.transpose(0, 1).reshape(E, G * C, d)
        ms = (slot_valid.reshape(G, E, C).transpose(0, 1).reshape(E, G * C)
              .to(xs.dtype))
        out = kernel_ops.grouped_mlp(xs, params["w1"], params.get("w3"),
                                     params["w2"], ms, act=cfg.act)
        return out.reshape(E, G, C, d).transpose(0, 1)
    a = torch.einsum("gecd,edf->gecf", expert_in, params["w1"])
    if cfg.act == "swiglu":
        hmid = F.silu(a) * torch.einsum("gecd,edf->gecf", expert_in, params["w3"])
    else:
        hmid = F.gelu(a, approximate="tanh")
    return torch.einsum("gecf,efd->gecd", hmid, params["w2"])


def moe_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
              policy: ComputePolicy | None = None, ep: Any = None,
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (x + MoE(x), aux_loss, drop_fraction), the last two
    fp32 scalars; ``drop_fraction`` is the share of routed (token, k)
    assignments dropped at the capacity limit."""
    if ep is not None:
        raise NotImplementedError("expert parallelism (ep) is not ported yet "
                                  "(see ROADMAP.md, Queue 1)")
    pol = resolve_policy(policy)
    B, S, d = x.shape
    h = layers.apply_norm(x, params["ln"], cfg.norm, cfg.rms_eps,
                          use_kernel=pol.kernels)
    G, g = group_shape(B, S)
    C = moe_capacity(g, cfg)
    E = cfg.n_experts
    xg = h.reshape(G, g, d)

    gates = torch.softmax((xg @ params["router"]).float(), dim=-1)   # (G, g, E)
    assignments, slot_to_token, slot_valid, aux = _route(gates, cfg.top_k, C)
    drop = 1.0 - slot_valid.sum().float() / float(G * g * max(cfg.top_k, 1))

    # dispatch: gather token activations into (G, E*C, d) expert slots
    expert_in = torch.gather(xg, 1, slot_to_token[..., None].expand(G, E * C, d))
    expert_in = torch.where(slot_valid[..., None], expert_in, 0).reshape(G, E, C, d)
    expert_out = _expert_mlps(params, expert_in, slot_valid, cfg, pol)
    expert_out = expert_out.reshape(G, E * C, d)

    # combine: each token's expert outputs, weighted, in x's dtype, k in order
    out = torch.zeros((G, g, d), dtype=x.dtype, device=x.device)
    for e_k, p_k, keep, w_k in assignments:
        s = torch.where(keep, e_k * C + p_k, 0)     # dropped: weight 0
        vals = torch.gather(expert_out, 1, s[..., None].expand(G, g, d))
        out = out + vals * (w_k * keep).to(x.dtype)[..., None]

    out = out.reshape(B, S, d)
    if cfg.shared_expert:
        out = out + layers.mlp(h, params["shared"], cfg.act, use_kernel=pol.kernels)
    if cfg.moe_dense_residual:
        out = out + layers.mlp(h, params["dense"], cfg.act, use_kernel=pol.kernels)
    return x + out, aux.float(), drop
