"""Mixture-of-Experts FFN with grouped, capacity-bounded dispatch (the port
of ``repro/models/moe.py``).

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

Expert parallelism (the ``ep`` plan axis, :class:`ExpertDispatch`): a rank
holds E/ep experts and routes its own groups; dispatch is the token
all-to-all over the expert group that moves the (G, E, C, d) slots from
group-major (every expert, the rank's groups) to expert-major (the rank's
experts, the groups of every rank of the group), and combine the inverse
one (``runtime/collectives.py:all_to_all_dim``; each one's backward is the
other).  Under tensor parallelism (``tp``, the model group) the expert
MLPs run on the rank's d_ff columns (w1, w3) and rows (w2), as do the
shared expert and the dense residual where their own blocks are split
(``shared_tp``, ``dense_tp``): their input passes ``copy_to_model``, and
the sum of the partial outputs, after the combine, one
``reduce_from_model``; a whole shared expert or dense residual adds its
output after that.  With the experts themselves on the model axis
(``experts``, the reference's ``ep_model`` override) a model rank holds
E/tp whole experts, consecutive ones as :class:`ExpertDispatch`'s expert
ranks do, routes the tokens (the same on every model rank) with the whole
router, and runs only its own experts' slots: its combine is a partial sum
as under ``tp``.  The combine weights pass ``copy_to_model`` too: their
gradient is a product with the partial expert outputs, so each rank holds
a part of it.  The router, its gates, the aux loss and the drop fraction
are computed alike on every model rank.  Under sequence parallelism
(``sp``) the block takes the rank's shard of the sequence and gathers it
(``collectives.all_gather_to_model``) before routing, so that the groups,
C, the drops and the aux loss are the single device's; the partial sums
are reduce-scattered back onto the shard, a whole shared expert or dense
residual runs on the shard itself, and no tensor passes
``copy_to_model``: the gather's backward sums the ranks' parts.
:func:`segment_body` is the StageProgram body of one MoE stack unit.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import expertplan as epl
from repro_torch.core.compute import ComputePolicy, resolve as resolve_policy
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers
from repro_torch.models.blocks import enter, leave, mlp_specs, norm_spec, seq_offset
from repro_torch.models.common import ModelConfig, Spec
from repro_torch.runtime.collectives import all_gather_to_model, all_to_all_dim, copy_to_model


@dataclasses.dataclass(frozen=True)
class ExpertDispatch:
    """The expert group of a rank (``models/model.py`` builds it at ep > 1):
    ``ep`` ranks, each holding E/ep consecutive experts, rank i of the
    group experts [i E/ep, (i + 1) E/ep).  The reference's
    ``group_axes`` (the batch axes a rank's routing groups are split over
    besides the expert axis: ("data",), or ("node", "data") on the
    hierarchical 5-D mesh) need no field here: the ranks that share them
    and differ in the expert axis alone exchange tokens, which is the
    expert group whichever they are."""
    group: Any
    ep: int

    def dispatch(self, t: torch.Tensor, kind: str = "all-to-all") -> torch.Tensor:
        """(G, E, C, ...) group-major -> (ep G, E/ep, C, ...) expert-major:
        the slots of the rank's experts from every rank of the group, the
        source rank slowest (the token all-to-all; ``kind`` names its byte
        count)."""
        return all_to_all_dim(t, 1, 0, self.group, kind)

    def combine(self, t: torch.Tensor) -> torch.Tensor:
        """(ep G, E/ep, C, ...) expert-major -> (G, E, C, ...) group-major
        (the inverse all-to-all)."""
        return all_to_all_dim(t, 0, 1, self.group)


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


def _expert_mlps(params: dict, expert_in: torch.Tensor, slot_valid: torch.Tensor | None,
                 cfg: ModelConfig, pol: ComputePolicy) -> torch.Tensor:
    """(G, E, C, d) expert slots -> (G, E, C, d) expert outputs; the
    grouped kernel takes the (G, E, C) slot mask."""
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
              policy: ComputePolicy | None = None, ep: ExpertDispatch | None = None,
              tp: Any = None, experts: Any = None, shared_tp: Any = None,
              dense_tp: Any = None, sp: Any = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (x + MoE(x), aux_loss, drop_fraction), the last two
    fp32 scalars over the rank's groups; ``drop_fraction`` is the share of
    routed (token, k) assignments dropped at the capacity limit.  ``ep``
    runs the expert MLPs on the rank's experts between the two all-to-alls,
    ``tp`` on the rank's d_ff shard, ``experts`` on the rank's E/tp whole
    experts, ``shared_tp``/``dense_tp`` the shared expert and the dense
    residual on their d_ff shards, ``sp`` on the rank's sequence shard
    (the module docstring)."""
    pol = resolve_policy(policy)
    h = layers.apply_norm(x, params["ln"], cfg.norm, cfg.rms_eps,
                          use_kernel=pol.kernels)
    # the routing's rows: the whole sequence, gathered under sp
    hr = h if sp is None else all_gather_to_model(h, 1, sp)
    B, S, d = hr.shape
    G, g = group_shape(B, S)
    C = moe_capacity(g, cfg)
    E = cfg.n_experts
    xg = hr.reshape(G, g, d)

    gates = torch.softmax((xg @ params["router"]).float(), dim=-1)   # (G, g, E)
    assignments, slot_to_token, slot_valid, aux = _route(gates, cfg.top_k, C)
    drop = 1.0 - slot_valid.sum().float() / float(G * g * max(cfg.top_k, 1))

    # the group the expert outputs are partial sums over, and the rank's
    # experts [lo, lo + n) (all of them but under ``experts``)
    grp = tp if experts is None else experts
    lo, n = 0, E
    if experts is not None:
        n = E // dist.get_world_size(experts)
        lo = dist.get_rank(experts) * n

    def part(t):            # a tensor each rank uses for its part of the work
        return t if grp is None or sp is not None else copy_to_model(t, grp)

    # dispatch: gather token activations into the (G, n*C, d) slots of the
    # rank's experts
    slots = slice(lo * C, (lo + n) * C)
    xe = part(xg)
    expert_in = torch.gather(xe, 1, slot_to_token[:, slots, None].expand(G, n * C, d))
    expert_in = torch.where(slot_valid[:, slots, None], expert_in, 0).reshape(G, n, C, d)
    valid = slot_valid[:, slots].reshape(G, n, C)
    if ep is not None:
        expert_in = ep.dispatch(expert_in)
        # the grouped kernel's slot mask follows its slots (the plain
        # products need none: an empty slot's row is zero)
        valid = (ep.dispatch(valid.to(torch.uint8), "all-to-all-mask").bool()
                 if pol.kernels else None)
    expert_out = _expert_mlps(params, expert_in, valid, cfg, pol)
    if ep is not None:
        expert_out = ep.combine(expert_out)
    expert_out = expert_out.reshape(G, n * C, d)

    # combine: each token's expert outputs, weighted, in x's dtype, k in order
    out = torch.zeros((G, g, d), dtype=x.dtype, device=x.device)
    for e_k, p_k, keep, w_k in assignments:
        wk = part((w_k * keep).to(x.dtype))
        if experts is not None:     # another rank's expert: weight 0 here
            mine = (e_k >= lo) & (e_k < lo + n)
            keep, wk = keep & mine, wk * mine
        s = torch.where(keep, (e_k - lo) * C + p_k, 0)     # dropped: weight 0
        vals = torch.gather(expert_out, 1, s[..., None].expand(G, g, d))
        out = out + vals * wk[..., None]
    out = out.reshape(B, S, d)

    # the partial sums over the model group, and the rest on x's own rows
    partial = rest = None
    if grp is not None:
        partial = out
    else:                   # computed alike on every model rank: the rank's rows
        rest = out if sp is None else out.narrow(1, seq_offset(sp, x.shape[1]), x.shape[1])
    for name, on, btp in (("shared", cfg.shared_expert, shared_tp),
                          ("dense", cfg.moe_dense_residual, dense_tp)):
        if not on:
            continue
        if btp is None:     # whole: on the rank's own rows
            y = layers.mlp(h, params[name], cfg.act, use_kernel=pol.kernels)
            rest = y if rest is None else rest + y
        else:
            y = layers.mlp(hr if sp is not None else enter(h, btp, None), params[name],
                           cfg.act, use_kernel=pol.kernels)
            partial = y if partial is None else partial + y
            grp = btp if grp is None else grp
    if partial is not None:
        x = x + leave(partial, grp, sp)
    if rest is not None:
        x = x + rest
    return x, aux.float(), drop


def simulated_drop_fraction(cfg: ModelConfig, batch: int, seq: int,
                            seed: int = 0, samples: int = 4) -> float:
    """Measured drop fraction of the router itself (:func:`_route`) at the
    run's (G, g, E, C), under softmax-of-Gaussian gates: what the dry run
    reports beside the analytic ``expertplan.predicted_drop_fraction``
    without running a train step.  Sample i draws its gates from
    ``numpy.random.default_rng(seed + i)`` (the reference draws them with
    ``jax.random``).  The result is cached by (batch, seq, the router's
    fields): a production shape takes tens of seconds on the CPU."""
    G, g = group_shape(batch, seq)
    return _drop_fraction(G, g, cfg.n_experts, cfg.top_k, moe_capacity(g, cfg), seed, samples)


@functools.lru_cache(maxsize=64)
def _drop_fraction(G: int, g: int, E: int, top_k: int, C: int, seed: int,
                   samples: int) -> float:
    fracs = []
    for i in range(samples):
        z = np.random.default_rng(seed + i).standard_normal((G, g, E), dtype=np.float32)
        _, _, slot_valid, _ = _route(torch.softmax(torch.from_numpy(z), -1), top_k, C)
        fracs.append(1.0 - float(slot_valid.sum()) / (G * g * max(top_k, 1)))
    return float(np.mean(fracs))


def _index(tree: dict, j: int) -> dict:
    return {k: _index(v, j) if isinstance(v, dict) else v[j] for k, v in tree.items()}


def segment_body(cfg: ModelConfig, policy: ComputePolicy | None,
                 cast: Callable[[dict], dict], par: Any = None,
                 ep: ExpertDispatch | None = None):
    """The StageProgram body of one MoE stack unit
    (``repro/models/moe.py:segment_body``): the nested ``moe_every - 1``
    dense sub-stack (llama4), attention, then :func:`moe_block`, whose aux
    loss and drop fraction add into the ``aux`` and ``moe_drop`` carries;
    each block on the model group as ``par`` (``blocks.Parallel``) says.
    The unit runs under the policy's remat wrapper with the cast of its
    storage-dtype weights (``cast``) inside, as the other families' bodies."""
    from repro_torch.models import blocks

    pol = resolve_policy(policy)
    par = par or blocks.Parallel()

    def unit(lp: dict, x: torch.Tensor):
        lp = cast(lp)
        for j in range(cfg.moe_every - 1):
            dlp = _index(lp["dense"], j)
            x = blocks.self_attn_block(dlp["attn"], x, cfg, causal=True, policy=pol,
                                       tp=par.tp("dense.attn"), sp=par.seq)
            x = blocks.mlp_block(dlp["mlp"], x, cfg, policy=pol, tp=par.tp("dense.mlp"),
                                 sp=par.seq)
        x = blocks.self_attn_block(lp["attn"], x, cfg, causal=True, policy=pol,
                                   tp=par.tp("attn"), sp=par.seq)
        return moe_block(lp["moe"], x, cfg, policy=pol, ep=ep, tp=par.tp("moe"),
                         experts=par.experts, shared_tp=par.tp("moe.shared"),
                         dense_tp=par.tp("moe.dense"), sp=par.seq)

    step = pol.checkpoint(unit)

    def body(lp: dict, x: torch.Tensor, carry: dict):
        x, a, dr = step(lp, x)
        return x, {**carry, "aux": carry["aux"] + a, "moe_drop": carry["moe_drop"] + dr}
    return body
