"""Serving loops (port of ``repro/runtime/serve_loop.py``).

PyTorch runs eagerly, so the build_* functions return plain callables where
the JAX package returns jitted ones; the model holds its own weights.  With
a mesh the decode step serves data-parallel slots on ``torch.distributed``:
where the reference's GSPMD shardings put the tick's batch and the cache's
slots on the data axis, each rank runs ``Model.decode_step`` on its own
rows and cache and the tick's logits are all-gathered over the data group.
The serve engine says which rows are a rank's.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.models.model import Model
from repro_torch.runtime.collectives import MeshGroups, all_gather_dim


def build_prefill(model: Model, cache_len: int, *,
                  with_lens: bool = False) -> Callable:
    """Prefill at a fixed cache length; ``with_lens=True`` takes the
    per-request true lengths (length-bucketed serving prefill)."""
    if with_lens:
        def prefill_lens(batch, lens):
            return model.prefill(batch, cache_len, lens=lens)
        return prefill_lens

    def prefill(batch):
        return model.prefill(batch, cache_len)
    return prefill


def serve_mesh(model: Model, mesh: Any, plan: Any) -> MeshGroups:
    """The mesh of data-parallel serving (a ``DeviceMesh`` from
    ``launch/mesh.py:mesh_for_plan``, or its ``MeshGroups``) after checking
    what the port serves on one: a replicated model and a dp-only plan
    (ZeRO 0, no rule_overrides), as the reference's launcher builds it.
    tp, pp, ep and ZeRO serving raise."""
    if plan is None:
        raise ValueError("a serving mesh needs its plan")
    if (plan.tp, plan.pp, plan.ep, plan.node, plan.zero) != (1, 1, 1, 1, 0):
        raise NotImplementedError(
            f"serving under tp={plan.tp}, pp={plan.pp}, ep={plan.ep}, node={plan.node}, "
            f"zero={plan.zero} is not ported yet (see ROADMAP.md, Queue 1): the port "
            "serves dp slots over a replicated model (zero=0)")
    if plan.rule_overrides:
        raise NotImplementedError("serving takes no rule_overrides: the engine puts each "
                                  "data rank's slots and pool share where it says")
    if model.shardings is not None:
        raise NotImplementedError("serving a sharded model is not ported yet (see "
                                  "ROADMAP.md, Queue 1); dp slots take the replicated model")
    groups = mesh if isinstance(mesh, MeshGroups) else MeshGroups.from_mesh(mesh)
    if groups.sizes["data"] != plan.dp:
        raise ValueError(f"mesh {groups.sizes} is not the plan's dp={plan.dp}")
    return groups


def build_decode_step(model: Model, mesh: MeshGroups | None = None,
                      rows: slice | None = None) -> Callable:
    """The decode step ``(cache, batch) -> (logits, cache)``.  With a mesh it
    takes the whole tick's batch (every input has the slots on dim 0), runs
    ``Model.decode_step`` on this rank's ``rows`` of it and its own cache,
    and returns every slot's logits, all-gathered over the data group."""
    if mesh is None:
        def decode_step(cache, batch_in):
            return model.decode_step(cache, batch_in)
        return decode_step

    if rows is None:
        raise ValueError("a data-parallel decode step needs this rank's rows")
    group = mesh.groups["data"]

    def decode_step(cache, batch_in):
        logits, cache = model.decode_step(cache, {k: v[rows] for k, v in batch_in.items()})
        return all_gather_dim(logits, 0, group), cache
    return decode_step


def data_rank0_int(n: int, mesh: MeshGroups, device: torch.device) -> int:
    """Data rank 0's ``n`` on every rank of the data group."""
    group = mesh.groups["data"]
    t = torch.tensor([n], dtype=torch.int64, device=device)
    dist.broadcast(t, dist.get_global_rank(group, 0), group=group)
    return int(t.item())


def share_logits(logits: torch.Tensor | None, owner: int, mesh: MeshGroups, vocab: int,
                 device: torch.device) -> torch.Tensor:
    """The (1, vocab) fp32 prefill logits of data rank ``owner`` on every
    rank of the data group (the others pass None)."""
    group = mesh.groups["data"]
    if logits is None:
        logits = torch.empty((1, vocab), dtype=torch.float32, device=device)
    dist.broadcast(logits, dist.get_global_rank(group, owner), group=group)
    return logits


def greedy_generate(model: Model, prompt: torch.Tensor, n_steps: int,
                    cache_len: int, extras: dict | None = None) -> torch.Tensor:
    """Greedy loop, the temperature-0 reference that the serve engine must
    match token for token: prompt (B, S) -> (B, n_steps) ids.  ``extras``
    carries the non-token prefill inputs (``frames`` (B, T, frontend_dim)
    for encdec, ``patches`` (B, P, frontend_dim) for vlm); the encoder's
    output that prefill returns is fed to every decode step as
    ``memory``."""
    batch = {"tokens": prompt}
    batch.update({k: torch.as_tensor(v) for k, v in (extras or {}).items()})
    logits, cache = model.prefill(batch, cache_len)
    memory = cache.pop("memory", None)
    fed = {} if memory is None else {"memory": memory}
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    decode = build_decode_step(model)
    outs = [tok]
    for _ in range(n_steps - 1):
        logits, cache = decode(cache, {"token": tok, **fed})
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        outs.append(tok)
    return torch.cat(outs, dim=1)
