"""Carry weights from the JAX package's parameter pytree into the port.

The caller converts the JAX tree to numpy on its side (``np.asarray`` per
leaf), so this module never sees a JAX type.  Keys are the pytree paths
joined by dots, which are the port's state_dict keys.  For a sharded model
:func:`shard_params` gives one rank its blocks of the tree and
:func:`gather_params` puts every rank's blocks back together.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.core import sharding as shd


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict of arrays -> {dotted path: array}."""
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def from_jax_params(tree: Any, model: nn.Module) -> dict[str, torch.Tensor]:
    """A state_dict for ``model`` from a numpy tree (nested or flat with
    dotted keys).  Strict: every leaf of the tree and every parameter of the
    model must be matched, with equal shapes; anything else raises."""
    flat = flatten_tree(tree)
    expected = model.state_dict()
    missing = sorted(expected.keys() - flat.keys())
    unused = sorted(flat.keys() - expected.keys())
    if missing or unused:
        raise KeyError(f"parameter trees differ: missing {missing}, unused {unused}")
    out = {}
    for key, ref in expected.items():
        arr = flat[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != {tuple(ref.shape)}")
        if arr.dtype.name == "bfloat16":        # ml_dtypes; torch reads fp32
            arr = arr.astype(np.float32)
        out[key] = torch.from_numpy(np.array(arr)).to(
            device=ref.device, dtype=ref.dtype)
    return out


def _specs(cfg, plan) -> tuple[dict, dict]:
    from repro_torch.runtime.train_loop import plan_state_shardings

    shapes, psh, _, _ = plan_state_shardings(cfg, plan)
    return shapes, psh


def block_index(key: str, shape, spec, cfg, plan, coord: dict) -> tuple:
    """The index of the rank at ``coord`` into the whole leaf ``key`` of
    ``shape`` under ``spec`` (a parameter's, or its Adam moments' under the
    plan's ZeRO stage), as numpy and torch apply it."""
    from repro_torch.models.model import pipe_interleaved, tp_pieces

    v = plan.virtual_stages if plan.pp > 1 and pipe_interleaved(key) else 1
    return shd.outer(shd.shard_slices(shape, spec, plan.mesh_sizes(), coord, v,
                                      tp_pieces(cfg).get(key)))


def shard_params(tree: Any, cfg, plan, coord: dict) -> dict[str, np.ndarray]:
    """The blocks of the rank at mesh coordinate ``coord`` ({"pipe": i,
    "data": j, "model": k}, "expert" at ep > 1, "node" at node > 1) of a whole parameter
    tree (nested or flat), under the plan's shardings of ``cfg``: at pp > 1
    the layers of the rank's logical stages (round-robin under virtual
    stages; the encdec encoder's contiguous block); at ep > 1 the rank's E/ep experts of each expert leaf (at
    ep = 1 its block of them over the data ranks); zamba2's in_proj and
    conv blocks the rank's heads' columns and the B and C ones
    (``models/model.py:tp_pieces``)."""
    shapes, psh = _specs(cfg, plan)
    return {k: np.asarray(a)[block_index(k, shapes[k], psh[k], cfg, plan, coord)]
            for k, a in flatten_tree(tree).items()}


def mesh_axes(plan) -> tuple[str, ...]:
    """The mesh axes of a plan's coordinates, as :func:`gather_params`
    keys them."""
    axes = ("pipe", "data", "model") if plan.ep == 1 else ("pipe", "data", "expert", "model")
    return (("node",) if plan.node > 1 else ()) + axes


def gather_params(blocks: dict[tuple[int, ...], dict], cfg, plan) -> dict[str, np.ndarray]:
    """The whole tree from every rank's blocks, ``{(pipe, data, model):
    {key: block}}``, or ``{(pipe, data, expert, model): ...}`` at ep > 1,
    either led by the node coordinate at node > 1
    (the inverse of :func:`shard_params`)."""
    shapes, psh = _specs(cfg, plan)
    axes = mesh_axes(plan)
    out = {}
    for k, shape in shapes.items():
        first = next(iter(blocks.values()))[k]
        whole = np.empty(shape, dtype=np.asarray(first).dtype)
        for at, tree in blocks.items():
            whole[block_index(k, shape, psh[k], cfg, plan,
                              dict(zip(axes, at)))] = np.asarray(tree[k])
        out[k] = whole
    return out
