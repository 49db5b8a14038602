"""Checkpoints in the reference's on-disk format
(``repro/checkpointing/checkpoint.py``): one ``.npy`` file a leaf and a
msgpack manifest, so that either package reads the other's.

Layout:  <dir>/step_<N:08d>/manifest.msgpack
         <dir>/step_<N:08d>/<sanitized tree path>.npy

A tree is a nested dict of tensors, numpy arrays and Python scalars.  A key
with dots is a path (the port's state_dict keys are the reference's tree
paths joined by dots), so a train state's leaves take the reference's names:
``params/layers/attn/wq``, ``opt/mu/...``, ``opt/nu/...``, ``opt/count``,
``loss_scale/...``, ``step``, in the reference's (sorted) order.  A leaf
with no numpy dtype (bfloat16, the fp8 types) is stored as its raw bytes
(``uint8``, the last dim times the item size) with ``raw_bytes: true`` and
its dtype's name; Python ints are stored as int32 and bools as bool, as the
reference's scalars are.

A sharded train state (``model`` built by ``train_loop.build_model``)
passes :func:`state_shardings`: the save gathers each leaf whole on rank 0
of the default group, which alone writes, receiving one copy of each
distinct block (a block that dp replicas hold comes once), and the
restore reads whole leaves on every rank and keeps the rank's block, so
a checkpoint saved under one plan restores under another (the parameters
by ``Model.block_of``'s index, Adam's moments by their ZeRO stage's).
"""
from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpointing.msgpack_lite import packb, unpackb
from repro_torch.core import sharding as shd
from repro_torch.interop import block_index
from repro_torch.runtime.train_loop import plan_state_shardings

MANIFEST = "manifest.msgpack"


def _flatten(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k, v in tree.items():
        out += _flatten(v, prefix + tuple(str(k).split(".")))
    return out


def flatten_with_paths(tree: Any) -> list[tuple[str, Any]]:
    """(path, leaf) pairs in the reference's leaf order, the path's parts
    joined by "/"."""
    return [("/".join(p), leaf) for p, leaf in sorted(_flatten(tree), key=lambda e: e[0])]


def _sanitize(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str, bool]:
    """(the array np.save writes, the dtype's name, raw?)."""
    if isinstance(leaf, bool):
        return np.asarray(leaf, np.bool_), "bool", False
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32", False
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        try:
            arr = t.numpy()
        except TypeError:                        # no numpy dtype: raw bytes
            flat = t.contiguous().reshape(t.shape or (1,))
            return flat.view(torch.uint8).numpy(), _dtype_name(t.dtype), True
        return arr, str(arr.dtype), False
    arr = np.asarray(leaf)
    return arr, str(arr.dtype), False


def _host(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as numpy; a dtype numpy lacks (bfloat16) viewed
    as the signed integer of its width."""
    t = t.detach().cpu()
    try:
        return t.numpy()
    except TypeError:
        width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
        return t.view(width[t.element_size()]).numpy()


def _key(index: tuple) -> tuple:
    """A hashable form of a block's index (slices, or ``np.ix_`` arrays)."""
    return tuple((e.start, e.stop, e.step) if isinstance(e, slice)
                 else (np.shape(e), np.asarray(e).tobytes()) for e in index)


def _gather_whole(block: torch.Tensor, shape: tuple, at: list[tuple]) -> torch.Tensor | None:
    """The whole leaf on rank 0 (None on the other ranks) from each rank's
    ``block``; ``at[r]`` is (rank r's index into the leaf, its block's
    shape).  Rank 0 receives one block of each index it does not hold, from
    the lowest rank that holds it: replicas (the parameters over the data
    ranks below ZeRO 3) send nothing."""
    me = dist.get_rank()
    owners: dict = {}
    for r, (index, _) in enumerate(at):
        owners.setdefault(_key(index), r)
    senders = sorted(set(owners.values()) - {0})
    if me in senders:
        dist.send(block.detach().contiguous(), dst=0)
    if me != 0:
        return None
    whole = np.empty(shape, dtype=_host(block).dtype)
    whole[at[0][0]] = _host(block)
    for r in senders:
        buf = torch.empty(at[r][1], dtype=block.dtype, device=block.device)
        dist.recv(buf, src=r)
        whole[at[r][0]] = _host(buf)
    return torch.from_numpy(whole).view(block.dtype)


def save_checkpoint(directory: str, step: int, tree: Any,
                    shardings: dict | None = None) -> str:
    """Write ``tree`` as step ``step`` of ``directory``; returns the step's
    directory.  ``shardings`` ({path: (whole shape, index)}, from
    :func:`state_shardings`) names the leaves that are a rank's blocks:
    they are gathered on rank 0, the only writer, one block of each
    distinct index (:func:`_gather_whole`)."""
    path = os.path.join(directory, f"step_{step:08d}")
    shardings = shardings or {}
    writer = not shardings or dist.get_rank() == 0
    if writer:
        os.makedirs(path, exist_ok=True)
    flat = flatten_with_paths(tree)
    if shardings:       # every rank's index and block shape of each leaf
        mine = {k: (shardings[k][1], tuple(leaf.shape)) for k, leaf in flat if k in shardings}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
    entries = []
    for key, leaf in flat:
        if key in shardings:
            leaf = _gather_whole(leaf, shardings[key][0], [e[key] for e in every])
            if leaf is None:
                continue
        if not writer:
            continue
        arr, dtype_name, raw = _to_numpy(leaf)
        fname = _sanitize(key) + ".npy"
        np.save(os.path.join(path, fname), arr)
        shape = list(leaf.shape) if hasattr(leaf, "shape") else []
        entries.append({"key": key, "file": fname, "raw_bytes": raw,
                        "shape": shape, "dtype": dtype_name})
    if writer:
        with open(os.path.join(path, MANIFEST), "wb") as f:
            f.write(packb({"step": step, "entries": entries}))
    if shardings:
        dist.barrier()
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def _load(path: str, entry: dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, entry["file"]))
    t = torch.from_numpy(arr)
    if entry.get("raw_bytes"):
        t = t.view(getattr(torch, entry["dtype"])).reshape(entry["shape"])
    return t


def restore_checkpoint(directory: str, step: int, like: Any,
                       shardings: dict | None = None) -> Any:
    """``like``'s tree with step ``step``'s values: a tensor leaf is
    overwritten in place (its dtype and device kept) and returned, a Python
    scalar leaf replaced by the stored value.  ``shardings`` as in
    :func:`save_checkpoint`: those leaves take the rank's block of the
    stored whole."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST), "rb") as f:
        by_key = {e["key"]: e for e in unpackb(f.read())["entries"]}
    shardings = shardings or {}
    values = {}
    for key, leaf in flatten_with_paths(like):
        if key not in by_key:
            raise KeyError(f"checkpoint {path} has no leaf {key!r}")
        arr = _load(path, by_key[key])
        whole_shape, index = shardings.get(key, (None, None))
        expected = whole_shape or (tuple(leaf.shape) if hasattr(leaf, "shape") else ())
        if tuple(arr.shape) != tuple(expected):
            raise ValueError(f"checkpoint leaf {key}: {tuple(arr.shape)} != {tuple(expected)}")
        if index is not None:
            arr = arr[index]
        if isinstance(leaf, torch.Tensor):
            with torch.no_grad():
                leaf.copy_(arr.to(leaf.dtype))
            values[key] = leaf
        elif isinstance(leaf, bool):
            values[key] = bool(arr)
        elif isinstance(leaf, int):
            values[key] = int(arr)
        else:
            values[key] = arr.numpy().astype(np.asarray(leaf).dtype)
    return _rebuild(like, values)


def _rebuild(tree: Any, values: dict, prefix: tuple = ()) -> Any:
    if not isinstance(tree, dict):
        return values["/".join(prefix)]
    return {k: _rebuild(v, values, prefix + tuple(str(k).split("."))) for k, v in tree.items()}


def state_shardings(model, plan) -> dict:
    """{path: (whole shape, index)} of a sharded train state's blocks
    (``train_loop.init_train_state`` over ``train_loop.build_model``): each
    parameter at ``Model.block_of``'s index, and Adam's ``mu`` and ``nu`` at
    the index of the rank's block of the update under the plan's ZeRO stage
    (``sharding.shard_slices`` of the optimizer spec).  Empty for an
    unsharded model."""
    if model.shardings is None:
        return {}
    shapes, _, opt_sh, _ = plan_state_shardings(model.cfg, plan)
    coord = model.mesh.coord
    out = {}
    for k, shape in shapes.items():
        name = k.replace(".", "/")
        out[f"params/{name}"] = (shape, shd.outer(model.block_of(k, shape)))
        opt = (shape, block_index(k, shape, opt_sh[k], model.cfg, plan, coord))
        out[f"opt/mu/{name}"] = out[f"opt/nu/{name}"] = opt
    return out
