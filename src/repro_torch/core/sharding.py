"""Logical-axis sharding rules (a jax-free copy of ``repro/core/sharding.py``).

Every parameter leaf carries a tuple of *logical* axis names (e.g.
``("embed", "mlp")``).  A :class:`ShardingRules` table maps logical names
onto mesh axes; the paper's TP/DP/ZeRO choices are different rule tables
over the same model definition.

A spec is a tuple with one entry per dim: a mesh axis name, a tuple of
names, or None (replicated).  Mesh axis sizes come from a plain
``{axis: size}`` mapping.  Divisibility is lenient: a mesh axis that does not
divide its dimension leaves that dimension replicated.

:func:`shard_shape` and :func:`shard_slices` give one rank's block of a
leaf under a spec (blocks in rank order along each sharded dim; the layer
stack round-robin over the pipe ranks under virtual stages; a dim laid out
as :class:`Pieces` over the model axis, the rank's part of each piece).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

MeshAxis = str | tuple[str, ...] | None
Spec = tuple[MeshAxis, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names to mesh axis names (or None = replicated)."""

    rules: Mapping[str, MeshAxis]
    name: str = "custom"

    def mesh_axis(self, logical: str | None) -> MeshAxis:
        if logical is None:
            return None
        return self.rules.get(logical)

    def with_overrides(self, name: str | None = None, **overrides: MeshAxis) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(overrides)
        return ShardingRules(rules=merged, name=name or self.name + "+")


def _base_rules(
    *, data_axis: MeshAxis, model_axis: MeshAxis, pipe_axis: MeshAxis = None,
    extra: Mapping[str, MeshAxis] | None = None,
    name: str = "custom",
) -> ShardingRules:
    rules: dict[str, MeshAxis] = {
        "batch": data_axis,
        "seq": None,
        "embed": None,
        "heads": model_axis,
        "kv_heads": model_axis,
        "head_dim": None,
        "mlp": model_axis,
        "vocab": model_axis,
        "layers": pipe_axis,
        "stage": pipe_axis or "pipe",
        "experts": data_axis,
        "expert_mlp": model_axis,
        "ssm_heads": model_axis,
        "ssm_state": None,
        "conv": None,
        "cache_batch": data_axis,
        "cache_seq": model_axis,
        "cache_heads": None,
        "act_embed": None,
        "act_heads": model_axis,
        "act_mlp": model_axis,
    }
    if extra:
        rules.update(extra)
    return ShardingRules(rules=rules, name=name)


def megatron_rules(data_axis: str = "data", model_axis: str = "model",
                   pipe_axis: MeshAxis = None) -> ShardingRules:
    """The paper's strategy: Megatron TP over `model`, DP (+ZeRO) over `data`."""
    return _base_rules(data_axis=data_axis, model_axis=model_axis,
                       pipe_axis=pipe_axis, name="megatron_tp")


def fsdp_rules(data_axis: str = "data", model_axis: str = "model",
               pipe_axis: MeshAxis = None) -> ShardingRules:
    """Parameters sharded over data on the embed dim too (gathered on use)."""
    return _base_rules(data_axis=data_axis, model_axis=model_axis,
                       pipe_axis=pipe_axis, extra={"embed": data_axis}, name="fsdp")


def dp_only_rules(data_axis: str = "data", model_axis: str | None = None,
                  pipe_axis: MeshAxis = None) -> ShardingRules:
    """Pure data parallelism (model replicated)."""
    return _base_rules(data_axis=data_axis, model_axis=None,
                       pipe_axis=pipe_axis, name="dp_only")


def tp_only_rules(data_axis: str | None = None, model_axis: str = "model",
                  pipe_axis: MeshAxis = None) -> ShardingRules:
    return _base_rules(data_axis=None, model_axis=model_axis,
                       pipe_axis=pipe_axis, name="tp_only")


PRESETS = {
    "megatron_tp": megatron_rules,
    "fsdp": fsdp_rules,
    "dp_only": dp_only_rules,
    "tp_only": tp_only_rules,
}


def _axes(entry: MeshAxis) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def axis_size(sizes: Mapping[str, int], axis: MeshAxis) -> int:
    """Size of a (possibly composite) mesh axis; 0 if ``sizes`` lacks it
    (such a dim falls back to replication)."""
    if axis is None:
        return 1
    if any(a not in sizes for a in _axes(axis)):
        return 0
    return int(np.prod([sizes[a] for a in _axes(axis)]))


def partition_spec(shape: Sequence[int], axes: Sequence[str | None],
                   sizes: Mapping[str, int], rules: ShardingRules,
                   unit_axes: bool = False) -> Spec:
    """The spec of one leaf; replicates dims that do not divide.  A mesh
    axis of size 1 replicates too, unless ``unit_axes`` (the port's
    executor keeps it, and runs its collectives over the one-rank group as
    over any other)."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} vs logical axes {axes}: rank mismatch")
    spec: list[MeshAxis] = []
    used: set[str] = set()
    for dim, logical in zip(shape, axes):
        mesh_axis = rules.mesh_axis(logical)
        if mesh_axis is None:
            spec.append(None)
            continue
        if any(a in used for a in _axes(mesh_axis)):
            spec.append(None)  # a mesh axis may shard only one dim
            continue
        size = axis_size(sizes, mesh_axis)
        if size < 1 or (size == 1 and not unit_axes) or dim % size != 0:
            spec.append(None)
            continue
        used.update(_axes(mesh_axis))
        spec.append(mesh_axis)
    return tuple(spec)


def zero_partition_spec(shape: Sequence[int], base_spec: Spec, sizes: Mapping[str, int],
                        dp_axis: str, unit_axes: bool = False,
                        node_axis: str | None = None) -> Spec:
    """Add the DP axis to the first divisible, unsharded dim of
    ``base_spec``; ``unit_axes`` as in :func:`partition_spec`.  With
    ``node_axis`` (the hierarchical CommPlan, ``core/commplan.py``) of more
    than one rank, the node axis goes on the first other free divisible
    dim, so a gather runs as an inter-node phase over the node group and an
    intra-node one over the data group; a leaf without such a dim falls
    back to the composite ``(dp, node)`` entry on the data dim where that
    divides (still 1/(dp x node) of the leaf, over one dim), else keeps the
    node axis off."""
    spec = list(base_spec) + [None] * (len(shape) - len(base_spec))
    used = {a for entry in spec for a in _axes(entry)}

    def place(axis: str, min_ways: int) -> int:
        ways = sizes.get(axis, 1)
        if axis in used or ways < min_ways:
            return -1
        for i, (dim, entry) in enumerate(zip(shape, spec)):
            if entry is None and dim % ways == 0 and dim >= ways:
                spec[i] = axis
                used.add(axis)
                return i
        return -1

    dp_dim = place(dp_axis, 1 if unit_axes else 2)
    if node_axis is not None and place(node_axis, 2) < 0 and node_axis not in used \
            and dp_dim >= 0 and sizes.get(node_axis, 1) > 1 \
            and shape[dp_dim] % (sizes[dp_axis] * sizes[node_axis]) == 0:
        spec[dp_dim] = (dp_axis, node_axis)
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class Pieces:
    """A dim sharded over the model axis that is not one even split: the
    dim is consecutive pieces ``(width, split)``; a split piece is cut into
    one even block per model rank, a piece that is not split is held whole
    by every model rank, and a rank's block is its part of each piece, in
    the dim's order (a fused projection whose columns are several tensors,
    some of them used whole by every rank)."""
    parts: tuple[tuple[int, bool], ...]

    @property
    def size(self) -> int:
        return sum(w for w, _ in self.parts)

    def _cut(self, ways: int) -> list[tuple[int, int, bool]]:
        """(start in the dim, width in a rank's block, split) of each piece."""
        out, start = [], 0
        for w, split in self.parts:
            if split and w % ways:
                raise ValueError(f"a piece of width {w} does not split over {ways} ranks")
            out.append((start, w // ways if split else w, split))
            start += w
        return out

    def width(self, ways: int) -> int:
        """The dim of one rank's block."""
        return sum(n for _, n, _ in self._cut(ways))

    def index(self, ways: int, k: int) -> list[int]:
        """Rank ``k``'s entries of the whole dim, in its block's order."""
        return [i for start, n, split in self._cut(ways)
                for i in range(start + k * n if split else start,
                               start + (k + 1) * n if split else start + n)]

    def split_ranges(self, ways: int) -> list[tuple[int, int]]:
        """(offset, length) in a rank's block of its split pieces' parts:
        what the rank holds alone."""
        out, off = [], 0
        for _, n, split in self._cut(ways):
            if split:
                out.append((off, n))
            off += n
        return out


def _pieces_dim(spec: Spec, pieces: Pieces | None) -> int | None:
    """The dim that ``pieces`` lays out: the one sharded over "model" alone
    (None: the leaf is not sharded over it, and is held whole)."""
    if pieces is None or "model" not in spec_axes(spec):
        return None
    dims = [i for i, e in enumerate(spec) if e == "model"]
    if len(dims) != 1:
        raise ValueError(f"pieces lay out the dim sharded over 'model' alone; spec {spec}")
    return dims[0]


def shard_shape(shape: Sequence[int], spec: Spec, sizes: Mapping[str, int],
                pieces: Pieces | None = None) -> tuple[int, ...]:
    """The block one rank holds of a leaf of ``shape`` under ``spec`` (the
    dim sharded over "model" laid out as ``pieces``, if given)."""
    at = _pieces_dim(spec, pieces)
    return tuple(pieces.width(sizes["model"]) if i == at else d // axis_size(sizes, e)
                 for i, (d, e) in enumerate(zip(shape, spec)))


def shard_slices(shape: Sequence[int], spec: Spec, sizes: Mapping[str, int],
                 coord: Mapping[str, int], virtual_stages: int = 1,
                 pieces: Pieces | None = None) -> tuple:
    """The index of the rank at mesh coordinate ``coord`` ({axis: index})
    into the whole leaf: along a dim sharded over a composite axis the
    first named axis is the slowest.  With ``virtual_stages`` v > 1 a dim
    sharded over "pipe" alone (the layer stack) is cut into v x p blocks
    and pipe rank d holds blocks d, d + p, ..., d + (v - 1) p, the layers of
    its logical stages (``core/pipeline.py``): a list of indices, where
    every other dim is a slice.  The dim that ``pieces`` lays out is a list
    of indices too (:meth:`Pieces.index`); :func:`outer` makes an index
    with two lists apply as one block."""
    at = _pieces_dim(spec, pieces)
    out: list = []
    for i, (d, e) in enumerate(zip(shape, spec)):
        if i == at:
            if d != pieces.size:
                raise ValueError(f"pieces of {pieces.size} lay out a dim of {d}")
            out.append(pieces.index(sizes["model"], coord["model"]))
            continue
        if virtual_stages > 1 and "pipe" in _axes(e):
            if e != "pipe":
                raise NotImplementedError(f"virtual stages on the composite axis {e!r}")
            p = sizes["pipe"]
            n = d // (virtual_stages * p)
            out.append([(k * p + coord["pipe"]) * n + i
                        for k in range(virtual_stages) for i in range(n)])
            continue
        idx, n = 0, 1
        for a in _axes(e):
            idx = idx * sizes[a] + coord[a]
            n *= sizes[a]
        out.append(slice(idx * (d // n), (idx + 1) * (d // n)))
    return tuple(out)


def outer(index: tuple) -> tuple:
    """A :func:`shard_slices` index that numpy (get and set) and torch (get)
    apply as the block it names: as it is with at most one list, else every
    dim as an open-mesh array (``np.ix_``)."""
    if sum(not isinstance(e, slice) for e in index) <= 1:
        return index
    return np.ix_(*[np.arange(e.start, e.stop) if isinstance(e, slice) else np.asarray(e)
                    for e in index])


def spec_axes(spec: Spec) -> set[str]:
    """The mesh axes a spec shards over."""
    return {a for entry in spec for a in _axes(entry)}
