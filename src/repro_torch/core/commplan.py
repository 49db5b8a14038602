"""CommPlan: the communication axis of a ParallelPlan, as bytes (the byte
semantics of ``repro/core/commplan.py``).

The plan fields are the reference's: ``qcomm`` (block-quantized ZeRO 3
gathers: int8 payloads with one fp32 scale per ``block`` elements of the
last dim; ``"both"`` also block-quantizes the gradient the gather's
backward reduce-scatters into the rank's block), ``node`` (a hierarchical
("node", ..., "data", ...) mesh whose ZeRO gathers and reduce-scatters run
in an inter-node phase over the node group and an intra-node one over the
data group) and ``overlap`` (each segment's weight gathers issued a chunk
of layers ahead of the compute).  The port's executor runs all three over
``torch.distributed``: ``runtime/qcollect.py`` (the quantizer,
``CommExec`` and ``LayerComm``), ``runtime/collectives.py:LeafGather``
(the phases) and ``core/stage_program.py:run_program`` (the overlap).
What is here decides and prices them: the spec algebra, which leaves a
gather moves and quantizes (:func:`gathers_over`, :func:`quant_eligible`)
and :func:`leaf_gather_bytes` / :func:`tree_gather_bytes`, which
``core/costmodel.py:predict_comm_bytes`` bridges to and the gather bytes
``runtime/collectives.py`` counts are read against.

Specs are plain tuples (entries None | str | tuple of str) and the mesh a
name -> size mapping: numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np

QCOMM_MODES = ("none", "gather", "both")

# One fp32 scale per quantization block (s8 payload + f32 scales); the
# per-element byte ratio of a quantized gather vs the f32 baseline is
# (1 + 4/block) / 4.
QUANT_ITEMSIZE = 1
SCALE_ITEMSIZE = 4


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """One point on the communication axis of a ParallelPlan."""

    qcomm: str = "none"         # none | gather | both
    block: int = 32             # quantization block along the last dim
    overlap: bool = False       # interleave weight gathers with the scan
    overlap_chunks: int = 2     # target chunks per segment when overlapping
    node: int = 1               # hierarchy ways (size of the "node" axis)
    node_axis: str = "node"
    data_axis: str = "data"

    def __post_init__(self):
        if self.qcomm not in QCOMM_MODES:
            raise ValueError(
                f"qcomm must be one of {QCOMM_MODES}, got {self.qcomm!r}")
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {self.block}")
        if self.overlap_chunks < 1:
            raise ValueError(
                f"overlap_chunks must be >= 1, got {self.overlap_chunks}")
        if self.node < 1:
            raise ValueError(f"node must be >= 1, got {self.node}")

    @property
    def quantizes(self) -> bool:
        return self.qcomm != "none"

    @property
    def quantizes_grads(self) -> bool:
        return self.qcomm == "both"

    @property
    def hierarchical(self) -> bool:
        return self.node > 1

    @property
    def strip_axes(self) -> tuple[str, ...]:
        """The mesh axes a weight gather removes from a ZeRO spec."""
        if self.hierarchical:
            return (self.data_axis, self.node_axis)
        return (self.data_axis,)

    def gather_itemsize(self, itemsize: int = 4) -> float:
        """Effective bytes/element a quantized gather moves (s8 + scales)."""
        if not self.quantizes:
            return float(itemsize)
        return QUANT_ITEMSIZE + SCALE_ITEMSIZE / self.block


# ---------------------------------------------------------------------------
# Spec algebra (specs are tuples of entries: None | str | tuple[str, ...])
# ---------------------------------------------------------------------------

Entry = Any  # None | str | tuple[str, ...]


def entry_axes(entry: Entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def strip_entry(entry: Entry, axes: Sequence[str]) -> Entry:
    kept = tuple(a for a in entry_axes(entry) if a not in axes)
    if not kept:
        return None
    if len(kept) == 1:
        return kept[0]
    return kept


def strip_spec(spec: Sequence[Entry], axes: Sequence[str]) -> tuple:
    """Remove ``axes`` from every entry — the gathered-side spec."""
    return tuple(strip_entry(e, axes) for e in spec)


def spec_axes(spec: Sequence[Entry]) -> set[str]:
    out: set[str] = set()
    for e in spec:
        out.update(entry_axes(e))
    return out


def entry_size(entry: Entry, mesh_shape: Mapping[str, int]) -> int:
    n = 1
    for a in entry_axes(entry):
        n *= int(mesh_shape.get(a, 1))
    return n


def pad_spec(spec: Sequence[Entry], ndim: int) -> tuple:
    """Left-pad a spec with None for leaves that grew leading dims (the
    hybrid grouping / overlap chunking reshape only ever splits dim 0)."""
    spec = tuple(spec)
    if len(spec) >= ndim:
        return spec[:ndim]
    return (None,) * (ndim - len(spec)) + spec


def gathers_over(spec: Sequence[Entry], strip: Sequence[str]) -> bool:
    """True when a gather from ``spec`` to the stripped spec moves bytes."""
    return bool(spec_axes(spec) & set(strip))


def quant_eligible(shape: Sequence[int], spec: Sequence[Entry],
                   mesh_shape: Mapping[str, int], strip: Sequence[str],
                   block: int) -> bool:
    """Whether a leaf rides the int8 gather path.

    Requires: the gather actually moves bytes (a stripped axis is in the
    spec), rank >= 2 (1-D norm/bias leaves are noise and keep the fp path),
    the last dim tiles into whole blocks, and the block-count dim stays
    divisible by whatever mesh axes shard the last dim (so the int8
    tensor's pinned sharding never splits a block across devices).
    """
    shape = tuple(shape)
    if len(shape) < 2 or not gathers_over(spec, strip):
        return False
    last = shape[-1]
    if last % block != 0:
        return False
    nblocks = last // block
    last_ways = entry_size(tuple(spec)[-1] if spec else None, mesh_shape)
    return last_ways <= 1 or nblocks % last_ways == 0


def quant_specs(spec: Sequence[Entry]) -> tuple[tuple, tuple]:
    """(int8-payload spec, scale spec) for a leaf spec: the last dim splits
    into (nblocks, block); the last dim's mesh axes ride the nblocks dim."""
    spec = tuple(spec)
    head, last = spec[:-1], spec[-1]
    return head + (last, None), head + (last,)


# ---------------------------------------------------------------------------
# Byte prediction (read against the gather bytes runtime/collectives.py counts)
# ---------------------------------------------------------------------------

def leaf_gather_bytes(shape: Sequence[int], spec: Sequence[Entry],
                      mesh_shape: Mapping[str, int], cp: CommPlan,
                      itemsize: int = 4, unit_axes: bool = False) -> dict[str, float]:
    """Predicted all-gather payload bytes to ungather one leaf once.

    Convention of the reference's ``analysis/hlo.py:comm_bytes``, which
    ``runtime/collectives.py`` counts by too: an all-gather's payload is
    its *output* bytes **per device**, so a leaf that stays sharded over
    non-stripped axes (e.g. the tensor-parallel "model" axis) after the
    gather only moves ``full / residual_ways`` bytes.  A hierarchical (two-axis) gather
    lowers to one per-axis phase each; phase k's output covers every axis
    gathered so far, so the total exceeds the flat single-phase payload —
    the win is that only the final (node) phase touches the slow fabric.
    Returns ``{"intra": bytes, "inter": bytes, "total": bytes}``.  With
    ``unit_axes`` a stripped axis of one rank named in the spec is a phase
    too, as the port's executor runs it (a gather over a one-rank group
    outputs its block); without, such a phase moves nothing, as XLA drops
    it.
    """
    numel = float(np.prod(np.asarray(shape, dtype=np.float64))) if shape else 1.0
    strip = cp.strip_axes
    present = spec_axes(spec)
    data_ways = entry_size(cp.data_axis, mesh_shape) if cp.data_axis in present else 1
    node_ways = entry_size(cp.node_axis, mesh_shape) if cp.node_axis in present else 1
    least = 1 if unit_axes else 2
    has_data = cp.data_axis in present and data_ways >= least
    has_node = cp.node_axis in present and node_ways >= least
    if not (has_data or has_node):
        return {"intra": 0.0, "inter": 0.0, "total": 0.0}
    quant = cp.quantizes and quant_eligible(shape, spec, mesh_shape, strip,
                                            cp.block)
    if quant:
        per_elem = QUANT_ITEMSIZE + SCALE_ITEMSIZE / cp.block
    else:
        per_elem = float(itemsize)
    residual = 1.0
    for entry in strip_spec(spec, strip):
        residual *= entry_size(entry, mesh_shape)
    full = numel * per_elem / residual
    if not (has_data and has_node):
        # single-phase gather over whichever axis is present
        bucket = "intra" if has_data else "inter"
        out = {"intra": 0.0, "inter": 0.0}
        out[bucket] = full
        out["total"] = full
        return out
    # two phases in the reference's order: the *second-listed* spec dim (the
    # node phase, which ZeRO specs place after the data dim) first, so the
    # intra (data) phase outputs the full tensor and the inter (node) phase
    # outputs full/data_ways
    inter = full / data_ways
    intra = full
    return {"intra": intra, "inter": inter, "total": intra + inter}


def tree_gather_bytes(shapes: Sequence[Sequence[int]],
                      specs: Sequence[Sequence[Entry]],
                      mesh_shape: Mapping[str, int], cp: CommPlan,
                      itemsize: int = 4, multiplier: float = 1.0,
                      unit_axes: bool = False) -> dict:
    """Sum :func:`leaf_gather_bytes` over parallel (shape, spec) lists.

    ``multiplier`` is how many times each leaf is gathered per train step
    (the port: once in each microbatch's forward, and again in the
    recompute of a checkpointed layer).
    """
    tot = {"intra": 0.0, "inter": 0.0, "total": 0.0}
    for shape, spec in zip(shapes, specs):
        b = leaf_gather_bytes(shape, spec, mesh_shape, cp, itemsize, unit_axes)
        for k in tot:
            tot[k] += b[k] * multiplier
    return tot
