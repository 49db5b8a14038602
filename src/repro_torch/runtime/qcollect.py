"""The CommPlan's executor on ``torch.distributed`` (the port of
``repro/runtime/qcollect.py``).

  * Block quantization (:func:`block_quantize`, :func:`block_dequantize`,
    :func:`block_fake_quant`): per-block symmetric int8 over the last dim,
    one fp32 scale per ``block`` elements (max |x| / 127, floored at
    1e-30), rounded half to even, as the reference's.
  * The quantized gather (:class:`QuantGather`, through
    ``runtime/collectives.py:LeafGather``): each rank quantizes its block
    from the stored fp32 master values, the int8 payload and the fp32
    scales are all-gathered (over the node group, then the data group, as
    every ZeRO gather), and the whole is dequantized in fp32 and cast to
    the compute dtype, which is the reference's dequantize-then-cast.  The
    backward is straight-through: the fp32 sum of the uses' gradients is
    reduce-scattered into the block as an fp gather's is.  Under
    ``qcomm="both"`` the rank's reduce-scattered block is then
    fake-quantized: the reference fake-quantizes the cotangent its
    ``custom_vjp`` sees, the microbatch's gradient of the whole leaf summed
    over every rank, and since no quantization block straddles a shard
    (``commplan.quant_eligible``) quantizing the rank's block of that sum
    gives the same values.
  * :class:`CommExec`: the per-leaf decisions of the plan over the rank's
    specs, from ``core/commplan.py`` (``gathers_over``, ``quant_eligible``):
    which leaves are gathered, over which phases, and which quantized.
    ``models/model.py:Model._uses`` asks it for each leaf's gather.
  * :class:`LayerComm`: the overlap hook ``core/stage_program.py:
    run_program`` consumes: how many chunks a segment's units split into
    (:meth:`LayerComm.plan_chunks`) and the early issue of a chunk's
    gathers (:meth:`LayerComm.prefetch`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from repro_torch.core import commplan as cpl
from repro_torch.core import sharding as shd
from repro_torch.runtime.collectives import NODE, LeafGather, MeshGroups


# ---------------------------------------------------------------------------
# Block quantization (per-block symmetric int8, fp32 scales)
# ---------------------------------------------------------------------------

def block_quantize(x: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload (..., nb, block), fp32 per-block scales (..., nb));
    the blocks tile the last dim."""
    nb = x.shape[-1] // block
    xb = x.float().reshape(*x.shape[:-1], nb, block)
    s = (xb.abs().amax(dim=-1) / 127.0).clamp_min(1e-30)
    return torch.round(xb / s[..., None]).to(torch.int8), s


def block_dequantize(q: torch.Tensor, s: torch.Tensor, shape: tuple,
                     dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * s[..., None]).reshape(shape).to(dtype)


def block_fake_quant(x: torch.Tensor, block: int) -> torch.Tensor:
    """The quantization round trip on values alone (the gradient's
    precision model under ``qcomm="both"``)."""
    q, s = block_quantize(x, block)
    return block_dequantize(q, s, x.shape, x.dtype)


@dataclasses.dataclass(frozen=True)
class QuantGather:
    """What :class:`~repro_torch.runtime.collectives.LeafGather` does with a
    quantized leaf: the block's payload (in the block's shape) and scales
    to gather, the gathered pair back to values, and the gradient's fake
    quantization under ``qcomm="both"``."""
    block: int
    grads: bool

    def quantize(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        q, s = block_quantize(x, self.block)
        return q.reshape(x.shape), s

    def dequantize(self, q: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return block_dequantize(q.reshape(*s.shape, self.block), s, q.shape, dtype)

    def grad(self, g: torch.Tensor) -> torch.Tensor:
        return block_fake_quant(g, self.block) if self.grads else g


# ---------------------------------------------------------------------------
# Per-leaf comm decisions over the rank's specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Leaf:
    """The comm decision for one parameter leaf: ``active`` (a gather moves
    it), ``quant`` (on the int8 path), and the reference's ``pin`` (the
    spec fitted to the leaf) and ``gathered`` (with the gathered axes
    stripped) specs."""
    shape: tuple
    spec: tuple
    active: bool
    quant: bool
    pin: tuple
    gathered: tuple


def fit_spec(spec: tuple, shape: tuple, sizes: Mapping[str, int]) -> tuple:
    """Drop the entries the leaf cannot carry: axes missing from the mesh
    or not dividing the dim fall back to replication."""
    out = []
    for dim, entry in zip(shape, spec):
        axes = cpl.entry_axes(entry)
        if not axes or any(a not in sizes for a in axes):
            out.append(None)
            continue
        size = cpl.entry_size(entry, sizes)
        out.append(entry if size <= 1 or dim % size == 0 else None)
    return tuple(out)


def leaf_decision(cp: cpl.CommPlan, shape: tuple, spec: tuple,
                  sizes: Mapping[str, int]) -> Leaf:
    shape, spec = tuple(shape), tuple(spec)
    strip = cp.strip_axes
    pin = fit_spec(cpl.pad_spec(spec, len(shape)), shape, sizes)
    return Leaf(shape, spec, cpl.gathers_over(spec, strip),
                cp.quantizes and cpl.quant_eligible(shape, spec, sizes, strip, cp.block),
                pin, cpl.strip_spec(pin, strip))


class CommExec:
    """The CommPlan bound to one rank's mesh and specs ({leaf: spec} and
    {leaf: whole shape}, dotted paths); ``pieces`` the leaves whose model
    dim is laid out as ``core/sharding.py:Pieces``."""

    def __init__(self, cp: cpl.CommPlan, mesh: MeshGroups, shapes: dict, specs: dict,
                 pieces: Mapping[str, shd.Pieces] | None = None):
        self.cp, self.mesh = cp, mesh
        self._stream = None         # the card's side stream of early gathers
        self.info = {k: leaf_decision(cp, shapes[k], spec, mesh.sizes)
                     for k, spec in specs.items()}
        self._quant = QuantGather(cp.block, cp.quantizes_grads) if cp.quantizes else None
        tp = mesh.sizes["model"]
        for k, piece in (pieces or {}).items():
            if k in self.info and self.info[k].quant and "model" in shd.spec_axes(specs[k]) \
                    and any((w // tp if split else w) % cp.block for w, split in piece.parts):
                raise NotImplementedError(
                    f"{k}: a quantization block would straddle the pieces of its model-axis "
                    f"block at tp={tp}, block={cp.block} (see ROADMAP.md, Queue 1)")

    def phases(self, path: str, lead: int = 0) -> tuple:
        """The (group, dim, axis) gather phases of leaf ``path``, the node
        phase first; ``lead`` leading dims of the stored leaf dropped (one
        layer's view of a stacked leaf).  Empty when no gather moves it."""
        info = self.info[path]
        if not info.active:
            return ()
        out = []
        for axis in (NODE, self.cp.data_axis):
            for i, entry in enumerate(info.spec):
                if axis in cpl.entry_axes(entry):
                    out.append((self.mesh.groups[axis], i - lead, axis))
        return tuple(out)

    def gather(self, path: str, block: torch.Tensor, lead: int = 0) -> Any:
        """``block`` (the rank's stored leaf, or one layer of it) as the
        model uses it: a :class:`LeafGather` over its phases (quantized
        where the plan quantizes it), or the block itself."""
        phases = self.phases(path, lead)
        if not phases:
            return block
        return LeafGather(block, phases, self._quant if self.info[path].quant else None)

    def layer_comm(self, dtype: torch.dtype, device: torch.device) -> "LayerComm | None":
        """The overlap hook over the layer stack (None without overlap),
        its gathers in ``dtype``, on a card issued from one side stream."""
        if not self.cp.overlap:
            return None
        if self._stream is None and device.type == "cuda":
            self._stream = torch.cuda.Stream(device)
        stack = {k: v for k, v in self.info.items() if k.startswith("layers.")}
        return LayerComm(self.cp, self.mesh.sizes, stack, dtype, self._stream)


def _leaf_gathers(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaf_gathers(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaf_gathers(v)
    elif isinstance(tree, LeafGather):
        yield tree


class LayerComm:
    """Chunked weight gathers for ``run_program``: the stacked leaves'
    decisions, the compute dtype their gathers run in and the stream they
    are issued from (None off a card)."""

    def __init__(self, cp: cpl.CommPlan, sizes: Mapping[str, int], info: dict,
                 dtype: torch.dtype, stream=None):
        self.cp, self.sizes, self.info = cp, sizes, info
        self.dtype, self.stream = dtype, stream

    def plan_chunks(self, n: int) -> int:
        """The largest chunk count <= ``overlap_chunks`` that divides ``n``
        and keeps every stacked leaf's leading-dim sharding divisible per
        chunk (the reference's rule)."""
        ways = [cpl.entry_size(cpl.pad_spec(i.spec, len(i.shape))[0], self.sizes)
                for i in self.info.values()]
        for chunks in range(min(self.cp.overlap_chunks, n), 1, -1):
            if n % chunks == 0 and all(w <= 1 or (n // chunks) % w == 0 for w in ways):
                return chunks
        return 1

    def prefetch(self, units: list) -> None:
        """Issue the gathers of ``units`` (one parameter tree of views each)
        now; each leaf's use waits on its own."""
        for leaf in _leaf_gathers(units):
            leaf.prefetch(self.dtype, self.stream)
