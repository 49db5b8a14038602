"""MemoryPlan: the ZeRO stage (0|1|2|3) as a plan axis (a copy of
``repro/core/memplan.py`` over plain ``{leaf: spec}`` dicts).

Stage semantics, as the port's executor (``runtime/train_loop.py``) runs
them over the data-parallel process group:

  * **0** — plain DP: params, grads and optimizer states replicated over
    the data ranks; grads all-reduced at the end of the step.
  * **1** — optimizer-state sharding: Adam's mu/nu hold one block of each
    leaf along its data dim; the all-reduced gradient is sliced at the
    update and the updated blocks are all-gathered into the parameters.
  * **2** — gradient sharding: each microbatch's gradient is
    reduce-scattered into an fp32 accumulator of the same block, instead
    of all-reducing full gradients at the end.
  * **3** — parameter sharding: every parameter holds only its block;
    a layer's leaves are all-gathered in the compute dtype on use and
    their fp32 gradients reduce-scattered into the blocks.

Which dim takes the data axis: the first divisible, unsharded one
(``sharding.zero_partition_spec``), except that a stacked leaf's leading
``layers`` dim is skipped, so that every rank holds a block of every layer
and a layer's gather is an all-gather (the reference's first fit lands on
the layer dim, making it a broadcast from the rank that owns the layer).
The bytes per rank are the same wherever the dims divide; a stacked leaf
with no divisible dim after the layer dim stays replicated.  A data axis of
size 1 is placed all the same (``unit_axes``): a one-rank plan runs the
same gathers and reduce-scatters as any other.  Under the hierarchical
CommPlan (``node_axis``, a node axis of more than one rank) each stage
also adds the node axis, on the next free divisible dim or composite with
the data axis (``sharding.zero_partition_spec``): the state is then 1 /
(dp x node) of the leaf per rank.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from repro_torch.core import sharding as shd

STAGES = (0, 1, 2, 3)


def resolve_stage(zero: int | None, zero1: object = None) -> int:
    """``zero`` as a stage; None is stage 1 (the paper's baseline).  The
    removed ``zero1`` alias raises."""
    if zero1 is not None:
        raise ValueError(
            "zero1= has been removed; pass zero=0|1|2|3 instead "
            "(zero1=True was zero=1, zero1=False was zero=0)")
    if zero is None:
        return 1
    if zero not in STAGES:
        raise ValueError(f"zero must be one of {STAGES}, got {zero!r}")
    return int(zero)


def data_spec(shape: tuple[int, ...], axes: tuple[str | None, ...], spec: shd.Spec,
              sizes: Mapping[str, int], data_axis: str,
              node_axis: str | None = None) -> shd.Spec:
    """``spec`` with the data axis (and ``node_axis``) on the leaf's first
    divisible free dims, past a leading ``layers`` dim (see the module
    docstring)."""
    if axes and axes[0] == "layers":
        return spec[:1] + shd.zero_partition_spec(shape[1:], spec[1:], sizes, data_axis,
                                                  unit_axes=True, node_axis=node_axis)
    return shd.zero_partition_spec(shape, spec, sizes, data_axis, unit_axes=True,
                                   node_axis=node_axis)


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """Which training state is sharded over the data axis."""

    zero: int = 1
    data_axis: str = "data"
    node_axis: str | None = None    # hierarchical CommPlan: a second ZeRO axis

    def __post_init__(self):
        if self.zero not in STAGES:
            raise ValueError(f"zero must be one of {STAGES}, got {self.zero!r}")

    @property
    def shards_optimizer(self) -> bool:
        return self.zero >= 1

    @property
    def shards_grads(self) -> bool:
        return self.zero >= 2

    @property
    def shards_params(self) -> bool:
        return self.zero >= 3

    def _add_data(self, on: bool, shapes: dict, axes: dict, specs: dict,
                  sizes: Mapping[str, int]) -> dict:
        if not on:
            return specs
        return {k: data_spec(shapes[k], axes[k], specs[k], sizes, self.data_axis,
                             self.node_axis) for k in specs}

    def param_shardings(self, shapes: dict, axes: dict, base: dict,
                        sizes: Mapping[str, int]) -> dict:
        """Stage 3: the data axis on every parameter leaf."""
        return self._add_data(self.shards_params, shapes, axes, base, sizes)

    def grad_shardings(self, shapes: dict, axes: dict, params: dict,
                       sizes: Mapping[str, int]) -> dict:
        """Stage >= 2: the fp32 gradient accumulator on the data axis."""
        return self._add_data(self.shards_grads, shapes, axes, params, sizes)

    def optimizer_shardings(self, shapes: dict, axes: dict, params: dict,
                            sizes: Mapping[str, int]) -> dict:
        """Stage >= 1: Adam's mu/nu on the data axis."""
        return self._add_data(self.shards_optimizer, shapes, axes, params, sizes)


def zero_divisors(zero: int, dp: int) -> tuple[int, int, int]:
    """(param_div, grad_div, opt_div): what each state class divides by
    under this stage (the paper's Table II columns)."""
    if zero not in STAGES:
        raise ValueError(f"zero must be one of {STAGES}, got {zero!r}")
    dp = max(int(dp), 1)
    return (dp if zero >= 3 else 1, dp if zero >= 2 else 1, dp if zero >= 1 else 1)


def table2_bytes_per_param(zero: int, dp: int, *, param_bytes: float = 2.0,
                           grad_bytes: float = 4.0,
                           opt_bytes: float = 12.0) -> dict[str, float]:
    """Table II's mixed-precision byte budget per parameter per device."""
    pd, gd, od = zero_divisors(zero, dp)
    out = {"params": param_bytes / pd, "grads": grad_bytes / gd, "opt": opt_bytes / od}
    out["total"] = out["params"] + out["grads"] + out["opt"]
    return out


def sharded_bytes(shapes: dict, specs: dict, sizes: Mapping[str, int], itemsize: int,
                  pieces: Mapping[str, shd.Pieces] | None = None) -> int:
    """Exact bytes one rank holds of a {leaf: shape} tree under
    {leaf: spec}: ``prod(shard_shape) * itemsize`` summed over the leaves
    (the leaves in ``pieces`` laid out by them over the model axis)."""
    pieces = pieces or {}
    return sum(int(np.prod(shd.shard_shape(shape, specs[k], sizes, pieces.get(k)),
                           dtype=np.int64)) * itemsize
               for k, shape in shapes.items())
