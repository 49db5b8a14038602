"""StageProgram: the family-agnostic layer-stack IR (the semantics of
``repro/core/stage_program.py``).

Each model family lowers its layer stack (``models/model.py:
Model.stage_program``) into an ordered list of :class:`Segment` s: a list
of per-unit parameter views in the storage dtype, and the body a unit
runs, ``body(unit_params, x, carry) -> (x, carry)``, with the
:class:`CarrySpec` tuple the program declares.  The body is the unit's
training step as the compute policy wraps it: the cast to the compute dtype
happens inside the remat wrapper, so the compute-dtype copies are
recomputed in the backward and the weight gradients arrive in fp32.

  * :func:`run_program`: the pp = 1 path, every unit in order;
  * :func:`split_stages`: cut the program into ``n_stages`` identical
    stages for the pipeline (``runtime/pipeline.py``).  A one-segment
    program splits on its unit list; a program of several segments splits
    on the segment list into structurally equal groups, its weight-tied
    segments (``tied``) closed over by every stage.

The carry rides along with the activation: ``"accum"`` carries are fp32
accumulators that start at zero (:meth:`StageProgram.init_carry`), the moe
family's load-balance loss ``aux`` and measured drop fraction
``moe_drop``, which the loss reduces after the last segment; the dense,
hybrid and rwkv programs carry the reference's single ``aux`` at 0, which
their bodies pass through untouched.  ``"input"`` carries are
per-microbatch tensors that every unit reads and none writes, given to
``init_carry``: the encdec decoder's ``memory`` (the encoder's output).
The recurrent families' state is sequence-level and layer-local, so it
never enters the carry.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


ACCUM = "accum"
INPUT = "input"


@dataclasses.dataclass(frozen=True)
class CarrySpec:
    """One entry of the cross-stage carry contract: an fp32 accumulator
    (``"accum"``) or a per-microbatch input every unit reads (``"input"``)."""
    name: str
    kind: str = ACCUM

    def __post_init__(self):
        if self.kind not in (ACCUM, INPUT):
            raise ValueError(f"carry kind must be {ACCUM!r} or {INPUT!r}, got {self.kind!r}")


@dataclasses.dataclass
class Segment:
    """A uniform run of ``n`` units: ``body`` applied to each of ``params``
    (one unit's parameter views each) in order.  ``tied`` marks a
    weight-tied segment: every occurrence in the program holds the same
    parameters, which :func:`split_stages` closes over instead of giving
    each stage its own."""
    name: str
    params: list
    n: int
    body: Callable[[Any, torch.Tensor, dict], tuple[torch.Tensor, dict]]
    tied: bool = False

    def __post_init__(self):
        if len(self.params) != self.n:
            raise ValueError(f"segment {self.name!r}: {len(self.params)} units, n={self.n}")


@dataclasses.dataclass
class StageProgram:
    segments: tuple[Segment, ...]
    carry_spec: tuple[CarrySpec, ...] = (CarrySpec("aux"),)

    def init_carry(self, device: torch.device | str | None = None,
                   inputs: dict | None = None) -> dict:
        """Every accumulator at an fp32 zero, every input carry from
        ``inputs`` (a missing one raises)."""
        inputs = inputs or {}
        carry = {}
        for cs in self.carry_spec:
            if cs.kind == ACCUM:
                carry[cs.name] = torch.zeros((), dtype=torch.float32, device=device)
            elif cs.name not in inputs:
                raise ValueError(f"carry input {cs.name!r} not provided")
            else:
                carry[cs.name] = inputs[cs.name]
        return carry

    @property
    def n_units(self) -> int:
        return sum(seg.n for seg in self.segments)


def _run(seg: Segment, units: list, x: torch.Tensor, carry: dict
         ) -> tuple[torch.Tensor, dict]:
    for lp in units:
        x, carry = seg.body(lp, x, carry)
    return x, carry


def run_program(program: StageProgram, x: torch.Tensor, carry: dict,
                comm: Any = None) -> tuple[torch.Tensor, dict]:
    """The non-pipelined executor: each segment's units in order.

    ``comm`` (a ``runtime/qcollect.py:LayerComm``) is the CommPlan's
    overlap hook: each untied segment's units are cut into
    ``comm.plan_chunks`` chunks, and chunk k + 1's weight gathers are
    issued (asynchronously) before chunk k's units run; each unit's use of
    a leaf waits on that leaf's gather.  Only the forward's gathers are
    issued early: a checkpointed unit's recompute gathers again, so no
    gathered chunk is kept for the backward.  With ``comm=None`` (or one
    chunk) every gather runs at its use."""
    for seg in program.segments:
        chunks = 1 if comm is None or seg.tied else comm.plan_chunks(seg.n)
        if chunks == 1:
            x, carry = _run(seg, seg.params, x, carry)
            continue
        per = seg.n // chunks
        comm.prefetch(seg.params[:per])
        for k in range(chunks):
            if k + 1 < chunks:
                comm.prefetch(seg.params[(k + 1) * per:(k + 2) * per])
            x, carry = _run(seg, seg.params[k * per:(k + 1) * per], x, carry)
    return x, carry


def units_error(name: str, n: int, n_stages: int) -> ValueError:
    """The error of a one-segment program whose units do not split."""
    return ValueError(f"segment {name!r} has {n} scan units, not divisible "
                      f"by pp*virtual_stages={n_stages}")


def _structure(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _check_groups_equal(chunks: list[list[Segment]]) -> None:
    ref = chunks[0]
    for c in chunks[1:]:
        for a, b in zip(ref, c):
            same = (a.name == b.name and a.n == b.n and a.tied == b.tied
                    and _structure(a.params) == _structure(b.params))
            if not same:
                raise ValueError(
                    "stage split requires structurally identical segment "
                    "groups per stage; got "
                    f"{[(s.name, s.n) for s in ref]} vs "
                    f"{[(s.name, s.n) for s in c]} — choose pp*virtual_stages "
                    "to divide the program's repeating pattern")
            if a.tied and any(x is not y for x, y in zip(_leaves(a.params),
                                                         _leaves(b.params))):
                raise ValueError(
                    f"tied segment {a.name!r} references different param "
                    "tensors across stages — tied segments must share one "
                    "set of weights (or drop tied=True to stack per-stage "
                    "copies)")


def split_stages(program: StageProgram, n_stages: int) -> tuple[list[tuple], Callable]:
    """Cut the program into ``n_stages`` identical stages.  Returns
    ``(stage_params, stage_fn)``: ``stage_params[s]`` is stage ``s``'s
    tuple of unit lists (one per untied segment of a stage), and
    ``stage_fn(stage_params[s], x, carry) -> (x, carry)`` runs stage ``s``;
    chained over the stages in order it is :func:`run_program`."""
    segs = program.segments
    if len(segs) == 1:
        seg = segs[0]
        if seg.n % n_stages:
            raise units_error(seg.name, seg.n, n_stages)
        per = seg.n // n_stages
        ref = [seg]
        stage_params = [(seg.params[s * per:(s + 1) * per],) for s in range(n_stages)]
    else:
        if len(segs) % n_stages:
            raise ValueError(
                f"program has {len(segs)} segments ({[s.name for s in segs]}), not "
                f"divisible by pp*virtual_stages={n_stages}")
        k = len(segs) // n_stages
        chunks = [list(segs[i * k:(i + 1) * k]) for i in range(n_stages)]
        _check_groups_equal(chunks)
        ref = chunks[0]
        stage_params = [tuple(seg.params for seg in c if not seg.tied) for c in chunks]

    def stage_fn(sp_slice: tuple, x: torch.Tensor, carry: dict
                 ) -> tuple[torch.Tensor, dict]:
        it = iter(sp_slice)
        for seg in ref:
            x, carry = _run(seg, seg.params if seg.tied else next(it), x, carry)
        return x, carry

    return stage_params, stage_fn
