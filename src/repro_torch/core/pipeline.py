"""The pipeline's tick schedule (the tick maths of ``repro/core/pipeline.py``)
and the port's schedule planner.

The reference's GSPMD pipeline (``pipeline_spmd``) runs all forwards, then
all backwards (GPipe's order), in ticks:

  * ``v == 1``: logical stage ``s`` on pipe rank ``s``; microbatch ``j``
    reaches stage ``s`` at tick ``j + s``: ``m + p - 1`` ticks;
  * ``v > 1`` (Megatron's interleaved, round-robin assignment): rank ``d``
    hosts logical stages ``{d, d + p, ..., d + (v - 1) p}`` and the
    activations loop the ring ``v`` times.  Microbatches enter in waves of
    at most ``p``; each wave drains in ``S + p - 1`` ticks (``S = v p``)
    before the next enters.

:func:`schedule` gives each rank its ordered forward applications
``(tick, microbatch, logical stage)``; the executor
(``runtime/pipeline.py``) walks them, and the backward walks them in
reverse tick order.  Its tick count is :func:`spmd_schedule`'s, so
:func:`spmd_idle_fraction` is the bubble of what the executor runs.
"""
from __future__ import annotations

import dataclasses


def _waves(p: int, m: int) -> list[tuple[int, int]]:
    """Interleaved schedule: microbatches enter in waves of at most ``p``."""
    return [(s, min(p, m - s)) for s in range(0, m, p)]


def spmd_schedule(p: int, m: int, v: int = 1) -> tuple[int, int, int]:
    """``(total_ticks, stage_applications_per_tick_per_ring,
    useful_applications)`` of the reference's schedule: ``m + S - 1``
    ticks of ``p * v`` applications at ``v == 1``; ``ceil(m / p)`` waves of
    ``S + p - 1`` ticks of ``p`` applications at ``v > 1``."""
    S = v * p
    if v == 1:
        return m + S - 1, p * v, m * S
    ticks = sum(S + p - 1 for _ in _waves(p, m))
    return ticks, p, m * S


def spmd_idle_fraction(p: int, m: int, v: int = 1) -> float:
    """Idle fraction of that schedule; compare ``core.bubble.bubble_fraction``
    (equal at ``v == 1``, and for the interleaved path on one full wave)."""
    if p <= 1:
        return 0.0
    ticks, per_tick, useful = spmd_schedule(p, m, v)
    return 1.0 - useful / (ticks * per_tick)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The forward applications of every pipe rank: ``ranks[d]`` is rank
    ``d``'s ``(tick, microbatch, logical stage)`` in tick order."""
    p: int
    m: int
    v: int
    ticks: int
    ranks: tuple[tuple[tuple[int, int, int], ...], ...]

    @property
    def n_stages(self) -> int:
        return self.p * self.v

    def slot_of(self, stage: int) -> int:
        """The slot of logical stage ``stage`` among the ``v`` stages of the
        rank that hosts it (rank ``stage % p``)."""
        return stage // self.p


def schedule(p: int, m: int, v: int = 1) -> Schedule:
    """The planner: rank ``s % p`` applies logical stage ``s`` to microbatch
    ``j`` at tick ``j + s`` (``v == 1``), or at tick ``w0 + i + s`` for the
    ``i``-th microbatch of a wave entering at tick ``w0`` (``v > 1``)."""
    if min(p, m, v) < 1:
        raise ValueError(f"p, m and v must be >= 1, got {p}, {m}, {v}")
    S = v * p
    apps: list[list[tuple[int, int, int]]] = [[] for _ in range(p)]
    if v == 1:
        starts = [(0, 0, m)]
        ticks = m + S - 1
    else:
        starts = [(w * (S + p - 1), first, n) for w, (first, n) in enumerate(_waves(p, m))]
        ticks = len(starts) * (S + p - 1)
    for t0, first, n in starts:
        for i in range(n):
            for s in range(S):
                apps[s % p].append((t0 + i + s, first + i, s))
    return Schedule(p, m, v, ticks, tuple(tuple(sorted(a)) for a in apps))
