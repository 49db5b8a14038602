"""Expert-count rules and the capacity maths of the MoE family (the port's
own copy of the single-device part of ``repro/core/expertplan.py``).

``capacity`` is the single source of the per-expert slot count C that
``models/moe.py`` routes into and the grouped expert-MLP kernel's grid is
cut from.  ``round_experts`` / ``validate_experts`` are what
``ModelConfig.reduced`` needs to keep scaled-down configs shardable.
``ExpertPlan`` (the ``ep`` plan axis) waits for the parallel executor
(ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import math


class ExpertDivisibilityError(ValueError):
    """n_experts does not tile the requested expert-parallel degree."""


def round_experts(n_experts: int, ep: int) -> int:
    """Nearest ep-divisible expert count (>= ep; ties round up)."""
    if ep <= 1:
        return n_experts
    down = (n_experts // ep) * ep
    up = down + ep
    if down < ep:
        return up
    return up if (n_experts - down) >= (up - n_experts) else down


def validate_experts(n_experts: int, ep: int, *, where: str = "plan") -> None:
    """Raise :class:`ExpertDivisibilityError` unless ep divides n_experts."""
    if ep > 1 and n_experts % ep != 0:
        raise ExpertDivisibilityError(
            f"{where}: n_experts={n_experts} is not divisible by ep={ep}; "
            f"use round_experts({n_experts}, {ep}) = "
            f"{round_experts(n_experts, ep)}")


def capacity(group_size: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Per-expert slot count C = max(ceil(cf * g * k / E), 1)."""
    cap = int(math.ceil(capacity_factor * group_size * max(top_k, 1)
                        / n_experts))
    return max(cap, 1)
