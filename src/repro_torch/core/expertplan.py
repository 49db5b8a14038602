"""ExpertPlan: the expert-count rules, the capacity maths and the analytic
predictors of the MoE family (a copy of ``repro/core/expertplan.py``).

``capacity`` is the single source of the per-expert slot count C that
``models/moe.py`` routes into and the grouped expert-MLP kernel's grid is
cut from.  ``round_experts`` / ``validate_experts`` are what
``ModelConfig.reduced`` needs to keep scaled-down configs shardable.
:class:`ExpertPlan` is the semantics of the ``ep`` plan axis;
:func:`dispatch_a2a_bytes` and :func:`predicted_drop_fraction` are what
``core/costmodel.py`` prices it with; ``models/moe.py:ExpertDispatch``
runs it.
"""
from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class ExpertPlan:
    """Semantics of one ``ParallelPlan(ep=...)`` configuration; ``ep == 1``
    replicates the experts."""
    ep: int = 1
    expert_axis: str = "expert"
    data_axis: str = "data"
    node_axis: str = "node"

    def __post_init__(self):
        if self.ep < 1:
            raise ValueError(f"ep must be >= 1, got {self.ep}")

    @property
    def enabled(self) -> bool:
        return self.ep > 1

    def validate_model(self, n_experts: int) -> None:
        validate_experts(n_experts, self.ep, where="ExpertPlan")

    def experts_per_shard(self, n_experts: int) -> int:
        self.validate_model(n_experts)
        return n_experts // max(self.ep, 1)


def dispatch_a2a_bytes(n_groups: int, n_experts: int, cap: int, d_model: int,
                       *, dp: int = 1, ep: int = 1, node: int = 1,
                       itemsize: int = 4, with_backward: bool = False) -> int:
    """Per-device all-to-all payload bytes for one MoE block's dispatch.

    The dispatched tensor is (G, E, C, d).  The forward reshards it twice
    (group-major to expert-major for dispatch, and back for combine), each
    one all-to-all whose operands sum to the *local* tensor:
    global_bytes / (dp * ep * node).  The backward of each reshard is the
    reverse one, so grad doubles the count."""
    global_b = n_groups * n_experts * cap * d_model * itemsize
    ways = max(dp * ep * node, 1)
    per_reshard = global_b // ways
    n_reshards = 4 if with_backward else 2
    return (0 if ep <= 1 else per_reshard * n_reshards)


def predicted_drop_fraction(top_k: int, n_experts: int,
                            capacity_factor: float, group_size: int) -> float:
    """Expected fraction of routed (token, k) assignments dropped to the
    capacity limit, under uniform routing.

    Per-expert load is ~Binomial(g*k, 1/E); with the normal approximation
    the expected overflow past C is E[max(X - C, 0)] =
    sigma*phi(z) - (C - mu)*(1 - Phi(z)) at z = (C - mu)/sigma, summed over
    experts and normalized by g*k.  cf >= 1 with many tokens per expert
    gives ~0; cf < 1 approaches 1 - cf."""
    g, k, E = group_size, max(top_k, 1), n_experts
    C = capacity(g, k, E, capacity_factor)
    n = g * k
    mu = n / E
    var = n * (1.0 / E) * (1.0 - 1.0 / E)
    if var <= 0.0:
        return max(0.0, (mu - C) / mu) if mu > 0 else 0.0
    sigma = math.sqrt(var)
    z = (C - mu) / sigma
    phi = math.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    big_phi = 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
    overflow = sigma * phi - (C - mu) * (1.0 - big_phi)
    return min(1.0, max(0.0, E * overflow / n))
