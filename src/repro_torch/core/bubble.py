"""Analytic pipeline-bubble model (a copy of ``repro/core/bubble.py``).

Bubble fraction = idle device-ticks / total device-ticks for one batch of
``m`` microbatches through ``p`` stages (``v`` interleaved virtual stage
groups per device):

  * GPipe / all-forward-all-backward: (p - 1) / (m + p - 1)
  * 1F1B (PipeDream non-interleaved):  (p - 1) / (m + p - 1)  (same bubble,
    lower activation memory: p in-flight microbatches instead of m)
  * 1F1B interleaved:                 (p - 1) / (v * m + p - 1)

The paper quotes the approximate forms (p-1)/m and (p-1)/(m v); both are
provided.  ``core/pipeline.py:spmd_idle_fraction`` is the bubble of the
schedule the port's executor walks, to be read beside these.
"""
from __future__ import annotations

import dataclasses


def bubble_fraction(p: int, m: int, v: int = 1, *, schedule: str = "1f1b",
                    approximate: bool = False) -> float:
    """Idle fraction of the steady pipeline for one batch."""
    if p <= 1:
        return 0.0
    if schedule not in ("gpipe", "1f1b", "1f1b_interleaved"):
        raise ValueError(schedule)
    veff = v if schedule == "1f1b_interleaved" else 1
    if approximate:  # the paper's form
        return (p - 1) / (m * veff)
    return (p - 1) / (m * veff + p - 1)


def pipeline_efficiency(p: int, m: int, v: int = 1, schedule: str = "1f1b") -> float:
    return 1.0 - bubble_fraction(p, m, v, schedule=schedule)


def wave_bubble_fraction(p: int, m: int, v: int) -> float:
    """Bubble of the wave-based interleaved schedule (``virtual_stages > 1``):
    microbatches enter in waves of at most ``p``; each wave drains in
    ``S + p - 1`` ticks of one 1/v-depth stage application per rank.
    Equals ``bubble_fraction(p, m, v, "1f1b_interleaved")`` for one full
    wave (``m == p``), and shrinks with ``v``."""
    if p <= 1:
        return 0.0
    S = p * v
    waves = -(-m // p)
    ticks = waves * (S + p - 1)
    return 1.0 - (m * S) / (p * ticks)


@dataclasses.dataclass(frozen=True)
class PipelineMemory:
    """Peak in-flight activation copies per device (relative units)."""
    schedule: str
    p: int
    m: int
    v: int = 1

    @property
    def inflight_microbatches(self) -> int:
        # GPipe holds all m microbatch activations until backward;
        # 1F1B holds at most p (stage-depth) microbatches.
        if self.schedule == "gpipe":
            return self.m
        if self.schedule == "1f1b":
            return min(self.p, self.m)
        return min(self.p * self.v, self.m * self.v)


def min_microbatches_for_efficiency(p: int, target_eff: float, v: int = 1) -> int:
    """The paper's 'saturate the pipeline' rule: the least m whose bubble is
    at most 1 - target_eff."""
    if p <= 1:
        return 1
    m = 1
    while pipeline_efficiency(p, m, v, "1f1b_interleaved" if v > 1 else "1f1b") < target_eff:
        m += 1
        if m > 100_000:
            break
    return m
