"""Per-request token sampling (port of ``repro/runtime/sampling.py``).

Temperature <= 0 is an exact argmax over the raw logits, the rule of
``serve_loop.greedy_generate``.  Above 0, request ``r`` at generation step
``s`` draws from a ``torch.Generator`` seeded from ``(seed_r, s)`` alone, so
its stream does not depend on its slot, on the other requests of the tick
or on an eviction's replay.  JAX's Threefry bits cannot be matched; the
draws are torch's.
"""
from __future__ import annotations

import torch


_MASK64 = (1 << 64) - 1


def _generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """A generator keyed by (seed, step) through a splitmix64 finalizer, so
    that the low 32 bits (all the CPU generator keeps) depend on both."""
    x = ((int(seed) & 0xFFFFFFFF) << 32 | (int(step) & 0xFFFFFFFF))
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    g = torch.Generator(device=device)
    g.manual_seed(x ^ (x >> 31))
    return g


def _nucleus_one(logits: torch.Tensor, temp: float, top_p: float,
                 seed: int, step: int) -> int:
    scaled = logits.float() / max(temp, 1e-6)
    ranked, order = torch.sort(scaled, descending=True)
    probs = torch.softmax(ranked, dim=-1)
    # keep the smallest prefix with mass >= top_p (the head token always)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    probs = torch.where(keep, probs, torch.zeros_like(probs))
    idx = torch.multinomial(probs, 1, generator=_generator(seed, step, logits.device))
    return int(order[idx])


def sample_tokens(logits: torch.Tensor, temps: list[float], top_ps: list[float],
                  seeds: list[int], steps: list[int]) -> list[int]:
    """(B, V) logits + per-request knobs -> B token ids.  ``steps`` is each
    request's generation index (0 = the token from its prefill logits)."""
    greedy = torch.argmax(logits, dim=-1).tolist()
    return [g if t <= 0.0 else _nucleus_one(logits[i], t, p, s, n)
            for i, (g, t, p, s, n) in enumerate(zip(greedy, temps, top_ps, seeds, steps))]
