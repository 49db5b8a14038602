"""Serving loops (port of ``repro/runtime/serve_loop.py``, single device).

PyTorch runs eagerly, so the build_* functions return plain callables where the JAX
package returns jitted ones; the model holds its own weights.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import Model


def build_prefill(model: Model, cache_len: int, *,
                  with_lens: bool = False) -> Callable:
    """Prefill at a fixed cache length; ``with_lens=True`` takes the
    per-request true lengths (length-bucketed serving prefill)."""
    if with_lens:
        def prefill_lens(batch, lens):
            return model.prefill(batch, cache_len, lens=lens)
        return prefill_lens

    def prefill(batch):
        return model.prefill(batch, cache_len)
    return prefill


def build_decode_step(model: Model) -> Callable:
    def decode_step(cache, batch):
        return model.decode_step(cache, batch)
    return decode_step


def greedy_generate(model: Model, prompt: torch.Tensor, n_steps: int,
                    cache_len: int) -> torch.Tensor:
    """Greedy loop, the temperature-0 reference that the serve engine must
    match token for token: prompt (B, S) -> (B, n_steps) ids."""
    logits, cache = model.prefill({"tokens": prompt}, cache_len)
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    decode = build_decode_step(model)
    outs = [tok]
    for _ in range(n_steps - 1):
        logits, cache = decode(cache, {"token": tok})
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        outs.append(tok)
    return torch.cat(outs, dim=1)
