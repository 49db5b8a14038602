"""Mixed-precision policy and loss scaling (a copy of
``repro/core/precision.py``).

Master weights are stored in ``param_dtype`` (fp32), the layer math runs in
``compute_dtype``, logits and the loss in ``output_dtype``.  fp16 uses
dynamic loss scaling as APEX/DeepSpeed do:

  * the scale starts at ``init_scale``
  * on any non-finite gradient the step is skipped and the scale halves
  * after ``growth_interval`` consecutive good steps the scale doubles

The loss-scale state is a dict of 0-d tensors, updated without reading it
back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32     # master weights
    compute_dtype: torch.dtype = torch.bfloat16  # matmul/activation dtype
    output_dtype: torch.dtype = torch.float32    # logits / loss dtype


def policy_from_name(name: str) -> Policy:
    name = name.lower()
    if name in ("bf16", "bfloat16", "mixed_bf16"):
        return Policy(torch.float32, torch.bfloat16, torch.float32)
    if name in ("fp16", "float16", "mixed_fp16"):
        return Policy(torch.float32, torch.float16, torch.float32)
    if name in ("fp32", "float32"):
        return Policy(torch.float32, torch.float32, torch.float32)
    raise ValueError(f"unknown precision policy {name!r}")


def init_loss_scale(enabled: bool, init_scale: float = 2.0 ** 15,
                    device: str | torch.device = "cpu") -> dict:
    return {
        "scale": torch.tensor(init_scale if enabled else 1.0, dtype=torch.float32,
                              device=device),
        "good_steps": torch.tensor(0, dtype=torch.int32, device=device),
        "enabled": enabled,
    }


def scale_loss(loss_scale: dict, loss: torch.Tensor) -> torch.Tensor:
    return loss * loss_scale["scale"].to(loss.dtype)


def all_finite(tensors: Any) -> torch.Tensor:
    """0-d bool: every floating tensor of the iterable is finite."""
    flags = [torch.isfinite(t).all() for t in tensors if t.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


def update_loss_scale(
    loss_scale: dict, grads_finite: torch.Tensor, *, growth_interval: int = 2000,
    growth_factor: float = 2.0, backoff_factor: float = 0.5,
    max_scale: float = 2.0 ** 24, min_scale: float = 1.0,
) -> dict:
    if not loss_scale["enabled"]:
        return loss_scale
    scale = loss_scale["scale"]
    good = loss_scale["good_steps"]
    new_good = torch.where(grads_finite, good + 1, torch.zeros_like(good))
    grow = new_good >= growth_interval
    new_scale = torch.where(
        grads_finite,
        torch.where(grow, torch.clamp(scale * growth_factor, max=max_scale), scale),
        torch.clamp(scale * backoff_factor, min=min_scale))
    new_good = torch.where(grow, torch.zeros_like(new_good), new_good)
    return {"scale": new_scale, "good_steps": new_good, "enabled": True}
