"""AdamW on fp32 master weights (a copy of ``repro/optim/adam.py``).

The state mirrors the parameters: ``mu`` and ``nu`` in fp32 (the paper's
Table II "4 bytes/param optimizer states" each) and a step counter.  Unlike
the reference, whose arrays are immutable, :func:`adamw_update` updates the
parameters and the moments in place: a second copy of the 16 bytes per
parameter of training state would not fit beside the first on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[int], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float | None = 1.0

    def lr_at(self, step: int) -> float:
        return float(self.lr(step)) if callable(self.lr) else float(self.lr)


def adamw_init(params: dict[str, torch.Tensor]) -> dict:
    """params: {name: tensor} -> {"mu", "nu": {name: fp32 zeros}, "count": 0}."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"mu": {k: zeros(p) for k, p in params.items()},
            "nu": {k: zeros(p) for k, p in params.items()},
            "count": 0}


def global_norm(tensors, group=None, device: torch.device | None = None) -> torch.Tensor:
    """fp32 L2 norm over an iterable of tensors (0-d, on their device).
    With ``group`` the sum of squares is all-reduced over its ranks: each
    passes the blocks it counts (a leaf replicated over ranks on one of
    them, so none may be left) and ``device``."""
    sq = sum(t.float().square().sum() for t in tensors)
    if group is not None:
        sq = torch.as_tensor(sq, dtype=torch.float32, device=device)
        dist.all_reduce(sq, group=group)
    return torch.sqrt(sq)


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float,
                        norm: torch.Tensor | None = None
                        ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """``grads`` scaled to a global norm of at most ``max_norm``; ``norm``
    is their global norm (taken here when not given: a rank holding blocks
    passes the one :func:`global_norm` takes over its group)."""
    if norm is None:
        norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def _decay_mask(params: dict[str, torch.Tensor]) -> dict[str, float]:
    """No weight decay on vectors (norms, biases, per-head scalars).  A
    rank's block of a leaf keeps the rank of the whole leaf, so the mask of
    the blocks is the whole leaves'."""
    return {k: float(p.ndim >= 2) for k, p in params.items()}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: dict, *,
                 skip: bool = False, grad_norm: torch.Tensor | None = None) -> dict:
    """One AdamW step, in place on ``params`` and the moments of ``state``;
    returns ``state`` with the new count.  ``skip`` (an fp16 step whose
    scaled gradients overflowed) leaves parameters and state as they are.
    ``grad_norm``, the gradients' global norm, is what the clip divides by
    (taken from ``grads`` when not given)."""
    if skip:
        return state
    count = state["count"] + 1
    b1, b2 = cfg.b1, cfg.b2
    lr = cfg.lr_at(count)
    c1 = 1.0 - b1 ** count
    c2 = 1.0 - b2 ** count
    mask = _decay_mask(params)
    if cfg.grad_clip is not None:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip, grad_norm)
    for k, p in params.items():
        g = grads[k].float()
        mu, nu = state["mu"][k], state["nu"][k]
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        step = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        if mask[k]:
            step.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_((p.float() - lr * step).to(p.dtype))
    state["count"] = count
    return state
