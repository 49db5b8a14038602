"""ComputePolicy: the compute-path knobs (a copy of ``repro/core/compute.py``).

  * ``remat`` — what a training step saves for the backward pass:
      - ``"full"`` — every layer body runs under
        ``torch.utils.checkpoint`` (non-reentrant): only layer boundaries
        are saved and everything inside is recomputed in the backward;
      - ``"none"`` — every intermediate is saved;
      - ``"selective"`` (save the matmul outputs) is not ported yet and
        raises (ROADMAP.md, Queue 1).
    The plain attention's query-chunk loop and the plain cross-entropy's
    token chunks stay checkpointed whatever ``remat`` says: their recompute
    is what keeps the scores and the (N, V) logits from being saved.
    Serving runs under ``torch.no_grad`` and checkpoints nothing.
  * ``kernels`` — route the norms, the MLP input half (SwiGLU gate or
    GELU), self-attention (forward and backward), the cross-entropy and the
    grouped expert MLPs through the hand-written CUDA kernels in
    ``repro_torch.kernels`` (their plain PyTorch versions on CPU tensors)
    instead of the plain layers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.utils.checkpoint

REMAT_MODES = ("full", "selective", "none")


def checkpointed(fn: Callable) -> Callable:
    """``fn`` recomputed in the backward (non-reentrant checkpoint) when a
    gradient is being recorded; called as it is otherwise.  The port's
    forward draws no random numbers, so the RNG state is not stashed."""
    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)
    return wrapped


@dataclasses.dataclass(frozen=True)
class ComputePolicy:
    remat: str = "full"        # full | selective | none
    kernels: bool = False      # hand-written CUDA kernels on the hot path

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(
                f"remat must be one of {REMAT_MODES}, got {self.remat!r}")

    def checkpoint(self, fn: Callable) -> Callable:
        """The remat wrapper of a layer body."""
        if self.remat == "full":
            return checkpointed(fn)
        if self.remat == "selective":
            raise NotImplementedError(
                "remat='selective' is not ported yet (see ROADMAP.md, Queue 1)")
        return fn


DEFAULT_POLICY = ComputePolicy()


def resolve(policy: ComputePolicy | None) -> ComputePolicy:
    """None -> the default (full remat, plain compute path)."""
    return DEFAULT_POLICY if policy is None else policy
