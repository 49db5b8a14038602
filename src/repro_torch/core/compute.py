"""ComputePolicy: the compute-path knobs (a copy of ``repro/core/compute.py``).

  * ``remat`` — what a training step saves for the backward pass
    (full | selective | none); the serving path, which is all this package
    runs so far, has no backward and ignores it.
  * ``kernels`` — route RMSNorm, the SwiGLU gate and prefill self-attention
    through the hand-written CUDA kernels in ``repro_torch.kernels`` (their
    plain PyTorch versions on CPU tensors) instead of the plain layers.
"""
from __future__ import annotations

import dataclasses

REMAT_MODES = ("full", "selective", "none")


@dataclasses.dataclass(frozen=True)
class ComputePolicy:
    remat: str = "full"        # full | selective | none
    kernels: bool = False      # hand-written CUDA kernels on the hot path

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(
                f"remat must be one of {REMAT_MODES}, got {self.remat!r}")


DEFAULT_POLICY = ComputePolicy()


def resolve(policy: ComputePolicy | None) -> ComputePolicy:
    """None -> the default (full remat, plain compute path)."""
    return DEFAULT_POLICY if policy is None else policy
