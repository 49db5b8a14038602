"""Roofline terms of a step from its per-device FLOPs, bytes and collective
bytes (a copy of ``repro/analysis/roofline.py`` over the port's
``param_specs``; the dry run, ``launch/dryrun.py``, traces the three
counts):

    compute term    = FLOPs / peak FLOP/s
    memory term     = bytes / HBM bytes/s
    collective term = collective bytes / link bytes/s

The counts are per device (the dry run traces one rank), so each term is a
device's time.  The default machine is the H100 SXM, from its published
peaks: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s a
direction, 80 GB.  ``FRONTIER_MI250X`` is the paper's machine (one GCD).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.common import ModelConfig, flatten_specs
from repro_torch.models.model import param_specs


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float                 # bf16 dense, per device
    hbm_bw: float                     # bytes/s per device
    link_bw: float                    # bytes/s per device, one direction
    hbm_bytes: float


H100 = Hardware("h100_sxm", peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9,
                hbm_bytes=80e9)

# The paper's machine, for the cost-model reproduction.
FRONTIER_MI250X = Hardware(
    name="mi250x_gcd", peak_flops=191.5e12, hbm_bw=1638e9 / 2, link_bw=50e9,
    hbm_bytes=64e9,
)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound (the sum); the max of the three is the
        perfectly overlapped bound."""
        return self.compute_s + self.memory_s + self.collective_s

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
        }


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_device: float,
    chips: int,
    hw: Hardware = H100,
) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_per_device / hw.peak_flops,
        memory_s=bytes_per_device / hw.hbm_bw,
        collective_s=collective_bytes_per_device / hw.link_bw,
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        collective_bytes_per_device=collective_bytes_per_device,
        chips=chips,
    )


# ---------------------------------------------------------------------------
# MODEL_FLOPS: 6 N D (dense) / 6 N_active D (MoE); forward-only = 2 N D.
# ---------------------------------------------------------------------------

def param_counts(cfg: ModelConfig) -> dict[str, int]:
    """Total and active (per-token) parameter counts from the spec tree."""
    total = 0
    active = 0
    for path, spec in flatten_specs(param_specs(cfg)):
        n = int(np.prod(spec.shape))
        total += n
        keys = path.split(".")
        is_expert = "experts" in spec.axes
        is_embed = keys[-1] in ("embed", "lm_head") or keys[0] in ("embed", "lm_head")
        if is_expert:
            active += n * max(cfg.top_k, 1) // max(cfg.n_experts, 1)
        elif is_embed:
            # the logits product touches every vocab row, the lookup does not;
            # the convention counts the embedding whole either way
            active += n
        else:
            active += n
    return {"total": total, "active": active}


def model_flops(cfg: ModelConfig, *, tokens: int, kind: str) -> float:
    n = param_counts(cfg)["active"]
    if kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens  # prefill / decode forward-only


def useful_flops_ratio(cfg: ModelConfig, *, tokens: int, kind: str,
                       flops_per_device: float, chips: int) -> float:
    total = flops_per_device * chips
    if total <= 0:
        return float("nan")
    return model_flops(cfg, tokens=tokens, kind=kind) / total
