"""Analytic FLOPs of a train step and the H100 machine, for MFU (the dense,
hybrid and rwkv parts of ``repro/core/costmodel.py:train_step_flops``; the reference's
``Machine`` table has only Frontier and TPU v5e, so the port defines its
card here)."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.common import flatten_specs
from repro_torch.models.model import param_specs
from repro_torch.models.ssm import d_inner


@dataclasses.dataclass(frozen=True)
class Machine:
    name: str
    peak_flops: float     # dense bf16 tensor-core rate, per card
    hbm_bw: float         # bytes/s


# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
H100 = Machine(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12)


@dataclasses.dataclass(frozen=True)
class StepFlops:
    """Analytic model FLOPs of one optimizer step."""
    matmul: float       # every >= 2D parameter leaf
    attn: float         # softmax-attention quadratic
    scan: float         # recurrent token mixing (rwkv wkv, mamba scan; 0 for dense)
    tokens: int         # gbs * seq

    @property
    def total(self) -> float:
        return self.matmul + self.attn + self.scan


def train_step_flops(cfg, global_batch: int, seq_len: int,
                     *, backward: bool = True) -> StepFlops:
    """Model FLOPs of one train step of a dense, hybrid or rwkv model: 6 per
    matmul parameter per token (2 without the backward; the untied
    embedding is a lookup and not billed; the hybrid family's weight-tied
    shared block is billed once per application) plus the attention
    quadratic 4 Tq Tkv h hd per self-attention layer and sequence (hybrid:
    one per application of the shared block; rwkv: none) and the scan's
    per token and layer, 6 d_inner ssm_state (hybrid) or 4 d hd (rwkv's wkv
    state update and read-out), both tripled with the backward.  MFU, not
    HFU: remat's recompute is not counted."""
    if cfg.family not in ("dense", "hybrid", "rwkv"):
        raise NotImplementedError(
            f"train_step_flops for family {cfg.family!r} is not ported yet "
            "(see ROADMAP.md, Queue 1)")
    per_param = 6.0 if backward else 2.0
    mult = per_param / 2.0
    B, s = global_batch, seq_len
    hybrid = cfg.family == "hybrid"
    n_shared_apps = (cfg.n_layers // cfg.hybrid_attn_every
                     if hybrid and cfg.hybrid_attn_every else 1)
    n = 0.0
    for path, spec in flatten_specs(param_specs(cfg)):
        if len(spec.shape) < 2 or (path == "embed" and not cfg.tie_embeddings):
            continue
        n += float(np.prod(spec.shape)) * (n_shared_apps if path.startswith("shared.") else 1)
    t_kv = min(s, cfg.sliding_window) if cfg.sliding_window else s
    if hybrid:
        n_self = n_shared_apps if cfg.hybrid_attn_every else 0
    else:
        n_self = 0 if cfg.family == "rwkv" else cfg.n_layers
    attn = mult * 4.0 * B * cfg.n_heads * cfg.resolved_head_dim * n_self * s * t_kv
    scan = 0.0
    if hybrid:
        scan = mult * B * s * cfg.n_layers * 6.0 * d_inner(cfg) * max(cfg.ssm_state, 1)
    elif cfg.family == "rwkv":
        scan = mult * B * s * cfg.n_layers * 4.0 * cfg.d_model * cfg.resolved_head_dim
    return StepFlops(matmul=per_param * n * B * s, attn=attn, scan=scan, tokens=B * s)


def mfu(flops_per_step: float, step_time_s: float, peak_flops: float) -> float:
    """Model-FLOPs utilization of one card: analytic step FLOPs over what it
    could have done in the measured wall time."""
    denom = step_time_s * peak_flops
    return flops_per_step / denom if denom > 0 else 0.0
