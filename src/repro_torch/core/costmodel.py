"""Analytic performance/memory model of 3D-parallel GPT training (a copy
of ``repro/core/costmodel.py``) and the port's MFU numerator.

The paper's empirical studies as a model: the same (TP, PP, MBS, GAS,
ZeRO stage, #nodes) knobs, evaluated against a machine model.  It
reproduces, structurally, Observations III.1-III.4, the Table V recipe
throughputs and the Fig. 12/13 scaling curves, and is the objective of the
DeepHyper-style search in ``core/hpo.py`` (OOM failures penalized).

Time per optimizer step (m = GAS microbatches):

    T = (m + p - 1) * (t_comp + t_tp + t_attn_mem + t_pp) + t_dp + t_opt

with the bubble entering through (m + p - 1)/m, TP all-reduces 4x per
layer at the bandwidth tier of the TP group span, and the DP gradient
reduce-scatter/all-gather at the end.  ``FRONTIER``'s constants were
calibrated once by the reference against the paper's 22B recipe (38.38%
of peak) and frozen.  ``H100`` is the port's card: its data-sheet rates,
and a ``matmul_eff`` measured on the card (``chip_smoke.py``'s GEMM
reading); the constants no run measured say so.  The CommPlan terms
(``core/commplan.py``: node, qcomm, overlap) and the ExpertPlan terms
(``core/expertplan.py``: the ep all-to-all, the capacity drop) are the
reference's; the port's executor runs both (``runtime/qcollect.py``,
``models/moe.py:ExpertDispatch``), and its byte counters are read against
:func:`predict_comm_bytes` and :func:`predict_a2a_bytes`.

:func:`train_step_flops` is the model FLOPs of a step (the MFU numerator
``core/telemetry.py`` reads); :func:`predict_step` prices an actual
(ModelConfig, ParallelPlan) run, the anchor of the telemetry's drift.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.core import commplan, expertplan, memplan


@dataclasses.dataclass(frozen=True)
class GPTSize:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    vocab: int = 51200
    seq: int = 2048

    @property
    def n_params(self) -> float:
        return 12.0 * self.n_layers * self.d_model ** 2


# Table I
GPT_1p4B = GPTSize("1.4B", 24, 2112, 24)
GPT_22B = GPTSize("22B", 48, 6144, 48)
GPT_175B = GPTSize("175B", 96, 12288, 96)
GPT_1T = GPTSize("1T", 128, 25600, 128)
MODELS = {m.name: m for m in (GPT_1p4B, GPT_22B, GPT_175B, GPT_1T)}


@dataclasses.dataclass(frozen=True)
class Machine:
    name: str
    gpus_per_node: int
    peak_flops: float            # per GPU (GCD / chip)
    hbm_bytes: float
    hbm_bw: float
    matmul_eff: float            # achievable fraction of peak on big GEMMs
    internode_bw: float          # per-GPU share of the NIC, bytes/s
    dp_contention_alpha: float   # extra DP all-reduce cost per log2(nodes)
    # intra-node collective bandwidth per GPU (Infinity Fabric / ICI tier);
    # the two-tier CommPlan model routes the hierarchical intra-node phase
    # here and only the inter-node phase over the NIC share above
    intranode_bw: float = 100e9

    def tp_bandwidth(self, tp: int) -> float:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FrontierMachine(Machine):
    def tp_bandwidth(self, tp: int) -> float:
        # Fig 5: 4x(50+50) GB/s within a die pair, half across dies,
        # 25+25 GB/s across nodes.
        if tp <= 2:
            return 200e9
        if tp <= 4:
            return 100e9
        if tp <= 8:
            return 100e9
        return 25e9  # beyond a node: ethernet/Slingshot


FRONTIER = FrontierMachine(
    name="frontier_mi250x_gcd",
    gpus_per_node=8,
    peak_flops=191.5e12,
    hbm_bytes=64e9,
    hbm_bw=1.6e12,
    matmul_eff=0.59,   # calibrated once on the paper's 22B recipe, then frozen
    internode_bw=25e9,
    dp_contention_alpha=0.018,
    intranode_bw=100e9,   # Fig 5: 50+50 GB/s per IF link between GCDs
)


@dataclasses.dataclass(frozen=True)
class H100Machine(Machine):
    def tp_bandwidth(self, tp: int) -> float:
        # NVLink 4 within a node: 18 links x 25 GB/s each way per card;
        # beyond a node the NIC share
        if tp <= self.gpus_per_node:
            return 450e9
        return self.internode_bw


# NVIDIA H100 SXM 80GB: the data sheet's dense bf16 rate, HBM3 size and
# rate, 8 cards to a node on NVLink (HGX H100)
H100 = H100Machine(
    name="h100-sxm",
    gpus_per_node=8,
    peak_flops=989e12,
    hbm_bytes=80e9,
    hbm_bw=3.35e12,
    # a cuBLAS bf16 GEMM of 8192^3 over the peak, chip_smoke.py's phase
    # "gemm": 767.4 TFLOP/s on an NVIDIA H100 80GB HBM3 at its 700 W limit
    matmul_eff=0.7759,
    # not measured (one host only): 8 x 400 Gb/s NICs of an HGX node, a
    # card's share
    internode_bw=50e9,
    # not measured: the Frontier calibration's value
    dp_contention_alpha=0.018,
    intranode_bw=450e9,   # NVLink 4, one direction
)


@dataclasses.dataclass(frozen=True)
class ParallelCfg:
    tp: int = 1
    pp: int = 1
    mbs: int = 1
    gas: int = 1                 # = number of microbatches m
    dp: int = 1                  # intra-node data ways when node > 1
    zero: int = 1                # ZeRO stage 0|1|2|3 (core/memplan.py)
    node: int = 1                # inter-node data ways (hierarchical mesh)
    qcomm: str = "none"          # none|gather|both (commplan.QCOMM_MODES)
    overlap: bool = False        # overlap zero=3 gathers with compute
    comm_block: int = 32         # int8 quantization block size
    flash_attention: bool = True
    checkpoint_activations: bool = True
    # --- ExpertPlan (core/expertplan.py): MoE expert parallelism ---
    ep: int = 1                  # expert-parallel ways ("expert" mesh axis)
    n_experts: int = 0           # 0 = dense model (no MoE terms billed)
    top_k: int = 1               # routed experts per token
    capacity_factor: float = 1.0  # slots per expert = cf * tokens*k/E

    @property
    def zero_stage(self) -> int:
        if self.zero not in memplan.STAGES:
            raise ValueError(f"zero must be in {memplan.STAGES}")
        return self.zero

    @property
    def comm_plan(self) -> commplan.CommPlan:
        return commplan.CommPlan(qcomm=self.qcomm, block=self.comm_block,
                                 overlap=self.overlap, node=self.node)

    @property
    def expert_plan(self) -> expertplan.ExpertPlan:
        return expertplan.ExpertPlan(ep=self.ep)

    @property
    def n_gpus(self) -> int:
        return self.tp * self.pp * self.dp * self.ep * self.node

    @property
    def gbs(self) -> int:
        # the "expert" axis carries batch groups too (batch is sharded over
        # (data, expert) under ep > 1 — runtime/train_loop.py), so ep
        # multiplies the data ways like dp and node do
        return self.mbs * self.gas * self.dp * self.ep * self.node


@dataclasses.dataclass
class Prediction:
    tflops_per_gpu: float
    pct_peak: float
    step_time_s: float
    memory_per_gpu: float
    oom: bool
    bubble: float
    breakdown: dict[str, float]
    # per-class state bytes (params/grads/opt/act) — Table II's structure,
    # divided per the ZeRO stage (core/memplan.py:zero_divisors)
    mem_breakdown: dict[str, float] = dataclasses.field(default_factory=dict)
    # predicted router capacity-overflow drop fraction (ExpertPlan's normal
    # approximation; 0.0 for dense models)
    moe_drop: float = 0.0
    # predicted per-device collective payload bytes per step, split by
    # mesh axis ({tp, ep, pp, dp, zero3_gather, total}): the analytic side
    # of the telemetry records' measured ``comm_bytes``
    comm_bytes: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def objective(self) -> float:
        """HPO objective (the paper maximizes achieved FLOPS); OOM -> fail."""
        return -1.0 if self.oom else self.tflops_per_gpu


def predict(model: GPTSize, cfg: ParallelCfg, machine: Machine = FRONTIER) -> Prediction:
    N = model.n_params
    s, d, L = model.seq, model.d_model, model.n_layers
    t, p, r, mbs, m = cfg.tp, cfg.pp, cfg.dp, cfg.mbs, cfg.gas
    peak = machine.peak_flops

    # ---------------- compute ----------------
    layers_per_stage = L / p
    # fwd+bwd GEMM flops per microbatch per device (checkpointing adds one
    # extra forward: factor 8 instead of 6 when enabled)
    factor = 8.0 if cfg.checkpoint_activations else 6.0
    gemm_flops = factor * mbs * s * (N / p) / t
    attn_flops = 2 * factor * mbs * s * s * d * layers_per_stage / t  # QK^T + AV
    # sharded GEMMs (weights d/t wide) and tiny microbatches run below the
    # big-GEMM roofline — the geometry effect behind Observation III.1
    geom_eff = (1.0 - 0.04 * math.log2(max(t, 1))) * (1.0 - 0.05 / max(mbs, 1))
    eff = machine.matmul_eff * geom_eff
    t_comp = (gemm_flops + attn_flops) / (peak * eff)

    # non-flash attention is memory-bound: it materializes s^2 scores many
    # times (fwd + recompute + bwd + softmax/mask/dropout passes) and
    # fragments the GEMM stream into small s x s tiles
    if cfg.flash_attention:
        t_attn_mem = 0.0
    else:
        heads_local = model.n_heads / t
        score_bytes = mbs * heads_local * s * s * 2.0
        t_attn_mem = 40.0 * score_bytes * layers_per_stage / machine.hbm_bw
        t_comp = t_comp / 0.88

    # per-device wire payloads per step, split by mesh axis: the analytic
    # side of the telemetry records' measured comm_bytes
    cbytes = {"tp": 0.0, "ep": 0.0, "pp": 0.0, "dp": 0.0, "zero3_gather": 0.0}
    ticks_sched = m + p - 1

    # ---------------- TP collective ----------------
    if t > 1:
        ar_vol = mbs * s * d * 2.0                      # activation, bf16/fp16
        ar_time = 2.0 * (t - 1) / t * ar_vol / machine.tp_bandwidth(t)
        t_tp = 4.0 * layers_per_stage * ar_time        # 2 fwd + 2 bwd per layer
        cbytes["tp"] = ticks_sched * 4.0 * layers_per_stage \
            * 2.0 * (t - 1) / t * ar_vol
    else:
        t_tp = 0.0

    # ---------------- EP token all-to-all ----------------
    # ExpertPlan: dispatch + combine reshard per MoE layer, forward and
    # backward (4 reshards/layer/microbatch), each moving the local
    # capacity-C slot tensor's (ep-1)/ep off-shard fraction over the
    # intra-node fabric tier (EP groups are packed within a node, like TP)
    e = cfg.ep
    if e > 1 and cfg.n_experts > 0:
        expertplan.validate_experts(cfg.n_experts, e,
                                    where=f"ParallelCfg(ep={e})")
        # local slot tensor per microbatch per layer: mbs*s tokens, top_k
        # slots each, capacity-factor headroom, d wide, bf16 wire
        a2a_vol = cfg.capacity_factor * mbs * s * cfg.top_k * d * 2.0
        t_ep = 4.0 * layers_per_stage * (e - 1) / e * a2a_vol / machine.intranode_bw
        cbytes["ep"] = ticks_sched * 4.0 * layers_per_stage \
            * (e - 1) / e * a2a_vol
        moe_drop = expertplan.predicted_drop_fraction(
            cfg.top_k, cfg.n_experts, cfg.capacity_factor, mbs * s)
    else:
        t_ep = 0.0
        moe_drop = (expertplan.predicted_drop_fraction(
            cfg.top_k, cfg.n_experts, cfg.capacity_factor, mbs * s)
            if cfg.n_experts > 0 else 0.0)

    # ---------------- PP point-to-point ----------------
    if p > 1:
        pp_vol = mbs * s * d * 2.0
        t_pp = 2.0 * 2.0 * pp_vol / machine.internode_bw   # fwd act + bwd grad
        cbytes["pp"] = ticks_sched * 2.0 * 2.0 * pp_vol
    else:
        t_pp = 0.0

    # ---------------- DP gradient reduction ----------------
    z = cfg.zero_stage
    nn = cfg.node
    R = r * nn                                         # total data ways
    if R > 1:
        grad_vol = 2.0 * N / (p * t)                   # fp16 gradients
        nodes = max(1, cfg.n_gpus // machine.gpus_per_node)
        contention = 1.0 + machine.dp_contention_alpha * math.log2(max(nodes, 1))
        # the NIC is shared by all GPUs of a node during the DP all-reduce
        dp_bw = machine.internode_bw / machine.gpus_per_node

        def dp_time(vol: float) -> float:
            """One all-gather (or reduce-scatter) of ``vol`` bytes over the
            data group.  Flat (node==1): a single ring over R ways on the
            NIC share.  Hierarchical: the CommPlan two-phase collective —
            an intra-node ring over dp ways at the Infinity-Fabric tier,
            then an inter-node ring over node ways moving only the 1/dp
            node-local shard across the NIC (the low-bandwidth win)."""
            if nn == 1:
                return (R - 1) / R * vol / dp_bw * contention
            intra = (r - 1) / r * vol / machine.intranode_bw if r > 1 else 0.0
            inter = (nn - 1) / nn * (vol / r) / dp_bw * contention
            return intra + inter

        def dp_vol_bytes(vol: float) -> float:
            """Wire bytes per device for one data-group collective of
            ``vol`` logical bytes (ring payload; hierarchical plans move
            the intra-node fraction plus the 1/dp node-local shard)."""
            if nn == 1:
                return (R - 1) / R * vol
            intra = (r - 1) / r * vol if r > 1 else 0.0
            return intra + (nn - 1) / nn * (vol / r)

        # qcomm wire discount: int8 payload + one fp32 scale per block,
        # relative to the 2-byte (bf16/fp16) wire format billed above
        q_itemsize = (commplan.QUANT_ITEMSIZE
                      + commplan.SCALE_ITEMSIZE / cfg.comm_block)
        q_discount = q_itemsize / 2.0

        if z >= 2:
            # each of the m microbatches reduce-scatters its full gradient
            # (m x half an all-reduce — the known GAS cost of gradient
            # sharding); stage 2 additionally all-gathers params after the
            # update (they are replicated below stage 3), stage 3 does not
            # — its gathers happen on use and are billed below.  The same
            # 1.05 protocol overhead as stage 1 keeps m=1 monotonic.
            halves = m + (1.0 if z == 2 else 0.0)
            g_disc = q_discount if cfg.qcomm == "both" else 1.0
            t_dp = halves * dp_time(grad_vol * g_disc) * 1.05
            cbytes["dp"] = halves * dp_vol_bytes(grad_vol * g_disc)
        else:
            t_dp = 2.0 * dp_time(grad_vol)
            cbytes["dp"] = 2.0 * dp_vol_bytes(grad_vol)
            if z >= 1:
                t_dp *= 1.05  # reduce-scatter + param all-gather ~ same volume
        if z >= 3:
            # ZeRO-3: weights all-gathered on use, *per microbatch* (the
            # 1/dp resident-param budget means each microbatch's forward,
            # backward, and checkpointing-replay forward re-gather)
            gathers = (3.0 if cfg.checkpoint_activations else 2.0) * m
            param_vol = 2.0 * N / (p * t)
            if cfg.qcomm in ("gather", "both"):
                param_vol *= q_discount
            t_gather = gathers * dp_time(param_vol)
            cbytes["zero3_gather"] = gathers * dp_vol_bytes(param_vol)
            if cfg.overlap:
                # per-segment prefetch hides gathers behind the GEMM
                # stream; only the residual past total compute is billed
                t_gather = max(t_gather - (m + p - 1) * t_comp, 0.0)
            t_dp += t_gather
    else:
        t_dp = 0.0

    # ---------------- optimizer ----------------
    t_opt = 14.0 * (N / (p * t)) / machine.hbm_bw       # streaming the state

    micro = t_comp + t_attn_mem + t_tp + t_ep + t_pp
    ticks = m + p - 1
    T = ticks * micro + t_dp + t_opt
    bubble = (p - 1) / ticks if p > 1 else 0.0

    # ---------------- memory ----------------
    # Table II's per-class byte budget: weights (bf16 + fp32 master) /
    # fp32 grad accumulator / Adam moments, each divided by dp when the
    # ZeRO stage shards that class (params at 3, grads at >= 2, opt >= 1)
    per_shard = N / (p * t)
    p_div, g_div, o_div = memplan.zero_divisors(z, R)
    mem_params = 6.0 * per_shard / p_div
    mem_grads = 4.0 * per_shard / g_div
    mem_opt = 4.0 * per_shard / o_div
    mem = mem_params + mem_grads + mem_opt
    inflight = min(m, p) if p > 1 else 1
    act_bytes_layer = mbs * s * d * 2.0
    c_act = 2.5 if cfg.checkpoint_activations else 12.0
    mem_act = inflight * act_bytes_layer * layers_per_stage * c_act / t
    if not cfg.flash_attention:
        mem_act += mbs * (model.n_heads / t) * s * s * 2.0 * 2  # live score blocks
    # logits workspace on the last stage
    mem_act += mbs * s * model.vocab * 4.0 / t
    mem += mem_act
    oom = mem > 0.92 * machine.hbm_bytes

    model_flops_step = 6.0 * N * cfg.gbs * s
    tflops = model_flops_step / (T * cfg.n_gpus) / 1e12
    return Prediction(
        tflops_per_gpu=tflops,
        pct_peak=100.0 * tflops * 1e12 / peak,
        step_time_s=T,
        memory_per_gpu=mem,
        oom=oom,
        bubble=bubble,
        breakdown={
            "t_comp": ticks * t_comp, "t_attn_mem": ticks * t_attn_mem,
            "t_tp": ticks * t_tp, "t_ep": ticks * t_ep, "t_pp": ticks * t_pp,
            "t_dp": t_dp, "t_opt": t_opt,
        },
        moe_drop=moe_drop,
        comm_bytes={**cbytes, "total": sum(cbytes.values())},
        mem_breakdown={
            "params": mem_params, "grads": mem_grads, "opt": mem_opt,
            "act": mem_act, "zero": float(z),
        },
    )


# ---------------------------------------------------------------------------
# CommPlan byte prediction + bandwidth calibration (the two-tier model's
# empirical anchors: predicted bytes are read against the bytes the port's
# collectives count, runtime/collectives.py, and the bandwidth coefficients
# fit against measured step times)
# ---------------------------------------------------------------------------


def predict_comm_bytes(shapes: Sequence[Sequence[int]],
                       specs: Sequence[Any],
                       mesh_shape: Mapping[str, int],
                       cp: commplan.CommPlan,
                       itemsize: int = 4,
                       multiplier: float = 1.0,
                       unit_axes: bool = False) -> dict:
    """Predicted zero=3 weight all-gather payload bytes per train step.

    Thin bridge over :func:`commplan.tree_gather_bytes`, read against the
    ``zero3_gather`` bytes ``runtime/collectives.py`` counts.
    ``multiplier`` is the gathers-per-step multiplicity: the port gathers a
    layer's leaves once in each microbatch's forward and once more in the
    recompute of a checkpointed layer (2 per microbatch under remat full or
    selective, 1 under none; the backward reuses no gather), where the
    reference's ``predict`` bills 3 (XLA re-gathers in the backward).
    ``unit_axes`` prices the phases over one-rank groups the port runs
    (``commplan.leaf_gather_bytes``).
    """
    return commplan.tree_gather_bytes(shapes, specs, mesh_shape, cp,
                                      itemsize=itemsize,
                                      multiplier=multiplier, unit_axes=unit_axes)


def predict_a2a_bytes(n_groups: int, n_experts: int, capacity: int,
                      d_model: int, *, dp: int = 1, ep: int = 1,
                      node: int = 1, itemsize: int = 4,
                      with_backward: bool = False) -> int:
    """Predicted ExpertPlan token all-to-all payload bytes per MoE layer.

    Thin bridge over :func:`expertplan.dispatch_a2a_bytes`, read against
    the ``all-to-all`` bytes ``runtime/collectives.py`` counts.
    """
    return expertplan.dispatch_a2a_bytes(
        n_groups, n_experts, capacity, d_model, dp=dp, ep=ep, node=node,
        itemsize=itemsize, with_backward=with_backward)


def calibrate_bandwidths(samples: Sequence[tuple[float, float, float]],
                         machine: Machine | None = None):
    """Fit the two-tier bandwidth coefficients from measured collectives.

    ``samples`` is a sequence of ``(intra_bytes, inter_bytes, seconds)``
    triples — per-step collective payloads split by fabric tier (from
    :func:`predict_comm_bytes`) against the measured comm time.  Solves the
    least-squares system ``t = intra/bw_i + inter/bw_x`` for the two
    effective bandwidths.  Returns ``{"intranode_bw", "internode_bw"}``
    (per-GPU effective bytes/s; ``internode_bw`` is the NIC *share*, i.e.
    directly comparable to ``machine.internode_bw / gpus_per_node``), or a
    ``dataclasses.replace``-d machine when one is given.
    """
    arr = np.asarray([(s[0], s[1]) for s in samples], dtype=np.float64)
    times = np.asarray([s[2] for s in samples], dtype=np.float64)
    if arr.shape[0] < 2:
        raise ValueError("calibrate_bandwidths needs >= 2 samples")
    coef, *_ = np.linalg.lstsq(arr, times, rcond=None)
    tiny = 1e-18
    bw_intra = 1.0 / max(float(coef[0]), tiny)
    bw_inter = 1.0 / max(float(coef[1]), tiny)
    if machine is None:
        return {"intranode_bw": bw_intra, "internode_bw": bw_inter}
    return dataclasses.replace(
        machine, intranode_bw=bw_intra,
        internode_bw=bw_inter * machine.gpus_per_node)


# ---------------------------------------------------------------------------
# Analytic per-family model FLOPs (telemetry's MFU numerator)
# ---------------------------------------------------------------------------
#
# MFU convention (the paper's "GPU throughput" percentages): *model* FLOPs:
# 6 flops per matmul parameter per token (fwd 2, bwd 4; remat's recompute is
# excluded, so this is MFU, not HFU), the attention quadratic billed
# non-causally at 4*T*T_kv*heads*head_dim per layer forward (x3 with the
# backward), and a recurrent-scan term for the attention-free token mixers
# (rwkv's wkv state, mamba's selective scan).  The embedding lookup is a
# gather (0 flops); the logits matmul is counted (once, when
# ``tie_embeddings`` reuses the embed matrix).


@dataclasses.dataclass(frozen=True)
class StepFlops:
    """Analytic model FLOPs of one optimizer step (whole job, all devices)."""
    matmul: float       # every >=2D parameter leaf, active (top_k/E) for MoE
    attn: float         # softmax-attention quadratic
    scan: float         # recurrent token mixing (rwkv wkv / mamba ssm scan)
    tokens: int         # tokens per step (gbs * seq)

    @property
    def total(self) -> float:
        return self.matmul + self.attn + self.scan

    @property
    def per_token(self) -> float:
        return self.total / max(self.tokens, 1)


_FLOPS_FAMILIES = ("dense", "moe", "hybrid", "rwkv", "encdec", "vlm")


def _matmul_params(cfg) -> dict[str, float]:
    """Active matmul parameters per token of each stream, {"decoder",
    "encoder"}: the >= 2-D leaves of the spec tree (vectors are O(d)
    elementwise, not billed); expert leaves weighted by the routed top_k/E
    fraction; the hybrid family's weight-tied "shared" block billed once
    per application; the untied embedding is a lookup (the lm_head is its
    own leaf); the encdec encoder's leaves per frame."""
    # lazy imports: core/ must not depend on models/ at module scope
    from repro_torch.models.common import flatten_specs
    from repro_torch.models.model import param_specs

    n_shared_apps = (cfg.n_layers // cfg.hybrid_attn_every
                     if cfg.family == "hybrid" and cfg.hybrid_attn_every else 1)
    n = {"decoder": 0.0, "encoder": 0.0}
    for path, spec in flatten_specs(param_specs(cfg)):
        if len(spec.shape) < 2 or (path == "embed" and not cfg.tie_embeddings):
            continue
        leaf = float(np.prod(spec.shape))
        if "experts" in spec.axes:
            leaf *= max(cfg.top_k, 1) / max(cfg.n_experts, 1)
        if path.startswith("shared."):
            leaf *= n_shared_apps
        n["encoder" if path.startswith("encoder.") else "decoder"] += leaf
    return n


def train_step_flops(cfg, global_batch: int, seq_len: int,
                     *, backward: bool = True) -> StepFlops:
    """Per-family analytic model FLOPs of one train step (all devices) of
    the families the port has (dense, moe, hybrid, rwkv, encdec, vlm; the
    reference's audio terms come with that family): the encdec
    encoder's matmuls at ``enc_seq_len`` frames a row, its self-attention
    at enc_seq_len^2 and the decoder's cross-attention at seq x
    enc_seq_len; the vlm decoder's stream at ``seq + num_patches``
    positions a row (the reference's ``s_stream``), its matmuls, ``proj``
    among them, billed over all of them.  ``tokens`` is the text's.
    ``backward=False`` gives the forward-only (prefill) count.  Invariant
    under the parallel plan: dividing by (step time x devices x peak) gives
    MFU whatever (dp, tp, pp, ep, gas)."""
    fam = cfg.family
    if fam not in _FLOPS_FAMILIES:
        raise NotImplementedError(
            f"train_step_flops for family {fam!r} is not ported yet "
            "(see ROADMAP.md, Queue 1)")
    per_param = 6.0 if backward else 2.0   # fwd 2 + bwd 4 per matmul param
    mult = per_param / 2.0                 # fwd multiplier for attn/scan
    B, s = global_batch, seq_len
    tokens = B * s
    s_stream = s + (cfg.num_patches if fam == "vlm" else 0)
    enc_tokens = B * cfg.enc_seq_len if fam == "encdec" else 0
    mm = _matmul_params(cfg)
    matmul = per_param * (mm["decoder"] * B * s_stream + mm["encoder"] * enc_tokens)
    t_kv = min(s_stream, cfg.sliding_window) if cfg.sliding_window else s_stream
    n_cross = n_enc = 0
    if fam in ("dense", "moe", "vlm"):
        n_self = cfg.n_layers
    elif fam == "encdec":
        n_self, n_cross, n_enc = cfg.n_layers, cfg.n_layers, cfg.enc_layers
    elif fam == "hybrid":
        n_self = cfg.n_layers // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 0
    else:                                  # rwkv: attention-free
        n_self = 0
    attn = mult * 4.0 * B * cfg.n_heads * cfg.resolved_head_dim * (
        n_self * s_stream * t_kv + n_cross * s * cfg.enc_seq_len + n_enc * cfg.enc_seq_len ** 2)
    if fam == "rwkv":
        scan_per_tok = 4.0 * cfg.d_model * cfg.resolved_head_dim
    elif fam == "hybrid":
        from repro_torch.models.ssm import d_inner   # lazy (core -> models)
        scan_per_tok = 6.0 * d_inner(cfg) * max(cfg.ssm_state, 1)
    else:
        scan_per_tok = 0.0
    scan = mult * B * s_stream * cfg.n_layers * scan_per_tok
    return StepFlops(matmul=matmul, attn=attn, scan=scan, tokens=tokens)


def plan_parallel_cfg(cfg, plan, global_batch: int,
                      seq_len: int) -> ParallelCfg:
    """Map an executor plan (``runtime/train_loop.py:ParallelPlan`` or any
    duck-typed equivalent) onto the analytic :class:`ParallelCfg`."""
    data_ways = plan.dp * plan.ep * plan.node
    mbs = max(1, global_batch // (plan.gas * data_ways))
    return ParallelCfg(
        tp=plan.tp, pp=plan.pp, mbs=mbs, gas=plan.gas, dp=plan.dp,
        zero=plan.zero, node=plan.node, qcomm=plan.qcomm,
        overlap=plan.overlap,
        comm_block=getattr(plan, "comm_block", commplan.CommPlan.block),
        checkpoint_activations=plan.remat != "none",
        ep=plan.ep, n_experts=cfg.n_experts, top_k=max(cfg.top_k, 1),
        capacity_factor=cfg.capacity_factor)


def predict_step(cfg, plan, global_batch: int, seq_len: int,
                 machine: Machine = FRONTIER) -> Prediction:
    """Costmodel prediction for an actual (ModelConfig, ParallelPlan) run.

    The drift-monitor anchor: builds the analytic :class:`GPTSize` /
    :class:`ParallelCfg` pair from the real model config and executor plan
    and prices it with :func:`predict`.  For non-GPT families the size
    mapping is structural (layers/width/heads) — the measured-over-
    predicted ratio the telemetry records carry *is* the calibration
    signal ``calibrate_bandwidths`` and the auto-planner consume.
    """
    size = GPTSize(name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
                   n_heads=cfg.n_heads, vocab=cfg.padded_vocab, seq=seq_len)
    return predict(size, plan_parallel_cfg(cfg, plan, global_batch, seq_len),
                   machine)


# ---------------------------------------------------------------------------
# Paper recipes (Table V) and scaling experiments (Figs 12/13)
# ---------------------------------------------------------------------------

RECIPE_175B = ParallelCfg(tp=4, pp=16, mbs=1, gas=640, dp=1)
RECIPE_1T = ParallelCfg(tp=8, pp=64, mbs=1, gas=1600, dp=1)
RECIPE_22B = ParallelCfg(tp=2, pp=4, mbs=2, gas=110, dp=1)


def weak_scaling(model: GPTSize, base: ParallelCfg, dps: list[int],
                 machine: Machine = FRONTIER) -> list[tuple[int, float]]:
    """Per-replica batch fixed; GBS grows with DP (Fig. 12)."""
    out = []
    for r in dps:
        cfg = dataclasses.replace(base, dp=r)
        pred = predict(model, cfg, machine)
        out.append((cfg.n_gpus, pred.tflops_per_gpu))
    return out


def strong_scaling(model: GPTSize, base: ParallelCfg, total_gbs: int,
                   dps: list[int], machine: Machine = FRONTIER) -> list[tuple[int, float]]:
    """Total batch fixed; per-replica microbatches shrink with DP (Fig. 13)."""
    out = []
    for r in dps:
        gas = max(1, total_gbs // (base.mbs * r))
        cfg = dataclasses.replace(base, dp=r, gas=gas)
        pred = predict(model, cfg, machine)
        out.append((cfg.n_gpus, pred.tflops_per_gpu * cfg.gbs / total_gbs))
    return out
