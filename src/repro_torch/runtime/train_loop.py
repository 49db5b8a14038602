"""The training step of ``repro/runtime/train_loop.py``, on one device or
over a ``torch.distributed`` mesh.

``ParallelPlan`` carries the reference's plan fields.  What runs:

  * one device (``build_train_step`` without a mesh): ``gas`` gradient-
    accumulation microbatches, ``precision`` (bf16 | fp16 | fp32 compute
    over fp32 master weights), the compute policy (``remat`` full |
    selective | none, ``kernels``);
  * over a ("pipe", "data", "model") mesh of pp x dp x tp ranks, or
    ("pipe", "data", "expert", "model") at ep > 1
    (``launch/mesh.py:mesh_for_plan``): the same, plus data parallelism
    with ZeRO stage ``zero`` 0-3 (None is stage 1, as in the reference;
    ``core/memplan.py`` says what each stage shards and how), Megatron
    tensor parallelism over the model group (``models/blocks.py``,
    ``models/ssm.py``, ``models/rwkv.py``, ``models/moe.py``; vocab-parallel
    embedding and CE), expert parallelism over the expert group (the moe
    family's experts split over it, the tokens moved by the all-to-all of
    ``models/moe.py:ExpertDispatch``; the batch's rows split over data then
    expert, as the reference's composite batch axis does; at ep = 1 the
    experts are on the data axis and gathered on use), the sharding ``rules`` preset
    (``core/sharding.py:PRESETS``; under ``tp_only`` the batch is off the
    data axis: every data rank takes the whole global batch, as the
    reference's ``batch -> None`` does, and the data reductions act on
    equal gradients), and pipeline parallelism over the pipe group: the
    layer stack split into ``pp x virtual_stages`` logical stages
    (``runtime/pipeline.py``; GPipe at ``virtual_stages`` = 1, Megatron's
    interleaved round-robin assignment above);
  * the CommPlan (``comm_plan()``, ``core/commplan.py``, executed by
    ``runtime/qcollect.py``): a hierarchical ``node`` axis ahead of the
    others (the ("node", "pipe", "data", ["expert",] "model") mesh, node-
    major): the batch's rows split over node, then data, then expert, every
    data reduction runs over the node x data ranks, and each ZeRO stage
    shards its state over the node axis too, so a ZeRO gather runs as an
    inter-node phase over the node group and an intra-node one over the
    data group (``collectives.LeafGather``); at ZeRO 3, ``qcomm`` "gather"
    (int8 block-quantized weight gathers of ``comm_block`` elements a
    scale) or "both" (also the gradient's block fake-quantized after its
    reduce-scatter), and at pp = 1 ``overlap`` (a segment's layers cut into
    chunks whose gathers are issued a chunk ahead, ``core/stage_program.py:
    run_program``); and ``rule_overrides``, the reference's ((logical
    axis, mesh axis), ...) applied after the preset, in full: each block
    split over the model group or whole by its own leaves' specs (the
    lenient divisibility; ``moe_dp_attn``, ``embed_replicated``), the moe
    experts on the model axis (``ep_model``), and the sequence on it
    (``seq_shard``, ``fsdp_seq``, ``moe_dp_attn+seq``: sequence parallelism
    for the dense and moe families at pp = 1 and ep = 1,
    ``models/model.py``).

What still raises, naming ROADMAP.md: ``multi_segment``, fp16 kernels, and
the sequence on the model axis under pp > 1, at ep > 1 or for the hybrid,
rwkv, encdec and vlm families;
as in the reference, ``qcomm`` or ``overlap`` at a ZeRO stage other than 3
and ``overlap`` at pp > 1 raise ValueError.

``build_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``, one step for both: an unsharded model (one device, no process
group) takes each collective below as the identity, a sharded one runs
them over its mesh's groups, of one rank or more.  The global batch is
split as the reference splits it: into ``gas`` microbatches, then each
microbatch's rows over the batch ranks (node, then data, then expert).
At pp = 1 each microbatch's scaled loss (this rank's loss sum over every
batch rank's token count, and the moe family's share of the aux term,
``Model.aux_loss``) is backpropagated and the gradients sum in fp32:
in the parameters' ``.grad`` (stages 0-1: all-reduced over the node x data
ranks after the last microbatch), reduce-scattered into the rank's block
after each microbatch (stage 2), or by the gathers' own reduce-scatters
(stage 3 and any leaf whose spec names the data or node axis); a
data-parallel axis no phase took is then all-reduced over.  At pp > 1 the ``gas``
microbatches run through the pipeline in one sweep, as the reference's
``outer_gas = 1`` runs them: each microbatch's loss is its rows' CE sum
over the token count of the whole global batch (``loss_pipelined``'s
normalisation), the gradients sum in fp32 in ``.grad``, those of the
leaves kept whole over the pipe group (embedding, final norm, lm_head, the
zamba2 shared block) are summed over it (zeros where a rank did not use
one), and then reduced over the data group as above, stage 2 by one
reduce-scatter after the sweep.  At ep > 1 every leaf but the experts' is
then summed over the expert group too (each expert rank holds other
experts, whose gradients are whole over the group's tokens already).
Under sequence parallelism every leaf whole over the model group is summed
over it too (each model rank's gradient is its sequence shard's part; the
all-reduce runs on the rank's block, after ZeRO's reduce-scatters), and
the CE metric where each rank's CE covers its shard (``Model.ce_group``).
Then the gradients are divided by ``gas``
(pp = 1 only) and unscaled in place, checked for finiteness (a flag
all-reduced over every rank, so all ranks skip an overflowed fp16 step
together), their global norm taken (squares summed over every rank, a
replicated leaf counted once: one kept whole over the pipe group on pipe
rank 0), AdamW applied in place to the rank's blocks (stages 1-2 then
all-gather the updated blocks into the parameters), and the loss scale
updated.  The metrics are the reference's, the same on every rank: loss
(the mean CE over the microbatches; at pp > 1 the CE of the global batch,
the same when every token counts), moe_aux and moe_drop (the moe family's
load-balance loss and dropped share of its routed assignments, each the
mean over the microbatches of the mean over every batch rank's groups,
summed over the pipe ranks' stages; 0 for the other families),
grad_norm, grads_finite and loss_scale, as 0-d tensors on the device.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import commplan as cpl
from repro_torch.core import expertplan as epl
from repro_torch.core import memplan as mpl
from repro_torch.core import precision as prec
from repro_torch.core import sharding as shd
from repro_torch.core import stage_program as sp
from repro_torch.core.compute import DEFAULT_POLICY, ComputePolicy
from repro_torch.core.pipeline import schedule
from repro_torch.models.common import ModelConfig, flatten_specs
from repro_torch.models.model import (Model, kv_replicated, param_specs, stage_units,
                                      tp_pieces, whole_heads)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.runtime import pipeline
from repro_torch.runtime.collectives import (
    NODE, MeshGroups, all_reduce_, gather_phases, scatter_phases,
)

# field -> the only value the port runs (multi_segment works around an XLA
# miscompile the port does not have)
_NOT_PORTED = {"multi_segment": False}
# the batch's mesh axes the executor splits rows over (slowest first)
_BATCH_AXES = ((), ("data",), ("data", "expert"), (NODE, "data"), (NODE, "data", "expert"))


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """One point of the paper's plan space (see the module docstring)."""
    dp: int = 1
    tp: int = 1
    pp: int = 1
    virtual_stages: int = 1
    ep: int = 1                     # expert-parallel ways ("expert" mesh axis)
    rules: str = "megatron_tp"      # sharding preset (core/sharding.py:PRESETS)
    zero: int | None = None         # ZeRO stage 0-3; None -> 1
    node: int = 1                   # hierarchical ways ("node" mesh axis)
    qcomm: str = "none"             # none | gather | both: int8 ZeRO 3 gathers
    overlap: bool = False           # chunked gathers ahead of the compute (pp = 1)
    comm_block: int = 32            # quantization block (core/commplan.py)
    gas: int = 1                    # gradient accumulation steps
    precision: str = "bf16"         # bf16 | fp16 | fp32
    remat: str = "full"             # full | selective | none
    kernels: bool = False           # hand-written CUDA kernels
    multi_segment: bool = False     # the reference's hybrid lowering: refused
    # ((logical axis, mesh axis | None), ...): applied after the preset
    rule_overrides: tuple = ()

    def __post_init__(self):
        for name in ("dp", "tp", "pp", "virtual_stages", "ep", "node", "gas"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        for name, only in _NOT_PORTED.items():
            if getattr(self, name) != only:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r}: not ported yet (see ROADMAP.md, "
                    "Queue 1); the port runs node, dp, ep, tp, pp with virtual stages, "
                    "ZeRO 0-3 and the CommPlan")
        stage = mpl.resolve_stage(self.zero)
        object.__setattr__(self, "zero", stage)
        if self.rules not in shd.PRESETS:
            raise ValueError(f"rules must be one of {sorted(shd.PRESETS)}, got {self.rules!r}")
        prec.policy_from_name(self.precision)           # validates
        if self.kernels and self.precision == "fp16":
            raise NotImplementedError(
                "the CUDA kernels take bf16 and fp32; fp16 kernels are not "
                "ported yet (see ROADMAP.md, Queue 2)")
        self.compute_policy()                           # validates remat
        self.comm_plan()                                # validates qcomm/comm_block/node
        if (self.qcomm != "none" or self.overlap) and stage != 3:
            raise ValueError(
                f"qcomm={self.qcomm!r}/overlap={self.overlap} act on the "
                f"zero=3 weight gathers; this plan has zero={stage}")
        if self.overlap and self.pp > 1:
            raise ValueError(
                "overlap interleaves gathers with the pp==1 StageProgram "
                "scan; pp > 1 already gathers per stage")
        if self.batch_axes not in _BATCH_AXES:
            batch = self.sharding_rules().mesh_axis("batch")
            raise NotImplementedError(f"rules {self.rules!r}: the batch on {batch!r} "
                                      "(see ROADMAP.md, Queue 1)")

    @property
    def n_devices(self) -> int:
        return self.node * self.dp * self.ep * self.tp * self.pp

    @property
    def batch_axes(self) -> tuple[str, ...]:
        """The mesh axes the batch's rows split over, slowest first."""
        batch = self.sharding_rules().mesh_axis("batch")
        return () if batch is None else (batch,) if isinstance(batch, str) else tuple(batch)

    @property
    def batch_ranks(self) -> int:
        """The ranks a global batch's rows split over: node x dp x ep, or 1
        where the rules keep the batch off the data axis (``tp_only`` at
        ep = 1 and node = 1)."""
        return shd.axis_size(self.mesh_sizes(), self.sharding_rules().mesh_axis("batch"))

    @property
    def seq_parallel(self) -> bool:
        """Whether the rules put the activations' sequence on the model axis
        (the reference's ``seq_shard``, ``fsdp_seq``, ``moe_dp_attn+seq``)."""
        return self.sharding_rules().mesh_axis("seq") == "model"

    @property
    def n_stages(self) -> int:
        """Logical pipeline depth (interleaving included)."""
        return self.pp * self.virtual_stages

    def compute_policy(self) -> ComputePolicy:
        return ComputePolicy(remat=self.remat, kernels=self.kernels)

    def memory_plan(self) -> mpl.MemoryPlan:
        return mpl.MemoryPlan(zero=self.zero, node_axis=NODE if self.node > 1 else None)

    def comm_plan(self) -> cpl.CommPlan:
        """The communication-axis policy this plan carries."""
        return cpl.CommPlan(qcomm=self.qcomm, block=self.comm_block, overlap=self.overlap,
                            node=self.node, node_axis=NODE, data_axis="data")

    def expert_plan(self) -> epl.ExpertPlan:
        """The expert-parallelism policy this plan carries."""
        return epl.ExpertPlan(ep=self.ep)

    def sharding_rules(self) -> shd.ShardingRules:
        """The preset's rules with the reference's overrides: the batch on
        every data-parallel axis, slowest first (node, then data, then
        expert), so a node or ep plan gives each rank the rows of the flat
        plan; at ep > 1 the experts moved from the data axis onto the
        expert axis; then ``rule_overrides``."""
        rules = shd.PRESETS[self.rules](data_axis="data", model_axis="model",
                                        pipe_axis="pipe" if self.pp > 1 else None)
        batch = (NODE,) if self.node > 1 else ()
        if batch or self.ep > 1:
            batch += ("data",) + (("expert",) if self.ep > 1 else ())
            rules = rules.with_overrides(
                name=rules.name + ("+ep" if self.ep > 1 else "+hier_dp"),
                batch=batch, cache_batch=batch)
        if self.ep > 1:
            rules = rules.with_overrides(name=rules.name, experts="expert")
        if self.rule_overrides:
            rules = rules.with_overrides(**dict(self.rule_overrides))
        return rules

    def mesh_sizes(self) -> dict:
        return {NODE: self.node, "pipe": self.pp, "data": self.dp, "expert": self.ep,
                "model": self.tp}


def plan_state_shardings(cfg: ModelConfig, plan: ParallelPlan
                         ) -> tuple[dict, dict, dict, dict]:
    """({leaf: whole shape}, and the param, optimizer and gradient specs
    {leaf: spec}) under the plan's rules and ZeRO stage: the port's
    counterpart of the reference's ``plan_state_shardings``.  The specs
    keep a mesh axis of size 1 (``unit_axes``), but for the families other
    than dense at tp = 1, which run replicated over the model group as one
    device runs them (embedding and CE included).  The moe family's expert
    leaves are on the data axis at ep = 1 and on the expert axis above (the
    reference's rules); where tp exceeds the kv heads, ``wk``/``wv``
    stay whole over the model axis (``models/model.py:kv_replicated``; the
    reference splits their columns below a head), and where the heads do
    not split into whole heads over tp the attention blocks stay whole
    (``models/model.py:whole_heads``: arctic's 56 query heads at tp 16; the
    reference splits those leaves' columns mid-head).  Every other dim
    follows the reference's lenient rule: a mesh axis that does not divide
    it leaves it whole (seamless-m4t-medium's vocab of 256206 at tp 4: the
    embedding and lm_head whole on every model rank, its CE over the whole
    vocab).  ZeRO adds the data axis, and at node > 1 the node
    axis (``sharding.zero_partition_spec``).  zamba2's in_proj and conv leaves (``tp_pieces``) take the
    model axis on their head dim whatever its width divides: the rank's
    block is its heads' columns and the shared B and C ones.  At pp > 1
    the layer stack is on the pipe axis, and its units must split into the
    plan's logical stages (the reference's ``split_stages`` error
    otherwise), and ep must divide the expert count
    (``expertplan.ExpertDivisibilityError`` otherwise)."""
    if plan.pp > 1:
        name, n = stage_units(cfg)
        if n % plan.n_stages:
            raise sp.units_error(name, n, plan.n_stages)
    epl.validate_experts(cfg.n_experts, plan.ep, where=f"ParallelPlan(ep={plan.ep}) on {cfg.name}")
    rules = plan.sharding_rules()
    if cfg.family != "dense" and plan.tp == 1:
        rules = rules.with_overrides(**{k: None for k, v in rules.rules.items()
                                        if "model" in shd.spec_axes((v,))})
    sizes = plan.mesh_sizes()
    leaves = list(flatten_specs(param_specs(cfg)))
    shapes = {k: s.shape for k, s in leaves}
    axes = {k: s.axes for k, s in leaves}
    base = {k: shd.partition_spec(s.shape, s.axes, sizes, rules, unit_axes=True)
            for k, s in leaves}
    for k in tp_pieces(cfg):
        base[k] = tuple(rules.mesh_axis("ssm_heads") if a == "ssm_heads" else e
                        for a, e in zip(axes[k], base[k]))
    for k in kv_replicated(cfg, plan.tp) + whole_heads(cfg, plan.tp):
        base[k] = tuple(None if "model" in shd.spec_axes((e,)) else e for e in base[k])
    mp = plan.memory_plan()
    psh = mp.param_shardings(shapes, axes, base, sizes)
    return (shapes, psh, mp.optimizer_shardings(shapes, axes, psh, sizes),
            mp.grad_shardings(shapes, axes, psh, sizes))


def train_state_bytes(cfg: ModelConfig, plan: ParallelPlan) -> dict:
    """Bytes of each train-state class one rank holds under the plan (the
    reference's ``train_state_bytes``): ``param_bytes`` the stored fp32
    master parameters, ``grad_bytes`` the fp32 gradient accumulator,
    ``opt_bytes`` both Adam moments.  zamba2's in_proj and conv leaves are
    counted as the ranks hold them (``tp_pieces``): at tp > 1 each model
    rank also holds the B and C columns, 2N (1 - 1/tp)(d + K + 1)
    parameters a mamba layer more than the reference's even split counts."""
    shapes, psh, opt_sh, grad_sh = plan_state_shardings(cfg, plan)
    sizes, pieces = plan.mesh_sizes(), tp_pieces(cfg)
    return {"zero": plan.zero,
            "param_bytes": mpl.sharded_bytes(shapes, psh, sizes, 4, pieces),
            "grad_bytes": mpl.sharded_bytes(shapes, grad_sh, sizes, 4, pieces),
            "opt_bytes": 2 * mpl.sharded_bytes(shapes, opt_sh, sizes, 4, pieces)}


def check_activation_rules(plan: ParallelPlan, cfg: ModelConfig) -> None:
    """The activation layout the executor runs: the heads' and the MLP's
    activations where their weights are, the residual stream whole over
    the model group, and the sequence whole or, under sequence
    parallelism (``seq`` on the model axis), split over the model group for
    the dense and moe families at pp = 1 and ep = 1.  ``rule_overrides``
    that ask for another layout raise: the executor would not carry it
    out."""
    rules = plan.sharding_rules().rules
    where = "(see ROADMAP.md, Queue 1)"
    want = {"act_embed": None, "act_heads": rules.get("heads"), "act_mlp": rules.get("mlp")}
    for axis, mesh_axis in want.items():
        if rules.get(axis) != mesh_axis:
            raise NotImplementedError(
                f"rule_overrides put the activations' {axis!r} on {rules.get(axis)!r}: the "
                "executor keeps the residual stream whole over the model group and the "
                f"heads' and MLP's activations where their weights are {where}")
    seq = rules.get("seq")
    if seq not in (None, "model"):
        raise NotImplementedError(f"rule_overrides put the activations' 'seq' on {seq!r}: "
                                  f"the executor splits the sequence over 'model' only {where}")
    if seq == "model" and (plan.pp > 1 or plan.ep > 1 or cfg.family not in ("dense", "moe")):
        raise NotImplementedError(
            f"rule_overrides put the activations' 'seq' on 'model': sequence parallelism "
            f"runs the dense and moe families at pp = 1 and ep = 1; {cfg.family} at "
            f"pp = {plan.pp}, ep = {plan.ep} is not ported yet {where}")


def build_model(cfg: ModelConfig, plan: ParallelPlan, mesh, dtype: torch.dtype = torch.float32,
                compute: ComputePolicy | None = None) -> Model:
    """The rank's sharded model on ``mesh`` (a DeviceMesh from
    ``launch/mesh.py:mesh_for_plan``), on the mesh's device (the dry run's
    on the meta device)."""
    groups = MeshGroups.from_mesh(mesh)
    if groups.sizes != plan.mesh_sizes():
        raise ValueError(f"mesh {groups.sizes} is not the plan's {plan.mesh_sizes()}")
    check_activation_rules(plan, cfg)
    _, psh, _, _ = plan_state_shardings(cfg, plan)
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    return Model(cfg, dtype, compute=compute, device=device, shardings=psh, mesh=groups,
                 virtual_stages=plan.virtual_stages if plan.pp > 1 else 1,
                 comm=plan.comm_plan(), seq_parallel=plan.seq_parallel)


# the data-parallel axes a gradient is reduced over
_DP_AXES = (NODE, "data")


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """How the step treats one parameter leaf of the rank.  A phase list is
    ((axis, dim), ...) in gather order: the node axis first (both on one
    dim for the composite entry)."""
    update: tuple          # stage >= 1: the phases its block of the update adds
    grad: tuple            # stage 2: the phases its gradient is reduce-scattered on
    reduce: tuple          # the data-parallel axes its gradient is all-reduced over
    counted: bool          # its block enters this rank's grad-norm sum
    on_pipe: bool          # split over the pipe ranks (the layer stack at pp > 1)
    on_expert: bool = False  # split over the expert ranks (the experts at ep > 1)
    # whole over the model group under sequence parallelism: each model
    # rank's gradient is its sequence shard's part, summed over the group
    model_sum: bool = False
    # (dim, [(offset, length)]): the parts of its block this rank counts,
    # where other model ranks hold the rest whole as well (tp_pieces); None: all
    own: tuple | None = None

    def norm_parts(self, g: torch.Tensor) -> list[torch.Tensor]:
        """What of the gradient block ``g`` enters this rank's norm sum."""
        if self.own is None:
            return [g]
        dim, ranges = self.own
        return [g.narrow(dim, o, n) for o, n in ranges]


def _leaves(model: Model, plan: ParallelPlan) -> dict[str, _Leaf]:
    if model.shardings is None:        # one device: whole leaves, no group
        return {k: _Leaf((), (), (), True, False) for k, _ in model.named_parameters()}
    _, psh, opt_sh, grad_sh = plan_state_shardings(model.cfg, plan)
    if psh != model.shardings:
        raise ValueError("the model is not sharded as the plan asks "
                         "(build it with train_loop.build_model)")
    coord = model.mesh.coord
    pieces = tp_pieces(model.cfg)

    def own(k, spec):
        if k not in pieces or "model" not in shd.spec_axes(spec) or coord["model"] == 0:
            return None
        return spec.index("model"), pieces[k].split_ranges(model.mesh.sizes["model"])

    def added(spec, base):
        return tuple((a, i) for a in _DP_AXES for i, (e, b) in enumerate(zip(spec, base))
                     if a in shd.spec_axes((e,)) and a not in shd.spec_axes((b,)))

    out = {}
    for k, spec in psh.items():
        block = shd.spec_axes(opt_sh[k])
        out[k] = _Leaf(update=added(opt_sh[k], spec), grad=added(grad_sh[k], spec),
                       reduce=tuple(a for a in _DP_AXES if a not in shd.spec_axes(grad_sh[k])),
                       counted=all(coord[a] == 0 for a in (NODE, "pipe", "data", "expert",
                                                           "model") if a not in block),
                       on_pipe="pipe" in shd.spec_axes(spec),
                       on_expert="expert" in shd.spec_axes(spec), own=own(k, spec),
                       model_sum=plan.seq_parallel and "model" not in shd.spec_axes(spec))
    return out


def _groups(phases: tuple, mesh: MeshGroups) -> list:
    """A phase list's (group, dim) pairs (``collectives.gather_phases``)."""
    return [(mesh.groups[a], dim) for a, dim in phases]


def _block(t: torch.Tensor, phases: tuple, mesh: MeshGroups) -> torch.Tensor:
    """The rank's block of ``t`` over ``phases`` (a view): the data axis's
    part first, then the node axis's part of it, as a composite
    ("data", "node") entry lays the blocks out."""
    for a, dim in reversed(phases):
        n = t.shape[dim] // mesh.sizes[a]
        t = t.narrow(dim, mesh.coord[a] * n, n)
    return t


def init_train_state(model: Model, opt_cfg: AdamWConfig, plan: ParallelPlan,
                     generator: torch.Generator | None = None) -> dict:
    """The train state over ``model``'s own parameters (drawn from
    ``generator`` when one is given): {"params": {name: Parameter}, "opt",
    "loss_scale", "step"}.  Parameters get ``requires_grad``; a sharded
    model's moments cover the rank's blocks of the update."""
    if generator is not None:
        model.init(generator)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    leaves = _leaves(model, plan)
    return {"params": params,
            "opt": adamw_init({k: _block(p, leaves[k].update, model.mesh)
                               for k, p in params.items()}),
            "loss_scale": prec.init_loss_scale(plan.precision == "fp16",
                                               device=model.device),
            "step": 0}


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(v, torch.Tensor)
                else v).to(device) for k, v in batch.items()}


def _sum(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` all-reduced over ``group`` in place; None (no process group)
    leaves it as it is."""
    return t if group is None else all_reduce_(t, group, op)


def _fill_unused(params: dict) -> None:
    """A zero gradient for each parameter the pass did not use (a pipe
    rank's leaves kept whole that only another stage uses; the moe
    family's shared-expert and dense-residual "ln" leaves, which the
    reference keeps and never applies), as the reference's gradient of an
    unused leaf is zero."""
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def build_train_step(model: Model, opt_cfg: AdamWConfig, plan: ParallelPlan, mesh=None):
    """Returns train_step(state, batch) -> (state, metrics); ``state`` is
    updated in place.  The step runs ``model``'s weights, which must be
    stored in the policy's fp32 master dtype, under the plan's compute policy
    and compute dtype through a view of the model (``Model.with_policy``):
    ``model`` itself keeps its own policy.  With ``mesh`` (the plan's
    DeviceMesh) ``model`` is the rank's sharded model (``build_model``) and
    ``batch`` the global batch, the same on every rank."""
    policy = prec.policy_from_name(plan.precision)
    if model.dtype != policy.param_dtype:
        raise ValueError(f"master weights must be stored in {policy.param_dtype}, "
                         f"the model stores {model.dtype}")
    epl.validate_experts(model.cfg.n_experts, plan.ep,
                         where=f"ParallelPlan(ep={plan.ep}) on {model.cfg.name}")
    if (mesh is None) != (model.shardings is None) or (mesh is None and plan.n_devices > 1):
        raise ValueError(f"a plan of {plan.n_devices} ranks runs a sharded model "
                         "(train_loop.build_model) on its mesh (launch/mesh.py:mesh_for_plan)")
    if mesh is None and (plan.qcomm != "none" or plan.overlap):
        raise ValueError("qcomm/overlap act on the ZeRO 3 gathers of a sharded model "
                         "(train_loop.build_model) on its mesh, of one rank or more")
    if mesh is not None and model.comm.cp != plan.comm_plan():
        raise ValueError(f"the model's CommPlan {model.comm.cp} is not the plan's "
                         f"{plan.comm_plan()} (build it with train_loop.build_model)")
    compute = plan.compute_policy()
    if model.compute not in (DEFAULT_POLICY, compute):
        warnings.warn(
            f"model carries compute policy {model.compute} but the plan "
            f"specifies {compute}; the plan wins inside the step — set "
            f"remat/kernels on the ParallelPlan instead", stacklevel=2)
    model = model.with_policy(compute, policy.compute_dtype)
    # dp: the batch ranks the rows split over (node, then data, then
    # expert); under tp_only (dp = 1 here) each data rank takes every row,
    # and its loss, over the token count summed over the data ranks, is its
    # 1 / dp share of their sum.  ``data`` is the group of the (node, data)
    # ranks, which every data reduction runs over.
    gas, dp = plan.gas, plan.batch_ranks
    mesh = model.mesh
    data, world = (None, None) if mesh is None else (mesh.dp, mesh.world)
    expert = None if mesh is None else mesh.groups["expert"]
    rank = 0
    for a in plan.batch_axes if mesh is not None else ():
        rank = rank * mesh.sizes[a] + mesh.coord[a]
    leaves = _leaves(model, plan)
    device = model.device
    if plan.pp > 1:            # the gas microbatches are the pipeline's
        sched = schedule(plan.pp, gas, plan.virtual_stages)
        ring = pipeline.Ring(mesh.groups["pipe"], device)
    # the gradient sum of the pp = 1 loop over gas microbatches is divided
    # by gas; the pipelined loss is already the global batch's mean
    div = gas if plan.pp == 1 else 1

    def backward_pp1(params: dict, micro: list[dict], ls: dict, gsum: dict,
                     sums: dict) -> torch.Tensor:
        ce_sum = torch.zeros((), dtype=torch.float32, device=device)
        for i, mb in enumerate(micro):
            loss, metrics = model.loss(mb)
            prec.scale_loss(ls, loss).backward()
            _fill_unused(params)
            ce_sum += metrics["ce"].detach()
            sums["aux"] += metrics["moe_aux"].detach()
            sums["moe_drop"] += metrics["moe_drop"].detach()
            for k, p in params.items():         # stage 2: into the rank's block
                if leaves[k].grad:
                    part = scatter_phases(p.grad, _groups(leaves[k].grad, mesh))
                    gsum[k] = part if i == 0 else gsum[k].add_(part)
                    p.grad = None
        return _sum(_sum(_sum(ce_sum, data), expert), model.ce_group) / gas

    def backward_pipelined(params: dict, micro: list[dict], ls: dict, gsum: dict,
                           count: torch.Tensor, sums: dict) -> torch.Tensor:
        ce_sum = pipeline.sweep(model, sched, micro, count, ls, ring, sums)
        _fill_unused(params)
        for k, p in params.items():
            if not leaves[k].on_pipe:           # every pipe rank joins
                _sum(p.grad, mesh.groups["pipe"])
            if leaves[k].grad:                  # stage 2: once, after the sweep
                gsum[k] = scatter_phases(p.grad, _groups(leaves[k].grad, mesh))
                p.grad = None
        _sum(sums["aux"], mesh.groups["pipe"])
        _sum(sums["moe_drop"], mesh.groups["pipe"])
        return _sum(_sum(_sum(ce_sum, data), expert), mesh.groups["pipe"])

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        ls = state["loss_scale"]
        batch = _to_device(batch, device)
        B = batch["tokens"].shape[0]
        if B % (gas * dp):
            raise ValueError(f"global batch {B} is not a multiple of gas x dp = {gas * dp}")
        b = B // gas // dp
        micro = [{k: v[i * B // gas + rank * b:i * B // gas + (rank + 1) * b]
                  for k, v in batch.items()} for i in range(gas)]
        for p in params.values():
            p.grad = None
        gsum: dict[str, torch.Tensor] = {}
        sums = {k: torch.zeros((), dtype=torch.float32, device=device)
                for k in ("aux", "moe_drop")}
        if plan.pp == 1:
            loss = backward_pp1(params, micro, ls, gsum, sums)
        else:
            loss = backward_pipelined(params, micro, ls, gsum,
                                      pipeline.loss_count(batch, device)
                                      * (plan.node * plan.dp * plan.ep // dp), sums)
        inv = 1.0 / ls["scale"]
        grads = {}
        for k, p in params.items():    # in place: (sum / div) unscaled, fp32
            leaf = leaves[k]
            g = gsum.get(k)
            staged = g is not None              # stage 2: already the rank's block
            if not staged:
                g = p.grad
            if mesh is not None:                # the dp axes no gradient phase took
                _sum(g, mesh.group_over(leaf.reduce))
            if not leaf.on_expert:              # ep > 1: every expert rank's tokens
                _sum(g, expert)
            if leaf.model_sum:                  # every sequence shard's part
                _sum(g, mesh.groups["model"])
            if not staged:
                g = _block(g, leaf.update, mesh)
            grads[k] = g.div_(div).mul_(inv)
        finite = _sum(prec.all_finite(grads.values()).to(device, torch.float32),
                      world, dist.ReduceOp.MIN) > 0
        grad_norm = global_norm([part for k, g in grads.items() if leaves[k].counted
                                 for part in leaves[k].norm_parts(g)],
                                group=world, device=device)
        blocks = {k: _block(p, leaves[k].update, mesh) for k, p in params.items()}
        skip = not bool(finite)
        state["opt"] = adamw_update(opt_cfg, blocks, grads, state["opt"], skip=skip,
                                    grad_norm=grad_norm)
        if not skip:                   # stages 1-2: the updated blocks to every rank
            with torch.no_grad():
                for k, p in params.items():
                    if leaves[k].update:
                        p.copy_(gather_phases(blocks[k], _groups(leaves[k].update, mesh)))
        state["loss_scale"] = prec.update_loss_scale(ls, finite)
        state["step"] += 1
        for p in params.values():
            p.grad = None
        # each rank's sums are over its groups: the mean over the batch ranks
        moe = {k: _sum(_sum(v, data), expert) / (model.loss_ranks * gas)
               for k, v in sums.items()}
        return state, {"loss": loss, "moe_aux": moe["aux"], "moe_drop": moe["moe_drop"],
                       "grad_norm": grad_norm, "grads_finite": finite,
                       "loss_scale": state["loss_scale"]["scale"]}

    return train_step
