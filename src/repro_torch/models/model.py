"""Top-level Model, the dense, moe, hybrid (zamba2), rwkv, encdec
(seamless) and vlm (internvl2) families of ``repro/models/model.py``, as an
``nn.Module`` that holds its weights.

  * ``param_specs()``  — declarative tree (shapes/axes/init); its dotted
    paths (``layers.attn.wq``, ``layers.mlp.w1``, …) are the state_dict keys,
    so weights carry over from the JAX pytree 1:1 (``repro_torch.interop``)
  * ``init(generator)`` — draw the weights from an explicit generator
  * ``loss(batch)`` / ``logits(batch)`` — the training objective (chunked or
    blocked-kernel CE, and for the moe family the load-balance aux loss)
    and the full-sequence logits; a vlm batch carries ``patches`` (B, P,
    frontend_dim), projected by ``proj`` and prepended to the token
    embeddings (the vision front end is a stub in the reference too), and
    its CE runs over the text positions only
  * ``encode(frames)`` — the encdec encoder: precomputed frame embeddings
    (B, T, frontend_dim) through ``in_proj``, its non-causal layer stack and
    final norm, to the decoder's cross-attention ``memory`` (B, T, d)
  * ``prefill(batch, cache_len, lens=)`` — full-sequence forward + cache
    (KV; for hybrid also each mamba layer's conv window and SSD state; for
    rwkv each layer's last tokens and wkv state, no KV; for encdec the
    decoder's self-attention KV, and the encoded ``memory`` beside it; for
    vlm the KV of the patch positions ahead of the prompt's)
  * ``decode_step(cache, batch)`` — one serving step, per-slot ``pos``,
    ``active`` and a paged ``block_table``, or ``active`` alone for a
    slot-swap cache (the hybrid and rwkv families' fixed-size state); an
    encdec step takes ``batch["memory"]`` and cross-attends to it in every
    layer, its K and V projected again each step, as the reference does
  * ``cache_specs`` / ``paged_cache_specs`` / ``init_cache``: a
    sliding-window config's KV is a ring of ``min(cache_len, window)``
    positions (slot-swapped, never paged); under ``kv_quant`` every KV leaf
    is int8 beside fp32 per-token, per-head scales

Weights keep the JAX layout (``x @ W`` with W (d_in, d_out), per-layer
leaves stacked on a leading ``L`` dim).  They are stored in ``dtype`` (fp32
master weights for training, bf16 for serving) and every forward casts them
to ``compute_dtype`` (``dtype``, or the plan's in the view a train step
runs through, ``with_policy``; the cast is free when the two agree).  The
training stack casts each layer's slice inside its remat wrapper, as the
reference casts inside its scan body, so the compute-dtype copies are
recomputed in the backward instead of saved and the weight gradients
arrive in fp32.  Caches are dicts of tensors that decode updates
in place (the JAX package returns new arrays; in place saves a copy of the
KV cache per step).

Sharded (``shardings`` and ``mesh``: a spec per leaf, from
``runtime/train_loop.py:plan_state_shardings``), the model stores only the
rank's block of each leaf.  ``init`` still draws every leaf whole, in the
same order from the same generator, and keeps the block, so every plan
starts from the single-device weights.  A leaf whose spec names the data
or the node axis is gathered on use (``collectives.LeafGather``, as the
CommPlan's ``runtime/qcollect.py:CommExec`` decides: its phases, and int8
block-quantized under ``qcomm``): a stacked leaf layer by layer inside the
layer's remat wrapper, so the backward's recompute gathers again and no
whole stack is saved (under ``overlap`` a chunk of layers' gathers is
issued ahead of the chunk before it, ``core/stage_program.py:
run_program``); the embedding in the storage dtype (its duplicate-token
rows then sum in fp32, as unsharded), the rest in the compute dtype.  The
zamba2 shared block is gathered at each application and its uses'
gradients summed before one reduce-scatter.
Under the model axis each block (:func:`block_name`: an attention, an MLP,
the experts, the embedding, the lm_head; the recurrent families' mixers as
one) runs Megatron tensor parallelism where the plan's specs split it and
whole on every model rank where they do not (:func:`check_shardings`; the
dense blocks and zamba2's shared block in ``blocks.py``, the mamba layers
in ``ssm.py``, rwkv's blocks in ``rwkv.py``, the expert MLPs, the shared
expert and the dense residual in ``moe.py``; ``tp_dims`` names the leaves
and their dims, ``tp_pieces`` the zamba2 leaves whose block is not one even
cut); the moe experts may instead sit on the model axis whole, E/tp a rank
(the reference's ``ep_model``).  A split embedding's lookup is
vocab-parallel (rows outside the shard are zero, then all-reduced over the
model group) and a split lm_head column-parallel into the vocab-parallel
CE (``models/vocab_parallel.py``); a whole one takes the CE's whole-vocab
branch.  With ``seq_parallel`` (the plan's ``seq`` on the model axis; the
dense and moe families at pp = 1) each microbatch row's positions split
over the model group, rank r holding [r S/tp, (r + 1) S/tp): the
residual stream, the norms and the whole blocks run on the shard, a split
block gathers the sequence and reduce-scatters its output
(``blocks.py``), the moe block routes the gathered sequence
(``moe.py``), the labels shift before the split, and each whole leaf's
gradient is the shard's part, which the train step sums over the group.
Under the pipe axis the model stores the layers of its rank's logical
stages only (with ``virtual_stages`` v > 1 a round-robin set,
``core/sharding.py:shard_slices``), and the embedding, final norm, lm_head
and the zamba2 shared block whole, as the reference's specs keep them; its
stack runs through ``runtime/pipeline.py``.  Under
the expert axis (ep > 1) the model stores the rank's E/ep experts of each
expert leaf and its MoE blocks dispatch tokens to them
(``moe.ExpertDispatch``); at ep = 1 the expert leaves are on the data
axis, as the reference's rules put them, and gathered on use.  The encdec
encoder's layer stack is on the pipe axis too, as the reference's rules put
every "layers" axis, but as a storage partition only (contiguous blocks,
whatever ``virtual_stages`` says): every pipe rank runs the whole encoder,
so the pipeline gathers it over the pipe group
(``runtime/pipeline.py:PipeEncoder``) and reduce-scatters its gradient
back.  Training only: prefill, decode and ``logits`` of a sharded model
raise.

The layer stack of every family lowers into the StageProgram IR
(:meth:`Model.stage_program`, ``core/stage_program.py``): ``hidden_states``
runs it whole, the pipeline split into stages.  The moe family's units add
their aux loss and drop fraction into the program's ``aux`` and
``moe_drop`` carries; the loss adds ``MOE_AUX_COEF * aux / n_layers`` to the
CE (over the rank's groups, a sharded model's share of the mean over the
batch ranks' groups).
"""
from __future__ import annotations

import copy
import dataclasses
from collections.abc import Callable, Iterator
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.core.compute import (
    ComputePolicy, checkpointed, resolve as resolve_policy,
)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import masked_update_
from repro_torch.models import blocks, layers, moe, rwkv, ssm
from repro_torch.models.vocab_parallel import vocab_parallel_tokens
from repro_torch.core import sharding as shd
from repro_torch.core import stage_program as sp
from repro_torch.models.common import (
    ModelConfig, Spec, flatten_specs, init_leaf, init_params, param_count,
    spec_tree_map,
)
from repro_torch.core.commplan import CommPlan
from repro_torch.runtime.collectives import (
    LeafGather, MeshGroups, all_gather_to_model, all_reduce_, copy_to_model,
)
from repro_torch.runtime.qcollect import CommExec

MOE_AUX_COEF = 0.01


class _GradCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def grad_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Identity forward; casts the cotangent to ``dtype`` on the way back
    (``repro/models/model.py:grad_cast``), so the fp32 loss cotangent does
    not turn the whole backward through the layer stack into fp32."""
    return _GradCast.apply(x, dtype)


def stack_specs(tree: Any, n: int) -> Any:
    return spec_tree_map(
        lambda s: dataclasses.replace(s, shape=(n,) + s.shape, axes=("layers",) + s.axes),
        tree)


def _layer_specs(cfg: ModelConfig) -> dict:
    """One stacked unit: attention and MLP (dense), attention and the MoE
    FFN after a sub-stack of ``moe_every - 1`` dense layers (moe), or one
    mamba2 layer (hybrid; the shared attention block is its own subtree),
    or one time-mix + channel-mix block (rwkv), or one decoder layer:
    self-attention, cross-attention and MLP (encdec)."""
    if cfg.family == "hybrid":
        return ssm.mamba_specs(cfg)
    if cfg.family == "rwkv":
        return rwkv.rwkv_specs(cfg)
    if cfg.family == "encdec":
        return {"attn": blocks.attn_specs(cfg), "cross": blocks.attn_specs(cfg, cross=True),
                "mlp": blocks.mlp_specs(cfg)}
    if cfg.family != "moe":
        return {"attn": blocks.attn_specs(cfg), "mlp": blocks.mlp_specs(cfg)}
    unit = {"attn": blocks.attn_specs(cfg), "moe": moe.moe_specs(cfg)}
    if cfg.moe_every > 1:
        dense = {"attn": blocks.attn_specs(cfg),
                 "mlp": blocks.mlp_specs(cfg, cfg.dense_d_ff or cfg.d_ff)}
        unit["dense"] = stack_specs(dense, cfg.moe_every - 1)
    return unit


def _n_stack(cfg: ModelConfig) -> int:
    """Number of stacked units (the leading "layers" dim)."""
    if cfg.family == "moe" and cfg.moe_every > 1:
        if cfg.n_layers % cfg.moe_every:
            raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a multiple "
                             f"of moe_every={cfg.moe_every}")
        return cfg.n_layers // cfg.moe_every
    return cfg.n_layers


def _n_super(cfg: ModelConfig) -> int:
    """Number of hybrid "super" units: ``hybrid_attn_every`` mamba layers
    and one application of the shared block each."""
    per = cfg.hybrid_attn_every or cfg.n_layers
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a multiple "
                         f"of hybrid_attn_every={per}")
    return cfg.n_layers // per


def stage_units(cfg: ModelConfig) -> tuple[str, int]:
    """The name and unit count of the family's one-segment stage program
    (:meth:`Model.stage_program`): what a pipeline's stages split."""
    if cfg.family == "hybrid":
        return "super", _n_super(cfg)
    return ({"rwkv": "rwkv", "moe": "moe_unit", "encdec": "decoder"}.get(cfg.family, "block"),
            _n_stack(cfg))


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree of ``repro/models/model.py:Model.param_specs``."""
    d, V = cfg.d_model, cfg.padded_vocab
    specs: dict[str, Any] = {
        "embed": Spec((V, d), ("vocab", "embed"), scale=0.02),
        "final_norm": blocks.norm_spec(d, cfg.norm),
        "layers": stack_specs(_layer_specs(cfg), _n_stack(cfg)),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = Spec((d, V), ("embed", "vocab"), scale=0.02)
    if cfg.family == "hybrid":
        # one weight-tied attention + MLP block, applied after every
        # hybrid_attn_every mamba layers
        specs["shared"] = {"attn": blocks.attn_specs(cfg), "mlp": blocks.mlp_specs(cfg)}
    if cfg.family == "encdec":
        enc_layer = {"attn": blocks.attn_specs(cfg), "mlp": blocks.mlp_specs(cfg)}
        specs["encoder"] = {
            "in_proj": Spec((cfg.frontend_dim, d), (None, "embed")),
            "layers": stack_specs(enc_layer, cfg.enc_layers),
            "final_norm": blocks.norm_spec(d, cfg.norm),
        }
    if cfg.family == "vlm":
        # the patch projector: patch embeddings (frontend_dim) -> d
        specs["proj"] = Spec((cfg.frontend_dim, d), (None, "embed"))
    return specs


def pipe_interleaved(path: str) -> bool:
    """Whether leaf ``path``'s pipe-axis block follows the logical stages'
    round-robin under virtual stages: the decoder's layer stack does; the
    encdec encoder's, a storage partition that every pipe rank gathers
    whole, is cut into contiguous blocks."""
    return not path.startswith("encoder.")


def check_supported(cfg: ModelConfig) -> None:
    """The slice of the JAX package this port covers; the rest raises."""
    where = "is not ported yet (see ROADMAP.md, Queue 1)"
    if cfg.family not in ("dense", "moe", "hybrid", "rwkv", "encdec", "vlm"):
        raise NotImplementedError(f"family {cfg.family!r} {where}")
    if cfg.pos not in ("rope", "none"):
        raise NotImplementedError(f"pos={cfg.pos!r} {where}")


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter or cache tree (views)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _unstack(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked tree through one ``unbind`` per leaf:
    the backward then stacks the per-layer gradients once, where indexing
    layer by layer would add a zero-filled full-stack gradient per layer."""
    parts = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, LeafGather):
        return tree(dtype)
    return tree.to(dtype) if tree.is_floating_point() else tree


# the logical axes the model axis sits on under Megatron tensor parallelism
# (core/sharding.py's rules), the vocab aside
_TP_AXES = ("heads", "kv_heads", "mlp", "ssm_heads", "expert_mlp")


def _model_dim(spec: shd.Spec) -> int | None:
    dims = [i for i, e in enumerate(spec) if "model" in shd.spec_axes((e,))]
    return dims[0] if dims else None


def tp_dims(cfg: ModelConfig) -> dict[str, int]:
    """{leaf: the dim tensor parallelism splits} of the family's blocks (the
    dense and moe blocks, zamba2's mamba layers and shared block, rwkv's
    time-mix and channel-mix): the dim of the leaf's first head, kv-head,
    MLP, expert-MLP or SSM-head axis."""
    out = {}
    for path, spec in flatten_specs(param_specs(cfg)):
        dims = [i for i, a in enumerate(spec.axes) if a in _TP_AXES]
        if dims:
            out[path] = dims[0]
    return out


def tp_pieces(cfg: ModelConfig) -> dict[str, shd.Pieces]:
    """{leaf: its model-axis layout} of the leaves whose split is not one
    even cut (``ssm.head_pieces``: zamba2's in_proj and conv)."""
    if cfg.family != "hybrid":
        return {}
    return {f"layers.{k}": v for k, v in ssm.head_pieces(cfg).items()}


def _tp_heads(cfg: ModelConfig) -> list[tuple[str, int]]:
    """(a leaf that splits on whole heads, its head count) of the family."""
    if cfg.family == "rwkv":
        return [("layers.tm.wr", rwkv.n_rwkv_heads(cfg))]
    attns = {"hybrid": ["shared.attn"],
             "encdec": ["layers.attn", "layers.cross", "encoder.layers.attn"],
             "moe": ["layers.attn"] + (["layers.dense.attn"] if cfg.moe_every > 1 else [])}
    heads = [(f"{attn}.{w}", n) for attn in attns.get(cfg.family, ["layers.attn"])
             for w, n in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads))]
    if cfg.family == "hybrid":
        heads.insert(0, ("layers.in_proj", ssm.n_ssm_heads(cfg)))
    return heads


def kv_replicated(cfg: ModelConfig, tp: int) -> tuple[str, ...]:
    """The ``wk``/``wv`` leaves (every one on the kv-head axis) kept whole
    over the model group where ``blocks.kv_heads_replicated``; empty
    otherwise."""
    if cfg.family == "rwkv" or not blocks.kv_heads_replicated(cfg, tp):
        return ()
    return tuple(path for path, spec in flatten_specs(param_specs(cfg))
                 if "kv_heads" in spec.axes)


def whole_heads(cfg: ModelConfig, tp: int) -> tuple[str, ...]:
    """The attention leaves (``wq``, ``wk``, ``wv`` and ``wo`` of every
    attention block) kept whole over a model group of ``tp`` ranks because
    the heads do not split into whole heads: query heads that tp does not
    divide, or kv heads that tp neither divides nor is a multiple of
    (arctic's 56 query heads over 16).  The reference's rules split such a
    leaf's columns wherever tp divides them, mid-head; the port's
    attention runs whole on every model rank instead, with the same
    numbers.  The recurrent families keep their all-or-none rule (none
    here: :func:`check_shardings` refuses their heads that do not split)."""
    if cfg.family in ("hybrid", "rwkv") or (
            cfg.n_heads % tp == 0
            and (cfg.n_kv_heads % tp == 0 or blocks.kv_heads_replicated(cfg, tp))):
        return ()
    return tuple(path for path, spec in flatten_specs(param_specs(cfg))
                 if {"heads", "kv_heads"} & set(spec.axes))


def block_name(cfg: ModelConfig, path: str) -> str:
    """The block leaf ``path`` belongs to, which tensor parallelism splits or
    keeps whole as one: the path without the leaf's name ("layers.attn",
    "layers.moe" for the experts, "layers.moe.dense", "encoder.layers.mlp");
    the embedding and the lm_head each their own; every leaf of the
    recurrent families one "mixer" block (they keep the all-or-none rule)."""
    if path in ("embed", "lm_head"):
        return path
    if cfg.family in ("hybrid", "rwkv"):
        return "mixer"
    return path.rsplit(".", 1)[0]


def check_shardings(cfg: ModelConfig, specs: dict[str, shd.Spec],
                    sizes: dict[str, int]) -> dict[str, str]:
    """What the port's sharded model can run: {block: "split" or
    "experts"} of the blocks (:func:`block_name`) on the model axis; a block
    it does not name runs whole on every model rank.  A split block is
    Megatron's: the model axis on the dim of :func:`tp_dims` of every leaf
    of the block that has one (the vocab dim of the embedding and the
    lm_head), on whole heads given the mesh ``sizes``, the leaves of
    :func:`kv_replicated` whole.  "experts" is the moe experts' block with
    the model axis on the experts dim of each expert leaf (E/tp whole
    experts a model rank, the reference's ``ep_model``).  Anything else
    raises, naming the leaf: a block whose leaves disagree, a split that is
    neither, heads that do not split."""
    where = "(see ROADMAP.md, Queue 1)"
    tp = sizes["model"]
    whole = kv_replicated(cfg, tp)
    expected = {k: v for k, v in tp_dims(cfg).items() if k not in whole}
    expected.update(embed=0, lm_head=1)
    axes = {k: s.axes for k, s in flatten_specs(param_specs(cfg))}
    layout: dict[str, str] = {}
    on = set()
    for path, spec in specs.items():
        dim = _model_dim(spec)
        if dim is None:
            continue
        if path in whole:
            raise NotImplementedError(f"{path}: split over tp={tp}, above the "
                                      f"{cfg.n_kv_heads} kv heads, where it is kept whole")
        mode = "split"
        if cfg.family == "moe" and axes[path][dim] == "experts":
            mode = "experts"
        elif expected.get(path) != dim:
            raise NotImplementedError(f"{path}: the model axis on dim {dim} is not "
                                      f"Megatron's split {where}")
        block = block_name(cfg, path)
        if layout.setdefault(block, mode) != mode:
            raise NotImplementedError(f"{path}: its block {block} is on the model axis "
                                      f"both by experts and by columns {where}")
        on.add(path)
    for leaf, heads in _tp_heads(cfg):
        if block_name(cfg, leaf) in layout and heads % tp and leaf not in whole:
            what = (f"{cfg.n_heads} query / {cfg.n_kv_heads} kv heads" if leaf.endswith(".wk")
                    else f"{heads} heads")
            raise NotImplementedError(f"{leaf}: {what} do not split over tp={tp} {where}")
    for path in specs:
        block = block_name(cfg, path)
        if block in layout and path in expected and path not in on:
            raise NotImplementedError(f"{path}: whole over the model axis while the other "
                                      f"leaves of its block ({block}) are split {where}")
    return layout


class _Tree(nn.Module):
    """A node of the parameter tree: its children are sub-trees and leaves."""


def _as_dict(module: nn.Module) -> dict:
    out: dict[str, Any] = dict(module._parameters)
    for name, child in module.named_children():
        out[name] = _as_dict(child)
    return out


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 compute: ComputePolicy | None = None,
                 device: str | torch.device | None = None,
                 shardings: dict[str, shd.Spec] | None = None,
                 mesh: MeshGroups | None = None, virtual_stages: int = 1,
                 comm: CommPlan | None = None, seq_parallel: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype                # storage
        self.compute_dtype = dtype        # with_policy gives another
        self.compute = resolve_policy(compute)
        check_supported(cfg)
        self.device = resolve_device(device)
        if (shardings is None) != (mesh is None):
            raise ValueError("a sharded model needs both its shardings and its mesh")
        self.shardings, self.mesh = shardings, mesh
        self.virtual_stages = virtual_stages     # logical stages per pipe rank
        # the model group of each split block, of the experts on the model
        # axis, of the recurrent families' mixers, of the sequence
        self._split: dict[str, Any] = {}
        self._tp = self._ep = self._experts = self._seq = None
        self.pieces = tp_pieces(cfg)
        if shardings is not None:
            group = mesh.groups["model"]
            layout = check_shardings(cfg, shardings, mesh.sizes)
            self._split = {b: group for b, m in layout.items() if m == "split"}
            if layout.get("layers.moe") == "experts":
                self._experts = group
            if "mixer" in layout:
                self._tp = group
            if seq_parallel:
                if cfg.family not in ("dense", "moe") or mesh.sizes["pipe"] > 1:
                    raise NotImplementedError(
                        f"sequence parallelism runs the dense and moe families at pp = 1; "
                        f"{cfg.family} at pp = {mesh.sizes['pipe']} is not ported yet "
                        "(see ROADMAP.md, Queue 1)")
                self._seq = group
        elif seq_parallel:
            raise ValueError("sequence parallelism splits the sequence over a mesh's "
                             "model group: a sharded model")
        if mesh is not None and mesh.sizes["expert"] > 1:
            if self._experts is not None or self._seq is not None:
                raise NotImplementedError(
                    "ep > 1 with the experts or the sequence on the model axis is not "
                    "ported yet (see ROADMAP.md, Queue 1)")
            self._ep = moe.ExpertDispatch(mesh.groups["expert"], mesh.sizes["expert"])
        # the CommPlan's per-leaf gathers (runtime/qcollect.py)
        self.comm = None if shardings is None else CommExec(
            comm or CommPlan(), mesh, {k: s.shape for k, s in flatten_specs(param_specs(cfg))},
            shardings, self.pieces)
        for path, spec in flatten_specs(self.param_specs()):
            *parents, leaf = path.split(".")
            node: nn.Module = self
            for name in parents:
                if not hasattr(node, name):
                    node.add_module(name, _Tree())
                node = getattr(node, name)
            shape = spec.shape if shardings is None else shd.shard_shape(
                spec.shape, shardings[path], mesh.sizes, self.pieces.get(path))
            node.register_parameter(leaf, nn.Parameter(
                torch.empty(shape, dtype=spec.dtype or dtype, device=self.device),
                requires_grad=False))

    # ------------------------------------------------------------------
    # Specs / init
    # ------------------------------------------------------------------
    def param_specs(self) -> dict:
        return param_specs(self.cfg)

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None) -> "Model":
        """Draw every weight with the JAX package's init rules, leaf by leaf
        in state_dict order, from ``generator`` (on the model's device),
        into the Parameters themselves; a sharded model draws each leaf
        whole and keeps its block.  A model on the meta device has no data
        to draw: it is left as it is."""
        if self.device.type == "meta":
            return self
        params = dict(self.named_parameters())
        for path, spec in flatten_specs(self.param_specs()):
            if self.shardings is None:
                init_leaf(spec, generator, self.device, self.dtype, out=params[path])
                continue
            leaf = init_leaf(spec, generator, self.device, self.dtype)
            params[path].copy_(leaf[shd.outer(self.block_of(path, spec.shape))])
        return self

    def block_of(self, path: str, shape: tuple[int, ...]) -> tuple:
        """The index of this rank's block into the whole leaf ``path``
        (``core/sharding.py:shard_slices``; :func:`tp_pieces` lays out the
        leaves whose split is not one even cut)."""
        if self.shardings is None:
            return tuple(slice(None) for _ in shape)
        return shd.shard_slices(shape, self.shardings[path], self.mesh.sizes, self.mesh.coord,
                                self.virtual_stages if pipe_interleaved(path) else 1,
                                self.pieces.get(path))

    def _parallel(self, stack: str) -> blocks.Parallel:
        """How the blocks of the layer stack ``stack`` ("layers" or
        "encoder.layers") run over the model group."""
        n = len(stack) + 1
        return blocks.Parallel({b[n:]: g for b, g in self._split.items()
                                if b.startswith(stack + ".")}, self._experts, self._seq)

    @property
    def seq_ways(self) -> int:
        """The ranks a microbatch row's sequence splits over (1 without
        sequence parallelism)."""
        return 1 if self._seq is None else self.mesh.sizes["model"]

    def _seq_shard(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's positions of a (B, S, ...) tensor under sequence
        parallelism: [r S/tp, (r + 1) S/tp)."""
        n = self.seq_ways
        if t.shape[1] % n:
            raise ValueError(f"the sequence of {t.shape[1]} does not split over the "
                             f"{n} ranks of the model group")
        s = t.shape[1] // n
        return t.narrow(1, self.mesh.coord["model"] * s, s)

    def _refuse_sharded(self, what: str) -> None:
        if self.shardings is not None and any(shd.spec_axes(s)
                                               for s in self.shardings.values()):
            raise NotImplementedError(f"{what} of a sharded model (tp, pp or ZeRO-3) is not "
                                      "ported yet (see ROADMAP.md, Queue 1: tp, pp and ZeRO "
                                      "serving); dp slots serve a replicated model "
                                      "(ServeEngine(mesh=, plan=))")

    def _uses(self, tree: dict, prefix: str = "", stacked: bool = False) -> dict:
        """``tree`` (stored leaves, or one layer's views of the stacked
        leaves when ``stacked``) with each leaf on the data or node axis
        wrapped in the :class:`LeafGather` the CommPlan gives it
        (``runtime/qcollect.py:CommExec.gather``: its phases, fp or
        quantized)."""
        out = {}
        for k, v in tree.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = self._uses(v, path, stacked)
            else:
                out[k] = v if self.comm is None else self.comm.gather(path, v, int(stacked))
        return out

    def with_policy(self, compute: ComputePolicy, compute_dtype: torch.dtype) -> "Model":
        """A view of this model's weights (the same Parameters) under another
        compute policy and compute dtype, as the reference's train step
        builds its own ``Model`` from the plan; this model is left as it is."""
        view = copy.copy(self)
        view.compute = compute
        view.compute_dtype = compute_dtype
        return view

    def n_params(self) -> int:
        return param_count(self.param_specs())

    def params(self) -> dict:
        """The weights as a nested dict shaped like the JAX pytree."""
        return _as_dict(self)

    def _cparams(self) -> dict:
        """The weights cast to the compute dtype (the weights themselves when
        it is the storage dtype)."""
        return _cast_floating(self.params(), self.compute_dtype)

    def _unembed_matrix(self, params: dict) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def _logits(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        """Final norm + unembedding of (B, d) rows -> (B, vocab) fp32."""
        cfg = self.cfg
        h = layers.apply_norm(h, params["final_norm"], cfg.norm, cfg.rms_eps,
                              use_kernel=self.compute.kernels)
        return (h @ self._unembed_matrix(params)).float()[..., :cfg.vocab_size]

    # ------------------------------------------------------------------
    # Caches
    # ------------------------------------------------------------------
    @property
    def paged_cacheable(self) -> bool:
        return (self.cfg.family in ("dense", "vlm", "moe", "encdec")
                and self.cfg.sliding_window is None)

    @property
    def patch_offset(self) -> int:
        """The positions ahead of the text: the vlm family's ``num_patches``
        patch embeddings, 0 for the other families."""
        return self.cfg.num_patches if self.cfg.family == "vlm" else 0

    def _attn_cache_len(self, cache_len: int) -> int:
        """The KV positions a cache of ``cache_len`` holds: a sliding
        window's ring keeps the last ``window`` only."""
        if self.cfg.sliding_window is not None:
            return min(cache_len, self.cfg.sliding_window)
        return cache_len

    def _kv_specs(self, lead: tuple[int, ...], axes: tuple[str, ...]) -> dict:
        """The KV leaves of every attention layer, stacked like the weights:
        flat (n_layers, ...); for moe with ``moe_every > 1`` per unit
        {"moe_kv": (n_stack, ...), "dense": (n_stack, moe_every - 1, ...)};
        for hybrid one per application of the shared block (n_super, ...).
        Under ``kv_quant`` "k" and "v" are int8 and "k_scale" / "v_scale"
        hold their fp32 scales (``lead`` + (Hkv,))."""
        cfg = self.cfg
        shape = (*lead, cfg.n_kv_heads, cfg.resolved_head_dim)
        full_axes = (*axes, "cache_heads", "head_dim")
        dt = torch.int8 if cfg.kv_quant else None
        kv = {"k": Spec(shape, full_axes, init="zeros", dtype=dt),
              "v": Spec(shape, full_axes, init="zeros", dtype=dt)}
        if cfg.kv_quant:
            for name in ("k_scale", "v_scale"):
                kv[name] = Spec(shape[:-1], full_axes[:-1], init="zeros",
                                dtype=torch.float32)
        if cfg.family == "moe" and cfg.moe_every > 1:
            unit = {"moe_kv": kv, "dense": stack_specs(kv, cfg.moe_every - 1)}
            return stack_specs(unit, _n_stack(cfg))
        return stack_specs(kv, _n_super(cfg) if cfg.family == "hybrid" else cfg.n_layers)

    def _attn_layers(self, params: dict, cache: dict, memory: torch.Tensor | None = None
                     ) -> Iterator[tuple[dict, dict, Callable]]:
        """(attention weights, that layer's KV cache leaves (views), the FFN
        that follows it) for each attention layer in order, from the stacked
        ``params["layers"]`` and ``cache["layers"]`` trees; an encdec
        layer's "FFN" is its cross-attention over ``memory``, then its MLP."""
        cfg, pol = self.cfg, self.compute
        for i in range(_n_stack(cfg)):
            lp, cl = _layer(params, i), _layer(cache, i)
            if cfg.family == "encdec":
                yield lp["attn"], cl, lambda x, p=lp: blocks.mlp_block(
                    p["mlp"], blocks.cross_attn_block(p["cross"], x, memory, cfg, policy=pol),
                    cfg, policy=pol)
                continue
            if cfg.family != "moe":
                yield lp["attn"], cl, lambda x, p=lp["mlp"]: blocks.mlp_block(
                    p, x, cfg, policy=pol)
                continue
            if "dense" in lp:
                for j in range(cfg.moe_every - 1):
                    dlp = _layer(lp["dense"], j)
                    yield dlp["attn"], _layer(cl["dense"], j), \
                        lambda x, p=dlp["mlp"]: blocks.mlp_block(p, x, cfg, policy=pol)
                cl = cl["moe_kv"]
            yield lp["attn"], cl, lambda x, p=lp["moe"]: moe.moe_block(
                p, x, cfg, policy=pol)[0]

    def cache_specs(self, batch: int, cache_len: int) -> dict:
        """{"pos", "layers"}: the KV of every attention layer; for hybrid
        "layers" holds each mamba layer's {"conv", "state"} and "shared" one
        KV stack per application of the shared block; for rwkv "layers"
        holds each layer's {"x_tm", "x_cm", "state"} (no KV: ``cache_len``
        is not used)."""
        cfg = self.cfg
        pos = Spec((), (), init="zeros", dtype=torch.int32)
        if cfg.family == "rwkv":
            return {"pos": pos,
                    "layers": stack_specs(rwkv.rwkv_cache_specs(cfg, batch), cfg.n_layers)}
        kv = self._kv_specs((batch, self._attn_cache_len(cache_len)),
                            ("cache_batch", "cache_seq"))
        specs = {"pos": pos, "layers": kv}
        if cfg.family == "hybrid":
            specs["layers"] = stack_specs(ssm.mamba_cache_specs(cfg, batch), cfg.n_layers)
            specs["shared"] = kv
        return specs

    def paged_cache_specs(self, n_slots: int, n_blocks: int, block_size: int) -> dict:
        """The KV pool of the serve engine: ``n_blocks`` physical blocks of
        ``block_size`` positions shared by the slots through a block table;
        ``pos`` is a per-slot vector.  Only full-attention KV pages: a
        sliding window's ring (and the recurrent families' state) is
        slot-swapped instead."""
        if not self.paged_cacheable:
            raise ValueError(f"{self.cfg.family} (sliding_window={self.cfg.sliding_window}) "
                             "has a fixed-size cache; paged pools serve full-attention KV "
                             "families only")
        return {"pos": Spec((n_slots,), ("cache_batch",), init="zeros",
                            dtype=torch.int32),
                "layers": self._kv_specs((n_blocks, block_size),
                                         ("cache_blocks", "cache_seq"))}

    def init_cache(self, batch: int, cache_len: int) -> dict:
        return init_params(self.cache_specs(batch, cache_len), None,
                           self.device, self.compute_dtype)

    # ------------------------------------------------------------------
    # Training forward / loss
    # ------------------------------------------------------------------
    def _with_patches(self, x: torch.Tensor, params: dict, batch: dict) -> torch.Tensor:
        """The text embeddings ``x`` (B, S, d), and for vlm ``patches @
        proj`` in the compute dtype ahead of them (B, P + S, d)."""
        if self.cfg.family != "vlm":
            return x
        cdt = self.compute_dtype
        patches = batch["patches"].to(device=self.device, dtype=cdt)
        return torch.cat([patches @ _cast_floating(params["proj"], cdt), x], dim=1)

    def _embed(self, params: dict, batch: dict) -> torch.Tensor:
        """The token embeddings in the compute dtype (B, S, d), and for vlm
        the projected patches ahead of them (B, P + S, d).  Under tp the
        token lookup is vocab-parallel and the patch product whole on every
        model rank; under sequence parallelism the rank's positions only
        (B, S/tp, d): a whole table looks them up, a vocab-parallel lookup
        reduce-scatters its partial sums over the sequence."""
        tokens = batch["tokens"].long()
        mine = tokens if self._seq is None else self._seq_shard(tokens)
        table = _cast_floating(self._uses({"embed": params["embed"]})["embed"], self.dtype)
        if _model_dim(self.shardings["embed"] if self.shardings else ()) is None:
            x = table[mine].to(self.compute_dtype)
        else:
            # vocab-parallel: this rank's rows, zero elsewhere, summed over the group
            rows = table.shape[0]
            local = tokens - self.mesh.coord["model"] * rows
            own = (local >= 0) & (local < rows)
            x = table[torch.where(own, local, 0)] * own[..., None]
            x = blocks.leave(x.to(self.compute_dtype), self.mesh.groups["model"], self._seq)
        if self.cfg.family == "vlm":
            params = self._uses({"proj": params["proj"]})
        return self._with_patches(x, params, batch)

    def stage_program(self) -> sp.StageProgram:
        """The rank's layer stack in the StageProgram IR (the lowerings of
        ``repro/models/model.py:stage_program``): one segment of per-layer
        units ("block", "rwkv"), each under the policy's remat wrapper with
        the cast inside; for moe one "moe_unit" per stacked unit
        (``moe.segment_body``), which carries ``aux`` and ``moe_drop``; for
        hybrid one "super" unit per ``hybrid_attn_every`` mamba layers,
        which closes over the weight-tied shared block
        (``ssm.hybrid_segment_body`` wraps each mamba layer and the shared
        application); for encdec one "decoder" unit a layer
        (``blocks.segment_body(cross=True)``) that reads the ``memory``
        input carry.  The other families carry the single ``aux`` at 0,
        untouched.  Data-sharded leaves are wrapped to gather on use, so a
        program serves one pass."""
        cfg = self.cfg
        cdt = self.compute_dtype
        params = self.params()
        stack = params["layers"]
        while isinstance(stack, dict):
            stack = next(iter(stack.values()))
        # one layer's leaves (views of the stacked ones), data-sharded ones
        # wrapped to gather on use
        lps = [self._uses(lp, "layers", stacked=True)
               for lp in _unstack(params["layers"], stack.shape[0])]
        if cfg.family == "moe":
            body = moe.segment_body(cfg, self.compute, lambda t: _cast_floating(t, cdt),
                                    par=self._parallel("layers"), ep=self._ep)
            return sp.StageProgram((sp.Segment("moe_unit", lps, len(lps), body),),
                                   (sp.CarrySpec("aux"), sp.CarrySpec("moe_drop")))
        if cfg.family == "hybrid":
            # the shared block's Parameters are closed over by every unit:
            # autograd sums their gradients over the applications
            per = cfg.n_layers // _n_super(cfg)
            units = [lps[s:s + per] for s in range(0, len(lps), per)]
            step = ssm.hybrid_segment_body(cfg, self.compute,
                                           self._uses(params["shared"], "shared"),
                                           lambda t: _cast_floating(t, cdt), tp=self._tp)
            name = "super"
        elif cfg.family == "encdec":
            layer = blocks.segment_body(cfg, self.compute, cross=True,
                                        par=self._parallel("layers"))
            step = self.compute.checkpoint(
                lambda lp, x, memory: layer(_cast_floating(lp, cdt), x, memory))
            return sp.StageProgram(
                (sp.Segment("decoder", lps, len(lps),
                            lambda lp, x, carry: (step(lp, x, carry["memory"]), carry)),),
                (sp.CarrySpec("aux"), sp.CarrySpec("memory", sp.INPUT)))
        else:
            if cfg.family == "rwkv":
                name, layer = "rwkv", rwkv.segment_body(cfg, self.compute, tp=self._tp)
            else:
                name, layer = "block", blocks.segment_body(cfg, self.compute,
                                                           par=self._parallel("layers"))
            # lp in the storage dtype: cast inside the remat
            step = self.compute.checkpoint(lambda lp, x: layer(_cast_floating(lp, cdt), x))
            units = lps
        return sp.StageProgram((sp.Segment(name, units, len(units),
                                           lambda lp, x, carry: (step(lp, x), carry)),))

    def encoder_program(self, layers_tree: dict | None = None) -> sp.StageProgram:
        """The encdec encoder stack as its own carry-less StageProgram
        (``repro/models/model.py:encoder_program``): one "encoder" unit a
        layer, non-causal, under the remat wrapper with the cast inside, over
        ``layers_tree`` (the stored ``encoder.layers`` by default; the
        pipeline passes the stack it gathered over the pipe group)."""
        cfg, cdt = self.cfg, self.compute_dtype
        tree = self.params()["encoder"]["layers"] if layers_tree is None else layers_tree
        lps = [self._uses(lp, "encoder.layers", stacked=True)
               for lp in _unstack(tree, cfg.enc_layers)]
        layer = blocks.segment_body(cfg, self.compute, causal=False,
                                    par=self._parallel("encoder.layers"))
        step = self.compute.checkpoint(lambda lp, x: layer(_cast_floating(lp, cdt), x))
        return sp.StageProgram((sp.Segment("encoder", lps, len(lps),
                                           lambda lp, x, carry: (step(lp, x), carry)),), ())

    def encode(self, frames: torch.Tensor, layers_tree: dict | None = None) -> torch.Tensor:
        """The encoder (``repro/models/model.py:encode``): frame embeddings
        (B, T, frontend_dim) -> memory (B, T, d) in the compute dtype:
        ``frames @ in_proj`` in the compute dtype, the
        :meth:`encoder_program`, then the encoder's final norm (its kernel
        under ``policy.kernels``)."""
        cfg, cdt = self.cfg, self.compute_dtype
        enc = self._uses(
            {k: v for k, v in self.params()["encoder"].items() if k != "layers"}, "encoder")
        x = frames.to(device=self.device, dtype=cdt) @ _cast_floating(enc["in_proj"], cdt)
        x, _ = sp.run_program(self.encoder_program(layers_tree), x, {})
        return layers.apply_norm(x, _cast_floating(enc["final_norm"], cdt), cfg.norm,
                                 cfg.rms_eps, use_kernel=self.compute.kernels)

    def normed(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm of the stack's output, in the compute dtype."""
        cfg = self.cfg
        final_norm = self._uses(self.params()["final_norm"], "final_norm")
        return layers.apply_norm(x, _cast_floating(final_norm, self.compute_dtype),
                                 cfg.norm, cfg.rms_eps, use_kernel=self.compute.kernels)

    def hidden_states(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(final-normed hidden states (B, S, d) in the compute dtype, the
        moe aux loss, the moe drop sum; both fp32 0 for the other
        families): the pp=1 path, ``core/stage_program.py:run_program``
        over :meth:`stage_program` (for encdec after :meth:`encode` of
        ``batch["frames"]``, its ``memory`` carry).  A model split over pipe
        ranks runs its stack through ``runtime/pipeline.py`` instead."""
        if self.mesh is not None and self.mesh.sizes["pipe"] > 1:
            raise ValueError("a model split over pipe ranks runs its layer stack "
                             "through runtime/pipeline.py (train_loop.build_train_step)")
        x = self._embed(self.params(), batch)
        inputs = {}
        if self.cfg.family == "encdec":
            inputs["memory"] = self.encode(batch["frames"])
        prog = self.stage_program()
        x, carry = sp.run_program(prog, x, prog.init_carry(x.device, inputs),
                                  None if self.comm is None
                                  else self.comm.layer_comm(self.compute_dtype, x.device))
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return self.normed(x), carry.get("aux", zero), carry.get("moe_drop", zero)

    def logits(self, batch: dict) -> torch.Tensor:
        self._refuse_sharded("logits")
        h, _, _ = self.hidden_states(batch)
        W = self._unembed_matrix(self.params()).to(self.compute_dtype)
        return (h @ W).float()[..., :self.cfg.vocab_size]

    @property
    def loss_ranks(self) -> int:
        """The ranks whose losses sum in the gradient reduction: every rank
        of the node, data and expert groups (1 unsharded)."""
        if self.mesh is None:
            return 1
        return self.mesh.sizes["node"] * self.mesh.sizes["data"] * self.mesh.sizes["expert"]

    def sum_over_batch(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed in place over the (node, data) ranks, then the
        expert group (as it is unsharded)."""
        if self.mesh is not None:
            for group in (self.mesh.dp, self.mesh.groups["expert"]):
                if group is not None:
                    all_reduce_(t, group)
        return t

    @property
    def n_moe_units(self) -> int:
        """What the ``moe_drop`` metric divides the drop sum by: the MoE
        units of the stack (1 for the other families)."""
        return _n_stack(self.cfg) if self.cfg.family == "moe" else 1

    def aux_loss(self, aux: torch.Tensor) -> torch.Tensor:
        """The moe aux loss's term of the objective
        (``MOE_AUX_COEF * aux / n_layers``, the reference's), as this rank's
        share: ``aux`` is the mean over its groups, and every batch rank
        holds as many, so the mean over all of them is the sum of the ranks'
        shares.  Under sequence parallelism every model rank routes the same
        whole sequence and its gradients are summed over the group, so each
        takes 1/tp of the term."""
        return (MOE_AUX_COEF * aux / max(self.cfg.n_layers, 1) / self.loss_ranks
                / self.seq_ways)

    @property
    def ce_group(self):
        """The group the CE metric is summed over besides the batch ranks:
        the model group where each model rank's CE covers its own sequence
        shard (a whole vocab under sequence parallelism), else None."""
        if self._seq is None:
            return None
        name = "embed" if self.cfg.tie_embeddings else "lm_head"
        return self._seq if _model_dim(self.shardings[name]) is None else None

    def _loss_from_hidden(self, h: torch.Tensor, batch: dict, aux: torch.Tensor,
                          drop: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """LM loss tail: final-normed hidden states -> (loss, metrics): the
        CE (:meth:`_ce_from_hidden`) plus the moe family's :meth:`aux_loss`
        of ``aux``.  The metrics are the reference's: ``ce``, ``moe_aux``
        (``aux``) and ``moe_drop`` (``drop`` over the MoE units), the last
        two this rank's."""
        ce = self._ce_from_hidden(h, batch)
        metrics = {"ce": ce, "moe_aux": aux, "moe_drop": drop / self.n_moe_units}
        if self.cfg.family != "moe":
            return ce, metrics
        return ce + self.aux_loss(aux), metrics

    def _ce_from_hidden(self, h: torch.Tensor, batch: dict,
                        count: torch.Tensor | None = None) -> torch.Tensor:
        """The CE sum over the rows of ``batch`` divided by ``count``, or by
        the token count of the batch (sharded: over every batch rank's
        rows).  Under sequence parallelism ``h`` is the rank's shard of
        the positions: the labels are shifted before the split (a shard's
        last position takes the next shard's first token, the sequence's
        last none), and a vocab-parallel CE gathers the sequence first
        (every model rank then takes the whole loss), while a whole vocab's
        CE covers the shard (:attr:`ce_group` sums the metric)."""
        cfg = self.cfg
        h = grad_cast(h, self.compute_dtype)
        h = h[:, self.patch_offset:, :]          # vlm: the text positions only
        tokens = batch["tokens"]
        labels = tokens[:, 1:]
        mask = batch.get("loss_mask")
        mask = (torch.ones(labels.shape, dtype=torch.float32, device=h.device)
                if mask is None else mask[:, 1:].float())
        if self.shardings is None:
            W = self._unembed_matrix(self.params()).to(self.compute_dtype)
            return _chunked_cross_entropy(h[:, :-1, :], W, labels, mask,
                                          valid_vocab=cfg.vocab_size, policy=self.compute,
                                          count=count)
        # sharded: the loss sum over this rank's rows over the token count of
        # every batch rank's rows (the microbatch's mean once summed over them)
        name = "embed" if cfg.tie_embeddings else "lm_head"
        W = _cast_floating(self._uses({name: self.params()[name]})[name], self.compute_dtype)
        W = W.T if cfg.tie_embeddings else W
        vocab_dim = _model_dim(self.shardings[name])
        group = self.mesh.groups["model"]
        if count is None:
            count = self.sum_over_batch(mask.sum())
        if vocab_dim is None:
            if self._seq is None:
                h = h[:, :-1, :]
            else:       # the shard's labels: shifted, then split
                labels, mask = (self._seq_shard(F.pad(t, (0, 1))) for t in (labels, mask))
            return _chunked_cross_entropy(h, W, labels, mask, valid_vocab=cfg.vocab_size,
                                          policy=self.compute, count=count)
        if self._seq is not None:
            h = all_gather_to_model(h, 1, self._seq)
        hf = h[:, :-1, :].reshape(-1, h.shape[-1])
        if self._seq is None:
            hf = copy_to_model(hf, group)
        losses = vocab_parallel_tokens(hf, W, labels.reshape(-1), cfg.vocab_size,
                                       self.mesh.coord["model"] * W.shape[1], group,
                                       plain=not self.compute.kernels)
        return (losses * mask.reshape(-1)).sum() / count.clamp(min=1.0)

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """The training objective of one (micro)batch {"tokens": (B, S)}
        (optionally "loss_mask"; for vlm "patches", for encdec "frames"):
        mean next-token CE over the text (plus the moe aux
        term), and {"ce", "moe_aux", "moe_drop"}.  A sharded model takes its
        batch rank's rows and returns their part of the mean over all the
        batch ranks' tokens."""
        h, aux, drop = self.hidden_states(batch)
        return self._loss_from_hidden(h, batch, aux, drop)

    # ------------------------------------------------------------------
    # Prefill
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, batch: dict, cache_len: int,
                lens: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
        """Returns (last-token logits (B, V) fp32, cache at pos=S).

        ``lens`` (B,) — true lengths of right-padded prompts: logits are
        read at ``lens - 1``, the cache holds only real positions, and
        ``cache["pos"]`` becomes the per-slot vector ``lens``.  A vlm batch
        carries ``patches`` (B, P, frontend_dim), whose P positions come
        before the prompt's: the cache holds ``lens + P`` positions and the
        logits are read at ``lens + P - 1``.  An encdec
        batch carries ``frames`` (B, T, frontend_dim): each layer runs
        self-attention (its KV into the cache), cross-attention over their
        encoding, then its MLP; the encoding is returned as
        ``cache["memory"]`` (B, T, d), which every decode step takes as
        ``batch["memory"]``."""
        cfg = self.cfg
        self._refuse_sharded("prefill")
        params = self._cparams()
        x = self._with_patches(params["embed"][batch["tokens"].long()], params, batch)
        B, S = x.shape[:2]
        if lens is None:
            total = None
            cache: dict[str, Any] = {"pos": torch.tensor(S, dtype=torch.int32,
                                                         device=self.device)}
        else:        # the positions written: the patches' and the prompt's
            total = lens.to(device=self.device, dtype=torch.int32) + self.patch_offset
            cache = {"pos": total}
        if cfg.family in ("hybrid", "rwkv"):
            if lens is not None and bool((lens != S).any()):
                raise ValueError(f"the {cfg.family} family prefills each prompt at its "
                                 "exact length: a padded row would leave its padding in "
                                 "the recurrent state")
        if cfg.family == "hybrid":
            x, state = self._prefill_hybrid(params, x, cache_len, total)
            cache.update(state)
        elif cfg.family == "rwkv":
            x, cache["layers"] = self._prefill_rwkv(params, x)
        else:
            clen = self._attn_cache_len(cache_len)
            kv = init_params(self._kv_specs((B, clen), ("cache_batch", "cache_seq")),
                             None, self.device, self.compute_dtype)
            memory = None
            if cfg.family == "encdec":
                memory = cache["memory"] = self.encode(batch["frames"])
            for ap, kvc, ffn in self._attn_layers(params["layers"], kv, memory):
                x, k, v = blocks.self_attn_block(ap, x, cfg, causal=True,
                                                 return_kv=True, policy=self.compute)
                x = ffn(x)
                _kv_into_cache(kvc, k, v, clen, total)
            cache["layers"] = kv
        last = x[:, -1] if total is None else x[torch.arange(B, device=x.device),
                                               total.long() - 1]
        return self._logits(params, last), cache

    def _prefill_hybrid(self, params: dict, x: torch.Tensor, cache_len: int,
                        total: torch.Tensor | None,
                        layer_hook: Callable[[int, torch.Tensor], None] | None = None
                        ) -> tuple[torch.Tensor, dict]:
        """The zamba2 super units over the prompt (``super_body`` of the
        reference's prefill): each mamba layer leaves its conv window and
        SSD state, each application of the shared block its KV.
        ``layer_hook(i, x)``, if given, sees the hidden state after mamba
        layer i and the shared block that may follow it.  Returns
        (x, {"layers", "shared"})."""
        cfg, pol = self.cfg, self.compute
        specs = self.cache_specs(x.shape[0], cache_len)
        cache = init_params({"layers": specs["layers"], "shared": specs["shared"]},
                            None, self.device, self.compute_dtype)
        per = cfg.n_layers // _n_super(cfg)
        shared = params["shared"]
        for i in range(cfg.n_layers):
            x, mc = ssm.mamba_prefill(_layer(params["layers"], i), x, cfg, policy=pol)
            for name, t in _layer(cache["layers"], i).items():
                t.copy_(mc[name])
            if (i + 1) % per == 0:
                x, k, v = blocks.self_attn_block(shared["attn"], x, cfg, causal=True,
                                                 return_kv=True, policy=pol)
                x = blocks.mlp_block(shared["mlp"], x, cfg, policy=pol)
                _kv_into_cache(_layer(cache["shared"], i // per), k, v,
                               self._attn_cache_len(cache_len), total)
            if layer_hook is not None:
                layer_hook(i, x)
        return x, cache

    def _prefill_rwkv(self, params: dict, x: torch.Tensor,
                      layer_hook: Callable[[int, torch.Tensor], None] | None = None
                      ) -> tuple[torch.Tensor, dict]:
        """The rwkv blocks over the prompt: each leaves its last normed
        tokens and its wkv state.  ``layer_hook(i, x)``, if given, sees the
        hidden state after block i.  Returns (x, the stacked cache leaves)."""
        cfg = self.cfg
        per_layer = []
        for i in range(cfg.n_layers):
            x, c = rwkv.rwkv_prefill(_layer(params["layers"], i), x, cfg, policy=self.compute)
            per_layer.append(c)
            if layer_hook is not None:
                layer_hook(i, x)
        return x, {name: torch.stack([c[name] for c in per_layer]) for name in per_layer[0]}

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, cache: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """One serving step: batch = {"token": (B, 1)} (and for encdec
        "memory" (B, T, d), the encoder's output), optionally "active"
        (B,) bool (inactive slots do not advance ``pos``) and "block_table"
        (B, max_blocks) for the paged pool of :meth:`paged_cache_specs`,
        where inactive slots' writes go to block 0.  ``active`` without a
        block table is the slot-swap cache of :meth:`cache_specs` (the
        reference's ``_freeze_inactive``): an inactive slot's KV rows, conv
        windows, SSD and wkv states and last tokens are left exactly as
        they were.
        ``cache["pos"]`` is a scalar or a (B,) vector (for vlm it counts the
        patch positions too, as prefill wrote them).  The cache leaves are
        updated in place; returns (logits (B, V) fp32, cache with the
        advanced ``pos``)."""
        cfg = self.cfg
        self._refuse_sharded("decode")
        params = self._cparams()
        pos = cache["pos"]
        active = batch.get("active")
        bt = batch.get("block_table")
        x = params["embed"][batch["token"].long()]
        step = 1 if active is None else active.to(pos.dtype)
        if cfg.family in ("hybrid", "rwkv"):
            if bt is not None:
                raise ValueError(f"the {cfg.family} family's cache is fixed-size: it is "
                                 "slot-swapped, never paged")
            if cfg.family == "hybrid":
                x = self._decode_hybrid(params, cache, x, pos, active)
            else:
                for i in range(cfg.n_layers):
                    cl = _layer(cache["layers"], i)
                    x, new = rwkv.rwkv_decode(_layer(params["layers"], i), x, cl, cfg,
                                              policy=self.compute, active=active)
                    _masked_copy(cl, new, active)
            return self._logits(params, x[:, 0]), {**cache, "pos": pos + step}
        memory = None
        if cfg.family == "encdec":
            memory = batch["memory"].to(device=self.device, dtype=self.compute_dtype)
        for ap, kvc, ffn in self._attn_layers(params["layers"], cache["layers"], memory):
            if bt is not None:
                x, _ = blocks.paged_attn_decode(ap, x, kvc, bt, pos, cfg,
                                                active=active, policy=self.compute)
            else:
                x, _ = blocks.self_attn_decode(ap, x, kvc, pos, cfg,
                                               policy=self.compute, active=active)
            x = ffn(x)
        new_cache = {"pos": pos + step, "layers": cache["layers"]}
        return self._logits(params, x[:, 0]), new_cache

    def _decode_hybrid(self, params: dict, cache: dict, x: torch.Tensor,
                       pos: torch.Tensor, active: torch.Tensor | None) -> torch.Tensor:
        """The zamba2 super units over one token (``super_body`` of the
        reference's decode).  Each mamba layer updates its state in place in
        the active slots' rows; its new conv window is a fresh tensor,
        copied into the cache under ``active``."""
        cfg, pol = self.cfg, self.compute
        per = cfg.n_layers // _n_super(cfg)
        shared = params["shared"]
        for i in range(cfg.n_layers):
            mc = _layer(cache["layers"], i)
            x, new = ssm.mamba_decode(_layer(params["layers"], i), x, mc, cfg, policy=pol,
                                      active=active)
            _masked_copy(mc, new, active)
            if (i + 1) % per == 0:
                x, _ = blocks.self_attn_decode(shared["attn"], x,
                                               _layer(cache["shared"], i // per), pos,
                                               cfg, policy=pol, active=active)
                x = blocks.mlp_block(shared["mlp"], x, cfg, policy=pol)
        return x


def _masked_copy(cache: dict, new: dict, active: torch.Tensor | None) -> None:
    """Copy each fresh leaf of ``new`` into its cache leaf (views), in the
    rows of the active slots only: an inactive row is left bit for bit.  A
    leaf that is the cache's own tensor (a state its step updated in place,
    under the same ``active``) is left alone."""
    for name, t in cache.items():
        if new[name] is not t:
            masked_update_(t, new[name].to(t.dtype), active)


def _ring_place(x: torch.Tensor, clen: int,
                lens: torch.Tensor | None = None) -> torch.Tensor:
    """Place full-sequence entries (B, S, ...) into a length-``clen`` cache,
    slot(t) = t % clen (``repro/models/model.py:_ring_place``).  With
    per-request ``lens``, slot s holds timeline position
    t(s) = (lens-1) - ((lens-1-s) mod clen), zero where t < 0."""
    B, S = x.shape[:2]
    if lens is None:
        if S == clen:
            return x
        out = x.new_zeros((B, clen, *x.shape[2:]))
        if S < clen:
            out[:, :S] = x
        else:
            out[:, np.arange(S - clen, S) % clen] = x[:, S - clen:]
        return out
    last = lens.long()[:, None] - 1                              # (B, 1)
    slots = torch.arange(clen, device=x.device)[None, :]         # (1, clen)
    t = last - torch.remainder(last - slots, clen)               # (B, clen)
    gathered = x[torch.arange(B, device=x.device)[:, None], t.clamp(0, S - 1)]
    keep = (t >= 0).reshape(B, clen, *([1] * (x.ndim - 2)))
    return torch.where(keep, gathered, torch.zeros((), dtype=x.dtype, device=x.device))


def _kv_into_cache(kvc: dict, k: torch.Tensor, v: torch.Tensor, clen: int,
                   lens: torch.Tensor | None) -> None:
    """Place a prompt's K and V (B, S, Hkv, hd) into one layer's cache
    leaves (views) by :func:`_ring_place`; an int8 cache (``k_scale`` among
    them) takes them quantized, with their scales
    (``repro/models/model.py:_kv_into_cache``)."""
    if "k_scale" in kvc:
        (kq, ks), (vq, vs) = layers.kv_quantize(k), layers.kv_quantize(v)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k, "v": v}
    for name, t in new.items():
        kvc[name].copy_(_ring_place(t, clen, lens))


def _chunked_cross_entropy(h: torch.Tensor, W: torch.Tensor, labels: torch.Tensor,
                           mask: torch.Tensor, target_chunk: int = 8192,
                           valid_vocab: int | None = None,
                           policy: ComputePolicy | None = None,
                           count: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE of (B, S, d) hidden states against the (d, V) unembedding
    (``repro/models/model.py:_chunked_cross_entropy``).

    ``policy.kernels`` takes the blocked CE kernel (per-token losses; the
    mask and the normalisation stay outside).  Otherwise token chunks of
    ``target_chunk`` rows (the last one ragged: torch needs no divisor of N)
    each run under a checkpoint whatever ``policy.remat`` says, so the
    (N, V) logits are never saved for the backward.  ``count`` replaces
    the mask's sum as the divisor (a data-parallel step's global count)."""
    pol = resolve_policy(policy)
    B, S, d = h.shape
    N = B * S
    hf = h.reshape(N, d)
    yf = labels.reshape(N)
    mf = mask.reshape(N)
    count = (mf.sum() if count is None else count).clamp(min=1.0)
    if pol.kernels:
        losses = kernel_ops.cross_entropy_tokens(hf, W, yf, valid_vocab)
        return (losses * mf).sum() / count
    Vp = W.shape[-1]

    def body(hc, yc, mc):
        logits = (hc @ W).float()
        if valid_vocab is not None and valid_vocab < Vp:
            logits[:, valid_vocab:] = -1e30
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, 1, yc.long()[:, None])[:, 0]
        return ((logz - ll) * mc).sum()

    body = checkpointed(body)
    loss_sum = sum(body(hf[s:s + target_chunk], yf[s:s + target_chunk],
                        mf[s:s + target_chunk]) for s in range(0, N, target_chunk))
    return loss_sum / count
