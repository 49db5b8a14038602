"""The collectives GSPMD inserts for the reference's sharded train step, as
explicit ``torch.distributed`` calls on the mesh's process groups.

  * Megatron's pair (:func:`copy_to_model`, :func:`reduce_from_model`): the
    identity whose backward all-reduces over the model group, in front of a
    column-parallel product, and the all-reduce whose backward is the
    identity, after a row-parallel product (its output is a partial sum);
  * :func:`sum_over_model`, an all-reduce whose backward all-reduces too:
    a sum of the ranks' parts that each rank then uses on its own columns
    only (the sum of squares of a norm over a dim split over the group);
  * :func:`reduce_scatter_to_model` and :func:`all_gather_from_model`, a
    partial sum reduce-scattered into the rank's block of a dim (backward:
    the gradients' blocks all-gathered) and the blocks all-gathered into
    the replicated whole (backward: the rank's block of the gradient), the
    two halves of an all-reduce with a product on the rank's block between
    them (rwkv's channel-mix);
  * ZeRO stage 3's gather-on-use (:class:`LeafGather`): a leaf's block
    all-gathered along its data dim in the compute dtype at each use, and
    the fp32 sum of the uses' gradients reduce-scattered into the block;
  * :func:`all_gather_dim` / :func:`reduce_scatter_dim` along any dim (the
    stage 1-2 update's all-gather and stage 2's per-microbatch
    reduce-scatter), and :func:`all_reduce_` in place;
  * :func:`all_to_all_dim`, the expert group's token all-to-all
    (``models/moe.py:ExpertDispatch``): a tensor split along one dim into
    one block per rank, block j sent to rank j, the blocks received
    concatenated along another dim in rank order; its backward is the
    inverse all-to-all of the gradient.

A one-rank group runs the same calls.  :class:`MeshGroups` is the mesh as
the executor reads it: axis sizes, this rank's coordinate, the groups
(the expert axis of size 1, and no group, on a mesh without one).

Each call adds the bytes it moves to :data:`COMM_BYTES`, by kind, in the
convention of the reference's ``analysis/hlo.py:comm_bytes``: an
all-gather its output, a reduce-scatter its input, an all-reduce twice its
input (a ring's reduce-scatter and all-gather), a point-to-point send its
operand (``runtime/pipeline.py``), an all-to-all its input, the block the
rank keeps included: the local tensor, as ``core/costmodel.py:
predict_a2a_bytes`` prices a reshard.  ZeRO 3's gathers on use count apart,
as ``zero3_gather`` (the ``core/costmodel.py`` key), and so do the expert
slot mask's all-to-alls (one byte a slot, beside the tokens' d values), as
``all-to-all-mask``.  The telemetry reads
them per step (:func:`comm_bytes`, :func:`reset_comm_bytes`); a count is
one integer add on the call.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

# the flat single-tensor collectives; newer torch names them *_single and
# warns on the older names, which an older torch has alone
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

AXES = ("pipe", "data", "model")
# the mesh of a plan with expert parallelism: expert between data and model
EP_AXES = ("pipe", "data", "expert", "model")

COMM_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "zero3_gather", "send",
              "all-to-all", "all-to-all-mask")
COMM_BYTES = dict.fromkeys(COMM_KINDS, 0)


def _count(kind: str, t: torch.Tensor, times: int = 1) -> None:
    COMM_BYTES[kind] += times * t.numel() * t.element_size()


def comm_bytes() -> dict:
    """The bytes this rank's collectives moved since the last reset, by
    kind, and their ``total``."""
    return {**COMM_BYTES, "total": sum(COMM_BYTES.values())}


def reset_comm_bytes() -> None:
    for k in COMM_BYTES:
        COMM_BYTES[k] = 0


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """The ("pipe", "data", "expert", "model") mesh of one rank: ``sizes``
    and ``coord`` ({axis: int}) and ``groups`` ({axis: ProcessGroup});
    ``world`` is the group of every rank of the mesh.  An axis the mesh
    lacks (the expert axis of a plan without expert parallelism) has size
    1, coordinate 0 and no group: a collective over it is skipped."""
    sizes: dict
    coord: dict
    groups: dict
    world: object

    def __post_init__(self):
        for a in EP_AXES:
            self.sizes.setdefault(a, 1)
            self.coord.setdefault(a, 0)
            self.groups.setdefault(a, None)

    @classmethod
    def from_mesh(cls, mesh) -> "MeshGroups":
        """From a ``torch.distributed.device_mesh.DeviceMesh`` with dims
        named ``AXES`` or ``EP_AXES``."""
        names = tuple(mesh.mesh_dim_names)
        if names not in (AXES, EP_AXES):
            raise ValueError(f"mesh dims {names}, expected {AXES} or {EP_AXES}")
        return cls(sizes={a: mesh.size(i) for i, a in enumerate(names)},
                   coord={a: mesh.get_local_rank(a) for a in names},
                   groups={a: mesh.get_group(a) for a in names},
                   world=dist.group.WORLD)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=group)
    _count("all-reduce", t, 2)
    return t


def all_gather_dim(x: torch.Tensor, dim: int, group,
                   kind: str = "all-gather") -> torch.Tensor:
    """The ranks' blocks ``x`` concatenated along ``dim`` in rank order."""
    n = dist.get_world_size(group)
    buf = x.new_empty((n, *x.shape))
    _all_gather(buf.view(-1), x.contiguous().view(-1), group=group)
    _count(kind, buf)
    s = x.shape
    return buf.movedim(0, dim).reshape(*s[:dim], n * s[dim], *s[dim + 1:])


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the ranks of ``x``, split along ``dim`` into one block
    per rank: this rank's block."""
    n = dist.get_world_size(group)
    s = x.shape
    block = (*s[:dim], s[dim] // n, *s[dim + 1:])
    parts = x.reshape(*s[:dim], n, s[dim] // n, *s[dim + 1:]).movedim(dim, 0).contiguous()
    out = x.new_empty(block)
    _reduce_scatter(out.view(-1), parts.view(-1), group=group)
    _count("reduce-scatter", parts)
    return out


def _all_to_all(x: torch.Tensor, split: int, cat: int, group, kind: str) -> torch.Tensor:
    n = dist.get_world_size(group)
    s = x.shape
    send = x.reshape(*s[:split], n, s[split] // n, *s[split + 1:]).movedim(split, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    _count(kind, send)
    block = list(send.shape[1:])
    block[cat] *= n
    return recv.movedim(0, cat).reshape(block)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, cat, group, kind):
        ctx.split, ctx.cat, ctx.group, ctx.kind = split, cat, group, kind
        return _all_to_all(x, split, cat, group, kind)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.cat, ctx.split, ctx.group, ctx.kind), None, None, None, None


def all_to_all_dim(x: torch.Tensor, split: int, cat: int, group,
                   kind: str = "all-to-all") -> torch.Tensor:
    """``x`` split along ``split`` into one block per rank of ``group``,
    block j sent to rank j; the blocks this rank receives concatenated
    along ``cat`` in rank order.  The send buffer is laid out contiguously
    per destination; the backward is the inverse exchange (split along
    ``cat``, concatenated along ``split``)."""
    if not x.is_floating_point():
        return _all_to_all(x, split, cat, group, kind)
    return _AllToAll.apply(x, split, cat, group, kind)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; all-reduces the gradient over ``group``."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduces a partial sum over ``group``; identity backward."""
    return _ReduceFromModel.apply(x, group)


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group), None


def sum_over_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' ``x`` over ``group``; the backward sums the
    ranks' gradients too, since each rank uses the sum on its own part."""
    return _SumOverModel.apply(x, group)


class _ReduceScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


class _AllGatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, dist.get_rank(ctx.group) * ctx.n, ctx.n), None, None


def reduce_scatter_to_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group`` of the ranks' partial ``x``, this rank's block
    along ``dim``; the backward all-gathers the blocks' gradients."""
    return _ReduceScatterToModel.apply(x, dim % x.ndim, group)


def all_gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks ``x`` along ``dim`` gathered into the whole, which
    every rank then uses alike; the backward takes the rank's block of the
    gradient."""
    return _AllGatherFromModel.apply(x, dim % x.ndim, group)


class _ScatterBack(torch.autograd.Function):
    """block -> a zero-stride placeholder of the whole leaf's shape; the
    gradient that accumulates on it (every use's) is reduce-scattered into
    the block."""
    @staticmethod
    def forward(ctx, block, dim, group):
        ctx.dim, ctx.group = dim, group
        shape = list(block.shape)
        shape[dim] *= dist.get_world_size(group)
        return torch.zeros((), dtype=torch.float32, device=block.device).expand(shape)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g.float(), ctx.dim, ctx.group), None, None


class _GatherUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, handle, block, dim, group, dtype):
        return all_gather_dim(block.to(dtype), dim, group, kind="zero3_gather")

    @staticmethod
    def backward(ctx, g):
        return g.float(), None, None, None, None


class LeafGather:
    """One leaf's block under stage 3 (or any data-sharded spec): each call
    all-gathers it along ``dim`` over ``group`` in ``dtype``; the backward
    casts each use's gradient to fp32, sums the uses and reduce-scatters the
    sum into the block once.  Make one per (micro)batch pass; inside a
    checkpointed function the recompute gathers again."""

    def __init__(self, block: torch.Tensor, dim: int, group):
        self.block, self.dim, self.group = block, dim, group
        self.handle = _ScatterBack.apply(block, dim, group)

    def __call__(self, dtype: torch.dtype) -> torch.Tensor:
        return _GatherUse.apply(self.handle, self.block, self.dim, self.group, dtype)
