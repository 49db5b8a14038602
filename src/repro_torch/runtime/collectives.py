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
  * :func:`all_gather_to_model`, the blocks all-gathered into the whole
    that each rank then uses for its own part of the work, so that the
    ranks' gradients of it are partial sums: its backward reduce-scatters
    them (sequence parallelism: the sequence gathered in front of a
    column-parallel product, the vocab-parallel CE or a routing, and a
    whole attention's K and V; :func:`reduce_scatter_to_model` after a
    row-parallel product is its other half);
  * ZeRO stage 3's gather-on-use (:class:`LeafGather`): a leaf's block
    all-gathered in the compute dtype at each use, and the fp32 sum of the
    uses' gradients reduce-scattered into the block.  Under the
    hierarchical CommPlan a block on both the node and the data axis is
    gathered in two phases, the node dim first (inter-node) and then the
    data dim (intra-node), and its gradient reduce-scattered in the
    reverse order (:func:`gather_phases`, :func:`scatter_phases`).  A
    quantized leaf (``qcomm``) gathers its int8 payload and fp32 block
    scales (``runtime/qcollect.py``), never its values.  A gather can be
    issued ahead of its use (:meth:`LeafGather.prefetch`, the overlap of
    ``core/stage_program.py:run_program``): the last phase runs with
    ``async_op=True``, on the card from a side stream, and the use waits on
    its handles;
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
(the node and expert axes of size 1, and no group, on a mesh without
them), and the group of the composite (node, data) ranks that the data
reductions run over.

Each call adds the bytes it moves to :data:`COMM_BYTES`, by kind, in the
convention of the reference's ``analysis/hlo.py:comm_bytes``: an
all-gather its output, a reduce-scatter its input, an all-reduce twice its
input (a ring's reduce-scatter and all-gather), a point-to-point send its
operand (``runtime/pipeline.py``), an all-to-all its input, the block the
rank keeps included: the local tensor, as ``core/costmodel.py:
predict_a2a_bytes`` prices a reshard.  ZeRO 3's gathers on use count apart,
as ``zero3_gather`` (the ``core/costmodel.py`` key), its phases split
into intra (over the data group) and inter (over the node group) bytes
(:func:`gather_phase_bytes`, what ``core/commplan.py:leaf_gather_bytes``
prices), and so do the expert
slot mask's all-to-alls (one byte a slot, beside the tokens' d values), as
``all-to-all-mask``, and the encdec encoder's gather over the pipe group at
pp > 1 and its gradient's reduce-scatter (``runtime/pipeline.py:PipeEncoder``),
as ``pipe_gather`` and ``pipe_scatter``.  The telemetry reads
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
# the hierarchical CommPlan's axis, ahead of the others (node-major)
NODE = "node"
ALL_AXES = (NODE,) + EP_AXES
# the tier of a ZeRO gather phase by the axis it runs over
TIER = {"data": "intra", NODE: "inter"}

COMM_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "zero3_gather", "send",
              "all-to-all", "all-to-all-mask", "pipe_gather", "pipe_scatter")
COMM_BYTES = dict.fromkeys(COMM_KINDS, 0)
GATHER_PHASES = {"intra": 0, "inter": 0}


def _count(kind: str, t: torch.Tensor, times: int = 1) -> None:
    COMM_BYTES[kind] += times * t.numel() * t.element_size()


def comm_bytes() -> dict:
    """The bytes this rank's collectives moved since the last reset, by
    kind, and their ``total``."""
    return {**COMM_BYTES, "total": sum(COMM_BYTES.values())}


def gather_phase_bytes() -> dict:
    """The ``zero3_gather`` bytes since the last reset split by phase:
    ``intra`` (over the data group), ``inter`` (over the node group) and
    their ``total``."""
    return {**GATHER_PHASES, "total": sum(GATHER_PHASES.values())}


def reset_comm_bytes() -> None:
    for d in (COMM_BYTES, GATHER_PHASES):
        for k in d:
            d[k] = 0


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """The ("node", "pipe", "data", "expert", "model") mesh of one rank:
    ``sizes`` and ``coord`` ({axis: int}) and ``groups`` ({axis:
    ProcessGroup}); ``world`` is the group of every rank of the mesh and
    ``dp`` the group of the ranks that differ in their node and data
    coordinates alone (the data group without a node axis).  An axis the
    mesh lacks (the node axis at node = 1, the expert axis of a plan
    without expert parallelism) has size 1, coordinate 0 and no group: a
    collective over it is skipped."""
    sizes: dict
    coord: dict
    groups: dict
    world: object
    dp: object = None

    def __post_init__(self):
        for a in ALL_AXES:
            self.sizes.setdefault(a, 1)
            self.coord.setdefault(a, 0)
            self.groups.setdefault(a, None)
        if self.dp is None:
            object.__setattr__(self, "dp", self.groups["data"])

    @classmethod
    def from_mesh(cls, mesh) -> "MeshGroups":
        """From a ``torch.distributed.device_mesh.DeviceMesh`` with dims
        named ``AXES`` or ``EP_AXES``, either led by ``NODE``."""
        names = tuple(mesh.mesh_dim_names)
        if names not in (AXES, EP_AXES, (NODE,) + AXES, (NODE,) + EP_AXES):
            raise ValueError(f"mesh dims {names}, expected {AXES} or {EP_AXES}, "
                             f"either led by {NODE!r}")
        dp = None
        if NODE in names:            # one group per coordinate of the other axes
            ranks = mesh.mesh.movedim(names.index("data"), -1).movedim(0, -2)
            dp, _ = dist.new_subgroups_by_enumeration(
                ranks.reshape(-1, ranks.shape[-2] * ranks.shape[-1]).tolist())
        return cls(sizes={a: mesh.size(i) for i, a in enumerate(names)},
                   coord={a: mesh.get_local_rank(a) for a in names},
                   groups={a: mesh.get_group(a) for a in names},
                   world=dist.group.WORLD, dp=dp)

    def group_over(self, axes) -> object:
        """The group of the ranks that differ in ``axes`` alone: one axis's,
        or ``dp`` for both the node and the data axis; None for none."""
        axes = set(axes)
        if axes == {NODE, "data"}:
            return self.dp
        if len(axes) > 1:
            raise ValueError(f"no group over the axes {sorted(axes)}")
        return self.groups[axes.pop()] if axes else None


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=group)
    _count("all-reduce", t, 2)
    return t


def _gather_start(x: torch.Tensor, group, kind: str, async_op: bool = False):
    """(buffer of the ranks' blocks ``x`` stacked on a new dim 0, the
    collective's handle: None unless ``async_op``)."""
    n = dist.get_world_size(group)
    buf = x.new_empty((n, *x.shape))
    work = _all_gather(buf.view(-1), x.contiguous().view(-1), group=group, async_op=async_op)
    _count(kind, buf)
    return buf, work


def _gathered(buf: torch.Tensor, dim: int) -> torch.Tensor:
    """A stacked gather buffer as the blocks concatenated along ``dim``."""
    n, s = buf.shape[0], buf.shape[1:]
    return buf.movedim(0, dim).reshape(*s[:dim], n * s[dim], *s[dim + 1:])


def all_gather_dim(x: torch.Tensor, dim: int, group,
                   kind: str = "all-gather") -> torch.Tensor:
    """The ranks' blocks ``x`` concatenated along ``dim`` in rank order."""
    return _gathered(_gather_start(x, group, kind)[0], dim)


def gather_phases(x: torch.Tensor, phases, kind: str = "all-gather") -> torch.Tensor:
    """``x`` all-gathered over each (group, dim) of ``phases`` in turn: a
    block sharded on the node and the data axis (``phases`` in that order)
    back to the whole, the node phase first."""
    for group, dim in phases:
        x = all_gather_dim(x, dim, group, kind)
    return x


def scatter_phases(x: torch.Tensor, phases) -> torch.Tensor:
    """The inverse of :func:`gather_phases` on a sum: ``x`` reduce-scattered
    over each (group, dim) of ``phases`` in reverse order (the data phase,
    then the node phase), the rank's block of the sum over every rank of
    the groups."""
    for group, dim in reversed(phases):
        x = reduce_scatter_dim(x, dim, group)
    return x


def reduce_scatter_dim(x: torch.Tensor, dim: int, group,
                       kind: str = "reduce-scatter") -> torch.Tensor:
    """The sum over the ranks of ``x``, split along ``dim`` into one block
    per rank: this rank's block."""
    n = dist.get_world_size(group)
    s = x.shape
    block = (*s[:dim], s[dim] // n, *s[dim + 1:])
    parts = x.reshape(*s[:dim], n, s[dim] // n, *s[dim + 1:]).movedim(dim, 0).contiguous()
    out = x.new_empty(block)
    _reduce_scatter(out.view(-1), parts.view(-1), group=group)
    _count(kind, parts)
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


class _AllGatherToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def reduce_scatter_to_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group`` of the ranks' partial ``x``, this rank's block
    along ``dim``; the backward all-gathers the blocks' gradients."""
    return _ReduceScatterToModel.apply(x, dim % x.ndim, group)


def all_gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks ``x`` along ``dim`` gathered into the whole, which
    every rank then uses alike; the backward takes the rank's block of the
    gradient."""
    return _AllGatherFromModel.apply(x, dim % x.ndim, group)


def all_gather_to_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks ``x`` along ``dim`` gathered into the whole, of
    which each rank computes its own part (its heads, columns, experts or
    queries); the backward reduce-scatters the ranks' partial gradients
    into this rank's block."""
    return _AllGatherToModel.apply(x, dim % x.ndim, group)


def _scatter(g: torch.Tensor, phases, quant) -> torch.Tensor:
    """The fp32 sum ``g`` of a leaf's uses' gradients reduce-scattered into
    its block over ``phases`` (fake-quantized under ``qcomm="both"``)."""
    g = scatter_phases(g, [(group, dim) for group, dim, _ in phases])
    return g if quant is None else quant.grad(g)


class _ScatterBack(torch.autograd.Function):
    """block -> a zero-stride placeholder of the whole leaf's shape; the
    gradient that accumulates on it (every use's) is reduce-scattered into
    the block (:func:`_scatter`)."""
    @staticmethod
    def forward(ctx, block, shape, phases, quant):
        ctx.phases, ctx.quant = phases, quant
        return torch.zeros((), dtype=torch.float32, device=block.device).expand(shape)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g.float(), ctx.phases, ctx.quant), None, None, None


class _GatherUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, handle, block, leaf, dtype):
        return leaf.gather(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.float(), None, None, None


class _Pending:
    """A gather whose last phase is in flight: its buffers and handles,
    the stream it was issued from, and what turns the buffers into the
    leaf."""

    def __init__(self, bufs, works, stream, finish):
        self.bufs, self.works, self.stream, self.finish = bufs, works, stream, finish

    def result(self) -> torch.Tensor:
        for w in self.works:
            if w is not None:
                w.wait()
        if self.stream is not None:
            main = torch.cuda.current_stream(self.bufs[0].device)
            main.wait_stream(self.stream)
            for b in self.bufs:
                b.record_stream(main)
        return self.finish(*self.bufs)


class LeafGather:
    """One leaf's block under stage 3 (or any spec on the data or node
    axis): each call all-gathers it over ``phases`` ((group, dim, axis) in
    gather order: the node phase first) in ``dtype``; the backward casts
    each use's gradient to fp32, sums the uses and reduce-scatters the sum
    into the block once, the phases in reverse.  With ``quant``
    (``runtime/qcollect.py:QuantGather``) the block is block-quantized from
    the stored fp32 values, its int8 payload and fp32 scales gathered and
    dequantized to ``dtype``; the reduce-scattered gradient is
    fake-quantized when it says so.  Make one per (micro)batch pass; inside
    a checkpointed function the recompute gathers again.  :meth:`prefetch`
    issues the gather ahead of the call that uses it."""

    def __init__(self, block: torch.Tensor, phases, quant=None):
        self.block, self.phases, self.quant = block, tuple(phases), quant
        shape = list(block.shape)
        for group, dim, _ in self.phases:
            shape[dim] *= dist.get_world_size(group)
        self.shape = tuple(shape)
        self._pending: dict = {}
        self.handle = _ScatterBack.apply(block, self.shape, self.phases, quant)

    def __call__(self, dtype: torch.dtype) -> torch.Tensor:
        return _GatherUse.apply(self.handle, self.block, self, dtype)

    def _start(self, dtype: torch.dtype, async_op: bool, stream=None) -> _Pending:
        """Every phase but the last run (the last in flight if
        ``async_op``), from ``stream`` if given."""
        with torch.no_grad():
            if self.quant is None:
                parts, finish = [self.block.to(dtype)], lambda x: x
            else:
                parts = list(self.quant.quantize(self.block))
                finish = lambda q, s: self.quant.dequantize(q, s, dtype)  # noqa: E731
            works = [None] * len(parts)
            for i, (group, dim, axis) in enumerate(self.phases):
                last = i == len(self.phases) - 1
                out = []
                for j, t in enumerate(parts):
                    buf, works[j] = _gather_start(t, group, "zero3_gather", async_op and last)
                    GATHER_PHASES[TIER[axis]] += buf.numel() * buf.element_size()
                    out.append(buf)
                parts = out if last else [_gathered(b, dim) for b in out]
        last_dim = self.phases[-1][1]
        return _Pending(parts, works, stream,
                        lambda *bufs: finish(*[_gathered(b, last_dim) for b in bufs]))

    def prefetch(self, dtype: torch.dtype, stream=None) -> None:
        """Issue the gather in ``dtype`` now (on a card from the side
        ``stream``, after the work queued so far); the next call in that
        dtype waits on it instead of gathering (a recompute, after it,
        gathers again)."""
        if dtype in self._pending:
            return
        if stream is None:
            self._pending[dtype] = self._start(dtype, async_op=True)
            return
        stream.wait_stream(torch.cuda.current_stream(self.block.device))
        with torch.cuda.stream(stream):
            self._pending[dtype] = self._start(dtype, async_op=True, stream=stream)

    def gather(self, dtype: torch.dtype) -> torch.Tensor:
        """The whole leaf in ``dtype`` (no autograd: :meth:`__call__` is the
        use)."""
        pending = self._pending.pop(dtype, None)
        return (pending or self._start(dtype, async_op=False)).result()
