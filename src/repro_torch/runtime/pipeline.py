"""The pipeline executor: one all-forward-then-all-backward sweep of the
microbatches through ``pp x virtual_stages`` logical stages (the port's
counterpart of ``repro/core/pipeline.py:pipeline_spmd`` as
``repro/models/model.py:loss_pipelined`` drives it).

Each pipe rank walks its applications of ``core/pipeline.py:schedule`` in
tick order.  At an application (microbatch ``j``, logical stage ``s``) it
embeds microbatch ``j`` (``s == 0``) or takes the activation that stage
``s - 1`` handed over as a leaf with ``requires_grad``, runs its local
stage (``core/stage_program.py:split_stages`` of the model's program,
from a zero carry), and keeps the (input, output) pair; the last stage
applies the final norm and the CE, whose output is the loss scaled for the
backward.  The backward walks the same applications in reverse tick order:
``torch.autograd.backward(output, grad)`` with the gradient that stage
``s + 1`` handed back (the loss takes none), then hands ``input.grad`` to
stage ``s - 1``.  The moe family's carries stay on the rank: an
application's aux loss enters the objective as its own term
(``Model.aux_loss`` over the gas microbatches, scaled like the loss), which
its backward takes beside the output (``backward((output, term), (grad,
None))``), so the router's gradient reaches the earlier stages through
``input.grad``; its aux and drop sums add into the sweep's ``sums``.
Parameter gradients accumulate in fp32 in ``.grad`` over the
applications, as the reference's pipeline-scan transpose does.

The encdec family's ``memory`` input carry is encoded on every pipe rank,
as the reference's GSPMD runs its encoder on every pipe rank, and never
rides the ring: before the forward walk each rank gathers the encoder's
layer stack over the pipe group (:class:`PipeEncoder`; the plan
stores it split over the pipe ranks) and encodes every microbatch's frames
in microbatch order; each application reads its microbatch's memory as a
leaf that sums the cotangents of the rank's stages; after the backward walk
the rank backpropagates each microbatch's memory cotangent through its
encode, in microbatch order, and reduce-scatters the gathered stack's
gradient back over the pipe group.  So the ring's bytes are the dense
family's, and every collective of the encoder runs at the same point on
every rank.

The vlm family's ``patches`` enter at stage 0, whose embedding projects
them and puts them ahead of the text, so every hand-off carries
``num_patches + seq`` positions (``Model.patch_offset``); the last stage's
CE drops them.

The hand-off is a local tensor when one process runs every stage
(``ring=None``: the stage split and its boundary backward checked on one
card), or a point-to-point exchange on the pipe group (:class:`Ring`):
activations go to rank ``d + 1`` and their gradients back to ``d - 1``
(mod p: the ring wraps under virtual stages), both in the compute dtype,
received into buffers of the known shape (b, seq, d).  Each tick's sends
and receives are posted together (``dist.batch_isend_irecv``), so no order
of the ranks can deadlock; each send's bytes count in
``runtime/collectives.py``'s ``send``.  :func:`walk_reading` measures the
last sweep of this process: its stage applications, the time they took
(forward and backward) and the sweep's time, on the device's clock (CUDA
events on the compute stream, so a wait for a neighbour's hand-off is
idle time) or on the host's on the CPU; the telemetry's measured idle
share of the pipeline comes from it.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.core import precision as prec
from repro_torch.core import sharding as shd
from repro_torch.core.pipeline import Schedule
from repro_torch.core.stage_program import split_stages
from repro_torch.runtime import collectives


class _Clock:
    """Marks of one sweep: its start, each application's start and end,
    its end.  On a card a mark is a CUDA event on the current stream, read
    only by :func:`walk_reading`; on the CPU, where an op has ended when it
    returns, the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []
        self.applications = 0

    def mark(self) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def timed(self, fn):
        def run(*args):
            self.mark()
            out = fn(*args)
            self.mark()
            return out
        return run

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a


_last_clock: _Clock | None = None


def walk_reading() -> dict:
    """This process's last sweep: its forward stage applications, the
    seconds they took forward and backward (``busy_s``) and the seconds of
    the whole sweep (``wall_s``); zeros before the first sweep.  On a card
    it waits for the sweep's end."""
    clock = _last_clock
    if clock is None:
        return {"applications": 0, "busy_s": 0.0, "wall_s": 0.0}
    marks = clock.marks
    if clock.cuda:
        marks[-1].synchronize()
    busy = sum(clock.seconds(marks[i], marks[i + 1]) for i in range(1, len(marks) - 1, 2))
    return {"applications": clock.applications, "busy_s": busy,
            "wall_s": clock.seconds(marks[0], marks[-1])}


class Ring:
    """This rank's neighbours on the pipe group (global ranks)."""

    def __init__(self, group, device: torch.device):
        self.group = group
        p, d = dist.get_world_size(group), dist.get_rank(group)
        self.prev = dist.get_global_rank(group, (d - 1) % p)
        self.next = dist.get_global_rank(group, (d + 1) % p)
        self.rank = d
        # a collective on every rank of the group before its first
        # point-to-point exchange, which only some ranks join (nccl)
        dist.all_reduce(torch.zeros(1, device=device), group=group)


def loss_count(batch: dict, device: torch.device) -> torch.Tensor:
    """The CE's divisor: the token count of the whole global batch."""
    mask = batch.get("loss_mask")
    tokens = batch["tokens"]
    if mask is None:
        return torch.tensor(float(tokens.shape[0] * (tokens.shape[1] - 1)),
                            dtype=torch.float32, device=device)
    return mask[:, 1:].float().sum()


class PipeEncoder:
    """The encdec encoder's layer stack for one pipelined step.  Each leaf
    the plan puts on the pipe axis (a storage partition, contiguous blocks
    in pipe order) is all-gathered whole over the pipe group, in the
    storage dtype, into a leaf of its own that takes the gradient of every
    encode this rank runs; the other leaves are the stored ones.
    :meth:`scatter` reduce-scatters the gathered leaves' gradients over the
    pipe group into the parameters' ``.grad``: each rank's block of the sum
    over every rank's encodes.  The leaves kept whole over the pipe group
    are summed over it by the step, as every such leaf is.  The bytes
    count as ``pipe_gather`` and ``pipe_scatter`` in
    ``runtime/collectives.py``.  ``layers`` is the stack as
    :meth:`Model.encode` takes it."""

    PREFIX = "encoder.layers."

    def __init__(self, model):
        self.group = None if model.mesh is None else model.mesh.groups["pipe"]
        self.gathered: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
        self.layers: dict = {}
        for path, p in model.named_parameters():
            if not path.startswith(self.PREFIX):
                continue
            leaf = p
            if model.shardings is not None and "pipe" in shd.spec_axes(model.shardings[path]):
                leaf = collectives.all_gather_dim(p.detach(), 0, self.group,
                                                  "pipe_gather").requires_grad_()
                self.gathered[path] = (p, leaf)
            *parents, name = path[len(self.PREFIX):].split(".")
            node = self.layers
            for k in parents:
                node = node.setdefault(k, {})
            node[name] = leaf

    def scatter(self) -> None:
        for p, leaf in self.gathered.values():
            g = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
            part = collectives.reduce_scatter_dim(g, 0, self.group, "pipe_scatter")
            p.grad = part if p.grad is None else p.grad.add_(part)


class _Stages:
    """What a rank runs at its applications: the model's local stages,
    logical stage s in local slot ``slot(s)``."""

    def __init__(self, model, sched: Schedule, micro: list[dict], count: torch.Tensor,
                 loss_scale: dict, n_local: int, slot, sums: dict | None):
        self.model, self.micro, self.count, self.ls = model, micro, count, loss_scale
        self.last = sched.n_stages - 1
        self.gas = sched.m
        self.n_local, self.slot = n_local, slot
        self.ce = torch.zeros((), dtype=torch.float32, device=model.device)
        self.sums = sums
        # encdec: (the encode's output, the leaf the stages read) a microbatch
        self.memory: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self.encoder = None

    def encode(self) -> None:
        """Gather the encoder and encode every microbatch's frames, in
        microbatch order (encdec; nothing for the other families)."""
        model = self.model
        if model.cfg.family != "encdec":
            return
        self.encoder = PipeEncoder(model)
        for j, mb in enumerate(self.micro):
            out = model.encode(mb["frames"], self.encoder.layers)
            self.memory[j] = (out, out.detach().requires_grad_())

    def encoder_backward(self) -> None:
        """Each microbatch's memory cotangent through its encode, in
        microbatch order, then the gathered stack's gradient reduce-scattered
        over the pipe group (encdec; nothing for the other families)."""
        if self.encoder is None:
            return
        for j in sorted(self.memory):
            out, leaf = self.memory.pop(j)
            if leaf.grad is not None:
                torch.autograd.backward(out, leaf.grad)
        self.encoder.scatter()

    def forward(self, j: int, s: int, x: torch.Tensor | None):
        """(input leaf or None at stage 0, output: activation or scaled
        loss, the scaled aux term its backward also takes, or None)."""
        model = self.model
        if s == 0:
            inp, h = None, model._embed(model.params(), self.micro[j])
        else:
            inp = x.detach().requires_grad_()
            h = inp
        # a fresh program per application: its data-sharded leaves gather
        # anew, as each microbatch's pass does at pp = 1
        prog = model.stage_program()
        params, stage_fn = split_stages(prog, self.n_local)
        inputs = {"memory": self.memory[j][1]} if self.memory else None
        h, carry = stage_fn(params[self.slot(s)], h, prog.init_carry(h.device, inputs))
        term = None
        if "moe_drop" in carry:
            if self.sums is not None:
                self.sums["aux"] += carry["aux"].detach()
                self.sums["moe_drop"] += carry["moe_drop"].detach() / model.n_moe_units
            term = model.aux_loss(carry["aux"]) / self.gas
        if s < self.last:
            return inp, h, None if term is None else prec.scale_loss(self.ls, term)
        ce = model._ce_from_hidden(model.normed(h), self.micro[j], self.count)
        self.ce += ce.detach()
        return inp, prec.scale_loss(self.ls, ce if term is None else ce + term), None

    @staticmethod
    def backward(inp, out, grad, term=None) -> torch.Tensor | None:
        if term is None:
            torch.autograd.backward(out, grad)
        else:
            torch.autograd.backward((out, term), (grad, None))
        return None if inp is None else inp.grad


def _walk(events: list, compute, recv_from: int, send_to: int, group, buffer) -> None:
    """Run ``events`` ([(tick, item, receives, sends)] in tick order): at each
    tick post the send of the previous tick's result and this tick's
    receive together, then ``compute(item, received)``."""
    at = {t: (item, recv, send) for t, item, recv, send in events}
    ticks = sorted(set(at) | {t + 1 for t, _, _, send in events if send})
    outbox: dict[int, torch.Tensor] = {}
    for t in ticks:
        ops, x = [], None
        if t in outbox:
            y = outbox.pop(t)
            ops.append(dist.P2POp(dist.isend, y, send_to, group))
            collectives._count("send", y)
        item, recv, send = at.get(t, (None, False, False))
        if recv:
            x = buffer()
            ops.append(dist.P2POp(dist.irecv, x, recv_from, group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if item is not None:
            y = compute(item, x)
            if send:
                outbox[t + 1] = y.detach().contiguous()


def sweep(model, sched: Schedule, micro: list[dict], count: torch.Tensor,
          loss_scale: dict, ring: Ring | None = None, sums: dict | None = None
          ) -> torch.Tensor:
    """One sweep of ``sched.m`` microbatches (``micro``: this batch rank's
    rows of each): fills the ``.grad`` of the parameters the rank's stages
    and its embedding or loss used, and returns the sum of the last stage's
    CE over the microbatches (zero on any other rank).  ``model`` holds
    every stage when ``ring`` is None (one process), else the stages of pipe
    rank ``ring.rank``; the CE of each microbatch is its rows' sum over
    ``count``.  ``sums`` ({"aux", "moe_drop"} fp32 scalars), if given,
    takes the moe family's carries of the rank's applications."""
    global _last_clock
    S = sched.n_stages
    clock = _Clock(model.device)
    clock.mark()
    if ring is None:
        stages = _Stages(model, sched, micro, count, loss_scale, S, lambda s: s, sums)
        clock.timed(stages.encode)()
        forward, backward = clock.timed(stages.forward), clock.timed(stages.backward)
        outs, kept = {}, []
        walk = sorted(a for apps in sched.ranks for a in apps)
        for _, j, s in walk:
            inp, out, term = forward(j, s, outs.pop((j, s - 1), None))
            if s < S - 1:
                outs[j, s] = out
            kept.append((j, s, inp, out, term))
        grads: dict = {}
        while kept:
            j, s, inp, out, term = kept.pop()
            g = backward(inp, out, grads.pop((j, s), None), term)
            if s > 0:
                grads[j, s - 1] = g
        clock.timed(stages.encoder_backward)()
        clock.mark()
        clock.applications = len(walk)
        _last_clock = clock
        return stages.ce

    stages = _Stages(model, sched, micro, count, loss_scale, sched.v, sched.slot_of, sums)
    clock.timed(stages.encode)()
    # the hand-off's positions: the text's, and for vlm the patches' ahead of it
    b, seq = micro[0]["tokens"].shape
    shape = (b, model.patch_offset + seq, model.cfg.d_model)

    def buffer():
        return torch.empty(shape, dtype=model.compute_dtype, device=model.device)

    apps = sched.ranks[ring.rank]
    kept = {}

    def forward(item, x):
        inp, out, term = stages.forward(*item, x)
        if item[1] < S - 1 and (out.shape != shape or out.dtype != model.compute_dtype):
            raise RuntimeError(f"stage {item[1]} hands over {out.dtype} {tuple(out.shape)}, "
                               f"the next expects {model.compute_dtype} {shape}")
        kept[item] = (inp, out, term)
        return out

    def backward(item, g):
        inp, out, term = kept.pop(item)
        return stages.backward(inp, out, g, term)

    _walk([(t, (j, s), s > 0, s < S - 1) for t, j, s in apps],
          clock.timed(forward), ring.prev, ring.next, ring.group, buffer)
    last = sched.ticks - 1
    _walk([(last - t, (j, s), s < S - 1, s > 0) for t, j, s in reversed(apps)],
          clock.timed(backward), ring.next, ring.prev, ring.group, buffer)
    clock.timed(stages.encoder_backward)()
    clock.mark()
    clock.applications = len(apps)
    _last_clock = clock
    return stages.ce
