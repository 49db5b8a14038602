"""The process group and the ("pipe", "data", "model") device mesh of a
``ParallelPlan``, ("pipe", "data", "expert", "model") at ep > 1, and with a
hierarchical node axis (node > 1) the same led by "node" (the port of
``repro/launch/mesh.py:validate_plan_shape``, ``make_mesh_4d``,
``make_mesh_4d_ep``, ``make_mesh_5d`` and ``mesh_for_plan``).

Ranks come from the launcher's environment (``torchrun`` /
``python -m torch.distributed.run``: RANK, WORLD_SIZE, LOCAL_RANK and the
master's address) unless the caller passes them with an ``init_method``.
On the card the group is nccl and each rank sets ``cuda:LOCAL_RANK`` before
the group is made; on the CPU it is gloo.  The mesh puts the model dim
fastest and the pipe dim slowest, as the reference does: ranks 2i and
2i + 1 share a model group at tp = 2, and at pp = 2 the first half of the
ranks is pipe rank 0.  The pipe dim has size pp.  The expert dim sits
between data and model: tensor parallelism keeps the nearest ranks, the
token all-to-all the next, and the batch's rows split over data then
expert, so an ep plan gives each rank the rows of the flat dp x ep plan.
The node dim is the slowest of all (node-major): a data group is
adjacent ranks (one node's fast links), a node group strided ones (the
inter-node fabric), and the rows split over node first, so a node x dp
plan gives each rank the rows of the flat (node dp) plan.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.runtime.collectives import AXES, EP_AXES, NODE

# the meta device's group is the dry run's fake one (launch/dryrun.py)
BACKEND = {"cuda": "nccl", "cpu": "gloo", "meta": "cpu:fake,meta:fake"}


def init_distributed(device: torch.device, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     timeout: datetime.timedelta | None = None) -> None:
    """Make the default process group for ``device`` unless one exists."""
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_initialized():
        check_backend(device)
        return
    kw = {} if init_method is None else {"init_method": init_method, "rank": rank,
                                         "world_size": world_size}
    if timeout is not None:
        kw["timeout"] = timeout
    dist.init_process_group(BACKEND[device.type], **kw)


def check_backend(device: torch.device) -> None:
    """On the card the group is nccl: nothing falls back to gloo there."""
    backend = dist.get_backend()
    if backend != BACKEND[device.type]:
        raise RuntimeError(f"a {device.type} run needs the {BACKEND[device.type]} "
                           f"process group, this one is {backend}")


def validate_plan_shape(pipe: int, data: int, model: int, n_devices: int | None = None,
                        node: int = 1, ep: int = 1) -> None:
    """Raise a clear error when (node, pp, dp, ep, tp) cannot tile the
    ranks."""
    for name, v in (("pp", pipe), ("dp", data), ("tp", model), ("node", node), ("ep", ep)):
        if v < 1:
            raise ValueError(f"--{name} must be >= 1, got {v}")
    n = dist.get_world_size() if n_devices is None else n_devices
    want = node * pipe * data * ep * model
    plan_txt = (f"pp={pipe} x dp={data} x tp={model}" if ep == 1
                else f"pp={pipe} x dp={data} x ep={ep} x tp={model}")
    if node > 1:
        plan_txt = f"node={node} x " + plan_txt
    if want != n:
        raise ValueError(f"parallel plan {plan_txt} = {want} ranks, but the process "
                         f"group has {n}; pick factors whose product is the world size "
                         f"(e.g. --nproc-per-node {want})")


def mesh_for_plan(plan, device: torch.device, n_devices: int | None = None) -> DeviceMesh:
    """The (pp, dp, tp) mesh a ParallelPlan asks for, over the default
    group; (pp, dp, ep, tp) at ep > 1; led by the node dim at node > 1."""
    ep = getattr(plan, "ep", 1)
    node = getattr(plan, "node", 1)
    validate_plan_shape(plan.pp, plan.dp, plan.tp, n_devices, node=node, ep=ep)
    check_backend(device)
    names = EP_AXES if ep > 1 else AXES
    sizes = (plan.pp, plan.dp, ep, plan.tp) if ep > 1 else (plan.pp, plan.dp, plan.tp)
    if node > 1:
        names, sizes = (NODE,) + names, (node,) + sizes
    return init_device_mesh(device.type, sizes, mesh_dim_names=names)
