"""Helpers of the port's multi-rank tests: gloo ranks spawned on the CPU
run train plans of the port's sharded executor and hand back their
trajectories; the single-device trajectories they are held to.  Imports
nothing of the JAX package, so the spawned ranks never load it."""
from __future__ import annotations

import datetime
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.checkpointing import (latest_step, restore_checkpoint, save_checkpoint,
                                       state_shardings)
from repro_torch.configs import get_config
from repro_torch.core import sharding as shd
from repro_torch.data import SyntheticCorpus, make_batch_iterator
from repro_torch.interop import from_jax_params, gather_params, mesh_axes, shard_params
from repro_torch.launch.mesh import init_distributed, mesh_for_plan
from repro_torch.launch.train import draw_extras, extra_specs
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import collectives, pipeline
from repro_torch.runtime.train_loop import (ParallelPlan, build_model, build_train_step,
                                            init_train_state)

STEPS, SEQ, BATCH = 3, 32, 8
LR = 1e-3


def batches(vocab: int, n: int = STEPS, cfg=None) -> list[dict]:
    """``n`` global batches; ``cfg`` adds its family's dense inputs (the
    encdec family's frames, ``launch/train.py:extra_specs``)."""
    it = make_batch_iterator(SyntheticCorpus(vocab_size=vocab, seed=0), seq_len=SEQ,
                             global_batch=BATCH, prefetch=0,
                             extra_specs=None if cfg is None else extra_specs(cfg))
    return [next(it) for _ in range(n)]


def config(arch: str, overrides: dict):
    return get_config(arch).reduced(**overrides)


def trajectory(step, state, bs, comm: list | None = None,
               walks: list | None = None, moe: list | None = None,
               phases: list | None = None, flops: list | None = None) -> list[tuple]:
    """(loss, grad_norm, grads_finite, loss_scale) of each step; ``comm``
    takes each step's collective bytes (``runtime/collectives.py``),
    ``walks`` its pipeline sweep's times (``runtime/pipeline.py``), ``moe``
    its (moe_aux, moe_drop), ``phases`` its ZeRO gather bytes by phase,
    ``flops`` its ``FlopCounterMode`` total."""
    out = []
    for b in bs:
        collectives.reset_comm_bytes()
        if flops is None:
            state, m = step(state, b)
        else:
            with FlopCounterMode(display=False) as counter:
                state, m = step(state, b)
            flops.append(counter.get_total_flops())
        if comm is not None:
            comm.append(collectives.comm_bytes())
        if phases is not None:
            phases.append(collectives.gather_phase_bytes())
        if walks is not None:
            walks.append(pipeline.walk_reading())
        if moe is not None:
            moe.append((float(m["moe_aux"]), float(m["moe_drop"])))
        out.append((float(m["loss"]), float(m["grad_norm"]), bool(m["grads_finite"]),
                    float(m["loss_scale"])))
    return out


def single_device(arch: str, overrides: dict, weights: dict, plan: dict,
                  n: int = STEPS, moe: list | None = None) -> tuple[list[tuple], dict]:
    """The port's single-device step from ``weights`` (a flat numpy tree):
    (its trajectory, its weights after the steps); ``moe`` takes each
    step's (moe_aux, moe_drop)."""
    cfg = config(arch, overrides)
    model = Model(cfg, torch.float32, device="cpu")
    model.load_state_dict(from_jax_params(weights, model))
    opt = AdamWConfig(lr=LR)
    p = ParallelPlan(**plan)
    traj = trajectory(build_train_step(model, opt, p), init_train_state(model, opt, p),
                      batches(cfg.vocab_size, n, cfg), moe=moe)
    return traj, {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def grads_check(model: Model, plan: ParallelPlan) -> dict:
    """The gradients of one fp32 loss (the first batch's first 4 rows) on
    the rank's blocks, put together over every rank (``gather_params``),
    against the single-device port's on the same whole weights and rows:
    {leaf: (max |difference|, max |single-device gradient|)}.  Under
    sequence parallelism a leaf whole over the model group takes each
    rank's shard's part, summed over the group first, as the train step
    sums it."""
    cfg = model.cfg
    batch = {k: torch.from_numpy(v[:4]) for k, v in batches(cfg.vocab_size, 1, cfg)[0].items()}

    def grads(m: Model) -> dict:
        m.requires_grad_(True)
        m.zero_grad(set_to_none=True)
        m.with_policy(m.compute, torch.float32).loss(batch)[0].backward()
        # a leaf the loss does not reach (llama4's shared expert's ln) has none
        return {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None
                else p.grad.numpy().copy() for k, p in m.named_parameters()}

    mine = grads(model)
    if plan.seq_parallel:
        for k, spec in model.shardings.items():
            if "model" not in shd.spec_axes(spec):
                t = torch.from_numpy(mine[k])
                dist.all_reduce(t, group=model.mesh.groups["model"])
                mine[k] = t.numpy()
    blocks = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, (dict(model.mesh.coord), blocks, mine))
    where = {tuple(c[a] for a in mesh_axes(plan)): i for i, (c, _, _) in enumerate(ranks)}
    whole = gather_params({k: ranks[i][1] for k, i in where.items()}, cfg, plan)
    tp = gather_params({k: ranks[i][2] for k, i in where.items()}, cfg, plan)
    single = Model(cfg, torch.float32, device="cpu")
    single.load_state_dict(from_jax_params(whole, single))
    return {k: (float(np.abs(tp[k] - g).max()), float(np.abs(g).max()))
            for k, g in grads(single).items()}


def prefill_refused(model: Model, plan: ParallelPlan) -> str:
    """What prefill of a sharded model raises."""
    try:
        model.prefill({"tokens": torch.zeros((1, 4), dtype=torch.int32)}, 8)
    except NotImplementedError as e:
        return str(e)
    return "no error"


def split_norm_check(model: Model, plan: ParallelPlan) -> dict:
    """``layers.rms_norm_split`` over the model's model group on each rank's
    column block of one seeded (x, weight, output gradient), all-gathered:
    its value and the gradients of x and the weight (the sum over the ranks
    of each one's output against its block of the gradient), and the
    whole-dim ``rms_norm``'s on the same inputs."""
    from repro_torch.models import layers
    from repro_torch.runtime.collectives import all_gather_dim

    group = model.mesh.groups["model"]
    n, k = dist.get_world_size(group), model.mesh.coord["model"]
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 16, 96, generator=gen)
    w = 1.0 + 0.1 * torch.randn(96, generator=gen)
    dy = torch.randn(4, 16, 96, generator=gen)
    cols = slice(k * 96 // n, (k + 1) * 96 // n)
    parts = [t[..., cols].clone().requires_grad_() for t in (x, w)]
    y = layers.rms_norm_split(*parts, 1e-5, group)
    (y * dy[..., cols]).sum().backward()
    split = [all_gather_dim(t.detach(), t.ndim - 1, group)
             for t in (y, parts[0].grad, parts[1].grad)]
    whole = [t.clone().requires_grad_() for t in (x, w)]
    ref = layers.rms_norm(*whole, 1e-5)
    (ref * dy).sum().backward()
    return {"split": [t.numpy() for t in split],
            "whole": [t.detach().numpy() for t in (ref, whole[0].grad, whole[1].grad)]}


# the serve engine jobs: 4 slots, 5 requests (a refill on each rank)
SERVE = dict(n_slots=4, cache_len=32, block_size=4)
SERVE_PROMPTS = (5, 9, 7, 12, 6)
SERVE_NEW = 6
SERVE_SKEW = 0.05


def serve_prompts(vocab: int) -> list[np.ndarray]:
    return [np.random.RandomState(70 + i).randint(0, vocab, n).astype(np.int32)
            for i, n in enumerate(SERVE_PROMPTS)]


def serve_extras(cfg) -> list[dict | None]:
    """Each serve prompt's non-token inputs (``launch/train.py:draw_extras``:
    the vlm family's ``patches``, none for the families served here)."""
    return [draw_extras(cfg, np.random.RandomState(170 + i))
            for i in range(len(SERVE_PROMPTS))]


def serve_engine(arch: str, overrides: dict, weights: dict, mesh=None,
                 plan: ParallelPlan | None = None, stagger: float = 0.0) -> dict:
    """The port's ServeEngine on ``weights`` (one device, or this rank's
    share of dp slots under ``mesh``/``plan``) over :func:`serve_prompts`,
    request i arriving at ``i * stagger`` seconds: {"tokens": {rid: ids},
    "cache_bytes": the bytes of this rank's cache, "paged"}; a vlm request
    carries its :func:`serve_extras`.  A paged pool has 2 (1 + 2
    max_blocks) blocks, which split over 2 ranks.  With
    staggered arrivals under a mesh, rank r starts its engine clock
    ``r * SERVE_SKEW`` seconds after rank 0, so that the ranks' clocks
    disagree on which requests have arrived."""
    from repro_torch.runtime.serve_engine import Request, ServeEngine

    cfg = config(arch, overrides)
    model = Model(cfg, torch.float32, device="cpu")
    model.load_state_dict(from_jax_params(weights, model))
    max_blocks = (SERVE["cache_len"] + model.patch_offset) // SERVE["block_size"] + 1
    eng = ServeEngine(model, **SERVE, n_blocks=2 * (1 + 2 * max_blocks), mesh=mesh, plan=plan)
    if mesh is not None and stagger:
        time.sleep(dist.get_rank() * SERVE_SKEW)
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW, arrival=i * stagger,
                           extras=x)
                   for i, (p, x) in enumerate(zip(serve_prompts(cfg.vocab_size),
                                                  serve_extras(cfg)))])
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    walk(eng.cache)
    return {"tokens": {k: v.tolist() for k, v in out.items()}, "paged": eng.paged,
            "cache_bytes": sum(t.numel() * t.element_size() for t in leaves)}


def _rank(rank: int, world: int, init_file: str, jobs: list, weights: dict, out: str):
    torch.set_num_threads(1)
    # a rank that fails mid-collective leaves the others waiting: time out
    init_distributed(torch.device("cpu"), f"file://{init_file}", rank, world,
                     timeout=datetime.timedelta(seconds=120))
    results = {}
    for job in jobs:
        try:
            plan = ParallelPlan(**job["plan"])
            cfg = config(job["arch"], job["overrides"])
            mesh = mesh_for_plan(plan, torch.device("cpu"))
            if job.get("serve"):
                results.setdefault(job["name"], {})[rank] = serve_engine(
                    job["arch"], job["overrides"], weights[job["weights"]], mesh, plan,
                    job.get("stagger", 0.0))
                continue
            model = build_model(cfg, plan, mesh)
            coord = {a: model.mesh.coord[a] for a in ("node", "pipe", "data", "expert", "model")}
            model.load_state_dict(from_jax_params(
                shard_params(weights[job["weights"]], cfg, plan, coord), model))
            opt = AdamWConfig(lr=LR)
            state = init_train_state(model, opt, plan)
            if "ckpt_restore" in job:       # a save of any plan, this plan's blocks
                state = restore_checkpoint(job["ckpt_restore"], latest_step(job["ckpt_restore"]),
                                           state, state_shardings(model, plan))
            skip = job.get("skip", 0)
            comm: list = []
            walks: list = []
            moe: list = []
            phases: list = []
            flops: list | None = [] if job.get("flops") else None
            res = {"trajectory": trajectory(build_train_step(model, opt, plan, mesh), state,
                                            batches(cfg.vocab_size, skip + job.get("steps", STEPS),
                                                    cfg)[skip:],
                                            comm, walks, moe, phases, flops),
                   "comm_bytes": comm, "walks": walks, "moe": moe, "coord": coord,
                   "gather_phases": phases, "flops": flops,
                   "blocks": {k: p.detach().numpy().copy()
                              for k, p in model.state_dict().items()},
                   "moments": {k: tuple(m.shape) for k, m in state["opt"]["mu"].items()}}
            if "ckpt_save" in job:      # and the bytes this rank receives
                received: list = []
                recv = dist.recv

                def counted(t, *a, **kw):
                    received.append(t.numel() * t.element_size())
                    return recv(t, *a, **kw)
                dist.recv = counted
                try:
                    save_checkpoint(job["ckpt_save"], state["step"], state,
                                    state_shardings(model, plan))
                finally:
                    dist.recv = recv
                res["ckpt_received"] = sum(received)
            if "check" in job:
                res["check"] = globals()[job["check"]](model, plan)
        except Exception as e:  # noqa: BLE001 - handed back to the test
            res = {"error": f"{type(e).__name__}: {e}"}
        results.setdefault(job["name"], {})[rank] = res
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


def run_ranks(world: int, jobs: list, weights: dict, tmp: str) -> dict:
    """Spawn ``world`` gloo ranks that run ``jobs`` in order; returns
    {job name: {rank: result}}."""
    init_file = os.path.join(tmp, "process_group")
    mp.spawn(_rank, args=(world, init_file, jobs, weights, tmp), nprocs=world)
    merged: dict = {}
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            for name, by_rank in pickle.load(f).items():
                merged.setdefault(name, {}).update(by_rank)
    return merged


# the recurrent families as the multi-rank tests reduce them: zamba2 in two
# super units of hybrid_attn_every = 2 mamba layers, rwkv6 in 4 blocks
RECURRENT = {"zamba2-2.7b": dict(n_layers=4), "rwkv6-1.6b": dict(n_layers=4)}

# the moe family as the multi-rank tests reduce it (.reduced(ep=2): 4
# experts): llama4 at 4 layers (two MoE units, so that pp = 2 splits them)
MOE = {"llama4-maverick-400b-a17b": dict(ep=2, n_layers=4), "arctic-480b": dict(ep=2)}
# name -> the parallel fields of the moe family's plans on 4 ranks
MOE_PLANS = {"ep4": dict(ep=4), "ep2 dp2": dict(ep=2, dp=2),
             "ep2 dp2 z3": dict(ep=2, dp=2, zero=3), "ep2 tp2": dict(ep=2, tp=2),
             "ep2 pp2": dict(ep=2, pp=2), "dp4": dict(dp=4)}
# the hierarchical node axis with ep (the 5-D mesh), arctic only
MOE_NODE_PLANS = {"node2 ep2": dict(node=2, ep=2), "node2 ep2 z3": dict(node=2, ep=2, zero=3)}

# the CommPlan's plans on 4 ranks (reduced yi, fp32): name -> plan fields
COMM_PLANS = {
    "dp4 z3 gather": dict(dp=4, zero=3, qcomm="gather"),
    "dp4 z3 both": dict(dp=4, zero=3, qcomm="both"),
    "dp4 z3 overlap": dict(dp=4, zero=3, overlap=True),
    "dp2 tp2 z3 gather": dict(dp=2, tp=2, zero=3, qcomm="gather"),
    "node2 dp2 z1": dict(node=2, dp=2, zero=1),
    "node2 dp2 z3": dict(node=2, dp=2, zero=3),
    "node2 dp2 z3 gather overlap": dict(node=2, dp=2, zero=3, qcomm="gather", overlap=True),
    "node2 dp2 z3 both overlap": dict(node=2, dp=2, zero=3, qcomm="both", overlap=True),
    "dp2 tp2 z3 overrides": dict(dp=2, tp=2, zero=3, rule_overrides=(("vocab", None),)),
}

# the reduced yi-6b of the reference's plan tests (tests/test_parallel_plan.py)
YI = dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=256,
          head_dim=32)
