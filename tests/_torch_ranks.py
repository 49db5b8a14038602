"""Helpers of the port's multi-rank tests: gloo ranks spawned on the CPU
run train plans of the port's sharded executor and hand back their
trajectories; the single-device trajectories they are held to.  Imports
nothing of the JAX package, so the spawned ranks never load it."""
from __future__ import annotations

import datetime
import os
import pickle

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.data import SyntheticCorpus, make_batch_iterator
from repro_torch.interop import from_jax_params, shard_params
from repro_torch.launch.mesh import init_distributed, mesh_for_plan
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import collectives, pipeline
from repro_torch.runtime.train_loop import (ParallelPlan, build_model, build_train_step,
                                            init_train_state)

STEPS, SEQ, BATCH = 3, 32, 8
LR = 1e-3


def batches(vocab: int, n: int = STEPS) -> list[dict]:
    it = make_batch_iterator(SyntheticCorpus(vocab_size=vocab, seed=0), seq_len=SEQ,
                             global_batch=BATCH, prefetch=0)
    return [next(it) for _ in range(n)]


def config(arch: str, overrides: dict):
    return get_config(arch).reduced(**overrides)


def trajectory(step, state, bs, comm: list | None = None,
               walks: list | None = None) -> list[tuple]:
    """(loss, grad_norm, grads_finite, loss_scale) of each step; ``comm``
    takes each step's collective bytes (``runtime/collectives.py``),
    ``walks`` its pipeline sweep's times (``runtime/pipeline.py``)."""
    out = []
    for b in bs:
        collectives.reset_comm_bytes()
        state, m = step(state, b)
        if comm is not None:
            comm.append(collectives.comm_bytes())
        if walks is not None:
            walks.append(pipeline.walk_reading())
        out.append((float(m["loss"]), float(m["grad_norm"]), bool(m["grads_finite"]),
                    float(m["loss_scale"])))
    return out


def single_device(arch: str, overrides: dict, weights: dict, plan: dict,
                  n: int = STEPS) -> tuple[list[tuple], dict]:
    """The port's single-device step from ``weights`` (a flat numpy tree):
    (its trajectory, its weights after the steps)."""
    cfg = config(arch, overrides)
    model = Model(cfg, torch.float32, device="cpu")
    model.load_state_dict(from_jax_params(weights, model))
    opt = AdamWConfig(lr=LR)
    p = ParallelPlan(**plan)
    traj = trajectory(build_train_step(model, opt, p), init_train_state(model, opt, p),
                      batches(cfg.vocab_size, n))
    return traj, {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def prefill_refused(model: Model) -> str:
    """What prefill of a sharded model raises."""
    try:
        model.prefill({"tokens": torch.zeros((1, 4), dtype=torch.int32)}, 8)
    except NotImplementedError as e:
        return str(e)
    return "no error"


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
            model = build_model(cfg, plan, mesh)
            coord = {a: model.mesh.coord[a] for a in ("pipe", "data", "model")}
            model.load_state_dict(from_jax_params(
                shard_params(weights[job["weights"]], cfg, plan, coord), model))
            opt = AdamWConfig(lr=LR)
            state = init_train_state(model, opt, plan)
            comm: list = []
            walks: list = []
            res = {"trajectory": trajectory(build_train_step(model, opt, plan, mesh), state,
                                            batches(cfg.vocab_size, job.get("steps", STEPS)),
                                            comm, walks),
                   "comm_bytes": comm, "walks": walks, "coord": coord,
                   "blocks": {k: p.detach().numpy().copy()
                              for k, p in model.state_dict().items()},
                   "moments": {k: tuple(m.shape) for k, m in state["opt"]["mu"].items()}}
            if "check" in job:
                res["check"] = globals()[job["check"]](model)
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


# the reduced yi-6b of the reference's plan tests (tests/test_parallel_plan.py)
YI = dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=256,
          head_dim=32)
