"""The pipeline's parts in one process, against the JAX package's: the copied
bubble model and tick maths over p in 1-4, m in 1-8, v in 1-3; the
schedule planner (its tick count is ``spmd_schedule``'s, each (microbatch,
stage) once on the rank that hosts the stage, one application a rank a
tick, a microbatch's stages at consecutive ticks); the StageProgram split
chained over its stages against ``run_program`` (dense, hybrid, rwkv; the
same arithmetic, so bitwise) and its errors, the hybrid's against the
reference's ``split_stages``; the one-process sweep (every stage local,
the hand-off a tensor) against the gas loop's loss and gradients; the
round-robin layer blocks of virtual stages; the plan's pipe rules and
specs against the reference's."""
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import bubble as jax_bubble
from repro.core import pipeline as jax_pipe
from repro.core import sharding as jax_sharding
from repro.core import stage_program as jax_sp
from repro.models.model import Model as JaxModel
from repro.runtime.train_loop import ParallelPlan as JaxPlan
from repro_torch.configs import get_config
from repro_torch.core import bubble, pipeline as pipe, precision, sharding
from repro_torch.core import stage_program as sp
from repro_torch.interop import shard_params
from repro_torch.models.common import flatten_specs
from repro_torch.models.model import Model, param_specs
from repro_torch.runtime import pipeline as runner
from repro_torch.runtime.train_loop import ParallelPlan, plan_state_shardings

torch.set_num_threads(1)

GRID = list(itertools.product((1, 2, 3, 4), range(1, 9), (1, 2, 3)))
SMALL = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
             head_dim=16, ssm_head_dim=16)
FAMILIES = {"dense": "yi-6b", "hybrid": "zamba2-2.7b", "rwkv": "rwkv6-1.6b"}


def test_bubble_model_equals_reference():
    for p, m, v in GRID:
        for sched in ("gpipe", "1f1b", "1f1b_interleaved"):
            for approx in (False, True):
                assert (bubble.bubble_fraction(p, m, v, schedule=sched, approximate=approx)
                        == jax_bubble.bubble_fraction(p, m, v, schedule=sched,
                                                      approximate=approx))
            assert (bubble.pipeline_efficiency(p, m, v, sched)
                    == jax_bubble.pipeline_efficiency(p, m, v, sched))
        assert bubble.wave_bubble_fraction(p, m, v) == jax_bubble.wave_bubble_fraction(p, m, v)
    for p, v, eff in itertools.product((1, 2, 4), (1, 2), (0.5, 0.8, 0.95)):
        assert (bubble.min_microbatches_for_efficiency(p, eff, v)
                == jax_bubble.min_microbatches_for_efficiency(p, eff, v))
    with pytest.raises(ValueError):
        bubble.bubble_fraction(2, 2, schedule="zb")


def test_tick_maths_equal_reference():
    for p, m, v in GRID:
        assert pipe._waves(p, m) == jax_pipe._waves(p, m)
        assert pipe.spmd_schedule(p, m, v) == jax_pipe.spmd_schedule(p, m, v)
        assert pipe.spmd_idle_fraction(p, m, v) == jax_pipe.spmd_idle_fraction(p, m, v)


@pytest.mark.parametrize("v", [1, 2, 3])
def test_planner_walks_the_reference_schedule(v):
    for p, m in itertools.product((1, 2, 3, 4), range(1, 9)):
        sched = pipe.schedule(p, m, v)
        S = p * v
        assert sched.ticks == jax_pipe.spmd_schedule(p, m, v)[0]
        seen = {}
        for d, apps in enumerate(sched.ranks):
            ticks = [t for t, _, _ in apps]
            assert ticks == sorted(set(ticks))           # one application a tick
            for t, j, s in apps:
                assert s % p == d and 0 <= t < sched.ticks
                assert (j, s) not in seen
                seen[j, s] = t
        assert sorted(seen) == [(j, s) for j in range(m) for s in range(S)]
        assert len(seen) == jax_pipe.spmd_schedule(p, m, v)[2]         # m * S useful
        # the hand-off: stage s + 1 of a microbatch at the tick after stage s
        assert all(seen[j, s + 1] == seen[j, s] + 1 for j in range(m) for s in range(S - 1))
        if v == 1:
            assert all(t == j + s for (j, s), t in seen.items())
    with pytest.raises(ValueError):
        pipe.schedule(2, 0)


def _model(family: str, **kw) -> Model:
    cfg = get_config(FAMILIES[family]).reduced(**{**SMALL, **kw})
    return Model(cfg, torch.float32, device="cpu").init(torch.Generator().manual_seed(0))


def _tokens(cfg, B: int = 4, T: int = 16) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (B, T)))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_split_stages_chained_is_run_program(family):
    model = _model(family)
    x = model._embed(model.params(), {"tokens": _tokens(model.cfg)})
    with torch.no_grad():
        prog = model.stage_program()
        whole, carry = sp.run_program(prog, x, prog.init_carry())
        assert carry.keys() == {"aux"} and float(carry["aux"]) == 0.0
        n = prog.n_units
        for S in (s for s in (1, 2, 4) if n % s == 0):
            params, stage_fn = sp.split_stages(model.stage_program(), S)
            assert len(params) == S
            y, c = x, prog.init_carry()
            for s in range(S):
                y, c = stage_fn(params[s], y, c)
            assert torch.equal(y, whole) and c.keys() == carry.keys(), (family, S)
        with pytest.raises(ValueError, match=f"not divisible by pp\\*virtual_stages={n + 1}"):
            sp.split_stages(model.stage_program(), n + 1)


def _unit(name, weight, tied=False):
    return sp.Segment(name, [{"w": weight}], 1,
                      lambda lp, x, c: (x * lp["w"], {"aux": c["aux"] + lp["w"]}), tied=tied)


def test_split_stages_multi_segment_and_its_errors():
    """The segment-list split: tied segments closed over by every stage, the
    other segments one group a stage; the reference's errors."""
    shared = torch.tensor(3.0)
    ws = [torch.tensor(float(i + 2)) for i in range(4)]
    prog = sp.StageProgram(tuple(seg for w in ws for seg in (_unit("m", w),
                                                             _unit("s", shared, tied=True))))
    params, stage_fn = sp.split_stages(prog, 2)
    assert [len(p) for p in params] == [2, 2]       # [m, s, m, s] a stage: s closed over
    y, c = torch.tensor(1.0), prog.init_carry()
    for s in range(2):
        y, c = stage_fn(params[s], y, c)
    whole, carry = sp.run_program(prog, torch.tensor(1.0), prog.init_carry())
    assert y == whole == 2 * 3 * 4 * 5 * 3 ** 4
    assert c["aux"] == carry["aux"] == 2 + 3 + 4 + 5 + 3 * 4
    with pytest.raises(ValueError, match="program has 8 segments"):
        sp.split_stages(prog, 3)
    odd = sp.StageProgram((_unit("m", ws[0]), _unit("s", shared), _unit("s", shared),
                           _unit("m", ws[1])))
    with pytest.raises(ValueError, match="structurally identical"):
        sp.split_stages(odd, 2)
    untied = sp.StageProgram((_unit("s", ws[0], tied=True), _unit("s", ws[1], tied=True)))
    with pytest.raises(ValueError, match="different param tensors"):
        sp.split_stages(untied, 2)
    with pytest.raises(ValueError, match="2 units, n=1"):
        sp.Segment("m", [{}, {}], 1, None)


@pytest.mark.parametrize("pp,v", [(2, 1), (2, 2), (4, 1)])
def test_plan_refuses_what_does_not_split_as_the_reference(pp, v):
    """zamba2 reduced to 4 layers of 2 super units: pp x v = 2 splits, 4
    does not, with the reference's split_stages message."""
    cfg = get_config("zamba2-2.7b").reduced(n_layers=4)
    plan = ParallelPlan(pp=pp, virtual_stages=v)
    jcfg = jax_get_config("zamba2-2.7b").reduced(n_layers=4)
    jm = JaxModel(jcfg, jnp.float32)
    prog = jm.stage_program(jm.init(jax.random.PRNGKey(0)))
    if pp * v == 2:
        plan_state_shardings(cfg, plan)
        return
    with pytest.raises(ValueError) as ref:
        jax_sp.split_stages(prog, pp * v)
    with pytest.raises(ValueError) as ours:
        plan_state_shardings(cfg, plan)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("S,m", [(2, 2), (4, 3)])
def test_local_sweep_is_the_gas_loop(S, m):
    """Every stage in one process (what the one-card check runs): the sum of
    the microbatches' CE over the global token count and the gradients in
    .grad, against the gas loop's mean and summed gradients over m."""
    model = _model("dense").requires_grad_(True)
    toks = _tokens(model.cfg, B=2 * m)
    micro = [{"tokens": toks[2 * i:2 * i + 2]} for i in range(m)]
    ls = precision.init_loss_scale(False)
    ce = runner.sweep(model, pipe.schedule(S, m), micro,
                      runner.loss_count({"tokens": toks}, model.device), ls)
    ours = {k: p.grad.clone() for k, p in model.named_parameters()}
    # the sweep's own measurement: every application, inside the sweep's time
    walked = runner.walk_reading()
    assert walked["applications"] == S * m
    assert 0.0 < walked["busy_s"] <= walked["wall_s"]
    model.zero_grad(set_to_none=True)
    ref = 0.0
    for mb in micro:
        loss, _ = model.loss(mb)
        (loss / m).backward()
        ref += float(loss.detach()) / m
    np.testing.assert_allclose(float(ce), ref, rtol=1e-6)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(ours[k].numpy(), p.grad.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("p,v", [(2, 1), (2, 2), (4, 2), (3, 3)])
def test_round_robin_layers_tile_the_stack(p, v):
    """Pipe rank d holds the layers of logical stages d, d + p, ... (n = L / S
    each), in slot order, and the ranks' blocks tile the stack once;
    ``shard_params`` hands them out so."""
    n = 2
    L = p * v * n
    held = []
    for d in range(p):
        idx = sharding.shard_slices((L, 8), ("pipe", None), {"pipe": p}, {"pipe": d}, v)
        rows = list(range(L))[idx[0]] if isinstance(idx[0], slice) else idx[0]
        assert rows == [s * n + i for k in range(v) for s in (k * p + d,) for i in range(n)]
        assert len(rows) == L // p == sharding.shard_shape((L, 8), ("pipe", None),
                                                          {"pipe": p})[0]
        held += rows
    assert sorted(held) == list(range(L))
    cfg = get_config("yi-6b").reduced(n_layers=L)
    shape = dict(flatten_specs(param_specs(cfg)))["layers.mlp.w1"].shape
    leaf = np.broadcast_to(np.arange(L, dtype=np.float32).reshape(L, 1, 1), shape).copy()
    for d in range(p):
        got = shard_params({"layers.mlp.w1": leaf}, cfg, ParallelPlan(pp=p, virtual_stages=v),
                           {"pipe": d, "data": 0, "model": 0})["layers.mlp.w1"]
        assert got.shape == (L // p, *shape[1:])
        assert [int(r) for r in got[:, 0, 0]] == [(k * p + d) * n + i
                                                  for k in range(v) for i in range(n)]


@pytest.mark.parametrize("pp,v,dp,tp", [(2, 1, 1, 1), (2, 2, 2, 1), (4, 1, 1, 1),
                                        (2, 1, 1, 2)])
def test_pipe_rules_and_specs_equal_reference(pp, v, dp, tp):
    """At pp > 1 "layers" goes on "pipe" (the reference's sharding_rules);
    every leaf's base spec equals the reference's; under ZeRO a stacked
    leaf takes the data axis past the layer dim; no spec names an axis
    twice."""
    kw = dict(pp=pp, virtual_stages=v, dp=dp, tp=tp)
    ours, ref = ParallelPlan(**kw), JaxPlan(**kw)
    assert dict(ours.sharding_rules().rules) == dict(ref.sharding_rules().rules)
    assert ours.sharding_rules().mesh_axis("layers") == "pipe"
    assert ours.n_stages == ref.n_stages and ours.n_devices == ref.n_devices
    cfg = get_config("yi-6b").reduced(n_layers=4)
    jcfg = jax_get_config("yi-6b").reduced(n_layers=4)
    sizes = ours.mesh_sizes()
    mesh = types.SimpleNamespace(shape=sizes)
    jleaves = jax.tree_util.tree_flatten_with_path(JaxModel(jcfg).param_specs(),
                                                   is_leaf=lambda x: hasattr(x, "axes"))[0]
    jspecs = {".".join(str(getattr(k, "key", k)) for k in path): leaf
              for path, leaf in jleaves}
    for z in (0, 3):
        _, psh, opt_sh, _ = plan_state_shardings(cfg, ParallelPlan(zero=z, **kw))
        for path, spec in flatten_specs(param_specs(cfg)):
            base = sharding.partition_spec(spec.shape, spec.axes, sizes, ours.sharding_rules())
            rbase = jax_sharding.partition_spec(jspecs[path].shape, jspecs[path].axes, mesh,
                                                ref.sharding_rules())
            assert base == tuple(rbase), path
            for s in (psh[path], opt_sh[path]):
                named = [a for e in s for a in sharding._axes(e)]
                assert len(named) == len(set(named)), (path, s)
            if path.startswith("layers."):
                assert psh[path][0] == opt_sh[path][0] == "pipe"
