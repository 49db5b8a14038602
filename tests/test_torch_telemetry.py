"""The port's measurement and search layer against the JAX package's:
``core/costmodel.py`` (``predict``, ``predict_step``, the Table V recipes'
weak and strong scaling, ``calibrate_bandwidths``, the moe term of
``train_step_flops``) on ``FRONTIER`` within 1e-9 relative;
``core/commplan.py``'s gather bytes and ``core/expertplan.py``'s
predictors exactly; ``core/telemetry.py``'s records of a reduced yi-6b run
on the CPU through the reference's own ``validate_record``, with the
reference ``Telemetry``'s FLOPs and MFU for the same wall times; the drift
monitor's one warning; ``analysis/trace.py``'s events and idle fraction;
``core/hpo.py``'s search over the paper's space (the reference's Fig. 9
objective) trial for trial, and ``core/sensitivity.py``'s Shapley
importances.  No spawn: the collective byte counters are held to
``costmodel.predict_comm_bytes`` in tests/test_torch_parallel.py's."""
import dataclasses
import json
import math
import warnings

import numpy as np
import pytest
import torch

from repro.analysis import trace as jtrace
from repro.configs import get_config as jax_get_config
from repro.core import commplan as jcomm, costmodel as jcm, expertplan as jexp
from repro.core import hpo as jhpo, sensitivity as jsens, telemetry as jtel
from repro.runtime.train_loop import ParallelPlan as JaxPlan
from repro_torch.analysis import report, trace
from repro_torch.configs import get_config
from repro_torch.core import commplan, costmodel as cm, expertplan, hpo, sensitivity
from repro_torch.core import telemetry as tel
from repro_torch.launch import train as train_launcher
from repro_torch.runtime.train_loop import ParallelPlan

torch.set_num_threads(1)

RTOL = 1e-9


def _close(a, b, path="") -> None:
    """Equal structures, floats within RTOL relative."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0) or a == b, (path, a, b)
    else:
        assert a == b, (path, a, b)


def _pred(p) -> dict:
    return dataclasses.asdict(p)


PARALLEL_CFGS = [
    dict(tp=4, pp=16, mbs=1, gas=640), dict(tp=8, pp=64, mbs=1, gas=1600),
    dict(tp=2, pp=4, mbs=2, gas=110), dict(tp=2, pp=2, mbs=4, gas=8, dp=4, zero=0),
    dict(tp=1, pp=1, mbs=8, gas=4, dp=16, zero=2), dict(tp=2, pp=1, mbs=2, gas=2, dp=8, zero=3),
    dict(tp=2, pp=1, mbs=2, gas=2, dp=4, zero=3, node=2, qcomm="both", overlap=True),
    dict(tp=1, pp=1, mbs=4, gas=2, dp=2, zero=3, qcomm="gather", comm_block=64),
    dict(tp=16, pp=2, mbs=1, gas=16, dp=2, flash_attention=False),
    dict(tp=2, pp=1, mbs=2, gas=4, dp=2, ep=4, n_experts=128, top_k=1, capacity_factor=1.25),
    dict(mbs=20, gas=10, checkpoint_activations=False),
]


@pytest.mark.parametrize("size", sorted(cm.MODELS))
def test_predict_equals_reference(size):
    for kw in PARALLEL_CFGS:
        _close(_pred(cm.predict(cm.MODELS[size], cm.ParallelCfg(**kw), cm.FRONTIER)),
               _pred(jcm.predict(jcm.MODELS[size], jcm.ParallelCfg(**kw), jcm.FRONTIER)))
    assert dataclasses.asdict(cm.MODELS[size]) == dataclasses.asdict(jcm.MODELS[size])


def test_recipes_and_scaling_equal_reference():
    for name in ("RECIPE_175B", "RECIPE_1T", "RECIPE_22B"):
        assert dataclasses.asdict(getattr(cm, name)) == dataclasses.asdict(getattr(jcm, name))
    dps = [1, 2, 4, 8, 16]
    for size, recipe in (("175B", "RECIPE_175B"), ("1T", "RECIPE_1T"), ("22B", "RECIPE_22B")):
        ours, ref = getattr(cm, recipe), getattr(jcm, recipe)
        _close(cm.weak_scaling(cm.MODELS[size], ours, dps),
               jcm.weak_scaling(jcm.MODELS[size], ref, dps))
        _close(cm.strong_scaling(cm.MODELS[size], ours, 8 * ours.gas, dps),
               jcm.strong_scaling(jcm.MODELS[size], ref, 8 * ref.gas, dps))


@pytest.mark.parametrize("arch", ["yi-6b", "gpt-1.4b", "zamba2-2.7b", "rwkv6-1.6b",
                                  "llama4-maverick-400b-a17b", "arctic-480b"])
def test_predict_step_and_flops_equal_reference(arch):
    """The drift anchor of every family the port trains or serves, over
    plans the port's executor runs, and the train FLOPs (the moe term:
    expert leaves at top_k / E)."""
    for reduced in (False, True):
        t, j = get_config(arch), jax_get_config(arch)
        if reduced:
            t, j = t.reduced(), j.reduced()
        for plan in (dict(), dict(dp=4, zero=3, gas=2, remat="selective"),
                     dict(tp=2, pp=2, gas=4, virtual_stages=2, remat="none"),
                     dict(dp=2, pp=4, gas=8, zero=2)):
            _close(_pred(cm.predict_step(t, ParallelPlan(**plan), 32, 2048)),
                   _pred(jcm.predict_step(j, JaxPlan(**plan), 32, 2048)))
        for backward in (True, False):
            a = cm.train_step_flops(t, 8, 2048, backward=backward)
            b = jcm.train_step_flops(j, 8, 2048, backward=backward)
            _close((a.matmul, a.attn, a.scan, a.tokens, a.per_token),
                   (b.matmul, b.attn, b.scan, b.tokens, b.per_token))


def test_calibrate_bandwidths_and_machines():
    samples = [(4e9, 1e9, 0.05), (1e9, 3e9, 0.09), (8e9, 2e8, 0.06), (2e9, 2e9, 0.07)]
    _close(cm.calibrate_bandwidths(samples), jcm.calibrate_bandwidths(samples))
    ours = cm.calibrate_bandwidths(samples, cm.FRONTIER)
    ref = jcm.calibrate_bandwidths(samples, jcm.FRONTIER)
    _close(dataclasses.asdict(ours), dataclasses.asdict(ref))
    assert dataclasses.asdict(cm.FRONTIER) == dataclasses.asdict(jcm.FRONTIER)
    assert [cm.FRONTIER.tp_bandwidth(t) for t in (1, 2, 4, 8, 16)] == \
        [jcm.FRONTIER.tp_bandwidth(t) for t in (1, 2, 4, 8, 16)]
    with pytest.raises(ValueError):
        cm.calibrate_bandwidths(samples[:1])
    # the port's card: the data sheet, and a GEMM rate measured on it
    h = cm.H100
    assert (h.peak_flops, h.hbm_bytes, h.hbm_bw, h.gpus_per_node) == (989e12, 80e9, 3.35e12, 8)
    assert 0.5 < h.matmul_eff < 1.0 and h.tp_bandwidth(8) > h.tp_bandwidth(16)
    assert set(tel.MACHINES) == {"h100", "frontier"} and not hasattr(cm, "TPU_V5E")


SPECS = [
    ((8, 64, 128), ("layers", "data", None)),
    ((64, 256), ("data", "model")),
    ((256,), ("data",)),
    ((96, 64), (None, ("data", "node"))),
    ((4, 128, 96), (None, "data", "node")),
    ((32, 33), ("data", None)),
    ((16, 64), (None, None)),
]


@pytest.mark.parametrize("cp", [dict(), dict(qcomm="gather"), dict(qcomm="both", block=16),
                                dict(node=2), dict(node=2, qcomm="gather", block=32)])
def test_gather_bytes_equal_reference(cp):
    shapes, specs = [s for s, _ in SPECS], [p for _, p in SPECS]
    mesh = {"data": 4, "model": 2, "node": 2, "layers": 1}
    ours = commplan.tree_gather_bytes(shapes, specs, mesh, commplan.CommPlan(**cp),
                                      itemsize=2, multiplier=3.0)
    ref = jcomm.tree_gather_bytes(shapes, specs, mesh, jcomm.CommPlan(**cp),
                                  itemsize=2, multiplier=3.0)
    assert ours == ref and ours["total"] > 0
    assert cm.predict_comm_bytes(shapes, specs, mesh, commplan.CommPlan(**cp)) == \
        jcm.predict_comm_bytes(shapes, specs, mesh, jcomm.CommPlan(**cp))
    for shape, spec in SPECS:
        assert commplan.quant_specs(spec) == jcomm.quant_specs(spec)
        assert commplan.pad_spec(spec, 4) == jcomm.pad_spec(spec, 4)


def test_expert_predictors_equal_reference():
    for args in [(16, 128, 40, 5120), (8, 64, 10, 256), (4, 8, 3, 128)]:
        for kw in (dict(ep=1), dict(ep=4, dp=2), dict(ep=8, node=2, itemsize=2),
                   dict(ep=2, with_backward=True)):
            assert expertplan.dispatch_a2a_bytes(*args, **kw) == \
                jexp.dispatch_a2a_bytes(*args, **kw)
            assert cm.predict_a2a_bytes(*args, **kw) == jcm.predict_a2a_bytes(*args, **kw)
    for k in (1, 2, 4):
        for E in (8, 64, 128):
            for cf in (0.5, 1.0, 1.25, 2.0):
                for g in (1, 16, 512, 8192):
                    assert expertplan.predicted_drop_fraction(k, E, cf, g) == \
                        jexp.predicted_drop_fraction(k, E, cf, g)
    plan = expertplan.ExpertPlan(ep=4)
    assert plan.enabled and plan.experts_per_shard(128) == 32
    with pytest.raises(expertplan.ExpertDivisibilityError):
        plan.validate_model(6)


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------

def test_launcher_records_pass_the_reference_validator(tmp_path):
    """A reduced yi-6b run of the launcher on the CPU with --log-jsonl and
    --trace: every record passes the reference's validate_record; its
    FLOPs and MFU equal the reference Telemetry's for the same wall times;
    the report renders it; the trace checks against the bubble."""
    path, tpath = tmp_path / "run.jsonl", tmp_path / "trace.json"
    recs = train_launcher.main(["--device", "cpu", "--arch", "yi-6b", "--reduced",
                                "--steps", "3", "--global-batch", "4", "--seq-len", "16",
                                "--gas", "2", "--remat", "selective", "--log-every", "1",
                                "--log-jsonl", str(path), "--trace", str(tpath),
                                "--machine", "frontier", "--drift-threshold", "1e12"])
    records = tel.validate_jsonl(str(path))
    assert [r["kind"] for r in records] == ["compile", "step", "step", "step"]
    for r in records:
        jtel.validate_record(r)
    head = records[0]
    assert head["backend"] == "cpu" and head["kernels_interpret_mode"] and head["devices"] == 1
    assert head["plan"]["remat"] == "selective" and head["state_bytes"]["param_bytes"] > 0
    ref = jtel.Telemetry(jax_get_config("yi-6b").reduced(),
                         JaxPlan(gas=2, precision="fp32", remat="selective"), 4, 16,
                         machine="frontier", drift_threshold=float("inf"))
    for r, ret in zip(records[1:], recs):
        j = ref.step(r["step"], r["wall_s"], {"loss": r["loss"], "loss_scale": 1.0})
        assert r["flops_per_step"] == j["flops_per_step"] == head["flops_per_step"]
        assert math.isclose(r["mfu"], j["mfu"], rel_tol=RTOL)
        _close(r["predicted"], j["predicted"])
        assert r["loss"] == ret["loss"] and "mfu" not in ret
    table = report.telemetry_table(str(path))
    assert table.count("\n| ") == 4 and "backend=cpu" in table
    summary = trace.check_trace_file(str(tpath))
    assert abs(summary["idle_fraction"]) < 1e-12    # pp = 1: no bubble


def test_telemetry_refuses_an_invalid_record():
    t = tel.Telemetry(get_config("yi-6b").reduced(), ParallelPlan(), 4, 16,
                      drift_threshold=float("inf"))
    with pytest.raises(ValueError, match="missing keys"):
        t.step(1, 0.5, {"loss_scale": 1.0})          # no loss
    with pytest.raises(ValueError, match="mfu"):
        t.step(1, 1e-30, {"loss": 1.0, "loss_scale": 1.0})
    rec = t.record_compile(device=torch.device("cpu"))
    jtel.validate_record(rec)
    with pytest.raises(ValueError, match="unknown record kind"):
        tel.validate_record({"schema": tel.SCHEMA, "kind": "dryrun"})


def test_drift_monitor_warns_once_on_rolling_crossing():
    mon = tel.DriftMonitor(threshold=10.0, window=4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        d = mon.update(5.0, 1.0)          # ratio 5: inside the band
    assert d["step_time_ratio"] == pytest.approx(5.0) and not d["warn"]
    with pytest.warns(UserWarning, match="costmodel drift"):
        d = mon.update(100.0, 1.0)        # rolling (5+100)/2 crosses 10
    assert d["warn"] and d["rolling_ratio"] == pytest.approx(52.5)
    with warnings.catch_warnings():       # one-shot: no second warning
        warnings.simplefilter("error")
        d = mon.update(100.0, 1.0)
    assert d["warn"] and d["window"] == 3
    assert math.isinf(tel.DriftMonitor().update(1.0, 0.0)["step_time_ratio"])
    with pytest.warns(UserWarning, match="costmodel drift"):
        tel.DriftMonitor(threshold=10.0, window=2).update(0.001, 1.0)   # 1000x faster


def test_sanitize_and_fields_equal_reference():
    rec = {"a": np.float32(1.5), "b": np.int64(3), "c": np.array([1.0, 2.0]),
           "t": torch.tensor(2.5), "f": torch.tensor(True),
           "traceback": "Traceback ...", "nested": {"traceback": "x", "ok": (1, 2)}}
    out = tel.sanitize_record(rec)
    assert out == {"a": 1.5, "b": 3, "c": [1.0, 2.0], "t": 2.5, "f": True,
                   "nested": {"ok": [1, 2]}}
    json.dumps(out)
    t, j = get_config("gpt-1.4b"), jax_get_config("gpt-1.4b")
    _close(tel.step_fields(t, 8, 2048, 1.9, 1, machine="frontier"),
           jtel.step_fields(j, 8, 2048, 1.9, 1, machine="frontier"))
    assert tel.mfu(1e15, 2.0, 4, 1e14) == jtel.mfu(1e15, 2.0, 4, 1e14)
    plan = ParallelPlan(dp=2, pp=2, gas=4, zero=3, remat="selective")
    assert tel.plan_dict(plan) == {k: v for k, v in jtel.plan_dict(
        JaxPlan(dp=2, pp=2, gas=4, zero=3, remat="selective")).items() if k in tel.plan_dict(plan)}


@pytest.mark.parametrize("p,m,v", [(2, 4, 1), (4, 8, 2)])
def test_trace_equals_reference(p, m, v, tmp_path):
    walls = [0.5, 0.25, 0.75]
    ours = trace.build_trace(p, m, v, walls, meta={"arch": "x"})
    ref = jtrace.build_trace(p, m, v, walls, meta={"arch": "x"})
    assert ours == ref
    assert trace.stage_intervals(p, m, v) == jtrace.stage_intervals(p, m, v)
    assert trace.trace_idle_fraction(ours) == jtrace.trace_idle_fraction(ref)
    path = str(tmp_path / "t.json")
    trace.write_trace(ours, path)
    assert trace.check_trace_file(path) == jtrace.check_trace_file(path)
    # the measured fields: the ranks' time in stage applications over the
    # time of their sweeps, beside the schedule's idle share
    walks = [{"applications": m * v, "busy_s": 1.0, "wall_s": 2.0},
             {"applications": m * v, "busy_s": 1.5, "wall_s": 2.5}]
    fields = tel.pipeline_fields(p, m, v, walks)
    assert fields["applications"] == 2 * m * v
    assert fields["busy_s"] == [1.0, 1.5] and fields["wall_s"] == [2.0, 2.5]
    assert math.isclose(fields["idle_fraction"], 1.0 - 2.5 / 4.5, rel_tol=1e-12)
    assert fields["spmd_idle_fraction"] == ours["metadata"]["idle_fraction_schedule"]


# ---------------------------------------------------------------------------
# The plan search
# ---------------------------------------------------------------------------

def _fig9_objective(costmodel):
    """The reference's benchmarks/fig9_hpo_search.py objective, over either
    package's cost model."""
    def plan_tflops(plan, cfg):
        pc = costmodel.ParallelCfg(tp=plan.tp, pp=plan.pp, mbs=cfg["mbs"], gas=plan.gas,
                                   dp=plan.dp, zero=plan.zero)
        return costmodel.predict(costmodel.GPT_175B, pc, costmodel.FRONTIER).objective
    return plan_tflops


@pytest.fixture(scope="module")
def searches():
    ours = hpo.bayesian_search(hpo.plan_objective(_fig9_objective(cm)), hpo.SPACE_175B_PAPER,
                               n_trials=24, seed=0)
    ref = jhpo.bayesian_search(jhpo.plan_objective(_fig9_objective(jcm)),
                               jhpo.SPACE_175B_PAPER, n_trials=24, seed=0)
    return ours, ref


def test_bayesian_search_equals_reference(searches):
    ours, ref = searches
    assert [t.config for t in ours.trials] == [t.config for t in ref.trials]
    _close([t.objective for t in ours.trials], [t.objective for t in ref.trials])
    assert [t.failed for t in ours.trials] == [t.failed for t in ref.trials]
    assert ours.best.config == ref.best.config
    _close(ours.best_so_far(), ref.best_so_far())
    assert ours.failure_rate() == ref.failure_rate()
    assert [p.name for p in hpo.SPACE_MOE] == [p.name for p in jhpo.SPACE_MOE]


def test_shapley_importance_equals_reference(searches):
    ours, ref = searches
    a = sensitivity.shapley_importance(ours, hpo.SPACE_175B_PAPER, n_permutations=16,
                                       n_explain=12)
    b = jsens.shapley_importance(ref, jhpo.SPACE_175B_PAPER, n_permutations=16, n_explain=12)
    assert a.keys() == b.keys()
    for k in a:
        assert math.isclose(a[k], b[k], rel_tol=1e-7, abs_tol=1e-12), (k, a[k], b[k])


def test_trial_plan_is_the_ports_plan():
    plan = hpo.trial_plan({"pp": 2, "tp": 4, "gas": 5, "zero": 1, "nnodes": 12,
                           "remat": "selective", "kernels": 1})
    assert isinstance(plan, ParallelPlan) and plan.dp == 12 and plan.remat == "selective"
    assert hpo.trial_plan({"pp": 16, "tp": 8, "nnodes": 12}) is None    # 96 cards, 128 a replica
    assert hpo.trial_plan({"pp": 1, "tp": 2, "zero": 3, "nnodes": 12, "ep": 2}).ep == 2
    # a draw that binds the CommPlan builds the plan the executor runs
    for extra, field, value in (({"qcomm": "gather"}, "qcomm", "gather"),
                                ({"overlap": 1}, "overlap", True), ({"node": 2}, "node", 2)):
        plan = hpo.trial_plan({"pp": 1, "tp": 2, "zero": 3, "nnodes": 12, **extra})
        assert getattr(plan, field) == value and plan.n_devices == 96
