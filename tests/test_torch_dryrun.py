"""The port's offline tooling against the JAX package's: ``configs/shapes.py``
(``SHAPES``, ``applicable``), ``core/compute.py:activation_bytes_estimate``
and ``core/bubble.py:PipelineMemory`` exactly on grids,
``analysis/roofline.py``'s ``param_counts`` and ``model_flops`` for every
config, ``models/moe.py``'s router on the same numpy gates (the drop
fraction ``simulated_drop_fraction`` reports), the dry run's analytic
fields (``launch/dryrun.py``) against the reference's functions, its traced
records on fake process groups (8 ranks of a reduced yi-6b; 256 of
qwen3-32b at full width and 2 layers, through the CLI), its statuses, and
``analysis/report.py``'s roofline and hillclimb tables against the
reference's on one set of records.  The traced FLOPs and collective bytes
are held to a real gloo run's in tests/test_torch_parallel.py's spawn."""
import ast
import dataclasses
import itertools
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.analysis import report as jreport, roofline as jrl
from repro.configs import get_config as jax_get_config
from repro.configs import shapes as jshapes
from repro.core import bubble as jbubble, compute as jcompute, costmodel as jcm
from repro.core import expertplan as jepl, telemetry as jtel
from repro.models import moe as jmoe
from repro.runtime.train_loop import ParallelPlan as JaxPlan
from repro_torch.analysis import report, roofline
from repro_torch.configs import ASSIGNED, PAPER, get_config
from repro_torch.configs import shapes
from repro_torch.configs.shapes import InputShape
from repro_torch.core import bubble, compute
from repro_torch.launch import dryrun, hillclimb
from repro_torch.models import moe
from repro_torch.runtime.train_loop import ParallelPlan, train_state_bytes

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ARCHS = ASSIGNED + PAPER
# a reduced train shape: 8 rows of 32 tokens
SMALL = InputShape("small", "train", 32, 8)
# the reference record's keys the port keeps (XLA's own analyses aside:
# lower_s, compile_s, analyze_s, dot_flops_per_device, xla_cost_analysis,
# collective_payload_bytes, collective_counts, unknown_trip_loops; the port
# has trace_s in their place)
RECORD_KEYS = {"schema", "arch", "shape", "chips", "mesh", "kind", "plan", "zero", "gas",
               "remat", "kernels", "node", "qcomm", "overlap", "ep", "tokens",
               "activation_bytes_estimate", "state_bytes", "flops_per_step", "predicted",
               "status", "flops_per_device", "bytes_per_device", "collective_bytes",
               "comm_bytes", "collective_bytes_total", "memory_analysis", "roofline",
               "model_flops", "useful_flops_ratio", "trace_s"}


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_applicable_equal_the_reference(arch):
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    for name in shapes.SHAPES:
        assert shapes.applicable(get_config(arch), shapes.SHAPES[name]) == \
            jshapes.applicable(jax_get_config(arch), jshapes.SHAPES[name])


GRID = list(itertools.product((1, 4, 16), (1, 8), (1, 2), (1, 4)))


@pytest.mark.parametrize("arch", ARCHS)
def test_activation_bytes_estimate_equals_the_reference(arch):
    for remat in ("full", "selective", "none"):
        for dp, tp, pp, gas in GRID:
            kw = dict(dp=dp, tp=tp, pp=pp, gas=gas)
            assert compute.activation_bytes_estimate(
                get_config(arch), 256, 4096, compute.ComputePolicy(remat=remat), **kw) == \
                jcompute.activation_bytes_estimate(
                    jax_get_config(arch), 256, 4096, jcompute.ComputePolicy(remat=remat), **kw)


def test_pipeline_memory_equals_the_reference():
    for schedule, p, m, v in itertools.product(("gpipe", "1f1b", "1f1b_interleaved"),
                                               (1, 2, 4, 8), (1, 3, 8, 16), (1, 2, 4)):
        mine = bubble.PipelineMemory(schedule, p, m, v)
        assert mine.inflight_microbatches == \
            jbubble.PipelineMemory(schedule, p, m, v).inflight_microbatches
        assert dataclasses.astuple(mine) == (schedule, p, m, v)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert roofline.param_counts(cfg) == jrl.param_counts(jcfg)
    for kind, tokens in (("train", 256 * 4096), ("prefill", 32 * 32768), ("decode", 128)):
        assert roofline.model_flops(cfg, tokens=tokens, kind=kind) == \
            jrl.model_flops(jcfg, tokens=tokens, kind=kind)
    assert roofline.useful_flops_ratio(cfg, tokens=4096, kind="train", flops_per_device=1e12,
                                       chips=16) == \
        jrl.useful_flops_ratio(jcfg, tokens=4096, kind="train", flops_per_device=1e12, chips=16)
    assert roofline.FRONTIER_MI250X == roofline.Hardware(**dataclasses.asdict(
        jrl.FRONTIER_MI250X))
    t = roofline.roofline_terms(1e15, 2e12, 3e9, 16)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1e15 / 989e12, 2e12 / 3.35e12,
                                                         3e9 / 450e9)


@pytest.mark.parametrize("arch", ["arctic-480b", "llama4-maverick-400b-a17b"])
def test_router_keeps_the_reference_slots_on_the_same_gates(arch):
    """``simulated_drop_fraction``'s gates (``default_rng(seed + i)``, a
    softmax) through the port's ``_route`` and the reference's keep the same
    slots, and its drop fraction is theirs."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    batch, seq, seed, samples = 4, 1024, 3, 2
    G, g = moe.group_shape(batch, seq)
    assert (G, g) == jmoe.group_shape(batch, seq)
    C = moe.moe_capacity(g, cfg)
    assert C == jmoe.moe_capacity(g, jcfg)
    fracs = []
    for i in range(samples):
        z = np.random.default_rng(seed + i).standard_normal((G, g, cfg.n_experts),
                                                            dtype=np.float32)
        gates = torch.softmax(torch.from_numpy(z), -1)
        _, _, mine, _ = moe._route(gates, cfg.top_k, C)
        _, _, ref, _ = jmoe._route(jnp.asarray(gates.numpy()), jcfg.top_k, C)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
        fracs.append(1.0 - float(np.asarray(ref).sum()) / (G * g * cfg.top_k))
    assert moe.simulated_drop_fraction(cfg, batch, seq, seed, samples) == float(np.mean(fracs))


def _traced(plan: ParallelPlan, arch: str = "yi-6b", **kw) -> dict:
    rec = dryrun.dryrun_one(arch, SMALL, multi_pod=False, plan=plan,
                            cfg=get_config(arch).reduced(), verbose=False, **kw)
    assert not dist.is_initialized()
    return rec


@pytest.mark.parametrize("zero", [1, 3])
def test_trace_on_eight_fake_ranks(zero):
    """yi-6b reduced at dp 2 x tp 2 x pp 2 traced as rank 0 of a fake group
    of 8: an ``ok`` record with the port's state bytes, a positive FLOP
    count, all-reduces and the ring's sends; no process group after it."""
    plan = ParallelPlan(dp=2, tp=2, pp=2, gas=2, zero=zero)
    rec = _traced(plan)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 8 and rec["mesh"] == "pipe2x2x2"
    assert rec["plan"] == "megatron_tp" + f"+zero{zero}"
    assert rec["state_bytes"] == train_state_bytes(get_config("yi-6b").reduced(), plan)
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collective_bytes"]["all-reduce"] > 0
    assert rec["collective_bytes"]["collective-permute"] == rec["comm_bytes"]["send"] > 0
    assert rec["comm_bytes"]["zero3_gather"] > 0 if zero == 3 else True
    assert rec["memory_analysis"]["peak_bytes"] > sum(rec["state_bytes"][k] for k in (
        "param_bytes", "opt_bytes"))
    assert RECORD_KEYS <= set(rec)
    assert rec["roofline"]["chips"] == 8


def test_analytic_fields_equal_the_reference():
    """The record's analytic fields against the reference's functions on
    the same config, shape and plan (one rank; arctic reduced for the moe
    fields)."""
    for arch, plan_kw in (("yi-6b", dict(dp=1, gas=2, precision="bf16")),
                          ("arctic-480b", dict(gas=2, precision="bf16"))):
        cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
        rec = _traced(ParallelPlan(**plan_kw), arch)
        assert rec["status"] == "ok", rec.get("traceback")
        jplan = JaxPlan(**plan_kw)
        assert rec["tokens"] == SMALL.global_batch * SMALL.seq_len
        assert rec["flops_per_step"] == jcm.train_step_flops(jcfg, 8, 32).total
        assert rec["predicted"] == jtel.predicted_block(jcm.predict_step(jcfg, jplan, 8, 32))
        assert rec["activation_bytes_estimate"] == jcompute.activation_bytes_estimate(
            jcfg, 8, 32, jplan.compute_policy(), dp=1, tp=1, pp=1, gas=2)
        assert rec["model_flops"] == jrl.model_flops(jcfg, tokens=256, kind="train")
        if arch == "arctic-480b":
            _, g = jmoe.group_shape(8, 32)
            assert rec["moe_drop_predicted"] == jepl.predicted_drop_fraction(
                jcfg.top_k, jcfg.n_experts, jcfg.capacity_factor, g)
            assert rec["moe_drop_measured"] == moe.simulated_drop_fraction(cfg, 8, 32)


def test_statuses_skipped_and_error():
    """``applicable``'s skip is a ``skipped`` record; a plan the executor
    refuses (the zamba2 shared block's kv heads that do not split, the
    reference's sequence-parallel override under pp 2) and ``kernels=True``
    are ``error`` records with the refusal's message; the hillclimb writes
    its error records."""
    skip = dryrun.dryrun_one("yi-6b", "long_500k", multi_pod=False, verbose=False)
    assert skip["status"] == "skipped" and "long_500k skipped" in skip["reason"]
    cfg = get_config("zamba2-2.7b").reduced(n_layers=4, n_heads=6, n_kv_heads=3)
    bad = dryrun.dryrun_one("zamba2-2.7b", SMALL, multi_pod=False, cfg=cfg, verbose=False,
                            plan=ParallelPlan(tp=2))
    assert bad["status"] == "error" and "shared.attn.wk" in bad["error"]
    seq = _traced(ParallelPlan(dp=2, tp=2, pp=2, rule_overrides=(("seq", "model"),)))
    assert seq["status"] == "error" and "'seq'" in seq["error"] and "pp = 2" in seq["error"]
    fused = _traced(ParallelPlan(kernels=True))
    assert fused["status"] == "error" and "kernels=True" in fused["error"]
    assert not dist.is_initialized()
    assert set(itertools.chain(*hillclimb.PLAN_MATRIX.values())) <= set(hillclimb.VARIANTS)
    assert set(hillclimb.PLAN_MATRIX) == set(hillclimb.PAIRS)


def test_production_record_through_the_cli(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch qwen3-32b --shape
    train_4k`` (here at 2 of its 64 layers): an ``ok`` record for 256
    ranks on "16x16", the H100 roofline, the port's ``train_state_bytes``."""
    out = tmp_path / "dry.json"
    records = dryrun.main(["--arch", "qwen3-32b", "--shape", "train_4k", "--layers", "2",
                           "--out", str(out)])
    rec = json.loads(out.read_text().splitlines()[0])
    assert records[0]["status"] == rec["status"] == "ok"
    assert (rec["chips"], rec["mesh"], rec["plan"]) == (256, "16x16", "megatron_tp+zero1")
    cfg = dataclasses.replace(get_config("qwen3-32b"), n_layers=2)
    assert rec["state_bytes"] == train_state_bytes(cfg, dryrun.default_plan(False))
    t = rec["roofline"]
    assert t["compute_s"] == rec["flops_per_device"] / roofline.H100.peak_flops
    assert t["collective_s"] == rec["collective_bytes_total"] / roofline.H100.link_bw
    assert RECORD_KEYS <= set(rec)
    assert not dist.is_initialized()


def test_report_tables_render_as_the_reference(tmp_path, monkeypatch):
    ok = _traced(ParallelPlan(gas=2))
    assert ok["status"] == "ok"
    ok = json.loads(json.dumps(dryrun.tel.sanitize_record(ok)))
    skip = {"arch": "yi-6b", "shape": "long_500k", "mesh": "16x16", "status": "skipped",
            "reason": "r"}
    err = {"arch": "arctic-480b", "shape": "train_4k", "mesh": "16x16", "status": "error",
           "error": "NotImplementedError: layers.attn.wq: 56 query / 8 kv heads do not split"}
    (tmp_path / "results").mkdir()
    (tmp_path / "results" / "dryrun_single.json").write_text(
        "".join(json.dumps(r) + "\n" for r in (ok, skip, err)))
    hill = [dict(ok, tag="qwen3:baseline", variant="baseline"),
            {"pair": "arctic", "variant": "seq_shard", "status": "error",
             "error": err["error"]}]
    (tmp_path / "results" / "hillclimb.json").write_text(
        "".join(json.dumps(r) + "\n" for r in hill))
    monkeypatch.chdir(tmp_path)
    assert report.roofline_table() == jreport.roofline_table()
    assert report.hillclimb_table() == jreport.hillclimb_table()
    assert report.roofline_table().count("\n") == 4 and "ERROR" in report.hillclimb_table()


def test_new_modules_import_no_jax_msgpack_or_ml_dtypes():
    src = REPO / "src" / "repro_torch"
    files = [src / p for p in ("configs/shapes.py", "analysis/roofline.py", "launch/dryrun.py",
                               "launch/hillclimb.py", "launch/pp_pod.py",
                               "checkpointing/__init__.py", "checkpointing/checkpoint.py",
                               "checkpointing/msgpack_lite.py")]
    for f in files:
        roots = set()
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                roots.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split(".")[0])
        assert not roots & {"jax", "jaxlib", "repro", "msgpack", "ml_dtypes"}, (f, roots)


# the new layouts of the hillclimb's plans on a fake group of 16 ranks (dp 4
# x tp 4): arctic reduced at 6 heads (the attention whole over tp 4) and 8
# experts, and qwen3 reduced
NEW_LAYOUTS = {"arctic baseline": ("arctic-480b", "baseline"),
               "arctic ep_model": ("arctic-480b", "ep_model"),
               "qwen3 fsdp_seq": ("qwen3-32b", "fsdp_seq")}


@pytest.mark.parametrize("name", sorted(NEW_LAYOUTS))
def test_new_layouts_trace_on_sixteen_fake_ranks(name):
    """Each layout the port refused before it ran per-block tensor
    parallelism, experts on the model axis and sequence parallelism traces
    ``ok`` as rank 0 of a fake group of 16, its state bytes the plan's."""
    arch, variant = NEW_LAYOUTS[name]
    cfg = get_config(arch).reduced(
        **(dict(n_heads=6, n_kv_heads=2, head_dim=32, n_experts=8) if arch == "arctic-480b"
           else {}))
    fn = hillclimb.VARIANTS[variant]["plan"]
    plan = (fn or (lambda p: p))(ParallelPlan(dp=4, tp=4, precision="bf16"))
    rec = dryrun.dryrun_one(arch, SMALL, multi_pod=False, plan=plan, cfg=cfg, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 16 and rec["mesh"] == "4x4"
    assert rec["state_bytes"] == train_state_bytes(cfg, plan)
    assert rec["collective_bytes_total"] > 0
    assert not dist.is_initialized()
