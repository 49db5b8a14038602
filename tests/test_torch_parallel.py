"""The port's sharded executor over data ranks (gloo on the CPU) against
its single-device step and the JAX package's: yi-6b reduced as
tests/test_parallel_plan.py reduces it (4 layers, d 128, 4 heads / 2 kv of
32, d_ff 256, vocab 256), fp32, 3 steps of 8 x 32 tokens, weights from the
reference (``interop.shard_params``), at dp = 2 with ZeRO 0-3 and gas 2,
kernels off and on; zamba2-2.7b and rwkv6-1.6b reduced to 4 layers at
dp = 2, zero = 3, kernels on, from the reference's weights; one fp16 step
at dp = 2, zero = 3.  Losses and grad norms agree within rtol 1e-5, atol 0
with the port's single device (the reference's bar between plans,
tests/test_memplan.py) and within 1e-4 with the reference's jitted
single-device step (tests/test_torch_train.py), for the recurrent families
its plain path (their Pallas bodies' interpret mode is held to the port in
tests/test_torch_ssm.py and tests/test_torch_wkv.py).  ZeRO 3 also runs
under remat selective (kernels off and on) and none, held to the same
bars, and the collectives' byte counters of the ZeRO 3 runs are held to
``costmodel.predict_comm_bytes`` of the same shapes and specs.  The serve
engine's dp slots (``ServeEngine(mesh=, plan=)``, plan dp = 2, ZeRO 0) for
yi-6b reduced (the paged pool), rwkv6-1.6b reduced (slot state) and
h2o-danube-1.8b reduced with the int8 cache (its ring), internvl2-2b
reduced at its head dim 128 (the paged pool, each request with its
patches ahead of the prompt), and yi-6b again
with arrivals 20 ms apart and the ranks' clocks 50 ms apart (admission on
data rank 0's clock): each rank's tokens
equal the single-device engine's and the JAX package's greedy streams, and
each rank holds half the single-device cache.  The dry run's trace of the
dp = 2, ZeRO 3 plan counts rank 0's FLOPs and collective bytes; a
checkpoint saved at dp = 2, ZeRO 3 and restored at tp = 2 continues the
single device's losses, and rank 0 receives each distinct block of a save
once (nothing at ZeRO 0).  Two ranks run every plan in one spawn."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_jax_ref
import _torch_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.runtime.serve_loop import greedy_generate as jax_greedy_generate
from repro_torch.configs.shapes import InputShape
from repro_torch.checkpointing import restore_checkpoint
from repro_torch.core import commplan, costmodel
from repro_torch.launch import dryrun
from repro_torch.interop import flatten_tree, gather_params
from repro_torch.models.common import flatten_specs
from repro_torch.models.model import Model, param_specs
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import ParallelPlan, init_train_state, plan_state_shardings

torch.set_num_threads(1)

RTOL_PLANS, RTOL_REF = 1e-5, 1e-4
STAGES = (0, 1, 2, 3)
RECURRENT = {"zamba2-2.7b": dict(n_layers=4), "rwkv6-1.6b": dict(n_layers=4)}
# the dp = 2 serve jobs: name -> (arch, .reduced() overrides, weights,
# seconds between arrivals).  Staggered arrivals land between ticks, and
# the ranks' clocks differ by ranks.SERVE_SKEW, so they would admit
# different requests unless they agree on admission.
SERVE = {"yi paged": ("yi-6b", ranks.YI, "yi", 0.0),
         "yi paged staggered": ("yi-6b", ranks.YI, "yi", 0.02),
         "rwkv6 slots": ("rwkv6-1.6b", RECURRENT["rwkv6-1.6b"], "rwkv6-1.6b", 0.0),
         "danube int8 ring": ("h2o-danube-1.8b", dict(kv_quant=True), "danube", 0.0),
         "vlm paged": ("internvl2-2b", dict(head_dim=128), "vlm", 0.0)}


def _jax_greedy(arch: str, overrides: dict, weights: dict) -> dict:
    """The JAX package's greedy stream of each serve prompt (with its
    patches for vlm) on ``weights``."""
    jm = JaxModel(jax_get_config(arch).reduced(**overrides), jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    assert flatten_tree(jax.tree.map(np.asarray, jp)).keys() == weights.keys()
    jp = jax.tree.map(lambda _, k: jnp.asarray(weights[k]), jp, _paths(jp))
    cfg = ranks.config(arch, overrides)
    cache_len = ranks.SERVE["cache_len"] + (cfg.num_patches if cfg.family == "vlm" else 0)
    return {i: np.asarray(jax_greedy_generate(
        jm, jp, jnp.asarray(p)[None], ranks.SERVE_NEW, cache_len,
        extras=None if x is None else {k: jnp.asarray(v)[None] for k, v in x.items()}))[0].tolist()
        for i, (p, x) in enumerate(zip(ranks.serve_prompts(jm.cfg.vocab_size),
                                       ranks.serve_extras(cfg)))}


def _paths(tree, prefix=""):
    """``tree`` with each leaf replaced by its dotted path."""
    if not isinstance(tree, dict):
        return prefix
    return {k: _paths(v, f"{prefix}.{k}" if prefix else k) for k, v in tree.items()}


def _plan(**kw):
    return dict(gas=2, precision="fp32", **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    weights, ref, single = {}, {}, {}
    for k in (False, True):
        weights["yi"], ref[k] = _torch_jax_ref.reference("yi-6b", ranks.YI, _plan(kernels=k))
        single[k] = ranks.single_device("yi-6b", ranks.YI, weights["yi"], _plan(kernels=k))
    jobs = [{"name": f"z{z} k{k}", "arch": "yi-6b", "overrides": ranks.YI, "weights": "yi",
             "plan": _plan(dp=2, zero=z, kernels=k)} for z in STAGES for k in (False, True)]
    ckpt, ckpt_z0 = (str(tmp_path_factory.mktemp(n)) for n in ("ckpt", "ckpt_z0"))
    # FlopCounterMode moves fp32 rounding (~1e-5 in the weights after 3
    # steps), so the counted step runs apart
    jobs += [{"name": "flops dp2 z3", "arch": "yi-6b", "overrides": ranks.YI, "weights": "yi",
              "plan": _plan(dp=2, zero=3), "steps": 1, "flops": True},
             {"name": "ckpt save dp2 z3", "arch": "yi-6b", "overrides": ranks.YI,
              "weights": "yi", "plan": _plan(dp=2, zero=3), "steps": 1, "ckpt_save": ckpt},
             {"name": "ckpt save dp2 z0", "arch": "yi-6b", "overrides": ranks.YI,
              "weights": "yi", "plan": _plan(dp=2, zero=0), "steps": 1,
              "ckpt_save": ckpt_z0},
             {"name": "ckpt restore tp2", "arch": "yi-6b", "overrides": ranks.YI,
              "weights": "yi", "plan": _plan(tp=2), "skip": 1, "steps": ranks.STEPS - 1,
              "ckpt_restore": ckpt}]
    jobs += [{"name": f"z3 {remat} k{k}", "arch": "yi-6b", "overrides": ranks.YI,
              "weights": "yi", "plan": _plan(dp=2, zero=3, kernels=k, remat=remat)}
             for remat, k in (("selective", False), ("selective", True), ("none", False))]
    for arch, ov in RECURRENT.items():
        weights[arch], ref[arch] = _torch_jax_ref.reference(arch, ov, _plan(kernels=False))
        single[arch] = ranks.single_device(arch, ov, weights[arch], _plan(kernels=True))
        jobs.append({"name": arch, "arch": arch, "overrides": ov, "weights": arch,
                     "plan": _plan(dp=2, zero=3, kernels=True)})
    jobs.append({"name": "fp16", "arch": "yi-6b", "overrides": ranks.YI, "weights": "yi",
                 "plan": dict(dp=2, zero=3, gas=2, precision="fp16"), "steps": 1})
    jd = JaxModel(dataclasses.replace(jax_get_config("h2o-danube-1.8b").reduced(),
                                      kv_quant=True), jnp.float32)
    weights["danube"] = flatten_tree(jax.tree.map(np.asarray, jd.init(jax.random.PRNGKey(0))))
    jv = JaxModel(jax_get_config("internvl2-2b").reduced(head_dim=128), jnp.float32)
    weights["vlm"] = flatten_tree(jax.tree.map(np.asarray, jv.init(jax.random.PRNGKey(0))))
    serve = {}
    jax_greedy = {}
    for name, (arch, ov, w, stagger) in SERVE.items():
        if w not in jax_greedy:
            jax_greedy[w] = _jax_greedy(arch, ov, weights[w])
        serve[name] = {"single": ranks.serve_engine(arch, ov, weights[w], stagger=stagger),
                       "jax": jax_greedy[w]}
        jobs.append({"name": name, "arch": arch, "overrides": ov, "weights": w,
                     "plan": dict(dp=2, zero=0), "serve": True, "stagger": stagger})
    res = ranks.run_ranks(2, jobs, weights, str(tmp_path_factory.mktemp("ranks")))
    for name, by_rank in res.items():
        for r, v in by_rank.items():
            assert "error" not in v, (name, r, v.get("error"))
    return {"ref": ref, "single": single, "ranks": res, "serve": serve, "ckpt_z0": ckpt_z0}


def _losses(traj):
    return np.array([t[:2] for t in traj])


def test_trace_equals_the_gloo_run(runs):
    """The dry run's trace of the dp 2, ZeRO 3 plan (rank 0 of a fake group
    on the meta device, ``launch/dryrun.py``) counts the FLOPs and the
    collective bytes by kind that rank 0 counted in the gloo run's first
    step."""
    plan = ParallelPlan(**_plan(dp=2, zero=3))
    rec = dryrun.dryrun_one("yi-6b", InputShape("ranks", "train", ranks.SEQ, ranks.BATCH),
                            multi_pod=False, plan=plan, cfg=ranks.config("yi-6b", ranks.YI),
                            verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    rank0 = runs["ranks"]["flops dp2 z3"][0]
    assert rec["flops_per_device"] == rank0["flops"][0] > 0
    assert rec["comm_bytes"] == {k: float(v) for k, v in rank0["comm_bytes"][0].items()}
    assert rec["comm_bytes"]["zero3_gather"] > 0


def test_resume_across_plans(runs):
    """Saved under dp 2, ZeRO 3 after one step (``save_checkpoint`` of the
    ranks' blocks), restored under tp 2: the next steps' losses and grad
    norms equal the single device's straight run within 1e-5."""
    single = _losses(runs["single"][False][0])
    saved = runs["ranks"]["ckpt save dp2 z3"]
    for res in saved.values():
        np.testing.assert_allclose(_losses(res["trajectory"]), single[:1], rtol=RTOL_PLANS, atol=0)
    for res in runs["ranks"]["ckpt restore tp2"].values():
        np.testing.assert_allclose(_losses(res["trajectory"]), single[1:], rtol=RTOL_PLANS,
                                   atol=0)


@pytest.mark.parametrize("zero", [0, 3])
def test_checkpoint_save_receives_each_block_once(runs, zero):
    """Rank 0 writes a sharded save, receiving one copy of each block it
    does not hold: at dp 2, ZeRO 3 rank 1's half of every parameter and of
    both moments, at ZeRO 0 (every leaf replicated over the data ranks)
    nothing.  The ZeRO 0 save restores on one device to the ranks'
    parameters."""
    saved = runs["ranks"][f"ckpt save dp2 z{zero}"]
    cfg = ranks.config("yi-6b", ranks.YI)
    shapes, *_ = plan_state_shardings(cfg, ParallelPlan(**_plan(dp=2, zero=zero)))
    whole = sum(int(np.prod(s)) for s in shapes.values())
    assert saved[0]["ckpt_received"] == (3 * 4 * whole // 2 if zero == 3 else 0)
    assert saved[1]["ckpt_received"] == 0
    if zero == 0:
        model = Model(cfg, torch.float32, device="cpu")
        state = init_train_state(model, AdamWConfig(lr=ranks.LR), ParallelPlan(**_plan()))
        restore_checkpoint(runs["ckpt_z0"], 1, state)
        for k, p in model.state_dict().items():
            np.testing.assert_array_equal(p.numpy(), saved[0]["blocks"][k], err_msg=k)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("zero", STAGES)
def test_dp2_zero_matches_single_device(runs, zero, kernels):
    by_rank = runs["ranks"][f"z{zero} k{kernels}"]
    single, _ = runs["single"][kernels]
    for r, res in by_rank.items():
        port = _losses(res["trajectory"])
        np.testing.assert_allclose(port, _losses(single), rtol=RTOL_PLANS, atol=0,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(port, runs["ref"][kernels], rtol=RTOL_REF, atol=0)
    assert by_rank[0]["trajectory"] == by_rank[1]["trajectory"]   # every rank the same


@pytest.mark.parametrize("zero", STAGES)
def test_dp2_state_is_sharded_by_stage(runs, zero):
    """Stage 3 stores only the blocks (half of every leaf here), stage >= 1
    holds half of each moment; the blocks put back together are the
    single-device weights after the same steps."""
    by_rank = runs["ranks"][f"z{zero} k{False}"]
    cfg = ranks.config("yi-6b", ranks.YI)
    shapes, *_ = plan_state_shardings(cfg, ParallelPlan(**_plan(dp=2, zero=zero)))
    whole = sum(int(np.prod(s)) for s in shapes.values())
    stored = sum(b.size for b in by_rank[0]["blocks"].values())
    moments = sum(int(np.prod(s)) for s in by_rank[0]["moments"].values())
    assert stored == (whole // 2 if zero == 3 else whole)
    assert moments == (whole if zero == 0 else whole // 2)
    plan = ParallelPlan(**_plan(dp=2, zero=zero))
    gathered = gather_params({(0, r["coord"]["data"], r["coord"]["model"]): r["blocks"]
                              for r in by_rank.values()}, cfg, plan)
    _, after = runs["single"][False]
    # Adam's normalised step turns fp32 noise in a near-zero gradient into
    # a change of up to lr (1e-3) a step: atol is 1% of that
    for k, w in after.items():
        np.testing.assert_allclose(gathered[k], w, rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", sorted(RECURRENT))
def test_recurrent_families_dp2_zero3(runs, arch):
    single, _ = runs["single"][arch]
    for res in runs["ranks"][arch].values():
        port = _losses(res["trajectory"])
        np.testing.assert_allclose(port, _losses(single), rtol=RTOL_PLANS, atol=0)
        np.testing.assert_allclose(port, runs["ref"][arch], rtol=RTOL_REF, atol=0)


def test_fp16_dp2_zero3_step(runs):
    """The reference's bar (tests/test_memplan.py): finite grads, a loss
    scale above 1, the loss within 2e-2 of the fp32 step's."""
    fp32 = runs["single"][False][0][0][0]
    for res in runs["ranks"]["fp16"].values():
        loss, _, finite, scale = res["trajectory"][0]
        assert finite and scale > 1.0
        assert abs(loss - fp32) / fp32 < 2e-2


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_dp2_zero3_selective_matches_single_device(runs, kernels):
    """remat selective at ZeRO 3: each layer's leaves gathered inside the
    selective checkpoint, gathered again in its recompute (never saved)."""
    single, _ = runs["single"][kernels]
    for r, res in runs["ranks"][f"z3 selective k{kernels}"].items():
        port = _losses(res["trajectory"])
        np.testing.assert_allclose(port, _losses(single), rtol=RTOL_PLANS, atol=0,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(port, runs["ref"][kernels], rtol=RTOL_REF, atol=0)


@pytest.mark.parametrize("remat", ["full", "selective", "none"])
def test_zero3_gather_bytes_equal_the_costmodel(runs, remat):
    """Each step's ``zero3_gather`` bytes (an all-gather's output, as the
    reference's ``analysis/hlo.py:comm_bytes`` counts it) equal
    ``costmodel.predict_comm_bytes`` over the plan's shapes and specs: the
    layer stack gathered twice a microbatch under remat full and selective
    (the forward and the recompute; the backward gathers nothing: the
    reference's ``predict`` bills 3 for XLA) and once under none, the
    embedding, the final norm and the lm_head once a microbatch."""
    job = "z3 kFalse" if remat == "full" else f"z3 {remat} kFalse"
    cfg = ranks.config("yi-6b", ranks.YI)
    plan = ParallelPlan(**_plan(dp=2, zero=3, remat=remat))
    shapes, psh, _, _ = plan_state_shardings(cfg, plan)
    stacked = {k for k, spec in flatten_specs(param_specs(cfg)) if spec.axes[:1] == ("layers",)}
    gathers = (1 if remat == "none" else 2) * plan.gas

    def predicted(keys, multiplier):
        return costmodel.predict_comm_bytes([shapes[k] for k in keys], [psh[k] for k in keys],
                                            plan.mesh_sizes(), commplan.CommPlan(),
                                            itemsize=4, multiplier=multiplier)["total"]
    want = (predicted(sorted(stacked), gathers)
            + predicted(sorted(set(shapes) - stacked), plan.gas))
    for res in runs["ranks"][job].values():
        assert len(res["comm_bytes"]) == ranks.STEPS
        for step in res["comm_bytes"]:
            assert step["zero3_gather"] == want
            assert step["reduce-scatter"] > 0 and step["total"] == sum(
                v for k, v in step.items() if k != "total")


@pytest.mark.parametrize("name", sorted(SERVE))
def test_dp2_engine_matches_single_device(runs, name):
    """Every rank's tokens equal the single-device engine's and the JAX
    greedy streams (every rank samples from the gathered logits); each
    rank holds half of the single-device cache: its slots' rows, or its
    half of the paged pool."""
    single, ref = runs["serve"][name]["single"], runs["serve"][name]["jax"]
    assert single["tokens"] == ref
    for r, res in runs["ranks"][name].items():
        assert res["tokens"] == single["tokens"], f"rank {r}"
        assert res["paged"] == single["paged"] == ("paged" in name)
        assert 2 * res["cache_bytes"] == single["cache_bytes"], f"rank {r}"
