"""The port's pipeline parallelism (gloo on the CPU) against its single-device
step and the JAX package's: yi-6b reduced as tests/test_parallel_plan.py
reduces it (4 layers), fp32, 3 steps of 8 x 32 tokens at gas 2 (the
pipeline's two microbatches), weights from the reference, kernels off and
on, at pp = 2 x dp = 2 with ZeRO 0-3, pp = 2 x dp = 2 with two virtual
stages a rank (the round-robin assignment: rank d holds layers d and
d + 2), pp = 4, pp = 2 x tp = 2 and pp = 2 x dp = 2 at ZeRO 3 under remat
selective (the policy inside each stage); zamba2-2.7b and rwkv6-1.6b reduced to 4
layers at pp = 2 x dp = 2, ZeRO 3, and at pp = 2 x tp = 2, kernels on; one
fp16 step at pp = 2 x dp = 2.  Losses and grad norms within rtol 1e-5,
atol 0 of the port's single device and 1e-4 of the reference's jitted
single-device step (the bars of tests/test_torch_parallel.py; rwkv6's
grad norms after step 0 under tp at 1e-4, as in
tests/test_torch_parallel_tp.py).  Four ranks run every plan in one
spawn."""
import numpy as np
import pytest
import torch

import _torch_jax_ref
import _torch_ranks as ranks
from repro_torch.core import telemetry
from repro_torch.core.pipeline import schedule
from repro_torch.interop import gather_params
from repro_torch.runtime.train_loop import ParallelPlan

torch.set_num_threads(1)

RTOL_PLANS, RTOL_REF = 1e-5, 1e-4
STAGES = (0, 1, 2, 3)
RECURRENT = ranks.RECURRENT
# rwkv6's grad norms after step 0 under tp: tests/test_torch_parallel_tp.py
RWKV_TP_LATER_NORMS = RTOL_REF
# name -> the plan's parallel fields (4 ranks each)
YI_PLANS = {**{f"pp2 dp2 z{z}": dict(pp=2, dp=2, zero=z) for z in STAGES},
            "pp2 dp2 v2": dict(pp=2, dp=2, virtual_stages=2),
            "pp4": dict(pp=4),
            "pp2 tp2": dict(pp=2, tp=2),
            "pp2 dp2 z3 selective": dict(pp=2, dp=2, zero=3, remat="selective")}


def _plan(**kw):
    return dict(gas=2, precision="fp32", **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    weights, ref, single = {}, {}, {}
    for k in (False, True):
        weights["yi"], ref[k] = _torch_jax_ref.reference("yi-6b", ranks.YI, _plan(kernels=k))
        single[k] = ranks.single_device("yi-6b", ranks.YI, weights["yi"], _plan(kernels=k))
    jobs = [{"name": f"{name} k{k}", "arch": "yi-6b", "overrides": ranks.YI, "weights": "yi",
             "plan": _plan(kernels=k, **plan)} for name, plan in YI_PLANS.items()
            for k in (False, True)]
    for arch, ov in RECURRENT.items():
        weights[arch], ref[arch] = _torch_jax_ref.reference(arch, ov, _plan(kernels=False))
        single[arch] = ranks.single_device(arch, ov, weights[arch], _plan(kernels=True))
        jobs.append({"name": arch, "arch": arch, "overrides": ov, "weights": arch,
                     "plan": _plan(pp=2, dp=2, zero=3, kernels=True)})
        jobs.append({"name": f"{arch} tp2", "arch": arch, "overrides": ov, "weights": arch,
                     "plan": _plan(pp=2, tp=2, kernels=True)})
    jobs.append({"name": "fp16", "arch": "yi-6b", "overrides": ranks.YI, "weights": "yi",
                 "plan": dict(pp=2, dp=2, gas=2, precision="fp16"), "steps": 1})
    res = ranks.run_ranks(4, jobs, weights, str(tmp_path_factory.mktemp("ranks")))
    for name, by_rank in res.items():
        for r, v in by_rank.items():
            assert "error" not in v, (name, r, v.get("error"))
    return {"ref": ref, "single": single, "ranks": res, "weights": weights}


def _losses(traj):
    return np.array([t[:2] for t in traj])


def _check(runs, job: str, key, later_norms: float = RTOL_PLANS):
    """Losses and grad norms against the single device's at RTOL_PLANS
    (grad norms after step 0 at ``later_norms``) and the reference's at
    RTOL_REF; every rank's trajectory the same."""
    by_rank = runs["ranks"][job]
    single, _ = runs["single"][key]
    for r, res in by_rank.items():
        port = _losses(res["trajectory"])
        np.testing.assert_allclose(port[:, 0], _losses(single)[:, 0], rtol=RTOL_PLANS, atol=0,
                                   err_msg=f"{job} rank {r} loss")
        np.testing.assert_allclose(port[:1, 1], _losses(single)[:1, 1], rtol=RTOL_PLANS,
                                   atol=0, err_msg=f"{job} rank {r} step-0 grad norm")
        np.testing.assert_allclose(port[1:, 1], _losses(single)[1:, 1], rtol=later_norms,
                                   atol=0, err_msg=f"{job} rank {r} grad norm")
        np.testing.assert_allclose(port, runs["ref"][key], rtol=RTOL_REF, atol=0,
                                   err_msg=f"{job} rank {r}")
    first = by_rank[0]["trajectory"]
    assert all(res["trajectory"] == first for res in by_rank.values())   # every rank


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("plan", sorted(YI_PLANS))
def test_pipelined_plans_match_single_device(runs, plan, kernels):
    _check(runs, f"{plan} k{kernels}", kernels)


def test_virtual_stages_store_the_round_robin_layers(runs):
    """pp = 2 x v = 2 over 4 layers: logical stages 0-3 of one layer each,
    pipe rank d hosts stages d and d + 2, so it stores layers d and d + 2 (a
    half of the stack) and replicates the embedding; the blocks put back
    together are the single-device weights after the same steps."""
    by_rank = runs["ranks"]["pp2 dp2 v2 kFalse"]
    whole = runs["weights"]["yi"]["layers.attn.wq"]
    for res in by_rank.values():
        assert res["blocks"]["layers.attn.wq"].shape == (2, *whole.shape[1:])
        assert res["blocks"]["embed"].shape == runs["weights"]["yi"]["embed"].shape
    cfg = ranks.config("yi-6b", ranks.YI)
    plan = ParallelPlan(**_plan(**YI_PLANS["pp2 dp2 v2"]))
    gathered = gather_params({(r["coord"]["pipe"], r["coord"]["data"], r["coord"]["model"]):
                              r["blocks"] for r in by_rank.values()}, cfg, plan)
    _, after = runs["single"][False]
    # Adam's normalised step turns fp32 noise in a near-zero gradient into
    # a change of up to lr (1e-3) a step: atol is 1% of that
    for k, w in after.items():
        np.testing.assert_allclose(gathered[k], w, rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", sorted(RECURRENT))
def test_recurrent_families_pp2_dp2_zero3(runs, arch):
    """zamba2's shared block runs in both stages (its gradient summed over
    the pipe ranks); rwkv6's blocks split two a stage."""
    _check(runs, arch, arch)


@pytest.mark.parametrize("arch", sorted(RECURRENT))
def test_recurrent_families_pp2_tp2(runs, arch):
    """Each pipe rank's stages on its model rank's heads; zamba2's shared
    block, kept whole over the pipe group, has its gradient summed over the
    two pipe ranks of each model coordinate only."""
    _check(runs, f"{arch} tp2", arch,
           RWKV_TP_LATER_NORMS if arch == "rwkv6-1.6b" else RTOL_PLANS)


@pytest.mark.parametrize("plan", ["pp4", "pp2 dp2 v2"])
def test_step_records_measure_the_pipeline(runs, plan):
    """Each rank measures its sweep: its applications are the schedule's,
    its time in them lies inside the sweep's, and a rank waits for its
    neighbours, so the measured idle share of a step lies in (0, 1)."""
    fields = YI_PLANS[plan]
    p, v = fields["pp"], fields.get("virtual_stages", 1)
    sched = schedule(p, 2, v)
    by_rank = runs["ranks"][f"{plan} kFalse"]
    for step in range(ranks.STEPS):
        walks = [res["walks"][step] for res in by_rank.values()]
        for res, w in zip(by_rank.values(), walks):
            assert w["applications"] == len(sched.ranks[res["coord"]["pipe"]])
            assert 0.0 < w["busy_s"] <= w["wall_s"]
        measured = telemetry.pipeline_fields(p, 2, v, walks)
        assert 0.0 < measured["idle_fraction"] < 1.0


def test_fp16_pp2_step(runs):
    """The reference's bar (tests/test_memplan.py): finite grads, a loss
    scale above 1, the loss within 2e-2 of the fp32 step's."""
    fp32 = runs["single"][False][0][0][0]
    for res in runs["ranks"]["fp16"].values():
        loss, _, finite, scale = res["trajectory"][0]
        assert finite and scale > 1.0
        assert abs(loss - fp32) / fp32 < 2e-2
