"""The reference's sharding rules in full on the port's executor (gloo on the
CPU): the plans of ``launch/hillclimb.py`` that remap the logical axes,
against the port's single-device step and the JAX package's
``build_train_step`` on the same numpy weights (fp32, 3 steps of 8 x 32
tokens, gas 2), all in one spawn of 4 ranks:

  * the lenient split: yi reduced at 6 query / 3 kv heads under dp 2 x
    tp 2 (the heads do not split over 2: the attention runs whole on every
    model rank, the MLP and the vocab split); arctic reduced at 6 heads and
    8 experts under tp 4 (attention whole, the dense residual, the experts'
    d_ff and the vocab split); seamless reduced at a vocab of 510, which
    does not split over tp 4 (embedding and lm_head whole, the CE over the
    whole vocab);
  * arctic under ``moe_dp_attn`` (attention and dense residual whole, the
    experts' d_ff split), ``ep_model`` (2 whole experts a model rank) and
    ``embed_replicated``;
  * sequence parallelism: ``seq_shard`` (Megatron's sequence parallelism)
    for yi and arctic at tp 4 and at dp 2 x tp 2 under ZeRO 0 and 3, for yi
    also with the vocab whole and with the kernels' entries (their plain
    versions on the CPU); ``fsdp_seq`` (every block whole, the weights on
    the data axis) and ``moe_dp_attn+seq`` for both.

Losses and grad norms within 1e-5 of the single device and 1e-4 of the
reference; one loss's gradients of every leaf, put together from the
ranks' blocks (a leaf whole over the model group summed over it under
sequence parallelism, as the train step sums it), within 1e-4 of the
leaf's largest element of the single device's; arctic's ``moe_drop``
within 1e-6 and ``moe_aux`` within 1e-5 of the single device's at every
step; the dry run's traced collective bytes (rank 0 of a fake group of 4)
equal to rank 0's in the gloo run's first step, kind by kind; a save under
``ep_model`` restores on one device to the ranks' weights.  What stays
refused is refused, naming ROADMAP.md: the sequence under pp > 1 and for
the other families, and ``ep`` > 1 with it.

The file takes ~80 s alone on the CPU (~150 s in the 6-worker tier-1
run), the spawn about half of it."""
import numpy as np
import pytest
import torch

import _torch_jax_ref
import _torch_ranks as ranks
from repro_torch.checkpointing import restore_checkpoint
from repro_torch.configs.shapes import InputShape
from repro_torch.core import sharding as shd
from repro_torch.interop import gather_params, mesh_axes
from repro_torch.launch import dryrun
from repro_torch.launch.hillclimb import VARIANTS
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.collectives import MeshGroups
from repro_torch.runtime.train_loop import (ParallelPlan, check_activation_rules,
                                            init_train_state, plan_state_shardings)

torch.set_num_threads(1)

RTOL_PLANS, RTOL_REF = 1e-5, 1e-4


def _overrides(variant: str) -> tuple:
    """The rule overrides of a hillclimb variant."""
    return VARIANTS[variant]["plan"](ParallelPlan()).rule_overrides


# name -> (architecture, the overrides of its .reduced())
MODELS = {"yi": ("yi-6b", ranks.YI),
          "yi lenient": ("yi-6b", dict(ranks.YI, n_heads=6, n_kv_heads=3)),
          "arctic": ("arctic-480b", dict(n_heads=6, n_kv_heads=2, head_dim=32, n_experts=8)),
          "seamless": ("seamless-m4t-medium", dict(vocab_size=510))}
SEQ = _overrides("seq_shard")
# name -> (model, plan fields, kernels, checks: "grads" for the gradient
# check, "ckpt" for the save)
PLANS = {
    "yi lenient dp2 tp2": ("yi lenient", dict(dp=2, tp=2), False, ()),
    "arctic lenient tp4": ("arctic", dict(tp=4), False, ("grads",)),
    "seamless lenient tp4": ("seamless", dict(tp=4), False, ("grads",)),
    "arctic moe_dp_attn tp4": ("arctic", dict(tp=4, rule_overrides=_overrides("moe_dp_attn")),
                               False, ("grads",)),
    "arctic ep_model tp4": ("arctic", dict(tp=4, rule_overrides=_overrides("ep_model")),
                            False, ("grads", "ckpt")),
    "arctic ep_model+embed_repl dp2 tp2 z3": (
        "arctic", dict(dp=2, tp=2, zero=3, rule_overrides=_overrides("ep_model+embed_repl")),
        False, ()),
    "arctic embed_replicated tp4": (
        "arctic", dict(tp=4, rule_overrides=_overrides("embed_replicated")), False, ()),
    "yi seq_shard tp4": ("yi", dict(tp=4, rule_overrides=SEQ), False, ("grads",)),
    "yi seq_shard dp2 tp2 z0": ("yi", dict(dp=2, tp=2, zero=0, rule_overrides=SEQ), False, ()),
    "yi seq_shard dp2 tp2 z3": ("yi", dict(dp=2, tp=2, zero=3, rule_overrides=SEQ), False,
                                ("grads",)),
    "yi seq_shard tp4 kernels": ("yi", dict(tp=4, rule_overrides=SEQ), True, ()),
    "yi seq_shard+embed_repl tp4": (
        "yi", dict(tp=4, rule_overrides=SEQ + _overrides("embed_replicated")), False,
        ("grads",)),
    "arctic seq_shard tp4": ("arctic", dict(tp=4, rule_overrides=SEQ), False, ("grads",)),
    "arctic seq_shard dp2 tp2 z0": ("arctic", dict(dp=2, tp=2, zero=0, rule_overrides=SEQ),
                                    False, ()),
    "arctic seq_shard dp2 tp2 z3": ("arctic", dict(dp=2, tp=2, zero=3, rule_overrides=SEQ),
                                    False, ("grads",)),
    "yi fsdp_seq dp2 tp2": ("yi", dict(dp=2, tp=2, rule_overrides=_overrides("fsdp_seq")),
                            False, ()),
    "arctic fsdp_seq dp2 tp2": (
        "arctic", dict(dp=2, tp=2, rule_overrides=_overrides("fsdp_seq")), False, ()),
    "yi moe_dp_attn+seq tp4": (
        "yi", dict(tp=4, rule_overrides=_overrides("moe_dp_attn+seq")), False, ("grads",)),
    "arctic moe_dp_attn+seq dp2 tp2 z3": (
        "arctic", dict(dp=2, tp=2, zero=3, rule_overrides=_overrides("moe_dp_attn+seq")),
        False, ("grads",)),
}


def _plan(kernels: bool = False, **kw) -> dict:
    return dict(gas=2, precision="fp32", kernels=kernels, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    weights, ref, single = {}, {}, {}
    for name, (arch, ov) in MODELS.items():
        weights[name], ref[name] = _torch_jax_ref.reference(arch, ov, _plan())
    for name, fields, k, _ in PLANS.values():
        if (name, k) not in single:
            moe: list = []
            traj, _ = ranks.single_device(*MODELS[name], weights[name], _plan(k), moe=moe)
            single[name, k] = (traj, moe)
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    jobs = []
    for job, (name, fields, k, checks) in PLANS.items():
        arch, ov = MODELS[name]
        jobs.append({"name": job, "arch": arch, "overrides": ov, "weights": name,
                     "plan": _plan(k, **fields)})
        if "grads" in checks:
            jobs[-1]["check"] = "grads_check"
        if "ckpt" in checks:
            jobs[-1]["ckpt_save"] = ckpt
    res = ranks.run_ranks(4, jobs, weights, str(tmp_path_factory.mktemp("ranks")))
    for name, by_rank in res.items():
        for r, v in by_rank.items():
            assert "error" not in v, (name, r, v.get("error"))
    return {"ref": ref, "single": single, "ranks": res, "ckpt": ckpt}


@pytest.mark.parametrize("job", sorted(PLANS))
def test_plan_matches_single_device_and_reference(runs, job):
    name, fields, k, checks = PLANS[job]
    single, moe = runs["single"][name, k]
    single = np.array([t[:2] for t in single])
    by_rank = runs["ranks"][job]
    for r, res in by_rank.items():
        port = np.array([t[:2] for t in res["trajectory"]])
        np.testing.assert_allclose(port, single, rtol=RTOL_PLANS, atol=0, err_msg=f"rank {r}")
        np.testing.assert_allclose(port, runs["ref"][name], rtol=RTOL_REF, atol=0,
                                   err_msg=f"rank {r} against the reference")
        if MODELS[name][0] == "arctic-480b":
            np.testing.assert_allclose([m[1] for m in res["moe"]], [m[1] for m in moe],
                                       rtol=0, atol=1e-6, err_msg=f"rank {r} moe_drop")
            np.testing.assert_allclose([m[0] for m in res["moe"]], [m[0] for m in moe],
                                       rtol=RTOL_PLANS, err_msg=f"rank {r} moe_aux")
        for leaf, (diff, top) in res.get("check", {}).items():
            assert diff <= 1e-4 * top, (r, leaf, diff, top)
        assert ("check" in res) == ("grads" in checks)
    first = by_rank[0]["trajectory"]
    assert all(res["trajectory"] == first for res in by_rank.values())


def _blocks(runs, job: str) -> dict:
    return runs["ranks"][job][0]["blocks"]


def test_lenient_layouts(runs):
    """What each model rank holds: the heads that do not split whole, the
    MLP's d_ff and the vocab split (yi at 6 / 3 heads over tp 2; arctic at
    6 heads over tp 4), seamless's vocab of 510 whole over tp 4."""
    yi = _blocks(runs, "yi lenient dp2 tp2")
    assert yi["layers.attn.wq"].shape == (4, 128, 192)
    assert yi["layers.attn.wk"].shape == (4, 128, 96)
    assert yi["layers.mlp.w1"].shape == (4, 128, 128)
    assert yi["embed"].shape == (128, 128)
    arctic = _blocks(runs, "arctic lenient tp4")
    assert arctic["layers.attn.wq"].shape == (2, 256, 192)
    assert arctic["layers.moe.w1"].shape == (2, 8, 256, 128)
    assert arctic["layers.moe.dense.w1"].shape == (2, 256, 64)
    assert arctic["embed"].shape == (128, 256)
    seamless = _blocks(runs, "seamless lenient tp4")
    assert seamless["embed"].shape == (510, 256)
    assert seamless["lm_head"].shape == (256, 510)
    assert seamless["layers.cross.wq"].shape == (2, 256, 64)


def test_experts_on_the_model_axis(runs):
    """``ep_model``: each model rank holds 2 of the 8 experts whole, rank m
    experts [2m, 2m + 2), every expert leaf's d_ff whole; the dense
    residual stays split."""
    cfg = ranks.config(*MODELS["arctic"])
    plan = ParallelPlan(**_plan(tp=4, rule_overrides=_overrides("ep_model")))
    gathered = gather_params({tuple(r["coord"][a] for a in mesh_axes(plan)): r["blocks"]
                              for r in runs["ranks"]["arctic ep_model tp4"].values()}, cfg, plan)
    for r, res in runs["ranks"]["arctic ep_model tp4"].items():
        m = res["coord"]["model"]
        for leaf in ("layers.moe.w1", "layers.moe.w2", "layers.moe.w3"):
            assert res["blocks"][leaf].shape[1] == 2
            np.testing.assert_array_equal(res["blocks"][leaf], gathered[leaf][:, 2 * m:2 * m + 2])
        assert res["blocks"]["layers.moe.dense.w1"].shape == (2, 256, 64)


def test_ep_model_save_restores_on_one_device(runs):
    """The ranks' save after 3 steps under ``ep_model`` (each rank's whole
    experts gathered on rank 0) restores into a one-device model: every
    weight equal to the ranks' blocks put together."""
    cfg = ranks.config(*MODELS["arctic"])
    plan = ParallelPlan(**_plan(tp=4, rule_overrides=_overrides("ep_model")))
    by_rank = runs["ranks"]["arctic ep_model tp4"]
    gathered = gather_params({tuple(r["coord"][a] for a in mesh_axes(plan)): r["blocks"]
                              for r in by_rank.values()}, cfg, plan)
    model = Model(cfg, torch.float32, device="cpu")
    state = init_train_state(model, AdamWConfig(lr=ranks.LR), ParallelPlan(**_plan()))
    restore_checkpoint(runs["ckpt"], ranks.STEPS, state)
    for k, p in model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), gathered[k], err_msg=k)


def test_sequence_parallel_shards(runs):
    """Under ``seq_shard`` the weights are Megatron's (yi: wq on the rank's
    head, wk/wv whole above the 2 kv heads at tp 4); under ``fsdp_seq``
    every block is whole over the model group and its embed dim on the data
    axis."""
    yi = _blocks(runs, "yi seq_shard tp4")
    assert yi["layers.attn.wq"].shape == (4, 128, 32)
    assert yi["layers.attn.wk"].shape == (4, 128, 64)
    fsdp = _blocks(runs, "yi fsdp_seq dp2 tp2")
    assert fsdp["layers.attn.wq"].shape == (4, 64, 128)
    assert fsdp["layers.mlp.w1"].shape == (4, 64, 256)
    assert fsdp["embed"].shape == (128, 64)


TRACED = sorted(job for job, (_, _, k, _) in PLANS.items() if not k)


@pytest.mark.parametrize("job", TRACED)
def test_trace_bytes_equal_the_gloo_run(runs, job):
    """The dry run's trace of the plan (rank 0 of a fake group of 4 on the
    meta device) counts the collective bytes, kind by kind, that rank 0
    counted in the gloo run's first step."""
    name, fields, k, _ = PLANS[job]
    arch, ov = MODELS[name]
    plan = ParallelPlan(**_plan(k, **fields))
    rec = dryrun.dryrun_one(arch, InputShape("ranks", "train", ranks.SEQ, ranks.BATCH),
                            multi_pod=False, plan=plan, cfg=ranks.config(arch, ov),
                            verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    rank0 = next(res for res in runs["ranks"][job].values()
                 if not any(res["coord"].values()))
    assert rec["comm_bytes"] == {k: float(v) for k, v in rank0["comm_bytes"][0].items()}
    assert rec["comm_bytes"]["total"] > 0


@pytest.mark.parametrize("arch,fields,what", [
    ("yi-6b", dict(pp=2, dp=2), "pp = 2"),
    ("zamba2-2.7b", dict(tp=2), "hybrid"),
    ("seamless-m4t-medium", dict(tp=2), "encdec"),
    ("arctic-480b", dict(ep=2, tp=2), "ep = 2"),
], ids=["pp2", "hybrid", "encdec", "ep2"])
def test_sequence_parallelism_refuses_the_rest(arch, fields, what):
    """``seq`` on the model axis runs the dense and moe families at pp = 1
    and ep = 1; the rest raises, naming ROADMAP.md."""
    plan = ParallelPlan(rule_overrides=SEQ, **fields)
    with pytest.raises(NotImplementedError, match="ROADMAP") as e:
        check_activation_rules(plan, ranks.config(arch, {}))
    assert what in str(e.value)


def test_a_block_whose_leaves_disagree_raises():
    """Hand-made specs that split ``wq`` but keep ``wo`` whole are no layout
    the port runs: the model raises, naming the leaf."""
    cfg = ranks.config("yi-6b", ranks.YI)
    plan = ParallelPlan(tp=2)
    _, psh, _, _ = plan_state_shardings(cfg, plan)
    psh = dict(psh, **{"layers.attn.wo": (None, None, None)})
    mesh = MeshGroups(sizes=plan.mesh_sizes(), coord={"pipe": 0, "data": 0, "model": 0},
                      groups={"pipe": None, "data": None, "model": None}, world=None)
    with pytest.raises(NotImplementedError, match="layers.attn.wo"):
        Model(cfg, torch.float32, device="cpu", shardings=psh, mesh=mesh)
    assert "model" in shd.spec_axes(psh["layers.attn.wq"])

