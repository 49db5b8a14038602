"""The port's Megatron tensor parallelism (gloo on the CPU) against its
single-device step and the JAX package's: yi-6b reduced as
tests/test_parallel_plan.py reduces it, fp32, 3 steps of 8 x 32 tokens,
weights from the reference, at tp = 2 and at dp = 2 x tp = 2 with ZeRO 0-3
and gas 2, kernels off and on; gpt-1.4b reduced to 2 heads of 88 at dp = 2
x tp = 2, zero 1 and 3, kernels on; yi at tp = 2 with its vocab padded so
that one rank's vocab shard is all padding (its CE kernel is never
called); the other sharding presets, kernels off: fsdp and dp_only at
dp = 2 x tp = 2, zero 1, and tp_only at tp = 2.  Losses and grad norms
within rtol 1e-5, atol 0 of the port's single device and 1e-4 of the
reference's.  Two spawns (2 and 4 ranks) run
every plan.  The vocab-parallel CE's shard and merge steps, without the
collectives, against the reference's per-token CE over the whole vocab.
Also what tp refuses: the hybrid and rwkv families, heads that do not
split, prefill of a tp model."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_jax_ref
import _torch_ranks as ranks
from repro.kernels import ops as jops
from repro_torch.models import vocab_parallel as vp
from repro_torch.models.model import Model
from repro_torch.runtime.collectives import MeshGroups
from repro_torch.runtime.train_loop import ParallelPlan, plan_state_shardings

torch.set_num_threads(1)

RTOL_PLANS, RTOL_REF = 1e-5, 1e-4
STAGES = (0, 1, 2, 3)
GPT = dict(d_model=176, n_heads=2, head_dim=88)
# 120 tokens padded to 256 columns: the second tp = 2 shard is all padding
PADDED = dict(ranks.YI, vocab_size=120, vocab_pad_multiple=256)


def _plan(**kw):
    return dict(gas=2, precision="fp32", **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    weights, ref, single = {}, {}, {}
    for name, arch, ov, kernels in (("yi", "yi-6b", ranks.YI, (False, True)),
                                    ("gpt", "gpt-1.4b", GPT, (True,)),
                                    ("padded", "yi-6b", PADDED, (True,))):
        for k in kernels:
            weights[name], ref[name, k] = _torch_jax_ref.reference(arch, ov, _plan(kernels=k))
            single[name, k], _ = ranks.single_device(arch, ov, weights[name],
                                                     _plan(kernels=k))
    two = [{"name": f"tp2 k{k}", "arch": "yi-6b", "overrides": ranks.YI, "weights": "yi",
            "plan": _plan(tp=2, kernels=k), "check": "prefill_refused"}
           for k in (False, True)]
    two.append({"name": "padded", "arch": "yi-6b", "overrides": PADDED, "weights": "padded",
                "plan": _plan(tp=2, kernels=True)})
    two.append({"name": "tp_only", "arch": "yi-6b", "overrides": ranks.YI, "weights": "yi",
                "plan": _plan(tp=2, rules="tp_only")})
    four = [{"name": f"z{z} k{k}", "arch": "yi-6b", "overrides": ranks.YI, "weights": "yi",
             "plan": _plan(dp=2, tp=2, zero=z, kernels=k)}
            for z in STAGES for k in (False, True)]
    four += [{"name": f"gpt z{z}", "arch": "gpt-1.4b", "overrides": GPT, "weights": "gpt",
              "plan": _plan(dp=2, tp=2, zero=z, kernels=True)} for z in (1, 3)]
    four += [{"name": rules, "arch": "yi-6b", "overrides": ranks.YI, "weights": "yi",
              "plan": _plan(dp=2, tp=2, zero=1, rules=rules)} for rules in ("fsdp", "dp_only")]
    res = {}
    for world, jobs in ((2, two), (4, four)):
        res.update(ranks.run_ranks(world, jobs, weights,
                                   str(tmp_path_factory.mktemp(f"ranks{world}"))))
    for name, by_rank in res.items():
        for r, v in by_rank.items():
            assert "error" not in v, (name, r, v.get("error"))
    return {"ref": ref, "single": single, "ranks": res}


def _check(runs, job: str, key: tuple):
    by_rank = runs["ranks"][job]
    single = np.array([t[:2] for t in runs["single"][key]])
    for r, res in by_rank.items():
        port = np.array([t[:2] for t in res["trajectory"]])
        np.testing.assert_allclose(port, single, rtol=RTOL_PLANS, atol=0, err_msg=f"rank {r}")
        np.testing.assert_allclose(port, runs["ref"][key], rtol=RTOL_REF, atol=0)
    first = by_rank[0]["trajectory"]
    assert all(res["trajectory"] == first for res in by_rank.values())


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_tp2_matches_single_device(runs, kernels):
    _check(runs, f"tp2 k{kernels}", ("yi", kernels))
    for res in runs["ranks"][f"tp2 k{kernels}"].values():
        assert "ROADMAP" in res["check"]                  # prefill refused
        # Megatron shards: each rank holds half of wq's heads and of the vocab
        assert res["blocks"]["layers.attn.wq"].shape == (4, 128, 64)
        assert res["blocks"]["embed"].shape == (128, 128)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("zero", STAGES)
def test_dp2_tp2_matches_single_device(runs, zero, kernels):
    _check(runs, f"z{zero} k{kernels}", ("yi", kernels))


@pytest.mark.parametrize("zero", [1, 3])
def test_gpt_hd88_dp2_tp2(runs, zero):
    """One head of 88 per rank, LayerNorm and GELU-MLP at d_ff / 2."""
    _check(runs, f"gpt z{zero}", ("gpt", True))


@pytest.mark.parametrize("rules", ["fsdp", "dp_only", "tp_only"])
def test_rules_presets_match_single_device(runs, rules):
    """fsdp also shards every leaf's embed dim over the data ranks
    (gathered on use), dp_only replicates the model over the model group,
    tp_only keeps the batch off the data axis."""
    _check(runs, rules, ("yi", False))
    blocks = runs["ranks"][rules][0]["blocks"]
    assert blocks["embed"].shape == {"fsdp": (128, 64), "dp_only": (256, 128),
                                     "tp_only": (128, 128)}[rules]
    assert blocks["layers.attn.wq"].shape == (4, 64 if rules == "fsdp" else 128,
                                              128 if rules == "dp_only" else 64)


def test_vocab_shard_all_padding(runs):
    _check(runs, "padded", ("padded", True))


@pytest.mark.parametrize("tp,valid", [(2, 256), (4, 197), (2, 120)],
                         ids=["whole", "padded", "shard_all_padding"])
def test_vocab_shards_merge_to_the_jax_tokens(tp, valid):
    """Each shard's (lse, label logit) by ``shard_terms``, the lse merged by
    ``merge_lse`` and the label logits summed (what the all-gather and the
    all-reduce do over a model group) give the reference's per-token losses
    over the whole vocab (tests/test_torch_kernels.py's fp32 tolerance)."""
    N, d, V = 60, 64, 256
    rng = np.random.RandomState(13)
    h = (0.5 * rng.randn(N, d)).astype(np.float32)
    w = (0.1 * rng.randn(d, V)).astype(np.float32)
    labels = rng.randint(0, valid, N).astype(np.int32)
    labels[-1] = valid - 1
    parts = [vp.shard_terms(torch.from_numpy(h), torch.from_numpy(w[:, r * V // tp:]
                                                                 [:, :V // tp].copy()),
                            torch.from_numpy(labels), valid, r * V // tp) for r in range(tp)]
    assert sum(int(p[3].sum()) for p in parts) == N         # each label owned once
    losses = vp.merge_lse(torch.stack([p[0] for p in parts])) - sum(p[1] for p in parts)
    ref = jops.cross_entropy_tokens(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
                                    valid)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_tp_refused_for_recurrent_families(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        plan_state_shardings(ranks.config(arch, {}), ParallelPlan(tp=2))


def test_tp_refuses_heads_that_do_not_split():
    """yi reduced has 2 kv heads: at tp = 4 its wk splits mid-head (the
    reference's lenient rules shard it all the same)."""
    cfg = ranks.config("yi-6b", ranks.YI)
    plan = ParallelPlan(tp=4)
    _, psh, _, _ = plan_state_shardings(cfg, plan)
    assert psh["layers.attn.wk"][2] == "model"
    mesh = MeshGroups(sizes=plan.mesh_sizes(), coord={"pipe": 0, "data": 0, "model": 0},
                      groups={"pipe": None, "data": None, "model": None}, world=None)
    with pytest.raises(NotImplementedError, match="layers.attn.wk"):
        Model(cfg, torch.float32, device="cpu", shardings=psh, mesh=mesh)
