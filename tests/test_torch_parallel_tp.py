"""The port's Megatron tensor parallelism (gloo on the CPU) against its
single-device step and the JAX package's: yi-6b reduced as
tests/test_parallel_plan.py reduces it, fp32, 3 steps of 8 x 32 tokens,
weights from the reference, at tp = 2 and at dp = 2 x tp = 2 with ZeRO 0-3
and gas 2, kernels off and on; gpt-1.4b reduced to 2 heads of 88 at dp = 2
x tp = 2, zero 1 and 3, kernels on; yi at tp = 2 with its vocab padded so
that one rank's vocab shard is all padding (its CE kernel is never
called); the other sharding presets, kernels off: fsdp and dp_only at
dp = 2 x tp = 2, zero 1, and tp_only at tp = 2 and at dp = 2 x tp = 2
(every data rank takes the whole batch); zamba2-2.7b (4 layers,
hybrid_attn_every 2) and rwkv6-1.6b (4 layers) reduced at tp = 2, kernels
off and on, and at dp = 2 x tp = 2 at ZeRO 1 (kernels off) and 3 (on);
llama4-maverick (4 layers) and arctic reduced with 4 experts at ep 4, ep 2
x dp 2 (ZeRO 1, and 3 kernels on), ep 2 x tp 2 (kernels on), ep 2 x pp 2
and dp 4, with their drop fractions, all-to-all bytes and state bytes,
and arctic at node 2 x ep 2 (ZeRO 1 and 3, the 5-D mesh); the CommPlan's
yi plans (``_torch_ranks.COMM_PLANS``): node 2 x dp 2 at ZeRO 1 and 3,
dp 4 with overlap, a rule override (the vocab off the model axis) at
dp 2 x tp 2, and the int8 gathers (qcomm gather and both at dp 4, gather
at dp 2 x tp 2, both with overlap at node 2 x dp 2), the quantized ones
held to the reference's own quantized plans run live in a subprocess of
4 virtual devices (step 0 within 1e-4, later steps within
``QUANT_LATER_RTOL``, every step within 5% of the fp trajectory), and
every CommPlan plan's gather bytes, intra and inter, to
``costmodel.predict_comm_bytes``; tp above the kv heads, wk and wv whole
on every model rank (``KV_REPLICATED``: yi and llama4 at tp 4, yi at one
kv head under dp 2 x tp 2 with ZeRO 3, zamba2's shared block at tp 4),
with their gradients and weights after the steps.
Losses and grad norms within rtol 1e-5, atol 0 of the port's single device
and 1e-4 of the reference's; rwkv6's grad norms after the first update
within 1e-4 of both (see ``RWKV_LATER_NORMS``).  Two spawns (2 and 4 ranks)
run every plan; the 2-rank zamba2 plan also holds the split RMSNorm (the
gated norm's and ``ln_x``'s) to the whole-dim one, value and gradients,
and one loss's gradients of the zamba2 and rwkv6 tp = 2 plans, put
together from the ranks' blocks, are held to the single device's.
The vocab-parallel CE's shard and merge steps, without the collectives,
against the reference's per-token CE over the whole vocab.  On one process:
zamba2's regrouped in_proj and conv blocks ([z_k | x_k | B | C | dt_k],
[x_k | B | C]) round-trip exactly through ``shard_params`` /
``gather_params``, and ``train_state_bytes`` counts the rank's tensors.
Also what tp refuses: heads that do not split (kv heads that tp neither
divides nor is a multiple of, yi's and zamba2's shared block's, zamba2's
SSM heads, rwkv6's heads), prefill of a tp model."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_jax_ref
import _torch_ranks as ranks
from repro.kernels import ops as jops
from repro_torch.core import costmodel, sharding
from repro_torch.interop import gather_params, mesh_axes, shard_params
from repro_torch.models import model, moe, ssm
from repro_torch.models.common import flatten_specs
from repro_torch.models import vocab_parallel as vp
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.collectives import MeshGroups
from repro_torch.runtime.train_loop import (ParallelPlan, init_train_state,
                                            plan_state_shardings, train_state_bytes)

torch.set_num_threads(1)

RTOL_PLANS, RTOL_REF = 1e-5, 1e-4
STAGES = (0, 1, 2, 3)
GPT = dict(d_model=176, n_heads=2, head_dim=88)
# 120 tokens padded to 256 columns: the second tp = 2 shard is all padding
PADDED = dict(ranks.YI, vocab_size=120, vocab_pad_multiple=256)
RECURRENT = ranks.RECURRENT
MOE = ranks.MOE
MOE_KERNELS = ("ep2 dp2 z3", "ep2 tp2")    # the moe plans run with kernels on
# tp above the kv heads (``blocks.kv_heads_replicated``): wk and wv whole on
# every model rank.  name -> (weights, plan fields, kernels); the weights
# name the model as KV_MODELS does
KV_REPLICATED = {"kv yi tp4": ("yi", dict(tp=4), False),
                 "kv yi tp4 kernels": ("yi", dict(tp=4), True),
                 "kv yi tp4 z3": ("yi", dict(tp=4, zero=3), False),
                 "kv1 yi dp2 tp2 z3": ("yi kv1", dict(dp=2, tp=2, zero=3), False),
                 "kv zamba2 tp4": ("zamba2-2.7b", dict(tp=4), False),
                 "kv llama4 tp4": ("llama4-maverick-400b-a17b", dict(tp=4), False)}
# zamba2 at tp 4: the SSM decay A_log takes the largest gradient error
# (1.4e-5 of its largest element against the single device; its gradient
# sums the scan over every token), and the grad norm after the second
# update moves 1.6e-5 from the single device's, which sits 0.9e-5 from the
# reference's (the tp 4 run 0.7e-5): held at the reference's bar, as
# rwkv6's (RWKV_LATER_NORMS)
KV_ZAMBA2_LATER_NORMS = RTOL_REF
# Adam's normalised step turns fp32 noise in a near-zero gradient into a
# change of up to 2 lr a step, and the model group sums a gradient in
# another order than one device: at most 27 elements of a leaf of 1.1M
# (zamba2's in_proj) leave tests/test_torch_parallel.py's weight bar
# (rtol 1e-4, atol 1e-5), the largest by 3.4e-4 (zamba2's embed).  Every
# element within half of lr, at most one in 1000 of a leaf outside that bar
KV_WEIGHTS_ATOL = 0.5 * ranks.LR
KV_WEIGHTS_OUTSIDE = 1e-3
KV_MODELS = {"yi": ("yi-6b", ranks.YI), "yi kv1": ("yi-6b", dict(ranks.YI, n_kv_heads=1)),
             "zamba2-2.7b": ("zamba2-2.7b", RECURRENT["zamba2-2.7b"]),
             "llama4-maverick-400b-a17b": ("llama4-maverick-400b-a17b",
                                           MOE["llama4-maverick-400b-a17b"])}
# rwkv6 reduced: its bonus u takes a gradient of ~500 at step 0 against
# 1e-2 to 1e-1 for every other leaf, and Adam's first step moves each
# weight by +-lr whatever its gradient's size, so an element whose sign is
# within rounding flips its update; the grad norm after it, a residual of
# ~16, moves with fp32 rounding: the port's single device sits 4.6e-5 to
# 6.2e-5 from the reference there, and its own kernels on and off 0.65e-5
# to 0.9e-5 apart.  A model group's partial sums round differently (its
# gradients equal the single device's to ~1e-14 when every op runs in
# float64), so rwkv6's grad norms after step 0 are held at the reference's
# bar; its losses at every step and its step-0 grad norm at RTOL_PLANS.
RWKV_LATER_NORMS = RTOL_REF


def _plan(**kw):
    return dict(gas=2, precision="fp32", **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    weights, ref, single, after = {}, {}, {}, {}
    for name, arch, ov, kernels in (("yi", "yi-6b", ranks.YI, (False, True)),
                                    ("gpt", "gpt-1.4b", GPT, (True,)),
                                    ("padded", "yi-6b", PADDED, (True,)),
                                    ("yi kv1", *KV_MODELS["yi kv1"], (False,))):
        for k in kernels:
            weights[name], ref[name, k] = _torch_jax_ref.reference(arch, ov, _plan(kernels=k))
            single[name, k], after[name, k] = ranks.single_device(arch, ov, weights[name],
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
    four.append({"name": "tp_only dp2", "arch": "yi-6b", "overrides": ranks.YI,
                 "weights": "yi", "plan": _plan(dp=2, tp=2, zero=1, rules="tp_only")})
    for arch, ov in MOE.items():
        weights[arch], ref[arch] = _torch_jax_ref.reference(arch, ov, _plan())
        for k in (False, True):
            moe = []
            single[arch, k], after[arch, k] = ranks.single_device(arch, ov, weights[arch],
                                                                  _plan(kernels=k), moe=moe)
            single[arch, k, "moe"] = moe
        four += [{"name": f"{arch} {name}", "arch": arch, "overrides": ov, "weights": arch,
                  "plan": _plan(kernels=name in MOE_KERNELS, **plan)}
                 for name, plan in ranks.MOE_PLANS.items()]
    for arch, ov in RECURRENT.items():
        weights[arch], ref[arch] = _torch_jax_ref.reference(arch, ov, _plan())
        for k in (False, True):
            single[arch, k], after[arch, k] = ranks.single_device(arch, ov, weights[arch],
                                                                  _plan(kernels=k))
            two.append({"name": f"{arch} tp2 k{k}", "arch": arch, "overrides": ov,
                        "weights": arch, "plan": _plan(tp=2, kernels=k)})
        four += [{"name": f"{arch} dp2 tp2 z{z}", "arch": arch, "overrides": ov,
                  "weights": arch, "plan": _plan(dp=2, tp=2, zero=z, kernels=z == 3)}
                 for z in (1, 3)]
    four += [{"name": f"arctic-480b {name}", "arch": "arctic-480b",
              "overrides": MOE["arctic-480b"], "weights": "arctic-480b", "plan": _plan(**plan)}
             for name, plan in ranks.MOE_NODE_PLANS.items()]
    four += [{"name": name, "arch": "yi-6b", "overrides": ranks.YI, "weights": "yi",
              "plan": _plan(**plan)} for name, plan in ranks.COMM_PLANS.items()]
    four += [{"name": name, "arch": KV_MODELS[w][0], "overrides": KV_MODELS[w][1],
              "weights": w, "plan": _plan(kernels=k, **plan), "check": "grads_check"}
             for name, (w, plan, k) in KV_REPLICATED.items()]
    live = _start_quantized_reference(tmp_path_factory.mktemp("live"))
    checks = {"zamba2-2.7b tp2 kFalse": "split_norm_check",
              "zamba2-2.7b tp2 kTrue": "grads_check", "rwkv6-1.6b tp2 kFalse": "grads_check"}
    for job in two:
        if job["name"] in checks:
            job["check"] = checks[job["name"]]
    res = {}
    for world, jobs in ((2, two), (4, four)):
        res.update(ranks.run_ranks(world, jobs, weights,
                                   str(tmp_path_factory.mktemp(f"ranks{world}"))))
    for name, by_rank in res.items():
        for r, v in by_rank.items():
            assert "error" not in v, (name, r, v.get("error"))
    return {"ref": ref, "single": single, "after": after, "ranks": res,
            "live": _finish(live)}


# the reference's quantized plans, live on 4 virtual CPU devices (ZeRO 3,
# gas 2, fp32, the reduced yi from PRNGKey(0), the port's batches)
LIVE = {"dp2 tp2 z3 gather": dict(dp=2, tp=2, zero=3, qcomm="gather"),
        "node2 dp2 z3 both overlap": dict(node=2, dp=2, zero=3, qcomm="both", overlap=True)}
LIVE_CODE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import mesh_for_plan
from repro.models.model import Model
from repro.optim import AdamWConfig
from repro.runtime.train_loop import ParallelPlan, init_train_state, jit_train_step
yi, plans, lr, path = json.loads(sys.argv[1])
tokens = np.load(path)
model = Model(get_config("yi-6b").reduced(**yi), jnp.float32)
opt = AdamWConfig(lr=lr)
out = {}
for name, kw in plans.items():
    plan = ParallelPlan(gas=2, precision="fp32", **kw)
    state = init_train_state(model, jax.random.PRNGKey(0), opt, plan)
    step = jit_train_step(model, opt, plan, mesh_for_plan(plan), *tokens.shape[1:])
    traj = []
    for t in tokens:
        state, m = step(state, {"tokens": jnp.asarray(t)})
        traj.append([float(m["loss"]), float(m["grad_norm"])])
    out[name] = traj
print("LIVE" + json.dumps(out))
"""


def _start_quantized_reference(tmp):
    """Start the reference's LIVE plans in a subprocess of 4 virtual
    devices (``conftest.run_multidev``'s environment), beside the spawn."""
    import json
    import os
    import subprocess
    import sys

    from conftest import REPO

    path = os.path.join(str(tmp), "tokens.npy")
    np.save(path, np.stack([b["tokens"] for b in ranks.batches(ranks.YI["vocab_size"])]))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.Popen([sys.executable, "-c", LIVE_CODE,
                             json.dumps([ranks.YI, LIVE, ranks.LR, path])],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc) -> dict:
    import json

    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-4000:]
    return {k: np.array(v) for k, v in json.loads(out.split("LIVE")[-1]).items()}


def _check(runs, job: str, key: tuple, ref_key=None, later_norms: float = RTOL_PLANS):
    """Every rank's losses and grad norms against the single device's at
    RTOL_PLANS (grad norms after step 0 at ``later_norms``) and the
    reference's (``ref_key``, by default ``key``) at RTOL_REF; every rank's
    trajectory the same."""
    by_rank = runs["ranks"][job]
    single = np.array([t[:2] for t in runs["single"][key]])
    ref = runs["ref"][key if ref_key is None else ref_key]
    for r, res in by_rank.items():
        port = np.array([t[:2] for t in res["trajectory"]])
        np.testing.assert_allclose(port[:, 0], single[:, 0], rtol=RTOL_PLANS, atol=0,
                                   err_msg=f"rank {r} loss")
        np.testing.assert_allclose(port[:1, 1], single[:1, 1], rtol=RTOL_PLANS, atol=0,
                                   err_msg=f"rank {r} step-0 grad norm")
        np.testing.assert_allclose(port[1:, 1], single[1:, 1], rtol=later_norms, atol=0,
                                   err_msg=f"rank {r} grad norm")
        np.testing.assert_allclose(port, ref, rtol=RTOL_REF, atol=0, err_msg=f"rank {r}")
    first = by_rank[0]["trajectory"]
    assert all(res["trajectory"] == first for res in by_rank.values())


def _check_recurrent(runs, job: str, arch: str, kernels: bool):
    _check(runs, job, (arch, kernels), ref_key=arch,
           later_norms=RWKV_LATER_NORMS if arch == "rwkv6-1.6b" else RTOL_PLANS)


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


@pytest.mark.parametrize("job", sorted(KV_REPLICATED))
def test_kv_heads_replicated_match_single_device(runs, job):
    """tp above the kv heads (yi and llama4 reduced: 4 query / 2 kv heads
    at tp 4, llama4's dense sub-stack too; yi at 1 kv head under dp 2 x tp
    2, ZeRO 3; zamba2's shared block at tp 4): every model rank holds wk
    and wv whole and projects the kv head its query heads share, where the
    reference's rules split wk's columns below a head.  Losses and grad
    norms as ``_check`` holds them, zamba2's grad norms after the first
    update at the reference's bar (``KV_ZAMBA2_LATER_NORMS``); one loss's
    gradients of every leaf, put together from the ranks' blocks, within
    1e-4 of the leaf's largest element of the single device's
    (``test_tp2_gradients_equal_single_device``'s bar); the weights after
    the 3 steps, put together, as ``KV_WEIGHTS_*`` hold them."""
    w, fields, k = KV_REPLICATED[job]
    arch, ov = KV_MODELS[w]
    _check(runs, job, (w, k), ref_key=(w, k) if w.startswith("yi") else w,
           later_norms=KV_ZAMBA2_LATER_NORMS if arch == "zamba2-2.7b" else RTOL_PLANS)
    cfg = ranks.config(arch, ov)
    plan = ParallelPlan(**_plan(kernels=k, **fields))
    by_rank = runs["ranks"][job]
    wk = next(p for p in model.kv_replicated(cfg, plan.tp) if p.endswith("wk"))
    for r, res in by_rank.items():
        # whole over the model axis
        assert res["blocks"][wk].shape[-1] == cfg.n_kv_heads * cfg.resolved_head_dim
        for leaf, (diff, top) in res["check"].items():
            assert diff <= 1e-4 * top, (r, leaf, diff, top)
    gathered = gather_params({tuple(r["coord"][a] for a in mesh_axes(plan)): r["blocks"]
                              for r in by_rank.values()}, cfg, plan)
    for key, single in runs["after"][w, k].items():
        err = np.abs(gathered[key] - single)
        assert err.max() <= KV_WEIGHTS_ATOL, (key, err.max())
        outside = err > 1e-5 + 1e-4 * np.abs(single)
        assert outside.mean() <= KV_WEIGHTS_OUTSIDE, (key, int(outside.sum()), single.size)


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


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", sorted(RECURRENT))
def test_recurrent_tp2_matches_single_device(runs, arch, kernels):
    """zamba2: each rank's mamba layers on 8 of the 16 SSM heads, the shared
    block on 2 of its 4 heads; rwkv6: 2 of 4 heads, d_ff / 2."""
    _check_recurrent(runs, f"{arch} tp2 k{kernels}", arch, kernels)
    blocks = runs["ranks"][f"{arch} tp2 k{kernels}"][0]["blocks"]
    if arch == "zamba2-2.7b":       # [z_k | x_k | B | C | dt_k]: 256 + 256 + 32 + 8
        assert blocks["layers.in_proj"].shape == (4, 256, 552)
        assert blocks["layers.A_log"].shape == (4, 8)
        assert blocks["shared.attn.wq"].shape == (256, 128)
    else:
        assert blocks["layers.tm.wr"].shape == (4, 256, 128)
        assert blocks["layers.cm.wk"].shape == (4, 256, 256)


@pytest.mark.parametrize("job", ["zamba2-2.7b tp2 kTrue", "rwkv6-1.6b tp2 kFalse"])
def test_tp2_gradients_equal_single_device(runs, job):
    """One loss's gradient of every leaf, put together from the two ranks'
    blocks, against the single device's on the same weights and rows:
    within 1e-4 of the leaf's largest element (fp32 rounding reads up to
    ~7e-6 of it).  The replicated leaves used inside the model-parallel
    region (zamba2's B and C columns and channels, rwkv6's mu_* and
    w_lora_a) take both ranks' parts: one rank's alone would be off by
    about half."""
    for r, res in runs["ranks"][job].items():
        for leaf, (diff, top) in res["check"].items():
            assert diff <= 1e-4 * top, (r, leaf, diff, top)


@pytest.mark.parametrize("zero", [1, 3])
@pytest.mark.parametrize("arch", sorted(RECURRENT))
def test_recurrent_dp2_tp2_matches_single_device(runs, arch, zero):
    _check_recurrent(runs, f"{arch} dp2 tp2 z{zero}", arch, zero == 3)


def test_tp_only_at_dp2_takes_the_whole_batch(runs):
    """Every data rank takes all 8 rows (its loss over the token count summed
    over the data ranks, so the data reductions sum its 1/2 share): the
    single device's trajectory; ZeRO 1 still halves the moments."""
    _check(runs, "tp_only dp2", ("yi", False))
    res = runs["ranks"]["tp_only dp2"][0]
    assert res["blocks"]["embed"].shape == (128, 128)
    assert res["moments"]["layers.attn.wq"] == (4, 64, 64)


def test_split_rms_norm_matches_whole(runs):
    """The gated norm's and ln_x's RMSNorm over a dim split over the model
    group (``layers.rms_norm_split``): its value and the gradients of x and
    the weight equal the whole-dim RMSNorm's within fp32 rounding, on both
    ranks."""
    for r, res in runs["ranks"]["zamba2-2.7b tp2 kFalse"].items():
        for name, split, whole in zip(("y", "dx", "dw"), res["check"]["split"],
                                      res["check"]["whole"]):
            np.testing.assert_allclose(split, whole, rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("plan", sorted(ranks.MOE_PLANS))
@pytest.mark.parametrize("arch", sorted(MOE))
def test_moe_plans_match_single_device(runs, arch, plan):
    """The moe family's plans on 4 ranks (llama4 at 2 MoE units, arctic at
    2; 4 experts): ep 4, ep 2 x dp 2 at ZeRO 1 and 3, ep 2 x tp 2, ep 2 x
    pp 2 and dp 4 (ep 1: the experts on the data axis, gathered on use).
    Losses and grad norms as every plan's; the measured drop fraction
    within 1e-6 of the single device's at every step, whatever the plan
    (each rank routes the rows the flat dp x ep plan gives it); each step's
    token all-to-all bytes equal ``costmodel.predict_a2a_bytes`` for the
    rank's MoE units and the gas microbatches (dispatch and combine forward
    and backward, and again in remat full's recompute); each rank holds
    the parameter and Adam-moment bytes ``train_state_bytes`` counts."""
    job, p = f"{arch} {plan}", ParallelPlan(**_plan(kernels=plan in MOE_KERNELS,
                                                       **ranks.MOE_PLANS[plan]))
    _check_moe(runs, arch, job, p)


def _check_moe(runs, arch: str, job: str, p: ParallelPlan) -> None:
    _check(runs, job, (arch, p.kernels), ref_key=arch)
    cfg = ranks.config(arch, MOE[arch])
    G, g = moe.group_shape(ranks.BATCH // p.gas, ranks.SEQ)
    C = moe.moe_capacity(g, cfg)
    per = sum(costmodel.predict_a2a_bytes(G, cfg.n_experts, C, cfg.d_model, dp=p.dp,
                                          ep=p.ep, node=p.node, with_backward=bwd)
              for bwd in (True, False))
    a2a = per * p.gas * model.stage_units(cfg)[1] // p.pp
    want = train_state_bytes(cfg, p)
    single = runs["single"][arch, p.kernels, "moe"]
    for r, res in runs["ranks"][job].items():
        np.testing.assert_allclose([m[1] for m in res["moe"]], [m[1] for m in single],
                                   rtol=0, atol=1e-6, err_msg=f"rank {r} moe_drop")
        np.testing.assert_allclose([m[0] for m in res["moe"]], [m[0] for m in single],
                                   rtol=RTOL_PLANS, err_msg=f"rank {r} moe_aux")
        assert [c["all-to-all"] for c in res["comm_bytes"]] == [a2a if p.ep > 1 else 0] * 3
        assert 4 * sum(int(np.prod(b.shape)) for b in res["blocks"].values()) \
            == want["param_bytes"]
        assert 2 * 4 * sum(int(np.prod(s)) for s in res["moments"].values()) \
            == want["opt_bytes"]
    assert single[0][1] > 0          # capacity 1.25 drops some assignments


@pytest.mark.parametrize("plan", sorted(ranks.MOE_NODE_PLANS))
def test_moe_node_by_ep_matches_single_device(runs, plan):
    """Reduced arctic on the 5-D (node, pipe, data, expert, model) mesh at
    node 2 x ep 2, ZeRO 1 and 3: the rows split over node, then expert (as
    the flat ep 2 x dp 2 plan splits them over data, then expert), the
    token all-to-all over the expert group; held as every moe plan."""
    p = ParallelPlan(**_plan(**ranks.MOE_NODE_PLANS[plan]))
    _check_moe(runs, "arctic-480b", f"arctic-480b {plan}", p)
    for res in runs["ranks"][f"arctic-480b {plan}"].values():
        assert res["gather_phases"][0]["inter"] > 0 or p.zero < 3


# the CommPlan's plans that move no value: held as every plan
COMM_FP = ("node2 dp2 z1", "node2 dp2 z3", "dp4 z3 overlap", "dp2 tp2 z3 overrides")
COMM_QUANT = tuple(k for k in ranks.COMM_PLANS if k not in COMM_FP)
# a quantized plan's later steps against the reference's live plan: after
# the first update a weight that sits within rounding of a boundary of its
# block's int8 grid (a step of max|block| / 127) can dequantize one step
# apart in the two programs, whose fp32 updates round differently; the
# grad norms of these plans' steps 1-2 move by up to 3.6e-5 so (losses
# 2.1e-6; step 0 within 1.4e-6), held with a 5x margin
QUANT_LATER_RTOL = 2e-4
# the reference's bar on a quantized plan's drift from the fp trajectory
QUANT_DRIFT = 0.05


@pytest.mark.parametrize("job", COMM_FP)
def test_commplan_fp_plans_match_single_device(runs, job):
    """node 2 x dp 2 at ZeRO 1 and 3 (the state on the node axis too, each
    gather in an inter- and an intra-node phase), dp 4 with overlap (a
    chunk of layers' gathers issued a chunk ahead), and a rule override
    (the vocab off the model axis) equal the single device, as any plan."""
    _check(runs, job, ("yi", False))
    p = ParallelPlan(**_plan(**ranks.COMM_PLANS[job]))
    want = train_state_bytes(ranks.config("yi-6b", ranks.YI), p)
    for res in runs["ranks"][job].values():
        assert 4 * sum(int(np.prod(b.shape)) for b in res["blocks"].values()) \
            == want["param_bytes"]
        assert 2 * 4 * sum(int(np.prod(s)) for s in res["moments"].values()) \
            == want["opt_bytes"]
    if job == "dp2 tp2 z3 overrides":
        assert runs["ranks"][job][0]["blocks"]["embed"].shape == (128, 128)


@pytest.mark.parametrize("job", COMM_QUANT)
def test_quantized_plans_match_the_reference(runs, job):
    """Every quantized plan's step 0 within RTOL_REF of the reference's live
    quantized plan (its loss sees the same int8 weights whatever the plan;
    its grad norm the live plan of the same qcomm), its later steps within
    QUANT_LATER_RTOL of the live plan of the same fields, every step
    within QUANT_DRIFT of the fp trajectory, every rank the same."""
    p = ParallelPlan(**_plan(**ranks.COMM_PLANS[job]))
    live = runs["live"]
    same = {"gather": "dp2 tp2 z3 gather", "both": "node2 dp2 z3 both overlap"}[p.qcomm]
    fp = np.array([t[:2] for t in runs["single"]["yi", False]])
    by_rank = runs["ranks"][job]
    for r, res in by_rank.items():
        port = np.array([t[:2] for t in res["trajectory"]])
        np.testing.assert_allclose(port[0], live[same][0], rtol=RTOL_REF, atol=0,
                                   err_msg=f"rank {r} step 0")
        if job in live:
            np.testing.assert_allclose(port, live[job], rtol=QUANT_LATER_RTOL, atol=0,
                                       err_msg=f"rank {r}")
        assert (np.abs(port[:, 0] - fp[:, 0]) / fp[:, 0]).max() < QUANT_DRIFT
        assert not np.array_equal(port[:, 0], fp[:, 0])     # the gathers did quantize
    first = by_rank[0]["trajectory"]
    assert all(res["trajectory"] == first for res in by_rank.values())


def test_live_reference_quantized_plans_drift_within_the_bar(runs):
    fp = np.array(runs["ref"]["yi", False])
    for name, traj in runs["live"].items():
        assert (np.abs(traj[:, 0] - fp[:, 0]) / fp[:, 0]).max() < QUANT_DRIFT, name


@pytest.mark.parametrize("job", sorted(ranks.COMM_PLANS))
def test_commplan_gather_bytes_equal_the_costmodel(runs, job):
    """Each step's ``zero3_gather`` bytes, and their intra (data group) and
    inter (node group) phases, equal ``costmodel.predict_comm_bytes`` over
    the plan's shapes, specs and CommPlan (``unit_axes``: the one-rank data
    group of an ep plan is a phase): the layer stack gathered twice a
    microbatch (forward, or its early issue under overlap, and the
    recompute), every other leaf once; at ZeRO 1 nothing is gathered."""
    cfg = ranks.config("yi-6b", ranks.YI)
    p = ParallelPlan(**_plan(**ranks.COMM_PLANS[job]))
    shapes, psh, _, _ = plan_state_shardings(cfg, p)
    stacked = {k for k in shapes if k.startswith("layers.")}

    def predicted(keys, multiplier):
        return costmodel.predict_comm_bytes([shapes[k] for k in keys], [psh[k] for k in keys],
                                            p.mesh_sizes(), p.comm_plan(), itemsize=4,
                                            multiplier=multiplier, unit_axes=True)
    a, b = predicted(sorted(stacked), 2 * p.gas), predicted(sorted(set(shapes) - stacked), p.gas)
    want = {k: a[k] + b[k] for k in a}
    for res in runs["ranks"][job].values():
        for step, phases in zip(res["comm_bytes"], res["gather_phases"]):
            assert step["zero3_gather"] == want["total"] == phases["total"]
            assert phases["intra"] == want["intra"] and phases["inter"] == want["inter"]
    if p.node > 1 and p.zero == 3:
        assert 0 < want["inter"] < want["intra"]


def test_quantized_gather_moves_3x_fewer_bytes_in_fp32(runs):
    """int8 payloads with an fp32 scale per 32 elements: (1 + 4/32) / 4 of
    the fp32 gather's bytes, 3.56x fewer (the reference's >= 3x bar)."""
    fp = runs["ranks"]["dp4 z3 overlap"][0]["comm_bytes"][0]["zero3_gather"]
    for job in ("dp4 z3 gather", "dp4 z3 both"):
        q = runs["ranks"][job][0]["comm_bytes"][0]["zero3_gather"]
        assert fp / q >= 3.0, (job, fp / q)


def _zamba2():
    return ranks.config("zamba2-2.7b", RECURRENT["zamba2-2.7b"])


@pytest.mark.parametrize("plan", [dict(tp=2), dict(tp=4), dict(dp=2, tp=2, zero=3),
                                  dict(pp=2, tp=2)], ids=["tp2", "tp4", "dp2tp2z3", "pp2tp2"])
def test_regrouped_blocks_round_trip(plan):
    """Each rank's in_proj block is [z_k | x_k | B | C | dt_k] of the whole
    leaf's columns and its conv blocks [x_k | B | C] (its heads' parts, B
    and C whole); every rank's blocks put back together are the whole tree,
    bit for bit."""
    cfg, p = _zamba2(), ParallelPlan(**_plan(**plan))
    rng = np.random.RandomState(0)
    shapes, _, _, _ = plan_state_shardings(cfg, p)
    tree = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    di, N, H, tp = ssm.d_inner(cfg), cfg.ssm_state, ssm.n_ssm_heads(cfg), p.tp
    blocks = {}
    for i in range(p.pp):
        for j in range(p.dp):
            for m in range(tp):
                coord = {"pipe": i, "data": j, "model": m}
                blocks[i, j, m] = b = shard_params(tree, cfg, p, coord)
                c, h, dt = di // tp, H // tp, 2 * di + 2 * N
                cols = np.r_[m * c:(m + 1) * c, di + m * c:di + (m + 1) * c,
                             2 * di:dt, dt + m * h:dt + (m + 1) * h]
                chans = np.r_[m * c:(m + 1) * c, di:di + 2 * N]
                rows = slice(i * 2, (i + 1) * 2) if p.pp > 1 else slice(None)
                d_rows = (slice(j * 128, (j + 1) * 128) if p.zero == 3
                          else slice(None))          # ZeRO 3 on in_proj's d dim
                np.testing.assert_array_equal(b["layers.in_proj"],
                                              tree["layers.in_proj"][rows][:, d_rows][..., cols])
                np.testing.assert_array_equal(b["layers.conv_b"],
                                              tree["layers.conv_b"][rows][..., chans])
                assert b["layers.conv_w"].shape[-1] == len(chans)
    gathered = gather_params(blocks, cfg, p)
    for k, w in tree.items():
        np.testing.assert_array_equal(gathered[k], w, err_msg=k)


@pytest.mark.parametrize("plan", sorted(ranks.MOE_PLANS))
def test_moe_blocks_round_trip(plan):
    """arctic reduced (4 experts) under each moe plan: the rank at expert
    coordinate e holds experts [e E/ep, (e + 1) E/ep) of every expert leaf
    (at ep 1 its block over the data ranks), its d_ff columns under tp;
    every rank's blocks put back together are the whole tree, bit for
    bit."""
    cfg = ranks.config("arctic-480b", MOE["arctic-480b"])
    p = ParallelPlan(**_plan(**ranks.MOE_PLANS[plan]))
    rng = np.random.RandomState(1)
    shapes, _, _, _ = plan_state_shardings(cfg, p)
    tree = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    blocks = {}
    for i in range(p.pp):
        for j in range(p.dp):
            for e in range(p.ep):
                for m in range(p.tp):
                    coord = {"pipe": i, "data": j, "expert": e, "model": m}
                    b = shard_params(tree, cfg, p, coord)
                    blocks[(i, j, m) if p.ep == 1 else (i, j, e, m)] = b
                    w1 = tree["layers.moe.w1"]
                    if p.ep > 1:
                        w1 = w1[:, e * 4 // p.ep:(e + 1) * 4 // p.ep]
                    else:
                        w1 = w1[:, j * 4 // p.dp:(j + 1) * 4 // p.dp]
                    rows = slice(i, i + 1) if p.pp > 1 else slice(None)
                    cols = slice(m * 512 // p.tp, (m + 1) * 512 // p.tp)
                    w1 = w1[rows][..., cols]
                    if p.zero == 3 and p.ep > 1:        # ZeRO 3: the data axis on d
                        w1 = w1[:, :, j * 256 // p.dp:(j + 1) * 256 // p.dp]
                    np.testing.assert_array_equal(b["layers.moe.w1"], w1)
    gathered = gather_params(blocks, cfg, p)
    for k, w in tree.items():
        np.testing.assert_array_equal(gathered[k], w, err_msg=k)


def _fake_mesh(plan, coord):
    return MeshGroups(sizes=plan.mesh_sizes(), coord=coord,
                      groups={"pipe": None, "data": None, "model": None}, world=None)


@pytest.mark.parametrize("zero", STAGES)
@pytest.mark.parametrize("arch", sorted(RECURRENT))
def test_train_state_bytes_are_the_ranks_tensors(arch, zero):
    """At dp = 2 x tp = 2 every rank's stored parameters and Adam moments
    take the bytes ``train_state_bytes`` counts (zamba2's regrouped blocks
    as the ranks hold them, the B and C columns whole on each)."""
    cfg = ranks.config(arch, RECURRENT[arch])
    plan = ParallelPlan(**_plan(dp=2, tp=2, zero=zero))
    want = train_state_bytes(cfg, plan)
    for m in range(2):
        model = Model(cfg, torch.float32, device="cpu", shardings=plan_state_shardings(
            cfg, plan)[1], mesh=_fake_mesh(plan, {"pipe": 0, "data": 1, "model": m}))
        state = init_train_state(model, AdamWConfig(lr=ranks.LR), plan)
        assert sum(p.numel() * 4 for p in model.parameters()) == want["param_bytes"]
        assert sum(t.numel() * 4 for t in (*state["opt"]["mu"].values(),
                                           *state["opt"]["nu"].values())) == want["opt_bytes"]


@pytest.mark.parametrize("arch,overrides,tp,leaf", [
    ("yi-6b", {**ranks.YI, "n_heads": 6, "n_kv_heads": 3}, 2, "layers.attn.wk"),
    ("zamba2-2.7b", dict(n_layers=4, ssm_head_dim=128), 8, "layers.in_proj"),
    ("zamba2-2.7b", dict(RECURRENT["zamba2-2.7b"], n_heads=6, n_kv_heads=3), 2,
     "shared.attn.wk"),
    ("rwkv6-1.6b", RECURRENT["rwkv6-1.6b"], 8, "layers.tm.wr"),
], ids=["yi_kv_heads", "zamba2_ssm_heads", "zamba2_shared_kv_heads", "rwkv6_heads"])
def test_tp_refuses_heads_that_do_not_split(arch, overrides, tp, leaf):
    """The reference's lenient rules shard a dim that tp divides, mid-head
    or not: yi reduced at 6 heads has 3 kv heads (tp 2 splits its wk
    mid-head; tp 4 at its 2 kv heads keeps wk whole, ``kv_replicated``),
    zamba2 at SSM head dim 128 has 4 SSM heads (tp 8), its shared block at 6
    heads 3 kv heads (tp 2), rwkv6 reduced 4 heads of 64 (tp 8: 32 columns
    a rank).  The port's own plan keeps yi's attention whole there
    (``model.whole_heads``; tests/test_torch_parallel_rules.py runs it), so
    yi's leaves take the reference's lenient specs here; the recurrent
    families keep the all-or-none rule.  Given a split below a head, the
    model refuses, naming the leaf."""
    cfg = ranks.config(arch, overrides)
    plan = ParallelPlan(tp=tp)
    _, psh, _, _ = plan_state_shardings(cfg, plan)
    for k in model.whole_heads(cfg, tp):
        assert "model" not in psh[k]
        spec = dict(flatten_specs(model.param_specs(cfg)))[k]
        psh[k] = sharding.partition_spec(spec.shape, spec.axes, plan.mesh_sizes(),
                                         plan.sharding_rules(), unit_axes=True)
    assert "model" in psh[leaf]
    mesh = _fake_mesh(plan, {"pipe": 0, "data": 0, "model": 0})
    with pytest.raises(NotImplementedError, match=leaf):
        Model(cfg, torch.float32, device="cpu", shardings=psh, mesh=mesh)
