"""The pieces of the port's train step against their JAX-package originals:
synthetic batches, train_step_flops, AdamW (clip, decay mask, skip), the LR
schedules, loss scaling, Model.loss/logits; and the single-device plan's
refusals, the remat policy and the training launcher on the CPU."""
import dataclasses
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import costmodel as jax_costmodel
from repro.core import precision as jax_prec
from repro.core.compute import ComputePolicy as JaxPolicy
from repro.data import SyntheticCorpus as JaxCorpus, make_batch_iterator as jax_batches
from repro.models.model import Model as JaxModel
from repro.runtime.train_loop import ParallelPlan as JaxPlan
from repro.optim import (AdamWConfig as JaxAdamW, adamw_init as jax_adamw_init,
                         adamw_update as jax_adamw_update,
                         cosine_schedule as jax_cosine, linear_warmup as jax_warmup)
from repro_torch.configs import get_config
from repro_torch.core import costmodel, precision
from repro_torch.core import compute
from repro_torch.core.compute import ComputePolicy
from repro_torch.data import SyntheticCorpus, make_batch_iterator
from repro_torch.interop import from_jax_params
from repro_torch.launch import train as train_launcher
from repro_torch.models import model as model_mod
from repro_torch.models.model import Model
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, cosine_schedule,
                               linear_warmup)
from repro_torch.runtime.train_loop import ParallelPlan, build_train_step, init_train_state

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,seq_len,batch", [(0, 32, 4), (3, 128, 2)])
def test_batches_equal_reference(seed, seq_len, batch):
    ours = make_batch_iterator(SyntheticCorpus(vocab_size=512, seed=seed),
                               seq_len=seq_len, global_batch=batch)
    ref = jax_batches(JaxCorpus(vocab_size=512, seed=seed), seq_len=seq_len,
                      global_batch=batch)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("arch", ["yi-6b", "gpt-1.4b"])
@pytest.mark.parametrize("backward", [True, False], ids=["train", "forward"])
def test_train_step_flops_equal_reference(arch, backward):
    for cfg_t, cfg_j in ((get_config(arch), jax_get_config(arch)),
                         (dataclasses.replace(get_config(arch), n_layers=8),
                          dataclasses.replace(jax_get_config(arch), n_layers=8))):
        a = costmodel.train_step_flops(cfg_t, 8, 2048, backward=backward)
        b = jax_costmodel.train_step_flops(cfg_j, 8, 2048, backward=backward)
        assert (a.matmul, a.attn, a.scan, a.tokens) == (b.matmul, b.attn, b.scan, b.tokens)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(6, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}


@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "noclip"])
def test_adamw_matches_reference(clip):
    jcfg = JaxAdamW(lr=jax_cosine(1e-2, 2, 5), grad_clip=clip)
    tcfg = AdamWConfig(lr=cosine_schedule(1e-2, 2, 5), grad_clip=clip)
    jp = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    tp = {k: torch.from_numpy(v) for k, v in _tree(0).items()}
    js, ts = jax_adamw_init(jp), adamw_init(tp)
    for i in range(4):
        g = {k: v * 3 for k, v in _tree(i + 1).items()}
        skip = i == 2                                   # an overflowed fp16 step
        jp, js = jax_adamw_update(jcfg, jp, {k: jnp.asarray(v) for k, v in g.items()},
                                  js, skip=jnp.bool_(skip))
        ts = adamw_update(tcfg, tp, {k: torch.from_numpy(v) for k, v in g.items()},
                          ts, skip=skip)
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(ts["nu"][k].numpy(), np.asarray(js["nu"][k]),
                                       rtol=1e-6, atol=1e-9)
        assert ts["count"] == int(js["count"])


def test_schedules_match_reference():
    for ours, ref in ((cosine_schedule(3e-4, 10, 100), jax_cosine(3e-4, 10, 100)),
                      (linear_warmup(1e-3, 7), jax_warmup(1e-3, 7))):
        for step in (0, 1, 5, 10, 11, 50, 100, 150):
            np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6)


def test_loss_scaling_matches_reference():
    js = jax_prec.init_loss_scale(True, 8.0)
    ts = precision.init_loss_scale(True, 8.0)
    for finite in (True, True, False, True, True, True, False):
        js = jax_prec.update_loss_scale(js, jnp.bool_(finite), growth_interval=2)
        ts = precision.update_loss_scale(ts, torch.tensor(finite), growth_interval=2)
        assert float(ts["scale"]) == float(js["scale"])
        assert int(ts["good_steps"]) == int(js["good_steps"])
    off = precision.init_loss_scale(False)
    assert precision.update_loss_scale(off, torch.tensor(False))["scale"] == 1.0
    for name in ("bf16", "fp16", "fp32"):
        ours = precision.policy_from_name(name).compute_dtype
        ref = jax_prec.policy_from_name(name).compute_dtype
        assert str(ours).removeprefix("torch.") == jnp.dtype(ref).name


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_model_loss_and_logits_match_jax(kernels):
    cfg = get_config("yi-6b").reduced()
    jm = JaxModel(jax_get_config("yi-6b").reduced(), jnp.float32,
                  compute=JaxPolicy(kernels=kernels))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = Model(cfg, torch.float32, compute=ComputePolicy(kernels=kernels), device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp), tm))
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    mask = (np.random.RandomState(3).rand(2, 24) > 0.3).astype(np.float32)
    batch_j = {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)}
    batch_t = {"tokens": torch.from_numpy(toks), "loss_mask": torch.from_numpy(mask)}
    lj, _ = jm.loss(jp, batch_j)
    with torch.no_grad():
        lt, metrics = tm.loss(batch_t)
        logits = tm.logits(batch_t)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    assert float(metrics["ce"]) == float(lt)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jm.logits(jp, batch_j)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("field,value", [("node", 2), ("qcomm", "gather"),
                                         ("overlap", True), ("multi_segment", True)])
def test_plan_refuses_what_is_not_ported(field, value):
    """Only multi_segment is refused as not ported, naming ROADMAP; the
    CommPlan's fields run, and are refused only where the reference
    refuses them (qcomm and overlap off ZeRO 3)."""
    if field == "multi_segment":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ParallelPlan(**{field: value})
        return
    kw = {field: value} if field == "node" else {field: value, "zero": 3}
    ours, ref = ParallelPlan(**kw), JaxPlan(**kw)
    assert getattr(ours, field) == getattr(ref, field) == value
    assert ours.n_devices == ref.n_devices
    if field != "node":
        with pytest.raises(ValueError, match="zero=3"):
            ParallelPlan(**{field: value})


@pytest.mark.parametrize("field,value", [("dp", 2), ("tp", 2), ("zero", 1), ("pp", 2),
                                         ("virtual_stages", 2)])
def test_plan_accepts_the_parallel_fields(field, value):
    """dp, tp, pp, virtual_stages and the ZeRO stage are the sharded
    executor's: accepted and resolved as the reference resolves them
    (zero=None is stage 1; at pp > 1 the layer stack goes on "pipe";
    virtual_stages at pp = 1 is accepted and has no effect)."""
    ours, ref = ParallelPlan(**{field: value}), JaxPlan(**{field: value})
    for name in ("dp", "tp", "pp", "virtual_stages", "zero", "n_devices", "n_stages"):
        assert getattr(ours, name) == getattr(ref, name)
    assert ParallelPlan().zero == JaxPlan().zero == 1
    assert dict(ours.sharding_rules().rules) == dict(ref.sharding_rules().rules)


def test_selective_remat_runs_and_fp16_kernels_refused():
    """remat="selective" runs (tests/test_torch_remat.py): the plan takes it
    and its wrapper consults ``save_policy``, which keeps the product, where
    full consults no policy; a remat mode the reference does not have
    raises, as fp16 kernels do."""
    assert ParallelPlan(remat="selective").compute_policy() == ComputePolicy("selective")
    w = torch.ones((4, 4), requires_grad=True)
    policy = compute.save_policy
    for remat, kept in (("selective", 1), ("full", 0)):
        log = []

        def recording(ctx, op, *args, **kwargs):
            decision = policy(ctx, op, *args, **kwargs)
            if not ctx.is_recompute:
                log.append((op, decision))
            return decision
        with mock.patch.object(compute, "save_policy", recording):
            ComputePolicy(remat=remat).checkpoint(lambda x: torch.tanh(x @ w))(
                torch.ones((2, 4), requires_grad=True)).sum().backward()
        assert [op for op, d in log if d == compute.CheckpointPolicy.MUST_SAVE] == \
            [torch.ops.aten.mm.default] * kept
    with pytest.raises(ValueError, match="remat must be one of"):
        ComputePolicy(remat="offload")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ParallelPlan(precision="fp16", kernels=True)


def test_train_step_leaves_the_model_policy_alone(monkeypatch):
    """The plan's policy and compute dtype hold inside the step only: the
    model keeps its own (a step built earlier keeps its plan), and a model
    policy other than the default that the plan overrides is warned about."""
    calls = []
    ce_tokens = model_mod.kernel_ops.cross_entropy_tokens
    monkeypatch.setattr(model_mod.kernel_ops, "cross_entropy_tokens",
                        lambda *a: calls.append(1) or ce_tokens(*a))
    m = Model(get_config("yi-6b").reduced(), torch.float32, device="cpu")
    opt = AdamWConfig(lr=1e-3)
    on = ParallelPlan(precision="bf16", remat="none", kernels=True)
    state = init_train_state(m, opt, on, torch.Generator().manual_seed(0))
    step = build_train_step(m, opt, on)
    build_train_step(m, opt, ParallelPlan(precision="fp32"))
    assert m.compute == ComputePolicy() and m.compute_dtype == torch.float32
    toks = np.random.RandomState(0).randint(0, 512, (2, 16)).astype(np.int32)
    _, metrics = step(state, {"tokens": toks})
    assert calls                                # the CE took the kernels' route
    assert np.isfinite(float(metrics["loss"]))
    m.compute = ComputePolicy(remat="none")
    with pytest.warns(UserWarning, match="the plan wins"):
        build_train_step(m, opt, on)
    assert m.compute == ComputePolicy(remat="none")


def test_full_remat_saves_only_layer_boundaries():
    """remat full keeps fewer tensors alive for the backward than none."""
    saved = {}
    for remat in ("full", "none"):
        m = Model(get_config("yi-6b").reduced(), torch.float32,
                  compute=ComputePolicy(remat=remat), device="cpu")
        m.init(torch.Generator().manual_seed(0)).requires_grad_(True)
        toks = torch.randint(0, 512, (2, 16), generator=torch.Generator().manual_seed(1))
        count = [0]

        def pack(t):
            count[0] += t.numel()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = m.loss({"tokens": toks})
        loss.backward()
        saved[remat] = count[0]
        assert all(p.grad is not None for p in m.parameters())
    assert saved["full"] < saved["none"] / 2


def test_train_launcher_on_cpu(capsys):
    recs = train_launcher.main(["--device", "cpu", "--arch", "yi-6b", "--reduced",
                                "--steps", "3", "--global-batch", "4", "--seq-len", "16",
                                "--gas", "2", "--kernels", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "kernels=True" in out and out.count("grad_norm") == 3
    assert len(recs) == 3 and all(np.isfinite(r["loss"]) for r in recs)
    assert "mfu" not in recs[0]                   # no device metric from a CPU run
