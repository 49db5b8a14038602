"""Training the port's moe family against the JAX package, fp32 on the CPU:
llama4-maverick (top-1, shared expert, a dense layer before each MoE layer)
and arctic (top-2, dense residual) reduced as ``.reduced(ep=2)`` reduces
them, weights from the reference's ``Model.init`` carried over by
``interop.from_jax_params``, tokens from a numpy seed.

  * ``Model.loss``: the objective (CE plus ``MOE_AUX_COEF * aux /
    n_layers``), ``ce``, ``moe_aux``, ``moe_drop`` and every leaf's
    gradient against ``jax.value_and_grad`` of the reference's ``loss``;
  * 3 steps of ``build_train_step`` (gas 2) against the reference's
    single-device step: loss, moe_aux, moe_drop and grad norm at each;
  * kernels on (the CPU takes the plain versions of the kernel entries,
    the grouped MLP's Function among them) against off;
  * the one-process pipeline sweep (2 stages of llama4 at 2 MoE units, the
    aux term in each stage's backward) against the gas loop;
  * an expert count ep does not divide raises ``ExpertDivisibilityError``
    when the step or the plan's shardings are built, as the reference's
    ``build_train_step`` does.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamW
from repro.runtime.train_loop import (ParallelPlan as JaxPlan,
                                      build_train_step as jax_build,
                                      init_train_state as jax_init)
from repro_torch.configs import get_config
from repro_torch.core import expertplan
from repro_torch.core import pipeline as pipe
from repro_torch.core import precision as prec
from repro_torch.core.compute import ComputePolicy
from repro_torch.interop import flatten_tree, from_jax_params
from repro_torch.models.model import MOE_AUX_COEF, Model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import pipeline as runner
from repro_torch.runtime.train_loop import (ParallelPlan, build_train_step, init_train_state,
                                            train_state_bytes)

torch.set_num_threads(1)

ARCHS = {"llama4": "llama4-maverick-400b-a17b", "arctic": "arctic-480b"}
TOL = 1e-4          # the port against the reference (XLA and torch sum in other orders)
TOL_KERNELS = 1e-5  # kernels on against off, both the port's
LR = 1e-3


def _pair(name: str, **over):
    arch = ARCHS[name]
    jm = JaxModel(jax_get_config(arch).reduced(ep=2, **over), jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    weights = flatten_tree(jax.tree.map(np.asarray, jp))
    return jm, jp, get_config(arch).reduced(ep=2, **over), weights


def _model(cfg, weights, kernels=False):
    tm = Model(cfg, torch.float32, compute=ComputePolicy(kernels=kernels), device="cpu")
    tm.load_state_dict(from_jax_params(weights, tm))
    return tm


def _tokens(seed: int, vocab: int, B: int = 4, S: int = 32) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_loss_metrics_and_grads_match_jax(name):
    """B 4 x S 32: four routing groups of 32 tokens over 4 experts, where
    capacity 1.25 drops some assignments (moe_drop > 0)."""
    jm, jp, cfg, weights = _pair(name)
    toks = _tokens(0, cfg.vocab_size)
    (lj, mj), gj = jax.value_and_grad(jm.loss, has_aux=True)(jp, {"tokens": jnp.asarray(toks)})
    tm = _model(cfg, weights).requires_grad_(True)
    lt, mt = tm.loss({"tokens": torch.from_numpy(toks)})
    lt.backward()
    lt = lt.detach()
    np.testing.assert_allclose(float(lt), float(lj), rtol=TOL)
    for k in ("ce", "moe_aux", "moe_drop"):
        np.testing.assert_allclose(float(mt[k].detach()), float(mj[k]), rtol=TOL, err_msg=k)
    assert float(mt["moe_drop"]) > 0.0
    np.testing.assert_allclose(float(lt), float(mt["ce"].detach()) + MOE_AUX_COEF
                               * float(mt["moe_aux"].detach()) / cfg.n_layers, rtol=1e-6)
    ref = flatten_tree(jax.tree.map(np.asarray, gj))
    for k, p in tm.named_parameters():
        if p.grad is None:          # the sub-MLPs' "ln" leaves, kept and never applied
            assert k.endswith(".ln.scale") and not ref[k].any(), k
            continue
        scale = max(float(np.abs(ref[k]).max()), 1e-6)
        np.testing.assert_allclose(p.grad.numpy(), ref[k], rtol=TOL, atol=TOL * scale,
                                   err_msg=k)


def _trajectory(step, state, batches) -> np.ndarray:
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append([float(m[k]) for k in ("loss", "moe_aux", "moe_drop", "grad_norm")])
    return np.array(out)


def _batches(vocab: int, n: int = 3) -> list[dict]:
    return [{"tokens": _tokens(10 + i, vocab, 8, 32)} for i in range(n)]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_trajectory_matches_jax_train_step(name):
    """3 steps of global batch 8 x 32 at gas 2, fp32, from the same weights:
    the reference's single-device jitted step and the port's."""
    jm, _, cfg, weights = _pair(name)
    plan = dict(gas=2, precision="fp32")
    jplan, jopt = JaxPlan(**plan), JaxAdamW(lr=LR)
    state = jax_init(jm, jax.random.PRNGKey(0), jopt, jplan)
    jstep = jax.jit(jax_build(jm, jopt, jplan))
    ref = []
    for b in _batches(cfg.vocab_size):
        state, m = jstep(state, {"tokens": jnp.asarray(b["tokens"])})
        ref.append([float(m[k]) for k in ("loss", "moe_aux", "moe_drop", "grad_norm")])
    tm = _model(cfg, weights)
    opt, p = AdamWConfig(lr=LR), ParallelPlan(**plan)
    ours = _trajectory(build_train_step(tm, opt, p), init_train_state(tm, opt, p),
                       _batches(cfg.vocab_size))
    np.testing.assert_allclose(ours, np.array(ref), rtol=TOL, atol=1e-7)
    assert (ours[:, 2] > 0).all()


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_kernels_on_matches_off(name):
    """The kernel entries' plain versions (the grouped MLP through its
    Function, forward and fp32 recompute backward; rmsnorm, swiglu, flash
    and CE) against the plain layers, 3 steps at gas 2."""
    _, _, cfg, weights = _pair(name)
    runs = []
    for kernels in (False, True):
        tm = _model(cfg, weights)
        opt, p = AdamWConfig(lr=LR), ParallelPlan(gas=2, precision="fp32", kernels=kernels)
        runs.append(_trajectory(build_train_step(tm, opt, p), init_train_state(tm, opt, p),
                                _batches(cfg.vocab_size)))
    np.testing.assert_allclose(runs[1], runs[0], rtol=TOL_KERNELS, atol=1e-8)


def test_pipeline_sweep_is_the_gas_loop():
    """llama4 at 4 layers (2 MoE units) split into 2 logical stages, 2
    microbatches, one process: the sweep's gradients (each stage's aux term
    in its own backward) and its CE, aux and drop sums equal the gas loop's
    over ``Model.loss``."""
    _, _, cfg, weights = _pair("llama4", n_layers=4)
    toks = torch.from_numpy(_tokens(3, cfg.vocab_size, 4, 16))
    micro = [{"tokens": toks[:2]}, {"tokens": toks[2:]}]
    model = _model(cfg, weights).requires_grad_(True)
    ls = prec.init_loss_scale(False)
    count = runner.loss_count({"tokens": toks}, torch.device("cpu"))
    sums = {k: torch.zeros(()) for k in ("aux", "moe_drop")}
    ce = runner.sweep(model, pipe.schedule(2, 2), micro, count, ls, None, sums)
    swept = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    ce_loop, aux, drop = 0.0, 0.0, 0.0
    for mb in micro:
        loss, m = model.loss(mb)
        (loss / 2).backward()
        ce_loop, aux, drop = ce_loop + float(m["ce"]) / 2, aux + float(m["moe_aux"]), \
            drop + float(m["moe_drop"])
    np.testing.assert_allclose(float(ce), ce_loop, rtol=1e-5)
    np.testing.assert_allclose(float(sums["aux"]), aux, rtol=1e-5)
    np.testing.assert_allclose(float(sums["moe_drop"]), drop, rtol=1e-6)
    assert swept.keys() == {k for k, p in model.named_parameters() if p.grad is not None}
    for k, p in model.named_parameters():
        if k in swept:
            np.testing.assert_allclose(swept[k].numpy(), p.grad.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("ep", [3, 8])
def test_indivisible_experts_raise(ep):
    """Reduced arctic has 4 experts: ep 3 and 8 do not divide them."""
    cfg = get_config(ARCHS["arctic"]).reduced()
    plan = ParallelPlan(ep=ep, precision="fp32")
    assert plan.n_devices == ep and plan.expert_plan().ep == ep
    with pytest.raises(expertplan.ExpertDivisibilityError, match="not divisible"):
        build_train_step(Model(cfg, torch.float32, device="cpu"), AdamWConfig(lr=LR), plan)
    with pytest.raises(expertplan.ExpertDivisibilityError):
        train_state_bytes(cfg, plan)
