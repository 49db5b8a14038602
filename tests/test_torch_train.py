"""The port's single-device train step against the JAX package's
``runtime/train_loop.py:build_train_step`` (no mesh, jitted), fp32, over 6
steps from the same weights (``interop.from_jax_params``) and the same
batches (the port's ``data/synthetic.py``, which the reference's iterator
reproduces; see tests/test_torch_train_parts.py).  yi-6b reduced with
kernels on and off (on the CPU the port's kernels take their plain versions
and its autograd Functions' plain backwards), remat full and none, gas 1
and 2; gpt-1.4b reduced with kernels off, and with kernels on at its head
dim 88 (remat full, gas 2).  Losses and grad norms agree
within 1e-4 relative, the tolerance tests/test_torch_model.py uses across
XLA and torch; the largest drift measured over the 6 steps is 5.9e-7."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamW, cosine_schedule as jax_cosine
from repro.runtime.train_loop import (ParallelPlan as JaxPlan,
                                      build_train_step as jax_build,
                                      init_train_state as jax_init)
from repro_torch.configs import get_config
from repro_torch.data import SyntheticCorpus, make_batch_iterator
from repro_torch.interop import from_jax_params
from repro_torch.kernels import ops
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.runtime.train_loop import ParallelPlan, build_train_step, init_train_state

# tiny shapes: intra-op threads only add overhead here, and they
# oversubscribe the cores shared by parallel test workers
torch.set_num_threads(1)

STEPS, SEQ, BATCH = 6, 32, 4
RTOL = 1e-4


def trajectories(arch, *, kernels, remat, gas, **overrides):
    """(reference, port) lists of (loss, grad_norm) over STEPS steps of the
    arch's ``.reduced(**overrides)`` config."""
    plan = dict(gas=gas, precision="fp32", remat=remat, kernels=kernels)
    jm = JaxModel(jax_get_config(arch).reduced(**overrides), jnp.float32)
    jplan = JaxPlan(**plan)
    jopt = JaxAdamW(lr=jax_cosine(1e-3, 2, STEPS))
    jstate = jax_init(jm, jax.random.PRNGKey(0), jopt, jplan)
    jstep = jax.jit(jax_build(jm, jopt, jplan))

    tm = Model(get_config(arch).reduced(**overrides), torch.float32, device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jstate["params"]), tm))
    topt = AdamWConfig(lr=cosine_schedule(1e-3, 2, STEPS))
    tplan = ParallelPlan(**plan)
    tstate = init_train_state(tm, topt, tplan)
    tstep = build_train_step(tm, topt, tplan)

    it = make_batch_iterator(SyntheticCorpus(vocab_size=tm.cfg.vocab_size, seed=0),
                             seq_len=SEQ, global_batch=BATCH, prefetch=0)
    ref, port = [], []
    ops.reset_launch_counts()
    for _ in range(STEPS):
        batch = next(it)
        jstate, jm_ = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        tstate, tm_ = tstep(tstate, batch)
        ref.append((float(jm_["loss"]), float(jm_["grad_norm"])))
        port.append((float(tm_["loss"]), float(tm_["grad_norm"])))
    assert set(ops.launch_counts().values()) == {0}      # CPU: plain versions only
    assert tstate["step"] == STEPS and tstate["opt"]["count"] == STEPS
    return np.array(ref), np.array(port)


@pytest.mark.parametrize("gas", [1, 2], ids=["gas1", "gas2"])
@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_yi_train_step_matches_jax(kernels, remat, gas):
    ref, port = trajectories("yi-6b", kernels=kernels, remat=remat, gas=gas)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=0)
    assert port[-1, 0] < port[0, 0]                      # it learns


@pytest.mark.parametrize("remat,gas", [("full", 1), ("none", 2)], ids=["full_gas1", "none_gas2"])
def test_gpt_train_step_matches_jax(remat, gas):
    ref, port = trajectories("gpt-1.4b", kernels=False, remat=remat, gas=gas)
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=0)


def test_gpt_hd88_kernels_train_step_matches_jax():
    """gpt-1.4b reduced at head dim 88 (d 176 over 2 heads) with kernels on:
    the LayerNorm and GELU-MLP Functions and the hd-88 flash path, forward
    and backward, against the reference's kernels=True step."""
    ref, port = trajectories("gpt-1.4b", kernels=True, remat="full", gas=2,
                             d_model=176, n_heads=2, head_dim=88)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=0)
    assert port[-1, 0] < port[0, 0]
