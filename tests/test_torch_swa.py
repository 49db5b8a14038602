"""The sliding-window ring cache in the port against the JAX package:
h2o-danube-1.8b reduced (window 16), fp32, weights from the reference
(``interop.from_jax_params``), kernels off and on.  Prefill logits and the
ring cache (a prompt longer than the window, with and without ``lens``),
a ring decode far past the window (the reference's
``test_swa_ring_buffer_long_decode``: each step against the JAX decode step
and the full-sequence logits), the slot-swap engine's tokens against greedy
decoding, and the loss and every gradient at a sequence longer than the
window."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.compute import ComputePolicy as JaxPolicy
from repro.models.model import Model as JaxModel
from repro.runtime.serve_loop import greedy_generate as jax_greedy_generate
from repro_torch.configs import get_config
from repro_torch.core.compute import ComputePolicy
from repro_torch.interop import flatten_tree, from_jax_params
from repro_torch.models.model import Model
from repro_torch.runtime.serve_engine import Request, ServeEngine
from repro_torch.runtime.serve_loop import greedy_generate

torch.set_num_threads(1)

ARCH = "h2o-danube-1.8b"
# XLA-CPU and torch-CPU order their matmul sums differently, across 2 layers
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_LEN = 64


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "kernels"])
def danube(request):
    kernels = request.param
    jm = JaxModel(jax_get_config(ARCH).reduced(), jnp.float32,
                  compute=JaxPolicy(kernels=kernels))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH).reduced(), torch.float32,
               compute=ComputePolicy(kernels=kernels), device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp), tm))
    assert tm.cfg.sliding_window == 16
    return jm, jp, tm


def _tokens(seed, shape, vocab):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


def _close(jax_arr, torch_t, **tol):
    np.testing.assert_allclose(torch_t.numpy(), np.asarray(jax_arr), **(tol or TOL))


@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
def test_prefill_ring_matches_jax(danube, with_lens):
    """A 24-token prompt (and right-padded ones of 11 and 24) into a
    64-position cache: the ring holds the last 16 positions, slot t % 16."""
    jm, jp, tm = danube
    toks = _tokens(0, (2, 24), tm.cfg.vocab_size)
    lens = np.array([11, 24], np.int32) if with_lens else None
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, CACHE_LEN,
                        lens=None if lens is None else jnp.asarray(lens))
    lt, ct = tm.prefill({"tokens": torch.from_numpy(toks)}, CACHE_LEN,
                        lens=None if lens is None else torch.from_numpy(lens))
    assert ct["layers"]["k"].shape[2] == 16
    _close(lj, lt)
    for name in ("k", "v"):
        _close(cj["layers"][name], ct["layers"][name])
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))


def test_ring_decode_far_past_window(danube):
    """A 10-token prompt, then 40 decode steps (the ring wraps 3 times):
    every step's logits and the final ring against the JAX decode step at
    1e-4, and against the full-sequence logits at the reference's 2e-3."""
    jm, jp, tm = danube
    S, n = 10, 40
    toks = _tokens(1, (2, S + n), tm.cfg.vocab_size)
    _, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, CACHE_LEN)
    _, ct = tm.prefill({"tokens": torch.from_numpy(toks[:, :S])}, CACHE_LEN)
    with torch.no_grad():
        full = tm.logits({"tokens": torch.from_numpy(toks)})
    step = jax.jit(jm.decode_step)
    for t in range(S, S + n):
        tok = toks[:, t:t + 1]
        lj, cj = step(jp, cj, {"token": jnp.asarray(tok)})
        lt, ct = tm.decode_step(ct, {"token": torch.from_numpy(tok)})
        _close(lj, lt)
        np.testing.assert_allclose(lt.numpy(), full[:, t].numpy(), rtol=2e-3, atol=2e-3)
    assert int(ct["pos"]) == S + n
    for name in ("k", "v"):
        _close(cj["layers"][name], ct["layers"][name])


def test_engine_ring_matches_greedy(danube):
    """Three requests over two slots of 16-position rings, prompts shorter
    and longer than the window (bucketed prefill with ``lens``): each
    request's tokens equal its greedy stream, and request 0's the JAX
    package's greedy stream."""
    jm, jp, tm = danube
    prompts = [_tokens(10 + i, n, tm.cfg.vocab_size) for i, n in enumerate((21, 9, 30))]
    refs = [greedy_generate(tm, torch.from_numpy(p)[None], 12, CACHE_LEN)[0].numpy()
            for p in prompts]
    eng = ServeEngine(tm, n_slots=2, cache_len=CACHE_LEN, block_size=4)
    assert not eng.paged and eng.cache["layers"]["k"].shape[2] == 16
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=12)
                   for i, p in enumerate(prompts)])
    for i in range(3):
        np.testing.assert_array_equal(out[i], refs[i])
    ref0 = np.asarray(jax_greedy_generate(jm, jp, jnp.asarray(prompts[0])[None], 12,
                                          CACHE_LEN))[0]
    np.testing.assert_array_equal(out[0], ref0)
    with pytest.raises(ValueError, match="fixed-size cache"):
        tm.paged_cache_specs(2, 9, 4)


def test_loss_and_grads_match_jax(danube):
    """Training at 40 tokens (past the window of 16): the loss and the
    gradient of every leaf against ``jax.grad`` of the JAX ``Model.loss``."""
    jm, jp, tm = danube
    toks = _tokens(3, (2, 40), tm.cfg.vocab_size)
    lj, gj = jax.value_and_grad(lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)})[0])(jp)
    tm.requires_grad_(True)
    tm.zero_grad(set_to_none=True)
    lt, _ = tm.loss({"tokens": torch.from_numpy(toks)})
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    gj = flatten_tree(jax.tree.map(np.asarray, gj))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gj[name], err_msg=name, **TOL)
    tm.requires_grad_(False)
    tm.zero_grad(set_to_none=True)
