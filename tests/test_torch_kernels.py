"""The port's kernel entry points (CPU tensors -> their plain PyTorch
versions) against the JAX package's Pallas kernels in interpret mode, on the
same numpy inputs.  fp32 throughout."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

# tiny shapes: intra-op threads only add overhead here, and they
# oversubscribe the cores shared by parallel test workers
torch.set_num_threads(1)


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _both(fn_j, fn_t, *arrays, **kw):
    out_j = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **kw))
    out_t = fn_t(*(torch.from_numpy(a) for a in arrays), **kw).numpy()
    return out_j, out_t


@pytest.mark.parametrize("shape", [(8, 64), (2, 7, 256)])
def test_rmsnorm_matches_jax(shape):
    x = _rand(0, *shape)
    w = 1 + _rand(1, shape[-1], scale=0.1)
    out_j, out_t = _both(jops.rmsnorm, tops.rmsnorm, x, w)
    # same fp32 formula, another summation order
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(16, 64, 128), (2, 6, 32, 96)])
def test_swiglu_matches_jax(shape):
    *lead, d, F = shape
    x = _rand(2, *lead, d)
    w1 = _rand(3, d, F, scale=d ** -0.5)
    w3 = _rand(4, d, F, scale=d ** -0.5)
    out_j, out_t = _both(jops.swiglu, tops.swiglu, x, w1, w3)
    assert out_t.shape == (*lead, F)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)


FLASH_CASES = [  # (B, Sq, Skv, Hq, Hkv, hd, kwargs)
    (1, 64, 64, 2, 2, 64, dict(causal=True)),                       # G=1
    (2, 64, 64, 4, 2, 64, dict(causal=True)),                       # G=2
    (1, 64, 128, 4, 2, 32, dict(causal=False)),                     # non-causal, Sq != Skv
    (1, 128, 128, 2, 1, 32, dict(causal=True, sliding_window=24)),  # window
    (1, 64, 64, 2, 1, 64, dict(causal=True, softcap=5.0)),          # softcap
    (2, 32, 128, 4, 2, 32, dict(causal=True, q_offset=96)),         # q_offset, Sq < Skv
    (1, 32, 96, 2, 1, 32, dict(causal=True, sliding_window=16, q_offset=64, softcap=8.0)),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[
    "g1", "g2", "noncausal", "window", "softcap", "q_offset", "window_offset_cap"])
def test_flash_attention_matches_jax(case):
    B, Sq, Skv, Hq, Hkv, hd, kw = case
    q = _rand(5, B, Sq, Hq, hd)
    k = _rand(6, B, Skv, Hkv, hd)
    v = _rand(7, B, Skv, Hkv, hd)
    out_j, out_t = _both(jops.flash_attention, tops.flash_attention, q, k, v, **kw)
    assert out_t.shape == (B, Sq, Hq, hd)
    # the tolerance of tests/test_kernels_flash.py
    np.testing.assert_allclose(out_t, out_j, rtol=2e-5, atol=2e-5)
