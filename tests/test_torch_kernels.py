"""The port's kernel entry points (CPU tensors -> their plain PyTorch
versions) against the JAX package's Pallas kernels in interpret mode, on the
same numpy inputs, forward and (through each ``torch.autograd.Function``)
backward against ``jax.vjp``; and the plain versions that the card's
kernels are held against, against float64 oracles.  fp32 throughout.  The
flash cases include head dim 88, gpt-1.4b's (d 2112 over 24 heads)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

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
    (2, 64, 64, 2, 2, 88, dict(causal=True)),                       # gpt-1.4b's hd
    (1, 40, 56, 2, 2, 88, dict(causal=False)),                      # hd 88, ragged
    (1, 32, 96, 2, 2, 88, dict(causal=True, q_offset=64)),          # hd 88, q_offset
]
FLASH_IDS = ["g1", "g2", "noncausal", "window", "softcap", "q_offset", "window_offset_cap",
             "hd88", "hd88_noncausal_ragged", "hd88_q_offset"]


@pytest.mark.parametrize("case", FLASH_CASES, ids=FLASH_IDS)
def test_flash_attention_matches_jax(case):
    B, Sq, Skv, Hq, Hkv, hd, kw = case
    q = _rand(5, B, Sq, Hq, hd)
    k = _rand(6, B, Skv, Hkv, hd)
    v = _rand(7, B, Skv, Hkv, hd)
    out_j, out_t = _both(jops.flash_attention, tops.flash_attention, q, k, v, **kw)
    assert out_t.shape == (B, Sq, Hq, hd)
    # the tolerance of tests/test_kernels_flash.py
    np.testing.assert_allclose(out_t, out_j, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# Gradients: each autograd Function (CPU: plain forward, plain backward) held
# against jax.vjp of the reference entry (interpret mode), fp32.
# ---------------------------------------------------------------------------

def _vjp_both(fn_j, fn_t, arrays, cot, **kw):
    """(jax grads, torch grads, torch output) for the cotangent ``cot``."""
    out_j, vjp = jax.vjp(lambda *a: fn_j(*a, **kw), *(jnp.asarray(a) for a in arrays))
    grads_j = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out_t = fn_t(*ts, **kw)
    grads_t = torch.autograd.grad(out_t, ts, torch.from_numpy(cot))
    return grads_j, [g.numpy() for g in grads_t], out_t


@pytest.mark.parametrize("case", FLASH_CASES, ids=FLASH_IDS)
def test_flash_attention_grads_match_jax(case):
    B, Sq, Skv, Hq, Hkv, hd, kw = case
    arrays = [_rand(5, B, Sq, Hq, hd), _rand(6, B, Skv, Hkv, hd), _rand(7, B, Skv, Hkv, hd)]
    gj, gt, out = _vjp_both(jops.flash_attention, tops.flash_attention, arrays,
                            _rand(8, B, Sq, Hq, hd), **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    # the gradient tolerances of tests/test_kernels_flash.py (2e-4, 3e-4 with softcap)
    tol = 3e-4 if "softcap" in kw else 2e-4
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(8, 64), (2, 7, 256)])
def test_rmsnorm_grads_match_jax(shape):
    arrays = [_rand(0, *shape), 1 + _rand(1, shape[-1], scale=0.1)]
    gj, gt, out = _vjp_both(jops.rmsnorm, tops.rmsnorm, arrays, _rand(2, *shape))
    assert type(out.grad_fn).__name__ == "RMSNormBackward"
    for a, b in zip(gt, gj):       # tests/test_kernels_rmsnorm.py's grad tolerance
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(16, 64, 128), (2, 6, 32, 96)])
def test_swiglu_grads_match_jax(shape):
    *lead, d, F = shape
    arrays = [_rand(2, *lead, d), _rand(3, d, F, scale=d ** -0.5),
              _rand(4, d, F, scale=d ** -0.5)]
    gj, gt, out = _vjp_both(jops.swiglu, tops.swiglu, arrays, _rand(5, *lead, F))
    assert type(out.grad_fn).__name__ == "ViewBackward0"   # reshape of the Function
    # fp32 recompute in both; d-long sums in another order
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(8, 64), (2, 7, 176)])
def test_layernorm_and_grads_match_jax(shape):
    x = _rand(13, *shape) + 0.3               # off-zero mean, as in the reference's test
    arrays = [x, 1 + _rand(14, shape[-1], scale=0.1), _rand(15, shape[-1], scale=0.1)]
    gj, gt, out = _vjp_both(jops.layernorm, tops.layernorm, arrays, _rand(16, *shape))
    assert type(out.grad_fn).__name__ == "LayerNormBackward"
    # tests/test_kernels_layernorm.py's tolerances: 1e-5 forward, 1e-4/1e-5 grads
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jops.layernorm(*map(jnp.asarray, arrays))),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(16, 64, 128), (2, 6, 176, 96)])
def test_gelu_mlp_in_and_grads_match_jax(shape):
    *lead, d, F = shape
    arrays = [_rand(17, *lead, d), _rand(18, d, F, scale=d ** -0.5)]
    gj, gt, out = _vjp_both(jops.gelu_mlp_in, tops.gelu_mlp_in, arrays, _rand(19, *lead, F))
    assert out.shape == (*lead, F)
    assert type(out.grad_fn).__name__ == "ViewBackward0"   # reshape of the Function
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jops.gelu_mlp_in(*map(jnp.asarray, arrays))),
                               rtol=1e-5, atol=1e-5)
    # tests/test_kernels_layernorm.py's gelu grad tolerance; fp32 recompute in both
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


CE_CASES = [  # (N, d, V, valid_vocab)
    (64, 32, 256, None),
    (60, 64, 200, 197),      # ragged N and V, padded vocab columns masked
]


@pytest.mark.parametrize("case", CE_CASES, ids=["plain", "valid_vocab"])
def test_cross_entropy_tokens_and_grads_match_jax(case):
    N, d, V, vv = case
    h, w = _rand(9, N, d, scale=0.5), _rand(10, d, V, scale=0.1)
    labels = np.random.RandomState(11).randint(0, vv or V, N).astype(np.int32)
    labels[-1] = (vv or V) - 1                       # a label in the last column
    fj = lambda h, w, **kw: jops.cross_entropy_tokens(h, w, jnp.asarray(labels), vv)  # noqa: E731
    ft = lambda h, w, **kw: tops.cross_entropy_tokens(  # noqa: E731
        h, w, torch.from_numpy(labels), vv)
    gj, gt, out = _vjp_both(fj, ft, [h, w], _rand(12, N))
    assert type(out.grad_fn).__name__ == "CrossEntropyTokensBackward"
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(fj(jnp.asarray(h), jnp.asarray(w))),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(gt, gj):       # tests/test_kernels_ce.py's fp32 tolerance
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    mean_t = tops.cross_entropy(torch.from_numpy(h), torch.from_numpy(w),
                                torch.from_numpy(labels), vv)
    np.testing.assert_allclose(float(mean_t), float(jref.cross_entropy_ref(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), vv)), rtol=1e-5)


# ---------------------------------------------------------------------------
# The plain versions the card's kernels are held against, in the flavours of
# chip_smoke.py's kernel phase: flash_attention_bwd_ref against autograd of
# flash_attention_ref in float64, cross_entropy_ref against materialized
# float64 logits.
# ---------------------------------------------------------------------------

BWD_CASES = [  # chip_smoke.py's small flavours, at smaller sizes
    (2, 48, 48, 4, 2, 64, dict(causal=True, sliding_window=16)),
    (1, 40, 40, 4, 4, 64, dict(causal=True, softcap=30.0)),
    (2, 16, 48, 8, 2, 64, dict(causal=True, q_offset=32)),
    (1, 20, 36, 4, 2, 64, dict(causal=False)),
    (1, 32, 32, 4, 4, 64, dict(causal=True)),
    (1, 34, 34, 8, 1, 64, dict(causal=True)),
    (1, 24, 40, 4, 2, 64, dict(causal=True, sliding_window=12, q_offset=16, softcap=20.0)),
    (1, 20, 36, 2, 2, 88, dict(causal=False)),
]


@pytest.mark.parametrize("case", BWD_CASES, ids=[
    "window", "softcap", "q_offset", "noncausal_ragged", "g1", "g8", "window_offset_cap",
    "hd88_noncausal_ragged"])
def test_flash_attention_bwd_ref_matches_autograd(case):
    B, Sq, Skv, Hq, Hkv, hd, kw = case
    q, k, v = (torch.from_numpy(a).double().requires_grad_() for a in (
        _rand(1, B, Hq, Sq, hd), _rand(2, B, Hkv, Skv, hd), _rand(3, B, Hkv, Skv, hd)))
    do = torch.from_numpy(_rand(4, B, Hq, Sq, hd)).double()
    o, lse = tref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    want = torch.autograd.grad(o, (q, k, v), do)
    got, scales, cancel = tref.flash_attention_bwd_ref(
        q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(), do,
        return_scales=True, **kw)
    for g, w, s in zip(got, want, scales):
        assert g.shape == w.shape == s.shape
        # fp32 inside the plain version; float64 autograd as the oracle
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)
        assert (s >= g.abs() - 1e-5).all()        # |grad| <= its error scale
    for g, c, s in zip(got, cancel, scales):      # dq, dk: C bounds |dS| too
        assert g.shape == c.shape and (c >= s - 1e-5).all()


@pytest.mark.parametrize("N,d,V,vv", [(37, 32, 200, 197), (64, 16, 1000, None)],
                         ids=["ragged_valid_vocab", "plain"])
def test_cross_entropy_ref_matches_float64(N, d, V, vv):
    h, w = _rand(5, N, d), _rand(6, d, V, scale=0.2)
    labels = torch.from_numpy(np.random.RandomState(7).randint(0, vv or V, N))
    labels[0] = (vv or V) - 1
    lse, ll = tref.cross_entropy_ref(torch.from_numpy(h), torch.from_numpy(w), labels, vv)
    logits = torch.from_numpy(h).double() @ torch.from_numpy(w).double()
    if vv:
        logits = logits[:, :vv]
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(logits, -1).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ll.numpy(), logits[torch.arange(N), labels].numpy(),
                               rtol=1e-5, atol=1e-5)
