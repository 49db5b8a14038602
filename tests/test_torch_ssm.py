"""The port's mamba2 pieces against the JAX package on the same numpy-seeded
inputs: the SSD scan Function (on the CPU its plain version and its
autograd recompute) against ``repro.kernels.ops.ssd_scan`` (Pallas, in
interpret mode) and ``ref.ssd_scan_ref``, forward at 2e-5 and the gradients
of sum(y^2) + sum(S^2) at 3e-4 (the tolerances of
tests/test_kernels_scan.py); the decode step against ``ref.mamba_decode_ref``
at 1e-6, also at the kernel's widths (P = N = 64, K = 4) against the JAX
``mamba_decode_step``; the in-place decode forms' slot masking bit for bit
and ``_masked_copy``'s skip of an in-place leaf; the ``tiling`` copy against the original; ``mamba_block``,
``mamba_prefill`` and ``mamba_decode`` against their JAX twins at 1e-5
(fp32, kernels on and off); and the hybrid ``train_step_flops`` against the
reference's cost model.  The kernel's staged form (``ssd_scan_staged``)
against the same references at chunks 1 to 128."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import costmodel as jax_costmodel
from repro.core.compute import ComputePolicy as JaxPolicy
from repro.kernels import ops as jax_ops, ref as jax_ref, tiling as jax_tiling
from repro.models import ssm as jax_ssm
from repro.models.common import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.core import costmodel
from repro_torch.core.compute import ComputePolicy
from repro_torch.kernels import ops, ssd_scan as ssd, tiling
from repro_torch.kernels.ref import mamba_decode_ref, mamba_decode_ref_
from repro_torch.models import ssm
from repro_torch.models.model import _masked_copy

# tiny shapes: intra-op threads only add overhead here, and they
# oversubscribe the cores shared by parallel test workers
torch.set_num_threads(1)


def _ssd_inputs(seed, B=2, T=32, H=3, P=8, N=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, T, H))).astype(np.float32)   # softplus
    Bm = rng.randn(B, T, N).astype(np.float32)
    Cm = rng.randn(B, T, N).astype(np.float32)
    A_log = (0.3 * rng.randn(H)).astype(np.float32)
    return x, dt, Bm, Cm, A_log


def _sq_loss(y, S):
    return (y ** 2).sum() + (S ** 2).sum()


@pytest.mark.parametrize("chunk", [1, 4, 8, 32])
def test_ssd_scan_matches_jax(chunk):
    arrays = _ssd_inputs(chunk)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, S = ops.ssd_scan(*ts, chunk=chunk)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    js = [jnp.asarray(a) for a in arrays]
    yk, Sk = jax_ops.ssd_scan(*js, chunk=chunk)                # interpret mode
    yr, Sr = jax_ref.ssd_scan_ref(*js, chunk=chunk)
    for ref_y, ref_S in ((yk, Sk), (yr, Sr)):
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(S.detach().numpy(), np.asarray(ref_S), rtol=2e-5, atol=2e-5)
    _sq_loss(y, S).backward()
    gk = jax.grad(lambda *a: _sq_loss(*jax_ops.ssd_scan(*a, chunk=chunk)),
                  argnums=tuple(range(5)))(*js)
    for t, g in zip(ts, gk):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("chunk,T", [(1, 32), (4, 32), (8, 32), (32, 64), (128, 128)])
def test_ssd_scan_staged_matches_jax(chunk, T):
    """``ssd_scan_staged``, the kernel's three passes (the chunk-local states,
    the carry in chunk order, the read-out) in plain torch, against the JAX
    package's ``ops.ssd_scan`` (Pallas, interpret mode) and
    ``ref.ssd_scan_ref`` at 2e-5."""
    arrays = _ssd_inputs(100 + chunk, T=T)
    y, S = ssd.ssd_scan_staged(*(torch.from_numpy(a) for a in arrays), chunk=chunk)
    js = [jnp.asarray(a) for a in arrays]
    for ref_y, ref_S in (jax_ops.ssd_scan(*js, chunk=chunk),
                         jax_ref.ssd_scan_ref(*js, chunk=chunk)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(S.numpy(), np.asarray(ref_S), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("T,chunk", [(32, 3), (32, 64), (24, 16), (256, 256)])
def test_ssd_scan_refuses_bad_chunk(T, chunk):
    x, dt, Bm, Cm, A_log = (torch.from_numpy(a) for a in _ssd_inputs(0, T=T))
    with pytest.raises(ValueError, match="chunk"):
        ssd.ssd_scan(x, dt, Bm, Cm, A_log, chunk=chunk)


def _decode_inputs(seed, B=2, K=4, H=3, P=4, N=8):
    rng = np.random.RandomState(seed)
    ch = H * P + 2 * N
    return dict(
        window=rng.randn(B, K, ch).astype(np.float32),
        conv_w=(0.5 * rng.randn(K, ch)).astype(np.float32),
        conv_b=(0.1 * rng.randn(ch)).astype(np.float32),
        dt_raw=rng.randn(B, H).astype(np.float32),
        dt_bias=(0.1 * rng.randn(H)).astype(np.float32),
        A_log=(0.5 * rng.randn(H)).astype(np.float32),
        D=rng.randn(H).astype(np.float32),
        state=rng.randn(B, H, P, N).astype(np.float32)), dict(n_heads=H, head_dim=P)


def test_mamba_decode_step_matches_jax():
    arrays, dims = _decode_inputs(5)
    ts = {k: torch.from_numpy(a) for k, a in arrays.items()}
    before = ts["state"].clone()
    y, S = ops.mamba_decode_step(**ts, **dims)
    assert torch.equal(ts["state"], before)             # a fresh state tensor
    js = {k: jnp.asarray(a) for k, a in arrays.items()}
    yr, Sr = jax_ref.mamba_decode_ref(**js, **dims)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sr), rtol=1e-6, atol=1e-6)
    yk, Sk = jax_ops.mamba_decode_step(**js, **dims)    # interpret mode
    np.testing.assert_allclose(y.numpy(), np.asarray(yk), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sk), rtol=1e-6, atol=1e-6)


def test_mamba_decode_step_at_kernel_widths_matches_jax():
    """The kernel's own widths (P = N = 64, K = 4) at 4 slots and 3 heads:
    ``ops.mamba_decode_step`` against the JAX package's ``mamba_decode_step``
    (interpret mode) and ``ref.mamba_decode_ref`` at 1e-6, y's absolute part
    scaled by sqrt(N / 8): y_p is an N-term fp32 sum of O(1) terms, whose
    rounding in another summation order grows as sqrt(N) (the 1e-6 of
    ``test_mamba_decode_step_matches_jax`` is at N = 8; here the two
    packages differ by up to 1.7e-6 on y, and by less than 1e-6 on the
    state, an elementwise update)."""
    arrays, dims = _decode_inputs(7, B=4, K=4, H=3, P=64, N=64)
    ts = {k: torch.from_numpy(a) for k, a in arrays.items()}
    y, S = ops.mamba_decode_step(**ts, **dims)
    js = {k: jnp.asarray(a) for k, a in arrays.items()}
    for ref_y, ref_S in (jax_ops.mamba_decode_step(**js, **dims),
                         jax_ref.mamba_decode_ref(**js, **dims)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=1e-6,
                                   atol=1e-6 * (64 / 8) ** 0.5)
        np.testing.assert_allclose(S.numpy(), np.asarray(ref_S), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("entry", ["ops", "ref"])
def test_mamba_decode_in_place_masks_slots(entry):
    """The in-place form with slots 1 and 3 inactive: y equals the pure
    form's, the active slots' rows its new state and the inactive slots'
    rows the state before, bit for bit; the tensor is the one passed in.
    With ``active`` None every row takes the new state."""
    arrays, dims = _decode_inputs(8, B=4, K=4, H=3, P=64, N=64)
    ts = {k: torch.from_numpy(a) for k, a in arrays.items()}
    step_ = ops.mamba_decode_step_ if entry == "ops" else mamba_decode_ref_
    y_pure, S_pure = mamba_decode_ref(**ts, **dims)
    active = torch.tensor([True, False, True, False])
    state = ts["state"].clone()
    ptr = state.data_ptr()
    y = step_(**dict(ts, state=state), active=active, **dims)
    assert state.data_ptr() == ptr
    assert torch.equal(y, y_pure)
    assert torch.equal(state[active], S_pure[active])
    assert torch.equal(state[~active], ts["state"][~active])
    state = ts["state"].clone()
    assert torch.equal(step_(**dict(ts, state=state), active=None, **dims), y_pure)
    assert torch.equal(state, S_pure)


def test_masked_copy_leaves_in_place_leaf():
    """``_masked_copy`` skips a leaf that is the cache's own tensor (a state
    its step updated in place) and still freezes the inactive rows of the
    others."""
    rng = np.random.RandomState(9)
    conv, state = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   for shape in ((4, 3, 8), (4, 2, 4, 4)))
    cache = {"conv": conv.clone(), "state": state.clone()}
    new_conv = torch.from_numpy(rng.randn(4, 3, 8).astype(np.float32))
    active = torch.tensor([True, False, True, True])
    cache["state"][active] += 1.0                 # what its step wrote in place
    written = cache["state"].clone()
    _masked_copy(cache, {"conv": new_conv, "state": cache["state"]}, active)
    assert torch.equal(cache["state"], written)
    assert torch.equal(cache["conv"][active], new_conv[active])
    assert torch.equal(cache["conv"][~active], conv[~active])


def test_mamba_decode_bf16_rounding_chain():
    """In bf16 the plain decode runs the conv in the window's dtype: the
    product (fp32 sums) rounded, the bias add rounded and silu rounded, then
    the state algebra in fp32; the chain the CUDA kernel reproduces."""
    arrays, dims = _decode_inputs(6)
    ts = {k: torch.from_numpy(a) for k, a in arrays.items()}
    bf = {k: (t if k == "state" else t.bfloat16()) for k, t in ts.items()}
    y, S = mamba_decode_ref(**bf, **dims)
    conv = (bf["window"].float() * bf["conv_w"].float()).sum(1).bfloat16()
    conv = torch.nn.functional.silu((conv + bf["conv_b"]).float()).bfloat16()
    H, P = dims["n_heads"], dims["head_dim"]
    N = S.shape[-1]
    xin, Bm, Cm = conv.float().split([H * P, N, N], dim=-1)
    dt = torch.nn.functional.softplus(bf["dt_raw"].float() + bf["dt_bias"].float())
    a = torch.exp(dt * -torch.exp(bf["A_log"].float()))
    xh = xin.reshape(-1, H, P)
    S_ref = (a[:, :, None, None] * bf["state"]
             + dt[:, :, None, None] * xh[..., None] * Bm[:, None, None, :])
    y_ref = (S_ref * Cm[:, None, None, :]).sum(-1) + bf["D"].float()[None, :, None] * xh
    np.testing.assert_allclose(S.numpy(), S_ref.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-6, atol=1e-5)


def test_tiling_matches_reference():
    for T in range(1, 301):
        for target in (tiling.SSD_CHUNK, tiling.WKV_CHUNK):
            assert tiling.pick_chunk(T, target) == jax_tiling.pick_chunk(T, target)
        assert tiling.fit_block(128, T) == jax_tiling.fit_block(128, T)
    assert (tiling.SSD_CHUNK, tiling.WKV_CHUNK) == (jax_tiling.SSD_CHUNK, jax_tiling.WKV_CHUNK)


def _layer_pair(seed):
    """One mamba layer's weights from the JAX init, as numpy and as torch."""
    jcfg = jax_get_config("zamba2-2.7b").reduced()
    cfg = get_config("zamba2-2.7b").reduced()
    jp = jax_init_params(jax_ssm.mamba_specs(jcfg), jax.random.PRNGKey(seed))
    # non-trivial decay, skip and bias values than the init's
    rng = np.random.RandomState(seed)
    H = jp["A_log"].shape[0]
    jp = dict(jp, dt_bias=jnp.asarray(0.3 * rng.randn(H), jnp.float32),
              D=jnp.asarray(rng.randn(H), jnp.float32),
              conv_b=jnp.asarray(0.1 * rng.randn(*jp["conv_b"].shape), jnp.float32))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_mamba_layers_match_jax(kernels):
    jcfg, cfg, jp, tp = _layer_pair(3)
    jpol, pol = JaxPolicy(kernels=kernels), ComputePolicy(kernels=kernels)
    x = np.random.RandomState(4).randn(2, 24, cfg.d_model).astype(np.float32)
    out = ssm.mamba_block(tp, torch.from_numpy(x), cfg, policy=pol)
    ref = jax_ssm.mamba_block(jp, jnp.asarray(x), jcfg, policy=jpol)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    out, cache = ssm.mamba_prefill(tp, torch.from_numpy(x), cfg, policy=pol)
    ref, jcache = jax_ssm.mamba_prefill(jp, jnp.asarray(x), jcfg, policy=jpol)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for name in ("conv", "state"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=1e-5, atol=1e-5)
    for step in range(3):
        tok = np.random.RandomState(10 + step).randn(2, 1, cfg.d_model).astype(np.float32)
        out, cache = ssm.mamba_decode(tp, torch.from_numpy(tok), cache, cfg, policy=pol)
        ref, jcache = jax_ssm.mamba_decode(jp, jnp.asarray(tok), jcache, jcfg, policy=jpol)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        for name in ("conv", "state"):
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                       rtol=1e-5, atol=1e-5)


def test_mamba_prefill_pads_a_short_prompt():
    """A prompt shorter than the conv window leaves a (B, K-1, ch) window,
    zero in front, as the causal conv pads it."""
    _, cfg, _, tp = _layer_pair(1)
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 2, cfg.d_model).astype(np.float32))
    _, cache = ssm.mamba_prefill(tp, x, cfg)
    K = cfg.conv_kernel
    assert cache["conv"].shape == (1, K - 1, ssm.conv_channels(cfg))
    assert torch.equal(cache["conv"][:, :K - 3], torch.zeros_like(cache["conv"][:, :K - 3]))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_train_step_flops_match_reference(reduced):
    jcfg, cfg = jax_get_config("zamba2-2.7b"), get_config("zamba2-2.7b")
    if reduced:
        jcfg, cfg = jcfg.reduced(n_layers=4), cfg.reduced(n_layers=4)
    for backward in (True, False):
        ref = jax_costmodel.train_step_flops(jcfg, 8, 2048, backward=backward)
        out = costmodel.train_step_flops(cfg, 8, 2048, backward=backward)
        for field in ("matmul", "attn", "scan", "tokens"):
            assert getattr(out, field) == pytest.approx(getattr(ref, field), rel=1e-12)
        assert out.scan > 0 and out.attn > 0
