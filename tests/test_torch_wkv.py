"""The port's wkv pieces against the JAX package on the same numpy-seeded
inputs: the wkv scan Function (on the CPU its plain version and its
autograd recompute) against ``repro.kernels.ops.wkv_scan`` (Pallas, in
interpret mode) and ``ref.wkv_scan_ref``, forward at 2e-5 and the gradients
of sum(y^2) + sum(S^2) at 3e-3 (the tolerances of
tests/test_kernels_scan.py), at head widths 8 and 64 and chunks 1, 4, 16
and 32; the scan against the reference's sequential ``_time_mix_core``
oracle at 1e-4; the decode step against ``ops.wkv_decode_step`` and
``ref.wkv_decode_ref`` at 1e-6; the in-place decode forms' slot masking
bit for bit; the chunk and head-width refusals; the
kernel's staged form (``wkv_scan_staged``) against the same references at
chunks 1 to 32."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jax_ops, ref as jax_ref
from repro.models import rwkv as jax_rwkv
from repro_torch.kernels import ops, wkv_scan as wkv
from repro_torch.kernels.ref import wkv_decode_ref, wkv_decode_ref_
from repro_torch.models import rwkv

# tiny shapes: intra-op threads only add overhead here, and they
# oversubscribe the cores shared by parallel test workers
torch.set_num_threads(1)


def _wkv_inputs(seed, B=2, T=64, H=3, K=8, V=8):
    """The reference tests' distributions (tests/test_kernels_scan.py:
    _wkv_inputs), drawn with numpy.  Above its K = 8, r and k are scaled by
    (8/K)^(1/4) each, so that r_t . k_i keeps the variance it has at K = 8:
    the reference's absolute tolerances are in the units of its outputs,
    and unit r and k at K = 64 give outputs of ~50 whose cancelling
    entries differ by 3e-5 between two fp32 summation orders."""
    rng = np.random.RandomState(seed)
    scale = np.float32(min(1.0, (8 / K) ** 0.25))
    r = (scale * rng.randn(B, T, H, K)).astype(np.float32)
    k = (scale * rng.randn(B, T, H, K)).astype(np.float32)
    v = rng.randn(B, T, H, V).astype(np.float32)
    w = np.exp(-np.exp(0.5 * rng.randn(B, T, H, K))).astype(np.float32)
    u = (0.3 * rng.randn(H, K)).astype(np.float32)
    S0 = (0.2 * rng.randn(B, H, K, V)).astype(np.float32)
    return r, k, v, w, u, S0


def _sq_loss(y, S):
    return (y ** 2).sum() + (S ** 2).sum()


@pytest.mark.parametrize("width", [8, 64])
@pytest.mark.parametrize("chunk", [1, 4, 16, 32])
def test_wkv_scan_matches_jax(chunk, width):
    arrays = _wkv_inputs(chunk + width, H=3 if width == 8 else 2, K=width, V=width)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, S = ops.wkv_scan(*ts, chunk=chunk)
    assert type(y.grad_fn).__name__ == "WKVScanBackward"
    js = [jnp.asarray(a) for a in arrays]
    yk, Sk = jax_ops.wkv_scan(*js, chunk=chunk)               # interpret mode
    yr, Sr = jax_ref.wkv_scan_ref(*js, chunk=chunk)
    for ref_y, ref_S in ((yk, Sk), (yr, Sr)):
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(S.detach().numpy(), np.asarray(ref_S), rtol=2e-5, atol=2e-5)
    _sq_loss(y, S).backward()
    gk = jax.grad(lambda *a: _sq_loss(*jax_ops.wkv_scan(*a, chunk=chunk)),
                  argnums=tuple(range(6)))(*js)
    for t, g in zip(ts, gk):
        g = np.asarray(g)
        # K = 8: the reference's own rule.  K = 64: the gradients reach
        # ~1e3, and the w gradient of a 16- or 32-token chunk sums cancelling
        # terms, where either package's fp32 lies as far from a float64
        # evaluation as from the other (up to 1e-5 of the leaf's norm): the
        # absolute part is 3e-3 of the leaf's rms
        atol = 3e-3 * (1.0 if width == 8 else float(np.sqrt(np.mean(g ** 2))))
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=3e-3, atol=atol)


@pytest.mark.parametrize("chunk", [1, 16])
def test_wkv_scan_matches_sequential_oracle(chunk):
    """The chunked scan against the reference's token-by-token
    ``_time_mix_core`` (the exact recurrence) at 1e-4."""
    r, k, v, w, u, S0 = _wkv_inputs(7)
    y, S = ops.wkv_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u, S0)), chunk=chunk)
    Sj = jnp.asarray(S0)
    ys = []
    for t in range(r.shape[1]):
        out, Sj = jax_rwkv._time_mix_core(*(jnp.asarray(a[:, t]) for a in (r, k, v, w)),
                                          jnp.asarray(u)[None], Sj)
        ys.append(np.asarray(out))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), rtol=1e-4, atol=1e-4)


def test_plain_chunked_path_matches_kernel_entry():
    """``rwkv._wkv_chunked`` without kernels (the model's plain path, chunk
    bodies under the remat wrapper) gives what the kernel entry gives."""
    arrays = [torch.from_numpy(a) for a in _wkv_inputs(3)]
    y, S = rwkv._wkv_chunked(*arrays, 16)
    yk, Sk = ops.wkv_scan(*arrays, chunk=16)
    assert torch.equal(y, yk) and torch.equal(S, Sk)


@pytest.mark.parametrize("width", [8, 64])
def test_wkv_decode_step_matches_jax(width):
    r, k, v, w, u, S0 = _wkv_inputs(11, K=width, V=width)
    r, k, v, w = (a[:, 5] for a in (r, k, v, w))          # one token: (B, H, K)
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in (r, k, v, w, u, S0)]
    before = ts[-1].clone()
    out, S = ops.wkv_decode_step(*ts)
    assert torch.equal(ts[-1], before)                   # a fresh state tensor
    js = [jnp.asarray(a) for a in (r, k, v, w, u, S0)]
    for ref_out, ref_S in (jax_ops.wkv_decode_step(*js), jax_ref.wkv_decode_ref(*js)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(S.numpy(), np.asarray(ref_S), rtol=1e-6, atol=1e-6)
    # the port's _time_mix_core is the same step
    out2, S2 = rwkv._time_mix_core(*ts)
    assert torch.equal(out2, out) and torch.equal(S2, S)


@pytest.mark.parametrize("entry", ["ops", "ref"])
def test_wkv_decode_in_place_masks_slots(entry):
    """The in-place form with slots 1 and 3 inactive, at the kernel's width
    64 and 4 slots: out equals the pure form's, the active slots' rows its
    new state and the inactive slots' rows the state before, bit for bit;
    the tensor is the one passed in.  With ``active`` None every row takes
    the new state."""
    r, k, v, w, u, S0 = _wkv_inputs(12, B=4, H=2, K=64, V=64)
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in
          (r[:, 3], k[:, 3], v[:, 3], w[:, 3], u)]
    S0 = torch.from_numpy(S0)
    step_ = ops.wkv_decode_step_ if entry == "ops" else wkv_decode_ref_
    out_pure, S_pure = wkv_decode_ref(*ts, S0)
    active = torch.tensor([True, False, True, False])
    state = S0.clone()
    ptr = state.data_ptr()
    out = step_(*ts, state, active)
    assert state.data_ptr() == ptr
    assert torch.equal(out, out_pure)
    assert torch.equal(state[active], S_pure[active])
    assert torch.equal(state[~active], S0[~active])
    state = S0.clone()
    assert torch.equal(step_(*ts, state, None), out_pure)
    assert torch.equal(state, S_pure)


@pytest.mark.parametrize("chunk", [1, 4, 8, 32])
def test_wkv_scan_staged_matches_jax(chunk):
    """``wkv_scan_staged``, the kernel's three passes (the chunk-local
    states, the carry in chunk order from the carried state, the read-out)
    in plain torch, against the JAX package's ``ops.wkv_scan`` (Pallas,
    interpret mode) and ``ref.wkv_scan_ref`` at 2e-5, at the kernels' head
    width 64."""
    arrays = _wkv_inputs(200 + chunk, H=2, K=64, V=64)
    y, S = wkv.wkv_scan_staged(*(torch.from_numpy(a) for a in arrays), chunk=chunk)
    js = [jnp.asarray(a) for a in arrays]
    for ref_y, ref_S in (jax_ops.wkv_scan(*js, chunk=chunk),
                         jax_ref.wkv_scan_ref(*js, chunk=chunk)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(S.numpy(), np.asarray(ref_S), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("T,chunk", [(32, 3), (64, 64), (24, 16), (32, 0)])
def test_wkv_scan_refuses_bad_chunk(T, chunk):
    arrays = [torch.from_numpy(a) for a in _wkv_inputs(0, T=T)]
    with pytest.raises(ValueError, match="chunk"):
        wkv.wkv_scan(*arrays, chunk=chunk)
