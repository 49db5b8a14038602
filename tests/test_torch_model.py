"""The port's Model against the JAX package's Model on the same weights
(carried over by ``interop.from_jax_params``) and the same numpy inputs:
prefill logits and cache (with and without ``lens``), decode with a scalar
and a per-slot ``pos``, and decode over a paged KV pool.  yi-6b reduced with
kernels off and on (on the CPU the port's kernels take their plain versions,
the JAX package's run in interpret mode), and gpt-1.4b reduced for its
LayerNorm, GELU and MHA layers: kernels off, and kernels on at gpt-1.4b's
head dim 88.  qwen3-32b (qk-norm; also at head dim 128, where its 4 heads
of 128 are wider than d 256, as 64 x 128 > 5120 at full width) and
phi4-mini-3.8b reduced, kernels off and on: prefill logits, 3 decode steps
and the loss.  fp32 throughout."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.compute import ComputePolicy as JaxPolicy
from repro.models.common import init_params as jax_init_params
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.core.compute import ComputePolicy
from repro_torch.interop import from_jax_params
from repro_torch.models.model import Model

# tiny shapes: intra-op threads only add overhead here, and they
# oversubscribe the cores shared by parallel test workers
torch.set_num_threads(1)

# XLA-CPU and torch-CPU order their matmul sums differently, across 2 layers
TOL = dict(rtol=1e-4, atol=1e-4)


# gpt-1.4b reduced at its own head dim (d 2112 over 24 heads): plain
# .reduced() has head dim 64 and would not reach the hd-88 kernels
GPT_HD88 = dict(d_model=176, n_heads=2, head_dim=88)


def build(arch, kernels, **overrides):
    jm = JaxModel(jax_get_config(arch).reduced(**overrides), jnp.float32,
                  compute=JaxPolicy(kernels=kernels))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(arch).reduced(**overrides), torch.float32,
               compute=ComputePolicy(kernels=kernels), device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp), tm))
    return jm, jp, tm


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "kernels"])
def yi(request):
    return build("yi-6b", request.param)


def _tokens(seed, B, S, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


def _close(jax_arr, torch_t):
    np.testing.assert_allclose(torch_t.numpy(), np.asarray(jax_arr), **TOL)


def _prefill_both(jm, jp, tm, toks, cache_len, lens=None):
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len,
                        lens=None if lens is None else jnp.asarray(lens))
    lt, ct = tm.prefill({"tokens": torch.from_numpy(toks)}, cache_len,
                        lens=None if lens is None else torch.from_numpy(lens))
    return (lj, cj), (lt, ct)


@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
def test_prefill_matches_jax(yi, with_lens):
    jm, jp, tm = yi
    toks = _tokens(0, 2, 16, tm.cfg.vocab_size)
    lens = np.array([11, 16], np.int32) if with_lens else None
    (lj, cj), (lt, ct) = _prefill_both(jm, jp, tm, toks, 24, lens)
    assert lt.shape == (2, tm.cfg.vocab_size) and lt.dtype == torch.float32
    _close(lj, lt)
    for name in ("k", "v"):
        _close(cj["layers"][name], ct["layers"][name])
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar_pos", "per_slot_pos"])
def test_decode_matches_jax(yi, per_slot):
    jm, jp, tm = yi
    toks = _tokens(1, 2, 12, tm.cfg.vocab_size)
    lens = np.array([7, 12], np.int32) if per_slot else None
    (_, cj), (_, ct) = _prefill_both(jm, jp, tm, toks, 20, lens)
    assert ct["pos"].ndim == (1 if per_slot else 0)
    for step in range(3):
        tok = _tokens(10 + step, 2, 1, tm.cfg.vocab_size)
        lj, cj = jm.decode_step(jp, cj, {"token": jnp.asarray(tok)})
        lt, ct = tm.decode_step(ct, {"token": torch.from_numpy(tok)})
        _close(lj, lt)
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    for name in ("k", "v"):
        _close(cj["layers"][name], ct["layers"][name])


def test_paged_decode_matches_jax(yi):
    """Two slots over a pool of 8-position blocks: prefill KV placed in the
    slots' blocks, then decode steps through the block table, the second
    slot inactive at the last step (its write goes to garbage block 0)."""
    jm, jp, tm = yi
    bs, max_blocks, n_slots = 8, 4, 2
    n_blocks = 1 + n_slots * max_blocks
    toks = _tokens(2, n_slots, 16, tm.cfg.vocab_size)
    lens = np.array([11, 16], np.int32)
    (_, cj), _ = _prefill_both(jm, jp, tm, toks, 16, lens)
    pool = jax.tree.map(np.array, jax_init_params(
        jm.paged_cache_specs(n_slots, n_blocks, bs), jax.random.PRNGKey(0)))
    bt = np.arange(1, n_blocks, dtype=np.int32).reshape(n_slots, max_blocks)
    for name in ("k", "v"):
        small = np.asarray(cj["layers"][name])            # (L, B, 16, Hkv, hd)
        for b in range(n_slots):
            pool["layers"][name][:, bt[b, :2]] = small[:, b].reshape(
                small.shape[0], 2, bs, *small.shape[3:])
    pool["pos"] = lens.copy()
    pj = jax.tree.map(jnp.asarray, pool)
    pt = {"pos": torch.from_numpy(lens.copy()),
          "layers": {n: torch.from_numpy(a.copy()) for n, a in pool["layers"].items()}}
    for step, active in enumerate([[True, True], [True, True], [True, False]]):
        batch = {"token": _tokens(20 + step, n_slots, 1, tm.cfg.vocab_size),
                 "active": np.array(active), "block_table": bt}
        lj, pj = jm.decode_step(jp, pj, {k: jnp.asarray(v) for k, v in batch.items()})
        lt, pt = tm.decode_step(pt, {k: torch.from_numpy(v) for k, v in batch.items()})
        _close(lj, lt)
    np.testing.assert_array_equal(pt["pos"].numpy(), np.asarray(pj["pos"]))
    for name in ("k", "v"):
        _close(pj["layers"][name], pt["layers"][name])


def _gpt_prefill_decode(jm, jp, tm):
    assert tm.cfg.norm == "layernorm" and tm.cfg.act == "gelu"
    toks = _tokens(3, 2, 10, tm.cfg.vocab_size)
    (lj, cj), (lt, ct) = _prefill_both(jm, jp, tm, toks, 16)
    _close(lj, lt)
    for step in range(2):
        tok = _tokens(30 + step, 2, 1, tm.cfg.vocab_size)
        lj, cj = jm.decode_step(jp, cj, {"token": jnp.asarray(tok)})
        lt, ct = tm.decode_step(ct, {"token": torch.from_numpy(tok)})
        _close(lj, lt)


def test_gpt_plain_matches_jax():
    """gpt-1.4b reduced: LayerNorm, tanh-GELU MLP, MHA, kernels off."""
    _gpt_prefill_decode(*build("gpt-1.4b", False))


def test_gpt_hd88_kernels_match_jax():
    """gpt-1.4b reduced at head dim 88 with kernels on: the LayerNorm and
    GELU-MLP entries in prefill and decode, flash attention in prefill."""
    jm, jp, tm = build("gpt-1.4b", True, **GPT_HD88)
    assert tm.cfg.resolved_head_dim == 88 and tm.cfg.n_kv_heads == tm.cfg.n_heads
    _gpt_prefill_decode(jm, jp, tm)


# qwen3-32b and phi4-mini-3.8b: the dense configs beside yi-6b and gpt-1.4b
DENSE = [("qwen3-32b", {}), ("qwen3-32b", dict(head_dim=128)), ("phi4-mini-3.8b", {})]


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("arch,overrides", DENSE, ids=["qwen3", "qwen3_hd128", "phi4"])
def test_dense_config_matches_jax(arch, overrides, kernels):
    """Prefill logits, 3 decode steps and the loss against the JAX Model."""
    jm, jp, tm = build(arch, kernels, **overrides)
    assert tm.cfg.qk_norm == (arch == "qwen3-32b")
    toks = _tokens(4, 2, 12, tm.cfg.vocab_size)
    (lj, cj), (lt, ct) = _prefill_both(jm, jp, tm, toks, 16)
    _close(lj, lt)
    step = jax.jit(jm.decode_step)
    for i in range(3):
        tok = _tokens(40 + i, 2, 1, tm.cfg.vocab_size)
        lj, cj = step(jp, cj, {"token": jnp.asarray(tok)})
        lt, ct = tm.decode_step(ct, {"token": torch.from_numpy(tok)})
        _close(lj, lt)
    batch = _tokens(5, 2, 24, tm.cfg.vocab_size)
    lj, _ = jm.loss(jp, {"tokens": jnp.asarray(batch)})
    with torch.no_grad():
        lt, _ = tm.loss({"tokens": torch.from_numpy(batch)})
    np.testing.assert_allclose(float(lt), float(lj), **TOL)
