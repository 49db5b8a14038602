"""The int8 KV cache (``kv_quant``) in the port against the JAX package.

  * ``layers.kv_quantize`` bit for bit against the reference's on the same
    numpy inputs (ties at .5, which both round to even, and all-zero rows,
    which take the 1e-8 scale floor);
  * yi-6b, h2o-danube-1.8b (its ring) and zamba2-2.7b (its shared block's
    KV) reduced with ``kv_quant=True``, weights from the reference: prefill
    and 4 decode steps against the JAX ``Model`` with ``kv_quant=True`` at
    1e-4, and against the port's fp cache at the reference's bar
    (``tests/test_kv_quant.py``: rtol 0.08, atol 0.15);
  * the paged (yi-6b) and slot-swap (h2o-danube, zamba2) engines over int8
    caches, token for token against greedy decoding.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.interop import from_jax_params
from repro_torch.models import layers
from repro_torch.models.model import Model
from repro_torch.runtime.serve_engine import Request, ServeEngine
from repro_torch.runtime.serve_loop import greedy_generate

torch.set_num_threads(1)

ARCHS = ("yi-6b", "h2o-danube-1.8b", "zamba2-2.7b")
TOL = dict(rtol=1e-4, atol=1e-4)
# the reference's bar between the int8 and the fp cache
QUANT_TOL = dict(rtol=0.08, atol=0.15)
CACHE_LEN = 32


def _quant_inputs() -> np.ndarray:
    """(6, 4, 16) rows: random ones at three scales, rows whose absmax is
    127 (scale exactly 1) holding ties x.5 of both signs, and all-zero
    rows."""
    rng = np.random.RandomState(0)
    x = rng.randn(6, 4, 16).astype(np.float32)
    x[1] *= 1e-3
    x[2] *= 300.0
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5], np.float32)
    x[3] = rng.randint(-20, 20, (4, 16)).astype(np.float32) + 0.5
    x[3, :, :8] = ties
    x[3, :, 8] = 127.0
    x[4] = 0.0
    x[5, :2] = 0.0
    return x


def test_kv_quantize_bit_equal_to_reference():
    x = _quant_inputs()
    qj, sj = jax_layers.kv_quantize(jnp.asarray(x))
    qt, st = layers.kv_quantize(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert np.all(st.numpy()[4] == np.float32(1e-8)) and not qt.numpy()[4].any()
    # the ties round to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 126.5 -> 126
    np.testing.assert_array_equal(qt.numpy()[3, 0, :8], [0, 2, 2, 0, -2, -2, 126, -126])
    for dtype in (np.float32, jnp.bfloat16):
        back_j = jax_layers.kv_dequantize(qj, sj, dtype)
        back_t = layers.kv_dequantize(qt, st, torch.float32 if dtype == np.float32
                                      else torch.bfloat16)
        np.testing.assert_array_equal(back_t.float().numpy(),
                                      np.asarray(back_j).astype(np.float32))


def _build(arch: str, quant: bool = True):
    cfg = dataclasses.replace(jax_get_config(arch).reduced(), kv_quant=quant)
    jm = JaxModel(cfg, jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config(arch).reduced(), kv_quant=quant)
    tm = Model(tcfg, torch.float32, device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp), tm))
    return jm, jp, tm


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jm, jp, tm = _build(request.param)
    fp = Model(dataclasses.replace(tm.cfg, kv_quant=False), torch.float32, device="cpu")
    fp.load_state_dict(tm.state_dict())
    return jm, jp, tm, fp


def _kv(cache: dict) -> dict:
    """The attention KV leaves of a cache (zamba2's are its shared block's)."""
    return cache["shared"] if "shared" in cache else cache["layers"]


def test_int8_cache_prefill_decode_match_jax(pair):
    jm, jp, tm, fp = pair
    S = 17
    toks = np.random.RandomState(1).randint(0, tm.cfg.vocab_size, (2, S + 4)).astype(np.int32)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, CACHE_LEN)
    lt, ct = tm.prefill({"tokens": torch.from_numpy(toks[:, :S])}, CACHE_LEN)
    lf, cf = fp.prefill({"tokens": torch.from_numpy(toks[:, :S])}, CACHE_LEN)
    kv = _kv(ct)
    assert kv["k"].dtype == kv["v"].dtype == torch.int8
    assert kv["k_scale"].dtype == torch.float32 and kv["k_scale"].shape == kv["k"].shape[:-1]
    step = jax.jit(jm.decode_step)
    for t in range(S, S + 5):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        np.testing.assert_allclose(lt.numpy(), lf.numpy(), **QUANT_TOL)
        if t == S + 4:
            break
        tok = toks[:, t:t + 1]
        lj, cj = step(jp, cj, {"token": jnp.asarray(tok)})
        lt, ct = tm.decode_step(ct, {"token": torch.from_numpy(tok)})
        lf, cf = fp.decode_step(cf, {"token": torch.from_numpy(tok)})
    assert (torch.argmax(lt, -1) == torch.argmax(lf, -1)).all()
    # an int8 entry may land one step off where XLA's K sits on the other
    # side of a rounding boundary; the scales agree as the values do
    for name in ("k", "v"):
        assert np.abs(_kv(ct)[name].numpy().astype(np.int32)
                      - np.asarray(_kv(cj)[name]).astype(np.int32)).max() <= 1
        np.testing.assert_allclose(_kv(ct)[name + "_scale"].numpy(),
                                   np.asarray(_kv(cj)[name + "_scale"]), **TOL)


def test_int8_engine_matches_greedy(pair):
    """Three requests over two slots (a refill): the paged pool for yi-6b,
    the slot-swap cache for the ring and zamba2, every leaf int8 or its
    scales; each request's tokens equal its greedy stream."""
    _, _, tm, _ = pair
    lens = (5, 11, 7) if tm.cfg.family == "hybrid" else (5, 20, 9)
    prompts = [np.random.RandomState(10 + i).randint(0, tm.cfg.vocab_size, n)
               .astype(np.int32) for i, n in enumerate(lens)]
    refs = [greedy_generate(tm, torch.from_numpy(p)[None], 6, CACHE_LEN)[0].numpy()
            for p in prompts]
    eng = ServeEngine(tm, n_slots=2, cache_len=CACHE_LEN, block_size=4)
    assert eng.paged == (tm.cfg.name == "yi-6b-reduced")
    assert _kv(eng.cache)["k"].dtype == torch.int8 and "v_scale" in _kv(eng.cache)
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=6)
                   for i, p in enumerate(prompts)])
    for i in range(3):
        np.testing.assert_array_equal(out[i], refs[i])
