"""The rwkv family (rwkv6-1.6b) in the port against the JAX package, fp32 on
the CPU, on rwkv6 reduced to 4 layers (d 256, 4 heads of 64: the kernels'
K = V) with the weights of the JAX init (``interop.from_jax_params``),
the init's zero token-shift mixes, decay bias and bonus replaced by random
values on both sides: loss and every gradient with kernels off and on (on
the CPU the kernel entries take their plain versions and the wkv Function
its autograd recompute; the JAX package's run in interpret mode) at 1e-4;
prefill logits and every cache leaf at exact lengths 5 (the single-step
loop), 33 (chunk 1) and 64 (chunk 32), then greedy decode; a frozen slot
of the slot-swap cache left bit-identical by ``decode_step``; the
ServeEngine's tokens equal to ``greedy_generate`` for mixed prompt lengths;
and 4 train steps against the reference's single-device step."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import costmodel as jax_costmodel
from repro.core.compute import ComputePolicy as JaxPolicy
from repro.models.model import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamW, cosine_schedule as jax_cosine
from repro.runtime.train_loop import (ParallelPlan as JaxPlan,
                                      build_train_step as jax_build,
                                      init_train_state as jax_init)
from repro_torch.configs import get_config
from repro_torch.core import costmodel
from repro_torch.core.compute import ComputePolicy
from repro_torch.data import SyntheticCorpus, make_batch_iterator
from repro_torch.interop import from_jax_params
from repro_torch.kernels import ops
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.runtime.serve_engine import Request, ServeEngine
from repro_torch.runtime.serve_loop import greedy_generate
from repro_torch.runtime.train_loop import ParallelPlan, build_train_step, init_train_state

# tiny shapes: intra-op threads only add overhead here, and they
# oversubscribe the cores shared by parallel test workers
torch.set_num_threads(1)

# XLA-CPU and torch-CPU order their sums differently, across 4 layers
TOL = dict(rtol=1e-4, atol=1e-4)
LAYERS = 4
ARCH = "rwkv6-1.6b"


def _randomize(jp: dict) -> dict:
    """The init's zero token-shift mixes (mu_*), decay bias (w0) and bonus
    (u) replaced by random values, so that every term of the block is live."""
    rng = np.random.RandomState(0)
    layers = jax.tree.map(np.asarray, jp["layers"])
    for mix in ("tm", "cm"):
        for name, a in layers[mix].items():
            if name.startswith("mu_"):
                layers[mix][name] = rng.uniform(0, 1, a.shape).astype(np.float32)
    tm = layers["tm"]
    tm["w0"] = (0.5 * rng.randn(*tm["w0"].shape)).astype(np.float32)
    tm["u"] = (0.3 * rng.randn(*tm["u"].shape)).astype(np.float32)
    return dict(jp, layers=jax.tree.map(jnp.asarray, layers))


def build(kernels):
    jm = JaxModel(jax_get_config(ARCH).reduced(n_layers=LAYERS), jnp.float32,
                  compute=JaxPolicy(kernels=kernels))
    jp = _randomize(jm.init(jax.random.PRNGKey(0)))
    tm = Model(get_config(ARCH).reduced(n_layers=LAYERS), torch.float32,
               compute=ComputePolicy(kernels=kernels), device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp), tm))
    return jm, jp, tm


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "kernels"])
def rwkv(request):
    return build(request.param)


def _tokens(seed, B, S, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


def _close(jax_arr, torch_t):
    np.testing.assert_allclose(torch_t.detach().numpy(), np.asarray(jax_arr), **TOL)


def test_params_and_specs_match_jax(rwkv):
    jm, jp, tm = rwkv
    assert tm.n_params() == jm.n_params()
    assert tm.cfg.resolved_head_dim == 64 and tm.cfg.d_model // 64 == 4
    assert set(tm.params()["layers"]) == {"tm", "cm"}
    assert not tm.paged_cacheable


def test_loss_and_grads_match_jax(rwkv):
    jm, jp, tm = rwkv
    toks = _tokens(0, 2, 32)
    (lj, _), gj = jax.value_and_grad(jm.loss, has_aux=True)(jp, {"tokens": jnp.asarray(toks)})
    tm.zero_grad(set_to_none=True)
    tm.requires_grad_(True)
    ops.reset_launch_counts()
    lt, _ = tm.loss({"tokens": torch.from_numpy(toks)})
    lt.backward()
    tm.requires_grad_(False)
    assert set(ops.launch_counts().values()) == {0}      # CPU: plain versions only
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    flat = dict(jax.tree_util.tree_flatten_with_path(gj)[0])
    grads = {".".join(str(getattr(k, "key", k)) for k in path): g for path, g in flat.items()}
    named = dict(tm.named_parameters())
    assert set(grads) == set(named)
    for name, g in grads.items():
        g = np.asarray(g)
        np.testing.assert_allclose(named[name].grad.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * max(float(np.abs(g).max()), 1e-6),
                                   err_msg=name)
    assert float(named["layers.tm.u"].grad.abs().sum()) > 0


@pytest.mark.parametrize("S", [5, 33, 64], ids=["T<8", "chunk1", "chunk32"])
def test_prefill_decode_match_jax(rwkv, S):
    """Prefill and 4 greedy decode steps: logits at 1e-4, every cache leaf,
    and the same tokens."""
    jm, jp, tm = rwkv
    toks = _tokens(S, 2, S)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 80)
    lt, ct = tm.prefill({"tokens": torch.from_numpy(toks)}, 80)
    _close(lj, lt)
    assert set(ct["layers"]) == {"x_tm", "x_cm", "state"}
    assert ct["layers"]["state"].dtype == torch.float32
    for step in range(4):
        for name in ("x_tm", "x_cm", "state"):
            _close(cj["layers"][name], ct["layers"][name])
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(torch.argmax(lt, -1).numpy(), tok[:, 0])
        lj, cj = jm.decode_step(jp, cj, {"token": jnp.asarray(tok)})
        lt, ct = tm.decode_step(ct, {"token": torch.from_numpy(tok.copy())})
        _close(lj, lt)
    assert int(ct["pos"]) == S + 4


def test_frozen_slot_is_bit_identical(rwkv):
    """``active`` without a block table: the inactive slot's last tokens,
    wkv states and pos come out exactly as they went in; the active slot's
    logits and cache equal the JAX package's under the same mask."""
    jm, jp, tm = rwkv
    toks = _tokens(7, 2, 9)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 16)
    _, ct = tm.prefill({"tokens": torch.from_numpy(toks)}, 16)
    ct["pos"] = torch.full((2,), 9, dtype=torch.int32)
    cj = dict(cj, pos=jnp.full((2,), 9, jnp.int32))
    before = {n: t.clone() for n, t in ct["layers"].items()}
    tok = np.array([[3], [5]], np.int32)
    active = np.array([True, False])
    lt, ct = tm.decode_step(ct, {"token": torch.from_numpy(tok),
                                 "active": torch.from_numpy(active)})
    lj, cj = jm.decode_step(jp, cj, {"token": jnp.asarray(tok), "active": jnp.asarray(active)})
    np.testing.assert_array_equal(ct["pos"].numpy(), [10, 9])
    _close(lj[0], lt[0])
    for name, old in before.items():
        assert torch.equal(ct["layers"][name][:, 1], old[:, 1]), name
        assert not torch.equal(ct["layers"][name][:, 0], old[:, 0]), name
        _close(cj["layers"][name], ct["layers"][name])


def test_prefill_and_decode_refuse_padding_and_paging(rwkv):
    """``lens`` shorter than the prompt tensor would leave the padding in
    the wkv state: the rwkv prefill refuses it, and takes ``lens`` equal to
    the length; a block table is refused too (the cache is slot-swapped)."""
    _, _, tm = rwkv
    toks = torch.from_numpy(_tokens(3, 2, 8))
    with pytest.raises(ValueError, match="exact"):
        tm.prefill({"tokens": toks}, 16, lens=torch.tensor([8, 5]))
    lt, ct = tm.prefill({"tokens": toks}, 16, lens=torch.tensor([8, 8]))
    lr, _ = tm.prefill({"tokens": toks}, 16)
    assert torch.equal(lt, lr)
    assert ct["pos"].tolist() == [8, 8]
    with pytest.raises(ValueError, match="slot-swapped"):
        tm.decode_step(ct, {"token": toks[:, :1],
                            "block_table": torch.zeros(2, 2, dtype=torch.int32)})


def test_engine_matches_greedy(rwkv):
    """5 requests over 2 slots (refills mid-run), prompt lengths 7 (the
    single-step loop), 9 (chunk 1), 12, 5 and 16: each request's tokens equal
    its solo greedy_generate stream; the engine prefills each at its exact
    length."""
    _, _, tm = rwkv
    lengths = [7, 9, 12, 5, 16]
    prompts = [_tokens(20 + i, 1, n)[0] for i, n in enumerate(lengths)]
    refs = [greedy_generate(tm, torch.from_numpy(p)[None], 6, 32)[0].numpy()
            for p in prompts]
    eng = ServeEngine(tm, n_slots=2, cache_len=32)
    assert not eng.paged and eng.exact_prefill
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)])
    for i in range(len(prompts)):
        np.testing.assert_array_equal(out[i], refs[i])
    assert eng.n_prefills == len(prompts)
    assert [r["finish_reason"] for r in eng.records] == ["max_new_tokens"] * len(prompts)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_train_steps_match_jax(kernels):
    """4 fp32 steps (gas 2, remat full) from the same weights and batches:
    losses and grad norms at 1e-4 relative."""
    plan = dict(gas=2, precision="fp32", remat="full", kernels=kernels)
    jm = JaxModel(jax_get_config(ARCH).reduced(n_layers=LAYERS), jnp.float32)
    jplan = JaxPlan(**plan)
    jopt = JaxAdamW(lr=jax_cosine(1e-3, 2, 4))
    jstate = jax_init(jm, jax.random.PRNGKey(0), jopt, jplan)
    jstate = dict(jstate, params=_randomize(jstate["params"]))
    jstep = jax.jit(jax_build(jm, jopt, jplan))
    tm = Model(get_config(ARCH).reduced(n_layers=LAYERS), torch.float32, device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jstate["params"]), tm))
    topt = AdamWConfig(lr=cosine_schedule(1e-3, 2, 4))
    tplan = ParallelPlan(**plan)
    tstate = init_train_state(tm, topt, tplan)
    tstep = build_train_step(tm, topt, tplan)
    it = make_batch_iterator(SyntheticCorpus(vocab_size=tm.cfg.vocab_size, seed=0),
                             seq_len=32, global_batch=4, prefetch=0)
    ref, port = [], []
    for _ in range(4):
        batch = next(it)
        jstate, jm_ = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        tstate, tm_ = tstep(tstate, batch)
        ref.append((float(jm_["loss"]), float(jm_["grad_norm"])))
        port.append((float(tm_["loss"]), float(tm_["grad_norm"])))
    port = np.array(port)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, np.array(ref), rtol=1e-4, atol=0)
    assert port[-1, 0] < port[0, 0]                      # it learns


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_train_step_flops_match_reference(reduced):
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(n_layers=LAYERS), cfg.reduced(n_layers=LAYERS)
    for backward in (True, False):
        ref = jax_costmodel.train_step_flops(jcfg, 8, 2048, backward=backward)
        out = costmodel.train_step_flops(cfg, 8, 2048, backward=backward)
        for field in ("matmul", "attn", "scan", "tokens"):
            assert getattr(out, field) == pytest.approx(getattr(ref, field), rel=1e-12)
        assert out.scan > 0 and out.attn == 0
