"""The encdec family (seamless-m4t-medium) in the port against the JAX
package, fp32 on the CPU, on seamless reduced (2 encoder + 2 decoder layers,
d 256 in 4 heads of 64, vocab 512, 32 frames of 64) with the weights of the
JAX init (``interop.from_jax_params``) and numpy-seeded tokens and frames:
``encode``, the hidden states, the loss and every gradient leaf with
kernels off and on (on the CPU the kernel entries take their plain
versions, the JAX package's run in interpret mode) at 1e-4; the
cross-attention block alone at the flash tolerances; prefill logits and
cache and 4 decode steps (a scalar ``pos``, and a per-slot ``pos`` with
``active`` over a paged pool); the ServeEngine's tokens equal to
``greedy_generate``'s and the reference's; the train step against the
reference's over 3 steps at gas 2; ``train_step_flops``; the strict weight
copy of the ``encoder`` subtree; and the bf16 CE kernel's vocab padding in
its plain algebra."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import costmodel as jax_costmodel
from repro.core.compute import ComputePolicy as JaxPolicy
from repro.models import blocks as jax_blocks
from repro.models.common import init_params as jax_init_params
from repro.models.model import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamW, cosine_schedule as jax_cosine
from repro.runtime.serve_loop import greedy_generate as jax_greedy
from repro.runtime.train_loop import (ParallelPlan as JaxPlan,
                                      build_train_step as jax_build,
                                      init_train_state as jax_init)
from repro_torch.configs import get_config
from repro_torch.core import costmodel
from repro_torch.core.compute import ComputePolicy
from repro_torch.data import SyntheticCorpus, make_batch_iterator
from repro_torch.interop import flatten_tree, from_jax_params
from repro_torch.kernels import cross_entropy as ce
from repro_torch.kernels import ops
from repro_torch.kernels.ref import cross_entropy_bwd_ref, cross_entropy_ref
from repro_torch.launch.train import extra_specs
from repro_torch.models import blocks
from repro_torch.models.common import param_count
from repro_torch.models.model import Model, param_specs
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.runtime.serve_engine import Request, ServeEngine
from repro_torch.runtime.serve_loop import greedy_generate
from repro_torch.runtime.train_loop import (ParallelPlan, build_train_step, init_train_state,
                                            plan_state_shardings)

# tiny shapes: intra-op threads only add overhead here, and they
# oversubscribe the cores shared by parallel test workers
torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
# XLA-CPU and torch-CPU order their sums differently, over 2 + 2 layers
TOL = dict(rtol=1e-4, atol=1e-4)
# the flash kernel's tolerances (tests/test_kernels_flash.py)
FLASH_FWD, FLASH_GRAD = 2e-5, 2e-4


def build(kernels):
    jm = JaxModel(jax_get_config(ARCH).reduced(), jnp.float32,
                  compute=JaxPolicy(kernels=kernels))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH).reduced(), torch.float32,
               compute=ComputePolicy(kernels=kernels), device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp), tm))
    return jm, jp, tm


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "kernels"])
def seamless(request):
    return build(request.param)


def _tokens(seed, B, S, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


def _frames(seed, B, cfg):
    rs = np.random.RandomState(1000 + seed)
    return (0.1 * rs.randn(B, cfg.enc_seq_len, cfg.frontend_dim)).astype(np.float32)


def _close(jax_arr, torch_t, **tol):
    np.testing.assert_allclose(torch_t.detach().numpy(), np.asarray(jax_arr), **(tol or TOL))


def test_params_and_specs_match_jax(seamless):
    jm, _, tm = seamless
    assert tm.n_params() == jm.n_params()
    assert set(tm.params()["encoder"]) == {"in_proj", "layers", "final_norm"}
    assert set(tm.params()["layers"]) == {"attn", "cross", "mlp"}
    assert tm.paged_cacheable
    assert param_count(param_specs(get_config(ARCH))) == 877_682_688


def test_encode_hidden_states_loss_and_grads_match_jax(seamless):
    jm, jp, tm = seamless
    toks, frames = _tokens(0, 2, 24), _frames(0, 2, tm.cfg)
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    tb = {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)}
    _close(jm.encode(jp, jb["frames"]), tm.encode(tb["frames"]))
    hj, _, _ = jm.hidden_states(jp, jb)
    with torch.no_grad():
        ht, _, _ = tm.hidden_states(tb)
    _close(hj, ht)
    (lj, _), gj = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    tm.zero_grad(set_to_none=True)
    tm.requires_grad_(True)
    ops.reset_launch_counts()
    lt, _ = tm.loss(tb)
    lt.backward()
    tm.requires_grad_(False)
    assert set(ops.launch_counts().values()) == {0}      # CPU: plain versions only
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    grads = flatten_tree(jax.tree.map(np.asarray, gj))
    named = dict(tm.named_parameters())
    assert set(grads) == set(named)
    for name, g in grads.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * max(float(np.abs(g).max()), 1e-6),
                                   err_msg=name)
    assert float(named["encoder.in_proj"].grad.abs().sum()) > 0   # the memory's way back


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_cross_attn_block_matches_jax(kernels):
    """One cross block (16 decoder positions over 32 memory positions):
    output at 2e-5, the gradients of x, the memory and every weight at
    2e-4 (kernels on: the reference's flash kernel in interpret mode)."""
    jm, jp, tm = build(kernels)
    cfg = tm.cfg
    rs = np.random.RandomState(5)
    x = rs.randn(2, 16, cfg.d_model).astype(np.float32)
    mem = rs.randn(2, cfg.enc_seq_len, cfg.d_model).astype(np.float32)
    jparams = jax.tree.map(lambda a: a[0], jp["layers"]["cross"])
    pol = JaxPolicy(kernels=kernels)

    def jf(p, xx, mm):
        return jnp.sum(jax_blocks.cross_attn_block(p, xx, mm, jm.cfg, policy=pol) ** 2)

    yj = jax_blocks.cross_attn_block(jparams, jnp.asarray(x), jnp.asarray(mem), jm.cfg,
                                     policy=pol)
    gj = jax.grad(jf, argnums=(0, 1, 2))(jparams, jnp.asarray(x), jnp.asarray(mem))
    tparams = {k: (torch.from_numpy(np.array(v)).requires_grad_() if not isinstance(v, dict)
                   else {n: torch.from_numpy(np.array(a)).requires_grad_()
                         for n, a in v.items()})
               for k, v in jparams.items()}
    xt, mt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(mem).requires_grad_()
    yt = blocks.cross_attn_block(tparams, xt, mt, cfg, policy=ComputePolicy(kernels=kernels))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=FLASH_FWD,
                               atol=FLASH_FWD)
    (yt ** 2).sum().backward()
    for got, want in ((xt.grad, gj[1]), (mt.grad, gj[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FLASH_GRAD,
                                   atol=FLASH_GRAD * float(np.abs(want).max()))
    tflat = flatten_tree({k: (v.grad if not isinstance(v, dict) else
                              {n: a.grad for n, a in v.items()}) for k, v in tparams.items()})
    for name, want in flatten_tree(jax.tree.map(np.asarray, gj[0])).items():
        np.testing.assert_allclose(np.asarray(tflat[name]), want, rtol=FLASH_GRAD,
                                   atol=FLASH_GRAD * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar_pos", "per_slot_pos"])
def test_prefill_and_decode_match_jax(seamless, per_slot):
    """Prefill logits and KV cache (with ``lens`` when per slot), then 4
    decode steps fed the encoded memory."""
    jm, jp, tm = seamless
    toks, frames = _tokens(1, 2, 12), _frames(1, 2, tm.cfg)
    lens = np.array([7, 12], np.int32) if per_slot else None
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}, 20,
                        lens=None if lens is None else jnp.asarray(lens))
    lt, ct = tm.prefill({"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)},
                        20, lens=None if lens is None else torch.from_numpy(lens))
    _close(lj, lt)
    for name in ("k", "v"):
        _close(cj["layers"][name], ct["layers"][name])
    mj, mt = jm.encode(jp, jnp.asarray(frames)), ct.pop("memory")
    _close(mj, mt)
    step = jax.jit(jm.decode_step)
    for i in range(4):
        tok = _tokens(10 + i, 2, 1)
        lj, cj = step(jp, cj, {"token": jnp.asarray(tok), "memory": mj})
        lt, ct = tm.decode_step(ct, {"token": torch.from_numpy(tok), "memory": mt})
        _close(lj, lt)
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    for name in ("k", "v"):
        _close(cj["layers"][name], ct["layers"][name])


def test_paged_decode_matches_jax(seamless):
    """Two slots over a pool of 8-position blocks: the prefill KV placed in
    the slots' blocks, then 4 decode steps through the block table with a
    per-slot memory, the second slot inactive at the last (its write goes to
    garbage block 0)."""
    jm, jp, tm = seamless
    bs, max_blocks, n_slots = 8, 4, 2
    n_blocks = 1 + n_slots * max_blocks
    toks, frames = _tokens(2, n_slots, 16), _frames(2, n_slots, tm.cfg)
    lens = np.array([11, 16], np.int32)
    _, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}, 16,
                       lens=jnp.asarray(lens))
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
    mj = jm.encode(jp, jnp.asarray(frames))
    mt = torch.from_numpy(np.array(mj))
    step = jax.jit(jm.decode_step)
    for i, active in enumerate([[True, True]] * 3 + [[True, False]]):
        batch = {"token": _tokens(20 + i, n_slots, 1), "active": np.array(active),
                 "block_table": bt}
        lj, pj = step(jp, pj, {**{k: jnp.asarray(v) for k, v in batch.items()}, "memory": mj})
        lt, pt = tm.decode_step(pt, {**{k: torch.from_numpy(v) for k, v in batch.items()},
                                     "memory": mt})
        _close(lj, lt)
    np.testing.assert_array_equal(pt["pos"].numpy(), np.asarray(pj["pos"]))
    for name in ("k", "v"):
        _close(pj["layers"][name], pt["layers"][name])


def test_engine_matches_greedy_and_jax(seamless):
    """4 requests of distinct prompt lengths, each with its frames, over 2
    slots (refills mid-run) on the paged pool: each request's tokens equal
    the port's and the reference's solo greedy streams."""
    jm, jp, tm = seamless
    lengths = [5, 9, 12, 7]
    prompts = [_tokens(30 + i, 1, n)[0] for i, n in enumerate(lengths)]
    frames = [_frames(30 + i, 1, tm.cfg)[0] for i in range(len(lengths))]
    n_new = 6
    for p, f in zip(prompts, frames):
        ours = greedy_generate(tm, torch.from_numpy(p)[None], n_new, 32,
                               extras={"frames": f[None]})[0].numpy()
        ref = np.asarray(jax_greedy(jm, jp, jnp.asarray(p)[None], n_new, 32,
                                    extras={"frames": jnp.asarray(f)[None]}))[0]
        np.testing.assert_array_equal(ours, ref)
    eng = ServeEngine(tm, n_slots=2, cache_len=32, block_size=8)
    assert eng.paged and eng.memory.shape == (2, tm.cfg.enc_seq_len, tm.cfg.d_model)
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=n_new, extras={"frames": f})
                   for i, (p, f) in enumerate(zip(prompts, frames))])
    for i, (p, f) in enumerate(zip(prompts, frames)):
        ref = greedy_generate(tm, torch.from_numpy(p)[None], n_new, 32,
                              extras={"frames": f[None]})[0].numpy()
        np.testing.assert_array_equal(out[i], ref)
    assert eng.n_prefills == len(prompts)


def _batches(cfg, n, seq=32, gb=4):
    it = make_batch_iterator(SyntheticCorpus(vocab_size=cfg.vocab_size, seed=0), seq_len=seq,
                             global_batch=gb, prefetch=0, extra_specs=extra_specs(cfg))
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_train_steps_match_jax(kernels):
    """3 fp32 steps (gas 2, remat full) from the same weights and batches
    (tokens and frames): losses and grad norms at 1e-4 relative."""
    plan = dict(gas=2, precision="fp32", remat="full", kernels=kernels)
    jm = JaxModel(jax_get_config(ARCH).reduced(), jnp.float32)
    jplan = JaxPlan(**plan)
    jopt = JaxAdamW(lr=jax_cosine(1e-3, 2, 3))
    jstate = jax_init(jm, jax.random.PRNGKey(0), jopt, jplan)
    jstep = jax.jit(jax_build(jm, jopt, jplan))
    tm = Model(get_config(ARCH).reduced(), torch.float32, device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jstate["params"]), tm))
    topt = AdamWConfig(lr=cosine_schedule(1e-3, 2, 3))
    tplan = ParallelPlan(**plan)
    tstate = init_train_state(tm, topt, tplan)
    tstep = build_train_step(tm, topt, tplan)
    ref, port = [], []
    for batch in _batches(tm.cfg, 3):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm_ = tstep(tstate, batch)
        ref.append((float(jm_["loss"]), float(jm_["grad_norm"])))
        port.append((float(tm_["loss"]), float(tm_["grad_norm"])))
    port = np.array(port)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, np.array(ref), rtol=1e-4, atol=0)
    assert port[-1, 0] < port[0, 0]                      # it learns


def test_train_step_splits_frames_with_tokens():
    """At gas 2 the step's loss is the mean of the two microbatches' losses,
    each on its own rows of the tokens and of the frames; the frames of the
    other microbatch give another loss."""
    tm = Model(get_config(ARCH).reduced(), torch.float32, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = _batches(tm.cfg, 1)[0]
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        halves = [float(tm.loss({k: v[i:i + 2] for k, v in t.items()})[0]) for i in (0, 2)]
        swapped = float(tm.loss({"tokens": t["tokens"][:2], "frames": t["frames"][2:]})[0])
    plan = ParallelPlan(gas=2, precision="fp32")
    opt = AdamWConfig(lr=1e-3)
    _, m = build_train_step(tm, opt, plan)(init_train_state(tm, opt, plan), batch)
    np.testing.assert_allclose(float(m["loss"]), np.mean(halves), rtol=1e-6)
    assert abs(swapped - halves[0]) > 1e-4


@pytest.mark.parametrize("backward", [True, False], ids=["train", "forward"])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_train_step_flops_match_jax(reduced, backward):
    """The encoder's matmuls at enc_seq_len frames a row, its
    self-attention and the decoder's cross-attention: the reference's
    count at seamless's full and reduced widths."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    ref = jax_costmodel.train_step_flops(jcfg, 8, 2048, backward=backward)
    out = costmodel.train_step_flops(cfg, 8, 2048, backward=backward)
    for name in ("matmul", "attn", "scan", "tokens"):
        assert getattr(out, name) == pytest.approx(getattr(ref, name), rel=1e-12), name


@pytest.mark.parametrize("fault", ["missing", "misshapen", "unused"])
def test_from_jax_params_is_strict_on_the_encoder(seamless, fault):
    _, jp, tm = seamless
    tree = jax.tree.map(np.array, jp)
    assert set(from_jax_params(tree, tm)) == set(tm.state_dict())
    enc = tree["encoder"]
    if fault == "missing":
        del enc["layers"]["attn"]["wk"]
    elif fault == "misshapen":
        enc["in_proj"] = np.zeros((3, 4), np.float32)
    else:
        enc["final_norm"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError if fault != "misshapen" else ValueError):
        from_jax_params(tree, tm)


@pytest.mark.parametrize("V", [509, 506, 512])
def test_ce_vocab_padding(V):
    """The bf16 kernel takes W padded to a multiple of 8 with valid_vocab the
    true V: the plain algebra on the padded W (the reference's and the
    kernel's two passes) gives the unpadded lse and label logits, and its
    backward the unpadded gradients, with zeros in the pad columns."""
    gen = torch.Generator().manual_seed(V)
    h = torch.randn(40, 64, generator=gen)
    w = torch.randn(64, V, generator=gen) * 0.1
    labels = torch.randint(0, V, (40,), generator=gen)
    g = torch.randn(40, generator=gen)
    wp = ce.pad_vocab(w)
    assert wp.shape[1] % ce.VOCAB_ALIGN == 0 and wp.shape[1] - V < ce.VOCAB_ALIGN
    assert (wp is w) == (V % ce.VOCAB_ALIGN == 0)
    assert torch.equal(wp[:, :V], w) and not wp[:, V:].any()
    exact = dict(rtol=1e-6, atol=1e-6)
    lse, ll = cross_entropy_ref(h, w, labels)
    lse_p, ll_p = cross_entropy_ref(h, wp, labels, V)
    torch.testing.assert_close(lse_p, lse, **exact)
    torch.testing.assert_close(ll_p, ll, **exact)
    m, s, ll_k = ce.partials_ref(h, wp, labels, V)
    torch.testing.assert_close(ce.merge_ref(m, s), lse, **exact)
    torch.testing.assert_close(ll_k, ll, **exact)
    dh, dw = cross_entropy_bwd_ref(h, w, labels, lse, g, V)
    dh_p, dw_p = cross_entropy_bwd_ref(h, wp, labels, lse_p, g, V)
    torch.testing.assert_close(dh_p, dh, **exact)
    torch.testing.assert_close(dw_p[:, :V], dw, **exact)
    assert not dw_p[:, V:].any()


def test_full_vocab_does_not_split_over_tp4():
    """256206 columns split over tp 2 (128103 a shard, padded for the bf16
    kernel) but not over tp 4: there the plan keeps the embedding and the
    lm_head whole on every model rank, as the reference's lenient rules do,
    and the CE runs over the whole vocab (the reduced seamless at a vocab
    of 510 over tp 4 holds that loss in tests/test_torch_parallel_rules.py);
    the blocks still split."""
    cfg = get_config(ARCH)
    _, two, _, _ = plan_state_shardings(cfg, ParallelPlan(tp=2))
    _, four, _, _ = plan_state_shardings(cfg, ParallelPlan(tp=4))
    assert two["embed"] == ("model", None) and two["lm_head"] == (None, "model")
    assert four["embed"] == (None, None) and four["lm_head"] == (None, None)
    assert four["layers.cross.wq"] == (None, None, "model")


def test_dp_engine_refuses_encdec(seamless):
    _, _, tm = seamless
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(tm, n_slots=2, mesh=object(), plan=ParallelPlan(dp=2, zero=0))
