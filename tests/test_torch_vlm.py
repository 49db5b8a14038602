"""The vlm family (internvl2-2b) in the port against the JAX package, fp32
on the CPU, on internvl2 reduced at its own head dim (2 layers, d 256 in 4
heads of 128 over 2 KV heads, vocab 512, 8 patches of 64 ahead of the
text) with the weights of the JAX init (``interop.from_jax_params``) and
numpy-seeded tokens and patches: the hidden states, ``logits`` (the patch
positions kept), the loss and every gradient leaf (``proj`` too) with
kernels off and on (on the CPU the kernel entries take their plain
versions, the JAX package's run in interpret mode) at 1e-4; prefill with
``lens`` at two buckets and with a scalar ``pos``, then 4 decode steps;
decode on a paged pool; the ServeEngine's tokens equal to
``greedy_generate``'s and the reference's, and its patch-offset
bookkeeping; the train step against the reference's over 3 steps at gas
2; ``train_step_flops``; the strict weight copy of ``proj``; and the
launchers at reduced size."""
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import costmodel as jax_costmodel
from repro.core.compute import ComputePolicy as JaxPolicy
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
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.launch.train import extra_specs
from repro_torch.models.common import param_count
from repro_torch.models.model import Model, param_specs
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.runtime.serve_engine import Request, ServeEngine
from repro_torch.runtime.serve_loop import greedy_generate
from repro_torch.runtime.train_loop import ParallelPlan, build_train_step, init_train_state

# tiny shapes: intra-op threads only add overhead here, and they
# oversubscribe the cores shared by parallel test workers
torch.set_num_threads(1)

ARCH = "internvl2-2b"
OVERRIDES = dict(head_dim=128)
# XLA-CPU and torch-CPU order their sums differently, over 2 layers
TOL = dict(rtol=1e-4, atol=1e-4)


def build(kernels):
    jm = JaxModel(jax_get_config(ARCH).reduced(**OVERRIDES), jnp.float32,
                  compute=JaxPolicy(kernels=kernels))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH).reduced(**OVERRIDES), torch.float32,
               compute=ComputePolicy(kernels=kernels), device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp), tm))
    return jm, jp, tm


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "kernels"])
def vlm(request):
    return build(request.param)


def _tokens(seed, B, S, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


def _patches(seed, B, cfg):
    rs = np.random.RandomState(1000 + seed)
    return (0.1 * rs.randn(B, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)


def _close(jax_arr, torch_t, **tol):
    np.testing.assert_allclose(torch_t.detach().numpy(), np.asarray(jax_arr), **(tol or TOL))


def _batches(jax_like: bool, **arrays):
    wrap = jnp.asarray if jax_like else torch.from_numpy
    return {k: wrap(v) for k, v in arrays.items()}


def test_params_and_specs_match_jax(vlm):
    jm, _, tm = vlm
    assert tm.n_params() == jm.n_params()
    assert tuple(tm.params()["proj"].shape) == (tm.cfg.frontend_dim, tm.cfg.d_model)
    assert tm.paged_cacheable and tm.patch_offset == tm.cfg.num_patches == 8
    assert param_count(param_specs(get_config(ARCH))) == 1_891_244_032


def test_hidden_states_logits_loss_and_grads_match_jax(vlm):
    """The hidden states and logits over the patch and text positions, the
    loss over the text and every gradient; the patches' way back reaches
    ``proj``, and the CE sees no patch position (other patches, the same
    tokens: another loss; the patch rows of the logits are not the text's)."""
    jm, jp, tm = vlm
    toks, pat = _tokens(0, 2, 24), _patches(0, 2, tm.cfg)
    jb, tb = _batches(True, tokens=toks, patches=pat), _batches(False, tokens=toks, patches=pat)
    hj, _, _ = jm.hidden_states(jp, jb)
    with torch.no_grad():
        ht, _, _ = tm.hidden_states(tb)
        lt_logits = tm.logits(tb)
    assert ht.shape == (2, 8 + 24, tm.cfg.d_model)
    _close(hj, ht)
    _close(jm.logits(jp, jb), lt_logits)
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
    assert float(named["proj"].grad.abs().sum()) > 0
    with torch.no_grad():
        other = float(tm.loss({**tb, "patches": torch.from_numpy(_patches(9, 2, tm.cfg))})[0])
    assert abs(other - float(lt.detach())) > 1e-5


@pytest.mark.parametrize("case", ["scalar_pos", "lens_bucket16", "lens_bucket24"])
def test_prefill_and_decode_match_jax(vlm, case):
    """Prefill logits and KV cache (``lens`` at two buckets: the cache holds
    lens + 8 positions, the logits read at lens + 7), then 4 decode steps
    whose positions count the patches."""
    jm, jp, tm = vlm
    S = 24 if case == "lens_bucket24" else 16
    toks, pat = _tokens(1, 2, S), _patches(1, 2, tm.cfg)
    lens = None if case == "scalar_pos" else np.array([S - 9, S], np.int32)
    lj, cj = jm.prefill(jp, _batches(True, tokens=toks, patches=pat), 40,
                        lens=None if lens is None else jnp.asarray(lens))
    lt, ct = tm.prefill(_batches(False, tokens=toks, patches=pat), 40,
                        lens=None if lens is None else torch.from_numpy(lens))
    _close(lj, lt)
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    assert int(ct["pos"].max()) == 8 + S
    for name in ("k", "v"):
        _close(cj["layers"][name], ct["layers"][name])
    step = jax.jit(jm.decode_step)
    for i in range(4):
        tok = _tokens(10 + i, 2, 1)
        lj, cj = step(jp, cj, {"token": jnp.asarray(tok)})
        lt, ct = tm.decode_step(ct, {"token": torch.from_numpy(tok)})
        _close(lj, lt)
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    for name in ("k", "v"):
        _close(cj["layers"][name], ct["layers"][name])


def test_paged_decode_matches_jax(vlm):
    """Two slots over a pool of 8-position blocks: the prefill KV (8 patch
    and 16 text positions) placed in the slots' blocks, then 4 decode steps
    through the block table, the second slot inactive at the last (its
    write goes to garbage block 0)."""
    jm, jp, tm = vlm
    bs, max_blocks, n_slots = 8, 5, 2
    n_blocks = 1 + n_slots * max_blocks
    toks, pat = _tokens(2, n_slots, 16), _patches(2, n_slots, tm.cfg)
    lens = np.array([11, 16], np.int32)
    _, cj = jm.prefill(jp, _batches(True, tokens=toks, patches=pat), 24,
                       lens=jnp.asarray(lens))
    pool = jax.tree.map(np.array, jax_init_params(
        jm.paged_cache_specs(n_slots, n_blocks, bs), jax.random.PRNGKey(0)))
    bt = np.arange(1, n_blocks, dtype=np.int32).reshape(n_slots, max_blocks)
    for name in ("k", "v"):
        small = np.asarray(cj["layers"][name])            # (L, B, 24, Hkv, hd)
        for b in range(n_slots):
            pool["layers"][name][:, bt[b, :3]] = small[:, b].reshape(
                small.shape[0], 3, bs, *small.shape[3:])
    pool["pos"] = np.asarray(cj["pos"]).copy()
    pj = jax.tree.map(jnp.asarray, pool)
    pt = {"pos": torch.from_numpy(pool["pos"].copy()),
          "layers": {n: torch.from_numpy(a.copy()) for n, a in pool["layers"].items()}}
    step = jax.jit(jm.decode_step)
    for i, active in enumerate([[True, True]] * 3 + [[True, False]]):
        batch = {"token": _tokens(20 + i, n_slots, 1), "active": np.array(active),
                 "block_table": bt}
        lj, pj = step(jp, pj, {k: jnp.asarray(v) for k, v in batch.items()})
        lt, pt = tm.decode_step(pt, {k: torch.from_numpy(v) for k, v in batch.items()})
        _close(lj, lt)
    np.testing.assert_array_equal(pt["pos"].numpy(), np.asarray(pj["pos"]))
    for name in ("k", "v"):
        _close(pj["layers"][name], pt["layers"][name])


def test_engine_matches_greedy_and_jax(vlm):
    """4 requests of distinct prompt lengths, each with its patches, over 2
    slots (refills mid-run) on the paged pool: each request's tokens equal
    the port's and the reference's solo greedy streams."""
    jm, jp, tm = vlm
    lengths = [5, 9, 12, 7]
    prompts = [_tokens(30 + i, 1, n)[0] for i, n in enumerate(lengths)]
    patches = [_patches(30 + i, 1, tm.cfg)[0] for i in range(len(lengths))]
    n_new = 6
    for p, f in zip(prompts, patches):
        ours = greedy_generate(tm, torch.from_numpy(p)[None], n_new, 40,
                               extras={"patches": f[None]})[0].numpy()
        ref = np.asarray(jax_greedy(jm, jp, jnp.asarray(p)[None], n_new, 40,
                                    extras={"patches": jnp.asarray(f)[None]}))[0]
        np.testing.assert_array_equal(ours, ref)
    eng = ServeEngine(tm, n_slots=2, cache_len=32, block_size=8)
    assert eng.paged and eng.patch_off == 8
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=n_new, extras={"patches": f})
                   for i, (p, f) in enumerate(zip(prompts, patches))])
    for i, (p, f) in enumerate(zip(prompts, patches)):
        ref = greedy_generate(tm, torch.from_numpy(p)[None], n_new, 40,
                              extras={"patches": f[None]})[0].numpy()
        np.testing.assert_array_equal(out[i], ref)
    assert eng.n_prefills == len(prompts)


def test_engine_counts_the_patch_positions():
    """The capacity, the blocks an admission takes and the slot's ``pos``
    count the 8 patch positions ahead of the prompt, as the reference's
    engine does; a request that fits only without them is refused."""
    _, _, tm = build(False)
    eng = ServeEngine(tm, n_slots=2, cache_len=32, block_size=8)
    assert eng.max_blocks == (32 + 8) // 8 + 1 and eng.capacity == 40
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(Request(rid=0, prompt=np.zeros(30, np.int32), max_new_tokens=3,
                           extras={"patches": _patches(0, 1, tm.cfg)[0]}))
    eng.submit(Request(rid=1, prompt=_tokens(3, 1, 9)[0], max_new_tokens=4,
                       extras={"patches": _patches(3, 1, tm.cfg)[0]}))
    eng.step()
    slot = next(s for s in eng.slots if s.req is not None)
    assert slot.pos == 8 + 9 + 1 and len(slot.blocks) == (8 + 9) // 8 + 1
    assert int(eng.cache["pos"].max()) == 8 + 9 + 1


def _train_batches(cfg, n, seq=32, gb=4):
    it = make_batch_iterator(SyntheticCorpus(vocab_size=cfg.vocab_size, seed=0), seq_len=seq,
                             global_batch=gb, prefetch=0, extra_specs=extra_specs(cfg))
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_train_steps_match_jax(kernels):
    """3 fp32 steps (gas 2, remat full) from the same weights and batches
    (tokens and patches): losses and grad norms at 1e-4 relative."""
    plan = dict(gas=2, precision="fp32", remat="full", kernels=kernels)
    jm = JaxModel(jax_get_config(ARCH).reduced(**OVERRIDES), jnp.float32)
    jplan = JaxPlan(**plan)
    jopt = JaxAdamW(lr=jax_cosine(1e-3, 2, 3))
    jstate = jax_init(jm, jax.random.PRNGKey(0), jopt, jplan)
    jstep = jax.jit(jax_build(jm, jopt, jplan))
    tm = Model(get_config(ARCH).reduced(**OVERRIDES), torch.float32, device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jstate["params"]), tm))
    topt = AdamWConfig(lr=cosine_schedule(1e-3, 2, 3))
    tplan = ParallelPlan(**plan)
    tstate = init_train_state(tm, topt, tplan)
    tstep = build_train_step(tm, topt, tplan)
    ref, port = [], []
    for batch in _train_batches(tm.cfg, 3):
        assert batch["patches"].shape == (4, 8, 64)
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm_ = tstep(tstate, batch)
        ref.append((float(jm_["loss"]), float(jm_["grad_norm"])))
        port.append((float(tm_["loss"]), float(tm_["grad_norm"])))
    port = np.array(port)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, np.array(ref), rtol=1e-4, atol=0)
    assert port[-1, 0] < port[0, 0]                      # it learns


def test_train_step_splits_patches_with_tokens():
    """At gas 2 the step's loss is the mean of the two microbatches' losses,
    each on its own rows of the tokens and of the patches."""
    tm = Model(get_config(ARCH).reduced(**OVERRIDES), torch.float32, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = _train_batches(tm.cfg, 1)[0]
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        halves = [float(tm.loss({k: v[i:i + 2] for k, v in t.items()})[0]) for i in (0, 2)]
        swapped = float(tm.loss({"tokens": t["tokens"][:2], "patches": t["patches"][2:]})[0])
    plan = ParallelPlan(gas=2, precision="fp32")
    opt = AdamWConfig(lr=1e-3)
    _, m = build_train_step(tm, opt, plan)(init_train_state(tm, opt, plan), batch)
    np.testing.assert_allclose(float(m["loss"]), np.mean(halves), rtol=1e-6)
    assert abs(swapped - halves[0]) > 1e-5


@pytest.mark.parametrize("backward", [True, False], ids=["train", "forward"])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_train_step_flops_match_jax(reduced, backward):
    """The decoder stream at seq + num_patches positions a row: the
    reference's count at internvl2's full and reduced widths (at 8 x 2048,
    1.8819e14 matmul and 2.5048e13 attention FLOPs a train step)."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    ref = jax_costmodel.train_step_flops(jcfg, 8, 2048, backward=backward)
    out = costmodel.train_step_flops(cfg, 8, 2048, backward=backward)
    for name in ("matmul", "attn", "scan", "tokens"):
        assert getattr(out, name) == pytest.approx(getattr(ref, name), rel=1e-12), name
    if backward and not reduced:
        assert out.matmul == pytest.approx(1.8819e14, rel=1e-4)
        assert out.attn == pytest.approx(2.5048e13, rel=1e-4)


@pytest.mark.parametrize("fault", ["missing", "misshapen"])
def test_from_jax_params_is_strict_on_proj(vlm, fault):
    _, jp, tm = vlm
    tree = jax.tree.map(np.array, jp)
    assert set(from_jax_params(tree, tm)) == set(tm.state_dict())
    if fault == "missing":
        del tree["proj"]
    else:
        tree["proj"] = np.zeros((tm.cfg.d_model, tm.cfg.frontend_dim), np.float32)
    with pytest.raises(KeyError if fault == "missing" else ValueError, match="proj"):
        from_jax_params(tree, tm)


def test_train_launcher_on_cpu(capsys):
    recs = train_launcher.main(["--device", "cpu", "--arch", ARCH, "--reduced",
                                "--steps", "3", "--global-batch", "4", "--seq-len", "16",
                                "--gas", "2", "--kernels", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "kernels=True" in out and out.count("grad_norm") == 3
    assert len(recs) == 3 and all(np.isfinite(r["loss"]) for r in recs)


def test_serve_launcher_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--reduced", "--device", "cpu",
                                      "--requests", "4", "--max-new", "4"])
    serve_launcher.main()
    out = capsys.readouterr().out
    assert "[vlm]" in out and "paged pool" in out and "4 requests" in out
