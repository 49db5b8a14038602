"""The port's moe family against the JAX package on the same numpy inputs and
weights (carried over by ``interop.from_jax_params``): the grouped
expert-MLP entry (CPU tensors -> its plain version) forward and backward
against the Pallas kernel in interpret mode and ``jax.vjp``; the capacity
and grouping maths; ``moe_block`` (out, aux, drop) with drops at the default
capacity factor; ``Model.prefill`` / decode logits and greedy tokens of
llama4-maverick (top-1, shared expert, a dense layer before each MoE layer)
and arctic (top-2, dense residual) reduced, and arctic with ``act="gelu"``;
and the port's ServeEngine against its greedy loop with dropless routing.
fp32 throughout, but for an emulation of the bf16 kernel's arithmetic
(h as bf16 hi + lo planes into an fp32 down product) against the plain
version."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import expertplan as jax_expertplan
from repro.core.compute import ComputePolicy as JaxPolicy
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro.models.common import init_params as jax_init_params
from repro.models.model import Model as JaxModel
from repro.runtime.serve_loop import greedy_generate as jax_greedy_generate
from repro_torch.configs import get_config
from repro_torch.core import expertplan
from repro_torch.core.compute import ComputePolicy
from repro_torch.interop import from_jax_params
from repro_torch.kernels import ops as tops
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.runtime.serve_engine import Request, ServeEngine
from repro_torch.runtime.serve_loop import greedy_generate

# tiny shapes: intra-op threads only add overhead here, and they
# oversubscribe the cores shared by parallel test workers
torch.set_num_threads(1)

LLAMA4, ARCTIC = "llama4-maverick-400b-a17b", "arctic-480b"
# (arch, overrides of .reduced()): arctic with act="gelu" reaches the
# grouped kernel's gelu body, which no config of the repo sets
VARIANTS = {"llama4": (LLAMA4, {}), "arctic": (ARCTIC, {}),
            "arctic_gelu": (ARCTIC, {"act": "gelu"})}
# XLA-CPU and torch-CPU order their matmul sums differently
TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _grouped_inputs(act, seed, E=4, N=37, d=32, F=48):
    """N not a multiple of any tile; about a third of the slots masked, and
    one expert with none valid."""
    x = _rand(seed, E, N, d)
    w1 = _rand(seed + 1, E, d, F, scale=0.1)
    w3 = _rand(seed + 2, E, d, F, scale=0.1) if act == "swiglu" else None
    w2 = _rand(seed + 3, E, F, d, scale=0.1)
    mask = (np.random.RandomState(seed + 4).rand(E, N) > 0.3).astype(np.float32)
    mask[1] = 0.0
    return x, w1, w3, w2, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_grouped_mlp_matches_jax(act):
    x, w1, w3, w2, mask = _grouped_inputs(act, 0)
    ref = np.asarray(jops.grouped_mlp(*(None if a is None else jnp.asarray(a)
                                        for a in (x, w1, w3, w2, mask)), act=act))
    out = tops.grouped_mlp(*map(_t, (x, w1, w3, w2, mask)), act=act).numpy()
    # the reference kernel's own tolerance (tests/test_expertplan.py)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    assert np.all(out[mask == 0.0] == 0.0)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_grouped_mlp_grads_match_jax(act):
    x, w1, w3, w2, mask = _grouped_inputs(act, 10)
    g = _rand(20, *x.shape)
    names = ["x", "w1", "w2"] + (["w3"] if act == "swiglu" else [])

    def f(x, w1, w2, w3=None):
        return jops.grouped_mlp(x, w1, w3, w2, jnp.asarray(mask), act=act)

    args = [x, w1, w2] + ([w3] if act == "swiglu" else [])
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in args))
    ref = dict(zip(names, (np.asarray(t) for t in vjp(jnp.asarray(g)))))
    leaves = {n: torch.from_numpy(a).requires_grad_() for n, a in zip(names, args)}
    mask_t = torch.from_numpy(mask).requires_grad_()
    out = tops.grouped_mlp(leaves["x"], leaves["w1"], leaves.get("w3"), leaves["w2"],
                           mask_t, act=act)
    out.backward(torch.from_numpy(g))
    for n in names:
        np.testing.assert_allclose(leaves[n].grad.numpy(), ref[n], rtol=3e-4, atol=3e-4,
                                   err_msg=n)
    assert np.all(leaves["x"].grad.numpy()[mask == 0.0] == 0.0)
    assert np.all(mask_t.grad.numpy() == 0.0)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10 mantissa bits, to nearest, ties away from
    zero (``cvt.rna.tf32.f32``, the rounding of the bf16 down product
    before the Hopper redesign)."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _grouped_bf16_emulation(x, w1, w3, w2, mask, act, h_as):
    """The bf16 kernel's arithmetic on bf16-valued fp32 tensors: both gate
    products exact in fp32 sums, the activation in fp32, h zero on masked
    rows, then h as ``h_as`` gives it into the down product in fp32 sums,
    times the mask (output rounding left out)."""
    keep = (mask != 0).float()[..., None]
    a = torch.bmm(x, w1)
    h = (torch.nn.functional.silu(a) * torch.bmm(x, w3) if act == "swiglu"
         else torch.nn.functional.gelu(a, approximate="tanh")) * keep
    return sum(torch.bmm(p, w2) for p in h_as(h)) * mask[..., None]


def _hi_lo(h):
    hi = h.bfloat16().float()
    return hi, (h - hi).bfloat16().float()


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_grouped_hi_lo_split_beats_tf32(act):
    """At reduced widths (F 512): h as bf16 hi + lo agrees with
    ``grouped_mlp_ref`` far more closely than h rounded to TF32 does (the
    chip check's h term, kept as an upper bound), and hi alone (h rounded
    to bf16, the chip check's first planted fault) does not; masked rows
    come out exactly 0."""
    from repro_torch.kernels.ref import grouped_mlp_ref

    E, N, d, F = 4, 37, 128, 512
    x, w1, w3, w2, mask = (None if a is None else torch.from_numpy(a)
                           for a in _grouped_inputs(act, 30, E, N, d, F))
    x = x.bfloat16().float()
    w1, w2 = (w.mul(w.shape[1] ** -0.5 / 0.1).bfloat16().float() for w in (w1, w2))
    w3 = None if w3 is None else w3.mul(d ** -0.5 / 0.1).bfloat16().float()
    ref = grouped_mlp_ref(x, w1, w3, w2, mask, act)
    errs = {name: float((_grouped_bf16_emulation(x, w1, w3, w2, mask, act, h_as) - ref)
                        .abs().max())
            for name, h_as in (("hi+lo", _hi_lo), ("tf32", lambda h: (_tf32(h),)),
                               ("hi", lambda h: _hi_lo(h)[:1]))}
    assert errs["hi+lo"] * 16 < errs["tf32"] < errs["hi"], errs
    out = _grouped_bf16_emulation(x, w1, w3, w2, mask, act, _hi_lo)
    assert torch.all(out[mask == 0] == 0)


def test_grouped_mlp_refuses_bad_act():
    x, w1, w3, w2, mask = map(_t, _grouped_inputs("swiglu", 0))
    with pytest.raises(ValueError, match="needs w3"):
        tops.grouped_mlp(x, w1, None, w2, mask, act="swiglu")
    with pytest.raises(ValueError, match="unsupported"):
        tops.grouped_mlp(x, w1, w3, w2, mask, act="relu")


def test_capacity_and_group_shape_match_jax():
    for g in (1, 3, 16, 64, 256, 4096):
        for k in (0, 1, 2, 4):
            for E in (1, 4, 16, 128):
                for cf in (1.0, 1.25, 2.0, 64.0):
                    assert (expertplan.capacity(g, k, E, cf)
                            == jax_expertplan.capacity(g, k, E, cf)), (g, k, E, cf)
    for B in (1, 2, 4):
        for S in (1, 16, 512, 8192, 8193, 12288, 20000):
            assert moe.group_shape(B, S) == jmoe.group_shape(B, S), (B, S)


def _moe_pair(variant, seed):
    arch, over = VARIANTS[variant]
    jcfg = jax_get_config(arch).reduced(**over)
    tcfg = get_config(arch).reduced(**over)
    params = jax.tree.map(np.asarray, jax_init_params(jmoe.moe_specs(jcfg),
                                                      jax.random.PRNGKey(seed)))
    return jcfg, tcfg, params


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_block_matches_jax(variant, kernels):
    """(B, S) = (8, 8): eight routing groups of 8 tokens, where the default
    capacity factor 1.25 leaves 3 (top-1) or 5 (top-2) slots per expert for
    a mean load of 2 or 4, so some assignments are dropped, and the drop
    fraction says so."""
    jcfg, tcfg, params = _moe_pair(variant, 0)
    x = _rand(1, 8, 8, tcfg.d_model)
    out_j, aux_j, drop_j = jmoe.moe_block(jax.tree.map(jnp.asarray, params),
                                          jnp.asarray(x), jcfg,
                                          policy=JaxPolicy(kernels=kernels))
    tparams = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    out_t, aux_t, drop_t = moe.moe_block(tparams, torch.from_numpy(x), tcfg,
                                         policy=ComputePolicy(kernels=kernels))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    assert float(drop_t) == pytest.approx(float(drop_j), abs=1e-7)
    assert float(drop_t) > 0.0


@functools.cache
def _build(variant, kernels, capacity_factor=1.25):
    """The JAX Model and the port's on the same weights (shared between the
    tests of this file, which change neither).  The JAX side runs its plain
    path: its interpret-mode kernels are held against it by its own tests,
    and the grouped one against the port by the tests above."""
    arch, over = VARIANTS[variant]
    over = {**over, "capacity_factor": capacity_factor}
    jm = JaxModel(jax_get_config(arch).reduced(**over), jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(arch).reduced(**over), torch.float32,
               compute=ComputePolicy(kernels=kernels), device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp), tm))
    return jm, jp, tm


def _tokens(seed, B, S, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("variant,kernels", [("llama4", True), ("arctic", True),
                                             ("arctic_gelu", False)])
def test_prefill_decode_match_jax(variant, kernels):
    """Prefill with per-request lengths, then decode steps with a per-slot
    position: last-token logits and the nested KV cache."""
    jm, jp, tm = _build(variant, kernels)
    toks = _tokens(0, 2, 16)
    lens = np.array([11, 16], np.int32)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 24, lens=jnp.asarray(lens))
    lt, ct = tm.prefill({"tokens": torch.from_numpy(toks)}, 24,
                        lens=torch.from_numpy(lens))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for step in range(2):
        tok = _tokens(10 + step, 2, 1)
        lj, cj = jm.decode_step(jp, cj, {"token": jnp.asarray(tok)})
        lt, ct = tm.decode_step(ct, {"token": torch.from_numpy(tok)})
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    flat_j = {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(a)
              for path, a in jax.tree_util.tree_flatten_with_path(cj["layers"])[0]}
    flat_t = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, name)
            else:
                flat_t[name] = v.numpy()
    walk(ct["layers"], "")
    assert flat_t.keys() == flat_j.keys()
    for name in flat_j:
        np.testing.assert_allclose(flat_t[name], flat_j[name], **TOL, err_msg=name)


@pytest.mark.parametrize("variant", ["llama4", "arctic"])
def test_greedy_tokens_match_jax(variant):
    """8 greedy steps for 2 prompts at the default capacity factor, kernels
    on (the CPU takes the grouped kernel's plain version)."""
    jm, jp, tm = _build(variant, True)
    prompt = _tokens(1, 2, 12)
    ref = np.asarray(jax_greedy_generate(jm, jp, jnp.asarray(prompt), 8, 24))
    out = greedy_generate(tm, torch.from_numpy(prompt), 8, 24).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("variant", ["llama4", "arctic"])
def test_engine_matches_greedy(variant):
    """3 requests over 2 slots (a mid-run refill) through the nested paged
    pool: each request's tokens equal its solo greedy stream.  Dropless
    routing (capacity factor 64), as the JAX engine test: only then is a
    request's routing independent of its prefill bucket's padding."""
    _, _, tm = _build(variant, True, capacity_factor=64.0)
    prompts = [_tokens(10 + i, 1, n)[0] for i, n in enumerate([5, 9, 7])]
    refs = [greedy_generate(tm, torch.from_numpy(p)[None], 6, 32)[0].numpy()
            for p in prompts]
    eng = ServeEngine(tm, n_slots=2, cache_len=32, block_size=4)
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=6)
                   for i, p in enumerate(prompts)])
    for i in range(3):
        np.testing.assert_array_equal(out[i], refs[i])

