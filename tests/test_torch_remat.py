"""Selective recompute (``core/compute.py``: ``remat="selective"``) against
remat full and none and against the JAX package's selective policy.

Reduced configs in fp32 at 64 tokens or fewer: yi-6b and gpt-1.4b (dense),
zamba2-2.7b (hybrid: its SSD chunk bodies take the policy's own wrapper,
nested in the layer's) and rwkv6-1.6b (rwkv: two wkv chunks at 64 tokens,
each a selective checkpoint inside the layer's).

  * Same losses: selective and none give the port's remat-full trajectory
    within 1e-5, kernels off and on (on the CPU the kernels take their
    plain versions), and the reference's ``remat="selective"`` trajectory
    (its kernels=False step, ``tests/test_compute_policy.py``'s own
    comparison) within 1e-4 (tests/test_torch_train.py's bar across XLA
    and torch).
  * Saved tensors: what ``compute.save_policy`` keeps in one
    layer body (recorded by wrapping it, :func:`saved_products`) is exactly the products without batch dims: their number
    and shapes equal the ``dot_general`` s without batch dims of the
    reference's ``jax.make_jaxpr`` of the same layer body (kernels off); at
    kernels on the kernels' outputs are not among them.  That they are
    kept indeed: the backward runs no product but the gradients' two of
    each, where remat full's recompute runs them again.  A microbatch of
    one row keeps the same set: a batched einsum at batch 1 is not taken
    for a plain product.
  * Saved bytes: full < selective < none.
  * A full (the attention's query-chunk loop) and a selective checkpoint
    nest inside a selective one.
"""
import contextlib
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamW, cosine_schedule as jax_cosine
from repro.runtime.train_loop import (ParallelPlan as JaxPlan,
                                      build_train_step as jax_build,
                                      init_train_state as jax_init)
from repro_torch.configs import get_config
from repro_torch.core import compute
from repro_torch.core.compute import ComputePolicy
from repro_torch.data import SyntheticCorpus, make_batch_iterator
from repro_torch.interop import from_jax_params
from repro_torch.models import layers
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.runtime.train_loop import ParallelPlan, build_train_step, init_train_state

torch.set_num_threads(1)

STEPS, BATCH = 3, 4
# arch -> (reduce overrides, sequence length)
ARCHS = {"yi-6b": ({}, 32), "gpt-1.4b": ({}, 32), "zamba2-2.7b": ({}, 64),
         "rwkv6-1.6b": ({}, 64)}
RTOL_MODES, RTOL_REF = 1e-5, 1e-4


@contextlib.contextmanager
def saved_products():
    """Records (op, output shape, bytes) of every output the selective
    policy saves in the forwards run inside the block: ``save_policy``
    wrapped, its recomputes left out."""
    log, policy = [], compute.save_policy

    def recording(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, b = args[0], args[1]
            shape = (*a.shape[:-1], b.shape[-1])
            log.append((str(op), shape, a.element_size() * torch.Size(shape).numel()))
        return decision
    with mock.patch.object(compute, "save_policy", recording):
        yield log


def _batches(vocab: int, seq: int, n: int = STEPS, batch: int = BATCH) -> list[dict]:
    it = make_batch_iterator(SyntheticCorpus(vocab_size=vocab, seed=0), seq_len=seq,
                             global_batch=batch, prefetch=0)
    return [next(it) for _ in range(n)]


@pytest.fixture(scope="module")
def reference():
    """arch -> (the reference's initial weights, its remat-selective
    trajectory of (loss, grad_norm))."""
    out = {}
    for arch, (ov, seq) in ARCHS.items():
        jm = JaxModel(jax_get_config(arch).reduced(**ov), jnp.float32)
        jplan = JaxPlan(gas=2, precision="fp32", remat="selective")
        jopt = JaxAdamW(lr=jax_cosine(1e-3, 2, STEPS))
        state = jax_init(jm, jax.random.PRNGKey(0), jopt, jplan)
        weights = jax.tree.map(np.asarray, state["params"])
        step = jax.jit(jax_build(jm, jopt, jplan))
        traj = []
        for b in _batches(jm.cfg.vocab_size, seq):
            state, m = step(state, {"tokens": jnp.asarray(b["tokens"])})
            traj.append((float(m["loss"]), float(m["grad_norm"])))
        out[arch] = (weights, np.array(traj))
    return out


def _port(arch: str, weights, remat: str, kernels: bool) -> np.ndarray:
    ov, seq = ARCHS[arch]
    model = Model(get_config(arch).reduced(**ov), torch.float32, device="cpu")
    model.load_state_dict(from_jax_params(weights, model))
    opt = AdamWConfig(lr=cosine_schedule(1e-3, 2, STEPS))
    plan = ParallelPlan(gas=2, precision="fp32", remat=remat, kernels=kernels)
    state, step = init_train_state(model, opt, plan), build_train_step(model, opt, plan)
    traj = []
    for b in _batches(model.cfg.vocab_size, seq):
        state, m = step(state, b)
        traj.append((float(m["loss"]), float(m["grad_norm"])))
    return np.array(traj)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_selective_and_none_match_full_and_reference(reference, arch, kernels):
    weights, ref = reference[arch]
    full = _port(arch, weights, "full", kernels)
    for remat in ("selective", "none"):
        port = _port(arch, weights, remat, kernels)
        np.testing.assert_allclose(port, full, rtol=RTOL_MODES, atol=0, err_msg=remat)
        np.testing.assert_allclose(port, ref, rtol=RTOL_REF, atol=0, err_msg=remat)
    assert full[-1, 0] < full[0, 0]                       # it learns


# ---------------------------------------------------------------------------
# What selective saves
# ---------------------------------------------------------------------------

def _jaxpr_products(jaxpr, mult: int = 1) -> list[tuple]:
    """Output shapes of the executed ``dot_general`` s without batch dims,
    a scan's body counted once per iteration."""
    out = []
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            _, (lb, _) = e.params["dimension_numbers"]
            if not lb:
                out += [tuple(e.outvars[0].aval.shape)] * mult
        m = mult * (e.params["length"] if e.primitive.name == "scan" else 1)
        for v in e.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out += _jaxpr_products(inner, m)
    return out


def _reference_layer_products(arch: str, batch: int, seq: int) -> list[tuple]:
    cfg = jax_get_config(arch).reduced(**ARCHS[arch][0])
    jm = JaxModel(cfg, jnp.float32)
    seg = jm.stage_program(jm.init(jax.random.PRNGKey(0))).segments[0]
    lp = jax.tree.map(lambda a: a[0], seg.params)
    x = jnp.zeros((batch, seq, cfg.d_model), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda lp, x: seg.body(lp, x, {})[0])(lp, x)
    # (B, T, n) -> the port's folded (B*T, n) rows
    return sorted((int(np.prod(s[:-1])), s[-1]) for s in _jaxpr_products(jaxpr.jaxpr))


class _CountMM(TorchDispatchMode):
    """Counts the ``aten.mm`` calls run inside it."""
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _layer_backward(arch: str, batch: int, seq: int, remat: str,
                    kernels: bool) -> tuple[list[tuple], int]:
    """One layer body of the port under ``remat``: (the shapes the selective
    policy records as saved, the ``aten.mm`` calls its backward runs)."""
    cfg = get_config(arch).reduced(**ARCHS[arch][0])
    model = Model(cfg, torch.float32, compute=ComputePolicy(remat, kernels), device="cpu")
    model.init(torch.Generator().manual_seed(0)).requires_grad_(True)
    seg = model.stage_program().segments[0]
    x = torch.randn((batch, seq, cfg.d_model), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    with saved_products() as log:
        y, _ = seg.body(seg.params[0], x, model.stage_program().init_carry())
    with _CountMM() as mm:
        y.sum().backward()
    assert all(op == "aten.mm.default" for op, _, _ in log)
    return sorted(tuple(shape) for _, shape, _ in log), mm.n


def _port_layer_products(arch: str, batch: int, seq: int, kernels: bool) -> list[tuple]:
    """The products selective saves in one layer body.  With kernels off
    they are checked to be kept indeed: the backward runs only the two
    gradient products of each (none recomputed), where remat full's
    recompute runs some again."""
    saved, mm = _layer_backward(arch, batch, seq, "selective", kernels)
    if not kernels:
        _, mm_full = _layer_backward(arch, batch, seq, "full", kernels)
        assert mm == 2 * len(saved) < mm_full
    return saved


# a layer body's products without batch dims, by family (d, heads x hd,
# kv heads x hd, d_ff of the reduced configs): the q/k/v/o projections and
# the MLP's products; zamba2's unit is 2 mamba layers (in_proj, out_proj)
# and the shared attention + SwiGLU block; rwkv6's time mix (wr, wk, wv, wg,
# wo, the decay LoRA's two) and channel mix (wr, wk, wv)
LAYER_PRODUCTS = {"yi-6b": 7, "gpt-1.4b": 6, "zamba2-2.7b": 11, "rwkv6-1.6b": 10}
# with kernels on, the SwiGLU / GELU input half (swiglu: w1 and w3,
# gelu_mlp: w1) is one kernel's output, which is not saved
KERNEL_PRODUCTS = {"yi-6b": 5, "gpt-1.4b": 5, "zamba2-2.7b": 9, "rwkv6-1.6b": 10}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_selective_saves_the_products_without_batch_dims(arch):
    seq = ARCHS[arch][1]
    ref = _reference_layer_products(arch, 2, seq)
    plain = _port_layer_products(arch, 2, seq, kernels=False)
    assert plain == ref and len(plain) == LAYER_PRODUCTS[arch]
    on = _port_layer_products(arch, 2, seq, kernels=True)
    assert len(on) == KERNEL_PRODUCTS[arch] and set(on) <= set(plain)
    # one row: the scans' and the attention's batched einsums reach the
    # policy as bmm of batch 1 and stay recomputed
    assert _port_layer_products(arch, 1, seq, kernels=False) == \
        _reference_layer_products(arch, 1, seq)


def _saved_bytes(arch: str, remat: str) -> int:
    """Bytes kept for the backward of one loss: the tensors autograd saves
    outside any checkpoint (the model's weights excluded; each storage
    once) plus the outputs the selective policy keeps."""
    cfg = get_config(arch).reduced(**ARCHS[arch][0])
    model = Model(cfg, torch.float32, compute=ComputePolicy(remat), device="cpu")
    model.init(torch.Generator().manual_seed(0)).requires_grad_(True)
    weights = {p.untyped_storage().data_ptr() for p in model.parameters()}
    kept = {}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in weights:
            kept[ptr] = t.untyped_storage().nbytes()
        return t
    toks = torch.from_numpy(_batches(cfg.vocab_size, ARCHS[arch][1], 1)[0]["tokens"])
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
            saved_products() as log:
        loss, _ = model.loss({"tokens": toks})
    loss.backward()
    return sum(kept.values()) + sum(b for _, _, b in log)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_saved_bytes_full_selective_none(arch):
    full, sel, none = (_saved_bytes(arch, r) for r in ("full", "selective", "none"))
    assert full < sel < none


def test_checkpoints_nest_inside_selective():
    """The plain attention's always-full query-chunk checkpoint (Sq 2048 >
    Q_CHUNK) and a selective one inside a selective layer: the gradients
    equal remat none's, and only the two projections are kept."""
    gen = torch.Generator().manual_seed(0)
    B, S, H, hd = 1, 2 * layers.Q_CHUNK, 2, 8
    x = torch.randn((B, S, H * hd), generator=gen)
    w1, w2 = (torch.randn((H * hd, H * hd), generator=gen) * 0.2 for _ in range(2))

    def grads(outer: str, inner: str):
        pol_o, pol_i = ComputePolicy(outer), ComputePolicy(inner)
        a, b = w1.clone().requires_grad_(), w2.clone().requires_grad_()
        xi = x.clone().requires_grad_()

        def body(x):
            q = (x @ a).reshape(B, S, H, hd)
            o = layers.attention(q, q, q).reshape(B, S, H * hd)
            return pol_i.checkpoint(lambda t: torch.tanh(t) @ b)(o)
        with saved_products() as log:
            y = pol_o.checkpoint(body)(xi)
        y.square().sum().backward()
        return [t.grad for t in (xi, a, b)], log

    ref, _ = grads("none", "none")
    for inner in ("full", "selective"):
        got, log = grads("selective", inner)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
        assert [shape for _, shape, _ in log[:2]] == [(S, H * hd)] * 2
