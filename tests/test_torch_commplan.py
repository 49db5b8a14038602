"""The port's CommPlan (``runtime/qcollect.py``, the node axis of
``core/sharding.py``, ``launch/mesh.py`` and ``runtime/train_loop.py``)
against the JAX package's, in one process: the int8 block quantizer bit
for bit (an all-zero block takes the 1e-30 scale floor, exact .5 ties
round to even); under ``qcomm="both"`` the fake quantization of the rank's
reduce-scattered gradient block against the reference's of the whole
summed cotangent; the per-leaf decisions (``active``, ``quant``, the
pinned and gathered specs) on the reference's own ``plan_state_shardings``
(an ``AbstractMesh``, no devices); ``zero_partition_spec`` with the node
axis, its composite fallback included; the refusals and the
plan-shape messages; ``hpo.trial_plan`` over ``SPACE_COMM`` draws; the
chunk plan of the overlap.  The plans on 4 gloo ranks are in
tests/test_torch_parallel_tp.py's spawn."""
import itertools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.core import commplan as jcpl
from repro.core import hpo as jhpo
from repro.core import sharding as jshd
from repro.launch import mesh as jmesh
from repro.models.model import Model as JaxModel
from repro.runtime import qcollect as jqc
from repro.runtime.train_loop import ParallelPlan as JaxPlan
from repro.runtime.train_loop import plan_state_shardings as jax_state_shardings
from repro_torch.core import commplan as cpl
from repro_torch.core import hpo
from repro_torch.core import sharding as shd
from repro_torch.launch import mesh
from repro_torch.runtime import qcollect as qc
from repro_torch.runtime.collectives import MeshGroups
from repro_torch.runtime.train_loop import ParallelPlan, plan_state_shardings

import _torch_ranks as ranks


def _quant_input(seed: int = 0) -> np.ndarray:
    """(8, 128) fp32: 32-wide blocks of normal values, one all-zero block,
    and blocks of exact .5 ties (max 127 -> scale 1; max 63.5 -> scale
    0.5)."""
    x = np.random.default_rng(seed).normal(size=(8, 128)).astype(np.float32) * 3.0
    x[1, 32:64] = 0.0
    ties = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 64.5], np.float32)
    x[2, :8] = ties
    x[2, 8:32] = 0.0
    x[3, 64:72] = np.array([63.5, 1.25, -1.75, 0.25, 0.75, -0.25, 31.75, -62.25], np.float32)
    x[3, 72:96] = 0.0
    return x


def test_block_quantize_is_bit_equal_to_the_reference():
    x = _quant_input()
    q, s = qc.block_quantize(torch.from_numpy(x), 32)
    jq, js = jqc.block_quantize(jnp.asarray(x), 32)
    assert q.dtype == torch.int8 and tuple(q.shape) == (8, 4, 32)
    assert s.dtype == torch.float32 and tuple(s.shape) == (8, 4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32), np.asarray(js).view(np.int32))
    assert s[1, 1] == np.float32(1e-30) and not q[1, 1].any()     # the floor
    # half to even: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0, 1.5 -> 2, -126.5 -> -126
    assert q[2, 0, :8].tolist() == [127, 2, -4, 0, 0, 2, -126, 64]
    assert q[3, 2, :8].tolist() == [127, 2, -4, 0, 2, 0, 64, -124]
    deq = qc.block_dequantize(q, s, x.shape, torch.float32)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jqc.block_dequantize(jq, js, x.shape, jnp.float32)))
    np.testing.assert_array_equal(qc.block_fake_quant(torch.from_numpy(x), 32).numpy(),
                                  np.asarray(jqc.block_fake_quant(jnp.asarray(x), 32)))


@pytest.mark.parametrize("dim", [0, 1])
def test_both_fake_quantizes_the_reduce_scattered_block(dim):
    """``qcomm="both"``: the reference fake-quantizes the cotangent of the
    whole leaf, summed over the ranks; the port fake-quantizes each rank's
    block of that sum after the reduce-scatter.  With the leaf split on a
    dim whose blocks hold whole quantization blocks (``quant_eligible``)
    the two are bit-equal; fake-quantizing each rank's partial gradient
    before the sum is not."""
    rng = np.random.default_rng(1)
    partials = rng.normal(size=(4, 8, 128)).astype(np.float32)
    whole = partials.sum(0)
    ref = np.asarray(jqc.block_fake_quant(jnp.asarray(whole), 32))
    quant = qc.QuantGather(32, grads=True)
    blocks = np.split(whole, 4, axis=dim)
    port = np.concatenate([quant.grad(torch.from_numpy(b)).numpy() for b in blocks], axis=dim)
    np.testing.assert_array_equal(port, ref)
    before = sum(qc.block_fake_quant(torch.from_numpy(p), 32).numpy() for p in partials)
    assert not np.array_equal(before, ref)
    g = torch.from_numpy(whole)
    assert qc.QuantGather(32, grads=False).grad(g) is g


def test_quant_gather_round_trip_is_the_dequantize_then_cast():
    x = torch.from_numpy(_quant_input(2))
    quant = qc.QuantGather(32, grads=False)
    q, s = quant.quantize(x)
    assert q.shape == x.shape and q.dtype == torch.int8 and s.shape == (8, 4)
    for dtype in (torch.float32, torch.bfloat16):
        np.testing.assert_array_equal(
            quant.dequantize(q, s, dtype).float().numpy(),
            qc.block_fake_quant(x, 32).to(dtype).float().numpy())


YI = ranks.YI

# (name, reference plan fields, mesh axis sizes in the reference's order)
PLANS = [
    ("dp4 tp2 gather", dict(dp=4, tp=2, zero=3, qcomm="gather"),
     {"pipe": 1, "data": 4, "model": 2}),
    ("dp2 tp2 gather", dict(dp=2, tp=2, zero=3, qcomm="gather"),
     {"pipe": 1, "data": 2, "model": 2}),
    ("node2 dp2 tp2 both overlap", dict(node=2, dp=2, tp=2, zero=3, qcomm="both", overlap=True),
     {"node": 2, "pipe": 1, "data": 2, "model": 2}),
    ("node2 dp2 gather block64", dict(node=2, dp=2, zero=3, qcomm="gather", comm_block=64),
     {"node": 2, "pipe": 1, "data": 2, "model": 1}),
]


def _dotted(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_dotted(v, path) if isinstance(v, dict) else {path: v})
    return out


def _ref_decisions(cfg, fields: dict, sizes: dict):
    """The reference's CommExec over its own plan_state_shardings:
    {leaf: (shape, spec, active, quant, pin, gathered)}."""
    plan = JaxPlan(gas=2, precision="fp32", **fields)
    amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    pshapes, psh, _, _ = jax_state_shardings(JaxModel(cfg, jnp.float32), amesh, plan)
    ce = jqc.CommExec(plan.comm_plan(), amesh, pshapes, psh)
    out = {}
    for k, info in _dotted(ce._info).items():
        pin = jqc._fit_spec(jcpl.pad_spec(info.spec, len(info.shape)), info.shape, amesh)
        out[k] = (tuple(info.shape), tuple(info.spec), info.active, info.quant, pin,
                  jcpl.strip_spec(pin, plan.comm_plan().strip_axes))
    return plan.comm_plan(), out


@pytest.mark.parametrize("name,fields,sizes", PLANS, ids=[p[0] for p in PLANS])
def test_comm_decisions_match_the_reference(name, fields, sizes):
    cfg = jax_get_config("yi-6b").reduced(**YI)
    jcp, ref = _ref_decisions(cfg, fields, sizes)
    cp = ParallelPlan(gas=2, precision="fp32", **fields).comm_plan()
    assert dataclasses_fields(cp) == dataclasses_fields(jcp)
    assert any(r[3] for r in ref.values()) and any(not r[3] for r in ref.values())
    for k, (shape, spec, active, quant, pin, gathered) in ref.items():
        leaf = qc.leaf_decision(cp, shape, spec, sizes)
        assert (leaf.active, leaf.quant, leaf.pin, leaf.gathered) == \
            (active, quant, pin, gathered), k


def dataclasses_fields(cp) -> dict:
    return {k: getattr(cp, k) for k in ("qcomm", "block", "overlap", "overlap_chunks",
                                         "node", "node_axis", "data_axis")}


def test_port_decisions_on_its_own_specs():
    """The executor's CommExec on the port's specs: every leaf that names a
    stripped axis is active, the quantized ones are those of rank >= 2
    (every last dim of the reduced yi tiles into blocks), and each one's
    phases run the node axis first; a layer's view drops the layer dim."""
    plan = ParallelPlan(node=2, dp=2, zero=3, qcomm="gather", gas=2, precision="fp32")
    shapes, psh, _, _ = plan_state_shardings(ranks.config("yi-6b", YI), plan)
    groups = {a: a for a in ("node", "pipe", "data", "expert", "model")}
    fake = MeshGroups(sizes=plan.mesh_sizes(), coord={}, groups=groups, world=None)
    ce = qc.CommExec(plan.comm_plan(), fake, shapes, psh)
    assert psh["final_norm.scale"] == (("data", "node"),)     # the composite fallback
    for k, spec in psh.items():
        info = ce.info[k]
        assert info.active == bool(shd.spec_axes(spec) & {"data", "node"}), k
        assert info.quant == (len(shapes[k]) >= 2 and info.active), k
        assert [a for _, _, a in ce.phases(k)] == ["node", "data"], k
    whole, layer = ce.phases("layers.attn.wq"), ce.phases("layers.attn.wq", lead=1)
    assert [d for _, d, _ in layer] == [d - 1 for _, d, _ in whole]


SHAPES = [(8,), (6, 8), (8, 8), (4, 6), (16, 12, 8), (3, 5), (12, 4), (2, 3, 16)]
BASES = [(), (None, "model"), ("model", None)]


@pytest.mark.parametrize("sizes", [dict(data=2, node=2, model=2), dict(data=4, node=2, model=1),
                                   dict(data=1, node=2, model=2), dict(data=2, node=1, model=2),
                                   dict(data=2, node=3, model=1)],
                         ids=["d2n2m2", "d4n2", "d1n2m2", "d2n1m2", "d2n3"])
def test_zero_partition_spec_with_node_matches_the_reference(sizes):
    fake = types.SimpleNamespace(shape=sizes)
    composite = 0
    for shape, base in itertools.product(SHAPES, BASES):
        base = tuple(base[:len(shape)])
        if any(e == "model" and shape[i] % sizes["model"] for i, e in enumerate(base)):
            continue
        for node_axis in (None, "node"):
            want = tuple(jshd.zero_partition_spec(shape, jax.sharding.PartitionSpec(*base),
                                                  fake, "data", node_axis))
            want += (None,) * (len(shape) - len(want))
            got = shd.zero_partition_spec(shape, base, sizes, "data", node_axis=node_axis)
            assert got == want, (shape, base, node_axis)
            composite += ("data", "node") in got
    if sizes["data"] > 1 and sizes["node"] > 1:
        assert composite            # the fallback is exercised


def test_zero_partition_spec_unit_data_places_node_after_it():
    """The port's one-rank data axis (``unit_axes``) takes the first free
    dim, and the node axis the next one, as at any data width."""
    assert shd.zero_partition_spec((8, 8), (), {"data": 1, "node": 2}, "data",
                                   unit_axes=True, node_axis="node") == ("data", "node")
    assert shd.zero_partition_spec((8,), (), {"data": 1, "node": 2}, "data",
                                   unit_axes=True, node_axis="node") == (("data", "node"),)


@pytest.mark.parametrize("kw", [dict(dp=2, zero=1, qcomm="gather"), dict(dp=2, zero=2, overlap=True),
                                dict(dp=2, pp=2, zero=3, overlap=True), dict(node=0),
                                dict(qcomm="int4", zero=3), dict(comm_block=0, zero=3)],
                         ids=["qcomm-z1", "overlap-z2", "overlap-pp2", "node0", "qcomm-mode",
                              "block0"])
def test_refusals_match_the_reference(kw):
    with pytest.raises(ValueError) as ref:
        JaxPlan(**kw)
    with pytest.raises(ValueError) as port:
        ParallelPlan(**kw)
    assert str(port.value) == str(ref.value)


def test_multi_segment_still_raises_naming_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ParallelPlan(multi_segment=True)


@pytest.mark.parametrize("node,pipe,data,ep,model,n", [
    (2, 1, 2, 1, 2, 4), (2, 2, 1, 1, 1, 8), (3, 1, 1, 2, 1, 4), (1, 1, 2, 1, 2, 6)])
def test_validate_plan_shape_messages(node, pipe, data, ep, model, n):
    """The reference's text up to the count, which names ranks here."""
    with pytest.raises(ValueError) as ref:
        jmesh.validate_plan_shape(pipe, data, model, n, node=node, ep=ep)
    with pytest.raises(ValueError) as port:
        mesh.validate_plan_shape(pipe, data, model, n, node=node, ep=ep)
    assert str(port.value).split(" ranks,")[0] == str(ref.value).split(" devices,")[0]
    mesh.validate_plan_shape(pipe, data, model, node * pipe * data * ep * model, node=node, ep=ep)


def _plan_fields(p) -> dict:
    return {k: getattr(p, k) for k in ("dp", "tp", "pp", "virtual_stages", "ep", "node",
                                       "rules", "zero", "qcomm", "overlap", "comm_block",
                                       "gas", "precision", "remat", "kernels",
                                       "multi_segment", "rule_overrides")}


def test_trial_plan_over_space_comm_matches_the_reference():
    """Every draw of the CommPlan axes builds the reference's plan, field for
    field (node, qcomm and overlap included; downgraded off ZeRO 3 and at
    pp > 1 alike), and the port's plan runs those fields."""
    rng = np.random.default_rng(0)
    seen = set()
    for _ in range(300):
        config = hpo._sample(hpo.SPACE_COMM, rng)
        jp = jhpo.trial_plan(dict(config))
        p = hpo.trial_plan(dict(config))
        assert (p is None) == (jp is None), config
        if p is None:
            continue
        assert _plan_fields(p) == _plan_fields(jp), config
        seen.add((p.node, p.qcomm, p.overlap))
    assert {(2, "gather", True), (2, "both", False), (1, "gather", True)} <= seen


def test_rule_overrides_apply_after_the_preset():
    p = ParallelPlan(dp=2, tp=2, zero=3, rule_overrides=(("vocab", None),))
    jp = JaxPlan(dp=2, tp=2, zero=3, rule_overrides=(("vocab", None),))
    assert p.sharding_rules().rules == jp.sharding_rules().rules
    hier = ParallelPlan(node=2, dp=2, ep=2)
    assert hier.sharding_rules().rules == JaxPlan(node=2, dp=2, ep=2).sharding_rules().rules
    assert hier.batch_axes == ("node", "data", "expert") and hier.batch_ranks == 8
    assert ParallelPlan(node=2, tp=2, rules="tp_only").batch_ranks == 2


def test_gather_bytes_price_unit_axes():
    """``unit_axes`` prices a one-rank phase as the port runs it (its output
    counted); without, it matches the reference's pricing, which drops it."""
    cp = cpl.CommPlan(qcomm="gather")
    shape, spec = (64, 128), ("data", None)
    one = {"data": 1, "model": 1}
    assert cpl.leaf_gather_bytes(shape, spec, one, cp)["total"] == 0.0
    assert cpl.leaf_gather_bytes(shape, spec, one, cp, unit_axes=True)["intra"] == \
        64 * 128 * (1 + 4 / 32)
    hier = {"data": 1, "node": 2}
    got = cpl.leaf_gather_bytes((64, 128), ("data", "node"), hier,
                                cpl.CommPlan(node=2), unit_axes=True)
    assert got == {"intra": 64 * 128 * 4.0, "inter": 64 * 128 * 4.0, "total": 2 * 64 * 128 * 4.0}
    for sizes in ({"data": 2, "node": 2, "model": 2}, {"data": 4, "node": 1}):
        for sp in [("data", "node"), (("data", "node"), None), ("data", "model")]:
            jc = jcpl.CommPlan(qcomm="gather", node=sizes.get("node", 1))
            c = cpl.CommPlan(qcomm="gather", node=sizes.get("node", 1))
            assert cpl.leaf_gather_bytes((64, 128), sp, sizes, c) == \
                jcpl.leaf_gather_bytes((64, 128), sp, sizes, jc)
            if all(v > 1 for v in sizes.values()):      # no one-rank axis to price
                assert cpl.leaf_gather_bytes((64, 128), sp, sizes, c, unit_axes=True) == \
                    jcpl.leaf_gather_bytes((64, 128), sp, sizes, jc)


def test_plan_chunks_is_the_reference_rule():
    info = {"a": qc.Leaf((8, 4), (None, "data"), True, False, (None, "data"), (None, None)),
            "b": qc.Leaf((8, 4), ("pipe", None), False, False, ("pipe", None), ("pipe", None))}
    lc = qc.LayerComm(cpl.CommPlan(overlap=True, overlap_chunks=4), {"pipe": 2, "data": 2},
                      info, torch.float32)
    assert lc.plan_chunks(8) == 4 and lc.plan_chunks(6) == 3
    assert lc.plan_chunks(4) == 2 and lc.plan_chunks(3) == 1 and lc.plan_chunks(1) == 1
