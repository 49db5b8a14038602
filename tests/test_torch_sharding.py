"""The port's jax-free copies of the sharding rules and the ZeRO byte
accounting against the JAX package's originals on the same shapes: every
leaf of yi-6b and gpt-1.4b reduced under the four presets at dp in {2, 4}
x tp in {1, 2, 4}; zero_divisors and Table II's bytes per parameter; and
each rank's train-state bytes at dp = 2 x tp = 2 and at pp = 2 x dp = 2
(the layer stack on the pipe axis), ZeRO 0-3, against the reference's
``train_state_bytes`` on 4 host devices; zamba2-2.7b reduced at dp = 2 x
tp = 2, whose regrouped in_proj and conv blocks hold the B and C columns
whole on every model rank: its parameters exceed the reference's even
split by exactly 2N (1 - 1/tp)(d + K + 1) a mamba layer; llama4-maverick and
arctic reduced at the multi-rank tests' moe plans (ep 4, ep 2 x dp 2,
ep 2 x tp 2, ep 2 x pp 2, dp 4), ZeRO 0-3, equal to the reference's."""
import json
import types

import pytest

from repro.configs import get_config as jax_get_config
from repro.core import memplan as jax_memplan
from repro.core import sharding as jax_sharding
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.core import memplan, sharding
from repro_torch.models.common import flatten_specs
from repro_torch.models.model import param_specs
from repro_torch.runtime.train_loop import ParallelPlan, train_state_bytes

ARCHS = ["yi-6b", "gpt-1.4b"]
MESHES = [(dp, tp) for dp in (2, 4) for tp in (1, 2, 4)]


def _leaves(arch):
    ours = dict(flatten_specs(param_specs(get_config(arch).reduced())))
    import jax
    ref = JaxModel(jax_get_config(arch).reduced()).param_specs()
    flat = {".".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                ref, is_leaf=lambda x: hasattr(x, "axes"))[0]}
    assert flat.keys() == ours.keys()
    return ours, flat


@pytest.mark.parametrize("preset", sorted(sharding.PRESETS))
@pytest.mark.parametrize("dp,tp", MESHES, ids=[f"dp{d}tp{t}" for d, t in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_partition_specs_equal_reference(arch, dp, tp, preset):
    sizes = {"pipe": 1, "data": dp, "model": tp}
    mesh = types.SimpleNamespace(shape=sizes)       # all the reference reads of a Mesh
    rules = sharding.PRESETS[preset]()
    ref_rules = jax_sharding.PRESETS[preset]()
    assert dict(rules.rules) == dict(ref_rules.rules)
    ours, ref = _leaves(arch)
    for path, spec in ours.items():
        base = sharding.partition_spec(spec.shape, spec.axes, sizes, rules)
        rbase = jax_sharding.partition_spec(ref[path].shape, ref[path].axes, mesh, ref_rules)
        assert base == tuple(rbase), path
        assert (sharding.zero_partition_spec(spec.shape, base, sizes, "data")
                == tuple(jax_sharding.zero_partition_spec(ref[path].shape, rbase, mesh,
                                                          "data"))), path


@pytest.mark.parametrize("zero", memplan.STAGES)
def test_byte_accounting_equals_reference(zero):
    for dp in (1, 2, 8):
        assert memplan.zero_divisors(zero, dp) == jax_memplan.zero_divisors(zero, dp)
        assert (memplan.table2_bytes_per_param(zero, dp)
                == jax_memplan.table2_bytes_per_param(zero, dp))
    assert memplan.resolve_stage(None) == jax_memplan.resolve_stage(None) == 1


STATE_BYTES_CODE = '''
import json, jax.numpy as jnp
from repro.configs import get_config
from repro.models.model import Model
from repro.runtime.train_loop import ParallelPlan, train_state_bytes
from repro.launch.mesh import mesh_for_plan
cfg = get_config("yi-6b").reduced(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                                  d_ff=256, vocab_size=256, head_dim=32)
out = {}
for z in (0, 1, 2, 3):
    plan = ParallelPlan(%s, zero=z, precision="fp32")
    out[z] = train_state_bytes(Model(cfg, jnp.float32), mesh_for_plan(plan), plan)
print("BYTES", json.dumps(out))
'''


def _state_bytes_match(multidev, mesh: dict):
    out = multidev(STATE_BYTES_CODE % ", ".join(f"{k}={v}" for k, v in mesh.items()),
                   n_devices=4)
    ref = json.loads(out.split("BYTES", 1)[1])
    cfg = get_config("yi-6b").reduced(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                                      d_ff=256, vocab_size=256, head_dim=32)
    for z in memplan.STAGES:
        ours = train_state_bytes(cfg, ParallelPlan(**mesh, zero=z, precision="fp32"))
        assert ours == {k: int(v) for k, v in ref[str(z)].items()}, z


def test_train_state_bytes_equal_reference(multidev):
    _state_bytes_match(multidev, dict(dp=2, tp=2))


def test_pipelined_train_state_bytes_equal_reference(multidev):
    """pp = 2 x dp = 2: each pipe rank stores half of the layer stack and
    the embedding, final norm and lm_head whole; ZeRO's data axis lands
    past the layer dim (the reference's first free dim there too)."""
    _state_bytes_match(multidev, dict(pp=2, dp=2))


ZAMBA_BYTES_CODE = '''
import json, jax.numpy as jnp
from repro.configs import get_config
from repro.models.model import Model
from repro.runtime.train_loop import ParallelPlan, train_state_bytes
from repro.launch.mesh import mesh_for_plan
cfg = get_config("zamba2-2.7b").reduced(n_layers=4)
out = {}
for z in (0, 1, 2, 3):
    plan = ParallelPlan(dp=2, tp=2, zero=z, precision="fp32")
    out[z] = train_state_bytes(Model(cfg, jnp.float32), mesh_for_plan(plan), plan)
print("BYTES", json.dumps(out))
'''


def test_regrouped_state_bytes_exceed_reference_by_the_bc_columns(multidev):
    """The reference splits in_proj's fused [z | x | B | C | dt] columns and
    the conv's [x | B | C] channels evenly; the port's rank holds its heads'
    z, x, dt and the B and C columns whole: 2N (1 - 1/tp)(d + K + 1) more
    parameters a mamba layer (246,240 for zamba2-2.7b at tp 4).  At ZeRO 0
    every state class differs by exactly that; at stages 1-2 the stored
    parameters still do (ZeRO's data axis then lands on other dims of the
    layer-stacked (L, H) leaves, past the layer dim in the port)."""
    out = multidev(ZAMBA_BYTES_CODE, n_devices=4)
    ref = json.loads(out.split("BYTES", 1)[1])
    cfg = get_config("zamba2-2.7b").reduced(n_layers=4)
    tp, N = 2, cfg.ssm_state
    extra = 4 * cfg.n_layers * (2 * N - 2 * N // tp) * (cfg.d_model + cfg.conv_kernel + 1)
    assert extra == 4 * 4 * 16 * 261
    for z in memplan.STAGES:
        ours = train_state_bytes(cfg, ParallelPlan(dp=2, tp=2, zero=z, precision="fp32"))
        theirs = {k: int(v) for k, v in ref[str(z)].items()}
        if z < 3:
            assert ours["param_bytes"] - theirs["param_bytes"] == extra, z
        if z == 0:
            assert ours["grad_bytes"] - theirs["grad_bytes"] == extra
            assert ours["opt_bytes"] - theirs["opt_bytes"] == 2 * extra


MOE_BYTES_CODE = '''
import json, jax.numpy as jnp
from repro.configs import get_config
from repro.models.model import Model
from repro.runtime.train_loop import ParallelPlan, train_state_bytes
from repro.launch.mesh import mesh_for_plan
out = {}
for arch, ov in %s:
    cfg = get_config(arch).reduced(**ov)
    for name, plan in %s:
        for z in (0, 1, 2, 3):
            p = ParallelPlan(**plan, zero=z, precision="fp32")
            out[f"{arch} {name} {z}"] = train_state_bytes(Model(cfg, jnp.float32),
                                                          mesh_for_plan(p), p)
print("BYTES", json.dumps(out))
'''


def test_moe_train_state_bytes_equal_reference(multidev):
    """The moe family's plans of the multi-rank tests (tests/_torch_ranks.py:
    MOE_PLANS) at ZeRO 0-3 on 4 host devices: at ep > 1 the expert leaves
    on the expert axis, at ep = 1 on the data axis, ZeRO adding the data
    axis only; every state class's bytes per rank equal the reference's."""
    import _torch_ranks as ranks

    plans = {k: v for k, v in ranks.MOE_PLANS.items() if "zero" not in v}
    out = multidev(MOE_BYTES_CODE % (sorted(ranks.MOE.items()), sorted(plans.items())),
                   n_devices=4)
    ref = json.loads(out.split("BYTES", 1)[1])
    assert len(ref) == len(ranks.MOE) * len(plans) * 4
    for arch, ov in ranks.MOE.items():
        cfg = get_config(arch).reduced(**ov)
        for name, plan in plans.items():
            for z in memplan.STAGES:
                ours = train_state_bytes(cfg, ParallelPlan(**plan, zero=z, precision="fp32"))
                assert ours == {k: int(v) for k, v in ref[f"{arch} {name} {z}"].items()}, \
                    (arch, name, z)
