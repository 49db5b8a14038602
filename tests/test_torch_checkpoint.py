"""The port's checkpoints (``checkpointing/checkpoint.py``) in the
reference's on-disk format: a round trip of fp32, bf16 and int leaves; a
port save read by the reference's ``restore_checkpoint`` and a reference
save read by the port, both equal to the ``interop.from_jax_params``
leaves; the port's msgpack against ``msgpack`` byte for byte; 4 train
steps against 2, a save, a restore into a fresh model and 2 more (the twin
of tests/test_checkpoint.py::test_train_resume_equivalence); and
``launch/train.py --ckpt-dir`` resuming from its latest step.  The
cross-plan resume (saved under dp 2, ZeRO 3, restored under tp 2) rides
tests/test_torch_parallel.py's spawn."""
import random

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpointing import restore_checkpoint as jax_restore
from repro.checkpointing import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamW
from repro.runtime.train_loop import TrainPlan, init_train_state as jax_init_state
from repro_torch.checkpointing import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.checkpointing import msgpack_lite
from repro_torch.configs import get_config
from repro_torch.data import SyntheticCorpus, make_batch_iterator
from repro_torch.interop import flatten_tree, from_jax_params
from repro_torch.launch import train as launcher
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import ParallelPlan, build_train_step, init_train_state

torch.set_num_threads(1)

TINY = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128, vocab_size=128,
            head_dim=32)


def test_roundtrip(tmp_path):
    tree = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                       "layers.k": torch.randn(4, 2).to(torch.bfloat16),
                       "s": torch.tensor(1.5, dtype=torch.bfloat16)},
            "i": torch.arange(3, dtype=torch.int32), "step": 7, "flag": True}
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 7, tree)
    save_checkpoint(d, 12, tree)
    assert latest_step(d) == 12
    like = {"params": {"w": torch.zeros(2, 3), "layers.k": torch.zeros(4, 2, dtype=torch.bfloat16),
                       "s": torch.zeros((), dtype=torch.bfloat16)},
            "i": torch.zeros(3, dtype=torch.int32), "step": 0, "flag": False}
    out = restore_checkpoint(d, 12, like)
    assert out["params"]["w"] is like["params"]["w"]           # in place
    for k in ("w", "layers.k", "s"):
        assert out["params"][k].dtype == tree["params"][k].dtype
        assert torch.equal(out["params"][k], tree["params"][k])
    assert torch.equal(out["i"], tree["i"]) and out["step"] == 7 and out["flag"] is True
    entries = msgpack.unpackb(open(tmp_path / "ckpt" / "step_00000012" / "manifest.msgpack",
                                   "rb").read())["entries"]
    assert [e["key"] for e in entries] == ["flag", "i", "params/layers/k", "params/s",
                                           "params/w", "step"]
    bf = next(e for e in entries if e["key"] == "params/layers/k")
    assert (bf["raw_bytes"], bf["dtype"], bf["shape"]) == (True, "bfloat16", [4, 2])


def _random(rng: random.Random, depth: int = 0):
    """A random value of the manifest's subset of msgpack."""
    kind = rng.randrange(6 if depth < 3 else 4)
    if kind == 0:
        return None
    if kind == 1:
        return rng.random() < 0.5
    if kind == 2:
        return rng.choice([rng.randrange(-2 ** 63, 2 ** 64), rng.randrange(-200, 300),
                           rng.randrange(-70000, 70000), rng.randrange(-2 ** 33, 2 ** 33)])
    if kind == 3:
        return "".join(rng.choice("ab_/.é") for _ in range(rng.choice([0, 5, 15, 31, 32, 120])))
    if kind == 4:
        return [_random(rng, depth + 1) for _ in range(rng.choice([0, 3, 15, 16, 20]))]
    return {str(rng.random()): _random(rng, depth + 1) for _ in range(rng.choice([0, 3, 15]))}


@pytest.mark.parametrize("seed", range(4))
def test_msgpack_writes_and_reads_msgpacks_bytes(seed):
    rng = random.Random(seed)
    for _ in range(100):
        obj = _random(rng)
        packed = msgpack.packb(obj)
        assert msgpack_lite.packb(obj) == packed
        assert msgpack_lite.unpackb(packed) == msgpack.unpackb(packed)
    manifest = {"step": 70000, "entries": [
        {"key": f"params/layers/w{i}", "file": f"params_layers_w{i}.npy",
         "raw_bytes": i % 2 == 0, "shape": [i, 4096, 65536], "dtype": "bfloat16"}
        for i in range(40)]}
    assert msgpack_lite.packb(manifest) == msgpack.packb(manifest)
    assert msgpack_lite.unpackb(msgpack.packb(manifest)) == manifest


@pytest.mark.parametrize("obj,error", [
    (1.5, TypeError), (b"raw", TypeError), ("a" * 256, ValueError),
    ({str(i): i for i in range(16)}, ValueError)], ids=["float", "bin", "str16", "map16"])
def test_msgpack_refuses_what_a_manifest_never_holds(obj, error):
    """Floats, bytes and the headers wider than a manifest needs: packb
    raises, and unpackb raises on msgpack's bytes for them."""
    with pytest.raises(error):
        msgpack_lite.packb(obj)
    with pytest.raises(ValueError, match="manifest's subset"):
        msgpack_lite.unpackb(msgpack.packb(obj))


def _jax_state(cfg_kw, plan_kw):
    jm = JaxModel(jax_get_config("yi-6b").reduced(**cfg_kw), jnp.float32)
    return jm, jax_init_state(jm, jax.random.PRNGKey(0), JaxAdamW(), TrainPlan(**plan_kw))


def _batches(vocab: int, n: int) -> list[dict]:
    it = make_batch_iterator(SyntheticCorpus(vocab_size=vocab), seq_len=32, global_batch=4,
                             prefetch=0)
    return [next(it) for _ in range(n)]


def test_checkpoints_read_across_both_tools(tmp_path):
    """A reference save of its ``init_train_state`` restored by the port
    into a fresh state equals ``from_jax_params`` of its parameters; a port
    save after one step restored by the reference equals the port's
    parameters, moments and counters."""
    plan = dict(gas=1, precision="fp32")
    jm, jstate = _jax_state(TINY, plan)
    ref = flatten_tree(jax.tree.map(np.asarray, jstate["params"]))
    jax_save(str(tmp_path / "ref"), 3, jstate)
    model = Model(get_config("yi-6b").reduced(**TINY), torch.float32, device="cpu")
    want = from_jax_params(ref, model)
    state = init_train_state(model, AdamWConfig(), ParallelPlan(**plan),
                             torch.Generator().manual_seed(5))
    state = restore_checkpoint(str(tmp_path / "ref"), 3, state)
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
    assert state["step"] == 0 and state["opt"]["count"] == 0
    assert state["loss_scale"]["enabled"] is False

    opt = AdamWConfig(lr=1e-3)
    step = build_train_step(model, opt, ParallelPlan(**plan))
    state, _ = step(state, _batches(model.cfg.vocab_size, 1)[0])
    save_checkpoint(str(tmp_path / "port"), 1, state)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)
    back = jax_restore(str(tmp_path / "port"), 1, like)
    for group, mine in (("params", dict(model.named_parameters())),
                        ("mu", state["opt"]["mu"]), ("nu", state["opt"]["nu"])):
        tree = back["params"] if group == "params" else back["opt"][group]
        flat = flatten_tree(jax.tree.map(np.asarray, tree))
        assert flat.keys() == mine.keys()
        for k, v in mine.items():
            np.testing.assert_array_equal(flat[k], v.detach().numpy(), err_msg=f"{group} {k}")
    assert int(back["step"]) == 1 and int(back["opt"]["count"]) == 1
    assert float(back["loss_scale"]["scale"]) == 1.0


def test_train_resume_equivalence(tmp_path):
    """Training 4 steps == training 2, checkpointing, restoring into a fresh
    model and state, training 2."""
    cfg = get_config("yi-6b").reduced(**TINY)
    plan = ParallelPlan(gas=1, precision="fp32")
    opt = AdamWConfig(lr=1e-3)
    batches = _batches(cfg.vocab_size, 4)

    def fresh(seed):
        model = Model(cfg, torch.float32, device="cpu")
        state = init_train_state(model, opt, plan, torch.Generator().manual_seed(seed))
        return model, state, build_train_step(model, opt, plan)

    ref, s, step = fresh(0)
    for b in batches:
        s, _ = step(s, b)
    m2, s2, step2 = fresh(0)
    for b in batches[:2]:
        s2, _ = step2(s2, b)
    d = str(tmp_path / "ck")
    save_checkpoint(d, 2, s2)
    m3, s3, step3 = fresh(1)
    s3 = restore_checkpoint(d, 2, s3)
    for b in batches[2:]:
        s3, _ = step3(s3, b)
    assert s3["step"] == 4 and s3["opt"]["count"] == 4
    for (k, a), b in zip(ref.named_parameters(), m3.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_launcher_resumes_from_its_latest_step(tmp_path):
    args = ["--device", "cpu", "--arch", "yi-6b", "--reduced", "--global-batch", "4",
            "--seq-len", "32", "--gas", "2", "--precision", "fp32", "--log-every", "1"]
    straight = launcher.main(args + ["--steps", "4"])
    d = str(tmp_path / "ck")
    first = launcher.main(args + ["--steps", "2", "--ckpt-dir", d, "--ckpt-every", "2"])
    assert latest_step(d) == 2
    resumed = launcher.main(args + ["--steps", "4", "--ckpt-dir", d, "--ckpt-every", "2"])
    assert [r["step"] for r in resumed] == [3, 4] and latest_step(d) == 4
    assert [r["loss"] for r in first + resumed] == [r["loss"] for r in straight]
    assert [r["grad_norm"] for r in first + resumed] == [r["grad_norm"] for r in straight]
