"""The encdec family (seamless-m4t-medium) under the port's sharded executor,
on 2 gloo ranks in one spawn: seamless reduced to 4 decoder and 2 encoder
layers over 16 frames (the shape of the reference's
tests/test_stage_program.py), fp32, 3 steps of 8 x 32 tokens with their
frames at gas 2, weights from the reference.  Plans: dp 2 at ZeRO 3 (the
encoder's leaves gathered on use), dp 2 at ZeRO 3 with int8 gathers
(``qcomm="gather"``), tp 2 (the encoder's and the cross blocks' heads
split, the memory into ``wk``/``wv`` through ``copy_to_model``) and pp 2
at 1 and 2 virtual stages (every pipe rank encodes; the encoder's layer
stack, stored split over the pipe ranks, gathered whole over the pipe group
and its gradient reduce-scattered back).

The fp plans give the port's single-device losses and grad norms within
1e-5 and the reference's jitted single-device step's within 1e-4; the
int8 plan's step 0 is the reference's own live quantized plan's within
1e-4 (2 virtual devices in a subprocess, beside the spawn), and every step
within 5% of the fp trajectory.  Each rank's stored parameter and moment
bytes are ``train_state_bytes`` and the reference's.  The bytes moved
equal their predictions: the ZeRO 3 gathers ``costmodel.
predict_comm_bytes``; at pp 2 the ring's sends (the dense family's: the
memory never rides the ring) and the encoder's pipe gather and scatter,
each the whole fp32 encoder stack a step.

The same spawn runs the vlm family (internvl2-2b reduced to 4 layers at its
head dim 128, 8 patches of 64 a row beside the tokens): dp 2 at ZeRO 3
(``proj`` gathered on use), tp 2 (the patch product whole on every model
rank), pp 2 at 1 and 2 virtual stages (stage 0 embeds the patches; every
hand-off carries the patch positions ahead of the text), held to the same
bars; at pp 2 the ring's sends are (b, num_patches + seq, d) fp32."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_jax_ref
import _torch_ranks as ranks
from conftest import REPO
from repro_torch.core import costmodel
from repro_torch.runtime.train_loop import (ParallelPlan, plan_state_shardings,
                                            train_state_bytes)

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
ENC = dict(n_layers=4, enc_layers=2, enc_seq_len=16)
RTOL_PLANS, RTOL_REF = 1e-5, 1e-4
QUANT_DRIFT = 0.05
# name -> the plan's parallel fields (2 ranks each)
FP_PLANS = {"dp2 z3": dict(dp=2, zero=3), "tp2": dict(tp=2), "pp2": dict(pp=2),
            "pp2 v2": dict(pp=2, virtual_stages=2)}
QUANT_PLANS = {"dp2 z3 gather": dict(dp=2, zero=3, qcomm="gather")}
PLANS = {**FP_PLANS, **QUANT_PLANS}
VLM_ARCH = "internvl2-2b"
VLM = dict(n_layers=4, head_dim=128)
VLM_PLANS = {f"vlm {name}": plan for name, plan in FP_PLANS.items()}

LIVE_CODE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import mesh_for_plan
from repro.models.model import Model
from repro.optim import AdamWConfig
from repro.runtime.train_loop import (ParallelPlan, init_train_state, jit_train_step,
                                      train_state_bytes)
ov, plans, live, lr, path = json.loads(sys.argv[1])
data = np.load(path)
model = Model(get_config("seamless-m4t-medium").reduced(**ov), jnp.float32)
opt = AdamWConfig(lr=lr)
out = {"bytes": {}, "live": {}}
for name, kw in plans.items():
    plan = ParallelPlan(gas=2, precision="fp32", **kw)
    out["bytes"][name] = {k: int(v) for k, v in
                          train_state_bytes(model, mesh_for_plan(plan), plan).items()}
for name, kw in live.items():
    plan = ParallelPlan(gas=2, precision="fp32", **kw)
    state = init_train_state(model, jax.random.PRNGKey(0), opt, plan)
    step = jit_train_step(model, opt, plan, mesh_for_plan(plan), *data["tokens"].shape[1:])
    traj = []
    for t, f in zip(data["tokens"], data["frames"]):
        state, m = step(state, {"tokens": jnp.asarray(t), "frames": jnp.asarray(f)})
        traj.append([float(m["loss"]), float(m["grad_norm"])])
    out["live"][name] = traj
print("LIVE" + json.dumps(out))
"""


def _plan(**kw):
    return dict(gas=2, precision="fp32", **kw)


def _start_reference(tmp):
    """The reference's train-state bytes of every plan and its live
    quantized plan, in a subprocess of 2 virtual devices."""
    path = os.path.join(str(tmp), "batches.npz")
    bs = ranks.batches(512, ranks.STEPS, ranks.config(ARCH, ENC))
    np.savez(path, tokens=np.stack([b["tokens"] for b in bs]),
             frames=np.stack([b["frames"] for b in bs]))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.Popen([sys.executable, "-c", LIVE_CODE,
                             json.dumps([ENC, PLANS, QUANT_PLANS, ranks.LR, path])],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    proc = _start_reference(tmp)
    weights, ref = _torch_jax_ref.reference(ARCH, ENC, _plan())
    single = ranks.single_device(ARCH, ENC, weights, _plan())
    vlm_weights, vlm_ref = _torch_jax_ref.reference(VLM_ARCH, VLM, _plan())
    vlm_single = ranks.single_device(VLM_ARCH, VLM, vlm_weights, _plan())
    jobs = [{"name": name, "arch": ARCH, "overrides": ENC, "weights": "seamless",
             "plan": _plan(**plan)} for name, plan in PLANS.items()]
    jobs += [{"name": name, "arch": VLM_ARCH, "overrides": VLM, "weights": "vlm",
              "plan": _plan(**plan)} for name, plan in VLM_PLANS.items()]
    res = ranks.run_ranks(2, jobs, {"seamless": weights, "vlm": vlm_weights}, str(tmp))
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-4000:]
    for name, by_rank in res.items():
        for r, v in by_rank.items():
            assert "error" not in v, (name, r, v.get("error"))
    return {"ref": ref, "single": single, "ranks": res, "weights": weights,
            "reference": json.loads(out.split("LIVE")[-1]),
            "vlm": {"ref": vlm_ref, "single": vlm_single}}


def _traj(res):
    return np.array([t[:2] for t in res["trajectory"]])


@pytest.mark.parametrize("job", sorted(FP_PLANS) + sorted(VLM_PLANS))
def test_plans_match_single_device_and_jax(runs, job):
    held = runs["vlm"] if job in VLM_PLANS else runs
    single = np.array([t[:2] for t in held["single"][0]])
    by_rank = runs["ranks"][job]
    for r, res in by_rank.items():
        port = _traj(res)
        np.testing.assert_allclose(port, single, rtol=RTOL_PLANS, atol=0,
                                   err_msg=f"{job} rank {r}")
        np.testing.assert_allclose(port, held["ref"], rtol=RTOL_REF, atol=0,
                                   err_msg=f"{job} rank {r} against the reference")
    assert all(res["trajectory"] == by_rank[0]["trajectory"] for res in by_rank.values())
    assert _traj(by_rank[0])[-1, 0] < _traj(by_rank[0])[0, 0]


def test_quantized_gathers_match_the_live_reference(runs):
    """qcomm gather: step 0 within 1e-4 of the reference's live plan (the
    same int8-rounded weights), every step within 5% of the fp
    trajectory, and not equal to it."""
    live = np.array(runs["reference"]["live"]["dp2 z3 gather"])
    fp = np.array([t[:2] for t in runs["single"][0]])
    by_rank = runs["ranks"]["dp2 z3 gather"]
    for r, res in by_rank.items():
        port = _traj(res)
        np.testing.assert_allclose(port[0], live[0], rtol=RTOL_REF, atol=0, err_msg=f"rank {r}")
        assert (np.abs(port[:, 0] - fp[:, 0]) / fp[:, 0]).max() < QUANT_DRIFT
        assert not np.array_equal(port[:, 0], fp[:, 0])
    assert (np.abs(live[:, 0] - fp[:, 0]) / fp[:, 0]).max() < QUANT_DRIFT
    assert all(res["trajectory"] == by_rank[0]["trajectory"] for res in by_rank.values())


@pytest.mark.parametrize("job", sorted(PLANS))
def test_state_bytes_equal_train_state_bytes_and_jax(runs, job):
    """Each rank's stored fp32 parameters and Adam moments are
    ``train_state_bytes``, and that is the reference's; at pp 2 the
    encoder's layer stack is split over the pipe ranks (1 of 2 layers
    each), whatever the virtual stages."""
    cfg = ranks.config(ARCH, ENC)
    want = train_state_bytes(cfg, ParallelPlan(**_plan(**PLANS[job])))
    assert {k: v for k, v in want.items() if k != "zero"} == \
        {k: v for k, v in runs["reference"]["bytes"][job].items() if k != "zero"}
    for res in runs["ranks"][job].values():
        assert 4 * sum(int(np.prod(b.shape)) for b in res["blocks"].values()) \
            == want["param_bytes"]
        assert 2 * 4 * sum(int(np.prod(s)) for s in res["moments"].values()) \
            == want["opt_bytes"]
        if PLANS[job].get("pp"):
            assert res["blocks"]["encoder.layers.attn.wq"].shape[0] == cfg.enc_layers // 2


def test_pipelined_bytes_equal_the_prediction(runs):
    """At pp 2 each rank sends (n_stages - 1) x 2 / pp activations or
    gradients of (b, seq, d) fp32 a microbatch (the memory rides no ring),
    and gathers and reduce-scatters the whole fp32 encoder layer stack once
    a step, whatever the virtual stages."""
    cfg = ranks.config(ARCH, ENC)
    shapes, _, _, _ = plan_state_shardings(cfg, ParallelPlan(**_plan(pp=2)))
    enc = 4 * sum(int(np.prod(s)) for k, s in shapes.items() if k.startswith("encoder.layers."))
    gas, b = 2, ranks.BATCH // 2
    for job, v in (("pp2", 1), ("pp2 v2", 2)):
        sends = gas * (2 * v - 1) * 2 // 2 * b * ranks.SEQ * cfg.d_model * 4
        for res in runs["ranks"][job].values():
            for step in res["comm_bytes"]:
                assert step["send"] == sends
                assert step["pipe_gather"] == step["pipe_scatter"] == enc
    for res in runs["ranks"]["dp2 z3"].values():
        assert all(step["pipe_gather"] == step["pipe_scatter"] == 0
                   for step in res["comm_bytes"])


def test_vlm_pipelined_sends_carry_the_patch_positions(runs):
    """At pp 2 a vlm hand-off is (b, num_patches + seq, d) fp32: the patch
    positions ride the ring ahead of the text; ``proj`` is kept whole on
    both pipe ranks, as ``embed`` is."""
    cfg = ranks.config(VLM_ARCH, VLM)
    gas, b = 2, ranks.BATCH // 2
    for job, v in (("vlm pp2", 1), ("vlm pp2 v2", 2)):
        sends = gas * (2 * v - 1) * b * (cfg.num_patches + ranks.SEQ) * cfg.d_model * 4
        for res in runs["ranks"][job].values():
            assert all(step["send"] == sends for step in res["comm_bytes"])
            assert res["blocks"]["proj"].shape == (cfg.frontend_dim, cfg.d_model)


@pytest.mark.parametrize("job", ["dp2 z3", "dp2 z3 gather"])
def test_zero3_gather_bytes_equal_the_costmodel(runs, job):
    """Each step's ZeRO 3 gather bytes: both layer stacks (the decoder's and
    the encoder's) gathered twice a microbatch (the forward and the
    recompute), every other leaf once, int8 payloads under qcomm."""
    cfg = ranks.config(ARCH, ENC)
    p = ParallelPlan(**_plan(**PLANS[job]))
    shapes, psh, _, _ = plan_state_shardings(cfg, p)
    stacked = {k for k in shapes if k.startswith(("layers.", "encoder.layers."))}

    def predicted(keys, multiplier):
        return costmodel.predict_comm_bytes([shapes[k] for k in keys], [psh[k] for k in keys],
                                            p.mesh_sizes(), p.comm_plan(), itemsize=4,
                                            multiplier=multiplier, unit_axes=True)
    a, b = predicted(sorted(stacked), 2 * p.gas), predicted(sorted(set(shapes) - stacked), p.gas)
    for res in runs["ranks"][job].values():
        for step in res["comm_bytes"]:
            assert step["zero3_gather"] == a["total"] + b["total"]
