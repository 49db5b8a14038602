"""Ground rules of the PyTorch/CUDA port: it imports nothing of JAX or of the
JAX package; its entry points refuse to run without a card unless asked for
the CPU; the CPU path never counts a kernel launch and a CUDA wrapper never
takes a CPU tensor; weight carry-over is strict; what the slice does not
cover raises."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.compute import ComputePolicy
from repro_torch.interop import from_jax_params
from repro_torch.kernels import (cross_entropy as ce, flash_attention as fa,
                                 gelu_mlp as gm, grouped_mlp as gp, layernorm as ln, ops,
                                 rmsnorm as rn, ssd_scan as ssd, swiglu as sg,
                                 wkv_scan as wkv)
from repro_torch.models.model import Model
from repro_torch.runtime.train_loop import ParallelPlan

# tiny shapes: intra-op threads only add overhead here, and they
# oversubscribe the cores shared by parallel test workers
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            roots.update(a.value.split(".")[0] for a in node.args
                         if isinstance(a, ast.Constant) and isinstance(a.value, str))
    return roots


def test_port_imports_no_jax_and_no_reference():
    files = (sorted((REPO / "src" / "repro_torch").rglob("*.py"))
             + [REPO / "chip_smoke.py"] + sorted((REPO / "tools").glob("*.py")))
    assert len(files) > 20
    # the measurement and search layer is scanned like the rest
    names = {str(f.relative_to(REPO / "src" / "repro_torch")) for f in files
             if f.is_relative_to(REPO / "src" / "repro_torch")}
    assert {"core/commplan.py", "core/costmodel.py", "core/expertplan.py", "core/telemetry.py",
            "core/hpo.py", "core/sensitivity.py", "analysis/trace.py",
            "analysis/report.py", "analysis/roofline.py", "configs/shapes.py",
            "launch/dryrun.py", "launch/hillclimb.py", "launch/pp_pod.py",
            "checkpointing/checkpoint.py", "checkpointing/msgpack_lite.py"} <= names
    bad = {str(f.relative_to(REPO)): sorted(_imported_roots(f) & set(FORBIDDEN))
           for f in files}
    assert not {f: r for f, r in bad.items() if r}


def _tiny():
    return get_config("yi-6b").reduced()


def test_entry_points_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(_tiny())


def test_launcher_runs_on_cpu_only_when_asked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
           "--requests", "3", "--max-new", "4"]
    ok = subprocess.run(cmd + ["--device", "cpu"], env=env, capture_output=True,
                        text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr
    assert "3 requests" in ok.stdout and "kernels=True" in ok.stdout
    if not torch.cuda.is_available():
        bad = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
        assert bad.returncode != 0 and "device='cpu'" in bad.stderr


def test_cpu_path_launches_no_kernel():
    ops.reset_launch_counts()
    gpt = get_config("gpt-1.4b").reduced(d_model=176, n_heads=2, head_dim=88)
    for cfg in (_tiny(), gpt, get_config("arctic-480b").reduced(act="gelu"),
                get_config("zamba2-2.7b").reduced(), get_config("rwkv6-1.6b").reduced()):
        m = Model(cfg, torch.float32, compute=ComputePolicy(kernels=True),
                  device="cpu").init(torch.Generator().manual_seed(0))
        toks = torch.randint(0, 512, (2, 9), generator=torch.Generator().manual_seed(1))
        logits, cache = m.prefill({"tokens": toks}, 16)
        m.decode_step(cache, {"token": torch.argmax(logits, -1)[:, None]})
        m.requires_grad_(True)
        m.loss({"tokens": toks})[0].backward()
    counts = ops.launch_counts()
    assert set(counts) == {"flash_attention", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv", "rmsnorm", "swiglu",
                           "layernorm", "gelu_mlp", "cross_entropy", "grouped_mlp",
                           "ssd_scan", "mamba_decode_step", "wkv_scan", "wkv_decode_step"}
    assert set(counts.values()) == {0}


@pytest.mark.parametrize("call", [
    lambda x: rn.rmsnorm_cuda(x, torch.ones(64), 1e-5),
    lambda x: sg.swiglu_cuda(x, torch.ones(64, 8), torch.ones(64, 8)),
    lambda x: fa.flash_attention_fwd_cuda(x.reshape(1, 4, 1, 64), x.reshape(1, 4, 1, 64),
                                          x.reshape(1, 4, 1, 64)),
    lambda x: fa.flash_attention_bwd_cuda(*(x.reshape(1, 4, 1, 64),) * 4,
                                          torch.zeros(1, 1, 4), x.reshape(1, 4, 1, 64)),
    lambda x: ce.cross_entropy_cuda(x, torch.ones(64, 8), torch.zeros(4, dtype=torch.long)),
    lambda x: ln.layernorm_cuda(x, torch.ones(64), torch.zeros(64), 1e-5),
    lambda x: gm.gelu_mlp_cuda(x, torch.ones(64, 8)),
    lambda x: gp.grouped_mlp_cuda(x.reshape(1, 4, 64), torch.ones(1, 64, 8),
                                  torch.ones(1, 64, 8), torch.ones(1, 8, 64),
                                  torch.ones(1, 4)),
    lambda x: ssd.ssd_scan_cuda(x.reshape(1, 4, 1, 64), torch.ones(1, 4, 1), x, x,
                                torch.zeros(1), 4),
    lambda x: ssd.mamba_decode_cuda(torch.ones(1, 4, 192), torch.ones(4, 192),
                                    torch.zeros(192), torch.zeros(1, 1), torch.zeros(1),
                                    torch.zeros(1), torch.ones(1), torch.zeros(1, 1, 64, 64),
                                    n_heads=1, head_dim=64),
    lambda x: wkv.wkv_scan_cuda(*(x.reshape(1, 4, 1, 64),) * 4, torch.zeros(1, 64),
                                torch.zeros(1, 1, 64, 64), 4),
    lambda x: wkv.wkv_decode_cuda(*(x[:1].reshape(1, 1, 64),) * 4, torch.zeros(1, 64),
                                  torch.zeros(1, 1, 64, 64)),
    lambda x: ssd.mamba_decode_cuda_(torch.ones(1, 4, 192), torch.ones(4, 192),
                                     torch.zeros(192), torch.zeros(1, 1), torch.zeros(1),
                                     torch.zeros(1), torch.ones(1), torch.zeros(1, 1, 64, 64),
                                     torch.ones(1, dtype=torch.bool), n_heads=1, head_dim=64),
    lambda x: wkv.wkv_decode_cuda_(*(x[:1].reshape(1, 1, 64),) * 4, torch.zeros(1, 64),
                                   torch.zeros(1, 1, 64, 64), torch.ones(1, dtype=torch.bool)),
], ids=["rmsnorm", "swiglu", "flash_attention", "flash_attention_bwd", "cross_entropy",
        "layernorm", "gelu_mlp", "grouped_mlp", "ssd_scan", "mamba_decode_step", "wkv_scan",
        "wkv_decode_step", "mamba_decode_step_", "wkv_decode_step_"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError):
        call(torch.ones(4, 64))


def _numpy_tree(model):
    tree = {}
    for key, t in model.state_dict().items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.zeros(tuple(t.shape), np.float32)
    return tree


@pytest.mark.parametrize("fault", ["missing", "misshapen", "unused"])
def test_from_jax_params_is_strict(fault):
    m = Model(_tiny(), torch.float32, device="cpu")
    tree = _numpy_tree(m)
    assert set(from_jax_params(tree, m)) == set(m.state_dict())
    if fault == "missing":
        del tree["layers"]["mlp"]["w3"]
    elif fault == "misshapen":
        tree["layers"]["attn"]["wq"] = np.zeros((1, 2), np.float32)
    else:
        tree["layers"]["attn"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError if fault != "misshapen" else ValueError):
        from_jax_params(tree, m)


@pytest.mark.parametrize("plan", [
    dict(multi_segment=True),               # the reference's hybrid lowering
    dict(precision="fp16", kernels=True),   # the kernels take bf16 and fp32
], ids=["multi_segment", "fp16_kernels"])
def test_out_of_scope_raises(plan):
    """What the port still refuses, naming ROADMAP.md; every model family
    of the reference is ported, so the refusals are plan fields."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ParallelPlan(**plan)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_functions_carry_gradients(cuda_device):
    """On the card every kernel entry returns an output whose grad_fn is its
    Function, and the backward reaches the flash dQ and dK/dV kernels, at
    head dims 64, 80 and 88; the grouped expert MLP's and the SSD and wkv
    scans' backwards are plain torch."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def leaf(*shape):
        return torch.randn(*shape, device=cuda_device, generator=gen, requires_grad=True)

    x, w, b, w1 = leaf(64, 128), leaf(128), leaf(128), leaf(128, 64)
    q, kv = leaf(1, 64, 4, 64), leaf(1, 64, 2, 64)
    q88, q80 = leaf(1, 64, 2, 88), leaf(1, 64, 2, 80)
    xs, dts = leaf(1, 64, 2, 64), leaf(1, 64, 2)
    bs, cs, alog = leaf(1, 64, 64), leaf(1, 64, 64), leaf(2)
    labels = torch.randint(0, 64, (64,), device=cuda_device, generator=gen)
    xe, we1, we2 = leaf(2, 16, 128), leaf(2, 128, 64), leaf(2, 64, 128)
    mask = (torch.arange(32, device=cuda_device) % 3 > 0).float().reshape(2, 16)
    rr, kk, vv, wl = (leaf(1, 32, 2, 64) for _ in range(4))
    uu, s0 = leaf(2, 64), leaf(1, 2, 64, 64)
    ops.reset_launch_counts()
    outs = [ops.rmsnorm(x, w), sg.swiglu(x, w1, w1),     # ops.swiglu adds a reshape
            ops.layernorm(x, w, b), gm.gelu_mlp_in(x, w1),
            ops.flash_attention(q, kv, kv), ops.flash_attention(q88, q88, q88),
            ops.flash_attention(q80, q80, q80),
            ops.cross_entropy_tokens(x, w1, labels),
            ops.grouped_mlp(xe, we1, we1, we2, mask),
            ops.ssd_scan(xs, dts.abs(), bs, cs, alog, chunk=16)[0],
            ops.wkv_scan(rr, kk, vv, torch.sigmoid(wl), uu, s0, chunk=16)[0]]
    names = ["RMSNormBackward", "SwiGLUBackward", "LayerNormBackward", "GeluMLPBackward",
             "FlashAttentionBackward", "FlashAttentionBackward", "FlashAttentionBackward",
             "CrossEntropyTokensBackward", "GroupedMLPBackward", "SSDScanBackward",
             "WKVScanBackward"]
    for out, name in zip(outs, names):
        assert type(out.grad_fn).__name__ == name
    sum(o.float().square().sum() for o in outs).backward()
    torch.cuda.synchronize()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (x, w, b, w1, q, kv, q88, q80, xe, we1, we2, xs, dts, bs, cs, alog,
                         rr, kk, vv, wl, uu, s0))
    counts = ops.launch_counts()
    assert counts["flash_attention_bwd_dq"] == counts["flash_attention_bwd_dkv"] == 3
    assert min(v for k, v in counts.items()
               if k not in ("mamba_decode_step", "wkv_decode_step")) >= 1
