"""How far bf16 drifts from fp32 through the depth of a recurrent model.

  python3 tools/depth_drift.py [--arch zamba2-2.7b|rwkv6-1.6b]
                                                    (one CUDA card, repo root)

Builds the arch at full width and depth in bf16 from ``chip_smoke.py``'s
serve seed and an fp32 copy of the same weights, prefills two of
``chip_smoke.py``'s prompts for the arch (zamba2: 255 and 32 tokens; rwkv6:
255 and 256, chunks 1 and 32) layer by layer, and prints per layer (every
third) the relative distance ||a - b|| / ||b|| of the hidden states of:

  * bf16 kernels on vs bf16 kernels off,
  * bf16 kernels on and bf16 kernels off vs the fp32 copy (kernels off),
  * bf16 kernels off with only the scan (SSD or wkv) in its kernel vs
    kernels off (an ULP-level change in one kernel, grown by the depth),

and the same distances of the last-token logits as a share of the fp32
copy's logit range.  These readings are why ``chip_smoke.py`` holds
zamba2's bf16 logits to the fp32 copy instead of to kernels off, and decide
whether rwkv6's are held to kernels off.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=[cs.ZAMBA, cs.RWKV], default=cs.ZAMBA)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("depth_drift: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.compute import ComputePolicy
    from repro_torch.kernels import _build, ops
    from repro_torch.models import rwkv, ssm
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cfg = cs.serve_config(args.arch)
    model = Model(cfg, torch.bfloat16, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    m32 = Model(cfg, torch.float32, device="cuda")
    m32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    on, off = ComputePolicy(kernels=True), ComputePolicy(kernels=False)

    hybrid = model.cfg.family == "hybrid"

    @contextlib.contextmanager
    def scan_kernel_only():
        """The plain path with only the scan (SSD or wkv) in its kernel."""
        if hybrid:
            mod, name = ssm, "_ssd_chunked"
            kernel = lambda *a, chunk, policy=None: ops.ssd_scan(*a, chunk=chunk)  # noqa: E731
        else:
            mod, name = rwkv, "_wkv_chunked"
            kernel = lambda *a, policy=None: ops.wkv_scan(*a[:6], chunk=a[6])  # noqa: E731
        plain = getattr(mod, name)
        setattr(mod, name, kernel)
        try:
            yield
        finally:
            setattr(mod, name, plain)

    @torch.no_grad()
    def run(m, pol, toks):
        """Per-layer hidden states (fp32) and last-token logits of the
        model's own prefill loop."""
        m.compute = pol
        params = m._cparams()
        hidden = []
        x = params["embed"][toks]

        def hook(i, h):
            hidden.append(h.float())
        if hybrid:
            x, _ = m._prefill_hybrid(params, x, toks.shape[1], None, layer_hook=hook)
        else:
            x, _ = m._prefill_rwkv(params, x, layer_hook=hook)
        return hidden, m._logits(params, x[:, -1])

    def rel(a, b):
        return [float((x - y).norm() / y.norm()) for x, y in zip(a, b)][::3]

    rng = np.random.RandomState(0)
    lens = cs.SERVE_PROMPT_LENS[args.arch]
    prompts = [rng.randint(0, cfg.vocab_size, int(n)) for n in lens]
    for i in ((0, 5) if hybrid else (0, 6)):
        toks = torch.from_numpy(prompts[i].astype(np.int64))[None].cuda()
        with scan_kernel_only():
            scan_only = run(model, off, toks)
        r = {"on": run(model, on, toks), "off": run(model, off, toks),
             "off+scan kernel": scan_only,
             "fp32": run(m32, off, toks)}
        span = float(r["fp32"][1].abs().max())

        def logits(a, b):
            return float((r[a][1] - r[b][1]).abs().max()) / span

        cs.emit({"arch": args.arch, "prompt_len": int(lens[i]), "layers_every": 3,
                 "hidden_on_vs_off": rel(r["on"][0], r["off"][0]),
                 "hidden_on_vs_fp32": rel(r["on"][0], r["fp32"][0]),
                 "hidden_off_vs_fp32": rel(r["off"][0], r["fp32"][0]),
                 "hidden_scan_kernel_vs_off": rel(r["off+scan kernel"][0], r["off"][0]),
                 "logits_on_vs_off": logits("on", "off"),
                 "logits_on_vs_fp32": logits("on", "fp32"),
                 "logits_off_vs_fp32": logits("off", "fp32"),
                 "logits_scan_kernel_vs_off": logits("off+scan kernel", "off"),
                 "logits_fp32_range": span})
        del r
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    cs.emit({"card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
