"""Readings of the recurrent families' decode steps on the card: the mamba
decode step (zamba2: 4 slots, 80 heads, P = N = 64, a bf16 and an fp32
window) and the wkv decode step (rwkv6: 4 slots, 32 heads, K = V = 64,
fp32), and of what the layer pays for the state beside them.

  python3 tools/decode_readings.py [--serve zamba2-2.7b rwkv6-1.6b]
                                      (one CUDA card, from the repo root)

For each step it prints, from ``chip_smoke.Timer.readings``: ``ms`` (CUDA
events around one call, the L2 flushed before it), ``device_ms`` and
``kernels_per_call`` (``torch.profiler``, the same flush, the flush's own
kernels left out) and ``host_us`` (the host's time a call, no
synchronize), for
- ``pure``: the wrapper that writes a fresh state;
- ``masked_copy``: ``models.model._masked_copy`` of the state leaf with
  slot 3 inactive, which the model ran after a pure step;
- ``pure_and_masked_copy``: both, with dt_raw a strided slice of in_proj's
  output as the mamba layer hands it over: the state's update as the layer
  paid it before the in-place form;
- ``in_place``: the in-place wrapper on the cache's state with slot 3
  inactive (dt_raw strided as above);
and the split of each wrapper's host time (``host_split_us``): the wrapper
with its C entry replaced by a stub that launches nothing, and the C
entry alone with the arguments the wrapper passed it.  With ``--serve``,
each arch at full width and depth in bf16 through ``ServeEngine`` (4
slots; 4 prefills of the first four prompts of ``chip_smoke.py``'s serve
run, one tick, then 8 ticks), as ``chip_smoke.phase_profile`` profiles it:
the decode tick's wall and device time, the device's idle share and its
kernels per tick.  Each reading is one JSON line.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

H_MAMBA, P_MAMBA = 80, 64    # zamba2's SSM heads and head dim


class _Recorder:
    """A stand-in for a kernel library: ``entry`` records its arguments and
    launches nothing; every other attribute is the library's."""

    def __init__(self, lib, entry: str):
        self.lib, self.entry, self.args = lib, entry, None

    def __getattr__(self, name):
        if name == self.entry:
            return self._record
        return getattr(self.lib, name)

    def _record(self, *args):
        self.args = args
        return 0


def host_split(module, entry: str, call) -> dict:
    """``call``'s host time without its C entry's launch, and the C entry
    alone on the arguments the wrapper gave it."""
    own = module._lib
    rec = _Recorder(own(), entry)
    module._lib = lambda: rec
    try:
        no_launch = cs.Timer.host_us(call)
        kept = call()        # the outputs that the recorded arguments point to stay alive
    finally:
        module._lib = own
    c_entry = getattr(own(), entry)
    res = {"wrapper_without_launch_us": no_launch,
           "c_entry_us": cs.Timer.host_us(lambda: c_entry(*rec.args))}
    del kept
    return res


def mamba_readings(timer: cs.Timer, args: dict) -> dict:
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models.model import _masked_copy

    dims = dict(n_heads=H_MAMBA, head_dim=P_MAMBA)
    active = torch.tensor([True, True, True, False], device="cuda")
    layer_args = dict(args, dt_raw=cs.strided_dt(args["dt_raw"]))
    cache = {"state": args["state"].clone()}
    new = ssd.mamba_decode_cuda(**args, **dims)[1]
    out = {"pure": timer.readings(lambda: ssd.mamba_decode_cuda(**args, **dims)),
           "masked_copy": timer.readings(lambda: _masked_copy(cache, {"state": new}, active))}

    def as_before():
        _masked_copy(cache, {"state": ssd.mamba_decode_cuda(**layer_args, **dims)[1]}, active)
    out["pure_and_masked_copy"] = timer.readings(as_before)

    def in_place():
        return ssd.mamba_decode_cuda_(**dict(layer_args, state=cache["state"]), active=active,
                                      **dims)
    out["in_place"] = timer.readings(in_place)
    out["host_split_us"] = {"pure": host_split(ssd, "mamba_decode_fwd",
                                               lambda: ssd.mamba_decode_cuda(**args, **dims)),
                            "in_place": host_split(ssd, "mamba_decode_fwd", in_place)}
    return out


def wkv_readings(timer: cs.Timer, args: tuple) -> dict:
    from repro_torch.kernels import wkv_scan as wkv
    from repro_torch.models.model import _masked_copy

    active = torch.tensor([True, True, True, False], device="cuda")
    *inputs, state = args
    cache = {"state": state.clone()}
    new = wkv.wkv_decode_cuda(*args)[1]
    out = {"pure": timer.readings(lambda: wkv.wkv_decode_cuda(*args)),
           "masked_copy": timer.readings(lambda: _masked_copy(cache, {"state": new}, active))}

    def as_before():
        _masked_copy(cache, {"state": wkv.wkv_decode_cuda(*args)[1]}, active)
    out["pure_and_masked_copy"] = timer.readings(as_before)

    def in_place():
        return wkv.wkv_decode_cuda_(*inputs, cache["state"], active)
    out["in_place"] = timer.readings(in_place)
    out["host_split_us"] = {"pure": host_split(wkv, "wkv_decode_fwd",
                                               lambda: wkv.wkv_decode_cuda(*args)),
                            "in_place": host_split(wkv, "wkv_decode_fwd", in_place)}
    return out


def serve_tick(arch: str, ticks: int = 8) -> dict:
    from repro_torch.core.compute import ComputePolicy
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve_engine import Request, ServeEngine

    cfg = cs.serve_config(arch)
    model = Model(cfg, torch.bfloat16, compute=ComputePolicy(kernels=True), device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in cs.SERVE_PROMPT_LENS[arch]]
    engine = ServeEngine(model, n_slots=4, cache_len=512, block_size=16)
    for i in range(4):
        engine.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=16))
    engine.step()                                      # 4 prefills + 1 tick
    dec = cs._profile(lambda: [engine.step() for _ in range(ticks)])
    res = {"serve": arch, "layers": cfg.n_layers, "ticks": ticks, "n_slots": 4,
           "wall_ms_per_tick": dec["wall_s"] / ticks * 1e3}
    if "device_kernels" in dec:
        res.update(device_ms_per_tick=dec["device_busy_s"] / ticks * 1e3,
                   device_idle_share=dec["device_idle_share"],
                   device_kernels_per_tick=dec["device_kernels"] / ticks,
                   device_ms_by_group=dec["device_ms_by_group"])
    else:
        res.update(device_ms_per_tick="not measured")
    del model, engine
    torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", nargs="*", default=[], choices=[cs.ZAMBA, cs.RWKV],
                    help="also profile these archs' decode ticks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_readings: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    _build.build_all(("ssd_scan", "wkv_scan"))
    timer = cs.Timer()
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            cs.emit({"step": "mamba_decode_step", "window": str(dtype)[6:],
                     "state": [4, H_MAMBA, P_MAMBA, 64], "card": card,
                     **mamba_readings(timer, cs.decode_inputs(gen, 4, dtype))})
        r, k, v, w, u, state = cs.wkv_inputs(gen, 4, 1)
        cs.emit({"step": "wkv_decode_step", "state": list(state.shape), "card": card,
                 **wkv_readings(timer, (r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, state))})
    del timer
    for arch in args.serve:
        cs.emit({**serve_tick(arch), "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
