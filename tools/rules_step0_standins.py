"""CPU stand-ins for chip_smoke's step-0 limits of the rules plans
(``TP_STEP0_RTOL`` for yi-6b and arctic-480b): bf16 step 0 of each plan on
4 gloo ranks against one process on the same weights, over seeds 0-4,
kernels off and on (their plain versions on the CPU; the card runs them
on).
yi-6b reduced to 2 and 4 layers of d 256 under ``seq_shard`` at tp 4 and
``fsdp_seq`` at dp 2 x tp 2; arctic reduced to 2 layers of d 256 with 8
experts under ``moe_dp_attn`` and ``ep_model`` at tp 4.  Prints each reading (relative loss and grad-norm differences) and,
last, the largest of each plan over the seeds as one JSON line; the limits
are the larger of 1.5x those and ``STEP0_RTOL``.

  PYTHONPATH=src python3 tools/rules_step0_standins.py      # ~5 minutes, 8 cores
"""
import json
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import _torch_ranks as ranks  # noqa: E402
from repro_torch.launch.hillclimb import VARIANTS  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.runtime.train_loop import ParallelPlan  # noqa: E402

D256 = dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64)
MODELS = {"yi 2 layers": ("yi-6b", dict(D256, n_layers=2, d_ff=512, vocab_size=512)),
          "yi 4 layers": ("yi-6b", dict(D256, n_layers=4, d_ff=512, vocab_size=512)),
          "arctic 2 layers": ("arctic-480b", dict(D256, n_layers=2, n_experts=8))}
# plan -> (variant, mesh fields)
PLANS = {"seq_shard tp4": ("seq_shard", dict(tp=4)),
         "fsdp_seq dp2 tp2": ("fsdp_seq", dict(dp=2, tp=2)),
         "moe_dp_attn tp4": ("moe_dp_attn", dict(tp=4)),
         "ep_model tp4": ("ep_model", dict(tp=4))}
SEEDS = 5
USE = {"yi 2 layers": ("seq_shard tp4", "fsdp_seq dp2 tp2"),
       "yi 4 layers": ("seq_shard tp4", "fsdp_seq dp2 tp2"),
       "arctic 2 layers": ("moe_dp_attn tp4", "ep_model tp4")}


def plan_fields(name: str, kernels: bool) -> dict:
    variant, mesh = PLANS[name]
    plan = VARIANTS[variant]["plan"](ParallelPlan(**mesh))
    return dict(mesh, gas=2, precision="bf16", kernels=kernels,
                rule_overrides=plan.rule_overrides)


def main() -> None:
    worst: dict = {}
    for seed, kernels in ((s, k) for s in range(SEEDS) for k in (False, True)):
        weights, jobs = {}, []
        for m, (arch, ov) in MODELS.items():
            model = Model(ranks.config(arch, ov), torch.float32, device="cpu")
            model.init(torch.Generator().manual_seed(seed))
            weights[m] = {k: v.numpy().copy() for k, v in model.state_dict().items()}
            jobs += [{"name": f"{m} {p}", "arch": arch, "overrides": ov, "weights": m,
                      "plan": plan_fields(p, kernels), "steps": 1} for p in USE[m]]
        with tempfile.TemporaryDirectory() as tmp:
            res = ranks.run_ranks(4, jobs, weights, tmp)
        for m, (arch, ov) in MODELS.items():
            single, _ = ranks.single_device(arch, ov, weights[m],
                                            dict(gas=2, precision="bf16", kernels=kernels),
                                            n=1)
            for p in USE[m]:
                got = res[f"{m} {p}"][0]
                if "error" in got:
                    raise SystemExit(f"{m} {p}: {got['error']}")
                rel = [abs(a - b) / abs(b) for a, b in zip(got["trajectory"][0][:2],
                                                           single[0][:2])]
                print(json.dumps({"seed": seed, "kernels": kernels, "model": m, "plan": p,
                                  "rel_loss": rel[0],
                                  "rel_grad_norm": rel[1]}), flush=True)
                w = worst.setdefault(f"{m} {p}", [0.0, 0.0])
                w[:] = [max(a, b) for a, b in zip(w, rel)]
    print(json.dumps(worst))


if __name__ == "__main__":
    main()
