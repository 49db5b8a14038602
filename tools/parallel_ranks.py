"""The multi-rank branches of chip_smoke's phases "parallel" and "pipeline"
alone, on the cards of one host: what each is compared with (phase 4's
single-device step 0 of yi-6b, zamba2-2.7b and rwkv6-1.6b, or phase 5's of
gpt-1.4b) on card 0, then chip_smoke._parallel_rank, _recurrent_tp_rank or
_pipeline_rank on min(count, 4) ranks.

  python3 tools/parallel_ranks.py [parallel|recurrent|moe|comm|pipeline|serve|encdec|vlm|rules]
                                       (default: parallel; a host with 2 or
                                        more CUDA cards, from the repo root)

_parallel_rank holds the reduced yi-6b's fp32 plans to the single-device
port, yi-6b (TRAIN_LAYERS) at dp = ranks and ZeRO 3 to that step 0, and at
4 ranks trains yi-6b at all 32 layers; then it runs what "recurrent" runs
alone (_recurrent_tp): the reduced zamba2 and rwkv6 fp32 plans at tp =
ranks and dp x tp held to the single-device port, zamba2 (TRAIN_LAYERS)
and rwkv6 (all 24 layers) at full width and tp = ranks, bf16, step 0 held
to phase 4's, and at 4 ranks zamba2 at all 54 layers at tp 4; and what
"moe" runs alone (_moe_ranks): the reduced llama4-maverick and arctic fp32
plans (ep 4, ep 2 x dp 2 at ZeRO 1 and 3, ep 2 x tp 2, ep 2 x pp 2; at 2
ranks ep 2) held to the single-device port (losses, moe_drop, the token
all-to-all's bytes against the predictor), and at 4 ranks arctic at full
width, 1 layer of 64 experts, ep 4 (step time, each card's peak, the
all-to-all bytes, and the state a card would hold at all 128 experts);
and what "comm" runs alone (_comm_ranks): the CommPlan's reduced yi-6b
fp32 plans at node 2 x dp = ranks / 2 and dp = ranks (ZeRO 1 and 3,
overlap, a rule override held to the single-device port; qcomm gather and
both within 5% of it; every gather's bytes, intra and inter, to the
predictor), then yi-6b at all 32 layers, ZeRO 3, bf16, at node 2 x dp
and dp = ranks, each fp, with qcomm gather, with overlap and with both
(step time, each card's peak, the intra and inter gather bytes).
_pipeline_rank holds the reduced yi-6b's fp32 pipelined plans to the
single-device port, gpt-1.4b at pp = ranks (1 and 2 virtual stages) to
phase 5's step 0, and at 4 ranks trains yi-6b at all 32 layers at pp = 4,
gas 8 against dp = 4, ZeRO 3.  "serve" runs chip_smoke._serve_rank: the
dp serve engine of yi-6b (TRAIN_LAYERS, bf16, kernels) at dp = ranks, 4
slots a rank, every rank's tokens equal to a meshless 4-slot engine's and
its pool 1/ranks of the whole.  "encdec" runs chip_smoke._family_rank for
seamless: the reduced seamless's fp32 plans (dp at ZeRO 3, tp, pp with the encoder
gathered over the pipe group) held to the single-device port, then
seamless-m4t-medium at full width at pp = ranks and dp = ranks (ZeRO 3),
step 0 held to its single-device step 0.  "vlm" runs it for internvl2:
the reduced internvl2's fp32 plans (dp at ZeRO 3, tp, pp with the patch
positions on the ring) held to the single-device port, then internvl2-2b
at full width at pp = ranks and dp = ranks (ZeRO 3), step 0 held to its
single-device step 0.  "rules" runs chip_smoke._rules_ranks, the last part
of "parallel": the reference's sharding rules (``rule_overrides`` of
launch/hillclimb.py: seq_shard, fsdp_seq and moe_dp_attn+seq for yi-6b,
moe_dp_attn, ep_model and seq_shard for arctic) on the reduced fp32
models, kernels on, held to the single-device port, then yi-6b
(TRAIN_LAYERS) under seq_shard at tp = ranks and fsdp_seq (dp 2 x tp 2 at
4 ranks) and arctic (2 layers of 8 experts) under moe_dp_attn and ep_model
at full width, bf16, step 0 held to phase 4's (TP_STEP0_RTOL).  Each
reading is a JSON line, and a failed check ends the run non-zero."""
import functools, subprocess, sys, time
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch
import torch.multiprocessing as mp
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.models.model import Model
from repro_torch.runtime.train_loop import ParallelPlan

# branch -> (the archs whose single-device step 0 it is compared with, its rank)
BRANCHES = {"parallel": (("yi-6b", cs.ZAMBA, cs.RWKV, cs.ARCTIC), cs._parallel_rank),
            "recurrent": ((cs.ZAMBA, cs.RWKV), cs._recurrent_tp_rank),
            "moe": ((), cs._moe_rank),
            "comm": ((), cs._comm_rank),
            "pipeline": ((cs.PIPELINE_ARCH,), cs._pipeline_rank),
            "serve": ((), cs._serve_rank),
            "encdec": ((cs.SEAMLESS,), functools.partial(cs._family_rank, arch=cs.SEAMLESS)),
            "vlm": ((cs.INTERNVL,), functools.partial(cs._family_rank, arch=cs.INTERNVL)),
            "rules": (("yi-6b", cs.ARCTIC), cs._rules_rank)}

if __name__ == "__main__":
    branch = sys.argv[1] if len(sys.argv) > 1 else "parallel"
    archs, rank_fn = BRANCHES[branch]
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout, flush=True)
    t = time.time(); _build.build_all(); print("build", time.time() - t, flush=True)
    plan = ParallelPlan(gas=cs.TRAIN["gas"], precision="bf16", remat="full", kernels=True)
    step0 = {}
    for arch in archs:
        cfg = cs.train_config(arch)
        t = time.time()
        step0[arch] = cs._run_steps(Model(cfg, torch.float32, device="cuda"), plan,
                                    cs._batches(cfg.vocab_size, cs.TRAIN["seq_len"],
                                                cs.TRAIN["global_batch"], 1, cfg), 0)[0]
        torch.cuda.empty_cache()
        cs.emit({"phase": f"{arch} single-device step 0", "step0": step0[arch],
                 "s": time.time() - t})
    world = min(torch.cuda.device_count(), 4)
    t = time.time()
    mp.spawn(rank_fn, args=(world, cs._process_group_file(f"{branch}_ranks"),
                            step0 if branch != "pipeline" else step0[cs.PIPELINE_ARCH]),
             nprocs=world)
    print(branch, "ranks", world, "s", time.time() - t, flush=True)
