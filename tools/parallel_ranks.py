"""The multi-rank branches of chip_smoke's phases "parallel" and "pipeline"
alone, on the cards of one host: what each is compared with (phase 4's
yi-6b, or phase 5's gpt-1.4b, single-device step 0) on card 0, then
chip_smoke._parallel_rank or chip_smoke._pipeline_rank on min(count, 4)
ranks.

  python3 tools/parallel_ranks.py [parallel|pipeline]   (default: parallel;
                                        a host with 2 or more CUDA cards,
                                        from the repo root)

_parallel_rank holds the reduced yi-6b's fp32 plans to the single-device
port, yi-6b (TRAIN_LAYERS) at dp = ranks and ZeRO 3 to that step 0, and at
4 ranks trains yi-6b at all 32 layers.  _pipeline_rank holds the reduced
yi-6b's fp32 pipelined plans to the single-device port, gpt-1.4b at pp =
ranks (1 and 2 virtual stages) to phase 5's step 0, and at 4 ranks trains
yi-6b at all 32 layers at pp = 4, gas 8 against dp = 4, ZeRO 3.  Each
reading is a JSON line, and a failed check ends the run non-zero."""
import subprocess, sys, time
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch
import torch.multiprocessing as mp
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.models.model import Model
from repro_torch.runtime.train_loop import ParallelPlan

if __name__ == "__main__":
    branch = sys.argv[1] if len(sys.argv) > 1 else "parallel"
    arch, rank_fn = {"parallel": ("yi-6b", cs._parallel_rank),
                     "pipeline": (cs.PIPELINE_ARCH, cs._pipeline_rank)}[branch]
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout, flush=True)
    t = time.time(); _build.build_all(); print("build", time.time() - t, flush=True)
    cfg = cs.train_config(arch)
    plan = ParallelPlan(gas=cs.TRAIN["gas"], precision="bf16", remat="full", kernels=True)
    t = time.time()
    step0 = cs._run_steps(Model(cfg, torch.float32, device="cuda"), plan,
                          cs._batches(cfg.vocab_size, cs.TRAIN["seq_len"], cs.TRAIN["global_batch"], 1), 0)[0]
    torch.cuda.empty_cache()
    cs.emit({"phase": f"{arch} single-device step 0", "step0": step0, "s": time.time() - t})
    world = min(torch.cuda.device_count(), 4)
    t = time.time()
    mp.spawn(rank_fn, args=(world, cs._process_group_file(f"{branch}_ranks"), step0), nprocs=world)
    print(branch, "ranks", world, "s", time.time() - t, flush=True)
