"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (each prints JSON lines; any failure ends the run non-zero):
  1. device + build: the card's name and power limit, ``nvcc`` builds of
     every ``src/repro_torch/csrc/*.cu`` for sm_90a, all started at once;
  2. kernels: each CUDA kernel against its plain PyTorch version on the same
     inputs, at the main paths' shapes in bf16 and fp32 (serve prefill and
     decode; the train step's microbatch of 4 x 2048 tokens; yi-6b's and
     gpt-1.4b's widths, the flash kernels at hd 128 and 88), plus small
     flavour cases (flash forward and backward: window, softcap, q_offset,
     non-causal ragged, G = 1, G = 8 at hd 64, ragged and q_offset at hd 88;
     CE: ragged N, valid_vocab < V, labels in the last partial tile), the
     flash C entries' refusal of a head dim they were not built for;
     the edges of the redesigned bf16 tiling (flash at every head dim:
     partial query and key tiles, the diagonal, a window edge, rows with no
     key; swiglu and gelu_mlp across their N < 64 regime switch with F and
     d past the last tile, gelu_mlp at each of its tile widths; CE at 4 x
     2047 tokens and d 520 with valid_vocab inside a tile and on a tile's
     start, whole tiles past it, labels at valid_vocab - 1 and in the last
     valid tile, and two planted faults of its partials that must fail the
     CE limits), swiglu's and gelu_mlp's decode launches bit-identical, and
     the Python mirrors of the C entries' tile choices (for the flash
     backward its items, their orders and which tiles take the mask); the
     flash backward also through FLASH_EDGES at every head dim, with two
     planted faults at the yi-6b train shape (one 128-key tile left out of
     dQ, one query head of each GQA group left out of dK/dV) that must fail
     its limits, and its two launches on the same inputs bit-identical; then
     the kernel / plain / library / bound times, and for the flash forward
     and backward, swiglu, gelu_mlp, CE, the grouped expert MLP and the SSD
     and wkv scans the time of the version before the redesign
     (tools/previous_kernels/, built beside the port's) on the same inputs,
     in turns;
     The grouped expert MLP (both bodies) at llama4-maverick's and arctic's
     widths, 128 experts, at their serve prefill and decode slot counts
     (and arctic's at the train microbatch of 4 x 2048 tokens, N 160)
     with masks from top-k routing of random gates, bf16 and reduced fp32,
     with masked rows exactly 0, a bf16 case with every slot masked, its
     work list held to the Python mirror and its bf16 times beside the
     version before its Hopper redesign; at the train phase's cut of 8
     experts (N 2560) forward against its plain version, then its
     Function's backward (the plain fp32 recompute) against fp32 autograd
     of the plain version, with its time.  The SSD scan at zamba2's widths
     (80 heads of 64, state 64) at its serve prefills (256 tokens, chunk 128; 255,
     chunk 1; 96, chunk 32) and the train microbatch (4 x 2048), y and the
     final state, the chunk-parallel work division held to its Python
     mirrors (check_scan_mirrors), a second launch bit-identical; the mamba
     decode step at 4 slots; both with planted faults that must fail their
     limits (the scan's also the carry one chunk late at every case of 4
     chunks or more); both decode steps also in place (``check_in_place``:
     slot 3 inactive, its rows bit-identical and the others within the
     pure step's limits, two launches from one state bit-identical, the
     planted fault "active ignored" caught, a strided, misaligned or bf16
     state refused), timed as a kernel and as the layer pays the state
     (the parent's launch plus the masked copy) against the version before
     the redesign, in turns, by event, device (``torch.profiler``) and host
     time; the three flash kernels at hd 80
     (32 heads, MHA) at the serve prefill and the train microbatch.  The
     wkv scan at rwkv6's widths (32 heads, K = V = 64, fp32) at the train
     microbatch (4 x 2048, chunk 32), at each serve prefill that takes it
     (256 and 64 tokens, chunk 32; 200, chunk 8; 255, chunk 1; ...) and at
     chunks 2, 4 and 16, y and the final state, with decays spread from
     ~0.999 to ~1e-3, a nonzero bonus and carried state; the wkv decode
     step at 4 slots; three planted faults of the scan (and the carry one
     chunk late at every case of 4 chunks or more) and one of the decode
     step must fail their limits; the scan's work division held to its
     mirrors, a second launch bit-identical; the train steps' kernels at
     the shard shapes of tensor parallelism, tp = 2 and 4
     (``phase_kernels_tp``: heads, d_ff and vocab over tp): yi-6b's and
     gpt-1.4b's flash forward and backward, swiglu, gelu_mlp and CE, and
     (``recurrent_kernels_tp``) zamba2-2.7b's SSD scan at 40 and 20 heads,
     its shared block's flash forward and backward at 16 and 8 heads of 80
     and swiglu at F 5120 and 2560, rwkv6-1.6b's wkv scan at 16 and 8
     heads, and both families' CE on vocab shards of 16000 / 8000 and
     32768 / 16384; CE on each vocab shard with labels outside it and a
     local valid vocab, the shards merged as the vocab-parallel CE merges
     them; the flash forward and backward at the query shards of sequence
     parallelism (``phase_kernels_seq``: qwen3-32b's 64q/8kv of 128 on one
     4096-position row split 16 and 4 ways, each shard at its q_offset
     against the whole K/V and the plain version, the shards put together
     against the unsplit call, each timed beside SDPA with the offset
     mask); the dense serving paths' own shapes (``phase_kernels_serve``):
     h2o-danube-1.8b's windowed flash forward (32q/8kv of 80, window 4096)
     at its 8192-token prefill bucket against SDPA with a boolean window
     mask, qwen3-32b's flash forward (64q/8kv of 128), swiglu at qwen3's
     (5120, 25600), phi4-mini's (3072, 8192) and danube's (2560, 6912)
     widths, rmsnorm on qwen3's 128-wide qk-norm rows; the encdec path's
     own shapes (``phase_kernels_encdec``, seamless-m4t-medium at the train
     microbatch): the flash forward and backward non-causal over 16 heads
     of 64, the cross-attention's 2048 queries over 1024 frames and the
     encoder's 1024 over 1024, layernorm (8192, 1024), gelu_mlp (8192,
     1024) x (1024, 4096), and the bf16 CE at V 256206 (no multiple of 8:
     W padded for the kernel's TMA map; the pad timed apart) with planted
     faults; the vlm path's own shapes (``phase_kernels_vlm``, internvl2-2b:
     4 rows of 256 patch and 2048 text positions): rmsnorm (9216, 2048),
     swiglu (9216, 2048) x (2048, 8192), both also at the serve prefill's
     512 and a tick's 4 rows, the flash forward and backward causal over
     4 x 2304 positions, 16q/8kv of 128, the bf16 CE at V 92553 (padded to
     92560) with planted faults; and, first of this phase, rmsnorm on
     qwen3's 128-wide qk-norm rows in turns with ``F.rms_norm`` (event,
     device and host time; ``phase_rmsnorm_qk``);
  3. serve, for yi-6b, gpt-1.4b, llama4-maverick (2 of 48 layers),
     arctic-480b (1 of 35 layers), zamba2-2.7b (all 54 layers),
     rwkv6-1.6b (all 24 layers), h2o-danube-1.8b (all 24 layers, cache_len
     8192: a ring of its 4096-position window a slot, two prompts longer
     than the window), phi4-mini-3.8b (all 32), qwen3-32b (all 64,
     65.5 GB of weights), seamless-m4t-medium (12 encoder and 12 decoder
     layers, each request with its frames, the engine's per-slot memory)
     and internvl2-2b (all 24 layers, each request with its 256 patches,
     their positions ahead of the prompt's in the slot's blocks):
     the model
     at full width in bf16 with kernels=True through ``ServeEngine`` (8
     requests, 4 slots; a paged pool, for zamba2, rwkv6 and danube the
     slot-swap cache, zamba2's and rwkv6's with exact-length prefill); for
     yi-6b also the int8 KV cache (``phase_serve_int8``: the same weights
     and requests on an int8 pool, its first decode tick's logits within
     the reference's bar of the bf16 pool's, the pool (hd + 4) / (2 hd) of
     bf16's bytes, greedy agreement a reading); the serving kernels' launch counters
     must rise (the grouped MLP's to (prefills + ticks) x MoE layers
     exactly; zamba2's SSD scan to prefills x 54, its decode step to ticks
     x 54 and flash to prefills x 9; rwkv6's wkv scan to (prefills of 8
     tokens or more) x 24, its decode step to (ticks + the 5-token prompt's
     tokens) x 24); the logits are held against a kernels=False run on the
     card (for the moe family beside the share of request 0's routing that
     both runs agree on; for zamba2, whose bf16 noise swamps that, only
     reported), and for zamba2 and rwkv6 an fp32 copy of the model runs
     kernels on vs off at full depth; a reduced fp32 model against
     kernels=False tightly; the grouped kernel is held against its plain
     version on the (x, mask) a real prefill gives it; zamba2's and rwkv6's
     tokens equal greedy decoding at the engine's shapes for every
     request, and seamless's and internvl2's (exact launches;
     ``greedy_paged``: the model alone at the engine's buckets and shapes,
     on a paged pool whose blocks it places itself, the patch positions
     counted as the engine counts them); then a
     ``torch.profiler`` pass over prefill and decode (the
     device time, idle share and kernels of a decode tick; for zamba2 and
     rwkv6 also a 255-token prefill, which scans at chunk 1, and the scan's
     share of its device time);
  4. train, for yi-6b (full width, 8 layers), gpt-1.4b (full width, all 24
     layers), zamba2-2.7b (full width, 18 of 54 layers), rwkv6-1.6b
     (full width, all 24 layers), arctic-480b (full width, 2 of 35
     layers, 8 of 128 experts), seamless-m4t-medium (full width, all 12
     + 12 layers, with synthetic frames) and internvl2-2b (full width, all
     24 layers, 256 synthetic patches ahead of each row): a reduced fp32
     model (at the arch's head dim; with arctic, llama4-maverick's too) with
     kernels on vs off over 5 steps,
     tightly; then the arch in bf16 compute
     over fp32 master weights, remat full, kernels=True, 5 steps of global
     batch 8 (gas 2, 2048 tokens); every kernel of the arch's step must
     count its launches; the same steps with kernels=False from the same
     weights and batches, step 0 held to the limits that
     ``tools/step0_limits.py`` measured (for arctic also moe_aux, moe_drop
     beside ``expertplan.predicted_drop_fraction`` and the share of
     microbatch 0's routing choices that kernels on and off agree on); a
     ``torch.profiler`` pass over one step;
  5. parallel (``phase_parallel``): gpt-1.4b at full width and depth
     through the sharded executor (``runtime/train_loop.py``) over a
     one-rank nccl group, ZeRO 3, TRAIN's plan, 3 steps; step 0 held to
     the single-device step on the same weights and batch at
     PARALLEL_RTOL, its launches counted, step time and peak memory beside
     the single-device step's; then over the same group the CommPlan
     (``_comm_one_rank``): yi-6b (TRAIN_LAYERS) at ZeRO 3 with fp gathers,
     qcomm gather, qcomm both and overlap on the same weights and
     batches, each run's launches exact, its gather bytes every step equal
     to ``comm_gather_bytes``, a quantized run's losses within COMM_DRIFT
     of the fp run's, overlap's step 0 within PARALLEL_RTOL of it; with 2
     or more cards, min(count, 4) nccl
     ranks (``_parallel_rank``) run the reduced yi-6b's fp32 plans against
     the single-device port, yi-6b (TRAIN_LAYERS) at dp = ranks, ZeRO 3,
     against phase 4's step 0, and at 4 ranks yi-6b at all 32 layers; then
     (``_recurrent_tp``) the reduced zamba2's and rwkv6's fp32 plans at tp
     = ranks and dp x tp against the single-device port, zamba2-2.7b
     and rwkv6-1.6b (TRAIN_LAYERS) at full width and tp =
     ranks against phase 4's step 0 (TP_STEP0_RTOL), with telemetry
     records, and at 4 ranks zamba2-2.7b at all 54 layers at tp 4; then
     (``_moe_ranks``) the reduced llama4-maverick's and arctic's fp32
     expert-parallel plans against the single-device port (losses,
     moe_drop, the token all-to-all's bytes against the predictor), and at
     4 ranks arctic at full width, 1 layer of 64 experts, ep 4; then
     (``_comm_ranks``, an even count of ranks) the CommPlan's reduced fp32
     plans at node 2 x dp = ranks / 2 and dp = ranks against the
     single-device port and the gather-bytes predictor, and yi-6b at all
     32 layers, ZeRO 3, at both layouts, fp, qcomm gather, overlap and
     both; then (``_rules_ranks``) the reference's rule overrides: the
     reduced yi-6b's and arctic's fp32 plans (seq_shard, fsdp_seq,
     moe_dp_attn+seq, moe_dp_attn, ep_model) against the single-device
     port, and yi-6b (TRAIN_LAYERS) under seq_shard and fsdp_seq and
     arctic (2 layers of 8 experts) under moe_dp_attn and ep_model at full
     width against phase 4's step 0 (TP_STEP0_RTOL); over the one-rank
     group also the dp serve engine
     (``_serve_dp_one_rank``: yi-6b at TRAIN_LAYERS through
     ``ServeEngine(mesh=, plan=)`` at dp 1), its tokens equal to the
     meshless engine's and its logits all-gather bytes exact;
  6. pipeline (``phase_pipeline``): gpt-1.4b at full width and depth, gas
     4, split into 4 logical stages of 6 layers (as 4 pipe ranks, and as 2
     ranks of 2 virtual stages) run in one process through the pipeline
     executor's stage functions, input leaves and boundary backward, the
     hand-off a local tensor: the stage split and its boundary backward on
     the card, not the transport; step 0's loss and grad norm held to the
     single-device step on the same weights and batch at PARALLEL_RTOL,
     each kernel's launches counted exactly, the planner's ticks and idle
     share beside the analytic bubble; with 2 or more cards, 4 (or 2) nccl
     ranks (``_pipeline_rank``) run the reduced yi-6b's fp32 pipelined
     plans against the single-device port, gpt-1.4b at pp = ranks (v = 1
     and 2) against phase 5's single-device step 0, and at 4 ranks yi-6b
     at all 32 layers at pp = 4, gas 8, ZeRO 1 against dp = 4, ZeRO 3;
  7. dryrun (``phase_dryrun``): ``launch/dryrun.py``'s trace of yi-6b at
     full width and DRYRUN_LAYERS layers (TRAIN's shape and plan, kernels
     off, one rank) on the meta device against the same step run 3 times
     on the card (``--measure``): ``FlopCounterMode``'s totals equal, the
     traced peak within DRYRUN_PEAK_BAND of ``max_memory_allocated``; then
     the trace of one 256-rank production record (qwen3-32b train_4k on
     "16x16", a fake group of 256 ranks), its ``trace_s`` printed, and of
     two hillclimb plans on "16x16" that need the port's per-block tensor
     parallelism and sequence parallelism (DRYRUN_HILLCLIMB: arctic
     baseline, qwen3 fsdp_seq), each ``ok``;
  8. checkpoint (``phase_checkpoint``): gpt-1.4b at full width and
     CKPT_LAYERS layers, TRAIN's plan (kernels on): 4 steps straight,
     twice, then 2 steps, ``save_checkpoint``, ``restore_checkpoint`` into
     a fresh model and state drawn from another seed, and 2 more steps; the
     resumed losses and final parameters bit-equal to the straight run's
     where the two straight runs are bit-equal, else within their spread;
     the save and restore seconds and the bytes on disk printed, the
     directory deleted;
  9. the ``kernels`` line: per kernel its launches on each path, its error,
     and the kernel / plain / library / bound times; for the redesigned
     flash forward and backward, swiglu, gelu_mlp, CE, the grouped expert
     MLP, the two scans and the two decode steps also ``parent_ms`` and
     ``ptxas`` (registers and spills of each redesigned kernel); for the
     decode steps also ``device_ms``, ``host_us``, their parent's and the
     layer's readings.
The last line is the result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the rate of the unit that runs them (tensor cores for bf16, FFMA for fp32).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel -> (its CUDA source, the TPU kernel it replaces)
KERNELS = {
    "rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:22"),
    "swiglu": ("swiglu.cu", "src/repro/kernels/swiglu.py:24"),
    "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:48"),
    "flash_attention_bwd_dq": ("flash_attention_bwd.cu",
                               "src/repro/kernels/flash_attention.py:166"),
    "flash_attention_bwd_dkv": ("flash_attention_bwd.cu",
                                "src/repro/kernels/flash_attention.py:223"),
    "cross_entropy": ("cross_entropy.cu", "src/repro/kernels/cross_entropy.py:33"),
    "layernorm": ("layernorm.cu", "src/repro/kernels/layernorm.py:22"),
    "gelu_mlp": ("gelu_mlp.cu", "src/repro/kernels/gelu_mlp.py:33"),
    # both bodies: _swiglu_kernel (:27) and _gelu_kernel (:39)
    "grouped_mlp": ("grouped_mlp.cu", "src/repro/kernels/grouped_mlp.py:27"),
    "ssd_scan": ("ssd_scan.cu", "src/repro/kernels/ssd_scan.py:34"),
    "mamba_decode_step": ("ssd_scan.cu", "src/repro/kernels/ssd_scan.py:148"),
    "wkv_scan": ("wkv_scan.cu", "src/repro/kernels/wkv_scan.py:34"),
    "wkv_decode_step": ("wkv_scan.cu", "src/repro/kernels/wkv_scan.py:151"),
}
LLAMA4, ARCTIC, ZAMBA = "llama4-maverick-400b-a17b", "arctic-480b", "zamba2-2.7b"
RWKV = "rwkv6-1.6b"
DANUBE, QWEN3, PHI4 = "h2o-danube-1.8b", "qwen3-32b", "phi4-mini-3.8b"
SEAMLESS = "seamless-m4t-medium"
INTERNVL = "internvl2-2b"
# the families whose cache is slot-swapped, with exact-length prefill
RECURRENT = ("hybrid", "rwkv")
# the kernels each arch's serving path runs
SERVE_KERNELS = {
    "yi-6b": ("rmsnorm", "swiglu", "flash_attention"),
    "gpt-1.4b": ("layernorm", "gelu_mlp", "flash_attention"),
    LLAMA4: ("rmsnorm", "swiglu", "flash_attention", "grouped_mlp"),
    ARCTIC: ("rmsnorm", "swiglu", "flash_attention", "grouped_mlp"),
    ZAMBA: ("rmsnorm", "swiglu", "flash_attention", "ssd_scan", "mamba_decode_step"),
    RWKV: ("rmsnorm", "wkv_scan", "wkv_decode_step"),
    DANUBE: ("rmsnorm", "swiglu", "flash_attention"),
    PHI4: ("rmsnorm", "swiglu", "flash_attention"),
    QWEN3: ("rmsnorm", "swiglu", "flash_attention"),
    SEAMLESS: ("layernorm", "gelu_mlp", "flash_attention"),
    INTERNVL: ("rmsnorm", "swiglu", "flash_attention"),
}
# the kernels each arch's train step runs
TRAIN_KERNELS = {
    "yi-6b": ("rmsnorm", "swiglu", "flash_attention", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv", "cross_entropy"),
    "gpt-1.4b": ("layernorm", "gelu_mlp", "flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "cross_entropy"),
    ZAMBA: ("rmsnorm", "swiglu", "flash_attention", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv", "cross_entropy", "ssd_scan"),
    RWKV: ("rmsnorm", "cross_entropy", "wkv_scan"),
    ARCTIC: ("rmsnorm", "swiglu", "flash_attention", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv", "cross_entropy", "grouped_mlp"),
    SEAMLESS: ("layernorm", "gelu_mlp", "flash_attention", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv", "cross_entropy"),
    INTERNVL: ("rmsnorm", "swiglu", "flash_attention", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv", "cross_entropy"),
}
# the reduced fp32 model each arch is first held against kernels=False with,
# at the arch's own head dim (plain .reduced() has hd 64)
REDUCED = {"yi-6b": dict(head_dim=128), "gpt-1.4b": dict(d_model=176, n_heads=2, head_dim=88),
           LLAMA4: dict(head_dim=128), ARCTIC: dict(head_dim=128),
           # zamba2: hd 80 (d 160 over 2 heads) and the SSD kernels' P = N = 64
           ZAMBA: dict(d_model=160, n_heads=2, head_dim=80, ssm_head_dim=64, ssm_state=64),
           # rwkv6: plain .reduced() has d 256 in 4 heads of 64, the kernels' K = V
           RWKV: {},
           # h2o-danube: hd 80 in danube's GQA 4 (4q/1kv), .reduced()'s window 16
           DANUBE: dict(d_model=320, n_heads=4, n_kv_heads=1, head_dim=80),
           # qwen3: 4 heads of 128 over d 256 (wider than d, as at full width),
           # qk-norm on 128-wide rows; phi4-mini: hd 128
           QWEN3: dict(head_dim=128), PHI4: dict(head_dim=128),
           # seamless: plain .reduced() is its own head dim, 64 (d 256 in 4 heads)
           SEAMLESS: {},
           # internvl2: 4 heads of 128 over d 256, 8 patches of 64 ahead of the text
           INTERNVL: dict(head_dim=128)}
# serving depth of the moe family at full width in bf16 on one 80 GB card:
# llama4 one stack unit (a dense layer, then a MoE layer: 18.55e9
# parameters, 37.1 GB), arctic one layer (14.07e9, 28.1 GB); the dense
# family serves at all its layers (qwen3-32b: 64, 32.8e9 parameters, 65.5
# GB; ``models/common.py:init_leaf`` draws a leaf past 2^30 elements a slice
# at a time, so the init needs no fp32 copy of a whole stacked leaf)
SERVE_LAYERS = {LLAMA4: 2, ARCTIC: 1}
# the serve engine's cache_len (512 unless named): h2o-danube at 8192, so
# that each slot holds a ring of its whole 4096-position window
SERVE_CACHE_LEN = {DANUBE: 8192}


# the sources redesigned for Hopper, the wrapper module's library loader and
# their C entries: the versions before the redesign (tools/previous_kernels/)
# are built beside the port's and timed on the same inputs, in turns with the
# new ones (``parent_ms``)
PREVIOUS = {"flash_attention": ("_lib", ("flash_attention_fwd",)),
            "flash_attention_bwd": ("_bwd_lib", ("flash_attention_bwd_dq",
                                                 "flash_attention_bwd_dkv")),
            "swiglu": ("_lib", ("swiglu_fwd",)), "gelu_mlp": ("_lib", ("gelu_mlp_fwd",)),
            "cross_entropy": ("_lib", ("cross_entropy_fwd",)),
            "grouped_mlp": ("_lib", ("grouped_mlp_fwd",)),
            "ssd_scan": ("_lib", ("ssd_scan_fwd", "ssd_scan_scratch")),
            "wkv_scan": ("_lib", ("wkv_scan_fwd", "wkv_scan_scratch"))}
# the redesigned kernels (bf16, and the fp32 decode steps), whose registers and spills the kernels
# line reports (``ptxas -v``)
REDESIGNED = {"flash_attention": ("flash_fwd_bf16_kernel",),
              "flash_attention_bwd_dq": ("flash_bwd_dq_bf16_kernel",),
              "flash_attention_bwd_dkv": ("flash_bwd_dkv_bf16_kernel",),
              "swiglu": ("swiglu_bf16_kernel",), "gelu_mlp": ("gelu_mlp_bf16_kernel",),
              "cross_entropy": ("ce_partial_bf16_kernel",),
              "grouped_mlp": ("grouped_live_kernel", "grouped_gate_bf16_kernel",
                              "grouped_down_bf16_kernel"),
              "ssd_scan": ("ssd_scan_state_kernel", "ssd_scan_pass_kernel",
                           "ssd_scan_out_kernel", "ssd_scan_out_tc_kernel",
                           "ssd_scan_small_kernel"),
              "wkv_scan": ("wkv_scan_state_kernel", "wkv_scan_pass_kernel",
                           "wkv_scan_out_kernel", "wkv_scan_small_kernel"),
              "mamba_decode_step": ("mamba_decode_kernel",),
              "wkv_decode_step": ("wkv_decode_kernel",)}
_PREVIOUS_LIBS: dict = {}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def start_previous_build() -> dict:
    """One ``nvcc`` per previous version, started at once (they include the
    port's ``csrc/common.cuh``)."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "previous"
    out_dir.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in PREVIOUS:
        out, src = out_dir / f"{name}.so", ROOT / "tools" / "previous_kernels" / f"{name}.cu"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out), str(src)]
        started[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    return started


def finish_previous_build(started: dict) -> None:
    import ctypes

    for name, (path, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the previous {name}.cu:\n{log}")
        lib = ctypes.CDLL(str(path))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _PREVIOUS_LIBS[name] = lib


def with_previous(name: str, fn):
    """``fn()`` with the kernel module's library swapped for the previous
    version's (same C entries and signatures), so the wrapper launches it."""
    from repro_torch.kernels import (cross_entropy as ce, flash_attention as fa,
                                     gelu_mlp as gm, grouped_mlp as gp, ssd_scan as ssd,
                                     swiglu as sg, wkv_scan as wkv)

    module = {"flash_attention": fa, "flash_attention_bwd": fa, "swiglu": sg,
              "gelu_mlp": gm, "cross_entropy": ce, "grouped_mlp": gp, "ssd_scan": ssd,
              "wkv_scan": wkv}[name]
    loader, entries = PREVIOUS[name]
    own, prev = getattr(module, loader), _PREVIOUS_LIBS[name]
    for entry in entries:
        getattr(prev, entry).argtypes = getattr(own(), entry).argtypes
        getattr(prev, entry).restype = getattr(own(), entry).restype
    setattr(module, loader, lambda: prev)
    try:
        return fn()
    finally:
        setattr(module, loader, own)


def timed_with_parent(timer, name: str, fn) -> tuple[float, float]:
    """(ms, parent_ms): the kernel and its previous version on the same
    inputs, in turns (new, previous, previous, new), each the mean of its
    two medians."""
    a = timer(fn)
    b = with_previous(name, lambda: timer(fn))
    c = with_previous(name, lambda: timer(fn))
    d = timer(fn)
    return (a + d) / 2, (b + c) / 2


def readings_in_turns(timer, fn, parent) -> tuple[dict, dict]:
    """``Timer.readings`` of ``fn`` and of ``parent`` in turns (fn, parent,
    parent, fn), each reading the mean of its two turns ("not measured"
    where either turn's profile caught no device time)."""
    a, b, c, d = (timer.readings(f) for f in (fn, parent, parent, fn))

    def mean(x: dict, y: dict) -> dict:
        def both(k):
            if isinstance(x[k], float) and isinstance(y.get(k), float):
                return (x[k] + y[k]) / 2
            return "not measured" if isinstance(y.get(k), str) else x[k]
        return {k: both(k) for k in x}
    return mean(a, d), mean(b, c)


def _previous_entry(src: str, entry: str, argtypes: list):
    import ctypes

    fn = getattr(_PREVIOUS_LIBS[src], entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def parent_mamba_decode(window, conv_w, conv_b, dt_raw, dt_bias, A_log, D, state, *,
                        n_heads: int, head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The decode step before its redesign: ``tools/previous_kernels/
    ssd_scan.cu``'s kernel through its wrapper as it was (its checks, the
    copies it made, a fresh state).  Its C entry has another signature than
    the port's, so ``with_previous`` cannot swap it in."""
    import ctypes

    from repro_torch.kernels import _build

    fwd = _previous_entry("ssd_scan", "mamba_decode_fwd",
                          [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    code = _build.dtype_code(window)
    B, K, ch = window.shape
    H, P = n_heads, head_dim
    N = state.shape[-1] if state.ndim == 4 else -1
    if (not window.is_cuda
            or any(t.device != window.device
                   for t in (conv_w, conv_b, dt_raw, dt_bias, A_log, D, state))
            or {conv_w.dtype, conv_b.dtype} != {window.dtype}
            or conv_w.shape != (K, ch) or conv_b.shape != (ch,) or dt_raw.shape != (B, H)
            or any(t.shape != (H,) for t in (dt_bias, A_log, D))
            or state.shape != (B, H, P, N) or state.dtype != torch.float32
            or ch != H * P + 2 * N or (P, N) != (64, 64)):
        raise ValueError("parent mamba_decode_step: inputs it does not take")
    window, conv_w, conv_b = (t.contiguous() for t in (window, conv_w, conv_b))
    small = (dt_raw, dt_bias, A_log, D)
    if len({t.dtype for t in small}) > 1:
        small = tuple(t.float() for t in small)
    dt_raw, dt_bias, A_log, D = (t.contiguous() for t in small)
    state = _build.aligned(state)
    y = torch.empty((B, H, P), dtype=torch.float32, device=window.device)
    new_state = torch.empty_like(state)
    err = fwd(window.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), dt_raw.data_ptr(),
              dt_bias.data_ptr(), A_log.data_ptr(), D.data_ptr(), state.data_ptr(),
              y.data_ptr(), new_state.data_ptr(), B, K, ch, H, P, N, code,
              _build.dtype_code(dt_raw), _build.stream_of(window))
    _build.check(_PREVIOUS_LIBS["ssd_scan"], err, "previous mamba_decode_fwd")
    return y, new_state


def parent_wkv_decode(r, k, v, w, u, state) -> tuple[torch.Tensor, torch.Tensor]:
    """The wkv decode step before its redesign (``tools/previous_kernels/
    wkv_scan.cu``) through its wrapper as it was: a fresh state."""
    import ctypes

    from repro_torch.kernels import _build

    fwd = _previous_entry("wkv_scan", "wkv_decode_fwd",
                          [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    B, H, K = r.shape
    V = v.shape[-1]
    if (not r.is_cuda or any(t.device != r.device for t in (k, v, w, u, state))
            or k.shape != r.shape or w.shape != r.shape or v.shape != (B, H, V)
            or u.shape != (H, K) or state.shape != (B, H, K, V) or (K, V) != (64, 64)):
        raise ValueError("parent wkv_decode_step: inputs it does not take")
    r, k, v, w, u, state = [_build.aligned(t.float()) for t in (r, k, v, w, u, state)]
    y = torch.empty((B, H, V), dtype=torch.float32, device=r.device)
    new_state = torch.empty_like(state)
    err = fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
              state.data_ptr(), y.data_ptr(), new_state.data_ptr(), B, H, K, V,
              _build.stream_of(r))
    _build.check(_PREVIOUS_LIBS["wkv_scan"], err, "previous wkv_decode_fwd")
    return y, new_state


def ptxas_summary(log: str, kernel: str) -> dict:
    """Registers and spills that ``ptxas -v`` reported for each entry
    function whose mangled name holds ``kernel``."""
    import re

    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1) if kernel in m.group(1) else None
            continue
        if current is None:
            continue
        tail = current[current.index(kernel) + len(kernel):].split("Ev")[0] + "E"
        args = [{"13__nv_bfloat16": "bf16", "f": "f32"}.get(a, a.strip("LiE")) for a in
                re.findall(r"13__nv_bfloat16|(?<=[IE6])f|Li\d+E", tail)]
        key = f"{kernel}<{', '.join(args)}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(key, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations"


class Timer:
    """Median of per-launch CUDA-event times, with L2 flushed (a 256 MB
    write, outside the timed events) before each launch."""

    def __init__(self, iters: int = 10):
        self.iters = iters
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def device(self, fn, n: int = 20) -> dict:
        """The device time of ``fn``'s kernels alone (``torch.profiler``),
        each of n calls after the L2 flush as ``__call__`` makes it, the
        flush's own kernels left out: ms and kernels per call, and ms per
        call by kernel name."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        # a session may miss a kernel or two at its edge (seen on the H100
        # after many sessions in one process): the flush's names are taken
        # from a few flushes, and fn's calls sit between flushes of their own
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                self.flush.zero_()
            torch.cuda.synchronize()
        flush_names = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                self.flush.zero_()
            for _ in range(n):
                self.flush.zero_()
                fn()
            for _ in range(3):
                self.flush.zero_()
            torch.cuda.synchronize()
        by_name: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and e.name not in flush_names:
                acc = by_name.setdefault(e.name[:60], [0.0, 0])
                acc[0] += e.time_range.elapsed_us() / 1e3 / n
                acc[1] += 1
        if not by_name or not flush_names:
            return {"device_ms": "not measured", "kernels_per_call": "not measured"}
        return {"device_ms": sum(ms for ms, _ in by_name.values()),
                "kernels_per_call": sum(c for _, c in by_name.values()) / n,
                "device_ms_by_kernel": {k: ms for k, (ms, _) in by_name.items()}}

    @staticmethod
    def host_us(fn, n: int = 300) -> float:
        """The host's time per call of ``fn`` in microseconds: n calls back to
        back with no synchronize (the card keeps up with a kernel that is
        shorter than its host cost), best of three rounds."""
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
        return best

    def readings(self, fn) -> dict:
        """``ms`` (events, as ``__call__``), ``device_ms`` and
        ``kernels_per_call`` (``device``) and ``host_us`` of one call."""
        dev = self.device(fn)
        return {"ms": self(fn), "device_ms": dev["device_ms"],
                "kernels_per_call": dev["kernels_per_call"], "host_us": self.host_us(fn)}


def max_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out.float() - ref.float()).abs().max())


def limit_share(out: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float,
                terms: tuple = ()) -> tuple[torch.Tensor, torch.Tensor, str]:
    """|out - ref| and its share of the elementwise limit atol + rtol*|ref| +
    the sum of tol*scale over ``terms``, and the rule as text."""
    diff = (out.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    rule = f"|d| <= {atol:g} + {rtol:g}*|ref|"
    for scale, tol, scale_name in terms:
        limit = limit + tol * scale.float()
        rule += f" + {tol:g}*({scale_name})"
    return diff, diff / limit, rule


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor, *, rtol: float,
                atol: float, why: str, terms: tuple = ()) -> float:
    """|out - ref| <= atol + rtol*|ref| + the sum of tol*scale over ``terms``
    elementwise, else raise; each term (scale, tol, name) is an elementwise
    error scale the caller derives from the kernel's own arithmetic (flash:
    P@|V| for its rounding of P)."""
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: shape {tuple(out.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite output")
    diff, share, rule = limit_share(out, ref, rtol, atol, terms)
    err = float(diff.max())
    worst = float(share.max())
    at = [int(i) for i in np.unravel_index(int(share.argmax()), share.shape)]
    emit({"phase": "kernel_check", "case": name, "max_abs_err": err,
          "worst_share_of_limit": worst, "worst_at": at, "rule": rule, "why": why})
    if worst > 1:
        raise AssertionError(f"{name}: max abs err {err}, {worst:.2f}x its limit ({rule})")
    return err


def randn(gen, *shape, dtype, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# bf16 outputs: kernel and plain version both round an fp32 result to bf16,
# so they may differ by one bf16 ULP, at most 2^-7 of the value.
BF16_ULP = 2.0 ** -7
TOL = {  # dtype -> (rtol, atol), and the reason
    "rmsnorm": {torch.bfloat16: (1.1 * BF16_ULP, 1e-5), torch.float32: (1e-5, 1e-5),
                "why": "same fp32 formula, other summation order; bf16: one "
                       "ULP between the two output roundings"},
    "swiglu": {torch.bfloat16: (1.1 * BF16_ULP, 1e-3), torch.float32: (1e-4, 1e-4),
               "why": "fp32: FFMA vs cuBLAS summation order over d; bf16: held "
                      "against the plain version on the same inputs in fp32 "
                      "(the kernel keeps both products in fp32): one ULP "
                      "between the output roundings, 1e-3 for summation order"},
    "flash_attention": {torch.bfloat16: (1.1 * BF16_ULP, 1e-5),
                        torch.float32: (5e-5, 5e-5),
                        "why": "fp32: other exp/summation order over up to 2048 "
                               "keys; bf16: one ULP between the output roundings, "
                               "plus the kernel's rounding of P to bf16 for P@V "
                               "(FA-2), at most 2^-8 of each p, so 2^-8*(P@|V|)"},
    "layernorm": {torch.bfloat16: (1.1 * BF16_ULP, 1e-5), torch.float32: (1e-5, 1e-5),
                  "why": "same fp32 two-pass formula, other summation order; bf16: "
                         "one ULP between the two output roundings; plus 1e-5 of "
                         "|x_hat|*|w| + |b| where x_hat*w + b cancels"},
    "gelu_mlp": {torch.bfloat16: (1.1 * BF16_ULP, 1e-6), torch.float32: (1e-5, 1e-6),
                 "why": "fp32 sums of exact products in another order over d "
                        "(2e-5 of |x|@|w1|, times max |gelu'|); bf16: one ULP "
                        "between the output roundings"},
}
# flash bf16: the bound on the P-rounding term, with 10% margin
FLASH_P_TOL = 1.1 * 2.0 ** -8
# layernorm: kernel and plain version take the mean and the variance in fp32
# in another summation order over d, which moves x_hat by ~1e-6 of itself;
# the output y = x_hat*w + b may cancel, so that error is held to 1e-5 of
# |x_hat|*|w| + |b| (elementwise), besides the rmsnorm-like rule above it.
LN_SCALE_TOL = 1e-5
# gelu_mlp: both form fp32 sums of the same exact products (bf16 x bf16 is
# exact in fp32; fp32 runs FFMA against cuBLAS without TF32) in another order
# over d: 2e-5 of |x|@|w1| (as the CE check), times 1.13 >= |gelu'(a)|, plus
# one ULP between the output roundings in bf16.
GELU_SCALE_TOL = 2e-5 * 1.13
# gpt-1.4b's widths (configs/gpt_paper.py): d 2112 = 24 heads of 88, 4d MLP
GPT_D, GPT_F, GPT_HEADS, GPT_HD = 2112, 8448, 24, 88


FLASH_FLAVOURS = [  # small cases of both flash checks: (name, B, Sq, Skv, Hq, Hkv, hd, kw)
    ("window 64", 2, 256, 256, 4, 2, 128, dict(causal=True, sliding_window=64)),
    ("softcap 30", 1, 192, 192, 4, 4, 128, dict(causal=True, softcap=30.0)),
    ("q_offset 192, Sq<Skv", 2, 64, 256, 8, 2, 128, dict(causal=True, q_offset=192)),
    ("non-causal, ragged", 1, 100, 200, 4, 2, 128, dict(causal=False)),
    ("G=1", 1, 128, 128, 4, 4, 64, dict(causal=True)),
    ("G=8, hd 64", 1, 130, 130, 8, 1, 64, dict(causal=True)),
    ("window + q_offset", 1, 96, 160, 4, 2, 64,
     dict(causal=True, sliding_window=48, q_offset=64)),
    ("window + q_offset + softcap", 1, 96, 160, 4, 2, 64,
     dict(causal=True, sliding_window=48, q_offset=64, softcap=20.0)),
    ("non-causal, ragged", 1, 100, 200, 4, 4, 88, dict(causal=False)),
    ("q_offset 192, Sq<Skv", 2, 64, 256, 4, 4, 88, dict(causal=True, q_offset=192)),
    ("G=2, window + q_offset", 1, 96, 160, 4, 2, 88,
     dict(causal=True, sliding_window=48, q_offset=64)),
    ("non-causal, ragged", 1, 100, 200, 4, 4, 80, dict(causal=False)),
    ("G=2, q_offset 64, Sq<Skv", 1, 96, 160, 4, 2, 80, dict(causal=True, q_offset=64)),
]


# the edges of the bf16 forward's tiling (128-row query tiles of two
# warpgroups, 128-key tiles, the mask only on tiles that need it), each at
# every head dim: (name, B, Sq, Skv, Hq, Hkv, kw)
FLASH_EDGES = [
    ("partial query and key tiles, diagonal", 1, 200, 200, 4, 2, dict(causal=True)),
    ("window edge + q_offset", 1, 200, 330, 4, 2,
     dict(causal=True, sliding_window=100, q_offset=130)),
    ("rows with no key", 1, 200, 200, 2, 1, dict(causal=True, q_offset=-40)),
    ("non-causal, partial key tile", 1, 130, 77, 2, 2, dict(causal=False)),
]
# swiglu across the bf16 regime switch (N < 64 streams 64 x 64 tiles) with F
# past the last 64-, 128- and 192-column tile and d past the last 64-deep
# stage (both multiples of 8), and the 192-column tile with that d
SWIGLU_EDGES = [(N, 264, 520) for N in (1, 3, 17, 63, 64, 200)] + [(256, 264, 11008)]


def card_sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def check_swiglu_edges(gen, check_swiglu) -> None:
    """SWIGLU_EDGES in bf16 and fp32; and the decode regime repeats
    bit-for-bit (one block's fixed-order sum per output, no atomics)."""
    from repro_torch.kernels import swiglu as sg

    for N, d, F_ in SWIGLU_EDGES:
        for dtype in (torch.bfloat16, torch.float32):
            x = randn(gen, N, d, dtype=dtype)
            w1 = randn(gen, d, F_, dtype=dtype, scale=d ** -0.5)
            w3 = randn(gen, d, F_, dtype=dtype, scale=d ** -0.5)
            check_swiglu(f"swiglu {dtype} edge ({N}, {d})x({d}, {F_}), tile "
                         f"{sg.swiglu_tile(N, F_, card_sms())}", x, w1, w3)
    x = randn(gen, 4, 4096, dtype=torch.bfloat16)
    w1, w3 = (randn(gen, 4096, 11008, dtype=torch.bfloat16, scale=4096 ** -0.5)
              for _ in range(2))
    same = torch.equal(sg.swiglu_cuda(x, w1, w3), sg.swiglu_cuda(x, w1, w3))
    emit({"phase": "kernel_check", "case": "swiglu bf16 (4, 4096)x(4096, 11008) twice",
          "bit_identical": same})
    if not same:
        raise AssertionError("swiglu decode: two launches on the same inputs differ")


def bwd_mirror_records(kernel: str, B: int, Hq: int, Hkv: int, Sq: int, Skv: int, hd: int,
                       **mask) -> tuple[list, list]:
    """The bf16 flash backward's items as (C records, mirror records), each
    item as its ids and the tiles it walks in order: dQ (q0, h, b, key
    tiles), dK/dV (k0, hk, b, query tiles)."""
    from repro_torch.kernels import flash_attention as fa

    sms = card_sms()
    got = fa.bwd_items_cuda(kernel, B, Hq, Hkv, Sq, Skv, hd, sms, **mask)
    if kernel == "dq":
        c = [(q0, h, b, [ks + (n - 1 - i) * fa.DQ_BLOCK_N for i in range(n)])
             for q0, h, b, ks, n in got]
        order = fa.work_order(B, Sq, Hq, fa.chunk_pairs(B, Hq, Hkv, Skv, hd), mask["causal"])
        mirror = [(q0, h, b, fa.key_tiles(q0, Sq, Skv, block_n=fa.DQ_BLOCK_N, **mask))
                  for q0, h, b in order]
    else:
        c = [(k0, hk, b, [qs + i * fa.DKV_BLOCK_M for i in range(n)])
             for k0, hk, b, qs, n in got]
        mirror = [(k0, hk, b, fa.query_tiles(k0, Sq, Skv, **mask))
                  for k0, hk, b in fa.dkv_work_order(
                      B, Hkv, Skv, fa.dkv_chunk(B, Hq, Hkv, Sq, Skv, hd, sms))]
    return c, mirror


def bwd_mirror_masks() -> list[tuple[int, int, dict]]:
    """(Sq, Skv, mask) the bf16 flash backward's mirrors are held at on the
    card: the train step's and each FLASH_FLAVOURS and FLASH_EDGES case's."""
    cases = [(2048, 2048, dict(causal=True))]
    cases += [(Sq, Skv, kw) for _, _, Sq, Skv, _, _, _, kw in FLASH_FLAVOURS]
    cases += [(Sq, Skv, kw) for _, _, Sq, Skv, _, _, kw in FLASH_EDGES]
    return [(Sq, Skv, dict(causal=kw.get("causal", True), window=kw.get("sliding_window"),
                           q_offset=kw.get("q_offset", 0))) for Sq, Skv, kw in cases]


def check_bwd_mirrors() -> int:
    """The bf16 flash backward's items and masked tiles: the C entries
    (``flash_bwd_item``, ``flash_bwd_edge``) against the Python mirrors, at
    every config's train microbatch and at ``bwd_mirror_masks``.  Returns
    the number of shapes held."""
    from repro_torch.configs import all_configs
    from repro_torch.kernels import flash_attention as fa

    n = 0
    shapes = {(4, 2048, 2048, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
               (("causal", True), ("window", None), ("q_offset", 0)))
              for cfg in all_configs().values()
              if cfg.resolved_head_dim in fa.HEAD_DIMS and cfg.n_kv_heads}
    shapes |= {(2, Sq, Skv, 8, 2, 128, tuple(m.items())) for Sq, Skv, m in bwd_mirror_masks()}
    for B, Sq, Skv, Hq, Hkv, hd, mask in sorted(shapes, key=str):
        for kernel in ("dq", "dkv"):
            got, want = bwd_mirror_records(kernel, B, Hq, Hkv, Sq, Skv, hd, **dict(mask))
            if got != want:
                bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
                raise AssertionError(f"flash bwd {kernel} items ({B}, {Sq}, {Skv}, {Hq}q/"
                                     f"{Hkv}kv, {hd}, {dict(mask)}): {len(got)} vs "
                                     f"{len(want)} items, first difference at {bad}")
            n += 1
    for Sq, Skv, mask in bwd_mirror_masks():
        for a in range(0, max(Sq, Skv), fa.WG_ROWS):
            for b in range(0, max(Sq, Skv), fa.WG_ROWS):
                for kernel, want in (
                        ("dq", fa.edge_tile(b, a, Sq, Skv, block_n=fa.DQ_BLOCK_N, **mask)),
                        ("dkv", fa.dkv_edge_tile(b, a, Sq, Skv, **mask))):
                    if fa.bwd_edge_cuda(kernel, a, b, Sq, Skv, **mask) != want:
                        raise AssertionError(f"flash bwd {kernel} edge ({a}, {b}) at "
                                             f"({Sq}, {Skv}, {mask}): mirror {want}")
        n += 1
    return n


def check_tile_mirrors() -> None:
    """The Python mirrors of the C entries' choices (the swiglu and gelu_mlp
    tiles, the CE tile and its partials a row, the flash forward's chunk of
    (b, h) pairs, the flash backward's items and masked tiles) agree with
    the libraries at every config's serve and train shapes on this card."""
    from repro_torch.configs import all_configs
    from repro_torch.kernels import (cross_entropy as ce, flash_attention as fa,
                                     gelu_mlp as gm, swiglu as sg)

    n, sms = 0, card_sms()
    for cfg in all_configs().values():
        if cfg.act == "gelu":
            for N in (1, 4, 63, 64, 129, 200, 256, 512, 8192):
                got, want = gm.gelu_mlp_tile_cuda(N, cfg.d_ff, sms), gm.gelu_mlp_tile(
                    N, cfg.d_ff, sms)
                if got != want:
                    raise AssertionError(f"gelu_mlp tile ({N}, {cfg.d_ff}): C {got}, "
                                         f"mirror {want}")
                n += 1
        V = cfg.padded_vocab
        for dtype in (torch.bfloat16, torch.float32):
            got = ce.tiling_cuda(V, dtype)
            want = ((ce.TILE_M, ce.TILE_N), ce.n_partials(V, dtype))
            if got != want:
                raise AssertionError(f"CE tiling ({V}, {dtype}): C {got}, mirror {want}")
            n += 1
        if cfg.act == "swiglu":
            for F_ in {f for f in (cfg.d_ff, cfg.dense_d_ff) if f}:
                for N in (1, 4, 63, 64, 129, 200, 256, 512, 8192):
                    got, want = sg.swiglu_tile_cuda(N, F_, sms), sg.swiglu_tile(N, F_, sms)
                    if got != want:
                        raise AssertionError(f"swiglu tile ({N}, {F_}): C {got}, mirror {want}")
                    n += 1
        if cfg.resolved_head_dim in fa.HEAD_DIMS and cfg.n_kv_heads:
            for B, S in ((1, 5), (1, 256), (1, 2048), (4, 2048)):
                args = (B, cfg.n_heads, cfg.n_kv_heads, S, cfg.resolved_head_dim)
                if fa.chunk_pairs_cuda(*args) != fa.chunk_pairs(*args):
                    raise AssertionError(f"flash chunk {args}: C {fa.chunk_pairs_cuda(*args)}, "
                                         f"mirror {fa.chunk_pairs(*args)}")
                n += 1
    n += check_bwd_mirrors()
    emit({"phase": "kernel_check", "case": "tile mirrors agree with the C entries",
          "shapes": n, "sms": sms})


def _flash_case(gen, name, B, Sq, Skv, Hq, Hkv, hd, dtype, **kw):
    """The flash forward kernel against ``flash_attention_ref`` on random
    q, k, v (and, in fp32, the LSE); returns (max abs err, (q, k, v))."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    q = randn(gen, B, Sq, Hq, hd, dtype=dtype)
    k = randn(gen, B, Skv, Hkv, hd, dtype=dtype)
    v = randn(gen, B, Skv, Hkv, hd, dtype=dtype)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ref, ref_lse = flash_attention_ref(qt, kt, vt, return_lse=True, **kw)
    rtol, atol = TOL["flash_attention"][dtype]
    scale = None
    if dtype == torch.bfloat16:                 # P@|V|, in fp32
        scale = flash_attention_ref(qt.float(), kt.float(), vt.float().abs(),
                                    **kw).transpose(1, 2)
    err = check_close(name, out, ref.transpose(1, 2), rtol=rtol, atol=atol,
                      why=TOL["flash_attention"]["why"],
                      terms=() if scale is None else ((scale, FLASH_P_TOL, "P@|V|"),))
    if dtype == torch.float32:
        seen = torch.isfinite(ref_lse)
        check_close(name + " lse", lse[seen], ref_lse[seen], rtol=1e-4, atol=1e-4,
                    why="fp32 log-sum-exp, other summation order")
    return err, (q, k, v)


def _timed(timer: Timer, name: str, fn, parent: bool) -> tuple[float, float | None]:
    """(ms, parent_ms): in turns with the version before the redesign when
    ``parent``, else the kernel alone."""
    return timed_with_parent(timer, name, fn) if parent else (timer(fn), None)


def flash_pairs(B: int, Hq: int, Sq: int, Skv: int, causal: bool) -> int:
    """The unmasked (q, k) pairs of a flash call (causal: Sq == Skv)."""
    return B * Hq * Sq * (Sq + 1) // 2 if causal else B * Hq * Sq * Skv


def _flash_row(timer: Timer, err, q, k, v, parent: bool = True, causal: bool = True) -> dict:
    """The timed row of a bf16 forward at q's and k's shapes."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    B, S, Hq, hd = q.shape
    pairs = flash_pairs(B, Hq, S, k.shape[1], causal)
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + B * Hq * S * 4
    b, by = bound_ms(nbytes, 4 * hd * pairs, q.dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
    except TypeError:                           # torch without enable_gqa
        lib_ms = None
    rtol, atol = TOL["flash_attention"][q.dtype]
    ms, parent_ms = _timed(timer, "flash_attention",
                           lambda: fa.flash_attention_fwd_cuda(q, k, v, causal=causal), parent)
    return {"shape": f"q {tuple(q.shape)}, k/v {tuple(k.shape)} bf16 "
                     f"{'causal' if causal else 'non-causal'}",
            "max_abs_err": err, "rtol": rtol, "atol": atol,
            "p_rounding_tol": FLASH_P_TOL, "ms": ms, "parent_ms": parent_ms,
            "plain_ms": timer(lambda: flash_attention_ref(qt, kt, vt, causal=causal)),
            "library_ms": lib_ms,
            "library_call": "F.scaled_dot_product_attention(enable_gqa=True)",
            "bound_ms": b, "bound_by": by}


def phase_kernels(timer: Timer) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa, rmsnorm as rn, swiglu as sg
    from repro_torch.kernels.ref import rmsnorm_ref, swiglu_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}

    # the moe family's widths: d, the dense MLP's F (llama4's dense layer and
    # shared expert, arctic's residual MLP) and the attention heads
    moe = [get_config(arch) for arch in (LLAMA4, ARCTIC)]

    # rmsnorm: the prefill norm of 2048 tokens of yi-6b, the train step's
    # 4 x 2048 rows, a 256-token prefill of llama4 and arctic, and a decode
    # tick's 4 rows of yi-6b, zamba2 and rwkv6 (d 4096, 2560, 2048; also by
    # device time, where the launch is most of the cost)
    rms_rows = []
    decode_d = [get_config(arch).d_model for arch in ("yi-6b", ZAMBA, RWKV)]
    for rows_n, d, dtype in ((2048, 4096, torch.bfloat16), (2048, 4096, torch.float32),
                             (8192, 4096, torch.bfloat16), (8192, 4096, torch.float32),
                             *((256, c.d_model, dt) for c in moe
                               for dt in (torch.bfloat16, torch.float32)),
                             *((4, d, dt) for d in decode_d
                               for dt in (torch.bfloat16, torch.float32))):
        rtol, atol = TOL["rmsnorm"][dtype]
        x = randn(gen, rows_n, d, dtype=dtype)
        w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
        err = check_close(f"rmsnorm {dtype} ({rows_n}, {d})", rn.rmsnorm_cuda(x, w, 1e-5),
                          rmsnorm_ref(x, w, 1e-5), rtol=rtol, atol=atol,
                          why=TOL["rmsnorm"]["why"])
        if dtype == torch.bfloat16:
            nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
            b, by = bound_ms(nbytes, 4 * x.numel(), torch.float32)
            rms_rows.append({
                "shape": f"x ({rows_n}, {d}) bf16", "max_abs_err": err,
                "rtol": rtol, "atol": atol,
                "ms": timer(lambda: rn.rmsnorm_cuda(x, w, 1e-5)),
                "plain_ms": timer(lambda: rmsnorm_ref(x, w, 1e-5)),
                "library_ms": (timer(lambda: F.rms_norm(x, (d,), w, 1e-5))
                               if hasattr(F, "rms_norm") else None),
                "library_call": "F.rms_norm", "bound_ms": b, "bound_by": by})
            if rows_n == 4:
                rms_rows[-1].update(
                    device_ms=timer.device(lambda: rn.rmsnorm_cuda(x, w, 1e-5))["device_ms"],
                    library_device_ms=(timer.device(lambda: F.rms_norm(x, (d,), w, 1e-5))
                                       ["device_ms"] if hasattr(F, "rms_norm") else None))
    rows["rmsnorm"] = {**rms_rows[0], "cases": rms_rows[1:]}

    def check_swiglu(name, x, w1, w3):
        """bf16: against the plain version on the same values in fp32, rounded
        to bf16 once (the kernel's own arithmetic); fp32: directly."""
        rtol, atol = TOL["swiglu"][x.dtype]
        ref = swiglu_ref(x.float(), w1.float(), w3.float()).to(x.dtype)
        return check_close(name, sg.swiglu_cuda(x, w1, w3), ref, rtol=rtol,
                           atol=atol, why=TOL["swiglu"]["why"])

    # swiglu: prefill (512 tokens), decode (4 slots) and the train step's
    # microbatch (4 x 2048 tokens) of yi-6b's MLP gate, and its 256-token
    # serve prefill (the largest prompt of the serve phase: it sets TTFT); a
    # 256-token prefill and decode of llama4's (5120 x 8192) and arctic's
    # (7168 x 4864) dense MLP
    swiglu_cases = []
    for N, d, F_ in ((512, 4096, 11008), (4, 4096, 11008), (8192, 4096, 11008),
                     (256, 4096, 11008),
                     *((N, c.d_model, c.dense_d_ff or c.d_ff) for c in moe for N in (256, 4))):
        for dtype in (torch.bfloat16, torch.float32):
            rtol, atol = TOL["swiglu"][dtype]
            x = randn(gen, N, d, dtype=dtype)
            w1 = randn(gen, d, F_, dtype=dtype, scale=d ** -0.5)
            w3 = randn(gen, d, F_, dtype=dtype, scale=d ** -0.5)
            err = check_swiglu(f"swiglu {dtype} ({N}, {d})x({d}, {F_})", x, w1, w3)
            if dtype == torch.bfloat16:
                nbytes = (x.numel() + w1.numel() + w3.numel() + N * F_) * 2
                b, by = bound_ms(nbytes, 4 * N * d * F_, dtype)
                ms, parent_ms = timed_with_parent(timer, "swiglu",
                                                  lambda: sg.swiglu_cuda(x, w1, w3))
                swiglu_cases.append({
                    "shape": f"x ({N}, {d}), w1/w3 ({d}, {F_}) bf16",
                    "max_abs_err": err, "rtol": rtol, "atol": atol,
                    "tile": sg.swiglu_tile(N, F_, card_sms()), "ms": ms, "parent_ms": parent_ms,
                    "plain_ms": timer(lambda: swiglu_ref(x, w1, w3)),
                    "library_ms": timer(lambda: F.silu(x @ w1) * (x @ w3)),
                    "library_call": "F.silu(x@w1)*(x@w3), a cuBLAS composition",
                    "bound_ms": b, "bound_by": by})
            del x, w1, w3
    rows["swiglu"] = {**swiglu_cases[0], "cases": swiglu_cases[1:]}

    # flash attention: causal prefill of 2048 tokens (B = 1) and the train
    # step's microbatch (B = 4), yi-6b heads (32 of 128, GQA 8), the train
    # step's microbatch with gpt-1.4b heads (24 of 88, MHA), yi-6b's
    # 256-token serve prefill, and a 256-token prefill with llama4's (40q/8kv,
    # GQA 5) and arctic's (56q/8kv, GQA 7) heads
    flash_rows = []
    for B, S, Hq, Hkv, hd in ((1, 2048, 32, 4, 128), (4, 2048, 32, 4, 128),
                              (4, 2048, GPT_HEADS, GPT_HEADS, GPT_HD), (1, 256, 32, 4, 128),
                              *((1, 256, c.n_heads, c.n_kv_heads, c.resolved_head_dim)
                                for c in moe)):
        for dtype in (torch.bfloat16, torch.float32):
            err, (q, k, v) = _flash_case(
                gen, f"flash {dtype} ({B}, {S}, {Hq}q/{Hkv}kv, {hd}) causal",
                B, S, S, Hq, Hkv, hd, dtype, causal=True)
            if dtype == torch.bfloat16:
                flash_rows.append(_flash_row(timer, err, q, k, v))
            del q, k, v
        torch.cuda.empty_cache()
    rows["flash_attention"] = {**flash_rows[0], "cases": flash_rows[1:]}
    check_head_dim_refused()

    for name, B, Sq, Skv, Hq, Hkv, hd, kw in FLASH_FLAVOURS:
        for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            _flash_case(gen, f"flash {tag} {name} (B{B}, Sq{Sq}, Skv{Skv}, {Hq}q/{Hkv}kv, "
                             f"{hd})", B, Sq, Skv, Hq, Hkv, hd, dtype, **kw)
    for name, B, Sq, Skv, Hq, Hkv, kw in FLASH_EDGES:
        for hd in fa.HEAD_DIMS:
            for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
                _flash_case(gen, f"flash {tag} {name} (B{B}, Sq{Sq}, Skv{Skv}, {Hq}q/{Hkv}kv, "
                                 f"{hd})", B, Sq, Skv, Hq, Hkv, hd, dtype, **kw)
    check_swiglu_edges(gen, check_swiglu)
    check_tile_mirrors()
    # ragged rows for the other two kernels
    for dtype in (torch.bfloat16, torch.float32):
        x = randn(gen, 37, 256, dtype=dtype)
        w1 = randn(gen, 256, 520, dtype=dtype, scale=1 / 16)
        w3 = randn(gen, 256, 520, dtype=dtype, scale=1 / 16)
        check_swiglu(f"swiglu {dtype} ragged (37, 256)x(256, 520)", x, w1, w3)
        rtol, atol = TOL["rmsnorm"][dtype]
        w = (1 + 0.1 * torch.randn(256, generator=gen, device="cuda")).to(dtype)
        check_close(f"rmsnorm {dtype} (37, 256)", rn.rmsnorm_cuda(x, w, 1e-5),
                    rmsnorm_ref(x, w, 1e-5), rtol=rtol, atol=atol,
                    why=TOL["rmsnorm"]["why"])
    rows.update(gpt_kernels(timer, gen))
    return rows


def check_layernorm(name: str, x, w, b) -> float:
    from repro_torch.kernels import layernorm as ln
    from repro_torch.kernels.ref import layernorm_ref

    rtol, atol = TOL["layernorm"][x.dtype]
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    xhat = (x32 - mean) * torch.rsqrt((x32 - mean).square().mean(-1, keepdim=True) + 1e-5)
    scale = xhat.abs() * w.float().abs() + b.float().abs()
    return check_close(name, ln.layernorm_cuda(x, w, b, 1e-5), layernorm_ref(x, w, b, 1e-5),
                       rtol=rtol, atol=atol, why=TOL["layernorm"]["why"],
                       terms=((scale, LN_SCALE_TOL, "|x_hat|*|w| + |b|"),))


def check_gelu_mlp(name: str, x, w1) -> float:
    from repro_torch.kernels import gelu_mlp as gm
    from repro_torch.kernels.ref import gelu_mlp_in_ref

    rtol, atol = TOL["gelu_mlp"][x.dtype]
    scale = x.float().abs() @ w1.float().abs()
    return check_close(name, gm.gelu_mlp_cuda(x, w1), gelu_mlp_in_ref(x, w1), rtol=rtol,
                       atol=atol, why=TOL["gelu_mlp"]["why"],
                       terms=((scale, GELU_SCALE_TOL, "1.13*|x|@|w1|"),))


def gpt_kernels(timer: Timer, gen) -> dict:
    """layernorm and gelu_mlp at gpt-1.4b's widths against their plain
    versions, at a prefill of 256 tokens, decode's 4 slots and the train
    step's microbatch of 4 x 2048 tokens (the timed headline row), plus
    ragged rows; bf16 and fp32."""
    from repro_torch.kernels import gelu_mlp as gm, layernorm as ln
    from repro_torch.kernels.ref import gelu_mlp_in_ref, layernorm_ref

    ln_rows, gelu_rows = [], []
    for N in (8192, 256, 4):
        for dtype in (torch.bfloat16, torch.float32):
            # rows off zero mean: the variance is taken around the mean
            x = (torch.randn(N, GPT_D, generator=gen, device="cuda") + 1.0).to(dtype)
            w = (1 + 0.1 * torch.randn(GPT_D, generator=gen, device="cuda")).to(dtype)
            b = randn(gen, GPT_D, dtype=dtype, scale=0.1)
            err = check_layernorm(f"layernorm {dtype} ({N}, {GPT_D})", x, w, b)
            if dtype == torch.bfloat16:
                rtol, atol = TOL["layernorm"][dtype]
                nbytes = 2 * x.numel() * 2 + 2 * GPT_D * 2
                bnd, by = bound_ms(nbytes, 8 * x.numel(), torch.float32)
                ln_rows.append({
                    "shape": f"x ({N}, {GPT_D}) bf16", "max_abs_err": err, "rtol": rtol,
                    "atol": atol, "scale_tol": LN_SCALE_TOL,
                    "ms": timer(lambda: ln.layernorm_cuda(x, w, b, 1e-5)),
                    "plain_ms": timer(lambda: layernorm_ref(x, w, b, 1e-5)),
                    "library_ms": timer(lambda: F.layer_norm(x, (GPT_D,), w, b, 1e-5)),
                    "library_call": "F.layer_norm", "bound_ms": bnd, "bound_by": by})
            x = randn(gen, N, GPT_D, dtype=dtype)
            w1 = randn(gen, GPT_D, GPT_F, dtype=dtype, scale=GPT_D ** -0.5)
            err = check_gelu_mlp(f"gelu_mlp {dtype} ({N}, {GPT_D})x({GPT_D}, {GPT_F})", x, w1)
            if dtype == torch.bfloat16:
                rtol, atol = TOL["gelu_mlp"][dtype]
                nbytes = (x.numel() + w1.numel() + N * GPT_F) * 2
                bnd, by = bound_ms(nbytes, 2 * N * GPT_D * GPT_F, dtype)
                ms, parent_ms = timed_with_parent(timer, "gelu_mlp",
                                                  lambda: gm.gelu_mlp_cuda(x, w1))
                gelu_rows.append({
                    "shape": f"x ({N}, {GPT_D}), w1 ({GPT_D}, {GPT_F}) bf16",
                    "max_abs_err": err, "rtol": rtol, "atol": atol,
                    "scale_tol": GELU_SCALE_TOL,
                    "tile": gm.gelu_mlp_tile(N, GPT_F, card_sms()), "ms": ms,
                    "parent_ms": parent_ms,
                    "plain_ms": timer(lambda: gelu_mlp_in_ref(x, w1)),
                    "library_ms": timer(lambda: F.gelu(x @ w1, approximate="tanh")),
                    "library_call": "F.gelu(x @ w1, approximate='tanh'), cuBLAS + "
                                    "an elementwise pass",
                    "bound_ms": bnd, "bound_by": by})
            del x, w1
    for dtype in (torch.bfloat16, torch.float32):       # ragged rows and columns
        x = randn(gen, 37, 256, dtype=dtype)
        check_gelu_mlp(f"gelu_mlp {dtype} ragged (37, 256)x(256, 520)", x,
                       randn(gen, 256, 520, dtype=dtype, scale=1 / 16))
        check_layernorm(f"layernorm {dtype} (37, 256)", x + 2.0,
                        (1 + 0.1 * torch.randn(256, generator=gen, device="cuda")).to(dtype),
                        randn(gen, 256, dtype=dtype, scale=0.1))
    check_gelu_edges(gen)
    torch.cuda.empty_cache()
    return {"layernorm": {**ln_rows[0], "cases": ln_rows[1:]},
            "gelu_mlp": {**gelu_rows[0], "cases": gelu_rows[1:]}}


# gelu_mlp across the bf16 regime switch (N < 64 streams 64 x 64 tiles) with
# F past the last 64-, 128-, 192- and 256-column tile and d past the last
# 64-deep stage (both multiples of 8); the 192- and 256-column tiles with
# that d (on 132 SMs: 200 x 8456 takes 192, 1024 x 3080 takes 256); gpt's
# 256-token prefill
GELU_EDGES = ([(N, 264, 520) for N in (1, 3, 17, 63, 64, 200)]
              + [(200, 264, 8456), (1024, 264, 3080), (256, GPT_D, GPT_F)])


def check_gelu_edges(gen) -> None:
    """GELU_EDGES in bf16 and fp32, every bf16 tile width among them; and
    the decode regime repeats bit-for-bit (one block's fixed-order sum per
    output, no atomics)."""
    from repro_torch.kernels import gelu_mlp as gm

    widths = set()
    for N, d, F_ in GELU_EDGES:
        tile = gm.gelu_mlp_tile(N, F_, card_sms())
        widths.add(tile[1])
        for dtype in (torch.bfloat16, torch.float32):
            x = randn(gen, N, d, dtype=dtype)
            w1 = randn(gen, d, F_, dtype=dtype, scale=d ** -0.5)
            check_gelu_mlp(f"gelu_mlp {dtype} edge ({N}, {d})x({d}, {F_}), tile {tile}",
                           x, w1)
    if widths != {64, 128, 192, 256}:
        raise AssertionError(f"gelu_mlp edges reach the tile widths {sorted(widths)} on "
                             f"{card_sms()} SMs, not all four")
    x = randn(gen, 4, GPT_D, dtype=torch.bfloat16)
    w1 = randn(gen, GPT_D, GPT_F, dtype=torch.bfloat16, scale=GPT_D ** -0.5)
    first = gm.gelu_mlp_cuda(x, w1)
    same = all(torch.equal(first, gm.gelu_mlp_cuda(x, w1)) for _ in range(3))
    emit({"phase": "kernel_check", "case": f"gelu_mlp bf16 (4, {GPT_D})x({GPT_D}, {GPT_F}) "
                                           f"four times", "bit_identical": same})
    if not same:
        raise AssertionError("gelu_mlp decode: launches on the same inputs differ")


CUDA_ERROR_INVALID_VALUE = 1


def check_head_dim_refused() -> None:
    """The flash C entries refuse a head dim they were not built for (96):
    they return cudaErrorInvalidValue and launch nothing, where they once
    ran the 128-wide kernel.  Called past the Python guard (``HEAD_DIMS``)."""
    import ctypes

    from repro_torch.kernels import flash_attention as fa

    q = torch.zeros(1, 64, 1, 96, dtype=torch.bfloat16, device="cuda")
    out = torch.full_like(q, float("nan"))
    lse = torch.zeros(1, 1, 64, device="cuda")
    strides = (ctypes.c_longlong * 21)(*(list(q.stride()[:3]) * 7))
    # Hq, Hkv, Sq, Skv, hd, strides, causal, window, softcap, q_offset, scale,
    # dtype (bf16), stream
    tail = [1, 1, 64, 64, 96, strides, 1, 0, 0.0, 0, 96 ** -0.5, 1, 0]
    fwd = fa._lib().flash_attention_fwd(q.data_ptr(), q.data_ptr(), q.data_ptr(),
                                        out.data_ptr(), lse.data_ptr(), 1, *tail)
    bwd = fa._bwd_lib()
    ptrs = [q.data_ptr()] * 4 + [lse.data_ptr()] * 2 + [out.data_ptr()] * 3
    errs = {"fwd": fwd, "bwd_dq": bwd.flash_attention_bwd_dq(*ptrs, 1, *tail),
            "bwd_dkv": bwd.flash_attention_bwd_dkv(*ptrs, 1, *tail)}
    torch.cuda.synchronize()
    emit({"phase": "kernel_check", "case": "flash C entries at hd 96", "errors": errs,
          "expected": CUDA_ERROR_INVALID_VALUE})
    if set(errs.values()) != {CUDA_ERROR_INVALID_VALUE} or not out.isnan().all():
        raise AssertionError(f"flash entries at hd 96: {errs}, output written: "
                             f"{not out.isnan().all()}")


# ---------------------------------------------------------------------------
# phase 2b: the training slice's kernels (flash backward, blocked CE)
# ---------------------------------------------------------------------------

# flash backward: the kernel rounds P (for dV) and dS (for dQ and dK) to bf16
# before its products, at most 2^-8 of each value, so its error is bounded
# by 2^-8 times the products of the absolute values (|dS|@|K|*scale,
# |dS|^T@|Q|*scale, P^T@|dO|, from the plain version), plus the rounding of
# the output to bf16 (2^-8 of the value); 10% margin on both.  The rest is
# fp32 summation order over up to 16k terms: 1e-4 of the same scale.  fp32
# runs FFMA only: 1e-5 of the value and 1e-4 of the scale.  A dropped
# 64-key tile moves a gradient by a few percent of its scale.  Both dtypes:
# dS = P*(dP - delta) takes the difference of two fp32 sums of up to 128
# exact products, which cancel where dS is near 0 (query row 0 of a causal
# head exactly: O = V_0); another summation order moves each by at most
# 128*2^-24 of its absolute sum, so dQ and dK also get 128*2^-24 of
# C@|K|*scale and C^T@|Q|*scale, C = P*(|dO|@|V|^T + rowsum|dO*O|).
FLASH_BWD_TOL = {torch.bfloat16: (1.1 * 2.0 ** -8, 1.1 * 2.0 ** -8 + 1e-4),
                 torch.float32: (1e-5, 1e-4)}
FLASH_BWD_CANCEL_TOL = 128 * 2.0 ** -24
FLASH_BWD_WHY = ("bf16: P and dS rounded to bf16 inside the kernel, bounded by "
                 "2^-8 of the absolute-value products, and one rounding of the "
                 "output; fp32: FFMA, summation order; both: the cancelling "
                 "difference dP - delta in another summation order")
# CE: the kernel and the plain version both form fp32 sums of the same exact
# products (bf16 x bf16 is exact in fp32), in another order over d: 2e-5 of
# |h|@|w| (the label's column for the label logit, the row's largest for the
# lse).  One missed 256-column tile takes 1/250 of a yi-6b row's mass (~4e-3
# of its lse, a few times that limit there) and a fifth at CE_EDGES' vocab,
# so both the yi-6b train shape and CE_EDGES plant it; a label logit from
# the wrong tile is off by O(1).
CE_SCALE_TOL = 2e-5
CE_WHY = "fp32 sums of exact products in another order over d"
# the bf16 CE tiling's edges at the train step's N = 4 x 2047 (not a multiple
# of the 128-row tile) and a d past the last 64-deep stage: (N, d, V,
# valid_vocab) with valid_vocab inside tile 4 (1024..1279) and on its start,
# so that the last tile (1280..1287, past V's last full tile), or the last
# two, hold no valid column (sumexp 0)
CE_EDGES = [(4 * 2047, 520, 1288, 1100), (4 * 2047, 520, 1288, 1024)]


FLASH_BWD_FAULTS = ("dq: keys 0..127 (one 128-key tile) left out of the sum",
                    "dk/dv: query head 0 of each GQA group left out of the sum")


def flash_bwd_faults(name, q, k, v, o, lse, do, ref, terms, rtol, **kw) -> None:
    """Each of FLASH_BWD_FAULTS, built from the plain version's pieces, must
    fail the same limits: dQ less the part the first 128 keys give (the plain
    backward over those keys alone, with the full rows' LSE and delta), and
    dK and dV of the plain backward with query head 0 of each group given
    dO = 0 (so its dP, delta, dS and P^T dO are 0)."""
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    qt, kt, vt, ot, dot = (t.float().transpose(1, 2) for t in (q, k, v, o, do))
    tile0 = flash_attention_bwd_ref(qt, kt[:, :, :128], vt[:, :, :128], ot, lse, dot, **kw)[0]
    G = q.shape[2] // k.shape[2]
    dropped = dot.clone()
    dropped[:, ::G] = 0
    _, dk_bad, dv_bad = flash_attention_bwd_ref(qt, kt, vt, ot, lse, dropped, **kw)
    faults = {FLASH_BWD_FAULTS[0]: [(ref[0] - tile0, ref[0], terms[0])],
              FLASH_BWD_FAULTS[1]: [(dk_bad, ref[1], terms[1]), (dv_bad, ref[2], terms[2])]}
    for fault, outs in faults.items():
        worst = max(float(limit_share(bad, r, rtol, 1e-6, gterms)[1].max())
                    for bad, r, gterms in outs)
        emit({"phase": "planted_fault", "case": name, "fault": fault,
              "worst_share_of_limit": worst})
        if worst <= 1:
            raise AssertionError(f"{name}: the flash bwd limit does not catch a planted "
                                 f"fault ({fault}: {worst:.2f} of it)")


def flash_bwd_case(name, gen, B, Sq, Skv, Hq, Hkv, hd, dtype, planted=False, **kw):
    """Forward kernel, then the two backward kernels against
    ``flash_attention_bwd_ref`` on the same q, k, v, o, lse and dO; with
    ``planted``, also FLASH_BWD_FAULTS against the same limits."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    q = randn(gen, B, Sq, Hq, hd, dtype=dtype)
    k = randn(gen, B, Skv, Hkv, hd, dtype=dtype)
    v = randn(gen, B, Skv, Hkv, hd, dtype=dtype)
    do = randn(gen, B, Sq, Hq, hd, dtype=dtype)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    ref, scales, cancel = flash_attention_bwd_ref(
        *(t.float().transpose(1, 2) for t in (q, k, v, o)), lse,
        do.float().transpose(1, 2), return_scales=True, **kw)
    rtol, stol = FLASH_BWD_TOL[dtype]
    terms = (((scales[0], stol, "|dS|@|K|*scale"),
              (cancel[0], FLASH_BWD_CANCEL_TOL, "C@|K|*scale")),
             ((scales[1], stol, "|dS|^T@|Q|*scale"),
              (cancel[1], FLASH_BWD_CANCEL_TOL, "C^T@|Q|*scale")),
             ((scales[2], stol, "P^T@|dO|"),))
    del scales, cancel
    errs = []
    for gname, out, r, gterms in zip(("dq", "dk", "dv"), grads, ref, terms):
        errs.append(check_close(f"{name} {gname}", out, r.transpose(1, 2), rtol=rtol,
                                atol=1e-6, why=FLASH_BWD_WHY,
                                terms=tuple((sc.transpose(1, 2), tol, sn)
                                            for sc, tol, sn in gterms)))
    if planted:
        flash_bwd_faults(name, q, k, v, o, lse, do, ref, terms, rtol, **kw)
    return errs, (q, k, v, o, lse, do)


CE_FAULTS = ("column tile 0 left out of the sum", "label logit from the next tile")


def ce_check(name, h, w, labels, valid_vocab, lse, ll, owned=None):
    """(lse, label_logit) against ``cross_entropy_ref`` on h, w, labels under
    the CE limits (the label logit only where ``owned``, if given); returns
    the two errors, the references and the limit terms."""
    from repro_torch.kernels.ref import cross_entropy_ref

    rlse, rll = cross_entropy_ref(h, w, labels, valid_vocab)
    absw = h.float().abs() @ w.float().abs()
    if valid_vocab is not None:
        absw[:, valid_vocab:] = 0
    lab_scale = torch.gather(absw, 1, labels.long()[:, None])[:, 0]
    lse_terms = ((absw.amax(1), CE_SCALE_TOL, "max |h|@|w|"),)
    ll_terms = ((lab_scale, CE_SCALE_TOL, "|h|@|w| at label"),)
    del absw
    keep = slice(None) if owned is None else owned
    e1 = check_close(f"{name} lse", lse, rlse, rtol=0, atol=1e-6, why=CE_WHY, terms=lse_terms)
    e2 = check_close(f"{name} label_logit", ll[keep], rll[keep], rtol=0, atol=1e-6,
                     why=CE_WHY, terms=((ll_terms[0][0][keep],) + ll_terms[0][1:],))
    return (e1, e2), (rlse, rll), (lse_terms, ll_terms)


def ce_case(name, gen, N, d, V, dtype, valid_vocab=None, labels=None, planted=False):
    """The CE kernel against ``cross_entropy_ref`` on the same h, w, labels;
    with ``planted``, each of CE_FAULTS, built from the plain partials
    (``cross_entropy.partials_ref``, ``merge_ref``) with one fault, must
    fail the same limits."""
    from repro_torch.kernels import cross_entropy as ce

    h = randn(gen, N, d, dtype=dtype)
    w = randn(gen, d, V, dtype=dtype, scale=d ** -0.5)
    if labels is None:
        labels = torch.randint(0, valid_vocab or V, (N,), generator=gen, device="cuda")
    lse, ll = ce.cross_entropy_cuda(h, w, labels, valid_vocab)
    (e1, e2), (rlse, rll), (lse_terms, ll_terms) = ce_check(name, h, w, labels, valid_vocab,
                                                            lse, ll)
    if planted:
        m, s, _ = ce.partials_ref(h.float(), w.float(), labels, valid_vocab, ce.TILE_N)
        vv = valid_vocab or V
        lab = labels.long()
        moved = torch.where(lab + ce.TILE_N < vv, lab + ce.TILE_N, lab - ce.TILE_N)
        faults = {CE_FAULTS[0]: (ce.merge_ref(m[1:], s[1:]), rlse, lse_terms),
                  CE_FAULTS[1]: (torch.gather(h.float() @ w.float(), 1, moved[:, None])[:, 0],
                                 rll, ll_terms)}
        for fault, (bad, ref, terms) in faults.items():
            worst = float(limit_share(bad, ref, 0, 1e-6, terms)[1].max())
            emit({"phase": "planted_fault", "case": name, "fault": fault,
                  "worst_share_of_limit": worst})
            if worst <= 1:
                raise AssertionError(f"{name}: the CE limit does not catch a planted fault "
                                     f"({fault}: {worst:.2f} of it)")
    return max(e1, e2), (h, w, labels)


def flash_bwd_times(timer: Timer, errs: list, q, k, v, o, lse, do,
                    parent: bool = True, causal: bool = True) -> tuple[dict, dict]:
    """The dQ and dK/dV rows of the kernels line at q's and k's shapes."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    B, S, Hq, hd = q.shape
    pairs = flash_pairs(B, Hq, S, k.shape[1], causal)
    args, _ = fa.bwd_args(q, k, v, o, lse, do, causal=causal)
    qt, kt, vt, ot, dot = (t.transpose(1, 2) for t in (q, k, v, o, do))
    plain_ms = timer(lambda: flash_attention_bwd_ref(qt, kt, vt, ot, lse, dot, causal=causal))
    try:
        ql, kl, vl = (t.detach().requires_grad_() for t in (qt, kt, vt))
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, enable_gqa=True)
        lib_ms = timer(lambda: torch.autograd.grad(out, (ql, kl, vl), dot,
                                                   retain_graph=True))
    except TypeError:                               # torch without enable_gqa
        lib_ms = None
    el = q.element_size()
    common = {"shape": f"q/o/dO ({B}, {S}, {Hq}, {hd}), k/v ({B}, {k.shape[1]}, "
                       f"{k.shape[2]}, {hd}) bf16 {'causal' if causal else 'non-causal'}",
              "plain_ms": plain_ms, "plain_call": "flash_attention_bwd_ref (dq, dk, dv)",
              "library_ms": lib_ms,
              "library_call": "SDPA(enable_gqa=True) backward on a retained graph "
                              "(dq, dk and dv together)",
              "bwd_bound_ms": bound_ms(0, 5 * 2 * hd * pairs, q.dtype)[0]}
    # dQ: S, dP and dS@K over the unmasked pairs; reads Q, K, V, dO, LSE,
    # delta and writes dQ
    b, by = bound_ms(el * (3 * q.numel() + 2 * k.numel()) + 8 * B * Hq * S,
                     3 * 2 * hd * pairs, q.dtype)
    ms, parent_ms = _timed(timer, "flash_attention_bwd", lambda: fa.launch_bwd_dq(args), parent)
    dq = {**common, "max_abs_err": errs[0], "ms": ms, "parent_ms": parent_ms,
          "bound_ms": b, "bound_by": by}
    # dK/dV: S^T, dP^T, dS^T@Q and P^T@dO; writes dK and dV
    b, by = bound_ms(el * (2 * q.numel() + 4 * k.numel()) + 8 * B * Hq * S,
                     4 * 2 * hd * pairs, q.dtype)
    ms, parent_ms = _timed(timer, "flash_attention_bwd", lambda: fa.launch_bwd_dkv(args),
                           parent)
    dkv = {**common, "max_abs_err": max(errs[1:]), "ms": ms, "parent_ms": parent_ms,
           "bound_ms": b, "bound_by": by}
    return dq, dkv


def check_bwd_repeats(q, k, v, o, lse, do) -> None:
    """Both bf16 backward kernels, launched twice on the same inputs, give
    the same bits: every sum runs in one block in a fixed order."""
    from repro_torch.kernels import flash_attention as fa

    first = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)
    second = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)
    same = {g: torch.equal(a, b) for g, a, b in zip(("dq", "dk", "dv"), first, second)}
    emit({"phase": "kernel_check", "case": f"flash bwd bf16 {tuple(q.shape)} "
                                           f"{k.shape[2]}kv twice", "bit_identical": same})
    if not all(same.values()):
        raise AssertionError(f"flash bwd: two launches on the same inputs differ: {same}")


def phase_kernels_train(timer: Timer) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)
    # flash backward at the forward's timed shapes: causal S = 2048, yi-6b
    # heads at B = 1 and at the train step's microbatch (B = 4), and
    # gpt-1.4b's heads (24 of 88) at B = 4
    # (the yi-6b train shape, bf16, also with FLASH_BWD_FAULTS planted and
    # launched twice for bit-identical repeats)
    timed = []
    for B, Hq, Hkv, hd in ((1, 32, 4, 128), (4, 32, 4, 128), (4, GPT_HEADS, GPT_HEADS, GPT_HD)):
        for dtype in (torch.bfloat16, torch.float32):
            train = dtype == torch.bfloat16 and (B, Hkv) == (4, 4)
            errs, tensors = flash_bwd_case(
                f"flash bwd {dtype} ({B}, 2048, {Hq}q/{Hkv}kv, {hd}) causal", gen, B, 2048,
                2048, Hq, Hkv, hd, dtype, planted=train, causal=True)
            if train:
                check_bwd_repeats(*tensors)
            if dtype == torch.bfloat16:
                timed.append(flash_bwd_times(timer, errs, *tensors))
            del tensors
            torch.cuda.empty_cache()
    rows = {"flash_attention_bwd_dq": {**timed[0][0], "cases": [t[0] for t in timed[1:]]},
            "flash_attention_bwd_dkv": {**timed[0][1], "cases": [t[1] for t in timed[1:]]}}
    for name, B, Sq, Skv, Hq_, Hkv, hd_, kw in FLASH_FLAVOURS:
        for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            flash_bwd_case(f"flash bwd {tag} {name} (B{B}, Sq{Sq}, Skv{Skv}, "
                           f"{Hq_}q/{Hkv}kv, {hd_})", gen, B, Sq, Skv, Hq_, Hkv, hd_,
                           dtype, **kw)
    flash_bwd_edges(gen)
    rows["cross_entropy"] = ce_kernels(timer, gen)
    return rows


def flash_bwd_edges(gen) -> None:
    """FLASH_EDGES through both backward kernels at every head dim, bf16 and
    fp32: the edges of the bf16 tiling (partial query and key tiles, the
    diagonal, a window edge with q_offset, rows that see no key)."""
    from repro_torch.kernels import flash_attention as fa

    for name, B, Sq, Skv, Hq, Hkv, kw in FLASH_EDGES:
        for hd in fa.HEAD_DIMS:
            for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
                flash_bwd_case(f"flash bwd {tag} {name} (B{B}, Sq{Sq}, Skv{Skv}, "
                               f"{Hq}q/{Hkv}kv, {hd})", gen, B, Sq, Skv, Hq, Hkv, hd, dtype,
                               **kw)


def ce_kernels(timer: Timer, gen) -> dict:
    """CE at the train step's shape, a microbatch of 4 x 2047 tokens of
    yi-6b (the headline row, with planted faults), then of gpt-1.4b, timed;
    then ragged shapes and CE_EDGES, with planted faults."""
    from repro_torch.kernels import cross_entropy as ce
    from repro_torch.kernels.ref import cross_entropy_ref

    ce_rows = []
    N = 4 * 2047
    for d, V in ((4096, 64000), (GPT_D, 51200)):
        for dtype in (torch.bfloat16, torch.float32):
            err, (h, w, labels) = ce_case(
                f"ce {dtype} ({N}, {d})x({d}, {V})", gen, N, d, V, dtype,
                planted=dtype == torch.bfloat16 and d == 4096)
            if dtype == torch.bfloat16:
                b, by = bound_ms(2 * (h.numel() + w.numel()) + 8 * N + 8 * N,
                                 2 * N * d * V, dtype)
                ms, parent_ms = timed_with_parent(
                    timer, "cross_entropy", lambda: ce.cross_entropy_cuda(h, w, labels))
                ce_rows.append({
                    "shape": f"h ({N}, {d}), w ({d}, {V}) bf16", "max_abs_err": err,
                    "tile": [ce.TILE_M, ce.TILE_N],
                    "partials": ce.n_partials(V, dtype), "ms": ms, "parent_ms": parent_ms,
                    "plain_ms": timer(lambda: cross_entropy_ref(h, w, labels)),
                    "plain_call": "cross_entropy_ref (materialized fp32 logits)",
                    "library_ms": timer(lambda: F.cross_entropy(
                        (h @ w).float(), labels, reduction="none")),
                    "library_call": "F.cross_entropy on (h @ w).float()",
                    "bound_ms": b, "bound_by": by})
            del h, w, labels
        torch.cuda.empty_cache()
    V2 = 1000   # not a multiple of the 256-column tile; last tile partial
    labels = torch.tensor([996, 999, 0, 640] * 250, device="cuda")[:1000]
    for dtype in (torch.bfloat16, torch.float32):
        ce_case(f"ce {dtype} ragged (1000, 256)x(256, {V2}), valid 997, last-tile labels",
                gen, 1000, 256, V2, dtype, valid_vocab=997, labels=labels)
        ce_case(f"ce {dtype} ragged (37, 512)x(512, 2056), past one 2048-column chunk", gen,
                37, 512, 2056, dtype)
    for N, d, V, vv in CE_EDGES:
        # the label at valid_vocab - 1, in the last valid tile, in tile 0 and inside
        first = (vv - 1) // 256 * 256
        labels = torch.tensor([vv - 1, first, 0, 777], device="cuda").repeat(-(-N // 4))[:N]
        for dtype in (torch.bfloat16, torch.float32):
            ce_case(f"ce {dtype} edge ({N}, {d})x({d}, {V}), valid {vv}", gen, N, d, V, dtype,
                    valid_vocab=vv, labels=labels, planted=dtype == torch.bfloat16)
    return {**ce_rows[0], "cases": ce_rows[1:]}




# ---------------------------------------------------------------------------
# phase 2c: the moe slice's grouped expert MLP
# ---------------------------------------------------------------------------

# grouped MLP: kernel and plain version differ by (a) the kernel's rounding of
# h for the bf16 down product: h reaches it as two bf16 planes, hi = bf16(h)
# and lo = bf16(h - hi), whose sum is h to within 2^-16 of it (the kernel
# before the Hopper redesign rounded h to TF32, at most 2^-11; that TF32
# term is kept unchanged as an upper bound of (a)), (b) the order of their
# fp32 sums over d (the gate, carried to the
# output through the activation's slope, |silu'| <= 1.1, |gelu'| <= 1.13,
# and w2) and over F (the down product), and (c) in bf16 one ULP between the
# output roundings.  (a) and (b) add many small independent roundings over F
# (and d), so at an output they spread like the root of the sum of squares
# (RSS) of the terms rounded, not like the sum of their bounds (which grows
# with d and F far faster than the error does): (a) has an rms of at most
# 2^-11/sqrt(3) of RSS_f(h*w2), (b) of 2^-24*sqrt(2n) of the RSS of the n
# terms summed on each side.  The check allows GROUPED_SIGMAS of those rms;
# over the ~10^6 outputs of a case a sound kernel's largest reading is near
# 5.5 of them.  Three planted faults must fail the same limit at the full
# widths: h rounded to bf16 (hi alone, 2^-8), and the first 32-wide k-tile of
# the gate's or of the down product's sum left out.
GROUPED_SIGMAS = 8.0
GROUPED_TF32_RMS = 2.0 ** -11 / 3 ** 0.5
GROUPED_SUM_RMS = 2.0 ** -24 * 2 ** 0.5          # times sqrt(n)
GROUPED_WHY = ("bf16: h into the down product as bf16 hi + lo (within 2^-16), bounded "
               "by the TF32 rounding (2^-11) the term keeps; fp32 sums in another "
               "order over d and F; each as 8 rms of its spread (the RSS of its "
               "rounded terms); bf16: one ULP between the output roundings")
GROUPED_FAULTS = ("h rounded to bf16", "gate k-tile 0 skipped", "down k-tile 0 skipped")


def routed_mask(gen, G: int, g: int, E: int, top_k: int, C: int) -> torch.Tensor:
    """The (E, G*C) slot mask that the model's own router gives G groups of g
    tokens under softmax-of-Gaussian gates, in ``_expert_mlps``' layout."""
    from repro_torch.models.moe import _route

    gates = torch.softmax(torch.randn(G, g, E, generator=gen, device="cuda"), -1)
    slot_valid = _route(gates, top_k, C)[2]
    return slot_valid.reshape(G, E, C).transpose(0, 1).reshape(E, G * C).float()


def grouped_terms(x, w1, w3, w2, mask, act: str,
                  planted: bool = False) -> tuple[tuple, dict]:
    """The error terms of the grouped check over (E, N, d) fp32 scales,
    zero for experts with no valid slot: RSS_f(h*w2) and RSS_f(slope*w2),
    with slope = 1.1*|b|*RSS_d(x*w1) + |silu(a)|*RSS_d(x*w3) (swiglu) or
    1.13*RSS_d(x*w1) (gelu); computed a few experts at a time.  With
    ``planted``, also the plain version's output under each of
    GROUPED_FAULTS."""
    from repro_torch.kernels.ref import gelu_tanh

    E, N, d = x.shape
    F_ = w1.shape[-1]
    hs = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    gs = torch.zeros_like(hs)
    faults = {k: torch.zeros_like(x) for k in GROUPED_FAULTS} if planted else {}
    for e in mask.ne(0).any(1).nonzero()[:, 0].split(4):
        m = mask[e].float()[..., None]
        x32 = x[e].float() * m
        w1e = w1[e].float()
        a = torch.bmm(x32, w1e)
        ra = torch.bmm(x32.square(), w1e.square()).sqrt_()
        a_skip = a - torch.bmm(x32[..., :32], w1e[:, :32]) if planted else None
        del w1e
        if act == "swiglu":
            w3e = w3[e].float()
            b = torch.bmm(x32, w3e)
            rb = torch.bmm(x32.square(), w3e.square()).sqrt_()
            h = F.silu(a) * b
            slope = 1.1 * b.abs() * ra + F.silu(a).abs() * rb
            if planted:
                h_skip = F.silu(a_skip) * (b - torch.bmm(x32[..., :32], w3e[:, :32]))
            del w3e
        else:
            h = gelu_tanh(a)
            slope = 1.13 * ra
            h_skip = gelu_tanh(a_skip) if planted else None
        w2e = w2[e].float()
        w2sq = w2e.square()
        hs[e] = torch.bmm(h.square(), w2sq).sqrt_() * m
        gs[e] = torch.bmm(slope.square(), w2sq).sqrt_() * m
        if planted:
            for name, (hh, ww) in zip(GROUPED_FAULTS, (
                    (h.bfloat16().float(), w2e), (h_skip, w2e), (h[..., 32:], w2e[:, 32:]))):
                faults[name][e] = (torch.bmm(hh, ww) * m).to(x.dtype)
    bf16 = x.dtype == torch.bfloat16
    h_rms = (GROUPED_TF32_RMS if bf16 else 0.0) + GROUPED_SUM_RMS * F_ ** 0.5
    return ((hs, GROUPED_SIGMAS * h_rms, "RSS_f(h*w2)"),
            (gs, GROUPED_SIGMAS * GROUPED_SUM_RMS * d ** 0.5, "RSS_f(slope*w2)")), faults


def check_grouped(name: str, x, w1, w3, w2, mask, act: str, planted: bool = False) -> float:
    """The grouped kernel against ``grouped_mlp_ref`` on the same inputs, with
    the masked rows exactly 0; with ``planted``, each planted fault of the
    plain version must fail the same limit."""
    from repro_torch.kernels import grouped_mlp as gp
    from repro_torch.kernels.ref import grouped_mlp_ref

    out = gp.grouped_mlp_cuda(x, w1, w3, w2, mask, act)
    torch.cuda.synchronize()
    dead = out[mask == 0]
    emit({"phase": "kernel_check", "case": name + " masked rows",
          "masked_rows": int((mask == 0).sum()), "nonzero": int(dead.ne(0).sum())})
    if dead.ne(0).any():
        raise AssertionError(f"{name}: masked rows are not exactly 0")
    terms, faults = grouped_terms(x, w1, w3, w2, mask, act, planted)
    ref = grouped_mlp_ref(x, w1, w3, w2, mask, act)
    rtol = 1.1 * BF16_ULP if x.dtype == torch.bfloat16 else 1e-6
    err = check_close(name, out, ref, rtol=rtol, atol=1e-6, why=GROUPED_WHY, terms=terms)
    for fault, bad in faults.items():
        worst = float(limit_share(bad, ref, rtol, 1e-6, terms)[1].max())
        emit({"phase": "planted_fault", "case": name, "fault": fault,
              "worst_share_of_limit": worst})
        if worst <= 1:
            raise AssertionError(f"{name}: the limit does not catch a planted fault "
                                 f"({fault}: {worst:.2f} of it)")
    return err


def grouped_bmm(x, w1, w3, w2, mask, act: str) -> torch.Tensor:
    """The same function as one cuBLAS composition over all experts (the
    yardstick; the port never calls it)."""
    a = torch.bmm(x, w1)
    h = F.silu(a) * torch.bmm(x, w3) if act == "swiglu" else F.gelu(a, approximate="tanh")
    return torch.bmm(h, w2) * mask[..., None].to(x.dtype)


def grouped_row(timer: Timer, err: float, x, w1, w3, w2, mask, act: str) -> dict:
    """The timed row of a bf16 case, with the version before the Hopper
    redesign (``parent_ms``) on the same inputs in turns: the bound counts
    the weights of the experts with a valid slot, x and the output, or the
    FLOPs of the valid slots."""
    from repro_torch.kernels import grouped_mlp as gp
    from repro_torch.kernels.ref import grouped_mlp_ref

    E, N, d = x.shape
    F_ = w1.shape[-1]
    n_w = 3 if act == "swiglu" else 2
    live = int(mask.ne(0).any(1).sum())
    valid = int(mask.ne(0).sum())
    b, by = bound_ms(live * n_w * d * F_ * 2 + 2 * x.numel() * 2 + mask.numel() * 4,
                     2 * valid * n_w * d * F_, x.dtype)
    ms, parent_ms = timed_with_parent(timer, "grouped_mlp",
                                      lambda: gp.grouped_mlp_cuda(x, w1, w3, w2, mask, act))
    return {"shape": f"x ({E}, {N}, {d}), F {F_}, {act}, bf16", "experts_with_a_slot": live,
            "valid_slots": valid, "max_abs_err": err, "sigmas": GROUPED_SIGMAS,
            "ms": ms, "parent_ms": parent_ms, "share_of_bound": b / ms,
            "plain_ms": timer(lambda: grouped_mlp_ref(x, w1, w3, w2, mask, act)),
            "library_ms": timer(lambda: grouped_bmm(x, w1, w3, w2, mask, act)),
            "library_call": "torch.bmm composition over all experts (bmm, silu, mul, "
                            "bmm, mask)",
            "bound_ms": b, "bound_by": by}


def phase_kernels_moe(timer: Timer) -> dict:
    """The grouped kernel at the serve path's shapes: G = 1 group of a
    256-token prefill bucket (N = C = 3 for llama4's top-1, 5 for arctic's
    top-2) and decode's G = 4 slots of one token (N = 4, at most 4*k valid),
    masks from the model's router on random gates; arctic's widths again
    with the gelu body; each of these also holds GROUPED_FAULTS, planted in
    the plain version, to fail the same limit.  Then reduced fp32 and bf16
    cases with ragged N and F, an expert with no valid slot and a live expert
    with a whole masked 64-row tile, and a bf16 case with every slot masked.
    At each bf16 mask the C entry's work list is held to its Python mirror
    (``tiling.grouped_order``), and at decode two launches must be
    bit-identical."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_mlp as gp
    from repro_torch.models.moe import moe_capacity

    gen = torch.Generator(device="cuda").manual_seed(3)
    timed = []
    orders = 0
    for arch, acts in ((LLAMA4, ("swiglu",)), (ARCTIC, ("swiglu", "gelu"))):
        cfg = get_config(arch)
        E, d, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
        w1, w3, w2 = (torch.randn(*shape, generator=gen, device="cuda",
                                  dtype=torch.bfloat16).mul_(shape[1] ** -0.5)
                      for shape in ((E, d, F_), (E, d, F_), (E, F_, d)))
        for act in acts:
            for what, G, g in (("prefill 256", 1, 256), ("decode", 4, 1),
                               ("train 4 x 2048", 4, 2048)):
                if (act == "gelu" and what == "decode"
                        or what.startswith("train") and (arch != ARCTIC or act == "gelu")):
                    continue
                C = moe_capacity(g, cfg)
                mask = routed_mask(gen, G, g, E, cfg.top_k, C)
                x = torch.randn(E, G * C, d, generator=gen, device="cuda",
                                dtype=torch.bfloat16)
                w3a = w3 if act == "swiglu" else None
                name = f"grouped {arch} {what} {act} bf16 (E {E}, N {G * C}, d {d}, F {F_})"
                err = check_grouped(name, x, w1, w3a, w2, mask, act,
                                    planted=not what.startswith("train"))
                orders += check_grouped_order(mask, d, F_)
                if what == "decode":
                    first = gp.grouped_mlp_cuda(x, w1, w3a, w2, mask, act)
                    if not torch.equal(first, gp.grouped_mlp_cuda(x, w1, w3a, w2, mask, act)):
                        raise AssertionError(f"{name}: two launches differ")
                timed.append({"case": f"{arch} {what}",
                              **grouped_row(timer, err, x, w1, w3a, w2, mask, act)})
        del w1, w3, w2
        torch.cuda.empty_cache()

    # reduced widths: ragged N (37 rows, 130 = 2 tiles + 2) and F (520, 96),
    # expert 1 with no valid slot, expert 0 with rows 64..127 masked whole
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for act in ("swiglu", "gelu"):
            for E, N, d, F_ in ((8, 37, 256, 520), (4, 130, 128, 96)):
                x = randn(gen, E, N, d, dtype=dtype)
                w1 = randn(gen, E, d, F_, dtype=dtype, scale=d ** -0.5)
                w3 = randn(gen, E, d, F_, dtype=dtype, scale=d ** -0.5) if act == "swiglu" else None
                w2 = randn(gen, E, F_, d, dtype=dtype, scale=F_ ** -0.5)
                mask = (torch.rand(E, N, generator=gen, device="cuda") > 0.4).float()
                mask[1] = 0
                mask[0, 64:128] = 0
                check_grouped(f"grouped {act} {tag} ragged (E {E}, N {N}, d {d}, F {F_})",
                              x, w1, w3, w2, mask, act)
                if dtype == torch.bfloat16:
                    orders += check_grouped_order(mask, d, F_)
    # every slot masked: no live expert, no item, the output all zeros
    x = randn(gen, 4, 37, 256, dtype=torch.bfloat16)
    w1, w3 = (randn(gen, 4, 256, 520, dtype=torch.bfloat16, scale=256 ** -0.5) for _ in range(2))
    w2 = randn(gen, 4, 520, 256, dtype=torch.bfloat16, scale=520 ** -0.5)
    mask = torch.zeros(4, 37, device="cuda")
    check_grouped("grouped swiglu bf16 every slot masked (E 4, N 37, d 256, F 520)",
                  x, w1, w3, w2, mask, "swiglu")
    orders += check_grouped_order(mask, 256, 520)
    emit({"phase": "kernel_check", "case": "grouped work list agrees with its mirror",
          "masks_and_widths": orders})
    timed += grouped_train_expert_cut(timer, gen)
    return {"grouped_mlp": {**timed[0], "cases": timed[1:]}}


# the grouped Function's backward (kernels/ref.py:grouped_mlp_bwd_ref: an fp32
# recompute of h, its gradients rounded to the inputs' bf16) against torch
# autograd of the plain fp32 grouped_mlp_ref on the same bf16-valued inputs.
# Both run fp32 products of the same values; they differ by the output
# rounding (at most half a bf16 ULP, 2^-8 of the value) and by the few fp32
# roundings by which their formulas for silu' and h part (GROUPED_BWD_U)
# and the order of the fp32 sums over F or N (GROUPED_SUM_RMS sqrt(n)), each
# carried through as an RSS of the summed terms, 8 of its rms
GROUPED_BWD_U = 4 * 2.0 ** -24
GROUPED_BWD_WHY = ("the Function's gradients rounded to bf16 (2^-8 of the value); "
                   "its fp32 formulas for h and silu' a few roundings from autograd's "
                   "and fp32 sums in another order, carried through each sum as an "
                   "RSS of its terms (8 rms)")


def grouped_bwd_terms(x, w1, w3, w2, mask, g) -> dict:
    """{grad: the RSS scale of its sum} for dx (over F), dw1 / dw3 (over
    N) and dw2 (over N), from the fp32 recompute's terms."""
    m = mask.float()[..., None]
    x32, g32 = x.float() * m, g.float() * m
    w1_32, w3_32, w2_32 = w1.float(), w3.float(), w2.float()
    a, b = torch.bmm(x32, w1_32), torch.bmm(x32, w3_32)
    dh = torch.bmm(g32, w2_32.transpose(1, 2))
    sig = torch.sigmoid(a)
    h = a * sig * b
    da, db = dh * b * (sig * (1.0 + a * (1.0 - sig))), dh * a * sig
    x2 = x32.square().transpose(1, 2)
    out = {"dx": (torch.bmm(da.square(), w1_32.square().transpose(1, 2))
                  + torch.bmm(db.square(), w3_32.square().transpose(1, 2))).sqrt_(),
           "dw1": torch.bmm(x2, da.square()).sqrt_(), "dw3": torch.bmm(x2, db.square()).sqrt_(),
           "dw2": torch.bmm(h.square().transpose(1, 2), g32.square()).sqrt_()}
    return out


def grouped_train_expert_cut(timer: Timer, gen) -> list[dict]:
    """The grouped kernel at the train phase's arctic shape: 8 of its 128
    experts (the expert count the card trains), TRAIN's microbatch of 4 x
    2048 tokens, so C 640 and N 2560 rows an expert, bf16, the mask from
    the model's router: forward against its plain version, timed beside
    the version before the Hopper redesign and the bmm composition; then
    the Function's backward (the plain fp32 recompute) against fp32
    autograd of ``grouped_mlp_ref``, and its time."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_mlp as gp
    from repro_torch.kernels.ref import grouped_mlp_bwd_ref, grouped_mlp_ref
    from repro_torch.models.moe import moe_capacity

    cfg = train_config(ARCTIC)
    E, d, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
    G, g = TRAIN["global_batch"] // TRAIN["gas"], TRAIN["seq_len"]
    C = moe_capacity(g, cfg)
    w1, w3, w2 = (torch.randn(*shape, generator=gen, device="cuda",
                              dtype=torch.bfloat16).mul_(shape[1] ** -0.5)
                  for shape in ((E, d, F_), (E, d, F_), (E, F_, d)))
    mask = routed_mask(gen, G, g, E, cfg.top_k, C)
    x = torch.randn(E, G * C, d, generator=gen, device="cuda", dtype=torch.bfloat16)
    name = f"grouped {ARCTIC} train {E} experts swiglu bf16 (E {E}, N {G * C}, d {d}, F {F_})"
    err = check_grouped(name, x, w1, w3, w2, mask, "swiglu")
    row = {"case": f"{ARCTIC} train, {E} of {get_config(ARCTIC).n_experts} experts",
           **grouped_row(timer, err, x, w1, w3, w2, mask, "swiglu")}
    # the backward: the Function (kernel forward, plain fp32 recompute
    # backward) against fp32 autograd of the plain version
    dy = torch.randn(x.shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    leaves = [t.detach().requires_grad_() for t in (x, w1, w3, w2)]
    gp.grouped_mlp(leaves[0], leaves[1], leaves[2], leaves[3], mask, "swiglu").backward(dy)
    got = {n: t.grad for n, t in zip(("dx", "dw1", "dw3", "dw2"), leaves)}
    del leaves
    ref_leaves = [t.detach().float().requires_grad_() for t in (x, w1, w3, w2)]
    grouped_mlp_ref(ref_leaves[0], ref_leaves[1], ref_leaves[2], ref_leaves[3], mask,
                    "swiglu").backward(dy.float())
    scales = grouped_bwd_terms(x, w1, w3, w2, mask, dy)
    errs = {}
    for n, t in zip(("dx", "dw1", "dw3", "dw2"), ref_leaves):
        summed = F_ if n == "dx" else G * C          # the length of its sum
        tol = GROUPED_SIGMAS * (GROUPED_BWD_U + GROUPED_SUM_RMS * summed ** 0.5)
        errs[n] = check_close(f"{name} backward {n}", got[n], t.grad, rtol=2.0 ** -8 * 1.1,
                              atol=1e-6, why=GROUPED_BWD_WHY,
                              terms=((scales[n], tol, f"RSS({n})"),))
    del ref_leaves, scales, got
    torch.cuda.empty_cache()
    n_w = 3
    valid = int(mask.ne(0).sum())
    # the backward's work: 2 products to recompute h, 1 for dh, and 2 a
    # weight (its gradient and dx's part), over the valid slots
    bwd_b, bwd_by = bound_ms(2 * n_w * E * d * F_ * 2 + 3 * x.numel() * 2 + mask.numel() * 4,
                             2 * valid * d * F_ * (2 + 1 + 2 * n_w), torch.float32)
    row.update(backward_ms=timer(lambda: grouped_mlp_bwd_ref(x, w1, w3, w2, mask, dy)),
               backward_bound_ms=bwd_b, backward_bound_by=bwd_by,
               backward_what="kernels/ref.py:grouped_mlp_bwd_ref, plain fp32 (no TF32)",
               backward_max_abs_err=errs)
    del x, w1, w3, w2
    torch.cuda.empty_cache()
    return [row]


def check_grouped_order(mask: torch.Tensor, d: int, F_: int) -> int:
    """The bf16 grouped kernels' work items from the (E, N) mask on the card
    (``grouped_mlp_items``: the prologue's live row tiles, then GroupedTiles'
    order) equal ``tiling.grouped_order`` for the gate (F columns) and the
    down product (d)."""
    from repro_torch.kernels import grouped_mlp as gp, tiling

    for cols in (F_, d):
        got, want = gp.grouped_items_cuda(mask, cols), tiling.grouped_order(mask.cpu(), cols)
        if got != want:
            raise AssertionError(f"grouped work list {tuple(mask.shape)}, {cols} columns: C "
                                 f"{got[:6]}... ({len(got)}), mirror {want[:6]}... ({len(want)})")
    return 2


# ---------------------------------------------------------------------------
# phase 2d: the hybrid slice's SSD scan, mamba decode step and flash at hd 80
# ---------------------------------------------------------------------------

U32 = 2.0 ** -24         # one fp32 rounding
# SSD scan: the kernel and the plain version run the same fp32 chunk algebra
# in another order, with their own exp and cumsum.  ssd_error_bound gives the
# first-order bound of that difference, term by term (u = 2^-24 a rounding,
# a sum of n terms off by n u of its absolute sum): the N-term C.B and C.S
# sums, the Q-term sums over j, exp (2 ulp), the products, and the exponents:
# an inclusive cumsum of Q terms of one sign is off by Q u |cum|, so
# e^(cum_i - cum_j) is off by Q u (|cum_i| + |cum_j|) + u |gap| of itself;
# the state's error carries from chunk to chunk.  Each implementation may be
# off by the bound, so the check allows twice it, and in bf16 one ULP
# between the output roundings.  Planted faults (the state not carried into
# the second chunk; one token's x left out) must fail the same limit.
SSD_WHY = ("fp32 chunk algebra in another order, with its own exp and cumsum: "
           "twice the first-order bound of each (ssd_error_bound); bf16: one ULP "
           "between the output roundings")
SSD_FAULTS = ("state not carried into chunk 2", "x of token 200 left out")
# the carry one chunk late: chunk 2's read-out from S_2 (the state after it)
# in place of S_1; planted at every bf16 case of 4 chunks or more
SSD_LATE = "chunk 2 read out from S_2, not S_1"
SCAN_LATE_CHUNK = 2


def _ssd_cases() -> list[tuple[int, int, int]]:
    """(B, T, chunk) of the scan checks: the train microbatch, then each
    zamba2 serve prompt at the chunk its exact-length prefill runs (one
    kernel lane takes Q/32 rows of the cumsum: 4 at chunk 128, 2 at 64, 1
    below), then one prompt length for each other chunk a prefill can give."""
    from repro_torch.kernels.tiling import SSD_CHUNK, pick_chunk

    cases = [(4, 2048, SSD_CHUNK)]
    for T in list(SERVE_PROMPT_LENS[ZAMBA]) + [50, 100, 48]:
        case = (1, T, pick_chunk(T, SSD_CHUNK))
        if case not in cases:
            cases.append(case)
    return cases


def ssd_error_bound(x, dt, Bm, Cm, A_log, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(bound on |y - y'| (B, T, H, P), bound on |S - S'| (B, H, P, N)) between
    two fp32 evaluations of the chunked scan in another summation order:
    ``ssd_scan_ref``'s chunk loop over absolute values in float64, each term
    weighted by its first-order relative error (see SSD_WHY), doubled."""
    Bsz, T, H, P = x.shape
    N, Q = Bm.shape[-1], chunk
    u = U32
    logA = -torch.exp(A_log.double())
    ax, aB, aC, dtd = x.double().abs(), Bm.double().abs(), Cm.double().abs(), dt.double()
    S_abs = torch.zeros(Bsz, H, P, N, dtype=torch.float64, device=x.device)
    S_err = torch.zeros_like(S_abs)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))[None, :, :, None]
    ys = []
    for s in range(0, T, Q):
        c = slice(s, s + Q)
        xc, Bc, Cc, dtc = ax[:, c], aB[:, c], aC[:, c], dtd[:, c]
        cum = torch.cumsum(dtc * logA, 1)                         # (B, Q, H)
        total, acum = cum[:, -1], cum.abs()
        gap = cum[:, :, None] - cum[:, None]                      # (B, Q, Q, H)
        W = (torch.einsum("bin,bjn->bij", Cc, Bc)[..., None]
             * torch.exp(torch.where(tri, gap, -torch.inf)) * dtc[:, None])
        eps_w = u * (N + Q + 8 + torch.where(tri, gap.abs(), 0.0)
                     + Q * (acum[:, :, None] + acum[:, None]))
        y_err = torch.einsum("bijh,bjhp->bihp", W * eps_w, xc)
        eps_e = u * (N + 4 + (Q + 1) * acum)                      # e^cum_i and the C.S sum
        y_err = y_err + torch.exp(cum)[..., None] * (
            torch.einsum("bin,bhpn->bihp", Cc, S_abs) * eps_e[..., None]
            + torch.einsum("bin,bhpn->bihp", Cc, S_err))
        ys.append(y_err)
        rem = total[:, None] - cum
        dec = dtc * torch.exp(rem)
        eps_dec = u * (Q + 8 + rem.abs() + Q * (total.abs()[:, None] + acum))
        et = torch.exp(total)[:, :, None, None]
        eps_t = (u * (4 + Q * total.abs()))[:, :, None, None]
        S_err = (et * (S_err + S_abs * eps_t)
                 + torch.einsum("bjh,bjn,bjhp->bhpn", dec * eps_dec, Bc, xc))
        S_abs = et * S_abs + torch.einsum("bjh,bjn,bjhp->bhpn", dec, Bc, xc)
    return 2 * torch.cat(ys, 1), 2 * S_err


def check_scan_mirrors(name: str, cases: list) -> int:
    """The chunked scan's work division as its C entries report it
    (``scan_items_cuda``, ``tri_tiles_cuda`` or ``score_pairs_cuda`` of
    ``kernels/<name>.py``) equals the mirrors of ``kernels/tiling.py``: the
    blocks of each (B, T, H, chunk) case (the token walk's split of the
    state among them) and the tile (SSD, in fp32 and bf16) or score-pair
    (wkv) list of every chunk the chunk kernels take."""
    import importlib

    from repro_torch.kernels import tiling

    module = importlib.import_module(f"repro_torch.kernels.{name}")
    if name == "ssd_scan":
        got_list, want_list = module.tri_tiles_cuda, tiling.ssd_tri_tiles
    else:
        got_list, want_list = module.score_pairs_cuda, tiling.wkv_score_pairs
    checks = [(f"blocks of ({B}, {T}, {H}) at chunk {chunk}",
               module.scan_items_cuda(B, T, H, chunk), tiling.scan_items(B, H, T, chunk))
              for B, T, H, chunk in cases]
    chunk = 2 * tiling.SCAN_SMALL_CHUNK
    while chunk <= module.MAX_CHUNK:
        checks.append((f"tile list at chunk {chunk}", got_list(chunk), want_list(chunk)))
        if name == "ssd_scan":
            checks.append((f"bf16 tile list at chunk {chunk}",
                           got_list(chunk, torch.bfloat16), tiling.ssd_mma_tiles(chunk)))
        chunk *= 2
    for what, got, want in checks:
        if isinstance(got, list):
            got, want = [tuple(g) for g in got], [tuple(w) for w in want]
        if got != want:
            raise AssertionError(f"{name} {what}: the C entry gives {str(got)[:120]}, the "
                                 f"mirror {str(want)[:120]}")
    emit({"phase": "mirror_check", "kernel": name, "checks": len(checks)})
    return len(checks)


def ssd_inputs(gen, B: int, T: int, dtype, H: int = 80, P: int = 64, N: int = 64):
    """x, B, C as the model hands them to the scan (silu of the conv output,
    slices of one (B, T, ch) tensor), dt = softplus(dt_raw - 3) (mamba2's dt
    range, slow and fast heads), A_log as the init's log(1..H)."""
    xbc = F.silu(torch.randn(B, T, H * P + 2 * N, generator=gen, device="cuda")).to(dtype)
    x = xbc[..., :H * P].reshape(B, T, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = F.softplus(torch.randn(B, T, H, generator=gen, device="cuda") - 3.0)
    A_log = torch.log(torch.arange(1, H + 1, device="cuda", dtype=torch.float32)).to(dtype)
    return x, dt, Bm, Cm, A_log


def check_ssd(name: str, args: tuple, chunk: int, planted: bool = False) -> float:
    """The SSD kernel against ``ssd_scan_ref`` on the same inputs, y and the
    final state; with ``planted``, each of SSD_FAULTS of the plain version
    must fail the same limit."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_scan_ref

    y, S = ssd.ssd_scan_cuda(*args, chunk)
    torch.cuda.synchronize()
    check_repeat(name, (y, S), ssd.ssd_scan_cuda(*args, chunk))
    yr, Sr = ssd_scan_ref(*args, chunk=chunk)
    ey, es = ssd_error_bound(*args, chunk)
    rtol = 1.1 * BF16_ULP if y.dtype == torch.bfloat16 else 0.0
    terms = ((ey, 1.0, "2 x first-order bound"),)
    err = check_close(name + " y", y, yr, rtol=rtol, atol=1e-6, why=SSD_WHY, terms=terms)
    err = max(err, check_close(name + " state", S, Sr, rtol=0.0, atol=1e-6, why=SSD_WHY,
                               terms=((es, 1.0, "2 x first-order bound"),)))
    x, dt, Bm, Cm, A_log = args
    T = x.shape[1]
    bad = {}
    if y.dtype == torch.bfloat16 and T >= 4 * chunk:
        bad[SSD_LATE] = ssd_late_carry(args, yr, chunk)
    if planted:
        tail = ssd_scan_ref(*(a[:, chunk:] for a in args[:4]), A_log, chunk=chunk)[0]
        x_drop = x.clone()
        x_drop[:, 200] = 0
        bad.update({SSD_FAULTS[0]: torch.cat([yr[:, :chunk], tail], 1),
                    SSD_FAULTS[1]: ssd_scan_ref(x_drop, dt, Bm, Cm, A_log, chunk=chunk)[0]})
        assert T > 200 and T >= 2 * chunk
    if bad:
        for fault, out in bad.items():
            worst = float(limit_share(out, yr, rtol, 1e-6, terms)[1].max())
            emit({"phase": "planted_fault", "case": name, "fault": fault,
                  "worst_share_of_limit": worst})
            if worst <= 1:
                raise AssertionError(f"{name}: the limit does not catch a planted fault "
                                     f"({fault}: {worst:.2f} of it)")
    return err


def ssd_late_carry(args: tuple, yr: torch.Tensor, chunk: int) -> torch.Tensor:
    """``yr`` with chunk SCAN_LATE_CHUNK's read-out taken from the state
    after that chunk in place of the one before it: e^{cum} C (S_c - S_{c-1})
    added to its rows, the states from the plain scan of its first chunks."""
    from repro_torch.kernels.ref import ssd_scan_ref

    x, dt, Bm, Cm, A_log = args
    c = SCAN_LATE_CHUNK
    s_before, s_after = (ssd_scan_ref(*(a[:, :n * chunk] for a in args[:4]), A_log,
                                      chunk=chunk)[1] for n in (c, c + 1))
    rows = slice(c * chunk, (c + 1) * chunk)
    cum = torch.cumsum(dt[:, rows].float() * -torch.exp(A_log.float()), 1)
    shift = torch.exp(cum)[..., None] * torch.einsum("bin,bhpn->bihp", Cm[:, rows].float(),
                                                    s_after - s_before)
    bad = yr.float().clone()
    bad[:, rows] += shift
    return bad.to(yr.dtype)


def scan_kernel_ms(call, n: int = 10) -> dict:
    """Device ms a call of each kernel a scan launches (``torch.profiler``
    over n calls, L2 warm)."""
    prof = _profile(lambda: [call() for _ in range(n)])
    if "top_kernels" not in prof:
        return {"not measured": prof["device_busy_s"]}
    return {k["name"]: k["device_ms"] / n for k in prof["top_kernels"]}


def check_repeat(name: str, first: tuple, again: tuple) -> None:
    """A second launch on the same inputs must give the same bits."""
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"{name}: a repeated launch gave other bits")


def ssd_bound(B: int, T: int, H: int, P: int, N: int, chunk: int,
              el: int) -> tuple[float, str, dict]:
    """(ms, bound_by, floors) of the SSD scan's function at chunk Q: x, B, C
    and dt read once, y and the state written once (x, B, C and y of ``el``
    bytes), against its products at the fastest rate the card has for their
    operands: C B^T (bf16 x bf16; B and C are shared by the heads) once per
    (b, chunk) at the bf16 tensor rate; W x, D_c and C S_{c-1}, each with an
    fp32 operand, per head at a third of it (the operand split exactly into
    three bf16 planes, as the kernel's bf16 path runs them)."""
    nc, pairs = T // chunk, chunk * (chunk + 1) // 2
    nbytes = 2 * B * T * H * P * el + 2 * B * T * N * el + B * T * H * 4 + B * H * P * N * 4
    cbt = B * nc * 2 * pairs * N
    split = B * H * nc * (2 * pairs * P + 2 * 2 * chunk * N * P)
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (cbt + 3 * split) / PEAK_FLOPS[torch.bfloat16] * 1e3
    return (max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations",
            {"bytes": t_mem, "tensor": t_ops, "nbytes": nbytes, "cbt_flops": cbt,
             "split_flops": split})


def ssd_row(timer: Timer, err: float, args: tuple, chunk: int) -> dict:
    """The timed row of a bf16 scan against ``ssd_bound``;
    ``design_bound_ms`` is this design's own floor, not the card's: for
    chunks over 8 the bytes add x read again and each chunk's state written
    and read twice, and every product runs per head on the tensor cores (C
    B^T too, and D_c, C S and W x three times over); the token walk moves
    nothing more (its blocks share B and C in the L2) and runs all on
    FFMA."""
    from repro_torch.kernels import ssd_scan as ssd, tiling
    from repro_torch.kernels.ref import ssd_scan_ref

    x, dt, Bm, Cm, A_log = args
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    el = x.element_size()
    b, by, floors = ssd_bound(B, T, H, P, N, chunk, el)
    nbytes, extra = floors["nbytes"], 0
    pairs = chunk * (chunk + 1) // 2
    ffma = B * H * (T // chunk) * (2 * pairs * (N + P) + 4 * chunk * N * P)
    db, dby = bound_ms(nbytes, ffma, torch.float32)
    if chunk > tiling.SCAN_SMALL_CHUNK:
        n_chunks = B * H * (T // chunk)
        extra = x.numel() * el + 4 * 4 * n_chunks * N * P + 8 * n_chunks
        tc = n_chunks * (2 * pairs * N + 3 * 2 * pairs * P + 2 * 3 * 2 * chunk * N * P)
        t_mem = (nbytes + extra) / HBM_BYTES_PER_S * 1e3
        t_ops = tc / PEAK_FLOPS[torch.bfloat16] * 1e3
        db, dby = max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations"

    def call():
        return ssd.ssd_scan_cuda(x, dt, Bm, Cm, A_log, chunk)

    ms, parent_ms = timed_with_parent(timer, "ssd_scan", call)
    return {"shape": f"x ({B}, {T}, {H}, {P}) bf16, N {N}, chunk {chunk}",
            "max_abs_err": err, "ms": ms, "parent_ms": parent_ms,
            "ms_by_kernel": scan_kernel_ms(call),
            "plain_ms": timer(lambda: ssd_scan_ref(x, dt, Bm, Cm, A_log, chunk=chunk)),
            "plain_call": "ssd_scan_ref (the chunk loop in torch)",
            "library_ms": None, "library_call": "none: no single PyTorch call computes it",
            "bound_ms": b, "bound_by": by,
            "flops_rate": "C B^T at the bf16 tensor rate, fp32-operand products at a third",
            "floors_ms": {"bytes": floors["bytes"], "tensor": floors["tensor"]},
            "design_bytes": nbytes + extra, "design_bound_ms": db, "design_bound_by": dby,
            "share_of_bound": b / ms, "share_of_design_bound": db / ms}


# mamba decode: the kernel reproduces the reference's dtype chain (the conv
# product, the bias add and silu each rounded to the window's dtype); the
# two may still round one of those differently where their fp32 sums of the
# 4 taps (in another order) straddle a rounding boundary: a conv channel's
# silu output may move by 1.1 * (ULP(|e|) + ULP(|e + b|)) + ULP(|s|) (bf16;
# |silu'| <= 1.1), and by 1.1 * 8u * sum|w * cw| + 4u |s| in fp32.
# decode_error_terms carries that through S' = a S + dt x B^T and
# y = S' C + D x, with the fp32 roundings of both sides (dt, a, the N-term sum).
DECODE_WHY = ("one rounding flip per conv channel in the window's dtype (bf16) or "
              "the fp32 tap sums in another order, carried through the state update "
              "and the read-out; fp32 roundings of dt, a and the N-term sum on both sides")


def decode_error_terms(window, conv_w, conv_b, dt_raw, dt_bias, A_log, D, state,
                       H: int, P: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(bound on |y - y'| (B, H, P), bound on |S' - S''| (B, H, P, N))."""
    u = U32
    N = state.shape[-1]
    w32, cw32 = window.float(), conv_w.float()
    e = torch.einsum("bkc,kc->bc", w32, cw32)
    ae = torch.einsum("bkc,kc->bc", w32.abs(), cw32.abs())
    pre = e + conv_b.float()
    s = F.silu(pre)
    if window.dtype == torch.bfloat16:
        ds = 1.1 * (BF16_ULP * (e.abs() + pre.abs()) + 8 * u * ae) + BF16_ULP * s.abs()
    else:
        ds = 1.1 * 8 * u * ae + 4 * u * s.abs()
    di = H * P
    x, Bv, Cv = s[:, :di].reshape(-1, H, P).abs(), s[:, di:di + N].abs(), s[:, di + N:].abs()
    dx, dB, dC = ds[:, :di].reshape(-1, H, P), ds[:, di:di + N], ds[:, di + N:]
    z = dt_raw.float() + dt_bias.float()
    dt = F.softplus(z)
    rate = dt * torch.exp(A_log.float())
    a = torch.exp(-rate)
    da = a * (8 * u * rate + 4 * u)                   # dt and e^A_log: a few ulp each
    aS = a[..., None, None] * state.abs()
    xb = dt[..., None, None] * x[..., None] * Bv[:, None, None, :]
    S_new = aS + xb
    dS = (da[..., None, None] * state.abs() + 8 * u * xb + 6 * u * aS
          + dt[..., None, None] * (dx[..., None] * Bv[:, None, None, :]
                                   + x[..., None] * dB[:, None, None, :]))
    dy = (torch.einsum("bn,bhpn->bhp", dC, S_new) + torch.einsum("bn,bhpn->bhp", Cv, dS)
          + 2 * (N + 2) * u * torch.einsum("bn,bhpn->bhp", Cv, S_new)
          + D.float().abs()[None, :, None] * (dx + 2 * u * x))
    return dy, dS


def check_decode(name: str, args: dict, H: int, P: int, planted: bool = False) -> float:
    """The pure launch against ``mamba_decode_ref`` (the input state left as
    it was; with ``planted``, B and C swapped must fail y's limit), then the
    in-place launch (``check_in_place``)."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import mamba_decode_ref, mamba_decode_ref_

    before = args["state"].clone()
    y, S = ssd.mamba_decode_cuda(**args, n_heads=H, head_dim=P)
    torch.cuda.synchronize()
    if not torch.equal(args["state"], before):
        raise AssertionError(f"{name}: the decode kernel wrote its input state")
    yr, Sr = mamba_decode_ref(**args, n_heads=H, head_dim=P)
    dy, dS = decode_error_terms(**args, H=H, P=P)
    err = check_close(name + " y", y, yr, rtol=0.0, atol=1e-6, why=DECODE_WHY,
                      terms=((dy, 1.0, "carried rounding bound"),))
    err = max(err, check_close(name + " state", S, Sr, rtol=0.0, atol=1e-6, why=DECODE_WHY,
                               terms=((dS, 1.0, "carried rounding bound"),)))
    if planted:                                   # B and C read from each other's channels
        N = S.shape[-1]
        di = H * P
        perm = torch.cat([torch.arange(di), torch.arange(di + N, di + 2 * N),
                          torch.arange(di, di + N)]).cuda()
        swapped = dict(args, window=args["window"][..., perm], conv_w=args["conv_w"][:, perm],
                       conv_b=args["conv_b"][perm])
        bad = mamba_decode_ref(**swapped, n_heads=H, head_dim=P)[0]
        worst = float(limit_share(bad, yr, 0.0, 1e-6, ((dy, 1.0, ""),))[1].max())
        emit({"phase": "planted_fault", "case": name, "fault": "B and C channels swapped",
              "worst_share_of_limit": worst})
        if worst <= 1:
            raise AssertionError(f"{name}: the limit does not catch B and C swapped")
    # in place, dt_raw a strided slice as the layer hands it over
    layer_args = dict(args, dt_raw=strided_dt(args["dt_raw"]))
    return max(err, check_in_place(
        name, lambda s, a: ssd.mamba_decode_cuda_(**dict(layer_args, state=s), active=a,
                                                  n_heads=H, head_dim=P),
        lambda s, a: mamba_decode_ref_(**dict(args, state=s), active=a, n_heads=H, head_dim=P),
        args["state"], lambda: ssd.launches_decode, dy=dy, dS=dS, atol=1e-6, why=DECODE_WHY))


# the decode steps' in-place checks and timings: slot 3 inactive
DECODE_ACTIVE = (True, True, True, False)


def check_in_place(name: str, launch, plain, state: torch.Tensor, counter, *, dy, dS,
                   atol: float, why: str) -> float:
    """An in-place decode launch ``launch(S, active) -> y`` against its plain
    in-place form ``plain(S, active)`` on copies of ``state`` with slot 3
    inactive: y and the active slots' rows within the pure step's limits
    (atol and the carried terms dy, dS), the inactive slot's rows bit-identical
    to ``state``; two launches from copies of one state bit-identical; a
    planted fault, every slot updated ("active ignored"), must fail the
    inactive-row check; a strided, misaligned or bf16 state must make the
    wrapper raise, with no launch counted (``counter()``)."""
    active = torch.tensor(DECODE_ACTIVE, device="cuda")
    keep = ~active
    st, again, ref = state.clone(), state.clone(), state.clone()
    y, y2, yr = launch(st, active), launch(again, active), plain(ref, active)
    torch.cuda.synchronize()
    err = check_close(f"{name} in place y", y, yr, rtol=0.0, atol=atol, why=why,
                      terms=((dy, 1.0, "the pure check's y term"),))
    err = max(err, check_close(f"{name} in place, active slots' state", st[active], ref[active],
                               rtol=0.0, atol=atol, why=why,
                               terms=((dS[active], 1.0, "the pure check's state term"),)))
    frozen = torch.equal(st[keep], state[keep])
    emit({"phase": "kernel_check", "case": f"{name} in place, inactive slot's state",
          "bit_identical": frozen})
    if not frozen:
        raise AssertionError(f"{name}: the in-place launch wrote an inactive slot's rows")
    if not (torch.equal(y, y2) and torch.equal(st, again)):
        raise AssertionError(f"{name}: two in-place launches from one state gave other bits")
    bad = state.clone()
    plain(bad, None)                              # planted: every slot updated
    caught = not torch.equal(bad[keep], state[keep])
    emit({"phase": "planted_fault", "case": name, "fault": "active ignored",
          "inactive_rows_bit_identical": not caught})
    if not caught:
        raise AssertionError(f"{name}: the inactive-row check does not catch 'active ignored'")
    flat = torch.empty(state.numel() + 1, device="cuda")
    views = {"strided": torch.empty(*state.shape[:-1], 2 * state.shape[-1],
                                    device="cuda")[..., ::2],
             "misaligned": flat[1:].view(state.shape),
             "bf16": state.bfloat16()}
    for what, view in views.items():
        before = counter()
        try:
            launch(view, active)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{name}: the in-place wrapper took a {what} state")
        if counter() != before:
            raise AssertionError(f"{name}: a launch was counted for a refused {what} state")
    emit({"phase": "kernel_check", "case": f"{name} in place refuses",
          "refused": sorted(views)})
    return err


def decode_inputs(gen, B: int, dtype, H: int = 80, P: int = 64, N: int = 64, K: int = 4):
    """The decode step's inputs as the model hands them over: the conv window
    of in_proj outputs, the init's conv weights (std 0.5) and A_log, a state
    of a prefilled prompt's magnitude."""
    ch = H * P + 2 * N
    return dict(
        window=torch.randn(B, K, ch, generator=gen, device="cuda").to(dtype),
        conv_w=(0.5 * torch.randn(K, ch, generator=gen, device="cuda")).to(dtype),
        conv_b=(0.1 * torch.randn(ch, generator=gen, device="cuda")).to(dtype),
        dt_raw=(torch.randn(B, H, generator=gen, device="cuda") - 3.0).to(dtype),
        dt_bias=torch.zeros(H, device="cuda").to(dtype),
        A_log=torch.log(torch.arange(1, H + 1, device="cuda", dtype=torch.float32)).to(dtype),
        D=torch.ones(H, device="cuda").to(dtype),
        state=torch.randn(B, H, P, N, generator=gen, device="cuda"))


def strided_dt(dt_raw: torch.Tensor, P: int = 64, N: int = 64) -> torch.Tensor:
    """dt_raw as ``models/ssm.py:mamba_decode`` hands it over: the last H
    columns of in_proj's (B, 2 H P + 2 N + H) output."""
    B, H = dt_raw.shape
    proj = torch.zeros(B, 2 * H * P + 2 * N + H, dtype=dt_raw.dtype, device="cuda")
    proj[:, -H:] = dt_raw
    return proj[:, -H:]


def decode_readings(timer: Timer, launch_, parent, plain_, state: torch.Tensor,
                    layer_launch_, layer_parent) -> dict:
    """The decode step's readings, in turns with its parent: as a kernel,
    the in-place launch ``launch_(S, active)`` (``ms``, ``device_ms``,
    ``host_us``) against the parent's fresh-state launch (``parent_*``); as
    the layer pays it, ``layer_launch_`` (mamba: dt_raw strided, as the
    layer hands it over) against ``layer_parent`` and ``_masked_copy`` of the
    state leaf into the cache (``layer`` and ``parent_layer``: device ms and
    kernels a step); the plain in-place form ``plain_`` (``plain_ms``); and
    one ``copy_`` of the state (``state_copy``: the byte bound's traffic,
    the state read and written once, through one PyTorch launch, a
    yardstick of what a launch this size takes on the card).  Every slot
    active, as a full engine's tick."""
    from repro_torch.models.model import _masked_copy

    active = torch.ones(state.shape[0], dtype=torch.bool, device="cuda")
    cache = {"state": state.clone()}
    other = state.clone()
    copy = timer.device(lambda: other.copy_(cache["state"]))
    new, par = readings_in_turns(timer, lambda: launch_(cache["state"], active), parent)
    layer, par_layer = readings_in_turns(
        timer, lambda: layer_launch_(cache["state"], active),
        lambda: _masked_copy(cache, {"state": layer_parent()[1]}, active))
    s = state.clone()
    y = launch_(s, None)                               # the new state, written over s
    yp, sp = parent()
    torch.cuda.synchronize()
    return {**new, **{f"parent_{k}": v for k, v in par.items()},
            "layer": layer, "parent_layer": par_layer,
            "state_copy": {"ms": timer(lambda: other.copy_(cache["state"])),
                           "device_ms": copy["device_ms"]},
            "state_bit_identical_to_parent": bool(torch.equal(s, sp)),
            "y_bit_identical_to_parent": bool(torch.equal(y, yp)),
            "plain_ms": timer(lambda: plain_(state.clone(), active))}


def decode_row(timer: Timer, err: float, args: dict, H: int, P: int) -> dict:
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import mamba_decode_ref_

    B, K, ch = args["window"].shape
    el = args["window"].element_size()
    st = args["state"]
    nbytes = (B * K * ch + K * ch + ch) * el + 2 * st.numel() * 4 + B * H * P * 4
    flops = B * (2 * K * (H * P + 128) + 6 * st[0].numel())
    b, by = bound_ms(nbytes, flops, torch.float32)
    dims = dict(n_heads=H, head_dim=P)
    layer_args = dict(args, dt_raw=strided_dt(args["dt_raw"]))
    rd = decode_readings(
        timer, lambda s, a: ssd.mamba_decode_cuda_(**dict(args, state=s), active=a, **dims),
        lambda: parent_mamba_decode(**args, **dims),
        lambda s, a: mamba_decode_ref_(**dict(args, state=s), active=a, **dims), st,
        lambda s, a: ssd.mamba_decode_cuda_(**dict(layer_args, state=s), active=a, **dims),
        lambda: parent_mamba_decode(**layer_args, **dims))
    return {"shape": f"window ({B}, {K}, {ch}) {str(args['window'].dtype)[6:]}, "
                     f"state {tuple(st.shape)} fp32, in place, every slot active",
            "max_abs_err": err, **rd,
            "plain_call": "mamba_decode_ref_ (the pure step, then the masked copy)",
            "library_ms": None, "library_call": "none: no single PyTorch call computes it",
            "bound_ms": b, "bound_by": by, "share_of_bound": b / rd["ms"],
            "share_of_bound_device": (b / rd["device_ms"]
                                      if isinstance(rd["device_ms"], float) else None)}


@torch.no_grad()
def phase_kernels_ssm(timer: Timer) -> dict:
    """The SSD scan at zamba2's widths (H 80, P 64, N 64), bf16 and fp32, at
    the train microbatch 4 x 2048 (chunk 128, the timed headline row), at
    every (T, chunk) that the zamba2 serve run prefills (`_ssd_cases`; the
    256-token prefill carries the planted faults) and at the chunks 2, 4
    and 16 that no serve prompt gives; the decode step at 4 slots in bf16
    and fp32 (with a planted fault), pure and in place.  Returns the SSD
    and decode rows."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    check_scan_mirrors("ssd_scan", [(B, T, 80, chunk) for B, T, chunk in _ssd_cases()])
    ssd_rows = []
    for B, T, chunk in _ssd_cases():
        for dtype in (torch.bfloat16, torch.float32):
            args = ssd_inputs(gen, B, T, dtype)
            err = check_ssd(f"ssd_scan {dtype} (B {B}, T {T}, H 80, P 64, N 64) chunk {chunk}",
                            args, chunk, planted=(T, dtype) == (256, torch.bfloat16))
            if dtype == torch.bfloat16:
                ssd_rows.append(ssd_row(timer, err, args, chunk))
            del args
        torch.cuda.empty_cache()
    dec_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        args = decode_inputs(gen, 4, dtype)
        err = check_decode(f"mamba_decode_step {dtype} (B 4, H 80, P 64, N 64)", args, 80, 64,
                           planted=dtype == torch.bfloat16)
        dec_rows.append(decode_row(timer, err, args, 80, 64))
    rows = {"ssd_scan": {**ssd_rows[0], "cases": ssd_rows[1:]},
            "mamba_decode_step": {**dec_rows[0], "cases": dec_rows[1:]}}
    return rows


def flash_hd80(timer: Timer) -> dict:
    """The flash forward at hd 80 (zamba2's shared block: 32 heads, MHA) at
    the serve prefill (1 x 256) and the train microbatch (4 x 2048), and its
    two backward kernels at the train microbatch, bf16 and fp32: rows to
    join the flash kernels' cases."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {"flash_attention": [], "flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": []}
    for B, S in ((1, 256), (4, 2048)):
        for dtype in (torch.bfloat16, torch.float32):
            err, (q, k, v) = _flash_case(gen, f"flash {dtype} ({B}, {S}, 32q/32kv, 80) causal",
                                         B, S, S, 32, 32, 80, dtype, causal=True)
            if dtype == torch.bfloat16:
                out["flash_attention"].append(_flash_row(timer, err, q, k, v))
            del q, k, v
    for dtype in (torch.bfloat16, torch.float32):
        errs, tensors = flash_bwd_case(f"flash bwd {dtype} (4, 2048, 32q/32kv, 80) causal",
                                       gen, 4, 2048, 2048, 32, 32, 80, dtype, causal=True)
        if dtype == torch.bfloat16:
            dq, dkv = flash_bwd_times(timer, errs, *tensors)
            out["flash_attention_bwd_dq"].append(dq)
            out["flash_attention_bwd_dkv"].append(dkv)
        del tensors
        torch.cuda.empty_cache()
    return out


def window_pairs(S: int, W: int) -> int:
    """The (query, key) pairs a causal window of W keys keeps over S tokens."""
    return S * (S + 1) // 2 if S <= W else W * (W + 1) // 2 + (S - W) * W


def _flash_window_row(timer: Timer, err, q, k, v, window: int) -> dict:
    """The timed row of a causal windowed bf16 forward at q's shape; the
    library call is SDPA with the window as a boolean mask."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    B, S, Hq, hd = q.shape
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + B * Hq * S * 4
    b, by = bound_ms(nbytes, 4 * hd * B * Hq * window_pairs(S, window), q.dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    i = torch.arange(S, device="cuda")
    mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    rtol, atol = TOL["flash_attention"][q.dtype]
    row = {"shape": f"q {tuple(q.shape)}, k/v {tuple(k.shape)} bf16 causal, window {window}",
           "max_abs_err": err, "rtol": rtol, "atol": atol, "p_rounding_tol": FLASH_P_TOL,
           "ms": timer(lambda: fa.flash_attention_fwd_cuda(q, k, v, causal=True,
                                                           sliding_window=window)),
           "plain_ms": timer(lambda: flash_attention_ref(qt, kt, vt, causal=True,
                                                         sliding_window=window)),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=mask, enable_gqa=True)),
           "library_call": "F.scaled_dot_product_attention(attn_mask=window, enable_gqa=True)",
           "bound_ms": b, "bound_by": by}
    del mask
    return row


def rmsnorm_rows_case(timer: Timer, gen, out: list, rows_n: int, d: int, **tags) -> None:
    """rmsnorm on (rows_n, d) in bf16 and fp32 under phase 2's limits; the
    bf16 row (``tags`` added) joins ``out``."""
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.ref import rmsnorm_ref

    for dtype in (torch.bfloat16, torch.float32):
        rtol, atol = TOL["rmsnorm"][dtype]
        x = randn(gen, rows_n, d, dtype=dtype)
        w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
        err = check_close(f"rmsnorm {dtype} ({rows_n}, {d})", rn.rmsnorm_cuda(x, w, 1e-6),
                          rmsnorm_ref(x, w, 1e-6), rtol=rtol, atol=atol,
                          why=TOL["rmsnorm"]["why"])
        if dtype == torch.bfloat16:
            nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
            b, by = bound_ms(nbytes, 4 * x.numel(), torch.float32)
            out.append({"shape": f"x ({rows_n}, {d}) bf16", **tags, "max_abs_err": err,
                        "rtol": rtol, "atol": atol,
                        "ms": timer(lambda: rn.rmsnorm_cuda(x, w, 1e-6)),
                        "plain_ms": timer(lambda: rmsnorm_ref(x, w, 1e-6)),
                        "library_ms": (timer(lambda: F.rms_norm(x, (d,), w, 1e-6))
                                       if hasattr(F, "rms_norm") else None),
                        "library_call": "F.rms_norm", "bound_ms": b, "bound_by": by})


def phase_kernels_serve(timer: Timer) -> dict:
    """The kernels at the shapes of the dense serving paths no other phase
    reaches, bf16 and fp32 under phase 2's limits: h2o-danube-1.8b's
    windowed flash forward (32q/8kv of 80, window 4096) at its 8192-token
    prefill bucket; qwen3-32b's flash forward (64q/8kv of 128) at a
    256-token prefill; swiglu at qwen3's (5120, 25600), phi4-mini's (3072,
    8192) and danube's (2560, 6912) for a 256-token prefill and a 4-slot
    decode tick (danube also its 8192-token bucket); rmsnorm on qwen3's
    128-wide qk-norm rows (a 256-token prefill's 64 query heads and 8 key
    heads, a tick's 4 x 64).  Rows to join the kernels' cases."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {"flash_attention": [], "swiglu": [], "rmsnorm": []}
    dan, qwen, phi = (get_config(a) for a in (DANUBE, QWEN3, PHI4))
    W = dan.sliding_window
    for arch, S, c, kw in ((DANUBE, 8192, dan, dict(sliding_window=W)), (QWEN3, 256, qwen, {})):
        for dtype in (torch.bfloat16, torch.float32):
            err, (q, k, v) = _flash_case(
                gen, f"flash {arch} {dtype} (1, {S}, {c.n_heads}q/{c.n_kv_heads}kv, "
                     f"{c.resolved_head_dim}) causal {kw}", 1, S, S, c.n_heads, c.n_kv_heads,
                c.resolved_head_dim, dtype, causal=True, **kw)
            if dtype == torch.bfloat16:
                row = (_flash_window_row(timer, err, q, k, v, W) if kw
                       else _flash_row(timer, err, q, k, v, parent=False))
                out["flash_attention"].append({**row, "arch": arch})
            del q, k, v
            torch.cuda.empty_cache()
    for c, Ns in ((qwen, (256, 4)), (phi, (256, 4)), (dan, (8192, 256, 4))):
        for N in Ns:
            swiglu_tp_case(timer, gen, out, f"{c.name}", c.d_model, c.d_ff,
                           (torch.bfloat16, torch.float32), N=N, arch=c.name)
        torch.cuda.empty_cache()
    hd = qwen.resolved_head_dim
    for rows_n, what in ((256 * qwen.n_heads, "prefill q"), (256 * qwen.n_kv_heads, "prefill k"),
                         (4 * qwen.n_heads, "decode q")):
        rmsnorm_rows_case(timer, gen, out["rmsnorm"], rows_n, hd, arch=QWEN3,
                          use=f"qk-norm, {what}")
    return out


def phase_kernels_encdec(timer: Timer) -> dict:
    """The encdec path's kernels at seamless-m4t-medium's shapes, the train
    microbatch (4 rows), bf16 and fp32 under phase 2's limits, the bf16
    ones timed against the plain version, the library call and the bound:
    the flash forward and backward non-causal over 16 heads of 64, the
    decoder's cross-attention (2048 queries over the encoder's 1024
    frames) and the encoder's self-attention (1024 over 1024); layernorm
    on (8192, 1024); gelu_mlp (8192, 1024) x (1024, 4096); and the bf16 CE
    at V 256206, which is no multiple of 8 (its W padded for the kernel's
    TMA map, ``cross_entropy.pad_vocab``; the pad copy timed apart), on 4 x
    2047 tokens, with planted faults.  Rows to join the kernels' cases."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import gelu_mlp as gm, layernorm as ln
    from repro_torch.kernels.ref import gelu_mlp_in_ref, layernorm_ref

    gen = torch.Generator(device="cuda").manual_seed(8)
    cfg = get_config(SEAMLESS)
    H, hd, d, F_, V = cfg.n_heads, cfg.resolved_head_dim, cfg.d_model, cfg.d_ff, cfg.vocab_size
    T = cfg.enc_seq_len
    out = {k: [] for k in ("flash_attention", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv", "layernorm", "gelu_mlp", "cross_entropy")}
    tags = {"arch": SEAMLESS}
    for use, Sq in (("cross-attention", 2048), ("encoder self-attention", T)):
        for dtype in (torch.bfloat16, torch.float32):
            name = f"seamless {use} {dtype} (4, {Sq} q, {T} kv, {H} heads, {hd}) non-causal"
            err, (q, k, v) = _flash_case(gen, f"flash {name}", 4, Sq, T, H, H, hd, dtype,
                                         causal=False)
            if dtype == torch.bfloat16:
                out["flash_attention"].append(
                    {**_flash_row(timer, err, q, k, v, parent=False, causal=False),
                     **tags, "use": use})
            del q, k, v
            errs, tensors = flash_bwd_case(f"flash bwd {name}", gen, 4, Sq, T, H, H, hd,
                                           dtype, causal=False)
            if dtype == torch.bfloat16:
                dq, dkv = flash_bwd_times(timer, errs, *tensors, parent=False, causal=False)
                out["flash_attention_bwd_dq"].append({**dq, **tags, "use": use})
                out["flash_attention_bwd_dkv"].append({**dkv, **tags, "use": use})
            del tensors
            torch.cuda.empty_cache()
    N = 8192
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(N, d, generator=gen, device="cuda") + 1.0).to(dtype)
        w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
        b = randn(gen, d, dtype=dtype, scale=0.1)
        err = check_layernorm(f"layernorm seamless {dtype} ({N}, {d})", x, w, b)
        if dtype == torch.bfloat16:
            rtol, atol = TOL["layernorm"][dtype]
            bnd, by = bound_ms(2 * x.numel() * 2 + 2 * d * 2, 8 * x.numel(), torch.float32)
            out["layernorm"].append({
                "shape": f"x ({N}, {d}) bf16", "max_abs_err": err, "rtol": rtol,
                "atol": atol, "scale_tol": LN_SCALE_TOL,
                "ms": timer(lambda: ln.layernorm_cuda(x, w, b, 1e-5)),
                "plain_ms": timer(lambda: layernorm_ref(x, w, b, 1e-5)),
                "library_ms": timer(lambda: F.layer_norm(x, (d,), w, b, 1e-5)),
                "library_call": "F.layer_norm", "bound_ms": bnd, "bound_by": by, **tags})
        x = randn(gen, N, d, dtype=dtype)
        w1 = randn(gen, d, F_, dtype=dtype, scale=d ** -0.5)
        err = check_gelu_mlp(f"gelu_mlp seamless {dtype} ({N}, {d})x({d}, {F_})", x, w1)
        if dtype == torch.bfloat16:
            rtol, atol = TOL["gelu_mlp"][dtype]
            bnd, by = bound_ms((x.numel() + w1.numel() + N * F_) * 2, 2 * N * d * F_, dtype)
            out["gelu_mlp"].append({
                "shape": f"x ({N}, {d}), w1 ({d}, {F_}) bf16", "max_abs_err": err,
                "rtol": rtol, "atol": atol, "scale_tol": GELU_SCALE_TOL,
                "tile": gm.gelu_mlp_tile(N, F_, card_sms()),
                "ms": timer(lambda: gm.gelu_mlp_cuda(x, w1)),
                "plain_ms": timer(lambda: gelu_mlp_in_ref(x, w1)),
                "library_ms": timer(lambda: F.gelu(x @ w1, approximate="tanh")),
                "library_call": "F.gelu(x @ w1, approximate='tanh'), cuBLAS + "
                                "an elementwise pass", "bound_ms": bnd, "bound_by": by, **tags})
        del x, w, b, w1
    torch.cuda.empty_cache()
    out["cross_entropy"].append(padded_ce_row(timer, gen, "seamless", 4 * 2047, d, V, tags))
    return out


def padded_ce_row(timer: Timer, gen, label: str, N: int, d: int, V: int, tags: dict) -> dict:
    """The bf16 CE kernel on (N, d) x (d, V) at a V that is no multiple of
    8 (its W padded for the kernel's TMA map, ``cross_entropy.pad_vocab``)
    against its plain version, with planted faults: the timed row, the pad
    copy timed apart beside its byte bound."""
    from repro_torch.kernels import cross_entropy as ce
    from repro_torch.kernels.ref import cross_entropy_ref

    before = ce.launches
    err, (h, w, labels) = ce_case(f"ce {label} bf16 ({N}, {d})x({d}, {V})", gen, N, d, V,
                                  torch.bfloat16, planted=True)
    if ce.launches == before:
        raise AssertionError(f"the CE kernel was not launched at V {V}")
    Vp = ce.pad_vocab(w).shape[1]
    bnd, by = bound_ms(2 * (h.numel() + w.numel()) + 16 * N, 2 * N * d * V, torch.bfloat16)
    pad_ms = timer(lambda: ce.pad_vocab(w))
    ms, parent_ms = timed_with_parent(timer, "cross_entropy",
                                      lambda: ce.cross_entropy_cuda(h, w, labels))
    row = {"shape": f"h ({N}, {d}), w ({d}, {V}) bf16, padded to {Vp} columns",
           "max_abs_err": err, "tile": [ce.TILE_M, ce.TILE_N],
           "partials": ce.n_partials(V, torch.bfloat16), "ms": ms, "parent_ms": parent_ms,
           "pad_ms": pad_ms, "pad_bound_ms": bound_ms(2 * d * (V + Vp), 0, torch.bfloat16)[0],
           "pad_call": "cross_entropy.pad_vocab (inside ms and parent_ms)",
           "plain_ms": timer(lambda: cross_entropy_ref(h, w, labels)),
           "plain_call": "cross_entropy_ref (materialized fp32 logits)",
           "library_ms": timer(lambda: F.cross_entropy((h @ w).float(), labels,
                                                       reduction="none")),
           "library_call": "F.cross_entropy on (h @ w).float()", "bound_ms": bnd,
           "bound_by": by, **tags}
    del h, w, labels
    torch.cuda.empty_cache()
    return row


# the rounds of rmsnorm on qwen3's 128-wide qk-norm rows in turns with
# F.rms_norm (``phase_kernels_vlm``): two separate runs on one H100 read the
# kernel at 0.0326 and 0.0162 ms on (16384, 128), against the library's
# 0.0168 (PERF.md, the kernel table's rmsnorm row), so only readings taken
# in turns tell the two apart
QK_NORM_ROUNDS = 3


def rmsnorm_turns(timer: Timer, gen, rows_n: int, d: int) -> dict:
    """rmsnorm on (rows_n, d) bf16 against ``F.rms_norm`` on the same inputs,
    ``QK_NORM_ROUNDS`` rounds in turns (kernel, library, library, kernel):
    each round's event ms, device ms and host us of both, and their means."""
    from repro_torch.kernels import rmsnorm as rn

    x = randn(gen, rows_n, d, dtype=torch.bfloat16)
    w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(torch.bfloat16)
    rounds = [readings_in_turns(timer, lambda: rn.rmsnorm_cuda(x, w, 1e-6),
                                lambda: F.rms_norm(x, (d,), w, 1e-6))
              for _ in range(QK_NORM_ROUNDS)]

    def mean(i: int, key: str):
        vals = [r[i][key] for r in rounds]
        return (float(np.mean(vals)) if all(isinstance(v, float) for v in vals)
                else "not measured")
    b, by = bound_ms(2 * x.numel() * 2 + 2 * d, 4 * x.numel(), torch.float32)
    out = {"shape": f"x ({rows_n}, {d}) bf16", "arch": QWEN3,
           "use": "qk-norm rows, in turns with F.rms_norm",
           "rounds": [{"kernel": a, "library": c} for a, c in rounds],
           "ms": mean(0, "ms"), "device_ms": mean(0, "device_ms"),
           "host_us": mean(0, "host_us"), "library_ms": mean(1, "ms"),
           "library_device_ms": mean(1, "device_ms"), "library_host_us": mean(1, "host_us"),
           "library_call": "F.rms_norm", "bound_ms": b, "bound_by": by}
    emit({"phase": "rmsnorm_qk_turns", **out})
    return out


def phase_kernels_vlm(timer: Timer) -> dict:
    """The vlm path's kernels at internvl2-2b's shapes, bf16 and fp32 under
    phase 2's limits, the bf16 ones timed against the plain version, the
    library call and the bound: the train microbatch is 4 rows of 256 patch
    and 2048 text positions (9216 rows of 2304 positions), the serve
    prefill of a 256-token bucket 512 positions, a tick 4 rows.  rmsnorm
    (9216, 2048), (512, 2048) and (4, 2048); swiglu (9216, 2048) x (2048,
    8192), and at 512 and 4 rows; the flash forward and backward causal
    over 4 x 2304 positions (no multiple of a 128-position tile: a ragged
    last tile), 16q/8kv of 128; the bf16 CE over the 4 x 2047 text rows at
    V 92553, no multiple of 8 (W padded for the kernel's TMA map, the pad
    timed apart), with planted faults.  Rows to join the kernels'
    cases."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device="cuda").manual_seed(9)
    cfg = get_config(INTERNVL)
    d, F_, V, P = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_patches
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    S = P + TRAIN["seq_len"]
    N = TRAIN["global_batch"] // TRAIN["gas"] * S
    out = {k: [] for k in ("rmsnorm", "swiglu", "flash_attention", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv", "cross_entropy")}
    tags = {"arch": INTERNVL}
    for rows_n, use in ((N, "train microbatch"), (256 + P, "serve prefill, 256-token bucket"),
                        (4, "serve tick")):
        rmsnorm_rows_case(timer, gen, out["rmsnorm"], rows_n, d, use=use, **tags)
    for n_rows, use, dtypes in ((N, "train microbatch", (torch.bfloat16, torch.float32)),
                                (256 + P, "serve prefill", (torch.bfloat16,)),
                                (4, "serve tick", (torch.bfloat16,))):
        swiglu_tp_case(timer, gen, out, INTERNVL, d, F_, dtypes, N=n_rows, use=use, **tags)
    torch.cuda.empty_cache()
    B = TRAIN["global_batch"] // TRAIN["gas"]
    for dtype in (torch.bfloat16, torch.float32):
        name = f"{INTERNVL} {dtype} ({B}, {S}, {Hq}q/{Hkv}kv, {hd}) causal"
        err, (q, k, v) = _flash_case(gen, f"flash {name}", B, S, S, Hq, Hkv, hd, dtype,
                                     causal=True)
        if dtype == torch.bfloat16:
            out["flash_attention"].append({**_flash_row(timer, err, q, k, v, parent=False),
                                           **tags})
        del q, k, v
        errs, tensors = flash_bwd_case(f"flash bwd {name}", gen, B, S, S, Hq, Hkv, hd, dtype,
                                       causal=True)
        if dtype == torch.bfloat16:
            dq, dkv = flash_bwd_times(timer, errs, *tensors, parent=False)
            out["flash_attention_bwd_dq"].append({**dq, **tags})
            out["flash_attention_bwd_dkv"].append({**dkv, **tags})
        del tensors
        torch.cuda.empty_cache()
    out["cross_entropy"].append(padded_ce_row(timer, gen, INTERNVL,
                                              B * (TRAIN["seq_len"] - 1), d, V, tags))
    return out


def phase_rmsnorm_qk(timer: Timer) -> list:
    """rmsnorm on qwen3's 128-wide qk-norm rows (16384 and 2048 rows) in
    turns with ``F.rms_norm``, with device and host time
    (``rmsnorm_turns``): rows to join rmsnorm's cases."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device="cuda").manual_seed(10)
    qwen = get_config(QWEN3)
    return [rmsnorm_turns(timer, gen, rows_n, qwen.resolved_head_dim)
            for rows_n in (256 * qwen.n_heads, 256 * qwen.n_kv_heads)]


# the tensor-parallel plans' ways: each rank's kernels see heads / tp,
# d_ff / tp and vocab / tp
TP_WAYS = (2, 4)


def flash_tp_case(timer: Timer, gen, out: dict, label: str, Hq: int, Hkv: int, hd: int,
                  dtypes: tuple, **tags) -> None:
    """The flash forward and backward at one shard shape of the train
    microbatch (4 x 2048, causal) in each of ``dtypes``, under phase 2's
    limits; the bf16 rows (``tags`` added) join ``out``."""
    for dtype in dtypes:
        name = f"{label} {dtype} (4, 2048, {Hq}q/{Hkv}kv, {hd}) causal"
        err, (q, k, v) = _flash_case(gen, f"flash {name}", 4, 2048, 2048, Hq, Hkv, hd,
                                     dtype, causal=True)
        if dtype == torch.bfloat16:
            out["flash_attention"].append({**_flash_row(timer, err, q, k, v, parent=False),
                                           **tags})
        del q, k, v
        errs, tensors = flash_bwd_case(f"flash bwd {name}", gen, 4, 2048, 2048, Hq, Hkv, hd,
                                       dtype, causal=True)
        if dtype == torch.bfloat16:
            dq, dkv = flash_bwd_times(timer, errs, *tensors, parent=False)
            out["flash_attention_bwd_dq"].append({**dq, **tags})
            out["flash_attention_bwd_dkv"].append({**dkv, **tags})
        del tensors
        torch.cuda.empty_cache()


def swiglu_tp_case(timer: Timer, gen, out: dict, label: str, d: int, F_: int, dtypes: tuple,
                   N: int = 8192, **tags) -> None:
    """swiglu at one shape (by default a shard shape: N 8192 rows, d_ff / tp
    columns) in each of ``dtypes``, under phase 2's limits; the bf16 row
    joins ``out``."""
    from repro_torch.kernels import swiglu as sg
    from repro_torch.kernels.ref import swiglu_ref

    for dtype in dtypes:
        x = randn(gen, N, d, dtype=dtype)
        w1 = randn(gen, d, F_, dtype=dtype, scale=d ** -0.5)
        w3 = randn(gen, d, F_, dtype=dtype, scale=d ** -0.5)
        rtol, atol = TOL["swiglu"][dtype]
        err = check_close(f"swiglu {label} {dtype} ({N}, {d})x({d}, {F_})",
                          sg.swiglu_cuda(x, w1, w3),
                          swiglu_ref(x.float(), w1.float(), w3.float()).to(dtype),
                          rtol=rtol, atol=atol, why=TOL["swiglu"]["why"])
        if dtype == torch.bfloat16:
            b, by = bound_ms((x.numel() + w1.numel() + w3.numel() + N * F_) * 2,
                             4 * N * d * F_, dtype)
            out["swiglu"].append({
                "shape": f"x ({N}, {d}), w1/w3 ({d}, {F_}) bf16", **tags,
                "max_abs_err": err, "rtol": rtol, "atol": atol,
                "tile": sg.swiglu_tile(N, F_, card_sms()),
                "ms": timer(lambda: sg.swiglu_cuda(x, w1, w3)),
                "plain_ms": timer(lambda: swiglu_ref(x, w1, w3)),
                "library_ms": timer(lambda: F.silu(x @ w1) * (x @ w3)),
                "library_call": "F.silu(x@w1)*(x@w3), a cuBLAS composition",
                "bound_ms": b, "bound_by": by})
        del x, w1, w3


def phase_kernels_tp(timer: Timer) -> dict:
    """The train steps' kernels at the shard shapes of tensor parallelism
    (tp = 2 and 4) on the train microbatch (4 x 2048 tokens), under the
    limits of phase 2.  Dense (bf16 and fp32): yi-6b (32q/4kv heads of 128,
    d_ff 11008, vocab 64000) and gpt-1.4b (24 heads of 88, d_ff 8448, vocab
    51200): the flash forward and backward at heads / tp, swiglu and
    gelu_mlp at d_ff / tp, and CE on each vocab shard with labels outside
    it (their stand-in 0 and the ownership mask of the vocab-parallel CE)
    and, on the last shard, a local valid vocab short of the shard, through
    the vocab-parallel CE's shard and merge steps (``ce_shards``), against
    the whole vocab's plain CE.  The recurrent families
    (``recurrent_kernels_tp``): zamba2-2.7b's SSD scan at 40 and 20 of its
    80 heads (bf16, chunk 128), its shared block's flash forward and
    backward at 16 and 8 of 32 heads of 80 and swiglu at F 5120 and 2560
    (d 2560), its CE on vocab shards of 16000 and 8000; rwkv6-1.6b's wkv
    scan at 16 and 8 of its 32 heads (fp32, chunk 32) and its CE on shards
    of 32768 and 16384 (d 2048).  bf16 rows (the wkv scan's fp32) timed
    beside their bounds and library calls: rows to join each kernel's
    cases."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import gelu_mlp as gm
    from repro_torch.kernels.ref import gelu_mlp_in_ref

    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {k: [] for k in ("flash_attention", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv", "cross_entropy", "swiglu", "gelu_mlp",
                           "ssd_scan", "wkv_scan")}
    bf16, N = torch.bfloat16, 8192
    for tp in TP_WAYS:
        for c in (get_config("yi-6b"), get_config("gpt-1.4b")):
            flash_tp_case(timer, gen, out, f"tp{tp} {c.name}", c.n_heads // tp,
                          c.n_kv_heads // tp, c.resolved_head_dim, (bf16, torch.float32),
                          tp=tp)
        for dtype in (bf16, torch.float32):
            swiglu_tp_case(timer, gen, out, f"tp{tp}", 4096, 11008 // tp, (dtype,),
                           tp=tp)                               # yi-6b's gate
            F_ = GPT_F // tp                                    # gpt-1.4b's GELU half
            x = randn(gen, N, GPT_D, dtype=dtype)
            w1 = randn(gen, GPT_D, F_, dtype=dtype, scale=GPT_D ** -0.5)
            err = check_gelu_mlp(f"gelu_mlp tp{tp} {dtype} ({N}, {GPT_D})x({GPT_D}, {F_})",
                                 x, w1)
            if dtype == bf16:
                rtol, atol = TOL["gelu_mlp"][dtype]
                b, by = bound_ms((x.numel() + w1.numel() + N * F_) * 2,
                                 2 * N * GPT_D * F_, dtype)
                out["gelu_mlp"].append({
                    "shape": f"x ({N}, {GPT_D}), w1 ({GPT_D}, {F_}) bf16", "tp": tp,
                    "max_abs_err": err, "rtol": rtol, "atol": atol,
                    "scale_tol": GELU_SCALE_TOL, "tile": gm.gelu_mlp_tile(N, F_, card_sms()),
                    "ms": timer(lambda: gm.gelu_mlp_cuda(x, w1)),
                    "plain_ms": timer(lambda: gelu_mlp_in_ref(x, w1)),
                    "library_ms": timer(lambda: F.gelu(x @ w1, approximate="tanh")),
                    "library_call": "F.gelu(x @ w1, approximate='tanh')",
                    "bound_ms": b, "bound_by": by})
            del x, w1
            torch.cuda.empty_cache()
        for d, V in ((4096, 64000), (GPT_D, 51200)):
            for dtype in (bf16, torch.float32):
                out["cross_entropy"] += ce_shards(timer, gen, tp, 4 * 2047, d, V, dtype)
            torch.cuda.empty_cache()
    for name, rows in recurrent_kernels_tp(timer).items():
        out[name] += rows
    return out


def recurrent_kernels_tp(timer: Timer) -> dict:
    """zamba2-2.7b's and rwkv6-1.6b's train-step kernels at the shard shapes
    of tp = 2 and 4 on the train microbatch (4 x 2048 tokens) in the dtype
    their step runs them (see ``phase_kernels_tp``), under phase 2's limits:
    the SSD scan (its work division held to the mirrors at the shard's
    heads; the carry one chunk late must fail the limit), the wkv scan (the
    same), the flash kernels at zamba2's shared-block heads of 80 (MHA),
    swiglu at its shared MLP's d_ff / tp, CE through the vocab-parallel
    shard and merge steps.  Each bf16 row (the wkv scan's fp32) carries
    ``tp`` and ``arch``."""
    from repro_torch.configs import get_config
    from repro_torch.models import rwkv as rwkv_mod, ssm

    gen = torch.Generator(device="cuda").manual_seed(8)
    z, rw = get_config(ZAMBA), get_config(RWKV)
    h_ssm, h_wkv, B, T = ssm.n_ssm_heads(z), rwkv_mod.n_rwkv_heads(rw), 4, 2048
    out = {k: [] for k in ("flash_attention", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv", "cross_entropy", "swiglu",
                           "ssd_scan", "wkv_scan")}
    check_scan_mirrors("ssd_scan", [(B, T, h_ssm // tp, 128) for tp in TP_WAYS])
    check_scan_mirrors("wkv_scan", [(B, T, h_wkv // tp, 32) for tp in TP_WAYS])
    bf16 = torch.bfloat16
    for tp in TP_WAYS:
        H = h_ssm // tp
        args = ssd_inputs(gen, B, T, bf16, H=H)
        err = check_ssd(f"ssd_scan tp{tp} {bf16} (B {B}, T {T}, H {H}, P 64, N 64) chunk 128",
                        args, 128)
        out["ssd_scan"].append({**ssd_row(timer, err, args, 128), "tp": tp, "arch": ZAMBA})
        del args
        H = h_wkv // tp
        args = wkv_inputs(gen, B, T, H=H)
        res = check_wkv(f"wkv_scan tp{tp} fp32 (B {B}, T {T}, H {H}, K 64) chunk 32", args, 32)
        out["wkv_scan"].append({**wkv_row(timer, res, args, 32), "tp": tp, "arch": RWKV})
        del args
        torch.cuda.empty_cache()
        flash_tp_case(timer, gen, out, f"tp{tp} {ZAMBA} shared", z.n_heads // tp,
                      z.n_kv_heads // tp, z.resolved_head_dim, (bf16,), tp=tp, arch=ZAMBA)
        swiglu_tp_case(timer, gen, out, f"tp{tp} {ZAMBA} shared", z.d_model, z.d_ff // tp,
                       (bf16,), tp=tp, arch=ZAMBA)
        for c in (z, rw):
            out["cross_entropy"] += [{**row, "arch": c.name} for row in ce_shards(
                timer, gen, tp, 4 * 2047, c.d_model, c.vocab_size, bf16)]
        torch.cuda.empty_cache()
    return out


# phase 2j: the flash kernels at the shard shapes of sequence parallelism:
# qwen3-32b's attention (64q/8kv heads of 128, causal, bf16) on one row of
# train_4k's 4096 positions, its queries split over the model group of tp 16
# (fsdp_seq at tp 16: 256-query shards) and tp 4 (1024), each shard's
# queries at q_offset r S / tp against the whole sequence's K and V, as a
# whole attention block runs under sequence parallelism
# (models/blocks.py:self_attn_block)
SEQ_SHARD_ARCH, SEQ_SHARD_S, SEQ_SHARD_WAYS = "qwen3-32b", 4096, (16, 4)


def seq_shard_pairs(B: int, Hq: int, s: int, off: int) -> int:
    """The unmasked (q, k) pairs of one causal query shard of ``s`` rows at
    absolute position ``off`` against the keys [0, off + s)."""
    return B * Hq * (s * off + s * (s + 1) // 2)


def seq_shard_rows(timer: Timer, q, k, v, o, lse, do, off: int, errs: tuple, **tags
                   ) -> tuple[dict, dict, dict]:
    """The timed forward, dQ and dK/dV rows of one query shard at ``off``:
    each beside its bound and SDPA's time with the explicit offset mask
    (a boolean (s, S) mask, ``enable_gqa``), forward and backward."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

    B, s, Hq, hd = q.shape
    Skv = k.shape[1]
    kw = dict(causal=True, q_offset=off)
    pairs = seq_shard_pairs(B, Hq, s, off)
    el = q.element_size()
    qt, kt, vt, ot, dot = (t.transpose(1, 2) for t in (q, k, v, o, do))
    mask = (torch.arange(Skv, device=q.device)[None, :]
            <= torch.arange(off, off + s, device=q.device)[:, None])
    try:
        sdpa_fwd = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                enable_gqa=True))
        ql, kl, vl = (t.detach().requires_grad_() for t in (qt, kt, vt))
        lo = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, enable_gqa=True)
        sdpa_bwd = timer(lambda: torch.autograd.grad(lo, (ql, kl, vl), dot, retain_graph=True))
        del lo
    except TypeError:                           # torch without enable_gqa
        sdpa_fwd = sdpa_bwd = None
    shape = (f"q/o/dO ({B}, {s}, {Hq}, {hd}) at q_offset {off}, k/v ({B}, {Skv}, "
             f"{k.shape[2]}, {hd}) bf16 causal")
    common = {"shape": shape, **tags, "library_call": "F.scaled_dot_product_attention("
              "attn_mask=the shard's causal offset mask, enable_gqa=True)"}
    b, by = bound_ms(2 * q.numel() * el + 2 * k.numel() * el + B * Hq * s * 4,
                     4 * hd * pairs, q.dtype)
    fwd = {**common, "max_abs_err": errs[0],
           "ms": timer(lambda: fa.flash_attention_fwd_cuda(q, k, v, **kw)),
           "plain_ms": timer(lambda: flash_attention_ref(qt, kt, vt, **kw)),
           "library_ms": sdpa_fwd, "bound_ms": b, "bound_by": by}
    args, _ = fa.bwd_args(q, k, v, o, lse, do, **kw)
    plain_bwd = timer(lambda: flash_attention_bwd_ref(qt, kt, vt, ot, lse, dot, **kw))
    b, by = bound_ms(el * (3 * q.numel() + 2 * k.numel()) + 8 * B * Hq * s,
                     3 * 2 * hd * pairs, q.dtype)
    dq = {**common, "max_abs_err": errs[1], "ms": timer(lambda: fa.launch_bwd_dq(args)),
          "plain_ms": plain_bwd, "plain_call": "flash_attention_bwd_ref (dq, dk, dv)",
          "library_ms": sdpa_bwd, "bound_ms": b, "bound_by": by}
    b, by = bound_ms(el * (2 * q.numel() + 4 * k.numel()) + 8 * B * Hq * s,
                     4 * 2 * hd * pairs, q.dtype)
    dkv = {**common, "max_abs_err": max(errs[2:]),
           "ms": timer(lambda: fa.launch_bwd_dkv(args)), "plain_ms": plain_bwd,
           "plain_call": "flash_attention_bwd_ref (dq, dk, dv)", "library_ms": sdpa_bwd,
           "bound_ms": b, "bound_by": by}
    return fwd, dq, dkv


def phase_kernels_seq(timer: Timer) -> dict:
    """Phase 2j (SEQ_SHARD_*): each query shard's forward and backward
    against the plain versions on the same tensors at the flash limits of
    phase 2 (the P@|V| term of the forward; |dS|@|K|, |dS|^T@|Q|, P^T@|dO|
    and the cancelling C terms of the backward); then the shards put
    together (the outputs and dQ concatenated, dK and dV summed in fp32 over
    the shards, as the sequence's reduce-scatter sums the ranks' parts)
    against the unsplit kernel call on the same tensors, within the same
    limits (their terms the shards' concatenated or summed).  Each shard's
    forward, dQ and dK/dV timed beside its bound and SDPA with the offset
    mask: rows to join the flash kernels' cases."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

    cfg = get_config(SEQ_SHARD_ARCH)
    Hq, Hkv, hd, S = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, SEQ_SHARD_S
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, do = (randn(gen, 1, S, Hq, hd, dtype=bf16) for _ in range(2))
    k, v = (randn(gen, 1, S, Hkv, hd, dtype=bf16) for _ in range(2))
    whole = fa.flash_attention_fwd_cuda(q, k, v, causal=True)
    whole_grads = fa.flash_attention_bwd_cuda(q, k, v, *whole, do, causal=True)
    rtol, atol = TOL["flash_attention"][bf16]
    brtol, stol = FLASH_BWD_TOL[bf16]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    kf, vf = kt.float(), vt.float()
    out = {n: [] for n in ("flash_attention", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv")}
    for ways in SEQ_SHARD_WAYS:
        s = S // ways
        outs, pv, dqs, dq_terms = [], [], [], [[], []]
        dkv = [torch.zeros(kt.shape, dtype=torch.float32, device=k.device) for _ in range(2)]
        dkv_terms = [torch.zeros_like(dkv[0]) for _ in range(3)]   # |dS|^T|Q|, C^T|Q|, P^T|dO|
        for r in range(ways):
            off = r * s
            kw = dict(causal=True, q_offset=off)
            qr, dor = q[:, off:off + s], do[:, off:off + s]
            name = f"flash seq {ways}-way shard {r} (1, {s}, {Hq}q/{Hkv}kv, {hd}) q_offset {off}"
            o, lse = fa.flash_attention_fwd_cuda(qr, k, v, **kw)
            qt = qr.transpose(1, 2)
            scale = flash_attention_ref(qt.float(), kf, vf.abs(), **kw)
            e_fwd = check_close(name, o, flash_attention_ref(qt, kt, vt, **kw).transpose(1, 2),
                                rtol=rtol, atol=atol, why=TOL["flash_attention"]["why"],
                                terms=((scale.transpose(1, 2), FLASH_P_TOL, "P@|V|"),))
            grads = fa.flash_attention_bwd_cuda(qr, k, v, o, lse, dor, **kw)
            ref, scales, cancel = flash_attention_bwd_ref(
                qt.float(), kf, vf, o.float().transpose(1, 2), lse,
                dor.float().transpose(1, 2), return_scales=True, **kw)
            terms = (((scales[0], stol, "|dS|@|K|*scale"),
                      (cancel[0], FLASH_BWD_CANCEL_TOL, "C@|K|*scale")),
                     ((scales[1], stol, "|dS|^T@|Q|*scale"),
                      (cancel[1], FLASH_BWD_CANCEL_TOL, "C^T@|Q|*scale")),
                     ((scales[2], stol, "P^T@|dO|"),))
            errs = [check_close(f"{name} {g}", got, want.transpose(1, 2), rtol=brtol,
                                atol=1e-6, why=FLASH_BWD_WHY,
                                terms=tuple((sc.transpose(1, 2), tol, sn)
                                            for sc, tol, sn in gterms))
                    for g, got, want, gterms in zip(("dq", "dk", "dv"), grads, ref, terms)]
            tags = {"seq_ways": ways, "shard": r, "q_offset": off}
            for key, row in zip(out, seq_shard_rows(timer, qr, k, v, o, lse, dor, off,
                                                    (e_fwd, *errs), **tags)):
                out[key].append(row)
            outs.append(o)
            pv.append(scale)
            dqs.append(grads[0])
            dq_terms[0].append(scales[0])
            dq_terms[1].append(cancel[0])
            for acc, g in zip(dkv, grads[1:]):
                acc += g.float().transpose(1, 2)
            for acc, t in zip(dkv_terms, (scales[1], cancel[1], scales[2])):
                acc += t
            del ref, scales, cancel, grads, o, lse
            torch.cuda.empty_cache()
        name = f"flash seq {ways}-way shards put together vs the unsplit call"
        check_close(f"{name}: o", torch.cat(outs, 1), whole[0], rtol=rtol, atol=atol,
                    why=TOL["flash_attention"]["why"],
                    terms=((torch.cat(pv, 2).transpose(1, 2), FLASH_P_TOL, "P@|V|"),))
        check_close(f"{name}: dq", torch.cat(dqs, 1), whole_grads[0], rtol=brtol, atol=1e-6,
                    why=FLASH_BWD_WHY,
                    terms=((torch.cat(dq_terms[0], 2).transpose(1, 2), stol, "|dS|@|K|*scale"),
                           (torch.cat(dq_terms[1], 2).transpose(1, 2), FLASH_BWD_CANCEL_TOL,
                            "C@|K|*scale")))
        for g, got, want, gterms in (
                ("dk", dkv[0], whole_grads[1],
                 ((dkv_terms[0], stol, "|dS|^T@|Q|*scale"),
                  (dkv_terms[1], FLASH_BWD_CANCEL_TOL, "C^T@|Q|*scale"))),
                ("dv", dkv[1], whole_grads[2], ((dkv_terms[2], stol, "P^T@|dO|"),))):
            check_close(f"{name}: {g} summed over the shards", got.transpose(1, 2), want,
                        rtol=brtol, atol=1e-6, why=FLASH_BWD_WHY,
                        terms=tuple((t.transpose(1, 2), tol, n) for t, tol, n in gterms))
        del outs, pv, dqs, dq_terms, dkv, dkv_terms
        torch.cuda.empty_cache()
    return out


def ce_shards(timer: Timer, gen, tp: int, N: int, d: int, V: int, dtype) -> list[dict]:
    """CE over ``tp`` vocab shards of (d, V) through the vocab-parallel CE's
    own shard and merge steps (``models/vocab_parallel.py``: ``shard_terms``
    on each shard, the kernel at its shard shape, then ``merge_lse``; the
    all-gather and all-reduce between them become a stack and a sum on one
    card), the whole vocab valid but its last 3 columns (a padded vocab's
    stand-in); returns the timed row of shard 0 in bf16."""
    from repro_torch.kernels import cross_entropy as ce
    from repro_torch.kernels.ref import cross_entropy_ref
    from repro_torch.models import vocab_parallel as vp

    h = randn(gen, N, d, dtype=dtype)
    w = randn(gen, d, V, dtype=dtype, scale=d ** -0.5)
    valid, Vl = V - 3, V // tp
    labels = torch.randint(0, valid, (N,), generator=gen, device="cuda")
    lses, lls, rows = [], [], []
    for r in range(tp):
        ws = w[:, r * Vl:(r + 1) * Vl].contiguous()
        lse, ll, local, owned, vv = vp.shard_terms(h, ws, labels, valid, r * Vl)
        name = f"ce tp{tp} shard {r} {dtype} ({N}, {d})x({d}, {Vl}), valid {vv}"
        (e1, e2), _, _ = ce_check(name, h, ws, local, vv, lse, ll, owned)
        lses.append(lse)
        lls.append(ll)
        if dtype == torch.bfloat16 and r == 0:
            b, by = bound_ms(2 * (h.numel() + ws.numel()) + 8 * N + 8 * N, 2 * N * d * Vl,
                             dtype)
            rows.append({
                "shape": f"h ({N}, {d}), w ({d}, {Vl}) bf16, {int(owned.sum())} of {N} "
                         "labels in the shard", "tp": tp, "max_abs_err": max(e1, e2),
                "tile": [ce.TILE_M, ce.TILE_N], "partials": ce.n_partials(Vl, dtype),
                "ms": timer(lambda: ce.cross_entropy_cuda(h, ws, local, vv)),
                "plain_ms": timer(lambda: cross_entropy_ref(h, ws, local, vv)),
                "plain_call": "cross_entropy_ref (materialized fp32 logits)",
                "library_ms": timer(lambda: F.cross_entropy((h @ ws).float(), local,
                                                            reduction="none")),
                "library_call": "F.cross_entropy on (h @ w_shard).float()",
                "bound_ms": b, "bound_by": by})
        del ws
    ce_check(f"ce tp{tp} {dtype} ({N}, {d})x({d}, {V}), {tp} shards merged", h, w, labels,
             valid, vp.merge_lse(torch.stack(lses)), sum(lls))
    return rows


# ---------------------------------------------------------------------------
# phase 2e: the rwkv slice's wkv scan and wkv decode step
# ---------------------------------------------------------------------------

# wkv scan: the kernel and the plain version run the same fp32 chunk algebra
# in another order, with their own exp, log and cumsum.  wkv_error_bound
# carries each rounding through the chunk algebra to first order (u = 2^-24
# a rounding; a sum of n terms off by n u of its absolute sum): the cumsum
# of Q logs of one sign is off by (Q + 2) u |cum|, an absolute error in every
# exponent that takes it (a gap cum_{t-1} - cum_i takes both ends'), which
# at rwkv's fast decays (|cum| up to several hundred over 32 tokens) is the
# largest term; then exp (2 ulp), the products, the K-term dot products, the
# Q-term sums over i and the three-term sum of y; the state's error carries
# from chunk to chunk.  Worst case ("worst"): every term at its bound, in
# the same direction.  RMS ("rms"): each rounding of rms u/sqrt(3), a sum of
# n of them of rms sqrt(n) u/sqrt(3); the exponent errors of one channel
# taken as correlated over i and t (they share the cumsum), the channels and
# the sum roundings as independent; WKV_SIGMAS of that rms.  Each
# implementation may be off by the bound: the limit is twice the worst case,
# or sqrt(2) WKV_SIGMAS rms.  WKV_LIMIT names the form the check holds: on
# an NVIDIA H100 80GB HBM3 (700 W) the worst case read the sound kernel at
# 0.012-0.099 of it over the eleven cases (too loose to tell a fault of a
# few ulps), the rms form at 0.11-0.33.
WKV_LIMIT = "rms"
WKV_SIGMAS = 8.0
WKV_WHY = ("fp32 chunk algebra in another order, with its own exp, log and cumsum: "
           "wkv_error_bound's first-order carry of each rounding, the cumsum's "
           "absolute error in every exponent first")
WKV_FAULTS = ("diagonal in the intra-chunk mask (i <= t)", "bonus term dropped",
              "carry-in not decayed by exp(cum_prev)")
# the carry one chunk late, planted at every case of 4 chunks or more
WKV_LATE = "chunk 2 read out from S_2, not S_1"
# the decode step's state update rounds as the plain version does (product,
# then sum): |S' - S''| <= 2u |w S| + u |k v| per implementation; out sums K
# terms r (S + u k v) in another order, each with its own few roundings: in
# the rms form of the scan's limit, sqrt(2) WKV_SIGMAS sqrt(K + 4) u/sqrt(3)
# of the terms' root sum of squares.
WKV_DECODE_WHY = ("state: the plain version's two roundings (w*S, + k v); out: K-term "
                  "sum in another order, with the bonus product's roundings, as "
                  "WKV_SIGMAS rms")


def _wkv_plain_variant(r, k, v, w, u, state, chunk: int, fault: str | None = None):
    """``wkv_scan_ref``'s chunk loop with one of WKV_FAULTS planted (the
    checks' yardstick of what a wrong kernel gives)."""
    B, T, H, K = r.shape
    lw = torch.log(w)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=r.device),
                     diagonal=0 if fault == WKV_FAULTS[0] else -1)
    ys = []
    for s in range(0, T, chunk):
        c = slice(s, s + chunk)
        rc, kc, vc = r[:, c], k[:, c], v[:, c]
        cum = torch.cumsum(lw[:, c], 1)
        cum_prev = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)
        rd = rc if fault == WKV_FAULTS[2] else rc * torch.exp(cum_prev)
        y = torch.einsum("bthk,bhkv->bthv", rd, state)
        gap = torch.where(tri[None, :, :, None, None],
                          cum_prev[:, :, None] - cum[:, None], -torch.inf)
        score = torch.einsum("bthk,bihk,btihk->btih", rc, kc, torch.exp(gap))
        y = y + torch.einsum("btih,bihv->bthv", score, vc)
        if fault != WKV_FAULTS[1]:
            y = y + torch.einsum("bthk,bthv->bthv", rc * (u[None, None] * kc), vc)
        total = cum[:, -1]
        state = torch.exp(total)[..., None] * state + torch.einsum(
            "bihk,bihv->bhkv", kc * torch.exp(total[:, None] - cum), vc)
        ys.append(y)
    return torch.cat(ys, 1), state


def wkv_error_bound(r, k, v, w, u, state, chunk: int) -> dict[str, tuple]:
    """{"worst": (bound on |y - y'| (B, T, H, V), on |S - S'| (B, H, K, V)),
    "rms": (the rms of each)} between two fp32 evaluations of the chunked
    scan in another order (see WKV_LIMIT): ``wkv_scan_ref``'s chunk loop in
    float64 over absolute values, each term weighted by its first-order
    relative error, for one evaluation (the caller doubles it)."""
    B, T, H, K = r.shape
    Q = chunk
    u_ = U32
    uq = U32 / 3 ** 0.5                                      # rms of one rounding
    r, k, v, w, uu = (t.double() for t in (r, k, v, w, u))
    S = state.double()
    S_w = torch.zeros_like(S)                                # worst-case error of S
    S_r = torch.zeros_like(S)                                # its rms
    lt = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=r.device), diagonal=-1)
    lt = lt[None, :, :, None, None]
    lw = torch.log(w)
    ys_w, ys_r = [], []
    for s in range(0, T, Q):
        c = slice(s, s + Q)
        rc, kc, vc = r[:, c], k[:, c], v[:, c]
        cum = torch.cumsum(lw[:, c], 1)                      # (B, Q, H, K), <= 0
        cum_prev = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)
        ec_w = (Q + 2) * u_ * cum.abs()                      # absolute, in the exponent
        ec_r = (Q + 2) ** 0.5 * uq * cum.abs()
        ep_w = torch.cat([torch.zeros_like(ec_w[:, :1]), ec_w[:, :-1]], 1)
        ep_r = torch.cat([torch.zeros_like(ec_r[:, :1]), ec_r[:, :-1]], 1)
        # inter: y = (r e^cum_prev) S, K terms
        rd = rc.abs() * torch.exp(cum_prev)
        inter = torch.einsum("bthk,bhkv->bthv", rd, S.abs())
        y_w = (torch.einsum("bthk,bhkv->bthv", rd * (3 * u_ + ep_w), S.abs())
               + K * u_ * inter + torch.einsum("bthk,bhkv->bthv", rd, S_w))
        y_r2 = (torch.einsum("bthk,bhkv->bthv", rd.square() * (3 * uq ** 2 + ep_r.square()),
                             S.square())
                + K * uq ** 2 * torch.einsum("bthk,bhkv->bthv", rd.square(), S.square())
                + torch.einsum("bthk,bhkv->bthv", rd.square(), S_r.square()))
        # intra: score_ti = sum_k r k e^gap over i < t, then sum_i score v_i
        gap = cum_prev[:, :, None] - cum[:, None]            # (B, t, i, H, K)
        eg = torch.where(lt, torch.exp(torch.where(lt, gap, 0.0)), 0.0)
        Tm = rc.abs()[:, :, None] * kc.abs()[:, None] * eg   # |r k e^gap|
        e_w = (4 + K) * u_ + ep_w[:, :, None] + ec_w[:, None] + u_ * gap.abs()
        e_r2 = (4 + K) * uq ** 2 + (uq * gap).square()
        score = Tm.sum(-1)                                   # (B, t, i, H)
        va = vc.abs()
        intra = torch.einsum("btih,bihv->bthv", score, va)
        y_w = y_w + torch.einsum("btihk,bihv->bthv", Tm * torch.where(lt, e_w, 0.0), va) \
            + (Q + 1) * u_ * intra
        # rms: per channel, the exponent errors of cum_prev_t and cum_i are
        # summed over i linearly, the channels independently
        corr = (torch.einsum("btihk,bihv->bthkv", Tm, va) * ep_r[..., None]).square().sum(3) \
            + torch.einsum("btihk,bihv->bthv", Tm.square() * ec_r[:, None].square(),
                           va.square())
        y_r2 = y_r2 + corr + torch.einsum("btihk,bihv->bthv", Tm.square() * e_r2,
                                          va.square()) \
            + (Q + 1) * uq ** 2 * torch.einsum("btih,bihv->bthv", score.square(), va.square())
        # bonus: (r . (u k)) v_t
        bk = (rc * uu[None, None] * kc).abs()
        bonus = bk.sum(-1, keepdim=True) * va
        y_w = y_w + (K + 3) * u_ * bonus + 2 * u_ * (inter + intra + bonus)
        y_r2 = (y_r2 + (K + 3) * uq ** 2 * bk.square().sum(-1, keepdim=True) * va.square()
                + 2 * uq ** 2 * (inter.square() + intra.square() + bonus.square()))
        ys_w.append(y_w)
        ys_r.append(y_r2.sqrt())
        # state: S' = e^total S + sum_i (k_i e^{total - cum_i}) v_i
        total = cum[:, -1]                                   # (B, H, K)
        et = torch.exp(total)[..., None]
        et_w, et_r = ec_w[:, -1][..., None], ec_r[:, -1][..., None]
        rem = total[:, None] - cum                           # (B, Q, H, K), <= 0
        kr = kc.abs() * torch.exp(rem)
        carry = torch.einsum("bihk,bihv->bhkv", kr, va)
        e_i_w = (Q + 5) * u_ + ec_w + u_ * rem.abs()
        e_i_r2 = (Q + 5) * uq ** 2 + ec_r.square() + (uq * rem).square()
        S_w_new = (et * (S_w + S.abs() * (3 * u_ + et_w)) + et_w * carry
                   + torch.einsum("bihk,bihv->bhkv", kr * e_i_w, va))
        S_r = (et.square() * (S_r.square() + S.square() * 3 * uq ** 2)
               + (et_r * (et * S.abs() + carry)).square()
               + torch.einsum("bihk,bihv->bhkv", kr.square() * e_i_r2, va.square())).sqrt()
        S_w = S_w_new
        S = et * S + torch.einsum("bihk,bihv->bhkv", kc * torch.exp(rem), vc)
    return {"worst": (torch.cat(ys_w, 1), S_w), "rms": (torch.cat(ys_r, 1), S_r)}


def wkv_limit_terms(bounds: dict, form: str) -> tuple[tuple, tuple]:
    """The check's error terms for y and the state under a limit form."""
    ey, es = bounds[form]
    f = 2.0 if form == "worst" else 2 ** 0.5 * WKV_SIGMAS
    name = "2 x first-order bound" if form == "worst" else f"sqrt(2) x {WKV_SIGMAS:g} rms"
    return ((ey, f, name),), ((es, f, name),)


def wkv_inputs(gen, B: int, T: int, H: int = 32, K: int = 64):
    """r, k, v of unit scale (projections of normed activations), the decays
    w = exp(-exp(z)) with z ~ N(mu_k, 0.5) and per-channel mu_k spread over
    [-7, 2] (w from ~0.999 to ~1e-3, so a 32-token cumsum reaches several
    hundred below zero), a nonzero bonus u and carried state."""
    def n(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    mu = torch.linspace(-7.0, 2.0, H * K, device="cuda").reshape(H, K)
    mu = mu.flatten()[torch.randperm(H * K, generator=gen, device="cuda")].reshape(H, K)
    w = torch.exp(-torch.exp(mu + 0.5 * n(B, T, H, K)))
    return n(B, T, H, K), n(B, T, H, K), n(B, T, H, K), w, 0.5 * n(H, K), 0.5 * n(B, H, K, K)


def _wkv_cases() -> list[tuple[int, int, int]]:
    """(B, T, chunk) of the scan checks: the train microbatch, each rwkv6
    serve prompt of 8 tokens or more at the chunk of its exact-length
    prefill, and one length for each other chunk (2, 4, 16)."""
    from repro_torch.kernels.tiling import WKV_CHUNK, pick_chunk

    cases = [(4, 2048, WKV_CHUNK)]
    for T in [t for t in SERVE_PROMPT_LENS[RWKV] if t >= 8] + [50, 100, 48]:
        case = (1, T, pick_chunk(T, WKV_CHUNK))
        if case not in cases:
            cases.append(case)
    return cases


def check_wkv(name: str, args: tuple, chunk: int, planted: bool = False) -> dict:
    """The wkv kernel against ``wkv_scan_ref`` on the same inputs, y and the
    final state, at the WKV_LIMIT form (the other form's share is reported);
    with ``planted``, each of WKV_FAULTS of the plain version must fail the
    same limit.  Returns the max abs error and both forms' worst shares."""
    from repro_torch.kernels import wkv_scan as wkv
    from repro_torch.kernels.ref import wkv_scan_ref

    y, S = wkv.wkv_scan_cuda(*args, chunk)
    torch.cuda.synchronize()
    check_repeat(name, (y, S), wkv.wkv_scan_cuda(*args, chunk))
    yr, Sr = wkv_scan_ref(*args, chunk=chunk)
    bounds = wkv_error_bound(*args, chunk)
    ty, ts = wkv_limit_terms(bounds, WKV_LIMIT)
    err = check_close(name + " y", y, yr, rtol=0.0, atol=1e-6, why=WKV_WHY, terms=ty)
    err = max(err, check_close(name + " state", S, Sr, rtol=0.0, atol=1e-6, why=WKV_WHY,
                               terms=ts))
    shares = {}
    for form in ("worst", "rms"):
        fy, fs = wkv_limit_terms(bounds, form)
        shares[form] = max(float(limit_share(y, yr, 0.0, 1e-6, fy)[1].max()),
                           float(limit_share(S, Sr, 0.0, 1e-6, fs)[1].max()))
    emit({"phase": "kernel_check", "case": name, "sound_share_by_limit_form": shares,
          "limit_form": WKV_LIMIT})
    faults = list(WKV_FAULTS) if planted else []
    if args[0].shape[1] >= 4 * chunk:
        faults.append(WKV_LATE)
    for fault in faults:
        bad = (wkv_late_carry(args, yr, chunk) if fault == WKV_LATE
               else _wkv_plain_variant(*args, chunk, fault)[0])
        worst = {form: float(limit_share(bad, yr, 0.0, 1e-6,
                                         wkv_limit_terms(bounds, form)[0])[1].max())
                 for form in ("worst", "rms")}
        emit({"phase": "planted_fault", "case": name, "fault": fault,
              "worst_share_of_limit": worst[WKV_LIMIT], "share_by_limit_form": worst})
        if worst[WKV_LIMIT] <= 1:
            raise AssertionError(f"{name}: the limit does not catch a planted fault "
                                 f"({fault}: {worst[WKV_LIMIT]:.2f} of it)")
    return {"max_abs_err": err, "sound_share_by_limit_form": shares}


def wkv_late_carry(args: tuple, yr: torch.Tensor, chunk: int) -> torch.Tensor:
    """``yr`` with chunk SCAN_LATE_CHUNK's read-out taken from the state
    after that chunk in place of the one before it: (r e^{cum_{t-1}})
    (S_c - S_{c-1}) added to its rows, the states from the plain scan of its
    first chunks."""
    from repro_torch.kernels.ref import wkv_scan_ref

    r, k, v, w, u, state = args
    c = SCAN_LATE_CHUNK
    s_before, s_after = (wkv_scan_ref(*(a[:, :n * chunk] for a in (r, k, v, w)), u, state,
                                      chunk=chunk)[1] for n in (c, c + 1))
    rows = slice(c * chunk, (c + 1) * chunk)
    cum = torch.cumsum(torch.log(w[:, rows]), 1)
    cum_prev = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)
    bad = yr.clone()
    bad[:, rows] += torch.einsum("bthk,bhkv->bthv", r[:, rows] * torch.exp(cum_prev),
                                 s_after - s_before)
    return bad


# the special-function units of an H100 SXM: 16 results a clock an SM
# (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0) at the 1.98 GHz boost clock of the data sheet
SFU_PER_S = 132 * 16 * 1.98e9


def wkv_row(timer: Timer, res: dict, args: tuple, chunk: int) -> dict:
    """The timed row of a scan: the bound counts r, k, v, w, u and the state
    read once, y and the state written once, and the fp32 FLOPs of the
    chunk algebra on the unmasked (t, i) pairs; the floors beside it are the
    bytes, the FFMA work and the exponentials and logarithms on the
    special-function units; ``design_bound_ms`` adds what this design moves
    besides through device memory (for chunks over 8, k, w and v read again
    and each chunk's state written and read twice)."""
    from repro_torch.kernels import tiling, wkv_scan as wkv
    from repro_torch.kernels.ref import wkv_scan_ref

    r, k, v, w, u, state = args
    B, T, H, K = r.shape
    V = v.shape[-1]
    nbytes = 4 * (3 * r.numel() + 2 * v.numel() + u.numel() + 2 * state.numel())
    pairs = chunk * (chunk - 1) // 2
    per_chunk = pairs * K * 4 + pairs * V * 2 + chunk * K * V * 2 + chunk * (3 * K + 2 * V) \
        + K * V * (2 * chunk + 2)
    n_chunks = B * H * (T // chunk)
    flops = n_chunks * per_chunk
    b, by = bound_ms(nbytes, flops, torch.float32)
    extra = 0
    if chunk > tiling.SCAN_SMALL_CHUNK:
        extra = 4 * (2 * r.numel() + v.numel()) + 4 * 4 * n_chunks * K * (V + 1)
    db, dby = bound_ms(nbytes + extra, flops, torch.float32)
    sfu = n_chunks * (pairs + 2 * chunk + 1) * K + r.numel()

    def call():
        return wkv.wkv_scan_cuda(*args, chunk)

    ms, parent_ms = timed_with_parent(timer, "wkv_scan", call)
    return {"shape": f"r/k/v/w ({B}, {T}, {H}, {K}) fp32, chunk {chunk}", **res,
            "exps": n_chunks * (pairs + 2 * chunk + 1) * K,
            "ms": ms, "parent_ms": parent_ms, "ms_by_kernel": scan_kernel_ms(call),
            "plain_ms": timer(lambda: wkv_scan_ref(*args, chunk=chunk)),
            "plain_call": "wkv_scan_ref (the chunk loop in torch)",
            "library_ms": None, "library_call": "none: no single PyTorch call computes it",
            "bound_ms": b, "bound_by": by, "flops_rate": "fp32 FFMA",
            "floors_ms": {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                          "ffma": flops / PEAK_FLOPS[torch.float32] * 1e3,
                          "sfu (exp and log)": sfu / SFU_PER_S * 1e3},
            "design_bytes": nbytes + extra, "design_bound_ms": db, "design_bound_by": dby,
            "share_of_bound": b / ms, "share_of_design_bound": db / ms}


def check_wkv_decode(name: str, args: tuple, planted: bool = False) -> float:
    """The decode kernel against ``wkv_decode_ref``: out and the fresh state
    (the input state left as it was); with ``planted``, the state not
    decayed by w must fail the state's limit; then the in-place launch
    (``check_in_place``)."""
    from repro_torch.kernels import wkv_scan as wkv
    from repro_torch.kernels.ref import wkv_decode_ref, wkv_decode_ref_

    r, k, v, w, u, state = args
    before = state.clone()
    y, S = wkv.wkv_decode_cuda(*args)
    torch.cuda.synchronize()
    if not torch.equal(state, before):
        raise AssertionError(f"{name}: the decode kernel wrote its input state")
    yr, Sr = wkv_decode_ref(*args)
    kv = k[..., :, None] * v[..., None, :]
    K = r.shape[-1]
    terms = r.double()[..., None] * (state.double() + u.double()[None, :, :, None] * kv)
    dy = (2 ** 0.5 * WKV_SIGMAS * (K + 4) ** 0.5 * U32 / 3 ** 0.5
          * terms.square().sum(2).sqrt()).float()
    dS = 2 * U32 * (2 * (w[..., None] * state).abs() + kv.abs())
    err = check_close(name + " out", y, yr, rtol=0.0, atol=1e-7, why=WKV_DECODE_WHY,
                      terms=((dy, 1.0, f"sqrt(2) x {WKV_SIGMAS:g} rms of the K-term sum"),))
    err = max(err, check_close(name + " state", S, Sr, rtol=0.0, atol=1e-7,
                               why=WKV_DECODE_WHY, terms=((dS, 1.0, "2u(2|wS| + |kv|)"),)))
    if planted:
        bad = state + k[..., :, None] * v[..., None, :]
        worst = float(limit_share(bad, Sr, 0.0, 1e-7, ((dS, 1.0, ""),))[1].max())
        emit({"phase": "planted_fault", "case": name, "fault": "state not decayed by w",
              "worst_share_of_limit": worst})
        if worst <= 1:
            raise AssertionError(f"{name}: the limit does not catch the undecayed state")
    return max(err, check_in_place(
        name, lambda s, a: wkv.wkv_decode_cuda_(r, k, v, w, u, s, a),
        lambda s, a: wkv_decode_ref_(r, k, v, w, u, s, a), state,
        lambda: wkv.launches_decode, dy=dy, dS=dS, atol=1e-7, why=WKV_DECODE_WHY))


@torch.no_grad()
def phase_kernels_wkv(timer: Timer) -> dict:
    """The wkv scan at rwkv6's widths (H 32, K = V = 64, fp32) at the train
    microbatch 4 x 2048 (chunk 32, the timed headline row), at every
    (T, chunk) that the rwkv6 serve run prefills with the scan (the
    256-token prefill carries the planted faults) and at chunks 2, 4 and
    16; the decode step at 4 slots (with a planted fault), pure and in
    place.  Returns the scan and decode rows."""
    from repro_torch.kernels import wkv_scan as wkv
    from repro_torch.kernels.ref import wkv_decode_ref_

    gen = torch.Generator(device="cuda").manual_seed(6)
    check_scan_mirrors("wkv_scan", [(B, T, 32, chunk) for B, T, chunk in _wkv_cases()])
    rows = []
    for B, T, chunk in _wkv_cases():
        args = wkv_inputs(gen, B, T)
        res = check_wkv(f"wkv_scan fp32 (B {B}, T {T}, H 32, K 64) chunk {chunk}", args, chunk,
                        planted=T == 256)
        rows.append(wkv_row(timer, res, args, chunk))
        del args
        torch.cuda.empty_cache()
    r, k, v, w, u, state = wkv_inputs(gen, 4, 1)
    args = (r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, state)
    err = check_wkv_decode("wkv_decode_step fp32 (B 4, H 32, K 64)", args, planted=True)
    b, by = bound_ms(4 * (2 * state.numel() + 5 * 4 * 32 * 64 + u.numel()),
                     4 * 32 * 64 * 64 * 6, torch.float32)
    inputs = args[:5]
    rd = decode_readings(timer, lambda s, a: wkv.wkv_decode_cuda_(*inputs, s, a),
                         lambda: parent_wkv_decode(*args),
                         lambda s, a: wkv_decode_ref_(*inputs, s, a), state,
                         lambda s, a: wkv.wkv_decode_cuda_(*inputs, s, a),
                         lambda: parent_wkv_decode(*args))
    dec = {"shape": f"r/k/v/w (4, 32, 64), state {tuple(state.shape)} fp32, in place, "
                    "every slot active",
           "max_abs_err": err, **rd,
           "plain_call": "wkv_decode_ref_ (the pure step, then the masked copy)",
           "library_ms": None, "library_call": "none: no single PyTorch call computes it",
           "bound_ms": b, "bound_by": by, "share_of_bound": b / rd["ms"],
           "share_of_bound_device": (b / rd["device_ms"]
                                     if isinstance(rd["device_ms"], float) else None)}
    return {"wkv_scan": {**rows[0], "cases": rows[1:]}, "wkv_decode_step": dec}


# ---------------------------------------------------------------------------
# phase 3: serve yi-6b, gpt-1.4b, llama4-maverick and arctic at full width
# ---------------------------------------------------------------------------

# bf16 last-token logits, kernels on vs off: max |d| over the logit range
LOGITS_REL_TOL = 0.05
LOGITS_TOL_WHY = {
    "yi-6b": "bf16 through 32 layers; the kernels keep the gate products in fp32 "
             "and round P in attention; about 2% of the logit range on an H100",
    "gpt-1.4b": "bf16 through 24 layers; the kernels keep the GELU product and the "
                "LayerNorm statistics in fp32 before one rounding and round P in "
                "attention; the plain path rounds x@w1 to bf16 before its GELU",
    LLAMA4: "bf16 through 2 layers; the grouped kernel keeps both expert products in "
            "fp32 where the plain einsums round to bf16; a token whose top-1 expert "
            "flips between the runs (an ULP of the norm moves the router logits) "
            "changes its MoE output whole",
    ARCTIC: "bf16 through 1 layer; as llama4, with a top-2 choice per token",
    ZAMBA: "not held: bf16 through 54 mamba layers and 9 applications of the shared "
           "block at this random init grows any rounding over the depth until plain "
           "bf16 itself lands far from an fp32 copy of the model (tools/depth_drift.py); "
           "the bf16 readings are reported, and an fp32 copy of the model is held on vs "
           "off over prefill and decode ticks at FP32_LOGITS_RTOL",
    RWKV: "not held: bf16 through 24 rwkv layers at this random init grows a "
          "rounding 70x over the depth (tools/depth_drift.py): the wkv kernel "
          "alone moves the logits 4.2-7.9% of the range and plain bf16 lies 10% "
          "from an fp32 copy, so no limit above the sound spread tells a wrong "
          "kernel; the bf16 readings are reported, and an fp32 copy of the model "
          "is held on vs off over prefill and decode ticks at FP32_LOGITS_RTOL",
    DANUBE: "bf16 through 24 layers; as yi-6b, with a 4096-key window in the flash "
            "kernel's mask and a 6000-token prompt",
    PHI4: "bf16 through 32 layers; as yi-6b",
    QWEN3: "bf16 through 64 layers; as yi-6b, with qk-norm in the rmsnorm kernel",
    SEAMLESS: "bf16 through 12 encoder and 12 decoder layers; as gpt-1.4b, with the "
              "encoder's and the cross-attention's non-causal flash attention",
    INTERNVL: "bf16 through 24 layers; as yi-6b, over 256 patch positions ahead of "
              "the prompt",
}
# the archs whose bf16 logits are reported, not held to LOGITS_REL_TOL (their
# fp32 copy is held on vs off instead)
LOGITS_NOT_HELD = (ZAMBA, RWKV)
# zamba2 in fp32 at full depth, kernels on vs off: the fp32 kernels round
# in another order (~1e-7 of a value), which the depth grows as it grows
# bf16's roundings (tools/depth_drift.py); a sound prefill read 6.4e-5 of
# the range (NVIDIA H100 80GB HBM3, 700 W), and a kernel that gets any term
# wrong moves the logits by far more than 1e-3 of it.  rwkv6 likewise: a
# sound prefill and 8 ticks read 6.3e-6 to 8.9e-6 of the range.
FP32_LOGITS_RTOL = 1e-3
# the fp32 copy's decode ticks after request 0's prefill, at the engine's 4 slots
FP32_DECODE_TICKS = 8


# zamba2's serve prompts: odd lengths (chunk 1), small powers of two and a
# 96-token prompt (chunk 32); rwkv6's the same with a 5-token prompt in place
# of the 32-token one (under 8 tokens its prefill loops the decode step);
# h2o-danube's two past its 4096-token window (its prefill bucket 8192:
# the windowed flash at full width, a ring wrapped at prefill) among short
# ones; the other archs draw 8 lengths in [64, 256]
SERVE_PROMPT_LENS = {ZAMBA: (255, 64, 96, 200, 129, 32, 256, 77),
                     RWKV: (255, 64, 96, 200, 129, 5, 256, 77),
                     DANUBE: (6000, 64, 200, 129, 4500, 77, 256, 96)}


def slot_cache(cache: dict, n_slots: int) -> dict:
    """A one-row slot-swap cache repeated into ``n_slots`` rows, with the
    engine's per-slot ``pos`` vector."""
    pos = torch.full((n_slots,), int(cache["pos"]), dtype=torch.int32, device="cuda")
    return {"pos": pos, **{k: {name: t.repeat_interleave(n_slots, dim=1)
                               for name, t in tree.items()}
                           for k, tree in cache.items() if k != "pos"}}


def recurrent_fp32_on_vs_off(model, p0: torch.Tensor, lk: torch.Tensor,
                             lp: torch.Tensor) -> dict:
    """The logits checks of a recurrent family (hybrid, rwkv), on an fp32
    copy of ``model`` at full depth:
    request 0's prefill, then FP32_DECODE_TICKS decode ticks at 4 slots
    (each slot fed its own tokens, slot 3 inactive on odd ticks), kernels on
    vs off on the same tokens, each step's logits within FP32_LOGITS_RTOL of
    the plain logits' range; an inactive slot's cache rows must come out of
    a tick bit-identical.  Also reports, unchecked, how far the bf16
    kernels-on logits ``lk`` and kernels-off ``lp`` lie from the fp32 copy.
    The readings, with "failed" naming the checks that did not hold."""
    from repro_torch.core.compute import ComputePolicy
    from repro_torch.models.model import Model

    cfg = model.cfg
    m32 = Model(cfg, torch.float32, device="cuda")
    m32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    n = FP32_DECODE_TICKS
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, cfg.vocab_size, (n, 4, 1))).cuda()
    active = torch.ones(n, 4, dtype=torch.bool, device="cuda")
    active[1::2, 3] = False
    steps, frozen_same = {}, True
    for kernels in (True, False):
        m32.compute = ComputePolicy(kernels=kernels)
        logits, cache = m32.prefill({"tokens": p0}, 512)
        out = [logits]
        cache = slot_cache(cache, 4)
        for t in range(n):
            frozen = {(k, name): leaf[:, 3].clone() for k, tree in cache.items()
                      if k != "pos" for name, leaf in tree.items()} if not active[t, 3] else {}
            logits, cache = m32.decode_step(cache, {"token": toks[t], "active": active[t]})
            frozen_same &= all(torch.equal(cache[k][name][:, 3], v)
                               for (k, name), v in frozen.items())
            out.append(logits)
        steps[kernels] = out
        del cache
    del m32
    torch.cuda.empty_cache()
    rel = [max_err(a, b) / float(b.abs().max()) for a, b in zip(steps[True], steps[False])]
    span = float(steps[False][0].abs().max())
    res = {"fp32_logits_on_vs_off_rel_by_step": rel, "fp32_decode_ticks": n,
           "fp32_logits_rtol": FP32_LOGITS_RTOL, "fp32_frozen_slot_bit_identical": frozen_same,
           "bf16_on_vs_fp32_rel_unchecked": max_err(lk, steps[False][0]) / span,
           "bf16_off_vs_fp32_rel_unchecked": max_err(lp, steps[False][0]) / span}
    res["failed"] = [name for name, bad in (
        ("fp32 on vs off", not all(torch.isfinite(t).all() for t in steps[True])
         or max(rel) > FP32_LOGITS_RTOL),
        ("frozen slot", not frozen_same)) if bad]
    return res


def greedy_at_slots(model, prompt: np.ndarray, n: int, cache_len: int,
                    n_slots: int) -> np.ndarray:
    """Greedy tokens of one request through ``Model.prefill`` (one row at the
    prompt's length, as the engine admits it) and ``Model.decode_step`` over
    ``n_slots`` rows that all hold the request, with the engine's per-slot
    ``pos`` and ``active``: the shapes of the engine's tick, so the row of
    each product is computed as in the engine (a product's kernel, and with
    it its summation order, may depend on its row count)."""
    p = torch.from_numpy(prompt.astype(np.int64))[None].cuda()
    logits, cache = model.prefill({"tokens": p}, cache_len)
    cache = slot_cache(cache, n_slots)
    active = torch.ones(n_slots, dtype=torch.bool, device="cuda")
    toks = [int(torch.argmax(logits[0]))]
    for _ in range(n - 1):
        tok = torch.full((n_slots, 1), toks[-1], dtype=torch.int64, device="cuda")
        logits, cache = model.decode_step(cache, {"token": tok, "active": active})
        toks.append(int(torch.argmax(logits[0])))
    return np.asarray(toks, np.int32)


def on_card(extras: dict | None, rows: int = 1) -> dict:
    """A request's extras as a prefill batch takes them: each on the card,
    repeated over ``rows`` rows ({} for None)."""
    return {k: torch.from_numpy(np.repeat(v[None], rows, 0)).cuda()
            for k, v in (extras or {}).items()}


def greedy_paged(model, prompt: np.ndarray, extras: dict | None, n: int, n_slots: int,
                 cache_len: int, block_size: int) -> np.ndarray:
    """Greedy tokens of one request through the model alone, at the shapes a
    ``ServeEngine(n_slots=, cache_len=, block_size=)`` gives it, built here
    without the engine's code: ``Model.prefill`` of the prompt right-padded
    to its bucket (the smallest power of two from max(4, block_size) that
    holds it, else ``cache_len``; ``lens``), its K/V reshaped into blocks
    and written into the highest-numbered blocks of a fresh
    ``Model.paged_cache_specs`` pool (the engine takes the lowest), then
    ``Model.decode_step`` over ``n_slots`` rows with the request alone
    active in slot 0, its block table grown a block (the next lower id) as
    its position crosses one, and (encdec) the prefill's memory in slot 0's
    row of an fp32 memory.  A vlm request's ``num_patches`` patch positions
    come before its prompt's: the prefill's cache length, the blocks it
    keeps, the pool's blocks a slot and the positions count them.  Every
    row of a tick's products is then computed as in the engine's ticks.
    Only a flat cache of "k"/"v" leaves (no int8 scales, no nested stacks)
    is placed here."""
    from repro_torch.models.common import init_params

    L, bs = len(prompt), block_size
    P = model.cfg.num_patches if model.cfg.family == "vlm" else 0
    bucket = max(4, bs)
    while bucket < L and bucket < cache_len:
        bucket *= 2
    bucket = min(bucket, cache_len)
    clen = -(-(bucket + P) // bs) * bs
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :L] = prompt
    logits, small = model.prefill({"tokens": torch.from_numpy(toks).cuda(), **on_card(extras)},
                                  clen, lens=torch.tensor([L], dtype=torch.int32, device="cuda"))
    max_blocks = (cache_len + P) // bs + 1
    n_blocks = 1 + n_slots * max_blocks
    pool = init_params(model.paged_cache_specs(n_slots, n_blocks, bs), None, model.device,
                       model.compute_dtype)
    if set(small["layers"]) != {"k", "v"}:
        raise ValueError(f"greedy_paged places k/v leaves only, not {sorted(small['layers'])}")
    n_keep = (L + P) // bs + 1
    blocks = list(range(n_blocks - 1, n_blocks - 1 - n_keep, -1))
    nb = min(n_keep, clen // bs)
    for name, leaf in small["layers"].items():             # (layers, 1, clen, H, hd)
        kv = leaf[:, 0].reshape(leaf.shape[0], clen // bs, bs, *leaf.shape[3:])
        pool["layers"][name][:, blocks[:nb]] = kv[:, :nb].to(pool["layers"][name].dtype)
    pool["pos"][0] = L + P
    bt = np.zeros((n_slots, max_blocks), np.int32)
    bt[0, :n_keep] = blocks
    fed = {}
    if "memory" in small:
        memory = torch.zeros((n_slots, *small["memory"].shape[1:]), dtype=torch.float32,
                             device="cuda")
        memory[0] = small["memory"][0]
        fed["memory"] = memory
    active = torch.zeros(n_slots, dtype=torch.bool, device="cuda")
    active[0] = True
    toks_out, pos = [int(torch.argmax(logits[0]))], L + P
    for _ in range(n - 1):
        if pos // bs >= len(blocks):
            blocks.append(blocks[-1] - 1)
            bt[0, len(blocks) - 1] = blocks[-1]
        tok = torch.zeros((n_slots, 1), dtype=torch.int64, device="cuda")
        tok[0, 0] = toks_out[-1]
        logits, pool = model.decode_step(pool, {"token": tok, "active": active,
                                                "block_table": torch.from_numpy(bt).cuda(),
                                                **fed})
        toks_out.append(int(torch.argmax(logits[0])))
        pos += 1
    return np.asarray(toks_out, np.int32)


def serve_config(arch: str):
    """The arch at full width with its serving depth (all layers for the dense
    family)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=SERVE_LAYERS.get(arch, cfg.n_layers))


@contextlib.contextmanager
def capture_moe():
    """Record, for each ``moe_block`` call, the experts its router chose and
    whether each assignment kept a slot (each (G, g, k)), and the (x, mask)
    it handed ``ops.grouped_mlp``."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe

    route, grouped = moe._route, ops.grouped_mlp
    seen: dict[str, list] = {"experts": [], "keep": [], "grouped": []}

    def route_rec(gates, top_k, capacity):
        out = route(gates, top_k, capacity)
        seen["experts"].append(torch.stack([a[0] for a in out[0]], -1))
        seen["keep"].append(torch.stack([a[2] for a in out[0]], -1))
        return out

    def grouped_rec(x, w1, w3, w2, mask, act="swiglu"):
        seen["grouped"].append((x, mask))
        return grouped(x, w1, w3, w2, mask, act)

    moe._route, ops.grouped_mlp = route_rec, grouped_rec
    try:
        yield seen
    finally:
        moe._route, ops.grouped_mlp = route, grouped


def phase_serve(card: str, arch: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.compute import ComputePolicy
    from repro_torch.kernels import ops
    from repro_torch.launch.train import draw_extras
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve_engine import Request, ServeEngine
    from repro_torch.runtime.serve_loop import greedy_generate

    # a reduced model in fp32: kernels=True against kernels=False, tightly
    red = Model(get_config(arch).reduced(**REDUCED[arch]), torch.float32,
                compute=ComputePolicy(kernels=True), device="cuda")
    red.init(torch.Generator(device="cuda").manual_seed(1))
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, 512, (2, 40))).cuda()
    rx = on_card(draw_extras(red.cfg, np.random.RandomState(2)), rows=2)
    lk, _ = red.prefill({"tokens": toks, **rx}, 64)
    gk = greedy_generate(red, toks, 8, 64, extras=rx)
    red.compute = ComputePolicy(kernels=False)
    lp, _ = red.prefill({"tokens": toks, **rx}, 64)
    gp = greedy_generate(red, toks, 8, 64, extras=rx)
    check_close(f"{arch} reduced fp32 prefill logits, kernels on vs off", lk, lp,
                rtol=1e-4, atol=1e-4,
                why="fp32 through 2 layers; the kernels only change summation order")
    if not torch.equal(gk, gp):
        raise AssertionError(f"reduced fp32 greedy tokens differ: {gk} vs {gp}")
    del red

    cfg = serve_config(arch)
    cache_len = SERVE_CACHE_LEN.get(arch, 512)
    moe_layers = cfg.n_layers // cfg.moe_every if cfg.family == "moe" else 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, torch.bfloat16, compute=ComputePolicy(kernels=True), device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9

    rng = np.random.RandomState(0)
    lens = SERVE_PROMPT_LENS.get(arch, rng.randint(64, 257, 8))
    prompts = [rng.randint(0, cfg.vocab_size, int(n)).astype(np.int32) for n in lens]
    extras = [draw_extras(cfg, rng) for _ in prompts]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=32, extras=x)
            for i, (p, x) in enumerate(zip(prompts, extras))]
    engine = ServeEngine(model, n_slots=4, cache_len=cache_len, block_size=16)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: ops.launch_counts()[k] for k in SERVE_KERNELS[arch]}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched on the serve path: {launches}")
    grouped_expected = (engine.n_prefills + engine.n_ticks) * moe_layers
    if moe_layers and launches["grouped_mlp"] != grouped_expected:
        raise AssertionError(f"grouped_mlp launched {launches['grouped_mlp']} times, "
                             f"expected (prefills + ticks) x MoE layers = {grouped_expected}")
    if sorted(out) != list(range(8)) or any(len(t) != 32 for t in out.values()):
        raise AssertionError("engine did not return 32 tokens for each of 8 requests")
    hybrid_res = {}
    if cfg.family in RECURRENT:
        if cfg.family == "hybrid":
            # exact launch counts: the scan once per mamba layer and prefill,
            # the decode step once per mamba layer and tick, flash once per
            # shared application and prefill (every prompt has more than one
            # token)
            n_super = cfg.n_layers // cfg.hybrid_attn_every
            expected = {"ssd_scan": engine.n_prefills * cfg.n_layers,
                        "mamba_decode_step": engine.n_ticks * cfg.n_layers,
                        "flash_attention": engine.n_prefills * n_super}
        else:
            # rwkv: the scan once per layer and prefill of 8 tokens or more,
            # the decode step once per layer and tick and once per layer and
            # token of a shorter prompt; rmsnorm (time-mix's norm and the
            # final norm) once per layer and forward, plus one
            short = [len(p) for p in prompts if len(p) < 8]
            forwards = engine.n_prefills + engine.n_ticks
            expected = {"wkv_scan": (engine.n_prefills - len(short)) * cfg.n_layers,
                        "wkv_decode_step": (engine.n_ticks + sum(short)) * cfg.n_layers,
                        "rmsnorm": forwards * (cfg.n_layers + 1)}
        got = {k: launches[k] for k in expected}
        if got != expected:
            raise AssertionError(f"{arch} serve launches {got}, expected {expected}")
        # exact-length prefill makes every request's stream comparable with
        # greedy decoding at the engine's shapes, token for token
        same = [bool(np.array_equal(greedy_at_slots(model, p, 32, cache_len, 4), out[i]))
                for i, p in enumerate(prompts)]
        hybrid_res = {"expected_launches": expected, "prompt_lens": [len(p) for p in prompts],
                      "engine_equals_greedy_by_request": same}
        if not all(same):
            raise AssertionError(f"{arch}: engine tokens differ from greedy for requests "
                                 f"{[i for i, ok in enumerate(same) if not ok]}")
    if cfg.family in ("encdec", "vlm"):
        # exact launch counts: an encdec prefill runs the encoder (2 norms,
        # a flash attention and an MLP a layer, its final norm) and the
        # decoder (3 norms, 2 flash attentions and an MLP a layer) and the
        # final norm; a tick the decoder's norms and MLPs (one-token
        # attention is plain) and the final norm.  A vlm prefill runs 2
        # norms, a flash attention and an MLP a layer and the final norm
        # over the patch and prompt positions, a tick the same but flash.
        e, n = cfg.enc_layers, cfg.n_layers
        pf, tk = engine.n_prefills, engine.n_ticks
        expected = ({"flash_attention": pf * (e + 2 * n),
                     "layernorm": pf * (2 * e + 3 * n + 2) + tk * (3 * n + 1),
                     "gelu_mlp": pf * (e + n) + tk * n} if cfg.family == "encdec" else
                    {"rmsnorm": (pf + tk) * (2 * n + 1), "swiglu": (pf + tk) * n,
                     "flash_attention": pf * n})
        if launches != expected:
            raise AssertionError(f"{arch} serve launches {launches}, expected {expected}")
        # greedy decoding at the engine's buckets and shapes, token for token
        same = [bool(np.array_equal(greedy_paged(model, p, x, 32, engine.n_slots,
                                                 engine.cache_len, engine.block_size), out[i]))
                for i, (p, x) in enumerate(zip(prompts, extras))]
        hybrid_res = {"expected_launches": expected, "prompt_lens": [len(p) for p in prompts],
                      "engine_equals_greedy_by_request": same}
        if not all(same):
            raise AssertionError(f"{arch}: engine tokens differ from greedy for requests "
                                 f"{[i for i, ok in enumerate(same) if not ok]}")

    # request 0 against kernels=False on the card: last-token prefill logits
    # and the greedy stream; for the moe family the router's choices of both
    # runs and the grouped kernel's own inputs
    p0 = torch.from_numpy(prompts[0].astype(np.int64))[None].cuda()
    x0 = on_card(extras[0])
    with capture_moe() as on:
        lk, _ = model.prefill({"tokens": p0, **x0}, cache_len)
    model.compute = ComputePolicy(kernels=False)
    with capture_moe() as off:
        lp, _ = model.prefill({"tokens": p0, **x0}, cache_len)
    # a vlm request's patch positions come before its prompt's in the cache
    gp = greedy_generate(model, p0, 32, cache_len + model.patch_offset,
                         extras=x0)[0].cpu().numpy()
    model.compute = ComputePolicy(kernels=True)
    moe_res = {}
    if moe_layers:
        route_agree = [float((a == b).float().mean())
                       for a, b in zip(on["experts"], off["experts"])]
        # the last token's logits see its own routing in the last MoE layer
        last_same = [bool(torch.equal(a[:, -1], b[:, -1]) and torch.equal(ka[:, -1], kb[:, -1]))
                     for a, b, ka, kb in zip(on["experts"], off["experts"], on["keep"],
                                             off["keep"])]
        x0, m0 = on["grouped"][-1]                    # the last MoE layer's
        lp_moe = model.params()["layers"]["moe"]
        w3 = lp_moe["w3"][-1] if cfg.act == "swiglu" else None
        err = check_grouped(f"grouped {arch} on request 0's prefill (E {x0.shape[0]}, "
                            f"N {x0.shape[1]}, d {x0.shape[2]})", x0, lp_moe["w1"][-1], w3,
                            lp_moe["w2"][-1], m0, cfg.act)
        moe_res = {"moe_layers": moe_layers, "experts": cfg.n_experts, "top_k": cfg.top_k,
                   "grouped_expected": grouped_expected,
                   "routing_agree_request0_by_moe_layer": route_agree,
                   "last_token_routing_same_by_moe_layer": last_same,
                   "grouped_request0_N": int(x0.shape[1]),
                   "grouped_request0_valid_slots": int(m0.ne(0).sum()),
                   "grouped_request0_max_abs_err": err}
    rel = max_err(lk, lp) / float(lp.abs().max())
    if cfg.family in RECURRENT:
        hybrid_res.update(recurrent_fp32_on_vs_off(model, p0, lk, lp))
    agree = float(np.mean(gp == out[0]))
    first_diverge = int(np.argmax(gp != out[0])) if agree < 1 else 32
    recs = engine.records
    ttft = [r["t_first_token"] - r["t_arrival"] for r in recs]
    window_res = {}
    if cfg.sliding_window is not None:
        # every slot a ring of the window; prompts past it wrap their ring at
        # prefill, and every request's decode wraps it further
        ring = engine.cache["layers"]["k"].shape[2]
        window_res = {"window": cfg.sliding_window, "ring_positions": ring,
                      "prompts_past_window": sum(len(p) > cfg.sliding_window
                                                 for p in prompts)}
        if ring != cfg.sliding_window or not window_res["prompts_past_window"]:
            raise AssertionError(f"{arch}: ring of {ring} positions, prompts {lens}")
    int8_res, paths = {}, {f"{arch} serve": launches}
    if arch == KV_QUANT_ARCH:
        int8_res, paths[f"{arch} serve int8"] = phase_serve_int8(model, engine, reqs, out)
    res = {"phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
           "params": model.n_params(),
           "dtype": "bf16", "kernels": True, "n_slots": 4, "cache_len": cache_len,
           "block_size": 16, "requests": len(recs),
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "generated_tokens": int(sum(len(t) for t in out.values())),
           "init_s": t_init, "wall_s": wall, "ticks": engine.n_ticks,
           "ttft_first_s": float(min(ttft)), "ttft_p50_s": float(np.median(ttft)),
           "prefill_tok_s": engine.n_prefill_tokens / engine.prefill_s,
           "decode_tok_s": engine.n_decode_tokens / engine.decode_s,
           "launches": launches,
           "logits_vs_plain_max_abs_err": max_err(lk, lp),
           "logits_vs_plain_rel_err": rel,
           "logits_rel_tol": None if arch in LOGITS_NOT_HELD else LOGITS_REL_TOL,
           "logits_tol_why": LOGITS_TOL_WHY[arch],
           "greedy_agree_vs_plain": agree, "greedy_first_divergence": first_diverge,
           **moe_res, **hybrid_res, **window_res, **int8_res,
           "init_peak_mem_gb": init_peak,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    emit(res)
    if not torch.isfinite(lk).all() or (rel > LOGITS_REL_TOL and arch not in LOGITS_NOT_HELD):
        raise AssertionError(f"{arch} logits kernels on vs off: rel err {rel}")
    if hybrid_res.get("failed"):
        raise AssertionError(f"{arch} fp32 copy, kernels on vs off: {hybrid_res['failed']}")
    if int8_res.get("int8_failed"):
        raise AssertionError(f"{arch} int8 KV cache: {int8_res['int8_failed']}")
    phase_profile(model, prompts, card, cache_len, extras)
    return paths


# the int8 KV cache's serve run: KV_QUANT_ARCH at full width and depth on
# the paged pool with kv_quant=True, the weights and requests of its bf16
# run; its first KV_QUANT_TICKS decode ticks' logits held to the bf16
# pool's at the reference's bar (tests/test_kv_quant.py: rtol 0.08, atol
# 0.15)
KV_QUANT_ARCH = "yi-6b"
KV_QUANT_TOL = dict(rtol=0.08, atol=0.15)
KV_QUANT_TICKS = 4


def pool_bytes(cache: dict) -> int:
    """The bytes of an engine cache's KV leaves (``pos`` aside)."""
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    walk(cache["layers"])
    return sum(t.numel() * t.element_size() for t in leaves)


def decode_tick_logits(model, prompt: np.ndarray, tokens) -> list[torch.Tensor]:
    """The fp32 logits of ``prompt``'s first ``len(tokens)`` decode ticks
    through a fresh engine (4 slots, the paged pool of 512 positions, the
    request alone), tick k fed ``tokens[k]`` whatever the engine sampled,
    so that two models' ticks read the same stream."""
    from repro_torch.runtime.serve_engine import Request, ServeEngine

    eng = ServeEngine(model, n_slots=4, cache_len=512, block_size=16)
    seen, decode = [], eng._decode

    def rec(cache, batch):
        batch["token"][0, 0] = int(tokens[len(seen)])
        logits, cache = decode(cache, batch)
        seen.append(logits[0].float().clone())
        return logits, cache
    eng._decode = rec
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=len(tokens) + 1))
    for _ in tokens:
        eng.step()
    return seen


def phase_serve_int8(model, engine, reqs: list, out: dict) -> tuple[dict, dict]:
    """The int8 KV cache on ``model``'s weights (a view with kv_quant=True):
    request 0's first KV_QUANT_TICKS decode ticks' logits (both fed the bf16
    run's greedy tokens) against the bf16 pool's at KV_QUANT_TOL (prefill
    attends over the fresh full-precision K/V and quantizes them only into
    the cache, so its logits are the bf16 run's: the decode ticks are the
    int8 path), the pool's bytes against the bf16
    ``engine``'s ((hd + 4) / (2 hd) of it: int8 values and an fp32 scale a
    head and position), and, a reading, the share of greedy tokens that
    equal the bf16 run's ``out``.  Returns (readings, with "int8_failed"
    naming the checks that did not hold; the run's launches)."""
    import copy

    from repro_torch.kernels import ops
    from repro_torch.runtime.serve_engine import ServeEngine

    mq = copy.copy(model)                    # the same Parameters
    mq.cfg = dataclasses.replace(model.cfg, kv_quant=True)
    p0, fed = reqs[0].prompt, out[0][:KV_QUANT_TICKS]
    db = torch.stack(decode_tick_logits(model, p0, fed))
    dq = torch.stack(decode_tick_logits(mq, p0, fed))
    tol = KV_QUANT_TOL

    def excess(a, b):                        # max of |a - b| - (atol + rtol |b|)
        return float(((a - b).abs() - tol["atol"] - tol["rtol"] * b.abs()).max())
    eng = ServeEngine(mq, n_slots=4, cache_len=512, block_size=16)
    ops.reset_launch_counts()
    outq = eng.run(reqs)
    torch.cuda.synchronize()
    launches = {k: ops.launch_counts()[k] for k in SERVE_KERNELS[KV_QUANT_ARCH]}
    hd = model.cfg.resolved_head_dim
    ratio = pool_bytes(eng.cache) / pool_bytes(engine.cache)
    agree = [float(np.mean(outq[i] == out[i])) for i in sorted(out)]
    res = {"int8_pool_bytes": pool_bytes(eng.cache), "bf16_pool_bytes": pool_bytes(engine.cache),
           "int8_pool_ratio": ratio, "int8_pool_ratio_expected": (hd + 4) / (2 * hd),
           "int8_decode_ticks": len(fed),
           "int8_decode_logits_max_abs_diff_by_tick": [max_err(q, b) for q, b in zip(dq, db)],
           "int8_decode_logits_max_abs_diff": max_err(dq, db),
           "int8_decode_logits_excess_over_bar": excess(dq, db),
           "int8_decode_logits_rel_range": max_err(dq, db) / float(db.abs().max()),
           "int8_tol": tol, "int8_greedy_agree_by_request": agree,
           "int8_greedy_agree": float(np.mean(agree)),
           "int8_decode_tok_s": eng.n_decode_tokens / eng.decode_s,
           "int8_launches": launches}
    res["int8_failed"] = [name for name, bad in (
        ("decode logits", excess(dq, db) > 0), ("ticks", len(fed) != KV_QUANT_TICKS),
        ("pool bytes", ratio != res["int8_pool_ratio_expected"]),
        ("not finite", not torch.isfinite(dq).all()),
        ("launches", min(launches.values()) == 0),
        ("tokens", sorted(outq) != sorted(out))) if bad]
    return res, launches


# ---------------------------------------------------------------------------
# phase 3b: where the time goes (torch.profiler over prefill and decode)
# ---------------------------------------------------------------------------

# device-time groups of the profile, by kernel name (first match wins)
PROFILE_GROUPS = (
    ("grouped_mlp kernels", ("grouped_",)),
    ("ssd_scan kernel", ("ssd_scan_",)),
    ("mamba_decode kernel", ("mamba_decode_kernel",)),
    ("wkv_scan kernel", ("wkv_scan_",)),
    ("wkv_decode kernel", ("wkv_decode_kernel",)),
    ("rmsnorm kernel", ("rmsnorm_kernel",)),
    ("layernorm kernel", ("layernorm_kernel",)),
    ("swiglu kernel", ("swiglu_",)),
    ("gelu_mlp kernel", ("gelu_mlp_",)),
    ("flash fwd kernel", ("flash_fwd_",)),
    ("flash bwd kernels", ("flash_bwd_",)),
    ("ce kernels", ("ce_partial_", "ce_merge_")),
    # the moe family's dispatch and combine (torch.gather and its backward)
    ("gather / scatter", ("scatter_gather", "index_elementwise")),
    ("fp32 GEMMs", ("f32f32_f32f32", "sgemm")),
    ("other GEMMs", ("gemm", "nvjet", "cutlass")),
)
PORTED = {"rmsnorm kernel", "layernorm kernel", "swiglu kernel", "gelu_mlp kernel",
          "flash fwd kernel", "flash bwd kernels", "ce kernels", "grouped_mlp kernels",
          "ssd_scan kernel", "mamba_decode kernel", "wkv_scan kernel", "wkv_decode kernel"}


def _profile(fn) -> dict:
    """Wall time of ``fn`` (synchronized), the device time summed over the
    kernels the profiler saw, the device's idle share, the ported kernels'
    share, the device time by group and the top kernels by device time.
    Only the device is traced: the host's op events are not read, and with
    them one rwkv6 train step (463k launches) took 248 s to parse, against
    61 s without (NVIDIA H100 80GB HBM3, 700 W), for the same device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    if not by_name:
        return {"wall_s": wall, "device_busy_s": "not measured",
                "device_idle_share": "not measured"}
    busy = sum(ms for ms, _ in by_name.values()) / 1e3
    groups: dict[str, float] = {}
    for name, (ms, _) in by_name.items():
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)),
                     "elementwise and other")
        groups[group] = groups.get(group, 0.0) + ms
    ported = sum(ms for g, ms in groups.items() if g in PORTED)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1 - busy / wall,
            "device_kernels": sum(n for _, n in by_name.values()),
            "ported_kernels_share_of_busy": ported / 1e3 / busy,
            "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": name[:70], "device_ms": ms, "calls": n}
                            for name, (ms, n) in top]}


def phase_profile(model, prompts, card: str, cache_len: int = 512,
                  extras: list | None = None) -> None:
    from repro_torch.runtime.serve_engine import Request, ServeEngine

    extras = extras or [None] * len(prompts)
    p = torch.from_numpy(prompts[0][:64].astype(np.int64))[None].cuda()
    p = torch.cat([p] * 4, dim=1)                      # one 256-token prompt
    prefill = _profile(lambda: model.prefill({"tokens": p, **on_card(extras[0])},
                                             256 + model.patch_offset))
    odd = {}
    if model.cfg.family in RECURRENT:                  # an odd prompt scans at chunk 1
        odd = _profile(lambda: model.prefill({"tokens": p[:, :255]}, 256))
        scan = "ssd_scan kernel" if model.cfg.family == "hybrid" else "wkv_scan kernel"
        if isinstance(odd["device_busy_s"], float):
            scan_ms = odd["device_ms_by_group"].get(scan, 0.0)
            odd["scan_device_ms"] = scan_ms
            odd["scan_share_of_busy"] = scan_ms / 1e3 / odd["device_busy_s"]
        odd = {"prefill_255_tokens": odd}
    engine = ServeEngine(model, n_slots=4, cache_len=cache_len, block_size=16)
    for i in range(4):
        engine.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=16, extras=extras[i]))
    engine.step()                                      # 4 prefills + 1 tick
    ticks = 8

    def decode():
        for _ in range(ticks):
            engine.step()
    dec = _profile(decode)
    emit({"phase": "profile", "arch": model.cfg.name, "dtype": "bf16", "kernels": True,
          "prefill_256_tokens": prefill, **odd, "decode_ticks": ticks, "n_slots": 4,
          "decode": dec, "decode_ms_per_tick": dec["wall_s"] / ticks * 1e3,
          "decode_device_ms_per_tick": (dec["device_busy_s"] * 1e3 / ticks
                                        if "device_kernels" in dec else "not measured"),
          "device_kernels_per_tick": dec.get("device_kernels", 0) / ticks or "not measured",
          "card": card})


# ---------------------------------------------------------------------------
# phase 4: the training step of yi-6b at full width
# ---------------------------------------------------------------------------

# fp32 reduced model, kernels on vs off: the kernels change only summation
# order, and AdamW's normalisation carries that into the weights; over 5
# steps the CPU tests see ~5e-7.
TRAIN_FP32_RTOL = 1e-4
# bf16, step 0 kernels on vs off, relative limits on loss and grad_norm per
# arch, set from the readings of tools/step0_limits.py (3 weight seeds, each
# with its own batch; one 64-row tile of a kernel's output zeroed).
# yi-6b (8 layers; NVIDIA H100 80GB HBM3, 700 W): sound runs differ by at
# most 1.27e-5 in loss and 6.65e-4 in grad_norm (seed 0, the one run here,
# is the largest); the limits are about 1.5x those.  A zeroed tile moves
# grad_norm by 8.9e-3 (swiglu forward) and 1.4e-3 (dK/dV), which fail here;
# in the flash forward or dQ by 7.1e-4 and 6.7e-4, inside the sound spread,
# and the loss by less than the spread for every fault: phase 2 holds those
# kernels at the step's shapes.
# gpt-1.4b (all 24 layers; the same card): sound runs differ by at most
# 1.31e-5 in loss (seed 2; seed 0 9.0e-6) and 6.71e-4 in grad_norm (seed 0);
# the limits, 1.5x those, come out as yi-6b's.  A zeroed tile moves the loss
# by 3.1e-4 (layernorm forward), 4.0e-5 (gelu_mlp forward) and 3.7e-5 (flash
# forward), and grad_norm by 4.3e-3 and 3.4e-3 (layernorm, gelu_mlp), which
# fail here; in dQ and dK/dV it moves neither out of the sound spread
# (grad_norm 6.7e-4 and 3.9e-4): phase 2 holds those at the step's shapes.
# zamba2 (all 54 layers; the same card): bf16 at this random init drifts
# far from fp32 over the depth (tools/depth_drift.py), so sound runs differ
# by up to 1.85e-4 in loss and 7.10e-2 in grad_norm (seed 1; seeds 0 and 2:
# 2.9e-5 and 9.9e-5, 1.9e-2 and 4.0e-2); the limits are about 1.5x those.  A zeroed
# tile of the SSD scan's output moves grad_norm by 2.7e6 (the gated norm of
# a zeroed row), which fails; every other planted fault stays inside the
# sound spread (loss at most 6.6e-5, grad_norm at most 2.2e-2): phase 2
# holds those kernels at the step's shapes, and phase 3 the whole model in
# fp32 at full depth.  These readings are at all 54 layers; the train phase
# runs zamba2 at 18 (TRAIN_LAYERS), where the depth grows bf16's roundings
# less, so the limits hold a sound step with more room.
# rwkv6 (all 24 layers; the same card): sound runs differ by at most
# 5.17e-5 in loss and 2.20e-3 in grad_norm (seed 1; seeds 0 and 2: 4.7e-5
# and 9.0e-6, 1.2e-3 and 9.8e-4); the limits are about 1.5x those.  A zeroed
# tile of the rmsnorm kernel's output moves the loss by 3.0e-4 and
# grad_norm by 8.6e-2, which fail; one of the wkv scan's output makes
# grad_norm non-finite (the finite check fails it) and moves the loss by
# 3.8e-5, inside the spread: phase 2e holds that kernel at the step's shape.
# arctic (2 layers, 8 of 128 experts; the same card): sound runs differ by
# at most 4.85e-5 in loss and 6.33e-4 in grad_norm (seed 1; seeds 0 and 2:
# 2.7e-5 and 3.3e-5, 6.1e-4 and 4.3e-4), with 0.99988 of microbatch 0's
# routing choices the same kernels on and off; the limits are about 1.5x
# those.  A zeroed tile of the grouped MLP's output (rows 1024:1088 of
# expert 0) moves the loss by 9.9e-5 and grad_norm by 1.6e-3, the swiglu
# forward's by 1.2e-4 and 9.9e-3, which fail; the flash faults stay inside
# the sound spread (phase 2 holds those kernels at the step's shapes).
# seamless-m4t-medium (12 + 12 layers; the same card): sound runs differ by
# at most 4.45e-6 in loss and 1.064e-3 in grad_norm (seed 2 for the loss,
# seed 1 for grad_norm; seed 0 2.9e-6 and 1.056e-3); the limits are about
# 1.5x those.  A zeroed tile moves the loss by 6.5e-5 (gelu_mlp forward),
# 1.6e-4 (layernorm forward) and 2.5e-5 (flash forward), and grad_norm by
# 7.5e-3 and 2.1e-3 (gelu_mlp, layernorm), which fail; in dQ and dK/dV it
# moves neither out of the sound spread (phase 2 holds those, the encdec
# shapes in ``phase_kernels_encdec``).
# internvl2-2b (all 24 layers, 256 patches a row; the same card): sound runs
# differ by at most 1.43e-5 in loss and 8.42e-4 in grad_norm (seed 2; seeds 0
# and 1: 9.5e-6 and 1.1e-5, 7.1e-4 and 8.2e-4); the limits are about 1.5x
# those.  A zeroed tile moves grad_norm by 0.116 (swiglu forward), the loss
# by 3.2e-4 (rmsnorm forward), 7.8e-3 (CE's lse on 64 text rows) and 3.1e-5
# (flash forward), which fail; in dQ and dK/dV it moves neither out of the
# sound spread (phase 2 holds those, the vlm shapes in ``phase_kernels_vlm``).
STEP0_RTOL = {"yi-6b": {"loss": 2e-5, "grad_norm": 1e-3},
              "gpt-1.4b": {"loss": 2e-5, "grad_norm": 1e-3},
              ZAMBA: {"loss": 3e-4, "grad_norm": 0.11},
              RWKV: {"loss": 8e-5, "grad_norm": 3.3e-3},
              ARCTIC: {"loss": 7.5e-5, "grad_norm": 1e-3},
              SEAMLESS: {"loss": 7e-6, "grad_norm": 1.6e-3},
              INTERNVL: {"loss": 2.2e-5, "grad_norm": 1.3e-3}}
TRAIN = dict(global_batch=8, gas=2, seq_len=2048, steps=5)
# gpt-1.4b, rwkv6, seamless and internvl2: all layers; zamba2: 18 of 54 (3
# of its 9 super units), cut so that the script keeps to its time (its
# 54-layer step took 11-16 s, the plain one 17-40 s; PERF.md)
TRAIN_LAYERS = {"yi-6b": 8, "gpt-1.4b": 24, ZAMBA: 18, RWKV: 24, ARCTIC: 2,
                SEAMLESS: 12, INTERNVL: 24}
# arctic trains at its published widths with 8 of its 128 experts: one layer
# with all 128 is 14.07e9 parameters, about 225 GB at 16 bytes a parameter
# (fp32 master, gradient, Adam's two moments); 2 layers of 8 experts are
# about 2.6e9, 41 GB
TRAIN_EXPERTS = {ARCTIC: 8}
TRAIN_LR = 1e-4
# kernels=False steps per arch (step 0 is the one compared; zamba2's plain
# steps take 17-40 s, so it runs only that one)
TRAIN_OFF_STEPS = {ZAMBA: 1, RWKV: 1}


def _batches(vocab: int, seq_len: int, global_batch: int, n: int, cfg=None) -> list:
    """``n`` synthetic global batches; ``cfg`` adds its family's dense inputs
    (the encdec family's frames, ``launch/train.py:extra_specs``)."""
    from repro_torch.data import SyntheticCorpus, make_batch_iterator
    from repro_torch.launch.train import extra_specs

    it = make_batch_iterator(SyntheticCorpus(vocab_size=vocab, seed=0),
                             seq_len=seq_len, global_batch=global_batch, prefetch=0,
                             extra_specs=None if cfg is None else extra_specs(cfg))
    return [next(it) for _ in range(n)]


def _run_steps(model, plan, batches, seed: int, mesh=None, tele=None) -> list[dict]:
    """Fresh train state from ``seed``, then one step per batch; per step its
    metrics and synchronized wall time.  With ``mesh``, ``model`` is the
    rank's sharded model (it draws every leaf whole from the same seed).
    With ``tele`` (a ``core/telemetry.py:Telemetry``) each step is also a
    telemetry record, of which ``telemetry`` keeps the MFU, the drift, the
    peak memory (since the caller's reset; every rank's, gathered, under a
    mesh), the collective bytes and, at pp > 1, the measured pipeline."""
    from repro_torch.launch.train import step_extras
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import collectives
    from repro_torch.runtime.train_loop import build_train_step, init_train_state

    opt = AdamWConfig(lr=TRAIN_LR)
    state = init_train_state(model, opt, plan,
                             torch.Generator(device=model.device).manual_seed(seed))
    step = build_train_step(model, opt, plan, mesh)
    world = 1 if mesh is None else mesh.size()
    out = []
    for i, b in enumerate(batches):
        collectives.reset_comm_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "step_s": time.perf_counter() - t0})
        if mesh is not None:        # the ZeRO gathers' bytes, by phase; the encoder's pipe
            # gather; the pipeline ring's sends
            out[-1]["zero3_gather"] = collectives.gather_phase_bytes()
            out[-1]["pipe_gather"] = collectives.comm_bytes()["pipe_gather"]
            out[-1]["send"] = collectives.comm_bytes()["send"]
        if model.cfg.family == "moe":
            out[-1].update(moe_aux=float(m["moe_aux"]), moe_drop=float(m["moe_drop"]),
                           all_to_all_bytes=collectives.comm_bytes()["all-to-all"])
        if tele is not None:
            rec = tele.step(i + 1, out[-1]["step_s"], m,
                            **step_extras(plan, model.device, world, mesh is not None))
            out[-1]["telemetry"] = {k: rec[k] for k in (
                "mfu", "tokens_per_s", "peak_bytes", "comm_bytes", "pipeline", "drift")
                if k in rec}
    del state
    return out


def train_config(arch: str):
    """The arch at full width with the train phase's depth (and expert
    count, TRAIN_EXPERTS)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), n_layers=TRAIN_LAYERS[arch])
    if arch in TRAIN_EXPERTS:
        cfg = dataclasses.replace(cfg, n_experts=TRAIN_EXPERTS[arch])
    return cfg


def expected_train_launches(cfg, steps: int, gas: int = TRAIN["gas"],
                            remat: str = "full") -> dict[str, int]:
    """Launches of each kernel in ``steps`` steps of TRAIN (at ``gas``
    microbatches) under remat full or selective:
    per layer and microbatch each forward kernel runs twice (the forward and
    its recompute: selective saves no kernel's output) and each backward
    kernel once; the final norm and the CE run once per microbatch.  Under
    remat none each forward kernel runs once.  For hybrid the attention layers are the shared
    block's applications, each mamba layer runs one norm and one SSD scan
    (whose backward is plain torch), and its gated norm is plain.  rwkv has
    no attention and no MLP kernel: each layer runs one kernel norm
    (time-mix's; channel-mix's and ln_x are plain) and one wkv scan (whose
    backward is plain torch).  The moe family's layers each run two norms,
    one flash attention and one swiglu (a dense layer's MLP, llama4's
    shared expert or arctic's dense residual), and each MoE unit one
    grouped expert MLP (forward and recompute; its backward is plain
    torch).  The encdec family's encoder layers each run two norms, one
    flash attention (non-causal) and one MLP, its decoder layers three
    norms (self-attention, cross-attention, MLP), two flash attentions
    (causal self, non-causal cross over the memory) and one MLP; the
    encoder's final norm runs once per microbatch, outside the remat
    wrapper, beside the decoder's."""
    norm = "rmsnorm" if cfg.norm == "rmsnorm" else "layernorm"
    fwd = 1 if remat == "none" else 2
    if cfg.family == "rwkv":
        per_mb = {norm: fwd * cfg.n_layers + 1, "wkv_scan": fwd * cfg.n_layers,
                  "cross_entropy": 1}
        return {k: n * gas * steps for k, n in per_mb.items()}
    mlp = "swiglu" if cfg.act == "swiglu" else "gelu_mlp"
    if cfg.family == "encdec":
        e, n = cfg.enc_layers, cfg.n_layers
        per_mb = {norm: fwd * (2 * e + 3 * n) + 2, mlp: fwd * (e + n),
                  "flash_attention": fwd * (e + 2 * n), "flash_attention_bwd_dq": e + 2 * n,
                  "flash_attention_bwd_dkv": e + 2 * n, "cross_entropy": 1}
        return {k: v * gas * steps for k, v in per_mb.items()}
    norms_per_layer = 2 + (2 if cfg.qk_norm else 0)
    hybrid = cfg.family == "hybrid"
    n_attn = cfg.n_layers // cfg.hybrid_attn_every if hybrid else cfg.n_layers
    n_mamba = cfg.n_layers if hybrid else 0
    per_mb = {norm: fwd * (norms_per_layer * n_attn + n_mamba) + 1, mlp: fwd * n_attn,
              "flash_attention": fwd * n_attn, "flash_attention_bwd_dq": n_attn,
              "flash_attention_bwd_dkv": n_attn, "cross_entropy": 1}
    if hybrid:
        per_mb["ssd_scan"] = fwd * n_mamba
    if cfg.family == "moe":
        per_mb["grouped_mlp"] = fwd * (cfg.n_layers // cfg.moe_every)
    return {k: n * gas * steps for k, n in per_mb.items()}


def routing_agreement(model, batch: dict) -> float:
    """The share of the moe family's routing choices (each token's top-k
    experts, every MoE layer) on the first microbatch of ``batch`` that
    kernels on and off agree on, in bf16 compute at the model's weights."""
    from repro_torch.core.compute import ComputePolicy

    rows = batch["tokens"].shape[0] // TRAIN["gas"]
    mb = {"tokens": torch.as_tensor(np.asarray(batch["tokens"][:rows])).cuda()}
    choices = {}
    for kernels in (True, False):
        view = model.with_policy(ComputePolicy("full", kernels), torch.bfloat16)
        with torch.no_grad(), capture_moe() as seen:
            view.loss(mb)
        choices[kernels] = seen["experts"]
    return float(np.mean([float((a == b).float().mean())
                          for a, b in zip(choices[True], choices[False])]))


def train_reduced(arch: str) -> None:
    """The arch reduced, in fp32 at its head dim: 5 steps kernels on vs
    off, loss and grad norm at TRAIN_FP32_RTOL."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.runtime.train_loop import ParallelPlan

    red_cfg = get_config(arch).reduced(**REDUCED[arch])
    red = Model(red_cfg, torch.float32, device="cuda")
    rb = _batches(red_cfg.vocab_size, 256, 4, 5, red_cfg)
    runs = {k: _run_steps(red, ParallelPlan(gas=2, precision="fp32", kernels=k), rb, 1)
            for k in (True, False)}
    for i, (a, b) in enumerate(zip(runs[True], runs[False])):
        for key in ("loss", "grad_norm"):
            rel = abs(a[key] - b[key]) / abs(b[key])
            if not np.isfinite(a[key]) or rel > TRAIN_FP32_RTOL:
                raise AssertionError(f"{arch} reduced fp32 train step {i} {key}: kernels "
                                     f"{a[key]} vs plain {b[key]} (rel {rel:.2e})")
    emit({"phase": "train_reduced_fp32", "arch": red_cfg.name,
          "head_dim": red_cfg.resolved_head_dim, "d_model": red_cfg.d_model,
          "steps": 5, "gas": 2, "seq_len": 256, "global_batch": 4,
          "kernels_on": runs[True], "kernels_off": runs[False],
          "rtol": TRAIN_FP32_RTOL})
    del red
    torch.cuda.empty_cache()


def phase_train(card: str, arch: str) -> dict:
    from repro_torch.core import costmodel, expertplan, telemetry
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_loop import (ParallelPlan, build_train_step,
                                                init_train_state)

    # the reduced model in fp32 at the arch's head dim: kernels on vs off,
    # tightly (with arctic, llama4-maverick's too: its reduced train step
    # reaches the moe lowering's dense sub-stack and shared expert)
    for name in (LLAMA4, arch) if arch == ARCTIC else (arch,):
        train_reduced(name)

    cfg = train_config(arch)
    gb, gas, S, steps = TRAIN["global_batch"], TRAIN["gas"], TRAIN["seq_len"], TRAIN["steps"]
    model = Model(cfg, torch.float32, device="cuda")
    batches = _batches(cfg.vocab_size, S, gb, steps, cfg)
    plan = ParallelPlan(gas=gas, precision="bf16", remat="full", kernels=True)
    # the drift is a reading here, not a limit: no warning
    tele = telemetry.Telemetry(cfg, plan, gb, S, machine="h100",
                               drift_threshold=float("inf"))
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    on = _run_steps(model, plan, batches, 0, tele=tele)
    launches = {k: ops.launch_counts()[k] for k in TRAIN_KERNELS[arch]}
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops = tele.flops.total
    for r in on:
        r["tokens_per_s"] = gb * S / r["step_s"]
        r["mfu"] = r["telemetry"]["mfu"]
    expected = expected_train_launches(cfg, steps)
    if launches != expected:
        raise AssertionError(f"{arch} train step launches {launches}, expected {expected}")
    if not all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in on):
        raise AssertionError(f"non-finite train metrics: {on}")
    opt = AdamWConfig(lr=TRAIN_LR)
    pstate = init_train_state(model, opt, plan)        # the weights as they are
    pstep = build_train_step(model, opt, plan)
    prof = _profile(lambda: pstep(pstate, batches[0]))
    del pstate
    torch.cuda.empty_cache()
    off = _run_steps(model, ParallelPlan(gas=gas, precision="bf16", remat="full",
                                         kernels=False),
                     batches[:TRAIN_OFF_STEPS.get(arch, steps)], 0)
    rel0 = {key: abs(on[0][key] - off[0][key]) / off[0][key] for key in ("loss", "grad_norm")}
    med = float(np.median([r["step_s"] for r in on[1:]]))
    res = {"phase": "train", "arch": cfg.name, "layers": cfg.n_layers,
           "params": model.n_params(), "precision": "bf16 compute, fp32 master",
           "remat": "full", "kernels": True, "global_batch": gb, "gas": gas,
           "seq_len": S, "steps": on, "median_step_s": med,
           "median_tokens_per_s": gb * S / med,
           "median_mfu": telemetry.mfu(flops, med, 1, costmodel.H100.peak_flops),
           "predicted_step_s": tele.prediction.step_time_s,
           "median_drift": med / tele.prediction.step_time_s,
           "flops_per_step": flops, "peak_mem_gb": peak, "launches": launches,
           "kernels_off_steps": off, "step0_loss_rel_diff": rel0["loss"],
           "step0_grad_norm_rel_diff": rel0["grad_norm"],
           "loss_rtol": STEP0_RTOL[arch]["loss"],
           "grad_norm_rtol": STEP0_RTOL[arch]["grad_norm"],
           "profile_one_step": prof, "card": card}
    if cfg.family == "moe":
        from repro_torch.models.moe import group_shape

        res.update(n_experts=cfg.n_experts, moe_aux=[r["moe_aux"] for r in on],
                   moe_drop=[r["moe_drop"] for r in on],
                   predicted_drop_fraction=expertplan.predicted_drop_fraction(
                       cfg.top_k, cfg.n_experts, cfg.capacity_factor,
                       group_shape(gb // gas, S)[1]),
                   routing_agreement_step0_microbatch0=routing_agreement(model, batches[0]))
    emit(res)
    if any(rel0[key] > STEP0_RTOL[arch][key] for key in rel0):
        raise AssertionError(f"{arch} step 0 kernels on vs off: {rel0}, limits "
                             f"{STEP0_RTOL[arch]}")
    TRAIN_STEP0[arch] = on[0]
    return launches


# phase 4's kernels-on step 0 of each arch (loss, grad_norm), which the
# multi-rank branch of phase 5 holds its yi-6b step 0 to
TRAIN_STEP0: dict = {}

# the cuBLAS bf16 GEMM whose rate over the bf16 peak is costmodel.H100's
# matmul_eff (the costmodel's big-GEMM efficiency)
GEMM_N = 8192


def phase_gemm(card: str) -> None:
    """One cuBLAS bf16 GEMM of GEMM_N^3 (torch.mm), 20 timed calls after 3
    warm ones (CUDA events): its median rate over the bf16 peak is the
    reading behind ``costmodel.H100.matmul_eff``."""
    from repro_torch.core import costmodel

    gen = torch.Generator(device="cuda").manual_seed(0)
    a, b = (torch.randn((GEMM_N, GEMM_N), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    for _ in range(3):
        torch.mm(a, b)
    times = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.mm(a, b)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    med = float(np.median(times))
    eff = 2.0 * GEMM_N ** 3 / med / PEAK_FLOPS[torch.bfloat16]
    emit({"phase": "gemm", "n": GEMM_N, "dtype": "bf16", "median_s": med,
          "min_s": min(times), "tflops": 2.0 * GEMM_N ** 3 / med / 1e12,
          "matmul_eff": eff, "costmodel_matmul_eff": costmodel.H100.matmul_eff,
          "card": card})


# phase "remat": the archs phase 4 trains at remat full, at remat selective
# and none, on phase 4's weights (seed 0) and first REMAT_STEPS batches;
# step 0 is held to phase 4's at PARALLEL_RTOL (the same arithmetic:
# selective keeps products the recompute would give bit for bit)
REMAT_ARCHS, REMAT_MODES, REMAT_STEPS = ("gpt-1.4b", "yi-6b"), ("selective", "none"), 3


def kept_for_backward(model, plan, batch: dict) -> dict:
    """One microbatch's loss and gradient through ``model`` under ``plan``'s
    compute policy: the bytes its forward leaves allocated for the backward
    (``kept_gb``) and the peak above the start over the forward and the
    backward (``peak_gb``).  The step's own peak is set by the optimizer's
    update and the CE, where no activation is alive, so it does not show
    what a remat mode keeps."""
    from repro_torch.core import precision as prec

    view = model.with_policy(plan.compute_policy(),
                             prec.policy_from_name(plan.precision).compute_dtype)
    tokens = torch.from_numpy(np.asarray(batch["tokens"])).to(model.device)
    micro = {"tokens": tokens[:tokens.shape[0] // plan.gas]}
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    loss, _ = view.loss(micro)
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - start
    loss.backward()
    torch.cuda.synchronize()
    out = {"kept_gb": kept / 1e9, "peak_gb": (torch.cuda.max_memory_allocated() - start) / 1e9}
    model.zero_grad(set_to_none=True)
    return out


def phase_remat(card: str, arch: str) -> dict:
    """Selective and no recompute on ``arch`` at TRAIN's batch, bf16 over
    fp32 masters, kernels on: step 0 against phase 4's remat-full step 0,
    every kernel's launches counted exactly (selective as full: it saves no
    kernel's output; none: each forward kernel once per microbatch), step
    time, peak memory and MFU from ``Telemetry`` records; and what each
    mode, full too, keeps for one microbatch's backward
    (:func:`kept_for_backward`), which must grow from full to selective to
    none."""
    from repro_torch.core import telemetry
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.runtime.train_loop import ParallelPlan

    cfg = train_config(arch)
    gb, gas, S = TRAIN["global_batch"], TRAIN["gas"], TRAIN["seq_len"]
    batches = _batches(cfg.vocab_size, S, gb, REMAT_STEPS)
    model = Model(cfg, torch.float32, device="cuda")
    model.init(torch.Generator(device=model.device).manual_seed(0))
    counts, failed = {}, []
    kept = {r: kept_for_backward(model, ParallelPlan(gas=gas, precision="bf16", remat=r,
                                                     kernels=True), batches[0])
            for r in ("full",) + REMAT_MODES}
    emit({"phase": "remat_kept", "arch": cfg.name, "layers": cfg.n_layers,
          "microbatch": [gb // gas, S], "kept": kept, "card": card})
    if not kept["full"]["kept_gb"] < kept["selective"]["kept_gb"] < kept["none"]["kept_gb"]:
        failed.append(f"bytes kept for the backward not full < selective < none: {kept}")
    for remat in REMAT_MODES:
        plan = ParallelPlan(gas=gas, precision="bf16", remat=remat, kernels=True)
        # the drift is a reading here, not a limit: no warning
        tele = telemetry.Telemetry(cfg, plan, gb, S, machine="h100",
                                   drift_threshold=float("inf"))
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        steps = _run_steps(model, plan, batches, 0, tele=tele)
        launches = {k: ops.launch_counts()[k] for k in TRAIN_KERNELS[arch]}
        counts[f"{arch} remat {remat}"] = launches
        expected = expected_train_launches(cfg, REMAT_STEPS, remat=remat)
        rel0 = _rel(steps[0], TRAIN_STEP0[arch])
        med = float(np.median([r["step_s"] for r in steps[1:]]))
        emit({"phase": "remat", "arch": cfg.name, "layers": cfg.n_layers, "remat": remat,
              "precision": "bf16 compute, fp32 master", "kernels": True,
              "global_batch": gb, "gas": gas, "seq_len": S, "steps": steps,
              "median_step_s": med,
              "median_mfu": telemetry.mfu(tele.flops.total, med, 1, tele.machine.peak_flops),
              "median_drift": med / tele.prediction.step_time_s,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "full_step0": TRAIN_STEP0[arch], "step0_rel_diff": rel0, "rtol": PARALLEL_RTOL,
              "launches": launches, "expected_launches": expected, "card": card})
        if launches != expected:
            failed.append(f"{remat} launches {launches}, expected {expected}")
        if not all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in steps) or any(
                v > PARALLEL_RTOL for v in rel0.values()):
            failed.append(f"{remat} step 0 vs remat full: {rel0}")
    del model
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{arch} phase remat: {failed}")
    return counts


# the train launcher on the card: its entry point with telemetry output
ENTRY_ARCH, ENTRY_STEPS = "gpt-1.4b", 2


def phase_entry(card: str) -> dict:
    """``launch/train.py``'s ``main`` on ENTRY_ARCH at full width and depth,
    TRAIN's batch, bf16, kernels, remat selective, for ENTRY_STEPS steps with
    ``--log-jsonl``: its file passes ``validate_jsonl`` and its launches are
    counted exactly."""
    from repro_torch.configs import get_config
    from repro_torch.core import telemetry
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher

    path = ROOT / "build" / "train_telemetry.jsonl"
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    ops.reset_launch_counts()
    recs = launcher.main(["--arch", ENTRY_ARCH, "--steps", str(ENTRY_STEPS),
                          "--global-batch", str(TRAIN["global_batch"]),
                          "--gas", str(TRAIN["gas"]), "--seq-len", str(TRAIN["seq_len"]),
                          "--precision", "bf16", "--kernels", "--remat", "selective",
                          "--log-every", "1", "--log-jsonl", str(path)])
    launches = {k: ops.launch_counts()[k] for k in TRAIN_KERNELS[ENTRY_ARCH]}
    records = telemetry.validate_jsonl(str(path))
    cfg = get_config(ENTRY_ARCH)
    expected = expected_train_launches(cfg, ENTRY_STEPS, remat="selective")
    steps = [r for r in records if r["kind"] == "step"]
    emit({"phase": "entry", "arch": ENTRY_ARCH, "argv": "--remat selective --kernels "
          "--precision bf16 --log-jsonl", "returned": recs,
          "records": [{k: r.get(k) for k in ("kind", "step", "wall_s", "mfu", "loss",
                                             "peak_bytes", "compile_s", "drift")}
                      for r in records],
          "launches": launches, "expected_launches": expected, "card": card})
    if (launches != expected or len(steps) != ENTRY_STEPS
            or not all(np.isfinite(r["loss"]) and r.get("peak_bytes") for r in steps)):
        raise AssertionError(f"train launcher on the card: launches {launches} "
                             f"(expected {expected}), step records {steps}")
    return launches
# phase 5's single-device gpt-1.4b step 0, which the multi-rank branch of
# phase 6 holds its pipelined gpt-1.4b step 0 to
PARALLEL_STEP0: dict = {}
# phase 5, one card: gpt-1.4b at full width and depth through the sharded
# executor over a one-rank nccl group, ZeRO 3 (every leaf stored as its
# block and gathered on use, over a data group of one), TRAIN's batch
PARALLEL_ARCH, PARALLEL_STEPS, PARALLEL_ZERO = "gpt-1.4b", 3, 3
# fp32 step 0 of the same arithmetic: the one-rank collectives copy, so
# equality is expected; 1e-5 relative is the reference's bar between plans
PARALLEL_RTOL = 1e-5
# the multi-rank branch's reduced yi-6b: tests/test_parallel_plan.py's with
# kernels off; with kernels on at head dim 64 (d 256), since the flash
# kernels take head dims 64, 80, 88 and 128 only
PARALLEL_REDUCED = {False: dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                                d_ff=256, vocab_size=256, head_dim=32),
                    True: dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                               d_ff=256, vocab_size=256, head_dim=64)}


def _process_group_file(tag: str) -> str:
    path = ROOT / "build" / f"process_group_{tag}"
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    return f"file://{path}"


def _sharded_steps(cfg, plan, batches, seed: int,
                   tele: bool = False) -> tuple[list[dict], float]:
    """The sharded executor over the default group's plan mesh from
    ``seed``: its per-step records (with ``tele``, telemetry records too:
    every rank's peak memory, at pp > 1 the measured idle share) and this rank's
    peak memory in GB."""
    from repro_torch.core import telemetry
    from repro_torch.launch.mesh import mesh_for_plan
    from repro_torch.runtime.train_loop import build_model

    device = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_for_plan(plan, device)
    model = build_model(cfg, plan, mesh)
    torch.cuda.reset_peak_memory_stats()
    gb, S = batches[0]["tokens"].shape
    rec = (telemetry.Telemetry(cfg, plan, gb, S, machine="h100", drift_threshold=float("inf"))
           if tele else None)
    out = _run_steps(model, plan, batches, seed, mesh, rec)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    return out, peak


def _rel(a: dict, b: dict) -> dict:
    return {k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm")}


def phase_parallel(card: str) -> dict:
    """PARALLEL_ARCH through the sharded executor on one card (the single-
    device step 0 first, on the same weights and batch), then, where the
    host has 2 or more cards, the multi-rank branch."""
    import torch.distributed as dist

    from repro_torch.core import costmodel, telemetry
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.models.model import Model
    from repro_torch.runtime.train_loop import ParallelPlan

    cfg = train_config(PARALLEL_ARCH)
    gb, S = TRAIN["global_batch"], TRAIN["seq_len"]
    batches = _batches(cfg.vocab_size, S, gb, PARALLEL_STEPS)
    kw = dict(gas=TRAIN["gas"], precision="bf16", remat="full", kernels=True)
    model = Model(cfg, torch.float32, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    single = _run_steps(model, ParallelPlan(**kw), batches[:1], 0)
    single_peak = torch.cuda.max_memory_allocated() / 1e9
    PARALLEL_STEP0.update(single[0])
    del model
    torch.cuda.empty_cache()

    init_distributed(torch.device("cuda"), _process_group_file("one_rank"), 0, 1)
    plan = ParallelPlan(zero=PARALLEL_ZERO, **kw)
    ops.reset_launch_counts()
    steps, peak = _sharded_steps(cfg, plan, batches, 0)
    launches = {k: ops.launch_counts()[k] for k in TRAIN_KERNELS[PARALLEL_ARCH]}
    paths = {f"{PARALLEL_ARCH} parallel": launches}
    paths.update(_comm_one_rank(card))
    paths.update(_serve_dp_one_rank(card))
    dist.destroy_process_group()
    flops = costmodel.train_step_flops(cfg, gb, S).total
    rel0 = _rel(steps[0], single[0])
    emit({"phase": "parallel", "arch": cfg.name, "layers": cfg.n_layers,
          "plan": {"dp": 1, "tp": 1, "zero": PARALLEL_ZERO, **kw}, "backend": "nccl",
          "ranks": 1, "global_batch": gb, "seq_len": S, "steps": steps,
          "median_step_s": float(np.median([r["step_s"] for r in steps[1:]])),
          "mfu_by_step": [telemetry.mfu(flops, r["step_s"], 1, costmodel.H100.peak_flops)
                          for r in steps],
          "peak_mem_gb": peak, "single_device_step0": single[0],
          "single_device_peak_mem_gb": single_peak, "step0_rel_diff": rel0,
          "rtol": PARALLEL_RTOL, "launches": launches, "card": card})
    if any(v > PARALLEL_RTOL for v in rel0.values()):
        raise AssertionError(f"sharded step 0 vs single device: {rel0}")
    expected = expected_train_launches(cfg, PARALLEL_STEPS)
    if launches != expected:
        raise AssertionError(f"sharded train launches {launches}, expected {expected}")
    world = min(torch.cuda.device_count(), 4)
    if world >= 2:
        import torch.multiprocessing as mp

        mp.spawn(_parallel_rank, args=(world, _process_group_file("ranks"),
                                       dict(TRAIN_STEP0)), nprocs=world)
    else:
        emit({"phase": "parallel_ranks", "ran": False,
              "why": f"{torch.cuda.device_count()} card: the multi-rank branch needs 2 or more"})
    return paths


# phase 5's dp serving over the same one-rank group: SERVE_DP_ARCH at full
# width and TRAIN_LAYERS depth, bf16, kernels on, 8 requests over 4 slots of
# the paged pool, meshless and then through ``ServeEngine(mesh=, plan=)``
# (plan dp 1, ZeRO 0): every slot on the one data rank, the tick's logits
# all-gathered and each prefill's broadcast over its group, on the same
# kernels at the same shapes, so the tokens must be equal
SERVE_DP_ARCH = "yi-6b"


def _serve_dp_one_rank(card: str) -> dict:
    from repro_torch.core.compute import ComputePolicy
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import mesh_for_plan
    from repro_torch.models.model import Model
    from repro_torch.runtime import collectives
    from repro_torch.runtime.serve_engine import Request, ServeEngine
    from repro_torch.runtime.train_loop import ParallelPlan

    cfg = train_config(SERVE_DP_ARCH)
    model = Model(cfg, torch.bfloat16, compute=ComputePolicy(kernels=True), device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(3)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, int(n)).astype(np.int32),
                    max_new_tokens=16) for i, n in enumerate(rng.randint(64, 257, 8))]
    kw = dict(n_slots=4, cache_len=512, block_size=16)
    single = ServeEngine(model, **kw).run(reqs)
    plan = ParallelPlan(dp=1, zero=0)
    device = torch.device("cuda", torch.cuda.current_device())
    engine = ServeEngine(model, **kw, mesh=mesh_for_plan(plan, device), plan=plan)
    ops.reset_launch_counts()
    collectives.reset_comm_bytes()
    t0 = time.perf_counter()
    out = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: ops.launch_counts()[k] for k in SERVE_KERNELS[SERVE_DP_ARCH]}
    same = [bool(np.array_equal(out[i], single[i])) for i in sorted(single)]
    gathered = collectives.comm_bytes()["all-gather"]
    emit({"phase": "serve_dp", "arch": cfg.name, "layers": cfg.n_layers, "backend": "nccl",
          "ranks": 1, "plan": {"dp": 1, "zero": 0}, **kw, "requests": len(reqs),
          "ticks": engine.n_ticks, "wall_s": wall,
          "decode_tok_s": engine.n_decode_tokens / engine.decode_s,
          "tokens_equal_meshless_by_request": same,
          "logits_all_gather_bytes": gathered,
          "logits_all_gather_bytes_expected": engine.n_ticks * 4 * cfg.vocab_size * 4,
          "launches": launches, "card": card})
    if not all(same) or min(launches.values()) == 0:
        raise AssertionError(f"dp engine over one rank: tokens equal {same}, launches {launches}")
    if gathered != engine.n_ticks * 4 * cfg.vocab_size * 4:
        raise AssertionError(f"dp engine gathered {gathered} logits bytes")
    del model, engine
    torch.cuda.empty_cache()
    return {f"{SERVE_DP_ARCH} serve dp": launches}


def _serve_rank(rank: int, world: int, init_method: str, step0: dict | None = None) -> None:
    """The dp engine on ``world`` nccl ranks (``tools/parallel_ranks.py
    serve``, a host of 2-4 cards): SERVE_DP_ARCH as in ``_serve_dp_one_rank``
    with 4 slots a rank over dp = world (ZeRO 0), 4 x world requests; every
    rank's tokens equal a meshless 4-slot engine's (the same shapes on each
    card, so the same kernels) and every rank holds 1/world of the pool the
    meshless engine of all the slots holds."""
    import datetime
    import os

    import torch.distributed as dist

    from repro_torch.core.compute import ComputePolicy
    from repro_torch.launch.mesh import init_distributed, mesh_for_plan
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve_engine import Request, ServeEngine
    from repro_torch.runtime.train_loop import ParallelPlan

    os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(torch.device("cuda"), init_method, rank, world,
                     timeout=datetime.timedelta(minutes=5))
    cfg = train_config(SERVE_DP_ARCH)
    model = Model(cfg, torch.bfloat16, compute=ComputePolicy(kernels=True), device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(3)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, int(n)).astype(np.int32),
                    max_new_tokens=16) for i, n in enumerate(rng.randint(64, 257, 4 * world))]
    blocks = 1 + 4 * (512 // 16 + 1)
    single = ServeEngine(model, n_slots=4, cache_len=512, block_size=16).run(reqs)
    whole = ServeEngine(model, n_slots=4 * world, cache_len=512, block_size=16,
                        n_blocks=world * blocks)
    plan = ParallelPlan(dp=world, zero=0)
    device = torch.device("cuda", torch.cuda.current_device())
    engine = ServeEngine(model, n_slots=4 * world, cache_len=512, block_size=16,
                         n_blocks=world * blocks, mesh=mesh_for_plan(plan, device), plan=plan)
    t0 = time.perf_counter()
    out = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    same = [bool(np.array_equal(out[i], single[i])) for i in sorted(single)]
    share = pool_bytes(engine.cache) / pool_bytes(whole.cache)
    if rank == 0:
        emit({"phase": "serve_dp_ranks", "arch": cfg.name, "layers": cfg.n_layers,
              "ranks": world, "slots": 4 * world, "requests": len(reqs), "wall_s": wall,
              "ticks": engine.n_ticks, "decode_tok_s": engine.n_decode_tokens / engine.decode_s,
              "tokens_equal_4_slot_engine_by_request": same, "pool_share": share,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    dist.destroy_process_group()
    if not all(same) or share != 1 / world:
        raise AssertionError(f"rank {rank}: tokens equal {same}, pool share {share}")


# phase 5's CommPlan runs over the same one-rank group: COMM_ARCH at
# TRAIN_LAYERS depth, full width, TRAIN's plan at ZeRO 3 with fp gathers,
# then the same plan and batches with each of COMM_VARIANTS.  A one-rank
# group still places the data axis (unit_axes), so each quantized leaf is
# quantized, its int8 payload and scales all-gathered and dequantized.
COMM_ARCH = "yi-6b"
COMM_VARIANTS = {"fp": {}, "qcomm gather": dict(qcomm="gather"),
                 "qcomm both": dict(qcomm="both"), "overlap": dict(overlap=True)}
# a quantized plan's loss at every step within 5% of the fp plan's: the
# reference's BENCH_comm.json validator's bar
COMM_DRIFT = 0.05


def comm_gather_bytes(cfg, plan) -> dict:
    """The ZeRO gathers' bytes of one step of ``plan`` (intra, inter,
    total) by ``costmodel.predict_comm_bytes`` over the plan's shapes, specs
    and CommPlan, with the port's one-rank phases (``unit_axes``): the
    layer stack twice a microbatch under remat full or selective (the
    forward and the recompute) in the compute dtype, the embedding once in
    its fp32 storage dtype, the rest once in the compute dtype."""
    from repro_torch.core import costmodel
    from repro_torch.core import precision as prec
    from repro_torch.runtime.train_loop import plan_state_shardings

    shapes, psh, _, _ = plan_state_shardings(cfg, plan)
    item = prec.policy_from_name(plan.precision).compute_dtype.itemsize
    stack = sorted(k for k in shapes if k.startswith("layers."))
    rest = sorted(k for k in shapes if k not in stack and k != "embed")
    parts = [(stack, item, plan.gas * (1 if plan.remat == "none" else 2)),
             (rest, item, plan.gas), (["embed"], 4, plan.gas)]
    if cfg.tie_embeddings:          # the lm_head's use of it, in the compute dtype
        parts.append((["embed"], item, plan.gas))
    out = {"intra": 0.0, "inter": 0.0, "total": 0.0}
    for keys, size, times in parts:
        b = costmodel.predict_comm_bytes([shapes[k] for k in keys], [psh[k] for k in keys],
                                         plan.mesh_sizes(), plan.comm_plan(), itemsize=size,
                                         multiplier=times, unit_axes=True)
        out = {k: out[k] + b[k] for k in out}
    return out


def _comm_one_rank(card: str) -> dict:
    """COMM_VARIANTS over the default one-rank group; returns each run's
    launches ({path: {kernel: count}}).  Each run's median step time, peak
    memory and gather bytes are readings; its launches must be exact, its
    gather bytes every step the predicted ones, a quantized run's losses
    within COMM_DRIFT of the fp run's, overlap's step 0 within
    PARALLEL_RTOL of it (it reorders no arithmetic)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.train_loop import ParallelPlan

    cfg = train_config(COMM_ARCH)
    gb, S = TRAIN["global_batch"], TRAIN["seq_len"]
    batches = _batches(cfg.vocab_size, S, gb, PARALLEL_STEPS)
    kw = dict(gas=TRAIN["gas"], precision="bf16", remat="full", kernels=True, zero=3)
    expected = expected_train_launches(cfg, PARALLEL_STEPS)
    runs, paths = {}, {}
    for name, extra in COMM_VARIANTS.items():
        plan = ParallelPlan(**kw, **extra)
        ops.reset_launch_counts()
        steps, peak = _sharded_steps(cfg, plan, batches, 0)
        paths[f"{COMM_ARCH} parallel {name}"] = launches = {
            k: ops.launch_counts()[k] for k in TRAIN_KERNELS[COMM_ARCH]}
        runs[name] = steps
        want = comm_gather_bytes(cfg, plan)
        fp = runs["fp"]
        drift = [abs(a["loss"] - b["loss"]) / b["loss"] for a, b in zip(steps, fp)]
        emit({"phase": "parallel_comm", "arch": cfg.name, "layers": cfg.n_layers,
              "variant": name, "plan": {"dp": 1, **kw, **extra}, "backend": "nccl",
              "ranks": 1, "steps": steps,
              "median_step_s": float(np.median([r["step_s"] for r in steps[1:]])),
              "median_step_s_fp": float(np.median([r["step_s"] for r in fp[1:]])),
              "peak_mem_gb": peak, "zero3_gather": steps[-1]["zero3_gather"],
              "predicted_zero3_gather": want,
              "bytes_vs_fp": steps[-1]["zero3_gather"]["total"]
              / fp[-1]["zero3_gather"]["total"],
              "loss_drift_vs_fp": drift, "step0_rel_diff_vs_fp": _rel(steps[0], fp[0]),
              "launches": launches, "card": card})
        if launches != expected:
            raise AssertionError(f"{name}: launches {launches}, expected {expected}")
        for i, r in enumerate(steps):
            if r["zero3_gather"] != want:
                raise AssertionError(f"{name} step {i}: gather bytes {r['zero3_gather']}, "
                                     f"predicted {want}")
        if "qcomm" in extra and max(drift) >= COMM_DRIFT:
            raise AssertionError(f"{name}: loss drift {drift} from the fp run")
        if extra.get("overlap") and any(v > PARALLEL_RTOL
                                        for v in _rel(steps[0], fp[0]).values()):
            raise AssertionError(f"overlap step 0 vs fp: {_rel(steps[0], fp[0])}")
        if not all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in steps):
            raise AssertionError(f"{name}: non-finite steps {steps}")
    return paths


def _parallel_rank(rank: int, world: int, init_method: str, step0: dict) -> None:
    """One nccl rank of the multi-rank branch: the reduced yi-6b's fp32 plans
    (PARALLEL_REDUCED) against the single-device port at PARALLEL_RTOL (dp =
    world at ZeRO 0-3, dp = world / 2 x tp = 2 at ZeRO 1 and 3, kernels off
    and on); yi-6b at
    TRAIN_LAYERS depth and full width at dp = world, ZeRO 3, step 0 within
    STEP0_RTOL of phase 4's single-device step (``step0``: {arch: phase 4's
    step 0}); at 4 ranks yi-6b at all 32 layers, ZeRO 3, 3 steps, with each
    rank's peak memory; then the recurrent families under tp
    (``_recurrent_tp``)."""
    import datetime
    import os

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.models.model import Model
    from repro_torch.runtime.train_loop import ParallelPlan

    os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    # a rank that fails mid-collective leaves the others waiting: time out
    init_distributed(torch.device("cuda"), init_method, rank, world,
                     timeout=datetime.timedelta(minutes=5))
    plans = [dict(dp=world, zero=z) for z in (0, 1, 2, 3)]
    plans += [dict(dp=world // 2, tp=2, zero=z) for z in (1, 3)] if world % 2 == 0 else []
    for kernels, overrides in PARALLEL_REDUCED.items():
        red = get_config("yi-6b").reduced(**overrides)
        rb = _batches(red.vocab_size, 32, 8, 3)
        kw = dict(gas=2, precision="fp32", kernels=kernels)
        single = _run_steps(Model(red, torch.float32, device="cuda"), ParallelPlan(**kw), rb, 0)
        for p in plans:
            steps, _ = _sharded_steps(red, ParallelPlan(**p, **kw), rb, 0)
            rel = [_rel(a, b) for a, b in zip(steps, single)]
            emit({"phase": "parallel_ranks_reduced", "rank": rank, "plan": {**p, **kw},
                  "rel_diff": rel, "rtol": PARALLEL_RTOL})
            if any(v > PARALLEL_RTOL for r in rel for v in r.values()):
                raise AssertionError(f"rank {rank} plan {p} kernels={kernels}: {rel}")
    kw = dict(gas=TRAIN["gas"], precision="bf16", remat="full", kernels=True)
    gb, S = TRAIN["global_batch"], TRAIN["seq_len"]
    cfg = train_config("yi-6b")
    yi_step0 = step0.get("yi-6b")
    steps, peak = _sharded_steps(cfg, ParallelPlan(dp=world, zero=3, **kw),
                                 _batches(cfg.vocab_size, S, gb, 1), 0, tele=True)
    rel0 = None if yi_step0 is None else _rel(steps[0], yi_step0)
    emit({"phase": "parallel_ranks", "rank": rank, "arch": cfg.name, "layers": cfg.n_layers,
          "dp": world, "zero": 3, "step0": steps[0], "train_step0": yi_step0,
          "rel_diff": rel0, "rtol": STEP0_RTOL["yi-6b"], "peak_mem_gb": peak})
    if rel0 is None or any(rel0[k] > STEP0_RTOL["yi-6b"][k] for k in rel0):
        raise AssertionError(f"rank {rank}: yi-6b dp={world} step 0 vs phase 4's: {rel0}")
    if world == 4:
        cfg = get_config("yi-6b")
        steps, peak = _sharded_steps(cfg, ParallelPlan(dp=world, zero=3, **kw),
                                     _batches(cfg.vocab_size, S, gb, 3), 0, tele=True)
        emit({"phase": "parallel_ranks", "rank": rank, "arch": cfg.name,
              "layers": cfg.n_layers, "dp": world, "zero": 3, "steps": steps,
              "peak_mem_gb": peak})
        if not all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in steps):
            raise AssertionError(f"rank {rank}: non-finite yi-6b steps {steps}")
    _recurrent_tp(rank, world, step0)
    _moe_ranks(rank, world)
    _comm_ranks(rank, world)
    _rules_ranks(rank, world, step0)
    dist.destroy_process_group()


# the recurrent families' reduced fp32 models of the multi-rank branch, at
# their kernels' widths: zamba2 at the SSD kernels' P = N = 64 (8 SSM heads)
# and a shared block of 4 heads of 64, MHA (so tp 4 splits both); rwkv6 as
# plain .reduced() gives it (4 heads of K = V = 64), 4 blocks
TP_REDUCED = {ZAMBA: dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
                          ssm_head_dim=64, ssm_state=64),
              RWKV: dict(n_layers=4)}
# the grad norms after the first update: Adam's first step moves every
# weight by +-lr whatever its gradient's size, so a gradient element whose
# sign is within rounding flips its update, and the next steps' grad norms
# move by more than PARALLEL_RTOL under any reordering of fp32 sums
# (tests/test_torch_parallel_tp.py:RWKV_LATER_NORMS; on four H100s zamba2's
# reduced tp = 4 read 1.3e-5 at step 2, its step 0 at 1.5e-6, its losses
# within 7.6e-8): held at the reference's bar, step 0 and every loss at
# PARALLEL_RTOL
TP_LATER_NORMS_RTOL = 1e-4
# full-width tp steps of each arch (step 0 checked, the next timed)
TP_STEPS = 2
# the step-0 limits of the full-width tp steps against phase 4's single-device
# step (bf16): tp rounds each rank's partial sums of the row-parallel
# outputs to bf16 before they are summed, which the kernels-on vs off
# readings behind STEP0_RTOL do not cover.  Stated before the first card
# run, by step0_limits' rule (1.5x the largest sound reading over 3 seeds)
# on CPU stand-ins (gloo ranks, the families reduced to 2 and 4 layers of
# d 256, 4 x 32 tokens, bf16, kernels' plain versions): tp 2 and 4 vs one
# process read up to 1.4e-4 (loss) and 1.3e-2 (grad norm) for zamba2, 2.9e-4
# and 3.3e-2 for rwkv6; the larger of that and STEP0_RTOL.
# The rules plans (RULES_FULL), by the same rule, stated before their first
# card run (``tools/rules_step0_standins.py``: seeds 0-4, kernels off and
# on): yi-6b reduced to 2 and 4 layers of d 256 under seq_shard at tp 4 and
# fsdp_seq at dp 2 x tp 2 read up to 5.5e-5 (loss) and 1.5e-3 (grad norm)
# against one process; arctic reduced to 2 layers of d 256, 8 experts,
# under moe_dp_attn and ep_model at tp 4 up to 3.9e-4 and 4.4e-3 (bf16
# routing: an expert's partial outputs summed over the group in bf16 move
# the next layer's gates).
TP_STEP0_RTOL = {ZAMBA: STEP0_RTOL[ZAMBA], RWKV: {"loss": 5e-4, "grad_norm": 5e-2},
                 "yi-6b": {"loss": 8.2e-5, "grad_norm": 2.2e-3},
                 ARCTIC: {"loss": 5.9e-4, "grad_norm": 6.6e-3}}


def _recurrent_tp(rank: int, world: int, step0: dict) -> None:
    """The recurrent families under tensor parallelism on ``world`` nccl
    ranks (2 or 4; the default group is up): the reduced fp32 models
    (TP_REDUCED) at tp = world and dp = world / 2 x tp = 2 at ZeRO 1 and 3,
    kernels off and on, against the single-device port (losses at every
    step and step 0's grad norm at PARALLEL_RTOL, later grad norms at
    TP_LATER_NORMS_RTOL); zamba2-2.7b and rwkv6-1.6b (TRAIN_LAYERS
    depth) at full width, tp = world, bf16, kernels, TRAIN's
    batch, step 0 within TP_STEP0_RTOL of phase 4's single-device step
    (``step0``: the same weights and batch) and a telemetry record a step
    (MFU, each rank's peak, the collective bytes by kind); at 4 ranks
    zamba2-2.7b at all 54 layers at tp = 4 (about 10.8 GB of fp32 state a
    card), its steps finite."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.runtime.train_loop import ParallelPlan

    plans = [dict(tp=world)] + ([dict(dp=world // 2, tp=2, zero=z) for z in (1, 3)]
                                if world == 4 else [])
    for arch, overrides in TP_REDUCED.items():
        red = get_config(arch).reduced(**overrides)
        rb = _batches(red.vocab_size, 32, 8, 3)
        for kernels in (False, True):
            kw = dict(gas=2, precision="fp32", kernels=kernels)
            single = _run_steps(Model(red, torch.float32, device="cuda"), ParallelPlan(**kw),
                                rb, 0)
            for p in plans:
                steps, _ = _sharded_steps(red, ParallelPlan(**p, **kw), rb, 0)
                rel = [_rel(a, b) for a, b in zip(steps, single)]
                emit({"phase": "parallel_ranks_tp_reduced", "rank": rank, "arch": red.name,
                      "plan": {**p, **kw}, "rel_diff": rel, "rtol": PARALLEL_RTOL,
                      "later_grad_norm_rtol": TP_LATER_NORMS_RTOL})
                if (any(r["loss"] > PARALLEL_RTOL for r in rel)
                        or rel[0]["grad_norm"] > PARALLEL_RTOL
                        or any(r["grad_norm"] > TP_LATER_NORMS_RTOL for r in rel[1:])):
                    raise AssertionError(f"rank {rank} {arch} plan {p} kernels={kernels}: {rel}")
    kw = dict(gas=TRAIN["gas"], precision="bf16", remat="full", kernels=True)
    gb, S = TRAIN["global_batch"], TRAIN["seq_len"]
    # (arch, config, whether step 0 is held to phase 4's)
    runs = [(ZAMBA, train_config(ZAMBA), True), (RWKV, train_config(RWKV), True)]
    if world == 4:
        runs.append((ZAMBA, get_config(ZAMBA), False))
    for arch, cfg, held in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps, peak = _sharded_steps(cfg, ParallelPlan(tp=world, **kw),
                                     _batches(cfg.vocab_size, S, gb, TP_STEPS), 0, tele=True)
        ref = step0.get(arch) if held else None
        rel0 = None if ref is None else _rel(steps[0], ref)
        emit({"phase": "parallel_ranks_tp", "rank": rank, "arch": cfg.name,
              "layers": cfg.n_layers, "tp": world, "steps": steps, "peak_mem_gb": peak,
              "train_step0": ref, "rel_diff": rel0, "rtol": TP_STEP0_RTOL[arch] if held else None,
              "seconds": time.perf_counter() - t0})
        if not all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in steps):
            raise AssertionError(f"rank {rank}: non-finite {cfg.name} tp={world} steps {steps}")
        if held and (rel0 is None or any(rel0[k] > TP_STEP0_RTOL[arch][k] for k in rel0)):
            raise AssertionError(f"rank {rank}: {cfg.name} tp={world} step 0 vs phase 4's: "
                                 f"{rel0}, limits {TP_STEP0_RTOL[arch]}")


def _recurrent_tp_rank(rank: int, world: int, init_method: str, step0: dict) -> None:
    """``_recurrent_tp`` alone on one nccl rank (``tools/parallel_ranks.py
    recurrent``)."""
    import datetime
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(torch.device("cuda"), init_method, rank, world,
                     timeout=datetime.timedelta(minutes=5))
    _recurrent_tp(rank, world, step0)
    dist.destroy_process_group()


# the moe family's reduced fp32 models of the multi-rank branch (4 experts,
# .reduced(ep=2)): llama4 at 4 layers (2 MoE units, so pp 2 splits them), at
# the flash kernels' head dim 64; their plans on 4 ranks (on 2: ep 2 alone)
MOE_REDUCED = {LLAMA4: dict(ep=2, n_layers=4), ARCTIC: dict(ep=2)}
MOE_PLANS = {"ep4": dict(ep=4), "ep2 dp2": dict(ep=2, dp=2),
             "ep2 dp2 z3": dict(ep=2, dp=2, zero=3), "ep2 tp2": dict(ep=2, tp=2),
             "ep2 pp2": dict(ep=2, pp=2)}
MOE_DROP_ATOL = 1e-6
# arctic at full width on 4 ranks: 1 layer of 64 experts at ep 4 (16 a card:
# about 27 GB of expert state and 11 GB of the rest); 128 would be about
# 78 GB a card before activations (train_state_bytes, emitted)
MOE_EP_EXPERTS = 64


def _moe_a2a_bytes(cfg, plan, gb: int, S: int) -> int:
    """``costmodel.predict_a2a_bytes`` for a step of the rank: the dispatch
    and combine forward and backward, and again in remat's recompute, of
    each MoE unit on the rank and each microbatch."""
    from repro_torch.core import costmodel
    from repro_torch.models.model import stage_units
    from repro_torch.models.moe import group_shape, moe_capacity

    G, g = group_shape(gb // plan.gas, S)
    itemsize = 4 if plan.precision == "fp32" else 2       # the compute dtype's
    per = sum(costmodel.predict_a2a_bytes(G, cfg.n_experts, moe_capacity(g, cfg), cfg.d_model,
                                          dp=plan.dp, ep=plan.ep, itemsize=itemsize,
                                          with_backward=bwd)
              for bwd in ((True, False) if plan.remat != "none" else (True,)))
    return per * plan.gas * stage_units(cfg)[1] // plan.pp


def _moe_ranks(rank: int, world: int) -> None:
    """The moe family under expert parallelism on ``world`` nccl ranks (2 or
    4; the default group is up): the reduced fp32 models (MOE_REDUCED) at
    each of MOE_PLANS that tiles ``world`` (kernels on) against the
    single-device port: losses at PARALLEL_RTOL, moe_drop within
    MOE_DROP_ATOL, each step's all-to-all bytes equal to the predictor's;
    then, at 4 ranks, arctic at full width, 1 layer, MOE_EP_EXPERTS experts,
    ep 4, bf16, kernels, TRAIN's batch: its steps' time, each rank's peak
    memory and all-to-all bytes, and the state bytes a card would hold at
    all 128 experts."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.runtime.train_loop import ParallelPlan, train_state_bytes

    for arch, overrides in MOE_REDUCED.items():
        red = get_config(arch).reduced(**overrides)
        rb = _batches(red.vocab_size, 32, 8, 3)
        kw = dict(gas=2, precision="fp32", kernels=True)
        single = _run_steps(Model(red, torch.float32, device="cuda"), ParallelPlan(**kw), rb, 0)
        for p in MOE_PLANS.values() if world == 4 else (dict(ep=2),):
            plan = ParallelPlan(**p, **kw)
            steps, peak = _sharded_steps(red, plan, rb, 0)
            rel = [_rel(a, b) for a, b in zip(steps, single)]
            drop = [abs(a["moe_drop"] - b["moe_drop"]) for a, b in zip(steps, single)]
            a2a = _moe_a2a_bytes(red, plan, 8, 32)
            emit({"phase": "parallel_ranks_moe_reduced", "rank": rank, "arch": red.name,
                  "plan": {**p, **kw}, "rel_diff": rel,
                  "rtol": PARALLEL_RTOL, "moe_drop_diff": drop,
                  "all_to_all_bytes": [r["all_to_all_bytes"] for r in steps],
                  "predicted_all_to_all_bytes": a2a})
            if (any(v > PARALLEL_RTOL for r in rel for v in r.values())
                    or max(drop) > MOE_DROP_ATOL
                    or any(r["all_to_all_bytes"] != a2a for r in steps)):
                raise AssertionError(f"rank {rank} {arch} plan {p}: {rel}, drop {drop}, "
                                     f"all-to-all {[r['all_to_all_bytes'] for r in steps]} "
                                     f"vs {a2a}")
    if world != 4:
        return
    kw = dict(gas=TRAIN["gas"], precision="bf16", remat="full", kernels=True)
    gb, S = TRAIN["global_batch"], TRAIN["seq_len"]
    full = get_config(ARCTIC)
    cfg = dataclasses.replace(full, n_layers=1, n_experts=MOE_EP_EXPERTS)
    plan = ParallelPlan(ep=4, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps, peak = _sharded_steps(cfg, plan, _batches(cfg.vocab_size, S, gb, 3), 0, tele=True)
    a2a = _moe_a2a_bytes(cfg, plan, gb, S)
    all_experts = train_state_bytes(dataclasses.replace(full, n_layers=1), plan)
    emit({"phase": "parallel_ranks_moe", "rank": rank, "arch": cfg.name, "layers": 1,
          "n_experts": cfg.n_experts, "ep": 4, "steps": steps, "peak_mem_gb": peak,
          "state_gb": sum(v for k, v in train_state_bytes(cfg, plan).items()
                          if k != "zero") / 1e9,
          "predicted_all_to_all_bytes": a2a,
          "state_gb_at_128_experts": sum(v for k, v in all_experts.items() if k != "zero") / 1e9,
          "fits_at_128_experts": False, "seconds": time.perf_counter() - t0})
    if not all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in steps):
        raise AssertionError(f"rank {rank}: non-finite arctic ep=4 steps {steps}")
    if any(r["all_to_all_bytes"] != a2a for r in steps):
        raise AssertionError(f"rank {rank}: arctic ep=4 all-to-all "
                             f"{[r['all_to_all_bytes'] for r in steps]} vs {a2a}")


# the reference's sharding rules on the cards (``rule_overrides`` of
# launch/hillclimb.py): name -> (arch, the variant's overrides, whether the
# plan takes dp 2 x tp = ranks / 2 at 4 ranks rather than tp = ranks)
RULES_PLANS = {"yi-6b seq_shard": ("yi-6b", "seq_shard", False),
               "yi-6b fsdp_seq": ("yi-6b", "fsdp_seq", True),
               "yi-6b moe_dp_attn+seq": ("yi-6b", "moe_dp_attn+seq", False),
               f"{ARCTIC} moe_dp_attn": (ARCTIC, "moe_dp_attn", False),
               f"{ARCTIC} ep_model": (ARCTIC, "ep_model", False),
               f"{ARCTIC} seq_shard": (ARCTIC, "seq_shard", False)}
# the reduced fp32 models of the rules plans, at the flash kernels' head dim
# 64: yi-6b as PARALLEL_REDUCED[True], arctic at 8 experts (2 a rank at
# ep_model over 4)
RULES_REDUCED = {"yi-6b": PARALLEL_REDUCED[True], ARCTIC: dict(n_layers=2, n_experts=8)}
# the full-width plans (yi-6b at TRAIN_LAYERS, arctic at its train phase's 2
# layers of 8 experts), step 0 against phase 4's
RULES_FULL = ("yi-6b seq_shard", "yi-6b fsdp_seq", f"{ARCTIC} moe_dp_attn",
              f"{ARCTIC} ep_model")


def rules_plan(name: str, world: int, **kw):
    """The ParallelPlan of RULES_PLANS[name] on ``world`` ranks."""
    from repro_torch.launch.hillclimb import VARIANTS
    from repro_torch.runtime.train_loop import ParallelPlan

    _, variant, dp2 = RULES_PLANS[name]
    shape = dict(dp=2, tp=world // 2) if dp2 and world == 4 else dict(tp=world)
    return VARIANTS[variant]["plan"](ParallelPlan(**shape, **kw))


def _rules_ranks(rank: int, world: int, step0: dict) -> None:
    """The reference's sharding rules on ``world`` nccl ranks (2 or 4; the
    default group is up), kernels on: each of RULES_PLANS on its reduced
    fp32 model (RULES_REDUCED) against the single-device port (losses and
    grad norms at PARALLEL_RTOL, moe_drop within MOE_DROP_ATOL), then
    RULES_FULL at full width, bf16, step 0 within TP_STEP0_RTOL of phase
    4's single-device step (``step0``: {arch: step 0})."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.runtime.train_loop import ParallelPlan

    kw = dict(gas=2, precision="fp32", kernels=True)
    singles = {}
    for name, (arch, _, _) in RULES_PLANS.items():
        red = get_config(arch).reduced(**RULES_REDUCED[arch])
        rb = _batches(red.vocab_size, 32, 8, 3)
        if arch not in singles:
            singles[arch] = _run_steps(Model(red, torch.float32, device="cuda"),
                                       ParallelPlan(**kw), rb, 0)
        plan = rules_plan(name, world, **kw)
        steps, _ = _sharded_steps(red, plan, rb, 0)
        rel = [_rel(a, b) for a, b in zip(steps, singles[arch])]
        drop = [abs(a.get("moe_drop", 0.0) - b.get("moe_drop", 0.0))
                for a, b in zip(steps, singles[arch])]
        emit({"phase": "parallel_ranks_rules_reduced", "rank": rank, "plan": name,
              "tp": plan.tp, "dp": plan.dp, "rule_overrides": plan.rule_overrides,
              "rel_diff": rel, "rtol": PARALLEL_RTOL, "moe_drop_diff": drop})
        if any(v > PARALLEL_RTOL for r in rel for v in r.values()) or max(drop) > MOE_DROP_ATOL:
            raise AssertionError(f"rank {rank} {name} (reduced): {rel}, drop {drop}")
    kw = dict(gas=TRAIN["gas"], precision="bf16", remat="full", kernels=True)
    gb, S = TRAIN["global_batch"], TRAIN["seq_len"]
    for name in RULES_FULL:
        arch = RULES_PLANS[name][0]
        cfg = train_config(arch)
        plan = rules_plan(name, world, **kw)
        steps, peak = _sharded_steps(cfg, plan, _batches(cfg.vocab_size, S, gb, TP_STEPS, cfg),
                                     0, tele=True)
        rel0 = None if arch not in step0 else _rel(steps[0], step0[arch])
        emit({"phase": "parallel_ranks_rules", "rank": rank, "plan": name,
              "arch": cfg.name, "layers": cfg.n_layers, "tp": plan.tp, "dp": plan.dp,
              "steps": steps, "train_step0": step0.get(arch), "rel_diff": rel0,
              "rtol": TP_STEP0_RTOL[arch], "peak_mem_gb": peak})
        if rel0 is None or any(rel0[k] > TP_STEP0_RTOL[arch][k] for k in rel0):
            raise AssertionError(f"rank {rank}: {name} step 0 vs phase 4's: {rel0}")
        torch.cuda.empty_cache()


def _rules_rank(rank: int, world: int, init_method: str, step0: dict) -> None:
    """One nccl rank of ``_rules_ranks`` alone (``tools/parallel_ranks.py
    rules``)."""
    import datetime
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(torch.device("cuda"), init_method, rank, world,
                     timeout=datetime.timedelta(minutes=5))
    _rules_ranks(rank, world, step0)
    dist.destroy_process_group()


def _moe_rank(rank: int, world: int, init_method: str, step0: dict | None = None) -> None:
    """``_moe_ranks`` alone on one nccl rank (``tools/parallel_ranks.py moe``)."""
    import datetime
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(torch.device("cuda"), init_method, rank, world,
                     timeout=datetime.timedelta(minutes=5))
    _moe_ranks(rank, world)
    dist.destroy_process_group()


# the CommPlan's plans of the multi-rank branch, at node 2 x dp = ranks / 2
# beside dp = ranks: the reduced yi-6b's fp32 plans (PARALLEL_REDUCED, kernels
# off) of tests/test_torch_parallel_tp.py, the fp ones held to the
# single-device port at PARALLEL_RTOL, the quantized ones within COMM_DRIFT
# of it, every one's gather bytes to the predictor; then yi-6b at all 32
# layers, ZeRO 3, TRAIN's bf16 plan with kernels, each of COMM_RANK_VARIANTS
# at both layouts (step time, every card's peak, intra and inter bytes),
# node 2's fp step 0 held to dp's at STEP0_RTOL
COMM_RANK_VARIANTS = {"fp": {}, "qcomm gather": dict(qcomm="gather"),
                      "overlap": dict(overlap=True),
                      "qcomm gather overlap": dict(qcomm="gather", overlap=True)}


def _comm_reduced_plans(world: int) -> tuple[dict, dict]:
    """({name: fp plan fields}, {name: quantized plan fields}) at ``world``."""
    node = dict(node=2, dp=world // 2)
    fp = {"node z1": dict(node, zero=1), "node z3": dict(node, zero=3),
          "dp z3 overlap": dict(dp=world, zero=3, overlap=True),
          "dp tp2 z3 overrides": dict(dp=world // 2, tp=2, zero=3,
                                      rule_overrides=(("vocab", None),))}
    quant = {"dp z3 gather": dict(dp=world, zero=3, qcomm="gather"),
             "dp z3 both": dict(dp=world, zero=3, qcomm="both"),
             "node z3 gather overlap": dict(node, zero=3, qcomm="gather", overlap=True)}
    return fp, quant


def _comm_ranks(rank: int, world: int) -> None:
    """The CommPlan's multi-rank plans (above) on this nccl rank."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.runtime.train_loop import ParallelPlan

    if world % 2:
        emit({"phase": "parallel_comm_ranks", "rank": rank, "ran": False,
              "why": f"{world} ranks: node 2 needs an even count"})
        return
    red = get_config("yi-6b").reduced(**PARALLEL_REDUCED[False])
    rb = _batches(red.vocab_size, 32, 8, 3)
    kw = dict(gas=2, precision="fp32")
    single = _run_steps(Model(red, torch.float32, device="cuda"), ParallelPlan(**kw), rb, 0)
    fp, quant = _comm_reduced_plans(world)
    for name, fields in {**fp, **quant}.items():
        plan = ParallelPlan(**fields, **kw)
        steps, _ = _sharded_steps(red, plan, rb, 0)
        rel = [_rel(a, b) for a, b in zip(steps, single)]
        want = comm_gather_bytes(red, plan)
        emit({"phase": "parallel_comm_ranks_reduced", "rank": rank, "plan": name,
              "fields": {**fields, **kw}, "rel_diff": rel, "rtol": PARALLEL_RTOL,
              "drift_bar": COMM_DRIFT, "zero3_gather": steps[-1]["zero3_gather"],
              "predicted_zero3_gather": want})
        if name in fp and any(v > PARALLEL_RTOL for r in rel for v in r.values()):
            raise AssertionError(f"rank {rank} {name}: {rel}")
        if name in quant and max(r["loss"] for r in rel) >= COMM_DRIFT:
            raise AssertionError(f"rank {rank} {name}: loss drift {rel}")
        if any(r["zero3_gather"] != want for r in steps):
            raise AssertionError(f"rank {rank} {name}: gather bytes "
                                 f"{[r['zero3_gather'] for r in steps]}, predicted {want}")
    cfg = get_config("yi-6b")
    gb, S = TRAIN["global_batch"], TRAIN["seq_len"]
    batches = _batches(cfg.vocab_size, S, gb, 3)
    kw = dict(gas=TRAIN["gas"], precision="bf16", remat="full", kernels=True, zero=3)
    step0 = {}
    for layout, fields in (("dp", dict(dp=world)), ("node", dict(node=2, dp=world // 2))):
        for name, extra in COMM_RANK_VARIANTS.items():
            plan = ParallelPlan(**fields, **kw, **extra)
            steps, peak = _sharded_steps(cfg, plan, batches, 0, tele=True)
            step0[layout, name] = steps[0]
            emit({"phase": "parallel_comm_ranks", "rank": rank, "arch": cfg.name,
                  "layers": cfg.n_layers, "layout": layout, "variant": name,
                  "fields": {**fields, **extra}, "steps": steps,
                  "median_step_s": float(np.median([r["step_s"] for r in steps[1:]])),
                  "peak_mem_gb": peak,
                  "peak_gb_by_rank": [b / 1e9 for b in
                                      steps[-1]["telemetry"].get("peak_bytes", [])],
                  "zero3_gather": steps[-1]["zero3_gather"],
                  "predicted_zero3_gather": comm_gather_bytes(cfg, plan)})
            if not all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in steps):
                raise AssertionError(f"rank {rank}: non-finite {layout} {name} {steps}")
    rel0 = _rel(step0["node", "fp"], step0["dp", "fp"])
    emit({"phase": "parallel_comm_ranks", "rank": rank, "node_vs_dp_step0": rel0,
          "rtol": STEP0_RTOL["yi-6b"]})
    if any(rel0[k] > STEP0_RTOL["yi-6b"][k] for k in rel0):
        raise AssertionError(f"rank {rank}: node 2 step 0 vs dp's: {rel0}")


def _comm_rank(rank: int, world: int, init_method: str, step0: dict | None = None) -> None:
    """``_comm_ranks`` alone on one nccl rank (``tools/parallel_ranks.py comm``)."""
    import datetime
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(torch.device("cuda"), init_method, rank, world,
                     timeout=datetime.timedelta(minutes=5))
    _comm_ranks(rank, world)
    dist.destroy_process_group()


# phase 6, one card: PIPELINE_ARCH at full width and depth, TRAIN's batch at
# PIPELINE_GAS microbatches, split into 4 logical stages (6 layers each) run
# in one process, as (pipe ranks, virtual stages) = each of PIPELINE_SPLITS
PIPELINE_ARCH, PIPELINE_GAS, PIPELINE_SPLITS = "gpt-1.4b", 4, ((4, 1), (2, 2))


def _local_sweep(model, plan, batch: dict, p: int, v: int) -> dict:
    """One pipelined step's loss and grad norm on ``model`` (unsharded,
    every stage local; no update): the pipeline executor's sweep with the
    hand-off a local tensor, over ``schedule(p, gas, v)``."""
    from repro_torch.core import precision as prec
    from repro_torch.core.pipeline import schedule
    from repro_torch.optim import global_norm
    from repro_torch.runtime import pipeline

    view = model.with_policy(plan.compute_policy(),
                             prec.policy_from_name(plan.precision).compute_dtype)
    tokens = torch.from_numpy(np.asarray(batch["tokens"])).to(model.device)
    b = tokens.shape[0] // plan.gas
    micro = [{"tokens": tokens[i * b:(i + 1) * b]} for i in range(plan.gas)]
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ce = pipeline.sweep(view, schedule(p, plan.gas, v), micro,
                        pipeline.loss_count({"tokens": tokens}, model.device),
                        prec.init_loss_scale(False))
    norm = global_norm([q.grad for q in model.parameters()])
    torch.cuda.synchronize()
    out = {"loss": float(ce), "grad_norm": float(norm), "step_s": time.perf_counter() - t0}
    model.zero_grad(set_to_none=True)
    return out


def phase_pipeline(card: str) -> dict:
    """PIPELINE_ARCH's step 0 through the pipeline executor's stage split on
    one card against the single-device step on the same weights and batch;
    then, where the host has 2 or more cards, the multi-rank branch."""
    from repro_torch.core import telemetry
    from repro_torch.core.bubble import bubble_fraction
    from repro_torch.core.pipeline import schedule, spmd_idle_fraction
    from repro_torch.kernels import ops
    from repro_torch.runtime import pipeline
    from repro_torch.models.model import Model
    from repro_torch.runtime.train_loop import ParallelPlan

    cfg = train_config(PIPELINE_ARCH)
    gb, S = TRAIN["global_batch"], TRAIN["seq_len"]
    batch = _batches(cfg.vocab_size, S, gb, 1)[0]
    plan = ParallelPlan(gas=PIPELINE_GAS, precision="bf16", remat="full", kernels=True)
    model = Model(cfg, torch.float32, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    single = _run_steps(model, plan, [batch], 0)[0]
    single["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    expected = expected_train_launches(cfg, 1, PIPELINE_GAS)
    runs, launches = [], {}
    for p, v in PIPELINE_SPLITS:
        model.init(torch.Generator(device=model.device).manual_seed(0))   # step 0's weights
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        r = _local_sweep(model, plan, batch, p, v)
        got = {k: ops.launch_counts()[k] for k in TRAIN_KERNELS[PIPELINE_ARCH]}
        sched = schedule(p, PIPELINE_GAS, v)
        # the sweep's measured times (one process runs every stage in turn:
        # its idle share is the gaps between applications, not a bubble)
        r["measured"] = telemetry.pipeline_fields(p, PIPELINE_GAS, v,
                                                  [pipeline.walk_reading()])
        r.update(pipe_ranks=p, virtual_stages=v, stages=p * v,
                 layers_per_stage=cfg.n_layers // (p * v), ticks=sched.ticks,
                 spmd_idle_fraction=spmd_idle_fraction(p, PIPELINE_GAS, v),
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=got,
                 rel_diff=_rel(r, single))
        runs.append(r)
        launches = {k: launches.get(k, 0) + n for k, n in got.items()}
    emit({"phase": "pipeline", "check": "the stage split and its boundary backward on "
          "one card (every stage in one process, the hand-off a local tensor), not the "
          "transport", "arch": cfg.name, "layers": cfg.n_layers, "global_batch": gb,
          "seq_len": S, "gas": PIPELINE_GAS, "plan": "bf16 compute, fp32 master, remat "
          "full, kernels", "single_device_step0": single, "splits": runs,
          "rtol": PARALLEL_RTOL, "expected_launches_per_split": expected,
          "schedule_4x4": [{"v": v, "ticks": schedule(4, 4, v).ticks,
                            "spmd_idle_fraction": spmd_idle_fraction(4, 4, v),
                            "bubble_fraction": bubble_fraction(
                                4, 4, v, schedule="gpipe" if v == 1 else "1f1b_interleaved")}
                           for v in (1, 2)], "card": card})
    del model
    torch.cuda.empty_cache()
    for r in runs:
        if not all(np.isfinite([r["loss"], r["grad_norm"]])) or any(
                x > PARALLEL_RTOL for x in r["rel_diff"].values()):
            raise AssertionError(f"pipelined step 0 (p={r['pipe_ranks']}, v="
                                 f"{r['virtual_stages']}) vs single device: {r['rel_diff']}")
        if r["launches"] != expected:
            raise AssertionError(f"pipelined launches {r['launches']}, expected {expected}")
        m = r["measured"]
        if m["applications"] != r["stages"] * PIPELINE_GAS or not (
                0 < m["busy_s"][0] <= m["wall_s"][0]):
            raise AssertionError(f"the sweep's measurement {m}: expected "
                                 f"{r['stages'] * PIPELINE_GAS} applications inside its time")
    world = min(torch.cuda.device_count(), 4)
    if world >= 2:
        import torch.multiprocessing as mp

        mp.spawn(_pipeline_rank, args=(world, _process_group_file("pipe_ranks"),
                                       dict(PARALLEL_STEP0) or None), nprocs=world)
    else:
        emit({"phase": "pipeline_ranks", "ran": False,
              "why": f"{torch.cuda.device_count()} card: a pipe rank needs a neighbour on "
                     "another card (nccl refuses two ranks on one card)"})
    return launches


def _pipeline_rank(rank: int, world: int, init_method: str, gpt_step0: dict | None) -> None:
    """One nccl rank of phase 6's multi-rank branch: the reduced yi-6b's fp32
    pipelined plans (PARALLEL_REDUCED, kernels off and on) against the
    single-device port at PARALLEL_RTOL (4 ranks: pp = 2 x dp = 2 at ZeRO
    0-3, pp = 2 x dp = 2 with 2 virtual stages, pp = 4, pp = 2 x tp = 2; 2
    ranks: pp = 2, with 2 virtual stages, and at ZeRO 3); gpt-1.4b at full
    width and depth at pp = world, v = 1 and 2, step 0 against phase 5's
    single-device step at PARALLEL_RTOL; at 4 ranks yi-6b at all 32 layers
    at pp = 4, gas 8, ZeRO 1 for 3 steps with each rank's step time and peak
    memory, step 0 against dp = 4, ZeRO 3 at STEP0_RTOL."""
    import datetime
    import os

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.models.model import Model
    from repro_torch.runtime.train_loop import ParallelPlan

    os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    # a rank that fails mid-exchange leaves the others waiting: time out
    init_distributed(torch.device("cuda"), init_method, rank, world,
                     timeout=datetime.timedelta(minutes=5))
    if world == 4:
        plans = [dict(pp=2, dp=2, zero=z) for z in (0, 1, 2, 3)]
        plans += [dict(pp=2, dp=2, virtual_stages=2), dict(pp=4), dict(pp=2, tp=2)]
    else:
        plans = [dict(pp=world), dict(pp=world, virtual_stages=2), dict(pp=world, zero=3)]
    for kernels, overrides in PARALLEL_REDUCED.items():
        red = get_config("yi-6b").reduced(**overrides)
        rb = _batches(red.vocab_size, 32, 8, 3)
        kw = dict(gas=2, precision="fp32", kernels=kernels)
        single = _run_steps(Model(red, torch.float32, device="cuda"), ParallelPlan(**kw), rb, 0)
        for p in plans:
            steps, _ = _sharded_steps(red, ParallelPlan(**p, **kw), rb, 0)
            rel = [_rel(a, b) for a, b in zip(steps, single)]
            emit({"phase": "pipeline_ranks_reduced", "rank": rank, "plan": {**p, **kw},
                  "rel_diff": rel, "rtol": PARALLEL_RTOL})
            if any(v > PARALLEL_RTOL for r in rel for v in r.values()):
                raise AssertionError(f"rank {rank} plan {p} kernels={kernels}: {rel}")
    kw = dict(gas=TRAIN["gas"], precision="bf16", remat="full", kernels=True)
    gb, S = TRAIN["global_batch"], TRAIN["seq_len"]
    cfg = train_config(PIPELINE_ARCH)
    for v in (1, 2):
        steps, peak = _sharded_steps(cfg, ParallelPlan(pp=world, virtual_stages=v, **kw),
                                     _batches(cfg.vocab_size, S, gb, 1), 0, tele=True)
        rel0 = None if gpt_step0 is None else _rel(steps[0], gpt_step0)
        emit({"phase": "pipeline_ranks", "rank": rank, "arch": cfg.name,
              "layers": cfg.n_layers, "pp": world, "virtual_stages": v, "gas": kw["gas"],
              "step0": steps[0], "single_device_step0": gpt_step0, "rel_diff": rel0,
              "rtol": PARALLEL_RTOL, "peak_mem_gb": peak})
        if rel0 is None or any(x > PARALLEL_RTOL for x in rel0.values()):
            raise AssertionError(f"rank {rank}: gpt-1.4b pp={world} v={v} step 0 vs "
                                 f"phase 5's: {rel0}")
    if world == 4:
        cfg = get_config("yi-6b")
        batches = _batches(cfg.vocab_size, S, gb, 3)
        dp, _ = _sharded_steps(cfg, ParallelPlan(dp=world, zero=3, **kw), batches[:1], 0)
        steps, peak = _sharded_steps(cfg, ParallelPlan(pp=world, zero=1,
                                                       **{**kw, "gas": 8}), batches, 0,
                                     tele=True)
        rel0 = _rel(steps[0], dp[0])
        emit({"phase": "pipeline_ranks", "rank": rank, "arch": cfg.name,
              "layers": cfg.n_layers, "pp": world, "gas": 8, "zero": 1, "steps": steps,
              "peak_mem_gb": peak, "dp4_zero3_step0": dp[0], "rel_diff": rel0,
              "rtol": STEP0_RTOL["yi-6b"]})
        if not all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in steps) or any(
                rel0[k] > STEP0_RTOL["yi-6b"][k] for k in rel0):
            raise AssertionError(f"rank {rank}: yi-6b pp=4 steps {steps}, step 0 vs "
                                 f"dp=4 ZeRO 3: {rel0}")
    dist.destroy_process_group()


# the multi-rank plans' reduced models: seamless at 4 decoder and 2 encoder
# layers over 16 frames, internvl2 at 4 layers of head dim 128 with 8 patches
# of 64 a row (tests/test_torch_encdec_ranks.py's)
FAMILY_REDUCED = {SEAMLESS: dict(n_layers=4, enc_layers=2, enc_seq_len=16),
                  INTERNVL: dict(n_layers=4, head_dim=128)}


def _family_rank(rank: int, world: int, init_method: str, step0: dict, arch: str) -> None:
    """One nccl rank of the encdec or vlm branch (``tools/parallel_ranks.py
    encdec|vlm``): the reduced arch's fp32 plans (FAMILY_REDUCED), kernels
    on, against the single-device port at PARALLEL_RTOL (2 ranks: dp 2 at
    ZeRO 3, tp 2, pp 2 at 1 and 2 virtual stages; 4 ranks: dp 4 at ZeRO 3,
    dp 2 x tp 2, pp 2 x dp 2, pp 4, pp 2 x tp 2), each step's bytes held to
    their predictions: the encdec encoder's pipe gather (and scatter) the
    fp32 encoder stack, and the ring's sends over every rank those of (b,
    num_patches + seq, d) fp32 hand-offs (vlm: the patch positions ride the
    ring), gas x (stages - 1) x 2 a pipe group; then the arch at full width
    and depth (TRAIN's plan) at pp = ranks and at dp = ranks, ZeRO 3, 3
    steps, step 0 against phase 4's single-device step (``step0``: {arch:
    phase 4's step 0}) at STEP0_RTOL, with each rank's step times,
    collective bytes and peak memory."""
    import datetime
    import os

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.sharding import shard_shape, spec_axes
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.models.model import Model
    from repro_torch.runtime.train_loop import ParallelPlan, plan_state_shardings

    os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(torch.device("cuda"), init_method, rank, world,
                     timeout=datetime.timedelta(minutes=5))
    if world == 4:
        plans = [dict(dp=4, zero=3), dict(dp=2, tp=2), dict(pp=2, dp=2), dict(pp=4),
                 dict(pp=2, tp=2)]
    else:
        plans = [dict(dp=2, zero=3), dict(tp=2), dict(pp=2), dict(pp=2, virtual_stages=2)]
    red = get_config(arch).reduced(**FAMILY_REDUCED[arch])
    gb, seq = 8, 32
    rb = _batches(red.vocab_size, seq, gb, 3, red)
    kw = dict(gas=2, precision="fp32", kernels=True)
    single = _run_steps(Model(red, torch.float32, device="cuda"), ParallelPlan(**kw), rb, 0)
    positions = seq + (red.num_patches if red.family == "vlm" else 0)
    for p in plans:
        plan = ParallelPlan(**p, **kw)
        steps, _ = _sharded_steps(red, plan, rb, 0)
        rel = [_rel(a, b) for a, b in zip(steps, single)]
        # each rank gathers its block of each encoder leaf on the pipe axis
        # (a tp block under tp) over the pipe ranks: pp blocks, fp32
        shapes, psh, _, _ = plan_state_shardings(red, plan)
        sizes = plan.mesh_sizes()
        enc = 4 * sizes["pipe"] * sum(
            int(np.prod(shard_shape(shape, psh[k], sizes))) for k, shape in shapes.items()
            if k.startswith("encoder.layers.") and "pipe" in spec_axes(psh[k]))
        gathered = [r["pipe_gather"] for r in steps]
        sent = torch.tensor([r["send"] for r in steps], dtype=torch.float64, device="cuda")
        dist.all_reduce(sent)
        handoff = gb // plan.gas // plan.dp * positions * red.d_model * 4
        sends = (plan.dp * plan.tp * plan.gas * (plan.pp * plan.virtual_stages - 1) * 2 * handoff
                 if plan.pp > 1 else 0)
        emit({"phase": f"{red.family}_ranks_reduced", "rank": rank, "plan": {**p, **kw},
              "rel_diff": rel, "rtol": PARALLEL_RTOL, "pipe_gather": gathered,
              "pipe_gather_predicted": enc, "sends_all_ranks": sent.tolist(),
              "sends_predicted": sends})
        if any(v > PARALLEL_RTOL for r in rel for v in r.values()) or any(
                g != enc for g in gathered) or any(x != sends for x in sent.tolist()):
            raise AssertionError(f"rank {rank} plan {p}: {rel}, pipe gather {gathered} "
                                 f"against {enc}, sends {sent.tolist()} against {sends}")
    kw = dict(gas=TRAIN["gas"], precision="bf16", remat="full", kernels=True)
    cfg = train_config(arch)
    for p in (dict(pp=world), dict(dp=world, zero=3)):
        steps, peak = _sharded_steps(cfg, ParallelPlan(**p, **kw),
                                     _batches(cfg.vocab_size, TRAIN["seq_len"],
                                              TRAIN["global_batch"], 3, cfg), 0, tele=True)
        rel0 = _rel(steps[0], step0[arch])
        emit({"phase": f"{cfg.family}_ranks", "rank": rank, "arch": cfg.name, "plan": p,
              "steps": steps, "single_device_step0": step0[arch], "rel_diff": rel0,
              "rtol": STEP0_RTOL[arch], "peak_mem_gb": peak})
        if any(rel0[k] > STEP0_RTOL[arch][k] for k in rel0):
            raise AssertionError(f"rank {rank}: {arch} {p} step 0 vs phase 4's: {rel0}")
    dist.destroy_process_group()


# phase "dryrun": the trace's peak against the card's, as a share of it
DRYRUN_ARCH, DRYRUN_LAYERS = "yi-6b", 8
DRYRUN_PEAK_BAND = (0.9, 1.1)
# a production record, traced on the host only (kept while under 60 s)
DRYRUN_PRODUCTION = ("qwen3-32b", "train_4k")
# hillclimb plans on "16x16" (the meta device, 256 fake ranks) that the
# port's sharding rules run since per-block tensor parallelism and sequence
# parallelism: (pair, variant) of launch/hillclimb.py, each must trace ok
DRYRUN_HILLCLIMB = (("arctic", "baseline"), ("qwen3", "fsdp_seq"))


def phase_dryrun(card: str) -> None:
    """``dryrun_one`` with ``measure``: the traced FLOPs must equal the
    card's step's and the traced peak lie in DRYRUN_PEAK_BAND of the
    card's; the production record and DRYRUN_HILLCLIMB's must trace
    ``ok``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.runtime.train_loop import ParallelPlan

    cfg = dataclasses.replace(get_config(DRYRUN_ARCH), n_layers=DRYRUN_LAYERS)
    shape = InputShape("train_chip", "train", TRAIN["seq_len"], TRAIN["global_batch"])
    plan = ParallelPlan(gas=TRAIN["gas"], precision="bf16", remat="full", kernels=False)
    rec = dryrun.dryrun_one(DRYRUN_ARCH, shape, multi_pod=False, plan=plan, cfg=cfg,
                            measure=True, verbose=False)
    if rec["status"] != "ok":
        raise AssertionError(f"dry run of {DRYRUN_ARCH}: {rec.get('error')}\n"
                             f"{rec.get('traceback')}")
    torch.cuda.empty_cache()
    prod = dryrun.dryrun_one(*DRYRUN_PRODUCTION, multi_pod=False, verbose=False)
    climbed = {f"{pair}:{variant}": hillclimb.run_variant(pair, variant)
               for pair, variant in DRYRUN_HILLCLIMB}
    m, peak = rec["measured"], rec["memory_analysis"]["peak_bytes"]
    ratio = peak / m["peak_bytes"]
    emit({"phase": "dryrun", "arch": DRYRUN_ARCH, "layers": DRYRUN_LAYERS, "plan": "1x1 " +
          rec["plan"], "traced_peak_bytes": peak, "measured_peak_bytes": m["peak_bytes"],
          "peak_ratio": ratio, "peak_band": DRYRUN_PEAK_BAND,
          "traced_flops": rec["flops_per_device"], "measured_flops": m["flops"],
          "traced_bytes": rec["bytes_per_device"], "roofline": rec["roofline"],
          "measured_step_s": m["step_s"], "measured_step_s_all": m["step_s_all"],
          "state_bytes": rec["state_bytes"], "trace_s": rec["trace_s"],
          "production": {k: prod.get(k) for k in (
              "arch", "shape", "mesh", "chips", "status", "error", "trace_s",
              "flops_per_device", "bytes_per_device", "collective_bytes",
              "memory_analysis", "state_bytes", "roofline", "useful_flops_ratio")},
          "hillclimb": {tag: {k: r.get(k) for k in (
              "mesh", "chips", "status", "error", "trace_s", "flops_per_device",
              "bytes_per_device", "collective_bytes", "memory_analysis", "state_bytes",
              "roofline")} for tag, r in climbed.items()},
          "card": card, "measured_card": m["card"]})
    if rec["flops_per_device"] != m["flops"]:
        raise AssertionError(f"traced FLOPs {rec['flops_per_device']} != the card's "
                             f"{m['flops']}")
    if not DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1]:
        raise AssertionError(f"traced peak {peak} is {ratio:.4f} of the card's "
                             f"{m['peak_bytes']}, outside {DRYRUN_PEAK_BAND}")
    if prod["status"] != "ok":
        raise AssertionError(f"production dry run {DRYRUN_PRODUCTION}: {prod.get('error')}")
    for tag, r in climbed.items():
        if r["status"] != "ok" or r["mesh"] != "16x16":
            raise AssertionError(f"hillclimb {tag} on {r.get('mesh')}: {r['status']} "
                                 f"{r.get('error')}")


# phase "checkpoint": gpt-1.4b at full width, 2 of 24 layers (323M
# parameters: 3.9 GB of fp32 parameters and Adam moments), TRAIN's plan
CKPT_ARCH, CKPT_LAYERS, CKPT_STEPS, CKPT_SAVE_AT = "gpt-1.4b", 2, 4, 2


def phase_checkpoint(card: str) -> dict:
    """4 steps straight (twice), against 2 steps, a save, a restore into a
    fresh model and state, and 2 steps: losses and final parameters."""
    import shutil

    from repro_torch.checkpointing import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_loop import (ParallelPlan, build_train_step,
                                                init_train_state)

    cfg = dataclasses.replace(get_config(CKPT_ARCH), n_layers=CKPT_LAYERS)
    plan = ParallelPlan(gas=TRAIN["gas"], precision="bf16", remat="full", kernels=True)
    batches = _batches(cfg.vocab_size, TRAIN["seq_len"], TRAIN["global_batch"], CKPT_STEPS)
    opt = AdamWConfig(lr=TRAIN_LR)
    where = ROOT / "build" / "checkpoint"
    shutil.rmtree(where, ignore_errors=True)

    def fresh(seed: int):
        model = Model(cfg, torch.float32, device="cuda")
        state = init_train_state(model, opt, plan,
                                 torch.Generator(device="cuda").manual_seed(seed))
        return model, state, build_train_step(model, opt, plan)

    def steps(step, state, bs) -> list[float]:
        return [float(step(state, b)[1]["loss"]) for b in bs]

    def weights(model) -> dict:
        return {k: p.detach().cpu().clone() for k, p in model.named_parameters()}

    straight = []
    ops.reset_launch_counts()
    for _ in range(2):
        model, state, step = fresh(0)
        straight.append((steps(step, state, batches), weights(model)))
        del model, state, step
    launches = dict(ops.launch_counts())
    model, state, step = fresh(0)
    first = steps(step, state, batches[:CKPT_SAVE_AT])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(str(where), CKPT_SAVE_AT, state)
    save_s = time.perf_counter() - t0
    disk = sum(f.stat().st_size for f in where.rglob("*") if f.is_file())
    del model, state, step
    torch.cuda.empty_cache()
    model, state, step = fresh(1)
    t0 = time.perf_counter()
    state = restore_checkpoint(str(where), CKPT_SAVE_AT, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    resumed = first + steps(step, state, batches[CKPT_SAVE_AT:])
    final = weights(model)
    del model, state, step
    shutil.rmtree(where, ignore_errors=True)
    torch.cuda.empty_cache()

    (loss_a, w_a), (loss_b, w_b) = straight
    spread_w = max(float((w_a[k] - w_b[k]).abs().max()) for k in w_a)
    diff_w = max(float((w_a[k] - final[k]).abs().max()) for k in w_a)
    spread_l = max(abs(a - b) for a, b in zip(loss_a, loss_b))
    diff_l = max(abs(a - b) for a, b in zip(loss_a, resumed))
    emit({"phase": "checkpoint", "arch": CKPT_ARCH, "layers": CKPT_LAYERS,
          "params": sum(v.numel() for v in final.values()), "steps": CKPT_STEPS,
          "saved_at": CKPT_SAVE_AT, "straight_losses": straight[0][0],
          "straight_again_losses": straight[1][0], "resumed_losses": resumed,
          "straight_spread": {"loss": spread_l, "weights": spread_w},
          "resumed_vs_straight": {"loss": diff_l, "weights": diff_w},
          "save_s": save_s, "restore_s": restore_s, "bytes_on_disk": disk,
          "launches": launches, "card": card})
    if spread_l == spread_w == 0.0:
        if diff_l or diff_w:
            raise AssertionError(f"resumed run differs from the straight run, which is "
                                 f"bit-equal to itself: loss {diff_l}, weights {diff_w}")
    elif diff_l > spread_l or diff_w > spread_w:
        raise AssertionError(f"resumed run off by loss {diff_l}, weights {diff_w}: outside "
                             f"the straight runs' spread {spread_l}, {spread_w}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    previous = start_previous_build()
    report = _build.build_all()
    finish_previous_build(previous)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "ptxas": {name: [ln.strip() for ln in r["log"].splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, r in report.items()}})

    t_start = time.perf_counter()
    seconds = {}

    def timed(name: str, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t
        return out

    timer = Timer()
    # first: the profiler missed this short kernel's device time when it ran
    # after the other kernel phases, in the same process
    qk_rows = timed("rmsnorm qk", lambda: phase_rmsnorm_qk(timer))
    rows = timed("kernels", lambda: phase_kernels(timer))
    rows.update(timed("kernels train", lambda: phase_kernels_train(timer)))
    rows.update(timed("kernels moe", lambda: phase_kernels_moe(timer)))
    rows.update(timed("kernels ssm", lambda: phase_kernels_ssm(timer)))
    rows.update(timed("kernels wkv", lambda: phase_kernels_wkv(timer)))
    for name, extra in timed("flash hd80", lambda: flash_hd80(timer)).items():
        rows[name]["cases"] += extra
    for name, extra in timed("kernels tp", lambda: phase_kernels_tp(timer)).items():
        rows[name]["cases"] += extra
    for name, extra in timed("kernels seq", lambda: phase_kernels_seq(timer)).items():
        rows[name]["cases"] += extra
    for name, extra in timed("kernels serve", lambda: phase_kernels_serve(timer)).items():
        rows[name]["cases"] += extra
    for name, extra in timed("kernels encdec", lambda: phase_kernels_encdec(timer)).items():
        rows[name]["cases"] += extra
    for name, extra in timed("kernels vlm", lambda: phase_kernels_vlm(timer)).items():
        rows[name]["cases"] += extra
    rows["rmsnorm"]["cases"] += qk_rows
    del timer
    torch.cuda.empty_cache()
    # each path's counts are zeroed just before it runs and read just after
    paths = {}
    for arch in SERVE_KERNELS:
        paths.update(timed(f"{arch} serve", lambda: phase_serve(card, arch)))
    for arch in TRAIN_KERNELS:
        paths[f"{arch} train"] = timed(f"{arch} train", lambda: phase_train(card, arch))
    timed("gemm", lambda: phase_gemm(card))
    for arch in REMAT_ARCHS:
        paths.update(timed(f"{arch} remat", lambda: phase_remat(card, arch)))
    paths[f"{ENTRY_ARCH} entry"] = timed("entry", lambda: phase_entry(card))
    paths.update(timed("parallel", lambda: phase_parallel(card)))
    paths[f"{PIPELINE_ARCH} pipeline"] = timed("pipeline", lambda: phase_pipeline(card))
    timed("dryrun", lambda: phase_dryrun(card))
    paths[f"{CKPT_ARCH} checkpoint"] = timed("checkpoint", lambda: phase_checkpoint(card))
    emit({"phase": "done", "seconds_after_build": time.perf_counter() - t_start,
          "seconds_by_phase": seconds})
    by_path = {name: {path: n[name] for path, n in paths.items() if name in n}
               for name in KERNELS}
    # ``launches``: the kernel's count in the first of these paths that runs
    # it: the gpt-1.4b train step, the yi-6b train step, the zamba2 train
    # step, the arctic train step (the grouped MLP), the llama4-maverick
    # serve run, the zamba2 serve run (the mamba decode step), the rwkv6
    # train step (the wkv scan), the rwkv6 serve run (the wkv decode step)
    order = ("gpt-1.4b train", "yi-6b train", f"{ZAMBA} train", f"{ARCTIC} train",
             f"{LLAMA4} serve", f"{ZAMBA} serve", f"{RWKV} train", f"{RWKV} serve")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
         "replaces": replaces,
         "launches": next(by_path[name][p] for p in order if p in by_path[name]),
         "launches_by_path": by_path[name], **rows[name], "card": card,
         **({"ptxas": {k: v for kernel in REDESIGNED[name] for k, v in ptxas_summary(
             report[src[:-3]]["log"]
             or _build.lib_path(src[:-3]).with_suffix(".log").read_text(), kernel).items()}}
            if name in REDESIGNED else {})}
        for name, (src, replaces) in KERNELS.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
