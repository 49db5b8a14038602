// FlashAttention backward for Hopper: dQ, and dK/dV summed over each KV
// head's G query heads, from Q, K, V, dO, the forward's fp32 row LSE and
// delta = rowsum(dO * O).
//
// Replaces: repro/kernels/flash_attention.py:_bwd_dq_kernel and
//   _bwd_dkv_kernel (via flash_attention_bwd).  Both recompute
//   P = exp(S - LSE) with S = cap(Q K^T / sqrt(hd)) and the causal,
//   sliding-window and q_offset masks; dP = dO V^T; dS = P (dP - delta),
//   times 1 - t^2 under the softcap t = tanh(s/c); dQ = dS K / sqrt(hd),
//   dK = dS^T Q / sqrt(hd), dV = P^T dO.
// Bound on the H100: operations.  dQ does three products over the unmasked
//   (query, key) pairs (S, dP, dS K), dK/dV four (S^T, dP^T, P^T dO,
//   dS^T Q), each 2*hd FLOP a pair: at yi-6b's train microbatch (4 x 2048
//   tokens, 32 query heads of 128, causal) 0.209 and 0.278 ms at 989
//   TFLOP/s, against ~0.03 ms to read Q, K, V, dO and write the gradients.
//   So the tensor cores have to be kept busy, as in the forward.
// Design: the TPU kernels carry dQ (grid axis nk) and dK/dV (grid axes G
//   and nq) in VMEM across sequential grid steps.  Blocks on the H100 run in
//   no order, so each work item owns its output rows and loops itself, and
//   every sum runs in one block in a fixed order: no atomics, and two
//   launches on the same inputs give the same bits.
//   bf16 (FlashAttention-3's backward without its dQ atomics: two kernels,
//   seven products where FA-3 does five): both take the forward's shape
//   (csrc/flash_attention.cu, on csrc/flash_common.cuh and csrc/hopper.cuh)
//   -- a persistent grid of one block per SM taking items as it comes
//   free; a producer warp issuing TMA copies (4-D tensor maps over
//   (hd, H, S, B), 128-byte swizzle) into an mbarrier ring; two consumer
//   warpgroups on wgmma; the mask applied by select only on tiles that
//   cross an edge (the causal diagonal, the window, Sq or Skv).  P works in
//   base 2: log2(e) folds into the score's scale and the LSE (a natural
//   log) is converted once.  A masked pair gets p = 0 by select, never
//   exp(-1e30 - lse), so rows that see no key and rows past Sq or Skv
//   contribute nothing.  The elementwise loop between the products is
//   compiled once per (softcap, edge) pair and chosen per tile: with a
//   run-time softcap test inside it the kernels ran 1.2-1.6x slower on an
//   H100 (tools/kernel_ab.py).
//   - dQ: the forward's item (b, h, 128 query rows, its order: L2 chunks of
//     whole GQA groups, the longest causal rows first); Q, dO, LSE and
//     delta once per item, K and V in 64-key tiles through a 4-stage ring.
//     Each warpgroup owns 64 rows, whose Q and dO it holds in registers
//     (ldmatrix from the swizzled tile; their stage then refills with the
//     next item's): S = Q K^T and dP = dO V^T as wgmma with A from
//     registers, dS in registers, dQ += dS K as wgmma with dS (bf16) from
//     registers and K in its MN-major layout (64 fp32 registers a thread at
//     hd 128).  The rows' LSE and delta sit in shared memory (in registers
//     they would spill at hd 128).  The S and dP of tile i are issued
//     before the dS K of tile i - 1, so dS is computed while the tensor
//     cores run.
//   - dK/dV: an item is (b, KV head, 128 keys); each warpgroup owns 64 keys
//     and holds dK and dV in fp32 registers across the item's G query heads
//     and the query tiles that see its keys, so the group sum stays in the
//     block and K and V are loaded once an item.  The producer warp streams
//     64-row tiles of Q and dO and their LSE and delta (plain loads into the
//     stage) through a 3-stage ring; both warpgroups read each tile.  Per
//     tile S^T = K Q^T and dP^T = V dO^T (wgmma, shared memory), P^T and
//     dS^T in registers, dV += P^T dO and dK += dS^T Q (wgmma, P^T and dS^T
//     bf16 from registers, dO and Q MN-major).  At hd <= 96 the S^T and
//     dP^T of tile i are issued before the products of tile i - 1; at hd
//     128 the 128 accumulators of dK and dV leave no room for that.  Items
//     run in chunks of (b, KV head) pairs whose G heads' Q and dO fit a
//     third of the L2 (MHA at 4 x 2048 tokens would otherwise read them
//     from device memory once per key tile), key tile by key tile within,
//     the first (longest under a causal mask) first; a chunk holds at least
//     two waves of items, since at yi-6b's microbatch (G = 8) the longest
//     item is nearly an SM's share and has to start first.
//   - Both stage their bf16 output (dQ and dK times 1/sqrt(hd)) in swizzled
//     shared memory and TMA-store it, clipped to hd and to Sq or Skv.
//   Head dims: a tile row is one or two 64-column boxes; TMA fills columns
//   past hd with zeros, so the contractions over hd (S, dP and their
//   transposes) run hd 88 as 96, and the products whose n is hd run as
//   wgmma n = 64, 80, 88 or 128.
//   fp32: FFMA only (no TF32) so the check against the plain fp32 version
//   stays tight, one key per lane for the scores as in the forward; the
//   fp32 dQ kernel pads hd to a multiple of 32 lanes, the fp32 dK/dV kernel
//   splits hd over 4 threads, which 80 and 88 allow.
#include <type_traits>

#include "flash_common.cuh"

using bf16 = __nv_bfloat16;
using namespace flash;

namespace {

struct Params {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    const float* lse;     // (B, Hq, Sq)
    const float* delta;   // (B, Hq, Sq)
    void* dq;
    void* dk;
    void* dv;
    int B, Hq, Hkv, Sq, Skv;
    long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
        do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh,
        dv_sb, dv_ss, dv_sh;
    int causal, window, q_offset;   // window <= 0: no window
    float softcap, scale;           // softcap <= 0: no cap
    int chunk;                      // bf16 dQ: (b, h) pairs per chunk of its work order
    int kv_chunk;                   // bf16 dK/dV: (b, KV head) pairs per chunk of its order
};

// From the raw product q.k: (p, dS / (dP - delta)), i.e. the probability and
// the softcap Jacobian; p = 0 for a masked pair or a row past Sq.
__device__ __forceinline__ void prob(const Params& p, float s, float lse, int qrow,
                                     int kpos, float& pe, float& jac) {
    s *= p.scale;
    jac = 1.f;
    if (p.softcap > 0.f) {
        const float t = tanhf(s / p.softcap);
        s = t * p.softcap;
        jac = 1.f - t * t;
    }
    const int qpos = qrow + p.q_offset;
    bool ok = kpos < p.Skv && qrow < p.Sq;
    if (p.causal) ok = ok && kpos <= qpos;
    if (p.window > 0) ok = ok && qpos - kpos < p.window;
    pe = ok ? expf(s - lse) : 0.f;
}

// ---------------------------------------------------------------------------
// bf16: persistent, TMA ring, wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int THREADS = 384;    // producer warpgroup + two consumers
constexpr int DQ_BM = 128;      // dQ: query rows of an item
constexpr int DQ_BN = 64;       // dQ: keys of a tile
constexpr int DQ_STAGES = 4;    // dQ: K/V ring depth
constexpr int DKV_BN = 128;     // dK/dV: keys of an item
constexpr int DKV_BM = 64;      // dK/dV: query rows of a tile
constexpr int DKV_STAGES = 3;   // dK/dV: Q/dO ring depth

// A dQ item: query rows [q0, q0 + 128) of (b, h) and the key tiles they see,
// walked from the last (k0 = kstart + (ntiles - 1) * 64) back to the first.
struct DqWork {
    int q0, h, b, kstart, ntiles;
};

__host__ __device__ inline DqWork dq_work_of(const Params& p, int item) {
    const QItem qi = q_item(item, p.B, p.Hq, p.Sq, p.chunk, p.causal, DQ_BM);
    int lo, hi;
    key_range(p, qi.q0, imin(qi.q0 + DQ_BM, p.Sq), lo, hi);
    const int kstart = lo / DQ_BN * DQ_BN;
    return {qi.q0, qi.h, qi.b, kstart, hi > kstart ? cdiv(hi - kstart, DQ_BN) : 0};
}

// A dK/dV item: keys [k0, k0 + 128) of (b, KV head hk) and the query tiles
// [qstart + 64 i) (i < nq) that see them, walked for each of the G query
// heads of the group in turn.  Items run in chunks of p.kv_chunk (b, hk)
// pairs (b-major) whose G heads' Q and dO stay in the L2 while the chunk
// runs; within a chunk key tile by key tile (the first, longest under a
// causal mask, first), pair by pair: q_item's order over keys, ascending.
struct DkvWork {
    int k0, hk, b, qstart, nq;
};

__host__ __device__ inline DkvWork dkv_work_of(const Params& p, int item) {
    const QItem ki = q_item(item, p.B, p.Hkv, p.Skv, p.kv_chunk, 0, DKV_BN);
    int lo, hi;
    query_range(p, ki.q0, imin(ki.q0 + DKV_BN, p.Skv), lo, hi);
    const int qstart = lo / DKV_BM * DKV_BM;
    return {ki.q0, ki.h, ki.b, qstart, hi > qstart ? cdiv(hi - qstart, DKV_BM) : 0};
}

// (b, KV head) pairs per chunk of the dK/dV order: as many as keep their G
// heads' Q and dO (bf16, hd padded to 16) within L2_CHUNK_BYTES, but enough
// for two waves of items on `sms` blocks, so that a chunk's longest items
// start while its shortest fill the tail; spread evenly over the chunks.
int dkv_chunk(int B, int Hq, int Hkv, int Sq, int Skv, int hd, int sms) {
    const int pairs = B * Hkv;
    const long long pair_bytes = 2ll * (Hq / Hkv) * Sq * pad16(hd) * 2;
    long long per = L2_CHUNK_BYTES / (pair_bytes > 0 ? pair_bytes : 1);
    per = per > 1 ? per : 1;
    const int wave = cdiv(2 * sms, cdiv(Skv, DKV_BN));
    per = per > wave ? per : wave;
    if (per >= pairs) return pairs;
    return cdiv(pairs, cdiv(pairs, (int)per));
}

template <int HD>
struct Dq {
    static constexpr int NBOX = (HD + BOX - 1) / BOX;     // boxes per row: 1 or 2
    static constexpr int KSTEPS = pad16(HD) / 16;         // k16 steps over hd
    static constexpr int Q_BOX = DQ_BM * 128;             // bytes of one box
    static constexpr int KV_BOX = DQ_BN * 128;
    static constexpr int O_BOX = WG_ROWS * 128;           // a consumer's rows
    static constexpr int Q_BYTES = NBOX * Q_BOX;          // Q or dO
    static constexpr int KV_BYTES = NBOX * KV_BOX;        // a K or V tile
    static constexpr int O_BYTES = 2 * NBOX * O_BOX;      // the output's staging
    static constexpr int ROW_BYTES = 2 * WG_ROWS * 2 * 4; // each consumer's LSE*log2(e), delta
    // q_full, q_empty, kv full and empty of each stage
    static constexpr int BARRIERS = 2 + 2 * DQ_STAGES;
    static constexpr int SMEM = hopper::SMEM_ALIGN + 2 * Q_BYTES + 2 * DQ_STAGES * KV_BYTES
                                + O_BYTES + ROW_BYTES + 8 + 8 * BARRIERS;   // the item slot
};

template <int HD>
struct Dkv {
    static constexpr int NBOX = (HD + BOX - 1) / BOX;
    static constexpr int KSTEPS = pad16(HD) / 16;
    static constexpr int K_BOX = DKV_BN * 128;
    static constexpr int T_BOX = DKV_BM * 128;
    static constexpr int O_BOX = WG_ROWS * 128;
    static constexpr int K_BYTES = NBOX * K_BOX;          // K or V of an item
    static constexpr int T_BYTES = NBOX * T_BOX;          // a Q or dO tile
    static constexpr int O_BYTES = 2 * 2 * NBOX * O_BOX;  // dK and dV staging of both consumers
    static constexpr int ROW_BYTES = 2 * DKV_STAGES * DKV_BM * 4;   // LSE*log2(e), delta
    // kv_full, kv_empty, tile full and empty of each stage
    static constexpr int BARRIERS = 2 + 2 * DKV_STAGES;
    static constexpr int SMEM = hopper::SMEM_ALIGN + 2 * K_BYTES + 2 * DKV_STAGES * T_BYTES
                                + O_BYTES + ROW_BYTES + 8 + 8 * BARRIERS;
    // issue the next tile's S^T and dP^T before this tile's products: room
    // for 64 more fp32 accumulators beside dK and dV
    static constexpr bool PIPELINE = HD <= 96;
};

// The persistent grids' next items, as in the forward: every block ends
// with one fetch past the last item; the block whose fetch is the last of
// those resets the count for the next launch.
__device__ unsigned int dq_next_item = 0;
__device__ unsigned int dkv_next_item = 0;

// The score s (the raw q.k) to base-2 exponent units: s * c, or under the
// softcap (CAP) tanh(s * cap_in) * c with the Jacobian 1 - t^2.
struct Score {
    bool cap;
    float c, cap_in;
    __device__ __forceinline__ Score(const Params& p)
        : cap(p.softcap > 0.f), c((p.softcap > 0.f ? p.softcap : p.scale) * LOG2E),
          cap_in(p.scale / (p.softcap > 0.f ? p.softcap : 1.f)) {}
    template <bool CAP>
    __device__ __forceinline__ float x(float s, float& jac) const {
        if constexpr (CAP) {
            const float t = tanhf(s * cap_in);
            jac = 1.f - t * t;
            return t * c;
        }
        jac = 1.f;
        return s * c;
    }
};

// body(cap, edge) with both as compile-time constants (std::bool_constant),
// so the per-element loops carry no branch on the softcap or the mask.
template <class F>
__device__ __forceinline__ void specialised(bool cap, bool edge, F&& body) {
    using T = std::true_type;
    using N = std::false_type;
    if (cap) {
        if (edge) body(T{}, T{});
        else body(T{}, N{});
    } else {
        if (edge) body(N{}, T{});
        else body(N{}, N{});
    }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap dqmap, const Params p,
                         int items) {
    using C = Dq<HD>;
    constexpr int S = DQ_STAGES;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* Qs = hopper::align_smem(smem_raw);
    unsigned char* dOs = Qs + C::Q_BYTES;
    unsigned char* Ks = dOs + C::Q_BYTES;
    unsigned char* Vs = Ks + S * C::KV_BYTES;
    unsigned char* Os = Vs + S * C::KV_BYTES;
    float* rows_s = reinterpret_cast<float*>(Os + C::O_BYTES);   // [2][64][2]
    volatile int* item_slot =
        reinterpret_cast<volatile int*>(Os + C::O_BYTES + C::ROW_BYTES);   // -1: done
    uint64_t* q_full = reinterpret_cast<uint64_t*>(Os + C::O_BYTES + C::ROW_BYTES + 8);
    uint64_t* q_empty = q_full + 1;
    uint64_t* kv_full = q_empty + 1;
    uint64_t* kv_empty = kv_full + S;

    const int wg = threadIdx.x / 128;
    if (threadIdx.x == 0) {
        hopper::mbar_init(q_full, 1);
        hopper::mbar_init(q_empty, 8);              // each consumer warp arrives
        for (int s = 0; s < S; ++s) {
            hopper::mbar_init(&kv_full[s], 1);
            hopper::mbar_init(&kv_empty[s], 8);
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();

    if (wg == 0) {
        // producer: one thread keeps the ring full, across items.  Q and dO
        // are released once the consumers hold them in registers, a K/V
        // stage once its dQ product is done.
        hopper::reg_dealloc<24>();
        if (threadIdx.x == 0) {
            hopper::prefetch_map(&qmap);
            hopper::prefetch_map(&domap);
            hopper::prefetch_map(&kmap);
            hopper::prefetch_map(&vmap);
            int g = 0;                               // K/V tiles loaded so far
            for (int n = 0;; ++n) {
                const int item = (int)atomicAdd(&dq_next_item, 1u);
                if (n > 0) hopper::mbar_wait(q_empty, (n - 1) & 1);
                if (item >= items) {
                    *item_slot = -1;
                    hopper::mbar_arrive(q_full);
                    if (item == items + (int)gridDim.x - 1) atomicExch(&dq_next_item, 0u);
                    break;
                }
                *item_slot = item;
                const DqWork w = dq_work_of(p, item);
                const int hk = w.h / (p.Hq / p.Hkv);
                hopper::mbar_expect_tx(q_full, 2 * C::Q_BYTES);
                for (int c = 0; c < C::NBOX; ++c) {
                    hopper::tma_load_4d_hint(Qs + c * C::Q_BOX, &qmap, q_full, c * BOX, w.h,
                                             w.q0, w.b, hopper::EVICT_FIRST);
                    hopper::tma_load_4d_hint(dOs + c * C::Q_BOX, &domap, q_full, c * BOX, w.h,
                                             w.q0, w.b, hopper::EVICT_FIRST);
                }
                for (int it = 0; it < w.ntiles; ++it, ++g) {
                    const int s = g % S;
                    const int k0 = w.kstart + (w.ntiles - 1 - it) * DQ_BN;
                    if (g >= S) hopper::mbar_wait(&kv_empty[s], ((g / S) & 1) ^ 1);
                    hopper::mbar_expect_tx(&kv_full[s], 2 * C::KV_BYTES);
                    for (int c = 0; c < C::NBOX; ++c) {
                        hopper::tma_load_4d_hint(Ks + s * C::KV_BYTES + c * C::KV_BOX, &kmap,
                                                 &kv_full[s], c * BOX, hk, k0, w.b,
                                                 hopper::EVICT_LAST);
                        hopper::tma_load_4d_hint(Vs + s * C::KV_BYTES + c * C::KV_BOX, &vmap,
                                                 &kv_full[s], c * BOX, hk, k0, w.b,
                                                 hopper::EVICT_LAST);
                    }
                }
            }
        }
    } else {
        // consumers: S and dP of tile i are computed while dQ += dS K of tile
        // i - 1 runs (FA-3's intra-warpgroup pipelining)
        hopper::reg_alloc<240>();
        const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32;
        const int rw = (t / 32) * 16 + lane / 4;       // rows rw, rw + 8 of the warpgroup's 64
        unsigned char* Ow = Os + cw * C::NBOX * C::O_BOX;
        float* rows = rows_s + cw * WG_ROWS * 2;       // this warpgroup's (LSE2, delta) pairs
        const Score score(p);

        float dq[HD / 2];
        float sc[32], dp[32];             // S then dS in fp32; dP
        uint32_t qa[C::KSTEPS][4];        // this warp's Q and dO rows: the A operands
        uint32_t oa[C::KSTEPS][4];        // of S and dP, per k16 step
        uint32_t da[4][4];                // dS in bf16: dS K's A operand
        int g0 = 0;                       // K/V tiles consumed before this item

        for (int n = 0;; ++n) {
            hopper::mbar_wait(q_full, n & 1);
            const int item = *item_slot;
            if (item < 0) break;
            // Q and dO into registers; their shared memory goes back to the
            // producer for the next item
#pragma unroll
            for (int kk = 0; kk < C::KSTEPS; ++kk) {
                load_a(qa[kk], Qs, C::Q_BOX, cw * WG_ROWS, kk, t / 32, lane);
                load_a(oa[kk], dOs, C::Q_BOX, cw * WG_ROWS, kk, t / 32, lane);
            }
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(q_empty);
            const DqWork w = dq_work_of(p, item);
            const int r_lo = w.q0 + cw * WG_ROWS;          // this warpgroup's rows
            const int row0 = r_lo + rw;
            // the rows' LSE (base 2) and delta into shared memory, read
            // for each tile (held in registers they would spill at hd 128);
            // rows past Sq take 0 and are never stored
            if (lane % 4 == 0) {
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const bool in = row0 + 8 * r < p.Sq;
                    const size_t i = ((size_t)w.b * p.Hq + w.h) * p.Sq + row0 + 8 * r;
                    rows[2 * (rw + 8 * r)] = in ? p.lse[i] * LOG2E : 0.f;
                    rows[2 * (rw + 8 * r) + 1] = in ? p.delta[i] : 0.f;
                }
            }
            __syncwarp();

            // S and dP of tile `it` (committed, not waited for)
            auto issue_sdp = [&](int it) {
                const int g = g0 + it, s = g % S;
                hopper::mbar_wait(&kv_full[s], (g / S) & 1);
                const uint64_t kd = hopper::desc(Ks + s * C::KV_BYTES, 16, 1024);
                const uint64_t vd = hopper::desc(Vs + s * C::KV_BYTES, 16, 1024);
                hopper::wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < C::KSTEPS; ++kk) {
                    // a k16 step: 32 bytes along the row, 4 to a 64-column box
                    const int b_off = (kk / 4) * C::KV_BOX + (kk % 4) * 32;
                    hopper::wgmma_rs<0>(sc, qa[kk], kd + hopper::desc_offset(b_off), kk > 0);
                }
#pragma unroll
                for (int kk = 0; kk < C::KSTEPS; ++kk) {
                    const int b_off = (kk / 4) * C::KV_BOX + (kk % 4) * 32;
                    hopper::wgmma_rs<0>(dp, oa[kk], vd + hopper::desc_offset(b_off), kk > 0);
                }
                hopper::wgmma_commit();
            };
            // dQ += dS K of tile `it` (committed, not waited for)
            auto issue_dq = [&](int it) {
                const int s = (g0 + it) % S;
                const uint64_t kt = hopper::desc(Ks + s * C::KV_BYTES, C::KV_BOX, 1024);
                hopper::wgmma_fence();
#pragma unroll
                for (int kc = 0; kc < DQ_BN / 16; ++kc)
                    hopper::wgmma_rs<1>(dq, da[kc], kt + hopper::desc_offset(kc * 16 * 128), 1);
                hopper::wgmma_commit();
            };
            // S and dP of tile `it` are done
            auto sdp_done = [&]() {
                hopper::fence_regs(sc);
                hopper::fence_regs(dp);
            };
            // dS of tile `it` in fp32, in sc
            auto dscores = [&](int it) {
                const int k0 = w.kstart + (w.ntiles - 1 - it) * DQ_BN;
                const float2 r0 = *reinterpret_cast<const float2*>(rows + 2 * rw);
                const float2 r8 = *reinterpret_cast<const float2*>(rows + 2 * (rw + 8));
                const float lse2[2] = {r0.x, r8.x}, dlt[2] = {r0.y, r8.y};
                const bool edge = rows_edge(p, r_lo, k0, DQ_BN);
                // row r sees keys [klo, khi]; offsets from this thread's
                // first column k0 + 2 * (lane % 4)
                int klo[2] = {0, 0}, khi[2] = {0, 0};
                if (edge) {
#pragma unroll
                    for (int r = 0; r < 2; ++r)
                        row_keys(p, row0 + 8 * r + p.q_offset, k0 + 2 * (lane % 4), klo[r],
                                 khi[r]);
                }
                specialised(score.cap, edge, [&](auto cap_c, auto edge_c) {
                    constexpr bool CAP = decltype(cap_c)::value, EDGE = decltype(edge_c)::value;
#pragma unroll
                    for (int j = 0; j < DQ_BN / 8; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int i = 4 * j + e, r = e >> 1, kk = 8 * j + (e & 1);
                            float jac;
                            float pe = hopper::ex2(score.x<CAP>(sc[i], jac) - lse2[r]);
                            if constexpr (EDGE) pe = kk >= klo[r] && kk <= khi[r] ? pe : 0.f;
                            sc[i] = pe * (dp[i] - dlt[r]) * jac;
                        }
                });
            };
            // dS to bf16, once the dS K before has finished
            auto to_operand = [&]() {
#pragma unroll
                for (int j = 0; j < DQ_BN / 8; ++j) {
                    da[j / 2][2 * (j % 2)] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
                    da[j / 2][2 * (j % 2) + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
                }
            };
            // dS K of tile `it` is done: release its K/V stage
            auto dq_done = [&](int it) {
                hopper::fence_regs(dq);
#pragma unroll
                for (int kc = 0; kc < DQ_BN / 16; ++kc) hopper::fence_regs(da[kc]);
                if (lane == 0) hopper::mbar_arrive(&kv_empty[(g0 + it) % S]);
            };

#pragma unroll
            for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
            if (w.ntiles > 0) {
                issue_sdp(0);
                hopper::wgmma_wait<0>();
                sdp_done();
                dscores(0);
                to_operand();
            }
            for (int it = 1; it < w.ntiles; ++it) {
                issue_sdp(it);
                issue_dq(it - 1);
                hopper::wgmma_wait<1>();      // S and dP of tile it
                sdp_done();
                dscores(it);
                hopper::wgmma_wait<0>();      // dS K of tile it - 1
                dq_done(it - 1);
                to_operand();
            }
            if (w.ntiles > 0) {
                issue_dq(w.ntiles - 1);
                hopper::wgmma_wait<0>();
                dq_done(w.ntiles - 1);
            }
            g0 += w.ntiles;

            // epilogue: dQ / sqrt(hd) in bf16 into this warpgroup's staging
            // rows, then one TMA store (rows past Sq and columns past hd clipped)
            const float scale[2] = {p.scale, p.scale};
            if (t == 0) hopper::bulk_wait_read();    // the last item's store has read it
            hopper::named_sync(1 + cw, 128);
            stage_rows<HD>(Ow, dq, scale, lane, rw);
            hopper::fence_async_smem();
            hopper::named_sync(1 + cw, 128);
            if (t == 0) {
                for (int b = 0; b < C::NBOX; ++b)
                    hopper::tma_store_4d(&dqmap, Ow + b * C::O_BOX, b * BOX, w.h, r_lo, w.b);
                hopper::bulk_commit();
            }
        }
        if (t == 0) hopper::bulk_wait_read();
    }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const __grid_constant__ CUtensorMap dkmap,
                          const __grid_constant__ CUtensorMap dvmap, const Params p,
                          int items) {
    using C = Dkv<HD>;
    constexpr int S = DKV_STAGES;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* Ks = hopper::align_smem(smem_raw);
    unsigned char* Vs = Ks + C::K_BYTES;
    unsigned char* Qs = Vs + C::K_BYTES;
    unsigned char* dOs = Qs + S * C::T_BYTES;
    unsigned char* Os = dOs + S * C::T_BYTES;
    float* lse_s = reinterpret_cast<float*>(Os + C::O_BYTES);   // [S][64]: LSE * log2(e)
    float* dlt_s = lse_s + S * DKV_BM;                           // [S][64]: delta
    volatile int* item_slot = reinterpret_cast<volatile int*>(dlt_s + S * DKV_BM);
    uint64_t* kv_full = reinterpret_cast<uint64_t*>(dlt_s + S * DKV_BM + 2);
    uint64_t* kv_empty = kv_full + 1;
    uint64_t* t_full = kv_empty + 1;
    uint64_t* t_empty = t_full + S;

    const int wg = threadIdx.x / 128;
    const int G = p.Hq / p.Hkv;
    if (threadIdx.x == 0) {
        hopper::mbar_init(kv_full, 1);
        hopper::mbar_init(kv_empty, 8);             // each consumer warp arrives
        for (int s = 0; s < S; ++s) {
            hopper::mbar_init(&t_full[s], 32);      // the producer warp's lanes
            hopper::mbar_init(&t_empty[s], 8);
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();

    if (wg == 0) {
        // producer: one warp keeps the ring full, across items; lane 0 issues
        // the copies, every lane stores two rows' LSE and delta.  K and V
        // are released once the item's last S^T and dP^T are computed, a
        // Q/dO stage once its dV and dK products are.
        hopper::reg_dealloc<24>();
        if (threadIdx.x < 32) {
            const int lane = threadIdx.x;
            if (lane == 0) {
                hopper::prefetch_map(&qmap);
                hopper::prefetch_map(&domap);
                hopper::prefetch_map(&kmap);
                hopper::prefetch_map(&vmap);
            }
            int g = 0;                               // Q/dO tiles loaded so far
            for (int n = 0;; ++n) {
                int item = 0;
                if (lane == 0) item = (int)atomicAdd(&dkv_next_item, 1u);
                item = __shfl_sync(0xffffffffu, item, 0);
                if (n > 0) hopper::mbar_wait(kv_empty, (n - 1) & 1);
                if (item >= items) {
                    if (lane == 0) {
                        *item_slot = -1;
                        hopper::mbar_arrive(kv_full);
                        if (item == items + (int)gridDim.x - 1) atomicExch(&dkv_next_item, 0u);
                    }
                    break;
                }
                const DkvWork w = dkv_work_of(p, item);
                if (lane == 0) {
                    *item_slot = item;
                    hopper::mbar_expect_tx(kv_full, 2 * C::K_BYTES);
                    for (int c = 0; c < C::NBOX; ++c) {
                        hopper::tma_load_4d_hint(Ks + c * C::K_BOX, &kmap, kv_full, c * BOX,
                                                 w.hk, w.k0, w.b, hopper::EVICT_FIRST);
                        hopper::tma_load_4d_hint(Vs + c * C::K_BOX, &vmap, kv_full, c * BOX,
                                                 w.hk, w.k0, w.b, hopper::EVICT_FIRST);
                    }
                }
                const int steps = G * w.nq;
                for (int it = 0; it < steps; ++it, ++g) {
                    const int s = g % S;
                    const int hq = w.hk * G + it / w.nq;
                    const int q0 = w.qstart + (it % w.nq) * DKV_BM;
                    if (g >= S) hopper::mbar_wait(&t_empty[s], ((g / S) & 1) ^ 1);
                    const size_t row = ((size_t)w.b * p.Hq + hq) * p.Sq + q0;
                    for (int r = lane; r < DKV_BM; r += 32) {
                        const bool in = q0 + r < p.Sq;
                        lse_s[s * DKV_BM + r] = in ? p.lse[row + r] * LOG2E : 0.f;
                        dlt_s[s * DKV_BM + r] = in ? p.delta[row + r] : 0.f;
                    }
                    if (lane == 0) {
                        hopper::mbar_expect_tx(&t_full[s], 2 * C::T_BYTES);
                        for (int c = 0; c < C::NBOX; ++c) {
                            hopper::tma_load_4d_hint(Qs + s * C::T_BYTES + c * C::T_BOX, &qmap,
                                                     &t_full[s], c * BOX, hq, q0, w.b,
                                                     hopper::EVICT_LAST);
                            hopper::tma_load_4d_hint(dOs + s * C::T_BYTES + c * C::T_BOX,
                                                     &domap, &t_full[s], c * BOX, hq, q0, w.b,
                                                     hopper::EVICT_LAST);
                        }
                    } else {
                        hopper::mbar_arrive(&t_full[s]);
                    }
                }
            }
        }
    } else {
        hopper::reg_alloc<240>();
        const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32;
        const int rw = (t / 32) * 16 + lane / 4;       // keys rw, rw + 8 of the warpgroup's 64
        unsigned char* Ok = Os + cw * 2 * C::NBOX * C::O_BOX;
        unsigned char* Ov = Ok + C::NBOX * C::O_BOX;
        const uint64_t kd = hopper::desc(Ks + cw * WG_ROWS * 128, 16, 1024);
        const uint64_t vd = hopper::desc(Vs + cw * WG_ROWS * 128, 16, 1024);
        const Score score(p);

        float dk[HD / 2], dv[HD / 2];
        float sc[32], dp[32];             // S^T then P^T in fp32; dP^T then dS^T
        uint32_t pa[4][4], da[4][4];      // P^T and dS^T in bf16: the A operands
        int g0 = 0;                       // Q/dO tiles consumed before this item

        for (int n = 0;; ++n) {
            hopper::mbar_wait(kv_full, n & 1);
            const int item = *item_slot;
            if (item < 0) break;
            const DkvWork w = dkv_work_of(p, item);
            const int steps = G * w.nq;
            const int kw = w.k0 + cw * WG_ROWS;            // this warpgroup's keys
            const int key0 = kw + rw;

            // S^T and dP^T of tile `it` (committed, not waited for)
            auto issue_sdp = [&](int it) {
                const int g = g0 + it, s = g % S;
                hopper::mbar_wait(&t_full[s], (g / S) & 1);
                const uint64_t qd = hopper::desc(Qs + s * C::T_BYTES, 16, 1024);
                const uint64_t dod = hopper::desc(dOs + s * C::T_BYTES, 16, 1024);
                hopper::wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < C::KSTEPS; ++kk) {
                    const int a_off = (kk / 4) * C::K_BOX + (kk % 4) * 32;
                    const int b_off = (kk / 4) * C::T_BOX + (kk % 4) * 32;
                    hopper::wgmma_ss<0>(sc, kd + hopper::desc_offset(a_off),
                                        qd + hopper::desc_offset(b_off), kk > 0);
                }
#pragma unroll
                for (int kk = 0; kk < C::KSTEPS; ++kk) {
                    const int a_off = (kk / 4) * C::K_BOX + (kk % 4) * 32;
                    const int b_off = (kk / 4) * C::T_BOX + (kk % 4) * 32;
                    hopper::wgmma_ss<0>(dp, vd + hopper::desc_offset(a_off),
                                        dod + hopper::desc_offset(b_off), kk > 0);
                }
                hopper::wgmma_commit();
            };
            // dV += P^T dO and dK += dS^T Q of tile `it` (committed)
            auto issue_dkv = [&](int it) {
                const int s = (g0 + it) % S;
                const uint64_t qt = hopper::desc(Qs + s * C::T_BYTES, C::T_BOX, 1024);
                const uint64_t dot = hopper::desc(dOs + s * C::T_BYTES, C::T_BOX, 1024);
                hopper::wgmma_fence();
#pragma unroll
                for (int kc = 0; kc < DKV_BM / 16; ++kc)
                    hopper::wgmma_rs<1>(dv, pa[kc], dot + hopper::desc_offset(kc * 16 * 128), 1);
#pragma unroll
                for (int kc = 0; kc < DKV_BM / 16; ++kc)
                    hopper::wgmma_rs<1>(dk, da[kc], qt + hopper::desc_offset(kc * 16 * 128), 1);
                hopper::wgmma_commit();
            };
            // S^T and dP^T of tile `it` are done: release K and V after the last
            auto sdp_done = [&](int it) {
                hopper::fence_regs(sc);
                hopper::fence_regs(dp);
                if (lane == 0 && it == steps - 1) hopper::mbar_arrive(kv_empty);
            };
            // P^T in sc and dS^T in dp, fp32
            auto scores = [&](int it) {
                const int s = (g0 + it) % S;
                const int q0 = w.qstart + (it % w.nq) * DKV_BM;
                const bool edge = keys_edge(p, kw, q0);
                // key r is seen by query rows [qlo, qhi]; offsets from this
                // thread's first column q0 + 2 * (lane % 4)
                int qlo[2] = {0, 0}, qhi[2] = {0, 0};
                if (edge) {
#pragma unroll
                    for (int r = 0; r < 2; ++r)
                        key_queries(p, key0 + 8 * r, q0 + 2 * (lane % 4), qlo[r], qhi[r]);
                }
                const float* ls = lse_s + s * DKV_BM + 2 * (lane % 4);
                const float* ds = dlt_s + s * DKV_BM + 2 * (lane % 4);
                specialised(score.cap, edge, [&](auto cap_c, auto edge_c) {
                    constexpr bool CAP = decltype(cap_c)::value, EDGE = decltype(edge_c)::value;
#pragma unroll
                    for (int j = 0; j < DKV_BM / 8; ++j) {
                        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j);
                        const float2 d2 = *reinterpret_cast<const float2*>(ds + 8 * j);
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int i = 4 * j + e, r = e >> 1, qq = 8 * j + (e & 1);
                            float jac;
                            float pe =
                                hopper::ex2(score.x<CAP>(sc[i], jac) - (e & 1 ? l2.y : l2.x));
                            if constexpr (EDGE) pe = qq >= qlo[r] && qq <= qhi[r] ? pe : 0.f;
                            sc[i] = pe;
                            dp[i] = pe * (dp[i] - (e & 1 ? d2.y : d2.x)) * jac;
                        }
                    }
                });
            };
            // P^T and dS^T to bf16, once the products before have finished
            auto to_operands = [&]() {
#pragma unroll
                for (int j = 0; j < DKV_BM / 8; ++j) {
                    pa[j / 2][2 * (j % 2)] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
                    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
                    da[j / 2][2 * (j % 2)] = pack_bf16(dp[4 * j], dp[4 * j + 1]);
                    da[j / 2][2 * (j % 2) + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
                }
            };
            // the products of tile `it` are done: release its Q/dO stage
            auto dkv_done = [&](int it) {
                hopper::fence_regs(dk);
                hopper::fence_regs(dv);
#pragma unroll
                for (int kc = 0; kc < DKV_BM / 16; ++kc) {
                    hopper::fence_regs(pa[kc]);
                    hopper::fence_regs(da[kc]);
                }
                if (lane == 0) hopper::mbar_arrive(&t_empty[(g0 + it) % S]);
            };

#pragma unroll
            for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
            if (steps == 0 && lane == 0) hopper::mbar_arrive(kv_empty);
            if constexpr (C::PIPELINE) {
                if (steps > 0) {
                    issue_sdp(0);
                    hopper::wgmma_wait<0>();
                    sdp_done(0);
                    scores(0);
                    to_operands();
                }
                for (int it = 1; it < steps; ++it) {
                    issue_sdp(it);
                    issue_dkv(it - 1);
                    hopper::wgmma_wait<1>();      // S^T and dP^T of tile it
                    sdp_done(it);
                    scores(it);
                    hopper::wgmma_wait<0>();      // the products of tile it - 1
                    dkv_done(it - 1);
                    to_operands();
                }
                if (steps > 0) {
                    issue_dkv(steps - 1);
                    hopper::wgmma_wait<0>();
                    dkv_done(steps - 1);
                }
            } else {
                for (int it = 0; it < steps; ++it) {
                    issue_sdp(it);
                    hopper::wgmma_wait<0>();
                    sdp_done(it);
                    scores(it);
                    to_operands();
                    issue_dkv(it);
                    hopper::wgmma_wait<0>();
                    dkv_done(it);
                }
            }
            g0 += steps;

            // epilogue: dK / sqrt(hd) and dV in bf16 into this warpgroup's
            // staging rows, then TMA stores (keys past Skv, columns past hd
            // clipped)
            const float kscale[2] = {p.scale, p.scale}, one[2] = {1.f, 1.f};
            if (t == 0) hopper::bulk_wait_read();    // the last item's stores have read it
            hopper::named_sync(1 + cw, 128);
            stage_rows<HD>(Ok, dk, kscale, lane, rw);
            stage_rows<HD>(Ov, dv, one, lane, rw);
            hopper::fence_async_smem();
            hopper::named_sync(1 + cw, 128);
            if (t == 0) {
                for (int b = 0; b < C::NBOX; ++b) {
                    hopper::tma_store_4d(&dkmap, Ok + b * C::O_BOX, b * BOX, w.hk, kw, w.b);
                    hopper::tma_store_4d(&dvmap, Ov + b * C::O_BOX, b * BOX, w.hk, kw, w.b);
                }
                hopper::bulk_commit();
            }
        }
        if (t == 0) hopper::bulk_wait_read();
    }
}

// ---------------------------------------------------------------------------
// fp32: FFMA, one key per lane
// ---------------------------------------------------------------------------

constexpr int FBM = 16, FBN = 32, ROWS_PER_WARP = 4;

// Rows [s0, s0 + n) of one head into smem with pitch ld: ``width`` columns
// of which the first hd are read, zero past S and past hd.
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* base,
                                              long long ss, int s0, int n, int S, int hd,
                                              int width) {
    for (int i = threadIdx.x; i < n * width; i += blockDim.x) {
        const int r = i / width, c = i % width;
        dst[r * ld + c] = s0 + r < S && c < hd ? base[(s0 + r) * ss + c] : 0.f;
    }
}

// dQ: one block per (b, h, 16 query rows); a warp owns 4 rows, a lane one
// key of the 32-key tile for the scores and HD/32 head dims for dQ.
template <int HD>
__global__ void __launch_bounds__(128) flash_bwd_dq_f32_kernel(const Params p) {
    constexpr int HDP = pad32(HD);         // K's columns past HD are zeros
    constexpr int DPL = HDP / 32;
    extern __shared__ float fsm[];
    float* Qs = fsm;                       // [FBM][HD]
    float* dOs = Qs + FBM * HD;            // [FBM][HD]
    float* Ks = dOs + FBM * HD;            // [FBN][HDP + 1]
    float* Vs = Ks + FBN * (HDP + 1);      // [FBN][HDP + 1]

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FBM;
    const int hk = h / (p.Hq / p.Hkv);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
    const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
    load_rows_f32(Qs, HD, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh,
                  p.q_ss, q0, FBM, p.Sq, HD, HD);
    load_rows_f32(dOs, HD, static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh,
                  p.do_ss, q0, FBM, p.Sq, HD, HD);

    float acc[ROWS_PER_WARP][DPL] = {};
    float lse[ROWS_PER_WARP], dlt[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const int row = min(q0 + warp * ROWS_PER_WARP + r, p.Sq - 1);
        lse[r] = p.lse[((size_t)b * p.Hq + h) * p.Sq + row];
        dlt[r] = p.delta[((size_t)b * p.Hq + h) * p.Sq + row];
    }

    int lo, hi;
    key_range(p, q0, min(q0 + FBM, p.Sq), lo, hi);
    for (int k0 = (lo / FBN) * FBN; k0 < hi; k0 += FBN) {
        __syncthreads();
        load_rows_f32(Ks, HDP + 1, kb, p.k_ss, k0, FBN, p.Skv, HD, HDP);
        load_rows_f32(Vs, HDP + 1, vb, p.v_ss, k0, FBN, p.Skv, HD, HDP);
        __syncthreads();
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
            const int lr = warp * ROWS_PER_WARP + r;
            float s = 0.f, dp = 0.f;
#pragma unroll 8
            for (int c = 0; c < HD; ++c) {
                s = fmaf(Qs[lr * HD + c], Ks[lane * (HDP + 1) + c], s);
                dp = fmaf(dOs[lr * HD + c], Vs[lane * (HDP + 1) + c], dp);
            }
            float pe, jac;
            prob(p, s, lse[r], q0 + lr, k0 + lane, pe, jac);
            const float ds = pe * (dp - dlt[r]) * jac;
            for (int j = 0; j < FBN; ++j) {
                const float dj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
                for (int i = 0; i < DPL; ++i)
                    acc[r][i] = fmaf(dj, Ks[j * (HDP + 1) + lane + 32 * i], acc[r][i]);
            }
        }
    }
    float* dqb = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const int row = q0 + warp * ROWS_PER_WARP + r;
        if (row >= p.Sq) continue;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
            if (lane + 32 * i < HD) dqb[row * p.dq_ss + lane + 32 * i] = acc[r][i] * p.scale;
    }
}

// dK/dV: one block per (b, KV head, 32 keys).  For each query head of the
// group and each 16-row query tile: a warp scores 4 rows against the 32
// keys (a lane per key) into P and dS in smem; then the thread that owns
// key (tid % 32) and head dims tid / 32 + 4 i accumulates dK and dV.
template <int HD>
__global__ void __launch_bounds__(128) flash_bwd_dkv_f32_kernel(const Params p) {
    static_assert(HD % 4 == 0, "hd split over 4 threads");
    constexpr int DPT = HD / 4;
    extern __shared__ float fsm[];
    float* Ks = fsm;                       // [FBN][HD + 1]
    float* Vs = Ks + FBN * (HD + 1);
    float* Qs = Vs + FBN * (HD + 1);       // [FBM][HD]
    float* dOs = Qs + FBM * HD;
    float* Ps = dOs + FBM * HD;            // [FBM][FBN]
    float* dSs = Ps + FBM * FBN;

    const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * FBN;
    const int G = p.Hq / p.Hkv;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    load_rows_f32(Ks, HD + 1, static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh,
                  p.k_ss, k0, FBN, p.Skv, HD, HD);
    load_rows_f32(Vs, HD + 1, static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh,
                  p.v_ss, k0, FBN, p.Skv, HD, HD);
    const int key = threadIdx.x & 31, d0 = threadIdx.x >> 5;
    float dk[DPT] = {}, dv[DPT] = {};

    int lo, hi;
    query_range(p, k0, min(k0 + FBN, p.Skv), lo, hi);
    for (int hq = hk * G; hq < (hk + 1) * G; ++hq) {
        const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + hq * p.q_sh;
        const float* dob = static_cast<const float*>(p.dout) + b * p.do_sb + hq * p.do_sh;
        const float* lse_b = p.lse + ((size_t)b * p.Hq + hq) * p.Sq;
        const float* dlt_b = p.delta + ((size_t)b * p.Hq + hq) * p.Sq;
        for (int q0 = (lo / FBM) * FBM; q0 < hi; q0 += FBM) {
            __syncthreads();
            load_rows_f32(Qs, HD, qb, p.q_ss, q0, FBM, p.Sq, HD, HD);
            load_rows_f32(dOs, HD, dob, p.do_ss, q0, FBM, p.Sq, HD, HD);
            __syncthreads();
#pragma unroll
            for (int r = 0; r < ROWS_PER_WARP; ++r) {
                const int lr = warp * ROWS_PER_WARP + r;
                const int row = min(q0 + lr, p.Sq - 1);
                float s = 0.f, dp = 0.f;
#pragma unroll 8
                for (int c = 0; c < HD; ++c) {
                    s = fmaf(Qs[lr * HD + c], Ks[lane * (HD + 1) + c], s);
                    dp = fmaf(dOs[lr * HD + c], Vs[lane * (HD + 1) + c], dp);
                }
                float pe, jac;
                prob(p, s, lse_b[row], q0 + lr, k0 + lane, pe, jac);
                Ps[lr * FBN + lane] = pe;
                dSs[lr * FBN + lane] = pe * (dp - dlt_b[row]) * jac;
            }
            __syncthreads();
            for (int r = 0; r < FBM; ++r) {
                const float pr = Ps[r * FBN + key], dsr = dSs[r * FBN + key];
#pragma unroll
                for (int i = 0; i < DPT; ++i) {
                    const int c = d0 + 4 * i;
                    dv[i] = fmaf(pr, dOs[r * HD + c], dv[i]);
                    dk[i] = fmaf(dsr, Qs[r * HD + c], dk[i]);
                }
            }
        }
    }
    if (k0 + key < p.Skv) {
        float* dkr = static_cast<float*>(p.dk) + b * p.dk_sb + hk * p.dk_sh + (k0 + key) * p.dk_ss;
        float* dvr = static_cast<float*>(p.dv) + b * p.dv_sb + hk * p.dv_sh + (k0 + key) * p.dv_ss;
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
            dkr[d0 + 4 * i] = dk[i] * p.scale;
            dvr[d0 + 4 * i] = dv[i];
        }
    }
}


template <typename K>
cudaError_t launch_kernel(K kernel, dim3 grid, size_t smem, const Params& p,
                          cudaStream_t s) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, 128, smem, s>>>(p);
    return cudaGetLastError();
}

// The tensor maps of q, dout (query rows), k, v (keys) with boxes of
// `q_rows` and `k_rows` rows.
template <int HD>
cudaError_t input_maps(const Params& p, CUtensorMap* qm, CUtensorMap* dom, CUtensorMap* km,
                       CUtensorMap* vm, int q_rows, int k_rows) {
    cudaError_t e = head_map(qm, p.q, HD, p.Hq, p.Sq, p.B, p.q_sb, p.q_ss, p.q_sh, q_rows);
    if (e == cudaSuccess)
        e = head_map(dom, p.dout, HD, p.Hq, p.Sq, p.B, p.do_sb, p.do_ss, p.do_sh, q_rows);
    if (e == cudaSuccess)
        e = head_map(km, p.k, HD, p.Hkv, p.Skv, p.B, p.k_sb, p.k_ss, p.k_sh, k_rows);
    if (e == cudaSuccess)
        e = head_map(vm, p.v, HD, p.Hkv, p.Skv, p.B, p.v_sb, p.v_ss, p.v_sh, k_rows);
    return e;
}

int dq_items(const Params& p) { return cdiv(p.Sq, DQ_BM) * p.Hq * p.B; }
int dkv_items(const Params& p) { return cdiv(p.Skv, DKV_BN) * p.Hkv * p.B; }

template <int HD>
cudaError_t launch_dq(Params p, int dtype, cudaStream_t s) {
    if (dtype != DTYPE_BF16)
        return launch_kernel(flash_bwd_dq_f32_kernel<HD>, dim3((p.Sq + FBM - 1) / FBM, p.Hq, p.B),
                             (2 * FBM * HD + 2 * FBN * (pad32(HD) + 1)) * sizeof(float), p, s);
    CUtensorMap qm, dom, km, vm, dqm;
    cudaError_t e = input_maps<HD>(p, &qm, &dom, &km, &vm, DQ_BM, DQ_BN);
    if (e == cudaSuccess)
        e = head_map(&dqm, p.dq, HD, p.Hq, p.Sq, p.B, p.dq_sb, p.dq_ss, p.dq_sh, WG_ROWS);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Dq<HD>::SMEM);
    if (e != cudaSuccess) return e;
    const int sms = hopper::sm_count();
    if (sms <= 0) return cudaErrorInvalidDevice;
    p.chunk = chunk_pairs(p.B, p.Hq, p.Hkv, p.Skv, HD);
    const int items = dq_items(p);
    flash_bwd_dq_bf16_kernel<HD><<<items < sms ? items : sms, THREADS, Dq<HD>::SMEM, s>>>(
        qm, km, vm, dom, dqm, p, items);
    return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(Params p, int dtype, cudaStream_t s) {
    if (dtype != DTYPE_BF16)
        return launch_kernel(flash_bwd_dkv_f32_kernel<HD>,
                             dim3((p.Skv + FBN - 1) / FBN, p.Hkv, p.B),
                             (2 * FBN * (HD + 1) + 2 * FBM * HD + 2 * FBM * FBN) * sizeof(float),
                             p, s);
    CUtensorMap qm, dom, km, vm, dkm, dvm;
    cudaError_t e = input_maps<HD>(p, &qm, &dom, &km, &vm, DKV_BM, DKV_BN);
    if (e == cudaSuccess)
        e = head_map(&dkm, p.dk, HD, p.Hkv, p.Skv, p.B, p.dk_sb, p.dk_ss, p.dk_sh, WG_ROWS);
    if (e == cudaSuccess)
        e = head_map(&dvm, p.dv, HD, p.Hkv, p.Skv, p.B, p.dv_sb, p.dv_ss, p.dv_sh, WG_ROWS);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Dkv<HD>::SMEM);
    if (e != cudaSuccess) return e;
    const int sms = hopper::sm_count();
    if (sms <= 0) return cudaErrorInvalidDevice;
    p.kv_chunk = dkv_chunk(p.B, p.Hq, p.Hkv, p.Sq, p.Skv, HD, sms);
    const int items = dkv_items(p);
    flash_bwd_dkv_bf16_kernel<HD><<<items < sms ? items : sms, THREADS, Dkv<HD>::SMEM, s>>>(
        qm, km, vm, dom, dkm, dvm, p, items);
    return cudaGetLastError();
}

int make_params(Params& p, const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
                int Hq, int Hkv, int Sq, int Skv, int hd, const long long* st, int causal,
                int window, float softcap, int q_offset, float scale, int dtype) {
    if ((dtype != DTYPE_BF16 && dtype != DTYPE_F32) || Hkv <= 0 || Hq % Hkv != 0 || B < 0
        || Sq < 0 || Skv < 0)
        return cudaErrorInvalidValue;
    p.q = q; p.k = k; p.v = v; p.dout = dout;
    p.lse = static_cast<const float*>(lse); p.delta = static_cast<const float*>(delta);
    p.dq = dq; p.dk = dk; p.dv = dv;
    p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv;
    long long* f[21] = {&p.q_sb, &p.q_ss, &p.q_sh, &p.k_sb, &p.k_ss, &p.k_sh,
                        &p.v_sb, &p.v_ss, &p.v_sh, &p.do_sb, &p.do_ss, &p.do_sh,
                        &p.dq_sb, &p.dq_ss, &p.dq_sh, &p.dk_sb, &p.dk_ss, &p.dk_sh,
                        &p.dv_sb, &p.dv_ss, &p.dv_sh};
    for (int i = 0; i < 21; ++i) *f[i] = st ? st[i] : 0;
    p.causal = causal; p.window = window; p.q_offset = q_offset;
    p.softcap = softcap; p.scale = scale; p.chunk = 0; p.kv_chunk = 0;
    return cudaSuccess;
}

}  // namespace

// Both entries take the same arguments.  q/dout/dq: (B, Sq, Hq, hd);
// k/v/dk/dv: (B, Skv, Hkv, hd), unit stride on hd; strides[21] = element
// strides (batch, seq, head) of q, k, v, dout, dq, dk, dv.  lse, delta:
// (B, Hq, Sq) fp32 contiguous.  hd in {64, 80, 88, 128} (any other gives
// cudaErrorInvalidValue); bf16 strides and base pointers must be multiples
// of 8 elements (16-byte vectors).
#define BWD_ARGS                                                                      \
    const void *q, const void *k, const void *v, const void *dout, const void *lse,   \
        const void *delta, void *dq, void *dk, void *dv, int B, int Hq, int Hkv,      \
        int Sq, int Skv, int hd, const long long *strides, int causal, int window,    \
        float softcap, int q_offset, float scale, int dtype, void *stream
#define BWD_PASS                                                                      \
    q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Skv, hd, strides, causal,  \
        window, softcap, q_offset, scale, dtype

extern "C" int flash_attention_bwd_dq(BWD_ARGS) {
    Params p;
    const int err = make_params(p, BWD_PASS);
    if (err != cudaSuccess) return err;
    if (B == 0 || Sq == 0 || Hq == 0) return cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 64: return launch_dq<64>(p, dtype, s);
        case 80: return launch_dq<80>(p, dtype, s);
        case 88: return launch_dq<88>(p, dtype, s);
        case 128: return launch_dq<128>(p, dtype, s);
        default: return cudaErrorInvalidValue;   // not built for this head dim
    }
}

extern "C" int flash_attention_bwd_dkv(BWD_ARGS) {
    Params p;
    const int err = make_params(p, BWD_PASS);
    if (err != cudaSuccess) return err;
    if (B == 0 || Skv == 0 || Hkv == 0) return cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 64: return launch_dkv<64>(p, dtype, s);
        case 80: return launch_dkv<80>(p, dtype, s);
        case 88: return launch_dkv<88>(p, dtype, s);
        case 128: return launch_dkv<128>(p, dtype, s);
        default: return cudaErrorInvalidValue;   // not built for this head dim
    }
}

// The bf16 backward's work, for the host-side mirrors' check
// (kernels/flash_attention.py): the number of items of kernel 0 (dQ) or 1
// (dK/dV) at these sizes and mask on `sms` SMs, and item `item`'s record in
// out[5]: dQ (q0, h, b, kstart, ntiles), dK/dV (k0, hk, b, qstart, nq).  -1
// for sizes the entries refuse.
extern "C" int flash_bwd_item(int kernel, int item, int B, int Hq, int Hkv, int Sq, int Skv,
                              int hd, int causal, int window, int q_offset, int sms, int* out) {
    Params p;
    if (make_params(p, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    nullptr, B, Hq, Hkv, Sq, Skv, hd, nullptr, causal, window, 0.f, q_offset,
                    1.f, DTYPE_BF16) != cudaSuccess)
        return -1;
    if (kernel == 0) {
        p.chunk = chunk_pairs(B, Hq, Hkv, Skv, hd);
        const int items = dq_items(p);
        if (item >= 0 && item < items) {
            const DqWork w = dq_work_of(p, item);
            const int rec[5] = {w.q0, w.h, w.b, w.kstart, w.ntiles};
            for (int i = 0; i < 5; ++i) out[i] = rec[i];
        }
        return items;
    }
    p.kv_chunk = dkv_chunk(B, Hq, Hkv, Sq, Skv, hd, sms);
    const int items = dkv_items(p);
    if (item >= 0 && item < items) {
        const DkvWork w = dkv_work_of(p, item);
        const int rec[5] = {w.k0, w.hk, w.b, w.qstart, w.nq};
        for (int i = 0; i < 5; ++i) out[i] = rec[i];
    }
    return items;
}

// Whether a bf16 backward tile takes the mask: kernel 0 (dQ), the
// warpgroup of query rows from `a` and the key tile from `b`; kernel 1
// (dK/dV), the warpgroup of keys from `a` and the query tile from `b`.
extern "C" int flash_bwd_edge(int kernel, int a, int b, int Sq, int Skv, int causal, int window,
                              int q_offset) {
    Params p;
    p.Sq = Sq; p.Skv = Skv; p.causal = causal; p.window = window; p.q_offset = q_offset;
    return kernel == 0 ? rows_edge(p, a, b, DQ_BN) : keys_edge(p, a, b);
}
