// FlashAttention forward for Hopper: O = softmax(mask(cap(Q K^T / sqrt(hd)))) V
// and the fp32 row log-sum-exp, with native GQA.
//
// Replaces: repro/kernels/flash_attention.py:_fwd_kernel (via
//   flash_attention_fwd): online softmax, causal and sliding-window masks,
//   q_offset, the logit softcap tanh(s/c)*c applied after the 1/sqrt(hd)
//   scale, query head h reading KV head h // G, output O and LSE (B, H, Sq).
// Bound on the H100: operations.  A causal prefill at S = 2048, hd = 128
//   does ~4*S*S/2*hd FLOP per head, ~300 FLOP per byte of Q, K, V and O,
//   above the ridge; short prompts and the masked-out half shift it toward
//   memory.  So the tensor cores have to be kept busy: operands must be in
//   shared memory before they are needed, and the softmax between the two
//   products must stay short.
// Design: the TPU kernel carries (m, l, acc) in VMEM across a sequential nk
//   grid axis.  Here a work item is (b, h, 128 query rows), whose key tiles
//   are walked in a loop inside the block with (m, l, acc) in registers;
//   the loop bounds skip fully masked tiles (causal limit, window start).
//   Q, K, V and O are read and written through their strides in the
//   model's (B, S, H, hd) layout, so no transposes are needed.
//   bf16 (FlashAttention-3's shape): a persistent grid, one block per SM,
//   each block taking the next work item as it comes free, so one item's
//   epilogue and the next one's loads overlap and no SM idles behind a
//   long causal row.  Items run in chunks of (b, h) pairs whose K and V fit
//   in a third of the L2 (MHA at 4 x 2048 tokens would otherwise stream K
//   and V from device memory once per query tile), the longest causal rows
//   of a chunk first.  Three warpgroups: a producer warp issues TMA copies
//   (4-D tensor maps over (hd, H, S, B), 128-byte swizzle, K and V with an
//   evict-last L2 hint): Q once per item, then K and V tiles of 128 keys
//   into a 2-stage ring in shared memory, each signalled by an mbarrier and
//   released apart (K once its scores are computed, V after P V), so the
//   next tiles are in flight while the consumers compute.  Two consumer
//   warpgroups own 64 query rows each: S = Q K^T is a wgmma with both
//   operands in shared memory; O += P V is a wgmma with P, the scores'
//   probabilities rounded to bf16, from registers and V in its MN-major
//   (transposed-B) layout; the S of tile i is issued before the P V of
//   tile i - 1 (FlashAttention-3's intra-warpgroup pipelining), so the
//   online softmax of tile i runs while P V keeps the tensor cores busy.
//   The softmax works in base 2 (one ex2.approx a score, log2(e)/sqrt(hd)
//   folded into one FFMA), and the mask, a key window per row applied by
//   select, runs only on tiles that cross the causal diagonal, the window's
//   start or the Skv edge; full tiles skip it.  O leaves through shared
//   memory and one TMA store per warpgroup.
//   Head dims: a tile row is one or two 64-column boxes; TMA fills columns
//   past hd with zeros (Q K^T runs hd 88 as 96 over zero columns) and
//   clips the store to hd, and O = P V runs as wgmma n = hd (64, 80, 88,
//   128).  A row that sees no key writes O = 0 and LSE -1e30 (the TPU
//   kernel's safe_l); LSE is the natural log, converted from base 2.
//   fp32: FFMA only (no TF32) so the check against the plain fp32 version
//   stays tight: a warp per 4 query rows, one key per lane for the scores,
//   head dims split across lanes for the P V update.  It pads hd to a
//   multiple of 32 lanes.  The scale stays 1/sqrt(hd) of the real head dim.
#include "flash_common.cuh"

using bf16 = __nv_bfloat16;
using namespace flash;

namespace {

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    float* lse;
    int B, Hq, Hkv, Sq, Skv;
    long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
    int causal, window, q_offset;   // window <= 0: no window
    float softcap, scale;           // softcap <= 0: no cap
    int chunk;                      // bf16: (b, h) pairs per chunk of the work order
};

__device__ __forceinline__ float score(const Params& p, float s, int qpos, int kpos) {
    s *= p.scale;
    if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
    bool ok = kpos < p.Skv;
    if (p.causal) ok = ok && kpos <= qpos;
    if (p.window > 0) ok = ok && qpos - kpos < p.window;
    return ok ? s : NEG_INF;
}

// ---------------------------------------------------------------------------
// bf16: persistent, TMA ring, wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int BM = 128;         // query rows of a work item: two consumer warpgroups of 64
constexpr int BN = 128;         // keys of a tile
constexpr int STAGES = 2;       // K/V ring depth
constexpr int THREADS = 384;    // producer warpgroup + two consumers

template <int HD>
struct Fwd {
    static constexpr int NBOX = (HD + BOX - 1) / BOX;     // boxes per row: 1 or 2
    static constexpr int KSTEPS = pad16(HD) / 16;         // k16 steps of Q K^T
    static constexpr int Q_BOX = BM * 128;                // bytes of one box
    static constexpr int KV_BOX = BN * 128;
    static constexpr int O_BOX = 64 * 128;                // a consumer's rows
    static constexpr int Q_BYTES = NBOX * Q_BOX;
    static constexpr int KV_BYTES = NBOX * KV_BOX;
    static constexpr int O_BYTES = 2 * NBOX * O_BOX;      // the output's staging
    // q_full, q_empty, k/v full and empty of each stage
    static constexpr int BARRIERS = 2 + 4 * STAGES;
    static constexpr int SMEM = hopper::SMEM_ALIGN + Q_BYTES + 2 * STAGES * KV_BYTES + O_BYTES
                                + 8 + 8 * BARRIERS;                // the item slot
};

// 2^x, flushing results below 2^-126 to 0 (one MUFU.EX2; exp2f adds a
// denormal fix-up around it)
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// A work item: 128 query rows of one (b, h) and the key tiles they see.
struct Work {
    int q0, h, b, kstart, ntiles;
};

// Items in the order of q_item (flash_common.cuh), in chunks of p.chunk
// (b, h) pairs.
__device__ __forceinline__ Work work_of(const Params& p, int item) {
    Work w;
    const QItem qi = q_item(item, p.B, p.Hq, p.Sq, p.chunk, p.causal, BM);
    w.q0 = qi.q0;
    w.h = qi.h;
    w.b = qi.b;
    int lo, hi;
    key_range(p, w.q0, min(w.q0 + BM, p.Sq), lo, hi);
    w.kstart = lo / BN * BN;
    w.ntiles = hi > w.kstart ? (hi - w.kstart + BN - 1) / BN : 0;
    return w;
}

// The persistent grid's next item: each block's producer takes one when its
// consumers are done with the last one's Q, so blocks stay busy whatever the
// items' lengths.  Every block ends with one fetch past the last item; the
// block whose fetch is the last of those resets the count for the next
// launch (launches on one stream run in order).
__device__ unsigned int flash_next_item = 0;

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap, const Params p, int items) {
    using C = Fwd<HD>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* Qs = hopper::align_smem(smem_raw);
    unsigned char* Ks = Qs + C::Q_BYTES;
    unsigned char* Vs = Ks + STAGES * C::KV_BYTES;
    unsigned char* Os = Vs + STAGES * C::KV_BYTES;
    volatile int* item_slot = reinterpret_cast<volatile int*>(Os + C::O_BYTES);  // -1: done
    uint64_t* q_full = reinterpret_cast<uint64_t*>(Os + C::O_BYTES + 8);
    uint64_t* q_empty = q_full + 1;
    uint64_t* k_full = q_empty + 1;
    uint64_t* v_full = k_full + STAGES;
    uint64_t* k_empty = v_full + STAGES;
    uint64_t* v_empty = k_empty + STAGES;

    const int wg = threadIdx.x / 128;
    if (threadIdx.x == 0) {
        hopper::mbar_init(q_full, 1);
        hopper::mbar_init(q_empty, 8);              // each consumer warp arrives
        for (int s = 0; s < STAGES; ++s) {
            hopper::mbar_init(&k_full[s], 1);
            hopper::mbar_init(&v_full[s], 1);
            hopper::mbar_init(&k_empty[s], 8);
            hopper::mbar_init(&v_empty[s], 8);
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();

    if (wg == 0) {
        // producer: one thread keeps the ring full, across items.  K and V
        // of a stage are released apart: K once its scores are computed, V
        // after P V; Q once the item's last scores are computed.
        hopper::reg_dealloc<24>();
        if (threadIdx.x == 0) {
            hopper::prefetch_map(&qmap);
            hopper::prefetch_map(&kmap);
            hopper::prefetch_map(&vmap);
            int g = 0;                               // K/V tiles loaded so far
            for (int n = 0;; ++n) {
                const int item = (int)atomicAdd(&flash_next_item, 1u);
                if (n > 0) hopper::mbar_wait(q_empty, (n - 1) & 1);
                if (item >= items) {
                    *item_slot = -1;
                    hopper::mbar_arrive(q_full);
                    if (item == items + (int)gridDim.x - 1) atomicExch(&flash_next_item, 0u);
                    break;
                }
                *item_slot = item;
                const Work w = work_of(p, item);
                const int hk = w.h / (p.Hq / p.Hkv);
                hopper::mbar_expect_tx(q_full, C::Q_BYTES);
                for (int c = 0; c < C::NBOX; ++c)
                    hopper::tma_load_4d_hint(Qs + c * C::Q_BOX, &qmap, q_full, c * BOX, w.h,
                                             w.q0, w.b, hopper::EVICT_FIRST);
                for (int it = 0; it < w.ntiles; ++it, ++g) {
                    const int s = g % STAGES;
                    const uint32_t par = ((g / STAGES) & 1) ^ 1;
                    const int k0 = w.kstart + (w.ntiles - 1 - it) * BN;
                    if (g >= STAGES) hopper::mbar_wait(&k_empty[s], par);
                    hopper::mbar_expect_tx(&k_full[s], C::KV_BYTES);
                    for (int c = 0; c < C::NBOX; ++c)
                        hopper::tma_load_4d_hint(Ks + s * C::KV_BYTES + c * C::KV_BOX, &kmap,
                                                 &k_full[s], c * BOX, hk, k0, w.b,
                                                 hopper::EVICT_LAST);
                    if (g >= STAGES) hopper::mbar_wait(&v_empty[s], par);
                    hopper::mbar_expect_tx(&v_full[s], C::KV_BYTES);
                    for (int c = 0; c < C::NBOX; ++c)
                        hopper::tma_load_4d_hint(Vs + s * C::KV_BYTES + c * C::KV_BOX, &vmap,
                                                 &v_full[s], c * BOX, hk, k0, w.b,
                                                 hopper::EVICT_LAST);
                }
            }
        }
    } else {
        // consumers: S of tile i is computed while P V of tile i - 1 runs,
        // so the softmax overlaps the tensor cores (FA-3's intra-warpgroup
        // pipelining)
        hopper::reg_alloc<240>();
        const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32;
        const int rw = (t / 32) * 16 + lane / 4;       // rows rw, rw + 8 of the warpgroup's 64
        unsigned char* Ow = Os + cw * C::NBOX * C::O_BOX;
        const uint64_t qd = hopper::desc(Qs + cw * 64 * 128, 16, 1024);   // this warpgroup's rows
        // the working score is the raw dot (no cap) or the capped score;
        // c turns it into base-2 units
        const bool cap = p.softcap > 0.f;
        const float c = (cap ? 1.f : p.scale) * LOG2E;
        const float cap_in = p.scale / (cap ? p.softcap : 1.f);

        float o[HD / 2];
        float m[2], l[2];                 // l: this thread's part
        float sc[BN / 2];                 // scores, then p in fp32
        uint32_t pa[BN / 16][4];          // p in bf16: P V's A operand
        float corr[2];
        int g0 = 0;                       // K/V tiles consumed before this item

        for (int n = 0;; ++n) {
            hopper::mbar_wait(q_full, n & 1);
            const int item = *item_slot;
            if (item < 0) break;
            const Work w = work_of(p, item);
            const int r_lo = w.q0 + cw * 64;               // this warpgroup's rows
            const int row0 = r_lo + rw;

            // S = Q K^T of tile `it` into sc (committed, not waited for)
            auto issue_s = [&](int it) {
                const int g = g0 + it, s = g % STAGES;
                hopper::mbar_wait(&k_full[s], (g / STAGES) & 1);
                const uint64_t kd = hopper::desc(Ks + s * C::KV_BYTES, 16, 1024);
                hopper::wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < C::KSTEPS; ++kk) {
                    // a k16 step: 32 bytes along the row, 4 to a 64-column box
                    const int q_off = (kk / 4) * C::Q_BOX + (kk % 4) * 32;
                    const int k_off = (kk / 4) * C::KV_BOX + (kk % 4) * 32;
                    hopper::wgmma_ss<0>(sc, qd + hopper::desc_offset(q_off),
                                        kd + hopper::desc_offset(k_off), kk > 0);
                }
                hopper::wgmma_commit();
            };
            // O += P V of tile `it` (committed, not waited for)
            auto issue_pv = [&](int it) {
                const int g = g0 + it, s = g % STAGES;
                hopper::mbar_wait(&v_full[s], (g / STAGES) & 1);
                const uint64_t vd = hopper::desc(Vs + s * C::KV_BYTES, C::KV_BOX, 1024);
                hopper::wgmma_fence();
#pragma unroll
                for (int kc = 0; kc < BN / 16; ++kc)
                    hopper::wgmma_rs<1>(o, pa[kc], vd + hopper::desc_offset(kc * 16 * 128), 1);
                hopper::wgmma_commit();
            };
            // S of tile `it` is done: release its K (and Q after the last)
            auto scores_done = [&](int it) {
                hopper::fence_regs(sc);
                if (lane == 0) {
                    hopper::mbar_arrive(&k_empty[(g0 + it) % STAGES]);
                    if (it == w.ntiles - 1) hopper::mbar_arrive(q_empty);
                }
            };
            // the online softmax of tile `it`'s scores: p in fp32 in sc, the
            // new row max in m, the factor for O and l in corr
            auto softmax = [&](int it) {
                const int k0 = w.kstart + (w.ntiles - 1 - it) * BN;
                if (cap) {
#pragma unroll
                    for (int i = 0; i < BN / 2; ++i) sc[i] = p.softcap * tanhf(sc[i] * cap_in);
                }
                if (rows_edge(p, r_lo, k0, BN)) {
                    // row r sees keys [klo, khi]; offsets from this thread's
                    // first column k0 + 2 * (lane % 4)
                    int klo[2], khi[2];
#pragma unroll
                    for (int r = 0; r < 2; ++r)
                        row_keys(p, row0 + 8 * r + p.q_offset, k0 + 2 * (lane % 4), klo[r],
                                 khi[r]);
#pragma unroll
                    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int kk = 8 * j + (e & 1);
                            const bool ok = kk >= klo[e >> 1] && kk <= khi[e >> 1];
                            sc[4 * j + e] = ok ? sc[4 * j + e] : NEG_INF;
                        }
                }
                float mt[2] = {m[0], m[1]};
#pragma unroll
                for (int j = 0; j < BN / 8; ++j) {
                    mt[0] = fmaxf(mt[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
                    mt[1] = fmaxf(mt[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
                }
                float ms[2];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
                    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
                    // a row that has seen no key yet keeps m = NEG_INF; its
                    // exponents then stay hugely negative and give p = 0
                    ms[r] = mt[r] == NEG_INF ? 0.f : mt[r] * c;
                    corr[r] = exp2_ftz(m[r] * c - ms[r]);
                    m[r] = mt[r];
                    l[r] *= corr[r];
                }
#pragma unroll
                for (int j = 0; j < BN / 8; ++j) {
                    sc[4 * j] = exp2_ftz(fmaf(sc[4 * j], c, -ms[0]));
                    sc[4 * j + 1] = exp2_ftz(fmaf(sc[4 * j + 1], c, -ms[0]));
                    sc[4 * j + 2] = exp2_ftz(fmaf(sc[4 * j + 2], c, -ms[1]));
                    sc[4 * j + 3] = exp2_ftz(fmaf(sc[4 * j + 3], c, -ms[1]));
                    l[0] += sc[4 * j] + sc[4 * j + 1];
                    l[1] += sc[4 * j + 2] + sc[4 * j + 3];
                }
            };
            // p to bf16 and O rescaled, once the P V before has finished
            auto to_pv_operand = [&]() {
#pragma unroll
                for (int j = 0; j < BN / 8; ++j) {
                    pa[j / 2][2 * (j % 2)] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
                    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
                }
#pragma unroll
                for (int j = 0; j < HD / 8; ++j) {
                    o[4 * j] *= corr[0];
                    o[4 * j + 1] *= corr[0];
                    o[4 * j + 2] *= corr[1];
                    o[4 * j + 3] *= corr[1];
                }
            };
            // P V of tile `it` is done: release its V
            auto pv_done = [&](int it) {
                hopper::fence_regs(o);
#pragma unroll
                for (int kc = 0; kc < BN / 16; ++kc) hopper::fence_regs(pa[kc]);
                if (lane == 0) hopper::mbar_arrive(&v_empty[(g0 + it) % STAGES]);
            };

#pragma unroll
            for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
            m[0] = m[1] = NEG_INF;
            l[0] = l[1] = 0.f;
            if (w.ntiles == 0 && lane == 0) hopper::mbar_arrive(q_empty);
            if (w.ntiles > 0) {
                issue_s(0);
                hopper::wgmma_wait<0>();
                scores_done(0);
                softmax(0);
                to_pv_operand();
            }
            for (int it = 1; it < w.ntiles; ++it) {
                issue_s(it);
                issue_pv(it - 1);
                hopper::wgmma_wait<1>();      // S of tile it
                scores_done(it);
                softmax(it);
                hopper::wgmma_wait<0>();      // P V of tile it - 1
                pv_done(it - 1);
                to_pv_operand();
            }
            if (w.ntiles > 0) {
                issue_pv(w.ntiles - 1);
                hopper::wgmma_wait<0>();
                pv_done(w.ntiles - 1);
            }
            g0 += w.ntiles;

            // epilogue: O / l in bf16 into this warpgroup's staging rows
            // (128-byte swizzled boxes), then one TMA store; LSE directly
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
                l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            }
            float inv[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
                if (lane % 4 == 0 && row0 + 8 * r < p.Sq)
                    p.lse[((size_t)w.b * p.Hq + w.h) * p.Sq + row0 + 8 * r] =
                        l[r] == 0.f ? NEG_INF : m[r] * c * LN2 + logf(l[r]);
            }
            if (t == 0) hopper::bulk_wait_read();    // the last item's store has read it
            hopper::named_sync(1 + cw, 128);
            stage_rows<HD>(Ow, o, inv, lane, rw);
            hopper::fence_async_smem();
            hopper::named_sync(1 + cw, 128);
            if (t == 0) {
                for (int b = 0; b < C::NBOX; ++b)
                    hopper::tma_store_4d(&omap, Ow + b * C::O_BOX, b * BOX, w.h, r_lo, w.b);
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

template <int HD>
__global__ void __launch_bounds__(128) flash_fwd_f32_kernel(const Params p) {
    constexpr int HDP = pad32(HD);        // columns past HD are zeros
    constexpr int DPL = HDP / 32;         // head dims per lane
    __shared__ float Qs[FBM][HDP];
    __shared__ float Ks[FBN][HDP + 1];    // +1: lane j reads row j conflict-free
    __shared__ float Vs[FBN][HDP];

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FBM;
    const int hk = h / (p.Hq / p.Hkv);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
    const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

    for (int i = threadIdx.x; i < FBM * HDP; i += blockDim.x) {
        const int r = i / HDP, c = i % HDP;
        Qs[r][c] = q0 + r < p.Sq && c < HD ? qb[(q0 + r) * p.q_ss + c] : 0.f;
    }

    float acc[ROWS_PER_WARP][DPL] = {};
    float m[ROWS_PER_WARP], l[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.f;
    }

    int lo, hi;
    key_range(p, q0, min(q0 + FBM, p.Sq), lo, hi);
    for (int k0 = (lo / FBN) * FBN; k0 < hi; k0 += FBN) {
        __syncthreads();
        for (int i = threadIdx.x; i < FBN * HDP; i += blockDim.x) {
            const int r = i / HDP, c = i % HDP;
            const bool ok = k0 + r < p.Skv && c < HD;
            Ks[r][c] = ok ? kb[(k0 + r) * p.k_ss + c] : 0.f;
            Vs[r][c] = ok ? vb[(k0 + r) * p.v_ss + c] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
            const int lr = warp * ROWS_PER_WARP + r;
            float dot = 0.f;
#pragma unroll 8
            for (int c = 0; c < HD; ++c) dot = fmaf(Qs[lr][c], Ks[lane][c], dot);
            const float x = score(p, dot, q0 + lr + p.q_offset, k0 + lane);
            const float m_new = fmaxf(m[r], warp_max(x));
            const float pe = x == NEG_INF ? 0.f : expf(x - m_new);
            const float corr = expf(m[r] - m_new);
            l[r] = l[r] * corr + warp_sum(pe);
            m[r] = m_new;
#pragma unroll
            for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
            for (int j = 0; j < FBN; ++j) {
                const float pj = __shfl_sync(0xffffffffu, pe, j);
#pragma unroll
                for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, Vs[j][lane + 32 * i], acc[r][i]);
            }
        }
    }

    float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const int row = q0 + warp * ROWS_PER_WARP + r;
        if (row >= p.Sq) continue;
        const float safe_l = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
        for (int i = 0; i < DPL; ++i)
            if (lane + 32 * i < HD) ob[row * p.o_ss + lane + 32 * i] = acc[r][i] / safe_l;
        if (lane == 0) p.lse[((size_t)b * p.Hq + h) * p.Sq + row] = m[r] + logf(safe_l);
    }
}

template <int HD>
cudaError_t launch(Params p, int dtype, cudaStream_t s) {
    if (dtype == DTYPE_BF16) {
        CUtensorMap qm, km, vm, om;
        cudaError_t e = head_map(&qm, p.q, HD, p.Hq, p.Sq, p.B, p.q_sb, p.q_ss, p.q_sh, BM);
        if (e == cudaSuccess)
            e = head_map(&km, p.k, HD, p.Hkv, p.Skv, p.B, p.k_sb, p.k_ss, p.k_sh, BN);
        if (e == cudaSuccess)
            e = head_map(&vm, p.v, HD, p.Hkv, p.Skv, p.B, p.v_sb, p.v_ss, p.v_sh, BN);
        if (e == cudaSuccess)
            e = head_map(&om, p.o, HD, p.Hq, p.Sq, p.B, p.o_sb, p.o_ss, p.o_sh, 64);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(flash_fwd_bf16_kernel<HD>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     Fwd<HD>::SMEM);
        if (e != cudaSuccess) return e;
        const int sms = hopper::sm_count();
        if (sms <= 0) return cudaErrorInvalidDevice;
        p.chunk = chunk_pairs(p.B, p.Hq, p.Hkv, p.Skv, HD);
        const int items = (p.Sq + BM - 1) / BM * p.Hq * p.B;
        flash_fwd_bf16_kernel<HD><<<items < sms ? items : sms, THREADS, Fwd<HD>::SMEM, s>>>(
            qm, km, vm, om, p, items);
    } else {
        const dim3 grid((p.Sq + FBM - 1) / FBM, p.Hq, p.B);
        flash_fwd_f32_kernel<HD><<<grid, 128, 0, s>>>(p);
    }
    return cudaGetLastError();
}

}  // namespace

// q: (B, Sq, Hq, hd), k/v: (B, Skv, Hkv, hd), o like q, all with unit stride
// on hd; strides[12] = element strides (batch, seq, head) of q, k, v, o.
// lse: (B, Hq, Sq) fp32 contiguous.  hd in {64, 80, 88, 128} (any other gives
// cudaErrorInvalidValue); bf16 strides and base pointers must be multiples
// of 8 elements (16-byte vectors).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int Hq, int Hkv,
                                   int Sq, int Skv, int hd, const long long* strides,
                                   int causal, int window, float softcap,
                                   int q_offset, float scale, int dtype, void* stream) {
    if ((dtype != DTYPE_BF16 && dtype != DTYPE_F32) || Hkv <= 0 || Hq % Hkv != 0 || B < 0
        || Sq < 0 || Skv < 0)
        return cudaErrorInvalidValue;
    if (B == 0 || Sq == 0 || Hq == 0) return cudaSuccess;
    Params p;
    p.q = q; p.k = k; p.v = v; p.o = o; p.lse = static_cast<float*>(lse);
    p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv;
    p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
    p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
    p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
    p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
    p.causal = causal; p.window = window; p.q_offset = q_offset;
    p.softcap = softcap; p.scale = scale; p.chunk = 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 64: return launch<64>(p, dtype, s);
        case 80: return launch<80>(p, dtype, s);
        case 88: return launch<88>(p, dtype, s);
        case 128: return launch<128>(p, dtype, s);
        default: return cudaErrorInvalidValue;   // not built for this head dim
    }
}

// The chunk of (b, h) pairs the bf16 forward's work order uses, for the
// host-side mirror's check (kernels/flash_attention.py: chunk_pairs).
extern "C" int flash_fwd_chunk(int B, int Hq, int Hkv, int Skv, int hd) {
    return Hkv > 0 && Hq % Hkv == 0 ? chunk_pairs(B, Hq, Hkv, Skv, hd) : -1;
}
