// RWKV-6 chunked wkv scan and fused single-token wkv decode step for Hopper.
//
// Replaces: repro/kernels/wkv_scan.py:_scan_kernel (via _fwd_pallas) and
//   repro/kernels/wkv_scan.py:_decode_kernel (via wkv_decode_step).
//
// wkv_scan_fwd: r, k, w (B, T, H, K), v (B, T, H, V), u (H, K) and the
//   carried state S (B, H, K, V), all fp32 -> y (B, T, H, V) and the final
//   state, fp32, T in chunks of Q (a power of two <= 32 that divides T).
//   Per chunk c, with cum the inclusive cumsum of log w over the chunk (per
//   channel k), cum_{-1} = 0 and total its last entry:
//     y_t = (r_t * e^{cum_{t-1}}) S_{c-1}
//           + sum_{i<t} [sum_k r_tk k_ik e^{cum_{t-1,k} - cum_{i,k}}] v_i
//           + (r_t . (u * k_t)) v_t
//     S_c = e^{total} * S_{c-1} + D_c,  D_c = sum_i (k_i * e^{total - cum_i})^T v_i
//   all in fp32 as the reference's chunk body, with its logf, expf and
//   cumsum order: the cumsum of each channel runs in order of t, as the
//   plain version's does.  With a shuffle scan over t and log2/exp2 the
//   reduced fp32 rwkv6 train step's grad_norm drifted 1.2e-4 from kernels
//   off at step 2, past chip_smoke.py's on-vs-off limit of 1e-4; in this
//   order 6.6e-5 (tools/kernel_ab.py wkv_scan OTHER.cu --fp32-train, one
//   NVIDIA H100 80GB HBM3 at 700 W).
// Design (Q = 16, 32): chunk-parallel, in three kernels.
//   1. wkv_scan_state_kernel, one block per (b, h, chunk): log w by every
//      thread, then the cumsum per channel in order of t (chunk_cumsum: a
//      thread a channel, Q adds with no log or exp in the chain), D_c (4 x 4
//      register tiles) and e^{total} per channel, into a scratch of
//      B H (T/Q) (K V + K) floats.
//   2. wkv_scan_pass_kernel: S_c = e^{total_c} S_{c-1} + D_c in chunk order
//      from the carried state, parallel over the K V entries of each (b, h)
//      (a float4 a thread, the next chunk's D in flight), each S_{c-1}
//      written over D_c once D_c is read; the final state out.
//   3. wkv_scan_out_kernel, one block per (b, h, chunk): the same cumsum;
//      r e^{cum_{t-1}}; the scores of the pairs i < t (score_pair: a warp
//      takes rows t and Q-1-t, whose t + Q-1-t = Q-1 pairs fill its lanes,
//      so each lane forms one score's K exponentials: the triangle spread
//      evenly, the masked half never formed, no exponent positive); the
//      bonus, a warp a row; then y over row pairs t, Q-1-t by 4 columns v.
//      ~54 KB of shared memory at Q = 32: four blocks an SM.
// Small chunks (Q <= 8, chunk 1 included): wkv_scan_small_kernel walks the
//   tokens with the same algebra, chunk by chunk.  A block of 128 threads
//   takes 16 state columns v of one (b, h) (grid B H V/16); 8 threads share
//   a column, 8 rows k each, in registers.  It stages 32 tokens of r, k, w
//   and v at a time (the next window's loads in flight while this one runs),
//   forms each chunk's cumsum, e^{total}, the in-chunk scores and the bonus,
//   then r e^{cum_{t-1}} and k e^{total - cum} in place, once per window, and
//   walks the tokens with no barrier: (r e^..)_t . S by 8 FMAs and three
//   shuffles, the in-chunk terms, D += (k e^..)_t v_t; at the chunk's end
//   S = e^{total} S + D.
// Every sum runs in a fixed order, with no atomics: repeated launches are
//   bit-identical.
// Bound on the H100: bytes.  The scan's own inputs and outputs are 4 K + 2 V
//   fp32 a token and head (335 MB at rwkv6's train microbatch, 4 x 2048 x
//   32 heads: 0.10 ms at 3.35 TB/s); this design reads k, w and v again and
//   moves the chunk states four times (D_c written and read, S_{c-1}
//   written and read, 4 x 134 MB): ~1.07 GB, 0.32 ms.  The FFMA work (the
//   read-out and D_c, 2 Q K V each a chunk, the scores and score @ v) is
//   ~0.09 ms at 67 TFLOP/s, and the ~Q K / 2 exponentials a token ~0.06 ms
//   on the special-function units.
//
// wkv_decode_fwd: r, k, w (B, H, K), v (B, H, V), u (H, K), S (B, H, K, V)
//   and a per-slot active flag, all fp32 -> out = r (S + u * k v^T) (B, H, V)
//   for every slot, and S' = w * S + k v^T of the active slots, written over
//   S in place (state_out == state) or into a buffer apart; an inactive
//   slot's rows are never written.  In place, the layer's one launch
//   replaces the fresh state and the masked copy into the cache after it
//   (the reference's _freeze_inactive), which moved the state five times
//   more.
// Bound on the H100: bytes.  S is read once and S' written once (2 K V fp32
//   per head and slot: 4.2 MB at rwkv6's 4 slots, 0.0013 ms at 3.35 TB/s);
//   r, k, v, w and u are a few KB.  At that size the cost is latency.
// Design: one block of 256 threads per (b, h): thread (row group g, column
//   group c) holds rows 4g..4g+3 x columns 4c..4c+3 of S as four float4
//   (a warp reads two whole rows: coalesced), issued with its float4 of
//   r, k, w and u and of v, and no barrier before the update; it writes its
//   S' (the product and the sum each rounded, as the reference's two ops;
//   streaming stores) and its 4-row partials of out, which the 16 row
//   groups' partials sum through shared memory in a fixed order.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int KD = 64;                 // K = V: rwkv6's head dim
constexpr int Q_MAX = 32;
constexpr int KP = KD + 1;             // pitch of rows read across lanes: conflict-free
constexpr int NW = THREADS / 32;
constexpr int SMALL_Q = 8;             // chunks up to this take the token walk
constexpr int WINDOW = 32;             // tokens the token walk stages at once
constexpr int SMALL_COLS = 16;         // state columns v of a token-walk block
constexpr int SMALL_PARTS = 8;         // threads sharing a column, KD / 8 rows each
constexpr int SMALL_THREADS = SMALL_COLS * SMALL_PARTS;
constexpr int NROW = KD / SMALL_PARTS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int DEPTH = 4;             // chunks whose states the carry loads at once

struct ScanParams {
    const float* r;
    const float* k;
    const float* v;
    const float* w;
    const float* u;
    const float* s0;
    float* y;
    float* s_out;
    float* delta;                      // B H nc chunk states [k][v]
    float* etot;                       // B H nc K e^{total}
    int B, T, H, Q, nc;
};

__device__ __forceinline__ void unpack8(const float* src, float (&a)[8]) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    const float4 y = *reinterpret_cast<const float4*>(src + 4);
    a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
    a[4] = y.x; a[5] = y.y; a[6] = y.z; a[7] = y.w;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}

// ---- the work division (the kernels and the plan entries share these) ----

// block -> (b, h, chunk) of the chunk kernels, the head fastest
struct Item { int b, h, c; };
__host__ __device__ inline Item chunk_item(int block, int H, int nc) {
    return {block / (H * nc), block % H, (block / H) % nc};
}

// the score pair (t, i), i < t, of warp w's lane in round rd: the warp
// takes rows pr and Q-1-pr (pr = rd * NW + w); lanes below pr take row pr,
// the next Q-1-pr lanes row Q-1-pr
__host__ __device__ inline bool score_pair(int Q, int rd, int w, int lane, int& t, int& i) {
    const int pr = rd * NW + w;
    if (pr >= Q / 2 || lane >= Q - 1) return false;
    if (lane < pr) {
        t = pr; i = lane;
    } else {
        t = Q - 1 - pr; i = lane - pr;
    }
    return true;
}

// the inclusive cumsum over t of log w, per channel and in order of t (the
// plain version's order): thread k < K takes channel k, whose entries of Cx
// (row t + 1 = token t) it replaces by cum_t.  Where tot is given, tot[k] =
// total.
template <int Q>
__device__ __forceinline__ void chunk_cumsum(float* Cx, float* tot, int warp, int lane) {
    const int kk = warp * 32 + lane;
    if (kk < KD) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < Q; ++t) {
            s += Cx[(t + 1) * KP + kk];
            Cx[(t + 1) * KP + kk] = s;
        }
        if (tot) tot[kk] = s;
    }
}

// log w of a float4 of w into four consecutive entries of a KP row
__device__ __forceinline__ void stage_log(float* dst, const float4 w) {
    dst[0] = logf(w.x); dst[1] = logf(w.y); dst[2] = logf(w.z); dst[3] = logf(w.w);
}

// 16 or 4 bytes from device to shared memory, asynchronously (no
// registers); the thread's copies are complete after cp_async_wait, the
// block's after the barrier that follows it
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(smem))), "l"(gmem)
                 : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(smem))), "l"(gmem)
                 : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <int Q>
constexpr size_t state_smem_floats() { return (size_t)2 * Q * KD + (Q + 1) * KP + KD; }

// 1. D_c = sum_i (k_i e^{total - cum_i})^T v_i as [k][v], and e^{total}
template <int Q>
__global__ void __launch_bounds__(THREADS) wkv_scan_state_kernel(const ScanParams p) {
    extern __shared__ float4 smem4[];
    float* Kd = reinterpret_cast<float*>(smem4);   // [Q][K]: k, then k e^{total - cum}
    float* Vs = Kd + Q * KD;                       // [Q][V]
    float* Cx = Vs + Q * KD;                       // [Q+1][KP]: row t+1 = log w_t, then cum_t
    float* tot = Cx + (Q + 1) * KP;                // [K]
    const Item it = chunk_item(blockIdx.x, p.H, p.nc);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const size_t row = (size_t)p.H * KD;
    const size_t off = (((size_t)it.b * p.T + (size_t)it.c * Q) * p.H + it.h) * KD;
    // every copy in flight at once; then log2 w in place, each thread its own
    for (int i = tid; i < Q * KD / 4; i += THREADS) {
        const int t = i / (KD / 4), q = 4 * (i % (KD / 4));
        const size_t g = off + t * row + q;
        cp_async16(&Kd[t * KD + q], p.k + g);
        cp_async16(&Vs[t * KD + q], p.v + g);
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(&Cx[(t + 1) * KP + q + e], p.w + g + e);
    }
    cp_async_wait();
    for (int i = tid; i < Q * KD / 4; i += THREADS) {
        float* c = &Cx[(i / (KD / 4) + 1) * KP + 4 * (i % (KD / 4))];
#pragma unroll
        for (int e = 0; e < 4; ++e) c[e] = logf(c[e]);
    }
    __syncthreads();
    chunk_cumsum<Q>(Cx, tot, warp, lane);
    __syncthreads();
    for (int i = tid; i < Q * KD; i += THREADS) {
        const int t = i / KD, kk = i % KD;
        Kd[i] *= expf(tot[kk] - Cx[(t + 1) * KP + kk]);
    }
    __syncthreads();
    const int tk = tid / (KD / 4), tv = tid % (KD / 4);    // 4 x 4 tile of [k][v]
    float acc[4][4] = {};
#pragma unroll 4
    for (int i = 0; i < Q; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(&Kd[i * KD + 4 * tk]);
        const float4 b = *reinterpret_cast<const float4*>(&Vs[i * KD + 4 * tv]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
    }
    const size_t slot = ((size_t)it.b * p.H + it.h) * p.nc + it.c;
    float* d = p.delta + slot * KD * KD;
#pragma unroll
    for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(&d[(4 * tk + r) * KD + 4 * tv]) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    if (tid < KD) p.etot[slot * KD + tid] = expf(tot[tid]);
}

// 2. the carry: S_c = e^{total_c} S_{c-1} + D_c in chunk order from the
// carried state; S_{c-1} over D_c; the final state out.  Block bh * 4 +
// quarter, thread: one float4 of the [k][v] entries.  The loads of DEPTH
// chunks (D and e^{total}) are in flight together: none depends on the carry.
__global__ void __launch_bounds__(THREADS) wkv_scan_pass_kernel(const ScanParams p) {
    constexpr int V4 = KD * KD / 4;
    const size_t bh = blockIdx.x / 4;
    const int e = (blockIdx.x % 4) * THREADS + threadIdx.x;
    float4* d = reinterpret_cast<float4*>(p.delta) + bh * p.nc * V4 + e;
    const float* et = p.etot + bh * p.nc * KD + e / (KD / 4);
    float4 s = reinterpret_cast<const float4*>(p.s0)[bh * V4 + e];
    float4 dn[DEPTH];
    float en[DEPTH];
#pragma unroll
    for (int j = 0; j < DEPTH; ++j)
        if (j < p.nc) dn[j] = d[(size_t)j * V4], en[j] = et[(size_t)j * KD];
    for (int c0 = 0; c0 < p.nc; c0 += DEPTH) {
        float4 dc[DEPTH];
        float ec[DEPTH];
#pragma unroll
        for (int j = 0; j < DEPTH; ++j) dc[j] = dn[j], ec[j] = en[j];
#pragma unroll
        for (int j = 0; j < DEPTH; ++j) {               // the next batch, before any store
            const int c = c0 + DEPTH + j;
            if (c < p.nc) dn[j] = d[(size_t)c * V4], en[j] = et[(size_t)c * KD];
        }
#pragma unroll
        for (int j = 0; j < DEPTH; ++j) {
            const int c = c0 + j;
            if (c >= p.nc) break;
            d[(size_t)c * V4] = s;                      // the state entering chunk c
            s = make_float4(fmaf(ec[j], s.x, dc[j].x), fmaf(ec[j], s.y, dc[j].y),
                            fmaf(ec[j], s.z, dc[j].z), fmaf(ec[j], s.w, dc[j].w));
        }
    }
    reinterpret_cast<float4*>(p.s_out)[bh * V4 + e] = s;
}

template <int Q>
constexpr size_t out_smem_floats() {
    return (size_t)2 * Q * KP + (Q + 1) * KP + Q * KD + KD * KD + Q * (Q + 1) + Q;
}

// 3. y = (r e^{cum_{t-1}}) S_{c-1} + sum_{i<t} score v_i + bonus v_t
template <int Q>
__global__ void __launch_bounds__(THREADS) wkv_scan_out_kernel(const ScanParams p) {
    constexpr int QP = Q + 1;
    constexpr int ROUNDS = (Q / 2 + NW - 1) / NW;
    extern __shared__ float4 smem4[];
    float* Ss = reinterpret_cast<float*>(smem4);   // [K][V]: S_{c-1}
    float* Vs = Ss + KD * KD;                      // [Q][V]
    float* Rs = Vs + Q * KD;                       // [Q][KP]: r, then r e^{cum_{t-1}}
    float* Ks = Rs + Q * KP;                       // [Q][KP]: k
    float* Cx = Ks + Q * KP;                       // [Q+1][KP]: row 0 = 0, row t+1 = cum_t
    float* Sc = Cx + (Q + 1) * KP;                 // [Q][QP]: scores, i < t only
    float* bonus = Sc + Q * QP;                    // [Q]: r_t . (u * k_t)
    const Item it = chunk_item(blockIdx.x, p.H, p.nc);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const size_t row = (size_t)p.H * KD;
    const size_t off = (((size_t)it.b * p.T + (size_t)it.c * Q) * p.H + it.h) * KD;
    const size_t slot = ((size_t)it.b * p.H + it.h) * p.nc + it.c;
    // every copy in flight at once; then log2 w in place, each thread its own
    for (int i = tid; i < Q * KD / 4; i += THREADS) {
        const int t = i / (KD / 4), q = 4 * (i % (KD / 4));
        const size_t g = off + t * row + q;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            cp_async4(&Rs[t * KP + q + e], p.r + g + e);
            cp_async4(&Ks[t * KP + q + e], p.k + g + e);
            cp_async4(&Cx[(t + 1) * KP + q + e], p.w + g + e);
        }
        cp_async16(&Vs[t * KD + q], p.v + g);
    }
    const float* sp = p.delta + slot * KD * KD;
    for (int i = tid; i < KD * KD / 4; i += THREADS) cp_async16(&Ss[4 * i], sp + 4 * i);
    if (tid < KD) Cx[tid] = 0.f;
    cp_async_wait();
    for (int i = tid; i < Q * KD / 4; i += THREADS) {
        float* c = &Cx[(i / (KD / 4) + 1) * KP + 4 * (i % (KD / 4))];
#pragma unroll
        for (int e = 0; e < 4; ++e) c[e] = logf(c[e]);
    }
    __syncthreads();
    chunk_cumsum<Q>(Cx, nullptr, warp, lane);
    __syncthreads();

#pragma unroll
    for (int rd = 0; rd < ROUNDS; ++rd) {
        int t, i;
        if (!score_pair(Q, rd, warp, lane, t, i)) continue;
        const float* rt = Rs + t * KP;
        const float* ki = Ks + i * KP;
        const float* cp = Cx + t * KP;             // cum_{t-1}
        const float* ci = Cx + (i + 1) * KP;       // cum_i >= cum_{t-1}: the gap is <= 0
        float s = 0.f;
#pragma unroll 8
        for (int kk = 0; kk < KD; ++kk) s = fmaf(rt[kk] * ki[kk], expf(cp[kk] - ci[kk]), s);
        Sc[t * QP + i] = s;
    }
    const float* uh = p.u + (size_t)it.h * KD;
    for (int t = warp; t < Q; t += NW) {
        float s = Rs[t * KP + lane] * (__ldg(uh + lane) * Ks[t * KP + lane])
                  + Rs[t * KP + lane + 32] * (__ldg(uh + lane + 32) * Ks[t * KP + lane + 32]);
        s = warp_sum(s);
        if (lane == 0) bonus[t] = s;
    }
    __syncthreads();                                 // every read of r as it was is done
    for (int i = tid; i < Q * KD; i += THREADS) {
        const int t = i / KD, kk = i % KD;
        Rs[t * KP + kk] *= expf(Cx[t * KP + kk]);
    }
    __syncthreads();

    // y: rows ta and tb = Q-1-ta by columns 4 tv..4 tv+3
    const int tv = tid % (KD / 4), ta = tid / (KD / 4), tb = Q - 1 - ta;
    if (ta >= Q / 2) return;
    float acc[2][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < KD; ++kk) {
        const float ra = Rs[ta * KP + kk], rb = Rs[tb * KP + kk];
        const float4 s = *reinterpret_cast<const float4*>(&Ss[kk * KD + 4 * tv]);
        const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            acc[0][e] = fmaf(ra, sv[e], acc[0][e]);
            acc[1][e] = fmaf(rb, sv[e], acc[1][e]);
        }
    }
    for (int i = 0; i < tb; ++i) {
        const float4 vi = *reinterpret_cast<const float4*>(&Vs[i * KD + 4 * tv]);
        const float vv[4] = {vi.x, vi.y, vi.z, vi.w};
        const float sb = Sc[tb * QP + i], sa = i < ta ? Sc[ta * QP + i] : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            acc[1][e] = fmaf(sb, vv[e], acc[1][e]);
            if (i < ta) acc[0][e] = fmaf(sa, vv[e], acc[0][e]);
        }
    }
    const int rows[2] = {ta, tb};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
        const int t = rows[a];
        const float4 vt = *reinterpret_cast<const float4*>(&Vs[t * KD + 4 * tv]);
        const float bt = bonus[t];
        *reinterpret_cast<float4*>(p.y + off + t * row + 4 * tv) =
            make_float4(fmaf(bt, vt.x, acc[a][0]), fmaf(bt, vt.y, acc[a][1]),
                        fmaf(bt, vt.z, acc[a][2]), fmaf(bt, vt.w, acc[a][3]));
    }
}

// Small chunks: the token walk.  Block (b, h, 16-column part), 128 threads.
template <int Q>
__global__ void __launch_bounds__(SMALL_THREADS) wkv_scan_small_kernel(const ScanParams p) {
    constexpr int NCH = WINDOW / Q;
    constexpr int RV = WINDOW * KD / 4 / SMALL_THREADS;     // float4s of r (k, w) a thread stages
    static_assert(RV * SMALL_THREADS * 4 == WINDOW * KD && WINDOW * SMALL_COLS / 4 == SMALL_THREADS
                  && NROW == 8, "one float4 of v a thread, two of the state column");
    __shared__ __align__(16) float Rw[WINDOW][KD];   // r, then r e^{cum_{t-1}}
    __shared__ __align__(16) float Kw[WINDOW][KD];   // k, then k e^{total - cum}
    __shared__ float Lw[WINDOW][KP];                 // log w, then the in-chunk cumsum
    __shared__ __align__(16) float Vw[WINDOW][SMALL_COLS];
    __shared__ __align__(16) float Yw[WINDOW][SMALL_COLS];
    __shared__ float Etw[NCH][KD];                   // e^{total}
    __shared__ float Scw[WINDOW][Q];                 // score (t, i - chunk start), i < t
    __shared__ float Bonw[WINDOW];
    __shared__ float Uw[KD];

    const int parts = KD / SMALL_COLS;
    const int b = blockIdx.x / (p.H * parts), h = (blockIdx.x / parts) % p.H;
    const int v0 = (blockIdx.x % parts) * SMALL_COLS;
    const int tid = threadIdx.x, col = tid / SMALL_PARTS, part = tid % SMALL_PARTS;
    const size_t row = (size_t)p.H * KD;
    const size_t base = ((size_t)b * p.T * p.H + h) * KD;  // (b, 0, h, 0)
    const size_t bh = (size_t)b * p.H + h;
    if (tid < KD) Uw[tid] = p.u[(size_t)h * KD + tid];

    float4 rr[RV], rk[RV], rw[RV], rv;
    auto fetch = [&](int t0) {
        const int n = min(WINDOW, p.T - t0);
#pragma unroll
        for (int j = 0; j < RV; ++j) {
            const int g = tid + j * SMALL_THREADS, t = g / (KD / 4), q = 4 * (g % (KD / 4));
            if (t < n) {
                const size_t a = base + (t0 + t) * row + q;
                rr[j] = ldg4(p.r + a);
                rk[j] = ldg4(p.k + a);
                rw[j] = ldg4(p.w + a);
            }
        }
        const int t = tid / (SMALL_COLS / 4), q = 4 * (tid % (SMALL_COLS / 4));
        if (t < n) rv = ldg4(p.v + base + (t0 + t) * row + v0 + q);
    };

    float S[NROW], D[NROW];
#pragma unroll
    for (int e = 0; e < NROW; ++e) S[e] = p.s0[(bh * KD + NROW * part + e) * KD + v0 + col];
    fetch(0);
    for (int t0 = 0; t0 < p.T; t0 += WINDOW) {
        const int n = min(WINDOW, p.T - t0), nch = n / Q;
        __syncthreads();                             // the last window's readers are done
#pragma unroll
        for (int j = 0; j < RV; ++j) {
            const int g = tid + j * SMALL_THREADS, t = g / (KD / 4), q = 4 * (g % (KD / 4));
            if (t < n) {
                *reinterpret_cast<float4*>(&Rw[t][q]) = rr[j];
                *reinterpret_cast<float4*>(&Kw[t][q]) = rk[j];
                stage_log(&Lw[t][q], rw[j]);
            }
        }
        {
            const int t = tid / (SMALL_COLS / 4), q = 4 * (tid % (SMALL_COLS / 4));
            if (t < n) *reinterpret_cast<float4*>(&Vw[t][q]) = rv;
        }
        if (t0 + WINDOW < p.T) fetch(t0 + WINDOW);   // in flight through this window
        __syncthreads();
        // each chunk's cumsum (a thread per chunk and channel, in order of t)
        // and e^{total}
        for (int task = tid; task < nch * KD; task += SMALL_THREADS) {
            const int ch = task / KD, kk = task % KD;
            float s = 0.f;
            for (int t = ch * Q; t < ch * Q + Q; ++t) {
                s += Lw[t][kk];
                Lw[t][kk] = s;
            }
            Etw[ch][kk] = expf(s);
        }
        __syncthreads();
        // the in-chunk scores (i < t) and the bonus, from r and k as staged;
        // a thread's sum over k starts at its own lane (no bank conflicts)
        const int npairs = nch * Q * (Q - 1) / 2;
        for (int task = tid; task < npairs + n; task += SMALL_THREADS) {
            if constexpr (Q == 1) {
            } else if (task < npairs) {
                const int ch = task / (Q * (Q - 1) / 2);
                int tt = 1, ii = task % (Q * (Q - 1) / 2);
                while (ii >= tt) ii -= tt++;         // pair (tt, ii), ii < tt, in the chunk
                const int t = ch * Q + tt, i = ch * Q + ii;
                float s = 0.f;
                for (int j = 0; j < KD; ++j) {
                    const int kk = (j + tid) % KD;
                    s = fmaf(Rw[t][kk] * Kw[i][kk], expf(Lw[t - 1][kk] - Lw[i][kk]), s);
                }
                Scw[t][ii] = s;
            }
            if (task >= npairs) {
                const int t = task - npairs;
                float s = 0.f;
                for (int kk = 0; kk < KD; ++kk) s = fmaf(Rw[t][kk], Uw[kk] * Kw[t][kk], s);
                Bonw[t] = s;
            }
        }
        __syncthreads();
        // r e^{cum_{t-1}} (cum_{-1} = 0) and k e^{total - cum}, in place
        for (int task = tid; task < n * KD; task += SMALL_THREADS) {
            const int t = task / KD, kk = task % KD, tt = t % Q, last = t - tt + Q - 1;
            Rw[t][kk] *= expf(tt == 0 ? 0.f : Lw[t - 1][kk]);
            Kw[t][kk] *= expf(Lw[last][kk] - Lw[t][kk]);
        }
        __syncthreads();
        // the walk: no barrier per token
        for (int ch = 0; ch < nch; ++ch) {
#pragma unroll
            for (int e = 0; e < NROW; ++e) D[e] = 0.f;
            for (int tt = 0; tt < Q; ++tt) {
                const int t = ch * Q + tt;
                float rd[NROW], kd[NROW];
                unpack8(&Rw[t][NROW * part], rd);
                float dot = 0.f;
#pragma unroll
                for (int e = 0; e < NROW; ++e) dot = fmaf(rd[e], S[e], dot);
#pragma unroll
                for (int o = SMALL_PARTS / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
                const float vt = Vw[t][col];
                for (int ii = 0; ii < tt; ++ii) dot = fmaf(Scw[t][ii], Vw[ch * Q + ii][col], dot);
                if (part == 0) Yw[t][col] = fmaf(Bonw[t], vt, dot);
                unpack8(&Kw[t][NROW * part], kd);
#pragma unroll
                for (int e = 0; e < NROW; ++e) D[e] = fmaf(kd[e], vt, D[e]);
            }
#pragma unroll
            for (int e = 0; e < NROW; ++e) S[e] = fmaf(Etw[ch][NROW * part + e], S[e], D[e]);
        }
        __syncthreads();
        {
            const int t = tid / (SMALL_COLS / 4), q = 4 * (tid % (SMALL_COLS / 4));
            if (t < n)
                *reinterpret_cast<float4*>(p.y + base + (t0 + t) * row + v0 + q) =
                    *reinterpret_cast<const float4*>(&Yw[t][q]);
        }
    }
#pragma unroll
    for (int e = 0; e < NROW; ++e) p.s_out[(bh * KD + NROW * part + e) * KD + v0 + col] = S[e];
}

struct DecodeParams {
    const float* r;
    const float* k;
    const float* v;
    const float* w;
    const float* u;
    const float* s;
    float* y;
    float* s_out;                   // may be s: then the active slots' rows only
    const unsigned char* active;    // B flags, or null: every slot active
    int H;
};

constexpr int DEC_COLS = KD / 4;                 // float4 column groups of a row: 16
constexpr int DEC_GROUPS = THREADS / DEC_COLS;   // row groups: 16
constexpr int DEC_ROWS = KD / DEC_GROUPS;        // rows a thread holds: 4
static_assert(DEC_ROWS == 4, "r, k, w and u of a thread's rows as one float4 each");

__device__ __forceinline__ void unpack(const float4 v, float (&a)[4]) {
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}

// The state is read once and written once a launch, and a serve tick finds
// it cold (24 layers between two reads): streaming loads and stores (evict
// first).  Never the non-coherent path (__ldg, ld.global.nc): the same
// launch may write what it reads.
__device__ __forceinline__ float4 ld_state(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st_state(float* p, const float4 v) {
    __stcs(reinterpret_cast<float4*>(p), v);
}

__global__ void __launch_bounds__(THREADS) wkv_decode_kernel(const DecodeParams p) {
    __shared__ __align__(16) float part[DEC_GROUPS][KD];   // out's partials by row group
    const size_t bh = blockIdx.x;
    const int h = blockIdx.x % p.H;
    const int cg = threadIdx.x % DEC_COLS, rg = threadIdx.x / DEC_COLS;
    const int k0 = rg * DEC_ROWS, v0 = 4 * cg;
    const size_t base = (bh * KD + k0) * KD + v0;
    // every load at once, no barrier before the update: the thread's 4 x 4
    // block of the state, then r, k, w, u of its rows and v of its columns
    float4 sv[DEC_ROWS];
#pragma unroll
    for (int i = 0; i < DEC_ROWS; ++i) sv[i] = ld_state(p.s + base + (size_t)i * KD);
    const bool act = p.active == nullptr || p.active[bh / p.H] != 0;
    float rr[4], kk[4], ww[4], uu[4], vv[4];
    unpack(__ldg(reinterpret_cast<const float4*>(p.r + bh * KD + k0)), rr);
    unpack(__ldg(reinterpret_cast<const float4*>(p.k + bh * KD + k0)), kk);
    unpack(__ldg(reinterpret_cast<const float4*>(p.w + bh * KD + k0)), ww);
    unpack(__ldg(reinterpret_cast<const float4*>(p.u + (size_t)h * KD + k0)), uu);
    unpack(__ldg(reinterpret_cast<const float4*>(p.v + bh * KD + v0)), vv);
    float out[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < DEC_ROWS; ++i) {
        float sr[4], so[4];
        unpack(sv[i], sr);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const float kv = __fmul_rn(kk[i], vv[c]);
            out[c] = fmaf(rr[i], sr[c] + uu[i] * kv, out[c]);
            so[c] = __fadd_rn(__fmul_rn(ww[i], sr[c]), kv);   // the plain two roundings
        }
        if (act) st_state(p.s_out + base + (size_t)i * KD, make_float4(so[0], so[1], so[2], so[3]));
    }
    *reinterpret_cast<float4*>(&part[rg][v0]) = make_float4(out[0], out[1], out[2], out[3]);
    __syncthreads();
    // out_v: the 16 row groups' partials in order (fixed: repeats are bit-identical)
    if (threadIdx.x < KD) {
        float acc = part[0][threadIdx.x];
#pragma unroll
        for (int g = 1; g < DEC_GROUPS; ++g) acc += part[g][threadIdx.x];
        p.y[bh * KD + threadIdx.x] = acc;
    }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int Q>
cudaError_t launch_chunks(const ScanParams& p, cudaStream_t s) {
    const int items = p.B * p.H * p.nc;
    const size_t sa = state_smem_floats<Q>() * sizeof(float);
    const size_t sc = out_smem_floats<Q>() * sizeof(float);
    cudaError_t e = allow_smem(wkv_scan_state_kernel<Q>, sa);
    if (e == cudaSuccess) e = allow_smem(wkv_scan_out_kernel<Q>, sc);
    if (e != cudaSuccess) return e;
    wkv_scan_state_kernel<Q><<<items, THREADS, sa, s>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    wkv_scan_pass_kernel<<<p.B * p.H * 4, THREADS, 0, s>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    wkv_scan_out_kernel<Q><<<items, THREADS, sc, s>>>(p);
    return cudaGetLastError();
}

template <int Q>
cudaError_t launch_small(const ScanParams& p, cudaStream_t s) {
    wkv_scan_small_kernel<Q><<<p.B * p.H * (KD / SMALL_COLS), SMALL_THREADS, 0, s>>>(p);
    return cudaGetLastError();
}

bool scan_shape_ok(int B, int T, int H, int K, int V, int Q) {
    return B >= 0 && H >= 0 && T >= 1 && Q >= 1 && Q <= Q_MAX && (Q & (Q - 1)) == 0
           && T % Q == 0 && K == KD && V == KD;
}

}  // namespace

// Floats of chunk-state scratch wkv_scan_fwd needs (the wrapper allocates
// this many): B H (T/Q) (K V + K) for Q > 8, none for the token
// walk.
extern "C" long long wkv_scan_scratch(int B, int T, int H, int Q) {
    if (Q <= SMALL_Q) return 0;
    return (long long)B * H * (T / Q) * (KD * KD + KD);
}

// r, k, w: (B, T, H, K), v: (B, T, H, V), u: (H, K), state: (B, H, K, V);
// y: (B, T, H, V), state_out: (B, H, K, V); all fp32, contiguous, 16-byte
// aligned; scratch: wkv_scan_scratch(B, T, H, Q) fp32, 16-byte aligned.
// Built for K = V = 64; Q a power of two <= 32 dividing T.  Anything else
// gives cudaErrorInvalidValue.
extern "C" int wkv_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                            const void* u, const void* state, void* y, void* state_out,
                            void* scratch, int B, int T, int H, int K, int V, int Q,
                            void* stream) {
    if (!scan_shape_ok(B, T, H, K, V, Q)) return cudaErrorInvalidValue;
    if (B == 0 || H == 0) return cudaSuccess;
    ScanParams p;
    p.r = static_cast<const float*>(r); p.k = static_cast<const float*>(k);
    p.v = static_cast<const float*>(v); p.w = static_cast<const float*>(w);
    p.u = static_cast<const float*>(u); p.s0 = static_cast<const float*>(state);
    p.y = static_cast<float*>(y); p.s_out = static_cast<float*>(state_out);
    p.B = B; p.T = T; p.H = H; p.Q = Q; p.nc = T / Q;
    p.delta = static_cast<float*>(scratch);
    p.etot = p.delta + (size_t)B * H * p.nc * KD * KD;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (Q) {
        case 1: return launch_small<1>(p, s);
        case 2: return launch_small<2>(p, s);
        case 4: return launch_small<4>(p, s);
        case 8: return launch_small<8>(p, s);
        case 16: return launch_chunks<16>(p, s);
        default: return launch_chunks<32>(p, s);
    }
}

// The scan's work division, as the kernels take it (for the Python mirrors
// in kernels/tiling.py).  wkv_scan_items: (b, h, chunk) of each block of the
// chunk kernels in block order, or (b, h, first state column) of each block
// of the token walk; returns the number of blocks (cap triples at most are
// written).  wkv_scan_pairs: (thread, t, i) of the scores wkv_scan_out_kernel
// forms, in the order its threads take them (round, then thread); returns
// their number.
extern "C" int wkv_scan_items(int B, int T, int H, int Q, int* out, int cap) {
    if (!scan_shape_ok(B, T, H, KD, KD, Q)) return -1;
    if (Q <= SMALL_Q) {
        const int parts = KD / SMALL_COLS, n = B * H * parts;
        for (int j = 0; j < n && j < cap; ++j) {
            out[3 * j] = j / (H * parts);
            out[3 * j + 1] = (j / parts) % H;
            out[3 * j + 2] = (j % parts) * SMALL_COLS;
        }
        return n;
    }
    const int nc = T / Q, n = B * H * nc;
    for (int j = 0; j < n && j < cap; ++j) {
        const Item it = chunk_item(j, H, nc);
        out[3 * j] = it.b; out[3 * j + 1] = it.h; out[3 * j + 2] = it.c;
    }
    return n;
}

extern "C" int wkv_scan_pairs(int Q, int* out, int cap) {
    if (Q <= SMALL_Q || Q > Q_MAX || (Q & (Q - 1)) != 0) return -1;
    const int rounds = (Q / 2 + NW - 1) / NW;
    int n = 0;
    for (int rd = 0; rd < rounds; ++rd)
        for (int th = 0; th < THREADS; ++th) {
            int t, i;
            if (!score_pair(Q, rd, th / 32, th % 32, t, i)) continue;
            if (n < cap) out[3 * n] = th, out[3 * n + 1] = t, out[3 * n + 2] = i;
            ++n;
        }
    return n;
}

// r, k, w: (B, H, K), v: (B, H, V), u: (H, K), state: (B, H, K, V); y:
// (B, H, V); state_out like state, either a buffer apart from it or state
// itself; all fp32, contiguous, 16-byte aligned; active: B bytes (0: the
// slot is inactive) or null (every slot active).  state_out gets the new
// state in the active slots' rows, the others' are not written; y is every
// slot's.  Built for K = V = 64; anything else gives cudaErrorInvalidValue.
extern "C" int wkv_decode_fwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* state, void* y, void* state_out,
                              const void* active, int B, int H, int K, int V, void* stream) {
    if (B < 0 || H < 0 || K != KD || V != KD) return cudaErrorInvalidValue;
    if (B == 0 || H == 0) return cudaSuccess;
    DecodeParams p;
    p.r = static_cast<const float*>(r); p.k = static_cast<const float*>(k);
    p.v = static_cast<const float*>(v); p.w = static_cast<const float*>(w);
    p.u = static_cast<const float*>(u); p.s = static_cast<const float*>(state);
    p.y = static_cast<float*>(y); p.s_out = static_cast<float*>(state_out);
    p.active = static_cast<const unsigned char*>(active);
    p.H = H;
    wkv_decode_kernel<<<B * H, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return cudaGetLastError();
}
