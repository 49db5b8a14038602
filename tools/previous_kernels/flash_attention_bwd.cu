// FlashAttention-2 backward for Hopper: dQ, and dK/dV summed over each KV
// head's G query heads, from Q, K, V, dO, the forward's fp32 row LSE and
// delta = rowsum(dO * O).
//
// Replaces: repro/kernels/flash_attention.py:_bwd_dq_kernel and
//   _bwd_dkv_kernel (via flash_attention_bwd).  Both recompute
//   P = exp(S - LSE) with S = cap(Q K^T / sqrt(hd)) and the causal,
//   sliding-window and q_offset masks; dP = dO V^T; dS = P (dP - delta),
//   times 1 - t^2 under the softcap t = tanh(s/c); dQ = dS K / sqrt(hd),
//   dK = dS^T Q / sqrt(hd), dV = P^T dO.
// Bound on the H100: operations.  A causal backward at S = 2048, hd = 128
//   does five S x S x hd products over the unmasked half (two recomputes,
//   dQ, dK, dV), ~5x the bytes of Q, K, V, O, dO in FLOP per byte.
// Design: the TPU kernels carry dQ (grid axis nk) and dK/dV (grid axes G
//   and nq) in VMEM across sequential grid steps.  Blocks on the H100 run in
//   no order, so each block owns its output tile and loops itself:
//   - dQ: one block per (b, h, 64 query rows) loops over the key tiles the
//     rows can see (causal limit, window start), with dQ in registers.
//   - dK/dV: one block per (b, KV head, 64 keys) loops over the G query
//     heads of the group and the query tiles that can see its keys, with
//     dK and dV in registers: the group sum happens inside the block, so
//     there are no atomics and K/V are never replicated.
//   A masked score gets p = 0 exactly (not exp(-1e30 - lse)), so rows that
//   see no key and zero-padded rows past Sq or Skv contribute nothing.
//   Q, K, V and dO are read through their strides in the model's
//   (B, S, H, hd) layout.
//   bf16: 4 warps; every product is mma.sync.m16n8k16 (bf16 in, fp32
//   accumulate).  The score and dP accumulators are reused in registers as
//   the A operand of the next product (FA-2): dQ += dS K per query tile of
//   16 rows per warp; for dK/dV each warp owns 16 keys and computes S^T and
//   dP^T directly, so P^T and dS^T are A operands of dV += P^T dO and
//   dK += dS^T Q.  P and dS are rounded to bf16 for those products.  Tiles
//   live in dynamic shared memory (70 KB for dK/dV at hd = 128).
//   fp32: FFMA only (no TF32) so the check against the plain fp32 version
//   stays tight, one key per lane for the scores as in the forward.
//   Head dims 64, 80, 88 and 128, as the forward (80 is a multiple of 16
//   and needs no padding in bf16): the contractions over hd
//   (S = Q K^T, dP = dO V^T and their transposes) run hd 88 as 96 over
//   tiles whose columns 88..95 are zeros written to shared memory; the
//   products whose n dimension is hd (dQ, dK, dV) tile by 8 and store only
//   the 88 real columns.  The fp32 dQ kernel pads to a multiple of 32 lanes;
//   the fp32 dK/dV kernel splits hd over 4 threads, which 80 and 88 allow.
//   Simple first version: no cp.async/TMA double buffering, no wgmma.
#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr float NEG_INF = -1e30f;

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
};

// Key range [lo, hi) that the query rows [q0, q1) can see.
__device__ __forceinline__ void key_range(const Params& p, int q0, int q1,
                                          int& lo, int& hi) {
    lo = 0;
    hi = p.Skv;
    if (p.causal) hi = min(hi, q1 - 1 + p.q_offset + 1);
    if (p.window > 0) lo = max(0, q0 + p.q_offset - p.window + 1);
}

// Query range [lo, hi) that can see some key of [k0, k1).
__device__ __forceinline__ void query_range(const Params& p, int k0, int k1,
                                            int& lo, int& hi) {
    lo = 0;
    hi = p.Sq;
    if (p.causal) lo = max(0, k0 - p.q_offset);
    if (p.window > 0) hi = min(hi, max(0, k1 - 1 + p.window - p.q_offset));
}

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
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [s0, s0 + 64) of one head into shared memory (pitch LD),
// pad16(HD) columns of which the first HD are read, zero-filling rows past S
// and columns past HD.  16-byte vectors; strides are multiples of 8.
template <int HD, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long long ss,
                                          int s0, int S) {
    constexpr int VPR = pad16(HD) / 8;
    for (int i = threadIdx.x; i < 64 * VPR; i += blockDim.x) {
        const int r = i / VPR, c = (i % VPR) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (s0 + r < S && c < HD)
            val = *reinterpret_cast<const uint4*>(base + (s0 + r) * ss + c);
        *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
}

// A operand (16 rows from r0, 16 columns from c) of a row-major smem tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t, int r0, int c) {
    a[0] = *reinterpret_cast<const uint32_t*>(t + r0 * LD + c);
    a[1] = *reinterpret_cast<const uint32_t*>(t + (r0 + 8) * LD + c);
    a[2] = *reinterpret_cast<const uint32_t*>(t + r0 * LD + c + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(t + (r0 + 8) * LD + c + 8);
}

// C[16 x 64] = A[16 rows of tile a from r0] . B^T for the 64 rows of tile b
// (both row-major over HD, zero-padded to pad16(HD)): the score-like
// products S, dP, S^T and dP^T.
template <int HD, int LD>
__device__ __forceinline__ void rows_dot_rows(float (&c)[BN / 8][4], const bf16* a,
                                              int r0, const bf16* b, int t, int g) {
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < pad16(HD) / 16; ++kk) {
        uint32_t af[4];
        load_a<LD>(af, a, r0, kk * 16 + 2 * t);
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
            const bf16* brow = b + (nt * 8 + g) * LD + kk * 16 + 2 * t;
            mma_bf16(c[nt], af, *reinterpret_cast<const uint32_t*>(brow),
                     *reinterpret_cast<const uint32_t*>(brow + 8));
        }
    }
}

// acc[16 x HD] += X[16 x 64] . T[64 x HD], X given as accumulator fragments
// (rounded to bf16 here), T a row-major smem tile (row = the summed index).
template <int HD, int LD>
__device__ __forceinline__ void acc_times_tile(float (&acc)[HD / 8][4],
                                               const float (&x)[BN / 8][4],
                                               const bf16* tile, int t, int g) {
    const unsigned short* raw = reinterpret_cast<const unsigned short*>(tile);
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
        const uint32_t a[4] = {
            pack_bf16(x[2 * kc][0], x[2 * kc][1]),
            pack_bf16(x[2 * kc][2], x[2 * kc][3]),
            pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]),
            pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]),
        };
        const unsigned short* r = raw + (kc * 16 + 2 * t) * LD + g;
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
            const unsigned short* vp = r + dt * 8;
            const uint32_t b0 = (uint32_t)vp[0] | ((uint32_t)vp[LD] << 16);
            const uint32_t b1 = (uint32_t)vp[8 * LD] | ((uint32_t)vp[9 * LD] << 16);
            mma_bf16(acc[dt], a, b0, b1);
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16_kernel(const Params p) {
    constexpr int LD = pad16(HD) + 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* dOs = Qs + BM * LD;
    bf16* Ks = dOs + BM * LD;
    bf16* Vs = Ks + BN * LD;

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
    const int hk = h / (p.Hq / p.Hkv);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16;              // this warp's rows; the thread's: g, g + 8

    const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const bf16* dob = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
    const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
    load_tile<HD, LD>(Qs, qb, p.q_ss, q0, p.Sq);
    load_tile<HD, LD>(dOs, dob, p.do_ss, q0, p.Sq);

    float lse[2], dlt[2];
    int qrow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        qrow[r] = q0 + r0 + g + 8 * r;
        const size_t i = ((size_t)b * p.Hq + h) * p.Sq + min(qrow[r], p.Sq - 1);
        lse[r] = p.lse[i];
        dlt[r] = p.delta[i];
    }
    float acc[HD / 8][4];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

    int lo, hi;
    key_range(p, q0, min(q0 + BM, p.Sq), lo, hi);
    for (int k0 = (lo / BN) * BN; k0 < hi; k0 += BN) {
        __syncthreads();
        load_tile<HD, LD>(Ks, kb, p.k_ss, k0, p.Skv);
        load_tile<HD, LD>(Vs, vb, p.v_ss, k0, p.Skv);
        __syncthreads();
        float s[BN / 8][4], dp[BN / 8][4];
        rows_dot_rows<HD, LD>(s, Qs, r0 + g, Ks, t, g);
        rows_dot_rows<HD, LD>(dp, dOs, r0 + g, Vs, t, g);
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                float pe, jac;
                prob(p, s[nt][e], lse[r], qrow[r], k0 + nt * 8 + 2 * t + (e & 1), pe, jac);
                s[nt][e] = pe * (dp[nt][e] - dlt[r]) * jac;       // dS
            }
        acc_times_tile<HD, LD>(acc, s, Ks, t, g);
    }

    bf16* dqb = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (qrow[r] >= p.Sq) continue;
        bf16* row = dqb + qrow[r] * p.dq_ss + 2 * t;
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt)
            *reinterpret_cast<uint32_t*>(row + dt * 8) =
                pack_bf16(acc[dt][2 * r] * p.scale, acc[dt][2 * r + 1] * p.scale);
    }
}

template <int HD>
__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16_kernel(const Params p) {
    constexpr int LD = pad16(HD) + 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
    bf16* Vs = Ks + BN * LD;
    bf16* Qs = Vs + BN * LD;
    bf16* dOs = Qs + BM * LD;
    float* lse_s = reinterpret_cast<float*>(dOs + BM * LD);
    float* dlt_s = lse_s + BM;

    const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * BN;
    const int G = p.Hq / p.Hkv;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16;              // this warp's keys; the thread's: g, g + 8

    const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
    const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
    load_tile<HD, LD>(Ks, kb, p.k_ss, k0, p.Skv);
    load_tile<HD, LD>(Vs, vb, p.v_ss, k0, p.Skv);

    float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
        dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
        dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
    }
    const int kpos[2] = {k0 + r0 + g, k0 + r0 + g + 8};

    int lo, hi;
    query_range(p, k0, min(k0 + BN, p.Skv), lo, hi);
    for (int hq = hk * G; hq < (hk + 1) * G; ++hq) {
        const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + hq * p.q_sh;
        const bf16* dob = static_cast<const bf16*>(p.dout) + b * p.do_sb + hq * p.do_sh;
        const float* lse_b = p.lse + ((size_t)b * p.Hq + hq) * p.Sq;
        const float* dlt_b = p.delta + ((size_t)b * p.Hq + hq) * p.Sq;
        for (int q0 = (lo / BM) * BM; q0 < hi; q0 += BM) {
            __syncthreads();
            load_tile<HD, LD>(Qs, qb, p.q_ss, q0, p.Sq);
            load_tile<HD, LD>(dOs, dob, p.do_ss, q0, p.Sq);
            for (int i = threadIdx.x; i < BM; i += blockDim.x) {
                const bool in = q0 + i < p.Sq;
                lse_s[i] = in ? lse_b[q0 + i] : 0.f;
                dlt_s[i] = in ? dlt_b[q0 + i] : 0.f;
            }
            __syncthreads();
            float s[BM / 8][4], dp[BM / 8][4];   // S^T and dP^T: rows = keys
            rows_dot_rows<HD, LD>(s, Ks, r0 + g, Qs, t, g);
            rows_dot_rows<HD, LD>(dp, Vs, r0 + g, dOs, t, g);
#pragma unroll
            for (int nt = 0; nt < BM / 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int qi = nt * 8 + 2 * t + (e & 1);
                    float pe, jac;
                    prob(p, s[nt][e], lse_s[qi], q0 + qi, kpos[e >> 1], pe, jac);
                    s[nt][e] = pe;                                   // P^T
                    dp[nt][e] = pe * (dp[nt][e] - dlt_s[qi]) * jac;  // dS^T
                }
            acc_times_tile<HD, LD>(dv, s, dOs, t, g);
            acc_times_tile<HD, LD>(dk, dp, Qs, t, g);
        }
    }

    bf16* dkb = static_cast<bf16*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
    bf16* dvb = static_cast<bf16*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (kpos[r] >= p.Skv) continue;
        bf16* krow = dkb + kpos[r] * p.dk_ss + 2 * t;
        bf16* vrow = dvb + kpos[r] * p.dv_ss + 2 * t;
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
            *reinterpret_cast<uint32_t*>(krow + dt * 8) =
                pack_bf16(dk[dt][2 * r] * p.scale, dk[dt][2 * r + 1] * p.scale);
            *reinterpret_cast<uint32_t*>(vrow + dt * 8) =
                pack_bf16(dv[dt][2 * r], dv[dt][2 * r + 1]);
        }
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

template <int HD>
cudaError_t launch_dq(const Params& p, int dtype, cudaStream_t s) {
    if (dtype == DTYPE_BF16)
        return launch_kernel(flash_bwd_dq_bf16_kernel<HD>, dim3((p.Sq + BM - 1) / BM, p.Hq, p.B),
                             4 * 64 * (pad16(HD) + 8) * sizeof(bf16), p, s);
    return launch_kernel(flash_bwd_dq_f32_kernel<HD>, dim3((p.Sq + FBM - 1) / FBM, p.Hq, p.B),
                         (2 * FBM * HD + 2 * FBN * (pad32(HD) + 1)) * sizeof(float), p, s);
}

template <int HD>
cudaError_t launch_dkv(const Params& p, int dtype, cudaStream_t s) {
    if (dtype == DTYPE_BF16)
        return launch_kernel(flash_bwd_dkv_bf16_kernel<HD>,
                             dim3((p.Skv + BN - 1) / BN, p.Hkv, p.B),
                             4 * 64 * (pad16(HD) + 8) * sizeof(bf16) + 2 * BM * sizeof(float),
                             p, s);
    return launch_kernel(flash_bwd_dkv_f32_kernel<HD>,
                         dim3((p.Skv + FBN - 1) / FBN, p.Hkv, p.B),
                         (2 * FBN * (HD + 1) + 2 * FBM * HD + 2 * FBM * FBN) * sizeof(float),
                         p, s);
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
    for (int i = 0; i < 21; ++i) *f[i] = st[i];
    p.causal = causal; p.window = window; p.q_offset = q_offset;
    p.softcap = softcap; p.scale = scale;
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
