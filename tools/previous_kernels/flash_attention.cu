// FlashAttention-2 forward for Hopper: O = softmax(mask(cap(Q K^T / sqrt(hd)))) V
// and the fp32 row log-sum-exp, with native GQA.
//
// Replaces: repro/kernels/flash_attention.py:_fwd_kernel (via
//   flash_attention_fwd): online softmax, causal and sliding-window masks,
//   q_offset, the logit softcap tanh(s/c)*c applied after the 1/sqrt(hd)
//   scale, query head h reading KV head h // G, output O and LSE (B, H, Sq).
// Bound on the H100: operations.  A causal prefill at S = 2048, hd = 128
//   does ~4*S*S/2*hd FLOP per head, ~300 FLOP per byte of Q, K, V and O,
//   above the ridge; short prompts and the masked-out half shift it toward
//   memory.
// Design: the TPU kernel carries (m, l, acc) in VMEM across a sequential nk
//   grid axis.  Here one block owns (b, h, 64 query rows) and loops over the
//   key tiles itself, with (m, l, acc) in registers.  The loop bounds skip
//   fully masked tiles (causal limit, window start).  Masked scores become
//   -1e30 as on the TPU and their probability is forced to 0, so a row that
//   sees no key writes 0 and LSE -1e30 (the TPU kernel's safe_l).  Q, K and
//   V are read through their strides in the model's (B, S, H, hd) layout,
//   so no transposes are needed.
//   bf16: 4 warps, 16 query rows each; S = Q K^T and O += P V run on the
//   tensor cores as mma.sync.m16n8k16 (bf16 in, fp32 accumulate), with the
//   score accumulators reused in registers as the P operand (FA-2).  K and V
//   tiles of 64 keys sit in shared memory (dynamic, 52 KB at hd = 128).
//   fp32: FFMA only (no TF32) so the check against the plain fp32 version
//   stays tight: a warp per 4 query rows, one key per lane for the scores,
//   head dims split across lanes for the P V update.
//   Head dims 64, 80 (zamba2's shared block: 2560 over 32 heads), 88
//   (gpt-1.4b: 2112 over 24 heads) and 128.  80 is a multiple of 16 and
//   runs as it is; the fp32 kernel pads it to 96 lanes.  The
//   contraction over hd (S = Q K^T) steps k by 16 in mma.sync, so hd 88 runs
//   as 96: the Q and K tiles get columns 88..95 written as zeros in shared
//   memory (never read from memory; uninitialised shared memory may hold NaN
//   bit patterns, and 0 * NaN = NaN).  Products whose n dimension is hd
//   (O = P V) tile by 8, which 88 allows, and only the 88 real columns are
//   stored.  The fp32 kernel pads the same way to a multiple of 32 lanes.
//   The scale stays 1/sqrt(hd) of the real head dim.
//   Simple first version: no cp.async/TMA double buffering, no wgmma.
#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr float NEG_INF = -1e30f;

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
};

// Key range [lo, hi) that the query rows [q0, q1) of a tile can see.
__device__ __forceinline__ void key_range(const Params& p, int q0, int q1,
                                          int& lo, int& hi) {
    lo = 0;
    hi = p.Skv;
    if (p.causal) hi = min(hi, q1 - 1 + p.q_offset + 1);
    if (p.window > 0) lo = max(0, q0 + p.q_offset - p.window + 1);
}

__device__ __forceinline__ float score(const Params& p, float s, int qpos, int kpos) {
    s *= p.scale;
    if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
    bool ok = kpos < p.Skv;
    if (p.causal) ok = ok && kpos <= qpos;
    if (p.window > 0) ok = ok && qpos - kpos < p.window;
    return ok ? s : NEG_INF;
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

// Copy rows [s0, s0 + 64) of one head into shared memory (pitch LD), HDP
// columns of which the first HD are read, zero-filling rows past S and
// columns past HD.  16-byte vectors; strides are multiples of 8.
template <int HD, int HDP, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long long ss,
                                          int s0, int S) {
    constexpr int VPR = HDP / 8;  // vectors per row
    for (int i = threadIdx.x; i < 64 * VPR; i += blockDim.x) {
        const int r = i / VPR, c = (i % VPR) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (s0 + r < S && c < HD)
            val = *reinterpret_cast<const uint4*>(base + (s0 + r) * ss + c);
        *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
}

template <int HD>
__global__ void __launch_bounds__(128) flash_fwd_bf16_kernel(const Params p) {
    constexpr int HDP = pad16(HD);        // the contraction's width
    constexpr int LD = HDP + 8;           // pitch: conflict-free fragment loads
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* Ks = Qs + BM * LD;
    bf16* Vs = Ks + BN * LD;
    const unsigned short* Vraw = reinterpret_cast<const unsigned short*>(Vs);

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
    const int hk = h / (p.Hq / p.Hkv);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16 + g;         // this thread's rows: r0 and r0 + 8

    const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
    const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

    load_tile<HD, HDP, LD>(Qs, qb, p.q_ss, q0, p.Sq);
    __syncthreads();
    uint32_t qf[HDP / 16][4];
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(Qs + r0 * LD + c);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(Qs + (r0 + 8) * LD + c);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(Qs + r0 * LD + c + 8);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(Qs + (r0 + 8) * LD + c + 8);
    }

    float acc[HD / 8][4];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // l: this thread's part
    const int qpos[2] = {q0 + r0 + p.q_offset, q0 + r0 + 8 + p.q_offset};

    int lo, hi;
    key_range(p, q0, min(q0 + BM, p.Sq), lo, hi);
    for (int k0 = (lo / BN) * BN; k0 < hi; k0 += BN) {
        __syncthreads();                  // everyone is done with the last tile
        load_tile<HD, HDP, LD>(Ks, kb, p.k_ss, k0, p.Skv);
        load_tile<HD, HDP, LD>(Vs, vb, p.v_ss, k0, p.Skv);
        __syncthreads();

        float s[BN / 8][4];
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
            s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
            const bf16* krow = Ks + (nt * 8 + g) * LD + 2 * t;
#pragma unroll
            for (int kk = 0; kk < HDP / 16; ++kk) {
                const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
                const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
                mma_bf16(s[nt], qf[kk], b0, b1);
            }
        }
        float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
                s[nt][e] = score(p, s[nt][e], qpos[e >> 1], kpos);
                mt[e >> 1] = fmaxf(mt[e >> 1], s[nt][e]);
            }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
            mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
            const float m_new = fmaxf(m[r], mt[r]);
            corr[r] = expf(m[r] - m_new);
            m[r] = m_new;
            l[r] *= corr[r];
        }
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x = s[nt][e];
                const float pe = x == NEG_INF ? 0.f : expf(x - m[e >> 1]);
                s[nt][e] = pe;
                l[e >> 1] += pe;
            }
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
            acc[i][0] *= corr[0];
            acc[i][1] *= corr[0];
            acc[i][2] *= corr[1];
            acc[i][3] *= corr[1];
        }
#pragma unroll
        for (int kc = 0; kc < BN / 16; ++kc) {
            const uint32_t pa[4] = {
                pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]),
            };
            const unsigned short* v0 = Vraw + (kc * 16 + 2 * t) * LD + g;
#pragma unroll
            for (int dt = 0; dt < HD / 8; ++dt) {
                const unsigned short* vp = v0 + dt * 8;
                const uint32_t b0 = (uint32_t)vp[0] | ((uint32_t)vp[LD] << 16);
                const uint32_t b1 = (uint32_t)vp[8 * LD] | ((uint32_t)vp[9 * LD] << 16);
                mma_bf16(acc[dt], pa, b0, b1);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = q0 + r0 + 8 * r;
        if (row >= p.Sq) continue;
        const float safe_l = l[r] == 0.f ? 1.f : l[r];
        const float inv = 1.f / safe_l;
        bf16* orow = ob + row * p.o_ss + 2 * t;
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt)
            *reinterpret_cast<uint32_t*>(orow + dt * 8) =
                pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
        if (t == 0) p.lse[((size_t)b * p.Hq + h) * p.Sq + row] = m[r] + logf(safe_l);
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
cudaError_t launch(const Params& p, int dtype, cudaStream_t s) {
    if (dtype == DTYPE_BF16) {
        const size_t smem = 3 * BM * (pad16(HD) + 8) * sizeof(bf16);
        cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16_kernel<HD>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return e;
        const dim3 grid((p.Sq + BM - 1) / BM, p.Hq, p.B);
        flash_fwd_bf16_kernel<HD><<<grid, 128, smem, s>>>(p);
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
    p.softcap = softcap; p.scale = scale;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 64: return launch<64>(p, dtype, s);
        case 80: return launch<80>(p, dtype, s);
        case 88: return launch<88>(p, dtype, s);
        case 128: return launch<128>(p, dtype, s);
        default: return cudaErrorInvalidValue;   // not built for this head dim
    }
}
