// Blocked cross-entropy forward for Hopper: per token row of h @ W, the fp32
// log-sum-exp over the vocab columns below valid_vocab and the label's
// logit, without writing the (N, V) logits to memory.
//
// Replaces: repro/kernels/cross_entropy.py:_ce_kernel (via
//   ce_logsumexp_pallas): a running (max, sumexp, label-logit) per row over
//   vocab blocks of h @ W, columns >= valid_vocab masked; returns
//   (lse, label_logit), loss = lse - label_logit.
// Bound on the H100: operations.  At N = 8188 tokens, d = 4096, V = 64000
//   the product is 2 N d V = 4.3 TFLOP against 0.6 GB of h and W.
// Design: the TPU kernel loops over all vocab blocks inside one token block
//   (a sequential grid axis), which here would give 128 blocks of 64 rows,
//   each streaming all 524 MB of W.  Instead the grid is (token block of 64
//   rows, vocab chunk of 2048 columns): 128 x 32 blocks fill the 132 SMs,
//   and blocks of one chunk run together and share W's tiles through L2.
//   Each block keeps a running (max, sumexp) per row in registers over the
//   16 tiles of 128 columns of its chunk and writes one partial pair per
//   (row, chunk); a second, small kernel merges the 32 partials of a row
//   into its lse.  The label logit is written by the one thread whose
//   column is the label.  Rows past N (N = B (S - 1) is rarely a multiple
//   of 64) are zero-filled and never written; columns past V or at or past
//   valid_vocab are excluded.
//   bf16: 4 warps of 16 rows each, h @ W as mma.sync.m16n8k16 (bf16 in,
//   fp32 accumulate) over 32-deep tiles of h and W in shared memory.
//   fp32: FFMA only (no TF32), a lane per column of 32-column tiles.
//   Simple first version: no cp.async/TMA double buffering, no wgmma.
#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int VOCAB_CHUNK = 2048;   // must match kernels/cross_entropy.py

struct Params {
    const void* h;            // (N, d)
    const void* w;            // (d, V)
    const long long* labels;  // (N,)
    float* label_logit;       // (N,), preset to -1e30
    float* partial;           // (n_chunks, N, 2): running (max, sumexp)
    int N, d, V, valid;
};

// Running (m, s) of one row after a tile whose logits (this thread's part)
// were folded into the tile max `mt` (already reduced over the row's lanes).
__device__ __forceinline__ float rescale(float& m, float& s, float mt) {
    const float m_new = fmaxf(m, mt);
    s *= expf(m - m_new);
    m = m_new;
    return m_new;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int BM = 64, BV = 128, BK = 32;
constexpr int LDH = BK + 8, LDW = BV + 8;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(128) ce_partial_bf16_kernel(const Params p) {
    __shared__ __align__(16) bf16 Hs[BM * LDH];
    __shared__ __align__(16) bf16 Ws[BK * LDW];
    const unsigned short* Wraw = reinterpret_cast<const unsigned short*>(Ws);

    const int n0 = blockIdx.x * BM, chunk = blockIdx.y;
    const int c0 = chunk * VOCAB_CHUNK, c1 = min(c0 + VOCAB_CHUNK, p.V);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16 + g;         // this thread's rows: r0 and r0 + 8
    const bf16* hb = static_cast<const bf16*>(p.h);
    const bf16* wb = static_cast<const bf16*>(p.w);

    int row[2];
    long long label[2];
    float m[2] = {NEG_INF, NEG_INF}, s[2] = {0.f, 0.f};   // s: this thread's part
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        row[r] = n0 + r0 + 8 * r;
        label[r] = row[r] < p.N ? p.labels[row[r]] : -1;
    }

    for (int v0 = c0; v0 < c1; v0 += BV) {
        float acc[BV / 8][4];
#pragma unroll
        for (int nt = 0; nt < BV / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
        for (int k0 = 0; k0 < p.d; k0 += BK) {
            __syncthreads();
            for (int i = threadIdx.x; i < BM * (BK / 8); i += blockDim.x) {
                const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
                uint4 val = make_uint4(0, 0, 0, 0);
                if (n0 + r < p.N)
                    val = *reinterpret_cast<const uint4*>(hb + (size_t)(n0 + r) * p.d + k0 + c);
                *reinterpret_cast<uint4*>(Hs + r * LDH + c) = val;
            }
            for (int i = threadIdx.x; i < BK * (BV / 8); i += blockDim.x) {
                const int r = i / (BV / 8), c = (i % (BV / 8)) * 8;
                uint4 val = make_uint4(0, 0, 0, 0);
                if (v0 + c < p.V)
                    val = *reinterpret_cast<const uint4*>(wb + (size_t)(k0 + r) * p.V + v0 + c);
                *reinterpret_cast<uint4*>(Ws + r * LDW + c) = val;
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                const int c = kk * 16 + 2 * t;
                const uint32_t a[4] = {
                    *reinterpret_cast<const uint32_t*>(Hs + r0 * LDH + c),
                    *reinterpret_cast<const uint32_t*>(Hs + (r0 + 8) * LDH + c),
                    *reinterpret_cast<const uint32_t*>(Hs + r0 * LDH + c + 8),
                    *reinterpret_cast<const uint32_t*>(Hs + (r0 + 8) * LDH + c + 8),
                };
                const unsigned short* wr = Wraw + (kk * 16 + 2 * t) * LDW + g;
#pragma unroll
                for (int nt = 0; nt < BV / 8; ++nt) {
                    const unsigned short* vp = wr + nt * 8;
                    const uint32_t b0 = (uint32_t)vp[0] | ((uint32_t)vp[LDW] << 16);
                    const uint32_t b1 = (uint32_t)vp[8 * LDW] | ((uint32_t)vp[9 * LDW] << 16);
                    mma_bf16(acc[nt], a, b0, b1);
                }
            }
        }
        // mask, pick the labels, fold the tile into the running (m, s)
        float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int nt = 0; nt < BV / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1, col = v0 + nt * 8 + 2 * t + (e & 1);
                const bool ok = col < p.valid;
                if (col == label[r]) p.label_logit[row[r]] = ok ? acc[nt][e] : NEG_INF;
                acc[nt][e] = ok ? acc[nt][e] : NEG_INF;
                mt[r] = fmaxf(mt[r], acc[nt][e]);
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
            mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
            rescale(m[r], s[r], mt[r]);
        }
#pragma unroll
        for (int nt = 0; nt < BV / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x = acc[nt][e];
                s[e >> 1] += x == NEG_INF ? 0.f : expf(x - m[e >> 1]);
            }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], 1);
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], 2);
        if (t == 0 && row[r] < p.N) {
            float* out = p.partial + ((size_t)chunk * p.N + row[r]) * 2;
            out[0] = m[r];
            out[1] = s[r];
        }
    }
}

// ---------------------------------------------------------------------------
// fp32: FFMA, a lane per column
// ---------------------------------------------------------------------------

constexpr int FBM = 32, FBV = 32, FBK = 32, ROWS_PER_WARP = 8;

__global__ void __launch_bounds__(128) ce_partial_f32_kernel(const Params p) {
    __shared__ float Hs[FBM][FBK + 1];
    __shared__ float Ws[FBK][FBV + 1];
    const int n0 = blockIdx.x * FBM, chunk = blockIdx.y;
    const int c0 = chunk * VOCAB_CHUNK, c1 = min(c0 + VOCAB_CHUNK, p.V);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* hb = static_cast<const float*>(p.h);
    const float* wb = static_cast<const float*>(p.w);

    float m[ROWS_PER_WARP], s[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
        m[r] = NEG_INF;
        s[r] = 0.f;
    }
    for (int v0 = c0; v0 < c1; v0 += FBV) {
        float acc[ROWS_PER_WARP] = {};
        for (int k0 = 0; k0 < p.d; k0 += FBK) {
            __syncthreads();
            for (int i = threadIdx.x; i < FBM * FBK; i += blockDim.x) {
                const int r = i / FBK, c = i % FBK;
                Hs[r][c] = n0 + r < p.N && k0 + c < p.d ? hb[(size_t)(n0 + r) * p.d + k0 + c] : 0.f;
                Ws[r][c] = k0 + r < p.d && v0 + c < p.V ? wb[(size_t)(k0 + r) * p.V + v0 + c] : 0.f;
            }
            __syncthreads();
#pragma unroll 8
            for (int c = 0; c < FBK; ++c) {
                const float wv = Ws[c][lane];
#pragma unroll
                for (int r = 0; r < ROWS_PER_WARP; ++r)
                    acc[r] = fmaf(Hs[warp * ROWS_PER_WARP + r][c], wv, acc[r]);
            }
        }
        const int col = v0 + lane;
        const bool ok = col < p.valid;
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
            const int row = n0 + warp * ROWS_PER_WARP + r;
            if (row < p.N && col == p.labels[row]) p.label_logit[row] = ok ? acc[r] : NEG_INF;
            const float x = ok ? acc[r] : NEG_INF;
            const float m_new = rescale(m[r], s[r], warp_max(x));
            s[r] += warp_sum(x == NEG_INF ? 0.f : expf(x - m_new));
        }
    }
    if (lane == 0) {
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
            const int row = n0 + warp * ROWS_PER_WARP + r;
            if (row >= p.N) continue;
            float* out = p.partial + ((size_t)chunk * p.N + row) * 2;
            out[0] = m[r];
            out[1] = s[r];
        }
    }
}

// lse of each row from its n_chunks partial (max, sumexp) pairs, folded in
// one pass as a running (max, sumexp); a chunk with no valid column has
// sumexp 0 and is skipped.
__global__ void ce_merge_kernel(const float* partial, float* lse, int N, int n_chunks) {
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= N) return;
    float m = NEG_INF, s = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
        const float mc = partial[((size_t)c * N + row) * 2];
        const float sc = partial[((size_t)c * N + row) * 2 + 1];
        if (sc > 0.f) {
            const float m_new = fmaxf(m, mc);
            s = s * expf(m - m_new) + sc * expf(mc - m_new);
            m = m_new;
        }
    }
    lse[row] = s > 0.f ? m + logf(s) : NEG_INF;
}

}  // namespace

// h: (N, d), w: (d, V) row-major contiguous in one dtype, labels: (N,)
// int64; lse, label_logit: (N,) fp32, label_logit preset to -1e30 by the
// caller; partial: scratch of (ceil(V / 2048), N, 2) fp32.  bf16 needs
// d % 32 == 0, V % 8 == 0 and 16-byte aligned h and w.
extern "C" int cross_entropy_fwd(const void* h, const void* w, const void* labels,
                                 void* lse, void* label_logit, void* partial, int N,
                                 int d, int V, int valid_vocab, int dtype, void* stream) {
    if ((dtype != DTYPE_BF16 && dtype != DTYPE_F32) || N < 0 || d <= 0 || V <= 0
        || valid_vocab <= 0 || valid_vocab > V
        || (dtype == DTYPE_BF16 && (d % BK != 0 || V % 8 != 0)))
        return cudaErrorInvalidValue;
    if (N == 0) return cudaSuccess;
    Params p;
    p.h = h; p.w = w; p.labels = static_cast<const long long*>(labels);
    p.label_logit = static_cast<float*>(label_logit);
    p.partial = static_cast<float*>(partial);
    p.N = N; p.d = d; p.V = V; p.valid = valid_vocab;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_chunks = (V + VOCAB_CHUNK - 1) / VOCAB_CHUNK;
    if (dtype == DTYPE_BF16)
        ce_partial_bf16_kernel<<<dim3((N + BM - 1) / BM, n_chunks), 128, 0, s>>>(p);
    else
        ce_partial_f32_kernel<<<dim3((N + FBM - 1) / FBM, n_chunks), 128, 0, s>>>(p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    ce_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(p.partial, static_cast<float*>(lse), N,
                                                    n_chunks);
    return cudaGetLastError();
}
