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
//   (a sequential grid axis); here blocks run in parallel, so each block
//   computes one tile of logits and reduces it to a (max, sumexp) partial
//   per row, and a second, small kernel merges a row's partials into its
//   lse, skipping those with sumexp 0 (no valid column).  The label logit is
//   written by the one thread whose column is the label (-1e30 if the label
//   is masked).  Rows past N (N = B (S - 1) is rarely a multiple of the
//   tile) and columns past V arrive as zeros and are never written or
//   summed; columns at or past valid_vocab are excluded.
//   bf16: the persistent, warp-specialised TMA + wgmma GEMM tile of
//   csrc/tma_gemm.cuh (h the K-major operand, W the MN-major one, read in
//   its (d, V) row-major layout) of 128 token rows x 256 vocab columns, in
//   two consumer warpgroups, over 64-deep stages of d in a 4-stage ring of
//   48 KB; the epilogue, in registers, masks (only the tiles that reach
//   valid_vocab), finds the label with one test a row, takes each row's
//   max over the tile (a thread's 64 columns, then the quad of lanes that
//   holds the row) and its sumexp against that max (ex2.approx with a
//   log2(e) prescale), and writes one (max, sumexp) pair per (row, column
//   tile): ceil(V / 256) partials a row.  Tiles are ordered for the L2:
//   GROUP_M row tiles sweep the vocab together, so at yi-6b's shapes W (524
//   MB, 10x the L2) is read from device memory about N / (128 * GROUP_M) =
//   4 times, and each group's 16 MB of h stays in the L2 while it does.  d
//   and V must be multiples of 8 (TMA's 16-byte strides).
//   fp32: FFMA only (no TF32), a lane per column of 32-column tiles, blocks
//   of 32 rows by a chunk of 2048 columns, a running (max, sumexp) per row
//   over the chunk: one partial per (row, chunk).
#include "common.cuh"
#include "tma_gemm.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int VOCAB_CHUNK = 2048;   // the fp32 kernel's columns a block;
                                    // must match kernels/cross_entropy.py

struct Params {
    const void* h;            // (N, d)
    const void* w;            // (d, V)
    const long long* labels;  // (N,)
    float* label_logit;       // (N,), preset to -1e30
    float* partial;           // (partials, N, 2): (max, sumexp) per row
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
// bf16: csrc/tma_gemm.cuh's tile, the row reduction in the epilogue
// ---------------------------------------------------------------------------

using CeCfg = tma_gemm::Cfg<128, 256, 1, 4, 1>;   // 48 KB a stage
constexpr float LOG2E = 1.4426950408889634f;

// Row r's (max, sumexp) over this thread's columns col0 + 8j + e of the
// tile, then over the quad of lanes that holds the row; MASKED excludes
// columns at or past `valid` (the tile's last columns may be).
template <bool MASKED, int ACC>
__device__ __forceinline__ float2 row_partial(const float (&a)[ACC], int r, int col0, int valid) {
    float m = NEG_INF;
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
            if (!MASKED || col0 + 8 * j + e < valid) m = fmaxf(m, a[4 * j + 2 * r + e]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float off = -m * LOG2E;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
            if (!MASKED || col0 + 8 * j + e < valid)
                s += hopper::ex2(fmaf(a[4 * j + 2 * r + e], LOG2E, off));
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    return make_float2(m, s);
}

// The epilogue: each row's label logit, if the label falls in this tile,
// and its (max, sumexp) partial for the tile.
struct PartialEpilogue {
    const long long* labels;
    float* label_logit;
    float* partial;
    int N, valid;

    template <int NB, int ACC>
    __device__ __forceinline__ void operator()(float (&acc)[NB][ACC], int m0, int n0, int t,
                                               unsigned char*) const {
        constexpr int TILE_N = 2 * ACC;
        const int lane = t % 32, q = lane % 4;
        const int col0 = n0 + 2 * q;                  // this thread's first column
        const int row0 = m0 + (t / 32) * 16 + lane / 4;
        int label[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
            label[r] = row0 + 8 * r < N ? static_cast<int>(labels[row0 + 8 * r]) : -1;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = row0 + 8 * r;
            // the label is column col0 + 8j + e of this thread for e = d % 8 < 2
            const int d = label[r] - col0;
            if (static_cast<unsigned>(d) < TILE_N && (d & 6) == 0) {
#pragma unroll
                for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        if (8 * j + e == d)
                            label_logit[row] = label[r] < valid ? acc[0][4 * j + 2 * r + e]
                                                                : NEG_INF;
            }
            const float2 ms = n0 + TILE_N <= valid
                                  ? row_partial<false>(acc[0], r, col0, valid)
                                  : row_partial<true>(acc[0], r, col0, valid);
            if (q == 0 && row < N)
                *reinterpret_cast<float2*>(partial + ((size_t)(n0 / TILE_N) * N + row) * 2) = ms;
        }
    }
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
ce_partial_bf16_kernel(const __grid_constant__ CUtensorMap hmap,
                       const __grid_constant__ CUtensorMap wmap, const Params p) {
    tma_gemm::run<C>(&hmap, {&wmap}, p.N, p.d, p.V,
                     PartialEpilogue{p.labels, p.label_logit, p.partial, p.N, p.valid});
}

cudaError_t launch_bf16(const Params& p, cudaStream_t s) {
    CUtensorMap hm, wm;
    cudaError_t e = tma_gemm::make_map(&hm, p.h, p.N, p.d, CeCfg::TILE_M);
    if (e == cudaSuccess) e = tma_gemm::make_map(&wm, p.w, p.d, p.V, tma_gemm::BK);
    if (e != cudaSuccess) return e;
    return tma_gemm::launch<CeCfg>(ce_partial_bf16_kernel<CeCfg>, p.N, p.V, s, hm, wm, p);
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

// (max, sumexp) partials a row: one per 256-column tile (bf16) or
// 2048-column chunk (fp32), for the caller's scratch and the host-side
// mirror's check (kernels/cross_entropy.py: n_partials).
extern "C" int cross_entropy_partials(int V, int dtype) {
    return tma_gemm::cdiv(V, dtype == DTYPE_BF16 ? CeCfg::TILE_N : VOCAB_CHUNK);
}

// The bf16 tile (rows << 16 | columns), one size at every shape, for the
// mirror's check (kernels/cross_entropy.py: TILE_M, TILE_N).
extern "C" int cross_entropy_tile() { return CeCfg::TILE_M << 16 | CeCfg::TILE_N; }

// h: (N, d), w: (d, V) row-major contiguous in one dtype, labels: (N,)
// int64; lse, label_logit: (N,) fp32, label_logit preset to -1e30 by the
// caller; partial: scratch of (cross_entropy_partials(V, dtype), N, 2)
// fp32.  bf16 needs d % 8 == 0, V % 8 == 0 and 16-byte aligned h and w.
extern "C" int cross_entropy_fwd(const void* h, const void* w, const void* labels,
                                 void* lse, void* label_logit, void* partial, int N,
                                 int d, int V, int valid_vocab, int dtype, void* stream) {
    if ((dtype != DTYPE_BF16 && dtype != DTYPE_F32) || N < 0 || d <= 0 || V <= 0
        || valid_vocab <= 0 || valid_vocab > V
        || (dtype == DTYPE_BF16 && (d % 8 != 0 || V % 8 != 0)))
        return cudaErrorInvalidValue;
    if (N == 0) return cudaSuccess;
    Params p;
    p.h = h; p.w = w; p.labels = static_cast<const long long*>(labels);
    p.label_logit = static_cast<float*>(label_logit);
    p.partial = static_cast<float*>(partial);
    p.N = N; p.d = d; p.V = V; p.valid = valid_vocab;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_partials = cross_entropy_partials(V, dtype);
    cudaError_t e;
    if (dtype == DTYPE_BF16) {
        e = launch_bf16(p, s);
    } else {
        ce_partial_f32_kernel<<<dim3((N + FBM - 1) / FBM, n_partials), 128, 0, s>>>(p);
        e = cudaGetLastError();
    }
    if (e != cudaSuccess) return e;
    ce_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(p.partial, static_cast<float*>(lse), N,
                                                    n_partials);
    return cudaGetLastError();
}
