// Fused SwiGLU gate forward for Hopper: out = silu(x @ w1) * (x @ w3).
//
// Replaces: repro/kernels/swiglu.py:_swiglu_kernel (via swiglu_fwd_pallas),
//   both gate products from one x block, fp32 math, cast to x's dtype.
// Bound on the H100: at prefill and in training (N = 256 .. 8192 tokens,
//   d = 4096, F = 11008) the 4*N*d*F operations bound it (compute); at
//   decode (N = 4 slots) the two d x F weight matrices, 180 MB in bf16,
//   bound it (memory).
// Design: neither product reaches device memory: each block computes a
//   tile of BOTH products over the same F columns from one shared-memory
//   copy of the x tile, applies silu(a) * b to the fp32 accumulators in
//   registers and stores the bf16 result directly, once.
//   bf16: the persistent, warp-specialised TMA + wgmma GEMM tile of
//   csrc/tma_gemm.cuh with two products: a producer warp keeps a ring of
//   shared-memory stages full by TMA (the x tile, TILE_M rows x 64 of d, and
//   the w1 and w3 tiles, 64 of d x TILE_N columns, read in the weights' (d,
//   F) row-major layout as the MN-major operand) and runs ahead into a
//   block's next tile while consumer warpgroups of 64 rows finish the last.
//   Two regimes, chosen by N in the C entry:
//   - N >= 64 (prefill, train): 128-row tiles of 128 columns of both
//     products (two consumer warpgroups, 128 accumulators a thread) in a
//     4-stage ring of 48 KB, or of 192 columns (192 accumulators) in a
//     3-stage ring of 64 KB where 128 would leave most of a last wave of
//     the SMs idle (yi-6b's 256-token prefill: 172 tiles of 128 columns on
//     132 SMs, 116 of 192); registers move from the producer to the
//     consumers (setmaxnreg).  Tiles are ordered for the L2: GROUP_M row
//     tiles sweep the same F columns together, so w1 and w3 come from
//     device memory about N / (128 * GROUP_M) times instead of once per
//     row tile.
//   - N < 64 (decode): weight streaming.  A 64-row tile (rows past N arrive
//     as zeros) by 64 F columns, one consumer warpgroup, 4 stages of 16 KB of
//     weights, two blocks an SM: 172 blocks at F = 11008 keep ~64 KB of
//     weights in flight on each SM.  d is not split, so each output is one
//     block's fp32 sum in a fixed order (repeatable, no atomics).
//   Ragged N, d and F edges arrive as zeros (TMA's out-of-bounds fill) and
//   are masked on store.  d and F must be multiples of 8 (TMA's 16-byte
//   strides).
//   fp32: FFMA (no TF32) so that it matches the plain fp32 product closely;
//   64 x 64 tiles, synchronous loads.
#include "common.cuh"
#include "tma_gemm.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 64, BN = 64;   // the fp32 kernel's tile

__device__ __forceinline__ float silu(float a) { return a / (1.f + expf(-a)); }

// ---------------------------------------------------------------------------
// bf16: csrc/tma_gemm.cuh's tile, silu(a) * g in the epilogue
// ---------------------------------------------------------------------------

constexpr int STREAM_ROWS = 64;   // N below this streams the weights

using tma_gemm::Cfg;
// (rows, columns, products, stages, blocks an SM)
using GemmCfg = Cfg<128, 128, 2, 4, 1>;     // 48 KB a stage
using WideCfg = Cfg<128, 192, 2, 3, 1>;     // 64 KB a stage
using StreamCfg = Cfg<64, 64, 2, 4, 2>;     // 24 KB a stage

// Columns of the N >= 64 tile: the fewest waves of tiles over the SMs
// times the width, 128 on a tie.
int gemm_cols(int N, int F, int sms) { return tma_gemm::gemm_cols(N, F, sms, {128, 192}); }

// The epilogue: silu(a) * g on the fp32 accumulators of the two products,
// stored as bf16 pairs, rows past N and columns past F masked.
struct SiluMulStore {
    bf16* out;
    int N, F;

    template <int NB, int ACC>
    __device__ __forceinline__ void operator()(float (&acc)[NB][ACC], int m0, int n0, int t,
                                               unsigned char*) const {
        const int lane = t % 32;
        const int row0 = m0 + (t / 32) * 16 + lane / 4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = row0 + 8 * r;
            if (row >= N) continue;
            bf16* orow = out + (size_t)row * F;
#pragma unroll
            for (int j = 0; j < ACC / 4; ++j) {
                const int col = n0 + 8 * j + 2 * (lane % 4);
                if (col >= F) continue;                  // F is even: col + 1 < F
                const int i = 4 * j + 2 * r;
                *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
                    silu(acc[0][i]) * acc[1][i], silu(acc[0][i + 1]) * acc[1][i + 1]);
            }
        }
    }
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
swiglu_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap w1map,
                   const __grid_constant__ CUtensorMap w3map, bf16* __restrict__ out,
                   int N, int d, int F) {
    tma_gemm::run<C>(&xmap, {&w1map, &w3map}, N, d, F, SiluMulStore{out, N, F});
}

template <class C>
cudaError_t launch_bf16(const void* x, const void* w1, const void* w3, void* out,
                        int N, int d, int F, cudaStream_t s) {
    CUtensorMap xm, w1m, w3m;
    cudaError_t e = tma_gemm::make_map(&xm, x, N, d, C::TILE_M);
    if (e == cudaSuccess) e = tma_gemm::make_map(&w1m, w1, d, F, tma_gemm::BK);
    if (e == cudaSuccess) e = tma_gemm::make_map(&w3m, w3, d, F, tma_gemm::BK);
    if (e != cudaSuccess) return e;
    return tma_gemm::launch<C>(swiglu_bf16_kernel<C>, N, F, s, xm, w1m, w3m,
                               static_cast<bf16*>(out), N, d, F);
}

// ---------------------------------------------------------------------------
// fp32: FFMA
// ---------------------------------------------------------------------------

constexpr int FBK = 16;

__global__ void __launch_bounds__(256)
swiglu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ w3, float* __restrict__ out,
                  int N, int d, int F) {
    __shared__ float xs[FBK][BM + 4];   // x tile, transposed
    __shared__ float w1s[FBK][BN];
    __shared__ float w3s[FBK][BN];

    const int n0 = blockIdx.y * BM, f0 = blockIdx.x * BN;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    float a[4][4] = {}, b[4][4] = {};

    for (int k0 = 0; k0 < d; k0 += FBK) {
        for (int i = tid; i < BM * FBK; i += blockDim.x) {
            const int r = i / FBK, c = i % FBK;
            xs[c][r] = (n0 + r < N && k0 + c < d) ? x[(size_t)(n0 + r) * d + k0 + c] : 0.f;
        }
        for (int i = tid; i < FBK * BN; i += blockDim.x) {
            const int r = i / BN, c = i % BN;
            const bool ok = k0 + r < d && f0 + c < F;
            const size_t off = (size_t)(k0 + r) * F + f0 + c;
            w1s[r][c] = ok ? w1[off] : 0.f;
            w3s[r][c] = ok ? w3[off] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < FBK; ++kk) {
            float xv[4], v1[4], v3[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                xv[t] = xs[kk][ty * 4 + t];
                v1[t] = w1s[kk][tx * 4 + t];
                v3[t] = w3s[kk][tx * 4 + t];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    a[i][j] = fmaf(xv[i], v1[j], a[i][j]);
                    b[i][j] = fmaf(xv[i], v3[j], b[i][j]);
                }
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int n = n0 + ty * 4 + i;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int f = f0 + tx * 4 + j;
            if (f < F) out[(size_t)n * F + f] = silu(a[i][j]) * b[i][j];
        }
    }
}

}  // namespace

// x: (N, d), w1/w3: (d, F), out: (N, F), all contiguous row-major, with
// 16-byte aligned bases.  For bf16, d and F must be multiples of 8 (TMA's
// 16-byte strides); N < 64 takes the weight-streaming tile.
extern "C" int swiglu_fwd(const void* x, const void* w1, const void* w3, void* out,
                          int N, int d, int F, int dtype, void* stream) {
    if (N < 0 || d <= 0 || F <= 0) return cudaErrorInvalidValue;
    if (N == 0) return cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == DTYPE_BF16) {
        if (d % 8 != 0 || F % 8 != 0) return cudaErrorInvalidValue;
        if (N < STREAM_ROWS) return launch_bf16<StreamCfg>(x, w1, w3, out, N, d, F, s);
        const int sms = hopper::sm_count();
        if (sms <= 0) return cudaErrorInvalidDevice;
        return gemm_cols(N, F, sms) == 192 ? launch_bf16<WideCfg>(x, w1, w3, out, N, d, F, s)
                                           : launch_bf16<GemmCfg>(x, w1, w3, out, N, d, F, s);
    } else if (dtype == DTYPE_F32) {
        const dim3 grid((F + BN - 1) / BN, (N + BM - 1) / BM);
        swiglu_f32_kernel<<<grid, 256, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(w1),
            static_cast<const float*>(w3), static_cast<float*>(out), N, d, F);
    } else {
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

// The bf16 tile (rows << 16 | columns) swiglu_fwd takes for (N, F) on a
// card with `sms` SMs, for the host-side mirror's check
// (kernels/swiglu.py: swiglu_tile).
extern "C" int swiglu_tile(int N, int F, int sms) {
    if (N < STREAM_ROWS) return StreamCfg::TILE_M << 16 | StreamCfg::TILE_N;
    return 128 << 16 | gemm_cols(N, F, sms);
}
