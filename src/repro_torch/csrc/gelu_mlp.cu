// Fused GELU-MLP input half forward for Hopper: out = gelu_tanh(x @ w1).
//
// Replaces: repro/kernels/gelu_mlp.py:_gelu_mlp_kernel (via
//   gelu_mlp_fwd_pallas): the product with fp32 accumulation, the tanh
//   approximation of GELU in fp32 with the reference's constants
//   (0.7978845608028654 = sqrt(2/pi), 0.044715), cast to x's dtype.
// Bound on the H100: at the train step's microbatch (N = 8192 tokens,
//   d = 2112, F = 8448) and at prefill the 2*N*d*F operations bound it
//   (compute); at decode (N = 4 slots) the d x F weight, 36 MB in bf16,
//   bounds it (memory).
// Design: the pre-activation never reaches device memory: GELU is applied
//   to the fp32 accumulators in registers and the (N, F) result is stored
//   once.
//   bf16: the persistent, warp-specialised TMA + wgmma GEMM tile of
//   csrc/tma_gemm.cuh with one product (swiglu.cu's has two): a producer
//   warp keeps a ring of shared-memory stages full by TMA (x: TILE_M rows x
//   64 of d; w1: 64 of d x TILE_N columns, read in its (d, F) row-major
//   layout as the MN-major operand) and runs ahead into a block's next tile
//   while consumer warpgroups of 64 rows finish the last.  The epilogue
//   stages bf16 in shared memory (128-byte swizzled boxes, conflict-free)
//   for TMA stores: at the train microbatch it is a quarter of the kernel's
//   time with direct 4-byte stores of each thread's pairs, since the K loop
//   is only 33 stages at d = 2112.  Two regimes, chosen by N in the C entry:
//   - N >= 64 (prefill, train): 128-row tiles (two consumer warpgroups) of
//     128, 192 or 256 columns, whichever takes the fewest waves of tiles
//     over the SMs times its width, the wider on a tie (fewer tiles, less
//     shared-memory traffic per operation): the train microbatch takes 256
//     (2112 tiles, 16 waves of 132 SMs), a 256-token prefill 128 (132
//     tiles, one wave; 66 of 256 would idle half the SMs).  Rings of 6, 4
//     or 4 stages of 32, 40 or 48 KB beside 32 KB of staging; registers
//     move from the producer to the consumers (setmaxnreg), 128
//     accumulators a thread at 256 columns.  Tiles are ordered for the L2:
//     GROUP_M row tiles sweep the same F columns together, so w1 comes from
//     device memory about N / (128 * GROUP_M) times instead of once per row
//     tile.
//   - N < 64 (decode): weight streaming.  A 64-row tile (rows past N arrive
//     as zeros) by 64 F columns, one consumer warpgroup, 12 stages of 8 KB
//     of w1, one block an SM: at F = 8448 the 132 blocks keep 96 KB of w1
//     in flight on each SM, and w1, read once, is the first the L2 evicts
//     (before lines that are dirty or that other kernels reuse).  d is not
//     split, so each output is one block's fp32 sum in a fixed order
//     (repeatable, no atomics).
//   GELU in fp32 with tanhf (accurate; tanh.approx.f32's ~2^-11 absolute
//   error would not fit the bf16 limit where 1 + tanh u cancels, a < 0).
//   Ragged N, d and F edges arrive as zeros (TMA's out-of-bounds fill) and
//   the TMA stores clip them.  d and F must be multiples of 8 (TMA's
//   16-byte strides).
//   fp32: FFMA (no TF32) so that it matches the plain fp32 product closely;
//   64 x 64 tiles, synchronous loads.
#include "common.cuh"
#include "tma_gemm.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 64, BN = 64;   // the fp32 kernel's tile

__device__ __forceinline__ float gelu_tanh(float a) {
    const float u = 0.7978845608028654f * (a + 0.044715f * a * a * a);
    return 0.5f * a * (1.f + tanhf(u));
}

// ---------------------------------------------------------------------------
// bf16: csrc/tma_gemm.cuh's tile, GELU in the epilogue
// ---------------------------------------------------------------------------

constexpr int STREAM_ROWS = 64;   // N below this streams the weight

using tma_gemm::Cfg;
// (rows, columns, products, stages, blocks an SM, staging a warpgroup)
using Cols128 = Cfg<128, 128, 1, 6, 1, 16384>;   // 32 KB a stage
using Cols192 = Cfg<128, 192, 1, 4, 1, 16384>;   // 40 KB a stage
using Cols256 = Cfg<128, 256, 1, 4, 1, 16384>;   // 48 KB a stage
using StreamCfg = Cfg<64, 64, 1, 12, 1, 8192, true>;  // 16 KB a stage, w1 streamed

// Columns of the N >= 64 tile: the fewest waves of tiles over the SMs
// times the width, the wider on a tie.
int gemm_cols(int N, int F, int sms) { return tma_gemm::gemm_cols(N, F, sms, {256, 192, 128}); }

// The epilogue: GELU on the fp32 accumulators, bf16 into the warpgroup's
// staging memory (128-byte swizzled 64 x 64 boxes, two at a time), then TMA
// stores, which clip rows past N and columns past F.
struct GeluStore {
    const CUtensorMap* omap;

    template <int NB, int ACC>
    __device__ __forceinline__ void operator()(float (&acc)[NB][ACC], int m0, int n0, int t,
                                               unsigned char* stage) const {
        constexpr int BOXES = 2 * ACC / 64, AT_ONCE = BOXES < 2 ? BOXES : 2;
        const int lane = t % 32, bar = threadIdx.x / 128;   // named barrier 1 + consumer
        const int row0 = (t / 32) * 16 + lane / 4;           // in the warpgroup's 64 rows
#pragma unroll
        for (int b0 = 0; b0 < BOXES; b0 += AT_ONCE) {
            if (t == 0) hopper::bulk_wait_read();   // the last store has read the staging
            hopper::named_sync(bar, 128);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = row0 + 8 * r;
#pragma unroll
                for (int jj = 0; jj < 8 * AT_ONCE; ++jj) {   // n8 blocks of these boxes
                    const int j = 8 * b0 + jj, i = 4 * j + 2 * r;
                    if (j >= ACC / 4) break;
                    unsigned char* dst = stage + (jj / 8) * 8192 + row * 128
                                         + (((jj % 8) ^ (row % 8)) * 16) + 4 * (lane % 4);
                    *reinterpret_cast<__nv_bfloat162*>(dst) =
                        __floats2bfloat162_rn(gelu_tanh(acc[0][i]), gelu_tanh(acc[0][i + 1]));
                }
            }
            hopper::fence_async_smem();
            hopper::named_sync(bar, 128);
            if (t == 0) {
                for (int b = b0; b < b0 + AT_ONCE && b < BOXES; ++b)
                    hopper::tma_store_2d(omap, stage + (b - b0) * 8192, n0 + 64 * b, m0);
                hopper::bulk_commit();
            }
        }
    }
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
gelu_mlp_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap omap, int N, int d, int F) {
    tma_gemm::run<C>(&xmap, {&wmap}, N, d, F, GeluStore{&omap});
}

template <class C>
cudaError_t launch_bf16(const void* x, const void* w1, void* out, int N, int d, int F,
                        cudaStream_t s) {
    CUtensorMap xm, wm, om;
    cudaError_t e = tma_gemm::make_map(&xm, x, N, d, C::TILE_M);
    if (e == cudaSuccess) e = tma_gemm::make_map(&wm, w1, d, F, tma_gemm::BK);
    if (e == cudaSuccess) e = tma_gemm::make_map(&om, out, N, F, 64);
    if (e != cudaSuccess) return e;
    return tma_gemm::launch<C>(gelu_mlp_bf16_kernel<C>, N, F, s, xm, wm, om, N, d, F);
}

// ---------------------------------------------------------------------------
// fp32: FFMA
// ---------------------------------------------------------------------------

constexpr int FBK = 16;

__global__ void __launch_bounds__(256)
gelu_mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    float* __restrict__ out, int N, int d, int F) {
    __shared__ float xs[FBK][BM + 4];   // x tile, transposed
    __shared__ float ws[FBK][BN];

    const int n0 = blockIdx.y * BM, f0 = blockIdx.x * BN;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    float a[4][4] = {};

    for (int k0 = 0; k0 < d; k0 += FBK) {
        for (int i = tid; i < BM * FBK; i += blockDim.x) {
            const int r = i / FBK, c = i % FBK;
            xs[c][r] = (n0 + r < N && k0 + c < d) ? x[(size_t)(n0 + r) * d + k0 + c] : 0.f;
        }
        for (int i = tid; i < FBK * BN; i += blockDim.x) {
            const int r = i / BN, c = i % BN;
            ws[r][c] = (k0 + r < d && f0 + c < F) ? w1[(size_t)(k0 + r) * F + f0 + c] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < FBK; ++kk) {
            float xv[4], wv[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                xv[t] = xs[kk][ty * 4 + t];
                wv[t] = ws[kk][tx * 4 + t];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) a[i][j] = fmaf(xv[i], wv[j], a[i][j]);
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
            if (f < F) out[(size_t)n * F + f] = gelu_tanh(a[i][j]);
        }
    }
}

}  // namespace

// x: (N, d), w1: (d, F), out: (N, F), all contiguous row-major, with
// 16-byte aligned bases.  For bf16, d and F must be multiples of 8 (TMA's
// 16-byte strides); N < 64 takes the weight-streaming tile.
extern "C" int gelu_mlp_fwd(const void* x, const void* w1, void* out, int N, int d,
                            int F, int dtype, void* stream) {
    if (N < 0 || d <= 0 || F <= 0) return cudaErrorInvalidValue;
    if (N == 0) return cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == DTYPE_BF16) {
        if (d % 8 != 0 || F % 8 != 0) return cudaErrorInvalidValue;
        if (N < STREAM_ROWS) return launch_bf16<StreamCfg>(x, w1, out, N, d, F, s);
        const int sms = hopper::sm_count();
        if (sms <= 0) return cudaErrorInvalidDevice;
        switch (gemm_cols(N, F, sms)) {
            case 256: return launch_bf16<Cols256>(x, w1, out, N, d, F, s);
            case 192: return launch_bf16<Cols192>(x, w1, out, N, d, F, s);
            default: return launch_bf16<Cols128>(x, w1, out, N, d, F, s);
        }
    } else if (dtype == DTYPE_F32) {
        const dim3 grid((F + BN - 1) / BN, (N + BM - 1) / BM);
        gelu_mlp_f32_kernel<<<grid, 256, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(w1),
            static_cast<float*>(out), N, d, F);
    } else {
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

// The bf16 tile (rows << 16 | columns) gelu_mlp_fwd takes for (N, F) on a
// card with `sms` SMs, for the host-side mirror's check
// (kernels/gelu_mlp.py: gelu_mlp_tile).
extern "C" int gelu_mlp_tile(int N, int F, int sms) {
    if (N < STREAM_ROWS) return StreamCfg::TILE_M << 16 | StreamCfg::TILE_N;
    return 128 << 16 | gemm_cols(N, F, sms);
}
