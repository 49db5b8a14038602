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
// Design: csrc/swiglu.cu's tiled GEMM without the gate branch.  A block
//   computes a 64 x 64 tile of x @ w1 from 32-deep slices of x and w1 in
//   shared memory and applies GELU to the fp32 accumulators in registers,
//   so the pre-activation never reaches device memory and the (N, F) result
//   is stored once.  bf16 runs on the tensor cores through nvcuda::wmma
//   (m16n16k16, fp32 accumulate); fp32 runs on FFMA (no TF32) so that it
//   matches the plain fp32 product closely.  Ragged N (prefill, the N = 4
//   of decode), F and d edges are zero-filled on load and masked on store.
//   This is the simple first version: no cp.async/TMA pipelining and no
//   wgmma, and a 64-row tile wastes most of the tensor-core work at decode.
#include "common.cuh"
#include <mma.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int XS_LD = BK + 8;   // bf16 elements; row pitch 80 B
constexpr int WS_LD = BN + 8;   // bf16 elements; row pitch 144 B
constexpr int CS_LD = BN + 4;   // fp32 elements

__device__ __forceinline__ float gelu_tanh(float a) {
    const float u = 0.7978845608028654f * (a + 0.044715f * a * a * a);
    return 0.5f * a * (1.f + tanhf(u));
}

__global__ void __launch_bounds__(128)
gelu_mlp_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                     bf16* __restrict__ out, int N, int d, int F) {
    __shared__ __align__(32) bf16 xs[BM * XS_LD];
    __shared__ __align__(32) bf16 ws[BK * WS_LD];
    __shared__ __align__(32) float cs[BM * CS_LD];

    const int n0 = blockIdx.y * BM, f0 = blockIdx.x * BN;
    const int tid = threadIdx.x, warp = tid >> 5;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;   // 2 x 2 warps

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int k0 = 0; k0 < d; k0 += BK) {
        for (int i = tid; i < BM * BK / 8; i += blockDim.x) {
            const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
            uint4 v = zero;
            if (n0 + r < N && k0 + c < d)
                v = *reinterpret_cast<const uint4*>(x + (size_t)(n0 + r) * d + k0 + c);
            *reinterpret_cast<uint4*>(xs + r * XS_LD + c) = v;
        }
        for (int i = tid; i < BK * BN / 8; i += blockDim.x) {
            const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
            uint4 v = zero;
            if (k0 + r < d && f0 + c < F)
                v = *reinterpret_cast<const uint4*>(w1 + (size_t)(k0 + r) * F + f0 + c);
            *reinterpret_cast<uint4*>(ws + r * WS_LD + c) = v;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(fa[i], xs + (wm + i * 16) * XS_LD + kk, XS_LD);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(fb[j], ws + kk * WS_LD + wn + j * 16, WS_LD);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
    }

    // epilogue in registers, then through shared memory for 16-byte stores
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int t = 0; t < acc[i][j].num_elements; ++t)
                acc[i][j].x[t] = gelu_tanh(acc[i][j].x[t]);
            wmma::store_matrix_sync(cs + (wm + i * 16) * CS_LD + wn + j * 16, acc[i][j],
                                    CS_LD, wmma::mem_row_major);
        }
    __syncthreads();
    for (int i = tid; i < BM * BN / 8; i += blockDim.x) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        if (n0 + r >= N || f0 + c >= F) continue;
        __align__(16) bf16 v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = __float2bfloat16(cs[r * CS_LD + c + t]);
        *reinterpret_cast<uint4*>(out + (size_t)(n0 + r) * F + f0 + c) =
            *reinterpret_cast<const uint4*>(v);
    }
}

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

// x: (N, d), w1: (d, F), out: (N, F), all contiguous row-major.  For bf16,
// d and F must be multiples of 8 (16-byte vector loads and stores).
extern "C" int gelu_mlp_fwd(const void* x, const void* w1, void* out, int N, int d,
                            int F, int dtype, void* stream) {
    if (N < 0 || d <= 0 || F <= 0) return cudaErrorInvalidValue;
    if (N == 0) return cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid((F + BN - 1) / BN, (N + BM - 1) / BM);
    if (dtype == DTYPE_BF16) {
        if (d % 8 != 0 || F % 8 != 0) return cudaErrorInvalidValue;
        gelu_mlp_bf16_kernel<<<grid, 128, 0, s>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
            static_cast<bf16*>(out), N, d, F);
    } else if (dtype == DTYPE_F32) {
        gelu_mlp_f32_kernel<<<grid, 256, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(w1),
            static_cast<float*>(out), N, d, F);
    } else {
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}
