// Fused SwiGLU gate forward for Hopper: out = silu(x @ w1) * (x @ w3).
//
// Replaces: repro/kernels/swiglu.py:_swiglu_kernel (via swiglu_fwd_pallas),
//   both gate products from one x block, fp32 math, cast to x's dtype.
// Bound on the H100: at prefill (N = 512 tokens, d = 4096, F = 11008) the
//   4*N*d*F operations bound it (compute); at decode (N = 4 slots) the two
//   d x F weight matrices, 180 MB in bf16, bound it (memory).
// Design: a tiled GEMM that computes a 64 x 64 tile of BOTH products per
//   block from one shared-memory copy of the x tile, and applies the
//   silu(a) * b epilogue to the fp32 accumulators in registers, so neither
//   product reaches device memory and the (N, F) result is stored once.
//   bf16 runs on the tensor cores through nvcuda::wmma (m16n16k16, fp32
//   accumulate); fp32 runs on FFMA (no TF32) so that it matches the plain
//   fp32 product closely.  Ragged N, F and d edges are zero-filled on load
//   and masked on store.  This is the simple first version: no cp.async/TMA
//   pipelining and no wgmma, and a 64-row tile wastes most of the tensor-core
//   work at decode's N = 4.
#include "common.cuh"
#include <mma.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int XS_LD = BK + 8;   // bf16 elements; row pitch 80 B
constexpr int WS_LD = BN + 8;   // bf16 elements; row pitch 144 B
constexpr int CS_LD = BN + 4;   // fp32 elements

__device__ __forceinline__ float silu(float a) { return a / (1.f + expf(-a)); }

__global__ void __launch_bounds__(128)
swiglu_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                   const bf16* __restrict__ w3, bf16* __restrict__ out,
                   int N, int d, int F) {
    __shared__ __align__(32) bf16 xs[BM * XS_LD];
    __shared__ __align__(32) bf16 w1s[BK * WS_LD];
    __shared__ __align__(32) bf16 w3s[BK * WS_LD];
    __shared__ __align__(32) float cs[BM * CS_LD];

    const int n0 = blockIdx.y * BM, f0 = blockIdx.x * BN;
    const int tid = threadIdx.x, warp = tid >> 5;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;   // 2 x 2 warps

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc1[2][2], acc3[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            wmma::fill_fragment(acc1[i][j], 0.f);
            wmma::fill_fragment(acc3[i][j], 0.f);
        }

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
            uint4 a = zero, b = zero;
            if (k0 + r < d && f0 + c < F) {
                const size_t off = (size_t)(k0 + r) * F + f0 + c;
                a = *reinterpret_cast<const uint4*>(w1 + off);
                b = *reinterpret_cast<const uint4*>(w3 + off);
            }
            *reinterpret_cast<uint4*>(w1s + r * WS_LD + c) = a;
            *reinterpret_cast<uint4*>(w3s + r * WS_LD + c) = b;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb1[2], fb3[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(fa[i], xs + (wm + i * 16) * XS_LD + kk, XS_LD);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                wmma::load_matrix_sync(fb1[j], w1s + kk * WS_LD + wn + j * 16, WS_LD);
                wmma::load_matrix_sync(fb3[j], w3s + kk * WS_LD + wn + j * 16, WS_LD);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    wmma::mma_sync(acc1[i][j], fa[i], fb1[j], acc1[i][j]);
                    wmma::mma_sync(acc3[i][j], fa[i], fb3[j], acc3[i][j]);
                }
        }
        __syncthreads();
    }

    // epilogue in registers: fragments of one type share their element map
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int t = 0; t < acc1[i][j].num_elements; ++t)
                acc1[i][j].x[t] = silu(acc1[i][j].x[t]) * acc3[i][j].x[t];
            wmma::store_matrix_sync(cs + (wm + i * 16) * CS_LD + wn + j * 16,
                                    acc1[i][j], CS_LD, wmma::mem_row_major);
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

// x: (N, d), w1/w3: (d, F), out: (N, F), all contiguous row-major.  For bf16,
// d and F must be multiples of 8 (16-byte vector loads and stores).
extern "C" int swiglu_fwd(const void* x, const void* w1, const void* w3, void* out,
                          int N, int d, int F, int dtype, void* stream) {
    if (N < 0 || d <= 0 || F <= 0) return cudaErrorInvalidValue;
    if (N == 0) return cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid((F + BN - 1) / BN, (N + BM - 1) / BM);
    if (dtype == DTYPE_BF16) {
        if (d % 8 != 0 || F % 8 != 0) return cudaErrorInvalidValue;
        swiglu_bf16_kernel<<<grid, 128, 0, s>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
            static_cast<const bf16*>(w3), static_cast<bf16*>(out), N, d, F);
    } else if (dtype == DTYPE_F32) {
        swiglu_f32_kernel<<<grid, 256, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(w1),
            static_cast<const float*>(w3), static_cast<float*>(out), N, d, F);
    } else {
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}
