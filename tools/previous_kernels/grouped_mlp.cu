// Grouped expert MLP forward for Hopper: for every expert e,
//   out_e = mask_e * (act(mask_e * x_e) @ w2_e),
//   act(x) = silu(x @ w1_e) * (x @ w3_e)   (swiglu)  or  gelu_tanh(x @ w1_e)   (gelu),
// over the expert-major slot layout x (E, N, d), w1/w3 (E, d, F), w2 (E, F, d),
// mask (E, N) in {0, 1}: masked slots go in as zero rows and come out as zeros.
//
// Replaces: repro/kernels/grouped_mlp.py:_swiglu_kernel and _gelu_kernel (via
//   _fwd_pallas): both bodies, fp32 math inside, the silu gate or the tanh
//   GELU with the reference's constants (0.7978845608028654 = sqrt(2/pi),
//   0.044715, as csrc/gelu_mlp.cu), cast to x's dtype.
// Bound on the H100: serving routes a few tokens to each of 128 experts, so
//   N is 1-5 slots at prefill and 4 at decode and the experts' weights bound
//   it (bytes); only the experts that hold a valid slot need to be read,
//   which at decode is 4 (top-1) or 8 (top-2) of 128.
// Design: two kernels from one entry.  The TPU body keeps an expert's whole
//   (d, F) weights and the (rows, F) activation h in VMEM; on the H100 h of a
//   64-row tile at F 8192 is 2 MB in fp32, far beyond shared memory, so h
//   goes through an fp32 (E, N, F) scratch in device memory:
//   - the gate kernel, grid (F tiles, N tiles, E): csrc/swiglu.cu's and
//     csrc/gelu_mlp.cu's 64 x 64 wmma tile (bf16 in, fp32 accumulate) at an
//     expert's offset, the x rows scaled by their mask on load, the
//     activation on the fp32 accumulators, h stored in fp32;
//   - the down kernel, grid (d tiles, N tiles, E): h @ w2 on wmma in TF32
//     (m16n16k8, fp32 accumulate), times the mask, stored in x's dtype.  h
//     stays fp32 as in the TPU body and is rounded only to TF32 (2^-11 of
//     each value) where bf16 would round it to 2^-8; the bf16 weights are
//     exact in TF32.  TF32 runs at half bf16's rate, which costs nothing
//     here: the weight bytes bound the kernel at the path's N.
//   A block whose 64 slots are all masked returns at once (the down kernel
//   writes its zeros first), so an expert with no valid slot is never read:
//   that keeps decode near the bytes of the 4 or 8 experts it needs.
//   fp32 runs both products on FFMA (no TF32) in one 64 x 64 tile template.
//   This is the simple first version: no cp.async/TMA pipelining, no wgmma,
//   no persistent grouped schedule, and a 64-row tile does 13-64x the
//   tensor-core work that N <= 5 valid rows need.
#include "common.cuh"
#include <mma.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

enum { ACT_SWIGLU = 0, ACT_GELU = 1, DOWN = 2 };

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int XS_LD = BK + 8;   // bf16 elements; row pitch 80 B
constexpr int WS_LD = BN + 8;   // bf16 elements; row pitch 144 B
constexpr int HS_LD = BK + 4;   // fp32 elements; row pitch 144 B
constexpr int CS_LD = BN + 4;   // fp32 elements; row pitch 272 B

__device__ __forceinline__ float silu(float a) { return a / (1.f + expf(-a)); }

__device__ __forceinline__ float gelu_tanh(float a) {
    const float u = 0.7978845608028654f * (a + 0.044715f * a * a * a);
    return 0.5f * a * (1.f + tanhf(u));
}

// Loads the mask of slots n0 .. n0+BM-1 (0 past N) into ms; true, in every
// thread, when any of them is valid.  Also the barrier that publishes ms.
__device__ __forceinline__ bool load_tile_mask(const float* __restrict__ mask_e, int n0,
                                               int N, float* ms) {
    int live = 0;
    for (int r = threadIdx.x; r < BM; r += blockDim.x) {
        const float m = n0 + r < N ? mask_e[n0 + r] : 0.f;
        ms[r] = m;
        live |= m != 0.f;
    }
    return __syncthreads_or(live);
}

// The gate: h[e, n0:n0+64, f0:f0+64] = act(mask * x_e @ w1_e [, w3_e]) in fp32.
template <int ACT>
__global__ void __launch_bounds__(128)
grouped_gate_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                         const bf16* __restrict__ w3, const float* __restrict__ mask,
                         float* __restrict__ h, int N, int d, int F) {
    constexpr int NW = ACT == ACT_SWIGLU ? 2 : 1;
    __shared__ float ms[BM];
    __shared__ __align__(32) bf16 xs[BM * XS_LD];
    __shared__ __align__(32) bf16 ws[NW][BK * WS_LD];
    __shared__ __align__(32) float cs[BM * CS_LD];

    const int e = blockIdx.z, n0 = blockIdx.y * BM, f0 = blockIdx.x * BN;
    if (!load_tile_mask(mask + (size_t)e * N, n0, N, ms)) return;
    x += (size_t)e * N * d;
    w1 += (size_t)e * d * F;
    if (ACT == ACT_SWIGLU) w3 += (size_t)e * d * F;
    h += (size_t)e * N * F;

    const int tid = threadIdx.x, warp = tid >> 5;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;   // 2 x 2 warps
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NW][2][2];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[w][i][j], 0.f);

    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int k0 = 0; k0 < d; k0 += BK) {
        for (int i = tid; i < BM * BK / 8; i += blockDim.x) {
            const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
            uint4 v = zero;
            const float m = ms[r];
            if (m != 0.f && k0 + c < d) {
                v = *reinterpret_cast<const uint4*>(x + (size_t)(n0 + r) * d + k0 + c);
                if (m != 1.f) {
                    bf16* b = reinterpret_cast<bf16*>(&v);
#pragma unroll
                    for (int t = 0; t < 8; ++t) b[t] = __float2bfloat16(__bfloat162float(b[t]) * m);
                }
            }
            *reinterpret_cast<uint4*>(xs + r * XS_LD + c) = v;
        }
        for (int i = tid; i < BK * BN / 8; i += blockDim.x) {
            const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
            const bool ok = k0 + r < d && f0 + c < F;
            const size_t off = (size_t)(k0 + r) * F + f0 + c;
            *reinterpret_cast<uint4*>(ws[0] + r * WS_LD + c) =
                ok ? *reinterpret_cast<const uint4*>(w1 + off) : zero;
            if (ACT == ACT_SWIGLU)
                *reinterpret_cast<uint4*>(ws[NW - 1] + r * WS_LD + c) =
                    ok ? *reinterpret_cast<const uint4*>(w3 + off) : zero;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(fa[i], xs + (wm + i * 16) * XS_LD + kk, XS_LD);
#pragma unroll
            for (int w = 0; w < NW; ++w) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    wmma::load_matrix_sync(fb[j], ws[w] + kk * WS_LD + wn + j * 16, WS_LD);
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int j = 0; j < 2; ++j)
                        wmma::mma_sync(acc[w][i][j], fa[i], fb[j], acc[w][i][j]);
            }
        }
        __syncthreads();
    }

    // the activation in registers: fragments of one type share their element map
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int t = 0; t < acc[0][i][j].num_elements; ++t) {
                const float a = acc[0][i][j].x[t];
                acc[0][i][j].x[t] = ACT == ACT_SWIGLU ? silu(a) * acc[NW - 1][i][j].x[t]
                                                      : gelu_tanh(a);
            }
            wmma::store_matrix_sync(cs + (wm + i * 16) * CS_LD + wn + j * 16, acc[0][i][j],
                                    CS_LD, wmma::mem_row_major);
        }
    __syncthreads();
    for (int i = tid; i < BM * BN / 4; i += blockDim.x) {
        const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
        if (n0 + r >= N || f0 + c >= F) continue;
        *reinterpret_cast<float4*>(h + (size_t)(n0 + r) * F + f0 + c) =
            *reinterpret_cast<const float4*>(cs + r * CS_LD + c);
    }
}

// The down product: out[e, n0:n0+64, c0:c0+64] = mask * (h_e @ w2_e), TF32
// tensor cores with fp32 accumulation, stored in bf16.
__global__ void __launch_bounds__(128)
grouped_down_tf32_kernel(const float* __restrict__ h, const bf16* __restrict__ w2,
                         const float* __restrict__ mask, bf16* __restrict__ out,
                         int N, int F, int d) {
    __shared__ float ms[BM];
    __shared__ __align__(32) float hs[BM * HS_LD];
    __shared__ __align__(32) float w2s[BK * CS_LD];
    __shared__ __align__(32) float cs[BM * CS_LD];

    const int e = blockIdx.z, n0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
    const int tid = threadIdx.x;
    const bool live = load_tile_mask(mask + (size_t)e * N, n0, N, ms);
    out += (size_t)e * N * d;
    if (!live) {   // masked slots are zero by definition; h was not written
        for (int i = tid; i < BM * BN / 8; i += blockDim.x) {
            const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
            if (n0 + r < N && c0 + c < d)
                *reinterpret_cast<uint4*>(out + (size_t)(n0 + r) * d + c0 + c) =
                    make_uint4(0, 0, 0, 0);
        }
        return;
    }
    h += (size_t)e * N * F;
    w2 += (size_t)e * F * d;

    const int warp = tid >> 5;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;   // 2 x 2 warps
    wmma::fragment<wmma::accumulator, 16, 16, 8, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < F; k0 += BK) {
        for (int i = tid; i < BM * BK / 4; i += blockDim.x) {
            const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
            *reinterpret_cast<float4*>(hs + r * HS_LD + c) =
                n0 + r < N && k0 + c < F
                    ? *reinterpret_cast<const float4*>(h + (size_t)(n0 + r) * F + k0 + c)
                    : zero4;
        }
        for (int i = tid; i < BK * BN / 8; i += blockDim.x) {
            const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
            __align__(16) bf16 v[8];
            *reinterpret_cast<uint4*>(v) =
                k0 + r < F && c0 + c < d
                    ? *reinterpret_cast<const uint4*>(w2 + (size_t)(k0 + r) * d + c0 + c)
                    : make_uint4(0, 0, 0, 0);
            float* dst = w2s + r * CS_LD + c;
#pragma unroll
            for (int t = 0; t < 8; ++t) dst[t] = __bfloat162float(v[t]);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 8) {
            wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major> fa[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major> fb[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                wmma::load_matrix_sync(fa[i], hs + (wm + i * 16) * HS_LD + kk, HS_LD);
#pragma unroll
                for (int t = 0; t < fa[i].num_elements; ++t)   // round to nearest
                    fa[i].x[t] = wmma::__float_to_tf32(fa[i].x[t]);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                // bf16 values are exact in TF32: no rounding needed
                wmma::load_matrix_sync(fb[j], w2s + kk * CS_LD + wn + j * 16, CS_LD);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(cs + (wm + i * 16) * CS_LD + wn + j * 16, acc[i][j],
                                    CS_LD, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < BM * BN / 8; i += blockDim.x) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        if (n0 + r >= N || c0 + c >= d) continue;
        __align__(16) bf16 v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = __float2bfloat16(cs[r * CS_LD + c + t] * ms[r]);
        *reinterpret_cast<uint4*>(out + (size_t)(n0 + r) * d + c0 + c) =
            *reinterpret_cast<const uint4*>(v);
    }
}

constexpr int FBK = 16;

// fp32 twin of both kernels on FFMA: a (E, N, K), b1/b3 (E, K, M) -> c (E, N, M).
// ACT_SWIGLU / ACT_GELU: c = act(mask * a @ b1 [, b3]) (the gate, into h);
// DOWN: c = mask * (a @ b1) (the down product, zeros for a masked tile).
template <int MODE>
__global__ void __launch_bounds__(256)
grouped_ffma_kernel(const float* __restrict__ a, const float* __restrict__ b1,
                    const float* __restrict__ b3, const float* __restrict__ mask,
                    float* __restrict__ c, int N, int K, int M) {
    constexpr int NB = MODE == ACT_SWIGLU ? 2 : 1;
    __shared__ float ms[BM];
    __shared__ float as[FBK][BM + 4];   // a tile, transposed
    __shared__ float bs[NB][FBK][BN];

    const int e = blockIdx.z, n0 = blockIdx.y * BM, m0 = blockIdx.x * BN;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const bool live = load_tile_mask(mask + (size_t)e * N, n0, N, ms);
    c += (size_t)e * N * M;
    if (!live) {
        if (MODE == DOWN)
            for (int i = tid; i < BM * BN; i += blockDim.x) {
                const int r = i / BN, col = i % BN;
                if (n0 + r < N && m0 + col < M) c[(size_t)(n0 + r) * M + m0 + col] = 0.f;
            }
        return;
    }
    a += (size_t)e * N * K;
    b1 += (size_t)e * K * M;
    if (MODE == ACT_SWIGLU) b3 += (size_t)e * K * M;

    float acc[NB][4][4] = {};
    for (int k0 = 0; k0 < K; k0 += FBK) {
        for (int i = tid; i < BM * FBK; i += blockDim.x) {
            const int r = i / FBK, col = i % FBK;
            const float v = n0 + r < N && k0 + col < K ? a[(size_t)(n0 + r) * K + k0 + col] : 0.f;
            as[col][r] = MODE == DOWN ? v : v * ms[r];
        }
        for (int i = tid; i < FBK * BN; i += blockDim.x) {
            const int r = i / BN, col = i % BN;
            const bool ok = k0 + r < K && m0 + col < M;
            const size_t off = (size_t)(k0 + r) * M + m0 + col;
            bs[0][r][col] = ok ? b1[off] : 0.f;
            if (MODE == ACT_SWIGLU) bs[NB - 1][r][col] = ok ? b3[off] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < FBK; ++kk) {
            float av[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) av[t] = as[kk][ty * 4 + t];
#pragma unroll
            for (int w = 0; w < NB; ++w) {
                float bv[4];
#pragma unroll
                for (int t = 0; t < 4; ++t) bv[t] = bs[w][kk][tx * 4 + t];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[w][i][j] = fmaf(av[i], bv[j], acc[w][i][j]);
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (n0 + r >= N) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = m0 + tx * 4 + j;
            if (col >= M) continue;
            const float v = acc[0][i][j];
            c[(size_t)(n0 + r) * M + col] =
                MODE == ACT_SWIGLU ? silu(v) * acc[NB - 1][i][j]
                : MODE == ACT_GELU ? gelu_tanh(v) : v * ms[r];
        }
    }
}

}  // namespace

// x: (E, N, d), w1/w3: (E, d, F) (w3 unused and may be null for gelu), w2:
// (E, F, d), out: (E, N, d), all contiguous row-major in one dtype; mask:
// (E, N) fp32 in {0, 1}; h: an fp32 (E, N, F) scratch.  act: 0 = swiglu,
// 1 = gelu.  For bf16, d and F must be multiples of 8 (16-byte vector loads
// and stores).  Anything else is refused with cudaErrorInvalidValue before
// a launch.
extern "C" int grouped_mlp_fwd(const void* x, const void* w1, const void* w3,
                               const void* w2, const float* mask, float* h, void* out,
                               int E, int N, int d, int F, int act, int dtype,
                               void* stream) {
    if (E <= 0 || E > 65535 || N < 0 || (N + BM - 1) / BM > 65535 || d <= 0 || F <= 0)
        return cudaErrorInvalidValue;
    if (act != ACT_SWIGLU && act != ACT_GELU) return cudaErrorInvalidValue;
    if (act == ACT_SWIGLU && w3 == nullptr) return cudaErrorInvalidValue;
    if (N == 0) return cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int nt = (N + BM - 1) / BM;
    const dim3 gate_grid((F + BN - 1) / BN, nt, E), down_grid((d + BN - 1) / BN, nt, E);
    switch (dtype) {
        case DTYPE_BF16: {
            if (d % 8 != 0 || F % 8 != 0) return cudaErrorInvalidValue;
            const bf16 *xb = static_cast<const bf16*>(x), *w1b = static_cast<const bf16*>(w1),
                       *w3b = static_cast<const bf16*>(w3);
            if (act == ACT_SWIGLU)
                grouped_gate_bf16_kernel<ACT_SWIGLU><<<gate_grid, 128, 0, s>>>(
                    xb, w1b, w3b, mask, h, N, d, F);
            else
                grouped_gate_bf16_kernel<ACT_GELU><<<gate_grid, 128, 0, s>>>(
                    xb, w1b, w3b, mask, h, N, d, F);
            const cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) return err;
            grouped_down_tf32_kernel<<<down_grid, 128, 0, s>>>(
                h, static_cast<const bf16*>(w2), mask, static_cast<bf16*>(out), N, F, d);
            break;
        }
        case DTYPE_F32: {
            const float *xf = static_cast<const float*>(x), *w1f = static_cast<const float*>(w1),
                        *w3f = static_cast<const float*>(w3);
            if (act == ACT_SWIGLU)
                grouped_ffma_kernel<ACT_SWIGLU><<<gate_grid, 256, 0, s>>>(
                    xf, w1f, w3f, mask, h, N, d, F);
            else
                grouped_ffma_kernel<ACT_GELU><<<gate_grid, 256, 0, s>>>(
                    xf, w1f, w3f, mask, h, N, d, F);
            const cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) return err;
            grouped_ffma_kernel<DOWN><<<down_grid, 256, 0, s>>>(
                h, static_cast<const float*>(w2), nullptr, mask, static_cast<float*>(out),
                N, F, d);
            break;
        }
        default:
            return cudaErrorInvalidValue;   // not built for this dtype
    }
    return cudaGetLastError();
}
