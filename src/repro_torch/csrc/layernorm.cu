// Fused LayerNorm forward for Hopper.
//
// Replaces: repro/kernels/layernorm.py:_layernorm_kernel (via
//   layernorm_fwd_pallas): in fp32, mean = sum(x)/d, then
//   var = sum((x - mean)^2)/d (two passes, as the TPU kernel; no one-pass
//   E[x^2] - E[x]^2, which cancels for rows far from zero mean),
//   y = (x - mean) * rsqrt(var + eps) * w + b, cast to x's dtype.
// Bound on the H100: memory.  Each row is read once and written once (plus
//   the two d-wide vectors w and b, which stay in L1/L2); a few FLOP per
//   byte, far below the card's ~295 FLOP/byte ridge.
// Design: as csrc/rmsnorm.cu, one block per row with 16-byte vectors
//   (d = 2112 in bf16 is 264 vectors: 288 threads, the last warp masked by
//   the loop bound and contributing zeros to the shuffles).  Three passes
//   over the row: the sum, the sum of squared deviations from the mean, and
//   the scaled, shifted store; the second and third re-read the row, which
//   the first brought into L1.  Each sum is reduced by warp shuffles and one
//   shared-memory step that every warp then reduces itself, so all threads
//   hold the total without another barrier.
#include "common.cuh"

template <typename T>
struct alignas(16) Pack {
    T v[16 / sizeof(T)];
};

// Sum of v over the block; every thread gets the total.  The leading
// barrier lets ``red`` be reused by consecutive calls.
__device__ __forceinline__ float block_sum(float v, float* red) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    v = warp_sum(v);
    __syncthreads();
    if (lane == 0) red[wid] = v;
    __syncthreads();
    const int nw = (blockDim.x + 31) >> 5;
    return warp_sum(lane < nw ? red[lane] : 0.f);
}

template <typename T>
__global__ void layernorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                 const T* __restrict__ b, T* __restrict__ y, int d,
                                 float eps) {
    constexpr int VEC = 16 / sizeof(T);
    const int nvec = d / VEC;
    const Pack<T>* xr = reinterpret_cast<const Pack<T>*>(x + (size_t)blockIdx.x * d);
    const Pack<T>* wr = reinterpret_cast<const Pack<T>*>(w);
    const Pack<T>* br = reinterpret_cast<const Pack<T>*>(b);
    Pack<T>* yr = reinterpret_cast<Pack<T>*>(y + (size_t)blockIdx.x * d);
    __shared__ float red[32];

    float s = 0.f;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
        const Pack<T> p = xr[i];
#pragma unroll
        for (int j = 0; j < VEC; ++j) s += to_f32(p.v[j]);
    }
    const float mean = block_sum(s, red) / (float)d;

    float ss = 0.f;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
        const Pack<T> p = xr[i];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            const float c = to_f32(p.v[j]) - mean;
            ss += c * c;
        }
    }
    const float inv = rsqrtf(block_sum(ss, red) / (float)d + eps);

    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
        const Pack<T> p = xr[i];
        const Pack<T> wv = wr[i];
        const Pack<T> bv = br[i];
        Pack<T> o;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
            o.v[j] = from_f32<T>((to_f32(p.v[j]) - mean) * inv * to_f32(wv.v[j])
                                 + to_f32(bv.v[j]));
        yr[i] = o;
    }
}

// x, y: (n_rows, d) contiguous; w, b: (d,).  d must be a multiple of 16
// bytes; every pointer 16-byte aligned.
extern "C" int layernorm_fwd(const void* x, const void* w, const void* b, void* y,
                             int n_rows, int d, float eps, int dtype, void* stream) {
    const int vec = dtype == DTYPE_BF16 ? 8 : 4;
    if ((dtype != DTYPE_BF16 && dtype != DTYPE_F32) || d <= 0 || d % vec != 0
        || n_rows < 0)
        return cudaErrorInvalidValue;
    if (n_rows == 0) return cudaSuccess;
    const int nvec = d / vec;
    const int threads = nvec >= 1024 ? 1024 : ((nvec + 31) / 32) * 32;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == DTYPE_BF16)
        layernorm_kernel<__nv_bfloat16><<<n_rows, threads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
            static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y), d, eps);
    else
        layernorm_kernel<float><<<n_rows, threads, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(w),
            static_cast<const float*>(b), static_cast<float*>(y), d, eps);
    return cudaGetLastError();
}
