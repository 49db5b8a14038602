// Fused RMSNorm forward for Hopper.
//
// Replaces: repro/kernels/rmsnorm.py:_rmsnorm_kernel (via rmsnorm_fwd_pallas),
//   y = (x * rsqrt(mean(x^2) + eps) * w) in fp32, cast to x's dtype.
// Bound on the H100: memory.  Each row is read once and written once (plus
//   the d-wide weight, which stays in L1/L2); at 2 FLOP per byte it is far
//   below the card's ~295 FLOP/byte ridge.
// Design: one block per row, 16-byte vector loads (d = 4096 in bf16 is 512
//   threads x 8 values), fp32 sum of squares reduced by warp shuffles and
//   one shared-memory step, then a second pass over the row (an L1 hit)
//   that scales, multiplies by the weight and stores with 16-byte stores.
#include "common.cuh"

template <typename T>
struct alignas(16) Pack {
    T v[16 / sizeof(T)];
};

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                               T* __restrict__ y, int d, float eps) {
    constexpr int VEC = 16 / sizeof(T);
    const int nvec = d / VEC;
    const Pack<T>* xr = reinterpret_cast<const Pack<T>*>(x + (size_t)blockIdx.x * d);
    const Pack<T>* wr = reinterpret_cast<const Pack<T>*>(w);
    Pack<T>* yr = reinterpret_cast<Pack<T>*>(y + (size_t)blockIdx.x * d);

    float ss = 0.f;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
        const Pack<T> p = xr[i];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            const float f = to_f32(p.v[j]);
            ss += f * f;
        }
    }
    __shared__ float red[32];
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    ss = warp_sum(ss);
    if (lane == 0) red[wid] = ss;
    __syncthreads();
    if (wid == 0) {
        const int nw = (blockDim.x + 31) >> 5;
        float t = lane < nw ? red[lane] : 0.f;
        t = warp_sum(t);
        if (lane == 0) red[0] = t;
    }
    __syncthreads();
    const float inv = rsqrtf(red[0] / (float)d + eps);

    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
        const Pack<T> p = xr[i];
        const Pack<T> q = wr[i];
        Pack<T> o;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
            o.v[j] = from_f32<T>(to_f32(p.v[j]) * inv * to_f32(q.v[j]));
        yr[i] = o;
    }
}

// x, y: (n_rows, d) contiguous; w: (d,).  d must be a multiple of 16 bytes.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int n_rows,
                           int d, float eps, int dtype, void* stream) {
    const int vec = dtype == DTYPE_BF16 ? 8 : 4;
    if ((dtype != DTYPE_BF16 && dtype != DTYPE_F32) || d <= 0 || d % vec != 0
        || n_rows < 0)
        return cudaErrorInvalidValue;
    if (n_rows == 0) return cudaSuccess;
    const int nvec = d / vec;
    const int threads = nvec >= 1024 ? 1024 : ((nvec + 31) / 32) * 32;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == DTYPE_BF16)
        rmsnorm_kernel<__nv_bfloat16><<<n_rows, threads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
            static_cast<__nv_bfloat16*>(y), d, eps);
    else
        rmsnorm_kernel<float><<<n_rows, threads, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(w),
            static_cast<float*>(y), d, eps);
    return cudaGetLastError();
}
