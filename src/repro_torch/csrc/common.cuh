// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every C entry point takes raw device pointers, sizes and a cudaStream_t,
// launches on that stream without synchronising, and returns
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch.  Element types are passed as a code: DTYPE_F32 or DTYPE_BF16.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

enum { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

extern "C" const char* error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// A head dim rounded up to the contraction step of mma.sync (16) and to the
// 32 lanes of a warp (the flash kernels): 88 -> 96 for both, 80 -> 80 and
// 96, 64 and 128 as they are.
__host__ __device__ constexpr int pad16(int hd) { return (hd + 15) / 16 * 16; }
__host__ __device__ constexpr int pad32(int hd) { return (hd + 31) / 32 * 32; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}
