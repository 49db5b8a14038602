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
//   bf16: warp-specialised.  A producer warp issues TMA copies (2-D tensor
//   maps, 128-byte swizzle) of the x tile (TILE_M rows x 64 of d) and of the
//   w1 and w3 tiles (64 of d x TILE_N columns, read in the weights' (d, F)
//   row-major layout) into a ring of shared-memory stages, each signalled
//   by an mbarrier; consumer warpgroups of 64 rows run wgmma on the stage
//   that has arrived (x K-major, the weights MN-major, i.e. transposed B)
//   with one group in flight, and release the stage behind it.  Two regimes,
//   chosen by N in the C entry:
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
#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 64, BN = 64;   // the fp32 kernel's tile

__device__ __forceinline__ float silu(float a) { return a / (1.f + expf(-a)); }

// ---------------------------------------------------------------------------
// bf16: TMA ring, wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int BK = 64;            // d per stage: one 128-byte box row
constexpr int GROUP_M = 16;       // row tiles that sweep the same F columns
constexpr int STREAM_ROWS = 64;   // N below this streams the weights

template <int BM_, int BNF_, int STAGES_, int MIN_BLOCKS_>
struct Cfg {
    static constexpr int TILE_M = BM_, TILE_N = BNF_, STAGES = STAGES_;
    static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
    static constexpr int CONSUMERS = TILE_M / 64;          // warpgroups of 64 rows
    static constexpr int THREADS = 128 * (CONSUMERS + 1);
    static constexpr int X_BYTES = TILE_M * BK * 2;
    static constexpr int W_BOX = BK * 64 * 2;               // 64 of d x 64 columns
    static constexpr int W_BYTES = TILE_N / 64 * W_BOX;
    static constexpr int STAGE_BYTES = X_BYTES + 2 * W_BYTES;
    static constexpr int SMEM = hopper::SMEM_ALIGN + STAGES * STAGE_BYTES + 16 * STAGES;
};
using GemmCfg = Cfg<128, 128, 4, 1>;     // 48 KB a stage
using WideCfg = Cfg<128, 192, 3, 1>;     // 64 KB a stage
using StreamCfg = Cfg<64, 64, 4, 2>;     // 24 KB a stage

// Columns of the N >= 64 tile, 128 or 192: whichever takes fewer waves of
// tiles over the SMs times its width (the narrower on a tie), so that a
// prefill of a few row tiles does not leave most of a last wave idle.
int gemm_cols(int N, int F, int sms) {
    const long long tm = (N + 127) / 128;
    const auto cost = [&](long long bn) {
        return (tm * ((F + bn - 1) / bn) + sms - 1) / sms * bn;
    };
    return cost(192) < cost(128) ? 192 : 128;
}

// Block -> (row tile, column tile): groups of GROUP_M row tiles, row tile
// fastest within a group, so blocks in flight together share F columns.
__device__ __forceinline__ void tile_of(int pid, int tiles_m, int tiles_n, int& tm, int& tn) {
    const int per_group = GROUP_M * tiles_n;
    const int first = pid / per_group * GROUP_M;
    const int gm = min(tiles_m - first, GROUP_M);
    const int r = pid % per_group;
    tm = first + r % gm;
    tn = r / gm;
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
swiglu_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap w1map,
                   const __grid_constant__ CUtensorMap w3map, bf16* __restrict__ out,
                   int N, int d, int F) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* ring = hopper::align_smem(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE_BYTES);
    uint64_t* empty = full + C::STAGES;

    int tm, tn;
    tile_of(blockIdx.x, (N + C::TILE_M - 1) / C::TILE_M, (F + C::TILE_N - 1) / C::TILE_N,
            tm, tn);
    const int m0 = tm * C::TILE_M, n0 = tn * C::TILE_N, ktiles = (d + BK - 1) / BK;
    const int wg = threadIdx.x / 128;
    if (threadIdx.x == 0) {
        for (int s = 0; s < C::STAGES; ++s) {
            hopper::mbar_init(&full[s], 1);
            hopper::mbar_init(&empty[s], 4 * C::CONSUMERS);   // each consumer warp arrives
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();

    if (wg == 0) {
        // producer: one thread keeps the ring full
        if constexpr (C::CONSUMERS > 1) hopper::reg_dealloc<40>();
        if (threadIdx.x == 0) {
            hopper::prefetch_map(&xmap);
            hopper::prefetch_map(&w1map);
            hopper::prefetch_map(&w3map);
            for (int kt = 0; kt < ktiles; ++kt) {
                const int s = kt % C::STAGES;
                if (kt >= C::STAGES) hopper::mbar_wait(&empty[s], ((kt / C::STAGES) & 1) ^ 1);
                unsigned char* st = ring + s * C::STAGE_BYTES;
                hopper::mbar_expect_tx(&full[s], C::STAGE_BYTES);
                hopper::tma_load_2d(st, &xmap, &full[s], kt * BK, m0);
                for (int c = 0; c < C::TILE_N / 64; ++c) {
                    hopper::tma_load_2d(st + C::X_BYTES + c * C::W_BOX, &w1map, &full[s],
                                        n0 + 64 * c, kt * BK);
                    hopper::tma_load_2d(st + C::X_BYTES + C::W_BYTES + c * C::W_BOX, &w3map,
                                        &full[s], n0 + 64 * c, kt * BK);
                }
            }
        }
    } else {
        if constexpr (C::CONSUMERS > 1) hopper::reg_alloc<232>();
        const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32;
        float a[C::TILE_N / 2], g[C::TILE_N / 2];
#pragma unroll
        for (int i = 0; i < C::TILE_N / 2; ++i) a[i] = g[i] = 0.f;

        for (int kt = 0; kt < ktiles; ++kt) {
            const int s = kt % C::STAGES;
            hopper::mbar_wait(&full[s], (kt / C::STAGES) & 1);
            const unsigned char* st = ring + s * C::STAGE_BYTES;
            const uint64_t dx = hopper::desc(st + cw * 64 * 128, 16, 1024);
            const uint64_t d1 = hopper::desc(st + C::X_BYTES, C::W_BOX, 1024);
            const uint64_t d3 = hopper::desc(st + C::X_BYTES + C::W_BYTES, C::W_BOX, 1024);
            hopper::fence_regs(a);
            hopper::fence_regs(g);
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                // k16 steps: 32 bytes along x's rows, 16 rows (2048 bytes) down w
                hopper::wgmma_ss<1>(a, dx + hopper::desc_offset(kk * 32),
                                    d1 + hopper::desc_offset(kk * 2048), 1);
                hopper::wgmma_ss<1>(g, dx + hopper::desc_offset(kk * 32),
                                    d3 + hopper::desc_offset(kk * 2048), 1);
            }
            hopper::wgmma_commit();
            hopper::fence_regs(a);
            hopper::fence_regs(g);
            hopper::wgmma_wait<1>();          // the stage before this one is read
            if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % C::STAGES]);
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(a);
        hopper::fence_regs(g);

        const int row0 = m0 + cw * 64 + (t / 32) * 16 + lane / 4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = row0 + 8 * r;
            if (row >= N) continue;
            bf16* orow = out + (size_t)row * F;
#pragma unroll
            for (int j = 0; j < C::TILE_N / 8; ++j) {
                const int col = n0 + 8 * j + 2 * (lane % 4);
                if (col >= F) continue;                  // F is even: col + 1 < F
                const int i = 4 * j + 2 * r;
                __nv_bfloat162 v = __floats2bfloat162_rn(silu(a[i]) * g[i],
                                                         silu(a[i + 1]) * g[i + 1]);
                *reinterpret_cast<__nv_bfloat162*>(orow + col) = v;
            }
        }
    }
}

template <class C>
cudaError_t launch_bf16(const void* x, const void* w1, const void* w3, void* out,
                        int N, int d, int F, cudaStream_t s) {
    CUtensorMap xm, w1m, w3m;
    const uint64_t xdims[2] = {(uint64_t)d, (uint64_t)N}, xstr[1] = {(uint64_t)d * 2};
    const uint64_t wdims[2] = {(uint64_t)F, (uint64_t)d}, wstr[1] = {(uint64_t)F * 2};
    const uint32_t xbox[2] = {BK, C::TILE_M}, wbox[2] = {64, BK};
    cudaError_t e = hopper::make_map(&xm, x, 2, xdims, xstr, xbox);
    if (e == cudaSuccess) e = hopper::make_map(&w1m, w1, 2, wdims, wstr, wbox);
    if (e == cudaSuccess) e = hopper::make_map(&w3m, w3, 2, wdims, wstr, wbox);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(swiglu_bf16_kernel<C>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    const int blocks = (N + C::TILE_M - 1) / C::TILE_M * ((F + C::TILE_N - 1) / C::TILE_N);
    swiglu_bf16_kernel<C><<<blocks, C::THREADS, C::SMEM, s>>>(
        xm, w1m, w3m, static_cast<bf16*>(out), N, d, F);
    return cudaGetLastError();
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
