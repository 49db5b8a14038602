// Grouped expert MLP forward for Hopper: for every expert e,
//   out_e = mask_e * (act(mask_e * x_e) @ w2_e),
//   act(x) = silu(x @ w1_e) * (x @ w3_e)   (swiglu)  or  gelu_tanh(x @ w1_e)   (gelu),
// over the expert-major slot layout x (E, N, d), w1/w3 (E, d, F), w2 (E, F, d),
// mask (E, N) in {0, 1}: masked slots come out as zeros.
//
// Replaces: repro/kernels/grouped_mlp.py:_swiglu_kernel and _gelu_kernel (via
//   _fwd_pallas): both bodies, fp32 math inside, the silu gate or the tanh
//   GELU with the reference's constants (0.7978845608028654 = sqrt(2/pi),
//   0.044715, as csrc/gelu_mlp.cu), cast to x's dtype.
// Bound on the H100: serving routes a few tokens to each of 128 experts, so
//   N is 1-5 slots at prefill and 4 at decode and the weights of the experts
//   that hold a valid slot bound it (bytes): 111 of 128 experts, 27.9 GB, at
//   llama4-maverick's 256-token prefill; 4 (top-1) or 8 (top-2) at decode.
//   A 64-row wgmma tile over them does about 1.8 TFLOP, ~1.8 ms of tensor
//   time against 8.3 ms of bytes.
// Design (bf16): three launches from one entry, no host sync.
//   - A prologue kernel lists, on the device, the (expert, 64-row tile)
//     pairs that hold a valid slot ("live" row tiles, ascending, after
//     their count) and writes the output rows of every other row tile as
//     zeros, so that a dead expert's weights are never read.
//   - The gate and the down product are the persistent, warp-specialised
//     TMA + wgmma tile of csrc/tma_gemm.cuh in its weight-streaming shape
//     (64 rows, one consumer warpgroup, weights loaded evict-first) over
//     GroupedTiles: work items (live row tile, 128-column tile), read from
//     the list by every block, so the grid is as many blocks as fit
//     whatever the count.  128 columns are two adjacent 64-column boxes, so
//     each weight row is read 256 contiguous bytes at a time: with one box
//     (128 bytes) the same kernel took 1.41x as long at llama4's prefill,
//     65% of the byte bound against 91% (NVIDIA H100 80GB HBM3, 700 W;
//     tools/kernel_ab.py grouped_mlp against the 64-column variant).
//     Operands are 3-D tensor maps (E, rows, cols), one per operand and
//     call, so TMA's zero fill of rows past N, of columns past F or d and
//     of K past d or F stops at each expert's edge (a 2-D map over the
//     stacked experts would read the next expert's rows where d or F is not
//     a multiple of 64).
//   - The gate: x @ w1 (and x @ w3) into fp32 accumulators, the activation
//     in the epilogue; masked rows give h = 0 (for m in {0, 1} the same as
//     scaling x's rows).  h is stored as two bf16 planes, hi = bf16(h) and
//     lo = bf16(h - hi), in the (E, N, F) fp32 scratch byte for byte: hi +
//     lo is h to within 2^-16 of it (bf16 alone 2^-8, TF32 2^-11).
//   - The down product: wgmma with both planes as A operands against each
//     stage of w2 into one fp32 accumulator (tma_gemm's NA = 2), so w2 is
//     read once, in bf16 (no TF32, no fp32 copy in shared memory); the
//     epilogue multiplies by the mask and stores bf16.
//   Each output is one block's fp32 sum in a fixed order (no atomics, no
//   split of K), so repeated launches are bit-identical.  Outputs are
//   written by direct bf16-pair stores: at N <= 5 a 64-row box would stage
//   59 empty rows for each real one, and h and the output are 0.1% of the
//   bytes.  d and F must be multiples of 8 (TMA's 16-byte strides).
//   fp32: both products on FFMA (no TF32) in one 64 x 64 tile template with
//   synchronous loads, h in fp32 in the scratch; a 64-slot tile with no
//   valid slot returns at once (the down kernel writes its zeros).
#include "common.cuh"
#include "tma_gemm.cuh"

using bf16 = __nv_bfloat16;

namespace {

enum { ACT_SWIGLU = 0, ACT_GELU = 1, DOWN = 2 };

constexpr int BM = 64, BN = 64;   // the fp32 tile; BM is also the bf16 row tile

__device__ __forceinline__ float silu(float a) { return a / (1.f + expf(-a)); }

__device__ __forceinline__ float gelu_tanh(float a) {
    const float u = 0.7978845608028654f * (a + 0.044715f * a * a * a);
    return 0.5f * a * (1.f + tanhf(u));
}

// ---------------------------------------------------------------------------
// bf16: the live row tiles, then csrc/tma_gemm.cuh's tile over them
// ---------------------------------------------------------------------------

constexpr int LIVE_THREADS = 256;

// Block t of E * ceil(N / 64) is row tile t % T of expert t / T: with no
// valid slot, its output rows are written as zeros (`out` may be null: the
// mirror's entry lists without writing).  Block 0 also writes the list:
// live[0] the count, live[1..] the live row tiles (expert * T + row tile)
// in ascending order.
__global__ void __launch_bounds__(LIVE_THREADS)
grouped_live_kernel(const float* __restrict__ mask, int* __restrict__ live,
                    bf16* __restrict__ out, int E, int N, int d) {
    const int T = tma_gemm::cdiv(N, BM), tid = threadIdx.x;
    if (out != nullptr) {
        const int e = blockIdx.x / T, r0 = blockIdx.x % T * BM, r1 = min(N, r0 + BM);
        int any = 0;
        for (int r = r0 + tid; r < r1; r += LIVE_THREADS) any |= mask[(size_t)e * N + r] != 0.f;
        if (!__syncthreads_or(any)) {
            uint4* o = reinterpret_cast<uint4*>(out + ((size_t)e * N + r0) * d);
            const size_t n = (size_t)(r1 - r0) * d / 8;
            for (size_t i = tid; i < n; i += LIVE_THREADS) o[i] = make_uint4(0, 0, 0, 0);
        }
    }
    if (blockIdx.x != 0) return;
    __shared__ int warp_live[LIVE_THREADS / 32];
    __shared__ int count;
    const int warp = tid / 32, lane = tid % 32;
    if (tid == 0) count = 0;
    __syncthreads();
    for (int i0 = 0; i0 < E * T; i0 += LIVE_THREADS) {
        const int i = i0 + tid;
        bool on = false;
        if (i < E * T) {
            const float* m = mask + (size_t)(i / T) * N;
            for (int r = i % T * BM, r1 = min(N, r + BM); r < r1 && !on; ++r) on = m[r] != 0.f;
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, on);
        if (lane == 0) warp_live[warp] = __popc(ballot);
        __syncthreads();
        int before = count;
        for (int w = 0; w < warp; ++w) before += warp_live[w];
        if (on) live[1 + before + __popc(ballot & ((1u << lane) - 1))] = i;
        __syncthreads();
        if (tid == 0)
            for (int w = 0; w < LIVE_THREADS / 32; ++w) count += warp_live[w];
        __syncthreads();
    }
    if (tid == 0) live[0] = count;
}

constexpr int COLS = 128;   // the bf16 column tile: two 64-column boxes

// The tile list of the gate (cols = F) or the down product (cols = d).
__device__ __forceinline__ tma_gemm::GroupedTiles grouped_tiles(const int* live, int N,
                                                                int cols) {
    return {live + 1, live[0], tma_gemm::cdiv(N, BM), tma_gemm::cdiv(cols, COLS)};
}

using tma_gemm::Cfg;
// (rows, columns, products, stages, blocks an SM, staging, weights streamed,
// A planes): one warpgroup of 64 rows by 128 columns, one block an SM with
// about 200 KB of stages: 160 KB of weights in flight on each SM for the
// gate (5 stages of 32 KB of w1 and w3), 128 KB for gelu's (8 of 16 KB of
// w1), 96 KB of w2 beside h's two planes for the down product (6 stages).
template <int NB>
using GateCfg = Cfg<BM, COLS, NB, NB == 2 ? 5 : 8, 1, 0, true>;   // 40 or 24 KB a stage
using DownCfg = Cfg<BM, COLS, 1, 6, 1, 0, true, 2>;                // 32 KB a stage

// The gate's epilogue: h = act(a [, b]) in fp32 (0 on a masked row), stored
// as bf16 hi and lo planes, rows past N and columns past F skipped.
template <int ACT>
struct GateStore {
    const float* mask;
    bf16 *hi, *lo;
    int N, F;

    template <int NB, int ACC>
    __device__ __forceinline__ void operator()(float (&acc)[NB][ACC], int m0, int n0, int t,
                                               unsigned char*, int e) const {
        const int lane = t % 32;
        const int row0 = m0 + (t / 32) * 16 + lane / 4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = row0 + 8 * r;
            if (row >= N) continue;
            const bool valid = mask[(size_t)e * N + row] != 0.f;
            const size_t base = ((size_t)e * N + row) * F;
#pragma unroll
            for (int j = 0; j < ACC / 4; ++j) {
                const int col = n0 + 8 * j + 2 * (lane % 4);
                if (col >= F) continue;                  // F is even: col + 1 < F
                const int i = 4 * j + 2 * r;
                float h0 = 0.f, h1 = 0.f;
                if (valid) {
                    h0 = ACT == ACT_SWIGLU ? silu(acc[0][i]) * acc[NB - 1][i] : gelu_tanh(acc[0][i]);
                    h1 = ACT == ACT_SWIGLU ? silu(acc[0][i + 1]) * acc[NB - 1][i + 1]
                                           : gelu_tanh(acc[0][i + 1]);
                }
                const __nv_bfloat162 h2 = __floats2bfloat162_rn(h0, h1);
                const float2 back = __bfloat1622float2(h2);
                *reinterpret_cast<__nv_bfloat162*>(hi + base + col) = h2;
                *reinterpret_cast<__nv_bfloat162*>(lo + base + col) =
                    __floats2bfloat162_rn(h0 - back.x, h1 - back.y);
            }
        }
    }
};

// The down product's epilogue: mask * acc in bf16 (exactly 0 on a masked
// row), rows past N and columns past d skipped.
struct DownStore {
    const float* mask;
    bf16* out;
    int N, d;

    template <int NB, int ACC>
    __device__ __forceinline__ void operator()(float (&acc)[NB][ACC], int m0, int n0, int t,
                                               unsigned char*, int e) const {
        const int lane = t % 32;
        const int row0 = m0 + (t / 32) * 16 + lane / 4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = row0 + 8 * r;
            if (row >= N) continue;
            const float m = mask[(size_t)e * N + row];
            bf16* orow = out + ((size_t)e * N + row) * d;
#pragma unroll
            for (int j = 0; j < ACC / 4; ++j) {
                const int col = n0 + 8 * j + 2 * (lane % 4);
                if (col >= d) continue;
                const int i = 4 * j + 2 * r;
                *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                    m != 0.f ? __floats2bfloat162_rn(acc[0][i] * m, acc[0][i + 1] * m)
                             : __floats2bfloat162_rn(0.f, 0.f);
            }
        }
    }
};

template <class C, int ACT>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
grouped_gate_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap w1map,
                         const __grid_constant__ CUtensorMap w3map,
                         const float* __restrict__ mask, const int* __restrict__ live,
                         bf16* __restrict__ hi, bf16* __restrict__ lo, int N, int d, int F) {
    const GateStore<ACT> epi{mask, hi, lo, N, F};
    if constexpr (ACT == ACT_SWIGLU)
        tma_gemm::run_tiles<C>(grouped_tiles(live, N, F), {&xmap}, {&w1map, &w3map}, d, epi);
    else
        tma_gemm::run_tiles<C>(grouped_tiles(live, N, F), {&xmap}, {&w1map}, d, epi);
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
grouped_down_bf16_kernel(const __grid_constant__ CUtensorMap himap,
                         const __grid_constant__ CUtensorMap lomap,
                         const __grid_constant__ CUtensorMap w2map,
                         const float* __restrict__ mask, const int* __restrict__ live,
                         bf16* __restrict__ out, int N, int d, int F) {
    tma_gemm::run_tiles<C>(grouped_tiles(live, N, d), {&himap, &lomap}, {&w2map}, F,
                           DownStore{mask, out, N, d});
}

// Writes, for each tile index below max_tiles, the (expert, row tile,
// column tile) that GroupedTiles gives it, or -1s past the list's end.
__global__ void grouped_items_kernel(const int* __restrict__ live, int* __restrict__ items,
                                     int N, int cols, int max_tiles) {
    const tma_gemm::GroupedTiles tl = grouped_tiles(live, N, cols);
    for (int tile = blockIdx.x * blockDim.x + threadIdx.x; tile < max_tiles;
         tile += gridDim.x * blockDim.x) {
        int e = -1, tm = -1, tn = -1;
        if (tile < tl.count()) tl.at(tile, e, tm, tn);
        items[3 * tile] = e;
        items[3 * tile + 1] = tm;
        items[3 * tile + 2] = tn;
    }
}

template <int ACT>
cudaError_t launch_bf16(const void* x, const void* w1, const void* w3, const void* w2,
                        const float* mask, float* h, void* out, int E, int N, int d, int F,
                        cudaStream_t s) {
    using G = GateCfg<ACT == ACT_SWIGLU ? 2 : 1>;
    const int T = tma_gemm::cdiv(N, BM);
    bf16* hi = reinterpret_cast<bf16*>(h);
    bf16* lo = hi + (size_t)E * N * F;
    int* live = reinterpret_cast<int*>(h + (size_t)E * N * F);
    grouped_live_kernel<<<E * T, LIVE_THREADS, 0, s>>>(mask, live, static_cast<bf16*>(out),
                                                        E, N, d);
    cudaError_t err = cudaGetLastError();
    CUtensorMap xm, w1m, w3m, him, lom, w2m;
    if (err == cudaSuccess) err = tma_gemm::make_map_3d(&xm, x, E, N, d, BM);
    if (err == cudaSuccess) err = tma_gemm::make_map_3d(&w1m, w1, E, d, F, tma_gemm::BK);
    if (err == cudaSuccess && ACT == ACT_SWIGLU)
        err = tma_gemm::make_map_3d(&w3m, w3, E, d, F, tma_gemm::BK);
    if (err == cudaSuccess) err = tma_gemm::make_map_3d(&him, hi, E, N, F, BM);
    if (err == cudaSuccess) err = tma_gemm::make_map_3d(&lom, lo, E, N, F, BM);
    if (err == cudaSuccess) err = tma_gemm::make_map_3d(&w2m, w2, E, F, d, tma_gemm::BK);
    if (err != cudaSuccess) return err;
    if (ACT != ACT_SWIGLU) w3m = w1m;   // not read
    err = tma_gemm::launch_persistent<G>(grouped_gate_bf16_kernel<G, ACT>,
                                         (long long)E * T * tma_gemm::cdiv(F, COLS), s, xm, w1m,
                                         w3m, mask, live, hi, lo, N, d, F);
    if (err != cudaSuccess) return err;
    return tma_gemm::launch_persistent<DownCfg>(grouped_down_bf16_kernel<DownCfg>,
                                                (long long)E * T * tma_gemm::cdiv(d, COLS), s,
                                                him, lom, w2m, mask, live,
                                                static_cast<bf16*>(out), N, d, F);
}

// ---------------------------------------------------------------------------
// fp32: FFMA
// ---------------------------------------------------------------------------

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
// (E, F, d), out: (E, N, d), all contiguous row-major in one dtype with
// 16-byte aligned bases; mask: (E, N) fp32 in {0, 1}; h: a scratch of
// E * N * F + E * ceil(N / 64) + 1 floats (fp32: h in its first E * N * F;
// bf16: h's hi and lo planes there, then the live row tiles).  act: 0 =
// swiglu, 1 = gelu.  For bf16, d and F must be multiples of 8 (TMA's 16-byte
// strides).  Anything else is refused with cudaErrorInvalidValue before a
// launch.
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
        case DTYPE_BF16:
            if (d % 8 != 0 || F % 8 != 0 || (long long)E * nt > 0x7fffffff)
                return cudaErrorInvalidValue;
            return act == ACT_SWIGLU
                ? launch_bf16<ACT_SWIGLU>(x, w1, w3, w2, mask, h, out, E, N, d, F, s)
                : launch_bf16<ACT_GELU>(x, w1, w3, w2, mask, h, out, E, N, d, F, s);
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

// The bf16 work order, for the host-side mirror's check
// (kernels/tiling.py: grouped_order): lists the live row tiles of the (E, N)
// device mask into `live` (E * ceil(N / 64) + 1 ints) as grouped_mlp_fwd
// does, then writes (expert, row tile, column tile) of each of the first
// E * ceil(N / 64) * ceil(cols / 128) tile indices to `items` (-1s past the
// list's end), cols being F for the gate or d for the down product.
extern "C" int grouped_mlp_items(const float* mask, int* live, int* items, int E, int N,
                                 int cols, void* stream) {
    if (E <= 0 || N <= 0 || cols <= 0) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int T = tma_gemm::cdiv(N, BM), tiles = E * T * tma_gemm::cdiv(cols, COLS);
    grouped_live_kernel<<<1, LIVE_THREADS, 0, s>>>(mask, live, nullptr, E, N, 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    grouped_items_kernel<<<tma_gemm::cdiv(tiles, 256), 256, 0, s>>>(live, items, N, cols, tiles);
    return cudaGetLastError();
}
