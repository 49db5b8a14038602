// The warp-specialised bf16 GEMM tile for Hopper that swiglu.cu, gelu_mlp.cu,
// cross_entropy.cu and grouped_mlp.cu are built from: one block computes a
// TILE_M x TILE_N tile of A @ B_b for NB products b (two for swiglu's gate,
// one for the others) and hands the fp32 accumulators, in registers, to the
// caller's epilogue, so that no product reaches device memory.  A may come
// as NA planes summed into the same accumulators (A_0 @ B + A_1 @ B: the
// grouped down product's h as bf16 hi + lo); the others take NA = 1.
//
// A (M, K) is row-major, the K-major operand of wgmma; each B (K, Ncols) is
// row-major, read as the MN-major ("transposed") operand.  Both arrive by
// TMA (128-byte swizzle: see hopper.cuh) into a ring of STAGES
// shared-memory stages; a stage holds A's TILE_M x 64 box (each plane) and,
// for each product, 64 of K x TILE_N columns as 64-column boxes, and its
// arrival is signalled by an mbarrier.  One producer thread keeps the ring
// full; consumer warpgroups of 64 rows run wgmma on the stage that has
// arrived with one group in flight, and release the stage behind it.
// Rows, columns and K past the edges arrive as zeros (TMA's out-of-bounds
// fill), so the sums are exact there; the epilogue masks what it writes.
//
// The grid is persistent: as many blocks as fit on the SMs at once, block
// b taking tiles b, b + grid, ... of a tile list.  DenseTiles is one (M,
// Ncols) output over 2-D maps, in GROUP_M-grouped order (the row tile
// fastest within a group of GROUP_M row tiles), so the blocks in flight
// together share B's columns, and A's rows, in the L2.  GroupedTiles is the
// grouped expert MLP's: 3-D (E, rows, cols) maps, and as row tiles only the
// (expert, row tile) pairs that a prologue kernel listed on the device, in
// the same grouped order over (listed row tile, column tile).  The ring
// runs on across a block's tiles: the producer loads the next tile's first
// stages while the consumers run the epilogue of the last.
//
// The epilogue is called by every consumer thread as
//   epi(acc, m0, n0, t, out)          (DenseTiles)
//   epi(acc, m0, n0, t, out, e)       (GroupedTiles: e the expert, m0 a row in it)
// with acc[b][ACC] the thread's accumulators of product b in wgmma's
// layout (for warp w = t / 32 of the warpgroup, lane = t % 32 and n8 block
// j, acc[b][4j + e] is row m0 + 16w + lane/4 + 8*(e/2), column n0 + 8j +
// 2*(lane%4) + e%2), m0 the warpgroup's first row, n0 the tile's first
// column, t the thread's index in its warpgroup and out the warpgroup's
// EPI_BYTES of shared memory (1024-byte aligned), e.g. to stage a TMA
// store; the block waits at its end until such stores have read it.
//
// The host side: make_map() and make_map_3d() build the operands' maps,
// gemm_cols() picks a 128-row tile's width, launch() and
// launch_persistent() start the persistent grid.  The tile order and the
// width rule are mirrored in kernels/tiling.py.
#pragma once

#include <initializer_list>

#include "hopper.cuh"

namespace tma_gemm {

constexpr int BK = 64;        // K per stage: one 128-byte box row
constexpr int GROUP_M = 16;   // row tiles that sweep the same columns together

// STREAM_B: B is read once (weight streaming at decode), so its lines are
// the first the L2 evicts, before lines that other blocks or kernels reuse
// or that are dirty.
// NA_: planes of A summed into the same accumulators.
template <int BM_, int BN_, int NB_, int STAGES_, int MIN_BLOCKS_, int EPI_BYTES_ = 0,
          bool STREAM_B_ = false, int NA_ = 1>
struct Cfg {
    static constexpr int TILE_M = BM_, TILE_N = BN_, NB = NB_, NA = NA_, STAGES = STAGES_;
    static constexpr int MIN_BLOCKS = MIN_BLOCKS_, EPI_BYTES = EPI_BYTES_;
    static constexpr bool STREAM_B = STREAM_B_;
    static constexpr int CONSUMERS = TILE_M / 64;          // warpgroups of 64 rows
    static constexpr int THREADS = 128 * (CONSUMERS + 1);
    static constexpr int ACC = TILE_N / 2;                  // accumulators a thread, a product
    static constexpr int A_BYTES = TILE_M * BK * 2;         // one plane
    static constexpr int B_BOX = BK * 64 * 2;               // 64 of K x 64 columns
    static constexpr int B_BYTES = TILE_N / 64 * B_BOX;
    static constexpr int STAGE_BYTES = NA * A_BYTES + NB * B_BYTES;
    // the ring, the epilogue's shared memory, the barriers
    static constexpr int SMEM = hopper::SMEM_ALIGN + STAGES * STAGE_BYTES
                                + CONSUMERS * EPI_BYTES + 16 * STAGES;
    static_assert(TILE_M % 64 == 0 && TILE_N % 64 == 0 && TILE_N <= 256, "wgmma tile");
    static_assert(EPI_BYTES % 1024 == 0, "aligned epilogue memory");
    static_assert(SMEM <= 232448, "shared memory of one block");
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Tile -> (row tile, column tile): groups of GROUP_M row tiles, the row
// tile fastest within a group, so tiles in flight together share columns.
__device__ __forceinline__ void tile_of(int tile, int tiles_m, int tiles_n, int& tm, int& tn) {
    const int per_group = GROUP_M * tiles_n;
    const int first = tile / per_group * GROUP_M;
    const int gm = min(tiles_m - first, GROUP_M);
    const int r = tile % per_group;
    tm = first + r % gm;
    tn = r / gm;
}

// The tiles of one (M, Ncols) output over 2-D maps, in tile_of's order.
struct DenseTiles {
    static constexpr bool GROUPED = false;
    int tiles_m, tiles_n;

    __device__ __forceinline__ int count() const { return tiles_m * tiles_n; }
    __device__ __forceinline__ void at(int tile, int& e, int& tm, int& tn) const {
        e = 0;
        tile_of(tile, tiles_m, tiles_n, tm, tn);
    }
};

// The grouped expert MLP's tiles over 3-D (E, rows, cols) maps: the n_live
// row tiles in `live` (expert * row_tiles + row tile, ascending) each by
// every column tile, in tile_of's order over (listed row tile, column tile).
struct GroupedTiles {
    static constexpr bool GROUPED = true;
    const int* live;
    int n_live, row_tiles, tiles_n;

    __device__ __forceinline__ int count() const { return n_live * tiles_n; }
    __device__ __forceinline__ void at(int tile, int& e, int& tm, int& tn) const {
        int l;
        tile_of(tile, n_live, tiles_n, l, tn);
        const int i = live[l];
        e = i / row_tiles;
        tm = i % row_tiles;
    }
};

// One box at (c0, c1) of a 2-D map, or of expert e of a 3-D one; EVICT_FIRST
// when STREAM.
template <class Tiles, bool STREAM>
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int e) {
    if constexpr (Tiles::GROUPED) {
        if constexpr (STREAM) hopper::tma_load_3d_hint(dst, map, bar, c0, c1, e,
                                                       hopper::EVICT_FIRST);
        else hopper::tma_load_3d(dst, map, bar, c0, c1, e);
    } else {
        if constexpr (STREAM) hopper::tma_load_2d_hint(dst, map, bar, c0, c1,
                                                       hopper::EVICT_FIRST);
        else hopper::tma_load_2d(dst, map, bar, c0, c1);
    }
}

// The block's tiles of sum_a A_a (M x K) @ B_b (K x Ncols), each followed by
// epi.  amap[a] are A's planes, NA of them; bmap[b] the products' maps, NB
// of them.  Launched by launch() or launch_persistent() below.
template <class C, class Tiles, class Epi>
__device__ __forceinline__ void run_tiles(const Tiles& tl,
                                          const CUtensorMap* const (&amap)[C::NA],
                                          const CUtensorMap* const (&bmap)[C::NB], int K,
                                          const Epi& epi) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* ring = hopper::align_smem(smem_raw);
    unsigned char* epi_smem = ring + C::STAGES * C::STAGE_BYTES;
    uint64_t* full = reinterpret_cast<uint64_t*>(epi_smem + C::CONSUMERS * C::EPI_BYTES);
    uint64_t* empty = full + C::STAGES;

    const int tiles = tl.count(), ktiles = cdiv(K, BK);
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
            for (int a = 0; a < C::NA; ++a) hopper::prefetch_map(amap[a]);
            for (int b = 0; b < C::NB; ++b) hopper::prefetch_map(bmap[b]);
            int it = 0;                        // stages loaded, over all tiles
            for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
                int e, tm, tn;
                tl.at(tile, e, tm, tn);
                for (int kt = 0; kt < ktiles; ++kt, ++it) {
                    const int s = it % C::STAGES;
                    if (it >= C::STAGES)
                        hopper::mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
                    unsigned char* st = ring + s * C::STAGE_BYTES;
                    hopper::mbar_expect_tx(&full[s], C::STAGE_BYTES);
                    for (int a = 0; a < C::NA; ++a)
                        load_box<Tiles, false>(st + a * C::A_BYTES, amap[a], &full[s],
                                               kt * BK, tm * C::TILE_M, e);
                    for (int b = 0; b < C::NB; ++b)
                        for (int c = 0; c < C::TILE_N / 64; ++c)
                            load_box<Tiles, C::STREAM_B>(
                                st + C::NA * C::A_BYTES + b * C::B_BYTES + c * C::B_BOX,
                                bmap[b], &full[s], tn * C::TILE_N + 64 * c, kt * BK, e);
                }
            }
        }
    } else {
        if constexpr (C::CONSUMERS > 1) hopper::reg_alloc<232>();
        const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32;
        float acc[C::NB][C::ACC];
        int it = 0;                            // stages consumed, over all tiles
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            int e, tm, tn;
            tl.at(tile, e, tm, tn);
#pragma unroll
            for (int b = 0; b < C::NB; ++b)
#pragma unroll
                for (int i = 0; i < C::ACC; ++i) acc[b][i] = 0.f;
            for (int kt = 0; kt < ktiles; ++kt, ++it) {
                const int s = it % C::STAGES;
                hopper::mbar_wait(&full[s], (it / C::STAGES) & 1);
                const unsigned char* st = ring + s * C::STAGE_BYTES;
                const uint64_t da = hopper::desc(st + cw * 64 * 128, 16, 1024);
#pragma unroll
                for (int b = 0; b < C::NB; ++b) hopper::fence_regs(acc[b]);
                hopper::wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
                    for (int b = 0; b < C::NB; ++b) {
                        // k16 steps: 32 bytes along A's rows, 16 rows (2048 bytes) down B
                        const uint64_t db = hopper::desc(
                            st + C::NA * C::A_BYTES + b * C::B_BYTES, C::B_BOX, 1024);
#pragma unroll
                        for (int a = 0; a < C::NA; ++a)
                            hopper::wgmma_ss<1>(acc[b],
                                                da + hopper::desc_offset(a * C::A_BYTES + kk * 32),
                                                db + hopper::desc_offset(kk * 2048), 1);
                    }
                hopper::wgmma_commit();
#pragma unroll
                for (int b = 0; b < C::NB; ++b) hopper::fence_regs(acc[b]);
                hopper::wgmma_wait<1>();      // the stage before this one is read
                if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % C::STAGES]);
            }
            hopper::wgmma_wait<0>();
#pragma unroll
            for (int b = 0; b < C::NB; ++b) hopper::fence_regs(acc[b]);
            if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % C::STAGES]);
            unsigned char* out = epi_smem + cw * C::EPI_BYTES;
            if constexpr (Tiles::GROUPED)
                epi(acc, tm * C::TILE_M + cw * 64, tn * C::TILE_N, t, out, e);
            else
                epi(acc, tm * C::TILE_M + cw * 64, tn * C::TILE_N, t, out);
        }
        if (C::EPI_BYTES > 0 && t == 0) hopper::bulk_wait_read();
    }
}

// The block's tiles of A (M x K) @ B_b (K x Ncols), each followed by epi
// (DenseTiles, one A plane).
template <class C, class Epi>
__device__ __forceinline__ void run(const CUtensorMap* amap,
                                    const CUtensorMap* const (&bmap)[C::NB], int M, int K,
                                    int Ncols, const Epi& epi) {
    static_assert(C::NA == 1, "one A plane");
    run_tiles<C>(DenseTiles{cdiv(M, C::TILE_M), cdiv(Ncols, C::TILE_N)}, {amap}, bmap, K, epi);
}

// The maps of a row-major bf16 (rows, cols) matrix for this tile: A's box
// is 64 columns (of K) by box_rows rows; B's 64 columns by 64 rows (of K).
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rows, int cols,
                            int box_rows) {
    const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
    const uint64_t strides[1] = {(uint64_t)cols * 2};
    const uint32_t box[2] = {64, (uint32_t)box_rows};
    return hopper::make_map(map, base, 2, dims, strides, box);
}

// The same for each of E stacked row-major (rows, cols) matrices, as one
// 3-D map whose zero fill stops at each matrix's edge.
inline cudaError_t make_map_3d(CUtensorMap* map, const void* base, int E, int rows, int cols,
                               int box_rows) {
    const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)E};
    const uint64_t strides[2] = {(uint64_t)cols * 2, (uint64_t)rows * cols * 2};
    const uint32_t box[3] = {64, (uint32_t)box_rows, 1};
    return hopper::make_map(map, base, 3, dims, strides, box);
}

// Columns of a 128-row tile over an (M, Ncols) output on `sms` SMs: of
// `widths`, the one whose waves of tiles over the SMs times the width are
// fewest, the earlier in `widths` on a tie, so that a few row tiles do not
// leave most of a last wave idle.
inline int gemm_cols(int M, int Ncols, int sms, std::initializer_list<int> widths) {
    const long long tm = cdiv(M, 128);
    const auto cost = [&](int bn) { return (tm * cdiv(Ncols, bn) + sms - 1) / sms * bn; };
    int best = *widths.begin();
    for (const int bn : widths)
        if (cost(bn) < cost(best)) best = bn;
    return best;
}

// Launch `kernel` (whose body is run_tiles<C>) on `stream` as a persistent
// grid of as many blocks as are resident on the current card at once
// (C::MIN_BLOCKS an SM), or one a tile where there are at most `tiles`.
template <class C, class... Params, class... Args>
cudaError_t launch_persistent(void (*kernel)(Params...), long long tiles, cudaStream_t stream,
                              Args... args) {
    const int sms = hopper::sm_count();
    if (sms <= 0) return cudaErrorInvalidDevice;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    const long long most = (long long)sms * C::MIN_BLOCKS;
    const int blocks = static_cast<int>(tiles < most ? tiles : most);
    kernel<<<blocks, C::THREADS, C::SMEM, stream>>>(args...);
    return cudaGetLastError();
}

// The same over an (M, Ncols) output (whose body is run<C>).
template <class C, class... Params, class... Args>
cudaError_t launch(void (*kernel)(Params...), int M, int Ncols, cudaStream_t stream,
                   Args... args) {
    return launch_persistent<C>(kernel, (long long)cdiv(M, C::TILE_M) * cdiv(Ncols, C::TILE_N),
                                stream, args...);
}

}  // namespace tma_gemm
