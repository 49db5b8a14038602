// The tiling the bf16 flash kernels share (csrc/flash_attention.cu, the
// forward; csrc/flash_attention_bwd.cu, dQ and dK/dV): which keys a block of
// query rows sees and which queries a block of keys is seen by, the order of
// the query-row work items, which tiles take the mask, and the TMA tensor
// maps over the model's (B, S, H, hd) layout.  kernels/flash_attention.py
// mirrors the host-side choices (chunk_pairs, work_order, key_tiles,
// edge_tile, dkv_work_order, query_tiles, dkv_edge_tile); the C entries
// flash_fwd_chunk, flash_bwd_item and flash_bwd_edge report them.
//
// The mask functions take any parameter struct with the fields Sq, Skv,
// causal, window (<= 0: none) and q_offset: query row q (position
// q + q_offset) sees key k iff q < Sq, k < Skv, k <= q + q_offset when
// causal, and q + q_offset - k < window when windowed.
#pragma once

#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int BOX = 64;         // columns of a TMA box: 128 bytes, the swizzle's span
constexpr int WG_ROWS = 64;     // rows of a consumer warpgroup's wgmma tile
// the (b, h) pairs of a chunk of the query-item order should keep their K
// and V (bf16) within this many bytes, a third of the H100's 50 MB L2; K and
// V are loaded with an evict-last hint, Q with evict-first
constexpr long long L2_CHUNK_BYTES = 16ll << 20;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Key range [lo, hi) that the query rows [q0, q1) can see.
template <class P>
__host__ __device__ inline void key_range(const P& p, int q0, int q1, int& lo, int& hi) {
    lo = 0;
    hi = p.Skv;
    if (p.causal) hi = imin(hi, q1 - 1 + p.q_offset + 1);
    if (p.window > 0) lo = imax(0, q0 + p.q_offset - p.window + 1);
}

// Query range [lo, hi) that can see some key of [k0, k1).
template <class P>
__host__ __device__ inline void query_range(const P& p, int k0, int k1, int& lo, int& hi) {
    lo = 0;
    hi = p.Sq;
    if (p.causal) lo = imax(0, k0 - p.q_offset);
    if (p.window > 0) hi = imin(hi, imax(0, k1 - 1 + p.window - p.q_offset));
}

// Whether the warpgroup of query rows [r_lo, r_lo + 64) masks key tile
// [k0, k0 + bn): the tile crosses the Skv edge, the causal diagonal or the
// window's start.  Other tiles hold only visible pairs (rows past Sq aside,
// which are never stored) and skip the mask.
template <class P>
__host__ __device__ inline bool rows_edge(const P& p, int r_lo, int k0, int bn) {
    const int r_hi = imax(imin(r_lo + WG_ROWS, p.Sq), r_lo + 1);
    return k0 + bn > p.Skv || (p.causal && k0 + bn - 1 > r_lo + p.q_offset)
           || (p.window > 0 && k0 <= r_hi - 1 + p.q_offset - p.window);
}

// Whether the warpgroup of keys [kw, kw + 64) masks query tile
// [q0, q0 + 64): the tile crosses the Sq or Skv edge, the causal diagonal or
// the window's end.
template <class P>
__host__ __device__ inline bool keys_edge(const P& p, int kw, int q0) {
    return q0 + WG_ROWS > p.Sq || kw + WG_ROWS > p.Skv
           || (p.causal && kw + WG_ROWS - 1 > q0 + p.q_offset)
           || (p.window > 0 && q0 + WG_ROWS - 1 + p.q_offset - kw >= p.window);
}

// The keys [klo, khi] that query position qpos sees, as offsets from kbase.
template <class P>
__device__ __forceinline__ void row_keys(const P& p, int qpos, int kbase, int& klo, int& khi) {
    khi = (p.causal ? imin(qpos, p.Skv - 1) : p.Skv - 1) - kbase;
    klo = (p.window > 0 ? qpos - p.window + 1 : INT_MIN / 2) - kbase;
}

// The query rows [qlo, qhi] that see key kpos, as offsets from qbase.
template <class P>
__device__ __forceinline__ void key_queries(const P& p, int kpos, int qbase, int& qlo,
                                            int& qhi) {
    qlo = (p.causal ? kpos - p.q_offset : INT_MIN / 2) - qbase;
    qhi = imin(p.Sq - 1, p.window > 0 ? kpos - p.q_offset + p.window - 1 : INT_MAX / 2);
    qhi = (kpos < p.Skv ? qhi : INT_MIN / 2) - qbase;
}

// (b, h) pairs per chunk of the query-item order: as many whole GQA groups
// as keep their K and V within L2_CHUNK_BYTES, spread evenly over the chunks.
inline int chunk_pairs(int B, int Hq, int Hkv, int Skv, int hd) {
    const int G = Hq / Hkv, pairs = B * Hq;
    const long long group_bytes = 2ll * Skv * pad16(hd) * 2;   // K and V of one KV head
    long long groups = L2_CHUNK_BYTES / (group_bytes > 0 ? group_bytes : 1);
    if (groups < 1) groups = 1;
    const long long most = groups * G;
    if (most >= pairs) return pairs;
    const int chunks = (int)((pairs + most - 1) / most);
    const int per = (pairs + chunks - 1) / chunks;
    return (per + G - 1) / G * G;
}

// A query-row item: `bm` rows from q0 of one (b, h).
struct QItem {
    int q0, h, b;
};

// Query-row items in order (the forward's and the dQ kernel's): the (b, h)
// pairs (b-major) in chunks of `chunk`, whose K and V stay in the L2 while
// the chunk runs; within a chunk, query tile by query tile (causal: the
// last, longest tile first), pair by pair.
__host__ __device__ inline QItem q_item(int item, int B, int Hq, int Sq, int chunk, int causal,
                                        int bm) {
    const int nq = cdiv(Sq, bm), pairs = B * Hq;
    const int first = item / (chunk * nq) * chunk;
    const int size = imin(chunk, pairs - first);
    const int r = item - first * nq;
    const int qi = r / size, pair = first + r % size;
    return {(causal ? nq - 1 - qi : qi) * bm, pair % Hq, pair / Hq};
}

// A tensor map over one of q, k, v, o and their gradients in (B, S, H, hd)
// with element strides (batch, seq, head): dims (hd, H, S, B), boxes of 64
// columns x `rows`.
inline cudaError_t head_map(CUtensorMap* map, const void* base, int hd, int H, int S, int B,
                            long long sb, long long ss, long long sh, int rows) {
    const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)H, (uint64_t)(S > 0 ? S : 1),
                              (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)sh * 2, (uint64_t)ss * 2, (uint64_t)sb * 2};
    const uint32_t box[4] = {(uint32_t)BOX, 1, (uint32_t)rows, 1};
    return hopper::make_map(map, base, 4, dims, strides, box);
}

// The wgmma A operand (registers) of k16 step kk for warp `warp`'s 16 rows
// of the warpgroup rows from row0 (a multiple of 8) of a 128B-swizzled
// tile of 64-column boxes of box_bytes each.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const unsigned char* tile,
                                       int box_bytes, int row0, int kk, int warp, int lane) {
    const int m = lane / 8;                               // ldmatrix's matrix: rows, then k
    const int row = row0 + 16 * warp + (m % 2) * 8 + lane % 8;
    const int chunk = (kk % 4) * 2 + m / 2;               // 16-byte chunk of the 128-byte row
    hopper::ldmatrix_x4(a, tile + (kk / 4) * box_bytes + row * 128 + ((chunk ^ (row % 8)) * 16));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// A warpgroup's 64 x hd accumulator (wgmma's layout: this thread's rows
// rw and rw + 8, each times its scale) in bf16 into the warpgroup's staging
// rows: 64-column boxes of 128-byte swizzled rows, as TMA stores them.
template <int HD>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const float (&acc)[HD / 2],
                                           const float (&scale)[2], int lane, int rw) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = rw + 8 * r;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
            const int chunk = j % 8;                   // 16-byte chunk of a 128-byte row
            unsigned char* d = dst + (j / 8) * (WG_ROWS * 128) + row * 128
                               + ((chunk ^ (row % 8)) * 16) + 4 * (lane % 4);
            *reinterpret_cast<uint32_t*>(d) =
                pack_bf16(acc[4 * j + 2 * r] * scale[r], acc[4 * j + 2 * r + 1] * scale[r]);
        }
    }
}

}  // namespace flash
