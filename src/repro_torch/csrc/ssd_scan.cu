// Mamba-2 chunked SSD scan and fused single-token mamba decode for Hopper.
//
// Replaces: repro/kernels/ssd_scan.py:_scan_kernel (via _fwd_pallas) and
//   repro/kernels/ssd_scan.py:_decode_kernel (via mamba_decode_step).
//
// ssd_scan_fwd: x (B, T, H, P), dt (B, T, H) fp32, B/C (B, T, N), A_log (H,)
//   fp32 -> y (B, T, H, P) in x's dtype and the final state (B, H, P, N)
//   fp32, zero initial state, T in chunks of Q (a power of two <= 128 that
//   divides T).  Per chunk c, with logA = -exp(A_log), cum the inclusive
//   cumsum of dt*logA over the chunk and total its last entry:
//     W[i][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   (j <= i, else 0)
//     y_i     = sum_j W[i][j] x_j + (C_i . S_{c-1}) * exp(cum_i)
//     S_c     = exp(total) S_{c-1} + D_c,  D_c = sum_j x_j (dt_j exp(total - cum_j)) B_j^T
//   all in fp32 as the reference's chunk body, S_{-1} = 0.
// Design (Q >= 16): chunk-parallel, in three kernels; every block issues all
// of its loads at once (registers or cp.async) before its first barrier.
//   1. ssd_scan_state_kernel, one block per (b, h, chunk): D_c and
//      exp(total_c), which do not depend on the carried state, into a
//      scratch of B H (T/Q) (N P + 1) floats (D_c as [n][p]).  In bf16 D_c
//      runs on the tensor cores: B^T (bf16, exact) times the fp32 x dt e^..
//      split exactly into three bf16 planes (8 bits each: hi + mid + lo),
//      mma.sync m16n8k16 with fp32 sums, both operands through
//      ldmatrix.trans from XOR-swizzled rows; in fp32 by FFMA.
//   2. ssd_scan_pass_kernel: the carry in chunk order, parallel over the
//      N P state entries of each (b, h) (a float4 a thread, DEPTH chunks'
//      D and exp(total) in flight): S_c = exp(total_c) S_{c-1} + D_c, each
//      S_{c-1} written over D_c once D_c is read, the final state out.
//   3. the read-out, one block of 2Q threads per (b, h, chunk):
//      y = exp(cum) (C S_{c-1}) + W x.  Every load is issued at once (C, B
//      and x rows 16 threads a row, coalesced; S_{c-1}).
//      bf16, ssd_scan_out_tc_kernel: every product on the tensor cores
//      (mma.sync m16n8k16, fp32 sums) from XOR-swizzled bf16 rows: C S with
//      S_{c-1} split exactly into three bf16 planes (split3: 8 bits each),
//      then C B^T over its lower-triangular 16 x 8 tiles (mma_tile: listed
//      strip by strip, dealt to the warps in turn), masked before exp (a
//      future position's gap is never exponentiated) and written as three
//      planes of W packed by 16-row strip over C, B and S; then W x over
//      each strip's j < 16 (s + 1).  Warp w takes strips a and NW-1-a by
//      half the P columns, so the triangle's work is even; C S and W x add
//      in registers.  ~78 KB of shared memory at Q = 128: two blocks an SM.
//      fp32, ssd_scan_out_kernel: register-tiled FFMA (4 x 4 tiles, float4
//      shared loads): C S by 4-row tiles; C B^T over its lower-triangular
//      4 x 4 tiles (tri_tile: each warp a 16 x 32 patch) in registers
//      until every read of C and B is done, then W^T over them; x takes
//      S's place and W x runs over row tiles paired top and bottom (rows
//      4a.. and Q-4-4a..), so every thread sums Q + 4 terms of j.
//   Blocks are numbered with the head fastest (chunk_item), so the blocks
//   in flight together share B and C rows in the L2.
// Small chunks (Q <= 8, chunk 1 included): ssd_scan_small_kernel walks the
//   tokens with the same algebra, chunk by chunk.  A block of 128 threads
//   takes 16 state rows p of one (b, h) (grid B H P/16); 8 threads share a
//   row, 8 state columns n each, in registers.  It stages 32 tokens of x, B,
//   C and dt at a time (the next window's loads in flight while this one
//   runs: none of them depends on the state), forms each chunk's cumsum,
//   exp(cum), dt exp(total - cum) and in-chunk W once per window, then walks
//   the tokens with no barrier: C_i . S by 8 FMAs and three shuffles, the
//   in-chunk terms, D += x_i (dt e^..)_i B_i; at the chunk's end
//   S = exp(total) S + D.
// Every sum runs in a fixed order, with no atomics: repeated launches are
//   bit-identical.
// Bound on the H100: bytes.  The function reads x, B, C and dt once and
//   writes y and the state once: 178 MB for zamba2's train microbatch
//   (4 x 2048, 80 heads, bf16), 0.053 ms at 3.35 TB/s.  Its products at the
//   fastest exact rate: C B^T (bf16 x bf16, shared by the heads) once per
//   (b, chunk) at 989 TFLOP/s, and W x, D_c and C S, each with an fp32
//   operand, per head as three bf16 products: 48.5 GFLOP, 0.049 ms.  This
//   design moves more: a second read of x and its chunk states (D_c written
//   and read, S_{c-1} written and read: 4 x 84 MB), ~0.61 GB, 0.18 ms; its
//   tensor-core work (C B^T per head too) 54 GFLOP, 0.05 ms.  In fp32 on
//   FFMA the algebra's 21.6 GFLOP take 0.32 ms at 67 TFLOP/s.
//
// mamba_decode_fwd: window (B, K, ch), conv_w (K, ch), conv_b (ch,) in one
//   dtype; dt_raw (B, H) (any row stride), dt_bias, A_log, D (H,) in one
//   dtype (read in fp32); the state (B, H, P, N) fp32 and a per-slot active
//   flag -> y (B, H, P) fp32 for every slot, and the new state of the
//   active slots, written over the old one in place (state_out == state)
//   or into a buffer apart; an inactive slot's rows are never written.
//   conv -> silu in the window's dtype (the product rounded, the bias add
//   rounded, silu rounded: the reference's dtype chain), then
//   dt = softplus(dt_raw + dt_bias), S' = exp(-dt e^{A_log}) S + dt x B^T,
//   y = S' C + D x in fp32.  In place, the layer's one launch replaces the
//   fresh state and the masked copy into the cache after it (the
//   reference's _freeze_inactive), which moved the state five times more.
// Bound on the H100: bytes.  The state is read and written once (2 P N fp32
//   per head and slot: 10.5 MB at zamba2's 4 slots, 0.0031 ms at 3.35
//   TB/s); everything else is a few KB.  At that size the cost is latency,
//   so no load waits on another: each thread issues its state loads first
//   (16 bytes each, streaming), then its conv channel's K taps and bias
//   (K a template parameter) and the head's dt, A_log and D, all in
//   flight at once; one barrier; the update.
// Design: one block of 256 threads per (b, h) (320 blocks at 4 slots, all
//   resident: 5.2 MB of loads in flight).  Threads 0..P+2N-1 each run the
//   K-tap conv of one channel (the head's P x channels and the 2N B and C
//   channels every head shares, which each block recomputes: cheap) into
//   shared memory.  Thread t holds float4 t + 256 q (q < 4) of the (b, h)
//   slab: 16 threads a row, so each warp instruction reads and writes 512
//   contiguous bytes (the parent's 4 threads a row, 16 values each, read at
//   a 64-byte stride and used half of each sector a load touched; with its
//   loads issued first that layout ran no faster than the parent on an
//   H100); it updates its values,
//   stores them (streaming) and reduces y_p over the row's 16 lanes by a
//   butterfly in a fixed order: repeated launches are bit-identical.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int HP = 64, HN = 64;      // the (P, N) the kernels are built for
constexpr int Q_MAX = 128;
constexpr int SMALL_Q = 8;           // chunks up to this take the token walk
constexpr int WINDOW = 32;           // tokens the token walk stages at once
constexpr int SMALL_ROWS = 16;       // state rows p of a token-walk block
constexpr int SMALL_PARTS = 8;       // threads sharing a row, HN / 8 columns each
constexpr int SMALL_THREADS = SMALL_ROWS * SMALL_PARTS;
constexpr int NCOL = HN / SMALL_PARTS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int DEPTH = 4;             // chunks whose states the carry loads at once
constexpr int DECODE_K = 4;          // the decode step's conv taps (zamba2's conv_kernel)

struct ScanParams {
    const void* x;
    const float* dt;
    const void* bm;
    const void* cm;
    const float* A_log;
    void* y;
    float* state;
    float* delta;                    // B H nc chunk states [n][p]
    float* etot;                     // B H nc exp(total)
    int B, T, H, Q, nc;
    long long x_sb, x_st, x_sh;      // element strides of x (unit on P)
    long long dt_sb, dt_st, dt_sh;   // of dt
    long long b_sb, b_st;            // of B (unit on N)
    long long c_sb, c_st;            // of C (unit on N)
};

__device__ __forceinline__ void unpack(const float4 v, float (&a)[4]) {
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}

__device__ __forceinline__ void unpack8(const float* src, float (&a)[8]) {
    const float4 u = *reinterpret_cast<const float4*>(src);
    const float4 v = *reinterpret_cast<const float4*>(src + 4);
    a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
    a[4] = v.x; a[5] = v.y; a[6] = v.z; a[7] = v.w;
}

// four consecutive elements: the raw load (in flight until first use), then
// fp32; and four fp32 values stored in the output's dtype
__device__ __forceinline__ float4 ldraw(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 ldraw(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 to4(const float4 v) { return v; }
__device__ __forceinline__ float4 to4(const uint2 u) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
}
template <typename T>
__device__ __forceinline__ float4 ld4(const T* p) { return to4(ldraw(p)); }
__device__ __forceinline__ void st4(float* p, const float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float4 v) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&a);
    u.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
}
template <typename T> struct Raw;
template <> struct Raw<float> { using type = float4; };
template <> struct Raw<__nv_bfloat16> { using type = uint2; };

// 16 bytes from device to shared memory, asynchronously (no registers); the
// block's copies are complete after cp_async_wait
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(hopper::smem_u32(smem)), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// ---- the work division (the kernels and the plan entries share these) ----

// block -> (b, h, chunk) of the chunk kernels, the head fastest
struct Item { int b, h, c; };
__host__ __device__ inline Item chunk_item(int block, int H, int nc) {
    return {block / (H * nc), block % H, (block / H) % nc};
}

// C B^T's lower-triangular 4 x 4 tiles (tile column <= tile row) come in
// patches of 4 tile rows x 8 tile columns, listed row-major over the patches
// that hold one; warp w of NW takes patches w, w + NW, ...; lane l takes tile
// (4 si + l / 8, 8 sj + l % 8) of its patch when that tile is on or below
// the diagonal.
__host__ __device__ constexpr int tri_patches(int Q) {
    int n = 0;
    for (int si = 0; si < Q / 16; ++si) n += (4 * si + 3) / 8 + 1;
    return n;
}
__host__ __device__ inline void tri_patch(int k, int& si, int& sj) {
    si = 0;
    while (k >= (4 * si + 3) / 8 + 1) k -= (4 * si + 3) / 8 + 1, ++si;
    sj = k;
}
// the tile (ti, tj) of warp w's round rd; false when it lies above the
// diagonal or past the list
__host__ __device__ inline bool tri_tile(int Q, int rd, int w, int lane, int& ti, int& tj) {
    const int k = rd * (Q / 16) + w;
    if (k >= tri_patches(Q)) return false;
    int si, sj;
    tri_patch(k, si, sj);
    ti = 4 * si + lane / 8;
    tj = 8 * sj + lane % 8;
    return tj <= ti;
}

// bf16: C B^T on the tensor cores (mma.sync m16n8k16, fp32 sums), over its
// lower-triangular 16 x 8 tiles: strip s (rows 16 s..16 s+15) has tiles
// jt = 0..2 s + 1; the tiles are listed strip by strip and warp w of Q/16
// takes tiles w, w + Q/16, ...
__host__ __device__ constexpr int mma_tiles(int Q) { return Q / 16 * (Q / 16 + 1); }
__host__ __device__ inline void mma_tile(int k, int& s, int& jt) {
    s = 0;
    while (k >= 2 * s + 2) k -= 2 * s + 2, ++s;
    jt = k;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(hopper::smem_u32(p))
                 : "memory");
}

// a bf16 [rows][64] tile with its 16-byte chunks XOR-swizzled by row % 8,
// so ldmatrix's eight rows of one chunk hit eight bank groups: the offset
// of element (row, col), col a multiple of 4 within the row
__device__ __forceinline__ int swz(int row, int col) {
    return row * 64 + (((col >> 3) ^ (row & 7)) << 3) + (col & 7);
}

// v = hi + mid + lo exactly in three bf16 planes (fp32's 24 bits, 8 a plane)
__device__ __forceinline__ void split3(float v, __nv_bfloat16& hi, __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
    hi = __float2bfloat16(v);
    v -= __bfloat162float(hi);
    mid = __float2bfloat16(v);
    lo = __float2bfloat16(v - __bfloat162float(mid));
}

// the four values of v as three bf16 planes (split3), each four bf16 at
// plane * h + off
__device__ __forceinline__ void store_planes(__nv_bfloat16* base, int plane, int off,
                                             const float4 v) {
    const float a[4] = {v.x, v.y, v.z, v.w};
    __nv_bfloat162 pl[3][2];
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
        __nv_bfloat16 h0[3], h1[3];
        split3(a[e], h0[0], h0[1], h0[2]);
        split3(a[e + 1], h1[0], h1[1], h1[2]);
#pragma unroll
        for (int h = 0; h < 3; ++h) pl[h][e / 2] = __halves2bfloat162(h0[h], h1[h]);
    }
#pragma unroll
    for (int h = 0; h < 3; ++h) {
        uint2 u;
        u.x = *reinterpret_cast<const uint32_t*>(&pl[h][0]);
        u.y = *reinterpret_cast<const uint32_t*>(&pl[h][1]);
        *reinterpret_cast<uint2*>(&base[h * plane + off]) = u;
    }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
                 "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// inclusive cumsum of dt*logA over the Q rows of a chunk by one warp: lane
// l sums a run of ceil(Q/32) consecutive rows, a warp scan adds the runs
// before it.  Writes cum and, where given, dt exp(total - cum) and exp(cum).
template <int Q>
__device__ __forceinline__ void chunk_cumsum(const float* dts, float logA, float* cum,
                                             float* wdec, float* ecum, int lane) {
    constexpr int R = (Q + 31) / 32;
    float loc[R];
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int j = lane * R + r;
        if (j < Q) s += dts[j] * logA;
        loc[r] = s;
    }
    float incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
    }
    const float total = __shfl_sync(FULL, incl, 31);
    const float off = incl - s;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int j = lane * R + r;
        if (j < Q) {
            const float c = off + loc[r];
            cum[j] = c;
            if (wdec) wdec[j] = dts[j] * expf(total - c);
            if (ecum) ecum[j] = expf(c);
        }
    }
}

// fp32: x (then x dt e^..) and B rows in fp32; bf16, in the same room: B
// rows and x dt e^.. as three bf16 planes, all [Q][64] swizzled
template <int Q>
constexpr size_t state_smem_floats() { return (size_t)2 * Q * HP + 3 * Q; }

// 1. D_c = sum_j (x_j dt_j e^{total - cum_j}) B_j^T as [n][p], and e^{total}.
// bf16: on the tensor cores (mma.sync m16n8k16, fp32 sums) as B^T times the
// three bf16 planes of the fp32 x dt e^.. (exact: products exact, sums fp32);
// fp32: register-tiled FFMA.
template <typename T, int Q>
__global__ void __launch_bounds__(THREADS) ssd_scan_state_kernel(const ScanParams p) {
    constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
    extern __shared__ float4 smem4[];
    float* Xs = reinterpret_cast<float*>(smem4);   // [Q][P]: x_j, then x_j dt_j e^..
    float* Bs = Xs + Q * HP;                       // [Q][N]
    __nv_bfloat16* Bb = reinterpret_cast<__nv_bfloat16*>(Xs);   // [Q][N] swizzled
    __nv_bfloat16* Xp = Bb + Q * HN;                            // 3 x [Q][P] swizzled
    float* dts = Bs + Q * HN;
    float* cum = dts + Q;
    float* wdec = cum + Q;
    const Item it = chunk_item(blockIdx.x, p.H, p.nc);
    const int tid = threadIdx.x;
    const long long t0 = (long long)it.c * Q;
    const T* xb = static_cast<const T*>(p.x) + it.b * p.x_sb + it.h * p.x_sh + t0 * p.x_st;
    const T* bb = static_cast<const T*>(p.bm) + it.b * p.b_sb + t0 * p.b_st;
    const float* dtb = p.dt + it.b * p.dt_sb + it.h * p.dt_sh + t0 * p.dt_st;

    // every load in flight at once, then into shared memory
    constexpr int SV = Q * HP / 4 / THREADS;
    typename Raw<T>::type xr[SV], br[SV];
#pragma unroll
    for (int k = 0; k < SV; ++k) {
        const int i = tid + k * THREADS, j = i / (HP / 4), q = 4 * (i % (HP / 4));
        xr[k] = ldraw(xb + j * p.x_st + q);
        br[k] = ldraw(bb + j * p.b_st + q);
    }
    const float dtr = tid < Q ? dtb[tid * p.dt_st] : 0.f;
    const size_t slot = ((size_t)it.b * p.H + it.h) * p.nc + it.c;
    float* d = p.delta + slot * HN * HP;
    if constexpr (TC) {
#pragma unroll
        for (int k = 0; k < SV; ++k) {
            const int i = tid + k * THREADS, j = i / (HP / 4), q = 4 * (i % (HP / 4));
            *reinterpret_cast<uint2*>(&Bb[swz(j, q)]) = br[k];
        }
        if (tid < Q) dts[tid] = dtr;
        __syncthreads();
        if (tid < 32) chunk_cumsum<Q>(dts, -expf(p.A_log[it.h]), cum, wdec, nullptr, tid);
        __syncthreads();
        // each thread splits the x it loaded, times dt e^.., into the planes
#pragma unroll
        for (int k = 0; k < SV; ++k) {
            const int i = tid + k * THREADS, j = i / (HP / 4), q = 4 * (i % (HP / 4));
            const float4 xv = to4(xr[k]);
            const float wj = wdec[j];
            store_planes(Xp, Q * HP, swz(j, q),
                         make_float4(xv.x * wj, xv.y * wj, xv.z * wj, xv.w * wj));
        }
        __syncthreads();
        // warp w: rows n 16 (w / 2).. of D, columns p 32 (w % 2)..; A = B^T and
        // the planes through ldmatrix.trans, the small planes first
        const int warp = tid / 32, lane = tid % 32, st = warp / 2, nt0 = 4 * (warp % 2);
        float c[4][4] = {};
        for (int j0 = 0; j0 < Q; j0 += 16) {
            uint32_t a[4];
            ldmatrix_x4_trans(a, &Bb[swz(j0 + lane % 8 + 8 * (lane / 16),
                                         16 * st + 8 * ((lane / 8) % 2))]);
#pragma unroll
            for (int h = 2; h >= 0; --h)
#pragma unroll
                for (int pair = 0; pair < 2; ++pair) {
                    uint32_t b[4];
                    const int row = j0 + lane % 8 + 8 * ((lane / 8) % 2);
                    ldmatrix_x4_trans(b, &Xp[h * Q * HP
                                             + swz(row, 8 * (nt0 + 2 * pair + lane / 16))]);
                    mma_bf16(c[2 * pair], a, b[0], b[1]);
                    mma_bf16(c[2 * pair + 1], a, b[2], b[3]);
                }
        }
        const int g = lane / 4, t2 = 2 * (lane % 4);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half)
                *reinterpret_cast<float2*>(&d[(16 * st + g + 8 * half) * HP + 8 * (nt0 + nt)
                                              + t2]) = make_float2(c[nt][2 * half],
                                                                   c[nt][2 * half + 1]);
    } else {
#pragma unroll
        for (int k = 0; k < SV; ++k) {
            const int i = tid + k * THREADS, j = i / (HP / 4), q = 4 * (i % (HP / 4));
            st4(&Xs[j * HP + q], to4(xr[k]));
            st4(&Bs[j * HN + q], to4(br[k]));
        }
        if (tid < Q) dts[tid] = dtr;
        __syncthreads();
        if (tid < 32) chunk_cumsum<Q>(dts, -expf(p.A_log[it.h]), cum, wdec, nullptr, tid);
        __syncthreads();
        for (int i = tid; i < Q * HP; i += THREADS) Xs[i] *= wdec[i / HP];
        __syncthreads();

        const int tn = tid / (HP / 4), tp = tid % (HP / 4);   // 4 x 4 tile of [n][p]
        float acc[4][4] = {};
#pragma unroll 4
        for (int j = 0; j < Q; ++j) {
            float bv[4], xv[4];
            unpack(*reinterpret_cast<const float4*>(&Bs[j * HN + 4 * tn]), bv);
            unpack(*reinterpret_cast<const float4*>(&Xs[j * HP + 4 * tp]), xv);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(bv[r], xv[s], acc[r][s]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
            st4(&d[(4 * tn + r) * HP + 4 * tp],
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
    }
    if (tid == 0) p.etot[slot] = expf(cum[Q - 1]);
}

// 2. the carry: S_c = e^{total_c} S_{c-1} + D_c in chunk order; S_{c-1}
// over D_c; the final state (B, H, P, N) out.  Block bh * 4 + quarter,
// thread: one float4 of the [n][p] entries.  The loads of DEPTH chunks
// (D and e^{total}) are in flight together: none depends on the carry.
__global__ void __launch_bounds__(THREADS) ssd_scan_pass_kernel(const ScanParams p) {
    constexpr int V4 = HN * HP / 4;
    const size_t bh = blockIdx.x / 4;
    const int e = (blockIdx.x % 4) * THREADS + threadIdx.x;
    float4* d = reinterpret_cast<float4*>(p.delta) + bh * p.nc * V4 + e;
    const float* et = p.etot + bh * p.nc;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 dn[DEPTH];
    float en[DEPTH];
#pragma unroll
    for (int j = 0; j < DEPTH; ++j)
        if (j < p.nc) dn[j] = d[(size_t)j * V4], en[j] = et[j];
    for (int c0 = 0; c0 < p.nc; c0 += DEPTH) {
        float4 dc[DEPTH];
        float ec[DEPTH];
#pragma unroll
        for (int j = 0; j < DEPTH; ++j) dc[j] = dn[j], ec[j] = en[j];
#pragma unroll
        for (int j = 0; j < DEPTH; ++j) {               // the next batch, before any store
            const int c = c0 + DEPTH + j;
            if (c < p.nc) dn[j] = d[(size_t)c * V4], en[j] = et[c];
        }
#pragma unroll
        for (int j = 0; j < DEPTH; ++j) {
            const int c = c0 + j;
            if (c >= p.nc) break;
            d[(size_t)c * V4] = s;                      // the state entering chunk c
            s = make_float4(fmaf(ec[j], s.x, dc[j].x), fmaf(ec[j], s.y, dc[j].y),
                            fmaf(ec[j], s.z, dc[j].z), fmaf(ec[j], s.w, dc[j].w));
        }
    }
    const int n = e / (HP / 4), q = 4 * (e % (HP / 4));
    float* out = p.state + bh * HP * HN + n;
    out[(q + 0) * HN] = s.x;
    out[(q + 1) * HN] = s.y;
    out[(q + 2) * HN] = s.z;
    out[(q + 3) * HN] = s.w;
}

// fp32 read-out: C and B rows (pitch CP), with W^T over them
constexpr int CP = HN + 4;              // fp32 pitch of C and B: float4 rows, 4 banks apart
template <int Q>
__host__ __device__ constexpr int region_floats() {
    return 2 * Q * CP > Q * (Q + 4) ? 2 * Q * CP : Q * (Q + 4);
}

template <int Q>
constexpr size_t out_smem_floats() {
    return (size_t)region_floats<Q>() + (HN * HP > Q * HP ? HN * HP : Q * HP) + 3 * Q;
}

// 3, fp32. y = e^{cum} (C S_{c-1}) + W x by FFMA, one block of 2Q threads
// per chunk
template <int Q>
__global__ void __launch_bounds__(2 * Q, Q == Q_MAX ? 2 : 1)
ssd_scan_out_kernel(const ScanParams p) {
    constexpr int NT = 2 * Q;
    constexpr int QP = Q + 4;                        // pitch of the Q-indexed rows
    constexpr int NW = NT / 32;
    constexpr int ROUNDS = (tri_patches(Q) + NW - 1) / NW;
    extern __shared__ float4 smem4[];
    float* Cs = reinterpret_cast<float*>(smem4);   // [Q][CP]: C rows
    float* Bs = Cs + Q * CP;                       // [Q][CP]: B rows
    float* Wt = Cs;                                // [Q][QP] over them: Wt[j][i] = W[i][j]
    float* R2 = Cs + region_floats<Q>();           // S_{c-1} [n][p], then x [j][p]
    float* cum = R2 + (HN * HP > Q * HP ? HN * HP : Q * HP);
    float* ecum = cum + Q;
    float* dts = ecum + Q;
    const Item it = chunk_item(blockIdx.x, p.H, p.nc);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const long long t0 = (long long)it.c * Q;
    const float* xb = static_cast<const float*>(p.x) + it.b * p.x_sb + it.h * p.x_sh
                      + t0 * p.x_st;
    const float* bb = static_cast<const float*>(p.bm) + it.b * p.b_sb + t0 * p.b_st;
    const float* cb = static_cast<const float*>(p.cm) + it.b * p.c_sb + t0 * p.c_st;
    const float* dtb = p.dt + it.b * p.dt_sb + it.h * p.dt_sh + t0 * p.dt_st;
    const size_t slot = ((size_t)it.b * p.H + it.h) * p.nc + it.c;

    // every load in flight at once: C and B rows into registers (16 threads
    // a row: coalesced), S_{c-1} by cp.async
    constexpr int CV = Q * HN / 4 / NT;
    float4 cr[CV], br[CV];
#pragma unroll
    for (int k = 0; k < CV; ++k) {
        const int i = tid + k * NT, j = i / (HN / 4), n = 4 * (i % (HN / 4));
        cr[k] = ldraw(cb + j * p.c_st + n);
        br[k] = ldraw(bb + j * p.b_st + n);
    }
    const float* sp = p.delta + slot * HN * HP;
    for (int i = tid; i < HN * HP / 4; i += NT) cp_async16(&R2[4 * i], sp + 4 * i);
    const float dtr = tid < Q ? dtb[tid * p.dt_st] : 0.f;
#pragma unroll
    for (int k = 0; k < CV; ++k) {
        const int i = tid + k * NT, j = i / (HN / 4), n = 4 * (i % (HN / 4));
        st4(&Cs[j * CP + n], cr[k]);
        st4(&Bs[j * CP + n], br[k]);
    }
    if (tid < Q) dts[tid] = dtr;
    cp_async_wait();
    __syncthreads();
    if (warp == 0) chunk_cumsum<Q>(dts, -expf(p.A_log[it.h]), cum, nullptr, ecum, lane);

    // y's row tiles a and b = Q/4-1-a (4 rows each) by columns 4 tp..4 tp+3
    const int ra = tid / (HP / 4), rb = Q / 4 - 1 - ra, tp = tid % (HP / 4);
    float acc[2][4][4] = {};
    for (int n = 0; n < HN; n += 4) {                // C rows by 4 n, S rows n..n+3
        float ca[4][4], cc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            unpack(*reinterpret_cast<const float4*>(&Cs[(4 * ra + r) * CP + n]), ca[r]);
            unpack(*reinterpret_cast<const float4*>(&Cs[(4 * rb + r) * CP + n]), cc[r]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float sv[4];
            unpack(*reinterpret_cast<const float4*>(&R2[(n + e) * HP + 4 * tp]), sv);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    acc[0][r][c] = fmaf(ca[r][e], sv[c], acc[0][r][c]);
                    acc[1][r][c] = fmaf(cc[r][e], sv[c], acc[1][r][c]);
                }
        }
    }
    __syncthreads();                                 // cum, ecum written
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const float ea = ecum[4 * ra + r], eb = ecum[4 * rb + r];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            acc[0][r][s] *= ea;
            acc[1][r][s] *= eb;
        }
    }

    // W over the lower-triangular 4 x 4 tiles (tri_tile), in registers:
    // masked before exp, so a future position's gap is never exponentiated
    float g[ROUNDS][4][4];
#pragma unroll
    for (int rd = 0; rd < ROUNDS; ++rd) {
        int ti, tj;
        if (!tri_tile(Q, rd, warp, lane, ti, tj)) continue;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) g[rd][r][c] = 0.f;
        for (int n = 0; n < HN; n += 4) {            // C and B rows by 4 n
            float cv[4][4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
                unpack(*reinterpret_cast<const float4*>(&Cs[(4 * ti + r) * CP + n]), cv[r]);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                float bv[4];
                unpack(*reinterpret_cast<const float4*>(&Bs[(4 * tj + c) * CP + n]), bv);
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int e = 0; e < 4; ++e) g[rd][r][c] = fmaf(cv[r][e], bv[e], g[rd][r][c]);
            }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int i = 4 * ti + r, j = 4 * tj + c;
                float w = 0.f;
                if (j <= i) w = g[rd][r][c] * expf(cum[i] - cum[j]) * dts[j];
                g[rd][r][c] = w;
            }
    }
    __syncthreads();                                 // every read of C, B and S is done
#pragma unroll
    for (int rd = 0; rd < ROUNDS; ++rd) {
        int ti, tj;
        if (!tri_tile(Q, rd, warp, lane, ti, tj)) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c)
            st4(&Wt[(4 * tj + c) * QP + 4 * ti],
                make_float4(g[rd][0][c], g[rd][1][c], g[rd][2][c], g[rd][3][c]));
    }
    for (int i = tid; i < Q * HP / 4; i += NT) {
        const int j = i / (HP / 4), q = 4 * (i % (HP / 4));
        st4(&R2[j * HP + q], ld4(xb + j * p.x_st + q));
    }
    __syncthreads();

    // W x: tile a needs j < 4 ra + 4, tile b j < 4 rb + 4
    int j = 0;
#pragma unroll 2
    for (; j < 4 * ra + 4; ++j) {
        float wa[4], wb[4], xv[4];
        unpack(*reinterpret_cast<const float4*>(&Wt[j * QP + 4 * ra]), wa);
        unpack(*reinterpret_cast<const float4*>(&Wt[j * QP + 4 * rb]), wb);
        unpack(*reinterpret_cast<const float4*>(&R2[j * HP + 4 * tp]), xv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                acc[0][r][s] = fmaf(wa[r], xv[s], acc[0][r][s]);
                acc[1][r][s] = fmaf(wb[r], xv[s], acc[1][r][s]);
            }
    }
#pragma unroll 2
    for (; j < 4 * rb + 4; ++j) {
        float wb[4], xv[4];
        unpack(*reinterpret_cast<const float4*>(&Wt[j * QP + 4 * rb]), wb);
        unpack(*reinterpret_cast<const float4*>(&R2[j * HP + 4 * tp]), xv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s) acc[1][r][s] = fmaf(wb[r], xv[s], acc[1][r][s]);
    }

    float* yb = static_cast<float*>(p.y) + (((size_t)it.b * p.T + t0) * p.H + it.h) * HP
                + 4 * tp;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        st4(yb + (size_t)(4 * ra + r) * p.H * HP,
            make_float4(acc[0][r][0], acc[0][r][1], acc[0][r][2], acc[0][r][3]));
        st4(yb + (size_t)(4 * rb + r) * p.H * HP,
            make_float4(acc[1][r][0], acc[1][r][1], acc[1][r][2], acc[1][r][3]));
    }
}

// 3, bf16. y = e^{cum} (C S_{c-1}) + W x with every product on the tensor
// cores (mma.sync m16n8k16, fp32 sums): C and B (bf16 rows, exact), S_{c-1}
// and W (fp32, each split exactly into three bf16 planes) and x (bf16 rows,
// exact).  Warp w takes row strips a and NW-1-a (a = w mod NW/2) by half
// of the P columns (w / (NW/2)), so every warp sums NW + 1 strips of W x;
// one warp at Q = 16 takes the one strip whole.
template <int Q>
__host__ __device__ constexpr int wplane_bf16() {   // the three packed planes of W
    return 3 * (Q / 16) * 16 * 8 + 3 * 16 * 16 * (Q / 16) * (Q / 16 + 1) / 2;
}
template <int Q>
constexpr size_t out_tc_smem_bytes() {
    // C, B and the three planes of S (bf16), with the planes of W over them
    constexpr int first = 2 * Q * HN * 2 + 3 * HN * HP * 2;
    constexpr int wp = wplane_bf16<Q>() * 2;
    return (size_t)(first > wp ? first : wp) + (size_t)Q * HP * 2 + 3 * Q * 4;
}
// packed strip s of a W plane: 16 rows of 16 (s + 1) + 8 bf16 (the 8 keep
// ldmatrix's rows on distinct bank groups)
__device__ __forceinline__ int wstrip_base(int s) { return 16 * (8 * s * (s + 1) + 8 * s); }
__device__ __forceinline__ int wstrip_pitch(int s) { return 16 * (s + 1) + 8; }

template <int Q>
__global__ void __launch_bounds__(2 * Q, Q == Q_MAX ? 2 : 1)
ssd_scan_out_tc_kernel(const ScanParams p) {
    using T = __nv_bfloat16;
    constexpr int NT = 2 * Q, NW = NT / 32;
    constexpr int ROUNDS = (mma_tiles(Q) + NW - 1) / NW;
    constexpr int NS = NW >= 2 ? 2 : 1;            // strips a warp takes
    constexpr int NTL = 8 / NS;                    // n8 column tiles a warp takes
    constexpr int WP = wplane_bf16<Q>() / 3;       // bf16 of one W plane
    extern __shared__ float4 smem4[];
    T* Cb = reinterpret_cast<T*>(smem4);           // [Q][64] swizzled
    T* Bb = Cb + Q * HN;                           // [Q][64] swizzled
    T* Sp = Bb + Q * HN;                           // 3 x [N][P] swizzled
    T* Wp = Cb;                                    // 3 x packed strips, over them
    constexpr int first = 2 * Q * HN + 3 * HN * HP;
    T* Xb = Cb + (first > 3 * WP ? first : 3 * WP);   // [Q][P] swizzled
    float* cum = reinterpret_cast<float*>(Xb + Q * HP);
    float* ecum = cum + Q;
    float* dts = ecum + Q;
    const Item it = chunk_item(blockIdx.x, p.H, p.nc);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t2 = 2 * (lane % 4);
    const long long t0 = (long long)it.c * Q;
    const T* xb = static_cast<const T*>(p.x) + it.b * p.x_sb + it.h * p.x_sh + t0 * p.x_st;
    const T* bb = static_cast<const T*>(p.bm) + it.b * p.b_sb + t0 * p.b_st;
    const T* cb = static_cast<const T*>(p.cm) + it.b * p.c_sb + t0 * p.c_st;
    const float* dtb = p.dt + it.b * p.dt_sb + it.h * p.dt_sh + t0 * p.dt_st;
    const size_t slot = ((size_t)it.b * p.H + it.h) * p.nc + it.c;

    // every load in flight at once: C, B and x rows (16 threads a row), S
    constexpr int CV = Q * HN / 4 / NT, SV = HN * HP / 4 / NT;
    uint2 cr[CV], br[CV], xr[CV];
    float4 sr[SV <= 4 ? SV : 1];
#pragma unroll
    for (int k = 0; k < CV; ++k) {
        const int i = tid + k * NT, j = i / (HN / 4), n = 4 * (i % (HN / 4));
        cr[k] = ldraw(cb + j * p.c_st + n);
        br[k] = ldraw(bb + j * p.b_st + n);
        xr[k] = ldraw(xb + j * p.x_st + n);
    }
    const float4* sp = reinterpret_cast<const float4*>(p.delta + slot * HN * HP);
    if constexpr (SV <= 4) {                       // else loaded as it is stored
#pragma unroll
        for (int k = 0; k < SV; ++k) sr[k] = sp[tid + k * NT];
    }
    const float dtr = tid < Q ? dtb[tid * p.dt_st] : 0.f;
#pragma unroll
    for (int k = 0; k < CV; ++k) {
        const int i = tid + k * NT, j = i / (HN / 4), n = 4 * (i % (HN / 4));
        *reinterpret_cast<uint2*>(&Cb[swz(j, n)]) = cr[k];
        *reinterpret_cast<uint2*>(&Bb[swz(j, n)]) = br[k];
        *reinterpret_cast<uint2*>(&Xb[swz(j, n)]) = xr[k];
    }
#pragma unroll
    for (int k = 0; k < SV; ++k) {                 // S_{c-1} [n][p] as three planes
        const int i = tid + k * NT, n = i / (HP / 4), q = 4 * (i % (HP / 4));
        if constexpr (SV <= 4) store_planes(Sp, HN * HP, swz(n, q), sr[k]);
        else store_planes(Sp, HN * HP, swz(n, q), sp[i]);
    }
    if (tid < Q) dts[tid] = dtr;
    __syncthreads();
    if (warp == 0) chunk_cumsum<Q>(dts, -expf(p.A_log[it.h]), cum, nullptr, ecum, lane);

    // this warp's strips and columns
    int strip[NS], tl0;
    if constexpr (NS == 2) {
        strip[0] = warp % (NW / 2);
        strip[NS - 1] = NW - 1 - strip[0];
        tl0 = NTL * (warp / (NW / 2));
    } else {
        strip[0] = 0;
        tl0 = 0;
    }
    // C S: k = n in steps of 16, the small planes first
    float cs[NS][NTL][4] = {};
#pragma unroll
    for (int k16 = 0; k16 < HN; k16 += 16) {
        uint32_t a[NS][4];
#pragma unroll
        for (int q = 0; q < NS; ++q)
            hopper::ldmatrix_x4(a[q], &Cb[swz(16 * strip[q] + lane % 16, k16 + 8 * (lane / 16))]);
#pragma unroll
        for (int h = 2; h >= 0; --h)
#pragma unroll
            for (int tt = 0; tt < NTL; tt += 2) {
                uint32_t b[4];
                ldmatrix_x4_trans(b, &Sp[h * HN * HP + swz(k16 + lane % 8 + 8 * ((lane / 8) % 2),
                                                           8 * (tl0 + tt + lane / 16))]);
#pragma unroll
                for (int q = 0; q < NS; ++q) {
                    mma_bf16(cs[q][tt], a[q], b[0], b[1]);
                    mma_bf16(cs[q][tt + 1], a[q], b[2], b[3]);
                }
            }
    }
    __syncthreads();                                 // cum, ecum written

    // W over the lower-triangular 16 x 8 tiles (mma_tile, dealt to the
    // warps in turn), masked before exp: a future gap is never exponentiated
    float w[ROUNDS][4];
#pragma unroll
    for (int rd = 0; rd < ROUNDS; ++rd) {
        const int k = rd * NW + warp;
        if (k >= mma_tiles(Q)) continue;
        int st, jt;
        mma_tile(k, st, jt);
#pragma unroll
        for (int e = 0; e < 4; ++e) w[rd][e] = 0.f;
#pragma unroll
        for (int k32 = 0; k32 < HN; k32 += 32) {     // two k16 steps a B load
            uint32_t bf[4];
            hopper::ldmatrix_x4(bf, &Bb[swz(8 * jt + lane % 8, k32 + 8 * (lane / 8))]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                uint32_t af[4];
                hopper::ldmatrix_x4(af, &Cb[swz(16 * st + lane % 16,
                                                k32 + 16 * h + 8 * (lane / 16))]);
                mma_bf16(w[rd], af, bf[2 * h], bf[2 * h + 1]);
            }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = 16 * st + g + 8 * (e / 2), j = 8 * jt + t2 + e % 2;
            float v = 0.f;
            if (j <= i) v = w[rd][e] * expf(cum[i] - cum[j]) * dts[j];
            w[rd][e] = v;
        }
    }
    __syncthreads();                                 // every read of C, B and S is done
#pragma unroll
    for (int rd = 0; rd < ROUNDS; ++rd) {            // W's three planes, packed by strip
        const int k = rd * NW + warp;
        if (k >= mma_tiles(Q)) continue;
        int st, jt;
        mma_tile(k, st, jt);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int off = wstrip_base(st) + (g + 8 * half) * wstrip_pitch(st) + 8 * jt + t2;
            __nv_bfloat16 h0[3], h1[3];
            split3(w[rd][2 * half], h0[0], h0[1], h0[2]);
            split3(w[rd][2 * half + 1], h1[0], h1[1], h1[2]);
#pragma unroll
            for (int h = 0; h < 3; ++h)
                *reinterpret_cast<__nv_bfloat162*>(&Wp[h * WP + off]) =
                    __halves2bfloat162(h0[h], h1[h]);
        }
    }
    __syncthreads();

    // W x: strip s sums j < 16 (s + 1), the small planes first
    float wx[NS][NTL][4] = {};
#pragma unroll
    for (int q = 0; q < NS; ++q) {
        const int s = strip[q];
        for (int j0 = 0; j0 <= 16 * s; j0 += 16) {
            uint32_t b[NTL / 2][4];
#pragma unroll
            for (int tt = 0; tt < NTL; tt += 2)
                ldmatrix_x4_trans(b[tt / 2], &Xb[swz(j0 + lane % 8 + 8 * ((lane / 8) % 2),
                                                     8 * (tl0 + tt + lane / 16))]);
#pragma unroll
            for (int h = 2; h >= 0; --h) {
                uint32_t a[4];
                hopper::ldmatrix_x4(a, &Wp[h * WP + wstrip_base(s) + (lane % 16) * wstrip_pitch(s)
                                           + j0 + 8 * (lane / 16)]);
#pragma unroll
                for (int tt = 0; tt < NTL; tt += 2) {
                    mma_bf16(wx[q][tt], a, b[tt / 2][0], b[tt / 2][1]);
                    mma_bf16(wx[q][tt + 1], a, b[tt / 2][2], b[tt / 2][3]);
                }
            }
        }
    }

    // y = e^{cum} (C S) + W x, two bf16 a store
    T* yb = static_cast<T*>(p.y) + (((size_t)it.b * p.T + t0) * p.H + it.h) * HP;
#pragma unroll
    for (int q = 0; q < NS; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int i = 16 * strip[q] + g + 8 * half;
            const float e = ecum[i];
#pragma unroll
            for (int tt = 0; tt < NTL; ++tt) {
                T* out = yb + (size_t)i * p.H * HP + 8 * (tl0 + tt) + t2;
                *reinterpret_cast<__nv_bfloat162*>(out) =
                    __floats2bfloat162_rn(fmaf(e, cs[q][tt][2 * half], wx[q][tt][2 * half]),
                                          fmaf(e, cs[q][tt][2 * half + 1],
                                               wx[q][tt][2 * half + 1]));
            }
        }
}

// Small chunks: the token walk.  Block (b, h, 16-row part), 128 threads.
template <typename T, int Q>
__global__ void __launch_bounds__(SMALL_THREADS) ssd_scan_small_kernel(const ScanParams p) {
    constexpr int NCH = WINDOW / Q;
    constexpr int BV = WINDOW * HN / 4 / SMALL_THREADS;     // float4s of B (and C) a thread stages
    static_assert(BV * SMALL_THREADS * 4 == WINDOW * HN && WINDOW * SMALL_ROWS / 4 == SMALL_THREADS
                  && NCOL == 8, "one float4 of x a thread, two of the state row");
    __shared__ __align__(16) float Bw[WINDOW][HN];
    __shared__ __align__(16) float Cw[WINDOW][HN];
    __shared__ __align__(16) float Xw[WINDOW][SMALL_ROWS];
    __shared__ __align__(16) float Yw[WINDOW][SMALL_ROWS];
    __shared__ float Ww[WINDOW][Q];                  // W[i][j - chunk start], j <= i
    __shared__ float dtw[WINDOW], cumw[WINDOW], ecw[WINDOW], wdw[WINDOW], etw[NCH];

    const int parts = HP / SMALL_ROWS;
    const int b = blockIdx.x / (p.H * parts), h = (blockIdx.x / parts) % p.H;
    const int p0 = (blockIdx.x % parts) * SMALL_ROWS;
    const int tid = threadIdx.x, row = tid / SMALL_PARTS, part = tid % SMALL_PARTS;
    const float logA = -expf(p.A_log[h]);
    const T* xb = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
    const T* bb = static_cast<const T*>(p.bm) + b * p.b_sb;
    const T* cb = static_cast<const T*>(p.cm) + b * p.c_sb;
    const float* dtb = p.dt + b * p.dt_sb + h * p.dt_sh;
    T* yb = static_cast<T*>(p.y) + ((size_t)b * p.T * p.H + h) * HP + p0;

    using R = typename Raw<T>::type;
    R rb[BV], rc[BV], rx;
    float rdt = 0.f;
    auto fetch = [&](int t0) {
        const int n = min(WINDOW, p.T - t0);
#pragma unroll
        for (int k = 0; k < BV; ++k) {
            const int g = tid + k * SMALL_THREADS, j = g / (HN / 4), q = 4 * (g % (HN / 4));
            if (j < n) {
                rb[k] = ldraw(bb + (t0 + j) * p.b_st + q);
                rc[k] = ldraw(cb + (t0 + j) * p.c_st + q);
            }
        }
        const int j = tid / (SMALL_ROWS / 4), q = 4 * (tid % (SMALL_ROWS / 4));
        if (j < n) rx = ldraw(xb + (t0 + j) * p.x_st + q);
        if (tid < n) rdt = dtb[(t0 + tid) * p.dt_st];
    };

    float S[NCOL], D[NCOL];
#pragma unroll
    for (int e = 0; e < NCOL; ++e) S[e] = 0.f;
    fetch(0);
    for (int t0 = 0; t0 < p.T; t0 += WINDOW) {
        const int n = min(WINDOW, p.T - t0), nch = n / Q;
        __syncthreads();                             // the last window's readers are done
#pragma unroll
        for (int k = 0; k < BV; ++k) {
            const int g = tid + k * SMALL_THREADS, j = g / (HN / 4), q = 4 * (g % (HN / 4));
            if (j < n) {
                st4(&Bw[j][q], to4(rb[k]));
                st4(&Cw[j][q], to4(rc[k]));
            }
        }
        {
            const int j = tid / (SMALL_ROWS / 4), q = 4 * (tid % (SMALL_ROWS / 4));
            if (j < n) st4(&Xw[j][q], to4(rx));
            if (tid < n) dtw[tid] = rdt;
        }
        if (t0 + WINDOW < p.T) fetch(t0 + WINDOW);   // in flight through this window
        __syncthreads();
        // each chunk's cumsum, e^{cum}, dt e^{total - cum}, e^{total}; the
        // in-chunk C_i . B_j
        if (tid < nch) {
            float s = 0.f;
            for (int j = tid * Q; j < tid * Q + Q; ++j) {
                s += dtw[j] * logA;
                cumw[j] = s;
            }
            for (int j = tid * Q; j < tid * Q + Q; ++j) {
                ecw[j] = expf(cumw[j]);
                wdw[j] = dtw[j] * expf(s - cumw[j]);
            }
            etw[tid] = expf(s);
        }
        for (int pr = tid; pr < nch * Q * (Q + 1) / 2; pr += SMALL_THREADS) {
            const int ch = pr / (Q * (Q + 1) / 2);
            int ii = 0, jj = pr % (Q * (Q + 1) / 2);
            while (jj > ii) jj -= ++ii;              // pair (ii, jj), jj <= ii, in the chunk
            const int i = ch * Q + ii, j = ch * Q + jj;
            float s = 0.f;
#pragma unroll 4
            for (int q = 0; q < HN; q += 4) {
                float cv[4], bv[4];
                unpack(*reinterpret_cast<const float4*>(&Cw[i][q]), cv);
                unpack(*reinterpret_cast<const float4*>(&Bw[j][q]), bv);
#pragma unroll
                for (int e = 0; e < 4; ++e) s = fmaf(cv[e], bv[e], s);
            }
            Ww[i][jj] = s;
        }
        __syncthreads();
        for (int pr = tid; pr < nch * Q * (Q + 1) / 2; pr += SMALL_THREADS) {
            const int ch = pr / (Q * (Q + 1) / 2);
            int ii = 0, jj = pr % (Q * (Q + 1) / 2);
            while (jj > ii) jj -= ++ii;
            const int i = ch * Q + ii, j = ch * Q + jj;
            Ww[i][jj] = Ww[i][jj] * expf(cumw[i] - cumw[j]) * dtw[j];   // j <= i
        }
        __syncthreads();
        // the walk: no barrier per token
        for (int ch = 0; ch < nch; ++ch) {
#pragma unroll
            for (int e = 0; e < NCOL; ++e) D[e] = 0.f;
            for (int ii = 0; ii < Q; ++ii) {
                const int i = ch * Q + ii;
                float cv[NCOL], bv[NCOL];
                unpack8(&Cw[i][NCOL * part], cv);
                float dot = 0.f;
#pragma unroll
                for (int e = 0; e < NCOL; ++e) dot = fmaf(cv[e], S[e], dot);
#pragma unroll
                for (int o = SMALL_PARTS / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
                float yi = ecw[i] * dot;
                for (int jj = 0; jj <= ii; ++jj) yi = fmaf(Ww[i][jj], Xw[ch * Q + jj][row], yi);
                if (part == 0) Yw[i][row] = yi;
                const float xw = Xw[i][row] * wdw[i];
                unpack8(&Bw[i][NCOL * part], bv);
#pragma unroll
                for (int e = 0; e < NCOL; ++e) D[e] = fmaf(xw, bv[e], D[e]);
            }
            const float et = etw[ch];
#pragma unroll
            for (int e = 0; e < NCOL; ++e) S[e] = fmaf(et, S[e], D[e]);
        }
        __syncthreads();
        {
            const int j = tid / (SMALL_ROWS / 4), q = 4 * (tid % (SMALL_ROWS / 4));
            if (j < n)
                st4(yb + (size_t)(t0 + j) * p.H * HP + q,
                    *reinterpret_cast<const float4*>(&Yw[j][q]));
        }
    }
    float* sb = p.state + (((size_t)b * p.H + h) * HP + p0 + row) * HN + NCOL * part;
    st4(sb, make_float4(S[0], S[1], S[2], S[3]));
    st4(sb + 4, make_float4(S[4], S[5], S[6], S[7]));
}

struct DecodeParams {
    const void* window;
    const void* conv_w;
    const void* conv_b;
    const void* dt_raw;   // dt_raw, dt_bias, A_log and D in one dtype
    const void* dt_bias;
    const void* A_log;
    const void* D;
    const float* state;
    float* y;
    float* state_out;               // may be state: then the active slots' rows only
    const unsigned char* active;    // B flags, or null: every slot active
    long long dt_sb;                // dt_raw's row stride, in elements
    int H, ch;
};

// The state is read once and written once a launch, and a serve tick finds
// it cold (one layer's 5.24 MB, 54 layers between two reads): streaming
// loads and stores (evict first).  Never the non-coherent path
// (__ldg, ld.global.nc): the same launch may write what it reads.
__device__ __forceinline__ float4 ld_state(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st_state(float* p, const float4 v) {
    __stcs(reinterpret_cast<float4*>(p), v);
}

template <typename T, typename S, int P, int N, int K>
__global__ void __launch_bounds__(THREADS) mamba_decode_kernel(const DecodeParams p) {
    constexpr int TPR = N / 4;                     // threads per state row, a float4 each
    constexpr int NV = P * N / 4 / THREADS;        // float4 a thread: rows r0 + q RSTEP
    constexpr int RSTEP = THREADS / TPR;
    static_assert(N % 4 == 0 && TPR <= 32 && 32 % TPR == 0 && (P * N / 4) % THREADS == 0
                  && P + 2 * N <= THREADS, "one conv channel per thread, float4 state rows");
    __shared__ __align__(16) float xs[P], bs[N], cs[N];
    const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
    const int tid = threadIdx.x;
    const int r0 = tid / TPR, n0 = 4 * (tid % TPR);
    // thread t holds float4 t + q THREADS of the (b, h) slab: each warp
    // instruction reads and writes 512 contiguous bytes
    const float* sb = p.state + ((size_t)b * p.H + h) * P * N + tid * 4;

    // 1. the state: nothing in this launch precedes it, so its loads go first
    float4 sv[NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) sv[q] = ld_state(sb + (size_t)q * THREADS * 4);
    const bool act = p.active == nullptr || p.active[b] != 0;
    // 2. the head's scalars and one conv channel's K taps and bias, all in
    //    flight together
    const float z = to_f32(__ldg(static_cast<const S*>(p.dt_raw) + b * p.dt_sb + h))
                    + to_f32(__ldg(static_cast<const S*>(p.dt_bias) + h));
    const float a_log = to_f32(__ldg(static_cast<const S*>(p.A_log) + h));
    const float d_skip = to_f32(__ldg(static_cast<const S*>(p.D) + h));
    if (tid < P + 2 * N) {
        const int di = p.H * P;
        const int c = tid < P ? h * P + tid : di + (tid - P);
        const T* w = static_cast<const T*>(p.window) + (size_t)b * K * p.ch + c;
        const T* cw = static_cast<const T*>(p.conv_w) + c;
        T wk[K], ck[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            wk[k] = __ldg(w + (size_t)k * p.ch);
            ck[k] = __ldg(cw + (size_t)k * p.ch);
        }
        const T bias = __ldg(static_cast<const T*>(p.conv_b) + c);
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) acc = fmaf(to_f32(wk[k]), to_f32(ck[k]), acc);
        // the window's dtype: the product rounded, the bias add rounded, silu rounded
        float u = to_f32(from_f32<T>(acc));
        u = to_f32(from_f32<T>(u + to_f32(bias)));
        const float s = to_f32(from_f32<T>(u / (1.f + expf(-u))));
        if (tid < P) xs[tid] = s;
        else if (tid < P + N) bs[tid - P] = s;
        else cs[tid - P - N] = s;
    }
    __syncthreads();

    // 3. the update and the read-out: every state value is read and written
    //    by this thread alone; y_p's N-term sum in a fixed order (the
    //    thread's 4 columns in order, then a butterfly over the TPR lanes
    //    of the row)
    const float dt = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));   // softplus
    const float a = expf(dt * -expf(a_log));
    float bn[4], cn[4];
    unpack(*reinterpret_cast<const float4*>(&bs[n0]), bn);
    unpack(*reinterpret_cast<const float4*>(&cs[n0]), cn);
    float* ob = p.state_out + ((size_t)b * p.H + h) * P * N + tid * 4;
    float* yb = p.y + ((size_t)b * p.H + h) * P;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
        const float xp = xs[r0 + q * RSTEP];
        float sq[4], o[4];
        unpack(sv[q], sq);
        float ysum = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            o[e] = a * sq[e] + dt * bn[e] * xp;
            ysum = fmaf(cn[e], o[e], ysum);
        }
        if (act) st_state(ob + (size_t)q * THREADS * 4, make_float4(o[0], o[1], o[2], o[3]));
#pragma unroll
        for (int m = TPR / 2; m > 0; m >>= 1) ysum += __shfl_xor_sync(0xffffffffu, ysum, m);
        if (tid % TPR == q) yb[r0 + q * RSTEP] = ysum + d_skip * xp;
    }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int Q>
cudaError_t launch_chunks(const ScanParams& p, cudaStream_t s) {
    const int items = p.B * p.H * p.nc;
    const size_t sa = state_smem_floats<Q>() * sizeof(float);
    constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
    const size_t sc = TC ? out_tc_smem_bytes<Q>() : out_smem_floats<Q>() * sizeof(float);
    cudaError_t e = allow_smem(ssd_scan_state_kernel<T, Q>, sa);
    if constexpr (TC) {
        if (e == cudaSuccess) e = allow_smem(ssd_scan_out_tc_kernel<Q>, sc);
    } else {
        if (e == cudaSuccess) e = allow_smem(ssd_scan_out_kernel<Q>, sc);
    }
    if (e != cudaSuccess) return e;
    ssd_scan_state_kernel<T, Q><<<items, THREADS, sa, s>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    ssd_scan_pass_kernel<<<p.B * p.H * 4, THREADS, 0, s>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if constexpr (TC) ssd_scan_out_tc_kernel<Q><<<items, 2 * Q, sc, s>>>(p);
    else ssd_scan_out_kernel<Q><<<items, 2 * Q, sc, s>>>(p);
    return cudaGetLastError();
}

template <typename T, int Q>
cudaError_t launch_small(const ScanParams& p, cudaStream_t s) {
    ssd_scan_small_kernel<T, Q><<<p.B * p.H * (HP / SMALL_ROWS), SMALL_THREADS, 0, s>>>(p);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scan(const ScanParams& p, cudaStream_t s) {
    switch (p.Q) {
        case 1: return launch_small<T, 1>(p, s);
        case 2: return launch_small<T, 2>(p, s);
        case 4: return launch_small<T, 4>(p, s);
        case 8: return launch_small<T, 8>(p, s);
        case 16: return launch_chunks<T, 16>(p, s);
        case 32: return launch_chunks<T, 32>(p, s);
        case 64: return launch_chunks<T, 64>(p, s);
        default: return launch_chunks<T, 128>(p, s);
    }
}

bool scan_shape_ok(int B, int T, int H, int P, int N, int Q) {
    return B >= 0 && H >= 0 && T >= 1 && Q >= 1 && Q <= Q_MAX && (Q & (Q - 1)) == 0
           && T % Q == 0 && P == HP && N == HN;
}

}  // namespace

// Floats of chunk-state scratch ssd_scan_fwd needs (the wrapper allocates
// this many): B H (T/Q) (N P + 1) for Q > 8, none for the token
// walk.
extern "C" long long ssd_scan_scratch(int B, int T, int H, int Q) {
    if (Q <= SMALL_Q) return 0;
    return (long long)B * H * (T / Q) * (HN * HP + 1);
}

// x: (B, T, H, P) with element strides (batch, time, head) and unit stride
// on P; dt: (B, T, H) fp32, strides (batch, time, head); bm/cm: (B, T, N),
// strides (batch, time) and unit on N; strides[10] in that order, those of
// x, B and C multiples of 4 and their data 16-byte aligned.  A_log: (H,)
// fp32; y: (B, T, H, P) contiguous in x's dtype; state: (B, H, P, N) fp32
// contiguous, 16-byte aligned; scratch: ssd_scan_scratch(B, T, H, Q) fp32,
// 16-byte aligned.  Built for P = N = 64; Q a power of two <= 128 dividing
// T.  Anything else gives cudaErrorInvalidValue.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* bm, const void* cm,
                            const void* A_log, void* y, void* state, void* scratch, int B,
                            int T, int H, int P, int N, int Q, const long long* strides,
                            int dtype, void* stream) {
    if ((dtype != DTYPE_BF16 && dtype != DTYPE_F32) || !scan_shape_ok(B, T, H, P, N, Q))
        return cudaErrorInvalidValue;
    if (B == 0 || H == 0) return cudaSuccess;
    ScanParams p;
    p.x = x; p.dt = static_cast<const float*>(dt); p.bm = bm; p.cm = cm;
    p.A_log = static_cast<const float*>(A_log); p.y = y; p.state = static_cast<float*>(state);
    p.B = B; p.T = T; p.H = H; p.Q = Q; p.nc = T / Q;
    p.delta = static_cast<float*>(scratch);
    p.etot = p.delta + (size_t)B * H * p.nc * HN * HP;
    p.x_sb = strides[0]; p.x_st = strides[1]; p.x_sh = strides[2];
    p.dt_sb = strides[3]; p.dt_st = strides[4]; p.dt_sh = strides[5];
    p.b_sb = strides[6]; p.b_st = strides[7];
    p.c_sb = strides[8]; p.c_st = strides[9];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == DTYPE_BF16) return launch_scan<__nv_bfloat16>(p, s);
    return launch_scan<float>(p, s);
}

// The scan's work division, as the kernels take it (for the Python mirrors
// in kernels/tiling.py).  ssd_scan_items: (b, h, chunk) of each block of the
// chunk kernels in block order, or (b, h, first state row) of each block of
// the token walk; returns the number of blocks (cap triples at most are
// written).  ssd_scan_tiles: C B^T's tiles in the order the read-out takes
// them: in fp32 (ssd_scan_out_kernel) (thread, ti, tj) of its 4 x 4 tiles
// (round, then thread), in bf16 (ssd_scan_out_tc_kernel) (warp, strip, jt)
// of its 16 x 8 mma tiles; returns their number.
extern "C" int ssd_scan_items(int B, int T, int H, int Q, int* out, int cap) {
    if (!scan_shape_ok(B, T, H, HP, HN, Q)) return -1;
    if (Q <= SMALL_Q) {
        const int parts = HP / SMALL_ROWS, n = B * H * parts;
        for (int k = 0; k < n && k < cap; ++k) {
            out[3 * k] = k / (H * parts);
            out[3 * k + 1] = (k / parts) % H;
            out[3 * k + 2] = (k % parts) * SMALL_ROWS;
        }
        return n;
    }
    const int nc = T / Q, n = B * H * nc;
    for (int k = 0; k < n && k < cap; ++k) {
        const Item it = chunk_item(k, H, nc);
        out[3 * k] = it.b; out[3 * k + 1] = it.h; out[3 * k + 2] = it.c;
    }
    return n;
}

extern "C" int ssd_scan_tiles(int Q, int dtype, int* out, int cap) {
    if (Q <= SMALL_Q || Q > Q_MAX || (Q & (Q - 1)) != 0) return -1;
    const int nw = Q / 16;
    int n = 0;
    if (dtype == DTYPE_BF16) {
        for (int k = 0; k < mma_tiles(Q); ++k) {
            int st, jt;
            mma_tile(k, st, jt);
            if (n < cap) out[3 * n] = k % nw, out[3 * n + 1] = st, out[3 * n + 2] = jt;
            ++n;
        }
        return n;
    }
    for (int rd = 0; rd < (tri_patches(Q) + nw - 1) / nw; ++rd)
        for (int t = 0; t < 2 * Q; ++t) {
            int ti, tj;
            if (!tri_tile(Q, rd, t / 32, t % 32, ti, tj)) continue;
            if (n < cap) out[3 * n] = t, out[3 * n + 1] = ti, out[3 * n + 2] = tj;
            ++n;
        }
    return n;
}

// window: (B, K, ch) contiguous, conv_w: (K, ch) contiguous, conv_b: (ch,),
// all in dtype, ch = H*P + 2N; dt_raw: (B, H) with row stride dt_stride
// and unit stride on H, dt_bias/A_log/D: (H,) contiguous, all in
// param_dtype; state: (B, H, P, N) fp32 contiguous, 16-byte aligned; y:
// (B, H, P) fp32; state_out like state, either a buffer apart from it or
// state itself; active: B bytes (0: the slot is inactive) or null (every
// slot active).  state_out gets the new state in the active slots' rows,
// the others' are not written; y is every slot's.  Built for P = N = 64 and K = 4 (zamba2's
// conv_kernel); anything else gives cudaErrorInvalidValue.
template <typename T>
void launch_decode(const DecodeParams& p, int B, int param_dtype, cudaStream_t s) {
    if (param_dtype == DTYPE_BF16)
        mamba_decode_kernel<T, __nv_bfloat16, 64, 64, DECODE_K><<<B * p.H, THREADS, 0, s>>>(p);
    else
        mamba_decode_kernel<T, float, 64, 64, DECODE_K><<<B * p.H, THREADS, 0, s>>>(p);
}

extern "C" int mamba_decode_fwd(const void* window, const void* conv_w, const void* conv_b,
                                const void* dt_raw, const void* dt_bias, const void* A_log,
                                const void* D, const void* state, void* y, void* state_out,
                                const void* active, int B, int K, int ch, int H, int P, int N,
                                long long dt_stride, int dtype, int param_dtype,
                                void* stream) {
    if ((dtype != DTYPE_BF16 && dtype != DTYPE_F32)
        || (param_dtype != DTYPE_BF16 && param_dtype != DTYPE_F32) || B < 0 || H < 0
        || K != DECODE_K || P != HP || N != HN || ch != H * P + 2 * N || dt_stride < 0)
        return cudaErrorInvalidValue;
    if (B == 0 || H == 0) return cudaSuccess;
    DecodeParams p;
    p.window = window; p.conv_w = conv_w; p.conv_b = conv_b;
    p.dt_raw = dt_raw; p.dt_bias = dt_bias; p.A_log = A_log; p.D = D;
    p.state = static_cast<const float*>(state); p.y = static_cast<float*>(y);
    p.state_out = static_cast<float*>(state_out);
    p.active = static_cast<const unsigned char*>(active);
    p.dt_sb = dt_stride;
    p.H = H; p.ch = ch;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == DTYPE_BF16) launch_decode<__nv_bfloat16>(p, B, param_dtype, s);
    else launch_decode<float>(p, B, param_dtype, s);
    return cudaGetLastError();
}
