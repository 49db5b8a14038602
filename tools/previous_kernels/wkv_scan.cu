// RWKV-6 chunked wkv scan and fused single-token wkv decode step for Hopper,
// as they were before the scan's chunk-parallel redesign: one block per
// (b, h) walks the chunks in order.  The C entry takes the current wrapper's
// chunk-state scratch and ignores it.
//
// Replaces: repro/kernels/wkv_scan.py:_scan_kernel (via _fwd_pallas) and
//   repro/kernels/wkv_scan.py:_decode_kernel (via wkv_decode_step).
//
// wkv_scan_fwd: r, k, w (B, T, H, K), v (B, T, H, V), u (H, K) and the
//   carried state S (B, H, K, V), all fp32 -> y (B, T, H, V) and the final
//   state, fp32, T in chunks of Q (a power of two <= 32 that divides T).
//   Per chunk, with cum the inclusive cumsum of log w over the chunk (per
//   channel k), cum_{-1} = 0 and total its last entry:
//     y_t = (r_t * e^{cum_{t-1}}) S
//           + sum_{i<t} [sum_k r_tk k_ik e^{cum_{t-1,k} - cum_{i,k}}] v_i
//           + (r_t . (u * k_t)) v_t
//     S'  = e^{total} * S + sum_i (k_i * e^{total - cum_i})^T v_i
//   all in fp32 as the reference's chunk body.
// Bound on the H100: bytes, narrowly.  Per token and head the chunk algebra
//   is ~Q K / 2 exps and 2 Q K FLOPs for the scores, 4 K V for the carry-in
//   and the state update and Q V for score @ v (~22k FLOPs at Q = 32)
//   against 4 K fp32 inputs and V outputs (1280 bytes): ~18 FLOPs a byte,
//   just under the FFMA ridge (~20); the Q K / 2 exps a token run on the
//   special-function units besides.
// Design: one block of 256 threads per (b, h) walks the T/Q chunks in order,
//   the place of the TPU grid's sequential chunk axis; the (K, V) state stays
//   in shared memory across the loop (16 KB).  Each chunk stages r, k, w and
//   v in shared memory (each thread's 32 loads issued together before the
//   barrier that frees the last chunk's buffers); one thread per channel k
//   forms the cumsum of log w in order of t, r * e^{cum_{t-1}} and
//   k * e^{total - cum}; one thread per (t, i) pair with i < t forms a
//   score (the masked triangle is never formed, so no exponent of a
//   future, positive gap is taken); then the
//   threads take y (a column v and 8 rows t each) and the state update (a
//   column v and 16 rows k each).  A chunk of 1 has no pair and no
//   intra-chunk term.  The grid has B*H blocks: 32 of the 132 SMs at B = 1
//   and rwkv6's 32 heads, 128 at the train microbatch of 4; V is not split
//   across blocks, which would recompute every score once per part.
//
// wkv_decode_fwd: r, k, w (B, H, K), v (B, H, V), u (H, K), S (B, H, K, V),
//   all fp32 -> out = r (S + u * k v^T) (B, H, V) and S' = w * S + k v^T in a
//   fresh (B, H, K, V) buffer.
// Bound on the H100: bytes.  S is read once and S' written once (2 K V fp32
//   per head and slot); r, k, v, w and u are a few KB.
// Design: one block of V threads per (b, h), one thread per column v: it
//   loads its column of S into registers (coalesced across the block, all 64
//   loads in flight: a loop of dependent load-use steps ran at the memory
//   latency, 64 times over), writes S' (the product and the sum each
//   rounded, as the reference's two ops) and sums out_v over k.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int KD = 64;                 // K = V: rwkv6's head dim
constexpr int Q_MAX = 32;
constexpr int KP = KD + 1;             // pitch of rows read by the (t, i) pairs: conflict-free
constexpr int QP = Q_MAX + 1;
constexpr int ROWS_Y = Q_MAX / (THREADS / KD);   // rows of y a thread takes (8)
constexpr int ROWS_S = KD / (THREADS / KD);      // rows of S' a thread takes (16)
constexpr int LOADS = Q_MAX * KD / THREADS;      // elements of r, k, w, v a thread stages (8)

struct ScanParams {
    const float* r;
    const float* k;
    const float* v;
    const float* w;
    const float* u;
    const float* s0;
    float* y;
    float* s_out;
    int B, T, H, Q;
};

constexpr size_t scan_smem_floats() {
    return 2 * Q_MAX * KP + (Q_MAX + 1) * KP + 3 * Q_MAX * KD + KD * KD + Q_MAX * QP
           + Q_MAX + KD;
}

__global__ void __launch_bounds__(THREADS) wkv_scan_kernel(const ScanParams p) {
    extern __shared__ float smem[];
    float* Rs = smem;                          // [Q][KP]: r
    float* Ks = Rs + Q_MAX * KP;               // [Q][KP]: k
    float* Cx = Ks + Q_MAX * KP;               // [Q+1][KP]: row 0 = 0, row t+1 = cum_t
    float* Rd = Cx + (Q_MAX + 1) * KP;         // [Q][K]: r * e^{cum_{t-1}}
    float* Kw = Rd + Q_MAX * KD;               // [Q][K]: k * e^{total - cum}
    float* Vs = Kw + Q_MAX * KD;               // [Q][V]
    float* Ss = Vs + Q_MAX * KD;               // [K][V]: the carried state
    float* Sc = Ss + KD * KD;                  // [Q][QP]: scores, i < t only
    float* bonus = Sc + Q_MAX * QP;            // [Q]: r_t . (u * k_t)
    float* et = bonus + Q_MAX;                 // [K]: e^{total}

    const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
    const int tid = threadIdx.x;
    const int Q = p.Q;
    const size_t row = (size_t)p.H * KD;                       // elements between t and t+1
    const size_t base = ((size_t)b * p.T * p.H + h) * KD;      // (b, 0, h, 0)
    const size_t sbase = ((size_t)b * p.H + h) * KD * KD;
    const float* uh = p.u + (size_t)h * KD;

    for (int i = tid; i < KD * KD; i += THREADS) Ss[i] = p.s0[sbase + i];
    if (tid < KD) Cx[tid] = 0.f;

    const int nc = p.T / Q;
    const int npairs = Q * (Q - 1) / 2;
    const int vv = tid % KD, grp = tid / KD;
    const int warp = tid / 32, lane = tid % 32;
    for (int c = 0; c < nc; ++c) {
        const size_t off = base + (size_t)c * Q * row;
        // all of the thread's loads in flight at once (read-only path), then
        // into shared memory once the last chunk's readers are done
        float lr[LOADS], lk[LOADS], lw[LOADS], lv[LOADS];
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
            const int i = tid + j * THREADS;
            if (i < Q * KD) {
                const size_t g = off + (i / KD) * row + i % KD;
                lr[j] = __ldg(p.r + g);
                lk[j] = __ldg(p.k + g);
                lw[j] = __ldg(p.w + g);
                lv[j] = __ldg(p.v + g);
            }
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
            const int i = tid + j * THREADS;
            if (i < Q * KD) {
                const int t = i / KD, kk = i % KD;
                Rs[t * KP + kk] = lr[j];
                Ks[t * KP + kk] = lk[j];
                Cx[(t + 1) * KP + kk] = lw[j];   // log w and its cumsum in place below
                Vs[t * KD + kk] = lv[j];
            }
        }
        __syncthreads();

        // one thread per channel: the cumsum of log w in order of t
        if (tid < KD) {
            float cum = 0.f;
            for (int t = 0; t < Q; ++t) {
                Rd[t * KD + tid] = Rs[t * KP + tid] * expf(cum);
                cum += logf(Cx[(t + 1) * KP + tid]);
                Cx[(t + 1) * KP + tid] = cum;
            }
            for (int t = 0; t < Q; ++t)
                Kw[t * KD + tid] = Ks[t * KP + tid] * expf(cum - Cx[(t + 1) * KP + tid]);
            et[tid] = expf(cum);
        }
        __syncthreads();

        // scores of the pairs i < t only: pair p = t(t-1)/2 + i
        for (int pi = tid; pi < npairs; pi += THREADS) {
            int t = (int)((1.f + sqrtf(1.f + 8.f * pi)) * 0.5f);
            while (t * (t - 1) / 2 > pi) --t;
            while ((t + 1) * t / 2 <= pi) ++t;
            const int i = pi - t * (t - 1) / 2;
            const float* rt = Rs + t * KP;
            const float* ki = Ks + i * KP;
            const float* cp = Cx + t * KP;         // cum_{t-1}
            const float* ci = Cx + (i + 1) * KP;   // cum_i >= cum_{t-1}: the gap is <= 0
            float s = 0.f;
            for (int kk = 0; kk < KD; ++kk) s = fmaf(rt[kk] * ki[kk], expf(cp[kk] - ci[kk]), s);
            Sc[t * QP + i] = s;
        }
        // the bonus term's dot product, one warp per row
        for (int t = warp; t < Q; t += THREADS / 32) {
            float s = Rs[t * KP + lane] * (uh[lane] * Ks[t * KP + lane])
                      + Rs[t * KP + lane + 32] * (uh[lane + 32] * Ks[t * KP + lane + 32]);
            s = warp_sum(s);
            if (lane == 0) bonus[t] = s;
        }
        __syncthreads();

        // y: column vv, rows grp, grp + 4, ... (interleaved: the i-loop is triangular)
        {
            float acc[ROWS_Y];
#pragma unroll
            for (int j = 0; j < ROWS_Y; ++j) acc[j] = 0.f;
            for (int kk = 0; kk < KD; ++kk) {
                const float s = Ss[kk * KD + vv];
#pragma unroll
                for (int j = 0; j < ROWS_Y; ++j) {
                    const int t = grp + (THREADS / KD) * j;
                    if (t < Q) acc[j] = fmaf(Rd[t * KD + kk], s, acc[j]);
                }
            }
#pragma unroll
            for (int j = 0; j < ROWS_Y; ++j) {
                const int t = grp + (THREADS / KD) * j;
                if (t >= Q) continue;
                float intra = 0.f;
                for (int i = 0; i < t; ++i) intra = fmaf(Sc[t * QP + i], Vs[i * KD + vv], intra);
                p.y[off + t * row + vv] = (acc[j] + intra) + bonus[t] * Vs[t * KD + vv];
            }
        }
        __syncthreads();                       // every read of the old S is done

        // S' = e^{total} S + sum_i Kw_i^T v_i: column vv, rows grp*16 .. +16
        {
            float acc[ROWS_S];
#pragma unroll
            for (int j = 0; j < ROWS_S; ++j) acc[j] = 0.f;
            for (int i = 0; i < Q; ++i) {
                const float vi = Vs[i * KD + vv];
#pragma unroll
                for (int j = 0; j < ROWS_S; ++j)
                    acc[j] = fmaf(Kw[i * KD + grp * ROWS_S + j], vi, acc[j]);
            }
            const bool last = c == nc - 1;
#pragma unroll
            for (int j = 0; j < ROWS_S; ++j) {
                const int kk = grp * ROWS_S + j;
                const float sn = et[kk] * Ss[kk * KD + vv] + acc[j];
                Ss[kk * KD + vv] = sn;
                if (last) p.s_out[sbase + kk * KD + vv] = sn;
            }
        }
    }
}

struct DecodeParams {
    const float* r;
    const float* k;
    const float* v;
    const float* w;
    const float* u;
    const float* s;
    float* y;
    float* s_out;
    int H;
};

__global__ void __launch_bounds__(KD) wkv_decode_kernel(const DecodeParams p) {
    __shared__ float rs[KD], ks[KD], ws[KD], us[KD];
    const size_t bh = blockIdx.x;
    const int h = blockIdx.x % p.H;
    const int vv = threadIdx.x;                // K == V: thread vv also stages channel vv
    rs[vv] = p.r[bh * KD + vv];
    ks[vv] = p.k[bh * KD + vv];
    ws[vv] = p.w[bh * KD + vv];
    us[vv] = p.u[(size_t)h * KD + vv];
    const float vval = p.v[bh * KD + vv];
    __syncthreads();
    const float* S = p.s + bh * KD * KD;
    float* So = p.s_out + bh * KD * KD;
    float s[KD];                               // the column, all loads in flight at once
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) s[kk] = __ldg(S + kk * KD + vv);
    float out = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
        const float kv = __fmul_rn(ks[kk], vval);
        out = fmaf(rs[kk], s[kk] + us[kk] * kv, out);
        So[kk * KD + vv] = __fadd_rn(__fmul_rn(ws[kk], s[kk]), kv);   // the plain two roundings
    }
    p.y[bh * KD + vv] = out;
}

}  // namespace

// Floats of scratch wkv_scan_fwd needs: none (the wrapper sizes its scratch
// with this entry; this version takes the argument and ignores it).
extern "C" long long wkv_scan_scratch(int, int, int, int) { return 0; }

// r, k, w: (B, T, H, K), v: (B, T, H, V), u: (H, K), state: (B, H, K, V);
// y: (B, T, H, V), state_out: (B, H, K, V); all fp32, contiguous.  Built for
// K = V = 64; Q a power of two <= 32 dividing T.  Anything else gives
// cudaErrorInvalidValue.
extern "C" int wkv_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                            const void* u, const void* state, void* y, void* state_out,
                            void* /* scratch */, int B, int T, int H, int K, int V, int Q,
                            void* stream) {
    if (B < 0 || H < 0 || T < 1 || Q < 1 || Q > Q_MAX || (Q & (Q - 1)) != 0 || T % Q != 0
        || K != KD || V != KD)
        return cudaErrorInvalidValue;
    if (B == 0 || H == 0) return cudaSuccess;
    ScanParams p;
    p.r = static_cast<const float*>(r); p.k = static_cast<const float*>(k);
    p.v = static_cast<const float*>(v); p.w = static_cast<const float*>(w);
    p.u = static_cast<const float*>(u); p.s0 = static_cast<const float*>(state);
    p.y = static_cast<float*>(y); p.s_out = static_cast<float*>(state_out);
    p.B = B; p.T = T; p.H = H; p.Q = Q;
    const size_t smem = scan_smem_floats() * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(wkv_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    wkv_scan_kernel<<<B * H, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return cudaGetLastError();
}

// r, k, w: (B, H, K), v: (B, H, V), u: (H, K), state: (B, H, K, V); y:
// (B, H, V), state_out like state, not aliasing it; all fp32, contiguous.
// Built for K = V = 64.
extern "C" int wkv_decode_fwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* state, void* y, void* state_out,
                              int B, int H, int K, int V, void* stream) {
    if (B < 0 || H < 0 || K != KD || V != KD) return cudaErrorInvalidValue;
    if (B == 0 || H == 0) return cudaSuccess;
    DecodeParams p;
    p.r = static_cast<const float*>(r); p.k = static_cast<const float*>(k);
    p.v = static_cast<const float*>(v); p.w = static_cast<const float*>(w);
    p.u = static_cast<const float*>(u); p.s = static_cast<const float*>(state);
    p.y = static_cast<float*>(y); p.s_out = static_cast<float*>(state_out);
    p.H = H;
    wkv_decode_kernel<<<B * H, KD, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return cudaGetLastError();
}
