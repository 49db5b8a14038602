// Mamba-2 chunked SSD scan and fused single-token mamba decode for Hopper,
// as they were before the scan's chunk-parallel redesign: one block per
// (b, h) walks the chunks in order.  The C entry takes the current wrapper's
// chunk-state scratch and ignores it.
//
// Replaces: repro/kernels/ssd_scan.py:_scan_kernel (via _fwd_pallas) and
//   repro/kernels/ssd_scan.py:_decode_kernel (via mamba_decode_step).
//
// ssd_scan_fwd: x (B, T, H, P), dt (B, T, H) fp32, B/C (B, T, N), A_log (H,)
//   fp32 -> y (B, T, H, P) in x's dtype and the final state (B, H, P, N)
//   fp32, zero initial state, T in chunks of Q (a power of two <= 128 that
//   divides T).  Per chunk, with logA = -exp(A_log), cum the inclusive
//   cumsum of dt*logA over the chunk and total its last entry:
//     W[i][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   (j <= i, else 0)
//     y_i     = sum_j W[i][j] x_j + (C_i . S) * exp(cum_i)
//     S'      = exp(total) S + sum_j x_j (dt_j exp(total - cum_j)) B_j^T
//   all in fp32 as the reference's chunk body.
// Bound on the H100: operations.  The chunk algebra is ~2 Q P N fp32 FMAs
//   per token and head (Q P N/2 for C B^T under the mask, Q P N/2 + P N for
//   y, P N for S') against 2 (P + 2N/H) input and P output values, i.e.
//   ~60 FMAs per byte in bf16 at Q = 128: far above the FFMA ridge (~20
//   FLOP/byte), so the kernel is bound by the fp32 units (FFMA here; the
//   tensor cores are a later step).
// Design: one block of 256 threads per (b, h) walks the T/Q chunks in
//   order, the place of the TPU grid's sequential chunk axis; the (P, N)
//   state stays in shared memory across the loop.  Each chunk stages x, B,
//   C (B and C transposed: [n][j]) and dt in fp32 in shared memory, forms
//   the cumsum with one warp's scan, then runs three register-tiled
//   products (4 x 4 outputs a thread, float4 shared loads): W^T (only the
//   tiles on or below the diagonal; the mask is applied before exp, so a
//   future position's gap is never exponentiated), y, and the state update.
//   A chunk of Q < 4 pads to 4 rows of zeros (x, B, C and dt), which add
//   nothing.  ~186 KB of shared memory: one block per SM.
//
// mamba_decode_fwd: window (B, K, ch), conv_w (K, ch), conv_b (ch,) in one
//   dtype; dt_raw (B, H), dt_bias, A_log, D (H,) in one dtype (read in fp32)
//   and state (B, H, P, N) fp32 -> y (B, H, P) fp32 and the new state
//   (B, H, P, N) fp32 in a fresh buffer.  conv -> silu in the window's
//   dtype (the product rounded, the bias add rounded, silu rounded: the
//   reference's dtype chain), then
//   dt = softplus(dt_raw + dt_bias), S' = exp(-dt e^{A_log}) S + dt x B^T,
//   y = S' C + D x in fp32.
// Bound on the H100: bytes.  The state is read and written once (2 P N fp32
//   per head and slot); everything else is a few KB.
// Design: one block of 256 threads per (b, h).  Threads 0..P+2N-1 each run
//   the K-tap conv of one channel (the head's P x channels and the 2N B and
//   C channels every head shares, which each block recomputes: cheap) into
//   shared memory; then 4 threads per state row p stream 16 of its N
//   values each through float4 loads and stores and reduce y_p by shuffles.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int Q_MAX = 128;
constexpr int QP = Q_MAX + 4;   // pitch of the Q-indexed shared rows (float4-aligned)

struct ScanParams {
    const void* x;
    const float* dt;
    const void* bm;
    const void* cm;
    const float* A_log;
    void* y;
    float* state;
    int B, T, H, Q;
    long long x_sb, x_st, x_sh;     // element strides of x (unit on P)
    long long dt_sb, dt_st, dt_sh;  // of dt
    long long b_sb, b_st;           // of B (unit on N)
    long long c_sb, c_st;           // of C (unit on N)
};

template <int P, int N>
constexpr size_t scan_smem_floats() {
    return (size_t)Q_MAX * P + 2 * N * QP + (size_t)Q_MAX * QP + N * P + 4 * Q_MAX;
}

__device__ __forceinline__ void unpack(const float4 v, float (&a)[4]) {
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(const ScanParams p) {
    static_assert(P % 4 == 0 && N % 4 == 0 && (N / 4) * (P / 4) <= THREADS,
                  "4x4 register tiles, one state tile per thread");
    extern __shared__ float4 smem4[];
    float* Xs = reinterpret_cast<float*>(smem4);  // [Q_MAX][P]
    float* Bt = Xs + Q_MAX * P;                    // [N][QP]: Bt[n][j] = B_j[n]
    float* Ct = Bt + N * QP;                       // [N][QP]
    float* Wt = Ct + N * QP;                       // [Q_MAX][QP]: Wt[j][i] = W[i][j]
    float* St = Wt + Q_MAX * QP;                   // [N][P]: St[n][p] = S[p][n]
    float* dts = St + N * P;                       // [Q_MAX]
    float* cum = dts + Q_MAX;                      // inclusive cumsum of dt*logA
    float* ecum = cum + Q_MAX;                     // exp(cum)
    float* wdec = ecum + Q_MAX;                    // dt * exp(total - cum)

    const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
    const int tid = threadIdx.x;
    const int Q = p.Q;
    const int Qr = Q < 4 ? 4 : Q;                  // rows padded to the 4-row tile
    const int nT = Qr / 4;
    const float logA = -expf(p.A_log[h]);
    const T* xb = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
    const float* dtb = p.dt + b * p.dt_sb + h * p.dt_sh;
    const T* bb = static_cast<const T*>(p.bm) + b * p.b_sb;
    const T* cb = static_cast<const T*>(p.cm) + b * p.c_sb;
    T* yb = static_cast<T*>(p.y) + ((size_t)b * p.T * p.H + h) * P;  // y is contiguous
    float* sb = p.state + ((size_t)b * p.H + h) * P * N;

    // zero state; rows [Q, Qr) of x, B, C and dt stay zero for the whole loop
    for (int i = tid; i < N * P; i += THREADS) St[i] = 0.f;
    for (int i = tid; i < Q_MAX * P; i += THREADS) Xs[i] = 0.f;
    for (int i = tid; i < N * QP; i += THREADS) Bt[i] = Ct[i] = 0.f;
    for (int i = tid; i < Q_MAX; i += THREADS) dts[i] = 0.f;

    const int nc = p.T / Q;
    for (int c = 0; c < nc; ++c) {
        const long long t0 = (long long)c * Q;
        __syncthreads();                           // the last chunk's readers are done
        for (int i = tid; i < Q * P; i += THREADS) {
            const int j = i / P, q = i % P;
            Xs[j * P + q] = to_f32(xb[(t0 + j) * p.x_st + q]);
        }
        for (int i = tid; i < Q * N; i += THREADS) {
            const int j = i / N, n = i % N;
            Bt[n * QP + j] = to_f32(bb[(t0 + j) * p.b_st + n]);
            Ct[n * QP + j] = to_f32(cb[(t0 + j) * p.c_st + n]);
        }
        for (int j = tid; j < Q; j += THREADS) dts[j] = dtb[(t0 + j) * p.dt_st];
        __syncthreads();

        // inclusive cumsum of dt*logA over the Qr rows: lane l sums a run of
        // R consecutive rows, a warp scan adds the runs before it
        if (tid < 32) {
            const int R = (Qr + 31) / 32;          // <= 4
            float loc[4];
            float s = 0.f;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int j = tid * R + r;
                if (r < R && j < Qr) s += dts[j] * logA;
                loc[r] = s;
            }
            float incl = s;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const float v = __shfl_up_sync(0xffffffffu, incl, o);
                if (tid >= o) incl += v;
            }
            const float off = incl - s;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int j = tid * R + r;
                if (r < R && j < Qr) cum[j] = off + loc[r];
            }
        }
        __syncthreads();
        const float total = cum[Qr - 1];
        for (int j = tid; j < Qr; j += THREADS) {
            ecum[j] = expf(cum[j]);
            wdec[j] = dts[j] * expf(total - cum[j]);
        }

        // W^T: tile (ti, tj) of 4 x 4, ti fastest over the threads (float4
        // loads of C and stores of W^T conflict-free); tiles above the
        // diagonal are all masked and never read
        for (int t = tid; t < nT * nT; t += THREADS) {
            const int ti = t % nT, tj = t / nT;
            if (tj > ti) continue;
            float g[4][4] = {};
            for (int n = 0; n < N; ++n) {
                float cv[4], bv[4];
                unpack(*reinterpret_cast<const float4*>(&Ct[n * QP + 4 * ti]), cv);
                unpack(*reinterpret_cast<const float4*>(&Bt[n * QP + 4 * tj]), bv);
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int s = 0; s < 4; ++s) g[r][s] = fmaf(cv[r], bv[s], g[r][s]);
            }
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                const int j = 4 * tj + s;
                float w[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const int i = 4 * ti + r;
                    // masked before exp: j > i is 0, never exp of a positive gap
                    w[r] = i >= j ? g[r][s] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
                }
                *reinterpret_cast<float4*>(&Wt[j * QP + 4 * ti]) =
                    make_float4(w[0], w[1], w[2], w[3]);
            }
        }
        __syncthreads();

        // y: tile (ti, tp), tp fastest (x and S loads conflict-free, W^T and
        // C broadcast); j runs only to the tile's last row
        for (int t = tid; t < nT * (P / 4); t += THREADS) {
            const int tp = t % (P / 4), ti = t / (P / 4);
            float acc[4][4] = {}, accs[4][4] = {};
            const int jmax = min(4 * ti + 4, Qr);
            for (int j = 0; j < jmax; ++j) {
                float wv[4], xv[4];
                unpack(*reinterpret_cast<const float4*>(&Wt[j * QP + 4 * ti]), wv);
                unpack(*reinterpret_cast<const float4*>(&Xs[j * P + 4 * tp]), xv);
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(wv[r], xv[s], acc[r][s]);
            }
            for (int n = 0; n < N; ++n) {
                float cv[4], sv[4];
                unpack(*reinterpret_cast<const float4*>(&Ct[n * QP + 4 * ti]), cv);
                unpack(*reinterpret_cast<const float4*>(&St[n * P + 4 * tp]), sv);
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int s = 0; s < 4; ++s) accs[r][s] = fmaf(cv[r], sv[s], accs[r][s]);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = 4 * ti + r;
                if (i >= Q) continue;
                T* yr = yb + (t0 + i) * p.H * P + 4 * tp;
#pragma unroll
                for (int s = 0; s < 4; ++s) yr[s] = from_f32<T>(acc[r][s] + accs[r][s] * ecum[i]);
            }
        }
        __syncthreads();                           // every read of the old S is done

        // S' = exp(total) S + sum_j (x_j * wdec_j) B_j^T: tile (tn, tp), tp fastest
        const float et = expf(total);
        const bool last = c == nc - 1;
        for (int t = tid; t < (N / 4) * (P / 4); t += THREADS) {
            const int tp = t % (P / 4), tn = t / (P / 4);
            float acc[4][4] = {};                  // [n][p]
            for (int j = 0; j < Qr; ++j) {
                const float wj = wdec[j];
                float xv[4], bv[4];
                unpack(*reinterpret_cast<const float4*>(&Xs[j * P + 4 * tp]), xv);
#pragma unroll
                for (int r = 0; r < 4; ++r) bv[r] = Bt[(4 * tn + r) * QP + j];
#pragma unroll
                for (int s = 0; s < 4; ++s) xv[s] *= wj;
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(bv[r], xv[s], acc[r][s]);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int s = 0; s < 4; ++s) {
                    float* sp = &St[(4 * tn + r) * P + 4 * tp + s];
                    *sp = et * *sp + acc[r][s];
                    acc[r][s] = *sp;
                }
            if (last) {                            // the final state, [p][n] in device memory
#pragma unroll
                for (int s = 0; s < 4; ++s)
                    *reinterpret_cast<float4*>(&sb[(size_t)(4 * tp + s) * N + 4 * tn]) =
                        make_float4(acc[0][s], acc[1][s], acc[2][s], acc[3][s]);
            }
        }
    }
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
    float* state_out;
    int H, K, ch;
};

template <typename T, typename S, int P, int N>
__global__ void __launch_bounds__(THREADS) mamba_decode_kernel(const DecodeParams p) {
    constexpr int TPR = THREADS / P;               // threads per state row
    constexpr int NPT = N / TPR;                   // state values per thread
    static_assert(THREADS % P == 0 && N % TPR == 0 && NPT % 4 == 0 && P + 2 * N <= THREADS,
                  "one conv channel per thread, float4 state rows");
    __shared__ float xs[P], bs[N], cs[N];
    const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
    const int tid = threadIdx.x;

    if (tid < P + 2 * N) {
        const int di = p.H * P;
        const int c = tid < P ? h * P + tid : di + (tid - P);
        const T* w = static_cast<const T*>(p.window) + (size_t)b * p.K * p.ch + c;
        const T* cw = static_cast<const T*>(p.conv_w) + c;
        float acc = 0.f;
        for (int k = 0; k < p.K; ++k)
            acc = fmaf(to_f32(w[(size_t)k * p.ch]), to_f32(cw[(size_t)k * p.ch]), acc);
        // the window's dtype: the product rounded, the bias add rounded, silu rounded
        float u = to_f32(from_f32<T>(acc));
        u = to_f32(from_f32<T>(u + to_f32(static_cast<const T*>(p.conv_b)[c])));
        const float s = to_f32(from_f32<T>(u / (1.f + expf(-u))));
        if (tid < P) xs[tid] = s;
        else if (tid < P + N) bs[tid - P] = s;
        else cs[tid - P - N] = s;
    }
    __syncthreads();

    const S* sp[4] = {static_cast<const S*>(p.dt_raw), static_cast<const S*>(p.dt_bias),
                      static_cast<const S*>(p.A_log), static_cast<const S*>(p.D)};
    const float z = to_f32(sp[0][b * p.H + h]) + to_f32(sp[1][h]);
    const float dt = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));   // softplus
    const float a = expf(dt * -expf(to_f32(sp[2][h])));
    const int row = tid / TPR, part = tid % TPR;
    const size_t base = (((size_t)b * p.H + h) * P + row) * N + part * NPT;
    const float xp = xs[row];
    float ysum = 0.f;
#pragma unroll
    for (int q = 0; q < NPT; q += 4) {
        float sv[4];
        unpack(*reinterpret_cast<const float4*>(p.state + base + q), sv);
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int n = part * NPT + q + e;
            o[e] = a * sv[e] + dt * bs[n] * xp;
            ysum = fmaf(cs[n], o[e], ysum);
        }
        *reinterpret_cast<float4*>(p.state_out + base + q) = make_float4(o[0], o[1], o[2], o[3]);
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1) ysum += __shfl_xor_sync(0xffffffffu, ysum, o);
    if (part == 0) p.y[((size_t)b * p.H + h) * P + row] = ysum + to_f32(sp[3][h]) * xp;
}

template <typename T, int P, int N>
cudaError_t launch_scan(const ScanParams& p, cudaStream_t s) {
    const size_t smem = scan_smem_floats<P, N>() * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel<T, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    ssd_scan_kernel<T, P, N><<<p.B * p.H, THREADS, smem, s>>>(p);
    return cudaGetLastError();
}

}  // namespace

// Floats of scratch ssd_scan_fwd needs: none (the wrapper sizes its scratch
// with this entry; this version takes the argument and ignores it).
extern "C" long long ssd_scan_scratch(int, int, int, int) { return 0; }

// x: (B, T, H, P) with element strides (batch, time, head) and unit stride
// on P; dt: (B, T, H) fp32, strides (batch, time, head); bm/cm: (B, T, N),
// strides (batch, time) and unit on N; strides[10] in that order.  A_log:
// (H,) fp32; y: (B, T, H, P) contiguous in x's dtype; state: (B, H, P, N)
// fp32 contiguous, 16-byte aligned.  Built for P = N = 64; Q a power of two
// <= 128 dividing T.  Anything else gives cudaErrorInvalidValue.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* bm, const void* cm,
                            const void* A_log, void* y, void* state, void* /* scratch */,
                            int B, int T, int H,
                            int P, int N, int Q, const long long* strides, int dtype,
                            void* stream) {
    if ((dtype != DTYPE_BF16 && dtype != DTYPE_F32) || B < 0 || H < 0 || T < 1 || Q < 1
        || Q > Q_MAX || (Q & (Q - 1)) != 0 || T % Q != 0 || P != 64 || N != 64)
        return cudaErrorInvalidValue;
    if (B == 0 || H == 0) return cudaSuccess;
    ScanParams p;
    p.x = x; p.dt = static_cast<const float*>(dt); p.bm = bm; p.cm = cm;
    p.A_log = static_cast<const float*>(A_log); p.y = y; p.state = static_cast<float*>(state);
    p.B = B; p.T = T; p.H = H; p.Q = Q;
    p.x_sb = strides[0]; p.x_st = strides[1]; p.x_sh = strides[2];
    p.dt_sb = strides[3]; p.dt_st = strides[4]; p.dt_sh = strides[5];
    p.b_sb = strides[6]; p.b_st = strides[7];
    p.c_sb = strides[8]; p.c_st = strides[9];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == DTYPE_BF16) return launch_scan<__nv_bfloat16, 64, 64>(p, s);
    return launch_scan<float, 64, 64>(p, s);
}

// window: (B, K, ch) contiguous, conv_w: (K, ch) contiguous, conv_b: (ch,),
// all in dtype, ch = H*P + 2N; dt_raw: (B, H), dt_bias/A_log/D: (H,), all
// contiguous in param_dtype; state: (B, H, P, N) fp32 contiguous; y:
// (B, H, P) fp32; state_out like state (16-byte aligned, not aliasing it).
// Built for P = N = 64.
template <typename T>
void launch_decode(const DecodeParams& p, int B, int param_dtype, cudaStream_t s) {
    if (param_dtype == DTYPE_BF16)
        mamba_decode_kernel<T, __nv_bfloat16, 64, 64><<<B * p.H, THREADS, 0, s>>>(p);
    else
        mamba_decode_kernel<T, float, 64, 64><<<B * p.H, THREADS, 0, s>>>(p);
}

extern "C" int mamba_decode_fwd(const void* window, const void* conv_w, const void* conv_b,
                                const void* dt_raw, const void* dt_bias, const void* A_log,
                                const void* D, const void* state, void* y, void* state_out,
                                int B, int K, int ch, int H, int P, int N, int dtype,
                                int param_dtype, void* stream) {
    if ((dtype != DTYPE_BF16 && dtype != DTYPE_F32)
        || (param_dtype != DTYPE_BF16 && param_dtype != DTYPE_F32) || B < 0 || H < 0
        || K < 1 || P != 64 || N != 64 || ch != H * P + 2 * N)
        return cudaErrorInvalidValue;
    if (B == 0 || H == 0) return cudaSuccess;
    DecodeParams p;
    p.window = window; p.conv_w = conv_w; p.conv_b = conv_b;
    p.dt_raw = dt_raw; p.dt_bias = dt_bias; p.A_log = A_log; p.D = D;
    p.state = static_cast<const float*>(state); p.y = static_cast<float*>(y);
    p.state_out = static_cast<float*>(state_out);
    p.H = H; p.K = K; p.ch = ch;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == DTYPE_BF16) launch_decode<__nv_bfloat16>(p, B, param_dtype, s);
    else launch_decode<float>(p, B, param_dtype, s);
    return cudaGetLastError();
}
