// K2 — the Mamba-1 mixer interior, one direction.
//
// Replaces plantcaduceus_tpu/ops/pallas_mixer.py::_mixer_kernel (launched
// at pallas_mixer.py:345 through mixer_scan_fused / bimamba_mixer_fused[_x]),
// with the x-projection given (no fuse_in):
//   xg    = silu(acc), acc = depthwise conv K taps (causal, or anticausal) + bias
//   dt_lr | B | C = xg @ [W_dt | W_B | W_C]
//   y     = K1's scan of xg with dt = dt_lr @ W_dt, plus Dskip * xg.
// The training variant (emit_res, pallas_mixer.py:61-66, 118-119, 131-135)
// also writes the pre-SiLU `acc` in xi's dtype and the scan's chunk-entry
// states `hb`; the fp32 dt_lr | B | C rows are the `dbc` scratch itself,
// which the wrapper returns instead of dropping.
//
// The TPU kernel walks time chunks in order and carries the conv halo and
// the x_proj sums in scratch. GPU blocks run in no order, so the work is two
// kernels on one stream, and xg never reaches device memory: each kernel
// computes it from xi's K taps (L2-resident) where it needs it.
//  (a) conv_xproj_kernel: a block owns (row, 64 time steps) across all of D,
//      32 channels a pass: the conv and SiLU of the pass into shared memory
//      (transposed), then the x_proj product register-blocked, a thread
//      owning 4 steps x TN outputs with its xg and W fragments in registers
//      (two 16-byte shared loads per 4 TN FMAs). Float32 FMA products (the
//      TPU's float32 dot, no TF32); each output is summed by one thread over
//      D in order, so results are deterministic (no atomics).
//  (b) mix_scan_kernel: one thread per channel with its N states in
//      registers, walking time in processing order (L-1 -> 0 for `reverse`,
//      no flipped copies) in chunks of 8 steps. Per chunk the thread first
//      computes the chunk's per-step inputs in registers, with no dependence
//      between steps: xg by the conv from a window of xi taps carried across
//      chunks, dt = dt_lr . W_dt[:, d] as an outer product over r (the
//      chunk's dt_lr rows staged transposed, one 16-byte load serving four
//      steps); then runs the recurrence. The B, C and dt_lr rows of the next
//      chunk are loaded while this one computes (two buffers, one barrier a
//      chunk).
// Every sum runs in one fixed order: the conv's bias first and then its
// taps, the dt projection over r, the x_proj over D, and the recurrence and
// readout of scan_core.cuh's scan_step (K1's), so K3 recomputes the same
// states. A lane per (channel, state) with the readout deferred to a
// reduce-scatter (K3's layout) issues about twice the instructions per state
// and step: at l20 training it ran this scan at 0.86 ms against this
// layout's 0.54 ms (PERF.md).
//
// What bounds it on an H100: the scan's exp2 per state (1.6e9 at l20,
// 256x512x768x16: about 0.4 ms on the special-function units) ahead of the
// fp32 FMAs (~2.2e10 flops with the x_proj product: 0.33 ms at 67 TFLOP/s)
// and of the bytes xi and y must move (0.13 ms in bf16). The scan issues
// about 250 instructions per (step, channel) (16 states, the softplus, the
// dt projection) at 12 warps an SM, so issue and latency, not the exp2
// alone, set its pace.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the dbc scratch comes from the wrapper) and returns
// cudaGetLastError().

#include "scan_core.cuh"

namespace pc {

constexpr int kMaxK = 8;        // conv taps
constexpr int kXpThreads = 256;
constexpr int kXpT = 64;        // time steps per block of (a)
constexpr int kXpTld = kXpT + 4;  // row stride of the transposed xg tile (16-byte rows)
constexpr int kXpC = 32;        // channels per pass of (a)
constexpr int kMsThreads = 128;  // channels per block of (b)
constexpr int kMsT = 8;          // steps per chunk of (b), its scalars in registers

// (a) shared memory: the xi window [kXpT + K - 1][kXpC], xg^T [kXpC][kXpTld]
// and the W pass [kXpC][16 TN].
inline size_t xp_smem_bytes(int TN) {
  return sizeof(float) * ((kXpT + kMaxK - 1) * kXpC + kXpC * kXpTld + kXpC * 16 * TN);
}

// The conv of one (step, channel) runs in one order that both kernels
// keep: s = bias, then s = fma(x[t - (K-1) + k], w[k], s) for k = 0 ..
// K-1 (causal), or s = fma(x[t + k], w[K-1-k], s) (reverse); xg = SiLU(s).
__device__ __forceinline__ float silu_xg(float s) { return s / (1.f + expf(-s)); }

// RES: the training variant, which also writes the pre-SiLU acc. TN: x_proj
// outputs per thread; wx is [D, 16 TN], zero past J.
template <typename T, bool RES, int TN>
__global__ void __launch_bounds__(kXpThreads) conv_xproj_kernel(
    const T* __restrict__ xi, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ wx, float* __restrict__ dbc,
    T* __restrict__ acc_out, int L, int D, int K, int J, int reverse) {
  extern __shared__ float4 xp_smem4[];
  constexpr int JP = 16 * TN;
  float* sx = reinterpret_cast<float*>(xp_smem4);  // [kXpT + K - 1][kXpC] xi window
  float* sxg = sx + (kXpT + kMaxK - 1) * kXpC;     // [kXpC][kXpTld] xg^T
  float4* sw = reinterpret_cast<float4*>(sxg + kXpC * kXpTld);  // [kXpC][JP / 4] W
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long b = blockIdx.y;
  const int t0 = blockIdx.x * kXpT;
  const T* xrow = xi + b * (long long)L * D;
  const int win = kXpT + K - 1;
  // causal: output t reads x[t-K+1 .. t]; anticausal: x[t .. t+K-1]
  const int tbase = reverse ? t0 : t0 - (K - 1);
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;

  for (int c0 = 0; c0 < D; c0 += kXpC) {
    for (int i = tid; i < win * kXpC; i += kXpThreads) {
      const int t = tbase + i / kXpC, c = c0 + i % kXpC;
      sx[i] = (t >= 0 && t < L && c < D) ? to_f(xrow[(long long)t * D + c]) : 0.f;
    }
    for (int i = tid; i < kXpC * JP / 4; i += kXpThreads) {
      const int c = c0 + i / (JP / 4);
      sw[i] = c < D ? __ldg(reinterpret_cast<const float4*>(wx + (long long)c * JP) + i % (JP / 4))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    {  // this thread's channel of the pass, its taps in the conv's order
      const int ch = tid % kXpC, c = c0 + ch;
      float wr[kMaxK];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        wr[k] = (k < K && c < D) ? conv_w[(long long)c * K + (reverse ? K - 1 - k : k)] : 0.f;
      const float cb = c < D ? conv_b[c] : 0.f;
      for (int tt = tid / kXpC; tt < kXpT; tt += kXpThreads / kXpC) {
        const int t = t0 + tt;
        float v = 0.f;
        if (t < L && c < D) {
          float s = cb;
#pragma unroll
          for (int k = 0; k < kMaxK; ++k)
            if (k < K) s = fmaf(sx[(tt + k) * kXpC + ch], wr[k], s);
          v = silu_xg(s);
          if constexpr (RES) acc_out[(b * L + t) * D + c] = from_f<T>(s);  // pre-SiLU
        }
        sxg[ch * kXpTld + tt] = v;
      }
    }
    __syncthreads();
    const float* swf = reinterpret_cast<const float*>(sw);
#pragma unroll 4
    for (int ch = 0; ch < kXpC; ++ch) {
      const float4 xv = *reinterpret_cast<const float4*>(sxg + ch * kXpTld + 4 * ty);
      float w[TN];
#pragma unroll
      for (int n = 0; n < TN; n += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(swf + ch * JP + tx * TN + n);
        w[n] = w4.x; w[n + 1] = w4.y; w[n + 2] = w4.z; w[n + 3] = w4.w;
      }
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(xa[i], w[n], acc[i][n]);
    }
    __syncthreads();  // sx, sxg and sw are rewritten by the next pass
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * ty + i;
    if (t >= L) continue;
    float* o = dbc + (b * L + t) * J;
#pragma unroll
    for (int n = 0; n < TN; ++n)
      if (tx * TN + n < J) o[tx * TN + n] = acc[i][n];
  }
}

struct MixScanArgs {
  const void* xi;        // [rows, L, D]
  const float* conv_w;   // [D, K]
  const float* conv_b;   // [D]
  const float* dbc;      // [rows, L, J]: dt_lr | B | C, J = R + 2N
  const float* wdt;      // [R, D]
  const float* dt_bias;  // [D]
  const float* A;        // [D, N]
  const float* Dskip;    // [D]
  void* y;               // [rows, L, D]
  float* hb;             // [rows, ceil(L/hbc), D, N] chunk-entry states, or nullptr
  int L, D, R, K, reverse, hbc;
};

// (b) shared memory: two buffers of a chunk's rows (B [kMsT][N], C [kMsT][N],
// dt_lr^T [R][kMsT]) and the block's W_dt columns [R][kMsThreads].
__host__ __device__ inline int ms_buf_floats(int N, int R) { return kMsT * (2 * N + R); }
inline size_t ms_smem_bytes(int N, int R) {
  return sizeof(float) * (2 * ms_buf_floats(N, R) + (size_t)R * kMsThreads);
}

// KT: registers for the conv taps (K <= KT; the K given taps in the conv's
// order, zero taps around them, which leaves every sum as it is).
template <typename T, int N, int KT, bool HB>
__global__ void __launch_bounds__(kMsThreads, 4) mix_scan_kernel(MixScanArgs a) {
  constexpr int TC = kMsT;
  constexpr int NR = 8;  // row values a thread stages: kMsT (2N + R) <= 1024 as R + 2N <= 128
  extern __shared__ float4 ms_smem4[];
  const int L = a.L, D = a.D, R = a.R, K = a.K, J = R + 2 * N;
  const int RW = ms_buf_floats(N, R);
  float* sbuf = reinterpret_cast<float*>(ms_smem4);  // [2][RW]
  float* sW = sbuf + 2 * RW;                         // [R][kMsThreads]
  const int tid = threadIdx.x;
  const long long row = blockIdx.y;
  const int d0 = blockIdx.x * kMsThreads, d = d0 + tid;
  const bool live = d < D;
  const T* x = static_cast<const T*>(a.xi) + row * (long long)L * D;
  T* y = static_cast<T*>(a.y) + row * (long long)L * D;
  const float* dbc = a.dbc + row * (long long)L * J;
  auto time_of = [&](int p) { return a.reverse ? L - 1 - p : p; };
  for (int i = tid; i < R * kMsThreads; i += kMsThreads) {
    const int c = d0 + i % kMsThreads;
    sW[i] = c < D ? a.wdt[(long long)(i / kMsThreads) * D + c] : 0.f;
  }
  float A[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = live ? a.A[(long long)d * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float bias = live ? a.dt_bias[d] : 0.f;
  const float dsk = live ? a.Dskip[d] : 0.f;
  const float cb = live ? a.conv_b[d] : 0.f;
  // Taps in window order: the window's slot KT - 1 + k is this chunk's step
  // k in processing order (u[p] = x[time_of(p)], 0 before the start), so a
  // causal step reads slots k .. k + KT - 1 oldest first and a reverse step
  // reads them newest first, each in the conv's order.
  float wt[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    float v = 0.f;
    if (live) {
      if (!a.reverse && j >= KT - K) v = a.conv_w[(long long)d * K + j - (KT - K)];
      if (a.reverse && j < K) v = a.conv_w[(long long)d * K + K - 1 - j];
    }
    wt[j] = v;
  }
  float* hb = HB ? a.hb + row * (long long)((L + a.hbc - 1) / a.hbc) * D * N : nullptr;
  const int hmask = a.hbc - 1;  // hbc a power of two <= 16

  // A chunk's B | C | dt_lr^T rows: element i of a buffer, for the chunk at p0.
  float rr[NR];
  auto load_rows = [&](int p0) {
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      const int i = tid + u * kMsThreads;
      int k, col;
      if (i < 2 * TC * N) {
        k = (i % (TC * N)) / N;
        col = R + (i >= TC * N ? N : 0) + i % N;
      } else {
        k = (i - 2 * TC * N) % TC;
        col = (i - 2 * TC * N) / TC;
      }
      const int p = p0 + k;
      rr[u] = (i < RW && p < L) ? dbc[(long long)time_of(p) * J + col] : 0.f;
    }
  };
  auto store_rows = [&](float* buf) {
#pragma unroll
    for (int u = 0; u < NR; ++u)
      if (tid + u * kMsThreads < RW) buf[tid + u * kMsThreads] = rr[u];
  };

  float win[KT - 1 + TC];
#pragma unroll
  for (int j = 0; j < KT - 1; ++j) win[j] = 0.f;
  load_rows(0);
  store_rows(sbuf);
  const int nchunks = (L + TC - 1) / TC;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int p0 = ci * TC;
    const float* sB = sbuf + (ci & 1) * RW;  // [TC][N]
    const float* sC = sB + TC * N;           // [TC][N]
    const float* sdt = sC + TC * N;          // [R][TC]
    __syncthreads();  // this chunk's rows are staged; the other buffer is free
    if (ci + 1 < nchunks) load_rows(p0 + TC);
    // The chunk's inputs and per-step scalars, in registers: xg by the conv,
    // dt = dt_lr . W_dt[:, d] (each step's sum over r in order), dt'.
#pragma unroll
    for (int k = 0; k < TC; ++k) {
      const int p = p0 + k;
      win[KT - 1 + k] = (live && p < L) ? to_f(x[(long long)time_of(p) * D + d]) : 0.f;
    }
    float xv[TC], dv[TC];
#pragma unroll
    for (int k = 0; k < TC; ++k) {
      float s = cb;
      if (!a.reverse) {
#pragma unroll
        for (int j = 0; j < KT; ++j) s = fmaf(win[k + j], wt[j], s);
      } else {
#pragma unroll
        for (int j = 0; j < KT; ++j) s = fmaf(win[k + KT - 1 - j], wt[j], s);
      }
      xv[k] = silu_xg(s);
      dv[k] = 0.f;
    }
#pragma unroll 2
    for (int r = 0; r < R; ++r) {
      const float w = sW[r * kMsThreads + tid];
#pragma unroll
      for (int k = 0; k < TC; k += 4) {
        const float4 q = *reinterpret_cast<const float4*>(sdt + r * TC + k);
        dv[k] = fmaf(q.x, w, dv[k]);
        dv[k + 1] = fmaf(q.y, w, dv[k + 1]);
        dv[k + 2] = fmaf(q.z, w, dv[k + 2]);
        dv[k + 3] = fmaf(q.w, w, dv[k + 3]);
      }
    }
    // The recurrence and readout: scan_core.cuh's scan_step, its arithmetic
    // and order.
#pragma unroll
    for (int k = 0; k < TC; ++k) {
      const int p = p0 + k;
      if constexpr (HB) {
        if ((p & hmask) == 0 && p < L && live)
          store_state<N>(hb + ((long long)(p / a.hbc) * D + d) * N, h);
      }
      const float dtp = p < L ? softplus(dv[k] + bias) : 0.f;
      const float dtl = dtp * kLog2e, dtx = dtp * xv[k];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; n += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(sB + k * N + n);
        const float4 c4 = *reinterpret_cast<const float4*>(sC + k * N + n);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w}, cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[n + e] = fmaf(exp2f(dtl * A[n + e]), h[n + e], bv[e] * dtx);
          acc = fmaf(cv[e], h[n + e], acc);
        }
      }
      if (live && p < L) y[(long long)time_of(p) * D + d] = from_f<T>(fmaf(xv[k], dsk, acc));
    }
#pragma unroll
    for (int j = 0; j < KT - 1; ++j) win[j] = win[TC + j];
    if (ci + 1 < nchunks) store_rows(sbuf + ((ci + 1) & 1) * RW);
  }
}

template <typename T, int N, int KT>
cudaError_t launch_mix_scan_n(const MixScanArgs& a, int rows, cudaStream_t s) {
  const size_t smem = ms_smem_bytes(N, a.R);
  auto kern = a.hb ? mix_scan_kernel<T, N, KT, true> : mix_scan_kernel<T, N, KT, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((a.D + kMsThreads - 1) / kMsThreads, rows), kMsThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int KT>
cudaError_t launch_mix_scan(const MixScanArgs& a, int N, int rows, cudaStream_t s) {
  switch (N) {
    case 4: return launch_mix_scan_n<T, 4, KT>(a, rows, s);
    case 8: return launch_mix_scan_n<T, 8, KT>(a, rows, s);
    case 16: return launch_mix_scan_n<T, 16, KT>(a, rows, s);
    case 32: return launch_mix_scan_n<T, 32, KT>(a, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_mixer(const void* xi, const float* conv_w, const float* conv_b,
                         const float* wx, const float* wdt, const float* dt_bias,
                         const float* A, const float* Dskip, float* dbc, void* y, void* acc,
                         float* hb, int Bn, int L, int D, int N, int R, int K, int reverse,
                         int hbc, cudaStream_t s) {
  const int J = R + 2 * N;
  if (K < 1 || K > kMaxK || J > 16 * 8) return cudaErrorInvalidValue;
  if (hb && (hbc < 1 || hbc > 16 || (hbc & (hbc - 1)))) return cudaErrorInvalidValue;
  const dim3 grid((L + kXpT - 1) / kXpT, Bn);
  const T* xt = static_cast<const T*>(xi);
  T* at = static_cast<T*>(acc);
  if (J <= 64) {
    auto k = acc ? conv_xproj_kernel<T, true, 4> : conv_xproj_kernel<T, false, 4>;
    k<<<grid, kXpThreads, xp_smem_bytes(4), s>>>(xt, conv_w, conv_b, wx, dbc, at, L, D, K, J,
                                                 reverse);
  } else {
    auto k = acc ? conv_xproj_kernel<T, true, 8> : conv_xproj_kernel<T, false, 8>;
    k<<<grid, kXpThreads, xp_smem_bytes(8), s>>>(xt, conv_w, conv_b, wx, dbc, at, L, D, K, J,
                                                 reverse);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  MixScanArgs a;
  a.xi = xi; a.conv_w = conv_w; a.conv_b = conv_b; a.dbc = dbc; a.wdt = wdt;
  a.dt_bias = dt_bias; a.A = A; a.Dskip = Dskip; a.y = y; a.hb = hb;
  a.L = L; a.D = D; a.R = R; a.K = K; a.reverse = reverse; a.hbc = hbc > 0 ? hbc : 1;
  return K <= 4 ? launch_mix_scan<T, 4>(a, N, Bn, s) : launch_mix_scan<T, kMaxK>(a, N, Bn, s);
}

}  // namespace pc

// acc and hb are both null (inference) or both given (training residuals);
// hbc, the hb stride in steps, a power of two <= 16. wx is [D, 64] when R +
// 2N <= 64, else [D, 128], zero past R + 2N; dbc [Bn, L, R + 2N] float32
// receives dt_lr | B | C.
extern "C" int pc_mixer_fwd(const void* xi, const float* conv_w, const float* conv_b,
                            const float* wx, const float* wdt, const float* dt_bias,
                            const float* A, const float* Dskip, float* dbc, void* y, void* acc,
                            float* hb, int Bn, int L, int D, int N, int R, int K, int reverse,
                            int bf16, int hbc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pc::launch_mixer<__nv_bfloat16>(xi, conv_w, conv_b, wx, wdt, dt_bias, A, Dskip, dbc,
                                           y, acc, hb, Bn, L, D, N, R, K, reverse, hbc, s);
  return pc::launch_mixer<float>(xi, conv_w, conv_b, wx, wdt, dt_bias, A, Dskip, dbc, y, acc,
                                 hb, Bn, L, D, N, R, K, reverse, hbc, s);
}
