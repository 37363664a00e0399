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
//  (b) scan_core.cuh's scan_fwd_kernel, the forward scan K1 also runs,
//      with this file's MixConvSrc as its input policy: one thread per
//      channel with its N states in registers, walking time in processing
//      order (L-1 -> 0 for `reverse`, no flipped copies) in chunks of 8
//      steps. Per chunk the thread first computes the chunk's per-step
//      inputs in registers, with no dependence between steps: xg by the conv
//      from a window of xi taps carried across chunks, dt = dt_lr . W_dt[:, d]
//      as an outer product over r; then runs the recurrence. The B, C and
//      dt_lr rows of the next chunk are loaded while this one computes.
// Every sum runs in one fixed order: the conv's bias first and then its
// taps, the dt projection over r, the x_proj over D, and the recurrence and
// readout of scan_core.cuh, so K3 recomputes the same states. A lane per
// (channel, state) with the readout deferred to a reduce-scatter (K3's
// layout) issues about twice the instructions per state and step: at l20
// training it ran this scan at 0.86 ms against this layout's 0.54 ms
// (PERF.md).
//
// What bounds it on an H100: the scan's exp2 per state (1.6e9 at l20,
// 256x512x768x16: about 0.4 ms on the special-function units) ahead of the
// fp32 FMAs (~2.2e10 flops with the x_proj product: 0.33 ms at 67 TFLOP/s)
// and of the bytes xi and y must move (0.13 ms in bf16). The scan's issue
// rate and latency, not the exp2 alone, set its pace (scan_core.cuh).
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
  int K, J;
};

// (b)'s input policy for scan_core.cuh's scan_fwd_kernel: xg by the conv
// from a window of xi taps carried across chunks, the B | C | dt_lr rows
// from (a)'s dbc. KT: registers for the conv taps (K <= KT; the K given taps
// in the conv's order, zero taps around them, which leaves every sum as it
// is).
template <typename T, int KT>
struct MixConvSrc {
  using Args = MixScanArgs;
  using Raw = float;
  static constexpr bool kFuse = true;
  static constexpr int TC = kFwdT;
  const T* x;
  const float* dbc;
  int L, D, J, d, reverse;
  bool live;
  float cb;
  // Taps in window order: the window's slot KT - 1 + k is this chunk's step
  // k in processing order (u[p] = x[time_of(p)], 0 before the start), so a
  // causal step reads slots k .. k + KT - 1 oldest first and a reverse step
  // reads them newest first, each in the conv's order.
  float wt[KT], win[KT - 1 + TC];
  __device__ MixConvSrc(const Args& m, const ScanFwdArgs& a, long long row, int d_, bool live_)
      : L(a.L), D(a.D), J(m.J), d(d_), reverse(a.reverse), live(live_) {
    x = static_cast<const T*>(m.xi) + row * L * D;
    dbc = m.dbc + row * L * J;
    const int K = m.K;
    cb = live ? m.conv_b[d] : 0.f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float v = 0.f;
      if (live) {
        if (!reverse && j >= KT - K) v = m.conv_w[(long long)d * K + j - (KT - K)];
        if (reverse && j < K) v = m.conv_w[(long long)d * K + K - 1 - j];
      }
      wt[j] = v;
    }
#pragma unroll
    for (int j = 0; j < KT - 1; ++j) win[j] = 0.f;
  }
  __device__ float row(long long t, int j) const { return dbc[t * J + j]; }
  __device__ void prefetch(int) {}
  // The chunk's xg: the conv of each step in order, then the window moves on.
  __device__ void x_chunk(int p0, float (&xv)[TC]) {
#pragma unroll
    for (int k = 0; k < TC; ++k) {
      const int p = p0 + k;
      win[KT - 1 + k] =
          (live && p < L) ? to_f(x[(long long)(reverse ? L - 1 - p : p) * D + d]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < TC; ++k) {
      float s = cb;
      if (!reverse) {
#pragma unroll
        for (int j = 0; j < KT; ++j) s = fmaf(win[k + j], wt[j], s);
      } else {
#pragma unroll
        for (int j = 0; j < KT; ++j) s = fmaf(win[k + KT - 1 - j], wt[j], s);
      }
      xv[k] = silu_xg(s);
    }
#pragma unroll
    for (int j = 0; j < KT - 1; ++j) win[j] = win[TC + j];
  }
};

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
  ScanFwdArgs a;
  a.y = y; a.A = A; a.Dskip = Dskip; a.dt_bias = dt_bias; a.wdt = wdt;
  a.hb = hb; a.h0 = nullptr; a.hfin = nullptr;
  a.L = L; a.D = D; a.R = R; a.reverse = reverse; a.hbc = hbc > 0 ? hbc : 1;
  const MixScanArgs m{xi, conv_w, conv_b, dbc, K, J};
  return K <= 4 ? launch_scan_fwd<T, MixConvSrc<T, 4>>(a, m, N, Bn, s)
                : launch_scan_fwd<T, MixConvSrc<T, kMaxK>>(a, m, N, Bn, s);
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
