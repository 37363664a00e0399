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
// kernels on one stream:
//  (a) conv_xproj_kernel: a block owns (row, kTL time steps) across all of
//      D. It reads the K-1 halo rows straight from xi, computes xg one
//      shared-memory pass of kDC channels at a time, writes xg (fp32) and
//      sums xg @ W over D in registers; each output element is summed by one
//      thread in a fixed order, so results are deterministic (no atomics).
//  (b) the scan of scan_core.cuh over xg and the fp32 dt_lr/B/C rows.
//
// What bounds it on an H100: the scan's exp2 per state (1.6e9 at l20,
// 256x512x768x16: about 0.4 ms on the special-function units) ahead of the
// fp32 FMAs (~2.2e10 flops with the x_proj product: 0.33 ms at 67 TFLOP/s)
// and of the bytes xi and y must move (0.13 ms in bf16). The fp32 xg
// scratch and its re-read add ~0.8 GB of traffic at l20 (~0.24 ms) that a
// fused single-pass kernel would not; it is the first thing to remove when
// the kernel is made fast.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (xg and dbc scratch come from the wrapper) and returns
// cudaGetLastError().

#include "scan_core.cuh"

namespace pc {

constexpr int kMixThreads = 256;
constexpr int kTL = 32;       // time steps per block
constexpr int kDC = 32;       // channels per shared-memory pass
constexpr int kMaxOut = 16;   // x_proj outputs per thread: kTL*J <= 4096
constexpr int kMaxK = 8;      // conv taps

inline size_t mix_smem_bytes(int J) {
  return sizeof(float) * ((kTL + kMaxK - 1) * kDC + kTL * kDC + kDC * J);
}

// RES: the training variant, which also writes the pre-SiLU acc.
template <typename T, bool RES>
__global__ void __launch_bounds__(kMixThreads) conv_xproj_kernel(
    const T* __restrict__ xi, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ wx,
    float* __restrict__ xg, float* __restrict__ dbc, T* __restrict__ acc_out, int L,
    int D, int K, int J, int reverse) {
  extern __shared__ float smem[];
  float* sx = smem;                            // [kTL+K-1][kDC] xi window
  float* sxg = sx + (kTL + kMaxK - 1) * kDC;   // [kTL][kDC]
  float* sw = sxg + kTL * kDC;                 // [kDC][J]
  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int t0 = blockIdx.x * kTL;
  const T* xrow = xi + b * (long long)L * D;
  float* xgrow = xg + b * (long long)L * D;
  const int nout = kTL * J;
  const int win = kTL + K - 1;
  // causal: output t reads x[t-K+1 .. t]; anticausal: x[t .. t+K-1]
  const int tbase = reverse ? t0 : t0 - (K - 1);

  float acc[kMaxOut];
#pragma unroll
  for (int m = 0; m < kMaxOut; ++m) acc[m] = 0.f;

  for (int c0 = 0; c0 < D; c0 += kDC) {
    for (int i = tid; i < win * kDC; i += kMixThreads) {
      const int t = tbase + i / kDC, c = c0 + i % kDC;
      sx[i] = (t >= 0 && t < L && c < D) ? to_f(xrow[(long long)t * D + c]) : 0.f;
    }
    for (int i = tid; i < kDC * J; i += kMixThreads) {
      const int c = c0 + i / J;
      sw[i] = c < D ? wx[(long long)c * J + i % J] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kTL * kDC; i += kMixThreads) {
      const int tt = i / kDC, ch = i % kDC;
      const int t = t0 + tt, c = c0 + ch;
      float v = 0.f;
      if (t < L && c < D) {
        const float* w = conv_w + (long long)c * K;
        float s = conv_b[c];
        for (int k = 0; k < K; ++k)
          s = fmaf(sx[(tt + k) * kDC + ch], w[reverse ? K - 1 - k : k], s);
        v = s / (1.f + expf(-s));  // silu
        xgrow[(long long)t * D + c] = v;
        if constexpr (RES) acc_out[(b * L + t) * D + c] = from_f<T>(s);  // pre-SiLU
      }
      sxg[i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kMaxOut; ++m) {
      const int o = tid + m * kMixThreads;
      if (o < nout) {
        const int tt = o / J, j = o % J;
        float s = acc[m];
#pragma unroll 8
        for (int ch = 0; ch < kDC; ++ch) s = fmaf(sxg[tt * kDC + ch], sw[ch * J + j], s);
        acc[m] = s;
      }
    }
    __syncthreads();  // sx/sxg/sw are rewritten by the next pass
  }
#pragma unroll
  for (int m = 0; m < kMaxOut; ++m) {
    const int o = tid + m * kMixThreads;
    if (o < nout && t0 + o / J < L)
      dbc[(b * L + t0 + o / J) * J + o % J] = acc[m];
  }
}

template <typename T>
cudaError_t launch_mixer(const void* xi, const float* conv_w, const float* conv_b,
                         const float* wx, const float* wdt, const float* dt_bias,
                         const float* A, const float* Dskip, float* xg, float* dbc,
                         void* y, void* acc, float* hb, int Bn, int L, int D, int N,
                         int R, int K, int reverse, int hbc, cudaStream_t s) {
  const int J = R + 2 * N;
  dim3 grid((L + kTL - 1) / kTL, Bn);
  auto conv = acc ? conv_xproj_kernel<T, true> : conv_xproj_kernel<T, false>;
  conv<<<grid, kMixThreads, mix_smem_bytes(J), s>>>(
      static_cast<const T*>(xi), conv_w, conv_b, wx, xg, dbc, static_cast<T*>(acc), L, D,
      K, J, reverse);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ScanArgs a;
  a.x = xg; a.dt = dbc; a.B = dbc + R; a.C = dbc + R + N;
  a.A = A; a.Dskip = Dskip; a.dt_bias = dt_bias; a.wdt = wdt; a.y = y;
  a.hb = hb; a.hbc = hbc > 0 ? hbc : 1;
  a.L = L; a.D = D; a.R = R; a.reverse = reverse;
  a.dt_step = J; a.dt_row = (long long)L * J;
  a.bc_step = J; a.bc_row = (long long)L * J;
  return launch_scan<float, float, T, true>(a, N, Bn, s);
}

}  // namespace pc

// acc and hb are both null (inference) or both given (training residuals).
extern "C" int pc_mixer_fwd(const void* xi, const float* conv_w, const float* conv_b,
                            const float* wx, const float* wdt, const float* dt_bias,
                            const float* A, const float* Dskip, float* xg, float* dbc,
                            void* y, void* acc, float* hb, int Bn, int L, int D, int N,
                            int R, int K, int reverse, int bf16, int hbc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pc::launch_mixer<__nv_bfloat16>(xi, conv_w, conv_b, wx, wdt, dt_bias, A,
                                           Dskip, xg, dbc, y, acc, hb, Bn, L, D, N, R,
                                           K, reverse, hbc, s);
  return pc::launch_mixer<float>(xi, conv_w, conv_b, wx, wdt, dt_bias, A, Dskip, xg,
                                 dbc, y, acc, hb, Bn, L, D, N, R, K, reverse, hbc, s);
}
