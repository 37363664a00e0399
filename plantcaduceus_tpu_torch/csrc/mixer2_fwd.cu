// K5 — the Mamba-2 mixer interior, one direction.
//
// Replaces plantcaduceus_tpu/ops/pallas_mixer2.py::_fused_kernel with
// _conv_acc (launched at pallas_mixer2.py:179 through _interior_pallas_call /
// mamba2_mixer_interior):
//   xc, Bc, Cc = silu(depthwise conv K taps + bias) of xi, Braw, Craw
//                (causal, or anticausal for reverse; taps and biases rounded
//                to xi's dtype, sums in float32)
//   y          = K4's chunk core (ssd_core.cuh) over xc, dt, Bc, Cc, in float32
//   u          = rmsnorm(y * silu(z)) * nw over d_inner, cast to xi's dtype.
// The training variant (emit_residuals, a template parameter kRes) also
// writes what K6 (ssd_bwd.cu, pre_silu mode) and the gated-norm adjoint
// need: the pre-SiLU conv accumulators accx, accB, accC and the pre-gate y
// (with the D-skip), all in xi's dtype as the TPU kernel emits them, and the
// float32 chunk-entry states fentry [R, L/128, N, d_inner] (ssd_core.cuh).
//
// The TPU kernel walks the chunks of a row in order, carries the conv's K-1
// halo in scratch and normalises each [T, d_inner] tile in VMEM. On the GPU a
// block owns one (row, head) (see ssd_core.cuh), and the RMS norm reduces
// over all heads' blocks, so K5 is three kernels on one stream:
//  (0) conv_silu_kernel, one thread per (row, channel, 32 steps): xc, Bc
//      and Cc in float32 (scratch from the wrapper). It reads the K-1 rows
//      before its first step straight from global memory (t-3..t-1, or
//      t+1..t+3 for reverse, zero past the sequence's edges), so no halo is
//      carried. Evaluating the conv inside (a), wherever the core reads a
//      value, would compute it six times per element (x three times, B
//      twice, C once, for every head of the group), bound by load latency
//      at one block per SM: on the H100 that made K5 2.4x slower (PERF.md).
//  (a) mixer2_head_kernel, per (row, head): the chunk core over the float32
//      xc, Bc, Cc, then the gate; writes u = y * silu(z) in float32 and, per
//      (row, t, head), two partial sums of u^2 over the head's P channels
//      (one per warp column half; each in a fixed order: per thread, then a
//      shuffle tree).
//  (b) gated_norm_kernel, per (row, t): the 2H partial sums in order (no
//      atomics, so two launches give equal bits), rsqrt, * nw, cast.
//
// What bounds it on an H100: the bytes of xi, z, Braw, Craw, dt in and u out
// (0.2 GB in bf16 at the l20-ssd scoring shape, 256 x 512 x 768) ahead of the
// core's products (about 82 GFLOP: 0.08 ms on the bf16 tensor cores). This
// version adds the float32 scratch (xc, Bc, Cc and u: ~1 GB written and read
// at l20-ssd).
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the scratch comes from the wrapper) and returns cudaGetLastError().

#include "ssd_core.cuh"

namespace pc {

constexpr int kMaxTaps = 8;
constexpr int kNormRows = 8;   // (row, t) pairs per block of stage (b), a warp each
constexpr int kConvThreads = 256;  // channels per block of stage (0)
constexpr int kConvSteps = 32;     // time steps per thread of stage (0)

// (0): out[r, t, c] = silu(sum_k in[r, t - dir*(K-1-k), c] * w[c, k] + b[c])
// in float32, dir = +1 (causal) or -1 (anticausal): the TPU kernel's tap
// order (pallas_mixer2.py:_conv_acc); tap K-1 is the current step either
// way. A thread owns one channel and walks kConvSteps steps in direction
// dir, keeping the K inputs of the current output in registers, so each
// input is read once per walk.
// With kRes the pre-SiLU sum (bias included) also goes to acc_out in T.
template <typename T, bool kRes>
__global__ void __launch_bounds__(kConvThreads) conv_silu_kernel(
    const T* __restrict__ in, const float* __restrict__ w, const float* __restrict__ b,
    float* __restrict__ out, T* __restrict__ acc_out, int L, int C, int K, int reverse) {
  const int c = blockIdx.x * kConvThreads + threadIdx.x;
  if (c >= C) return;
  const long long row = (long long)blockIdx.z * L * C;
  const int dir = reverse ? -1 : 1;
  const int first = reverse ? min(L, (int)(blockIdx.y + 1) * kConvSteps) - 1
                            : (int)blockIdx.y * kConvSteps;
  const int steps = min(kConvSteps, L - (int)blockIdx.y * kConvSteps);
  float wk[kMaxTaps], win[kMaxTaps];
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) {
    wk[k] = k < K ? w[c * K + k] : 0.f;
    const int s = first - dir * (K - 1 - k);  // the inputs before the first output
    win[k] = (k < K - 1 && s >= 0 && s < L) ? to_f(in[row + (long long)s * C + c]) : 0.f;
  }
  const float bias = b[c];
  for (int i = 0, t = first; i < steps; ++i, t += dir) {
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k)
      if (k == K - 1) win[k] = to_f(in[row + (long long)t * C + c]);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k)
      if (k < K) acc = fmaf(win[k], wk[k], acc);
    acc += bias;
    if constexpr (kRes) acc_out[row + (long long)t * C + c] = from_f<T>(acc);
    out[row + (long long)t * C + c] = acc / (1.f + expf(-acc));
#pragma unroll
    for (int k = 0; k + 1 < kMaxTaps; ++k)
      if (k + 1 < K) win[k] = win[k + 1];
  }
}

// The core's values for one (row, head): the float32 conv outputs. With
// kRes, out() also stores the pre-gate y in T.
template <typename T, bool kRes>
struct Mixer2Src {
  const float* xc;  // the row's [L, di], at head h's first channel
  const float* Bc;  // the row's [L, NG*N], at group g's first column
  const float* Cc;
  const T* dtr;     // the row's [L, H], at column h
  const T* z;       // the row's [L, di], at head h's first channel
  float* u;         // as z, float32
  float* part;      // the row's [L, H, kSsdParts] sums of u^2, at head h
  T* yres;          // as z (kRes)
  int di, NGN, H;
  float D;
  __device__ float x(int t, int p) const { return xc[(long long)t * di + p]; }
  __device__ float b(int t, int n) const { return Bc[(long long)t * NGN + n]; }
  __device__ float c(int t, int n) const { return Cc[(long long)t * NGN + n]; }
  __device__ float dt(int t) const { return to_f(dtr[(long long)t * H]); }
  __device__ void out(const float (&acc)[4][16], int t0, const Tile& tl) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + tl.row(i);
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int p = tl.col(j);
        const float y = acc[i][j] + x(t, p) * D;
        if constexpr (kRes) yres[(long long)t * di + p] = from_f<T>(y);
        const float zf = to_f(z[(long long)t * di + p]);
        const float v = y * (zf / (1.f + expf(-zf)));
        u[(long long)t * di + p] = v;
        ss = fmaf(v, v, ss);
      }
      // the row's 16 columns of this warp lie in the 4 lanes of a quad
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      if (tl.q == 0) part[(long long)t * H * kSsdParts + tl.part()] = ss;
    }
  }
};

template <typename T, bool kRes>
__global__ void __launch_bounds__(kSsdThreads, 1) mixer2_head_kernel(
    const float* __restrict__ xc, const float* __restrict__ Bc, const float* __restrict__ Cc,
    const T* __restrict__ dt, const T* __restrict__ z, const float* __restrict__ A,
    const float* __restrict__ Dskip, const float* __restrict__ dt_bias, float* __restrict__ u,
    float* __restrict__ part, float* __restrict__ fe, T* __restrict__ yres, int L, int H,
    int NG, int reverse) {
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  const int h = blockIdx.x;
  const long long r = blockIdx.y;
  Mixer2Src<T, kRes> src;
  src.H = H;
  src.di = H * kSsdP;
  src.NGN = NG * kSsdN;
  const long long xoff = r * L * src.di + h * kSsdP;
  const long long bcoff = r * L * src.NGN + (h / (H / NG)) * kSsdN;
  src.xc = xc + xoff;
  src.z = z + xoff;
  src.u = u + xoff;
  src.Bc = Bc + bcoff;
  src.Cc = Cc + bcoff;
  src.dtr = dt + r * L * H + h;
  src.part = part + r * L * H * kSsdParts + h * kSsdParts;
  src.yres = kRes ? yres + xoff : nullptr;
  src.D = Dskip[h];
  float* fer = kRes ? fe + r * (L / kSsdT) * kSsdN * src.di + h * kSsdP : nullptr;
  ssd_head<T, kRes>(src, A[h], dt_bias[h], L, reverse, ssd_smem, fer, src.di);
}

template <typename T>
__global__ void __launch_bounds__(32 * kNormRows) gated_norm_kernel(
    const float* __restrict__ u, const float* __restrict__ part, const float* __restrict__ nw,
    T* __restrict__ out, long long rows, int di, int H, float eps) {
  const long long row = (long long)blockIdx.x * kNormRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float ss = 0.f;
  for (int h = 0; h < H * kSsdParts; ++h) ss += part[row * H * kSsdParts + h];
  const float rs = rsqrtf(ss / (float)di + eps);
  const float* ur = u + row * di;
  T* o = out + row * di;
  for (int c = lane; c < di; c += 32) o[c] = from_f<T>(ur[c] * rs * nw[c]);
}

template <typename T, bool kRes>
cudaError_t launch_conv_silu(const void* in, const float* w, const float* b, float* out,
                             void* acc_out, int R, int L, int C, int K, int reverse,
                             cudaStream_t s) {
  const dim3 grid((C + kConvThreads - 1) / kConvThreads, (L + kConvSteps - 1) / kConvSteps, R);
  conv_silu_kernel<T, kRes><<<grid, kConvThreads, 0, s>>>(
      static_cast<const T*>(in), w, b, out, static_cast<T*>(acc_out), L, C, K, reverse);
  return cudaGetLastError();
}

template <typename T, bool kRes>
cudaError_t launch_mixer2(const void* xi, const void* z, const void* Bm, const void* Cm,
                          const void* dt, const float* cxw, const float* cxb, const float* cbw,
                          const float* cbb, const float* ccw, const float* ccb,
                          const float* nw, const float* A, const float* Dskip,
                          const float* dt_bias, float* xc, float* Bc, float* Cc, float* u,
                          float* part, void* out, void* accx, void* accB, void* accC,
                          float* fe, void* yres, int R, int L, int H, int NG, int K,
                          int reverse, float eps, cudaStream_t s) {
  if (K > kMaxTaps) return cudaErrorInvalidValue;
  const long long rows = (long long)R * L;
  const int di = H * kSsdP, NGN = NG * kSsdN;
  cudaError_t e = launch_conv_silu<T, kRes>(xi, cxw, cxb, xc, accx, R, L, di, K, reverse, s);
  if (e != cudaSuccess) return e;
  e = launch_conv_silu<T, kRes>(Bm, cbw, cbb, Bc, accB, R, L, NGN, K, reverse, s);
  if (e != cudaSuccess) return e;
  e = launch_conv_silu<T, kRes>(Cm, ccw, ccb, Cc, accC, R, L, NGN, K, reverse, s);
  if (e != cudaSuccess) return e;
  const size_t smem = ssd_smem_bytes<T>();
  e = cudaFuncSetAttribute(mixer2_head_kernel<T, kRes>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  mixer2_head_kernel<T, kRes><<<dim3(H, R), kSsdThreads, smem, s>>>(
      xc, Bc, Cc, static_cast<const T*>(dt), static_cast<const T*>(z), A, Dskip, dt_bias, u,
      part, fe, static_cast<T*>(yres), L, H, NG, reverse);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gated_norm_kernel<T><<<(unsigned)((rows + kNormRows - 1) / kNormRows), 32 * kNormRows, 0, s>>>(
      u, part, nw, static_cast<T*>(out), rows, di, H, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mixer2_any(const void* xi, const void* z, const void* Bm, const void* Cm,
                              const void* dt, const float* cxw, const float* cxb,
                              const float* cbw, const float* cbb, const float* ccw,
                              const float* ccb, const float* nw, const float* A,
                              const float* Dskip, const float* dt_bias, float* xc, float* Bc,
                              float* Cc, float* u, float* part, void* out, void* accx,
                              void* accB, void* accC, float* fe, void* yres, int R, int L,
                              int H, int NG, int K, int reverse, float eps, cudaStream_t s) {
  if (accx)
    return launch_mixer2<T, true>(xi, z, Bm, Cm, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw, A,
                                  Dskip, dt_bias, xc, Bc, Cc, u, part, out, accx, accB, accC,
                                  fe, yres, R, L, H, NG, K, reverse, eps, s);
  return launch_mixer2<T, false>(xi, z, Bm, Cm, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw, A,
                                 Dskip, dt_bias, xc, Bc, Cc, u, part, out, accx, accB, accC,
                                 fe, yres, R, L, H, NG, K, reverse, eps, s);
}

}  // namespace pc

// P = N = chunk = 128, L % 128 == 0 and NG | H are the wrapper's to check.
// Conv taps and biases arrive as float32 values already rounded to xi's
// dtype; xc [R, L, di], Bc and Cc [R, L, NG*N], u [R, L, di] and part [R, L,
// H, 2] are float32 scratch. The residuals accx [R, L, di], accB, accC [R,
// L, NG*N], yres [R, L, di] (xi's dtype) and fentry [R, L/128, N, di]
// (float32) are all given for the training variant, all null otherwise.
extern "C" int pc_mixer2_fwd(const void* xi, const void* z, const void* Bm, const void* Cm,
                             const void* dt, const float* cxw, const float* cxb,
                             const float* cbw, const float* cbb, const float* ccw,
                             const float* ccb, const float* nw, const float* A,
                             const float* Dskip, const float* dt_bias, float* xc, float* Bc,
                             float* Cc, float* u, float* part, void* out, void* accx,
                             void* accB, void* accC, float* fentry, void* yres, int R, int L,
                             int H, int NG, int K, int reverse, float eps, int bf16,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pc::launch_mixer2_any<__nv_bfloat16>(
        xi, z, Bm, Cm, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw, A, Dskip, dt_bias, xc, Bc, Cc, u,
        part, out, accx, accB, accC, fentry, yres, R, L, H, NG, K, reverse, eps, s);
  return pc::launch_mixer2_any<float>(xi, z, Bm, Cm, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw, A,
                                      Dskip, dt_bias, xc, Bc, Cc, u, part, out, accx, accB,
                                      accC, fentry, yres, R, L, H, NG, K, reverse, eps, s);
}
