// K5 — the Mamba-2 mixer interior, one direction.
//
// Replaces plantcaduceus_tpu/ops/pallas_mixer2.py::_fused_kernel with
// _conv_acc (launched at pallas_mixer2.py:179 through _interior_pallas_call /
// mamba2_mixer_interior):
//   xc, Bc, Cc = silu(depthwise conv K taps + bias) of xi, Braw, Craw
//                (causal, or anticausal for reverse; taps and biases rounded
//                to xi's dtype, sums in float32)
//   y          = K4's chunk math (ssd_core.cuh) over xc, dt, Bc, Cc, float32
//   u          = rmsnorm(y * silu(z)) * nw over d_inner, cast to xi's dtype.
// The training variant (emit_residuals, a template parameter kRes) also
// writes what K6 (ssd_bwd.cu, pre_silu mode) and the gated-norm adjoint
// need: the pre-SiLU conv accumulators accx, accB, accC and the pre-gate y
// (with the D-skip), all in xi's dtype as the TPU kernel emits them, and the
// float32 chunk-entry states fentry [R, L/128, N, d_inner].
//
// The TPU kernel walks the chunks of a row in order with the state of all
// heads in VMEM. Here the only serial part is the state's recurrence, and it
// is elementwise once each chunk's increment is known, so K5 is five kernels
// on one stream, with no atomics (two launches give equal bits):
//  (-) mixer2_act_kernel, per (row, chunk, group): SiLU of the B and C convs
//      once, into copies in xi's dtype (scratch Ba, Ca) that every head of
//      the group stages; the pre-SiLU accB, accC with kRes.
//  (a)-(c) ssd_chunk.cuh's state, pass and chunk kernels, the SSD forward
//      K4 also runs, with this file's Mix2Pol as their policy: x is the
//      SiLU of xi's conv, staged straight into the tiles (each thread walks
//      eight steps of eight channels with the taps and its input rows in
//      registers, 16-byte loads, all issued first), so nothing of it reaches
//      device memory but accx; the chunk kernel's epilogue is the gate v = y
//      silu(z) into the float32 scratch u and the sum of v^2 over the head's
//      P channels per step (each in a fixed order). The state buffer fe is
//      fentry in the training variant, scratch otherwise. (Evaluating the
//      conv wherever the chunk core reads a value, with scalar loads at one
//      block per SM, runs 2.4x slower than a float32 pre-pass on the H100;
//      PERF.md.)
//  (d) gated_norm_kernel, per (row, t): the heads' sums of v^2 in head order,
//      rsqrt, * nw, cast. The norm spans all heads' channels, so a per-head
//      block cannot finish it; u makes one float32 round trip. (Finishing it
//      in (c) with the H heads' blocks as one thread-block cluster, the sums
//      exchanged through distributed shared memory, runs slower on the H100:
//      PERF.md.)
//
// Numerics as ssd_core.cuh: every decay, the state and every sum in float32;
// product operands in E (bfloat16 for bfloat16 inputs, else float32),
// the state rounded to E only as the operand of C S; segment sums masked
// before exp2. The float32 variant keeps FMA products (no TF32). Conv taps
// and biases are rounded to xi's dtype here, the sums in float32. SiLU uses
// the fast exponential and division (a few float32 ulps from torch's).
//
// What bounds it on an H100: the bytes of xi, z, Braw, Craw, dt in and u out
// (0.2 GB in bf16 at the l20-ssd scoring shape, 256 x 512 x 768) ahead of the
// products (~82 GFLOP: 0.08 ms on the bf16 tensor cores). This design adds
// float32 traffic: the state buffer (written by (a), read and written by (b),
// read by (c): about 1.3 GB at l20-ssd scoring, 0.33 GB at training, where
// fentry must be written anyway) and u's round trip (0.4 GB each way at
// scoring). (c) runs one block of eight warps per SM (197 KB of shared
// memory), so its staging, products and epilogue do not overlap.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the scratch comes from the wrapper) and returns cudaGetLastError().

#include "ssd_chunk.cuh"

namespace pc {

constexpr int kMaxTaps = 8;
constexpr int kNormRows = 8;      // (row, t) pairs per block of (d), a warp each

// SiLU with the fast exponential and division (within a few float32 ulps
// of torch's silu).
__device__ __forceinline__ float silu_f(float a) { return __fdividef(a, 1.f + __expf(-a)); }

// The pre-SiLU conv of a 128-step x 128-channel block at steps t0..t0+127:
// acc(r, c) = sum_k in[t - dir*(K-1-k), c] * w[c, k] + b[c] for t = t0 + r,
// dir = +1 (causal) or -1 (reverse), inputs past the sequence's edges 0: the
// TPU kernel's tap order (pallas_mixer2.py:_conv_acc), tap K-1 the current
// step. `in` is the row's [L, C] input at the block's first channel, w its
// [C, K] float32 taps and b its biases, both at that channel, each rounded
// to T here. Thread u owns channels 8(u % 16) .. +8 and walks the eight steps
// 8(u / 16) .. +8 in direction dir with the KT >= K taps (the K given ones
// last, zeros before them, which leaves every sum bit for bit as it is),
// its KT + 7 input rows loaded into registers before the first is used;
// out(r, c0, acc) receives the eight sums of (r, c0 .. c0+7). Every thread
// calls it.
template <int KT, typename T, class Out>
__device__ __forceinline__ void conv_block(const T* __restrict__ in, int C,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b, int K, int L, int t0,
                                           int reverse, Out out) {
  const int c0 = (threadIdx.x & 15) * 8, run = threadIdx.x >> 4;
  const int dir = reverse ? -1 : 1;
  float wk[KT][8], bias[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    bias[e] = round_to<T>(b[c0 + e]);
#pragma unroll
    for (int k = 0; k < KT; ++k)
      wk[k][e] = k < KT - K ? 0.f : round_to<T>(w[(c0 + e) * K + k - (KT - K)]);
  }
  const int r0 = reverse ? 8 * run + 7 : 8 * run;  // the first row walked
  // every input row of the walk, loaded before the first is used
  constexpr int NW = KT - 1 + 8, V = std::is_same<T, float>::value ? 2 : 1;
  uint4 raw[NW][V];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int s = t0 + r0 + dir * (j - (KT - 1));
#pragma unroll
    for (int v = 0; v < V; ++v)
      raw[j][v] = (s >= 0 && s < L)
                      ? __ldg(reinterpret_cast<const uint4*>(in + (long long)s * C + c0) + v)
                      : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < KT; ++k)
        a = fmaf(vec_at<T>(raw[i + k][e * V / 8], e % (8 / V)), wk[k][e], a);
      acc[e] = a + bias[e];
    }
    out(r0 + dir * i, c0, acc);
  }
}

// The arguments every kernel of a launch shares: ssd_chunk.cuh's fields
// (those of SsdChunkArgs<T>: x = xi before its conv, Bs, Cs = the SiLU of the
// B and C convs) and K5's own. Flat, in this order: derived from
// SsdChunkArgs (its int fields in the middle of the parameter block), the
// act kernel compiled to other SASS from the same source and ran 2-8%
// slower on the H100 (PERF.md).
template <typename T>
struct Mixer2Args {
  const T* x;    // [R, L, di] xi
  const T* z;    // [R, L, di]
  const T* Bm;   // [R, L, NG*N] raw (before the conv)
  const T* Cm;
  const T* dt;   // [R, L, H] raw
  const float *cxw, *cxb, *cbw, *cbb, *ccw, *ccb;  // taps [C, K] and biases
  const float *A, *Dskip, *dt_bias;                // [H]
  float* fe;     // [R, L/128, N, di]: increments, then the entry states
  float* tot;    // [R, L/128, H] chunk total decays
  float* u;      // [R, L, di] float32 v = y * silu(z)
  float* part;   // [R, L, H, parts] sums of v^2
  T *Bs, *Cs;    // [R, L, NG*N] SiLU of the B and C convs
  T *accx, *accB, *accC, *yres;  // residuals (kRes)
  int L, H, NG, K, reverse;
};

// (-) mixer2_act_kernel, per (row, chunk, group): SiLU of the B and C convs
// once, into T copies (Bs, Cs) that every head of the group stages (they
// are product operands, so rounding them to T is the rounding the tiles
// would do); the pre-SiLU accumulators accB, accC with kRes.
template <typename T, bool kRes, int KT>
__global__ void __launch_bounds__(kSsdThreads) mixer2_act_kernel(Mixer2Args<T> a) {
  const int g = blockIdx.x, t0 = blockIdx.y * kSsdT;
  const long long r = blockIdx.z;
  const int NGN = a.NG * kSsdN;
  const long long o0 = r * a.L * NGN + g * kSsdN;  // (row r, step 0, group g)
  auto act = [&](const T* in, const float* w, const float* b, T* out, T* acc) {
    conv_block<KT>(in + o0, NGN, w + g * kSsdN * a.K, b + g * kSsdN, a.K, a.L, t0, a.reverse,
                   [&](int i, int c0, const float (&v)[8]) {
                     const long long o = o0 + (long long)(t0 + i) * NGN + c0;
                     if constexpr (kRes) store8(acc + o, v);
                     float y[8];
#pragma unroll
                     for (int e = 0; e < 8; ++e) y[e] = silu_f(v[e]);
                     store8(out + o, y);
                   });
  };
  act(a.Bm, a.cbw, a.cbb, a.Bs, a.accB);
  act(a.Cm, a.ccw, a.ccb, a.Cs, a.accC);
}

// z at a thread's accumulator positions, loaded ahead of the epilogue
// (before the last product, so the loads overlap it): raw pairs.
template <typename T, class Fr>
struct ZPairs {
  using W = std::conditional_t<std::is_same<T, float>::value, float2, uint32_t>;
  W w[Fr::NI][Fr::NJ];
  __device__ void load(const T* z, const Fr& fr, int di) {
#pragma unroll
    for (int i = 0; i < Fr::NI; ++i)
#pragma unroll
      for (int j = 0; j < Fr::NJ; ++j)
        w[i][j] = __ldg(reinterpret_cast<const W*>(z + (long long)fr.row(i) * di + fr.col(j)));
  }
  __device__ float2 get(int i, int j) const {
    if constexpr (std::is_same<T, float>::value) return w[i][j];
    else return make_float2(__uint_as_float(w[i][j] << 16), __uint_as_float(w[i][j] & 0xffff0000u));
  }
};

// The epilogue of (c) over one thread's part of the [T, P] output, in either
// accumulator layout (Fr): y = acc + D x (x from the float32 tile xs, row
// stride xld), the residual y (kRes), v = y silu(z) into u, and per row the
// sum of v^2 over this thread's columns, then its quad, into part at the
// layout's column part. o0: the element offset of (row r, step t0, head h's
// first channel) in the [R, L, di] tensors; p0: that of (r, t0, h, 0) in part.
template <typename T, bool kRes, class Fr, class Acc>
__device__ __forceinline__ void mixer2_epilogue(const Mixer2Args<T>& a, const Fr& fr, Acc& acc,
                                                const ZPairs<T, Fr>& zp, const float* xs,
                                                int xld, float D, long long o0, long long p0,
                                                int di) {
  float* u = a.u + o0;
#pragma unroll
  for (int i = 0; i < Fr::NI; ++i) {
    const int t = fr.row(i);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < Fr::NJ; ++j) {
      const int p = fr.col(j);
      const float2 zz = zp.get(i, j);
      float y[2], v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        y[e] = Fr::at(acc, i, j, e) + xs[t * xld + p + e] * D;
        v[e] = y[e] * silu_f(e ? zz.y : zz.x);
        ss = fmaf(v[e], v[e], ss);
      }
      if constexpr (kRes) {
        T* yr = a.yres + o0 + (long long)t * di + p;
        if constexpr (std::is_same<T, float>::value)
          *reinterpret_cast<float2*>(yr) = make_float2(y[0], y[1]);
        else
          *reinterpret_cast<uint32_t*>(yr) = pack2(__float2bfloat16(y[0]), __float2bfloat16(y[1]));
      }
      *reinterpret_cast<float2*>(u + (long long)t * di + p) = make_float2(v[0], v[1]);
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    if (fr.q == 0) a.part[p0 + (long long)t * a.H * Fr::kParts + fr.part()] = ss;
  }
}

// ssd_chunk.cuh's policy for K5: x is SiLU(conv of xi), the pre-SiLU conv
// written to accx in the chunk kernel of the training variant; z is loaded
// ahead of the epilogue, which gates and sums squares (mixer2_epilogue).
template <typename T_, bool kRes, int KT>
struct Mix2Pol {
  using T = T_;
  using Args = Mixer2Args<T>;
  template <bool kChunk, class Out>
  static __device__ __forceinline__ void x_block(const Args& a, long long r, int h, int t0,
                                                 Out out) {
    const int di = a.H * kSsdP;
    const long long o0 = (r * a.L + t0) * di + h * kSsdP;
    conv_block<KT>(a.x + r * a.L * di + h * kSsdP, di, a.cxw + h * kSsdP * a.K,
                   a.cxb + h * kSsdP, a.K, a.L, t0, a.reverse,
                   [&](int i, int c0, const float (&v)[8]) {
                     if constexpr (kChunk && kRes) store8(a.accx + o0 + (long long)i * di + c0, v);
                     float x[8];
#pragma unroll
                     for (int e = 0; e < 8; ++e) x[e] = silu_f(v[e]);
                     out(i, c0, x);
                   });
  }
  template <class Fr>
  struct Ahead {
    ZPairs<T, Fr> zp;
    __device__ void load(const Args& a, const Fr& fr, long long o0) {
      zp.load(a.z + o0, fr, a.H * kSsdP);
    }
  };
  template <class Fr, class Acc>
  static __device__ __forceinline__ void epilogue(const Args& a, const Fr& fr, Acc& acc,
                                                  const Ahead<Fr>& ah, const float* xs, int xld,
                                                  float D, long long o0, long long p0) {
    mixer2_epilogue<T, kRes>(a, fr, acc, ah.zp, xs, xld, D, o0, p0, a.H * kSsdP);
  }
};

// (d): per (row, t): the sums of v^2 of all heads in order, rsqrt, * nw, cast.
template <typename T>
__global__ void __launch_bounds__(32 * kNormRows) gated_norm_kernel(
    const float* __restrict__ u, const float* __restrict__ part, const float* __restrict__ nw,
    T* __restrict__ out, long long rows, int di, int nparts, float eps) {
  const long long row = (long long)blockIdx.x * kNormRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float ss = 0.f;
  for (int h = 0; h < nparts; ++h) ss += part[row * nparts + h];
  const float rs = rsqrtf(ss / (float)di + eps);
  const float* ur = u + row * di;
  T* o = out + row * di;
  for (int c = lane; c < di; c += 32) o[c] = from_f<T>(ur[c] * rs * nw[c]);
}

template <typename T, bool kRes, int KT>
cudaError_t launch_mixer2(const Mixer2Args<T>& a, const float* nw, T* out, int R, float eps,
                          cudaStream_t s) {
  const int nc = a.L / kSsdT, di = a.H * kSsdP;
  mixer2_act_kernel<T, kRes, KT><<<dim3(a.NG, nc, R), kSsdThreads, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_ssd_chunked<Mix2Pol<T, kRes, KT>>(a, R, s);
  if (e != cudaSuccess) return e;
  constexpr int parts = std::is_same<T, bf16>::value ? WgFrag::kParts : TileFrag::kParts;
  const long long rows = (long long)R * a.L;
  gated_norm_kernel<T><<<(unsigned)((rows + kNormRows - 1) / kNormRows), 32 * kNormRows, 0, s>>>(
      a.u, a.part, nw, out, rows, di, a.H * parts, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* xi, const void* z, const void* Bm, const void* Cm,
                         const void* dt, const float* cxw, const float* cxb, const float* cbw,
                         const float* cbb, const float* ccw, const float* ccb, const float* nw,
                         const float* A, const float* Dskip, const float* dt_bias, float* fe,
                         float* tot, float* u, float* part, void* Ba, void* Ca, void* out,
                         void* accx, void* accB, void* accC, void* yres, int R, int L, int H,
                         int NG, int K, int reverse, float eps, cudaStream_t s) {
  if (K < 1 || K > kMaxTaps) return cudaErrorInvalidValue;
  Mixer2Args<T> a;
  a.x = static_cast<const T*>(xi);
  a.z = static_cast<const T*>(z);
  a.Bm = static_cast<const T*>(Bm);
  a.Cm = static_cast<const T*>(Cm);
  a.dt = static_cast<const T*>(dt);
  a.cxw = cxw; a.cxb = cxb; a.cbw = cbw; a.cbb = cbb; a.ccw = ccw; a.ccb = ccb;
  a.A = A; a.Dskip = Dskip; a.dt_bias = dt_bias;
  a.fe = fe; a.tot = tot; a.u = u; a.part = part;
  a.Bs = static_cast<T*>(Ba);
  a.Cs = static_cast<T*>(Ca);
  a.accx = static_cast<T*>(accx);
  a.accB = static_cast<T*>(accB);
  a.accC = static_cast<T*>(accC);
  a.yres = static_cast<T*>(yres);
  a.L = L; a.H = H; a.NG = NG; a.K = K; a.reverse = reverse;
  T* o = static_cast<T*>(out);
  const bool res = accx != nullptr;
  if (K <= 4)
    return res ? launch_mixer2<T, true, 4>(a, nw, o, R, eps, s)
               : launch_mixer2<T, false, 4>(a, nw, o, R, eps, s);
  return res ? launch_mixer2<T, true, kMaxTaps>(a, nw, o, R, eps, s)
             : launch_mixer2<T, false, kMaxTaps>(a, nw, o, R, eps, s);
}

}  // namespace pc

// P = N = chunk = 128, L % 128 == 0 and NG | H are the wrapper's to check.
// Conv taps and biases arrive as float32 (the kernel rounds them to xi's
// dtype). Float32: fe [R, L/128, N, di] (fentry in the training variant,
// scratch otherwise), tot [R, L/128, H], u [R, L, di] and part [R, L, H, 2]
// (scratch). Ba, Ca [R, L, NG*N] in xi's dtype (scratch). The residuals accx
// [R, L, di], accB, accC [R, L, NG*N] and yres [R, L, di] (xi's dtype) are
// all given for the training variant, all null otherwise.
extern "C" int pc_mixer2_fwd(const void* xi, const void* z, const void* Bm, const void* Cm,
                             const void* dt, const float* cxw, const float* cxb,
                             const float* cbw, const float* cbb, const float* ccw,
                             const float* ccb, const float* nw, const float* A,
                             const float* Dskip, const float* dt_bias, float* fe, float* tot,
                             float* u, float* part, void* Ba, void* Ca, void* out, void* accx,
                             void* accB, void* accC, void* yres, int R, int L, int H, int NG,
                             int K, int reverse, float eps, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pc::launch_typed<__nv_bfloat16>(xi, z, Bm, Cm, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw,
                                           A, Dskip, dt_bias, fe, tot, u, part, Ba, Ca, out,
                                           accx, accB, accC, yres, R, L, H, NG, K, reverse, eps,
                                           s);
  return pc::launch_typed<float>(xi, z, Bm, Cm, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw, A, Dskip,
                                 dt_bias, fe, tot, u, part, Ba, Ca, out, accx, accB, accC, yres,
                                 R, L, H, NG, K, reverse, eps, s);
}
