// K6 — the SSD (Mamba-2) adjoint, one direction.
//
// Replaces plantcaduceus_tpu/ops/pallas_ssd.py::_bwd_kernel (launched at
// pallas_ssd.py:545 through _ssd_dir_bwd_kernel_call, which ssd_dir's custom
// VJP and the fused mixer's backward pallas_mixer2._interior_bwd call), in
// both its modes, a template parameter each: plain (x, B and C as given) and
// pre_silu (x, B and C are the fused mixer's pre-SiLU conv accumulators:
// SiLU re-applies here, SiLU' chains onto dx, dB and dC, and gx = sum_P g*x
// and dtp = dt' come back too). The math, chunk by chunk, is that of
// ops/ssd_bwd.py, the plain version this kernel is held to:
//   x~ = dt' x;  scores = (C B^T) * decay;  M = (g x~^T) * decay
//   dx~ = scores^T g + exp2(outof) B Rv         dx = dt' dx~ + D g
//   dB  = sum_h M^T C + exp2(outof) x~ Rv^T     dC = sum_h M B + (g exp2(into)) F^T
//   mass[r] = the sum of Q = (C B^T) * M over the pairs whose decay spans r
//           + the entry, exit and entry-x-exit terms (F, Rv)
//   ddt_raw = sigmoid(dt + dt_bias) (sum_P x dx~ + mass A)
//   Rv      = exp2(total) Rv + C^T (g exp2(into))     (chunks in backward order)
// with F the forward's chunk-entry states (fentry, from K4/K5's training
// variants) and Rv [N, P] the cotangent state.
//
// The TPU kernel walks a row's chunks opposite to the forward, keeps the
// cotangent state of the whole row [N, H*P] in VMEM and sums dB and dC over
// the group's heads in the chunk body. On the GPU a block owns (row, head),
// as in the forward (ssd_core.cuh): the group's heads' Rv would need 6 x 66
// KB at l20-ssd. So K6 is three kernels on one stream, and uses no atomics
// (two launches give equal bits):
//  (a) ssd_bwd_local_kernel, per (row, head, chunk), all chunks at once:
//      C B^T and g x~^T, the masked decays, and from them the chunk-local
//      parts: dx~ (into dx, as scratch), per-head dB and dC (float32 [R, L,
//      H, N] partials) and the chunk-local mass, which is a difference of
//      prefix sums of Q's column and row sums (the TPU kernel takes it as a
//      product with the mask, T^3 work).
//  (b) ssd_bwd_carry_kernel, per (row, head), the chunks in backward order
//      (the reverse direction from chunk 0, with no flipped copies): Rv
//      float32 in shared memory (66 KB, as K4 keeps S) against F read from
//      global memory as a product operand. It completes dx~, dB and dC,
//      writes dx, and takes the mass's boundary terms (prefix and suffix
//      sums by warp scans, and exp2(total) <Rv, F>) to write dmass and
//      ddt_raw (and gx, dtp).
//  (c) ssd_bwd_group_kernel, per output element: dB and dC as the sums of
//      the group's heads' partials in head order (times SiLU' in pre_silu).
//
// Products: the 128 x 128 x 128 block products of ssd_core.cuh (mma.sync on
// the tensor cores for bf16, FMA loops for fp32), nine per (row, head,
// chunk): five in (a), four in (b). Shared memory: (a) three [128][LD] tiles
// (203 KB fp32, 110 KB bf16), (b) Rv and two tiles (206 KB fp32, 144 KB
// bf16); one block per SM. Every exponent is masked before exp2.
//
// What bounds it on an H100 (l20-ssd training: 64 rows x 512, H 6): the
// bytes of x, g, B, C, dt and fentry in and dx, dB, dC, ddt, dmass out (0.35
// GB in bf16: 0.11 ms), ahead of the products (~53 GFLOP: 0.05 ms on the
// tensor cores); in fp32 the products bound it (0.8 ms at 67 TFLOP/s). This
// version also writes and reads its float32 partials (dx~, the per-head dB
// and dC, the chunk-local mass: ~0.5 GB at that shape).
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the partials come from the wrapper) and returns cudaGetLastError().

#include "ssd_core.cuh"

namespace pc {

constexpr int kGroupThreads = 256;

__device__ __forceinline__ float silu_f(float a) { return a / (1.f + expf(-a)); }

__device__ __forceinline__ float silu_grad_f(float a) {
  const float s = 1.f / (1.f + expf(-a));
  return s * (1.f + a * (1.f - s));
}

// One (row, head) block's values for absolute step t, float32: x, B and C
// (SiLU applied in pre_silu mode), the accumulator under x, the cotangent g
// and the raw dt.
template <typename T, bool kPre>
struct BwdSrc {
  const T* xr;   // the row's [L, H*P], at head h's first channel
  const T* gr;   // as xr
  const T* dtr;  // the row's [L, H], at column h
  const T* Br;   // the row's [L, NG*N], at group g's first column
  const T* Cr;
  int HP, H, NGN;
  __device__ float act(T v) const { return kPre ? silu_f(to_f(v)) : to_f(v); }
  __device__ float x(int t, int p) const { return act(xr[(long long)t * HP + p]); }
  __device__ float acc_x(int t, int p) const { return to_f(xr[(long long)t * HP + p]); }
  __device__ float g(int t, int p) const { return to_f(gr[(long long)t * HP + p]); }
  __device__ float dt(int t) const { return to_f(dtr[(long long)t * H]); }
  __device__ float b(int t, int n) const { return act(Br[(long long)t * NGN + n]); }
  __device__ float c(int t, int n) const { return act(Cr[(long long)t * NGN + n]); }
};

template <typename T, bool kPre>
__device__ __forceinline__ BwdSrc<T, kPre> bwd_src(const T* x, const T* g, const T* dt,
                                                   const T* B, const T* C, long long r, int h,
                                                   int L, int H, int NG) {
  BwdSrc<T, kPre> s;
  s.HP = H * kSsdP;
  s.H = H;
  s.NGN = NG * kSsdN;
  const long long xoff = r * L * s.HP + h * kSsdP;
  const long long boff = r * L * s.NGN + (h / (H / NG)) * kSsdN;
  s.xr = x + xoff;
  s.gr = g + xoff;
  s.dtr = dt + r * L * H + h;
  s.Br = B + boff;
  s.Cr = C + boff;
  return s;
}

// The sums over the 128 columns of each row of a block-wide 128 x 128 tile
// held in the Tile layout (f(i, j): the thread's value at row(i), col(j)):
// out[r] for r < 128, in a fixed order (the thread's 16 columns, its quad,
// then the two column halves). red: 2 * 128 floats. Every thread calls it;
// it ends synced.
template <class F>
__device__ __forceinline__ void row_sums(const Tile& tl, float* red, float* out, F f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) s += f(i, j);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (tl.q == 0) red[tl.part() * kSsdT + tl.row(i)] = s;
  }
  __syncthreads();
  if (threadIdx.x < kSsdT) out[threadIdx.x] = red[threadIdx.x] + red[kSsdT + threadIdx.x];
  __syncthreads();
}

// The sums over the 128 rows of each column, likewise (the thread's 4 rows,
// the 8 lanes of a column, then the four row quarters). red: 4 * 128 floats.
template <class F>
__device__ __forceinline__ void col_sums(const Tile& tl, float* red, float* out, F f) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) s += f(i, j);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (tl.g == 0) red[(tl.rb >> 5) * kSsdT + tl.col(j)] = s;
  }
  __syncthreads();
  if (threadIdx.x < kSsdT) {
    const int c = threadIdx.x;
    out[c] = ((red[c] + red[kSsdT + c]) + red[2 * kSsdT + c]) + red[3 * kSsdT + c];
  }
  __syncthreads();
}

// The sum of one value per thread over the block, in a fixed order (a
// shuffle tree, then the warps in order). red: 8 floats. Ends synced.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kSsdThreads / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// The inclusive prefix sum over threads 0..127 of v, in a fixed order: a
// scan in each warp, then the totals of the warps before in order (the form
// of ssd_core.cuh's cumsum). Every thread calls it (v of threads >= 128 is
// ignored); red: 4 floats. Ends synced.
__device__ __forceinline__ float scan128(float v, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid < kSsdT) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) red[w] = v;
  }
  __syncthreads();
  if (tid < kSsdT) {
    float base = 0.f;
    for (int q = 0; q < w; ++q) base += red[q];
    v = base + v;
  }
  __syncthreads();
  return v;
}

// Shared memory of (a): the decay vectors and reduction scratch (1344
// floats), then three [128][LD] tiles.
constexpr int kLocalFloats = 4 * kSsdT + 32 + 4 * kSsdT + 2 * kSsdT + 32;

template <typename T>
inline size_t bwd_local_smem() {
  return sizeof(float) * kLocalFloats + 3 * sizeof(T) * kSsdT * SsdLd<T>::v;
}

// (a): the chunk-local parts of one (row, head, chunk).
template <typename T, bool kPre>
__global__ void __launch_bounds__(kSsdThreads, 1) ssd_bwd_local_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ B,
    const T* __restrict__ C, const T* __restrict__ g, const float* __restrict__ A,
    const float* __restrict__ dt_bias, float* __restrict__ dxt, float* __restrict__ dBh,
    float* __restrict__ dCh, float* __restrict__ m_intra, int L, int H, int NG, int reverse) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  constexpr int LD = SsdLd<T>::v;
  const int h = blockIdx.x, t0 = blockIdx.y * kSsdT, tid = threadIdx.x;
  const long long r = blockIdx.z;
  const int HP = H * kSsdP;
  const auto src = bwd_src<T, kPre>(x, g, dt, B, C, r, h, L, H, NG);
  float* dtp = reinterpret_cast<float*>(bwd_smem);  // [T] dt'
  float* segb = dtp + kSsdT;                         // [T] sb
  float* into_e = segb + kSsdT;                      // [T] exp2(into)
  float* scale = into_e + kSsdT;                     // [T] exp2(outof)
  float* total_s = scale + kSsdT;                    // [1] total
  float* red = total_s + 32;                         // [4][T] reduction scratch
  float* rsum = red + 4 * kSsdT;                     // [T] row sums of Q
  float* csum = rsum + kSsdT;                        // [T] column sums of Q
  float* sred = csum + kSsdT;                        // [32] scan scratch
  T* t1 = reinterpret_cast<T*>(bwd_smem + sizeof(float) * kLocalFloats);
  T* t2 = t1 + kSsdT * LD;
  T* t3 = t2 + kSsdT * LD;
  const Tile tl;
  float accG[4][16], accX[4][16];

  // 1. the C and B tiles; dt' and the decay vectors.
  fill_tile<T>(t1, [&](int i, int n) { return src.c(t0 + i, n); });
  fill_tile<T>(t2, [&](int i, int n) { return src.b(t0 + i, n); });
  chunk_decays(src, t0, A[h] * kLog2e, dt_bias[h], reverse, dtp, segb, into_e, scale, total_s);
  // 2. GBC = C @ B^T
  zero(accG);
  block_mm<false, true, float>(accG, tl, t1, LD, t2, LD);
  __syncthreads();  // every read of C and B is done
  // 3. GXG = g @ x~^T
  fill_tile<T>(t1, [&](int i, int p) { return src.g(t0 + i, p); });
  fill_tile<T>(t2, [&](int i, int p) { return src.x(t0 + i, p) * dtp[i]; });
  __syncthreads();
  zero(accX);
  block_mm<false, true, float>(accX, tl, t1, LD, t2, LD);
  __syncthreads();  // every read of x~ is done
  // 4. the masked decays: the scores into t3, M into t2, Q = GBC * M into accG
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tl.row(i);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int s = tl.col(j);
      const bool keep = reverse ? t <= s : t >= s;
      const float se = exp2f(keep ? segb[t] - segb[s] : __uint_as_float(0xff800000u));
      const float m = accX[i][j] * se;
      t3[t * LD + s] = from_f<T>(accG[i][j] * se);
      t2[t * LD + s] = from_f<T>(m);
      accG[i][j] *= m;
    }
  }
  // 5. the chunk-local mass: over the pairs s <= r <= t (reverse: t <= r <=
  //    s), the prefix sums of Q's column sums less the exclusive prefix sums
  //    of its row sums (reverse: rows and columns swapped).
  row_sums(tl, red, rsum, [&](int i, int j) { return accG[i][j]; });
  col_sums(tl, red, csum, [&](int i, int j) { return accG[i][j]; });
  {
    const bool own = tid < kSsdT;
    const float a = scan128(own ? (reverse ? rsum[tid] : csum[tid]) : 0.f, sred);
    const float v = own ? (reverse ? csum[tid] : rsum[tid]) : 0.f;
    const float b = scan128(v, sred + 8) - v;
    if (own) m_intra[(r * L + t0 + tid) * H + h] = a - b;
  }
  // 6. dx~ (chunk-local) = scores^T @ g, into dx
  zero(accX);
  block_mm<true, false, float>(accX, tl, t3, LD, t1, LD);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* o = dxt + (r * L + t0 + tl.row(i)) * HP + h * kSsdP;
#pragma unroll
    for (int j = 0; j < 16; ++j) o[tl.col(j)] = accX[i][j];
  }
  __syncthreads();  // every read of g and of the scores is done
  // 7. C and B again: dB = M^T @ C, dC = M @ B (this head's, chunk-local)
  fill_tile<T>(t1, [&](int i, int n) { return src.c(t0 + i, n); });
  fill_tile<T>(t3, [&](int i, int n) { return src.b(t0 + i, n); });
  __syncthreads();
  zero(accX);
  block_mm<true, false, float>(accX, tl, t2, LD, t1, LD);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* o = dBh + ((r * L + t0 + tl.row(i)) * H + h) * kSsdN;
#pragma unroll
    for (int j = 0; j < 16; ++j) o[tl.col(j)] = accX[i][j];
  }
  zero(accX);
  block_mm<false, false, float>(accX, tl, t2, LD, t3, LD);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* o = dCh + ((r * L + t0 + tl.row(i)) * H + h) * kSsdN;
#pragma unroll
    for (int j = 0; j < 16; ++j) o[tl.col(j)] = accX[i][j];
  }
}

// Shared memory of (b): Rv, the vectors and reduction scratch, two tiles.
constexpr int kCarryFloats = kSsdN * kSsdLdS + 4 * kSsdT + 32 + 4 * kSsdT + 32 + 5 * kSsdT;

template <typename T>
inline size_t bwd_carry_smem() {
  return sizeof(float) * kCarryFloats + 2 * sizeof(T) * kSsdT * SsdLd<T>::v;
}

// (b): the cotangent state's pass over one (row, head), and the outputs.
template <typename T, bool kPre>
__global__ void __launch_bounds__(kSsdThreads, 1) ssd_bwd_carry_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ B,
    const T* __restrict__ C, const T* __restrict__ g, const float* __restrict__ fentry,
    const float* __restrict__ A, const float* __restrict__ Dskip,
    const float* __restrict__ dt_bias, const float* __restrict__ m_intra,
    float* __restrict__ dx, float* __restrict__ dBh, float* __restrict__ dCh,
    float* __restrict__ ddt, float* __restrict__ dmass, float* __restrict__ gx,
    float* __restrict__ dtp_out, int L, int H, int NG, int reverse) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  constexpr int LD = SsdLd<T>::v;
  const int h = blockIdx.x, tid = threadIdx.x;
  const long long r = blockIdx.y;
  const int HP = H * kSsdP;
  const auto src = bwd_src<T, kPre>(x, g, dt, B, C, r, h, L, H, NG);
  float* Rv = reinterpret_cast<float*>(bwd_smem);  // [N][kSsdLdS]
  float* dtp = Rv + kSsdN * kSsdLdS;                // [T] dt'
  float* segb = dtp + kSsdT;                        // [T] sb (unused here)
  float* into_e = segb + kSsdT;                     // [T] exp2(into)
  float* scale = into_e + kSsdT;                    // [T] exp2(outof)
  float* total_s = scale + kSsdT;                   // [1] total
  float* red = total_s + 32;                        // [4][T] reduction scratch
  float* sred = red + 4 * kSsdT;                    // [32] sum and scan scratch
  float* vout = sred + 32;                          // [T] sum_N B * (x~ Rv^T)
  float* win = vout + kSsdT;                        // [T] sum_N C * ((g exp2(into)) F^T)
  float* ddir = win + kSsdT;                        // [T] sum_P x dx~
  float* xdx = ddir + kSsdT;                        // [T] sum_P x~ dx~
  float* gxv = xdx + kSsdT;                         // [T] sum_P g x
  T* t1 = reinterpret_cast<T*>(bwd_smem + sizeof(float) * kCarryFloats);
  T* t2 = t1 + kSsdT * LD;
  const Tile tl;
  const float A_h = A[h], D_h = Dskip[h], dtb_h = dt_bias[h];
  for (int i = tid; i < kSsdN * kSsdLdS; i += kSsdThreads) Rv[i] = 0.f;

  const int nc = L / kSsdT;
  float acc[4][16];
  for (int ci = 0; ci < nc; ++ci) {
    const int c = reverse ? ci : nc - 1 - ci;
    const int t0 = c * kSsdT;
    const float* F = fentry + (r * nc + c) * kSsdN * HP + h * kSsdP;  // [N][HP], head h
    // 1. dt' and the decay vectors; the x~ and B tiles.
    chunk_decays(src, t0, A_h * kLog2e, dtb_h, reverse, dtp, segb, into_e, scale, total_s);
    fill_tile<T>(t1, [&](int i, int p) { return src.x(t0 + i, p) * dtp[i]; });
    fill_tile<T>(t2, [&](int i, int n) { return src.b(t0 + i, n); });
    __syncthreads();
    // 2. x~ @ Rv^T: V0, and the exit part of this head's dB
    zero(acc);
    block_mm<false, true, T>(acc, tl, t1, LD, Rv, kSsdLdS);
    row_sums(tl, red, vout,
             [&](int i, int j) { return src.b(t0 + tl.row(i), tl.col(j)) * acc[i][j]; });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = tl.row(i);
      float* o = dBh + ((r * L + t0 + s) * H + h) * kSsdN;
#pragma unroll
      for (int j = 0; j < 16; ++j) o[tl.col(j)] += scale[s] * acc[i][j];
    }
    // 3. dx~ = (chunk-local part, from (a)) + exp2(outof) B @ Rv; dx
    zero(acc);
    block_mm<false, false, T>(acc, tl, t2, LD, Rv, kSsdLdS);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = tl.row(i);
      const float* o = dx + (r * L + t0 + s) * HP + h * kSsdP;
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = o[tl.col(j)] + scale[s] * acc[i][j];
    }
    row_sums(tl, red, ddir,
             [&](int i, int j) { return src.x(t0 + tl.row(i), tl.col(j)) * acc[i][j]; });
    row_sums(tl, red, xdx, [&](int i, int j) {
      const int s = tl.row(i);
      return src.x(t0 + s, tl.col(j)) * dtp[s] * acc[i][j];
    });
    if constexpr (kPre)
      row_sums(tl, red, gxv, [&](int i, int j) {
        const int s = t0 + tl.row(i), p = tl.col(j);
        return src.g(s, p) * src.x(s, p);
      });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = tl.row(i);
      float* o = dx + (r * L + t0 + s) * HP + h * kSsdP;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int p = tl.col(j);
        float v = dtp[s] * acc[i][j] + D_h * src.g(t0 + s, p);
        if constexpr (kPre) v *= silu_grad_f(src.acc_x(t0 + s, p));
        o[p] = v;
      }
    }
    __syncthreads();  // every read of the x~ and B tiles and of Rv is done
    // 4. g exp2(into) and C; (g exp2(into)) @ F^T: W, and the entry part of dC
    fill_tile<T>(t1, [&](int i, int p) { return src.g(t0 + i, p) * into_e[i]; });
    fill_tile<T>(t2, [&](int i, int n) { return src.c(t0 + i, n); });
    __syncthreads();
    zero(acc);
    block_mm<false, true, T>(acc, tl, t1, LD, F, HP);
    row_sums(tl, red, win,
             [&](int i, int j) { return src.c(t0 + tl.row(i), tl.col(j)) * acc[i][j]; });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* o = dCh + ((r * L + t0 + tl.row(i)) * H + h) * kSsdN;
#pragma unroll
      for (int j = 0; j < 16; ++j) o[tl.col(j)] += acc[i][j];
    }
    // 5. <Rv, F>; Rv = exp2(total) Rv + C^T @ (g exp2(into)), each thread its
    //    own elements of Rv
    zero(acc);
    block_mm<true, false, float>(acc, tl, t2, LD, t1, LD);
    const float tote = exp2f(total_s[0]);
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = tl.row(i);
      float* rrow = Rv + n * kSsdLdS;
      const float* frow = F + (long long)n * HP;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int p = tl.col(j);
        part = fmaf(rrow[p], frow[p], part);
        rrow[p] = tote * rrow[p] + acc[i][j];
      }
    }
    const float scal = block_sum(part, sred);
    // 6. the mass and ddt_raw, one step a thread. Forward: the entry term is
    //    the suffix sum of W, the exit term the prefix sum of exp2(outof) V0;
    //    reverse: the other way round. The suffix sums are prefix sums over
    //    the steps in reverse order.
    const bool own = tid < kSsdT;
    const int k = kSsdT - 1 - tid;
    float pv = 0.f, sv = 0.f;
    if (own) {
      pv = reverse ? win[tid] : scale[tid] * vout[tid];
      sv = reverse ? scale[k] * vout[k] : win[k];
    }
    const float pre = scan128(pv, sred + 8);
    const float suf = scan128(sv, sred + 16);
    if (own) red[k] = suf;
    __syncthreads();
    if (own) {
      const long long o = (r * L + t0 + tid) * H + h;
      const float up = reverse ? pre : red[tid], dn = reverse ? red[tid] : pre;
      const float mass = m_intra[o] + up + dn + tote * scal - xdx[tid];
      const float din = src.dt(t0 + tid) + dtb_h;
      ddt[o] = (ddir[tid] + mass * A_h) / (1.f + expf(-din));
      dmass[o] = mass;
      if constexpr (kPre) {
        gx[o] = gxv[tid];
        dtp_out[o] = dtp[tid];
      }
    }
    __syncthreads();  // before the next chunk rewrites the tiles and vectors
  }
}

// (c): dB and dC [R*L, NG, N] from the heads' partials [R*L, H, N], summed
// over each group's heads in order; SiLU' of the accumulators in pre_silu.
template <typename T, bool kPre>
__global__ void __launch_bounds__(kGroupThreads) ssd_bwd_group_kernel(
    const float* __restrict__ dBh, const float* __restrict__ dCh, const T* __restrict__ B,
    const T* __restrict__ C, float* __restrict__ dB, float* __restrict__ dC, long long n_out,
    int H, int NG) {
  const long long e = (long long)blockIdx.x * kGroupThreads + threadIdx.x;
  if (e >= n_out) return;
  const int n = (int)(e % kSsdN);
  const long long pg = e / kSsdN;
  const int gi = (int)(pg % NG), hg = H / NG;
  const long long base = ((pg / NG) * H + gi * hg) * kSsdN + n;
  float sb = 0.f, sc = 0.f;
  for (int j = 0; j < hg; ++j) {
    sb += dBh[base + j * kSsdN];
    sc += dCh[base + j * kSsdN];
  }
  if constexpr (kPre) {
    sb *= silu_grad_f(to_f(B[e]));
    sc *= silu_grad_f(to_f(C[e]));
  }
  dB[e] = sb;
  dC[e] = sc;
}

template <typename T, bool kPre>
cudaError_t launch_ssd_bwd(const void* x, const void* dt, const void* B, const void* C,
                           const void* g, const float* fentry, const float* A,
                           const float* Dskip, const float* dt_bias, float* dx, float* dB,
                           float* dC, float* ddt, float* dmass, float* gx, float* dtp,
                           float* dBh, float* dCh, float* m_intra, int R, int L, int H, int NG,
                           int reverse, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* dtt = static_cast<const T*>(dt);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  const T* gt = static_cast<const T*>(g);
  const size_t sa = bwd_local_smem<T>(), sb = bwd_carry_smem<T>();
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_local_kernel<T, kPre>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(ssd_bwd_carry_kernel<T, kPre>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sb);
  if (e != cudaSuccess) return e;
  ssd_bwd_local_kernel<T, kPre><<<dim3(H, L / kSsdT, R), kSsdThreads, sa, s>>>(
      xt, dtt, Bt, Ct, gt, A, dt_bias, dx, dBh, dCh, m_intra, L, H, NG, reverse);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_carry_kernel<T, kPre><<<dim3(H, R), kSsdThreads, sb, s>>>(
      xt, dtt, Bt, Ct, gt, fentry, A, Dskip, dt_bias, m_intra, dx, dBh, dCh, ddt, dmass, gx,
      dtp, L, H, NG, reverse);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n_out = (long long)R * L * NG * kSsdN;
  ssd_bwd_group_kernel<T, kPre>
      <<<(unsigned)((n_out + kGroupThreads - 1) / kGroupThreads), kGroupThreads, 0, s>>>(
          dBh, dCh, Bt, Ct, dB, dC, n_out, H, NG);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ssd_bwd_any(const void* x, const void* dt, const void* B, const void* C,
                               const void* g, const float* fentry, const float* A,
                               const float* Dskip, const float* dt_bias, float* dx, float* dB,
                               float* dC, float* ddt, float* dmass, float* gx, float* dtp,
                               float* dBh, float* dCh, float* m_intra, int R, int L, int H,
                               int NG, int reverse, int pre_silu, cudaStream_t s) {
  if (pre_silu)
    return launch_ssd_bwd<T, true>(x, dt, B, C, g, fentry, A, Dskip, dt_bias, dx, dB, dC, ddt,
                                   dmass, gx, dtp, dBh, dCh, m_intra, R, L, H, NG, reverse, s);
  return launch_ssd_bwd<T, false>(x, dt, B, C, g, fentry, A, Dskip, dt_bias, dx, dB, dC, ddt,
                                  dmass, gx, dtp, dBh, dCh, m_intra, R, L, H, NG, reverse, s);
}

}  // namespace pc

// P = N = chunk = 128, L % 128 == 0 and NG | H are the wrapper's to check.
// x, g [R, L, H*P], dt [R, L, H], B, C [R, L, NG, N] of one dtype; fentry
// [R, L/128, N, H*P] and A, Dskip, dt_bias [H] float32. Outputs, float32: dx
// [R, L, H*P], dB, dC [R, L, NG, N], ddt, dmass [R, L, H], and with pre_silu
// gx, dtp [R, L, H] (null otherwise). Scratch, float32: dBh, dCh [R, L, H,
// N], m_intra [R, L, H].
extern "C" int pc_ssd_bwd(const void* x, const void* dt, const void* B, const void* C,
                          const void* g, const float* fentry, const float* A,
                          const float* Dskip, const float* dt_bias, float* dx, float* dB,
                          float* dC, float* ddt, float* dmass, float* gx, float* dtp,
                          float* dBh, float* dCh, float* m_intra, int R, int L, int H, int NG,
                          int reverse, int pre_silu, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pc::launch_ssd_bwd_any<__nv_bfloat16>(x, dt, B, C, g, fentry, A, Dskip, dt_bias, dx,
                                                 dB, dC, ddt, dmass, gx, dtp, dBh, dCh,
                                                 m_intra, R, L, H, NG, reverse, pre_silu, s);
  return pc::launch_ssd_bwd_any<float>(x, dt, B, C, g, fentry, A, Dskip, dt_bias, dx, dB, dC,
                                       ddt, dmass, gx, dtp, dBh, dCh, m_intra, R, L, H, NG,
                                       reverse, pre_silu, s);
}
