// K6 — the SSD (Mamba-2) adjoint, one direction.
//
// Replaces plantcaduceus_tpu/ops/pallas_ssd.py::_bwd_kernel (launched at
// pallas_ssd.py:545 through _ssd_dir_bwd_kernel_call, which ssd_dir's custom
// VJP and the fused mixer's backward pallas_mixer2._interior_bwd call), in
// both its modes, a template parameter each: plain (x, B and C as given) and
// pre_silu (x, B and C are the fused mixer's pre-SiLU conv accumulators:
// SiLU applies here, SiLU' chains onto dx, dB and dC, and gx = sum_P g*x
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
// variants) and Rv [N, P] the cotangent state entering a chunk.
//
// The TPU kernel walks a row's chunks opposite to the forward, keeps the
// cotangent state of the whole row [N, H*P] in VMEM and sums dB and dC over
// the group's heads in the chunk body. Here the only serial part is the Rv
// recurrence, and it is an elementwise one once its increments are known,
// so K6 is four kernels on one stream (five in pre_silu), with no atomics
// (two launches give equal bits):
//  (-) pre_silu only, ssd_bwd_act_kernel: SiLU of B and C once, into
//      float32 copies that every head reads (B and C belong to the group).
//  (a) ssd_bwd_state_kernel, per (row, head, chunk), all chunks at once:
//      the chunk's increment C^T (g exp2(into)) [N, P] into the float32
//      scratch rv [R, L/128, N, H*P] (fentry's layout), and its total decay.
//  (b) ssd_bwd_pass_kernel, per element of a row's state: the recurrence
//      over the chunks in backward order (the reverse direction from chunk
//      0), in place: rv then holds the state entering each chunk, as fentry
//      holds the forward's.
//  (c) ssd_bwd_chunk_kernel, per (row, head, chunk), all chunks at once:
//      everything else, from the chunk's inputs, F and Rv: C B^T and g x~^T,
//      the masked decays and the chunk-local mass (a difference of prefix
//      sums of Q's column and row sums, not the TPU kernel's T^3 mask
//      product), dx~ = scores^T g + exp2(outof) B Rv summed in registers and
//      written once as dx, this head's dB and dC (float32 [R, L, H, N],
//      written once), and the mass's boundary terms, dmass and ddt_raw (and
//      gx, dtp).
//  (d) ssd_bwd_group_kernel, per output element: dB and dC as the sums of
//      the group's heads' parts in head order (times SiLU' in pre_silu).
//
// Staging. Every product operand is copied into a shared-memory tile with
// 16-byte global loads, x's SiLU applied on the way: x, g, B, C and,
// rounded to the product type, F and Rv. In bfloat16 (the wgmma kernel,
// ssd_bwd_chunk_wg_kernel) six [128][128] tiles in wgmma's 128-byte-swizzled
// layout (192 KB) hold every operand of the chunk's eight products at once,
// each staged once; every product is eight m64n128k16 wgmma per warpgroup,
// both operands read from shared memory K-major or MN-major (the descriptor's
// transpose bit), the accumulator a warpgroup's 64 rows: a row's 128
// columns lie in one quad of lanes, so the row sums take two shuffles. In
// float32 (ssd_bwd_chunk_kernel) three [128][LD] tiles (206 KB) are reused
// by ssd_core.cuh's FMA block products, and x~, B and C are staged again.
// At most two accumulators are live at a time. Row sums that need
// unrounded values (sum_P x dx~, sum_P g x, sum_N B (x~ Rv^T), sum_N C ((g
// exp2(into)) F^T)) read them from global memory at the accumulator's
// positions, once (L2-resident: the block staged them just before); <Rv,
// F> is summed while F is staged. SiLU and SiLU' use the fast exponential
// and division. (a) keeps ssd_core.cuh's mma.sync product (one a block).
// The products round the same operands to bf16 as ops/ssd_bwd.py does.
// Every exponent is masked before exp2.
//
// What bounds it on an H100 (l20-ssd training: 64 rows x 512, H 6): the
// bytes of x, g, B, C, dt and fentry in and dx, dB, dC, ddt, dmass out (0.35
// GB in bf16: 0.11 ms), ahead of the products (~53 GFLOP: 0.05 ms on the
// tensor cores); in fp32 the products bound it (0.8 ms at 67 TFLOP/s). This
// version also moves its float32 scratch once each way: the chunk states
// (0.1 GB) and the per-head dB and dC (0.2 GB). One block of (c) fills an
// SM (eight warps), so its staging, products and row sums do not overlap
// one another: that, not bytes or products, is what it waits on.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the scratch comes from the wrapper) and returns cudaGetLastError().

#include <type_traits>

#include "attn_sm90.cuh"
#include "ssd_core.cuh"

namespace pc {

constexpr int kGroupThreads = 256;
constexpr int kPassThreads = 256;

// SiLU and its derivative with the fast exponential and division (within
// a few float32 ulps of torch's silu).
__device__ __forceinline__ float silu_f(float a) { return __fdividef(a, 1.f + __expf(-a)); }

__device__ __forceinline__ float silu_grad_f(float a) {
  const float s = __fdividef(1.f, 1.f + __expf(-a));
  return s * (1.f + a * (1.f - s));
}

// SiLU and its derivative at once, from one exponential.
__device__ __forceinline__ float2 silu_and_grad(float a) {
  const float s = __fdividef(1.f, 1.f + __expf(-a));
  return make_float2(a * s, s * (1.f + a * (1.f - s)));
}

// The activation of x, B and C: SiLU in pre_silu mode.
template <bool kPre>
__device__ __forceinline__ float act(float a) { return kPre ? silu_f(a) : a; }

// Elements of S in one 16-byte load, kept raw until used.
template <typename S> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<bf16> { static constexpr int n = 8; };

template <typename S>
__device__ __forceinline__ uint4 load_vec(const S* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
// Element e of a raw 16-byte vector of S, as float.
template <typename S>
__device__ __forceinline__ float vec_at(const uint4& v, int e) {
  if constexpr (std::is_same<S, float>::value) return __uint_as_float((&v.x)[e]);
  const uint32_t w = (&v.x)[e >> 1];  // bf16 e is the low half for even e
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Two neighbouring elements (the accumulator's column pair 2q, 2q+1).
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// Stage a 128 x 128 block of S (row stride `stride` elements) into a
// [128][LD] tile of E: tile(r, c) = f(r, c, value). 16-byte loads, all of a
// thread's issued before the first is used; a row is VPR neighbouring
// threads. Every thread calls it; the caller syncs.
template <typename E, typename S, class F>
__device__ __forceinline__ void stage(E* tile, const S* src, long long stride, F f) {
  constexpr int V = Vec<S>::n, VPR = 128 / V, LD = SsdLd<E>::v;
  constexpr int IT = 128 * VPR / kSsdThreads;
  uint4 a[IT];
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    const int v = threadIdx.x + k * kSsdThreads;
    a[k] = load_vec(src + (v / VPR) * stride + (v % VPR) * V);
  }
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    const int v = threadIdx.x + k * kSsdThreads, r = v / VPR, c0 = (v % VPR) * V;
#pragma unroll
    for (int e = 0; e < V; ++e) tile[r * LD + c0 + e] = from_f<E>(f(r, c0 + e, vec_at<S>(a[k], e)));
  }
}

// Two blocks of one layout at once: ta(r, c) = fa(r, a(r, c), b(r, c)) and
// tb(r, c) = fb(r, a, b) (either tile may be null), and per row r the sum
// over c of fs(r, a, b) into rs[r] (null: none), by a shuffle tree over the
// row's VPR threads, so in a fixed order. The caller syncs.
template <typename E, typename S, typename S2, class FA, class FB, class FS>
__device__ __forceinline__ void stage2(E* ta, E* tb, const S* sa, const S2* sb, long long stride,
                                       float* rs, FA fa, FB fb, FS fs) {
  static_assert(Vec<S>::n == Vec<S2>::n, "stage2: one vector width");
  constexpr int V = Vec<S>::n, VPR = 128 / V, LD = SsdLd<E>::v;
  constexpr int IT = 128 * VPR / kSsdThreads;
#pragma unroll 4
  for (int k = 0; k < IT; ++k) {
    const int v = threadIdx.x + k * kSsdThreads, r = v / VPR, c0 = (v % VPR) * V;
    const uint4 a = load_vec(sa + r * stride + c0), b = load_vec(sb + r * stride + c0);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float av = vec_at<S>(a, e), bv = vec_at<S2>(b, e);
      if (ta) ta[r * LD + c0 + e] = from_f<E>(fa(r, av, bv));
      if (tb) tb[r * LD + c0 + e] = from_f<E>(fb(r, av, bv));
      if (rs) part += fs(r, av, bv);
    }
    if (rs) {
#pragma unroll
      for (int o = 1; o < VPR; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (v % VPR == 0) rs[r] = part;
    }
  }
}

// The raw dt of one (row, head), for chunk_decays.
template <typename T>
struct DtSrc {
  const T* dtr;  // the row's [L, H], at column h
  int H;
  __device__ float dt(int t) const { return to_f(dtr[(long long)t * H]); }
};

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

// pre_silu: SiLU of the B and C accumulators once, into float32 copies that
// every head's blocks stage and read (B and C belong to the group).
template <typename T>
__global__ void __launch_bounds__(kGroupThreads) ssd_bwd_act_kernel(
    const T* __restrict__ B, const T* __restrict__ C, float* __restrict__ Ba,
    float* __restrict__ Ca, long long n) {
  const long long e = (long long)blockIdx.x * kGroupThreads + threadIdx.x;
  if (e >= n) return;
  Ba[e] = silu_f(to_f(B[e]));
  Ca[e] = silu_f(to_f(C[e]));
}

// Shared memory of (a): the decay vectors, then two [128][LD] tiles.
constexpr int kStateFloats = 4 * kSsdT + 32;

template <typename T>
inline size_t bwd_state_smem() {
  return sizeof(float) * kStateFloats + 2 * sizeof(T) * kSsdT * SsdLd<T>::v;
}

// (a): one (row, head, chunk)'s increment of the cotangent state, C^T (g
// exp2(into)) [N, P], into rv at the chunk's slot, and its total decay.
template <typename T, bool kPre>
__global__ void __launch_bounds__(kSsdThreads, 2) ssd_bwd_state_kernel(
    const T* __restrict__ dt, const T* __restrict__ C, const float* __restrict__ Ca,
    const T* __restrict__ g, const float* __restrict__ A, const float* __restrict__ dt_bias,
    float* __restrict__ rv, float* __restrict__ tot, int L, int H, int NG, int reverse) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  constexpr int LD = SsdLd<T>::v;
  const int h = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const long long r = blockIdx.z;
  const int t0 = c * kSsdT, HP = H * kSsdP, NGN = NG * kSsdN;
  float* dtp = reinterpret_cast<float*>(bwd_smem);  // [T] dt'
  float* segb = dtp + kSsdT;                         // [T] sb (unused here)
  float* into_e = segb + kSsdT;                      // [T] exp2(into)
  float* scale = into_e + kSsdT;                     // [T] exp2(outof) (unused here)
  float* total_s = scale + kSsdT;                    // [1] total
  T* tc = reinterpret_cast<T*>(bwd_smem + sizeof(float) * kStateFloats);
  T* tg = tc + kSsdT * LD;
  const DtSrc<T> ds{dt + r * L * H + h, H};
  chunk_decays(ds, t0, A[h] * kLog2e, dt_bias[h], reverse, dtp, segb, into_e, scale, total_s);
  const long long brow = (r * L + t0) * NGN + (h / (H / NG)) * kSsdN;
  const T* gr = g + (r * L + t0) * HP + h * kSsdP;
  auto as_is = [](int, int, float v) { return v; };
  if constexpr (kPre)
    stage<T>(tc, Ca + brow, NGN, as_is);
  else
    stage<T>(tc, C + brow, NGN, as_is);
  stage<T>(tg, gr, HP, [&](int i, int, float v) { return v * into_e[i]; });
  __syncthreads();
  const Tile tl;
  float acc[4][16];
  zero(acc);
  block_mm<true, false, float>(acc, tl, tc, LD, tg, LD);
  float* o = rv + (r * nc + c) * kSsdN * HP + h * kSsdP;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; j += 2)
      *reinterpret_cast<float2*>(o + (long long)tl.row(i) * HP + tl.col(j)) =
          make_float2(acc[i][j], acc[i][j + 1]);
  if (threadIdx.x == 0) tot[(r * nc + c) * H + h] = total_s[0];
}

// (b): per four neighbouring elements of a row's state [N, H*P], the
// recurrence Rv = exp2(total) Rv + increment over the chunks in backward
// order (reverse: from chunk 0), in place: each chunk's slot of rv ends
// holding the state entering it. Four chunks' increments are loaded at once.
__global__ void __launch_bounds__(kPassThreads) ssd_bwd_pass_kernel(
    float* __restrict__ rv, const float* __restrict__ tot, long long n4, int nc, int H,
    int reverse) {
  const long long e = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= n4) return;
  const int HP = H * kSsdP;
  const long long row4 = (long long)kSsdN * HP / 4;  // float4s of one chunk's state
  const long long r = e / row4;
  const long long o4 = e % row4;
  const int h = (int)((o4 * 4) % HP) / kSsdP;
  auto slot = [&](int k) {
    const int c = reverse ? k : nc - 1 - k;
    return reinterpret_cast<float4*>(rv + (r * nc + c) * kSsdN * HP) + o4;
  };
  auto decay = [&](int k) { return exp2f(tot[(r * nc + (reverse ? k : nc - 1 - k)) * H + h]); };
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < nc; k0 += 4) {
    float4 inc[4];
    float te[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (k0 + u < nc) {
        inc[u] = *slot(k0 + u);
        te[u] = decay(k0 + u);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (k0 + u < nc) {
        *slot(k0 + u) = s;
        s = make_float4(te[u] * s.x + inc[u].x, te[u] * s.y + inc[u].y, te[u] * s.z + inc[u].z,
                        te[u] * s.w + inc[u].w);
      }
    }
  }
}

// 7. the mass and ddt_raw of a chunk, one step a thread, from its vectors
//    in shared memory. Forward: the entry term is the suffix sum of W, the
//    exit term the prefix sum of exp2(outof) V0; reverse: the other way
//    round. The suffix sums are prefix sums over the steps in reverse order.
//    o0 is the (row, step t0, head) output offset; red: T floats of scratch.
template <bool kPre, class Dt>
__device__ __forceinline__ void mass_and_ddt(const Dt& ds, int reverse, float total, float scal,
                                             float A_h, float dtb_h, int t0, long long o0, int H,
                                             const float* dtp, const float* scale,
                                             const float* mi, const float* vout,
                                             const float* win, const float* ddir,
                                             const float* xdx, const float* gxv, float* red,
                                             float* sred, float* ddt, float* dmass, float* gx,
                                             float* dtp_out) {
  const int tid = threadIdx.x;
  const float tote = exp2f(total);
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
    const long long o = o0 + (long long)tid * H;
    const float up = reverse ? pre : red[tid], dn = reverse ? red[tid] : pre;
    const float mass = mi[tid] + up + dn + tote * scal - xdx[tid];
    const float din = ds.dt(t0 + tid) + dtb_h;
    ddt[o] = (ddir[tid] + mass * A_h) / (1.f + expf(-din));
    dmass[o] = mass;
    if constexpr (kPre) {
      gx[o] = gxv[tid];
      dtp_out[o] = dtp[tid];
    }
  }
}

// Shared memory of (c) in float32: the vectors and reduction scratch, then
// three [128][LD] tiles, reused (x~, B and C are staged again).
constexpr int kChunkFloats = 19 * kSsdT + 64;

template <typename T>
inline size_t bwd_chunk_smem() {
  return sizeof(float) * kChunkFloats + 3 * sizeof(T) * kSsdT * SsdLd<T>::v;
}

// (c) in float32: all of one (row, head, chunk) but the state's recurrence,
// on ssd_core.cuh's FMA block products.
template <typename T, bool kPre>
__global__ void __launch_bounds__(kSsdThreads, 1) ssd_bwd_chunk_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ B,
    const T* __restrict__ C, const float* __restrict__ Ba, const float* __restrict__ Ca,
    const T* __restrict__ g, const float* __restrict__ fentry, const float* __restrict__ rv,
    const float* __restrict__ A, const float* __restrict__ Dskip,
    const float* __restrict__ dt_bias, float* __restrict__ dx, float* __restrict__ dBh,
    float* __restrict__ dCh, float* __restrict__ ddt, float* __restrict__ dmass,
    float* __restrict__ gx, float* __restrict__ dtp_out, int L, int H, int NG, int reverse) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  constexpr int LD = SsdLd<T>::v;
  const int h = blockIdx.x, c = blockIdx.y, nc = gridDim.y, tid = threadIdx.x;
  const long long r = blockIdx.z;
  const int t0 = c * kSsdT, HP = H * kSsdP, NGN = NG * kSsdN;
  float* dtp = reinterpret_cast<float*>(bwd_smem);  // [T] dt'
  float* segb = dtp + kSsdT;                         // [T] sb
  float* into_e = segb + kSsdT;                      // [T] exp2(into)
  float* scale = into_e + kSsdT;                     // [T] exp2(outof)
  float* total_s = scale + kSsdT;                    // [1] total
  float* red = total_s + 32;                         // [4][T] reduction scratch
  float* rsum = red + 4 * kSsdT;                     // [T] row sums of Q (then scratch)
  float* csum = rsum + kSsdT;                        // [T] column sums of Q (then scratch)
  float* sred = csum + kSsdT;                        // [32] sum and scan scratch
  float* mi = sred + 32;                             // [T] the chunk-local mass
  float* vout = mi + kSsdT;                          // [T] sum_N B * (x~ Rv^T)
  float* win = vout + kSsdT;                         // [T] sum_N C * ((g exp2(into)) F^T)
  float* ddir = win + kSsdT;                         // [T] sum_P x dx~
  float* xdx = ddir + kSsdT;                         // [T] sum_P x~ dx~
  float* gxv = xdx + kSsdT;                          // [T] sum_P g x
  float* frs = gxv + kSsdT;                          // [T] row sums of Rv * F
  float* gred = frs + kSsdT;                         // [2][T] reduction scratch of gx
  T* t1 = reinterpret_cast<T*>(bwd_smem + sizeof(float) * kChunkFloats);  // three tiles
  T* t2 = t1 + kSsdT * LD;
  T* t3 = t2 + kSsdT * LD;
  const Tile tl;
  const float A_h = A[h], D_h = Dskip[h], dtb_h = dt_bias[h];
  const long long xrow = (r * L + t0) * HP + h * kSsdP;  // x, g, dx at (t0, head h)
  const long long brow = (r * L + t0) * NGN + (h / (H / NG)) * kSsdN;
  const T* xr = x + xrow;
  const T* gr = g + xrow;
  // B and C as the products and sums take them (activated in pre_silu)
  using BC = std::conditional_t<kPre, float, T>;
  const BC* Br;
  const BC* Cr;
  if constexpr (kPre) {
    Br = Ba + brow;
    Cr = Ca + brow;
  } else {
    Br = B + brow;
    Cr = C + brow;
  }
  const long long srow = (r * nc + c) * kSsdN * HP + h * kSsdP;  // F, Rv [N][HP] at head h
  const float* Fr = fentry + srow;
  const float* Rr = rv + srow;
  float accA[4][16], accB[4][16];

  auto as_is = [](int, int, float v) { return v; };
  // 3. the masked decays from accA = C B^T and accB = g x~^T: the scores
  //    and M into two tiles, Q = GBC * M into accA; then the chunk-local
  //    mass: over the pairs s <= r <= t (reverse: t <= r <= s), the prefix
  //    sums of Q's column sums less the exclusive prefix sums of its row
  //    sums (reverse: rows and columns swapped).
  auto local_mass = [&](T* tsc, T* tm) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tl.row(i);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int s = tl.col(j);
        const bool keep = reverse ? t <= s : t >= s;
        const float se = exp2f(keep ? segb[t] - segb[s] : __uint_as_float(0xff800000u));
        const float m = accB[i][j] * se;
        tsc[t * LD + s] = from_f<T>(accA[i][j] * se);
        tm[t * LD + s] = from_f<T>(m);
        accA[i][j] *= m;
      }
    }
    row_sums(tl, red, rsum, [&](int i, int j) { return accA[i][j]; });
    col_sums(tl, red, csum, [&](int i, int j) { return accA[i][j]; });
    const bool own = tid < kSsdT;
    const float a = scan128(own ? (reverse ? rsum[tid] : csum[tid]) : 0.f, sred);
    const float v = own ? (reverse ? csum[tid] : rsum[tid]) : 0.f;
    const float b = scan128(v, sred + 8) - v;
    if (own) mi[tid] = a - b;
  };
  // 4. dx~ = accA (scores^T g) + exp2(outof) accB (B Rv), into accA so that
  //    accB is free for the epilogue's loads; dx, and the row sums sum_P x
  //    dx~ and sum_P x~ dx~ into red, sum_P g x into gred (the caller syncs)
  auto dx_out = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float sc = scale[tl.row(i)];
#pragma unroll
      for (int j = 0; j < 16; ++j) accA[i][j] += sc * accB[i][j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = tl.row(i);
      const float dp = dtp[s];
      float s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const int p = tl.col(j);
        const float2 xa = load_pair(xr + (long long)s * HP + p);
        const float2 ga = load_pair(gr + (long long)s * HP + p);
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = e ? xa.y : xa.x, gv = e ? ga.y : ga.x;
          const float d = accA[i][j + e];
          const float2 sg = kPre ? silu_and_grad(a) : make_float2(a, 1.f);
          s1 += sg.x * d;
          s2 += sg.x * dp * d;
          s3 += gv * sg.x;
          float v = dp * d + D_h * gv;
          if constexpr (kPre) v *= sg.y;
          o[e] = v;
        }
        *reinterpret_cast<float2*>(dx + xrow + (long long)s * HP + p) = make_float2(o[0], o[1]);
      }
#pragma unroll
      for (int m = 1; m < 4; m <<= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, m);
        s2 += __shfl_xor_sync(0xffffffffu, s2, m);
        if constexpr (kPre) s3 += __shfl_xor_sync(0xffffffffu, s3, m);
      }
      if (tl.q == 0) {
        red[tl.part() * kSsdT + s] = s1;
        red[(2 + tl.part()) * kSsdT + s] = s2;
        if constexpr (kPre) gred[tl.part() * kSsdT + s] = s3;
      }
    }
  };
  auto dx_sums = [&]() {
    if (tid < kSsdT) {
      ddir[tid] = red[tid] + red[kSsdT + tid];
      xdx[tid] = red[2 * kSsdT + tid] + red[3 * kSsdT + tid];
      if constexpr (kPre) gxv[tid] = gred[tid] + gred[kSsdT + tid];
    }
  };
  // 5. from accA = x~ Rv^T: the row sums sum_N B (x~ Rv^T) into rsum and
  //    csum, free by now (the caller syncs); then accA *= exp2(outof)
  auto exit_part = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = tl.row(i);
      float s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const float2 b = load_pair(Br + (long long)s * NGN + tl.col(j));
        s1 += b.x * accA[i][j];
        s1 += b.y * accA[i][j + 1];
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) accA[i][j] *= scale[s];
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      if (tl.q == 0) rsum[tl.part() * kSsdT + s] = s1;
    }
  };
  auto write_dB = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* o = dBh + ((r * L + t0 + tl.row(i)) * H + h) * kSsdN;
#pragma unroll
      for (int j = 0; j < 16; j += 2)
        *reinterpret_cast<float2*>(o + tl.col(j)) = make_float2(accA[i][j], accA[i][j + 1]);
    }
  };
  // 6. dC = accA (M B) + accB ((g exp2(into)) F^T), and the row sums
  //    sum_N C accB into red (the caller syncs)
  auto dC_out = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tl.row(i);
      float s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const float2 cc = load_pair(Cr + (long long)t * NGN + tl.col(j));
        s1 += cc.x * accB[i][j];
        s1 += cc.y * accB[i][j + 1];
      }
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      if (tl.q == 0) red[tl.part() * kSsdT + t] = s1;
      float* o = dCh + ((r * L + t0 + t) * H + h) * kSsdN;
#pragma unroll
      for (int j = 0; j < 16; j += 2)
        *reinterpret_cast<float2*>(o + tl.col(j)) =
            make_float2(accA[i][j] + accB[i][j], accA[i][j + 1] + accB[i][j + 1]);
    }
  };
  auto stage_gi = [&](T* t) {
    stage<T>(t, gr, HP, [&](int i, int, float v) { return v * into_e[i]; });
  };
  auto stage_f = [&](T* t) {  // F, and the row sums of Rv * F (float32)
    stage2<T>(t, (T*)nullptr, Fr, Rr, HP, frs, [](int, float f, float) { return f; },
              [](int, float, float) { return 0.f; },
              [](int, float f, float rvv) { return f * rvv; });
  };

  const DtSrc<T> ds{dt + r * L * H + h, H};
  chunk_decays(ds, t0, A_h * kLog2e, dtb_h, reverse, dtp, segb, into_e, scale, total_s);
  stage<T>(t1, Cr, NGN, as_is);
  stage<T>(t2, Br, NGN, as_is);
  __syncthreads();
  zero(accA);
  block_mm<false, true, float>(accA, tl, t1, LD, t2, LD);   // C B^T
  __syncthreads();  // every read of C and B is done
  stage<T>(t1, gr, HP, as_is);
  stage<T>(t2, xr, HP, [&](int i, int, float v) { return act<kPre>(v) * dtp[i]; });
  __syncthreads();
  zero(accB);
  block_mm<false, true, float>(accB, tl, t1, LD, t2, LD);   // g x~^T
  __syncthreads();  // every read of x~ is done
  local_mass(t3, t2);
  zero(accA);
  block_mm<true, false, float>(accA, tl, t3, LD, t1, LD);   // scores^T g
  __syncthreads();  // every read of g and of the scores is done
  stage<T>(t1, Br, NGN, as_is);
  stage<T>(t3, Rr, HP, as_is);
  __syncthreads();
  zero(accB);
  block_mm<false, false, float>(accB, tl, t1, LD, t3, LD);  // B Rv
  dx_out();
  __syncthreads();  // and every read of the B tile is done
  dx_sums();
  stage<T>(t1, xr, HP, [&](int i, int, float v) { return act<kPre>(v) * dtp[i]; });
  __syncthreads();
  zero(accA);
  block_mm<false, true, float>(accA, tl, t1, LD, t3, LD);   // x~ Rv^T
  __syncthreads();  // every read of x~ and Rv is done
  stage<T>(t1, Cr, NGN, as_is);
  exit_part();
  __syncthreads();
  if (tid < kSsdT) vout[tid] = rsum[tid] + rsum[kSsdT + tid];
  block_mm<true, false, float>(accA, tl, t2, LD, t1, LD);   // += M^T C
  write_dB();
  stage<T>(t3, Br, NGN, as_is);
  __syncthreads();
  zero(accA);
  block_mm<false, false, float>(accA, tl, t2, LD, t3, LD);  // M B
  __syncthreads();  // every read of M and B is done
  stage_gi(t2);
  stage_f(t3);
  __syncthreads();
  zero(accB);
  block_mm<false, true, float>(accB, tl, t2, LD, t3, LD);   // (g exp2(into)) F^T
  dC_out();
  __syncthreads();
  if (tid < kSsdT) win[tid] = red[tid] + red[kSsdT + tid];
  const float scal = block_sum(tid < kSsdT ? frs[tid] : 0.f, sred);
  mass_and_ddt<kPre>(ds, reverse, total_s[0], scal, A_h, dtb_h, t0, (r * L + t0) * H + h, H, dtp,
                     scale, mi, vout, win, ddir, xdx, gxv, red, sred, ddt, dmass, gx, dtp_out);
}

// ---------------------------------------------------------------------------
// (c) in bfloat16: the same chunk on wgmma. Six [128][128] bf16 tiles in the
// layout wgmma reads (attn_sm90.cuh's 128-byte swizzle, the tile as two
// column atoms of [128 rows][64 cols], 16 KB each, 1024-byte aligned), so
// each of the eight products is eight m64n128k16 wgmma per warpgroup with
// both operands read from shared memory, K-major or MN-major by the
// descriptor's transpose bit: warpgroup w computes output rows 64w..64w+63.
// A thread's accumulator holds rows row(i), i < 2, and columns 8j + 2q + e,
// j < 16, e < 2 (acc[j][2i + e]): a row's 128 columns lie in the four lanes
// of one quad, so row sums need two shuffles and no shared memory.

constexpr int kWgTileBytes = kSsdT * kSsdT * 2;  // 32 KB
constexpr int kWgAtomBytes = kSsdT * 128;        // one [128][64] column atom

// Byte offset of element (r, c) (c % 8 == 0: a 16-byte chunk) in a tile.
__device__ __forceinline__ uint32_t wg_off(int r, int c) {
  return (c >> 6) * kWgAtomBytes + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4);
}

// d[16][4] (+)= A . B for one warpgroup, m64n128k16; TA / TB: the operand is
// MN-major (transposed) in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[16][4], uint64_t da, uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// acc (+)= A . B over K = 128 for warpgroup wg's 64 output rows. A is tile
// ta as [m][k] (AT: as [k][m]), B is tile tb as [k][n] (BT: as [n][k]);
// tiles are shared-memory addresses. Waits for the products to finish.
template <bool AT, bool BT>
__device__ __forceinline__ void wg_mm(float (&acc)[16][4], uint32_t ta, uint32_t tb, int wg,
                                      bool accumulate) {
  reg_fence(acc);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < kSsdT / 16; ++ks) {
    const int c = 16 * ks;
    const uint64_t da =
        AT ? wg_desc(ta + wg * kWgAtomBytes + c * 128, kWgAtomBytes, 1024, 1)
           : wg_desc(ta + (c >> 6) * kWgAtomBytes + wg * 64 * 128 + (c & 63) * 2, 16, 1024, 1);
    const uint64_t db = BT ? wg_desc(tb + (c >> 6) * kWgAtomBytes + (c & 63) * 2, 16, 1024, 1)
                           : wg_desc(tb + c * 128, kWgAtomBytes, 1024, 1);
    wgmma_m64n128<AT ? 1 : 0, BT ? 0 : 1>(acc, da, db, (accumulate || ks > 0) ? 1 : 0);
  }
  wg_commit();
  wg_wait<0>();
  reg_fence(acc);
}

// Stage a 128 x 128 block of S (row stride `stride` elements) into a tile:
// tile(r, c) = bf16(f(r, value)); 16-byte chunks, all loads of a thread
// issued before the first is used. Ends with the proxy fence; the caller
// syncs.
template <typename S, class F>
__device__ __forceinline__ void wg_stage(unsigned char* tile, const S* src, long long stride,
                                         F f) {
  constexpr int V = Vec<S>::n, NV = 8 / V;  // 16-byte loads per 8-column chunk
  uint4 a[8][NV];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int u = threadIdx.x + k * kSsdThreads, r = u >> 4, c0 = (u & 15) * 8;
#pragma unroll
    for (int m = 0; m < NV; ++m) a[k][m] = load_vec(src + r * stride + c0 + m * V);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int u = threadIdx.x + k * kSsdThreads, r = u >> 4, c0 = (u & 15) * 8;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2)
      w[e / 2] = pack2(__float2bfloat16(f(r, vec_at<S>(a[k][e / V], e % V))),
                       __float2bfloat16(f(r, vec_at<S>(a[k][(e + 1) / V], (e + 1) % V))));
    *reinterpret_cast<uint4*>(tile + wg_off(r, c0)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  fence_async_smem();
}

template <bool kPre>
__global__ void __launch_bounds__(kSsdThreads, 1) ssd_bwd_chunk_wg_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dt, const bf16* __restrict__ B,
    const bf16* __restrict__ C, const float* __restrict__ Ba, const float* __restrict__ Ca,
    const bf16* __restrict__ g, const float* __restrict__ fentry, const float* __restrict__ rv,
    const float* __restrict__ A, const float* __restrict__ Dskip,
    const float* __restrict__ dt_bias, float* __restrict__ dx, float* __restrict__ dBh,
    float* __restrict__ dCh, float* __restrict__ ddt, float* __restrict__ dmass,
    float* __restrict__ gx, float* __restrict__ dtp_out, int L, int H, int NG, int reverse) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const int h = blockIdx.x, c = blockIdx.y, nc = gridDim.y, tid = threadIdx.x;
  const long long r = blockIdx.z;
  const int t0 = c * kSsdT, HP = H * kSsdP, NGN = NG * kSsdN;
  unsigned char* tiles = wg_smem;                    // six tiles
  float* dtp = reinterpret_cast<float*>(wg_smem + 6 * kWgTileBytes);  // [T] dt'
  float* segb = dtp + kSsdT;                         // [T] sb
  float* into_e = segb + kSsdT;                      // [T] exp2(into)
  float* scale = into_e + kSsdT;                     // [T] exp2(outof)
  float* total_s = scale + kSsdT;                    // [1] total
  float* red = total_s + 32;                         // [8][T] column-sum scratch
  float* rsum = red + 8 * kSsdT;                     // [T] row sums of Q
  float* csum = rsum + kSsdT;                        // [T] column sums of Q
  float* sred = csum + kSsdT;                        // [32] sum and scan scratch
  float* mi = sred + 32;                             // [T] the chunk-local mass
  float* vout = mi + kSsdT;                          // [T] sum_N B * (x~ Rv^T)
  float* win = vout + kSsdT;                         // [T] sum_N C * ((g exp2(into)) F^T)
  float* ddir = win + kSsdT;                         // [T] sum_P x dx~
  float* xdx = ddir + kSsdT;                         // [T] sum_P x~ dx~
  float* gxv = xdx + kSsdT;                          // [T] sum_P g x
  float* frs = gxv + kSsdT;                          // [T] row sums of Rv * F
  const int wg = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31, gq = lane >> 2, q = lane & 3;
  auto row = [&](int i) { return 64 * wg + 16 * wi + gq + 8 * i; };
  auto col = [&](int j) { return 8 * j + 2 * q; };  // and + 1
  const float A_h = A[h], D_h = Dskip[h], dtb_h = dt_bias[h];
  const long long xrow = (r * L + t0) * HP + h * kSsdP;
  const long long brow = (r * L + t0) * NGN + (h / (H / NG)) * kSsdN;
  const bf16* xr = x + xrow;
  const bf16* gr = g + xrow;
  using BC = std::conditional_t<kPre, float, bf16>;
  const BC* Br;
  const BC* Cr;
  if constexpr (kPre) {
    Br = Ba + brow;
    Cr = Ca + brow;
  } else {
    Br = B + brow;
    Cr = C + brow;
  }
  const long long srow = (r * nc + c) * kSsdN * HP + h * kSsdP;
  const float* Fr = fentry + srow;
  const float* Rr = rv + srow;
  // Tiles: 0 C, 1 B, 2 g (then g exp2(into)), 3 x~ (then F), 4 the scores
  // (then Rv), 5 M.
  unsigned char *tC = tiles, *tB = tiles + kWgTileBytes, *tG = tiles + 2 * kWgTileBytes,
                *tX = tiles + 3 * kWgTileBytes, *tS = tiles + 4 * kWgTileBytes,
                *tM = tiles + 5 * kWgTileBytes;
  const uint32_t sC = smem_u32(tC), sB = smem_u32(tB), sG = smem_u32(tG), sX = smem_u32(tX),
                 sS = smem_u32(tS), sM = smem_u32(tM);
  float accA[16][4], accB[16][4];
  auto as_is = [](int, float v) { return v; };
  // the sums of v(i, j, e) over each of this thread's two rows' 32 columns,
  // completed over the quad: every lane of the quad ends holding them
  auto quad_sum = [&](float s) {
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    return s + __shfl_xor_sync(0xffffffffu, s, 2);
  };

  const DtSrc<bf16> ds{dt + r * L * H + h, H};
  chunk_decays(ds, t0, A_h * kLog2e, dtb_h, reverse, dtp, segb, into_e, scale, total_s);
  wg_stage(tC, Cr, NGN, as_is);
  wg_stage(tB, Br, NGN, as_is);
  wg_stage(tG, gr, HP, as_is);
  wg_stage(tX, xr, HP, [&](int i, float v) { return act<kPre>(v) * dtp[i]; });
  __syncthreads();
  wg_mm<false, true>(accA, sC, sB, wg, false);   // C B^T
  wg_mm<false, true>(accB, sG, sX, wg, false);   // g x~^T

  // 3. the masked decays: the scores and M into their tiles, Q = GBC * M
  //    into accA; the chunk-local mass from Q's row and column sums.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row(i);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int s0 = col(j);
      float sc[2], mm[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = s0 + e;
        const bool keep = reverse ? t <= s : t >= s;
        const float se = exp2f(keep ? segb[t] - segb[s] : __uint_as_float(0xff800000u));
        const float m = accB[j][2 * i + e] * se;
        sc[e] = accA[j][2 * i + e] * se;
        mm[e] = m;
        accA[j][2 * i + e] *= m;
      }
      const uint32_t o = wg_off(t, s0 & ~7) + (s0 & 7) * 2;
      *reinterpret_cast<uint32_t*>(tS + o) =
          pack2(__float2bfloat16(sc[0]), __float2bfloat16(sc[1]));
      *reinterpret_cast<uint32_t*>(tM + o) =
          pack2(__float2bfloat16(mm[0]), __float2bfloat16(mm[1]));
    }
  }
  fence_async_smem();
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // row sums of Q
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) s += accA[j][2 * i] + accA[j][2 * i + 1];
    s = quad_sum(s);
    if (q == 0) rsum[row(i)] = s;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {  // column sums of Q: the warp's 16 rows, then the 8 warps
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = accA[j][e] + accA[j][2 + e];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (gq == 0) red[(tid >> 5) * kSsdT + col(j) + e] = s;
    }
  }
  __syncthreads();  // the scores, M and the sums are written
  if (tid < kSsdT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red[w * kSsdT + tid];
    csum[tid] = s;
  }
  __syncthreads();
  {
    const bool own = tid < kSsdT;
    const float a = scan128(own ? (reverse ? rsum[tid] : csum[tid]) : 0.f, sred);
    const float v = own ? (reverse ? csum[tid] : rsum[tid]) : 0.f;
    const float b = scan128(v, sred + 8) - v;
    if (own) mi[tid] = a - b;
  }

  // 4. dx~ = scores^T g + exp2(outof) B Rv; dx; sum_P x dx~, sum_P x~ dx~,
  //    sum_P g x
  wg_mm<true, false>(accA, sS, sG, wg, false);   // scores^T g
  __syncthreads();  // every read of the scores is done
  wg_stage(tS, Rr, HP, as_is);
  __syncthreads();
  wg_mm<false, false>(accB, sB, sS, wg, false);  // B Rv
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = row(i);
    const float sc = scale[s], dp = dtp[s];
    float s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int p = col(j);
      const float2 xa = load_pair(xr + (long long)s * HP + p);
      const float2 ga = load_pair(gr + (long long)s * HP + p);
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = e ? xa.y : xa.x, gv = e ? ga.y : ga.x;
        const float d = accA[j][2 * i + e] + sc * accB[j][2 * i + e];
        const float2 sg = kPre ? silu_and_grad(a) : make_float2(a, 1.f);
        s1 += sg.x * d;
        s2 += sg.x * dp * d;
        s3 += gv * sg.x;
        float v = dp * d + D_h * gv;
        if constexpr (kPre) v *= sg.y;
        o[e] = v;
      }
      *reinterpret_cast<float2*>(dx + xrow + (long long)s * HP + p) = make_float2(o[0], o[1]);
    }
    s1 = quad_sum(s1);
    s2 = quad_sum(s2);
    if constexpr (kPre) s3 = quad_sum(s3);
    if (q == 0) {
      ddir[s] = s1;
      xdx[s] = s2;
      if constexpr (kPre) gxv[s] = s3;
    }
  }

  // 5. this head's dB = exp2(outof) x~ Rv^T + M^T C; sum_N B (x~ Rv^T)
  wg_mm<false, true>(accA, sX, sS, wg, false);   // x~ Rv^T
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = row(i);
    float s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 b = load_pair(Br + (long long)s * NGN + col(j));
      s1 += b.x * accA[j][2 * i] + b.y * accA[j][2 * i + 1];
    }
    s1 = quad_sum(s1);
    if (q == 0) vout[s] = s1;
    const float sc = scale[s];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      accA[j][2 * i] *= sc;
      accA[j][2 * i + 1] *= sc;
    }
  }
  __syncthreads();  // every read of x~, g and Rv is done
  wg_stage(tG, gr, HP, [&](int i, float v) { return v * into_e[i]; });
  stage2<bf16>((bf16*)nullptr, (bf16*)nullptr, Fr, Rr, HP, frs,
               [](int, float, float) { return 0.f; }, [](int, float, float) { return 0.f; },
               [](int, float f, float rvv) { return f * rvv; });
  wg_stage(tX, Fr, HP, as_is);
  wg_mm<true, false>(accA, sM, sC, wg, true);    // += M^T C
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* o = dBh + ((r * L + t0 + row(i)) * H + h) * kSsdN;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(o + col(j)) = make_float2(accA[j][2 * i], accA[j][2 * i + 1]);
  }

  // 6. this head's dC = M B + (g exp2(into)) F^T; sum_N C (g exp2(into)) F^T
  wg_mm<false, false>(accA, sM, sB, wg, false);  // M B
  __syncthreads();  // g exp2(into) and F are staged
  wg_mm<false, true>(accB, sG, sX, wg, false);   // (g exp2(into)) F^T
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row(i);
    float s1 = 0.f;
    float* o = dCh + ((r * L + t0 + t) * H + h) * kSsdN;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 cc = load_pair(Cr + (long long)t * NGN + col(j));
      s1 += cc.x * accB[j][2 * i] + cc.y * accB[j][2 * i + 1];
      *reinterpret_cast<float2*>(o + col(j)) =
          make_float2(accA[j][2 * i] + accB[j][2 * i], accA[j][2 * i + 1] + accB[j][2 * i + 1]);
    }
    s1 = quad_sum(s1);
    if (q == 0) win[t] = s1;
  }
  __syncthreads();
  const float scal = block_sum(tid < kSsdT ? frs[tid] : 0.f, sred);
  mass_and_ddt<kPre>(ds, reverse, total_s[0], scal, A_h, dtb_h, t0, (r * L + t0) * H + h, H, dtp,
                     scale, mi, vout, win, ddir, xdx, gxv, red, sred, ddt, dmass, gx, dtp_out);
}

inline size_t bwd_chunk_wg_smem() {
  return 6 * kWgTileBytes + sizeof(float) * (21 * kSsdT + 64);
}

// (d): dB and dC [R*L, NG, N] from the heads' parts [R*L, H, N], summed
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
                           float* dBh, float* dCh, float* rv, float* tot, float* Ba, float* Ca,
                           int R, int L, int H, int NG, int reverse, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* dtt = static_cast<const T*>(dt);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  const T* gt = static_cast<const T*>(g);
  const int nc = L / kSsdT;
  constexpr bool kWg = std::is_same<T, bf16>::value;  // bf16: the chunk on wgmma
  const size_t sa = bwd_state_smem<T>(), sc = kWg ? bwd_chunk_wg_smem() : bwd_chunk_smem<T>();
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_state_kernel<T, kPre>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (e != cudaSuccess) return e;
  if constexpr (kWg)
    e = cudaFuncSetAttribute(ssd_bwd_chunk_wg_kernel<kPre>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sc);
  else
    e = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T, kPre>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sc);
  if (e != cudaSuccess) return e;
  const long long n_out = (long long)R * L * NG * kSsdN;
  const unsigned gblocks = (unsigned)((n_out + kGroupThreads - 1) / kGroupThreads);
  if constexpr (kPre) {
    ssd_bwd_act_kernel<T><<<gblocks, kGroupThreads, 0, s>>>(Bt, Ct, Ba, Ca, n_out);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(H, nc, R);
  ssd_bwd_state_kernel<T, kPre><<<grid, kSsdThreads, sa, s>>>(dtt, Ct, Ca, gt, A, dt_bias, rv,
                                                              tot, L, H, NG, reverse);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n4 = (long long)R * kSsdN * H * kSsdP / 4;
  ssd_bwd_pass_kernel<<<(unsigned)((n4 + kPassThreads - 1) / kPassThreads), kPassThreads, 0,
                        s>>>(rv, tot, n4, nc, H, reverse);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (kWg)
    ssd_bwd_chunk_wg_kernel<kPre><<<grid, kSsdThreads, sc, s>>>(
        xt, dtt, Bt, Ct, Ba, Ca, gt, fentry, rv, A, Dskip, dt_bias, dx, dBh, dCh, ddt, dmass, gx,
        dtp, L, H, NG, reverse);
  else
    ssd_bwd_chunk_kernel<T, kPre><<<grid, kSsdThreads, sc, s>>>(
        xt, dtt, Bt, Ct, Ba, Ca, gt, fentry, rv, A, Dskip, dt_bias, dx, dBh, dCh, ddt, dmass, gx,
        dtp, L, H, NG, reverse);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_group_kernel<T, kPre><<<gblocks, kGroupThreads, 0, s>>>(dBh, dCh, Bt, Ct, dB, dC,
                                                                   n_out, H, NG);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ssd_bwd_any(const void* x, const void* dt, const void* B, const void* C,
                               const void* g, const float* fentry, const float* A,
                               const float* Dskip, const float* dt_bias, float* dx, float* dB,
                               float* dC, float* ddt, float* dmass, float* gx, float* dtp,
                               float* dBh, float* dCh, float* rv, float* tot, float* Ba,
                               float* Ca, int R, int L, int H, int NG, int reverse,
                               int pre_silu, cudaStream_t s) {
  if (pre_silu)
    return launch_ssd_bwd<T, true>(x, dt, B, C, g, fentry, A, Dskip, dt_bias, dx, dB, dC, ddt,
                                   dmass, gx, dtp, dBh, dCh, rv, tot, Ba, Ca, R, L, H, NG,
                                   reverse, s);
  return launch_ssd_bwd<T, false>(x, dt, B, C, g, fentry, A, Dskip, dt_bias, dx, dB, dC, ddt,
                                  dmass, gx, dtp, dBh, dCh, rv, tot, Ba, Ca, R, L, H, NG,
                                  reverse, s);
}

}  // namespace pc

// P = N = chunk = 128, L % 128 == 0 and NG | H are the wrapper's to check.
// x, g [R, L, H*P], dt [R, L, H], B, C [R, L, NG, N] of one dtype; fentry
// [R, L/128, N, H*P] and A, Dskip, dt_bias [H] float32. Outputs, float32: dx
// [R, L, H*P], dB, dC [R, L, NG, N], ddt, dmass [R, L, H], and with pre_silu
// gx, dtp [R, L, H] (null otherwise). Scratch, float32: dBh, dCh [R, L, H,
// N], rv [R, L/128, N, H*P], tot [R, L/128, H], and with pre_silu Ba, Ca
// [R, L, NG, N] (null otherwise).
extern "C" int pc_ssd_bwd(const void* x, const void* dt, const void* B, const void* C,
                          const void* g, const float* fentry, const float* A,
                          const float* Dskip, const float* dt_bias, float* dx, float* dB,
                          float* dC, float* ddt, float* dmass, float* gx, float* dtp,
                          float* dBh, float* dCh, float* rv, float* tot, float* Ba, float* Ca,
                          int R, int L, int H, int NG, int reverse, int pre_silu, int bf16,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pc::launch_ssd_bwd_any<__nv_bfloat16>(x, dt, B, C, g, fentry, A, Dskip, dt_bias, dx,
                                                 dB, dC, ddt, dmass, gx, dtp, dBh, dCh, rv,
                                                 tot, Ba, Ca, R, L, H, NG, reverse, pre_silu,
                                                 s);
  return pc::launch_ssd_bwd_any<float>(x, dt, B, C, g, fentry, A, Dskip, dt_bias, dx, dB, dC,
                                       ddt, dmass, gx, dtp, dBh, dCh, rv, tot, Ba, Ca, R, L, H,
                                       NG, reverse, pre_silu, s);
}
