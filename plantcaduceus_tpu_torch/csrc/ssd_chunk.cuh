// The chunk-parallel SSD (Mamba-2) forward of one direction, shared by K4
// (ssd_fwd.cu) and K5 (mixer2_fwd.cu): three kernels on one stream over a
// policy that says where x comes from and what the epilogue does.
//
// Math as ssd_core.cuh (per row, head h of group g, chunk of T = 128 steps):
//   y = scores (x dt') + (C S) exp2(into) + D x,
//   S = exp2(total) S + B^T (x dt' exp2(outof)).
// The TPU kernel walks the chunks of a row in order with the state of all
// heads in VMEM. Here the only serial part is the state's recurrence, and it
// is elementwise once each chunk's increment is known:
//  (a) ssd_state_kernel, per (row, chunk, head), all chunks but the last
//      processed one at once: the increment B^T (x dt' exp2(outof)) [N, P]
//      into the chunk's slot of the state buffer fe [R, L/128, N, H*P] and
//      the chunk's total decay into tot.
//  (b) ssd_pass_kernel, per four elements of a row's state: S = exp2(total)
//      S + increment over the chunks in processing order, in place, so each
//      slot ends holding the state entering its chunk: fentry itself (the
//      inference variant's fe is scratch).
//  (c) ssd_chunk_kernel, per (row, chunk, head), all chunks at once: C B^T,
//      the masked scores, acc = (C S) exp2(into) + scores (x dt'), then the
//      policy's epilogue with D x.
// bfloat16 runs (a) and (c) on wgmma over tiles in the layout ssd_sm90.cuh
// sets out (two in (a); four in (c): C, B then the scores, x dt', the
// state); float32 on ssd_core.cuh's FMA block products over reused
// [128][LD] tiles. B and C are staged from [R, L, NG*N] operands in the
// input dtype with 16-byte loads. x is staged straight into the tiles of
// (a) and (c), in float32 too for the D-skip, so nothing reads it twice
// from device memory. No atomics: two launches give equal bits.
//
// A policy Pol gives: T (the input dtype), Args (SsdChunkArgs<T>'s fields),
//   x_block<kChunk>(a, r, h, t0, out)  every thread calls it; out(i, c0, x)
//       receives x of chunk rows i, channels c0 .. c0+7 of head h, as float;
//       each (i, c0) once (kChunk: the call of (c), else of (a));
//   Ahead<Fr>                          loaded before (c)'s last product, so
//       the loads overlap it (load(a, fr, o0));
//   epilogue(a, fr, acc, ahead, xs, xld, D, o0, p0) over a thread's part of
//       the [T, P] output in either accumulator layout (Fr).

#pragma once

#include "ssd_sm90.cuh"

namespace pc {

constexpr int kPassThreads = 256;
constexpr int kXsLd = kSsdP + 4;  // row stride of (c)'s float32 x tile in bfloat16

// Eight float values to T at p (16-byte aligned).
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
  if constexpr (std::is_same<T, float>::value) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        pack2(__float2bfloat16(v[0]), __float2bfloat16(v[1])),
        pack2(__float2bfloat16(v[2]), __float2bfloat16(v[3])),
        pack2(__float2bfloat16(v[4]), __float2bfloat16(v[5])),
        pack2(__float2bfloat16(v[6]), __float2bfloat16(v[7])));
  }
}

template <typename T>
struct SsdChunkArgs {
  const T* x;    // [R, L, H*P]: the policy's x input
  const T* Bs;   // [R, L, NG*N] B and C as product operands
  const T* Cs;
  const T* dt;   // [R, L, H] raw
  const float *A, *Dskip, *dt_bias;  // [H]
  float* fe;     // [R, L/128, N, H*P]: increments, then the entry states
  float* tot;    // [R, L/128, H] chunk total decays
  int L, H, NG, reverse;
};

// Stage a 128 x 128 float32 block (row stride `stride` elements) into a
// [128][LD] tile of ssd_core.cuh's float32 layout: 16-byte loads, sixteen a
// thread, all issued before the first store. Every thread calls it; the
// caller syncs.
__device__ __forceinline__ void stage_tile(float* tile, const float* __restrict__ src,
                                           long long stride) {
  constexpr int LD = SsdLd<float>::v;
  float4 v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int u = threadIdx.x + k * kSsdThreads;
    v[k] = __ldg(reinterpret_cast<const float4*>(src + (u >> 5) * stride + (u & 31) * 4));
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int u = threadIdx.x + k * kSsdThreads;
    float* t = tile + (u >> 5) * LD + (u & 31) * 4;
    t[0] = v[k].x; t[1] = v[k].y; t[2] = v[k].z; t[3] = v[k].w;
  }
}

// The accumulator layout of ssd_core.cuh's Tile (float32): rows row(i), i <
// 4, column pairs cb + 8j + 2q (+1), j < 8; two warps share a row.
struct TileFrag {
  static constexpr int NI = 4, NJ = 8, kParts = 2;
  Tile tl;
  int q;
  __device__ TileFrag() { q = tl.q; }
  __device__ int row(int i) const { return tl.row(i); }
  __device__ int col(int j) const { return tl.col(2 * j); }
  __device__ int part() const { return tl.part(); }
  __device__ static float& at(float (&acc)[4][16], int i, int j, int e) {
    return acc[i][2 * j + e];
  }
};

// The accumulator layout of wgmma m64n128 (ssd_sm90.cuh): rows row(i), i <
// 2, column pairs 8j + 2q (+1), j < 16; a row's columns lie in one quad.
struct WgFrag {
  static constexpr int NI = 2, NJ = 16, kParts = 1;
  int wg, wi, g, q;
  __device__ WgFrag() {
    const int tid = threadIdx.x, lane = tid & 31;
    wg = tid >> 7;
    wi = (tid >> 5) & 3;
    g = lane >> 2;
    q = lane & 3;
  }
  __device__ int row(int i) const { return 64 * wg + 16 * wi + g + 8 * i; }
  __device__ int col(int j) const { return 8 * j + 2 * q; }
  __device__ int part() const { return 0; }
  __device__ static float& at(float (&acc)[16][4], int i, int j, int e) {
    return acc[j][2 * i + e];
  }
};

// The x block of chunk rows 0..127 of one head, loaded as it is: thread u
// owns channels 8(u % 16) .. +8 and rows 8(u / 16) .. +8, all its 16-byte
// loads issued before the first value is used; out(i, c0, x[8]) as the
// policy's x_block. `in` is at (step t0, the head's first channel).
template <typename T, class Out>
__device__ __forceinline__ void load_block(const T* __restrict__ in, long long stride, Out out) {
  const int c0 = (threadIdx.x & 15) * 8, r0 = (threadIdx.x >> 4) * 8;
  constexpr int V = std::is_same<T, float>::value ? 2 : 1;  // 16-byte loads per row
  uint4 raw[8][V];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v)
      raw[j][v] = __ldg(reinterpret_cast<const uint4*>(in + (r0 + j) * stride + c0) + v);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = vec_at<T>(raw[j][e * V / 8], e % (8 / V));
    out(r0 + j, c0, x);
  }
}

// (a): one (row, chunk, head)'s increment B^T (x dt' exp2(outof)) into its
// slot of fe, and the chunk's total decay. blockIdx.y counts the chunks in
// processing order, all but the last. In float32: tiles of ssd_core.cuh's
// layout and its FMA block product.
template <class Pol>
__global__ void __launch_bounds__(kSsdThreads, 2) ssd_state_kernel(typename Pol::Args a) {
  using T = float;
  static_assert(std::is_same<typename Pol::T, float>::value, "the float32 state kernel");
  extern __shared__ __align__(16) unsigned char ssd_st_smem[];
  constexpr int LD = SsdLd<T>::v;
  const int h = blockIdx.x, nc = a.L / kSsdT;
  const int c = a.reverse ? nc - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const long long r = blockIdx.z;
  const int t0 = c * kSsdT, di = a.H * kSsdP, NGN = a.NG * kSsdN;
  const int g = h / (a.H / a.NG);
  float* dtp = reinterpret_cast<float*>(ssd_st_smem);  // [T] dt'
  float* segb = dtp + kSsdT;                            // [T] sb (unused here)
  float* into_e = segb + kSsdT;                         // [T] exp2(into) (unused here)
  float* scale = into_e + kSsdT;                        // [T] exp2(outof)
  float* total_s = scale + kSsdT;                       // [1] total
  T* tb = reinterpret_cast<T*>(total_s + 32);           // [T][LD] B
  T* tx = tb + kSsdT * LD;                              // [T][LD] x dt' exp2(outof)
  const DtSrc<T> ds{a.dt + r * a.L * a.H + h, a.H};
  chunk_decays(ds, t0, a.A[h] * kLog2e, a.dt_bias[h], a.reverse, dtp, segb, into_e, scale,
               total_s);
  stage_tile(tb, a.Bs + (r * a.L + t0) * NGN + g * kSsdN, NGN);
  Pol::template x_block<false>(a, r, h, t0, [&](int i, int c0, const float (&x)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e) tx[i * LD + c0 + e] = from_f<T>(x[e] * dtp[i] * scale[i]);
  });
  __syncthreads();
  const Tile tl;
  float acc[4][16];
  zero(acc);
  block_mm<true, false, float>(acc, tl, tb, LD, tx, LD);
  float* o = a.fe + (r * nc + c) * kSsdN * di + h * kSsdP;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; j += 2)
      *reinterpret_cast<float2*>(o + (long long)tl.row(i) * di + tl.col(j)) =
          make_float2(acc[i][j], acc[i][j + 1]);
  if (threadIdx.x == 0) a.tot[(r * nc + c) * a.H + h] = total_s[0];
}

inline size_t state_smem() {
  return sizeof(float) * (4 * kSsdT + 32 + 2 * kSsdT * SsdLd<float>::v);
}

// (a) in bfloat16 on wgmma: the B tile and the decayed x tile in the layout
// wgmma reads (ssd_sm90.cuh), the product B^T (x dt' exp2(outof)) with the
// B tile read MN-major.
template <class Pol>
__global__ void __launch_bounds__(kSsdThreads, 2) ssd_state_wg_kernel(typename Pol::Args a) {
  static_assert(std::is_same<typename Pol::T, bf16>::value, "the bfloat16 state kernel");
  extern __shared__ __align__(1024) unsigned char ssd_stw_smem[];
  const int h = blockIdx.x, nc = a.L / kSsdT;
  const int c = a.reverse ? nc - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const long long r = blockIdx.z;
  const int t0 = c * kSsdT, di = a.H * kSsdP, NGN = a.NG * kSsdN;
  const int g = h / (a.H / a.NG);
  unsigned char *tB = ssd_stw_smem, *tX = tB + kWgTileBytes;
  float* dtp = reinterpret_cast<float*>(tX + kWgTileBytes);  // [T] dt'
  float* segb = dtp + kSsdT;                                  // [T] sb (unused here)
  float* into_e = segb + kSsdT;                               // [T] exp2(into) (unused here)
  float* scale = into_e + kSsdT;                              // [T] exp2(outof)
  float* total_s = scale + kSsdT;                             // [1] total
  const DtSrc<bf16> ds{a.dt + r * a.L * a.H + h, a.H};
  chunk_decays(ds, t0, a.A[h] * kLog2e, a.dt_bias[h], a.reverse, dtp, segb, into_e, scale,
               total_s);
  wg_stage(tB, a.Bs + (r * a.L + t0) * NGN + g * kSsdN, NGN, [](int, float v) { return v; });
  Pol::template x_block<false>(a, r, h, t0, [&](int i, int c0, const float (&x)[8]) {
    float xs[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) xs[e] = x[e] * dtp[i] * scale[i];
    store8(reinterpret_cast<bf16*>(tX + wg_off(i, c0)), xs);
  });
  fence_async_smem();
  __syncthreads();
  const WgFrag fr;
  float acc[16][4];
  wg_mm<true, false>(acc, smem_u32(tB), smem_u32(tX), fr.wg, false);
  float* o = a.fe + (r * nc + c) * kSsdN * di + h * kSsdP;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(o + (long long)fr.row(i) * di + fr.col(j)) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
  if (threadIdx.x == 0) a.tot[(r * nc + c) * a.H + h] = total_s[0];
}

inline size_t state_wg_smem() { return 2 * kWgTileBytes + sizeof(float) * (4 * kSsdT + 32); }

// (b): per four neighbouring elements of a row's state [N, di], S = exp2(total)
// S + increment over the chunks in processing order (reverse: from the last
// chunk), in place: each chunk's slot ends holding the state entering it (0
// for the first). Four chunks' increments are loaded at once.
__global__ void __launch_bounds__(kPassThreads) ssd_pass_kernel(
    float* __restrict__ fe, const float* __restrict__ tot, long long n4, int nc, int H,
    int reverse) {
  const long long e = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= n4) return;
  const int di = H * kSsdP;
  const long long row4 = (long long)kSsdN * di / 4;  // float4s of one chunk's state
  const long long r = e / row4;
  const long long o4 = e % row4;
  const int h = (int)((o4 * 4) % di) / kSsdP;
  auto chunk = [&](int k) { return reverse ? nc - 1 - k : k; };
  auto slot = [&](int k) {
    return reinterpret_cast<float4*>(fe + (r * nc + chunk(k)) * kSsdN * di) + o4;
  };
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < nc; k0 += 4) {
    float4 inc[4];
    float te[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (k0 + u < nc - 1) {  // the last chunk's increment was never written
        inc[u] = *slot(k0 + u);
        te[u] = exp2f(tot[(r * nc + chunk(k0 + u)) * H + h]);
      }
    }
    float4 out[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      out[u] = s;
      if (k0 + u < nc - 1)
        s = make_float4(te[u] * s.x + inc[u].x, te[u] * s.y + inc[u].y, te[u] * s.z + inc[u].z,
                        te[u] * s.w + inc[u].w);
    }
    // stored in descending address order: in ascending order (the forward
    // direction's processing order) this kernel runs 2.7x slower on the H100
#pragma unroll
    for (int u = 3; u >= 0; --u) {
      const int k = reverse ? k0 + 3 - u : k0 + u;
      if (k < nc) *slot(k) = out[k - k0];
    }
  }
}

// Two 128 x 128 blocks of bfloat16 (row strides sa, sb) into two tiles of
// ssd_sm90.cuh's layout, all sixteen 16-byte loads of a thread issued before
// the first store; ends with the proxy fence (the caller syncs).
__device__ __forceinline__ void wg_stage_two(unsigned char* ta, const bf16* __restrict__ a,
                                             long long sa, unsigned char* tb,
                                             const bf16* __restrict__ b, long long sb) {
  uint4 va[8], vb[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int u = threadIdx.x + k * kSsdThreads, r = u >> 4, c0 = (u & 15) * 8;
    va[k] = __ldg(reinterpret_cast<const uint4*>(a + r * sa + c0));
    vb[k] = __ldg(reinterpret_cast<const uint4*>(b + r * sb + c0));
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int u = threadIdx.x + k * kSsdThreads, r = u >> 4, c0 = (u & 15) * 8;
    *reinterpret_cast<uint4*>(ta + wg_off(r, c0)) = va[k];
    *reinterpret_cast<uint4*>(tb + wg_off(r, c0)) = vb[k];
  }
  fence_async_smem();
}

// Where a (row, chunk, head) block of (c) starts in each tensor.
struct ChunkAt {
  long long r, o0, p0, bc0, fe0;
  int h, c, g, t0, nc, di, NGN;
  bool first;
  template <class Args>
  __device__ ChunkAt(const Args& a, int parts) {
    h = blockIdx.x;
    c = blockIdx.y;
    r = blockIdx.z;
    nc = a.L / kSsdT;
    t0 = c * kSsdT;
    di = a.H * kSsdP;
    NGN = a.NG * kSsdN;
    g = h / (a.H / a.NG);
    o0 = (r * a.L + t0) * di + h * kSsdP;
    p0 = ((r * a.L + t0) * a.H + h) * parts;
    bc0 = (r * a.L) * NGN + g * kSsdN;  // at step 0 of the row
    fe0 = (r * nc + c) * kSsdN * di + h * kSsdP;
    first = c == (a.reverse ? nc - 1 : 0);  // the entry state is 0
  }
};

// (c) in float32: three [128][LD] tiles, reused: C then x dt'; B then the
// scores; the state then x (float32, for the D-skip).
template <class Pol>
__global__ void __launch_bounds__(kSsdThreads, 1) ssd_chunk_kernel(typename Pol::Args a) {
  using T = float;
  static_assert(std::is_same<typename Pol::T, float>::value, "the float32 chunk kernel");
  extern __shared__ __align__(16) unsigned char ssd_ch_smem[];
  constexpr int LD = SsdLd<T>::v;
  const ChunkAt at(a, TileFrag::kParts);
  const int tid = threadIdx.x;
  float* dtp = reinterpret_cast<float*>(ssd_ch_smem);
  float* segb = dtp + kSsdT;
  float* into_e = segb + kSsdT;
  float* scale = into_e + kSsdT;
  float* total_s = scale + kSsdT;
  T* t1 = reinterpret_cast<T*>(total_s + 32);
  T* t2 = t1 + kSsdT * LD;
  T* t3 = t2 + kSsdT * LD;
  const Tile tl;
  const DtSrc<T> ds{a.dt + at.r * a.L * a.H + at.h, a.H};
  chunk_decays(ds, at.t0, a.A[at.h] * kLog2e, a.dt_bias[at.h], a.reverse, dtp, segb, into_e,
               scale, total_s);
  stage_tile(t1, a.Cs + at.bc0 + (long long)at.t0 * at.NGN, at.NGN);
  stage_tile(t2, a.Bs + at.bc0 + (long long)at.t0 * at.NGN, at.NGN);
  __syncthreads();
  float acc[4][16];
  zero(acc);
  block_mm<false, true, float>(acc, tl, t1, LD, t2, LD);  // C B^T
  __syncthreads();  // every read of B is done
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tl.row(i);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int s = tl.col(j);
      const bool keep = a.reverse ? t <= s : t >= s;
      const float seg = keep ? segb[t] - segb[s] : __uint_as_float(0xff800000u);  // -inf
      t2[t * LD + s] = from_f<T>(acc[i][j] * exp2f(seg));
    }
  }
  zero(acc);
  if (!at.first) {
    const float* fe = a.fe + at.fe0;
    for (int e = tid; e < kSsdN * kSsdP; e += kSsdThreads)
      t3[(e >> 7) * LD + (e & 127)] = from_f<T>(fe[(long long)(e >> 7) * at.di + (e & 127)]);
    __syncthreads();
    block_mm<false, false, T>(acc, tl, t1, LD, t3, LD);  // C S
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float f = into_e[tl.row(i)];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] *= f;
    }
  }
  __syncthreads();  // every read of C and S is done; the scores are written
  Pol::template x_block<true>(a, at.r, at.h, at.t0, [&](int i, int c0, const float (&x)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      t1[i * LD + c0 + e] = from_f<T>(x[e] * dtp[i]);
      t3[i * LD + c0 + e] = x[e];
    }
  });
  __syncthreads();
  block_mm<false, false, float>(acc, tl, t2, LD, t1, LD);  // += scores (x dt')
  const TileFrag fr;
  typename Pol::template Ahead<TileFrag> ahead;
  ahead.load(a, fr, at.o0);
  Pol::epilogue(a, fr, acc, ahead, t3, LD, a.Dskip[at.h], at.o0, at.p0);
}

inline size_t chunk_smem() {
  return sizeof(float) * (4 * kSsdT + 32 + 3 * kSsdT * SsdLd<float>::v);
}

// (c) in bfloat16 on wgmma: four [128][128] tiles (C; B, then the scores;
// x dt'; the state) and x in float32 [128][kXsLd] for the D-skip.
template <class Pol>
__global__ void __launch_bounds__(kSsdThreads, 1) ssd_chunk_wg_kernel(typename Pol::Args a) {
  static_assert(std::is_same<typename Pol::T, bf16>::value, "the bfloat16 chunk kernel");
  extern __shared__ __align__(1024) unsigned char ssd_chw_smem[];
  const ChunkAt at(a, WgFrag::kParts);
  unsigned char *tC = ssd_chw_smem, *tB = tC + kWgTileBytes, *tX = tB + kWgTileBytes,
                *tS = tX + kWgTileBytes;
  float* xs = reinterpret_cast<float*>(tS + kWgTileBytes);  // [T][kXsLd]
  float* dtp = xs + kSsdT * kXsLd;
  float* segb = dtp + kSsdT;
  float* into_e = segb + kSsdT;
  float* scale = into_e + kSsdT;
  float* total_s = scale + kSsdT;
  const uint32_t sC = smem_u32(tC), sB = smem_u32(tB), sX = smem_u32(tX), sS = smem_u32(tS);
  const WgFrag fr;
  const DtSrc<bf16> ds{a.dt + at.r * a.L * a.H + at.h, a.H};
  chunk_decays(ds, at.t0, a.A[at.h] * kLog2e, a.dt_bias[at.h], a.reverse, dtp, segb, into_e,
               scale, total_s);
  auto as_is = [](int, float v) { return v; };
  wg_stage_two(tC, a.Cs + at.bc0 + (long long)at.t0 * at.NGN, at.NGN, tB,
               a.Bs + at.bc0 + (long long)at.t0 * at.NGN, at.NGN);
  Pol::template x_block<true>(a, at.r, at.h, at.t0, [&](int i, int c0, const float (&x)[8]) {
    float xd[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) xd[e] = x[e] * dtp[i];
    store8(xs + i * kXsLd + c0, x);
    store8(reinterpret_cast<bf16*>(tX + wg_off(i, c0)), xd);
  });
  fence_async_smem();
  if (!at.first) wg_stage(tS, a.fe + at.fe0, at.di, as_is);
  __syncthreads();
  float acc[16][4];
  wg_mm<false, true>(acc, sC, sB, fr.wg, false);  // C B^T
  __syncthreads();  // every read of B is done
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = fr.row(i);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int s0 = fr.col(j);
      float sc[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = s0 + e;
        const bool keep = a.reverse ? t <= s : t >= s;
        const float seg = keep ? segb[t] - segb[s] : __uint_as_float(0xff800000u);  // -inf
        sc[e] = acc[j][2 * i + e] * exp2f(seg);
      }
      *reinterpret_cast<uint32_t*>(tB + wg_off(t, s0 & ~7) + (s0 & 7) * 2) =
          pack2(__float2bfloat16(sc[0]), __float2bfloat16(sc[1]));
    }
  }
  fence_async_smem();
  if (!at.first) {
    wg_mm<false, false>(acc, sC, sS, fr.wg, false);  // C S
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float f = into_e[fr.row(i)];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[j][2 * i] *= f;
        acc[j][2 * i + 1] *= f;
      }
    }
  }
  typename Pol::template Ahead<WgFrag> ahead;
  ahead.load(a, fr, at.o0);
  __syncthreads();  // the scores are written
  wg_mm<false, false>(acc, sB, sX, fr.wg, !at.first);  // (+)= scores (x dt')
  Pol::epilogue(a, fr, acc, ahead, xs, kXsLd, a.Dskip[at.h], at.o0, at.p0);
}

inline size_t chunk_wg_smem() {
  return 4 * kWgTileBytes + sizeof(float) * (kSsdT * kXsLd + 4 * kSsdT + 32);
}

// Launch a kernel that takes more than 48 KB of dynamic shared memory.
template <class K, class A>
cudaError_t launch_big(K kern, dim3 grid, size_t smem, cudaStream_t s, const A& a) {
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kSsdThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// (a), (b) and (c) of one direction over R rows, on stream s.
template <class Pol>
cudaError_t launch_ssd_chunked(const typename Pol::Args& a, int R, cudaStream_t s) {
  constexpr bool kBf16 = std::is_same<typename Pol::T, bf16>::value;
  const int nc = a.L / kSsdT, di = a.H * kSsdP;
  cudaError_t e;
  if (nc > 1) {
    const dim3 sgrid(a.H, nc - 1, R);
    if constexpr (kBf16)
      e = launch_big(ssd_state_wg_kernel<Pol>, sgrid, state_wg_smem(), s, a);
    else
      e = launch_big(ssd_state_kernel<Pol>, sgrid, state_smem(), s, a);
    if (e != cudaSuccess) return e;
  }
  const long long n4 = (long long)R * kSsdN * di / 4;
  ssd_pass_kernel<<<(unsigned)((n4 + kPassThreads - 1) / kPassThreads), kPassThreads, 0, s>>>(
      a.fe, a.tot, n4, nc, a.H, a.reverse);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid(a.H, nc, R);
  if constexpr (kBf16)
    return launch_big(ssd_chunk_wg_kernel<Pol>, grid, chunk_wg_smem(), s, a);
  else
    return launch_big(ssd_chunk_kernel<Pol>, grid, chunk_smem(), s, a);
}

}  // namespace pc
