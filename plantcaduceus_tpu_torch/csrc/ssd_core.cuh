// SSD (Mamba-2) chunk math, shared device code of K4 (ssd_fwd.cu) and K5
// (mixer2_fwd.cu) through ssd_chunk.cuh, and of K6 (ssd_bwd.cu): the float32
// block products, the tile layout they read and the per-chunk decay vectors.
//
// Math (one row, one head h of group g; chunk of T steps), the same as
// plantcaduceus_tpu/ops/pallas_ssd.py::ssd_chunk_core:
//   dt'    = softplus(dt + dt_bias)                la = dt' * A * log2(e)
//   cum    = inclusive cumsum of la over the chunk, total = cum[T-1]
//   GBC    = C @ B^T                               [T, T]
//   scores = GBC * exp2(mask ? seg : -inf)         seg[t,s] = sb[t] - sb[s]
//   y      = scores @ (x*dt') + (C @ S) * exp2(into) + D * x
//   S      = exp2(total) * S + B^T @ (x*dt'*exp2(outof))
// forward: sb = into = cum, outof = total - cum, mask t >= s;
// reverse: e = cum - la, sb = -e, into = total - e, outof = e, mask t <= s.
// The segment sums are masked before the exponent, as the TPU kernel does:
// a masked-out seg can be large and positive, and exp2 of it times 0 is nan.
//
// Numerics: every decay, the state S and every sum are float32. The
// products take their operands in E, the kernel's product type (bfloat16
// when the inputs are bfloat16, else float32): C, B, the scores, x*dt', the
// decayed x and the state (rounded to E only as an operand of C @ S), with
// float32 accumulation, as the TPU's MXU products with
// preferred_element_type=float32.
//
// Each product here is a 128 x 128 x 128 block product over shared-memory
// tiles [128][LD], 256 threads, each owning 4 rows x 16 columns of the
// output in the layout of mma.m16n8k16's accumulators (struct Tile).
// float32: FMA loops (the float32 kernels of K4, K5 and K6); bfloat16:
// mma.sync on the tensor cores, fragments read from the tiles with 32-bit
// loads (K6's local kernel; the other bfloat16 products run on wgmma,
// ssd_sm90.cuh).

#pragma once

#include <stdint.h>

#include <type_traits>

#include "scan_core.cuh"

namespace pc {

constexpr int kSsdT = 128;        // chunk length
constexpr int kSsdP = 128;        // head dim
constexpr int kSsdN = 128;        // state size
constexpr int kSsdThreads = 256;  // 8 warps, each a 32 x 64 part of every product

// Row stride (elements) of the [128][LD] tiles: odd in 32-bit words for
// float32 (the FMA loops' strided reads), 68 words for bfloat16 (the
// tensor-core fragment loads of 8 rows x 4 words fall on 32 banks).
template <typename E> struct SsdLd;
template <> struct SsdLd<float> { static constexpr int v = 129; };
template <> struct SsdLd<__nv_bfloat16> { static constexpr int v = 136; };

template <typename E>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<E>(v)); }

// A thread's share of a 128 x 128 product: 4 rows x 16 columns, laid out as
// the accumulators of mma.m16n8k16 (warp w covers rows 32*(w/2) .. +32 and
// columns 64*(w%2) .. +64; lane = 4g + q). acc[i][j] is (row(i), col(j)).
struct Tile {
  int rb, cb, g, q;
  __device__ Tile() {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    rb = 32 * (w >> 1);
    cb = 64 * (w & 1);
    g = lane >> 2;
    q = lane & 3;
  }
  __device__ int row(int i) const { return rb + (i >> 1) * 16 + (i & 1) * 8 + g; }
  __device__ int col(int j) const { return cb + (j >> 1) * 8 + 2 * q + (j & 1); }
  __device__ int part() const { return cb >> 6; }  // which of the two warps of a row
};

__device__ __forceinline__ void zero(float (&acc)[4][16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
}

// float32: FMA loops. acc[i][j] += sum_k A(row(i), k) * B(k, col(j)) over
// k < 128. A(m, k) = a[m*lda + k] (AT: a[k*lda + m]); B(k, n) = b[k*ldb + n]
// (BT: b[n*ldb + k]); B's values are rounded through RB.
template <bool AT, bool BT, typename RB, typename TA, typename TB>
__device__ __forceinline__ void block_mm_fma(float (&acc)[4][16], const Tile& tl,
                                             const TA* __restrict__ a, int lda,
                                             const TB* __restrict__ b, int ldb) {
#pragma unroll 2
  for (int k = 0; k < 128; ++k) {
    float av[4], bv[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = tl.row(i);
      av[i] = to_f(AT ? a[k * lda + m] : a[m * lda + k]);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = tl.col(j);
      bv[j] = round_to<RB>(to_f(BT ? b[n * ldb + k] : b[k * ldb + n]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Two bf16 of A at (m, k), (m, k+1), packed low to high.
template <bool AT>
__device__ __forceinline__ uint32_t a_pair(const bf16* a, int lda, int m, int k) {
  if (AT) return pack2(a[k * lda + m], a[(k + 1) * lda + m]);
  return *reinterpret_cast<const uint32_t*>(a + m * lda + k);
}

// Two bf16 of B at (k, n), (k+1, n); a float32 B (the state S, the
// backward's Rv and F) is rounded.
template <bool BT, typename TB>
__device__ __forceinline__ uint32_t b_pair(const TB* b, int ldb, int k, int n) {
  if constexpr (std::is_same<TB, float>::value) {
    if (BT) return pack2(__float2bfloat16(b[n * ldb + k]), __float2bfloat16(b[n * ldb + k + 1]));
    return pack2(__float2bfloat16(b[k * ldb + n]), __float2bfloat16(b[(k + 1) * ldb + n]));
  } else {
    if (BT) return *reinterpret_cast<const uint32_t*>(b + n * ldb + k);
    return pack2(b[k * ldb + n], b[(k + 1) * ldb + n]);
  }
}

__device__ __forceinline__ void mma_bf16(float& c0, float& c1, float& c2, float& c3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bfloat16: the same product on the tensor cores (mma.sync m16n8k16, bf16
// operands, float32 accumulation), fragments read from shared memory.
template <bool AT, bool BT, typename TB>
__device__ __forceinline__ void block_mm_mma(float (&acc)[4][16], const Tile& tl,
                                             const bf16* __restrict__ a, int lda,
                                             const TB* __restrict__ b, int ldb) {
#pragma unroll 2
  for (int k0 = 0; k0 < 128; k0 += 16) {
    const int k = k0 + 2 * tl.q;
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = tl.rb + 16 * mt + tl.g;
      af[mt][0] = a_pair<AT>(a, lda, m, k);
      af[mt][1] = a_pair<AT>(a, lda, m + 8, k);
      af[mt][2] = a_pair<AT>(a, lda, m, k + 8);
      af[mt][3] = a_pair<AT>(a, lda, m + 8, k + 8);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = tl.cb + 8 * nt + tl.g;
      const uint32_t b0 = b_pair<BT>(b, ldb, k, n), b1 = b_pair<BT>(b, ldb, k + 8, n);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma_bf16(acc[2 * mt][2 * nt], acc[2 * mt][2 * nt + 1], acc[2 * mt + 1][2 * nt],
                 acc[2 * mt + 1][2 * nt + 1], af[mt], b0, b1);
    }
  }
}

template <bool AT, bool BT, typename RB, typename TA, typename TB>
__device__ __forceinline__ void block_mm(float (&acc)[4][16], const Tile& tl, const TA* a,
                                         int lda, const TB* b, int ldb) {
  if constexpr (std::is_same<TA, bf16>::value)
    block_mm_mma<AT, BT>(acc, tl, a, lda, b, ldb);
  else
    block_mm_fma<AT, BT, RB>(acc, tl, a, lda, b, ldb);
}

// dt' and the decay vectors of the chunk at t0, for threads < kSsdT (one
// step each; every thread of the block calls it): dtp = softplus(dt +
// dt_bias), the inclusive cumsum `cum` of la = dtp * al (an inclusive scan in
// each warp, then the warps' totals in order, so cum[T-1] == total bit for
// bit), and segb, into_e = exp2(into), scale = exp2(outof) and total_s[0] =
// total as set out at the top of this file. into_e holds the in-warp
// prefixes in between. Ends with __syncthreads().
template <class Src>
__device__ __forceinline__ void chunk_decays(const Src& src, int t0, float al, float dtb_h,
                                             int reverse, float* dtp, float* segb,
                                             float* into_e, float* scale, float* total_s) {
  const int tid = threadIdx.x;
  float la = 0.f, cum = 0.f, total = 0.f;
  if (tid < kSsdT) {
    const float d = softplus(src.dt(t0 + tid) + dtb_h);
    la = d * al;
    float v = la;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if ((tid & 31) >= o) v += u;
    }
    dtp[tid] = d;
    into_e[tid] = v;
  }
  __syncthreads();
  if (tid < kSsdT) {
    const int w = tid >> 5;
    float base = 0.f;
#pragma unroll
    for (int q = 0; q < kSsdT / 32; ++q) {
      const float s = into_e[q * 32 + 31];
      if (q < w) base += s;
      total += s;
    }
    cum = base + into_e[tid];
  }
  __syncthreads();
  if (tid < kSsdT) {
    if (!reverse) {
      segb[tid] = cum;
      into_e[tid] = exp2f(cum);
      scale[tid] = exp2f(total - cum);
    } else {
      const float e = cum - la;
      segb[tid] = -e;
      into_e[tid] = exp2f(total - e);
      scale[tid] = exp2f(e);
    }
    if (tid == 0) total_s[0] = total;
  }
  __syncthreads();
}

}  // namespace pc
