// Flash attention with a structured bias, shared device code of K7
// (attn_fwd.cu) and K8 (attn_bwd.cu).
//
// Math (one batch row b, head h; queries i, keys j < L), the same as
// plantcaduceus_tpu/ops/pallas_attention.py:
//   s[i, j] = scale * q_i . k_j + bias(i, j)
//   bias    = -slope_h * |i - j|   (ALiBi; (i - j) when not symmetric)
//             -1e30 where |i - j| > window or (causal and j > i)
// the masked sentinel -1e30 being _NEG (:40), as _block_bias builds it
// (:43-60): added, not -inf, so a row whose first key tiles are all masked
// (a local window) runs exp(0) on them and the first unmasked tile's
// rescale exp(-1e30 - m) = 0 wipes them out, as on the TPU. Keys at or past
// L (the ragged last tile; the TPU tiles L exactly) score -inf and add 0.
//
// Layout. q, k and v are read in their [B, L, H, hd] layout through the
// strides the wrapper passes (one set for the three: views of one fused qkv
// projection, or three contiguous tensors); o, do, dq, dk and dv are
// contiguous [B, L, H, hd]; lse and delta are float32 [B*H, L]. A block of
// 128 threads (4 warps) owns one (b*h, 64-row tile); warp w owns tile rows
// 16w .. 16w+15, and each thread two of them (g and g+8, lane = 4g + t), in
// the layout of mma.m16n8k16's accumulators: a [16 x 64] score tile is
// s[nt][c], column 8nt + 2t + (c & 1), row g + 8 (c >> 1).
//
// Two block products serve both kernels:
//  mm_rows   acc[8][4]    += A[16 rows of the warp][hd] . B[64 rows][hd]^T
//            (q k^T, do v^T; in the backward also k q^T and v do^T),
//  mm_scores acc[hd/8][4] += P[16 x 64] . B[64 rows][hd]
//            with P the warp's own score tile in registers (p v, ds k;
//            p^T do, ds^T q).
// bfloat16: mma.sync m16n8k16 with float32 accumulation. q k^T on bf16
// inputs equals the TPU kernel's float32 product term by term (a bf16 x
// bf16 product is exact in float32); the score operand P of mm_scores is
// rounded to bf16 (the TPU keeps it float32), a deliberate difference.
// float32: FMA loops over the same ownership, no TF32; the score operand
// goes through a per-warp float32 scratch in shared memory.

#pragma once

#include <math.h>

#include "ssd_core.cuh"  // to_f, from_f, pack2, mma_bf16, pc_error_string

namespace pc {

constexpr int kAttnTile = 64;     // query rows and key rows per tile
constexpr int kAttnThreads = 128;  // 4 warps of 16 rows each
constexpr float kAttnNeg = -1e30f;  // the TPU kernel's _NEG

// Row stride (elements) of the [64][LD] tiles in shared memory: 16 bytes
// of padding, so the fragment loads (8 rows x 4 words) and the FMA loops'
// reads (8 rows) fall on distinct banks, and every row stays 16-byte
// aligned for the vector loads that fill it.
template <typename T, int HD>
struct AttnLd {
  static constexpr int v = HD + 16 / (int)sizeof(T);
};
constexpr int kAttnPLd = kAttnTile + 4;  // float32 score scratch row stride

// The structured bias of one (b, h) and the problem's extent.
struct AttnMask {
  float scale, slope;
  int L, causal, window, use_slopes, symmetric;  // window < 0: none

  __device__ __forceinline__ float score(float dot, int i, int j) const {
    if (i >= L || j >= L) return -INFINITY;
    const int dl = i - j;
    float b = 0.f;
    if (use_slopes) b = -slope * (float)(symmetric ? abs(dl) : dl);
    if (window >= 0 && abs(dl) > window) b = kAttnNeg;
    if (causal && dl < 0) b = kAttnNeg;
    return dot * scale + b;
  }

  // The keys [lo, hi] that rows [r0, r1] can see (causal: j <= i), or the
  // queries that keys [r0, r1] are seen by (transpose: i >= j).
  __device__ __forceinline__ void span(int r0, int r1, bool transpose, int& lo,
                                       int& hi) const {
    lo = 0;
    hi = L - 1;
    if (window >= 0) {
      lo = max(0, r0 - window);
      hi = min(hi, r1 + window);
    }
    if (causal) {
      if (transpose) lo = max(lo, r0);
      else hi = min(hi, r1);
    }
  }
};

// This thread's place in the warp's [16 x ...] tiles.
struct AttnLane {
  int w, g, t;
  __device__ AttnLane() {
    const int lane = threadIdx.x & 31;
    w = threadIdx.x >> 5;
    g = lane >> 2;
    t = lane & 3;
  }
  __device__ int row(int r) const { return 16 * w + g + 8 * r; }  // r = 0, 1
  __device__ int col(int nt, int e) const { return 8 * nt + 2 * t + e; }
};

// Fill a [64][LD] tile from `rows` rows of hd elements (row r at src + r *
// stride), 16 bytes a thread; rows from `rows` on are zeros.
template <typename T, int HD>
__device__ __forceinline__ void attn_load(T* dst, const T* src, long long stride, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  constexpr int LD = AttnLd<T, HD>::v;
  for (int c = threadIdx.x; c < kAttnTile * kPerRow; c += kAttnThreads) {
    const int r = c / kPerRow, col = (c % kPerRow) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) v = *reinterpret_cast<const uint4*>(src + r * stride + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = v;
  }
}

template <int N>
__device__ __forceinline__ void attn_zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[nt][c] += sum_d A[row][d] * B[col][d] over the warp's 16 rows of A and
// the 64 rows of B.
template <int HD>
__device__ __forceinline__ void mm_rows(float (&acc)[8][4], const AttnLane& ln,
                                        const bf16* __restrict__ A,
                                        const bf16* __restrict__ B) {
  constexpr int LD = AttnLd<bf16, HD>::v;
  const bf16* a0 = A + ln.row(0) * LD + 2 * ln.t;
  const bf16* a1 = A + ln.row(1) * LD + 2 * ln.t;
#pragma unroll
  for (int k0 = 0; k0 < HD; k0 += 16) {
    const uint32_t af[4] = {ld_pair(a0 + k0), ld_pair(a1 + k0), ld_pair(a0 + k0 + 8),
                            ld_pair(a1 + k0 + 8)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* b = B + (8 * nt + ln.g) * LD + k0 + 2 * ln.t;
      mma_bf16(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3], af, ld_pair(b), ld_pair(b + 8));
    }
  }
}

template <int HD>
__device__ __forceinline__ void mm_rows(float (&acc)[8][4], const AttnLane& ln,
                                        const float* __restrict__ A,
                                        const float* __restrict__ B) {
  constexpr int LD = AttnLd<float, HD>::v;
  const float* a0 = A + ln.row(0) * LD;
  const float* a1 = A + ln.row(1) * LD;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float x0 = a0[d], x1 = a1[d];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float y = B[ln.col(nt, e) * LD + d];
        acc[nt][e] = fmaf(x0, y, acc[nt][e]);
        acc[nt][2 + e] = fmaf(x1, y, acc[nt][2 + e]);
      }
  }
}

// acc[nd][c] += sum_j P[row][j] * B[j][col] with P the warp's score tile
// (registers, s layout) and B a [64][LD] tile. `scratch` (float32 only) is
// the warp's [16][kAttnPLd] floats.
template <int HD>
__device__ __forceinline__ void mm_scores(float (&acc)[HD / 8][4], const AttnLane& ln,
                                          const float (&p)[8][4],
                                          const bf16* __restrict__ B, float*) {
  constexpr int LD = AttnLd<bf16, HD>::v;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t af[4] = {
        pack2(__float2bfloat16(p[2 * kk][0]), __float2bfloat16(p[2 * kk][1])),
        pack2(__float2bfloat16(p[2 * kk][2]), __float2bfloat16(p[2 * kk][3])),
        pack2(__float2bfloat16(p[2 * kk + 1][0]), __float2bfloat16(p[2 * kk + 1][1])),
        pack2(__float2bfloat16(p[2 * kk + 1][2]), __float2bfloat16(p[2 * kk + 1][3]))};
    const bf16* b = B + (16 * kk + 2 * ln.t) * LD + ln.g;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      const bf16* bn = b + 8 * nd;
      mma_bf16(acc[nd][0], acc[nd][1], acc[nd][2], acc[nd][3], af,
               pack2(bn[0], bn[LD]), pack2(bn[8 * LD], bn[9 * LD]));
    }
  }
}

template <int HD>
__device__ __forceinline__ void mm_scores(float (&acc)[HD / 8][4], const AttnLane& ln,
                                          const float (&p)[8][4],
                                          const float* __restrict__ B, float* scratch) {
  constexpr int LD = AttnLd<float, HD>::v;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      scratch[ln.g * kAttnPLd + ln.col(nt, e)] = p[nt][e];
      scratch[(ln.g + 8) * kAttnPLd + ln.col(nt, e)] = p[nt][2 + e];
    }
  __syncwarp();
  const float* p0 = scratch + ln.g * kAttnPLd;
  const float* p1 = p0 + 8 * kAttnPLd;
#pragma unroll 4
  for (int j = 0; j < kAttnTile; ++j) {
    const float x0 = p0[j], x1 = p1[j];
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float y = B[j * LD + ln.col(nd, e)];
        acc[nd][e] = fmaf(x0, y, acc[nd][e]);
        acc[nd][2 + e] = fmaf(x1, y, acc[nd][2 + e]);
      }
  }
  __syncwarp();  // every read of the scratch is done before the next write
}

// Sum or max over the four threads of a quad (the lanes that share a row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Write a thread's share of a warp's [16 x hd] result, times `mul`, to rows
// r0 + row(0), r0 + row(1) (those < L) of a contiguous [B, L, H, hd] tensor
// at `base` (the (b, h) slice's row 0; row stride H*hd).
template <typename T, int HD>
__device__ __forceinline__ void attn_store(T* base, long long stride,
                                           const float (&acc)[HD / 8][4], const AttnLane& ln,
                                           int r0, int L, const float (&mul)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + ln.row(r);
    if (i >= L) continue;
    T* dst = base + i * stride;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) dst[ln.col(nd, e)] = from_f<T>(acc[nd][2 * r + e] * mul[r]);
  }
}

// Dynamic shared memory of a kernel with `tiles` [64][LD] tiles and
// `extra` floats; float32 adds the 4 warps' score scratch.
template <typename T, int HD>
inline size_t attn_smem_bytes(int tiles, int extra) {
  size_t n = (size_t)tiles * kAttnTile * AttnLd<T, HD>::v * sizeof(T) + extra * sizeof(float);
  if (sizeof(T) == 4) n += 4 * 16 * kAttnPLd * sizeof(float);
  return n;
}

}  // namespace pc
