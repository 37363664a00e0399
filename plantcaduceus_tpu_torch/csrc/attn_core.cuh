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
// The kernels keep scores in base 2: s2 = log2(e) * s, with log2(e) folded
// into the scale and the slope (one FMA a score) and exp2 for every
// exponential; a masked score is the sentinel itself in either base. lse
// leaves the kernels in natural log.
//
// Head dims above 128 (a multiple of 128: flash_attention pads to one, as
// pallas_attention.py:184 does) run in 128-wide slices: NS = hd / 128
// blocks per tile, block z (blockIdx.z) owning the outputs' columns 128 z
// .. 128 z + 127. Each block sums the score-type products over the NS
// slices in slice order with hd 128's routines, so the NS blocks of a tile
// compute the same scores bit for bit, then accumulates its own slice of
// the outputs; the scores are recomputed once per slice. No ring: every
// tile is copied, waited for and used (the "wide" kernels).
//
// Masking by tile class: a (query tile, key tile) pair wholly inside L and
// inside the window/causal span (AttnMask::interior) takes only the ALiBi
// term, from the tile's offset; only the pairs on an edge (the ragged end,
// the window or causal boundary) take the per-score tests.
//
// Layout. q, k and v are read in their [B, L, H, hd] layout through the
// strides the wrapper passes (one set for the three: views of one fused qkv
// projection, or three contiguous tensors); o, do, dq, dk and dv are
// contiguous [B, L, H, hd]; lse and delta are float32 [B*H, L]. A block of
// 128 threads (4 warps: one warpgroup) owns one (b*h, 64-row tile); warp w
// owns tile rows 16w .. 16w+15, and each thread two of them (g and g+8,
// lane = 4g + t), in the layout of wgmma's (and mma.m16n8k16's)
// accumulators: a [64 x 64] score tile is s[nt][c], column 8nt + 2t + (c &
// 1), row 16w + g + 8 (c >> 1).
//
// Tiles reach shared memory by cp.async (16 bytes a thread, zeros past L)
// into a ring of two stages, so the next key (or query) tile loads while
// the current one computes.
//
// Products. bfloat16: wgmma (attn_sm90.cuh) with float32 accumulation.
// Score-type products (q k^T, do v^T; k q^T, v do^T) read both operands
// from shared memory, K-major; accumulating products (p v, ds k; p^T do,
// ds^T q) take the score tile from registers, packed to bf16 in place, and
// read the same stored tile MN-major. q k^T on bf16 inputs equals the TPU
// kernel's float32 product term by term (a bf16 x bf16 product is exact in
// float32); the score operand is rounded to bf16 (the TPU keeps it
// float32), a deliberate difference. float32: FMA loops over the same
// ownership, no TF32, tiles in a padded layout (AttnTile<float>); the score
// operand goes through a per-warp float32 scratch in shared memory.

#pragma once

#include <math.h>

#include <type_traits>

#include "attn_sm90.cuh"
#include "ssd_core.cuh"  // to_f, from_f, pack2, kLog2e, pc_error_string

namespace pc {

constexpr int kAttnTile = 64;     // query rows and key rows per tile
constexpr int kAttnThreads = 128;  // 4 warps of 16 rows each: one warpgroup
constexpr int kAttnStages = 2;    // the ring of key (or query) tiles
constexpr float kAttnNeg = -1e30f;  // the TPU kernel's _NEG
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kAttnPLd = kAttnTile + 4;  // float32 score scratch row stride

// A [64][HD] tile of T in shared memory: its size (a multiple of 1024
// bytes) and the byte offset of (r, c), c a multiple of 16 bytes.
template <typename T, int HD>
struct AttnTile;
template <int HD>
struct AttnTile<bf16, HD> : WgTile<HD> {};
// float32: rows padded by 16 bytes, so the FMA loops' reads (8 rows) fall on
// distinct banks and every row stays 16-byte aligned for cp.async.
template <int HD>
struct AttnTile<float, HD> {
  static constexpr int kLd = HD + 4;
  static constexpr int kBytes = kAttnTile * kLd * 4;
  __device__ static uint32_t off(int r, int c) { return (r * kLd + c) * 4; }
};

// The structured bias of one (b, h) and the problem's extent; scale and
// slope in base 2 (times log2 e) on the card.
struct AttnMask {
  float scale, slope;
  int L, causal, window, use_slopes, symmetric;  // window < 0: none

  // The base-2 score of the product `dot` at (i, j), every test applied.
  __device__ __forceinline__ float score2(float dot, int i, int j) const {
    if (i >= L || j >= L) return -INFINITY;
    const int dl = i - j;
    if ((window >= 0 && abs(dl) > window) || (causal && dl < 0)) return kAttnNeg;
    return fmaf(dot, scale, -slope * (float)(symmetric ? abs(dl) : dl));
  }

  // Every (i, j) of query tile q0 and key tile k0 inside L and the span.
  __device__ __forceinline__ bool interior(int q0, int k0) const {
    if (q0 + kAttnTile > L || k0 + kAttnTile > L) return false;
    if (window >= 0 && abs(q0 - k0) + kAttnTile - 1 > window) return false;
    return !(causal && k0 + kAttnTile - 1 > q0);
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

// The mask of (b, h) in base 2, from the host's natural-log one.
__device__ __forceinline__ AttnMask attn_mask2(const AttnMask& host, const float* slopes,
                                               int h) {
  AttnMask mk = host;
  mk.scale = host.scale * kLog2e;
  mk.slope = host.use_slopes ? slopes[h] * kLog2e : 0.f;
  return mk;
}

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

// The block's dynamic shared memory from a 1024-byte boundary (the
// swizzled tiles' alignment); the launch asks for 1024 bytes more.
__device__ __forceinline__ unsigned char* attn_smem_base(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// Start copying a [64][HD] tile from `rows` rows of hd elements (row r at
// src + r * stride) into dst, 16 bytes a copy; rows from `rows` on are
// zeros. The caller commits the group.
template <typename T, int HD>
__device__ __forceinline__ void attn_load_async(unsigned char* dst, const T* src,
                                                long long stride, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  const uint32_t d0 = smem_u32(dst);
  static_assert(kAttnTile * kPerRow % kAttnThreads == 0, "whole copies per thread");
#pragma unroll
  for (int k = 0; k < kAttnTile * kPerRow / kAttnThreads; ++k) {
    const int c = threadIdx.x + k * kAttnThreads;
    const int r = c / kPerRow, col = (c % kPerRow) * kVec;
    const bool ok = r < rows;
    cp_async16(d0 + AttnTile<T, HD>::off(r, col), src + (ok ? r : 0) * stride + col, ok);
  }
}

// Wait for the current stage (and everything before it): one group more in
// flight when the next stage was issued. Then every thread's copies are
// visible to the whole block, wgmma's async proxy included.
__device__ __forceinline__ void attn_stage_ready(bool next_in_flight) {
  if (next_in_flight) cp_async_wait<1>();
  else cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();
}

template <int N>
__device__ __forceinline__ void attn_zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
}

// Raw products s (q . k) of the warp's rows -> base-2 scores. Rows are
// queries from r0 and columns keys from c0; TR: rows are keys, columns
// queries (the transposed tiles of the dk/dv kernel).
template <bool TR, bool SYM>
__device__ __forceinline__ void attn_alibi_tile(float (&s)[8][4], const AttnLane& ln,
                                                const AttnMask& mk, int r0, int c0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // i - j = base -+ (8 nt + e)
    const float base = TR ? (float)(c0 + 2 * ln.t - r0 - ln.row(r))
                          : (float)(r0 + ln.row(r) - c0 - 2 * ln.t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = TR ? base + (float)(8 * nt + e) : base - (float)(8 * nt + e);
        float& v = s[nt][2 * r + e];
        v = fmaf(v, mk.scale, -mk.slope * (SYM ? fabsf(dl) : dl));
      }
  }
}

template <bool TR>
__device__ __forceinline__ void attn_scores(float (&s)[8][4], const AttnLane& ln,
                                            const AttnMask& mk, int r0, int c0) {
  if (mk.interior(TR ? c0 : r0, TR ? r0 : c0)) {
    if (!mk.use_slopes) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] *= mk.scale;
    } else if (mk.symmetric) {
      attn_alibi_tile<TR, true>(s, ln, mk, r0, c0);
    } else {
      attn_alibi_tile<TR, false>(s, ln, mk, r0, c0);
    }
    return;
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int rr = r0 + ln.row(c >> 1), cc = c0 + ln.col(nt, c & 1);
      s[nt][c] = TR ? mk.score2(s[nt][c], cc, rr) : mk.score2(s[nt][c], rr, cc);
    }
}

// ---- bfloat16: wgmma -------------------------------------------------------

// s = A . B^T over hd, A and B [64][HD] tiles at shared addresses a and b
// (issued; the caller fences, commits and waits); s += A . B^T with
// `accumulate` (the head-dim slices after the first, above hd 128).
template <int HD>
__device__ __forceinline__ void wg_scores(float (&s)[8][4], uint32_t a, uint32_t b,
                                          bool accumulate = false) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    wgmma_ss(s, WgTile<HD>::desc_k(a, ks), WgTile<HD>::desc_k(b, ks), accumulate || ks > 0);
}

// The score tile as wgmma A fragments (bf16), one per 16 columns.
__device__ __forceinline__ void wg_pack(uint32_t (&a)[4][4], const float (&p)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack2(__float2bfloat16(p[2 * kk][0]), __float2bfloat16(p[2 * kk][1]));
    a[kk][1] = pack2(__float2bfloat16(p[2 * kk][2]), __float2bfloat16(p[2 * kk][3]));
    a[kk][2] = pack2(__float2bfloat16(p[2 * kk + 1][0]), __float2bfloat16(p[2 * kk + 1][1]));
    a[kk][3] = pack2(__float2bfloat16(p[2 * kk + 1][2]), __float2bfloat16(p[2 * kk + 1][3]));
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+r"(a[kk][c])::"memory");
  }
}

// acc += P . B, P the packed score tile, B the [64][HD] tile at b (issued).
template <int HD>
__device__ __forceinline__ void wg_accum(float (&acc)[HD / 8][4], const uint32_t (&p)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_rs(acc, p[ks], WgTile<HD>::desc_mn(b, ks));
}

// ---- float32: FMA loops ----------------------------------------------------

// acc[nt][c] += sum_d A[row][d] * B[col][d] over the warp's 16 rows of A and
// the 64 rows of B; 16-byte reads (4 d at a time).
template <int HD>
__device__ __forceinline__ void mm_rows(float (&acc)[8][4], const AttnLane& ln,
                                        const float* __restrict__ A,
                                        const float* __restrict__ B) {
  constexpr int LD = AttnTile<float, HD>::kLd;
  const float* a0 = A + ln.row(0) * LD;
  const float* a1 = A + ln.row(1) * LD;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + d);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + d);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 y = *reinterpret_cast<const float4*>(B + ln.col(nt, e) * LD + d);
        float& u = acc[nt][e];
        float& w = acc[nt][2 + e];
        u = fmaf(x0.x, y.x, u);
        w = fmaf(x1.x, y.x, w);
        u = fmaf(x0.y, y.y, u);
        w = fmaf(x1.y, y.y, w);
        u = fmaf(x0.z, y.z, u);
        w = fmaf(x1.z, y.z, w);
        u = fmaf(x0.w, y.w, u);
        w = fmaf(x1.w, y.w, w);
      }
  }
}

// acc[nd][c] += sum_j P[row][j] * B[j][col] with P the warp's score tile
// (registers, s layout) and B a [64][LD] tile. `scratch` is the warp's
// [16][kAttnPLd] floats (16-byte aligned rows).
template <int HD>
__device__ __forceinline__ void mm_scores(float (&acc)[HD / 8][4], const AttnLane& ln,
                                          const float (&p)[8][4],
                                          const float* __restrict__ B, float* scratch) {
  constexpr int LD = AttnTile<float, HD>::kLd;
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
#pragma unroll 2
  for (int j = 0; j < kAttnTile; j += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(p0 + j);
    const float4 x1 = *reinterpret_cast<const float4*>(p1 + j);
    const float u0[4] = {x0.x, x0.y, x0.z, x0.w}, u1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
        const float2 y = *reinterpret_cast<const float2*>(B + (j + jj) * LD + ln.col(nd, 0));
        acc[nd][0] = fmaf(u0[jj], y.x, acc[nd][0]);
        acc[nd][1] = fmaf(u0[jj], y.y, acc[nd][1]);
        acc[nd][2] = fmaf(u1[jj], y.x, acc[nd][2]);
        acc[nd][3] = fmaf(u1[jj], y.y, acc[nd][3]);
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

// Two adjacent outputs in one store.
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack2(__float2bfloat16(x), __float2bfloat16(y));
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
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
      store2(dst + ln.col(nd, 0), acc[nd][2 * r] * mul[r], acc[nd][2 * r + 1] * mul[r]);
  }
}

// Dynamic shared memory of a kernel with `tiles` [64][HD] tiles and `extra`
// floats after them, plus the alignment slack; float32 adds the 4 warps'
// score scratch.
template <typename T, int HD>
inline size_t attn_smem_bytes(int tiles, int extra) {
  size_t n = 1024 + (size_t)tiles * AttnTile<T, HD>::kBytes + extra * sizeof(float);
  if (sizeof(T) == 4) n += 4 * 16 * kAttnPLd * sizeof(float);
  return n;
}

}  // namespace pc
