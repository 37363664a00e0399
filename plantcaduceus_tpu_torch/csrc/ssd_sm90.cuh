// Hopper (sm_90a) building blocks of the SSD kernels K5 (mixer2_fwd.cu) and
// K6 (ssd_bwd.cu): 16-byte loads of float32 or bfloat16 rows, the raw dt of
// one head for ssd_core.cuh's chunk_decays, and bfloat16 [128][128] tiles in
// the layout wgmma reads with the warpgroup product over them.
//
// A tile is two column atoms of [128 rows][64 cols] (16 KB each, 1024-byte
// aligned) in attn_sm90.cuh's 128-byte swizzle, so each 128 x 128 x 128
// product is eight m64n128k16 wgmma per warpgroup with both operands read
// from shared memory, K-major or MN-major by the descriptor's transpose bit:
// warpgroup w computes output rows 64w..64w+63. A thread's accumulator holds
// rows 64w + 16wi + g + 8i, i < 2 (wi its warp in the warpgroup, lane = 4g +
// q), and columns 8j + 2q + e, j < 16, e < 2 (acc[j][2i + e]): a row's 128
// columns lie in the four lanes of one quad, so row sums need two shuffles.

#pragma once

#include <stdint.h>

#include <type_traits>

#include "attn_sm90.cuh"
#include "ssd_core.cuh"

namespace pc {

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

// The raw dt of one (row, head), for chunk_decays.
template <typename T>
struct DtSrc {
  const T* dtr;  // the row's [L, H], at column h
  int H;
  __device__ float dt(int t) const { return to_f(dtr[(long long)t * H]); }
};

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

}  // namespace pc
