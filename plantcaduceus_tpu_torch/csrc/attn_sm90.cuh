// Hopper (sm_90a) building blocks of K7 and K8: asynchronous copies into
// shared memory (cp.async), the proxy fence between them and the tensor
// cores' reads, wgmma shared-memory descriptors and the warpgroup products
// the attention kernels issue.
//
// Layout of a bfloat16 tile [64 rows][HD] in shared memory (WgTile): the
// canonical swizzled layouts wgmma reads, 64-byte swizzle at hd 32 and
// 128-byte swizzle at hd 64 (rows of 64 or 128 bytes), and at hd 128 two
// 128-byte atoms side by side (columns 0-63, then 64-127, each [64][64]).
// The 16-byte chunk index within a row is XORed with bits 7.. of the byte
// offset (Swizzle<3,4,3> and Swizzle<2,4,3> in CUTLASS's terms), so tiles
// sit on 1024-byte boundaries. One stored tile serves both ways wgmma reads
// it:
//  K-major (rows = M or N, hd = the reduction): q k^T, do v^T, k q^T,
//    v do^T; a 16-column step moves the start address 32 bytes within the
//    atom (or to the next atom at hd 128); 8-row groups are SBO = 8 rows
//    apart.
//  MN-major (rows = the reduction, hd = N, the descriptor's transpose bit):
//    p v, ds k, p^T do, ds^T q; a 16-row step moves the start address 16
//    rows; SBO = 8 rows, LBO = the distance between the two atoms at hd 128.

#pragma once

#include <stdint.h>

namespace pc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zeros when !valid (src is then
// not read but must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes (one float32), zero when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's completed generic-proxy writes to shared memory (cp.async,
// st.shared) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Order the compiler's reads and writes of wgmma's accumulators after the
// wait that completes them (and its writes before the fence that starts
// them).
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+f"(d[i][c])::"memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle mode (1: 128-byte, 2:
// 64-byte).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                            uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)mode << 62);
}

// The bfloat16 [64][HD] tile (see the head of this file).
template <int HD>
struct WgTile {
  static constexpr int kSw = HD == 32 ? 64 : 128;     // bytes of an atom row
  static constexpr int kAtomCols = kSw / 2;            // bf16 columns per atom
  static constexpr int kAtomBytes = 64 * kSw;          // one atom over the 64 rows
  static constexpr int kBytes = 64 * HD * 2;
  static constexpr uint32_t kMode = kSw == 128 ? 1 : 2;

  // Byte offset of (r, c) for c a multiple of 8 (one 16-byte chunk).
  __device__ static uint32_t off(int r, int c) {
    const uint32_t o = (c / kAtomCols) * kAtomBytes + r * kSw + (c % kAtomCols) * 2;
    return o ^ (((o >> 7) & (kSw / 16 - 1)) << 4);
  }
  // K-major operand, columns 16 ks .. 16 ks + 15.
  __device__ static uint64_t desc_k(uint32_t base, int ks) {
    const int c = 16 * ks;
    return wg_desc(base + (c / kAtomCols) * kAtomBytes + (c % kAtomCols) * 2, 16, 8 * kSw,
                   kMode);
  }
  // MN-major operand [16 x HD], rows 16 ks .. 16 ks + 15.
  __device__ static uint64_t desc_mn(uint32_t base, int ks) {
    return wg_desc(base + 16 * ks * kSw, kAtomBytes, 8 * kSw, kMode);
  }
};

// d[8][4] (+)= A . B^T, A [64 x 16] and B [64 x 16] read K-major from
// shared memory through the descriptors da and db; acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(acc));
}

// d[4][4] += A . B, A [64 x 16] bf16 in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B [16 x 32] read MN-major from shared
// memory through the descriptor db.
__device__ __forceinline__ void wgmma_rs(float (&d)[4][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[8][4] += A . B, A [64 x 16] bf16 in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B [16 x 64] read MN-major from shared
// memory through the descriptor db.
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[16][4] += A . B, A [64 x 16] bf16 in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B [16 x 128] read MN-major from shared
// memory through the descriptor db.
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

}  // namespace pc
