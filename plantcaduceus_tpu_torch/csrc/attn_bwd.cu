// K8 — flash attention backward with a structured bias: dq, dk, dv from q,
// k, v, o, do and the forward's lse (K7), any sequence length, head dim 32,
// 64, 128 or a multiple of 128.
//
// Replaces plantcaduceus_tpu/ops/pallas_attention.py::_dq_kernel (:103)
// and ::_dkv_kernel (:135), launched at :247 and :263 by _bwd (the custom
// VJP's backward, :310), with the wrapper's delta = rowsum(do * o) (:231).
// Two kernels on one stream, no atomics, so two launches give equal bits:
//  (a) attn_dq_kernel, per (b*h, 64-query tile): first delta = rowsum(do
//      * o) of its rows in float32 (16-byte loads, two threads a row),
//      kept in registers and written to `delta` for (b); then over the key
//      tiles its rows see: s and p = exp2(s2 - lse2) recomputed, dp = do
//      v^T, ds = p (dp - delta), dq += ds k; dq = scale * dq at the end;
//  (b) attn_dkv_kernel, per (b*h, 64-key tile), over the query tiles that
//      see its keys: the transposed scores s^T = k q^T and p^T, dv += p^T
//      do, dp^T = v do^T, ds^T = p^T (dp^T - delta), dk += ds^T q; dk =
//      scale * dk.
// The bias and the score transform are attn_core.cuh's, as in K7. dq, dk
// and dv come out in the inputs' dtype, contiguous [B, L, H, hd].
//
// What bounds it on an H100: five products of 2 L^2 hd flops per (b, h)
// (s, dp, dv, dk, dq: 64 GFLOP at the training shape 32 x 512, H 12, hd 64:
// 0.065 ms on the bf16 tensor cores, 0.98 ms as float32 FMA); the bytes
// (q, k, v, o, do in, dq, dk, dv out: ~0.2 GB, 0.06 ms) come close. Each
// kernel recomputes s and dp (seven products, not five) so that each owns
// its outputs without atomics. The design against the bound, in bf16: the
// block's own tiles (q and do; k and v) are copied once and stay in shared
// memory; the tiles it walks arrive by cp.async into a ring of two stages;
// the four score-type products are wgmma chains with both operands in
// shared memory, the three accumulating ones take p, ds, p^T or ds^T from
// the accumulator registers (packed to bf16) and read the walked or own
// tile MN-major; interior tiles take only the ALiBi term; the delta pass is
// the dq kernel's prologue, overlapping its first copies. One warpgroup a
// block, as K7 (attn_fwd.cu says what else was measured). float32 keeps
// the FMA loops (no TF32) on the same ring.
//
// Head dims above 128 (JAX pads them to a multiple of 128,
// pallas_attention.py:172-186): attn_dq_wide_kernel and
// attn_dkv_wide_kernel, in 128-wide slices (attn_core.cuh). Block z sums
// s and dp (or s^T and dp^T) over the slices in slice order, then
// accumulates its own slice of dq (from k_z), or of dk and dv (from q_z
// and do_z), which it reloads unless z is the last slice; delta sums over
// the whole head in the dq kernel, whose block 0 writes it. Four tiles of
// shared memory at any hd, each copied, waited for and used.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (delta is the wrapper's scratch) and returns cudaGetLastError().

#include "attn_core.cuh"

namespace pc {

struct AttnBwdArgs {
  const void *q, *k, *v;
  long long sb, sl, sh;  // strides of q, k and v (elements)
  const float* slopes;   // [H]
  const void *o, *dout;  // contiguous [B, L, H, hd]
  const float* lse;      // [B*H, L]
  float* delta;          // [B*H, L], written by (a), read by (b)
  void *dq, *dk, *dv;    // contiguous [B, L, H, hd]
  int B, H;
  AttnMask mask;
};

// delta = rowsum(do * o) over the 64 rows from o / g (row stride `stride`;
// `rows` of them valid) and `slices` HD-wide slices of the head, two
// threads a row, 16-byte loads; into sD[64] (zeros past `rows`) and, where
// gD is given, gD[0 .. rows).
template <typename T, int HD>
__device__ __forceinline__ void attn_delta(const T* o, const T* g, long long stride, int rows,
                                           float* sD, float* gD, int slices = 1) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPer = HD / 2 / kVec;  // 16-byte loads per thread, tensor and slice
  const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (HD / 2);
  float s = 0.f;
  if (r < rows) {
    for (int sl = 0; sl < slices; ++sl) {
      const int c = c0 + sl * HD;
      uint4 vo[kPer], vg[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        vo[k] = *reinterpret_cast<const uint4*>(o + r * stride + c + k * kVec);
        vg[k] = *reinterpret_cast<const uint4*>(g + r * stride + c + k * kVec);
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const T* x = reinterpret_cast<const T*>(&vo[k]);
        const T* y = reinterpret_cast<const T*>(&vg[k]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) s = fmaf(to_f(y[e]), to_f(x[e]), s);
      }
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if ((threadIdx.x & 1) == 0) {
    sD[r] = s;
    if (gD && r < rows) gD[r] = s;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kAttnThreads) attn_dq_kernel(AttnBwdArgs a) {
  constexpr bool kWg = std::is_same<T, bf16>::value;
  constexpr int kTB = AttnTile<T, HD>::kBytes;
  extern __shared__ unsigned char attn_smem[];
  unsigned char* sQ = attn_smem_base(attn_smem);
  unsigned char* sG = sQ + kTB;  // do
  unsigned char* sK = sG + kTB;  // stage st: k at sK + st * 2 * kTB, v after it
  float* sDlt = reinterpret_cast<float*>(sQ + (2 + 2 * kAttnStages) * kTB);
  const AttnLane ln;
  float* scratch = sDlt + kAttnTile + ln.w * 16 * kAttnPLd;

  const int L = a.mask.L;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kAttnTile;
  const AttnMask mk = attn_mask2(a.mask, a.slopes, h);
  const long long off = b * a.sb + h * a.sh;
  const long long so = (long long)a.H * HD, ooff = (long long)b * L * so + h * HD;
  const T* kb = static_cast<const T*>(a.k) + off;
  const T* vb = static_cast<const T*>(a.v) + off;

  int lo, hi;
  mk.span(q0, min(q0 + kAttnTile, L) - 1, false, lo, hi);
  const int kt0 = lo / kAttnTile, n = hi / kAttnTile - kt0 + 1;
  auto load_kv = [&](int kt, int st) {
    const int k0 = kt * kAttnTile;
    attn_load_async<T, HD>(sK + st * 2 * kTB, kb + k0 * a.sl, a.sl, L - k0);
    attn_load_async<T, HD>(sK + st * 2 * kTB + kTB, vb + k0 * a.sl, a.sl, L - k0);
    cp_async_commit();
  };
  const T* gb = static_cast<const T*>(a.dout) + ooff + q0 * so;
  attn_load_async<T, HD>(sQ, static_cast<const T*>(a.q) + off + q0 * a.sl, a.sl, L - q0);
  attn_load_async<T, HD>(sG, gb, so, L - q0);
  load_kv(kt0, 0);
  // the delta pass runs while the first tiles are in flight
  attn_delta<T, HD>(static_cast<const T*>(a.o) + ooff + q0 * so, gb, so, L - q0, sDlt,
                    a.delta + (long long)bh * L + q0);
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + ln.row(r);
    lse2[r] = i < L ? a.lse[(long long)bh * L + i] * kLog2e : 0.f;
  }
  __syncthreads();
  const float dlt[2] = {sDlt[ln.row(0)], sDlt[ln.row(1)]};

  float dq[HD / 8][4];
  attn_zero(dq);
  for (int it = 0; it < n; ++it) {
    const int st = it & 1, k0 = (kt0 + it) * kAttnTile;
    if (it + 1 < n) load_kv(kt0 + it + 1, st ^ 1);
    attn_stage_ready(it + 1 < n);
    unsigned char* tK = sK + st * 2 * kTB;
    unsigned char* tV = tK + kTB;
    float s[8][4], dp[8][4];
    attn_zero(s);
    attn_zero(dp);
    if constexpr (kWg) {
      wg_fence();
      wg_scores<HD>(s, smem_u32(sQ), smem_u32(tK));
      wg_scores<HD>(dp, smem_u32(sG), smem_u32(tV));
      wg_commit();
      wg_wait<0>();
      reg_fence(s);
      reg_fence(dp);
    } else {
      mm_rows<HD>(s, ln, reinterpret_cast<const float*>(sQ),
                  reinterpret_cast<const float*>(tK));
      mm_rows<HD>(dp, ln, reinterpret_cast<const float*>(sG),
                  reinterpret_cast<const float*>(tV));
    }
    attn_scores<false>(s, ln, mk, q0, k0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        s[nt][c] = exp2f(s[nt][c] - lse2[r]) * (dp[nt][c] - dlt[r]);  // ds
      }
    if constexpr (kWg) {
      uint32_t ds[4][4];
      wg_pack(ds, s);
      reg_fence(dq);
      wg_fence();
      wg_accum<HD>(dq, ds, smem_u32(tK));
      wg_commit();
      wg_wait<0>();
      reg_fence(dq);
    } else {
      mm_scores<HD>(dq, ln, s, reinterpret_cast<const float*>(tK), scratch);
    }
    __syncthreads();  // every read of this stage is done before it is refilled
  }
  const float mul[2] = {a.mask.scale, a.mask.scale};
  attn_store<T, HD>(static_cast<T*>(a.dq) + ooff, so, dq, ln, q0, L, mul);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kAttnThreads) attn_dkv_kernel(AttnBwdArgs a) {
  constexpr bool kWg = std::is_same<T, bf16>::value;
  constexpr int kTB = AttnTile<T, HD>::kBytes;
  extern __shared__ unsigned char attn_smem[];
  unsigned char* sK = attn_smem_base(attn_smem);
  unsigned char* sV = sK + kTB;
  unsigned char* sQ = sV + kTB;  // stage st: q at sQ + st * 2 * kTB, do after it
  float* sLse = reinterpret_cast<float*>(sK + (2 + 2 * kAttnStages) * kTB);  // [stage][64]
  float* sDlt = sLse + kAttnStages * kAttnTile;                               // [stage][64]
  const AttnLane ln;
  float* scratch = sDlt + kAttnStages * kAttnTile + ln.w * 16 * kAttnPLd;

  const int L = a.mask.L;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kAttnTile;
  const AttnMask mk = attn_mask2(a.mask, a.slopes, h);
  const long long off = b * a.sb + h * a.sh;
  const long long so = (long long)a.H * HD, ooff = (long long)b * L * so + h * HD;
  const T* qb = static_cast<const T*>(a.q) + off;
  const T* gb = static_cast<const T*>(a.dout) + ooff;
  const float* lseb = a.lse + (long long)bh * L;
  const float* dltb = a.delta + (long long)bh * L;

  int lo, hi;
  mk.span(k0, min(k0 + kAttnTile, L) - 1, true, lo, hi);
  const int qt0 = lo / kAttnTile, n = hi / kAttnTile - qt0 + 1;
  auto load_q = [&](int qt, int st) {
    const int q0 = qt * kAttnTile;
    attn_load_async<T, HD>(sQ + st * 2 * kTB, qb + q0 * a.sl, a.sl, L - q0);
    attn_load_async<T, HD>(sQ + st * 2 * kTB + kTB, gb + q0 * so, so, L - q0);
    // lse (threads 0-63) and delta (64-127) of the tile's queries
    const int c = threadIdx.x & (kAttnTile - 1), i = q0 + c;
    const float* src = (threadIdx.x < kAttnTile ? lseb : dltb) + (i < L ? i : 0);
    float* dst = (threadIdx.x < kAttnTile ? sLse : sDlt) + st * kAttnTile + c;
    cp_async4(smem_u32(dst), src, i < L);
    cp_async_commit();
  };
  attn_load_async<T, HD>(sK, static_cast<const T*>(a.k) + off + k0 * a.sl, a.sl, L - k0);
  attn_load_async<T, HD>(sV, static_cast<const T*>(a.v) + off + k0 * a.sl, a.sl, L - k0);
  load_q(qt0, 0);

  float dk[HD / 8][4], dv[HD / 8][4];
  attn_zero(dk);
  attn_zero(dv);
  for (int it = 0; it < n; ++it) {
    const int st = it & 1, q0 = (qt0 + it) * kAttnTile;
    if (it + 1 < n) load_q(qt0 + it + 1, st ^ 1);
    attn_stage_ready(it + 1 < n);
    unsigned char* tQ = sQ + st * 2 * kTB;
    unsigned char* tG = tQ + kTB;
    const float* tLse = sLse + st * kAttnTile;
    const float* tDlt = sDlt + st * kAttnTile;
    // rows: this warp's keys; columns: the tile's queries
    float pt[8][4], dpt[8][4];
    attn_zero(pt);
    attn_zero(dpt);
    if constexpr (kWg) {
      wg_fence();
      wg_scores<HD>(pt, smem_u32(sK), smem_u32(tQ));
      wg_scores<HD>(dpt, smem_u32(sV), smem_u32(tG));
      wg_commit();
      wg_wait<0>();
      reg_fence(pt);
      reg_fence(dpt);
    } else {
      mm_rows<HD>(pt, ln, reinterpret_cast<const float*>(sK),
                  reinterpret_cast<const float*>(tQ));
    }
    attn_scores<true>(pt, ln, mk, k0, q0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        pt[nt][c] = exp2f(pt[nt][c] - tLse[ln.col(nt, c & 1)] * kLog2e);
    if constexpr (kWg) {
      // ds^T first, then both packed: pt dies before the fragments are live
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dpt[nt][c] = pt[nt][c] * (dpt[nt][c] - tDlt[ln.col(nt, c & 1)]);
      uint32_t p[4][4], ds[4][4];
      wg_pack(p, pt);
      wg_pack(ds, dpt);
      reg_fence(dv);
      reg_fence(dk);
      wg_fence();
      wg_accum<HD>(dv, p, smem_u32(tG));
      wg_accum<HD>(dk, ds, smem_u32(tQ));
      wg_commit();
      wg_wait<0>();
      reg_fence(dv);
      reg_fence(dk);
    } else {
      mm_scores<HD>(dv, ln, pt, reinterpret_cast<const float*>(tG), scratch);
      mm_rows<HD>(dpt, ln, reinterpret_cast<const float*>(sV),
                  reinterpret_cast<const float*>(tG));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) pt[nt][c] *= dpt[nt][c] - tDlt[ln.col(nt, c & 1)];  // ds^T
      mm_scores<HD>(dk, ln, pt, reinterpret_cast<const float*>(tQ), scratch);
    }
    __syncthreads();  // every read of this stage is done before it is refilled
  }
  const float one[2] = {1.f, 1.f}, mul[2] = {a.mask.scale, a.mask.scale};
  attn_store<T, HD>(static_cast<T*>(a.dk) + ooff, so, dk, ln, k0, L, mul);
  attn_store<T, HD>(static_cast<T*>(a.dv) + ooff, so, dv, ln, k0, L, one);
}

// Head dims above 128, dq: block (query tile, b*h, z) of NS = hd / 128.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads) attn_dq_wide_kernel(AttnBwdArgs a, int NS) {
  constexpr int HD = 128;
  constexpr bool kWg = std::is_same<T, bf16>::value;
  constexpr int kTB = AttnTile<T, HD>::kBytes;
  extern __shared__ unsigned char attn_smem[];
  unsigned char* sQ = attn_smem_base(attn_smem);
  unsigned char* sG = sQ + kTB;  // do
  unsigned char* sK = sG + kTB;
  unsigned char* sV = sK + kTB;
  float* sDlt = reinterpret_cast<float*>(sQ + 4 * kTB);
  const AttnLane ln;
  float* scratch = sDlt + kAttnTile + ln.w * 16 * kAttnPLd;

  const int L = a.mask.L;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, z = blockIdx.z;
  const int q0 = blockIdx.x * kAttnTile;
  const AttnMask mk = attn_mask2(a.mask, a.slopes, h);
  const long long off = b * a.sb + h * a.sh;
  const long long so = (long long)a.H * HD * NS;
  const long long ooff = (long long)b * L * so + (long long)h * HD * NS;
  const T* qb = static_cast<const T*>(a.q) + off + (long long)q0 * a.sl;
  const T* gb = static_cast<const T*>(a.dout) + ooff + (long long)q0 * so;
  const T* kb = static_cast<const T*>(a.k) + off;
  const T* vb = static_cast<const T*>(a.v) + off;

  int lo, hi;
  mk.span(q0, min(q0 + kAttnTile, L) - 1, false, lo, hi);
  const int kt0 = lo / kAttnTile, n = hi / kAttnTile - kt0 + 1;
  attn_delta<T, HD>(static_cast<const T*>(a.o) + ooff + (long long)q0 * so, gb, so, L - q0, sDlt,
                    z == 0 ? a.delta + (long long)bh * L + q0 : nullptr, NS);
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + ln.row(r);
    lse2[r] = i < L ? a.lse[(long long)bh * L + i] * kLog2e : 0.f;
  }
  __syncthreads();
  const float dlt[2] = {sDlt[ln.row(0)], sDlt[ln.row(1)]};

  float dq[HD / 8][4];
  attn_zero(dq);
  for (int it = 0; it < n; ++it) {
    const int k0 = (kt0 + it) * kAttnTile;
    float s[8][4], dp[8][4];
    attn_zero(s);
    attn_zero(dp);
    for (int sl = 0; sl < NS; ++sl) {
      attn_load_async<T, HD>(sQ, qb + sl * HD, a.sl, L - q0);
      attn_load_async<T, HD>(sG, gb + sl * HD, so, L - q0);
      attn_load_async<T, HD>(sK, kb + k0 * a.sl + sl * HD, a.sl, L - k0);
      attn_load_async<T, HD>(sV, vb + k0 * a.sl + sl * HD, a.sl, L - k0);
      cp_async_commit();
      attn_stage_ready(false);
      if constexpr (kWg) {
        wg_fence();
        wg_scores<HD>(s, smem_u32(sQ), smem_u32(sK), sl > 0);
        wg_scores<HD>(dp, smem_u32(sG), smem_u32(sV), sl > 0);
        wg_commit();
        wg_wait<0>();
        reg_fence(s);
        reg_fence(dp);
      } else {
        mm_rows<HD>(s, ln, reinterpret_cast<const float*>(sQ),
                    reinterpret_cast<const float*>(sK));
        mm_rows<HD>(dp, ln, reinterpret_cast<const float*>(sG),
                    reinterpret_cast<const float*>(sV));
      }
      __syncthreads();  // the tiles are refilled next
    }
    if (z != NS - 1) {  // k's slice z for dq's
      attn_load_async<T, HD>(sK, kb + k0 * a.sl + z * HD, a.sl, L - k0);
      cp_async_commit();
      attn_stage_ready(false);
    }
    attn_scores<false>(s, ln, mk, q0, k0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        s[nt][c] = exp2f(s[nt][c] - lse2[r]) * (dp[nt][c] - dlt[r]);  // ds
      }
    if constexpr (kWg) {
      uint32_t ds[4][4];
      wg_pack(ds, s);
      reg_fence(dq);
      wg_fence();
      wg_accum<HD>(dq, ds, smem_u32(sK));
      wg_commit();
      wg_wait<0>();
      reg_fence(dq);
    } else {
      mm_scores<HD>(dq, ln, s, reinterpret_cast<const float*>(sK), scratch);
    }
    __syncthreads();  // every read of k is done before the next key tile's copies
  }
  const float mul[2] = {a.mask.scale, a.mask.scale};
  attn_store<T, HD>(static_cast<T*>(a.dq) + ooff + z * HD, so, dq, ln, q0, L, mul);
}

// Head dims above 128, dk and dv: block (key tile, b*h, z) of NS.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads) attn_dkv_wide_kernel(AttnBwdArgs a, int NS) {
  constexpr int HD = 128;
  constexpr bool kWg = std::is_same<T, bf16>::value;
  constexpr int kTB = AttnTile<T, HD>::kBytes;
  extern __shared__ unsigned char attn_smem[];
  unsigned char* sK = attn_smem_base(attn_smem);
  unsigned char* sV = sK + kTB;
  unsigned char* sQ = sV + kTB;
  unsigned char* sG = sQ + kTB;  // do
  float* sLse = reinterpret_cast<float*>(sK + 4 * kTB);  // [64]
  float* sDlt = sLse + kAttnTile;                        // [64]
  const AttnLane ln;
  float* scratch = sDlt + kAttnTile + ln.w * 16 * kAttnPLd;

  const int L = a.mask.L;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, z = blockIdx.z;
  const int k0 = blockIdx.x * kAttnTile;
  const AttnMask mk = attn_mask2(a.mask, a.slopes, h);
  const long long off = b * a.sb + h * a.sh;
  const long long so = (long long)a.H * HD * NS;
  const long long ooff = (long long)b * L * so + (long long)h * HD * NS;
  const T* kb = static_cast<const T*>(a.k) + off + (long long)k0 * a.sl;
  const T* vb = static_cast<const T*>(a.v) + off + (long long)k0 * a.sl;
  const T* qb = static_cast<const T*>(a.q) + off;
  const T* gb = static_cast<const T*>(a.dout) + ooff;
  const float* lseb = a.lse + (long long)bh * L;
  const float* dltb = a.delta + (long long)bh * L;

  int lo, hi;
  mk.span(k0, min(k0 + kAttnTile, L) - 1, true, lo, hi);
  const int qt0 = lo / kAttnTile, n = hi / kAttnTile - qt0 + 1;
  float dk[HD / 8][4], dv[HD / 8][4];
  attn_zero(dk);
  attn_zero(dv);
  for (int it = 0; it < n; ++it) {
    const int q0 = (qt0 + it) * kAttnTile;
    float pt[8][4], dpt[8][4];  // rows: this warp's keys; columns: the tile's queries
    attn_zero(pt);
    attn_zero(dpt);
    for (int sl = 0; sl < NS; ++sl) {
      attn_load_async<T, HD>(sK, kb + sl * HD, a.sl, L - k0);
      attn_load_async<T, HD>(sV, vb + sl * HD, a.sl, L - k0);
      attn_load_async<T, HD>(sQ, qb + q0 * a.sl + sl * HD, a.sl, L - q0);
      attn_load_async<T, HD>(sG, gb + q0 * so + sl * HD, so, L - q0);
      if (sl == 0) {  // lse (threads 0-63) and delta (64-127) of the tile's queries
        const int c = threadIdx.x & (kAttnTile - 1), i = q0 + c;
        const float* src = (threadIdx.x < kAttnTile ? lseb : dltb) + (i < L ? i : 0);
        cp_async4(smem_u32((threadIdx.x < kAttnTile ? sLse : sDlt) + c), src, i < L);
      }
      cp_async_commit();
      attn_stage_ready(false);
      if constexpr (kWg) {
        wg_fence();
        wg_scores<HD>(pt, smem_u32(sK), smem_u32(sQ), sl > 0);
        wg_scores<HD>(dpt, smem_u32(sV), smem_u32(sG), sl > 0);
        wg_commit();
        wg_wait<0>();
        reg_fence(pt);
        reg_fence(dpt);
      } else {
        mm_rows<HD>(pt, ln, reinterpret_cast<const float*>(sK),
                    reinterpret_cast<const float*>(sQ));
        mm_rows<HD>(dpt, ln, reinterpret_cast<const float*>(sV),
                    reinterpret_cast<const float*>(sG));
      }
      __syncthreads();  // the tiles are refilled next
    }
    if (z != NS - 1) {  // q's and do's slice z for dk's and dv's
      attn_load_async<T, HD>(sQ, qb + q0 * a.sl + z * HD, a.sl, L - q0);
      attn_load_async<T, HD>(sG, gb + q0 * so + z * HD, so, L - q0);
      cp_async_commit();
      attn_stage_ready(false);
    }
    attn_scores<true>(pt, ln, mk, k0, q0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        pt[nt][c] = exp2f(pt[nt][c] - sLse[ln.col(nt, c & 1)] * kLog2e);
    if constexpr (kWg) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dpt[nt][c] = pt[nt][c] * (dpt[nt][c] - sDlt[ln.col(nt, c & 1)]);
      uint32_t p[4][4], ds[4][4];
      wg_pack(p, pt);
      wg_pack(ds, dpt);
      reg_fence(dv);
      reg_fence(dk);
      wg_fence();
      wg_accum<HD>(dv, p, smem_u32(sG));
      wg_accum<HD>(dk, ds, smem_u32(sQ));
      wg_commit();
      wg_wait<0>();
      reg_fence(dv);
      reg_fence(dk);
    } else {
      mm_scores<HD>(dv, ln, pt, reinterpret_cast<const float*>(sG), scratch);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) pt[nt][c] *= dpt[nt][c] - sDlt[ln.col(nt, c & 1)];  // ds^T
      mm_scores<HD>(dk, ln, pt, reinterpret_cast<const float*>(sQ), scratch);
    }
    __syncthreads();  // every read of this tile is done before the next one's copies
  }
  const float one[2] = {1.f, 1.f}, mul[2] = {a.mask.scale, a.mask.scale};
  attn_store<T, HD>(static_cast<T*>(a.dk) + ooff + z * HD, so, dk, ln, k0, L, mul);
  attn_store<T, HD>(static_cast<T*>(a.dv) + ooff + z * HD, so, dv, ln, k0, L, one);
}

template <typename T>
cudaError_t launch_attn_bwd_wide(const AttnBwdArgs& a, int NS, cudaStream_t s) {
  const dim3 grid((a.mask.L + kAttnTile - 1) / kAttnTile, a.B * a.H, NS);
  const size_t smem_dq = attn_smem_bytes<T, 128>(4, kAttnTile);
  cudaError_t e = cudaFuncSetAttribute(attn_dq_wide_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (e != cudaSuccess) return e;
  attn_dq_wide_kernel<T><<<grid, kAttnThreads, smem_dq, s>>>(a, NS);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem_dkv = attn_smem_bytes<T, 128>(4, 2 * kAttnTile);
  e = cudaFuncSetAttribute(attn_dkv_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_dkv);
  if (e != cudaSuccess) return e;
  attn_dkv_wide_kernel<T><<<grid, kAttnThreads, smem_dkv, s>>>(a, NS);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_attn_bwd(const AttnBwdArgs& a, cudaStream_t s) {
  const int L = a.mask.L;
  const dim3 grid((L + kAttnTile - 1) / kAttnTile, a.B * a.H);
  const size_t smem_dq = attn_smem_bytes<T, HD>(2 + 2 * kAttnStages, kAttnTile);
  cudaError_t e = cudaFuncSetAttribute(attn_dq_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (e != cudaSuccess) return e;
  attn_dq_kernel<T, HD><<<grid, kAttnThreads, smem_dq, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem_dkv =
      attn_smem_bytes<T, HD>(2 + 2 * kAttnStages, 2 * kAttnStages * kAttnTile);
  e = cudaFuncSetAttribute(attn_dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_dkv);
  if (e != cudaSuccess) return e;
  attn_dkv_kernel<T, HD><<<grid, kAttnThreads, smem_dkv, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_attn_bwd_hd(const AttnBwdArgs& a, int hd, cudaStream_t s) {
  switch (hd) {
    case 32: return launch_attn_bwd<T, 32>(a, s);
    case 64: return launch_attn_bwd<T, 64>(a, s);
    case 128: return launch_attn_bwd<T, 128>(a, s);
    default:
      if (hd > 128 && hd % 128 == 0 && hd / 128 <= 65535)
        return launch_attn_bwd_wide<T>(a, hd / 128, s);
      return cudaErrorInvalidValue;
  }
}

}  // namespace pc

// q, k, v as for pc_attn_fwd; o, dout, dq, dk, dv contiguous [B, L, H, hd]
// in the same dtype; lse float32 [B*H, L]; delta float32 [B*H, L] scratch,
// written and read here.
extern "C" int pc_attn_bwd(const void* q, const void* k, const void* v, long long sb,
                           long long sl, long long sh, const float* slopes, const void* o,
                           const void* dout, const float* lse, float* delta, void* dq,
                           void* dk, void* dv, int B, int L, int H, int hd, int use_slopes,
                           int symmetric, int causal, int window, float scale, int bf16,
                           void* stream) {
  pc::AttnBwdArgs a{q, k, v, sb, sl, sh, slopes, o, dout, lse, delta, dq, dk, dv, B, H,
                    pc::AttnMask{scale, 0.f, L, causal, window, use_slopes, symmetric}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return pc::launch_attn_bwd_hd<__nv_bfloat16>(a, hd, s);
  return pc::launch_attn_bwd_hd<float>(a, hd, s);
}
