// K7 — flash attention forward with a structured bias (ALiBi, local window,
// causal), any sequence length, head dim 32, 64, 128 or a multiple of 128.
//
// Replaces plantcaduceus_tpu/ops/pallas_attention.py::_fwd_kernel (:63,
// with _block_bias :43; launched at :197 by _fwd, which flash_attention and
// its custom VJP call): q, k, v [B, L, H, hd] -> o [B, L, H, hd] in q's
// dtype and the row logsumexp lse [B*H, L] float32, the residual K8 reads.
// The bias is rebuilt from indices (attn_core.cuh), never read.
//
// A block (one warpgroup, 128 threads) owns one (b*h, 64-query tile) and
// walks the key tiles that its rows can see (all of them; with causal up
// to its last row; with a window those within reach of its rows: the tiles
// it skips would add exactly 0), with an online softmax: running max m, sum
// l and accumulator in float32 registers, rescaled by exp2(m_old - m_new)
// at each tile, as the TPU kernel does (in base 2). At the end o = acc / l
// (l == 0 taken as 1, :97-99) and lse = ln 2 * (m + log2 l). The TPU's
// 128-lane lse layout [BH, L, 128] is a layout only; here it is [BH, L].
//
// What bounds it on an H100: in bf16 the bytes of q, k, v and o (0.40 GB at
// the scoring shape 128 x 512, H 12, hd 64: 0.12 ms) beside the two products
// on the tensor cores (103 GFLOP: 0.10 ms) and one exp2 per score on the
// SFU (0.10 ms); in float32 the products as FMA (1.5 ms at 67 TFLOP/s).
// The design against it: the Q tile is copied once and stays in shared
// memory as a wgmma operand; K and V tiles arrive by cp.async into a ring
// of two stages, the next pair loading while the current one computes;
// s = q k^T is one chain of wgmma (both operands in shared memory), and
// o += p v takes p from the accumulator registers, packed to bf16 in place,
// with V read MN-major from the same tile; interior tiles take only the
// ALiBi term, one FMA a score before exp2. One warpgroup of 64 query rows a
// block, four blocks an SM at hd 64 (41 KB of shared memory, 116 registers
// a thread): the blocks' chains of copy wait, products and softmax overlap
// on the SM. Measured on an H100 (tools/attn_bench.py): two warpgroups a
// block sharing each K/V tile (half the tiles' traffic from L2), a third
// ring stage, or a register cap for five blocks an SM were each no faster;
// what is left is each warpgroup's serial chain, which wgmma issued ahead
// of the softmax (a later design) would overlap.
// float32 keeps the FMA loops (no TF32) on the same ring, with 16-byte
// reads of shared memory.
//
// Head dims above 128 (JAX pads them to a multiple of 128,
// pallas_attention.py:172-186): attn_fwd_wide_kernel, in 128-wide slices
// (attn_core.cuh): block z of a (b*h, query tile) sums q k^T over the
// slices, then accumulates p v_z, v's slice z; every block gets the same
// scores, m, l and lse, and block 0 writes lse. Three tiles of shared
// memory at any hd, each copied, waited for and used. What bounds it: at
// hd 256 the products double against hd 128, and the scores are computed
// once per slice, twice the q k^T work; a simple first design.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include "attn_core.cuh"

namespace pc {

struct AttnFwdArgs {
  const void *q, *k, *v;
  long long sb, sl, sh;  // strides of q, k and v (elements)
  const float* slopes;   // [H]
  void* o;               // [B, L, H, hd]
  float* lse;            // [B*H, L]
  int H;
  AttnMask mask;
};

// One key tile's step of the online softmax: s (base-2 scores, bias
// applied) becomes p, the rows' max m and sum l move on, acc is rescaled
// and gains p v, v the [64][HD] tile at tV.
template <typename T, int HD>
__device__ __forceinline__ void attn_softmax_pv(float (&s)[8][4], float (&m)[2], float (&l)[2],
                                                float (&acc)[HD / 8][4], const AttnLane& ln,
                                                unsigned char* tV, float* scratch) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kAttnNeg;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
    const float m_new = fmaxf(m[r], quad_max(mx));
    const float alpha = exp2f(m[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[nt][2 * r + e];
        v = exp2f(v - m_new);
        sum += v;
      }
    l[r] = l[r] * alpha + quad_sum(sum);
    m[r] = m_new;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      acc[nd][2 * r] *= alpha;
      acc[nd][2 * r + 1] *= alpha;
    }
  }
  if constexpr (std::is_same<T, bf16>::value) {
    uint32_t p[4][4];
    wg_pack(p, s);
    reg_fence(acc);
    wg_fence();
    wg_accum<HD>(acc, p, smem_u32(tV));
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
  } else {
    mm_scores<HD>(acc, ln, s, reinterpret_cast<const float*>(tV), scratch);
  }
}

// o = acc / l (l == 0 taken as 1) into columns 128 z .. of a head of NS
// HD-wide slices (NS = 1, z = 0 below hd 128), and lse = ln 2 (m + log2 l)
// where `write_lse`.
template <typename T, int HD>
__device__ __forceinline__ void attn_fwd_finish(const AttnFwdArgs& a, const float (&acc)[HD / 8][4],
                                                const float (&m)[2], const float (&l)[2],
                                                const AttnLane& ln, int b, int h, int bh, int q0,
                                                int NS, int z, bool write_lse) {
  const int L = a.mask.L;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsafe = l[r] > 0.f ? l[r] : 1.f;
    inv[r] = 1.f / lsafe;
    const int i = q0 + ln.row(r);
    if (write_lse && ln.t == 0 && i < L)
      a.lse[(long long)bh * L + i] = (m[r] + log2f(lsafe)) * kLn2;
  }
  const long long so = (long long)a.H * HD * NS;
  attn_store<T, HD>(static_cast<T*>(a.o) + (long long)b * L * so + ((long long)h * NS + z) * HD,
                    so, acc, ln, q0, L, inv);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kAttnThreads) attn_fwd_kernel(AttnFwdArgs a) {
  constexpr bool kWg = std::is_same<T, bf16>::value;
  constexpr int kTB = AttnTile<T, HD>::kBytes;
  extern __shared__ unsigned char attn_smem[];
  unsigned char* sQ = attn_smem_base(attn_smem);
  unsigned char* sK = sQ + kTB;  // stage st at sK + st * 2 * kTB, v after k
  const AttnLane ln;
  float* scratch = reinterpret_cast<float*>(sQ + (1 + 2 * kAttnStages) * kTB) +
                   ln.w * 16 * kAttnPLd;

  const int L = a.mask.L;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kAttnTile;
  const AttnMask mk = attn_mask2(a.mask, a.slopes, h);
  const long long off = b * a.sb + h * a.sh;
  const T* qb = static_cast<const T*>(a.q) + off;
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
  attn_load_async<T, HD>(sQ, qb + q0 * a.sl, a.sl, L - q0);
  load_kv(kt0, 0);

  float m[2] = {kAttnNeg, kAttnNeg}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
  attn_zero(acc);
  for (int it = 0; it < n; ++it) {
    const int st = it & 1, k0 = (kt0 + it) * kAttnTile;
    if (it + 1 < n) load_kv(kt0 + it + 1, st ^ 1);
    attn_stage_ready(it + 1 < n);
    unsigned char* tK = sK + st * 2 * kTB;
    unsigned char* tV = tK + kTB;
    float s[8][4];
    attn_zero(s);
    if constexpr (kWg) {
      wg_fence();
      wg_scores<HD>(s, smem_u32(sQ), smem_u32(tK));
      wg_commit();
      wg_wait<0>();
      reg_fence(s);
    } else {
      mm_rows<HD>(s, ln, reinterpret_cast<const float*>(sQ),
                  reinterpret_cast<const float*>(tK));
    }
    attn_scores<false>(s, ln, mk, q0, k0);
    attn_softmax_pv<T, HD>(s, m, l, acc, ln, tV, scratch);
    __syncthreads();  // every read of this stage is done before it is refilled
  }
  attn_fwd_finish<T, HD>(a, acc, m, l, ln, b, h, bh, q0, 1, 0, true);
}

// Head dims above 128: block (query tile, b*h, z) of NS = hd / 128, as the
// head of this file says.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads) attn_fwd_wide_kernel(AttnFwdArgs a, int NS) {
  constexpr int HD = 128;
  constexpr bool kWg = std::is_same<T, bf16>::value;
  constexpr int kTB = AttnTile<T, HD>::kBytes;
  extern __shared__ unsigned char attn_smem[];
  unsigned char* sQ = attn_smem_base(attn_smem);
  unsigned char* sK = sQ + kTB;
  unsigned char* sV = sK + kTB;
  const AttnLane ln;
  float* scratch = reinterpret_cast<float*>(sQ + 3 * kTB) + ln.w * 16 * kAttnPLd;

  const int L = a.mask.L;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, z = blockIdx.z;
  const int q0 = blockIdx.x * kAttnTile;
  const AttnMask mk = attn_mask2(a.mask, a.slopes, h);
  const long long off = b * a.sb + h * a.sh;
  const T* qb = static_cast<const T*>(a.q) + off + (long long)q0 * a.sl;
  const T* kb = static_cast<const T*>(a.k) + off;
  const T* vb = static_cast<const T*>(a.v) + off + z * HD;

  int lo, hi;
  mk.span(q0, min(q0 + kAttnTile, L) - 1, false, lo, hi);
  const int kt0 = lo / kAttnTile, n = hi / kAttnTile - kt0 + 1;
  float m[2] = {kAttnNeg, kAttnNeg}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
  attn_zero(acc);
  for (int it = 0; it < n; ++it) {
    const int k0 = (kt0 + it) * kAttnTile;
    float s[8][4];
    attn_zero(s);
    for (int sl = 0; sl < NS; ++sl) {
      attn_load_async<T, HD>(sQ, qb + sl * HD, a.sl, L - q0);
      attn_load_async<T, HD>(sK, kb + k0 * a.sl + sl * HD, a.sl, L - k0);
      if (sl == NS - 1) attn_load_async<T, HD>(sV, vb + k0 * a.sl, a.sl, L - k0);
      cp_async_commit();
      attn_stage_ready(false);
      if constexpr (kWg) {
        wg_fence();
        wg_scores<HD>(s, smem_u32(sQ), smem_u32(sK), sl > 0);
        wg_commit();
        wg_wait<0>();
        reg_fence(s);
      } else {
        mm_rows<HD>(s, ln, reinterpret_cast<const float*>(sQ),
                    reinterpret_cast<const float*>(sK));
      }
      __syncthreads();  // q and k are refilled by the next slice
    }
    attn_scores<false>(s, ln, mk, q0, k0);
    attn_softmax_pv<T, HD>(s, m, l, acc, ln, sV, scratch);
    __syncthreads();  // v is refilled by the next key tile
  }
  attn_fwd_finish<T, HD>(a, acc, m, l, ln, b, h, bh, q0, NS, z, z == 0);
}

template <typename T, int HD>
cudaError_t launch_attn_fwd(const AttnFwdArgs& a, int B, cudaStream_t s) {
  const size_t smem = attn_smem_bytes<T, HD>(1 + 2 * kAttnStages, 0);
  cudaError_t e = cudaFuncSetAttribute(attn_fwd_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.mask.L + kAttnTile - 1) / kAttnTile, B * a.H);
  attn_fwd_kernel<T, HD><<<grid, kAttnThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_attn_fwd_wide(const AttnFwdArgs& a, int B, int NS, cudaStream_t s) {
  const size_t smem = attn_smem_bytes<T, 128>(3, 0);
  cudaError_t e = cudaFuncSetAttribute(attn_fwd_wide_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.mask.L + kAttnTile - 1) / kAttnTile, B * a.H, NS);
  attn_fwd_wide_kernel<T><<<grid, kAttnThreads, smem, s>>>(a, NS);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_attn_fwd_hd(const AttnFwdArgs& a, int B, int hd, cudaStream_t s) {
  switch (hd) {
    case 32: return launch_attn_fwd<T, 32>(a, B, s);
    case 64: return launch_attn_fwd<T, 64>(a, B, s);
    case 128: return launch_attn_fwd<T, 128>(a, B, s);
    default:
      if (hd > 128 && hd % 128 == 0 && hd / 128 <= 65535)
        return launch_attn_fwd_wide<T>(a, B, hd / 128, s);
      return cudaErrorInvalidValue;
  }
}

}  // namespace pc

// q, k, v share the strides (sb, sl, sh) and have a unit last stride, 16-byte
// aligned rows; o is contiguous [B, L, H, hd], lse [B*H, L]; the wrapper
// checks all of it. window < 0: no window.
extern "C" int pc_attn_fwd(const void* q, const void* k, const void* v, long long sb,
                           long long sl, long long sh, const float* slopes, void* o,
                           float* lse, int B, int L, int H, int hd, int use_slopes,
                           int symmetric, int causal, int window, float scale, int bf16,
                           void* stream) {
  pc::AttnFwdArgs a{q, k, v, sb, sl, sh, slopes, o, lse, H,
                    pc::AttnMask{scale, 0.f, L, causal, window, use_slopes, symmetric}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return pc::launch_attn_fwd_hd<__nv_bfloat16>(a, B, hd, s);
  return pc::launch_attn_fwd_hd<float>(a, B, hd, s);
}
