// K8 — flash attention backward with a structured bias: dq, dk, dv from q,
// k, v, o, do and the forward's lse (K7), any sequence length, head dim 32,
// 64 or 128.
//
// Replaces plantcaduceus_tpu/ops/pallas_attention.py::_dq_kernel (:103)
// and ::_dkv_kernel (:135), launched at :247 and :263 by _bwd (the custom
// VJP's backward, :310), with the wrapper's delta = rowsum(do * o) (:231).
// Three kernels on one stream, no atomics, so two launches give equal bits:
//  (a) attn_delta_kernel: delta [B*H, L] = sum_d do * o, float32;
//  (b) attn_dq_kernel, per (b*h, 64-query tile), over the key tiles its rows
//      see: s and p = exp(s - lse) recomputed, dp = do v^T,
//      ds = p (dp - delta), dq += ds k; dq = scale * dq at the end;
//  (c) attn_dkv_kernel, per (b*h, 64-key tile), over the query tiles that
//      see its keys: the transposed scores s^T = k q^T and p^T, dv += p^T
//      do, dp^T = v do^T, ds^T = p^T (dp^T - delta), dk += ds^T q; dk =
//      scale * dk.
// The block products and the bias are attn_core.cuh's, so the recomputed
// scores equal the forward's bit for bit. dq, dk and dv come out in the
// inputs' dtype, contiguous [B, L, H, hd].
//
// What bounds it on an H100: seven products of 2 L^2 hd flops per (b, h)
// (s twice, dp twice, dv, dk, dq: 90 GFLOP at the training shape 32 x 512,
// H 12, hd 64: 0.09 ms on the bf16 tensor cores, 1.35 ms as float32 FMA);
// the bytes (q, k, v, o, do in, dq, dk, dv out: ~0.1 GB) come second. As
// K7, a simple mma.sync kernel first; wgmma and TMA are later work.
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
  float* delta;          // [B*H, L], written by (a)
  void *dq, *dk, *dv;    // contiguous [B, L, H, hd]
  int B, H;
  AttnMask mask;
};

// One thread per (b, i, h) row, in that order (consecutive threads read
// consecutive rows).
template <typename T, int HD>
__global__ void attn_delta_kernel(AttnBwdArgs a) {
  const int L = a.mask.L;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)a.B * L * a.H) return;
  const int h = idx % a.H;
  const long long bi = idx / a.H;
  const int i = bi % L, b = bi / L;
  const T* o = static_cast<const T*>(a.o) + idx * HD;
  const T* g = static_cast<const T*>(a.dout) + idx * HD;
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) s = fmaf(to_f(g[d]), to_f(o[d]), s);
  a.delta[((long long)b * a.H + h) * L + i] = s;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kAttnThreads) attn_dq_kernel(AttnBwdArgs a) {
  constexpr int LD = AttnLd<T, HD>::v;
  extern __shared__ __align__(16) unsigned char attn_smem[];
  T* sQ = reinterpret_cast<T*>(attn_smem);
  T* sG = sQ + kAttnTile * LD;  // do
  T* sK = sG + kAttnTile * LD;
  T* sV = sK + kAttnTile * LD;
  const AttnLane ln;
  float* scratch = reinterpret_cast<float*>(sV + kAttnTile * LD) + ln.w * 16 * kAttnPLd;

  const int L = a.mask.L;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kAttnTile;
  AttnMask mk = a.mask;
  mk.slope = mk.use_slopes ? a.slopes[h] : 0.f;
  const long long off = b * a.sb + h * a.sh;
  const long long so = (long long)a.H * HD, ooff = (long long)b * L * so + h * HD;
  attn_load<T, HD>(sQ, static_cast<const T*>(a.q) + off + q0 * a.sl, a.sl, L - q0);
  attn_load<T, HD>(sG, static_cast<const T*>(a.dout) + ooff + q0 * so, so, L - q0);
  float lse[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + ln.row(r);
    lse[r] = i < L ? a.lse[(long long)bh * L + i] : 0.f;
    dlt[r] = i < L ? a.delta[(long long)bh * L + i] : 0.f;
  }

  int lo, hi;
  mk.span(q0, min(q0 + kAttnTile, L) - 1, false, lo, hi);
  float dq[HD / 8][4];
  attn_zero(dq);
  for (int kt = lo / kAttnTile; kt <= hi / kAttnTile; ++kt) {
    const int k0 = kt * kAttnTile;
    __syncthreads();
    attn_load<T, HD>(sK, static_cast<const T*>(a.k) + off + k0 * a.sl, a.sl, L - k0);
    attn_load<T, HD>(sV, static_cast<const T*>(a.v) + off + k0 * a.sl, a.sl, L - k0);
    __syncthreads();
    float s[8][4], dp[8][4];
    attn_zero(s);
    attn_zero(dp);
    mm_rows<HD>(s, ln, sQ, sK);
    mm_rows<HD>(dp, ln, sG, sV);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        const float p = expf(mk.score(s[nt][c], q0 + ln.row(r), k0 + ln.col(nt, c & 1)) - lse[r]);
        s[nt][c] = p * (dp[nt][c] - dlt[r]);  // ds
      }
    mm_scores<HD>(dq, ln, s, sK, scratch);
  }
  const float mul[2] = {mk.scale, mk.scale};
  attn_store<T, HD>(static_cast<T*>(a.dq) + ooff, so, dq, ln, q0, L, mul);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kAttnThreads) attn_dkv_kernel(AttnBwdArgs a) {
  constexpr int LD = AttnLd<T, HD>::v;
  extern __shared__ __align__(16) unsigned char attn_smem[];
  T* sK = reinterpret_cast<T*>(attn_smem);
  T* sV = sK + kAttnTile * LD;
  T* sQ = sV + kAttnTile * LD;
  T* sG = sQ + kAttnTile * LD;  // do
  float* sLse = reinterpret_cast<float*>(sG + kAttnTile * LD);
  float* sDlt = sLse + kAttnTile;
  const AttnLane ln;
  float* scratch = sDlt + kAttnTile + ln.w * 16 * kAttnPLd;

  const int L = a.mask.L;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kAttnTile;
  AttnMask mk = a.mask;
  mk.slope = mk.use_slopes ? a.slopes[h] : 0.f;
  const long long off = b * a.sb + h * a.sh;
  const long long so = (long long)a.H * HD, ooff = (long long)b * L * so + h * HD;
  attn_load<T, HD>(sK, static_cast<const T*>(a.k) + off + k0 * a.sl, a.sl, L - k0);
  attn_load<T, HD>(sV, static_cast<const T*>(a.v) + off + k0 * a.sl, a.sl, L - k0);

  int lo, hi;
  mk.span(k0, min(k0 + kAttnTile, L) - 1, true, lo, hi);
  float dk[HD / 8][4], dv[HD / 8][4];
  attn_zero(dk);
  attn_zero(dv);
  for (int qt = lo / kAttnTile; qt <= hi / kAttnTile; ++qt) {
    const int q0 = qt * kAttnTile;
    __syncthreads();
    attn_load<T, HD>(sQ, static_cast<const T*>(a.q) + off + q0 * a.sl, a.sl, L - q0);
    attn_load<T, HD>(sG, static_cast<const T*>(a.dout) + ooff + q0 * so, so, L - q0);
    if (threadIdx.x < kAttnTile) {
      const int i = q0 + threadIdx.x;
      sLse[threadIdx.x] = i < L ? a.lse[(long long)bh * L + i] : 0.f;
      sDlt[threadIdx.x] = i < L ? a.delta[(long long)bh * L + i] : 0.f;
    }
    __syncthreads();
    // rows: this warp's keys; columns: the tile's queries
    float st[8][4], dpt[8][4];
    attn_zero(st);
    attn_zero(dpt);
    mm_rows<HD>(st, ln, sK, sQ);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = ln.col(nt, c & 1);
        st[nt][c] = expf(mk.score(st[nt][c], q0 + col, k0 + ln.row(c >> 1)) - sLse[col]);
      }
    mm_scores<HD>(dv, ln, st, sG, scratch);
    mm_rows<HD>(dpt, ln, sV, sG);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[nt][c] *= dpt[nt][c] - sDlt[ln.col(nt, c & 1)];  // ds^T
    mm_scores<HD>(dk, ln, st, sQ, scratch);
  }
  const float one[2] = {1.f, 1.f}, mul[2] = {mk.scale, mk.scale};
  attn_store<T, HD>(static_cast<T*>(a.dk) + ooff, so, dk, ln, k0, L, mul);
  attn_store<T, HD>(static_cast<T*>(a.dv) + ooff, so, dv, ln, k0, L, one);
}

template <typename T, int HD>
cudaError_t launch_attn_bwd(const AttnBwdArgs& a, cudaStream_t s) {
  const int L = a.mask.L;
  const long long rows = (long long)a.B * L * a.H;
  attn_delta_kernel<T, HD><<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((L + kAttnTile - 1) / kAttnTile, a.B * a.H);
  const size_t smem_dq = attn_smem_bytes<T, HD>(4, 0);
  e = cudaFuncSetAttribute(attn_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_dq);
  if (e != cudaSuccess) return e;
  attn_dq_kernel<T, HD><<<grid, kAttnThreads, smem_dq, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem_dkv = attn_smem_bytes<T, HD>(4, 2 * kAttnTile);
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
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pc

// q, k, v as for pc_attn_fwd; o, dout, dq, dk, dv contiguous [B, L, H, hd]
// in the same dtype; lse and delta (scratch) float32 [B*H, L].
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
