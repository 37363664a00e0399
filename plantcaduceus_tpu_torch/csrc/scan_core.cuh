// Selective-scan forward, shared device code of K1 (scan_fwd.cu) and the
// scan half of K2 (mixer_fwd.cu).
//
// Math (per row, channel d, state n), the same as
// plantcaduceus_tpu/ops/pallas_scan.py::_fwd_kernel:
//   dt'  = softplus(dt + dt_bias)     dt = dt_lr . W_dt[:, d] when FUSE
//   h_n  = exp2(dt' * log2e * A[d,n]) * h_n + B[t,n] * dt' * x[t,d]
//   y    = sum_n C[t,n] * h_n + Dskip[d] * x[t,d]
//
// Layout (that of the mamba_ssm forward, not the TPU kernel's block walk):
// a block owns (row, tile of kScanThreads channels); each thread owns one
// channel and keeps its N fp32 states in registers while it walks time in
// order, L-1 down to 0 when `reverse` is set, so no flipped copy of any
// tensor exists. B, C (and dt_lr) rows of each time chunk are shared by
// every channel, so the block stages them in shared memory once per chunk;
// the W_dt tile sits in shared memory for the whole run.
//
// Training variant (hb != nullptr): before processing step p (counted in
// processing order) with p % hbc == 0, the thread stores its N states to
// hb[row][p / hbc][d][:], as pallas_scan.py's emit_hb (hb [rows, L/chunk,
// D, N], processing order). K3 (scan_bwd.cu) recomputes each chunk from it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kScanThreads = 128;  // channels per block
constexpr int kScanChunk = 64;     // time steps staged per shared-memory pass

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Same form as the plain version (torch softplus, threshold 20); agrees with
// jax.nn.softplus to float32 rounding.
__device__ __forceinline__ float softplus(float x) { return x > 20.f ? x : log1pf(expf(x)); }

// Fused dt: the dt_lr row of one step (shared) against this channel's
// column of the W_dt tile (shared, row stride `wstride`). Forward and
// backward call this one function, so the backward's recomputed states are
// bit-identical to the forward's.
__device__ __forceinline__ float fused_dt(const float* sdt_row, const float* sW,
                                          int R, int wstride, int tid) {
  float v = 0.f;
  for (int r = 0; r < R; ++r) v = fmaf(sdt_row[r], sW[r * wstride + tid], v);
  return v;
}

// One step of the recurrence for one channel: h = exp2(dt'*log2e*A) * h +
// B*dt'*x. With Y, also returns the readout sum_n C[n]*h[n], in the same
// loop (the forward); without, returns 0 (K3's recompute).
template <int N, bool Y>
__device__ __forceinline__ float scan_step(float (&h)[N], const float (&A)[N],
                                           const float* sBrow, const float* sCrow,
                                           float dtp, float xv) {
  const float dtl = dtp * kLog2e;
  const float dtx = dtp * xv;
  float acc = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = fmaf(exp2f(dtl * A[n]), h[n], sBrow[n] * dtx);
    if constexpr (Y) acc = fmaf(sCrow[n], h[n], acc);
  }
  return acc;
}

// N fp32 states to / from hb (N % 4 == 0; each thread's N floats are 16-byte aligned).
template <int N>
__device__ __forceinline__ void store_state(float* dst, const float (&h)[N]) {
#pragma unroll
  for (int n = 0; n < N; n += 4)
    reinterpret_cast<float4*>(dst)[n / 4] = make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
}

template <int N>
__device__ __forceinline__ void load_state(float (&h)[N], const float* src) {
#pragma unroll
  for (int n = 0; n < N; n += 4) {
    const float4 v = reinterpret_cast<const float4*>(src)[n / 4];
    h[n] = v.x; h[n + 1] = v.y; h[n + 2] = v.z; h[n + 3] = v.w;
  }
}

struct ScanArgs {
  const void* x;      // [rows, L, D]
  const void* dt;     // dt [rows, L, D], or dt_lr with R columns when FUSE
  const void* B;      // B[t, n] at B + row*bc_row + t*bc_step + n
  const void* C;
  const float* A;     // [D, N]
  const float* Dskip; // [D]
  const float* dt_bias;  // [D]
  const float* wdt;   // [R, D] when FUSE
  void* y;            // [rows, L, D]
  float* hb;          // [rows, ceil(L/hbc), D, N] chunk-entry states, or nullptr
  int L, D, R, reverse, hbc;
  long long dt_row, dt_step, bc_row, bc_step;  // element strides
};

inline size_t scan_smem_bytes(int N, int R, bool fuse) {
  return sizeof(float) *
         (2 * kScanChunk * N + (fuse ? kScanChunk * R + R * kScanThreads : 0));
}

// HB: the training variant, chosen at launch from a.hb, so the inference
// kernel carries no per-step test for it.
template <typename Tx, typename Tb, typename Ty, int N, bool FUSE, bool HB>
__global__ void __launch_bounds__(kScanThreads) scan_kernel(ScanArgs a) {
  extern __shared__ float smem[];
  float* sB = smem;                   // [kScanChunk][N]
  float* sC = sB + kScanChunk * N;    // [kScanChunk][N]
  float* sdt = sC + kScanChunk * N;   // [kScanChunk][R]
  float* sW = sdt + kScanChunk * a.R; // [R][kScanThreads]
  const int tid = threadIdx.x;
  const long long row = blockIdx.y;
  const int d0 = blockIdx.x * kScanThreads;
  const int d = d0 + tid;
  const bool live = d < a.D;
  const long long xrow = row * (long long)a.L * a.D;
  const Tx* x = static_cast<const Tx*>(a.x) + xrow;
  Ty* y = static_cast<Ty*>(a.y) + xrow;
  const Tb* dt = static_cast<const Tb*>(a.dt) + row * a.dt_row;
  const Tb* Bm = static_cast<const Tb*>(a.B) + row * a.bc_row;
  const Tb* Cm = static_cast<const Tb*>(a.C) + row * a.bc_row;

  if (FUSE) {
    for (int i = tid; i < a.R * kScanThreads; i += kScanThreads) {
      const int r = i / kScanThreads, c = d0 + i % kScanThreads;
      sW[i] = c < a.D ? a.wdt[(long long)r * a.D + c] : 0.f;
    }
  }
  float A[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = live ? a.A[(long long)d * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float bias = live ? a.dt_bias[d] : 0.f;
  const float dsk = live ? a.Dskip[d] : 0.f;
  float* hb = HB ? a.hb + row * (long long)((a.L + a.hbc - 1) / a.hbc) * a.D * N : nullptr;

  const int nchunks = (a.L + kScanChunk - 1) / kScanChunk;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int t0 = (a.reverse ? nchunks - 1 - ci : ci) * kScanChunk;
    const int tn = min(kScanChunk, a.L - t0);
    __syncthreads();  // every reader of the previous chunk is done
    for (int i = tid; i < tn * N; i += kScanThreads) {
      const long long off = (long long)(t0 + i / N) * a.bc_step + i % N;
      sB[i] = to_f(Bm[off]);
      sC[i] = to_f(Cm[off]);
    }
    if (FUSE) {
      for (int i = tid; i < tn * a.R; i += kScanThreads)
        sdt[i] = to_f(dt[(long long)(t0 + i / a.R) * a.dt_step + i % a.R]);
    }
    __syncthreads();
    if (!live) continue;  // idle lanes still reach every barrier above
    for (int k = 0; k < tn; ++k) {
      const int tt = a.reverse ? tn - 1 - k : k;
      const long long t = t0 + tt;
      const float xv = to_f(x[t * a.D + d]);
      const float dtv = FUSE ? fused_dt(sdt + tt * a.R, sW, a.R, kScanThreads, tid)
                             : to_f(dt[t * a.dt_step + d]);
      if constexpr (HB) {
        const int p = a.reverse ? a.L - 1 - (int)t : (int)t;
        if (p % a.hbc == 0) store_state<N>(hb + ((long long)(p / a.hbc) * a.D + d) * N, h);
      }
      const float acc =
          scan_step<N, true>(h, A, sB + tt * N, sC + tt * N, softplus(dtv + bias), xv);
      y[t * a.D + d] = from_f<Ty>(fmaf(xv, dsk, acc));
    }
  }
}

template <typename Tx, typename Tb, typename Ty, int N, bool FUSE>
cudaError_t launch_scan_t(const ScanArgs& a, int rows, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(N, a.R, FUSE);
  auto kern = a.hb ? scan_kernel<Tx, Tb, Ty, N, FUSE, true>
                   : scan_kernel<Tx, Tb, Ty, N, FUSE, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((a.D + kScanThreads - 1) / kScanThreads, rows);
  kern<<<grid, kScanThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The wrappers admit N in {4, 8, 16, 32} only.
template <typename Tx, typename Tb, typename Ty, bool FUSE>
cudaError_t launch_scan(const ScanArgs& a, int N, int rows, cudaStream_t stream) {
  switch (N) {
    case 4: return launch_scan_t<Tx, Tb, Ty, 4, FUSE>(a, rows, stream);
    case 8: return launch_scan_t<Tx, Tb, Ty, 8, FUSE>(a, rows, stream);
    case 16: return launch_scan_t<Tx, Tb, Ty, 16, FUSE>(a, rows, stream);
    case 32: return launch_scan_t<Tx, Tb, Ty, 32, FUSE>(a, rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pc

extern "C" const char* pc_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
