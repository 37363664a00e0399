// K1 — selective-scan forward, one direction.
//
// Replaces plantcaduceus_tpu/ops/pallas_scan.py::_fwd_kernel (launched at
// pallas_scan.py:293 through _pallas_scan_group / selective_scan_pallas):
// the `reverse` flag, both dt modes (dt given per channel, or dt_lr
// projected up by W_dt inside the kernel), the carry options h0 and
// emit_hfin (pallas_scan.py:93-95, 179), for training emit_hb (chunk-entry
// states every `hbc` steps, pallas_scan.py:120-122, 286-288), and the
// `combine` epilogue y = (y + y_prev) * silu(z) (pallas_scan.py:78, 82-83,
// 195-201, 213-221), which bimamba_scan_gated's reverse direction runs
// (pallas_scan.py:743-835, under PCAD_GATED_KERNEL=1). combine reads two
// more [rows, L, D] tensors and saves the separate sum-and-gate pass's
// reads of both directions' y and z and its write; the exp2 per state
// still bounds the kernel (scan_core.cuh). The combine kernels build in a
// unit of their own (this file with PC_SCAN_COMBINE: pc_scan_fwd_combine),
// beside the others (pc_scan_fwd), which they would otherwise lengthen.
//
// This file holds K1's input policy and entry point only: the kernel is
// scan_core.cuh's scan_fwd_kernel, the forward scan K2 also runs. K1's
// policy loads x (and, unfused, dt) of the next 8-step chunk into registers
// while a chunk computes, and reads the B, C and dt_lr rows as the kernel
// stages them. See scan_core.cuh for the layout, the numerics and the bound.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include "scan_core.cuh"

namespace pc {

struct ScanLoadArgs {
  const void* x;   // [rows, L, D]
  const void* dt;  // [rows, L, D], or dt_lr [rows, L, R] when fused
  const void* B;   // [rows, L, N]
  const void* C;
  int N;
};

// x and dt from device memory, B | C | dt_lr rows for the kernel's staging.
// COMB: the combine kernel's policy (scan_core.cuh).
template <typename T, bool FUSE, bool COMB>
struct ScanLoadSrc {
  using Args = ScanLoadArgs;
  using Raw = T;
  static constexpr bool kFuse = FUSE, kHb = !COMB, kCombine = COMB;
  static constexpr int kSmemFloats = 0;
  const T *x, *dt, *B, *C;
  int L, D, R, N, reverse;
  bool live;
  T xr[kFwdT], dr[kFwdT];  // the next chunk's x (and dt), raw
  __device__ ScanLoadSrc(const Args& s, const ScanFwdArgs& a, long long row, int d, bool live_)
      : L(a.L), D(a.D), R(FUSE ? a.R : 0), N(s.N), reverse(a.reverse), live(live_) {
    x = static_cast<const T*>(s.x) + row * L * D + d;
    dt = static_cast<const T*>(s.dt) + row * L * (FUSE ? R : D) + (FUSE ? 0 : d);
    B = static_cast<const T*>(s.B) + row * L * N;
    C = static_cast<const T*>(s.C) + row * L * N;
  }
  __device__ T row(long long t, int j) const {
    if (j < R) return dt[t * R + j];
    j -= R;
    return j < N ? B[t * N + j] : C[t * N + j - N];
  }
  __device__ void prefetch(int p0) {
#pragma unroll
    for (int k = 0; k < kFwdT; ++k) {
      const int p = p0 + k;
      const long long t = reverse ? L - 1 - p : p;
      const bool ok = live && p < L;
      xr[k] = ok ? x[t * D] : from_f<T>(0.f);
      if (!FUSE) dr[k] = ok ? dt[t * D] : from_f<T>(0.f);
    }
  }
  __device__ void x_chunk(int, float (&xv)[kFwdT]) const {
#pragma unroll
    for (int k = 0; k < kFwdT; ++k) xv[k] = to_f(xr[k]);
  }
  __device__ void dt_chunk(int, float (&dv)[kFwdT]) const {
#pragma unroll
    for (int k = 0; k < kFwdT; ++k) dv[k] = to_f(dr[k]);
  }
};

template <typename T, bool COMB>
cudaError_t launch_k1(const ScanFwdArgs& a, const ScanLoadArgs& s, int rows, cudaStream_t st) {
  if (a.R > 0) return launch_scan_fwd<T, ScanLoadSrc<T, true, COMB>>(a, s, s.N, rows, st);
  return launch_scan_fwd<T, ScanLoadSrc<T, false, COMB>>(a, s, s.N, rows, st);
}

template <bool COMB>
int run_k1(const void* x, const void* dt, const void* B, const void* C, const float* A,
           const float* Dskip, const float* dt_bias, const float* wdt, void* y, float* hb,
           const float* h0, float* hfin, const void* yprev, const void* z, int rows, int L,
           int D, int N, int R, int reverse, int bf16, int hbc, void* stream) {
  ScanFwdArgs a;
  a.y = y; a.A = A; a.Dskip = Dskip; a.dt_bias = dt_bias; a.wdt = wdt;
  a.hb = hb; a.h0 = h0; a.hfin = hfin; a.yprev = yprev; a.z = z;
  a.L = L; a.D = D; a.R = R; a.reverse = reverse; a.hbc = hbc > 0 ? hbc : 1;
  const ScanLoadArgs s{x, dt, B, C, N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_k1<__nv_bfloat16, COMB>(a, s, rows, st);
  return launch_k1<float, COMB>(a, s, rows, st);
}

}  // namespace pc

// R > 0: dt is dt_lr [rows, L, R] projected by wdt [R, D]; R == 0: dt is
// [rows, L, D]. h0 and hfin are optional (null).
#ifndef PC_SCAN_COMBINE
// hb (hbc >= 1) is optional (null).
extern "C" int pc_scan_fwd(const void* x, const void* dt, const void* B, const void* C,
                           const float* A, const float* Dskip, const float* dt_bias,
                           const float* wdt, void* y, float* hb, const float* h0, float* hfin,
                           int rows, int L, int D, int N, int R, int reverse, int bf16, int hbc,
                           void* stream) {
  return pc::run_k1<false>(x, dt, B, C, A, Dskip, dt_bias, wdt, y, hb, h0, hfin, nullptr,
                           nullptr, rows, L, D, N, R, reverse, bf16, hbc, stream);
}
#else
// The combine epilogue: yprev and z [rows, L, D] in x's dtype.
extern "C" int pc_scan_fwd_combine(const void* x, const void* dt, const void* B, const void* C,
                                   const float* A, const float* Dskip, const float* dt_bias,
                                   const float* wdt, void* y, const float* h0, float* hfin,
                                   const void* yprev, const void* z, int rows, int L, int D,
                                   int N, int R, int reverse, int bf16, void* stream) {
  return pc::run_k1<true>(x, dt, B, C, A, Dskip, dt_bias, wdt, y, nullptr, h0, hfin, yprev, z,
                          rows, L, D, N, R, reverse, bf16, 0, stream);
}
#endif
