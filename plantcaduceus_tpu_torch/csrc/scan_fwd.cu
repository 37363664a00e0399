// K1 — selective-scan forward, one direction.
//
// Replaces plantcaduceus_tpu/ops/pallas_scan.py::_fwd_kernel (launched at
// pallas_scan.py:293 through _pallas_scan_group / selective_scan_pallas):
// the `reverse` flag, both dt modes (dt given per channel, or dt_lr
// projected up by W_dt inside the kernel), the carry options h0 and
// emit_hfin (pallas_scan.py:93-95, 179) and, for training, emit_hb
// (chunk-entry states every `hbc` steps, pallas_scan.py:120-122, 286-288).
// The TPU kernel's `combine` epilogue is not ported.
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
template <typename T, bool FUSE>
struct ScanLoadSrc {
  using Args = ScanLoadArgs;
  using Raw = T;
  static constexpr bool kFuse = FUSE;
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

template <typename T>
cudaError_t launch_k1(const ScanFwdArgs& a, const ScanLoadArgs& s, int rows, cudaStream_t st) {
  if (a.R > 0) return launch_scan_fwd<T, ScanLoadSrc<T, true>>(a, s, s.N, rows, st);
  return launch_scan_fwd<T, ScanLoadSrc<T, false>>(a, s, s.N, rows, st);
}

}  // namespace pc

// R > 0: dt is dt_lr [rows, L, R] projected by wdt [R, D]; R == 0: dt is
// [rows, L, D]. hb (hbc >= 1), h0 and hfin are optional (null).
extern "C" int pc_scan_fwd(const void* x, const void* dt, const void* B, const void* C,
                           const float* A, const float* Dskip, const float* dt_bias,
                           const float* wdt, void* y, float* hb, const float* h0, float* hfin,
                           int rows, int L, int D, int N, int R, int reverse, int bf16, int hbc,
                           void* stream) {
  pc::ScanFwdArgs a;
  a.y = y; a.A = A; a.Dskip = Dskip; a.dt_bias = dt_bias; a.wdt = wdt;
  a.hb = hb; a.h0 = h0; a.hfin = hfin;
  a.L = L; a.D = D; a.R = R; a.reverse = reverse; a.hbc = hbc > 0 ? hbc : 1;
  const pc::ScanLoadArgs s{x, dt, B, C, N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return pc::launch_k1<__nv_bfloat16>(a, s, rows, st);
  return pc::launch_k1<float>(a, s, rows, st);
}
