// K1 — selective-scan forward, one direction.
//
// Replaces plantcaduceus_tpu/ops/pallas_scan.py::_fwd_kernel (launched at
// pallas_scan.py:293 through _pallas_scan_group / selective_scan_pallas):
// the `reverse` flag, both dt modes (dt given per channel, or dt_lr
// projected up by W_dt inside the kernel) and, for training, the emit_hb
// option (`hb` non-null: chunk-entry states every `hbc` steps, as
// pallas_scan.py:120-122, 286-288). The h0/hfin and combine options of the
// TPU kernel are not ported yet.
//
// What bounds it on an H100: one exp2 per (row, step, channel, state) on
// the special-function units (rows*L*D*N of them: 1.6e9 at the l20 shape
// 256x512x768x16, about 0.4 ms at 16 per clock per SM), against ~0.13 ms to
// read x and write y in bf16. So it is bound by operations, not bytes.
// The design keeps the states in registers and the shared B/C/dt_lr rows in
// shared memory, so device memory sees each input once and each output once;
// nothing of size [rows, L, D, N] is ever stored (hb holds one state in
// every hbc steps: 1/16 of that with the port's chunk).
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include "scan_core.cuh"

extern "C" int pc_scan_fwd(const void* x, const void* dt, const void* B, const void* C,
                           const float* A, const float* Dskip, const float* dt_bias,
                           const float* wdt, void* y, float* hb, int rows, int L, int D,
                           int N, int R, int fuse, int reverse, int bf16, int hbc,
                           void* stream) {
  pc::ScanArgs a;
  a.x = x; a.dt = dt; a.B = B; a.C = C;
  a.A = A; a.Dskip = Dskip; a.dt_bias = dt_bias; a.wdt = wdt; a.y = y;
  a.hb = hb; a.hbc = hbc > 0 ? hbc : 1;
  a.L = L; a.D = D; a.R = fuse ? R : 0; a.reverse = reverse;
  a.dt_step = fuse ? R : D;
  a.dt_row = (long long)L * a.dt_step;
  a.bc_step = N;
  a.bc_row = (long long)L * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (bf16)
    return fuse ? pc::launch_scan<bf, bf, bf, true>(a, N, rows, s)
                : pc::launch_scan<bf, bf, bf, false>(a, N, rows, s);
  return fuse ? pc::launch_scan<float, float, float, true>(a, N, rows, s)
              : pc::launch_scan<float, float, float, false>(a, N, rows, s);
}
