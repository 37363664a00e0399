// K3 — selective-scan backward (the adjoint of one scan direction).
//
// Replaces plantcaduceus_tpu/ops/pallas_scan.py::_bwd_kernel (launched at
// pallas_scan.py:564 through _pallas_bwd_group), the backward of K1
// (_scan_op_bwd) and of K2 (pallas_mixer._bimamba_mixer_bwd). Both dt modes
// and `reverse`; the g0 / dh0 options (sequence parallelism) are not ported.
//
// Math (ops/scan_bwd.py), per row, channel d, state n, with dt' =
// softplus(dt + bias), a = exp2(dt'*log2e*A), h the forward states:
//   g[t]  = C[t]*gy[t] + a[t+1]*g[t+1]            (cotangent of h[t])
//   dx    = (sum_n g*B)*dt' + gy*Dskip
//   ddt   = (sum_n g*h[t-1]*a*A + (sum_n g*B)*x) * sigmoid(dt + bias)
//   dB    = sum_d g*dt'*x            dC    = sum_d gy*h
//   dA    = sum_t g*h[t-1]*a*dt'     dD    = sum_t gy*x     dbias = sum_t ddt
//   fused dt: ddt_lr = ddt @ W_dt^T (sum over d), dW_dt = dt_lr^T @ ddt.
//
// Design. The TPU kernel runs its grid in order and carries the cotangent
// and the dB/dC/dW sums across grid steps in VMEM; GPU blocks run in no
// order, so:
//  * A block owns (row, tile of kScanThreads channels), as K1; each thread
//    owns one channel and keeps its N fp32 cotangents in registers.
//  * It walks the hb chunks (hbc steps each) in reverse processing order:
//    L-1 -> 0 for a forward-direction scan, 0 -> L-1 for `reverse`, with no
//    flipped copies. Per chunk it reloads the entry state from hb, recomputes
//    the states forward (the forward's own arithmetic, so they are the
//    forward's states bit for bit) keeping the entry state of every S-step
//    sub-chunk in shared memory, then for each sub-chunk from the last:
//    recomputes its S states into registers and runs the adjoint backwards
//    over them. States never reach device memory as [rows, L, D, N].
//  * Cross-channel sums (dB, dC per step; ddt_lr) are reduced inside the
//    block: dB|dC by a warp reduce-scatter (shuffles) and a fixed-order sum
//    over the warps in shared memory, ddt_lr as a product over the block's
//    channels in shared memory. Each block writes them as per-tile partials.
//  * Whole-run sums (dA, dbias, dD, dW) stay in registers or the thread's own
//    shared-memory column and are written as per-row partials.
//  * sum_slabs_kernel then adds the partials in a fixed order. No atomics
//    anywhere: the result is the same run to run.
//
// What bounds it on an H100: the exp2 per state and step (rows*L*D*N = 4.0e8
// at the l20 training shape, 64 rows x 512 x 768 x 16: 0.1 ms on the
// special-function units at 16 per clock per SM) and ~a dozen fp32 flops per
// state (~0.08 ms at 67 TFLOP/s), against a few hundred MB of bytes (x, gy,
// hb, dx; ~0.1 ms). This design spends about 3 exp2 per state (chunk pass,
// sub-chunk recompute, adjoint) and a warp reduce-scatter per step, so it
// sits well above that bound; making it fast is later work.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (partials and outputs come from the wrapper) and returns
// cudaGetLastError().

#include <algorithm>

#include "scan_core.cuh"

namespace pc {

constexpr int kBwdWarps = kScanThreads / 32;
constexpr int kRowPad = kScanThreads + 1;  // shared rows of one value per channel, padded
constexpr int kMaxHbChunk = 64;

// Steps per sub-chunk whose states one thread holds in registers (S*N <= 64
// floats, or 128 for N = 32).
template <int N> __host__ __device__ constexpr int sub_steps() { return N <= 8 ? 64 / N : 4; }

// Sums v[0..V) over the 32 lanes of the warp. Afterwards lane l holds in
// v[0..VL) the totals of values [l*VL, (l+1)*VL) when V >= 32 (VL = V/32), or
// of value l / (32/V) when V < 32 (VL = 1). Each level sends half the values
// still held, so V >= 32 costs V - V/32 shuffles instead of 5V.
template <int V>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[V], int lane) {
#pragma unroll
  for (int lvl = 0; lvl < 5; ++lvl) {
    const int m = 16 >> lvl;
    const int h = V >> (lvl + 1);
    if (h >= 1) {
      const bool upper = lane & m;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = upper ? v[i] : v[i + h];
        const float keep = upper ? v[i + h] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
    }
  }
}

struct BwdArgs {
  const void* x;       // [rows, L, D]  (Tx)
  const void* gy;      // [rows, L, D]  (Tx)
  const void* dt;      // dt [rows, L, D] or dt_lr (R columns) when FUSE  (Tb)
  const void* B;       // B[t, n] at B + row*bc_row + t*bc_step + n  (Tb)
  const void* C;
  const float* A;      // [D, N]
  const float* Dskip;  // [D]
  const float* dt_bias;  // [D]
  const float* wdt;    // [R, D] when FUSE
  const float* hb;     // [rows, ceil(L/hbc), D, N]
  float* dx;           // [rows, L, D]
  float* ddt;          // [rows, L, D] when not FUSE
  float* part_pos;     // [ntiles, rows, L, J], J = R + 2N: ddt_lr | dB | dC per tile
  float* part_run;     // [rows, P], P = D*N + 2D + R*D: dA | dbias | dD | dW per row
  int L, D, R, reverse, hbc;
  long long dt_row, dt_step, bc_row, bc_step;  // element strides
};

template <int N>
inline size_t bwd_smem_bytes(int T, int R) {
  constexpr int S = sub_steps<N>();
  return sizeof(float) * (2 * T * N + (T / S) * N * kScanThreads + kBwdWarps * T * 2 * N +
                          T * R + 2 * R * kRowPad + (R ? T * kRowPad : 0));
}

template <typename Tx, typename Tb, int N, bool FUSE>
__global__ void __launch_bounds__(kScanThreads) scan_bwd_kernel(BwdArgs a) {
  constexpr int S = sub_steps<N>();
  constexpr int V = 2 * N;                  // per-step cross-channel sums: dB | dC
  constexpr int VL = V >= 32 ? V / 32 : 1;  // of which one lane holds VL
  extern __shared__ float smem[];
  const int T = a.hbc;
  const int R = FUSE ? a.R : 0;
  float* sB = smem;                                  // [T][N]
  float* sC = sB + T * N;                            // [T][N]
  float* sE = sC + T * N;                            // [T/S][N][kScanThreads]
  float* spart = sE + (T / S) * N * kScanThreads;    // [kBwdWarps][T][V]
  float* sdt = spart + kBwdWarps * T * V;            // [T][R]
  float* sW = sdt + T * R;                           // [R][kRowPad]
  float* sdW = sW + R * kRowPad;                     // [R][kRowPad]
  float* sddt = sdW + R * kRowPad;                   // [T][kRowPad]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.y;
  const int d0 = blockIdx.x * kScanThreads;
  const int d = d0 + tid;
  const bool live = d < a.D;
  const long long xrow = row * (long long)a.L * a.D;
  const Tx* x = static_cast<const Tx*>(a.x) + xrow;
  const Tx* gy = static_cast<const Tx*>(a.gy) + xrow;
  const Tb* dt = static_cast<const Tb*>(a.dt) + row * a.dt_row;
  const Tb* Bm = static_cast<const Tb*>(a.B) + row * a.bc_row;
  const Tb* Cm = static_cast<const Tb*>(a.C) + row * a.bc_row;
  const int J = R + V;
  const int nhb = (a.L + T - 1) / T;
  const float* hb = a.hb + row * (long long)nhb * a.D * N;
  float* ppos = a.part_pos + ((long long)blockIdx.x * gridDim.y + row) * a.L * J;
  auto time_of = [&](int p) -> long long { return a.reverse ? a.L - 1 - p : p; };

  if constexpr (FUSE) {
    for (int i = tid; i < R * kScanThreads; i += kScanThreads) {
      const int r = i / kScanThreads, c = i % kScanThreads;
      sW[r * kRowPad + c] = d0 + c < a.D ? a.wdt[(long long)r * a.D + d0 + c] : 0.f;
      sdW[r * kRowPad + c] = 0.f;
    }
  }
  float A[N], g[N], dA[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = live ? a.A[(long long)d * N + n] : 0.f;
    g[n] = 0.f;
    dA[n] = 0.f;
  }
  const float bias = live ? a.dt_bias[d] : 0.f;
  const float dsk = live ? a.Dskip[d] : 0.f;
  float dbias = 0.f, dD = 0.f;

  for (int c = nhb - 1; c >= 0; --c) {
    const int p0 = c * T;
    const int tn = min(T, a.L - p0);
    __syncthreads();  // every reader of the previous chunk's shared data is done
    for (int i = tid; i < tn * N; i += kScanThreads) {
      const long long off = time_of(p0 + i / N) * a.bc_step + i % N;
      sB[i] = to_f(Bm[off]);
      sC[i] = to_f(Cm[off]);
    }
    if constexpr (FUSE) {
      for (int i = tid; i < tn * R; i += kScanThreads)
        sdt[i] = to_f(dt[time_of(p0 + i / R) * a.dt_step + i % R]);
    }
    __syncthreads();

    // Inputs of processing step p0 + i for this channel (dead lanes: zeros).
    auto step_in = [&](int i, float& xv, float& pre) {
      const long long t = time_of(p0 + i);
      xv = live ? to_f(x[t * a.D + d]) : 0.f;
      const float dtv = FUSE ? fused_dt(sdt + i * R, sW, R, kRowPad, tid)
                             : (live ? to_f(dt[t * a.dt_step + d]) : 0.f);
      pre = dtv + bias;
    };

    // Pass 1: the entry state of every sub-chunk, from the chunk's entry state.
    float h[N];
    if (live) {
      load_state<N>(h, hb + ((long long)c * a.D + d) * N);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = 0.f;
    }
    const int nsub = (tn + S - 1) / S;
    for (int j = 0; j < nsub; ++j) {
#pragma unroll
      for (int n = 0; n < N; ++n) sE[(j * N + n) * kScanThreads + tid] = h[n];
      if (j + 1 < nsub) {  // sub-chunk j is full
#pragma unroll
        for (int k = 0; k < S; ++k) {
          float xv, pre;
          step_in(j * S + k, xv, pre);
          scan_step<N, false>(h, A, sB + (j * S + k) * N, nullptr, softplus(pre), xv);
        }
      }
    }

    // Pass 2: sub-chunks from the last; recompute S states, then the adjoint.
    for (int j = nsub - 1; j >= 0; --j) {
      float hs[S][N], kx[S] = {}, kpre[S] = {};
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = sE[(j * N + n) * kScanThreads + tid];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int i = j * S + k;
        if (i < tn) {
          step_in(i, kx[k], kpre[k]);
          scan_step<N, false>(h, A, sB + i * N, nullptr, softplus(kpre[k]), kx[k]);
        }
#pragma unroll
        for (int n = 0; n < N; ++n) hs[k][n] = h[n];
      }
#pragma unroll
      for (int k = S - 1; k >= 0; --k) {
        const int i = j * S + k;
        if (i >= tn) continue;  // the same for every thread of the block
        const long long t = time_of(p0 + i);
        const float gyv = live ? to_f(gy[t * a.D + d]) : 0.f;
        const float xv = kx[k];
        const float dtp = softplus(kpre[k]);
        const float dtl = dtp * kLog2e;
        const float dtx = dtp * xv;
        float red[V];
        float gB = 0.f, dda = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float hp = k > 0 ? hs[k - 1][n] : sE[(j * N + n) * kScanThreads + tid];
          const float gn = fmaf(sC[i * N + n], gyv, g[n]);
          gB = fmaf(sB[i * N + n], gn, gB);
          red[n] = gn * dtx;
          red[N + n] = gyv * hs[k][n];
          const float gnext = exp2f(dtl * A[n]) * gn;
          const float das = gnext * hp;
          dA[n] = fmaf(das, dtp, dA[n]);
          dda = fmaf(das, A[n], dda);
          g[n] = gnext;
        }
        const float ddt = fmaf(gB, xv, dda) / (1.f + expf(-kpre[k]));
        if (live) {
          a.dx[xrow + t * a.D + d] = fmaf(gB, dtp, gyv * dsk);
          if (!FUSE) a.ddt[xrow + t * a.D + d] = ddt;
        }
        if constexpr (FUSE) sddt[i * kRowPad + tid] = ddt;  // dead lanes hold 0
        dbias += ddt;
        dD = fmaf(gyv, xv, dD);
        warp_reduce_scatter<V>(red, lane);
        if constexpr (V >= 32) {
#pragma unroll
          for (int q = 0; q < VL; ++q) spart[(warp * T + i) * V + lane * VL + q] = red[q];
        } else {
          if (lane % (32 / V) == 0) spart[(warp * T + i) * V + lane / (32 / V)] = red[0];
        }
      }
    }
    __syncthreads();

    // Chunk epilogue: this tile's partial ddt_lr | dB | dC per step, summed
    // over the block's channels in a fixed order.
    for (int o = tid; o < tn * J; o += kScanThreads) {
      const int i = o / J, q = o % J;
      float s = 0.f;
      if (q < R) {
        for (int ch = 0; ch < kScanThreads; ++ch)
          s = fmaf(sddt[i * kRowPad + ch], sW[q * kRowPad + ch], s);
      } else {
        for (int w = 0; w < kBwdWarps; ++w) s += spart[(w * T + i) * V + q - R];
      }
      ppos[time_of(p0 + i) * J + q] = s;
    }
    if constexpr (FUSE) {  // dW[:, d] += dt_lr^T ddt over the chunk (own column only)
      for (int r = 0; r < R; ++r) {
        float s = sdW[r * kRowPad + tid];
        for (int i = 0; i < tn; ++i) s = fmaf(sdt[i * R + r], sddt[i * kRowPad + tid], s);
        sdW[r * kRowPad + tid] = s;
      }
    }
  }

  if (live) {  // this row's whole-run partials
    const long long P = (long long)a.D * N + 2 * a.D + (long long)R * a.D;
    float* pr = a.part_run + row * P;
#pragma unroll
    for (int n = 0; n < N; ++n) pr[(long long)d * N + n] = dA[n];
    pr[(long long)a.D * N + d] = dbias;
    pr[(long long)a.D * N + a.D + d] = dD;
    for (int r = 0; r < R; ++r)
      pr[(long long)a.D * (N + 2) + (long long)r * a.D + d] = sdW[r * kRowPad + tid];
  }
}

// out[i] = sum_k part[k*M + i], k in order: the deterministic second pass.
__global__ void sum_slabs_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int K, long long M) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < M;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += part[k * M + i];
    out[i] = s;
  }
}

inline cudaError_t sum_slabs(const float* part, float* out, int K, long long M,
                             cudaStream_t s) {
  const long long blocks = std::min<long long>((M + 255) / 256, 132 * 16);
  sum_slabs_kernel<<<(int)blocks, 256, 0, s>>>(part, out, K, M);
  return cudaGetLastError();
}

template <typename Tx, typename Tb, int N, bool FUSE>
cudaError_t launch_bwd_t(const BwdArgs& a, int rows, cudaStream_t stream) {
  if (a.hbc % sub_steps<N>() || a.hbc > kMaxHbChunk) return cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes<N>(a.hbc, FUSE ? a.R : 0);
  auto kern = scan_bwd_kernel<Tx, Tb, N, FUSE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((a.D + kScanThreads - 1) / kScanThreads, rows);
  kern<<<grid, kScanThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename Tx, typename Tb, bool FUSE>
cudaError_t launch_bwd(const BwdArgs& a, int N, int rows, cudaStream_t stream) {
  switch (N) {
    case 4: return launch_bwd_t<Tx, Tb, 4, FUSE>(a, rows, stream);
    case 8: return launch_bwd_t<Tx, Tb, 8, FUSE>(a, rows, stream);
    case 16: return launch_bwd_t<Tx, Tb, 16, FUSE>(a, rows, stream);
    case 32: return launch_bwd_t<Tx, Tb, 32, FUSE>(a, rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Tx, typename Tb>
cudaError_t launch_bwd_types(const BwdArgs& a, int N, int rows, bool fuse, cudaStream_t s) {
  return fuse ? launch_bwd<Tx, Tb, true>(a, N, rows, s) : launch_bwd<Tx, Tb, false>(a, N, rows, s);
}

}  // namespace pc

// x_bf16 / bc_bf16: the dtype of x, gy and of dt, B, C (bf16 or fp32). The
// combination x fp32 with dt/B/C bf16 is refused. out_pos [rows, L, J] and
// out_run [P] receive the summed partials.
extern "C" int pc_scan_bwd(const void* x, const void* gy, const void* dt, const void* B,
                           const void* C, const float* A, const float* Dskip,
                           const float* dt_bias, const float* wdt, const float* hb,
                           float* dx, float* ddt, float* part_pos, float* part_run,
                           float* out_pos, float* out_run, int rows, int L, int D, int N,
                           int R, int fuse, int reverse, int hbc, long long dt_row,
                           long long dt_step, long long bc_row, long long bc_step,
                           int x_bf16, int bc_bf16, void* stream) {
  pc::BwdArgs a;
  a.x = x; a.gy = gy; a.dt = dt; a.B = B; a.C = C;
  a.A = A; a.Dskip = Dskip; a.dt_bias = dt_bias; a.wdt = wdt; a.hb = hb;
  a.dx = dx; a.ddt = ddt; a.part_pos = part_pos; a.part_run = part_run;
  a.L = L; a.D = D; a.R = fuse ? R : 0; a.reverse = reverse; a.hbc = hbc;
  a.dt_row = dt_row; a.dt_step = dt_step; a.bc_row = bc_row; a.bc_step = bc_step;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t e;
  if (x_bf16 && bc_bf16) e = pc::launch_bwd_types<bf, bf>(a, N, rows, fuse, s);
  else if (x_bf16) e = pc::launch_bwd_types<bf, float>(a, N, rows, fuse, s);
  else if (!bc_bf16) e = pc::launch_bwd_types<float, float>(a, N, rows, fuse, s);
  else e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  const int J = a.R + 2 * N;
  const int ntiles = (D + pc::kScanThreads - 1) / pc::kScanThreads;
  e = pc::sum_slabs(part_pos, out_pos, ntiles, (long long)rows * L * J, s);
  if (e != cudaSuccess) return e;
  return pc::sum_slabs(part_run, out_run, rows,
                       (long long)D * N + 2LL * D + (long long)a.R * D, s);
}
