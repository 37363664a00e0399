// Selective-scan forward: the device routine of K1 (scan_fwd.cu) and of the
// scan half of K2 (mixer_fwd.cu), one kernel template over an input policy.
//
// Math (per row, channel d, state n), the same as
// plantcaduceus_tpu/ops/pallas_scan.py::_fwd_kernel:
//   dt'  = softplus(dt + dt_bias)     dt = dt_lr . W_dt[:, d] when fused
//   h_n  = exp2(dt' * log2e * A[d,n]) * h_n + B[t,n] * dt' * x[t,d]
//   y    = sum_n C[t,n] * h_n + Dskip[d] * x[t,d]
//
// Layout (that of the mamba_ssm forward, not the TPU kernel's block walk):
// a block owns (row, kFwdThreads channels); each thread owns one channel,
// keeps its N float32 states in registers and walks time in processing
// order (L-1 down to 0 for `reverse`, no flipped copy of any tensor) in
// chunks of kFwdT steps. Per chunk it first forms the chunk's per-step
// inputs in registers, with no dependence between steps: x (the policy's:
// K1 loads it, prefetched a chunk ahead; K2 convolves it from xi's taps),
// dt (the policy's, or dt_lr . W_dt[:, d] as an outer product over r: the
// chunk's dt_lr rows staged transposed, one 16-byte shared load serving
// four steps, the block's W_dt columns in shared memory), dt' and its two
// products; then it runs the recurrence over the chunk's steps. The B, C
// (and dt_lr) rows of a chunk are shared by every channel: the block stages
// them in shared memory, read back as float4, and loads the next chunk's
// rows into registers while this one computes (two buffers, one barrier a
// chunk).
//
// Every sum runs in one fixed order, the recurrence and readout
// h = fmaf(exp2f(dtl * A), h, B * dtx), acc = fmaf(C, h, acc) over n in
// order, the dt projection over r in order from 0, so K3 (scan_bwd.cu)
// recomputes the same states from hb, and K1 and K2 give the bits of their
// earlier single-purpose kernels. exp2f is MUFU.EX2 with a fix-up around it
// for arguments below -126 (halve, MUFU.EX2, square: three more
// instructions, issued for every state and step). A chunk whose smallest
// argument, dtl_max * A_min, is not below -126 in every lane of the warp
// takes MUFU.EX2 alone (ex2.approx.ftz.f32), which gives the same bits
// there; a warp with any steeper lane runs that chunk through exp2f as it
// is, so no warp issues both recurrences. (With the initialiser's weights
// no chunk is that steep: a state that decays more than 2^-126 in one step
// is forgotten. How often trained weights give such chunks is not measured.)
//
// Options (null pointers when unused): hb, the training variant's
// chunk-entry states, stored before processing step p (counted in
// processing order) when p % hbc == 0 to hb[row][p / hbc][d][:] (the
// layout of pallas_scan.py's emit_hb, which K3 recomputes from); h0
// [rows, D, N] seeds the states before the first processed step, and hfin
// [rows, D, N] receives them after the last (pallas_scan.py:93-95, 179);
// combine (yprev and z, [rows, L, D] in the input dtype; K1's only,
// pallas_scan.py:78, 82-83, 213-221), the bidirectional epilogue
// y = (y + yprev) * z * sigmoid(z), all in float32 (y with its D-skip, the
// sigmoid of the raw gate z), stored in the input dtype. A chunk's yprev
// and z are loaded before its recurrence runs, so their latency hides
// under it.
//
// What bounds it on an H100: one exp2 per (row, step, channel, state) on
// the special-function units (1.6e9 at the l20 scoring shape 256 x 512 x
// 768 x 16: ~0.4 ms at 16 a clock per SM), against ~0.13 ms of bytes in
// bf16. The recurrence issues about six instructions per state and step
// (the exponent's product, MUFU.EX2, B * dt' x, two FMAs, a 16-byte shared
// load per four B and four C values) plus the per-step work spread over
// the N states (softplus, the dt projection, x, y), so issue and latency
// set its pace next to the exp2 rate.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kFwdThreads = 128;  // channels per block, one a thread
constexpr int kFwdT = 8;          // steps per chunk, their scalars in registers
// Blocks an SM (__launch_bounds__): the inference variant at most 128
// registers a thread; the training variant (hb), whose grid at the l20
// training shape fills three blocks an SM anyway, at most 168.
constexpr int kFwdMinBlocks = 4;
constexpr int kFwdMinBlocksHb = 3;

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

// N float32 states to or from memory (N % 4 == 0; 16-byte aligned).
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

// MUFU.EX2 alone: exp2f's bits for arguments >= -126.
__device__ __forceinline__ float ex2_ftz(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

struct ScanFwdArgs {
  void* y;               // [rows, L, D] in the input dtype
  const float* A;        // [D, N]
  const float* Dskip;    // [D]
  const float* dt_bias;  // [D]
  const float* wdt;      // [R, D] when dt is fused
  float* hb;             // [rows, ceil(L/hbc), D, N] chunk-entry states, or null
  const float* h0;       // [rows, D, N] initial states, or null (zeros)
  float* hfin;           // [rows, D, N] final states, or null
  const void* yprev = nullptr;  // [rows, L, D] the other direction's y (combine), or null
  const void* z = nullptr;      // [rows, L, D] the raw gate (combine), or null
  int L, D, R, reverse, hbc;  // R = 0 when dt is given per channel
  int rows = 0;               // set by the launcher
};

// A policy's rows a block (Src::kRows where it has one, else 1).
template <class S, class = void>
struct RowsOf {
  static constexpr int v = 1;
};
template <class S>
struct RowsOf<S, std::void_t<decltype(S::kRows)>> {
  static constexpr int v = S::kRows;
};

// The barrier of a block's row group: the whole block when it holds one
// row, else the group's kFwdThreads threads on named barrier 1 + grp.
template <int RG>
__device__ __forceinline__ void group_sync(int grp) {
  if constexpr (RG == 1) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "n"(kFwdThreads) : "memory");
  }
}

// A chunk's shared rows: B [kFwdT][N], C [kFwdT][N], dt_lr^T [R][kFwdT].
__host__ __device__ inline int fwd_row_floats(int N, int R) { return kFwdT * (2 * N + R); }
// Two buffers of rows and the block's W_dt columns [R][kFwdThreads].
inline size_t fwd_smem_bytes(int N, int R) {
  return sizeof(float) * (2 * fwd_row_floats(N, R) + (size_t)R * kFwdThreads);
}

// The forward scan over one (row, block of channels). Src, the input
// policy, is built per thread as Src(args, a, row, d, live) and gives:
//   kFuse                      dt = dt_lr . W_dt[:, d] (a.R columns) or given;
//   Raw, row(t, j)             element j of step t's shared row (j < R:
//                              dt_lr, then B's N, then C's N) as loaded
//                              (Raw: float or bfloat16); made float only
//                              when it is stored to shared memory, at the
//                              chunk's end (a bfloat16 converted at its load
//                              stalled every chunk on device memory: bf16
//                              K1-hb 13% behind fp32 on the H100, PERF.md);
//   x_chunk(p0, xv)            x of processing steps p0 .. p0+kFwdT-1 (0 past
//                              L), called once a chunk, in order;
//   dt_chunk(p0, dv)           dt of those steps (unfused), likewise;
//   prefetch(p0)               start loading what x_chunk / dt_chunk of the
//                              chunk at p0 (the next one) need;
//   kHb, kCombine              whether the policy runs the training
//                              variant, and whether it runs the combine
//                              epilogue (then only that: a policy's
//                              combine kernel builds in a unit of its own,
//                              PC_SCAN_COMBINE in scan_fwd.cu);
//   kSmemFloats, bind_smem(p)  shared memory the policy uses, after the
//                              kernel's own (16-byte aligned), if any;
//   kRows (optional, default 1) rows a block: kRows groups of kFwdThreads
//                              threads, each its own row with its own
//                              staged rows and named barrier (id 1 + group)
//                              in place of __syncthreads; the policy then
//                              sizes its shared memory at run time
//                              (smem_bytes(args), bound by bind_smem(p) for
//                              the whole block) and stages what its groups
//                              share in stage_block(), which every thread
//                              calls before one __syncthreads.
// HB: the training variant, COMB: the combine epilogue, each chosen at
// launch, so the inference kernel carries no per-step test for them.
template <typename T, int N, bool HB, bool COMB, class Src>
__global__ void __launch_bounds__(kFwdThreads * RowsOf<Src>::v,
                                  RowsOf<Src>::v > 1 ? 1 : HB ? kFwdMinBlocksHb : kFwdMinBlocks)
    scan_fwd_kernel(ScanFwdArgs a, typename Src::Args sa) {
  // Row values a thread prefetches: all of them (16N) when dt is given; with
  // fused dt those of 2N + R <= 64 (N <= 16) or <= 128 columns, the rest
  // loaded as they are stored.
  constexpr int TC = kFwdT;
  constexpr int NR = !Src::kFuse ? (N >= 8 ? N / 8 : 1) : N <= 16 ? 4 : 8;
  constexpr int RG = RowsOf<Src>::v;
  extern __shared__ float4 fwd_smem4[];
  const int L = a.L, D = a.D, R = Src::kFuse ? a.R : 0;
  const int RW = fwd_row_floats(N, R);
  const int grp = RG > 1 ? threadIdx.x / kFwdThreads : 0;
  float* sbuf = reinterpret_cast<float*>(fwd_smem4) + grp * 2 * RW;  // [2][RW] a row
  float* sW = reinterpret_cast<float*>(fwd_smem4) + RG * 2 * RW;     // [R][kFwdThreads]
  const int tid = RG > 1 ? threadIdx.x % kFwdThreads : threadIdx.x;
  const long long row = RG > 1 ? (long long)blockIdx.y * RG + grp : blockIdx.y;
  const int d0 = blockIdx.x * kFwdThreads, d = d0 + tid;
  const bool live = d < D;
  Src src(sa, a, row, d, live);
  if constexpr (Src::kSmemFloats > 0 || RG > 1) src.bind_smem(sW + R * kFwdThreads);
  T* y = static_cast<T*>(a.y) + row * (long long)L * D;
  const T* yprev = COMB ? static_cast<const T*>(a.yprev) + row * (long long)L * D + d : nullptr;
  const T* zg = COMB ? static_cast<const T*>(a.z) + row * (long long)L * D + d : nullptr;
  auto time_of = [&](int p) { return a.reverse ? L - 1 - p : p; };
  for (int i = threadIdx.x; i < R * kFwdThreads; i += RG * kFwdThreads) {
    const int c = d0 + i % kFwdThreads;
    sW[i] = c < D ? a.wdt[(long long)(i / kFwdThreads) * D + c] : 0.f;
  }
  if constexpr (RG > 1) {
    src.stage_block();
    __syncthreads();  // sW and the policy's shared tiles; groups run apart from here
    if (row >= a.rows) return;
  }
  float A[N], h[N];
  float amin = 0.f;  // min(A[d, :], 0): dtl * amin is the chunk's smallest exponent
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = live ? a.A[(long long)d * N + n] : 0.f;
    amin = fminf(amin, A[n]);
    h[n] = 0.f;
  }
  if (a.h0 && live) load_state<N>(h, a.h0 + (row * D + d) * N);
  const float bias = live ? a.dt_bias[d] : 0.f;
  const float dsk = live ? a.Dskip[d] : 0.f;
  float* hb = HB ? a.hb + row * (long long)((L + a.hbc - 1) / a.hbc) * D * N : nullptr;

  // Element i of the rows of the chunk at p0 (zero past L).
  using Raw = typename Src::Raw;
  auto elem = [&](int i, int p0) -> Raw {
    int k, col;
    if (i < 2 * TC * N) {
      k = (i % (TC * N)) / N;
      col = R + (i >= TC * N ? N : 0) + i % N;
    } else {
      k = (i - 2 * TC * N) % TC;
      col = (i - 2 * TC * N) / TC;
    }
    const int p = p0 + k;
    return p < L ? src.row(time_of(p), col) : from_f<Raw>(0.f);
  };
  Raw rr[NR];
  auto load_rows = [&](int p0) {
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      const int i = tid + u * kFwdThreads;
      rr[u] = i < RW ? elem(i, p0) : from_f<Raw>(0.f);
    }
  };
  auto store_rows = [&](float* buf, int p0) {
#pragma unroll
    for (int u = 0; u < NR; ++u)
      if (tid + u * kFwdThreads < RW) buf[tid + u * kFwdThreads] = to_f(rr[u]);
    // rows past the prefetch's reach, loaded as they are stored
    for (int i = tid + NR * kFwdThreads; i < RW; i += kFwdThreads) buf[i] = to_f(elem(i, p0));
  };

  load_rows(0);
  store_rows(sbuf, 0);
  src.prefetch(0);
  const int nchunks = (L + TC - 1) / TC;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int p0 = ci * TC;
    const float* sB = sbuf + (ci & 1) * RW;  // [TC][N]
    const float* sC = sB + TC * N;           // [TC][N]
    const float* sdt = sC + TC * N;          // [R][TC]
    group_sync<RG>(grp);  // this chunk's rows are staged; the other buffer is free
    if (ci + 1 < nchunks) load_rows(p0 + TC);
    float xv[TC], dv[TC];
    src.x_chunk(p0, xv);
    if constexpr (Src::kFuse) {
#pragma unroll
      for (int k = 0; k < TC; ++k) dv[k] = 0.f;
#pragma unroll 2
      for (int r = 0; r < R; ++r) {
        const float w = sW[r * kFwdThreads + tid];
#pragma unroll
        for (int k = 0; k < TC; k += 4) {
          const float4 q = *reinterpret_cast<const float4*>(sdt + r * TC + k);
          dv[k] = fmaf(q.x, w, dv[k]);
          dv[k + 1] = fmaf(q.y, w, dv[k + 1]);
          dv[k + 2] = fmaf(q.z, w, dv[k + 2]);
          dv[k + 3] = fmaf(q.w, w, dv[k + 3]);
        }
      }
    } else {
      src.dt_chunk(p0, dv);
    }
    if (ci + 1 < nchunks) src.prefetch(p0 + TC);
    // dt' of every step of the chunk (in dv's registers), then the
    // recurrence. dtl = dt' log2e is monotone in dt', so the chunk's largest
    // is that of its largest dt'.
    float dtmax = 0.f;
#pragma unroll
    for (int k = 0; k < TC; ++k) {
      dv[k] = p0 + k < L ? softplus(dv[k] + bias) : 0.f;
      dtmax = fmaxf(dtmax, dv[k]);
    }
    float yp[COMB ? TC : 1], zz[COMB ? TC : 1];  // combine: the chunk's yprev and z
    if constexpr (COMB) {
#pragma unroll
      for (int k = 0; k < TC; ++k) {
        const bool ok = live && p0 + k < L;
        const long long t = time_of(p0 + k);
        yp[k] = ok ? to_f(yprev[t * D]) : 0.f;
        zz[k] = ok ? to_f(zg[t * D]) : 0.f;
      }
    }
    int kh = 0;  // the chunk's first step that stores hb
    if constexpr (HB) {
      kh = p0 % a.hbc;
      kh = kh ? a.hbc - kh : 0;
    }
    auto run = [&](auto fast) {
#pragma unroll
      for (int k = 0; k < TC; ++k) {
        const int p = p0 + k;
        if constexpr (HB) {
          if (k == kh) {
            if (p < L && live) store_state<N>(hb + ((long long)(p / a.hbc) * D + d) * N, h);
            kh += a.hbc;
          }
        }
        const float dtl = dv[k] * kLog2e, dtx = dv[k] * xv[k];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; n += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(sB + k * N + n);
          const float4 c4 = *reinterpret_cast<const float4*>(sC + k * N + n);
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w}, cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float arg = dtl * A[n + e];
            const float dec = decltype(fast)::value ? ex2_ftz(arg) : exp2f(arg);
            h[n + e] = fmaf(dec, h[n + e], bv[e] * dtx);
            acc = fmaf(cv[e], h[n + e], acc);
          }
        }
        if (live && p < L) {
          float yv = fmaf(xv[k], dsk, acc);
          if constexpr (COMB) yv = (yv + yp[k]) * (zz[k] * (1.f / (1.f + expf(-zz[k]))));
          y[(long long)time_of(p) * D + d] = from_f<T>(yv);
        }
      }
    };
    // One path for the whole warp (every thread of the block reaches here).
    if (__all_sync(0xffffffffu, dtmax * kLog2e * amin >= -126.f))
      run(std::true_type{});
    else
      run(std::false_type{});
    if (ci + 1 < nchunks) store_rows(sbuf + ((ci + 1) & 1) * RW, p0 + TC);
  }
  if (a.hfin && live) store_state<N>(a.hfin + (row * D + d) * N, h);
}

template <typename T, int N, class Src>
cudaError_t launch_scan_fwd_n(const ScanFwdArgs& a0, const typename Src::Args& sa, int rows,
                              cudaStream_t s) {
  constexpr int RG = RowsOf<Src>::v;
  ScanFwdArgs a = a0;
  a.rows = rows;
  size_t smem =
      fwd_smem_bytes(N, Src::kFuse ? a.R : 0) + sizeof(float) * (size_t)Src::kSmemFloats;
  if constexpr (RG > 1)
    smem += sizeof(float) * (RG - 1) * 2 * fwd_row_floats(N, Src::kFuse ? a.R : 0) +
            Src::smem_bytes(sa);
  // a combine policy takes yprev and z and never hb; the others neither
  if ((a.yprev != nullptr) != Src::kCombine || (a.z != nullptr) != Src::kCombine ||
      (a.hb && !Src::kHb))
    return cudaErrorInvalidValue;
  auto kern = scan_fwd_kernel<T, N, false, Src::kCombine, Src>;
  if constexpr (Src::kHb) {
    if (a.hb) kern = scan_fwd_kernel<T, N, true, false, Src>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((a.D + kFwdThreads - 1) / kFwdThreads, (rows + RG - 1) / RG), kFwdThreads * RG,
         smem, s>>>(a, sa);
  return cudaGetLastError();
}

// The wrappers admit N in {4, 8, 16, 32} only.
template <typename T, class Src>
cudaError_t launch_scan_fwd(const ScanFwdArgs& a, const typename Src::Args& sa, int N, int rows,
                            cudaStream_t s) {
  switch (N) {
    case 4: return launch_scan_fwd_n<T, 4, Src>(a, sa, rows, s);
    case 8: return launch_scan_fwd_n<T, 8, Src>(a, sa, rows, s);
    case 16: return launch_scan_fwd_n<T, 16, Src>(a, sa, rows, s);
    case 32: return launch_scan_fwd_n<T, 32, Src>(a, sa, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pc

extern "C" const char* pc_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
