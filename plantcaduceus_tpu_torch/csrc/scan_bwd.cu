// K3 — selective-scan backward (the adjoint of one scan direction).
//
// Replaces plantcaduceus_tpu/ops/pallas_scan.py::_bwd_kernel (launched at
// pallas_scan.py:564 through _pallas_bwd_group), the backward of K1
// (_scan_op_bwd), of K2 (pallas_mixer._bimamba_mixer_bwd) and of the
// context-parallel scan (seq_parallel._sp_scan_op_bwd). Both dt modes,
// `reverse`, and the options g0 (a cotangent state [rows, D, N] that seeds
// the recurrence: the adjoint of an emitted final state) and dh0 (the
// cotangent left after the earliest-processed step: the gradient with
// respect to the processing-order initial state).
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
// order. The recurrence is serial in time, so the parallelism has to come
// from the states: one lane per (channel, state) pair, N lanes a channel,
// 512 / N channels a block of 512 threads (32 channels at N = 16, two
// blocks an SM), so the l20 training shape runs 786,432 lanes against the
// 49,152 threads of a thread-per-channel layout. A block walks the hb
// chunks (hbc <= 16 steps each) in reverse processing order (L-1 -> 0 for
// a forward-direction scan, 0 -> L-1 for `reverse`, no flipped copies).
// Per chunk:
//  * the block stages the chunk's B and C rows and, one (step, channel)
//    pair a thread, the per-step scalars: dt' = softplus(dt + bias) (fused
//    dt projected once here, from the dt_lr rows and the block's W_dt
//    columns), dt'*log2e, dt'*x and gy packed in one float4 (one 16-byte
//    load a lane and step), x and sigmoid(dt + bias);
//  * each lane recomputes its state forward from the hb entry state, with
//    the forward's arithmetic, keeping every step's decay a and state h in
//    registers (one exp2 per state and step, for the recompute and the
//    adjoint together), then runs the cotangent backwards through them.
//    Steps past a ragged chunk's end are no-ops (zero inputs, decay 1), so
//    both loops are straight-line code;
//  * sum_n g*B and sum_n g*h[t-1]*a*A of each step stay per lane until the
//    chunk ends and are then reduce-scattered over the channel's N lanes
//    (30 shuffles for 32 values at N = 16, every index a constant so the
//    values stay in registers), so each lane finishes dx and ddt of its
//    own steps;
//  * dB and dC (sums over channels) are reduced over the warp's channels
//    by shuffles and over the block's warps in shared memory in a fixed
//    order; ddt_lr (fused) as a product over the block's channels. Each
//    block writes them as per-tile partials [tiles, rows, L, R + 2N].
// Whole-run sums (dA per lane, dbias, dD, dW) are written as per-row
// partials, and sum_slabs_kernel adds the partials in a fixed order. No
// atomics anywhere: the result is the same run to run.
//
// What bounds it on an H100: the exp2 per state and step (rows*L*D*N = 4.0e8
// at the l20 training shape, 64 rows x 512 x 768 x 16: 0.1 ms on the
// special-function units at 16 per clock per SM) and ~18 fp32 flops per
// state (0.17 ms at 67 TFLOP/s), against ~0.3 GB of bytes (x, gy, hb, the
// dt_lr | B | C residuals, dx; ~0.1 ms). This design issues ~25
// instructions per state and step (the recompute, the adjoint, the
// shuffles of the channel sums) and a per-chunk epilogue (the ddt_lr and
// dW products, the dB/dC sums over warps), so the issue rate, not the
// exp2, sets its pace.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (partials and outputs come from the wrapper) and returns
// cudaGetLastError().

#include <algorithm>

#include "scan_core.cuh"

namespace pc {

constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kMaxHbChunk = 16;  // steps whose decays and states a lane keeps in registers

template <int N> __host__ __device__ constexpr int bwd_channels() { return kBwdThreads / N; }

// Fused dt of one step: the dt_lr row (shared) against this channel's
// column of the W_dt tile (shared, row stride `wstride`), summed over r in
// order from 0, the order of the forward's outer product (scan_core.cuh), so
// the recomputed states are the forward's bit for bit.
__device__ __forceinline__ float fused_dt(const float* sdt_row, const float* sW,
                                          int R, int wstride, int tid) {
  float v = 0.f;
  for (int r = 0; r < R; ++r) v = fmaf(sdt_row[r], sW[r * wstride + tid], v);
  return v;
}

// One level of group_reduce_scatter: lanes with bit M set keep the upper
// half of v[0..2H), the others the lower half, each adding its partner's.
template <int M, int H, int V>
__device__ __forceinline__ void reduce_scatter_level(float (&v)[V], int lane) {
  const bool upper = lane & M;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// Sums v[0..V) over the G lanes of an aligned group (G a power of two <=
// 32, V >= G). Afterwards lane l of the group holds in v[0..V/G) the totals
// of values [l*V/G, (l+1)*V/G). Each level sends half the values still
// held: V - V/G shuffles in all. Every index is a constant, so v stays in
// registers.
template <int G, int V>
__device__ __forceinline__ void group_reduce_scatter(float (&v)[V], int lane) {
  static_assert(V >= G, "group_reduce_scatter: fewer values than lanes");
  if constexpr (G >= 2) reduce_scatter_level<G / 2, V / 2>(v, lane);
  if constexpr (G >= 4) reduce_scatter_level<G / 4, V / 4>(v, lane);
  if constexpr (G >= 8) reduce_scatter_level<G / 8, V / 8>(v, lane);
  if constexpr (G >= 16) reduce_scatter_level<G / 16, V / 16>(v, lane);
  if constexpr (G >= 32) reduce_scatter_level<G / 32, V / 32>(v, lane);
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
  const float* g0;     // [rows, D, N] cotangent seed, or null (zeros)
  float* dh0;          // [rows, D, N] initial-state gradient, or null
  float* dx;           // [rows, L, D]
  float* ddt;          // [rows, L, D] when not FUSE
  float* part_pos;     // [ntiles, rows, L, J], J = R + 2N: ddt_lr | dB | dC per tile
  float* part_run;     // [rows, P], P = D*N + 2D + R*D: dA | dbias | dD | dW per row
  int L, D, R, reverse, hbc;
  long long dt_row, dt_step, bc_row, bc_step;  // element strides
};

// Shared memory: per (step, channel), the scalars the lanes read at every
// step packed in one float4 (dt'*log2e, dt'*x, gy, dt'), then x, sigmoid(dt
// + bias), the outputs dx and ddt and the running dD and dbias by step,
// [16][CH + 1] each; B and C packed [16][N]; the warps' dB | dC partials
// [warps][16][2N]; fused: dt_lr [16][R], W_dt and dW [R][CH + 1]. The pads
// put the rows of one column on distinct banks (a lane finishing its steps
// of one channel, the ddt_lr product's reads of R rows).
template <int N>
inline size_t bwd_smem_bytes(int R) {
  constexpr int CH = bwd_channels<N>(), T = kMaxHbChunk;
  return sizeof(float) *
         (10 * T * (CH + 1) + 2 * T * N + kBwdWarps * T * 2 * N + T * R + 2 * R * (CH + 1));
}

template <typename Tx, typename Tb, int N, bool FUSE>
__global__ void __launch_bounds__(kBwdThreads, 1024 / kBwdThreads) scan_bwd_kernel(BwdArgs a) {
  constexpr int CH = bwd_channels<N>();  // channels of the block
  constexpr int V = 2 * kMaxHbChunk;     // per lane: sum_n g*B | sum_n das*A of each step
  constexpr int VL = V / N;              // of which a lane ends holding VL (VL/2 steps)
  extern __shared__ float4 smem4[];
  constexpr int TS = kMaxHbChunk;  // steps of the shared arrays (a chunk's are T <= TS)
  constexpr int XS = CH + 1;       // row stride of the [TS][CH] and [R][CH] arrays
  const int T = a.hbc;
  const int R = FUSE ? a.R : 0;
  float4* s_st = smem4;                            // [TS][XS] dt'*log2e, dt'*x, gy, dt'
  float* s_x = reinterpret_cast<float*>(s_st + TS * XS);  // [TS][XS] x
  float* s_sig = s_x + TS * XS;                    // [TS][XS] sigmoid(dt + bias)
  float* s_dx = s_sig + TS * XS;                   // [TS][XS] dx
  float* s_ddt = s_dx + TS * XS;                   // [TS][XS] ddt
  float* s_dD = s_ddt + TS * XS;                   // [TS][XS] gy*x over the chunks, by step
  float* s_db = s_dD + TS * XS;                    // [TS][XS] ddt over the chunks, by step
  float2* sBC = reinterpret_cast<float2*>(s_db + TS * XS);  // [TS][N] B, C
  float* spart = reinterpret_cast<float*>(sBC + TS * N);    // [warps][TS][N] dB, dC
  float* sdt = spart + kBwdWarps * TS * 2 * N;     // [TS][R]
  float* sW = sdt + TS * R;                        // [R][XS] W_dt
  float* sdW = sW + R * XS;                        // [R][XS] dW

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  // this lane's (channel, state)
  const int dl = tid / N, n = tid % N;
  const int d = d0 + dl;
  const bool live = d < a.D;
  const long long xrow = row * (long long)a.L * a.D;
  const Tx* x = static_cast<const Tx*>(a.x) + xrow;
  const Tx* gy = static_cast<const Tx*>(a.gy) + xrow;
  const Tb* dt = static_cast<const Tb*>(a.dt) + row * a.dt_row;
  const Tb* Bm = static_cast<const Tb*>(a.B) + row * a.bc_row;
  const Tb* Cm = static_cast<const Tb*>(a.C) + row * a.bc_row;
  const int J = R + 2 * N;
  const int nhb = (a.L + T - 1) / T;
  const float* hb = a.hb + row * (long long)nhb * a.D * N;
  float* ppos = a.part_pos + ((long long)blockIdx.x * gridDim.y + row) * a.L * J;
  auto time_of = [&](int p) -> long long { return a.reverse ? a.L - 1 - p : p; };

  for (int i = tid; i < TS * XS; i += kBwdThreads) s_dD[i] = s_db[i] = 0.f;
  if constexpr (FUSE) {
    for (int i = tid; i < R * CH; i += kBwdThreads) {
      const int r = i / CH, c = i % CH;
      sW[r * XS + c] = d0 + c < a.D ? a.wdt[(long long)r * a.D + d0 + c] : 0.f;
      sdW[r * XS + c] = 0.f;
    }
  }
  const float A = live ? a.A[(long long)d * N + n] : 0.f;
  const long long state = (row * a.D + d) * N + n;  // this lane's [rows, D, N] index
  float g = a.g0 && live ? a.g0[state] : 0.f, dA = 0.f;

  for (int c = nhb - 1; c >= 0; --c) {
    const int p0 = c * T;
    const int tn = min(T, a.L - p0);
    __syncthreads();  // every reader of the previous chunk's shared data is done
    for (int i = tid; i < TS * N; i += kBwdThreads) {  // zeros past the chunk's end
      const long long off = time_of(p0 + i / N) * a.bc_step + i % N;
      sBC[i] = i / N < tn ? make_float2(to_f(Bm[off]), to_f(Cm[off])) : make_float2(0.f, 0.f);
    }
    if constexpr (FUSE) {
      for (int i = tid; i < tn * R; i += kBwdThreads)
        sdt[i] = to_f(dt[time_of(p0 + i / R) * a.dt_step + i % R]);
      __syncthreads();  // the dt_lr rows are staged
    }
    // The per-step scalars, one (step, channel) pair a thread; dead pairs
    // (past L or D) hold zeros.
    for (int o = tid; o < TS * CH; o += kBwdThreads) {
      const int k = o / CH, c2 = o % CH, dd = d0 + c2, i = k * XS + c2;
      float xv = 0.f, gyv = 0.f, dtp = 0.f, sig = 0.f;
      if (k < tn && dd < a.D) {
        const long long t = time_of(p0 + k);
        xv = to_f(x[t * a.D + dd]);
        gyv = to_f(gy[t * a.D + dd]);
        const float dtv = FUSE ? fused_dt(sdt + k * R, sW, R, XS, c2)
                               : to_f(dt[t * a.dt_step + dd]);
        const float pre = dtv + a.dt_bias[dd];
        dtp = softplus(pre);
        sig = 1.f / (1.f + expf(-pre));
        s_dD[i] = fmaf(gyv, xv, s_dD[i]);
      }
      s_st[i] = make_float4(dtp * kLog2e, dtp * xv, gyv, dtp);
      s_x[i] = xv;
      s_sig[i] = sig;
    }
    __syncthreads();

    // Forward: the chunk's decays and states from its entry state. Steps
    // past a ragged chunk's end have dt' = x = gy = B = C = 0, so they leave
    // h and g as they are (decay 1) and add nothing: every chunk runs all
    // kMaxHbChunk steps without a test.
    float h0 = live ? hb[((long long)c * a.D + d) * N + n] : 0.f;
    float av[kMaxHbChunk], hv[kMaxHbChunk];
    {
      float h = h0;
#pragma unroll
      for (int k = 0; k < kMaxHbChunk; ++k) {
        const float2 st = *reinterpret_cast<const float2*>(s_st + k * XS + dl);  // dtl, dtx
        av[k] = exp2f(st.x * A);
        h = fmaf(av[k], h, sBC[k * N + n].x * st.y);
        hv[k] = h;
      }
    }
    // Backward: the cotangent through the chunk, last step first.
    float v[V];
#pragma unroll
    for (int k = kMaxHbChunk - 1; k >= 0; --k) {
      const float4 st = s_st[k * XS + dl];
      const float2 bc = sBC[k * N + n];
      const float dtx = st.y, gyv = st.z, dtp = st.w;
      const float gn = fmaf(bc.y, gyv, g);
      float db = gn * dtx, dc = gyv * hv[k];
#pragma unroll
      for (int m = N; m < 32; m <<= 1) {  // over the warp's channels
        db += __shfl_xor_sync(0xffffffffu, db, m);
        dc += __shfl_xor_sync(0xffffffffu, dc, m);
      }
      if (lane < N)
        *reinterpret_cast<float2*>(spart + ((warp * TS + k) * N + n) * 2) = make_float2(db, dc);
      v[2 * k] = bc.x * gn;
      g = av[k] * gn;
      const float das = g * (k > 0 ? hv[k - 1] : h0);
      dA = fmaf(das, dtp, dA);
      v[2 * k + 1] = das * A;
    }
    // sum_n over the channel's lanes; each lane finishes dx and ddt of its
    // own steps.
    group_reduce_scatter<N, V>(v, lane);
    auto finish = [&](int k, float gB, float dda) {
      const int i = k * XS + dl;
      if (k < tn) {
        const float4 st = s_st[i];
        const float ddt = fmaf(gB, s_x[i], dda) * s_sig[i];
        s_dx[i] = live ? fmaf(gB, st.w, st.z * a.Dskip[d]) : 0.f;
        s_ddt[i] = live ? ddt : 0.f;
      }
    };
    if constexpr (N == 32) {  // lane 2k holds step k's sum_n g*B, lane 2k + 1 its das*A
      const float other = __shfl_xor_sync(0xffffffffu, v[0], 1);
      if ((lane & 1) == 0) finish(lane / 2, v[0], other);
    } else {
#pragma unroll
      for (int q = 0; q < VL / 2; ++q) finish((lane % N) * (VL / 2) + q, v[2 * q], v[2 * q + 1]);
    }
    __syncthreads();

    // Chunk epilogue: dx (and ddt) rows; this tile's partial ddt_lr | dB |
    // dC per step, summed over the block's channels in a fixed order; dW.
    for (int o = tid; o < tn * CH; o += kBwdThreads) {
      const int k = o / CH, dd = d0 + o % CH, i = k * XS + o % CH;
      if (dd < a.D) {
        const long long g_o = xrow + time_of(p0 + k) * a.D + dd;
        a.dx[g_o] = s_dx[i];
        if (!FUSE) a.ddt[g_o] = s_ddt[i];
      }
    }
    for (int o = tid; o < tn * 2 * N; o += kBwdThreads) {  // o = (k, n, dB | dC)
      const int k = o / (2 * N), q = o % (2 * N);
      float s = 0.f;
      for (int w = 0; w < kBwdWarps; ++w) s += spart[(w * TS + k) * 2 * N + q];
      ppos[time_of(p0 + k) * J + R + (q & 1) * N + (q >> 1)] = s;
    }
    if constexpr (FUSE) {
      for (int o = tid; o < tn * R; o += kBwdThreads) {  // ddt_lr
        const int k = o / R, q = o % R;
        float s = 0.f;
        for (int ch = 0; ch < CH; ++ch) s = fmaf(s_ddt[k * XS + ch], sW[q * XS + ch], s);
        ppos[time_of(p0 + k) * J + q] = s;
      }
      for (int i = tid; i < R * CH; i += kBwdThreads) {  // dW[:, d] += dt_lr^T ddt
        const int r = i / CH, ch = i % CH;
        float s = sdW[r * XS + ch];
        for (int k = 0; k < tn; ++k) s = fmaf(sdt[k * R + r], s_ddt[k * XS + ch], s);
        sdW[r * XS + ch] = s;
      }
    }
    for (int o = tid; o < tn * CH; o += kBwdThreads) {
      const int i = (o / CH) * XS + o % CH;
      s_db[i] += s_ddt[i];
    }
  }

  // The cotangent after the earliest-processed step (its decay applied): dh0.
  if (a.dh0 && live) a.dh0[state] = g;

  // This row's whole-run partials: dA per lane; dbias, dD and dW per channel
  // (dbias and dD summed over the step slots in order).
  __syncthreads();
  const long long P = (long long)a.D * N + 2 * a.D + (long long)R * a.D;
  float* pr = a.part_run + row * P;
  if (live) pr[(long long)d * N + n] = dA;
  for (int ch = tid; ch < CH; ch += kBwdThreads) {
    const int dd = d0 + ch;
    if (dd >= a.D) continue;
    float sb = 0.f, sd = 0.f;
    for (int k = 0; k < TS; ++k) {
      sb += s_db[k * XS + ch];
      sd += s_dD[k * XS + ch];
    }
    pr[(long long)a.D * N + dd] = sb;
    pr[(long long)a.D * N + a.D + dd] = sd;
  }
  if constexpr (FUSE) {
    for (int i = tid; i < R * CH; i += kBwdThreads) {
      const int r = i / CH, dd = d0 + i % CH;
      if (dd < a.D)
        pr[(long long)a.D * (N + 2) + (long long)r * a.D + dd] = sdW[r * XS + i % CH];
    }
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
  if (a.hbc < 1 || a.hbc > kMaxHbChunk) return cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes<N>(FUSE ? a.R : 0);
  auto kern = scan_bwd_kernel<Tx, Tb, N, FUSE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((a.D + bwd_channels<N>() - 1) / bwd_channels<N>(), rows);
  kern<<<grid, kBwdThreads, smem, stream>>>(a);
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
// out_run [P] receive the summed partials; part_pos has ceil(D / (512 /
// N)) tiles. g0 and dh0 may be null.
extern "C" int pc_scan_bwd(const void* x, const void* gy, const void* dt, const void* B,
                           const void* C, const float* A, const float* Dskip,
                           const float* dt_bias, const float* wdt, const float* hb,
                           const float* g0, float* dh0, float* dx, float* ddt,
                           float* part_pos, float* part_run,
                           float* out_pos, float* out_run, int rows, int L, int D, int N,
                           int R, int fuse, int reverse, int hbc, long long dt_row,
                           long long dt_step, long long bc_row, long long bc_step,
                           int x_bf16, int bc_bf16, void* stream) {
  pc::BwdArgs a;
  a.x = x; a.gy = gy; a.dt = dt; a.B = B; a.C = C;
  a.A = A; a.Dskip = Dskip; a.dt_bias = dt_bias; a.wdt = wdt; a.hb = hb;
  a.g0 = g0; a.dh0 = dh0;
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
  const int ntiles = (D + pc::kBwdThreads / N - 1) / (pc::kBwdThreads / N);
  e = pc::sum_slabs(part_pos, out_pos, ntiles, (long long)rows * L * J, s);
  if (e != cudaSuccess) return e;
  return pc::sum_slabs(part_run, out_run, rows,
                       (long long)D * N + 2LL * D + (long long)a.R * D, s);
}
