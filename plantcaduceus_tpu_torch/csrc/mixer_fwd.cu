// K2 — the Mamba-1 mixer interior, one direction.
//
// Replaces plantcaduceus_tpu/ops/pallas_mixer.py::_mixer_kernel (launched
// at pallas_mixer.py:345 through mixer_scan_fused / bimamba_mixer_fused[_x]):
//   xg    = silu(acc), acc = depthwise conv K taps (causal, or anticausal) + bias
//   dt_lr | B | C = xg @ [W_dt | W_B | W_C]
//   y     = K1's scan of xg with dt = dt_lr @ W_dt, plus Dskip * xg.
// The training variant (emit_res, pallas_mixer.py:61-66, 118-119, 131-135)
// also writes the pre-SiLU `acc` in xi's dtype and the scan's chunk-entry
// states `hb`; the fp32 dt_lr | B | C rows are the `dbc` scratch itself,
// which the wrapper returns instead of dropping. The fuse_in variant
// (pallas_mixer.py:52-59, 91-96, 208-224, 335-341; bimamba_mixer_fused_x,
// :374-397, JAX's inference path at d_inner <= 768) takes the block input
// x [rows, L, d_model] and w_in^T [D, d_model] instead of xi: xi = x w_in,
// the product in x's dtype with a float32 sum, stays float32 and is never
// written to device memory (below).
//
// The TPU kernel walks time chunks in order and carries the conv halo and
// the x_proj sums in scratch. GPU blocks run in no order, so the work is two
// kernels on one stream, and xg never reaches device memory: each kernel
// computes it from xi's K taps (L2-resident) where it needs it.
//  (a) conv_xproj_kernel: a block owns (row, 64 time steps) across all of D,
//      32 channels a pass: the conv and SiLU of the pass into shared memory
//      (transposed), then the x_proj product register-blocked, a thread
//      owning 4 steps x TN outputs with its xg and W fragments in registers
//      (two 16-byte shared loads per 4 TN FMAs). Float32 FMA products (the
//      TPU's float32 dot, no TF32); each output is summed by one thread over
//      D in order, so results are deterministic (no atomics).
//  (b) scan_core.cuh's scan_fwd_kernel, the forward scan K1 also runs,
//      with this file's MixConvSrc as its input policy: one thread per
//      channel with its N states in registers, walking time in processing
//      order (L-1 -> 0 for `reverse`, no flipped copies) in chunks of 8
//      steps. Per chunk the thread first computes the chunk's per-step
//      inputs in registers, with no dependence between steps: xg by the conv
//      from a window of xi taps carried across chunks, dt = dt_lr . W_dt[:, d]
//      as an outer product over r; then runs the recurrence. The B, C and
//      dt_lr rows of the next chunk are loaded while this one computes.
// Every sum runs in one fixed order: the conv's bias first and then its
// taps, the dt projection over r, the x_proj over D, and the recurrence and
// readout of scan_core.cuh, so K3 recomputes the same states. A lane per
// (channel, state) with the readout deferred to a reduce-scatter (K3's
// layout) issues about twice the instructions per state and step: at l20
// training it ran this scan at 0.86 ms against this layout's 0.54 ms
// (PERF.md).
//
// What bounds it on an H100: the scan's exp2 per state (1.6e9 at l20,
// 256x512x768x16: about 0.4 ms on the special-function units) ahead of the
// fp32 FMAs (~2.2e10 flops with the x_proj product: 0.33 ms at 67 TFLOP/s)
// and of the bytes xi and y must move (0.13 ms in bf16). The scan's issue
// rate and latency, not the exp2 alone, set its pace (scan_core.cuh).
//
// fuse_in. Each kernel computes the xi it needs from x rows and w_in^T
// rows, never from an xi in device memory; every xi element is one chain
// over d_model from k = 0 in one order with a float32 sum (bf16: mma.sync
// m16n8k16 on the tensor cores; float32: FMA, as the port's float32
// contract refuses TF32), so (a) and (b) compute the same bits for it
// wherever it sits in a tile. The bound at l20 scoring (256 x 512, d_model
// 384 -> 768, one direction): the in_proj is 7.7e10 flops, 0.08 ms on the
// bf16 tensor cores (1.2 ms as fp32 FMA), under the scan's exp2. What
// bounds the products here is how their operands reach them (restaging
// w_in^T or x from L2 behind barriers, ldmatrix traffic, the rows' waits),
// not the tensor cores (their mma.sync rate on the card is ~600 TFLOP/s),
// so the bf16 design keeps each operand in shared memory for as long as it
// is used. bf16, l20's route:
//  (a) conv_xproj_x_kernel: the block's x window (64 + K - 1 rows, all of
//      d_model) reaches shared memory once by cp.async; each 32-channel
//      pass's w_in^T rows arrive by cp.async while the previous pass's conv
//      and x_proj run; three warps compute the pass's xi window, two row
//      tiles by four channel tiles each, so every ldmatrix fragment serves
//      two or four products (one A and one B fragment a product, over all
//      eight warps, ran twice as long). 109.8 KB at d_model 384: two blocks
//      an SM. Its products still cost ~0.55 ms of its ~1.45 (PERF.md): the
//      passes' products, conv and x_proj take turns behind barriers, and
//      neither four product warps (one per SM partition) nor product warps
//      running a pass ahead of the conv warps (one block an SM) did better.
//  (b) MixConvSrcX: a block holds four rows (kXRows) of the same 128
//      channels, so their w_in^T slice [128][d_model] stays resident in
//      shared memory (96 KB at d_model 384, staged once); each row's four
//      warps run their own scan on named barriers, and project 32-step
//      xi tiles (B fragments by ldmatrix from the resident slice, x rows
//      from the caches, sixteen loads in flight) into the row's float32
//      tile. The four rows' tile boundaries are a chunk apart, so in each
//      8-step chunk one row's warps project while the other three scan. No
//      producer warps: the scan holds 16 warps an SM at 128 registers, the
//      whole register file, and warps set aside for products would cost
//      scan warps. The products are nearly free here; the x loads and the
//      row's wait for its tile are what the scan pays (~0.45 ms).
// float32 (parity only; its w_in^T slice, 192 KB, cannot stay resident):
// the first design, (a)'s window and (b)'s tile from staged chunks of
// w_in^T (kInK of d_model), restaged for every 32 steps. fuse_in builds in
// a unit of its own (this file with PC_MIXER_FUSE_IN: pc_mixer_fwd_x),
// beside the other variants (pc_mixer_fwd).
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the dbc scratch comes from the wrapper) and returns
// cudaGetLastError().

#include "attn_sm90.cuh"  // cp.async, smem_u32
#include "scan_core.cuh"

namespace pc {

using bf16 = __nv_bfloat16;

constexpr int kMaxK = 8;        // conv taps
constexpr int kXpThreads = 256;
constexpr int kXpT = 64;        // time steps per block of (a)
constexpr int kXpTld = kXpT + 4;  // row stride of the transposed xg tile (16-byte rows)
constexpr int kXpC = 32;        // channels per pass of (a)

// (a) shared memory: the xi window [kXpT + K - 1][kXpC], xg^T [kXpC][kXpTld]
// and the W pass [kXpC][16 TN]; with fuse_in (in_bytes) the staged x and
// w_in^T after them.
inline size_t xp_smem_bytes(int TN, size_t in_bytes = 0) {
  return sizeof(float) * ((kXpT + kMaxK - 1) * kXpC + kXpC * kXpTld + kXpC * 16 * TN) + in_bytes;
}

// The conv of one (step, channel) runs in one order that both kernels
// keep: s = bias, then s = fma(x[t - (K-1) + k], w[k], s) for k = 0 ..
// K-1 (causal), or s = fma(x[t + k], w[K-1-k], s) (reverse); xg = SiLU(s).
__device__ __forceinline__ float silu_xg(float s) { return s / (1.f + expf(-s)); }

// ---- fuse_in: in_proj's x half inside both kernels --------------------------

constexpr int kInT = 32;                // steps (b) projects at once, a multiple of kFwdT
constexpr int kInLd = kFwdThreads + 8;  // row stride of (b)'s xi tile (floats)
constexpr int kInK = 64;                // float32: d_model per staged chunk of w_in^T and x
constexpr int kInRows = 80;             // (a)'s window rows in 16-row tiles: kXpT + kMaxK - 1 rounded up
constexpr int kXWin = 72;               // bf16 (a): the window rows kept (>= kXpT + kMaxK - 1)
constexpr int kXpCld = kXpC + 8;        // bf16 (a): row stride of its xi window (floats)
constexpr int kXRows = 4;               // bf16 (b): rows a block, sharing the resident w_in^T
static_assert(kInRows >= kXpT + kMaxK - 1 && kInRows % 16 == 0, "(a)'s window in 16-row tiles");
static_assert(kXWin >= kXpT + kMaxK - 1 && kInRows - kXWin <= kXpC, "bf16 (a)'s halo tile");
static_assert(kInT % (kXRows * kFwdT) == 0, "(b)'s rows project a chunk apart");

// bf16: row stride of a staged x or w_in^T row, in elements: 16-byte rows
// an odd number of 16-byte units apart, so ldmatrix's eight rows fall on
// distinct banks (d_model is a multiple of 16).
__host__ __device__ inline int x_ld(int Dm) { return Dm + 8; }

// float32: row stride of a staged w_in^T or x chunk (68 words: the fragment
// reads fall on distinct banks).
constexpr int kInLdF = kInK + 4;

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// d += a . b: mma.sync m16n8k16, bf16 operands, float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four (two) 8x8 bf16 matrices from shared memory, one row address a lane
// (lanes 8i .. 8i + 7 give matrix i's rows): lane 4g + t receives row g,
// columns 2t and 2t + 1 of each, mma's fragment layout.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// bf16: rows c0 .. c0 + rows - 1 of w_in^T [D][Dm] (zeros for c >= D) into
// dst [rows][x_ld(Dm)] by cp.async, the calling threads (nthreads of them,
// thread index i0) 16 bytes at a time; the caller commits and waits.
__device__ __forceinline__ void stage_rows_async(bf16* dst, const bf16* wT, int c0, int rows,
                                                 int D, int Dm, int i0, int nthreads) {
  const int per = Dm / 8, ld = x_ld(Dm);
  for (int i = i0; i < rows * per; i += nthreads) {
    const int r = i / per, v = i % per, c = c0 + r;
    cp_async16(smem_u32(dst + r * ld + 8 * v), c < D ? wT + (long long)c * Dm + 8 * v : wT,
               c < D);
  }
}

__device__ __forceinline__ void fma4(float& d, const float4& x, const float4& w) {
  d = fmaf(x.x, w.x, d);
  d = fmaf(x.y, w.y, d);
  d = fmaf(x.z, w.z, d);
  d = fmaf(x.w, w.w, d);
}

// float32: the block stages w_in^T rows c0 .. c0 + rows - 1, d_model k0 ..
// k0 + kInK - 1 (the last chunk may be shorter: Dm is a multiple of 16),
// into sw [rows][kInLdF], zeros for channels >= D; 16-byte copies.
__device__ __forceinline__ void stage_w(float* sw, const float* wT, int c0, int rows, int D,
                                        int Dm, int k0) {
  const int kc = min(kInK, Dm - k0), per = kc / 4;
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int r = i / per, v = i % per, c = c0 + r;
    *reinterpret_cast<float4*>(sw + r * kInLdF + v * 4) =
        c < D ? __ldg(reinterpret_cast<const float4*>(wT + (long long)c * Dm + k0 + v * 4))
              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// float32: the block stages x rows r = 0 .. kInRows - 1 (step t0 + r; zeros
// for r >= valid or a step outside [0, L)), d_model k0 .. k0 + kInK - 1,
// into sx [kInRows][kInLdF]; 16-byte copies.
__device__ __forceinline__ void stage_x(float* sx, const float* xrow, int t0, int valid, int L,
                                        int Dm, int k0) {
  const int per = min(kInK, Dm - k0) / 4;
  for (int i = threadIdx.x; i < kInRows * per; i += blockDim.x) {
    const int r = i / per, v = i % per, t = t0 + r;
    *reinterpret_cast<float4*>(sx + r * kInLdF + v * 4) =
        r < valid && t >= 0 && t < L
            ? __ldg(reinterpret_cast<const float4*>(xrow + (long long)t * Dm + k0 + v * 4))
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// float32: one warp's 16 steps x NT 8-channel tiles of xi = x w_in, a
// d_model chunk of kc summed by fmaf over k in order from 0, then added to
// d (a sum of chunk sums: the rounding grows with kInK, not d_model). Lane 4g + t
// holds, for tile nt, xi at (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1). xr0, xr1: this lane's x rows for tile rows g and g + 8 at the
// chunk's first column, in device memory (null outside [0, L): xi is the
// conv's zero padding there) or, with ASMEM, staged in shared memory; sw:
// the staged w_in^T rows of the NT tiles' channels.
template <int NT, bool ASMEM>
__device__ __forceinline__ void xi_tiles_f32(float (&d)[NT][4], const float* xr0,
                                             const float* xr1, const float* sw, int kc) {
  const int t = threadIdx.x & 3;
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
  auto ld4 = [](const float* p) {
    return ASMEM ? *reinterpret_cast<const float4*>(p)
                 : __ldg(reinterpret_cast<const float4*>(p));
  };
  float c[NT][4] = {};
#pragma unroll 2
  for (int kk = 0; kk < kc; kk += 4) {
    const float4 xa = xr0 ? ld4(xr0 + kk) : z4, xb = xr1 ? ld4(xr1 + kk) : z4;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* b = sw + (8 * nt + 2 * t) * kInLdF + kk;
      const float4 wa = *reinterpret_cast<const float4*>(b);
      const float4 wb = *reinterpret_cast<const float4*>(b + kInLdF);
      fma4(c[nt][0], xa, wa);
      fma4(c[nt][1], xa, wb);
      fma4(c[nt][2], xb, wa);
      fma4(c[nt][3], xb, wb);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[nt][i] += c[nt][i];
}

// ---- (a): conv + SiLU + x_proj ----------------------------------------------

// One pass's conv and SiLU: the block's kXpT steps of channels c0 ..
// c0 + kXpC - 1 from the xi window sx [kXpT + K - 1][SXLD] into xg^T sxg
// [kXpC][kXpTld] (zeros past L or D); RES also stores the pre-SiLU acc.
template <typename T, bool RES, int SXLD = kXpC>
__device__ __forceinline__ void conv_pass(const float* sx, float* sxg,
                                          const float* __restrict__ conv_w,
                                          const float* __restrict__ conv_b, T* acc_out,
                                          long long b, int t0, int c0, int L, int D, int K,
                                          int reverse) {
  const int tid = threadIdx.x, ch = tid % kXpC, c = c0 + ch;
  float wr[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
    wr[k] = (k < K && c < D) ? conv_w[(long long)c * K + (reverse ? K - 1 - k : k)] : 0.f;
  const float cb = c < D ? conv_b[c] : 0.f;
  for (int tt = tid / kXpC; tt < kXpT; tt += kXpThreads / kXpC) {
    const int t = t0 + tt;
    float v = 0.f;
    if (t < L && c < D) {
      float s = cb;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) s = fmaf(sx[(tt + k) * SXLD + ch], wr[k], s);
      v = silu_xg(s);
      if constexpr (RES) acc_out[(b * L + t) * D + c] = from_f<T>(s);  // pre-SiLU
    }
    sxg[ch * kXpTld + tt] = v;
  }
}

// One pass's x_proj, added to this thread's 4 steps x TN outputs: xg^T
// sxg times the pass's W rows swf [kXpC][16 TN], over the pass's channels
// in order (two 16-byte shared loads per 4 TN FMAs).
template <int TN>
__device__ __forceinline__ void xproj_pass(const float* sxg, const float* swf,
                                           float (&acc)[4][TN]) {
  constexpr int JP = 16 * TN;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll 4
  for (int ch = 0; ch < kXpC; ++ch) {
    const float4 xv = *reinterpret_cast<const float4*>(sxg + ch * kXpTld + 4 * ty);
    float w[TN];
#pragma unroll
    for (int n = 0; n < TN; n += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(swf + ch * JP + tx * TN + n);
      w[n] = w4.x; w[n + 1] = w4.y; w[n + 2] = w4.z; w[n + 3] = w4.w;
    }
    const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(xa[i], w[n], acc[i][n]);
  }
}

// The block's x_proj outputs: its 64 steps' dt_lr | B | C rows.
template <int TN>
__device__ __forceinline__ void store_dbc(float* __restrict__ dbc, const float (&acc)[4][TN],
                                          long long b, int t0, int L, int J) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * ty + i;
    if (t >= L) continue;
    float* o = dbc + (b * L + t) * J;
#pragma unroll
    for (int n = 0; n < TN; ++n)
      if (tx * TN + n < J) o[tx * TN + n] = acc[i][n];
  }
}

// RES: the training variant, which also writes the pre-SiLU acc. FIN: the
// float32 fuse_in variant, xi being x [rows, L, Dm] and winT w_in^T [D,
// Dm]. TN: x_proj outputs per thread; wx is [D, 16 TN], zero past J.
template <typename T, bool RES, bool FIN, int TN>
__global__ void __launch_bounds__(kXpThreads) conv_xproj_kernel(
    const T* __restrict__ xi, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ wx, float* __restrict__ dbc,
    T* __restrict__ acc_out, const T* __restrict__ winT, int L, int D, int K, int J, int reverse,
    int Dm) {
  static_assert(!FIN || std::is_same<T, float>::value, "bf16 fuse_in: conv_xproj_x_kernel");
  extern __shared__ float4 xp_smem4[];
  constexpr int JP = 16 * TN;
  float* sx = reinterpret_cast<float*>(xp_smem4);  // [kXpT + K - 1][kXpC] xi window
  float* sxg = sx + (kXpT + kMaxK - 1) * kXpC;     // [kXpC][kXpTld] xg^T
  float4* sw = reinterpret_cast<float4*>(sxg + kXpC * kXpTld);  // [kXpC][JP / 4] W
  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int t0 = blockIdx.x * kXpT;
  const T* xrow = xi + b * (long long)L * (FIN ? Dm : D);
  const int win = kXpT + K - 1;
  // causal: output t reads x[t-K+1 .. t]; anticausal: x[t .. t+K-1]
  const int tbase = reverse ? t0 : t0 - (K - 1);
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;
  // fuse_in: staged chunks of w_in^T [kXpC][kInLdF] and of the x window
  // [kInRows][kInLdF]
  float* sin = FIN ? reinterpret_cast<float*>(sw + kXpC * JP / 4) : nullptr;
  float* sxin = FIN ? sin + kXpC * kInLdF : nullptr;

  for (int c0 = 0; c0 < D; c0 += kXpC) {
    if constexpr (FIN) {
      // the pass's xi window from staged chunks of the window's x rows and
      // of w_in^T: warp w < 5 owns window rows 16w .. 16w + 15 and the
      // pass's 32 channels
      const int w = tid >> 5, g = (tid & 31) >> 2, tq = tid & 3;
      const int ra = 16 * w + g, rb = ra + 8;
      const bool busy = 16 * w < win;
      float v[kXpC / 8][4] = {};
      for (int k0 = 0; k0 < Dm; k0 += kInK) {
        stage_w(sin, reinterpret_cast<const float*>(winT), c0, kXpC, D, Dm, k0);
        stage_x(sxin, reinterpret_cast<const float*>(xrow), tbase, win, L, Dm, k0);
        __syncthreads();
        if (busy)
          xi_tiles_f32<kXpC / 8, true>(v, sxin + ra * kInLdF, sxin + rb * kInLdF, sin,
                                       min(kInK, Dm - k0));
        __syncthreads();  // both are restaged next
      }
      if (busy) {
#pragma unroll
        for (int nt = 0; nt < kXpC / 8; ++nt) {
          const int cc = 8 * nt + 2 * tq;
          if (ra < win) { sx[ra * kXpC + cc] = v[nt][0]; sx[ra * kXpC + cc + 1] = v[nt][1]; }
          if (rb < win) { sx[rb * kXpC + cc] = v[nt][2]; sx[rb * kXpC + cc + 1] = v[nt][3]; }
        }
      }
    } else {
      for (int i = tid; i < win * kXpC; i += kXpThreads) {
        const int t = tbase + i / kXpC, c = c0 + i % kXpC;
        sx[i] = (t >= 0 && t < L && c < D) ? to_f(xrow[(long long)t * D + c]) : 0.f;
      }
    }
    for (int i = tid; i < kXpC * JP / 4; i += kXpThreads) {
      const int c = c0 + i / (JP / 4);
      sw[i] = c < D ? __ldg(reinterpret_cast<const float4*>(wx + (long long)c * JP) + i % (JP / 4))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    conv_pass<T, RES>(sx, sxg, conv_w, conv_b, acc_out, b, t0, c0, L, D, K, reverse);
    __syncthreads();
    xproj_pass<TN>(sxg, reinterpret_cast<const float*>(sw), acc);
    __syncthreads();  // sx, sxg and sw are rewritten by the next pass
  }
  store_dbc<TN>(dbc, acc, b, t0, L, J);
}

// (a) for bf16 fuse_in: x [rows, L, Dm], winT w_in^T [D, Dm]. The x window
// [kXWin][x_ld(Dm)] is staged once; per pass, the pass's w_in^T rows
// [kXpC][x_ld(Dm)] (cp.async, issued while the previous pass's conv and
// x_proj run) and its W rows (cp.async, while its products run). The
// pass's xi window is 5 x 4 m16n8 tiles (rows past K - 1 + 64 skipped):
// warp w < 3 takes row tiles 2w and 2w + 1 and all four channel tiles, so
// per k-step two A and two B ldmatrix feed eight products (the fewer warps
// with the more products each, the faster this phase ran: the tensor
// cores' rate does not bound it). The halo tile's ldmatrix reads past the
// window's 72 rows into swin: those rows' products are never stored.
template <int TN>
__global__ void __launch_bounds__(kXpThreads, 2) conv_xproj_x_kernel(
    const bf16* __restrict__ x, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ wx, float* __restrict__ dbc,
    const bf16* __restrict__ winT, int L, int D, int K, int J, int reverse, int Dm) {
  extern __shared__ float4 xp_smem4[];
  constexpr int JP = 16 * TN;
  const int ld = x_ld(Dm);
  float* sx = reinterpret_cast<float*>(xp_smem4);  // [kXpT + K - 1][kXpCld] xi window
  float* sxg = sx + (kXpT + kMaxK - 1) * kXpCld;   // [kXpC][kXpTld] xg^T
  float* sw = sxg + kXpC * kXpTld;                 // [kXpC][JP] W
  bf16* sxw = reinterpret_cast<bf16*>(sw + kXpC * JP);  // [kXWin][ld] x window
  bf16* swin = sxw + kXWin * ld;                        // [kXpC][ld] the pass's w_in^T rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long long b = blockIdx.y;
  const int t0 = blockIdx.x * kXpT;
  const bf16* xrow = x + b * (long long)L * Dm;
  const int win = kXpT + K - 1;
  const int tbase = reverse ? t0 : t0 - (K - 1);
  {  // the window: row r is step tbase + r; zeros outside [0, L) and past win
    const int per = Dm / 8;
    for (int i = tid; i < kXWin * per; i += kXpThreads) {
      const int r = i / per, v = i % per, t = tbase + r;
      const bool ok = r < win && t >= 0 && t < L;
      cp_async16(smem_u32(sxw + r * ld + 8 * v), ok ? xrow + (long long)t * Dm + 8 * v : xrow,
                 ok);
    }
  }
  stage_rows_async(swin, winT, 0, kXpC, D, Dm, tid, kXpThreads);
  cp_async_commit();
  // warp w < 3: row tiles 2w (and 2w + 1 below 5), the second only where
  // the window reaches it (the halo tile 4 when K > 1)
  const int nm = warp < 2 ? 2 : warp == 2 && win > 64 ? 1 : 0;
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;

  for (int c0 = 0; c0 < D; c0 += kXpC) {
    cp_async_wait<0>();
    __syncthreads();  // this pass's w_in^T rows (and the window) landed; sw and sxg are free
    for (int i = tid; i < kXpC * JP / 4; i += kXpThreads) {
      const int c = c0 + i / (JP / 4);
      cp_async16(smem_u32(sw + 4 * i), c < D ? wx + (long long)c * JP + 4 * (i % (JP / 4)) : wx,
                 c < D);
    }
    cp_async_commit();
    if (nm > 0) {
      // the next k-step's fragments are loaded before this one's products
      float v[2][4][4] = {};
      const bf16* pa = sxw + (32 * warp + (lane & 15)) * ld + 8 * (lane >> 4);
      const bf16* pb = swin + (8 * (lane >> 4) + (lane & 7)) * ld + 8 * ((lane >> 3) & 1);
      uint32_t fa[2][4], fb[2][4];
      auto frags = [&](uint32_t(&ra)[2][4], uint32_t(&rb)[2][4], int k0) {
        ldsm_x4(ra[0], pa + k0);
        if (nm > 1) ldsm_x4(ra[1], pa + 16 * ld + k0);
        ldsm_x4(rb[0], pb + k0);
        ldsm_x4(rb[1], pb + 16 * ld + k0);
      };
      frags(fa, fb, 0);
      for (int k0 = 0; k0 < Dm; k0 += 16) {
        uint32_t an[2][4], bn[2][4];
        if (k0 + 16 < Dm) frags(an, bn, k0 + 16);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (m >= nm) break;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma_bf16(v[m][2 * j], fa[m], fb[j][0], fb[j][1]);
            mma_bf16(v[m][2 * j + 1], fa[m], fb[j][2], fb[j][3]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fa[0][i] = an[0][i];
          fa[1][i] = an[1][i];
          fb[0][i] = bn[0][i];
          fb[1][i] = bn[1][i];
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m >= nm) break;
        const int ra = 32 * warp + 16 * m + g, rb = ra + 8;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int cc = 8 * nt + 2 * tq;
          if (ra < win)
            *reinterpret_cast<float2*>(sx + ra * kXpCld + cc) = make_float2(v[m][nt][0], v[m][nt][1]);
          if (rb < win)
            *reinterpret_cast<float2*>(sx + rb * kXpCld + cc) = make_float2(v[m][nt][2], v[m][nt][3]);
        }
      }
    }
    __syncthreads();  // the xi window is complete; swin is free
    const bool more = c0 + kXpC < D;
    if (more) {
      stage_rows_async(swin, winT, c0 + kXpC, kXpC, D, Dm, tid, kXpThreads);
      cp_async_commit();
    }
    conv_pass<bf16, false, kXpCld>(sx, sxg, conv_w, conv_b, nullptr, b, t0, c0, L, D, K,
                                   reverse);
    if (more) cp_async_wait<1>();  // this pass's W rows, not the next pass's w_in^T
    else cp_async_wait<0>();
    __syncthreads();  // xg^T and the W rows are complete
    xproj_pass<TN>(sxg, sw, acc);
  }
  store_dbc<TN>(dbc, acc, b, t0, L, J);
}

struct MixScanArgs {
  const void* xi;        // [rows, L, D], or x [rows, L, Dm] with fuse_in
  const float* conv_w;   // [D, K]
  const float* conv_b;   // [D]
  const float* dbc;      // [rows, L, J]: dt_lr | B | C, J = R + 2N
  const void* winT;      // w_in^T [D, Dm] (fuse_in), or null
  int K, J, Dm;
};

// What (b)'s input policies share: xg by the conv from a window of xi taps
// carried across chunks, the B | C | dt_lr rows from (a)'s dbc. KT:
// registers for the conv taps (K <= KT; the K given taps in the conv's
// order, zero taps around them, which leaves every sum as it is). Taps in
// window order: the window's slot KT - 1 + k is this chunk's step k in
// processing order (u[p] = x[time_of(p)], 0 before the start), so a causal
// step reads slots k .. k + KT - 1 oldest first and a reverse step reads
// them newest first, each in the conv's order.
template <typename T, int KT>
struct MixConvBase {
  using Args = MixScanArgs;
  using Raw = float;
  static constexpr int TC = kFwdT;
  const T* x;
  const T* winT;
  const float* dbc;
  int L, D, J, Dm, d, reverse;
  bool live;
  float cb;
  float wt[KT], win[KT - 1 + TC];
  __device__ MixConvBase(const Args& m, const ScanFwdArgs& a, long long row, int d_, bool live_,
                         bool fin)
      : L(a.L), D(a.D), J(m.J), Dm(m.Dm), d(d_), reverse(a.reverse), live(live_) {
    x = static_cast<const T*>(m.xi) + row * L * (fin ? Dm : D);
    winT = static_cast<const T*>(m.winT);
    dbc = m.dbc + row * L * J;
    const int K = m.K;
    cb = live ? m.conv_b[d] : 0.f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float v = 0.f;
      if (live) {
        if (!reverse && j >= KT - K) v = m.conv_w[(long long)d * K + j - (KT - K)];
        if (reverse && j < K) v = m.conv_w[(long long)d * K + K - 1 - j];
      }
      wt[j] = v;
    }
#pragma unroll
    for (int j = 0; j < KT - 1; ++j) win[j] = 0.f;
  }
  __device__ float row(long long t, int j) const { return dbc[t * J + j]; }
  __device__ void prefetch(int) {}
  // The chunk's xg from the window (its new taps in place): the conv of
  // each step in order, then the window moves on.
  __device__ void conv(float (&xv)[TC]) {
#pragma unroll
    for (int k = 0; k < TC; ++k) {
      float s = cb;
      if (!reverse) {
#pragma unroll
        for (int j = 0; j < KT; ++j) s = fmaf(win[k + j], wt[j], s);
      } else {
#pragma unroll
        for (int j = 0; j < KT; ++j) s = fmaf(win[k + KT - 1 - j], wt[j], s);
      }
      xv[k] = silu_xg(s);
    }
#pragma unroll
    for (int j = 0; j < KT - 1; ++j) win[j] = win[TC + j];
  }
};

// (b)'s policy with xi given, or (FIN, float32 only) with xi from x and
// w_in^T through a float32 [kInT][kInLd] tile in shared memory, kInT steps
// (processing order) at a time, from staged chunks of w_in^T.
template <typename T, int KT, bool FIN = false>
struct MixConvSrc : MixConvBase<T, KT> {
  static_assert(!FIN || std::is_same<T, float>::value, "bf16 fuse_in: MixConvSrcX");
  using Base = MixConvBase<T, KT>;
  using Base::x; using Base::winT; using Base::L; using Base::D; using Base::Dm; using Base::d;
  using Base::reverse; using Base::live; using Base::win;
  static constexpr bool kFuse = true, kHb = !FIN, kCombine = false;
  // sxi [kInT][kInLd] float32, then the staged w_in^T chunk [128][kInLdF]
  static constexpr int kSmemFloats = FIN ? kInT * kInLd + kFwdThreads * kInLdF : 0;
  static constexpr int TC = kFwdT;
  float* sxi = nullptr;
  __device__ MixConvSrc(const typename Base::Args& m, const ScanFwdArgs& a, long long row, int d_,
                        bool live_)
      : Base(m, a, row, d_, live_, FIN) {}
  __device__ void bind_smem(float* p) { sxi = p; }
  // fuse_in: xi of processing steps P0 .. P0 + kInT - 1 for the block's
  // channels into sxi: warp w owns steps 16 (w & 1) .. + 15 and channels
  // 64 (w >> 1) .. + 63 (8 tiles). Every thread of the block calls it,
  // between two barriers.
  __device__ void project(int P0) {
    static_assert(kInT == 32 && kFwdThreads == 128, "4 warps: 2 x 16 steps, 2 x 64 channels");
    __syncthreads();  // every thread's reads of the last tile are done
    float* sin = sxi + kInT * kInLd;
    const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
    const int r = 16 * (w & 1) + g, ch = 64 * (w >> 1), d0 = d - threadIdx.x;
    const int pa = P0 + r, pb = pa + 8;
    const float* xa = pa < L ? x + (long long)(reverse ? L - 1 - pa : pa) * Dm : nullptr;
    const float* xb = pb < L ? x + (long long)(reverse ? L - 1 - pb : pb) * Dm : nullptr;
    float v[8][4] = {};
    for (int k0 = 0; k0 < Dm; k0 += kInK) {
      stage_w(sin, winT, d0, kFwdThreads, D, Dm, k0);
      __syncthreads();
      xi_tiles_f32<8, false>(v, xa ? xa + k0 : nullptr, xb ? xb + k0 : nullptr,
                             sin + ch * kInLdF, min(kInK, Dm - k0));
      __syncthreads();  // sin is restaged next
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int cc = ch + 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(sxi + r * kInLd + cc) = make_float2(v[nt][0], v[nt][1]);
      *reinterpret_cast<float2*>(sxi + (r + 8) * kInLd + cc) = make_float2(v[nt][2], v[nt][3]);
    }
    __syncthreads();
  }
  __device__ void x_chunk(int p0, float (&xv)[TC]) {
    if constexpr (FIN) {
      if (p0 % kInT == 0) project(p0);
#pragma unroll
      for (int k = 0; k < TC; ++k)
        win[KT - 1 + k] =
            (live && p0 + k < L) ? sxi[(p0 % kInT + k) * kInLd + threadIdx.x] : 0.f;
    } else {
#pragma unroll
      for (int k = 0; k < TC; ++k) {
        const int p = p0 + k;
        win[KT - 1 + k] =
            (live && p < L) ? to_f(x[(long long)(reverse ? L - 1 - p : p) * D + d]) : 0.f;
      }
    }
    this->conv(xv);
  }
};

// (b)'s policy for bf16 fuse_in: kXRows rows a block share the resident
// w_in^T slice of its 128 channels, sw [128][x_ld(Dm)] (stage_block); each
// row's group projects kInT-step xi tiles into its own float32 tile sxi
// [kInT][kInLd]. Group g's tiles start where (p + phase) % kInT == 0,
// phase = g kInT / kXRows: one group of four projects in any chunk.
template <int KT>
struct MixConvSrcX : MixConvBase<bf16, KT> {
  using Base = MixConvBase<bf16, KT>;
  using Base::x; using Base::winT; using Base::L; using Base::D; using Base::Dm;
  using Base::reverse; using Base::live; using Base::win;
  static constexpr bool kFuse = true, kHb = false, kCombine = false;
  static constexpr int kRows = kXRows;
  static constexpr int kSmemFloats = 0;  // sized at run time
  static constexpr int TC = kFwdT;
  bf16* sw = nullptr;
  float* sxi = nullptr;
  int grp, phase;
  __device__ MixConvSrcX(const typename Base::Args& m, const ScanFwdArgs& a, long long row,
                         int d_, bool live_)
      : Base(m, a, row, d_, live_, true) {
    grp = threadIdx.x / kFwdThreads;
    phase = grp * (kInT / kXRows);
  }
  static size_t smem_bytes(const typename Base::Args& m) {
    return sizeof(bf16) * kFwdThreads * x_ld(m.Dm) + sizeof(float) * kXRows * kInT * kInLd;
  }
  __device__ void bind_smem(float* p) {
    sw = reinterpret_cast<bf16*>(p);
    sxi = reinterpret_cast<float*>(sw + kFwdThreads * x_ld(Dm)) + grp * kInT * kInLd;
  }
  // Every thread of the block, before its __syncthreads.
  __device__ void stage_block() {
    stage_rows_async(sw, winT, blockIdx.x * kFwdThreads, kFwdThreads, D, Dm, threadIdx.x,
                     kXRows * kFwdThreads);
    cp_async_commit();
    cp_async_wait<0>();
  }
  // xi of processing steps P0 .. P0 + kInT - 1 (zeros outside [0, L)) for
  // the block's channels into the group's sxi: warp w of the group owns
  // steps 16 (w & 1) .. + 15 and channels 64 (w >> 1) .. + 63 (8 tiles),
  // A fragments from x in device memory, B by ldmatrix from sw. The
  // group's threads call it after the chunk's barrier, so every read of
  // the last tile is done; the barrier at its end publishes the tile.
  __device__ void project(int P0) {
    const int tid = threadIdx.x % kFwdThreads, lane = tid & 31, w = tid >> 5;
    const int g = lane >> 2, tq = lane & 3;
    const int r = 16 * (w & 1) + g, ch = 64 * (w >> 1), ld = x_ld(Dm);
    const int pa = P0 + r, pb = pa + 8;
    const bf16* xa =
        pa >= 0 && pa < L ? x + (long long)(reverse ? L - 1 - pa : pa) * Dm + 2 * tq : nullptr;
    const bf16* xb =
        pb >= 0 && pb < L ? x + (long long)(reverse ? L - 1 - pb : pb) * Dm + 2 * tq : nullptr;
    // lane l reads row l & 7 of matrix l >> 3: tile 2j + (l >> 4), k half (l >> 3) & 1
    const bf16* bp = sw + (ch + 8 * (lane >> 4) + (lane & 7)) * ld + 8 * ((lane >> 3) & 1);
    float v[8][4] = {};
    // x in groups of four k-steps, each group's sixteen loads issued before
    // its products, so the group waits for the caches once
    for (int k0 = 0; k0 < Dm; k0 += 4 * 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = k0 + 16 * s;
        const bool in = k < Dm;
        a[s][0] = xa && in ? ld_u32(xa + k) : 0u;
        a[s][1] = xb && in ? ld_u32(xb + k) : 0u;
        a[s][2] = xa && in ? ld_u32(xa + k + 8) : 0u;
        a[s][3] = xb && in ? ld_u32(xb + k + 8) : 0u;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (k0 + 16 * s >= Dm) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bb[4];
          ldsm_x4(bb, bp + 16 * j * ld + k0 + 16 * s);
          mma_bf16(v[2 * j], a[s], bb[0], bb[1]);
          mma_bf16(v[2 * j + 1], a[s], bb[2], bb[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int cc = ch + 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(sxi + r * kInLd + cc) = make_float2(v[nt][0], v[nt][1]);
      *reinterpret_cast<float2*>(sxi + (r + 8) * kInLd + cc) = make_float2(v[nt][2], v[nt][3]);
    }
    group_sync<kXRows>(grp);
  }
  __device__ void x_chunk(int p0, float (&xv)[TC]) {
    const int s = (p0 + phase) % kInT;  // the chunk's first slot in the tile
    if (s == 0 || p0 == 0) project(p0 - s);
    const int tid = threadIdx.x % kFwdThreads;
#pragma unroll
    for (int k = 0; k < TC; ++k)
      win[KT - 1 + k] = (live && p0 + k < L) ? sxi[(s + k) * kInLd + tid] : 0.f;
    this->conv(xv);
  }
};

// FIN: the fuse_in variant (xi is x [Bn, L, Dm], winT w_in^T [D, Dm]);
// otherwise acc and hb select the training variant.
template <typename T, bool FIN>
cudaError_t launch_mixer(const void* xi, const float* conv_w, const float* conv_b,
                         const float* wx, const float* wdt, const float* dt_bias,
                         const float* A, const float* Dskip, float* dbc, void* y, void* acc,
                         float* hb, const void* winT, int Bn, int L, int D, int N, int R, int K,
                         int reverse, int hbc, int Dm, cudaStream_t s) {
  constexpr bool XB = FIN && std::is_same<T, bf16>::value;  // bf16 fuse_in
  const int J = R + 2 * N;
  if (K < 1 || K > kMaxK || J > 16 * 8) return cudaErrorInvalidValue;
  if (hb && (hbc < 1 || hbc > 16 || (hbc & (hbc - 1)))) return cudaErrorInvalidValue;
  if (FIN && (!winT || Dm < 16 || Dm % 16)) return cudaErrorInvalidValue;
  const dim3 grid((L + kXpT - 1) / kXpT, Bn);
  const T* xt = static_cast<const T*>(xi);
  const T* wt = static_cast<const T*>(winT);
  T* at = static_cast<T*>(acc);
  auto launch = [&](auto kern, size_t smem, auto... args) {
    if (smem > 48 * 1024) {
      cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      // all of the SM's shared memory, so that two blocks of (a) fit on one
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      if (e != cudaSuccess) return;  // no launch: cudaGetLastError() reports e
    }
    kern<<<grid, kXpThreads, smem, s>>>(args...);
  };
  if constexpr (XB) {
    // xp_smem_bytes with the window's wider rows, then the x window and w_in^T rows
    const size_t in_bytes = sizeof(float) * (kXpT + kMaxK - 1) * (kXpCld - kXpC) +
                            sizeof(bf16) * (kXWin + kXpC) * x_ld(Dm);
    if (J <= 64)
      launch(conv_xproj_x_kernel<4>, xp_smem_bytes(4, in_bytes), xt, conv_w, conv_b, wx, dbc, wt,
             L, D, K, J, reverse, Dm);
    else
      launch(conv_xproj_x_kernel<8>, xp_smem_bytes(8, in_bytes), xt, conv_w, conv_b, wx, dbc, wt,
             L, D, K, J, reverse, Dm);
  } else if constexpr (FIN) {
    const size_t in_bytes = sizeof(float) * (kXpC + kInRows) * kInLdF;
    if (J <= 64)
      launch(conv_xproj_kernel<T, false, true, 4>, xp_smem_bytes(4, in_bytes), xt, conv_w, conv_b,
             wx, dbc, at, wt, L, D, K, J, reverse, Dm);
    else
      launch(conv_xproj_kernel<T, false, true, 8>, xp_smem_bytes(8, in_bytes), xt, conv_w, conv_b,
             wx, dbc, at, wt, L, D, K, J, reverse, Dm);
  } else if (J <= 64) {
    launch(acc ? conv_xproj_kernel<T, true, false, 4> : conv_xproj_kernel<T, false, false, 4>,
           xp_smem_bytes(4), xt, conv_w, conv_b, wx, dbc, at, wt, L, D, K, J, reverse, Dm);
  } else {
    launch(acc ? conv_xproj_kernel<T, true, false, 8> : conv_xproj_kernel<T, false, false, 8>,
           xp_smem_bytes(8), xt, conv_w, conv_b, wx, dbc, at, wt, L, D, K, J, reverse, Dm);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ScanFwdArgs a;
  a.y = y; a.A = A; a.Dskip = Dskip; a.dt_bias = dt_bias; a.wdt = wdt;
  a.hb = hb; a.h0 = nullptr; a.hfin = nullptr;
  a.L = L; a.D = D; a.R = R; a.reverse = reverse; a.hbc = hbc > 0 ? hbc : 1;
  const MixScanArgs m{xi, conv_w, conv_b, dbc, winT, K, J, Dm};
  if constexpr (XB) {
    return K <= 4 ? launch_scan_fwd<T, MixConvSrcX<4>>(a, m, N, Bn, s)
                  : launch_scan_fwd<T, MixConvSrcX<kMaxK>>(a, m, N, Bn, s);
  } else {
    return K <= 4 ? launch_scan_fwd<T, MixConvSrc<T, 4, FIN>>(a, m, N, Bn, s)
                  : launch_scan_fwd<T, MixConvSrc<T, kMaxK, FIN>>(a, m, N, Bn, s);
  }
}

}  // namespace pc

// wx is [D, 64] when R + 2N <= 64, else [D, 128], zero past R + 2N; dbc
// [Bn, L, R + 2N] float32 receives dt_lr | B | C.
#ifndef PC_MIXER_FUSE_IN
// acc and hb are both null (inference) or both given (training residuals);
// hbc, the hb stride in steps, a power of two <= 16.
extern "C" int pc_mixer_fwd(const void* xi, const float* conv_w, const float* conv_b,
                            const float* wx, const float* wdt, const float* dt_bias,
                            const float* A, const float* Dskip, float* dbc, void* y, void* acc,
                            float* hb, int Bn, int L, int D, int N, int R, int K, int reverse,
                            int bf16, int hbc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pc::launch_mixer<__nv_bfloat16, false>(xi, conv_w, conv_b, wx, wdt, dt_bias, A, Dskip,
                                                  dbc, y, acc, hb, nullptr, Bn, L, D, N, R, K,
                                                  reverse, hbc, 0, s);
  return pc::launch_mixer<float, false>(xi, conv_w, conv_b, wx, wdt, dt_bias, A, Dskip, dbc, y,
                                        acc, hb, nullptr, Bn, L, D, N, R, K, reverse, hbc, 0, s);
}
#else
// fuse_in (inference): x [Bn, L, Dm] (Dm a multiple of 16) and winT, w_in^T
// [D, Dm] in x's dtype.
extern "C" int pc_mixer_fwd_x(const void* x, const float* conv_w, const float* conv_b,
                              const float* wx, const float* wdt, const float* dt_bias,
                              const float* A, const float* Dskip, float* dbc, void* y,
                              const void* winT, int Bn, int L, int D, int N, int R, int K,
                              int reverse, int bf16, int Dm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pc::launch_mixer<__nv_bfloat16, true>(x, conv_w, conv_b, wx, wdt, dt_bias, A, Dskip,
                                                 dbc, y, nullptr, nullptr, winT, Bn, L, D, N, R,
                                                 K, reverse, 0, Dm, s);
  return pc::launch_mixer<float, true>(x, conv_w, conv_b, wx, wdt, dt_bias, A, Dskip, dbc, y,
                                       nullptr, nullptr, winT, Bn, L, D, N, R, K, reverse, 0, Dm,
                                       s);
}
#endif
