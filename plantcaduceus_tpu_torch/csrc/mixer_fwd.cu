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
// rows, never from an xi in device memory: (a) the window of each
// 32-channel pass, its K - 1 halo rows included (recomputed by the
// neighbouring block too), into the pass's float32 xi window in shared
// memory; (b) the scan block's 128 channels over kInT steps at a time into
// a float32 tile in shared memory (MixConvSrc<T, KT, true>), from which
// each thread's conv reads its channel in float32, the window of K - 1 taps
// carried across chunks as for xi given. The products (xi_tiles): a warp
// owns 16 steps x NT 8-channel tiles; w_in^T comes through shared memory
// in chunks of kInK of d_model, staged by the whole block with 16-byte
// copies, and so do (a)'s window rows ((b) reads its x rows through the
// caches); each A fragment serves the NT tiles, so NT product chains run
// side by side. bf16: mma.sync m16n8k16 on the tensor cores with a float32
// accumulator; float32: FMA (the port's float32 contract refuses TF32).
// Every element is one chain over d_model from k = 0 in one order, so (a)
// and (b) compute the same bits for it wherever it sits in a tile. The
// bound at l20 scoring (256 x 512, d_model 384 -> 768, one direction): the
// in_proj is 7.7e10 flops, 0.08 ms on the bf16 tensor cores (1.2 ms as
// fp32 FMA), under the scan's exp2; the kernels do it about twice and a
// tenth (both kernels, and (a)'s halo), and save writing and rereading a
// 201 MB bf16 xi. The products run between the scan's chunks, not beside
// them, each chunk's staging waited for: a simple design, measured at
// about twice xi given's time (PERF.md). fuse_in builds in a unit of its
// own (this file with PC_MIXER_FUSE_IN: pc_mixer_fwd_x),
// beside the other variants (pc_mixer_fwd).
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the dbc scratch comes from the wrapper) and returns
// cudaGetLastError().

#include "scan_core.cuh"

namespace pc {

constexpr int kMaxK = 8;        // conv taps
constexpr int kXpThreads = 256;
constexpr int kXpT = 64;        // time steps per block of (a)
constexpr int kXpTld = kXpT + 4;  // row stride of the transposed xg tile (16-byte rows)
constexpr int kXpC = 32;        // channels per pass of (a)

// (a) shared memory: the xi window [kXpT + K - 1][kXpC], xg^T [kXpC][kXpTld]
// and the W pass [kXpC][16 TN]; with fuse_in (in_bytes) the staged w_in^T
// chunk after them.
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
constexpr int kInK = 64;                // d_model per staged chunk of w_in^T (and of x in (a))
constexpr int kInRows = 80;             // (a)'s staged x window: kXpT + kMaxK - 1 rounded to 16
static_assert(kInRows >= kXpT + kMaxK - 1 && kInRows % 16 == 0, "(a)'s window in 16-row tiles");

// Row stride of a staged w_in^T chunk, in elements: 16-byte rows whose
// fragment reads fall on distinct banks (bf16: 36 words, fp32: 68).
template <typename T>
__host__ __device__ constexpr int in_ldw() { return sizeof(T) == 2 ? kInK + 8 : kInK + 4; }

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ uint32_t lds_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

__device__ __forceinline__ void fma4(float& d, const float4& x, const float4& w) {
  d = fmaf(x.x, w.x, d);
  d = fmaf(x.y, w.y, d);
  d = fmaf(x.z, w.z, d);
  d = fmaf(x.w, w.w, d);
}

// The block stages w_in^T rows c0 .. c0 + rows - 1, d_model k0 .. k0 +
// kInK - 1 (the last chunk may be shorter: Dm is a multiple of 16), into
// sw [rows][in_ldw<T>()], zeros for channels >= D; 16-byte copies.
template <typename T>
__device__ __forceinline__ void stage_w(T* sw, const T* wT, int c0, int rows, int D, int Dm,
                                        int k0) {
  constexpr int kVec = 16 / sizeof(T), kLd = in_ldw<T>();
  const int kc = min(kInK, Dm - k0), per = kc / kVec;
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int r = i / per, v = i % per, c = c0 + r;
    *reinterpret_cast<uint4*>(sw + r * kLd + v * kVec) =
        c < D ? __ldg(reinterpret_cast<const uint4*>(wT + (long long)c * Dm + k0 + v * kVec))
              : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The block stages x rows r = 0 .. kInRows - 1 (step t0 + r; zeros for r
// >= valid or a step outside [0, L)), d_model k0 .. k0 + kInK - 1, into sx
// [kInRows][in_ldw<T>()]; 16-byte copies.
template <typename T>
__device__ __forceinline__ void stage_x(T* sx, const T* xrow, int t0, int valid, int L, int Dm,
                                        int k0) {
  constexpr int kVec = 16 / sizeof(T), kLd = in_ldw<T>();
  const int per = min(kInK, Dm - k0) / kVec;
  for (int i = threadIdx.x; i < kInRows * per; i += blockDim.x) {
    const int r = i / per, v = i % per, t = t0 + r;
    *reinterpret_cast<uint4*>(sx + r * kLd + v * kVec) =
        r < valid && t >= 0 && t < L
            ? __ldg(reinterpret_cast<const uint4*>(xrow + (long long)t * Dm + k0 + v * kVec))
            : make_uint4(0u, 0u, 0u, 0u);
  }
}

// One warp's 16 steps x NT 8-channel tiles of xi = x w_in, a d_model
// chunk of kc added to d. Lane 4g + t holds, for tile nt, xi at (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1): mma m16n8's accumulator
// layout. xr0, xr1: this lane's x rows for tile rows g and g + 8 at the
// chunk's first column, in device memory (null outside [0, L): xi is the
// conv's zero padding there) or, with ASMEM, staged in shared memory; sw:
// the staged w_in^T rows of the NT tiles' channels. bf16: mma.sync over k
// in steps of 16; float32: fmaf over k in order. Each element's chain over
// the chunks in order depends only on its own row and channel.
template <typename T, int NT, bool ASMEM>
__device__ __forceinline__ void xi_tiles(float (&d)[NT][4], const T* xr0, const T* xr1,
                                         const T* sw, int kc) {
  constexpr int kLd = in_ldw<T>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    auto lda = [](const T* p) { return ASMEM ? lds_u32(p) : ld_u32(p); };
#pragma unroll 2
    for (int kk = 2 * t; kk < kc; kk += 16) {
      const uint32_t a[4] = {xr0 ? lda(xr0 + kk) : 0u, xr1 ? lda(xr1 + kk) : 0u,
                             xr0 ? lda(xr0 + kk + 8) : 0u, xr1 ? lda(xr1 + kk + 8) : 0u};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* b = sw + (8 * nt + g) * kLd + kk;
        mma_bf16(d[nt], a, lds_u32(b), lds_u32(b + 8));
      }
    }
  } else {
    const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
    auto ld4 = [](const float* p) {
      return ASMEM ? *reinterpret_cast<const float4*>(p)
                   : __ldg(reinterpret_cast<const float4*>(p));
    };
#pragma unroll 2
    for (int kk = 0; kk < kc; kk += 4) {
      const float4 xa = xr0 ? ld4(xr0 + kk) : z4, xb = xr1 ? ld4(xr1 + kk) : z4;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* b = sw + (8 * nt + 2 * t) * kLd + kk;
        const float4 wa = *reinterpret_cast<const float4*>(b);
        const float4 wb = *reinterpret_cast<const float4*>(b + kLd);
        fma4(d[nt][0], xa, wa);
        fma4(d[nt][1], xa, wb);
        fma4(d[nt][2], xb, wa);
        fma4(d[nt][3], xb, wb);
      }
    }
  }
}

// RES: the training variant, which also writes the pre-SiLU acc. FIN: the
// fuse_in variant, xi being x [rows, L, Dm] and winT w_in^T [D, Dm]. TN:
// x_proj outputs per thread; wx is [D, 16 TN], zero past J.
template <typename T, bool RES, bool FIN, int TN>
__global__ void __launch_bounds__(kXpThreads) conv_xproj_kernel(
    const T* __restrict__ xi, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ wx, float* __restrict__ dbc,
    T* __restrict__ acc_out, const T* __restrict__ winT, int L, int D, int K, int J, int reverse,
    int Dm) {
  extern __shared__ float4 xp_smem4[];
  constexpr int JP = 16 * TN;
  float* sx = reinterpret_cast<float*>(xp_smem4);  // [kXpT + K - 1][kXpC] xi window
  float* sxg = sx + (kXpT + kMaxK - 1) * kXpC;     // [kXpC][kXpTld] xg^T
  float4* sw = reinterpret_cast<float4*>(sxg + kXpC * kXpTld);  // [kXpC][JP / 4] W
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
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
  // fuse_in: staged chunks of w_in^T [kXpC][in_ldw<T>()] and of the x window
  // [kInRows][in_ldw<T>()]
  T* sin = FIN ? reinterpret_cast<T*>(sw + kXpC * JP / 4) : nullptr;
  T* sxin = FIN ? sin + kXpC * in_ldw<T>() : nullptr;

  for (int c0 = 0; c0 < D; c0 += kXpC) {
    if constexpr (FIN) {
      // the pass's xi window from staged chunks of the window's x rows and
      // of w_in^T: warp w < 5 owns window rows 16w .. 16w + 15 and the
      // pass's 32 channels
      constexpr int kLd = in_ldw<T>();
      const int w = tid >> 5, g = (tid & 31) >> 2, tq = tid & 3;
      const int ra = 16 * w + g, rb = ra + 8;
      const bool busy = 16 * w < win;
      float v[kXpC / 8][4] = {};
      for (int k0 = 0; k0 < Dm; k0 += kInK) {
        stage_w<T>(sin, winT, c0, kXpC, D, Dm, k0);
        stage_x<T>(sxin, xrow, tbase, win, L, Dm, k0);
        __syncthreads();
        if (busy)
          xi_tiles<T, kXpC / 8, true>(v, sxin + ra * kLd, sxin + rb * kLd, sin,
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
    {  // this thread's channel of the pass, its taps in the conv's order
      const int ch = tid % kXpC, c = c0 + ch;
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
            if (k < K) s = fmaf(sx[(tt + k) * kXpC + ch], wr[k], s);
          v = silu_xg(s);
          if constexpr (RES) acc_out[(b * L + t) * D + c] = from_f<T>(s);  // pre-SiLU
        }
        sxg[ch * kXpTld + tt] = v;
      }
    }
    __syncthreads();
    const float* swf = reinterpret_cast<const float*>(sw);
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
    __syncthreads();  // sx, sxg and sw are rewritten by the next pass
  }
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

struct MixScanArgs {
  const void* xi;        // [rows, L, D], or x [rows, L, Dm] with fuse_in
  const float* conv_w;   // [D, K]
  const float* conv_b;   // [D]
  const float* dbc;      // [rows, L, J]: dt_lr | B | C, J = R + 2N
  const void* winT;      // w_in^T [D, Dm] (fuse_in), or null
  int K, J, Dm;
};

// (b)'s input policy for scan_core.cuh's scan_fwd_kernel: xg by the conv
// from a window of xi taps carried across chunks, the B | C | dt_lr rows
// from (a)'s dbc. KT: registers for the conv taps (K <= KT; the K given taps
// in the conv's order, zero taps around them, which leaves every sum as it
// is). FIN: the fuse_in variant, xi from x and w_in^T through a float32
// [kInT][kInLd] tile in shared memory, kInT steps (processing order) at a
// time.
template <typename T, int KT, bool FIN = false>
struct MixConvSrc {
  using Args = MixScanArgs;
  using Raw = float;
  static constexpr bool kFuse = true, kHb = !FIN, kCombine = false;
  // sxi [kInT][kInLd] float32, then the staged w_in^T chunk [128][in_ldw<T>()]
  static constexpr int kSmemFloats =
      FIN ? kInT * kInLd + kFwdThreads * in_ldw<T>() * (int)sizeof(T) / 4 : 0;
  static constexpr int TC = kFwdT;
  const T* x;
  const T* winT;
  const float* dbc;
  float* sxi = nullptr;
  int L, D, J, Dm, d, reverse;
  bool live;
  float cb;
  // Taps in window order: the window's slot KT - 1 + k is this chunk's step
  // k in processing order (u[p] = x[time_of(p)], 0 before the start), so a
  // causal step reads slots k .. k + KT - 1 oldest first and a reverse step
  // reads them newest first, each in the conv's order.
  float wt[KT], win[KT - 1 + TC];
  __device__ MixConvSrc(const Args& m, const ScanFwdArgs& a, long long row, int d_, bool live_)
      : L(a.L), D(a.D), J(m.J), Dm(m.Dm), d(d_), reverse(a.reverse), live(live_) {
    x = static_cast<const T*>(m.xi) + row * L * (FIN ? Dm : D);
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
  __device__ void bind_smem(float* p) { sxi = p; }
  // fuse_in: xi of processing steps P0 .. P0 + kInT - 1 for the block's
  // channels into sxi: warp w owns steps 16 (w & 1) .. + 15 and channels
  // 64 (w >> 1) .. + 63 (8 tiles). Every thread of the block calls it,
  // between two barriers.
  __device__ void project(int P0) {
    static_assert(kInT == 32 && kFwdThreads == 128, "4 warps: 2 x 16 steps, 2 x 64 channels");
    __syncthreads();  // every thread's reads of the last tile are done
    T* sin = reinterpret_cast<T*>(sxi + kInT * kInLd);
    const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
    const int r = 16 * (w & 1) + g, ch = 64 * (w >> 1), d0 = d - threadIdx.x;
    const int pa = P0 + r, pb = pa + 8;
    const T* xa = pa < L ? x + (long long)(reverse ? L - 1 - pa : pa) * Dm : nullptr;
    const T* xb = pb < L ? x + (long long)(reverse ? L - 1 - pb : pb) * Dm : nullptr;
    float v[8][4] = {};
    for (int k0 = 0; k0 < Dm; k0 += kInK) {
      stage_w<T>(sin, winT, d0, kFwdThreads, D, Dm, k0);
      __syncthreads();
      xi_tiles<T, 8, false>(v, xa ? xa + k0 : nullptr, xb ? xb + k0 : nullptr,
                            sin + ch * in_ldw<T>(), min(kInK, Dm - k0));
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
  // The chunk's xg: the conv of each step in order, then the window moves on.
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

// FIN: the fuse_in variant (xi is x [Bn, L, Dm], winT w_in^T [D, Dm]);
// otherwise acc and hb select the training variant.
template <typename T, bool FIN>
cudaError_t launch_mixer(const void* xi, const float* conv_w, const float* conv_b,
                         const float* wx, const float* wdt, const float* dt_bias,
                         const float* A, const float* Dskip, float* dbc, void* y, void* acc,
                         float* hb, const void* winT, int Bn, int L, int D, int N, int R, int K,
                         int reverse, int hbc, int Dm, cudaStream_t s) {
  const int J = R + 2 * N;
  if (K < 1 || K > kMaxK || J > 16 * 8) return cudaErrorInvalidValue;
  if (hb && (hbc < 1 || hbc > 16 || (hbc & (hbc - 1)))) return cudaErrorInvalidValue;
  if (FIN && (!winT || Dm < 16 || Dm % 16)) return cudaErrorInvalidValue;
  const dim3 grid((L + kXpT - 1) / kXpT, Bn);
  const T* xt = static_cast<const T*>(xi);
  const T* wt = static_cast<const T*>(winT);
  T* at = static_cast<T*>(acc);
  auto launch = [&](auto kern, size_t smem) {
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return;  // no launch: cudaGetLastError() reports e
    }
    kern<<<grid, kXpThreads, smem, s>>>(xt, conv_w, conv_b, wx, dbc, at, wt, L, D, K, J, reverse,
                                        Dm);
  };
  if constexpr (FIN) {
    const size_t in_bytes = sizeof(T) * (kXpC + kInRows) * in_ldw<T>();
    if (J <= 64) launch(conv_xproj_kernel<T, false, true, 4>, xp_smem_bytes(4, in_bytes));
    else launch(conv_xproj_kernel<T, false, true, 8>, xp_smem_bytes(8, in_bytes));
  } else if (J <= 64) {
    launch(acc ? conv_xproj_kernel<T, true, false, 4> : conv_xproj_kernel<T, false, false, 4>,
           xp_smem_bytes(4));
  } else {
    launch(acc ? conv_xproj_kernel<T, true, false, 8> : conv_xproj_kernel<T, false, false, 8>,
           xp_smem_bytes(8));
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ScanFwdArgs a;
  a.y = y; a.A = A; a.Dskip = Dskip; a.dt_bias = dt_bias; a.wdt = wdt;
  a.hb = hb; a.h0 = nullptr; a.hfin = nullptr;
  a.L = L; a.D = D; a.R = R; a.reverse = reverse; a.hbc = hbc > 0 ? hbc : 1;
  const MixScanArgs m{xi, conv_w, conv_b, dbc, winT, K, J, Dm};
  return K <= 4 ? launch_scan_fwd<T, MixConvSrc<T, 4, FIN>>(a, m, N, Bn, s)
                : launch_scan_fwd<T, MixConvSrc<T, kMaxK, FIN>>(a, m, N, Bn, s);
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
