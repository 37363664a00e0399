// K5 — the Mamba-2 mixer interior, one direction.
//
// Replaces plantcaduceus_tpu/ops/pallas_mixer2.py::_fused_kernel with
// _conv_acc (launched at pallas_mixer2.py:179 through _interior_pallas_call /
// mamba2_mixer_interior):
//   xc, Bc, Cc = silu(depthwise conv K taps + bias) of xi, Braw, Craw
//                (causal, or anticausal for reverse; taps and biases rounded
//                to xi's dtype, sums in float32)
//   y          = K4's chunk math (ssd_core.cuh) over xc, dt, Bc, Cc, float32
//   u          = rmsnorm(y * silu(z)) * nw over d_inner, cast to xi's dtype.
// The training variant (emit_residuals, a template parameter kRes) also
// writes what K6 (ssd_bwd.cu, pre_silu mode) and the gated-norm adjoint
// need: the pre-SiLU conv accumulators accx, accB, accC and the pre-gate y
// (with the D-skip), all in xi's dtype as the TPU kernel emits them, and the
// float32 chunk-entry states fentry [R, L/128, N, d_inner].
//
// The TPU kernel walks the chunks of a row in order with the state of all
// heads in VMEM. Here the only serial part is the state's recurrence, and it
// is elementwise once each chunk's increment is known, so K5 is five kernels
// on one stream, with no atomics (two launches give equal bits):
//  (-) mixer2_act_kernel, per (row, chunk, group): SiLU of the B and C convs
//      once, into copies in xi's dtype (scratch Ba, Ca) that every head of
//      the group stages; the pre-SiLU accB, accC with kRes.
//  (a) mixer2_state_kernel, per (row, chunk, head), all chunks but the last
//      processed one at once: the increment B^T (x dt' exp2(outof)) [N, P]
//      into the chunk's slot of the state buffer fe [R, L/128, N, d_inner]
//      (fentry's layout) and the chunk's total decay into tot.
//  (b) mixer2_pass_kernel, per four elements of a row's state: S = exp2(total)
//      S + increment over the chunks in processing order, in place, so each
//      slot ends holding the state entering its chunk: fentry itself (the
//      inference variant's fe is scratch).
//  (c) mixer2_chunk_kernel, per (row, chunk, head), all chunks at once: C B^T,
//      the masked scores, y = (C S) exp2(into) + scores (x dt') + D x, the
//      gate v = y silu(z) into the float32 scratch u, and the sum of v^2 over
//      the head's P channels per step (each in a fixed order).
//  (d) gated_norm_kernel, per (row, t): the heads' sums of v^2 in head order,
//      rsqrt, * nw, cast. The norm spans all heads' channels, so a per-head
//      block cannot finish it; u makes one float32 round trip. (Finishing it
//      in (c) with the H heads' blocks as one thread-block cluster, the sums
//      exchanged through distributed shared memory, runs slower on the H100:
//      PERF.md.)
// bfloat16 runs (a) and (c) on wgmma over tiles in the layout ssd_sm90.cuh
// sets out (two in (a); four in (c): C, B then the scores, x dt', the state);
// float32 on ssd_core.cuh's FMA block products over reused [128][LD] tiles.
// x's conv is staged straight into the tiles of (a) and (c): each thread
// walks eight steps of eight channels with the taps and its input rows in
// registers (16-byte loads, all issued first), so nothing of it reaches
// device memory but accx. (Evaluating the conv wherever the chunk core
// reads a value, with scalar loads at one block per SM, runs 2.4x slower
// than a float32 pre-pass on the H100; PERF.md.)
//
// Numerics as ssd_core.cuh: every decay, the state and every sum in float32;
// product operands in E (bfloat16 for bfloat16 inputs, else float32),
// the state rounded to E only as the operand of C S; segment sums masked
// before exp2. The float32 variant keeps FMA products (no TF32). Conv taps
// and biases are rounded to xi's dtype here, the sums in float32. SiLU uses
// the fast exponential and division (a few float32 ulps from torch's).
//
// What bounds it on an H100: the bytes of xi, z, Braw, Craw, dt in and u out
// (0.2 GB in bf16 at the l20-ssd scoring shape, 256 x 512 x 768) ahead of the
// products (~82 GFLOP: 0.08 ms on the bf16 tensor cores). This design adds
// float32 traffic: the state buffer (written by (a), read and written by (b),
// read by (c): about 1.3 GB at l20-ssd scoring, 0.33 GB at training, where
// fentry must be written anyway) and u's round trip (0.4 GB each way at
// scoring). (c) runs one block of eight warps per SM (197 KB of shared
// memory), so its staging, products and epilogue do not overlap.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the scratch comes from the wrapper) and returns cudaGetLastError().

#include "ssd_sm90.cuh"

namespace pc {

constexpr int kMaxTaps = 8;
constexpr int kNormRows = 8;      // (row, t) pairs per block of (d), a warp each
constexpr int kPassThreads = 256;
constexpr int kXsLd = kSsdP + 4;  // row stride of (c)'s float32 x tile in bfloat16

// Eight float values to T at p (16-byte aligned).
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
  if constexpr (std::is_same<T, float>::value) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        pack2(__float2bfloat16(v[0]), __float2bfloat16(v[1])),
        pack2(__float2bfloat16(v[2]), __float2bfloat16(v[3])),
        pack2(__float2bfloat16(v[4]), __float2bfloat16(v[5])),
        pack2(__float2bfloat16(v[6]), __float2bfloat16(v[7])));
  }
}

// SiLU with the fast exponential and division (within a few float32 ulps
// of torch's silu).
__device__ __forceinline__ float silu_f(float a) { return __fdividef(a, 1.f + __expf(-a)); }

// The pre-SiLU conv of a 128-step x 128-channel block at steps t0..t0+127:
// acc(r, c) = sum_k in[t - dir*(K-1-k), c] * w[c, k] + b[c] for t = t0 + r,
// dir = +1 (causal) or -1 (reverse), inputs past the sequence's edges 0: the
// TPU kernel's tap order (pallas_mixer2.py:_conv_acc), tap K-1 the current
// step. `in` is the row's [L, C] input at the block's first channel, w its
// [C, K] float32 taps and b its biases, both at that channel, each rounded
// to T here. Thread u owns channels 8(u % 16) .. +8 and walks the eight steps
// 8(u / 16) .. +8 in direction dir with the KT >= K taps (the K given ones
// last, zeros before them, which leaves every sum bit for bit as it is),
// its KT + 7 input rows loaded into registers before the first is used;
// out(r, c0, acc) receives the eight sums of (r, c0 .. c0+7). Every thread
// calls it.
template <int KT, typename T, class Out>
__device__ __forceinline__ void conv_block(const T* __restrict__ in, int C,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b, int K, int L, int t0,
                                           int reverse, Out out) {
  const int c0 = (threadIdx.x & 15) * 8, run = threadIdx.x >> 4;
  const int dir = reverse ? -1 : 1;
  float wk[KT][8], bias[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    bias[e] = round_to<T>(b[c0 + e]);
#pragma unroll
    for (int k = 0; k < KT; ++k)
      wk[k][e] = k < KT - K ? 0.f : round_to<T>(w[(c0 + e) * K + k - (KT - K)]);
  }
  const int r0 = reverse ? 8 * run + 7 : 8 * run;  // the first row walked
  // every input row of the walk, loaded before the first is used
  constexpr int NW = KT - 1 + 8, V = std::is_same<T, float>::value ? 2 : 1;
  uint4 raw[NW][V];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int s = t0 + r0 + dir * (j - (KT - 1));
#pragma unroll
    for (int v = 0; v < V; ++v)
      raw[j][v] = (s >= 0 && s < L)
                      ? __ldg(reinterpret_cast<const uint4*>(in + (long long)s * C + c0) + v)
                      : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < KT; ++k)
        a = fmaf(vec_at<T>(raw[i + k][e * V / 8], e % (8 / V)), wk[k][e], a);
      acc[e] = a + bias[e];
    }
    out(r0 + dir * i, c0, acc);
  }
}

// The arguments every kernel of a launch shares.
template <typename T>
struct Mixer2Args {
  const T* xi;   // [R, L, di]
  const T* z;    // [R, L, di]
  const T* Bm;   // [R, L, NG*N] raw (before the conv)
  const T* Cm;
  const T* dt;   // [R, L, H] raw
  const float *cxw, *cxb, *cbw, *cbb, *ccw, *ccb;  // taps [C, K] and biases
  const float *A, *Dskip, *dt_bias;                // [H]
  float* fe;     // [R, L/128, N, di]: increments, then the entry states
  float* tot;    // [R, L/128, H] chunk total decays
  float* u;      // [R, L, di] float32 v = y * silu(z)
  float* part;   // [R, L, H, parts] sums of v^2
  T *Ba, *Ca;    // [R, L, NG*N] SiLU of the B and C convs
  T *accx, *accB, *accC, *yres;  // residuals (kRes)
  int L, H, NG, K, reverse;
};

// (-) mixer2_act_kernel, per (row, chunk, group): SiLU of the B and C convs
// once, into T copies (Ba, Ca) that every head of the group stages (they
// are product operands, so rounding them to T is the rounding the tiles
// would do); the pre-SiLU accumulators accB, accC with kRes.
template <typename T, bool kRes, int KT>
__global__ void __launch_bounds__(kSsdThreads) mixer2_act_kernel(Mixer2Args<T> a) {
  const int g = blockIdx.x, t0 = blockIdx.y * kSsdT;
  const long long r = blockIdx.z;
  const int NGN = a.NG * kSsdN;
  const long long o0 = r * a.L * NGN + g * kSsdN;  // (row r, step 0, group g)
  auto act = [&](const T* in, const float* w, const float* b, T* out, T* acc) {
    conv_block<KT>(in + o0, NGN, w + g * kSsdN * a.K, b + g * kSsdN, a.K, a.L, t0, a.reverse,
                   [&](int i, int c0, const float (&v)[8]) {
                     const long long o = o0 + (long long)(t0 + i) * NGN + c0;
                     if constexpr (kRes) store8(acc + o, v);
                     float y[8];
#pragma unroll
                     for (int e = 0; e < 8; ++e) y[e] = silu_f(v[e]);
                     store8(out + o, y);
                   });
  };
  act(a.Bm, a.cbw, a.cbb, a.Ba, a.accB);
  act(a.Cm, a.ccw, a.ccb, a.Ca, a.accC);
}

// Stage a 128 x 128 float32 block (row stride `stride` elements) into a
// [128][LD] tile of ssd_core.cuh's float32 layout: 16-byte loads, sixteen a
// thread, all issued before the first store. Every thread calls it; the
// caller syncs.
__device__ __forceinline__ void stage_tile(float* tile, const float* __restrict__ src,
                                           long long stride) {
  constexpr int LD = SsdLd<float>::v;
  float4 v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int u = threadIdx.x + k * kSsdThreads;
    v[k] = __ldg(reinterpret_cast<const float4*>(src + (u >> 5) * stride + (u & 31) * 4));
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int u = threadIdx.x + k * kSsdThreads;
    float* t = tile + (u >> 5) * LD + (u & 31) * 4;
    t[0] = v[k].x; t[1] = v[k].y; t[2] = v[k].z; t[3] = v[k].w;
  }
}

// The accumulator layout of ssd_core.cuh's Tile (float32): rows row(i), i <
// 4, column pairs cb + 8j + 2q (+1), j < 8; two warps share a row.
struct TileFrag {
  static constexpr int NI = 4, NJ = 8, kParts = 2;
  Tile tl;
  int q;
  __device__ TileFrag() { q = tl.q; }
  __device__ int row(int i) const { return tl.row(i); }
  __device__ int col(int j) const { return tl.col(2 * j); }
  __device__ int part() const { return tl.part(); }
  __device__ static float& at(float (&acc)[4][16], int i, int j, int e) {
    return acc[i][2 * j + e];
  }
};

// The accumulator layout of wgmma m64n128 (ssd_sm90.cuh): rows row(i), i <
// 2, column pairs 8j + 2q (+1), j < 16; a row's columns lie in one quad.
struct WgFrag {
  static constexpr int NI = 2, NJ = 16, kParts = 1;
  int wg, wi, g, q;
  __device__ WgFrag() {
    const int tid = threadIdx.x, lane = tid & 31;
    wg = tid >> 7;
    wi = (tid >> 5) & 3;
    g = lane >> 2;
    q = lane & 3;
  }
  __device__ int row(int i) const { return 64 * wg + 16 * wi + g + 8 * i; }
  __device__ int col(int j) const { return 8 * j + 2 * q; }
  __device__ int part() const { return 0; }
  __device__ static float& at(float (&acc)[16][4], int i, int j, int e) {
    return acc[j][2 * i + e];
  }
};

// (a): one (row, chunk, head)'s increment B^T (x dt' exp2(outof)) into its
// slot of fe, and the chunk's total decay. blockIdx.y counts the chunks in
// processing order, all but the last. In float32: tiles of ssd_core.cuh's
// layout and its FMA block product.
template <int KT>
__global__ void __launch_bounds__(kSsdThreads, 2) mixer2_state_kernel(Mixer2Args<float> a) {
  using T = float;
  extern __shared__ __align__(16) unsigned char m2_smem[];
  constexpr int LD = SsdLd<T>::v;
  const int h = blockIdx.x, nc = a.L / kSsdT;
  const int c = a.reverse ? nc - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const long long r = blockIdx.z;
  const int t0 = c * kSsdT, di = a.H * kSsdP, NGN = a.NG * kSsdN;
  const int g = h / (a.H / a.NG);
  float* dtp = reinterpret_cast<float*>(m2_smem);  // [T] dt'
  float* segb = dtp + kSsdT;                        // [T] sb (unused here)
  float* into_e = segb + kSsdT;                     // [T] exp2(into) (unused here)
  float* scale = into_e + kSsdT;                    // [T] exp2(outof)
  float* total_s = scale + kSsdT;                   // [1] total
  T* tb = reinterpret_cast<T*>(total_s + 32);       // [T][LD] B
  T* tx = tb + kSsdT * LD;                          // [T][LD] x dt' exp2(outof)
  const DtSrc<T> ds{a.dt + r * a.L * a.H + h, a.H};
  chunk_decays(ds, t0, a.A[h] * kLog2e, a.dt_bias[h], a.reverse, dtp, segb, into_e, scale,
               total_s);
  stage_tile(tb, a.Ba + (r * a.L + t0) * NGN + g * kSsdN, NGN);
  conv_block<KT>(a.xi + r * a.L * di + h * kSsdP, di, a.cxw + h * kSsdP * a.K,
                 a.cxb + h * kSsdP, a.K, a.L, t0, a.reverse,
                 [&](int i, int c0, const float (&v)[8]) {
#pragma unroll
                   for (int e = 0; e < 8; ++e)
                     tx[i * LD + c0 + e] = from_f<T>(silu_f(v[e]) * dtp[i] * scale[i]);
                 });
  __syncthreads();
  const Tile tl;
  float acc[4][16];
  zero(acc);
  block_mm<true, false, float>(acc, tl, tb, LD, tx, LD);
  float* o = a.fe + (r * nc + c) * kSsdN * di + h * kSsdP;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; j += 2)
      *reinterpret_cast<float2*>(o + (long long)tl.row(i) * di + tl.col(j)) =
          make_float2(acc[i][j], acc[i][j + 1]);
  if (threadIdx.x == 0) a.tot[(r * nc + c) * a.H + h] = total_s[0];
}

inline size_t state_smem() {
  return sizeof(float) * (4 * kSsdT + 32 + 2 * kSsdT * SsdLd<float>::v);
}

// (a) in bfloat16 on wgmma: the B tile and the decayed x tile in the layout
// wgmma reads (ssd_sm90.cuh), the product B^T (x dt' exp2(outof)) with the
// B tile read MN-major.
template <int KT>
__global__ void __launch_bounds__(kSsdThreads, 2) mixer2_state_wg_kernel(Mixer2Args<bf16> a) {
  extern __shared__ __align__(1024) unsigned char m2_st_smem[];
  const int h = blockIdx.x, nc = a.L / kSsdT;
  const int c = a.reverse ? nc - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const long long r = blockIdx.z;
  const int t0 = c * kSsdT, di = a.H * kSsdP, NGN = a.NG * kSsdN;
  const int g = h / (a.H / a.NG);
  unsigned char *tB = m2_st_smem, *tX = tB + kWgTileBytes;
  float* dtp = reinterpret_cast<float*>(tX + kWgTileBytes);  // [T] dt'
  float* segb = dtp + kSsdT;                                  // [T] sb (unused here)
  float* into_e = segb + kSsdT;                               // [T] exp2(into) (unused here)
  float* scale = into_e + kSsdT;                              // [T] exp2(outof)
  float* total_s = scale + kSsdT;                             // [1] total
  const DtSrc<bf16> ds{a.dt + r * a.L * a.H + h, a.H};
  chunk_decays(ds, t0, a.A[h] * kLog2e, a.dt_bias[h], a.reverse, dtp, segb, into_e, scale,
               total_s);
  wg_stage(tB, a.Ba + (r * a.L + t0) * NGN + g * kSsdN, NGN, [](int, float v) { return v; });
  conv_block<KT>(a.xi + r * a.L * di + h * kSsdP, di, a.cxw + h * kSsdP * a.K,
                 a.cxb + h * kSsdP, a.K, a.L, t0, a.reverse,
                 [&](int i, int c0, const float (&v)[8]) {
                   float xs[8];
#pragma unroll
                   for (int e = 0; e < 8; ++e) xs[e] = silu_f(v[e]) * dtp[i] * scale[i];
                   store8(reinterpret_cast<bf16*>(tX + wg_off(i, c0)), xs);
                 });
  fence_async_smem();
  __syncthreads();
  const WgFrag fr;
  float acc[16][4];
  wg_mm<true, false>(acc, smem_u32(tB), smem_u32(tX), fr.wg, false);
  float* o = a.fe + (r * nc + c) * kSsdN * di + h * kSsdP;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(o + (long long)fr.row(i) * di + fr.col(j)) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
  if (threadIdx.x == 0) a.tot[(r * nc + c) * a.H + h] = total_s[0];
}

inline size_t state_wg_smem() { return 2 * kWgTileBytes + sizeof(float) * (4 * kSsdT + 32); }

// (b): per four neighbouring elements of a row's state [N, di], S = exp2(total)
// S + increment over the chunks in processing order (reverse: from the last
// chunk), in place: each chunk's slot ends holding the state entering it (0
// for the first). Four chunks' increments are loaded at once.
__global__ void __launch_bounds__(kPassThreads) mixer2_pass_kernel(
    float* __restrict__ fe, const float* __restrict__ tot, long long n4, int nc, int H,
    int reverse) {
  const long long e = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= n4) return;
  const int di = H * kSsdP;
  const long long row4 = (long long)kSsdN * di / 4;  // float4s of one chunk's state
  const long long r = e / row4;
  const long long o4 = e % row4;
  const int h = (int)((o4 * 4) % di) / kSsdP;
  auto chunk = [&](int k) { return reverse ? nc - 1 - k : k; };
  auto slot = [&](int k) {
    return reinterpret_cast<float4*>(fe + (r * nc + chunk(k)) * kSsdN * di) + o4;
  };
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < nc; k0 += 4) {
    float4 inc[4];
    float te[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (k0 + u < nc - 1) {  // the last chunk's increment was never written
        inc[u] = *slot(k0 + u);
        te[u] = exp2f(tot[(r * nc + chunk(k0 + u)) * H + h]);
      }
    }
    float4 out[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      out[u] = s;
      if (k0 + u < nc - 1)
        s = make_float4(te[u] * s.x + inc[u].x, te[u] * s.y + inc[u].y, te[u] * s.z + inc[u].z,
                        te[u] * s.w + inc[u].w);
    }
    // stored in descending address order: in ascending order (the forward
    // direction's processing order) this kernel runs 2.7x slower on the H100
#pragma unroll
    for (int u = 3; u >= 0; --u) {
      const int k = reverse ? k0 + 3 - u : k0 + u;
      if (k < nc) *slot(k) = out[k - k0];
    }
  }
}

// z at a thread's accumulator positions, loaded ahead of the epilogue
// (before the last product, so the loads overlap it): raw pairs.
template <typename T, class Fr>
struct ZPairs {
  using W = std::conditional_t<std::is_same<T, float>::value, float2, uint32_t>;
  W w[Fr::NI][Fr::NJ];
  __device__ void load(const T* z, const Fr& fr, int di) {
#pragma unroll
    for (int i = 0; i < Fr::NI; ++i)
#pragma unroll
      for (int j = 0; j < Fr::NJ; ++j)
        w[i][j] = __ldg(reinterpret_cast<const W*>(z + (long long)fr.row(i) * di + fr.col(j)));
  }
  __device__ float2 get(int i, int j) const {
    if constexpr (std::is_same<T, float>::value) return w[i][j];
    else return make_float2(__uint_as_float(w[i][j] << 16), __uint_as_float(w[i][j] & 0xffff0000u));
  }
};

// The epilogue of (c) over one thread's part of the [T, P] output, in either
// accumulator layout (Fr): y = acc + D x (x from the float32 tile xs, row
// stride xld), the residual y (kRes), v = y silu(z) into u, and per row the
// sum of v^2 over this thread's columns, then its quad, into part at the
// layout's column part. o0: the element offset of (row r, step t0, head h's
// first channel) in the [R, L, di] tensors; p0: that of (r, t0, h, 0) in part.
template <typename T, bool kRes, class Fr, class Acc>
__device__ __forceinline__ void mixer2_epilogue(const Mixer2Args<T>& a, const Fr& fr, Acc& acc,
                                                const ZPairs<T, Fr>& zp, const float* xs,
                                                int xld, float D, long long o0, long long p0,
                                                int di) {
  float* u = a.u + o0;
#pragma unroll
  for (int i = 0; i < Fr::NI; ++i) {
    const int t = fr.row(i);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < Fr::NJ; ++j) {
      const int p = fr.col(j);
      const float2 zz = zp.get(i, j);
      float y[2], v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        y[e] = Fr::at(acc, i, j, e) + xs[t * xld + p + e] * D;
        v[e] = y[e] * silu_f(e ? zz.y : zz.x);
        ss = fmaf(v[e], v[e], ss);
      }
      if constexpr (kRes) {
        T* yr = a.yres + o0 + (long long)t * di + p;
        if constexpr (std::is_same<T, float>::value)
          *reinterpret_cast<float2*>(yr) = make_float2(y[0], y[1]);
        else
          *reinterpret_cast<uint32_t*>(yr) = pack2(__float2bfloat16(y[0]), __float2bfloat16(y[1]));
      }
      *reinterpret_cast<float2*>(u + (long long)t * di + p) = make_float2(v[0], v[1]);
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    if (fr.q == 0) a.part[p0 + (long long)t * a.H * Fr::kParts + fr.part()] = ss;
  }
}

// Two 128 x 128 blocks of bfloat16 (row strides sa, sb) into two tiles of
// ssd_sm90.cuh's layout, all sixteen 16-byte loads of a thread issued before
// the first store; ends with the proxy fence (the caller syncs).
__device__ __forceinline__ void wg_stage_two(unsigned char* ta, const bf16* __restrict__ a,
                                             long long sa, unsigned char* tb,
                                             const bf16* __restrict__ b, long long sb) {
  uint4 va[8], vb[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int u = threadIdx.x + k * kSsdThreads, r = u >> 4, c0 = (u & 15) * 8;
    va[k] = __ldg(reinterpret_cast<const uint4*>(a + r * sa + c0));
    vb[k] = __ldg(reinterpret_cast<const uint4*>(b + r * sb + c0));
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int u = threadIdx.x + k * kSsdThreads, r = u >> 4, c0 = (u & 15) * 8;
    *reinterpret_cast<uint4*>(ta + wg_off(r, c0)) = va[k];
    *reinterpret_cast<uint4*>(tb + wg_off(r, c0)) = vb[k];
  }
  fence_async_smem();
}

// Where a (row, chunk, head) block of (c) starts in each tensor.
struct ChunkAt {
  long long r, o0, p0, bc0, fe0;
  int h, c, g, t0, nc, di, NGN;
  bool first;
  template <typename T>
  __device__ ChunkAt(const Mixer2Args<T>& a, int parts) {
    h = blockIdx.x;
    c = blockIdx.y;
    r = blockIdx.z;
    nc = a.L / kSsdT;
    t0 = c * kSsdT;
    di = a.H * kSsdP;
    NGN = a.NG * kSsdN;
    g = h / (a.H / a.NG);
    o0 = (r * a.L + t0) * di + h * kSsdP;
    p0 = ((r * a.L + t0) * a.H + h) * parts;
    bc0 = (r * a.L) * NGN + g * kSsdN;  // at step 0 of the row
    fe0 = (r * nc + c) * kSsdN * di + h * kSsdP;
    first = c == (a.reverse ? nc - 1 : 0);  // the entry state is 0
  }
};

// (c) in float32: three [128][LD] tiles, reused: C then x dt'; B then the
// scores; the state then x (float32, for the D-skip).
template <bool kRes, int KT>
__global__ void __launch_bounds__(kSsdThreads, 1) mixer2_chunk_kernel(Mixer2Args<float> a) {
  using T = float;
  extern __shared__ __align__(16) unsigned char m2_smem[];
  constexpr int LD = SsdLd<T>::v;
  const ChunkAt at(a, 2);
  const int tid = threadIdx.x;
  float* dtp = reinterpret_cast<float*>(m2_smem);
  float* segb = dtp + kSsdT;
  float* into_e = segb + kSsdT;
  float* scale = into_e + kSsdT;
  float* total_s = scale + kSsdT;
  T* t1 = reinterpret_cast<T*>(total_s + 32);
  T* t2 = t1 + kSsdT * LD;
  T* t3 = t2 + kSsdT * LD;
  const Tile tl;
  const DtSrc<T> ds{a.dt + at.r * a.L * a.H + at.h, a.H};
  chunk_decays(ds, at.t0, a.A[at.h] * kLog2e, a.dt_bias[at.h], a.reverse, dtp, segb, into_e,
               scale, total_s);
  stage_tile(t1, a.Ca + at.bc0 + (long long)at.t0 * at.NGN, at.NGN);
  stage_tile(t2, a.Ba + at.bc0 + (long long)at.t0 * at.NGN, at.NGN);
  __syncthreads();
  float acc[4][16];
  zero(acc);
  block_mm<false, true, float>(acc, tl, t1, LD, t2, LD);  // C B^T
  __syncthreads();  // every read of B is done
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tl.row(i);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int s = tl.col(j);
      const bool keep = a.reverse ? t <= s : t >= s;
      const float seg = keep ? segb[t] - segb[s] : __uint_as_float(0xff800000u);  // -inf
      t2[t * LD + s] = from_f<T>(acc[i][j] * exp2f(seg));
    }
  }
  zero(acc);
  if (!at.first) {
    const float* fe = a.fe + at.fe0;
    for (int e = tid; e < kSsdN * kSsdP; e += kSsdThreads)
      t3[(e >> 7) * LD + (e & 127)] = from_f<T>(fe[(long long)(e >> 7) * at.di + (e & 127)]);
    __syncthreads();
    block_mm<false, false, T>(acc, tl, t1, LD, t3, LD);  // C S
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float f = into_e[tl.row(i)];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] *= f;
    }
  }
  __syncthreads();  // every read of C and S is done; the scores are written
  conv_block<KT>(a.xi + at.o0 - (long long)at.t0 * at.di, at.di, a.cxw + at.h * kSsdP * a.K,
                 a.cxb + at.h * kSsdP, a.K, a.L, at.t0, a.reverse,
                 [&](int i, int c0, const float (&v)[8]) {
                   if constexpr (kRes) store8(a.accx + at.o0 + (long long)i * at.di + c0, v);
#pragma unroll
                   for (int e = 0; e < 8; ++e) {
                     const float x = silu_f(v[e]);
                     t1[i * LD + c0 + e] = from_f<T>(x * dtp[i]);
                     t3[i * LD + c0 + e] = x;
                   }
                 });
  __syncthreads();
  block_mm<false, false, float>(acc, tl, t2, LD, t1, LD);  // += scores (x dt')
  const TileFrag fr;
  ZPairs<T, TileFrag> zp;
  zp.load(a.z + at.o0, fr, at.di);
  mixer2_epilogue<T, kRes>(a, fr, acc, zp, t3, LD, a.Dskip[at.h],
                           at.o0, at.p0, at.di);
}

inline size_t chunk_smem() {
  return sizeof(float) * (4 * kSsdT + 32 + 3 * kSsdT * SsdLd<float>::v);
}

// (c) in bfloat16 on wgmma: four [128][128] tiles (C; B, then the scores;
// x dt'; the state) and x in float32 [128][kXsLd] for the D-skip.

template <bool kRes, int KT>
__global__ void __launch_bounds__(kSsdThreads, 1) mixer2_chunk_wg_kernel(Mixer2Args<bf16> a) {
  extern __shared__ __align__(1024) unsigned char m2_wg_smem[];
  const ChunkAt at(a, 1);
  unsigned char *tC = m2_wg_smem, *tB = tC + kWgTileBytes, *tX = tB + kWgTileBytes,
                *tS = tX + kWgTileBytes;
  float* xs = reinterpret_cast<float*>(tS + kWgTileBytes);  // [T][kXsLd]
  float* dtp = xs + kSsdT * kXsLd;
  float* segb = dtp + kSsdT;
  float* into_e = segb + kSsdT;
  float* scale = into_e + kSsdT;
  float* total_s = scale + kSsdT;
  const uint32_t sC = smem_u32(tC), sB = smem_u32(tB), sX = smem_u32(tX), sS = smem_u32(tS);
  const WgFrag fr;
  const DtSrc<bf16> ds{a.dt + at.r * a.L * a.H + at.h, a.H};
  chunk_decays(ds, at.t0, a.A[at.h] * kLog2e, a.dt_bias[at.h], a.reverse, dtp, segb, into_e,
               scale, total_s);
  auto as_is = [](int, float v) { return v; };
  wg_stage_two(tC, a.Ca + at.bc0 + (long long)at.t0 * at.NGN, at.NGN, tB,
               a.Ba + at.bc0 + (long long)at.t0 * at.NGN, at.NGN);
  conv_block<KT>(a.xi + at.o0 - (long long)at.t0 * at.di, at.di, a.cxw + at.h * kSsdP * a.K,
                 a.cxb + at.h * kSsdP, a.K, a.L, at.t0, a.reverse,
                 [&](int i, int c0, const float (&v)[8]) {
                   if constexpr (kRes) store8(a.accx + at.o0 + (long long)i * at.di + c0, v);
                   float x[8], xd[8];
#pragma unroll
                   for (int e = 0; e < 8; ++e) {
                     x[e] = silu_f(v[e]);
                     xd[e] = x[e] * dtp[i];
                   }
                   store8(xs + i * kXsLd + c0, x);
                   store8(reinterpret_cast<bf16*>(tX + wg_off(i, c0)), xd);
                 });
  fence_async_smem();
  if (!at.first) wg_stage(tS, a.fe + at.fe0, at.di, as_is);
  __syncthreads();
  float acc[16][4];
  wg_mm<false, true>(acc, sC, sB, fr.wg, false);  // C B^T
  __syncthreads();  // every read of B is done
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = fr.row(i);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int s0 = fr.col(j);
      float sc[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = s0 + e;
        const bool keep = a.reverse ? t <= s : t >= s;
        const float seg = keep ? segb[t] - segb[s] : __uint_as_float(0xff800000u);  // -inf
        sc[e] = acc[j][2 * i + e] * exp2f(seg);
      }
      *reinterpret_cast<uint32_t*>(tB + wg_off(t, s0 & ~7) + (s0 & 7) * 2) =
          pack2(__float2bfloat16(sc[0]), __float2bfloat16(sc[1]));
    }
  }
  fence_async_smem();
  if (!at.first) {
    wg_mm<false, false>(acc, sC, sS, fr.wg, false);  // C S
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float f = into_e[fr.row(i)];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[j][2 * i] *= f;
        acc[j][2 * i + 1] *= f;
      }
    }
  }
  ZPairs<bf16, WgFrag> zp;
  zp.load(a.z + at.o0, fr, at.di);
  __syncthreads();  // the scores are written
  wg_mm<false, false>(acc, sB, sX, fr.wg, !at.first);  // (+)= scores (x dt')
  mixer2_epilogue<bf16, kRes>(a, fr, acc, zp, xs, kXsLd, a.Dskip[at.h], at.o0, at.p0, at.di);
}

inline size_t chunk_wg_smem() {
  return 4 * kWgTileBytes + sizeof(float) * (kSsdT * kXsLd + 4 * kSsdT + 32);
}

// (d): per (row, t): the sums of v^2 of all heads in order, rsqrt, * nw, cast.
template <typename T>
__global__ void __launch_bounds__(32 * kNormRows) gated_norm_kernel(
    const float* __restrict__ u, const float* __restrict__ part, const float* __restrict__ nw,
    T* __restrict__ out, long long rows, int di, int nparts, float eps) {
  const long long row = (long long)blockIdx.x * kNormRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float ss = 0.f;
  for (int h = 0; h < nparts; ++h) ss += part[row * nparts + h];
  const float rs = rsqrtf(ss / (float)di + eps);
  const float* ur = u + row * di;
  T* o = out + row * di;
  for (int c = lane; c < di; c += 32) o[c] = from_f<T>(ur[c] * rs * nw[c]);
}

template <typename T, bool kRes, int KT>
cudaError_t launch_mixer2(const Mixer2Args<T>& a, const float* nw, T* out, int R, float eps,
                          cudaStream_t s) {
  const int nc = a.L / kSsdT, di = a.H * kSsdP;
  mixer2_act_kernel<T, kRes, KT><<<dim3(a.NG, nc, R), kSsdThreads, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (nc > 1) {
    const dim3 sgrid(a.H, nc - 1, R);
    if constexpr (std::is_same<T, bf16>::value) {
      const size_t ss = state_wg_smem();
      e = cudaFuncSetAttribute(mixer2_state_wg_kernel<KT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ss);
      if (e != cudaSuccess) return e;
      mixer2_state_wg_kernel<KT><<<sgrid, kSsdThreads, ss, s>>>(a);
    } else {
      const size_t ss = state_smem();
      e = cudaFuncSetAttribute(mixer2_state_kernel<KT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ss);
      if (e != cudaSuccess) return e;
      mixer2_state_kernel<KT><<<sgrid, kSsdThreads, ss, s>>>(a);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const long long n4 = (long long)R * kSsdN * di / 4;
  mixer2_pass_kernel<<<(unsigned)((n4 + kPassThreads - 1) / kPassThreads), kPassThreads, 0, s>>>(
      a.fe, a.tot, n4, nc, a.H, a.reverse);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid(a.H, nc, R);
  int parts;
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t cs = chunk_wg_smem();
    e = cudaFuncSetAttribute(mixer2_chunk_wg_kernel<kRes, KT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cs);
    if (e != cudaSuccess) return e;
    mixer2_chunk_wg_kernel<kRes, KT><<<grid, kSsdThreads, cs, s>>>(a);
    e = cudaGetLastError();
    parts = WgFrag::kParts;
  } else {
    const size_t cs = chunk_smem();
    e = cudaFuncSetAttribute(mixer2_chunk_kernel<kRes, KT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cs);
    if (e != cudaSuccess) return e;
    mixer2_chunk_kernel<kRes, KT><<<grid, kSsdThreads, cs, s>>>(a);
    e = cudaGetLastError();
    parts = TileFrag::kParts;
  }
  if (e != cudaSuccess) return e;
  const long long rows = (long long)R * a.L;
  gated_norm_kernel<T><<<(unsigned)((rows + kNormRows - 1) / kNormRows), 32 * kNormRows, 0, s>>>(
      a.u, a.part, nw, out, rows, di, a.H * parts, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* xi, const void* z, const void* Bm, const void* Cm,
                         const void* dt, const float* cxw, const float* cxb, const float* cbw,
                         const float* cbb, const float* ccw, const float* ccb, const float* nw,
                         const float* A, const float* Dskip, const float* dt_bias, float* fe,
                         float* tot, float* u, float* part, void* Ba, void* Ca, void* out,
                         void* accx, void* accB, void* accC, void* yres, int R, int L, int H,
                         int NG, int K, int reverse, float eps, cudaStream_t s) {
  if (K < 1 || K > kMaxTaps) return cudaErrorInvalidValue;
  Mixer2Args<T> a;
  a.xi = static_cast<const T*>(xi);
  a.z = static_cast<const T*>(z);
  a.Bm = static_cast<const T*>(Bm);
  a.Cm = static_cast<const T*>(Cm);
  a.dt = static_cast<const T*>(dt);
  a.cxw = cxw; a.cxb = cxb; a.cbw = cbw; a.cbb = cbb; a.ccw = ccw; a.ccb = ccb;
  a.A = A; a.Dskip = Dskip; a.dt_bias = dt_bias;
  a.fe = fe; a.tot = tot; a.u = u; a.part = part;
  a.Ba = static_cast<T*>(Ba);
  a.Ca = static_cast<T*>(Ca);
  a.accx = static_cast<T*>(accx);
  a.accB = static_cast<T*>(accB);
  a.accC = static_cast<T*>(accC);
  a.yres = static_cast<T*>(yres);
  a.L = L; a.H = H; a.NG = NG; a.K = K; a.reverse = reverse;
  T* o = static_cast<T*>(out);
  const bool res = accx != nullptr;
  if (K <= 4)
    return res ? launch_mixer2<T, true, 4>(a, nw, o, R, eps, s)
               : launch_mixer2<T, false, 4>(a, nw, o, R, eps, s);
  return res ? launch_mixer2<T, true, kMaxTaps>(a, nw, o, R, eps, s)
             : launch_mixer2<T, false, kMaxTaps>(a, nw, o, R, eps, s);
}

}  // namespace pc

// P = N = chunk = 128, L % 128 == 0 and NG | H are the wrapper's to check.
// Conv taps and biases arrive as float32 (the kernel rounds them to xi's
// dtype). Float32: fe [R, L/128, N, di] (fentry in the training variant,
// scratch otherwise), tot [R, L/128, H], u [R, L, di] and part [R, L, H, 2]
// (scratch). Ba, Ca [R, L, NG*N] in xi's dtype (scratch). The residuals accx
// [R, L, di], accB, accC [R, L, NG*N] and yres [R, L, di] (xi's dtype) are
// all given for the training variant, all null otherwise.
extern "C" int pc_mixer2_fwd(const void* xi, const void* z, const void* Bm, const void* Cm,
                             const void* dt, const float* cxw, const float* cxb,
                             const float* cbw, const float* cbb, const float* ccw,
                             const float* ccb, const float* nw, const float* A,
                             const float* Dskip, const float* dt_bias, float* fe, float* tot,
                             float* u, float* part, void* Ba, void* Ca, void* out, void* accx,
                             void* accB, void* accC, void* yres, int R, int L, int H, int NG,
                             int K, int reverse, float eps, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pc::launch_typed<__nv_bfloat16>(xi, z, Bm, Cm, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw,
                                           A, Dskip, dt_bias, fe, tot, u, part, Ba, Ca, out,
                                           accx, accB, accC, yres, R, L, H, NG, K, reverse, eps,
                                           s);
  return pc::launch_typed<float>(xi, z, Bm, Cm, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw, A, Dskip,
                                 dt_bias, fe, tot, u, part, Ba, Ca, out, accx, accB, accC, yres,
                                 R, L, H, NG, K, reverse, eps, s);
}
