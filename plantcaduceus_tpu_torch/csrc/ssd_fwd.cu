// K4 — the SSD (Mamba-2) chunk scan, one direction.
//
// Replaces plantcaduceus_tpu/ops/pallas_ssd.py::_kernel (with its
// ssd_chunk_core; launched at pallas_ssd.py:211 through _ssd_pallas_one /
// ssd_dir / ssd_pallas): the flat contract of ssd_dir,
//   x [R, L, H*P], dt [R, L, H] raw, B/C [R, L, NG, N], A/D/dt_bias [H] fp32
//   -> y [R, L, H*P] in x's dtype,
// with softplus(dt + dt_bias), the exp2 decays and the D-skip in the kernel.
// The training variant (emit_fentry) also writes the float32 state each
// chunk starts from, fentry [R, L/128, N, H*P] by chunk index, which K6
// (ssd_bwd.cu) recomputes each chunk from.
//
// This file holds K4's policy and entry point only: the kernels are
// ssd_chunk.cuh's state, pass and chunk kernels, the SSD forward K5 also
// runs (chunk-parallel; wgmma in bf16). K4's policy stages x, B and C with
// 16-byte loads in their dtype, and its epilogue stores y = acc + D x in x's
// dtype, x taken from the float32 tile already staged. fentry is the pass's
// output; the inference variant's state buffer is scratch from the wrapper.
//
// What bounds it on an H100: in bf16, the bytes of x, B, C, dt and y (0.47
// GB at the l20-ssd scoring shape, 256 x 512, H 6: 0.14 ms) ahead of the
// four 128 x 128 x 128 products per (row, head, chunk) on the tensor cores
// (about 82 GFLOP with C @ B^T once per group: 0.08 ms at 989 TFLOP/s). In
// fp32 the products run as FMA loops on the fp32 cores and bound it (1.2 ms
// at 67 TFLOP/s). This design adds the float32 state buffer's round trips
// (written by the state kernel, read and written by the pass, read by the
// chunk kernel) and recomputes C B^T per head.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include "ssd_chunk.cuh"

namespace pc {

template <typename T>
struct SsdFwdArgs : SsdChunkArgs<T> {
  T* y;  // [R, L, H*P]
};

// ssd_chunk.cuh's policy for K4: x as it is; y = acc + D x, stored.
template <typename T_>
struct SsdPol {
  using T = T_;
  using Args = SsdFwdArgs<T>;
  template <bool kChunk, class Out>
  static __device__ __forceinline__ void x_block(const Args& a, long long r, int h, int t0,
                                                 Out out) {
    const int di = a.H * kSsdP;
    load_block(a.x + (r * a.L + t0) * di + h * kSsdP, di, out);
  }
  template <class Fr>
  struct Ahead {
    __device__ void load(const Args&, const Fr&, long long) {}
  };
  template <class Fr, class Acc>
  static __device__ __forceinline__ void epilogue(const Args& a, const Fr& fr, Acc& acc,
                                                  const Ahead<Fr>&, const float* xs, int xld,
                                                  float D, long long o0, long long) {
    const int di = a.H * kSsdP;
    T* y = a.y + o0;
#pragma unroll
    for (int i = 0; i < Fr::NI; ++i) {
      const int t = fr.row(i);
#pragma unroll
      for (int j = 0; j < Fr::NJ; ++j) {
        const int p = fr.col(j);
        const float y0 = Fr::at(acc, i, j, 0) + xs[t * xld + p] * D;
        const float y1 = Fr::at(acc, i, j, 1) + xs[t * xld + p + 1] * D;
        T* o = y + (long long)t * di + p;
        if constexpr (std::is_same<T, float>::value)
          *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
        else
          *reinterpret_cast<uint32_t*>(o) = pack2(__float2bfloat16(y0), __float2bfloat16(y1));
      }
    }
  }
};

template <typename T>
cudaError_t launch_ssd(const void* x, const void* dt, const void* B, const void* C,
                       const float* A, const float* Dskip, const float* dt_bias, void* y,
                       float* fe, float* tot, int R, int L, int H, int NG, int reverse,
                       cudaStream_t s) {
  SsdFwdArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.Bs = static_cast<const T*>(B);
  a.Cs = static_cast<const T*>(C);
  a.dt = static_cast<const T*>(dt);
  a.A = A; a.Dskip = Dskip; a.dt_bias = dt_bias;
  a.fe = fe; a.tot = tot;
  a.L = L; a.H = H; a.NG = NG; a.reverse = reverse;
  a.y = static_cast<T*>(y);
  return launch_ssd_chunked<SsdPol<T>>(a, R, s);
}

}  // namespace pc

// P = N = chunk = 128, L % 128 == 0 and NG | H are the wrapper's to check.
// fe [R, L/128, N, H*P] float32 receives the chunk-entry states (fentry in
// the training variant, scratch otherwise); tot [R, L/128, H] float32 is
// scratch.
extern "C" int pc_ssd_fwd(const void* x, const void* dt, const void* B, const void* C,
                          const float* A, const float* Dskip, const float* dt_bias, void* y,
                          float* fe, float* tot, int R, int L, int H, int NG, int reverse,
                          int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pc::launch_ssd<__nv_bfloat16>(x, dt, B, C, A, Dskip, dt_bias, y, fe, tot, R, L, H,
                                         NG, reverse, s);
  return pc::launch_ssd<float>(x, dt, B, C, A, Dskip, dt_bias, y, fe, tot, R, L, H, NG, reverse,
                               s);
}
