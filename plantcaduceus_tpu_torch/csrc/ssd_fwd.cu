// K4 — the SSD (Mamba-2) chunk scan, one direction.
//
// Replaces plantcaduceus_tpu/ops/pallas_ssd.py::_kernel (with its
// ssd_chunk_core; launched at pallas_ssd.py:211 through _ssd_pallas_one /
// ssd_dir / ssd_pallas): the flat contract of ssd_dir,
//   x [R, L, H*P], dt [R, L, H] raw, B/C [R, L, NG, N], A/D/dt_bias [H] fp32
//   -> y [R, L, H*P] in x's dtype,
// with softplus(dt + dt_bias), the exp2 decays and the D-skip in the kernel.
// The training variant (emit_fentry, a template parameter) also writes the
// float32 state each chunk starts from, fentry [R, L/128, N, H*P] by chunk
// index, which K6 (ssd_bwd.cu) recomputes each chunk from.
//
// One block per (row, head) runs ssd_core.cuh's ssd_head over the row's
// L/128 chunks; see there for the layout and the numerics.
//
// What bounds it on an H100: in bf16, the bytes of x, B, C, dt and y (0.47
// GB at the l20-ssd scoring shape, 256 x 512, H 6: 0.14 ms) ahead of the
// four 128 x 128 x 128 products per (row, head, chunk) on the tensor cores
// (about 82 GFLOP with C @ B^T once per group: 0.08 ms at 989 TFLOP/s). In
// fp32 the products run as FMA loops on the fp32 cores and bound it (1.2 ms
// at 67 TFLOP/s). The bf16 products here are mma.sync tiles; wgmma with TMA
// is the way to the bound.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include "ssd_core.cuh"

namespace pc {

// Plain loads of one (row, head) from the flat tensors.
template <typename T>
struct SsdSrc {
  const T* xr;   // the row's [L, H*P], at head h's first channel
  const T* dtr;  // the row's [L, H], at column h
  const T* Br;   // the row's [L, NG*N], at group g's first column
  const T* Cr;
  T* yr;         // as xr
  int HP, H, NGN;
  float D;
  __device__ float x(int t, int p) const { return to_f(xr[(long long)t * HP + p]); }
  __device__ float dt(int t) const { return to_f(dtr[(long long)t * H]); }
  __device__ float b(int t, int n) const { return to_f(Br[(long long)t * NGN + n]); }
  __device__ float c(int t, int n) const { return to_f(Cr[(long long)t * NGN + n]); }
  __device__ void out(const float (&acc)[4][16], int t0, const Tile& tl) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + tl.row(i);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int p = tl.col(j);
        yr[(long long)t * HP + p] = from_f<T>(acc[i][j] + x(t, p) * D);
      }
    }
  }
};

template <typename T, bool kFentry>
__global__ void __launch_bounds__(kSsdThreads, 1) ssd_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ B,
    const T* __restrict__ C, const float* __restrict__ A, const float* __restrict__ Dskip,
    const float* __restrict__ dt_bias, T* __restrict__ y, float* __restrict__ fe, int L,
    int H, int NG, int reverse) {
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  const int h = blockIdx.x;
  const long long r = blockIdx.y;
  const int g = h / (H / NG);
  SsdSrc<T> src;
  src.HP = H * kSsdP;
  src.H = H;
  src.NGN = NG * kSsdN;
  src.xr = x + r * L * src.HP + h * kSsdP;
  src.yr = y + r * L * src.HP + h * kSsdP;
  src.dtr = dt + r * L * H + h;
  src.Br = B + r * L * src.NGN + g * kSsdN;
  src.Cr = C + r * L * src.NGN + g * kSsdN;
  src.D = Dskip[h];
  float* fer = kFentry ? fe + r * (L / kSsdT) * kSsdN * src.HP + h * kSsdP : nullptr;
  ssd_head<T, kFentry>(src, A[h], dt_bias[h], L, reverse, ssd_smem, fer, src.HP);
}

template <typename T, bool kFentry>
cudaError_t launch_ssd_v(const void* x, const void* dt, const void* B, const void* C,
                       const float* A, const float* Dskip, const float* dt_bias, void* y,
                       float* fe, int R, int L, int H, int NG, int reverse, cudaStream_t s) {
  const size_t smem = ssd_smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(ssd_fwd_kernel<T, kFentry>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  ssd_fwd_kernel<T, kFentry><<<dim3(H, R), kSsdThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(B),
      static_cast<const T*>(C), A, Dskip, dt_bias, static_cast<T*>(y), fe, L, H, NG, reverse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ssd(const void* x, const void* dt, const void* B, const void* C,
                       const float* A, const float* Dskip, const float* dt_bias, void* y,
                       float* fe, int R, int L, int H, int NG, int reverse, cudaStream_t s) {
  if (fe)
    return launch_ssd_v<T, true>(x, dt, B, C, A, Dskip, dt_bias, y, fe, R, L, H, NG, reverse,
                                 s);
  return launch_ssd_v<T, false>(x, dt, B, C, A, Dskip, dt_bias, y, fe, R, L, H, NG, reverse,
                                s);
}

}  // namespace pc

// P = N = chunk = 128 and L % 128 == 0 are the wrapper's to check. fentry
// [R, L/128, N, H*P] float32, or null for the inference variant.
extern "C" int pc_ssd_fwd(const void* x, const void* dt, const void* B, const void* C,
                          const float* A, const float* Dskip, const float* dt_bias, void* y,
                          float* fentry, int R, int L, int H, int NG, int reverse, int bf16,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pc::launch_ssd<__nv_bfloat16>(x, dt, B, C, A, Dskip, dt_bias, y, fentry, R, L, H,
                                         NG, reverse, s);
  return pc::launch_ssd<float>(x, dt, B, C, A, Dskip, dt_bias, y, fentry, R, L, H, NG,
                               reverse, s);
}
