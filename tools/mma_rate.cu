// The card's rate for the tensor-core instruction K2's fuse_in products use,
// mma.sync m16n8k16 with bf16 operands and a float32 accumulator, with the
// operands in registers: CH independent accumulator chains a warp, several
// block shapes, every SM busy. Build and run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_rate tools/mma_rate.cu
//   build/mma_rate
//
// Prints one line per shape: the chains a warp, threads a block and blocks
// an SM, the time of 4096 iterations and the rate in TFLOP/s. A kernel whose
// products run far below this rate is bound by how their operands reach
// them, not by the tensor cores.
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

template <int CH>
__global__ void mma_loop(float* out, int iters) {
  float d[CH][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u}, b0 = threadIdx.x, b1 = 5u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CH>
int run(int sms, int threads, int blocks_per_sm) {
  const dim3 grid(sms * blocks_per_sm);
  const int iters = 4096;
  float* out;
  if (cudaMalloc(&out, sizeof(float) * grid.x * threads) != cudaSuccess) return 1;
  mma_loop<CH><<<grid, threads>>>(out, 16);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  mma_loop<CH><<<grid, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  if (cudaGetLastError() != cudaSuccess) return 1;
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flops = 2.0 * 16 * 8 * 16 * CH * (double)iters * (threads / 32) * grid.x;
  printf("mma.sync m16n8k16 bf16: %2d chains a warp, %3d threads x %d blocks an SM: %.3f ms, "
         "%.1f TFLOP/s\n", CH, threads, blocks_per_sm, ms, flops / ms / 1e9);
  cudaFree(out);
  return 0;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceProp p;
  cudaGetDeviceProperties(&p, 0);
  printf("%s, %d SMs\n", p.name, sms);
  return run<1>(sms, 512, 1) | run<4>(sms, 512, 1) | run<8>(sms, 512, 1) | run<8>(sms, 256, 2) |
         run<8>(sms, 128, 1) | run<4>(sms, 128, 1) | run<16>(sms, 512, 1);
}
