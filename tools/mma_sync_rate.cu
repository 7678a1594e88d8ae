// The card's rate for the warp-level tensor-core products the port's
// mma.sync kernels issue (K14's split-TF32 MaxSim, the attention cores):
// mma.sync m16n8k8 TF32 and m16n8k16 bf16, f32 accumulators, on registers
// only (no memory traffic), four blocks an SM, each warp CHAINS independent
// accumulators so no product waits on the one before. Prints TFLOP/s and
// products a clock an SM at the card's current clock.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_sync_rate tools/mma_sync_rate.cu
//   build/mma_sync_rate
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

template <int CHAINS, bool TF32>
__global__ void mma_loop(float* out, int iters) {
  float acc[CHAINS][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  const uint32_t b[2] = {threadIdx.x * 3u, 7u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
            "{%0,%1,%2,%3};"
            : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
            "{%0,%1,%2,%3};"
            : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.0f;
  for (int c = 0; c < CHAINS; ++c) s += acc[c][0] + acc[c][3];
  if (s == 12345.0f) out[0] = s;  // keeps the products alive
}

template <int CHAINS, bool TF32>
static void run(int warps) {
  float* out;
  cudaMalloc(&out, sizeof(float));
  int sms = 0, dev = 0, khz = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev);
  const int iters = 4096, blocks = 4 * sms;
  mma_loop<CHAINS, TF32><<<blocks, 32 * warps>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  mma_loop<CHAINS, TF32><<<blocks, 32 * warps>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double mmas = (double)blocks * warps * iters * CHAINS, flops = TF32 ? 2048.0 : 4096.0;
  printf("%s chains %d, %d warps a block: %.3f ms, %.1f TFLOP/s, %.3f products a clock an SM at %d MHz\n",
         TF32 ? "tf32 m16n8k8 " : "bf16 m16n8k16", CHAINS, warps, ms, mmas * flops / ms / 1e9,
         mmas / sms / (ms * 1e-3 * khz * 1e3), khz / 1000);
  cudaFree(out);
}

int main() {
  run<8, true>(4);
  run<16, true>(8);
  run<8, false>(4);
  run<16, false>(8);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
