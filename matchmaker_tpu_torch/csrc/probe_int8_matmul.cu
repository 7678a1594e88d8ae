// The int8 product probe, written for Hopper.
//
// Replaces the Pallas kernel of benchmarks/int8_matmul_probe.py:
//   K16 pk (inside mm_int8_pallas) -> int8_matmul_kernel
// out (M, N) int32 = xq (M, K) int8 . wq (K, N) int8, exact. The weight
// codes come K-major, as wq^T (N, K), the way a serving path would store
// them once: both operands then feed mma.sync's row.col form through
// ldmatrix without a transpose.
//
// What bounds it on the card: 2*M*K*N int8 operations against
// M*K + K*N + 4*M*N bytes; at the probe's MLP shape (16,384 x 768 x 3,072)
// the int32 output alone is 201 MB, so the bytes bound it (0.065 ms at
// 3.35 TB/s against 0.039 ms of int8 tensor-core work at 1,979 TOP/s).
//
// Design (a simple tensor-core kernel, not yet tuned): one block of 8 warps
// per 128 x 128 output tile; K comes through a 3-stage cp.async ring of
// 64-byte slices of both operands (80-byte shared rows, so ldmatrix's eight
// row addresses fall on distinct banks); each warp owns 64 x 32 of the tile:
// per 32-deep step four A and two B ldmatrix.x4 loads feed 16
// mma.sync.m16n8k32.s8 products into 64 int32 accumulators. Rows past M,
// columns past N and a K tail of 32 are zero-filled by the copies.
#include "mma_sync.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

namespace mm {
namespace probe_i8 {

constexpr int BM = 128, BN = 128, BK = 64;  // tile rows, columns and bytes of K a stage
constexpr int LDS = BK + 16;                 // 80-byte shared rows
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int STAGE_BYTES = (BM + BN) * LDS;
constexpr size_t SMEM_BYTES = (size_t)STAGES * STAGE_BYTES;

__device__ __forceinline__ void load_stage(int8_t* st, const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                                           int M, int N, int K, int m0, int n0, int k0) {
  for (int c = threadIdx.x; c < (BM + BN) * (BK / 16); c += THREADS) {
    const int row = c >> 2, col = (c & 3) * 16;  // rows [0, BM) of A, then BN rows of B
    const bool is_b = row >= BM;
    const int g = is_b ? n0 + row - BM : m0 + row;
    const bool ok = g < (is_b ? N : M) && k0 + col < K;
    const int8_t* src = (is_b ? B : A) + (ok ? (size_t)g * K + k0 + col : 0);
    cp_async16(st + row * LDS + col, src, ok);
  }
}

__global__ void __launch_bounds__(THREADS, 2) int8_matmul_kernel(const int8_t* __restrict__ A,
                                                                  const int8_t* __restrict__ B,
                                                                  int* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(128) int8_t smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int k_tiles = (K + BK - 1) / BK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_stage(smem + s * STAGE_BYTES, A, B, M, N, K, m0, n0, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    const int next = kt + STAGES - 1;
    if (next < k_tiles) load_stage(smem + (next % STAGES) * STAGE_BYTES, A, B, M, N, K, m0, n0, next * BK);
    cp_async_commit();
    const int8_t* As = smem + (kt % STAGES) * STAGE_BYTES;
    const int8_t* Bs = As + BM * LDS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldsm_x4(a[i], As + (wm + 16 * i + (lane & 15)) * LDS + ks + (lane >> 4) * 16);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldsm_x4(b[p], Bs + (wn + 16 * p + (lane & 7) + ((lane >> 4) << 3)) * LDS + ks + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma16832_s8(acc[i][2 * p], a[i], b[p][0], b[p][1]);
          mma16832_s8(acc[i][2 * p + 1], a[i], b[p][2], b[p][3]);
        }
    }
  }
  cp_async_wait<0>();
  // fragment [i][j][2h + e] holds row wm + 16i + lane/4 + 8h, column wn + 8j + 2(lane%4) + e
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + 16 * i + (lane >> 2) + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + 8 * j + 2 * (lane & 3);
        if (col < N) *reinterpret_cast<int2*>(C + (size_t)row * N + col) = make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

}  // namespace probe_i8
}  // namespace mm

using namespace mm::probe_i8;

extern "C" {

// out (M, N) int32 = xq (M, K) int8 . wq_t (N, K)^T, all contiguous;
// K % 32 == 0, N % 8 == 0, any M.
int mm_probe_int8_matmul(const void* xq, const void* wq_t, void* out, int M, int N, int K, void* stream) {
  if (M < 0 || N < 8 || K < 32 || N % 8 || K % 32) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err =
      cudaFuncSetAttribute(int8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq_t), static_cast<int*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
