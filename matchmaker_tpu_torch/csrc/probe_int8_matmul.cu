// The int8 product probe, written for Hopper.
//
// Replaces the Pallas kernel of benchmarks/int8_matmul_probe.py:
//   K16 pk (inside mm_int8_pallas) -> int8_matmul_kernel
// out (M, N) int32 = xq (M, K) int8 . wq (K, N) int8, exact. The weight
// codes come K-major, as wq^T (N, K), the way a serving path would store
// them once: wgmma takes 8-bit operands K-major only, so both feed it
// untransposed.
//
// What bounds it on the card: 2*M*K*N int8 operations against
// M*K + K*N + 4*M*N bytes; at the probe's MLP shape (16,384 x 768 x 3,072)
// the int32 output alone is 201 MB, so the bytes bound it (0.065 ms at
// 3.35 TB/s against 0.039 ms of int8 tensor-core work at 1,979 TOP/s): the
// kernel has to keep the output stream running while it multiplies.
//
// Design: persistent and warp-specialised (wgmma_gemm.cuh's pieces). One
// CTA an SM walks the 128 x 128 output tiles (along N first, so concurrent
// tiles share their A rows in L2). A producer warp keeps TMA loads of both
// K-major operands (128-byte-deep stages, 128-byte swizzle) in a 5-stage
// mbarrier ring and runs ahead into the next tile while the consumers
// finish this one. The ring sets the speed: the operands come from L2 and
// the mainloop waits on them unless 160 KB are in flight (on an H100, 4
// stages took 0.114 ms, 5 stages 0.086; 256 x 128 tiles with 2 stages,
// 0.134). Two consumer warpgroups own 64 rows each: wgmma
// m64n128k32 s8 x s8 -> s32, four a stage. The epilogue goes through
// shared memory: each consumer writes its 64 x 128 int32 accumulators into
// its own 32 KB buffer, swizzled as the store's four 64 x 32 boxes, and
// one thread stores them by TMA (cp.async.bulk.tensor, a bulk group), so
// the store stream runs under the next tile's mainloop; the buffer is
// written again only once that group has been read. The tensor maps clip
// rows past M and columns past N (N % 8 == 0 keeps the row pitch a multiple
// of 16 bytes, so every N takes TMA stores: no plain-store tail), and fill
// K past its end with zeros (K % 32 == 0; the zeros add nothing).
#include "wgmma_gemm.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

namespace mm {
namespace probe_i8 {

using namespace wg;

constexpr int BM = 128, BN = 128, BK = 128;  // tile rows, columns and bytes of K a stage
constexpr int CONSUMERS = 2;                 // warpgroups of 64 rows, beside the producer's
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int STAGES = 5;
constexpr int BOX_BYTES = 128 * BK;          // one operand's stage: 16 KB
constexpr int STAGE_BYTES = 2 * BOX_BYTES;
constexpr int OUT_BYTES = 64 * BN * 4;       // a consumer's int32 tile: 32 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + CONSUMERS * OUT_BYTES + 1024 /* alignment */ + 2 * STAGES * 8;

__global__ void __launch_bounds__(THREADS, 1)
    int8_matmul_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                       const __grid_constant__ CUtensorMap tc, int N, int K, int units) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* out_buf = smem + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_buf + CONSUMERS * OUT_BYTES);
  uint64_t* empty = full + STAGES;
  const int warpgroup = threadIdx.x / 128;
  const int tiles_n = (N + BN - 1) / BN, k_tiles = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == CONSUMERS * 128) {  // one thread keeps the ring full, across tiles
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int m0 = (u / tiles_n) * BM, n0 = (u % tiles_n) * BN;
        for (int t = 0; t < k_tiles; ++t, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          mbar_expect_tx(&full[s], STAGE_BYTES);
          uint8_t* st = smem + s * STAGE_BYTES;
          tma_load(&ta, st, &full[s], t * BK, m0);
          tma_load(&tb, st + BOX_BYTES, &full[s], t * BK, n0);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");

  const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
  const bool leader = threadIdx.x % 128 == 0;
  uint8_t* buf = out_buf + warpgroup * OUT_BYTES;
  int it = 0;  // K tiles consumed so far, over all tiles
  bool stored = false;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int m0 = (u / tiles_n) * BM, n0 = (u % tiles_n) * BN;
    int acc[64];
    for (int t = 0; t < k_tiles; ++t, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t a_st = smem_u32(smem + s * STAGE_BYTES) + warpgroup * (64 * BK);
      const uint32_t b_st = smem_u32(smem + s * STAGE_BYTES + BOX_BYTES);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 32; ++k)  // the tile's first product overwrites the sums (scale-d = 0)
        wgmma_m64n128_s8(acc, a_st + 32 * k, b_st + 32 * k, t > 0 || k > 0);
      wgmma_commit();
      // keep this stage's products in flight; the previous stage's are done
      wgmma_wait<1>();
      if (t > 0 && leader) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (leader) {
      mbar_arrive(&empty[(it - 1) % STAGES]);
      if (stored) tma_store_wait_read<0>();  // the previous tile's store has left the buffer
    }
    warpgroup_sync(warpgroup);
    stage_acc_m64n128(buf, acc, warp, lane);
    fence_proxy_async();
    warpgroup_sync(warpgroup);
    if (leader) {
#pragma unroll
      for (int b = 0; b < BN / 32; ++b) tma_store(&tc, buf + b * 8192, n0 + 32 * b, m0 + 64 * warpgroup);
      tma_store_commit();
    }
    stored = true;
  }
  if (leader) tma_store_wait<0>();
}

// the launch for the extern "C" entry below (inside the namespace: wg's
// names of the same spelling stay out of the way)
inline cudaError_t launch(const void* xq, const void* wq_t, void* out, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap ta, tb, tc;
  if (!make_map(&ta, xq, K, M, false, CU_TENSOR_MAP_DATA_TYPE_UINT8, BM) ||
      !make_map(&tb, wq_t, K, N, false, CU_TENSOR_MAP_DATA_TYPE_UINT8, BN) ||
      !make_store_map(&tc, out, N, M, CU_TENSOR_MAP_DATA_TYPE_INT32))
    return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(int8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int units = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = units < sm_count() ? units : sm_count();
  int8_matmul_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(ta, tb, tc, N, K, units);
  return cudaGetLastError();
}

}  // namespace probe_i8
}  // namespace mm

extern "C" {

// out (M, N) int32 = xq (M, K) int8 . wq_t (N, K)^T, all contiguous;
// K % 32 == 0, N % 8 == 0, any M.
int mm_probe_int8_matmul(const void* xq, const void* wq_t, void* out, int M, int N, int K, void* stream) {
  if (M < 0 || N < 8 || K < 32 || N % 8 || K % 32) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(mm::probe_i8::launch(xq, wq_t, out, M, N, K, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
