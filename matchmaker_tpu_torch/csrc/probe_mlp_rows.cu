// The row-packed fused MLP probe, written for Hopper.
//
// Replaces the Pallas kernels of benchmarks/mlp_rows_probe.py:
//   K17 _mlp_kernel_rows2d  (mlp_rows2d: whole padded examples as rows)
//   K18 _mlp_kernel_rowsblk (mlp_rowsblk: flat 1024/2048-row blocks)
// -> mlp_rows_kernel, which serves both wrappers (they differ only in how
// they pad the rows, ops in matchmaker_tpu_torch/probes/mlp_rows.py).
// y = LN(x + gelu(x.W1 + b1).W2 + b2) over rows x (M, 768) bf16, W1 (768, FF)
// and W2 (FF, 768) bf16 row-major, b1, b2 and the LayerNorm's scale and shift
// f32, eps as given; gelu is the FMA-only polynomial of the bf16 halves
// (encoder_common.cuh), its output rounded to bf16 before the second
// product; y is bf16.
//
// What bounds it on the card: 4*M*768*FF flops (483 GFLOP at M = 51,200,
// 0.49 ms at the bf16 peak) against M*768*4 + 9.4 MB bytes: the operations.
// Behind that sits the on-chip traffic: a tile of rows has to see all of W1
// and W2 (9.4 MB at FF 3,072), and the tile is bounded by what a CTA can
// keep on chip: each row's 768 pre-LN sums (f32) and its h (bf16, FF wide).
//
// Design: a cluster of 4 CTAs owns 128 rows and splits the 768 output
// columns, so the row tile doubles (the first port's 64-row CTA pulled all
// the weights through L2 for each 64 rows) while each CTA holds 128 x 192
// sums: 96 registers a thread in two consumer warpgroups of 64 rows. FF is
// walked in rounds of 256: in round n CTA c computes h's chunk
// [256n + 64c, +64) for all 128 rows (x . W1[:, chunk], K = 768 in 12 ring
// stages), adds b1, takes gelu, rounds to bf16 into its shared memory and
// copies it into the three peers' (cp.async.bulk shared::cta ->
// shared::cluster, completing on each receiver's mbarrier); then every CTA
// runs acc += h[:, 256n + 64s, +64) . W2[that chunk, its 192 columns] for
// s = 0..3, the same order in every CTA. h goes to a double buffer so the
// exchange of round n lands while the CTAs compute round n + 1's chunk:
// each warpgroup computes h(n + 1), hands it over, then multiplies h(n).
// A buffer slot is written again only once all four CTAs have finished with
// it (an mbarrier each slot and warpgroup that the four CTAs arrive on).
//
// Operands arrive by TMA into one ring of 4 stages of 24 KB, each stage
// either {x rows 128 x K 64 (16 KB), W1 K 64 x 64 (8 KB)} or {W2 64 x 192
// (24 KB)}, 128-byte swizzled. The x stage is the same for the four CTAs:
// each loads 32 of its rows and multicasts them to all four, so x crosses L2
// once a cluster. A stage is refilled only when all eight consumer
// warpgroups of the cluster are done with it (its empty mbarrier in each CTA
// counts their eight arrivals, each warpgroup's four sent by four threads at
// once, as soon as the stage's own products are done). One producer thread
// issues the loads (its warpgroup keeps 40 registers, setmaxnreg); both
// products are wgmma with A K-major in shared memory (x, h) and B MN-major
// where the weights lie: m64n64k16 for h's chunk (32 registers), m64n192k16
// for the sums (96).
//
// Epilogue: v = (x + b2) + acc (x read from device memory), the LayerNorm in
// two passes: each CTA's row sums over its 192 columns are stored into all
// four CTAs' shared memory, every CTA adds the four in the order c = 0..3
// (the mean, the same bits in each CTA and on every run), then the same for
// the centred squares; cluster barriers order the three exchanges. y is
// staged in bf16 as 128-byte swizzled 64 x 64 boxes and leaves by TMA store
// (rows past M clipped by the tensor map, as its loads zero them). Neither h
// nor the pre-LN sums reach device memory.
//
// Budget a CTA: shared memory 4 x 24 KB ring + 2 x 64 KB h slots + 16
// mbarriers + 1 KB alignment = 230,528 B (of 232,448); registers 2 x 128 x
// 232 (consumers) + 128 x 40 (producer) = 64,512 (of 65,536); one CTA an
// SM, 30 clusters at once on an H100 (120 SMs: clusters stay within a GPC).
// L2 bytes a cluster: x 12 x 196,608 (one multicast read a round of 256 FF
// at FF 3,072) + W1 and W2 9,437,184 + x again and y 393,216 = 12.2 MB for
// 128 rows, 4.87 GB a call at M = 51,200 (the first port's 64-row tiles:
// 7.55 GB); probes/mlp_rows.py:kernel_plan states the same.
//
// What holds it back (measured on an H100 at M = 51,200, device time, with
// parts of the kernel stubbed out, tools/mlp_rows_variants.py): of 1.14 ms
// the products add 0.22; without them the ring's loads, the h exchange, the
// gelu and the epilogue take 0.92 ms, and without the loads too 0.58.
// Neither halving the L2 weight traffic (a 2 x 4 cluster multicasting W1
// and W2 across two row groups: 1.18), nor 6 stages with one h slot (1.19),
// nor 128-wide h chunks (25 % fewer bytes a CTA, 3 stages: 1.22) was
// faster: the stages' turnaround across the cluster sets the pace.
#include "wgmma_gemm.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mm {
namespace probe_mlp {

using namespace wg;
using bf16 = __nv_bfloat16;

constexpr int HID = 768;
constexpr int CLUSTER = 4;                    // CTAs of a cluster, each 192 output columns
constexpr int ROWS = 128;                     // rows a cluster: two consumer warpgroups of 64
constexpr int COLS = HID / CLUSTER;           // 192
constexpr int FC = 64;                        // FF columns of h a CTA computes a round
constexpr int ROUND_FF = CLUSTER * FC;        // 256
constexpr int KB = 64;                        // K of a first-product stage
constexpr int K1_STEPS = HID / KB;            // 12
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int STAGES = 4;
constexpr int X_BYTES = ROWS * KB * 2;        // 16 KB: the x part of a first-product stage
constexpr int X_PART = X_BYTES / CLUSTER;     // the 32 rows each CTA loads and multicasts
constexpr int STAGE_BYTES = X_BYTES + KB * FC * 2;  // x + W1 (64 x 64), or W2 (64 x 192): 24 KB
constexpr int H_HALF = 64 * FC * 2;           // a warpgroup's 64 rows of an h chunk: 8 KB
constexpr int H_CHUNK = ROWS * FC * 2;        // 16 KB
constexpr int H_SLOT = CLUSTER * H_CHUNK;     // one round's h: 64 KB
constexpr int H_SLOTS = 2;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int BARRIERS = 2 * STAGES + 2 * H_SLOTS * CONSUMERS;
constexpr int SMEM_BYTES = RING_BYTES + H_SLOTS * H_SLOT + BARRIERS * 8 + 1024 /* alignment */;
static_assert(FC * COLS * 2 == STAGE_BYTES, "a W2 stage (64 x 192) is as large as x + W1's");
static_assert(SMEM_BYTES <= 232448, "one CTA's shared memory on the H100");
static_assert(2 * CLUSTER * ROWS * 4 <= H_SLOT, "the LayerNorm partials fit in an h slot");
static_assert(CONSUMERS * (COLS / 64) * CHUNK_BYTES <= RING_BYTES, "y's boxes fit in the ring");

// ring stage i is free again: thread r < CLUSTER of a warpgroup arrives on
// its empty mbarrier in CTA r, all four at once
__device__ __forceinline__ void release_stage(uint64_t* empty, int i, int tid) {
  if (tid < CLUSTER) mbar_arrive_cluster(map_to_rank(&empty[i % STAGES], tid));
}

// Grid: 4 CTAs (one cluster) a 128-row tile, CTA c owning output columns
// [192c, 192c + 192). Every CTA walks the same sequence of ring stages: the
// 12 first-product stages of round 0, then for each round n those of round
// n + 1 and the 4 W2 stages of round n.
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
    mlp_rows_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw1,
                    const __grid_constant__ CUtensorMap tw2, const __grid_constant__ CUtensorMap ty,
                    const bf16* __restrict__ x, const float* __restrict__ b1, const float* __restrict__ b2,
                    const float* __restrict__ gamma, const float* __restrict__ beta, int M, int FF, float eps) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled TMA boxes want 1024-byte alignment; the offset is the
  // same in every CTA, so multicasts and peer copies land where they should
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint8_t* hbuf = smem + RING_BYTES;  // [slot][source CTA][128 rows][64] bf16, swizzled K-major
  uint64_t* full = reinterpret_cast<uint64_t*>(hbuf + H_SLOTS * H_SLOT);
  uint64_t* empty = full + STAGES;
  uint64_t* hfull = empty + STAGES;  // [slot][warpgroup]: the peers' three h halves of these rows have landed
  uint64_t* hfree = hfull + H_SLOTS * CONSUMERS;  // [slot][warpgroup]: the four CTAs are done with them
  const int c = cluster_rank();
  const int m0 = (blockIdx.x / CLUSTER) * ROWS;
  const int rounds = FF / ROUND_FF;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * CLUSTER);
    }
    for (int i = 0; i < H_SLOTS * CONSUMERS; ++i) {
      mbar_init(&hfull[i], 1);
      mbar_init(&hfree[i], CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // every CTA's mbarriers exist before a peer arrives on them or loads into its ring

  if (threadIdx.x >= 128 * CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 128 * CONSUMERS) {  // one thread keeps the ring full
      int it = 0;
      for (int n = -1; n < rounds; ++n) {
        if (n + 1 < rounds)
          for (int t = 0; t < K1_STEPS; ++t, ++it) {
            const int s = it % STAGES;
            if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
            mbar_expect_tx(&full[s], STAGE_BYTES);  // the four CTAs' x parts and this CTA's W1 box
            uint8_t* st = ring + s * STAGE_BYTES;
            tma_load_multicast(&tx, st + c * X_PART, &full[s], t * KB, m0 + c * (ROWS / CLUSTER),
                               (uint16_t)((1u << CLUSTER) - 1));
            tma_load(&tw1, st + X_BYTES, &full[s], (n + 1) * ROUND_FF + c * FC, t * KB);
          }
        if (n >= 0)
          for (int src = 0; src < CLUSTER; ++src, ++it) {
            const int s = it % STAGES;
            if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
            mbar_expect_tx(&full[s], STAGE_BYTES);
            uint8_t* st = ring + s * STAGE_BYTES;
#pragma unroll
            for (int j = 0; j < COLS / 64; ++j)
              tma_load(&tw2, st + j * CHUNK_BYTES, &full[s], c * COLS + 64 * j, n * ROUND_FF + src * FC);
          }
      }
    }
    cluster_sync();  // the consumers' three exchanges below
    cluster_sync();
    cluster_sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");

  const int w = threadIdx.x / 128, tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, warp = tid >> 5, tig = lane & 3;
  const bool leader = tid == 0;
  float acc[96];  // rows 64w + 16 warp + lane/4 + 8i, columns 192c + 8j + 2 tig + e at [4j + 2i + e]
  float hacc[32];
  int it = 0;
  for (int n = -1; n < rounds; ++n) {
    if (n + 1 < rounds) {
      // hacc = x (this warpgroup's 64 rows) . W1[:, chunk (n + 1, c)]
      for (int t = 0; t < K1_STEPS; ++t, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint32_t st = smem_u32(ring + s * STAGE_BYTES);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KB / 16; ++k)
          wgmma_m64n64_ss<1>(hacc, make_desc<false>(st + w * CHUNK_BYTES + k_step<false>(k)),
                              make_desc<true>(st + X_BYTES + k_step<true>(k)), t > 0 || k > 0);
        wgmma_commit();
        // the stage goes back to the producers as soon as its products are
        // done: the ring's turnaround, not the tensor cores, sets the pace
        wgmma_wait<0>();
        release_stage(empty, it, tid);
      }
      fence_regs(hacc);
      // h chunk (n + 1, c) = bf16(gelu(hacc + b1)) into its slot once the four
      // CTAs are done with the slot's round n - 1; then into the peers' slots
      const int hn = n + 1, slot = hn % H_SLOTS;
      if (hn >= H_SLOTS) mbar_wait(&hfree[slot * CONSUMERS + w], ((hn / H_SLOTS) - 1) & 1);
      uint8_t* mine = hbuf + slot * H_SLOT + c * H_CHUNK + w * H_HALF;
      const int ff0 = hn * ROUND_FF + c * FC;
#pragma unroll
      for (int j = 0; j < FC / 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(b1 + ff0 + 8 * j + 2 * tig);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = warp * 16 + (lane >> 2) + 8 * i;
          *reinterpret_cast<uint32_t*>(mine + row * 128 + ((j ^ (row & 7)) << 4) + 4 * tig) =
              pack2(gelu_poly(hacc[4 * j + 2 * i] + bb.x), gelu_poly(hacc[4 * j + 2 * i + 1] + bb.y));
        }
      }
      fence_proxy_async();  // for this warpgroup's wgmma and the bulk copies to the peers
      warpgroup_sync(w);
      if (leader) {
        uint64_t* bar = &hfull[slot * CONSUMERS + w];
        mbar_expect_tx(bar, (CLUSTER - 1) * H_HALF);  // the peers' three halves of these rows
#pragma unroll
        for (int p = 1; p < CLUSTER; ++p) {
          const int peer = (c + p) % CLUSTER;
          bulk_copy_to_cluster(map_to_rank(mine, peer), mine, H_HALF, map_to_rank(bar, peer));
        }
      }
    }
    if (n >= 0) {
      // acc += h(n)[:, chunk of CTA src] . W2[chunk, 192c .. 192c + 191], src = 0..3
      const int slot = n % H_SLOTS;
      mbar_wait(&hfull[slot * CONSUMERS + w], (n / H_SLOTS) & 1);
      for (int src = 0; src < CLUSTER; ++src, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint32_t a = smem_u32(hbuf + slot * H_SLOT + src * H_CHUNK + w * H_HALF);
        const uint32_t b = smem_u32(ring + s * STAGE_BYTES);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < FC / 16; ++k)
          wgmma_m64n192_ss_tb(acc, make_desc<false>(a + k_step<false>(k)), make_desc<true>(b + k_step<true>(k)),
                              n > 0 || src > 0 || k > 0);
        wgmma_commit();
        wgmma_wait<0>();
        release_stage(empty, it, tid);
      }
      fence_regs(acc);
      if (tid < CLUSTER) mbar_arrive_cluster(map_to_rank(&hfree[slot * CONSUMERS + w], tid));
    }
  }

  // ---- epilogue: residual, the cluster's LayerNorm, the store ----------------
  cluster_sync();  // every CTA is done with its ring and its h slots
  float* red_sum = reinterpret_cast<float*>(hbuf);  // [source CTA][128 rows]
  float* red_sq = red_sum + CLUSTER * ROWS;
  const int rl = w * 64 + warp * 16 + (lane >> 2);  // the tile's row of i = 0 (i = 1: + 8)
  const int col0 = c * COLS;
  float part[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < COLS / 8; ++j) {
    const int col = col0 + 8 * j + 2 * tig;
    const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + rl + 8 * i;
      float x0 = 0.0f, x1 = 0.0f;
      if (row < M) {
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)row * HID + col);
        x0 = __low2float(xv);
        x1 = __high2float(xv);
      }
      // the plain version's order: (x + b2) + product
      acc[4 * j + 2 * i] = (x0 + bb.x) + acc[4 * j + 2 * i];
      acc[4 * j + 2 * i + 1] = (x1 + bb.y) + acc[4 * j + 2 * i + 1];
      part[i] += acc[4 * j + 2 * i] + acc[4 * j + 2 * i + 1];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 2);
  }
  if (tig == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int p = 0; p < CLUSTER; ++p) st_cluster(map_to_rank(&red_sum[c * ROWS + rl + 8 * i], p), part[i]);
  cluster_sync();
  float mean[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = red_sum[rl + 8 * i];
#pragma unroll
    for (int p = 1; p < CLUSTER; ++p) sum += red_sum[p * ROWS + rl + 8 * i];
    mean[i] = sum * (1.0f / HID);
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) {
      const float d0 = acc[4 * j + 2 * i] - mean[i], d1 = acc[4 * j + 2 * i + 1] - mean[i];
      sq += d0 * d0 + d1 * d1;
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    part[i] = sq;
  }
  if (tig == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int p = 0; p < CLUSTER; ++p) st_cluster(map_to_rank(&red_sq[c * ROWS + rl + 8 * i], p), part[i]);
  cluster_sync();  // after this no CTA touches another's shared memory
  float rstd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sq = red_sq[rl + 8 * i];
#pragma unroll
    for (int p = 1; p < CLUSTER; ++p) sq += red_sq[p * ROWS + rl + 8 * i];
    rstd[i] = rsqrtf(sq * (1.0f / HID) + eps);
  }
  // y in bf16 into this warpgroup's three 64 x 64 boxes (the ring is idle now)
  uint8_t* out = ring + w * (COLS / 64) * CHUNK_BYTES;
#pragma unroll
  for (int j = 0; j < COLS / 8; ++j) {
    const int col = col0 + 8 * j + 2 * tig;
    const float2 gm = *reinterpret_cast<const float2*>(gamma + col);
    const float2 be = *reinterpret_cast<const float2*>(beta + col);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = warp * 16 + (lane >> 2) + 8 * i;
      *reinterpret_cast<uint32_t*>(out + (j >> 3) * CHUNK_BYTES + row * 128 + (((j & 7) ^ (row & 7)) << 4) +
                                   4 * tig) =
          pack2((acc[4 * j + 2 * i] - mean[i]) * rstd[i] * gm.x + be.x,
                (acc[4 * j + 2 * i + 1] - mean[i]) * rstd[i] * gm.y + be.y);
    }
  }
  fence_proxy_async();
  warpgroup_sync(w);
  if (leader) {
#pragma unroll
    for (int b = 0; b < COLS / 64; ++b) tma_store(&ty, out + b * CHUNK_BYTES, col0 + 64 * b, m0 + 64 * w);
    tma_store_commit();
    tma_store_wait<0>();
  }
}

// the launch for the extern "C" entry below
inline cudaError_t launch(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
                          const float* g, const float* be, void* out, int M, int FF, float eps, cudaStream_t stream) {
  CUtensorMap tx, tw1, tw2, ty;
  if (!make_map(&tx, x, HID, M, false, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ROWS / CLUSTER) ||
      !make_map(&tw1, w1, FF, HID, true) || !make_map(&tw2, w2, HID, FF, true) ||
      !make_store_map(&ty, out, HID, M, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mlp_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int tiles = (M + ROWS - 1) / ROWS;
  mlp_rows_kernel<<<tiles * CLUSTER, THREADS, SMEM_BYTES, stream>>>(tx, tw1, tw2, ty, static_cast<const bf16*>(x),
                                                                     b1, b2, g, be, M, FF, eps);
  return cudaGetLastError();
}

}  // namespace probe_mlp
}  // namespace mm

extern "C" {

// out (M, 768) bf16 = LN(x + gelu(x.w1 + b1).w2 + b2) over rows x (M, 768)
// bf16; w1 (768, FF), w2 (FF, 768) bf16; b1 (FF), b2, gamma, beta (768) f32,
// 8-byte aligned; all contiguous; FF % 256 == 0.
int mm_probe_mlp_rows(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, const void* g,
                      const void* be, void* out, int M, int FF, float eps, void* stream) {
  using namespace mm::probe_mlp;
  if (M < 0 || FF < ROUND_FF || FF % ROUND_FF) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch(x, w1, static_cast<const float*>(b1), w2, static_cast<const float*>(b2),
                                 static_cast<const float*>(g), static_cast<const float*>(be), out, M, FF, eps,
                                 static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
