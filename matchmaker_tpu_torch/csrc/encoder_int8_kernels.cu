// The encoder's int8 layer halves (inference only), written for Hopper.
//
// Replaces the Pallas kernels of matchmaker_tpu/ops/fused_int8.py:
//   K9  _mlp_int8_kernel  (MLP half):       LN(x + b2 + sum_c dq(gelu(dq(xq.W1q[:, c]) + b1[c])q . W2q[c, :]))
//   K10 _attn_int8_kernel (attention half): LN(x + bo + sum_g dq(MHA(QKV(xq))[:, g]q . Woq[g, :]))
// with per-output-column weight scales (quantized once outside, from the
// f32 parameters), per-row activation scales for x, per-(row, FF chunk of
// 768) scales for the gelu output and per-(row, group of two heads = 128
// columns) scales for the attention output. Each half runs as a few
// launches:
//   K9:  quant_groups (x, per row) -> gemm_s8_gelu_quant (W1: dequant + b1
//        + gelu, then the per-(row, chunk) codes and scales of the gelu
//        output, written as int8; the f32 gelu output never reaches device
//        memory) -> gemm_s8 (W2, the chunks' int32 partials dequantized one
//        by one onto x + b2, f32 out) -> mm_layernorm
//   K10: quant_groups (x, per row) -> gemm_s8 (packed Q|K|V, dequant + bias,
//        bf16 out) -> mm_attention_core_f32 (K1's core) -> quant_groups (per
//        row and group) -> gemm_s8 (Wo, per-group partials onto x + bo, f32
//        out) -> mm_layernorm
//
// Numerics, matched to the TPU kernels: codes are rint(v / s) (IEEE
// division, ties to even) clipped to +-127 with s = max(absmax / 127,
// 1e-12); every int8 product is exact in int32 and is dequantized as
// f32(acc) * (row scale * column scale) with explicitly rounded multiplies
// and adds (no FMA contraction), in the TPU kernels' order, so the plain
// version (ops/fused_int8.py) reproduces the kernels' dequantized values.
// A chunk's or group's partial never shares an int32 accumulator with
// another: each has its own row scale.
//
// What bounds them on the card: the projections are int8 tensor-core
// products (2*M*K*N operations on M = B*L >= 7680 rows against 0.6-2.4 MB of
// int8 weights), compute bound at the card's int8 rate of 1,979 TOP/s. The
// design: every product runs on wgmma.mma_async s8 x s8 -> s32 fed by TMA
// (wgmma_gemm.cuh's pieces): both operands K-major (the weights' codes are
// stored transposed, (OUT, IN), once per set of weights), one producer
// warpgroup (one thread issues the copies) that keeps a ring of
// 128-byte-deep stages full, consumer warpgroups that run the wgmma, one
// persistent CTA per SM. gemm_s8 owns a 128 x 128 output tile (two
// consumer warpgroups of 64 rows); a K chunk's partial finishes in its int32
// registers (wgmma.wait_group 0), is dequantized onto the f32 running value,
// and the next chunk's first wgmma overwrites it (scale-d = 0). Wo's chunks
// are one stage deep, so its products wait for each dequantization: a
// second accumulator set to overlap them was serialized by ptxas.
// gemm_s8_gelu_quant owns 64 rows x one whole FF chunk (768 columns: three
// consumer warpgroups of 256 = two 128-wide accumulators, 128 int32
// registers a thread, beside 32 more; two warpgroups of 384 columns left
// 40 registers beside 192 accumulators and spilled or ran 30 % slower),
// so a row's chunk amax is a reduction inside the CTA: the
// warpgroups swap their partial amaxes through shared memory, and the
// codes and scales leave the kernel where the f32 gelu output used to (at
// 256 x 128 rows, 101 MB of codes instead of 403 MB of f32 written and read
// twice). A chunk wider than 768 columns runs in passes: the amax passes
// first, then the passes recomputed and quantized (the product of a wide
// chunk costs twice; the gelu values, and so the codes, are the same bits).
#include "encoder_common.cuh"
#include "wgmma_gemm.cuh"

#include <cuda_bf16.h>
#include <math.h>

namespace mm {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// One warp per (row, group) of x (M, G*W): codes and the group's scale
// (matchmaker_tpu/ops/fused_int8.py:_quant_rows over each group). The codes
// go to q (M, G*WP), each group's W codes followed by WP - W zero codes: a
// product's contraction padded to whole 64-code steps.
template <typename T>
__global__ void __launch_bounds__(256) quant_groups_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                                           float* __restrict__ scales, int M, int G, int W, int WP) {
  const long long wid = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (wid >= (long long)M * G) return;
  const size_t base = (size_t)wid * W;  // row-major (M, G*W): group g of row r starts at (r*G + g)*W
  int8_t* qg = q + (size_t)wid * WP;
  for (int j = W + lane; j < WP; j += 32) qg[j] = 0;
  float amax = 0.0f;
  for (int j = lane; j < W; j += 32) amax = fmaxf(amax, fabsf(to_f32(x[base + j])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
  for (int j = lane; j < W; j += 32) {
    const float c = fminf(fmaxf(rintf(__fdiv_rn(to_f32(x[base + j]), s)), -127.0f), 127.0f);
    qg[j] = static_cast<int8_t>(c);
  }
  if (lane == 0) scales[wid] = s;
}

namespace s8 {

using namespace wg;  // mbarriers, TMA, descriptors, wgmma

constexpr int BK = 128;              // bytes (int8 codes) of K a stage: one swizzled 128-byte row
constexpr int BOX_BYTES = 128 * BK;  // a 128-row operand box: 16 KB
constexpr int CONSUMERS = 2;         // consumer warpgroups of gemm_s8, beside one producer warpgroup

enum EpilogueS8 : int { EPI_S8_BIAS_BF16 = 0, EPI_S8_CHUNKS_RESID_F32 = 1 };

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int stages, int consumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Registers a thread after setmaxnreg, for `consumers` consumer warpgroups
// beside one producer warpgroup: each SM sub-partition holds one producer
// warp and `consumers` consumer warps in its 512 registers a lane (16,384 /
// 32): 40 + 2 x 232 or 24 + 3 x 160.
template <int consumers>
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(consumers == 2 ? 40 : 24));
}
template <int consumers>
__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(consumers == 2 ? 232 : 160));
}

// the consumer warpgroups alone (the producer does not wait here)
template <int consumers>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(128 * consumers) : "memory");
}

// ---- gemm_s8: C (M, N) = epilogue(A (M, K) . Bt (N, K)^T), a 128 x 128 tile a unit ----
// The K axis runs in chunks of `chunk` codes; chunk c's int32 partial is
// dequantized by row_scale[row * (K / chunk) + c] * col_scale[col]:
//   EPI_S8_BIAS_BF16:        one chunk; C bf16 = bf16(dq + bias)
//   EPI_S8_CHUNKS_RESID_F32: C f32 = (resid + bias) + dq_0 + dq_1 + ... in order
struct GemmParams {
  int M, N, K, chunk;
  const float* row_scale;  // (M, K / chunk)
  const float* col_scale;  // (N)
  const float* bias;       // (N)
  const bf16* resid;       // (M, N), EPI_S8_CHUNKS_RESID_F32
  void* C;                 // (M, N) bf16 or f32
};

constexpr int G_STAGES = 6;
constexpr int G_STAGE_BYTES = 2 * BOX_BYTES;  // A 128 rows, Bt 128 rows
constexpr int G_SMEM_BYTES = G_STAGES * G_STAGE_BYTES + 1024 /* alignment */ + 2 * G_STAGES * 8;

// accumulator layout (wgmma m64nN): element (row 16 * warp + lane / 4 + 8i,
// column 8j + 2 (lane % 4) + e) of the warpgroup's 64 rows at [4j + 2i + e]
template <int EPI>
__device__ __forceinline__ void dequant_chunk(float (&f)[64], const int (&acc)[64], const GemmParams& p, int row0,
                                              int n0, int lane, int c, int nchunks) {
  float rs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    rs[i] = row < p.M ? p.row_scale[(size_t)row * nchunks + c] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    if (col >= p.N) continue;
    const float2 cs = *reinterpret_cast<const float2*>(p.col_scale + col);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float v0 = __fmul_rn(static_cast<float>(acc[4 * j + 2 * i]), __fmul_rn(rs[i], cs.x));
      const float v1 = __fmul_rn(static_cast<float>(acc[4 * j + 2 * i + 1]), __fmul_rn(rs[i], cs.y));
      if (EPI == EPI_S8_CHUNKS_RESID_F32) {
        f[4 * j + 2 * i] = __fadd_rn(f[4 * j + 2 * i], v0);
        f[4 * j + 2 * i + 1] = __fadd_rn(f[4 * j + 2 * i + 1], v1);
      } else {
        f[4 * j + 2 * i] = v0;
        f[4 * j + 2 * i + 1] = v1;
      }
    }
  }
}

// Persistent: CTA b takes tiles b, b + gridDim.x, ... (along N first, so
// concurrent tiles share their A rows in L2); the producer runs ahead into
// the next tile while the consumers finish this one. Rows and columns past
// M and N, and K past the last chunk, come in as zeros (TMA's fill).
// SPLIT = 1: chunks of whole stages (chunk % 128 == 0); SPLIT = 2: a chunk
// of 64 codes x odd may end half way through a stage.
template <int EPI, int SPLIT>
__global__ void __launch_bounds__(128 * (CONSUMERS + 1), 1)
    gemm_s8_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                   const GemmParams p, int units) {
  constexpr int SUB = BK / SPLIT;  // codes of K a step
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G_STAGES * G_STAGE_BYTES);
  uint64_t* empty = full + G_STAGES;
  const int warpgroup = threadIdx.x / 128;
  const int tiles_n = (p.N + 127) / 128;
  const int k_tiles = (p.K + BK - 1) / BK;
  init_ring(full, empty, G_STAGES, CONSUMERS);

  if (warpgroup == CONSUMERS) {
    producer_registers<CONSUMERS>();
    if (threadIdx.x == CONSUMERS * 128) {  // one thread of the producer warpgroup keeps the ring full
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int m0 = (u / tiles_n) * 128, n0 = (u % tiles_n) * 128;
        for (int t = 0; t < k_tiles; ++t, ++it) {
          const int s = it % G_STAGES;
          if (it >= G_STAGES) mbar_wait(&empty[s], ((it / G_STAGES) - 1) & 1);
          mbar_expect_tx(&full[s], G_STAGE_BYTES);
          uint8_t* st = smem + s * G_STAGE_BYTES;
          tma_load(&ta, st, &full[s], t * BK, m0);
          tma_load(&tb, st + BOX_BYTES, &full[s], t * BK, n0);
        }
      }
    }
    return;
  }
  consumer_registers<CONSUMERS>();

  const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
  const int nchunks = p.K / p.chunk, steps = p.chunk / SUB;
  int it = 0;  // K tiles consumed so far, over all units
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int m0 = (u / tiles_n) * 128, n0 = (u % tiles_n) * 128;
    const int row0 = m0 + warpgroup * 64 + warp * 16 + (lane >> 2);
    float f[64];
    int acc[64];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        float v0 = 0.0f, v1 = 0.0f;
        if (EPI == EPI_S8_CHUNKS_RESID_F32 && row < p.M && col < p.N) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(p.resid + (size_t)row * p.N + col);
          v0 = __fadd_rn(__low2float(r), p.bias[col]);
          v1 = __fadd_rn(__high2float(r), p.bias[col + 1]);
        }
        f[4 * j + 2 * i] = v0;
        f[4 * j + 2 * i + 1] = v1;
      }
    }

    // chunk by chunk, in steps of SUB codes (a stage, or half of one): no
    // branch around a wgmma, so the products of a chunk stay in flight
    // back to back; a chunk's end waits for its sums and dequantizes them
    int step = 0, released = 0;  // steps issued, stages given back in this unit
    for (int c = 0; c < nchunks; ++c) {
      for (int q = 0; q < steps; ++q, ++step) {
        const int t = step / SPLIT, h = step % SPLIT;
        const int s = (it + t) % G_STAGES;
        if (h == 0) mbar_wait(&full[s], ((it + t) / G_STAGES) & 1);
        const uint32_t a_st = smem_u32(smem + s * G_STAGE_BYTES) + warpgroup * (64 * BK) + h * SUB;
        const uint32_t b_st = smem_u32(smem + s * G_STAGE_BYTES + BOX_BYTES) + h * SUB;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < SUB / 32; ++k)  // a chunk's first step overwrites the sums (scale-d = 0)
          wgmma_m64n128_s8(acc, a_st + 32 * k, b_st + 32 * k, k > 0 || q > 0);
        wgmma_commit();
        if (h == SPLIT - 1) {  // the stage's products are issued; the previous stage's are done
          wgmma_wait<1>();
          if (t > 0) {
            if (threadIdx.x % 128 == 0) mbar_arrive(&empty[(it + t - 1) % G_STAGES]);
            released = t;
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      dequant_chunk<EPI>(f, acc, p, row0, n0, lane, c, nchunks);
    }
    for (int t = released; t < k_tiles; ++t)
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[(it + t) % G_STAGES]);
    it += k_tiles;

#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col >= p.N) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row >= p.M) continue;
        const size_t off = (size_t)row * p.N + col;
        if (EPI == EPI_S8_BIAS_BF16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.C) + off) = __floats2bfloat162_rn(
              __fadd_rn(f[4 * j + 2 * i], p.bias[col]), __fadd_rn(f[4 * j + 2 * i + 1], p.bias[col + 1]));
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(p.C) + off) =
              make_float2(f[4 * j + 2 * i], f[4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

// ---- gemm_s8_gelu_quant: the codes of gelu(dq(A . W1) + b1) per (row, chunk) ----
struct GeluQuantParams {
  int M, N, K, chunk;      // N = FF, chunk = FF / ff_chunks
  const float* row_scale;  // (M) x's scales
  const float* col_scale;  // (N) W1's column scales
  const float* bias;       // (N) b1
  int8_t* hq;              // (M, N) codes of the gelu output
  float* hs;               // (M, N / chunk) their scales
};

constexpr int Q_ROWS = 64;                                    // rows a unit (one wgmma M)
constexpr int Q_CONSUMERS = 3;                                // consumer warpgroups
constexpr int Q_SUBS = 2;                                     // 128-wide accumulators a warpgroup
constexpr int Q_WG_COLS = Q_SUBS * 128;                       // columns a warpgroup
constexpr int Q_COLS = Q_CONSUMERS * Q_WG_COLS;               // 768 columns a pass
constexpr int Q_STAGES = 2;
constexpr int Q_A_BYTES = Q_ROWS * BK;                        // 8 KB
constexpr int Q_STAGE_BYTES = Q_A_BYTES + Q_COLS * BK;        // 104 KB
constexpr int Q_RED_BYTES = 2 * Q_CONSUMERS * Q_ROWS * 4;     // partial amaxes, two units' worth
constexpr int Q_SMEM_BYTES = Q_STAGES * Q_STAGE_BYTES + 1024 + 2 * Q_STAGES * 8 + Q_RED_BYTES;

// Persistent over units (64 rows, one FF chunk); rows along the chunks
// first. A pass is one K loop over the 64 rows and up to 768 of the
// chunk's columns; a chunk of <= 768 columns is one pass, amax and codes
// from the same registers. A wider chunk runs its passes twice: first for
// the amax, then again for the codes.
__global__ void __launch_bounds__(128 * (Q_CONSUMERS + 1), 1)
    gemm_s8_gelu_quant_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                              const GeluQuantParams p, int units) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Q_STAGES * Q_STAGE_BYTES);
  uint64_t* empty = full + Q_STAGES;
  float* red = reinterpret_cast<float*>(empty + Q_STAGES);  // [unit parity][warpgroup][row]
  const int warpgroup = threadIdx.x / 128;
  const int nchunks = p.N / p.chunk;
  const int k_tiles = (p.K + BK - 1) / BK;
  const int passes = (p.chunk + Q_COLS - 1) / Q_COLS;
  const int rounds = passes == 1 ? 1 : 2 * passes;
  init_ring(full, empty, Q_STAGES, Q_CONSUMERS);

  if (warpgroup == Q_CONSUMERS) {
    producer_registers<Q_CONSUMERS>();
    if (threadIdx.x == Q_CONSUMERS * 128) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int m0 = (u / nchunks) * Q_ROWS, c = u % nchunks;
        for (int r = 0; r < rounds; ++r) {
          const int col0 = (r % passes) * Q_COLS;
          for (int t = 0; t < k_tiles; ++t, ++it) {
            const int s = it % Q_STAGES;
            if (it >= Q_STAGES) mbar_wait(&empty[s], ((it / Q_STAGES) - 1) & 1);
            mbar_expect_tx(&full[s], Q_STAGE_BYTES);
            uint8_t* st = smem + s * Q_STAGE_BYTES;
            tma_load(&ta, st, &full[s], t * BK, m0);
            for (int b = 0; b < Q_CONSUMERS * Q_SUBS; ++b)
              tma_load(&tb, st + Q_A_BYTES + b * BOX_BYTES, &full[s], t * BK, c * p.chunk + col0 + 128 * b);
          }
        }
      }
    }
    return;
  }
  consumer_registers<Q_CONSUMERS>();

  const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
  int it = 0, parity = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, parity ^= 1) {
    const int m0 = (u / nchunks) * Q_ROWS, c = u % nchunks;
    const int rl0 = warp * 16 + (lane >> 2);  // this thread's rows: rl0 and rl0 + 8 of the unit
    float rs[2], amax[2] = {0.0f, 0.0f}, scale[2] = {1.0f, 1.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + rl0 + 8 * i;
      rs[i] = row < p.M ? p.row_scale[row] : 0.0f;
    }
    for (int r = 0; r < rounds; ++r) {
      const int col0 = (r % passes) * Q_COLS;
      int acc[Q_SUBS][64];
      // every accumulator runs every step, also past the chunk's (or FF's)
      // last column, where the epilogue drops it: a wgmma under a branch
      // that depends on the warpgroup would be serialized
      for (int t = 0; t < k_tiles; ++t, ++it) {
        const int s = it % Q_STAGES;
        mbar_wait(&full[s], (it / Q_STAGES) & 1);
        const uint32_t a_st = smem_u32(smem + s * Q_STAGE_BYTES);
        const uint32_t b_st = a_st + Q_A_BYTES + warpgroup * Q_SUBS * BOX_BYTES;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 32; ++k) {
#pragma unroll
          for (int sub = 0; sub < Q_SUBS; ++sub)
            wgmma_m64n128_s8(acc[sub], a_st + 32 * k, b_st + sub * BOX_BYTES + 32 * k, k > 0 || t > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (t > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(it - 1) % Q_STAGES]);
      }
      wgmma_wait<0>();
      if (k_tiles > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(it - 1) % Q_STAGES]);
#pragma unroll
      for (int sub = 0; sub < Q_SUBS; ++sub) fence_regs(acc[sub]);

      // gelu(dq + b1) in place of the int32 sums (as f32 bits); the amax
      // rounds fold |h| into the rows' partial amax. The columns past the
      // chunk are skipped (a warp-uniform branch): computing them for
      // nothing spilled registers
      const bool amax_round = r < passes;
#pragma unroll
      for (int sub = 0; sub < Q_SUBS; ++sub) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int cc = col0 + warpgroup * Q_WG_COLS + sub * 128 + 8 * j;  // the 8 columns' start in the chunk
          if (cc >= p.chunk) continue;                                       // the same for the whole warp
          const int col = c * p.chunk + cc + 2 * (lane & 3);
          const float2 cs = *reinterpret_cast<const float2*>(p.col_scale + col);
          const float2 b = *reinterpret_cast<const float2*>(p.bias + col);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float h0 = gelu_poly(
                __fadd_rn(__fmul_rn(static_cast<float>(acc[sub][4 * j + 2 * i]), __fmul_rn(rs[i], cs.x)), b.x));
            const float h1 = gelu_poly(__fadd_rn(
                __fmul_rn(static_cast<float>(acc[sub][4 * j + 2 * i + 1]), __fmul_rn(rs[i], cs.y)), b.y));
            acc[sub][4 * j + 2 * i] = __float_as_int(h0);
            acc[sub][4 * j + 2 * i + 1] = __float_as_int(h1);
            const float a = fmaxf(amax[i], fmaxf(fabsf(h0), fabsf(h1)));
            if (amax_round) amax[i] = a;
          }
        }
      }

      if (r == passes - 1) {  // every column of the chunk seen: the rows' scales
        float* red_u = red + parity * Q_CONSUMERS * Q_ROWS;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float a = amax[i];
          a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
          a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 2));
          if ((lane & 3) == 0) red_u[warpgroup * Q_ROWS + rl0 + 8 * i] = a;
        }
        consumers_sync<Q_CONSUMERS>();  // (a unit's buffer is written again two units later, after another sync)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float a = red_u[rl0 + 8 * i];
#pragma unroll
          for (int w = 1; w < Q_CONSUMERS; ++w) a = fmaxf(a, red_u[w * Q_ROWS + rl0 + 8 * i]);
          scale[i] = fmaxf(__fdiv_rn(a, 127.0f), 1e-12f);
          const int row = m0 + rl0 + 8 * i;
          if (warpgroup == 0 && (lane & 3) == 0 && row < p.M) p.hs[(size_t)row * nchunks + c] = scale[i];
        }
      }

      if (passes == 1 || r >= passes) {  // codes: 2 columns x 2 rows a thread, swapped with the
                                         // neighbouring lane into one 4-byte store per row
#pragma unroll
        for (int sub = 0; sub < Q_SUBS; ++sub) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int cc = col0 + warpgroup * Q_WG_COLS + sub * 128 + 8 * j;
            if (cc >= p.chunk) continue;
            uint32_t code[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              uint32_t two = 0;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float h = __int_as_float(acc[sub][4 * j + 2 * i + e]);
                const float q = fminf(fmaxf(rintf(__fdiv_rn(h, scale[i])), -127.0f), 127.0f);
                two |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xffu) << (8 * e);
              }
              code[i] = two;
            }
            // even lanes store row rl0's 4 columns, odd lanes row rl0 + 8's
            const bool odd = lane & 1;
            const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? code[0] : code[1], 1);
            const uint32_t word = odd ? (got | (code[1] << 16)) : (code[0] | (got << 16));
            const int row = m0 + rl0 + (odd ? 8 : 0);
            const int col = c * p.chunk + cc + 2 * ((lane & 3) & ~1);
            if (row < p.M) *reinterpret_cast<uint32_t*>(p.hq + (size_t)row * p.N + col) = word;
          }
        }
      }
    }
  }
}

template <typename Kernel, typename Params>
inline cudaError_t launch_persistent(Kernel kernel, int threads, int smem_bytes, const CUtensorMap& ta,
                                     const CUtensorMap& tb, const Params& p, int units, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  if (units <= 0) return cudaSuccess;
  const int grid = units < sm_count() ? units : sm_count();
  kernel<<<grid, threads, smem_bytes, stream>>>(ta, tb, p, units);
  return cudaGetLastError();
}

template <int EPI>
inline cudaError_t launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb, const GemmParams& p, int units,
                               cudaStream_t stream) {
  constexpr int threads = 128 * (CONSUMERS + 1);
  return p.chunk % BK ? launch_persistent(gemm_s8_kernel<EPI, 2>, threads, G_SMEM_BYTES, ta, tb, p, units, stream)
                      : launch_persistent(gemm_s8_kernel<EPI, 1>, threads, G_SMEM_BYTES, ta, tb, p, units, stream);
}

}  // namespace s8
}  // namespace mm

using namespace mm;

extern "C" {

// q (M, G*WP) int8 codes and scales (M, G) f32 of x (M, G*W), bf16
// (x_is_f32 = 0) or f32 (x_is_f32 = 1), quantized per row and group of W,
// each group's codes padded with zeros to WP >= W.
int mm_quant_groups(const void* x, void* q, void* scales, int M, int G, int W, int WP, int x_is_f32, void* stream) {
  if (WP < W) return static_cast<int>(cudaErrorInvalidValue);
  const long long warps = (long long)M * G;
  const unsigned blocks = (unsigned)((warps + 7) / 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_f32)
    quant_groups_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(x), static_cast<int8_t*>(q),
                                                       static_cast<float*>(scales), M, G, W, WP);
  else
    quant_groups_kernel<bf16><<<blocks, 256, 0, s>>>(static_cast<const bf16*>(x), static_cast<int8_t*>(q),
                                                      static_cast<float*>(scales), M, G, W, WP);
  return static_cast<int>(cudaGetLastError());
}

// C (M, N) = dequant(A (M, K) int8 . Bt (N, K)^T int8) + epilogue (see
// gemm_s8_kernel); both operands K-major; row_scale (M, K/chunk) f32,
// col_scale and bias (N) f32, resid (M, N) bf16 for EPI_S8_CHUNKS_RESID_F32.
// K % 64 == 0, K % chunk == 0, chunk % 64 == 0, N even.
int mm_wg_gemm_s8(const void* A, const void* Bt, const void* row_scale, const void* col_scale, const void* bias,
                  const void* resid, void* C, int M, int N, int K, int chunk, int epilogue, void* stream) {
  if (K <= 0 || chunk <= 0 || chunk % 64 || K % chunk || N % 2) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  if (!wg::make_map(&ta, A, K, M, false, CU_TENSOR_MAP_DATA_TYPE_UINT8, 128) ||
      !wg::make_map(&tb, Bt, K, N, false, CU_TENSOR_MAP_DATA_TYPE_UINT8, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const s8::GemmParams p{M, N, K, chunk, static_cast<const float*>(row_scale), static_cast<const float*>(col_scale),
                         static_cast<const float*>(bias), static_cast<const bf16*>(resid), C};
  const int units = ((M + 127) / 128) * ((N + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case s8::EPI_S8_BIAS_BF16:
      return static_cast<int>(s8::launch_gemm<s8::EPI_S8_BIAS_BF16>(ta, tb, p, units, s));
    case s8::EPI_S8_CHUNKS_RESID_F32:
      return static_cast<int>(s8::launch_gemm<s8::EPI_S8_CHUNKS_RESID_F32>(ta, tb, p, units, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// hq (M, N) int8 and hs (M, N/chunk) f32: the per-(row, chunk) codes and
// scales of gelu_poly(dequant(A (M, K) int8 . W1t (N, K)^T int8) + bias),
// dequantized by row_scale (M) x col_scale (N). K % 32 == 0, chunk % 64 == 0,
// N % chunk == 0.
int mm_wg_gemm_s8_gelu_quant(const void* A, const void* W1t, const void* row_scale, const void* col_scale,
                             const void* bias, void* hq, void* hs, int M, int N, int K, int chunk, void* stream) {
  if (K <= 0 || K % 32 || chunk <= 0 || chunk % 64 || N % chunk) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  if (!wg::make_map(&ta, A, K, M, false, CU_TENSOR_MAP_DATA_TYPE_UINT8, s8::Q_ROWS) ||
      !wg::make_map(&tb, W1t, K, N, false, CU_TENSOR_MAP_DATA_TYPE_UINT8, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const s8::GeluQuantParams p{M, N, K, chunk, static_cast<const float*>(row_scale),
                              static_cast<const float*>(col_scale), static_cast<const float*>(bias),
                              static_cast<int8_t*>(hq), static_cast<float*>(hs)};
  const int units = ((M + s8::Q_ROWS - 1) / s8::Q_ROWS) * (N / chunk);
  return static_cast<int>(s8::launch_persistent(s8::gemm_s8_gelu_quant_kernel, 128 * (s8::Q_CONSUMERS + 1),
                                                s8::Q_SMEM_BYTES, ta, tb, p, units,
                                                static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
