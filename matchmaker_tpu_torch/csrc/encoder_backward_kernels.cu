// Backward of the encoder's fused layer halves, written for Hopper.
//
// Replaces the Pallas kernels of matchmaker_tpu/ops/fused_backward.py:
//   K11 _mlp_bwd_kernel  (MLP half):       dx, dW1, db1, dW2, db2, dgamma, dbeta
//   K12 _attn_bwd_kernel (attention half): dx, dWq/k/v/o, dbq/k/v/o, dgamma, dbeta
// from the block input x, the upstream gradient dy (bf16) and the f32 pre-LN
// sums the forward saved. The function is the TPU kernels'; the fusion
// boundaries are not. Each half is one call from ops/fused_backward.py
// (mm_attention_block_bwd, mm_mlp_block_bwd) that issues these launches:
//   both: ln_bwd (LayerNorm backward, per-block column partials of dgamma,
//         dbeta and the output bias) -> colsum (second pass, fixed order)
//   K11:  wgrad dW2 = h^T.dacc; dz = bf16((dacc.W2^T) * gelu'(x.W1 + b1)) in
//         one GEMM with two accumulators; wgrad dW1 = x^T.dz; colsum db1;
//         dx = bf16(dacc + dz.W1^T)
//   K12:  wgrad dWo = a^T.dacc; da = bf16(dacc.Wo^T); attention core
//         backward (dq, then dk/dv) into the packed (B, L, 3H) dqkv;
//         wgrad dWqkv = x^T.dqkv; colsum dbqkv; dx = bf16(dacc + dqkv.Wqkv^T)
// The forward's own outputs (qkv, the attention output a, the gelu output h)
// are kept by the training forward instead of being recomputed.
//
// What bounds them on the card: the products (2*R*I*J flops over R = B*L >=
// 960 rows) are compute bound and run on wgmma with TMA (wgmma_gemm.cuh);
// the weight gradients read both row-major operands MN-major, so no
// transpose pass exists, and split their rows only when the output has too
// few tiles for the card, into separate partials summed by a second pass in
// a fixed order. The column sums (biases, LayerNorm) are two-pass reductions
// too: no float atomics, so a gradient is the same run to run.
//
// The attention core backward (head width 64) runs all five products on the
// tensor cores (mma.sync m16n8k16, operands through ldmatrix): S = QK^T,
// dP = dA.V^T, dV = P^T.dA, dQ = dS.K, dK = dS^T.Q. The TPU kept P and dS
// f32 into their products; here P enters dV and dS enters dQ as bf16, and dS
// enters dK as a bf16 hi + lo pair (the key-bias gradient, zero in exact
// arithmetic, keeps its noise ten times below what one rounding leaves); the
// CPU test tests/test_torch_attention_bwd_rounding.py holds this rounding to
// the bars. The row term D = sum_j P_ij dP_ij is summed exactly, online in
// the first pass, not from an f32 P.V. Kernel 1 owns 64 queries of one
// (example, head): a pass over 64-key tiles for each row's max, sum of
// exponentials and D, then a second pass for dS and dQ; kernel 2 owns 64
// keys and loops over the query tiles with kernel 1's row statistics, so dK
// and dV sum over every query in one block, without atomics. No L-wide row
// is ever held in shared memory.
#include "mma_sync.cuh"
#include "wgmma_gemm.cuh"

#include <math.h>

namespace mm {

using bf16 = __nv_bfloat16;

// out[e] = sum over s of partial[s][e], in order of s
__global__ void __launch_bounds__(256) sum_splits_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                                         int splits, size_t n) {
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * n + e];
  out[e] = s;
}

// ---- column sums in two passes ---------------------------------------------
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// partial[split][c] = sum of x[r][c] over the split's rows. Grid (C/256, splits).
template <typename T>
__global__ void __launch_bounds__(256) colsum_partial_kernel(const T* __restrict__ x, float* __restrict__ partial,
                                                             int M, int C, int rows_per_split) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= C) return;
  const int r0 = blockIdx.y * rows_per_split, r1 = min(M, r0 + rows_per_split);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) s += to_f32(x[(size_t)r * C + c]);
  partial[(size_t)blockIdx.y * C + c] = s;
}

// ---- LayerNorm backward ------------------------------------------------------
// One block = LNB_ROWS rows of N = 128 * C columns, a warp per row at a time;
// lane l holds columns 128c + 4l .. + 3 of its row in registers, read once:
// two-pass mean and variance as the forward, then
// dacc = rstd.(dy.g - mean(dy.g) - yhat.mean(dy.g.yhat)) (f32 and bf16 copies).
// Each warp sums its rows' dgamma += dy.yhat, dbeta += dy, dbias += dacc into
// its own shared-memory row; the block then adds the eight warps' rows in
// order into this block's row of partial (blocks, 3N) for the second pass.
constexpr int LNB_ROWS = 32;
constexpr int LNB_WARPS = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int C>
__global__ void __launch_bounds__(32 * LNB_WARPS) ln_bwd_kernel(const float* __restrict__ acc,
                                                                const bf16* __restrict__ dy,
                                                                const float* __restrict__ gamma,
                                                                float* __restrict__ dacc, bf16* __restrict__ dacc_lp,
                                                                float* __restrict__ partial, int M, float eps) {
  constexpr int N = 128 * C;
  extern __shared__ float ws[];  // [LNB_WARPS][3N]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = ws + warp * 3 * N;
  for (int c = lane; c < 3 * N; c += 32) mine[c] = 0.0f;
  for (int rr = warp; rr < LNB_ROWS; rr += LNB_WARPS) {
    const int row = blockIdx.x * LNB_ROWS + rr;
    if (row >= M) break;
    float x[C][4], d[C][4];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t off = (size_t)row * N + 128 * c + 4 * lane;
      const float4 xv = *reinterpret_cast<const float4*>(acc + off);
      const uint2 raw = *reinterpret_cast<const uint2*>(dy + off);
      const bf16* db = reinterpret_cast<const bf16*>(&raw);
      x[c][0] = xv.x, x[c][1] = xv.y, x[c][2] = xv.z, x[c][3] = xv.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) d[c][e] = __bfloat162float(db[e]);
    }
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum += x[c][e];
    const float mean = warp_sum(sum) / N;
    float q = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) q += (x[c][e] - mean) * (x[c][e] - mean);
    const float rstd = rsqrtf(warp_sum(q) / N + eps);
    float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 g = *reinterpret_cast<const float4*>(gamma + 128 * c + 4 * lane);
      const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[c][e] = (x[c][e] - mean) * rstd;  // yhat from here on
        const float dyh = d[c][e] * gv[e];
        m1 += dyh;
        m2 += dyh * x[c][e];
      }
    }
    m1 = warp_sum(m1) / N;
    m2 = warp_sum(m2) / N;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = 128 * c + 4 * lane;
      const float4 g = *reinterpret_cast<const float4*>(gamma + col);
      const float gv[4] = {g.x, g.y, g.z, g.w};
      float v[4];
      __align__(8) bf16 lp[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = rstd * (d[c][e] * gv[e] - m1 - x[c][e] * m2);
        lp[e] = __float2bfloat16(v[e]);
        mine[col + e] += d[c][e] * x[c][e];
        mine[N + col + e] += d[c][e];
        mine[2 * N + col + e] += v[e];
      }
      const size_t off = (size_t)row * N + col;
      *reinterpret_cast<float4*>(dacc + off) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<uint2*>(dacc_lp + off) = *reinterpret_cast<const uint2*>(lp);
    }
  }
  __syncthreads();  // every warp's column sums are in shared memory
  for (int c = threadIdx.x; c < 3 * N; c += 32 * LNB_WARPS) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < LNB_WARPS; ++w) t += ws[w * 3 * N + c];
    partial[(size_t)blockIdx.x * 3 * N + c] = t;
  }
}

template <int C>
cudaError_t launch_ln_bwd(const float* acc, const bf16* dy, const float* gamma, float* dacc, bf16* dacc_lp,
                          float* partial, int M, float eps, cudaStream_t s) {
  const int smem = LNB_WARPS * 3 * 128 * C * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ln_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ln_bwd_kernel<C><<<(M + LNB_ROWS - 1) / LNB_ROWS, 32 * LNB_WARPS, smem, s>>>(acc, dy, gamma, dacc, dacc_lp,
                                                                              partial, M, eps);
  return cudaGetLastError();
}

// ---- attention core backward -------------------------------------------------
constexpr int AH = 64;            // head width
constexpr int AT = 64;            // query or key rows of a tile
constexpr int A_THREADS = 128;    // 4 warps, 16 rows of the block's own tile each
constexpr int T_LD = AH + 8;      // padded bf16 tile rows: 144 bytes, ldmatrix rows on distinct banks
constexpr int TILE_ELEMS = AT * T_LD;
constexpr int MAX_KEYS = 512;
constexpr size_t DQ_SMEM_BYTES = (size_t)6 * TILE_ELEMS * 2 + MAX_KEYS * 4;
constexpr size_t DKV_SMEM_BYTES = (size_t)6 * TILE_ELEMS * 2 + 2 * 3 * AT * 4;

// rows [r0, r0 + 64) of one head's 64 columns (column offset col0 in rows of
// row_w) into a [64][T_LD] tile; rows past L read as zero
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* base, int row_w, int col0, int r0, int L) {
  for (int c = threadIdx.x; c < AT * AH / 8; c += A_THREADS) {
    const int row = c >> 3, col = (c & 7) * 8;
    const bool ok = r0 + row < L;
    cp_async16(dst + row * T_LD + col, base + (size_t)(ok ? r0 + row : 0) * row_w + col0 + col, ok);
  }
}

// A fragments (16 rows x 64 columns, four 16-deep blocks) of a [row][col] tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* tile, int row0, int lane) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) ldsm_x4(a[kb], tile + (row0 + (lane & 15)) * T_LD + kb * 16 + (lane >> 4) * 8);
}

// the 16 x 64 f32 C fragments as bf16 A fragments over their 64 columns
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    a[kb][0] = pack_bf16(c[2 * kb][0], c[2 * kb][1]);
    a[kb][1] = pack_bf16(c[2 * kb][2], c[2 * kb][3]);
    a[kb][2] = pack_bf16(c[2 * kb + 1][0], c[2 * kb + 1][1]);
    a[kb][3] = pack_bf16(c[2 * kb + 1][2], c[2 * kb + 1][3]);
  }
}

// c (16 x 64) = a (16 x 64) . tile^T, tile [n][k]: the other side's 64 rows
__device__ __forceinline__ void mma_nt(float (&c)[8][4], const uint32_t (&a)[4][4], const bf16* tile, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, tile + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * T_LD + kb * 16 + ((lane >> 3) & 1) * 8);
      mma16816(c[2 * np], a[kb], b[0], b[1]);
      mma16816(c[2 * np + 1], a[kb], b[2], b[3]);
    }
  }
}

// c (16 x 64) += a (16 x 64, contracting the tile's rows) . tile, tile [k][n]
__device__ __forceinline__ void mma_nn(float (&c)[8][4], const uint32_t (&a)[4][4], const bf16* tile, int lane) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, tile + (16 * kb + (lane & 7) + (((lane >> 3) & 1) << 3)) * T_LD + 16 * np + (lane >> 4) * 8);
      mma16816(c[2 * np], a[kb], b[0], b[1]);
      mma16816(c[2 * np + 1], a[kb], b[2], b[3]);
    }
  }
}

// the 16 x 64 C fragments as bf16 rows of a (rows, row_w) tensor at column
// col0 (rows past L are skipped); fragment [j][2i + e] holds row lane/4 + 8i,
// column 8j + 2(lane%4) + e
__device__ __forceinline__ void store_rows(bf16* out, const float (&c)[8][4], int row0, int L, int row_w, int col0,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + lane / 4 + 8 * i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(out + (size_t)row * row_w + col0 + 8 * j + 2 * (lane & 3)) =
          pack_bf16(c[j][2 * i], c[j][2 * i + 1]);
  }
}

// Kernel 1: one block per (64-query tile, head, example). qkv (B, L, 3*HID)
// from the forward, da (B, L, HID) the gradient of the attention output.
// Writes dq into dqkv[:, :, 0:HID] and each query's row statistics (max,
// sum of exp, D = sum_j P_ij dP_ij) into stats (3, B, H, L) for kernel 2.
__global__ void __launch_bounds__(A_THREADS, 3)
    attention_bwd_q_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                               const bf16* __restrict__ da, bf16* __restrict__ dqkv, float* __restrict__ stats,
                               int L, int H, float scale) {
  extern __shared__ __align__(128) char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = Qs + TILE_ELEMS;
  bf16* Kb = Ds + TILE_ELEMS;      // two buffers
  bf16* Vb = Kb + 2 * TILE_ELEMS;  // two buffers
  float* negk = reinterpret_cast<float*>(Vb + 2 * TILE_ELEMS);

  const int q0 = blockIdx.x * AT, h = blockIdx.y, b = blockIdx.z;
  const int HID = H * AH, ROW = 3 * HID;
  const bf16* base = qkv + (size_t)b * L * ROW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (L + AT - 1) / AT;
  auto stage_kv = [&](int t) {
    stage_tile(Kb + (t & 1) * TILE_ELEMS, base, ROW, HID + h * AH, t * AT, L);
    stage_tile(Vb + (t & 1) * TILE_ELEMS, base, ROW, 2 * HID + h * AH, t * AT, L);
    cp_async_commit();
  };
  // tile t's K and V are in their buffers, the next tile's on their way
  auto next_tile = [&](int t) {
    if (t + 1 < tiles) {
      stage_kv(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };

  for (int j = tid; j < tiles * AT; j += A_THREADS)
    negk[j] = j < L ? (mask[(size_t)b * L + j] - 1.0f) * 1e9f : -INFINITY;
  stage_tile(Qs, base, ROW, h * AH, q0, L);
  stage_tile(Ds, da + (size_t)b * L * HID, HID, h * AH, q0, L);
  stage_kv(0);

  // pass 1: S and dP over the key tiles, for each row's max m, sum of
  // exp(s - m) and sum of exp(s - m) dP, rescaled as the max grows: D is the
  // last over the second, exactly the plain version's sum_j P_ij dP_ij
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f}, dsum[2] = {0.0f, 0.0f};
  for (int t = 0; t < tiles; ++t) {
    next_tile(t);
    uint32_t fa[4][4];
    float s[8][4], dp[8][4];
    load_a(fa, Qs, warp * 16, lane);
    mma_nt(s, fa, Kb + (t & 1) * TILE_ELEMS, lane);
    load_a(fa, Ds, warp * 16, lane);
    mma_nt(dp, fa, Vb + (t & 1) * TILE_ELEMS, lane);
    float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = s[j][e] * scale + negk[t * AT + 8 * j + 2 * (lane & 3) + (e & 1)];
        tm[e >> 1] = fmaxf(tm[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tm[i] = fmaxf(tm[i], __shfl_xor_sync(0xffffffffu, tm[i], 1));
      tm[i] = fmaxf(tm[i], __shfl_xor_sync(0xffffffffu, tm[i], 2));
      const float m_new = fmaxf(mx[i], tm[i]);
      const float keep = __expf(mx[i] - m_new);
      sum[i] *= keep;
      dsum[i] *= keep;
      mx[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ex = __expf(s[j][e] - mx[e >> 1]);
        sum[e >> 1] += ex;
        dsum[e >> 1] = fmaf(ex, dp[j][e], dsum[e >> 1]);
      }
    __syncthreads();  // the buffers are refilled two tiles on
  }
  float dd[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o);
      dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], o);
    }
    dd[i] = dsum[i] / sum[i];
    inv[i] = 1.0f / sum[i];
    const int q = q0 + warp * 16 + lane / 4 + 8 * i;
    if ((lane & 3) == 0 && q < L) {
      const size_t plane = (size_t)gridDim.z * H * L, at = ((size_t)b * H + h) * L + q;
      stats[at] = mx[i];
      stats[plane + at] = sum[i];
      stats[2 * plane + at] = dd[i];
    }
  }

  // pass 2: P from the statistics, dP = dA V^T, dS = P (dP - D) scale, dQ += dS K
  stage_kv(0);
  float dq[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    next_tile(t);
    const bf16* kt = Kb + (t & 1) * TILE_ELEMS;
    uint32_t fa[4][4];
    load_a(fa, Qs, warp * 16, lane);
    float s[8][4], dp[8][4];
    mma_nt(s, fa, kt, lane);
    load_a(fa, Ds, warp * 16, lane);
    mma_nt(dp, fa, Vb + (t & 1) * TILE_ELEMS, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = __expf(s[j][e] * scale + negk[t * AT + 8 * j + 2 * (lane & 3) + (e & 1)] - mx[i]) * inv[i];
        s[j][e] = p * (dp[j][e] - dd[i]) * scale;  // dS in place of S
      }
    c_to_a(fa, s);
    mma_nn(dq, fa, kt, lane);
    __syncthreads();
  }
  store_rows(dqkv + (size_t)b * L * ROW, dq, q0 + warp * 16, L, ROW, h * AH, lane);
}

// Kernel 2: one block per (64-key tile, head, example), looping over every
// 64-query tile: P^T = exp(K Q^T scale + mask - max) / sum from kernel 1's
// statistics, dP^T = V dA^T, dS^T = P^T (dP^T - D) scale; dV += P^T dA and
// dK += dS^T Q, kept in registers for the whole loop.
__global__ void __launch_bounds__(A_THREADS, 3)
    attention_bwd_kv_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                                const bf16* __restrict__ da, bf16* __restrict__ dqkv, const float* __restrict__ stats,
                                int L, int H, float scale) {
  extern __shared__ __align__(128) char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TILE_ELEMS;
  bf16* Qb = Vs + TILE_ELEMS;      // two buffers
  bf16* Db = Qb + 2 * TILE_ELEMS;  // two buffers
  float* qst = reinterpret_cast<float*>(Db + 2 * TILE_ELEMS);  // [2][3][64]: max, 1 / sum, D

  const int k0 = blockIdx.x * AT, h = blockIdx.y, b = blockIdx.z;
  const int HID = H * AH, ROW = 3 * HID;
  const bf16* base = qkv + (size_t)b * L * ROW;
  const bf16* dbase = da + (size_t)b * L * HID;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (L + AT - 1) / AT;
  const size_t plane = (size_t)gridDim.z * H * L;
  const float* st_row = stats + ((size_t)b * H + h) * L;
  auto load_stats = [&](int t) {  // plain loads, visible after the next __syncthreads
    float* dst = qst + (t & 1) * 3 * AT;
    for (int j = tid; j < AT; j += A_THREADS) {
      const int q = t * AT + j;
      const bool ok = q < L;
      dst[j] = ok ? st_row[q] : 0.0f;
      dst[AT + j] = ok ? 1.0f / st_row[plane + q] : 1.0f;  // 1 / sum of exp
      dst[2 * AT + j] = ok ? st_row[2 * plane + q] : 0.0f;
    }
  };

  float nk[2];  // this thread's key rows: the additive mask, -inf past L
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + lane / 4 + 8 * i;
    nk[i] = key < L ? (mask[(size_t)b * L + key] - 1.0f) * 1e9f : -INFINITY;
  }
  stage_tile(Ks, base, ROW, HID + h * AH, k0, L);
  stage_tile(Vs, base, ROW, 2 * HID + h * AH, k0, L);
  stage_tile(Qb, base, ROW, h * AH, 0, L);
  stage_tile(Db, dbase, HID, h * AH, 0, L);
  cp_async_commit();
  load_stats(0);

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage_tile(Qb + ((t + 1) & 1) * TILE_ELEMS, base, ROW, h * AH, (t + 1) * AT, L);
      stage_tile(Db + ((t + 1) & 1) * TILE_ELEMS, dbase, HID, h * AH, (t + 1) * AT, L);
      cp_async_commit();
      load_stats(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = Qb + (t & 1) * TILE_ELEMS;
    const bf16* dt = Db + (t & 1) * TILE_ELEMS;
    const float* qm = qst + (t & 1) * 3 * AT;
    uint32_t fa[4][4];
    load_a(fa, Ks, warp * 16, lane);
    float s[8][4], dp[8][4];
    mma_nt(s, fa, qt, lane);
    load_a(fa, Vs, warp * 16, lane);
    mma_nt(dp, fa, dt, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * (lane & 3) + (e & 1);
        const float p = t * AT + c < L ? __expf(s[j][e] * scale + nk[e >> 1] - qm[c]) * qm[AT + c] : 0.0f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - qm[2 * AT + c]) * scale;  // dS^T in place of dP^T
      }
    c_to_a(fa, s);
    mma_nn(dv, fa, dt, lane);
    // dS^T as a bf16 hi + lo pair into dK: the key-bias gradient sums dK over
    // the keys, where each row of dS sums to zero; one bf16 rounding of dS
    // would leave noise of the order of that gradient's bar
    c_to_a(fa, dp);
    mma_nn(dk, fa, qt, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] -= __bfloat162float(__float2bfloat16(dp[j][e]));
    c_to_a(fa, dp);
    mma_nn(dk, fa, qt, lane);
    __syncthreads();
  }
  bf16* out = dqkv + (size_t)b * L * ROW;
  store_rows(out, dk, k0 + warp * 16, L, ROW, HID + h * AH, lane);
  store_rows(out, dv, k0 + warp * 16, L, ROW, 2 * HID + h * AH, lane);
}

// column sums of x (M, C), bf16 or f32, into out (C) f32: two passes
// through partial (colsum_splits(M), C)
inline int colsum_splits(int M) { return M / 64 < 1 ? 1 : (M / 64 > 256 ? 256 : M / 64); }

cudaError_t colsum(const void* x, bool is_bf16, float* partial, float* out, int M, int C, cudaStream_t s) {
  const int splits = colsum_splits(M);
  const int rows = (M + splits - 1) / splits;
  const dim3 grid((C + 255) / 256, splits);
  if (is_bf16)
    colsum_partial_kernel<bf16><<<grid, 256, 0, s>>>(static_cast<const bf16*>(x), partial, M, C, rows);
  else
    colsum_partial_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x), partial, M, C, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_splits_kernel<<<(C + 255) / 256, 256, 0, s>>>(partial, out, splits, (size_t)C);
  return cudaGetLastError();
}

// LayerNorm backward over M rows of N (a multiple of 128, at most 1024):
// dacc f32 and bf16, and per-block column partials (ln_blocks(M), 3N) of
// dgamma, dbeta and sum(dacc).
inline int ln_blocks(int M) { return (M + LNB_ROWS - 1) / LNB_ROWS; }

cudaError_t ln_bwd(const float* acc, const bf16* dy, const float* gamma, float* dacc, bf16* dacc_lp, float* partial,
                   int M, int N, float eps, cudaStream_t s) {
  switch (N) {
    case 256: return launch_ln_bwd<2>(acc, dy, gamma, dacc, dacc_lp, partial, M, eps, s);
    case 384: return launch_ln_bwd<3>(acc, dy, gamma, dacc, dacc_lp, partial, M, eps, s);
    case 512: return launch_ln_bwd<4>(acc, dy, gamma, dacc, dacc_lp, partial, M, eps, s);
    case 768: return launch_ln_bwd<6>(acc, dy, gamma, dacc, dacc_lp, partial, M, eps, s);
    case 1024: return launch_ln_bwd<8>(acc, dy, gamma, dacc, dacc_lp, partial, M, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mm

using namespace mm;

extern "C" {

// C (M,N) = A (M,K) . B^T with B (N,K), both bf16 row-major, then the
// epilogue: 0 C bf16; 1 C bf16 = product + aux (M,N) f32 (wgmma_gemm.cuh).
int mm_wg_gemm(const void* A, const void* B, const void* aux, void* C, int M, int N, int K, int epilogue,
               void* stream) {
  CUtensorMap ta, tb;
  if (!wg::make_map(&ta, A, K, M, false) || !wg::make_map(&tb, B, K, N, false))
    return static_cast<int>(cudaErrorInvalidValue);
  const wg::Params p{M, N, K, (K + wg::BK - 1) / wg::BK, C, static_cast<const float*>(aux), nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case wg::EPI_BF16:
      return static_cast<int>(wg::launch<false, false, false, wg::EPI_BF16>(ta, tb, ta, tb, p, 1, s));
    case wg::EPI_RESID_BF16:
      return static_cast<int>(wg::launch<false, false, false, wg::EPI_RESID_BF16>(ta, tb, ta, tb, p, 1, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dz (M,FF) bf16 = (dacc (M,HID) . W2^T) * gelu'(x (M,HID) . W1 + b1), W1
// (HID,FF), W2 (FF,HID) bf16, b1 (FF) f32: one GEMM, two accumulators.
int mm_wg_gemm_dz(const void* x, const void* w1, const void* b1, const void* dacc, const void* w2, void* dz, int M,
                  int FF, int HID, void* stream) {
  CUtensorMap ta, tb, ta2, tb2;
  if (!wg::make_map(&ta, x, HID, M, false) || !wg::make_map(&tb, w1, FF, HID, true) ||
      !wg::make_map(&ta2, dacc, HID, M, false) || !wg::make_map(&tb2, w2, HID, FF, false))
    return static_cast<int>(cudaErrorInvalidValue);
  const wg::Params p{M, FF, HID, (HID + wg::BK - 1) / wg::BK, dz, nullptr, static_cast<const float*>(b1)};
  return static_cast<int>(
      wg::launch<false, true, true, wg::EPI_GELU_DZ>(ta, tb, ta2, tb2, p, 1, static_cast<cudaStream_t>(stream)));
}

// out (I,J) f32 = A^T (R,I) . B (R,J), bf16 inputs, both read MN-major; with
// splits > 1 split z contracts row tiles [z * k_tiles, (z + 1) * k_tiles)
// into partial[z] (splits, I, J), and a second pass sums them in order of z.
int mm_wg_wgrad(const void* A, const void* B, void* partial, void* out, int R, int I, int J, int splits,
                int k_tiles, void* stream) {
  CUtensorMap ta, tb;
  if (!wg::make_map(&ta, A, I, R, true) || !wg::make_map(&tb, B, J, R, true))
    return static_cast<int>(cudaErrorInvalidValue);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  const wg::Params p{I, J, R, k_tiles, dst, nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = wg::launch<true, true, false, wg::EPI_F32>(ta, tb, ta, tb, p, splits, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)I * J;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(dst, static_cast<float*>(out), splits, n);
  return static_cast<int>(cudaGetLastError());
}

// dqkv (B,L,3*H*64) bf16 from qkv (B,L,3*H*64), mask (B,L) f32 and da
// (B,L,H*64) bf16; stats (3,B,H,L) f32 is scratch passed between the kernels.
int mm_attention_bwd(const void* qkv, const void* mask, const void* da, void* dqkv, void* stats, int B, int L, int H,
                     float scale, void* stream) {
  if (L < 1 || L > MAX_KEYS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_q_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)DQ_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_kv_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DKV_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + AT - 1) / AT, H, B);
  const bf16* q = static_cast<const bf16*>(qkv);
  const float* m = static_cast<const float*>(mask);
  const bf16* d = static_cast<const bf16*>(da);
  bf16* out = static_cast<bf16*>(dqkv);
  float* st = static_cast<float*>(stats);
  attention_bwd_q_mma_kernel<<<grid, A_THREADS, DQ_SMEM_BYTES, s>>>(q, m, d, out, st, L, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_kv_mma_kernel<<<grid, A_THREADS, DKV_SMEM_BYTES, s>>>(q, m, d, out, st, L, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// ---- one call a half -----------------------------------------------------------
// ops/fused_backward.py makes one ctypes call for each half: its launches are
// issued here, so the host's time a half is one call, not one per launch.
namespace mm {

// One half's scratch, taken in order from the caller's workspace (each piece
// 256-byte aligned). With a null base it only adds up the bytes: the
// *_bytes entry points run the same code to size the workspace.
struct Arena {
  char* base;
  size_t used;
  template <typename T>
  T* take(size_t n) {
    const size_t off = (used + 255) & ~size_t(255);
    used = off + n * sizeof(T);
    return base != nullptr ? reinterpret_cast<T*>(base + off) : nullptr;
  }
};

#define MM_TRY(expr)                            \
  do {                                          \
    const int err_ = static_cast<int>(expr);    \
    if (err_ != 0) return err_;                 \
  } while (0)

// K12: x (M, HID) bf16 the block input, wqkv (HID, 3HID), wo (HID, HID) bf16,
// mask (B, L) f32, gamma (HID) f32, dy (M, HID) bf16, acc (M, HID) f32, qkv
// (M, 3HID) and attn (M, HID) bf16 from the forward. Writes dx (M, HID) bf16,
// dwqkv (HID, 3HID) and dwo (HID, HID) f32, and vec f32 = [dgamma | dbeta |
// dbo | dbqkv] (6HID). The weight gradients split their rows by the given
// plans (ops/fused_backward.py:wgrad_plan).
int attention_block_bwd(Arena& ar, const void* x, const void* wqkv, const void* wo, const void* mask,
                        const void* gamma, const void* dy, const void* acc, const void* qkv, const void* attn,
                        void* dx, void* dwqkv, void* dwo, void* vec, int B, int L, int H, int HID, float eps,
                        float scale, int wo_splits, int wo_per, int wqkv_splits, int wqkv_per, cudaStream_t s) {
  const int M = B * L;
  float* dacc = ar.take<float>((size_t)M * HID);
  bf16* dacc_lp = ar.take<bf16>((size_t)M * HID);
  float* ln_part = ar.take<float>((size_t)ln_blocks(M) * 3 * HID);
  float* ln_col = ar.take<float>((size_t)colsum_splits(ln_blocks(M)) * 3 * HID);
  float* wo_part = ar.take<float>(wo_splits > 1 ? (size_t)wo_splits * HID * HID : 0);
  bf16* da = ar.take<bf16>((size_t)M * HID);
  bf16* dqkv = ar.take<bf16>((size_t)M * 3 * HID);
  float* stats = ar.take<float>((size_t)3 * M * H);
  float* wqkv_part = ar.take<float>(wqkv_splits > 1 ? (size_t)wqkv_splits * HID * 3 * HID : 0);
  float* b_col = ar.take<float>((size_t)colsum_splits(M) * 3 * HID);
  if (ar.base == nullptr) return 0;
  float* sums = static_cast<float*>(vec);
  MM_TRY(ln_bwd(static_cast<const float*>(acc), static_cast<const bf16*>(dy), static_cast<const float*>(gamma), dacc,
                dacc_lp, ln_part, M, HID, eps, s));
  MM_TRY(colsum(ln_part, false, ln_col, sums, ln_blocks(M), 3 * HID, s));  // dgamma | dbeta | dbo
  MM_TRY(mm_wg_wgrad(attn, dacc_lp, wo_part, dwo, M, HID, HID, wo_splits, wo_per, s));
  MM_TRY(mm_wg_gemm(dacc_lp, wo, nullptr, da, M, HID, HID, wg::EPI_BF16, s));
  MM_TRY(mm_attention_bwd(qkv, mask, da, dqkv, stats, B, L, H, scale, s));
  MM_TRY(mm_wg_wgrad(x, dqkv, wqkv_part, dwqkv, M, HID, 3 * HID, wqkv_splits, wqkv_per, s));
  MM_TRY(colsum(dqkv, true, b_col, sums + 3 * HID, M, 3 * HID, s));  // dbqkv
  MM_TRY(mm_wg_gemm(dqkv, wqkv, dacc, dx, M, HID, 3 * HID, wg::EPI_RESID_BF16, s));
  return 0;
}

// K11: x (M, HID) bf16, w1 (HID, FF), w2 (FF, HID) bf16, b1 (FF) and gamma
// (HID) f32, dy (M, HID) bf16, acc (M, HID) f32 and h (M, FF) bf16 from the
// forward. Writes dx (M, HID) bf16, dw1 (HID, FF) and dw2 (FF, HID) f32, and
// vec f32 = [dgamma | dbeta | db2 | db1] (3HID + FF).
int mlp_block_bwd(Arena& ar, const void* x, const void* w1, const void* b1, const void* w2, const void* gamma,
                  const void* dy, const void* acc, const void* h, void* dx, void* dw1, void* dw2, void* vec, int M,
                  int HID, int FF, float eps, int w2_splits, int w2_per, int w1_splits, int w1_per, cudaStream_t s) {
  float* dacc = ar.take<float>((size_t)M * HID);
  bf16* dacc_lp = ar.take<bf16>((size_t)M * HID);
  float* ln_part = ar.take<float>((size_t)ln_blocks(M) * 3 * HID);
  float* ln_col = ar.take<float>((size_t)colsum_splits(ln_blocks(M)) * 3 * HID);
  float* w2_part = ar.take<float>(w2_splits > 1 ? (size_t)w2_splits * FF * HID : 0);
  bf16* dz = ar.take<bf16>((size_t)M * FF);
  float* w1_part = ar.take<float>(w1_splits > 1 ? (size_t)w1_splits * HID * FF : 0);
  float* b_col = ar.take<float>((size_t)colsum_splits(M) * FF);
  if (ar.base == nullptr) return 0;
  float* sums = static_cast<float*>(vec);
  MM_TRY(ln_bwd(static_cast<const float*>(acc), static_cast<const bf16*>(dy), static_cast<const float*>(gamma), dacc,
                dacc_lp, ln_part, M, HID, eps, s));
  MM_TRY(colsum(ln_part, false, ln_col, sums, ln_blocks(M), 3 * HID, s));  // dgamma | dbeta | db2
  MM_TRY(mm_wg_wgrad(h, dacc_lp, w2_part, dw2, M, FF, HID, w2_splits, w2_per, s));
  MM_TRY(mm_wg_gemm_dz(x, w1, b1, dacc_lp, w2, dz, M, FF, HID, s));
  MM_TRY(mm_wg_wgrad(x, dz, w1_part, dw1, M, HID, FF, w1_splits, w1_per, s));
  MM_TRY(colsum(dz, true, b_col, sums + 3 * HID, M, FF, s));  // db1
  MM_TRY(mm_wg_gemm(dz, w1, dacc, dx, M, HID, FF, wg::EPI_RESID_BF16, s));
  return 0;
}

#undef MM_TRY

}  // namespace mm

extern "C" {

// K12's backward in one call into the workspace ws of
// mm_attention_block_bwd_bytes bytes (mm::attention_block_bwd).
int mm_attention_block_bwd(const void* x, const void* wqkv, const void* wo, const void* mask, const void* gamma,
                           const void* dy, const void* acc, const void* qkv, const void* attn, void* dx, void* dwqkv,
                           void* dwo, void* vec, void* ws, int B, int L, int H, int HID, float eps, float scale,
                           int wo_splits, int wo_per, int wqkv_splits, int wqkv_per, void* stream) {
  Arena ar{static_cast<char*>(ws), 0};
  return attention_block_bwd(ar, x, wqkv, wo, mask, gamma, dy, acc, qkv, attn, dx, dwqkv, dwo, vec, B, L, H, HID,
                             eps, scale, wo_splits, wo_per, wqkv_splits, wqkv_per, static_cast<cudaStream_t>(stream));
}

long long mm_attention_block_bwd_bytes(int B, int L, int H, int HID, int wo_splits, int wqkv_splits) {
  Arena ar{nullptr, 0};
  attention_block_bwd(ar, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, nullptr, B, L, H, HID, 0.0f, 0.0f, wo_splits, 0, wqkv_splits, 0, nullptr);
  return static_cast<long long>(ar.used);
}

// K11's backward in one call into the workspace ws of mm_mlp_block_bwd_bytes
// bytes (mm::mlp_block_bwd).
int mm_mlp_block_bwd(const void* x, const void* w1, const void* b1, const void* w2, const void* gamma, const void* dy,
                     const void* acc, const void* h, void* dx, void* dw1, void* dw2, void* vec, void* ws, int M,
                     int HID, int FF, float eps, int w2_splits, int w2_per, int w1_splits, int w1_per,
                     void* stream) {
  Arena ar{static_cast<char*>(ws), 0};
  return mlp_block_bwd(ar, x, w1, b1, w2, gamma, dy, acc, h, dx, dw1, dw2, vec, M, HID, FF, eps, w2_splits, w2_per,
                       w1_splits, w1_per, static_cast<cudaStream_t>(stream));
}

long long mm_mlp_block_bwd_bytes(int M, int HID, int FF, int w2_splits, int w1_splits) {
  Arena ar{nullptr, 0};
  mlp_block_bwd(ar, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, M, HID, FF, 0.0f, w2_splits, 0, w1_splits, 0, nullptr);
  return static_cast<long long>(ar.used);
}

}  // extern "C"
