// Backward of the encoder's fused layer halves, written for Hopper.
//
// Replaces the Pallas kernels of matchmaker_tpu/ops/fused_backward.py:
//   K11 _mlp_bwd_kernel  (MLP half):       dx, dW1, db1, dW2, db2, dgamma, dbeta
//   K12 _attn_bwd_kernel (attention half): dx, dWq/k/v/o, dbq/k/v/o, dgamma, dbeta
// from the block input x, the upstream gradient dy (bf16) and the f32 pre-LN
// sums the forward saved. The function is the TPU kernels'; the fusion
// boundaries are not. Each half is a few launches (ops/fused_backward.py):
//   both: ln_bwd (LayerNorm backward, per-block column partials of dgamma,
//         dbeta and the output bias) -> colsum (second pass, fixed order)
//   K11:  gemm_tn dW2 = h^T.dacc; gemm gelu'(x.W1 + b1) (f32, recomputed);
//         gemm dz = bf16((dacc.W2^T) * gelu'); gemm_tn dW1 = x^T.dz;
//         colsum db1; gemm dx = bf16(dacc + dz.W1^T)
//   K12:  gemm_tn dWo = a^T.dacc; gemm da = bf16(dacc.Wo^T); attention core
//         backward (dq, then dk/dv) into the packed (B, L, 3H) dqkv;
//         gemm_tn dWqkv = x^T.dqkv; colsum dbqkv; gemm dx = bf16(dacc + dqkv.Wqkv^T)
// The forward's own outputs (qkv, the attention output a, the gelu output h)
// are kept by the training forward instead of being recomputed; z is not
// stored, so gelu'(z) is recomputed by one GEMM.
//
// What bounds them on the card: the products are compute bound (2*R*I*J
// flops over R = B*L >= 960 rows) and run on the tensor cores (tile_mma.cuh).
// The TPU summed weight gradients across a sequential grid into one output
// block; here blocks run in parallel and in no order, so every weight
// gradient is one product that contracts all B*L rows inside a block's K loop
// (gemm_tn), split along the rows only into separate partial buffers summed
// by a second pass, and the column sums (biases, LayerNorm) are two-pass
// reductions too: no float atomics, so a gradient is the same run to run.
// The attention core keeps p and ds in f32 into their products as on the TPU:
// S = QK^T and dP = dA.V^T run on the tensor cores (bf16 in, f32 out), while
// dV = P^T.dA, dQ = dS.K and dK = dS^T.Q run as f32 FMAs from shared memory,
// since wmma has no f32 x bf16 product. Kernel 1 owns a 64-query tile of one
// (example, head): scores for all keys, softmax, o = P.V (f32) for the row
// terms D = dA.o, then dS and dQ. Kernel 2 owns a 64-key tile and loops over
// the query tiles, recomputing P^T from kernel 1's row statistics, so dK and
// dV sum over every query in one block, without atomics.
#include "tile_mma.cuh"

#include <math.h>

namespace mm {

enum BwdEpilogue : int { BWD_GELU_GRAD_F32 = 0, BWD_MUL_BF16 = 1, BWD_BF16 = 2, BWD_RESID_BF16 = 3 };

// d/dz gelu with the FMA-only erf polynomial of the bf16 forward
// (matchmaker_tpu/ops/fused_backward.py:_gelu_grad_poly): Phi(z) + z.phi(z).
__device__ __forceinline__ float gelu_grad_poly(float z) {
  const float u = z * 0.7071067811865476f;
  const float uc = fminf(fmaxf(u, -3.4f), 3.4f);
  const float v = uc * uc;
  float p = 1.2036946e-08f;
  p = p * v + -7.4665718e-07f;
  p = p * v + 2.0221069e-05f;
  p = p * v + -0.00031579041f;
  p = p * v + 0.0031725222f;
  p = p * v + -0.021726243f;
  p = p * v + 0.10513879f;
  p = p * v + -0.37025923f;
  p = p * v + 1.1268175f;
  return 0.5f * (1.0f + p * uc) + z * (0.3989422804014327f * expf(-0.5f * z * z));
}

// C = A(M,K) . B, then the epilogue. B_NK=false: B (K,N); B_NK=true: B (N,K),
// used transposed. Grid (N/128, M/128).
//   BWD_GELU_GRAD_F32: C f32 = gelu'(acc + bias)
//   BWD_MUL_BF16:      C bf16 = acc * aux[m][n]     (aux f32)
//   BWD_BF16:          C bf16 = acc
//   BWD_RESID_BF16:    C bf16 = acc + aux[m][n]     (aux f32)
template <bool B_NK, int EPI>
__global__ void __launch_bounds__(TILE_THREADS) bwd_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                                                                 const float* __restrict__ bias,
                                                                 const float* __restrict__ aux, void* __restrict__ C,
                                                                 int M, int N, int K) {
  __shared__ __align__(128) char smem[TILE_SMEM_BYTES];
  const int m0 = blockIdx.y * TILE_M, n0 = blockIdx.x * TILE_N;
  FragC acc[FRAG_M][FRAG_N];
  tile_mma<B_NK>(A, M, B, N, K, m0, n0, smem, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  float* st = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FRAG_M; ++i) {
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * WARP_M + i * 16 + r;
      const int gn = n0 + wn * WARP_N + j * 16 + c8;
      if (gm < M && gn < N) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = st[r * 16 + c8 + e];
        const size_t off = (size_t)gm * N + gn;
        if (EPI == BWD_GELU_GRAD_F32) {
          float* out = reinterpret_cast<float*>(C) + off;
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = gelu_grad_poly(v[e] + bias[gn + e]);
          *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(out + 4) = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          if (EPI == BWD_MUL_BF16 || EPI == BWD_RESID_BF16) {
            const float4 a0 = *reinterpret_cast<const float4*>(aux + off);
            const float4 a1 = *reinterpret_cast<const float4*>(aux + off + 4);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = EPI == BWD_MUL_BF16 ? v[e] * av[e] : v[e] + av[e];
          }
          __align__(16) bf16 o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(v[e]);
          *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(C) + off) = *reinterpret_cast<const uint4*>(o);
        }
      }
      __syncwarp();
    }
  }
}

// ---- weight gradients: C (I, J) f32 = A^T . B over rows ---------------------
// Grid (J/128, I/128, splits): block z contracts its own slice of the rows and
// writes partial[z]; with one split it writes C itself.
__global__ void __launch_bounds__(TILE_THREADS) gemm_tn_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                                                                float* __restrict__ C, int R, int I, int J,
                                                                int rows_per_split) {
  __shared__ __align__(128) char smem[TILE_SMEM_BYTES];
  const int i0 = blockIdx.y * TILE_M, j0 = blockIdx.x * TILE_N;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  FragC acc[FRAG_M][FRAG_N];
  tile_mma_tn(A, I, B, J, r_begin, r_end, i0, j0, smem, acc);

  float* out = C + (size_t)blockIdx.z * I * J;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  float* st = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FRAG_M; ++i) {
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gi = i0 + wm * WARP_M + i * 16 + r;
      const int gj = j0 + wn * WARP_N + j * 16 + c8;
      if (gi < I && gj < J) {
        float* o = out + (size_t)gi * J + gj;
        *reinterpret_cast<float4*>(o) = make_float4(st[r * 16 + c8], st[r * 16 + c8 + 1], st[r * 16 + c8 + 2],
                                                    st[r * 16 + c8 + 3]);
        *reinterpret_cast<float4*>(o + 4) = make_float4(st[r * 16 + c8 + 4], st[r * 16 + c8 + 5],
                                                        st[r * 16 + c8 + 6], st[r * 16 + c8 + 7]);
      }
      __syncwarp();
    }
  }
}

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
// One block = LNB_ROWS rows, a warp per row at a time: two-pass mean and
// variance as the forward, then dacc = rstd.(dy.g - mean(dy.g) - yhat.mean(dy.g.yhat))
// (f32 and bf16 copies). Then each thread sums its columns over the block's
// rows: dgamma += dy.yhat, dbeta += dy, dbias += dacc, written as this block's
// row of partial (blocks, 3N) for the second pass.
constexpr int LNB_ROWS = 32;

__global__ void __launch_bounds__(256) ln_bwd_kernel(const float* __restrict__ acc, const bf16* __restrict__ dy,
                                                     const float* __restrict__ gamma, float* __restrict__ dacc,
                                                     bf16* __restrict__ dacc_lp, float* __restrict__ partial, int M,
                                                     int N, float eps) {
  __shared__ float s_mean[LNB_ROWS], s_rstd[LNB_ROWS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * LNB_ROWS;
  for (int rr = warp; rr < LNB_ROWS; rr += 8) {
    const int row = r0 + rr;
    if (row >= M) break;
    const float* xr = acc + (size_t)row * N;
    const bf16* dr = dy + (size_t)row * N;
    float s = 0.0f;
    for (int j = lane; j < N; j += 32) s += xr[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / N;
    float q = 0.0f;
    for (int j = lane; j < N; j += 32) {
      const float d = xr[j] - mean;
      q += d * d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float rstd = rsqrtf(q / N + eps);
    float m1 = 0.0f, m2 = 0.0f;
    for (int j = lane; j < N; j += 32) {
      const float dyh = __bfloat162float(dr[j]) * gamma[j];
      m1 += dyh;
      m2 += dyh * ((xr[j] - mean) * rstd);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m1 += __shfl_xor_sync(0xffffffffu, m1, o);
      m2 += __shfl_xor_sync(0xffffffffu, m2, o);
    }
    m1 /= N;
    m2 /= N;
    for (int j = lane; j < N; j += 32) {
      const float yhat = (xr[j] - mean) * rstd;
      const float v = rstd * (__bfloat162float(dr[j]) * gamma[j] - m1 - yhat * m2);
      dacc[(size_t)row * N + j] = v;
      dacc_lp[(size_t)row * N + j] = __float2bfloat16(v);
    }
    if (lane == 0) {
      s_mean[rr] = mean;
      s_rstd[rr] = rstd;
    }
  }
  __syncthreads();  // this block's dacc rows and row statistics are visible
  const int rows = min(LNB_ROWS, M - r0);
  for (int c = threadIdx.x; c < N; c += 256) {
    float sg = 0.0f, sb = 0.0f, sd = 0.0f;
    for (int rr = 0; rr < rows; ++rr) {
      const size_t off = (size_t)(r0 + rr) * N + c;
      const float d = __bfloat162float(dy[off]);
      sg += d * ((acc[off] - s_mean[rr]) * s_rstd[rr]);
      sb += d;
      sd += dacc[off];
    }
    float* p = partial + (size_t)blockIdx.x * 3 * N;
    p[c] = sg;
    p[N + c] = sb;
    p[2 * N + c] = sd;
  }
}

// ---- attention core backward -------------------------------------------------
constexpr int BH = 64;          // head width
constexpr int BQ = 64;          // query (kernel 1) or key (kernel 2) rows per block
constexpr int BC = 64;          // rows per shared-memory chunk of the other side
constexpr int B_THREADS = 128;  // 4 warps, 16 rows each for the wmma products
constexpr int B_LD = BH + 8;    // padded bf16 rows (144 bytes)
constexpr int T_LD = BC + 4;    // padded f32 chunk rows

__host__ __device__ inline int bwd_keys_padded(int L) { return (L + BC - 1) / BC * BC; }
__host__ __device__ inline int bwd_s_ld(int L) { return bwd_keys_padded(L) + 4; }
inline size_t dq_smem_bytes(int L) {
  return (size_t)3 * BQ * B_LD * 2 + (size_t)BQ * bwd_s_ld(L) * 4 + (size_t)BQ * T_LD * 4 +
         (size_t)bwd_keys_padded(L) * 4 + (size_t)BQ * 4;
}
constexpr size_t DKV_SMEM_BYTES = (size_t)4 * BQ * B_LD * 2 + (size_t)2 * BQ * T_LD * 4 + (size_t)4 * BC * 4;

// stage rows [r0, r0+64) of one head's 64 columns (at column offset col0 of
// rows of width row_w) into a [64][B_LD] tile; rows past L read as zero
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* base, int row_w, int col0, int r0, int L) {
  for (int c = threadIdx.x; c < BQ * BH / 8; c += B_THREADS) {
    const int row = c >> 3, col = (c & 7) * 8;
    *reinterpret_cast<uint4*>(dst + row * B_LD + col) =
        load16(base + (size_t)(r0 + row) * row_w + col0 + col, r0 + row < L);
  }
}

// Kernel 1: one block per (64-query tile, head, example). qkv (B, L, 3*HID)
// from the forward, da (B, L, HID) the gradient of the attention output.
// Writes dq into dqkv[:, :, 0:HID] and the row statistics of every query
// (max, sum of exp, D = dA.o) into stats (3, B, H, L) for kernel 2.
__global__ void __launch_bounds__(B_THREADS) attention_bwd_dq_kernel(const bf16* __restrict__ qkv,
                                                                      const float* __restrict__ mask,
                                                                      const bf16* __restrict__ da,
                                                                      bf16* __restrict__ dqkv,
                                                                      float* __restrict__ stats, int L, int H,
                                                                      float scale) {
  extern __shared__ __align__(128) char smem[];
  const int LKP = bwd_keys_padded(L), SLD = bwd_s_ld(L);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = Qs + BQ * B_LD;
  bf16* Ks = Ds + BQ * B_LD;  // K chunk, later V chunks, later K chunks again
  float* S = reinterpret_cast<float*>(Ks + BQ * B_LD);
  float* T = S + BQ * SLD;
  float* neg = T + BQ * T_LD;
  float* rowD = neg + LKP;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int HID = H * BH, ROW = 3 * HID;
  const bf16* base = qkv + (size_t)b * L * ROW;
  const bf16* dbase = da + (size_t)b * L * HID;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t plane = (size_t)gridDim.z * H * L;  // one statistic for every (b, h, query)
  float* st_row = stats + ((size_t)b * H + h) * L;

  for (int j = tid; j < LKP; j += B_THREADS) neg[j] = j < L ? (mask[(size_t)b * L + j] - 1.0f) * 1e9f : 0.0f;
  stage_tile(Qs, base, ROW, h * BH, q0, L);
  stage_tile(Ds, dbase, HID, h * BH, q0, L);
  __syncthreads();
  FragA qf[BH / 16], df[BH / 16];
#pragma unroll
  for (int k = 0; k < BH / 16; ++k) {
    wmma::load_matrix_sync(qf[k], Qs + warp * 16 * B_LD + k * 16, B_LD);
    wmma::load_matrix_sync(df[k], Ds + warp * 16 * B_LD + k * 16, B_LD);
  }

  // S = Q K^T on the tensor cores, one 64-key chunk at a time
  for (int kc = 0; kc < LKP; kc += BC) {
    stage_tile(Ks, base, ROW, HID + h * BH, kc, L);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BC / 16; ++j) {
      FragC sf;
      wmma::fill_fragment(sf, 0.0f);
#pragma unroll
      for (int k = 0; k < BH / 16; ++k) {
        FragBcol kf;
        wmma::load_matrix_sync(kf, Ks + j * 16 * B_LD + k * 16, B_LD);
        wmma::mma_sync(sf, qf[k], kf, sf);
      }
      wmma::store_matrix_sync(S + warp * 16 * SLD + kc + j * 16, sf, SLD, wmma::mem_row_major);
    }
    __syncthreads();
  }

  // f32 softmax over the L real keys, as the forward; keep each row's max and sum
  for (int rr = 0; rr < 16; ++rr) {
    const int row = warp * 16 + rr;
    float* srow = S + row * SLD;
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const float s = srow[j] * scale + neg[j];
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(srow[j] - mx);
      srow[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < LKP; j += 32) srow[j] = j < L ? srow[j] / sum : 0.0f;
    if (lane == 0 && q0 + row < L) {
      st_row[q0 + row] = mx;
      st_row[plane + q0 + row] = sum;
    }
  }
  __syncthreads();

  // o = P V in f32 (thread owns rows g + 8*i, 4 columns), then D = dA . o per row
  const int g = tid >> 4, c0 = (tid & 15) * 4;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  for (int kc = 0; kc < LKP; kc += BC) {
    stage_tile(Ks, base, ROW, 2 * HID + h * BH, kc, L);
    __syncthreads();
    for (int j = 0; j < BC; ++j) {
      const uint2 raw = *reinterpret_cast<const uint2*>(Ks + j * B_LD + c0);
      const bf16* vb = reinterpret_cast<const bf16*>(&raw);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = __bfloat162float(vb[e]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = S[(g + 8 * i) * SLD + kc + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(p, v[e], acc[i][e]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float d = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) d = fmaf(__bfloat162float(Ds[(g + 8 * i) * B_LD + c0 + e]), acc[i][e], d);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);  // the 16 lanes of row g + 8i
    if ((tid & 15) == 0) {
      rowD[g + 8 * i] = d;
      if (q0 + g + 8 * i < L) st_row[2 * plane + q0 + g + 8 * i] = d;
    }
  }
  __syncthreads();

  // dS = P (dP - D) scale in place of P, with dP = dA V^T on the tensor cores
  for (int kc = 0; kc < LKP; kc += BC) {
    stage_tile(Ks, base, ROW, 2 * HID + h * BH, kc, L);
    __syncthreads();
    float* tw = T + warp * 16 * T_LD;
#pragma unroll
    for (int j = 0; j < BC / 16; ++j) {
      FragC pf;
      wmma::fill_fragment(pf, 0.0f);
#pragma unroll
      for (int k = 0; k < BH / 16; ++k) {
        FragBcol vf;
        wmma::load_matrix_sync(vf, Ks + j * 16 * B_LD + k * 16, B_LD);
        wmma::mma_sync(pf, df[k], vf, pf);
      }
      wmma::store_matrix_sync(tw + j * 16, pf, T_LD, wmma::mem_row_major);
    }
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int row = warp * 16 + rr;
      const float dd = rowD[row];
      for (int c = lane; c < BC; c += 32) {
        float* sp = S + row * SLD + kc + c;
        *sp = *sp * (tw[rr * T_LD + c] - dd) * scale;
      }
    }
    __syncthreads();
  }

  // dQ = dS K in f32
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  for (int kc = 0; kc < LKP; kc += BC) {
    stage_tile(Ks, base, ROW, HID + h * BH, kc, L);
    __syncthreads();
    for (int j = 0; j < BC; ++j) {
      const uint2 raw = *reinterpret_cast<const uint2*>(Ks + j * B_LD + c0);
      const bf16* kb = reinterpret_cast<const bf16*>(&raw);
      float kv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) kv[e] = __bfloat162float(kb[e]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ds = S[(g + 8 * i) * SLD + kc + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(ds, kv[e], acc[i][e]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = q0 + g + 8 * i;
    if (q < L) {
      __align__(8) bf16 o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = __float2bfloat16(acc[i][e]);
      *reinterpret_cast<uint2*>(dqkv + ((size_t)b * L + q) * ROW + h * BH + c0) = *reinterpret_cast<const uint2*>(o);
    }
  }
}

// Kernel 2: one block per (64-key tile, head, example), looping over every
// 64-query chunk: P^T = exp(K Q^T scale + mask - max) / sum from kernel 1's
// statistics, dP^T = V dA^T (tensor cores), dS^T = P^T (dP^T - D) scale;
// dV += P^T dA and dK += dS^T Q in f32, kept in registers for the whole loop.
__global__ void __launch_bounds__(B_THREADS) attention_bwd_dkv_kernel(const bf16* __restrict__ qkv,
                                                                       const float* __restrict__ mask,
                                                                       const bf16* __restrict__ da,
                                                                       bf16* __restrict__ dqkv,
                                                                       const float* __restrict__ stats, int L,
                                                                       int H, float scale) {
  extern __shared__ __align__(128) char smem[];
  bf16* Kt = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Kt + BQ * B_LD;
  bf16* Qc = Vt + BQ * B_LD;
  bf16* Dc = Qc + BQ * B_LD;
  float* PT = reinterpret_cast<float*>(Dc + BQ * B_LD);
  float* DPT = PT + BQ * T_LD;
  float* qm = DPT + BQ * T_LD;
  float* ql = qm + BC;
  float* qd = ql + BC;
  float* negk = qd + BC;

  const int k0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int HID = H * BH, ROW = 3 * HID;
  const bf16* base = qkv + (size_t)b * L * ROW;
  const bf16* dbase = da + (size_t)b * L * HID;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t plane = (size_t)gridDim.z * H * L;
  const float* st_row = stats + ((size_t)b * H + h) * L;

  for (int j = tid; j < BQ; j += B_THREADS)
    negk[j] = k0 + j < L ? (mask[(size_t)b * L + k0 + j] - 1.0f) * 1e9f : 0.0f;
  stage_tile(Kt, base, ROW, HID + h * BH, k0, L);
  stage_tile(Vt, base, ROW, 2 * HID + h * BH, k0, L);
  __syncthreads();
  FragA kf[BH / 16], vf[BH / 16];
#pragma unroll
  for (int k = 0; k < BH / 16; ++k) {
    wmma::load_matrix_sync(kf[k], Kt + warp * 16 * B_LD + k * 16, B_LD);
    wmma::load_matrix_sync(vf[k], Vt + warp * 16 * B_LD + k * 16, B_LD);
  }

  const int g = tid >> 4, c0 = (tid & 15) * 4;
  float acc_k[8][4], acc_v[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.0f;

  const int LQP = bwd_keys_padded(L);
  for (int qc = 0; qc < LQP; qc += BC) {
    stage_tile(Qc, base, ROW, h * BH, qc, L);
    stage_tile(Dc, dbase, HID, h * BH, qc, L);
    for (int j = tid; j < BC; j += B_THREADS) {
      const bool ok = qc + j < L;
      qm[j] = ok ? st_row[qc + j] : 0.0f;
      ql[j] = ok ? st_row[plane + qc + j] : 1.0f;
      qd[j] = ok ? st_row[2 * plane + qc + j] : 0.0f;
    }
    __syncthreads();
    float* pw = PT + warp * 16 * T_LD;
    float* dw = DPT + warp * 16 * T_LD;
#pragma unroll
    for (int j = 0; j < BC / 16; ++j) {
      FragC sf, pf;
      wmma::fill_fragment(sf, 0.0f);
      wmma::fill_fragment(pf, 0.0f);
#pragma unroll
      for (int k = 0; k < BH / 16; ++k) {
        FragBcol qf, af;
        wmma::load_matrix_sync(qf, Qc + j * 16 * B_LD + k * 16, B_LD);
        wmma::load_matrix_sync(af, Dc + j * 16 * B_LD + k * 16, B_LD);
        wmma::mma_sync(sf, kf[k], qf, sf);
        wmma::mma_sync(pf, vf[k], af, pf);
      }
      wmma::store_matrix_sync(pw + j * 16, sf, T_LD, wmma::mem_row_major);
      wmma::store_matrix_sync(dw + j * 16, pf, T_LD, wmma::mem_row_major);
    }
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int kr = warp * 16 + rr;
      const bool key_ok = k0 + kr < L;
      for (int c = lane; c < BC; c += 32) {
        const float s = pw[rr * T_LD + c] * scale + negk[kr];
        const float p = key_ok && qc + c < L ? expf(s - qm[c]) / ql[c] : 0.0f;
        pw[rr * T_LD + c] = p;
        dw[rr * T_LD + c] = p * (dw[rr * T_LD + c] - qd[c]) * scale;
      }
    }
    __syncthreads();
    for (int c = 0; c < BC; ++c) {
      const uint2 qraw = *reinterpret_cast<const uint2*>(Qc + c * B_LD + c0);
      const uint2 araw = *reinterpret_cast<const uint2*>(Dc + c * B_LD + c0);
      const bf16* qb = reinterpret_cast<const bf16*>(&qraw);
      const bf16* ab = reinterpret_cast<const bf16*>(&araw);
      float qv[4], av[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qv[e] = __bfloat162float(qb[e]);
        av[e] = __bfloat162float(ab[e]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = PT[(g + 8 * i) * T_LD + c];
        const float ds = DPT[(g + 8 * i) * T_LD + c];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc_v[i][e] = fmaf(p, av[e], acc_v[i][e]);
          acc_k[i][e] = fmaf(ds, qv[e], acc_k[i][e]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + g + 8 * i;
    if (k < L) {
      __align__(8) bf16 ok[4], ov[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ok[e] = __float2bfloat16(acc_k[i][e]);
        ov[e] = __float2bfloat16(acc_v[i][e]);
      }
      bf16* dst = dqkv + ((size_t)b * L + k) * ROW + h * BH + c0;
      *reinterpret_cast<uint2*>(dst + HID) = *reinterpret_cast<const uint2*>(ok);
      *reinterpret_cast<uint2*>(dst + 2 * HID) = *reinterpret_cast<const uint2*>(ov);
    }
  }
}

}  // namespace mm

using namespace mm;

extern "C" {

// C = A.B (+ epilogue): see bwd_gemm_kernel. The gelu' epilogue takes
// B (K,N) and bias (N) f32; the others take B (N,K) used transposed and aux
// (M,N) f32 where they read it.
int mm_bwd_gemm(const void* A, const void* B, const void* bias, const void* aux, void* C, int M, int N, int K,
                int epilogue, void* stream) {
  const dim3 grid((N + TILE_N - 1) / TILE_N, (M + TILE_M - 1) / TILE_M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* b = static_cast<const bf16*>(B);
  const float* bi = static_cast<const float*>(bias);
  const float* ax = static_cast<const float*>(aux);
  switch (epilogue) {
    case BWD_GELU_GRAD_F32:
      bwd_gemm_kernel<false, BWD_GELU_GRAD_F32><<<grid, TILE_THREADS, 0, s>>>(a, b, bi, ax, C, M, N, K);
      break;
    case BWD_MUL_BF16:
      bwd_gemm_kernel<true, BWD_MUL_BF16><<<grid, TILE_THREADS, 0, s>>>(a, b, bi, ax, C, M, N, K);
      break;
    case BWD_BF16:
      bwd_gemm_kernel<true, BWD_BF16><<<grid, TILE_THREADS, 0, s>>>(a, b, bi, ax, C, M, N, K);
      break;
    case BWD_RESID_BF16:
      bwd_gemm_kernel<true, BWD_RESID_BF16><<<grid, TILE_THREADS, 0, s>>>(a, b, bi, ax, C, M, N, K);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (I,J) f32 = A^T (R,I) . B (R,J), bf16 inputs; with splits > 1 the row
// slices go to partial (splits, I, J) and a second pass sums them into out.
int mm_gemm_tn(const void* A, const void* B, void* partial, void* out, int R, int I, int J, int splits,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = ((R + splits - 1) / splits + TILE_K - 1) / TILE_K * TILE_K;
  const dim3 grid((J + TILE_N - 1) / TILE_N, (I + TILE_M - 1) / TILE_M, splits);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  gemm_tn_kernel<<<grid, TILE_THREADS, 0, s>>>(static_cast<const bf16*>(A), static_cast<const bf16*>(B), dst, R, I,
                                               J, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)I * J;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(static_cast<const float*>(partial),
                                                                 static_cast<float*>(out), splits, n);
  return static_cast<int>(cudaGetLastError());
}

// out (C) f32 = column sums of x (M,C), bf16 if is_bf16 else f32; two passes
// through partial (splits, C).
int mm_colsum(const void* x, void* partial, void* out, int M, int C, int splits, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = (M + splits - 1) / splits;
  const dim3 grid((C + 255) / 256, splits);
  float* p = static_cast<float*>(partial);
  if (is_bf16)
    colsum_partial_kernel<bf16><<<grid, 256, 0, s>>>(static_cast<const bf16*>(x), p, M, C, rows);
  else
    colsum_partial_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x), p, M, C, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_splits_kernel<<<(C + 255) / 256, 256, 0, s>>>(p, static_cast<float*>(out), splits, (size_t)C);
  return static_cast<int>(cudaGetLastError());
}

// LayerNorm backward over M rows of N: dacc f32 and bf16, and per-block
// column partials (ceil(M / 32), 3N) of dgamma, dbeta and sum(dacc).
int mm_ln_bwd(const void* acc, const void* dy, const void* gamma, void* dacc, void* dacc_lp, void* partial, int M,
              int N, float eps, void* stream) {
  ln_bwd_kernel<<<(M + LNB_ROWS - 1) / LNB_ROWS, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const bf16*>(dy), static_cast<const float*>(gamma),
      static_cast<float*>(dacc), static_cast<bf16*>(dacc_lp), static_cast<float*>(partial), M, N, eps);
  return static_cast<int>(cudaGetLastError());
}

// dqkv (B,L,3*H*64) bf16 from qkv (B,L,3*H*64), mask (B,L) f32 and da
// (B,L,H*64) bf16; stats (3,B,H,L) f32 is scratch passed between the kernels.
int mm_attention_bwd(const void* qkv, const void* mask, const void* da, void* dqkv, void* stats, int B, int L, int H,
                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem1 = dq_smem_bytes(L);
  cudaError_t err =
      cudaFuncSetAttribute(attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DKV_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  const bf16* q = static_cast<const bf16*>(qkv);
  const float* m = static_cast<const float*>(mask);
  const bf16* d = static_cast<const bf16*>(da);
  bf16* out = static_cast<bf16*>(dqkv);
  float* st = static_cast<float*>(stats);
  attention_bwd_dq_kernel<<<grid, B_THREADS, smem1, s>>>(q, m, d, out, st, L, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_kernel<<<grid, B_THREADS, DKV_SMEM_BYTES, s>>>(q, m, d, out, st, L, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
