// The encoder's int8 layer halves (inference only), written for Hopper.
//
// Replaces the Pallas kernels of matchmaker_tpu/ops/fused_int8.py:
//   K9  _mlp_int8_kernel  (MLP half):       LN(x + b2 + sum_c dq(gelu(dq(xq.W1q[:, c]) + b1[c])q . W2q[c, :]))
//   K10 _attn_int8_kernel (attention half): LN(x + bo + sum_g dq(MHA(QKV(xq))[:, g]q . Woq[g, :]))
// with per-output-column weight scales (quantized once outside, from the
// f32 parameters), per-row activation scales for x, per-(row, FF chunk of
// 768) scales for the gelu output and per-(row, group of two heads = 128
// columns) scales for the attention output. Each half runs as a few
// launches, as the bf16 halves do (encoder_kernels.cu):
//   K9:  quant_groups (x, per row) -> gemm_s8 (W1, dequant + bias + gelu,
//        f32 out) -> quant_groups (per row and chunk) -> gemm_s8 (W2, the
//        chunks' int32 partials dequantized one by one onto x + b2, f32 out)
//        -> mm_layernorm
//   K10: quant_groups (x, per row) -> gemm_s8 (packed Q|K|V, dequant + bias,
//        bf16 out) -> mm_attention_core_f32 -> quant_groups (per row and
//        group) -> gemm_s8 (Wo, per-group partials onto x + bo, f32 out) ->
//        mm_layernorm
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
// int8 weights), compute bound at the card's int8 rate; the f32 gelu output
// (M x 3072) and the f32 attention output go through device memory, which
// at 256 x 128 rows is about 0.4 GB of traffic a layer. This first version
// runs int8 wmma (mma.sync) fed through registers, not wgmma/TMA; the
// attention core is K1's (S on the tensor cores, P.V in f32 FMAs).
#include "encoder_common.cuh"
#include "tile_mma.cuh"

#include <math.h>

namespace mm {

enum EpilogueS8 : int { EPI_S8_BIAS_BF16 = 0, EPI_S8_BIAS_GELU_F32 = 1, EPI_S8_CHUNKS_RESID_F32 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// One warp per (row, group) of x (M, G*W): codes and the group's scale
// (matchmaker_tpu/ops/fused_int8.py:_quant_rows over each group).
template <typename T>
__global__ void __launch_bounds__(256) quant_groups_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                                           float* __restrict__ scales, int M, int G, int W) {
  const long long wid = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (wid >= (long long)M * G) return;
  const size_t base = (size_t)wid * W;  // row-major (M, G*W): group g of row r starts at (r*G + g)*W
  float amax = 0.0f;
  for (int j = lane; j < W; j += 32) amax = fmaxf(amax, fabsf(to_f32(x[base + j])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
  for (int j = lane; j < W; j += 32) {
    const float c = fminf(fmaxf(rintf(__fdiv_rn(to_f32(x[base + j]), s)), -127.0f), 127.0f);
    q[base + j] = static_cast<int8_t>(c);
  }
  if (lane == 0) scales[wid] = s;
}

// C = dequant(A(M,K) int8 . B(K,N) int8) with the epilogue; grid (N/128, M/128).
// The K axis runs in chunks of `chunk` columns; chunk c's int32 partial is
// dequantized by row_scale[row * nchunks + c] * col_scale[col]:
//   EPI_S8_BIAS_BF16:        one chunk; C bf16 = bf16(dq + bias)
//   EPI_S8_BIAS_GELU_F32:    one chunk; C f32 = gelu_poly(dq + bias)
//   EPI_S8_CHUNKS_RESID_F32: C f32 = (resid + bias) + dq_0 + dq_1 + ... in order
template <int EPI>
__global__ void __launch_bounds__(TILE_THREADS) gemm_s8_kernel(const int8_t* __restrict__ A,
                                                                const int8_t* __restrict__ B,
                                                                const float* __restrict__ row_scale,
                                                                const float* __restrict__ col_scale,
                                                                const float* __restrict__ bias,
                                                                const bf16* __restrict__ resid, void* __restrict__ C,
                                                                int M, int N, int K, int chunk) {
  __shared__ __align__(128) char smem[S8_SMEM_BYTES];
  const int m0 = blockIdx.y * TILE_M, n0 = blockIdx.x * TILE_N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int r = lane >> 1, c8 = (lane & 1) * 8;  // this lane's row and 8 columns of each 16x16 fragment
  const int nchunks = K / chunk;
  int* st = reinterpret_cast<int*>(smem) + warp * 256;  // per-warp 16x16 staging, in the ring after tile_mma_s8

  float f[FRAG_M][FRAG_N][8];
#pragma unroll
  for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j) {
      const int gm = m0 + wm * WARP_M + i * 16 + r;
      const int gn = n0 + wn * WARP_N + j * 16 + c8;
#pragma unroll
      for (int e = 0; e < 8; ++e) f[i][j][e] = 0.0f;
      if (EPI == EPI_S8_CHUNKS_RESID_F32 && gm < M && gn < N) {
        const uint4 raw = *reinterpret_cast<const uint4*>(resid + (size_t)gm * N + gn);
        const bf16* rb = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[i][j][e] = __fadd_rn(__bfloat162float(rb[e]), bias[gn + e]);
      }
    }

  for (int c = 0; c < nchunks; ++c) {
    FragCi acc[FRAG_M][FRAG_N];
    tile_mma_s8<false>(A, M, K, B, N, c * chunk, (c + 1) * chunk, m0, n0, smem, acc);
#pragma unroll
    for (int i = 0; i < FRAG_M; ++i) {
#pragma unroll
      for (int j = 0; j < FRAG_N; ++j) {
        wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int gm = m0 + wm * WARP_M + i * 16 + r;
        const int gn = n0 + wn * WARP_N + j * 16 + c8;
        if (gm < M && gn < N) {
          const float rs = row_scale[(size_t)gm * nchunks + c];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float v = __fmul_rn(static_cast<float>(st[r * 16 + c8 + e]), __fmul_rn(rs, col_scale[gn + e]));
            f[i][j][e] = EPI == EPI_S8_CHUNKS_RESID_F32 ? __fadd_rn(f[i][j][e], v) : v;
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();  // the staging lives in the ring the next chunk's product refills
  }

#pragma unroll
  for (int i = 0; i < FRAG_M; ++i) {
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j) {
      const int gm = m0 + wm * WARP_M + i * 16 + r;
      const int gn = n0 + wn * WARP_N + j * 16 + c8;
      if (gm >= M || gn >= N) continue;
      if (EPI == EPI_S8_BIAS_BF16) {
        __align__(16) bf16 o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(__fadd_rn(f[i][j][e], bias[gn + e]));
        *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(C) + (size_t)gm * N + gn) =
            *reinterpret_cast<const uint4*>(o);
      } else {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = EPI == EPI_S8_BIAS_GELU_F32 ? gelu_poly(__fadd_rn(f[i][j][e], bias[gn + e])) : f[i][j][e];
        float* out = reinterpret_cast<float*>(C) + (size_t)gm * N + gn;
        *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(out + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
}

}  // namespace mm

using namespace mm;

extern "C" {

// q (M, G*W) int8 codes and scales (M, G) f32 of x (M, G*W), bf16
// (x_is_f32 = 0) or f32 (x_is_f32 = 1), quantized per row and group of W.
int mm_quant_groups(const void* x, void* q, void* scales, int M, int G, int W, int x_is_f32, void* stream) {
  const long long warps = (long long)M * G;
  const unsigned blocks = (unsigned)((warps + 7) / 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_f32)
    quant_groups_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(x), static_cast<int8_t*>(q),
                                                       static_cast<float*>(scales), M, G, W);
  else
    quant_groups_kernel<bf16><<<blocks, 256, 0, s>>>(static_cast<const bf16*>(x), static_cast<int8_t*>(q),
                                                      static_cast<float*>(scales), M, G, W);
  return static_cast<int>(cudaGetLastError());
}

// C = dequant(A (M,K) int8 . B (K,N) int8) + epilogue (see gemm_s8_kernel);
// row_scale (M, K/chunk) f32, col_scale and bias (N) f32, resid (M,N) bf16
// for EPI_S8_CHUNKS_RESID_F32.
int mm_gemm_s8(const void* A, const void* B, const void* row_scale, const void* col_scale, const void* bias,
               const void* resid, void* C, int M, int N, int K, int chunk, int epilogue, void* stream) {
  if (chunk <= 0 || K % chunk || chunk % S8_TILE_K) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + TILE_N - 1) / TILE_N, (M + TILE_M - 1) / TILE_M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* b = static_cast<const int8_t*>(B);
  const float* rs = static_cast<const float*>(row_scale);
  const float* cs = static_cast<const float*>(col_scale);
  const float* bi = static_cast<const float*>(bias);
  const bf16* r = static_cast<const bf16*>(resid);
  switch (epilogue) {
    case EPI_S8_BIAS_BF16:
      gemm_s8_kernel<EPI_S8_BIAS_BF16><<<grid, TILE_THREADS, 0, s>>>(a, b, rs, cs, bi, r, C, M, N, K, chunk);
      break;
    case EPI_S8_BIAS_GELU_F32:
      gemm_s8_kernel<EPI_S8_BIAS_GELU_F32><<<grid, TILE_THREADS, 0, s>>>(a, b, rs, cs, bi, r, C, M, N, K, chunk);
      break;
    case EPI_S8_CHUNKS_RESID_F32:
      gemm_s8_kernel<EPI_S8_CHUNKS_RESID_F32><<<grid, TILE_THREADS, 0, s>>>(a, b, rs, cs, bi, r, C, M, N, K, chunk);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
