// The encoder's fused layer halves, written for Hopper.
//
// Replaces the Pallas kernels of matchmaker_tpu/ops/fused_attention.py:
//   K1 _block_kernel (attention half): LN(x + Wo.MHA(xWq+bq, xWk+bk, xWv+bv) + bo)
//   K2 _mlp_kernel   (MLP half):       LN(x + gelu(xW1+b1)W2 + b2)
//   K13 _attn_kernel (fused_mha, standalone multi-head attention over separate
//                     Q, K, V): mm_fused_mha, the attention core below
// The function computed is the same; the fusion boundaries are not. Each
// half runs as a few launches:
//   K1: mm_gemm (QKV, bias, bf16 out) -> mm_attention_core -> mm_gemm
//       (out projection, bias + residual, f32 out) -> mm_layernorm
//   K2: mm_gemm (W1, bias + gelu poly, bf16 out) -> mm_gemm (W2, bias +
//       residual, f32 out) -> mm_layernorm
//
// What bounds them on the card: the four projection GEMMs are compute bound
// (2*M*K*N flops on M = B*L >= 7680 rows against 1.2-4.7 MB of weights), so
// they run on the tensor cores (tile_mma.cuh). The attention core is small
// per (example, head) but its probabilities must stay f32 into P.V as on the
// TPU: S = QK^T runs on the tensor cores (bf16 in, f32 out) while P.V runs as
// f32 FMAs from shared memory, since wmma has no f32 x bf16 product. The
// (B, L, L) scores never reach device memory: a block keeps one 64-query
// tile's score rows for all keys in shared memory (L <= 512).
// Unlike the TPU kernel, the (B*L, 3072) gelu output and the (B*L, 768) f32
// pre-LN sums do go through device memory; keeping them on chip is later work.
#include "encoder_common.cuh"
#include "tile_mma.cuh"

#include <math.h>

namespace mm {

enum Epilogue : int { EPI_BIAS_BF16 = 0, EPI_BIAS_GELU_BF16 = 1, EPI_BIAS_RESID_F32 = 2 };

// C = A(M,K) . B(K,N) + bias, then the epilogue. Grid (N/128, M/128).
template <int EPI>
__global__ void __launch_bounds__(TILE_THREADS) gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                                                             const float* __restrict__ bias,
                                                             const bf16* __restrict__ resid, void* __restrict__ C,
                                                             int M, int N, int K) {
  __shared__ __align__(128) char smem[TILE_SMEM_BYTES];
  const int m0 = blockIdx.y * TILE_M, n0 = blockIdx.x * TILE_N;
  FragC acc[FRAG_M][FRAG_N];
  tile_mma<false>(A, M, B, N, K, m0, n0, smem, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  float* st = reinterpret_cast<float*>(smem) + warp * 256;  // the ring is free after tile_mma
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
        for (int e = 0; e < 8; ++e) v[e] = st[r * 16 + c8 + e] + bias[gn + e];
        if (EPI == EPI_BIAS_RESID_F32) {
          const uint4 raw = *reinterpret_cast<const uint4*>(resid + (size_t)gm * N + gn);
          const bf16* rb = reinterpret_cast<const bf16*>(&raw);
          float* out = reinterpret_cast<float*>(C) + (size_t)gm * N + gn;
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += __bfloat162float(rb[e]);
          *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(out + 4) = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          __align__(16) bf16 o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(EPI == EPI_BIAS_GELU_BF16 ? gelu_poly(v[e]) : v[e]);
          *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(C) + (size_t)gm * N + gn) =
              *reinterpret_cast<const uint4*>(o);
        }
      }
      __syncwarp();
    }
  }
}

// ---- attention core -------------------------------------------------------
// One block per (64-query tile, head, example). q, k and v are (B, L, *) bf16
// with row stride ld and the head split read straight from their columns: for
// K1 the QKV GEMM's output (B, L, 3*HID), ld = 3*HID; for K13 three separate
// (B, L, HID) tensors, ld = HID. out is (B, L, HID): bf16, each head's slice
// cast as the TPU kernels do, or f32 for the int8 attention half (K10
// re-quantizes the f32 output). ROUND_P rounds the f32 probabilities to bf16
// before P.V, as K13's TPU kernel does (p.astype(v.dtype)); K1 keeps them f32.
constexpr int HD = 64;         // head width
constexpr int QT = 64;         // query rows per block
constexpr int KC = 64;         // keys per shared-memory chunk
constexpr int ATT_THREADS = 128;
constexpr int HD_LD = HD + 8;  // padded bf16 rows (144 bytes)

__host__ __device__ inline int att_keys_padded(int L) { return (L + KC - 1) / KC * KC; }
__host__ __device__ inline int att_s_ld(int L) { return att_keys_padded(L) + 4; }
inline size_t att_smem_bytes(int L) {
  return (size_t)2 * QT * HD_LD * 2 + (size_t)QT * att_s_ld(L) * 4 + (size_t)att_keys_padded(L) * 4;
}

template <typename OutT, bool ROUND_P>
__global__ void __launch_bounds__(ATT_THREADS) attention_core_kernel(const bf16* __restrict__ q_in,
                                                                      const bf16* __restrict__ k_in,
                                                                      const bf16* __restrict__ v_in, int ld,
                                                                      const float* __restrict__ mask,
                                                                      OutT* __restrict__ out, int L, int H,
                                                                      float scale) {
  extern __shared__ __align__(128) char smem[];
  const int LKP = att_keys_padded(L), SLD = att_s_ld(L);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + QT * HD_LD;  // K chunk, later the V chunk
  float* S = reinterpret_cast<float*>(Ks + QT * HD_LD);
  float* neg = S + QT * SLD;

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int HID = H * HD;
  const size_t head = (size_t)b * L * ld + h * HD;
  const bf16 *qb = q_in + head, *kb = k_in + head, *vb = v_in + head;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int j = tid; j < LKP; j += ATT_THREADS)
    neg[j] = j < L ? (mask[(size_t)b * L + j] - 1.0f) * 1e9f : 0.0f;
  // Q tile: 64 rows x 64 bf16 = 512 chunks of 16 bytes
  for (int c = tid; c < QT * HD / 8; c += ATT_THREADS) {
    const int row = c >> 3, col = (c & 7) * 8;
    *reinterpret_cast<uint4*>(Qs + row * HD_LD + col) =
        load16(qb + (size_t)(q0 + row) * ld + col, q0 + row < L);
  }
  __syncthreads();
  FragA qf[HD / 16];
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) wmma::load_matrix_sync(qf[k], Qs + warp * 16 * HD_LD + k * 16, HD_LD);

  // S = Q K^T on the tensor cores, one 64-key chunk at a time
  for (int kc = 0; kc < LKP; kc += KC) {
    for (int c = tid; c < KC * HD / 8; c += ATT_THREADS) {
      const int row = c >> 3, col = (c & 7) * 8;
      *reinterpret_cast<uint4*>(Ks + row * HD_LD + col) =
          load16(kb + (size_t)(kc + row) * ld + col, kc + row < L);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KC / 16; ++j) {
      FragC sf;
      wmma::fill_fragment(sf, 0.0f);
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        FragBcol kf;  // element (d, key) at Ks[key * HD_LD + d]
        wmma::load_matrix_sync(kf, Ks + j * 16 * HD_LD + k * 16, HD_LD);
        wmma::mma_sync(sf, qf[k], kf, sf);
      }
      wmma::store_matrix_sync(S + warp * 16 * SLD + kc + j * 16, sf, SLD, wmma::mem_row_major);
    }
    __syncthreads();
  }

  // f32 softmax over the L real keys; padded key columns get probability 0
  for (int rr = 0; rr < 16; ++rr) {
    float* srow = S + (warp * 16 + rr) * SLD;
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
    for (int j = lane; j < LKP; j += 32) {
      const float p = j < L ? srow[j] / sum : 0.0f;
      srow[j] = ROUND_P ? __bfloat162float(__float2bfloat16(p)) : p;
    }
  }
  __syncthreads();

  // O = P V with P in f32: thread owns rows g + 8*i (i < 8) and 4 columns
  const int g = tid >> 4, c0 = (tid & 15) * 4;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  for (int kc = 0; kc < LKP; kc += KC) {
    for (int c = tid; c < KC * HD / 8; c += ATT_THREADS) {
      const int row = c >> 3, col = (c & 7) * 8;
      *reinterpret_cast<uint4*>(Ks + row * HD_LD + col) =
          load16(vb + (size_t)(kc + row) * ld + col, kc + row < L);
    }
    __syncthreads();
    for (int j = 0; j < KC; ++j) {
      const uint2 raw = *reinterpret_cast<const uint2*>(Ks + j * HD_LD + c0);
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
    const int q = q0 + g + 8 * i;
    if (q < L) {
      OutT* dst = out + ((size_t)b * L + q) * HID + h * HD + c0;
      if constexpr (sizeof(OutT) == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
        __align__(8) bf16 o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = __float2bfloat16(acc[i][e]);
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(o);
      }
    }
  }
}

// ---- row LayerNorm ----------------------------------------------------------
// One warp per row of the f32 pre-LN sums; two-pass mean/variance as in the
// TPU kernel, eps inside the rsqrt, bf16 out.
__global__ void __launch_bounds__(256) layernorm_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                                                        const float* __restrict__ beta, bf16* __restrict__ out,
                                                        int M, int N, float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = x + (size_t)row * N;
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
  const float inv = rsqrtf(q / N + eps);
  for (int j = lane; j < N; j += 32)
    out[(size_t)row * N + j] = __float2bfloat16((xr[j] - mean) * inv * gamma[j] + beta[j]);
}

template <typename OutT, bool ROUND_P>
int launch_attention_core(const bf16* q, const bf16* k, const bf16* v, int ld, const void* mask, void* out, int B,
                          int L, int H, float scale, void* stream) {
  const size_t smem = att_smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(attention_core_kernel<OutT, ROUND_P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + QT - 1) / QT, H, B);
  attention_core_kernel<OutT, ROUND_P><<<grid, ATT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, ld, static_cast<const float*>(mask), static_cast<OutT*>(out), L, H, scale);
  return static_cast<int>(cudaGetLastError());
}

// K1's packed QKV GEMM output (B, L, 3*HID): Q, K, V side by side in a row
template <typename OutT>
int launch_packed_attention_core(const void* qkv, const void* mask, void* out, int B, int L, int H, float scale,
                                 void* stream) {
  const bf16* p = static_cast<const bf16*>(qkv);
  const int hid = H * HD;
  return launch_attention_core<OutT, false>(p, p + hid, p + 2 * hid, 3 * hid, mask, out, B, L, H, scale, stream);
}

}  // namespace mm

using namespace mm;

extern "C" {

const char* mm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// C = A.B + bias (+ epilogue); A (M,K) bf16, B (K,N) bf16, bias (N) f32,
// resid (M,N) bf16 for EPI_BIAS_RESID_F32 (C f32), C bf16 otherwise.
int mm_gemm(const void* A, const void* B, const void* bias, const void* resid, void* C, int M, int N, int K,
            int epilogue, void* stream) {
  const dim3 grid((N + TILE_N - 1) / TILE_N, (M + TILE_M - 1) / TILE_M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* b = static_cast<const bf16*>(B);
  const float* bi = static_cast<const float*>(bias);
  const bf16* r = static_cast<const bf16*>(resid);
  switch (epilogue) {
    case EPI_BIAS_BF16:
      gemm_kernel<EPI_BIAS_BF16><<<grid, TILE_THREADS, 0, s>>>(a, b, bi, r, C, M, N, K);
      break;
    case EPI_BIAS_GELU_BF16:
      gemm_kernel<EPI_BIAS_GELU_BF16><<<grid, TILE_THREADS, 0, s>>>(a, b, bi, r, C, M, N, K);
      break;
    case EPI_BIAS_RESID_F32:
      gemm_kernel<EPI_BIAS_RESID_F32><<<grid, TILE_THREADS, 0, s>>>(a, b, bi, r, C, M, N, K);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (B,L,H*64) bf16 = per-head softmax(QK^T*scale + mask) V from qkv (B,L,3*H*64).
int mm_attention_core(const void* qkv, const void* mask, void* out, int B, int L, int H, float scale,
                      void* stream) {
  return launch_packed_attention_core<bf16>(qkv, mask, out, B, L, H, scale, stream);
}

// The same with out (B,L,H*64) f32, P.V's f32 sums uncast (int8 attention half).
int mm_attention_core_f32(const void* qkv, const void* mask, void* out, int B, int L, int H, float scale,
                          void* stream) {
  return launch_packed_attention_core<float>(qkv, mask, out, B, L, H, scale, stream);
}

// K13: out (B,L,H*64) bf16 = per-head softmax(QK^T*scale + mask) V from
// separate q, k, v (B,L,H*64) bf16, the probabilities rounded to bf16.
int mm_fused_mha(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int L, int H,
                 float scale, void* stream) {
  return launch_attention_core<bf16, true>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                           static_cast<const bf16*>(v), H * HD, mask, out, B, L, H, scale, stream);
}

// out (M,N) bf16 = LayerNorm(x (M,N) f32) * gamma + beta
int mm_layernorm(const void* x, const void* gamma, const void* beta, void* out, int M, int N, float eps,
                 void* stream) {
  layernorm_kernel<<<(M + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<bf16*>(out), M, N, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
