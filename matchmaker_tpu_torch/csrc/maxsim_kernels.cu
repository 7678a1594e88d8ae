// ColBERT all-pairs MaxSim, written for Hopper.
//
// Replaces the Pallas kernel of matchmaker_tpu/ops/pallas_kernels.py:
//   K14 _maxsim_v2_kernel (maxsim_all_pairs_pallas_v2) -> maxsim_kernel
// out[b][j] = sum_l w(b,l) * max_t s(b,l,j,t), s = q[b,l].d[j,t] for a live
// doc token (mask > 0) and `fill` for a padded one, w the query mask, a
// masked query token adding exactly 0 (never -inf * 0).
//
// What bounds it on the card: 2*Bq*Lq*Bd*Ld*D operations against
// (Bq*Lq + Bd*Ld)*D*4 bytes. At the ColBERT shapes (D 128, Lq 32, Ld 200)
// every doc token is used by all Bq*Lq query rows, so the function is compute
// bound, and the products run as f32 FMAs on the CUDA cores: the TPU kernel
// computes in f32 by default, and TF32 or bf16 tensor-core products would
// break the 1e-4 agreement with the plain version.
//
// Design: one block per (doc, group of whole queries): the group's query rows
// (at most 128, so the sum over a query's tokens stays inside the block) sit
// transposed in shared memory for the whole run over the doc's tokens, which
// come through in chunks of 64, transposed too. Each of 256 threads keeps an
// 8 rows x 4 tokens tile of dot products in registers (three 16-byte shared
// loads per 32 FMAs) and a running max per row; a shuffle finishes the max
// over the 16 token groups, and one thread per query sums its rows in order.
// The (Bq, Lq, Bd, Ld) scores never reach device memory.
#include <cuda_runtime.h>
#include <math.h>

namespace mm {

constexpr int MS_ROWS = 128;         // query rows a block holds
constexpr int MS_TOK = 64;           // doc tokens per shared-memory chunk
constexpr int MS_THREADS = 256;      // 16 row groups x 16 token groups
constexpr int MS_TM = 8, MS_TN = 4;  // rows x tokens of one thread's tile
constexpr int MS_Q_LD = MS_ROWS + 4; // transposed tiles [k][row]: 16-byte rows,
constexpr int MS_D_LD = MS_TOK + 4;  // and a row stride of 4 mod 32 banks

inline size_t maxsim_smem_bytes(int D) { return ((size_t)D * (MS_Q_LD + MS_D_LD) + MS_ROWS) * sizeof(float); }

// Copy rows [0, n_valid) of a (rows, D) f32 tile to dst[k][r] (stride ld),
// zeros beyond n_valid. A warp takes 16 rows x 2 float4 columns, so its
// global reads are 32-byte row pieces and its shared stores hit 32 banks.
template <int ROWS>
__device__ __forceinline__ void load_transposed(const float* __restrict__ src, int n_valid, int D, float* dst,
                                                int ld) {
  const int d4 = D >> 2;
  for (int c = threadIdx.x; c < ROWS * d4; c += MS_THREADS) {
    const int w = c >> 5, lane = c & 31;
    const int r = (w % (ROWS / 16)) * 16 + (lane & 15);
    const int k = ((w / (ROWS / 16)) * 2 + (lane >> 4)) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < n_valid) v = *reinterpret_cast<const float4*>(src + (size_t)r * D + k);
    dst[(k + 0) * ld + r] = v.x;
    dst[(k + 1) * ld + r] = v.y;
    dst[(k + 2) * ld + r] = v.z;
    dst[(k + 3) * ld + r] = v.w;
  }
}

// grid (Bd, ceil(Bq / qpb)); qpb = queries a block holds, qpb * Lq <= 128.
__global__ void __launch_bounds__(MS_THREADS) maxsim_kernel(const float* __restrict__ q, const float* __restrict__ d,
                                                            const float* __restrict__ q_mask,
                                                            const float* __restrict__ d_mask, float* __restrict__ out,
                                                            int Bq, int Lq, int Bd, int Ld, int D, int qpb,
                                                            float fill) {
  extern __shared__ __align__(16) float ms_smem[];
  float* Qs = ms_smem;                // [D][MS_Q_LD]
  float* Ds = Qs + D * MS_Q_LD;       // [D][MS_D_LD]
  float* best = Ds + D * MS_D_LD;     // [MS_ROWS]
  const int j = blockIdx.x, b0 = blockIdx.y * qpb;
  const int nq = min(qpb, Bq - b0), rows = nq * Lq;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_transposed<MS_ROWS>(q + (size_t)b0 * Lq * D, rows, D, Qs, MS_Q_LD);
  const float* dj = d + (size_t)j * Ld * D;
  const float* mj = d_mask + (size_t)j * Ld;
  float rmax[MS_TM];
#pragma unroll
  for (int i = 0; i < MS_TM; ++i) rmax[i] = -INFINITY;

  for (int t0 = 0; t0 < Ld; t0 += MS_TOK) {
    __syncthreads();  // the previous chunk is consumed (and Qs written)
    load_transposed<MS_TOK>(dj + (size_t)t0 * D, Ld - t0, D, Ds, MS_D_LD);
    __syncthreads();
    float acc[MS_TM][MS_TN];
#pragma unroll
    for (int i = 0; i < MS_TM; ++i)
#pragma unroll
      for (int e = 0; e < MS_TN; ++e) acc[i][e] = 0.0f;
    const float* qa = Qs + ty * MS_TM;
    const float* db = Ds + tx * MS_TN;
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(qa + k * MS_Q_LD);
      const float4 a1 = *reinterpret_cast<const float4*>(qa + k * MS_Q_LD + 4);
      const float4 bv = *reinterpret_cast<const float4*>(db + k * MS_D_LD);
      const float a[MS_TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[MS_TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < MS_TM; ++i)
#pragma unroll
        for (int e = 0; e < MS_TN; ++e) acc[i][e] = fmaf(a[i], b[e], acc[i][e]);
    }
#pragma unroll
    for (int e = 0; e < MS_TN; ++e) {
      const int t = t0 + tx * MS_TN + e;
      if (t < Ld) {
        const bool live = mj[t] > 0.0f;
#pragma unroll
        for (int i = 0; i < MS_TM; ++i) rmax[i] = fmaxf(rmax[i], live ? acc[i][e] : fill);
      }
    }
  }
  // max over the 16 token groups: the lanes of one half-warp share ty
#pragma unroll
  for (int i = 0; i < MS_TM; ++i)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], o));
  if (tx == 0)
#pragma unroll
    for (int i = 0; i < MS_TM; ++i) best[ty * MS_TM + i] = rmax[i];
  __syncthreads();
  if (tid < nq) {
    const float* w = q_mask + (size_t)(b0 + tid) * Lq;
    float s = 0.0f;
    for (int l = 0; l < Lq; ++l) {
      const float m = w[l];
      if (m != 0.0f) s += best[tid * Lq + l] * m;
    }
    out[(size_t)(b0 + tid) * Bd + j] = s;
  }
}

}  // namespace mm

using namespace mm;

extern "C" {

// out (Bq, Bd) f32 = all-pairs MaxSim of q (Bq, Lq, D) and d (Bd, Ld, D), all
// f32 and contiguous, masks (Bq, Lq) / (Bd, Ld) f32; D % 8 == 0, D <= 256,
// 1 <= Lq <= 128.
int mm_maxsim(const void* q, const void* d, const void* q_mask, const void* d_mask, void* out, int Bq, int Lq,
              int Bd, int Ld, int D, float fill, void* stream) {
  if (D % 8 || D > 256 || Lq < 1 || Lq > MS_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = maxsim_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(maxsim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qpb = MS_ROWS / Lq;
  const dim3 grid(Bd, (Bq + qpb - 1) / qpb);
  maxsim_kernel<<<grid, MS_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(d), static_cast<const float*>(q_mask),
      static_cast<const float*>(d_mask), static_cast<float*>(out), Bq, Lq, Bd, Ld, D, qpb, fill);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
