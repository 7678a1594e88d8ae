// ColBERT all-pairs MaxSim, written for Hopper.
//
// Replaces the Pallas kernel of matchmaker_tpu/ops/pallas_kernels.py:
//   K14 _maxsim_v2_kernel (maxsim_all_pairs_pallas_v2) -> maxsim_kernel
// out[b][j] = sum_l w(b,l) * max_t s(b,l,j,t), s = q[b,l].d[j,t] for a live
// doc token (mask > 0) and `fill` for a padded one, w the query mask, a
// masked query token adding exactly 0 (never -inf * 0).
//
// What bounds it on the card: 2*Bq*Lq*Bd*Ld*D operations against
// (Bq*Lq + Bd*Ld)*D*4 bytes. At the ColBERT shapes (D 128-768, Lq 32, Ld 200)
// every doc token is used by all Bq*Lq query rows, so the function is compute
// bound, and the products run as f32 FMAs on the CUDA cores: the TPU kernel
// computes in f32 by default, and TF32 or bf16 tensor-core products would
// break the 1e-4 agreement with the plain version.
//
// Design: one block per (doc, group of whole queries). The group's query rows
// are walked in row tiles of 128: whole queries of Lq <= 128 share one tile
// (qpb = 128 / Lq of them), a query of Lq > 128 (up to 512) takes one block
// and ceil(Lq / 128) tiles in turn. For each tile the doc's tokens come
// through in chunks of 64, and the contraction over D in slabs held
// transposed in shared memory: with D <= 256 the tile's query rows stay
// resident over all of D for the whole run over the tokens (RESIDENT), past
// that a 64-deep slab of the query rows and of the token chunk is loaded per
// step (so any D % 8 == 0 fits in 52 KB). Each of 256 threads keeps an
// 8 rows x 4 tokens tile of dot products in registers across the slabs
// (three 16-byte shared loads per 32 FMAs, k in order from 0 to D - 1 in
// both forms, so they give the same bits) and a running max per row; a
// shuffle finishes the max over the 16 token groups into a shared row of
// every query row's best, and one thread per query sums its rows in order:
// the sum's order is fixed, so reruns give identical bits. The
// (Bq, Lq, Bd, Ld) scores never reach device memory.
#include <cuda_runtime.h>
#include <math.h>

namespace mm {

constexpr int MS_ROWS = 128;         // query rows of one row tile
constexpr int MS_TOK = 64;           // doc tokens per shared-memory chunk
constexpr int MS_SLAB = 64;          // contraction depth per slab when D is streamed
constexpr int MS_RESIDENT_DIM = 256; // largest D held resident
constexpr int MS_MAX_LQ = 512;       // query rows a block sums (the encoder's position limit)
constexpr int MS_THREADS = 256;      // 16 row groups x 16 token groups
constexpr int MS_TM = 8, MS_TN = 4;  // rows x tokens of one thread's tile
constexpr int MS_Q_LD = MS_ROWS + 4; // transposed tiles [k][row]: 16-byte rows,
constexpr int MS_D_LD = MS_TOK + 4;  // and a row stride of 4 mod 32 banks

inline size_t maxsim_smem_bytes(int depth) {
  return ((size_t)depth * (MS_Q_LD + MS_D_LD) + MS_MAX_LQ) * sizeof(float);
}

// Copy columns [k0, k0 + cols) of rows [0, n_valid) of a (rows, D) f32 tile
// to dst[k][r] (stride ld), zeros beyond n_valid; cols % 8 == 0. A warp takes
// 16 rows x 2 float4 columns, so its global reads are 32-byte row pieces and
// its shared stores hit 32 banks.
template <int ROWS>
__device__ __forceinline__ void load_transposed(const float* __restrict__ src, int n_valid, int D, int k0, int cols,
                                                float* dst, int ld) {
  const int c4 = cols >> 2;
  for (int c = threadIdx.x; c < ROWS * c4; c += MS_THREADS) {
    const int w = c >> 5, lane = c & 31;
    const int r = (w % (ROWS / 16)) * 16 + (lane & 15);
    const int k = ((w / (ROWS / 16)) * 2 + (lane >> 4)) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < n_valid) v = *reinterpret_cast<const float4*>(src + (size_t)r * D + k0 + k);
    dst[(k + 0) * ld + r] = v.x;
    dst[(k + 1) * ld + r] = v.y;
    dst[(k + 2) * ld + r] = v.z;
    dst[(k + 3) * ld + r] = v.w;
  }
}

// grid (Bd, ceil(Bq / qpb)); qpb = queries a block holds: 128 / Lq for
// Lq <= 128, else 1. RESIDENT: D <= 256, the query tile held over all of D.
template <bool RESIDENT>
__global__ void __launch_bounds__(MS_THREADS) maxsim_kernel(const float* __restrict__ q, const float* __restrict__ d,
                                                            const float* __restrict__ q_mask,
                                                            const float* __restrict__ d_mask, float* __restrict__ out,
                                                            int Bq, int Lq, int Bd, int Ld, int D, int qpb,
                                                            float fill) {
  extern __shared__ __align__(16) float ms_smem[];
  const int depth = RESIDENT ? D : MS_SLAB;
  float* Qs = ms_smem;                // [depth][MS_Q_LD]
  float* Ds = Qs + depth * MS_Q_LD;   // [depth][MS_D_LD]
  float* best = Ds + depth * MS_D_LD; // [MS_MAX_LQ]
  const int j = blockIdx.x, b0 = blockIdx.y * qpb;
  const int nq = min(qpb, Bq - b0), rows = nq * Lq;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* qb = q + (size_t)b0 * Lq * D;
  const float* dj = d + (size_t)j * Ld * D;
  const float* mj = d_mask + (size_t)j * Ld;

  for (int r0 = 0; r0 < rows; r0 += MS_ROWS) {
    const float* qt = qb + (size_t)r0 * D;
    const int n_rows = rows - r0;
    if (RESIDENT) {
      __syncthreads();  // the previous tile's reads of Qs are done
      load_transposed<MS_ROWS>(qt, n_rows, D, 0, D, Qs, MS_Q_LD);
    }
    float rmax[MS_TM];
#pragma unroll
    for (int i = 0; i < MS_TM; ++i) rmax[i] = -INFINITY;

    for (int t0 = 0; t0 < Ld; t0 += MS_TOK) {
      float acc[MS_TM][MS_TN];
#pragma unroll
      for (int i = 0; i < MS_TM; ++i)
#pragma unroll
        for (int e = 0; e < MS_TN; ++e) acc[i][e] = 0.0f;
      for (int k0 = 0; k0 < D; k0 += depth) {
        const int cols = min(depth, D - k0);
        __syncthreads();  // the previous slab is consumed (and Qs written)
        if (!RESIDENT) load_transposed<MS_ROWS>(qt, n_rows, D, k0, cols, Qs, MS_Q_LD);
        load_transposed<MS_TOK>(dj + (size_t)t0 * D, Ld - t0, D, k0, cols, Ds, MS_D_LD);
        __syncthreads();
        const float* qa = Qs + ty * MS_TM;
        const float* db = Ds + tx * MS_TN;
#pragma unroll 4
        for (int k = 0; k < cols; ++k) {
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
      for (int i = 0; i < MS_TM; ++i) {
        const int r = r0 + ty * MS_TM + i;
        if (r < rows) best[r] = rmax[i];
      }
  }
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

template <bool RESIDENT>
cudaError_t launch_maxsim(const float* q, const float* d, const float* q_mask, const float* d_mask, float* out,
                          int Bq, int Lq, int Bd, int Ld, int D, float fill, cudaStream_t stream) {
  const size_t smem = maxsim_smem_bytes(RESIDENT ? D : MS_SLAB);
  cudaError_t err =
      cudaFuncSetAttribute(maxsim_kernel<RESIDENT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int qpb = Lq <= MS_ROWS ? MS_ROWS / Lq : 1;
  const dim3 grid(Bd, (Bq + qpb - 1) / qpb);
  maxsim_kernel<RESIDENT><<<grid, MS_THREADS, smem, stream>>>(q, d, q_mask, d_mask, out, Bq, Lq, Bd, Ld, D, qpb,
                                                              fill);
  return cudaGetLastError();
}

}  // namespace mm

using namespace mm;

extern "C" {

// out (Bq, Bd) f32 = all-pairs MaxSim of q (Bq, Lq, D) and d (Bd, Ld, D), all
// f32 and contiguous, masks (Bq, Lq) / (Bd, Ld) f32; D % 8 == 0 (any D),
// 1 <= Lq <= 512. stream_d != 0 streams D in slabs even where D <= 256 would
// stay resident (the same bits; for timing the two forms).
int mm_maxsim(const void* q, const void* d, const void* q_mask, const void* d_mask, void* out, int Bq, int Lq,
              int Bd, int Ld, int D, float fill, int stream_d, void* stream) {
  if (D < 8 || D % 8 || Lq < 1 || Lq > MS_MAX_LQ) return static_cast<int>(cudaErrorInvalidValue);
  auto* qq = static_cast<const float*>(q);
  auto* dd = static_cast<const float*>(d);
  auto* qm = static_cast<const float*>(q_mask);
  auto* dm = static_cast<const float*>(d_mask);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = (D <= MS_RESIDENT_DIM && !stream_d)
                              ? launch_maxsim<true>(qq, dd, qm, dm, o, Bq, Lq, Bd, Ld, D, fill, s)
                              : launch_maxsim<false>(qq, dd, qm, dm, o, Bq, Lq, Bd, Ld, D, fill, s);
  return static_cast<int>(err);
}

}  // extern "C"
