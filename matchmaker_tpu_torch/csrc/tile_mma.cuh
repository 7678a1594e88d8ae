// Shared 128x128 tile products on the tensor cores (nvcuda::wmma), used by
// the forward encoder GEMMs (encoder_kernels.cu, encoder_int8_kernels.cu) and
// the binmax scan (binmax_kernels.cu); the backward's products run on
// wgmma_gemm.cuh:
//   bf16 x bf16 -> f32: A.B and A.B^T (tile_mma; A may be int8 codes, which
//                       become bf16 exactly on their way to shared memory);
//   int8 x int8 -> int32: A.B and A.B^T (tile_mma_s8), exact.
//
// Bound: at the main path's shapes (M = B*L rows >= 7680, N = 768..3072,
// K = 768/3072) every product here is compute bound on the card. This first
// version stages tiles through registers into a double-buffered shared-memory
// ring (one __syncthreads per K step) and issues mma.sync through wmma;
// wgmma and TMA are left for a later version.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace mm {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int TILE_M = 128;
constexpr int TILE_N = 128;
constexpr int TILE_K = 32;
constexpr int TILE_THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int WARP_M = 32;         // rows of C per warp
constexpr int WARP_N = 64;         // columns of C per warp
constexpr int FRAG_M = WARP_M / 16;
constexpr int FRAG_N = WARP_N / 16;
constexpr int A_LD = TILE_K + 8;   // padded rows: 80 bytes, fragment starts stay 32-byte aligned
constexpr int BKN_LD = TILE_N + 8; // B stored [K][N] (weights, row-major (in, out))
constexpr int BNK_LD = TILE_K + 8; // B stored [N][K] (queries, row-major (Q, D))

// shared bytes the ring needs (both buffers of A and of B)
constexpr int TILE_SMEM_BYTES =
    2 * TILE_M * A_LD * 2 + 2 * (TILE_K * BKN_LD > TILE_N * BNK_LD ? TILE_K * BKN_LD : TILE_N * BNK_LD) * 2;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBrow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBcol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ uint4 load16(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

// eight consecutive A elements as eight bf16: bf16 as they are, int8 codes
// converted (|code| <= 127 fits bf16's 8-bit significand, so exactly)
__device__ __forceinline__ uint4 load8_as_bf16(const bf16* p, bool ok) { return load16(p, ok); }
__device__ __forceinline__ uint4 load8_as_bf16(const int8_t* p, bool ok) {
  if (!ok) return make_uint4(0u, 0u, 0u, 0u);
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  __align__(16) bf16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(static_cast<float>(c[e]));
  return *reinterpret_cast<const uint4*>(v);
}

// C[m0:m0+128, n0:n0+128] = A[m0:, :K] . B, accumulated into acc.
// A: (M, K) row-major, lda = K, bf16 or int8 codes (AT). B_NK=false: B is
// (K, N) row-major; B_NK=true: B is (N, K) row-major (the product is A . B^T).
// Rows of A past M and columns past N read as zero. K % 32 == 0, rows
// 16-byte aligned (checked by the Python wrappers).
template <bool B_NK, typename AT = bf16>
__device__ __forceinline__ void tile_mma(const AT* __restrict__ A, int M, const bf16* __restrict__ B, int N,
                                         int K, int m0, int n0, char* smem, FragC (&acc)[FRAG_M][FRAG_N]) {
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * TILE_M * A_LD;
  constexpr int B_BUF = B_NK ? TILE_N * BNK_LD : TILE_K * BKN_LD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // 0..3
  const int wn = warp & 1;   // 0..1

#pragma unroll
  for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // each thread moves two 16-byte chunks of A and two of B per K step
  uint4 ra[2], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      int chunk = tid + c * TILE_THREADS;  // 0..511
      int row = chunk >> 2, col = (chunk & 3) * 8;
      ra[c] = load8_as_bf16(A + (size_t)(m0 + row) * K + k0 + col, m0 + row < M);
      if (B_NK) {
        rb[c] = load16(B + (size_t)(n0 + row) * K + k0 + col, n0 + row < N);
      } else {
        int brow = chunk >> 4, bcol = (chunk & 15) * 8;
        rb[c] = load16(B + (size_t)(k0 + brow) * N + n0 + bcol, n0 + bcol < N);
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      int chunk = tid + c * TILE_THREADS;
      int row = chunk >> 2, col = (chunk & 3) * 8;
      *reinterpret_cast<uint4*>(As + buf * TILE_M * A_LD + row * A_LD + col) = ra[c];
      if (B_NK) {
        *reinterpret_cast<uint4*>(Bs + buf * B_BUF + row * BNK_LD + col) = rb[c];
      } else {
        int brow = chunk >> 4, bcol = (chunk & 15) * 8;
        *reinterpret_cast<uint4*>(Bs + buf * B_BUF + brow * BKN_LD + bcol) = rb[c];
      }
    }
  };

  const int steps = K / TILE_K;
  fetch(0);
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    stash(buf);
    __syncthreads();
    if (s + 1 < steps) fetch((s + 1) * TILE_K);  // in flight while the tensor cores work
    const bf16* a_base = As + buf * TILE_M * A_LD + (wm * WARP_M) * A_LD;
    const bf16* b_base = Bs + buf * B_BUF;
#pragma unroll
    for (int kk = 0; kk < TILE_K; kk += 16) {
      FragA fa[FRAG_M];
#pragma unroll
      for (int i = 0; i < FRAG_M; ++i) wmma::load_matrix_sync(fa[i], a_base + i * 16 * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < FRAG_N; ++j) {
        const int ncol = wn * WARP_N + j * 16;
        if (B_NK) {
          FragBcol fb;
          wmma::load_matrix_sync(fb, b_base + ncol * BNK_LD + kk, BNK_LD);
#pragma unroll
          for (int i = 0; i < FRAG_M; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        } else {
          FragBrow fb;
          wmma::load_matrix_sync(fb, b_base + kk * BKN_LD + ncol, BKN_LD);
#pragma unroll
          for (int i = 0; i < FRAG_M; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();  // the ring may be reused by the caller's epilogue
}

// ---- int8 x int8 -> int32 ----------------------------------------------
// wmma's signed-char 16x16x16 product with an int accumulator. Fragment
// pointers must be 32-byte aligned, and a 16-byte k step of a row-major int8
// tile is not, so every int8 tile is staged in shared memory as 16-byte-wide
// slabs: slab s holds bytes [16s, 16s+16) of every row, rows 16 bytes apart
// (ldm = 16). A slab's stride is padded by 32 bytes so neighbouring threads'
// 16-byte stores land on different banks.
constexpr int S8_TILE_K = 64;                    // K bytes per step: 4 slabs
constexpr int S8_SLAB_ROWS = TILE_M * 16 + 32;   // slab of 128 rows (A, or B stored [N][K])
constexpr int S8_SLAB_KN = S8_TILE_K * 16 + 32;  // slab of 64 k-rows (B stored [K][N])
constexpr int S8_A_BUF = (S8_TILE_K / 16) * S8_SLAB_ROWS;
constexpr int S8_BKN_BUF = (TILE_N / 16) * S8_SLAB_KN;
constexpr int S8_B_BUF = S8_A_BUF > S8_BKN_BUF ? S8_A_BUF : S8_BKN_BUF;
constexpr int S8_SMEM_BYTES = 2 * S8_A_BUF + 2 * S8_B_BUF;  // both buffers of A and of B

using FragA8 = wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>;
using FragB8row = wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major>;
using FragB8col = wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major>;
using FragCi = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

__device__ __forceinline__ uint4 load16b(const int8_t* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

// C[m0:m0+128, n0:n0+128] = A[m0:, k_begin:k_end] . B[k_begin:k_end, :] in
// int32, exact. A: (M, lda) int8 row-major. B_NK=false: B is (K, N) int8
// row-major (weights, (in, out)); B_NK=true: B is (N, lda) row-major (the
// product is A . B^T). Rows past M and columns past N read as zero;
// (k_end - k_begin) % 64 == 0, lda % 16 == 0 and N % 16 == 0 (checked by the
// Python wrappers). Ends with __syncthreads: the caller may reuse smem.
template <bool B_NK>
__device__ __forceinline__ void tile_mma_s8(const int8_t* __restrict__ A, int M, int lda,
                                            const int8_t* __restrict__ B, int N, int k_begin, int k_end,
                                            int m0, int n0, char* smem, FragCi (&acc)[FRAG_M][FRAG_N]) {
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + 2 * S8_A_BUF;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;

#pragma unroll
  for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j) wmma::fill_fragment(acc[i][j], 0);

  // per K step 128 rows x 64 bytes of A and 512 16-byte chunks of B: two of each per thread
  uint4 ra[2], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int chunk = tid + c * TILE_THREADS;  // 0..511
      const int row = chunk >> 2, slab = chunk & 3;
      ra[c] = load16b(A + (size_t)(m0 + row) * lda + k0 + slab * 16, m0 + row < M);
      if (B_NK) {
        rb[c] = load16b(B + (size_t)(n0 + row) * lda + k0 + slab * 16, n0 + row < N);
      } else {
        const int krow = chunk >> 3, nslab = chunk & 7;
        rb[c] = load16b(B + (size_t)(k0 + krow) * N + n0 + nslab * 16, n0 + nslab * 16 < N);
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int chunk = tid + c * TILE_THREADS;
      const int row = chunk >> 2, slab = chunk & 3;
      *reinterpret_cast<uint4*>(As + buf * S8_A_BUF + slab * S8_SLAB_ROWS + row * 16) = ra[c];
      if (B_NK) {
        *reinterpret_cast<uint4*>(Bs + buf * S8_B_BUF + slab * S8_SLAB_ROWS + row * 16) = rb[c];
      } else {
        const int krow = chunk >> 3, nslab = chunk & 7;
        *reinterpret_cast<uint4*>(Bs + buf * S8_B_BUF + nslab * S8_SLAB_KN + krow * 16) = rb[c];
      }
    }
  };

  const int steps = (k_end - k_begin) / S8_TILE_K;
  if (steps > 0) fetch(k_begin);
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    stash(buf);
    __syncthreads();
    if (s + 1 < steps) fetch(k_begin + (s + 1) * S8_TILE_K);
    const int8_t* a_base = As + buf * S8_A_BUF + (wm * WARP_M) * 16;
    const int8_t* b_base = Bs + buf * S8_B_BUF;
#pragma unroll
    for (int ks = 0; ks < S8_TILE_K / 16; ++ks) {
      FragA8 fa[FRAG_M];
#pragma unroll
      for (int i = 0; i < FRAG_M; ++i)
        wmma::load_matrix_sync(fa[i], a_base + ks * S8_SLAB_ROWS + i * 16 * 16, 16);
#pragma unroll
      for (int j = 0; j < FRAG_N; ++j) {
        const int ncol = wn * WARP_N + j * 16;
        if (B_NK) {
          FragB8col fb;  // element (k, n) at slab ks, row n
          wmma::load_matrix_sync(fb, b_base + ks * S8_SLAB_ROWS + ncol * 16, 16);
#pragma unroll
          for (int i = 0; i < FRAG_M; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        } else {
          FragB8row fb;  // element (k, n) at slab n/16, row k
          wmma::load_matrix_sync(fb, b_base + (ncol / 16) * S8_SLAB_KN + ks * 16 * 16, 16);
#pragma unroll
          for (int i = 0; i < FRAG_M; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();
}

}  // namespace mm
