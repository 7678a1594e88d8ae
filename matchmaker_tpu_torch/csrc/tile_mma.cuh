// The 128x128 tile product on the tensor cores (nvcuda::wmma) of the mixed
// binmax scan K8 (binmax_int8f_kernel, binmax_kernels.cu), its only user:
// C = A.B^T with A int8 codes, which become bf16 exactly on their way to
// shared memory, B bf16, f32 sums. The bf16 (K3) and int8 (K7) scans and the
// encoder's products run on wgmma (wgmma_gemm.cuh, encoder_int8_kernels.cu).
//
// Bound: at K8's shape (262,144 x 768 rows against 256 queries) the product
// is compute bound on the card. It stages tiles through registers into a
// double-buffered shared-memory ring (one __syncthreads per K step) and
// issues mma.sync through wmma; K8's move to the wgmma/TMA scan is the next
// redesign (ROADMAP.md).
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
constexpr int BNK_LD = TILE_K + 8; // B stored [N][K] (queries, row-major (Q, D))

// shared bytes the ring needs (both buffers of A and of B)
constexpr int TILE_SMEM_BYTES = 2 * TILE_M * A_LD * 2 + 2 * TILE_N * BNK_LD * 2;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBcol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ uint4 load16(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

// eight consecutive int8 codes as eight bf16 (|code| <= 127 fits bf16's
// 8-bit significand, so exactly)
__device__ __forceinline__ uint4 load8_as_bf16(const int8_t* p, bool ok) {
  if (!ok) return make_uint4(0u, 0u, 0u, 0u);
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  __align__(16) bf16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(static_cast<float>(c[e]));
  return *reinterpret_cast<const uint4*>(v);
}

// C[m0:m0+128, n0:n0+128] = A[m0:, :K] . B^T, accumulated into acc.
// A: (M, K) row-major int8 codes, lda = K; B: (N, K) row-major bf16. Rows
// of A past M and rows of B past N read as zero. K % 32 == 0, rows 16-byte
// aligned (checked by the Python wrappers).
__device__ __forceinline__ void tile_mma(const int8_t* __restrict__ A, int M, const bf16* __restrict__ B, int N,
                                         int K, int m0, int n0, char* smem, FragC (&acc)[FRAG_M][FRAG_N]) {
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * TILE_M * A_LD;
  constexpr int B_BUF = TILE_N * BNK_LD;
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
      rb[c] = load16(B + (size_t)(n0 + row) * K + k0 + col, n0 + row < N);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      int chunk = tid + c * TILE_THREADS;
      int row = chunk >> 2, col = (chunk & 3) * 8;
      *reinterpret_cast<uint4*>(As + buf * TILE_M * A_LD + row * A_LD + col) = ra[c];
      *reinterpret_cast<uint4*>(Bs + buf * B_BUF + row * BNK_LD + col) = rb[c];
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
        FragBcol fb;
        wmma::load_matrix_sync(fb, b_base + ncol * BNK_LD + kk, BNK_LD);
#pragma unroll
        for (int i = 0; i < FRAG_M; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
  }
  __syncthreads();  // the ring may be reused by the caller's epilogue
}

}  // namespace mm
