// Shared 128x128 bf16 tile product on the tensor cores (nvcuda::wmma,
// f32 accumulation), used by the encoder GEMMs (encoder_kernels.cu,
// encoder_backward_kernels.cu) and the binmax scan (binmax_kernels.cu):
// A.B and A.B^T (tile_mma), A^T.B (tile_mma_tn).
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

// C[m0:m0+128, n0:n0+128] = A[m0:, :K] . B, accumulated into acc.
// A: (M, K) row-major, lda = K. B_NK=false: B is (K, N) row-major;
// B_NK=true: B is (N, K) row-major (the product is A . B^T).
// Rows of A past M and columns past N read as zero. K % 32 == 0, rows
// 16-byte aligned (checked by the Python wrappers).
template <bool B_NK>
__device__ __forceinline__ void tile_mma(const bf16* __restrict__ A, int M, const bf16* __restrict__ B, int N,
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
      ra[c] = load16(A + (size_t)(m0 + row) * K + k0 + col, m0 + row < M);
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

// The transposed-A tile for weight gradients (encoder_backward_kernels.cu):
// C[i0:i0+128, j0:j0+128] = sum over rows r in [r_begin, r_end) of
// A[r][i] * B[r][j], i.e. A^T . B contracting the row dimension. A (R, I) and
// B (R, J) row-major. Rows outside [r_begin, r_end) read as zero, so the row
// count needs no alignment; I and J are multiples of 8 (16-byte chunks).
// A's K-step tile is staged [k][i] in shared memory and read as a col-major
// matrix_a fragment, so no transpose pass exists.
constexpr int AT_LD = TILE_M + 8;  // A^T staged [K][M]: 272-byte rows
using FragAcol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

__device__ __forceinline__ void tile_mma_tn(const bf16* __restrict__ A, int I, const bf16* __restrict__ B, int J,
                                            int r_begin, int r_end, int i0, int j0, char* smem,
                                            FragC (&acc)[FRAG_M][FRAG_N]) {
  static_assert(2 * TILE_K * AT_LD * 2 + 2 * TILE_K * BKN_LD * 2 <= TILE_SMEM_BYTES, "A^T ring too large");
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * TILE_K * AT_LD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;

#pragma unroll
  for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // per K step: 32 rows x 128 columns of A and of B, two 16-byte chunks of each per thread
  uint4 ra[2], rb[2];
  auto fetch = [&](int r0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int chunk = tid + c * TILE_THREADS;  // 0..511
      const int row = chunk >> 4, col = (chunk & 15) * 8;
      const bool in_rows = r0 + row < r_end;
      ra[c] = load16(A + (size_t)(r0 + row) * I + i0 + col, in_rows && i0 + col < I);
      rb[c] = load16(B + (size_t)(r0 + row) * J + j0 + col, in_rows && j0 + col < J);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int chunk = tid + c * TILE_THREADS;
      const int row = chunk >> 4, col = (chunk & 15) * 8;
      *reinterpret_cast<uint4*>(As + buf * TILE_K * AT_LD + row * AT_LD + col) = ra[c];
      *reinterpret_cast<uint4*>(Bs + buf * TILE_K * BKN_LD + row * BKN_LD + col) = rb[c];
    }
  };

  const int steps = (r_end - r_begin + TILE_K - 1) / TILE_K;
  if (steps > 0) fetch(r_begin);
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    stash(buf);
    __syncthreads();
    if (s + 1 < steps) fetch(r_begin + (s + 1) * TILE_K);
    const bf16* a_base = As + buf * TILE_K * AT_LD + wm * WARP_M;
    const bf16* b_base = Bs + buf * TILE_K * BKN_LD + wn * WARP_N;
#pragma unroll
    for (int kk = 0; kk < TILE_K; kk += 16) {
      FragAcol fa[FRAG_M];
#pragma unroll
      for (int i = 0; i < FRAG_M; ++i) wmma::load_matrix_sync(fa[i], a_base + kk * AT_LD + i * 16, AT_LD);
#pragma unroll
      for (int j = 0; j < FRAG_N; ++j) {
        FragBrow fb;
        wmma::load_matrix_sync(fb, b_base + kk * BKN_LD + j * 16, BKN_LD);
#pragma unroll
        for (int i = 0; i < FRAG_M; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
  }
  __syncthreads();
}

}  // namespace mm
