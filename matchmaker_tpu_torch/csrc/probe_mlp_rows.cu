// The row-packed fused MLP probe, written for Hopper.
//
// Replaces the Pallas kernels of benchmarks/mlp_rows_probe.py:
//   K17 _mlp_kernel_rows2d  (mlp_rows2d: whole padded examples a block)
//   K18 _mlp_kernel_rowsblk (mlp_rowsblk: flat 1024/2048-row blocks)
// -> mlp_rows_kernel<R>, which serves both wrappers (they differ only in how
// they pad the rows, ops in matchmaker_tpu_torch/probes/mlp_rows.py).
// y = LN(x + gelu(x.W1 + b1).W2 + b2) over rows x (M, 768) bf16, W1 (768, FF)
// and W2 (FF, 768) bf16 row-major, b1, b2 and the LayerNorm's scale and shift
// f32, eps as given; gelu is the FMA-only polynomial of the bf16 halves
// (encoder_common.cuh), its output rounded to bf16 before the second
// product; y is bf16.
//
// What bounds it on the card: 4*M*768*FF flops (483 GFLOP at M = 51,200,
// 0.49 ms at the bf16 peak) against M*768*4 + 9.4 MB bytes: the operations.
// But every block streams all of W1 and W2 (9.4 MB) through L2, so L2
// carries (M / R) * 9.4 MB a call: R is the row tile's one lever.
//
// Design: one block of R / 4 warps owns R rows (R = 16, 32 or 64: the
// accumulator's R * 768 f32 live in registers, 96 a thread) and walks FF in
// chunks of 128: h_c = gelu(x.W1[:, c] + b1[c]) (R x 128, K = 768) goes
// into shared memory as bf16, then acc += h_c.W2[c, :] (K = 128). Neither h
// nor the pre-LN sums reach device memory (K2 writes both). The x rows stay
// in shared memory for the whole run (the first product's A operand and the
// residual); W1 and W2 come through one 3-stage cp.async ring of equal
// stages: a chunk is 8 slices of W1 (96 x 128) then 8 of W2 (16 x 768).
// All products are mma.sync m16n8k16 (bf16 in, f32 sums), operands through
// ldmatrix (W slices transposed). The epilogue adds x and b2, takes each
// row's mean and variance over the 768 columns in two passes (per-warp
// partials summed in a fixed order through shared memory) and writes bf16.
#include "encoder_common.cuh"
#include "mma_sync.cuh"

#include <cuda_runtime.h>

namespace mm {
namespace probe_mlp {

using bf16 = __nv_bfloat16;

constexpr int HID = 768;
constexpr int FC = 128;                    // FF columns a chunk
constexpr int KS1 = 96, KS2 = 16;          // W1 / W2 rows a ring stage
constexpr int STEPS1 = HID / KS1, STEPS2 = FC / KS2, STEPS = STEPS1 + STEPS2;
constexpr int X_LD = HID + 8, H_LD = FC + 8, W1_LD = FC + 8, W2_LD = HID + 8;  // rows of 4 mod 32 words
constexpr int STAGE = KS1 * W1_LD > KS2 * W2_LD ? KS1 * W1_LD : KS2 * W2_LD;  // bf16 elements
constexpr int STAGES = 3;
constexpr int CHUNKS16 = KS1 * FC / 8;     // 16-byte pieces a stage (the same for both slices)
static_assert(KS1 * FC == KS2 * HID, "the ring's two slices are the same size");

// second product's warp tile: R = 16: 16 rows x 192 columns; else 32 x 96
template <int R> struct Tiling {
  static constexpr int WARPS = R / 4, THREADS = 32 * WARPS;
  static constexpr int MT = R == 16 ? 1 : 2;        // m16 tiles
  static constexpr int NT = R == 16 ? 24 : 12;      // n8 tiles
  static constexpr int CG = HID / (8 * NT);         // warps across the columns
};

template <int R>
constexpr size_t smem_bytes() {
  return (size_t)(R * X_LD + R * H_LD + STAGES * STAGE) * sizeof(bf16) + (size_t)2 * Tiling<R>::CG * R * sizeof(float);
}

// step s of chunk c: W1 rows [96s, 96s + 96) x columns [128c, 128c + 128),
// then W2 rows [128c + 16(s - 8), + 16) x all 768 columns
template <int R>
__device__ __forceinline__ void load_step(bf16* st, const bf16* __restrict__ w1, const bf16* __restrict__ w2, int FF,
                                          int c, int s) {
  for (int i = threadIdx.x; i < CHUNKS16; i += Tiling<R>::THREADS) {
    if (s < STEPS1) {
      const int row = i >> 4, col = (i & 15) * 8;
      cp_async16(st + row * W1_LD + col, w1 + (size_t)(s * KS1 + row) * FF + c * FC + col, true);
    } else {
      const int row = i / (HID / 8), col = (i % (HID / 8)) * 8;
      cp_async16(st + row * W2_LD + col, w2 + (size_t)(c * FC + (s - STEPS1) * KS2 + row) * HID + col, true);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(Tiling<R>::THREADS, 1)
    mlp_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
                    const bf16* __restrict__ w2, const float* __restrict__ b2, const float* __restrict__ gamma,
                    const float* __restrict__ beta, bf16* __restrict__ out, int M, int FF, float eps) {
  using T = Tiling<R>;
  extern __shared__ __align__(128) char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);  // [R][X_LD]
  bf16* Hs = Xs + R * X_LD;                  // [R][H_LD]
  bf16* ring = Hs + R * H_LD;                // [STAGES][STAGE]
  float* red = reinterpret_cast<float*>(ring + STAGES * STAGE);  // [2][CG][R]
  const int m0 = blockIdx.x * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  // first product: 16 rows x 32 columns of h_c a warp
  const int r1 = (warp >> 2) * 16, c1 = (warp & 3) * 32;
  // second product: MT*16 rows x NT*8 columns of acc a warp
  const int r2 = (warp / T::CG) * 16 * T::MT, cg = warp % T::CG, c2 = cg * 8 * T::NT;

  for (int i = threadIdx.x; i < R * HID / 8; i += T::THREADS) {
    const int row = i / (HID / 8), col = (i % (HID / 8)) * 8;
    const bool ok = m0 + row < M;
    cp_async16(Xs + row * X_LD + col, x + (size_t)(ok ? m0 + row : 0) * HID + col, ok);
  }
  cp_async_commit();
  const int chunks = FF / FC, total = chunks * STEPS;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    load_step<R>(ring + p * STAGE, w1, w2, FF, p / STEPS, p % STEPS);
    cp_async_commit();
  }

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
  float hacc[4][4];

  for (int gs = 0; gs < total; ++gs) {
    const int c = gs / STEPS, s = gs % STEPS;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step gs landed; every warp is done with step gs - 1
    const int next = gs + STAGES - 1;
    if (next < total) load_step<R>(ring + (next % STAGES) * STAGE, w1, w2, FF, next / STEPS, next % STEPS);
    cp_async_commit();
    const bf16* st = ring + (gs % STAGES) * STAGE;
    if (s < STEPS1) {
      if (s == 0)
#pragma unroll
        for (int j = 0; j < 4; ++j) hacc[j][0] = hacc[j][1] = hacc[j][2] = hacc[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS1 / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, Xs + (r1 + (lane & 15)) * X_LD + s * KS1 + 16 * kk + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bb[4];
          ldsm_x4_t(bb, st + (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * W1_LD + c1 + 16 * np + (lane >> 4) * 8);
          mma16816(hacc[2 * np], a, bb[0], bb[1]);
          mma16816(hacc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      if (s == STEPS1 - 1) {
        // h_c = bf16(gelu(. + b1)); fragment [j][2i + e]: row r1 + g + 8i, column c1 + 8j + 2 tig + e
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c1 + 8 * j + 2 * tig;
          const float bx = b1[c * FC + col], by = b1[c * FC + col + 1];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<uint32_t*>(Hs + (r1 + g + 8 * i) * H_LD + col) =
                pack_bf16(gelu_poly(hacc[j][2 * i] + bx), gelu_poly(hacc[j][2 * i + 1] + by));
        }
      }
    } else {
      const int k0 = (s - STEPS1) * KS2;  // Hs columns of this slice; written at step 7, ordered by the barrier above
      uint32_t a[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) ldsm_x4(a[i], Hs + (r2 + 16 * i + (lane & 15)) * H_LD + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < T::NT / 2; ++np) {
        uint32_t bb[4];
        ldsm_x4_t(bb, st + ((lane & 7) + (((lane >> 3) & 1) << 3)) * W2_LD + c2 + 16 * np + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          mma16816(acc[i][2 * np], a[i], bb[0], bb[1]);
          mma16816(acc[i][2 * np + 1], a[i], bb[2], bb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: v = acc + x + b2; fragment [i][j][2h + e] holds row r2 + 16i + g + 8h,
  // column c2 + 8j + 2 tig + e
  float* red_sum = red;
  float* red_sq = red + T::CG * R;
  float part[T::MT][2];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r2 + 16 * i + g + 8 * hh;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int col = c2 + 8 * j + 2 * tig;
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(Xs + row * X_LD + col);
        acc[i][j][2 * hh] += __low2float(xv) + b2[col];
        acc[i][j][2 * hh + 1] += __high2float(xv) + b2[col + 1];
        sum += acc[i][j][2 * hh] + acc[i][j][2 * hh + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      part[i][hh] = sum;
    }
  if (tig == 0)
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) red_sum[cg * R + r2 + 16 * i + g + 8 * hh] = part[i][hh];
  __syncthreads();
  float mean[T::MT][2];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r2 + 16 * i + g + 8 * hh;
      float sum = 0.0f;
      for (int w = 0; w < T::CG; ++w) sum += red_sum[w * R + row];
      mean[i][hh] = sum * (1.0f / HID);
      float sq = 0.0f;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const float d0 = acc[i][j][2 * hh] - mean[i][hh], d1 = acc[i][j][2 * hh + 1] - mean[i][hh];
        sq += d0 * d0 + d1 * d1;
      }
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      part[i][hh] = sq;
    }
  if (tig == 0)
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) red_sq[cg * R + r2 + 16 * i + g + 8 * hh] = part[i][hh];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r2 + 16 * i + g + 8 * hh;
      float sq = 0.0f;
      for (int w = 0; w < T::CG; ++w) sq += red_sq[w * R + row];
      const float rstd = rsqrtf(sq * (1.0f / HID) + eps);
      if (m0 + row >= M) continue;
      bf16* orow = out + (size_t)(m0 + row) * HID;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int col = c2 + 8 * j + 2 * tig;
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16((acc[i][j][2 * hh] - mean[i][hh]) * rstd * gamma[col] + beta[col],
                      (acc[i][j][2 * hh + 1] - mean[i][hh]) * rstd * gamma[col + 1] + beta[col + 1]);
      }
    }
}

template <int R>
cudaError_t launch(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2, const float* g,
                   const float* be, bf16* out, int M, int FF, float eps, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<R>();
  cudaError_t err = cudaFuncSetAttribute(mlp_rows_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mlp_rows_kernel<R><<<(M + R - 1) / R, Tiling<R>::THREADS, smem, stream>>>(x, w1, b1, w2, b2, g, be, out, M, FF, eps);
  return cudaGetLastError();
}

}  // namespace probe_mlp
}  // namespace mm

using namespace mm::probe_mlp;

extern "C" {

// out (M, 768) bf16 = LN(x + gelu(x.w1 + b1).w2 + b2) over rows x (M, 768)
// bf16; w1 (768, FF), w2 (FF, 768) bf16; b1 (FF), b2, gamma, beta (768) f32;
// all contiguous; FF % 128 == 0; row tile R = 16, 32 or 64.
int mm_probe_mlp_rows(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, const void* g,
                      const void* be, void* out, int M, int FF, float eps, int R, void* stream) {
  if (M < 0 || FF < FC || FF % FC) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  auto* xx = static_cast<const bf16*>(x);
  auto* w1p = static_cast<const bf16*>(w1);
  auto* w2p = static_cast<const bf16*>(w2);
  auto* b1p = static_cast<const float*>(b1);
  auto* b2p = static_cast<const float*>(b2);
  auto* gp = static_cast<const float*>(g);
  auto* bep = static_cast<const float*>(be);
  auto* o = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 16: return static_cast<int>(launch<16>(xx, w1p, b1p, w2p, b2p, gp, bep, o, M, FF, eps, s));
    case 32: return static_cast<int>(launch<32>(xx, w1p, b1p, w2p, b2p, gp, bep, o, M, FF, eps, s));
    case 64: return static_cast<int>(launch<64>(xx, w1p, b1p, w2p, b2p, gp, bep, o, M, FF, eps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
