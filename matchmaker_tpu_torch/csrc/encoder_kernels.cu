// The encoder's fused layer halves, written for Hopper.
//
// Replaces the Pallas kernels of matchmaker_tpu/ops/fused_attention.py:
//   K1 _block_kernel (attention half): LN(x + Wo.MHA(xWq+bq, xWk+bk, xWv+bv) + bo)
//   K2 _mlp_kernel   (MLP half):       LN(x + gelu(xW1+b1)W2 + b2)
//   K13 _attn_kernel (fused_mha, standalone multi-head attention over separate
//                     Q, K, V): mm_fused_mha, the attention core below
// The function computed is the same; the fusion boundaries are not. Each
// half runs as a few launches:
//   K1: mm_wg_gemm_fwd (QKV, bias, bf16 out) -> mm_attention_core ->
//       mm_wg_gemm_fwd (Wo, bias + residual, f32 out) -> mm_layernorm
//   K2: mm_wg_gemm_fwd (W1, bias + gelu poly, bf16 out) -> mm_wg_gemm_fwd
//       (W2, bias + residual, f32 out) -> mm_layernorm
//
// What bounds them on the card, and what the design does about it:
// - The four projections are compute bound (2*M*K*N flops on M = B*L >=
//   7680 rows against 1.2-4.7 MB of weights). They run on the persistent
//   TMA/mbarrier/wgmma GEMM of wgmma_gemm.cuh (128 x 128 tiles, one producer
//   and two consumer warpgroups) with the bias, gelu and residual in its
//   epilogue. The weights are stored (K, N) and read MN-major in place
//   (wgmma's transposed shared-memory form), so no call transposes them.
// - LayerNorm needs a whole 768-wide row, which one 128-wide output tile
//   never holds: it stays a launch of its own over the f32 pre-LN sums.
// - The attention core is bound by its bytes (Q, K, V in and the output
//   out: 0.06 ms at (256, 128) against 12.9 GFLOP of tensor-core work). It
//   keeps the (L, L) scores out of device memory and out of shared memory:
//   each warp holds its 16 query rows' scores for one 64-key tile in the
//   mma.sync accumulators and forms the probabilities there (see below).
// Unlike the TPU kernel, the (B*L, 3072) gelu output and the (B*L, 768) f32
// pre-LN sums do go through device memory; keeping them on chip is later work.
#include "mma_sync.cuh"
#include "wgmma_gemm.cuh"

#include <math.h>

namespace mm {

using bf16 = __nv_bfloat16;

// ---- attention core -------------------------------------------------------
// One block of 4 warps per (64-query tile, head, example), 16 query rows a
// warp. q, k and v are (B, L, *) bf16 with row stride ld and the head split
// read straight from their columns: for K1 and K10 the QKV product's output
// (B, L, 3*HID), ld = 3*HID; for K13 three separate (B, L, HID) tensors,
// ld = HID. out is (B, L, HID): bf16, or f32 for the int8 attention half
// (K10 re-quantizes the f32 output).
//
// Both products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// sums, operands through ldmatrix) over 64-key tiles of K and V streamed
// through a double cp.async buffer. Two passes over the keys keep the plain
// versions' rounding points:
//   pass 1: S = QK^T * scale + (m - 1) * 1e9 per tile, in registers; each
//           row's running max and sum of exp(s - max) (the sum rescaled
//           when the max grows);
//   pass 2: S again (the same instructions, the same bits), p = exp(s - max)
//           / sum normalised in registers, and O += P.V with P's A fragments
//           taken straight from the score accumulators.
// ROUND_P rounds the normalised p to bf16, as K13's TPU kernel does
// (p.astype(v.dtype)); otherwise (K1, K10) p stays f32 into P.V, entered as
// bf16 terms into one f32 accumulator: for K1 a hi + lo pair (hi = bf16(p),
// lo = bf16(p - hi): 16 significant bits, two products; its output is
// rounded to bf16), for K10 hi + mid + lo (all 24 bits, three products: its
// f32 output is re-quantized, and 16 bits of p flip a few int8 codes against
// the plain version's f32 p). Keys past L (up to a multiple of 64) take
// p = 0, key tiles past an example's last unmasked key are skipped; query
// rows past L are not stored. Shared memory (Q, two K and two V tiles, a
// window of the mask row) does not grow with L: the window holds NEG_KEYS
// keys, eight 64-key tiles, and is refilled from the mask row every eighth
// tile of a pass, between the barriers that already close and open a tile
// (at L <= 512 it holds the whole row, filled once).
// The head width HD is a template parameter, instanced for 16, 32, 64 and
// 128 (launch_attention_core): the QK^T reduction takes HD / 16 k-steps of
// 16, P.V HD / 8 n-tiles of 8, and the tiles' padded rows stay on distinct
// banks for ldmatrix at each width (rows of 48, 80, 144 and 272 bytes).
// Heads of 128 keep the same warp layout (16 query rows a warp, 64-key
// tiles) in attention_core_wide_kernel: its five tiles take 87 KB, past
// the 48 KB of static shared memory, so they come as dynamic shared
// memory, and Q's fragments and the output's sums (96 registers a thread
// at 128) leave the 128 registers of four blocks an SM behind: two blocks
// an SM, up to 255 registers a thread.
constexpr int QT = 64;          // query rows a block
constexpr int KT = 64;          // keys a tile
constexpr int ATT_THREADS = 128;
constexpr int NEG_KEYS = 512;       // the mask row's window in shared memory
constexpr int NEG_TILES = NEG_KEYS / KT;
template <int HD>
__host__ __device__ constexpr int t_ld() { return HD + 8; }  // padded bf16 tile rows: ldmatrix rows on distinct banks
template <int HD>
__host__ __device__ constexpr int tile_elems() { return KT * t_ld<HD>(); }

// rows [r0, r0 + 64) of one head's HD columns (rows ld apart) into a
// [64][HD + 8] tile; rows past L read as zero
template <int HD>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* base, int ld, int r0, int L) {
  constexpr int SHIFT = HD == 128 ? 4 : (HD == 64 ? 3 : (HD == 32 ? 2 : 1));  // log2 of the 16-byte pieces a row
  for (int c = threadIdx.x; c < (KT << SHIFT); c += ATT_THREADS) {
    const int row = c >> SHIFT, col = (c & ((1 << SHIFT) - 1)) * 8;
    const bool ok = r0 + row < L;
    cp_async16(dst + row * t_ld<HD>() + col, base + (size_t)(ok ? r0 + row : 0) * ld + col, ok);
  }
}

// s (16 query rows x 64 keys of the warp) = Q K^T * scale + neg, fragment
// [j][2i + e] at row lane/4 + 8i, key 8j + 2(lane%4) + e of the tile
template <int HD>
__device__ __forceinline__ void score_tile(float (&s)[8][4], const uint32_t (&fq)[HD / 16][4], const bf16* kt,
                                           const float* neg, float scale, int lane) {
  constexpr int LD = t_ld<HD>();
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
  for (int kb = 0; kb < HD / 16; ++kb)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bb[4];
      ldsm_x4(bb, kt + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * LD + kb * 16 + ((lane >> 3) & 1) * 8);
      mma16816(s[2 * np], fq[kb], bb[0], bb[1]);
      mma16816(s[2 * np + 1], fq[kb], bb[2], bb[3]);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 n = *reinterpret_cast<const float2*>(neg + 8 * j + 2 * (lane & 3));
    s[j][0] = s[j][0] * scale + n.x;
    s[j][1] = s[j][1] * scale + n.y;
    s[j][2] = s[j][2] * scale + n.x;
    s[j][3] = s[j][3] * scale + n.y;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// keys [k0, k0 + NEG_KEYS) of the additive mask row (keys from `end` on
// left as they are): (m - 1) * 1e9 as the plain version adds it, -inf past L
__device__ __forceinline__ void fill_neg(float* neg, const float* __restrict__ mrow, int k0, int end, int L) {
  for (int j = threadIdx.x; j < NEG_KEYS && k0 + j < end; j += ATT_THREADS)
    neg[j] = k0 + j < L ? (mrow[k0 + j] - 1.0f) * 1e9f : -INFINITY;
}

// The core of one block, on the shared-memory tiles its kernel gives it:
// Qs (one tile), Kb and Vb (two each), neg (NEG_KEYS), live (2 * warps).
template <typename OutT, bool ROUND_P, int HD>
__device__ __forceinline__ void attention_core(bf16* Qs, bf16* Kb, bf16* Vb, float* neg, int* live,
                                               const bf16* __restrict__ q_in, const bf16* __restrict__ k_in,
                                               const bf16* __restrict__ v_in, int ld, const float* __restrict__ mask,
                                               OutT* __restrict__ out, int L, int H, float scale) {
  constexpr int T_LD = t_ld<HD>(), TILE = tile_elems<HD>();

  // bf16 terms of p into P.V: the rounded p (K13); hi + lo, 16 significant
  // bits, under a bf16 output (K1); hi + mid + lo, all 24 of f32, under the
  // f32 output that K10 re-quantizes
  constexpr int P_TERMS = ROUND_P ? 1 : (sizeof(OutT) == 4 ? 3 : 2);
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int HID = H * HD;
  const size_t head = (size_t)b * L * ld + h * HD;
  const bf16 *qb = q_in + head, *kb = k_in + head, *vb = v_in + head;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // (m - 1) * 1e9 per key as the plain version adds it; -inf past L (p = 0).
  // Where some key has m = 1, a key with m = 0 takes exp(-1e9 + ...) = 0
  // exactly, so the tiles past the last key with m != 0 add nothing to either
  // pass and are skipped (the same values); without a key of m = 1 every tile
  // runs. The scan reads the whole row; the window takes its first NEG_KEYS.
  const float* mrow = mask + (size_t)b * L;
  int last = 0, one = 0;
  for (int j = tid; j < (L + KT - 1) / KT * KT; j += ATT_THREADS) {
    const float mj = j < L ? mrow[j] : 0.0f;
    if (j < NEG_KEYS) neg[j] = j < L ? (mj - 1.0f) * 1e9f : -INFINITY;
    if (mj != 0.0f) last = j + 1;
    one |= mj == 1.0f;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  one = __reduce_or_sync(0xffffffffu, one);
  if (lane == 0) {
    live[warp] = last;
    live[ATT_THREADS / 32 + warp] = one;
  }
  __syncthreads();
  int tiles = (L + KT - 1) / KT, end = 0, any_one = 0;
#pragma unroll
  for (int w = 0; w < ATT_THREADS / 32; ++w) {
    end = max(end, live[w]);
    any_one |= live[ATT_THREADS / 32 + w];
  }
  if (any_one) tiles = (end + KT - 1) / KT;
  stage_tile<HD>(Qs, qb, ld, q0, L);
  stage_tile<HD>(Kb, kb, ld, 0, L);
  cp_async_commit();

  // pass 1: each row's max and sum of exponentials. m is the same in the
  // four lanes of a quad (they hold one row); l is this lane's share of the
  // sum until the quad adds its shares after the last tile.
  uint32_t fq[HD / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  for (int t = 0; t < tiles; ++t) {
    // a new window: the last one's tiles were read before the last barrier
    if (t % NEG_TILES == 0 && t > 0) fill_neg(neg, mrow, t * KT, tiles * KT, L);
    if (t + 1 < tiles) {
      stage_tile<HD>(Kb + ((t + 1) & 1) * TILE, kb, ld, (t + 1) * KT, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0)
#pragma unroll
      for (int k = 0; k < HD / 16; ++k)
        ldsm_x4(fq[k], Qs + (warp * 16 + (lane & 15)) * T_LD + k * 16 + (lane >> 4) * 8);
    float s[8][4];
    score_tile<HD>(s, fq, Kb + (t & 1) * TILE, neg + t % NEG_TILES * KT, scale, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = quad_max(mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += expf(s[j][2 * i] - mx) + expf(s[j][2 * i + 1] - mx);
      l[i] = l[i] * expf(m[i] - mx) + sum;  // the first tile: 0 * exp(-inf) + sum
      m[i] = mx;
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }
  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) den[i] = quad_sum(l[i]);

  // pass 2: O = P V
  if (tiles > NEG_TILES) fill_neg(neg, mrow, 0, tiles * KT, L);
  stage_tile<HD>(Kb, kb, ld, 0, L);
  stage_tile<HD>(Vb, vb, ld, 0, L);
  cp_async_commit();
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    if (t % NEG_TILES == 0 && t > 0) fill_neg(neg, mrow, t * KT, tiles * KT, L);
    if (t + 1 < tiles) {
      stage_tile<HD>(Kb + ((t + 1) & 1) * TILE, kb, ld, (t + 1) * KT, L);
      stage_tile<HD>(Vb + ((t + 1) & 1) * TILE, vb, ld, (t + 1) * KT, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[8][4];
    score_tile<HD>(s, fq, Kb + (t & 1) * TILE, neg + t % NEG_TILES * KT, scale, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - m[e >> 1]) / den[e >> 1];
    const bf16* vt = Vb + (t & 1) * TILE;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // keys 16k .. 16k + 15: the score fragments of n-blocks 2k, 2k + 1 are
      // the A fragment of a 16 x 16 block of P, split into its bf16 terms
      uint32_t pt[P_TERMS][4];
      float2 r[4] = {make_float2(s[2 * k][0], s[2 * k][1]), make_float2(s[2 * k][2], s[2 * k][3]),
                     make_float2(s[2 * k + 1][0], s[2 * k + 1][1]), make_float2(s[2 * k + 1][2], s[2 * k + 1][3])};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int n = 0; n < P_TERMS; ++n) {
          const __nv_bfloat162 t = __floats2bfloat162_rn(r[e].x, r[e].y);
          pt[n][e] = *reinterpret_cast<const uint32_t*>(&t);
          r[e] = make_float2(r[e].x - __low2float(t), r[e].y - __high2float(t));  // exact
        }
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vt + (16 * k + (lane & 7) + (((lane >> 3) & 1) << 3)) * T_LD + 16 * np + (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < P_TERMS; ++n) {
          mma16816(o[2 * np], pt[n], bb[0], bb[1]);
          mma16816(o[2 * np + 1], pt[n], bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }

  // fragment [j][2i + e] holds row lane/4 + 8i, column 8j + 2(lane%4) + e
  const int r_lo = warp * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_lo + 8 * i;
    if (row >= L) continue;
    OutT* dst = out + ((size_t)b * L + row) * HID + h * HD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if constexpr (sizeof(OutT) == 4)
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[j][2 * i], o[j][2 * i + 1]);
      else
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(o[j][2 * i], o[j][2 * i + 1]);
    }
  }
}

// four blocks an SM: at most 48 KB of shared memory (at HD = 64) and 128
// registers a thread each
template <typename OutT, bool ROUND_P, int HD>
__global__ void __launch_bounds__(ATT_THREADS, 4)
    attention_core_kernel(const bf16* __restrict__ q_in, const bf16* __restrict__ k_in, const bf16* __restrict__ v_in,
                          int ld, const float* __restrict__ mask, OutT* __restrict__ out, int L, int H, float scale) {
  constexpr int TILE = tile_elems<HD>();
  __shared__ __align__(128) bf16 Qs[TILE];
  __shared__ __align__(128) bf16 Kb[2 * TILE];
  __shared__ __align__(128) bf16 Vb[2 * TILE];
  __shared__ float neg[NEG_KEYS];
  __shared__ int live[2 * ATT_THREADS / 32];
  attention_core<OutT, ROUND_P, HD>(Qs, Kb, Vb, neg, live, q_in, k_in, v_in, ld, mask, out, L, H, scale);
}

// heads of 128: the same core on dynamic shared memory, two blocks an SM
constexpr int WIDE_HD = 128;
constexpr size_t WIDE_SMEM = (size_t)5 * tile_elems<WIDE_HD>() * sizeof(bf16) + NEG_KEYS * sizeof(float) +
                             2 * ATT_THREADS / 32 * sizeof(int);

template <typename OutT, bool ROUND_P>
__global__ void __launch_bounds__(ATT_THREADS, 2)
    attention_core_wide_kernel(const bf16* __restrict__ q_in, const bf16* __restrict__ k_in,
                               const bf16* __restrict__ v_in, int ld, const float* __restrict__ mask,
                               OutT* __restrict__ out, int L, int H, float scale) {
  constexpr int TILE = tile_elems<WIDE_HD>();
  extern __shared__ __align__(128) char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Kb = Qs + TILE;
  bf16* Vb = Kb + 2 * TILE;
  float* neg = reinterpret_cast<float*>(Vb + 2 * TILE);
  int* live = reinterpret_cast<int*>(neg + NEG_KEYS);
  attention_core<OutT, ROUND_P, WIDE_HD>(Qs, Kb, Vb, neg, live, q_in, k_in, v_in, ld, mask, out, L, H, scale);
}

// ---- row LayerNorm ----------------------------------------------------------
// One warp per row of the f32 pre-LN sums; two-pass mean/variance as in the
// TPU kernel, eps inside the rsqrt, bf16 out. Rows of N columns, ld_in and
// ld_out apart (a width that is not a multiple of 8 runs its products at
// the next one: the padded columns are read past, and written as zeros up
// to ld_out).
__global__ void __launch_bounds__(256) layernorm_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                                                        const float* __restrict__ beta, bf16* __restrict__ out,
                                                        int M, int N, int ld_in, int ld_out, float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = x + (size_t)row * ld_in;
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
  bf16* orow = out + (size_t)row * ld_out;
  for (int j = lane; j < N; j += 32) orow[j] = __float2bfloat16((xr[j] - mean) * inv * gamma[j] + beta[j]);
  for (int j = N + lane; j < ld_out; j += 32) orow[j] = __float2bfloat16(0.0f);
}

template <typename OutT, bool ROUND_P>
int launch_attention_core(const bf16* q, const bf16* k, const bf16* v, int ld, const void* mask, void* out, int B,
                          int L, int H, int hd, float scale, void* stream) {
  if (B < 1 || H < 1 || L < 1 || B > 65535 || H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((L + QT - 1) / QT, H, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  OutT* o = static_cast<OutT*>(out);
  switch (hd) {
    case 16:
      attention_core_kernel<OutT, ROUND_P, 16><<<grid, ATT_THREADS, 0, s>>>(q, k, v, ld, m, o, L, H, scale);
      break;
    case 32:
      attention_core_kernel<OutT, ROUND_P, 32><<<grid, ATT_THREADS, 0, s>>>(q, k, v, ld, m, o, L, H, scale);
      break;
    case 64:
      attention_core_kernel<OutT, ROUND_P, 64><<<grid, ATT_THREADS, 0, s>>>(q, k, v, ld, m, o, L, H, scale);
      break;
    case WIDE_HD: {
      const cudaError_t err = cudaFuncSetAttribute(attention_core_wide_kernel<OutT, ROUND_P>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WIDE_SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
      attention_core_wide_kernel<OutT, ROUND_P><<<grid, ATT_THREADS, WIDE_SMEM, s>>>(q, k, v, ld, m, o, L, H, scale);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1's packed QKV product output (B, L, 3*HID): Q, K, V side by side in a row
template <typename OutT>
int launch_packed_attention_core(const void* qkv, const void* mask, void* out, int B, int L, int H, int hd,
                                 float scale, void* stream) {
  const bf16* p = static_cast<const bf16*>(qkv);
  const int hid = H * hd;
  return launch_attention_core<OutT, false>(p, p + hid, p + 2 * hid, 3 * hid, mask, out, B, L, H, hd, scale, stream);
}

}  // namespace mm

using namespace mm;

extern "C" {

const char* mm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// C = A.B + bias, then the epilogue (wgmma_gemm.cuh): A (M,K) bf16, B (K,N)
// bf16 (read MN-major), bias (N) f32; wg::EPI_BIAS_BF16 and
// EPI_BIAS_GELU_BF16 write C bf16, EPI_BIAS_RESID_F32 writes C f32 =
// (resid + bias) + A.B with resid (M,N) bf16. K and N multiples of 8.
int mm_wg_gemm_fwd(const void* A, const void* B, const void* bias, const void* resid, void* C, int M, int N, int K,
                   int epilogue, void* stream) {
  CUtensorMap ta, tb;
  if (!wg::make_map(&ta, A, K, M, false) || !wg::make_map(&tb, B, N, K, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const wg::Params p{M, N, K, (K + wg::BK - 1) / wg::BK, C, nullptr, static_cast<const float*>(bias),
                     static_cast<const bf16*>(resid)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case wg::EPI_BIAS_BF16:
      return static_cast<int>(wg::launch<false, true, false, wg::EPI_BIAS_BF16>(ta, tb, ta, tb, p, 1, s));
    case wg::EPI_BIAS_GELU_BF16:
      return static_cast<int>(wg::launch<false, true, false, wg::EPI_BIAS_GELU_BF16>(ta, tb, ta, tb, p, 1, s));
    case wg::EPI_BIAS_RESID_F32:
      return static_cast<int>(wg::launch<false, true, false, wg::EPI_BIAS_RESID_F32>(ta, tb, ta, tb, p, 1, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out (B,L,H*hd) bf16 = per-head softmax(QK^T*scale + mask) V from qkv
// (B,L,3*H*hd); head width hd 16, 32, 64 or 128.
int mm_attention_core(const void* qkv, const void* mask, void* out, int B, int L, int H, int hd, float scale,
                      void* stream) {
  return launch_packed_attention_core<bf16>(qkv, mask, out, B, L, H, hd, scale, stream);
}

// The same with out (B,L,H*hd) f32, P.V's f32 sums uncast (int8 attention half).
int mm_attention_core_f32(const void* qkv, const void* mask, void* out, int B, int L, int H, int hd, float scale,
                          void* stream) {
  return launch_packed_attention_core<float>(qkv, mask, out, B, L, H, hd, scale, stream);
}

// K13: out (B,L,H*hd) bf16 = per-head softmax(QK^T*scale + mask) V from
// separate q, k, v (B,L,H*hd) bf16, the probabilities rounded to bf16.
int mm_fused_mha(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int L, int H,
                 int hd, float scale, void* stream) {
  return launch_attention_core<bf16, true>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                           static_cast<const bf16*>(v), H * hd, mask, out, B, L, H, hd, scale,
                                           stream);
}

// out (M,N) bf16 = LayerNorm(x (M,N) f32) * gamma + beta; x's rows ld_in
// apart, out's ld_out apart (columns N .. ld_out - 1 written as zeros)
int mm_layernorm_ld(const void* x, const void* gamma, const void* beta, void* out, int M, int N, int ld_in,
                    int ld_out, float eps, void* stream) {
  if (N < 1 || ld_in < N || ld_out < N) return static_cast<int>(cudaErrorInvalidValue);
  layernorm_kernel<<<(M + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<bf16*>(out), M, N, ld_in, ld_out, eps);
  return static_cast<int>(cudaGetLastError());
}

// out (M,N) bf16 = LayerNorm(x (M,N) f32) * gamma + beta
int mm_layernorm(const void* x, const void* gamma, const void* beta, void* out, int M, int N, float eps,
                 void* stream) {
  return mm_layernorm_ld(x, gamma, beta, out, M, N, N, N, eps, stream);
}

}  // extern "C"
