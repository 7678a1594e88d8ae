// The attention inner-loop probe, written for Hopper.
//
// Replaces the Pallas kernels of benchmarks/attn_inner_probe.py:
//   K15 k_batched (and its variants k_unrolled, k_allheads, k_blockdiag,
//       which compute the same function) -> attn_inner_kernel
// For each head h of pre-projected q, k, v (B, L, H*64) bf16 and a key mask
// (B, L) f32: s = q_h.k_h^T * scale + (m - 1) * 1e9, p = softmax(s) over the
// keys, o_h = p.v_h with f32 sums, written bf16 in the input layout. Three
// variants: BF16_P rounds p to bf16 before P.V (k_batched, as K13);
// F32_P keeps p f32 (keep_f32_p, as K1's core), entering P.V as a bf16
// hi + lo pair (p = hi + lo to 16 mantissa bits, two products); STUB
// replaces the softmax with p = s * 0.005 (stub_softmax: wrong math on
// purpose, to attribute time) and ignores the mask, as the TPU probe does.
//
// What bounds it on the card: 4*B*L^2*64*H flops against 4*B*L*H*64*2
// bytes (q, k, v in, o out); at the probe's (256, 200) the bytes bound it
// (0.094 ms at 3.35 TB/s against 0.032 ms of bf16 tensor-core work).
//
// Design: one block of 4 warps per (64-query tile, head, example), 16 query
// rows a warp; both products on the tensor cores (mma.sync m16n8k16 bf16 ->
// f32, operands through ldmatrix). Pass 1 streams 64-key tiles of K through
// a double cp.async buffer and writes each warp's scaled S rows into shared
// memory (the whole padded row, L <= 512: 132 KB at L = 512); pass 2 is the
// softmax of each warp's own rows in shared memory (mask added, max, exp,
// sum, normalise), so only __syncwarp orders it; pass 3 streams V tiles the
// same way and builds P's A fragments from the f32 rows. Padded keys (past
// L, up to a multiple of 64) take p = 0, so no (B, L, L) tensor reaches
// device memory. It does not share attention_core_kernel (K1, K13, K10;
// encoder_kernels.cu), which keeps each 64-key tile's scores in registers
// over two passes instead of whole rows in shared memory; the two are timed
// side by side.
#include "mma_sync.cuh"

#include <cuda_runtime.h>
#include <math.h>

namespace mm {
namespace probe_attn {

using bf16 = __nv_bfloat16;

enum Variant : int { BF16_P = 0, F32_P = 1, STUB = 2 };

constexpr int HD = 64;            // head width
constexpr int QT = 64;            // query rows a block
constexpr int KT = 64;            // keys a tile
constexpr int THREADS = 128;      // 4 warps x 16 query rows
constexpr int T_LD = HD + 8;      // bf16 tile rows of 144 bytes: ldmatrix rows on distinct banks
constexpr int TILE = QT * T_LD;
constexpr int MAX_LEN = 512;

__host__ __device__ inline int keys_padded(int L) { return (L + KT - 1) / KT * KT; }
// f32 S rows: a stride of 8 mod 32 words keeps the fragments' float2
// accesses of a half-warp on distinct banks
__host__ __device__ inline int s_ld(int L) { return keys_padded(L) + 8; }
inline size_t smem_bytes(int L) {
  return (size_t)3 * TILE * sizeof(bf16) + ((size_t)QT * s_ld(L) + keys_padded(L)) * sizeof(float);
}

// rows [r0, r0 + 64) of one head's 64 columns (column col0 of rows of width
// row_w) into a [64][T_LD] tile; rows past L read as zero
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* base, int row_w, int col0, int r0, int L) {
  for (int c = threadIdx.x; c < KT * HD / 8; c += THREADS) {
    const int row = c >> 3, col = (c & 7) * 8;
    const bool ok = r0 + row < L;
    cp_async16(dst + row * T_LD + col, base + (size_t)(ok ? r0 + row : 0) * row_w + col0 + col, ok);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a pair of f32 as bf16 hi and the bf16 rounding of what hi leaves
__device__ __forceinline__ void split_bf16(float2 p, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p.x, p.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p.x - __low2float(h), p.y - __high2float(h));
}

template <int VAR>
__global__ void __launch_bounds__(THREADS) attn_inner_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                                             const bf16* __restrict__ v,
                                                             const float* __restrict__ mask, bf16* __restrict__ out,
                                                             int L, int H, float scale) {
  extern __shared__ __align__(128) char smem[];
  const int LKP = keys_padded(L), SLD = s_ld(L), tiles = LKP / KT;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Tb = Qs + TILE;  // two K, later V, tiles
  float* S = reinterpret_cast<float*>(Tb + 2 * TILE);
  float* negk = S + QT * SLD;

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int HID = H * HD, col0 = h * HD;
  const size_t ex = (size_t)b * L * HID;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r_lo = warp * 16 + (lane >> 2);  // this lane's fragment rows: r_lo and r_lo + 8

  for (int j = tid; j < LKP; j += THREADS) negk[j] = j < L ? (mask[(size_t)b * L + j] - 1.0f) * 1e9f : -INFINITY;
  stage_tile(Qs, q + ex, HID, col0, q0, L);
  stage_tile(Tb, k + ex, HID, col0, 0, L);
  cp_async_commit();

  // pass 1: S = Q K^T * scale, one 16 x 64 block of a warp's rows per tile
  uint32_t fq[4][4];
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage_tile(Tb + ((t + 1) & 1) * TILE, k + ex, HID, col0, (t + 1) * KT, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0)
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) ldsm_x4(fq[kb], Qs + (warp * 16 + (lane & 15)) * T_LD + kb * 16 + (lane >> 4) * 8);
    const bf16* kt = Tb + (t & 1) * TILE;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, kt + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * T_LD + kb * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], fq[kb], bb[0], bb[1]);
        mma16816(s[2 * np + 1], fq[kb], bb[2], bb[3]);
      }
    // fragment [j][2i + e] holds row r_lo + 8i, key 8j + 2(lane%4) + e of the tile
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(S + (r_lo + 8 * i) * SLD + t * KT + 8 * j + 2 * (lane & 3)) =
            make_float2(s[j][2 * i] * scale, s[j][2 * i + 1] * scale);
    __syncthreads();  // the buffer is refilled two tiles on
  }
  stage_tile(Tb, v + ex, HID, col0, 0, L);  // V's first tile comes in under the softmax
  cp_async_commit();

  // pass 2: the softmax of the warp's own 16 rows
  for (int rr = 0; rr < 16; ++rr) {
    float* sr = S + (warp * 16 + rr) * SLD;
    if (VAR == STUB) {
      for (int j = lane; j < LKP; j += 32) sr[j] = j < L ? sr[j] * 0.005f : 0.0f;
    } else {
      float mx = -INFINITY;
      for (int j = lane; j < LKP; j += 32) mx = fmaxf(mx, sr[j] + negk[j]);
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int j = lane; j < LKP; j += 32) {
        const float e = __expf(sr[j] + negk[j] - mx);  // padded keys: exp(-inf) = 0
        sr[j] = e;
        sum += e;
      }
      const float inv = 1.0f / warp_sum(sum);
      for (int j = lane; j < LKP; j += 32) sr[j] *= inv;
    }
  }
  __syncwarp();

  // pass 3: O = P V over the V tiles, P's A fragments from the f32 rows
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage_tile(Tb + ((t + 1) & 1) * TILE, v + ex, HID, col0, (t + 1) * KT, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* vt = Tb + (t & 1) * TILE;
    uint32_t pa[4][4], pl[4][4];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      // a0: (row r_lo, keys c, c+1), a1: row r_lo + 8, a2/a3: keys c + 8, c + 9
      const int c = t * KT + 16 * kb + 2 * (lane & 3);
      const float2 p[4] = {*reinterpret_cast<const float2*>(S + r_lo * SLD + c),
                           *reinterpret_cast<const float2*>(S + (r_lo + 8) * SLD + c),
                           *reinterpret_cast<const float2*>(S + r_lo * SLD + c + 8),
                           *reinterpret_cast<const float2*>(S + (r_lo + 8) * SLD + c + 8)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (VAR == F32_P)
          split_bf16(p[e], pa[kb][e], pl[kb][e]);
        else
          pa[kb][e] = pack_bf16(p[e].x, p[e].y);
      }
    }
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vt + (16 * kb + (lane & 7) + (((lane >> 3) & 1) << 3)) * T_LD + 16 * np + (lane >> 4) * 8);
        mma16816(o[2 * np], pa[kb], bb[0], bb[1]);
        mma16816(o[2 * np + 1], pa[kb], bb[2], bb[3]);
        if (VAR == F32_P) {
          mma16816(o[2 * np], pl[kb], bb[0], bb[1]);
          mma16816(o[2 * np + 1], pl[kb], bb[2], bb[3]);
        }
      }
    __syncthreads();
  }
  // fragment [j][2i + e] holds row r_lo + 8i, column 8j + 2(lane%4) + e
  bf16* ob = out + ex + col0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_lo + 8 * i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row * HID + 8 * j + 2 * (lane & 3)) = pack_bf16(o[j][2 * i], o[j][2 * i + 1]);
  }
}

template <int VAR>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const float* mask, bf16* out, int B, int L, int H,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(attn_inner_kernel<VAR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + QT - 1) / QT, H, B);
  attn_inner_kernel<VAR><<<grid, THREADS, smem, stream>>>(q, k, v, mask, out, L, H, scale);
  return cudaGetLastError();
}

}  // namespace probe_attn
}  // namespace mm

using namespace mm::probe_attn;

extern "C" {

// out (B, L, H*64) bf16 = the attention inner loop of q, k, v (B, L, H*64)
// bf16 and mask (B, L) f32, all contiguous; 1 <= L <= 512; variant 0
// (bf16 P), 1 (f32 P as hi + lo) or 2 (softmax stub).
int mm_probe_attn_inner(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int L, int H,
                        float scale, int variant, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > MAX_LEN) return static_cast<int>(cudaErrorInvalidValue);
  auto* qq = static_cast<const bf16*>(q);
  auto* kk = static_cast<const bf16*>(k);
  auto* vv = static_cast<const bf16*>(v);
  auto* m = static_cast<const float*>(mask);
  auto* o = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case BF16_P: return static_cast<int>(launch<BF16_P>(qq, kk, vv, m, o, B, L, H, scale, s));
    case F32_P: return static_cast<int>(launch<F32_P>(qq, kk, vv, m, o, B, L, H, scale, s));
    case STUB: return static_cast<int>(launch<STUB>(qq, kk, vv, m, o, B, L, H, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
