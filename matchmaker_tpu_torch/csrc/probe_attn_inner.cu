// The attention inner-loop probe, written for Hopper.
//
// Replaces the Pallas kernels of benchmarks/attn_inner_probe.py:
//   K15 k_batched (and its variants k_unrolled, k_allheads, k_blockdiag,
//       which compute the same function) -> attn_inner_kernel
// For each head h of pre-projected q, k, v (B, L, H*64) bf16 and a key mask
// (B, L) f32: s = q_h.k_h^T * scale + (m - 1) * 1e9, p = softmax(s) over the
// keys, o_h = p.v_h with f32 sums, written bf16 in the input layout. Three
// variants: BF16_P rounds the normalised p to bf16 before P.V (k_batched,
// as K13); F32_P keeps p f32 (keep_f32_p, as K1's core), entering P.V as a
// bf16 hi + lo pair (p = hi + lo to 16 mantissa bits, two products); STUB
// replaces the softmax with p = s * 0.005 (stub_softmax: wrong math on
// purpose, to attribute time) and ignores the mask, as the TPU probe does.
//
// What bounds it on the card: 4*B*L^2*64*H flops against 4*B*L*H*64*2
// bytes (q, k, v in, o out); at the probe's (256, 200) the bytes bound it
// (0.094 ms at 3.35 TB/s against 0.032 ms of bf16 tensor-core work), so
// q, k and v are read once and nothing of the (L, L) scores leaves the
// registers.
//
// Design: one CTA of one warpgroup per (head, example), two CTAs an SM.
// Thread 0 issues every TMA load of the CTA at its start (K's and V's
// 64-key boxes, one mbarrier each for all of K and all of V, and each
// 64-query tile of Q with its own mbarrier), through 3-D tensor maps over
// (B, L, H*64) with boxes of 64 rows x 64 columns: a head's slice needs no
// copy, and rows past L are filled with zeros on loads and clipped on
// stores (never the next example's). The warpgroup then walks its query
// tiles: S = Q.K^T by wgmma m64n64k16 (both K-major, 128-byte swizzle),
// one accumulator of 32 f32 a thread for each 64-key chunk, the whole row
// (NC <= 4 chunks, L <= 256) in registers; the softmax in registers, a
// row's values on the quad of lanes holding it (scale, mask, max, exp2,
// sum, normalise, two xor shuffles each); p into bf16 A fragments in
// registers (the accumulator's layout is the register-A layout); O = P.V by
// register-A wgmma m64n64k16 against V in shared memory (V's rows are
// keys: B MN-major). The output tile goes through the Q tile's shared
// memory (its products are done) to a TMA store. Padding: keys past L (to
// a multiple of 64) take -inf and p = 0, and groups of 8 keys wholly past L
// skip the softmax arithmetic; warps whose 16 query rows all lie past L
// skip it too; the products run over whole 64-key chunks and query tiles.
//
// L in (256, 512]: a row no longer fits in registers. The keys run in two
// halves of four chunks. Pass 1 takes each half's row max m_h and sum
// l_h = sum exp(s - m_h) and combines them: m = max(m_0, m_1),
// l = l_0 exp(m_0 - m) + l_1 exp(m_1 - m). Pass 2 recomputes each half's S
// and feeds p = exp(s - m) / l to P.V. Every p is the one-pass form's
// exp(s - m) times 1/l; only l rounds otherwise (two rescaled partial sums),
// a relative difference of a few f32 ulps (tests/test_torch_probe_plans.py
// emulates this order against the plain version and the JAX probe).
#include "wgmma_gemm.cuh"

#include <cuda_runtime.h>
#include <math.h>

namespace mm {
namespace probe_attn {

using namespace wg;
using bf16 = __nv_bfloat16;

enum Variant : int { BF16_P = 0, F32_P = 1, STUB = 2 };

constexpr int HD = 64;             // head width
constexpr int THREADS = 128;       // one warpgroup: 64 query rows, 16 a warp
constexpr int BOX_BYTES = 64 * 128;  // 64 rows of 64 bf16
constexpr int MAX_LEN = 512;
constexpr int HALF_CHUNKS = 4;     // 64-key chunks a pass holds in registers
constexpr float LOG2E = 1.4426950408889634f;

// bytes of dynamic shared memory: Q tiles, K and V boxes (n_boxes each), the
// key mask as additive f32, the mbarriers (K, V, one per Q tile)
inline size_t smem_bytes(int L, int n_boxes) {
  const int tiles = (L + 63) / 64;
  return 1024 + (size_t)(tiles + 2 * n_boxes) * BOX_BYTES + (size_t)n_boxes * 64 * 4 + (size_t)(2 + tiles) * 8;
}

__device__ __forceinline__ void tma_load_3d(const CUtensorMap* map, void* dst, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S (64 query rows x NC chunks of 64 keys) = Q . K^T: chunk c at s[c], the
// wgmma accumulator layout (row 16 warp + lane/4 + 8i, key 64c + 8j +
// 2 (lane%4) + e at [c][4j + 2i + e])
template <int NC>
__device__ __forceinline__ void scores(float (&s)[NC][32], uint32_t q_tile, uint32_t k_boxes) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < HD / 16; ++k)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_m64n64_ss(s[c], make_desc<false>(q_tile + 32 * k), make_desc<false>(k_boxes + c * BOX_BYTES + 32 * k),
                      k > 0);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(s[c]);
}

// s * scale + the additive mask (keys past L: -inf), in place; returns
// nothing for groups of 8 keys wholly past L, which stay -inf
template <int NC>
__device__ __forceinline__ void scale_mask(float (&s)[NC][32], const float* negk, int key0, int L, float scale,
                                           int quad) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = key0 + 64 * c + 8 * j;
      if (key >= L) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][4 * j + e] = -INFINITY;
        continue;
      }
      const float2 nk = *reinterpret_cast<const float2*>(negk + key + 2 * quad);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s[c][4 * j + 2 * i] = s[c][4 * j + 2 * i] * scale + nk.x;
        s[c][4 * j + 2 * i + 1] = s[c][4 * j + 2 * i + 1] * scale + nk.y;
      }
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

// each of the thread's two rows' max over its masked scores (then the
// quad's); four running maxima a row, so the compares do not wait on each
// other
template <int NC>
__device__ __forceinline__ void row_max(const float (&s)[NC][32], float (&mx)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) m[j & 3] = fmaxf(m[j & 3], fmaxf(s[c][4 * j + 2 * i], s[c][4 * j + 2 * i + 1]));
    mx[i] = quad_max(fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3])));
  }
}

// s <- exp(s - mx) in place, keys past L (whole groups of 8) to 0 without
// the arithmetic; returns each row's sum over the quad (four running sums
// a row, added pairwise)
template <int NC>
__device__ __forceinline__ void exp_rows(float (&s)[NC][32], const float (&mx)[2], int key0, int L,
                                         float (&sum)[2]) {
  const float off[2] = {mx[0] * LOG2E, mx[1] * LOG2E};
  float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (key0 + 64 * c + 8 * j >= L) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][4 * j + e] = 0.0f;
        continue;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2_approx(fmaf(s[c][4 * j + 2 * i + e], LOG2E, -off[i]));
          s[c][4 * j + 2 * i + e] = p;
          acc[i][(j & 1) * 2 + e] += p;
        }
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) sum[i] = quad_sum((acc[i][0] + acc[i][1]) + (acc[i][2] + acc[i][3]));
}

// O (+)= P . V over the NC chunks: p = e * inv (the normalised
// probabilities; for the stub, e with inv = 1) into bf16 A fragments, then
// register-A wgmma against the V boxes from v_boxes on (16 keys a product);
// F32_P: p = hi + lo, two products a step. accumulate = 0: the first
// product overwrites o.
template <int VAR, int NC>
__device__ __forceinline__ void p_times_v(float (&o)[32], const float (&e)[NC][32], const float (&inv)[2],
                                          uint32_t v_boxes, int accumulate) {
  uint32_t hi[NC * 4][4], lo[VAR == F32_P ? NC * 4 : 1][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // keys 16 kk .. 16 kk + 15 of chunk c: accumulator columns j = 2 kk, 2 kk + 1
      const int j0 = 2 * kk, j1 = 2 * kk + 1;
      // a[0]: row i = 0 of column group j0, a[1]: row 1, a[2] and a[3]: j1
      const float x[4][2] = {{e[c][4 * j0] * inv[0], e[c][4 * j0 + 1] * inv[0]},
                             {e[c][4 * j0 + 2] * inv[1], e[c][4 * j0 + 3] * inv[1]},
                             {e[c][4 * j1] * inv[0], e[c][4 * j1 + 1] * inv[0]},
                             {e[c][4 * j1 + 2] * inv[1], e[c][4 * j1 + 3] * inv[1]}};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        hi[4 * c + kk][r] = pack2(x[r][0], x[r][1]);
        if constexpr (VAR == F32_P) {
          const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[4 * c + kk][r]);
          lo[4 * c + kk][r] = pack2(x[r][0] - __low2float(h), x[r][1] - __high2float(h));
        }
      }
    }
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < NC * 4; ++t) {
    const uint64_t dv = make_desc<true>(v_boxes + t * 16 * 128);
    wgmma_m64n64_rs_tb(o, hi[t], dv, t > 0 || accumulate);
    if constexpr (VAR == F32_P) wgmma_m64n64_rs_tb(o, lo[t], dv, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// NC chunks of keys in registers; HALVES = 2 runs L in (256, 512] as two
// halves of HALF_CHUNKS chunks
template <int VAR, int NC, int HALVES>
__global__ void __launch_bounds__(THREADS, 2)
    attn_inner_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                      const float* __restrict__ mask, int L, float scale) {
  constexpr int NB = NC * HALVES;  // K and V boxes of 64 keys
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tiles = (L + 63) / 64;
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + tiles * BOX_BYTES;
  uint8_t* Vs = Ks + NB * BOX_BYTES;
  float* negk = reinterpret_cast<float*>(Vs + NB * BOX_BYTES);
  uint64_t* bar = reinterpret_cast<uint64_t*>(negk + NB * 64);  // K, V, then one per Q tile
  const int h = blockIdx.x, b = blockIdx.y, col0 = h * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, quad = lane & 3;

  if (tid == 0) {
    for (int i = 0; i < 2 + tiles; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(&bar[0], NB * BOX_BYTES);
    for (int c = 0; c < NB; ++c) tma_load_3d(&tk, Ks + c * BOX_BYTES, &bar[0], col0, 64 * c, b);
    mbar_expect_tx(&bar[2], BOX_BYTES);
    tma_load_3d(&tq, Qs, &bar[2], col0, 0, b);
    mbar_expect_tx(&bar[1], NB * BOX_BYTES);
    for (int c = 0; c < NB; ++c) tma_load_3d(&tv, Vs + c * BOX_BYTES, &bar[1], col0, 64 * c, b);
    for (int t = 1; t < tiles; ++t) {
      mbar_expect_tx(&bar[2 + t], BOX_BYTES);
      tma_load_3d(&tq, Qs + t * BOX_BYTES, &bar[2 + t], col0, 64 * t, b);
    }
  }
  for (int j = tid; j < NB * 64; j += THREADS) negk[j] = j < L ? (mask[(size_t)b * L + j] - 1.0f) * 1e9f : -INFINITY;
  __syncthreads();

  const uint32_t k_boxes = smem_u32(Ks), v_boxes = smem_u32(Vs);
  mbar_wait(&bar[0], 0);
  for (int t = 0; t < tiles; ++t) {
    const bool live = 64 * t + 16 * warp < L;  // this warp holds a query row below L
    uint8_t* q_tile = Qs + t * BOX_BYTES;
    const uint32_t qa = smem_u32(q_tile);
    mbar_wait(&bar[2 + t], 0);
    float o[32];

    if constexpr (VAR == STUB) {
      const float one[2] = {1.0f, 1.0f};
#pragma unroll 1
      for (int half = 0; half < HALVES; ++half) {
        float s[NC][32];
        scores<NC>(s, qa, k_boxes + half * NC * BOX_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) s[c][i] = s[c][i] * scale * 0.005f;  // keys past L: zero rows of K
        if (t == 0 && half == 0) mbar_wait(&bar[1], 0);
        p_times_v<VAR, NC>(o, s, one, v_boxes + half * NC * BOX_BYTES, half);
      }
    } else if constexpr (HALVES == 1) {
      float s[NC][32], inv[2] = {0.0f, 0.0f};
      scores<NC>(s, qa, k_boxes);
      if (live) {
        float mx[2], sum[2];
        scale_mask<NC>(s, negk, 0, L, scale, quad);
        row_max<NC>(s, mx);
        exp_rows<NC>(s, mx, 0, L, sum);
        inv[0] = 1.0f / sum[0];
        inv[1] = 1.0f / sum[1];
      }  // else inv = 0: p = 0 for rows past L
      if (t == 0) mbar_wait(&bar[1], 0);
      p_times_v<VAR, NC>(o, s, inv, v_boxes, 0);
    } else {
      // pass 1: each half's max and sum, combined
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll 1
      for (int half = 0; half < HALVES; ++half) {
        float s[NC][32], mh[2], lh[2];
        scores<NC>(s, qa, k_boxes + half * NC * BOX_BYTES);
        if (live) {
          scale_mask<NC>(s, negk, half * NC * 64, L, scale, quad);
          row_max<NC>(s, mh);
          exp_rows<NC>(s, mh, half * NC * 64, L, lh);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float mn = fmaxf(m[i], mh[i]);
            // a half wholly past L has mh = -inf and lh = 0: it adds nothing
            const float a = m[i] == -INFINITY ? 0.0f : exp2_approx((m[i] - mn) * LOG2E);
            const float c = mh[i] == -INFINITY ? 0.0f : exp2_approx((mh[i] - mn) * LOG2E);
            l[i] = l[i] * a + lh[i] * c;
            m[i] = mn;
          }
        }
      }
      const float inv[2] = {live ? 1.0f / l[0] : 0.0f, live ? 1.0f / l[1] : 0.0f};
      // pass 2: S again, p = exp(s - m) / l, O += P.V
#pragma unroll 1
      for (int half = 0; half < HALVES; ++half) {
        float s[NC][32], sum[2];
        scores<NC>(s, qa, k_boxes + half * NC * BOX_BYTES);
        if (live) {
          scale_mask<NC>(s, negk, half * NC * 64, L, scale, quad);
          exp_rows<NC>(s, m, half * NC * 64, L, sum);
        }  // else inv = 0: p = 0 for rows past L
        if (t == 0 && half == 0) mbar_wait(&bar[1], 0);
        p_times_v<VAR, NC>(o, s, inv, v_boxes + half * NC * BOX_BYTES, half);
      }
    }

    // O (64 x 64) as bf16 into the Q tile's swizzled box, then one TMA store
    // (rows past L are clipped by the map)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * warp + (lane >> 2) + 8 * i;
        *reinterpret_cast<uint32_t*>(q_tile + row * 128 + ((j ^ (row & 7)) << 4) + 4 * quad) =
            pack2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
      }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      tma_store_3d(&to, q_tile, col0, 64 * t, b);
      tma_store_commit();
    }
  }
  if (tid == 0) tma_store_wait<0>();
}

// a (B, L, H*64) bf16 tensor as a 3-D map {H*64, L, B} with 64 x 64 boxes
inline bool make_head_map(CUtensorMap* map, const void* ptr, int B, int L, int H) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H * HD, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)H * HD * 2, (cuuint64_t)L * H * HD * 2};
  const cuuint32_t box[3] = {HD, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int VAR, int NC, int HALVES>
cudaError_t launch(const CUtensorMap* maps, const float* mask, int B, int L, int H, float scale,
                   cudaStream_t stream) {
  auto kernel = attn_inner_kernel<VAR, NC, HALVES>;
  const size_t smem = smem_bytes(L, NC * HALVES);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], mask, L, scale);
  return cudaGetLastError();
}

// the instance for L: NC = ceil(L / 64) chunks, or two halves of four past 256
template <int VAR>
cudaError_t launch_for(const CUtensorMap* maps, const float* mask, int B, int L, int H, float scale,
                       cudaStream_t stream) {
  switch ((L + 63) / 64) {
    case 1: return launch<VAR, 1, 1>(maps, mask, B, L, H, scale, stream);
    case 2: return launch<VAR, 2, 1>(maps, mask, B, L, H, scale, stream);
    case 3: return launch<VAR, 3, 1>(maps, mask, B, L, H, scale, stream);
    case 4: return launch<VAR, 4, 1>(maps, mask, B, L, H, scale, stream);
    default: return launch<VAR, HALF_CHUNKS, 2>(maps, mask, B, L, H, scale, stream);
  }
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
  CUtensorMap maps[4];
  if (!make_head_map(&maps[0], q, B, L, H) || !make_head_map(&maps[1], k, B, L, H) ||
      !make_head_map(&maps[2], v, B, L, H) || !make_head_map(&maps[3], out, B, L, H))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* m = static_cast<const float*>(mask);
  auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case BF16_P: return static_cast<int>(launch_for<BF16_P>(maps, m, B, L, H, scale, s));
    case F32_P: return static_cast<int>(launch_for<F32_P>(maps, m, B, L, H, scale, s));
    case STUB: return static_cast<int>(launch_for<STUB>(maps, m, B, L, H, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
