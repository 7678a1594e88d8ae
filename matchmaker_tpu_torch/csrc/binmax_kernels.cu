// The binmax MIPS scan, written for Hopper.
//
// Replaces the Pallas kernels of matchmaker_tpu/ops/mips_binmax.py:
//   K3 _binmax_kernel + _topk_per_bin_t   -> binmax_kernel<P, SCAN_BF16>
//   K8 _binmax_kernel_int8f (int8 corpus, bf16 queries)
//                                         -> binmax_kernel<P, SCAN_INT8F>
//   K7 _binmax_kernel_int8 (int8 corpus, int8 queries)
//                                         -> binmax_kernel<P, SCAN_INT8>
//   K5 _transpose_kernel                  -> folded into binmax_kernel's store
//   K4 _make_level2_kernel (level 2)      -> level2_kernel
//   K6 _unpack_kernel                     -> unpack_kernel
//
// binmax_kernel: one block scores one 128-row corpus bin against 128 queries
// on the tensor cores (bf16 in, f32 out), keeps the 128x128 score tile in
// shared memory, masks rows >= n_valid to -inf, and each of 128 threads keeps
// its query's top `per_bin` rows of the bin (ties to the lowest row offset,
// the TPU kernel's first-argmax rule), packing the 7-bit offset into the low
// mantissa bits of finite scores. It stores straight into the (Q, C) layout
// the TPU path only reaches after its transpose pass: column =
// tile*(per_bin*nb) + rank*nb + bin, nb = tile_rows/128.
//
// The int8 modes score the same way before the same selection: K8 turns the
// int8 codes into bf16 (exact) on their way to shared memory and multiplies
// the bf16 product by the bin's scale; K7 multiplies int8 codes by int8
// query codes into int32 (exact), then f32(raw) * bin scale * query scale,
// in that order and rounded at each step, as the TPU kernel does.
//
// What bounds it on the card: the corpus read (N*D*2 bytes per 128 queries,
// N*D for int8) against 2*N*D operations per query — at Q = 256 the scan is
// compute bound on the tensor cores (bf16 rate for K3/K8, int8 rate for K7),
// and the selection (128 shared-memory reads per thread and rank) is a small
// fraction of it. The per-bin candidates are 1/16..1/64 of the scores, so
// the (Q, N) score matrix never reaches device memory.
#include "tile_mma.cuh"

#include <math.h>

namespace mm {

constexpr int BIN = 128;
constexpr int S_LD = TILE_N + 4;  // score tile row stride (floats)
constexpr int BINMAX_RING = TILE_SMEM_BYTES > S8_SMEM_BYTES ? TILE_SMEM_BYTES : S8_SMEM_BYTES;
constexpr int BINMAX_SMEM = BINMAX_RING > TILE_M * S_LD * 4 ? BINMAX_RING : TILE_M * S_LD * 4;
constexpr int L2_BLOCK = 1024;  // level-2 column block (matchmaker_tpu _L2_BLOCK)
constexpr int L2_KEEP = 8;      // candidates kept per level-2 group (LEVEL2_PER_BIN)

// offset into mantissa bits [shift, shift+7) of a finite f32 (_pack_lane)
__device__ __forceinline__ float pack_lane(float v, int lane, int shift) {
  if (!isfinite(v)) return v;
  const int bits = (__float_as_int(v) & ~(127 << shift)) | (lane << shift);
  return __int_as_float(bits);
}

// keep the P largest (value desc, offset asc among equal values): offsets
// arrive in ascending order and a newcomer only passes strictly smaller
// values, which is repeated first-argmax selection
template <int P>
__device__ __forceinline__ void insert_top(float (&tv)[P], int (&ti)[P], float v, int idx) {
  if (v > tv[P - 1]) {
    tv[P - 1] = v;
    ti[P - 1] = idx;
#pragma unroll
    for (int j = P - 1; j > 0; --j) {
      if (tv[j] > tv[j - 1]) {
        const float fv = tv[j];
        tv[j] = tv[j - 1];
        tv[j - 1] = fv;
        const int fi = ti[j];
        ti[j] = ti[j - 1];
        ti[j - 1] = fi;
      }
    }
  }
}

enum ScanMode : int { SCAN_BF16 = 0, SCAN_INT8F = 1, SCAN_INT8 = 2 };

// grid (NR/128 bins, ceil(NQ/128) query tiles). queries: (NQ, D) bf16
// (SCAN_BF16, SCAN_INT8F) or int8 (SCAN_INT8); corpus: (NR, D) bf16
// (SCAN_BF16) or int8; bin_scales (NR/128) f32 and query_scales (NQ) f32 for
// the int8 modes that read them.
template <int P, int MODE>
__global__ void __launch_bounds__(TILE_THREADS) binmax_kernel(const void* __restrict__ queries,
                                                               const void* __restrict__ corpus,
                                                               const float* __restrict__ bin_scales,
                                                               const float* __restrict__ query_scales,
                                                               float* __restrict__ out, int NQ, int NR, int D,
                                                               int n_valid, int nb, long long ld_out) {
  extern __shared__ __align__(128) char smem[];
  const int m0 = blockIdx.x * BIN, n0 = blockIdx.y * TILE_N;
  float* S = reinterpret_cast<float*>(smem);  // [128 rows][S_LD], rows = corpus, columns = queries
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  if constexpr (MODE == SCAN_INT8) {
    FragCi acc[FRAG_M][FRAG_N];
    tile_mma_s8(static_cast<const int8_t*>(corpus), NR, D, static_cast<const int8_t*>(queries), NQ, 0, D,
                m0, n0, smem, acc);
    int* Si = reinterpret_cast<int*>(smem);  // the same cells, read as int32 below
#pragma unroll
    for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
      for (int j = 0; j < FRAG_N; ++j)
        wmma::store_matrix_sync(Si + (wm * WARP_M + i * 16) * S_LD + wn * WARP_N + j * 16, acc[i][j], S_LD,
                                wmma::mem_row_major);
  } else {
    FragC acc[FRAG_M][FRAG_N];
    if constexpr (MODE == SCAN_INT8F)
      tile_mma<int8_t>(static_cast<const int8_t*>(corpus), NR, static_cast<const bf16*>(queries), NQ, D, m0, n0,
                       smem, acc);
    else
      tile_mma(static_cast<const bf16*>(corpus), NR, static_cast<const bf16*>(queries), NQ, D, m0, n0, smem, acc);
#pragma unroll
    for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
      for (int j = 0; j < FRAG_N; ++j)
        wmma::store_matrix_sync(S + (wm * WARP_M + i * 16) * S_LD + wn * WARP_N + j * 16, acc[i][j], S_LD,
                                wmma::mem_row_major);
  }
  __syncthreads();

  const int q = threadIdx.x;
  if (q >= TILE_N || n0 + q >= NQ) return;
  const float cs = MODE == SCAN_BF16 ? 1.0f : bin_scales[blockIdx.x];
  const float qs = MODE == SCAN_INT8 ? query_scales[n0 + q] : 1.0f;
  float tv[P];
  int ti[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    tv[j] = -INFINITY;
    ti[j] = 0;
  }
  for (int r = 0; r < BIN; ++r) {
    float v;
    if constexpr (MODE == SCAN_INT8)
      v = __fmul_rn(__fmul_rn(static_cast<float>(reinterpret_cast<const int*>(S)[r * S_LD + q]), cs), qs);
    else if constexpr (MODE == SCAN_INT8F)
      v = __fmul_rn(S[r * S_LD + q], cs);
    else
      v = S[r * S_LD + q];
    insert_top<P>(tv, ti, m0 + r < n_valid ? v : -INFINITY, r);
  }
  const int tile = blockIdx.x / nb, bin = blockIdx.x % nb;
  float* o = out + (size_t)(n0 + q) * ld_out + (size_t)tile * P * nb + bin;
#pragma unroll
  for (int j = 0; j < P; ++j) o[(size_t)j * nb] = pack_lane(tv[j], ti[j], 0);
}

// Level 2 over (NQ, C_pad) level-1 candidates: every `w` consecutive columns
// keep their top 8, offset packed at bits [7, 14), written rank-major within
// each 1024-column block (the layout of matchmaker_tpu _level2_reduce).
__global__ void __launch_bounds__(256) level2_kernel(const float* __restrict__ in, float* __restrict__ out,
                                                      int NQ, int groups, int w, long long ld_in,
                                                      long long ld_out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)NQ * groups) return;
  const int q = (int)(t / groups), g = (int)(t % groups);
  const int nb2 = L2_BLOCK / w, blk = g / nb2, grp = g % nb2;
  const float* src = in + (size_t)q * ld_in + (size_t)g * w;
  float tv[L2_KEEP];
  int ti[L2_KEEP];
#pragma unroll
  for (int j = 0; j < L2_KEEP; ++j) {
    tv[j] = -INFINITY;
    ti[j] = 0;
  }
  for (int j = 0; j < w; ++j) insert_top<L2_KEEP>(tv, ti, src[j], j);
  float* dst = out + (size_t)q * ld_out + (size_t)blk * nb2 * L2_KEEP + grp;
#pragma unroll
  for (int r = 0; r < L2_KEEP; ++r) dst[(size_t)r * nb2] = pack_lane(tv[r], ti[r], 7);
}

// (value, corpus row id) of selected packed candidates (unpack_candidates)
__global__ void __launch_bounds__(256) unpack_kernel(const float* __restrict__ vals, const long long* __restrict__ pos,
                                                     float* __restrict__ out_vals, long long* __restrict__ out_ids,
                                                     long long n, int tile_rows, int per_bin, int level2) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = vals[i];
  const long long p = pos[i];
  const int bits = __float_as_int(v);
  const bool finite = isfinite(v);
  const int clear = level2 ? (127 | (127 << 7)) : 127;
  out_vals[i] = finite ? __int_as_float(bits & ~clear) : v;
  long long rc = p;
  if (level2) {
    const int nb2 = L2_BLOCK / level2;
    const long long blk = p / (nb2 * L2_KEEP), bin2 = p % nb2;
    rc = blk * L2_BLOCK + bin2 * level2 + ((bits >> 7) & 127);
  }
  const int nb = tile_rows / BIN;
  const long long tile = rc / ((long long)per_bin * nb), bin = rc % nb;
  out_ids[i] = finite ? tile * tile_rows + bin * BIN + (bits & 127) : -1;
}

template <int P, int MODE>
int launch_binmax(const void* q, const void* c, const float* bs, const float* qs, float* out, int NQ, int NR, int D,
                  int n_valid, int nb, long long ld_out, cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(binmax_kernel<P, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, BINMAX_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(NR / BIN, (NQ + TILE_N - 1) / TILE_N);
  binmax_kernel<P, MODE><<<grid, TILE_THREADS, BINMAX_SMEM, s>>>(q, c, bs, qs, out, NQ, NR, D, n_valid, nb, ld_out);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_binmax_mode(const void* q, const void* c, const float* bs, const float* qs, float* out, int NQ, int NR,
                       int D, int n_valid, int per_bin, int nb, long long ld_out, cudaStream_t s) {
  switch (per_bin) {
    case 1: return launch_binmax<1, MODE>(q, c, bs, qs, out, NQ, NR, D, n_valid, nb, ld_out, s);
    case 2: return launch_binmax<2, MODE>(q, c, bs, qs, out, NQ, NR, D, n_valid, nb, ld_out, s);
    case 4: return launch_binmax<4, MODE>(q, c, bs, qs, out, NQ, NR, D, n_valid, nb, ld_out, s);
    case 8: return launch_binmax<8, MODE>(q, c, bs, qs, out, NQ, NR, D, n_valid, nb, ld_out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mm

using namespace mm;

extern "C" {

// out (NQ, ld_out) f32: level-1 packed candidates of corpus (NR, D) bf16 for
// queries (NQ, D) bf16; NR % 128 == 0, per_bin in {1, 2, 4, 8}.
int mm_binmax_scan(const void* queries, const void* corpus, void* out, int NQ, int NR, int D, int n_valid,
                   int per_bin, int nb, long long ld_out, void* stream) {
  return launch_binmax_mode<SCAN_BF16>(queries, corpus, nullptr, nullptr, static_cast<float*>(out), NQ, NR, D,
                                       n_valid, per_bin, nb, ld_out, static_cast<cudaStream_t>(stream));
}

// The same over an int8 corpus (NR, D) with bin scales (NR/128) f32: mixed = 1
// takes bf16 queries (K8); mixed = 0 takes int8 query codes with their
// scales (NQ) f32 (K7).
int mm_binmax_scan_int8(const void* queries, const void* corpus, const void* bin_scales, const void* query_scales,
                        void* out, int NQ, int NR, int D, int n_valid, int per_bin, int nb, long long ld_out,
                        int mixed, void* stream) {
  const float* bs = static_cast<const float*>(bin_scales);
  const float* qs = static_cast<const float*>(query_scales);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mixed)
    return launch_binmax_mode<SCAN_INT8F>(queries, corpus, bs, qs, o, NQ, NR, D, n_valid, per_bin, nb, ld_out, s);
  if (D % S8_TILE_K) return static_cast<int>(cudaErrorInvalidValue);
  return launch_binmax_mode<SCAN_INT8>(queries, corpus, bs, qs, o, NQ, NR, D, n_valid, per_bin, nb, ld_out, s);
}

// out (NQ, ld_out) f32: level-2 reduction of in (NQ, ld_in) over c_pad
// columns (c_pad % 1024 == 0), groups of `width` in {32, 128}.
int mm_level2(const void* in, void* out, int NQ, int c_pad, int width, long long ld_in, long long ld_out,
              void* stream) {
  const int groups = c_pad / width;
  const long long total = (long long)NQ * groups;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  level2_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), NQ, groups, width, ld_in, ld_out);
  return static_cast<int>(cudaGetLastError());
}

// vals/pos: n selected candidates (f32, int64 columns) -> values, int64 corpus rows
int mm_unpack(const void* vals, const void* pos, void* out_vals, void* out_ids, long long n, int tile_rows,
              int per_bin, int level2, void* stream) {
  const unsigned blocks = (unsigned)((n + 255) / 256);
  unpack_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const long long*>(pos), static_cast<float*>(out_vals),
      static_cast<long long*>(out_ids), n, tile_rows, per_bin, level2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
