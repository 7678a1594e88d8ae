// ColBERT MaxSim, written for Hopper.
//
// Replaces the Pallas kernel of matchmaker_tpu/ops/pallas_kernels.py:
//   K14 _maxsim_v2_kernel (maxsim_all_pairs_pallas_v2) -> maxsim_kernel
// out[b][c] = sum_l w(b,l) * max_t s(b,l,c,t) over the Lpad token slots of
// candidate c of query b: s = q[b,l].tok[first + t] for a live token (t <
// count, and tok_mask > 0 where a token mask is given), `fill` for any
// other slot below Lpad; w the query mask, a masked query token adding
// exactly 0 (never -inf * 0). The candidates are (first row, count) spans
// of one (N, D) token matrix, f32 or float16: per query (the batched exact
// rescore of retrieval/colbert_search.py) or, for the all-pairs form of
// ops/maxsim.py, the docs flattened and masked, doc c the Lpad rows from
// c * Lpad for every query.
//
// Training (ColBERT's in-batch all-pairs loss) adds two launches, neither
// with a Pallas counterpart (JAX differentiates its jnp MaxSim): the
// all-pairs form that also writes each row max's doc token
// (mm_maxsim_argmax, the ARGMAX instances of maxsim_kernel), and the
// backward kernel that turns those tokens into dq and dd (mm_maxsim_bwd,
// maxsim_bwd_kernel, at the end of this file).
//
// What bounds it on the card: 2*B*Lq*C*Ld*D operations against the token
// rows' bytes. At the all-pairs shapes (D 128-768, Lq 32, Ld 200) a token
// row is used by every query row of the batch and the function is compute
// bound; the batched rescore (a query's own 64 candidates) reads each
// candidate's float16 rows once and is bound by bytes.
//
// Arithmetic: the products run on the tensor cores (mma.sync m16n8k8 .tf32,
// f32 accumulators; SASS HMMA.1688.F32.TF32) in split TF32: x = hi + lo, hi
// the nearest TF32 of x (ties away from zero, cvt.rna's rounding, done with
// two integer operations), lo the nearest TF32 of x - hi, and q.d =
// q_lo.d_hi + q_hi.d_lo + q_hi.d_hi, small terms first (the dropped lo.lo term and lo's rounding leave about 2^-21 of
// |q||d|, against TF32's 2^-11 alone, which misses the 1e-4 bar at ColBERT's
// raw dots of ~7,000). Float16 tokens are exact in TF32 (10 mantissa bits),
// so their lo is 0 and that product is skipped: two products, not three.
//
// Design: a block takes `qpb` whole queries (all-pairs: as many as fit a
// row tile of at most 128 rows; the batched rescore: one) and `cpb` of
// their candidates. The tile's query rows (qpb*Lq rounded up to the MMA's
// 16, never 128 for a short query) sit in shared memory in f32 over all of
// D; a query longer than a tile (Lq up to 512, or wide D) walks its rows in
// tiles, reloading them per candidate. The candidates' tokens stream through
// a 3-stage cp.async ring in chunks of 64 tokens x 128 bytes of D (32 f32 or
// 64 float16); the block's candidate spans wait in shared memory and a
// chunk's token mask in registers, so no global load stalls the ring. Four warps split a chunk's 64 tokens (and, in tiles over 32
// rows, the rows in two halves), each holding MSW strips of 16 rows x NTW
// n8 token tiles of accumulators; the k slots of a k8 step are permuted
// (slot t <-> element 2t, slot t + 4 <-> element 2t + 1) so each lane loads
// its A and B elements as float2 / half2 pairs, the row strides padded so
// the loads hit distinct banks. After a chunk each accumulator takes the
// token's mask (or `fill`) and folds into a running row max in registers;
// after a candidate the max goes across the quad by shuffles, across the
// warps through shared memory in a fixed order, and one thread per query
// sums its rows in order l = 0..Lq-1: every order is fixed, so reruns give
// identical bits, and the (B, Lq, C, Ld) scores never reach device memory.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace mm {
namespace msim {

constexpr int THREADS = 128;       // four warps
constexpr int WARPS = THREADS / 32;
constexpr int TOK = 64;            // tokens of a chunk
constexpr int STAGES = 3;          // cp.async ring depth
constexpr int MAX_ROWS = 128;      // query rows of a tile
constexpr int MAX_LQ = 512;        // query rows a block sums (the encoder's position limit)
constexpr int SMEM_MAX = 232448;   // shared memory a block can use
constexpr int MAX_CPB = 128;       // candidates a block (their spans sit in shared memory)

// a stage: TOK token rows of 128 bytes of K, rows padded so a warp's B
// loads (row g, pair t) hit 32 distinct banks
template <typename DT>
struct Tok;
template <>
struct Tok<float> {
  static constexpr int KS = 32, LD = 40;  // K a stage, row stride (elements)
  static constexpr int PRODUCTS = 3;
};
template <>
struct Tok<__half> {
  static constexpr int KS = 64, LD = 72;
  static constexpr int PRODUCTS = 2;
};
template <typename DT>
__host__ __device__ constexpr int stage_elems() {
  return TOK * Tok<DT>::LD;
}

struct Params {
  const float* q;          // (B, Lq, D) f32
  const float* q_mask;     // (B, Lq) f32
  const void* tokens;      // (N, D) f32 or float16
  const float* tok_mask;   // (N) f32, or null: every token of a span is live
  const long long* first;  // candidates' first token rows, (B, C) or (C); null: candidate c is rows [c Lpad, +Lpad)
  const int* count;        // candidates' token counts (<= Lpad), the same shape
  float* out;              // (B, C) f32
  int* argmax;             // (B, Lq, C) int32 or null: each row max's doc token (all pairs only)
  int B, Lq, C, D, Lpad;
  int cand_stride;         // C: per-query spans; 0: all pairs over dense docs
  int ldq;                 // query row stride in shared memory (floats), % 32 == 8
  int rows;                // rows of a tile (multiple of 16)
  int tiles;               // tiles a query job walks (> 1: one query a block, reloaded per candidate)
  int qpb, cpb;            // queries and candidates a block
  float fill;
};

// the nearest TF32 value, ties away from zero, as cvt.rna.tf32.f32 gives
// it: half of the 13 dropped bits added to the magnitude, then masked off
// (two integer operations; ptxas expands the cvt to four with an inf test,
// and an inf stays inf here too)
__device__ __forceinline__ uint32_t tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c (16 x 8 f32) += a (16 x 8 tf32, row) . b (8 x 8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two consecutive token elements as f32
__device__ __forceinline__ float2 load_pair(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load_pair(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// where the block's stage walk stands: candidate c, row tile, token chunk, K slab
struct Cursor {
  int c, tile, chunk, slab;
  int chunks, count;
  long long first;
};

// the block's candidate spans, staged in shared memory (c0: its first candidate)
struct Spans {
  const long long* first;
  const int* count;
  int c0;
};

__device__ __forceinline__ void at_candidate(const Spans& sp, Cursor& cur) {
  cur.first = sp.first[cur.c - sp.c0];
  cur.count = sp.count[cur.c - sp.c0];
  cur.chunks = max(1, (cur.count + TOK - 1) / TOK);
}

__device__ __forceinline__ void advance(const Params& p, const Spans& sp, int c_end, int slabs, Cursor& cur) {
  if (++cur.slab < slabs) return;
  cur.slab = 0;
  if (++cur.chunk < cur.chunks) return;
  cur.chunk = 0;
  if (++cur.tile < p.tiles) return;
  cur.tile = 0;
  if (++cur.c < c_end) at_candidate(sp, cur);
}

// one stage: chunk tokens [chunk * 64, +64) of the candidate, K [slab * KS,
// +KS), rows past the count zero-filled (they are masked anyway)
template <typename DT>
__device__ __forceinline__ void load_stage(const Params& p, const Cursor& cur, DT* dst) {
  constexpr int KS = Tok<DT>::KS, LD = Tok<DT>::LD, PER = 16 / sizeof(DT);
  const DT* tokens = static_cast<const DT*>(p.tokens);
  const int k0 = cur.slab * KS, t0 = cur.chunk * TOK;
  const int pieces = min(KS, p.D - k0) / PER;  // 16-byte pieces of a row
  for (int i = threadIdx.x; i < TOK * 8; i += THREADS) {
    const int r = i >> 3, piece = i & 7;
    if (piece >= pieces) continue;
    const bool live = t0 + r < cur.count;
    const DT* src = live ? tokens + (cur.first + t0 + r) * p.D + k0 + piece * PER : tokens;
    cp_async16(dst + r * LD + piece * PER, src, live ? 16 : 0);
  }
}

// query rows [row0, row0 + n) of the block's queries into the tile, the
// tile's rows past n zeroed
__device__ __forceinline__ void load_queries(const Params& p, int b0, int row0, int n, float* Qs) {
  const float* src = p.q + ((size_t)b0 * p.Lq + row0) * p.D;
  const int d4 = p.D / 4;
  for (int i = threadIdx.x; i < p.rows * d4; i += THREADS) {
    const int r = i / d4, k = (i - r * d4) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < n) v = *reinterpret_cast<const float4*>(src + (size_t)r * p.D + k);
    *reinterpret_cast<float4*>(Qs + r * p.ldq + k) = v;
  }
}

// which of two equal maxima a row keeps: the lower doc token, a filled
// slot (-1, compared unsigned) after every live token
__device__ __forceinline__ bool before(int a, int b) { return (unsigned)a < (unsigned)b; }

// MSW strips of 16 rows x NTW n8 token tiles a warp; WT warps across a
// chunk's tokens, WARPS / WT across the tile's rows. FULL: every strip of
// every tile holds query rows, so the products test none. ARGMAX: each
// row's max also carries its doc token (the first of equal maxima, -1 for
// a filled slot) into p.argmax, for the backward kernel below
template <typename DT, int MSW, int NTW, bool FULL, bool ARGMAX>
__global__ void __launch_bounds__(THREADS) maxsim_kernel(const Params p) {
  constexpr int KS = Tok<DT>::KS, LD = Tok<DT>::LD, PRODUCTS = Tok<DT>::PRODUCTS;
  constexpr int WT = TOK / (8 * NTW);
  static_assert(WARPS % WT == 0, "warps split a chunk's tokens evenly");
  extern __shared__ __align__(16) float smem[];
  long long* s_first = reinterpret_cast<long long*>(smem);                   // [MAX_CPB]
  int* s_count = reinterpret_cast<int*>(s_first + MAX_CPB);                  // [MAX_CPB]
  float* Qs = reinterpret_cast<float*>(s_count + MAX_CPB);                   // [rows][ldq]
  DT* ring = reinterpret_cast<DT*>(Qs + p.rows * p.ldq);                     // [STAGES][TOK][LD]
  float* red = reinterpret_cast<float*>(ring + STAGES * stage_elems<DT>());  // [WT][rows]
  float* best = red + WT * p.rows;                                           // [max(rows, Lq)]
  float* wts = best + max(p.rows, p.Lq);                                     // the queries' masks, [nq * Lq]
  int* red_idx = reinterpret_cast<int*>(wts + max(p.rows, p.Lq));            // ARGMAX: [WT][rows]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wt = warp % WT, strip0 = (warp / WT) * MSW;
  const int ldq = p.ldq;
  const int a_lane = (strip0 * 16 + g) * ldq + 2 * t;  // this lane's first A element in the tile
  const int b_lane = (wt * NTW * 8 + g) * LD + 2 * t;  // and its first B element in a stage
  const int b0 = blockIdx.y * p.qpb, nq = min(p.qpb, p.B - b0);
  const int c0 = blockIdx.x * p.cpb, c_end = min(p.C, c0 + p.cpb);
  const int slabs = (p.D + KS - 1) / KS;
  if (c0 >= c_end) return;

  for (int i = threadIdx.x; i < c_end - c0; i += THREADS) {
    const long long j = (long long)b0 * p.cand_stride + c0 + i;
    s_first[i] = p.first ? p.first[j] : (long long)(c0 + i) * p.Lpad;  // dense docs: Lpad rows each
    s_count[i] = p.first ? p.count[j] : p.Lpad;
  }
  for (int i = threadIdx.x; i < nq * p.Lq; i += THREADS) wts[i] = p.q_mask[(size_t)b0 * p.Lq + i];
  __syncthreads();
  const Spans sp{s_first, s_count, c0};
  Cursor prod{c0, 0, 0, 0, 0, 0, 0};
  at_candidate(sp, prod);
  Cursor cons = prod;
  int tile_rows = nq * p.Lq;  // rows of the tile in use
  if (p.tiles == 1) load_queries(p, b0, 0, tile_rows, Qs);  // the first iteration's barrier publishes it
  for (int s = 0; s < STAGES - 1; ++s) {
    if (prod.c < c_end) {
      load_stage<DT>(p, prod, ring + s * stage_elems<DT>());
      advance(p, sp, c_end, slabs, prod);
    }
    cp_async_commit();
  }

  float acc[MSW][NTW][4], rmax[MSW][2];
  int ridx[MSW][2];   // ARGMAX: the doc token of each running max
  bool live[NTW][2];  // the chunk's tokens of this lane: inside the span and not masked
#pragma unroll
  for (int s = 0; s < MSW; ++s) {
    rmax[s][0] = rmax[s][1] = -INFINITY;
    ridx[s][0] = ridx[s][1] = -1;
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][n][e] = 0.0f;
  }

  for (int it = 0; cons.c < c_end; ++it) {
    if (p.tiles > 1 && cons.chunk == 0 && cons.slab == 0) {
      __syncthreads();  // the previous tile's rows are read
      tile_rows = min(p.rows, p.Lq - cons.tile * p.rows);
      load_queries(p, b0, cons.tile * p.rows, tile_rows, Qs);
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // this stage landed for every thread; the slot refilled below is consumed
    if (prod.c < c_end) {
      load_stage<DT>(p, prod, ring + ((it + STAGES - 1) % STAGES) * stage_elems<DT>());
      advance(p, sp, c_end, slabs, prod);
    }
    cp_async_commit();

    if (cons.slab == 0) {  // a chunk begins: its tokens' masks, read while the products run
      const int tok0 = cons.chunk * TOK + wt * NTW * 8 + 2 * t;
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int tok = tok0 + n * 8 + e;
          live[n][e] = tok < cons.count && (p.tok_mask == nullptr || p.tok_mask[cons.first + tok] > 0.0f);
        }
    }

    // the products of this stage: k8 steps in order, each pair of a lane's
    // A and B elements (k slots t and t + 4) one float2 / half2 load
    const int my_strips = FULL ? MSW : min(MSW, ((tile_rows + 15) >> 4) - strip0);  // this warp's strips with rows
    const int steps = min(KS, p.D - cons.slab * KS) >> 3;
    const DT* tb = ring + (it % STAGES) * stage_elems<DT>() + b_lane;
    const float* qa = Qs + a_lane + cons.slab * KS;
#pragma unroll
    for (int kk = 0; kk < KS / 8; ++kk) {
      if (kk < steps) {
        uint32_t bh[NTW][2], bl[NTW][2];
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          const float2 v = load_pair(tb + n * 8 * LD + kk * 8);
          if (PRODUCTS == 3) {
            split(v.x, bh[n][0], bl[n][0]);
            split(v.y, bh[n][1], bl[n][1]);
          } else {  // float16: exact in TF32
            bh[n][0] = __float_as_uint(v.x);
            bh[n][1] = __float_as_uint(v.y);
          }
        }
        // every strip's A first, then each product term over all (strip,
        // n8 tile) accumulators: MSW * NTW independent sums between two
        // products into one accumulator
        uint32_t ah[MSW][4], al[MSW][4];
#pragma unroll
        for (int s = 0; s < MSW; ++s) {
          if (FULL || s < my_strips) {
            const float2 r0 = load_pair(qa + s * 16 * ldq + kk * 8);
            const float2 r1 = load_pair(qa + (s * 16 + 8) * ldq + kk * 8);
            split(r0.x, ah[s][0], al[s][0]);
            split(r1.x, ah[s][1], al[s][1]);
            split(r0.y, ah[s][2], al[s][2]);
            split(r1.y, ah[s][3], al[s][3]);
          }
        }
#pragma unroll
        for (int s = 0; s < MSW; ++s)
          if (FULL || s < my_strips)
#pragma unroll
            for (int n = 0; n < NTW; ++n) mma_tf32(acc[s][n], al[s], bh[n]);
        if (PRODUCTS == 3) {
#pragma unroll
          for (int s = 0; s < MSW; ++s)
            if (FULL || s < my_strips)
#pragma unroll
              for (int n = 0; n < NTW; ++n) mma_tf32(acc[s][n], ah[s], bl[n]);
        }
#pragma unroll
        for (int s = 0; s < MSW; ++s)
          if (FULL || s < my_strips)
#pragma unroll
            for (int n = 0; n < NTW; ++n) mma_tf32(acc[s][n], ah[s], bh[n]);
      }
    }

    if (cons.slab == slabs - 1) {
      // the chunk is summed over D: each token's mask, then the running row max
      const int tok0 = cons.chunk * TOK + wt * NTW * 8 + 2 * t;
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool inside = tok0 + n * 8 + e < cons.count;
#pragma unroll
          for (int s = 0; s < MSW; ++s)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v = live[n][e] ? acc[s][n][2 * h + e] : (inside ? p.fill : -INFINITY);
              if constexpr (ARGMAX) {
                const int idx = live[n][e] ? tok0 + n * 8 + e : -1;
                if (v > rmax[s][h] || (v == rmax[s][h] && before(idx, ridx[s][h]))) {
                  rmax[s][h] = v;
                  ridx[s][h] = idx;
                }
              } else {
                rmax[s][h] = fmaxf(rmax[s][h], v);
              }
            }
        }
#pragma unroll
      for (int s = 0; s < MSW; ++s)
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[s][n][e] = 0.0f;

      if (cons.chunk == cons.chunks - 1) {
        // the candidate's tile is done: max over the quad, then over the WT
        // warps sharing a row (in order), the fill of slots past the count
#pragma unroll
        for (int s = 0; s < MSW; ++s)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float m = rmax[s][h];
            if constexpr (ARGMAX) {
              int i = ridx[s][h];
#pragma unroll
              for (int x = 1; x <= 2; x <<= 1) {
                const float om = __shfl_xor_sync(0xffffffffu, m, x);
                const int oi = __shfl_xor_sync(0xffffffffu, i, x);
                if (om > m || (om == m && before(oi, i))) {
                  m = om;
                  i = oi;
                }
              }
              if (t == 0 && (FULL || s < my_strips)) red_idx[wt * p.rows + (strip0 + s) * 16 + g + 8 * h] = i;
              ridx[s][h] = -1;
            } else {
              m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
              m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            }
            if (t == 0 && (FULL || s < my_strips)) red[wt * p.rows + (strip0 + s) * 16 + g + 8 * h] = m;
            rmax[s][h] = -INFINITY;
          }
        __syncthreads();
        const int row_off = cons.tile * p.rows;
        for (int r = threadIdx.x; r < tile_rows; r += THREADS) {
          float m = red[r];
          if constexpr (ARGMAX) {
            int i = red_idx[r];
            for (int w = 1; w < WT; ++w) {
              const float om = red[w * p.rows + r];
              const int oi = red_idx[w * p.rows + r];
              if (om > m || (om == m && before(oi, i))) {
                m = om;
                i = oi;
              }
            }
            if (cons.count < p.Lpad && p.fill > m) {
              m = p.fill;
              i = -1;
            }
            p.argmax[((size_t)b0 * p.Lq + row_off + r) * p.C + cons.c] = i;
          } else {
            for (int w = 1; w < WT; ++w) m = fmaxf(m, red[w * p.rows + r]);
            if (cons.count < p.Lpad) m = fmaxf(m, p.fill);
          }
          best[row_off + r] = m;
        }
        if (cons.tile == p.tiles - 1) {
          __syncthreads();
          for (int qi = threadIdx.x; qi < nq; qi += THREADS) {
            const float* w = wts + qi * p.Lq;
            float sum = 0.0f;
            for (int l = 0; l < p.Lq; ++l) {
              const float m = w[l];
              if (m != 0.0f) sum += best[qi * p.Lq + l] * m;
            }
            p.out[(size_t)(b0 + qi) * p.C + cons.c] = sum;
          }
        }
      }
    }
    advance(p, sp, c_end, slabs, cons);
  }
  cp_async_wait<0>();
}

template <typename DT, int MSW, int NTW>
cudaError_t launch(const Params& p, size_t smem, dim3 grid, cudaStream_t stream) {
  // FULL when each tile's rows fill the warps' strips: one tile of exactly
  // that many rows, or tiles of it that divide Lq
  constexpr int STRIPS = MSW * (WARPS / (TOK / (8 * NTW)));
  const bool full = p.rows == STRIPS * 16 && (p.tiles == 1 ? p.qpb * p.Lq == p.rows : p.Lq % p.rows == 0);
  auto kernel = full ? maxsim_kernel<DT, MSW, NTW, true, false> : maxsim_kernel<DT, MSW, NTW, false, false>;
  if constexpr (std::is_same<DT, float>::value) {  // the training form: f32 docs, all pairs
    if (p.argmax)
      kernel = full ? maxsim_kernel<DT, MSW, NTW, true, true> : maxsim_kernel<DT, MSW, NTW, false, true>;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// the warp tile for a row tile: <= 32 rows, 2 strips x 2 n8 tiles (the
// warps split the tokens four ways); <= 64 rows, 2 x 4 (tokens two ways,
// rows two ways); else 4 x 4
template <typename DT>
cudaError_t launch_rows(const Params& p, size_t smem, dim3 grid, cudaStream_t stream) {
  if (p.rows <= 32) return launch<DT, 2, 2>(p, smem, grid, stream);
  if (p.rows <= 64) return launch<DT, 2, 4>(p, smem, grid, stream);
  return launch<DT, 4, 4>(p, smem, grid, stream);
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms <= 0)
      sms = 132;
  }
  return sms;
}

}  // namespace msim
}  // namespace mm

using namespace mm::msim;

extern "C" {

// out (B, C) f32: MaxSim of queries q (B, Lq, D) f32 with masks (B, Lq)
// against C candidates a query, each `count` (<= Lpad) token rows from
// `first` of tokens (N, D), f32 (tok_f16 = 0) or float16 (tok_f16 = 1),
// slots up to Lpad past the count and tokens with tok_mask <= 0 (when
// given) taking `fill`. first/count (B, C) int64/int32: a query's own
// candidates (the caller checks that the spans lie inside tokens); both
// null: candidate c the Lpad rows from c * Lpad for every query (all pairs
// over dense docs). D % 8 == 0, D <= 2048, 1 <= Lq <= 512.
static int maxsim_entry(const void* q, const void* q_mask, const void* tokens, const void* tok_mask,
                        const void* first, const void* count, void* out, void* argmax, int B, int Lq, int C, int D,
                        int Lpad, int tok_f16, float fill, void* stream) {
  if (D < 8 || D % 8 || D > 2048 || Lq < 1 || Lq > MAX_LQ || Lpad < 0 || (first == nullptr) != (count == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  Params p;
  p.q = static_cast<const float*>(q);
  p.q_mask = static_cast<const float*>(q_mask);
  p.tokens = tokens;
  p.tok_mask = static_cast<const float*>(tok_mask);
  p.first = static_cast<const long long*>(first);
  p.count = static_cast<const int*>(count);
  p.out = static_cast<float*>(out);
  p.argmax = static_cast<int*>(argmax);
  p.B = B;
  p.Lq = Lq;
  p.C = C;
  p.D = D;
  p.Lpad = Lpad;
  p.cand_stride = first ? C : 0;
  p.fill = fill;
  p.ldq = D + (40 - D % 32) % 32;  // % 32 == 8: a warp's float2 A loads hit distinct banks
  const size_t ring = (size_t)STAGES * TOK * (tok_f16 ? Tok<__half>::LD * 2 : Tok<float>::LD * 4);
  const size_t red_idx = argmax ? (size_t)WARPS * MAX_ROWS * 4 : 0;  // the argmax form's row tokens
  const size_t fixed = (size_t)MAX_CPB * 12 + ring + (size_t)(WARPS + 1) * MAX_ROWS * 4 + (size_t)MAX_LQ * 8 + red_idx;
  const int fit = (int)((SMEM_MAX - fixed) / ((size_t)p.ldq * 4)) / 16 * 16;  // rows the tile can hold
  const int max_rows = fit < MAX_ROWS ? fit : MAX_ROWS;
  if (max_rows < 16) return static_cast<int>(cudaErrorInvalidValue);
  // whole queries a tile: all-pairs packs as many as fit, a query's own
  // candidates take one; a query longer than a tile walks it in tiles
  p.qpb = Lq <= max_rows && first == nullptr ? (max_rows / Lq < B ? max_rows / Lq : B) : 1;
  const int rows = p.qpb * Lq;
  p.tiles = rows <= max_rows ? 1 : (Lq + max_rows - 1) / max_rows;
  p.rows = p.tiles == 1 ? (rows + 15) / 16 * 16 : max_rows;
  const int groups = (B + p.qpb - 1) / p.qpb;
  // candidates a block: about sixteen blocks an SM over the launch (two or
  // three run at once, so the last wave is a small share), spread evenly
  // over a query group's blocks
  const long long pairs = (long long)groups * C, want = 16LL * sm_count();
  const long long per_block = pairs / want < MAX_CPB ? pairs / want : MAX_CPB;
  const int cpb = (int)(per_block > 1 ? (per_block < C ? per_block : C) : 1);
  const int blocks = (C + cpb - 1) / cpb;
  p.cpb = (C + blocks - 1) / blocks;
  const dim3 grid(blocks, groups);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int wt = p.rows <= 32 ? 4 : 2;  // warps across a chunk's tokens (launch_rows)
  const int best = Lq > p.rows ? Lq : p.rows;  // + the queries' masks, as many
  const size_t spans = (size_t)MAX_CPB * 12;
  const size_t smem = spans + (size_t)p.rows * p.ldq * 4 + ring + (size_t)wt * p.rows * 4 + (size_t)best * 8 +
                      (argmax ? (size_t)wt * p.rows * 4 : 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = tok_f16 ? launch_rows<__half>(p, smem, grid, s) : launch_rows<float>(p, smem, grid, s);
  return static_cast<int>(err);
}

int mm_maxsim(const void* q, const void* q_mask, const void* tokens, const void* tok_mask, const void* first,
              const void* count, void* out, int B, int Lq, int C, int D, int Lpad, int tok_f16, float fill,
              void* stream) {
  return maxsim_entry(q, q_mask, tokens, tok_mask, first, count, out, nullptr, B, Lq, C, D, Lpad, tok_f16, fill,
                      stream);
}

// the training form of the all-pairs launch: mm_maxsim over f32 dense docs
// (first/count null) that also writes argmax (B, Lq, C) int32, each (query
// row, doc)'s max doc token: the first of exactly equal maxima, -1 where the
// fill is the max (a masked or padded slot; no gradient goes there)
int mm_maxsim_argmax(const void* q, const void* q_mask, const void* tokens, const void* tok_mask, void* out,
                     void* argmax, int B, int Lq, int C, int D, int Lpad, float fill, void* stream) {
  if (argmax == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return maxsim_entry(q, q_mask, tokens, tok_mask, nullptr, nullptr, out, argmax, B, Lq, C, D, Lpad, 0, fill,
                      stream);
}

}  // extern "C"

// ---- the backward of the all-pairs form --------------------------------------
//
// Given g = dL/dout (Bq, Bd) and the argmax the training form saved, the
// gradients of out[b][k] = sum_l w(b,l) max_m (q[b,l] . d[k,m]):
//   dq[b,l,:] = w(b,l) sum_k g[b,k] d[k, a(b,l,k), :]
//   dd[k,m,:] = sum over (b,l) whose max for doc k sits on m of g[b,k] w(b,l) q[b,l,:]
// with a = -1 (the fill won) giving nothing. Exactly equal maxima split
// their gradient evenly, as torch.amax's backward (and JAX's max) does: the
// forward keeps the first of them, and the rows of the doc that are bit for
// bit equal to it (the ties its products can make, a token repeated in a
// document) share w / count each. No float atomics: blocks [0, Bd * chunks)
// each own a doc's dd rows for `cw` columns, held in shared memory and
// summed over (b, l) in order; the other blocks own 8 rows of dq each, a
// warp two rows, summed over k in order. Reruns give identical bits.

namespace mm {
namespace msim_bwd {

constexpr int THREADS = 128;
constexpr int ROWS_PER_WARP = 2;
constexpr int DQ_ROWS = ROWS_PER_WARP * THREADS / 32;  // dq rows a block
constexpr int TILE = 256;                              // (b, l) entries a dd block stages at once
constexpr int SMEM_MAX = 232448;

struct Params {
  const float* q;       // (Bq, Lq, D)
  const float* q_mask;  // (Bq, Lq)
  const float* d;       // (Bd, Ld, D)
  const float* d_mask;  // (Bd, Ld)
  const int* argmax;    // (Bq, Lq, Bd)
  const float* g;       // (Bq, Bd)
  float* dq;            // (Bq, Lq, D)
  float* dd;            // (Bd, Ld, D)
  int Bq, Lq, Bd, Ld, D;
  int cw, chunks, dd_blocks;
};

__device__ __forceinline__ uint32_t row_hash(const float* row, int D) {
  uint32_t h = 2166136261u;
  for (int i = 0; i < D; ++i) h = (h ^ __float_as_uint(row[i])) * 16777619u;
  return h;
}

__device__ __forceinline__ bool rows_equal(const float* a, const float* b, int D) {
  for (int i = 0; i < D; ++i)
    if (__float_as_uint(a[i]) != __float_as_uint(b[i])) return false;
  return true;
}

__device__ void dd_block(const Params& p, int blk, char* smem) {
  const int k = blk / p.chunks, col = (blk % p.chunks) * p.cw + threadIdx.x;
  const int Ld = p.Ld, D = p.D, cw = p.cw, E = p.Bq * p.Lq;
  float* acc = reinterpret_cast<float*>(smem);                   // [Ld][cw]
  int* lead = reinterpret_cast<int*>(acc + (size_t)Ld * cw);     // [Ld] the first row equal to this one
  int* next = lead + Ld;                                         // [Ld] the next row equal to it, or -1
  int* cnt = next + Ld;                                          // [Ld] rows equal to it
  uint32_t* hsh = reinterpret_cast<uint32_t*>(cnt + Ld);         // [Ld]
  int* s_a = reinterpret_cast<int*>(hsh + Ld);                   // [TILE]
  float* s_w = reinterpret_cast<float*>(s_a + TILE);             // [TILE]
  const float* doc = p.d + (size_t)k * Ld * D;
  const float* dm = p.d_mask + (size_t)k * Ld;

  // the doc's classes of bit-equal live rows
  for (int m = threadIdx.x; m < Ld; m += THREADS) hsh[m] = dm[m] > 0.0f ? row_hash(doc + (size_t)m * D, D) : 0u;
  for (int i = threadIdx.x; i < Ld * cw; i += THREADS) acc[i] = 0.0f;
  __syncthreads();
  for (int m = threadIdx.x; m < Ld; m += THREADS) {
    int first = m;
    if (dm[m] > 0.0f)
      for (int m2 = 0; m2 < m; ++m2)
        if (dm[m2] > 0.0f && hsh[m2] == hsh[m] && rows_equal(doc + (size_t)m2 * D, doc + (size_t)m * D, D)) {
          first = m2;
          break;
        }
    lead[m] = first;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < Ld; m += THREADS) {
    int n = -1, c = 0;
    for (int m2 = Ld - 1; m2 >= 0; --m2)
      if (lead[m2] == lead[m]) {
        ++c;
        if (m2 > m) n = m2;
      }
    next[m] = n;
    cnt[m] = c;
  }

  const bool mine = threadIdx.x < cw && col < D;
  for (int e0 = 0; e0 < E; e0 += TILE) {
    __syncthreads();  // the classes are built; the previous tile is consumed
    const int n = min(TILE, E - e0);
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int e = e0 + i;
      const float w = p.g[(size_t)(e / p.Lq) * p.Bd + k] * p.q_mask[e];
      const int a = p.argmax[(size_t)e * p.Bd + k];
      s_a[i] = w != 0.0f && a >= 0 ? a : -1;
      s_w[i] = w;
    }
    __syncthreads();
    if (!mine) continue;
    const float* qcol = p.q + (size_t)e0 * D + col;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float qv = qcol[(size_t)i * D];
      const int a = s_a[i];
      if (a < 0) continue;
      const int first = lead[a], c = cnt[first];
      if (c == 1) {
        acc[a * cw + threadIdx.x] += s_w[i] * qv;
      } else {
        const float v = (s_w[i] / (float)c) * qv;
        for (int m = first; m >= 0; m = next[m]) acc[m * cw + threadIdx.x] += v;
      }
    }
  }
  if (mine)
    for (int m = 0; m < Ld; ++m) p.dd[((size_t)k * Ld + m) * D + col] = acc[m * cw + threadIdx.x];
}

__device__ void dq_block(const Params& p, int blk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, E = p.Bq * p.Lq, D4 = p.D / 4;
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int e = (blk * (THREADS / 32) + warp) * ROWS_PER_WARP + r;  // query row (b, l)
    if (e >= E) return;
    const int b = e / p.Lq;
    const float wq = p.q_mask[e];
    const int* a_row = p.argmax + (size_t)e * p.Bd;
    const float* g_row = p.g + (size_t)b * p.Bd;
    for (int d4 = lane; d4 < D4; d4 += 32) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (wq != 0.0f) {
#pragma unroll 4
        for (int k = 0; k < p.Bd; ++k) {
          const int a = a_row[k];
          if (a < 0) continue;
          const float w = g_row[k] * wq;
          const float4 v = *reinterpret_cast<const float4*>(p.d + ((size_t)k * p.Ld + a) * p.D + d4 * 4);
          acc.x += w * v.x;
          acc.y += w * v.y;
          acc.z += w * v.z;
          acc.w += w * v.w;
        }
      }
      *reinterpret_cast<float4*>(p.dq + (size_t)e * p.D + d4 * 4) = acc;
    }
  }
}

__global__ void __launch_bounds__(THREADS) maxsim_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) char smem[];
  if ((int)blockIdx.x < p.dd_blocks)
    dd_block(p, blockIdx.x, smem);
  else
    dq_block(p, blockIdx.x - p.dd_blocks);
}

inline size_t dd_smem(int Ld, int cw) { return (size_t)Ld * cw * 4 + (size_t)Ld * 16 + (size_t)TILE * 8; }

}  // namespace msim_bwd
}  // namespace mm

extern "C" {

// dq (Bq, Lq, D) and dd (Bd, Ld, D) f32 from g (Bq, Bd) and the argmax
// (Bq, Lq, Bd) of mm_maxsim_argmax over the same q (Bq, Lq, D), q_mask
// (Bq, Lq), docs (Bd, Ld, D) and d_mask (Bd, Ld), all f32 but argmax.
// D % 8 == 0, D <= 2048, Lq >= 1, 1 <= Ld <= 1024.
int mm_maxsim_bwd(const void* q, const void* q_mask, const void* d, const void* d_mask, const void* argmax,
                  const void* g, void* dq, void* dd, int Bq, int Lq, int Bd, int Ld, int D, void* stream) {
  namespace bw = mm::msim_bwd;
  if (D < 8 || D % 8 || D > 2048 || Lq < 1 || Ld < 1 || Ld > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (Bq <= 0 || Bd <= 0) return static_cast<int>(cudaSuccess);
  bw::Params p;
  p.q = static_cast<const float*>(q);
  p.q_mask = static_cast<const float*>(q_mask);
  p.d = static_cast<const float*>(d);
  p.d_mask = static_cast<const float*>(d_mask);
  p.argmax = static_cast<const int*>(argmax);
  p.g = static_cast<const float*>(g);
  p.dq = static_cast<float*>(dq);
  p.dd = static_cast<float*>(dd);
  p.Bq = Bq;
  p.Lq = Lq;
  p.Bd = Bd;
  p.Ld = Ld;
  p.D = D;
  p.cw = bw::THREADS;  // the widest column slab whose rows fit shared memory
  while (p.cw > 32 && bw::dd_smem(Ld, p.cw) > (size_t)bw::SMEM_MAX) p.cw /= 2;
  p.chunks = (D + p.cw - 1) / p.cw;
  p.dd_blocks = Bd * p.chunks;
  const long long dq_blocks = ((long long)Bq * Lq + bw::DQ_ROWS - 1) / bw::DQ_ROWS;
  if (p.dd_blocks + dq_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bw::dd_smem(Ld, p.cw);
  cudaError_t err =
      cudaFuncSetAttribute(bw::maxsim_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bw::maxsim_bwd_kernel<<<(unsigned)(p.dd_blocks + dq_blocks), bw::THREADS, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
