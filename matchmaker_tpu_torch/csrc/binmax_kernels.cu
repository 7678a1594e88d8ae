// The binmax MIPS scans, written for Hopper.
//
// Replaces the Pallas kernels of matchmaker_tpu/ops/mips_binmax.py:
//   K3 _binmax_kernel + _topk_per_bin_t (bf16 corpus, bf16 queries)
//                                         -> scan_kernel<P, SCAN_BF16, SLABS>
//   K7 _binmax_kernel_int8 (int8 corpus, int8 query codes)
//                                         -> scan_kernel<P, SCAN_INT8, SLABS>
//   K8 _binmax_kernel_int8f (int8 corpus, bf16 queries)
//                                         -> scan_kernel<P, SCAN_MIXED, SLABS>
//   K5 _transpose_kernel                  -> folded into the scans' stores
//   K4 _make_level2_kernel (level 2)      -> l2::level2_kernel<W>
//   K6 _unpack_kernel                     -> unpack::unpack_kernel
//
// Every scan keeps, for each query and each 128-row corpus bin, the bin's
// top `per_bin` scores (ties to the lowest row offset: repeated
// first-argmax, the TPU kernel's rule), rows >= n_valid masked to -inf
// first, and packs the 7-bit offset into the low mantissa bits of finite
// scores. It stores straight into the (Q, C) layout the TPU path only
// reaches after its transpose pass: column = tile*(per_bin*nb) + rank*nb +
// bin, nb = tile_rows/128. K7 scores are exact int32 sums, then
// f32(raw) * bin scale * query scale, in that order and rounded at each
// step, as the TPU kernel does; K8 multiplies the f32 sum of bf16 products
// of the codes (exact in bf16) and the queries by the bin scale, rounded
// once (mips_binmax.py:312-313).
//
// What bounds the scans on the card: at Q = 256 over 262,144 x 768 rows the
// corpus read (N*D*2 bytes for K3, N*D for K7 and K8: 0.125 / 0.065 ms at
// 3.35 TB/s) sets the floor, with the tensor cores' 2*Q*N*D operations
// close behind (0.104 ms bf16, K3 and K8; 0.052 ms int8); the per-bin
// selection is ALU work that grows with Q*N*per_bin: at per_bin 8 about
// half of K3's time and 70 % of K7's (ptxas recomputes a compare for each
// select of the insertion).
//
// scan_kernel is one persistent, warp-specialised kernel on the pieces of
// wgmma_gemm.cuh. The queries are the wgmma A operand (m64 slabs), one
// 128-row corpus bin the B operand (n128); both are K-major where they lie,
// (Q, D) and (N, D) row-major, so no copy is made. One producer thread
// keeps TMA loads of 128-byte-deep stages (64 bf16 or 128 int8 codes of K)
// in flight through an mbarrier ring; two consumer warpgroups each multiply
// SLABS m64 slabs of queries by the bin (K3 and K8: m64n128k16 bf16 -> f32,
// K7: m64n128k32 s8 -> s32), so a unit is one bin against 128 * SLABS
// queries and the whole bin's scores of a query row sit in the registers
// of one quad of lanes. One CTA per SM walks over the units, query blocks
// of a bin back to back (the bin's second read hits L2; at Q <= 256 a
// launch reads the corpus from device memory once), and the producer loads
// the next unit while the consumers select.
//
// K8 (SCAN_MIXED): a stage holds 64 of K, the queries as K3 loads them and
// the bin's 128 x 64 int8 codes, by TMA as they lie (no swizzle) into a
// staging area with a barrier of its own. The producer warpgroup's three
// idle warps (96 threads) turn them into bf16 in the 128-byte-swizzled
// layout TMA gives K3's corpus operand (exact: |code| <= 127), fence the
// writes for the async proxy, and arrive on the stage's full barrier beside
// the queries' transaction bytes; the consumers run K3's products,
// selection and stores unchanged. A stage is 32 + 16 + 8 KB at 256 queries,
// four in a 224 KB ring.
//
// Selection in registers: in the accumulator layout a lane holds, for each
// of its query rows, the bin columns {8j + 2t, 8j + 2t + 1}, j = 0..15,
// t = lane % 4 (the column map tests/test_torch_binmax_selection.py
// emulates). Each lane keeps the top P of its 32 columns in ascending
// offset order with a strict '>' (insert_sorted, branch-free), then two
// __shfl_xor_sync rounds (xor 1, xor 2) merge the quad's sorted lists
// (value descending, offset ascending on equal values; a bitonic split and
// sort), and the quad's lanes store the P packed candidates. The score tile
// never reaches shared memory and every consumer thread selects. A thread
// interleaves the insertions of its two rows of a slab (two independent
// chains), and a lane position rides as an f32 immediate (select_slab).
//
// Kept by measurement (tools/binmax_scan_ab.py, one call, H100): both
// consumer warpgroups on one unit of 256 queries, the corpus bin shared.
// Tried and dropped: a ping-pong in which each warpgroup owns units of 128
// queries and a ring of its own, so one selects while the other multiplies
// (K3 per_bin 2 14 % slower: each bin crosses L2 twice; K7 4 % faster); a
// values-first selection (max/min networks, then each value's column, the
// exact path for a row holding a value twice) (K7 per_bin 8 47 % slower:
// equal int32 sums in a bin send whole warps down the exact path).
//
// SLABS = 1 (a unit of 128 queries, for Q <= 128) or 2 (256 queries). Query
// rows past Q and K past D arrive as zeros (TMA's fill); their stores are
// masked.
#include "wgmma_gemm.cuh"

#include <climits>
#include <math.h>
#include <type_traits>

namespace mm {

constexpr int BIN = 128;
constexpr int L2_BLOCK = 1024;  // level-2 column block (matchmaker_tpu _L2_BLOCK)
constexpr int L2_KEEP = 8;      // candidates kept per level-2 group (LEVEL2_PER_BIN)

// offset into mantissa bits [shift, shift+7) of a finite f32 (_pack_lane)
__device__ __forceinline__ float pack_lane(float v, int lane, int shift) {
  if (!isfinite(v)) return v;
  const int bits = (__float_as_int(v) & ~(127 << shift)) | (lane << shift);
  return __int_as_float(bits);
}

// ---- K3, K7, K8: the persistent wgmma/TMA scan ------------------------------------
namespace scan {

using namespace wg;  // mbarriers, TMA, tensor maps, wgmma fences

enum ScanMode : int { SCAN_BF16 = 0, SCAN_INT8 = 1, SCAN_MIXED = 2 };

constexpr int ROW_BYTES = 128;               // bytes of K a stage: one 128-byte swizzled row
constexpr int SLAB_BYTES = 64 * ROW_BYTES;   // one m64 slab of query rows: 8 KB
constexpr int BIN_BYTES = BIN * ROW_BYTES;   // one corpus bin: 16 KB
constexpr int CODE_BYTES = BIN * 64;         // K8: a bin's int8 codes of a stage (64 of K): 8 KB
constexpr int CONSUMERS = 2;                 // consumer warpgroups, beside one producer warpgroup
constexpr int CONVERTERS = 96;               // K8: the producer warpgroup's warps 1-3
constexpr int THREADS = 128 * (CONSUMERS + 1);

template <int SLABS>
__host__ __device__ constexpr int query_rows() {  // queries a unit
  return CONSUMERS * SLABS * 64;
}
template <int MODE, int SLABS>
__host__ __device__ constexpr int stage_bytes() {  // the query block's rows and the bin's (K8: + its codes)
  return CONSUMERS * SLABS * SLAB_BYTES + BIN_BYTES + (MODE == SCAN_MIXED ? CODE_BYTES : 0);
}
template <int MODE, int SLABS>
__host__ __device__ constexpr int ring_stages() {  // a ring of 192 KB (K8: 224 KB, four stages at 256 queries)
  return (MODE == SCAN_MIXED ? 229376 : 196608) / stage_bytes<MODE, SLABS>();
}
template <int MODE, int SLABS>
__host__ __device__ constexpr int ring_smem_bytes() {  // + alignment, + 2 (K8: 3) barriers a stage
  return ring_stages<MODE, SLABS>() * stage_bytes<MODE, SLABS>() + 1024 +
         (MODE == SCAN_MIXED ? 3 : 2) * ring_stages<MODE, SLABS>() * 8;
}

struct Params {
  int NQ, NR, n_valid, nb;
  int q_blocks;             // ceil(NQ / query_rows)
  int k_steps;              // 128-byte stages of K
  long long ld_out;
  const float* bin_scales;    // (NR/128) f32, K7 and K8
  const float* query_scales;  // (NQ) f32, K7
  float* out;                 // (NQ, ld_out) f32
};

// d (64 x 128 f32) (+)= A (64 x 16) . B (128 x 16)^T, bf16, both K-major
// 128-byte-swizzled in shared memory; the asm builds the descriptors from
// the addresses (as wgmma_m64n128_s8), so no 64-bit descriptor stays live
// beside the accumulators
__device__ __forceinline__ void wgmma_m64n128_bf16(float (&d)[64], uint32_t a_addr, uint32_t b_addr,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 la, lb, hi;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "bfe.u32 la, %64, 4, 14;\nbfe.u32 lb, %65, 4, 14;\n"
      "or.b32 la, la, 0x10000;\nor.b32 lb, lb, 0x10000;\n"  // leading byte offset 16
      "mov.b32 hi, 0x40000040;\n"                               // stride 1024 bytes, 128-byte swizzle
      "mov.b64 da, {la, hi};\nmov.b64 db, {lb, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a_addr), "r"(b_addr), "r"(accumulate));
}

// one 32-byte k slice of a stage: 16 bf16 (K3, K8) or 32 int8 codes (K7)
__device__ __forceinline__ void mma_step(float (&d)[64], uint32_t a, uint32_t b, int accumulate) {
  wgmma_m64n128_bf16(d, a, b, accumulate);
}
__device__ __forceinline__ void mma_step(int (&d)[64], uint32_t a, uint32_t b, int accumulate) {
  wgmma_m64n128_s8(d, a, b, accumulate);
}

// pin accumulator registers after wgmma.wait_group (fence_regs for f32)
__device__ __forceinline__ void pin(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void pin(int (&r)[64]) { fence_regs(r); }

// a score of the accumulators: K3 as it is; K8 the f32 sum * bin scale;
// K7 f32(raw) * bin scale * query scale; each product rounded (the TPU
// kernels' order)
template <int MODE>
__device__ __forceinline__ float score(float acc, float cs, float) {
  return MODE == SCAN_MIXED ? __fmul_rn(acc, cs) : acc;
}
template <int MODE>
__device__ __forceinline__ float score(int acc, float cs, float qs) {
  return __fmul_rn(__fmul_rn(static_cast<float>(acc), cs), qs);
}

// K8: eight int8 codes (two words) -> eight bf16 (a 16-byte chunk), exact.
// A code x becomes f32 by its bits: 0x4B000000 | (x ^ 0x80) is 2^23 + 128 +
// x, less 2^23 + 128; the bf16 is that f32's high half, its low half being
// zero (|x| <= 127 needs 7 bits of mantissa).
__device__ __forceinline__ uint32_t code_bits(uint32_t flipped, uint32_t byte) {
  return __float_as_uint(__uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440u | byte)) - 8388736.0f);
}
__device__ __forceinline__ uint2 codes_to_bf16(uint32_t w) {
  const uint32_t f = w ^ 0x80808080u;
  return make_uint2(__byte_perm(code_bits(f, 0), code_bits(f, 1), 0x7632u),
                    __byte_perm(code_bits(f, 2), code_bits(f, 3), 0x7632u));
}

// K8: a stage's codes (128 rows x 64, as TMA lays them without a swizzle)
// into the bf16 B operand, 16-byte chunk c of row r at chunk c ^ (r % 8):
// the 128-byte swizzle TMA gives K3's corpus. Converter thread ct of 96
// takes chunks ct, ct + 96, ...; a warp reads 256 contiguous bytes and
// writes four whole 128-byte rows, so neither side has bank conflicts.
__device__ __forceinline__ void convert_codes(const uint8_t* codes, uint8_t* tile, int ct) {
  for (int i = ct; i < BIN * 8; i += CONVERTERS) {
    const int r = i >> 3, c = i & 7;
    const uint2 w = *reinterpret_cast<const uint2*>(codes + r * 64 + c * 8);
    const uint2 lo = codes_to_bf16(w.x), hi = codes_to_bf16(w.y);
    *reinterpret_cast<uint4*>(tile + r * 128 + ((c ^ (r & 7)) << 4)) = make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

// Keep the P largest (value descending, offset ascending among equal
// values): offsets arrive in ascending order and a newcomer passes only
// strictly smaller values, which is repeated first-argmax selection (the
// TPU kernels' rule). Without a branch: with c[j] = v > tv[j] (the list
// before), slot j takes tv[j - 1] if c[j - 1], else v if c[j], else keeps
// its own; j runs downwards so tv[j - 1] is still the old value. In the
// scan a warp's lanes insert eight rows' scores at once, so an early-out
// (v > tv[P - 1]) diverges on nearly every score (tried: K3 per_bin 8 2.7x
// slower). Level 2's exact path uses it too.
template <int P, typename I>
__device__ __forceinline__ void insert_sorted(float (&tv)[P], I (&ti)[P], float v, I idx) {
#pragma unroll
  for (int j = P - 1; j > 0; --j) {
    const bool above = v > tv[j - 1], here = v > tv[j];
    tv[j] = above ? tv[j - 1] : (here ? v : tv[j]);
    ti[j] = above ? ti[j - 1] : (here ? idx : ti[j]);
  }
  const bool first = v > tv[0];
  tv[0] = first ? v : tv[0];
  ti[0] = first ? idx : ti[0];
}

// (a, ai) before (b, bi): value descending, offset ascending on equal values
__device__ __forceinline__ bool before(float a, int ai, float b, int bi) {
  return a > b || (a == b && ai < bi);
}

// merge this lane's sorted top P with that of lane ^ m: the better of each
// pair (r, P-1-r) holds the top P of both lists as a bitonic sequence,
// which a bitonic network sorts; both lanes end with the same list
template <int P>
__device__ __forceinline__ void merge_lanes(float (&tv)[P], int (&ti)[P], int m) {
  float ov[P];
  int oi[P];
#pragma unroll
  for (int r = 0; r < P; ++r) {
    ov[r] = __shfl_xor_sync(0xffffffffu, tv[r], m);
    oi[r] = __shfl_xor_sync(0xffffffffu, ti[r], m);
  }
#pragma unroll
  for (int r = 0; r < P; ++r) {
    if (!before(tv[r], ti[r], ov[P - 1 - r], oi[P - 1 - r])) {
      tv[r] = ov[P - 1 - r];
      ti[r] = oi[P - 1 - r];
    }
  }
#pragma unroll
  for (int h = P / 2; h > 0; h /= 2) {
#pragma unroll
    for (int r = 0; r < P; ++r) {
      if ((r & h) == 0 && before(tv[r + h], ti[r + h], tv[r], ti[r])) {
        const float fv = tv[r];
        tv[r] = tv[r + h];
        tv[r + h] = fv;
        const int fi = ti[r];
        ti[r] = ti[r + h];
        ti[r + h] = fi;
      }
    }
  }
}

// The lane's top P of each of its two rows of a slab (accumulator element
// (row 16 * warp + lane / 4 + 8i, column 8j + 2 * quad + e) at [4j + 2i +
// e]), the two rows interleaved so their insertions overlap; a lane
// position 2j + e rides as an f32 immediate and becomes its bin column at
// the end. MASKED: columns at or past `live` score -inf.
template <int P, int MODE, bool MASKED, typename Acc>
__device__ __forceinline__ void select_slab(const Acc (&a)[64], float cs, const float (&qs)[2], int live, int quad,
                                            float (&tv)[2][P], int (&ti)[2][P]) {
  float tp[2][P];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < P; ++r) {
      tv[i][r] = -INFINITY;
      tp[i][r] = 0.0f;
    }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v = score<MODE>(a[4 * j + 2 * i + e], cs, qs[i]);
        if (MASKED && 8 * j + 2 * quad + e >= live) v = -INFINITY;
        insert_sorted<P>(tv[i], tp[i], v, static_cast<float>(2 * j + e));
      }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const int c = static_cast<int>(tp[i][r]);
      ti[i][r] = 8 * (c >> 1) + 2 * quad + (c & 1);
    }
}

// Persistent: CTA b takes units b, b + gridDim.x, ...; unit u scores bin
// u / q_blocks against query block u % q_blocks. tq: queries (NQ, D), box
// {128 bytes, query_rows}; tc: corpus (NR, D), box {128 bytes, 128} (K8:
// its codes, box {64 bytes, 128}, no swizzle). A stage: the queries at 0,
// the bin's B operand at A_BYTES (K8: its codes at A_BYTES + BIN_BYTES).
template <int P, int MODE, int SLABS>
__global__ void __launch_bounds__(THREADS, 1)
    scan_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tc, const Params p,
                int units) {
  using Acc = typename std::conditional<MODE == SCAN_INT8, int, float>::type;
  constexpr bool MIXED = MODE == SCAN_MIXED;
  constexpr int STAGES = ring_stages<MODE, SLABS>();
  constexpr int STAGE = stage_bytes<MODE, SLABS>();
  constexpr int QROWS = query_rows<SLABS>();
  constexpr int A_BYTES = CONSUMERS * SLABS * SLAB_BYTES;
  constexpr int K_ELEMS = MODE == SCAN_INT8 ? ROW_BYTES : ROW_BYTES / 2;  // K elements a stage
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled TMA destinations want 1024-byte alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* codes_full = empty + STAGES;  // K8: a stage's codes have landed
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + (MIXED ? CONVERTERS : 0));
      mbar_init(&empty[s], CONSUMERS);
      if (MIXED) mbar_init(&codes_full[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == CONSUMERS) {
    // producer: one thread keeps the ring full, running ahead into the next
    // unit while the consumers select; K8: warps 1-3 convert the codes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int ptid = threadIdx.x - CONSUMERS * 128;
    if (ptid == 0) {
      int it = 0;  // stages loaded so far, over all units
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int q0 = (u % p.q_blocks) * QROWS, r0 = (u / p.q_blocks) * BIN;
        for (int t = 0; t < p.k_steps; ++t, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          uint8_t* st = smem + s * STAGE;
          if (MIXED) {
            mbar_expect_tx(&full[s], A_BYTES);
            tma_load(&tq, st, &full[s], t * K_ELEMS, q0);
            mbar_expect_tx(&codes_full[s], CODE_BYTES);
            tma_load(&tc, st + A_BYTES + BIN_BYTES, &codes_full[s], t * K_ELEMS, r0);
          } else {
            mbar_expect_tx(&full[s], STAGE);
            tma_load(&tq, st, &full[s], t * K_ELEMS, q0);
            tma_load(&tc, st + A_BYTES, &full[s], t * K_ELEMS, r0);
          }
        }
      }
    } else if (MIXED && ptid >= 32) {
      // the stage's bf16 tile is free: the producer reloads a stage's codes
      // only after the consumers released it
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        for (int t = 0; t < p.k_steps; ++t, ++it) {
          const int s = it % STAGES;
          mbar_wait(&codes_full[s], (it / STAGES) & 1);
          uint8_t* st = smem + s * STAGE;
          convert_codes(st + A_BYTES + BIN_BYTES, st + A_BYTES, ptid - 32);
          // the tile was written through the generic proxy; wgmma reads it
          // through the async proxy
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");

  const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5, quad = lane & 3;
  int it = 0;  // stages consumed so far, over all units
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int q0 = (u % p.q_blocks) * QROWS, bin_g = u / p.q_blocks, r0 = bin_g * BIN;
    Acc acc[SLABS][64];
    for (int t = 0; t < p.k_steps; ++t, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t st = smem_u32(smem + s * STAGE);
      const uint32_t a_st = st + warpgroup * SLABS * SLAB_BYTES, b_st = st + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < ROW_BYTES / 32; ++k)  // a unit's first slice overwrites the sums (scale-d = 0)
#pragma unroll
        for (int sl = 0; sl < SLABS; ++sl)
          mma_step(acc[sl], a_st + sl * SLAB_BYTES + 32 * k, b_st + 32 * k, t > 0 || k > 0);
      wgmma_commit();
      // keep this stage's products in flight; the previous stage's are
      // done, so it goes back to the producer
      wgmma_wait<1>();
      if (t > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl) pin(acc[sl]);

    // select each slab's rows, merge over the quads, store
    const float cs = MODE != SCAN_BF16 ? p.bin_scales[bin_g] : 1.0f;
    const int live = min(BIN, p.n_valid - r0);  // columns at or past it are masked
    const int tile = bin_g / p.nb, bin = bin_g % p.nb;
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl) {
      const int row0 = q0 + (warpgroup * SLABS + sl) * 64 + warp * 16 + (lane >> 2);
      float qs[2] = {1.0f, 1.0f};
      if (MODE == SCAN_INT8) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (row0 + 8 * i < p.NQ) qs[i] = p.query_scales[row0 + 8 * i];
      }
      float tv[2][P];
      int ti[2][P];
      if (live >= BIN)
        select_slab<P, MODE, false>(acc[sl], cs, qs, live, quad, tv, ti);
      else
        select_slab<P, MODE, true>(acc[sl], cs, qs, live, quad, tv, ti);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        merge_lanes<P>(tv[i], ti[i], 1);
        merge_lanes<P>(tv[i], ti[i], 2);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row < p.NQ) {
          float* o = p.out + (size_t)row * p.ld_out + (size_t)tile * P * p.nb + bin;
#pragma unroll
          for (int r = 0; r < P; ++r)
            if ((r & 3) == quad) o[(size_t)r * p.nb] = pack_lane(tv[i][r], ti[i][r], 0);
        }
      }
    }
  }
}

// K8's codes: (NR, D) int8 row-major, box {64 codes, 128 rows} laid out as
// they lie (no swizzle: the converters read them), zeros past D
inline bool make_codes_map(CUtensorMap* map, const void* ptr, int D, int NR) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)NR};
  const cuuint64_t strides[1] = {(cuuint64_t)D};
  const cuuint32_t box[2] = {64, BIN};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int P, int MODE, int SLABS>
int launch_scan(const void* q, const void* c, const float* bs, const float* qs, float* out, int NQ, int NR, int D,
                int n_valid, int nb, long long ld_out, cudaStream_t stream) {
  constexpr int bytes = ring_smem_bytes<MODE, SLABS>();
  auto kernel = scan_kernel<P, MODE, SLABS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CUtensorMapDataType type =  // the queries' (and K3's, K7's corpus)
      MODE == SCAN_INT8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tc;
  const bool mapped = make_map(&tq, q, D, NQ, false, type, query_rows<SLABS>()) &&
                      (MODE == SCAN_MIXED ? make_codes_map(&tc, c, D, NR) : make_map(&tc, c, D, NR, false, type, BIN));
  if (!mapped) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.NQ = NQ;
  p.NR = NR;
  p.n_valid = n_valid;
  p.nb = nb;
  p.q_blocks = (NQ + query_rows<SLABS>() - 1) / query_rows<SLABS>();
  p.k_steps = (D * (MODE == SCAN_INT8 ? 1 : 2) + ROW_BYTES - 1) / ROW_BYTES;
  p.ld_out = ld_out;
  p.bin_scales = bs;
  p.query_scales = qs;
  p.out = out;
  const int units = p.q_blocks * (NR / BIN);
  if (units <= 0) return static_cast<int>(cudaSuccess);
  const int grid = units < sm_count() ? units : sm_count();
  kernel<<<grid, THREADS, bytes, stream>>>(tq, tc, p, units);
  return static_cast<int>(cudaGetLastError());
}

// per_bin and the query block (128 queries a unit up to Q = 128, else 256)
template <int MODE>
int launch_mode(const void* q, const void* c, const float* bs, const float* qs, float* out, int NQ, int NR, int D,
                int n_valid, int per_bin, int nb, long long ld_out, cudaStream_t s) {
  const bool wide = NQ > query_rows<1>();
#define MM_SCAN_CASE(P)                                                                    \
  case P:                                                                                  \
    return wide ? launch_scan<P, MODE, 2>(q, c, bs, qs, out, NQ, NR, D, n_valid, nb, ld_out, s) \
                : launch_scan<P, MODE, 1>(q, c, bs, qs, out, NQ, NR, D, n_valid, nb, ld_out, s);
  switch (per_bin) {
    MM_SCAN_CASE(1)
    MM_SCAN_CASE(2)
    MM_SCAN_CASE(4)
    MM_SCAN_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MM_SCAN_CASE
}

}  // namespace scan

// ---- K4: level 2 -----------------------------------------------------------------
//
// Over (NQ, C_pad) level-1 candidates, every W (32 or 128) consecutive
// columns keep their top 8 (value descending, ties to the lowest offset:
// insert_sorted's strict '>'), the offset packed at mantissa bits [7, 14) and
// written rank-major within each 1,024-column block: column blk*(1024/W)*8 +
// rank*(1024/W) + group (matchmaker_tpu _level2_reduce). Output columns from
// C_pad/W*8 to ld_out are -inf (the padding to a multiple of 128).
//
// What bounds it: the bytes, NQ*C_pad*4 read and a quarter (W = 32) or a
// sixteenth (W = 128) of that written: 6.3 us at (256, 16,384), W = 32, and
// 118 us at ColBERT's (8,192, 11,264), W = 128, at 3.35 TB/s. Selecting
// with insert_sorted costs about 40 compare and select instructions a score,
// which at the card's compare/select rate is as long as the bytes (one
// thread a group so, with scalar loads, took 0.0195 and 0.381 ms there on
// an H100; this design 0.0080 and 0.142, 1.3x and 1.2x the bound; PERF.md).
// The design reads coalesced and halves the selection's instructions:
// - a warp takes one (query row, 1024-column block): eight 16-byte loads a
//   lane (512 contiguous bytes a warp instruction) into the warp's own
//   shared-memory rows, one 32-column sub-group a lane, each padded to 36
//   floats so the lanes' 16-byte reads hit distinct banks;
// - each lane selects from its 32 columns by int32 keys: the score's bits
//   made signed-ordered, the low BITS = log2(W) bits replaced by W-1-offset,
//   so a key carries its offset and max/min (IMNMX) order keys by (score,
//   then lower offset); chunks of 8 are sorted by a 19-comparator network
//   and merged into the running top 8 by one bitonic step, which also
//   yields the 9th key (the largest dropped); for W = 128 the four lanes of
//   a quad merge their top 8 with two xor shuffles;
// - keys that agree above their low BITS bits (a near tie: scores within
//   2^-16 relative of each other, equal scores, +0 beside -0) are in
//   offset order (+0's before -0's), which need not be the scores' order
//   (value descending, offset ascending). So the kept list is exact unless
//   two neighbours among the top 8 tie near out of the scores' order, the
//   8th and the 9th key tie near (the run may go on past the 9th), or a
//   kept score is NaN (two -inf are no tie: they are written -inf whatever
//   their offset); then
//   the whole warp selects again by insert_sorted's rule (with
//   scan::merge_lanes for W = 128), so the output stays bit-identical to
//   _level2_plain. Scores of real searches rarely tie near
//   (tests/test_torch_mips_binmax.py emulates both paths);
// - stores: each rank's columns of a block are contiguous, so a warp
//   stores 128 bytes (W = 32) or 256 bytes (W = 128) an instruction, and
//   the warp of a row's last block writes the row's -inf tail columns.
namespace l2 {

constexpr int WARPS = 8;           // warps a CTA, one (query row, block) each
constexpr int SUB = 32;            // columns a lane selects from
constexpr int SUB_STRIDE = SUB + 4;  // floats between sub-groups in shared memory

// the float's bits as an int32 of the same order (-0 just below +0)
__device__ __forceinline__ int ordered(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ void cx(int& a, int& b) {  // a >= b after
  const int hi = max(a, b), lo = min(a, b);
  a = hi;
  b = lo;
}

// descending sort of 8 keys: an optimal 19-comparator network, depth 6
__device__ __forceinline__ void sort8(int (&k)[8]) {
  cx(k[0], k[2]); cx(k[1], k[3]); cx(k[4], k[6]); cx(k[5], k[7]);
  cx(k[0], k[4]); cx(k[1], k[5]); cx(k[2], k[6]); cx(k[3], k[7]);
  cx(k[0], k[1]); cx(k[2], k[3]); cx(k[4], k[5]); cx(k[6], k[7]);
  cx(k[2], k[4]); cx(k[3], k[5]);
  cx(k[1], k[4]); cx(k[3], k[6]);
  cx(k[1], k[2]); cx(k[3], k[4]); cx(k[5], k[6]);
}

// a := the top 8 of sorted a and sorted b, sorted; rej := the largest of
// rej and the keys dropped. The larger of each pair (i, 7 - i) are the top
// 8 as a bitonic sequence, which three half-cleaner stages sort.
__device__ __forceinline__ void merge8(int (&a)[8], const int (&b)[8], int& rej) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int x = a[i], y = b[7 - i];
    a[i] = max(x, y);
    rej = max(rej, min(x, y));
  }
#pragma unroll
  for (int h = 4; h > 0; h /= 2)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if ((i & h) == 0) cx(a[i], a[i + h]);
}

// a key's score bits above its offset, +0's and -0's families made equal
template <int BITS>
__device__ __forceinline__ int high(int key) {
  const int h = key & ~((1 << BITS) - 1);
  return h == -(1 << BITS) ? 0 : h;
}

template <int W>
__global__ void __launch_bounds__(WARPS * 32) level2_kernel(const float* __restrict__ in, float* __restrict__ out,
                                                            int NQ, int nblk, long long ld_in, long long ld_out,
                                                            int tail) {
  constexpr int BITS = W == 32 ? 5 : 7, M = (1 << BITS) - 1;
  constexpr int GROUPS = L2_BLOCK / W, OUT = GROUPS * L2_KEEP;  // groups and output columns a block
  __shared__ __align__(16) float rows[WARPS][SUB * SUB_STRIDE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * WARPS + warp;
  if (item >= (long long)NQ * nblk) return;
  const int q = (int)(item / nblk), blk = (int)(item % nblk);
  float* s = rows[warp];

  // the block's 1024 columns: lane l loads columns 4l + 128i
  const float4* src = reinterpret_cast<const float4*>(in + (size_t)q * ld_in + (size_t)blk * L2_BLOCK);
  float4 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __ldg(src + lane + 32 * i);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(s + (lane / 8 + 4 * i) * SUB_STRIDE + 4 * (lane % 8)) = v[i];
  __syncwarp();

  // this lane's top 8 keys of its sub-group, and the 9th
  const float* mine = s + lane * SUB_STRIDE;
  const int base = W == 32 ? 0 : SUB * (lane & 3);  // the sub-group's first offset in its group
  int a[8], rej = INT_MIN;
#pragma unroll
  for (int c = 0; c < SUB / 8; ++c) {
    const float4 x0 = *reinterpret_cast<const float4*>(mine + 8 * c);
    const float4 x1 = *reinterpret_cast<const float4*>(mine + 8 * c + 4);
    const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    int b[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) b[e] = (ordered(x[e]) | M) - (base + 8 * c + e);
    sort8(b);
    if (c == 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = b[e];
    } else {
      merge8(a, b, rej);
    }
  }
  if (W == 128) {  // the quad's four sub-groups make one group
#pragma unroll
    for (int m = 1; m <= 2; m *= 2) {
      int o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = __shfl_xor_sync(0xffffffffu, a[e], m);
      rej = max(rej, __shfl_xor_sync(0xffffffffu, rej, m));
      merge8(a, o, rej);
    }
  }

  // the kept scores, and whether the keys' order may differ from the scores'
  const float* grp = s + (W == 32 ? lane : lane & ~3) * SUB_STRIDE;  // the group's first sub-group
  constexpr int HIGH_NEG_INF = (int)(0x807fffffu & ~(unsigned)M);    // high<BITS>(key of -inf)
  float kept[8];
  int off[8];
  bool redo = false;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    off[r] = M - (a[r] & M);
    kept[r] = grp[(off[r] / SUB) * SUB_STRIDE + off[r] % SUB];
    redo |= isnan(kept[r]);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {  // inside a run of equal high parts the keys' order need not be the scores'
    const int h = high<BITS>(a[r]);
    if (r < 7)
      redo |= h == high<BITS>(a[r + 1]) && h != HIGH_NEG_INF && !scan::before(kept[r], off[r], kept[r + 1], off[r + 1]);
    else  // the 8th beside the 9th: the run may go on past the 9th
      redo |= h == high<BITS>(rej) && h != HIGH_NEG_INF;
  }
  if (__any_sync(0xffffffffu, redo)) {  // exact: insert_sorted's rule over the scores
    float tv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      tv[r] = -INFINITY;
      off[r] = 0;
    }
#pragma unroll
    for (int j = 0; j < SUB; ++j) scan::insert_sorted<8, int>(tv, off, mine[j], base + j);
    if (W == 128) {
      scan::merge_lanes<8>(tv, off, 1);
      scan::merge_lanes<8>(tv, off, 2);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) kept[r] = tv[r];
  }

  float* dst = out + (size_t)q * ld_out + (size_t)blk * OUT;
  if (W == 32) {
#pragma unroll
    for (int r = 0; r < 8; ++r) dst[r * GROUPS + lane] = pack_lane(kept[r], off[r], 7);
  } else {  // lane 4g + t stores group g's ranks 2t and 2t + 1
    const int t = lane & 3, g = lane >> 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float kv = kept[i];
      int ko = off[i];
#pragma unroll
      for (int u = 1; u < 4; ++u)
        if (t == u) {
          kv = kept[2 * u + i];
          ko = off[2 * u + i];
        }
      dst[(2 * t + i) * GROUPS + g] = pack_lane(kv, ko, 7);
    }
  }
  if (blk == nblk - 1)
    for (int c = lane; c < tail; c += 32) out[(size_t)q * ld_out + (size_t)nblk * OUT + c] = -INFINITY;
}

}  // namespace l2

// ---- K6: unpack -------------------------------------------------------------------
//
// (value, corpus row id) of selected packed candidates (unpack_candidates):
// n elements, each read once (f32 value, int64 column) and written once
// (f32 value, int64 id): 24 bytes an element, 1.8 us at (256, 1000) at
// 3.35 TB/s, so a launch is as short as the card's launch itself (an empty
// kernel at this grid takes about 1 us). The column arithmetic is 32-bit
// (columns are below 2^31): the level-2 block and group by shifts
// (1024/W*8 and 1024/W are powers of two), the tile and bin by one
// multiply-shift division by nb = tile_rows/128 (FastDiv; nb need not be a
// power of two) and a shift by log2(per_bin), since c / (per_bin*nb) =
// (c / nb) / per_bin. Only tile * tile_rows + bin * 128 + lane is 64-bit.
// One element a thread: measured on an H100 against four a thread with
// 16-byte loads and stores (in grids capped at 8 or 16 CTAs an SM, or not
// capped), it was as fast at (256, 1000) and (8,192, 48) and faster at
// (256, 4000).
namespace unpack {

// n / d for 0 <= n < 2^31 by a multiply and a shift (cutlass::FastDivmod's
// round-up method): mul = ceil(2^(31 + l) / d), l = ceil(log2 d); exact
// because the rounding error n * (mul * d - 2^(31 + l)) / 2^(31 + l) stays
// below 1/d
struct FastDiv {
  unsigned mul;
  int shift, d;
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((unsigned)n, mul) >> shift);
  }
};

inline int ceil_log2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

inline FastDiv make_fastdiv(int d) {
  if (d == 1) return {0u, 0, 1};
  const int p = 31 + ceil_log2(d);
  return {(unsigned)(((1ull << p) + (unsigned)d - 1) / (unsigned)d), p - 32, d};
}

struct Geometry {
  FastDiv nb;          // divides by tile_rows / 128
  int per_bin_shift;   // log2(per_bin)
  long long tile_rows;
  int level2_shift;    // log2(1024 / W * 8): the level-2 block of a column
  int group_mask;      // 1024 / W - 1: its group
  int width_shift;     // log2(W); -1 without level 2
  int clear;           // the packed lane bits
};

__device__ __forceinline__ long long row_id(const Geometry& g, float v, int col, float& val) {
  const int bits = __float_as_int(v);
  const bool finite = (bits & 0x7f800000) != 0x7f800000;
  val = finite ? __int_as_float(bits & ~g.clear) : v;
  int rc = col;  // the level-1 column
  if (g.width_shift >= 0)
    rc = ((col >> g.level2_shift) << 10) + ((col & g.group_mask) << g.width_shift) + ((bits >> 7) & 127);
  const int t = g.nb.div(rc), bin = rc - t * g.nb.d;
  return finite ? (long long)(t >> g.per_bin_shift) * g.tile_rows + (bin << 7) + (bits & 127) : -1;
}

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) unpack_kernel(const float* __restrict__ vals,
                                                         const long long* __restrict__ pos,
                                                         float* __restrict__ out_vals,
                                                         long long* __restrict__ out_ids, long long n, Geometry g) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) out_ids[i] = row_id(g, vals[i], (int)pos[i], out_vals[i]);
}

__global__ void empty_kernel() {}

inline unsigned grid(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace unpack

}  // namespace mm

using namespace mm;

extern "C" {

// out (NQ, ld_out) f32: level-1 packed candidates of corpus (NR, D) bf16 for
// queries (NQ, D) bf16 (K3); NR % 128 == 0, D % 32 == 0, per_bin in
// {1, 2, 4, 8}.
int mm_binmax_scan(const void* queries, const void* corpus, void* out, int NQ, int NR, int D, int n_valid,
                   int per_bin, int nb, long long ld_out, void* stream) {
  if (D <= 0 || D % 32 || NR % BIN) return static_cast<int>(cudaErrorInvalidValue);
  return scan::launch_mode<scan::SCAN_BF16>(queries, corpus, nullptr, nullptr, static_cast<float*>(out), NQ, NR,
                                            D, n_valid, per_bin, nb, ld_out, static_cast<cudaStream_t>(stream));
}

// The same over an int8 corpus (NR, D) with bin scales (NR/128) f32: mixed = 1
// takes bf16 queries (K8, D % 32 == 0); mixed = 0 takes int8 query codes with
// their scales (NQ) f32 (K7, D % 64 == 0).
int mm_binmax_scan_int8(const void* queries, const void* corpus, const void* bin_scales, const void* query_scales,
                        void* out, int NQ, int NR, int D, int n_valid, int per_bin, int nb, long long ld_out,
                        int mixed, void* stream) {
  const float* bs = static_cast<const float*>(bin_scales);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % (mixed ? 32 : 64) || NR % BIN) return static_cast<int>(cudaErrorInvalidValue);
  if (!mixed)
    return scan::launch_mode<scan::SCAN_INT8>(queries, corpus, bs, static_cast<const float*>(query_scales), o, NQ,
                                              NR, D, n_valid, per_bin, nb, ld_out, s);
  return scan::launch_mode<scan::SCAN_MIXED>(queries, corpus, bs, nullptr, o, NQ, NR, D, n_valid, per_bin, nb,
                                             ld_out, s);
}

// out (NQ, ld_out) f32: level-2 reduction of in (NQ, ld_in) over c_pad
// columns (c_pad % 1024 == 0), groups of `width` in {32, 128}; columns from
// c_pad / width * 8 to ld_out are written -inf. in, out 16-byte aligned.
int mm_level2(const void* in, void* out, int NQ, int c_pad, int width, long long ld_in, long long ld_out,
              void* stream) {
  const int nblk = c_pad / L2_BLOCK;
  const long long tail = ld_out - (long long)c_pad / width * L2_KEEP;
  if (c_pad <= 0 || c_pad % L2_BLOCK || (width != 32 && width != 128) || tail < 0 || ld_in < c_pad || ld_in % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (NQ <= 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = (unsigned)(((long long)NQ * nblk + l2::WARPS - 1) / l2::WARPS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* i = static_cast<const float*>(in);
  float* o = static_cast<float*>(out);
  if (width == 32)
    l2::level2_kernel<32><<<blocks, l2::WARPS * 32, 0, s>>>(i, o, NQ, nblk, ld_in, ld_out, (int)tail);
  else
    l2::level2_kernel<128><<<blocks, l2::WARPS * 32, 0, s>>>(i, o, NQ, nblk, ld_in, ld_out, (int)tail);
  return static_cast<int>(cudaGetLastError());
}

// vals/pos: n selected candidates (f32, int64 columns below 2^31) -> values,
// int64 corpus rows; tile_rows % 128 == 0, per_bin in {1, 2, 4, 8}, level2
// 0 (none), 32 or 128.
int mm_unpack(const void* vals, const void* pos, void* out_vals, void* out_ids, long long n, int tile_rows,
              int per_bin, int level2, void* stream) {
  if (tile_rows <= 0 || tile_rows % BIN || (per_bin & (per_bin - 1)) || per_bin < 1 || per_bin > 8 ||
      (level2 != 0 && level2 != 32 && level2 != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  unpack::Geometry g;
  g.nb = unpack::make_fastdiv(tile_rows / BIN);
  g.per_bin_shift = unpack::ceil_log2(per_bin);
  g.tile_rows = tile_rows;
  g.level2_shift = level2 ? unpack::ceil_log2(L2_BLOCK / level2 * L2_KEEP) : 0;
  g.group_mask = level2 ? L2_BLOCK / level2 - 1 : 0;
  g.width_shift = level2 ? unpack::ceil_log2(level2) : -1;
  g.clear = level2 ? (127 | (127 << 7)) : 127;
  unpack::unpack_kernel<<<unpack::grid(n), unpack::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const long long*>(pos), static_cast<float*>(out_vals),
      static_cast<long long*>(out_ids), n, g);
  return static_cast<int>(cudaGetLastError());
}

// an empty kernel at mm_unpack's grid for n candidates: the floor the card
// gives that launch (chip_smoke.py and tools/binmax_scan_ab.py time it)
int mm_unpack_floor(long long n, void* stream) {
  unpack::empty_kernel<<<unpack::grid(n), unpack::THREADS, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
