// ColBERT's in-batch MaxSim under training, written for Hopper: the
// training form (all pairs, each row max's doc token saved) and its backward.
//
// Neither has a Pallas counterpart: JAX differentiates its jnp all-pairs
// MaxSim (matchmaker_tpu/ops/maxsim.py:33-47). The serving launches of K14
// (all pairs without tokens, the gathered rescore) stay in
// maxsim_kernels.cu; nothing here is compiled into them.
//
// ---- the training form (mm_maxsim_train) ------------------------------------
// best[r][k] = max_m s(r, k, m), argmax[r][k] its doc token, over the flat
// query rows r = b * Lq + l and docs k, s = q[r] . d[k, m] for a live slot
// (d_mask > 0), `fill` for a masked one; the first of exactly equal maxima,
// -1 where the fill is above every live dot. Then out[b][k] = sum_l w(b,l)
// best[b*Lq+l][k] over l in order, w the query mask, a masked query token
// adding exactly 0 (a second, small kernel).
//
// What bounds it: 6 * Bq*Lq * Bd*Ld * D operations on the tensor cores (three
// TF32 products a multiply-add, below) against a few MB of inputs: compute.
// The design for the in-batch shape (a few hundred query rows against every
// doc of the batch):
// - Products on wgmma (m64nNk8 .tf32, f32 accumulators), both operands
//   K-major in shared memory, 128-byte swizzle. Split TF32 as K14: x = hi +
//   lo, hi the nearest TF32 (ties away from zero), lo the nearest TF32 of x -
//   hi, and q.d = q_lo.d_hi + q_hi.d_lo + q_hi.d_hi a k8 step, small terms
//   first (about 2^-21 of |q||d| left; TF32 alone misses the 1e-4 bar).
// - A CTA is two consumer warpgroups over a tile of 128 query rows (64
//   each: the wgmma's M) and a producer warpgroup; it walks a contiguous
//   range of the (row tile, doc) items, persistent over the doc axis: the
//   grid is one CTA an SM and the items split evenly over it, so the card
//   fills at any batch. The tile's hi and lo stay in shared memory while the
//   CTA walks its docs (resident, split once) when they leave room for two
//   ring slots (D <= 160); wider queries stream their slab beside each doc
//   slab.
// - Docs stream in stages of one chunk of N tokens (N in {64, 104, 128}, the
//   fewest padded columns for Ld: two chunks of 104 for ColBERT's 200) by
//   32 floats of D through a ring of 2-4 slots with full / empty mbarriers.
//   The producer keeps two or three stages' loads in flight in registers,
//   splits each into hi and lo and stores both into a free slot: each
//   element is split once, by one thread. A fence for the async proxy
//   before its arrival.
// - A consumer keeps a stage's products in flight while it waits for the
//   next slot and gives a slot back once the products on it are done; the
//   two consumers run apart, so one's fold overlaps the other's products.
//   At a new row tile the consumers load it themselves, between two
//   barriers of their own.
// - After a chunk each accumulator takes its token's mask and folds into a
//   running row max and token in registers (tokens ascend within a thread,
//   so a strict > keeps the first); after a doc the max goes across the quad
//   by shuffles (equal maxima: the lower token), `fill` applies where the
//   doc has a masked slot, and one lane writes best and the token. Every
//   order is fixed: reruns give identical bits.
//
// ---- the backward (mm_maxsim_bwd) -------------------------------------------
// dq[b,l,:] = w(b,l) sum_k g[b,k] d[k, a(b,l,k), :]  (a >= 0), k in order
// dd[k,m,:] = sum over (b,l) whose token for doc k lies in m's class of
//             g[b,k] w(b,l) q[b,l,:], divided by the class's size
// A class is a doc's live rows equal bit for bit (the ties its products can
// make: a token repeated in a document); its members share the gradient
// evenly, as torch.amax's backward (and JAX's max) does. Bounded by bytes,
// and at these shapes by the gathers through L2 (each (b, l, k) moves one
// row of D floats for dq and one for dd). Two launches, no float atomics:
// 1. a block a doc builds its classes once (a lane-parallel hash of each
//    row; each hash's lowest row from an open-addressed table in shared
//    memory; a row's lead that row when the two are equal in full, else the
//    earlier rows of its hash compared in order) into `info` (lead | size
//    << 16; past 32,767 rows two planes, the lead, -1 - m for a masked row
//    m, and the size); the doc's table is dynamic shared memory sized by
//    Ld (at least 1,024 rows), or, where that would not fit (Ld past
//    8,192), the same arrays in a global workspace; two blocks an SM; the
//    other blocks
//    compute dq, a warp a query
//    row: the row's Bd tokens and weights loaded 32 at a time and broadcast
//    by shuffles, the d rows gathered 16 bytes a lane, sixteen in flight,
//    summed over k in order;
// 2. dd: a block a (doc, range of at most 40 rows, 128 columns); it lists
//    in order the (b, l) whose token's class lead lies in its range (a
//    stable compaction by a block scan) and four groups of 128 threads, a
//    column each, add w q[b,l] into their own copy of the lead's row in
//    shared memory, group g the list's entries from the g-th quarter of each
//    chunk of 1024 (b, l), in order; it writes every row of those classes:
//    the groups' sums added in order g = 0..3 over the class size. A skewed
//    doc (every (b, l) on one token) still spreads over the four groups.
//    The doc's packed classes wait in shared memory beside the sums; past
//    32,767 rows the two planes are read where they lie.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_gemm.cuh"

namespace mm {
namespace msim_train {

using wg::fence_proxy_async;
using wg::make_desc;
using wg::smem_u32;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_wait;

constexpr int CONSUMERS = 2;                  // warpgroups, 64 query rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int PRODUCERS = 128;
constexpr int ROWS = 64 * CONSUMERS;          // query rows of a tile
constexpr int SLAB = 32;                      // floats of D a stage: one 128-byte swizzled row
constexpr int SLAB_BYTES = ROWS * 128;        // a tile's slab, hi or lo
constexpr int MASK_BYTES = 1024;              // a slot's token masks (at most 128 floats), padded
constexpr int MAX_SLOTS = 4;
constexpr int SMEM_MAX = 232448;
constexpr int SMEM_FIXED = 2048;              // alignment slack and the mbarriers

// d (64 x N f32 per warpgroup) = A (64 x 8) . B (8 x N) (+ d when
// accumulate), TF32, both K-major in shared memory (make_desc<false>)
__device__ __forceinline__ void wgmma_tf32_m64n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_m64n104(float (&d)[52], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51}, %52, %53, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]),
        "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_m64n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]),
        "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_tf32_m64n64(d, da, db, accumulate);
  if constexpr (N == 104) wgmma_tf32_m64n104(d, da, db, accumulate);
  if constexpr (N == 128) wgmma_tf32_m64n128(d, da, db, accumulate);
}

struct Params {
  const float* q;       // (rows, D): Bq x Lq query rows
  const float* q_mask;  // (rows)
  const float* d;       // (Bd, Ld, D)
  const float* d_mask;  // (Bd, Ld)
  float* best;          // (rows, Bd)
  int* argmax;          // (rows, Bd)
  float* out;           // (Bq, Bd)
  int Bq, Lq, rows, Bd, Ld, D;
  int slabs, chunks, items, slots;  // ceil(D / 32), ceil(Ld / N), row tiles * Bd, ring slots
  float fill;
};

// the nearest TF32 value, ties away from zero (cvt.rna's rounding), and the
// split x = hi + lo of maxsim_kernels.cu
__device__ __forceinline__ uint32_t tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }
__device__ __forceinline__ void split4(const float4& v, uint4& hi, uint4& lo) {
  hi = make_uint4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
  lo = make_uint4(tf32(v.x - __uint_as_float(hi.x)), tf32(v.y - __uint_as_float(hi.y)),
                  tf32(v.z - __uint_as_float(hi.z)), tf32(v.w - __uint_as_float(hi.w)));
}
// a 16-byte piece (row, piece) of a K-major operand, 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int row, int piece) { return row * 128 + ((piece ^ (row & 7)) << 4); }
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo, int row, int piece, const float4& v) {
  uint4 h, l;
  split4(v, h, l);
  *reinterpret_cast<uint4*>(hi + swz(row, piece)) = h;
  *reinterpret_cast<uint4*>(lo + swz(row, piece)) = l;
}
__device__ __forceinline__ float4 ldg4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ float4 zero4() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

// where a stage of the CTA's walk stands: item (tile, doc k), chunk, slab;
// stepped by compares alone (a division a stage costs as much issue time as
// the stage's split)
struct At {
  int tile, k, chunk, slab;
};
__device__ __forceinline__ At first_stage(const Params& p, long long item) {
  return At{(int)(item / p.Bd), (int)(item % p.Bd), 0, 0};
}
__device__ __forceinline__ At next_stage(const Params& p, At at) {
  if (++at.slab < p.slabs) return at;
  at.slab = 0;
  if (++at.chunk < p.chunks) return at;
  at.chunk = 0;
  if (++at.k < p.Bd) return at;
  at.k = 0;
  ++at.tile;
  return at;
}
// a ring slot and the parity of its current fill
struct Ring {
  int slot = 0, phase = 0;
  __device__ __forceinline__ void step(int slots) {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// a ring slot: doc hi [N][128 B], doc lo, (streaming) the tile's query hi and
// lo [ROWS][128 B], then the chunk's token masks
template <int N, bool RES>
struct Slot {
  static constexpr int Q = 2 * N * 128;
  static constexpr int MASK = Q + (RES ? 0 : 2 * SLAB_BYTES);
  static constexpr int BYTES = MASK + MASK_BYTES;
};

// one stage in the producer's registers between its loads and its split
// into a slot: N doc token rows x 8 pieces (and, streaming, the tile's query
// rows), piece j of a producer thread at index ptid + 128 j; at a chunk's
// last slab the chunk's token masks (the fold reads them from the slot)
template <int N, bool RES>
struct Stage {
  static constexpr int DP = (N * 8 + PRODUCERS - 1) / PRODUCERS;
  static constexpr int QP = ROWS * 8 / PRODUCERS;
  float4 d[DP];
  float4 q[RES ? 1 : QP];
  float mask;

  __device__ __forceinline__ void load(const Params& p, const At& at, int ptid) {
    const int col0 = at.slab * SLAB, tok0 = at.chunk * N;
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      const int i = ptid + PRODUCERS * j, r = i >> 3, col = col0 + (i & 7) * 4, tok = tok0 + r;
      d[j] = (r < N && tok < p.Ld && col < p.D) ? ldg4(p.d + ((size_t)at.k * p.Ld + tok) * p.D + col) : zero4();
    }
    if constexpr (!RES) {
#pragma unroll
      for (int j = 0; j < QP; ++j) {
        const int i = ptid + PRODUCERS * j, row = at.tile * ROWS + (i >> 3), col = col0 + (i & 7) * 4;
        q[j] = (row < p.rows && col < p.D) ? ldg4(p.q + (size_t)row * p.D + col) : zero4();
      }
    }
    if (at.slab == p.slabs - 1) {
      const int tok = tok0 + ptid;
      mask = (ptid < N && tok < p.Ld) ? __ldg(p.d_mask + (size_t)at.k * p.Ld + tok) : 0.0f;
    }
  }
  __device__ __forceinline__ void store(const Params& p, uint8_t* slot, const At& at, int ptid) const {
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      const int i = ptid + PRODUCERS * j;
      if (i < N * 8) store_split(slot, slot + N * 128, i >> 3, i & 7, d[j]);
    }
    if constexpr (!RES) {
#pragma unroll
      for (int j = 0; j < QP; ++j) {
        const int i = ptid + PRODUCERS * j;
        store_split(slot + Slot<N, RES>::Q, slot + Slot<N, RES>::Q + SLAB_BYTES, i >> 3, i & 7, q[j]);
      }
    }
    if (at.slab == p.slabs - 1 && ptid < N) reinterpret_cast<float*>(slot + Slot<N, RES>::MASK)[ptid] = mask;
  }
};

// the resident tile's query rows, every slab split into hi and lo, by the
// 256 consumer threads (ctid), two slabs' loads in flight at a time
__device__ __forceinline__ void load_tile(const Params& p, int tile, uint8_t* qs, int ctid) {
  constexpr int QP = ROWS * 8 / (128 * CONSUMERS);
  for (int s0 = 0; s0 < p.slabs; s0 += 2) {
    float4 v[2][QP];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < QP; ++j) {
        const int i = ctid + 128 * CONSUMERS * j, row = tile * ROWS + (i >> 3), col = (s0 + h) * SLAB + (i & 7) * 4;
        v[h][j] = s0 + h < p.slabs && row < p.rows && col < p.D ? ldg4(p.q + (size_t)row * p.D + col) : zero4();
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < QP; ++j) {
        const int i = ctid + 128 * CONSUMERS * j;
        uint8_t* hi = qs + (s0 + h) * 2 * SLAB_BYTES;
        if (s0 + h < p.slabs) store_split(hi, hi + SLAB_BYTES, i >> 3, i & 7, v[h][j]);
      }
  }
}
// the consumer warpgroups' own barrier (0 is __syncthreads')
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, %0;" ::"n"(128 * CONSUMERS) : "memory"); }

// which of two equal maxima a row keeps: the lower doc token, the fill's -1
// (compared unsigned) after every live token
__device__ __forceinline__ bool before(int a, int b) { return (unsigned)a < (unsigned)b; }

template <int N, bool RES>
__global__ void __launch_bounds__(THREADS, 1) train_kernel(const Params p) {
  using wg::mbar_arrive;
  using wg::mbar_init;
  using wg::mbar_wait;
  using SL = Slot<N, RES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;                                           // RES: [slabs][hi, lo][ROWS][128 B]
  uint8_t* ring = base + (RES ? p.slabs * 2 * SLAB_BYTES : 0);  // [slots][Slot::BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.slots * SL::BYTES);  // a slot is stored
  uint64_t* empty = full + MAX_SLOTS;                                        // every consumer thread is done with it

  const long long i0 = (long long)blockIdx.x * p.items / gridDim.x;
  const long long i1 = (long long)(blockIdx.x + 1) * p.items / gridDim.x;
  const int stages = (int)(i1 - i0) * p.chunks * p.slabs, S = p.slots;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], PRODUCERS);
      mbar_init(&empty[s], 128 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (stages == 0) return;

  if (threadIdx.x >= 128 * CONSUMERS) {
    // producer: a ring of DEPTH stages in registers, each loaded DEPTH - 1
    // stages before it is split into its slot
    constexpr int DEPTH = RES ? 3 : 2;
    const int ptid = threadIdx.x - 128 * CONSUMERS;
    Stage<N, RES> regs[DEPTH];
    At at = first_stage(p, i0), ahead = at;  // the next stage to store, to load
#pragma unroll
    for (int j = 0; j < DEPTH - 1; ++j) {
      if (j < stages) regs[j].load(p, ahead, ptid);
      ahead = next_stage(p, ahead);
    }
    Ring ring_at;
    for (int st0 = 0; st0 < stages; st0 += DEPTH) {
#pragma unroll
      for (int j = 0; j < DEPTH; ++j) {
        const int st = st0 + j;
        if (st < stages) {
          if (st + DEPTH - 1 < stages) regs[(j + DEPTH - 1) % DEPTH].load(p, ahead, ptid);
          ahead = next_stage(p, ahead);
          if (st >= S) mbar_wait(&empty[ring_at.slot], ring_at.phase ^ 1);
          regs[j].store(p, ring + ring_at.slot * SL::BYTES, at, ptid);
          fence_proxy_async();  // written by threads, read by wgmma (the async proxy)
          mbar_arrive(&full[ring_at.slot]);
          ring_at.step(S);
          at = next_stage(p, at);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c holds tile rows [64 c, 64 c + 64)
  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3;
  const uint32_t a_off = (uint32_t)wgi * 64 * 128;
  float acc[N / 2];
  float best[2] = {-INFINITY, -INFINITY};
  int tok[2] = {-1, -1};
  bool dead = false;  // the doc has a masked slot (among this thread's tokens)
  // the resident row tile; the slot of a stage whose products may be in flight
  int tile = -1, pending = -1;
  At at = first_stage(p, i0);
  Ring ring_at;
  for (int st = 0; st < stages; ++st) {
    const int slot = ring_at.slot;
    const At next = next_stage(p, at);
    if (RES && at.tile != tile) {
      // a new row tile: both warpgroups are done with the old one (their
      // products waited for at the last doc's end)
      if (tile >= 0) consumers_sync();
      load_tile(p, at.tile, qs, threadIdx.x);
      fence_proxy_async();
      consumers_sync();
      tile = at.tile;
    }
    mbar_wait(&full[slot], ring_at.phase);
    ring_at.step(S);

    // 4 k8 steps x 3 products into the chunk's accumulators
    uint8_t* sp = ring + slot * SL::BYTES;
    const uint32_t b_hi = smem_u32(sp), b_lo = b_hi + N * 128;
    const uint32_t a_hi = (RES ? smem_u32(qs) + at.slab * 2 * SLAB_BYTES : smem_u32(sp) + SL::Q) + a_off;
    const uint32_t a_lo = a_hi + SLAB_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_tf32<N>(acc, make_desc<false>(a_lo + 32 * kk), make_desc<false>(b_hi + 32 * kk), at.slab | kk);
      wgmma_tf32<N>(acc, make_desc<false>(a_hi + 32 * kk), make_desc<false>(b_lo + 32 * kk), 1);
      wgmma_tf32<N>(acc, make_desc<false>(a_hi + 32 * kk), make_desc<false>(b_hi + 32 * kk), 1);
    }
    wgmma_commit();
    if (at.slab < p.slabs - 1) {
      // keep this stage's products in flight; the previous stage's are done
      wgmma_wait<1>();
      if (pending >= 0) mbar_arrive(&empty[pending]);
      pending = slot;
      at = next;
      continue;
    }
    wgmma_wait<0>();
    wg::fence_regs(acc);
    if (pending >= 0) mbar_arrive(&empty[pending]);
    pending = -1;

    // the chunk is summed over D: each token's mask, the running row max
    const float* mk = reinterpret_cast<const float*>(sp + SL::MASK);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float2 m2 = *reinterpret_cast<const float2*>(mk + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tk = at.chunk * N + 8 * j + 2 * t + e;
        const bool inside = tk < p.Ld, live = inside && (e ? m2.y : m2.x) > 0.0f;
        dead |= inside && !live;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = acc[4 * j + 2 * h + e];
          if (live && v > best[h]) {
            best[h] = v;
            tok[h] = tk;
          }
        }
      }
    }
    mbar_arrive(&empty[slot]);  // its products are done and its masks read
    if (at.chunk == p.chunks - 1) {
      // the doc is done: across the quad, then the fill, then one lane writes
      dead |= __shfl_xor_sync(0xffffffffu, (int)dead, 1) != 0;
      dead |= __shfl_xor_sync(0xffffffffu, (int)dead, 2) != 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = best[h];
        int i = tok[h];
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          const float om = __shfl_xor_sync(0xffffffffu, m, x);
          const int oi = __shfl_xor_sync(0xffffffffu, i, x);
          if (om > m || (om == m && before(oi, i))) {
            m = om;
            i = oi;
          }
        }
        if (dead && p.fill > m) {
          m = p.fill;
          i = -1;
        }
        const int row = at.tile * ROWS + wgi * 64 + warp * 16 + g + 8 * h;
        if (t == 0 && row < p.rows) {
          p.best[(size_t)row * p.Bd + at.k] = m;
          p.argmax[(size_t)row * p.Bd + at.k] = i;
        }
        best[h] = -INFINITY;
        tok[h] = -1;
      }
      dead = false;
    }
    at = next;
  }
}

// out[b][k] = sum_l w(b,l) best[b*Lq+l][k], l in order, a masked token adding 0
__global__ void sum_kernel(const Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.Bq * p.Bd) return;
  const int b = i / p.Bd, k = i - b * p.Bd;
  float sum = 0.0f;
#pragma unroll 8
  for (int l = 0; l < p.Lq; ++l) {  // loads outside the condition: eight in flight
    const float w = __ldg(p.q_mask + (size_t)b * p.Lq + l), m = __ldg(p.best + ((size_t)b * p.Lq + l) * p.Bd + k);
    if (w != 0.0f) sum += m * w;
  }
  p.out[i] = sum;
}

template <int N, bool RES>
cudaError_t launch(const Params& p, int ctas, size_t smem, cudaStream_t stream) {
  auto kernel = train_kernel<N, RES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_kernel<<<(p.Bq * p.Bd + 255) / 256, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

// a ring slot's bytes and the shared memory of a launch with `slots` of
// them (ops/maxsim.py:train_plan computes the same)
inline size_t slot_bytes(int N, bool resident) {
  return (size_t)2 * N * 128 + (resident ? 0 : (size_t)2 * SLAB_BYTES) + MASK_BYTES;
}
inline size_t train_smem(int N, int slabs, bool resident, int slots) {
  return SMEM_FIXED + (resident ? (size_t)slabs * 2 * SLAB_BYTES : 0) + (size_t)slots * slot_bytes(N, resident);
}

}  // namespace msim_train

namespace msim_bwd {

using msim_train::ldg4;

constexpr int THREADS = 256;     // launch 1: classes and dq
constexpr int GROUPS = 4;        // launch 2: column groups of a dd block, each summing its own entries
constexpr int DD_THREADS = 128 * GROUPS;
constexpr int LIST = 1024;       // (b, l) entries a dd block filters at once
constexpr int GATHER = 16;       // rows a thread has in flight (dq, dd) or pieces (the hashes)
constexpr int ROWS_MAX = 40;     // doc rows a dd block owns (a group's sums in shared memory)
constexpr int CLASS_ROWS = 1024; // a doc's class arrays hold at least this many rows
constexpr int PACKED_LD = 32767; // the most rows whose lead and class size share one int
constexpr int SMEM_MAX = 232448;

struct Params {
  const float* q;       // (E, D), E = Bq * Lq
  const float* q_mask;  // (E)
  const float* d;       // (Bd, Ld, D)
  const float* d_mask;  // (Bd, Ld)
  const int* argmax;    // (E, Bd)
  const float* g;       // (Bq, Bd)
  int* info;            // (Bd, Ld): each row's class lead | its size << 16 (0 for a masked row); past
                        // PACKED_LD rows (2, Bd, Ld): the lead (-1 - m for a masked row m), the size
  int* ws;              // the classes' arrays in global memory (Bd docs, class_ints ints each), or null
  float* dq;            // (E, D)
  float* dd;            // (Bd, Ld, D)
  int Bq, Lq, Bd, Ld, D, E, parts, slabs;
  int rows_cap, table;  // a doc's class arrays' rows, its hash table's entries (a power of two)
};

// a doc's class arrays: hash, lead and size (rows_cap each), the table,
// then the live flags (rows_cap bytes)
__host__ __device__ inline int class_rows(int Ld) { return Ld > CLASS_ROWS ? Ld : CLASS_ROWS; }
__host__ __device__ inline int class_table(int Ld) {
  int t = 2 * CLASS_ROWS;
  while (t < 2 * Ld) t *= 2;
  return t;
}
__host__ __device__ inline size_t class_bytes(int Ld) {
  return ((size_t)3 * class_rows(Ld) + class_table(Ld)) * 4 + (size_t)(class_rows(Ld) + 3) / 4 * 4;
}

__device__ __forceinline__ uint32_t mix(float x, int c) {
  return (__float_as_uint(x) ^ ((uint32_t)c * 0x9E3779B1u)) * 0x85EBCA77u;
}

__device__ bool rows_equal(const float* a, const float* b, int D) {
  for (int c = 0; c < D; c += 4) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(a + c)), y = __ldg(reinterpret_cast<const uint4*>(b + c));
    if (x.x != y.x || x.y != y.y || x.z != y.z || x.w != y.w) return false;
  }
  return true;
}

// doc k's classes of bit-equal live rows into p.info, on its class arrays
// at `arrays` (class_bytes(Ld) of shared or global memory)
__device__ __forceinline__ void classes_block(const Params& p, int k, uint8_t* arrays) {
  const int TABLE = p.table;
  uint32_t* hash = reinterpret_cast<uint32_t*>(arrays);
  int* lead = reinterpret_cast<int*>(hash + p.rows_cap);
  int* size = lead + p.rows_cap;
  int* table = size + p.rows_cap;
  bool* live = reinterpret_cast<bool*>(table + TABLE);
  const float* doc = p.d + (size_t)k * p.Ld * p.D;
  for (int m = threadIdx.x; m < p.Ld; m += THREADS) {
    hash[m] = 0u;
    live[m] = p.d_mask[(size_t)k * p.Ld + m] > 0.0f;
  }
  for (int i = threadIdx.x; i < TABLE; i += THREADS) table[i] = -1;
  __syncthreads();
  // a row's hash: the sum of its elements' mixes, a warp's rows m = warp +
  // 8 r, each in chunks of 32 16-byte pieces, GATHER chunks' loads in flight
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, W = THREADS / 32;
  const int pieces = p.D / 4, cpr = (pieces + 31) / 32;
  const int n = (p.Ld - warp + W - 1) / W * cpr;
  for (int i0 = 0; i0 < n; i0 += GATHER) {
    float4 v[GATHER];
#pragma unroll
    for (int j = 0; j < GATHER; ++j) {
      const int i = i0 + j, pc = (i % cpr) * 32 + lane;
      v[j] = i < n && pc < pieces ? ldg4(doc + (size_t)(warp + W * (i / cpr)) * p.D + pc * 4)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < GATHER; ++j) {
      const int i = i0 + j, pc = (i % cpr) * 32 + lane, c = pc * 4;
      if (i >= n) break;
      uint32_t h = pc < pieces ? mix(v[j].x, c) + mix(v[j].y, c + 1) + mix(v[j].z, c + 2) + mix(v[j].w, c + 3) : 0u;
#pragma unroll
      for (int x = 16; x >= 1; x >>= 1) h += __shfl_xor_sync(0xffffffffu, h, x);
      if (lane == 0) hash[warp + W * (i / cpr)] += h;
    }
  }
  __syncthreads();
  // each hash's lowest live row, in an open-addressed table (the lowest by
  // atomicMin: the same whatever the order)
  for (int m = threadIdx.x; m < p.Ld; m += THREADS) {
    if (!live[m]) continue;
    for (int i = hash[m] & (TABLE - 1);; i = (i + 1) & (TABLE - 1)) {
      int cur = table[i];
      if (cur < 0) {
        cur = atomicCAS(&table[i], -1, m);
        if (cur < 0) break;
      }
      if (hash[cur] == hash[m]) {
        atomicMin(&table[i], m);
        break;
      }
    }
  }
  __syncthreads();
  // each live row's first equal row: the lowest row of its hash when the
  // two are equal, else (two rows of one hash that differ) the earlier rows
  // compared in order
  for (int m = threadIdx.x; m < p.Ld; m += THREADS) {
    int first = m;
    if (live[m]) {
      int c = m;
      for (int i = hash[m] & (TABLE - 1); table[i] >= 0; i = (i + 1) & (TABLE - 1))
        if (hash[table[i]] == hash[m]) {
          c = table[i];
          break;
        }
      const float* row = doc + (size_t)m * p.D;
      if (c != m && rows_equal(doc + (size_t)c * p.D, row, p.D)) {
        first = c;
      } else if (c != m) {
        for (int m2 = c + 1; m2 < m; ++m2)
          if (live[m2] && hash[m2] == hash[m] && rows_equal(doc + (size_t)m2 * p.D, row, p.D)) {
            first = m2;
            break;
          }
      }
    }
    lead[m] = first;
    size[m] = live[m] && first == m ? 1 : 0;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < p.Ld; m += THREADS)
    if (lead[m] != m) atomicAdd(&size[lead[m]], 1);  // integer counts: any order gives the same
  __syncthreads();
  const size_t plane = (size_t)p.Bd * p.Ld;
  for (int m = threadIdx.x; m < p.Ld; m += THREADS) {
    if (p.Ld <= PACKED_LD) {
      p.info[(size_t)k * p.Ld + m] = lead[m] | (size[lead[m]] << 16);
    } else {
      p.info[(size_t)k * p.Ld + m] = live[m] ? lead[m] : -1 - m;
      p.info[plane + (size_t)k * p.Ld + m] = size[lead[m]];
    }
  }
}

// dq rows [8 blk, 8 blk + 8), a warp each
__device__ void dq_block(const Params& p, int blk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blk * (THREADS / 32) + warp;
  if (e >= p.E) return;
  const int b = e / p.Lq;
  const float wq = p.q_mask[e];
  const int* a_row = p.argmax + (size_t)e * p.Bd;
  const float* g_row = p.g + (size_t)b * p.Bd;
  for (int c0 = 0; c0 < p.D; c0 += 128) {
    const int col = c0 + 4 * lane;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (wq != 0.0f) {
      for (int k0 = 0; k0 < p.Bd; k0 += 32) {
        const int kl = k0 + lane;
        const int a_l = kl < p.Bd ? __ldg(a_row + kl) : -1;
        const float w_l = kl < p.Bd ? __ldg(g_row + kl) * wq : 0.0f;
        const int n = min(32, p.Bd - k0);
        for (int j0 = 0; j0 < n; j0 += GATHER) {
          // GATHER rows in flight, then added in order k
          int a[GATHER];
          float w[GATHER];
          float4 v[GATHER];
#pragma unroll
          for (int j = 0; j < GATHER; ++j) {
            a[j] = __shfl_sync(0xffffffffu, a_l, (j0 + j) & 31);
            w[j] = __shfl_sync(0xffffffffu, w_l, (j0 + j) & 31);
            if (j0 + j >= n) a[j] = -1;
            v[j] = a[j] >= 0 && col < p.D ? ldg4(p.d + ((size_t)(k0 + j0 + j) * p.Ld + a[j]) * p.D + col)
                                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
#pragma unroll
          for (int j = 0; j < GATHER; ++j)
            if (a[j] >= 0) {
              acc.x += w[j] * v[j].x;
              acc.y += w[j] * v[j].y;
              acc.z += w[j] * v[j].z;
              acc.w += w[j] * v[j].w;
            }
        }
      }
    }
    if (col < p.D) *reinterpret_cast<float4*>(p.dq + (size_t)e * p.D + col) = acc;
  }
}

// GLOBAL: the class arrays in p.ws (a doc's too large for shared memory)
template <bool GLOBAL>
__global__ void __launch_bounds__(THREADS, 2) classes_dq_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t class_smem[];
  if ((int)blockIdx.x < p.Bd)
    classes_block(p, blockIdx.x,
                  GLOBAL ? reinterpret_cast<uint8_t*>(p.ws) + blockIdx.x * class_bytes(p.Ld) : class_smem);
  else
    dq_block(p, blockIdx.x - p.Bd);
}

// dd rows of doc k whose class lead lies in [m0, m1), columns [128 s, +128).
// The block's four groups of 128 threads (a column each) sum the entries of
// each LIST chunk's four quarters apart (group g: entries [256 g, 256 g +
// 256) of the chunk, in order, into its own rows), and a row's dd is the
// groups' sums added in order g = 0..3: skewed tokens (every (b, l) on one
// row) still spread over four groups, and the order is fixed
// WIDE: a doc past PACKED_LD rows, its leads and sizes in info's two
// planes, read where they lie; else each row's lead | size << 16, the doc's
// copied into shared memory first
template <bool WIDE>
__global__ void __launch_bounds__(DD_THREADS) dd_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int per_doc = p.parts * p.slabs;
  const int k = blockIdx.x / per_doc, r = (blockIdx.x % per_doc) / p.slabs, s = blockIdx.x % p.slabs;
  const int m0 = (int)((long long)r * p.Ld / p.parts), m1 = (int)((long long)(r + 1) * p.Ld / p.parts);
  const int rows = m1 - m0, tid = threadIdx.x, grp = tid >> 7, col = s * 128 + (tid & 127);
  const int warp = tid >> 5, lane = tid & 31;
  const bool active = col < p.D;
  float* acc = reinterpret_cast<float*>(smem);                            // [GROUPS][rows][128]
  int* info = reinterpret_cast<int*>(acc + GROUPS * rows * 128);          // [Ld] (not WIDE)
  int* l_e = info + (WIDE ? 0 : p.Ld);                                    // [LIST] the listed (b, l)
  int* l_r = l_e + LIST;                                                  // [LIST] their rows in acc
  float* l_w = reinterpret_cast<float*>(l_r + LIST);                      // [LIST] their weights
  int* warp_n = reinterpret_cast<int*>(l_w + LIST);                       // [DD_THREADS / 32]
  float* my = acc + grp * rows * 128 + (tid & 127);
  const int* leads = p.info + (size_t)k * p.Ld;                           // WIDE: the leads' plane
  const int* sizes = leads + (size_t)p.Bd * p.Ld;                         // WIDE: the sizes' plane
  for (int i = tid; i < GROUPS * rows * 128; i += DD_THREADS) acc[i] = 0.0f;
  if (!WIDE)
    for (int m = tid; m < p.Ld; m += DD_THREADS) info[m] = p.info[(size_t)k * p.Ld + m];
  __syncthreads();

  constexpr int PER = LIST / DD_THREADS;  // consecutive entries a thread filters
  constexpr int WARPS = DD_THREADS / 32;
  for (int e0 = 0; e0 < p.E; e0 += LIST) {
    int row[PER], a[PER];
    float w[PER];
    int n = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {  // every load first
      const int e = e0 + tid * PER + j;
      a[j] = e < p.E ? __ldg(p.argmax + (size_t)e * p.Bd + k) : -1;
      w[j] = e < p.E ? __ldg(p.g + (size_t)(e / p.Lq) * p.Bd + k) * __ldg(p.q_mask + e) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      row[j] = -1;
      if (a[j] >= 0 && a[j] < p.Ld && w[j] != 0.0f) {
        if constexpr (WIDE) {
          const int ld = leads[a[j]];  // a masked row's is negative
          if (ld >= m0 && ld < m1) row[j] = ld - m0;
        } else {
          const int inf = info[a[j]], ld = inf & 0xFFFF;
          if ((inf >> 16) > 0 && ld >= m0 && ld < m1) row[j] = ld - m0;
        }
      }
      n += row[j] >= 0;
    }
    // the list's order is the entries' order: an exclusive scan over the
    // block; group g's entries are the list's positions [first of warp 4 g,
    // first of warp 4 g + 4)
    int incl = n;
#pragma unroll
    for (int x = 1; x < 32; x <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, x);
      if (lane >= x) incl += o;
    }
    if (lane == 31) warp_n[warp] = incl;
    __syncthreads();
    int pos = incl - n, first = 0, last = 0;
    for (int w2 = 0; w2 < WARPS; ++w2) {
      if (w2 < warp) pos += warp_n[w2];
      if (w2 < 4 * grp) first += warp_n[w2];
      if (w2 < 4 * grp + 4) last += warp_n[w2];
    }
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (row[j] >= 0) {
        l_e[pos] = e0 + tid * PER + j;
        l_r[pos] = row[j];
        l_w[pos] = w[j];
        ++pos;
      }
    __syncthreads();
    if (active) {
      int i = first;
      for (; i + GATHER <= last; i += GATHER) {  // GATHER q rows in flight, then added in order
        float v[GATHER];
#pragma unroll
        for (int j = 0; j < GATHER; ++j) v[j] = __ldg(p.q + (size_t)l_e[i + j] * p.D + col);
#pragma unroll
        for (int j = 0; j < GATHER; ++j) my[l_r[i + j] * 128] += l_w[i + j] * v[j];
      }
      for (; i < last; ++i) my[l_r[i] * 128] += l_w[i] * __ldg(p.q + (size_t)l_e[i] * p.D + col);
    }
    __syncthreads();  // the list is consumed before the next one is written
  }
  if (!active) return;
  // group g writes rows m = g, g + 4, ...: the lead's groups' sums in order over its class's size
  for (int m = grp; m < p.Ld; m += GROUPS) {
    int ld, size;
    if constexpr (WIDE) {
      ld = leads[m] >= 0 ? leads[m] : -1 - leads[m];  // a masked row: itself, its size 0
      size = sizes[m];
    } else {
      const int inf = info[m];
      ld = inf & 0xFFFF;
      size = inf >> 16;
    }
    if (ld < m0 || ld >= m1) continue;
    const float* row = acc + (ld - m0) * 128 + (tid & 127);
    float v = row[0];
#pragma unroll
    for (int g2 = 1; g2 < GROUPS; ++g2) v += row[g2 * rows * 128];
    p.dd[((size_t)k * p.Ld + m) * p.D + col] = size > 0 ? v / (float)size : 0.0f;
  }
}

// dd's shared memory: the groups' sums, the doc's packed classes (not
// past PACKED_LD rows), the list
inline size_t dd_smem(int Ld, int parts) {
  const int rows = (Ld + parts - 1) / parts;
  return (size_t)GROUPS * rows * 128 * 4 + (Ld > PACKED_LD ? 0 : (size_t)Ld * 4) + (size_t)LIST * 12 +
         (size_t)DD_THREADS / 32 * 4;
}

}  // namespace msim_bwd
}  // namespace mm

extern "C" {

// the training form: out (Bq, Bd) f32 and argmax (Bq, Lq, Bd) int32 (each
// row max's doc token: the first of exactly equal maxima, -1 where the fill
// is the max) of q (Bq, Lq, D), q_mask (Bq, Lq), docs (Bd, Ld, D) and d_mask
// (Bd, Ld), all f32; best (Bq, Lq, Bd) f32 scratch. The plan (chunk in {64,
// 104, 128}, resident, ring slots, ctas) comes from ops/maxsim.py:train_plan.
// D % 8 == 0, D <= 2048, Lq >= 1, Ld >= 1.
int mm_maxsim_train(const void* q, const void* q_mask, const void* d, const void* d_mask, void* best, void* out,
                    void* argmax, int Bq, int Lq, int Bd, int Ld, int D, int chunk, int resident, int slots,
                    int ctas, float fill, void* stream) {
  namespace tr = mm::msim_train;
  if (D < 8 || D % 8 || D > 2048 || Lq < 1 || Ld < 1 || ctas < 1 ||
      (chunk != 64 && chunk != 104 && chunk != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Bq <= 0 || Bd <= 0) return static_cast<int>(cudaSuccess);
  tr::Params p;
  p.q = static_cast<const float*>(q);
  p.q_mask = static_cast<const float*>(q_mask);
  p.d = static_cast<const float*>(d);
  p.d_mask = static_cast<const float*>(d_mask);
  p.best = static_cast<float*>(best);
  p.argmax = static_cast<int*>(argmax);
  p.out = static_cast<float*>(out);
  p.Bq = Bq;
  p.Lq = Lq;
  p.Bd = Bd;
  p.Ld = Ld;
  p.D = D;
  const long long rows = (long long)Bq * Lq, items = (rows + tr::ROWS - 1) / tr::ROWS * Bd;
  if (rows > 0x7fffffffLL || items > 0x7fffffffLL || (long long)Bq * Bd > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  p.rows = (int)rows;
  p.items = (int)items;
  p.slabs = (D + tr::SLAB - 1) / tr::SLAB;
  p.chunks = (Ld + chunk - 1) / chunk;
  p.fill = fill;
  if ((long long)p.chunks * p.slabs * ((items + ctas - 1) / ctas) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  p.slots = slots;
  const size_t smem = tr::train_smem(chunk, p.slabs, resident != 0, slots);
  if (slots < 2 || slots > tr::MAX_SLOTS || smem > (size_t)tr::SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = ctas < p.items ? ctas : p.items;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (chunk == 64)
    err = resident ? tr::launch<64, true>(p, grid, smem, s) : tr::launch<64, false>(p, grid, smem, s);
  else if (chunk == 104)
    err = resident ? tr::launch<104, true>(p, grid, smem, s) : tr::launch<104, false>(p, grid, smem, s);
  else
    err = resident ? tr::launch<128, true>(p, grid, smem, s) : tr::launch<128, false>(p, grid, smem, s);
  return static_cast<int>(err);
}

// the global workspace mm_maxsim_bwd needs for Bd docs of Ld rows: 0 where
// a doc's class arrays fit shared memory
long long mm_maxsim_bwd_ws_bytes(int Bd, int Ld) {
  namespace bw = mm::msim_bwd;
  return Bd < 1 || Ld < 1 || bw::class_bytes(Ld) <= (size_t)bw::SMEM_MAX ? 0
                                                                       : (long long)Bd * bw::class_bytes(Ld);
}

// dq (Bq, Lq, D) and dd (Bd, Ld, D) f32 from g (Bq, Bd) and the argmax of
// mm_maxsim_train over the same q, q_mask, docs and d_mask; info (Bd, Ld)
// int32 scratch, (2, Bd, Ld) past 32,767 doc tokens; ws
// mm_maxsim_bwd_ws_bytes(Bd, Ld) bytes of scratch (or
// null where that is 0); `parts` row ranges a doc's dd is cut into
// (ops/maxsim.py:bwd_plan). D % 8 == 0, D <= 2048, Lq >= 1, Ld >= 1.
int mm_maxsim_bwd(const void* q, const void* q_mask, const void* d, const void* d_mask, const void* argmax,
                  const void* g, void* info, void* ws, void* dq, void* dd, int Bq, int Lq, int Bd, int Ld, int D,
                  int parts, void* stream) {
  namespace bw = mm::msim_bwd;
  if (D < 8 || D % 8 || D > 2048 || Lq < 1 || Ld < 1 || parts < 1 || parts > Ld ||
      (Ld + parts - 1) / parts > bw::ROWS_MAX || (ws == nullptr && mm_maxsim_bwd_ws_bytes(Bd, Ld) > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Bq <= 0 || Bd <= 0) return static_cast<int>(cudaSuccess);
  bw::Params p;
  p.q = static_cast<const float*>(q);
  p.q_mask = static_cast<const float*>(q_mask);
  p.d = static_cast<const float*>(d);
  p.d_mask = static_cast<const float*>(d_mask);
  p.argmax = static_cast<const int*>(argmax);
  p.g = static_cast<const float*>(g);
  p.info = static_cast<int*>(info);
  p.ws = static_cast<int*>(ws);
  p.dq = static_cast<float*>(dq);
  p.dd = static_cast<float*>(dd);
  p.Bq = Bq;
  p.Lq = Lq;
  p.Bd = Bd;
  p.Ld = Ld;
  p.D = D;
  p.parts = parts;
  p.slabs = (D + 127) / 128;
  p.rows_cap = bw::class_rows(Ld);
  p.table = bw::class_table(Ld);
  const long long E = (long long)Bq * Lq;
  const long long blocks1 = Bd + (E + bw::THREADS / 32 - 1) / (bw::THREADS / 32);
  const long long blocks2 = (long long)Bd * parts * p.slabs;
  if (E > 0x7fffffffLL || blocks1 > 0x7fffffffLL || blocks2 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  p.E = (int)E;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mm_maxsim_bwd_ws_bytes(Bd, Ld) > 0) {
    bw::classes_dq_kernel<true><<<(unsigned)blocks1, bw::THREADS, 0, s>>>(p);
  } else {
    const size_t smem1 = bw::class_bytes(Ld);
    err = cudaFuncSetAttribute(bw::classes_dq_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem1);
    if (err != cudaSuccess) return static_cast<int>(err);
    bw::classes_dq_kernel<false><<<(unsigned)blocks1, bw::THREADS, smem1, s>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = bw::dd_smem(Ld, parts);
  auto dd_fn = Ld > bw::PACKED_LD ? bw::dd_kernel<true> : bw::dd_kernel<false>;
  err = cudaFuncSetAttribute(dd_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dd_fn<<<(unsigned)blocks2, bw::DD_THREADS, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
