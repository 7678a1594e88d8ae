// A Hopper GEMM for the encoder's bf16 products: TMA fills a ring of
// shared-memory stages, signalled through mbarriers; one producer warpgroup
// (a single thread issues the copies) and two consumer warpgroups that run
// wgmma.mma_async (bf16 in, f32 accumulate) on 64 rows of a 128 x 128 output
// tile each. One CTA per SM walks over the output tiles (persistent), so the
// next tile's loads overlap this one's epilogue. The GEMM kernel serves the
// bf16 forward halves (K1's QKV and Wo, K2's W1 and W2, encoder_kernels.cu,
// with a bias, gelu or bias + residual epilogue) and the backward of the
// fused halves (K11, K12); the int8 forward halves (K9, K10,
// encoder_int8_kernels.cu) build their own kernels from the pieces here
// (mbarriers, TMA, descriptors, the s8 wgmma below, tensor maps of int8
// codes), and so do the probes' K15 and K16 (probe_attn_inner.cu: the
// m64n64 forms with A from shared memory or from registers;
// probe_int8_matmul.cu: the epilogue through shared memory by TMA store,
// which none of the GEMMs here uses yet; probe_mlp_rows.cu: a thread-block
// cluster exchanging tiles through distributed shared memory, with the
// cluster pieces and the m64n64 / m64n192 forms with B MN-major below).
//
// Operands are bf16 and row-major in device memory. Each may be read
//   K-major:  stored (rows, K), K contiguous: one TMA box {64, 128} a stage,
//             the 128-byte swizzled rows wgmma reads untransposed;
//   MN-major: stored (K, rows), rows contiguous: two TMA boxes {64, 64} a
//             stage (64 columns each), read by wgmma's transposed (MN-major)
//             shared-memory form, so no transpose pass exists.
// So C = A . B^T (both K-major: dx, da, dacc.W2^T), A . B with B (K, N)
// (x.W1 for gelu', and every forward product: the weights are stored
// (K, N) and read MN-major where they lie), and A^T . B contracting the
// rows of two row-major matrices (the weight gradients) are one kernel
// template. A second operand pair with its own accumulator (DUAL) fuses the
// two products that meet in dz = (dacc.W2^T) * gelu'(x.W1 + b1): the f32
// gelu' never reaches device memory.
//
// Ragged edges: TMA fills rows and columns past the tensor's extent with
// zeros, so M, N and K need no multiple of the tile; the epilogue masks its
// stores. A split-K launch gives each split one range of K tiles and its
// own f32 partial; the wrapper sums the partials in a fixed order
// (no float atomics, no TMA reduce-add), so a gradient is bit-identical run
// to run.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_common.cuh"

namespace mm {
namespace wg {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int CONSUMERS = 2;                       // warpgroups, 64 rows of C each
constexpr int THREADS = 128 * (CONSUMERS + 1);     // + the producer warpgroup
constexpr int OPERAND_BYTES = BM * BK * 2;         // one operand's stage (BN == BM): 16 KB
constexpr int CHUNK_BYTES = 64 * 128;              // 64 rows of 128 bytes

// backward: EPI_BF16 .. EPI_GELU_DZ; forward: the last three, each adding
// the (N) f32 bias to the product first
enum Epilogue : int {
  EPI_BF16 = 0,
  EPI_RESID_BF16 = 1,
  EPI_F32 = 2,
  EPI_GELU_DZ = 3,
  EPI_BIAS_BF16 = 4,       // bf16(product + bias)                  (K1's QKV)
  EPI_BIAS_GELU_BF16 = 5,  // bf16(gelu_poly(product + bias))       (K2's W1)
  EPI_BIAS_RESID_F32 = 6,  // f32((resid + bias) + product)         (K1's Wo, K2's W2)
};

struct Params {
  int M, N, K;              // C (M, N); K the contraction length
  int k_tiles_per_split;    // split z contracts K tiles [z * this, (z + 1) * this)
  void* C;                  // bf16 (M, N), or f32 (M, N) per split for EPI_F32, f32 for EPI_BIAS_RESID_F32
  const float* aux;         // EPI_RESID_BF16: (M, N) f32 added to the product
  const float* bias;        // (N) f32: b1 for EPI_GELU_DZ, the forward epilogues' bias
  const __nv_bfloat16* resid;  // EPI_BIAS_RESID_F32: (M, N) bf16, the half's input x
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA -------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// one operand's stage: K-major, box {64 (K), 128 rows} at (k0, r0); MN-major,
// boxes {64 rows, 64 (K)} at (r0 + 64c, k0) into 64-row chunks
template <bool MN>
__device__ __forceinline__ void load_operand(const CUtensorMap* map, uint8_t* dst, uint64_t* bar, int r0, int k0) {
  if (MN) {
    tma_load(map, dst, bar, r0, k0);
    tma_load(map, dst + CHUNK_BYTES, bar, r0 + 64, k0);
  } else {
    tma_load(map, dst, bar, k0, r0);
  }
}

// ---- wgmma -----------------------------------------------------------------
// shared-memory matrix descriptor, 128-byte swizzle. K-major: rows 128 bytes
// apart, 8-row groups 1024 bytes apart (SBO). MN-major: 8-row K groups 1024
// bytes apart (SBO), 64-wide MN chunks CHUNK_BYTES apart (LBO).
__device__ __forceinline__ uint64_t desc_field(uint32_t x) { return (uint64_t)((x & 0x3FFFF) >> 4); }
template <bool MN>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return desc_field(addr) | (desc_field(MN ? CHUNK_BYTES : 16) << 16) | (desc_field(1024) << 32) | (1ull << 62);
}
// byte offset of the k-th 16-deep slice of a stage operand
template <bool MN>
__device__ __forceinline__ uint32_t k_step(int k) {
  return MN ? k * 16 * 128 : k * 32;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (64 x 128 f32 per warpgroup) += A (64 x 16) . B (16 x 128)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %66, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}

// d (64 x 128 s32 per warpgroup) = A (64 x 32) . B (32 x 128) (+ d when
// accumulate), s8 x s8 codes, both K-major in shared memory (for 8-bit types
// wgmma takes no transposed form); every sum is exact in int32. The operands
// come as shared-memory addresses: the asm builds their K-major descriptors
// (make_desc<false>) itself, so no 64-bit descriptor stays live in
// registers beside up to 192 accumulators
__device__ __forceinline__ void wgmma_m64n128_s8(int (&d)[64], uint32_t a_addr, uint32_t b_addr, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 la, lb, hi;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "bfe.u32 la, %64, 4, 14;\nbfe.u32 lb, %65, 4, 14;\n"
      "or.b32 la, la, 0x10000;\nor.b32 lb, lb, 0x10000;\n"  // leading byte offset 16
      "mov.b32 hi, 0x40000040;\n"                               // stride 1024 bytes, 128-byte swizzle
      "mov.b64 da, {la, hi};\nmov.b64 db, {lb, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, da, db, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a_addr), "r"(b_addr), "r"(accumulate));
}

// pin accumulator registers after a wgmma.wait_group: the compiler may not
// move their reads above this point
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64 f32 per warpgroup) = A (64 x 16) . B (16 x 64) (+ d when
// accumulate), bf16 in shared memory: A K-major (make_desc<false>), B
// K-major, or MN-major when TB (make_desc<true>)
template <int TB = 0>
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// d (64 x 64 f32 per warpgroup) = A (64 x 16 bf16, in registers) . B (16 x
// 64) (+ d when accumulate), B MN-major in shared memory (make_desc<true>).
// A's fragment is the
// m64nNk16 accumulator's layout over 16 of its columns: a[0] = (row
// 16 w + lane/4, columns 2 (lane%4) + {0, 1}), a[1] the same 8 rows on,
// a[2] and a[3] the same 8 columns on, each a bf16 pair
__device__ __forceinline__ void wgmma_m64n64_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 192 f32 per warpgroup) = A (64 x 16) . B (16 x 192) (+ d when
// accumulate), bf16; A K-major (make_desc<false>), B MN-major
// (make_desc<true>: three 64-wide chunks CHUNK_BYTES apart) in shared memory
__device__ __forceinline__ void wgmma_m64n192_ss_tb(float (&d)[96], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, "
      "%81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---- thread-block clusters ---------------------------------------------------
// The CTAs of a cluster run at once on neighbouring SMs. Each reaches the
// others' shared memory (distributed shared memory) through shared::cluster
// addresses from mapa: it arrives on their mbarriers, stores into their
// buffers, copies a buffer of its own into theirs (cp.async.bulk, the bytes
// completing on the receiver's mbarrier), and one TMA load it issues can
// land at the same offset in several CTAs (multicast), completing on each
// one's mbarrier at the same offset. Remote arrivals keep the default
// (CTA-scope) release and are waited on with mbar_wait, as CUTLASS's
// cluster pipelines do: on an H100 a release at cluster scope on each of
// them made K17 2x slower (2.28 against 1.14 ms at 51,200 rows).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  return rank;
}
// every thread of every CTA in the cluster: what each wrote before it (to
// its own or another CTA's shared memory) is seen by every read after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}
// the shared::cluster address of this CTA's shared-memory location p in CTA rank
__device__ __forceinline__ uint32_t map_to_rank(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}
// arrive on an mbarrier of any CTA of the cluster (a shared::cluster address)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}
// one TMA box into dst's offset in every CTA of mask (bit i: cluster rank i),
// its bytes completing on the mbarrier at bar's offset in each
__device__ __forceinline__ void tma_load_multicast(const CUtensorMap* map, void* dst, uint64_t* bar, int c0, int c1,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1, {%3, %4}], [%2], %5;" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}
// bytes (a multiple of 16) of this CTA's shared memory at src into another
// CTA's at the shared::cluster address dst, completing on its mbarrier bar
// (a shared::cluster address); src must have been fenced for the async
// proxy (fence_proxy_async) by the threads that wrote it
__device__ __forceinline__ void bulk_copy_to_cluster(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   dst),
               "r"(smem_u32(src)), "r"(bytes), "r"(bar)
               : "memory");
}

// a consumer warpgroup's own named barrier (ids 0 and 1 are taken elsewhere)
__device__ __forceinline__ void warpgroup_sync(int warpgroup) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + warpgroup) : "memory");
}

// two floats as a bf16 pair (round to nearest), lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- TMA stores: an epilogue through shared memory -------------------------
// The tile goes to shared memory in the 128-byte-swizzled layout of the
// store's boxes (rows of 128 bytes, the 16-byte chunk c of row r at chunk
// c ^ (r % 8), boxes 1024-byte aligned); every writing thread fences its
// writes for the async proxy and the writers meet at a barrier; then one
// thread issues the boxes and commits them as a bulk group. Before the
// buffer is written again, that thread waits until the group has been read
// (tma_store_wait_read), and before the CTA ends until it is done. Rows and
// columns past the tensor map's extent are not written.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_store_commit() { asm volatile("cp.async.bulk.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// a warpgroup's 64 x 128 accumulator of 4-byte values (wgmma m64n128
// layout: element (row 16 warp + lane/4 + 8i, column 8j + 2 (lane%4) + e)
// at [4j + 2i + e]) into four swizzled boxes of 64 rows x 32 columns, box b
// holding columns [32b, 32b + 32) at buf + 8192 b; each 8-byte pair lands
// so that a warp's stores of one j fill every bank twice
template <typename T>
__device__ __forceinline__ void stage_acc_m64n128(uint8_t* buf, const T (&acc)[64], int warp, int lane) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = warp * 16 + (lane >> 2) + 8 * i;
      const int byte = 32 * (j & 3) + 8 * (lane & 3);  // within the box's 128-byte row
      uint8_t* dst = buf + (j >> 2) * 8192 + row * 128 + ((((byte >> 4) ^ (row & 7))) << 4) + (byte & 15);
      T pair[2] = {acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]};
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(pair);
    }
}

// one 16-deep slice of the stage: A rows [64c, 64c + 64), all 128 B columns
template <bool A_MN, bool B_MN>
__device__ __forceinline__ void mma_slice(float (&d)[64], uint32_t a_stage, uint32_t b_stage, int consumer, int k) {
  const uint64_t da = make_desc<A_MN>(a_stage + consumer * CHUNK_BYTES + k_step<A_MN>(k));
  const uint64_t db = make_desc<B_MN>(b_stage + k_step<B_MN>(k));
  wgmma_m64n128<A_MN ? 1 : 0, B_MN ? 1 : 0>(d, da, db);
}

// d/dz gelu with the FMA-only erf polynomial of the bf16 forward
// (matchmaker_tpu/ops/fused_backward.py:_gelu_grad_poly): Phi(z) + z.phi(z)
__device__ __forceinline__ float gelu_grad_poly(float z) {
  const float u = z * 0.7071067811865476f;
  const float uc = fminf(fmaxf(u, -3.4f), 3.4f);
  const float v = uc * uc;
  float p = 1.2036946e-08f;
  p = p * v + -7.4665718e-07f;
  p = p * v + 2.0221069e-05f;
  p = p * v + -0.00031579041f;
  p = p * v + 0.0031725222f;
  p = p * v + -0.021726243f;
  p = p * v + 0.10513879f;
  p = p * v + -0.37025923f;
  p = p * v + 1.1268175f;
  return 0.5f * (1.0f + p * uc) + z * (0.3989422804014327f * expf(-0.5f * z * z));
}

// a stage holds A and B (and A2, B2 for DUAL): a ring of 160 or 192 KB
template <bool DUAL>
__host__ __device__ constexpr int stages() {
  return DUAL ? 3 : 5;
}
template <bool DUAL>
__host__ __device__ constexpr int smem_bytes() {
  return stages<DUAL>() * (DUAL ? 4 : 2) * OPERAND_BYTES + 1024 /* alignment */ + 2 * stages<DUAL>() * 8;
}

// one unit of work: an output tile and, for a split-K launch, one split
struct Unit {
  int m0, n0, split, kt0, n_k;
};
__device__ __forceinline__ Unit unit_at(const Params& p, int u) {
  const int tiles_n = (p.N + BN - 1) / BN, tiles = tiles_n * ((p.M + BM - 1) / BM);
  const int k_tiles = (p.K + BK - 1) / BK;
  Unit w;
  w.split = u / tiles;
  const int t = u % tiles;  // along N first: concurrent tiles share their A rows in L2
  w.m0 = (t / tiles_n) * BM;
  w.n0 = (t % tiles_n) * BN;
  w.kt0 = w.split * p.k_tiles_per_split;
  w.n_k = max(0, min(k_tiles, w.kt0 + p.k_tiles_per_split) - w.kt0);
  return w;
}

// Persistent: CTA b takes units b, b + gridDim.x, ... (units = output tiles x
// splits); each unit is C tile = A . B over its split's K tiles, then the
// epilogue. The ring's stage and phase run on across units, so the producer
// loads the next unit's first stages while the consumers run the epilogue.
// DUAL: a second pair (A2 K-major (M, K), B2 K-major (N, K)) into a second
// accumulator; EPI_GELU_DZ writes bf16(acc2 * gelu'(acc + bias)).
template <bool A_MN, bool B_MN, bool DUAL, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap ta2, const __grid_constant__ CUtensorMap tb2, const Params p,
                int units) {
  constexpr int STAGES = stages<DUAL>();
  constexpr int STAGE_BYTES = (DUAL ? 4 : 2) * OPERAND_BYTES;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled TMA destinations want 1024-byte alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == CONSUMERS) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0;  // K tiles loaded so far, over all units
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_at(p, u);
        for (int t = 0; t < w.n_k; ++t, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          mbar_expect_tx(&full[s], STAGE_BYTES);
          uint8_t* st = smem + s * STAGE_BYTES;
          const int k0 = (w.kt0 + t) * BK;
          load_operand<A_MN>(&ta, st, &full[s], w.m0, k0);
          load_operand<B_MN>(&tb, st + OPERAND_BYTES, &full[s], w.n0, k0);
          if (DUAL) {
            load_operand<false>(&ta2, st + 2 * OPERAND_BYTES, &full[s], w.m0, k0);
            load_operand<false>(&tb2, st + 3 * OPERAND_BYTES, &full[s], w.n0, k0);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x % 128) / 32;
    int it = 0;  // K tiles consumed so far, over all units
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_at(p, u);
      float acc[64], acc2[DUAL ? 64 : 1];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < (DUAL ? 64 : 1); ++i) acc2[i] = 0.0f;

      for (int t = 0; t < w.n_k; ++t, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint32_t st = smem_u32(smem + s * STAGE_BYTES);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) {
          mma_slice<A_MN, B_MN>(acc, st, st + OPERAND_BYTES, warpgroup, k);
          if constexpr (DUAL)
            mma_slice<false, false>(acc2, st + 2 * OPERAND_BYTES, st + 3 * OPERAND_BYTES, warpgroup, k);
        }
        wgmma_commit();
        // keep this K tile's products in flight; the previous one's are
        // done, so its stage goes back to the producer
        wgmma_wait<1>();
        if (t > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      if (w.n_k > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

      // accumulator layout: element (row w*16 + lane/4 + 8i, column 8j + 2(lane%4) + e) at [4j + 2i + e]
      const int row0 = w.m0 + warpgroup * 64 + warp * 16 + lane / 4;
      constexpr bool FWD = EPI >= EPI_BIAS_BF16;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = w.n0 + 8 * j + 2 * (lane & 3);
        if (col >= p.N) continue;
        float2 bias = make_float2(0.0f, 0.0f);
        if constexpr (FWD) bias = *reinterpret_cast<const float2*>(p.bias + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row0 + 8 * i;
          if (row >= p.M) continue;
          float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
          const size_t off = (size_t)row * p.N + col;
          if constexpr (EPI == EPI_F32) {
            float* out = static_cast<float*>(p.C) + (size_t)w.split * p.M * p.N + off;
            *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
          } else if constexpr (EPI == EPI_BIAS_RESID_F32) {
            // the plain version's order: (x + bias) + product
            const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(p.resid + off);
            *reinterpret_cast<float2*>(static_cast<float*>(p.C) + off) =
                make_float2((__low2float(r) + bias.x) + v0, (__high2float(r) + bias.y) + v1);
          } else if constexpr (FWD) {
            v0 += bias.x;
            v1 += bias.y;
            if constexpr (EPI == EPI_BIAS_GELU_BF16) {
              v0 = gelu_poly(v0);
              v1 = gelu_poly(v1);
            }
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.C) + off) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if constexpr (EPI == EPI_RESID_BF16) {
              const float2 a = *reinterpret_cast<const float2*>(p.aux + off);
              v0 += a.x;
              v1 += a.y;
            } else if constexpr (EPI == EPI_GELU_DZ) {
              v0 = acc2[4 * j + 2 * i] * gelu_grad_poly(v0 + p.bias[col]);
              v1 = acc2[4 * j + 2 * i + 1] * gelu_grad_poly(v1 + p.bias[col + 1]);
            }
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.C) + off) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

// ---- host side ---------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no link
// against libcuda)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(sym);
  }
  return fn;
}

// a row-major (outer, inner) matrix read as an operand, one 128-byte row of
// inner a box row: K-major when inner is K (box {128 bytes, box_rows}),
// MN-major when inner is the rows of the product (box {128 bytes, 64});
// 128-byte swizzle, zero fill past the edges. bf16 (a box row holds 64
// elements) or int8 codes (type UINT8: 128 elements, the same bytes, so the
// shared layout and the descriptors are those of bf16)
inline bool make_map(CUtensorMap* map, const void* ptr, int inner, int outer, bool mn_major,
                     CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, int box_rows = BM) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const int elem_bytes = type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)(mn_major ? 64 : box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a row-major (rows, cols) matrix of 4-byte elements (int32 or f32) or of
// bf16 as the destination of TMA stores: boxes of 128 bytes (32 or 64
// columns) x 64 rows, 128-byte swizzle, the layout stage_acc_m64n128 writes
// for 4-byte values; rows and columns past the extent are not stored. The
// row pitch must be a multiple of 16 bytes.
inline bool make_store_map(CUtensorMap* map, void* ptr, int cols, int rows, CUtensorMapDataType type) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const int elem_bytes = type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), 64};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, ptr, dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// one CTA per SM (at most one per unit), each walking over its units
template <bool A_MN, bool B_MN, bool DUAL, int EPI>
inline cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& ta2,
                          const CUtensorMap& tb2, const Params& p, int splits, cudaStream_t stream) {
  auto kernel = gemm_kernel<A_MN, B_MN, DUAL, EPI>;
  constexpr int bytes = smem_bytes<DUAL>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int units = ((p.N + BN - 1) / BN) * ((p.M + BM - 1) / BM) * splits;
  const int grid = units < sm_count() ? units : sm_count();
  kernel<<<grid, THREADS, bytes, stream>>>(ta, tb, ta2, tb2, p, units);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace mm
