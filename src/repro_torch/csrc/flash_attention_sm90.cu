// Causal grouped-query flash attention for bfloat16 on Hopper's tensor
// cores (wgmma), fed by TMA through a two-stage ring of K/V tiles; fp32
// online softmax, bfloat16 in and out, head dims 64, 128 and 256.
//
// Replaces the TPU kernel kernels/flash_attention.py::flash_attention
// (src/repro/kernels/flash_attention.py:75, Pallas body _flash_kernel) of
// the JAX package for bfloat16 inputs at the model widths; float32 inputs,
// and bfloat16 at head dims 16 and 32, stay with csrc/flash_attention.cu.
// Plain version: repro_torch/kernels/flash_attention.py::
// flash_attention_torch.  Route: kernels/flash_attention.py::flash_route.
//
// What it computes, for query head h (KV head h / (H / K)) and query row i
// of Sq, at position p = q_offset + i among the Sk keys, as the JAX kernel
// does (q_offset = 0 and Sq = Sk: its call; else rows [q_offset, q_offset
// + Sq) of that call over Sk queries, a device's block of a split sequence):
//   s[j]  = hd^-0.5 * (q[i] . k[j])            (the product in fp32)
//   s[j]  = softcap * tanh(s[j] / softcap)    (if softcap; before the mask)
//   s[j]  = -1e30 where j > p (causal), p - j >= window (if window), j >= Sk
//   out   = sum_j softmax(s)[j] v[j], by the online recurrence over key
//           tiles, finally acc / max(l, 1e-30), rounded to bfloat16.
// The scale is applied to the fp32 scores, not to q in bfloat16 (rounding
// q * scale to bfloat16 would move a score of 30 by 0.06).  Scores are
// carried in log2 units (log2(e) folded into the scale) so that exp2f
// serves.  The masked value is the finite -1e30 of the JAX kernel: a row
// whose first processed tile is all masked gets p = exp2(0) there, which
// the first unmasked tile wipes out exactly through alpha = exp2(-1e30 -
// m) = 0; -inf would give NaN.  P is rounded to bfloat16 for the P.V
// product (the row sums l stay in fp32), as every tensor-core flash kernel
// does; the JAX kernel keeps P in fp32.
//
// What bounds it on an H100: 4 * hd operations per unmasked (query, key)
// pair against q, k, v read once and the output written once, so at the
// model widths (hd 128 or 256, thousands of keys) it is bound by
// operations: the bf16 tensor-core peak, 989 TFLOP/s.
//
// What the design does about it:
// - One CTA of two warpgroups (256 threads) per (batch, head, 128 query
//   rows), the query blocks walked from the last (the heaviest under a
//   causal mask) to the first.  Each warpgroup owns 64 query rows and
//   holds the fp32 O accumulator (hd / 2 a thread, 128 at hd 256), the
//   score tile and P in registers.  With 8 warps the launch bound gives a
//   thread up to 255 registers; a ninth warp (a dedicated producer) puts
//   three warps on one of the SM's four register quarters and caps every
//   thread at 168, and then the hd 256 accumulators spill (ptxas -v,
//   whatever setmaxnreg asks for; PERF.md has the times of both).
// - Thread 0 issues the TMA loads: Q once, then the K and V tiles into a
//   ring of two stages, each guarded by a full and an empty mbarrier (the
//   empty one counts the 8 warps out); once both warpgroups are done with
//   tile it, thread 0 refills its stage with tile it + 2.  (A third stage,
//   refilled one tile later so that the warpgroups need not keep step,
//   measured no faster.)
// - Tiles of 128 keys at hd <= 128 and 64 keys at hd 256.  Shared memory:
//   Q 16 / 32 / 64 KB plus two stages of K and V of 32 / 64 / 64 KB each,
//   80 / 160 / 192 KB at hd 64 / 128 / 256, under the 227 KB a block may
//   use, so one CTA per SM.
// - TMA tensor maps over the JAX layout, built on the host at each call:
//   q as the 4-D tensor (hd, H, Sq, B), k and v as (hd, K, Sk, B), boxes of
//   (64, 1, rows, 1) with the 128-byte swizzle; a wider head is 2 or 4
//   boxes of 64 columns.  Rows past S are filled with zeros by the TMA
//   unit (a ragged S), and keys past S are masked.  The driver's
//   cuTensorMapEncodeTiled is reached through the runtime's
//   cudaGetDriverEntryPoint(ByVersion), so nothing links against libcuda.
// - S = Q K^T by wgmma from shared memory (both K-major, fp32
//   accumulators), O += P V by wgmma with P from registers (the S
//   fragment re-packed to bfloat16 as the A operand, FA3's way) and V as
//   the MN-major B operand (the transpose flag).  Each warpgroup runs its
//   two products back to back; the two warpgroups interleave on the SM's
//   tensor cores.  (Overlapping a tile's softmax with the previous tile's
//   P V inside a warpgroup, FA3's way, measured no faster here.)
// - The softmax works on the accumulator fragment: a thread holds two rows
//   of the tile, and the row max and sum reduce over the quad of lanes
//   that shares a row (__shfl_xor_sync with 1 and 2).  The mask is
//   evaluated only on tiles that cross the causal diagonal, the window's
//   edge or S; tiles wholly outside the band are never loaded.
//
// Entry: flash_attention_sm90_launch returns 0 or a CUDA runtime error;
// kEncodeError + the CUresult when a tensor map does not encode, and
// kNoEncoder when the driver entry point is missing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;          // query rows per CTA
constexpr int kThreads = 256;     // two warpgroups of 64 query rows each
constexpr int kStages = 2;        // K/V tiles in the ring
constexpr int kBox = 128;         // bytes of one row of a 64-column bf16 box
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeError = 100000;
constexpr int kNoEncoder = 99999;

// ---------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of the given parity has completed; a wait that
// never completes (a fault in the pipeline) traps, an error the launch's
// caller sees, instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins == (1u << 22)) __trap();
  }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma matrix descriptor of a tile in the 128-byte swizzled layout (the
// TMA's CU_TENSOR_MAP_SWIZZLE_128B); tiles are 1024-byte aligned, so the
// base offset is 0.  lbo and sbo in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ------------------------------------------------- wgmma, bf16 in, fp32 out
// The accumulator fragment of m64nNk16: thread t of the warpgroup (warp w,
// lane) holds d[4c + 2r + e] = D[16w + lane/4 + 8r][8c + 2(lane%4) + e].
// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers, B MN-major in shared memory
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers, B MN-major in shared memory
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] * B[16 x 256], A from registers, B MN-major in shared memory
__device__ __forceinline__ void mma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  mma_ss_n64(d, a, b, acc);
}
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  mma_ss_n128(d, a, b, acc);
}
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  mma_rs_n64(d, a, b);
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  mma_rs_n128(d, a, b);
}
__device__ __forceinline__ void mma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  mma_rs_n256(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------------ kernel
template <int HD, int BK>
struct Tiles {
  static constexpr int kChunks = HD / 64;          // 64-column boxes per row
  static constexpr int kQBox = kBQ * kBox;         // one box of Q
  static constexpr int kKVBox = BK * kBox;         // one box of K or V
  static constexpr int kQBytes = kChunks * kQBox;
  static constexpr int kKBytes = kChunks * kKVBox;
  static constexpr int kStageBytes = 2 * kKBytes;  // K then V
  // alignment slack, Q, the ring, then the barriers: q_full, full[], empty[]
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes + 8 * (1 + 2 * kStages);
};

template <int HD, int BK>
__global__ void __launch_bounds__(kThreads, 1) flash_sm90_kernel(
    const __grid_constant__ CUtensorMap tq,   // (hd, H, Sq, B)
    const __grid_constant__ CUtensorMap tk,   // (hd, K, Sk, B)
    const __grid_constant__ CUtensorMap tv,   // (hd, K, Sk, B)
    __nv_bfloat16* __restrict__ out,          // [B, Sq, H, hd]
    int Sq, int Sk, int q_off, int H, int K, int causal, int window, float softcap,
    float sm_scale) {
  using T = Tiles<HD, BK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t ring = sq + T::kQBytes;
  const uint32_t q_full = ring + kStages * T::kStageBytes;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest causal blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int p0 = q_off + q0;  // the position of the block's first row among the keys
  const int n_kb = (Sk + BK - 1) / BK;
  const int kb_hi = causal ? min(n_kb, (p0 + kBQ + BK - 1) / BK) : n_kb;
  const int kb_lo = window > 0 ? max(0, p0 - window + 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // K and V of key tile it (of kb_lo + it) into stage it % kStages
  auto load_tile = [&](int it) {
    const int s = it % kStages;
    const uint32_t full = full0 + 8 * s;
    const uint32_t st = ring + s * T::kStageBytes;
    const int kb = kb_lo + it;
    mbar_expect_tx(full, T::kStageBytes);
    for (int c = 0; c < T::kChunks; ++c) {
      tma_load(st + c * T::kKVBox, &tk, full, 64 * c, kvh, kb * BK, b);
      tma_load(st + T::kKBytes + c * T::kKVBox, &tv, full, 64 * c, kvh, kb * BK, b);
    }
  };
  const int n = kb_hi - kb_lo;
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, T::kQBytes);
    for (int c = 0; c < T::kChunks; ++c)
      tma_load(sq + c * T::kQBox, &tq, q_full, 64 * c, h, q0, b);
    for (int it = 0; it < min(n, kStages); ++it) load_tile(it);
  }

  // ---- each warpgroup: its 64 rows against every key tile of the band
  const int cw = threadIdx.x / 128;        // rows q0 + 64 cw ... + 63
  const int ct = threadIdx.x % 128;
  const int lane = ct % 32;
  const int r_lo = p0 + 64 * cw;                      // positions among the keys
  const int row0 = r_lo + 16 * (ct / 32) + lane / 4;  // and row0 + 8
  const int col0 = 2 * (lane % 4);
  const bool capped = softcap > 0.0f;
  const float score_log2 = sm_scale * kLog2e;
  const float cap_in = capped ? sm_scale / softcap : 0.0f;
  const float cap_out = softcap * kLog2e;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums
  const uint32_t qa = sq + cw * 64 * kBox;  // this warpgroup's rows of each Q box

  mbar_wait(q_full, 0);
  for (int kb = kb_lo, it = 0; kb < kb_hi; ++kb, ++it) {
    const int s = it % kStages;
    mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    const uint32_t kt = ring + s * T::kStageBytes;
    const uint32_t vt = kt + T::kKBytes;

    // S = Q K^T: hd / 16 steps of 16 columns (32 bytes inside a box)
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const uint32_t off = (ks % 4) * 32;
      mma_ss(sc, sw128_desc(qa + (ks / 4) * T::kQBox + off, 16, 1024),
             sw128_desc(kt + (ks / 4) * T::kKVBox + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scores in log2 units, softcap before the mask, the mask only where
    // the tile crosses the diagonal, the window's edge or S
    const int k0 = kb * BK;
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > r_lo) ||
                        (window > 0 && r_lo + 63 - k0 >= window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      float y = capped ? cap_out * tanhf(sc[i] * cap_in) : sc[i] * score_log2;
      if (masked) {
        const int key = k0 + 8 * (i / 4) + col0 + (i & 1);
        const int row = row0 + 8 * r;
        bool ok = key < Sk;
        if (causal) ok = ok && key <= row;
        if (window > 0) ok = ok && row - key < window;
        y = ok ? y : kNegInf;
      }
      sc[i] = y;
      mx[r] = fmaxf(mx[r], y);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = mx[r];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const float m_new = fmaxf(m[r], v);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    // P in bf16 as the A operand: for 16 keys kk, registers
    // {sc[8kk..8kk+1]}, {sc[8kk+2..+3]}, {sc[8kk+4..+5]}, {sc[8kk+6..+7]}
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = exp2f(sc[i] - m[r]);
      const float p1 = exp2f(sc[i + 1] - m[r]);
      l[r] += p0 + p1;
      pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V: BK / 16 steps of 16 keys (2048 bytes of each V box);
    // the boxes of 64 columns lie kKVBox apart (the leading offset)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_rs(o, pa[kk], sw128_desc(vt + kk * 16 * kBox, T::kKVBox, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    // thread 0 refills the stage with tile it + kStages once both
    // warpgroups are done with it
    if (threadIdx.x == 0 && it + kStages < n) {
      mbar_wait(empty0 + 8 * s, (it / kStages) & 1);
      load_tile(it + kStages);
    }
    __syncwarp();
  }

  // epilogue: acc / max(l, 1e-30), rounded to bf16, rows past Sq dropped
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r - q_off;  // the output's row
    if (row < Sq) {
      __nv_bfloat16* dst = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * HD + col0;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(o[4 * c + 2 * r] / l[r], o[4 * c + 2 * r + 1] / l[r]);
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) = v;
      }
    }
  }
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the map of a [B, S, heads, hd] bf16 tensor as (hd, heads, S, B), boxes
// of 64 columns by `rows` rows of one head, 128-byte swizzle, zero fill
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int hd, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  cuuint64_t strides[3] = {hd * e, (cuuint64_t)heads * hd * e, (cuuint64_t)S * heads * hd * e};
  cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + (int)res;
}

template <int HD, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
           int q_off, int H, int K, int causal, int window, float softcap, float sm_scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, Sq, H, HD, kBQ);
  if (err == 0) err = make_map(&tk, k, B, Sk, K, HD, BK);
  if (err == 0) err = make_map(&tv, v, B, Sk, K, HD, BK);
  if (err != 0) return err;
  auto kernel = flash_sm90_kernel<HD, BK>;
  const int smem = Tiles<HD, BK>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  __nv_bfloat16* out = (__nv_bfloat16*)o;
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, out, Sq, Sk, q_off, H, K, causal,
                                           window, softcap, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Sq, H, hd], k and v [B, Sk, K, hd], out [B, Sq, H, hd], all
// bfloat16, contiguous and 16-byte aligned; hd in {64, 128, 256};
// q_offset + Sq <= Sk
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
    int q_offset, int H, int K, int hd, int causal, int window, float softcap, float sm_scale,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define FLASH_LAUNCH(HD, BK)                                                              \
  launch<HD, BK>(q, k, v, out, B, Sq, Sk, q_offset, H, K, causal, window, softcap, sm_scale, st)
  switch (hd) {
    case 64: return FLASH_LAUNCH(64, 128);
    case 128: return FLASH_LAUNCH(128, 128);
    case 256: return FLASH_LAUNCH(256, 64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_LAUNCH
}
