// Building blocks of the four kernels: the 1-bit `mma.sync` product, the
// 1-bit `wgmma` product of kernel 1's large tile, the `cp.async` copies
// of kernels 1 and 2 and of the block program of kernel 3
// (mlp_block.cuh), and the tensor memory accelerator's 2-D copies on
// mbarriers that feed kernel 1's large tile and kernel 2's row ring
// (their tensor maps: tensor_map.cuh).
//
// Why 1-bit and not int8 operands: on the H100 a warp's
// `mma.sync.m16n8k256.b1.and.popc` issues at the same rate as an int8
// `mma.sync.m16n8k32` (scripts/torch_mma_probe.py: 19,141 bit-MACs and
// 2,356 int8 MACs per clock per SM), so it does 8x the bits per
// instruction, and its fragments are the packed words themselves: a
// thread's A registers are words t and t+4 of a row's 8-word K step, its
// B registers the same words of a column.  No ±1 bytes are ever built.
// A warpgroup's `wgmma.m64nNk256.b1.and.popc`, both operands in shared
// memory, issues 29,383 bit-MACs per clock per SM (the same probe, NVIDIA
// H100 80GB HBM3, 700 W), 1.54x `mma.sync`; kernel 1 takes it where its
// tile is large enough to feed it (128 x 256 outputs a block).
// Hopper has `.and.popc` only (no `.xor.popc`), so a Hamming distance is
// either two products, HD(x, w) = popc(x & ~w) + popc(~x & w) (kernels
// 2-4 and kernel 1's small tiles), or one product beside the rows'
// popcounts, HD = popc(x) + popc(w) - 2 popc(x & w) (kernel 1's large
// tile).  Pad bits are zero in both operands, so they add nothing to
// either form.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace picbnn {

// d += popc(a & b) over one 16 x 256 (A, row) by 256 x 8 (B, col) step.
// Fragments (PTX ISA, mma.m16n8k256 .b1), lane = 4*g + t:
//   a[0] row g word t, a[1] row g+8 word t, a[2] row g word t+4,
//   a[3] row g+8 word t+4;  b[0] column g word t, b[1] column g word t+4;
//   d[0], d[1] row g columns 2t, 2t+1;  d[2], d[3] row g+8, same columns.
__device__ __forceinline__ void bmma_and(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += HD over one K step: popc(a & ~b) + popc(~a & b); `na` is ~a.
__device__ __forceinline__ void bmma_hd(int (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&na)[4], uint32_t b0,
                                        uint32_t b1) {
  bmma_and(d, a, ~b0, ~b1);
  bmma_and(d, na, b0, b1);
}

__device__ __forceinline__ void complement(uint32_t (&na)[4],
                                           const uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) na[i] = ~a[i];
}

// Asynchronous global -> shared copies; `src_bytes` < size zero-fills
// the rest (0: the whole granule is zero and `src` is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------- wgmma
// d += popc(A & B) for a warpgroup: A 64 rows x 256 bits, B 256 columns
// x 256 bits, both from descriptors.  Thread (warp w of the group, lane
// 4g + t) holds rows 16w + g and 16w + g + 8 of columns 8j + 2t, 8j +
// 2t + 1 in d[4j], d[4j + 1] and d[4j + 2], d[4j + 3].
__device__ __forceinline__ void wgmma_and_n256(int (&d)[128], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k256.s32.b1.b1.and.popc {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66,"
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92,"
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104,"
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115,"
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126,"
      "%127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ----------------------------------------------- TMA copies, mbarriers
// The tensor memory accelerator's copies (async proxy) complete on an
// mbarrier in shared memory: the issuing thread arms the barrier with the
// bytes to come (`mbar_arrive_expect`), the copies count them down, and
// consumers wait for the barrier's phase (`mbar_wait`); what they then
// read of the copied bytes is visible to them.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// makes the barriers' initialisation visible to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// waits until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// the box at (c0 inner, c1 outer) of a 2-D tensor map into shared `dst`;
// elements outside the tensor arrive as zero
__device__ __forceinline__ void tensor_copy_2d(void* dst, const void* map,
                                               int c0, int c1,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1),
         "r"(smem_addr(bar))
      : "memory");
}

}  // namespace picbnn
