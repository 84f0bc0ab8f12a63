// Hopper's tile copies (TMA), mbarriers and warpgroup MMA (wgmma) in PTX,
// for the general family's per-layer GEMM (policy_general.cuh) and its
// probe (tools/cluster_probe.cu).
//
// Shared-memory operand layouts, both 128-byte swizzled, as a TMA box of
// 64 bf16 (128 bytes) along the contiguous dimension writes them:
//  - K-major (k contiguous): R rows of 64 k, row r at r * 128 bytes, its
//    16-byte group g at (g ^ (r % 8)) * 16; `k_desc` of the block plus 32
//    bytes a k16 step;
//  - MN-major (m or n contiguous): 64-wide MN atoms of 64 k rows (8192
//    bytes each), k row kk of an atom at kk * 128, its 16-byte group g at
//    (g ^ (kk % 8)) * 16; `mn_desc` with the atoms LBO = 8192 bytes apart
//    and 8-row k groups SBO = 1024 apart, plus 2048 bytes a k16 step.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr uint32_t MN_LBO = 8192;  // a 64 x 64 bf16 MN atom
constexpr uint32_t MN_SBO = 1024;  // 8 rows of 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// spins until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the box of a 3-D tensor map at coordinates (c0, c1, c2) into shared
// memory at `dst`, completing on `bar`'s transaction count; elements past
// the tensor's extents land as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// descriptor of a K-major operand block at shared address `addr`: 8-row
// groups 1024 bytes apart, the leading offset unused (1), 128-byte swizzle
__device__ __forceinline__ uint64_t k_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// descriptor of an MN-major operand at `addr` (the wgmma's transpose bit):
// 64-wide MN atoms `lbo` bytes apart, 8-row k groups `sbo` apart
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, uint32_t lbo = MN_LBO, uint32_t sbo = MN_SBO) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators across
// an asynchronous wgmma (CUTLASS's warpgroup_fence_operand)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) += A (64 x 16, desc da) B (16 x N, desc db), both bf16
// in shared memory; TA / TB 1: that operand MN-major. Thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 i +
// 2 (t % 4) (+ 1) in d[4 i .. 4 i + 3]: (row, c), (row, c + 1), (row + 8,
// c), (row + 8, c + 1).
template <int N, int TA, int TB>
struct Wgmma;

template <int TA, int TB>
struct Wgmma<64, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<128, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<256, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};


}  // namespace sm90
