// The warpgroup MLP of csrc/policy_value_forward.cu's two entries (K4, the
// fused actor-critic forward, and K3, the PPO log-prob): one 2 x 256 tanh
// trunk and its head over 64-row tiles of f32 observations, on Hopper's
// wgmma with the trunk's weights resident in shared memory.
//
// The block (THREADS = 384): two consumer warpgroups and a producer
// warpgroup, which hands its registers to the consumers (setmaxnreg: 40
// against 232 a thread).
//  - The producer's thread 0 issues one 1-D bulk copy (cp.async.bulk) per
//    region of the trunk's weight image at the start: layer 0 with the
//    biases, each of layer 1's four 64-deep K-chunks, the head. Each
//    region completes on its own mbarrier, so chunk c + 1 lands while the
//    consumers multiply chunk c. The image is built on the host in exactly
//    the byte order the wgmma B descriptor reads (ops/cuda_policy.py::
//    pack_trunk), so no thread touches a weight on its way in.
//  - The producer warpgroup then walks the block's tiles, handing them to the
//    two consumer warpgroups in turn: 4-byte cp.async copies of the tile's
//    f32 rows (any row stride: K3's packed rows are 37 floats wide in the
//    dogfight, not 16-byte aligned; zero-filled past n and obs_dim) into
//    that consumer's staging tile, completing on its mbarrier. A consumer
//    reads its tile into registers first thing, so the next one loads while
//    it computes.
//  - Each consumer warpgroup runs a whole tile alone, its activations never
//    leaving registers: layer 0 is wgmma.m64n256k16 with A the obs tile
//    rounded to bf16 in registers; the epilogue adds the bias, takes an
//    accurate tanhf and packs bf16 pairs, and the accumulator fragment of
//    columns 16 kb .. 16 kb + 15 is then exactly the A fragment of k-block
//    kb, so it feeds layer 1 (m64n256k16, A from registers) and layer 1's
//    feeds the head (m64n8k16, outputs padded to 8), whose accumulators the
//    entry's epilogue turns into its outputs. The two warpgroups share
//    nothing but the weights, so one's tanh epilogue runs on the SM's
//    CUDA cores while the other's MMAs run on its tensor cores.
//
// Weights resident whole (~164 KB a trunk) rather than streamed through a
// ring: K3 is persistent (one block an SM walks many tiles), so the trunk
// is read from L2 once a block instead of once a tile, and K4 runs the same
// persistent loop with half the SMs on each trunk; one layout then serves
// both entries. The cost is one block an SM (208 KB of shared memory).
//
// Shared-memory layout of a 64-wide K-chunk of a weight (B operand):
// K-major, one 128-byte row per output column, the 128-byte swizzle. Entry
// (n, k) of a chunk lies at byte
//   n * 128 + (((k / 8) ^ (n % 8)) * 16) + (k % 8) * 2
// and chunk c of a matrix with N output columns at c * N * 128. The same
// formula is written once in Python, ops/cuda_policy.py::swizzle_offset,
// which builds the weight image; the two must agree.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace pmlp {

constexpr int TILE_M = 64;                // rows a tile: the wgmma M
constexpr int HID = 256;                  // trunk width
constexpr int KC = 64;                    // K a chunk: one 128-byte swizzle row of bf16
constexpr int HEAD_N = 8;                 // head outputs, padded (act <= 8, value 1)
constexpr int MAX_OBS = KC;               // layer 0's K is one chunk
constexpr int CONSUMERS = 2;              // warpgroups, one tile each at a time
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and the producer warpgroup
constexpr int PRODUCER_REGS = 40;         // registers a thread after setmaxnreg
constexpr int CONSUMER_REGS = 232;        // 128 x 40 + 256 x 232 <= 65,536
constexpr int OBS_LD = MAX_OBS + 8;       // staging row stride in floats (8 mod 32 banks)

// the regions of one trunk's weight image (ops/cuda_policy.py's W0_BYTES ...)
constexpr int W0_BYTES = HID * KC * 2;          // layer 0: 256 rows x one chunk
constexpr int W1_CHUNK_BYTES = HID * KC * 2;    // layer 1: 256 rows x 4 chunks
constexpr int W1_CHUNKS = HID / KC;
constexpr int HW_CHUNK_BYTES = HEAD_N * KC * 2;  // head: 8 rows x 4 chunks
constexpr int HW_BYTES = W1_CHUNKS * HW_CHUNK_BYTES;

// weight barriers: layer 0 and the biases, layer 1's chunks, the head
constexpr int BAR_W0 = 0;
constexpr int BAR_W1 = 1;
constexpr int BAR_HEAD = BAR_W1 + W1_CHUNKS;
constexpr int N_BAR_W = BAR_HEAD + 1;

struct Smem {
  // every wgmma operand at a 1024-byte boundary (the swizzle's period)
  uint8_t w0[W0_BYTES];
  uint8_t w1[W1_CHUNKS][W1_CHUNK_BYTES];
  uint8_t hw[W1_CHUNKS][HW_CHUNK_BYTES];
  float x[CONSUMERS][TILE_M * OBS_LD];  // each consumer's f32 obs tile
  float b0[HID];
  float b1[HID];
  float hb[HEAD_N];
  uint64_t bar_w[N_BAR_W];
  uint64_t full[CONSUMERS];   // consumer j's obs tile landed
  uint64_t empty[CONSUMERS];  // consumer j has read it
};
// dynamic shared memory: the struct and its alignment slack
constexpr int SMEM_BYTES = static_cast<int>(sizeof(Smem)) + 1024;
static_assert(SMEM_BYTES <= 232448, "more shared memory than a block can have");

// The weights of one trunk: pointers into its image (16-byte aligned).
struct TrunkSrc {
  const void* w0;    // W0_BYTES
  const float* b0;   // HID
  const void* w1;    // W1_CHUNKS * W1_CHUNK_BYTES
  const float* b1;   // HID
  const void* hw;    // HW_BYTES
  const float* hb;   // HEAD_N, zero past the real outputs
};

// ---------------------------------------------------------------------------
// PTX: shared addresses, mbarriers, copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// spins until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared, `bytes` (a multiple of 16, both ends 16-byte aligned),
// completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// one float global -> shared; src_bytes 0 writes a zero and reads nothing
__device__ __forceinline__ void cp_async4(float* dst, const float* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

// an arrival on `bar` once this thread's cp.async copies have landed (the
// barrier counts it: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// ---------------------------------------------------------------------------
// PTX: wgmma (bf16 x bf16 -> f32; A from registers or shared memory, B in
// shared memory, K-major or MN-major)
// ---------------------------------------------------------------------------

// descriptor of a 128-byte-swizzled K-major operand at `p`: 8-row groups
// 1024 bytes apart (SBO), the leading offset unused by this layout (1, as
// CUTLASS sets it), swizzle mode 1 (128 B). `p` is a chunk's base plus 32
// bytes per k16 step, so the base offset field stays 0.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// descriptor of a 128-byte-swizzled MN-major operand at `p` (read with the
// wgmma's transpose bit): 64 MN values contiguous in each 128-byte row, one
// row per K index; 8-row K groups `sbo` bytes apart and 64-wide MN atoms
// `lbo` bytes apart (CUTLASS's canonical ((8,n),(8,k)):((1,LBO),(8,SBO)) in
// 16-byte units). A k16 step starts 16 rows further on; `p` stays on the
// swizzle's 1024-byte period, so the base offset field stays 0.
__device__ __forceinline__ uint64_t mn_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// keeps the compiler from moving reads or writes of a wgmma's registers
// (accumulators, A fragments) across the asynchronous wgmma, and keeps an
// A fragment's registers live until the wait (CUTLASS's
// warpgroup_fence_operand)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (64 x 256) += A (64 x 16, this thread's fragment a0-a3) B (16 x 256, desc_b);
// TRANS_B 1 reads B MN-major (mn_desc)
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
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
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
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
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// d (64 x 8) += A (64 x 16, this thread's fragment a0-a3) B (16 x 8, desc_b)
__device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}


// d (64 x 64) += A (64 x 16, registers) B (16 x 64, desc_b)
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// d (64 x 256) += A (64 x 16, desc_a) B (16 x 256, desc_b); TRANS_A / TRANS_B 1
// read that operand MN-major (mn_desc)
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
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
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, %131, %132;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

// d (64 x 8) += A (64 x 16, desc_a) B (16 x 8, desc_b)
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n8k16_ss(float (&d)[4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3},"
      " %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

// ---------------------------------------------------------------------------
// the block
// ---------------------------------------------------------------------------

// the dynamic shared memory as an S at its first 1024-byte boundary
template <class S = Smem>
__device__ __forceinline__ S& smem() {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  return *reinterpret_cast<S*>(smem_raw + pad);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// thread 0 of the producer: every region of the trunk's image, one barrier
// each (S: Smem, or a struct with the same weight fields and barriers)
template <class S>
__device__ __forceinline__ void load_weights(S& s, const TrunkSrc& w) {
  mbar_expect_tx(&s.bar_w[BAR_W0], W0_BYTES + (2 * HID + HEAD_N) * 4);
  bulk_copy(s.w0, w.w0, W0_BYTES, &s.bar_w[BAR_W0]);
  bulk_copy(s.b0, w.b0, HID * 4, &s.bar_w[BAR_W0]);
  bulk_copy(s.b1, w.b1, HID * 4, &s.bar_w[BAR_W0]);
  bulk_copy(s.hb, w.hb, HEAD_N * 4, &s.bar_w[BAR_W0]);
  for (int c = 0; c < W1_CHUNKS; ++c) {
    mbar_expect_tx(&s.bar_w[BAR_W1 + c], W1_CHUNK_BYTES);
    bulk_copy(s.w1[c], static_cast<const uint8_t*>(w.w1) + c * W1_CHUNK_BYTES, W1_CHUNK_BYTES,
              &s.bar_w[BAR_W1 + c]);
  }
  mbar_expect_tx(&s.bar_w[BAR_HEAD], HW_BYTES);
  bulk_copy(s.hw, w.hw, HW_BYTES, &s.bar_w[BAR_HEAD]);
}

// The producer warpgroup: obs rows row0.. (row stride ld floats) -> the f32
// staging tile x, zero past n and obs_dim, over the columns the MMAs read.
__device__ __forceinline__ void load_tile(float* x, const float* rows, int ld, int n, int obs_dim, int row0) {
  const int kpad = (obs_dim + 15) / 16 * 16;
  for (int e = threadIdx.x % 128; e < TILE_M * kpad; e += 128) {
    const int r = e / kpad, k = e % kpad;
    const bool in = row0 + r < n && k < obs_dim;
    cp_async4(x + r * OBS_LD + k, in ? rows + static_cast<size_t>(row0 + r) * ld + k : rows, in ? 4 : 0);
  }
}

// The staged f32 obs tile xs as bf16 A fragments: k-block kb in x[4 kb ..
// 4 kb + 3] (rows r0 (+ 8), columns 16 kb + 8 (e / 2) + 2 q (+ 1)), zero
// past the obs width's k16 steps.
__device__ __forceinline__ void obs_frags(const float* xs, int r0, int q, int ksteps, uint32_t (&x)[16]) {
#pragma unroll
  for (int kb = 0; kb < MAX_OBS / 16; ++kb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = kb < ksteps
          ? *reinterpret_cast<const float2*>(xs + (r0 + 8 * (e & 1)) * OBS_LD + 16 * kb + 8 * (e >> 1) + 2 * q)
          : make_float2(0.f, 0.f);
      x[4 * kb + e] = pack_bf16(v.x, v.y);
    }
  }
}

// d (this warpgroup's fragment of the 64 x 256 accumulator) -> a, the bf16
// A fragments of the next product: a[m] = bf16(tanh(d[2m] + b), tanh(d[2m +
// 1] + b)). Thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4
// (+ 8) and columns 8 i + 2 (t % 4) (+ 1) in d[4 i .. 4 i + 3]; the A
// fragment of k-block kb is a[4 kb .. 4 kb + 3]: (row, 2 (t % 4)), (row +
// 8, same), (row, 8 + same), (row + 8, 8 + same), two columns each, which
// is d[8 kb .. 8 kb + 7] pair by pair.
__device__ __forceinline__ void tanh_to_frag(const float (&d)[128], const float* bias, uint32_t (&a)[64]) {
  const int q = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * i + 2 * q);
#pragma unroll
    for (int h = 0; h < 2; ++h) a[2 * i + h] = pack_bf16(tanhf(d[4 * i + 2 * h] + b.x), tanhf(d[4 * i + 2 * h + 1] + b.y));
  }
}

// Consumer warpgroup j: every second tile of the block, layer 0, layer 1 and
// the head; `head(h, hb, row0)` turns the head's fragment (rows as
// tanh_to_frag's, columns 2 (t % 4) (+ 1) in h[0..1], rows + 8 in h[2..3])
// into the entry's outputs.
template <class Head>
__device__ __forceinline__ void consume(Smem& s, int n, int obs_dim, const Head& head) {
  const int j = threadIdx.x / 128, t = threadIdx.x % 128;
  const int r0 = 16 * (t / 32) + (t % 32) / 4, q = t % 4;
  const int ksteps = (obs_dim + 15) / 16;
  const int tiles = (n + TILE_M - 1) / TILE_M;
  const float* xs = s.x[j];
  float d[128];
  uint32_t a[64];
  int k = 0;
  for (int tile = blockIdx.x + j * gridDim.x; tile < tiles; tile += CONSUMERS * gridDim.x, ++k) {
    mbar_wait(&s.full[j], k & 1);
    uint32_t x[16];
    obs_frags(xs, r0, q, ksteps, x);
    mbar_arrive(&s.empty[j]);
    // layer 0: K = ksteps x 16 of the zero-padded obs
    mbar_wait(&s.bar_w[BAR_W0], 0);
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < MAX_OBS / 16; ++kb)
      if (kb < ksteps)
        wgmma_m64n256k16_rs(d, x[4 * kb], x[4 * kb + 1], x[4 * kb + 2], x[4 * kb + 3], sw128_desc(s.w0 + 32 * kb));
    wg_commit();
    wg_wait0();
    fence_regs(d);
    fence_regs(x);
    tanh_to_frag(d, s.b0, a);
    // layer 1, chunk by chunk as the weights land
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int c = 0; c < W1_CHUNKS; ++c) {
      mbar_wait(&s.bar_w[BAR_W1 + c], 0);
#pragma unroll
      for (int st = 0; st < KC / 16; ++st) {
        const int kb = 4 * c + st;
        wgmma_m64n256k16_rs(d, a[4 * kb], a[4 * kb + 1], a[4 * kb + 2], a[4 * kb + 3], sw128_desc(s.w1[c] + 32 * st));
      }
    }
    wg_commit();
    wg_wait0();
    fence_regs(d);
    fence_regs(a);
    tanh_to_frag(d, s.b1, a);
    // the head
    mbar_wait(&s.bar_w[BAR_HEAD], 0);
    float h[4] = {0.f, 0.f, 0.f, 0.f};
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < HID / 16; ++kb)
      wgmma_m64n8k16_rs(h, a[4 * kb], a[4 * kb + 1], a[4 * kb + 2], a[4 * kb + 3], sw128_desc(s.hw[kb / 4] + 32 * (kb % 4)));
    wg_commit();
    wg_wait0();
    fence_regs(h);
    fence_regs(a);
    head(h, s.hb, tile * TILE_M);
  }
}

// The whole block: barriers, then the producer or a consumer warpgroup.
// Tiles blockIdx.x + k gridDim.x of `n` rows of `rows` (row stride ld
// floats, obs in the first obs_dim columns), the k-th to consumer k % 2.
template <class Head>
__device__ __forceinline__ void mlp_block(const TrunkSrc& w, const float* rows, int ld, int n, int obs_dim,
                                          const Head& head) {
  Smem& s = smem();
  if (threadIdx.x == 0) {
    for (int b = 0; b < N_BAR_W; ++b) mbar_init(&s.bar_w[b], 1);
    for (int j = 0; j < CONSUMERS; ++j) {
      mbar_init(&s.full[j], 128);
      mbar_init(&s.empty[j], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x / 128 == CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x % 128 == 0) load_weights(s, w);
    const int tiles = (n + TILE_M - 1) / TILE_M;
    int i = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
      const int j = i % CONSUMERS, use = i / CONSUMERS;
      mbar_wait(&s.empty[j], (use & 1) ^ 1);  // a fresh barrier's "previous" phase is complete
      load_tile(s.x[j], rows, ld, n, obs_dim, tile * TILE_M);
      cp_async_arrive(&s.full[j]);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  consume(s, n, obs_dim, head);
}

// above 48 KB of dynamic shared memory needs the opt-in, once per device;
// also returns the device's SM count
template <typename K>
cudaError_t prepare_launch(K kernel, int* attr_device, int* sms) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess || device == *attr_device) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) *attr_device = device;
  return e;
}

}  // namespace pmlp
