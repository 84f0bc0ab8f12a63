// A probe for the general family's resident and cluster routes
// (tools/cluster_probe.py builds this file with nvcc and binds it with
// ctypes; sm_90a). wgmma_bits: does a chain of wgmma k16 steps, taken in
// order on one accumulator, give the bits of a chain of mma.sync m16n8k16
// steps on the same bf16 fragments? Each block (one warpgroup) takes one
// trial: A (64 x K) and B (K x 8) bf16; the warpgroup runs wgmma.m64n8k16
// with A from registers and B from a 128-byte-swizzled K-major image in
// shared memory, k16 step by k16 step, and each warp runs mma.sync on its
// 16 rows with the same fragments, both from zero. Both results go out f32.
//
// wgmma_modes / mma_chain: the same question in the per-layer GEMM's operand
// modes (pyflyt_tpu_torch/csrc/policy_general.cuh): A and B both from
// shared memory, each K-major or MN-major (the transpose bit), at N = 64,
// 128 and 256, every k16 step issued back to back under one commit, in the
// layouts and descriptors of gemm_sm90.cuh (a TMA box's 128-byte swizzle);
// mma_chain is mma.sync's chain on the same inputs, one warp an n8 column
// block at a time. k may pass the 256 staged k: step s reads k block s % 16.
#include "../pyflyt_tpu_torch/csrc/gemm_sm90.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void fence_regs(float (&d)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a: (trials, 64, k) bf16 row-major; b: (trials, 8, k) bf16 (B^T, k contiguous);
// d_wg, d_mma: (trials, 64, 8) f32
__global__ void __launch_bounds__(128) wgmma_bits_kernel(const uint16_t* a, const uint16_t* b, float* d_wg,
                                                         float* d_mma, int k) {
  __shared__ __align__(1024) uint8_t sb[MAX_K / 64 * 1024];
  const int t = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, t4 = lane & 3;
  const uint16_t* A = a + static_cast<long long>(t) * 64 * k;
  const uint16_t* B = b + static_cast<long long>(t) * 8 * k;
  // B^T (8 x k) into 128-byte-swizzled atoms of 8 rows x 64 k: entry (n, kk)
  // of atom kk / 64 at n * 128 + ((kk % 64 / 8) ^ n) * 16 + (kk % 8) * 2
  for (int i = tid; i < 8 * k; i += 128) {
    const int n = i / k, kk = i % k;
    *reinterpret_cast<uint16_t*>(sb + (kk / 64) * 1024 + n * 128 + (((kk % 64) / 8) ^ n) * 16 + (kk % 8) * 2) =
        B[n * k + kk];
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  float dw[4] = {0.f, 0.f, 0.f, 0.f}, dm[4] = {0.f, 0.f, 0.f, 0.f};
  const int r0 = 16 * warp + gr;
  for (int s = 0; s < k / 16; ++s) {
    const int k0 = 16 * s + 2 * t4;
    uint32_t af[4];
    af[0] = *reinterpret_cast<const uint32_t*>(A + r0 * k + k0);
    af[1] = *reinterpret_cast<const uint32_t*>(A + (r0 + 8) * k + k0);
    af[2] = *reinterpret_cast<const uint32_t*>(A + r0 * k + k0 + 8);
    af[3] = *reinterpret_cast<const uint32_t*>(A + (r0 + 8) * k + k0 + 8);
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(B + gr * k + k0);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(B + gr * k + k0 + 8);
    mma(dm, af, b0, b1);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    fence_regs(dw);
    wgmma_m64n8k16_rs(dw, af, sw128_desc(sb + (s / 4) * 1024 + 32 * (s % 4)));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(dw);
  }
  float* W = d_wg + static_cast<long long>(t) * 64 * 8;
  float* M = d_mma + static_cast<long long>(t) * 64 * 8;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int r = r0 + 8 * (c / 2), col = 2 * t4 + c % 2;
    W[r * 8 + col] = dw[c];
    M[r * 8 + col] = dm[c];
  }
}

constexpr int MODE_K = 256;  // distinct k a trial stages

// a: (trials, 64, MODE_K) bf16 row-major; bt: (trials, N, MODE_K) bf16 (B^T);
// d: (trials, 64, N) f32. Operand block b (64 k) of R rows at b R 128 bytes.
template <int N, int TA, int TB>
__global__ void __launch_bounds__(128) wgmma_modes_kernel(const uint16_t* a, const uint16_t* bt, float* d, int k) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sa = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sb = sa + MODE_K / 64 * 64 * 128;
  const int t = blockIdx.x, tid = threadIdx.x;
  const uint16_t* A = a + static_cast<long long>(t) * 64 * MODE_K;
  const uint16_t* B = bt + static_cast<long long>(t) * N * MODE_K;
  // element (r, kk) of an R-row operand (r its m or n) at its mode's byte
  auto at = [](int r, int kk, int rows, int mn_major) {
    const int blk = kk / 64, c = kk % 64;
    if (!mn_major) return blk * rows * 128 + r * 128 + (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
    return blk * rows * 128 + (r / 64) * 8192 + c * 128 + ((((r % 64) / 8) ^ (c % 8)) * 16) + (r % 8) * 2;
  };
  for (int i = tid; i < 64 * MODE_K; i += 128)
    *reinterpret_cast<uint16_t*>(sa + at(i / MODE_K, i % MODE_K, 64, TA)) = A[i];
  for (int i = tid; i < N * MODE_K; i += 128)
    *reinterpret_cast<uint16_t*>(sb + at(i / MODE_K, i % MODE_K, N, TB)) = B[i];
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const uint32_t a0 = sm90::smem_u32(sa), b0 = sm90::smem_u32(sb);
  sm90::wg_fence();
  sm90::fence_regs(acc);
  for (int s = 0; s < k / 16; ++s) {
    const int blk = (s % (MODE_K / 16)) / 4, st = s % 4;
    const uint64_t da = TA ? sm90::mn_desc(a0 + blk * 64 * 128 + st * 2048) : sm90::k_desc(a0 + blk * 64 * 128 + 32 * st);
    const uint64_t db = TB ? sm90::mn_desc(b0 + blk * N * 128 + st * 2048) : sm90::k_desc(b0 + blk * N * 128 + 32 * st);
    sm90::Wgmma<N, TA, TB>::mma(acc, da, db);
  }
  sm90::wg_commit();
  sm90::wg_wait<0>();
  sm90::fence_regs(acc);
  float* D = d + static_cast<long long>(t) * 64 * N;
  const int r = 16 * (tid / 32) + (tid % 32) / 4, q = tid % 4;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    D[r * N + 8 * i + 2 * q] = acc[4 * i];
    D[r * N + 8 * i + 2 * q + 1] = acc[4 * i + 1];
    D[(r + 8) * N + 8 * i + 2 * q] = acc[4 * i + 2];
    D[(r + 8) * N + 8 * i + 2 * q + 1] = acc[4 * i + 3];
  }
}

// mma.sync's chain on the inputs of wgmma_modes_kernel: warp w rows 16 w..,
// each n8 block from zero over k / 16 steps in order
__global__ void __launch_bounds__(128) mma_chain_kernel(const uint16_t* a, const uint16_t* bt, float* d, int n, int k) {
  const int t = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t4 = lane & 3;
  const uint16_t* A = a + static_cast<long long>(t) * 64 * MODE_K;
  const uint16_t* B = bt + static_cast<long long>(t) * n * MODE_K;
  float* D = d + static_cast<long long>(t) * 64 * n;
  const int r0 = 16 * warp + gr;
  for (int nb = 0; nb < n / 8; ++nb) {
    float dm[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < k / 16; ++s) {
      const int k0 = 16 * (s % (MODE_K / 16)) + 2 * t4;
      uint32_t af[4];
      af[0] = *reinterpret_cast<const uint32_t*>(A + r0 * MODE_K + k0);
      af[1] = *reinterpret_cast<const uint32_t*>(A + (r0 + 8) * MODE_K + k0);
      af[2] = *reinterpret_cast<const uint32_t*>(A + r0 * MODE_K + k0 + 8);
      af[3] = *reinterpret_cast<const uint32_t*>(A + (r0 + 8) * MODE_K + k0 + 8);
      const uint16_t* brow = B + (8 * nb + gr) * MODE_K;
      mma(dm, af, *reinterpret_cast<const uint32_t*>(brow + k0), *reinterpret_cast<const uint32_t*>(brow + k0 + 8));
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) D[(r0 + 8 * (c / 2)) * n + 8 * nb + 2 * t4 + c % 2] = dm[c];
  }
}

template <int N, int TA, int TB>
int launch_modes(const uint16_t* a, const uint16_t* bt, float* d, int trials, int k, cudaStream_t st) {
  const int smem = MODE_K / 64 * (64 + N) * 128 + 1024;
  cudaError_t e = cudaFuncSetAttribute(wgmma_modes_kernel<N, TA, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  wgmma_modes_kernel<N, TA, TB><<<trials, 128, smem, st>>>(a, bt, d, k);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_n(const uint16_t* a, const uint16_t* bt, float* d, int trials, int k, int ta, int tb, cudaStream_t st) {
  if (ta) return tb ? launch_modes<N, 1, 1>(a, bt, d, trials, k, st) : launch_modes<N, 1, 0>(a, bt, d, trials, k, st);
  return tb ? launch_modes<N, 0, 1>(a, bt, d, trials, k, st) : launch_modes<N, 0, 0>(a, bt, d, trials, k, st);
}

}  // namespace

extern "C" int wgmma_modes(const uint16_t* a, const uint16_t* bt, float* d, int trials, int k, int n, int ta, int tb,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (trials <= 0 || k <= 0 || k % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 64) return launch_n<64>(a, bt, d, trials, k, ta, tb, st);
  if (n == 128) return launch_n<128>(a, bt, d, trials, k, ta, tb, st);
  if (n == 256) return launch_n<256>(a, bt, d, trials, k, ta, tb, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mma_chain(const uint16_t* a, const uint16_t* bt, float* d, int trials, int k, int n, void* stream) {
  if (trials <= 0 || k <= 0 || k % 16 != 0 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  mma_chain_kernel<<<trials, 128, 0, static_cast<cudaStream_t>(stream)>>>(a, bt, d, n, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgmma_bits(const uint16_t* a, const uint16_t* b, float* d_wg, float* d_mma, int trials, int k,
                          void* stream) {
  if (trials <= 0 || k <= 0 || k % 64 != 0 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  wgmma_bits_kernel<<<trials, 128, 0, static_cast<cudaStream_t>(stream)>>>(a, b, d_wg, d_mma, k);
  return static_cast<int>(cudaGetLastError());
}
