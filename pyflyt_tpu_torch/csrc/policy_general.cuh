// The general policy family's per-layer GEMM on Hopper: bf16 operands
// brought by TMA into a ring of 128-byte-swizzled stages, multiplied by
// wgmma with f32 accumulation; shared by K4g and K3g (policy_general.cu)
// and K2g (fused_epoch_general.cu) on their per-layer routes.
//
// The family takes every actor-critic the Pallas builders take and the wide
// (policy_mlp.cuh) and narrow (policy_narrow.cuh) families do not: any
// number of tanh layers a trunk (none included), any widths, any obs and
// action widths. Past what the resident and cluster routes hold (deeper
// than 16 layers, wider than a cluster of 8 blocks) and for K2g past a
// block's width, each layer of each pass is one launch of this GEMM:
// C (m x n) = A (m x k) B (k x n), every operand a bf16 buffer in device
// memory, written once (rounded to nearest even, as the Pallas kernels
// round their matmul inputs), each row's width padded to a multiple of 32
// (KPAD) and 16-byte aligned. Each operand is read through a 3-D tensor map
// (the contiguous dimension, the rows, a plane: K2g's minibatch of the
// obs) whose extents are the real sizes, so a box past them lands as zeros.
// Three operand modes, chosen by the transpose bits TA and TB:
//   forward        A K-major (a layer's input, rows x k), B MN-major (the
//                  weight image: W (in x out) as the parameters hold it, its
//                  rows padded to pad32(out))
//   data gradient  A K-major (dz), B K-major (the same image read as W^T)
//   weight grad.   A MN-major (the layer's input read as A^T), B MN-major
//                  (dz), the minibatch's rows the k, split into `splits`
//                  chunks of k_split rows, each chunk's partial into its
//                  own slab row
// Four epilogues, fused:
//   EPI_BIAS   C = A B + bias             (a head, f32)
//   EPI_TANH   C = tanh(A B + bias)       (a tanh layer: f32 for the backward's
//                                          1 - a^2 where asked, bf16 for the next GEMM)
//   EPI_DTANH  C = (A B) (1 - act^2)      (the data gradient dz W^T of a layer times the
//                                          tanh derivative of the layer below, bf16,
//                                          and its column sums over each 128-row tile, f32)
//   EPI_STORE  C = A B                    (the weight gradient over a chunk of rows, f32)
//
// The block (THREADS = 384, one an SM, persistent over the output tiles
// t = blockIdx.x, blockIdx.x + gridDim.x, ...): a producer warpgroup, whose
// one thread keeps STAGES k blocks (BK = 64 k) of A and B in flight by TMA,
// each stage completing on its `full` mbarrier, and two consumer
// warpgroups (setmaxnreg 232 against the producer's 40), each 64 rows of
// the 128 x 128 output tile: per stage its k16 steps back to back
// (wgmma.m64n128k16, both operands from shared memory), one commit, then
// it waits for the stage before (wait_group 1) and releases that stage on
// its `empty` mbarrier. The accumulators start at zero and take k16 steps
// in ascending k, pad32(k) / 16 of them, and k is never split in the
// forward: each output is the same chain as mma.sync's on the same
// fragments (tools/cluster_probe.py's wgmma_bits finds wgmma's bits equal
// to mma.sync's in these modes), so a row's forward is the resident and
// cluster routes' (policy_resident.cuh, policy_cluster.cuh) bit for bit,
// K3g's log-probs are K2g's forward bit for bit on every route, and the
// bias is added after the sum, as there.
//
// What bounds it on an H100: at K2g's 2 x 1024 trunks over 8192 rows a
// minibatch is 104.7 GFLOP of bf16 MMA (0.106 ms at 989 TFLOP/s) against
// about 0.2 GB of operands, activations and slab rows (0.06 ms at 3.35
// TB/s): operations bound it, and the design feeds wgmma from shared memory
// without a thread touching an operand on its way in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace general {

constexpr int BM = 128, BN = 128, BK = 64;  // output tile (two warpgroups of 64 rows), k a stage
constexpr int STAGES = 4;                   // k blocks in flight
constexpr int THREADS = 384;                // two consumer warpgroups and the producer warpgroup
constexpr int KPAD = 32;                    // every operand row is padded to a multiple of it
constexpr int PRODUCER_REGS = 40;           // registers a thread after setmaxnreg
constexpr int CONSUMER_REGS = 232;          // 128 x 40 + 256 x 232 <= 65,536
constexpr int OPERAND_BYTES = BM * BK * 2;  // A's (or B's) block a stage: 16 KB
constexpr int STAGE_BYTES = 2 * OPERAND_BYTES;
constexpr int RED_FLOATS = 8 * BN;          // the column sums' per-warp partials
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + RED_FLOATS * 4 + 2 * STAGES * 8 + 1024;
constexpr float LOG2PI = 1.8378770664093453f;  // log(2 pi)
static_assert(BM == BN, "one box height for both K-major operands");
static_assert(SMEM_BYTES <= 232448, "more shared memory than a block can have");

enum Epilogue : int { EPI_BIAS = 0, EPI_TANH = 1, EPI_DTANH = 2, EPI_STORE = 3 };

// One product. Must match ops/cuda_general.py's use: the host code of
// policy_general.cu and fused_epoch_general.cu fills it.
struct GemmArgs {
  CUtensorMap a;          // A's map: K-major boxes of 64 k x BM rows, MN-major of 64 m x 64 k
  CUtensorMap b;          // B's map: K-major boxes of 64 k x BN rows (B^T's), MN-major of 64 n x 64 k
  float* c;               // f32 C (null: none), row stride ldc; chunk z's at c + z c_split
  long long ldc;
  long long c_split;
  __nv_bfloat16* cb;      // bf16 C (null: none), row stride ldcb: columns < ncb, zero past n
  long long ldcb;
  const float* bias;      // (n,): EPI_BIAS, EPI_TANH
  const float* act;       // EPI_DTANH: (m x n) f32 activations, row stride ld_act
  long long ld_act;
  float* colsum;          // EPI_DTANH: the 128-row tile i's column sums at colsum + i colsum_ld (null: none)
  long long colsum_ld;
  int a_z;                // A's plane (K2g's minibatch of the obs; 0 else)
  int m, n, k;            // the real sizes
  int k_split;            // k a chunk (a multiple of BK); pad32(k) for none
  int splits;             // chunks of k
  int ncb;                // bf16 columns written (pad32(n))
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b: one m16n8k16 product, bf16 inputs, f32 accumulation (the
// resident and cluster routes' layer loops)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 b16 matrices; lane 8q + j gives row j of matrix q
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__host__ __device__ __forceinline__ int pad32(int x) { return (x + KPAD - 1) / KPAD * KPAD; }

__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;" ::: "memory"); }

// tile t's chunk z and first row and column
__device__ __forceinline__ void tile_of(const GemmArgs& g, int t, int& z, int& m0, int& n0) {
  const int tm = (g.m + BM - 1) / BM, tn = (g.n + BN - 1) / BN;
  z = t / (tm * tn);
  const int r = t % (tm * tn);
  m0 = r / tn * BM;
  n0 = r % tn * BN;
}

// The epilogue of one consumer warpgroup's 64 rows from row0 of tile
// (z, m0, n0): thread t holds rows row0 + 16 (t / 32) + (t % 32) / 4 (+ 8),
// columns n0 + 8 i + 2 (t % 4) (+ 1) in acc[4 i .. 4 i + 3]. Everything it
// reads (the bias, the activations) is loaded before it writes anything,
// so the loads' latencies overlap instead of each waiting behind the
// stores before it.
template <int EPI>
__device__ __forceinline__ void epilogue(const GemmArgs& g, const float (&acc)[BN / 2], int z, int m0, int row0,
                                         int n0, float* red) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r = row0 + 16 * (t / 32) + lane / 4;
  const bool colsum = EPI == EPI_DTANH && g.colsum != nullptr;
  float in[BN / 8][4];  // per column pair: the bias (b0, b1), or the activations (row, row + 8)
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (EPI == EPI_BIAS || EPI == EPI_TANH) {
        in[i][2 * h] = h == 0 && col < g.n ? __ldg(g.bias + col) : 0.f;
        in[i][2 * h + 1] = h == 0 && col + 1 < g.n ? __ldg(g.bias + col + 1) : 0.f;
      }
      if constexpr (EPI == EPI_DTANH) {
        const int row = r + 8 * h;
        const float* ap = g.act + static_cast<long long>(row) * g.ld_act;
        in[i][2 * h] = row < g.m && col < g.n ? __ldg(ap + col) : 0.f;
        in[i][2 * h + 1] = row < g.m && col + 1 < g.n ? __ldg(ap + col + 1) : 0.f;
      }
    }
  }
  // f32 pairs as one 8-byte store where every row and the base allow it
  const bool pairs = g.c != nullptr && g.ldc % 2 == 0 && g.c_split % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(g.c) & 7) == 0;
  if (colsum) consumers_sync();  // the tile before has read `red`
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * (lane % 4);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
      if constexpr (EPI == EPI_BIAS) {
        v0 = v0 + in[i][0];
        v1 = v1 + in[i][1];
      }
      if constexpr (EPI == EPI_TANH) {
        v0 = tanhf(v0 + in[i][0]);
        v1 = tanhf(v1 + in[i][1]);
      }
      if constexpr (EPI == EPI_DTANH) {
        const float a0 = in[i][2 * h], a1 = in[i][2 * h + 1];
        v0 = row < g.m && col < g.n ? v0 * (1.f - a0 * a0) : 0.f;
        v1 = row < g.m && col + 1 < g.n ? v1 * (1.f - a1 * a1) : 0.f;
        s0 += v0;
        s1 += v1;
      }
      if (row < g.m) {
        if (g.c != nullptr) {
          float* cp = g.c + static_cast<long long>(z) * g.c_split + static_cast<long long>(row) * g.ldc;
          if (pairs && col + 1 < g.n) {
            *reinterpret_cast<float2*>(cp + col) = make_float2(v0, v1);
          } else {
            if (col < g.n) cp[col] = v0;
            if (col + 1 < g.n) cp[col + 1] = v1;
          }
        }
        if constexpr (EPI == EPI_TANH || EPI == EPI_DTANH) {
          if (g.cb != nullptr && col < g.ncb)
            *reinterpret_cast<__nv_bfloat162*>(g.cb + static_cast<long long>(row) * g.ldcb + col) =
                __floats2bfloat162_rn(col < g.n ? v0 : 0.f, col + 1 < g.n ? v1 : 0.f);
        }
      }
    }
    if (colsum) {  // the warp's 16 rows: rows r and r + 8, then the lanes of a column pair
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (lane < 4) {
        float* q = red + (threadIdx.x / 32) * BN + 8 * i + 2 * lane;
        q[0] = s0;
        q[1] = s1;
      }
    }
  }
  if (colsum) {  // the tile's column sums: the 8 warps' in order
    consumers_sync();
    const int c = threadIdx.x;
    if (c < BN && n0 + c < g.n) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += red[w * BN + c];
      g.colsum[static_cast<long long>(m0 / BM) * g.colsum_ld + n0 + c] = s;
    }
  }
}

template <int EPI, int TA, int TB>
__global__ void __launch_bounds__(THREADS, 1) gemm_kernel(const __grid_constant__ GemmArgs g) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_u32(smem);
  float* red = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  const uint32_t full = sm90::smem_u32(red + RED_FLOATS), empty = full + 8 * STAGES;
  const int tiles = ((g.m + BM - 1) / BM) * ((g.n + BN - 1) / BN) * g.splits;
  const int kpad = pad32(g.k);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int z, m0, n0;
        tile_of(g, t, z, m0, n0);
        const int k1 = min(kpad, (z + 1) * g.k_split);
        for (int kb = z * g.k_split; kb < k1; kb += BK, ++it) {
          const int s = it % STAGES;
          sm90::mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);  // a fresh barrier's "previous" phase is complete
          const uint32_t bar = full + 8 * s, sa = base + s * STAGE_BYTES, sb = sa + OPERAND_BYTES;
          sm90::mbar_expect_tx(bar, STAGE_BYTES);
          if (TA) {
            sm90::tma_load(sa, &g.a, bar, m0, kb, g.a_z);
            sm90::tma_load(sa + 8192, &g.a, bar, m0 + 64, kb, g.a_z);
          } else {
            sm90::tma_load(sa, &g.a, bar, kb, m0, g.a_z);
          }
          if (TB) {
            sm90::tma_load(sb, &g.b, bar, n0, kb, 0);
            sm90::tma_load(sb + 8192, &g.b, bar, n0 + 64, kb, 0);
          } else {
            sm90::tma_load(sb, &g.b, bar, kb, n0, 0);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int z, m0, n0;
    tile_of(g, t, z, m0, n0);
    const int k1 = min(kpad, (z + 1) * g.k_split);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int kb = z * g.k_split; kb < k1; kb += BK, ++it) {
      const int s = it % STAGES;
      sm90::mbar_wait(full + 8 * s, (it / STAGES) & 1);
      const uint32_t sa = base + s * STAGE_BYTES, sb = sa + OPERAND_BYTES;
      const int steps = min(BK, k1 - kb) / 16;
      sm90::wg_fence();
      sm90::fence_regs(acc);
#pragma unroll
      for (int st = 0; st < BK / 16; ++st) {
        if (st < steps) {
          const uint64_t da = TA ? sm90::mn_desc(sa + wg * 8192 + st * 2048) : sm90::k_desc(sa + wg * 8192 + 32 * st);
          const uint64_t db = TB ? sm90::mn_desc(sb + st * 2048) : sm90::k_desc(sb + 32 * st);
          sm90::Wgmma<BN, TA, TB>::mma(acc, da, db);
        }
      }
      sm90::wg_commit();
      sm90::wg_wait<1>();
      sm90::fence_regs(acc);
      if (prev >= 0) sm90::mbar_arrive(empty + 8 * prev);  // the stage before is read
      prev = s;
    }
    sm90::wg_wait<0>();
    sm90::fence_regs(acc);
    if (prev >= 0) sm90::mbar_arrive(empty + 8 * prev);
    epilogue<EPI>(g, acc, z, m0, m0 + 64 * wg, n0, red);
  }
}

// ---------------------------------------------------------------------------
// host side: internal to each source that includes it, so that the
// function-local statics below are one a library (an inline function's
// would be one a process, shared by every library built from this header)
// ---------------------------------------------------------------------------

namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up once (null if missing)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A bf16 operand: `inner` elements contiguous (row stride `ld` elements, a
// multiple of 8), `rows` rows, `planes` planes `plane` elements apart, at a
// 16-byte aligned `base`.
struct Operand {
  const __nv_bfloat16* base;
  int inner;
  long long ld;
  int rows;
  int planes;
  long long plane;
};

// its tensor map: boxes of 64 contiguous elements x `box_rows` rows, the
// 128-byte swizzle, zeros past the extents
inline cudaError_t make_map(CUtensorMap* map, const Operand& o, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (o.base == nullptr || o.inner <= 0 || o.rows <= 0 || o.planes <= 0 || o.ld < o.inner || o.ld % 8 != 0 ||
      o.plane % 8 != 0 || (o.planes > 1 && o.plane < o.ld * o.rows) || (reinterpret_cast<uintptr_t>(o.base) & 15) != 0)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(o.inner), static_cast<cuuint64_t>(o.rows),
                              static_cast<cuuint64_t>(o.planes)};
  const long long plane = o.planes > 1 ? o.plane : o.ld * o.rows;
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(o.ld) * 2, static_cast<cuuint64_t>(plane) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<__nv_bfloat16*>(o.base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the SMs of the current device, and the kernel's shared-memory opt-in on it
template <typename K>
inline cudaError_t prepare(K kernel, int* sms) {
  int device = 0, count = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e == cudaSuccess) *sms = count;
  return e;
}

// Checks one product and makes its A and B maps from the operands (A
// K-major unless TA, B^T's K-major unless TB).
template <int EPI, int TA, int TB>
inline cudaError_t prepare_gemm(GemmArgs& g, const Operand& a, const Operand& b) {
  if (g.m <= 0 || g.n <= 0 || g.k <= 0 || g.splits <= 0 || g.k_split <= 0 ||
      static_cast<long long>(g.splits) * g.k_split < pad32(g.k) || (g.splits > 1 && g.k_split % BK != 0) ||
      (g.cb != nullptr && (g.ncb < g.n || g.ncb > pad32(g.n) || g.ldcb < g.ncb || g.ldcb % 2 != 0)) ||
      (EPI == EPI_DTANH && g.act == nullptr) || ((EPI == EPI_BIAS || EPI == EPI_TANH) && g.bias == nullptr))
    return cudaErrorInvalidValue;
  const cudaError_t e = make_map(&g.a, a, TA ? 64 : BM);
  return e == cudaSuccess ? make_map(&g.b, b, TB ? 64 : BN) : e;
}

// Enqueues one prepared product on `stream`: a persistent grid of at most
// one block an SM over the tiles.
template <int EPI, int TA, int TB>
inline cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  static int sms = 0;
  cudaError_t e;
  if (sms == 0 && (e = prepare(gemm_kernel<EPI, TA, TB>, &sms)) != cudaSuccess) return e;
  const int tiles = ((g.m + BM - 1) / BM) * ((g.n + BN - 1) / BN) * g.splits;
  gemm_kernel<EPI, TA, TB><<<tiles < sms ? tiles : sms, THREADS, SMEM_BYTES, stream>>>(g);
  return cudaGetLastError();
}

template <int EPI, int TA, int TB>
inline cudaError_t gemm(GemmArgs g, const Operand& a, const Operand& b, cudaStream_t stream) {
  const cudaError_t e = prepare_gemm<EPI, TA, TB>(g, a, b);
  return e == cudaSuccess ? launch_gemm<EPI, TA, TB>(g, stream) : e;
}

}  // namespace

// (rows x cols) f32 at x (row stride ld) -> bf16 at out (row stride ldo,
// zero past cols), rounded to nearest even: an operand written once
__global__ void __launch_bounds__(256) round_rows_kernel(const float* x, long long ld, long long rows, int cols,
                                                         __nv_bfloat16* out, int ldo) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const int half = ldo / 2;
  if (i >= rows * half) return;
  const long long r = i / half;
  const int c = 2 * static_cast<int>(i % half);
  const float* src = x + r * ld;
  const float v0 = c < cols ? src[c] : 0.f, v1 = c + 1 < cols ? src[c + 1] : 0.f;
  *reinterpret_cast<__nv_bfloat162*>(out + r * ldo + c) = __floats2bfloat162_rn(v0, v1);
}

inline cudaError_t round_rows(const float* x, long long ld, long long rows, int cols, __nv_bfloat16* out, int ldo,
                              cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || ldo < cols || ldo % 2 != 0) return cudaErrorInvalidValue;
  const long long n = rows * (ldo / 2);
  round_rows_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(x, ld, rows, cols, out, ldo);
  return cudaGetLastError();
}

// One row's log-prob of `action` (act values) under a diagonal Gaussian of
// mean `mean` and log_std `log_std` (clipped to [lo, hi] with `has_range`),
// summed over the actions in order: K3g's output and K2g's ratio alike.
__device__ __forceinline__ float row_logp(const float* action, const float* mean, const float* log_std, int act,
                                          int has_range, float lo, float hi) {
  float s = 0.f;
  for (int jj = 0; jj < act; ++jj) {
    const float ls = has_range ? fminf(fmaxf(log_std[jj], lo), hi) : log_std[jj];
    const float var = expf(2.f * ls);
    const float d = action[jj] - mean[jj];
    s += -0.5f * (d * d / var + 2.f * ls + LOG2PI);
  }
  return s;
}

}  // namespace general

// One trunk for K4g's and K3g's per-layer host code: `depth` tanh layers,
// then the head (layer `depth`). Must match ops/cuda_general.py::_TrunkC.
// The arrays are host memory the caller keeps alive for the call.
struct GeneralTrunk {
  int depth;
  const int* dims;        // depth + 2 widths: the input, each layer's outputs, the head's
  const long long* w;     // depth + 1: W_l (dims[l] x pad32(dims[l + 1]) bf16) at image + w[l] bytes
  const long long* b;     // depth + 1: bias_l (dims[l + 1] f32) at image + b[l] bytes
  const long long* out;   // depth: tanh layer l's bf16 outputs (rows x pad32(dims[l + 1])) at ws + out[l]
};

namespace general {

// Whether a host-side trunk is one the Python wrapper writes: positive
// widths, input width `in`, `outs` outputs, the image's regions inside
// its `bytes` and 16-byte aligned.
inline bool trunk_ok(const GeneralTrunk& T, int in, int outs, long long bytes) {
  if (T.depth < 0 || T.dims == nullptr || T.w == nullptr || T.b == nullptr || T.out == nullptr ||
      T.dims[0] != in || T.dims[T.depth + 1] != outs)
    return false;
  for (int l = 0; l <= T.depth; ++l) {
    if (T.dims[l] <= 0 || T.dims[l + 1] <= 0 || T.w[l] < 0 || T.b[l] < 0 || T.w[l] % 16 != 0 || T.b[l] % 16 != 0 ||
        T.w[l] + 2LL * T.dims[l] * pad32(T.dims[l + 1]) > bytes || T.b[l] + 4LL * T.dims[l + 1] > bytes)
      return false;
    if (l < T.depth && (T.out[l] < 0 || T.out[l] % 8 != 0)) return false;
  }
  return true;
}

// The forward of one trunk over `rows` rows of x (bf16, row stride
// pad32(dims[0])): the tanh layers' bf16 outputs into ws + out[l], the head
// into `head` (f32, row stride dims[depth + 1]). One launch a layer.
inline cudaError_t trunk_forward(const GeneralTrunk& T, const uint8_t* image, const __nv_bfloat16* x, int rows,
                                 __nv_bfloat16* ws, float* head, cudaStream_t stream) {
  const __nv_bfloat16* in = x;
  for (int l = 0; l <= T.depth; ++l) {
    const int k = T.dims[l], n = T.dims[l + 1];
    const Operand a{in, k, pad32(k), rows, 1, 0};
    const Operand b{reinterpret_cast<const __nv_bfloat16*>(image + T.w[l]), n, pad32(n), k, 1, 0};
    GemmArgs g{};
    g.bias = reinterpret_cast<const float*>(image + T.b[l]);
    g.m = rows;
    g.n = n;
    g.k = k;
    g.k_split = pad32(k);
    g.splits = 1;
    cudaError_t e;
    if (l < T.depth) {
      g.cb = ws + T.out[l];
      g.ldcb = pad32(n);
      g.ncb = pad32(n);
      e = gemm<EPI_TANH, 0, 1>(g, a, b, stream);
      in = g.cb;
    } else {
      g.c = head;
      g.ldc = n;
      e = gemm<EPI_BIAS, 0, 1>(g, a, b, stream);
    }
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace general
