// The general policy family's tiled GEMM on Hopper's warp-level tensor-core
// MMA (mma.sync m16n8k16, bf16 inputs, f32 accumulation), shared by K4g and
// K3g (policy_general.cu) and K2g (fused_epoch_general.cu).
//
// The family takes every actor-critic the Pallas builders take and the wide
// (policy_mlp.cuh) and narrow (policy_narrow.cuh) families do not: any
// number of tanh layers a trunk (none included), any widths, any obs and
// action widths. So nothing is resident: each layer of each trunk is one
// launch of one GEMM, C (m x n) = A (m x k) B (k x n), every operand f32 in
// device memory, read through two strides (element (i, j) of A at
// a[i a_si + j a_sj]), so that one kernel reads a layer's input, its
// transpose (the weight gradient's A^T) and a weight's transpose (the data
// gradient's W^T) in place. Every operand is rounded to bf16 (nearest
// even) on its way into shared memory, as the Pallas kernels round their
// matmul inputs, and the accumulation is f32. Four epilogues:
//   EPI_BIAS   C = A B + bias             (a head)
//   EPI_TANH   C = tanh(A B + bias)       (a tanh layer; C is kept for the backward)
//   EPI_DTANH  C = (A B) (1 - act^2)      (the data gradient dZ W^T of a layer, times
//                                          the tanh derivative of the layer below)
//   EPI_STORE  C = A B                    (the weight gradient A^T dZ over a chunk of rows)
// The weight gradient splits its k (the minibatch's rows) into chunks of
// `k_split` rows, grid.z a chunk, each writing its own partial C at
// c + z c_split; with `colsum` set the same blocks also sum B's columns
// (dZ, the bias gradient) over their chunk in f32, in a fixed order. The
// partials are summed in chunk order afterwards (fused_epoch_general.cu),
// so no atomics and a bit-reproducible epoch.
//
// Tiling: 128 x 64 output tiles, k steps of 32, 8 warps of 32 x 32 (2 m16
// x 4 n8 MMA tiles a warp); each thread loads its operands' k step as runs
// of 4 along the operand's contiguous dimension (one 16-byte load where the
// rows are aligned), and the next k step's are loaded into registers while
// the warps multiply the current one from shared memory. Rows and columns
// past m, n and k read as zero and are not stored. The products of one
// output row depend only on that row and the k order (k16 steps in
// order), so K3g's actor forward equals K2g's bit for bit whatever the row
// count or the tiling.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace general {

constexpr int BM = 128, BN = 64, BK = 32;  // output tile, k step
constexpr int THREADS = 256;               // 8 warps, 4 (m) x 2 (n) over the tile
constexpr int LDS = BK + 8;                // bf16 a k-major shared-memory row: 80 bytes, ldmatrix conflict-free
constexpr float LOG2PI = 1.8378770664093453f;  // log(2 pi)

enum Epilogue : int { EPI_BIAS = 0, EPI_TANH = 1, EPI_DTANH = 2, EPI_STORE = 3 };

// One product. Must match ops/cuda_general.py's use: the host code of
// policy_general.cu and fused_epoch_general.cu fills it.
struct GemmArgs {
  const float* a;
  long long a_si, a_sj;   // A (m x k): element (i, j) at a[i a_si + j a_sj]
  const float* b;
  long long b_si, b_sj;   // B (k x n): element (i, j) at b[i b_si + j b_sj]
  float* c;
  long long ldc;          // C (m x n) row-major, row stride ldc
  long long c_split;      // chunk z's C at c + z c_split
  const float* bias;      // (n,): EPI_BIAS, EPI_TANH
  const float* act;       // EPI_DTANH: (m x n) activations, row stride ld_act
  long long ld_act;
  float* colsum;          // EPI_STORE: B's column sums over chunk z at colsum + z colsum_split (null: none)
  long long colsum_split;
  int m, n, k;
  int k_split;            // rows of k a chunk (a multiple of BK); k for no split
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b: one m16n8k16 product, bf16 inputs, f32 accumulation
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

// One operand's k step, R rows x BK, as runs of 4 along its contiguous
// dimension: with `rows_contig` (the operand's element (r, c) at p[r + c
// s_c]) a run is 4 rows of one column, else 4 columns of one row (at p[r
// s_r + c], or strided when neither stride is 1). Run e of a thread is run
// threadIdx.x + THREADS e, the runs of one row or column consecutive, so a
// warp reads 512 contiguous bytes. `vec`: the runs are 16-byte aligned
// (checked a launch), so each whole run is one float4 load. In shared
// memory the tile keeps the operand's contiguous dimension: R rows of k
// (row stride LDS) or, with `rows_contig`, BK rows of R (row stride LDT),
// so each run is one 8-byte store; the fragments read the latter through
// ldmatrix.trans.
template <int R>
struct Operand {
  static constexpr int RUNS = R * BK / 4 / THREADS;  // runs a thread
  static constexpr int LDT = R + 8;                  // bf16 an r-major row: 272 or 144 bytes, conflict-free
  static constexpr int ELEMS = R * LDS > BK * LDT ? R * LDS : BK * LDT;  // the tile's shared memory
  float4 v[RUNS];

  __device__ __forceinline__ void load(const float* p, long long s_r, long long s_c, bool rows_contig, bool vec,
                                       int r0, int rows, int c0, int k_end) {
#pragma unroll
    for (int e = 0; e < RUNS; ++e) {
      const int idx = threadIdx.x + THREADS * e;
      const int r = rows_contig ? r0 + (idx % (R / 4)) * 4 : r0 + idx / (BK / 4);
      const int c = rows_contig ? c0 + idx / (R / 4) : c0 + (idx % (BK / 4)) * 4;
      const int dr = rows_contig ? 1 : 0, dc = rows_contig ? 0 : 1;
      const long long at = static_cast<long long>(r) * s_r + static_cast<long long>(c) * s_c;
      if (vec && r + 3 * dr < rows && c + 3 * dc < k_end) {
        v[e] = *reinterpret_cast<const float4*>(p + at);
      } else {
        const long long step = rows_contig ? s_r : s_c;
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = (r + i * dr < rows && c + i * dc < k_end) ? p[at + i * step] : 0.f;
        v[e] = make_float4(w[0], w[1], w[2], w[3]);
      }
    }
  }

  // the runs into the tile's shared memory, bf16, one 8-byte store a run
  __device__ __forceinline__ void store(__nv_bfloat16* s, bool rows_contig) const {
#pragma unroll
    for (int e = 0; e < RUNS; ++e) {
      const int idx = threadIdx.x + THREADS * e;
      const int at = rows_contig ? (idx / (R / 4)) * LDT + (idx % (R / 4)) * 4
                                 : (idx / (BK / 4)) * LDS + (idx % (BK / 4)) * 4;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[e].x, v[e].y), hi = __floats2bfloat162_rn(v[e].z, v[e].w);
      uint2 pair;
      pair.x = *reinterpret_cast<const uint32_t*>(&lo);
      pair.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(s + at) = pair;
    }
  }
};

// whether an operand's runs are 16-byte aligned: the contiguous stride 1,
// the other a multiple of 4 floats, the base 16-byte aligned
__device__ __forceinline__ bool runs_aligned(const float* p, long long s_r, long long s_c, bool rows_contig) {
  const long long other = rows_contig ? s_c : s_r, unit = rows_contig ? s_r : s_c;
  return unit == 1 && other % 4 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int EPI>
__global__ void __launch_bounds__(THREADS) gemm_kernel(const __grid_constant__ GemmArgs g) {
  __shared__ __align__(16) __nv_bfloat16 As[Operand<BM>::ELEMS];  // A's tile: m rows of k, or k rows of m
  __shared__ __align__(16) __nv_bfloat16 Bs[Operand<BN>::ELEMS];  // B's tile: n rows of k, or k rows of n
  __shared__ float csum_s[THREADS * 4];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kz0 = blockIdx.z * g.k_split;
  const int k_end = min(g.k, kz0 + g.k_split);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  const int q = lane >> 3, j = lane & 7, gr = lane >> 2, t4 = lane & 3;

  // A (m x k) held as m rows of k, rows contiguous when a_si == 1. B (k x
  // n) held as n rows of k: element (n, k) at b[n b_sj + k b_si], rows
  // contiguous when b_sj == 1; then each thread's runs are the 4 columns
  // n0 + (threadIdx.x % 16) 4 + i, for the column sums
  const bool a_rows = g.a_si == 1, b_rows = g.b_sj == 1;
  const bool a_vec = runs_aligned(g.a, g.a_si, g.a_sj, a_rows), b_vec = runs_aligned(g.b, g.b_sj, g.b_si, b_rows);
  const bool colsum = EPI == EPI_STORE && g.colsum != nullptr;
  float csum[4] = {0.f, 0.f, 0.f, 0.f};

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

  Operand<BM> oa;
  Operand<BN> ob;
  oa.load(g.a, g.a_si, g.a_sj, a_rows, a_vec, m0, g.m, kz0, k_end);
  ob.load(g.b, g.b_sj, g.b_si, b_rows, b_vec, n0, g.n, kz0, k_end);
  const uint32_t a_base = smem_addr(As), b_base = smem_addr(Bs);
  for (int k0 = kz0; k0 < k_end; k0 += BK) {
    oa.store(As, a_rows);
    ob.store(Bs, b_rows);
    if (colsum) {
#pragma unroll
      for (int e = 0; e < Operand<BN>::RUNS; ++e) {  // k rows in order, 4 columns a run
        csum[0] += ob.v[e].x;
        csum[1] += ob.v[e].y;
        csum[2] += ob.v[e].z;
        csum[3] += ob.v[e].w;
      }
    }
    __syncthreads();
    if (k0 + BK < k_end) {  // the next k step's operands, in flight during the products
      oa.load(g.a, g.a_si, g.a_sj, a_rows, a_vec, m0, g.m, k0 + BK, k_end);
      ob.load(g.b, g.b_sj, g.b_si, b_rows, b_vec, n0, g.n, k0 + BK, k_end);
    }
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      // fragment matrix q of A: m + 8 (q & 1), k + 8 (q >> 1); of B's pair:
      // k + 8 (q & 1), n + 8 (q >> 1)
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (a_rows)
          ldsm4_t(af[mi], a_base + ((ks + (q >> 1) * 8 + j) * Operand<BM>::LDT + wm + mi * 16 + (q & 1) * 8) * 2);
        else
          ldsm4(af[mi], a_base + ((wm + mi * 16 + (q & 1) * 8 + j) * LDS + ks + (q >> 1) * 8) * 2);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        if (b_rows)
          ldsm4_t(bf, b_base + ((ks + (q & 1) * 8 + j) * Operand<BN>::LDT + wn + np * 16 + (q >> 1) * 8) * 2);
        else
          ldsm4(bf, b_base + ((wn + np * 16 + (q >> 1) * 8 + j) * LDS + ks + (q & 1) * 8) * 2);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          mma(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
  }

  // the epilogue: fragment c of (mi, ni) is row wm + 16 mi + gr + 8 (c / 2),
  // column wn + 8 ni + 2 t4 + c % 2 of the tile
  float* C = g.c + static_cast<long long>(blockIdx.z) * g.c_split;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = m0 + wm + mi * 16 + gr + 8 * (c >> 1);
        const int col = n0 + wn + ni * 8 + 2 * t4 + (c & 1);
        if (r < g.m && col < g.n) {
          float v = acc[mi][ni][c];
          if constexpr (EPI == EPI_BIAS) v = v + g.bias[col];
          if constexpr (EPI == EPI_TANH) v = tanhf(v + g.bias[col]);
          if constexpr (EPI == EPI_DTANH) {
            const float a = g.act[static_cast<long long>(r) * g.ld_act + col];
            v = v * (1.f - a * a);
          }
          C[static_cast<long long>(r) * g.ldc + col] = v;
        }
      }
    }
  }
  if (colsum) {  // the chunk's column sums: the 16 threads of a column's run in thread order
    constexpr int PER_COLUMN = THREADS / (BN / 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) csum_s[threadIdx.x * 4 + i] = csum[i];
    __syncthreads();
    const int col = n0 + threadIdx.x;
    if (blockIdx.x == 0 && threadIdx.x < BN && col < g.n) {
      const int run = threadIdx.x / 4, i = threadIdx.x % 4;
      float s = 0.f;
      for (int t = 0; t < PER_COLUMN; ++t) s += csum_s[(run + (BN / 4) * t) * 4 + i];
      g.colsum[static_cast<long long>(blockIdx.z) * g.colsum_split + col] = s;
    }
  }
}

// Enqueues one product on `stream`, `splits` chunks of k (1: no split).
template <int EPI>
inline cudaError_t gemm(const GemmArgs& g, int splits, cudaStream_t stream) {
  if (g.m <= 0 || g.n <= 0 || g.k <= 0 || splits <= 0 || g.k_split <= 0 ||
      static_cast<long long>(splits) * g.k_split < g.k || (splits > 1 && g.k_split % BK != 0) ||
      (g.colsum != nullptr && (EPI != EPI_STORE || g.b_sj != 1)))
    return cudaErrorInvalidValue;
  const dim3 grid((g.m + BM - 1) / BM, (g.n + BN - 1) / BN, splits);
  gemm_kernel<EPI><<<grid, THREADS, 0, stream>>>(g);
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

// One trunk for the host code: `depth` tanh layers, then the head (layer
// `depth`). Must match ops/cuda_general.py::_TrunkC. The arrays are host
// memory the caller keeps alive for the call.
struct GeneralTrunk {
  int depth;
  const int* dims;        // depth + 2 widths: the input, each layer's outputs, the head's
  const long long* w;     // depth + 1: W_l (dims[l] x dims[l + 1], row-major) at base + w[l]
  const long long* b;     // depth + 1: bias_l (dims[l + 1]) at base + b[l]
  const long long* out;   // depth + 1: layer l's outputs (rows x dims[l + 1]) at workspace + out[l]
};

namespace general {

// Whether a host-side trunk is one the Python wrapper writes: positive
// widths, input width `in`, `outs` outputs, offsets inside their buffers.
inline bool trunk_ok(const GeneralTrunk& T, int in, int outs, long long base_floats) {
  if (T.depth < 0 || T.dims == nullptr || T.w == nullptr || T.b == nullptr || T.out == nullptr ||
      T.dims[0] != in || T.dims[T.depth + 1] != outs)
    return false;
  for (int l = 0; l <= T.depth; ++l) {
    if (T.dims[l] <= 0 || T.dims[l + 1] <= 0 || T.w[l] < 0 || T.b[l] < 0 || T.out[l] < 0 ||
        T.w[l] + static_cast<long long>(T.dims[l]) * T.dims[l + 1] > base_floats ||
        T.b[l] + T.dims[l + 1] > base_floats)
      return false;
  }
  return true;
}

// The forward of one trunk over `rows` rows of x (row stride ldx): the tanh
// layers into workspace + out[l] (row stride dims[l + 1]), the head into
// `head` (row stride dims[depth + 1]). One launch a layer.
inline cudaError_t trunk_forward(const GeneralTrunk& T, const float* base, const float* x, long long ldx, int rows,
                                 float* ws, float* head, cudaStream_t stream) {
  const float* in = x;
  long long ld = ldx;
  for (int l = 0; l <= T.depth; ++l) {
    const int k = T.dims[l], n = T.dims[l + 1];
    GemmArgs g{};
    g.a = in;
    g.a_si = ld;
    g.a_sj = 1;
    g.b = base + T.w[l];
    g.b_si = n;
    g.b_sj = 1;
    g.c = l < T.depth ? ws + T.out[l] : head;
    g.ldc = n;
    g.bias = base + T.b[l];
    g.m = rows;
    g.n = n;
    g.k = k;
    g.k_split = k;
    const cudaError_t e = l < T.depth ? gemm<EPI_TANH>(g, 1, stream) : gemm<EPI_BIAS>(g, 1, stream);
    if (e != cudaSuccess) return e;
    in = g.c;
    ld = n;
  }
  return cudaSuccess;
}

}  // namespace general
