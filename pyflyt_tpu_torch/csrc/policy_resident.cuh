// The general family's resident-trunk forward on Hopper (K4g and K3g's
// route for every trunk that fits a block, policy_general.cu): one launch
// runs every layer of a trunk over a tile of rows, the activations resident
// in shared memory, the weights streamed through a ring of bulk copies.
// With policy_general.cu's entries it replaces
// pyflyt_tpu/ops/pallas_policy.py::build_policy_value_forward and
// pyflyt_tpu/ops/pallas_sgd.py::build_logp_forward at those trunks.
//
// The image (ops/cuda_general.py::pack_resident writes it on the host): for
// each layer l (the tanh layers, then the head) with input width k_l and
// output width n_l, each rounded up to KC (zero past the real widths):
// W_l^T in blocks of `rows` output units x KC inputs, the blocks of a
// chunk of NC outputs in k order, the chunks in n order (rows = NC but in a
// chunk past n_l - NC), each block `rows` lines of KC bf16 (64 bytes), the
// 16-byte group (k % 32) / 8 of line r at group ((k % 32) / 8) ^ ((r / 2) %
// 4) (`swizzle`, conflict-free for ldmatrix); the layers' blocks in order
// from byte w[l], then every bias as n_l f32 from byte b[l]. So the blocks
// lie in the order the kernel consumes them, each 16-byte aligned.
//
// A block takes TILE rows of one trunk (blockIdx.y: the actor or the
// critic) and runs every layer on them. The tile's activations are bf16 in
// two ping-pong buffers of `width` (the widest k_l) + ACT_PAD columns: the
// obs rounded to nearest even on entry, each tanh layer's tanhf(acc +
// bias) rounded the same way as it is stored. Warp 0 walks the weight
// blocks in image order and copies each into the next stage of a ring
// (cp.async.bulk, completing on the stage's `full` mbarrier) once every
// warp has released that stage (its `empty` mbarrier): at each step it
// refills the stage the step before used, STAGES - 1 steps ahead. The
// warps (TILE / 32 along the rows x NW along the chunk's columns, a warp
// 32 rows x WN columns: 16 at 128-row tiles, 4 a scheduler, so that the
// tanh epilogue's long dependent chains and the MMA's latencies hide
// behind each other's) wait for a stage, multiply its block by mma.sync
// m16n8k16 from ldmatrix fragments and release it, with no block barrier
// but one a layer (the next layer reads the whole output). Each output's
// accumulator runs its k16 steps in order from 0, as the per-layer GEMM of
// policy_general.cuh does with the same fragments: a row's outputs are the
// per-layer route's bit for bit, so K3g's log-probs stay K2g's forward.
// K3g's blocks are persistent (a block walks the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...) and stage the head's f32 means in shared
// memory, where one thread a row sums its log-prob (general::row_logp) in
// the action order. The layer loop (`layer`: the ring, the fragments) and
// the forward's epilogue are K2g's resident epoch's too
// (fused_epoch_general.cu), whose walk streams a second, transposed image
// after the forward's for its data gradient.
//
// What bounds it on an H100: at the 3 x 256 trunk (obs 21, act 4) K4g over
// 8192 rows is 4.5 GFLOP of bf16 MMA (4.5 us at 989 TFLOP/s) and K3g over
// 262,144 rows 72 GFLOP (0.073 ms), against a few MB: operations bound
// both. The design reads each input row once and writes only the outputs;
// what remains is mma.sync's rate (wgmma would have to change K2g's
// forward too) and the exact tanhf, which K2g's bits need.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "policy_general.cuh"

namespace resident {

constexpr int NC = 256;             // output units a chunk: a weight block's lines
constexpr int KC = 32;              // a block's depth: two k16 steps (the per-layer GEMM's BK)
constexpr int STAGES = 4;           // ring stages: weight blocks in flight
constexpr int STAGE_BYTES = NC * KC * 2;
constexpr int WN = 64;              // a warp's columns of a chunk: 8 n8 tiles, 64 accumulators
constexpr int NW = NC / WN;         // warps along a chunk's columns
constexpr int MAX_LAYERS = 16;      // tanh layers and the head
constexpr int ACT_PAD = 8;          // bf16 past an activation row: rows 16 bytes apart mod 128
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may opt into

}  // namespace resident

// One trunk's resident image. Must match ops/cuda_general.py::_ResidentTrunkC.
struct ResidentTrunk {
  int layers;                    // tanh layers + the head, 1..MAX_LAYERS
  int k[resident::MAX_LAYERS];   // a layer's input width, a multiple of KC
  int n[resident::MAX_LAYERS];   // its output width, a multiple of KC
  int w[resident::MAX_LAYERS];   // byte offset of its first weight block
  int b[resident::MAX_LAYERS];   // byte offset of its bias (n f32, zero past the real width)
  int bytes;                     // the image's size
};

// K4g's and K3g's launch. Must match ops/cuda_general.py::_ResidentArgsC.
struct ResidentArgs {
  const float* x;             // (n, ld) f32: the obs (K4g) or packed rows [obs | action | ...] (K3g)
  const uint8_t* image[2];    // K4g: the actor's, the critic's; K3g: the actor's
  float* out[2];              // K4g: mean (n, act_dim), value (n,); K3g: log-probs (n,)
  const float* log_std;       // K3g: (act_dim,)
  ResidentTrunk trunk[2];     // as image
  int n;
  int ld;
  int obs_dim;
  int act_dim;
  int has_range;              // K3g: clamp log_std to [ls_lo, ls_hi]
  float ls_lo;
  float ls_hi;
  int tile;                   // rows a block: 128 or 64 (ops/cuda_general.py::resident_tile)
  int width;                  // the activation buffers' width: the widest k of the trunks
};

namespace resident {

// byte offset of W^T entry (line r, k) in a block, k < KC
__host__ __device__ constexpr int swizzle(int r, int k) {
  return r * KC * 2 + ((((k >> 3) ^ (r >> 1)) & 3) << 4) + (k & 7) * 2;
}

// K3g's staged means: a row's stride in floats (odd: one thread a row reads
// without bank conflicts)
__host__ __device__ constexpr int stage_stride(int act_dim) { return act_dim | 1; }

// A layer's bias in shared memory: the widest padded output of a launch
// (a tanh layer's is at most `width`, the heads' act_dim or 1 padded)
__host__ __device__ constexpr int bias_floats(int width, int act_dim) {
  return width > (act_dim + KC - 1) / KC * KC ? width : (act_dim + KC - 1) / KC * KC;
}

// The dynamic shared memory of a launch: the ring, the two activation
// buffers, two bias buffers (a layer's and the next one's), K3g's staged
// means and the ring's full and empty barriers.
__host__ __device__ constexpr int smem_bytes(int tile, int width, int act_dim, bool logp) {
  return STAGES * STAGE_BYTES + 2 * tile * (width + ACT_PAD) * 2 + 2 * bias_floats(width, act_dim) * 4 +
         (logp ? tile * stage_stride(act_dim) * 4 : 0) + STAGES * 16;
}

// Whether a trunk is one ops/cuda_general.py::resident_layout writes for
// `in` inputs and a head of `outs` outputs inside `width` and the image.
inline bool trunk_ok(const ResidentTrunk& T, int in, int outs, int width) {
  if (T.layers < 1 || T.layers > MAX_LAYERS || T.bytes <= 0 || T.bytes % 16 != 0 || T.k[0] < in ||
      T.n[T.layers - 1] < outs)
    return false;
  for (int l = 0; l < T.layers; ++l) {
    if (T.k[l] <= 0 || T.k[l] % KC != 0 || T.k[l] > width || T.n[l] <= 0 || T.n[l] % KC != 0 ||
        T.w[l] % 16 != 0 || T.b[l] % 16 != 0 || static_cast<long long>(T.w[l]) + 2ll * T.k[l] * T.n[l] > T.bytes ||
        static_cast<long long>(T.b[l]) + 4ll * T.n[l] > T.bytes || (l > 0 && T.k[l] != T.n[l - 1]))
      return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// PTX: mbarriers, bulk copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

// spins until the barrier's phase of this parity has completed; traps (a
// launch failure, not a hang) if no copy lands within ~2^32 cycles
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// global -> this block's shared memory, `bytes` (a multiple of 16, both ends
// 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// A block's warps: TILE / 32 along the rows (32 each) x NW along a chunk's
// columns (WN each): 16 warps at 128-row tiles, 4 a scheduler, at most 128
// registers a thread
template <int TILE>
struct Warps {
  static constexpr int MW = TILE / 32;
  static constexpr int THREADS = 32 * MW * NW;
  static constexpr int NT = WN / 8;  // a warp's n8 tiles
};

// Warp 0's place in a trunk's weight blocks: layer, chunk, k step
// and the block's byte offset; `next` walks them in image order, back to
// the first block after the head's last (the next tile), and says whether
// it went back.
struct Cursor {
  int l, c0, k0, off;

  __device__ __forceinline__ int bytes(const ResidentTrunk& T) const { return min(NC, T.n[l] - c0) * KC * 2; }

  __device__ __forceinline__ bool next(const ResidentTrunk& T) {
    off += bytes(T);
    if ((k0 += KC) < T.k[l]) return false;
    k0 = 0;
    if ((c0 += NC) < T.n[l]) return false;
    c0 = 0;
    l = l + 1 < T.layers ? l + 1 : 0;
    off = T.w[l];
    return l == 0;
  }
};

// Warp 0's walk over the weight blocks of SEGS images in turn, each in
// image order (K4g and K3g: one trunk's; K2g: a trunk's forward image,
// then its backward one), back to the first segment after the last. A
// segment of no layers is passed over.
template <int SEGS>
struct Walk {
  static_assert(SEGS == 1 || SEGS == 2, "one or two images");
  const ResidentTrunk* T[SEGS];
  const uint8_t* img[SEGS];
  int seg;
  Cursor cur;

  __device__ __forceinline__ Walk(const ResidentTrunk* const (&t)[SEGS], const uint8_t* const (&im)[SEGS]) : seg(0) {
#pragma unroll
    for (int s = 0; s < SEGS; ++s) {
      T[s] = t[s];
      img[s] = im[s];
    }
    cur = Cursor{0, 0, 0, T[0]->w[0]};
  }

  // x[seg] by a select, not an index (no local memory)
  template <class X>
  __device__ __forceinline__ X pick(const X (&x)[SEGS]) const {
    if constexpr (SEGS == 1) {
      return x[0];
    } else {
      return seg ? x[1] : x[0];
    }
  }

  __device__ __forceinline__ int bytes() const { return cur.bytes(*pick(T)); }
  __device__ __forceinline__ const uint8_t* src() const { return pick(img) + cur.off; }

  __device__ __forceinline__ void next() {
    const bool back = cur.next(*pick(T));
    if constexpr (SEGS == 2) {
      if (back) {
        seg = seg == 0 && T[1]->layers > 0 ? 1 : 0;
        cur = Cursor{0, 0, 0, pick(T)->w[0]};
      }
    }
  }
};

// The ring of a block: its stages' shared memory, their full and empty
// barriers, the consumers' step and warp 0's copies issued of `total`.
struct Ring {
  uint32_t base, full, empty;
  int step, issued, total;
};

// Warp 0, converged: lane 0 copies the walk's block into ring stage `s`;
// every lane moves the walk to the next block.
template <class Wk>
__device__ __forceinline__ void issue(Wk& walk, const Ring& rg, int s) {
  if ((threadIdx.x & 31) == 0) {
    const int bytes = walk.bytes();
    const uint32_t bar = rg.full + 8 * s;
    mbar_expect_tx(bar, bytes);
    bulk_copy(rg.base + s * STAGE_BYTES, walk.src(), bytes, bar);
  }
  walk.next();
}

// TILE rows of f32 x (row stride ld, row0 first, zero past n and `cols`)
// into a bf16 buffer of `k` columns, two columns a thread a step
template <int TILE>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int lda, const float* x, int ld, int n, int cols, int k,
                                          int row0) {
  const int half = k / 2;
  for (int i = threadIdx.x; i < TILE * half; i += Warps<TILE>::THREADS) {
    const int r = i / half, c = 2 * (i % half), row = row0 + r;
    float v0 = 0.f, v1 = 0.f;
    if (row < n) {
      const float* src = x + static_cast<long long>(row) * ld;
      if (c < cols) v0 = src[c];
      if (c + 1 < cols) v1 = src[c + 1];
    }
    *reinterpret_cast<__nv_bfloat162*>(dst + r * lda + c) = __floats2bfloat162_rn(v0, v1);
  }
}

// acc (32 x WN, the warp's rows wm.. and columns wn.. of the chunk) += the
// KC inputs from k0 of the activations at `in` times the block's lines at
// `blk`, k16 step by k16 step; lines past `rows` are skipped unless FULL
// (every line of the warp's is one of the chunk)
template <int NT, bool FULL>
__device__ __forceinline__ void product(float (&acc)[2][NT][4], uint32_t in, int lda, int wm, int wn, int k0,
                                        uint32_t blk, int rows) {
  const int lane = threadIdx.x & 31, q = lane >> 3, j = lane & 7;
#pragma unroll
  for (int ks = 0; ks < KC; ks += 16) {
    // fragment matrix q of A: rows + 8 (q & 1), k + 8 (q >> 1); of the
    // block's lines: units + 8 (q >> 1), k + 8 (q & 1)
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      general::ldsm4(af[mi], in + ((wm + mi * 16 + (q & 1) * 8 + j) * lda + k0 + ks + (q >> 1) * 8) * 2);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const int r = wn + np * 16;
      if (FULL || r < rows) {
        uint32_t bf[4];
        general::ldsm4(bf, blk + swizzle(r + (q >> 1) * 8 + j, ks + (q & 1) * 8));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          general::mma(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          general::mma(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
}

// One layer over the tile: for each chunk of NC of T.n[l] outputs, the
// warp's 32 x WN accumulators over T.k[l] inputs from the bf16 activations
// at `in` (row stride lda), weight block by weight block from the ring
// (warp 0 first copies the blocks up to STAGES - 1 steps ahead, each once
// its stage is free), then epi(acc, c0, rows) with the chunk's first unit
// c0 and its width `rows`. No block barrier: the caller's, before, makes
// `in` whole.
template <int TILE, class Wk, class Epi>
__device__ __forceinline__ void layer(const ResidentTrunk& T, int l, uint32_t in, int lda, Ring& rg, Wk& walk,
                                      Epi&& epi) {
  using W = Warps<TILE>;
  constexpr int NT = W::NT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp % W::MW) * 32, wn = (warp / W::MW) * WN;
  for (int c0 = 0; c0 < T.n[l]; c0 += NC) {
    const int rows = min(NC, T.n[l] - c0);
    float acc[2][NT][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;
    for (int k0 = 0; k0 < T.k[l]; k0 += KC, ++rg.step) {
      if (warp == 0) {  // the copies up to STAGES - 1 steps ahead, each once its stage is free
        for (; rg.issued < rg.total && rg.issued < rg.step + STAGES; ++rg.issued) {
          const int si = rg.issued % STAGES;
          if (rg.issued >= STAGES)  // every warp released step issued - STAGES
            mbar_wait(rg.empty + 8 * si, (rg.issued / STAGES - 1) & 1);
          issue(walk, rg, si);
        }
      }
      const int s = rg.step % STAGES;
      mbar_wait(rg.full + 8 * s, (rg.step / STAGES) & 1);
      const uint32_t blk = rg.base + s * STAGE_BYTES;
      if (wn + WN <= rows)  // every column of the warp's is a unit of the chunk
        product<NT, true>(acc, in, lda, wm, wn, k0, blk, rows);
      else if (wn < rows)
        product<NT, false>(acc, in, lda, wm, wn, k0, blk, rows);
      __syncwarp();  // the warp is done with the stage
      if (lane == 0) mbar_arrive(rg.empty + 8 * s);
    }
    epi(acc, c0, rows);
  }
}

// The forward's epilogue of one chunk (`acc`, `c0`, `rows` as `layer`
// gives them): fragment c of (mi, ni) is row wm + 16 mi + gr + 8 (c / 2),
// column wn + 8 ni + 2 t4 + c % 2 of the chunk. A tanh layer stores
// tanhf(acc + bias) rounded to bf16 into `out` (row stride lda) and, with
// FAC (K2g), each f32 value into `fac` (row stride ldf); the head passes
// each pair of acc + bias to head_fn(r, column, v0, v1).
template <int TILE, bool FAC, int NT, class Head>
__device__ __forceinline__ void forward_epilogue(const float (&acc)[2][NT][4], const float* bias, int c0, int rows,
                                                 bool head, __nv_bfloat16* out, int lda, float* fac, int ldf,
                                                 Head&& head_fn) {
  using W = Warps<TILE>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp % W::MW) * 32, wn = (warp / W::MW) * WN;
  const int gr = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int col = wn + ni * 8 + 2 * t4;
    if (col >= rows) continue;
    const float2 bb = *reinterpret_cast<const float2*>(bias + c0 + col);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mi * 16 + gr + 8 * h, cc = c0 + col;
        const float v0 = acc[mi][ni][2 * h] + bb.x, v1 = acc[mi][ni][2 * h + 1] + bb.y;
        if (!head) {
          const float a0 = tanhf(v0), a1 = tanhf(v1);
          *reinterpret_cast<__nv_bfloat162*>(out + r * lda + cc) = __floats2bfloat162_rn(a0, a1);
          if constexpr (FAC) *reinterpret_cast<float2*>(fac + static_cast<long long>(r) * ldf + cc) = make_float2(a0, a1);
        } else {
          head_fn(r, cc, v0, v1);
        }
      }
    }
  }
}

template <int TILE, bool LOGP>
__global__ void __launch_bounds__(Warps<TILE>::THREADS, 1) resident_kernel(const __grid_constant__ ResidentArgs p) {
  using W = Warps<TILE>;
  constexpr int THREADS = W::THREADS;
  extern __shared__ __align__(128) uint8_t smem[];
  const int job = LOGP ? 0 : blockIdx.y;
  const ResidentTrunk& T = p.trunk[job];
  const uint8_t* img = p.image[job];
  const int lda = p.width + ACT_PAD;
  __nv_bfloat16* act0 = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * STAGE_BYTES);
  __nv_bfloat16* act1 = act0 + TILE * lda;
  const int nb = bias_floats(p.width, p.act_dim);
  float* biases = reinterpret_cast<float*>(act1 + TILE * lda);  // layer l's at biases + (l % 2) nb
  float* means = biases + 2 * nb;                                // K3g
  const int ms = stage_stride(p.act_dim);
  const uint32_t full = general::smem_addr(means + (LOGP ? TILE * ms : 0));

  const int tid = threadIdx.x;
  // block b walks the tiles b, b + gridDim.x, ... (rows past n: zeros, no store)
  const int tiles = (p.n + TILE - 1) / TILE;
  const int my_tiles = blockIdx.x < tiles ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(full + 8 * (STAGES + s), THREADS / 32);  // empty: every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the barriers exist before a copy or an arrival lands in them

  int per_tile = 0;
  for (int l = 0; l < T.layers; ++l) per_tile += (T.n[l] + NC - 1) / NC * (T.k[l] / KC);
  Ring rg{general::smem_addr(smem), full, full + 8 * STAGES, 0, 0, my_tiles * per_tile};
  const ResidentTrunk* const trunks[1] = {&T};
  const uint8_t* const images[1] = {img};
  Walk<1> walk(trunks, images);  // warp 0's: the next block to copy

  for (int g = 0; g < my_tiles; ++g) {
    const int row0 = (blockIdx.x + g * gridDim.x) * TILE;
    load_rows<TILE>(act0, lda, p.x, p.ld, p.n, p.obs_dim, T.k[0], row0);
    for (int l = 0; l < T.layers; ++l) {
      float* bias = biases + (l % 2) * nb;  // the layer before reads the other buffer
      for (int i = tid; i < T.n[l]; i += THREADS) bias[i] = reinterpret_cast<const float*>(img + T.b[l])[i];
      __syncthreads();  // the layer's input and bias are written; every warp is done reading what it writes
      const bool head = l == T.layers - 1;
      __nv_bfloat16* out = l % 2 ? act0 : act1;
      layer<TILE>(T, l, general::smem_addr(l % 2 ? act1 : act0), lda, rg, walk, [&](const auto& acc, int c0, int rows) {
        forward_epilogue<TILE, false>(acc, bias, c0, rows, head, out, lda, nullptr, 0,
                                      [&](int r, int cc, float v0, float v1) {
          if constexpr (LOGP) {
            if (cc < p.act_dim) means[r * ms + cc] = v0;
            if (cc + 1 < p.act_dim) means[r * ms + cc + 1] = v1;
          } else if (row0 + r < p.n) {
            const long long row = row0 + r;
            if (job == 0) {
              if (cc < p.act_dim) p.out[0][row * p.act_dim + cc] = v0;
              if (cc + 1 < p.act_dim) p.out[0][row * p.act_dim + cc + 1] = v1;
            } else if (cc == 0) {
              p.out[1][row] = v0;
            }
          }
        });
      });
    }
    __syncthreads();  // the head's means are staged; every warp is done with the tile's buffers
    if constexpr (LOGP) {
      for (int r = tid; r < TILE; r += THREADS) {
        const long long row = row0 + r;
        if (row < p.n)
          p.out[0][row] = general::row_logp(p.x + row * p.ld + p.obs_dim, means + r * ms, p.log_std, p.act_dim,
                                            p.has_range, p.ls_lo, p.ls_hi);
      }
    }
  }
}

// Enqueues one launch: K4g (LOGP false: grid (tiles, 2)) or K3g
// (persistent: as many blocks as fit the card at once, at most one a tile).
template <int TILE, bool LOGP>
cudaError_t launch(const ResidentArgs& p, cudaStream_t stream) {
  auto kernel = resident_kernel<TILE, LOGP>;
  const int smem = smem_bytes(TILE, p.width, p.act_dim, LOGP);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (p.n + TILE - 1) / TILE;
  dim3 grid(tiles, 2);
  if constexpr (LOGP) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Warps<TILE>::THREADS, smem)) !=
            cudaSuccess)
      return e;
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    grid = dim3(sms * per_sm < tiles ? sms * per_sm : tiles);
  }
  kernel<<<grid, Warps<TILE>::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// the launch of `p`'s tile
template <bool LOGP>
cudaError_t launch_any(const ResidentArgs& p, cudaStream_t stream) {
  return p.tile == 128 ? launch<128, LOGP>(p, stream) : launch<64, LOGP>(p, stream);
}

}  // namespace resident
