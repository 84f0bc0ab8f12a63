// A whole PPO epoch of minibatch SGD on the 2x256 tanh actor-critic:
// for each minibatch in turn, the forward of both trunks, the clipped-
// surrogate and value losses, a backward derived by hand, the global-norm
// clip, Adam over every parameter, and one metrics row.
//
// Replaces pyflyt_tpu/ops/pallas_sgd.py::build_fused_epoch with its
// arithmetic (pallas_sgd.py:21-26, :64-92, :357-512): every matmul takes
// bf16 inputs (round to nearest even) and accumulates in f32; everything
// elementwise (the tanh, the 1 - h^2 factors from the f32 activations),
// the bias sums of dz, the reductions, the clip and Adam are f32. The loss
// keeps the Pallas kernel's corner cases: advantages normalised with the
// given per-minibatch mean/std, the 50/50 cotangent split where the two
// surrogate terms tie, and a log_std gradient masked by the strict
// inequality of the clamp band; metrics from the pre-update log_std.
//
// What bounds it on an H100: about 837 kFLOP of bf16 matmul per row
// (forward, data gradient of every layer but the first, weight gradient of
// every layer), 219 GFLOP (0.22 ms at 989 TFLOP/s) for an epoch of
// 32 x 8192 rows, against 29 MB of minibatch rows and 3.5 MB of parameters
// and moments in and out (about 10 us at 3.35 TB/s): operations bound it.
//
// Design: four kernels per minibatch, queued in order on one stream by one
// host call (minibatch m + 1 reads what update m wrote), all on Hopper's
// wgmma with operands landed by bulk copies on mbarriers (policy_mlp.cuh),
// plus one kernel per call that writes the first weight images. Each is a
// programmatic dependent launch of the one before (pdl_wait), which hides
// the launch gaps.
//  A. fwd_bwd_kernel: K4's block (policy_mlp.cuh's top comment): grid
//     (blocks, 2), blockIdx.y the trunk (actor, critic), the trunk's weight
//     image resident in shared memory, a producer warpgroup and two
//     consumer warpgroups walking 64-row tiles. A consumer runs its tile's
//     forward (activations in registers), the per-row loss and its
//     derivative in the head's epilogue, and the data gradient:
//       dz2 = (bf16(dhead) W_head^T) * (1 - h2^2), four m64n64 pieces, the
//           f32 factor kept in the layer-1 accumulator's registers;
//       dz1 = (bf16(dz2) W1^T) * (1 - h1^2), with W1^T read from the same
//           resident image through the MN-major descriptor, and the f32
//           factor of layer 0 spilled to a per-consumer f32 tile in device
//           memory (it stays in L2) and read back by the thread that wrote
//           it: 232 registers hold one 64 x 256 f32 tile, not two. The
//           spill costs about two thirds of recomputing h1 from the obs
//           tile (a third tanh pass), as measured on the card (PERF.md).
//     It writes bf16 x, h1, h2, dz1, dz2 as 64 x 64 blocks in the wgmma's
//     128-byte-swizzled order (through a per-warp staging buffer, in whole
//     128-byte lines), bf16 dhead as an (8 x 64) K-major block, the tile's
//     f32 column sums of dz1, dz2 and dhead (the bias gradients) and its 11
//     partial sums (metrics, log_std gradient).
//  B. wgrad_kernel: the weight gradients A^T dZ as a split-K GEMM over the
//     minibatch's row tiles: grid (splits, 12 jobs); a job is one trunk's
//     W0 (64 inputs x 256), a 64-input slice of W1, or the head (256 x 8,
//     four m64n8 products). One warpgroup a block; thread 0 keeps a ring
//     of 4 stages of bulk copies in flight; A = X^T read MN-major
//     (transposed A), B = dZ read MN-major. The split's partials go to an
//     f32 slab, beside its sums of the bias columns and of the log_std
//     partials over its tiles.
//  C1. reduce_kernel: the gradient as the slabs' sums, per-block sums of
//     squares, the metrics row; every sum over tiles or slabs in a fixed
//     order: no atomics, the epoch is bit-reproducible.
//  C2. adam_kernel: every block sums the block sums of squares in the same
//     order (the global norm), clips, runs Adam (bias correction
//     1 - exp(t ln b), t = t0 + m + 1) in place, and writes each updated
//     weight into both trunks' images (bf16 at its swizzled slot, biases
//     f32), so the next minibatch's bulk copies land it as is.
// Parameters, moments and gradients are flat f32 vectors; each leaf starts
// at a multiple of 4 floats (offsets from the wrapper; the padding stays 0).
// The image layout is ops/cuda_policy.py::pack_trunk's; the flat index ->
// image slot rule is written once more in ops/cuda_sgd.py::image_slots.
#include "policy_mlp.cuh"

#include <algorithm>

namespace {

using pmlp::HEAD_N;
using pmlp::HID;
using pmlp::KC;
using pmlp::TILE_M;

constexpr int MAX_ACT = HEAD_N;
constexpr int NPART = 3 + MAX_ACT;  // per tile: sum pg_min, sum verr^2, sum (old - logp), g_logstd
constexpr int BLOCK_BYTES = TILE_M * KC * 2;            // a 64 x 64 bf16 block of the workspace
constexpr int TILE_BYTES = (HID / KC) * BLOCK_BYTES;    // a 64 x 256 activation tile: 4 blocks
constexpr int HEAD_TILE_BYTES = HEAD_N * TILE_M * 2;    // dhead of a tile: 8 outputs x 64 rows
constexpr int COLS = 2 * HID + HEAD_N;                  // column sums of a tile: dz1, dz2, dhead
constexpr int ACTS = 4;                                 // workspace tiles a trunk and row tile
enum Act { H1, H2, DZ1, DZ2 };
constexpr int SMALL = HEAD_N + NPART + 1;               // dhead sums, partials (padded)
constexpr int JOBS = 6;                                 // wgrad jobs a trunk: W0, W1 x 4, head
constexpr int WG_THREADS = 128;
constexpr int WG_STAGES = 4;
constexpr int WG_STAGE_BYTES = BLOCK_BYTES + TILE_BYTES;  // the largest A + B of a job
constexpr int THREADS = 256;                            // reduce, Adam, image

// wgmma descriptor offsets of the backward's MN-major reads (tests/
// test_torch_epoch_layout.py reads these lines)
constexpr int W1T_LBO = 32768;  // W1^T: 64-wide atoms of inputs are the image's K-chunks
constexpr int W1T_SBO = 1024;   // 8 output rows of 128 bytes
constexpr int HWT_SBO = 0;      // W_head^T: K rows 8-15 alias rows 0-7 (A is zero there)
constexpr int WS_LBO = 8192;    // the workspace: 64-wide atoms are 64 x 64 blocks
constexpr int WS_SBO = 1024;    // 8 rows of 128 bytes
static_assert(W1T_LBO == pmlp::W1_CHUNK_BYTES && WS_LBO == BLOCK_BYTES, "descriptor offsets");

// one trunk's image (ops/cuda_policy.py: W1_OFF, HW_OFF, B0_OFF, B1_OFF,
// HB_OFF, TRUNK_BYTES)
constexpr int IMG_W1 = pmlp::W0_BYTES;
constexpr int IMG_HW = IMG_W1 + pmlp::W1_CHUNKS * pmlp::W1_CHUNK_BYTES;
constexpr int IMG_B0 = IMG_HW + pmlp::HW_BYTES;
constexpr int IMG_B1 = IMG_B0 + HID * 4;
constexpr int IMG_HB = IMG_B1 + HID * 4;
constexpr int IMG_BYTES = IMG_HB + HEAD_N * 4;

constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float ADAM_EPS = 1e-5f;
constexpr float LN_B1 = -0.10536051565782628f;   // log(0.9)
constexpr float LN_B2 = -0.0010005003335835335f; // log(0.999)
constexpr float LOG2PI = 1.8378770664093453f;    // log(2 pi)
constexpr float ENT_C = 1.4189385332046727f;     // 0.5 log(2 pi e)

// leaf order of ops/cuda_sgd.py::leaf_specs for two trunk layers
enum Leaf {
  PI_W0, PI_B0, PI_W1, PI_B1, PI_HW, PI_HB, LOG_STD,
  VF_W0, VF_B0, VF_W1, VF_B1, VF_HW, VF_HB, N_LEAVES
};
// a trunk's leaves from its first (PI_W0 or VF_W0)
enum Kind { K_W0, K_B0, K_W1, K_B1, K_HW, K_HB };

}  // namespace

// Must match pyflyt_tpu_torch/ops/cuda_sgd.py::_EpochArgsC.
struct EpochArgs {
  const float* mbs;        // (n_mb, mb, feat) f32: [obs | action | old_logp | adv | ret]
  const float* adv_stats;  // (n_mb, 2) f32: advantage mean, population std
  const int* t0;           // (1,) int32: Adam's count before the epoch
  float* params;           // (P,) f32, updated in place
  float* mu;               // (P,) f32, first moment, in place
  float* nu;               // (P,) f32, second moment, in place
  float* metrics;          // (n_mb, 5) f32: loss, pg_loss, v_loss, entropy, approx_kl
  uint8_t* image;          // (2, IMG_BYTES): actor and critic images (cuda_policy.pack_trunk), zero padding
  uint8_t* ws_x;           // (tiles, BLOCK_BYTES) bf16 obs blocks
  uint8_t* ws_act;         // (2, ACTS, tiles, TILE_BYTES) bf16 h1, h2, dz1, dz2
  uint8_t* ws_head;        // (2, tiles, HEAD_TILE_BYTES) bf16 dmean / dvalue, K-major
  float* spill;            // (spill_slots, 64 x 256) f32: 1 - h1^2 of a consumer's tile
  float* colsum;           // (2, tiles, COLS) f32
  float* tile_part;        // (tiles, NPART) f32
  float* gpart;            // (splits, P) f32: weight-gradient partials
  float* grad;             // (P,) f32
  float* block_sq;         // (ceil(P / 256),) f32
  int off[N_LEAVES];       // leaf offsets into the flat vectors
  int P;
  int n_mb;
  int mb;
  int feat;
  int obs_dim;
  int act_dim;
  int splits;
  int spill_slots;
  float lr;
  float clip_eps;
  float ent_coef;
  float vf_coef;
  float max_grad_norm;
  int has_range;
  float ls_lo;
  float ls_hi;
};

namespace {

__device__ __forceinline__ int n_tiles(const EpochArgs& p) { return (p.mb + TILE_M - 1) / TILE_M; }

// row tiles a wgrad split reduces (the last split may take fewer)
__device__ __forceinline__ int tiles_per_split(const EpochArgs& p) {
  return (n_tiles(p) + p.splits - 1) / p.splits;
}

__host__ __device__ __forceinline__ int leaf_size(int l, int obs_dim, int act_dim) {
  switch (l) {
    case PI_W0: case VF_W0: return obs_dim * HID;
    case PI_W1: case VF_W1: return HID * HID;
    case PI_HW: return HID * act_dim;
    case VF_HW: return HID;
    case PI_HB: case LOG_STD: return act_dim;
    case VF_HB: return 1;
    default: return HID;  // the trunks' biases
  }
}

// the leaf holding flat index i, or -1 (padding)
__device__ __forceinline__ int leaf_of(const EpochArgs& p, int i) {
  for (int l = 0; l < N_LEAVES; ++l)
    if (i >= p.off[l] && i < p.off[l] + leaf_size(l, p.obs_dim, p.act_dim)) return l;
  return -1;
}

// byte offset of entry (k, n) of a weight with `rows` output rows in its
// image region (ops/cuda_policy.py::swizzle_offset)
__device__ __forceinline__ uint32_t swizzle_offset(int k, int n, int rows) {
  return (k / KC) * rows * 128 + n * 128 + ((((k % KC) / 8) ^ (n % 8)) * 16) + (k % 8) * 2;
}

// A workspace tile: 64 rows x 256 columns of bf16 in four 64-wide blocks,
// each 64 rows of 128 bytes with the 128-byte swizzle: (row r, column c)
// at byte (c / 64) BLOCK_BYTES + 128 r + (((c % 64) / 8) ^ (r % 8)) 16 +
// (c % 8) 2 (ops/cuda_sgd.py::workspace_offset), so the weight-gradient
// kernel's bulk copies land each block as its MN-major wgmma operand.
//
// Rows rbase .. rbase + 7 (rbase a multiple of 8) x the 64 columns of
// block b of a workspace tile from this warp's fragment words w[k] (column
// group 8 b + k: row rbase + lane / 4, columns 2 (lane % 4), + 1), through
// the warp's 1 KB staging buffer: two stmatrix.x4 lay the 8 rows out in
// the tile's own swizzled order, so each lane then copies 16 bytes of two
// contiguous 512-byte runs: whole 128-byte lines, where a store straight
// from the fragments writes 4 bytes into each of 8 lines.
__device__ __forceinline__ void store_rows(uint8_t* stage, uint8_t* tile, int b, int rbase, const uint32_t (&w)[8],
                                           int lane) {
  const int rho = lane % 8, jm = lane / 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t at = pmlp::smem_u32(stage + rho * 128 + (((4 * h + jm) ^ rho) * 16));
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(at), "r"(w[4 * h]),
                 "r"(w[4 * h + 1]), "r"(w[4 * h + 2]), "r"(w[4 * h + 3])
                 : "memory");
  }
  __syncwarp();
  uint8_t* dst = tile + b * BLOCK_BYTES + rbase * 128;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    *reinterpret_cast<uint4*>(dst + 512 * h + 16 * lane) = *reinterpret_cast<const uint4*>(stage + 512 * h + 16 * lane);  // probe: ws_store
  __syncwarp();
}

// The 64 x 256 tile of fragment words a[2 i + hh] (rows r0 + 8 hh, column
// group i) into its four workspace blocks.
__device__ __forceinline__ void store_tile(uint8_t* stage, uint8_t* tile, const uint32_t (&a)[64], int warp, int lane) {
#pragma unroll
  for (int b = 0; b < HID / KC; ++b)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) w[k] = a[2 * (8 * b + k) + hh];
      store_rows(stage, tile, b, 16 * warp + 8 * hh, w, lane);
    }
}

// Programmatic dependent launch: each kernel after the first is launched
// while its predecessor runs (its blocks take SMs as they free up) and
// waits here, before it reads anything, until the predecessor has
// finished and its writes are visible; each kernel lets its successor
// launch at once. Hides the launch gap between the epoch's kernels.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void pdl_launch_next() { asm volatile("griddepcontrol.launch_dependents;" ::: "memory"); }

// flat parameter i, now `v`, into its image slot (log_std and padding have none)
__device__ __forceinline__ void write_image(const EpochArgs& p, int i, float v) {
  const int l = leaf_of(p, i);
  if (l < 0 || l == LOG_STD) return;
  const int tr = l >= VF_W0 ? 1 : 0, kind = l - (tr ? VF_W0 : PI_W0), e = i - p.off[l];
  uint8_t* img = p.image + static_cast<size_t>(tr) * IMG_BYTES;
  const int outs = tr ? 1 : p.act_dim;
  uint32_t at;
  switch (kind) {
    case K_W0: at = swizzle_offset(e / HID, e % HID, HID); break;
    case K_W1: at = IMG_W1 + swizzle_offset(e / HID, e % HID, HID); break;
    case K_HW: at = IMG_HW + swizzle_offset(e / outs, e % outs, HEAD_N); break;
    case K_B0: *reinterpret_cast<float*>(img + IMG_B0 + 4 * e) = v; return;
    case K_B1: *reinterpret_cast<float*>(img + IMG_B1 + 4 * e) = v; return;
    default: *reinterpret_cast<float*>(img + IMG_HB + 4 * e) = v; return;
  }
  *reinterpret_cast<__nv_bfloat16*>(img + at) = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// A: forward, loss and data gradient
// ---------------------------------------------------------------------------

struct SmemF {
  // the fields pmlp::load_weights fills, each wgmma operand at 1024 bytes
  uint8_t w0[pmlp::W0_BYTES];
  uint8_t w1[pmlp::W1_CHUNKS][pmlp::W1_CHUNK_BYTES];
  uint8_t hw[pmlp::W1_CHUNKS][pmlp::HW_CHUNK_BYTES];
  float x[pmlp::CONSUMERS][TILE_M * pmlp::OBS_LD];  // each consumer's f32 obs tile
  float b0[HID];
  float b1[HID];
  float hb[HEAD_N];
  uint8_t stage[pmlp::CONSUMERS * 4][1024];   // each consumer warp's store staging (store_rows)
  float red[pmlp::CONSUMERS][4][HID];          // per-warp column sums of dz2, then of dz1
  float red_small[pmlp::CONSUMERS][4][SMALL];  // per-warp dhead sums and partials
  uint64_t bar_w[pmlp::N_BAR_W];
  uint64_t full[pmlp::CONSUMERS];
  uint64_t empty[pmlp::CONSUMERS];
};
constexpr int SMEM_F = static_cast<int>(sizeof(SmemF)) + 1024;
static_assert(SMEM_F <= 232448, "more shared memory than a block can have");

// v[N]: a thread's sums over its two rows of N columns (column of entry
// idx: 8 (idx / 2) + 2 (lane % 4) + idx % 2 from the fragment's base);
// sums them over the 8 lanes that hold the same columns (lane bits 2-4) by
// halving: 3 exchanges of N / 2, N / 4, N / 8 values. Afterwards v[k], k <
// N / 8, is the warp's sum of entry (N / 8) (lane / 4) + k. A fixed order.
template <int N>
__device__ __forceinline__ void lane_sums(float (&v)[N], int lane) {
#pragma unroll
  for (int st = 0; st < 3; ++st) {
    const int msk = 16 >> st;
    const int half = N >> (st + 1);
    const bool up = (lane & msk) != 0;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float keep = up ? v[half + k] : v[k];
      const float give = up ? v[k] : v[half + k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, give, msk);
    }
  }
}

__device__ __forceinline__ float quad_rows_sum(float v) {  // over lanes of equal lane % 4
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 1; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the 128 threads of consumer warpgroup j
__device__ __forceinline__ void wg_sync(int j) { asm volatile("bar.sync %0, 128;" ::"r"(1 + j) : "memory"); }

// Consumer warpgroup j: every second tile of the block. Thread t holds rows
// r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8 of every fragment, columns
// 8 i + 2 (t % 4) (+ 1) (policy_mlp.cuh::tanh_to_frag).
__device__ __forceinline__ void consume_epoch(SmemF& s, const EpochArgs& p, int m) {
  using namespace pmlp;
  const int j = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
  const int r0 = 16 * warp + g;
  const bool critic = blockIdx.y != 0;
  const int tr = critic ? 1 : 0;
  const int ksteps = (p.obs_dim + 15) / 16;
  const int tiles = n_tiles(p);
  const float* rows = p.mbs + static_cast<size_t>(m) * p.mb * p.feat;
  const float inv_mb = 1.f / static_cast<float>(p.mb);
  const int c0 = p.obs_dim + p.act_dim;
  uint8_t* ws = p.ws_act + static_cast<size_t>(tr) * ACTS * tiles * TILE_BYTES;
  float4* spill = reinterpret_cast<float4*>(p.spill) +
                  (static_cast<size_t>(blockIdx.y * gridDim.x + blockIdx.x) * CONSUMERS + j) * (TILE_M * HID / 4);
  const float* xs = s.x[j];
  uint8_t* stage = s.stage[4 * j + warp];
  // this thread's two action columns: log_std (clipped) and its variance
  float ls[2], var[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int jj = 2 * q + e;
    ls[e] = 0.f;
    if (!critic && jj < p.act_dim) {
      ls[e] = p.params[p.off[LOG_STD] + jj];
      if (p.has_range) ls[e] = fminf(fmaxf(ls[e], p.ls_lo), p.ls_hi);
    }
    var[e] = expf(2.f * ls[e]);
  }
  float d[128];
  uint32_t a[64];
  int k = 0;
  for (int tile = blockIdx.x + j * gridDim.x; tile < tiles; tile += CONSUMERS * gridDim.x, ++k) {
    const int row0 = tile * TILE_M;
    uint8_t* h1t = ws + (static_cast<size_t>(H1) * tiles + tile) * TILE_BYTES;
    uint8_t* h2t = ws + (static_cast<size_t>(H2) * tiles + tile) * TILE_BYTES;
    uint8_t* dz1t = ws + (static_cast<size_t>(DZ1) * tiles + tile) * TILE_BYTES;
    uint8_t* dz2t = ws + (static_cast<size_t>(DZ2) * tiles + tile) * TILE_BYTES;

    // ---- the obs tile as bf16 A fragments; the actor writes its block
    mbar_wait(&s.full[j], k & 1);
    uint32_t x[16];
    obs_frags(xs, r0, q, ksteps, x);
    mbar_arrive(&s.empty[j]);
    if (!critic) {  // column group i of rows r0 + 8 hh is x[4 (i / 2) + 2 (i % 2) + hh]
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = x[4 * (i / 2) + 2 * (i % 2) + hh];
        store_rows(stage, p.ws_x + static_cast<size_t>(tile) * BLOCK_BYTES, 0, 16 * warp + 8 * hh, w, lane);
      }
    }

    // ---- layer 0; h1 = tanh(. + b0) into a (bf16), the workspace, and 1 - h1^2 into the spill
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
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float2 b = *reinterpret_cast<const float2*>(s.b0 + 8 * i + 2 * q);
      float gg[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float u = tanhf(d[4 * i + 2 * hh] + b.x), w = tanhf(d[4 * i + 2 * hh + 1] + b.y);  // probe: tanh
        a[2 * i + hh] = pack_bf16(u, w);
        gg[2 * hh] = 1.f - u * u;
        gg[2 * hh + 1] = 1.f - w * w;
      }
      spill[i * 128 + t] = make_float4(gg[0], gg[1], gg[2], gg[3]);  // probe: spill_store
    }
    store_tile(stage, h1t, a, warp, lane);

    // ---- layer 1; h2 = tanh(. + b1) into a (bf16) and the workspace, 1 - h2^2 stays in d
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
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float2 b = *reinterpret_cast<const float2*>(s.b1 + 8 * i + 2 * q);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float u = tanhf(d[4 * i + 2 * hh] + b.x), w = tanhf(d[4 * i + 2 * hh + 1] + b.y);  // probe: tanh
        a[2 * i + hh] = pack_bf16(u, w);
        d[4 * i + 2 * hh] = 1.f - u * u;
        d[4 * i + 2 * hh + 1] = 1.f - w * w;
      }
    }
    store_tile(stage, h2t, a, warp, lane);

    // ---- the rows' loss inputs, loaded while the head multiplies: the
    // actor's actions (its two columns), old log-prob and advantage; the
    // critic's return
    float in_a[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, in_0[2] = {0.f, 0.f}, in_1[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + r0 + 8 * hh;
      if (row < p.mb) {
        const float* rw = rows + static_cast<size_t>(row) * p.feat;
        if (!critic) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (2 * q + e < p.act_dim) in_a[hh][e] = rw[p.obs_dim + 2 * q + e];
          in_0[hh] = rw[c0];
          in_1[hh] = rw[c0 + 1];
        } else if (q == 0) {
          in_0[hh] = rw[c0 + 2];
        }
      }
    }

    // ---- the head: columns 2q, 2q + 1 of rows r0 (h[0..1]) and r0 + 8 (h[2..3])
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

    // ---- the loss of each row and d(loss)/d(head), dm, in the same layout
    float dm[4] = {0.f, 0.f, 0.f, 0.f};
    float pg = 0.f, vsq = 0.f, kl = 0.f, gls[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const bool ok = row0 + r0 + 8 * hh < p.mb;
      if (!critic) {
        float diff[2] = {0.f, 0.f}, lp = 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = 2 * q + e;
          if (ok && jj < p.act_dim) {
            diff[e] = in_a[hh][e] - (h[2 * hh + e] + s.hb[jj]);
            lp += -0.5f * (diff[e] * diff[e] / var[e] + 2.f * ls[e] + LOG2PI);
          }
        }
        lp += __shfl_xor_sync(0xffffffffu, lp, 1);  // the row's log-prob: its quad's columns
        lp += __shfl_xor_sync(0xffffffffu, lp, 2);
        if (ok) {
          const float old_logp = in_0[hh], adv = in_1[hh];
          const float ratio = expf(lp - old_logp);
          const float adv_n = (adv - p.adv_stats[2 * m]) / (p.adv_stats[2 * m + 1] + 1e-8f);
          const float lo_c = 1.f - p.clip_eps, hi_c = 1.f + p.clip_eps;
          const float clipped = fminf(fmaxf(ratio, lo_c), hi_c);
          const float pg1 = ratio * adv_n, pg2 = clipped * adv_n;
          const float inband = (ratio >= lo_c && ratio <= hi_c) ? 1.f : 0.f;
          const float d1 = adv_n, d2 = adv_n * inband;
          const float dmin = pg1 == pg2 ? 0.5f * (d1 + d2) : (pg1 < pg2 ? d1 : d2);
          const float g_logp = (-inv_mb) * dmin * ratio;
          if (q == 0) {
            pg += fminf(pg1, pg2);
            kl += old_logp - lp;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (2 * q + e < p.act_dim) {
              dm[2 * hh + e] = g_logp * (diff[e] / var[e]);
              gls[e] += g_logp * (diff[e] * diff[e] / var[e] - 1.f);
            }
          }
        }
      } else if (ok && q == 0) {
        const float verr = h[2 * hh] + s.hb[0] - in_0[hh];
        vsq += verr * verr;
        dm[2 * hh] = (p.vf_coef * inv_mb) * verr;
      }
    }
    {  // dhead as bf16: the workspace's K-major (8 x 64) block
      uint8_t* hdt = p.ws_head + (static_cast<size_t>(tr) * tiles + tile) * HEAD_TILE_BYTES;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = 2 * q + e, r = r0 + 8 * hh;
          *reinterpret_cast<__nv_bfloat16*>(hdt + swizzle_offset(r, jj, HEAD_N)) = __float2bfloat16_rn(dm[2 * hh + e]);
        }
    }
    {  // the tile's dhead column sums and partials: per warp into shared memory
      float* rs = s.red_small[j][warp];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ds = quad_rows_sum(dm[e] + dm[2 + e]);
        const float gs = quad_rows_sum(gls[e]);
        if (g == 0) {
          rs[2 * q + e] = ds;
          rs[HEAD_N + 3 + 2 * q + e] = gs;
        }
      }
      pg = warp_sum(pg);
      vsq = warp_sum(vsq);
      kl = warp_sum(kl);
      if (lane == 0) {
        rs[HEAD_N + 0] = pg;
        rs[HEAD_N + 1] = vsq;
        rs[HEAD_N + 2] = kl;
      }
    }

    // ---- dz2 = (bf16(dm) W_head^T) * (1 - h2^2), 64 columns a piece:
    // a <- bf16(dz2) (the A fragments of the next product), the workspace,
    // column sums
    const uint32_t hd0 = pack_bf16(dm[0], dm[1]), hd1 = pack_bf16(dm[2], dm[3]);
#pragma unroll
    for (int pc = 0; pc < W1_CHUNKS; ++pc) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      wg_fence();
      wgmma_m64n64k16_rs<1>(acc, hd0, hd1, 0u, 0u, mn_desc(s.hw[pc], HW_CHUNK_BYTES, HWT_SBO));
      wg_commit();
      wg_wait0();
      fence_regs(acc);
      float v[16];
#pragma unroll
      for (int i2 = 0; i2 < 8; ++i2) {
        const int i = 8 * pc + i2;
        float dz[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) dz[e] = acc[4 * i2 + e] * d[4 * i + e];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) a[2 * i + hh] = pack_bf16(dz[2 * hh], dz[2 * hh + 1]);
        v[2 * i2] = dz[0] + dz[2];
        v[2 * i2 + 1] = dz[1] + dz[3];
      }
      lane_sums(v, lane);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) s.red[j][warp][64 * pc + 8 * g + 2 * q + kk] = v[kk];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t w[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) w[k] = a[2 * (8 * pc + k) + hh];
        store_rows(stage, dz2t, pc, 16 * warp + 8 * hh, w, lane);
      }
    }
    // the tile's dz2 column sums over its four warps, in order
    float* cs = p.colsum + (static_cast<size_t>(tr) * tiles + tile) * COLS;
    wg_sync(j);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int c = t + 128 * h2;
      cs[HID + c] = ((s.red[j][0][c] + s.red[j][1][c]) + s.red[j][2][c]) + s.red[j][3][c];
    }
    wg_sync(j);

    // ---- dz1 = (bf16(dz2) W1^T) * (1 - h1^2): W1^T from the resident image, MN-major
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < HID / 16; ++kb)
      wgmma_m64n256k16_rs<1>(d, a[4 * kb], a[4 * kb + 1], a[4 * kb + 2], a[4 * kb + 3],
                             mn_desc(s.w1[0] + 16 * 128 * kb, W1T_LBO, W1T_SBO));
    wg_commit();
    wg_wait0();
    fence_regs(d);
    fence_regs(a);
    {
      float v[64];
#pragma unroll
      for (int i0 = 0; i0 < 32; i0 += 8) {  // the spill back 8 loads at a time: 4 round trips to L2, not 32
        float4 gg[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) gg[u] = spill[(i0 + u) * 128 + t];  // probe: spill_load
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u;
          const float dz[4] = {d[4 * i] * gg[u].x, d[4 * i + 1] * gg[u].y, d[4 * i + 2] * gg[u].z,
                               d[4 * i + 3] * gg[u].w};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) a[2 * i + hh] = pack_bf16(dz[2 * hh], dz[2 * hh + 1]);
          v[2 * i] = dz[0] + dz[2];
          v[2 * i + 1] = dz[1] + dz[3];
        }
      }
      lane_sums(v, lane);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) s.red[j][warp][32 * g + 8 * (kk / 2) + 2 * q + kk % 2] = v[kk];
    }
    store_tile(stage, dz1t, a, warp, lane);

    // ---- the tile's dz1, dhead and partial sums over its four warps, in order
    wg_sync(j);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int c = t + 128 * h2;
      cs[c] = ((s.red[j][0][c] + s.red[j][1][c]) + s.red[j][2][c]) + s.red[j][3][c];
    }
    if (t < HEAD_N) {
      float sh = 0.f;
      for (int w = 0; w < 4; ++w) sh += s.red_small[j][w][t];
      cs[2 * HID + t] = sh;
    } else if (t < HEAD_N + NPART) {
      const int k2 = t - HEAD_N;  // partial k2: the critic owns 1, the actor the rest
      if ((k2 == 1) == critic) {
        float sp = 0.f;
        for (int w = 0; w < 4; ++w) sp += s.red_small[j][w][HEAD_N + k2];
        p.tile_part[static_cast<size_t>(tile) * NPART + k2] = sp;
      }
    }
    wg_sync(j);  // shared sums read before the next tile writes them
  }
}

__global__ void __launch_bounds__(pmlp::THREADS, 1) fwd_bwd_kernel(const EpochArgs p, int m) {
  using namespace pmlp;
  pdl_wait();
  pdl_launch_next();
  SmemF& s = smem<SmemF>();
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
    if (threadIdx.x % 128 == 0) {
      const uint8_t* img = p.image + static_cast<size_t>(blockIdx.y) * IMG_BYTES;
      const TrunkSrc w{img, reinterpret_cast<const float*>(img + IMG_B0), img + IMG_W1,
                       reinterpret_cast<const float*>(img + IMG_B1), img + IMG_HW,
                       reinterpret_cast<const float*>(img + IMG_HB)};
      load_weights(s, w);
    }
    const float* rows = p.mbs + static_cast<size_t>(m) * p.mb * p.feat;
    const int tiles = n_tiles(p);
    int i = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
      const int j = i % CONSUMERS, use = i / CONSUMERS;
      mbar_wait(&s.empty[j], (use & 1) ^ 1);  // a fresh barrier's "previous" phase is complete
      load_tile(s.x[j], rows, p.feat, p.mb, p.obs_dim, tile * TILE_M);
      cp_async_arrive(&s.full[j]);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  consume_epoch(s, p, m);
}

// ---------------------------------------------------------------------------
// B: weight gradients, split-K over the row tiles
// ---------------------------------------------------------------------------

struct SmemW {
  uint8_t stage[WG_STAGES][WG_STAGE_BYTES];  // A at the stage's start, B after it
  uint64_t full[WG_STAGES];
};
constexpr int SMEM_W = static_cast<int>(sizeof(SmemW)) + 1024;
static_assert(SMEM_W <= 232448, "more shared memory than a block can have");

// Block (split, job): one trunk's W0 (x^T dz1), one 64-input slice of W1
// (h1^T dz2) or its head (h2^T dhead) over the split's row tiles, in
// order; the partial goes to slab `split` of gpart, beside the split's
// sums of the bias gradients (W0's and the first W1 slice's jobs, the
// head's) and of the actor's log_std gradient (its head's job).
__global__ void __launch_bounds__(WG_THREADS, 1) wgrad_kernel(const EpochArgs p) {
  using namespace pmlp;
  pdl_wait();
  pdl_launch_next();
  SmemW& s = smem<SmemW>();
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, q = lane % 4;
  const int r0 = 16 * warp + lane / 4;
  const int tiles = n_tiles(p), per = tiles_per_split(p), split = blockIdx.x;
  const int tb = split * per, n = min(tiles, tb + per) - tb;
  const int tr = blockIdx.y / JOBS, kind = blockIdx.y % JOBS;
  const bool head = kind == JOBS - 1;
  const uint8_t* act = p.ws_act + static_cast<size_t>(tr) * ACTS * tiles * TILE_BYTES;
  const uint8_t* a_src;
  const uint8_t* b_src;
  int a_bytes, a_stride, b_bytes, b_stride;
  if (kind == 0) {
    a_src = p.ws_x; a_bytes = a_stride = BLOCK_BYTES;
    b_src = act + static_cast<size_t>(DZ1) * tiles * TILE_BYTES; b_bytes = b_stride = TILE_BYTES;
  } else if (!head) {
    a_src = act + static_cast<size_t>(H1) * tiles * TILE_BYTES + (kind - 1) * BLOCK_BYTES;
    a_bytes = BLOCK_BYTES; a_stride = TILE_BYTES;
    b_src = act + static_cast<size_t>(DZ2) * tiles * TILE_BYTES; b_bytes = b_stride = TILE_BYTES;
  } else {
    a_src = act + static_cast<size_t>(H2) * tiles * TILE_BYTES; a_bytes = a_stride = TILE_BYTES;
    b_src = p.ws_head + static_cast<size_t>(tr) * tiles * HEAD_TILE_BYTES; b_bytes = b_stride = HEAD_TILE_BYTES;
  }
  if (t == 0) {
    for (int st = 0; st < WG_STAGES; ++st) mbar_init(&s.full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int it) {  // row tile tb + it into stage it % WG_STAGES
    const int st = it % WG_STAGES;
    mbar_expect_tx(&s.full[st], a_bytes + b_bytes);
    bulk_copy(s.stage[st], a_src + static_cast<size_t>(tb + it) * a_stride, a_bytes, &s.full[st]);
    bulk_copy(s.stage[st] + a_bytes, b_src + static_cast<size_t>(tb + it) * b_stride, b_bytes, &s.full[st]);
  };
  if (t == 0)
    for (int it = 0; it < WG_STAGES && it < n; ++it) issue(it);
  // while they land: the split's share of the bias gradients (the tiles'
  // f32 column sums) and of the actor's log_std gradient, in tile order
  float* gp = p.gpart + static_cast<size_t>(split) * p.P;
  const int leaf0 = tr ? VF_W0 : PI_W0;
  const float* cs = p.colsum + static_cast<size_t>(tr) * tiles * COLS;
  if (kind <= 1) {  // the W0 job: b0 from dz1; the first W1 job: b1 from dz2
    for (int c = t; c < HID; c += WG_THREADS) {
      float sum = 0.f;
#pragma unroll 4
      for (int tt = tb; tt < tb + n; ++tt) sum += cs[static_cast<size_t>(tt) * COLS + kind * HID + c];
      gp[p.off[leaf0 + (kind == 0 ? K_B0 : K_B1)] + c] = sum;
    }
  } else if (head) {
    const int outs = tr ? 1 : p.act_dim;
    if (t < outs) {
      float sum = 0.f;
#pragma unroll 4
      for (int tt = tb; tt < tb + n; ++tt) sum += cs[static_cast<size_t>(tt) * COLS + 2 * HID + t];
      gp[p.off[leaf0 + K_HB] + t] = sum;
    } else if (!tr && t >= HEAD_N && t < HEAD_N + p.act_dim) {
      float sum = 0.f;
#pragma unroll 4
      for (int tt = tb; tt < tb + n; ++tt) sum += p.tile_part[static_cast<size_t>(tt) * NPART + 3 + t - HEAD_N];
      gp[p.off[LOG_STD] + t - HEAD_N] = sum;
    }
  }
  float acc[128];
  float hacc[4][4];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) hacc[mt][i] = 0.f;
  for (int it = 0; it < n; ++it) {
    const int st = it % WG_STAGES;
    mbar_wait(&s.full[st], (it / WG_STAGES) & 1);
    const uint8_t* A = s.stage[st];
    const uint8_t* B = A + a_bytes;
    wg_fence();
    if (!head) {
#pragma unroll
      for (int ks = 0; ks < TILE_M / 16; ++ks)
        wgmma_m64n256k16_ss<1, 1>(acc, mn_desc(A + 16 * 128 * ks, WS_LBO, WS_SBO), mn_desc(B + 16 * 128 * ks, WS_LBO, WS_SBO));
    } else {
#pragma unroll
      for (int ks = 0; ks < TILE_M / 16; ++ks)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          wgmma_m64n8k16_ss<1, 0>(hacc[mt], mn_desc(A + mt * BLOCK_BYTES + 16 * 128 * ks, WS_LBO, WS_SBO),
                                  sw128_desc(B + 32 * ks));
    }
    wg_commit();
    wg_wait0();
    fence_regs(acc);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) fence_regs(hacc[mt]);
    __syncthreads();  // every warp's wgmma has read the stage
    if (t == 0 && it + WG_STAGES < n) issue(it + WG_STAGES);
  }
  if (!head) {
    const int i0 = kind == 0 ? 0 : KC * (kind - 1);
    const int in_real = kind == 0 ? p.obs_dim : HID;
    float* gw = gp + p.off[leaf0 + (kind == 0 ? K_W0 : K_W1)];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int in = i0 + r0 + 8 * hh;
      if (in < in_real) {
        float* row = gw + static_cast<size_t>(in) * HID;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          *reinterpret_cast<float2*>(row + 8 * i + 2 * q) = make_float2(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
      }
    }
  } else {
    const int outs = tr ? 1 : p.act_dim;
    float* gw = gp + p.off[leaf0 + K_HW];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (2 * q + e < outs) gw[(KC * mt + r0 + 8 * hh) * outs + 2 * q + e] = hacc[mt][2 * hh + e];
  }
}

// ---------------------------------------------------------------------------
// C: gradient, clip, Adam and the next images
// ---------------------------------------------------------------------------

// Deterministic sum over a block of one value per thread.
__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) t += red[w];
  return t;
}

// Gradient: the slab sums (log_std's less the entropy term, masked outside
// the clamp band); per-block sums of squares; block 0 writes minibatch m's
// metrics row from the pre-update log_std.
__global__ void __launch_bounds__(THREADS) reduce_kernel(const EpochArgs p, int m) {
  __shared__ float red[THREADS / 32];
  pdl_wait();
  pdl_launch_next();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int tiles = n_tiles(p);
  const int used = (tiles + tiles_per_split(p) - 1) / tiles_per_split(p);
  const int ls0 = p.off[LOG_STD];
  float g = 0.f;
  if (i < p.P) {
    const int l = leaf_of(p, i);
    if (l >= 0) {
#pragma unroll 4
      for (int sl = 0; sl < used; ++sl) g += p.gpart[static_cast<size_t>(sl) * p.P + i];
    }
    if (l == LOG_STD) {
      g -= p.ent_coef;
      const float raw = p.params[i];
      if (p.has_range && !(raw > p.ls_lo && raw < p.ls_hi)) g = 0.f;
    }
    p.grad[i] = g;
  }
  const float sq = block_sum(g * g, red);
  if (threadIdx.x == 0) p.block_sq[blockIdx.x] = sq;
  if (blockIdx.x == 0 && threadIdx.x < 32) {  // the metrics: warp 0 sums the tiles' partials
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int tt = threadIdx.x; tt < tiles; tt += 32) {
      s0 += p.tile_part[static_cast<size_t>(tt) * NPART + 0];
      s1 += p.tile_part[static_cast<size_t>(tt) * NPART + 1];
      s2 += p.tile_part[static_cast<size_t>(tt) * NPART + 2];
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (threadIdx.x == 0) {
      const float inv_mb = 1.f / static_cast<float>(p.mb);
      const float pg_loss = -s0 * inv_mb;
      const float v_loss = 0.5f * s1 * inv_mb;
      const float kl = s2 * inv_mb;
      float ent = 0.f;
      for (int jj = 0; jj < p.act_dim; ++jj) {
        float ls = p.params[ls0 + jj];
        if (p.has_range) ls = fminf(fmaxf(ls, p.ls_lo), p.ls_hi);
        ent += ls + ENT_C;
      }
      float* row = p.metrics + static_cast<size_t>(m) * 5;
      row[0] = pg_loss + p.vf_coef * v_loss - p.ent_coef * ent;
      row[1] = pg_loss;
      row[2] = v_loss;
      row[3] = ent;
      row[4] = kl;
    }
  }
}

// Global-norm clip and Adam, in place, and the updated weights into the
// images. Every block sums the block sums of squares in the same order, so
// every block sees the same norm.
__global__ void __launch_bounds__(THREADS) adam_kernel(const EpochArgs p, int m) {
  __shared__ float coef[3];  // scale, c1, c2
  pdl_wait();
  pdl_launch_next();
  const int nb = (p.P + THREADS - 1) / THREADS;
  if (threadIdx.x < 32) {
    float sq = 0.f;
#pragma unroll 8
    for (int b = threadIdx.x; b < nb; b += 32) sq += p.block_sq[b];
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if (threadIdx.x == 0) {
      const float gnorm = sqrtf(sq);
      coef[0] = gnorm < p.max_grad_norm ? 1.f : p.max_grad_norm / gnorm;
      const float t = static_cast<float>(*p.t0 + m + 1);
      coef[1] = 1.f - expf(t * LN_B1);
      coef[2] = 1.f - expf(t * LN_B2);
    }
  }
  __syncthreads();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= p.P) return;
  const float g = p.grad[i] * coef[0];
  const float m_new = B1 * p.mu[i] + (1.f - B1) * g;
  const float v_new = B2 * p.nu[i] + (1.f - B2) * (g * g);
  p.mu[i] = m_new;
  p.nu[i] = v_new;
  const float upd = (m_new / coef[1]) / (sqrtf(v_new / coef[2]) + ADAM_EPS);
  const float w = p.params[i] - p.lr * upd;
  p.params[i] = w;
  write_image(p, i, w);  // probe: image_write
}

// The images of the parameters as given: the first minibatch's weights.
__global__ void __launch_bounds__(THREADS) image_kernel(const EpochArgs p) {
  pdl_launch_next();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < p.P) write_image(p, i, p.params[i]);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// `kernel` on `st` after the stream's previous kernel, as a programmatic
// dependent launch (pdl_wait); then the launch's error
template <typename... Args>
cudaError_t launch(void (*kernel)(Args...), dim3 grid, int threads, int smem, cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;  // probe: pdl
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// One epoch: one image kernel, then 4 kernels per minibatch, queued in
// order on `stream`. Shapes are checked by the Python wrapper: obs_dim <=
// 64, two 256-wide tanh layers per trunk, act_dim <= 8, the workspace as
// ops/cuda_sgd.py sizes it. Returns the first CUDA error of a launch (0 =
// every kernel launched).
extern "C" int fused_epoch(const EpochArgs* args, void* stream) {
  const EpochArgs& p = *args;
  if (p.n_mb <= 0 || p.mb <= 0 || p.obs_dim <= 0 || p.obs_dim > pmlp::MAX_OBS || p.act_dim <= 0 ||
      p.act_dim > MAX_ACT || p.obs_dim + p.act_dim + 3 > p.feat || p.P <= 0 || p.splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < N_LEAVES; ++l) {
    const int end = p.off[l] + leaf_size(l, p.obs_dim, p.act_dim);
    if (p.off[l] % 4 != 0 || p.off[l] < 0 || end > p.P || (l + 1 < N_LEAVES && end > p.off[l + 1]))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  static int attr_device = -1, sms = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device != attr_device) {
    if ((e = allow_smem(fwd_bwd_kernel, SMEM_F)) != cudaSuccess) return static_cast<int>(e);
    if ((e = allow_smem(wgrad_kernel, SMEM_W)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
      return static_cast<int>(e);
    attr_device = device;
  }
  const int tiles = (p.mb + TILE_M - 1) / TILE_M;
  const int per_trunk = std::min(tiles, std::max(1, sms / 2));
  if (2 * per_trunk * pmlp::CONSUMERS > p.spill_slots) return static_cast<int>(cudaErrorInvalidValue);
  const int per = (tiles + p.splits - 1) / p.splits;
  const int used = (tiles + per - 1) / per;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (p.P + THREADS - 1) / THREADS;
  image_kernel<<<nb, THREADS, 0, st>>>(p);  // after whatever the stream ran before, in full
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  for (int m = 0; m < p.n_mb; ++m) {
    if ((e = launch(fwd_bwd_kernel, dim3(per_trunk, 2), pmlp::THREADS, SMEM_F, st, p, m)) != cudaSuccess ||
        (e = launch(wgrad_kernel, dim3(used, 2 * JOBS), WG_THREADS, SMEM_W, st, p)) != cudaSuccess ||
        (e = launch(reduce_kernel, dim3(nb), THREADS, 0, st, p, m)) != cudaSuccess ||
        (e = launch(adam_kernel, dim3(nb), THREADS, 0, st, p, m)) != cudaSuccess)
      return static_cast<int>(e);
  }
  return 0;
}
