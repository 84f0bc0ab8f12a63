// A whole PPO epoch of minibatch SGD for narrow, deep tanh actor-critics
// (K2n): 1 to 4 layers a trunk, each at most 128 wide, obs <= 64, act <= 8,
// actor and critic trunks that may differ. For each minibatch in turn: the
// forward of both trunks, the clipped-surrogate and value losses, a
// backward derived by hand, the global-norm clip, Adam over every
// parameter, and one metrics row. The 2 x 256 trunks keep fused_epoch.cu.
//
// Replaces pyflyt_tpu/ops/pallas_sgd.py::build_fused_epoch at those
// trunks, with its arithmetic (pallas_sgd.py:21-26, :64-92, :357-512):
// every matmul takes bf16 inputs (round to nearest even) and accumulates in
// f32; everything elementwise (the tanh, the 1 - h^2 factors from the f32
// activations), the bias sums of dz, the reductions, the clip and Adam are
// f32. It keeps the Pallas kernel's corner cases: advantages normalised by
// the given per-minibatch mean/std, the 50/50 cotangent split where the
// two surrogate terms tie, a log_std gradient masked by the strict
// inequality of the clamp band, metrics from the pre-update log_std.
//
// What bounds it on an H100: at the trajectory network (obs 16, act 4,
// 64-64-32-32 trunks) a row is about 100 kFLOP of bf16 MMA (forward, the
// data gradient of every layer but the first, the weight gradient of every
// layer): an epoch of 64 minibatches of 4096 rows is 26 GFLOP (27 us at
// 989 TFLOP/s) against 19 MB of rows (6 us at 3.35 TB/s). The 64 updates
// run in order, each ending in a clip over every parameter, so the chain of
// kernels and their launches sets the time, not the arithmetic.
//
// Design: three kernels a minibatch, queued in order on one stream by one
// host call, plus one a call that writes the first weight images:
//  A. fwd_bwd_kernel: grid (row tiles, 2 trunks), 4 warps of 16 rows a
//     64-row tile, the trunk's image (policy_narrow.cuh) resident in shared
//     memory. A warp runs its rows' forward with the activations in
//     registers (their f32 values spilled to device memory for the tanh
//     derivatives, read back by the thread that wrote them), the per-row
//     loss and its derivative, then the backward layer by layer: the block
//     stages bf16 dz and the layer's bf16 input in shared memory and forms
//     the tile's weight gradient A^T dZ with ldmatrix.trans + mma, its bias
//     gradient as f32 column sums (a shuffle butterfly, then the warps in
//     order), and each warp the data gradient dZ W^T from the image read
//     transposed. Each tile's gradient lands in its own slab row.
//  B. reduce_kernel: the gradient as the slab rows' sum in tile order, the
//     log_std term, per-block sums of squares, the metrics row: every sum in
//     a fixed order and no atomics, so the epoch is bit-reproducible.
//  C. adam_kernel: every block sums the block sums of squares in the same
//     order (the global norm), clips, runs Adam (bias correction
//     1 - exp(t ln b), t = t0 + m + 1) in place, and writes each updated
//     weight into its trunk's image (bf16 Wt, biases f32), which the next
//     minibatch's blocks copy as is.
// Parameters, moments and gradients are flat f32 vectors of the leaves in
// ops/cuda_sgd.py::leaf_specs order, each at a multiple of 4 floats; the
// flat index -> image slot rule is written once more in
// ops/cuda_narrow.py::image_slots.
#include "policy_narrow.cuh"

using narrow::LAYERS;
using narrow::MAX_ACT;
using narrow::MAX_KC;
using narrow::MAX_NT;
using narrow::MAX_OBS;
using narrow::MAX_WIDTH;
using narrow::TILE_ROWS;
using narrow::WARPS;

// Must match pyflyt_tpu_torch/ops/cuda_narrow.py::_EpochArgsC.
struct NarrowEpochArgs {
  const float* mbs;        // (n_mb, mb, feat) f32: [obs | action | old_logp | adv | ret]
  const float* adv_stats;  // (n_mb, 2) f32: advantage mean, population std
  const int* t0;           // (1,) int32: Adam's count before the epoch
  float* params;           // (P,) f32, updated in place
  float* mu;               // (P,) f32, first moment, in place
  float* nu;               // (P,) f32, second moment, in place
  float* metrics;          // (n_mb, 5) f32: loss, pg_loss, v_loss, entropy, approx_kl
  uint8_t* image;          // (2, img_stride): the actor's and the critic's images, zero padding
  float* spill;            // (2, tiles, WARPS, spill_nt, 32, 4) f32: the tanh layers' activations
  float* slab;             // (tiles, P) f32: each tile's gradient (zero where no leaf)
  float* tile_part;        // (tiles, 4) f32: sum pg_min, sum verr^2, sum (old - logp), unused
  float* grad;             // (P,) f32
  float* block_sq;         // (ceil(P / 256),) f32
  NarrowTrunk pi;
  NarrowTrunk vf;
  int w_leaf[2][LAYERS];   // flat offset of each layer's weight (the head's at depth), per trunk
  int b_leaf[2][LAYERS];   // and of its bias
  int ls_off;              // log_std's flat offset
  int img_stride;          // bytes from the actor's image to the critic's
  int spill_nt;            // n8 tiles a warp spills: the larger trunk's over its tanh layers
  int P;
  int n_mb;
  int mb;
  int feat;
  int obs_dim;
  int act_dim;
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

constexpr int STAGE_BYTES = TILE_ROWS * (MAX_WIDTH + 8) * 2;  // a tile's bf16 rows of one layer
constexpr int COL_FLOATS = WARPS * MAX_WIDTH;                  // the warps' column sums of dz
constexpr int PART_FLOATS = WARPS * 16;                        // the warps' loss partials
constexpr int SMEM_FIXED = 2 * STAGE_BYTES + 4 * (COL_FLOATS + PART_FLOATS);
constexpr int NPART = 4;  // tile_part's row
constexpr int THREADS = 256;  // reduce, Adam, image
static_assert(SMEM_FIXED % 16 == 0, "the image's copy needs 16-byte alignment");

constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float ADAM_EPS = 1e-5f;
constexpr float LN_B1 = -0.10536051565782628f;    // log(0.9)
constexpr float LN_B2 = -0.0010005003335835335f;  // log(0.999)
constexpr float ENT_C = 1.4189385332046727f;      // 0.5 log(2 pi e)

__device__ __forceinline__ int n_tiles(const NarrowEpochArgs& p) { return (p.mb + TILE_ROWS - 1) / TILE_ROWS; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over a column's 8 lane groups (lanes of one t): the rows g
__device__ __forceinline__ float rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

__device__ __forceinline__ float clip_ls(const NarrowEpochArgs& p, float ls) {
  return p.has_range ? fminf(fmaxf(ls, p.ls_lo), p.ls_hi) : ls;
}

// The tile's weight gradient (kp x np) = act_s^T (kp x 64 rows) dz_s (64
// rows x np), both staged bf16 row by row; warps take m16 tiles w, w + 4,
// ...; the real entries (k < kr, n < nr) to out[k nr + n]
__device__ __forceinline__ void weight_grad(float (&acc)[MAX_NT][4], const uint8_t* act_s, const uint8_t* dz_s, int kp, int np,
                            int kr, int nr, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane >> 3, j = lane & 7;
  const int g = lane >> 2, t = lane & 3;
  const int sa = 2 * (kp + 8), sd = 2 * (np + 8);
  const uint32_t A = narrow::smem_addr(act_s), D = narrow::smem_addr(dz_s);
  for (int mt = warp; mt * 16 < kp; mt += WARPS) {
#pragma unroll
    for (int n2 = 0; n2 < MAX_NT / 2; ++n2)
      if (n2 * 16 < np)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[2 * n2][c] = acc[2 * n2 + 1][c] = 0.f;
#pragma unroll
    for (int kc = 0; kc < TILE_ROWS / 16; ++kc) {
      uint32_t af[4];
      narrow::ldsm4_t(af, A + (kc * 16 + (q >> 1) * 8 + j) * sa + (mt * 16 + (q & 1) * 8) * 2);
#pragma unroll
      for (int n2 = 0; n2 < MAX_NT / 2; ++n2) {
        if (n2 * 16 < np) {
          uint32_t b[4];
          narrow::ldsm4_t(b, D + (kc * 16 + (q & 1) * 8 + j) * sd + (n2 * 16 + (q >> 1) * 8) * 2);
          narrow::mma(acc[2 * n2], af, b[0], b[1]);
          narrow::mma(acc[2 * n2 + 1], af, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) {
      if (nt * 8 < np) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int k = mt * 16 + g + 8 * hh;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = nt * 8 + 2 * t + e;
            if (k < kr && n < nr) out[k * nr + n] = acc[nt][2 * hh + e];
          }
        }
      }
    }
  }
}

// a warp's 16 rows (r0 = 16 warp + g, r0 + 8) of bf16 pairs at column 8 nt + 2t
__device__ __forceinline__ void stage_pair(uint8_t* s, int stride, int row, int col, uint32_t v) {
  *reinterpret_cast<uint32_t*>(s + row * stride + col * 2) = v;
}

__global__ void __launch_bounds__(narrow::THREADS) fwd_bwd_kernel(const __grid_constant__ NarrowEpochArgs p, int m) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* act_s = smem;
  uint8_t* dz_s = smem + STAGE_BYTES;
  float* col_s = reinterpret_cast<float*>(smem + 2 * STAGE_BYTES);
  float* part_s = col_s + COL_FLOATS;
  uint8_t* img = smem + SMEM_FIXED;
  const int trunk = blockIdx.y, tile = blockIdx.x;
  const bool critic = trunk != 0;
  const NarrowTrunk& T = critic ? p.vf : p.pi;
  narrow::load_image(img, p.image + static_cast<size_t>(trunk) * p.img_stride, T.bytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = tile * TILE_ROWS + 16 * warp;
  const float* rows = p.mbs + static_cast<size_t>(m) * p.mb * p.feat;
  float4* spill = reinterpret_cast<float4*>(p.spill) +
                  ((static_cast<size_t>(trunk) * n_tiles(p) + tile) * WARPS + warp) * p.spill_nt * 32;
  float* slab = p.slab + static_cast<size_t>(tile) * p.P;
  __syncthreads();

  // forward
  uint32_t a[MAX_KC][4];
  float acc[MAX_NT][4];
  narrow::load_rows(a, rows, p.feat, p.obs_dim, row0, p.mb, T.k[0]);
  narrow::trunk_forward(acc, a, img, T, spill);

  // the loss and its derivative: dhead into acc[0] (acc[1], head columns
  // 8-15, zero); the warp's partial sums into part_s
  const float inv_mb = 1.f / static_cast<float>(p.mb);
  const float adv_mean = p.adv_stats[2 * m], adv_std = p.adv_stats[2 * m + 1];
  const int c0 = p.obs_dim + p.act_dim;
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[1][c] = 0.f;
  if (!critic) {
    const float lo = 1.f - p.clip_eps, hi = 1.f + p.clip_eps;
    float ls[2], var[2], gls[2] = {0.f, 0.f}, s_pg = 0.f, s_kl = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int jj = 2 * t + e;
      ls[e] = jj < p.act_dim ? clip_ls(p, p.params[p.ls_off + jj]) : 0.f;
      var[e] = expf(2.f * ls[e]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + g + 8 * hh;
      const bool valid = row < p.mb;
      const float* rp = rows + static_cast<size_t>(valid ? row : 0) * p.feat;
      float diff[2] = {0.f, 0.f}, logp = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = 2 * t + e;
        if (valid && jj < p.act_dim) {
          diff[e] = rp[p.obs_dim + jj] - acc[0][2 * hh + e];
          logp += -0.5f * (diff[e] * diff[e] / var[e] + 2.f * ls[e] + narrow::LOG2PI);
        }
      }
      logp += __shfl_xor_sync(0xffffffffu, logp, 1);
      logp += __shfl_xor_sync(0xffffffffu, logp, 2);
      float dmean[2] = {0.f, 0.f};
      if (valid) {
        const float old = rp[c0], adv = rp[c0 + 1];
        const float ratio = expf(logp - old);
        const float adv_n = (adv - adv_mean) / (adv_std + 1e-8f);
        const float clipped = fminf(fmaxf(ratio, lo), hi);
        const float pg1 = ratio * adv_n, pg2 = clipped * adv_n;
        const float inband = (ratio >= lo && ratio <= hi) ? 1.f : 0.f;
        const float d1 = adv_n, d2 = adv_n * inband;
        const float dmin = pg1 == pg2 ? 0.5f * (d1 + d2) : (pg1 < pg2 ? d1 : d2);
        const float g_logp = (-inv_mb) * dmin * ratio;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (2 * t + e < p.act_dim) {
            dmean[e] = g_logp * (diff[e] / var[e]);
            gls[e] += g_logp * (diff[e] * diff[e] / var[e] - 1.f);
          }
        }
        if (t == 0) {
          s_pg += fminf(pg1, pg2);
          s_kl += old - logp;
        }
      }
      acc[0][2 * hh] = dmean[0];
      acc[0][2 * hh + 1] = dmean[1];
    }
    s_pg = warp_sum(s_pg);
    s_kl = warp_sum(s_kl);
    gls[0] = rows_sum(gls[0]);
    gls[1] = rows_sum(gls[1]);
    if (lane == 0) {
      part_s[warp * 16 + 0] = s_pg;
      part_s[warp * 16 + 2] = s_kl;
    }
    if (g == 0) {
      part_s[warp * 16 + 4 + 2 * t] = gls[0];
      part_s[warp * 16 + 5 + 2 * t] = gls[1];
    }
  } else {
    const float dv_coef = p.vf_coef * inv_mb;
    float s_v = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + g + 8 * hh;
      float dv = 0.f;
      if (t == 0 && row < p.mb) {
        const float verr = acc[0][2 * hh] - rows[static_cast<size_t>(row) * p.feat + c0 + 2];
        dv = dv_coef * verr;
        s_v += verr * verr;
      }
      acc[0][2 * hh] = dv;
      acc[0][2 * hh + 1] = 0.f;
    }
    s_v = warp_sum(s_v);
    if (lane == 0) part_s[warp * 16 + 1] = s_v;
  }

  // the backward, layer by layer from the head
  int nt_base[LAYERS];
  nt_base[0] = 0;
  for (int l = 1; l <= T.depth; ++l) nt_base[l] = nt_base[l - 1] + T.n[l - 1] / 8;
  const int sr0 = 16 * warp + g;  // this lane's staging rows: sr0 and sr0 + 8
  for (int l = T.depth; l >= 0; --l) {
    const int kp = T.k[l], np = T.n[l];
    if (l < T.depth) {  // dz = da (1 - a^2), a the layer's f32 activations
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt) {
        if (nt * 8 < np) {
          const float4 s = spill[(nt_base[l] + nt) * 32 + lane];
          acc[nt][0] *= 1.f - s.x * s.x;
          acc[nt][1] *= 1.f - s.y * s.y;
          acc[nt][2] *= 1.f - s.z * s.z;
          acc[nt][3] *= 1.f - s.w * s.w;
        }
      }
    }
    // dz (bf16) and its f32 column sums; the layer's input (bf16)
    const int sd = 2 * (np + 8), sa = 2 * (kp + 8);
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) {
      if (nt * 8 < np) {
        stage_pair(dz_s, sd, sr0, nt * 8 + 2 * t, narrow::pack_bf16(acc[nt][0], acc[nt][1]));
        stage_pair(dz_s, sd, sr0 + 8, nt * 8 + 2 * t, narrow::pack_bf16(acc[nt][2], acc[nt][3]));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = rows_sum(acc[nt][e] + acc[nt][2 + e]);
          if (g == 0) col_s[warp * MAX_WIDTH + nt * 8 + 2 * t + e] = v;
        }
      }
    }
    if (l == 0) {
      narrow::load_rows(a, rows, p.feat, p.obs_dim, row0, p.mb, kp);
#pragma unroll
      for (int kc = 0; kc < MAX_KC; ++kc) {
        if (kc * 16 < kp) {
          stage_pair(act_s, sa, sr0, kc * 16 + 2 * t, a[kc][0]);
          stage_pair(act_s, sa, sr0 + 8, kc * 16 + 2 * t, a[kc][1]);
          stage_pair(act_s, sa, sr0, kc * 16 + 8 + 2 * t, a[kc][2]);
          stage_pair(act_s, sa, sr0 + 8, kc * 16 + 8 + 2 * t, a[kc][3]);
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt) {
        if (nt * 8 < kp) {
          const float4 s = spill[(nt_base[l - 1] + nt) * 32 + lane];
          stage_pair(act_s, sa, sr0, nt * 8 + 2 * t, narrow::pack_bf16(s.x, s.y));
          stage_pair(act_s, sa, sr0 + 8, nt * 8 + 2 * t, narrow::pack_bf16(s.z, s.w));
        }
      }
    }
    uint32_t dzf[MAX_KC][4];
    narrow::to_fragments(dzf, acc, np);
    __syncthreads();
    weight_grad(acc, act_s, dz_s, kp, np, T.kr[l], T.nr[l], slab + p.w_leaf[trunk][l]);
    for (int c = threadIdx.x; c < T.nr[l]; c += blockDim.x)
      slab[p.b_leaf[trunk][l] + c] =
          ((col_s[c] + col_s[MAX_WIDTH + c]) + col_s[2 * MAX_WIDTH + c]) + col_s[3 * MAX_WIDTH + c];
    if (l > 0) narrow::layer_product_t(acc, dzf, img + T.w_off[l], kp, np);
    __syncthreads();
  }

  // the tile's partial sums, the warps in order
  if (threadIdx.x < 16) {
    const int i = threadIdx.x;
    const float s = ((part_s[i] + part_s[16 + i]) + part_s[32 + i]) + part_s[48 + i];
    if (!critic) {
      if (i == 0 || i == 2) p.tile_part[static_cast<size_t>(tile) * NPART + i] = s;
      if (i >= 4 && i - 4 < p.act_dim) slab[p.ls_off + i - 4] = s;
    } else if (i == 1) {
      p.tile_part[static_cast<size_t>(tile) * NPART + 1] = s;
    }
  }
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

// Gradient: the slab rows' sums in tile order (log_std's less the entropy
// term, masked outside the clamp band); per-block sums of squares; block 0
// writes minibatch m's metrics row from the pre-update log_std.
__global__ void __launch_bounds__(THREADS) reduce_kernel(const __grid_constant__ NarrowEpochArgs p, int m) {
  __shared__ float red[THREADS / 32];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int tiles = n_tiles(p);
  float g = 0.f;
  if (i < p.P) {
#pragma unroll 4
    for (int tt = 0; tt < tiles; ++tt) g += p.slab[static_cast<size_t>(tt) * p.P + i];
    if (i >= p.ls_off && i < p.ls_off + p.act_dim) {
      g -= p.ent_coef;
      const float raw = p.params[i];
      if (p.has_range && !(raw > p.ls_lo && raw < p.ls_hi)) g = 0.f;
    }
    p.grad[i] = g;
  }
  const float sq = block_sum(g * g, red);
  if (threadIdx.x == 0) p.block_sq[blockIdx.x] = sq;
  if (blockIdx.x == 0 && threadIdx.x < 32) {
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
      for (int jj = 0; jj < p.act_dim; ++jj) ent += clip_ls(p, p.params[p.ls_off + jj]) + ENT_C;
      float* row = p.metrics + static_cast<size_t>(m) * 5;
      row[0] = pg_loss + p.vf_coef * v_loss - p.ent_coef * ent;
      row[1] = pg_loss;
      row[2] = v_loss;
      row[3] = ent;
      row[4] = kl;
    }
  }
}

// flat index i's slot in the images: bf16 Wt (n, k) of a layer or f32 bias
__device__ __forceinline__ void write_image(const NarrowEpochArgs& p, int i, float w) {
#pragma unroll
  for (int tr = 0; tr < 2; ++tr) {
    const NarrowTrunk& T = tr ? p.vf : p.pi;
    uint8_t* img = p.image + static_cast<size_t>(tr) * p.img_stride;
    for (int l = 0; l <= T.depth; ++l) {
      const int wl = p.w_leaf[tr][l], bl = p.b_leaf[tr][l];
      if (i >= wl && i < wl + T.kr[l] * T.nr[l]) {
        const int k = (i - wl) / T.nr[l], n = (i - wl) % T.nr[l];
        *reinterpret_cast<__nv_bfloat16*>(img + T.w_off[l] + (n * (T.k[l] + 8) + k) * 2) = __float2bfloat16_rn(w);
        return;
      }
      if (i >= bl && i < bl + T.nr[l]) {
        reinterpret_cast<float*>(img + T.b_off[l])[i - bl] = w;
        return;
      }
    }
  }
}

// Global-norm clip and Adam, in place, and the updated weights into the
// images. Every block sums the block sums of squares in the same order, so
// every block sees the same norm.
__global__ void __launch_bounds__(THREADS) adam_kernel(const __grid_constant__ NarrowEpochArgs p, int m) {
  __shared__ float coef[3];  // scale, c1, c2
  const int nb = (p.P + THREADS - 1) / THREADS;
  if (threadIdx.x < 32) {
    float sq = 0.f;
    for (int b = threadIdx.x; b < nb; b += 32) sq += p.block_sq[b];
    sq = warp_sum(sq);
    if (threadIdx.x == 0) {
      const float gnorm = sqrtf(sq);
      coef[0] = gnorm < p.max_grad_norm ? 1.f : p.max_grad_norm / gnorm;
      const float tt = static_cast<float>(*p.t0 + m + 1);
      coef[1] = 1.f - expf(tt * LN_B1);
      coef[2] = 1.f - expf(tt * LN_B2);
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
  write_image(p, i, w);
}

// The images of the parameters as given: the first minibatch's weights.
__global__ void __launch_bounds__(THREADS) image_kernel(const __grid_constant__ NarrowEpochArgs p) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < p.P) write_image(p, i, p.params[i]);
}

}  // namespace

// One epoch: one image kernel, then 3 kernels a minibatch, queued in order
// on `stream`. Shapes are checked by the Python wrapper and again here.
// Returns the first CUDA error of a launch (0 = every kernel launched).
extern "C" int fused_epoch_narrow(const NarrowEpochArgs* args, void* stream) {
  const NarrowEpochArgs& p = *args;
  if (p.n_mb <= 0 || p.mb <= 0 || p.obs_dim <= 0 || p.obs_dim > MAX_OBS || p.act_dim <= 0 ||
      p.act_dim > MAX_ACT || p.obs_dim + p.act_dim + 3 > p.feat || p.P <= 0 ||
      !narrow::trunk_ok(p.pi, p.obs_dim, p.act_dim) || !narrow::trunk_ok(p.vf, p.obs_dim, 1) ||
      p.img_stride < p.pi.bytes || p.img_stride < p.vf.bytes || p.img_stride % 16 != 0 || p.ls_off < 0 || p.ls_off + p.act_dim > p.P)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int tr = 0; tr < 2; ++tr) {
    const NarrowTrunk& T = tr ? p.vf : p.pi;
    int spilled = 0;
    for (int l = 0; l < T.depth; ++l) spilled += T.n[l] / 8;
    if (spilled > p.spill_nt) return static_cast<int>(cudaErrorInvalidValue);
    for (int l = 0; l <= T.depth; ++l)
      if (p.w_leaf[tr][l] < 0 || p.w_leaf[tr][l] + T.kr[l] * T.nr[l] > p.P || p.b_leaf[tr][l] < 0 ||
          p.b_leaf[tr][l] + T.nr[l] > p.P)
        return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = SMEM_FIXED + (p.pi.bytes > p.vf.bytes ? p.pi.bytes : p.vf.bytes);
  cudaError_t e = cudaFuncSetAttribute(fwd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (p.mb + TILE_ROWS - 1) / TILE_ROWS;
  const int nb = (p.P + THREADS - 1) / THREADS;
  image_kernel<<<nb, THREADS, 0, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  for (int m = 0; m < p.n_mb; ++m) {
    fwd_bwd_kernel<<<dim3(tiles, 2), narrow::THREADS, smem, st>>>(p, m);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    reduce_kernel<<<nb, THREADS, 0, st>>>(p, m);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    adam_kernel<<<nb, THREADS, 0, st>>>(p, m);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
