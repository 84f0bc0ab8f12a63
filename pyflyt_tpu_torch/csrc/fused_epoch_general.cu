// A whole PPO epoch of minibatch SGD for the general policy family (K2g):
// any number of tanh layers a trunk (none included), any widths, any obs
// and action widths, actor and critic trunks that may differ. For each
// minibatch in turn: the forward of both trunks, the clipped-surrogate and
// value losses, a backward derived by hand, the global-norm clip, Adam over
// every parameter, and one metrics row. The 2 x 256 trunks keep
// fused_epoch.cu and the narrow ones fused_epoch_narrow.cu.
//
// Replaces pyflyt_tpu/ops/pallas_sgd.py::build_fused_epoch at those
// trunks, with its arithmetic (pallas_sgd.py:21-26, :64-92, :357-512):
// every matmul takes bf16 inputs (round to nearest even) and accumulates in
// f32; everything elementwise (the tanh, the 1 - h^2 factors from the f32
// activations), the bias sums of dz, the reductions, the clip and Adam are
// f32. It keeps the Pallas kernel's corner cases: advantages normalised by
// the given per-minibatch mean/std, the 50/50 cotangent split where the
// two surrogate terms tie, a log_std gradient masked by the strict
// inequality of the clamp band, metrics from the pre-update log_std; Adam
// with eps 1e-5, eps_root 0 and bias correction 1 - exp(t ln b).
//
// What bounds it on an H100: at the hover recipe's minibatch (8192 rows,
// obs 21, act 4, two 3 x 256 trunks) a minibatch is about 13.3 GFLOP of
// bf16 MMA (the forward, the data gradient of every layer but the first,
// the weight gradient of every layer: 13.4 us at 989 TFLOP/s) against
// about 8 MB of rows, parameters and moments (2.4 us at 3.35 TB/s), so
// operations bound it; the minibatches run in order, each ending in a clip
// over every parameter.
//
// Two routes, chosen by the wrapper from the widths
// (ops/cuda_general.py::epoch_route): the resident one (namespace rep,
// below) for every trunk pair whose widest width fits a block, four kernels
// a minibatch; and the per-layer one past it, where each layer of each pass
// is a launch of policy_general.cuh's GEMM (TMA-fed bf16 stages, wgmma).
//
// The per-layer route: two kernels a call (round_rows: the obs of every
// minibatch into one bf16 copy; image_kernel: the weights into the bf16
// image, each layer's W (in x out) as the parameters hold it, pad32(out)
// wide), then per minibatch 3 (depth_pi + depth_vf) + 7 kernels queued by
// one host call, every operand map made once a call, the critic's GEMMs on
// a second stream beside the actor's (each fills the SMs the other's tail
// leaves idle; the loss and the reduce wait for both):
//  - the forward: one GEMM a layer a trunk, each tanh layer's outputs kept
//    f32 (the backward's 1 - a^2) and bf16 (the next GEMM's A and the
//    weight gradient's), the heads f32;
//  - loss_kernel: a block a 128-row tile, a thread a row: the log-prob
//    (general::row_logp, K3g's), the losses, the heads' dz (bf16, zero past
//    their outputs) and, per tile, the partial sums, the log_std gradient
//    and the heads' dz column sums (f32);
//  - the backward of each trunk from its head: the weight gradient of a
//    layer (A^T dZ, the minibatch's rows split into `splits` chunks, one
//    partial a chunk into its slab row), then the data gradient (dZ W^T
//    from the same image, times 1 - a^2 of the layer below, bf16 into the
//    other of the trunk's two dz buffers, its f32 column sums, the bias
//    gradient, per 128-row tile);
//  - reduce_kernel: the gradient as the slab rows' sum in chunk order (a
//    weight), the tiles' column sums in tile order (a bias), the tiles'
//    log_std terms; per-block sums of squares and the metrics row: every
//    sum in a fixed order and no atomics, so the epoch is bit-reproducible;
//  - adam_kernel: every block sums the block sums of squares in the same
//    order (the global norm), clips, runs Adam in place and writes each
//    updated weight's bf16 into the image (in the parameters' order, so
//    side by side), which the next minibatch's GEMMs read.
// What sets its time at the hovering CLI's 2 x 1024 (PERF.md §5): the
// GEMMs' epilogues (a tanh layer's f32 and bf16 stores, a data gradient's
// f32 activation loads), which run after their main loops, not beside
// them; then the reduce and Adam over every parameter.
// Parameters, moments and gradients are flat f32 vectors of the leaves in
// ops/cuda_sgd.py::leaf_specs order, each at a multiple of 4 floats; `slot`
// says what each one is (ops/cuda_general.py::epoch_slots).
#include "policy_general.cuh"
#include "policy_resident.cuh"

#include <utility>
#include <vector>

// One trunk of the per-layer epoch. Must match
// pyflyt_tpu_torch/ops/cuda_general.py::_GeneralEpochTrunkC. The arrays are
// host memory the caller keeps alive for the call.
struct GeneralEpochTrunk {
  int depth;
  const int* dims;        // depth + 2 widths: the input, each layer's outputs, the head's
  const long long* w;     // depth + 1: W_l (dims[l] x dims[l + 1]) at params + w[l], its gradient at a slab row + w[l]
  const long long* b;     // depth + 1: bias_l at params + b[l]
  const long long* img;   // depth + 1: W_l bf16 (dims[l] x pad32(dims[l + 1])) at image + img[l]
  const long long* out;   // depth + 1: layer l's f32 outputs (mb x dims[l + 1]) at ws + out[l]
  const long long* act;   // depth: tanh layer l's bf16 outputs (mb x pad32(dims[l + 1])) at acts + act[l]
  const int* cs;          // depth + 1: dz_l's column sums from column cs[l] of a colsum row
};

// Must match pyflyt_tpu_torch/ops/cuda_general.py::_EpochArgsC.
struct GeneralEpochArgs {
  const float* mbs;        // (n_mb, mb, feat) f32: [obs | action | old_logp | adv | ret]
  const float* adv_stats;  // (n_mb, 2) f32: advantage mean, population std
  const int* t0;           // (1,) int32: Adam's count before the epoch
  float* params;           // (P,) f32, updated in place
  float* mu;               // (P,) f32, first moment, in place
  float* nu;               // (P,) f32, second moment, in place
  float* metrics;          // (n_mb, 5) f32: loss, pg_loss, v_loss, entropy, approx_kl
  float* ws;               // each layer's f32 outputs
  __nv_bfloat16* obs;      // (n_mb, mb, pad32(obs_dim)) bf16: the obs rounded once a call
  __nv_bfloat16* acts;     // each tanh layer's bf16 outputs
  __nv_bfloat16* dz;       // two (mb x dz_width) bf16 dz buffers a trunk (the actor's, the critic's), then the
                           // critic head's (mb x 32)
  __nv_bfloat16* image;    // every layer's W, bf16
  const int* slot;         // (P,) int32: a weight's image slot, -2 - a bias's colsum column, -1 else
  float* slab;             // (splits, P) f32: each row chunk's weight gradient (only at the weights)
  float* colsum;           // (tiles, cs_width) f32: each 128-row tile's dz column sums
  float* part;             // (tiles, 3 + act_dim) f32: sum pg_min, sum verr^2, sum (old - logp), g_log_std
  float* grad;             // (P,) f32
  float* block_sq;         // (ceil(P / 256),) f32
  GeneralEpochTrunk pi;
  GeneralEpochTrunk vf;
  long long ws_floats;
  long long acts_elems;
  long long image_elems;
  long long mean;          // (mb x act_dim) the actor's head in ws: pi.out[pi.depth], for the kernels
  long long value;         // (mb,) the critic's: vf.out[vf.depth]
  int ls_off;              // log_std's flat offset
  int P;
  int n_mb;
  int mb;
  int feat;
  int obs_dim;
  int act_dim;
  int dz_width;            // a dz buffer's row stride bound: the widest pad32 output
  int cs_width;            // floats of a colsum row
  int cs_mean;             // the heads' dz column sums: pi.cs[pi.depth], vf.cs[vf.depth]
  int cs_value;
  int splits;              // row chunks of the weight gradient
  int split_rows;          // rows a chunk (a multiple of general::BK)
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

using general::BM;
using general::GemmArgs;
using general::Operand;
using general::pad32;

constexpr int THREADS = 256;  // loss, reduce, Adam, image
constexpr int PER_THREAD = 4; // parameters a reduce or Adam thread takes
constexpr int CRITIC_LD = 32; // the critic head's dz row: pad32(1)

constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float ADAM_EPS = 1e-5f;
constexpr float LN_B1 = -0.10536051565782628f;    // log(0.9)
constexpr float LN_B2 = -0.0010005003335835335f;  // log(0.999)
constexpr float ENT_C = 1.4189385332046727f;      // 0.5 log(2 pi e)

__host__ __device__ __forceinline__ int n_tiles(const GeneralEpochArgs& p) { return (p.mb + BM - 1) / BM; }
__host__ __device__ __forceinline__ int n_part(const GeneralEpochArgs& p) { return 3 + p.act_dim; }
// the reduce's and Adam's blocks: THREADS x PER_THREAD parameters each
__host__ __device__ __forceinline__ int n_param_blocks(const GeneralEpochArgs& p) {
  return (p.P + THREADS * PER_THREAD - 1) / (THREADS * PER_THREAD);
}
// parameter e of thread threadIdx.x in a reduce or Adam block
__device__ __forceinline__ int param_of(int e) { return (blockIdx.x * PER_THREAD + e) * THREADS + threadIdx.x; }

__device__ __forceinline__ float clip_ls(const GeneralEpochArgs& p, float ls) {
  return p.has_range ? fminf(fmaxf(ls, p.ls_lo), p.ls_hi) : ls;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's sum in a fixed order (the warps' sums in warp order); every
// thread gets it, and `red` may be reused right after
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// The losses of minibatch m, a block a 128-row tile, thread r its row r:
// the log-prob, the ratio, the clipped surrogate's and the value loss's
// derivatives, the heads' dz (bf16: dmean into dz at row stride
// pad32(act_dim), dvalue into the critic's buffer); per tile the partial
// sums, the log_std gradient and the heads' dz column sums (f32).
__global__ void __launch_bounds__(THREADS) loss_kernel(const __grid_constant__ GeneralEpochArgs p, int m) {
  __shared__ float red[THREADS / 32];
  const int c = blockIdx.x, r = c * BM + threadIdx.x;
  const bool valid = threadIdx.x < BM && r < p.mb;
  const float* rp = p.mbs + (static_cast<long long>(m) * p.mb + (valid ? r : 0)) * p.feat;
  const float* mp = p.ws + p.mean + static_cast<long long>(valid ? r : 0) * p.act_dim;
  const float* ls = p.params + p.ls_off;
  const float inv_mb = 1.f / static_cast<float>(p.mb);
  const int c0 = p.obs_dim + p.act_dim, apad = pad32(p.act_dim);
  float g_logp = 0.f, pg = 0.f, kl = 0.f, verr = 0.f, dv = 0.f;
  if (valid) {
    const float logp = general::row_logp(rp + p.obs_dim, mp, ls, p.act_dim, p.has_range, p.ls_lo, p.ls_hi);
    const float old = rp[c0], adv = rp[c0 + 1], ret = rp[c0 + 2];
    const float ratio = expf(logp - old);
    const float adv_n = (adv - p.adv_stats[2 * m]) / (p.adv_stats[2 * m + 1] + 1e-8f);
    const float lo = 1.f - p.clip_eps, hi = 1.f + p.clip_eps;
    const float clipped = fminf(fmaxf(ratio, lo), hi);
    const float pg1 = ratio * adv_n, pg2 = clipped * adv_n;
    const float inband = (ratio >= lo && ratio <= hi) ? 1.f : 0.f;
    const float d1 = adv_n, d2 = adv_n * inband;
    const float dmin = pg1 == pg2 ? 0.5f * (d1 + d2) : (pg1 < pg2 ? d1 : d2);
    g_logp = (-inv_mb) * dmin * ratio;
    pg = fminf(pg1, pg2);
    kl = old - logp;
    verr = p.ws[p.value + r] - ret;
    dv = (p.vf_coef * inv_mb) * verr;
    __nv_bfloat16* dzv = p.dz + 4LL * p.mb * p.dz_width + static_cast<long long>(r) * CRITIC_LD;
    for (int j = 0; j < CRITIC_LD; ++j) dzv[j] = __float2bfloat16_rn(j == 0 ? dv : 0.f);
    __nv_bfloat16* dzm = p.dz + static_cast<long long>(r) * apad;
    for (int j = p.act_dim; j < apad; ++j) dzm[j] = __float2bfloat16_rn(0.f);
  }
  float* part = p.part + static_cast<long long>(c) * n_part(p);
  float* cs = p.colsum + static_cast<long long>(c) * p.cs_width;
  const float s_pg = block_sum(pg, red), s_v = block_sum(verr * verr, red), s_kl = block_sum(kl, red);
  const float s_dv = block_sum(dv, red);
  if (threadIdx.x == 0) {
    part[0] = s_pg;
    part[1] = s_v;
    part[2] = s_kl;
    cs[p.cs_value] = s_dv;
  }
  // per action: dmean = g_logp (a - mean) / var, and log_std's gradient
  // g_logp ((a - mean)^2 / var - 1), each summed over the tile
  for (int j = 0; j < p.act_dim; ++j) {
    float dm = 0.f, lsg = 0.f;
    if (valid) {
      const float var = expf(2.f * clip_ls(p, ls[j]));
      const float d = rp[p.obs_dim + j] - mp[j];
      dm = g_logp * (d / var);
      lsg = g_logp * (d * d / var - 1.f);
      p.dz[static_cast<long long>(r) * apad + j] = __float2bfloat16_rn(dm);
    }
    const float s_dm = block_sum(dm, red), s_ls = block_sum(lsg, red);
    if (threadIdx.x == 0) {
      cs[p.cs_mean + j] = s_dm;
      part[3 + j] = s_ls;
    }
  }
}

// Gradient: a weight's slab rows summed in chunk order, a bias's tiles'
// column sums in tile order, log_std's tiles' terms less the entropy term
// (masked outside the clamp band); per-block sums of squares; block 0
// writes minibatch m's metrics row from the pre-update log_std. A thread
// takes PER_THREAD parameters, THREADS apart, its reads (read-only for the
// kernel) issued together.
__global__ void __launch_bounds__(THREADS) reduce_kernel(const __grid_constant__ GeneralEpochArgs p, int m) {
  __shared__ float red[THREADS / 32];
  const int tiles = n_tiles(p), np = n_part(p);
  int slot[PER_THREAD];
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) slot[e] = param_of(e) < p.P ? __ldg(p.slot + param_of(e)) : -1;
  float g[PER_THREAD], sq = 0.f;
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int i = param_of(e), s = slot[e];
    g[e] = 0.f;
    if (s >= 0) {
      for (int c = 0; c < p.splits; ++c) g[e] += __ldg(p.slab + static_cast<long long>(c) * p.P + i);
    } else if (s <= -2) {
      const float* cs = p.colsum + (-2 - s);
      for (int tt = 0; tt < tiles; ++tt) g[e] += cs[static_cast<long long>(tt) * p.cs_width];
    } else if (i >= p.ls_off && i < p.ls_off + p.act_dim) {
      for (int tt = 0; tt < tiles; ++tt) g[e] += p.part[static_cast<long long>(tt) * np + 3 + i - p.ls_off];
      g[e] -= p.ent_coef;
      const float raw = p.params[i];
      if (p.has_range && !(raw > p.ls_lo && raw < p.ls_hi)) g[e] = 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    if (param_of(e) < p.P) p.grad[param_of(e)] = g[e];
    sq += g[e] * g[e];
  }
  sq = block_sum(sq, red);
  if (threadIdx.x == 0) p.block_sq[blockIdx.x] = sq;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int tt = 0; tt < tiles; ++tt) {
      s0 += p.part[static_cast<long long>(tt) * np + 0];
      s1 += p.part[static_cast<long long>(tt) * np + 1];
      s2 += p.part[static_cast<long long>(tt) * np + 2];
    }
    const float inv_mb = 1.f / static_cast<float>(p.mb);
    const float pg_loss = -s0 * inv_mb;
    const float v_loss = 0.5f * s1 * inv_mb;
    const float kl = s2 * inv_mb;
    float ent = 0.f;
    for (int jj = 0; jj < p.act_dim; ++jj) ent += clip_ls(p, p.params[p.ls_off + jj]) + ENT_C;
    float* row = p.metrics + static_cast<long long>(m) * 5;
    row[0] = pg_loss + p.vf_coef * v_loss - p.ent_coef * ent;
    row[1] = pg_loss;
    row[2] = v_loss;
    row[3] = ent;
    row[4] = kl;
  }
}

// Global-norm clip and Adam, in place, each updated weight's bf16 into the
// image. Every block sums the block sums of squares in the same order (a
// thread's strided share, then the block's sum in a fixed order), so every
// block sees the same norm.
__global__ void __launch_bounds__(THREADS) adam_kernel(const __grid_constant__ GeneralEpochArgs p, int m) {
  __shared__ float red[THREADS / 32];
  __shared__ float coef[3];  // scale, c1, c2
  const int nb = n_param_blocks(p);
  float sq = 0.f;
  for (int b = threadIdx.x; b < nb; b += THREADS) sq += __ldg(p.block_sq + b);
  sq = block_sum(sq, red);
  if (threadIdx.x == 0) {
    const float gnorm = sqrtf(sq);
    coef[0] = gnorm < p.max_grad_norm ? 1.f : p.max_grad_norm / gnorm;
    const float tt = static_cast<float>(*p.t0 + m + 1);
    coef[1] = 1.f - expf(tt * LN_B1);
    coef[2] = 1.f - expf(tt * LN_B2);
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int i = param_of(e);
    if (i >= p.P) break;
    const float g = __ldg(p.grad + i) * coef[0];
    const float m_new = B1 * p.mu[i] + (1.f - B1) * g;
    const float v_new = B2 * p.nu[i] + (1.f - B2) * (g * g);
    p.mu[i] = m_new;
    p.nu[i] = v_new;
    const float upd = (m_new / coef[1]) / (sqrtf(v_new / coef[2]) + ADAM_EPS);
    const float w = p.params[i] - p.lr * upd;
    p.params[i] = w;
    const int s = __ldg(p.slot + i);
    if (s >= 0) p.image[s] = __float2bfloat16_rn(w);
  }
}

// The image of the weights as given: the first minibatch's.
__global__ void __launch_bounds__(THREADS) image_kernel(const __grid_constant__ GeneralEpochArgs p) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= p.P) return;
  const int s = p.slot[i];
  if (s >= 0) p.image[s] = __float2bfloat16_rn(p.params[i]);
}

// One GEMM of the epoch, its maps made once a call: which kernel, and
// whether its A is the obs (whose plane is the minibatch).
struct Step {
  GemmArgs g;
  int kind;
  bool obs;
};
enum Kind : int { FWD_TANH = 0, FWD_HEAD = 1, WGRAD = 2, DGRAD = 3 };

cudaError_t launch(const Step& s, int m, cudaStream_t st) {
  GemmArgs g = s.g;
  if (s.obs) g.a_z = m;
  switch (s.kind) {
    case FWD_TANH: return general::launch_gemm<general::EPI_TANH, 0, 1>(g, st);
    case FWD_HEAD: return general::launch_gemm<general::EPI_BIAS, 0, 1>(g, st);
    case WGRAD: return general::launch_gemm<general::EPI_STORE, 1, 1>(g, st);
    default: return general::launch_gemm<general::EPI_DTANH, 0, 0>(g, st);
  }
}

int widest(const GeneralEpochTrunk& T) {
  int w = 0;
  for (int l = 1; l <= T.depth + 1; ++l) w = pad32(T.dims[l]) > w ? pad32(T.dims[l]) : w;
  return w;
}

bool fits(long long off, long long elems, long long size, int align) {
  return off >= 0 && off + elems <= size && off % align == 0;
}

// A trunk the wrapper lays out: `in` inputs, `outs` outputs, every offset
// inside its buffer and aligned as its maps need.
bool trunk_ok(const GeneralEpochArgs& p, const GeneralEpochTrunk& T, int outs, long long mb) {
  if (T.depth < 0 || T.dims == nullptr || T.w == nullptr || T.b == nullptr || T.img == nullptr ||
      T.out == nullptr || T.act == nullptr || T.cs == nullptr || T.dims[0] != p.obs_dim || T.dims[T.depth + 1] != outs)
    return false;
  for (int l = 0; l <= T.depth; ++l) {
    const long long k = T.dims[l], n = T.dims[l + 1];
    if (k <= 0 || n <= 0 || !fits(T.w[l], k * n, p.P, 1) || !fits(T.b[l], n, p.P, 1) ||
        !fits(T.img[l], k * pad32(static_cast<int>(n)), p.image_elems, 64) || !fits(T.out[l], mb * n, p.ws_floats, 1) ||
        T.cs[l] < 0 || T.cs[l] + n > p.cs_width || pad32(static_cast<int>(n)) > p.dz_width)
      return false;
    if (l < T.depth && !fits(T.act[l], mb * pad32(static_cast<int>(n)), p.acts_elems, 64)) return false;
  }
  return true;
}

// The steps of one trunk: its forward (a layer each) and its backward from
// the head's dz at dz + dz_head (row stride pad32 of the head's outputs):
// per layer from the head the weight gradient, then (but for layer 0) the
// data gradient into the other of the trunk's two dz buffers (from dz +
// dz_own).
cudaError_t trunk_steps(const GeneralEpochArgs& p, const GeneralEpochTrunk& T, long long dz_head, long long dz_own,
                        std::vector<Step>& fwd, std::vector<Step>& bwd) {
  const int mb = p.mb, obs_ld = pad32(p.obs_dim);
  const Operand obs{p.obs, p.obs_dim, obs_ld, mb, p.n_mb, static_cast<long long>(mb) * obs_ld};
  // layer l's input: the obs or tanh layer l - 1's bf16 outputs
  const auto input = [&](int l) {
    return l == 0 ? obs : Operand{p.acts + T.act[l - 1], T.dims[l], pad32(T.dims[l]), mb, 1, 0};
  };
  // W_l: the forward's B (k x n) MN-major, the data gradient's B^T K-major
  const auto weights = [&](int l) {
    return Operand{p.image + T.img[l], T.dims[l + 1], pad32(T.dims[l + 1]), T.dims[l], 1, 0};
  };
  cudaError_t e;
  for (int l = 0; l <= T.depth; ++l) {
    const int k = T.dims[l], n = T.dims[l + 1];
    Step s{};
    s.obs = l == 0;
    GemmArgs& g = s.g;
    g.bias = p.params + T.b[l];
    g.c = p.ws + T.out[l];
    g.ldc = n;
    g.m = mb;
    g.n = n;
    g.k = k;
    g.k_split = pad32(k);
    g.splits = 1;
    if (l < T.depth) {
      s.kind = FWD_TANH;
      g.cb = p.acts + T.act[l];
      g.ldcb = g.ncb = pad32(n);
      e = general::prepare_gemm<general::EPI_TANH, 0, 1>(g, input(l), weights(l));
    } else {
      s.kind = FWD_HEAD;
      e = general::prepare_gemm<general::EPI_BIAS, 0, 1>(g, input(l), weights(l));
    }
    if (e != cudaSuccess) return e;
    fwd.push_back(s);
  }
  const long long dz0 = dz_own, dz1 = dz_own + static_cast<long long>(mb) * p.dz_width;
  long long cur = dz_head;
  for (int l = T.depth; l >= 0; --l) {
    const int k = T.dims[l], n = T.dims[l + 1];
    const Operand dz{p.dz + cur, n, pad32(n), mb, 1, 0};
    Step w{};  // dW_l = in^T dz_l, a partial a chunk of rows
    w.kind = WGRAD;
    w.obs = l == 0;
    w.g.c = p.slab + T.w[l];
    w.g.ldc = n;
    w.g.c_split = p.P;
    w.g.m = k;
    w.g.n = n;
    w.g.k = mb;
    w.g.k_split = p.split_rows;
    w.g.splits = p.splits;
    if ((e = general::prepare_gemm<general::EPI_STORE, 1, 1>(w.g, input(l), dz)) != cudaSuccess) return e;
    bwd.push_back(w);
    if (l == 0) break;
    const long long next = cur == dz0 ? dz1 : dz0;
    Step d{};  // dz_{l-1} = (dz_l W_l^T) (1 - a_{l-1}^2), its column sums the bias gradient
    d.kind = DGRAD;
    d.g.cb = p.dz + next;
    d.g.ldcb = d.g.ncb = pad32(k);
    d.g.act = p.ws + T.out[l - 1];
    d.g.ld_act = k;
    d.g.colsum = p.colsum + T.cs[l - 1];
    d.g.colsum_ld = p.cs_width;
    d.g.m = mb;
    d.g.n = k;
    d.g.k = n;
    d.g.k_split = pad32(n);
    d.g.splits = 1;
    if ((e = general::prepare_gemm<general::EPI_DTANH, 0, 0>(d.g, dz, weights(l))) != cudaSuccess) return e;
    bwd.push_back(d);
    cur = next;
  }
  return cudaSuccess;
}

// A second stream and two events a device, made at first use: the critic's
// GEMMs run beside the actor's, so that each fills the SMs the other's
// tail leaves idle.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t to_side = nullptr, to_main = nullptr;
};

cudaError_t side_of(Side*& side) {
  static Side sides[16];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= 16) return cudaErrorInvalidDevice;
  Side& s = sides[device];
  if (s.stream == nullptr) {
    if ((e = cudaEventCreateWithFlags(&s.to_side, cudaEventDisableTiming)) != cudaSuccess ||
        (e = cudaEventCreateWithFlags(&s.to_main, cudaEventDisableTiming)) != cudaSuccess ||
        (e = cudaStreamCreateWithFlags(&s.stream, cudaStreamNonBlocking)) != cudaSuccess)
      return e;
  }
  side = &s;
  return cudaSuccess;
}

// `to` waits for what `from` has queued so far
cudaError_t join(cudaStream_t to, cudaStream_t from, cudaEvent_t ev) {
  const cudaError_t e = cudaEventRecord(ev, from);
  return e == cudaSuccess ? cudaStreamWaitEvent(to, ev, 0) : e;
}

}  // namespace

// One epoch on the per-layer route: 2 kernels a call, then 3 (depth_pi +
// depth_vf) + 7 a minibatch, queued on `stream` but for the critic's
// forward and backward GEMMs, which go to a second stream between two
// joins (the actor's and the critic's dz buffers apart): after the loss
// and before the reduce everything on `stream` waits for them. Shapes are
// checked by the Python wrapper and again here. Returns the first CUDA
// error of a launch (0 = every kernel launched).
extern "C" int fused_epoch_general(const GeneralEpochArgs* args, void* stream) {
  const GeneralEpochArgs& p = *args;
  const long long mb = p.mb;
  if (p.n_mb <= 0 || p.mb <= 0 || p.obs_dim <= 0 || p.act_dim <= 0 || p.obs_dim + p.act_dim + 3 > p.feat ||
      p.P <= 0 || p.ls_off < 0 || p.ls_off + p.act_dim > p.P || p.splits <= 0 || p.split_rows <= 0 ||
      p.split_rows % general::BK != 0 || static_cast<long long>(p.splits) * p.split_rows < pad32(p.mb) ||
      p.dz_width < pad32(p.act_dim) || p.dz_width % 8 != 0 || p.cs_width <= 0 || p.obs == nullptr ||
      p.acts == nullptr || p.dz == nullptr || p.image == nullptr || p.slot == nullptr ||
      !trunk_ok(p, p.pi, p.act_dim, mb) || !trunk_ok(p, p.vf, 1, mb) || widest(p.pi) > p.dz_width ||
      widest(p.vf) > p.dz_width || p.mean != p.pi.out[p.pi.depth] || p.value != p.vf.out[p.vf.depth] ||
      p.cs_mean != p.pi.cs[p.pi.depth] || p.cs_value != p.vf.cs[p.vf.depth])
    return static_cast<int>(cudaErrorInvalidValue);
  std::vector<Step> fwd[2], bwd[2];
  cudaError_t e;
  Side* side = nullptr;
  if ((e = trunk_steps(p, p.pi, 0, 0, fwd[0], bwd[0])) != cudaSuccess ||
      (e = trunk_steps(p, p.vf, 4 * mb * p.dz_width, 2 * mb * p.dz_width, fwd[1], bwd[1])) != cudaSuccess ||
      (e = side_of(side)) != cudaSuccess)
    return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream), sd = side->stream;
  const int nb = (p.P + THREADS - 1) / THREADS;
  if ((e = general::round_rows(p.mbs, p.feat, static_cast<long long>(p.n_mb) * p.mb, p.obs_dim, p.obs,
                               pad32(p.obs_dim), st)) != cudaSuccess)
    return static_cast<int>(e);
  image_kernel<<<nb, THREADS, 0, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  for (int m = 0; m < p.n_mb; ++m) {
    if ((e = join(sd, st, side->to_side)) != cudaSuccess) return static_cast<int>(e);
    for (int tr = 0; tr < 2; ++tr)
      for (const Step& s : fwd[tr])
        if ((e = launch(s, m, tr ? sd : st)) != cudaSuccess) return static_cast<int>(e);
    if ((e = join(st, sd, side->to_main)) != cudaSuccess) return static_cast<int>(e);
    loss_kernel<<<n_tiles(p), THREADS, 0, st>>>(p, m);
    if ((e = cudaGetLastError()) != cudaSuccess || (e = join(sd, st, side->to_side)) != cudaSuccess)
      return static_cast<int>(e);
    for (int tr = 0; tr < 2; ++tr)
      for (const Step& s : bwd[tr])
        if ((e = launch(s, m, tr ? sd : st)) != cudaSuccess) return static_cast<int>(e);
    if ((e = join(st, sd, side->to_main)) != cudaSuccess) return static_cast<int>(e);
    reduce_kernel<<<n_param_blocks(p), THREADS, 0, st>>>(p, m);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    adam_kernel<<<n_param_blocks(p), THREADS, 0, st>>>(p, m);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The resident route: four kernels a minibatch
// ---------------------------------------------------------------------------
//
// For every trunk pair whose widest width fits a block (ops/cuda_general.py::
// epoch_tile), an epoch is one image kernel, then for each minibatch four
// kernels, each a programmatic dependent launch of the one before:
//  - rep::fwd_bwd_kernel, grid (row tiles, 2 trunks): a block takes a tile
//    of rows of one trunk through the resident forward of
//    policy_resident.cuh (its layer loop, ring, fragments and epilogue, so
//    each row's mean and value are K3g's and the per-layer route's bit for
//    bit), the loss in the head's epilogue (one thread a row), then the data
//    gradient back through the layers on the same loop: each layer's dz
//    times W^T from the trunk's backward image (W_L^T, ..., W_1^T laid out
//    as a trunk of their own, ops/cuda_general.py::epoch_layouts), whose
//    blocks the same walk streams after the forward's; the epilogue takes
//    1 - a^2 from the f32 tanh outputs the forward wrote to a per-tile f32
//    buffer (`factor`, read back by the thread that wrote it), rounds dz to
//    bf16 into the next layer's input and sums its columns in f32 over the
//    tile in a fixed order (the bias gradients). It writes each layer's bf16
//    input and bf16 dz tiles to device memory for the weight gradient, and
//    the tile's loss partials.
//  - rep::wgrad_kernel: every layer's A^T dZ over the minibatch's rows from
//    those bf16 tiles (no rounding on load), 128 x 128 outputs a block,
//    mma.sync from ldmatrix.trans, a 4-stage cp.async ring, the rows split
//    into `splits` chunks, each chunk's partial into its row of the slab;
//  - rep::reduce_kernel: the gradient as the slab rows', the tiles' column
//    sums and partials' sums, each in a fixed order (no atomics: an epoch
//    is bit-reproducible), per-block sums of squares, the metrics row;
//  - rep::adam_kernel: the global norm (every block sums the block sums in
//    the same order), the clip, Adam in place, and each updated weight into
//    both trunks' images: bf16 at its slot of the forward image and (but
//    for the first layer's) of the backward one, a bias f32, so the next
//    minibatch's bulk copies land them as they are and no image is rebuilt.
// rep::image_kernel writes the first minibatch's images from the
// parameters as given. The arithmetic is the per-layer route's (bf16
// matmul inputs, f32 sums, the tanh, 1 - a^2 from f32 activations, the
// loss, clip and Adam in f32).
//
// What sets its time at the 3 x 256 trunk (PERF.md): the 13.3 GFLOP a
// minibatch run on mma.sync (the forward must stay K3g's bits, so no
// wgmma), and the bytes: the f32 tanh outputs (the 1 - a^2 factors need
// them exact, and neither the registers at 128 a thread nor the shared
// memory beside the ring and the two activation buffers hold a tile's) go
// to device memory and back, 50 MB a minibatch, and the bf16 tiles, 52 MB,
// are written once and read by the weight gradient.

namespace rep {

constexpr int MAX_LAYERS = resident::MAX_LAYERS;
constexpr int MAX_DIMS = 17;  // MAX_LAYERS + 1 widths a trunk

}  // namespace rep

// One trunk of the resident epoch. Must match ops/cuda_general.py::_EpochTrunkC.
struct EpochTrunk {
  int dims[rep::MAX_DIMS];          // the real widths: the input, each tanh layer's, the head's
  int w_off[rep::MAX_LAYERS];       // W_l (dims[l] x dims[l + 1], row-major) at params + w_off[l]
  int b_off[rep::MAX_LAYERS];       // b_l at params + b_off[l]
  long long act[rep::MAX_LAYERS];   // layer l's bf16 input, (rows x fwd.k[l]), at acts + act[l]
  long long dz[rep::MAX_LAYERS];    // its bf16 dz, (rows x fwd.n[l]), at dzs + dz[l]
  long long fac[rep::MAX_LAYERS];   // a tanh layer's f32 outputs, (rows x fwd.n[l]), at factor + fac[l]
  int cs[rep::MAX_LAYERS];          // layer l's dz column sums from column cs[l] of a colsum row
  ResidentTrunk fwd;                // the forward image: layers W_0 .. W_L, the head last
  ResidentTrunk bwd;                // the backward image: W_L^T .. W_1^T (no layer: a linear trunk)
};

// K2g's resident route. Must match ops/cuda_general.py::_ResidentEpochArgsC.
struct ResidentEpochArgs {
  const float* mbs;        // (n_mb, mb, feat) f32: [obs | action | old_logp | adv | ret]
  const float* adv_stats;  // (n_mb, 2) f32: advantage mean, population std
  const int* t0;           // (1,) int32: Adam's count before the epoch
  float* params;           // (P,) f32, updated in place
  float* mu;               // (P,) f32, first moment, in place
  float* nu;               // (P,) f32, second moment, in place
  float* metrics;          // (n_mb, 5) f32: loss, pg_loss, v_loss, entropy, approx_kl
  uint8_t* image[4];       // the actor's forward and backward images, the critic's (zero padding)
  __nv_bfloat16* acts;     // each layer's bf16 input tiles
  __nv_bfloat16* dzs;      // each layer's bf16 dz tiles
  float* factor;           // each tanh layer's f32 outputs
  float* colsum;           // (2, tiles, cs_width) f32: each tile's dz column sums
  float* part;             // (tiles, 3 + act_dim) f32: sum pg_min, sum verr^2, sum (old - logp), g_log_std
  float* slab;             // (splits, P) f32: each row chunk's weight gradient (only at the weights)
  float* grad;             // (P,) f32
  float* block_sq;         // (ceil(P / 256),) f32
  EpochTrunk trunk[2];     // the actor, the critic
  int ls_off;              // log_std's flat offset
  int P;
  int n_mb;
  int mb;
  int feat;
  int obs_dim;
  int act_dim;
  int tile;                // rows a fwd_bwd block: 128 or 64 (ops/cuda_general.py::epoch_tile)
  int width;               // the activation buffers' width: the widest k of the four images
  int cs_width;            // floats of a colsum row
  int splits;              // row chunks of the weight gradient
  int split_rows;          // rows a chunk (a multiple of rep::WG_BK)
  float lr;
  float clip_eps;
  float ent_coef;
  float vf_coef;
  float max_grad_norm;
  int has_range;
  float ls_lo;
  float ls_hi;
};

namespace rep {

using resident::ACT_PAD;
using resident::KC;
using resident::NC;
using resident::Warps;

constexpr int WG_BM = 128, WG_BN = 128, WG_BK = 32;  // a weight-gradient block's outputs, rows a stage
constexpr int WG_STAGES = 4;
constexpr int WG_THREADS = 256;                      // 8 warps, 2 (units) x 4 (outputs) of 64 x 32
constexpr int WG_LD = WG_BM + 8;                     // bf16 a staged row: 272 bytes, ldmatrix conflict-free
constexpr int WG_OPERAND = WG_BK * WG_LD;            // bf16 an operand a stage
constexpr int WG_SMEM = WG_STAGES * 2 * WG_OPERAND * 2;
static_assert(WG_BM == WG_BN, "one staged row width for both operands");

__host__ __device__ __forceinline__ int n_tiles(const ResidentEpochArgs& p) { return (p.mb + p.tile - 1) / p.tile; }
__host__ __device__ __forceinline__ int depth(const EpochTrunk& T) { return T.fwd.layers - 1; }
__host__ __device__ __forceinline__ int n_part(const ResidentEpochArgs& p) { return 3 + p.act_dim; }

// The floats of the loss's per-warp sums: pg_min, approx_kl, each action's
// g_log_std and dmean (the actor; the critic two)
__host__ __device__ __forceinline__ int loss_sums(int act_dim) { return 2 + 2 * act_dim; }

// A fwd_bwd block's dynamic shared memory: the ring, two bf16 activation
// buffers, two bias buffers, the staged head outputs (then their dz), the
// per-warp sums (the loss's, then the data gradient's column sums) and the
// ring's barriers.
__host__ __device__ constexpr int red_floats(int tile, int width, int act_dim) {
  return tile / 32 * (width > 2 + 2 * act_dim ? width : 2 + 2 * act_dim);
}
__host__ __device__ constexpr int smem_bytes(int tile, int width, int act_dim) {
  return resident::STAGES * resident::STAGE_BYTES + 2 * tile * (width + ACT_PAD) * 2 +
         2 * resident::bias_floats(width, act_dim) * 4 + tile * resident::stage_stride(act_dim) * 4 +
         red_floats(tile, width, act_dim) * 4 + resident::STAGES * 16;
}

__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void pdl_launch_next() { asm volatile("griddepcontrol.launch_dependents;" ::: "memory"); }

__device__ __forceinline__ float clip_ls(const ResidentEpochArgs& p, float ls) {
  return p.has_range ? fminf(fmaxf(ls, p.ls_lo), p.ls_hi) : ls;
}

// rows x cols bf16 (a multiple of 8 columns) from shared memory (row
// stride lds) to device memory (row stride cols), 16 bytes a thread a step
template <int THREADS>
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int lds, int rows, int cols) {
  const int vec = cols / 8;
  for (int i = threadIdx.x; i < rows * vec; i += THREADS) {
    const int r = i / vec, c = 8 * (i % vec);
    *reinterpret_cast<uint4*>(dst + static_cast<long long>(r) * cols + c) =
        *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

// The data gradient's epilogue of one chunk: dz of the layer below is acc
// (dz W^T) times 1 - a^2, a the f32 tanh output in `fac` (row stride ldf)
// at the fragment's own place (the forward's epilogue wrote it from the
// same fragment), rounded to bf16 into `out`; each column's sum over the
// warp's 32 rows (f32, its fragments in order, then lanes by a butterfly)
// into red[(warp % MW) ldr + column].
template <int TILE, int NT>
__device__ __forceinline__ void backward_epilogue(const float (&acc)[2][NT][4], int c0, int rows,
                                                  __nv_bfloat16* out, int lda, const float* fac, int ldf, float* red,
                                                  int ldr) {
  using W = Warps<TILE>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp % W::MW) * 32, wn = (warp / W::MW) * resident::WN;
  const int gr = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    if (wn + ni * 8 >= rows) continue;  // the same for every lane: rows is a multiple of 32
    const int cc = c0 + wn + ni * 8 + 2 * t4;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mi * 16 + gr + 8 * h;
        const float2 a = *reinterpret_cast<const float2*>(fac + static_cast<long long>(r) * ldf + cc);
        const float v0 = acc[mi][ni][2 * h] * (1.f - a.x * a.x), v1 = acc[mi][ni][2 * h + 1] * (1.f - a.y * a.y);
        *reinterpret_cast<__nv_bfloat162*>(out + r * lda + cc) = __floats2bfloat162_rn(v0, v1);
        s0 += v0;
        s1 += v1;
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (gr == 0) {
      red[(warp % W::MW) * ldr + cc] = s0;
      red[(warp % W::MW) * ldr + cc + 1] = s1;
    }
  }
}

template <int TILE>
__global__ void __launch_bounds__(Warps<TILE>::THREADS, 1) fwd_bwd_kernel(const __grid_constant__ ResidentEpochArgs p,
                                                                          int m) {
  using W = Warps<TILE>;
  constexpr int THREADS = W::THREADS, MW = W::MW;
  extern __shared__ __align__(128) uint8_t smem[];
  pdl_wait();
  pdl_launch_next();
  const int t = blockIdx.y, tile = blockIdx.x, tiles = n_tiles(p);
  const EpochTrunk& E = p.trunk[t];
  const ResidentTrunk& F = E.fwd;
  const ResidentTrunk& B = E.bwd;
  const int L = depth(E);
  const int row0 = tile * TILE;
  const int lda = p.width + ACT_PAD;
  __nv_bfloat16* const buf0 = reinterpret_cast<__nv_bfloat16*>(smem + resident::STAGES * resident::STAGE_BYTES);
  __nv_bfloat16* const buf1 = buf0 + TILE * lda;
  const auto buf = [&](int i) { return i % 2 ? buf1 : buf0; };  // a select, not an index
  const int nb = resident::bias_floats(p.width, p.act_dim);
  float* biases = reinterpret_cast<float*>(buf1 + TILE * lda);
  float* stage = biases + 2 * nb;  // the head's outputs, then their dz: a row's at stage + r ms
  const int ms = resident::stage_stride(p.act_dim);
  float* red = stage + TILE * ms;
  const uint32_t full = general::smem_addr(red + red_floats(TILE, p.width, p.act_dim));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < resident::STAGES; ++s) {
      resident::mbar_init(full + 8 * s, 1);
      resident::mbar_init(full + 8 * (resident::STAGES + s), THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int total = 0;
  for (int l = 0; l < F.layers; ++l) total += (F.n[l] + NC - 1) / NC * (F.k[l] / KC);
  for (int l = 0; l < B.layers; ++l) total += (B.n[l] + NC - 1) / NC * (B.k[l] / KC);
  resident::Ring rg{general::smem_addr(smem), full, full + 8 * resident::STAGES, 0, 0, total};
  const ResidentTrunk* const trunks[2] = {&F, &B};
  const uint8_t* const images[2] = {p.image[2 * t], p.image[2 * t + 1]};
  resident::Walk<2> walk(trunks, images);  // the forward image's blocks, then the backward one's

  const float* rows = p.mbs + static_cast<long long>(m) * p.mb * p.feat;
  resident::load_rows<TILE>(buf(0), lda, rows, p.feat, p.mb, p.obs_dim, F.k[0], row0);
  // the forward, as K3g's: layer l reads buf(l)
  for (int l = 0; l <= L; ++l) {
    float* bias = biases + (l % 2) * nb;
    for (int i = tid; i < F.n[l]; i += THREADS) bias[i] = reinterpret_cast<const float*>(p.image[2 * t] + F.b[l])[i];
    __syncthreads();  // the layer's input and bias are written
    store_tile<THREADS>(p.acts + E.act[l] + static_cast<long long>(row0) * F.k[l], buf(l), lda, TILE, F.k[l]);
    const bool head = l == L;
    float* fac = head ? nullptr : p.factor + E.fac[l] + static_cast<long long>(row0) * F.n[l];
    resident::layer<TILE>(F, l, general::smem_addr(buf(l)), lda, rg, walk, [&](const auto& acc, int c0, int n) {
      resident::forward_epilogue<TILE, true>(acc, bias, c0, n, head, buf(l + 1), lda, fac, F.n[l],
                                             [&](int r, int cc, float v0, float v1) {
        if (cc < (t == 0 ? p.act_dim : 1)) stage[r * ms + cc] = v0;
        if (cc + 1 < (t == 0 ? p.act_dim : 1)) stage[r * ms + cc + 1] = v1;
      });
    });
  }
  __syncthreads();  // the head's outputs are staged

  // the loss, one thread a row: the head's dz into `stage`, the per-warp sums into `red`
  const int nq = t == 0 ? loss_sums(p.act_dim) : 2;
  if (tid < TILE) {  // whole warps
    const int r = tid;
    const long long row = row0 + r;
    const bool valid = row < p.mb;
    const float* rp = rows + (valid ? row : 0) * p.feat;
    const float inv_mb = 1.f / static_cast<float>(p.mb);
    const int c0 = p.obs_dim + p.act_dim;
    float* q = red + warp * nq;
    if (t == 0) {
      const float* ls = p.params + p.ls_off;
      float* mp = stage + r * ms;
      float g_logp = 0.f, pg = 0.f, kl = 0.f;
      if (valid) {
        const float logp = general::row_logp(rp + p.obs_dim, mp, ls, p.act_dim, p.has_range, p.ls_lo, p.ls_hi);
        const float old = rp[c0], adv = rp[c0 + 1];
        const float ratio = expf(logp - old);
        const float adv_n = (adv - p.adv_stats[2 * m]) / (p.adv_stats[2 * m + 1] + 1e-8f);
        const float lo = 1.f - p.clip_eps, hi = 1.f + p.clip_eps;
        const float clipped = fminf(fmaxf(ratio, lo), hi);
        const float pg1 = ratio * adv_n, pg2 = clipped * adv_n;
        const float inband = (ratio >= lo && ratio <= hi) ? 1.f : 0.f;
        const float d1 = adv_n, d2 = adv_n * inband;
        const float dmin = pg1 == pg2 ? 0.5f * (d1 + d2) : (pg1 < pg2 ? d1 : d2);
        g_logp = (-inv_mb) * dmin * ratio;
        pg = fminf(pg1, pg2);
        kl = old - logp;
      }
      pg = warp_sum(pg);
      kl = warp_sum(kl);
      if (lane == 0) {
        q[0] = pg;
        q[1] = kl;
      }
      for (int j = 0; j < p.act_dim; ++j) {
        float dm = 0.f, lsg = 0.f;
        if (valid) {
          const float var = expf(2.f * clip_ls(p, ls[j]));
          const float d = rp[p.obs_dim + j] - mp[j];
          dm = g_logp * (d / var);
          lsg = g_logp * (d * d / var - 1.f);
        }
        mp[j] = dm;
        lsg = warp_sum(lsg);
        const float sdm = warp_sum(dm);
        if (lane == 0) {
          q[2 + j] = lsg;
          q[2 + p.act_dim + j] = sdm;
        }
      }
    } else {
      float verr = 0.f;
      if (valid) verr = stage[r * ms] - rp[c0 + 2];
      const float dv = (p.vf_coef * inv_mb) * verr;
      stage[r * ms] = dv;
      const float sv = warp_sum(verr * verr), sdv = warp_sum(dv);
      if (lane == 0) {
        q[0] = sv;
        q[1] = sdv;
      }
    }
  }
  __syncthreads();  // the per-warp sums and the head's dz are written
  float* cs_row = p.colsum + (static_cast<long long>(t) * tiles + tile) * p.cs_width;
  float* part = p.part + static_cast<long long>(tile) * n_part(p);
  if (tid < nq) {  // the tile's sums: the warps' in order
    float s = 0.f;
    for (int w = 0; w < TILE / 32; ++w) s += red[w * nq + tid];
    if (t == 0) {
      if (tid < 2)
        part[tid == 0 ? 0 : 2] = s;
      else if (tid < 2 + p.act_dim)
        part[3 + tid - 2] = s;
      else
        cs_row[E.cs[L] + tid - 2 - p.act_dim] = s;
    } else {
      if (tid == 0)
        part[1] = s;
      else
        cs_row[E.cs[L]] = s;
    }
  }
  // the head's dz, bf16, zero past its outputs, as the data gradient's first input
  const int outs = t == 0 ? p.act_dim : 1;
  __nv_bfloat16* dz_in = buf(L + 1);
  for (int i = tid; i < TILE * F.n[L]; i += THREADS) {
    const int r = i / F.n[L], c = i % F.n[L];
    dz_in[r * lda + c] = __float2bfloat16_rn(c < outs ? stage[r * ms + c] : 0.f);
  }
  __syncthreads();
  store_tile<THREADS>(p.dzs + E.dz[L] + static_cast<long long>(row0) * F.n[L], dz_in, lda, TILE, F.n[L]);

  // the data gradient: backward layer j is W_l^T, l = L - j, from dz_l in
  // buf(l + 1) to dz_{l-1} in buf(l)
  for (int j = 0; j < B.layers; ++j) {
    const int l = L - j;
    if (j > 0) __syncthreads();  // the layer's input is written; the last one's sums are read
    const float* fac = p.factor + E.fac[l - 1] + static_cast<long long>(row0) * F.n[l - 1];
    __nv_bfloat16* out = buf(l);
    resident::layer<TILE>(B, j, general::smem_addr(buf(l + 1)), lda, rg, walk,
                          [&](const auto& acc, int c0, int n) {
      backward_epilogue<TILE>(acc, c0, n, out, lda, fac, F.n[l - 1], red, p.width);
    });
    __syncthreads();  // dz_{l-1} and its per-warp column sums are written
    for (int c = tid; c < B.n[j]; c += THREADS) {
      float s = 0.f;
      for (int w = 0; w < MW; ++w) s += red[w * p.width + c];
      cs_row[E.cs[l - 1] + c] = s;
    }
    store_tile<THREADS>(p.dzs + E.dz[l - 1] + static_cast<long long>(row0) * F.n[l - 1], out, lda, TILE,
                        F.n[l - 1]);
  }
}

// ---------------------------------------------------------------------------
// the weight gradient
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The weight-gradient jobs: for each trunk and layer, its (fwd.k[l] /
// WG_BM) x (fwd.n[l] / WG_BN) output tiles, rounded up. Job j's trunk,
// layer and first unit and output; false past the last.
__host__ __device__ inline bool wgrad_job(const ResidentEpochArgs& p, int j, int& t, int& l, int& m0, int& n0) {
  for (t = 0; t < 2; ++t) {
    const ResidentTrunk& F = p.trunk[t].fwd;
    for (l = 0; l < F.layers; ++l) {
      const int nt = (F.n[l] + WG_BN - 1) / WG_BN, count = (F.k[l] + WG_BM - 1) / WG_BM * nt;
      if (j < count) {
        m0 = j / nt * WG_BM;
        n0 = j % nt * WG_BN;
        return true;
      }
      j -= count;
    }
  }
  return false;
}

__host__ __device__ inline int wgrad_jobs(const ResidentEpochArgs& p) {
  int count = 0;
  for (int t = 0; t < 2; ++t) {
    const ResidentTrunk& F = p.trunk[t].fwd;
    for (int l = 0; l < F.layers; ++l) count += (F.k[l] + WG_BM - 1) / WG_BM * ((F.n[l] + WG_BN - 1) / WG_BN);
  }
  return count;
}

// dW_l (fwd.k[l] x fwd.n[l]) = A^T dZ over split blockIdx.y's rows, A =
// layer l's bf16 inputs, dZ its bf16 dz (both row-major over the rows):
// the block's 128 units x 128 outputs, the units and outputs the staged
// rows' contiguous dimension, so both operands' fragments come through
// ldmatrix.trans; the real entries of W_l into the split's slab row.
__global__ void __launch_bounds__(WG_THREADS, 2) wgrad_kernel(const __grid_constant__ ResidentEpochArgs p) {
  extern __shared__ __align__(128) uint8_t smem[];
  pdl_wait();
  pdl_launch_next();
  int t, l, m0, n0;
  if (!wgrad_job(p, blockIdx.x, t, l, m0, n0)) return;
  const EpochTrunk& E = p.trunk[t];
  const int K = E.fwd.k[l], N = E.fwd.n[l];  // units (A's columns) and outputs (dZ's)
  const __nv_bfloat16* A = p.acts + E.act[l];
  const __nv_bfloat16* Z = p.dzs + E.dz[l];
  const int rows_pad = n_tiles(p) * p.tile;
  const int r0 = blockIdx.y * p.split_rows, r1 = min(rows_pad, r0 + p.split_rows);
  const int steps = r1 > r0 ? (r1 - r0) / WG_BK : 0;
  const uint32_t base = general::smem_addr(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int q = lane >> 3, jj = lane & 7, gr = lane >> 2, t4 = lane & 3;

  // stage s of step i: rows r0 + i WG_BK .., A's units m0 .. m0 + 127 then dZ's outputs n0 ..
  auto load = [&](int i, int s) {
#pragma unroll
    for (int e = 0; e < 2 * WG_BK * (WG_BM / 8) / WG_THREADS; ++e) {
      const int c = tid + WG_THREADS * e;
      const int op = c / (WG_BK * WG_BM / 8), cc = c % (WG_BK * WG_BM / 8);
      const int r = cc / (WG_BM / 8), u = (cc % (WG_BM / 8)) * 8;
      const long long row = r0 + i * WG_BK + r;
      const bool in = op == 0 ? m0 + u < K : n0 + u < N;
      const __nv_bfloat16* src = op == 0 ? A + row * K + m0 + u : Z + row * N + n0 + u;
      cp_async16(base + ((s * 2 + op) * WG_OPERAND + r * WG_LD + u) * 2, in ? src : A, in);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_wait<WG_STAGES - 2>();
    __syncthreads();  // step i has landed for every thread; every warp is done with step i - 1's stage
    if (i + WG_STAGES - 1 < steps) load(i + WG_STAGES - 1, (i + WG_STAGES - 1) % WG_STAGES);
    cp_commit();
    const int s = i % WG_STAGES;
    const uint32_t a_base = base + (s * 2) * WG_OPERAND * 2, b_base = base + (s * 2 + 1) * WG_OPERAND * 2;
#pragma unroll
    for (int ks = 0; ks < WG_BK; ks += 16) {
      // fragment matrix q of A: units + 8 (q & 1), rows + 8 (q >> 1); of dZ's
      // pair: rows + 8 (q & 1), outputs + 8 (q >> 1)
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        if (m0 + wm + mi * 16 < K)
          general::ldsm4_t(af[mi], a_base + ((ks + (q >> 1) * 8 + jj) * WG_LD + wm + mi * 16 + (q & 1) * 8) * 2);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        if (n0 + wn + np * 16 < N)
          general::ldsm4_t(bf[np], b_base + ((ks + (q & 1) * 8 + jj) * WG_LD + wn + np * 16 + (q >> 1) * 8) * 2);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (m0 + wm + mi * 16 >= K) continue;
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          if (n0 + wn + np * 16 >= N) continue;
          general::mma(acc[mi][2 * np], af[mi], bf[np][0], bf[np][1]);
          general::mma(acc[mi][2 * np + 1], af[mi], bf[np][2], bf[np][3]);
        }
      }
    }
  }
  cp_wait<0>();

  // fragment c of (mi, ni): unit m0 + wm + 16 mi + gr + 8 (c / 2), output
  // n0 + wn + 8 ni + 2 t4 + c % 2
  const int k_real = E.dims[l], n_real = E.dims[l + 1];
  float* out = p.slab + static_cast<long long>(blockIdx.y) * p.P + E.w_off[l];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int u = m0 + wm + mi * 16 + gr + 8 * (c >> 1), o = n0 + wn + ni * 8 + 2 * t4 + (c & 1);
        if (u < k_real && o < n_real) out[static_cast<long long>(u) * n_real + o] = acc[mi][ni][c];
      }
}

// ---------------------------------------------------------------------------
// the reduce, Adam and the images
// ---------------------------------------------------------------------------

enum Kind : int { PAD = 0, WEIGHT = 1, BIAS = 2, LOG_STD = 3 };

// What flat parameter i is: its kind, trunk, layer and its place e in the leaf
__device__ __forceinline__ int leaf_of(const ResidentEpochArgs& p, int i, int& t, int& l, int& e) {
  if (i >= p.ls_off && i < p.ls_off + p.act_dim) {
    e = i - p.ls_off;
    return LOG_STD;
  }
  for (t = 0; t < 2; ++t) {
    const EpochTrunk& E = p.trunk[t];
    for (l = 0; l < E.fwd.layers; ++l) {
      if (i >= E.w_off[l] && i < E.w_off[l] + E.dims[l] * E.dims[l + 1]) {
        e = i - E.w_off[l];
        return WEIGHT;
      }
      if (i >= E.b_off[l] && i < E.b_off[l] + E.dims[l + 1]) {
        e = i - E.b_off[l];
        return BIAS;
      }
    }
  }
  return PAD;
}

// the byte offset of W^T entry (unit r, input k) in a layer's blocks of a
// resident image (ops/cuda_general.py::resident_offset)
__device__ __forceinline__ int resident_offset(int r, int k, int k_pad, int n_pad) {
  const int c = r / NC, lines = min(NC, n_pad - c * NC);
  return c * NC * k_pad * 2 + (k / KC) * lines * KC * 2 + resident::swizzle(r % NC, k % KC);
}

// flat parameter i, now `v`, into the images: a weight bf16 into the
// forward image and (but for the first layer's) the backward one, a bias
// f32 into the forward image; log_std and the padding have no slot
__device__ __forceinline__ void write_images(const ResidentEpochArgs& p, int i, float v) {
  int t = 0, l = 0, e = 0;
  const int kind = leaf_of(p, i, t, l, e);
  if (kind != WEIGHT && kind != BIAS) return;
  const EpochTrunk& E = p.trunk[t];
  const ResidentTrunk& F = E.fwd;
  if (kind == BIAS) {
    *reinterpret_cast<float*>(p.image[2 * t] + F.b[l] + 4 * e) = v;
    return;
  }
  const int kk = e / E.dims[l + 1], nn = e % E.dims[l + 1];
  const __nv_bfloat16 w = __float2bfloat16_rn(v);
  *reinterpret_cast<__nv_bfloat16*>(p.image[2 * t] + F.w[l] + resident_offset(nn, kk, F.k[l], F.n[l])) = w;
  if (l > 0) {
    const ResidentTrunk& B = E.bwd;
    const int j = depth(E) - l;
    *reinterpret_cast<__nv_bfloat16*>(p.image[2 * t + 1] + B.w[j] + resident_offset(kk, nn, B.k[j], B.n[j])) = w;
  }
}

__global__ void __launch_bounds__(THREADS) reduce_kernel(const __grid_constant__ ResidentEpochArgs p, int m) {
  __shared__ float red[THREADS / 32];
  pdl_wait();
  pdl_launch_next();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int tiles = n_tiles(p), np = n_part(p);
  float g = 0.f;
  if (i < p.P) {
    int t = 0, l = 0, e = 0;
    const int kind = leaf_of(p, i, t, l, e);
    if (kind == WEIGHT) {
      for (int s = 0; s < p.splits; ++s) g += p.slab[static_cast<long long>(s) * p.P + i];
    } else if (kind == BIAS) {
      const float* cs = p.colsum + static_cast<long long>(t) * tiles * p.cs_width + p.trunk[t].cs[l] + e;
      for (int tt = 0; tt < tiles; ++tt) g += cs[static_cast<long long>(tt) * p.cs_width];
    } else if (kind == LOG_STD) {
      for (int tt = 0; tt < tiles; ++tt) g += p.part[static_cast<long long>(tt) * np + 3 + e];
      g -= p.ent_coef;
      const float raw = p.params[i];
      if (p.has_range && !(raw > p.ls_lo && raw < p.ls_hi)) g = 0.f;
    }
    p.grad[i] = g;
  }
  const float sq = block_sum(g * g, red);
  if (threadIdx.x == 0) p.block_sq[blockIdx.x] = sq;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int tt = 0; tt < tiles; ++tt) {
      s0 += p.part[static_cast<long long>(tt) * np + 0];
      s1 += p.part[static_cast<long long>(tt) * np + 1];
      s2 += p.part[static_cast<long long>(tt) * np + 2];
    }
    const float inv_mb = 1.f / static_cast<float>(p.mb);
    const float pg_loss = -s0 * inv_mb;
    const float v_loss = 0.5f * s1 * inv_mb;
    const float kl = s2 * inv_mb;
    float ent = 0.f;
    for (int jj = 0; jj < p.act_dim; ++jj) ent += clip_ls(p, p.params[p.ls_off + jj]) + ENT_C;
    float* row = p.metrics + static_cast<long long>(m) * 5;
    row[0] = pg_loss + p.vf_coef * v_loss - p.ent_coef * ent;
    row[1] = pg_loss;
    row[2] = v_loss;
    row[3] = ent;
    row[4] = kl;
  }
}

__global__ void __launch_bounds__(THREADS) adam_kernel(const __grid_constant__ ResidentEpochArgs p, int m) {
  __shared__ float coef[3];  // scale, c1, c2
  pdl_wait();
  pdl_launch_next();
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
  write_images(p, i, w);
}

// The images of the parameters as given: the first minibatch's weights.
__global__ void __launch_bounds__(THREADS) image_kernel(const __grid_constant__ ResidentEpochArgs p) {
  pdl_launch_next();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < p.P) write_images(p, i, p.params[i]);
}

// `kernel` on `st` after the stream's previous kernel, as a programmatic
// dependent launch (pdl_wait); then the launch's error
template <typename... Args, typename... Act>
cudaError_t launch(void (*kernel)(Args...), dim3 grid, int threads, int smem, cudaStream_t st, Act&&... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// A trunk the wrapper lays out: its forward image `in` inputs to `outs`,
// its backward image the forward's layers past the first, transposed and
// in reverse order, its workspace offsets inside their buffers.
bool epoch_trunk_ok(const ResidentEpochArgs& p, const EpochTrunk& E, int outs, long long rows) {
  const ResidentTrunk &F = E.fwd, &B = E.bwd;
  if (!resident::trunk_ok(F, p.obs_dim, outs, p.width) || E.dims[0] != p.obs_dim || E.dims[F.layers] != outs ||
      F.n[F.layers - 1] > p.width ||
      B.layers != F.layers - 1 || (B.layers > 0 && !resident::trunk_ok(B, outs, E.dims[1], p.width)))
    return false;
  for (int l = 0; l < F.layers; ++l) {
    if (E.dims[l + 1] <= 0 || F.k[l] < E.dims[l] || F.n[l] < E.dims[l + 1] || E.w_off[l] < 0 || E.b_off[l] < 0 ||
        E.w_off[l] + static_cast<long long>(E.dims[l]) * E.dims[l + 1] > p.P || E.b_off[l] + E.dims[l + 1] > p.P ||
        E.act[l] < 0 || E.dz[l] < 0 || E.fac[l] < 0 || E.cs[l] < 0 || E.cs[l] + F.n[l] > p.cs_width ||
        E.act[l] % 8 != 0 || E.dz[l] % 8 != 0 || E.fac[l] % 2 != 0)
      return false;
    if (l > 0) {
      const int j = F.layers - 1 - l;
      if (B.k[j] != F.n[l] || B.n[j] != F.k[l]) return false;
    }
  }
  return rows > 0;
}

}  // namespace rep

// One epoch on the resident route: the image kernel, then 4 kernels a
// minibatch, queued in order on `stream`. Shapes are checked by the Python
// wrapper and again here (the workspace's sizes are the wrapper's). Returns
// the first CUDA error of a launch (0 = every kernel launched).
extern "C" int fused_epoch_general_resident(const ResidentEpochArgs* args, void* stream) {
  const ResidentEpochArgs& p = *args;
  if (p.n_mb <= 0 || p.mb <= 0 || p.obs_dim <= 0 || p.act_dim <= 0 || p.obs_dim + p.act_dim + 3 > p.feat ||
      p.P <= 0 || p.ls_off < 0 || p.ls_off + p.act_dim > p.P || (p.tile != 128 && p.tile != 64) || p.width <= 0 ||
      p.width % resident::KC != 0 || rep::smem_bytes(p.tile, p.width, p.act_dim) > resident::SMEM_LIMIT ||
      rep::loss_sums(p.act_dim) > resident::Warps<64>::THREADS ||
      p.splits <= 0 || p.split_rows <= 0 || p.split_rows % rep::WG_BK != 0 ||
      static_cast<long long>(p.splits) * p.split_rows < static_cast<long long>(rep::n_tiles(p)) * p.tile)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int t = 0; t < 4; ++t)
    if (p.image[t] == nullptr || (reinterpret_cast<uintptr_t>(p.image[t]) & 15) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(rep::n_tiles(p)) * p.tile;
  if (!rep::epoch_trunk_ok(p, p.trunk[0], p.act_dim, rows) || !rep::epoch_trunk_ok(p, p.trunk[1], 1, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = rep::smem_bytes(p.tile, p.width, p.act_dim);
  auto fwd_bwd = p.tile == 128 ? rep::fwd_bwd_kernel<128> : rep::fwd_bwd_kernel<64>;
  const int threads = p.tile == 128 ? resident::Warps<128>::THREADS : resident::Warps<64>::THREADS;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(fwd_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(rep::wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, rep::WG_SMEM)) !=
          cudaSuccess)
    return static_cast<int>(e);
  const int nb = (p.P + THREADS - 1) / THREADS;
  const dim3 wgrad_grid(rep::wgrad_jobs(p), p.splits);
  rep::image_kernel<<<nb, THREADS, 0, st>>>(p);  // after whatever the stream ran before, in full
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  for (int m = 0; m < p.n_mb; ++m) {
    if ((e = rep::launch(fwd_bwd, dim3(rep::n_tiles(p), 2), threads, smem, st, p, m)) != cudaSuccess ||
        (e = rep::launch(rep::wgrad_kernel, wgrad_grid, rep::WG_THREADS, rep::WG_SMEM, st, p)) != cudaSuccess ||
        (e = rep::launch(rep::reduce_kernel, dim3(nb), THREADS, 0, st, p, m)) != cudaSuccess ||
        (e = rep::launch(rep::adam_kernel, dim3(nb), THREADS, 0, st, p, m)) != cudaSuccess)
      return static_cast<int>(e);
  }
  return 0;
}
