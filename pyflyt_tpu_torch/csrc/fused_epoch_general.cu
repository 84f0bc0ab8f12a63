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
// over every parameter, and each layer of each pass is a launch, so the
// chain of launches and the activations' round trips through device memory
// set the time of this first, simple design.
//
// Design: per minibatch, 3 (depth_pi + depth_vf) + 7 kernels queued in
// order on one stream by one host call:
//  - the forward: one GEMM a layer a trunk (policy_general.cuh), each
//    tanh layer's f32 outputs kept in the workspace for the backward;
//  - loss_kernel: a block a chunk of rows, a thread a row: the log-prob
//    (general::row_logp, K3g's), the losses, dmean, dvalue, each chunk's
//    partial sums and its log_std gradient;
//  - the backward of each trunk from its head: the weight gradient of a
//    layer (A^T dZ, one partial a chunk of rows, its bias gradient the
//    chunk's f32 column sums of dZ in the same launch) into the chunk's
//    slab row, then the data gradient (dZ W^T times 1 - a^2 of the layer
//    below) into the other of two dz buffers;
//  - reduce_kernel: the gradient as the slab rows' sum in chunk order, the
//    log_std term, per-block sums of squares and the metrics row: every sum
//    in a fixed order and no atomics, so the epoch is bit-reproducible;
//  - adam_kernel: every block sums the block sums of squares in the same
//    order (the global norm), clips and runs Adam in place. The next
//    minibatch's GEMMs read the updated f32 parameters directly.
// Parameters, moments and gradients are flat f32 vectors of the leaves in
// ops/cuda_sgd.py::leaf_specs order, each at a multiple of 4 floats.
#include "policy_general.cuh"

// Must match pyflyt_tpu_torch/ops/cuda_general.py::_EpochArgsC.
struct GeneralEpochArgs {
  const float* mbs;        // (n_mb, mb, feat) f32: [obs | action | old_logp | adv | ret]
  const float* adv_stats;  // (n_mb, 2) f32: advantage mean, population std
  const int* t0;           // (1,) int32: Adam's count before the epoch
  float* params;           // (P,) f32, updated in place
  float* mu;               // (P,) f32, first moment, in place
  float* nu;               // (P,) f32, second moment, in place
  float* metrics;          // (n_mb, 5) f32: loss, pg_loss, v_loss, entropy, approx_kl
  float* ws;               // the workspace: layer outputs, dz buffers, dvalue, g_logp
  float* slab;             // (chunks, P) f32: each chunk's gradient (zero where no leaf)
  float* chunk_part;       // (chunks, 3) f32: sum pg_min, sum verr^2, sum (old - logp)
  float* grad;             // (P,) f32
  float* block_sq;         // (ceil(P / 256),) f32
  GeneralTrunk pi;         // host arrays: w, b leaf offsets in params (and in a slab row); out in ws
  GeneralTrunk vf;
  long long mean;          // (mb x act_dim) the actor's head in ws: pi.out[pi.depth], for the kernels
  long long value;         // (mb,) the critic's: vf.out[vf.depth]
  long long dz0;           // two (mb x widest output) dz buffers in ws; the actor's dmean starts in dz0
  long long dz1;
  long long dv;            // (mb,) the critic's dvalue
  long long glogp;         // (mb,) each row's d loss / d logp
  long long ws_floats;
  int ls_off;              // log_std's flat offset
  int P;
  int n_mb;
  int mb;
  int feat;
  int obs_dim;
  int act_dim;
  int chunk;               // rows a weight-gradient partial sums (a multiple of general::BK)
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

using general::EPI_DTANH;
using general::EPI_STORE;
using general::GemmArgs;

constexpr int THREADS = 256;  // loss, reduce, Adam
constexpr int NPART = 3;

constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float ADAM_EPS = 1e-5f;
constexpr float LN_B1 = -0.10536051565782628f;    // log(0.9)
constexpr float LN_B2 = -0.0010005003335835335f;  // log(0.999)
constexpr float ENT_C = 1.4189385332046727f;      // 0.5 log(2 pi e)

__host__ __device__ __forceinline__ int n_chunks(const GeneralEpochArgs& p) { return (p.mb + p.chunk - 1) / p.chunk; }

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

// The losses of minibatch m, a block a chunk of rows: per row the log-prob,
// the ratio, the clipped surrogate's and the value loss's derivatives
// (dmean into ws + dz0, dvalue into ws + dv, d loss / d logp into
// ws + glogp); per chunk the partial sums and the log_std gradient.
__global__ void __launch_bounds__(THREADS) loss_kernel(const __grid_constant__ GeneralEpochArgs p, int m) {
  __shared__ float red[THREADS / 32];
  const int c = blockIdx.x;
  const int r0 = c * p.chunk, r1 = min(p.mb, r0 + p.chunk);
  const float* rows = p.mbs + static_cast<long long>(m) * p.mb * p.feat;
  const float* mean = p.ws + p.mean;
  const float* value = p.ws + p.value;
  float* dmean = p.ws + p.dz0;
  float* dv = p.ws + p.dv;
  float* glogp = p.ws + p.glogp;
  const float* ls = p.params + p.ls_off;
  const float inv_mb = 1.f / static_cast<float>(p.mb);
  const float adv_mean = p.adv_stats[2 * m], adv_std = p.adv_stats[2 * m + 1];
  const float lo = 1.f - p.clip_eps, hi = 1.f + p.clip_eps;
  const int c0 = p.obs_dim + p.act_dim;
  float s_pg = 0.f, s_v = 0.f, s_kl = 0.f;
  for (int r = r0 + threadIdx.x; r < r1; r += THREADS) {
    const float* rp = rows + static_cast<long long>(r) * p.feat;
    const float* mp = mean + static_cast<long long>(r) * p.act_dim;
    const float logp = general::row_logp(rp + p.obs_dim, mp, ls, p.act_dim, p.has_range, p.ls_lo, p.ls_hi);
    const float old = rp[c0], adv = rp[c0 + 1], ret = rp[c0 + 2];
    const float ratio = expf(logp - old);
    const float adv_n = (adv - adv_mean) / (adv_std + 1e-8f);
    const float clipped = fminf(fmaxf(ratio, lo), hi);
    const float pg1 = ratio * adv_n, pg2 = clipped * adv_n;
    const float inband = (ratio >= lo && ratio <= hi) ? 1.f : 0.f;
    const float d1 = adv_n, d2 = adv_n * inband;
    const float dmin = pg1 == pg2 ? 0.5f * (d1 + d2) : (pg1 < pg2 ? d1 : d2);
    const float g_logp = (-inv_mb) * dmin * ratio;
    for (int jj = 0; jj < p.act_dim; ++jj) {
      const float var = expf(2.f * clip_ls(p, ls[jj]));
      dmean[static_cast<long long>(r) * p.act_dim + jj] = g_logp * ((rp[p.obs_dim + jj] - mp[jj]) / var);
    }
    glogp[r] = g_logp;
    const float verr = value[r] - ret;
    dv[r] = (p.vf_coef * inv_mb) * verr;
    s_pg += fminf(pg1, pg2);
    s_v += verr * verr;
    s_kl += old - logp;
  }
  s_pg = block_sum(s_pg, red);
  s_v = block_sum(s_v, red);
  s_kl = block_sum(s_kl, red);
  if (threadIdx.x == 0) {
    float* part = p.chunk_part + static_cast<long long>(c) * NPART;
    part[0] = s_pg;
    part[1] = s_v;
    part[2] = s_kl;
  }
  // log_std's gradient over the chunk: sum_rows g_logp ((a - mean)^2 / var - 1)
  for (int jj = 0; jj < p.act_dim; ++jj) {
    const float var = expf(2.f * clip_ls(p, ls[jj]));
    float s = 0.f;
    for (int r = r0 + threadIdx.x; r < r1; r += THREADS) {
      const float d = rows[static_cast<long long>(r) * p.feat + p.obs_dim + jj] -
                      mean[static_cast<long long>(r) * p.act_dim + jj];
      s += glogp[r] * (d * d / var - 1.f);
    }
    s = block_sum(s, red);
    if (threadIdx.x == 0) p.slab[static_cast<long long>(c) * p.P + p.ls_off + jj] = s;
  }
}

// The backward of one trunk from dz_head (ws + dz_head, mb x dims[depth +
// 1]): per layer from the head the weight gradient and its bias gradient
// into the slab, then (but for layer 0) the data gradient into the other
// dz buffer.
cudaError_t trunk_backward(const GeneralEpochArgs& p, const GeneralTrunk& T, const float* rows, long long dz_head,
                           cudaStream_t st) {
  const int splits = n_chunks(p);
  long long cur = dz_head;
  for (int l = T.depth; l >= 0; --l) {
    const int k = T.dims[l], n = T.dims[l + 1];
    const float* in = l == 0 ? rows : p.ws + T.out[l - 1];
    const long long ld_in = l == 0 ? p.feat : k;
    GemmArgs w{};  // dW_l = in^T dz_l, a partial a chunk of rows
    w.a = in;
    w.a_si = 1;
    w.a_sj = ld_in;
    w.b = p.ws + cur;
    w.b_si = n;
    w.b_sj = 1;
    w.c = p.slab + T.w[l];
    w.ldc = n;
    w.c_split = p.P;
    w.colsum = p.slab + T.b[l];
    w.colsum_split = p.P;
    w.m = k;
    w.n = n;
    w.k = p.mb;
    w.k_split = p.chunk;
    cudaError_t e = general::gemm<EPI_STORE>(w, splits, st);
    if (e != cudaSuccess) return e;
    if (l == 0) break;
    const long long next = cur == p.dz0 ? p.dz1 : p.dz0;
    GemmArgs d{};  // dz_{l-1} = (dz_l W_l^T) (1 - a_{l-1}^2)
    d.a = p.ws + cur;
    d.a_si = n;
    d.a_sj = 1;
    d.b = p.params + T.w[l];
    d.b_si = 1;
    d.b_sj = n;
    d.c = p.ws + next;
    d.ldc = k;
    d.act = p.ws + T.out[l - 1];
    d.ld_act = k;
    d.m = p.mb;
    d.n = k;
    d.k = n;
    d.k_split = n;
    if ((e = general::gemm<EPI_DTANH>(d, 1, st)) != cudaSuccess) return e;
    cur = next;
  }
  return cudaSuccess;
}

// Gradient: the slab rows' sums in chunk order (log_std's less the entropy
// term, masked outside the clamp band); per-block sums of squares; block 0
// writes minibatch m's metrics row from the pre-update log_std.
__global__ void __launch_bounds__(THREADS) reduce_kernel(const __grid_constant__ GeneralEpochArgs p, int m) {
  __shared__ float red[THREADS / 32];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int chunks = n_chunks(p);
  float g = 0.f;
  if (i < p.P) {
    for (int c = 0; c < chunks; ++c) g += p.slab[static_cast<long long>(c) * p.P + i];
    if (i >= p.ls_off && i < p.ls_off + p.act_dim) {
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
    for (int c = 0; c < chunks; ++c) {
      s0 += p.chunk_part[static_cast<long long>(c) * NPART + 0];
      s1 += p.chunk_part[static_cast<long long>(c) * NPART + 1];
      s2 += p.chunk_part[static_cast<long long>(c) * NPART + 2];
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

// Global-norm clip and Adam, in place. Every block sums the block sums of
// squares in the same order, so every block sees the same norm.
__global__ void __launch_bounds__(THREADS) adam_kernel(const __grid_constant__ GeneralEpochArgs p, int m) {
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
  p.params[i] = p.params[i] - p.lr * upd;
}

int widest(const GeneralTrunk& T) {
  int w = 0;
  for (int l = 1; l <= T.depth + 1; ++l) w = T.dims[l] > w ? T.dims[l] : w;
  return w;
}

bool fits(long long off, long long floats, long long ws) { return off >= 0 && off + floats <= ws; }

}  // namespace

// One epoch: 3 (depth_pi + depth_vf) + 7 kernels a minibatch, queued in
// order on `stream`. Shapes are checked by the Python wrapper and again
// here. Returns the first CUDA error of a launch (0 = every kernel
// launched).
extern "C" int fused_epoch_general(const GeneralEpochArgs* args, void* stream) {
  const GeneralEpochArgs& p = *args;
  if (p.n_mb <= 0 || p.mb <= 0 || p.obs_dim <= 0 || p.act_dim <= 0 || p.obs_dim + p.act_dim + 3 > p.feat ||
      p.P <= 0 || p.chunk <= 0 || p.chunk % general::BK != 0 || p.ls_off < 0 || p.ls_off + p.act_dim > p.P ||
      !general::trunk_ok(p.pi, p.obs_dim, p.act_dim, p.P) || !general::trunk_ok(p.vf, p.obs_dim, 1, p.P))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long mb = p.mb;
  const long long wide = widest(p.pi) > widest(p.vf) ? widest(p.pi) : widest(p.vf);
  bool ok = fits(p.dz0, mb * wide, p.ws_floats) && fits(p.dz1, mb * wide, p.ws_floats) &&
            fits(p.dv, mb, p.ws_floats) && fits(p.glogp, mb, p.ws_floats);
  for (int tr = 0; tr < 2; ++tr) {
    const GeneralTrunk& T = tr ? p.vf : p.pi;
    for (int l = 0; l <= T.depth; ++l) ok = ok && fits(T.out[l], mb * T.dims[l + 1], p.ws_floats);
  }
  if (!ok || p.mean != p.pi.out[p.pi.depth] || p.value != p.vf.out[p.vf.depth])
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (p.P + THREADS - 1) / THREADS;
  cudaError_t e;
  for (int m = 0; m < p.n_mb; ++m) {
    const float* rows = p.mbs + static_cast<long long>(m) * p.mb * p.feat;
    for (int tr = 0; tr < 2; ++tr) {
      const GeneralTrunk& T = tr ? p.vf : p.pi;
      e = general::trunk_forward(T, p.params, rows, p.feat, p.mb, p.ws, p.ws + T.out[T.depth], st);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    loss_kernel<<<n_chunks(p), THREADS, 0, st>>>(p, m);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    if ((e = trunk_backward(p, p.pi, rows, p.dz0, st)) != cudaSuccess) return static_cast<int>(e);
    if ((e = trunk_backward(p, p.vf, rows, p.dv, st)) != cudaSuccess) return static_cast<int>(e);
    reduce_kernel<<<nb, THREADS, 0, st>>>(p, m);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    adam_kernel<<<nb, THREADS, 0, st>>>(p, m);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
