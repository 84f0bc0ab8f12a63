// A whole PPO epoch of minibatch SGD on the 2x256 tanh actor-critic:
// for each minibatch in turn, the forward of both trunks, the clipped-
// surrogate and value losses, a backward derived by hand, the global-norm
// clip, Adam over every parameter, and one metrics row.
//
// Replaces pyflyt_tpu/ops/pallas_sgd.py::build_fused_epoch with its
// arithmetic (pallas_sgd.py:21-26, :64-92, :357-512): every matmul takes
// bf16 inputs (round to nearest even) and accumulates in f32; everything
// elementwise, the reductions, the clip and Adam are f32. The loss keeps
// the Pallas kernel's corner cases: advantages normalised with the given
// per-minibatch mean/std, the 50/50 cotangent split where the two
// surrogate terms tie, and a log_std gradient masked by the strict
// inequality of the clamp band.
//
// What bounds it on an H100: about 837 kFLOP of bf16 matmul per row
// (forward, data gradient of every layer but the first, weight gradient of
// every layer), 219 GFLOP (0.22 ms at 989 TFLOP/s) for an epoch of
// 32 x 8192 rows, against 29 MB of minibatch rows and 3.5 MB of parameters
// and moments in and out (about 10 us at 3.35 TB/s): operations bound it.
//
// Design (simple and right first). The Pallas kernel keeps the ~144K
// parameters, both moments and the gradient accumulator resident in VMEM
// for the whole epoch; that is ~2.3 MB of f32, ten times an SM's shared
// memory, so here the epoch is four kernels per minibatch, queued in order
// on one stream by one host call (minibatch m+1 reads what update m wrote):
//  A. fwd_bwd_kernel, one block of 8 warps per 64 rows: both trunks'
//     forward with nvcuda::wmma bf16 fragments (K4's tile), the per-row
//     loss and its derivative, and the data gradient back to the first
//     layer (W read column-major through shared memory). It writes each
//     layer's bf16 input and its f32 dz to a workspace in device memory
//     (~50 MB at 8192 rows) and 11 per-tile partial sums (metrics and the
//     log_std gradient). The f32 activations stay in shared memory.
//  B. wgrad_kernel: the weight gradients A^T dZ and the bias sums, one
//     block per 64 x 64 output tile of each weight matrix and per quarter
//     of the rows, each reducing its rows in a fixed order: deterministic,
//     no atomics; the four row slabs are summed in order by C1.
//  C1. reduce_kernel: slab sums, the log_std gradient from the tile sums,
//     per-block sums of squares, and the metrics row (from the parameters
//     before the update, as the Pallas kernel reports entropy).
//  C2. adam_kernel: every block sums the block sums of squares in the same
//     order (the global norm), clips, and runs Adam with the bias
//     correction 1 - exp(t ln b), t = t0 + m + 1, in place.
// Parameters, moments and gradients are flat f32 vectors; each leaf starts
// at a multiple of 4 floats (offsets from the wrapper; the padding stays 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int TILE_M = 64;    // rows per block of kernel A
constexpr int HID = 256;      // trunk width
constexpr int K0 = 32;        // obs width padded for the first layer
constexpr int KC = 32;        // weight rows per shared-memory chunk
constexpr int THREADS = 256;
constexpr int MAX_ACT = 8;
constexpr int NPART = 3 + MAX_ACT;  // per tile: sum pg_min, sum verr^2, sum (old - logp), g_logstd
constexpr int SLABS = 4;            // row slabs of the weight-gradient reduction
constexpr int WG_TILE = 64;         // weight-gradient output tile (in x out)
constexpr int WG_ROWS = 32;         // rows per weight-gradient chunk
constexpr int JOBS_PER_TRUNK = 24;  // W0: 1x4 tiles, W1: 4x4, head: 4x1
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
  __nv_bfloat16* ws_x;     // (mb_pad, 32) bf16 obs
  __nv_bfloat16* ws_a;     // 4 x (mb_pad, 256) bf16: pi h1, pi h2, vf h1, vf h2
  float* ws_dz;            // 4 x (mb_pad, 256) f32: pi dz1, pi dz2, vf dz1, vf dz2
  float* ws_dmean;         // (mb_pad, 8) f32
  float* ws_dvalue;        // (mb_pad,) f32
  float* tile_part;        // (n_tiles, NPART) f32
  float* gpart;            // (SLABS, P) f32, zero where no leaf lies
  float* grad;             // (P,) f32
  float* block_sq;         // (ceil(P / 256),) f32
  int off[N_LEAVES];       // leaf offsets into the flat vectors
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

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct SmemA {
  __nv_bfloat16 x[TILE_M * K0];     // obs tile, bf16, zero-padded
  __nv_bfloat16 act[TILE_M * HID];  // bf16 input of the next matmul
  __nv_bfloat16 w[KC * HID];        // one weight chunk
  float h1[TILE_M * HID];           // f32 tanh output of layer 1
  float h2[TILE_M * HID];           // f32 tanh output of layer 2
  float stage[THREADS / 32][16 * 16];
  float head[TILE_M * MAX_ACT];     // mean, then dmean
  float rowv[TILE_M];               // value, then dvalue
  float red[THREADS / 32][NPART];   // per-warp partial sums
};

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ size_t mb_pad(const EpochArgs& p) {
  return static_cast<size_t>((p.mb + TILE_M - 1) / TILE_M) * TILE_M;
}

// acc (the warp's 16 x 128 slice of a 64 x 256 product) = in @ B, where
// `in` is (64, k_pad) bf16 in shared memory with leading dimension ld_in
// and B is W (k_real x 256, row-major f32; TRANS false) or W^T with W
// (256 x 256 row-major f32; TRANS true). W is rounded to bf16 as it is
// staged. Ends with a barrier: `in` may be overwritten afterwards.
template <bool TRANS>
__device__ void mm_tile(SmemA& s, const __nv_bfloat16* in, int ld_in, int k_pad,
                        int k_real, const float* W, AccFrag (&acc)[8]) {
  const int warp = threadIdx.x / 32;
  const int rb = (warp % 4) * 16;   // this warp's 16 rows
  const int cb = (warp / 4) * 128;  // and its 128 columns
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < k_pad; k0 += KC) {
    __syncthreads();  // the previous chunk is consumed, `in` is written
    if constexpr (!TRANS) {
      // s.w[r * 256 + c] = W[k0 + r][c]
      for (int idx = threadIdx.x; idx < KC * HID / 4; idx += THREADS) {
        const int r = idx / (HID / 4), c4 = idx % (HID / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + r < k_real)
          v = reinterpret_cast<const float4*>(W + static_cast<size_t>(k0 + r) * HID)[c4];
        __nv_bfloat16* d = s.w + r * HID + c4 * 4;
        d[0] = __float2bfloat16_rn(v.x);
        d[1] = __float2bfloat16_rn(v.y);
        d[2] = __float2bfloat16_rn(v.z);
        d[3] = __float2bfloat16_rn(v.w);
      }
    } else {
      // column-major chunk of W^T: s.w[c * KC + k] = W[c][k0 + k]
      for (int idx = threadIdx.x; idx < HID * KC / 4; idx += THREADS) {
        const int c = idx / (KC / 4), k4 = idx % (KC / 4);
        const float4 v =
            reinterpret_cast<const float4*>(W + static_cast<size_t>(c) * HID + k0)[k4];
        __nv_bfloat16* d = s.w + c * KC + k4 * 4;
        d[0] = __float2bfloat16_rn(v.x);
        d[1] = __float2bfloat16_rn(v.y);
        d[2] = __float2bfloat16_rn(v.z);
        d[3] = __float2bfloat16_rn(v.w);
      }
    }
    __syncthreads();
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, in + rb * ld_in + k0 + kk, ld_in);
      for (int j = 0; j < 8; ++j) {
        if constexpr (!TRANS) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, s.w + kk * HID + cb + j * 16, HID);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(b, s.w + (cb + j * 16) * KC + kk, KC);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done reading `in` and s.w
}

// h = tanh(acc + b): f32 into hout, bf16 into s.act and into the
// workspace tile gout (row-major, ld 256).
__device__ void epi_tanh(SmemA& s, AccFrag (&acc)[8], const float* b, float* hout,
                         __nv_bfloat16* gout) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rb = (warp % 4) * 16, cb = (warp / 4) * 128;
  float* st = s.stage[warp];
  for (int j = 0; j < 8; ++j) {
    wmma::store_matrix_sync(st, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = rb + e / 16, col = cb + j * 16 + e % 16;
      const float h = tanhf(st[e] + b[col]);
      const __nv_bfloat16 hb = __float2bfloat16_rn(h);
      hout[r * HID + col] = h;
      s.act[r * HID + col] = hb;
      gout[static_cast<size_t>(r) * HID + col] = hb;
    }
    __syncwarp();
  }
  __syncthreads();
}

// dz = acc * (1 - h^2) into the workspace tile gout (f32, ld 256).
__device__ void epi_dz(SmemA& s, AccFrag (&acc)[8], const float* h, float* gout) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rb = (warp % 4) * 16, cb = (warp / 4) * 128;
  float* st = s.stage[warp];
  for (int j = 0; j < 8; ++j) {
    wmma::store_matrix_sync(st, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = rb + e / 16, col = cb + j * 16 + e % 16;
      const float a = h[r * HID + col];
      gout[static_cast<size_t>(r) * HID + col] = st[e] * (1.f - a * a);
    }
    __syncwarp();
  }
  __syncthreads();
}

// Deterministic block sum of NPART values per thread (threads past the
// rows pass zeros): fixed shuffle pattern, then warps in order.
__device__ void block_partials(SmemA& s, float (&v)[NPART], float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = 0; k < NPART; ++k) {
    float x = v[k];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) s.red[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < NPART) {
    float t = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) t += s.red[w][threadIdx.x];
    out[threadIdx.x] = t;
  }
  __syncthreads();
}

// Forward, loss and backward of one 64-row tile of minibatch m.
__global__ void __launch_bounds__(THREADS) fwd_bwd_kernel(EpochArgs p, int m) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemA& s = *reinterpret_cast<SmemA*>(smem_raw);
  const int row0 = blockIdx.x * TILE_M;
  const size_t pad = mb_pad(p);
  const float* rows = p.mbs + static_cast<size_t>(m) * p.mb * p.feat;
  const float* P_ = p.params;
  const int A = p.act_dim, c0 = p.obs_dim + p.act_dim;
  const float inv_mb = 1.f / static_cast<float>(p.mb);
  AccFrag acc[8];

  // obs tile, bf16, zero past the minibatch and the obs width
  for (int idx = threadIdx.x; idx < TILE_M * K0; idx += THREADS) {
    const int r = idx / K0, c = idx % K0;
    float v = 0.f;
    if (row0 + r < p.mb && c < p.obs_dim) v = rows[static_cast<size_t>(row0 + r) * p.feat + c];
    const __nv_bfloat16 xb = __float2bfloat16_rn(v);
    s.x[idx] = xb;
    p.ws_x[(row0 + r) * static_cast<size_t>(K0) + c] = xb;
  }

  float part[NPART];
  for (int k = 0; k < NPART; ++k) part[k] = 0.f;
  const int r = threadIdx.x;  // the per-row epilogues: threads 0..63
  const bool row_ok = r < TILE_M && row0 + r < p.mb;

  // ---------------- actor
  __nv_bfloat16* a_h1 = p.ws_a + 0 * pad * HID + static_cast<size_t>(row0) * HID;
  __nv_bfloat16* a_h2 = p.ws_a + 1 * pad * HID + static_cast<size_t>(row0) * HID;
  mm_tile<false>(s, s.x, K0, K0, p.obs_dim, P_ + p.off[PI_W0], acc);
  epi_tanh(s, acc, P_ + p.off[PI_B0], s.h1, a_h1);
  mm_tile<false>(s, s.act, HID, HID, HID, P_ + p.off[PI_W1], acc);
  epi_tanh(s, acc, P_ + p.off[PI_B1], s.h2, a_h2);
  {  // mean head: bf16(h2) . bf16(W) + b
    const float* hw = P_ + p.off[PI_HW];
    const float* hb = P_ + p.off[PI_HB];
    for (int o = threadIdx.x; o < TILE_M * A; o += THREADS) {
      const int rr = o / A, j = o % A;
      float acc_h = 0.f;
      const __nv_bfloat16* a = s.act + rr * HID;
      for (int k = 0; k < HID; ++k)
        acc_h = fmaf(__bfloat162float(a[k]), bf(hw[k * A + j]), acc_h);
      s.head[rr * MAX_ACT + j] = acc_h + hb[j];
    }
  }
  __syncthreads();
  if (r < TILE_M) {  // per-row loss and d(loss)/d(mean), log_std partials
    float dmean[MAX_ACT];
    for (int j = 0; j < MAX_ACT; ++j) dmean[j] = 0.f;
    if (row_ok) {
      const float* row = rows + static_cast<size_t>(row0 + r) * p.feat;
      float ls[MAX_ACT], var[MAX_ACT], diff[MAX_ACT];
      float logp = 0.f;
      for (int j = 0; j < A; ++j) {
        ls[j] = P_[p.off[LOG_STD] + j];
        if (p.has_range) ls[j] = fminf(fmaxf(ls[j], p.ls_lo), p.ls_hi);
        var[j] = expf(2.f * ls[j]);
        diff[j] = row[p.obs_dim + j] - s.head[r * MAX_ACT + j];
        logp += -0.5f * (diff[j] * diff[j] / var[j] + 2.f * ls[j] + LOG2PI);
      }
      const float old_logp = row[c0], adv = row[c0 + 1];
      const float ratio = expf(logp - old_logp);
      const float a_mu = p.adv_stats[2 * m], a_sd = p.adv_stats[2 * m + 1];
      const float adv_n = (adv - a_mu) / (a_sd + 1e-8f);
      const float lo_c = 1.f - p.clip_eps, hi_c = 1.f + p.clip_eps;
      const float clipped = fminf(fmaxf(ratio, lo_c), hi_c);
      const float pg1 = ratio * adv_n, pg2 = clipped * adv_n;
      const float inband = (ratio >= lo_c && ratio <= hi_c) ? 1.f : 0.f;
      const float d1 = adv_n, d2 = adv_n * inband;
      const float dmin = pg1 == pg2 ? 0.5f * (d1 + d2) : (pg1 < pg2 ? d1 : d2);
      const float g_logp = (-inv_mb) * dmin * ratio;
      part[0] = fminf(pg1, pg2);
      part[2] = old_logp - logp;
      for (int j = 0; j < A; ++j) {
        dmean[j] = g_logp * (diff[j] / var[j]);
        part[3 + j] = g_logp * (diff[j] * diff[j] / var[j] - 1.f);
      }
    }
    float* gd = p.ws_dmean + static_cast<size_t>(row0 + r) * MAX_ACT;
    for (int j = 0; j < MAX_ACT; ++j) {
      s.head[r * MAX_ACT + j] = dmean[j];
      gd[j] = dmean[j];
    }
  }
  __syncthreads();
  {  // dz2 = (bf16(dmean) . bf16(W_head)^T) * (1 - h2^2)
    const float* hw = P_ + p.off[PI_HW];
    float* dz2 = p.ws_dz + 1 * pad * HID + static_cast<size_t>(row0) * HID;
    for (int idx = threadIdx.x; idx < TILE_M * HID; idx += THREADS) {
      const int rr = idx / HID, i = idx % HID;
      float da = 0.f;
      for (int j = 0; j < A; ++j) da = fmaf(bf(s.head[rr * MAX_ACT + j]), bf(hw[i * A + j]), da);
      const float h = s.h2[idx];
      const float dz = da * (1.f - h * h);
      dz2[idx] = dz;
      s.act[idx] = __float2bfloat16_rn(dz);
    }
  }
  // dz1 = (bf16(dz2) . bf16(W1)^T) * (1 - h1^2)
  mm_tile<true>(s, s.act, HID, HID, HID, P_ + p.off[PI_W1], acc);
  epi_dz(s, acc, s.h1, p.ws_dz + 0 * pad * HID + static_cast<size_t>(row0) * HID);

  // ---------------- critic
  __nv_bfloat16* v_h1 = p.ws_a + 2 * pad * HID + static_cast<size_t>(row0) * HID;
  __nv_bfloat16* v_h2 = p.ws_a + 3 * pad * HID + static_cast<size_t>(row0) * HID;
  mm_tile<false>(s, s.x, K0, K0, p.obs_dim, P_ + p.off[VF_W0], acc);
  epi_tanh(s, acc, P_ + p.off[VF_B0], s.h1, v_h1);
  mm_tile<false>(s, s.act, HID, HID, HID, P_ + p.off[VF_W1], acc);
  epi_tanh(s, acc, P_ + p.off[VF_B1], s.h2, v_h2);
  if (r < TILE_M) {  // value head, value error, d(loss)/d(value)
    const float* hw = P_ + p.off[VF_HW];
    float value = 0.f;
    const __nv_bfloat16* a = s.act + r * HID;
    for (int k = 0; k < HID; ++k) value = fmaf(__bfloat162float(a[k]), bf(hw[k]), value);
    value += P_[p.off[VF_HB]];
    float dvalue = 0.f;
    if (row_ok) {
      const float verr = value - rows[static_cast<size_t>(row0 + r) * p.feat + c0 + 2];
      part[1] = verr * verr;
      dvalue = (p.vf_coef * inv_mb) * verr;
    }
    s.rowv[r] = dvalue;
    p.ws_dvalue[row0 + r] = dvalue;
  }
  __syncthreads();
  {  // dz2 = (bf16(dvalue) . bf16(W_head)^T) * (1 - h2^2)
    const float* hw = P_ + p.off[VF_HW];
    float* dz2 = p.ws_dz + 3 * pad * HID + static_cast<size_t>(row0) * HID;
    for (int idx = threadIdx.x; idx < TILE_M * HID; idx += THREADS) {
      const int rr = idx / HID, i = idx % HID;
      const float da = bf(s.rowv[rr]) * bf(hw[i]);
      const float h = s.h2[idx];
      const float dz = da * (1.f - h * h);
      dz2[idx] = dz;
      s.act[idx] = __float2bfloat16_rn(dz);
    }
  }
  mm_tile<true>(s, s.act, HID, HID, HID, P_ + p.off[VF_W1], acc);
  epi_dz(s, acc, s.h1, p.ws_dz + 2 * pad * HID + static_cast<size_t>(row0) * HID);

  block_partials(s, part, p.tile_part + static_cast<size_t>(blockIdx.x) * NPART);
}

// Weight gradients of minibatch m: block (job, slab) reduces one 64 x 64
// tile of one matrix's A^T dZ over its quarter of the rows, in order, and
// the bias sums of dZ where its input tile is the first.
__global__ void __launch_bounds__(THREADS) wgrad_kernel(EpochArgs p) {
  __shared__ __align__(128) __nv_bfloat16 sa[WG_ROWS * WG_TILE];  // A chunk, rows x in
  __shared__ __align__(128) __nv_bfloat16 sz[WG_ROWS * WG_TILE];  // dZ chunk, rows x out
  __shared__ __align__(128) float sout[WG_TILE * WG_TILE];
  const size_t pad = mb_pad(p);
  const int trunk = blockIdx.x / JOBS_PER_TRUNK, job = blockIdx.x % JOBS_PER_TRUNK;
  const int slab = blockIdx.y;
  const bool pi = trunk == 0;

  // the job's matrix: input A (bf16, ld lda), output dZ (f32, ld ldz)
  const __nv_bfloat16* Am;
  const float* Z;
  int lda, in_real, ldz, out_w, in_tile, out_tile, off_w, off_b;
  if (job < 4) {  // first layer
    Am = p.ws_x; lda = K0; in_real = p.obs_dim;
    Z = p.ws_dz + (pi ? 0 : 2) * pad * HID; ldz = HID; out_w = HID;
    in_tile = 0; out_tile = job;
    off_w = p.off[pi ? PI_W0 : VF_W0]; off_b = p.off[pi ? PI_B0 : VF_B0];
  } else if (job < 20) {  // second layer
    Am = p.ws_a + (pi ? 0 : 2) * pad * HID; lda = HID; in_real = HID;
    Z = p.ws_dz + (pi ? 1 : 3) * pad * HID; ldz = HID; out_w = HID;
    in_tile = (job - 4) / 4; out_tile = (job - 4) % 4;
    off_w = p.off[pi ? PI_W1 : VF_W1]; off_b = p.off[pi ? PI_B1 : VF_B1];
  } else {  // head
    Am = p.ws_a + (pi ? 1 : 3) * pad * HID; lda = HID; in_real = HID;
    Z = pi ? p.ws_dmean : p.ws_dvalue; ldz = pi ? MAX_ACT : 1; out_w = pi ? p.act_dim : 1;
    in_tile = job - 20; out_tile = 0;
    off_w = p.off[pi ? PI_HW : VF_HW]; off_b = p.off[pi ? PI_HB : VF_HB];
  }
  const int i0 = in_tile * WG_TILE, o0 = out_tile * WG_TILE;
  const int slab_rows = ((p.mb + SLABS - 1) / SLABS + WG_ROWS - 1) / WG_ROWS * WG_ROWS;
  const int r_begin = slab * slab_rows;
  const int r_end = min(p.mb, r_begin + slab_rows);

  const int warp = threadIdx.x / 32;
  const int ib = (warp % 4) * 16;  // this warp's 16 input rows of the tile
  const int ob = (warp / 4) * 32;  // and its 32 output columns
  AccFrag acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  float bsum = 0.f;  // threads 0..63: the bias sum of column o0 + tid
  const bool do_bias = in_tile == 0 && threadIdx.x < WG_TILE && o0 + threadIdx.x < out_w;

  for (int r0 = r_begin; r0 < r_end; r0 += WG_ROWS) {
    __syncthreads();  // the previous chunk is consumed
    for (int idx = threadIdx.x; idx < WG_ROWS * WG_TILE; idx += THREADS) {
      const int k = idx / WG_TILE, c = idx % WG_TILE;
      const bool row_ok = r0 + k < r_end;
      __nv_bfloat16 a = __float2bfloat16_rn(0.f);
      if (row_ok && i0 + c < lda) a = Am[static_cast<size_t>(r0 + k) * lda + i0 + c];
      sa[idx] = a;
      float z = 0.f;
      if (row_ok && o0 + c < out_w) z = Z[static_cast<size_t>(r0 + k) * ldz + o0 + c];
      sz[idx] = __float2bfloat16_rn(z);
    }
    if (do_bias) {
      for (int k = 0; k < WG_ROWS && r0 + k < r_end; ++k)
        bsum += Z[static_cast<size_t>(r0 + k) * ldz + o0 + threadIdx.x];
    }
    __syncthreads();
    for (int kk = 0; kk < WG_ROWS; kk += 16) {
      // A^T: element (i, k) of the (in x rows) operand is sa[k][i]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
      wmma::load_matrix_sync(a, sa + kk * WG_TILE + ib, WG_TILE);
      for (int c = 0; c < 2; ++c) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, sz + kk * WG_TILE + ob + c * 16, WG_TILE);
        wmma::mma_sync(acc[c], a, b, acc[c]);
      }
    }
  }
  for (int c = 0; c < 2; ++c)
    wmma::store_matrix_sync(sout + ib * WG_TILE + ob + c * 16, acc[c], WG_TILE, wmma::mem_row_major);
  __syncthreads();
  float* g = p.gpart + static_cast<size_t>(slab) * p.P;
  for (int idx = threadIdx.x; idx < WG_TILE * WG_TILE; idx += THREADS) {
    const int i = idx / WG_TILE, o = idx % WG_TILE;
    if (i0 + i < in_real && o0 + o < out_w)
      g[off_w + (i0 + i) * out_w + o0 + o] = sout[idx];
  }
  if (do_bias) g[off_b + o0 + threadIdx.x] = bsum;
}

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

// Gradient = sum of the slabs (log_std: sum of the tile partials less the
// entropy term, masked outside the clamp band); per-block sums of squares;
// block 0 writes minibatch m's metrics row from the pre-update log_std.
__global__ void __launch_bounds__(THREADS) reduce_kernel(EpochArgs p, int m) {
  __shared__ float red[THREADS / 32];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int n_tiles = (p.mb + TILE_M - 1) / TILE_M;
  const int ls0 = p.off[LOG_STD];
  float g = 0.f;
  if (i < p.P) {
    if (i >= ls0 && i < ls0 + p.act_dim) {
      for (int t = 0; t < n_tiles; ++t) g += p.tile_part[static_cast<size_t>(t) * NPART + 3 + (i - ls0)];
      g -= p.ent_coef;
      const float raw = p.params[i];
      if (p.has_range && !(raw > p.ls_lo && raw < p.ls_hi)) g = 0.f;
    } else {
      for (int sl = 0; sl < SLABS; ++sl) g += p.gpart[static_cast<size_t>(sl) * p.P + i];
    }
    p.grad[i] = g;
  }
  const float sq = block_sum(g * g, red);
  if (threadIdx.x == 0) {
    p.block_sq[blockIdx.x] = sq;
    if (blockIdx.x == 0) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int t = 0; t < n_tiles; ++t) {
        s0 += p.tile_part[static_cast<size_t>(t) * NPART + 0];
        s1 += p.tile_part[static_cast<size_t>(t) * NPART + 1];
        s2 += p.tile_part[static_cast<size_t>(t) * NPART + 2];
      }
      const float inv_mb = 1.f / static_cast<float>(p.mb);
      const float pg_loss = -s0 * inv_mb;
      const float v_loss = 0.5f * s1 * inv_mb;
      const float kl = s2 * inv_mb;
      float ent = 0.f;
      for (int j = 0; j < p.act_dim; ++j) {
        float ls = p.params[ls0 + j];
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

// Global-norm clip and Adam, in place. Every block sums the block sums of
// squares in the same order, so every block sees the same norm.
__global__ void __launch_bounds__(THREADS) adam_kernel(EpochArgs p, int m) {
  __shared__ float coef[3];  // scale, c1, c2
  const int nb = (p.P + THREADS - 1) / THREADS;
  if (threadIdx.x < 32) {
    float sq = 0.f;
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
  p.params[i] = p.params[i] - p.lr * upd;
}

}  // namespace

// One epoch: 4 kernels per minibatch, queued in order on `stream`.
// Shapes are checked by the Python wrapper: obs_dim <= 32, two 256-wide
// tanh layers per trunk, act_dim <= 8. Returns the first CUDA error of a
// launch (0 = every kernel launched).
extern "C" int fused_epoch(const EpochArgs* args, void* stream) {
  const EpochArgs& p = *args;
  if (p.n_mb <= 0 || p.mb <= 0 || p.obs_dim <= 0 || p.obs_dim > K0 || p.act_dim <= 0 ||
      p.act_dim > MAX_ACT || p.obs_dim + p.act_dim + 3 > p.feat || p.P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < N_LEAVES; ++l)
    if (p.off[l] % 4 != 0 || p.off[l] < 0 || p.off[l] >= p.P)
      return static_cast<int>(cudaErrorInvalidValue);
  static int attr_device = -1;
  const int smem = static_cast<int>(sizeof(SmemA));
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device != attr_device) {
    e = cudaFuncSetAttribute(fwd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_device = device;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (p.mb + TILE_M - 1) / TILE_M;
  const int nb = (p.P + THREADS - 1) / THREADS;
  for (int m = 0; m < p.n_mb; ++m) {
    fwd_bwd_kernel<<<n_tiles, THREADS, smem, st>>>(p, m);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    wgrad_kernel<<<dim3(2 * JOBS_PER_TRUNK, SLABS), THREADS, 0, st>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    reduce_kernel<<<nb, THREADS, 0, st>>>(p, m);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    adam_kernel<<<nb, THREADS, 0, st>>>(p, m);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
