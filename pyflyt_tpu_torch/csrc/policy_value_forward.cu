// Fused actor-critic forward: the actor mean and the critic value of a batch
// of observations, both 2x256 tanh trunks and both heads in one launch.
//
// Replaces pyflyt_tpu/ops/pallas_policy.py::build_policy_value_forward with
// its arithmetic (pallas_sgd.py::_mm): every matmul takes bf16 inputs and
// accumulates in f32; bias and tanh are f32; a trunk activation is rounded
// to bf16 when the next layer reads it, as the Pallas kernel's `_mm` casts.
//
// What bounds it on an H100: about 286 kFLOP per row (2 x (21x256 +
// 256x256) MACs plus the heads), 2.34 GFLOP at 8192 rows, about 2.4 us at
// the 989 TFLOP/s bf16 tensor-core peak; the bytes (obs, bf16 weights,
// outputs) are under 1.2 MB, about 0.35 us. So the tensor cores bound it.
// Design (simple and right first): one block of 8 warps per 64 rows; the
// obs tile is converted to bf16 and zero-padded to the next multiple of 32
// (K=21 -> 32, 33 -> 64; widths up to 64) in shared memory; each layer streams its weights through shared memory in 32-row
// K-chunks and runs nvcuda::wmma bf16 16x16x16 fragments with f32
// accumulators (each warp owns a 16-row x 128-column slice of the 64x256
// output); the epilogue adds the bias, applies tanh and writes the bf16
// activation back into the same 32 KB shared tile, so activations never
// leave the SM. The small heads (4 and 1 outputs) are SIMT dot products
// over the shared activations. Rows past n are zero in, masked out.
//
// Second entry, `logp_forward` (replaces pyflyt_tpu/ops/pallas_sgd.py::
// build_logp_forward): the same tile, obs loader and policy trunk, read
// from the packed PPO rows [obs | action | ...] of width `feat`, with an
// epilogue that turns the mean head into the Gaussian log-prob of the
// stored action, sum_j -0.5 ((a - mean)^2 / var + 2 log_std + log 2pi),
// log_std clipped to its range where one is set. It runs only the actor
// trunk: about 144 kFLOP per row, 37.7 GFLOP (38 us at the bf16 peak) over
// a 262,144-row PPO batch against 29 MB of rows read, so operations bound
// it too. Its rows past n are masked, never recomputed at a smaller tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int TILE_M = 64;   // rows per block
constexpr int HID = 256;     // trunk width
constexpr int K0 = 64;       // widest obs tile (row stride of s.x)
constexpr int KC = 32;       // weight rows per shared-memory chunk
constexpr int THREADS = 256;

struct Smem {
  __nv_bfloat16 x[TILE_M * K0];     // obs tile, bf16, zero-padded
  __nv_bfloat16 act[TILE_M * HID];  // trunk activations, bf16
  __nv_bfloat16 w[KC * HID];        // one weight K-chunk
  float stage[THREADS / 32][16 * 16];  // per-warp epilogue staging
};

}  // namespace

// Must match pyflyt_tpu_torch/ops/cuda_policy.py::_ForwardArgsC.
struct ForwardArgs {
  const float* obs;  // (n, obs_dim) f32
  const __nv_bfloat16* pi_w0;  // (obs_dim, 256)
  const float* pi_b0;
  const __nv_bfloat16* pi_w1;  // (256, 256)
  const float* pi_b1;
  const __nv_bfloat16* pi_hw;  // (256, act_dim)
  const float* pi_hb;
  const __nv_bfloat16* vf_w0;
  const float* vf_b0;
  const __nv_bfloat16* vf_w1;
  const float* vf_b1;
  const __nv_bfloat16* vf_hw;  // (256, 1)
  const float* vf_hb;
  float* mean;   // (n, act_dim) f32
  float* value;  // (n,) f32
  int n;
  int obs_dim;
  int act_dim;
};

namespace {

// s.act <- bf16(tanh(in @ W + b)); `in` is (64, k_pad) bf16 with leading
// dimension ld_in, W is (k_real, 256) bf16 row-major in device memory.
__device__ void dense_tanh(Smem& s, const __nv_bfloat16* in, int ld_in,
                           int k_pad, int k_real, const __nv_bfloat16* W,
                           const float* b) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rb = (warp % 4) * 16;   // this warp's 16 rows
  const int cb = (warp / 4) * 128;  // and its 128 columns
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < k_pad; k0 += KC) {
    __syncthreads();  // the previous chunk is consumed, `in` is written
    for (int idx = threadIdx.x; idx < KC * HID / 8; idx += THREADS) {
      const int r = idx / (HID / 8), c8 = idx % (HID / 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < k_real)
        v = reinterpret_cast<const uint4*>(W + static_cast<size_t>(k0 + r) * HID)[c8];
      reinterpret_cast<uint4*>(s.w + r * HID)[c8] = v;
    }
    __syncthreads();
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, in + rb * ld_in + k0 + kk, ld_in);
      for (int j = 0; j < 8; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, s.w + kk * HID + cb + j * 16, HID);
        wmma::mma_sync(acc[j], a, bf, acc[j]);
      }
    }
  }
  __syncthreads();  // every warp is done reading `in`, which may be s.act

  float* st = s.stage[warp];
  for (int j = 0; j < 8; ++j) {
    wmma::store_matrix_sync(st, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, col = cb + j * 16 + e % 16;
      s.act[(rb + r) * HID + col] = __float2bfloat16_rn(tanhf(st[e] + b[col]));
    }
    __syncwarp();
  }
  __syncthreads();
}

// out[row, j] = bf16(act[row]) . bf16(W[:, j]) + b[j] in f32, rows < n.
__device__ void head(const Smem& s, const __nv_bfloat16* W, const float* b,
                     int outs, float* out, int row0, int n) {
  for (int o = threadIdx.x; o < TILE_M * outs; o += THREADS) {
    const int r = o / outs, j = o % outs;
    if (row0 + r >= n) continue;
    float acc = 0.f;
    const __nv_bfloat16* a = s.act + r * HID;
    for (int k = 0; k < HID; ++k)
      acc = fmaf(__bfloat162float(a[k]), __bfloat162float(W[k * outs + j]), acc);
    out[static_cast<size_t>(row0 + r) * outs + j] = acc + b[j];
  }
}

// The obs width padded for the first layer: a whole number of K-chunks.
__host__ __device__ constexpr int padded_obs(int obs_dim) { return (obs_dim + KC - 1) / KC * KC; }

// s.x <- bf16 obs of rows row0.. (row stride ld), zero past n and obs_dim,
// columns 0..padded_obs(obs_dim) of the K0-wide tile.
__device__ void load_obs(Smem& s, const float* src, int ld, int n, int obs_dim, int row0) {
  const int k_pad = padded_obs(obs_dim);
  for (int idx = threadIdx.x; idx < TILE_M * k_pad; idx += THREADS) {
    const int r = idx / k_pad, c = idx % k_pad;
    float v = 0.f;
    if (row0 + r < n && c < obs_dim) v = src[static_cast<size_t>(row0 + r) * ld + c];
    s.x[r * K0 + c] = __float2bfloat16_rn(v);
  }
}

__global__ void __launch_bounds__(THREADS) policy_value_kernel(ForwardArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int row0 = blockIdx.x * TILE_M;

  load_obs(s, p.obs, p.obs_dim, p.n, p.obs_dim, row0);
  // actor: trunk, then the mean head
  dense_tanh(s, s.x, K0, padded_obs(p.obs_dim), p.obs_dim, p.pi_w0, p.pi_b0);
  dense_tanh(s, s.act, HID, HID, HID, p.pi_w1, p.pi_b1);
  head(s, p.pi_hw, p.pi_hb, p.act_dim, p.mean, row0, p.n);
  __syncthreads();  // the head has read s.act before the critic rewrites it
  // critic: trunk, then the value head
  dense_tanh(s, s.x, K0, padded_obs(p.obs_dim), p.obs_dim, p.vf_w0, p.vf_b0);
  dense_tanh(s, s.act, HID, HID, HID, p.vf_w1, p.vf_b1);
  head(s, p.vf_hw, p.vf_hb, 1, p.value, row0, p.n);
}

}  // namespace

// Must match pyflyt_tpu_torch/ops/cuda_sgd.py::_LogpArgsC.
struct LogpArgs {
  const float* rows;  // (n, feat) f32: [obs | action | ...]
  const __nv_bfloat16* w0;  // (obs_dim, 256)
  const float* b0;
  const __nv_bfloat16* w1;  // (256, 256)
  const float* b1;
  const __nv_bfloat16* hw;  // (256, act_dim)
  const float* hb;
  const float* log_std;  // (act_dim,) f32, unclipped
  float* out;            // (n,) f32
  int n;
  int feat;
  int obs_dim;
  int act_dim;
  int has_range;
  float ls_lo;
  float ls_hi;
};

namespace {

constexpr int MAX_ACT = 8;
constexpr float LOG2PI = 1.8378770664093453f;  // log(2 pi)

__global__ void __launch_bounds__(THREADS) logp_kernel(LogpArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int row0 = blockIdx.x * TILE_M;

  load_obs(s, p.rows, p.feat, p.n, p.obs_dim, row0);
  dense_tanh(s, s.x, K0, padded_obs(p.obs_dim), p.obs_dim, p.w0, p.b0);
  dense_tanh(s, s.act, HID, HID, HID, p.w1, p.b1);
  // the mean head into the (now idle) staging area: 64 x act_dim floats
  float* mean = &s.stage[0][0];
  for (int o = threadIdx.x; o < TILE_M * p.act_dim; o += THREADS) {
    const int r = o / p.act_dim, j = o % p.act_dim;
    float acc = 0.f;
    const __nv_bfloat16* a = s.act + r * HID;
    for (int k = 0; k < HID; ++k)
      acc = fmaf(__bfloat162float(a[k]), __bfloat162float(p.hw[k * p.act_dim + j]), acc);
    mean[o] = acc + p.hb[j];
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < TILE_M && row0 + r < p.n) {
    const float* row = p.rows + static_cast<size_t>(row0 + r) * p.feat;
    float logp = 0.f;
    for (int j = 0; j < p.act_dim; ++j) {
      float ls = p.log_std[j];
      if (p.has_range) ls = fminf(fmaxf(ls, p.ls_lo), p.ls_hi);
      const float var = expf(2.f * ls);
      const float diff = row[p.obs_dim + j] - mean[r * p.act_dim + j];
      logp += -0.5f * (diff * diff / var + 2.f * ls + LOG2PI);
    }
    p.out[row0 + r] = logp;
  }
}

// above 48 KB of dynamic shared memory needs the opt-in, once per device
template <typename K>
cudaError_t allow_smem(K kernel, int* attr_device, int smem) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess || device == *attr_device) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) *attr_device = device;
  return e;
}

}  // namespace

// Shapes are checked by the Python wrapper: obs_dim <= 64, trunks 2 x 256.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int policy_value_forward(const ForwardArgs* args, void* stream) {
  if (args->n <= 0 || args->obs_dim > K0 || args->obs_dim <= 0 || args->act_dim <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static int attr_device = -1;
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t e = allow_smem(policy_value_kernel, &attr_device, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((args->n + TILE_M - 1) / TILE_M);
  policy_value_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// Shapes are checked by the Python wrapper: obs_dim <= 64, the actor trunk
// 2 x 256, act_dim <= 8, obs_dim + act_dim <= feat.
extern "C" int logp_forward(const LogpArgs* args, void* stream) {
  if (args->n <= 0 || args->obs_dim > K0 || args->obs_dim <= 0 || args->act_dim <= 0 ||
      args->act_dim > MAX_ACT || args->obs_dim + args->act_dim > args->feat)
    return static_cast<int>(cudaErrorInvalidValue);
  static int attr_device = -1;
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t e = allow_smem(logp_kernel, &attr_device, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((args->n + TILE_M - 1) / TILE_M);
  logp_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
