// The actor-critic forward (K4n) and the PPO log-prob (K3n) for narrow,
// deep tanh trunks: 1 to 4 layers a trunk, each at most 128 wide, obs <= 64,
// act <= 8 (policy_narrow.cuh's tile MLP). The 2 x 256 trunks keep their
// wgmma kernels (policy_value_forward.cu).
//
// `narrow_policy_value_forward` replaces pyflyt_tpu/ops/pallas_policy.py::
// build_policy_value_forward at those trunks, with its arithmetic: every
// matmul takes bf16 inputs (round to nearest even) and accumulates in f32;
// bias and tanh are f32 (an accurate tanhf); an activation is rounded to
// bf16 where the next layer reads it.
//
// `narrow_logp_forward` replaces pyflyt_tpu/ops/pallas_sgd.py::
// build_logp_forward: the actor trunk over packed PPO rows [obs | action |
// ...] of width `feat`, the head turned into the Gaussian log-prob of the
// stored action, sum_j -0.5 ((a - mean)^2 / var + 2 log_std + log 2 pi),
// log_std clipped to its range where one is set.
//
// What bounds them on an H100: at the trajectory network (obs 19, act 4,
// 64-64-32-32 trunks) a row is about 34 kFLOP of bf16 MMA over both trunks,
// so 2048 rows are 69 MFLOP (0.07 us at 989 TFLOP/s) against about 0.2 MB
// of obs, weights and outputs (0.06 us at 3.35 TB/s): the launch, the
// weight image's copy into shared memory and the chain of 5 dependent
// layers set the time. The design keeps that chain short: one block a
// 64-row tile and trunk (4 warps of 16 rows), the trunk's image resident,
// every activation in registers. Blocks walk tiles blockIdx.x + k gridDim.x,
// so a large batch copies each image once an SM.
#include "policy_narrow.cuh"

using narrow::MAX_ACT;
using narrow::MAX_KC;
using narrow::MAX_NT;
using narrow::MAX_OBS;
using narrow::THREADS;
using narrow::TILE_ROWS;

// Must match pyflyt_tpu_torch/ops/cuda_narrow.py::_ForwardArgsC.
struct NarrowForwardArgs {
  const float* obs;          // (n, obs_dim) f32
  const uint8_t* pi_image;   // the actor's image (cuda_narrow.pack_trunk)
  const uint8_t* vf_image;   // the critic's
  float* mean;               // (n, act_dim) f32
  float* value;              // (n,) f32
  NarrowTrunk pi;
  NarrowTrunk vf;
  int n;
  int obs_dim;
  int act_dim;
};

// Must match pyflyt_tpu_torch/ops/cuda_narrow.py::_LogpArgsC.
struct NarrowLogpArgs {
  const float* rows;      // (n, feat) f32: [obs | action | ...]
  const uint8_t* image;   // the actor's image
  const float* log_std;   // (act_dim,) f32, unclipped
  float* out;             // (n,) f32
  NarrowTrunk pi;
  int n;
  int feat;
  int obs_dim;
  int act_dim;
  int has_range;
  float ls_lo;
  float ls_hi;
};

namespace {

__global__ void __launch_bounds__(THREADS) narrow_forward_kernel(const __grid_constant__ NarrowForwardArgs p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const bool critic = blockIdx.y != 0;
  const NarrowTrunk& T = critic ? p.vf : p.pi;
  narrow::load_image(smem, critic ? p.vf_image : p.pi_image, T.bytes);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tiles = (p.n + TILE_ROWS - 1) / TILE_ROWS;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * TILE_ROWS + 16 * warp;
    uint32_t a[MAX_KC][4];
    float acc[MAX_NT][4];
    narrow::load_rows(a, p.obs, p.obs_dim, p.obs_dim, row0, p.n, T.k[0]);
    narrow::trunk_forward(acc, a, smem, T, nullptr);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + g + 8 * hh;
      if (row >= p.n) continue;
      if (critic) {
        if (t == 0) p.value[row] = acc[0][2 * hh];
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (2 * t + e < p.act_dim) p.mean[static_cast<size_t>(row) * p.act_dim + 2 * t + e] = acc[0][2 * hh + e];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) narrow_logp_kernel(const __grid_constant__ NarrowLogpArgs p) {
  extern __shared__ __align__(16) uint8_t smem[];
  narrow::load_image(smem, p.image, p.pi.bytes);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tiles = (p.n + TILE_ROWS - 1) / TILE_ROWS;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * TILE_ROWS + 16 * warp;
    uint32_t a[MAX_KC][4];
    float acc[MAX_NT][4];
    narrow::load_rows(a, p.rows, p.feat, p.obs_dim, row0, p.n, p.pi.k[0]);
    narrow::trunk_forward(acc, a, smem, p.pi, nullptr);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + g + 8 * hh;
      float logp = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * t + e;
        if (row < p.n && j < p.act_dim) {
          float ls = p.log_std[j];
          if (p.has_range) ls = fminf(fmaxf(ls, p.ls_lo), p.ls_hi);
          const float var = expf(2.f * ls);
          const float diff = p.rows[static_cast<size_t>(row) * p.feat + p.obs_dim + j] - acc[0][2 * hh + e];
          logp += -0.5f * (diff * diff / var + 2.f * ls + narrow::LOG2PI);
        }
      }
      logp += __shfl_xor_sync(0xffffffffu, logp, 1);
      logp += __shfl_xor_sync(0xffffffffu, logp, 2);
      if (t == 0 && row < p.n) p.out[row] = logp;
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int sm_count() {
  static int device_seen = -1, sms = 0;
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (device != device_seen) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
    device_seen = device;
  }
  return sms;
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/cuda_narrow.py) and again
// here. Returns the launch's CUDA error (0 = launched).
extern "C" int narrow_policy_value_forward(const NarrowForwardArgs* args, void* stream) {
  const NarrowForwardArgs& p = *args;
  if (p.n <= 0 || p.obs_dim <= 0 || p.obs_dim > MAX_OBS || p.act_dim <= 0 || p.act_dim > MAX_ACT ||
      !narrow::trunk_ok(p.pi, p.obs_dim, p.act_dim) || !narrow::trunk_ok(p.vf, p.obs_dim, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = p.pi.bytes > p.vf.bytes ? p.pi.bytes : p.vf.bytes;
  cudaError_t e = allow_smem(narrow_forward_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (p.n + TILE_ROWS - 1) / TILE_ROWS, sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const dim3 grid(tiles < sms ? tiles : sms, 2);
  narrow_forward_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int narrow_logp_forward(const NarrowLogpArgs* args, void* stream) {
  const NarrowLogpArgs& p = *args;
  if (p.n <= 0 || p.obs_dim <= 0 || p.obs_dim > MAX_OBS || p.act_dim <= 0 || p.act_dim > MAX_ACT ||
      p.obs_dim + p.act_dim > p.feat || !narrow::trunk_ok(p.pi, p.obs_dim, p.act_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem(narrow_logp_kernel, p.pi.bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (p.n + TILE_ROWS - 1) / TILE_ROWS, sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int blocks = tiles < 4 * sms ? tiles : 4 * sms;  // a few blocks an SM; each copies the image once
  narrow_logp_kernel<<<blocks, THREADS, p.pi.bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
