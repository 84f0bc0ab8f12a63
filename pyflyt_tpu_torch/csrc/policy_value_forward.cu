// Fused actor-critic forward (K4) and the PPO log-prob (K3): 2 x 256 tanh
// trunks and their heads on Hopper's wgmma, through the warpgroup MLP of
// policy_mlp.cuh (its top comment describes the block).
//
// `policy_value_forward` replaces pyflyt_tpu/ops/pallas_policy.py::
// build_policy_value_forward, with its arithmetic (pallas_sgd.py::_mm):
// every matmul takes bf16 inputs and accumulates in f32; bias and tanh are
// f32 (an accurate tanhf); a trunk activation is rounded to bf16 when the
// next layer reads it, as the Pallas kernel's `_mm` casts; the heads take
// the bf16 activations and bf16 head weights, summed in f32.
//
// What bounds it on an H100: about 286 kFLOP per row (2 x (21x256 +
// 256x256) MACs plus the heads), 2.34 GFLOP at 8192 rows, about 2.4 us at
// the 989 TFLOP/s bf16 tensor-core peak; the bytes (obs, bf16 weights,
// outputs) are under 1.2 MB, about 0.35 us. So the tensor cores bound it,
// and at a few thousand rows the chain of one tile (the weights' first
// arrival, two layers, their epilogues, the head) sets its time. Grid
// (blocks, 2): blockIdx.y picks the trunk (0 the actor -> mean, 1 the
// critic -> value), half the SMs each; each block keeps its trunk resident
// and walks tiles blockIdx.x + k gridDim.x.
//
// `logp_forward` replaces pyflyt_tpu/ops/pallas_sgd.py::build_logp_forward:
// the actor trunk over the packed PPO rows [obs | action | ...] of width
// `feat`, with an epilogue that turns the mean head into the Gaussian
// log-prob of the stored action, sum_j -0.5 ((a - mean)^2 / var + 2
// log_std + log 2pi), log_std clipped to its range where one is set. About
// 144 kFLOP per row: 37.7 GFLOP (38 us at the bf16 peak) over a 262,144-row
// PPO batch against 29 MB of rows read (9 us at 3.35 TB/s), so operations
// bound it. Persistent: one block an SM loads the actor trunk once and
// walks every SM-count-th tile.
#include "policy_mlp.cuh"

using pmlp::CONSUMER_REGS;
using pmlp::HEAD_N;
using pmlp::MAX_OBS;
using pmlp::PRODUCER_REGS;
using pmlp::SMEM_BYTES;
using pmlp::THREADS;
using pmlp::TILE_M;

// Must match pyflyt_tpu_torch/ops/cuda_policy.py::_ForwardArgsC. Each
// weight pointer is a region of its trunk's image (cuda_policy.pack_trunk).
struct ForwardArgs {
  const float* obs;  // (n, obs_dim) f32
  const void* pi_w0;  // layer 0, swizzled
  const float* pi_b0;
  const void* pi_w1;  // layer 1, swizzled
  const float* pi_b1;
  const void* pi_hw;  // head, swizzled, 8 outputs
  const float* pi_hb;  // (8,) zero past act_dim
  const void* vf_w0;
  const float* vf_b0;
  const void* vf_w1;
  const float* vf_b1;
  const void* vf_hw;
  const float* vf_hb;
  float* mean;   // (n, act_dim) f32
  float* value;  // (n,) f32
  int n;
  int obs_dim;
  int act_dim;
};

// Must match pyflyt_tpu_torch/ops/cuda_sgd.py::_LogpArgsC.
struct LogpArgs {
  const float* rows;  // (n, feat) f32: [obs | action | ...]
  const void* w0;  // the actor's image, as ForwardArgs
  const float* b0;
  const void* w1;
  const float* b1;
  const void* hw;
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

constexpr float LOG2PI = 1.8378770664093453f;  // log(2 pi)

// out[row, j] = head + hb[j] for j < outs (the mean, or the value with outs 1)
struct DenseHead {
  float* out;
  int outs;
  int n;
  __device__ void operator()(const float (&h)[4], const float* hb, int row0) const {
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r = row0 + 16 * (t / 32) + lane / 4, c = 2 * (lane % 4);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r + 8 * hh;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (row < n && c + e < outs) out[static_cast<size_t>(row) * outs + c + e] = h[2 * hh + e] + hb[c + e];
    }
  }
};

// out[row] = the Gaussian log-prob of the row's stored action: each thread
// sums its two columns, a quad of lanes the row's eight
struct LogpHead {
  LogpArgs p;
  __device__ void operator()(const float (&h)[4], const float* hb, int row0) const {
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r = row0 + 16 * (t / 32) + lane / 4, c = 2 * (lane % 4);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r + 8 * hh;
      float logp = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = c + e;
        if (row < p.n && j < p.act_dim) {
          float ls = p.log_std[j];
          if (p.has_range) ls = fminf(fmaxf(ls, p.ls_lo), p.ls_hi);
          const float var = expf(2.f * ls);
          const float diff = p.rows[static_cast<size_t>(row) * p.feat + p.obs_dim + j] - (h[2 * hh + e] + hb[j]);
          logp += -0.5f * (diff * diff / var + 2.f * ls + LOG2PI);
        }
      }
      logp += __shfl_xor_sync(0xffffffffu, logp, 1);
      logp += __shfl_xor_sync(0xffffffffu, logp, 2);
      if (lane % 4 == 0 && row < p.n) p.out[row] = logp;
    }
  }
};

__global__ void __launch_bounds__(THREADS, 1) policy_value_kernel(const ForwardArgs p) {
  const bool critic = blockIdx.y != 0;
  const pmlp::TrunkSrc w = critic ? pmlp::TrunkSrc{p.vf_w0, p.vf_b0, p.vf_w1, p.vf_b1, p.vf_hw, p.vf_hb}
                                  : pmlp::TrunkSrc{p.pi_w0, p.pi_b0, p.pi_w1, p.pi_b1, p.pi_hw, p.pi_hb};
  pmlp::mlp_block(w, p.obs, p.obs_dim, p.n, p.obs_dim,
                  DenseHead{critic ? p.value : p.mean, critic ? 1 : p.act_dim, p.n});
}

__global__ void __launch_bounds__(THREADS, 1) logp_kernel(const LogpArgs p) {
  const pmlp::TrunkSrc w{p.w0, p.b0, p.w1, p.b1, p.hw, p.hb};
  pmlp::mlp_block(w, p.rows, p.feat, p.n, p.obs_dim, LogpHead{p});
}

}  // namespace

// Shapes are checked by the Python wrapper: obs_dim <= 64, act_dim <= 8,
// trunks 2 x 256, weights as cuda_policy.pack_trunk's image.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int policy_value_forward(const ForwardArgs* args, void* stream) {
  if (args->n <= 0 || args->obs_dim > MAX_OBS || args->obs_dim <= 0 || args->act_dim <= 0 ||
      args->act_dim > HEAD_N)
    return static_cast<int>(cudaErrorInvalidValue);
  static int attr_device = -1, sms = 0;
  cudaError_t e = pmlp::prepare_launch(policy_value_kernel, &attr_device, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (args->n + TILE_M - 1) / TILE_M;
  const int per_trunk = sms / 2 > 1 ? sms / 2 : 1;
  const dim3 grid(tiles < per_trunk ? tiles : per_trunk, 2);
  policy_value_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// Shapes are checked by the Python wrapper: obs_dim <= 64, the actor trunk
// 2 x 256, act_dim <= 8, obs_dim + act_dim <= feat.
extern "C" int logp_forward(const LogpArgs* args, void* stream) {
  if (args->n <= 0 || args->obs_dim > MAX_OBS || args->obs_dim <= 0 || args->act_dim <= 0 ||
      args->act_dim > HEAD_N || args->obs_dim + args->act_dim > args->feat)
    return static_cast<int>(cudaErrorInvalidValue);
  static int attr_device = -1, sms = 0;
  cudaError_t e = pmlp::prepare_launch(logp_kernel, &attr_device, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (args->n + TILE_M - 1) / TILE_M;
  const dim3 grid(tiles < sms ? tiles : sms);
  logp_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// The launch's shape, for the record: threads a block, dynamic shared
// memory a block, registers a thread of a consumer and of the producer
// warpgroup after setmaxnreg.
extern "C" void policy_mlp_launch_info(int* out) {
  out[0] = THREADS;
  out[1] = SMEM_BYTES;
  out[2] = CONSUMER_REGS;
  out[3] = PRODUCER_REGS;
}
