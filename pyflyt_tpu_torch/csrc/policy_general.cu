// The general family's actor-critic forward (K4g) and log-prob of stored
// actions (K3g): every trunk, obs and action width the Pallas builders
// take and the wide (policy_value_forward.cu) and narrow (policy_narrow.cu)
// kernels do not, a linear policy (no tanh layer) included.
//
// Replaces pyflyt_tpu/ops/pallas_policy.py::build_policy_value_forward and
// pyflyt_tpu/ops/pallas_sgd.py::build_logp_forward at those trunks, with
// their arithmetic: bf16 matmul inputs rounded to nearest even, f32
// accumulation, f32 bias and tanh, the log-prob and the optional log_std
// clamp in f32.
//
// What bounds it on an H100: at 8192 rows of obs 21 through two 3 x 256
// trunks the forward is about 4.5 GFLOP of bf16 MMA (4.5 us at 989
// TFLOP/s) against 1.9 MB of obs, weights and outputs (0.6 us at 3.35
// TB/s); K3g over 262,144 rows of the actor about 72 GFLOP (0.073 ms)
// against 29 MB (0.009 ms): operations bound both.
//
// Three routes, chosen by the wrapper from the widths
// (ops/cuda_general.py::resident_tile, cluster_plan):
//  - resident (general_resident_forward, general_resident_logp;
//    policy_resident.cuh): one launch a call. A block takes a tile of rows
//    of one trunk through every layer, the activations bf16 in shared
//    memory, the weights a bf16 image streamed by bulk copies through a
//    ring, K3g's log-prob in the same kernel. Every trunk whose widest
//    width fits a block's shared memory takes it;
//  - cluster (general_cluster_forward, general_cluster_logp;
//    policy_cluster.cuh): the same, one launch a call, with a tile shared
//    by a cluster of 2, 4 or 8 blocks, each holding its share of every
//    layer's output; every wider trunk whose share fits a block;
//  - per layer (general_policy_value_forward, general_logp_forward), for
//    the rest (deeper than 16 layers, or wider than a cluster of 8 holds):
//    the obs rounded to bf16 once, then one launch of policy_general.cuh's
//    TMA-fed wgmma GEMM a layer a trunk on the trunk's image (W_l bf16
//    (in x out), f32 biases: ops/cuda_general.py::pack_trunk), the
//    tanh layers' bf16 outputs in a workspace the wrapper sizes per call
//    (two row buffers of the widest layer, in turn), the heads written
//    straight into the outputs; K3g then one thread a row for the log-prob
//    (general::row_logp).
// Every route runs each output's k16 steps in order from 0 on the same
// bf16 inputs as K2g's forward (fused_epoch_general.cu), and wgmma's chain
// gives mma.sync's bits, so K3g's log-probs are K2g's forward bit for bit
// on any.
#include "policy_cluster.cuh"
#include "policy_general.cuh"
#include "policy_resident.cuh"

// Must match ops/cuda_general.py::_ForwardArgsC.
struct GeneralForwardArgs {
  const float* obs;         // (n, obs_dim) f32
  const uint8_t* pi_image;  // the actor's weights (ops/cuda_general.py::pack_trunk)
  const uint8_t* vf_image;  // the critic's
  __nv_bfloat16* ws;        // bf16: the obs rounded (n x pad32(obs_dim)) at ws, the tanh layers' outputs at ws + out[l]
  float* mean;              // (n, act_dim)
  float* value;             // (n,)
  GeneralTrunk pi;
  GeneralTrunk vf;
  long long pi_bytes;
  long long vf_bytes;
  long long ws_elems;
  int n;
  int obs_dim;
  int act_dim;
};

// Must match ops/cuda_general.py::_LogpArgsC.
struct GeneralLogpArgs {
  const float* rows;     // (n, feat) f32: [obs | action | ...]
  const uint8_t* image;  // the actor's weights
  const float* log_std;  // (act_dim,)
  __nv_bfloat16* ws;     // bf16: the obs rounded at ws, the tanh layers' outputs at ws + out[l]
  float* mean;           // (n, act_dim) workspace
  float* out;            // (n,)
  GeneralTrunk pi;
  long long image_bytes;
  long long ws_elems;
  int n;
  int feat;
  int obs_dim;
  int act_dim;
  int has_range;
  float ls_lo;
  float ls_hi;
};

namespace {

constexpr int LOGP_THREADS = 256;

// whether a trunk's tanh outputs lie past the rounded obs and inside the
// workspace
bool ws_ok(const GeneralTrunk& T, int rows, int obs_dim, long long ws_elems) {
  const long long obs_end = static_cast<long long>(rows) * general::pad32(obs_dim);
  if (obs_end > ws_elems) return false;
  for (int l = 0; l < T.depth; ++l)
    if (T.out[l] < obs_end || T.out[l] + static_cast<long long>(rows) * general::pad32(T.dims[l + 1]) > ws_elems)
      return false;
  return true;
}

bool image_ok(const uint8_t* image) { return image != nullptr && (reinterpret_cast<uintptr_t>(image) & 15) == 0; }

__global__ void __launch_bounds__(LOGP_THREADS) logp_kernel(const __grid_constant__ GeneralLogpArgs p) {
  const long long r = static_cast<long long>(blockIdx.x) * LOGP_THREADS + threadIdx.x;
  if (r >= p.n) return;
  p.out[r] = general::row_logp(p.rows + r * p.feat + p.obs_dim, p.mean + r * p.act_dim, p.log_std, p.act_dim,
                               p.has_range, p.ls_lo, p.ls_hi);
}

}  // namespace

// K4g's per-layer route: the obs rounded to bf16 once, then the actor's
// trunk and head and the critic's, one GEMM launch a layer on `stream`.
// Returns the first CUDA error of a launch (0 = every kernel launched), or
// cudaErrorInvalidValue outside the layouts.
extern "C" int general_policy_value_forward(const GeneralForwardArgs* args, void* stream) {
  const GeneralForwardArgs& p = *args;
  if (p.n <= 0 || p.obs_dim <= 0 || p.act_dim <= 0 || p.ws == nullptr || !image_ok(p.pi_image) ||
      !image_ok(p.vf_image) || !general::trunk_ok(p.pi, p.obs_dim, p.act_dim, p.pi_bytes) ||
      !general::trunk_ok(p.vf, p.obs_dim, 1, p.vf_bytes) || !ws_ok(p.pi, p.n, p.obs_dim, p.ws_elems) ||
      !ws_ok(p.vf, p.n, p.obs_dim, p.ws_elems))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = general::round_rows(p.obs, p.obs_dim, p.n, p.obs_dim, p.ws, general::pad32(p.obs_dim), st);
  if (e == cudaSuccess) e = general::trunk_forward(p.pi, p.pi_image, p.ws, p.n, p.ws, p.mean, st);
  if (e == cudaSuccess) e = general::trunk_forward(p.vf, p.vf_image, p.ws, p.n, p.ws, p.value, st);
  return static_cast<int>(e);
}

// K3g's per-layer route: the rows' obs columns rounded to bf16, the
// actor's forward, then one thread a row for the log-prob of its stored
// action.
extern "C" int general_logp_forward(const GeneralLogpArgs* args, void* stream) {
  const GeneralLogpArgs& p = *args;
  if (p.n <= 0 || p.obs_dim <= 0 || p.act_dim <= 0 || p.obs_dim + p.act_dim > p.feat || p.ws == nullptr ||
      !image_ok(p.image) || !general::trunk_ok(p.pi, p.obs_dim, p.act_dim, p.image_bytes) ||
      !ws_ok(p.pi, p.n, p.obs_dim, p.ws_elems))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = general::round_rows(p.rows, p.feat, p.n, p.obs_dim, p.ws, general::pad32(p.obs_dim), st);
  if (e == cudaSuccess) e = general::trunk_forward(p.pi, p.image, p.ws, p.n, p.ws, p.mean, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  logp_kernel<<<(p.n + LOGP_THREADS - 1) / LOGP_THREADS, LOGP_THREADS, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// Whether the wrapper's resident launch is one the kernel takes: K4g the
// actor (act_dim outputs) and the critic (1), K3g the actor on rows of ld
// >= obs_dim + act_dim floats; the tile and shared memory in range.
bool resident_ok(const ResidentArgs& p, bool logp) {
  const int trunks = logp ? 1 : 2;
  if (p.n <= 0 || p.obs_dim <= 0 || p.act_dim <= 0 || p.x == nullptr || (p.tile != 128 && p.tile != 64) ||
      p.width <= 0 || p.width % resident::KC != 0 ||
      resident::smem_bytes(p.tile, p.width, p.act_dim, logp) > resident::SMEM_LIMIT ||
      p.ld < (logp ? p.obs_dim + p.act_dim : p.obs_dim) || (logp && p.log_std == nullptr))
    return false;
  for (int t = 0; t < trunks; ++t) {
    if (p.image[t] == nullptr || p.out[t] == nullptr || (reinterpret_cast<uintptr_t>(p.image[t]) & 15) != 0 ||
        !resident::trunk_ok(p.trunk[t], p.obs_dim, t == 0 ? p.act_dim : 1, p.width))
      return false;
  }
  return true;
}

}  // namespace

// K4g's resident route: both trunks in one launch (blockIdx.y), each block
// a tile of rows through every layer. Returns the launch's CUDA error (0 =
// launched), or cudaErrorInvalidValue outside the layouts.
extern "C" int general_resident_forward(const ResidentArgs* args, void* stream) {
  if (!resident_ok(*args, false)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(resident::launch_any<false>(*args, static_cast<cudaStream_t>(stream)));
}

// K3g's resident route: the actor and the log-prob in one persistent launch.
extern "C" int general_resident_logp(const ResidentArgs* args, void* stream) {
  if (!resident_ok(*args, true)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(resident::launch_any<true>(*args, static_cast<cudaStream_t>(stream)));
}

namespace {

// Whether the wrapper's cluster launch is one the kernel takes: as
// resident_ok, with `width` the columns a block holds (the obs and rank 0's
// share of each tanh layer at clusters of C), C one of 2, 4 and 8 and the
// cluster kernel's shared memory in range.
bool cluster_ok(const ResidentArgs& p, int C, bool logp) {
  const int trunks = logp ? 1 : 2;
  if ((C != 2 && C != 4 && C != cluster::MAX_CLUSTER) || p.n <= 0 || p.obs_dim <= 0 || p.act_dim <= 0 ||
      p.x == nullptr || p.tile != cluster::TILE_ROWS || p.width <= 0 || p.width % resident::KC != 0 ||
      cluster::smem_bytes(p.tile, p.width, p.act_dim, logp) > resident::SMEM_LIMIT ||
      p.ld < (logp ? p.obs_dim + p.act_dim : p.obs_dim) || (logp && p.log_std == nullptr))
    return false;
  for (int t = 0; t < trunks; ++t) {
    if (p.image[t] == nullptr || p.out[t] == nullptr || (reinterpret_cast<uintptr_t>(p.image[t]) & 15) != 0 ||
        !cluster::trunk_ok(p.trunk[t], p.obs_dim, t == 0 ? p.act_dim : 1, p.width, C))
      return false;
  }
  return true;
}

}  // namespace

// K4g's cluster route: both trunks in one launch (blockIdx.y), each cluster
// of C blocks a tile of rows through every layer. Returns the launch's CUDA
// error (0 = launched), or cudaErrorInvalidValue outside the layouts.
extern "C" int general_cluster_forward(const ResidentArgs* args, int C, void* stream) {
  if (!cluster_ok(*args, C, false)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cluster::launch<cluster::TILE_ROWS, false>(*args, C, static_cast<cudaStream_t>(stream)));
}

// K3g's cluster route: the actor and the log-prob in one launch of
// persistent clusters.
extern "C" int general_cluster_logp(const ResidentArgs* args, int C, void* stream) {
  if (!cluster_ok(*args, C, true)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cluster::launch<cluster::TILE_ROWS, true>(*args, C, static_cast<cudaStream_t>(stream)));
}

