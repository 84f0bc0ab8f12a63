// One full QuadX-Hover agent step for a batch of envs, one thread an env.
//
// Replaces pyflyt_tpu/ops/pallas_quadx.py::packed_hover_step (the
// env-fused variant of _build_kernel), modes 0, 7 and 8, ENU:
// `inner_steps` aviary steps of `ratio` physics iterations each (ang-vel
// PID, mode 7's position cascade in front of it, or direct PWM at
// iteration 0; saturation rescale; throttle lag + Philox motor
// noise; wrench from the lagged read; semi-implicit Euler; detection-grade
// ground contact), then the hover reward, termination, truncation and the
// done-freeze.
//
// What bounds it on an H100: each env reads 55 of its 56 f32 rows once
// (not the reward row, re-armed below) and writes all 56 (444 B), about
// 2 kFLOP of f32 work per env, so at 8192 envs the bytes (3.64 MB,
// ~1.09 us at 3.35 TB/s; mode 7 reads 73 of 80 rows, 5.0 MB, 1.5 us) bound it, and each thread's dependent chain (3
// aviary steps x 2 physics iterations: the throttle lag, the wrench, the
// rotation, the integration and the exponential-map quaternion step in a
// row) costs more than either.
//
// Design: state is SoA (ROWS, N), so a warp's load of one row is one
// coalesced transaction; the whole agent step runs in registers with one
// read and one write per row; the vehicle and task constants arrive as one
// POD struct passed by value as a __grid_constant__; the mode, the noise
// and the sparse reward are template parameters. Blocks are 64 threads,
// so 8192 envs spread over 128 of the 132 SMs. The per-iteration pieces
// (row layout, Lane, control, physics) are quadx_lane.cuh's, shared with
// quadx_step.cu and quadx_waypoints_step.cu; this file instantiates them
// for modes 0, 7 and 8, ENU, no wind (mode 7 on the 80-row layout: the
// cascade's 18 registers loaded from rows 56-73 and stored back, rows
// 74-79 written zero, as quadx_step.cu does), and shortens the chain in
// three ways:
// the view is computed only on an aviary step's last physics iteration,
// whose view is the one read (by the next aviary step's controller and
// the task update); the done-freeze leaves the aviary loop (termination
// and truncation never clear, so a lane done before an aviary step keeps
// its registers untouched, with no copy of the lane and no select); the
// divisions by the mass, the inertia and the control period are
// multiplications by reciprocals taken once a launch. Groups of 2 and 4 lanes an env measured slower (PERF.md
// section 6). Any N is allowed: the last block masks its tail.
//
// Semantics kept from the Pallas kernel: the reward is re-armed to -0.1
// every agent step and overwritten with -100 on a fatal event; truncation
// uses the step count before the increment; the step count stays f32; a
// lane that was done before an aviary step keeps its snapshot; contact is
// detection-grade (lift out of the ground, stop downward velocity).
#include <cuda_runtime.h>
#include <curand_kernel.h>

#include <climits>
#include <cstddef>

#include "quadx_lane.cuh"

namespace {

// Env rows of the hover-fused layout (pallas_quadx.py:207-213); the drone
// rows 0-49 are quadx_lane's.
constexpr int RWD = 50, TERM = 51, TRUNC = 52, COLL = 53, OOB = 54, STEP = 55;
constexpr int THREADS = 64;  // per block

}  // namespace

// Must match pyflyt_tpu_torch/ops/cuda_quadx.py::HoverConsts field by field
// (tests/test_torch_package.py holds the two layouts equal).
struct HoverConsts {
  float mass;
  float inertia[3];
  float motor_map[16];  // (4, 4) row-major: pwm[m] = sum_j map[m][j] cmd[j]
  float mpos_x[4];
  float mpos_y[4];
  float thrust_coef[4];
  float torque_coef[4];
  float lag[4];  // physics_period / tau
  float max_rpm[4];
  float noise_ratio[4];
  float drag_xyz[3];
  float drag_pqr;
  float kp[3];
  float ki[3];
  float kd[3];
  float lim[3];
  float period;  // control period (PID)
  float dt;      // physics period
  float min_pwm;
  float max_pwm;
  float half_ext[3];
  float dome2;
  float max_steps;
  int inner_steps;
  int ratio;
  // mode 7: the position cascade's banks, last so that modes 0 and 8 read
  // every other field at the offsets they always had
  float lp_kp[2];
  float lp_ki[2];
  float lp_kd[2];
  float lp_lim[2];
  float lv_kp[2];
  float lv_ki[2];
  float lv_kd[2];
  float lv_lim[2];
  float ap_kp[3];
  float ap_ki[3];
  float ap_kd[3];
  float ap_lim[3];
  float zp_kp[1];
  float zp_ki[1];
  float zp_kd[1];
  float zp_lim[1];
  float zv_kp[1];
  float zv_ki[1];
  float zv_kd[1];
  float zv_lim[1];
};

namespace {

using quadx_lane::Lane;

// The drone registers plus the hover task's env registers.
struct HoverLane {
  Lane d;
  float rwd, term, trunc, coll, oob;
};

template <int MODE, bool NOISY, bool SPARSE>
__global__ void __launch_bounds__(THREADS)
    hover_step_kernel(const float* __restrict__ in, float* __restrict__ out, int n,
                      const long long* __restrict__ seed, const __grid_constant__ HoverConsts c) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;  // ragged edge
  const size_t ld = static_cast<size_t>(n);
  const float* S = in + i;
  HoverLane s;
  float sp[4];
  quadx_lane::load_lane(S, ld, s.d, sp);
  quadx_lane::Cascade cas;  // mode 7 only
  if constexpr (MODE == 7) quadx_lane::load_cascade(S, ld, cas);
  s.term = S[TERM * ld];
  s.trunc = S[TRUNC * ld];
  s.coll = S[COLL * ld];
  s.oob = S[OOB * ld];
  const float stepc = S[STEP * ld];
  s.rwd = -0.1f;  // re-armed every agent step
  const float trunc_hit = (stepc > c.max_steps) ? 1.f : 0.f;  // pre-increment

  const float no_wind[3] = {0.f, 0.f, 0.f};
  const quadx_lane::Recip rcp = quadx_lane::reciprocals(c);
  curandStatePhilox4_32_10_t rng;
  if (NOISY) curand_init(static_cast<unsigned long long>(seed[0]),
                         static_cast<unsigned long long>(i), 0ULL, &rng);

  for (int a = 0; a < c.inner_steps; ++a) {
    // done-freeze: the flags never clear, so a lane done before an aviary
    // step is done for the rest of the agent step
    if (fminf(fmaxf(s.term, s.trunc), 1.f) > 0.f) break;
    float any_contact = 0.f;
    for (int it = 0; it < c.ratio; ++it) {
      if constexpr (MODE == 7) {
        if (it == 0) quadx_lane::control<MODE, false>(s.d, sp, c, &cas, &rcp);  // probe: recip
      } else {
        if (it == 0) quadx_lane::control<MODE, false>(s.d, sp, c, nullptr, &rcp);  // probe: recip
      }
      const bool read = it == c.ratio - 1;  // probe: read
      quadx_lane::physics<NOISY, false, false>(s.d, c, &rng, no_wind, read, &rcp);  // probe: recip
      any_contact = fmaxf(any_contact, s.d.contact);
    }
    // hover task update on the lagged position
    const float vx = s.d.view[9], vy = s.d.view[10], vz = s.d.view[11];
    const float oob_i = (vx * vx + vy * vy + vz * vz > c.dome2) ? 1.f : 0.f;
    const float fatal = fmaxf(any_contact, oob_i);
    s.trunc = fminf(s.trunc + trunc_hit, 1.f);
    float rwd = (fatal > 0.f) ? -100.f : s.rwd;
    if (!SPARSE) {
      const float dz = vz - 1.f;
      rwd = rwd - sqrtf(vx * vx + vy * vy + dz * dz) -
            sqrtf(s.d.view[3] * s.d.view[3] + s.d.view[4] * s.d.view[4]) + 1.f;
    }
    s.rwd = rwd;
    s.term = fminf(s.term + fatal, 1.f);
    s.coll = fminf(s.coll + any_contact, 1.f);
    s.oob = fminf(s.oob + oob_i, 1.f);
  }

  float* O = out + i;
  quadx_lane::store_lane(O, ld, s.d, sp);
  O[RWD * ld] = s.rwd;
  O[TERM * ld] = s.term;
  O[TRUNC * ld] = s.trunc;
  O[COLL * ld] = s.coll;
  O[OOB * ld] = s.oob;
  O[STEP * ld] = stepc + 1.f;  // unconditional, after the inner loop
  if constexpr (MODE == 7) {
    quadx_lane::store_cascade(O, ld, cas);
    for (int r = quadx_lane::CASCADE + quadx_lane::CASCADE_ROWS; r < quadx_lane::ROWS_MODE7; ++r) O[r * ld] = 0.f;
  }
}

template <int MODE, bool NOISY>
void launch_sparse(bool sparse, dim3 grid, dim3 block, cudaStream_t stream,
                   const float* in, float* out, int n, const long long* seed,
                   const HoverConsts& c) {
  if (sparse)
    hover_step_kernel<MODE, NOISY, true><<<grid, block, 0, stream>>>(in, out, n, seed, c);
  else
    hover_step_kernel<MODE, NOISY, false><<<grid, block, 0, stream>>>(in, out, n, seed, c);
}

template <int MODE>
void launch_noisy(bool noisy, bool sparse, dim3 grid, dim3 block,
                  cudaStream_t stream, const float* in, float* out, int n,
                  const long long* seed, const HoverConsts& c) {
  if (noisy)
    launch_sparse<MODE, true>(sparse, grid, block, stream, in, out, n, seed, c);
  else
    launch_sparse<MODE, false>(sparse, grid, block, stream, in, out, n, seed, c);
}

}  // namespace

// in/out: (56, n) f32 row-major on the device, (80, n) in mode 7; seed: one int64 on the
// device; consts: host pointer, copied into the launch by value.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int quadx_hover_step(const float* in, float* out, int n,
                                const long long* seed, const HoverConsts* consts,
                                int mode, int noisy, int sparse, void* stream) {
  if (n <= 0 || n > INT_MAX - THREADS || (mode != 0 && mode != 7 && mode != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(THREADS);
  const dim3 grid((n + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    launch_noisy<0>(noisy != 0, sparse != 0, grid, block, s, in, out, n, seed, *consts);
  else if (mode == 7)
    launch_noisy<7>(noisy != 0, sparse != 0, grid, block, s, in, out, n, seed, *consts);
  else
    launch_noisy<8>(noisy != 0, sparse != 0, grid, block, s, in, out, n, seed, *consts);
  return static_cast<int>(cudaGetLastError());
}
