// Kernel K5: the Fixedwing steps for a batch of envs, one thread per env.
//
// Replaces pyflyt_tpu/ops/pallas_fixedwing.py::_build_kernel (:441-640)
// behind its entries packed_step (:647) and packed_waypoints_step (:663);
// pallas_fixedwing.step (:692) is the Python wrapper
// ops/cuda_fixedwing.step around fixedwing_step. Flight modes -1 and 0,
// noise on or off; the per-iteration physics is fixedwing_lane.cuh's.
//
// fixedwing_step: one aviary step (`ratio` physics iterations, the control
// map at iteration 0); row 53 of the output is the step's any-contact flag
// and rows 54-87 are zero, as in the Pallas kernel.
//
// fixedwing_waypoints_step: the whole Fixedwing-Waypoints agent step
// (envs/fixedwing_base.py base_step + envs/fixedwing_waypoints.py
// _task_update): `inner_steps` aviary steps, each followed by the task
// update: out-of-dome and contact termination (-100), step-count
// truncation, the body-frame target deltas (rotated by the last
// iteration's pre-integration rotation), the shaped reward
// max(3 progress, 0) + 1 / distance (the fixedwing task's, not QuadX's
// 0.1 / distance), the 100-point reach, the cyclic target advance, the
// all-reached truncation and env_complete. The reward is re-armed to -0.1
// before the loop and the step count increments after it, frozen or not.
//
// Layout (pallas_fixedwing.py:54-86), (88, n) f32: the drone in rows 0-52,
// the env rows 53-59 (reward, termination, truncation, collision,
// out-of-bounds, step count, env_complete), the 4 x 3 targets rolled so
// the current one is first (60-71), the remaining count (72), the new- and
// old-distance memos (73, 74), the 4 x 3 delta observation (75-86), one
// padding row.
//
// What bounds it on an H100: at the stock 4096 envs the waypoints step
// reads 86 rows and writes 88, 2.85 MB, 0.85 us at 3.35 TB/s; its ~10
// kFLOP per env (8 physics iterations of 5 surfaces) is 0.60 us at 67
// TFLOP/s. So bytes bound it, and each thread's dependent chain (an atan2f
// and a sincosf per surface per iteration) costs more.
//
// Design: SoA rows, one thread per env with the whole step in registers,
// one read and one write per row, the constants one POD struct passed by
// value as a __grid_constant__ (read through the constant cache, no local
// copy), the mode, the noise and the sparse reward as template parameters
// (4 + 8 instantiations), Philox motor noise, a masked ragged tail. The
// done-freeze leaves the inner loop: termination and truncation never
// clear, so a lane done before an aviary step stays done for the rest of
// the agent step and its registers are simply not touched again (no copy
// of the lane, no select, and no NaN computed on a frozen lane can reach
// it). Block size: 64 threads, so 4096 envs make 64 blocks with two warps
// each on 64 of the 132 SMs (32-thread blocks would put one warp on each
// of 128 SMs). Each warp has an SM sub-partition to itself either way, so
// the chain sets the time; measured on an H100 at 4096 envs, 64 threads
// ran the agent step in 34.6 us against 35.5 us with 32, and the aviary
// step in 12.6 us against 13.4 us (PERF.md).
#include <cuda_runtime.h>
#include <curand_kernel.h>

#include <cstddef>

#include "fixedwing_lane.cuh"

// Must match pyflyt_tpu_torch/ops/cuda_fixedwing.py::FixedwingConsts field
// by field (tests/test_torch_fixedwing.py holds the two layouts equal).
struct FixedwingConsts {
  float lu[15];        // lift units, 5 x 3
  float du[15];        // forward units
  float tu[15];        // pitch-moment units
  float r_s[15];       // surface position - CoM (read offset and lever arm)
  float qa[5];         // HALF_RHO * area
  float chord[5];
  float piar_inv[5];   // 1 / (pi * aspect)
  float cl3d[5];
  float cd0[5];
  float a0b[5];        // alpha_0_base, rad
  float asp_b[5];      // alpha_stall_P_base, rad
  float asn_b[5];      // alpha_stall_N_base, rad
  float dlim_rad[5];   // deflection limit, rad (0: no flap)
  float dcl_gain[5];   // Cl_alpha_3D * aero_tau * eta
  float f2c[5];        // flap_to_chord
  float clmax_p[5];    // Cl_alpha_3D * (alpha_stall_P_base - alpha_0_base)
  float clmax_n[5];    // Cl_alpha_3D * (alpha_stall_N_base - alpha_0_base)
  float stall_c[5];    // 0.41 (1 - exp(-17 / aspect))
  float lag[5];        // physics period / surface tau
  float inertia[9];    // row-major, about the CoM
  float inv_inertia[9];
  float com[3];        // base origin -> CoM, body frame
  float contact_pts[24];  // 8 CoM-relative contact points
  float mot_f[3];      // thrust per rpm^2, body frame
  float mot_t[3];      // torque per rpm^2
  float assist_signs[6];
  int assist_ids[6];
  float inv_mass;
  float mot_lag;       // physics period / motor tau
  float mot_max_rpm;
  float mot_noise;
  float dt;            // physics period
  float dome2;         // flight_dome_size^2
  float max_steps;     // step-count truncation threshold
  float goal;          // goal_reach_distance
  int ratio;           // physics iterations per aviary step
  int inner_steps;     // aviary steps per agent step
  int num_targets;     // 1..4
};

namespace {

namespace fl = fixedwing_lane;

// Env and waypoint rows (pallas_fixedwing.py:69-86).
constexpr int RWD = 53, TERM = 54, TRUNC = 55, COLL = 56, OOB = 57, STEP = 58, CPLT = 59;
constexpr int TGT = 60, REM = 72, NDIST = 73, ODIST = 74, TDLT = 75;
constexpr int ROWS = 88;
constexpr int THREADS = 64;  // per block; the header comment says why

template <int MODE, bool NOISY>
__global__ void __launch_bounds__(THREADS)
    step_kernel(const float* __restrict__ in, float* __restrict__ out, int n,
                const long long* __restrict__ seed, const __grid_constant__ FixedwingConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // ragged edge
  const size_t ld = static_cast<size_t>(n);
  fl::Lane s;
  float sp[6], cmd[6], R[9];
  fl::load_lane<false>(in + i, ld, s, sp);
  curandStatePhilox4_32_10_t rng;
  if (NOISY) curand_init(static_cast<unsigned long long>(seed[0]), static_cast<unsigned long long>(i), 0ULL, &rng);
  fl::control_cmd<MODE>(c, sp, cmd);
  float any_contact = 0.f;
  for (int it = 0; it < c.ratio; ++it) {
    fl::physics_iter<NOISY>(s, cmd, c, &rng, R);
    any_contact = fmaxf(any_contact, s.contact);
  }
  float* O = out + i;
  fl::store_lane(O, ld, s, sp);
  O[RWD * ld] = any_contact;  // the spare row carries the any-contact flag
  for (int r = RWD + 1; r < ROWS; ++r) O[r * ld] = 0.f;
}

template <int MODE, bool NOISY, bool SPARSE>
__global__ void __launch_bounds__(THREADS)
    waypoints_kernel(const float* __restrict__ in, float* __restrict__ out, int n,
                     const long long* __restrict__ seed, const __grid_constant__ FixedwingConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // ragged edge
  const size_t ld = static_cast<size_t>(n);
  const float* S = in + i;
  fl::Lane s;
  float sp[6], cmd[6], R[9];
  fl::load_lane<true>(S, ld, s, sp);
  float term = S[TERM * ld], trunc = S[TRUNC * ld], coll = S[COLL * ld], oob = S[OOB * ld];
  float cplt = S[CPLT * ld];
  const float stepc = S[STEP * ld];
  float tgt[12], tdlt[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    tgt[k] = S[(TGT + k) * ld];
    tdlt[k] = S[(TDLT + k) * ld];
  }
  float rem = S[REM * ld], ndist = S[NDIST * ld], odist = S[ODIST * ld];
  float rwd = -0.1f;  // re-armed every agent step
  const float trunc_hit = (stepc > c.max_steps) ? 1.f : 0.f;  // the count before this step's increment

  curandStatePhilox4_32_10_t rng;
  if (NOISY) curand_init(static_cast<unsigned long long>(seed[0]), static_cast<unsigned long long>(i), 0ULL, &rng);
  fl::control_cmd<MODE>(c, sp, cmd);  // the setpoint is constant over the agent step

  for (int a = 0; a < c.inner_steps; ++a) {
    if (term + trunc > 0.f) break;  // the done-freeze: flags never clear
    float any_contact = 0.f;
    for (int it = 0; it < c.ratio; ++it) {
      fl::physics_iter<NOISY>(s, cmd, c, &rng, R);
      any_contact = fmaxf(any_contact, s.contact);
    }
    // the task update on the lagged base position
    const float lp[3] = {s.view[9], s.view[10], s.view[11]};
    const float oob_i = (lp[0] * lp[0] + lp[1] * lp[1] + lp[2] * lp[2] > c.dome2) ? 1.f : 0.f;
    const float fatal = fmaxf(any_contact, oob_i);
    float reached, all_reached;
    const float progress = quadx_math::waypoint_track(R, lp, tgt, rem, ndist, odist, tdlt, c.num_targets,
                                                      c.goal, reached, all_reached);
    float r = (fatal > 0.f) ? -100.f : rwd;
    if (!SPARSE) r = r + fmaxf(3.f * progress, 0.f) + 1.f / ndist;
    rwd = (reached > 0.f) ? 100.f : r;
    trunc = fminf(fminf(trunc + trunc_hit, 1.f) + all_reached, 1.f);
    cplt = fminf(cplt + all_reached, 1.f);
    term = fminf(term + fatal, 1.f);
    coll = fminf(coll + any_contact, 1.f);
    oob = fminf(oob + oob_i, 1.f);
  }

  float* O = out + i;
  fl::store_lane(O, ld, s, sp);
  O[RWD * ld] = rwd;
  O[TERM * ld] = term;
  O[TRUNC * ld] = trunc;
  O[COLL * ld] = coll;
  O[OOB * ld] = oob;
  O[STEP * ld] = stepc + 1.f;  // unconditional, after the inner loop
  O[CPLT * ld] = cplt;
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    O[(TGT + k) * ld] = tgt[k];
    O[(TDLT + k) * ld] = tdlt[k];
  }
  O[REM * ld] = rem;
  O[NDIST * ld] = ndist;
  O[ODIST * ld] = odist;
  O[(TDLT + 12) * ld] = 0.f;  // padding row
}

struct Launch {
  dim3 grid, block;
  cudaStream_t stream;
  const float* in;
  float* out;
  int n;
  const long long* seed;
  const FixedwingConsts* c;
};

template <int MODE, bool NOISY>
void launch_waypoints(bool sparse, const Launch& L) {
  if (sparse)
    waypoints_kernel<MODE, NOISY, true><<<L.grid, L.block, 0, L.stream>>>(L.in, L.out, L.n, L.seed, *L.c);
  else
    waypoints_kernel<MODE, NOISY, false><<<L.grid, L.block, 0, L.stream>>>(L.in, L.out, L.n, L.seed, *L.c);
}

template <int MODE>
void launch_mode(bool waypoints, bool noisy, bool sparse, const Launch& L) {
  if (waypoints) {
    if (noisy)
      launch_waypoints<MODE, true>(sparse, L);
    else
      launch_waypoints<MODE, false>(sparse, L);
  } else if (noisy) {
    step_kernel<MODE, true><<<L.grid, L.block, 0, L.stream>>>(L.in, L.out, L.n, L.seed, *L.c);
  } else {
    step_kernel<MODE, false><<<L.grid, L.block, 0, L.stream>>>(L.in, L.out, L.n, L.seed, *L.c);
  }
}

int launch(bool waypoints, const float* in, float* out, int n, const long long* seed,
           const FixedwingConsts* consts, int mode, int noisy, int sparse, void* stream) {
  if (n <= 0 || (mode != -1 && mode != 0) || consts->ratio < 1 ||
      (waypoints && (consts->num_targets < 1 || consts->num_targets > 4 || consts->inner_steps < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{dim3((n + THREADS - 1) / THREADS), dim3(THREADS), static_cast<cudaStream_t>(stream),
                 in, out, n, seed, consts};
  if (mode == 0)
    launch_mode<0>(waypoints, noisy != 0, sparse != 0, L);
  else
    launch_mode<-1>(waypoints, noisy != 0, sparse != 0, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in/out: (88, n) f32 row-major on the device; seed: one int64 on the
// device; consts: host pointer, copied into the launch by value. Each
// returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue outside the envelope.
extern "C" int fixedwing_step(const float* in, float* out, int n, const long long* seed,
                              const FixedwingConsts* consts, int mode, int noisy, int sparse, void* stream) {
  return launch(false, in, out, n, seed, consts, mode, noisy, sparse, stream);
}

extern "C" int fixedwing_waypoints_step(const float* in, float* out, int n, const long long* seed,
                                        const FixedwingConsts* consts, int mode, int noisy, int sparse,
                                        void* stream) {
  return launch(true, in, out, n, seed, consts, mode, noisy, sparse, stream);
}
