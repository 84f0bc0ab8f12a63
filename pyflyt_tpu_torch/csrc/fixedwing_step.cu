// Kernel K5: the Fixedwing steps for a batch of envs, a group of lanes per env.
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
// TFLOP/s. So bytes bound it, and the dependent chain of a physics
// iteration (an atan2f and a sincosf per surface, the rigid body's
// rotation and integration) costs more.
//
// Design: SoA rows; each env a group of GROUP lanes (fixedwing_lane.cuh:
// a surface a lane, the wrench summed by a butterfly, the motor and the
// rigid body in every lane), so 4096 envs make 32,768
// threads, 512 blocks of 64, about two warps to switch between on each SM
// sub-partition where one thread per env left one warp alone with the
// chain of five surfaces. Each lane reads the rows it needs once and each
// row is written once, by the lane that owns it. The constants are one
// POD struct passed by value as a __grid_constant__ (read through the
// constant cache, no local copy), each lane's surface constants gathered
// into registers once; the mode, the noise and the sparse reward are
// template parameters (4 + 8 instantiations); Philox motor noise, every
// lane of a group on the env's stream (the subsequence its index, as
// before); a ragged tail
// that leaves a whole group at a time. The done-freeze leaves the inner
// loop: termination and truncation never clear and every lane of a group
// holds the same flags, so a group done before an aviary step leaves
// together, stays done for the rest of the agent step and its registers
// are simply not touched again (no copy of the lane, no select, and no NaN
// computed on a frozen lane can reach it); the shuffles use the group's
// own mask, so a group that left does not stall the others of its warp.
// Measured against one thread per env on an H100: PERF.md section 6.
#include <cuda_runtime.h>
#include <curand_kernel.h>

#include <climits>
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
constexpr int THREADS = 64;  // per block: whole warps, so no group straddles two
constexpr int GROUP = 8;     // lanes per env (probe: group)

template <int MODE, bool NOISY>
__global__ void __launch_bounds__(THREADS)
    step_kernel(const float* __restrict__ in, float* __restrict__ out, int n,
                const long long* __restrict__ seed, const __grid_constant__ FixedwingConsts c) {
  const int tid = blockIdx.x * THREADS + threadIdx.x;
  const int i = tid / GROUP, lane = tid % GROUP;
  if (i >= n) return;  // ragged edge: whole groups leave
  const unsigned mask = fl::group_mask<GROUP>();
  const size_t ld = static_cast<size_t>(n);
  fl::GroupLane<GROUP> s;
  float sp[6], cmd[6], R[9];
  fl::load_lane<GROUP, false>(in + i, ld, lane, s, sp);
  curandStatePhilox4_32_10_t rng;
  if (NOISY)  // every lane of the group on the env's one stream
    curand_init(static_cast<unsigned long long>(seed[0]), static_cast<unsigned long long>(i), 0ULL, &rng);
  fl::control_cmd<MODE>(c, sp, cmd);
  const fl::Role<GROUP> o = fl::make_role<GROUP>(c, lane, cmd);
  float any_contact = 0.f;
  for (int it = 0; it < c.ratio; ++it) {
    const bool read = it == c.ratio - 1;  // probe: read
    fl::physics_iter<GROUP, NOISY>(s, o, cmd[5], c, mask, &rng, read, R);
    any_contact = fmaxf(any_contact, s.contact);
  }
  float* O = out + i;
  fl::store_lane<GROUP>(O, ld, lane, s, sp);
  fl::put<GROUP>(O, ld, lane, RWD, any_contact);  // the spare row carries the any-contact flag
#pragma unroll
  for (int r = RWD + 1; r < ROWS; ++r) fl::put<GROUP>(O, ld, lane, r, 0.f);
}

template <int MODE, bool NOISY, bool SPARSE>
__global__ void __launch_bounds__(THREADS)
    waypoints_kernel(const float* __restrict__ in, float* __restrict__ out, int n,
                     const long long* __restrict__ seed, const __grid_constant__ FixedwingConsts c) {
  const int tid = blockIdx.x * THREADS + threadIdx.x;
  const int i = tid / GROUP, lane = tid % GROUP;
  if (i >= n) return;  // ragged edge: whole groups leave
  const unsigned mask = fl::group_mask<GROUP>();
  const size_t ld = static_cast<size_t>(n);
  const float* S = in + i;
  fl::GroupLane<GROUP> s;
  float sp[6], cmd[6], R[9];
  fl::load_lane<GROUP, true>(S, ld, lane, s, sp);
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
  if (NOISY)  // every lane of the group on the env's one stream
    curand_init(static_cast<unsigned long long>(seed[0]), static_cast<unsigned long long>(i), 0ULL, &rng);
  fl::control_cmd<MODE>(c, sp, cmd);  // the setpoint is constant over the agent step
  const fl::Role<GROUP> o = fl::make_role<GROUP>(c, lane, cmd);

  for (int a = 0; a < c.inner_steps; ++a) {
    if (term + trunc > 0.f) break;  // the done-freeze: flags never clear, the same in every lane
    float any_contact = 0.f;
    for (int it = 0; it < c.ratio; ++it) {
      const bool read = it == c.ratio - 1;  // probe: read
      fl::physics_iter<GROUP, NOISY>(s, o, cmd[5], c, mask, &rng, read, R);
      any_contact = fmaxf(any_contact, s.contact);
    }
    // the task update on the lagged base position, in every lane
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
  fl::store_lane<GROUP>(O, ld, lane, s, sp);
  fl::put<GROUP>(O, ld, lane, RWD, rwd);
  fl::put<GROUP>(O, ld, lane, TERM, term);
  fl::put<GROUP>(O, ld, lane, TRUNC, trunc);
  fl::put<GROUP>(O, ld, lane, COLL, coll);
  fl::put<GROUP>(O, ld, lane, OOB, oob);
  fl::put<GROUP>(O, ld, lane, STEP, stepc + 1.f);  // unconditional, after the inner loop
  fl::put<GROUP>(O, ld, lane, CPLT, cplt);
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    fl::put<GROUP>(O, ld, lane, TGT + k, tgt[k]);
    fl::put<GROUP>(O, ld, lane, TDLT + k, tdlt[k]);
  }
  fl::put<GROUP>(O, ld, lane, REM, rem);
  fl::put<GROUP>(O, ld, lane, NDIST, ndist);
  fl::put<GROUP>(O, ld, lane, ODIST, odist);
  fl::put<GROUP>(O, ld, lane, TDLT + 12, 0.f);  // padding row
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
  if (n <= 0 || n > (INT_MAX - THREADS) / GROUP || (mode != -1 && mode != 0) || consts->ratio < 1 ||
      (waypoints && (consts->num_targets < 1 || consts->num_targets > 4 || consts->inner_steps < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{dim3((n * GROUP + THREADS - 1) / THREADS), dim3(THREADS), static_cast<cudaStream_t>(stream),
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
