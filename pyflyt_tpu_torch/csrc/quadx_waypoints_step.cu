// One full QuadX-Waypoints agent step for a batch of envs, one thread per env.
//
// Replaces pyflyt_tpu/ops/pallas_quadx.py::packed_waypoints_step (the
// env-fused variant of _build_kernel with the `waypoints` extension:
// :368-397 registers, :418-431 snapshot, :682-753 task update and freeze,
// :781-790 pack back) and pallas_math.py::waypoint_track (here
// quadx_math::waypoint_track), modes 0, 7 and 8, ENU: `inner_steps`
// aviary steps of `ratio` physics iterations each (quadx_lane.cuh), each
// followed by the waypoints task update: out-of-dome and contact
// termination, step-count truncation, the body-frame target deltas rotated
// by the last iteration's pre-integration rotation, the progress and
// proximity reward, the 100-point reach, the cyclic target advance, the
// all-reached truncation and env_complete, and the done-freeze.
//
// Layout (pallas_quadx.py:52-98): the drone in rows 0-49, the env rows
// 50-55 (reward, termination, truncation, collision, out-of-bounds, step
// count), in mode 7 the cascade in rows 56-73, then 28 waypoint rows from
// WB = 56 (80 in mode 7): +0 the 4 x 3 targets rolled so the current one
// is first, +12 the remaining count, +13 the new-distance memo, +14 the
// old-distance memo, +15 the 4 x 3 delta observation, +27 env_complete;
// 88 rows in all (112 in mode 7), the TPU layout's padding kept so packed
// states compare row by row.
//
// What bounds it on an H100: at 8192 envs in mode 7 each env reads 101
// f32 rows (the drone's 50, the env rows but the re-armed reward, the
// cascade's 18, the 28 waypoint rows) and writes all 112, 6.98 MB in all,
// ~2.1 us at 3.35 TB/s; its ~4 kFLOP of f32 work per env (4 aviary steps)
// is ~0.5 us at 67 TFLOP/s. So bytes bound it, and each thread's long
// dependent chain costs more (as in quadx_hover_step.cu). Design: SoA
// rows, one thread per env in 64-thread blocks, the whole agent step in
// registers with one read and one write per row, constants as one POD
// struct passed as a __grid_constant__, the mode, the noise and the sparse
// reward as template parameters (12 instantiations), a masked ragged tail.
// The chain is shortened as in quadx_hover_step.cu: the view and the
// rotation the task update reads only on an aviary step's last physics
// iteration; reciprocals of the mass, the inertia and the control period
// (the cascade's included) taken once a launch; the done-freeze an exit
// from the aviary loop (termination and truncation never clear) with the
// lane updated in place, no copy of it and no select. On an H100 dividing
// costs 48%, the freeze as a select 10% and the view every iteration 6%;
// staging the block's rows through shared memory by bulk copies (the
// probe's `staged`) was 24% slower, since the loads already overlap and
// the chain dominates (PERF.md section 6).
#include <cuda_runtime.h>
#include <curand_kernel.h>

#include <cstddef>

#include "quadx_lane.cuh"

namespace {

// Env rows (pallas_quadx.py:207-213); waypoint rows relative to WB.
constexpr int RWD = 50, TERM = 51, TRUNC = 52, COLL = 53, OOB = 54, STEP = 55;
constexpr int WP_TGT = 0, WP_REM = 12, WP_NDIST = 13, WP_ODIST = 14, WP_TDLT = 15, WP_CPLT = 27;
constexpr int WP_ROWS = 28;
constexpr int THREADS = 64;  // per block

template <int MODE>
struct Layout {
  static constexpr int WB = (MODE == 7) ? quadx_lane::ROWS_MODE7 : 56;
  static constexpr int ROWS = ((WB + WP_ROWS + 7) / 8) * 8;  // 88, or 112 in mode 7
};

}  // namespace

// Must match pyflyt_tpu_torch/ops/cuda_quadx.py::WaypointsConsts field by
// field (tests/test_torch_packed_waypoints.py holds the two layouts equal).
struct WaypointsConsts {
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
  float lp_kp[2];  // mode 7: the position cascade's banks
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
  float dome2;      // flight_dome_size^2
  float max_steps;  // step-count truncation threshold
  float goal;       // goal_reach_distance
  int inner_steps;  // aviary steps per agent step
  int ratio;        // physics iterations per aviary step
  int num_targets;  // 1..4
};

namespace {

using quadx_lane::Lane;

// Every register of one env that an aviary step may change.
struct WaypointsLane {
  Lane d;
  quadx_lane::Cascade cas;  // mode 7 only
  float rwd, term, trunc, coll, oob;
  float tgt[12], rem, ndist, odist, tdlt[12], cplt;
};

// One agent step of env i from column S into column O (row stride ld).
template <int MODE, bool NOISY, bool SPARSE>
__device__ __forceinline__ void agent_step(const float* S, float* O, size_t ld, int i,
                                           const long long* __restrict__ seed, const WaypointsConsts& c) {
  constexpr int WB = Layout<MODE>::WB;
  constexpr int ROWS = Layout<MODE>::ROWS;
  WaypointsLane s;
  float sp[4];
  quadx_lane::load_lane(S, ld, s.d, sp);
  if constexpr (MODE == 7) quadx_lane::load_cascade(S, ld, s.cas);
  s.term = S[TERM * ld];
  s.trunc = S[TRUNC * ld];
  s.coll = S[COLL * ld];
  s.oob = S[OOB * ld];
  for (int k = 0; k < 12; ++k) {
    s.tgt[k] = S[(WB + WP_TGT + k) * ld];
    s.tdlt[k] = S[(WB + WP_TDLT + k) * ld];
  }
  s.rem = S[(WB + WP_REM) * ld];
  s.ndist = S[(WB + WP_NDIST) * ld];
  s.odist = S[(WB + WP_ODIST) * ld];
  s.cplt = S[(WB + WP_CPLT) * ld];
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
    if (fminf(fmaxf(s.term, s.trunc), 1.f) > 0.f) break;  // probe: freeze
    float any_contact = 0.f;
    float q_pre[4];
    for (int it = 0; it < c.ratio; ++it) {
      if (it == 0) quadx_lane::control<MODE, false>(s.d, sp, c, &s.cas, &rcp);  // probe: recip
      const bool read = it == c.ratio - 1;  // probe: read
      if (read)
        for (int k = 0; k < 4; ++k) q_pre[k] = s.d.quat[k];
      quadx_lane::physics<NOISY, false, false>(s.d, c, &rng, no_wind, read, &rcp);  // probe: recip
      any_contact = fmaxf(any_contact, s.d.contact);
    }
    // the task update on the lagged position; the deltas are rotated by
    // the last iteration's pre-integration rotation (pallas_quadx.py:677-680)
    const float lp[3] = {s.d.view[9], s.d.view[10], s.d.view[11]};
    const float oob_i = (lp[0] * lp[0] + lp[1] * lp[1] + lp[2] * lp[2] > c.dome2) ? 1.f : 0.f;
    const float fatal = fmaxf(any_contact, oob_i);
    const float trunc = fminf(s.trunc + trunc_hit, 1.f);
    float rwd = (fatal > 0.f) ? -100.f : s.rwd;
    float R[9];
    quadx_math::quat_rotmat(q_pre, R);
    float reached, all_reached;
    const float progress = quadx_math::waypoint_track(R, lp, s.tgt, s.rem, s.ndist, s.odist, s.tdlt,
                                                      c.num_targets, c.goal, reached, all_reached);
    if (!SPARSE) rwd = rwd + fmaxf(3.f * progress, 0.f) + 0.1f / s.ndist;
    s.rwd = (reached > 0.f) ? 100.f : rwd;
    s.trunc = fminf(trunc + all_reached, 1.f);
    s.cplt = fminf(s.cplt + all_reached, 1.f);
    s.term = fminf(s.term + fatal, 1.f);
    s.coll = fminf(s.coll + any_contact, 1.f);
    s.oob = fminf(s.oob + oob_i, 1.f);  // probe: freeze
  }

  quadx_lane::store_lane(O, ld, s.d, sp);
  O[RWD * ld] = s.rwd;
  O[TERM * ld] = s.term;
  O[TRUNC * ld] = s.trunc;
  O[COLL * ld] = s.coll;
  O[OOB * ld] = s.oob;
  O[STEP * ld] = stepc + 1.f;  // unconditional, after the inner loop
  if constexpr (MODE == 7) {
    quadx_lane::store_cascade(O, ld, s.cas);
    for (int r = quadx_lane::CASCADE + quadx_lane::CASCADE_ROWS; r < WB; ++r) O[r * ld] = 0.f;
  }
  for (int k = 0; k < 12; ++k) {
    O[(WB + WP_TGT + k) * ld] = s.tgt[k];
    O[(WB + WP_TDLT + k) * ld] = s.tdlt[k];
  }
  O[(WB + WP_REM) * ld] = s.rem;
  O[(WB + WP_NDIST) * ld] = s.ndist;
  O[(WB + WP_ODIST) * ld] = s.odist;
  O[(WB + WP_CPLT) * ld] = s.cplt;
  for (int r = WB + WP_ROWS; r < ROWS; ++r) O[r * ld] = 0.f;
}

// One thread an env, the ragged tail masked.
template <int MODE, bool NOISY, bool SPARSE>
__global__ void __launch_bounds__(THREADS)
    waypoints_step_kernel(const float* __restrict__ in, float* __restrict__ out, int n,
                          const long long* __restrict__ seed, const __grid_constant__ WaypointsConsts c) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const size_t ld = static_cast<size_t>(n);
  if (i < n) agent_step<MODE, NOISY, SPARSE>(in + i, out + i, ld, i, seed, c);  // probe: staged
}

struct Launch {
  dim3 grid, block;
  cudaStream_t stream;
  const float* in;
  float* out;
  int n;
  const long long* seed;
  const WaypointsConsts* c;
};

template <int MODE, bool NOISY>
void launch_sparse(bool sparse, const Launch& L) {
  if (sparse)
    waypoints_step_kernel<MODE, NOISY, true><<<L.grid, L.block, 0, L.stream>>>(L.in, L.out, L.n, L.seed, *L.c);
  else
    waypoints_step_kernel<MODE, NOISY, false><<<L.grid, L.block, 0, L.stream>>>(L.in, L.out, L.n, L.seed, *L.c);
}

template <int MODE>
void launch_noisy(bool noisy, bool sparse, const Launch& L) {
  if (noisy)
    launch_sparse<MODE, true>(sparse, L);
  else
    launch_sparse<MODE, false>(sparse, L);
}

}  // namespace

// in/out: (88, n) f32 row-major on the device, (112, n) in mode 7; seed:
// one int64 on the device; consts: host pointer, copied into the launch by
// value. Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue outside the envelope.
extern "C" int quadx_waypoints_step(const float* in, float* out, int n, const long long* seed,
                                    const WaypointsConsts* consts, int mode, int noisy, int sparse,
                                    void* stream) {
  if (n <= 0 || (mode != 0 && mode != 7 && mode != 8) || consts->num_targets < 1 ||
      consts->num_targets > 4 || consts->ratio < 1 || consts->inner_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{dim3((n + THREADS - 1) / THREADS), dim3(THREADS),
                 static_cast<cudaStream_t>(stream), in, out, n, seed, consts};
  const bool nz = noisy != 0, sp = sparse != 0;
  if (mode == 0)
    launch_noisy<0>(nz, sp, L);
  else if (mode == 7)
    launch_noisy<7>(nz, sp, L);
  else
    launch_noisy<8>(nz, sp, L);
  return static_cast<int>(cudaGetLastError());
}
