// Kernel K6: the Rocket steps for a batch of envs, one thread per env.
//
// Replaces pyflyt_tpu/ops/pallas_rocket.py::_build_kernel (:321-829)
// behind its entries packed_step (:836) and packed_landing_step (:851).
//
// rocket_step: one aviary step (`ratio` physics iterations, 2 at the stock
// 240 Hz physics and 120 Hz control); row 59 of the output carries the
// step's any-ground-contact flag and row 60 its any-pad-contact flag, the
// pad rows 66-68 are kept and the other env rows are zero, as in the Pallas
// kernel.
//
// rocket_landing_step: the whole Rocket-Landing agent step
// (envs/rocket_base.py base_step + envs/rocket_landing.py _task_update):
// `inner_steps` aviary steps (3 at the stock 40 Hz), each followed by the
// memo shift (the current body rates, velocity and pad distance become the
// previous ones), the base termination (truncation from the step count
// before this step's increment, a ground contact off the pad, below ground,
// out of bounds by displacement or ceiling; the reward is not overwritten),
// the shaped reward unless SPARSE, and the pad touchdown: +20, hard landing
// on the previous memos (fatal), landed (+500, complete). The reward is
// re-armed to 0 before the loop and the step count increments after it,
// frozen or not.
//
// Each physics iteration (models/rocket.py physics_iter):
//   1. the composite CoM of the fuel load before the burn;
//   2. the body drag at the fuel-tank link, its lever arm about that CoM;
//   3. the 4 grid-fin Khan surfaces (fixedwing_lane.cuh's surface model)
//      from the lagged read, after the actuation lag, lever arms about the
//      pre-burn CoM;
//   4. the gimbal lag and the two-axis Rodrigues rotation of the thrust;
//   5. the booster: ignition latch, throttle floor and lag, Philox noise,
//      no thrust from a dry tank, the fuel burn;
//   6. the post-burn composite mass, CoM and the 6 unique entries of its
//      inertia (7 point masses shifted to the CoM, plus the link inertias);
//   7. the boost wrench about the post-burn CoM;
//   8. the new lagged read from the pre-integration state: the view and the
//      body-frame air velocities at the 4 finlets and the drag link;
//   9. semi-implicit Euler with the full inertia, solved by its adjugate;
//  10. the impulse contact over the 12 contact points against the ground
//      and the raised landing pad (its top inside r = 2 m): the
//      depth-weighted centroid, the normal impulse, Coulomb friction at
//      mu = 0.5 with the world inverse inertia 1 / ((R o R) diag I), the
//      positional projection (core/integrator.py ground_contact).
// The landing task observes what happens after contact, so unlike K1 and
// K5 this is the full impulse model, not detection.
//
// Layout (pallas_rocket.py:57-92), (88, n) f32: the drone in rows 0-58
// (position, quaternion, velocities, the 12 view rows, 12 finlet and 3
// drag-link velocities, 4 finlet deflections, fuel, throttle, ignition, 2
// gimbal rows, the 7 setpoint rows, the contact flags), then reward,
// termination, truncation, fatal collision, out of bounds, complete, step
// count (59-65), the pad position (66-68), the pad-contact flag (69) and
// the 6 memos of 3 rows (70-87).
//
// What bounds it on an H100: at the serving path's 8192 envs the landing
// step reads 87 rows (all but the re-armed reward) and writes 88, 5.7 MB,
// 1.71 us at 3.35 TB/s; its ~11.3 kFLOP per airborne env (6 physics
// iterations; cuda_rocket.ops_per_env counts them) are 1.38 us at 67
// TFLOP/s. So bytes bound it, and each thread's dependent chain (6 atan2f,
// an asinf and 6 sincosf per iteration, the composite and the 12-point
// contact) costs more than either: measured on an H100 at 8192 envs,
// 33.5-35.5 us for the agent step and 13.3-13.9 us for the aviary step
// (PERF.md).
//
// Design: SoA rows, one thread per env with the whole step in registers,
// one read and one write per row; the constants one POD struct passed by
// value as a __grid_constant__; LANDING, NOISY and SPARSE template
// parameters (2 + 4 instantiations); Philox booster noise with the
// subsequence set to the global env index; a masked ragged tail; blocks of
// 64 threads, as every vehicle kernel here. The done-freeze leaves the
// inner loop: termination and truncation never clear, so a lane done
// before an aviary step keeps its registers untouched for the rest of the
// agent step (the Pallas kernel's snapshot-select). The composite CoM and
// inertia are affine in the fuel mass and accumulate in registers; the
// Mosaic workarounds are dropped: native atan2f/asinf in the Euler read
// and sincosf in the Rodrigues pair.
#include <cuda_runtime.h>
#include <curand_kernel.h>

#include <cstddef>

#include "fixedwing_lane.cuh"

// Must match pyflyt_tpu_torch/ops/cuda_rocket.py::RocketConsts field by
// field (tests/test_torch_rocket.py holds the two layouts equal). The
// surface fields carry the names fixedwing_lane::surface reads.
struct RocketConsts {
  float lu[12];           // finlet lift units, 4 x 3
  float du[12];           // forward units
  float tu[12];           // pitch-moment units
  float spos[12];         // finlet positions, body frame (base origin)
  float qa[4];            // HALF_RHO * area
  float chord[4];
  float piar_inv[4];      // 1 / (pi * aspect)
  float cl3d[4];
  float cd0[4];
  float a0b[4];           // alpha_0_base, rad
  float asp_b[4];         // alpha_stall_P_base, rad
  float asn_b[4];         // alpha_stall_N_base, rad
  float dlim_rad[4];      // deflection limit, rad
  float dcl_gain[4];      // Cl_alpha_3D * aero_tau * eta
  float f2c[4];           // flap_to_chord
  float clmax_p[4];       // Cl_alpha_3D * (alpha_stall_P_base - alpha_0_base)
  float clmax_n[4];       // Cl_alpha_3D * (alpha_stall_N_base - alpha_0_base)
  float stall_c[4];       // 0.41 (1 - exp(-17 / aspect))
  float lag[4];           // physics period / finlet tau
  float finlet_map[12];   // [force x, force y, yaw] -> 4 finlets, row-major
  float drag_const[3];    // 1/2 rho Cd A per body axis
  float drag_pos[3];      // the drag link (the fuel tank), body frame
  float contact_pts[36];  // 12 contact points, body frame (base origin)
  float pt_mass[7];       // [base, fuel (run time), booster, 4 fins]
  float pt_pos[21];       // their positions, body frame
  float p_dry[3];         // sum of the dry point masses' m * p
  float i_dry[3];         // base + booster link inertia diagonals
  float fuel_inertia[3];  // the fuel tank's link inertia at full fuel
  float b_pos[3];         // booster position
  float b_tu[3];          // thrust unit before gimballing
  float g_range[2];       // gimbal ranges, rad
  float g_w1[9];          // gimbal axis skews and their squares, row-major
  float g_w2[9];
  float g_w1sq[9];
  float g_w2sq[9];
  float m_dry;            // the dry mass
  float b_lag;            // physics period / booster tau
  float b_total_fuel;     // fuel mass at full fuel
  float b_fuel_rate;      // max fuel rate / total fuel
  float b_min_ratio;      // min thrust / max thrust
  float b_max_thrust;
  float b_noise;          // booster noise ratio
  float g_lag;            // physics period / gimbal tau
  float dt;               // physics period
  float max_steps;        // step-count truncation threshold (landing entry)
  float max_displacement; // xy bound (landing entry)
  float ceiling;          // z bound (landing entry)
  int b_reignitable;
  int ratio;              // physics iterations per aviary step
  int inner_steps;        // aviary steps per agent step (landing entry)
};

namespace {

namespace fl = fixedwing_lane;

// Row layout of pallas_rocket.py:57-92.
constexpr int POS = 0, QUAT = 3, LVEL = 7, AVEL = 10, VIEW = 13, FLV = 25, DLV = 37, ACT = 40, FUEL = 44,
              BTHR = 45, IGN = 46, GBL = 47, SP = 49, CON = 56, GCON = 57, PCON = 58;
constexpr int RWD = 59, TERM = 60, TRUNC = 61, FATC = 62, OOB = 63, CPLT = 64, STEP = 65, PADP = 66, PFLAG = 69,
              AV = 70, LV = 73, DIST = 76, PAV = 79, PLV = 82, PDIST = 85;
constexpr int ROWS = 88;
constexpr int NUM_FINLETS = 4, NUM_POINTS = 7, NUM_CONTACT = 12;
constexpr float GRAVITY = 9.81f;
constexpr float PAD_RADIUS2 = 4.f;     // the pad's radius, 2 m, squared
constexpr float PAD_HALF_HEIGHT = 0.05f;
constexpr float FRICTION = 0.5f;
constexpr int THREADS = 64;  // per block, as in every vehicle kernel here

struct Lane {
  float pos[3], quat[4], lvel[3], avel[3], view[12], flv[12], dlv[3], act[4];
  float fuel, bthr, ign, gbl[2], con, gcon, pcon;
};

// The agent step's commands, constant over it: the finlet mix, the
// ignition, the clipped throttle and gimbal commands.
struct Cmd {
  float fin[NUM_FINLETS], ign, pwm, gbl[2];
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

__device__ __forceinline__ void load_lane(const float* S, size_t ld, Lane& s, float sp[7]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.pos[k] = S[(POS + k) * ld];
    s.lvel[k] = S[(LVEL + k) * ld];
    s.avel[k] = S[(AVEL + k) * ld];
    s.dlv[k] = S[(DLV + k) * ld];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s.quat[k] = S[(QUAT + k) * ld];
    s.act[k] = S[(ACT + k) * ld];
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) s.flv[k] = S[(FLV + k) * ld];
  s.fuel = S[FUEL * ld];
  s.bthr = S[BTHR * ld];
  s.ign = S[IGN * ld];
  s.gbl[0] = S[GBL * ld];
  s.gbl[1] = S[(GBL + 1) * ld];
#pragma unroll
  for (int k = 0; k < 7; ++k) sp[k] = S[(SP + k) * ld];
}

__device__ __forceinline__ void store_lane(float* O, size_t ld, const Lane& s, const float sp[7]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    O[(POS + k) * ld] = s.pos[k];
    O[(LVEL + k) * ld] = s.lvel[k];
    O[(AVEL + k) * ld] = s.avel[k];
    O[(DLV + k) * ld] = s.dlv[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    O[(QUAT + k) * ld] = s.quat[k];
    O[(ACT + k) * ld] = s.act[k];
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    O[(VIEW + k) * ld] = s.view[k];
    O[(FLV + k) * ld] = s.flv[k];
  }
  O[FUEL * ld] = s.fuel;
  O[BTHR * ld] = s.bthr;
  O[IGN * ld] = s.ign;
  O[GBL * ld] = s.gbl[0];
  O[(GBL + 1) * ld] = s.gbl[1];
#pragma unroll
  for (int k = 0; k < 7; ++k) O[(SP + k) * ld] = sp[k];
  O[CON * ld] = s.con;
  O[GCON * ld] = s.gcon;
  O[PCON * ld] = s.pcon;
}

// The control map (models/rocket.py update_control plus the clips of
// physics_iter): constant over the agent step, as the setpoint is.
__device__ __forceinline__ Cmd control(const RocketConsts& c, const float sp[7]) {
  Cmd u;
#pragma unroll
  for (int k = 0; k < NUM_FINLETS; ++k)
    u.fin[k] = clampf(c.finlet_map[3 * k] * sp[0] + c.finlet_map[3 * k + 1] * sp[1] + c.finlet_map[3 * k + 2] * sp[2],
                      -1.f, 1.f);
  u.ign = sp[3];
  u.pwm = clampf(sp[4], 0.f, 1.f);
  u.gbl[0] = clampf(sp[5], -1.f, 1.f);
  u.gbl[1] = clampf(sp[6], -1.f, 1.f);
  return u;
}

// The composite CoM for fuel mass fm, and 1 / mass.
__device__ __forceinline__ void mass_com(const RocketConsts& c, float fm, float com[3], float& inv_mass) {
  inv_mass = 1.f / (c.m_dry + fm);
#pragma unroll
  for (int i = 0; i < 3; ++i) com[i] = (c.p_dry[i] + fm * c.pt_pos[3 + i]) * inv_mass;
}

// v + s (W v) + q (W^2 v) for a row-major skew W and its square.
__device__ __forceinline__ void rodrigues(const float w[9], const float wsq[9], float s, float q, float v[3]) {
  float out[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = v[i] + s * (w[3 * i] * v[0] + w[3 * i + 1] * v[1] + w[3 * i + 2] * v[2]) +
             q * (wsq[3 * i] * v[0] + wsq[3 * i + 1] * v[1] + wsq[3 * i + 2] * v[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = out[i];
}

// The body-frame velocity of the body point p (base origin) relative to
// the composite CoM com, under the pre-integration rotation R.
__device__ __forceinline__ void local_vel_at(const Lane& s, const float R[9], const float com[3], const float* p,
                                             float out[3]) {
  const float rx = p[0] - com[0], ry = p[1] - com[1], rz = p[2] - com[2];
  const float rwx = R[0] * rx + R[1] * ry + R[2] * rz;
  const float rwy = R[3] * rx + R[4] * ry + R[5] * rz;
  const float rwz = R[6] * rx + R[7] * ry + R[8] * rz;
  const float vx = s.lvel[0] + (s.avel[1] * rwz - s.avel[2] * rwy);
  const float vy = s.lvel[1] + (s.avel[2] * rwx - s.avel[0] * rwz);
  const float vz = s.lvel[2] + (s.avel[0] * rwy - s.avel[1] * rwx);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = R[i] * vx + R[3 + i] * vy + R[6 + i] * vz;
}

// One 240 Hz physics iteration in place on the lane; the pad's contact
// flags OR into any_ground / any_pad.
template <bool NOISY>
__device__ __forceinline__ void physics_iter(Lane& s, const Cmd& u, const float pad[3], const RocketConsts& c,
                                             curandStatePhilox4_32_10_t* rng, float& any_ground, float& any_pad) {
  const float dt = c.dt;
  // 1-2. the pre-burn CoM and the body drag at the drag link
  float com[3], inv_mass;
  mass_com(c, s.fuel * c.b_total_fuel, com, inv_mass);
  float f[3], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float v = s.dlv[i];
    const float sgn = (v > 0.f) ? 1.f : ((v < 0.f) ? -1.f : 0.f);
    f[i] = -sgn * c.drag_const[i] * v * v;
  }
  {
    const float r[3] = {c.drag_pos[0] - com[0], c.drag_pos[1] - com[1], c.drag_pos[2] - com[2]};
    t[0] = r[1] * f[2] - r[2] * f[1];
    t[1] = r[2] * f[0] - r[0] * f[2];
    t[2] = r[0] * f[1] - r[1] * f[0];
  }
  // 3. the finlets
#pragma unroll
  for (int k = 0; k < NUM_FINLETS; ++k) {
    s.act[k] = s.act[k] + c.lag[k] * (u.fin[k] - s.act[k]);
    const fl::Surface S = fl::surface(c, k);
    float fn, fp, qcm;
    fl::surface_normal_forward(S, s.act[k], &s.flv[3 * k], fn, fp, qcm);
    const float r[3] = {c.spos[3 * k] - com[0], c.spos[3 * k + 1] - com[1], c.spos[3 * k + 2] - com[2]};
    fl::add_surface_wrench(S, &c.tu[3 * k], r, fn, fp, qcm, f, t);
  }
  // 4. the gimbal lag and the thrust direction R1(a1) R2(a2) thrust_unit
  float tdir[3] = {c.b_tu[0], c.b_tu[1], c.b_tu[2]};
  {
    s.gbl[0] = s.gbl[0] + c.g_lag * (u.gbl[0] - s.gbl[0]);
    s.gbl[1] = s.gbl[1] + c.g_lag * (u.gbl[1] - s.gbl[1]);
    float h1, ch1, h2, ch2;  // sin and cos of the half angles
    sincosf(0.5f * (s.gbl[0] * c.g_range[0]), &h1, &ch1);
    sincosf(0.5f * (s.gbl[1] * c.g_range[1]), &h2, &ch2);
    rodrigues(c.g_w2, c.g_w2sq, 2.f * h2 * ch2, 2.f * h2 * h2, tdir);
    rodrigues(c.g_w1, c.g_w1sq, 2.f * h1 * ch1, 2.f * h1 * h1, tdir);
  }
  // 5. the booster
  const float lit = (u.ign > 0.5f) ? 1.f : 0.f;
  s.ign = c.b_reignitable ? lit : fmaxf(s.ign, lit);
  const float target = s.ign * (u.pwm * (1.f - c.b_min_ratio) + c.b_min_ratio);
  s.bthr = s.bthr + c.b_lag * (target - s.bthr);
  if constexpr (NOISY) s.bthr = s.bthr + curand_normal(rng) * s.bthr * c.b_noise;
  s.bthr = (s.fuel > 0.f) ? s.bthr : 0.f;
  s.fuel = clampf(s.fuel - s.bthr * c.b_fuel_rate * dt, 0.f, 1.f);
  const float thrust = s.bthr * c.b_max_thrust;
  // 6. the post-burn composite: mass, CoM, the 6 unique inertia entries
  const float fm = s.fuel * c.b_total_fuel;
  mass_com(c, fm, com, inv_mass);
  float ixx = c.i_dry[0] + s.fuel * c.fuel_inertia[0];
  float iyy = c.i_dry[1] + s.fuel * c.fuel_inertia[1];
  float izz = c.i_dry[2] + s.fuel * c.fuel_inertia[2];
  float ixy = 0.f, ixz = 0.f, iyz = 0.f;
#pragma unroll
  for (int k = 0; k < NUM_POINTS; ++k) {
    const float dx = c.pt_pos[3 * k] - com[0], dy = c.pt_pos[3 * k + 1] - com[1], dz = c.pt_pos[3 * k + 2] - com[2];
    const float m = (k == 1) ? fm : c.pt_mass[k];
    ixx += m * (dy * dy + dz * dz);
    iyy += m * (dx * dx + dz * dz);
    izz += m * (dx * dx + dy * dy);
    ixy -= m * dx * dy;
    ixz -= m * dx * dz;
    iyz -= m * dy * dz;
  }
  // 7. the boost wrench about the post-burn CoM
  {
    const float fb[3] = {thrust * tdir[0], thrust * tdir[1], thrust * tdir[2]};
    const float r[3] = {c.b_pos[0] - com[0], c.b_pos[1] - com[1], c.b_pos[2] - com[2]};
#pragma unroll
    for (int i = 0; i < 3; ++i) f[i] += fb[i];
    t[0] += r[1] * fb[2] - r[2] * fb[1];
    t[1] += r[2] * fb[0] - r[0] * fb[2];
    t[2] += r[0] * fb[1] - r[1] * fb[0];
  }
  // 8. the new lagged read from the pre-integration state
  float R[9];
  quadx_math::quat_rotmat(s.quat, R);
  float rcom[3], avb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) rcom[i] = R[3 * i] * com[0] + R[3 * i + 1] * com[1] + R[3 * i + 2] * com[2];
  {
    const float bv[3] = {s.lvel[0] - (s.avel[1] * rcom[2] - s.avel[2] * rcom[1]),
                         s.lvel[1] - (s.avel[2] * rcom[0] - s.avel[0] * rcom[2]),
                         s.lvel[2] - (s.avel[0] * rcom[1] - s.avel[1] * rcom[0])};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      avb[i] = R[i] * s.avel[0] + R[3 + i] * s.avel[1] + R[6 + i] * s.avel[2];
      s.view[i] = avb[i];
      s.view[6 + i] = R[i] * bv[0] + R[3 + i] * bv[1] + R[6 + i] * bv[2];
      s.view[9 + i] = s.pos[i] - rcom[i];
    }
  }
  quadx_math::quat_to_euler(s.quat, &s.view[3]);
#pragma unroll
  for (int k = 0; k < NUM_FINLETS; ++k) local_vel_at(s, R, com, &c.spos[3 * k], &s.flv[3 * k]);
  local_vel_at(s, R, com, c.drag_pos, s.dlv);

  // 9. semi-implicit Euler; dob = I^-1 (t - ob x I ob) by the adjugate
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float fw = R[3 * i] * f[0] + R[3 * i + 1] * f[1] + R[3 * i + 2] * f[2];
    s.lvel[i] = s.lvel[i] + dt * (fw * inv_mass - ((i == 2) ? GRAVITY : 0.f));
  }
  {
    const float iw[3] = {ixx * avb[0] + ixy * avb[1] + ixz * avb[2], ixy * avb[0] + iyy * avb[1] + iyz * avb[2],
                         ixz * avb[0] + iyz * avb[1] + izz * avb[2]};
    const float b0 = t[0] - (avb[1] * iw[2] - avb[2] * iw[1]);
    const float b1 = t[1] - (avb[2] * iw[0] - avb[0] * iw[2]);
    const float b2 = t[2] - (avb[0] * iw[1] - avb[1] * iw[0]);
    const float c00 = iyy * izz - iyz * iyz, c01 = ixz * iyz - ixy * izz, c02 = ixy * iyz - ixz * iyy;
    const float c11 = ixx * izz - ixz * ixz, c12 = ixy * ixz - ixx * iyz, c22 = ixx * iyy - ixy * ixy;
    const float inv_det = 1.f / (ixx * c00 + ixy * c01 + ixz * c02);
    const float ob[3] = {avb[0] + dt * ((c00 * b0 + c01 * b1 + c02 * b2) * inv_det),
                         avb[1] + dt * ((c01 * b0 + c11 * b1 + c12 * b2) * inv_det),
                         avb[2] + dt * ((c02 * b0 + c12 * b1 + c22 * b2) * inv_det)};
#pragma unroll
    for (int i = 0; i < 3; ++i) s.avel[i] = R[3 * i] * ob[0] + R[3 * i + 1] * ob[1] + R[3 * i + 2] * ob[2];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) s.pos[i] = s.pos[i] + dt * s.lvel[i];
  quadx_math::quat_integrate(s.quat, s.avel, dt);

  // 10. the impulse contact against the ground and the raised pad
  quadx_math::quat_rotmat(s.quat, R);
  const float pad_top = pad[2] + PAD_HALF_HEIGHT;
  float depth_sum = 0.f, max_depth = 0.f, cx = 0.f, cy = 0.f, cz = 0.f;
  bool on_pad_pen = false, off_pad_pen = false;
#pragma unroll
  for (int j = 0; j < NUM_CONTACT; ++j) {
    const float px = c.contact_pts[3 * j] - com[0], py = c.contact_pts[3 * j + 1] - com[1],
                pz = c.contact_pts[3 * j + 2] - com[2];
    const float wx = R[0] * px + R[1] * py + R[2] * pz;
    const float wy = R[3] * px + R[4] * py + R[5] * pz;
    const float wz = R[6] * px + R[7] * py + R[8] * pz;
    const float dxp = s.pos[0] + wx - pad[0], dyp = s.pos[1] + wy - pad[1];
    const bool on_pad = dxp * dxp + dyp * dyp < PAD_RADIUS2;
    const float depth = (on_pad ? pad_top : 0.f) - (s.pos[2] + wz);
    const bool pen = depth > 0.f;
    on_pad_pen = on_pad_pen || (on_pad && pen);
    off_pad_pen = off_pad_pen || (!on_pad && pen);
    const float w = fmaxf(depth, 0.f);
    depth_sum += w;
    max_depth = fmaxf(max_depth, depth);
    cx += w * wx;
    cy += w * wy;
    cz += w * wz;
  }
  const bool hit = on_pad_pen || off_pad_pen;
  if (hit) {
    const float inv_w = 1.f / fmaxf(depth_sum, 1e-12f);
    const float rx = cx * inv_w, ry = cy * inv_w, rz = cz * inv_w;
    float iw_inv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      iw_inv[i] = 1.f / (R[3 * i] * R[3 * i] * ixx + R[3 * i + 1] * R[3 * i + 1] * iyy + R[3 * i + 2] * R[3 * i + 2] * izz);
    const float vpx = s.lvel[0] + (s.avel[1] * rz - s.avel[2] * ry);
    const float vpy = s.lvel[1] + (s.avel[2] * rx - s.avel[0] * rz);
    const float vpz = s.lvel[2] + (s.avel[0] * ry - s.avel[1] * rx);
    // the normal impulse (restitution 0), r x z = (ry, -rx, 0)
    const float k_n = inv_mass + (ry * ry * iw_inv[0] + rx * rx * iw_inv[1]);
    const float j_n = (vpz < 0.f) ? fmaxf(-vpz / k_n, 0.f) : 0.f;
    // the Coulomb-clamped friction impulse against the tangential velocity
    const float vt = sqrtf(vpx * vpx + vpy * vpy);
    const float inv_vt = 1.f / fmaxf(vt, 1e-9f);
    const float tx = vpx * inv_vt, ty = vpy * inv_vt;
    const float rxt0 = -rz * ty, rxt1 = rz * tx, rxt2 = rx * ty - ry * tx;
    const float k_t = inv_mass + (rxt0 * rxt0 * iw_inv[0] + rxt1 * rxt1 * iw_inv[1] + rxt2 * rxt2 * iw_inv[2]);
    const float j_t = fminf(vt / k_t, FRICTION * j_n);
    const float jx = -j_t * tx, jy = -j_t * ty, jz = j_n;
    s.lvel[0] += jx * inv_mass;
    s.lvel[1] += jy * inv_mass;
    s.lvel[2] += jz * inv_mass;
    s.avel[0] += (ry * jz - rz * jy) * iw_inv[0];
    s.avel[1] += (rz * jx - rx * jz) * iw_inv[1];
    s.avel[2] += (rx * jy - ry * jx) * iw_inv[2];
    s.pos[2] += fmaxf(max_depth, 0.f);
  }
  s.con = hit ? 1.f : 0.f;
  s.gcon = off_pad_pen ? 1.f : 0.f;
  s.pcon = on_pad_pen ? 1.f : 0.f;
  any_ground = fmaxf(any_ground, s.gcon);
  any_pad = fmaxf(any_pad, s.pcon);
}

__device__ __forceinline__ float norm3(const float v[3]) { return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]); }

template <bool LANDING, bool NOISY, bool SPARSE>
__global__ void __launch_bounds__(THREADS)
    rocket_kernel(const float* __restrict__ in, float* __restrict__ out, int n, const long long* __restrict__ seed,
                  const __grid_constant__ RocketConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // ragged edge
  const size_t ld = static_cast<size_t>(n);
  const float* S = in + i;
  float* O = out + i;
  Lane s;
  float sp[7];
  load_lane(S, ld, s, sp);
  const float pad[3] = {S[PADP * ld], S[(PADP + 1) * ld], S[(PADP + 2) * ld]};
  curandStatePhilox4_32_10_t rng;
  if (NOISY) curand_init(static_cast<unsigned long long>(seed[0]), static_cast<unsigned long long>(i), 0ULL, &rng);
  const Cmd u = control(c, sp);

  if constexpr (!LANDING) {
    // the view and the contact flags are overwritten unread
    float any_ground = 0.f, any_pad = 0.f;
    for (int it = 0; it < c.ratio; ++it) physics_iter<NOISY>(s, u, pad, c, &rng, any_ground, any_pad);
    store_lane(O, ld, s, sp);
    O[RWD * ld] = any_ground;  // the spare rows carry the step's contact ORs
    O[TERM * ld] = any_pad;
    for (int r = TERM + 1; r < PADP; ++r) O[r * ld] = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) O[(PADP + k) * ld] = pad[k];
    for (int r = PFLAG; r < ROWS; ++r) O[r * ld] = 0.f;
  } else {
    // a frozen lane keeps every row, so the view and the flags are read
#pragma unroll
    for (int k = 0; k < 12; ++k) s.view[k] = S[(VIEW + k) * ld];
    s.con = S[CON * ld];
    s.gcon = S[GCON * ld];
    s.pcon = S[PCON * ld];
    float term = S[TERM * ld], trunc = S[TRUNC * ld], fatc = S[FATC * ld], oob = S[OOB * ld], cplt = S[CPLT * ld];
    const float stepc = S[STEP * ld];
    float pflag = S[PFLAG * ld];
    float av[3], lv[3], dist[3], pav[3], plv[3], pdist[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      av[k] = S[(AV + k) * ld];
      lv[k] = S[(LV + k) * ld];
      dist[k] = S[(DIST + k) * ld];
      pav[k] = S[(PAV + k) * ld];
      plv[k] = S[(PLV + k) * ld];
      pdist[k] = S[(PDIST + k) * ld];
    }
    float rwd = 0.f;  // re-armed every agent step
    const bool trunc_hit = stepc > c.max_steps;  // the count before this step's increment

    for (int a = 0; a < c.inner_steps; ++a) {
      if (term + trunc > 0.f) break;  // the done-freeze: the flags never clear
      float any_ground = 0.f, any_pad = 0.f;
      for (int it = 0; it < c.ratio; ++it) physics_iter<NOISY>(s, u, pad, c, &rng, any_ground, any_pad);
      // the memo shift
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pav[k] = av[k];
        plv[k] = lv[k];
        pdist[k] = dist[k];
        av[k] = s.view[k];
        lv[k] = s.view[6 + k];
        dist[k] = s.view[9 + k] - pad[k];
      }
      // the base termination (no reward overwrite)
      if (trunc_hit) trunc = 1.f;
      const bool fatal = any_ground > 0.f || s.view[11] < 0.f;
      const bool out_i = sqrtf(s.view[9] * s.view[9] + s.view[10] * s.view[10]) > c.max_displacement ||
                         s.view[11] > c.ceiling;
      const float tilt = sqrtf(s.view[3] * s.view[3] + s.view[4] * s.view[4]);
      if (!SPARSE) {
        const float d_xy = sqrtf(dist[0] * dist[0] + dist[1] * dist[1]);
        const float pd_xy = sqrtf(pdist[0] * pdist[0] + pdist[1] * pdist[1]);
        rwd += -5.f + 2.f / (d_xy + 0.1f) + 100.f * (pd_xy - d_xy) - fabsf(av[2]) - 3.f * tilt;
      }
      // the pad touchdown, on the previous memos
      const bool on_pad = any_pad > 0.f;
      const float pav_n = norm3(pav), plv_n = norm3(plv);
      const bool hard = pav_n > 0.35f || plv_n > 1.f;
      const bool landed = pav_n < 0.02f && plv_n < 0.02f && tilt < 0.1f;
      const bool fatal_touch = on_pad && hard;
      const bool complete = on_pad && !hard && landed;
      if (on_pad) rwd += 20.f;
      if (complete) rwd += 500.f;
      pflag = any_pad;
      if (fatal || out_i || fatal_touch || complete) term = 1.f;
      if (fatal || fatal_touch) fatc = 1.f;
      if (out_i) oob = 1.f;
      if (complete) cplt = 1.f;
    }

    store_lane(O, ld, s, sp);
    O[RWD * ld] = rwd;
    O[TERM * ld] = term;
    O[TRUNC * ld] = trunc;
    O[FATC * ld] = fatc;
    O[OOB * ld] = oob;
    O[CPLT * ld] = cplt;
    O[STEP * ld] = stepc + 1.f;  // unconditional, after the inner loop
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      O[(PADP + k) * ld] = pad[k];
      O[(AV + k) * ld] = av[k];
      O[(LV + k) * ld] = lv[k];
      O[(DIST + k) * ld] = dist[k];
      O[(PAV + k) * ld] = pav[k];
      O[(PLV + k) * ld] = plv[k];
      O[(PDIST + k) * ld] = pdist[k];
    }
    O[PFLAG * ld] = pflag;
  }
}

struct Launch {
  dim3 grid, block;
  cudaStream_t stream;
  const float* in;
  float* out;
  int n;
  const long long* seed;
  const RocketConsts* c;
};

template <bool LANDING, bool NOISY, bool SPARSE>
void go(const Launch& L) {
  rocket_kernel<LANDING, NOISY, SPARSE><<<L.grid, L.block, 0, L.stream>>>(L.in, L.out, L.n, L.seed, *L.c);
}

int launch(bool landing, const float* in, float* out, int n, const long long* seed, const RocketConsts* consts,
           int noisy, int sparse, void* stream) {
  if (n <= 0 || consts->ratio < 1 || (landing && consts->inner_steps < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{dim3((n + THREADS - 1) / THREADS), dim3(THREADS), static_cast<cudaStream_t>(stream),
                 in, out, n, seed, consts};
  if (!landing) {
    if (noisy) go<false, true, false>(L); else go<false, false, false>(L);
  } else if (noisy) {
    if (sparse) go<true, true, true>(L); else go<true, true, false>(L);
  } else {
    if (sparse) go<true, false, true>(L); else go<true, false, false>(L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in/out: (88, n) f32 row-major on the device; seed: one int64 on the
// device; consts: host pointer, copied into the launch by value. Each
// returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue outside the envelope.
extern "C" int rocket_step(const float* in, float* out, int n, const long long* seed, const RocketConsts* consts,
                           int noisy, int sparse, void* stream) {
  return launch(false, in, out, n, seed, consts, noisy, sparse, stream);
}

extern "C" int rocket_landing_step(const float* in, float* out, int n, const long long* seed,
                                   const RocketConsts* consts, int noisy, int sparse, void* stream) {
  return launch(true, in, out, n, seed, consts, noisy, sparse, stream);
}
