// Kernel K6: the Rocket steps for a batch of envs, a group of lanes per env.
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
// TFLOP/s. So bytes bound it, and the dependent chain of a physics
// iteration costs more than either: one thread an env ran 33.5-35.6 us for
// the agent step and 13.3-13.9 us for the aviary step (PERF.md section 6),
// two warps an SM, the four finlets (an atan2f and a sincosf each), the
// 7-point inertia and the 12-point contact in a row.
//
// Design: SoA rows; each env a group of GROUP lanes, and an item k of each
// kind on lane k % GROUP: the links (finlet k < 4 with its lag, its 3 read
// rows, its Khan surface from fixedwing_lane.cuh and its wrench about the
// pre-burn CoM; the drag link, k = 4, with its 3 read rows and the body
// drag), the 7 point masses' inertia terms and the 12 contact points. The
// 6-float wrench and the 6 inertia entries are summed by
// fixedwing_lane::group_sum's butterfly on the group's mask, the contact's
// depth and centroid sums by the same, the deepest point by a max
// butterfly and the on- and off-pad flags by a ballot; then every lane
// takes the impulse. The booster and the gimbal, the mass and CoM, the
// rigid body, the view and the landing task run in every lane on the same
// bits: float adds and fmaxf commute, so the butterflies leave every lane
// with the same sums and no broadcast is needed; every lane draws the
// env's one Philox stream (the subsequence the env index), so the noise
// is that of one thread an env. A lane reads its items' constants where
// it uses them, from the launch's constants copied into shared memory, so
// they hold no registers; of the landing memos only the previous ones are
// held (the current ones are the view's). The view is computed only on an
// aviary step's last physics iteration, the one whose read is read. Each
// row is read by the lanes that need it and written once, by the lane
// that owns it (fixedwing_lane::put's rule, a link's rows by its lane);
// the rows passed through (the setpoint, the pad, the step count) are
// written at once and not held. GROUP = 4 (measured against 2 and 8 by
// tools/fixedwing_lane_probe.py: every lane repeats the rigid body, so at
// 8 the repeated instructions cost more than the shorter chain buys) gives
// 512 blocks of 64 threads at 8192 envs, 4 an SM, all resident at once
// at any register count (4 x 64 x 255 < 65,536). The constants are one
// POD struct passed by value as a __grid_constant__; LANDING, NOISY and
// SPARSE are template parameters (2 + 4 instantiations); a masked ragged
// tail leaves a whole group at a time.
// The done-freeze leaves the inner loop: termination and truncation never
// clear and every lane of a group holds the same flags, so a group done
// before an aviary step leaves together and keeps its registers untouched
// for the rest of the agent step (the Pallas kernel's snapshot-select).
// The Mosaic workarounds are dropped: native atan2f/asinf in the Euler
// read and sincosf in the Rodrigues pair. Measured against one thread per
// env on an H100: PERF.md section 6.
#include <cuda_runtime.h>
#include <curand_kernel.h>

#include <climits>
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
constexpr int NUM_LINKS = NUM_FINLETS + 1;  // the finlets 0-3 and the drag link, 4
constexpr float GRAVITY = 9.81f;
constexpr float PAD_RADIUS2 = 4.f;     // the pad's radius, 2 m, squared
constexpr float PAD_HALF_HEIGHT = 0.05f;
constexpr float FRICTION = 0.5f;
constexpr int THREADS = 64;  // per block: whole warps, so no group straddles two
constexpr int GROUP = 4;     // lanes per env (probe: group)
// a lane's share: links, point masses and contact points lane + GROUP j
constexpr int LINK_SLOTS = (NUM_LINKS + GROUP - 1) / GROUP;
constexpr int POINT_SLOTS = (NUM_POINTS + GROUP - 1) / GROUP;
constexpr int CONTACT_SLOTS = (NUM_CONTACT + GROUP - 1) / GROUP;

// What lane `lane` of a group owns: the links lane + GROUP j (a finlet
// below 4, the drag link at 4), the point masses lane + GROUP j and the
// contact points lane + GROUP j. Their constants are read where they are
// used, from the launch's constants copied into the block's shared memory
// (one address a lane of a group; the groups of a warp read the same), so
// they hold no registers across the step; the rocket's lever arms are
// taken about a CoM that moves with the fuel, so a link's position is read,
// not its arm. A slot past the last item owns nothing.

// One lane's registers: the rigid body, its view, the booster and gimbal,
// the contact flags and the composite CoM, the same in every lane of the
// group; the lagged read rows and deflections of this lane's links.
struct Lane {
  float pos[3], quat[4], lvel[3], avel[3], view[12];
  float lv[LINK_SLOTS][3], act[LINK_SLOTS];
  float fuel, bthr, ign, gbl[2], con, gcon, pcon;
  float com[3], inv_mass;  // the composite CoM and 1 / mass at the current fuel
};

// The agent step's commands other than the finlets' (finlet_cmd's),
// constant over it: the ignition, the clipped throttle and gimbal.
struct Cmd {
  float ign, pwm, gbl[2];
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// The largest x of the group and whether any lane's p holds: every lane
// ends with the same value (fmaxf commutes as the adds do).
__device__ __forceinline__ float group_max(float x, unsigned mask) {
#pragma unroll
  for (int o = 1; o < GROUP; o <<= 1) x = fmaxf(x, __shfl_xor_sync(mask, x, o));
  return x;
}

__device__ __forceinline__ bool group_any(bool p, unsigned mask) { return (__ballot_sync(mask, p) & mask) != 0u; }

// The finlet commands of this lane's links (the control map of
// models/rocket.py update_control, clipped), constant over the agent step.
__device__ __forceinline__ void finlet_cmd(const RocketConsts& c, int lane, const float sp[7],
                                           float cmd[LINK_SLOTS]) {
#pragma unroll
  for (int j = 0; j < LINK_SLOTS; ++j) {
    const int k = lane + GROUP * j;
    const int kf = (k < NUM_FINLETS) ? k : NUM_FINLETS - 1;
    cmd[j] = clampf(c.finlet_map[3 * kf] * sp[0] + c.finlet_map[3 * kf + 1] * sp[1] +
                    c.finlet_map[3 * kf + 2] * sp[2], -1.f, 1.f);
  }
}

// The rows of env column S (row stride ld) that lane `lane` needs. Without
// FULL, the view and the contact flags, which the step overwrites unread,
// are not read.
template <bool FULL>
__device__ __forceinline__ void load_lane(const float* S, size_t ld, int lane, Lane& s) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.pos[k] = S[(POS + k) * ld];
    s.lvel[k] = S[(LVEL + k) * ld];
    s.avel[k] = S[(AVEL + k) * ld];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) s.quat[k] = S[(QUAT + k) * ld];
#pragma unroll
  for (int j = 0; j < LINK_SLOTS; ++j) {
    const int k = lane + GROUP * j;
    const int row = (k < NUM_FINLETS) ? FLV + 3 * k : DLV;
#pragma unroll
    for (int i = 0; i < 3; ++i) s.lv[j][i] = (k < NUM_LINKS) ? S[(row + i) * ld] : 0.f;
    s.act[j] = (k < NUM_FINLETS) ? S[(ACT + k) * ld] : 0.f;
  }
  s.fuel = S[FUEL * ld];
  s.bthr = S[BTHR * ld];
  s.ign = S[IGN * ld];
  s.gbl[0] = S[GBL * ld];
  s.gbl[1] = S[(GBL + 1) * ld];
  if constexpr (FULL) {
#pragma unroll
    for (int k = 0; k < 12; ++k) s.view[k] = S[(VIEW + k) * ld];
    s.con = S[CON * ld];
    s.gcon = S[GCON * ld];
    s.pcon = S[PCON * ld];
  } else {
#pragma unroll
    for (int k = 0; k < 12; ++k) s.view[k] = 0.f;
    s.con = s.gcon = s.pcon = 0.f;
  }
}

// Rows 0-58 but the setpoint's, each written once: a link's rows by the
// link's lane, any other row by fixedwing_lane::put's rule (lane row % G).
__device__ __forceinline__ void store_lane(float* O, size_t ld, int lane, const Lane& s) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    fl::put<GROUP>(O, ld, lane, POS + k, s.pos[k]);
    fl::put<GROUP>(O, ld, lane, LVEL + k, s.lvel[k]);
    fl::put<GROUP>(O, ld, lane, AVEL + k, s.avel[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) fl::put<GROUP>(O, ld, lane, QUAT + k, s.quat[k]);
#pragma unroll
  for (int k = 0; k < 12; ++k) fl::put<GROUP>(O, ld, lane, VIEW + k, s.view[k]);
#pragma unroll
  for (int j = 0; j < LINK_SLOTS; ++j) {
    const int k = lane + GROUP * j;
    if (k < NUM_LINKS) {
      const int row = (k < NUM_FINLETS) ? FLV + 3 * k : DLV;
#pragma unroll
      for (int i = 0; i < 3; ++i) O[(row + i) * ld] = s.lv[j][i];
    }
    if (k < NUM_FINLETS) O[(ACT + k) * ld] = s.act[j];
  }
  fl::put<GROUP>(O, ld, lane, FUEL, s.fuel);
  fl::put<GROUP>(O, ld, lane, BTHR, s.bthr);
  fl::put<GROUP>(O, ld, lane, IGN, s.ign);
  fl::put<GROUP>(O, ld, lane, GBL, s.gbl[0]);
  fl::put<GROUP>(O, ld, lane, GBL + 1, s.gbl[1]);
  fl::put<GROUP>(O, ld, lane, CON, s.con);
  fl::put<GROUP>(O, ld, lane, GCON, s.gcon);
  fl::put<GROUP>(O, ld, lane, PCON, s.pcon);
}

// The control map (models/rocket.py update_control plus the clips of
// physics_iter) but the finlets' (finlet_cmd): constant over the agent step.
__device__ __forceinline__ Cmd control(const float sp[7]) {
  Cmd u;
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

// One 240 Hz physics iteration in place on the group; the pad's contact
// flags OR into any_ground / any_pad. With `read`, also the view (only the
// last iteration of an aviary step is read). Every lane of the group calls
// it with the same `read`; its shuffles use the group's mask only. c: the
// launch's constants (the reads every lane makes alike); sc: their copy in
// shared memory (the reads of this lane's links, points and contacts).
template <bool NOISY>
__device__ __forceinline__ void physics_iter(Lane& s, int lane, const float cmd[LINK_SLOTS], const Cmd& u,
                                             const float pad[3], const RocketConsts& c, const RocketConsts& sc,
                                             unsigned mask, curandStatePhilox4_32_10_t* rng, bool read,
                                             float& any_ground, float& any_pad) {
  const float dt = c.dt;
  // 1-3. the pre-burn CoM; this lane's links' wrench about it (a finlet's
  // Khan surface after its lag, or the drag link's body drag), summed over
  // the group
  float com[3] = {s.com[0], s.com[1], s.com[2]}, inv_mass = s.inv_mass;  // the fuel has not moved since
  float f[3] = {0.f, 0.f, 0.f}, t[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < LINK_SLOTS; ++j) {
    const int k = lane + GROUP * j;
    if (k < NUM_FINLETS) {
      const float r[3] = {sc.spos[3 * k] - com[0], sc.spos[3 * k + 1] - com[1], sc.spos[3 * k + 2] - com[2]};
      s.act[j] = s.act[j] + sc.lag[k] * (cmd[j] - s.act[j]);
      const fl::Surface S = fl::surface(sc, k);
      float fn, fp, qcm;
      fl::surface_normal_forward(S, s.act[j], s.lv[j], fn, fp, qcm);
      fl::add_surface_wrench(S, &sc.tu[3 * k], r, fn, fp, qcm, f, t);
    } else if (k < NUM_LINKS) {
      const float r[3] = {c.drag_pos[0] - com[0], c.drag_pos[1] - com[1], c.drag_pos[2] - com[2]};
      float fd[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float v = s.lv[j][i];
        const float sgn = (v > 0.f) ? 1.f : ((v < 0.f) ? -1.f : 0.f);
        fd[i] = -sgn * c.drag_const[i] * v * v;
        f[i] += fd[i];
      }
      t[0] += r[1] * fd[2] - r[2] * fd[1];
      t[1] += r[2] * fd[0] - r[0] * fd[2];
      t[2] += r[0] * fd[1] - r[1] * fd[0];
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f[i] = fl::group_sum<GROUP>(f[i], mask);
    t[i] = fl::group_sum<GROUP>(t[i], mask);
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
  // 5. the booster, every lane on the env's one Philox stream
  const float lit = (u.ign > 0.5f) ? 1.f : 0.f;
  s.ign = c.b_reignitable ? lit : fmaxf(s.ign, lit);
  const float target = s.ign * (u.pwm * (1.f - c.b_min_ratio) + c.b_min_ratio);
  s.bthr = s.bthr + c.b_lag * (target - s.bthr);
  if constexpr (NOISY) s.bthr = s.bthr + curand_normal(rng) * s.bthr * c.b_noise;
  s.bthr = (s.fuel > 0.f) ? s.bthr : 0.f;
  s.fuel = clampf(s.fuel - s.bthr * c.b_fuel_rate * dt, 0.f, 1.f);
  const float thrust = s.bthr * c.b_max_thrust;
  // 6. the post-burn composite: mass, CoM, the 6 unique inertia entries,
  // this lane's point masses' terms summed over the group
  const float fm = s.fuel * c.b_total_fuel;
  mass_com(c, fm, com, inv_mass);
#pragma unroll
  for (int i = 0; i < 3; ++i) s.com[i] = com[i];
  s.inv_mass = inv_mass;
  float pi[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // xx, yy, zz, xy, xz, yz
#pragma unroll
  for (int j = 0; j < POINT_SLOTS; ++j) {
    const int k = lane + GROUP * j;
    if (k < NUM_POINTS) {
      const float dx = sc.pt_pos[3 * k] - com[0], dy = sc.pt_pos[3 * k + 1] - com[1], dz = sc.pt_pos[3 * k + 2] - com[2];
      const float m = (k == 1) ? fm : sc.pt_mass[k];
      pi[0] += m * (dy * dy + dz * dz);
      pi[1] += m * (dx * dx + dz * dz);
      pi[2] += m * (dx * dx + dy * dy);
      pi[3] -= m * dx * dy;
      pi[4] -= m * dx * dz;
      pi[5] -= m * dy * dz;
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) pi[k] = fl::group_sum<GROUP>(pi[k], mask);
  const float ixx = c.i_dry[0] + s.fuel * c.fuel_inertia[0] + pi[0];
  const float iyy = c.i_dry[1] + s.fuel * c.fuel_inertia[1] + pi[1];
  const float izz = c.i_dry[2] + s.fuel * c.fuel_inertia[2] + pi[2];
  const float ixy = pi[3], ixz = pi[4], iyz = pi[5];
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
  // 8. the new lagged read from the pre-integration state: the view (on
  // the read iteration) and this lane's links' body-frame velocities
  float R[9];
  quadx_math::quat_rotmat(s.quat, R);
  float avb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) avb[i] = R[i] * s.avel[0] + R[3 + i] * s.avel[1] + R[6 + i] * s.avel[2];
  if (read) {
    float rcom[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) rcom[i] = R[3 * i] * com[0] + R[3 * i + 1] * com[1] + R[3 * i + 2] * com[2];
    const float bv[3] = {s.lvel[0] - (s.avel[1] * rcom[2] - s.avel[2] * rcom[1]),
                         s.lvel[1] - (s.avel[2] * rcom[0] - s.avel[0] * rcom[2]),
                         s.lvel[2] - (s.avel[0] * rcom[1] - s.avel[1] * rcom[0])};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s.view[i] = avb[i];
      s.view[6 + i] = R[i] * bv[0] + R[3 + i] * bv[1] + R[6 + i] * bv[2];
      s.view[9 + i] = s.pos[i] - rcom[i];
    }
    quadx_math::quat_to_euler(s.quat, &s.view[3]);
  }
#pragma unroll
  for (int j = 0; j < LINK_SLOTS; ++j) {
    const int k = lane + GROUP * j;
    if (k < NUM_FINLETS)
      local_vel_at(s, R, com, &sc.spos[3 * k], s.lv[j]);
    else if (k < NUM_LINKS)
      local_vel_at(s, R, com, c.drag_pos, s.lv[j]);
  }

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

  // 10. the impulse contact against the ground and the raised pad: this
  // lane's contact points, their depth sums and centroid sums, the deepest
  // point and the on/off-pad flags over the group
  quadx_math::quat_rotmat(s.quat, R);
  const float pad_top = pad[2] + PAD_HALF_HEIGHT;
  float depth_sum = 0.f, max_depth = 0.f, cx = 0.f, cy = 0.f, cz = 0.f;
  bool on_pad_pen = false, off_pad_pen = false;
#pragma unroll
  for (int j = 0; j < CONTACT_SLOTS; ++j) {
    const int k = lane + GROUP * j;
    if (k < NUM_CONTACT) {
      const float px = sc.contact_pts[3 * k] - com[0], py = sc.contact_pts[3 * k + 1] - com[1],
                  pz = sc.contact_pts[3 * k + 2] - com[2];
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
  }
  depth_sum = fl::group_sum<GROUP>(depth_sum, mask);
  cx = fl::group_sum<GROUP>(cx, mask);
  cy = fl::group_sum<GROUP>(cy, mask);
  cz = fl::group_sum<GROUP>(cz, mask);
  max_depth = group_max(max_depth, mask);
  on_pad_pen = group_any(on_pad_pen, mask);
  off_pad_pen = group_any(off_pad_pen, mask);
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
  // the constants that lanes read at their own items' indices, in shared
  // memory: one address a lane of a group, the same for a warp's groups
  __shared__ RocketConsts sc;
  for (int w = threadIdx.x; w < static_cast<int>(sizeof(RocketConsts) / 4); w += THREADS)
    reinterpret_cast<int*>(&sc)[w] = reinterpret_cast<const int*>(&c)[w];
  __syncthreads();
  const int tid = blockIdx.x * THREADS + threadIdx.x;
  const int i = tid / GROUP, lane = tid % GROUP;
  if (i >= n) return;  // ragged edge: whole groups leave
  const unsigned mask = fl::group_mask<GROUP>();
  const size_t ld = static_cast<size_t>(n);
  const float* S = in + i;
  float* O = out + i;
  Lane s;
  load_lane<LANDING>(S, ld, lane, s);
  mass_com(c, s.fuel * c.b_total_fuel, s.com, s.inv_mass);
  float sp[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    sp[k] = S[(SP + k) * ld];
    fl::put<GROUP>(O, ld, lane, SP + k, sp[k]);  // passed through: stored now, not held
  }
  const float pad[3] = {S[PADP * ld], S[(PADP + 1) * ld], S[(PADP + 2) * ld]};
#pragma unroll
  for (int k = 0; k < 3; ++k) fl::put<GROUP>(O, ld, lane, PADP + k, pad[k]);
  curandStatePhilox4_32_10_t rng;
  if (NOISY)  // every lane of the group on the env's one stream
    curand_init(static_cast<unsigned long long>(seed[0]), static_cast<unsigned long long>(i), 0ULL, &rng);
  const Cmd u = control(sp);
  float cmd[LINK_SLOTS];
  finlet_cmd(c, lane, sp, cmd);

  if constexpr (!LANDING) {
    float any_ground = 0.f, any_pad = 0.f;
    for (int it = 0; it < c.ratio; ++it) {
      const bool read = it == c.ratio - 1;  // probe: read
      physics_iter<NOISY>(s, lane, cmd, u, pad, c, sc, mask, &rng, read, any_ground, any_pad);
    }
    store_lane(O, ld, lane, s);
    fl::put<GROUP>(O, ld, lane, RWD, any_ground);  // the spare rows carry the step's contact ORs
    fl::put<GROUP>(O, ld, lane, TERM, any_pad);
#pragma unroll
    for (int r = TERM + 1; r < PADP; ++r) fl::put<GROUP>(O, ld, lane, r, 0.f);
#pragma unroll
    for (int r = PFLAG; r < ROWS; ++r) fl::put<GROUP>(O, ld, lane, r, 0.f);
  } else {
    // a frozen lane keeps every row, so the view and the flags were read
    float term = S[TERM * ld], trunc = S[TRUNC * ld], fatc = S[FATC * ld], oob = S[OOB * ld], cplt = S[CPLT * ld];
    const float stepc = S[STEP * ld];
    fl::put<GROUP>(O, ld, lane, STEP, stepc + 1.f);  // unconditional, after the inner loop
    float pflag = S[PFLAG * ld];
    // The memos: after an aviary step the current ones (ang_vel, lin_vel,
    // pad distance) are the view's, so only the previous ones are held;
    // until the first step both are the input's rows.
    float pav[3], plv[3], pdist[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pav[k] = S[(PAV + k) * ld];
      plv[k] = S[(PLV + k) * ld];
      pdist[k] = S[(PDIST + k) * ld];
    }
    bool stepped = false;
    float rwd = 0.f;  // re-armed every agent step
    const bool trunc_hit = stepc > c.max_steps;  // the count before this step's increment

    for (int a = 0; a < c.inner_steps; ++a) {
      // the done-freeze: the flags never clear and every lane of a group
      // holds the same, so a group done before an aviary step leaves it
      // together and its registers are not touched again
      if (term + trunc > 0.f) break;
      // the memo shift: the current memos become the previous ones
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pav[k] = stepped ? s.view[k] : S[(AV + k) * ld];
        plv[k] = stepped ? s.view[6 + k] : S[(LV + k) * ld];
        pdist[k] = stepped ? s.view[9 + k] - pad[k] : S[(DIST + k) * ld];
      }
      float any_ground = 0.f, any_pad = 0.f;
      for (int it = 0; it < c.ratio; ++it) {
        const bool read = it == c.ratio - 1;  // probe: read
        physics_iter<NOISY>(s, lane, cmd, u, pad, c, sc, mask, &rng, read, any_ground, any_pad);
      }
      stepped = true;
      const float dist[3] = {s.view[9] - pad[0], s.view[10] - pad[1], s.view[11] - pad[2]};
      // the base termination (no reward overwrite)
      if (trunc_hit) trunc = 1.f;
      const bool fatal = any_ground > 0.f || s.view[11] < 0.f;
      const bool out_i = sqrtf(s.view[9] * s.view[9] + s.view[10] * s.view[10]) > c.max_displacement ||
                         s.view[11] > c.ceiling;
      const float tilt = sqrtf(s.view[3] * s.view[3] + s.view[4] * s.view[4]);
      if (!SPARSE) {
        const float d_xy = sqrtf(dist[0] * dist[0] + dist[1] * dist[1]);
        const float pd_xy = sqrtf(pdist[0] * pdist[0] + pdist[1] * pdist[1]);
        rwd += -5.f + 2.f / (d_xy + 0.1f) + 100.f * (pd_xy - d_xy) - fabsf(s.view[2]) - 3.f * tilt;
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

    store_lane(O, ld, lane, s);
    fl::put<GROUP>(O, ld, lane, RWD, rwd);
    fl::put<GROUP>(O, ld, lane, TERM, term);
    fl::put<GROUP>(O, ld, lane, TRUNC, trunc);
    fl::put<GROUP>(O, ld, lane, FATC, fatc);
    fl::put<GROUP>(O, ld, lane, OOB, oob);
    fl::put<GROUP>(O, ld, lane, CPLT, cplt);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      fl::put<GROUP>(O, ld, lane, AV + k, stepped ? s.view[k] : S[(AV + k) * ld]);
      fl::put<GROUP>(O, ld, lane, LV + k, stepped ? s.view[6 + k] : S[(LV + k) * ld]);
      fl::put<GROUP>(O, ld, lane, DIST + k, stepped ? s.view[9 + k] - pad[k] : S[(DIST + k) * ld]);
      fl::put<GROUP>(O, ld, lane, PAV + k, pav[k]);
      fl::put<GROUP>(O, ld, lane, PLV + k, plv[k]);
      fl::put<GROUP>(O, ld, lane, PDIST + k, pdist[k]);
    }
    fl::put<GROUP>(O, ld, lane, PFLAG, pflag);
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
  if (n <= 0 || n > (INT_MAX - THREADS) / GROUP || consts->ratio < 1 || (landing && consts->inner_steps < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{dim3((n * GROUP + THREADS - 1) / THREADS), dim3(THREADS), static_cast<cudaStream_t>(stream),
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
