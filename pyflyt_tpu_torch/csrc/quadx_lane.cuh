// Per-thread QuadX aviary-step pieces shared by the QuadX kernels
// (quadx_hover_step.cu, quadx_step.cu, quadx_waypoints_step.cu): the packed
// row layout, the drone's registers (Lane) and the mode-7 cascade's
// (Cascade), the controller at iteration 0 and one physics iteration, each
// with its branches as template parameters so that an instantiation
// carries only its own.
//
// Replaces the per-iteration body of pyflyt_tpu/ops/pallas_quadx.py::
// _build_kernel (:433-680): mode 0 (ang-vel PID, ENU or NED thrust clip),
// 7 (the position cascade, ENU, with the inline pid_bank of :348-366),
// 8 (direct PWM) and 9 (raw motor mix); saturation rescale; throttle lag
// with Philox motor noise; wrench from the lagged read; the ENU or NED
// read; drag on the air velocity under wind; semi-implicit Euler;
// detection-grade ground contact. The Mosaic workarounds of the Pallas
// kernel (polynomial atan2/asin, Box-Muller over the per-core PRNG) are
// not carried over: native atan2f/asinf and curand's Philox normals.
//
// Constants come as a POD struct (HoverConsts, GenericConsts or
// WaypointsConsts) whose vehicle fields have the same names in all, passed
// to the kernels as a __grid_constant__; the functions are templated on
// it. The cascade's gains (lp_*, lv_*, ap_*, zp_*, zv_*) are read in mode 7
// only (HoverConsts keeps them last, after the fields modes 0 and 8 read).
//
// All three kernels run one thread an env and shorten its chain the same
// way: the view only on an aviary step's last physics iteration
// (physics's `read`) and multiplications by reciprocals taken once a
// launch (`Recip`). Groups of 2 and 4 lanes an env measured slower on the
// hover kernel (every lane repeats the rigid body; PERF.md section 6).
#pragma once

#include <cuda_runtime.h>
#include <curand_kernel.h>

#include <cstddef>

#include "quadx_math.cuh"

namespace quadx_lane {

// Row layout of pallas_quadx.py:52-67 (the drone, rows 0-49).
constexpr int POS = 0, QUAT = 3, LVEL = 7, AVEL = 10, VIEW = 13, AVB = 25,
              DRG = 28, THR = 31, PWM = 35, SP = 39, PINT = 43, PPRV = 46,
              CON = 49;
// Mode 7's layout (pallas_quadx.py:69-82): the cascade's 18 rows from row
// 56, in an 80-row state.
constexpr int CASCADE = 56, CASCADE_ROWS = 18, ROWS_MODE7 = 80;
constexpr float GRAVITY = 9.81f;
constexpr float HALF_PI = 1.57079632679489661923f;

// Wind kinds of the generic kernel (pallas_quadx.py:581-621).
enum Wind : int {
  WIND_NONE = 0,          // air velocity = ground velocity
  WIND_GAUSSIAN = 1,      // baked ENU base + clipped unit gusts
  WIND_GAUSSIAN_ENV = 2,  // per-env ENU base from rows 51-53 + gusts
  WIND_SIMPLE = 3,        // log-height thermal + unit noise
};

struct Lane {
  float pos[3], quat[4], lvel[3], avel[3], view[12], avb[3], drg[3];
  float thr[4], pwm[4], pint[3], pprv[3];
  float contact;
};

// The mode-7 cascade's PID registers in row order: per bank its integrals,
// then its previous errors (lin_pos 2, lin_vel 2, ang_pos 3, z_pos 1,
// z_vel 1).
struct Cascade {
  float r[CASCADE_ROWS];
};
constexpr int LP = 0, LV = 4, AP = 8, ZP = 14, ZV = 16;  // first integral of each bank

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float signf(float v) {
  return (v > 0.f) ? 1.f : ((v < 0.f) ? -1.f : 0.f);
}

// Rows 0-49 of env column S (row stride ld) into registers; the setpoint
// goes to sp, which the step reads and writes through unchanged.
__device__ __forceinline__ void load_lane(const float* S, size_t ld, Lane& s,
                                          float sp[4]) {
  for (int k = 0; k < 3; ++k) {
    s.pos[k] = S[(POS + k) * ld];
    s.lvel[k] = S[(LVEL + k) * ld];
    s.avel[k] = S[(AVEL + k) * ld];
    s.avb[k] = S[(AVB + k) * ld];
    s.drg[k] = S[(DRG + k) * ld];
    s.pint[k] = S[(PINT + k) * ld];
    s.pprv[k] = S[(PPRV + k) * ld];
  }
  for (int k = 0; k < 4; ++k) {
    s.quat[k] = S[(QUAT + k) * ld];
    s.thr[k] = S[(THR + k) * ld];
    s.pwm[k] = S[(PWM + k) * ld];
    sp[k] = S[(SP + k) * ld];
  }
  for (int k = 0; k < 12; ++k) s.view[k] = S[(VIEW + k) * ld];
  s.contact = S[CON * ld];
}

__device__ __forceinline__ void store_lane(float* O, size_t ld, const Lane& s,
                                           const float sp[4]) {
  for (int k = 0; k < 3; ++k) {
    O[(POS + k) * ld] = s.pos[k];
    O[(LVEL + k) * ld] = s.lvel[k];
    O[(AVEL + k) * ld] = s.avel[k];
    O[(AVB + k) * ld] = s.avb[k];
    O[(DRG + k) * ld] = s.drg[k];
    O[(PINT + k) * ld] = s.pint[k];
    O[(PPRV + k) * ld] = s.pprv[k];
  }
  for (int k = 0; k < 4; ++k) {
    O[(QUAT + k) * ld] = s.quat[k];
    O[(THR + k) * ld] = s.thr[k];
    O[(PWM + k) * ld] = s.pwm[k];
    O[(SP + k) * ld] = sp[k];
  }
  for (int k = 0; k < 12; ++k) O[(VIEW + k) * ld] = s.view[k];
  O[CON * ld] = s.contact;
}

__device__ __forceinline__ void load_cascade(const float* S, size_t ld, Cascade& k) {
  for (int j = 0; j < CASCADE_ROWS; ++j) k.r[j] = S[(CASCADE + j) * ld];
}

__device__ __forceinline__ void store_cascade(float* O, size_t ld, const Cascade& k) {
  for (int j = 0; j < CASCADE_ROWS; ++j) O[(CASCADE + j) * ld] = k.r[j];
}

// Reciprocals of the constants that control and physics divide by, taken
// once a launch so that each iteration multiplies (every QuadX kernel passes
// them: dividing cost K1-hover 24% on an H100, PERF.md section 6). A null
// `rcp` divides, as the Pallas kernel does (tools/fixedwing_lane_probe.py's
// no_recip variant).
struct Recip {
  float mass, inertia[3], period;
};

template <class C>
__device__ __forceinline__ Recip reciprocals(const C& c) {
  return {1.f / c.mass, {1.f / c.inertia[0], 1.f / c.inertia[1], 1.f / c.inertia[2]}, 1.f / c.period};
}

// One PID bank of K lanes (ops/pid.py::step), its integrals at r[0..K)
// and previous errors at r[K..2K) of the cascade registers; with `rcp` the
// derivative multiplies by the reciprocal of the period.
template <int K>
__device__ __forceinline__ void pid_bank(float* r, const float* kp, const float* ki,
                                         const float* kd, const float* lim, float period,
                                         const Recip* rcp, const float* meas, const float* setp,
                                         float* out) {
  for (int i = 0; i < K; ++i) {
    const float err = setp[i] - meas[i];
    r[i] = clampf(r[i] + ki[i] * err * period, -lim[i], lim[i]);
    const float deriv = rcp ? kd[i] * (err - r[K + i]) * rcp->period : kd[i] * (err - r[K + i]) / period;
    r[K + i] = err;
    out[i] = clampf(kp[i] * err + r[i] + deriv, -lim[i], lim[i]);
  }
}

// The controller at iteration 0 (models/quadx.py::update_control) and the
// saturation rescale (models/quadx.py::saturation_rescale). Mode 7 steps
// the cascade registers `cas` (unused in the other modes); with `rcp` the
// rate PID and the cascade's banks multiply by the reciprocal of the
// period.
template <int MODE, bool NED, class C>
__device__ __forceinline__ void control(Lane& s, const float sp[4], const C& c, Cascade* cas,
                                        const Recip* rcp) {
  float raw[4];
  if constexpr (MODE == 8) {  // direct PWM
    for (int m = 0; m < 4; ++m) raw[m] = sp[m];
  } else if constexpr (MODE == 9) {  // raw motor mix: no PID, no thrust clip
    for (int m = 0; m < 4; ++m) {
      raw[m] = c.motor_map[4 * m + 0] * sp[0] + c.motor_map[4 * m + 1] * sp[1] +
               c.motor_map[4 * m + 2] * sp[2] + c.motor_map[4 * m + 3] * sp[3];
    }
  } else {  // modes 0 and 7: ang-vel PID on the lagged body rates
    static_assert(MODE == 0 || MODE == 7, "modes 0, 7, 8 and 9");
    static_assert(MODE != 7 || !NED, "mode 7 carries the ENU cascade only");
    float a_sp[3] = {sp[0], sp[1], sp[2]};
    float cmd[4];
    if constexpr (MODE == 7) {
      // lin_pos -> yaw frame -> lin_vel -> ENU axis swap -> ang_pos (yaw
      // setpoint third); z_pos -> z_vel (models/quadx.py::_attitude, _height)
      float xy[2];
      pid_bank<2>(cas->r + LP, c.lp_kp, c.lp_ki, c.lp_kd, c.lp_lim, c.period, rcp, &s.view[9], sp, xy);
      float sy, cy;
      sincosf(s.view[5], &sy, &cy);
      const float yf[2] = {cy * xy[0] + sy * xy[1], -sy * xy[0] + cy * xy[1]};
      pid_bank<2>(cas->r + LV, c.lv_kp, c.lv_ki, c.lv_kd, c.lv_lim, c.period, rcp, &s.view[6], yf, xy);
      const float ap_sp[3] = {-xy[1], xy[0], sp[2]};
      pid_bank<3>(cas->r + AP, c.ap_kp, c.ap_ki, c.ap_kd, c.ap_lim, c.period, rcp, &s.view[3], ap_sp, a_sp);
      float z1, z2;
      pid_bank<1>(cas->r + ZP, c.zp_kp, c.zp_ki, c.zp_kd, c.zp_lim, c.period, rcp, &s.view[11], &sp[3], &z1);
      pid_bank<1>(cas->r + ZV, c.zv_kp, c.zv_ki, c.zv_kd, c.zv_lim, c.period, rcp, &s.view[8], &z1, &z2);
      cmd[3] = clampf(z2, 0.f, 1.f);
    } else {
      // NED: clip(z, -1, 0), negate, clip(0, 1) (models/quadx.py:320-323)
      cmd[3] = NED ? clampf(-clampf(sp[3], -1.f, 0.f), 0.f, 1.f) : clampf(sp[3], 0.f, 1.f);
    }
    for (int k = 0; k < 3; ++k) {
      const float err = a_sp[k] - s.view[k];
      s.pint[k] = clampf(s.pint[k] + c.ki[k] * err * c.period, -c.lim[k], c.lim[k]);
      const float deriv = rcp ? c.kd[k] * (err - s.pprv[k]) * rcp->period
                              : c.kd[k] * (err - s.pprv[k]) / c.period;
      s.pprv[k] = err;
      cmd[k] = clampf(c.kp[k] * err + s.pint[k] + deriv, -c.lim[k], c.lim[k]);
    }
    for (int m = 0; m < 4; ++m) {
      raw[m] = c.motor_map[4 * m + 0] * cmd[0] + c.motor_map[4 * m + 1] * cmd[1] +
               c.motor_map[4 * m + 2] * cmd[2] + c.motor_map[4 * m + 3] * cmd[3];
    }
  }
  const float high = fmaxf(fmaxf(raw[0], raw[1]), fmaxf(raw[2], raw[3]));
  const float low = fminf(fminf(raw[0], raw[1]), fminf(raw[2], raw[3]));
  const float pmax = fminf(high, c.max_pwm);
  const float pmin = fmaxf(low, c.min_pwm);
  const float d_add = pmax - low, d_sub = high - pmin;
  const float f_add = (d_add != 0.f) ? (pmin - low) / d_add : 0.f;
  const float f_sub = (d_sub != 0.f) ? (high - pmax) / d_sub : 0.f;
  for (int m = 0; m < 4; ++m) {
    float v = raw[m];
    if (high != low) v = v + f_add * (pmax - v) - f_sub * (v - pmin);
    s.pwm[m] = clampf(v, c.min_pwm, c.max_pwm);
  }
}

// The ENU wind velocity of one physics iteration, from the
// pre-integration state (core/wind.py). Gaussian gusts are drawn only when
// max_gust > 0 (a launch-uniform branch); the NED remap of a gust is
// another draw of the same distribution, so gusts are drawn in ENU.
template <int WIND, class C>
__device__ __forceinline__ void wind_velocity(const Lane& s, const float wbase[3],
                                              const C& c,
                                              curandStatePhilox4_32_10_t* rng,
                                              float w[3]) {
  if constexpr (WIND == WIND_NONE) {
    w[0] = w[1] = w[2] = 0.f;
  } else if constexpr (WIND == WIND_SIMPLE) {
    const float height = fmaxf(s.pos[2] + 1.f, 0.f);
    const float thermal = (height > 0.f) ? logf(fmaxf(height, 1e-12f)) * c.wind_strength : 0.f;
    const float4 g = curand_normal4(rng);
    w[0] = g.x;
    w[1] = g.y;
    w[2] = thermal + g.z;
  } else {
    const float* base = (WIND == WIND_GAUSSIAN) ? c.wind_base : wbase;
    w[0] = base[0];
    w[1] = base[1];
    w[2] = base[2];
    if (c.max_gust > 0.f) {
      const float4 g = curand_normal4(rng);
      w[0] += clampf(g.x, -c.max_gust, c.max_gust);
      w[1] += clampf(g.y, -c.max_gust, c.max_gust);
      w[2] += clampf(g.z, -c.max_gust, c.max_gust);
    }
  }
}

// One physics iteration (models/quadx.py::physics_iter): throttle lag and
// noise, wrench from the lagged read, the new read from the
// pre-integration state (ENU or NED view; drag on R^T (v - wind)),
// semi-implicit Euler, detection-grade ground contact. With `read` false
// the view (Euler angles, body rates, body velocity, lagged position) is
// left as it was: no iteration reads it, so every QuadX kernel computes it
// only on an aviary step's last iteration, whose view the next controller,
// the task update and the env read. The lagged body rates and air
// velocity, which the next iteration's drag reads, are taken every
// iteration. With `rcp` the integration multiplies by the reciprocals of
// the mass and the inertia.
template <bool NOISY, bool NED, bool WIND, class C>
__device__ __forceinline__ void physics(Lane& s, const C& c,
                                        curandStatePhilox4_32_10_t* rng,
                                        const float wind[3], bool read, const Recip* rcp) {
  float nrm[4] = {0.f, 0.f, 0.f, 0.f};
  if (NOISY) {
    const float4 g = curand_normal4(rng);
    nrm[0] = g.x; nrm[1] = g.y; nrm[2] = g.z; nrm[3] = g.w;
  }
  for (int m = 0; m < 4; ++m) {
    s.thr[m] = s.thr[m] + c.lag[m] * (s.pwm[m] - s.thr[m]);
    if (NOISY) s.thr[m] = s.thr[m] + nrm[m] * s.thr[m] * c.noise_ratio[m];
  }

  // wrench from the lagged read (all rotors thrust along body +z)
  float fz = 0.f, tx = 0.f, ty = 0.f, tz = 0.f;
  for (int m = 0; m < 4; ++m) {
    const float rpm = s.thr[m] * c.max_rpm[m];
    const float rc = rpm * rpm * signf(rpm);
    const float f = rc * c.thrust_coef[m];
    fz += f;
    tx += c.mpos_y[m] * f;  // r x F for F along +z
    ty -= c.mpos_x[m] * f;
    tz += rc * c.torque_coef[m];
  }
  float fd[3];
  for (int k = 0; k < 3; ++k)
    fd[k] = -signf(s.drg[k]) * c.drag_xyz[k] * s.drg[k] * s.drg[k];
  const float nc = 1.f - s.contact;  // pqr pseudo-drag is off in contact
  tx -= nc * signf(s.avb[0]) * c.drag_pqr * s.avb[0] * s.avb[0];
  ty -= nc * signf(s.avb[1]) * c.drag_pqr * s.avb[1] * s.avb[1];
  tz -= nc * signf(s.avb[2]) * c.drag_pqr * s.avb[2] * s.avb[2];
  const float fx = fd[0], fy = fd[1];
  fz += fd[2];

  float r[9];
  quadx_math::quat_rotmat(s.quat, r);

  // the new read, from the pre-integration state (one-step sensor latency)
  float lvb[3], avb_new[3], eul[3], drg_new[3];
  const float pos_pre[3] = {s.pos[0], s.pos[1], s.pos[2]};
  for (int k = 0; k < 3; ++k) {
    lvb[k] = r[k] * s.lvel[0] + r[3 + k] * s.lvel[1] + r[6 + k] * s.lvel[2];
    avb_new[k] = r[k] * s.avel[0] + r[3 + k] * s.avel[1] + r[6 + k] * s.avel[2];
  }
  if (WIND) {
    const float a[3] = {s.lvel[0] - wind[0], s.lvel[1] - wind[1], s.lvel[2] - wind[2]};
    for (int k = 0; k < 3; ++k) drg_new[k] = r[k] * a[0] + r[3 + k] * a[1] + r[6 + k] * a[2];
  } else {
    for (int k = 0; k < 3; ++k) drg_new[k] = lvb[k];
  }
  if (read) quadx_math::quat_to_euler(s.quat, eul);

  // semi-implicit Euler (core/integrator.py::step, diagonal inertia)
  const float fw[3] = {r[0] * fx + r[1] * fy + r[2] * fz,
                       r[3] * fx + r[4] * fy + r[5] * fz,
                       r[6] * fx + r[7] * fy + r[8] * fz};
  s.lvel[0] = s.lvel[0] + c.dt * (rcp ? fw[0] * rcp->mass : fw[0] / c.mass);
  s.lvel[1] = s.lvel[1] + c.dt * (rcp ? fw[1] * rcp->mass : fw[1] / c.mass);
  s.lvel[2] = s.lvel[2] + c.dt * ((rcp ? fw[2] * rcp->mass : fw[2] / c.mass) - GRAVITY);
  const float* I = c.inertia;
  const float ob[3] = {avb_new[0], avb_new[1], avb_new[2]};
  const float gyro[3] = {ob[1] * I[2] * ob[2] - ob[2] * I[1] * ob[1],
                         ob[2] * I[0] * ob[0] - ob[0] * I[2] * ob[2],
                         ob[0] * I[1] * ob[1] - ob[1] * I[0] * ob[0]};
  const float tq[3] = {tx, ty, tz};
  float obn[3];
  for (int k = 0; k < 3; ++k)
    obn[k] = ob[k] + c.dt * (rcp ? (tq[k] - gyro[k]) * rcp->inertia[k] : (tq[k] - gyro[k]) / I[k]);
  for (int k = 0; k < 3; ++k)
    s.avel[k] = r[3 * k] * obn[0] + r[3 * k + 1] * obn[1] + r[3 * k + 2] * obn[2];
  for (int k = 0; k < 3; ++k) s.pos[k] = s.pos[k] + c.dt * s.lvel[k];
  quadx_math::quat_integrate(s.quat, s.avel, c.dt);

  // detection-grade ground contact: the box's lowest point along -z
  const float x = s.quat[0], y = s.quat[1], z = s.quat[2], w = s.quat[3];
  const float a20 = fabsf(2.f * (x * z - w * y));
  const float a21 = fabsf(2.f * (y * z + w * x));
  const float a22 = fabsf(1.f - 2.f * (x * x + y * y));
  const float extent = a20 * c.half_ext[0] + a21 * c.half_ext[1] + a22 * c.half_ext[2];
  const float depth = extent - s.pos[2];
  const bool hit = depth > 0.f;
  if (hit) {
    s.pos[2] = s.pos[2] + depth;
    if (s.lvel[2] < 0.f) s.lvel[2] = 0.f;
  }
  s.contact = hit ? 1.f : 0.f;

  // the read: NED remaps the view (models/quadx.py::update_state); the
  // body state and the drag/pqr reads stay ENU/FLU
  if (read) {
    if (NED) {
      s.view[0] = avb_new[0]; s.view[1] = -avb_new[1]; s.view[2] = -avb_new[2];
      s.view[3] = eul[0]; s.view[4] = -eul[1]; s.view[5] = HALF_PI - eul[2];
      s.view[6] = lvb[0]; s.view[7] = -lvb[1]; s.view[8] = -lvb[2];
      s.view[9] = pos_pre[1]; s.view[10] = pos_pre[0]; s.view[11] = -pos_pre[2];
    } else {
      for (int k = 0; k < 3; ++k) {
        s.view[k] = avb_new[k];
        s.view[3 + k] = eul[k];
        s.view[6 + k] = lvb[k];
        s.view[9 + k] = pos_pre[k];
      }
    }
  }
  for (int k = 0; k < 3; ++k) {
    s.avb[k] = avb_new[k];
    s.drg[k] = drg_new[k];
  }
}

}  // namespace quadx_lane
