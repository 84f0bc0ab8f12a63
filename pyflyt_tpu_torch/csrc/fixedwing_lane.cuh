// Per-thread Fixedwing aviary-step pieces: the packed row layout, the
// drone's registers (Lane), one lifting surface's Khan-model forces
// (surface_normal_forward, with the lever arm an argument of the wrench so
// that a vehicle whose lever arms change in flight can call it), the
// control map at iteration 0 (control_cmd) and one physics iteration
// (physics_iter).
//
// Replaces pyflyt_tpu/ops/pallas_fixedwing.py::surface_normal_forward
// (:201-276), _control_cmd (:291-299) and _drone_physics_iter (:302-438):
// actuator and throttle lag with Philox motor noise; the 5-surface aero
// wrench and the puller motor's from the lagged read; the new read from
// the pre-integration state; semi-implicit Euler with the full 3x3 inertia
// and its inverse; detection-grade ground contact (the lowest contact
// point, projection, inelastic vertical stop). The Mosaic workarounds of
// the Pallas kernel are not carried over: native atan2f/asinf/sincosf and
// rsqrtf, and curand's Philox normals for the per-core PRNG.
//
// Constants come as a POD struct whose fields have the names of
// FixedwingConsts in fixedwing_step.cu; the functions are templated on it.
// A surface without a flap (deflection limit 0) skips the flap algebra on
// a warp-uniform branch, where Pallas removed it at trace time.
#pragma once

#include <cuda_runtime.h>
#include <curand_kernel.h>

#include <cstddef>

#include "quadx_math.cuh"

namespace fixedwing_lane {

// Row layout of pallas_fixedwing.py:57-67 (the drone, rows 0-52).
constexpr int POS = 0, QUAT = 3, LVEL = 7, AVEL = 10, VIEW = 13, SLV = 25,
              ACT = 40, THR = 45, SP = 46, CON = 52;
constexpr int NUM_SURFACES = 5, MAX_CONTACT = 8;
constexpr float GRAVITY = 9.81f;
constexpr float HALF_PI = 1.57079632679489661923f;
constexpr float TWO_OVER_PI = 0.63661977236758134308f;

struct Lane {
  float pos[3], quat[4], lvel[3], avel[3], view[12], slv[15], act[5];
  float thr, contact;
};

// One surface's coefficients, gathered from the constants struct.
struct Surface {
  float lu[3], du[3];
  float qa, chord, piar_inv, cl3d, cd0, a0b, asp_b, asn_b, dlim_rad,
      dcl_gain, f2c, clmax_p, clmax_n, stall_c;
};

template <class C>
__device__ __forceinline__ Surface surface(const C& c, int k) {
  Surface S;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    S.lu[i] = c.lu[3 * k + i];
    S.du[i] = c.du[3 * k + i];
  }
  S.qa = c.qa[k];
  S.chord = c.chord[k];
  S.piar_inv = c.piar_inv[k];
  S.cl3d = c.cl3d[k];
  S.cd0 = c.cd0[k];
  S.a0b = c.a0b[k];
  S.asp_b = c.asp_b[k];
  S.asn_b = c.asn_b[k];
  S.dlim_rad = c.dlim_rad[k];
  S.dcl_gain = c.dcl_gain[k];
  S.f2c = c.f2c[k];
  S.clmax_p = c.clmax_p[k];
  S.clmax_n = c.clmax_n[k];
  S.stall_c = c.stall_c[k];
  return S;
}

// Rows 0-45 of env column S (row stride ld) into registers, and the 6
// setpoint rows into sp. Without `full`, the view and the contact flag,
// which the first physics iteration overwrites, are not read.
template <bool FULL>
__device__ __forceinline__ void load_lane(const float* S, size_t ld, Lane& s, float sp[6]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.pos[k] = S[(POS + k) * ld];
    s.lvel[k] = S[(LVEL + k) * ld];
    s.avel[k] = S[(AVEL + k) * ld];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) s.quat[k] = S[(QUAT + k) * ld];
#pragma unroll
  for (int k = 0; k < 15; ++k) s.slv[k] = S[(SLV + k) * ld];
#pragma unroll
  for (int k = 0; k < 5; ++k) s.act[k] = S[(ACT + k) * ld];
  s.thr = S[THR * ld];
#pragma unroll
  for (int k = 0; k < 6; ++k) sp[k] = S[(SP + k) * ld];
  if constexpr (FULL) {
#pragma unroll
    for (int k = 0; k < 12; ++k) s.view[k] = S[(VIEW + k) * ld];
    s.contact = S[CON * ld];
  } else {
    s.contact = 0.f;
  }
}

__device__ __forceinline__ void store_lane(float* O, size_t ld, const Lane& s, const float sp[6]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    O[(POS + k) * ld] = s.pos[k];
    O[(LVEL + k) * ld] = s.lvel[k];
    O[(AVEL + k) * ld] = s.avel[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) O[(QUAT + k) * ld] = s.quat[k];
#pragma unroll
  for (int k = 0; k < 12; ++k) O[(VIEW + k) * ld] = s.view[k];
#pragma unroll
  for (int k = 0; k < 15; ++k) O[(SLV + k) * ld] = s.slv[k];
#pragma unroll
  for (int k = 0; k < 5; ++k) O[(ACT + k) * ld] = s.act[k];
  O[THR * ld] = s.thr;
#pragma unroll
  for (int k = 0; k < 6; ++k) O[(SP + k) * ld] = sp[k];
  O[CON * ld] = s.contact;
}

// sp[idx] over the 6 setpoint registers without a runtime-indexed array
// (which would put them in local memory).
__device__ __forceinline__ float pick6(const float sp[6], int idx) {
  float v = sp[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) v = (idx == j) ? sp[j] : v;
  return v;
}

// The control gate of iteration 0: raw actuator commands (mode -1) or the
// surface-assist map cmd[j] = sign[j] * sp[id[j]] (mode 0).
template <int MODE, class C>
__device__ __forceinline__ void control_cmd(const C& c, const float sp[6], float cmd[6]) {
#pragma unroll
  for (int j = 0; j < 6; ++j) cmd[j] = (MODE == -1) ? sp[j] : c.assist_signs[j] * pick6(sp, c.assist_ids[j]);
}

// One surface's (normal force fn, forward force fp, pitch moment qcm) from
// its lagged body-frame velocity lv and its deflection act: the no-stall
// linear regime between the stall angles, else the post-stall flat plate
// (lifting_surfaces.py:128-183); sin/cos of the angle of attack from the
// velocity components.
__device__ __forceinline__ void surface_normal_forward(const Surface& S, float act, const float lv[3],
                                                       float& fn, float& fp, float& qcm) {
  const float lifting = lv[0] * S.lu[0] + lv[1] * S.lu[1] + lv[2] * S.lu[2];
  const float forward = lv[0] * S.du[0] + lv[1] * S.du[1] + lv[2] * S.du[2];
  const float alpha = atan2f(-lifting, forward);
  float a0 = S.a0b, asp = S.asp_b, asn = S.asn_b, cd90 = 1.98f;
  if (S.dlim_rad != 0.f) {  // the flap branch
    const float defl = act * S.dlim_rad;
    const float dcl = S.dcl_gain * defl;
    const float dclmax = S.f2c * dcl;
    a0 = S.a0b - dcl / S.cl3d;
    asp = a0 + (S.clmax_p + dclmax) / S.cl3d;
    asn = a0 + (S.clmax_n + dclmax) / S.cl3d;
    cd90 = (-4.26e-2f * defl * defl) + (2.1e-1f * defl) + 1.98f;
  }
  float cl, cd, cmo;
  if (asn < alpha && alpha < asp) {  // the no-stall linear regime
    const float cl_lin = S.cl3d * (alpha - a0);
    const float ae = alpha - a0 - cl_lin * S.piar_inv;
    float sae, cae;
    sincosf(ae, &sae, &cae);
    const float ct = S.cd0 * cae;
    const float cn = (cl_lin + ct * sae) / cae;
    cl = cl_lin;
    cd = cn * sae + ct * cae;
    cmo = -cn * (0.25f - 0.175f * (1.f - TWO_OVER_PI * ae));
  } else {  // the post-stall flat plate
    const float aisp = (S.cl3d * (asp - a0)) * S.piar_inv;
    const float aisn = (S.cl3d * (asn - a0)) * S.piar_inv;
    const float tp = fminf(fmaxf((alpha - asp) / (HALF_PI - asp), 0.f), 1.f);
    const float tn = fminf(fmaxf((alpha + HALF_PI) / (asn + HALF_PI), 0.f), 1.f);
    const float ai_st = (alpha > 0.f) ? aisp * (1.f - tp) : tn * aisn;
    const float ae_st = alpha - a0 - ai_st;
    float s_st, c_st;
    sincosf(ae_st, &s_st, &c_st);
    const float cn_st = cd90 * s_st * (1.f / (0.56f + 0.44f * fabsf(s_st)) - S.stall_c);
    const float ct_st = 0.5f * S.cd0 * c_st;
    cl = cn_st * c_st - ct_st * s_st;
    cd = cn_st * s_st + ct_st * c_st;
    cmo = -cn_st * (0.25f - 0.175f * (1.f - TWO_OVER_PI * fabsf(ae_st)));
  }
  const float free2 = lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2];
  const float hyp2 = lifting * lifting + forward * forward;
  const bool degen = hyp2 < 1e-16f;
  const float r_inv = rsqrtf(degen ? 1.f : hyp2);
  const float sina = degen ? 0.f : -lifting * r_inv;
  const float cosa = degen ? 1.f : forward * r_inv;
  const float q = S.qa * free2;
  const float lift = cl * q, drag = cd * q;
  fn = lift * cosa + drag * sina;
  fp = lift * sina - drag * cosa;
  qcm = q * cmo * S.chord;
}

// Adds one surface's wrench onto (f, t): force fn*lu + fp*du, torque
// qcm*tu + r x force, with r the surface's lever arm about the CoM.
__device__ __forceinline__ void add_surface_wrench(const Surface& S, const float tu[3], const float r[3],
                                                   float fn, float fp, float qcm, float f[3], float t[3]) {
  float fs[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    fs[i] = fn * S.lu[i] + fp * S.du[i];
    f[i] += fs[i];
  }
  t[0] += qcm * tu[0] + (r[1] * fs[2] - r[2] * fs[1]);
  t[1] += qcm * tu[1] + (r[2] * fs[0] - r[0] * fs[2]);
  t[2] += qcm * tu[2] + (r[0] * fs[1] - r[1] * fs[0]);
}

// One 240 Hz physics iteration in place on the lane (models/fixedwing.py
// physics_iter): lags (+ noise), the wrench from the lagged read, the new
// read from the pre-integration state, integration, contact. R returns the
// pre-integration body->world rotation, which the waypoints task rotates
// the target deltas with.
template <bool NOISY, class C>
__device__ __forceinline__ void physics_iter(Lane& s, const float cmd[6], const C& c,
                                             curandStatePhilox4_32_10_t* rng, float R[9]) {
  const float dt = c.dt;
#pragma unroll
  for (int k = 0; k < NUM_SURFACES; ++k) s.act[k] = s.act[k] + c.lag[k] * (cmd[k] - s.act[k]);
  s.thr = s.thr + c.mot_lag * (cmd[5] - s.thr);
  if constexpr (NOISY) s.thr = s.thr + curand_normal(rng) * s.thr * c.mot_noise;

  float f[3] = {0.f, 0.f, 0.f}, t[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < NUM_SURFACES; ++k) {
    const Surface S = surface(c, k);
    float fn, fp, qcm;
    surface_normal_forward(S, s.act[k], &s.slv[3 * k], fn, fp, qcm);
    add_surface_wrench(S, &c.tu[3 * k], &c.r_s[3 * k], fn, fp, qcm, f, t);
  }
  const float rpm = s.thr * c.mot_max_rpm;
  const float rc = rpm * rpm * ((rpm > 0.f) ? 1.f : ((rpm < 0.f) ? -1.f : 0.f));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f[i] += rc * c.mot_f[i];
    t[i] += rc * c.mot_t[i];
  }

  quadx_math::quat_rotmat(s.quat, R);
  // the new read from the pre-integration state (one iteration of lag)
  float rcom[3], bv[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) rcom[i] = R[3 * i] * c.com[0] + R[3 * i + 1] * c.com[1] + R[3 * i + 2] * c.com[2];
  bv[0] = s.lvel[0] - (s.avel[1] * rcom[2] - s.avel[2] * rcom[1]);
  bv[1] = s.lvel[1] - (s.avel[2] * rcom[0] - s.avel[0] * rcom[2]);
  bv[2] = s.lvel[2] - (s.avel[0] * rcom[1] - s.avel[1] * rcom[0]);
  float avb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    avb[i] = R[i] * s.avel[0] + R[3 + i] * s.avel[1] + R[6 + i] * s.avel[2];
    s.view[i] = avb[i];
    s.view[6 + i] = R[i] * bv[0] + R[3 + i] * bv[1] + R[6 + i] * bv[2];
    s.view[9 + i] = s.pos[i] - rcom[i];
  }
  quadx_math::quat_to_euler(s.quat, &s.view[3]);
#pragma unroll
  for (int k = 0; k < NUM_SURFACES; ++k) {
    const float* r = &c.r_s[3 * k];
    float rw[3], vs[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) rw[i] = R[3 * i] * r[0] + R[3 * i + 1] * r[1] + R[3 * i + 2] * r[2];
    vs[0] = s.lvel[0] + (s.avel[1] * rw[2] - s.avel[2] * rw[1]);
    vs[1] = s.lvel[1] + (s.avel[2] * rw[0] - s.avel[0] * rw[2]);
    vs[2] = s.lvel[2] + (s.avel[0] * rw[1] - s.avel[1] * rw[0]);
#pragma unroll
    for (int i = 0; i < 3; ++i) s.slv[3 * k + i] = R[i] * vs[0] + R[3 + i] * vs[1] + R[6 + i] * vs[2];
  }

  // semi-implicit Euler; the body-frame Euler equations with the full
  // inertia: dob = I^-1 (t - ob x I ob)
  float fw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) fw[i] = R[3 * i] * f[0] + R[3 * i + 1] * f[1] + R[3 * i + 2] * f[2];
  s.lvel[0] = s.lvel[0] + dt * (fw[0] * c.inv_mass);
  s.lvel[1] = s.lvel[1] + dt * (fw[1] * c.inv_mass);
  s.lvel[2] = s.lvel[2] + dt * (fw[2] * c.inv_mass - GRAVITY);
  float iw[3], rhs[3], ob[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) iw[i] = c.inertia[3 * i] * avb[0] + c.inertia[3 * i + 1] * avb[1] + c.inertia[3 * i + 2] * avb[2];
  rhs[0] = t[0] - (avb[1] * iw[2] - avb[2] * iw[1]);
  rhs[1] = t[1] - (avb[2] * iw[0] - avb[0] * iw[2]);
  rhs[2] = t[2] - (avb[0] * iw[1] - avb[1] * iw[0]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    ob[i] = avb[i] + dt * (c.inv_inertia[3 * i] * rhs[0] + c.inv_inertia[3 * i + 1] * rhs[1] +
                           c.inv_inertia[3 * i + 2] * rhs[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) s.avel[i] = R[3 * i] * ob[0] + R[3 * i + 1] * ob[1] + R[3 * i + 2] * ob[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) s.pos[i] = s.pos[i] + dt * s.lvel[i];
  quadx_math::quat_integrate(s.quat, s.avel, dt);

  // detection-grade ground contact
  const float x = s.quat[0], y = s.quat[1], z = s.quat[2], w = s.quat[3];
  const float c20 = 2.f * (x * z - w * y), c21 = 2.f * (y * z + w * x), c22 = 1.f - 2.f * (x * x + y * y);
  float zmin = c20 * c.contact_pts[0] + c21 * c.contact_pts[1] + c22 * c.contact_pts[2];
#pragma unroll
  for (int j = 1; j < MAX_CONTACT; ++j)
    zmin = fminf(zmin, c20 * c.contact_pts[3 * j] + c21 * c.contact_pts[3 * j + 1] + c22 * c.contact_pts[3 * j + 2]);
  const float depth = -(s.pos[2] + zmin);
  const bool hit = depth > 0.f;
  if (hit) {
    s.pos[2] = s.pos[2] + depth;
    if (s.lvel[2] < 0.f) s.lvel[2] = 0.f;
  }
  s.contact = hit ? 1.f : 0.f;
}

}  // namespace fixedwing_lane
