// Fixedwing aviary-step pieces for a drone spread over a group of G lanes:
// the packed row layout, one lifting surface's Khan-model forces
// (surface_normal_forward, with the lever arm an argument of the wrench so
// that a vehicle whose lever arms change in flight can call it), the
// control map at iteration 0 (control_cmd), what each lane of a group owns
// (Role) and holds (GroupLane), the group's loads and stores, and one
// physics iteration (physics_iter).
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
// The group. With one thread per drone, K5 and K7 ran one warp per SM
// sub-partition at their stock widths (4096 envs, 8192 drones), and each
// thread paid the full latency of five surfaces in a row (an atan2f, a
// sincosf, an rsqrtf and, on a flapped surface, three IEEE divisions
// each). Here lane j of a drone's group owns surfaces j, j + G, ... (one
// each when G >= 5): their constants, actuator lags, body-frame read rows
// and wrenches. The 5-surface wrench is summed by a log2(G)-level
// __shfl_xor_sync butterfly on the group's own mask; float addition
// commutes, so every lane ends with the same bits, adds the motor's wrench
// itself (every lane draws the drone's Philox noise, the stream of one
// thread per drone) and integrates the rigid body itself, with no
// broadcast; each lane then reads only its own surfaces' new velocities
// (a spare lane, past the fifth surface, computes none). The view
// (euler angles, body-frame velocities, base position) is computed only on
// the iteration whose read is read: the last of an aviary step. G is a
// power of two with 2G <= 32 (K7's pairs of groups share a warp) and a
// block is a whole number of warps, so no group straddles two warps.
//
// Constants come as a POD struct whose fields have the names of
// FixedwingConsts in fixedwing_step.cu; the functions are templated on it.
// The rocket (rocket_step.cu) takes surface, surface_normal_forward,
// add_surface_wrench, group_mask, group_sum and put, with its own map of
// items to lanes (its lever arms move with the fuel).
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
// velocity components. A surface without a flap (deflection limit 0)
// skips the flap algebra, where Pallas removed it at trace time.
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

// ---------------------------------------------------------------------------
// the group
// ---------------------------------------------------------------------------

// The lanes of this thread's group in its warp.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  static_assert(G >= 2 && 2 * G <= 32 && (G & (G - 1)) == 0, "G: a power of two, 2G <= 32");
  return ((1u << G) - 1u) << ((threadIdx.x & 31u) & ~static_cast<unsigned>(G - 1));
}

// x summed over the group's lanes: a log2(G)-level butterfly. Lane a adds
// lane a ^ o's partial to its own where that lane adds a's to its own;
// float addition commutes, so every lane ends with the same bits.
template <int G>
__device__ __forceinline__ float group_sum(float x, unsigned mask) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) x += __shfl_xor_sync(mask, x, o);
  return x;
}

// What lane `lane` of a group owns: surfaces lane + G j (SLOTS of them;
// owns[j] is false past the fifth, on a spare lane, whose slot is filled
// from the fifth surface and never used) with their constants and
// commands. SLOTS is 1 at G = 8; G = 4 is the measured alternative.
template <int G>
struct Role {
  static constexpr int SLOTS = (NUM_SURFACES + G - 1) / G;
  bool owns[SLOTS];
  Surface S[SLOTS];
  float tu[SLOTS][3], r[SLOTS][3], lag[SLOTS], cmd[SLOTS];
};

template <int G, class C>
__device__ __forceinline__ Role<G> make_role(const C& c, int lane, const float cmd[6]) {
  Role<G> o;
#pragma unroll
  for (int j = 0; j < Role<G>::SLOTS; ++j) {
    const int k = lane + G * j;
    o.owns[j] = k < NUM_SURFACES;
    const int kk = o.owns[j] ? k : NUM_SURFACES - 1;
    o.S[j] = surface(c, kk);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      o.tu[j][i] = c.tu[3 * kk + i];
      o.r[j][i] = c.r_s[3 * kk + i];
    }
    o.lag[j] = c.lag[kk];
    o.cmd[j] = pick6(cmd, kk);
  }
  return o;
}

// One lane's registers: the rigid body, its read and the throttle, the
// same in every lane of the group; the lag states and read rows of this
// lane's surfaces.
template <int G>
struct GroupLane {
  float pos[3], quat[4], lvel[3], avel[3], view[12];
  float slv[Role<G>::SLOTS][3], act[Role<G>::SLOTS];
  float thr, contact;
};

// The rows of env column S (row stride ld) that lane `lane` needs, into
// its registers, and the 6 setpoint rows into sp. Without FULL, the view
// and the contact flag, which the first physics iteration overwrites, are
// not read.
template <int G, bool FULL>
__device__ __forceinline__ void load_lane(const float* S, size_t ld, int lane, GroupLane<G>& s, float sp[6]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.pos[k] = S[(POS + k) * ld];
    s.lvel[k] = S[(LVEL + k) * ld];
    s.avel[k] = S[(AVEL + k) * ld];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) s.quat[k] = S[(QUAT + k) * ld];
#pragma unroll
  for (int j = 0; j < Role<G>::SLOTS; ++j) {
    const int k = lane + G * j;
    const bool own = k < NUM_SURFACES;
#pragma unroll
    for (int i = 0; i < 3; ++i) s.slv[j][i] = own ? S[(SLV + 3 * k + i) * ld] : 0.f;
    s.act[j] = own ? S[(ACT + k) * ld] : 0.f;
  }
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

// Row `row` of column O, a row every lane of the group holds, written by
// the one lane that owns it: lane row % G.
template <int G>
__device__ __forceinline__ void put(float* O, size_t ld, int lane, int row, float v) {
  if (lane == row % G) O[row * ld] = v;
}

// Rows 0-52, each written once: the surface rows and the throttle by
// their owners, the rest by put's rule.
template <int G>
__device__ __forceinline__ void store_lane(float* O, size_t ld, int lane, const GroupLane<G>& s, const float sp[6]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    put<G>(O, ld, lane, POS + k, s.pos[k]);
    put<G>(O, ld, lane, LVEL + k, s.lvel[k]);
    put<G>(O, ld, lane, AVEL + k, s.avel[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) put<G>(O, ld, lane, QUAT + k, s.quat[k]);
#pragma unroll
  for (int k = 0; k < 12; ++k) put<G>(O, ld, lane, VIEW + k, s.view[k]);
#pragma unroll
  for (int j = 0; j < Role<G>::SLOTS; ++j) {
    const int k = lane + G * j;
    if (k < NUM_SURFACES) {
#pragma unroll
      for (int i = 0; i < 3; ++i) O[(SLV + 3 * k + i) * ld] = s.slv[j][i];
      O[(ACT + k) * ld] = s.act[j];
    }
  }
  put<G>(O, ld, lane, THR, s.thr);
#pragma unroll
  for (int k = 0; k < 6; ++k) put<G>(O, ld, lane, SP + k, sp[k]);
  put<G>(O, ld, lane, CON, s.contact);
}

// One 240 Hz physics iteration in place on the group (models/fixedwing.py
// physics_iter): lags (+ noise), the wrench from the lagged read, the new
// read from the pre-integration state, integration, contact. With `read`,
// also the view (only the last iteration of an aviary step is read). R
// returns the pre-integration body->world rotation, which the waypoints
// task rotates the target deltas with. Every lane of the group calls it
// with the same `read`; its shuffles use the group's mask only. cmd_thr is
// the throttle command.
template <int G, bool NOISY, class C>
__device__ __forceinline__ void physics_iter(GroupLane<G>& s, const Role<G>& o, float cmd_thr, const C& c,
                                             unsigned mask, curandStatePhilox4_32_10_t* rng, bool read,
                                             float R[9]) {
  const float dt = c.dt;
  float f[3] = {0.f, 0.f, 0.f}, t[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < Role<G>::SLOTS; ++j) {
    if (o.owns[j]) {
      s.act[j] = s.act[j] + o.lag[j] * (o.cmd[j] - s.act[j]);
      float fn, fp, qcm;
      surface_normal_forward(o.S[j], s.act[j], s.slv[j], fn, fp, qcm);
      add_surface_wrench(o.S[j], o.tu[j], o.r[j], fn, fp, qcm, f, t);
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f[i] = group_sum<G>(f[i], mask);
    t[i] = group_sum<G>(t[i], mask);
  }
  s.thr = s.thr + c.mot_lag * (cmd_thr - s.thr);
  if constexpr (NOISY) s.thr = s.thr + curand_normal(rng) * s.thr * c.mot_noise;
  const float rpm = s.thr * c.mot_max_rpm;
  const float rc = rpm * rpm * ((rpm > 0.f) ? 1.f : ((rpm < 0.f) ? -1.f : 0.f));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f[i] += rc * c.mot_f[i];
    t[i] += rc * c.mot_t[i];
  }

  quadx_math::quat_rotmat(s.quat, R);
  float avb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) avb[i] = R[i] * s.avel[0] + R[3 + i] * s.avel[1] + R[6 + i] * s.avel[2];
  if (read) {  // the view from the pre-integration state
    float rcom[3], bv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) rcom[i] = R[3 * i] * c.com[0] + R[3 * i + 1] * c.com[1] + R[3 * i + 2] * c.com[2];
    bv[0] = s.lvel[0] - (s.avel[1] * rcom[2] - s.avel[2] * rcom[1]);
    bv[1] = s.lvel[1] - (s.avel[2] * rcom[0] - s.avel[0] * rcom[2]);
    bv[2] = s.lvel[2] - (s.avel[0] * rcom[1] - s.avel[1] * rcom[0]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s.view[i] = avb[i];
      s.view[6 + i] = R[i] * bv[0] + R[3 + i] * bv[1] + R[6 + i] * bv[2];
      s.view[9 + i] = s.pos[i] - rcom[i];
    }
    quadx_math::quat_to_euler(s.quat, &s.view[3]);
  }
  // this lane's surfaces' new read (one iteration of lag)
#pragma unroll
  for (int j = 0; j < Role<G>::SLOTS; ++j) {
    if (o.owns[j]) {
      const float* r = o.r[j];
      float rw[3], vs[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) rw[i] = R[3 * i] * r[0] + R[3 * i + 1] * r[1] + R[3 * i + 2] * r[2];
      vs[0] = s.lvel[0] + (s.avel[1] * rw[2] - s.avel[2] * rw[1]);
      vs[1] = s.lvel[1] + (s.avel[2] * rw[0] - s.avel[0] * rw[2]);
      vs[2] = s.lvel[2] + (s.avel[0] * rw[1] - s.avel[1] * rw[0]);
#pragma unroll
      for (int i = 0; i < 3; ++i) s.slv[j][i] = R[i] * vs[0] + R[3 + i] * vs[1] + R[6 + i] * vs[2];
    }
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
