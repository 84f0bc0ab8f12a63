// One full QuadX-Hover agent step for a batch of envs, one thread per env.
//
// Replaces pyflyt_tpu/ops/pallas_quadx.py::packed_hover_step (the
// env-fused variant of _build_kernel), modes 0 and 8, ENU: `inner_steps`
// aviary steps of `ratio` physics iterations each (ang-vel PID or direct
// PWM at iteration 0; saturation rescale; throttle lag + Philox motor
// noise; wrench from the lagged read; semi-implicit Euler; detection-grade
// ground contact), then the hover reward, termination, truncation and the
// done-freeze.
//
// What bounds it on an H100: each env reads 55 of its 56 f32 rows once
// (not the reward row, re-armed below) and writes all 56 (444 B), about
// 2 kFLOP of f32 work per env, so at 8192 envs the bytes (3.64 MB,
// ~1.09 us at 3.35 TB/s) bound it and a launch (a few us)
// costs more than either. Design for that: state is SoA (ROWS, N), so a
// warp's load of one row is one coalesced 128 B transaction; the whole
// agent step runs in registers with one read and one write per row; the
// vehicle and task constants arrive as one POD struct by value (no
// constant-memory upload, no per-vehicle rebuild); the mode, the noise and
// the sparse reward are template parameters, so each instantiation carries
// only its own branch. Blocks are 64 threads, so 8192 envs spread over 128
// of the 132 SMs rather than 32: each thread's long dependent chain, not
// instruction throughput, sets the time, so spreading the warps helps. Any
// N is allowed: the last block masks its tail.
//
// Semantics kept from the Pallas kernel: the reward is re-armed to -0.1
// every agent step and overwritten with -100 on a fatal event; truncation
// uses the step count before the increment; the step count stays f32; a
// lane that was done before an aviary step keeps its snapshot (done-freeze,
// written as a select so a frozen lane's old values pass through bit for
// bit); contact is detection-grade (lift out of the ground, stop downward
// velocity).
#include <cuda_runtime.h>
#include <curand_kernel.h>

#include <cstddef>

#include "quadx_math.cuh"

namespace {

// Row layout of pallas_quadx.py:52-67 and :207-213.
constexpr int POS = 0, QUAT = 3, LVEL = 7, AVEL = 10, VIEW = 13, AVB = 25,
              DRG = 28, THR = 31, PWM = 35, SP = 39, PINT = 43, PPRV = 46,
              CON = 49, RWD = 50, TERM = 51, TRUNC = 52, COLL = 53, OOB = 54,
              STEP = 55;
constexpr float GRAVITY = 9.81f;
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
};

namespace {

struct Lane {
  float pos[3], quat[4], lvel[3], avel[3], view[12], avb[3], drg[3];
  float thr[4], pwm[4], pint[3], pprv[3];
  float contact, rwd, term, trunc, coll, oob;
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float signf(float v) {
  return (v > 0.f) ? 1.f : ((v < 0.f) ? -1.f : 0.f);
}

template <int MODE>
__device__ __forceinline__ void control(Lane& s, const float sp[4],
                                        const HoverConsts& c) {
  float raw[4];
  if (MODE == 8) {
    for (int m = 0; m < 4; ++m) raw[m] = sp[m];
  } else {  // mode 0: ang-vel PID on the lagged body rates, clipped thrust
    float cmd[4];
    for (int k = 0; k < 3; ++k) {
      const float err = sp[k] - s.view[k];
      s.pint[k] = clampf(s.pint[k] + c.ki[k] * err * c.period, -c.lim[k], c.lim[k]);
      const float deriv = c.kd[k] * (err - s.pprv[k]) / c.period;
      s.pprv[k] = err;
      cmd[k] = clampf(c.kp[k] * err + s.pint[k] + deriv, -c.lim[k], c.lim[k]);
    }
    cmd[3] = clampf(sp[3], 0.f, 1.f);
    for (int m = 0; m < 4; ++m) {
      raw[m] = c.motor_map[4 * m + 0] * cmd[0] + c.motor_map[4 * m + 1] * cmd[1] +
               c.motor_map[4 * m + 2] * cmd[2] + c.motor_map[4 * m + 3] * cmd[3];
    }
  }
  // saturation rescale (models/quadx.py::saturation_rescale)
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

template <bool NOISY>
__device__ __forceinline__ void physics(Lane& s, const HoverConsts& c,
                                        curandStatePhilox4_32_10_t* rng) {
  // throttle lag + multiplicative noise (ops/motors.py::throttle_update)
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
  float lvb[3], avb_new[3], eul[3];
  const float pos_pre[3] = {s.pos[0], s.pos[1], s.pos[2]};
  for (int k = 0; k < 3; ++k) {
    lvb[k] = r[k] * s.lvel[0] + r[3 + k] * s.lvel[1] + r[6 + k] * s.lvel[2];
    avb_new[k] = r[k] * s.avel[0] + r[3 + k] * s.avel[1] + r[6 + k] * s.avel[2];
  }
  quadx_math::quat_to_euler(s.quat, eul);

  // semi-implicit Euler (core/integrator.py::step, diagonal inertia)
  const float fw[3] = {r[0] * fx + r[1] * fy + r[2] * fz,
                       r[3] * fx + r[4] * fy + r[5] * fz,
                       r[6] * fx + r[7] * fy + r[8] * fz};
  s.lvel[0] = s.lvel[0] + c.dt * (fw[0] / c.mass);
  s.lvel[1] = s.lvel[1] + c.dt * (fw[1] / c.mass);
  s.lvel[2] = s.lvel[2] + c.dt * (fw[2] / c.mass - GRAVITY);
  const float* I = c.inertia;
  const float ob[3] = {avb_new[0], avb_new[1], avb_new[2]};
  const float gyro[3] = {ob[1] * I[2] * ob[2] - ob[2] * I[1] * ob[1],
                         ob[2] * I[0] * ob[0] - ob[0] * I[2] * ob[2],
                         ob[0] * I[1] * ob[1] - ob[1] * I[0] * ob[0]};
  const float tq[3] = {tx, ty, tz};
  float obn[3];
  for (int k = 0; k < 3; ++k) obn[k] = ob[k] + c.dt * ((tq[k] - gyro[k]) / I[k]);
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

  for (int k = 0; k < 3; ++k) {
    s.view[k] = avb_new[k];
    s.view[3 + k] = eul[k];
    s.view[6 + k] = lvb[k];
    s.view[9 + k] = pos_pre[k];
    s.avb[k] = avb_new[k];
    s.drg[k] = lvb[k];
  }
}

template <int MODE, bool NOISY, bool SPARSE>
__global__ void __launch_bounds__(THREADS)
    hover_step_kernel(const float* __restrict__ in, float* __restrict__ out,
                      int n, const long long* __restrict__ seed, HoverConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // ragged edge
  const size_t ld = static_cast<size_t>(n);
  const float* S = in + i;
  Lane s;
  for (int k = 0; k < 3; ++k) {
    s.pos[k] = S[(POS + k) * ld];
    s.lvel[k] = S[(LVEL + k) * ld];
    s.avel[k] = S[(AVEL + k) * ld];
    s.avb[k] = S[(AVB + k) * ld];
    s.drg[k] = S[(DRG + k) * ld];
    s.pint[k] = S[(PINT + k) * ld];
    s.pprv[k] = S[(PPRV + k) * ld];
  }
  float sp[4];
  for (int k = 0; k < 4; ++k) {
    s.quat[k] = S[(QUAT + k) * ld];
    s.thr[k] = S[(THR + k) * ld];
    s.pwm[k] = S[(PWM + k) * ld];
    sp[k] = S[(SP + k) * ld];
  }
  for (int k = 0; k < 12; ++k) s.view[k] = S[(VIEW + k) * ld];
  s.contact = S[CON * ld];
  s.term = S[TERM * ld];
  s.trunc = S[TRUNC * ld];
  s.coll = S[COLL * ld];
  s.oob = S[OOB * ld];
  const float stepc = S[STEP * ld];
  s.rwd = -0.1f;  // re-armed every agent step
  const float trunc_hit = (stepc > c.max_steps) ? 1.f : 0.f;  // pre-increment

  curandStatePhilox4_32_10_t rng;
  if (NOISY) curand_init(static_cast<unsigned long long>(seed[0]),
                         static_cast<unsigned long long>(i), 0ULL, &rng);

  for (int a = 0; a < c.inner_steps; ++a) {
    const bool frozen = fminf(fmaxf(s.term, s.trunc), 1.f) > 0.f;
    Lane nw = s;
    float any_contact = 0.f;
    for (int it = 0; it < c.ratio; ++it) {
      if (it == 0) control<MODE>(nw, sp, c);
      physics<NOISY>(nw, c, &rng);
      any_contact = fmaxf(any_contact, nw.contact);
    }
    // hover task update on the lagged position
    const float vx = nw.view[9], vy = nw.view[10], vz = nw.view[11];
    const float oob_i = (vx * vx + vy * vy + vz * vz > c.dome2) ? 1.f : 0.f;
    const float fatal = fmaxf(any_contact, oob_i);
    nw.trunc = fminf(nw.trunc + trunc_hit, 1.f);
    float rwd = (fatal > 0.f) ? -100.f : nw.rwd;
    if (!SPARSE) {
      const float dz = vz - 1.f;
      rwd = rwd - sqrtf(vx * vx + vy * vy + dz * dz) -
            sqrtf(nw.view[3] * nw.view[3] + nw.view[4] * nw.view[4]) + 1.f;
    }
    nw.rwd = rwd;
    nw.term = fminf(nw.term + fatal, 1.f);
    nw.coll = fminf(nw.coll + any_contact, 1.f);
    nw.oob = fminf(nw.oob + oob_i, 1.f);
    if (!frozen) s = nw;  // done-freeze as a select
  }

  float* O = out + i;
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
  O[RWD * ld] = s.rwd;
  O[TERM * ld] = s.term;
  O[TRUNC * ld] = s.trunc;
  O[COLL * ld] = s.coll;
  O[OOB * ld] = s.oob;
  O[STEP * ld] = stepc + 1.f;  // unconditional, after the inner loop
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

// in/out: (56, n) f32 row-major on the device; seed: one int64 on the
// device; consts: host pointer, copied into the launch by value.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int quadx_hover_step(const float* in, float* out, int n,
                                const long long* seed, const HoverConsts* consts,
                                int mode, int noisy, int sparse, void* stream) {
  if (n <= 0 || (mode != 0 && mode != 8)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(THREADS);
  const dim3 grid((n + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    launch_noisy<0>(noisy != 0, sparse != 0, grid, block, s, in, out, n, seed, *consts);
  else
    launch_noisy<8>(noisy != 0, sparse != 0, grid, block, s, in, out, n, seed, *consts);
  return static_cast<int>(cudaGetLastError());
}
