// Per-thread quaternion and waypoint helpers shared by the vehicle kernels.
//
// Replaces the register-level helpers of pyflyt_tpu/ops/pallas_math.py
// (quat_rotmat, quat_to_euler, quat_integrate, waypoint_track). The Mosaic workarounds
// there (polynomial atan2/asin) are not carried over: CUDA has native
// atan2f/asinf, so euler angles here agree with core/math.py to f32
// rounding. The plain twins of these functions are the tensor versions in
// pyflyt_tpu_torch/ops/cuda_math.py.
#pragma once

#include <math.h>

namespace quadx_math {

// Body->world rotation matrix, row-major r[0..8] = (r00, r01, ..., r22).
__device__ __forceinline__ void quat_rotmat(const float q[4], float r[9]) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  r[0] = 1.f - 2.f * (y * y + z * z);
  r[1] = 2.f * (x * y - w * z);
  r[2] = 2.f * (x * z + w * y);
  r[3] = 2.f * (x * y + w * z);
  r[4] = 1.f - 2.f * (x * x + z * z);
  r[5] = 2.f * (y * z - w * x);
  r[6] = 2.f * (x * z - w * y);
  r[7] = 2.f * (y * z + w * x);
  r[8] = 1.f - 2.f * (x * x + y * y);
}

// (roll, pitch, yaw), PyBullet's extraction (core/math.py::quat_to_euler).
__device__ __forceinline__ void quat_to_euler(const float q[4], float e[3]) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  e[0] = atan2f(2.f * (w * x + y * z), 1.f - 2.f * (x * x + y * y));
  e[1] = asinf(fminf(fmaxf(2.f * (w * y - z * x), -1.f), 1.f));
  e[2] = atan2f(2.f * (w * z + x * y), 1.f - 2.f * (y * y + z * z));
}

// Exact exponential-map step under world angular velocity w for dt, with
// the Taylor branch near |w dt| = 0 (core/math.py::quat_integrate).
__device__ __forceinline__ void quat_integrate(float q[4], const float w[3],
                                               float dt) {
  const float thx = w[0] * dt, thy = w[1] * dt, thz = w[2] * dt;
  const float sq = thx * thx + thy * thy + thz * thz;
  const bool small = sq < 1e-16f;
  const float ang = sqrtf(small ? 1.f : sq);
  const float half = 0.5f * ang;
  const float sinc = small ? 0.5f - sq / 48.f : sinf(half) / ang;
  const float ch = small ? 1.f - sq / 8.f : cosf(half);
  const float dx = thx * sinc, dy = thy * sinc, dz = thz * sinc, dw = ch;
  const float x = q[0], y = q[1], z = q[2], qw = q[3];
  const float nx = dw * x + dx * qw + dy * z - dz * y;
  const float ny = dw * y - dx * z + dy * qw + dz * x;
  const float nz = dw * z + dx * y - dy * x + dz * qw;
  const float nw = dw * qw - dx * x - dy * y - dz * z;
  const float norm = sqrtf(nx * nx + ny * ny + nz * nz + nw * nw);
  const float inv = 1.f / fmaxf(norm, 1e-12f);
  q[0] = nx * inv;
  q[1] = ny * inv;
  q[2] = nz * inv;
  q[3] = nw * inv;
}

// Waypoint tracking on the cyclically rolled target rows
// (pallas_math.py::waypoint_track, envs/utils/waypoints.py semantics):
// body-frame deltas R^T (target - lp) of the first nt <= 4 targets, the
// distance to the current one (ndist; the old memo goes to odist), the
// delta observation with the rows past the remaining count zeroed, the
// reach (distance under goal while targets remain) and, on a reach, the
// roll that brings the next target to the front. The loops run over the 4
// slots with compile-time indices, so the registers stay registers; nt
// only masks them. The first target goes to slot nt - 1 by a select in
// every slot: a store under `k == nt - 1` let the compiler address it as
// slot nt - 1, a runtime index, which put the caller's whole register set
// in local memory (a 416-byte frame in the waypoints kernel).
// Returns the progress odist - ndist; reached and all_reached are 0/1.
__device__ __forceinline__ float waypoint_track(const float R[9], const float lp[3],
                                                float tgt[12], float& rem, float& ndist,
                                                float& odist, float tdlt[12], int nt,
                                                float goal, float& reached,
                                                float& all_reached) {
  float d[12];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float dx = tgt[3 * k] - lp[0], dy = tgt[3 * k + 1] - lp[1], dz = tgt[3 * k + 2] - lp[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) d[3 * k + i] = R[i] * dx + R[3 + i] * dy + R[6 + i] * dz;
  }
  const float nd = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  odist = ndist;
  ndist = nd;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float keep = (k < nt && rem > k + 0.5f) ? 1.f : 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) tdlt[3 * k + i] = (k < nt) ? d[3 * k + i] * keep : 0.f;
  }
  reached = (nd < goal && rem > 0.5f) ? 1.f : 0.f;
  if (reached > 0.f) {
    const float first[3] = {tgt[0], tgt[1], tgt[2]};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k < nt - 1) {
#pragma unroll
        for (int i = 0; i < 3; ++i) tgt[3 * k + i] = tgt[3 * k + 3 + i];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool last = k == nt - 1;
#pragma unroll
      for (int i = 0; i < 3; ++i) tgt[3 * k + i] = last ? first[i] : tgt[3 * k + i];
    }
  }
  rem = rem - reached;
  all_reached = (rem < 0.5f) ? 1.f : 0.f;
  return odist - nd;
}

}  // namespace quadx_math
