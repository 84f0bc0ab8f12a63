// Kernel K7: the 2-agent Fixedwing dogfight agent step, a group of lanes per drone.
//
// Replaces pyflyt_tpu/ops/pallas_dogfight.py::_build_kernel (:90-256) behind
// packed_dogfight_step (:259). One launch runs the whole agent step of N
// arenas (envs/ma_fixedwing_dogfight.py step): `inner_steps` aviary steps
// (4 at the stock 30 Hz), each
//   1. the engagement reward from the PREVIOUS aviary step's memos (the
//      reference's reward memo fires before its state memo): closing
//      distance, angle progress and 3 / (angle + 0.1), off when SPARSE,
//      plus 30 per hit scored and -20 per hit taken;
//   2. `ratio` physics iterations of fixedwing_lane.cuh (K5's), the mode-0
//      assist map computed once per agent step;
//   3. the forward vector from the lagged euler read, the gun 0.35 m behind
//      the CG, the separation to the partner's gun, the distance, the cone
//      angle (acosf of the clipped cosine) and the hit; health -=
//      damage_per_hit per partner hit; the memo shift;
//   4. mutual-sphere and ground collision, out-of-dome, -3000 for each, and
//      the termination / truncation / reward / flag accumulation;
// then the step count + 1. There is no done-freeze, as in the Pallas
// kernel: the env masks actions and ends arenas itself.
//
// Layout (pallas_dogfight.py:53-78), (72, 2N) f32: the fixedwing drone
// bank in rows 0-52, then health, angle, previous angle, hit, distance,
// previous distance, termination, truncation, reward, collision flag,
// out-of-bounds flag, other-dead, step count (53-65), padding (66-71).
// Columns are arena-interleaved: column 2a + m is drone m of arena a.
//
// What bounds it on an H100: at the league's 8192 drones each reads 48
// rows and writes 72, 3.9 MB, 1.17 us at 3.35 TB/s; its ~9.5 kFLOP (8
// physics iterations of 5 surfaces plus the engagement) is 1.16 us at 67
// TFLOP/s. The two are even; the dependent chain of a physics iteration
// (an atan2f and a sincosf per surface, the rigid body's rotation and
// integration) costs more than either, as in K5.
//
// Design: each drone a group of GROUP lanes running fixedwing_lane.cuh's
// grouped iteration, as K5 does (a surface a lane, the wrench summed by a
// butterfly on the group's mask, the motor and the rigid body in every
// lane), so 8192 drones make 65,536 threads in 1024 blocks of 64,
// about four warps on each SM sub-partition where one thread per drone
// left one warp alone with the chain of five surfaces. Every lane of a
// group holds the drone's state and memos and runs the engagement itself;
// the partner drone's group is the adjacent one of the same warp, and
// every value of the partner (its previous hit, gun position, new hit,
// body position) comes over __shfl_xor_sync(FULL, x, GROUP), where the TPU
// rolled sublanes by 4. The shuffles need every lane of the warp present:
// blocks of 64 threads hold whole warps, so no pair of groups straddles
// two, a group past the edge clamps its column, computes and skips the
// store, and no thread leaves the loop early. Each row is written once, by
// the lane that owns it. The constants come as one __grid_constant__
// struct; NOISY and SPARSE are template parameters; Philox motor noise,
// every lane of a group on the drone's stream (the subsequence its global
// index, as before). The Mosaic workarounds are dropped: native acosf (for pi/2 -
// asin), atan2f, asinf and sincosf. Measured against one thread per drone
// on an H100: PERF.md section 6.
#include <cuda_runtime.h>
#include <curand_kernel.h>

#include <climits>
#include <cstddef>

#include "fixedwing_lane.cuh"

// Must match pyflyt_tpu_torch/ops/cuda_dogfight.py::DogfightConsts field by
// field: cuda_fixedwing.FixedwingConsts' fields, then the engagement's
// (tests/test_torch_dogfight.py holds the two layouts equal).
struct DogfightConsts {
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
  float goal;          // unused here (the waypoints task's)
  int ratio;           // physics iterations per aviary step
  int inner_steps;     // aviary steps per agent step
  int num_targets;     // unused here (the waypoints task's)
  float lethal_angle;  // rad
  float lethal_distance;
  float damage_per_hit;
  float crad2;         // (2 collision_radius)^2
};

namespace {

namespace fl = fixedwing_lane;

// Engagement and episode rows (pallas_dogfight.py:63-76).
constexpr int HP = 53, ANG = 54, PANG = 55, HIT = 56, DIST = 57, PDIST = 58, TERM = 59, TRUNC = 60,
              RWD = 61, COLLF = 62, OOBF = 63, OTHD = 64, STEPC = 65;
constexpr int ROWS = 72;
constexpr int THREADS = 64;  // per block: whole warps, so no pair of groups straddles two
constexpr int GROUP = 8;     // lanes per drone (probe: group)
// 8192 drones x GROUP lanes are 1024 blocks, 7.8 an SM: all resident at once
// when a thread takes at most 65,536 / (8 x THREADS) = 128 registers
constexpr int MIN_BLOCKS = 8;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float GUN_OFFSET = 0.35f;

// The partner drone's value: the adjacent group (column 2a + 1 - m).
__device__ __forceinline__ float partner(float x) { return __shfl_xor_sync(FULL_MASK, x, GROUP); }

template <bool NOISY, bool SPARSE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)  // probe: min_blocks
    dogfight_kernel(const float* __restrict__ in, float* __restrict__ out, int n,
                    const long long* __restrict__ seed, const __grid_constant__ DogfightConsts c) {
  const int tid = blockIdx.x * THREADS + threadIdx.x;
  const int i = tid / GROUP, lane = tid % GROUP;
  // n is even, so a group past the edge and its partner are both past it:
  // they compute on the last column and store nothing
  const bool live = i < n;
  const unsigned mask = fl::group_mask<GROUP>();
  const size_t ld = static_cast<size_t>(n);
  const float* S = in + (live ? i : n - 1);
  fl::GroupLane<GROUP> s;
  float sp[6], cmd[6], R[9];
  fl::load_lane<GROUP, false>(S, ld, lane, s, sp);
  float hp = S[HP * ld], ang = S[ANG * ld], pang = S[PANG * ld], hit = S[HIT * ld];
  float dist = S[DIST * ld], pdist = S[PDIST * ld];
  const float othd = S[OTHD * ld], stepc = S[STEPC * ld];
  float term = 0.f, trunc = 0.f, rwd = 0.f, collf = 0.f, oobf = 0.f;
  const float trunc_hit = (stepc > c.max_steps) ? 1.f : 0.f;  // the count before this step's increment

  curandStatePhilox4_32_10_t rng;
  if (NOISY)  // every lane of the group on the drone's one stream
    curand_init(static_cast<unsigned long long>(seed[0]), static_cast<unsigned long long>(i), 0ULL, &rng);
  fl::control_cmd<0>(c, sp, cmd);  // the setpoint is constant over the agent step
  const fl::Role<GROUP> o = fl::make_role<GROUP>(c, lane, cmd);

  for (int a = 0; a < c.inner_steps; ++a) {
    // 1. the reward from the previous aviary step's memos
    float r = 0.f;
    if (!SPARSE) {
      const float in_range = (dist < c.lethal_distance) ? 1.f : 0.f;
      const float closing = fmaxf(pdist - dist, 0.f);
      const float chasing = (fabsf(ang) < fl::HALF_PI) ? 1.f : 0.f;
      r = closing * (1.f - in_range) * chasing + (pang - ang) * in_range * 10.f + 3.f / (ang + 0.1f) * in_range;
    }
    r = r + 30.f * hit - 20.f * partner(hit);

    // 2. the physics
    float contact = 0.f;
    for (int it = 0; it < c.ratio; ++it) {
      const bool read = it == c.ratio - 1;  // probe: read
      fl::physics_iter<GROUP, NOISY>(s, o, cmd[5], c, mask, &rng, read, R);
      contact = fmaxf(contact, s.contact);
    }

    // 3. the gun cone from the lagged euler read
    float sin_p, cos_p, sin_y, cos_y;
    sincosf(s.view[4], &sin_p, &cos_p);
    sincosf(s.view[5], &sin_y, &cos_y);
    const float fwd[3] = {cos_y * cos_p, sin_y * cos_p, -sin_p};
    float sep[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float gun = s.view[9 + k] - GUN_OFFSET * fwd[k];
      sep[k] = partner(gun) - gun;
    }
    const float dist_new = sqrtf(sep[0] * sep[0] + sep[1] * sep[1] + sep[2] * sep[2]);
    // a true division, as the plain env's: acosf near 1 turns one rounding
    // of the cosine into ~3e-4 rad, which 3 / (angle + 0.1) amplifies
    const float dot = sep[0] * fwd[0] + sep[1] * fwd[1] + sep[2] * fwd[2];
    const float ang_new = acosf(fminf(fmaxf(__fdiv_rn(dot, fmaxf(dist_new, 1e-8f)), -1.f), 1.f));
    const float hit_new =
        (ang_new < c.lethal_angle && dist_new < c.lethal_distance && fabsf(ang_new) < fl::HALF_PI) ? 1.f : 0.f;
    hp = hp - c.damage_per_hit * partner(hit_new);
    pang = ang;
    ang = ang_new;
    pdist = dist;
    dist = dist_new;
    hit = hit_new;

    // 4. collisions, bounds and the accumulation
    const float dx = s.pos[0] - partner(s.pos[0]);
    const float dy = s.pos[1] - partner(s.pos[1]);
    const float dz = s.pos[2] - partner(s.pos[2]);
    const float coll = fmaxf(contact, (dx * dx + dy * dy + dz * dz < c.crad2) ? 1.f : 0.f);
    const float lp2 = s.view[9] * s.view[9] + s.view[10] * s.view[10] + s.view[11] * s.view[11];
    const float oob = (lp2 > c.dome2) ? 1.f : 0.f;
    r = r - 3000.f * oob - 3000.f * coll;
    term = fminf(term + coll + oob + othd, 1.f);
    trunc = fminf(trunc + trunc_hit, 1.f);
    rwd = rwd + r;
    collf = fminf(collf + coll, 1.f);
    oobf = fminf(oobf + oob, 1.f);
  }

  if (!live) return;  // after the last shuffle
  float* O = out + i;
  fl::store_lane<GROUP>(O, ld, lane, s, sp);
  fl::put<GROUP>(O, ld, lane, HP, hp);
  fl::put<GROUP>(O, ld, lane, ANG, ang);
  fl::put<GROUP>(O, ld, lane, PANG, pang);
  fl::put<GROUP>(O, ld, lane, HIT, hit);
  fl::put<GROUP>(O, ld, lane, DIST, dist);
  fl::put<GROUP>(O, ld, lane, PDIST, pdist);
  fl::put<GROUP>(O, ld, lane, TERM, term);
  fl::put<GROUP>(O, ld, lane, TRUNC, trunc);
  fl::put<GROUP>(O, ld, lane, RWD, rwd);
  fl::put<GROUP>(O, ld, lane, COLLF, collf);
  fl::put<GROUP>(O, ld, lane, OOBF, oobf);
  fl::put<GROUP>(O, ld, lane, OTHD, othd);
  fl::put<GROUP>(O, ld, lane, STEPC, stepc + 1.f);
#pragma unroll
  for (int r = STEPC + 1; r < ROWS; ++r) fl::put<GROUP>(O, ld, lane, r, 0.f);  // padding rows
}

template <bool NOISY>
void launch_noisy(bool sparse, dim3 grid, cudaStream_t stream, const float* in, float* out, int n,
                  const long long* seed, const DogfightConsts& c) {
  if (sparse)
    dogfight_kernel<NOISY, true><<<grid, THREADS, 0, stream>>>(in, out, n, seed, c);
  else
    dogfight_kernel<NOISY, false><<<grid, THREADS, 0, stream>>>(in, out, n, seed, c);
}

}  // namespace

// in/out: (72, n) f32 row-major on the device, n = 2N drones (even); seed:
// one int64 on the device; consts: host pointer, copied into the launch by
// value. Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue outside the envelope.
extern "C" int dogfight_step(const float* in, float* out, int n, const long long* seed,
                             const DogfightConsts* consts, int noisy, int sparse, void* stream) {
  if (n <= 0 || n % 2 != 0 || n > (INT_MAX - THREADS) / GROUP || consts->ratio < 1 || consts->inner_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n * GROUP + THREADS - 1) / THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noisy)
    launch_noisy<true>(sparse != 0, grid, s, in, out, n, seed, *consts);
  else
    launch_noisy<false>(sparse != 0, grid, s, in, out, n, seed, *consts);
  return static_cast<int>(cudaGetLastError());
}
