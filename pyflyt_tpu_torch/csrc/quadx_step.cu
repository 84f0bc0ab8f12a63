// One QuadX aviary step for a batch of envs, one thread per env: the
// generic variant of the QuadX kernel.
//
// Replaces pyflyt_tpu/ops/pallas_quadx.py::packed_step (the non-env-fused
// variant of _build_kernel) and, behind pack -> kernel -> unpack,
// pallas_quadx.step. Per launch: `ratio` physics iterations with the
// controller at iteration 0 (modes 0, 8, 9, ENU or NED; mode 7, the
// position cascade, ENU only as in the Pallas kernel), wind on the drag
// (none, a baked gaussian base, a per-env gaussian base read from rows
// 51-53, or the simple thermal field), detection-grade ground contact.
// Row 50 of the output is the step's any-contact flag; rows 51-53 pass the
// per-env wind base through (zero otherwise); rows 54-55 are zero. Mode 7
// runs on an 80-row state: rows 56-73 carry the cascade's five PID banks,
// read and written back; rows 74-79 are zero.
//
// What bounds it on an H100: at 8192 envs and 3 physics iterations each env
// reads 50 f32 rows (53 with a per-env base) and writes 56, about 0.42 KB,
// 3.5 MB in all, ~1.0 us at 3.35 TB/s, and does ~1.1 kFLOP of f32 work
// (~0.13 us at 67 TFLOP/s); so bytes bound it, and in practice each
// thread's long dependent chain and the launch do. Design for that: SoA
// (56, N) rows, so a warp's load of one row is one coalesced 128 B
// transaction; the whole step in registers, one read and one write per
// row; constants as one POD struct passed as a __grid_constant__; the
// mode, the convention, the motor noise and the wind kind are template
// parameters (48 instantiations for modes 0/8/9, 8 more for ENU mode 7),
// and the gusts (max_gust > 0) a launch-uniform branch. The chain is
// shortened as in quadx_hover_step.cu: the view only on the step's last
// physics iteration (the one the env and the next launch's controller
// read), and the divisions by the mass, the inertia and the control period
// (also in mode 7's cascade) multiplications by reciprocals taken once a
// launch. On an H100 the view every iteration costs 6% and dividing 30% at
// the recipe's shape (PERF.md section 6).
// Random draws are curand Philox normals keyed by (seed, env): 4 per
// iteration for motor noise, 4 (3 used) per iteration for gusts or the
// simple field's noise. Blocks of 64 threads, as in quadx_hover_step.cu.
#include <cuda_runtime.h>
#include <curand_kernel.h>

#include <cstddef>

#include "quadx_lane.cuh"

namespace {

constexpr int ANY = 50;    // any-contact flag of the step
constexpr int WBASE = 51;  // 3: per-env wind base, ENU
constexpr int ROWS = 56;
constexpr int THREADS = 64;  // per block

}  // namespace

// Must match pyflyt_tpu_torch/ops/cuda_quadx.py::GenericConsts field by
// field (tests/test_torch_quadx_step.py holds the two layouts equal).
struct GenericConsts {
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
  float lp_kp[2];  // mode 7: the position cascade's banks (lin_pos, lin_vel,
  float lp_ki[2];  // ang_pos, z_pos, z_vel), gains per lane
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
  float wind_base[3];  // WIND_GAUSSIAN: the baked base, ENU
  float max_gust;      // gaussian kinds: gust clip (0 = no gusts)
  float wind_strength; // WIND_SIMPLE: thermal strength
  int wind_kind;       // quadx_lane::Wind
  int ned;             // 1: NED_FRD read
  int ratio;           // physics iterations per launch
};

namespace {

using quadx_lane::Lane;

template <int MODE, bool NED, bool NOISY, int WIND>
__global__ void __launch_bounds__(THREADS)
    quadx_step_kernel(const float* __restrict__ in, float* __restrict__ out, int n,
                      const long long* __restrict__ seed, const __grid_constant__ GenericConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // ragged edge
  const size_t ld = static_cast<size_t>(n);
  const float* S = in + i;
  Lane s;
  float sp[4];
  quadx_lane::load_lane(S, ld, s, sp);
  quadx_lane::Cascade cas;
  if constexpr (MODE == 7) quadx_lane::load_cascade(S, ld, cas);
  float wb[3] = {0.f, 0.f, 0.f};
  if (WIND == quadx_lane::WIND_GAUSSIAN_ENV)
    for (int k = 0; k < 3; ++k) wb[k] = S[(WBASE + k) * ld];

  constexpr bool kGaussian =
      WIND == quadx_lane::WIND_GAUSSIAN || WIND == quadx_lane::WIND_GAUSSIAN_ENV;
  const bool draws = NOISY || WIND == quadx_lane::WIND_SIMPLE || (kGaussian && c.max_gust > 0.f);
  curandStatePhilox4_32_10_t rng;
  if (draws) curand_init(static_cast<unsigned long long>(seed[0]),
                         static_cast<unsigned long long>(i), 0ULL, &rng);

  const quadx_lane::Recip rcp = quadx_lane::reciprocals(c);
  float any_contact = 0.f;
  for (int it = 0; it < c.ratio; ++it) {
    if (it == 0) quadx_lane::control<MODE, NED>(s, sp, c, &cas, &rcp);  // probe: recip
    float w[3];
    quadx_lane::wind_velocity<WIND>(s, wb, c, &rng, w);
    const bool read = it == c.ratio - 1;  // probe: read
    quadx_lane::physics<NOISY, NED, WIND != quadx_lane::WIND_NONE>(s, c, &rng, w, read, &rcp);  // probe: recip
    any_contact = fmaxf(any_contact, s.contact);
  }

  float* O = out + i;
  quadx_lane::store_lane(O, ld, s, sp);
  O[ANY * ld] = any_contact;
  for (int k = 0; k < 3; ++k) O[(WBASE + k) * ld] = wb[k];  // through, or 0
  for (int r = WBASE + 3; r < ROWS; ++r) O[r * ld] = 0.f;
  if constexpr (MODE == 7) {
    quadx_lane::store_cascade(O, ld, cas);
    for (int r = quadx_lane::CASCADE + quadx_lane::CASCADE_ROWS; r < quadx_lane::ROWS_MODE7; ++r)
      O[r * ld] = 0.f;
  }
}

struct Launch {
  dim3 grid, block;
  cudaStream_t stream;
  const float* in;
  float* out;
  int n;
  const long long* seed;
  const GenericConsts* c;
};

template <int MODE, bool NED, bool NOISY>
void launch_wind(const Launch& L) {
  switch (L.c->wind_kind) {
    case quadx_lane::WIND_NONE:
      quadx_step_kernel<MODE, NED, NOISY, quadx_lane::WIND_NONE>
          <<<L.grid, L.block, 0, L.stream>>>(L.in, L.out, L.n, L.seed, *L.c);
      break;
    case quadx_lane::WIND_GAUSSIAN:
      quadx_step_kernel<MODE, NED, NOISY, quadx_lane::WIND_GAUSSIAN>
          <<<L.grid, L.block, 0, L.stream>>>(L.in, L.out, L.n, L.seed, *L.c);
      break;
    case quadx_lane::WIND_GAUSSIAN_ENV:
      quadx_step_kernel<MODE, NED, NOISY, quadx_lane::WIND_GAUSSIAN_ENV>
          <<<L.grid, L.block, 0, L.stream>>>(L.in, L.out, L.n, L.seed, *L.c);
      break;
    default:
      quadx_step_kernel<MODE, NED, NOISY, quadx_lane::WIND_SIMPLE>
          <<<L.grid, L.block, 0, L.stream>>>(L.in, L.out, L.n, L.seed, *L.c);
  }
}

template <int MODE, bool NED>
void launch_noisy(bool noisy, const Launch& L) {
  if (noisy)
    launch_wind<MODE, NED, true>(L);
  else
    launch_wind<MODE, NED, false>(L);
}

template <int MODE>
void launch_ned(bool noisy, const Launch& L) {
  if (L.c->ned)
    launch_noisy<MODE, true>(noisy, L);
  else
    launch_noisy<MODE, false>(noisy, L);
}

}  // namespace

// in/out: (56, n) f32 row-major on the device, (80, n) in mode 7; seed:
// one int64 on the device; consts: host pointer, copied into the launch by
// value. Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a mode, convention or wind kind outside the
// envelope.
extern "C" int quadx_step(const float* in, float* out, int n, const long long* seed,
                          const GenericConsts* consts, int mode, int noisy, void* stream) {
  if (n <= 0 || (mode != 0 && mode != 7 && mode != 8 && mode != 9) || (mode == 7 && consts->ned) ||
      consts->wind_kind < 0 || consts->wind_kind > quadx_lane::WIND_SIMPLE || consts->ratio < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{dim3((n + THREADS - 1) / THREADS), dim3(THREADS),
                 static_cast<cudaStream_t>(stream), in, out, n, seed, consts};
  const bool nz = noisy != 0;
  if (mode == 0)
    launch_ned<0>(nz, L);
  else if (mode == 7)
    launch_noisy<7, false>(nz, L);  // ENU only
  else if (mode == 8)
    launch_ned<8>(nz, L);
  else
    launch_ned<9>(nz, L);
  return static_cast<int>(cudaGetLastError());
}
