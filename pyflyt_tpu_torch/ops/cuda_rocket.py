"""The Rocket kernel K6 on a packed ``(ROWS, N)`` state (port of
``pyflyt_tpu/ops/pallas_rocket.py``).

One CUDA source, ``csrc/rocket_step.cu`` on ``csrc/fixedwing_lane.cuh``'s
surface model, with two entries:

- ``packed_step`` (replaces ``pallas_rocket.packed_step``): one aviary
  step, the step's any-ground and any-pad contact flags in rows 59 and 60,
  the pad rows 66-68 kept, the other env rows zero;
- ``packed_landing_step`` (replaces ``pallas_rocket.packed_landing_step``):
  the whole Rocket-Landing agent step, ``inner_steps`` aviary steps each
  followed by the memo shift, the base termination, the shaped reward and
  the pad touchdown, with the done-freeze; then the step count + 1.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch twin (``*_plain``) for a CPU tensor, with no fallback between the
two. The twins repeat the kernel's arithmetic row by row; with noise on
they draw from a ``torch.Generator`` seeded with the kernel's seed, where
the kernel draws Philox normals: same distribution, other numbers. As in
the JAX package, there is no pack → step → unpack drop-in for
``models.rocket.step``.

Layout: SoA ``(88, N)`` f32, one column per env, with the Pallas module's
row numbers, so packed states compare row by row; the TPU's
``(88, 8, N/8)`` sublane fold is dropped
(``convert.packed_rocket_landing_from_jax`` undoes it).

Bound on an H100 at the serving path's 8192 envs: the landing step reads
87 rows and writes 88 (5.7 MB, 1.71 µs at 3.35 TB/s) and does ~11.3 kFLOP
per env over its 6 physics iterations (1.38 µs at 67 TFLOP/s): bytes bound
it, and each thread's dependent chain costs more (see the source note).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.core.state import Body6DoF
from pyflyt_tpu_torch.models import rocket
from pyflyt_tpu_torch.ops import boosters, cuda_build
from pyflyt_tpu_torch.ops import cuda_fixedwing as cf
from pyflyt_tpu_torch.ops import cuda_math as cm
from pyflyt_tpu_torch.ops.cuda_build import Kernel

ROWS = 88

# drone rows (pallas_rocket.py:59-75)
_POS = 0     # 3: world ENU CoM position
_QUAT = 3    # 4: xyzw body->world
_LVEL = 7    # 3: world linear velocity (CoM)
_AVEL = 10   # 3: world angular velocity
_VIEW = 13   # 12: lagged [ang_vel_b, euler, lin_vel_b, base_pos]
_FLV = 25    # 12: lagged body-frame finlet velocities (4 x 3)
_DLV = 37    # 3: lagged body-frame drag-link velocity
_ACT = 40    # 4: finlet deflections
_FUEL = 44   # booster fuel ratio
_BTHR = 45   # booster throttle
_IGN = 46    # booster ignition latch (0/1)
_GBL = 47    # 2: gimbal state
_SP = 49     # 7: setpoint (= the env's action)
_CON = 56    # any contact of the last physics iteration (0/1)
_GCON = 57   # ground contact (off the pad), last physics iteration
_PCON = 58   # pad contact, last physics iteration
# env rows (pallas_rocket.py:77-92); packed_step's output carries the step's
# any-ground flag in row 59 and its any-pad flag in row 60
_RWD = 59
_TERM = 60
_TRUNC = 61
_FATC = 62   # fatal_collision
_OOB = 63    # out_of_bounds
_CPLT = 64   # env_complete
_STEP = 65   # agent step count (exact as f32 below 2^24)
_PADP = 66   # 3: pad position
_PFLAG = 69  # pad_contact_flag (an observation field)
_AV = 70     # 3: ang_vel memo
_LV = 73     # 3: lin_vel memo
_DIST = 76   # 3: distance memo (base_pos - pad)
_PAV = 79    # 3: the previous memos
_PLV = 82
_PDIST = 85

NUM_POINTS = 7  # the composite's point masses: base, fuel, booster, 4 fins
NUM_CONTACT = 12
NO_PAD = 1e9  # pad rows x, y of a state without a pad: out of reach
GRAVITY = 9.81
FRICTION = 0.5

# f32 operations per env, counted from csrc/rocket_step.cu (adds,
# multiplies, divides, compares, selects, transcendentals each 1) — the
# operation side of the bounds: one finlet's aero and wrench (the flap
# branch and the no-stall regime, fixedwing_lane.cuh's as in K5); the rest
# of a physics iteration (the two composite CoMs and the inertia over 7
# point masses, the drag, the gimbal's Rodrigues pair, the booster, the
# read with 5 local velocities, the integration with the adjugate solve);
# the 12-point contact test (a lane in contact adds ~95 for the impulse);
# the control map; the landing task update
OPS_PER_PHYSICS_BODY = 880
OPS_PER_CONTACT_TEST = 526
OPS_PER_CONTROL = 36
OPS_PER_LANDING_TASK = 60
OPS_PER_PHYSICS_ITER = rocket.NUM_FINLETS * cf.OPS_PER_SURFACE + OPS_PER_PHYSICS_BODY + OPS_PER_CONTACT_TEST


def pack_state(state: rocket.RocketState) -> Tensor:
    """Batched ``RocketState`` (N,) → ``(ROWS, N)`` f32; env rows zero, the
    pad parked out of reach (rows 66-67 at ``NO_PAD``), as
    ``pallas_rocket.pack_state`` does."""
    n = state.body.pos.shape[0]
    rows = [
        state.body.pos.T,
        state.body.quat.T,
        state.body.lin_vel.T,
        state.body.ang_vel.T,
        state.read.view.reshape(n, 12).T,
        state.read.finlet_local_vel.reshape(n, 12).T,
        state.read.drag_local_vel.T,
        state.actuation.T,
        state.booster.ratio_fuel_remaining.T,
        state.booster.throttle.T,
        state.booster.ignition_state.T,
        state.gimbal_state.reshape(n, 2).T,
        state.setpoint.T,
        state.contact[None, :],
        state.ground_contact[None, :],
        state.pad_contact[None, :],
    ]
    packed = torch.cat([r.to(torch.float32) for r in rows], dim=0)
    packed = torch.cat([packed, packed.new_zeros((ROWS - packed.shape[0], n))], dim=0)
    packed[_PADP : _PADP + 2] = NO_PAD
    return packed.contiguous()


def unpack_state(packed: Tensor, template: rocket.RocketState) -> rocket.RocketState:
    """``(ROWS, N)`` → ``RocketState``; ``cmd`` and ``physics_steps`` keep
    the template's values."""
    g = lambda r, k: packed[r : r + k].T  # noqa: E731
    n = packed.shape[1]
    return dataclasses.replace(
        template,
        body=Body6DoF(pos=g(_POS, 3), quat=g(_QUAT, 4), lin_vel=g(_LVEL, 3), ang_vel=g(_AVEL, 3)),
        read=rocket.RocketRead(view=g(_VIEW, 12).reshape(n, 4, 3), finlet_local_vel=g(_FLV, 12).reshape(n, 4, 3),
                               drag_local_vel=g(_DLV, 3)),
        actuation=g(_ACT, 4),
        booster=boosters.BoosterState(ratio_fuel_remaining=g(_FUEL, 1), throttle=g(_BTHR, 1),
                                      ignition_state=g(_IGN, 1) > 0.5),
        gimbal_state=g(_GBL, 2).reshape(n, 1, 2),
        setpoint=g(_SP, 7),
        contact=packed[_CON] > 0.5,
        ground_contact=packed[_GCON] > 0.5,
        pad_contact=packed[_PCON] > 0.5,
    )


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------


_arr = cuda_build.array_field


@dataclasses.dataclass(frozen=True)
class RocketConsts:
    """Vehicle and task constants of K6 as Python values: the numbers
    ``pallas_rocket._bake`` computes, in float64 from the f32 parameters.
    The kernel gets them as one POD struct by value (``_RocketConstsC``,
    these fields in this order); the twins read the same values."""

    lu: tuple = _arr(12)  # finlet lift units, 4 x 3
    du: tuple = _arr(12)  # forward units
    tu: tuple = _arr(12)  # pitch-moment units, lift × forward
    spos: tuple = _arr(12)  # finlet positions, body frame (base origin)
    qa: tuple = _arr(4)  # HALF_RHO * area
    chord: tuple = _arr(4)
    piar_inv: tuple = _arr(4)  # 1 / (pi * aspect)
    cl3d: tuple = _arr(4)
    cd0: tuple = _arr(4)
    a0b: tuple = _arr(4)  # alpha_0_base, rad
    asp_b: tuple = _arr(4)  # alpha_stall_P_base, rad
    asn_b: tuple = _arr(4)  # alpha_stall_N_base, rad
    dlim_rad: tuple = _arr(4)  # deflection limit, rad
    dcl_gain: tuple = _arr(4)  # Cl_alpha_3D * aero_tau * eta
    f2c: tuple = _arr(4)  # flap_to_chord
    clmax_p: tuple = _arr(4)  # Cl_alpha_3D * (alpha_stall_P_base - alpha_0_base)
    clmax_n: tuple = _arr(4)  # Cl_alpha_3D * (alpha_stall_N_base - alpha_0_base)
    stall_c: tuple = _arr(4)  # 0.41 * (1 - exp(-17 / aspect))
    lag: tuple = _arr(4)  # physics_period / finlet tau
    finlet_map: tuple = _arr(12)  # row-major (4, 3)
    drag_const: tuple = _arr(3)
    drag_pos: tuple = _arr(3)
    contact_pts: tuple = _arr(3 * NUM_CONTACT)  # body frame (base origin)
    pt_mass: tuple = _arr(NUM_POINTS)  # [base, fuel (0 here: run time), booster, 4 fins]
    pt_pos: tuple = _arr(3 * NUM_POINTS)
    p_dry: tuple = _arr(3)  # sum of the dry point masses' m * p
    i_dry: tuple = _arr(3)  # base + booster link inertia diagonals
    fuel_inertia: tuple = _arr(3)  # the tank's link inertia at full fuel
    b_pos: tuple = _arr(3)
    b_tu: tuple = _arr(3)
    g_range: tuple = _arr(2)  # rad
    g_w1: tuple = _arr(9)  # gimbal axis skews and their squares, row-major
    g_w2: tuple = _arr(9)
    g_w1sq: tuple = _arr(9)
    g_w2sq: tuple = _arr(9)
    m_dry: float
    b_lag: float  # physics_period / booster tau
    b_total_fuel: float
    b_fuel_rate: float  # max fuel rate / total fuel
    b_min_ratio: float  # min thrust / max thrust
    b_max_thrust: float
    b_noise: float
    g_lag: float  # physics_period / gimbal tau
    dt: float
    max_steps: float  # step-count truncation threshold (landing entry)
    max_displacement: float  # xy bound (landing entry)
    ceiling: float  # z bound (landing entry)
    b_reignitable: int
    ratio: int  # physics iterations per aviary step
    inner_steps: int  # aviary steps per agent step (landing entry)


def rocket_consts(params: rocket.RocketParams, cfg: rocket.RocketConfig) -> RocketConsts:
    """Reads the parameter tensors once into ``RocketConsts`` (the landing
    task's fields zero: ``landing_consts`` fills them)."""
    p = lambda t: np.asarray(t.detach().cpu(), dtype=np.float64)  # noqa: E731
    flat = lambda a: tuple(float(v) for v in np.asarray(a, np.float64).reshape(-1))  # noqa: E731
    s, b, g = params.finlets, params.booster, params.gimbal
    aspect = p(s.aspect)
    cl3d, a0b = p(s.Cl_alpha_3D), p(s.alpha_0_base)
    pts = p(params.contact_points)
    if len(pts) != NUM_CONTACT:
        raise NotImplementedError(f"K6 carries {NUM_CONTACT} contact points, not {len(pts)}")
    m_base, m_boost, m_fin = float(p(params.base_mass)), float(p(params.booster_mass)), float(p(params.fin_mass))
    pt_pos = np.stack([p(params.base_position), p(params.fueltank_position), p(params.booster_position),
                       *p(params.fin_positions)])
    pt_mass = np.array([m_base, 0.0, m_boost, m_fin, m_fin, m_fin, m_fin])
    dt = float(cfg.physics_period)
    return RocketConsts(
        lu=flat(p(s.lift_unit)), du=flat(p(s.drag_unit)), tu=flat(p(s.torque_unit)), spos=flat(p(s.positions)),
        qa=flat(cf.HALF_RHO * p(s.area)), chord=flat(p(s.chord)), piar_inv=flat(1.0 / (np.pi * aspect)),
        cl3d=flat(cl3d), cd0=flat(p(s.Cd_0)), a0b=flat(a0b), asp_b=flat(p(s.alpha_stall_P_base)),
        asn_b=flat(p(s.alpha_stall_N_base)), dlim_rad=flat(np.deg2rad(p(s.deflection_limit))),
        dcl_gain=flat(cl3d * p(s.aero_tau) * p(s.eta)), f2c=flat(p(s.flap_to_chord)),
        clmax_p=flat(cl3d * (p(s.alpha_stall_P_base) - a0b)), clmax_n=flat(cl3d * (p(s.alpha_stall_N_base) - a0b)),
        stall_c=flat(0.41 * (1.0 - np.exp(-17.0 / aspect))), lag=flat(dt / p(s.tau)),
        finlet_map=flat(p(params.finlet_map)), drag_const=flat(p(params.drag_const)),
        drag_pos=flat(p(params.drag_position)), contact_pts=flat(pts), pt_mass=flat(pt_mass), pt_pos=flat(pt_pos),
        p_dry=flat((pt_mass[:, None] * pt_pos).sum(0)), i_dry=flat(p(params.base_inertia) + p(params.booster_inertia)),
        fuel_inertia=flat(p(b.max_inertia)[0]), b_pos=flat(p(b.positions)[0]), b_tu=flat(p(b.thrust_unit)[0]),
        g_range=flat(p(g.range_radians)[0]), g_w1=flat(p(g.w1)[0]), g_w2=flat(p(g.w2)[0]),
        g_w1sq=flat(p(g.w1_squared)[0]), g_w2sq=flat(p(g.w2_squared)[0]),
        m_dry=float(pt_mass.sum()), b_lag=dt / float(p(b.tau)[0]), b_total_fuel=float(p(b.total_fuel_mass)[0]),
        b_fuel_rate=float(p(b.max_fuel_rate)[0] / p(b.total_fuel_mass)[0]),
        b_min_ratio=float(p(b.min_thrust)[0] / p(b.max_thrust)[0]), b_max_thrust=float(p(b.max_thrust)[0]),
        b_noise=float(p(b.noise_ratio)[0]), g_lag=dt / float(p(g.tau)[0]), dt=dt,
        max_steps=0.0, max_displacement=0.0, ceiling=0.0, b_reignitable=int(bool(b.reignitable[0])),
        ratio=int(cfg.physics_control_ratio), inner_steps=0,
    )


def landing_consts(
    params: rocket.RocketParams,
    cfg: rocket.RocketConfig,
    inner_steps: int,
    max_steps: int,
    max_displacement: float,
    ceiling: float,
) -> RocketConsts:
    """``rocket_consts`` with the landing task's fields."""
    return dataclasses.replace(
        rocket_consts(params, cfg), inner_steps=int(inner_steps), max_steps=float(max_steps),
        max_displacement=float(max_displacement), ceiling=float(ceiling),
    )


def ops_per_env(c: RocketConsts, landing: bool) -> int:
    """f32 operations one launch does per env that runs its whole step
    airborne (for the bound): a full agent step of ``inner_steps`` aviary
    steps, or one aviary step. A frozen lane does less, and a lane in
    contact does the impulse's ~95 more per physics iteration."""
    per_aviary = c.ratio * OPS_PER_PHYSICS_ITER
    if landing:
        return OPS_PER_CONTROL + c.inner_steps * (per_aviary + OPS_PER_LANDING_TASK)
    return OPS_PER_CONTROL + per_aviary


def rows_moved(landing: bool) -> tuple[int, int]:
    """(rows read, rows written) per env. ``packed_step`` reads the 47 rows
    its step uses (the view and the contact flags are overwritten unread);
    the landing step reads all but the re-armed reward, since a frozen lane
    keeps every row. Both write all 88."""
    if landing:
        return ROWS - 1, ROWS
    return 3 + 4 + 3 + 3 + 12 + 3 + 4 + 3 + 2 + 7 + 3, ROWS


class _RocketConstsC(cuda_build.ConstsStruct):
    """Mirror of ``struct RocketConsts`` in csrc/rocket_step.cu, field by
    field from ``RocketConsts`` (a test holds the C struct to it)."""

    _fields_ = cuda_build.struct_fields(RocketConsts)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

_ARGS = [
    ctypes.c_void_p,  # in
    ctypes.c_void_p,  # out
    ctypes.c_int,  # n
    ctypes.c_void_p,  # seed (device int64)
    ctypes.c_void_p,  # consts (host struct)
    ctypes.c_int,  # noisy
    ctypes.c_int,  # sparse (landing entry; ignored by the step)
    ctypes.c_void_p,  # stream
]
STEP_KERNEL = Kernel("rocket_step.cu", "rocket_step", _ARGS)
LANDING_KERNEL = Kernel("rocket_step.cu", "rocket_landing_step", _ARGS)


def _check(packed: Tensor, seed: Tensor) -> None:
    if packed.dtype != torch.float32 or packed.dim() != 2 or packed.shape[0] != ROWS:
        raise ValueError(f"packed must be ({ROWS}, N) float32, got {tuple(packed.shape)} {packed.dtype}")
    if seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != packed.device:
        raise ValueError("seed must be one int64 on the packed state's device")


def _launch(kernel: Kernel, packed: Tensor, seed: Tensor, c: RocketConsts, noisy: bool, sparse: bool) -> Tensor:
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    out = torch.empty_like(packed)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel.fn()(
            packed.data_ptr(), out.data_ptr(), packed.shape[1], seed.data_ptr(),
            ctypes.addressof(_RocketConstsC.of(c)), int(noisy), int(sparse), stream,
        )
    kernel.check(rc)
    kernel.launches += 1
    return out


def packed_step(packed: Tensor, seed: Tensor, consts: RocketConsts, noisy: bool) -> Tensor:
    """One aviary step on the packed ``(ROWS, N)`` state, the pad read from
    rows 66-68: returns the new state (a new tensor), its row 59 the step's
    any-ground flag, row 60 its any-pad flag, the other env rows zero.
    ``seed`` is a one-element int64 tensor on the state's device (the
    booster-noise key of this step)."""
    _check(packed, seed)
    if packed.device.type == "cpu":
        return packed_step_plain(packed, seed, consts, noisy)
    return _launch(STEP_KERNEL, packed, seed, consts, noisy, False)


def packed_landing_step(
    packed: Tensor, seed: Tensor, consts: RocketConsts, noisy: bool, sparse: bool = False
) -> Tensor:
    """One whole Rocket-Landing agent step on the packed ``(ROWS, N)``
    state (``consts`` from ``landing_consts``): returns the new state, a new
    tensor."""
    _check(packed, seed)
    if consts.inner_steps < 1:
        raise ValueError("the landing step needs landing_consts (inner_steps >= 1)")
    if packed.device.type == "cpu":
        return packed_landing_step_plain(packed, seed, consts, noisy, sparse)
    return _launch(LANDING_KERNEL, packed, seed, consts, noisy, sparse)


# ---------------------------------------------------------------------------
# the plain twins: the kernel's arithmetic in PyTorch, row by row
# ---------------------------------------------------------------------------


def _control_plain(c: RocketConsts, sp: list[Tensor]) -> dict:
    """rocket_step.cu::control: the finlet mix and the clipped commands."""
    fm = c.finlet_map
    fin = [torch.clamp(fm[3 * k] * sp[0] + fm[3 * k + 1] * sp[1] + fm[3 * k + 2] * sp[2], -1.0, 1.0)
           for k in range(rocket.NUM_FINLETS)]
    return {"fin": fin, "ign": sp[3], "pwm": torch.clamp(sp[4], 0.0, 1.0),
            "gbl": [torch.clamp(sp[5], -1.0, 1.0), torch.clamp(sp[6], -1.0, 1.0)]}


def _mass_com_plain(c: RocketConsts, fm: Tensor) -> tuple[list[Tensor], Tensor]:
    inv_mass = 1.0 / (c.m_dry + fm)
    return [(c.p_dry[i] + fm * c.pt_pos[3 + i]) * inv_mass for i in range(3)], inv_mass


def _rodrigues_plain(w, wsq, s: Tensor, q: Tensor, v: list[Tensor]) -> list[Tensor]:
    return [v[i] + s * (w[3 * i] * v[0] + w[3 * i + 1] * v[1] + w[3 * i + 2] * v[2])
            + q * (wsq[3 * i] * v[0] + wsq[3 * i + 1] * v[1] + wsq[3 * i + 2] * v[2]) for i in range(3)]


def _local_vel_plain(R, lvel, avel, com, p) -> list[Tensor]:
    r = [p[i] - com[i] for i in range(3)]
    rw = [R[3 * i] * r[0] + R[3 * i + 1] * r[1] + R[3 * i + 2] * r[2] for i in range(3)]
    v = [lvel[0] + (avel[1] * rw[2] - avel[2] * rw[1]),
         lvel[1] + (avel[2] * rw[0] - avel[0] * rw[2]),
         lvel[2] + (avel[0] * rw[1] - avel[1] * rw[0])]
    return [R[i] * v[0] + R[3 + i] * v[1] + R[6 + i] * v[2] for i in range(3)]


def _physics_plain(s: dict, c: RocketConsts, u: dict, pad: list[Tensor], gen, noisy: bool) -> None:
    """rocket_step.cu::physics_iter: one physics iteration in place on
    ``s``."""
    dt = c.dt
    com, inv_mass = _mass_com_plain(c, s["fuel"] * c.b_total_fuel)
    f = [-torch.sign(s["dlv"][i]) * c.drag_const[i] * s["dlv"][i] * s["dlv"][i] for i in range(3)]
    r = [c.drag_pos[i] - com[i] for i in range(3)]
    t = [r[1] * f[2] - r[2] * f[1], r[2] * f[0] - r[0] * f[2], r[0] * f[1] - r[1] * f[0]]
    act = [s["act"][k] + c.lag[k] * (u["fin"][k] - s["act"][k]) for k in range(rocket.NUM_FINLETS)]
    for k in range(rocket.NUM_FINLETS):
        fn, fp, qcm = cf._surface_plain(c, k, act[k], s["flv"][3 * k : 3 * k + 3])
        lu, du, tu = c.lu[3 * k : 3 * k + 3], c.du[3 * k : 3 * k + 3], c.tu[3 * k : 3 * k + 3]
        r = [c.spos[3 * k + i] - com[i] for i in range(3)]
        fs = [fn * lu[i] + fp * du[i] for i in range(3)]
        f = [f[i] + fs[i] for i in range(3)]
        t = [t[0] + qcm * tu[0] + (r[1] * fs[2] - r[2] * fs[1]),
             t[1] + qcm * tu[1] + (r[2] * fs[0] - r[0] * fs[2]),
             t[2] + qcm * tu[2] + (r[0] * fs[1] - r[1] * fs[0])]

    gbl = [s["gbl"][i] + c.g_lag * (u["gbl"][i] - s["gbl"][i]) for i in range(2)]
    h1, ch1 = torch.sin(0.5 * (gbl[0] * c.g_range[0])), torch.cos(0.5 * (gbl[0] * c.g_range[0]))
    h2, ch2 = torch.sin(0.5 * (gbl[1] * c.g_range[1])), torch.cos(0.5 * (gbl[1] * c.g_range[1]))
    tdir = [torch.full_like(h1, c.b_tu[i]) for i in range(3)]
    tdir = _rodrigues_plain(c.g_w2, c.g_w2sq, 2.0 * h2 * ch2, 2.0 * h2 * h2, tdir)
    tdir = _rodrigues_plain(c.g_w1, c.g_w1sq, 2.0 * h1 * ch1, 2.0 * h1 * h1, tdir)

    lit = (u["ign"] > 0.5).to(act[0].dtype)
    ign = lit if c.b_reignitable else torch.maximum(s["ign"], lit)
    target = ign * (u["pwm"] * (1.0 - c.b_min_ratio) + c.b_min_ratio)
    bthr = s["bthr"] + c.b_lag * (target - s["bthr"])
    if noisy:
        bthr = bthr + torch.randn(bthr.shape, generator=gen, device=bthr.device) * bthr * c.b_noise
    bthr = torch.where(s["fuel"] > 0.0, bthr, 0.0)
    fuel = torch.clamp(s["fuel"] - bthr * c.b_fuel_rate * dt, 0.0, 1.0)
    thrust = bthr * c.b_max_thrust

    fm = fuel * c.b_total_fuel
    com, inv_mass = _mass_com_plain(c, fm)
    ixx = c.i_dry[0] + fuel * c.fuel_inertia[0]
    iyy = c.i_dry[1] + fuel * c.fuel_inertia[1]
    izz = c.i_dry[2] + fuel * c.fuel_inertia[2]
    ixy = ixz = iyz = torch.zeros_like(fuel)
    for k in range(NUM_POINTS):
        dx, dy, dz = (c.pt_pos[3 * k + i] - com[i] for i in range(3))
        m = fm if k == 1 else c.pt_mass[k]
        ixx = ixx + m * (dy * dy + dz * dz)
        iyy = iyy + m * (dx * dx + dz * dz)
        izz = izz + m * (dx * dx + dy * dy)
        ixy = ixy - m * dx * dy
        ixz = ixz - m * dx * dz
        iyz = iyz - m * dy * dz
    fb = [thrust * tdir[i] for i in range(3)]
    r = [c.b_pos[i] - com[i] for i in range(3)]
    f = [f[i] + fb[i] for i in range(3)]
    t = [t[0] + (r[1] * fb[2] - r[2] * fb[1]), t[1] + (r[2] * fb[0] - r[0] * fb[2]),
         t[2] + (r[0] * fb[1] - r[1] * fb[0])]

    # the new read from the pre-integration state
    pos, quat, lvel, avel = s["pos"], s["quat"], s["lvel"], s["avel"]
    R = cm.quat_rotmat(quat)
    rcom = [R[3 * i] * com[0] + R[3 * i + 1] * com[1] + R[3 * i + 2] * com[2] for i in range(3)]
    bv = [lvel[0] - (avel[1] * rcom[2] - avel[2] * rcom[1]),
          lvel[1] - (avel[2] * rcom[0] - avel[0] * rcom[2]),
          lvel[2] - (avel[0] * rcom[1] - avel[1] * rcom[0])]
    avb = [R[i] * avel[0] + R[3 + i] * avel[1] + R[6 + i] * avel[2] for i in range(3)]
    lvb = [R[i] * bv[0] + R[3 + i] * bv[1] + R[6 + i] * bv[2] for i in range(3)]
    view = [*avb, *cm.quat_to_euler(quat), *lvb, *(pos[i] - rcom[i] for i in range(3))]
    flv = []
    for k in range(rocket.NUM_FINLETS):
        flv += _local_vel_plain(R, lvel, avel, com, c.spos[3 * k : 3 * k + 3])
    dlv = _local_vel_plain(R, lvel, avel, com, c.drag_pos)

    # semi-implicit Euler, the adjugate solve
    fw = [R[3 * i] * f[0] + R[3 * i + 1] * f[1] + R[3 * i + 2] * f[2] for i in range(3)]
    lvel = [lvel[0] + dt * (fw[0] * inv_mass - 0.0), lvel[1] + dt * (fw[1] * inv_mass - 0.0),
            lvel[2] + dt * (fw[2] * inv_mass - GRAVITY)]
    iw = [ixx * avb[0] + ixy * avb[1] + ixz * avb[2], ixy * avb[0] + iyy * avb[1] + iyz * avb[2],
          ixz * avb[0] + iyz * avb[1] + izz * avb[2]]
    b0 = t[0] - (avb[1] * iw[2] - avb[2] * iw[1])
    b1 = t[1] - (avb[2] * iw[0] - avb[0] * iw[2])
    b2 = t[2] - (avb[0] * iw[1] - avb[1] * iw[0])
    c00, c01, c02 = iyy * izz - iyz * iyz, ixz * iyz - ixy * izz, ixy * iyz - ixz * iyy
    c11, c12, c22 = ixx * izz - ixz * ixz, ixy * ixz - ixx * iyz, ixx * iyy - ixy * ixy
    inv_det = 1.0 / (ixx * c00 + ixy * c01 + ixz * c02)
    ob = [avb[0] + dt * ((c00 * b0 + c01 * b1 + c02 * b2) * inv_det),
          avb[1] + dt * ((c01 * b0 + c11 * b1 + c12 * b2) * inv_det),
          avb[2] + dt * ((c02 * b0 + c12 * b1 + c22 * b2) * inv_det)]
    avel = [R[3 * i] * ob[0] + R[3 * i + 1] * ob[1] + R[3 * i + 2] * ob[2] for i in range(3)]
    pos = [pos[i] + dt * lvel[i] for i in range(3)]
    quat = cm.quat_integrate(quat, avel, dt)

    # the impulse contact against the ground and the raised pad
    Rn = cm.quat_rotmat(quat)
    pad_top = pad[2] + rocket.PAD_HALF_HEIGHT
    zero = torch.zeros_like(fuel)
    depth_sum, max_depth, cx, cy, cz = zero, zero, zero, zero, zero
    on_pad_pen = off_pad_pen = torch.zeros_like(fuel, dtype=torch.bool)
    for j in range(NUM_CONTACT):
        pj = [c.contact_pts[3 * j + i] - com[i] for i in range(3)]
        w = [Rn[3 * i] * pj[0] + Rn[3 * i + 1] * pj[1] + Rn[3 * i + 2] * pj[2] for i in range(3)]
        dxp, dyp = pos[0] + w[0] - pad[0], pos[1] + w[1] - pad[1]
        on_pad = dxp * dxp + dyp * dyp < rocket.PAD_RADIUS**2
        depth = torch.where(on_pad, pad_top, 0.0) - (pos[2] + w[2])
        pen = depth > 0.0
        on_pad_pen = on_pad_pen | (on_pad & pen)
        off_pad_pen = off_pad_pen | (~on_pad & pen)
        wgt = torch.clamp(depth, min=0.0)
        depth_sum = depth_sum + wgt
        max_depth = torch.maximum(max_depth, depth)
        cx, cy, cz = cx + wgt * w[0], cy + wgt * w[1], cz + wgt * w[2]
    hit = on_pad_pen | off_pad_pen
    inv_w = 1.0 / torch.clamp(depth_sum, min=1e-12)
    rx, ry, rz = cx * inv_w, cy * inv_w, cz * inv_w
    iw_inv = [1.0 / (Rn[3 * i] * Rn[3 * i] * ixx + Rn[3 * i + 1] * Rn[3 * i + 1] * iyy
                     + Rn[3 * i + 2] * Rn[3 * i + 2] * izz) for i in range(3)]
    vpx = lvel[0] + (avel[1] * rz - avel[2] * ry)
    vpy = lvel[1] + (avel[2] * rx - avel[0] * rz)
    vpz = lvel[2] + (avel[0] * ry - avel[1] * rx)
    k_n = inv_mass + (ry * ry * iw_inv[0] + rx * rx * iw_inv[1])
    j_n = torch.where(vpz < 0.0, torch.clamp(-vpz / k_n, min=0.0), 0.0)
    vt = torch.sqrt(vpx * vpx + vpy * vpy)
    inv_vt = 1.0 / torch.clamp(vt, min=1e-9)
    tx, ty = vpx * inv_vt, vpy * inv_vt
    rxt0, rxt1, rxt2 = -rz * ty, rz * tx, rx * ty - ry * tx
    k_t = inv_mass + (rxt0 * rxt0 * iw_inv[0] + rxt1 * rxt1 * iw_inv[1] + rxt2 * rxt2 * iw_inv[2])
    j_t = torch.minimum(vt / k_t, FRICTION * j_n)
    jx, jy, jz = -j_t * tx, -j_t * ty, j_n
    lvel = [torch.where(hit, lvel[0] + jx * inv_mass, lvel[0]), torch.where(hit, lvel[1] + jy * inv_mass, lvel[1]),
            torch.where(hit, lvel[2] + jz * inv_mass, lvel[2])]
    avel = [torch.where(hit, avel[0] + (ry * jz - rz * jy) * iw_inv[0], avel[0]),
            torch.where(hit, avel[1] + (rz * jx - rx * jz) * iw_inv[1], avel[1]),
            torch.where(hit, avel[2] + (rx * jy - ry * jx) * iw_inv[2], avel[2])]
    pos[2] = torch.where(hit, pos[2] + torch.clamp(max_depth, min=0.0), pos[2])
    s.update(pos=pos, quat=quat, lvel=lvel, avel=avel, view=view, flv=flv, dlv=dlv, act=act, fuel=fuel, bthr=bthr,
             ign=ign, gbl=gbl, con=hit.to(fuel.dtype), gcon=off_pad_pen.to(fuel.dtype),
             pcon=on_pad_pen.to(fuel.dtype))


_LANE_ROWS = {"pos": (_POS, 3), "quat": (_QUAT, 4), "lvel": (_LVEL, 3), "avel": (_AVEL, 3), "view": (_VIEW, 12),
              "flv": (_FLV, 12), "dlv": (_DLV, 3), "act": (_ACT, 4), "gbl": (_GBL, 2)}
_LANE_FLAGS = {"fuel": _FUEL, "bthr": _BTHR, "ign": _IGN, "con": _CON, "gcon": _GCON, "pcon": _PCON}


def _unpack_rows(S: list[Tensor]) -> dict:
    s = {k: S[r : r + n] for k, (r, n) in _LANE_ROWS.items()}
    s.update({k: S[r] for k, r in _LANE_FLAGS.items()})
    return s


def _pack_rows(out: list, s: dict, sp: list[Tensor], pad: list[Tensor]) -> None:
    for k, (r, n) in _LANE_ROWS.items():
        out[r : r + n] = s[k]
    for k, r in _LANE_FLAGS.items():
        out[r] = s[k]
    out[_SP : _SP + 7] = sp
    out[_PADP : _PADP + 3] = pad


def packed_step_plain(packed: Tensor, seed: Tensor, consts: RocketConsts, noisy: bool) -> Tensor:
    """``packed_step``'s arithmetic in plain PyTorch (any device)."""
    _check(packed, seed)
    c = consts
    S = list(packed.unbind(0))
    gen = cf._twin_generator(seed, packed.device) if noisy else None
    s = _unpack_rows(S)
    sp, pad = S[_SP : _SP + 7], S[_PADP : _PADP + 3]
    u = _control_plain(c, sp)
    any_ground = any_pad = torch.zeros_like(S[_FUEL])
    for _ in range(c.ratio):
        _physics_plain(s, c, u, pad, gen, noisy)
        any_ground = torch.maximum(any_ground, s["gcon"])
        any_pad = torch.maximum(any_pad, s["pcon"])
    out = [torch.zeros_like(any_ground)] * ROWS
    _pack_rows(out, s, sp, pad)
    out[_RWD] = any_ground
    out[_TERM] = any_pad
    return torch.stack(out, dim=0)


def packed_landing_step_plain(
    packed: Tensor, seed: Tensor, consts: RocketConsts, noisy: bool, sparse: bool = False
) -> Tensor:
    """``packed_landing_step``'s arithmetic in plain PyTorch (any device).
    The kernel leaves a done lane's inner loop; the twin computes every
    lane and selects, which gives the same state."""
    _check(packed, seed)
    c = consts
    S = list(packed.unbind(0))
    gen = cf._twin_generator(seed, packed.device) if noisy else None
    st = _unpack_rows(S)
    st.update(term=S[_TERM], trunc=S[_TRUNC], fatc=S[_FATC], oob=S[_OOB], cplt=S[_CPLT], pflag=S[_PFLAG],
              av=S[_AV : _AV + 3], lv=S[_LV : _LV + 3], dist=S[_DIST : _DIST + 3], pav=S[_PAV : _PAV + 3],
              plv=S[_PLV : _PLV + 3], pdist=S[_PDIST : _PDIST + 3])
    sp, pad = S[_SP : _SP + 7], S[_PADP : _PADP + 3]
    stepc = S[_STEP]
    st["rwd"] = torch.zeros_like(stepc)  # re-armed every agent step
    trunc_hit = stepc > c.max_steps  # the count before this step's increment
    one = torch.ones_like(stepc)
    u = _control_plain(c, sp)
    norm3 = lambda v: torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])  # noqa: E731

    for _ in range(c.inner_steps):
        done = (st["term"] + st["trunc"]) > 0.0
        nw = dict(st)
        any_ground = any_pad = torch.zeros_like(stepc)
        for _ in range(c.ratio):
            _physics_plain(nw, c, u, pad, gen, noisy)
            any_ground = torch.maximum(any_ground, nw["gcon"])
            any_pad = torch.maximum(any_pad, nw["pcon"])
        view = nw["view"]
        nw["pav"], nw["plv"], nw["pdist"] = nw["av"], nw["lv"], nw["dist"]
        nw["av"], nw["lv"] = view[0:3], view[6:9]
        nw["dist"] = [view[9 + k] - pad[k] for k in range(3)]
        fatal = (any_ground > 0.0) | (view[11] < 0.0)
        out_i = (torch.sqrt(view[9] * view[9] + view[10] * view[10]) > c.max_displacement) | (view[11] > c.ceiling)
        tilt = torch.sqrt(view[3] * view[3] + view[4] * view[4])
        rwd = nw["rwd"]
        if not sparse:
            d_xy = torch.sqrt(nw["dist"][0] * nw["dist"][0] + nw["dist"][1] * nw["dist"][1])
            pd_xy = torch.sqrt(nw["pdist"][0] * nw["pdist"][0] + nw["pdist"][1] * nw["pdist"][1])
            rwd = rwd + (-5.0 + 2.0 / (d_xy + 0.1) + 100.0 * (pd_xy - d_xy) - torch.abs(nw["av"][2]) - 3.0 * tilt)
        on_pad = any_pad > 0.0
        pav_n, plv_n = norm3(nw["pav"]), norm3(nw["plv"])
        hard = (pav_n > 0.35) | (plv_n > 1.0)
        landed = (pav_n < 0.02) & (plv_n < 0.02) & (tilt < 0.1)
        fatal_touch = on_pad & hard
        complete = on_pad & ~hard & landed
        rwd = torch.where(on_pad, rwd + 20.0, rwd)
        nw["rwd"] = torch.where(complete, rwd + 500.0, rwd)
        nw["pflag"] = any_pad
        nw["trunc"] = torch.where(trunc_hit, one, nw["trunc"])
        nw["term"] = torch.where(fatal | out_i | fatal_touch | complete, one, nw["term"])
        nw["fatc"] = torch.where(fatal | fatal_touch, one, nw["fatc"])
        nw["oob"] = torch.where(out_i, one, nw["oob"])
        nw["cplt"] = torch.where(complete, one, nw["cplt"])
        for key, old in st.items():  # the done-freeze
            st[key] = ([torch.where(done, o, v) for o, v in zip(old, nw[key])] if isinstance(old, list)
                       else torch.where(done, old, nw[key]))

    out = [torch.zeros_like(stepc)] * ROWS
    _pack_rows(out, st, sp, pad)
    for row, key in ((_RWD, "rwd"), (_TERM, "term"), (_TRUNC, "trunc"), (_FATC, "fatc"), (_OOB, "oob"),
                     (_CPLT, "cplt"), (_PFLAG, "pflag")):
        out[row] = st[key]
    out[_STEP] = stepc + 1.0  # unconditional, after the inner loop
    for row, key in ((_AV, "av"), (_LV, "lv"), (_DIST, "dist"), (_PAV, "pav"), (_PLV, "plv"), (_PDIST, "pdist")):
        out[row : row + 3] = st[key]
    return torch.stack(out, dim=0)
