"""The QuadX kernels on a packed ``(ROWS, N)`` state (port of
``pyflyt_tpu/ops/pallas_quadx.py``).

Three kernels share one per-iteration body (``csrc/quadx_lane.cuh``):

- ``packed_hover_step`` (``csrc/quadx_hover_step.cu``, replaces
  ``pallas_quadx.packed_hover_step``): the whole QuadX-Hover agent step,
  ``inner_steps`` aviary steps plus reward, termination, truncation and
  the done-freeze; modes 0, 7 and 8, ENU (mode 7 on the 80-row layout,
  the position cascade's banks in rows 56-73).
- ``packed_step`` (``csrc/quadx_step.cu``, replaces
  ``pallas_quadx.packed_step``): one aviary step, the generic variant;
  modes 0, 7, 8 and 9, ENU or NED (mode 7 ENU only, as in the Pallas
  kernel), wind none, a baked gaussian base, a per-env gaussian base (rows
  51-53) or the simple thermal field. Mode 7 carries the position
  cascade's five PID banks in rows 56-73 of an 80-row layout. ``step``
  (replaces ``pallas_quadx.step``) is the drop-in for ``models.quadx.step``
  behind pack → kernel → unpack.
- ``packed_waypoints_step`` (``csrc/quadx_waypoints_step.cu``, replaces
  ``pallas_quadx.packed_waypoints_step``): the whole QuadX-Waypoints agent
  step, ``inner_steps`` aviary steps plus waypoint tracking, reward,
  target advance, termination, truncation and the done-freeze; modes 0, 7
  and 8, ENU, up to 4 targets, on 28 waypoint rows after
  ``rows_for(mode)`` (88 or 112 rows, the Pallas layout).

Each wrapper launches its CUDA kernel for a CUDA tensor and runs its plain
PyTorch twin (``*_plain``) for a CPU tensor. There is no fallback between
the two: a CUDA tensor launches the kernel or raises.

Layout: SoA ``(ROWS, N)`` f32, one column per env, with the row indices of
the Pallas module so packed rows compare one to one. The TPU's
``(ROWS, 8, N/8)`` sublane fold is dropped: on the card one thread owns one
env and a warp's load of a row is one coalesced transaction. Any N works.

Bounds on an H100 at N=8192: the hover step reads 55 of the 56 f32 rows
and writes all 56 (3.64 MB, about 1.09 µs at 3.35 TB/s), in mode 7 73
of 80 (5.0 MB, 1.5 µs), and does about 2 kFLOP per env; the generic step reads 50 rows (53 with a per-env wind
base) and writes 56 (about 3.5 MB, 1.0 µs) and does about 1.1 kFLOP per
env at 3 physics iterations; the waypoints step in mode 7 reads 101 rows
and writes 112 (about 7.0 MB, 2.1 µs) and does about 4 kFLOP per env.
Bytes bound all three, and launch latency and each thread's dependent
chain cost more. All three run one thread an env and shorten that chain
alike: the view only on an aviary step's last physics iteration, the
divisions by the mass, the inertia and the control period (mode 7's
cascade included) multiplications by reciprocals taken once a launch, the
constants a ``__grid_constant__``, and in the two agent steps the
done-freeze an exit from the aviary loop. Groups of lanes an env, the
freeze as a select, and the waypoints step's rows staged through shared
memory by bulk copies measured slower (PERF.md section 6; the source
notes give the numbers). The twins keep the Pallas kernel's order of
operations: they divide, and they select the frozen lanes.

With noise or stochastic wind on, the kernels draw Philox normals keyed by
(seed, env index, draw index) and the twins draw from a ``torch.Generator``
seeded with the same seed: same distribution, different numbers.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.core import wind as wind_models
from pyflyt_tpu_torch.models import quadx
from pyflyt_tpu_torch.ops import cuda_build
from pyflyt_tpu_torch.ops import cuda_math as cm
from pyflyt_tpu_torch.ops.cuda_build import Kernel, array_field

ROWS = 56

# row layout (pallas_quadx.py:52-67)
_POS = 0       # 3: world ENU position
_QUAT = 3      # 4: xyzw body->world
_LVEL = 7      # 3: world linear velocity
_AVEL = 10     # 3: world angular velocity
_VIEW = 13     # 12: [ang_vel_b, euler, lin_vel_b, lin_pos] (lagged)
_AVB = 25      # 3: lagged body rates
_DRG = 28      # 3: lagged body-frame air velocity
_THR = 31      # 4: motor throttle
_PWM = 35      # 4: motor pwm
_SP = 39       # 4: setpoint
_PINT = 43     # 3: ang_vel PID integral
_PPRV = 46     # 3: ang_vel PID prev error
_CON = 49      # 1: contact flag (0/1)
# env rows of the hover-fused layout (pallas_quadx.py:207-213)
_RWD = 50      # running reward of the agent step
_TERM = 51     # termination flag
_TRUNC = 52    # truncation flag
_COLL = 53     # collision info flag
_OOB = 54      # out-of-bounds info flag
_STEP = 55     # agent step count, f32 (exact below 2^24)
# rows of the generic layout (pallas_quadx.py:215-221)
_ANY = 50      # any-contact flag of the aviary step
_WBASE = 51    # 3: per-env wind base, ENU
# mode 7: the position cascade's PID banks (pallas_quadx.py:69-82)
ROWS_MODE7 = 80
_LP_INT = 56   # 2: lin_pos PID integral
_LP_PRV = 58   # 2: lin_pos PID prev error
_LV_INT = 60   # 2: lin_vel
_LV_PRV = 62
_AP_INT = 64   # 3: ang_pos
_AP_PRV = 67
_ZP_INT = 70   # 1: z_pos
_ZP_PRV = 71
_ZV_INT = 72   # 1: z_vel
_ZV_PRV = 73
CASCADE_ROWS = 18
# waypoint rows after rows_for(mode) (pallas_quadx.py:89-98); the targets
# are rolled so the current one is first
WP_ROWS = 28
_WP_TGT = 0     # 12: world-frame targets, rolled (4 x 3)
_WP_REM = 12    # remaining-target count
_WP_NDIST = 13  # new-distance memo
_WP_ODIST = 14  # old-distance memo
_WP_TDLT = 15   # 12: the target_deltas observation (body frame, rolled, masked)
_WP_CPLT = 27   # env_complete flag
MAX_TARGETS = 4

GRAVITY = 9.81
# f32 operations per env in one physics iteration, control, wind draw and
# hover task update, counted from the kernel sources (adds, multiplies,
# divides, compares, transcendentals each 1) — the operation side of the
# kernels' bounds
OPS_PER_PHYSICS_ITER = 330
OPS_PER_CONTROL = 75
OPS_PER_TASK_UPDATE = 30
OPS_PER_WIND = 12
OPS_PER_CASCADE = 135  # mode 7: 9 PID lanes of ~14, the yaw frame and the swap
OPS_PER_WAYPOINT_TASK = 160  # the rotation, 4 targets' deltas, distance, mask, advance, reward, flags

# wind kinds of the generic kernel (csrc/quadx_lane.cuh::Wind)
WIND_NONE, WIND_GAUSSIAN, WIND_GAUSSIAN_ENV, WIND_SIMPLE = 0, 1, 2, 3
GENERIC_MODES = (0, 7, 8, 9)
HOVER_MODES = (0, 7, 8)
WAYPOINT_MODES = (0, 7, 8)


def rows_for(mode: int) -> int:
    """Rows of the generic layout: 80 in mode 7 (the cascade's banks), else 56."""
    return ROWS_MODE7 if mode == 7 else ROWS


def rows_for_waypoints(mode: int) -> int:
    """Rows of the waypoints layout, padded to a multiple of 8 as the Pallas
    layout is, so the two compare row by row: 88, or 112 in mode 7."""
    return -(-(rows_for(mode) + WP_ROWS) // 8) * 8


def _cascade_banks(pids: quadx.QuadXPIDState) -> list[Tensor]:
    return [pids.lin_pos.integral, pids.lin_pos.prev_error, pids.lin_vel.integral, pids.lin_vel.prev_error,
            pids.ang_pos.integral, pids.ang_pos.prev_error, pids.z_pos.integral, pids.z_pos.prev_error,
            pids.z_vel.integral, pids.z_vel.prev_error]


def pack_state(state: quadx.QuadXState, mode: int = 0) -> Tensor:
    """Batched ``QuadXState`` (N,) → ``(rows_for(mode), N)`` f32; env rows
    zero. Mode 7 appends the position cascade's PID banks (rows 56-73)."""
    n = state.body.pos.shape[0]
    rows = [
        state.body.pos.T,
        state.body.quat.T,
        state.body.lin_vel.T,
        state.body.ang_vel.T,
        state.read.view.reshape(n, 12).T,
        state.read.ang_vel_body.T,
        state.read.drag_local_vel.T,
        state.throttle.T,
        state.pwm.T,
        state.setpoint.T,
        state.pids.ang_vel.integral.T,
        state.pids.ang_vel.prev_error.T,
        state.contact.to(torch.float32)[None, :],
    ]
    if mode == 7:
        rows.append(state.body.pos.new_zeros((_LP_INT - _ANY, n)))
        rows += [b.T for b in _cascade_banks(state.pids)]
    packed = torch.cat([r.to(torch.float32) for r in rows], dim=0)
    pad = packed.new_zeros((rows_for(mode) - packed.shape[0], n))
    return torch.cat([packed, pad], dim=0).contiguous()


def unpack_state(packed: Tensor, template: quadx.QuadXState) -> quadx.QuadXState:
    """``(rows, N)`` → ``QuadXState``; PID banks outside the layout keep the
    template's values (the cascade's banks are read from the mode-7 layouts
    only: rows 56+ of the 88-row waypoints layout hold waypoints)."""
    g = lambda r, k: packed[r : r + k].T  # noqa: E731
    n = packed.shape[1]
    pids = dataclasses.replace(
        template.pids,
        ang_vel=dataclasses.replace(
            template.pids.ang_vel, integral=g(_PINT, 3), prev_error=g(_PPRV, 3)
        ),
    )
    if packed.shape[0] in (ROWS_MODE7, rows_for_waypoints(7)):
        bank = lambda st, r, k: dataclasses.replace(st, integral=g(r, k), prev_error=g(r + k, k))  # noqa: E731
        pids = dataclasses.replace(
            pids, lin_pos=bank(pids.lin_pos, _LP_INT, 2), lin_vel=bank(pids.lin_vel, _LV_INT, 2),
            ang_pos=bank(pids.ang_pos, _AP_INT, 3), z_pos=bank(pids.z_pos, _ZP_INT, 1),
            z_vel=bank(pids.z_vel, _ZV_INT, 1),
        )
    return dataclasses.replace(
        template,
        body=dataclasses.replace(
            template.body, pos=g(_POS, 3), quat=g(_QUAT, 4), lin_vel=g(_LVEL, 3),
            ang_vel=g(_AVEL, 3),
        ),
        read=dataclasses.replace(
            template.read, view=g(_VIEW, 12).reshape(n, 4, 3),
            ang_vel_body=g(_AVB, 3), drag_local_vel=g(_DRG, 3),
        ),
        throttle=g(_THR, 4),
        pwm=g(_PWM, 4),
        setpoint=g(_SP, 4),
        pids=pids,
        contact=packed[_CON] > 0.5,
    )


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Vehicle:
    """The vehicle fields every QuadX constants struct starts with."""

    mass: float
    inertia: tuple = array_field(3)
    motor_map: tuple = array_field(16)  # row-major (4, 4)
    mpos_x: tuple = array_field(4)
    mpos_y: tuple = array_field(4)
    thrust_coef: tuple = array_field(4)
    torque_coef: tuple = array_field(4)
    lag: tuple = array_field(4)  # physics_period / tau
    max_rpm: tuple = array_field(4)
    noise_ratio: tuple = array_field(4)
    drag_xyz: tuple = array_field(3)
    drag_pqr: float
    kp: tuple = array_field(3)
    ki: tuple = array_field(3)
    kd: tuple = array_field(3)
    lim: tuple = array_field(3)
    period: float
    dt: float
    min_pwm: float
    max_pwm: float
    half_ext: tuple = array_field(3)


@dataclasses.dataclass(frozen=True)
class _CascadeGains:
    """The gains of the mode-7 position cascade's five PID banks (``lp``
    lin_pos, ``lv`` lin_vel, ``ap`` ang_pos, ``zp`` z_pos, ``zv`` z_vel)."""

    lp_kp: tuple = array_field(2)
    lp_ki: tuple = array_field(2)
    lp_kd: tuple = array_field(2)
    lp_lim: tuple = array_field(2)
    lv_kp: tuple = array_field(2)
    lv_ki: tuple = array_field(2)
    lv_kd: tuple = array_field(2)
    lv_lim: tuple = array_field(2)
    ap_kp: tuple = array_field(3)
    ap_ki: tuple = array_field(3)
    ap_kd: tuple = array_field(3)
    ap_lim: tuple = array_field(3)
    zp_kp: tuple = array_field(1)
    zp_ki: tuple = array_field(1)
    zp_kd: tuple = array_field(1)
    zp_lim: tuple = array_field(1)
    zv_kp: tuple = array_field(1)
    zv_ki: tuple = array_field(1)
    zv_kd: tuple = array_field(1)
    zv_lim: tuple = array_field(1)


@dataclasses.dataclass(frozen=True)
class _HoverTask(_Vehicle):
    dome2: float
    max_steps: float
    inner_steps: int
    ratio: int


# dataclass fields follow the reversed MRO: the base's first, the gains last
@dataclasses.dataclass(frozen=True)
class HoverConsts(_CascadeGains, _HoverTask):
    """Vehicle and task constants of one hover env, as Python floats: the
    vehicle, the task, then the cascade gains that mode 7 reads (last, so
    modes 0 and 8 read every other field at the offsets they always had).

    The kernel gets them as one POD struct by value (``_HoverConstsC``,
    whose fields are these, in this order); the twin reads the same values,
    so both round them identically.
    """


@dataclasses.dataclass(frozen=True)
class CascadeVehicle(_CascadeGains, _Vehicle):
    """The vehicle fields and the cascade gains: the leading fields of the
    generic and the waypoints constants."""


@dataclasses.dataclass(frozen=True)
class GenericConsts(CascadeVehicle):
    """Constants of the generic step: the vehicle and its cascade gains,
    the wind of the launch and the convention, as Python values. The
    kernel gets them as one POD struct by value (``_GenericConstsC``,
    these fields in this order)."""

    wind_base: tuple = array_field(3)  # WIND_GAUSSIAN: the baked base, ENU
    max_gust: float  # gaussian kinds: the gust clip (0: no gusts)
    wind_strength: float  # WIND_SIMPLE: the thermal strength
    wind_kind: int
    ned: int
    ratio: int


@dataclasses.dataclass(frozen=True)
class WaypointsConsts(CascadeVehicle):
    """Constants of the waypoints agent step: the vehicle and its cascade
    gains, then the task's, as Python values (``_WaypointsConstsC``,
    these fields in this order)."""

    dome2: float
    max_steps: float
    goal: float  # goal_reach_distance
    inner_steps: int
    ratio: int
    num_targets: int


def _vehicle(params: quadx.QuadXParams, cfg: quadx.QuadXConfig) -> dict:
    """The vehicle fields both constant structs share, read once from the
    parameter tensors."""
    f = lambda t: tuple(float(v) for v in np.asarray(t.detach().cpu(), np.float64).reshape(-1))  # noqa: E731
    if not np.allclose(np.asarray(params.motor.thrust_unit.cpu()), [0.0, 0.0, 1.0]):
        raise NotImplementedError(
            "the fused QuadX steps assume +z thrust for every motor"
        )
    pos = np.asarray(params.motor.positions.cpu(), np.float64)
    tau = np.asarray(params.motor.tau.cpu(), np.float64)
    return dict(
        mass=float(params.mass),
        inertia=f(params.inertia),
        motor_map=f(params.motor_map),
        mpos_x=tuple(float(v) for v in pos[:, 0]),
        mpos_y=tuple(float(v) for v in pos[:, 1]),
        thrust_coef=f(params.motor.thrust_coef),
        torque_coef=f(params.motor.torque_coef),
        lag=tuple(float(cfg.physics_period / t) for t in tau),
        max_rpm=f(params.motor.max_rpm),
        noise_ratio=f(params.motor.noise_ratio),
        drag_xyz=f(params.drag_const_xyz),
        drag_pqr=float(params.drag_coef_pqr),
        kp=f(params.pid_ang_vel.kp),
        ki=f(params.pid_ang_vel.ki),
        kd=f(params.pid_ang_vel.kd),
        lim=f(params.pid_ang_vel.lim),
        period=float(params.pid_ang_vel.period),
        dt=float(cfg.physics_period),
        min_pwm=float(cfg.min_pwm),
        max_pwm=float(cfg.max_pwm),
        half_ext=f(params.collision_half_extents),
        ratio=int(cfg.physics_control_ratio),
    )


_BANKS = {"lp": "lin_pos", "lv": "lin_vel", "ap": "ang_pos", "zp": "z_pos", "zv": "z_vel"}


def _cascade_gains(params: quadx.QuadXParams) -> dict:
    """The five cascade banks' gains, read once from the parameter tensors."""
    f = lambda t: tuple(float(v) for v in np.asarray(t.detach().cpu(), np.float64).reshape(-1))  # noqa: E731
    return {
        f"{short}_{g}": f(getattr(getattr(params, f"pid_{name}"), g))
        for short, name in _BANKS.items()
        for g in ("kp", "ki", "kd", "lim")
    }


def hover_consts(
    params: quadx.QuadXParams,
    cfg: quadx.QuadXConfig,
    inner_steps: int,
    dome: float,
    max_steps: int,
) -> HoverConsts:
    """Reads the parameter tensors once into ``HoverConsts``."""
    if cfg.orn_conv != "ENU_FLU":
        raise NotImplementedError("the fused hover step is ENU only")
    return HoverConsts(
        **_vehicle(params, cfg), **_cascade_gains(params),
        dome2=float(dome) ** 2,
        max_steps=float(max_steps),
        inner_steps=int(inner_steps),
    )


def _wind_fields(wind) -> dict:
    """The wind fields of ``GenericConsts`` from the JAX package's wind
    dict (``{"kind": "gaussian", "base": (3,) ENU, "max_gust": g}``,
    ``{"kind": "gaussian", "per_env_base": True, "max_gust": g}`` or
    ``{"kind": "simple", "strength": s}``), or from a ``core/wind.py``
    ``GaussianWind``, whose per-env base goes to rows 51-53."""
    none = dict(wind_kind=WIND_NONE, wind_base=(0.0, 0.0, 0.0), max_gust=0.0, wind_strength=0.0)
    if wind is None:
        return none
    if isinstance(wind, wind_models.GaussianWind):
        return dict(none, wind_kind=WIND_GAUSSIAN_ENV, max_gust=float(wind.max_gust))
    if wind["kind"] == "simple":
        return dict(none, wind_kind=WIND_SIMPLE, wind_strength=float(wind["strength"]))
    if wind["kind"] != "gaussian":
        raise ValueError(f"unknown wind kind {wind['kind']!r}")
    if wind.get("per_env_base"):
        return dict(none, wind_kind=WIND_GAUSSIAN_ENV, max_gust=float(wind.get("max_gust", 0.0)))
    base = tuple(float(v) for v in np.asarray(wind["base"], np.float64).reshape(3))
    return dict(none, wind_kind=WIND_GAUSSIAN, wind_base=base, max_gust=float(wind.get("max_gust", 0.0)))


def generic_consts(
    params: quadx.QuadXParams, cfg: quadx.QuadXConfig, wind=None
) -> GenericConsts:
    """Reads the parameter tensors once into ``GenericConsts``, with the
    wind baked in (see ``_wind_fields``; None: no wind)."""
    return GenericConsts(
        **_vehicle(params, cfg), **_cascade_gains(params), **_wind_fields(wind),
        ned=int(cfg.orn_conv == "NED_FRD"),
    )


def waypoints_consts(
    params: quadx.QuadXParams,
    cfg: quadx.QuadXConfig,
    inner_steps: int,
    dome: float,
    max_steps: int,
    num_targets: int,
    goal: float,
) -> WaypointsConsts:
    """Reads the parameter tensors once into ``WaypointsConsts``."""
    if cfg.orn_conv != "ENU_FLU":
        raise NotImplementedError("the fused waypoints step is ENU only")
    if not 1 <= num_targets <= MAX_TARGETS:
        raise NotImplementedError(
            f"the waypoints layout carries 1..{MAX_TARGETS} targets, not {num_targets}"
        )
    return WaypointsConsts(
        **_vehicle(params, cfg), **_cascade_gains(params), dome2=float(dome) ** 2,
        max_steps=float(max_steps), goal=float(goal), inner_steps=int(inner_steps),
        num_targets=int(num_targets),
    )


@functools.lru_cache(maxsize=32)
def _with_wind(consts: GenericConsts, key: tuple) -> GenericConsts:
    return dataclasses.replace(consts, **dict(key))


def with_wind(consts: GenericConsts, wind) -> GenericConsts:
    """``consts`` with another wind baked in (None keeps ``consts``)."""
    if wind is None:
        return consts
    return _with_wind(consts, tuple(sorted(_wind_fields(wind).items())))


def ops_per_env(c: HoverConsts, mode: int = 0) -> int:
    """f32 operations one hover agent step does per env (for the bound)."""
    cascade = OPS_PER_CASCADE if mode == 7 else 0
    per_aviary = OPS_PER_CONTROL + cascade + c.ratio * OPS_PER_PHYSICS_ITER + OPS_PER_TASK_UPDATE
    return c.inner_steps * per_aviary


def hover_rows_moved(mode: int) -> tuple[int, int]:
    """(rows read, rows written) per env by the hover kernel: it reads
    every row of the drone and the env but the reward (re-armed), and the
    cascade's 18 in mode 7, and writes every row of ``rows_for(mode)``,
    mode 7's padding included."""
    read = ROWS - 1 + (CASCADE_ROWS if mode == 7 else 0)
    return read, rows_for(mode)


def generic_ops_per_env(c: GenericConsts, mode: int = 0) -> int:
    """f32 operations one generic aviary step does per env (for the bound)."""
    wind = 0 if c.wind_kind == WIND_NONE else OPS_PER_WIND
    cascade = OPS_PER_CASCADE if mode == 7 else 0
    return OPS_PER_CONTROL + cascade + c.ratio * (OPS_PER_PHYSICS_ITER + wind)


def generic_rows_read(c: GenericConsts, mode: int = 0) -> int:
    """The f32 rows the generic kernel reads per env: the drone's 50, the
    per-env wind base where it has one, the cascade's 18 in mode 7."""
    return _CON + 1 + (3 if c.wind_kind == WIND_GAUSSIAN_ENV else 0) + (CASCADE_ROWS if mode == 7 else 0)


def waypoints_ops_per_env(c: WaypointsConsts, mode: int) -> int:
    """f32 operations one waypoints agent step does per env (for the bound)."""
    cascade = OPS_PER_CASCADE if mode == 7 else 0
    per_aviary = OPS_PER_CONTROL + cascade + c.ratio * OPS_PER_PHYSICS_ITER + OPS_PER_WAYPOINT_TASK
    return c.inner_steps * per_aviary


def waypoints_rows_moved(mode: int) -> tuple[int, int]:
    """(rows read, rows written) per env by the waypoints kernel: it reads
    the drone's 50, the 5 env rows but the reward (re-armed), the
    cascade's 18 in mode 7 and the 28 waypoint rows, and writes every row
    of the layout, padding included."""
    read = _CON + 1 + 5 + (CASCADE_ROWS if mode == 7 else 0) + WP_ROWS
    return read, rows_for_waypoints(mode)


class _HoverConstsC(cuda_build.ConstsStruct):
    """Mirror of ``struct HoverConsts`` in csrc/quadx_hover_step.cu, field
    by field from ``HoverConsts`` (a test holds the C struct to it)."""

    _fields_ = cuda_build.struct_fields(HoverConsts)


class _GenericConstsC(cuda_build.ConstsStruct):
    """Mirror of ``struct GenericConsts`` in csrc/quadx_step.cu, field by
    field from ``GenericConsts`` (a test holds the C struct to it)."""

    _fields_ = cuda_build.struct_fields(GenericConsts)


class _WaypointsConstsC(cuda_build.ConstsStruct):
    """Mirror of ``struct WaypointsConsts`` in
    csrc/quadx_waypoints_step.cu, field by field from ``WaypointsConsts``
    (a test holds the C struct to it)."""

    _fields_ = cuda_build.struct_fields(WaypointsConsts)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

KERNEL = Kernel(
    "quadx_hover_step.cu",
    "quadx_hover_step",
    [
        ctypes.c_void_p,  # in
        ctypes.c_void_p,  # out
        ctypes.c_int,  # n
        ctypes.c_void_p,  # seed (device int64)
        ctypes.c_void_p,  # consts (host struct)
        ctypes.c_int,  # mode
        ctypes.c_int,  # noisy
        ctypes.c_int,  # sparse
        ctypes.c_void_p,  # stream
    ],
)

GENERIC_KERNEL = Kernel(
    "quadx_step.cu",
    "quadx_step",
    [
        ctypes.c_void_p,  # in
        ctypes.c_void_p,  # out
        ctypes.c_int,  # n
        ctypes.c_void_p,  # seed (device int64)
        ctypes.c_void_p,  # consts (host struct)
        ctypes.c_int,  # mode
        ctypes.c_int,  # noisy
        ctypes.c_void_p,  # stream
    ],
)

WAYPOINTS_KERNEL = Kernel(
    "quadx_waypoints_step.cu",
    "quadx_waypoints_step",
    [
        ctypes.c_void_p,  # in
        ctypes.c_void_p,  # out
        ctypes.c_int,  # n
        ctypes.c_void_p,  # seed (device int64)
        ctypes.c_void_p,  # consts (host struct)
        ctypes.c_int,  # mode
        ctypes.c_int,  # noisy
        ctypes.c_int,  # sparse
        ctypes.c_void_p,  # stream
    ],
)


def _check_packed(packed: Tensor, seed: Tensor, rows: int) -> None:
    if packed.dtype != torch.float32 or packed.dim() != 2 or packed.shape[0] != rows:
        raise ValueError(f"packed must be ({rows}, N) float32, got {tuple(packed.shape)} {packed.dtype}")
    if seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != packed.device:
        raise ValueError("seed must be one int64 on the packed state's device")


def _check_args(packed: Tensor, seed: Tensor, mode: int) -> None:
    if mode not in HOVER_MODES:
        raise NotImplementedError(
            f"the fused hover step covers modes 0, 7 and 8, not {mode}"
        )
    _check_packed(packed, seed, rows_for(mode))


def _check_generic(packed: Tensor, seed: Tensor, mode: int, c: GenericConsts) -> None:
    if mode not in GENERIC_MODES:
        raise NotImplementedError(
            f"the generic QuadX step covers modes 0, 7, 8 and 9, not {mode} "
            "(models/quadx.step runs the others it has)"
        )
    if mode == 7 and c.ned:
        raise NotImplementedError(
            "mode 7 in the QuadX kernels carries the ENU cascade only, as the "
            "Pallas kernel does; NED mode 7 runs on models/quadx.step"
        )
    _check_packed(packed, seed, rows_for(mode))


def _check_waypoints(packed: Tensor, seed: Tensor, mode: int, c: WaypointsConsts) -> None:
    if mode not in WAYPOINT_MODES:
        raise NotImplementedError(f"the fused waypoints step covers modes 0, 7 and 8, not {mode}")
    if not 1 <= c.num_targets <= MAX_TARGETS:
        raise NotImplementedError(f"the waypoints layout carries 1..{MAX_TARGETS} targets, not {c.num_targets}")
    _check_packed(packed, seed, rows_for_waypoints(mode))


def _launch(kernel: Kernel, packed: Tensor, seed: Tensor, cstruct, *flags) -> Tensor:
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    out = torch.empty_like(packed)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel.fn()(
            packed.data_ptr(), out.data_ptr(), packed.shape[1], seed.data_ptr(),
            ctypes.addressof(cstruct), *flags, stream,
        )
    kernel.check(rc)
    kernel.launches += 1
    return out


def packed_hover_step(
    packed: Tensor,
    seed: Tensor,
    consts: HoverConsts,
    mode: int,
    noisy: bool,
    sparse: bool = False,
) -> Tensor:
    """One full hover agent step on the packed ``(rows_for(mode), N)``
    state: returns the new packed state (a new tensor). ``seed`` is a one-element int64
    tensor on the state's device (the motor-noise key of this step)."""
    _check_args(packed, seed, mode)
    if packed.device.type == "cpu":
        return packed_hover_step_plain(packed, seed, consts, mode, noisy, sparse)
    return _launch(KERNEL, packed, seed, _HoverConstsC.of(consts), mode, int(noisy), int(sparse))


def packed_step(
    packed: Tensor,
    seed: Tensor,
    consts: GenericConsts,
    mode: int,
    noisy: bool,
    wind=None,
) -> Tensor:
    """One aviary step on the packed ``(ROWS, N)`` state (the generic
    kernel): returns the new packed state, a new tensor whose row ``_ANY``
    is the step's any-contact flag. ``wind`` (a JAX-style wind dict or a
    ``core/wind.py`` field, see ``_wind_fields``) replaces the wind baked
    into ``consts``; a per-env gaussian base is read from rows 51-53, in
    ENU. ``seed`` is a one-element int64 tensor on the state's device."""
    consts = with_wind(consts, wind)
    _check_generic(packed, seed, mode, consts)
    if packed.device.type == "cpu":
        return packed_step_plain(packed, seed, consts, mode, noisy)
    return _launch(GENERIC_KERNEL, packed, seed, _GenericConstsC.of(consts), mode, int(noisy))


def packed_waypoints_step(
    packed: Tensor,
    seed: Tensor,
    consts: WaypointsConsts,
    mode: int,
    noisy: bool,
    sparse: bool = False,
) -> Tensor:
    """One full waypoints agent step on the packed
    ``(rows_for_waypoints(mode), N)`` state: returns the new packed state (a
    new tensor). ``seed`` is a one-element int64 tensor on the state's
    device (the motor-noise key of this step)."""
    _check_waypoints(packed, seed, mode, consts)
    if packed.device.type == "cpu":
        return packed_waypoints_step_plain(packed, seed, consts, mode, noisy, sparse)
    return _launch(WAYPOINTS_KERNEL, packed, seed, _WaypointsConstsC.of(consts), mode, int(noisy), int(sparse))


def step(
    state: quadx.QuadXState,
    params: quadx.QuadXParams,
    cfg: quadx.QuadXConfig,
    mode: int,
    generator: torch.Generator | None = None,
    wind=None,
    consts: GenericConsts | None = None,
) -> tuple[quadx.QuadXState, Tensor]:
    """Drop-in for ``models.quadx.step`` through the generic kernel: pack →
    one launch → unpack; returns ``(state, any_contact)``. Motor noise is on
    when ``cfg.noisy_motors`` and a ``generator`` is given (it draws the
    launch's seed). ``wind`` is a JAX-style wind dict or a ``core/wind.py``
    field (a ``GaussianWind`` carries a per-env base; its generator draws
    the seed when ``generator`` is None). ``consts`` saves re-reading
    ``params`` on every call (``generic_consts(params, cfg)``)."""
    c = with_wind(consts if consts is not None else generic_consts(params, cfg), wind)
    packed = pack_state(state, mode)
    if c.wind_kind == WIND_GAUSSIAN_ENV:
        if not isinstance(wind, wind_models.GaussianWind):
            raise ValueError("step takes a per-env wind base from a GaussianWind")
        packed[_WBASE : _WBASE + 3] = wind.base_enu().to(packed.dtype).T
    gen = generator if generator is not None else getattr(wind, "generator", None)
    if gen is not None:
        seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device=packed.device, dtype=torch.int64)
    else:
        seed = torch.zeros(1, dtype=torch.int64, device=packed.device)
    out = packed_step(packed, seed, c, mode, noisy=cfg.noisy_motors and generator is not None)
    new = unpack_state(out, state)
    new = dataclasses.replace(new, physics_steps=state.physics_steps + cfg.physics_control_ratio)
    return new, out[_ANY] > 0.5


# ---------------------------------------------------------------------------
# the plain twins: the kernels' arithmetic in PyTorch, row by row
# ---------------------------------------------------------------------------


def _unpack_rows(S: list[Tensor], mode: int = 0) -> dict:
    """The drone rows 0-49 of ``S`` (a list of row tensors) by name, and
    in mode 7 the cascade's 18 rows (``cas``)."""
    st = {
        "pos": S[_POS:_POS + 3], "quat": S[_QUAT:_QUAT + 4],
        "lvel": S[_LVEL:_LVEL + 3], "avel": S[_AVEL:_AVEL + 3],
        "view": S[_VIEW:_VIEW + 12], "avb": S[_AVB:_AVB + 3],
        "drg": S[_DRG:_DRG + 3], "thr": S[_THR:_THR + 4],
        "pwm": S[_PWM:_PWM + 4], "pint": S[_PINT:_PINT + 3],
        "pprv": S[_PPRV:_PPRV + 3], "contact": S[_CON],
    }
    if mode == 7:
        st["cas"] = S[_LP_INT:_LP_INT + CASCADE_ROWS]
    return st


def _pack_rows(out: list, st: dict, sp: list[Tensor]) -> None:
    for base, key in ((_POS, "pos"), (_QUAT, "quat"), (_LVEL, "lvel"),
                      (_AVEL, "avel"), (_VIEW, "view"), (_AVB, "avb"),
                      (_DRG, "drg"), (_THR, "thr"), (_PWM, "pwm"),
                      (_PINT, "pint"), (_PPRV, "pprv")):
        for k, v in enumerate(st[key]):
            out[base + k] = v
    out[_SP:_SP + 4] = sp
    out[_CON] = st["contact"]
    if "cas" in st:
        out[_LP_INT:_LP_INT + CASCADE_ROWS] = st["cas"]


# the cascade's banks in its 18 rows: (name, first integral row, lanes)
_CASCADE_LAYOUT = (("lp", 0, 2), ("lv", 4, 2), ("ap", 8, 3), ("zp", 14, 1), ("zv", 16, 1))


def _pid_bank_plain(cas: list[Tensor], bank: str, c, meas: list, setp: list) -> list[Tensor]:
    """quadx_lane.cuh::pid_bank: one PID bank of the cascade, in place on
    its integral and prev-error rows of ``cas``."""
    _, r0, k = next(b for b in _CASCADE_LAYOUT if b[0] == bank)
    kp, ki, kd, lim = (getattr(c, f"{bank}_{g}") for g in ("kp", "ki", "kd", "lim"))
    out = []
    for i in range(k):
        err = setp[i] - meas[i]
        cas[r0 + i] = torch.clamp(cas[r0 + i] + ki[i] * err * c.period, -lim[i], lim[i])
        deriv = kd[i] * (err - cas[r0 + k + i]) / c.period
        cas[r0 + k + i] = err
        out.append(torch.clamp(kp[i] * err + cas[r0 + i] + deriv, -lim[i], lim[i]))
    return out


def _control_plain(s: dict, sp: list[Tensor], c, mode: int, ned: bool) -> None:
    """quadx_lane.cuh::control: the controller at iteration 0 and the
    saturation rescale, in place on ``s``."""
    clip = torch.clamp
    mm = c.motor_map
    if mode == 8:
        raw = list(sp)
    elif mode == 9:
        raw = [mm[4 * m] * sp[0] + mm[4 * m + 1] * sp[1] + mm[4 * m + 2] * sp[2] + mm[4 * m + 3] * sp[3]
               for m in range(4)]
    else:
        cmd = []
        pint, pprv = list(s["pint"]), list(s["pprv"])
        a_sp = sp
        if mode == 7:  # the position cascade (ENU): its ang-vel setpoint and thrust
            v = s["view"]
            cas = list(s["cas"])
            xy = _pid_bank_plain(cas, "lp", c, v[9:11], sp[0:2])
            cy, sy = torch.cos(v[5]), torch.sin(v[5])
            xy = [cy * xy[0] + sy * xy[1], -sy * xy[0] + cy * xy[1]]
            xy = _pid_bank_plain(cas, "lv", c, v[6:8], xy)
            a_sp = _pid_bank_plain(cas, "ap", c, v[3:6], [-xy[1], xy[0], sp[2]])
            z1 = _pid_bank_plain(cas, "zp", c, v[11:12], sp[3:4])
            z1 = _pid_bank_plain(cas, "zv", c, v[8:9], z1)
            s["cas"] = cas
        for k in range(3):
            err = a_sp[k] - s["view"][k]
            pint[k] = clip(pint[k] + c.ki[k] * err * c.period, -c.lim[k], c.lim[k])
            deriv = c.kd[k] * (err - pprv[k]) / c.period
            pprv[k] = err
            cmd.append(clip(c.kp[k] * err + pint[k] + deriv, -c.lim[k], c.lim[k]))
        if mode == 7:
            cmd.append(clip(z1[0], 0.0, 1.0))
        else:
            cmd.append(clip(-clip(sp[3], -1.0, 0.0), 0.0, 1.0) if ned else clip(sp[3], 0.0, 1.0))
        s["pint"], s["pprv"] = pint, pprv
        raw = [
            mm[4 * m] * cmd[0] + mm[4 * m + 1] * cmd[1]
            + mm[4 * m + 2] * cmd[2] + mm[4 * m + 3] * cmd[3]
            for m in range(4)
        ]
    high = torch.maximum(torch.maximum(raw[0], raw[1]), torch.maximum(raw[2], raw[3]))
    low = torch.minimum(torch.minimum(raw[0], raw[1]), torch.minimum(raw[2], raw[3]))
    pmax = torch.clamp(high, max=c.max_pwm)
    pmin = torch.clamp(low, min=c.min_pwm)
    d_add, d_sub = pmax - low, high - pmin
    f_add = torch.where(d_add != 0, (pmin - low) / torch.where(d_add != 0, d_add, 1.0), 0.0)
    f_sub = torch.where(d_sub != 0, (high - pmax) / torch.where(d_sub != 0, d_sub, 1.0), 0.0)
    s["pwm"] = [
        clip(torch.where(high != low, r + f_add * (pmax - r) - f_sub * (r - pmin), r),
             c.min_pwm, c.max_pwm)
        for r in raw
    ]


def _wind_plain(s: dict, wbase: list[Tensor] | None, c: GenericConsts, gen) -> list[Tensor] | None:
    """quadx_lane.cuh::wind_velocity: the ENU wind of one iteration."""
    like = s["contact"]
    if c.wind_kind == WIND_NONE:
        return None
    if c.wind_kind == WIND_SIMPLE:
        height = torch.clamp(s["pos"][2] + 1.0, min=0.0)
        thermal = torch.where(height > 0.0, torch.log(torch.clamp(height, min=1e-12)) * c.wind_strength, 0.0)
        g = torch.randn(3, like.shape[0], generator=gen, device=like.device)
        return [g[0], g[1], thermal + g[2]]
    base = wbase if c.wind_kind == WIND_GAUSSIAN_ENV else [torch.full_like(like, v) for v in c.wind_base]
    if c.max_gust > 0.0:
        g = torch.clamp(torch.randn(3, like.shape[0], generator=gen, device=like.device), -c.max_gust, c.max_gust)
        return [base[k] + g[k] for k in range(3)]
    return list(base)


def _physics_plain(s: dict, c, gen, noisy: bool, ned: bool, wind: list[Tensor] | None) -> None:
    """quadx_lane.cuh::physics: one physics iteration, in place on ``s``."""
    like = s["contact"]
    thr = list(s["thr"])
    nrm = torch.randn(4, like.shape[0], generator=gen, device=like.device) if noisy else None
    for m in range(4):
        thr[m] = thr[m] + c.lag[m] * (s["pwm"][m] - thr[m])
        if noisy:
            thr[m] = thr[m] + nrm[m] * thr[m] * c.noise_ratio[m]
    s["thr"] = thr
    fz = tx = ty = tz = torch.zeros_like(like)
    for m in range(4):
        rpm = thr[m] * c.max_rpm[m]
        rc = rpm * rpm * torch.sign(rpm)
        f = rc * c.thrust_coef[m]
        fz = fz + f
        tx = tx + c.mpos_y[m] * f
        ty = ty - c.mpos_x[m] * f
        tz = tz + rc * c.torque_coef[m]
    drg, avb = s["drg"], s["avb"]
    fd = [-torch.sign(drg[k]) * c.drag_xyz[k] * drg[k] * drg[k] for k in range(3)]
    nc = 1.0 - s["contact"]
    tx = tx - nc * torch.sign(avb[0]) * c.drag_pqr * avb[0] * avb[0]
    ty = ty - nc * torch.sign(avb[1]) * c.drag_pqr * avb[1] * avb[1]
    tz = tz - nc * torch.sign(avb[2]) * c.drag_pqr * avb[2] * avb[2]
    fx, fy, fz = fd[0], fd[1], fz + fd[2]

    r = cm.quat_rotmat(s["quat"])
    lvel, avel, pos = s["lvel"], s["avel"], s["pos"]
    lvb = [r[k] * lvel[0] + r[3 + k] * lvel[1] + r[6 + k] * lvel[2] for k in range(3)]
    avb_new = [r[k] * avel[0] + r[3 + k] * avel[1] + r[6 + k] * avel[2] for k in range(3)]
    if wind is None:
        drg_new = lvb
    else:
        a = [lvel[k] - wind[k] for k in range(3)]
        drg_new = [r[k] * a[0] + r[3 + k] * a[1] + r[6 + k] * a[2] for k in range(3)]
    eul = cm.quat_to_euler(s["quat"])
    if ned:
        new_view = [avb_new[0], -avb_new[1], -avb_new[2],
                    eul[0], -eul[1], cm.HALF_PI - eul[2],
                    lvb[0], -lvb[1], -lvb[2],
                    pos[1], pos[0], -pos[2]]
    else:
        new_view = [*avb_new, *eul, *lvb, *pos]

    fw = [r[3 * k] * fx + r[3 * k + 1] * fy + r[3 * k + 2] * fz for k in range(3)]
    lvel = [lvel[0] + c.dt * (fw[0] / c.mass),
            lvel[1] + c.dt * (fw[1] / c.mass),
            lvel[2] + c.dt * (fw[2] / c.mass - GRAVITY)]
    I = c.inertia
    ob = avb_new
    gyro = [ob[1] * I[2] * ob[2] - ob[2] * I[1] * ob[1],
            ob[2] * I[0] * ob[0] - ob[0] * I[2] * ob[2],
            ob[0] * I[1] * ob[1] - ob[1] * I[0] * ob[0]]
    tq = [tx, ty, tz]
    obn = [ob[k] + c.dt * ((tq[k] - gyro[k]) / I[k]) for k in range(3)]
    avel = [r[3 * k] * obn[0] + r[3 * k + 1] * obn[1] + r[3 * k + 2] * obn[2] for k in range(3)]
    pos = [pos[k] + c.dt * lvel[k] for k in range(3)]
    quat = cm.quat_integrate(s["quat"], avel, c.dt)

    x, y, z, w = quat
    extent = (torch.abs(2 * (x * z - w * y)) * c.half_ext[0]
              + torch.abs(2 * (y * z + w * x)) * c.half_ext[1]
              + torch.abs(1 - 2 * (x * x + y * y)) * c.half_ext[2])
    depth = extent - pos[2]
    hit = depth > 0.0
    pos[2] = torch.where(hit, pos[2] + depth, pos[2])
    lvel[2] = torch.where(hit & (lvel[2] < 0.0), 0.0, lvel[2])
    s.update(pos=pos, quat=quat, lvel=lvel, avel=avel, view=new_view,
             avb=avb_new, drg=drg_new, contact=hit.to(like.dtype))


def _freeze(st: dict, nw: dict, frozen: Tensor) -> None:
    """The done-freeze as a select, in place on ``st``: a frozen lane keeps
    its registers, the others take ``nw``'s."""
    for key, old in st.items():
        if isinstance(old, list):
            st[key] = [torch.where(frozen, o, v) for o, v in zip(old, nw[key])]
        else:
            st[key] = torch.where(frozen, old, nw[key])


def _twin_generator(seed: Tensor, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed.reshape(()).item()))
    return gen


def packed_hover_step_plain(
    packed: Tensor,
    seed: Tensor,
    consts: HoverConsts,
    mode: int,
    noisy: bool,
    sparse: bool = False,
) -> Tensor:
    """The hover kernel's arithmetic in plain PyTorch, row by row (any
    device)."""
    _check_args(packed, seed, mode)
    c = consts
    S = list(packed.unbind(0))
    gen = _twin_generator(seed, packed.device) if noisy else None
    st = _unpack_rows(S, mode)
    st.update(term=S[_TERM], trunc=S[_TRUNC], coll=S[_COLL], oob=S[_OOB])
    sp = S[_SP:_SP + 4]
    stepc = S[_STEP]
    st["rwd"] = torch.full_like(stepc, -0.1)
    trunc_hit = (stepc > c.max_steps).to(stepc.dtype)

    for _ in range(c.inner_steps):
        frozen = torch.clamp(torch.maximum(st["term"], st["trunc"]), max=1.0) > 0.0
        nw = dict(st)
        any_contact = torch.zeros_like(stepc)
        for it in range(c.ratio):
            if it == 0:
                _control_plain(nw, sp, c, mode, ned=False)
            _physics_plain(nw, c, gen, noisy, ned=False, wind=None)
            any_contact = torch.maximum(any_contact, nw["contact"])
        vx, vy, vz = nw["view"][9], nw["view"][10], nw["view"][11]
        oob_i = ((vx * vx + vy * vy + vz * vz) > c.dome2).to(stepc.dtype)
        fatal = torch.maximum(any_contact, oob_i)
        nw["trunc"] = torch.clamp(nw["trunc"] + trunc_hit, max=1.0)
        rwd = torch.where(fatal > 0.0, -100.0, nw["rwd"])
        if not sparse:
            dz = vz - 1.0
            v3, v4 = nw["view"][3], nw["view"][4]
            rwd = rwd - torch.sqrt(vx * vx + vy * vy + dz * dz) - torch.sqrt(v3 * v3 + v4 * v4) + 1.0
        nw["rwd"] = rwd
        nw["term"] = torch.clamp(nw["term"] + fatal, max=1.0)
        nw["coll"] = torch.clamp(nw["coll"] + any_contact, max=1.0)
        nw["oob"] = torch.clamp(nw["oob"] + oob_i, max=1.0)
        _freeze(st, nw, frozen)

    out = [torch.zeros_like(stepc)] * rows_for(mode)
    _pack_rows(out, st, sp)
    out[_RWD] = st["rwd"]
    out[_TERM] = st["term"]
    out[_TRUNC] = st["trunc"]
    out[_COLL] = st["coll"]
    out[_OOB] = st["oob"]
    out[_STEP] = stepc + 1.0
    return torch.stack(out, dim=0)


def packed_step_plain(
    packed: Tensor,
    seed: Tensor,
    consts: GenericConsts,
    mode: int,
    noisy: bool,
    wind=None,
) -> Tensor:
    """The generic kernel's arithmetic in plain PyTorch, row by row (any
    device); ``wind`` as in ``packed_step``."""
    c = with_wind(consts, wind)
    _check_generic(packed, seed, mode, c)
    S = list(packed.unbind(0))
    stochastic = noisy or c.wind_kind == WIND_SIMPLE or (
        c.wind_kind in (WIND_GAUSSIAN, WIND_GAUSSIAN_ENV) and c.max_gust > 0.0
    )
    gen = _twin_generator(seed, packed.device) if stochastic else None
    st = _unpack_rows(S, mode)
    sp = S[_SP:_SP + 4]
    zero = torch.zeros_like(S[_CON])
    wbase = S[_WBASE:_WBASE + 3] if c.wind_kind == WIND_GAUSSIAN_ENV else None
    any_contact = zero
    for it in range(c.ratio):
        if it == 0:
            _control_plain(st, sp, c, mode, ned=bool(c.ned))
        w = _wind_plain(st, wbase, c, gen)
        _physics_plain(st, c, gen, noisy, ned=bool(c.ned), wind=w)
        any_contact = torch.maximum(any_contact, st["contact"])
    out = [zero] * rows_for(mode)
    _pack_rows(out, st, sp)
    out[_ANY] = any_contact
    if wbase is not None:
        out[_WBASE:_WBASE + 3] = wbase
    return torch.stack(out, dim=0)


def _waypoint_track_plain(R, lp, tgt, rem, ndist, nt: int, goal: float):
    """quadx_math.cuh::waypoint_track (pallas_math.py:239-294): body-frame
    deltas of the rolled targets, the distance to the current one, the
    masked delta observation, the reach and the cyclic advance. Returns
    ``(tgt, rem, ndist, odist, progress, tdlt, reached, all_reached)``."""
    deltas = []
    for k in range(nt):
        d = [tgt[3 * k + i] - lp[i] for i in range(3)]
        deltas.append([R[i] * d[0] + R[3 + i] * d[1] + R[6 + i] * d[2] for i in range(3)])
    d0 = deltas[0]
    ndist_new = torch.sqrt(d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2])
    progress = ndist - ndist_new
    zero = torch.zeros_like(rem)
    tdlt = []
    for k in range(MAX_TARGETS):
        keep = (rem > k + 0.5).to(rem.dtype) if k < nt else None
        tdlt += [deltas[k][i] * keep if k < nt else zero for i in range(3)]
    reached = (ndist_new < goal) & (rem > 0.5)
    n3 = 3 * nt
    tgt = [torch.where(reached, tgt[(j + 3) % n3], tgt[j]) for j in range(n3)] + list(tgt[n3:])
    rem = rem - reached.to(rem.dtype)
    return tgt, rem, ndist_new, ndist, progress, tdlt, reached, rem < 0.5


def packed_waypoints_step_plain(
    packed: Tensor,
    seed: Tensor,
    consts: WaypointsConsts,
    mode: int,
    noisy: bool,
    sparse: bool = False,
) -> Tensor:
    """The waypoints kernel's arithmetic in plain PyTorch, row by row (any
    device)."""
    c = consts
    _check_waypoints(packed, seed, mode, c)
    S = list(packed.unbind(0))
    gen = _twin_generator(seed, packed.device) if noisy else None
    wb = rows_for(mode)
    st = _unpack_rows(S, mode)
    st.update(term=S[_TERM], trunc=S[_TRUNC], coll=S[_COLL], oob=S[_OOB],
              tgt=S[wb + _WP_TGT : wb + _WP_TGT + 12], rem=S[wb + _WP_REM], ndist=S[wb + _WP_NDIST],
              odist=S[wb + _WP_ODIST], tdlt=S[wb + _WP_TDLT : wb + _WP_TDLT + 12], cplt=S[wb + _WP_CPLT])
    sp = S[_SP:_SP + 4]
    stepc = S[_STEP]
    st["rwd"] = torch.full_like(stepc, -0.1)
    trunc_hit = (stepc > c.max_steps).to(stepc.dtype)
    one = torch.ones_like(stepc)

    for _ in range(c.inner_steps):
        frozen = torch.clamp(torch.maximum(st["term"], st["trunc"]), max=1.0) > 0.0
        nw = dict(st)
        any_contact = torch.zeros_like(stepc)
        for it in range(c.ratio):
            if it == 0:
                _control_plain(nw, sp, c, mode, ned=False)
            quat_pre = nw["quat"]
            _physics_plain(nw, c, gen, noisy, ned=False, wind=None)
            any_contact = torch.maximum(any_contact, nw["contact"])
        # the task update on the lagged position, deltas rotated by the last
        # iteration's pre-integration rotation (pallas_quadx.py:677-680)
        vx, vy, vz = nw["view"][9], nw["view"][10], nw["view"][11]
        oob_i = ((vx * vx + vy * vy + vz * vz) > c.dome2).to(stepc.dtype)
        fatal = torch.maximum(any_contact, oob_i)
        trunc = torch.clamp(nw["trunc"] + trunc_hit, max=1.0)
        rwd = torch.where(fatal > 0.0, -100.0, nw["rwd"])
        (nw["tgt"], nw["rem"], ndist, nw["odist"], progress, nw["tdlt"], reached,
         all_reached) = _waypoint_track_plain(cm.quat_rotmat(quat_pre), (vx, vy, vz), nw["tgt"], nw["rem"],
                                              nw["ndist"], c.num_targets, c.goal)
        nw["ndist"] = ndist
        if not sparse:
            rwd = rwd + torch.clamp(3.0 * progress, min=0.0) + 0.1 / ndist
        nw["rwd"] = torch.where(reached, 100.0, rwd)
        nw["trunc"] = torch.where(all_reached, one, trunc)
        nw["cplt"] = torch.where(all_reached, one, nw["cplt"])
        nw["term"] = torch.clamp(nw["term"] + fatal, max=1.0)
        nw["coll"] = torch.clamp(nw["coll"] + any_contact, max=1.0)
        nw["oob"] = torch.clamp(nw["oob"] + oob_i, max=1.0)
        _freeze(st, nw, frozen)

    out = [torch.zeros_like(stepc)] * rows_for_waypoints(mode)
    _pack_rows(out, st, sp)
    out[_RWD] = st["rwd"]
    out[_TERM] = st["term"]
    out[_TRUNC] = st["trunc"]
    out[_COLL] = st["coll"]
    out[_OOB] = st["oob"]
    out[_STEP] = stepc + 1.0
    out[wb + _WP_TGT : wb + _WP_TGT + 12] = st["tgt"]
    out[wb + _WP_REM] = st["rem"]
    out[wb + _WP_NDIST] = st["ndist"]
    out[wb + _WP_ODIST] = st["odist"]
    out[wb + _WP_TDLT : wb + _WP_TDLT + 12] = st["tdlt"]
    out[wb + _WP_CPLT] = st["cplt"]
    return torch.stack(out, dim=0)
