"""The QuadX kernels on a packed ``(ROWS, N)`` state (port of
``pyflyt_tpu/ops/pallas_quadx.py``).

Two kernels share one per-iteration body (``csrc/quadx_lane.cuh``):

- ``packed_hover_step`` (``csrc/quadx_hover_step.cu``, replaces
  ``pallas_quadx.packed_hover_step``): the whole QuadX-Hover agent step,
  ``inner_steps`` aviary steps plus reward, termination, truncation and
  the done-freeze; modes 0 and 8, ENU.
- ``packed_step`` (``csrc/quadx_step.cu``, replaces
  ``pallas_quadx.packed_step``): one aviary step, the generic variant;
  modes 0, 8 and 9, ENU or NED, wind none, a baked gaussian base, a
  per-env gaussian base (rows 51-53) or the simple thermal field. ``step``
  (replaces ``pallas_quadx.step``) is the drop-in for ``models.quadx.step``
  behind pack → kernel → unpack. Mode 7 and its 80-row layout are not
  here yet (ROADMAP.md, item 6, with the waypoints slice).

Each wrapper launches its CUDA kernel for a CUDA tensor and runs its plain
PyTorch twin (``*_plain``) for a CPU tensor. There is no fallback between
the two: a CUDA tensor launches the kernel or raises.

Layout: SoA ``(ROWS, N)`` f32, one column per env, with the row indices of
the Pallas module so packed rows compare one to one. The TPU's
``(ROWS, 8, N/8)`` sublane fold is dropped: on the card one thread owns one
env and a warp's load of a row is one coalesced transaction. Any N works.

Bounds on an H100 at N=8192: the hover step reads 55 of the 56 f32 rows
and writes all 56 (3.64 MB, about 1.09 µs at 3.35 TB/s) and does about
2 kFLOP per env; the generic step reads 50 rows (53 with a per-env wind
base) and writes 56 (about 3.5 MB, 1.0 µs) and does about 1.1 kFLOP per
env at 3 physics iterations. Bytes bound both, and launch latency and each
thread's dependent chain cost more. See the source notes for the designs.

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
from pyflyt_tpu_torch.ops import cuda_math as cm
from pyflyt_tpu_torch.ops.cuda_build import Kernel

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

GRAVITY = 9.81
# f32 operations per env in one physics iteration, control, wind draw and
# hover task update, counted from the kernel sources (adds, multiplies,
# divides, compares, transcendentals each 1) — the operation side of the
# kernels' bounds
OPS_PER_PHYSICS_ITER = 330
OPS_PER_CONTROL = 75
OPS_PER_TASK_UPDATE = 30
OPS_PER_WIND = 12

# wind kinds of the generic kernel (csrc/quadx_lane.cuh::Wind)
WIND_NONE, WIND_GAUSSIAN, WIND_GAUSSIAN_ENV, WIND_SIMPLE = 0, 1, 2, 3
GENERIC_MODES = (0, 8, 9)


def pack_state(state: quadx.QuadXState) -> Tensor:
    """Batched ``QuadXState`` (N,) → ``(ROWS, N)`` f32; env rows zero."""
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
    packed = torch.cat([r.to(torch.float32) for r in rows], dim=0)
    pad = packed.new_zeros((ROWS - packed.shape[0], n))
    return torch.cat([packed, pad], dim=0).contiguous()


def unpack_state(packed: Tensor, template: quadx.QuadXState) -> quadx.QuadXState:
    """``(ROWS, N)`` → ``QuadXState``; PID banks outside the layout keep the
    template's values."""
    g = lambda r, k: packed[r : r + k].T  # noqa: E731
    n = packed.shape[1]
    pids = dataclasses.replace(
        template.pids,
        ang_vel=dataclasses.replace(
            template.pids.ang_vel, integral=g(_PINT, 3), prev_error=g(_PPRV, 3)
        ),
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


def _floats(n: int):
    """A dataclass field of ``n`` floats (a ``float[n]`` in the C struct)."""
    return dataclasses.field(metadata={"len": n})


@dataclasses.dataclass(frozen=True)
class HoverConsts:
    """Vehicle and task constants of one hover env, as Python floats.

    The kernel gets them as one POD struct by value (``_HoverConstsC``,
    whose fields are these, in this order); the twin reads the same values,
    so both round them identically.
    """

    mass: float
    inertia: tuple = _floats(3)
    motor_map: tuple = _floats(16)  # row-major (4, 4)
    mpos_x: tuple = _floats(4)
    mpos_y: tuple = _floats(4)
    thrust_coef: tuple = _floats(4)
    torque_coef: tuple = _floats(4)
    lag: tuple = _floats(4)  # physics_period / tau
    max_rpm: tuple = _floats(4)
    noise_ratio: tuple = _floats(4)
    drag_xyz: tuple = _floats(3)
    drag_pqr: float
    kp: tuple = _floats(3)
    ki: tuple = _floats(3)
    kd: tuple = _floats(3)
    lim: tuple = _floats(3)
    period: float
    dt: float
    min_pwm: float
    max_pwm: float
    half_ext: tuple = _floats(3)
    dome2: float
    max_steps: float
    inner_steps: int
    ratio: int


@dataclasses.dataclass(frozen=True)
class GenericConsts:
    """Vehicle constants of the generic step (``HoverConsts`` without the
    task fields), the wind of the launch and the convention, as Python
    values: the kernel gets them as one POD struct by value
    (``_GenericConstsC``, these fields in this order)."""

    mass: float
    inertia: tuple = _floats(3)
    motor_map: tuple = _floats(16)  # row-major (4, 4)
    mpos_x: tuple = _floats(4)
    mpos_y: tuple = _floats(4)
    thrust_coef: tuple = _floats(4)
    torque_coef: tuple = _floats(4)
    lag: tuple = _floats(4)  # physics_period / tau
    max_rpm: tuple = _floats(4)
    noise_ratio: tuple = _floats(4)
    drag_xyz: tuple = _floats(3)
    drag_pqr: float
    kp: tuple = _floats(3)
    ki: tuple = _floats(3)
    kd: tuple = _floats(3)
    lim: tuple = _floats(3)
    period: float
    dt: float
    min_pwm: float
    max_pwm: float
    half_ext: tuple = _floats(3)
    wind_base: tuple = _floats(3)  # WIND_GAUSSIAN: the baked base, ENU
    max_gust: float  # gaussian kinds: the gust clip (0: no gusts)
    wind_strength: float  # WIND_SIMPLE: the thermal strength
    wind_kind: int
    ned: int
    ratio: int


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
        **_vehicle(params, cfg),
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
        **_vehicle(params, cfg), **_wind_fields(wind), ned=int(cfg.orn_conv == "NED_FRD")
    )


@functools.lru_cache(maxsize=32)
def _with_wind(consts: GenericConsts, key: tuple) -> GenericConsts:
    return dataclasses.replace(consts, **dict(key))


def with_wind(consts: GenericConsts, wind) -> GenericConsts:
    """``consts`` with another wind baked in (None keeps ``consts``)."""
    if wind is None:
        return consts
    return _with_wind(consts, tuple(sorted(_wind_fields(wind).items())))


def ops_per_env(c: HoverConsts) -> int:
    """f32 operations one hover agent step does per env (for the bound)."""
    per_aviary = OPS_PER_CONTROL + c.ratio * OPS_PER_PHYSICS_ITER + OPS_PER_TASK_UPDATE
    return c.inner_steps * per_aviary


def generic_ops_per_env(c: GenericConsts) -> int:
    """f32 operations one generic aviary step does per env (for the bound)."""
    wind = 0 if c.wind_kind == WIND_NONE else OPS_PER_WIND
    return OPS_PER_CONTROL + c.ratio * (OPS_PER_PHYSICS_ITER + wind)


def generic_rows_read(c: GenericConsts) -> int:
    """The f32 rows the generic kernel reads per env: the drone's 50, and
    the per-env wind base where it has one."""
    return _CON + 1 + (3 if c.wind_kind == WIND_GAUSSIAN_ENV else 0)


def _ctype(f: dataclasses.Field):
    if "len" in f.metadata:
        return ctypes.c_float * f.metadata["len"]
    return {"float": ctypes.c_float, "int": ctypes.c_int}[f.type]


class _ConstsC(ctypes.Structure):
    @classmethod
    @functools.lru_cache(maxsize=16)  # one per env config; saves host time per launch
    def of(cls, c) -> "_ConstsC":
        s = cls()
        for name, _ in cls._fields_:
            v = getattr(c, name)
            if isinstance(v, tuple):
                getattr(s, name)[:] = v
            else:
                setattr(s, name, v)
        return s


class _HoverConstsC(_ConstsC):
    """Mirror of ``struct HoverConsts`` in csrc/quadx_hover_step.cu, field
    by field from ``HoverConsts`` (a test holds the C struct to it)."""

    _fields_ = [(f.name, _ctype(f)) for f in dataclasses.fields(HoverConsts)]


class _GenericConstsC(_ConstsC):
    """Mirror of ``struct GenericConsts`` in csrc/quadx_step.cu, field by
    field from ``GenericConsts`` (a test holds the C struct to it)."""

    _fields_ = [(f.name, _ctype(f)) for f in dataclasses.fields(GenericConsts)]


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


def _check_packed(packed: Tensor, seed: Tensor) -> None:
    if packed.dtype != torch.float32 or packed.dim() != 2 or packed.shape[0] != ROWS:
        raise ValueError(f"packed must be ({ROWS}, N) float32, got {tuple(packed.shape)} {packed.dtype}")
    if seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != packed.device:
        raise ValueError("seed must be one int64 on the packed state's device")


def _check_args(packed: Tensor, seed: Tensor, mode: int) -> None:
    if mode not in (0, 8):
        raise NotImplementedError(
            f"the fused hover step covers modes 0 and 8, not {mode}"
        )
    _check_packed(packed, seed)


def _check_generic(packed: Tensor, seed: Tensor, mode: int) -> None:
    if mode == 7:
        raise NotImplementedError(
            "mode 7 in the generic QuadX step needs the position cascade and "
            "its 80-row layout: ROADMAP.md, item 6 (quadx mode 7), with the "
            "waypoints slice (slice 5)"
        )
    if mode not in GENERIC_MODES:
        raise NotImplementedError(
            f"the generic QuadX step covers modes 0, 8 and 9, not {mode} "
            "(models/quadx.step runs the others it has)"
        )
    _check_packed(packed, seed)


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
    """One full hover agent step on the packed ``(ROWS, N)`` state: returns
    the new packed state (a new tensor). ``seed`` is a one-element int64
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
    _check_generic(packed, seed, mode)
    consts = with_wind(consts, wind)
    if packed.device.type == "cpu":
        return packed_step_plain(packed, seed, consts, mode, noisy)
    return _launch(GENERIC_KERNEL, packed, seed, _GenericConstsC.of(consts), mode, int(noisy))


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
    packed = pack_state(state)
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


def _unpack_rows(S: list[Tensor]) -> dict:
    """The drone rows 0-49 of ``S`` (a list of row tensors) by name."""
    return {
        "pos": S[_POS:_POS + 3], "quat": S[_QUAT:_QUAT + 4],
        "lvel": S[_LVEL:_LVEL + 3], "avel": S[_AVEL:_AVEL + 3],
        "view": S[_VIEW:_VIEW + 12], "avb": S[_AVB:_AVB + 3],
        "drg": S[_DRG:_DRG + 3], "thr": S[_THR:_THR + 4],
        "pwm": S[_PWM:_PWM + 4], "pint": S[_PINT:_PINT + 3],
        "pprv": S[_PPRV:_PPRV + 3], "contact": S[_CON],
    }


def _pack_rows(out: list, st: dict, sp: list[Tensor]) -> None:
    for base, key in ((_POS, "pos"), (_QUAT, "quat"), (_LVEL, "lvel"),
                      (_AVEL, "avel"), (_VIEW, "view"), (_AVB, "avb"),
                      (_DRG, "drg"), (_THR, "thr"), (_PWM, "pwm"),
                      (_PINT, "pint"), (_PPRV, "pprv")):
        for k, v in enumerate(st[key]):
            out[base + k] = v
    out[_SP:_SP + 4] = sp
    out[_CON] = st["contact"]


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
        for k in range(3):
            err = sp[k] - s["view"][k]
            pint[k] = clip(pint[k] + c.ki[k] * err * c.period, -c.lim[k], c.lim[k])
            deriv = c.kd[k] * (err - pprv[k]) / c.period
            pprv[k] = err
            cmd.append(clip(c.kp[k] * err + pint[k] + deriv, -c.lim[k], c.lim[k]))
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
    st = _unpack_rows(S)
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
        # done-freeze as a select
        for key, old in st.items():
            if isinstance(old, list):
                st[key] = [torch.where(frozen, o, v) for o, v in zip(old, nw[key])]
            else:
                st[key] = torch.where(frozen, old, nw[key])

    out = [None] * ROWS
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
    _check_generic(packed, seed, mode)
    c = with_wind(consts, wind)
    S = list(packed.unbind(0))
    stochastic = noisy or c.wind_kind == WIND_SIMPLE or (
        c.wind_kind in (WIND_GAUSSIAN, WIND_GAUSSIAN_ENV) and c.max_gust > 0.0
    )
    gen = _twin_generator(seed, packed.device) if stochastic else None
    st = _unpack_rows(S)
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
    out = [zero] * ROWS
    _pack_rows(out, st, sp)
    out[_ANY] = any_contact
    if wbase is not None:
        out[_WBASE:_WBASE + 3] = wbase
    return torch.stack(out, dim=0)
