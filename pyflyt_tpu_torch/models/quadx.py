"""QuadX (CrazyFlie 2.x) quadrotor: dynamics and flight controller (port of
``pyflyt_tpu/models/quadx.py``).

Per physics iteration, as in the JAX module:
  1. update_control   (at control_hz; uses the lagged read state)
  2. update_physics   (throttle lag + noise, wrench from the lagged state)
  3. update_state     (reads the pre-integration state: one-step latency)
  4. integrate        (semi-implicit Euler at physics_hz)

Flight modes, each in ENU_FLU and NED_FRD:
  -1 raw motor PWM | 0 vp,vq,vr,T | 1 p,q,r,vz | 2 vp,vq,vr,z | 3 p,q,r,z
   4 u,v,vr,z | 5 u,v,vr,vz | 6 vx,vy,vr,vz | 7 x,y,r,z
   8 direct PWM | 9 motor mix of RPYT | 10 gain-scheduled state feedback
A ``custom_controller(view, setpoint) -> setpoint`` runs before the mode's
controller; wind enters through ``step(wind_fn=...)`` (``core/wind.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.core import integrator
from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.core.params import load_vehicle_json
from pyflyt_tpu_torch.core.state import Body6DoF
from pyflyt_tpu_torch.device import resolve_device
from pyflyt_tpu_torch.ops import motors, pid
from pyflyt_tpu_torch.ops.ga_pid import ga_pid_step

MODES = tuple(range(-1, 11))


def check_mode(mode: int) -> None:
    if mode not in MODES:
        raise ValueError(f"quadx flight mode must be in -1..10, got {mode}")


# ---------------------------------------------------------------------------
# configuration & parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuadXConfig:
    drone_model: str = "cf2x"
    control_hz: int = 120
    physics_hz: int = 240
    orn_conv: str = "ENU_FLU"
    noisy_motors: bool = True
    min_pwm: float = 0.05
    max_pwm: float = 1.0
    model_dir: str | None = None
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.physics_hz % self.control_hz != 0:
            raise ValueError(
                f"`control_hz` ({self.control_hz}) must be a round denominator "
                f"of `physics_hz` ({self.physics_hz})."
            )
        if self.orn_conv not in ("ENU_FLU", "NED_FRD"):
            raise ValueError(f"unknown orn_conv {self.orn_conv!r}")

    @property
    def physics_period(self) -> float:
        return 1.0 / self.physics_hz

    @property
    def control_period(self) -> float:
        return 1.0 / self.control_hz

    @property
    def physics_control_ratio(self) -> int:
        return self.physics_hz // self.control_hz


@dataclasses.dataclass
class QuadXParams:
    mass: Tensor
    inertia: Tensor  # (3,)
    collision_half_extents: Tensor  # (3,)
    motor: motors.MotorParams
    motor_map: Tensor  # (4, 4) command [r, p, y, T] -> per-motor PWM
    drag_const_xyz: Tensor  # (3,) = ½ρ·Cd·A per axis
    drag_coef_pqr: Tensor  # scalar
    pid_ang_vel: pid.PIDParams
    pid_ang_pos: pid.PIDParams
    pid_lin_vel: pid.PIDParams
    pid_lin_pos: pid.PIDParams
    pid_z_pos: pid.PIDParams
    pid_z_vel: pid.PIDParams


_MOTOR_MAP_NED = np.array(
    [
        [-1.0, +1.0, +1.0, +1.0],
        [+1.0, -1.0, +1.0, +1.0],
        [+1.0, +1.0, -1.0, +1.0],
        [-1.0, -1.0, -1.0, +1.0],
    ]
)
_MOTOR_MAP_ENU = np.array(
    [
        [-1.0, -1.0, -1.0, +1.0],
        [+1.0, +1.0, -1.0, +1.0],
        [+1.0, -1.0, +1.0, +1.0],
        [-1.0, +1.0, +1.0, +1.0],
    ]
)


def build_params(cfg: QuadXConfig, device: str | torch.device = "cuda") -> QuadXParams:
    """Loads the vehicle file and assembles the parameter dataclass on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    y = load_vehicle_json(cfg.drone_model, cfg.model_dir)
    frame, mp, dp, ctl = (
        y["frame"], y["motor_params"], y["drag_params"], y["control_params"]
    )
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=cfg.dtype, device=device)  # noqa: E731

    n = len(mp["positions"])
    motor = motors.MotorParams(
        positions=t(mp["positions"]),
        thrust_unit=t(np.tile(np.asarray(mp["thrust_unit"]), (n, 1))),
        thrust_coef=t(np.full((n,), mp["thrust_coef"])),
        torque_coef=t(np.asarray(mp["torque_signs"]) * mp["torque_coef"]),
        tau=t(np.full((n,), mp["tau"])),
        max_rpm=t(np.full((n,), np.sqrt(mp["total_thrust"] / (4 * mp["thrust_coef"])))),
        noise_ratio=t(np.full((n,), mp["noise_ratio"])),
    )

    def bank(name):
        c = ctl[name]
        arr = lambda v: t(np.atleast_1d(v))  # noqa: E731
        return pid.PIDParams(
            kp=arr(c["kp"]), ki=arr(c["ki"]), kd=arr(c["kd"]), lim=arr(c["lim"]),
            period=cfg.control_period,
        )

    motor_map = _MOTOR_MAP_NED if cfg.orn_conv == "NED_FRD" else _MOTOR_MAP_ENU
    return QuadXParams(
        mass=t(frame["mass"]),
        inertia=t(frame["inertia"]),
        collision_half_extents=t(frame["collision_half_extents"]),
        motor=motor,
        motor_map=t(motor_map),
        drag_const_xyz=t(
            np.full((3,), 0.5 * 1.225 * dp["drag_coef_xyz"] * dp["drag_area_xyz"])
        ),
        drag_coef_pqr=t(dp["drag_coef_pqr"]),
        pid_ang_vel=bank("ang_vel"),
        pid_ang_pos=bank("ang_pos"),
        pid_lin_vel=bank("lin_vel"),
        pid_lin_pos=bank("lin_pos"),
        pid_z_pos=bank("z_pos"),
        pid_z_vel=bank("z_vel"),
    )


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QuadXPIDState:
    ang_vel: pid.PIDState  # (..., 3)
    ang_pos: pid.PIDState  # (..., 3)
    lin_vel: pid.PIDState  # (..., 2)
    lin_pos: pid.PIDState  # (..., 2)
    z_pos: pid.PIDState  # (..., 1)
    z_vel: pid.PIDState  # (..., 1)


@dataclasses.dataclass
class QuadXRead:
    """The lagged sensor snapshot consumed by control, physics and obs."""

    view: Tensor  # (..., 4, 3) [ang_vel, ang_pos, lin_vel, lin_pos] in orn_conv
    ang_vel_body: Tensor  # (..., 3) ENU body rates
    drag_local_vel: Tensor  # (..., 3) body-frame air-relative velocity


@dataclasses.dataclass
class QuadXState:
    body: Body6DoF
    read: QuadXRead
    throttle: Tensor  # (..., 4)
    pwm: Tensor  # (..., 4)
    setpoint: Tensor  # (..., 4)
    pids: QuadXPIDState
    contact: Tensor  # (...,) bool
    physics_steps: Tensor  # (...,) int32


def init_pids(params: QuadXParams, batch_shape: tuple[int, ...] = ()) -> QuadXPIDState:
    mk = lambda p: pid.init(p, batch_shape)  # noqa: E731
    return QuadXPIDState(
        ang_vel=mk(params.pid_ang_vel),
        ang_pos=mk(params.pid_ang_pos),
        lin_vel=mk(params.pid_lin_vel),
        lin_pos=mk(params.pid_lin_pos),
        z_pos=mk(params.pid_z_pos),
        z_vel=mk(params.pid_z_vel),
    )


def update_state(
    body: Body6DoF, cfg: QuadXConfig, wind_vel: Tensor | None = None
) -> QuadXRead:
    """The read snapshot from the raw body state; the drag reads the
    body-frame air velocity ``R^T (lin_vel - wind_vel)``."""
    R = pm.quat_to_rotmat(body.quat)
    lin_vel_b = torch.einsum("...ji,...j->...i", R, body.lin_vel)
    ang_vel_b = torch.einsum("...ji,...j->...i", R, body.ang_vel)
    euler = pm.quat_to_euler(body.quat)
    if cfg.orn_conv == "NED_FRD":
        lin_pos = pm.enu_pos_to_ned(body.pos)
        ang_pos = pm.enu_euler_to_ned(euler)
        lin_vel = pm.flu_vec_to_frd(lin_vel_b)
        ang_vel = pm.flu_vec_to_frd(ang_vel_b)
    else:
        lin_pos, ang_pos, lin_vel, ang_vel = body.pos, euler, lin_vel_b, ang_vel_b
    view = torch.stack([ang_vel, ang_pos, lin_vel, lin_pos], dim=-2)
    if wind_vel is None:
        drag_local_vel = lin_vel_b
    else:
        drag_local_vel = torch.einsum("...ji,...j->...i", R, body.lin_vel - wind_vel)
    return QuadXRead(view=view, ang_vel_body=ang_vel_b, drag_local_vel=drag_local_vel)


def init_state(
    params: QuadXParams,
    cfg: QuadXConfig,
    start_pos: Tensor,
    start_orn: Tensor,
    wind_vel: Tensor | None = None,
) -> QuadXState:
    """The reset state; ``start_pos``/``start_orn`` are in the configured
    orientation convention, with leading batch dims."""
    if cfg.orn_conv == "NED_FRD":
        pos_enu = pm.ned_pos_to_enu(start_pos)
        orn_enu = pm.ned_euler_to_enu(start_orn)
    else:
        pos_enu, orn_enu = start_pos, start_orn
    batch = tuple(start_pos.shape[:-1])
    body = Body6DoF(
        pos=pos_enu,
        quat=pm.euler_to_quat(orn_enu),
        lin_vel=torch.zeros_like(pos_enu),
        ang_vel=torch.zeros_like(pos_enu),
    )
    z4 = start_pos.new_zeros((*batch, 4))
    return QuadXState(
        body=body,
        read=update_state(body, cfg, wind_vel),
        throttle=z4,
        pwm=z4.clone(),
        setpoint=z4.clone(),
        pids=init_pids(params, batch),
        contact=torch.zeros(batch, dtype=torch.bool, device=start_pos.device),
        physics_steps=torch.zeros(batch, dtype=torch.int32, device=start_pos.device),
    )


def mode_default_setpoint(state: QuadXState, mode: int, cfg: QuadXConfig) -> Tensor:
    """Setpoint preset applied on a mode change."""
    check_mode(mode)
    view = state.read.view
    if mode in (-1, 8, 9, 10):
        return state.setpoint  # these modes leave the setpoint untouched
    if mode == 7:  # hold the current [x, y, yaw, z]
        return torch.stack([view[..., 3, 0], view[..., 3, 1], view[..., 1, 2], view[..., 3, 2]], dim=-1)
    sp = view.new_zeros(view.shape[:-2] + (4,))
    if mode == 0:
        sp[..., 3] = -1.0
    elif mode in (2, 3, 4):  # hold the current height
        sp[..., 3] = view[..., 3, 2]
    return sp  # modes 1, 5 and 6: zeros


def set_mode(state: QuadXState, mode: int, cfg: QuadXConfig) -> QuadXState:
    """Resets the PIDs and applies the mode's default setpoint."""
    zero = lambda s: pid.reset(s)  # noqa: E731
    p = state.pids
    pids = QuadXPIDState(
        ang_vel=zero(p.ang_vel), ang_pos=zero(p.ang_pos), lin_vel=zero(p.lin_vel),
        lin_pos=zero(p.lin_pos), z_pos=zero(p.z_pos), z_vel=zero(p.z_vel),
    )
    return dataclasses.replace(
        state, setpoint=mode_default_setpoint(state, mode, cfg), pids=pids
    )


# ---------------------------------------------------------------------------
# control
# ---------------------------------------------------------------------------


def _pid_lanes(
    st: pid.PIDState, pp: pid.PIDParams, meas: Tensor, setp: Tensor, n: int
) -> tuple[pid.PIDState, Tensor]:
    """Steps a PID on its first ``n`` lanes and keeps the other lanes'
    registers."""
    sub = pid.PIDState(st.integral[..., :n], st.prev_error[..., :n])
    sub_p = pid.PIDParams(kp=pp.kp[..., :n], ki=pp.ki[..., :n], kd=pp.kd[..., :n], lim=pp.lim[..., :n],
                          period=pp.period)
    new_sub, out = pid.step(sub, sub_p, meas, setp)
    return (
        pid.PIDState(
            torch.cat([new_sub.integral, st.integral[..., n:]], dim=-1),
            torch.cat([new_sub.prev_error, st.prev_error[..., n:]], dim=-1),
        ),
        out,
    )


def _yaw_frame(view: Tensor, xy: Tensor) -> Tensor:
    """Rotates a ground-frame xy command into the yaw frame."""
    yaw = view[..., 1, 2]
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([c * xy[..., 0] + s * xy[..., 1], -s * xy[..., 0] + c * xy[..., 1]], dim=-1)


def _attitude(
    pids: QuadXPIDState, params: QuadXParams, view: Tensor, a: Tensor, mode: int, ned: bool
) -> tuple[QuadXPIDState, Tensor]:
    """The attitude cascade of modes 0-7 down to the ang-vel PID's output.
    Modes 0/2 command body rates, 1/3 angles; modes 4-7 go lin_pos (7
    only) -> yaw frame (6, 7) -> lin_vel -> the ENU/NED axis swap ->
    ang_pos, on lanes 0-1 in modes 4-6 (lane 2's registers kept) and on
    all three in mode 7. In NED, modes 4-6 take the JAX module's reading of
    the reference: ``[a1, -a0]`` on the xy lanes, yaw kept."""
    if mode in (1, 3):
        pids_ap, a = pid.step(pids.ang_pos, params.pid_ang_pos, view[..., 1, :], a)
        pids = dataclasses.replace(pids, ang_pos=pids_ap)
    elif mode in (4, 5, 6, 7):
        xy, yaw_cmd = a[..., :2], a[..., 2:3]
        if mode == 7:
            pids_lp, xy = pid.step(pids.lin_pos, params.pid_lin_pos, view[..., 3, :2], xy)
            pids = dataclasses.replace(pids, lin_pos=pids_lp)
        if mode in (6, 7):
            xy = _yaw_frame(view, xy)
        pids_lv, xy = pid.step(pids.lin_vel, params.pid_lin_vel, view[..., 2, :2], xy)
        # velocity command -> attitude command axis swap
        if ned:
            xy = torch.stack([xy[..., 1], -xy[..., 0]], dim=-1)
        else:
            xy = torch.stack([-xy[..., 1], xy[..., 0]], dim=-1)
        if mode == 7:
            pids_ap, a = pid.step(pids.ang_pos, params.pid_ang_pos, view[..., 1, :], torch.cat([xy, yaw_cmd], dim=-1))
        else:
            pids_ap, xy = _pid_lanes(pids.ang_pos, params.pid_ang_pos, view[..., 1, :2], xy, 2)
            a = torch.cat([xy, yaw_cmd], dim=-1)
        pids = dataclasses.replace(pids, lin_vel=pids_lv, ang_pos=pids_ap)
    pids_av, a = pid.step(pids.ang_vel, params.pid_ang_vel, view[..., 0, :], a)
    return dataclasses.replace(pids, ang_vel=pids_av), a


def _height(
    pids: QuadXPIDState, params: QuadXParams, view: Tensor, z: Tensor, mode: int, ned: bool
) -> tuple[QuadXPIDState, Tensor]:
    """The height cascade of modes 0-7 down to the thrust command: mode 0
    passes its thrust, modes 1/5/6 go through z_vel, modes 2/3/4/7 go
    z_pos -> z_vel; then the NED sign and the clip to [0, 1]."""
    if mode in (2, 3, 4, 7):
        pids_zp, z1 = pid.step(pids.z_pos, params.pid_z_pos, view[..., 3, 2:3], z[..., None])
        pids_zv, z1 = pid.step(pids.z_vel, params.pid_z_vel, view[..., 2, 2:3], z1)
        pids = dataclasses.replace(pids, z_pos=pids_zp, z_vel=pids_zv)
        z = z1[..., 0]
    else:
        if mode in (1, 5, 6):
            pids_zv, z1 = pid.step(pids.z_vel, params.pid_z_vel, view[..., 2, 2:3], z[..., None])
            pids = dataclasses.replace(pids, z_vel=pids_zv)
            z = z1[..., 0]
        z = torch.clamp(z, -1.0, 0.0) if ned else torch.clamp(z, 0.0, 1.0)
    if ned:
        z = -z
    return pids, torch.clamp(z, 0.0, 1.0)


def update_control(
    state: QuadXState,
    params: QuadXParams,
    cfg: QuadXConfig,
    mode: int,
    custom_controller=None,
) -> QuadXState:
    """Runs the mode's controller; returns the state with new pwm + PIDs.

    ``custom_controller``: an optional ``(..., 4, 3) view, setpoint ->
    setpoint`` function applied first, in every mode; its output is the
    setpoint of ``mode``'s controller for this call (the state keeps the
    setpoint it was given)."""
    check_mode(mode)
    view = state.read.view
    sp = state.setpoint
    if custom_controller is not None:
        sp = custom_controller(view, sp)
    pids = state.pids
    ned = cfg.orn_conv == "NED_FRD"

    if mode == -1:
        # raw PWM, returned before the saturation step: no rescale, no clamp
        return dataclasses.replace(state, pwm=sp, pids=pids)
    if mode == 8:
        pwm = sp
    elif mode == 9:
        pwm = torch.einsum("ij,...j->...i", params.motor_map, sp)
    elif mode == 10:
        pwm = torch.einsum("ij,...j->...i", params.motor_map, ga_pid_step(view, sp))
    else:
        pids, a = _attitude(pids, params, view, sp[..., :3], mode, ned)
        pids, z = _height(pids, params, view, sp[..., 3], mode, ned)
        cmd = torch.cat([a, z[..., None]], dim=-1)
        pwm = torch.einsum("ij,...j->...i", params.motor_map, cmd)

    pwm = saturation_rescale(pwm, cfg.min_pwm, cfg.max_pwm)
    return dataclasses.replace(state, pwm=pwm, pids=pids)


def _safe_div(n: Tensor, d: Tensor) -> Tensor:
    return torch.where(d != 0.0, n / torch.where(d == 0.0, torch.ones_like(d), d), 0.0)


def saturation_rescale(pwm: Tensor, min_pwm: float, max_pwm: float) -> Tensor:
    """Motor saturation handling that keeps the command's shape."""
    high = torch.amax(pwm, dim=-1, keepdim=True)
    low = torch.amin(pwm, dim=-1, keepdim=True)
    pwm_max = torch.clamp(high, max=max_pwm)
    pwm_min = torch.clamp(low, min=min_pwm)
    add = _safe_div(pwm_min - low, pwm_max - low) * (pwm_max - pwm)
    sub = _safe_div(high - pwm_max, high - pwm_min) * (pwm - pwm_min)
    rescaled = torch.where(high != low, pwm + add - sub, pwm)
    return torch.clamp(rescaled, min_pwm, max_pwm)


# ---------------------------------------------------------------------------
# physics
# ---------------------------------------------------------------------------


def _wrench(
    read: QuadXRead, throttle: Tensor, contact: Tensor, params: QuadXParams
) -> tuple[Tensor, Tensor]:
    """Body-frame (force, torque): motors + body drag + pqr pseudo-drag
    (the latter skipped while in contact)."""
    f_mot, t_mot = motors.wrench(throttle, params.motor)
    v = read.drag_local_vel
    f_drag = -torch.sign(v) * params.drag_const_xyz * v * v
    w = read.ang_vel_body
    t_pqr = -torch.sign(w) * params.drag_coef_pqr * w * w
    t_pqr = torch.where(contact[..., None], 0.0, t_pqr)
    return f_mot + f_drag, t_mot + t_pqr


def _contact_geom(params: QuadXParams) -> integrator.ContactGeom:
    """The eight corners of the collision box."""
    h = params.collision_half_extents
    signs = h.new_tensor(
        [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]
    )
    return integrator.ContactGeom(points=signs * h)


def physics_iter(
    state: QuadXState,
    params: QuadXParams,
    cfg: QuadXConfig,
    generator: torch.Generator | None,
    wind_vel: Tensor | None = None,
) -> QuadXState:
    """One physics iteration (control not included — see ``step``)."""
    throttle = motors.throttle_update(
        state.throttle, state.pwm, params.motor, cfg.physics_period,
        generator if cfg.noisy_motors else None,
    )
    force_b, torque_b = _wrench(state.read, throttle, state.contact, params)
    new_read = update_state(state.body, cfg, wind_vel)  # one-physics-step sensor latency
    rb = integrator.RigidBodyParams(mass=params.mass, inertia=params.inertia)
    body = integrator.step(state.body, rb, force_b, torque_b, cfg.physics_period)
    body, contact = integrator.ground_contact(body, rb, _contact_geom(params))
    return dataclasses.replace(
        state,
        body=body,
        read=new_read,
        throttle=throttle,
        contact=contact,
        physics_steps=state.physics_steps + 1,
    )


def step(
    state: QuadXState,
    params: QuadXParams,
    cfg: QuadXConfig,
    mode: int,
    generator: torch.Generator | None = None,
    wind_fn=None,
    custom_controller=None,
) -> tuple[QuadXState, Tensor]:
    """One aviary step: ``physics_control_ratio`` physics iterations with the
    controller at iteration 0. Returns ``(state, any_contact)``. Motor noise
    is drawn from ``generator`` (None: noise off); ``wind_fn(physics_steps,
    pos)`` (``core/wind.py``) gives the ENU wind before each iteration."""
    any_contact = torch.zeros_like(state.contact)
    for s in range(cfg.physics_control_ratio):
        if s == 0:
            state = update_control(state, params, cfg, mode, custom_controller)
        wind_vel = None
        if wind_fn is not None:
            wind_vel = wind_fn(state.physics_steps, state.body.pos)
        state = physics_iter(state, params, cfg, generator, wind_vel)
        any_contact = any_contact | state.contact
    return state, any_contact
