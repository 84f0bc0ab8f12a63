"""Fixedwing (small airplane) and acrowing: aerodynamics and the control
map (port of ``pyflyt_tpu/models/fixedwing.py``).

Five lifting surfaces and one puller motor on one rigid body assembled
from the vehicle file's point masses: total mass, CoM at the mass
centroid, full 3×3 point-mass inertia (the raised tail adds xz terms).
The same model serves ``drone_model="acrowing"``.

Per aviary step, as in the JAX module: control at iteration 0, then per
physics iteration the actuator and throttle lag (plus motor noise), the
aero and motor wrench from the lagged read, a fresh read from the
pre-integration state (one iteration of sensor lag), semi-implicit Euler
with the full inertia and the centroid ground contact.

Flight modes: -1 (raw ``[left_ail, right_ail, h_tail, v_tail, main_wing,
thrust]``) and 0 (``[roll, pitch, (unused), thrust]`` through the
surface-assist map).
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
from pyflyt_tpu_torch.ops import lifting_surfaces, motors

NUM_SURFACES = 5
MODES = (-1, 0)


def _check_mode(mode: int) -> None:
    if mode not in MODES:
        raise ValueError(f"fixedwing flight mode must be -1 or 0, got {mode}")


@dataclasses.dataclass(frozen=True)
class FixedwingConfig:
    drone_model: str = "fixedwing"
    control_hz: int = 120
    physics_hz: int = 240
    noisy_motors: bool = True
    starting_velocity: tuple = (20.0, 0.0, 0.0)
    model_dir: str | None = None
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.physics_hz % self.control_hz != 0:
            raise ValueError(
                f"`control_hz` ({self.control_hz}) must be a round denominator of `physics_hz` ({self.physics_hz})."
            )

    @property
    def physics_period(self) -> float:
        return 1.0 / self.physics_hz

    @property
    def physics_control_ratio(self) -> int:
        return self.physics_hz // self.control_hz


@dataclasses.dataclass
class FixedwingParams:
    mass: Tensor  # scalar
    inertia: Tensor  # (3, 3) full point-mass inertia about the CoM
    com_offset: Tensor  # (3,) base origin -> CoM, body frame
    contact_points: Tensor  # (k, 3) body-frame (base-origin) contact samples
    surfaces: lifting_surfaces.SurfaceParams
    motor: motors.MotorParams  # one motor, position CoM-relative
    assist_ids: Tensor  # (6,) int64: mode-0 setpoint gather indices
    assist_signs: Tensor  # (6,)


def build_params(cfg: FixedwingConfig, device: str | torch.device = "cuda") -> FixedwingParams:
    """Loads the vehicle file and assembles the parameters on ``device``;
    the composite mass, CoM and inertia are computed in float64."""
    dev = resolve_device(device)
    y = load_vehicle_json(cfg.drone_model, cfg.model_dir)
    frame, mp, ctl = y["frame"], y["motor_params"], y["control_params"]
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=cfg.dtype, device=dev)  # noqa: E731

    masses = np.asarray(frame["link_masses"], dtype=np.float64)
    positions = np.asarray(frame["link_positions"], dtype=np.float64)
    mass = masses.sum()
    com = (masses[:, None] * positions).sum(0) / mass
    d = positions - com
    inertia = np.zeros((3, 3))
    for m, di in zip(masses, d):
        inertia += m * (np.dot(di, di) * np.eye(3) - np.outer(di, di))

    motor = motors.MotorParams(
        positions=t([np.asarray(mp["position"]) - com]),
        thrust_unit=t([mp["thrust_unit"]]),
        thrust_coef=t([mp["thrust_coef"]]),
        torque_coef=t([mp["torque_coef"]]),
        tau=t([mp["tau"]]),
        max_rpm=t([np.sqrt(mp["total_thrust"] / mp["thrust_coef"])]),  # one motor: the full thrust
        noise_ratio=t([mp["noise_ratio"]]),
    )
    return FixedwingParams(
        mass=t(mass),
        inertia=t(inertia),
        com_offset=t(com),
        contact_points=t(frame["contact_points"]),
        surfaces=lifting_surfaces.build(y["surfaces"], dtype=cfg.dtype, device=dev),
        motor=motor,
        assist_ids=torch.as_tensor(ctl["surface_assist_ids"], dtype=torch.int64, device=dev),
        assist_signs=t(ctl["surface_assist_signs"]),
    )


@dataclasses.dataclass
class FixedwingRead:
    """The lagged sensor snapshot."""

    view: Tensor  # (..., 4, 3) [ang_vel_b, euler, lin_vel_b, lin_pos] of the base origin
    surface_local_vel: Tensor  # (..., 5, 3) body-frame air-relative surface velocities


@dataclasses.dataclass
class FixedwingState:
    body: Body6DoF  # CoM state, world ENU
    read: FixedwingRead
    actuation: Tensor  # (..., 5) surface deflections
    throttle: Tensor  # (..., 1)
    cmd: Tensor  # (..., 6) current actuator commands
    setpoint: Tensor  # (..., 6) in mode -1, (..., 4) in mode 0
    contact: Tensor  # (...,) bool
    physics_steps: Tensor  # (...,) int32


def _base_kinematics(body: Body6DoF, params: FixedwingParams) -> tuple[Tensor, Tensor, Tensor]:
    """(R, base_pos_world, base_vel_world) from the CoM state."""
    R = pm.quat_to_rotmat(body.quat)
    r = torch.einsum("...ij,j->...i", R, params.com_offset)
    base_pos = body.pos - r
    base_vel = body.lin_vel + torch.linalg.cross(body.ang_vel, -r)
    return R, base_pos, base_vel


def update_state(
    body: Body6DoF,
    params: FixedwingParams,
    cfg: FixedwingConfig,
    physics_steps: Tensor,
    wind_fn=None,
) -> FixedwingRead:
    """The read snapshot: the base origin's readouts and each surface's
    body-frame velocity relative to the air. ``wind_fn(physics_steps,
    pos)`` gives the ENU wind at the ``(..., 5, 3)`` surface positions, as
    in ``models/quadx``."""
    R, base_pos, base_vel = _base_kinematics(body, params)
    lin_vel_b = torch.einsum("...ji,...j->...i", R, base_vel)
    ang_vel_b = torch.einsum("...ji,...j->...i", R, body.ang_vel)
    euler = pm.quat_to_euler(body.quat)
    view = torch.stack([ang_vel_b, euler, lin_vel_b, base_pos], dim=-2)

    # world velocity of each surface: v_com + ω × R (r_s - r_com)
    r_s = torch.einsum("...ij,nj->...ni", R, params.surfaces.positions - params.com_offset)
    v_s = body.lin_vel[..., None, :] + torch.linalg.cross(body.ang_vel[..., None, :].expand_as(r_s), r_s)
    if wind_fn is not None:
        v_s = v_s - wind_fn(physics_steps, body.pos[..., None, :] + r_s)
    local = torch.einsum("...ji,...nj->...ni", R, v_s)
    return FixedwingRead(view=view, surface_local_vel=local)


def init_state(
    params: FixedwingParams,
    cfg: FixedwingConfig,
    start_pos: Tensor,
    start_orn: Tensor,
    mode: int = 0,
    start_vel: Tensor | None = None,
) -> FixedwingState:
    """The reset state: base origin at ``start_pos``, world velocity
    ``cfg.starting_velocity`` or ``start_vel``; leading batch dims."""
    _check_mode(mode)
    start_pos = start_pos.to(cfg.dtype)
    batch = tuple(start_pos.shape[:-1])
    quat = pm.euler_to_quat(start_orn.to(cfg.dtype))
    R = pm.quat_to_rotmat(quat)
    com_pos = start_pos + torch.einsum("...ij,j->...i", R, params.com_offset)
    if start_vel is None:
        vel = start_pos.new_tensor(cfg.starting_velocity).expand(start_pos.shape).clone()
    else:
        vel = start_vel.to(cfg.dtype)
    body = Body6DoF(pos=com_pos, quat=quat, lin_vel=vel, ang_vel=torch.zeros_like(com_pos))
    zeros = lambda n: start_pos.new_zeros((*batch, n))  # noqa: E731
    dev = start_pos.device
    return FixedwingState(
        body=body,
        read=update_state(body, params, cfg, torch.zeros(batch, dtype=torch.int32, device=dev)),
        actuation=zeros(NUM_SURFACES),
        throttle=zeros(1),
        cmd=zeros(6),
        setpoint=zeros(6 if mode == -1 else 4),
        contact=torch.zeros(batch, dtype=torch.bool, device=dev),
        physics_steps=torch.zeros(batch, dtype=torch.int32, device=dev),
    )


def update_control(state: FixedwingState, params: FixedwingParams, cfg: FixedwingConfig, mode: int) -> FixedwingState:
    """Maps the setpoint to the 6 actuator commands."""
    _check_mode(mode)
    if mode == -1:
        cmd = state.setpoint
    else:
        cmd = state.setpoint[..., params.assist_ids] * params.assist_signs
    return dataclasses.replace(state, cmd=cmd)


def physics_iter(
    state: FixedwingState,
    params: FixedwingParams,
    cfg: FixedwingConfig,
    generator: torch.Generator | None,
    wind_fn=None,
) -> FixedwingState:
    """One physics iteration (control not included, see ``step``); motor
    noise from ``generator`` when ``cfg.noisy_motors`` (None: off)."""
    actuation = lifting_surfaces.actuation_update(
        state.actuation, state.cmd[..., :NUM_SURFACES], params.surfaces, cfg.physics_period
    )
    throttle = motors.throttle_update(
        state.throttle, state.cmd[..., NUM_SURFACES:], params.motor, cfg.physics_period,
        generator if cfg.noisy_motors else None,
    )
    # the wrench from the lagged read
    f_aero, t_aero = lifting_surfaces.wrench(actuation, state.read.surface_local_vel, params.surfaces, params.com_offset)
    f_mot, t_mot = motors.wrench(throttle, params.motor)

    new_read = update_state(state.body, params, cfg, state.physics_steps, wind_fn)
    rb = integrator.RigidBodyParams(mass=params.mass, inertia=params.inertia, full_inertia=True)
    body = integrator.step(state.body, rb, f_aero + f_mot, t_aero + t_mot, cfg.physics_period)
    body, contact = integrator.ground_contact(
        body, rb, integrator.ContactGeom(points=params.contact_points - params.com_offset)
    )
    return dataclasses.replace(
        state, body=body, read=new_read, actuation=actuation, throttle=throttle, contact=contact,
        physics_steps=state.physics_steps + 1,
    )


def aux_state(state: FixedwingState) -> Tensor:
    """[surface deflections (5), motor throttle (1)]."""
    return torch.cat([state.actuation, state.throttle], dim=-1)


def step(
    state: FixedwingState,
    params: FixedwingParams,
    cfg: FixedwingConfig,
    mode: int,
    generator: torch.Generator | None = None,
    wind_fn=None,
) -> tuple[FixedwingState, Tensor]:
    """One aviary step: ``physics_control_ratio`` physics iterations with
    the control map at iteration 0. Returns ``(state, any_contact)``."""
    any_contact = torch.zeros_like(state.contact)
    for s in range(cfg.physics_control_ratio):
        if s == 0:
            state = update_control(state, params, cfg, mode)
        state = physics_iter(state, params, cfg, generator, wind_fn)
        any_contact = any_contact | state.contact
    return state, any_contact
