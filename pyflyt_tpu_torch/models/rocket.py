"""Rocket (a 1:10 Falcon-9-like booster): quadratic body drag, 4 grid-fin
lifting surfaces and a fueled, gimballed booster on one rigid body whose
mass, CoM and inertia track the remaining fuel every physics step (port of
``pyflyt_tpu/models/rocket.py``).

Setpoint (7): ``[finlet x, finlet y, finlet yaw, ignition, throttle,
gimbal axis 1, gimbal axis 2]``. Mode 0 only: the finlet mix matrix maps
``setpoint[:3]`` to the 4 finlet deflections, so
``cmd = [4 finlets, ignition, throttle, gimbal 1, gimbal 2]``.

Reference quirks kept on purpose, as the JAX module keeps them: the
finlets act at link ids 0-3 of the reference (fuel tank, booster and two
fins), not at the four fin links (``assets/vehicles/rocket.json``), and the
body drag acts at the fuel-tank link.

Per physics iteration, as in the JAX module: the body drag and the finlet
wrench from the lagged read with lever arms about the pre-burn CoM; the
gimbal lag and rotation; the booster (latch, floor, lag, noise, fuel-out,
burn); the post-burn composite; the boost wrench about the post-burn CoM;
a fresh read from the pre-integration state; semi-implicit Euler with the
full inertia; the impulse contact against the ground and, where given, a
raised landing pad.
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
from pyflyt_tpu_torch.ops import boosters, gimbals, lifting_surfaces

NUM_FINLETS = 4
PAD_RADIUS = 2.0  # the landing pad: a cylinder of radius 2 m
PAD_HALF_HEIGHT = 0.05  # and length 0.1 m


@dataclasses.dataclass(frozen=True)
class RocketConfig:
    drone_model: str = "rocket"
    control_hz: int = 120
    physics_hz: int = 240
    noisy_boosters: bool = True
    starting_fuel_ratio: float = 0.05
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
class RocketParams:
    # the dry frame's point masses and link inertias (the fuel apart)
    base_mass: Tensor
    base_inertia: Tensor  # (3,)
    base_position: Tensor  # (3,)
    booster_mass: Tensor
    booster_inertia: Tensor  # (3,)
    booster_position: Tensor  # (3,)
    fueltank_position: Tensor  # (3,)
    fin_mass: Tensor
    fin_positions: Tensor  # (4, 3)
    contact_points: Tensor  # (k, 3) body frame, base origin
    drag_const: Tensor  # (3,) ½ρ·Cd·A per axis
    drag_position: Tensor  # (3,) where the body drag acts (the fuel tank)
    finlets: lifting_surfaces.SurfaceParams
    booster: boosters.BoosterParams
    gimbal: gimbals.GimbalParams
    finlet_map: Tensor  # (4, 3)


def build_params(cfg: RocketConfig, device: str | torch.device = "cuda") -> RocketParams:
    """Loads the vehicle file into ``RocketParams`` on ``device``."""
    dev = resolve_device(device)
    y = load_vehicle_json(cfg.drone_model, cfg.model_dir)
    frame, bp, body, ctl = y["frame"], y["booster_params"], y["body_params"], y["control_params"]
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=cfg.dtype, device=dev)  # noqa: E731
    booster = boosters.BoosterParams(
        positions=t([frame["booster_position"]]),
        thrust_unit=t([bp["thrust_unit"]]),
        tau=t([bp["booster_tau"]]),
        total_fuel_mass=t([bp["total_fuel"]]),
        max_fuel_rate=t([bp["max_fuel_rate"]]),
        max_inertia=t([[bp["inertia_ixx"], bp["inertia_iyy"], bp["inertia_izz"]]]),
        min_thrust=t([bp["min_thrust"]]),
        max_thrust=t([bp["max_thrust"]]),
        reignitable=torch.tensor([bool(bp["reignitable"])], device=dev),
        noise_ratio=t([bp["noise_ratio"]]),
    )
    gimbal = gimbals.build(
        gimbal_unit_1=np.array([[1.0, 0.0, 0.0]]),
        gimbal_unit_2=np.array([[0.0, 1.0, 0.0]]),
        gimbal_tau=np.array([bp["gimbal_tau"]]),
        gimbal_range_degrees=np.array([[bp["gimbal_range_degrees"]] * 2]),
        dtype=cfg.dtype,
        device=dev,
    )
    drag = [0.5 * 1.225 * body[f"drag_coef_{a}"] * body[f"area_{a}"] for a in "xyz"]
    return RocketParams(
        base_mass=t(frame["base_mass"]),
        base_inertia=t(frame["base_inertia"]),
        base_position=t(frame["base_position"]),
        booster_mass=t(frame["booster_mass"]),
        booster_inertia=t(frame["booster_inertia"]),
        booster_position=t(frame["booster_position"]),
        fueltank_position=t(frame["fueltank_position"]),
        fin_mass=t(frame["fin_mass"]),
        fin_positions=t(frame["fin_positions"]),
        contact_points=t(frame["contact_points"]),
        drag_const=t(drag),
        drag_position=t(frame["fueltank_position"]),
        finlets=lifting_surfaces.build(y["finlets"], dtype=cfg.dtype, device=dev),
        booster=booster,
        gimbal=gimbal,
        finlet_map=t(ctl["finlet_map"]),
    )


def mass_properties(params: RocketParams, fuel_mass: Tensor, fuel_inertia: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The composite ``(mass, com, inertia 3×3)`` for the fuel load
    (``fuel_mass`` ``(..., 1)``, ``fuel_inertia`` ``(..., 1, 3)``): point
    masses and link inertias of [base, fuel tank, booster, 4 fins] shifted
    to the composite CoM."""
    fm = fuel_mass[..., 0]
    fi = fuel_inertia[..., 0, :]
    masses = [params.base_mass, fm, params.booster_mass] + [params.fin_mass] * 4
    positions = [params.base_position, params.fueltank_position, params.booster_position,
                 *params.fin_positions.unbind(0)]
    inertias = [params.base_inertia, fi, params.booster_inertia] + [torch.zeros_like(params.base_inertia)] * 4

    mass = sum(masses)
    com = sum(m[..., None] * p for m, p in zip(masses, positions)) / mass[..., None]
    eye = torch.eye(3, dtype=com.dtype, device=com.device)
    inertia = com.new_zeros(com.shape[:-1] + (3, 3))
    for m, p, i_diag in zip(masses, positions, inertias):
        d = p - com
        shift = m[..., None, None] * (
            torch.sum(d * d, dim=-1)[..., None, None] * eye - d[..., :, None] * d[..., None, :]
        )
        inertia = inertia + shift + i_diag[..., None] * eye
    return mass, com, inertia


@dataclasses.dataclass
class RocketRead:
    """The lagged sensor snapshot."""

    view: Tensor  # (..., 4, 3) [ang_vel_b, euler, lin_vel_b, lin_pos] of the base origin
    finlet_local_vel: Tensor  # (..., 4, 3) body-frame air-relative finlet velocities
    drag_local_vel: Tensor  # (..., 3) at the drag link, body frame


@dataclasses.dataclass
class RocketState:
    body: Body6DoF  # CoM state (the CoM of the current fuel load), world ENU
    read: RocketRead
    actuation: Tensor  # (..., 4) finlet deflections
    booster: boosters.BoosterState
    gimbal_state: Tensor  # (..., 1, 2)
    cmd: Tensor  # (..., 8)
    setpoint: Tensor  # (..., 7)
    contact: Tensor  # (...,) bool: any contact, ground or pad
    ground_contact: Tensor  # (...,) bool: contact off the pad
    pad_contact: Tensor  # (...,) bool
    physics_steps: Tensor  # (...,) int32


def update_state(
    body: Body6DoF,
    params: RocketParams,
    cfg: RocketConfig,
    com: Tensor,
    physics_steps: Tensor,
    wind_fn=None,
) -> RocketRead:
    """The read snapshot for CoM offset ``com`` (``(..., 3)``): the base
    origin's readouts and the body-frame air-relative velocities at the
    finlets and the drag link. ``wind_fn(physics_steps, pos)`` gives the
    ENU wind at ``(..., k, 3)`` positions, as in ``models/quadx``."""
    R = pm.quat_to_rotmat(body.quat)
    r = torch.einsum("...ij,...j->...i", R, com)
    base_pos = body.pos - r
    base_vel = body.lin_vel + torch.linalg.cross(body.ang_vel, -r)
    lin_vel_b = torch.einsum("...ji,...j->...i", R, base_vel)
    ang_vel_b = torch.einsum("...ji,...j->...i", R, body.ang_vel)
    view = torch.stack([ang_vel_b, pm.quat_to_euler(body.quat), lin_vel_b, base_pos], dim=-2)

    def local_vel_at(points: Tensor) -> Tensor:
        rp = torch.einsum("...ij,...nj->...ni", R, points - com[..., None, :])
        v = body.lin_vel[..., None, :] + torch.linalg.cross(body.ang_vel[..., None, :].expand_as(rp), rp)
        if wind_fn is not None:
            v = v - wind_fn(physics_steps, body.pos[..., None, :] + rp)
        return torch.einsum("...ji,...nj->...ni", R, v)

    return RocketRead(
        view=view,
        finlet_local_vel=local_vel_at(params.finlets.positions),
        drag_local_vel=local_vel_at(params.drag_position[None, :])[..., 0, :],
    )


def _fuel_com(params: RocketParams, fuel_ratio: Tensor) -> Tensor:
    """The CoM offset for the fuel ratio ``(..., 1)``."""
    fuel_mass = fuel_ratio * params.booster.total_fuel_mass
    fuel_inertia = fuel_ratio[..., None] * params.booster.max_inertia
    return mass_properties(params, fuel_mass, fuel_inertia)[1]


def init_state(
    params: RocketParams,
    cfg: RocketConfig,
    start_pos: Tensor,
    start_orn: Tensor,
    start_lin_vel: Tensor | None = None,
    start_ang_vel: Tensor | None = None,
) -> RocketState:
    """The reset state: base origin at ``start_pos``, fuel at
    ``cfg.starting_fuel_ratio``, optional initial velocities; leading batch
    dims."""
    start_pos = start_pos.to(cfg.dtype)
    batch = tuple(start_pos.shape[:-1])
    dev = start_pos.device
    bst = boosters.init(params.booster, batch, cfg.starting_fuel_ratio, dtype=cfg.dtype)
    com = _fuel_com(params, bst.ratio_fuel_remaining)
    quat = pm.euler_to_quat(start_orn.to(cfg.dtype))
    R = pm.quat_to_rotmat(quat)
    com_pos = start_pos + torch.einsum("...ij,...j->...i", R, com)
    lin_vel = torch.zeros_like(start_pos) if start_lin_vel is None else start_lin_vel.to(cfg.dtype).expand_as(start_pos)
    ang_vel = torch.zeros_like(start_pos) if start_ang_vel is None else start_ang_vel.to(cfg.dtype).expand_as(start_pos)
    body = Body6DoF(pos=com_pos, quat=quat, lin_vel=lin_vel, ang_vel=ang_vel)
    zeros = lambda *s: start_pos.new_zeros((*batch, *s))  # noqa: E731
    false = torch.zeros(batch, dtype=torch.bool, device=dev)
    steps = torch.zeros(batch, dtype=torch.int32, device=dev)
    return RocketState(
        body=body,
        read=update_state(body, params, cfg, com, steps),
        actuation=zeros(NUM_FINLETS),
        booster=bst,
        gimbal_state=gimbals.init(params.gimbal, batch, cfg.dtype),
        cmd=zeros(8),
        setpoint=zeros(7),
        contact=false,
        ground_contact=false.clone(),
        pad_contact=false.clone(),
        physics_steps=steps,
    )


def update_control(state: RocketState, params: RocketParams, cfg: RocketConfig) -> RocketState:
    """The finlet mix and the pass-through of the rest (mode 0)."""
    finlet_cmd = torch.clamp(torch.einsum("ij,...j->...i", params.finlet_map, state.setpoint[..., :3]), -1.0, 1.0)
    return dataclasses.replace(state, cmd=torch.cat([finlet_cmd, state.setpoint[..., 3:]], dim=-1))


def _pad_ground_heights(pts_w: Tensor, pad_position: Tensor | None) -> tuple[Tensor, Tensor]:
    """The ground height under each point ``(..., k, 3)``: the pad's top
    inside its radius, else 0. Returns ``(heights, on_pad)``."""
    if pad_position is None:
        z = pts_w.new_zeros(pts_w.shape[:-1])
        return z, torch.zeros(pts_w.shape[:-1], dtype=torch.bool, device=pts_w.device)
    d_xy = pts_w[..., :2] - pad_position[..., None, :2]
    on_pad = torch.sum(d_xy * d_xy, dim=-1) < PAD_RADIUS**2
    pad_top = pad_position[..., 2] + PAD_HALF_HEIGHT
    return torch.where(on_pad, pad_top[..., None], 0.0), on_pad


def physics_iter(
    state: RocketState,
    params: RocketParams,
    cfg: RocketConfig,
    generator: torch.Generator | None,
    wind_fn=None,
    pad_position: Tensor | None = None,
) -> RocketState:
    """One physics iteration (the control map is ``step``'s); booster noise
    from ``generator`` when ``cfg.noisy_boosters`` (None: off)."""
    cmd = state.cmd
    com_pre = _fuel_com(params, state.booster.ratio_fuel_remaining)

    # the body drag at the drag link, its lever arm about the pre-burn CoM
    v = state.read.drag_local_vel
    f_drag = -torch.sign(v) * params.drag_const * v * v
    t_drag = torch.linalg.cross((params.drag_position - com_pre).expand_as(f_drag), f_drag)

    actuation = lifting_surfaces.actuation_update(
        state.actuation, cmd[..., :NUM_FINLETS], params.finlets, cfg.physics_period
    )
    f_fin, t_fin = lifting_surfaces.wrench(actuation, state.read.finlet_local_vel, params.finlets, com_pre)

    # the gimbal, then the booster
    gimbal_state, rot = gimbals.compute_rotation(
        state.gimbal_state, cmd[..., 6:8][..., None, :], params.gimbal, cfg.physics_period
    )
    bst, thrust, fuel_mass, fuel_inertia = boosters.update(
        state.booster, params.booster, cmd[..., 4:5], torch.clamp(cmd[..., 5:6], 0.0, 1.0), cfg.physics_period,
        generator if cfg.noisy_boosters else None,
    )
    thrust_dir = torch.einsum("...nij,...nj->...ni", rot, params.booster.thrust_unit.expand(rot.shape[:-1]))
    f_boost_n = thrust[..., None] * thrust_dir  # (..., 1, 3)
    mass, com, inertia = mass_properties(params, fuel_mass, fuel_inertia)
    t_boost = torch.linalg.cross((params.booster.positions - com[..., None, :]).expand_as(f_boost_n), f_boost_n)
    f_boost = torch.sum(f_boost_n, dim=-2)
    t_boost = torch.sum(t_boost, dim=-2)

    new_read = update_state(state.body, params, cfg, com, state.physics_steps, wind_fn)
    rb = integrator.RigidBodyParams(mass=mass, inertia=inertia, full_inertia=True)
    body = integrator.step(state.body, rb, f_drag + f_fin + f_boost, t_drag + t_fin + t_boost, cfg.physics_period)

    # contact with the ground and the raised landing pad
    R = pm.quat_to_rotmat(body.quat)
    pts_b = params.contact_points - com[..., None, :]
    pts_w = body.pos[..., None, :] + torch.einsum("...ij,...nj->...ni", R, pts_b)
    heights, on_pad = _pad_ground_heights(pts_w, pad_position)
    penetrating = (heights - pts_w[..., 2]) > 0.0
    pad_contact = torch.any(on_pad & penetrating, dim=-1)
    ground_only = torch.any(~on_pad & penetrating, dim=-1)
    body, contact = integrator.ground_contact(body, rb, integrator.ContactGeom(points=pts_b), ground_z=heights)

    return dataclasses.replace(
        state, body=body, read=new_read, actuation=actuation, booster=bst, gimbal_state=gimbal_state,
        contact=contact, ground_contact=ground_only, pad_contact=pad_contact,
        physics_steps=state.physics_steps + 1,
    )


def aux_state(state: RocketState) -> Tensor:
    """[finlet deflections (4), booster states (3), gimbal states (2)]."""
    return torch.cat(
        [state.actuation, boosters.get_states(state.booster), state.gimbal_state.flatten(-2)], dim=-1
    )


def step(
    state: RocketState,
    params: RocketParams,
    cfg: RocketConfig,
    generator: torch.Generator | None = None,
    wind_fn=None,
    pad_position: Tensor | None = None,
) -> tuple[RocketState, Tensor, Tensor]:
    """One aviary step: ``physics_control_ratio`` physics iterations with
    the control map at iteration 0. Returns ``(state, any_ground_contact,
    any_pad_contact)`` over the step's iterations."""
    any_ground = torch.zeros_like(state.ground_contact)
    any_pad = torch.zeros_like(state.pad_contact)
    for s in range(cfg.physics_control_ratio):
        if s == 0:
            state = update_control(state, params, cfg)
        state = physics_iter(state, params, cfg, generator, wind_fn, pad_position)
        any_ground = any_ground | state.ground_contact
        any_pad = any_pad | state.pad_contact
    return state, any_ground, any_pad
