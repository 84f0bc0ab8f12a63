"""The multi-drone simulation orchestrator (port of
``pyflyt_tpu/core/aviary.py``): a static fleet configuration and pure state
transitions over a tuple of per-drone model states.

Kept from the JAX module:
- ``updates_per_step = physics_hz / min(control_hz)`` with per-drone control
  gating ``it % (physics_hz / control_hz_i) == 0``;
- per physics iteration: control -> physics (forces from the lagged read
  state) -> state read -> integrate;
- contact flags reset per aviary step; drone-drone contact by sphere
  proximity at each vehicle's ``collision_radius``;
- ``set_armed``: a disarmed drone gets no control or physics update but
  integrates ballistically under gravity, its read snapshot frozen;
- QuadX custom controllers, pure ``(view, setpoint) -> setpoint``
  functions over a base mode;
- a wind field ``wind_fn(physics_steps, pos)`` shared by all drones;
- static obstacles as ``core/camera.Boxes``: detection, and with
  ``obstacle_response=True`` a restitution-0 sphere-vs-box impulse;
- flight modes are part of the configuration: ``set_mode`` returns a new
  ``(Aviary, state)`` pair.

Where the JAX package ``vmap``s ``reset`` and ``step`` over aviaries, the
port batches them by a leading dimension: ``reset(batch=B)`` builds ``B``
independent copies of the fleet, every per-drone tensor ``(B, ...)``, and
``step`` steps them all. The random stream (motor and booster noise) is one
``torch.Generator`` in the state, where the JAX state carries a PRNG key;
the fixedwing and rocket handles draw noise always, as the JAX ones do, and
a wind field draws its own gusts per call. As in the JAX step, every drone
computes both its controlled and its ballistic branch and the armed mask
selects between them, so a step reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.core import camera, integrator
from pyflyt_tpu_torch.device import resolve_device
from pyflyt_tpu_torch.envs.base import tree_select
from pyflyt_tpu_torch.models import fixedwing, quadx, rocket


@dataclasses.dataclass
class AviaryState:
    drones: tuple  # per-drone model states (heterogeneous)
    armed: Tensor  # (n,) or (B, n) bool
    contact: Tensor  # (n,) or (B, n) bool: any contact during the last aviary step
    contact_matrix: Tensor  # (n, n) or (B, n, n) bool: drone-drone proximity contacts
    generator: torch.Generator | None  # motor and booster noise
    aviary_steps: Tensor  # () or (B,) int32
    physics_steps: Tensor  # () or (B,) int32


# ---------------------------------------------------------------------------
# per-type handles
# ---------------------------------------------------------------------------


def _zero_wrench(st) -> tuple[Tensor, Tensor]:
    return torch.zeros_like(st.body.pos), torch.zeros_like(st.body.pos)


class _QuadXHandle:
    collision_radius = 0.065

    def __init__(self, spec: "DroneSpec", physics_hz: int, device: torch.device):
        opts = spec.options
        self.mode = spec.mode
        self.custom_controller = spec.custom_controller
        self.cfg = quadx.QuadXConfig(
            drone_model=opts.get("drone_model", "cf2x"),
            control_hz=spec.control_hz,
            physics_hz=physics_hz,
            orn_conv=opts.get("orn_conv", "ENU_FLU"),
            noisy_motors=opts.get("noisy_motors", True),
            min_pwm=opts.get("min_pwm", 0.05),
            max_pwm=opts.get("max_pwm", 1.0),
        )
        self.params = quadx.build_params(self.cfg, device)

    @property
    def noisy(self) -> bool:
        return self.cfg.noisy_motors

    def init(self, start_pos: Tensor, start_orn: Tensor):
        st = quadx.init_state(self.params, self.cfg, start_pos, start_orn)
        return quadx.set_mode(st, self.mode, self.cfg)

    def set_mode(self, st, mode: int):
        return quadx.set_mode(st, mode, self.cfg)

    def control(self, st):
        return quadx.update_control(st, self.params, self.cfg, self.mode, self.custom_controller)

    def physics(self, st, generator, wind_fn):
        wind = None if wind_fn is None else wind_fn(st.physics_steps, st.body.pos)
        return quadx.physics_iter(st, self.params, self.cfg, generator if self.cfg.noisy_motors else None, wind)

    def ballistic(self, st):
        rb = integrator.RigidBodyParams(mass=self.params.mass, inertia=self.params.inertia)
        body = integrator.step(st.body, rb, *_zero_wrench(st), self.cfg.physics_period)
        body, contact = integrator.ground_contact(body, rb, quadx._contact_geom(self.params))
        # the read snapshot stays frozen while disarmed
        return dataclasses.replace(st, body=body, contact=contact, physics_steps=st.physics_steps + 1)

    def set_setpoint(self, st, sp: Tensor):
        return dataclasses.replace(st, setpoint=sp.to(self.cfg.dtype).expand_as(st.setpoint).clone())

    def view(self, st) -> Tensor:
        return st.read.view

    def aux(self, st) -> Tensor:
        return st.throttle

    def pos(self, st) -> Tensor:
        return st.body.pos


class _FixedwingHandle:
    collision_radius = 0.5

    def __init__(self, spec: "DroneSpec", physics_hz: int, device: torch.device):
        opts = spec.options
        self.mode = spec.mode
        self.cfg = fixedwing.FixedwingConfig(
            drone_model=opts.get("drone_model", "fixedwing"),
            control_hz=spec.control_hz,
            physics_hz=physics_hz,
            starting_velocity=tuple(opts.get("starting_velocity", (20.0, 0.0, 0.0))),
        )
        self.params = fixedwing.build_params(self.cfg, device)

    @property
    def noisy(self) -> bool:
        return self.cfg.noisy_motors

    def init(self, start_pos: Tensor, start_orn: Tensor):
        return fixedwing.init_state(self.params, self.cfg, start_pos, start_orn, self.mode)

    def set_mode(self, st, mode: int):
        # the setpoint zeroed at the mode's size
        return dataclasses.replace(st, setpoint=st.body.pos.new_zeros(st.body.pos.shape[:-1] + (6 if mode == -1 else 4,)))

    def control(self, st):
        return fixedwing.update_control(st, self.params, self.cfg, self.mode)

    def physics(self, st, generator, wind_fn):
        return fixedwing.physics_iter(st, self.params, self.cfg, generator, wind_fn)

    def ballistic(self, st):
        rb = integrator.RigidBodyParams(mass=self.params.mass, inertia=self.params.inertia, full_inertia=True)
        body = integrator.step(st.body, rb, *_zero_wrench(st), self.cfg.physics_period)
        body, contact = integrator.ground_contact(
            body, rb, integrator.ContactGeom(points=self.params.contact_points - self.params.com_offset)
        )
        return dataclasses.replace(st, body=body, contact=contact, physics_steps=st.physics_steps + 1)

    def set_setpoint(self, st, sp: Tensor):
        return dataclasses.replace(st, setpoint=sp.to(self.cfg.dtype).expand_as(st.setpoint).clone())

    def view(self, st) -> Tensor:
        return st.read.view

    def aux(self, st) -> Tensor:
        return fixedwing.aux_state(st)

    def pos(self, st) -> Tensor:
        return st.body.pos


class _RocketHandle:
    collision_radius = 0.6

    def __init__(self, spec: "DroneSpec", physics_hz: int, device: torch.device):
        opts = spec.options
        self.cfg = rocket.RocketConfig(
            drone_model=opts.get("drone_model", "rocket"),
            control_hz=spec.control_hz,
            physics_hz=physics_hz,
            starting_fuel_ratio=opts.get("starting_fuel_ratio", 0.05),
        )
        self.params = rocket.build_params(self.cfg, device)

    @property
    def noisy(self) -> bool:
        return self.cfg.noisy_boosters

    def init(self, start_pos: Tensor, start_orn: Tensor):
        return rocket.init_state(self.params, self.cfg, start_pos, start_orn)

    def set_mode(self, st, mode: int):
        if mode != 0:
            raise ValueError("rocket supports flight mode 0 only")
        return st

    def control(self, st):
        return rocket.update_control(st, self.params, self.cfg)

    def physics(self, st, generator, wind_fn):
        return rocket.physics_iter(st, self.params, self.cfg, generator, wind_fn)

    def ballistic(self, st):
        # the composite mass, CoM and inertia of the current fuel load
        ratio = st.booster.ratio_fuel_remaining
        mass, com, inertia = rocket.mass_properties(
            self.params, ratio * self.params.booster.total_fuel_mass, ratio[..., None] * self.params.booster.max_inertia
        )
        rb = integrator.RigidBodyParams(mass=mass, inertia=inertia, full_inertia=True)
        body = integrator.step(st.body, rb, *_zero_wrench(st), self.cfg.physics_period)
        body, contact = integrator.ground_contact(
            body, rb, integrator.ContactGeom(points=self.params.contact_points - com[..., None, :])
        )
        return dataclasses.replace(st, body=body, contact=contact, physics_steps=st.physics_steps + 1)

    def set_setpoint(self, st, sp: Tensor):
        return dataclasses.replace(st, setpoint=sp.to(self.cfg.dtype).expand_as(st.setpoint).clone())

    def view(self, st) -> Tensor:
        return st.read.view

    def aux(self, st) -> Tensor:
        return rocket.aux_state(st)

    def pos(self, st) -> Tensor:
        return st.body.pos


_HANDLE_TYPES: dict[str, type] = {
    "quadx": _QuadXHandle,
    "fixedwing": _FixedwingHandle,
    "rocket": _RocketHandle,
}


def register_drone_type(name: str, handle_cls: type) -> None:
    """Registers a vehicle handle class under ``name``: constructed as
    ``handle_cls(spec, physics_hz, device)``, with the built-in handles'
    methods."""
    _HANDLE_TYPES[name] = handle_cls


@dataclasses.dataclass(frozen=True)
class DroneSpec:
    """Static per-drone configuration."""

    drone_type: str = "quadx"
    control_hz: int = 120
    mode: int = 0
    options: Any = dataclasses.field(default_factory=dict)
    custom_controller: Callable | None = None  # quadx only


class Aviary:
    """A static fleet and its pure transition methods.

    ``specs`` gives per-drone control (mixed fleets, modes, rates); without
    it every drone is ``drone_type`` with ``drone_options``. ``obstacles``:
    optional ``core/camera.Boxes`` of static scene geometry (one scene for
    every copy), whose proximity feeds the per-drone contact flags; with
    ``obstacle_response=True`` each physics iteration also projects a drone
    out of the deepest box its bounding sphere enters and cancels its
    approaching normal velocity (restitution 0, no torque). Everything runs
    on ``device``: the card unless the caller passes ``device="cpu"``.
    """

    def __init__(
        self,
        start_pos,
        start_orn,
        drone_type: str | None = "quadx",
        drone_options: dict | None = None,
        specs: tuple[DroneSpec, ...] | None = None,
        physics_hz: int = 240,
        wind_fn=None,
        obstacles: camera.Boxes | None = None,
        obstacle_response: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.start_pos = np.asarray(start_pos, dtype=np.float32)
        self.start_orn = np.asarray(start_orn, dtype=np.float32)
        if self.start_pos.ndim != 2 or self.start_pos.shape[-1] != 3:
            raise ValueError(f"start_pos must be (n, 3), got {self.start_pos.shape}")
        n = self.start_pos.shape[0]
        if specs is None:
            specs = tuple(DroneSpec(drone_type=drone_type, options=dict(drone_options or {})) for _ in range(n))
        if len(specs) != n:
            raise ValueError(f"{len(specs)} specs for {n} drones")
        self.specs = tuple(specs)
        self.physics_hz = physics_hz
        self.wind_fn = wind_fn
        self.obstacles = None if obstacles is None else camera.materialize_rotations(obstacles)
        self.obstacle_response = obstacle_response and obstacles is not None
        self.handles = [_HANDLE_TYPES[s.drone_type](s, physics_hz, self.device) for s in self.specs]
        rates = [s.control_hz for s in self.specs]
        for hz in rates:
            if physics_hz % hz != 0:
                raise ValueError("`physics_hz` must be an integer multiple of every `control_hz`")
        # the rates must be multiples of the lowest, or the gating below
        # gives uneven control intervals
        lo = min(rates)
        for hz in rates:
            if hz % lo != 0:
                raise ValueError(
                    f"all `control_hz` must be integer multiples of the lowest ({lo}); got {sorted(set(rates))}"
                )
        self.updates_per_step = physics_hz // lo
        self.control_ratios = [physics_hz // hz for hz in rates]
        self._radii = torch.tensor([h.collision_radius for h in self.handles], device=self.device)

    @property
    def num_drones(self) -> int:
        return len(self.specs)

    def describe(self) -> str:
        """A human-readable dump of the fleet."""
        lines = [
            f"Aviary: {self.num_drones} drone(s), physics {self.physics_hz} Hz,"
            f" updates_per_step {self.updates_per_step},"
            f" wind={'yes' if self.wind_fn is not None else 'no'},"
            f" obstacles={0 if self.obstacles is None else self.obstacles.count}"
        ]
        for i, (s, h) in enumerate(zip(self.specs, self.handles)):
            lines.append(
                f"  [{i}] {s.drone_type} mode={s.mode} control={s.control_hz}Hz"
                f" spawn={self.start_pos[i].tolist()}"
                f" r_col={h.collision_radius}"
            )
        return "\n".join(lines)

    # ----- construction / reset -------------------------------------------
    def reset(self, generator: torch.Generator | None = None, batch: int | None = None) -> AviaryState:
        """The fleet at its spawns: one aviary (``batch=None``, the JAX
        shapes) or ``batch`` independent copies. ``generator`` draws the
        noise of the drones that have it on, and is required for them."""
        if generator is None and any(h.noisy for h in self.handles):
            raise ValueError("Aviary.reset needs a torch.Generator: a drone has its noise on")
        lead = () if batch is None else (batch,)
        t = lambda a: torch.as_tensor(a, device=self.device).expand(*lead, 3).clone()  # noqa: E731
        drones = tuple(h.init(t(p), t(o)) for h, p, o in zip(self.handles, self.start_pos, self.start_orn))
        n = self.num_drones
        false = lambda *s: torch.zeros(*lead, *s, dtype=torch.bool, device=self.device)  # noqa: E731
        steps = torch.zeros(lead, dtype=torch.int32, device=self.device)
        return AviaryState(
            drones=drones,
            armed=~false(n),
            contact=false(n),
            contact_matrix=false(n, n),
            generator=generator,
            aviary_steps=steps,
            physics_steps=steps.clone(),
        )

    # ----- setters ----------------------------------------------------------
    def set_setpoint(self, state: AviaryState, index: int, setpoint) -> AviaryState:
        """Drone ``index``'s setpoint: one for every copy, or ``(B, k)``."""
        drones = list(state.drones)
        sp = torch.as_tensor(setpoint, device=self.device)
        drones[index] = self.handles[index].set_setpoint(drones[index], sp)
        return dataclasses.replace(state, drones=tuple(drones))

    def set_all_setpoints(self, state: AviaryState, setpoints) -> AviaryState:
        for i, sp in enumerate(setpoints):
            state = self.set_setpoint(state, i, sp)
        return state

    def set_armed(self, state: AviaryState, armed) -> AviaryState:
        """``armed``: ``(n,)`` for every copy, or ``(B, n)``."""
        armed = torch.as_tensor(armed, dtype=torch.bool, device=self.device)
        return dataclasses.replace(state, armed=armed.expand_as(state.armed).clone())

    def set_mode(self, state: AviaryState, modes) -> tuple["Aviary", AviaryState]:
        """A new ``(Aviary, state)`` with the given flight modes (an int for
        every drone, or one each): the modes are part of the configuration."""
        if isinstance(modes, int):
            modes = [modes] * self.num_drones
        new_av = Aviary(
            self.start_pos,
            self.start_orn,
            specs=tuple(dataclasses.replace(s, mode=m) for s, m in zip(self.specs, modes)),
            physics_hz=self.physics_hz,
            wind_fn=self.wind_fn,
            obstacles=self.obstacles,
            obstacle_response=self.obstacle_response,
            device=self.device,
        )
        drones = tuple(h.set_mode(d, m) for h, d, m in zip(new_av.handles, state.drones, modes))
        return new_av, dataclasses.replace(state, drones=drones)

    # ----- readouts ---------------------------------------------------------
    def state(self, state: AviaryState, index: int) -> Tensor:
        """The ``(..., 4, 3)`` state view of drone ``index``."""
        return self.handles[index].view(state.drones[index])

    def aux_state(self, state: AviaryState, index: int) -> Tensor:
        return self.handles[index].aux(state.drones[index])

    def all_states(self, state: AviaryState) -> list[Tensor]:
        return [self.state(state, i) for i in range(self.num_drones)]

    # ----- stepping ---------------------------------------------------------
    def _positions(self, drones: tuple) -> Tensor:
        return torch.stack([h.pos(d) for h, d in zip(self.handles, drones)], dim=-2)  # (..., n, 3)

    def _pairwise_contacts(self, pos: Tensor) -> Tensor:
        n = self.num_drones
        eye = torch.eye(n, dtype=torch.bool, device=pos.device)
        if n == 1:
            return torch.zeros(pos.shape[:-2] + (1, 1), dtype=torch.bool, device=pos.device)
        dist = torch.linalg.vector_norm(pos[..., :, None, :] - pos[..., None, :, :], dim=-1)
        return (dist < self._radii[:, None] + self._radii[None, :]) & ~eye

    def _box_closest_points(self, pos: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """Sphere-vs-box support math shared by detection and response:
        ``pos`` (..., 3) centres -> ``(local, clamped, d2)`` in each box's
        frame, shaped (..., k, 3), (..., k, 3) and (..., k)."""
        ob = self.obstacles
        rel = pos[..., None, :] - ob.centers
        local = torch.einsum("kji,...kj->...ki", ob.rotations, rel)
        clamped = torch.clamp(local, -ob.half_extents, ob.half_extents)
        d2 = torch.sum((local - clamped) ** 2, dim=-1)
        return local, clamped, d2

    def _obstacle_contacts(self, pos: Tensor) -> Tensor:
        """(..., n) bool: each drone's sphere within a box."""
        if self.obstacles is None:
            return torch.zeros(pos.shape[:-1], dtype=torch.bool, device=pos.device)
        _, _, d2 = self._box_closest_points(pos)  # (..., n, k)
        return torch.any(d2 < (self._radii[:, None] ** 2), dim=-1)

    def _obstacle_impulse(self, body, radius: float):
        """Restitution-0 sphere-vs-box response: projects the body out of
        the deepest-penetrating box and cancels its approaching normal
        velocity; no torque (the sphere is centred on the CoM)."""
        ob = self.obstacles
        local, clamped, d2 = self._box_closest_points(body.pos)  # (..., k, ...)
        outside = d2 > 1e-12
        dist = torch.sqrt(torch.clamp(d2, min=1e-12))
        n_out = (local - clamped) / dist[..., None]
        # a centre inside the box: out along the least-penetrated face
        face_gap = ob.half_extents - torch.abs(local)
        axis = torch.argmin(face_gap, dim=-1)
        sign = torch.sign(torch.gather(local, -1, axis[..., None])[..., 0])
        sign = torch.where(sign == 0.0, 1.0, sign)
        n_in = sign[..., None] * torch.nn.functional.one_hot(axis, 3).to(local.dtype)
        pen = torch.where(outside, radius - dist, radius + torch.amin(face_gap, dim=-1))
        n_local = torch.where(outside[..., None], n_out, n_in)
        n_world = torch.einsum("kij,...kj->...ki", ob.rotations, n_local)
        k_best = torch.argmax(pen, dim=-1, keepdim=True)
        pen_best = torch.gather(pen, -1, k_best)  # (..., 1)
        n_b = torch.gather(n_world, -2, k_best[..., None].expand(*k_best.shape[:-1], 1, 3))[..., 0, :]
        hit = pen_best > 0.0
        v_n = torch.clamp(torch.sum(body.lin_vel * n_b, dim=-1, keepdim=True), max=0.0)
        return dataclasses.replace(
            body,
            pos=torch.where(hit, body.pos + torch.clamp(pen_best, min=0.0) * n_b, body.pos),
            lin_vel=torch.where(hit, body.lin_vel - v_n * n_b, body.lin_vel),
        )

    def step(self, state: AviaryState) -> AviaryState:
        """One aviary step: ``updates_per_step`` physics iterations."""
        n = self.num_drones
        lead = state.armed.shape[:-1]
        any_contact = torch.zeros(*lead, n, dtype=torch.bool, device=self.device)
        any_matrix = torch.zeros(*lead, n, n, dtype=torch.bool, device=self.device)
        drones = list(state.drones)
        for it in range(self.updates_per_step):
            for i, (h, ratio) in enumerate(zip(self.handles, self.control_ratios)):
                # both branches for every drone, then a select: no host read
                armed_i = state.armed[..., i]
                if it % ratio == 0:
                    drones[i] = tree_select(armed_i, h.control(drones[i]), drones[i])
                stepped = h.physics(drones[i], state.generator, self.wind_fn)
                drones[i] = tree_select(armed_i, stepped, h.ballistic(drones[i]))
                if self.obstacle_response:
                    body = self._obstacle_impulse(drones[i].body, h.collision_radius)
                    drones[i] = dataclasses.replace(drones[i], body=body)
            pos = self._positions(drones)
            matrix = self._pairwise_contacts(pos)
            contacts = torch.stack([d.contact for d in drones], dim=-1)
            any_contact = any_contact | contacts | torch.any(matrix, dim=-1) | self._obstacle_contacts(pos)
            any_matrix = any_matrix | matrix
        return dataclasses.replace(
            state,
            drones=tuple(drones),
            contact=any_contact,
            contact_matrix=any_matrix,
            aviary_steps=state.aviary_steps + 1,
            physics_steps=state.physics_steps + self.updates_per_step,
        )
