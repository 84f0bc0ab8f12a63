"""Multi-agent Fixedwing Dogfight, batched over arenas (port of
``pyflyt_tpu/envs/ma_fixedwing_dogfight.py``).

``N`` arenas of two acrowings each: every state tensor is ``(N, 2, ...)``
(arena-shared values ``(N,)``), where the JAX package ``vmap``s one arena.

Semantics as in the JAX module (which cites the reference line by line):
- gun origin 0.35 m behind the CG along the forward vector;
- a hit iff the angle to the opponent < ``lethal_angle_radians``, the
  distance < ``lethal_distance`` and chasing (|angle| < π/2); health −=
  ``damage_per_hit`` per hit taken;
- engagement rewards from the PREVIOUS aviary step's memos (the
  reference's reward memo fires before its state memo): + closing distance
  (chasing, out of range), + 10·angle progress and + 3/(angle + 0.1) (in
  range), + 30 per hit scored, − 20 per hit taken; − 3000 on collision or
  leaving the dome;
- termination on collision, out-of-dome or fewer than 2 agents alive at
  the step's start; health ≤ 0 alone does not terminate (``wins`` info);
  truncation once the step count (before this step's increment) exceeds
  ``max_steps``;
- observation (30,): [own 12-state with the gun position, own health,
  opponent relative 12-state, opponent health, past action];
- spawn: a pair ≥ 0.2·dome apart at ``spawn_height`` (rejection sampling,
  here a masked redraw of the arenas still too close until none is),
  random attitude (roll/pitch ±1 rad, yaw ±2π), 10 m/s forward, then 10
  stabilization aviary steps;
- drone-drone collision by sphere proximity.

The random stream is one ``torch.Generator`` per batch (spawns and motor
noise), where the JAX env carries a key per arena.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.core import camera as cam
from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.device import resolve_device
from pyflyt_tpu_torch.envs.ma_quadx_hover import MAStepOut
from pyflyt_tpu_torch.models import fixedwing

CONTROL_HZ = 120
GUN_OFFSET = 0.35  # m behind the CG along the forward vector


@dataclasses.dataclass
class DogfightState:
    drones: fixedwing.FixedwingState  # batched (N, 2)
    generator: torch.Generator | None  # spawns and motor noise of the batch
    step_count: Tensor  # (N,) int32
    alive: Tensor  # (N, 2) bool
    current_actions: Tensor  # (N, 2, action_size)
    past_actions: Tensor  # (N, 2, action_size)
    health: Tensor  # (N, 2)
    current_hits: Tensor  # (N, 2) bool: hit scored BY agent i
    current_angles: Tensor  # (N, 2)
    current_offsets: Tensor  # (N, 2)
    current_distance: Tensor  # (N,)
    prev_angles: Tensor  # (N, 2): one aviary step older (reward memo lag)
    prev_distance: Tensor  # (N,)
    observations: Tensor  # (N, 2, obs_size)


def compute_rotation_forward(orn: Tensor) -> tuple[Tensor, Tensor]:
    """Euler → (body→world rotation, forward vector)."""
    R = pm.euler_to_rotmat(orn)
    c, s = torch.cos(orn), torch.sin(orn)
    forward = torch.stack([c[..., 2] * c[..., 1], s[..., 2] * c[..., 1], -s[..., 1]], dim=-1)
    return R, forward


def observation_pair(view: Tensor, health: Tensor, past_actions: Tensor) -> Tensor:
    """The ``(N, 2, 30)`` observation pair from the lagged views ``(N, 2, 4,
    3)``, the healths ``(N, 2)`` after this step's hits and the past
    actions: the observation half of ``_compute_agent_states``."""
    n = view.shape[0]
    rotation, forward = compute_rotation_forward(view[:, :, 1])
    gun = view[:, :, 3] - forward * GUN_OFFSET
    att = torch.cat([view[:, :, :3], gun[:, :, None]], dim=2)
    opp = att.flip(1)
    separation = gun.flip(1) - gun
    ground_vel = torch.einsum("nmij,nmj->nmi", rotation, att[:, :, 2])
    opp_lin_vel = torch.einsum("nmj,nmji->nmi", ground_vel.flip(1), rotation) - att[:, :, 2]
    opp_lin_pos = torch.einsum("nmj,nmji->nmi", separation, rotation)
    opponent = torch.stack([opp[:, :, 0], opp[:, :, 1] - att[:, :, 1], opp_lin_vel, opp_lin_pos], dim=2)
    return torch.cat([
        att.reshape(n, 2, 12), health[..., None], opponent.reshape(n, 2, 12), health.flip(1)[..., None],
        past_actions,
    ], dim=-1)


@dataclasses.dataclass(frozen=True)
class MAFixedwingDogfightEnv:
    spawn_height: float = 15.0
    damage_per_hit: float = 0.02
    lethal_distance: float = 15.0
    lethal_angle_radians: float = 0.1
    assisted_flight: bool = True
    sparse_reward: bool = False
    flight_dome_size: float = 150.0
    max_duration_seconds: float = 60.0
    agent_hz: int = 30
    drone_model: str = "acrowing"
    collision_radius: float = 0.5
    noisy_motors: bool = True  # booster-noise toggle (parity testing)
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if CONTROL_HZ % self.agent_hz != 0:
            raise ValueError(f"`agent_hz` must be a round denominator of {CONTROL_HZ}.")
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def num_agents(self) -> int:
        return 2

    @property
    def possible_agents(self) -> list[str]:
        return ["uav_0", "uav_1"]

    @property
    def env_step_ratio(self) -> int:
        return CONTROL_HZ // self.agent_hz

    @property
    def max_steps(self) -> int:
        return int(self.agent_hz * self.max_duration_seconds)

    @functools.cached_property
    def cfg(self) -> fixedwing.FixedwingConfig:
        return fixedwing.FixedwingConfig(drone_model=self.drone_model, control_hz=CONTROL_HZ,
                                         noisy_motors=self.noisy_motors)

    @functools.cached_property
    def params(self) -> fixedwing.FixedwingParams:
        return fixedwing.build_params(self.cfg, self.device)

    @property
    def obs_size(self) -> int:
        # the reference's actual emission: 30 assisted, 32 unassisted
        return 12 + 1 + 12 + 1 + self.action_size

    @property
    def action_size(self) -> int:
        """4 RPYT commands, or 6 "actuator" commands when
        ``assisted_flight=False``. As in the reference (and the JAX env),
        6-dim actions still go through the mode-0 surface-assist map
        ``setpoint[[0,0,1,1,2,3]] * [1,-1,1,-1,0,1]``: action dims 4-5 are
        dead and thrust is read from index 3."""
        return 4 if self.assisted_flight else 6

    def action_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        high = np.ones(self.action_size)
        low = -np.ones(self.action_size)
        low[-1] = 0.0
        return low, high

    def _generator(self, generator: torch.Generator | None) -> torch.Generator | None:
        return generator if self.noisy_motors else None

    # ----- spawning ---------------------------------------------------------
    def _sample_spawn(self, num_arenas: int, generator: torch.Generator | None) -> tuple[Tensor, Tensor]:
        """Positions ≥ 0.2·dome apart: every arena still too close draws a
        new pair, until none is (the JAX env's per-arena rejection loop)."""
        dtype, dev = self.cfg.dtype, self.device
        min_sep = 0.2 * self.flight_dome_size
        pos = torch.zeros(num_arenas, 2, 3, dtype=dtype, device=dev)
        redraw = torch.ones(num_arenas, dtype=torch.bool, device=dev)
        while bool(redraw.any()):
            draw = (torch.rand((num_arenas, 2, 3), generator=generator, dtype=dtype, device=dev) - 0.5)
            draw = draw * self.flight_dome_size * 0.5
            draw[..., 2] = self.spawn_height
            pos = torch.where(redraw[:, None, None], draw, pos)
            redraw = torch.linalg.vector_norm(pos[:, 0] - pos[:, 1], dim=-1) < min_sep
        scale = torch.tensor([1.0, 1.0, 2.0 * math.pi], dtype=dtype, device=dev)
        orn = (torch.rand((num_arenas, 2, 3), generator=generator, dtype=dtype, device=dev) - 0.5) * 2.0 * scale
        return pos, orn

    # ----- engagement geometry ---------------------------------------------
    def _agent_states(self, state: DogfightState) -> DogfightState:
        """Hits, health decrement, the memo shift and the observation pair."""
        view = state.drones.read.view  # (N, 2, 4, 3)
        _, forward = compute_rotation_forward(view[:, :, 1])
        gun = view[:, :, 3] - forward * GUN_OFFSET
        separation = gun.flip(1) - gun  # self -> opponent
        distance = torch.linalg.vector_norm(separation[:, 0], dim=-1)
        cos = torch.sum(separation * forward, dim=-1) / torch.clamp(distance, min=1e-8)[:, None]
        angles = torch.arccos(torch.clamp(cos, -1.0, 1.0))
        offsets = torch.linalg.vector_norm(torch.linalg.cross(separation, forward), dim=-1)
        hits = (angles < self.lethal_angle_radians) & (distance < self.lethal_distance)[:, None] & (
            torch.abs(angles) < math.pi / 2.0)
        health = state.health - self.damage_per_hit * hits.flip(1).to(state.health.dtype)
        return dataclasses.replace(
            state,
            health=health,
            current_hits=hits,
            current_angles=angles,
            current_offsets=offsets,
            current_distance=distance,
            prev_angles=state.current_angles,
            prev_distance=state.current_distance,
            observations=observation_pair(view, health, state.past_actions),
        )

    # ----- API --------------------------------------------------------------
    def reset(self, num_arenas: int, generator: torch.Generator | None = None) -> tuple[DogfightState, Tensor]:
        """``num_arenas`` fresh arenas; returns the state and the ``(N, 2,
        obs_size)`` observation. The generator draws the spawns, so it is
        needed with or without motor noise."""
        if generator is None:
            raise ValueError("the dogfight's reset needs a torch.Generator (the spawns are random)")
        pos, orn = self._sample_spawn(num_arenas, generator)
        _, forward = compute_rotation_forward(orn)
        drones = fixedwing.init_state(self.params, self.cfg, pos, orn, mode=0, start_vel=forward * 10.0)
        if not self.assisted_flight:  # 6-dim setpoint through the mode-0 assist map
            drones = dataclasses.replace(drones, setpoint=pos.new_zeros((num_arenas, 2, self.action_size)))
        for _ in range(10):
            drones, _ = fixedwing.step(drones, self.params, self.cfg, 0, self._generator(generator))
        dtype, dev = self.cfg.dtype, self.device
        z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)  # noqa: E731
        state = DogfightState(
            drones=drones,
            generator=generator,
            step_count=torch.zeros(num_arenas, dtype=torch.int32, device=dev),
            alive=torch.ones(num_arenas, 2, dtype=torch.bool, device=dev),
            current_actions=z(num_arenas, 2, self.action_size),
            past_actions=z(num_arenas, 2, self.action_size),
            health=torch.ones(num_arenas, 2, dtype=dtype, device=dev),
            current_hits=torch.zeros(num_arenas, 2, dtype=torch.bool, device=dev),
            current_angles=z(num_arenas, 2),
            current_offsets=z(num_arenas, 2),
            current_distance=z(num_arenas),
            prev_angles=z(num_arenas, 2),
            prev_distance=z(num_arenas),
            observations=z(num_arenas, 2, self.obs_size),
        )
        state = self._agent_states(state)
        return state, state.observations

    def scene_boxes(self, state: DogfightState) -> cam.Boxes:
        """Gunsight markers for third-person renders: a thin box 0.65 m
        ahead of each nose along its rotation, red (alpha 0.2) while that
        agent scores a hit and black otherwise, hidden once it is out;
        ``(N, 2, ...)``."""
        view = state.drones.read.view  # (N, 2, 4, 3)
        R, forward = compute_rotation_forward(view[:, :, 1])
        rgba = lambda c: view.new_tensor(c)  # noqa: E731
        return cam.Boxes(
            centers=view[:, :, 3] + forward * 0.65,
            half_extents=view.new_tensor([0.4, 0.02, 0.02]).expand(2, 3),
            rotations=R,
            colors=torch.where(state.current_hits[..., None], rgba([1.0, 0.0, 0.0, 0.2]), rgba([0.0, 0.0, 0.0, 0.2])),
            visible=state.alive,
        )

    def step(self, state: DogfightState, actions: Tensor) -> tuple[DogfightState, MAStepOut]:
        """``actions``: (N, 2, action_size); rows of step-start-dead agents
        are zeroed."""
        actions = actions.to(self.cfg.dtype)
        agents_mask = state.alive
        actions = torch.where(agents_mask[..., None], actions, 0.0)
        state = dataclasses.replace(
            state,
            past_actions=state.current_actions,
            current_actions=actions,
            drones=dataclasses.replace(state.drones, setpoint=actions),
        )
        # "terminal if the other agent is dead" counts the step-start agents
        other_dead = (agents_mask.sum(dim=1) < 2)[:, None]
        time_up = (state.step_count > self.max_steps)[:, None]
        gen = self._generator(state.generator)
        dtype = self.cfg.dtype
        term = torch.zeros_like(agents_mask)
        trunc = torch.zeros_like(agents_mask)
        any_coll, any_oob = torch.zeros_like(term), torch.zeros_like(term)
        reward = torch.zeros(agents_mask.shape, dtype=dtype, device=agents_mask.device)
        for _ in range(self.env_step_ratio):
            drones, contact = fixedwing.step(state.drones, self.params, self.cfg, 0, gen)
            state = dataclasses.replace(state, drones=drones)
            # engagement rewards FIRST, from the previous aviary step's memos
            rew = torch.zeros_like(reward)
            if not self.sparse_reward:
                in_range = (state.current_distance < self.lethal_distance)[:, None].to(dtype)
                chasing = (torch.abs(state.current_angles) < math.pi / 2.0).to(dtype)
                closing = torch.clamp(state.prev_distance - state.current_distance, min=0.0)[:, None]
                rew = rew + closing * ((1.0 - in_range) * chasing) * 1.0
                rew = rew + (state.prev_angles - state.current_angles) * in_range * 10.0
                rew = rew + 3.0 / (state.current_angles + 0.1) * in_range
            hits = state.current_hits.to(dtype)
            rew = rew + 30.0 * hits - 20.0 * hits.flip(1)

            state = self._agent_states(state)

            pos = drones.body.pos
            mutual = (torch.linalg.vector_norm(pos[:, 0] - pos[:, 1], dim=-1) < 2.0 * self.collision_radius)[:, None]
            collision = contact | mutual
            oob = torch.linalg.vector_norm(drones.read.view[..., 3, :], dim=-1) > self.flight_dome_size
            rew = rew - 3000.0 * oob.to(dtype) - 3000.0 * collision.to(dtype)
            term = term | collision | oob | other_dead
            trunc = trunc | time_up
            reward = reward + rew
            any_coll, any_oob = any_coll | collision, any_oob | oob
        state = dataclasses.replace(state, step_count=state.step_count + 1, alive=state.alive & ~(term | trunc))
        n = agents_mask.shape[0]
        out = MAStepOut(
            obs=state.observations,
            reward=reward,
            termination=term,
            truncation=trunc,
            agents_mask=agents_mask,
            info={
                "collision": any_coll,
                "out_of_bounds": any_oob,
                # every agent's info carries the full arrays, as the reference does
                "wins": (state.health <= 0.0)[:, None, :].expand(n, 2, 2),
                "healths": state.health[:, None, :].expand(n, 2, 2),
            },
        )
        return state, out
