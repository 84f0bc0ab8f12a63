"""Multi-agent QuadX Hover, batched over arenas (port of
``pyflyt_tpu/envs/ma_quadx_hover.py``).

``N`` arenas of ``n`` drones each: every state tensor is ``(N, n, ...)``,
where the JAX package ``vmap``s a single arena. A fixed agent axis and an
``alive`` mask stand in for the reference's mutable agent list.

Semantics as in the JAX module:
- per inner aviary step, every (step-start-alive) agent accumulates reward
  and termination: −100 per inner step on collision or out-of-dome, plus
  the dense shaping ``1 − ‖pos − start‖ − 0.1·‖(roll, pitch)‖``, with no
  early exit within the agent step;
- the observation carries the *previous* step's actions (the reference's
  ``past_actions`` double buffer);
- drone-drone collisions are a sphere-sphere proximity test at
  ``collision_radius``.

Motor noise is drawn from the batch's ``torch.Generator``, as the JAX env
always draws it; a batch reset without one (a parity run) flies quiet
motors. Flight modes are those of the port's ``models/quadx``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.device import resolve_device
from pyflyt_tpu_torch.models import quadx

CONTROL_HZ = 120


@dataclasses.dataclass
class MAQuadXState:
    drones: quadx.QuadXState  # batched (N, n)
    generator: torch.Generator | None  # motor-noise stream of the batch (None: quiet motors)
    step_count: Tensor  # (N,) int32
    alive: Tensor  # (N, n) bool: agents still in the arena
    current_actions: Tensor  # (N, n, 4)
    past_actions: Tensor  # (N, n, 4)


@dataclasses.dataclass
class MAStepOut:
    """Fixed-shape multi-agent transition, batched over arenas."""

    obs: Tensor  # (N, n, obs_dim)
    reward: Tensor  # (N, n)
    termination: Tensor  # (N, n)
    truncation: Tensor  # (N, n)
    agents_mask: Tensor  # (N, n) agents alive at step START (have valid outputs)
    info: dict[str, Tensor]


_DEFAULT_START = (
    (-1.0, -1.0, 1.0), (1.0, -1.0, 1.0), (-1.0, 1.0, 1.0), (1.0, 1.0, 1.0),
)


@dataclasses.dataclass(frozen=True)
class MAQuadXHoverEnv:
    start_pos: tuple = _DEFAULT_START
    start_orn: tuple = ((0.0, 0.0, 0.0),) * 4
    flight_mode: int = 0
    flight_dome_size: float = 10.0
    max_duration_seconds: float = 10.0
    angle_representation: str = "euler"  # the MA default (ma_quadx_base_env.py:28)
    agent_hz: int = 40
    sparse_reward: bool = False
    collision_radius: float = 0.065
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if CONTROL_HZ % self.agent_hz != 0:
            raise ValueError(f"`agent_hz` must be a round denominator of {CONTROL_HZ}.")
        if self.angle_representation not in ("euler", "quaternion"):
            raise ValueError(f"unknown angle_representation {self.angle_representation!r}")
        object.__setattr__(self, "device", resolve_device(self.device))
        quadx.check_mode(self.flight_mode)

    # ----- static -----------------------------------------------------------
    @property
    def num_agents(self) -> int:
        return len(self.start_pos)

    @property
    def possible_agents(self) -> list[str]:
        return [f"uav_{i}" for i in range(self.num_agents)]

    @property
    def env_step_ratio(self) -> int:
        return CONTROL_HZ // self.agent_hz

    @property
    def max_steps(self) -> int:
        return int(self.agent_hz * self.max_duration_seconds)

    @functools.cached_property
    def cfg(self) -> quadx.QuadXConfig:
        return quadx.QuadXConfig(control_hz=CONTROL_HZ)

    @functools.cached_property
    def params(self) -> quadx.QuadXParams:
        return quadx.build_params(self.cfg, self.device)

    @property
    def attitude_size(self) -> int:
        return 13 if self.angle_representation == "quaternion" else 12

    @property
    def obs_size(self) -> int:
        # attitude + aux (4) + past action (4) + own start pos (3)
        return self.attitude_size + 4 + 4 + 3

    @property
    def action_size(self) -> int:
        return 4

    def action_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        high = np.array([np.pi, np.pi, np.pi, 0.8])
        low = np.array([-np.pi, -np.pi, -np.pi, 0.0])
        return low, high

    # ----- helpers ----------------------------------------------------------
    def _start_pos(self) -> Tensor:
        return torch.tensor(self.start_pos, dtype=self.cfg.dtype, device=self.device)

    def _collisions(self, drones: quadx.QuadXState, model_contact: Tensor) -> Tensor:
        """Ground contact (model) | pairwise drone proximity."""
        pos = drones.body.pos  # (N, n, 3) ENU
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        d2 = torch.sum(diff * diff, dim=-1)
        n = pos.shape[1]
        d2 = d2 + torch.eye(n, dtype=d2.dtype, device=d2.device) * 1e6
        mutual = torch.any(d2 < (2.0 * self.collision_radius) ** 2, dim=-1)
        return model_contact | mutual

    def _obs(self, state: MAQuadXState) -> Tensor:
        view = state.drones.read.view  # (N, n, 4, 3)
        att = view[..., 1, :]
        if self.angle_representation == "quaternion":
            att = pm.euler_to_quat(att)
        return torch.cat([
            view[..., 0, :], att, view[..., 2, :], view[..., 3, :],
            state.drones.throttle,  # aux
            state.past_actions,
            self._start_pos().expand(view.shape[0], -1, -1),
        ], dim=-1)

    # ----- API --------------------------------------------------------------
    def reset(self, num_arenas: int, generator: torch.Generator | None) -> tuple[MAQuadXState, Tensor]:
        """``num_arenas`` fresh arenas plus 10 stabilization aviary steps,
        motor noise from ``generator`` (None: quiet motors); returns the
        state and the ``(N, n, obs_size)`` observation."""
        dtype, dev, n = self.cfg.dtype, self.device, self.num_agents
        pos = self._start_pos().expand(num_arenas, -1, -1)
        orn = torch.tensor(self.start_orn, dtype=dtype, device=dev).expand(num_arenas, -1, -1)
        drones = quadx.init_state(self.params, self.cfg, pos, orn)
        drones = quadx.set_mode(drones, self.flight_mode, self.cfg)
        for _ in range(10):
            drones, _ = quadx.step(drones, self.params, self.cfg, self.flight_mode, generator)
        state = MAQuadXState(
            drones=drones,
            generator=generator,
            step_count=torch.zeros(num_arenas, dtype=torch.int32, device=dev),
            alive=torch.ones(num_arenas, n, dtype=torch.bool, device=dev),
            current_actions=torch.zeros(num_arenas, n, 4, dtype=dtype, device=dev),
            past_actions=torch.zeros(num_arenas, n, 4, dtype=dtype, device=dev),
        )
        return state, self._obs(state)

    def step(self, state: MAQuadXState, actions: Tensor) -> tuple[MAQuadXState, MAStepOut]:
        """``actions``: (N, n, 4); rows of step-start-dead agents are ignored
        (zeroed, as the reference does for missing dict keys)."""
        actions = actions.to(self.cfg.dtype)
        agents_mask = state.alive
        actions = torch.where(agents_mask[..., None], actions, 0.0)
        state = dataclasses.replace(
            state,
            past_actions=state.current_actions,
            current_actions=actions,
            drones=dataclasses.replace(state.drones, setpoint=actions),
        )
        start = self._start_pos()
        term = torch.zeros_like(agents_mask)
        trunc = torch.zeros_like(agents_mask)
        reward = torch.zeros(agents_mask.shape, dtype=self.cfg.dtype, device=agents_mask.device)
        any_coll, any_oob = torch.zeros_like(term), torch.zeros_like(term)
        time_up = (state.step_count > self.max_steps)[:, None]
        for _ in range(self.env_step_ratio):
            drones, contact = quadx.step(state.drones, self.params, self.cfg, self.flight_mode, state.generator)
            state = dataclasses.replace(state, drones=drones)
            collision = self._collisions(drones, contact)
            view = drones.read.view
            lin_pos = view[..., 3, :]
            oob = torch.linalg.vector_norm(lin_pos, dim=-1) > self.flight_dome_size
            rew = -100.0 * collision.to(reward.dtype) - 100.0 * oob.to(reward.dtype)
            if not self.sparse_reward:
                lin_dist = torch.linalg.vector_norm(lin_pos - start, dim=-1)
                ang_dist = torch.linalg.vector_norm(view[..., 1, :2], dim=-1)
                rew = rew - (lin_dist + 0.1 * ang_dist) + 1.0
            term = term | collision | oob
            trunc = trunc | time_up
            reward = reward + rew
            any_coll, any_oob = any_coll | collision, any_oob | oob
        state = dataclasses.replace(
            state, step_count=state.step_count + 1, alive=state.alive & ~(term | trunc),
        )
        out = MAStepOut(
            obs=self._obs(state),
            reward=reward,
            termination=term,
            truncation=trunc,
            agents_mask=agents_mask,
            info={"collision": any_coll, "out_of_bounds": any_oob},
        )
        return state, out
