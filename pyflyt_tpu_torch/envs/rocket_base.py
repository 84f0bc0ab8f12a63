"""Shared machinery for the Rocket tasks (port of
``pyflyt_tpu/envs/rocket_base.py``), batched by construction.

It differs from the QuadX and Fixedwing bases, as the JAX module does, and
so keeps its own agent-step loop:

- the reward is re-armed to 0.0 every agent step, not −0.1, and the base
  termination does not overwrite it;
- termination on a ground collision (the pad excluded), below ground
  (z < 0), an xy displacement beyond ``max_displacement`` or z above
  ``ceiling``;
- the task update after each aviary step takes ``(state, ground_contact,
  pad_contact)``;
- ``randomize_drop`` randomizes the spawn position and attitude and
  ``accelerate_drop`` starts the fall at −100 m/s. The reference's
  "randoimize_drop" typo means random spawn *velocities* never happen;
  that is reproduced by not drawing them.

Action (7): ``[finlet x, finlet y, finlet yaw ∈ ±1, ignition ∈ [0, 1],
throttle ∈ [0, 1], gimbal x, gimbal y ∈ ±1]``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.device import resolve_device
from pyflyt_tpu_torch.envs.base import StepOut, tree_select
from pyflyt_tpu_torch.models import rocket

CONTROL_HZ = 120


@dataclasses.dataclass
class RocketEnvState:
    drone: rocket.RocketState
    generator: torch.Generator | None  # booster-noise stream of the batch
    step_count: Tensor  # (N,) int32
    termination: Tensor  # (N,) bool
    truncation: Tensor  # (N,) bool
    reward: Tensor  # (N,) running reward of the current agent step
    action: Tensor  # (N, 7)
    fatal_collision: Tensor  # (N,) bool
    out_of_bounds: Tensor  # (N,) bool
    env_complete: Tensor  # (N,) bool


@dataclasses.dataclass(frozen=True)
class RocketBaseEnv:
    start_pos: tuple = ((0.0, 0.0, 450.0),)
    start_orn: tuple = ((0.0, 0.0, 0.0),)
    ceiling: float = 500.0
    max_displacement: float = 200.0
    max_duration_seconds: float = 30.0
    angle_representation: str = "quaternion"
    agent_hz: int = 40
    drone_model: str = "rocket"
    starting_fuel_ratio: float = 0.01
    randomize_drop: bool = True
    accelerate_drop: bool = True
    noisy_boosters: bool = True
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if CONTROL_HZ % self.agent_hz != 0:
            raise ValueError(f"`agent_hz` must be a round denominator of {CONTROL_HZ}.")
        if self.angle_representation not in ("euler", "quaternion"):
            raise ValueError(f"unknown angle_representation {self.angle_representation!r}")
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def env_step_ratio(self) -> int:
        return CONTROL_HZ // self.agent_hz

    @property
    def max_steps(self) -> int:
        return int(self.agent_hz * self.max_duration_seconds)

    @functools.cached_property
    def cfg(self) -> rocket.RocketConfig:
        return rocket.RocketConfig(
            drone_model=self.drone_model, control_hz=CONTROL_HZ, starting_fuel_ratio=self.starting_fuel_ratio,
            noisy_boosters=self.noisy_boosters,
        )

    @functools.cached_property
    def params(self) -> rocket.RocketParams:
        return rocket.build_params(self.cfg, self.device)

    @property
    def attitude_size(self) -> int:
        return 13 if self.angle_representation == "quaternion" else 12

    @property
    def combined_size(self) -> int:
        # attitude + previous action (7) + auxiliary (9)
        return self.attitude_size + 7 + 9

    @property
    def action_size(self) -> int:
        return 7

    def action_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """±1 finlets and gimbals, [0, 1] ignition and throttle."""
        return np.array([-1.0, -1.0, -1.0, 0.0, 0.0, -1.0, -1.0]), np.ones(7)

    # ----- shared pieces ---------------------------------------------------
    def attitude_obs(self, state: RocketEnvState) -> Tensor:
        """[ang_vel, (quat|euler), lin_vel, lin_pos, action, aux]."""
        view = state.drone.read.view
        att = view[..., 1, :]
        if self.angle_representation == "quaternion":
            att = pm.euler_to_quat(att)
        return torch.cat(
            [view[..., 0, :], att, view[..., 2, :], view[..., 3, :], state.action, rocket.aux_state(state.drone)],
            dim=-1,
        )

    def base_term_trunc(self, state: Any, fatal_contact: Tensor) -> Any:
        """Step-count truncation (on the count before this agent step's
        increment); termination on a fatal contact, below ground or out of
        bounds. The reward is not overwritten."""
        truncation = state.truncation | (state.step_count > self.max_steps)
        lin_pos = state.drone.read.view[..., 3, :]
        fatal = fatal_contact | (lin_pos[..., 2] < 0.0)
        oob = (torch.linalg.vector_norm(lin_pos[..., :2], dim=-1) > self.max_displacement) | (
            lin_pos[..., 2] > self.ceiling
        )
        return dataclasses.replace(
            state,
            truncation=truncation,
            termination=state.termination | fatal | oob,
            fatal_collision=state.fatal_collision | fatal,
            out_of_bounds=state.out_of_bounds | oob,
        )

    def sample_spawn(self, num_envs: int, generator: torch.Generator | None) -> tuple[Tensor, Tensor, Tensor]:
        """``(start_pos, start_orn, start_lin_vel)``, ``(N, 3)`` each, with
        the drop randomization drawn from ``generator``."""
        dtype, dev = self.cfg.dtype, self.device
        pos = torch.tensor(self.start_pos[0], dtype=dtype, device=dev).expand(num_envs, 3).clone()
        orn = torch.tensor(self.start_orn[0], dtype=dtype, device=dev).expand(num_envs, 3).clone()
        if self.randomize_drop:
            u = lambda *s: torch.rand(s, generator=generator, dtype=dtype, device=dev)  # noqa: E731
            spawn_range = self.max_displacement * 0.1
            pos[:, :2] = -spawn_range + 2.0 * spawn_range * u(num_envs, 2)
            pos[:, 2] = self.ceiling * 0.8 + (self.ceiling * 0.9 - self.ceiling * 0.8) * u(num_envs)
            orn = -0.3 + 0.6 * u(num_envs, 3)
        lin_vel = torch.zeros(num_envs, 3, dtype=dtype, device=dev)
        if self.accelerate_drop:
            lin_vel[:, 2] = -100.0
        return pos, orn, lin_vel

    def init_env_state(
        self, num_envs: int, generator: torch.Generator | None, pad_position: Tensor | None = None
    ) -> RocketEnvState:
        """A fresh drop plus 10 stabilization aviary steps."""
        if generator is None and (self.randomize_drop or self.noisy_boosters):
            raise ValueError("reset needs a torch.Generator (the drop randomization and the booster noise)")
        pos, orn, lin_vel = self.sample_spawn(num_envs, generator)
        drone = rocket.init_state(self.params, self.cfg, pos, orn, lin_vel)
        for _ in range(10):
            drone, _, _ = rocket.step(drone, self.params, self.cfg, generator, pad_position=pad_position)
        false = torch.zeros(num_envs, dtype=torch.bool, device=self.device)
        return RocketEnvState(
            drone=drone,
            generator=generator,
            step_count=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
            termination=false,
            truncation=false.clone(),
            reward=torch.zeros(num_envs, dtype=self.cfg.dtype, device=self.device),
            action=torch.zeros(num_envs, 7, dtype=self.cfg.dtype, device=self.device),
            fatal_collision=false.clone(),
            out_of_bounds=false.clone(),
            env_complete=false.clone(),
        )

    def base_step(
        self,
        state: Any,
        action: Tensor,
        task_update: Callable[[Any, Tensor, Tensor], Any],
        obs_fn: Callable[[Any], Tensor],
        pad_position: Tensor | None = None,
        extra_info: Callable[[Any], dict[str, Any]] | None = None,
    ) -> tuple[Any, StepOut]:
        """One agent step: the action becomes the setpoint, the reward is
        re-armed to 0.0, then ``env_step_ratio`` aviary steps each followed
        by ``task_update(state, ground_contact, pad_contact)``, with the
        done-freeze; the step count increments after the loop."""
        action = action.to(self.cfg.dtype)
        state = dataclasses.replace(
            state,
            action=action,
            reward=torch.zeros_like(state.reward),
            drone=dataclasses.replace(state.drone, setpoint=action),
        )
        for _ in range(self.env_step_ratio):
            done_before = state.termination | state.truncation
            drone, ground, pad = rocket.step(
                state.drone, self.params, self.cfg, state.generator, pad_position=pad_position
            )
            new_state = task_update(dataclasses.replace(state, drone=drone), ground, pad)
            state = tree_select(done_before, state, new_state)  # the done-freeze
        state = dataclasses.replace(state, step_count=state.step_count + 1)
        out = StepOut(
            obs=obs_fn(state),
            reward=state.reward,
            termination=state.termination,
            truncation=state.truncation,
            info={
                "fatal_collision": state.fatal_collision,
                "out_of_bounds": state.out_of_bounds,
                "env_complete": state.env_complete,
                **(extra_info(state) if extra_info is not None else {}),
            },
        )
        return state, out
