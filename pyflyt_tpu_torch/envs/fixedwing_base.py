"""Shared machinery for the Fixedwing tasks (port of
``pyflyt_tpu/envs/fixedwing_base.py``), batched by construction.

Stepping semantics as in the JAX module: 120 Hz control, ``env_step_ratio``
inner aviary steps per agent step, the reward re-armed to −0.1 each agent
step and overwritten to −100 by a collision or leaving the dome, the
done-freeze for the rest of the agent step, 10 stabilization steps on
reset. Action ``[roll, pitch-pair, (unused), thrust]`` in ``[−1, 1]³ ×
[0, 1]``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.device import resolve_device
from pyflyt_tpu_torch.envs.base import AviaryTaskEnv
from pyflyt_tpu_torch.models import fixedwing

CONTROL_HZ = 120


@dataclasses.dataclass
class FixedwingEnvState:
    drone: fixedwing.FixedwingState
    step_count: Tensor  # (N,) int32
    termination: Tensor  # (N,) bool
    truncation: Tensor  # (N,) bool
    reward: Tensor  # (N,) running reward of the current agent step
    action: Tensor  # (N, 4)
    collision: Tensor  # (N,) bool
    out_of_bounds: Tensor  # (N,) bool
    env_complete: Tensor  # (N,) bool
    generator: torch.Generator | None  # motor-noise stream of the batch


@dataclasses.dataclass(frozen=True)
class FixedwingBaseEnv(AviaryTaskEnv):
    start_pos: tuple = ((0.0, 0.0, 1.0),)
    start_orn: tuple = ((0.0, 0.0, 0.0),)
    flight_mode: int = 0
    flight_dome_size: float = float("inf")
    max_duration_seconds: float = 10.0
    angle_representation: str = "quaternion"
    agent_hz: int = 30
    drone_model: str = "fixedwing"
    noisy_motors: bool = True
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if CONTROL_HZ % self.agent_hz != 0:
            raise ValueError(f"`agent_hz` must be a round denominator of {CONTROL_HZ}.")
        if self.angle_representation not in ("euler", "quaternion"):
            raise ValueError(f"unknown angle_representation {self.angle_representation!r}")
        object.__setattr__(self, "device", resolve_device(self.device))
        fixedwing._check_mode(self.flight_mode)

    @property
    def env_step_ratio(self) -> int:
        return CONTROL_HZ // self.agent_hz

    @property
    def max_steps(self) -> int:
        return int(self.agent_hz * self.max_duration_seconds)

    @functools.cached_property
    def cfg(self) -> fixedwing.FixedwingConfig:
        return fixedwing.FixedwingConfig(
            drone_model=self.drone_model, control_hz=CONTROL_HZ, noisy_motors=self.noisy_motors
        )

    @functools.cached_property
    def params(self) -> fixedwing.FixedwingParams:
        return fixedwing.build_params(self.cfg, self.device)

    def aviary_step(
        self, drone: fixedwing.FixedwingState, generator: torch.Generator | None
    ) -> tuple[fixedwing.FixedwingState, Tensor]:
        """One aviary step of ``models/fixedwing``."""
        return fixedwing.step(drone, self.params, self.cfg, self.flight_mode, generator)

    @property
    def attitude_size(self) -> int:
        return 13 if self.angle_representation == "quaternion" else 12

    @property
    def combined_size(self) -> int:
        # attitude + previous action (4) + auxiliary (5 surfaces + 1 motor)
        return self.attitude_size + 4 + 6

    @property
    def action_size(self) -> int:
        return 4

    def action_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """±1 control surfaces, [0, 1] thrust."""
        return np.array([-1.0, -1.0, -1.0, 0.0]), np.array([1.0, 1.0, 1.0, 1.0])

    # ----- shared pieces ---------------------------------------------------
    def attitude_obs(self, state: FixedwingEnvState) -> Tensor:
        """[ang_vel, (quat|euler), lin_vel, lin_pos, action, aux]."""
        view = state.drone.read.view
        att = view[..., 1, :]
        if self.angle_representation == "quaternion":
            att = pm.euler_to_quat(att)
        parts = [view[..., 0, :], att, view[..., 2, :], view[..., 3, :], state.action,
                 fixedwing.aux_state(state.drone)]
        return torch.cat(parts, dim=-1)

    def init_env_state(self, num_envs: int, generator: torch.Generator | None) -> FixedwingEnvState:
        """Fresh aircraft plus 10 stabilization aviary steps."""
        if self.noisy_motors and generator is None:
            raise ValueError("noisy_motors needs a torch.Generator for reset")
        dtype, dev = self.cfg.dtype, self.device
        pos = torch.tensor(self.start_pos[0], dtype=dtype, device=dev).expand(num_envs, 3)
        orn = torch.tensor(self.start_orn[0], dtype=dtype, device=dev).expand(num_envs, 3)
        drone = fixedwing.init_state(self.params, self.cfg, pos, orn, self.flight_mode)
        for _ in range(10):
            drone, _ = fixedwing.step(drone, self.params, self.cfg, self.flight_mode, generator)
        false = torch.zeros(num_envs, dtype=torch.bool, device=dev)
        return FixedwingEnvState(
            drone=drone,
            step_count=torch.zeros(num_envs, dtype=torch.int32, device=dev),
            termination=false,
            truncation=false.clone(),
            reward=torch.zeros(num_envs, dtype=dtype, device=dev),
            action=torch.zeros(num_envs, 4, dtype=dtype, device=dev),
            collision=false.clone(),
            out_of_bounds=false.clone(),
            env_complete=false.clone(),
            generator=generator,
        )
