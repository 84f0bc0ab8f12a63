"""Shared machinery for the QuadX tasks (port of
``pyflyt_tpu/envs/quadx_base.py``), batched by construction.

Stepping semantics as in the JAX module:
- the agent acts every ``env_step_ratio = 120 / agent_hz`` aviary steps;
- the reward is re-armed to −0.1 each agent step and shaped per inner
  aviary step, with a fatal event overwriting it to −100;
- once terminated or truncated, an env's state is frozen for the rest of
  the agent step;
- reset runs 10 stabilization aviary steps.

``use_kernel=True`` mirrors the JAX envs' ``use_pallas``: each inner
aviary step goes through the generic QuadX kernel (``ops/cuda_quadx.step``,
pack → one launch → unpack) instead of ``models/quadx.step``, in modes 0,
7 (ENU), 8 and 9. Its ground contact is detection-grade, which only shows
after a contact, where the tasks terminate.
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
from pyflyt_tpu_torch.models import quadx
from pyflyt_tpu_torch.ops import cuda_quadx

CONTROL_HZ = 120


@dataclasses.dataclass
class QuadXEnvState:
    drone: quadx.QuadXState
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
class QuadXBaseEnv(AviaryTaskEnv):
    start_pos: tuple = ((0.0, 0.0, 1.0),)
    start_orn: tuple = ((0.0, 0.0, 0.0),)
    flight_mode: int = 0
    flight_dome_size: float = float("inf")
    max_duration_seconds: float = 10.0
    angle_representation: str = "quaternion"
    agent_hz: int = 30
    noisy_motors: bool = True
    orn_conv: str = "ENU_FLU"
    drone_model: str = "cf2x"
    device: str | torch.device = "cuda"
    use_kernel: bool = False  # the counterpart of the JAX envs' use_pallas

    def __post_init__(self):
        if CONTROL_HZ % self.agent_hz != 0:
            raise ValueError(f"`agent_hz` must be a round denominator of {CONTROL_HZ}.")
        if self.angle_representation not in ("euler", "quaternion"):
            raise ValueError(f"unknown angle_representation {self.angle_representation!r}")
        object.__setattr__(self, "device", resolve_device(self.device))
        quadx.check_mode(self.flight_mode)

    # ----- static derived quantities -------------------------------------
    @property
    def env_step_ratio(self) -> int:
        return CONTROL_HZ // self.agent_hz

    @property
    def max_steps(self) -> int:
        return int(self.agent_hz * self.max_duration_seconds)

    @functools.cached_property
    def cfg(self) -> quadx.QuadXConfig:
        return quadx.QuadXConfig(
            drone_model=self.drone_model,
            control_hz=CONTROL_HZ,
            orn_conv=self.orn_conv,
            noisy_motors=self.noisy_motors,
        )

    @functools.cached_property
    def params(self) -> quadx.QuadXParams:
        return quadx.build_params(self.cfg, self.device)

    @functools.cached_property
    def kernel_consts(self) -> cuda_quadx.GenericConsts:
        """The generic kernel's constants, read once (``use_kernel``)."""
        return cuda_quadx.generic_consts(self.params, self.cfg)

    def aviary_step(
        self, drone: quadx.QuadXState, generator: torch.Generator | None
    ) -> tuple[quadx.QuadXState, Tensor]:
        """One aviary step: ``models/quadx.step``, or the generic kernel
        under ``use_kernel``."""
        if self.use_kernel:
            return cuda_quadx.step(
                drone, self.params, self.cfg, self.flight_mode, generator, consts=self.kernel_consts
            )
        return quadx.step(drone, self.params, self.cfg, self.flight_mode, generator)

    @property
    def attitude_size(self) -> int:
        return 13 if self.angle_representation == "quaternion" else 12

    @property
    def combined_size(self) -> int:
        return self.attitude_size + 4 + 4

    @property
    def action_size(self) -> int:
        return 4

    def action_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """[±π rate, ±π, ±π, 0..0.8 thrust]."""
        high = np.array([np.pi, np.pi, np.pi, 0.8])
        low = np.array([-np.pi, -np.pi, -np.pi, 0.0])
        return low, high

    # ----- shared pieces ---------------------------------------------------
    def attitude_obs(self, state: QuadXEnvState) -> Tensor:
        """[ang_vel, (quat|euler), lin_vel, lin_pos, action, aux]."""
        view = state.drone.read.view
        att = view[..., 1, :]
        if self.angle_representation == "quaternion":
            att = pm.euler_to_quat(att)
        parts = [view[..., 0, :], att, view[..., 2, :], view[..., 3, :],
                 state.action, state.drone.throttle]
        return torch.cat(parts, dim=-1)

    def init_env_state(
        self, num_envs: int, generator: torch.Generator | None
    ) -> QuadXEnvState:
        """Fresh drones plus 10 stabilization aviary steps."""
        if self.noisy_motors and generator is None:
            raise ValueError("noisy_motors needs a torch.Generator for reset")
        dtype, dev = self.cfg.dtype, self.device
        pos = torch.tensor(self.start_pos[0], dtype=dtype, device=dev).expand(num_envs, 3)
        orn = torch.tensor(self.start_orn[0], dtype=dtype, device=dev).expand(num_envs, 3)
        drone = quadx.init_state(self.params, self.cfg, pos, orn)
        drone = quadx.set_mode(drone, self.flight_mode, self.cfg)
        for _ in range(10):
            drone, _ = quadx.step(drone, self.params, self.cfg, self.flight_mode, generator)
        false = torch.zeros(num_envs, dtype=torch.bool, device=dev)
        return QuadXEnvState(
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
