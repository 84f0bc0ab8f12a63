"""The fork's slow (hover-at-waypoint) trajectory-following env (port of
``pyflyt_tpu/envs/quadx_mod/trajectory_following_slow.py``), batched by
construction: reach each waypoint in position (< 0.3 m), yaw (< 5°) and
near-zero speed (‖v‖ < 1) before the next one appears.

Semantics kept from the JAX env:

- the observation (16) is the hovering env's: [lin_pos, lin_vel, ang_pos,
  ang_vel, lin_pos_error, yaw_error], rounded to 3 decimals;
- random mode regenerates one waypoint (an offset from the current target
  by the fast env's rule, ``next_waypoint``) and a fresh yaw on each
  reach; fixed mode walks the ``(n, 4)`` [x, y, z, ψ] list and clamps at
  its end;
- reward ``40·targets_reached + 35 − α·‖pos_err‖ − β·|ψ_err| − γ·‖ω‖``
  (α=2, β=4, γ=0.2), −1000 on a collision;
- the fast env's loop, spaces' scheme, normalization, wind, truncation
  and done-freeze (the JAX class subclasses the fast env, as this one
  does).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.core.wind import GaussianWind
from pyflyt_tpu_torch.envs.base import StepOut, tree_select
from pyflyt_tpu_torch.envs.quadx_mod.trajectory_following_fast import (
    OFFSET,
    QuadXTrajectoryFollowingFastEnv,
    next_waypoint,
)
from pyflyt_tpu_torch.models import quadx


@dataclasses.dataclass
class TrajSlowState:
    drone: quadx.QuadXState
    wind: GaussianWind
    generator: torch.Generator | None
    step_count: Tensor  # (N,) int32
    termination: Tensor  # (N,) bool
    truncation: Tensor  # (N,) bool
    reward: Tensor  # (N,)
    action: Tensor  # (N, 4)
    current_target_index: Tensor  # (N,) int32
    target_pos: Tensor  # (N, 3)
    target_psi: Tensor  # (N,)
    fixed_waypoints: Tensor  # (N, n, 4) in fixed mode (zeros (N, 1, 4) in random mode)
    state16: Tensor  # (N, 16)
    collision: Tensor  # (N,) bool
    env_complete: Tensor  # (N,) bool


@dataclasses.dataclass(frozen=True)
class QuadXTrajectoryFollowingSlowEnv(QuadXTrajectoryFollowingFastEnv):
    """The fast env's configuration with the slow task's reach and reward."""

    goal_reach_distance: float = 0.3
    goal_reach_angle: float = float(np.deg2rad(5))
    alpha: float = 2.0
    beta: float = 4.0
    gamma: float = 0.2

    @functools.cached_property
    def obs_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        d = self.flight_dome_size + 25
        z_lo, z_hi = (0.0, d) if self.orn_conv == "ENU_FLU" else (-d, 0.0)
        low = np.array([-d, -d, z_lo, -50, -50, -50, -np.pi, -np.pi, -np.pi,
                        -130, -130, -130, -20, -20, -20, -np.pi])
        high = np.array([d, d, z_hi, 50, 50, 50, np.pi, np.pi, np.pi,
                         130, 130, 130, 20, 20, 20, np.pi])
        return low, high

    @property
    def obs_size(self) -> int:
        return 16

    @property
    def fixed_num_targets(self) -> int:
        return len(self.waypoints)

    def compute_state16(self, view: Tensor, target_pos: Tensor, target_psi: Tensor) -> Tensor:
        """The rounded 16-dim state from the read's ``(N, 4, 3)`` view."""
        ang_pos = pm.wrap_angle(view[:, 1])
        yaw_err = pm.wrap_angle(target_psi - ang_pos[:, 2])
        return self.round3(torch.cat([view[:, 3], view[:, 2], ang_pos, view[:, 0], target_pos - view[:, 3],
                                      yaw_err[:, None]], dim=-1))

    # ----- API ----------------------------------------------------------------
    def reset(self, num_envs: int, generator: torch.Generator | None = None) -> tuple[TrajSlowState, Tensor]:
        """A fresh batch; ``generator`` draws the spawns, the first targets
        and the wind bases, and stays the batch's stream."""
        if generator is None and (self.randomize_start or self.random_trajectory or self.noisy_motors
                                  or self.simulate_wind):
            raise ValueError(f"{type(self).__name__}.reset needs a torch.Generator")
        n, dtype, dev = num_envs, self.cfg.dtype, self.device
        start_pos, start_orn = self.draw_start(n, generator)
        if self.random_trajectory:
            target_pos = next_waypoint(start_pos, self.uniform((n, 3), -OFFSET, OFFSET, generator),
                                       self.flight_dome_size)
            target_psi = self.uniform((n,), -math.pi, math.pi, generator)
            fixed = torch.zeros(n, 1, 4, dtype=dtype, device=dev)
        else:
            fixed = torch.tensor(self.waypoints, dtype=dtype, device=dev).expand(n, -1, 4).clone()
            target_pos, target_psi = fixed[:, 0, :3].clone(), fixed[:, 0, 3].clone()
        wind = self.make_wind(n, generator)
        drone = self.new_drone(start_pos, start_orn)
        false = torch.zeros(n, dtype=torch.bool, device=dev)
        state = TrajSlowState(
            drone=drone, wind=wind, generator=generator,
            step_count=torch.zeros(n, dtype=torch.int32, device=dev), termination=false, truncation=false.clone(),
            reward=torch.zeros(n, dtype=dtype, device=dev), action=torch.zeros(n, 4, dtype=dtype, device=dev),
            current_target_index=torch.zeros(n, dtype=torch.int32, device=dev), target_pos=target_pos,
            target_psi=target_psi, fixed_waypoints=fixed,
            state16=self.compute_state16(drone.read.view, target_pos, target_psi),
            collision=false.clone(), env_complete=false.clone(),
        )
        return state, self.normalize_state(state.state16)

    def step(self, state: TrajSlowState, action: Tensor) -> tuple[TrajSlowState, StepOut]:
        """One env step = one aviary step; a finished env keeps its state."""
        norm = torch.linalg.vector_norm
        dtype = self.cfg.dtype
        action = self.denormalize_action(action.to(dtype))
        done_before = state.termination | state.truncation
        drone = dataclasses.replace(state.drone, setpoint=action)
        drone, contact = quadx.step(drone, self.params, self.cfg, self.flight_mode, state.generator,
                                    wind_fn=state.wind)
        view = drone.read.view
        yaw_err = pm.wrap_angle(state.target_psi - pm.wrap_angle(view[:, 1])[:, 2])
        reached = ((norm(state.target_pos - view[:, 3], dim=-1) < self.goal_reach_distance)
                   & (torch.abs(yaw_err) < self.goal_reach_angle) & (norm(view[:, 2], dim=-1) < 1.0))
        if self.random_trajectory:
            idx = state.current_target_index + reached.to(torch.int32)
            n = reached.shape[0]
            new_pos = next_waypoint(state.target_pos, self.uniform((n, 3), -OFFSET, OFFSET, state.generator),
                                    self.flight_dome_size)
            new_psi = self.uniform((n,), -math.pi, math.pi, state.generator)
        else:
            idx = torch.clamp(state.current_target_index + reached.to(torch.int32), max=self.fixed_num_targets - 1)
            picked = state.fixed_waypoints[torch.arange(idx.shape[0], device=idx.device), idx.long()]
            new_pos, new_psi = picked[:, :3], picked[:, 3]
        target_pos = torch.where(reached[:, None], new_pos, state.target_pos)
        target_psi = torch.where(reached, new_psi, state.target_psi)
        state16 = self.compute_state16(view, target_pos, target_psi)
        truncation = state.step_count >= self.max_steps  # the count before this step's increment
        reward = 40.0 * idx.to(dtype) + (
            35.0 - self.alpha * norm(state16[:, 12:15], dim=-1) - self.beta * torch.abs(state16[:, 15])
            - self.gamma * norm(state16[:, 9:12], dim=-1))
        reward = torch.where(contact, -1000.0, reward).to(dtype)
        new_state = dataclasses.replace(
            state, drone=drone, step_count=state.step_count + 1, termination=state.termination | contact,
            truncation=state.truncation | truncation, reward=reward, action=action, current_target_index=idx,
            target_pos=target_pos, target_psi=target_psi, state16=state16, collision=state.collision | contact,
        )
        new_state = tree_select(done_before, state, new_state)  # the done-freeze
        return new_state, StepOut(
            obs=self.normalize_state(new_state.state16),
            reward=torch.where(done_before, 0.0, new_state.reward),
            termination=new_state.termination,
            truncation=new_state.truncation,
            info={
                "collision": new_state.collision,
                "out_of_bounds": torch.zeros_like(new_state.collision),
                "env_complete": new_state.env_complete,
                "num_targets_reached": new_state.current_target_index,
            },
        )
