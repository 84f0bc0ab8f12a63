"""Fixedwing Waypoints task (port of
``pyflyt_tpu/envs/fixedwing_waypoints.py``), batched: spawn at z = 10 m
with 20 m/s forward speed and fly through 4 random waypoints in a 100 m
dome over 120 s episodes. Reward per inner aviary step
``+max(3·progress, 0) + 1/dist``, overwritten with 100 on a target reach;
the episode truncates once every target is reached.

The observation is a dict: ``attitude`` (the base env's 23 values) and
``target_deltas`` ``(N, num_targets, 3)``, the remaining targets'
body-frame deltas rolled so the current target is row 0, exhausted rows
zero. PPO flattens it in sorted-key order (``rl/ppo._flat_obs``):
``flat_obs_size`` values, 35 for the stock four targets.

Reset draws the targets from the batch's generator after the 10
stabilization steps, where the JAX env folds a key, so reset states
differ from the JAX package's by design; tests carry JAX reset states in
(``convert.fixedwing_waypoints_state_from_jax``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.envs.base import StepOut, tree_select
from pyflyt_tpu_torch.envs.fixedwing_base import FixedwingBaseEnv, FixedwingEnvState
from pyflyt_tpu_torch.envs.utils.waypoints import WaypointHandler, WaypointState


@dataclasses.dataclass
class FixedwingWaypointsState(FixedwingEnvState):
    wp: WaypointState
    target_deltas: Tensor  # (N, num_targets, 3) the pre-advance remaining-target view


@dataclasses.dataclass(frozen=True)
class FixedwingWaypointsEnv(FixedwingBaseEnv):
    sparse_reward: bool = False
    num_targets: int = 4
    goal_reach_distance: float = 2.0
    flight_dome_size: float = 100.0
    max_duration_seconds: float = 120.0
    agent_hz: int = 30
    start_pos: tuple = ((0.0, 0.0, 10.0),)

    @property
    def waypoints(self) -> WaypointHandler:
        return WaypointHandler(
            num_targets=self.num_targets,
            use_yaw_targets=False,
            goal_reach_distance=self.goal_reach_distance,
            goal_reach_angle=float("inf"),
            flight_dome_size=self.flight_dome_size,
        )

    def scene_boxes(self, state: FixedwingWaypointsState):
        return self.waypoints.marker_boxes(state.wp)

    @property
    def obs_size(self) -> int:  # the attitude part only, as in the JAX env
        return self.combined_size

    @property
    def flat_obs_size(self) -> int:
        """Width of the flattened dict observation (``rl/ppo._flat_obs``)."""
        return self.combined_size + 3 * self.num_targets

    def _obs(self, state: FixedwingWaypointsState) -> dict:
        return {"attitude": self.attitude_obs(state), "target_deltas": state.target_deltas}

    def reset(
        self, num_envs: int, generator: torch.Generator | None = None
    ) -> tuple[FixedwingWaypointsState, dict]:
        base = self.init_env_state(num_envs, generator)
        wph = self.waypoints
        ws = wph.reset(num_envs, generator, dtype=self.cfg.dtype, device=self.device)
        view = base.drone.read.view
        ws, deltas = wph.update_distances(ws, view[:, 1], view[:, 3], pm.euler_to_quat(view[:, 1]))
        state = FixedwingWaypointsState(
            **{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
            wp=ws,
            target_deltas=wph.remaining_deltas(ws, deltas),
        )
        return state, self._obs(state)

    def _task_update(self, state: FixedwingWaypointsState, contact: Tensor) -> FixedwingWaypointsState:
        wph = self.waypoints
        view = state.drone.read.view
        ang_pos, lin_pos = view[:, 1], view[:, 3]
        ws, deltas = wph.update_distances(state.wp, ang_pos, lin_pos, pm.euler_to_quat(ang_pos))
        state = dataclasses.replace(state, wp=ws, target_deltas=wph.remaining_deltas(ws, deltas))

        state = self.base_term_trunc_reward(state, contact)
        reward = state.reward
        if not self.sparse_reward:
            reward = reward + torch.clamp(3.0 * wph.progress_to_target(ws), min=0.0)
            reward = reward + 1.0 / wph.immediate_distance(ws, deltas)

        reached = wph.target_reached(ws)
        reward = torch.where(reached, 100.0, reward)
        ws = tree_select(reached, wph.advance_targets(ws), ws)
        all_reached = wph.all_targets_reached(ws)
        return dataclasses.replace(
            state,
            wp=ws,
            reward=reward,
            truncation=state.truncation | all_reached,
            env_complete=state.env_complete | all_reached,
        )

    def step(
        self, state: FixedwingWaypointsState, action: Tensor
    ) -> tuple[FixedwingWaypointsState, StepOut]:
        return self.base_step(
            state, action, self._task_update, self._obs,
            extra_info=lambda s: {"num_targets_reached": s.wp.idx},
        )
