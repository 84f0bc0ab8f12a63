"""QuadX Waypoints task (port of ``pyflyt_tpu/envs/quadx_waypoints.py``),
batched: fly through a sequence of random waypoints. Reward per inner
aviary step ``+max(3·progress, 0) + 0.1/dist``, overwritten with 100 on a
target reach; the episode truncates once every target is reached.

The observation is a dict: ``attitude`` (the base env's 21 values) and
``target_deltas``, a fixed ``(N, num_targets, 3|4)`` array of the
remaining targets' body-frame deltas, rolled so the current target is row
0, with exhausted rows zero (``WaypointHandler.remaining_deltas``). PPO
flattens it in sorted-key order (``rl/ppo._flat_obs``): ``flat_obs_size``
values, 33 for the stock four targets.

Reset draws the targets from the batch's generator after the 10
stabilization steps, where the JAX env folds a key; so reset states differ
from the JAX package's by design, and tests carry JAX reset states in
(``convert.waypoints_state_from_jax``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.envs.base import StepOut, tree_select
from pyflyt_tpu_torch.envs.quadx_base import QuadXBaseEnv, QuadXEnvState
from pyflyt_tpu_torch.envs.utils.waypoints import WaypointHandler, WaypointState


@dataclasses.dataclass
class QuadXWaypointsState(QuadXEnvState):
    wp: WaypointState
    target_deltas: Tensor  # (N, num_targets, 3|4) the pre-advance remaining-target view


@dataclasses.dataclass(frozen=True)
class QuadXWaypointsEnv(QuadXBaseEnv):
    sparse_reward: bool = False
    num_targets: int = 4
    use_yaw_targets: bool = False
    goal_reach_distance: float = 0.2
    goal_reach_angle: float = 0.1
    flight_dome_size: float = 5.0
    agent_hz: int = 30

    @property
    def waypoints(self) -> WaypointHandler:
        return WaypointHandler(
            num_targets=self.num_targets,
            use_yaw_targets=self.use_yaw_targets,
            goal_reach_distance=self.goal_reach_distance,
            goal_reach_angle=self.goal_reach_angle,
            flight_dome_size=self.flight_dome_size,
        )

    def scene_boxes(self, state: QuadXWaypointsState):
        return self.waypoints.marker_boxes(state.wp)

    # ----- observation ----------------------------------------------------
    @property
    def obs_size(self) -> int:  # the attitude part only, as in the JAX env
        return self.combined_size

    @property
    def flat_obs_size(self) -> int:
        """Width of the flattened dict observation (``rl/ppo._flat_obs``)."""
        return self.combined_size + self.num_targets * self.waypoints.delta_size

    def _obs(self, state: QuadXWaypointsState) -> dict:
        return {"attitude": self.attitude_obs(state), "target_deltas": state.target_deltas}

    # ----- reset ----------------------------------------------------------
    def reset(
        self, num_envs: int, generator: torch.Generator | None = None
    ) -> tuple[QuadXWaypointsState, dict]:
        base = self.init_env_state(num_envs, generator)
        wph = self.waypoints
        ws = wph.reset(num_envs, generator, dtype=self.cfg.dtype, device=self.device)
        view = base.drone.read.view
        ws, deltas = wph.update_distances(ws, view[:, 1], view[:, 3], pm.euler_to_quat(view[:, 1]))
        state = QuadXWaypointsState(
            **{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
            wp=ws,
            target_deltas=wph.remaining_deltas(ws, deltas),
        )
        return state, self._obs(state)

    # ----- per-inner-step task update -------------------------------------
    def _task_update(self, state: QuadXWaypointsState, contact: Tensor) -> QuadXWaypointsState:
        wph = self.waypoints
        view = state.drone.read.view
        ang_pos, lin_pos = view[:, 1], view[:, 3]
        ws, deltas = wph.update_distances(state.wp, ang_pos, lin_pos, pm.euler_to_quat(ang_pos))
        state = dataclasses.replace(state, wp=ws, target_deltas=wph.remaining_deltas(ws, deltas))

        state = self.base_term_trunc_reward(state, contact)
        reward = state.reward
        if not self.sparse_reward:
            reward = reward + torch.clamp(3.0 * wph.progress_to_target(ws), min=0.0)
            reward = reward + 0.1 / wph.immediate_distance(ws, deltas)

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

    def step(self, state: QuadXWaypointsState, action: Tensor) -> tuple[QuadXWaypointsState, StepOut]:
        return self.base_step(
            state, action, self._task_update, self._obs,
            extra_info=lambda s: {"num_targets_reached": s.wp.idx},
        )
