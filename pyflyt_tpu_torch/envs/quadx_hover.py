"""QuadX Hover task (port of ``pyflyt_tpu/envs/quadx_hover.py``): hover at
[0, 0, 1]; dense reward ``−0.1 − ‖pos − (0,0,1)‖ − ‖(roll, pitch)‖ + 1``
accumulated per inner aviary step, −100 on collision or leaving the dome.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from pyflyt_tpu_torch.envs.base import StepOut
from pyflyt_tpu_torch.envs.quadx_base import QuadXBaseEnv, QuadXEnvState


@dataclasses.dataclass(frozen=True)
class QuadXHoverEnv(QuadXBaseEnv):
    sparse_reward: bool = False
    flight_dome_size: float = 3.0
    agent_hz: int = 40

    @property
    def obs_size(self) -> int:
        return self.combined_size

    def reset(
        self, num_envs: int, generator: torch.Generator | None = None
    ) -> tuple[QuadXEnvState, Tensor]:
        state = self.init_env_state(num_envs, generator)
        return state, self.attitude_obs(state)

    def _task_update(self, state: QuadXEnvState, contact: Tensor) -> QuadXEnvState:
        state = self.base_term_trunc_reward(state, contact)
        if self.sparse_reward:
            return state
        view = state.drone.read.view
        target = view.new_tensor([0.0, 0.0, 1.0])
        linear_distance = torch.linalg.vector_norm(view[..., 3, :] - target, dim=-1)
        angular_distance = torch.linalg.vector_norm(view[..., 1, :2], dim=-1)
        reward = state.reward - linear_distance - angular_distance + 1.0
        return dataclasses.replace(state, reward=reward)

    def step(
        self, state: QuadXEnvState, action: Tensor
    ) -> tuple[QuadXEnvState, StepOut]:
        return self.base_step(state, action, self._task_update, self.attitude_obs)
