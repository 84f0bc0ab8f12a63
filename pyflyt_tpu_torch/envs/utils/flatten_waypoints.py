"""Waypoint-observation flattening (port of
``pyflyt_tpu/envs/utils/flatten_waypoints.py``): the attitude vector and
the first ``context_length`` remaining target deltas (zero-padded), as one
flat observation. The delta buffer is already rolled and zero-padded
(``WaypointHandler.remaining_deltas``), so this is a slice and a concat.

As in the JAX package, the declared size is the emitted one,
``attitude + context_length · delta_size`` (the reference declares
``attitude + delta_size``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import Tensor


def flatten_waypoint_obs(obs: dict, context_length: int = 2) -> Tensor:
    """{"attitude": (..., A), "target_deltas": (..., N, K)} → (..., A + C·K),
    zero-padded when ``context_length`` exceeds the target count."""
    deltas = obs["target_deltas"]
    n = deltas.shape[-2]
    if context_length > n:
        deltas = F.pad(deltas, (0, 0, 0, context_length - n))
    deltas = deltas[..., :context_length, :]
    flat = deltas.reshape(*deltas.shape[:-2], -1)
    return torch.cat([obs["attitude"], flat], dim=-1)


class FlattenWaypointEnv:
    """Batched-env wrapper flattening dict observations."""

    def __init__(self, env, context_length: int = 2):
        if not hasattr(env, "waypoints"):
            raise ValueError("Only a waypoints environment can be used with `FlattenWaypointEnv`.")
        self.env = env
        self.context_length = context_length

    def __getattr__(self, name):
        return getattr(self.env, name)

    @property
    def obs_size(self) -> int:
        return self.env.combined_size + self.context_length * self.env.waypoints.delta_size

    @property
    def flat_obs_size(self) -> int:  # the observation is flat already
        return self.obs_size

    def reset(self, num_envs: int, generator: torch.Generator | None = None):
        state, obs = self.env.reset(num_envs, generator)
        return state, flatten_waypoint_obs(obs, self.context_length)

    def step(self, state, action):
        state, out = self.env.step(state, action)
        return state, dataclasses.replace(out, obs=flatten_waypoint_obs(out.obs, self.context_length))

    def action_bounds(self):
        return self.env.action_bounds()
