"""Rocket Landing task (port of ``pyflyt_tpu/envs/rocket_landing.py``),
batched: drop from ~450 m at −100 m/s with 1% fuel and land upright on a
2 m-radius pad placed at random within ``0.05 · ceiling`` of the origin.

Reward per inner aviary step: −5 + 2/(pad offset + 0.1) + 100 · xy
progress − |yaw rate| − 3 · ‖tilt‖; +20 on a pad touch; the touch is fatal
when the previous step's ‖ω‖ > 0.35 or ‖v‖ > 1.0, and **+500 landed** when
‖ω‖ < 0.02, ‖v‖ < 0.02 (both the previous step's) and the tilt is under
0.1. The observation (33 with quaternions) is the base env's attitude
(13), the previous action (7), the auxiliary state (9), the pad-contact
flag and the pad-relative distance rotated into the body frame.

Reset draws the pad and the drop from the batch's generator, where the
JAX env splits a key, so reset states differ from the JAX package's by
design; tests carry JAX reset states in
(``convert.rocket_landing_state_from_jax``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import Tensor

from pyflyt_tpu_torch.core import camera as cam
from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.envs.base import StepOut
from pyflyt_tpu_torch.envs.rocket_base import RocketBaseEnv, RocketEnvState


@dataclasses.dataclass
class RocketLandingState(RocketEnvState):
    pad_position: Tensor  # (N, 3)
    pad_contact_flag: Tensor  # (N,) float, an observation field
    ang_vel: Tensor  # (N, 3) the current body rates (the compute_state memo)
    lin_vel: Tensor  # (N, 3)
    distance: Tensor  # (N, 3) lin_pos - pad_position
    prev_ang_vel: Tensor
    prev_lin_vel: Tensor
    prev_distance: Tensor


@dataclasses.dataclass(frozen=True)
class RocketLandingEnv(RocketBaseEnv):
    sparse_reward: bool = False

    @property
    def obs_size(self) -> int:
        # combined + pad contact flag + rotated pad-relative distance
        return self.combined_size + 1 + 3

    def _obs(self, state: RocketLandingState) -> Tensor:
        rotation = pm.quat_to_rotmat(pm.euler_to_quat(state.drone.read.view[..., 1, :]))
        rotated_distance = torch.einsum("...j,...ji->...i", state.distance, rotation)
        return torch.cat([self.attitude_obs(state), state.pad_contact_flag[..., None], rotated_distance], dim=-1)

    def reset(self, num_envs: int, generator: torch.Generator | None = None) -> tuple[RocketLandingState, Tensor]:
        """The polar pad placement, then the base drop reset; both draw
        from ``generator``."""
        if generator is None:
            raise ValueError("reset needs a torch.Generator (the pad placement)")
        dtype, dev = self.cfg.dtype, self.device
        theta = 2.0 * math.pi * torch.rand(num_envs, generator=generator, dtype=dtype, device=dev)
        dist = 0.05 * self.ceiling * torch.rand(num_envs, generator=generator, dtype=dtype, device=dev)
        pad_position = torch.stack([torch.cos(theta), torch.sin(theta), torch.full_like(theta, 0.1)], dim=-1)
        pad_position = pad_position * dist[:, None]

        base = self.init_env_state(num_envs, generator, pad_position)
        zero3 = torch.zeros(num_envs, 3, dtype=dtype, device=dev)
        state = RocketLandingState(
            **{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
            pad_position=pad_position,
            pad_contact_flag=torch.zeros(num_envs, dtype=dtype, device=dev),
            ang_vel=zero3,
            lin_vel=zero3.clone(),
            distance=zero3.clone(),
            prev_ang_vel=zero3.clone(),
            prev_lin_vel=zero3.clone(),
            prev_distance=zero3.clone(),
        )
        state = self._compute_state_fields(state)
        return state, self._obs(state)

    def _compute_state_fields(self, state: RocketLandingState) -> RocketLandingState:
        """The memo shift: the current readouts become the previous ones,
        then refresh from the view and the pad."""
        view = state.drone.read.view
        return dataclasses.replace(
            state,
            prev_ang_vel=state.ang_vel,
            prev_lin_vel=state.lin_vel,
            prev_distance=state.distance,
            ang_vel=view[..., 0, :],
            lin_vel=view[..., 2, :],
            distance=view[..., 3, :] - state.pad_position,
        )

    def _task_update(self, state: RocketLandingState, ground_contact: Tensor, pad_contact: Tensor) -> RocketLandingState:
        state = self._compute_state_fields(state)
        ang_pos = state.drone.read.view[..., 1, :]
        # a fatal contact excludes the pad: ground_contact is already pad-free
        state = self.base_term_trunc(state, ground_contact)
        norm = lambda v: torch.linalg.vector_norm(v, dim=-1)  # noqa: E731

        reward = state.reward
        if not self.sparse_reward:
            progress_to_pad = norm(state.prev_distance[..., :2]) - norm(state.distance[..., :2])
            offset_to_pad = norm(state.distance[..., :2]) + 0.1
            reward = reward + (
                -5.0
                + (2.0 / offset_to_pad)
                + (100.0 * progress_to_pad)
                - torch.abs(state.ang_vel[..., 2])
                - 3.0 * norm(ang_pos[..., :2])
            )

        # the pad touchdown, on the previous step's rates
        reward = torch.where(pad_contact, reward + 20.0, reward)
        hard = (norm(state.prev_ang_vel) > 0.35) | (norm(state.prev_lin_vel) > 1.0)
        landed = (norm(state.prev_ang_vel) < 0.02) & (norm(state.prev_lin_vel) < 0.02) & (norm(ang_pos[..., :2]) < 0.1)
        fatal_touch = pad_contact & hard
        complete = pad_contact & ~hard & landed
        return dataclasses.replace(
            state,
            reward=torch.where(complete, reward + 500.0, reward),
            pad_contact_flag=pad_contact.to(reward.dtype),
            termination=state.termination | fatal_touch | complete,
            fatal_collision=state.fatal_collision | fatal_touch,
            env_complete=state.env_complete | complete,
        )

    def scene_boxes(self, state: RocketLandingState) -> cam.Boxes:
        """The landing pad for third-person renders: a box in place of the
        cylinder (landing_pad.urdf: r = 2, l = 0.1), one an env."""
        dt, dev = state.pad_position.dtype, state.pad_position.device
        return cam.Boxes(
            centers=state.pad_position[:, None, :],
            half_extents=torch.tensor([[2.0, 2.0, 0.05]], dtype=dt, device=dev),
            rotations=torch.eye(3, dtype=dt, device=dev)[None],
            colors=torch.tensor([[0.2, 0.2, 0.8, 1.0]], dtype=dt, device=dev),
            visible=torch.ones(1, dtype=torch.bool, device=dev),
        )

    def step(self, state: RocketLandingState, action: Tensor) -> tuple[RocketLandingState, StepOut]:
        return self.base_step(state, action, self._task_update, self._obs, pad_position=state.pad_position)
