"""QuadX Gates task (port of ``pyflyt_tpu/envs/quadx_gates.py``),
batched: fly through a chain of randomly oriented race gates with an
onboard FPV camera.

Semantics kept from the JAX env:
- the chained gate placement (``chain_gates``): a gate a distance U(1, 4)
  on and angles U(−1, 1) · ``max_gate_angles`` turned further, with the
  minimum-height vertical offset; it takes the draws, so a test can feed
  it the JAX env's own;
- the obs dict {``attitude`` (the base env's 21), ``rgba_cam`` ``(N, 4,
  H, W)`` uint8 channels first, ``target_deltas`` ``(N, n, 3)``, the
  body-frame deltas from the current gate on, rows past the last zero};
  ``rl/ppo._flat_obs`` flattens it in sorted-key order, the image as f32
  (``flat_obs_size``);
- the render (``core/camera.capture_image``, FPV at the camera link): the
  gates green (current), yellow (upcoming) and red (passed), one holed box
  each;
- the reward: −0.1 an agent step, −100 and termination more than
  2 · ``max_gate_distance`` from the current gate, +100 on a pass, which
  advances ``idx`` or, at the last gate, completes the episode.

Reset draws the gates from the batch's generator (Philox) after the 10
stabilization steps, where the JAX env folds its key with 11: reset
states differ from the JAX package's by design, and tests carry JAX states
in (``convert.gates_state_from_jax``). ``native_batch`` and the auto-reset
methods let ``rl/ppo`` step the batch as it is; ``use_kernel`` steps the
physics through the generic QuadX kernel (``envs/quadx_base``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.core import camera as cam
from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.envs import base as env_base
from pyflyt_tpu_torch.envs.base import StepOut
from pyflyt_tpu_torch.envs.quadx_base import QuadXBaseEnv, QuadXEnvState

GREEN = (0.0, 1.0, 0.0, 1.0)  # the current gate
YELLOW = (1.0, 1.0, 0.0, 1.0)  # the gates after it
RED = (1.0, 0.0, 0.0, 1.0)  # the gates passed


@dataclasses.dataclass
class QuadXGatesState(QuadXEnvState):
    gate_positions: Tensor  # (N, n, 3)
    gate_eulers: Tensor  # (N, n, 3)
    idx: Tensor  # (N,) int32: the current gate
    dis_error_scalar: Tensor  # (N,) distance to the current gate
    target_deltas: Tensor  # (N, n, 3) the remaining view


def chain_gates(
    distances: Tensor, angles: Tensor, max_gate_distance: float = 4.0, min_gate_height: float = 1.0,
    max_pitch: float = 0.3,
) -> tuple[Tensor, Tensor]:
    """Gate positions and eulers ``(N, n, 3)`` from the draws: each gate
    ``new_R · old_R · [0, d, v]`` past the previous one (from ``[0, 0,
    1]``, level), its euler the running sum of the angles, where ``v`` lifts
    the gate when even a full-length leg pitched down by ``max_pitch``
    could end below ``min_gate_height``.

    ``distances`` ``(N, n)``, already in [min, max); ``angles`` ``(N, n,
    3)``, already scaled by ``max_gate_angles``."""
    max_cos = float(np.cos(max_pitch))
    n_env, n = distances.shape
    pos = distances.new_tensor([0.0, 0.0, 1.0]).expand(n_env, 3)
    ang = distances.new_zeros(n_env, 3)
    positions, eulers = [], []
    for k in range(n):
        limit = pos[:, 2] + max_gate_distance * max_cos
        vertical = torch.where(limit < min_gate_height, limit, 0.0)
        leg = torch.stack([torch.zeros_like(distances[:, k]), distances[:, k], vertical], dim=-1)
        rot = pm.euler_to_rotmat(angles[:, k]) @ pm.euler_to_rotmat(ang)
        pos = pos + (rot @ leg[..., None])[..., 0]
        ang = ang + angles[:, k]
        positions.append(pos)
        eulers.append(ang)
    return torch.stack(positions, dim=1), torch.stack(eulers, dim=1)


@dataclasses.dataclass(frozen=True)
class QuadXGatesEnv(QuadXBaseEnv):
    num_targets: int = 5
    goal_reach_distance: float = 0.21
    min_gate_height: float = 1.0
    max_gate_angles: tuple = (0.0, 0.3, 1.0)
    min_gate_distance: float = 1.0
    max_gate_distance: float = 4.0
    camera_resolution: tuple = (128, 128)
    camera_fov_degrees: float = 90.0
    agent_hz: int = 40

    native_batch = True  # PPO: the env steps and auto-resets the batch itself
    time_limit_truncation_only = True  # a pass of the last gate terminates; only the time limit truncates

    # ----- observation ------------------------------------------------------
    @property
    def obs_size(self) -> int:  # the attitude part only, as in the JAX env
        return self.combined_size

    @property
    def image_shape(self) -> tuple[int, int, int]:
        return (4, *self.camera_resolution)

    @property
    def flat_obs_size(self) -> int:
        """Width of the flattened dict observation (``rl/ppo._flat_obs``):
        attitude, then the image, then the deltas."""
        return self.combined_size + math.prod(self.image_shape) + self.num_targets * 3

    @functools.cached_property
    def _palette(self) -> tuple[Tensor, Tensor, Tensor, Tensor]:
        """The gate order ``(1, n)`` and the red, green and yellow RGBA, on the device."""
        c = lambda rgba: torch.tensor(rgba, dtype=self.cfg.dtype, device=self.device)  # noqa: E731
        return torch.arange(self.num_targets, device=self.device)[None, :], c(RED), c(GREEN), c(YELLOW)

    def gate_colors(self, idx: Tensor) -> Tensor:
        """``(N, n, 4)``: red before ``idx``, green at it, yellow after."""
        order, red, green, yellow = self._palette
        i = idx[:, None].to(order.dtype)
        return torch.where((order < i)[..., None], red, torch.where((order == i)[..., None], green, yellow))

    def scene_boxes(self, state: QuadXGatesState) -> cam.Boxes:
        """The gates as render boxes, coloured by progress."""
        return cam.gate_boxes(state.gate_positions, state.gate_eulers, self.gate_colors(state.idx))

    def _render_camera(self, state: QuadXGatesState) -> Tensor:
        """``(N, 4, H, W)`` uint8, channels first; the eye at the camera
        link (ENU_FLU: ``lin_pos``)."""
        view = state.drone.read.view
        rgba, _, _ = cam.capture_image(
            view[:, 3], view[:, 1], self.scene_boxes(state),
            resolution=tuple(self.camera_resolution), fov_degrees=self.camera_fov_degrees,
        )
        return rgba.permute(0, 3, 1, 2).contiguous()

    def _deltas(self, state: QuadXGatesState) -> tuple[Tensor, Tensor]:
        """Body-frame deltas to every gate and the distance to the current one."""
        view = state.drone.read.view
        R = pm.quat_to_rotmat(pm.euler_to_quat(view[:, 1]))
        deltas = torch.einsum("bji,bnj->bni", R, state.gate_positions - view[:, 3][:, None, :])
        i = state.idx.to(torch.int64)[:, None, None].expand(-1, 1, 3)
        current = torch.gather(deltas, 1, i)[:, 0]
        return deltas, torch.linalg.vector_norm(current, dim=-1)

    def _remaining(self, state: QuadXGatesState, deltas: Tensor) -> Tensor:
        """Row k is gate ``idx + k``; rows past the last gate zero (the JAX
        env's per-env roll, as a gather on ``(arange + idx) % n``)."""
        n = self.num_targets
        ar = torch.arange(n, device=deltas.device)
        rows = (ar[None, :] + state.idx[:, None].to(torch.int64)) % n
        rolled = torch.gather(deltas, 1, rows[..., None].expand(-1, -1, 3))
        mask = ar[None, :] < (n - state.idx[:, None])
        return torch.where(mask[..., None], rolled, 0.0)

    def _obs(self, state: QuadXGatesState) -> dict:
        return {
            "attitude": self.attitude_obs(state),
            "rgba_cam": self._render_camera(state),
            "target_deltas": state.target_deltas,
        }

    # ----- reset --------------------------------------------------------------
    def draw_gates(self, num_envs: int, generator: torch.Generator) -> tuple[Tensor, Tensor]:
        """The chain's draws from ``generator``: distances U(min, max) and
        angles U(−1, 1) · ``max_gate_angles``."""
        dt, dev, n = self.cfg.dtype, self.device, self.num_targets
        u = torch.rand((num_envs, n), generator=generator, dtype=dt, device=dev)
        distances = self.min_gate_distance + u * (self.max_gate_distance - self.min_gate_distance)
        a = torch.rand((num_envs, n, 3), generator=generator, dtype=dt, device=dev) * 2.0 - 1.0
        angles = a * torch.tensor(self.max_gate_angles, dtype=dt, device=dev)
        return distances, angles

    def reset(self, num_envs: int, generator: torch.Generator | None = None) -> tuple[QuadXGatesState, dict]:
        """A fresh batch; ``generator`` draws the motor noise and the gates,
        and stays the batch's stream."""
        if generator is None:
            raise ValueError("QuadXGatesEnv.reset needs a torch.Generator (the gates are drawn from it)")
        base = self.init_env_state(num_envs, generator)
        positions, eulers = chain_gates(*self.draw_gates(num_envs, generator), self.max_gate_distance,
                                        self.min_gate_height, self.max_gate_angles[1])
        n_env, dt, dev = num_envs, self.cfg.dtype, self.device
        state = QuadXGatesState(
            **{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
            gate_positions=positions,
            gate_eulers=eulers,
            idx=torch.zeros(n_env, dtype=torch.int32, device=dev),
            dis_error_scalar=torch.zeros(n_env, dtype=dt, device=dev),
            target_deltas=torch.zeros(n_env, self.num_targets, 3, dtype=dt, device=dev),
        )
        deltas, dist = self._deltas(state)
        state = dataclasses.replace(state, dis_error_scalar=dist, target_deltas=self._remaining(state, deltas))
        return state, self._obs(state)

    # ----- the per-inner-step task update --------------------------------------
    def _task_update(self, state: QuadXGatesState, contact: Tensor) -> QuadXGatesState:
        deltas, dist = self._deltas(state)
        state = dataclasses.replace(state, dis_error_scalar=dist, target_deltas=self._remaining(state, deltas))
        state = self.base_term_trunc_reward(state, contact)

        # out of range of the current gate
        oob = dist > 2.0 * self.max_gate_distance
        reward = torch.where(oob, state.reward - 100.0, state.reward)
        termination = state.termination | oob

        # a gate passed
        reached = dist < self.goal_reach_distance
        reward = torch.where(reached, reward + 100.0, reward)
        last = state.idx >= self.num_targets - 1
        complete = reached & last
        idx = torch.where(reached & ~last, state.idx + 1, state.idx)
        return dataclasses.replace(
            state,
            reward=reward,
            termination=termination | complete,
            out_of_bounds=state.out_of_bounds | oob,
            env_complete=state.env_complete | complete,
            idx=idx,
        )

    def step(self, state: QuadXGatesState, action: Tensor) -> tuple[QuadXGatesState, StepOut]:
        return self.base_step(
            state, action, self._task_update, self._obs, extra_info=lambda s: {"num_targets_reached": s.idx}
        )

    # ----- auto-reset (rl/ppo's native_batch adapter) ----------------------------
    def autoreset_step(self, state, action: Tensor):
        """Exact auto-reset: the whole batch is reset every step from the
        state's generator and finished lanes take it (``envs/base``)."""
        return env_base.autoreset_step(self, state, action)

    def cached_autoreset_init(self, num_envs: int, generator: torch.Generator | None = None):
        return env_base.autoreset_init(self, num_envs, generator)

    def cached_autoreset_step(self, ars, action: Tensor, refresh: int = 64):
        return env_base.cached_autoreset_step(self, ars, action, refresh)
