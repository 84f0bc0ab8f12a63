"""Packed-state QuadX Waypoints env: the whole agent step is one kernel
(port of ``pyflyt_tpu/envs/packed_quadx_waypoints.py``).

``N`` envs live in the ``(rows_for_waypoints(mode), N)`` layout of
``ops/cuda_quadx.py``, the waypoint targets stored rolled so the current
target is the first three waypoint rows. ``step`` writes the action into
the setpoint rows, launches ``cuda_quadx.packed_waypoints_step`` once
(``env_step_ratio`` aviary steps plus the waypoint task update, reward,
target advance, termination, truncation and the done-freeze) and assembles
the dict observation from packed rows. Reset is the plain env's batched
reset (10 stabilization steps and the target draws), packed.

Like the JAX env it has no auto-reset: it serves a policy over whole
episodes (finished lanes stay frozen), and PPO trains on the plain env.

Semantics match ``QuadXWaypointsEnv`` with noise off, up to f32 rounding:
the kernel rotates the deltas with the last physics iteration's
pre-integration rotation where the plain env rebuilds it from the view's
euler angles, and its contact is detection-grade (it only shows after a
termination). Envelope, as the JAX env's: modes 0, 7 and 8, ENU,
``use_yaw_targets=False``, at most 4 targets.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import Tensor

from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.envs.base import StepOut
from pyflyt_tpu_torch.envs.quadx_waypoints import QuadXWaypointsEnv, QuadXWaypointsState
from pyflyt_tpu_torch.ops import cuda_quadx as cq


@dataclasses.dataclass
class PackedWaypointsState:
    packed: Tensor  # (rows_for_waypoints(mode), N)
    generator: torch.Generator | None  # draws each step's kernel seed


@dataclasses.dataclass(frozen=True)
class PackedQuadXWaypointsEnv:
    """Batch-level env on the packed layout; ``base`` holds the task
    configuration and the device."""

    base: QuadXWaypointsEnv = dataclasses.field(default_factory=QuadXWaypointsEnv)

    def __post_init__(self):
        b = self.base
        if b.flight_mode not in cq.WAYPOINT_MODES:
            raise NotImplementedError(f"the packed waypoints env covers modes 0, 7 and 8, not {b.flight_mode}")
        if b.orn_conv != "ENU_FLU":
            raise NotImplementedError("the packed waypoints env is ENU only")
        if b.use_yaw_targets:
            raise NotImplementedError("the packed waypoints env carries 3-wide target deltas only")
        if b.num_targets > cq.MAX_TARGETS:
            raise NotImplementedError(f"the packed waypoints env carries at most {cq.MAX_TARGETS} targets")

    @property
    def flat_obs_size(self) -> int:
        return self.base.flat_obs_size

    @property
    def action_size(self) -> int:
        return 4

    def action_bounds(self):
        return self.base.action_bounds()

    @property
    def _wb(self) -> int:
        return cq.rows_for(self.base.flight_mode)

    @functools.cached_property
    def consts(self) -> cq.WaypointsConsts:
        b = self.base
        return cq.waypoints_consts(
            b.params, b.cfg, inner_steps=b.env_step_ratio, dome=b.flight_dome_size,
            max_steps=b.max_steps, num_targets=b.num_targets, goal=b.goal_reach_distance,
        )

    # ----- layout conversions ---------------------------------------------
    def pack_env_state(self, st: QuadXWaypointsState) -> Tensor:
        """Batched ``QuadXWaypointsState`` → packed rows; row k of the
        targets holds target ``(idx + k) mod num_targets``."""
        b = self.base
        nt = b.num_targets
        packed = cq.pack_state(st.drone, b.flight_mode)
        n = packed.shape[1]
        packed[cq._RWD : cq._STEP + 1] = torch.stack([
            st.reward, st.termination, st.truncation, st.collision, st.out_of_bounds, st.step_count,
        ]).to(torch.float32)
        ar = (st.wp.idx[:, None].to(torch.int64) + torch.arange(nt, device=packed.device)[None, :]) % nt
        rolled = torch.gather(st.wp.targets, 1, ar[..., None].expand(-1, -1, 3))
        pad = packed.new_zeros((n, cq.MAX_TARGETS - nt, 3))
        wp_rows = torch.cat([
            torch.cat([rolled.to(torch.float32), pad], dim=1).reshape(n, 12).T,
            (nt - st.wp.idx).to(torch.float32)[None, :],
            st.wp.new_distance[None, :],
            st.wp.old_distance[None, :],
            torch.cat([st.target_deltas.to(torch.float32), pad], dim=1).reshape(n, 12).T,
            st.env_complete.to(torch.float32)[None, :],
        ], dim=0)
        total = cq.rows_for_waypoints(b.flight_mode)
        tail = packed.new_zeros((total - self._wb - cq.WP_ROWS, n))
        return torch.cat([packed, wp_rows, tail], dim=0).contiguous()

    def _obs(self, packed: Tensor) -> dict:
        """The dict observation from packed rows."""
        b = self.base
        rows = lambda r, k: packed[r : r + k].T  # noqa: E731
        euler = rows(cq._VIEW + 3, 3)
        att = pm.euler_to_quat(euler) if b.angle_representation == "quaternion" else euler
        attitude = torch.cat([
            rows(cq._VIEW, 3), att, rows(cq._VIEW + 6, 3), rows(cq._VIEW + 9, 3),
            rows(cq._SP, 4), rows(cq._THR, 4),
        ], dim=-1)
        t0 = self._wb + cq._WP_TDLT
        deltas = rows(t0, 3 * b.num_targets).reshape(-1, b.num_targets, 3)
        return {"attitude": attitude, "target_deltas": deltas}

    # ----- env API ----------------------------------------------------------
    def reset(
        self, num_envs: int, generator: torch.Generator | None = None
    ) -> tuple[PackedWaypointsState, dict]:
        """The plain env's batched reset (10 stabilization steps and the
        target draws), packed."""
        st, obs = self.base.reset(num_envs, generator)
        return PackedWaypointsState(packed=self.pack_env_state(st), generator=generator), obs

    def step(
        self, state: PackedWaypointsState, action: Tensor
    ) -> tuple[PackedWaypointsState, StepOut]:
        """One agent step: one kernel launch. The action is written into the
        state's setpoint rows in place (applied before the inner loop, frozen
        lanes included, as in the plain env); the kernel returns the next
        state as a new tensor."""
        b = self.base
        packed = state.packed
        if b.noisy_motors:
            seed = torch.randint(
                0, 2**31 - 1, (1,), generator=state.generator, device=packed.device, dtype=torch.int64
            )
        else:
            seed = torch.zeros(1, dtype=torch.int64, device=packed.device)
        packed[cq._SP : cq._SP + 4] = action.to(packed.dtype).T
        out = cq.packed_waypoints_step(
            packed, seed, self.consts, mode=b.flight_mode, noisy=b.noisy_motors, sparse=b.sparse_reward,
        )
        wb = self._wb
        step_out = StepOut(
            obs=self._obs(out),
            reward=out[cq._RWD],
            termination=out[cq._TERM] > 0.5,
            truncation=out[cq._TRUNC] > 0.5,
            info={
                "collision": out[cq._COLL] > 0.5,
                "out_of_bounds": out[cq._OOB] > 0.5,
                "env_complete": out[wb + cq._WP_CPLT] > 0.5,
                "num_targets_reached": (b.num_targets - out[wb + cq._WP_REM]).round().to(torch.int32),
            },
        )
        return PackedWaypointsState(packed=out, generator=state.generator), step_out
