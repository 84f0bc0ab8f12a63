"""Packed-state Fixedwing Waypoints env: the whole agent step is one kernel
launch (port of ``pyflyt_tpu/envs/packed_fixedwing_waypoints.py``).

``N`` envs live in the ``(88, N)`` layout of ``ops/cuda_fixedwing.py``,
the waypoint targets stored rolled so the current target is rows 60-62
(``idx = num_targets - remaining``). ``step`` writes the action into the
setpoint rows, launches ``cuda_fixedwing.packed_waypoints_step`` once
(``env_step_ratio`` aviary steps plus the waypoint task update, reward,
target advance, termination, truncation and the done-freeze) and builds
the dict observation from packed rows. Reset is the plain env's batched
reset (10 stabilization steps and the target draws), packed.

Like the JAX env it has no auto-reset: it serves a policy over whole
episodes (finished lanes stay frozen); PPO trains on the plain env.

Semantics match ``FixedwingWaypointsEnv`` with noise off, up to f32
rounding: the kernel rotates the deltas with the last physics iteration's
pre-integration rotation where the plain env rebuilds it from the view's
euler angles, and its contact is detection-grade (it only shows after a
termination). Modes -1 and 0, at most 4 targets.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import Tensor

from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.envs.base import StepOut
from pyflyt_tpu_torch.envs.fixedwing_waypoints import FixedwingWaypointsEnv, FixedwingWaypointsState
from pyflyt_tpu_torch.envs.packed_quadx_waypoints import PackedWaypointsState
from pyflyt_tpu_torch.ops import cuda_fixedwing as cf


@dataclasses.dataclass(frozen=True)
class PackedFixedwingWaypointsEnv:
    """Batch-level env on the packed layout; ``base`` holds the task
    configuration and the device."""

    base: FixedwingWaypointsEnv = dataclasses.field(default_factory=FixedwingWaypointsEnv)

    def __post_init__(self):
        if self.base.num_targets > cf.MAX_TARGETS:
            raise NotImplementedError(f"the packed waypoints env carries at most {cf.MAX_TARGETS} targets")

    @property
    def flat_obs_size(self) -> int:
        return self.base.flat_obs_size

    @property
    def action_size(self) -> int:
        return self.base.action_size

    def action_bounds(self):
        return self.base.action_bounds()

    @functools.cached_property
    def consts(self) -> cf.FixedwingConsts:
        b = self.base
        return cf.waypoints_consts(
            b.params, b.cfg, inner_steps=b.env_step_ratio, dome=b.flight_dome_size, max_steps=b.max_steps,
            goal=b.goal_reach_distance, num_targets=b.num_targets,
        )

    # ----- layout conversions ---------------------------------------------
    def pack_env_state(self, st: FixedwingWaypointsState) -> Tensor:
        """Batched ``FixedwingWaypointsState`` → packed rows; row k of the
        targets holds target ``(idx + k) mod num_targets``."""
        nt = self.base.num_targets
        packed = cf.pack_state(st.drone)
        n = packed.shape[1]
        packed[cf._RWD : cf._CPLT + 1] = torch.stack([
            st.reward, st.termination, st.truncation, st.collision, st.out_of_bounds, st.step_count,
            st.env_complete,
        ]).to(torch.float32)
        ar = (st.wp.idx[:, None].to(torch.int64) + torch.arange(nt, device=packed.device)[None, :]) % nt
        rolled = torch.gather(st.wp.targets, 1, ar[..., None].expand(-1, -1, 3))
        pad = packed.new_zeros((n, cf.MAX_TARGETS - nt, 3))
        packed[cf._TGT : cf._TGT + 12] = torch.cat([rolled.to(torch.float32), pad], dim=1).reshape(n, 12).T
        packed[cf._REM] = (nt - st.wp.idx).to(torch.float32)
        packed[cf._NDIST] = st.wp.new_distance
        packed[cf._ODIST] = st.wp.old_distance
        packed[cf._TDLT : cf._TDLT + 12] = torch.cat([st.target_deltas.to(torch.float32), pad], dim=1).reshape(n, 12).T
        return packed

    def unpack_env_state(self, packed: Tensor, template: FixedwingWaypointsState) -> FixedwingWaypointsState:
        """Packed rows → batched ``FixedwingWaypointsState`` (the targets
        rolled back to the handler's cursor form)."""
        nt = self.base.num_targets
        n = packed.shape[1]
        idx = (nt - packed[cf._REM]).round().to(torch.int32)
        rolled = packed[cf._TGT : cf._TGT + 3 * nt].T.reshape(n, nt, 3)
        ar = (torch.arange(nt, device=packed.device)[None, :] - idx[:, None].to(torch.int64)) % nt
        targets = torch.gather(rolled, 1, ar[..., None].expand(-1, -1, 3))
        flag = lambda r: packed[r] > 0.5  # noqa: E731
        return dataclasses.replace(
            template,
            drone=cf.unpack_state(packed, template.drone),
            reward=packed[cf._RWD],
            termination=flag(cf._TERM),
            truncation=flag(cf._TRUNC),
            collision=flag(cf._COLL),
            out_of_bounds=flag(cf._OOB),
            step_count=packed[cf._STEP].round().to(torch.int32),
            env_complete=flag(cf._CPLT),
            action=packed[cf._SP : cf._SP + self.action_size].T,
            wp=dataclasses.replace(template.wp, targets=targets, idx=idx, new_distance=packed[cf._NDIST],
                                   old_distance=packed[cf._ODIST]),
            target_deltas=packed[cf._TDLT : cf._TDLT + 3 * nt].T.reshape(n, nt, 3),
        )

    def _obs(self, packed: Tensor) -> dict:
        """The dict observation from packed rows."""
        b = self.base
        rows = lambda r, k: packed[r : r + k].T  # noqa: E731
        euler = rows(cf._VIEW + 3, 3)
        att = pm.euler_to_quat(euler) if b.angle_representation == "quaternion" else euler
        attitude = torch.cat([
            rows(cf._VIEW, 3), att, rows(cf._VIEW + 6, 3), rows(cf._VIEW + 9, 3),
            rows(cf._SP, self.action_size), rows(cf._ACT, 6),  # 5 surfaces + throttle
        ], dim=-1)
        deltas = rows(cf._TDLT, 3 * b.num_targets).reshape(-1, b.num_targets, 3)
        return {"attitude": attitude, "target_deltas": deltas}

    # ----- env API ----------------------------------------------------------
    def reset(
        self, num_envs: int, generator: torch.Generator | None = None
    ) -> tuple[PackedWaypointsState, dict]:
        """The plain env's batched reset, packed."""
        st, obs = self.base.reset(num_envs, generator)
        return PackedWaypointsState(packed=self.pack_env_state(st), generator=generator), obs

    def step(self, state: PackedWaypointsState, action: Tensor) -> tuple[PackedWaypointsState, StepOut]:
        """One agent step: one kernel launch. The action is written into the
        state's setpoint rows in place (before the inner loop, frozen lanes
        included, as in the plain env); the kernel returns the next state as
        a new tensor."""
        b = self.base
        packed = state.packed
        if b.noisy_motors:
            seed = torch.randint(
                0, 2**31 - 1, (1,), generator=state.generator, device=packed.device, dtype=torch.int64
            )
        else:
            seed = torch.zeros(1, dtype=torch.int64, device=packed.device)
        packed[cf._SP : cf._SP + self.action_size] = action.to(packed.dtype).T
        out = cf.packed_waypoints_step(packed, seed, self.consts, b.flight_mode, b.noisy_motors, b.sparse_reward)
        step_out = StepOut(
            obs=self._obs(out),
            reward=out[cf._RWD],
            termination=out[cf._TERM] > 0.5,
            truncation=out[cf._TRUNC] > 0.5,
            info={
                "collision": out[cf._COLL] > 0.5,
                "out_of_bounds": out[cf._OOB] > 0.5,
                "env_complete": out[cf._CPLT] > 0.5,
                "num_targets_reached": (b.num_targets - out[cf._REM]).round().to(torch.int32),
            },
        )
        return PackedWaypointsState(packed=out, generator=state.generator), step_out
