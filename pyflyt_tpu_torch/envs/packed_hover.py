"""Packed-state QuadX Hover env: the whole agent step is one kernel (port
of ``pyflyt_tpu/envs/packed_hover.py``).

The batch state lives permanently in the kernel's ``(ROWS, N)`` layout
(ops/cuda_quadx.py). ``step`` writes the action into the setpoint rows,
launches the fused hover step (``env_step_ratio`` aviary steps plus
reward, termination, truncation and the done-freeze) and assembles the
observation from packed rows. Reset goes through the plain
``QuadXHoverEnv`` path (10 stabilization steps) and packs its result.

Semantics match ``QuadXHoverEnv`` with noise off, apart from the
detection-grade contact, which only differs after a termination.
Envelope: modes 0, 7 and 8, ENU, quaternion or euler observations, dense
or sparse reward. In mode 7 the action is a position setpoint ``[x, y,
yaw, z]`` written into the setpoint rows as any action is, and the state
has 80 rows: the position cascade's five PID banks in rows 56-73
(``cuda_quadx.rows_for``). It auto-resets through its reset cache only: like the JAX
package's, it has no exact ``autoreset_step``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import Tensor

from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.envs.base import StepOut
from pyflyt_tpu_torch.envs.quadx_base import QuadXEnvState
from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
from pyflyt_tpu_torch.ops import cuda_quadx as cq


@dataclasses.dataclass
class PackedHoverState:
    packed: Tensor  # (rows_for(mode), N): drone rows 0-49, env rows 50-55, mode 7's cascade 56-73
    generator: torch.Generator | None  # draws each step's kernel seed


@dataclasses.dataclass(frozen=True)
class PackedQuadXHoverEnv:
    """Batch-level env on the packed layout; ``base`` holds the task
    configuration and the device."""

    base: QuadXHoverEnv = dataclasses.field(default_factory=QuadXHoverEnv)
    # steps the whole batch itself; PPO then takes the in-scan truncation
    # bootstrap, as the JAX package does for a natively batched env
    native_batch = True

    def __post_init__(self):
        if self.base.flight_mode not in cq.HOVER_MODES:
            raise NotImplementedError(
                f"the packed hover env covers modes 0, 7 and 8, not {self.base.flight_mode}"
            )
        if self.base.orn_conv != "ENU_FLU":
            raise NotImplementedError("the packed hover env is ENU only")

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def obs_size(self) -> int:
        return self.base.obs_size

    @property
    def max_steps(self) -> int:
        return self.base.max_steps

    @property
    def action_size(self) -> int:
        return 4

    def action_bounds(self):
        return self.base.action_bounds()

    @functools.cached_property
    def consts(self) -> cq.HoverConsts:
        b = self.base
        return cq.hover_consts(
            b.params, b.cfg, inner_steps=b.env_step_ratio,
            dome=b.flight_dome_size, max_steps=b.max_steps,
        )

    # ----- layout conversions ---------------------------------------------
    def pack_env_state(self, st: QuadXEnvState) -> Tensor:
        """Batched ``QuadXEnvState`` → packed ``(rows_for(mode), N)``."""
        packed = cq.pack_state(st.drone, self.base.flight_mode)
        env_rows = torch.stack([
            st.reward, st.termination, st.truncation, st.collision,
            st.out_of_bounds, st.step_count,
        ]).to(torch.float32)
        packed[cq._RWD : cq._STEP + 1] = env_rows
        return packed

    def unpack_env_state(self, packed: Tensor, template: QuadXEnvState) -> QuadXEnvState:
        """Packed ``(rows_for(mode), N)`` → batched ``QuadXEnvState``."""
        return dataclasses.replace(
            template,
            drone=cq.unpack_state(packed, template.drone),
            reward=packed[cq._RWD],
            termination=packed[cq._TERM] > 0.5,
            truncation=packed[cq._TRUNC] > 0.5,
            collision=packed[cq._COLL] > 0.5,
            out_of_bounds=packed[cq._OOB] > 0.5,
            step_count=packed[cq._STEP].to(torch.int32),
            action=packed[cq._SP : cq._SP + 4].T,
        )

    def _obs(self, packed: Tensor) -> Tensor:
        """attitude_obs from packed rows."""
        rows = lambda r, k: packed[r : r + k].T  # noqa: E731
        euler = rows(cq._VIEW + 3, 3)
        att = pm.euler_to_quat(euler) if self.base.angle_representation == "quaternion" else euler
        return torch.cat([
            rows(cq._VIEW, 3), att, rows(cq._VIEW + 6, 3), rows(cq._VIEW + 9, 3),
            rows(cq._SP, 4), rows(cq._THR, 4),
        ], dim=-1)

    # ----- env API ----------------------------------------------------------
    def reset(
        self, num_envs: int, generator: torch.Generator | None = None
    ) -> tuple[PackedHoverState, Tensor]:
        st, obs = self.base.reset(num_envs, generator)
        return PackedHoverState(packed=self.pack_env_state(st), generator=generator), obs

    def step(
        self, state: PackedHoverState, action: Tensor
    ) -> tuple[PackedHoverState, StepOut]:
        """One agent step. The action is written into the state's setpoint
        rows in place; the kernel returns the next state as a new tensor."""
        b = self.base
        packed = state.packed
        if b.noisy_motors:
            seed = torch.randint(
                0, 2**31 - 1, (1,), generator=state.generator, device=packed.device,
                dtype=torch.int64,
            )
        else:
            seed = torch.zeros(1, dtype=torch.int64, device=packed.device)
        packed[cq._SP : cq._SP + 4] = action.to(packed.dtype).T
        out = cq.packed_hover_step(
            packed, seed, self.consts, mode=b.flight_mode, noisy=b.noisy_motors,
            sparse=b.sparse_reward,
        )
        step_out = StepOut(
            obs=self._obs(out),
            reward=out[cq._RWD],
            termination=out[cq._TERM] > 0.5,
            truncation=out[cq._TRUNC] > 0.5,
            info={
                "collision": out[cq._COLL] > 0.5,
                "out_of_bounds": out[cq._OOB] > 0.5,
                "env_complete": torch.zeros_like(out[cq._COLL], dtype=torch.bool),
            },
        )
        return PackedHoverState(packed=out, generator=state.generator), step_out

    # ----- auto-reset (PPO dispatches on these methods) ---------------------
    def cached_autoreset_init(
        self, num_envs: int, generator: torch.Generator | None = None
    ) -> tuple["PackedAutoResetState", Tensor]:
        return packed_autoreset_init(self, num_envs, generator)

    def cached_autoreset_step(
        self, ars: "PackedAutoResetState", action: Tensor, refresh: int = 64
    ) -> tuple["PackedAutoResetState", StepOut]:
        return packed_cached_autoreset_step(self, ars, action, refresh)


# ---------------------------------------------------------------------------
# cached auto-reset on the packed layout (mirrors envs/base.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackedAutoResetState:
    env_state: PackedHoverState
    cache_packed: Tensor
    cache_obs: Tensor
    step_idx: int
    generator: torch.Generator | None  # stream for the cache refreshes


def packed_autoreset_init(
    env: PackedQuadXHoverEnv, num_envs: int, generator: torch.Generator | None = None
) -> tuple[PackedAutoResetState, Tensor]:
    state, obs = env.reset(num_envs, generator)
    cache_state, cache_obs = env.reset(num_envs, generator)
    return (
        PackedAutoResetState(
            env_state=state, cache_packed=cache_state.packed, cache_obs=cache_obs,
            step_idx=0, generator=generator,
        ),
        obs,
    )


def packed_cached_autoreset_step(
    env: PackedQuadXHoverEnv,
    ars: PackedAutoResetState,
    action: Tensor,
    refresh: int = 64,
) -> tuple[PackedAutoResetState, StepOut]:
    """``cached_autoreset_step`` on the packed layout: finished lanes take
    their cached packed column; the cache regenerates every ``refresh``
    steps."""
    state, out = env.step(ars.env_state, action)
    done = out.termination | out.truncation
    packed = torch.where(done[None, :], ars.cache_packed, state.packed)
    obs = torch.where(done[:, None], ars.cache_obs, out.obs)

    cache_packed, cache_obs = ars.cache_packed, ars.cache_obs
    if ars.step_idx % refresh == refresh - 1:
        st, cache_obs = env.reset(done.shape[0], ars.generator)
        cache_packed = st.packed
    return (
        PackedAutoResetState(
            env_state=PackedHoverState(packed=packed, generator=state.generator),
            cache_packed=cache_packed, cache_obs=cache_obs,
            step_idx=ars.step_idx + 1, generator=ars.generator,
        ),
        dataclasses.replace(
            out, obs=obs, info={**out.info, "terminal_observation": out.obs}
        ),
    )
