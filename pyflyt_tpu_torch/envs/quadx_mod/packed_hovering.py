"""Packed fast path of the mod-hovering env: the physics through the generic
QuadX kernel (port of ``pyflyt_tpu/envs/quadx_mod/packed_hovering.py``).

``QuadXModHoveringEnv.step`` is one aviary step plus elementwise
observation and reward work. This env carries the drones in the kernel's
``(56, N)`` layout across steps and advances them with one launch of
``ops/cuda_quadx.packed_step`` per env step, while the rounded state16,
the reward and the flags stay plain PyTorch, computed from the kernel's
view rows with the base env's formulas. The JAX env's ``(56, 8, N/8)``
fold is dropped: any N works.

Wind: the base env draws a random ``GaussianWind`` base per env at reset.
It goes, converted to ENU, into rows 51-53, which the kernel reads and
writes through. With ``max_gust=0`` the step follows the base env to f32
rounding; gusts match in distribution (the kernel's Philox stream).

A natively batched env: ``reset(num_envs, generator)`` and
``step(state, action)`` take the whole batch, and it brings its own exact
(``autoreset_step``) and cached (``cached_autoreset_init`` /
``cached_autoreset_step``) auto-resets, which PPO uses.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import Tensor

from pyflyt_tpu_torch.envs.base import StepOut
from pyflyt_tpu_torch.envs.quadx_mod.hovering import ModHoverState, QuadXModHoveringEnv
from pyflyt_tpu_torch.ops import cuda_quadx as cq


@dataclasses.dataclass
class PackedModHoverState:
    packed: Tensor  # (56, N) drone rows; the ENU wind base in rows 51-53
    target_pos: Tensor  # (N, 3)
    target_psi: Tensor  # (N,)
    step_count: Tensor  # (N,) int32
    termination: Tensor  # (N,) bool
    truncation: Tensor  # (N,) bool
    collision: Tensor  # (N,) bool
    state16: Tensor  # (N, 16)
    generator: torch.Generator | None  # kernel seeds and the exact resets


@dataclasses.dataclass
class PackedAutoResetState:
    """The live batch and a cache of resets, refreshed every ``refresh``
    steps (``envs/base.AutoResetState`` on the packed layout)."""

    env_state: PackedModHoverState
    cache_state: PackedModHoverState
    cache_obs: Tensor
    step_idx: int
    generator: torch.Generator | None  # stream of the cache refreshes


def _select(done: Tensor, fresh: PackedModHoverState, state: PackedModHoverState) -> PackedModHoverState:
    """``fresh``'s lanes where ``done``, else ``state``'s; the live
    generator stays (it seeds the kernel for the whole batch)."""
    col = done[:, None]
    return PackedModHoverState(
        packed=torch.where(done[None, :], fresh.packed, state.packed),
        target_pos=torch.where(col, fresh.target_pos, state.target_pos),
        target_psi=torch.where(done, fresh.target_psi, state.target_psi),
        step_count=torch.where(done, fresh.step_count, state.step_count),
        termination=torch.where(done, fresh.termination, state.termination),
        truncation=torch.where(done, fresh.truncation, state.truncation),
        collision=torch.where(done, fresh.collision, state.collision),
        state16=torch.where(col, fresh.state16, state.state16),
        generator=state.generator,
    )


@dataclasses.dataclass(frozen=True)
class PackedQuadXModHoveringEnv:
    """The packed twin of ``QuadXModHoveringEnv``; ``base`` holds the task
    configuration and the device."""

    base: QuadXModHoveringEnv

    native_batch = True  # PPO: the env steps and auto-resets the batch itself
    # truncation fires only on the time limit, so PPO may take the
    # one-slot-per-rollout truncation bootstrap
    time_limit_truncation_only = True

    @classmethod
    def create(cls, **kwargs) -> "PackedQuadXModHoveringEnv":
        return cls(base=QuadXModHoveringEnv(**kwargs))

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def obs_size(self) -> int:
        return self.base.obs_size

    @property
    def action_size(self) -> int:
        return 4

    @property
    def max_steps(self) -> int:
        return self.base.max_steps

    def action_bounds(self):
        return self.base.action_bounds()

    def wind_spec(self) -> dict | None:
        """The kernel's wind: a per-env gaussian base, or none."""
        b = self.base
        if not b.simulate_wind:
            return None
        return {"kind": "gaussian", "per_env_base": True, "max_gust": float(b.max_gust_strength)}

    @functools.cached_property
    def consts(self) -> cq.GenericConsts:
        return cq.generic_consts(self.base.params, self.base.cfg, self.wind_spec())

    # ----- layout -----------------------------------------------------------
    def from_state(self, st: ModHoverState) -> PackedModHoverState:
        """A batch of the base env → the packed state (step counts and
        flags carried over)."""
        packed = cq.pack_state(st.drone)
        if self.base.simulate_wind:
            packed[cq._WBASE : cq._WBASE + 3] = st.wind.base_enu().to(packed.dtype).T
        return PackedModHoverState(
            packed=packed, target_pos=st.target_pos, target_psi=st.target_psi,
            step_count=st.step_count, termination=st.termination, truncation=st.truncation,
            collision=st.collision, state16=st.state16, generator=st.generator,
        )

    # ----- env API ----------------------------------------------------------
    def reset(
        self, num_envs: int, generator: torch.Generator | None = None
    ) -> tuple[PackedModHoverState, Tensor]:
        st, obs = self.base.reset(num_envs, generator)
        return self.from_state(st), obs

    def advance(self, state: PackedModHoverState, action: Tensor) -> Tensor:
        """The physics of one step: the denormalized action into the
        setpoint rows of a copy of the state, then one launch of the
        generic kernel. Returns the kernel's output rows."""
        packed = state.packed
        if state.generator is not None:
            seed = torch.randint(
                0, 2**31 - 1, (1,), generator=state.generator, device=packed.device, dtype=torch.int64
            )
        else:
            seed = torch.zeros(1, dtype=torch.int64, device=packed.device)
        packed = packed.clone()  # a frozen lane keeps its old setpoint
        packed[cq._SP : cq._SP + 4] = self.base.denormalize_action(action.to(packed.dtype)).T
        return cq.packed_step(packed, seed, self.consts, self.base.flight_mode, self.base.noisy_motors)

    def finish(
        self, state: PackedModHoverState, out: Tensor
    ) -> tuple[PackedModHoverState, StepOut]:
        """The task half of a step from the kernel's rows: state16, the
        reward, the flags and the done-freeze."""
        b = self.base
        done_before = state.termination | state.truncation
        contact = out[cq._ANY] > 0.5
        view = out[cq._VIEW : cq._VIEW + 12].T.reshape(-1, 4, 3)
        state16 = b.compute_state16(view, state.target_pos, state.target_psi)
        truncation = state.step_count >= b.max_steps
        reward = b.reward_of(state16, contact)
        live = ~done_before
        new_state = PackedModHoverState(
            packed=torch.where(done_before[None, :], state.packed, out),
            target_pos=state.target_pos,
            target_psi=state.target_psi,
            step_count=torch.where(done_before, state.step_count, state.step_count + 1),
            termination=state.termination | (contact & live),
            truncation=state.truncation | (truncation & live),
            collision=torch.where(done_before, state.collision, state.collision | contact),
            state16=torch.where(done_before[:, None], state.state16, state16),
            generator=state.generator,
        )
        false = torch.zeros_like(new_state.collision)
        return new_state, StepOut(
            obs=b.normalize_state16(new_state.state16),
            reward=torch.where(done_before, 0.0, reward),
            termination=new_state.termination,
            truncation=new_state.truncation,
            info={"collision": new_state.collision, "out_of_bounds": false, "env_complete": false.clone()},
        )

    def step(
        self, state: PackedModHoverState, action: Tensor
    ) -> tuple[PackedModHoverState, StepOut]:
        """One env step: one kernel launch, then the task half."""
        return self.finish(state, self.advance(state, action))

    def autoreset_step(
        self, state: PackedModHoverState, action: Tensor
    ) -> tuple[PackedModHoverState, StepOut]:
        """Exact auto-reset: finished lanes take a fresh reset (the whole
        batch is reset every step, from the state's generator); the
        pre-reset observation is ``info["terminal_observation"]``."""
        state, out = self.step(state, action)
        done = out.termination | out.truncation
        fresh, fresh_obs = self.reset(done.shape[0], state.generator)
        return _select(done, fresh, state), dataclasses.replace(
            out,
            obs=torch.where(done[:, None], fresh_obs, out.obs),
            info={**out.info, "terminal_observation": out.obs},
        )

    # ----- amortized auto-reset -------------------------------------------
    def cached_autoreset_init(
        self, num_envs: int, generator: torch.Generator | None = None
    ) -> tuple[PackedAutoResetState, Tensor]:
        """Resets the batch and fills the reset cache."""
        state, obs = self.reset(num_envs, generator)
        cache_state, cache_obs = self.reset(num_envs, generator)
        return (
            PackedAutoResetState(
                env_state=state, cache_state=cache_state, cache_obs=cache_obs,
                step_idx=0, generator=generator,
            ),
            obs,
        )

    def cached_autoreset_step(
        self, ars: PackedAutoResetState, action: Tensor, refresh: int = 64
    ) -> tuple[PackedAutoResetState, StepOut]:
        """Step with cached auto-reset: finished lanes take their cached
        reset; the whole cache regenerates every ``refresh`` steps. An env
        finishing twice in one period restarts from the same initial state
        (its trajectory still diverges through the kernel's noise)."""
        state, out = self.step(ars.env_state, action)
        done = out.termination | out.truncation
        state = _select(done, ars.cache_state, state)
        obs = torch.where(done[:, None], ars.cache_obs, out.obs)
        cache_state, cache_obs = ars.cache_state, ars.cache_obs
        if ars.step_idx % refresh == refresh - 1:
            cache_state, cache_obs = self.reset(done.shape[0], ars.generator)
        return (
            PackedAutoResetState(
                env_state=state, cache_state=cache_state, cache_obs=cache_obs,
                step_idx=ars.step_idx + 1, generator=ars.generator,
            ),
            dataclasses.replace(out, obs=obs, info={**out.info, "terminal_observation": out.obs}),
        )
