"""Self-play adapter: the packed dogfight as a natively batched 1-agent env
(port of ``pyflyt_tpu/envs/selfplay_dogfight.py``).

Both drones of every arena are rows of one flat agent batch driven by the
same policy, so the standard single-agent PPO trains the dogfight by
self-play. ``B = 2N`` rows over ``N`` arenas, arena-major: row ``2a + m``
is drone ``m`` of arena ``a``, which is also the packed layout's column
order, so the flat view is a reshape.

- ``reset(num_rows, generator)`` spawns ``num_rows // 2`` arenas and
  returns the ``(B, 30)`` observation block.
- ``step(state, actions (B, A))`` runs the one-launch arena step and
  reports per-row flags: a row terminates on its own end (collision,
  out-of-dome, or the other-dead rule) and truncates on the time limit or
  when its PARTNER's row is done: the survivor's episode is cut short
  through no terminal state of its own, the bootstrap case.
- ``autoreset_step`` resets a whole arena as soon as either row is done;
  ``cached_autoreset_init``/``cached_autoreset_step`` substitute a cached
  spawn pool refreshed every ``refresh`` steps, at the arena level.

PPO notes, as in the JAX module: ``PPOConfig(slot_bootstrap=False)``, since
arenas end and reset several times inside one rollout.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from pyflyt_tpu_torch.envs.base import StepOut
from pyflyt_tpu_torch.envs.packed_dogfight import PackedDogfightEnvState, PackedMAFixedwingDogfightEnv


@dataclasses.dataclass
class SelfPlayState:
    inner: PackedDogfightEnvState
    generator: torch.Generator | None  # the exact auto-reset's spawns


@dataclasses.dataclass
class SelfPlayAutoResetState:
    """Carry of the amortized (cached) arena-reset path."""

    env_state: SelfPlayState
    cache_inner: PackedDogfightEnvState
    cache_obs: Tensor  # (N, 2, obs)
    step_idx: int
    generator: torch.Generator | None  # the pool refreshes' spawns


@dataclasses.dataclass(frozen=True)
class SelfPlayDogfightEnv:
    """Flat-batch self-play view over ``PackedMAFixedwingDogfightEnv``."""

    penv: PackedMAFixedwingDogfightEnv = dataclasses.field(default_factory=PackedMAFixedwingDogfightEnv)

    native_batch = True
    # partner death truncates a row at any step, arbitrarily often per
    # rollout: PPO's slot bootstrap must stay off (rl/ppo.py _use_slot)
    time_limit_truncation_only = False

    @property
    def base(self):
        return self.penv.base

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def max_steps(self) -> int:
        return self.base.max_steps

    @property
    def obs_size(self) -> int:
        return self.base.obs_size

    @property
    def action_size(self) -> int:
        return self.base.action_size

    def action_bounds(self):
        return self.base.action_bounds()

    # ------------------------------------------------------------------ api
    def reset(self, num_rows: int, generator: torch.Generator | None = None) -> tuple[SelfPlayState, Tensor]:
        """``num_rows = 2N`` agent rows: ``N`` fresh arenas."""
        if num_rows % 2:
            raise ValueError(f"self-play needs an even number of rows (2 per arena), got {num_rows}")
        inner, obs = self.penv.reset(num_rows // 2, generator)
        return SelfPlayState(inner=inner, generator=generator), obs.reshape(num_rows, -1)

    @staticmethod
    def _flat(x: Tensor) -> Tensor:  # (N, 2, ...) -> (B, ...)
        return x.reshape((x.shape[0] * 2,) + tuple(x.shape[2:]))

    def step(self, state: SelfPlayState, actions: Tensor) -> tuple[SelfPlayState, StepOut]:
        """Plain step (no arena reset), per-row flags as documented above."""
        b = actions.shape[0]
        inner, out = self.penv.step(state.inner, actions.reshape(b // 2, 2, -1))
        own_done = out.termination | out.truncation  # (N, 2)
        match_done = own_done.any(dim=1, keepdim=True)
        truncation = out.truncation | (match_done & ~own_done)
        own_health = out.info["healths"][:, 0, :]  # (N, 2): row i keeps its own
        return SelfPlayState(inner=inner, generator=state.generator), StepOut(
            obs=self._flat(out.obs),
            reward=self._flat(out.reward),
            termination=self._flat(out.termination),
            truncation=self._flat(truncation),
            info={"health": self._flat(own_health)},
        )

    @staticmethod
    def _splice(inner: PackedDogfightEnvState, reset_inner: PackedDogfightEnvState,
                match_done: Tensor) -> PackedDogfightEnvState:
        """Done arenas take ``reset_inner``'s entries (both columns of the
        arena); the live generator stays."""
        m = match_done[:, None]
        return PackedDogfightEnvState(
            packed=torch.where(match_done.repeat_interleave(2)[None, :], reset_inner.packed, inner.packed),
            generator=inner.generator,
            alive=torch.where(m, reset_inner.alive, inner.alive),
            current_actions=torch.where(m[..., None], reset_inner.current_actions, inner.current_actions),
            past_actions=torch.where(m[..., None], reset_inner.past_actions, inner.past_actions),
        )

    def _finish(self, out: StepOut, match_done: Tensor, obs_pairs: Tensor) -> StepOut:
        n = match_done.shape[0]
        obs = torch.where(match_done[:, None, None], obs_pairs, out.obs.reshape(n, 2, -1)).reshape(2 * n, -1)
        return dataclasses.replace(out, obs=obs, info={**out.info, "terminal_observation": out.obs})

    def autoreset_step(self, state: SelfPlayState, actions: Tensor) -> tuple[SelfPlayState, StepOut]:
        """Step + arena-level exact auto-reset: a fresh spawn for every
        arena, drawn from the state's generator, taken where either row is
        done; the pre-reset observations surface as
        ``terminal_observation``."""
        n = actions.shape[0] // 2
        new_state, out = self.step(state, actions)
        match_done = (out.termination | out.truncation).reshape(n, 2).any(dim=1)
        reset_inner, reset_obs = self.penv.reset(n, state.generator)
        merged = self._splice(new_state.inner, reset_inner, match_done)
        return SelfPlayState(inner=merged, generator=state.generator), self._finish(out, match_done, reset_obs)

    # ---- amortized auto-reset (envs/base cached semantics, arena-level) ----
    def cached_autoreset_init(
        self, num_rows: int, generator: torch.Generator | None = None
    ) -> tuple[SelfPlayAutoResetState, Tensor]:
        """Resets the batch and fills a spawn pool of one arena per arena:
        done arenas take their pooled spawn instead of a fresh reset; the
        pool regenerates every ``refresh`` steps."""
        state, obs = self.reset(num_rows, generator)
        cache_inner, cache_obs = self.penv.reset(num_rows // 2, generator)
        return SelfPlayAutoResetState(
            env_state=state, cache_inner=cache_inner, cache_obs=cache_obs, step_idx=0, generator=generator,
        ), obs

    def cached_autoreset_step(
        self, ars: SelfPlayAutoResetState, actions: Tensor, refresh: int = 64
    ) -> tuple[SelfPlayAutoResetState, StepOut]:
        n = actions.shape[0] // 2
        state, out = self.step(ars.env_state, actions)
        match_done = (out.termination | out.truncation).reshape(n, 2).any(dim=1)
        merged = self._splice(state.inner, ars.cache_inner, match_done)
        out = self._finish(out, match_done, ars.cache_obs)
        cache_inner, cache_obs = ars.cache_inner, ars.cache_obs
        if ars.step_idx % refresh == refresh - 1:
            cache_inner, cache_obs = self.penv.reset(n, ars.generator)
        return SelfPlayAutoResetState(
            env_state=SelfPlayState(inner=merged, generator=state.generator), cache_inner=cache_inner,
            cache_obs=cache_obs, step_idx=ars.step_idx + 1, generator=ars.generator,
        ), out
