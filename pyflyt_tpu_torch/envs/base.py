"""Batched environment protocol and auto-reset helpers (port of
``pyflyt_tpu/envs/base.py``).

Envs here are batched by construction: ``reset(num_envs, generator)``
builds the whole batch and ``step(state, action)`` steps it, where the JAX
package ``vmap``s a single-instance env. A batch's random stream is one
``torch.Generator`` carried in its state, where the JAX package carries a
PRNG key per instance.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Protocol

import torch
from torch import Tensor

from pyflyt_tpu_torch.core.state import tree_map


@dataclasses.dataclass
class StepOut:
    """Transition outputs, batched like the state."""

    obs: Any
    reward: Tensor
    termination: Tensor
    truncation: Tensor
    info: dict[str, Tensor]


class BatchedEnv(Protocol):
    def reset(
        self, num_envs: int, generator: torch.Generator | None
    ) -> tuple[Any, Tensor]: ...

    def step(self, state: Any, action: Tensor) -> tuple[Any, StepOut]: ...


def tree_select(mask: Tensor, on_true: Any, on_false: Any) -> Any:
    """Batched ``where`` over matching dataclasses (``mask`` has the batch
    shape and broadcasts over trailing dims). Non-tensor leaves, such as
    the batch's generator, come from ``on_false``."""

    def pick(f: Tensor, t: Tensor) -> Tensor:
        m = mask.reshape(mask.shape + (1,) * (f.dim() - mask.dim()))
        return torch.where(m, t, f)

    return tree_map(pick, on_false, on_true)


# ---------------------------------------------------------------------------
# the agent-step loop of the single-vehicle task envs
# ---------------------------------------------------------------------------


class AviaryTaskEnv:
    """The agent-step loop and base termination that the QuadX and Fixedwing
    task envs share (``base_step`` and ``base_term_trunc_reward`` of the
    JAX package's quadx_base.py and fixedwing_base.py). A subclass gives
    ``aviary_step(drone, generator) -> (drone, contact)``, ``cfg.dtype``,
    ``env_step_ratio``, ``max_steps`` and ``flight_dome_size``; its state
    has the fields of ``QuadXEnvState``."""

    def base_term_trunc_reward(self, state: Any, contact: Tensor) -> Any:
        """Collision or leaving the dome: reward −100 and termination;
        step-count truncation (on the count before this agent step's
        increment)."""
        truncation = state.truncation | (state.step_count > self.max_steps)
        lin_pos = state.drone.read.view[..., 3, :]
        oob = torch.linalg.vector_norm(lin_pos, dim=-1) > self.flight_dome_size
        fatal = contact | oob
        return dataclasses.replace(
            state,
            truncation=truncation,
            termination=state.termination | fatal,
            reward=torch.where(fatal, -100.0, state.reward),
            collision=state.collision | contact,
            out_of_bounds=state.out_of_bounds | oob,
        )

    def base_step(
        self,
        state: Any,
        action: Tensor,
        task_update: Callable[[Any, Tensor], Any],
        obs_fn: Callable[[Any], Any],
        extra_info: Callable[[Any], dict[str, Any]] | None = None,
    ) -> tuple[Any, StepOut]:
        """One agent step: the action becomes the setpoint, the reward is
        re-armed to −0.1, then ``env_step_ratio`` aviary steps each followed
        by ``task_update(state, contact)``, with the done-freeze; the step
        count increments after the loop. ``extra_info(state)`` adds task
        entries to the info."""
        action = action.to(self.cfg.dtype)
        state = dataclasses.replace(
            state,
            action=action,
            reward=torch.full_like(state.reward, -0.1),
            drone=dataclasses.replace(state.drone, setpoint=action),
        )
        for _ in range(self.env_step_ratio):
            done_before = state.termination | state.truncation
            drone, contact = self.aviary_step(state.drone, state.generator)
            new_state = task_update(dataclasses.replace(state, drone=drone), contact)
            state = tree_select(done_before, state, new_state)  # the done-freeze
        state = dataclasses.replace(state, step_count=state.step_count + 1)
        out = StepOut(
            obs=obs_fn(state),
            reward=state.reward,
            termination=state.termination,
            truncation=state.truncation,
            info={
                "collision": state.collision,
                "out_of_bounds": state.out_of_bounds,
                "env_complete": state.env_complete,
                **(extra_info(state) if extra_info is not None else {}),
            },
        )
        return state, out


# ---------------------------------------------------------------------------
# exact auto-reset
# ---------------------------------------------------------------------------


def autoreset_step(env: BatchedEnv, state: Any, action: Tensor) -> tuple[Any, StepOut]:
    """Batched step with exact auto-reset: finished envs take a fresh
    reset, drawn every step for the whole batch from the stepped state's
    generator (``state.generator``; None where the env's reset draws
    nothing). ``StepOut`` describes the finished transition, with the next
    episode's first obs in ``obs`` and the pre-reset obs in
    ``info["terminal_observation"]``.

    The whole batch is reset every step, as the JAX package's vmap does;
    ``cached_autoreset_step`` amortizes that. No ``_unalias`` is needed
    here: PyTorch does not donate buffers.
    """
    state, out = env.step(state, action)
    done = out.termination | out.truncation
    reset_state, reset_obs = env.reset(done.shape[0], getattr(state, "generator", None))
    state = tree_select(done, reset_state, state)
    obs = tree_select(done, reset_obs, out.obs)  # a tensor or a dict of them
    return state, dataclasses.replace(
        out, obs=obs, info={**out.info, "terminal_observation": out.obs}
    )


# ---------------------------------------------------------------------------
# amortized auto-reset
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AutoResetState:
    """Env batch plus a per-env cache of reset states.

    The whole cache is rebuilt once every ``refresh`` steps, and finished
    envs take their cached entry in between. Each cached reset is drawn
    independently of the episode's outcome, so the reset distribution is
    that of the exact path.
    """

    env_state: Any
    cache_state: Any
    cache_obs: Any  # a tensor or a dict of them
    step_idx: int
    generator: torch.Generator | None  # stream for the cache refreshes


def autoreset_init(
    env: BatchedEnv, num_envs: int, generator: torch.Generator | None
) -> tuple[AutoResetState, Tensor]:
    """Resets the batch and fills the reset cache."""
    state, obs = env.reset(num_envs, generator)
    cache_state, cache_obs = env.reset(num_envs, generator)
    return (
        AutoResetState(
            env_state=state, cache_state=cache_state, cache_obs=cache_obs,
            step_idx=0, generator=generator,
        ),
        obs,
    )


def cached_autoreset_step(
    env: BatchedEnv, ars: AutoResetState, action: Tensor, refresh: int = 64
) -> tuple[AutoResetState, StepOut]:
    """Batched step with cached auto-reset: finished envs substitute their
    cached reset; the whole cache regenerates every ``refresh`` steps.
    ``StepOut`` describes the finished transition, with the next episode's
    first obs in ``obs`` and the pre-reset obs in
    ``info["terminal_observation"]``."""
    state, out = env.step(ars.env_state, action)
    done = out.termination | out.truncation
    state = tree_select(done, ars.cache_state, state)
    obs = tree_select(done, ars.cache_obs, out.obs)

    cache_state, cache_obs = ars.cache_state, ars.cache_obs
    if ars.step_idx % refresh == refresh - 1:
        cache_state, cache_obs = env.reset(done.shape[0], ars.generator)
    ars = AutoResetState(
        env_state=state, cache_state=cache_state, cache_obs=cache_obs,
        step_idx=ars.step_idx + 1, generator=ars.generator,
    )
    return ars, dataclasses.replace(
        out, obs=obs, info={**out.info, "terminal_observation": out.obs}
    )
