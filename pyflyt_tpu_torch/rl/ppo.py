"""The acting half of PPO (port of ``pyflyt_tpu/rl/ppo.py``): sampling
actions from the policy and collecting a rollout with cached auto-reset.
GAE, the truncation bootstrap and SGD belong to the training slice.

The rollout mirrors the body of ``PPO._rollout``: act → clip to the action
bounds → env step → record. ``act`` runs the policy through the fused
forward (ops/cuda_policy.py) unless ``fused=False``, in which case it uses
the module's f32 ``forward`` (``network.apply`` in the JAX package).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from pyflyt_tpu_torch.envs.base import cached_autoreset_step
from pyflyt_tpu_torch.envs.packed_hover import (
    PackedQuadXHoverEnv,
    packed_cached_autoreset_step,
)
from pyflyt_tpu_torch.ops import cuda_policy
from pyflyt_tpu_torch.rl.networks import ActorCritic, gaussian_log_prob


@dataclasses.dataclass
class Transition:
    """A rollout, each field stacked over time: (T, N, ...)."""

    obs: Tensor
    action: Tensor
    log_prob: Tensor
    value: Tensor
    reward: Tensor
    done: Tensor


def apply_policy(
    network: ActorCritic, obs: Tensor, fused: bool = True
) -> tuple[Tensor, Tensor, Tensor]:
    """(mean, log_std, value): the fused forward, or the f32 module."""
    if not fused:
        return network(obs)
    mean, value = cuda_policy.policy_value_forward(obs, network.kernel_weights())
    return mean, network.clamped_log_std().detach().expand_as(mean), value


@torch.no_grad()
def act(
    network: ActorCritic,
    obs: Tensor,
    generator: torch.Generator | None = None,
    noise: Tensor | None = None,
    fused: bool = True,
) -> tuple[Tensor, Tensor, Tensor]:
    """Samples ``(action, log_prob, value)``: ``action = mean + std·noise``,
    with ``noise`` drawn from ``generator`` unless given. The log-prob is
    that of the unclipped sample; clipping happens at the env boundary."""
    mean, log_std, value = apply_policy(network, obs, fused)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    action = mean + torch.exp(log_std) * noise
    return action, gaussian_log_prob(mean, log_std, action), value


@torch.no_grad()
def act_deterministic(network: ActorCritic, obs: Tensor, low: Tensor, high: Tensor) -> Tensor:
    """The policy mean (f32 forward), clipped to the action bounds."""
    mean, _, _ = network(obs)
    return torch.clamp(mean, low, high)


def action_bounds(env, device: torch.device) -> tuple[Tensor, Tensor]:
    low, high = env.action_bounds()
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return as_t(low), as_t(high)


@torch.no_grad()
def rollout(
    network: ActorCritic,
    env,
    ars,
    obs: Tensor,
    num_steps: int,
    generator: torch.Generator | None,
    refresh: int = 64,
    fused: bool = True,
):
    """Collects ``num_steps`` steps from a batch under cached auto-reset.

    ``ars``/``obs`` come from ``packed_autoreset_init`` (for a
    ``PackedQuadXHoverEnv``) or ``autoreset_init``; ``generator`` draws the
    action noise. Returns ``(ars, obs, Transition)``.
    """
    step_fn = (
        packed_cached_autoreset_step
        if isinstance(env, PackedQuadXHoverEnv)
        else cached_autoreset_step
    )
    low, high = action_bounds(env, obs.device)
    n = obs.shape[0]
    new = lambda *shape, dtype=torch.float32: torch.empty(  # noqa: E731
        (num_steps, n, *shape), dtype=dtype, device=obs.device
    )
    traj = Transition(
        obs=new(obs.shape[1]), action=new(low.shape[0]), log_prob=new(),
        value=new(), reward=new(), done=new(dtype=torch.bool),
    )
    for t in range(num_steps):
        action, log_prob, value = act(network, obs, generator, fused=fused)
        clipped = torch.clamp(action, low, high)
        ars, out = step_fn(env, ars, clipped, refresh)
        traj.obs[t] = obs
        traj.action[t] = action
        traj.log_prob[t] = log_prob
        traj.value[t] = value
        traj.reward[t] = out.reward
        traj.done[t] = out.termination | out.truncation
        obs = out.obs
    return ars, obs, traj
