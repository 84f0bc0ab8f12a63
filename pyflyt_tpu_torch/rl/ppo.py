"""PPO on batched on-device environments (port of ``pyflyt_tpu/rl/ppo.py``).

One iteration is rollout → GAE → epochs × minibatch SGD, as in the JAX
package, run eagerly: PyTorch has no jitted scan to lean on, so the scans
are Python loops and the hot pieces are the port's kernels.

- The rollout acts through the fused forward (K4, ``ops/cuda_policy.py``)
  when ``fused_rollout_forward`` is set, else through the f32 module.
- ``fused_sgd=True`` rewrites the stored old log-probs with K3 and runs
  each epoch as one call of K2 (``ops/cuda_sgd.py``), with the Pallas
  kernels' bf16-input arithmetic. The default path is autograd on the f32
  ``ActorCritic`` with optax's ``clip_by_global_norm`` and Adam written
  out, the exact-semantics path, as the XLA scan is in the JAX package.

Dict observations (the waypoints and gates envs) are flattened in
sorted-key order (``_flat_obs``, ``ppo.py:224-230``), a uint8 image
promoted to f32, wherever PPO takes an observation: the batch it starts
from, every rollout step, the truncation bootstrap's terminal observation
and ``evaluate``.

``PPO(env, config, network=...)`` takes another policy module in place of
``ActorCritic`` (``VisionActorCritic`` for the gates env), as the JAX
``PPO`` does: it keeps the ``(mean, log_std, value)`` contract, has
``value(obs)``, ``clamped_log_std()`` and ``reset_parameters(generator)``,
and trains on the default f32 path only (the fused kernels implement the
``ActorCritic`` MLP). Clip and Adam then run over its parameters as they
are.

Differences from the JAX package, by design: a ``torch.Generator`` in the
runner draws the action noise and the epoch permutations (threefry and
Philox give other numbers from one seed); the network's parameters are
updated in place, so ``train_iteration`` returns the runner it was given;
Adam's moments are kept per leaf (``AdamState``) on both paths, where the
JAX default path keeps them as one ``optax.flatten`` vector
(``convert.adam_state_from_optax`` reads both).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch
from torch import Tensor

from pyflyt_tpu_torch.envs.base import autoreset_init, autoreset_step, cached_autoreset_step
from pyflyt_tpu_torch.ops import cuda_policy, cuda_sgd
from pyflyt_tpu_torch.rl.networks import ActorCritic, gaussian_entropy, gaussian_log_prob


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The JAX ``PPOConfig``'s fields and defaults (SB3's PPO defaults with
    the reference's batch sizing), but for the two that only size TPU
    blocks (``fused_sgd_chunk``, ``fused_rollout_chunk``): the CUDA kernels
    tile their rows themselves.

    ``compute_dtype`` other than ``"float32"`` raises ``NotImplementedError``
    (ROADMAP.md, open item 25). ``cached_reset_refresh=0`` (the default)
    auto-resets exactly, through the env's own ``autoreset_step`` or
    ``envs/base.autoreset_step``; an env without an exact path raises.
    """

    num_envs: int = 1024
    rollout_steps: int = 32
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.0
    value_coef: float = 0.5
    max_grad_norm: float = 0.5
    num_epochs: int = 15
    num_minibatches: int = 32
    feature_sizes: tuple = (256, 256)
    pi_sizes: tuple = ()
    vf_sizes: tuple = ()
    init_log_std: float = 0.0
    log_std_range: tuple | None = None
    cached_reset_refresh: int = 0
    compute_dtype: str = "float32"
    fused_sgd: bool = False
    fused_sgd_consistent_logp: bool = True
    fused_rollout_forward: bool = False
    slot_bootstrap: bool | None = None
    shuffle_block: int = 16
    shuffle_block_auto: bool = True

    @property
    def batch_size(self) -> int:
        return self.num_envs * self.rollout_steps

    @property
    def minibatch_size(self) -> int:
        return self.batch_size // self.num_minibatches


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState`` per leaf: ``count`` is an int32 scalar
    tensor, ``mu``/``nu`` follow ``cuda_sgd.leaf_specs``."""

    count: Tensor
    mu: list[Tensor]
    nu: list[Tensor]

    @classmethod
    def zeros(cls, network: torch.nn.Module) -> "AdamState":
        leaves = optimizer_leaves(network)
        z = [torch.zeros_like(t, memory_format=torch.contiguous_format).detach() for t in leaves]
        return cls(
            count=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
            mu=z, nu=[torch.zeros_like(t) for t in z],
        )


def optimizer_leaves(network: torch.nn.Module) -> list[Tensor]:
    """The tensors clip and Adam run over: ``ActorCritic``'s in the leaf
    layout of ``cuda_sgd.leaf_specs`` (views of its parameters), any other
    module's parameters as they are."""
    if isinstance(network, ActorCritic):
        return cuda_sgd.params_to_leaves(network)
    return list(network.parameters())


@dataclasses.dataclass
class RunnerState:
    network: torch.nn.Module
    opt_state: AdamState
    env_state: Any
    obs: Tensor  # (num_envs, obs_dim)
    generator: torch.Generator  # action noise and epoch permutations
    update_idx: int


@dataclasses.dataclass
class Transition:
    """A rollout, each field stacked over time: (T, N, ...)."""

    obs: Tensor
    action: Tensor
    log_prob: Tensor
    value: Tensor
    reward: Tensor
    done: Tensor


# ---------------------------------------------------------------------------
# acting
# ---------------------------------------------------------------------------


def _flat_obs(obs) -> Tensor:
    """Dict observations are flattened (sorted keys) for the MLP policy."""
    if isinstance(obs, dict):
        return torch.cat([obs[k].reshape(obs[k].shape[0], -1) for k in sorted(obs)], dim=-1)
    return obs


def obs_width(env) -> int:
    """The width of the policy's input: ``flat_obs_size`` where the env
    has a dict observation, else ``obs_size``."""
    return getattr(env, "flat_obs_size", env.obs_size)


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


def env_init(env, num_envs: int, generator: torch.Generator | None, refresh: int):
    """The batch a rollout starts from and its flat observation
    (``ppo.py:307-326``): a natively batched env resets itself
    (``cached_autoreset_init`` when ``refresh > 0``); any other env through
    ``envs/base`` (``autoreset_init`` when ``refresh > 0``)."""
    if getattr(env, "native_batch", False):
        if refresh > 0:
            ars, obs = env.cached_autoreset_init(num_envs, generator)
        else:
            ars, obs = env.reset(num_envs, generator)
    elif refresh > 0:
        ars, obs = autoreset_init(env, num_envs, generator)
    else:
        ars, obs = env.reset(num_envs, generator)
    return ars, _flat_obs(obs)


def env_step(env, ars, action: Tensor, refresh: int):
    """One batch step with auto-reset (``ppo.py:379-391``): a natively
    batched env's own ``cached_autoreset_step`` (``refresh > 0``) or exact
    ``autoreset_step``; any other env through ``envs/base``."""
    if getattr(env, "native_batch", False):
        if refresh > 0:
            return env.cached_autoreset_step(ars, action, refresh)
        return env.autoreset_step(ars, action)
    if refresh > 0:
        return cached_autoreset_step(env, ars, action, refresh)
    return autoreset_step(env, ars, action)


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
    gamma: float | None = None,
    slot: bool = False,
):
    """Collects ``num_steps`` steps from a batch under auto-reset
    (``env_step``: cached when ``refresh > 0``, else exact).

    ``ars``/``obs`` come from ``env_init`` with the same ``refresh`` (a
    dict observation is flattened, ``_flat_obs``);
    ``generator`` draws the action noise. With ``gamma`` set, a step truncated but not terminated
    gets ``gamma·V(terminal_obs)`` added to its reward (SB3's time-limit
    bootstrap, f32 critic): at every step (``slot=False``), or once after
    the loop from one stored (obs, step) slot per env (``slot=True``, exact
    only where an env truncates at most once per rollout). Returns
    ``(ars, obs, Transition)``.
    """
    low, high = action_bounds(env, obs.device)
    n = obs.shape[0]
    new = lambda *shape, dtype=torch.float32: torch.empty(  # noqa: E731
        (num_steps, n, *shape), dtype=dtype, device=obs.device
    )
    traj = Transition(
        obs=new(obs.shape[1]), action=new(low.shape[0]), log_prob=new(),
        value=new(), reward=new(), done=new(dtype=torch.bool),
    )
    if gamma is not None and slot:
        slot_obs = torch.zeros_like(obs)
        slot_t = torch.zeros((n,), dtype=torch.long, device=obs.device)
        slot_has = torch.zeros((n,), dtype=torch.bool, device=obs.device)
    for t in range(num_steps):
        action, log_prob, value = act(network, obs, generator, fused=fused)
        clipped = torch.clamp(action, low, high)
        ars, out = env_step(env, ars, clipped, refresh)
        reward = out.reward
        if gamma is not None:
            term_obs = _flat_obs(out.info["terminal_observation"])
            trunc_only = out.truncation & ~out.termination
            if slot:
                slot_obs = torch.where(trunc_only[:, None], term_obs, slot_obs)
                slot_t = torch.where(trunc_only, t, slot_t)
                slot_has = slot_has | trunc_only
            else:
                reward = reward + gamma * network.value(term_obs) * trunc_only
        traj.obs[t] = obs
        traj.action[t] = action
        traj.log_prob[t] = log_prob
        traj.value[t] = value
        traj.reward[t] = reward
        traj.done[t] = out.termination | out.truncation
        obs = _flat_obs(out.obs)
    if gamma is not None and slot:
        adj = gamma * network.value(slot_obs) * slot_has
        traj.reward.index_put_((slot_t, torch.arange(n, device=obs.device)), adj, accumulate=True)
    return ars, obs, traj


# ---------------------------------------------------------------------------
# the learner's pieces
# ---------------------------------------------------------------------------


def shuffle_block_size(cfg: PPOConfig) -> int:
    """The effective block of the epoch shuffle (``ppo.py:593-604``): the
    largest divisor of the minibatch size not above the target, which grows
    with the batch under ``shuffle_block_auto``."""
    if int(cfg.shuffle_block) < 1:
        raise ValueError(
            f"shuffle_block must be >= 1, got {cfg.shuffle_block} (1 = exact per-sample permutation)"
        )
    target = int(cfg.shuffle_block)
    if cfg.shuffle_block_auto:
        target = max(target, cfg.batch_size // 8192)
    return max(d for d in range(1, target + 1) if cfg.minibatch_size % d == 0)


def shuffle_gather(packed: Tensor, perm: Tensor, blk: int, num_minibatches: int) -> Tensor:
    """Block-permutes the packed (batch, feat) buffer into
    (num_minibatches, minibatch_size, feat) minibatches: one row gather of
    whole blocks (the JAX package's 128-lane view is a TPU layout trick
    with the same result)."""
    batch, feat = packed.shape
    g = packed.reshape(batch // blk, blk * feat).index_select(0, perm)
    return g.reshape(num_minibatches, batch // num_minibatches, feat)


def clip_by_global_norm(grads: list[Tensor], max_norm: float) -> list[Tensor]:
    """optax's rule: keep ``g`` while its global norm is below ``max_norm``,
    else ``(g / norm) * max_norm`` (``torch.nn.utils.clip_grad_norm_``
    divides by ``norm + 1e-6`` instead)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


def adam_update(
    leaves: list[Tensor], grads: list[Tensor], state: AdamState, lr: float
) -> AdamState:
    """``optax.adam(lr, eps=1e-5)`` on leaves, in place on ``leaves``;
    returns the new state."""
    count = state.count + 1
    t = count.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(cuda_sgd.B1, dtype=torch.float32, device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(cuda_sgd.B2, dtype=torch.float32, device=t.device), t)
    mu, nu = [], []
    with torch.no_grad():
        for p, g, m, v in zip(leaves, grads, state.mu, state.nu):
            m = (1.0 - cuda_sgd.B1) * g + cuda_sgd.B1 * m
            v = (1.0 - cuda_sgd.B2) * (g * g) + cuda_sgd.B2 * v
            upd = (m / c1) / (torch.sqrt(v / c2) + cuda_sgd.ADAM_EPS)
            p.add_(-lr * upd)
            mu.append(m)
            nu.append(v)
    return AdamState(count=count, mu=mu, nu=nu)


def _leaf_parameters(network: ActorCritic) -> list[torch.nn.Parameter]:
    """The parameters in ``leaf_specs`` order."""
    out = []
    for lin in network.pi_trunk.layers:
        out += [lin.weight, lin.bias]
    out += [network.pi_head.weight, network.pi_head.bias, network.log_std]
    for lin in network.vf_trunk.layers:
        out += [lin.weight, lin.bias]
    out += [network.vf_head.weight, network.vf_head.bias]
    return out


def _as_leaf(param: Tensor, g: Tensor) -> Tensor:
    """A parameter's gradient in leaf layout: (in, out) weights, (1, n) rows."""
    return g.T if g.dim() == 2 else g[None, :]


class PPO:
    """PPO trainer bound to one env and config."""

    def __init__(self, env, config: PPOConfig = PPOConfig(), mesh=None, network: torch.nn.Module | None = None):
        """``network``: a policy module in place of ``ActorCritic`` (see the
        module note); ``init`` trains a copy of it, re-initialised from its
        seed."""
        if network is not None and (config.fused_sgd or config.fused_rollout_forward):
            raise ValueError(
                "fused_sgd / fused_rollout_forward implement the stock ActorCritic MLP; "
                f"train a custom network ({type(network).__name__}) on the default f32 path"
            )
        if mesh is not None:
            raise NotImplementedError("PPO on a device mesh: ROADMAP.md, open item 24 (parallel/mesh)")
        if config.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={config.compute_dtype!r}: ROADMAP.md, open item 25 (bf16 compute_dtype)"
            )
        native = getattr(env, "native_batch", False)
        if native and config.cached_reset_refresh <= 0 and not hasattr(env, "autoreset_step"):
            raise NotImplementedError(
                f"{type(env).__name__} has no exact autoreset_step (nor has its JAX "
                "counterpart): set cached_reset_refresh > 0 (ROADMAP.md, item 7)"
            )
        if native and config.cached_reset_refresh > 0 and not hasattr(env, "cached_autoreset_init"):
            raise ValueError(
                f"{type(env).__name__} has no cached auto-reset; set cached_reset_refresh=0"
            )
        if (config.fused_sgd or config.fused_rollout_forward) and torch.device(env.device).type == "cuda":
            # the card's K4, K3 and K2 route through one router: the wide,
            # narrow or general family (raising only on a non-positive width)
            cuda_sgd._check_envelope(obs_width(env), int(torch.as_tensor(env.action_bounds()[0]).shape[-1]),
                                     tuple(config.feature_sizes) + tuple(config.pi_sizes),
                                     tuple(config.feature_sizes) + tuple(config.vf_sizes))
        self.env = env
        self.config = config
        self.network = network
        self.device = env.device
        self.action_low, self.action_high = action_bounds(env, self.device)
        self.action_dim = int(self.action_low.shape[-1])

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> RunnerState:
        """Seeded network, zero Adam state, env batch (``env_init``) and the
        runner's generator. The network (``ActorCritic``, or a copy of the
        given one) is initialised on the CPU from ``seed`` and moved to the
        env's device."""
        cfg = self.config
        dev = self.device
        if self.network is not None:
            network = copy.deepcopy(self.network)
            network.reset_parameters(torch.Generator().manual_seed(seed))
            network.to(dev)
        else:
            network = ActorCritic(
                obs_width(self.env), self.action_dim,
                feature_sizes=cfg.feature_sizes, pi_sizes=cfg.pi_sizes, vf_sizes=cfg.vf_sizes,
                init_log_std=cfg.init_log_std, log_std_range=cfg.log_std_range,
                device=dev, generator=torch.Generator().manual_seed(seed),
            )
        env_gen = torch.Generator(device=dev).manual_seed(seed + 1)
        env_state, obs = env_init(self.env, cfg.num_envs, env_gen, cfg.cached_reset_refresh)
        return RunnerState(
            network=network,
            opt_state=AdamState.zeros(network),
            env_state=env_state,
            obs=obs,
            generator=torch.Generator(device=dev).manual_seed(seed + 2),
            update_idx=0,
        )

    # ------------------------------------------------------------- policies
    def act(self, network: ActorCritic, obs: Tensor, generator: torch.Generator):
        return act(network, obs, generator, fused=self.config.fused_rollout_forward)

    def act_deterministic(self, network: ActorCritic, obs: Tensor) -> Tensor:
        return act_deterministic(network, obs, self.action_low, self.action_high)

    # ------------------------------------------------------------- rollout
    def _env_step(self, env_state, action: Tensor):
        return env_step(self.env, env_state, action, self.config.cached_reset_refresh)

    def _use_slot(self) -> bool:
        """``PPOConfig.slot_bootstrap`` (None = auto): the slot form only
        where truncations come from the time limit alone and the limit
        exceeds the rollout. A natively batched env that does not declare
        ``time_limit_truncation_only`` (the packed hover env) takes the
        in-scan form, as ``ppo.py:393-419`` decides."""
        cfg = self.config
        if cfg.slot_bootstrap is not None:
            return cfg.slot_bootstrap
        max_steps = getattr(self.env, "max_steps", None)
        time_limit_only = getattr(
            self.env, "time_limit_truncation_only", not getattr(self.env, "native_batch", False)
        )
        return max_steps is not None and max_steps > cfg.rollout_steps and time_limit_only

    def _rollout(self, runner: RunnerState) -> tuple[RunnerState, Transition]:
        cfg = self.config
        env_state, obs, traj = rollout(
            runner.network, self.env, runner.env_state, runner.obs, cfg.rollout_steps,
            runner.generator, refresh=cfg.cached_reset_refresh,
            fused=cfg.fused_rollout_forward, gamma=cfg.gamma, slot=self._use_slot(),
        )
        runner.env_state, runner.obs = env_state, obs
        return runner, traj

    # ----------------------------------------------------------------- GAE
    @torch.no_grad()
    def _gae(self, network: ActorCritic, traj: Transition, last_obs: Tensor) -> tuple[Tensor, Tensor]:
        """Advantages and returns (T, N): the reverse scan of ``ppo.py:495-521``."""
        gamma, lam = self.config.gamma, self.config.gae_lambda
        next_value = network.value(last_obs)
        gae = torch.zeros_like(next_value)
        not_done = 1.0 - traj.done.to(torch.float32)
        adv = torch.empty_like(traj.reward)
        for t in range(traj.reward.shape[0] - 1, -1, -1):
            delta = traj.reward[t] + gamma * next_value * not_done[t] - traj.value[t]
            gae = delta + gamma * lam * not_done[t] * gae
            adv[t] = gae
            next_value = traj.value[t]
        return adv, adv + traj.value

    # ---------------------------------------------------------------- loss
    def _loss(self, network, obs, action, old_log_prob, advantages, returns):
        mean, log_std, value = network(obs)
        log_prob = gaussian_log_prob(mean, log_std, action)
        ratio = torch.exp(log_prob - old_log_prob)
        # population std, as jnp.std (torch.std is Bessel-corrected)
        adv = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1.0 - self.config.clip_eps, 1.0 + self.config.clip_eps) * adv
        pg_loss = -torch.mean(torch.minimum(pg1, pg2))
        v_loss = 0.5 * torch.mean((value - returns) ** 2)
        ent = torch.mean(gaussian_entropy(log_std))
        total = pg_loss + self.config.value_coef * v_loss - self.config.entropy_coef * ent
        metrics = {
            "loss": total, "pg_loss": pg_loss, "v_loss": v_loss, "entropy": ent,
            "approx_kl": torch.mean(old_log_prob - log_prob),
        }
        return total, {k: v.detach() for k, v in metrics.items()}

    def _minibatch_step(self, network: torch.nn.Module, opt: AdamState, mb: Tensor, obs_dim: int, act_dim: int):
        """One default-path update: autograd on the f32 network, optax's
        clip, Adam. Returns the new Adam state and the metrics."""
        c0 = obs_dim + act_dim
        loss, metrics = self._loss(
            network, mb[:, :obs_dim], mb[:, obs_dim:c0], mb[:, c0], mb[:, c0 + 1], mb[:, c0 + 2]
        )
        if isinstance(network, ActorCritic):
            params = _leaf_parameters(network)
            grads = [_as_leaf(p, g) for p, g in zip(params, torch.autograd.grad(loss, params))]
        else:
            grads = list(torch.autograd.grad(loss, list(network.parameters())))
        grads = clip_by_global_norm(grads, self.config.max_grad_norm)
        opt = adam_update(optimizer_leaves(network), grads, opt, self.config.learning_rate)
        return opt, metrics

    def epoch_config(self, obs_dim: int) -> cuda_sgd.EpochConfig:
        cfg = self.config
        return cuda_sgd.EpochConfig(
            obs_dim=obs_dim, act_dim=self.action_dim,
            pi_sizes=tuple(cfg.feature_sizes) + tuple(cfg.pi_sizes),
            vf_sizes=tuple(cfg.feature_sizes) + tuple(cfg.vf_sizes),
            learning_rate=cfg.learning_rate, clip_eps=cfg.clip_eps,
            entropy_coef=cfg.entropy_coef, value_coef=cfg.value_coef,
            max_grad_norm=cfg.max_grad_norm, log_std_range=cfg.log_std_range,
        )

    # ------------------------------------------------------- train iteration
    def pack(self, traj: Transition, advantages: Tensor, returns: Tensor) -> Tensor:
        """The (batch, obs + act + 3) buffer ``[obs | action | old_logp |
        adv | ret]`` of ``ppo.py:568-583``."""
        b = self.config.batch_size
        return torch.cat([
            traj.obs.reshape(b, -1), traj.action.reshape(b, -1),
            traj.log_prob.reshape(b, 1), advantages.reshape(b, 1), returns.reshape(b, 1),
        ], dim=1)

    def rewrite_old_logp(self, network: ActorCritic, packed: Tensor, obs_dim: int) -> None:
        """K3: the packed buffer's old log-prob column recomputed in place
        with the epoch kernel's own arithmetic, so the first epoch's ratios
        start at exp(0) (``fused_sgd_consistent_logp``, pallas_sgd.py:187-198)."""
        cfg = self.config
        n_pi_leaves = 2 * (len(cfg.feature_sizes) + len(cfg.pi_sizes)) + 3
        leaves = [t.detach() for t in cuda_sgd.params_to_leaves(network)[:n_pi_leaves]]
        packed[:, obs_dim + self.action_dim] = cuda_sgd.logp_forward(
            packed, leaves, obs_dim, cfg.log_std_range, vf_sizes=self.epoch_config(obs_dim).vf_sizes
        )

    def sgd(self, runner: RunnerState, packed: Tensor, obs_dim: int) -> dict[str, Tensor]:
        """The epochs of one iteration over the packed buffer; updates the
        runner's network and Adam state in place and returns the metrics
        stacked as (num_epochs, num_minibatches). Under ``fused_sgd`` each
        epoch is one call of K2 and Adam's count advances by
        ``num_minibatches`` per epoch."""
        cfg = self.config
        act_dim = self.action_dim
        c0 = obs_dim + act_dim
        blk = shuffle_block_size(cfg)
        num_blocks = cfg.batch_size // blk
        network, opt = runner.network, runner.opt_state
        if cfg.fused_sgd:
            ecfg = self.epoch_config(obs_dim)
            leaves = [t.detach() for t in cuda_sgd.params_to_leaves(network)]
            mu, nu, count = opt.mu, opt.nu, opt.count
        rows = []
        for _ in range(cfg.num_epochs):
            perm = torch.randperm(num_blocks, generator=runner.generator, device=packed.device)
            mbs = shuffle_gather(packed, perm, blk, cfg.num_minibatches)
            if cfg.fused_sgd:
                adv_col = mbs[:, :, c0 + 1]
                adv_stats = torch.stack([adv_col.mean(dim=1), adv_col.std(dim=1, correction=0)], dim=1)
                leaves, mu, nu, m = cuda_sgd.fused_epoch(mbs, adv_stats, count.reshape(1), leaves, mu, nu, ecfg)
                count = count + cfg.num_minibatches
                rows.append(m)
                continue
            for mb in mbs:
                opt, metrics = self._minibatch_step(network, opt, mb, obs_dim, act_dim)
                rows.append(torch.stack([metrics[k] for k in cuda_sgd.METRICS]))
        if cfg.fused_sgd:
            cuda_sgd.leaves_to_params(leaves, network)
            opt = AdamState(count=count, mu=mu, nu=nu)
        runner.opt_state = opt
        stacked = torch.stack(rows).reshape(cfg.num_epochs, cfg.num_minibatches, len(cuda_sgd.METRICS))
        return {k: stacked[..., i] for i, k in enumerate(cuda_sgd.METRICS)}

    def train_iteration(self, runner: RunnerState) -> tuple[RunnerState, dict[str, Tensor]]:
        """One PPO update: rollout → GAE → epochs × minibatch SGD. Updates
        ``runner`` in place and returns it with the iteration's metrics
        (0-d tensors on the device: means over epochs and minibatches,
        ``mean_reward`` and ``mean_episode_done``)."""
        runner, traj = self._rollout(runner)
        advantages, returns = self._gae(runner.network, traj, runner.obs)
        packed = self.pack(traj, advantages, returns)
        obs_dim = traj.obs.shape[-1]
        if self.config.fused_sgd and self.config.fused_sgd_consistent_logp:
            self.rewrite_old_logp(runner.network, packed, obs_dim)
        metrics = self.sgd(runner, packed, obs_dim)
        runner.update_idx += 1
        metrics = {k: v.mean() for k, v in metrics.items()}
        metrics["mean_reward"] = traj.reward.mean()
        metrics["mean_episode_done"] = traj.done.to(torch.float32).mean()
        return runner, metrics

    # ----------------------------------------------------------------- eval
    @torch.no_grad()
    def evaluate(
        self, network: ActorCritic, generator: torch.Generator | None = None, num_episodes: int = 8
    ) -> dict[str, Tensor]:
        """Deterministic-policy evaluation: mean/std (population) episode
        reward and length over ``num_episodes`` fresh episodes, stepped for
        ``max_steps + 2`` calls (envs first report their time-limit
        truncation on call max_steps + 2)."""
        if not hasattr(self.env, "max_steps"):
            raise AttributeError(
                "evaluate() needs env.max_steps to size the episode horizon; "
                f"{type(self.env).__name__} does not define it"
            )
        state, obs = self.env.reset(num_episodes, generator)
        obs = _flat_obs(obs)
        zeros = lambda: torch.zeros(num_episodes, device=obs.device)  # noqa: E731
        done, ep_rew, ep_len = zeros(), zeros(), zeros()
        for _ in range(int(self.env.max_steps) + 2):
            action = self.act_deterministic(network, obs)
            state, out = self.env.step(state, action)
            step_done = (out.termination | out.truncation).to(torch.float32)
            ep_rew = ep_rew + out.reward * (1.0 - done)
            ep_len = ep_len + (1.0 - done)
            done = torch.maximum(done, step_done)
            obs = _flat_obs(out.obs)
        std = lambda x: x.std(correction=0)  # noqa: E731
        return {
            "mean_reward": ep_rew.mean(), "std_reward": std(ep_rew),
            "mean_length": ep_len.mean(), "std_length": std(ep_len),
        }

