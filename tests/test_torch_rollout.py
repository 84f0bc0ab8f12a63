"""The whole slice on the CPU: weights carried from a flax init, the
policy acting in the port's hover envs, against the JAX package's
``PPO.act_deterministic`` driving ``vmap(QuadXHoverEnv.step)``.

8 agent steps at N=16, noise off. Obs and reward trajectories within
atol 2e-4 (the env tolerance of tests/test_packed_hover.py), flags exact.
"""

import jax
import numpy as np
import pytest
import torch

from pyflyt_tpu.envs.base import vec_reset
from pyflyt_tpu.envs.quadx_hover import QuadXHoverEnv as JHoverEnv
from pyflyt_tpu.rl.ppo import PPO, PPOConfig
from pyflyt_tpu_torch.convert import actor_critic_from_flax
from pyflyt_tpu_torch.envs.base import autoreset_init
from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv, packed_autoreset_init
from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
from pyflyt_tpu_torch.rl import ppo as tppo
from pyflyt_tpu_torch.rl.networks import ActorCritic, gaussian_log_prob

torch.set_num_threads(1)

N = 16
STEPS = 8
ATOL = 2e-4


@pytest.fixture(scope="module")
def reference():
    env = JHoverEnv(noisy_motors=False)
    ppo = PPO(env, PPOConfig(num_envs=N))
    st, obs = vec_reset(env, jax.random.split(jax.random.PRNGKey(0), N))
    params = ppo.network.init(jax.random.PRNGKey(42), obs)
    # scale the mean head so the carried policy flies visibly off hover
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 60.0 if "pi_head" in jax.tree_util.keystr(p) else x, params
    )
    vstep = jax.jit(jax.vmap(env.step))
    act = jax.jit(ppo.act_deterministic)
    traj = []
    for _ in range(STEPS):
        a = act(params, obs)
        st, out = vstep(st, a)
        obs = out.obs
        traj.append({"action": np.asarray(a), "obs": np.asarray(out.obs),
                     "reward": np.asarray(out.reward),
                     "termination": np.asarray(out.termination)})
    return jax.tree.map(np.asarray, params), traj


@pytest.mark.parametrize("kind", ["plain", "packed"])
def test_deterministic_rollout_matches_jax(reference, kind):
    params, traj = reference
    net = actor_critic_from_flax(params, device="cpu")
    base = QuadXHoverEnv(noisy_motors=False, device="cpu")
    env = base if kind == "plain" else PackedQuadXHoverEnv(base=base)
    low, high = tppo.action_bounds(env, torch.device("cpu"))
    st, obs = env.reset(N)
    moved = 0.0
    for i, ref in enumerate(traj):
        a = tppo.act_deterministic(net, obs, low, high)
        np.testing.assert_allclose(a.numpy(), ref["action"], atol=ATOL, err_msg=f"step {i} action")
        st, out = env.step(st, a)
        obs = out.obs
        np.testing.assert_allclose(out.obs.numpy(), ref["obs"], atol=ATOL, err_msg=f"step {i} obs")
        np.testing.assert_allclose(out.reward.numpy(), ref["reward"], atol=ATOL, err_msg=f"step {i} reward")
        np.testing.assert_array_equal(out.termination.numpy(), ref["termination"])
        moved = max(moved, float(np.abs(ref["obs"][:, :3]).max()))
    assert moved > 0.1, "the policy should move the drones"


@pytest.mark.parametrize("kind", ["plain", "packed"])
def test_stochastic_rollout_records_and_resets(kind):
    """``rollout`` with noise on, through the fused forward's twin, under
    cached auto-reset: shapes, finiteness, and episodes that end and restart."""
    base = QuadXHoverEnv(device="cpu")
    env = base if kind == "plain" else PackedQuadXHoverEnv(base=base)
    gen = torch.Generator().manual_seed(0)
    if kind == "plain":
        ars, obs = autoreset_init(env, N, gen)
    else:
        ars, obs = packed_autoreset_init(env, N, gen)
    net = ActorCritic(env.obs_size, 4, feature_sizes=(32, 32), device="cpu",
                           generator=torch.Generator().manual_seed(1))
    ars, obs, traj = tppo.rollout(net, env, ars, obs, 40, gen, refresh=16)
    assert traj.obs.shape == (40, N, env.obs_size) and traj.action.shape == (40, N, 4)
    for t in (traj.obs, traj.action, traj.log_prob, traj.value, traj.reward, obs):
        assert torch.isfinite(t).all()
    assert traj.done.any()
    assert ars.step_idx == 40
    # the next obs of a finished lane is a fresh episode's: previous action
    # (obs columns 13-16) zero, position back near the start
    t, lane = [int(x) for x in torch.nonzero(traj.done[:-1])[0]]
    fresh = traj.obs[t + 1, lane]
    assert not fresh[13:17].any() and traj.obs[t, lane, 13:17].any()
    assert torch.linalg.vector_norm(fresh[10:13] - torch.tensor([0.0, 0.0, 1.0])) < 0.1
    # the recorded log-prob is that of the unclipped sample
    mean, log_std, _ = tppo.apply_policy(net, traj.obs[0])
    lp = gaussian_log_prob(mean, log_std, traj.action[0])
    torch.testing.assert_close(traj.log_prob[0], lp)


def test_rollout_with_f32_forward_matches_fused_twin_closely():
    base = QuadXHoverEnv(noisy_motors=False, device="cpu")
    env = PackedQuadXHoverEnv(base=base)
    net = ActorCritic(env.obs_size, 4, device="cpu", generator=torch.Generator().manual_seed(2))
    out = []
    for fused in (True, False):
        gen = torch.Generator().manual_seed(3)
        ars, obs = packed_autoreset_init(env, N, gen)
        out.append(tppo.rollout(net, env, ars, obs, 4, gen, fused=fused)[2])
    # bf16 inputs against f32: the 0.01-gain mean head keeps the difference
    # far below the unit-scale action noise
    torch.testing.assert_close(out[0].action, out[1].action, atol=1e-3, rtol=0)
    torch.testing.assert_close(out[0].value, out[1].value, atol=2e-2, rtol=0)
