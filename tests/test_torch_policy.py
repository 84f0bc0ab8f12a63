"""The port's policy against the JAX package: weights carried from a flax
init, the f32 forward, the fused forward's bf16 arithmetic against the
Pallas kernel (interpret mode), the Gaussian log-prob and ``act``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyflyt_tpu.envs.quadx_hover import QuadXHoverEnv as JHoverEnv
from pyflyt_tpu.ops import pallas_policy, pallas_sgd
from pyflyt_tpu.rl import networks as jnet
from pyflyt_tpu.rl.ppo import PPO, PPOConfig
from pyflyt_tpu_torch.convert import actor_critic_from_flax
from pyflyt_tpu_torch.ops import cuda_policy
from pyflyt_tpu_torch.rl import networks as tnet
from pyflyt_tpu_torch.rl import ppo as tppo

torch.set_num_threads(1)

OBS_DIM, ACT_DIM = 21, 4
RNG = np.random.default_rng(11)
OBS = RNG.normal(size=(64, OBS_DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def carried():
    net = jnet.ActorCritic(action_dim=ACT_DIM, init_log_std=-0.5)
    params = net.init(jax.random.PRNGKey(3), jnp.asarray(OBS))
    tp = actor_critic_from_flax(jax.tree.map(np.asarray, params), device="cpu")
    return net, params, tp


def test_converter_transposes_dense_kernels(carried):
    _, params, tp = carried
    p = params["params"]
    k0 = np.asarray(p["pi_trunk"]["Dense_0"]["kernel"])
    assert k0.shape == (OBS_DIM, 256) and tp.pi_trunk.layers[0].weight.shape == (256, OBS_DIM)
    np.testing.assert_array_equal(tp.pi_trunk.layers[0].weight.detach().numpy(), k0.T)
    np.testing.assert_array_equal(
        tp.vf_head.weight.detach().numpy(), np.asarray(p["vf_head"]["kernel"]).T
    )
    np.testing.assert_array_equal(tp.log_std.detach().numpy(), np.asarray(p["log_std"]))


def test_f32_forward_matches_flax(carried):
    net, params, tp = carried
    mean, log_std, value = net.apply(params, jnp.asarray(OBS))
    tm, tls, tv = tp(torch.from_numpy(OBS))
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(mean), atol=1e-5)
    np.testing.assert_allclose(tls.detach().numpy(), np.asarray(log_std), atol=1e-6)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(value), atol=1e-5)


def test_log_std_range_clamps_like_flax():
    net = jnet.ActorCritic(action_dim=ACT_DIM, feature_sizes=(16,), init_log_std=-3.0, log_std_range=(-1.6, 0.5))
    params = net.init(jax.random.PRNGKey(4), jnp.asarray(OBS))
    tp = actor_critic_from_flax(jax.tree.map(np.asarray, params), log_std_range=(-1.6, 0.5), device="cpu")
    _, ls, _ = net.apply(params, jnp.asarray(OBS))
    _, tls, _ = tp(torch.from_numpy(OBS))
    np.testing.assert_allclose(tls.detach().numpy(), np.asarray(ls), atol=0.0)
    assert float(tls.detach().min()) == pytest.approx(-1.6)


def test_fused_forward_plain_matches_pallas_kernel(carried):
    """bf16-input / f32-accumulate arithmetic against the Pallas kernel in
    interpret mode at n=64. Both round the same bf16 inputs; sums run in
    another order, and a sum on a bf16 rounding boundary moves one trunk
    activation by one bf16 ulp (<= 2^-8): through the 0.01-gain head that
    is < 1e-4 on the mean, through the 1.0-gain head < 1e-3 on the value."""
    _, params, tp = carried
    run = pallas_policy.build_policy_value_forward(
        obs_dim=OBS_DIM, act_dim=ACT_DIM, pi_sizes=(256, 256), vf_sizes=(256, 256),
        chunk=64, interpret=True,
    )
    jm, jv = run(jnp.asarray(OBS), pallas_sgd.params_to_leaves(params))
    tm, tv = cuda_policy.policy_value_forward(torch.from_numpy(OBS), tp.kernel_weights())
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-3)


def test_fused_forward_plain_matches_pallas_kernel_at_obs_33():
    """The same at the waypoints env's flat width (attitude 21 + 4 target
    deltas x 3), which the kernel pads to 64; the tolerance is the bf16
    boundary argument above."""
    obs33 = np.random.default_rng(12).normal(size=(64, 33)).astype(np.float32)
    net = jnet.ActorCritic(action_dim=ACT_DIM, init_log_std=-0.5)
    params = net.init(jax.random.PRNGKey(5), jnp.asarray(obs33))
    tp = actor_critic_from_flax(jax.tree.map(np.asarray, params), device="cpu")
    run = pallas_policy.build_policy_value_forward(
        obs_dim=33, act_dim=ACT_DIM, pi_sizes=(256, 256), vf_sizes=(256, 256), chunk=64, interpret=True,
    )
    jm, jv = run(jnp.asarray(obs33), pallas_sgd.params_to_leaves(params))
    w = tp.kernel_weights()
    assert w.obs_dim == 33 <= cuda_policy.MAX_OBS_DIM
    tm, tv = cuda_policy.policy_value_forward(torch.from_numpy(obs33), w)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-3)


def test_leaf_order_matches_pallas_sgd(carried):
    _, params, tp = carried
    net = dict(obs_dim=OBS_DIM, act_dim=ACT_DIM, pi_sizes=(256, 256), vf_sizes=(256, 256), log_std_range=None)
    assert cuda_policy.leaf_specs(net) == pallas_sgd._leaf_specs(net)
    for a, b in zip(cuda_policy.params_to_leaves(tp), pallas_sgd.params_to_leaves(params)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


def test_kernel_weights_are_cached_until_a_parameter_changes(carried):
    _, _, tp = carried
    w1 = tp.kernel_weights()
    assert tp.kernel_weights() is w1
    assert w1.pi_w[1].dtype == torch.bfloat16 and w1.pi_b[1].dtype == torch.float32
    with torch.no_grad():
        tp.pi_head.bias.add_(1.0)
    try:
        w2 = tp.kernel_weights()
        assert w2 is not w1
        np.testing.assert_allclose(w2.pi_head_b.numpy(), w1.pi_head_b.numpy() + 1.0)
    finally:
        with torch.no_grad():
            tp.pi_head.bias.sub_(1.0)


def test_fused_forward_rejects_wrong_obs_width(carried):
    _, _, tp = carried
    with pytest.raises(ValueError, match="obs must be"):
        cuda_policy.policy_value_forward(torch.zeros(3, OBS_DIM + 1), tp.kernel_weights())


def test_forward_flop_count(carried):
    _, _, tp = carried
    macs = 2 * (OBS_DIM * 256 + 256 * 256) + 256 * ACT_DIM + 256
    assert cuda_policy.forward_flops(8192, tp.kernel_weights()) == 2 * 8192 * macs


def test_gaussian_log_prob_matches_jax():
    mean, log_std, action = (RNG.normal(size=(32, ACT_DIM)).astype(np.float32) for _ in range(3))
    jl = jnet.gaussian_log_prob(jnp.asarray(mean), jnp.asarray(log_std), jnp.asarray(action))
    tl = tnet.gaussian_log_prob(torch.from_numpy(mean), torch.from_numpy(log_std), torch.from_numpy(action))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-6)


def test_act_matches_jax_given_the_same_noise(carried, monkeypatch):
    """``PPO.act`` with its normal draw replaced by a fixed noise array,
    against the port's ``act`` (f32 forward) fed the same array."""
    net, params, tp = carried
    cfg = PPOConfig(num_envs=64, init_log_std=-0.5)
    ppo = PPO(JHoverEnv(max_duration_seconds=2.0), cfg, network=net)
    noise = RNG.normal(size=(64, ACT_DIM)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(noise))
    ja, jl, jv = ppo.act(params, jnp.asarray(OBS), jax.random.PRNGKey(0))
    ta, tl, tv = tppo.act(tp, torch.from_numpy(OBS), noise=torch.from_numpy(noise), fused=False)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def test_fused_act_uses_the_fused_forward(carried):
    _, _, tp = carried
    obs = torch.from_numpy(OBS)
    noise = torch.from_numpy(RNG.normal(size=(64, ACT_DIM)).astype(np.float32))
    a, lp, v = tppo.act(tp, obs, noise=noise)
    mean, value = cuda_policy.policy_value_forward(obs, tp.kernel_weights())
    std = torch.exp(tp.log_std.detach())
    torch.testing.assert_close(a, mean + std * noise)
    torch.testing.assert_close(v, value)
    torch.testing.assert_close(lp, tnet.gaussian_log_prob(mean, tp.log_std.detach().expand_as(mean), a))
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    torch.testing.assert_close(tppo.act(tp, obs, g1)[0], tppo.act(tp, obs, g2)[0])


def test_seeded_init_is_reproducible_and_orthogonal():
    a = tnet.ActorCritic(OBS_DIM, ACT_DIM, device="cpu", generator=torch.Generator().manual_seed(1))
    b = tnet.ActorCritic(OBS_DIM, ACT_DIM, device="cpu", generator=torch.Generator().manual_seed(1))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    w = a.pi_trunk.layers[1].weight.detach()
    torch.testing.assert_close(w @ w.T, 2.0 * torch.eye(256), atol=1e-4, rtol=0)
    h = a.vf_head.weight.detach()
    assert h.norm().item() == pytest.approx(1.0, abs=1e-5)
    assert not a.pi_trunk.layers[0].bias.any()


def test_actor_critic_with_head_layers_round_trips():
    net = jnet.ActorCritic(action_dim=ACT_DIM, feature_sizes=(32,), pi_sizes=(16,), vf_sizes=(8, 8))
    params = net.init(jax.random.PRNGKey(9), jnp.asarray(OBS))
    tp = actor_critic_from_flax(jax.tree.map(np.asarray, params), device="cpu")
    assert [l.out_features for l in tp.pi_trunk.layers] == [32, 16]
    assert [l.out_features for l in tp.vf_trunk.layers] == [32, 8, 8]
    m, _, v = net.apply(params, jnp.asarray(OBS))
    tm, _, tv = tp(torch.from_numpy(OBS))
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(m), atol=1e-5)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(v), atol=1e-5)
    assert dataclasses.is_dataclass(tp.kernel_weights())
