"""The port's learner against the JAX package's on the CPU: the default
epoch (autograd, optax's clip, Adam) against the XLA minibatch scan on the
same minibatches, GAE, the block shuffle, the loss's parity traps; then
the port's own training loop: fused and default paths over one iteration,
a smoke iteration on the packed hover env, checkpoints that resume bit for
bit, an orbax checkpoint carried in, and ``train`` writing its logs."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pyflyt_tpu.envs.quadx_hover import QuadXHoverEnv as JHoverEnv
from pyflyt_tpu.ops import pallas_sgd
from pyflyt_tpu.rl import checkpoint as jckpt
from pyflyt_tpu.rl import networks as jnet
from pyflyt_tpu.rl import ppo as jppo
from pyflyt_tpu_torch.convert import actor_critic_from_flax
from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv
from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
from pyflyt_tpu_torch.ops import cuda_sgd
from pyflyt_tpu_torch.rl import checkpoint, networks, ppo
from pyflyt_tpu_torch.rl.train import TrainConfig, train

torch.set_num_threads(1)

OBS, ACT = 21, 4
FEAT = OBS + ACT + 3
T = torch.from_numpy


def _jax_ppo(**kw):
    cfg = jppo.PPOConfig(feature_sizes=(32, 32), init_log_std=-0.5, learning_rate=1e-3, **kw)
    return jppo.PPO(JHoverEnv(max_duration_seconds=2.0), cfg)


def _port_ppo(fused=False, env=None, **kw):
    env = env or QuadXHoverEnv(device="cpu", max_duration_seconds=1.0)
    cfg = ppo.PPOConfig(
        feature_sizes=(32, 32), init_log_std=-0.5, learning_rate=1e-3, cached_reset_refresh=8,
        fused_sgd=fused, **kw,
    )
    return ppo.PPO(env, cfg)


def _packed_env():
    return PackedQuadXHoverEnv(base=QuadXHoverEnv(device="cpu", max_duration_seconds=1.0))


@pytest.fixture(scope="module")
def flax_params():
    jp = _jax_ppo()
    return jp, jp.network.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))


def _minibatches(params, n_mb, mb, seed):
    """Rows whose stored log-probs are the policy's own plus noise: ratios
    inside the clip band (where the two surrogate terms tie) and outside."""
    rng = np.random.default_rng(seed)
    mbs = rng.normal(size=(n_mb, mb, FEAT)).astype(np.float32)
    flat = mbs.reshape(-1, FEAT)
    flat[:, OBS : OBS + ACT] *= 0.5
    net = jnet.ActorCritic(action_dim=ACT, feature_sizes=(32, 32), init_log_std=-0.5)
    mean, log_std, _ = net.apply(params, jnp.asarray(flat[:, :OBS]))
    own = np.asarray(jnet.gaussian_log_prob(mean, log_std, jnp.asarray(flat[:, OBS : OBS + ACT])))
    flat[:, OBS + ACT] = own + rng.normal(size=flat.shape[0]).astype(np.float32) * 0.3
    flat[:, OBS + ACT + 2] *= 3.0  # returns
    return mbs


# ---------------------------------------------------------------------------
# the default epoch against the XLA minibatch scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_grad_norm", [0.5, 1e3], ids=["clipped", "unclipped"])
def test_default_epoch_matches_jax_minibatch_scan(flax_params, max_grad_norm):
    """``jax.value_and_grad(PPO._loss)`` + ``PPO.optimizer`` (optax.flatten
    of clip + Adam) scanned over 3 minibatches of 64 rows, against the
    port's autograd step with optax's clip and Adam written out. Both f32
    on the CPU: summation order only, so metrics to 1e-5 and params to
    2e-6 after three lr-1e-3 Adam steps."""
    jp0, params = flax_params
    jp = _jax_ppo(max_grad_norm=max_grad_norm)
    mbs = _minibatches(params, 3, 64, seed=1)
    c0 = OBS + ACT

    def minibatch(carry, mb):
        p, opt_state = carry
        (_, metrics), grads = jax.value_and_grad(jp._loss, has_aux=True)(
            p, mb[:, :OBS], mb[:, OBS:c0], mb[:, c0], mb[:, c0 + 1], mb[:, c0 + 2]
        )
        updates, opt_state = jp.optimizer.update(grads, opt_state, p)
        return (optax.apply_updates(p, updates), opt_state), metrics

    (jparams, _), jmet = jax.jit(lambda p, s, m: jax.lax.scan(minibatch, (p, s), m))(
        params, jp.optimizer.init(params), jnp.asarray(mbs)
    )
    net = actor_critic_from_flax(jax.tree.map(np.asarray, params), device="cpu")
    tp = _port_ppo(max_grad_norm=max_grad_norm)
    opt = ppo.AdamState.zeros(net)
    rows = []
    for mb in T(mbs):
        opt, m = tp._minibatch_step(net, opt, mb, OBS, ACT)
        rows.append(m)
    assert int(opt.count) == 3
    for k in cuda_sgd.METRICS:
        np.testing.assert_allclose([float(r[k]) for r in rows], np.asarray(jmet[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    want = pallas_sgd.params_to_leaves(jparams)
    for i, (a, b) in enumerate(zip(cuda_sgd.params_to_leaves(net), want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=2e-6, rtol=0, err_msg=f"leaf {i}")
    moved = np.abs(np.asarray(want[0]) - np.asarray(pallas_sgd.params_to_leaves(params)[0])).max()
    assert moved > 1e-3


def test_loss_and_gradient_match_jax_on_eight_rows(flax_params):
    """Trap: the advantage is normalised with the population std (jnp.std
    has ddof 0; torch.std would divide by n - 1, 7% off at 8 rows)."""
    jp, params = flax_params
    mb = _minibatches(params, 1, 8, seed=2)[0]
    c0 = OBS + ACT
    args = (mb[:, :OBS], mb[:, OBS:c0], mb[:, c0], mb[:, c0 + 1], mb[:, c0 + 2])
    (jl, _), jg = jax.jit(jax.value_and_grad(jp._loss, has_aux=True))(params, *map(jnp.asarray, args))
    net = actor_critic_from_flax(jax.tree.map(np.asarray, params), device="cpu")
    tl, _ = _port_ppo()._loss(net, *map(T, args))
    grads = torch.autograd.grad(tl, ppo._leaf_parameters(net))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6, atol=1e-6)
    for p, g, want in zip(ppo._leaf_parameters(net), grads, pallas_sgd.params_to_leaves(jg)):
        np.testing.assert_allclose(ppo._as_leaf(p, g).numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["kept", "clipped"])
def test_clip_by_global_norm_is_optax(scale):
    """Trap: optax keeps g below the norm and scales by max/norm above it;
    torch's clip_grad_norm_ divides by norm + 1e-6."""
    rng = np.random.default_rng(3)
    gs = [(rng.normal(size=s) * scale).astype(np.float32) for s in [(5, 3), (1, 3), (7,)]]
    want, _ = optax.clip_by_global_norm(0.5).update([jnp.asarray(g) for g in gs], optax.EmptyState())
    got = ppo.clip_by_global_norm([T(g) for g in gs], 0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_adam_update_is_optax_adam():
    """Trap: optax's bias correction 1 - b**t (the kernels' 1 - exp(t ln b)
    agrees to f32 rounding) and eps outside the square root."""
    rng = np.random.default_rng(4)
    shapes = [(6, 3), (1, 3)]
    p = [rng.normal(size=s).astype(np.float32) for s in shapes]
    opt = optax.adam(1e-2, eps=1e-5)
    jparams, jstate = [jnp.asarray(x) for x in p], opt.init([jnp.asarray(x) for x in p])
    tparams = [T(x.copy()) for x in p]
    tstate = ppo.AdamState(torch.zeros((), dtype=torch.int32), [torch.zeros(s) for s in shapes],
                           [torch.zeros(s) for s in shapes])
    for step in range(3):
        g = [rng.normal(size=s).astype(np.float32) for s in shapes]
        upd, jstate = opt.update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tstate = ppo.adam_update(tparams, [T(x) for x in g], tstate, 1e-2)
    assert int(tstate.count) == 3
    for a, b in zip(tparams, jparams):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    t = 5.0
    assert abs((1 - np.exp(np.float32(t) * np.log(cuda_sgd.B2))) - (1 - cuda_sgd.B2**t)) < 1e-7


def test_log_std_clamp_passes_half_the_gradient_on_a_bound():
    """Trap: jnp.clip gives 0.5 at a bound, torch.clamp 1.0; the port's
    f32 network follows jnp.clip (the fused kernels follow the Pallas
    kernel's strict mask, tests/test_torch_sgd.py)."""
    net = networks.ActorCritic(OBS, ACT, feature_sizes=(8,), log_std_range=(-1.0, 0.5), device="cpu")
    with torch.no_grad():
        net.log_std.copy_(torch.tensor([-1.0, 0.0, 0.5, 2.0]))
    (g,) = torch.autograd.grad(net.clamped_log_std().sum(), net.log_std)
    want = jax.grad(lambda x: jnp.clip(x, -1.0, 0.5).sum())(jnp.asarray([-1.0, 0.0, 0.5, 2.0]))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    assert g.tolist() == [0.5, 1.0, 0.5, 0.0]


def test_minimum_splits_a_tie_like_lax_min():
    a = torch.tensor([1.0, 2.0], requires_grad=True)
    b = torch.tensor([1.0, 3.0], requires_grad=True)
    ga, gb = torch.autograd.grad(torch.minimum(a, b).sum(), (a, b))
    ja, jb = jax.grad(lambda x, y: jnp.minimum(x, y).sum(), argnums=(0, 1))(jnp.asarray([1.0, 2.0]), jnp.asarray([1.0, 3.0]))
    assert ga.tolist() == np.asarray(ja).tolist() == [0.5, 1.0]
    assert gb.tolist() == np.asarray(jb).tolist() == [0.5, 0.0]


def test_gaussian_entropy_matches_jax():
    ls = np.random.default_rng(5).normal(size=(6, ACT)).astype(np.float32)
    np.testing.assert_allclose(
        networks.gaussian_entropy(T(ls)).numpy(), np.asarray(jnet.gaussian_entropy(jnp.asarray(ls))), atol=1e-6
    )


# ---------------------------------------------------------------------------
# GAE and the block shuffle
# ---------------------------------------------------------------------------


def test_gae_matches_jax(flax_params):
    jp, params = flax_params
    rng = np.random.default_rng(6)
    t_len, n = 8, 16
    traj = dict(
        obs=rng.normal(size=(t_len, n, OBS)).astype(np.float32),
        action=np.zeros((t_len, n, ACT), np.float32),
        log_prob=np.zeros((t_len, n), np.float32),
        value=rng.normal(size=(t_len, n)).astype(np.float32),
        reward=rng.normal(size=(t_len, n)).astype(np.float32),
        done=rng.random((t_len, n)) < 0.2,
    )
    last_obs = rng.normal(size=(n, OBS)).astype(np.float32)
    ja, jr = jp._gae(params, jppo.Transition(**{k: jnp.asarray(v) for k, v in traj.items()}), jnp.asarray(last_obs))
    net = actor_critic_from_flax(jax.tree.map(np.asarray, params), device="cpu")
    ta, tr = _port_ppo()._gae(net, ppo.Transition(**{k: T(v) for k, v in traj.items()}), T(last_obs))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize(
    "num_envs,steps,n_mb,block,auto,want",
    [
        (8192, 32, 32, 16, True, 32),  # the main path: 262,144 // 8192
        (65536, 32, 32, 16, True, 256),
        (32, 16, 4, 16, False, 16),
        (24, 4, 4, 16, True, 12),  # largest divisor of 24 not above 16
        (32, 16, 4, 1, False, 1),  # the exact per-sample permutation
    ],
)
def test_shuffle_block_size(num_envs, steps, n_mb, block, auto, want):
    """Hand-counted against the formula of ``ppo.py:593-604``."""
    cfg = ppo.PPOConfig(num_envs=num_envs, rollout_steps=steps, num_minibatches=n_mb,
                        shuffle_block=block, shuffle_block_auto=auto)
    assert ppo.shuffle_block_size(cfg) == want
    with pytest.raises(ValueError, match="shuffle_block"):
        ppo.shuffle_block_size(dataclasses.replace(cfg, shuffle_block=0))


@pytest.mark.parametrize("blk", [32, 12], ids=["lane_view", "row_view"])
def test_shuffle_gather_matches_jax(blk):
    """Both branches of the JAX gather (a 128-lane view when a block is a
    whole number of 128 floats) against the port's row gather: exact."""
    rng = np.random.default_rng(7)
    batch, n_mb = 384, 4
    packed = rng.normal(size=(batch, FEAT)).astype(np.float32)
    perm = rng.permutation(batch // blk)
    want = jppo._shuffle_gather(jnp.asarray(packed), jnp.asarray(perm), batch // blk, blk, FEAT, n_mb, batch // n_mb)
    got = ppo.shuffle_gather(T(packed), T(perm), blk, n_mb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the port's training loop
# ---------------------------------------------------------------------------


def _params(net):
    return [p.detach().clone() for p in net.parameters()]


def test_fused_and_default_paths_agree_over_one_iteration():
    """The same rollout and permutations through K3 + K2's twins (bf16
    inputs) and through autograd (f32): the tolerance of
    tests/test_pallas_sgd.py:46-70."""
    out = {}
    for fused in (False, True):
        tp = _port_ppo(fused, _packed_env(), num_envs=32, rollout_steps=16, num_epochs=2,
                       num_minibatches=4, shuffle_block_auto=False)
        runner = tp.init(3)
        runner, metrics = tp.train_iteration(runner)
        out[fused] = (metrics, _params(runner.network))
    for k in cuda_sgd.METRICS:
        np.testing.assert_allclose(float(out[True][0][k]), float(out[False][0][k]), rtol=2e-2, atol=2e-4, err_msg=k)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-2, atol=5e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused"])
def test_train_iteration_smoke_on_the_packed_env(fused):
    tp = _port_ppo(fused, _packed_env(), num_envs=16, rollout_steps=8, num_epochs=2, num_minibatches=2,
                   fused_rollout_forward=fused)
    runner = tp.init(0)
    before = _params(runner.network)
    runner, metrics = tp.train_iteration(runner)
    runner, metrics = tp.train_iteration(runner)
    assert runner.update_idx == 2
    assert int(runner.opt_state.count) == 2 * 2 * 2  # iterations x epochs x minibatches
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert any(not torch.equal(a, b) for a, b in zip(before, _params(runner.network)))
    # the JAX PPO's metric keys (traced, not compiled)
    jp = _jax_ppo()
    pj = jp.network.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    z = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)  # noqa: E731
    _, jm = jax.eval_shape(jp._loss, pj, z(4, OBS), z(4, ACT), z(4), z(4), z(4))
    assert set(metrics) == set(jm) | {"mean_reward", "mean_episode_done"}


def test_fused_path_normalises_advantages_with_the_population_std(monkeypatch):
    seen = []
    real = cuda_sgd.fused_epoch

    def spy(mbs, adv_stats, *rest):
        seen.append((mbs.clone(), adv_stats.clone()))
        return real(mbs, adv_stats, *rest)

    monkeypatch.setattr(cuda_sgd, "fused_epoch", spy)
    tp = _port_ppo(True, _packed_env(), num_envs=8, rollout_steps=4, num_epochs=1, num_minibatches=2)
    tp.train_iteration(tp.init(1))
    (mbs, stats), = seen
    adv = mbs[:, :, OBS + ACT + 1].numpy()
    np.testing.assert_allclose(stats.numpy(), np.stack([adv.mean(1), adv.std(1, ddof=0)], 1), rtol=1e-5, atol=1e-6)


def test_slot_bootstrap_matches_in_scan():
    """The two forms of the time-limit bootstrap give the same rewards
    where each env truncates at most once (every env truncates on call 12
    of a 12-step rollout), as tests/test_ppo.py holds them in the JAX
    package; without the bootstrap the rewards differ."""
    env = QuadXHoverEnv(device="cpu", max_duration_seconds=0.25, noisy_motors=False)
    rewards = {}
    for slot in (False, True, None):
        tp = _port_ppo(False, env, num_envs=8, rollout_steps=12, slot_bootstrap=slot)
        runner = tp.init(4)
        if slot is None:
            _, _, traj = ppo.rollout(runner.network, env, runner.env_state, runner.obs, 12,
                                     runner.generator, refresh=8, fused=False)
        else:
            runner, traj = tp._rollout(runner)
        rewards[slot] = traj.reward
    assert tp._use_slot() is False and _port_ppo(False, env, rollout_steps=8)._use_slot() is True
    np.testing.assert_allclose(rewards[True].numpy(), rewards[False].numpy(), atol=1e-5)
    assert float((rewards[False] - rewards[None]).abs().max()) > 0.1


def test_checkpoint_resumes_bit_for_bit(tmp_path):
    tp = _port_ppo(True, _packed_env(), num_envs=16, rollout_steps=8, num_epochs=2, num_minibatches=2)
    runner = tp.init(5)
    runner, _ = tp.train_iteration(runner)
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, runner)
    runner, m_a = tp.train_iteration(runner)
    restored = checkpoint.restore(path, tp.init(9))
    assert restored.update_idx == 1 and int(restored.opt_state.count) == 4
    shared = restored.env_state
    assert shared.env_state.generator is shared.generator, "one generator stays one"
    restored, m_b = tp.train_iteration(restored)
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    for a, b in zip(_params(runner.network), _params(restored.network)):
        assert torch.equal(a, b)
    assert torch.equal(runner.obs, restored.obs)
    for a, b in zip(runner.opt_state.nu, restored.opt_state.nu):
        assert torch.equal(a, b)


def test_orbax_checkpoint_of_the_jax_package_carries_over(tmp_path, flax_params):
    """An orbax checkpoint written by the JAX package: its params through
    ``pyflyt_tpu.rl.checkpoint.restore_params`` and
    ``convert.actor_critic_from_flax`` give the same forward."""
    _, params = flax_params
    path = str(tmp_path / "jax_ckpt")
    jckpt.save(path, {"params": params, "update_idx": jnp.zeros((), jnp.int32)})
    restored = jckpt.restore_params(path, params)
    net = actor_critic_from_flax(jax.tree.map(np.asarray, restored), device="cpu")
    obs = np.random.default_rng(8).normal(size=(16, OBS)).astype(np.float32)
    jm, _, jv = jnet.ActorCritic(action_dim=ACT, feature_sizes=(32, 32), init_log_std=-0.5).apply(params, jnp.asarray(obs))
    tm, _, tv = net(T(obs))
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), atol=1e-5)


def test_train_writes_metrics_checkpoints_and_evaluations(tmp_path):
    tp = _port_ppo(False, PackedQuadXHoverEnv(base=QuadXHoverEnv(device="cpu", max_duration_seconds=0.25)),
                   num_envs=8, rollout_steps=4, num_epochs=1, num_minibatches=2)
    log_dir = str(tmp_path / "run")
    tcfg = TrainConfig(total_timesteps=2 * 32, eval_every_updates=1, eval_episodes=4, log_dir=log_dir,
                       checkpoint_every_updates=2, param_ema=0.5)
    seen = []
    runner = train(tp, tcfg, on_metrics=lambda u, row: seen.append(u))
    assert runner.update_idx == 2 and seen == [1, 2]
    rows = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    assert [r["update"] for r in rows] == [1, 2]
    assert {"loss", "eval_mean_reward", "eval_ema_mean_reward", "steps_per_s"} <= set(rows[0])
    names = os.listdir(log_dir)
    best = sorted(n for n in names if n.startswith("best_model_") and not n.startswith("best_model_ema"))
    assert best and any(n.startswith("best_model_ema") for n in names) and "ckpt_2" in names
    hist = np.load(os.path.join(log_dir, "evaluations.npz"), allow_pickle=True)["history"]
    assert len(hist) == 2 and json.loads(hist[0])["update"] == 1
    # warm start from the best model: same parameters, fresh optimizer
    net = checkpoint.restore_params(os.path.join(log_dir, best[-1]), runner.network)
    avg = checkpoint.average_params([os.path.join(log_dir, best[-1])] * 2, runner.network)
    for a, b in zip(net.parameters(), avg.parameters()):
        torch.testing.assert_close(a, b)
    warm = train(tp, dataclasses.replace(tcfg, total_timesteps=32, log_dir=None, param_ema=0.0,
                                         init_from=os.path.join(log_dir, best[-1])))
    assert warm.update_idx == 1


@pytest.mark.parametrize("what", ["mesh", "bf16", "refresh0", "train_mesh"])
def test_deferred_options_raise(what):
    env = QuadXHoverEnv(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what == "mesh":
            ppo.PPO(env, ppo.PPOConfig(cached_reset_refresh=8), mesh=object())
        elif what == "bf16":
            ppo.PPO(env, ppo.PPOConfig(cached_reset_refresh=8, compute_dtype="bfloat16"))
        elif what == "refresh0":
            # the packed hover env has no exact autoreset_step (nor has the JAX one)
            ppo.PPO(PackedQuadXHoverEnv(base=env), ppo.PPOConfig())
        else:
            train(ppo.PPO(env, ppo.PPOConfig(cached_reset_refresh=8)), TrainConfig(use_mesh=True))
