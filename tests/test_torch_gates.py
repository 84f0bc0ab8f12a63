"""The port's QuadX-Gates env, its gate chain, PPO with a vision network
and the ``gates_vision`` CLI against the JAX package's
(``pyflyt_tpu.envs.quadx_gates``).

The env is reset in JAX for N envs (16 × 16 px, 3 gates, noise off: the
streams differ by design), edited so that its events fire, carried into
the port with ``convert.gates_state_from_jax`` and stepped in both
packages with the same actions: one jitted K-step scan on the JAX side.
Events: lane 0 has its first gate on the drone (a pass, ``idx`` advances),
lane 1 all three (three passes in one agent step and the completion),
lane 2 its gates 100 m away (out of range: −100 and termination), lanes 3
and 4 cut the thrust (a crash into the ground), the rest fly random
rates. The JAX side runs three jitted programs: the gate chain, the reset
and the scan.

Tolerances: idx, reward, termination, truncation and the info flags
exact; the drone state, the gates and the deltas within rtol 1e-5 (and
1e-5 absolute for components near zero); the ``rgba_cam`` observation
with the render's rule (at most 0.5% of the pixels, each on an edge of the
JAX image). The gate chain within 1e-6 on JAX's own uniforms.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _render_check import assert_edge_flips_only

from pyflyt_tpu.envs.quadx_gates import QuadXGatesEnv as JGates
from pyflyt_tpu_torch.convert import gates_state_from_jax
from pyflyt_tpu_torch.envs.quadx_gates import QuadXGatesEnv, chain_gates
from pyflyt_tpu_torch.ops import cuda_quadx as cq
from pyflyt_tpu_torch.rl import PPO, PPOConfig
from pyflyt_tpu_torch.rl.networks import VisionActorCritic
from pyflyt_tpu_torch.rl.ppo import _flat_obs, obs_width
from pyflyt_tpu_torch.rl_training import gates_vision as cli

torch.set_num_threads(1)

N = 8
K = 24
ENV = dict(camera_resolution=(16, 16), num_targets=3, noisy_motors=False)
STATE_RTOL = 1e-5
STATE_ATOL = 1e-5


def _actions(k: int) -> np.ndarray:
    """Mode-0 actions: random rates about a hover thrust; lanes 3-4 at zero thrust."""
    rng = np.random.default_rng(900 + k)
    a = np.zeros((N, 4), np.float32)
    a[:, :3] = rng.normal(scale=0.4, size=(N, 3))
    a[:, 3] = rng.uniform(0.35, 0.55, size=N)
    a[3:5] = 0.0
    return a


def _carried_reset():
    """The JAX reset, edited: lane 0's first gate on the drone, lane 1's
    three, lane 2's all 100 m off."""
    env = JGates(**ENV)
    state, _ = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(3), N))
    state = jax.tree.map(np.asarray, state)
    pos = state.gate_positions.copy()
    drone = state.drone.body.pos
    pos[0, 0] = drone[0]
    pos[1, :] = drone[1][None, :]
    pos[2] += 100.0
    return env, dataclasses.replace(state, gate_positions=pos)


@pytest.fixture(scope="module")
def runs():
    env, st0 = _carried_reset()
    acts = np.stack([_actions(k) for k in range(K)])

    def scan(state, actions):
        def body(s, a):
            s, out = jax.vmap(env.step)(s, a)
            return s, (s, out)

        return jax.lax.scan(body, state, actions)[1]

    states, outs = jax.jit(scan)(jax.tree.map(jnp.asarray, st0), jnp.asarray(acts))
    return st0, acts, jax.tree.map(np.asarray, states), jax.tree.map(np.asarray, outs)


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), want, rtol=STATE_RTOL, atol=STATE_ATOL, err_msg=what)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_env_matches_jax_lane_by_lane(runs, use_kernel):
    """Every event fires (a pass, three passes and the completion, out of
    range, two crashes); flags, ``idx`` and rewards exact, the state close,
    the image on edges only. ``use_kernel`` steps the physics through the
    generic kernel's twin (CPU tensors: no launch)."""
    st0, acts, states, outs = runs
    env = QuadXGatesEnv(device="cpu", use_kernel=use_kernel, **ENV)
    st = gates_state_from_jax(st0, device="cpu")
    launches = cq.GENERIC_KERNEL.launches
    for k in range(K):
        st, out = env.step(st, torch.from_numpy(acts[k]))
        ref = jax.tree.map(lambda x: x[k], outs)
        ref_st = jax.tree.map(lambda x: x[k], states)
        for f in ("termination", "truncation"):
            np.testing.assert_array_equal(getattr(out, f).numpy(), getattr(ref, f), err_msg=f"step {k}: {f}")
        for f in ("collision", "out_of_bounds", "env_complete", "num_targets_reached"):
            np.testing.assert_array_equal(out.info[f].numpy(), ref.info[f], err_msg=f"step {k}: {f}")
        np.testing.assert_array_equal(out.reward.numpy(), ref.reward, err_msg=f"step {k}: reward")
        np.testing.assert_array_equal(st.idx.numpy(), ref_st.idx, err_msg=f"step {k}: idx")
        for f in ("pos", "quat", "lin_vel", "ang_vel"):
            _close(getattr(st.drone.body, f), getattr(ref_st.drone.body, f), f"step {k}: {f}")
        _close(st.dis_error_scalar, ref_st.dis_error_scalar, f"step {k}: distance")
        _close(out.obs["target_deltas"], ref.obs["target_deltas"], f"step {k}: deltas")
        _close(out.obs["attitude"], ref.obs["attitude"], f"step {k}: attitude")
        assert out.obs["rgba_cam"].shape == (N, 4, 16, 16) and out.obs["rgba_cam"].dtype == torch.uint8
        assert_edge_flips_only(np.moveaxis(ref.obs["rgba_cam"], 1, -1), np.moveaxis(out.obs["rgba_cam"].numpy(), 1, -1))
    # every event fired where it was set up
    fin = jax.tree.map(lambda x: x[-1], outs)
    assert fin.info["env_complete"][1] and fin.info["out_of_bounds"][2] and fin.info["collision"][3:5].all()
    assert states.idx[0, 0] == 1 and outs.reward[0, 0] > 90.0 and outs.reward[0, 2] <= -100.0
    assert cq.GENERIC_KERNEL.launches == launches


def test_gate_chain_matches_jax_on_its_uniforms():
    """``chain_gates`` on the JAX env's own draws (its ``_generate_gates``
    keys split as it splits them): the stock env and one whose minimum
    gate height lifts every leg (the vertical offset branch)."""
    envs = [JGates(num_targets=5), JGates(num_targets=5, min_gate_height=6.0)]

    def draw(env, key):
        k_d, k_a = jax.random.split(key)
        d = jax.random.uniform(k_d, (5,), jnp.float32, env.min_gate_distance, env.max_gate_distance)
        a = jax.random.uniform(k_a, (5, 3), jnp.float32, -1.0, 1.0) * jnp.asarray(env.max_gate_angles)
        return (d, a, *env._generate_gates(key))

    keys = jax.random.split(jax.random.PRNGKey(11), 16)
    out = jax.jit(lambda ks: [jax.vmap(lambda k, e=e: draw(e, k))(ks) for e in envs])(keys)
    for env, (d, a, pos, eul) in zip(envs, out):
        got_pos, got_eul = chain_gates(torch.tensor(np.asarray(d)), torch.tensor(np.asarray(a)),
                                       env.max_gate_distance, env.min_gate_height, env.max_gate_angles[1])
        np.testing.assert_allclose(got_pos.numpy(), np.asarray(pos), atol=1e-6, rtol=0)
        np.testing.assert_allclose(got_eul.numpy(), np.asarray(eul), atol=1e-6, rtol=0)
    # the lift fired: every first gate of the second env above every one of the first
    assert np.asarray(out[1][2])[:, 0, 2].min() > np.asarray(out[0][2])[:, 0, 2].max()


def test_reset_draws_and_obs():
    """Reset draws the chain from the batch's generator (the same seed, the
    same gates), the legs within [1, 4 + slack], the obs dict's shapes."""
    env = QuadXGatesEnv(device="cpu", **ENV)
    a, obs = env.reset(5, torch.Generator().manual_seed(4))
    b, _ = env.reset(5, torch.Generator().manual_seed(4))
    torch.testing.assert_close(a.gate_positions, b.gate_positions, rtol=0, atol=0)
    legs = torch.diff(torch.cat([a.gate_positions.new_tensor([0.0, 0.0, 1.0]).expand(5, 1, 3), a.gate_positions], 1),
                      dim=1).norm(dim=-1)
    assert (legs >= 1.0 - 1e-5).all() and (legs <= 6.0).all()
    assert obs["attitude"].shape == (5, 21) and obs["rgba_cam"].shape == (5, 4, 16, 16)
    assert obs["target_deltas"].shape == (5, 3, 3) and (a.idx == 0).all()
    flat = _flat_obs(obs)
    assert flat.dtype == torch.float32 and flat.shape == (5, obs_width(env)) == (5, 21 + 4 * 256 + 9)
    torch.testing.assert_close(flat[:, 21 : 21 + 1024], obs["rgba_cam"].reshape(5, -1).float())
    with pytest.raises(ValueError, match="Generator"):
        env.reset(2, None)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        QuadXGatesEnv()
    with pytest.raises(RuntimeError, match="CUDA"):
        VisionActorCritic(21 + 4 * 64 + 15, 4, 21, (4, 8, 8))


def _small_net(env):
    return VisionActorCritic(env.flat_obs_size, 4, env.combined_size, env.image_shape, conv_features=(8, 8),
                             feature_sizes=(16,), init_log_std=-0.5, device="cpu")


@pytest.mark.parametrize("refresh", [0, 2])
def test_ppo_trains_a_vision_net(refresh):
    """Two iterations with the exact (0) and the cached auto-reset (a
    refresh inside the rollout), a time limit inside it too: finite
    losses, the parameters move, and ``init`` re-seeds a copy of the given
    network."""
    env = QuadXGatesEnv(device="cpu", camera_resolution=(8, 8), num_targets=3, max_duration_seconds=0.1)
    template = _small_net(env)
    before = [p.detach().clone() for p in template.parameters()]
    ppo = PPO(env, PPOConfig(num_envs=4, rollout_steps=6, num_epochs=2, num_minibatches=2,
                             cached_reset_refresh=refresh), network=template)
    runner = ppo.init(0)
    assert runner.network is not template and runner.obs.shape == (4, obs_width(env))
    again = ppo.init(0).network
    for p, q in zip(runner.network.parameters(), again.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    start = [p.detach().clone() for p in runner.network.parameters()]
    for _ in range(2):
        runner, m = ppo.train_iteration(runner)
        assert all(bool(torch.isfinite(v)) for v in m.values())
    assert int(runner.opt_state.count) == 2 * 2 * 2 and len(runner.opt_state.mu) == len(start)
    moved = [not torch.equal(p, q) for p, q in zip(runner.network.parameters(), start)]
    assert all(moved)
    for p, q in zip(template.parameters(), before):  # the template is untouched
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_checkpoints_warm_start_and_ema_take_a_vision_net(tmp_path):
    """``rl/checkpoint``'s round trip of a runner holding a
    ``VisionActorCritic``, and ``train`` with ``init_from`` (the network
    restored from that checkpoint, the rest fresh) and the EMA shadow (its
    own best-model checkpoint)."""
    from pyflyt_tpu_torch.rl import TrainConfig, checkpoint, train

    env = QuadXGatesEnv(device="cpu", camera_resolution=(8, 8), num_targets=3, max_duration_seconds=0.1)
    ppo = PPO(env, PPOConfig(num_envs=4, rollout_steps=4, num_epochs=1, num_minibatches=2), network=_small_net(env))
    runner, _ = ppo.train_iteration(ppo.init(0))
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, runner)
    back = checkpoint.restore(path, ppo.init(1))
    assert isinstance(back.network, VisionActorCritic) and back.update_idx == 1
    for (k, p), q in zip(runner.network.state_dict().items(), back.network.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=k)
    warm = checkpoint.restore_params(path, ppo.init(2).network)
    torch.testing.assert_close(warm.convs[0].weight, runner.network.convs[0].weight, rtol=0, atol=0)
    log = tmp_path / "ema"
    out = train(ppo, TrainConfig(total_timesteps=16, eval_every_updates=1, eval_episodes=2, init_from=path,
                                 param_ema=0.5, log_dir=str(log), seed=3))
    assert out.update_idx == 1 and all(bool(torch.isfinite(p).all()) for p in out.network.parameters())
    names = [p.name for p in log.iterdir()]
    assert any(n.startswith("best_model_ema_") for n in names) and any(n.startswith("best_model_1_") for n in names)


@pytest.mark.parametrize("flag", ["fused_sgd", "fused_rollout_forward"])
def test_fused_paths_refuse_a_vision_net(flag):
    env = QuadXGatesEnv(device="cpu", **ENV)
    with pytest.raises(ValueError, match="ActorCritic"):
        PPO(env, PPOConfig(**{flag: True}), network=_small_net(env))


def _short_env(monkeypatch):
    """The CLI's env with 1 s episodes (40 agent steps), so its evals stay short here."""
    build = cli.build_env

    def short(args):
        return dataclasses.replace(build(args), max_duration_seconds=1.0)

    monkeypatch.setattr(cli, "build_env", short)


def test_cli_train_one_iteration_then_eval_its_checkpoint(tmp_path, monkeypatch):
    """``train`` for one iteration (its eval, metrics and best-model
    checkpoint), then ``eval`` on that checkpoint."""
    _short_env(monkeypatch)
    log = tmp_path / "run"
    runner = cli.main(["train", "--num_envs", "4", "--rollout_steps", "4", "--n_epochs", "1",
                       "--num_minibatches", "2", "--total_timesteps", "16", "--camera_res", "8",
                       "--conv_features", "8", "--layer_size", "16", "--eval_episodes", "2",
                       "--log_dir", str(log)], device="cpu")
    assert runner.update_idx == 1 and isinstance(runner.network, VisionActorCritic)
    best = sorted(p.name for p in log.iterdir() if p.name.startswith("best_model_"))
    assert len(best) == 1 and (log / "metrics.jsonl").exists()
    stats = cli.main(["eval", "--checkpoint", str(log / best[0]), "--camera_res", "8", "--conv_features", "8",
                      "--layer_size", "16", "--eval_episodes", "2"], device="cpu")
    assert set(stats) == {"mean_reward", "std_reward", "mean_length", "std_length"}
    assert np.isfinite(list(stats.values())).all()


def test_cli_eval_flies_the_r4_npz(monkeypatch):
    """``eval --checkpoint`` on the shipped npz, by name and by path, with
    the CLI's defaults (32 px, conv 16-32-32, trunk 128)."""
    _short_env(monkeypatch)
    by_name = cli.main(["eval", "--checkpoint", "gates_vision_r4", "--eval_episodes", "2"], device="cpu")
    by_path = cli.main(["eval", "--checkpoint", "pyflyt_tpu_torch/assets/policies/gates_vision_r4.npz",
                        "--eval_episodes", "2"], device="cpu")
    assert by_name == by_path
    assert by_name["mean_reward"] > 90.0  # the first gate within 1 s
