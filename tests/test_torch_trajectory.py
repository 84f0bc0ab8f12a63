"""The port's trajectory-following envs, sampler, logger, CLI and archived
slow policy against the JAX package's (``pyflyt_tpu.envs.quadx_mod``).

Each env variant is reset in JAX for 16 envs (noise and gusts off: the
streams differ by design), edited so its events fire, carried into the
port with ``convert.traj_fast_state_from_jax`` / ``traj_slow_state_from_jax``
and stepped in both packages with the same actions: one jitted K-step scan
per variant on the JAX side. Events: lanes 0-2 start 5 mm above the
ground, falling (a collision and the −1000 overwrite); lanes 8-9 two steps
short of the time limit (truncation and the done-freeze); in the fast env
lanes 4-7 get two waypoints 0.2 and 0.4 m from the drone (a reach, the
bonus, the zero leg and the clamp past the last waypoint); in the slow
env's fixed mode lanes 4-7 sit on the first waypoint, lanes 10-11 with the
yaw 10° off (the yaw gate holds) and lanes 12-13 moving at 2 m/s (the
speed gate holds).

Tolerances: the states are rounded to a 1e-3 quantum, so one f32
difference at a rounding boundary moves a component by one quantum:
states within 1e-3 + 1e-5, the normalized obs within 7e-4 (a quantum over
the narrowest bound: angle_diff's π); the rewards within one quantum in
each rounded error term plus the progress term's share of the physics'
f32 differences (see ``REWARD_ATOL``). Flags and counts are exact.
"""

import argparse
import csv
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyflyt_tpu.envs.quadx_mod import QuadXTrajectoryFollowingFastEnv as JFast
from pyflyt_tpu.envs.quadx_mod import QuadXTrajectoryFollowingSlowEnv as JSlow
from pyflyt_tpu.rl import PPO as JPPO
from pyflyt_tpu.rl import PPOConfig as JPPOConfig
from pyflyt_tpu.rl import checkpoint as jckpt
from pyflyt_tpu.utils import trajectory_logger as jlog
from pyflyt_tpu_torch.convert import actor_critic_from_flax, traj_fast_state_from_jax, traj_slow_state_from_jax
from pyflyt_tpu_torch.envs.quadx_mod import QuadXTrajectoryFollowingFastEnv, QuadXTrajectoryFollowingSlowEnv
from pyflyt_tpu_torch.envs.quadx_mod import trajectory_following_fast as tff
from pyflyt_tpu_torch.rl import PPO, PPOConfig
from pyflyt_tpu_torch.rl import checkpoint as tckpt
from pyflyt_tpu_torch.rl.ppo import act_deterministic, action_bounds
from pyflyt_tpu_torch.rl_training import trajectory_following as cli
from pyflyt_tpu_torch.utils import trajectory_logger as tlog

torch.set_num_threads(1)

N = 16
K = 12
FAST = dict(flight_mode=9, max_duration_seconds=2.0)  # 2 waypoints, 160 steps
SLOW = dict(flight_mode=9, max_duration_seconds=2.0)
SLOW_FIXED = dict(flight_mode=9, orn_conv="ENU_FLU", max_duration_seconds=2.0, random_trajectory=False,
                  waypoints=((1.0, 2.0, 3.0, 0.5), (4.0, 2.0, 3.0, -1.0), (4.0, 5.0, 6.0, 2.0)))
STATE_ATOL = 1e-3 + 1e-5
OBS_ATOL = 7e-4
# fast: γ·√3 quanta of ‖ω‖, and the progress term α·100·Δ‖e‖/leg over a leg
# of at least 0.2 m amplifies f32 position differences (≤ 1e-6 m here) by
# 5000; slow: α·√3 + β + γ·√3 quanta
REWARD_ATOL = {"fast": 1e-2, "slow": 1e-2}
ARCHIVE = "docs/artifacts/policies_traj_slow_r4_seed0"
ARCH = dict(feature_sizes=(), pi_sizes=(64, 64, 32, 32), vf_sizes=(64, 64, 32, 32))
RECIPE = dict(num_envs=2048, rollout_steps=128, num_epochs=10, num_minibatches=64, learning_rate=1e-4, clip_eps=0.1,
              init_log_std=-1.6)
R4_ENV = dict(flight_mode=9, control_hz=80, simulate_wind=True, noisy_motors=True, flight_dome_size=100,
              max_duration_seconds=10.0)


def _actions(i, n=N):
    """Normalized mode-9 actions near a hover: small rates, 0.4-0.8 PWM."""
    rng = np.random.default_rng(700 + i)
    a = rng.uniform(-0.1, 0.1, size=(n, 4)).astype(np.float32)
    a[:, 3] = rng.uniform(-0.2, 0.6, size=n)
    return a


def _set_body(st, idx, pos=None, lin_vel=None, quat=None):
    body = st.drone.body
    idx = jnp.asarray(idx)
    if pos is not None:
        body = body.replace(pos=body.pos.at[idx].set(jnp.asarray(pos, jnp.float32)))
    if lin_vel is not None:
        body = body.replace(lin_vel=body.lin_vel.at[idx].set(jnp.asarray(lin_vel, jnp.float32)))
    if quat is not None:
        body = body.replace(quat=body.quat.at[idx].set(jnp.asarray(quat, jnp.float32)))
    return st.replace(drone=st.drone.replace(body=body))


def _common_events(st, max_steps):
    """Lanes 0-2 falling onto the ground (body frame ENU: 5 mm up, 1 m/s
    down); lanes 8-9 two steps short of the time limit."""
    st = _set_body(st, [0, 1, 2], lin_vel=[0.0, 0.0, -1.0])
    body = st.drone.body
    st = st.replace(drone=st.drone.replace(body=body.replace(pos=body.pos.at[jnp.asarray([0, 1, 2]), 2].set(0.005))))
    return st.replace(step_count=st.step_count.at[jnp.asarray([8, 9])].set(max_steps - 2))


def _fast_events(st):
    """Lanes 4-7: waypoints 0.2 and 0.4 m from the drone along the leg of
    its first target (in the env's NED frame)."""
    pos = np.asarray(st.drone.read.view[:, 3])
    wp = np.array(st.waypoints)
    for i in (4, 5, 6, 7):
        d = wp[i, 0] - pos[i]
        d = d / np.linalg.norm(d)
        wp[i, 0], wp[i, 1] = pos[i] + 0.2 * d, pos[i] + 0.4 * d
    wp = jnp.asarray(wp)
    return st.replace(waypoints=wp, target_pos=wp[:, 0], next_pos=wp[:, 1], delta_pos=wp[:, 1] - wp[:, 0])


def _yaw_quat(psi):
    return [0.0, 0.0, math.sin(psi / 2), math.cos(psi / 2)]  # xyzw


def _slow_fixed_events(st):
    """Lanes 4-7 on the first waypoint (ENU) at its yaw, at rest: they
    reach it; lanes 10-11 there 10° off its yaw and lanes 12-13 there at
    2 m/s: the yaw and the speed gates hold."""
    wp0 = list(SLOW_FIXED["waypoints"][0])
    st = _set_body(st, [4, 5, 6, 7, 12, 13], pos=wp0[:3], quat=_yaw_quat(wp0[3]), lin_vel=[0.0, 0.0, 0.0])
    st = _set_body(st, [10, 11], pos=wp0[:3], quat=_yaw_quat(wp0[3] + math.radians(10)), lin_vel=[0.0, 0.0, 0.0])
    return _set_body(st, [12, 13], lin_vel=[2.0, 0.0, 0.0])


def _run_jax(env, edit):
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    st, _ = jax.jit(jax.vmap(env.reset))(keys)
    st = edit(_common_events(st, env.max_steps))
    acts = jnp.asarray(np.stack([_actions(i) for i in range(K)]))

    def body(s, a):
        s, out = jax.vmap(env.step)(s, a)
        return s, (out, s)

    _, (outs, states) = jax.jit(lambda s, a: jax.lax.scan(body, s, a))(st, acts)
    return jax.tree.map(np.asarray, st), jax.tree.map(np.asarray, outs), jax.tree.map(np.asarray, states)


@pytest.fixture(scope="module")
def runs():
    return {
        "fast": _run_jax(JFast(**FAST), _fast_events),
        "slow": _run_jax(JSlow(**SLOW), lambda s: s),
        "slow_fixed": _run_jax(JSlow(**SLOW_FIXED), _slow_fixed_events),
    }


CASES = {
    "fast": (QuadXTrajectoryFollowingFastEnv, FAST, traj_fast_state_from_jax, "state19"),
    "slow": (QuadXTrajectoryFollowingSlowEnv, SLOW, traj_slow_state_from_jax, "state16"),
    "slow_fixed": (QuadXTrajectoryFollowingSlowEnv, SLOW_FIXED, traj_slow_state_from_jax, "state16"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_env_matches_jax_lane_by_lane(runs, case):
    cls, kw, convert, state_key = CASES[case]
    env = cls(device="cpu", **kw)
    st0, outs, states = runs[case]
    st = convert(st0, torch.Generator().manual_seed(0), "cpu")
    tol = REWARD_ATOL[case.split("_")[0]]
    for i in range(K):
        st, out = env.step(st, torch.from_numpy(_actions(i)))
        where = f"{case} step {i}"
        np.testing.assert_allclose(getattr(st, state_key).numpy(), getattr(states, state_key)[i], atol=STATE_ATOL,
                                   err_msg=where)
        np.testing.assert_allclose(out.obs.numpy(), outs.obs[i], atol=OBS_ATOL, err_msg=where)
        np.testing.assert_allclose(out.reward.numpy(), outs.reward[i], atol=tol, err_msg=where)
        for flag in ("termination", "truncation"):
            np.testing.assert_array_equal(getattr(out, flag).numpy(), getattr(outs, flag)[i], err_msg=where)
        for key in ("collision", "num_targets_reached", "out_of_bounds"):
            np.testing.assert_array_equal(out.info[key].numpy(), outs.info[key][i], err_msg=f"{where} {key}")
    # the events fired, in JAX and in the port alike
    assert outs.termination[-1][:3].all() and (outs.reward[:, :3] == -1000.0).any()
    assert outs.truncation[-1][8:10].all() and not outs.truncation[1][8:10].any()
    if case == "fast":
        ntr = outs.info["num_targets_reached"]
        assert (ntr[-1][4:8] == 2).all() and (ntr[0][4:8] >= 1).all()  # reached, then clamped at the last
        assert (outs.reward[:, 4:8] > 900.0).any()  # the reach bonus
    if case == "slow_fixed":
        ntr = outs.info["num_targets_reached"]
        assert (ntr[0][4:8] == 1).all() and (ntr[0][10:14] == 0).all()


def test_fast_update_tracking_holds_angle_diff_and_zeroes_a_zero_leg():
    """``angle_diff`` keeps its value below 0.01 m/s and is 0 on a zero
    leg, in both packages (one jitted vmap of the JAX update)."""
    env_j = JFast(**FAST)
    st, _ = jax.jit(jax.vmap(env_j.reset))(jax.random.split(jax.random.PRNGKey(4), 4))
    view = np.array(st.drone.read.view)
    view[:, 2] = [[0.005, 0.0, 0.0], [0.0, 0.006, 0.0], [1.0, 2.0, 0.0], [3.0, 0.0, 1.0]]  # slow, slow, fast, fast
    wp = np.array(st.waypoints)
    wp[3, 1] = wp[3, 0]  # lane 3: a zero leg
    st = st.replace(drone=st.drone.replace(read=st.drone.read.replace(view=jnp.asarray(view))),
                    angle_diff=jnp.asarray([0.7, 1.3, 0.2, 0.4], jnp.float32), waypoints=jnp.asarray(wp),
                    next_pos=jnp.asarray(wp[:, 1]), delta_pos=jnp.asarray(wp[:, 1] - wp[:, 0]))
    ref, _ = jax.jit(jax.vmap(env_j._update_tracking))(st)
    env = QuadXTrajectoryFollowingFastEnv(device="cpu", **FAST)
    got, _ = env.update_tracking(traj_fast_state_from_jax(jax.tree.map(np.asarray, st), None, "cpu"))
    np.testing.assert_allclose(got.angle_diff.numpy(), np.asarray(ref.angle_diff), atol=1e-6)
    np.testing.assert_allclose(got.state19.numpy(), np.asarray(ref.state19), atol=STATE_ATOL)
    assert got.angle_diff[0] == pytest.approx(0.7) and got.angle_diff[1] == pytest.approx(1.3)
    assert float(got.angle_diff[3]) == 0.0


def test_sampler_rules_on_jax_uniforms():
    """The chained sampler and the slow env's one-waypoint rule, fed the
    JAX env's own U(−10, 10) draws, give its waypoints bit for bit, from
    starts that fire the dome reflections and the NED z condition."""
    env = JFast(flight_dome_size=5.0, max_duration_seconds=12.0)
    starts = jnp.asarray([[4.5, -4.5, -4.5], [0.0, 0.0, -1.2], [-3.0, 2.0, -0.5], [1.0, 1.0, -2.0]], jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(9), 4)

    @jax.jit
    def draws(key, start):
        ks = jax.random.split(key, env.num_of_targets)
        u = jax.vmap(lambda k: jax.random.uniform(k, (3,), jnp.float32, -10.0, 10.0))(ks)
        return u, env._sample_waypoints(key, start), JSlow._next_waypoint(JSlow(flight_dome_size=5.0), key, start)

    u, wps, one = jax.vmap(draws)(keys, starts)
    got = tff.chain_waypoints(torch.tensor(np.asarray(starts)), torch.tensor(np.asarray(u)), 5.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(wps))
    u0 = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (3,), jnp.float32, -10.0, 10.0))(keys))
    got1 = tff.next_waypoint(torch.tensor(np.asarray(starts)), torch.tensor(u0), 5.0)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(one))
    # every step moves each axis by at least 1; the first draws fire the
    # dome reflection and the NED z condition
    wps = np.concatenate([np.asarray(starts)[:, None], np.asarray(wps)], axis=1)
    assert (np.abs(np.diff(wps, axis=1)) >= 1.0).all()
    first = np.asarray(starts) + tff.push_out_of_unit(torch.from_numpy(np.asarray(u)[:, 0])).numpy()
    assert (np.abs(first[:, :2]) > 5.0).any() and (first[:, 2] > -1.0).any()


def test_fast_logger_columns_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    rows = [(i, rng.normal(size=19), rng.uniform(size=4), float(rng.normal())) for i in range(5)]
    ours = tlog.TrajectoryFastLogger(str(tmp_path / "t"), make_plots=False)
    ref = jlog.TrajectoryFastLogger(str(tmp_path / "j"), make_plots=False)
    for r in rows:
        ours.add(*r)
        ref.add(*r)
    assert ours.buffer == ref.buffer and tlog.FAST_COLUMNS == jlog.FAST_COLUMNS and len(tlog.FAST_COLUMNS) == 33
    assert all(row[27] == 0.0 for row in ours.buffer)  # maximum_velocity
    path = ours.log_episode()
    with open(path) as f:
        table = list(csv.reader(f))
    assert table[0] == tlog.FAST_COLUMNS and len(table) == 6 and all(len(r) == 33 for r in table)
    assert tlog.TrajectorySlowLogger.__name__ == "HoveringLogger"


def test_eval_pid_expert_raises_naming_item_6(tmp_path):
    """Mode 10 is ported: the expert flies a 0.2 s episode (17 steps) of
    each fixed scenario in mode 10 and logs it."""
    for scenario in (1, 2, 3):
        log_dir = str(tmp_path / f"s{scenario}")
        result = cli.main(["eval-pid-expert", "--scenario", str(scenario), "--max_duration_seconds", "0.2",
                           "--log_dir", log_dir], device="cpu")
        assert result["episode_length"] == 17 and np.isfinite(result["episode_reward"])
        with open(os.path.join(log_dir, os.listdir(log_dir)[0])) as f:
            assert len(list(csv.reader(f))) == 1 + 17


def _archive():
    env = JSlow(**R4_ENV)
    ppo = JPPO(env, JPPOConfig(**RECIPE, **ARCH))
    init = ppo.network.init(jax.random.PRNGKey(0), jnp.zeros((1, 16)))
    return ppo, jax.tree.map(np.asarray, jckpt.restore_params(ARCHIVE, init))


def test_slow_npz_equals_its_orbax_source_and_acts_as_jax_does(runs):
    ppo, params = _archive()
    net = tckpt.load_policy_npz("traj_slow_r4_seed0", device="cpu")
    ref = actor_critic_from_flax(params, device="cpu")
    for (k, a), (k2, b) in zip(net.state_dict().items(), ref.state_dict().items()):
        assert k == k2
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    assert [lin.out_features for lin in net.pi_trunk.layers] == [64, 64, 32, 32] and net.obs_dim == 16
    obs = np.concatenate([runs["slow"][1].obs[i] for i in (0, 5, 11)])
    low, high = action_bounds(QuadXTrajectoryFollowingSlowEnv(device="cpu", **R4_ENV), torch.device("cpu"))
    got = act_deterministic(net, torch.tensor(obs), low, high)
    want = ppo.act_deterministic(jax.tree.map(jnp.asarray, params), jnp.asarray(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert np.abs(np.asarray(want)).max() > 0.05  # a trained policy, not the 0.01-gain init


@pytest.mark.parametrize("refresh", [0, 4])
@pytest.mark.parametrize("variant", ["fast", "slow"])
def test_ppo_trains_on_both_envs_fused_and_exact(variant, refresh):
    """The fused PPO path (the twins of K4n, K3n and K2n on the CPU) on
    the reference network, through the envs' ``native_batch`` adapter with
    the exact (refresh 0) and the cached auto-reset, and a time limit
    inside the rollout."""
    cls = QuadXTrajectoryFollowingFastEnv if variant == "fast" else QuadXTrajectoryFollowingSlowEnv
    env = cls(device="cpu", flight_mode=9, max_duration_seconds=0.1)  # 8 steps an episode
    cfg = PPOConfig(num_envs=8, rollout_steps=12, num_epochs=2, num_minibatches=2, fused_sgd=True,
                    fused_rollout_forward=True, cached_reset_refresh=refresh, **ARCH)
    ppo = PPO(env, cfg)
    runner = ppo.init(0)
    before = [p.detach().clone() for p in runner.network.parameters()]
    runner, metrics = ppo.train_iteration(runner)
    assert all(math.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["mean_episode_done"]) > 0  # episodes ended and were reset inside the rollout
    assert any(not torch.equal(a, b) for a, b in zip(before, runner.network.parameters()))
    assert int(runner.opt_state.count) == cfg.num_epochs * cfg.num_minibatches
    assert runner.obs.shape == (8, env.obs_size)


def test_cli_train_then_eval_one_and_averaged_checkpoints(tmp_path):
    common = ["--variant", "slow", "--max_duration_seconds", "0.1"]
    log = str(tmp_path / "run")
    cli.main(["train", *common, "--num_envs", "8", "--rollout_steps", "8", "--n_epochs", "1", "--num_minibatches", "2",
              "--total_timesteps", "128", "--eval_every_updates", "1", "--eval_episodes", "2", "--log_dir", log],
             device="cpu")
    ckpts = sorted(os.path.join(log, f) for f in os.listdir(log) if f.startswith("best_model_"))
    assert ckpts
    one = cli.main(["eval", *common, "--checkpoint", ckpts[-1], "--episodes", "2", "--log_dir", str(tmp_path / "e")],
                   device="cpu")
    two = cli.main(["eval", *common, "--checkpoint", ckpts[-1], ckpts[-1], "--episodes", "2"], device="cpu")
    assert one == two and one["mean_length"] > 0
    with open(tmp_path / "e" / "evaluation_results_0.csv") as f:
        assert len(next(csv.reader(f))) == 34
    with pytest.raises(NotImplementedError, match="item 24"):
        cli.cmd_train(argparse.Namespace(**{**vars(argparse.Namespace(
            variant="fast", control_hz=80, flight_mode=9, noisy_motors=False, simulate_wind=False,
            flight_dome_size=100.0, max_duration_seconds=0.1, seed=0, num_envs=2, rollout_steps=2, n_epochs=1,
            num_minibatches=1, learning_rate=3e-4, clip_eps=0.2, init_log_std=0.0, log_std_min=None,
            log_std_max=None, cached_reset_refresh=0, init_from=None, feature_sizes=[], total_timesteps=4,
            eval_every_updates=1, eval_episodes=1, param_ema=0.0, early_stop_patience=0, log_dir=None,
            use_mesh=True, device="cpu"))}))


def test_modes_minus_one_and_ten_raise_naming_item_6():
    """Both envs take modes -1 and 10 (ported) beside 7 and 8: three noise-off
    steps each; in mode -1 the motors get the denormalized action as raw
    PWM, in mode 10 the unnormalized setpoint flies ga_pid."""
    for cls in (QuadXTrajectoryFollowingFastEnv, QuadXTrajectoryFollowingSlowEnv):
        for mode in (-1, 10):
            env = cls(device="cpu", flight_mode=mode, noisy_motors=False)
            st, obs = env.reset(4, torch.Generator().manual_seed(mode + 2))
            for i in range(3):
                v = st.drone.read.view  # mode 10 holds [x, y, psi, z]
                a = torch.from_numpy(_actions(i, 4)) if mode == -1 else torch.stack(
                    [v[:, 3, 0], v[:, 3, 1], v[:, 1, 2], v[:, 3, 2]], dim=-1)
                st, out = env.step(st, a)
                assert torch.isfinite(out.obs).all() and torch.isfinite(out.reward).all()
            if mode == -1:
                torch.testing.assert_close(st.drone.pwm, (a + 1.0) / 2.0, rtol=0.0, atol=1e-7)
            else:
                assert (st.drone.pwm > 0.0).all()
        cls(device="cpu", flight_mode=7)
        cls(device="cpu", flight_mode=8)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for cls in (QuadXTrajectoryFollowingFastEnv, QuadXTrajectoryFollowingSlowEnv):
        with pytest.raises(Exception, match="(?i)cuda"):
            cls()
