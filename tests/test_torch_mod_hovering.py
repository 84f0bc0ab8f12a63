"""The port's mod-hovering envs, expert, logger, PPO wiring and CLI against
the JAX package's ``pyflyt_tpu.envs.quadx_mod``.

The recipe's env (mode 9, NED_FRD, 80 Hz, a GaussianWind base per env;
gusts and motor noise off, the streams differ by design) is reset in JAX
for 16 envs, carried into the port with ``convert.mod_hover_state_from_jax``
and stepped in both packages with the same actions. Four envs start just
above the ground, falling, so the collision path is exercised.

Tolerances: the 16-dim state is rounded to a 1e-3 quantum, so one f32
difference at a rounding boundary moves a component by one quantum:
state16 within 1e-3 + 1e-5, the normalized obs within 4e-4 (a quantum over
the narrowest bound, 2π), the reward within 1e-2 (one quantum in each
error term: α·√3 + β·√3 + γ + δ·√3 quanta). Flags are exact. The packed
env follows the plain env on lanes that did not collide (its contact is
detection-grade, which only shows after a contact) and the JAX packed env
(Pallas in interpret mode, 8 envs) on every lane.
"""

import argparse
import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyflyt_tpu.envs.quadx_mod import QuadXModHoveringEnv as JModEnv
from pyflyt_tpu.envs.quadx_mod import hovering_pid_expert as j_expert
from pyflyt_tpu.envs.quadx_mod import packed_hovering as jph
from pyflyt_tpu.envs.quadx_mod.packed_hovering import PackedQuadXModHoveringEnv as JPackedModEnv
from pyflyt_tpu.ops import pallas_quadx
from pyflyt_tpu.utils import hovering_logger as jlog
from pyflyt_tpu_torch.convert import mod_hover_state_from_jax
from pyflyt_tpu_torch.envs.base import autoreset_step
from pyflyt_tpu_torch.envs.quadx_mod import (
    PackedQuadXModHoveringEnv,
    QuadXModHoveringEnv,
    hovering_pid_expert,
    trajectory_pid_expert,
)
from pyflyt_tpu_torch.ops import cuda_quadx as cq
from pyflyt_tpu_torch.rl import PPO, PPOConfig
from pyflyt_tpu_torch.rl_training import hovering as cli
from pyflyt_tpu_torch.utils import hovering_logger as tlog

torch.set_num_threads(1)

N = 16
N_PACKED_JAX = 8
STEPS = 15
RECIPE = dict(flight_mode=9, orn_conv="NED_FRD", control_hz=80, simulate_wind=True)
QUIET = dict(max_gust_strength=0.0, noisy_motors=False)
S16_ATOL = 1e-3 + 1e-5
OBS_ATOL = 4e-4
REWARD_ATOL = 1e-2


def _actions(i, n=N):
    """Normalized mode-9 actions near a hover: small rates, 0.4-0.8 PWM."""
    rng = np.random.default_rng(500 + i)
    a = rng.uniform(-0.1, 0.1, size=(n, 4)).astype(np.float32)
    a[:, 3] = rng.uniform(-0.2, 0.6, size=n)
    return a


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _ground_some(st):
    """Lanes 0-2 (and 8) start 5 mm above the ground, falling at 1 m/s: they
    collide in the first step, so the collision path is exercised."""
    body = st.drone.body
    idx = jnp.asarray([0, 1, 2, 8])
    body = body.replace(pos=body.pos.at[idx, 2].set(0.005), lin_vel=body.lin_vel.at[idx, 2].set(-1.0))
    return st.replace(drone=st.drone.replace(body=body))


@pytest.fixture(scope="module")
def reference():
    env = JModEnv(**RECIPE, **QUIET)
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    st, obs = jax.jit(jax.vmap(env.reset))(keys)
    st = _ground_some(st)
    st0 = _np_tree(st)
    step = jax.jit(jax.vmap(env.step))
    traj = []
    for i in range(STEPS):
        st, out = step(st, jnp.asarray(_actions(i)))
        traj.append({
            "obs": np.asarray(out.obs), "reward": np.asarray(out.reward),
            "termination": np.asarray(out.termination), "truncation": np.asarray(out.truncation),
            "collision": np.asarray(out.info["collision"]), "state16": np.asarray(st.state16),
        })
    return {"state": st0, "obs": np.asarray(obs), "traj": traj, "keys": keys}


def _port_env(**kw):
    return QuadXModHoveringEnv(**{**RECIPE, **QUIET, "device": "cpu", **kw})


def _carried(reference, n=N):
    tree = jax.tree.map(lambda a: a[:n], reference["state"])
    return mod_hover_state_from_jax(tree, torch.Generator().manual_seed(0), "cpu")


def test_carried_reset_gives_the_jax_obs(reference):
    env = _port_env()
    st = _carried(reference)
    s16 = env.compute_state16(st.drone.read.view, st.target_pos, st.target_psi)
    np.testing.assert_allclose(s16.numpy(), reference["state"].state16, atol=S16_ATOL)
    np.testing.assert_allclose(env.normalize_state16(st.state16).numpy(), reference["obs"], atol=1e-6)
    np.testing.assert_array_equal(st.wind.base_wind.numpy(), reference["state"].wind.base_wind)
    assert st.wind.orn_conv == "NED_FRD" and st.wind.max_gust == 0.0


def _check_step(i, out, state16, ref, lanes=slice(None)):
    np.testing.assert_allclose(out.obs[lanes].numpy(), ref["obs"][lanes], atol=OBS_ATOL, err_msg=f"step {i} obs")
    np.testing.assert_allclose(state16[lanes].numpy(), ref["state16"][lanes], atol=S16_ATOL, err_msg=f"step {i} s16")
    np.testing.assert_allclose(out.reward.numpy(), ref["reward"], atol=REWARD_ATOL, err_msg=f"step {i} reward")
    for k in ("termination", "truncation"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), ref[k], err_msg=f"step {i} {k}")
    np.testing.assert_array_equal(out.info["collision"].numpy(), ref["collision"], err_msg=f"step {i} collision")


def test_plain_env_matches_jax(reference):
    """Obs, state16, reward and flags over 15 steps, collisions included
    (both packages resolve the contact in full)."""
    env = _port_env()
    st = _carried(reference)
    for i, ref in enumerate(reference["traj"]):
        st, out = env.step(st, torch.from_numpy(_actions(i)))
        _check_step(i, out, st.state16, ref)
    assert reference["traj"][-1]["termination"].any() and not reference["traj"][-1]["termination"].all()


def test_packed_env_matches_plain_env(reference):
    """The generic kernel's twin under the packed env, from the same carried
    state: every lane until it collides, the flags and rewards of all."""
    env = _port_env()
    packed_env = PackedQuadXModHoveringEnv(env)
    sp = _carried(reference)
    sk = packed_env.from_state(_carried(reference))
    np.testing.assert_array_equal(sk.packed[cq._WBASE : cq._WBASE + 3].T.numpy(), sp.wind.base_enu().numpy())
    for i in range(STEPS):
        a = torch.from_numpy(_actions(i))
        sp, op = env.step(sp, a)
        sk, ok = packed_env.step(sk, a)
        live = ~op.info["collision"]
        np.testing.assert_allclose(ok.obs[live].numpy(), op.obs[live].numpy(), atol=OBS_ATOL)
        np.testing.assert_allclose(ok.reward.numpy(), op.reward.numpy(), atol=REWARD_ATOL)
        np.testing.assert_array_equal(ok.termination.numpy(), op.termination.numpy())
        np.testing.assert_array_equal(sk.step_count.numpy(), sp.step_count.numpy())
    assert op.termination.any()


def test_packed_env_matches_jax_packed_env(reference):
    """The JAX packed env (Pallas ``packed_step`` in interpret mode, 8 envs)
    and the port's on the same state, packed by each package: obs, reward,
    flags and the packed drone rows, every lane (both contacts are
    detection-grade)."""
    jenv = JPackedModEnv(JModEnv(**RECIPE, **QUIET))
    st8 = jax.tree.map(lambda a: jnp.asarray(a[:N_PACKED_JAX]), reference["state"])
    packed = pallas_quadx.pack_state(st8.drone, 9)
    packed = packed.at[pallas_quadx._WBASE : pallas_quadx._WBASE + 3].set(jph._fold(jenv._base_rows(st8.wind).T))
    js = jph.PackedModHoverState(
        packed=packed, target_pos=st8.target_pos, target_psi=st8.target_psi, step_count=st8.step_count,
        termination=st8.termination, truncation=st8.truncation, collision=st8.collision, state16=st8.state16,
        key=jax.random.PRNGKey(0),
    )
    jstep = jax.jit(jenv.step)
    env = PackedQuadXModHoveringEnv(_port_env())
    ts = env.from_state(_carried(reference, N_PACKED_JAX))
    np.testing.assert_array_equal(ts.packed.numpy(), np.asarray(js.packed).reshape(cq.ROWS, N_PACKED_JAX))
    for i in range(STEPS):
        a = _actions(i, N_PACKED_JAX)
        js, jo = jstep(js, jnp.asarray(a))
        ts, to = env.step(ts, torch.from_numpy(a))
        np.testing.assert_allclose(to.obs.numpy(), np.asarray(jo.obs), atol=OBS_ATOL, err_msg=f"step {i}")
        np.testing.assert_allclose(to.reward.numpy(), np.asarray(jo.reward), atol=REWARD_ATOL)
        np.testing.assert_array_equal(to.termination.numpy(), np.asarray(jo.termination))
        np.testing.assert_array_equal(to.truncation.numpy(), np.asarray(jo.truncation))
        rows = np.asarray(js.packed).reshape(cq.ROWS, N_PACKED_JAX)
        np.testing.assert_allclose(ts.packed[: cq._CON + 1].numpy(), rows[: cq._CON + 1], atol=2e-4)
        np.testing.assert_array_equal(ts.packed[cq._WBASE : cq._WBASE + 3].numpy(), rows[cq._WBASE : cq._WBASE + 3])


def test_obs_and_action_normalization_match_jax():
    jenv = JModEnv(**RECIPE)
    env = _port_env()
    rng = np.random.default_rng(1)
    s16 = (rng.normal(size=(32, 16)) * np.array([200, 200, 200, 80, 80, 80, 4, 4, 4, 200, 200, 200, 30, 30, 30, 4])
           ).astype(np.float32)
    np.testing.assert_allclose(env.normalize_state16(torch.from_numpy(s16)).numpy(),
                               np.asarray(jenv._normalize_obs(jnp.asarray(s16))), atol=1e-6)
    a = rng.uniform(-1.5, 1.5, size=(32, 4)).astype(np.float32)
    np.testing.assert_allclose(env.denormalize_action(torch.from_numpy(a)).numpy(),
                               np.asarray(jenv._denormalize_action(jnp.asarray(a))), atol=1e-7)
    for mode in (8, 9):
        assert [b.tolist() for b in _port_env(flight_mode=mode).action_bounds()] == \
            [b.tolist() for b in JModEnv(flight_mode=mode).action_bounds()]
    enu = _port_env(orn_conv="ENU_FLU")
    np.testing.assert_array_equal(enu.obs_bounds[0], JModEnv(flight_mode=9).obs_bounds[0])


def test_rounding_matches_jax():
    """3-decimal rounding, halves to even as ``jnp.round``."""
    x = np.array([0.0005, 0.0015, -0.0025, 1.23449, 1.2345, -7.0004, 99.9996], np.float32)
    np.testing.assert_array_equal(QuadXModHoveringEnv.round3(torch.from_numpy(x)).numpy(),
                                  np.asarray(JModEnv(flight_mode=9)._round3(jnp.asarray(x))))


def test_truncation_on_the_count_before_the_increment_and_freeze():
    """Truncation fires on the step whose count before the increment is
    max_steps; after it the env is frozen and pays 0."""
    env = _port_env(max_duration_seconds=0.05)  # 4 steps
    st, _ = env.reset(3, torch.Generator().manual_seed(1))
    st = dataclasses.replace(st, step_count=torch.full((3,), env.max_steps - 1, dtype=torch.int32))
    hover = torch.zeros(3, 4)
    st, out = env.step(st, hover)
    assert not out.truncation.any()
    st, out = env.step(st, hover)
    assert out.truncation.all() and (out.reward != 0).all()
    frozen = st.drone.body.pos.clone()
    st, out = env.step(st, hover)
    assert (out.reward == 0).all() and torch.equal(st.drone.body.pos, frozen)
    assert (st.step_count == env.max_steps + 1).all()


def test_dead_position_error_termination_stays_dead():
    """A drone 60 m from its target is not terminated (the reference's 20 m
    check is dead code)."""
    env = _port_env(randomize_start=False, target_pos=(60.0, 0.0, -10.0), start_pos=((0.0, 0.0, -10.0),))
    st, _ = env.reset(2, torch.Generator().manual_seed(0))
    st, out = env.step(st, torch.zeros(2, 4))
    assert float(st.state16[0, 12:15].norm()) > 20 and not out.termination.any()
    assert out.reward[0] < 35.0 - 2.0 * 59


def test_constructor_quirk_and_unported_modes(reference):
    """The constructor's default mode 0 is outside the admitted modes; modes
    -1 (raw PWM) and 10 (ga_pid), once unported, construct and step in
    parity with the JAX env for 5 noise-off steps from the carried reset
    (mode 10 flying the PID expert's setpoints)."""
    with pytest.raises(AssertionError):
        JModEnv()
    with pytest.raises(ValueError, match="only -1, 7, 8, 9, 10"):
        QuadXModHoveringEnv(device="cpu")
    assert QuadXModHoveringEnv(flight_mode=7, device="cpu").flight_mode == 7
    for mode in (-1, 10):
        jenv, env = JModEnv(**{**RECIPE, **QUIET, "flight_mode": mode}), _port_env(flight_mode=mode)
        jstep = jax.jit(jax.vmap(jenv.step))
        jst = jax.tree.map(jnp.asarray, reference["state"])
        st = _carried(reference)
        for i in range(5):
            a = _actions(i) if mode == -1 else np.array(j_expert(jst.state16))
            jst, jout = jstep(jst, jnp.asarray(a))
            st, out = env.step(st, torch.from_numpy(a))
            ref = {"obs": np.asarray(jout.obs), "state16": np.asarray(jst.state16), "reward": np.asarray(jout.reward),
                   "termination": np.asarray(jout.termination), "truncation": np.asarray(jout.truncation),
                   "collision": np.asarray(jout.info["collision"])}
            _check_step(i, out, st.state16, ref)
        np.testing.assert_allclose(st.drone.pwm.numpy(), np.asarray(jst.drone.pwm), atol=1e-5)
        assert out.termination.any() and not out.termination.all()


def test_reset_draws_follow_the_recipe():
    env = _port_env(noisy_motors=True, max_gust_strength=7.0)
    st, obs = env.reset(512, torch.Generator().manual_seed(3))
    tp = st.target_pos
    assert (tp[:, :2].abs() <= 100).all() and (tp[:, 2] <= -1).all() and (tp[:, 2] >= -100).all()
    lin_pos = st.drone.read.view[:, 3]
    assert ((lin_pos - tp).abs() <= 10.0 + 1e-3).all()
    assert (st.drone.read.view[:, 1, :2].abs() <= 0.175).all()
    b = st.wind.base_wind
    assert (b[:, :2].abs() <= 7).all() and (b[:, 2].abs() <= 2).all() and b.std(0).min() > 0.5
    assert obs.shape == (512, 16) and (obs.abs() <= 1).all()
    np.testing.assert_array_equal(st.state16.numpy(), env.round3(st.state16).numpy())
    with pytest.raises(ValueError, match="Generator"):
        env.reset(2, None)


def test_pid_experts_match_jax():
    obs = np.random.default_rng(4).normal(size=(32, 16)).astype(np.float32) * 5
    ref = np.asarray(j_expert(jnp.asarray(obs)))
    np.testing.assert_allclose(hovering_pid_expert(torch.from_numpy(obs)).numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(trajectory_pid_expert(torch.from_numpy(obs)).numpy(), ref, atol=1e-6)


def test_logger_writes_the_34_jax_columns(tmp_path):
    assert tlog.COLUMNS == jlog.COLUMNS and len(tlog.COLUMNS) == 34
    rng = np.random.default_rng(5)
    rows = [(i, rng.normal(size=3), float(rng.normal()), rng.normal(size=16), rng.uniform(size=4), float(rng.normal()))
            for i in range(3)]
    paths = []
    for mod, d in ((tlog, tmp_path / "t"), (jlog, tmp_path / "j")):
        lg = mod.HoveringLogger(str(d), make_plots=False)
        for r in rows:
            lg.add(*r)
        paths.append(lg.log_episode())
    with open(paths[0]) as f:
        got = list(csv.reader(f))
    with open(paths[1]) as f:
        ref = list(csv.reader(f))
    assert got[0] == tlog.COLUMNS and len(got) == 4
    np.testing.assert_allclose(np.array(got[1:], float), np.array(ref[1:], float), rtol=1e-12)


# ---------------------------------------------------------------------------
# auto-reset
# ---------------------------------------------------------------------------


def _clone_gen(g):
    c = torch.Generator()
    c.set_state(g.get_state())
    return c


def test_packed_autoreset_replaces_exactly_the_done_lanes(reference):
    """The exact auto-reset: done lanes (the grounded envs collide at once)
    take the batch reset drawn right after the step; the others keep
    the step's state; ``terminal_observation`` is the pre-reset obs."""
    env = PackedQuadXModHoveringEnv(_port_env())
    st = env.from_state(_carried(reference))
    g_replay = _clone_gen(st.generator)
    a = torch.from_numpy(_actions(0))
    post, out = env.autoreset_step(st, a)
    stepped, ref_out = env.step(dataclasses.replace(st, generator=g_replay), a)
    fresh, fresh_obs = env.reset(N, g_replay)
    done = ref_out.termination | ref_out.truncation
    assert done.any() and (~done).any()
    np.testing.assert_array_equal(post.packed[:, done].numpy(), fresh.packed[:, done].numpy())
    np.testing.assert_array_equal(post.packed[:, ~done].numpy(), stepped.packed[:, ~done].numpy())
    np.testing.assert_array_equal(out.obs[done].numpy(), fresh_obs[done].numpy())
    np.testing.assert_array_equal(out.obs[~done].numpy(), ref_out.obs[~done].numpy())
    np.testing.assert_array_equal(out.info["terminal_observation"].numpy(), ref_out.obs.numpy())
    assert not post.termination.any() and (post.step_count[done] == 0).all()
    np.testing.assert_array_equal(out.termination.numpy(), ref_out.termination.numpy())


def test_plain_autoreset_replaces_exactly_the_done_lanes(reference):
    env = _port_env()
    st = _carried(reference)
    g_replay = _clone_gen(st.generator)
    a = torch.from_numpy(_actions(0))
    post, out = autoreset_step(env, st, a)
    stepped, ref_out = env.step(dataclasses.replace(st, generator=g_replay), a)
    fresh, fresh_obs = env.reset(N, g_replay)
    done = ref_out.termination | ref_out.truncation
    assert done.any() and (~done).any()
    pos = post.drone.body.pos
    np.testing.assert_array_equal(pos[done].numpy(), fresh.drone.body.pos[done].numpy())
    np.testing.assert_array_equal(pos[~done].numpy(), stepped.drone.body.pos[~done].numpy())
    np.testing.assert_array_equal(post.wind.base_wind[done].numpy(), fresh.wind.base_wind[done].numpy())
    np.testing.assert_array_equal(out.obs[done].numpy(), fresh_obs[done].numpy())
    np.testing.assert_array_equal(out.info["terminal_observation"].numpy(), ref_out.obs.numpy())


def test_packed_cached_autoreset(reference):
    """Done lanes take their cached reset; the cache regenerates every
    ``refresh`` steps."""
    env = PackedQuadXModHoveringEnv(_port_env())
    ars, _ = env.cached_autoreset_init(N, torch.Generator().manual_seed(2))
    ars.env_state = env.from_state(_carried(reference))
    pre = ars
    a = torch.from_numpy(_actions(0))
    stepped, ref_out = env.step(dataclasses.replace(pre.env_state, generator=_clone_gen(pre.env_state.generator)), a)
    ars, out = env.cached_autoreset_step(ars, a, refresh=3)
    done = ref_out.termination | ref_out.truncation
    assert done.any() and (~done).any()
    p = ars.env_state.packed
    np.testing.assert_array_equal(p[:, done].numpy(), pre.cache_state.packed[:, done].numpy())
    np.testing.assert_array_equal(p[:, ~done].numpy(), stepped.packed[:, ~done].numpy())
    np.testing.assert_array_equal(out.obs[done].numpy(), pre.cache_obs[done].numpy())
    np.testing.assert_array_equal(out.info["terminal_observation"].numpy(), ref_out.obs.numpy())
    caches = [ars.cache_state]
    for _ in range(4):
        ars, _ = env.cached_autoreset_step(ars, torch.zeros(N, 4), refresh=3)
        caches.append(ars.cache_state)
    assert caches[0] is caches[1] and caches[1] is not caches[2] and caches[2] is caches[4]
    assert ars.step_idx == 5


# ---------------------------------------------------------------------------
# PPO and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("refresh", [0, 64])
@pytest.mark.parametrize("kind", ["packed", "plain"])
def test_ppo_iteration_on_the_mod_env(kind, refresh):
    """One PPO iteration at 64 envs, exact (refresh 0) and cached auto-reset:
    the env's own methods for the packed env, ``envs/base`` for the plain."""
    base = QuadXModHoveringEnv(**RECIPE, device="cpu")
    env = PackedQuadXModHoveringEnv(base) if kind == "packed" else base
    tp = PPO(env, PPOConfig(num_envs=64, rollout_steps=8, num_epochs=2, num_minibatches=4,
                            cached_reset_refresh=refresh, feature_sizes=(32, 32), init_log_std=-1.6))
    runner = tp.init(0)
    before = [p.detach().clone() for p in runner.network.parameters()]
    runner, metrics = tp.train_iteration(runner)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert max((a - b).abs().max().item() for a, b in zip(before, runner.network.parameters())) > 0
    assert runner.obs.shape == (64, 16)


def test_cli_train_eval_and_the_pid_expert(tmp_path):
    common = ["--device", "cpu", "--flight_mode", "9", "--max_duration_seconds", "0.1"]
    log_dir = str(tmp_path / "run")
    runner = cli.main(["train", *common, "--num_envs", "16", "--rollout_steps", "4", "--n_epochs", "1",
                       "--num_minibatches", "2", "--total_timesteps", "64", "--eval_every_updates", "1",
                       "--eval_episodes", "2", "--layer_size", "16", "--log_dir", log_dir])
    assert runner.update_idx == 1
    best = [n for n in os.listdir(log_dir) if n.startswith("best_model_")]
    assert len(best) == 1 and "metrics.jsonl" in os.listdir(log_dir)
    eval_dir = str(tmp_path / "eval")
    total, length = cli.main(["eval", *common, "--checkpoint", os.path.join(log_dir, best[0]),
                              "--layer_size", "16", "--log_dir", eval_dir])
    assert length == 9 and np.isfinite(total)  # 80 Hz x 0.1 s, truncated on call max_steps + 1
    with open(os.path.join(eval_dir, "evaluation_results_0.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == tlog.COLUMNS and len(rows) == 1 + length
    assert all(len(r) == 34 for r in rows)
    # the PID expert in mode 7 (the default), through models/quadx's NED
    # position cascade, and in mode 10 (ga_pid): one 0.1 s episode (9 steps) each
    total, length = cli.main(["eval-pid-expert", *common])
    assert length == 9 and np.isfinite(total)
    total10, length10 = cli.main(["eval-pid-expert", *common, "--expert_mode", "10"])
    assert length10 == 9 and np.isfinite(total10) and total10 != total


def test_cli_eval_scenario_is_the_fixed_ned_one():
    args = argparse.Namespace(
        control_hz=40, orn_conv="ENU_FLU", min_pwm=0.0, max_pwm=1.0, noisy_motors=True, drone_model="cf2x",
        flight_mode=9, simulate_wind=False, flight_dome_size=100.0, max_duration_seconds=10.0,
        normalize_obs=True, normalize_actions=True, alpha=2.0, beta=0.1, gamma=4.0, delta=0.1, device="cpu",
    )
    env = cli.build_env(args, eval_scenario=True)
    assert (env.orn_conv, env.control_hz, env.simulate_wind, env.randomize_start) == ("NED_FRD", 80, True, False)
    assert env.base_wind_velocities == (5.0, -5.0, -1.0) and env.max_gust_strength == 7.0
    st, _ = env.reset(1, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(st.drone.read.view[0, 3].numpy(), [19.0, -19.0, -14.0], atol=1e-5)
    np.testing.assert_array_equal(st.wind.base_enu()[0].numpy(), [-5.0, 5.0, 1.0])
