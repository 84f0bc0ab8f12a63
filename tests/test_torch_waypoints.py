"""The port's waypoints task against the JAX package: the batched
``WaypointHandler`` (including a lane past its last target and yaw
targets), ``flatten_waypoint_obs``, ``QuadXWaypointsEnv`` from carried JAX
resets (a mode-7 chase and a mode-0 crash/truncation run), its
``use_kernel`` form (the generic kernel's twin in mode 7) against the plain
env, and PPO on the dict observation.

Tolerances: the handler 1e-5 (f32 rotations of the same numbers); the env
runs follow tests/test_packed_waypoints.py's rule. The chase (mode 7,
``goal_reach_distance=0.6``, 32 steps) allows at most 4 of 64 lanes beyond
``5e-4 + 4e-4·i`` at step i: a reach sits on a threshold and the 5-bank
cascade drifts lane by lane (the JAX env against itself, jit against
eager, crosses that curve by step 20). The crash run holds every lane at
``5e-4 + 2e-4·i``. Flags (termination, truncation, collision,
out-of-bounds, env_complete, num_targets_reached) match exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyflyt_tpu.core import math as jpm
from pyflyt_tpu.envs.base import vec_reset
from pyflyt_tpu.envs.quadx_waypoints import QuadXWaypointsEnv as JWaypointsEnv
from pyflyt_tpu.envs.utils import flatten_waypoints as jflat
from pyflyt_tpu.envs.utils import waypoints as jwp
from pyflyt_tpu.rl.ppo import _flat_obs as j_flat_obs
from pyflyt_tpu_torch.convert import waypoints_state_from_jax
from pyflyt_tpu_torch.envs import FlattenWaypointEnv, QuadXWaypointsEnv, flatten_waypoint_obs
from pyflyt_tpu_torch.envs.utils import waypoints as twp
from pyflyt_tpu_torch.ops import cuda_quadx as cq
from pyflyt_tpu_torch.rl import PPO, PPOConfig
from pyflyt_tpu_torch.rl import ppo as tppo

torch.set_num_threads(1)

N = 64
NT = 4
FLAGS = ("collision", "out_of_bounds", "env_complete")


# ---------------------------------------------------------------------------
# the handler
# ---------------------------------------------------------------------------


def _handler_inputs(seed: int, use_yaw: bool):
    """Seeded targets, cursors 0..NT (a quarter of the lanes past their last
    target), memos and the drone's read."""
    rng = np.random.default_rng(seed)
    n = 32
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    targets = f(n, NT, 3) * 2.0
    yaw_t = rng.uniform(-np.pi, np.pi, size=(n, NT)).astype(np.float32) if use_yaw else np.zeros((n, NT), np.float32)
    idx = rng.integers(0, NT + 1, size=n).astype(np.int32)
    idx[:8] = NT  # the idx == num_targets trap
    memo = np.abs(f(n)) + 0.3
    ang_pos = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    ang_pos[:, 2] = rng.uniform(-np.pi, np.pi, size=n)
    lin_pos = f(n, 3)
    return targets, yaw_t, idx, memo, ang_pos, lin_pos


@pytest.mark.parametrize("use_yaw", [False, True])
def test_handler_matches_jax(use_yaw):
    targets, yaw_t, idx, memo, ang_pos, lin_pos = _handler_inputs(3 + use_yaw, use_yaw)
    h = dict(num_targets=NT, use_yaw_targets=use_yaw, goal_reach_distance=0.5, goal_reach_angle=0.5)
    jh, th = jwp.WaypointHandler(**h), twp.WaypointHandler(**h)
    z = np.zeros_like(memo)
    jws = jwp.WaypointState(targets=jnp.asarray(targets), yaw_targets=jnp.asarray(yaw_t), idx=jnp.asarray(idx),
                            old_distance=jnp.asarray(z), new_distance=jnp.asarray(memo), yaw_error=jnp.asarray(z))
    T = torch.from_numpy
    tws = twp.WaypointState(targets=T(targets), yaw_targets=T(yaw_t), idx=T(idx), old_distance=T(z),
                            new_distance=T(memo), yaw_error=T(z))
    jquat = jpm.euler_to_quat(jnp.asarray(ang_pos))

    def jstep(ws, a, p, q):
        ws, d = jh.update_distances(ws, a, p, q)
        adv = jh.advance_targets(ws)
        return (ws, d, jh.remaining_deltas(ws, d), jh.immediate_distance(ws, d), jh.target_reached(ws),
                adv.idx, jh.all_targets_reached(adv), jh.progress_to_target(ws))

    jws2, jd, jrem, jimm, jreach, jadv, jall, jprog = jax.vmap(jstep)(jws, jnp.asarray(ang_pos), jnp.asarray(lin_pos),
                                                                      jquat)
    tws2, td = th.update_distances(tws, T(ang_pos), T(lin_pos), torch.from_numpy(np.asarray(jquat)))
    live = idx < NT
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_allclose(tws2.new_distance.numpy()[live], np.asarray(jws2.new_distance)[live], atol=1e-5)
    np.testing.assert_array_equal(tws2.old_distance.numpy(), memo)  # old <- previous new
    # past the last target JAX reads NaN where the port clamps; both select it away
    assert np.isnan(np.asarray(jws2.new_distance)[~live]).all()
    assert np.isfinite(tws2.new_distance.numpy()).all()
    np.testing.assert_allclose(th.remaining_deltas(tws2, td).numpy(), np.asarray(jrem), atol=1e-5)
    assert not th.remaining_deltas(tws2, td).numpy()[~live].any()
    np.testing.assert_allclose(th.immediate_distance(tws2, td).numpy()[live], np.asarray(jimm)[live], atol=1e-5)
    np.testing.assert_allclose(th.progress_to_target(tws2).numpy()[live], np.asarray(jprog)[live], atol=1e-5)
    np.testing.assert_array_equal(th.target_reached(tws2).numpy()[live], np.asarray(jreach)[live])
    adv = th.advance_targets(tws2)
    np.testing.assert_array_equal(adv.idx.numpy(), np.asarray(jadv))
    np.testing.assert_array_equal(th.all_targets_reached(adv).numpy(), np.asarray(jall))
    if use_yaw:
        np.testing.assert_allclose(tws2.yaw_error.numpy()[live], np.asarray(jws2.yaw_error)[live], atol=1e-5)
        assert td.shape[-1] == 4 and th.delta_size == 4
    # the render markers (the camera came with ROADMAP item 21): JAX's, field by field
    jm, tm = jax.vmap(jh.marker_boxes)(jws2), th.marker_boxes(tws2)
    np.testing.assert_array_equal(tm.centers.numpy(), np.asarray(jm.centers))
    np.testing.assert_array_equal(tm.visible.numpy(), np.asarray(jm.visible))
    for f in ("half_extents", "rotations", "colors"):  # shared by the port's batch
        np.testing.assert_array_equal(getattr(tm, f).expand(np.shape(getattr(jm, f))).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)


def test_handler_reset_draws_by_their_statistics():
    """The port draws from a torch.Generator (JAX folds a key), so the
    draws are held by their distribution: the distance within [1, 0.9 dome]
    where z was not floored, z >= min_height, the azimuth and the yaw
    targets uniform (means within 5 standard errors)."""
    h = twp.WaypointHandler(num_targets=NT, use_yaw_targets=True, flight_dome_size=5.0)
    ws = h.reset(4096, torch.Generator().manual_seed(5), device="cpu")
    t = ws.targets.reshape(-1, 3)
    m = t.shape[0]
    assert (t[:, 2] >= h.min_height).all()
    free = t[:, 2] > h.min_height + 1e-6
    dist = t[free].norm(dim=1)
    assert dist.min() >= 1.0 - 1e-5 and dist.max() <= 0.9 * 5.0 + 1e-5
    az = torch.atan2(t[:, 1], t[:, 0])
    se = 5 * np.sqrt(0.5 / m)
    assert abs(float(torch.cos(az).mean())) < se and abs(float(torch.sin(az).mean())) < se
    yaw = ws.yaw_targets.reshape(-1)
    assert yaw.abs().max() <= np.pi and abs(float(yaw.mean())) < 5 * np.pi / np.sqrt(3 * m)
    assert ws.idx.dtype == torch.int32 and not ws.idx.any()
    assert not twp.WaypointHandler().reset(8, torch.Generator(), device="cpu").yaw_targets.any()
    with pytest.raises(ValueError, match="Generator"):
        h.reset(8, None, device="cpu")


@pytest.mark.parametrize("context", [2, 6])
def test_flatten_waypoint_obs_matches_jax(context):
    rng = np.random.default_rng(context)
    obs = {"attitude": rng.normal(size=(5, 21)).astype(np.float32),
           "target_deltas": rng.normal(size=(5, NT, 3)).astype(np.float32)}
    ref = np.asarray(jflat.flatten_waypoint_obs({k: jnp.asarray(v) for k, v in obs.items()}, context))
    got = flatten_waypoint_obs({k: torch.from_numpy(v) for k, v in obs.items()}, context)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.shape[-1] == 21 + context * 3


def test_flat_obs_matches_the_jax_ppo():
    rng = np.random.default_rng(9)
    obs = {"target_deltas": rng.normal(size=(6, NT, 3)).astype(np.float32),
           "attitude": rng.normal(size=(6, 21)).astype(np.float32)}
    ref = np.asarray(j_flat_obs({k: jnp.asarray(v) for k, v in obs.items()}))
    got = tppo._flat_obs({k: torch.from_numpy(v) for k, v in obs.items()})
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.shape == (6, 33) and tppo._flat_obs(got) is got


# ---------------------------------------------------------------------------
# the env from carried JAX resets
# ---------------------------------------------------------------------------


def _jax_run(mode: int, key: int, actions, **kw):
    """A vmapped JAX reset and ``len(actions)`` jitted steps (actions a
    function of the step and the JAX state): the reset state and, per
    step, (action, StepOut, state) as numpy trees."""
    base = JWaypointsEnv(noisy_motors=False, flight_mode=mode, **kw)
    st, _ = vec_reset(base, jax.random.split(jax.random.PRNGKey(key), N))
    st0 = jax.tree.map(np.asarray, st)
    step = jax.jit(jax.vmap(base.step))
    traj = []
    for i in range(len(actions)):
        act = actions[i](st)
        st, out = step(st, act)
        traj.append((np.asarray(act), jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, st)))
    return st0, traj


def _chase_action(i):
    def act(st):  # command the current target's world position (mode 7: x, y, yaw, z)
        cur = jnp.take_along_axis(st.wp.targets, jnp.minimum(st.wp.idx, NT - 1)[:, None, None], axis=1)[:, 0]
        return jnp.concatenate([cur[:, :2], jnp.zeros((N, 1)), cur[:, 2:]], axis=-1)
    return act


def _crash_action(i):
    def act(st):
        a = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(5), i), (N, 4), minval=-0.6, maxval=0.6)
        return a.at[:, 3].set(jnp.abs(a[:, 3]) * 0.3)  # weak thrust: the fleet falls
    return act


@pytest.fixture(scope="module")
def chase():
    return _jax_run(7, 1, [_chase_action(i) for i in range(32)], goal_reach_distance=0.6)


@pytest.fixture(scope="module")
def crash():
    return _jax_run(0, 2, [_crash_action(i) for i in range(12)], max_duration_seconds=0.3)


def _check_flags(out, ref, i):
    for name, a, b in (("termination", out.termination, ref.termination),
                       ("truncation", out.truncation, ref.truncation),
                       *((k, out.info[k], ref.info[k]) for k in (*FLAGS, "num_targets_reached"))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"step {i} {name}")


def _lane_errors(out, ref) -> np.ndarray:
    err = np.zeros(N)
    for part in ("attitude", "target_deltas"):
        d = np.abs(out.obs[part].numpy() - ref.obs[part])
        err = np.maximum(err, d.reshape(N, -1).max(axis=-1))
    return np.maximum(err, np.abs(out.reward.numpy() - ref.reward))


def test_reset_obs_of_a_carried_state(chase):
    st0, _ = chase
    env = QuadXWaypointsEnv(noisy_motors=False, flight_mode=7, goal_reach_distance=0.6, device="cpu")
    st = waypoints_state_from_jax(st0, device="cpu")
    jenv = JWaypointsEnv(noisy_motors=False, flight_mode=7)
    ref = jax.vmap(jenv._obs)(jax.tree.map(jnp.asarray, st0))
    obs = env._obs(st)
    np.testing.assert_allclose(obs["attitude"].numpy(), np.asarray(ref["attitude"]), atol=1e-6)
    np.testing.assert_array_equal(obs["target_deltas"].numpy(), np.asarray(ref["target_deltas"]))
    assert env.flat_obs_size == 33 and env.obs_size == 21


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mode7_chase_matches_jax(chase, use_kernel):
    """The chase: reaches bank 100, targets advance; at most 4 of 64 lanes
    beyond the drift curve at any step, flags exact. ``use_kernel`` runs
    each aviary step through the generic kernel's mode-7 twin."""
    st0, traj = chase
    env = QuadXWaypointsEnv(noisy_motors=False, flight_mode=7, goal_reach_distance=0.6, device="cpu",
                            use_kernel=use_kernel)
    st = waypoints_state_from_jax(st0, device="cpu")
    launches = cq.GENERIC_KERNEL.launches
    reaches = 0
    for i, (act, ref, _) in enumerate(traj):
        st, out = env.step(st, torch.from_numpy(act))
        bad = _lane_errors(out, ref) > 5e-4 + 4e-4 * i
        assert int(bad.sum()) <= 4, f"step {i}: {int(bad.sum())} lanes diverged"
        _check_flags(out, ref, i)
        reaches += int((ref.reward >= 99.0).sum())
    assert reaches > 0, "the chase should reach waypoints"
    assert cq.GENERIC_KERNEL.launches == launches  # CPU tensors: the twin, no launch


def test_mode0_crash_and_truncation_match_jax(crash):
    """Mode 0 with weak thrust: crashes terminate, the 9-step limit
    truncates, frozen lanes stay frozen; every lane within the curve."""
    st0, traj = crash
    env = QuadXWaypointsEnv(noisy_motors=False, flight_mode=0, max_duration_seconds=0.3, device="cpu")
    st = waypoints_state_from_jax(st0, device="cpu")
    done = False
    for i, (act, ref, _) in enumerate(traj):
        st, out = env.step(st, torch.from_numpy(act))
        tol = 5e-4 + 2e-4 * i
        for part in ("attitude", "target_deltas"):
            np.testing.assert_allclose(out.obs[part].numpy(), ref.obs[part], atol=tol, err_msg=f"step {i} {part}")
        np.testing.assert_allclose(out.reward.numpy(), ref.reward, atol=tol, err_msg=f"step {i} reward")
        _check_flags(out, ref, i)
        done |= bool((out.termination | out.truncation).any())
    assert done and out.truncation.all()


def test_use_kernel_env_follows_the_plain_env_in_mode_0():
    """``use_kernel`` against the plain env in mode 0 (the generic twin on
    the 56-row layout): obs on the lanes still flying (the kernel's contact
    is detection-grade), rewards and flags on all."""
    plain = QuadXWaypointsEnv(noisy_motors=False, flight_mode=0, device="cpu")
    kern = dataclasses.replace(plain, use_kernel=True)
    sp, _ = plain.reset(32, torch.Generator().manual_seed(4))
    sk, _ = kern.reset(32, torch.Generator().manual_seed(4))
    rng = np.random.default_rng(8)
    for i in range(20):
        a = rng.uniform(-0.6, 0.6, size=(32, 4)).astype(np.float32)
        a[:, 3] = np.abs(a[:, 3]) * 0.6
        a[:10] = 0.0  # a third of the fleet falls onto the ground plane
        a = torch.from_numpy(a)
        sp, op = plain.step(sp, a)
        sk, ok = kern.step(sk, a)
        live = ~op.termination
        np.testing.assert_allclose(ok.obs["attitude"][live].numpy(), op.obs["attitude"][live].numpy(), atol=2e-4)
        np.testing.assert_allclose(ok.obs["target_deltas"].numpy(), op.obs["target_deltas"].numpy(), atol=2e-4)
        np.testing.assert_array_equal(ok.termination.numpy(), op.termination.numpy())
        np.testing.assert_array_equal(ok.truncation.numpy(), op.truncation.numpy())
    assert op.termination.any()


# ---------------------------------------------------------------------------
# PPO on the dict observation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("refresh", [0, 4])
def test_ppo_trains_on_the_dict_env(refresh):
    """One tiny PPO iteration on the mode-7 kernel env: obs flattened to
    33, exact (``envs/base.autoreset_step``) and cached auto-resets of a
    dict observation, finite metrics, moved parameters."""
    env = QuadXWaypointsEnv(flight_mode=7, use_kernel=True, device="cpu")
    tp = PPO(env, PPOConfig(num_envs=16, rollout_steps=4, num_epochs=1, num_minibatches=2,
                            cached_reset_refresh=refresh, feature_sizes=(16, 16)))
    runner = tp.init(0)
    assert runner.obs.shape == (16, 33) and runner.network.obs_dim == 33
    before = [p.detach().clone() for p in runner.network.parameters()]
    runner, metrics = tp.train_iteration(runner)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert max((a - b).abs().max().item() for a, b in zip(before, runner.network.parameters())) > 0
    assert runner.obs.shape == (16, 33)
    ev = tp.evaluate(runner.network, torch.Generator().manual_seed(1), num_episodes=2)
    assert all(np.isfinite(float(v)) for v in ev.values())


def test_fused_sgd_trains_one_iteration_at_obs_33():
    """Once the fused SGD kernel (K2) stopped at obs 32 and this raised,
    naming ROADMAP item 26; K2 now takes K4's obs widths up to 64, so
    ``fused_sgd`` builds and trains at obs 33 (on the CPU through K2's
    twin): finite metrics, moved parameters, Adam's count advanced by the
    epoch's minibatches. The 27-wide flattened env still works."""
    env = QuadXWaypointsEnv(flight_mode=7, use_kernel=True, device="cpu")
    tp = PPO(env, PPOConfig(num_envs=8, rollout_steps=4, num_epochs=1, num_minibatches=2, fused_sgd=True))
    runner = tp.init(0)
    assert runner.obs.shape == (8, 33) and tp.epoch_config(33).obs_dim == 33
    before = [p.detach().clone() for p in runner.network.parameters()]
    runner, metrics = tp.train_iteration(runner)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert max((a - b).abs().max().item() for a, b in zip(before, runner.network.parameters())) > 0
    assert int(runner.opt_state.count) == 2
    flat = FlattenWaypointEnv(env, context_length=2)
    assert flat.obs_size == 27
    PPO(flat, PPOConfig(fused_sgd=True))  # 27 wide: inside K2's envelope
    st, obs = flat.reset(4, torch.Generator().manual_seed(0))
    assert obs.shape == (4, 27)
    _, out = flat.step(st, torch.zeros(4, 4))
    assert out.obs.shape == (4, 27)
