"""The Fixedwing-Waypoints slice against the JAX package.

- The plain ``FixedwingWaypointsEnv`` and the row-6 twin
  (``PackedFixedwingWaypointsEnv``, ``cuda_fixedwing.
  packed_waypoints_step_plain``) against the JAX XLA env
  ``jax.vmap(FixedwingWaypointsEnv.step)`` from resets carried over by
  ``convert``, JAX-drawn actions fed to all three: the stock 30 Hz env for
  20 steps (with lanes started falling at the ground, flying out of the
  dome and past their last target, so collision, out-of-dome and the
  freeze run), a 25 m reach at 60 Hz, and a 0.05 s horizon at 120 Hz with
  a 120 m reach (tests/test_pallas_fixedwing.py:213-253's cases). Per
  lane: tests/test_pallas_fixedwing.py:161-195's tolerances (attitude
  5e-4, target deltas 5e-3, reward 5e-3), the obs held on the lanes still
  flying (the twin's contact is detection-grade), and at most 4 of 64
  lanes beyond them (a reach or the stall switch sits on a threshold);
  every flag exact.
- ``pack_env_state`` against the JAX env's, row by row (exact), its
  observation, and ``unpack_env_state`` back.
- PPO on the plain env at refresh 0 and 64; ``fused_sgd`` raising (item
  26).
- The archived r5 policy: the npz equal to the orbax archive, its
  deterministic actions equal to JAX's (1e-5), and the K4 twin at obs 35
  against the Pallas forward in interpret mode.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyflyt_tpu.envs.base import vec_reset
from pyflyt_tpu.envs.fixedwing_waypoints import FixedwingWaypointsEnv as JEnv
from pyflyt_tpu.envs.packed_fixedwing_waypoints import PackedFixedwingWaypointsEnv as JPackedEnv
from pyflyt_tpu.ops import pallas_policy, pallas_sgd
from pyflyt_tpu.rl import checkpoint as jckpt
from pyflyt_tpu.rl import networks as jnet
from pyflyt_tpu_torch.convert import (
    actor_critic_from_flax,
    fixedwing_waypoints_state_from_jax,
    packed_fixedwing_waypoints_from_jax,
)
from pyflyt_tpu_torch.envs import FixedwingWaypointsEnv, PackedFixedwingWaypointsEnv, PackedWaypointsState
from pyflyt_tpu_torch.ops import cuda_fixedwing as cf
from pyflyt_tpu_torch.ops import cuda_policy
from pyflyt_tpu_torch.rl import PPO, PPOConfig
from pyflyt_tpu_torch.rl import checkpoint as tckpt
from pyflyt_tpu_torch.rl.ppo import _flat_obs, act_deterministic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHIVE = os.path.join(REPO, "docs", "artifacts", "policies_fixedwing_r5_lr3e-4_seed0")
NPZ = "fixedwing_r5_lr3e-4_seed0"
N = 64
NT = 4
DIVERGED = 4  # lanes of 64 that may leave the curve (tests/test_packed_waypoints.py's rule)

CASES = {  # name: (env kwargs, reset key, steps, action kind)
    "stock": (dict(), 1, 20, "random"),
    "reach25": (dict(goal_reach_distance=25.0, agent_hz=60), 2, 20, "random"),
    "horizon": (dict(goal_reach_distance=120.0, max_duration_seconds=0.05, agent_hz=120), 3, 9, "cruise"),
}


def _actions(i, kind):
    if kind == "cruise":
        return jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 0.5]), (N, 1))
    a = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(99), i), (N, 4), minval=-0.4, maxval=0.4)
    return a.at[:, 3].set(jnp.abs(a[:, 3]) + 0.3)


def _traps(st):
    """Lanes 0-3 start 0.4 m up falling at 8 m/s (collision), lanes 4-7 at
    the dome's edge flying out (out-of-bounds), lanes 8-11 past their last
    target (truncated, env_complete: frozen from the start)."""
    lane = jnp.arange(N)
    fall, out, past = lane < 4, (lane >= 4) & (lane < 8), (lane >= 8) & (lane < 12)
    body = st.drone.body
    pos = jnp.where(fall[:, None], body.pos.at[:, 2].set(0.4), body.pos)
    pos = jnp.where(out[:, None], pos.at[:, 0].set(99.5), pos)
    vel = jnp.where(fall[:, None], body.lin_vel.at[:, 2].set(-8.0), body.lin_vel)
    drone = st.drone.replace(body=body.replace(pos=pos, lin_vel=vel))
    return st.replace(drone=drone, wp=st.wp.replace(idx=jnp.where(past, NT, st.wp.idx)),
                      truncation=st.truncation | past, env_complete=st.env_complete | past)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The JAX env's reset (one program) and steps (one program)."""
    kw, key, steps, kind = CASES[case]
    base = JEnv(noisy_motors=False, **kw)
    st, _ = vec_reset(base, jax.random.split(jax.random.PRNGKey(key), N))
    if case == "stock":
        st = _traps(st)
    st0 = st
    step = jax.jit(jax.vmap(base.step))
    traj = []
    for i in range(steps):
        act = _actions(i, kind)
        st, out = step(st, act)
        traj.append((np.asarray(act), jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, st)))
    return base, jax.tree.map(np.asarray, st0), traj


def _envs(case):
    plain = FixedwingWaypointsEnv(noisy_motors=False, device="cpu", **CASES[case][0])
    return plain, PackedFixedwingWaypointsEnv(plain)


def _lane_errors(got, ref):
    """Per lane: the largest error relative to its tolerance (obs on the
    lanes still flying, the reward on all), > 1 beyond it."""
    live = ~np.asarray(ref.termination)
    att = np.abs(got.obs["attitude"].numpy() - ref.obs["attitude"]).max(-1) / 5e-4
    dlt = np.abs(got.obs["target_deltas"].numpy() - ref.obs["target_deltas"]).reshape(N, -1).max(-1) / 5e-3
    rwd = np.abs(got.reward.numpy() - ref.reward) / 5e-3
    return np.maximum(rwd, np.where(live, np.maximum(att, dlt), 0.0))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_env_and_packed_twin_match_the_jax_env(case):
    _, st0, traj = _reference(case)
    plain, env = _envs(case)
    carried = fixedwing_waypoints_state_from_jax(st0, device="cpu")
    ps = PackedWaypointsState(packed=env.pack_env_state(carried), generator=None)
    ts = carried
    launches = cf.WAYPOINTS_KERNEL.launches
    events = dict(reach=0, termination=0, truncation=0, collision=0, out_of_bounds=0, env_complete=0)
    for i, (act, ref, _) in enumerate(traj):
        a = torch.tensor(act)
        ps, out = env.step(ps, a)
        ts, tout = plain.step(ts, a)
        for name, got in (("packed", out), ("plain", tout)):
            bad = _lane_errors(got, ref) > 1.0
            assert int(bad.sum()) <= DIVERGED, f"{case} {name} step {i}: {int(bad.sum())} lanes diverged"
            for flag, x, y in (("termination", got.termination, ref.termination),
                               ("truncation", got.truncation, ref.truncation),
                               *((k, got.info[k], ref.info[k]) for k in
                                 ("collision", "out_of_bounds", "env_complete", "num_targets_reached"))):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f"{case} {name} step {i} {flag}")
        events["reach"] += int((ref.reward >= 99.0).sum())
        for k in ("collision", "out_of_bounds", "env_complete"):
            events[k] = int(ref.info[k].sum())
        events["termination"], events["truncation"] = int(ref.termination.sum()), int(ref.truncation.sum())
    assert out.info["num_targets_reached"].dtype == torch.int32
    assert cf.WAYPOINTS_KERNEL.launches == launches  # CPU tensors: the twin, no launch
    need = {"stock": ("collision", "out_of_bounds", "termination", "truncation"),
            "reach25": ("reach", "truncation", "env_complete"), "horizon": ("truncation", "env_complete")}[case]
    assert all(events[k] > 0 for k in need), events
    if case == "stock":  # the lanes past their last target stayed frozen
        frozen = ps.packed[:, 8:12] - env.pack_env_state(carried)[:, 8:12]
        assert not frozen[cf._POS : cf._SP].any() and not frozen[cf._TERM : cf._STEP].any()
    if case == "horizon":
        assert bool((out.truncation | out.termination).all())


@pytest.mark.parametrize("case", ["stock", "reach25"])
def test_pack_env_state_matches_jax(case):
    """Row by row at the reset and after the run (targets advanced: the
    rolled rows), the observation from packed rows, and back."""
    base, st0, traj = _reference(case)
    jenv = JPackedEnv(base=base)
    _, env = _envs(case)
    for jst in (st0, traj[-1][2]):
        ref = packed_fixedwing_waypoints_from_jax(jenv.pack_env_state(jax.tree.map(jnp.asarray, jst)), "cpu")
        carried = fixedwing_waypoints_state_from_jax(jst, device="cpu")
        got = env.pack_env_state(carried)
        assert got.shape == (cf.ROWS, N) == ref.shape
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        back = env.unpack_env_state(got, carried)
        np.testing.assert_array_equal(back.wp.targets.numpy(), carried.wp.targets.numpy())
        np.testing.assert_array_equal(back.wp.idx.numpy(), carried.wp.idx.numpy())
        np.testing.assert_array_equal(back.step_count.numpy(), carried.step_count.numpy())
        np.testing.assert_array_equal(back.drone.read.view.numpy(), carried.drone.read.view.numpy())
    assert int(traj[-1][2].wp.idx.max()) > 0
    ref_obs = jenv._obs(jenv.pack_env_state(jax.tree.map(jnp.asarray, st0)).reshape(cf.ROWS, -1))
    obs = env._obs(env.pack_env_state(fixedwing_waypoints_state_from_jax(st0, device="cpu")))
    for k in ("attitude", "target_deltas"):
        np.testing.assert_allclose(obs[k].numpy(), np.asarray(ref_obs[k]), atol=1e-6)
    assert obs["attitude"].shape == (N, 23) and env.flat_obs_size == 35


def test_reset_obs_shapes_and_scene_boxes_raise():
    plain, env = _envs("stock")
    st, obs = env.reset(6, torch.Generator().manual_seed(0))
    assert st.packed.shape == (cf.ROWS, 6) and obs["target_deltas"].shape == (6, NT, 3)
    pst, pobs = plain.reset(6, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(obs["attitude"].numpy(), pobs["attitude"].numpy())
    assert float(st.packed[cf._POS + 2].min()) > 9.0 and float(st.packed[cf._LVEL].min()) > 15.0
    # the waypoint markers (the camera came with ROADMAP item 21)
    boxes = plain.scene_boxes(pst)
    torch.testing.assert_close(boxes.centers, pst.wp.targets, rtol=0, atol=0)
    assert boxes.visible.shape == (6, NT) and bool(boxes.visible.all()) and boxes.colors.shape == (NT, 4)
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        FixedwingWaypointsEnv(device="cpu").reset(2, None)


# ---------------------------------------------------------------------------
# PPO on the plain env
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("refresh", [0, 64])
def test_ppo_trains_on_the_fixedwing_env(refresh):
    """One tiny iteration of the r5 recipe's shape on the stock env: obs
    flattened to 35, exact and cached auto-resets, finite metrics, moved
    parameters."""
    env = FixedwingWaypointsEnv(device="cpu")
    tp = PPO(env, PPOConfig(num_envs=8, rollout_steps=4, num_epochs=1, num_minibatches=2, init_log_std=-0.5,
                            cached_reset_refresh=refresh, feature_sizes=(16, 16)))
    runner = tp.init(0)
    assert runner.obs.shape == (8, 35) and runner.network.obs_dim == 35
    before = [p.detach().clone() for p in runner.network.parameters()]
    runner, metrics = tp.train_iteration(runner)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert max((a - b).abs().max().item() for a, b in zip(before, runner.network.parameters())) > 0
    assert runner.obs.shape == (8, 35)


def test_fused_sgd_trains_one_iteration_at_obs_35():
    """Once the fused SGD kernel (K2) stopped at obs 32 and this raised,
    naming ROADMAP item 26; K2 now takes widths up to 64, so ``fused_sgd``
    builds and trains at the fixedwing env's obs 35 (on the CPU through
    K2's twin): finite metrics, moved parameters, Adam's count advanced by
    the epoch's minibatches."""
    tp = PPO(FixedwingWaypointsEnv(device="cpu"), PPOConfig(num_envs=8, rollout_steps=4, num_epochs=1,
                                                            num_minibatches=2, fused_sgd=True, feature_sizes=(16, 16)))
    runner = tp.init(0)
    assert runner.obs.shape == (8, 35)
    before = [p.detach().clone() for p in runner.network.parameters()]
    runner, metrics = tp.train_iteration(runner)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert max((a - b).abs().max().item() for a, b in zip(before, runner.network.parameters())) > 0
    assert int(runner.opt_state.count) == 2


# ---------------------------------------------------------------------------
# the archived r5 policy
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _archived():
    tmpl = jnet.ActorCritic(action_dim=4).init(jax.random.PRNGKey(0), jnp.zeros((1, 35)))
    params = jax.tree.map(np.asarray, jckpt.restore_params(ARCHIVE, tmpl))
    return params, tckpt.load_policy_npz(NPZ, device="cpu")


def test_archived_policy_npz_equals_the_orbax_archive():
    params, net = _archived()
    ref = actor_critic_from_flax(params, device="cpu")
    for (k, a), (k2, b) in zip(net.state_dict().items(), ref.state_dict().items()):
        assert k == k2
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    assert net.obs_dim == 35 and net.action_dim == 4 and [lin.out_features for lin in net.pi_trunk.layers] == [256, 256]


def test_archived_policy_acts_as_jax_does():
    """Deterministic actions (the clipped mean) on reset observations of
    the stock env, f32 forward against flax's (1e-5); then the K4 twin at
    obs 35 against the Pallas forward in interpret mode (bf16 inputs:
    tests/test_torch_policy.py's 1e-4 on the mean, 1e-3 on the value)."""
    params, net = _archived()
    _, st0, _ = _reference("stock")
    _, env = _envs("stock")
    flat = _flat_obs(env._obs(env.pack_env_state(fixedwing_waypoints_state_from_jax(st0, device="cpu"))))
    low, high = torch.tensor([-1.0, -1.0, -1.0, 0.0]), torch.ones(4)
    got = act_deterministic(net, flat, low, high)
    mean, _, value = jnet.ActorCritic(action_dim=4).apply(params, jnp.asarray(flat.numpy()))
    ref = np.clip(np.asarray(mean), low.numpy(), high.numpy())
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    assert np.abs(np.asarray(mean)).max() > 0.05  # a trained policy, not the 0.01-gain init

    run = pallas_policy.build_policy_value_forward(
        obs_dim=35, act_dim=4, pi_sizes=(256, 256), vf_sizes=(256, 256), chunk=64, interpret=True,
    )
    jm, jv = run(jnp.asarray(flat.numpy()), pallas_sgd.params_to_leaves(params))
    tm, tv = cuda_policy.policy_value_forward(flat, net.kernel_weights())
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-3)
    np.testing.assert_allclose(tv.numpy(), np.asarray(value), rtol=0.02)  # bf16 inputs against f32: one critic
