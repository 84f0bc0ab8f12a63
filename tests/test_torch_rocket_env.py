"""The Rocket-Landing slice: the plain env, K6's row-9 twin through the
packed env, the archived L0 policy and its npz, against the JAX package.

- ``RocketLandingEnv`` and the row-9 twin (``PackedRocketLandingEnv`` on
  CPU tensors, no launch) against ``jax.vmap(RocketLandingEnv.step)``
  (XLA, noise off) from carried resets, tests/_rocket_reference.py's
  ``drop`` and ``traps`` runs, at tests/test_pallas_rocket.py:168-194's
  bounds (obs 5e-3 + 1e-3 i, reward 1e-3 + 2e-4 i with rtol 1e-3, flags
  exact); every preset trap fires (a soft touchdown that completes, a
  hard touchdown, a ground hit, below ground, out of bounds by
  displacement and by the ceiling, truncation) and frozen lanes keep
  every row but the setpoint, the re-armed reward and the step count.
- ``pack_env_state`` against the JAX env's after
  ``convert.packed_rocket_landing_from_jax``, the observation from packed
  rows against the JAX env's.
- The reset's draws (the polar pad, the randomized drop).
- The L0 npz against its orbax source (with its ``log_std_range``), its
  deterministic actions against the JAX PPO's ``act_deterministic``; the
  npz ``log_std_range`` round trip, the older npz files loading as
  before.
- The slice's entry points default to ``"cuda"`` and raise without a card.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _rocket_reference import LOW_ENV, N, TRAPS, assert_step_parity, env_case

from pyflyt_tpu.envs.packed_rocket_landing import PackedRocketLandingEnv as JPackedEnv
from pyflyt_tpu.envs.rocket_landing import RocketLandingEnv as JEnv
from pyflyt_tpu.rl import PPO as JPPO
from pyflyt_tpu.rl import PPOConfig as JPPOConfig
from pyflyt_tpu.rl import checkpoint as jckpt
from pyflyt_tpu_torch.convert import (
    actor_critic_from_flax,
    packed_rocket_landing_from_jax,
    rocket_landing_state_from_jax,
)
from pyflyt_tpu_torch.envs import PackedRocketEnvState, PackedRocketLandingEnv, RocketLandingEnv
from pyflyt_tpu_torch.ops import cuda_rocket as cr
from pyflyt_tpu_torch.rl import checkpoint as tckpt
from pyflyt_tpu_torch.rl.networks import ActorCritic
from pyflyt_tpu_torch.rl.ppo import act_deterministic, action_bounds

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHIVE = os.path.join(REPO, "docs", "artifacts", "policies_rocket_landing_L0")
L0_ENV = dict(starting_fuel_ratio=0.02, ceiling=15.0, max_displacement=15.0, accelerate_drop=False)
L0_RANGE = (-3.5, -1.0)  # rocket_rl_r5h.py:85-88


def _plain():
    return RocketLandingEnv(device="cpu", **LOW_ENV)


def _packed(st0):
    env = PackedRocketLandingEnv(_plain())
    return env, PackedRocketEnvState(packed=env.pack_env_state(rocket_landing_state_from_jax(st0, device="cpu")),
                                     generator=None)


@pytest.mark.parametrize("case", ["drop", "traps"])
def test_plain_env_matches_jax_env(case):
    st0, obs0, traj = env_case(case)
    env = _plain()
    st = rocket_landing_state_from_jax(st0, device="cpu")
    np.testing.assert_allclose(env._obs(st).numpy(), obs0, atol=1e-5)
    for i, (a, ref, _) in enumerate(traj):
        st, out = env.step(st, torch.tensor(a))
        assert_step_parity(out, ref, i, f"plain {case}")
    np.testing.assert_array_equal(st.step_count.numpy(), traj[-1][2].step_count)
    if case == "drop":
        assert bool(out.termination.all()), "every rocket falls onto the ground or its pad within 60 steps"


@pytest.mark.parametrize("case", ["drop", "traps"])
def test_packed_twin_matches_jax_env(case):
    st0, obs0, traj = env_case(case)
    env, ps = _packed(st0)
    np.testing.assert_allclose(env._obs(ps.packed).numpy(), obs0, atol=1e-5)
    launches = cr.LANDING_KERNEL.launches
    for i, (a, ref, rst) in enumerate(traj):
        ps, out = env.step(ps, torch.tensor(a))
        assert_step_parity(out, ref, i, f"packed {case}")
        np.testing.assert_array_equal(ps.packed[cr._STEP].numpy(), rst.step_count)
        np.testing.assert_array_equal(ps.packed[cr._PFLAG].numpy(), rst.pad_contact_flag)
    assert cr.LANDING_KERNEL.launches == launches  # CPU tensors: the twin, no launch


def test_every_trap_fires_and_frozen_lanes_hold():
    st0, _, traj = env_case("traps")
    env, ps = _packed(st0)
    before = ps.packed.clone()
    rewards, first = [], None
    for a, _, _ in traj:
        ps, out = env.step(ps, torch.tensor(a))
        rewards.append(out.reward)
        first = out if first is None else first
    p = ps.packed
    lanes = lambda k: list(TRAPS[k])  # noqa: E731
    flag = lambda row, k: (p[row, lanes(k)] > 0.5)  # noqa: E731
    assert flag(cr._CPLT, "soft_complete").all() and (first.reward[lanes("soft_complete")] > 500.0).all()
    assert not flag(cr._FATC, "soft_complete").any()
    for k in ("hard_touchdown", "ground_hit", "below_ground"):
        assert flag(cr._FATC, k).all() and flag(cr._TERM, k).all(), k
    assert (first.reward[lanes("hard_touchdown")] > first.reward[lanes("ground_hit")].max()).all()  # +20 on the pad
    for k in ("displacement", "ceiling"):
        assert flag(cr._OOB, k).all(), k
    assert flag(cr._TRUNC, "truncation").all() and not flag(cr._TERM, "truncation").any()
    assert not (p[cr._TERM, 13:] > 0.5).any()  # the free lanes fly on
    frozen = lanes("frozen")
    keep = torch.ones(cr.ROWS, dtype=torch.bool)
    keep[cr._SP : cr._SP + 7] = False
    keep[cr._RWD] = False
    keep[cr._STEP] = False
    assert torch.equal(p[keep][:, frozen], before[keep][:, frozen])
    assert (torch.stack(rewards)[:, frozen] == 0.0).all()
    np.testing.assert_array_equal(p[cr._STEP, frozen].numpy(), before[cr._STEP, frozen].numpy() + len(traj))


@pytest.mark.parametrize("case", ["drop", "traps"])
def test_pack_env_state_matches_jax(case):
    st0, _, traj = env_case(case)
    jenv = JPackedEnv(base=JEnv(**LOW_ENV))
    env = PackedRocketLandingEnv(_plain())
    for jst in (st0, traj[-1][2]):
        ref = packed_rocket_landing_from_jax(jenv.pack_env_state(jax.tree.map(jnp.asarray, jst)), "cpu")
        got = env.pack_env_state(rocket_landing_state_from_jax(jst, device="cpu"))
        assert got.shape == (cr.ROWS, N) == ref.shape
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        jobs = jenv._obs(jnp.asarray(ref.numpy()))
        np.testing.assert_allclose(env._obs(got).numpy(), np.asarray(jobs), atol=1e-6)


def test_reset_draws_the_pad_and_the_drop():
    env = RocketLandingEnv(device="cpu")  # the stock drop: 400-450 m, -100 m/s, a pad within 25 m
    st, obs = env.reset(64, torch.Generator().manual_seed(0))
    assert obs.shape == (64, env.obs_size) == (64, 33) and bool(torch.isfinite(obs).all())
    pad = st.pad_position
    dist = torch.linalg.vector_norm(pad[:, :2], dim=-1)
    assert float(dist.max()) <= 0.05 * env.ceiling and float(dist.std()) > 1.0
    np.testing.assert_allclose(pad[:, 2].numpy(), 0.1 * dist.numpy(), rtol=1e-5)  # the pad's z is 0.1 of its distance
    base = st.drone.read.view[:, 3]
    assert float(base[:, :2].abs().max()) <= 0.1 * env.max_displacement + 1e-3
    assert 380.0 < float(base[:, 2].min()) and float(base[:, 2].max()) < 450.0  # 10 stabilization steps fell ~8 m
    assert float(st.drone.body.lin_vel[:, 2].max()) < -95.0  # the accelerated drop, near its drag-limited speed
    again, _ = env.reset(64, torch.Generator().manual_seed(0))
    assert torch.equal(again.drone.body.pos, st.drone.body.pos)
    with pytest.raises(ValueError, match="Generator"):
        env.reset(4)
    low = RocketLandingEnv(device="cpu", **LOW_ENV)
    st, _ = low.reset(4, torch.Generator().manual_seed(1))  # no randomized drop: straight down from 8 m
    np.testing.assert_allclose(st.drone.read.view[:, 3, :2].numpy(), 0.0, atol=1e-3)
    assert float(st.drone.read.view[:, 3, 2].min()) > 7.9


# ---------------------------------------------------------------------------
# the archived L0 policy
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _l0():
    """The JAX PPO of the r5h recipe's L0 rung (rocket_rl_r5h.py:85-93) and
    the archived params."""
    ppo = JPPO(JEnv(**L0_ENV), JPPOConfig(init_log_std=-1.2, log_std_range=L0_RANGE))
    init = ppo.network.init(jax.random.PRNGKey(0), jnp.zeros((1, 33)))
    return ppo, jax.tree.map(np.asarray, jckpt.restore_params(ARCHIVE, init))


def test_l0_npz_equals_its_orbax_source():
    _, params = _l0()
    net = tckpt.load_policy_npz("rocket_landing_L0", device="cpu")
    ref = actor_critic_from_flax(params, log_std_range=L0_RANGE, device="cpu")
    for (k, a), (k2, b) in zip(net.state_dict().items(), ref.state_dict().items()):
        assert k == k2
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    assert net.obs_dim == 33 and net.action_dim == 7 and [lin.out_features for lin in net.pi_trunk.layers] == [256, 256]
    assert net.log_std_range == L0_RANGE
    # trained below the range's top: the clamp changes the sampling std
    assert float(net.clamped_log_std().detach().max()) <= -1.0 and float(net.log_std.detach().min()) < -2.0


def test_l0_acts_as_jax_does():
    """Deterministic actions (the clipped mean, f32) on the drop run's
    observations against the JAX PPO's ``act_deterministic`` (1e-5)."""
    ppo, params = _l0()
    _, obs0, traj = env_case("drop")
    obs = np.concatenate([obs0, traj[10][1].obs, traj[30][1].obs])
    net = tckpt.load_policy_npz("rocket_landing_L0", device="cpu")
    low, high = action_bounds(RocketLandingEnv(device="cpu", **L0_ENV), torch.device("cpu"))
    got = act_deterministic(net, torch.tensor(obs), low, high)
    ref = ppo.act_deterministic(jax.tree.map(jnp.asarray, params), jnp.asarray(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert np.abs(np.asarray(ref)).max() > 0.05  # a trained policy, not the 0.01-gain init


def test_policy_npz_keeps_log_std_range(tmp_path):
    g = torch.Generator().manual_seed(0)
    for rng in (None, (-2.0, 0.5)):
        net = ActorCritic(5, 2, feature_sizes=(8,), log_std_range=rng, device="cpu", generator=g)
        path = str(tmp_path / f"p{rng is None}.npz")
        tckpt.save_policy_npz(path, net)
        back = tckpt.load_policy_npz(path, device="cpu")
        assert back.log_std_range == rng
        assert set(np.load(path).files) == set(net.state_dict()) | (set() if rng is None else {"log_std_range"})
        for (k, a), b in zip(net.state_dict().items(), back.state_dict().values()):
            assert torch.equal(a, b), k
    # the npz files written before the key existed load as before
    for name in ("fixedwing_r5_lr3e-4_seed0", "dogfight_league_r5_s100"):
        path = os.path.join(tckpt.POLICY_DIR, f"{name}.npz")
        assert "log_std_range" not in np.load(path).files
        net = tckpt.load_policy_npz(name, device="cpu")
        assert net.log_std_range is None
        with np.load(path) as z:
            np.testing.assert_array_equal(net.log_std.detach().numpy(), z["log_std"])


def test_scene_boxes_waits_on_vision():
    """The landing pad's render box (the camera came with ROADMAP item 21):
    one a env, at the pad, 4 x 4 x 0.1 m."""
    env = _plain()
    st, _ = env.reset(3, torch.Generator().manual_seed(0))
    boxes = env.scene_boxes(st)
    torch.testing.assert_close(boxes.centers, st.pad_position[:, None, :], rtol=0, atol=0)
    torch.testing.assert_close(boxes.half_extents, torch.tensor([[2.0, 2.0, 0.05]]), rtol=0, atol=0)
    assert boxes.visible.tolist() == [True]


@pytest.mark.parametrize("entry", ["rocket_params", "rocket_env", "packed_rocket_env", "l0_policy", "gimbals",
                                   "convert"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, entry):
    from pyflyt_tpu_torch.models import rocket
    from pyflyt_tpu_torch.ops import gimbals

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st0, _, _ = env_case("drop")
    build = {
        "rocket_params": lambda: rocket.build_params(rocket.RocketConfig()),
        "rocket_env": lambda: RocketLandingEnv(),
        "packed_rocket_env": lambda: PackedRocketLandingEnv(),
        "l0_policy": lambda: tckpt.load_policy_npz("rocket_landing_L0"),
        "gimbals": lambda: gimbals.build(np.eye(3)[:1], np.eye(3)[1:2], np.ones(1), np.ones((1, 2))),
        "convert": lambda: rocket_landing_state_from_jax(st0),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
