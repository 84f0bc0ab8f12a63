"""The dogfight slice: K7's twin, the packed and self-play envs, PPO, the
CLI and the league policies, against the JAX package.

- The K7 twin (``cuda_dogfight.packed_dogfight_step_plain``) through
  ``PackedMAFixedwingDogfightEnv`` against ``jax.vmap(
  MAFixedwingDogfightEnv.step)`` (XLA, stock 30 Hz, noise off) from
  carried resets, tests/_dogfight_reference.py's cases (hits, the
  other-dead step, out-of-dome in a 10 m dome, unassisted actions) at
  tests/test_pallas_dogfight.py:48-75's bounds; no launch on the CPU.
- ``pack_env_state`` against the JAX env's after the column reorder of
  ``convert.packed_dogfight_from_jax`` (exact), and the observation pair
  from packed rows against the JAX env's ``_obs``.
- ``DogfightConsts`` against ``pallas_fixedwing._bake`` and the Pallas
  kernel's engagement constants, its C struct field by field; the twin's
  noise by its statistics; the wrapper's argument checks.
- The self-play semantics of tests/test_selfplay_dogfight.py:30-133 on the
  port: the flat view, partner death truncating the survivor, auto-reset
  spawning fresh arenas, cached equal to exact between resets, respawns.
- PPO on the self-play env at refresh 0 and 64; the ``eval-vs`` CLI.
- Both league npz files against their JAX sources (the orbax archive's
  ``s100``; the network's init from ``split(PRNGKey(0), 3)[1]``), and
  ``s100``'s deterministic actions against the JAX PPO's
  ``act_deterministic``.
- The slice's entry points default to ``"cuda"`` and raise without a card.
"""

import argparse
import ctypes
import dataclasses
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _dogfight_reference import CASES, N, assert_step_parity, reference

from pyflyt_tpu.envs.ma_fixedwing_dogfight import MAFixedwingDogfightEnv as JEnv
from pyflyt_tpu.envs.packed_dogfight import PackedMAFixedwingDogfightEnv as JPackedEnv
from pyflyt_tpu.envs.selfplay_dogfight import SelfPlayDogfightEnv as JSelfPlay
from pyflyt_tpu.ops import pallas_fixedwing
from pyflyt_tpu.rl import PPO as JPPO
from pyflyt_tpu.rl import PPOConfig as JPPOConfig
from pyflyt_tpu.rl import checkpoint as jckpt
from pyflyt_tpu_torch.convert import actor_critic_from_flax, dogfight_state_from_jax, packed_dogfight_from_jax
from pyflyt_tpu_torch.envs import (
    MAFixedwingDogfightEnv,
    PackedDogfightEnvState,
    PackedMAFixedwingDogfightEnv,
    SelfPlayDogfightEnv,
)
from pyflyt_tpu_torch.ops import cuda_build
from pyflyt_tpu_torch.ops import cuda_dogfight as cd
from pyflyt_tpu_torch.ops import cuda_fixedwing as cf
from pyflyt_tpu_torch.rl import PPO, PPOConfig
from pyflyt_tpu_torch.rl import checkpoint as tckpt
from pyflyt_tpu_torch.rl.ppo import act_deterministic, action_bounds
from pyflyt_tpu_torch.rl_training import dogfight_selfplay

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHIVE = os.path.join(REPO, "docs", "artifacts", "policies_dogfight_league_r5")


def _packed(kw, st0):
    env = PackedMAFixedwingDogfightEnv(MAFixedwingDogfightEnv(noisy_motors=False, device="cpu", **kw))
    ts = dogfight_state_from_jax(st0, device="cpu")
    ps = PackedDogfightEnvState(packed=env.pack_env_state(ts), generator=None, alive=ts.alive,
                                current_actions=ts.current_actions, past_actions=ts.past_actions)
    return env, ps


@pytest.mark.parametrize("case", list(CASES))
def test_packed_twin_matches_jax_env(case):
    kw, st0, traj, dead = reference(case)
    env, ps = _packed(kw, st0)
    launches = cd.KERNEL.launches
    for i, (a, ref, _) in enumerate(traj):
        ps, out = env.step(ps, torch.tensor(a))
        assert_step_parity(out, ref, i, 2e-3 + 1e-3 * i, f"packed {case}")
        np.testing.assert_array_equal(ps.alive.numpy(), traj[i][2].alive)
    assert cd.KERNEL.launches == launches  # CPU tensors: the twin, no launch
    if case == "engage":
        assert sum(int(s.current_hits.sum()) for _, _, s in traj) > 0
        alive, a, ref = dead
        ps = dataclasses.replace(ps, alive=torch.tensor(alive))
        _, out = env.step(ps, torch.tensor(a))
        assert_step_parity(out, ref, len(traj), 2e-3 + 1e-3 * len(traj), "packed dead-agent")
        assert bool(out.termination.all()) and not bool(out.info["collision"].all())
    assert int(ps.packed[cd._STEPC, 0]) == len(traj)


@pytest.mark.parametrize("case", ["engage", "unassisted"])
def test_pack_env_state_matches_jax(case):
    kw, st0, traj, _ = reference(case)
    jenv = JPackedEnv(base=JEnv(noisy_motors=False, **kw))
    for jst in (st0, traj[-1][2]):
        jpacked = jenv.pack_env_state(jax.tree.map(jnp.asarray, jst))
        ref = packed_dogfight_from_jax(jpacked, "cpu")
        got = cd.pack_env_state(dogfight_state_from_jax(jst, device="cpu"))
        assert got.shape == (cd.ROWS, 2 * N) == ref.shape
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        obs = PackedMAFixedwingDogfightEnv(MAFixedwingDogfightEnv(device="cpu", **kw))._obs(
            got, torch.tensor(jst.past_actions))
        jobs = jenv._obs(jpacked.reshape(cd.ROWS, -1), jnp.asarray(jst.past_actions))
        # f32 rounding of ~20 m/s and ~20 m terms in another einsum order
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-5, atol=2e-5)
    # the column of drone m of arena a is 2a + m: the partner is the neighbour
    st = dogfight_state_from_jax(st0, device="cpu")
    got = cd.pack_env_state(st)
    np.testing.assert_array_equal(cd.pair(got, cf._POS).numpy(), st.drones.body.pos[..., 0].numpy())
    np.testing.assert_array_equal(cd.partner(got[cf._POS]).reshape(N, 2).numpy(),
                                  st.drones.body.pos.flip(1)[..., 0].numpy())


def test_consts_match_bake_and_the_c_struct():
    base = JEnv(noisy_motors=False)
    B = pallas_fixedwing._bake(base.params, base.cfg)
    env = PackedMAFixedwingDogfightEnv(MAFixedwingDogfightEnv(device="cpu"))
    c, b = env.consts, env.base
    fw = cf.fixedwing_consts(b.params, b.cfg)
    for f in dataclasses.fields(cf.FixedwingConsts):  # the acrowing's K5 values, task fields the dogfight's
        if f.name not in ("dome2", "max_steps", "inner_steps"):
            assert getattr(c, f.name) == getattr(fw, f.name), f.name
    f32 = lambda v: np.asarray(v, np.float64).astype(np.float32)  # noqa: E731
    np.testing.assert_allclose(f32(c.cl3d), f32([s["cl3d"] for s in B["surf"]]), rtol=1e-6)
    np.testing.assert_allclose(f32(c.inertia), f32(B["inertia"]).reshape(-1), rtol=1e-6)
    assert (c.inv_mass, c.dt, c.ratio) == pytest.approx((B["inv_mass"], B["dt"], B["ratio"]), rel=1e-6)
    # the Pallas kernel's fuse values (pallas_dogfight.py:104-111)
    assert c.inner_steps == base.env_step_ratio == 4 and c.max_steps == float(base.max_steps) == 1800.0
    assert c.dome2 == base.flight_dome_size**2 and c.crad2 == (2.0 * base.collision_radius) ** 2
    assert (c.lethal_angle, c.lethal_distance, c.damage_per_hit) == (
        base.lethal_angle_radians, base.lethal_distance, base.damage_per_hit)

    src = (cuda_build.CSRC / cd.KERNEL.source).read_text()
    body = re.search(r"struct DogfightConsts \{(.*?)\};", src, re.S).group(1)
    c_fields = [(name, ctype, int(n or 1))
                for ctype, name, n in re.findall(r"^\s*(float|int) (\w+)(?:\[(\d+)\])?;", body, re.M)]
    py_fields = []
    for name, t in cd._DogfightConstsC._fields_:
        n, base_t = (t._length_, t._type_) if issubclass(t, ctypes.Array) else (1, t)
        py_fields.append((name, {ctypes.c_float: "float", ctypes.c_int: "int"}[base_t], n))
    assert py_fields == c_fields and len(c_fields) == len(dataclasses.fields(cd.DogfightConsts))
    assert "__shfl_xor_sync" in src and cd.ROWS == 72 and cd.rows_moved() == (48, 72)
    assert cd.ops_per_drone(c) == cf.OPS_PER_CONTROL + 4 * (2 * cf.OPS_PER_PHYSICS_ITER + cd.OPS_PER_ENGAGEMENT)


def test_twin_noise_statistics_and_argument_checks():
    """Noise on, identical lanes: the throttle spreads with the motor's
    noise ratio, mean unbiased; one seed gives one draw, another another.
    Then the wrapper's checks."""
    env = PackedMAFixedwingDogfightEnv(MAFixedwingDogfightEnv(device="cpu"))
    st, _ = env.reset(2, torch.Generator().manual_seed(0))
    packed = st.packed[:, :1].expand(-1, 2048).contiguous()
    packed[cf._SP + 3] = 0.75  # thrust
    s1 = torch.tensor([1])
    quiet = cd.packed_dogfight_step_plain(packed, s1, env.consts, False)[cf._THR]
    noisy = cd.packed_dogfight_step_plain(packed, s1, env.consts, True)[cf._THR]
    assert bool((quiet == quiet[0]).all())
    rel = (noisy - quiet) / quiet
    noise = env.consts.mot_noise
    assert abs(float(rel.mean())) < 5.0 * noise * np.sqrt(8.0) / np.sqrt(2048)
    assert 0.8 * noise < float(rel.std()) < 4.0 * noise
    assert torch.equal(noisy, cd.packed_dogfight_step_plain(packed, s1, env.consts, True)[cf._THR])
    assert not torch.equal(noisy, cd.packed_dogfight_step_plain(packed, torch.tensor([2]), env.consts, True)[cf._THR])
    seed = torch.zeros(1, dtype=torch.int64)
    for bad, exc in ((torch.zeros(cd.ROWS, 3), ValueError), (torch.zeros(cd.ROWS - 1, 4), ValueError),
                     (torch.zeros(cd.ROWS, 4, dtype=torch.float64), ValueError)):
        with pytest.raises(exc):
            cd.packed_dogfight_step(bad, seed, env.consts, False)
    with pytest.raises(ValueError, match="seed"):
        cd.packed_dogfight_step(torch.zeros(cd.ROWS, 4), seed.int(), env.consts, False)
    with pytest.raises(ValueError, match="dogfight_consts"):
        cd.packed_dogfight_step(torch.zeros(cd.ROWS, 4), seed, cf.fixedwing_consts(env.base.params, env.base.cfg), False)


# ---------------------------------------------------------------------------
# self-play (tests/test_selfplay_dogfight.py:30-133 on the port)
# ---------------------------------------------------------------------------

B = 16


def _selfplay(**kw):
    kw.setdefault("noisy_motors", False)
    return SelfPlayDogfightEnv(PackedMAFixedwingDogfightEnv(MAFixedwingDogfightEnv(device="cpu", **kw)))


def _cruise(b=B):
    return torch.tensor([0.05, 0.0, 0.0, 0.75]).repeat(b, 1)


def test_flat_view_matches_pair_env():
    env = _selfplay()
    st, obs = env.reset(B, torch.Generator().manual_seed(0))
    pst, pobs = env.penv.reset(B // 2, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(obs.numpy(), pobs.reshape(B, -1).numpy())
    st2, out = env.step(st, _cruise())
    _, pout = env.penv.step(pst, _cruise().reshape(B // 2, 2, -1))
    np.testing.assert_array_equal(out.obs.numpy(), pout.obs.reshape(B, -1).numpy())
    np.testing.assert_array_equal(out.reward.numpy(), pout.reward.reshape(B).numpy())
    np.testing.assert_array_equal(out.info["health"].numpy(), pout.info["healths"][:, 0].reshape(B).numpy())
    assert env.native_batch and not env.time_limit_truncation_only and env.obs_size == 30


def test_partner_death_truncates_survivor():
    """Drone 0 of the even arenas 0.4 m above the ground falling (its own
    collision terminates it): its partner row truncates, the other arenas
    run on."""
    env = _selfplay()
    st, _ = env.reset(B, torch.Generator().manual_seed(1))
    p = st.inner.packed
    crash = torch.arange(B) % 4 == 0  # drone 0 of arenas 0, 2, 4, 6
    p[cf._POS + 2] = torch.where(crash, 0.4, p[cf._POS + 2])
    p[cf._LVEL + 2] = torch.where(crash, -8.0, p[cf._LVEL + 2])
    _, out = env.step(st, _cruise())
    term, trunc = out.termination.reshape(-1, 2), out.truncation.reshape(-1, 2)
    arena = torch.arange(B // 2)
    assert bool(term[arena % 2 == 0, 0].all()) and not bool(term[arena % 2 == 0, 1].any())
    assert bool(trunc[arena % 2 == 0, 1].all())  # the survivor's episode is cut short
    assert not bool((term | trunc)[arena % 2 == 1].any())


def test_autoreset_spawns_fresh_arena():
    env = _selfplay(max_duration_seconds=0.05)  # max_steps 1: truncates on the third step
    gen = torch.Generator().manual_seed(2)
    st, _ = env.reset(B, gen)
    for i in range(env.max_steps + 2):
        st, out = env.autoreset_step(st, _cruise())
        assert "terminal_observation" in out.info
    assert bool(out.truncation.all()), "expected the time-limit truncation"
    np.testing.assert_array_equal(st.inner.packed[cd._STEPC].numpy(), 0.0)  # fresh arenas
    assert not torch.equal(out.obs, out.info["terminal_observation"])
    st, out = env.autoreset_step(st, _cruise())
    assert bool(torch.isfinite(out.obs).all()) and not bool(out.truncation.any())


def test_cached_autoreset_matches_exact_between_resets():
    env = _selfplay()
    st, obs0 = env.reset(B, torch.Generator().manual_seed(3))
    ars, obs0c = env.cached_autoreset_init(B, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(obs0.numpy(), obs0c.numpy())
    for _ in range(2):
        st, out = env.autoreset_step(st, _cruise())
        ars, outc = env.cached_autoreset_step(ars, _cruise(), refresh=64)
        assert not bool((out.termination | out.truncation).any())
        np.testing.assert_array_equal(out.obs.numpy(), outc.obs.numpy())
        np.testing.assert_array_equal(out.reward.numpy(), outc.reward.numpy())


def test_cached_autoreset_respawns():
    env = _selfplay(max_duration_seconds=0.05)
    ars, _ = env.cached_autoreset_init(B, torch.Generator().manual_seed(4))
    pool = ars.cache_inner.packed.clone()
    saw = False
    for i in range(env.max_steps + 3):
        ars, out = env.cached_autoreset_step(ars, _cruise(), refresh=4)
        if bool(out.truncation.any()):
            saw = True
            np.testing.assert_array_equal(ars.env_state.inner.packed[: cd.D_ROWS].numpy(), pool[: cd.D_ROWS].numpy())
    assert saw and ars.step_idx == env.max_steps + 3
    assert not torch.equal(ars.cache_inner.packed, pool)  # refreshed on step 4
    assert bool(torch.isfinite(out.obs).all())


@pytest.mark.parametrize("refresh", [0, 64])
def test_ppo_trains_on_the_selfplay_env(refresh):
    env = _selfplay(noisy_motors=True)
    tp = PPO(env, PPOConfig(num_envs=B, rollout_steps=4, num_epochs=1, num_minibatches=2, feature_sizes=(32, 32),
                            slot_bootstrap=False, cached_reset_refresh=refresh, init_log_std=-1.0))
    runner = tp.init(0)
    assert runner.obs.shape == (B, 30)
    before = [p.detach().clone() for p in runner.network.parameters()]
    runner, metrics = tp.train_iteration(runner)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert max((a - b).abs().max().item() for a, b in zip(before, runner.network.parameters())) > 0
    assert cd.KERNEL.launches == 0


def test_eval_vs_cli(capsys):
    """The league pair on the CLI at 4 matches of 0.5 s (15 steps)."""
    argv = ["eval-vs", "--checkpoint", "dogfight_league_r5_s100", "--opponent", "dogfight_league_r5_init",
            "--num_matches", "4", "--max_duration_seconds", "0.5", "--device", "cpu"]
    out = dogfight_selfplay.main(argv)
    assert out["matches"] == 4 and out["finished"] == 4
    assert out["win_rate_a"] + out["loss_rate_a"] + out["draw_rate"] == pytest.approx(1.0)
    assert '"win_rate_a"' in capsys.readouterr().out
    args = argparse.Namespace(
        sparse_reward=False, noisy_motors=False, damage_per_hit=0.02, max_duration_seconds=60.0, agent_hz=30,
        cached_reset_refresh=64, layer_size=256, num_of_layers=2, init_log_std=-1.0, device="cpu", num_envs=B,
        rollout_steps=128, n_epochs=4, num_minibatches=16, learning_rate=3e-4, clip_eps=0.2, entropy_coef=0.0)
    cfg = dogfight_selfplay.mk_ppo(args, dogfight_selfplay.build_env(args)).config
    assert (cfg.slot_bootstrap, cfg.cached_reset_refresh, cfg.feature_sizes) == (False, 64, (256, 256))


# ---------------------------------------------------------------------------
# the league policies
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _league():
    """The JAX PPO of the league's args (dogfight_league_r5.py:46-52), its
    network's init params and the archived s100."""
    ppo = JPPO(JSelfPlay(), JPPOConfig(feature_sizes=(256, 256), init_log_std=-1.0, slot_bootstrap=False))
    init = ppo.network.init(jax.random.split(jax.random.PRNGKey(0), 3)[1], jnp.zeros((1, 30)))
    s100 = jckpt.restore_params(ARCHIVE, init)
    return ppo, jax.tree.map(np.asarray, init), jax.tree.map(np.asarray, s100)


@pytest.mark.parametrize("tag", ["init", "s100"])
def test_league_npz_equals_its_jax_source(tag):
    _, init, s100 = _league()
    net = tckpt.load_policy_npz(f"dogfight_league_r5_{tag}", device="cpu")
    ref = actor_critic_from_flax({"init": init, "s100": s100}[tag], device="cpu")
    for (k, a), (k2, b) in zip(net.state_dict().items(), ref.state_dict().items()):
        assert k == k2
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    assert net.obs_dim == 30 and net.action_dim == 4 and [lin.out_features for lin in net.pi_trunk.layers] == [256, 256]
    assert float(net.log_std.detach().mean()) == pytest.approx(-1.0, abs=0.05)


def test_league_policy_acts_as_jax_does():
    """s100's deterministic actions (the clipped mean, f32) on reset
    observations against the JAX PPO's ``act_deterministic`` (1e-5)."""
    ppo, _, s100 = _league()
    _, st0, _, _ = reference("engage")
    obs = dogfight_state_from_jax(st0, device="cpu").observations.reshape(2 * N, 30)
    net = tckpt.load_policy_npz("dogfight_league_r5_s100", device="cpu")
    env = _selfplay()
    low, high = action_bounds(env, torch.device("cpu"))
    got = act_deterministic(net, obs, low, high)
    ref = ppo.act_deterministic(jax.tree.map(jnp.asarray, s100), jnp.asarray(obs.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert np.abs(np.asarray(ref)).max() > 0.05  # a trained policy, not the 0.01-gain init


@pytest.mark.parametrize("entry", ["ma_quadx_env", "dogfight_env", "selfplay_env", "league_policy", "dogfight_cli"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, entry):
    from pyflyt_tpu_torch.envs import MAQuadXHoverEnv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = {
        "ma_quadx_env": lambda: MAQuadXHoverEnv(),
        "dogfight_env": lambda: MAFixedwingDogfightEnv(),
        "selfplay_env": lambda: SelfPlayDogfightEnv(),
        "league_policy": lambda: tckpt.load_policy_npz("dogfight_league_r5_s100"),
        "dogfight_cli": lambda: dogfight_selfplay.main(["eval-vs", "--checkpoint", "dogfight_league_r5_s100"]),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
