"""The port's hover envs against the JAX package's ``QuadXHoverEnv``, and
the fused hover step's semantics on its plain twin.

Both the port's ``QuadXHoverEnv`` (plain tensor physics) and its
``PackedQuadXHoverEnv`` (the fused step; on CPU tensors its plain twin)
follow the JAX env over 20 agent steps at N=37 (a ragged edge for any
block size), half of the fleet falling onto the ground. Noise is off.
Obs and reward within atol 2e-4 (as tests/test_packed_hover.py), flags
exact, reset obs within 1e-6.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pyflyt_tpu.envs.base import vec_reset
from pyflyt_tpu.envs.quadx_hover import QuadXHoverEnv as JHoverEnv
from pyflyt_tpu_torch.envs.base import autoreset_init, cached_autoreset_step
from pyflyt_tpu_torch.envs.packed_hover import (
    PackedQuadXHoverEnv,
    packed_autoreset_init,
    packed_cached_autoreset_step,
)
from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
from pyflyt_tpu_torch.ops import cuda_quadx as cq

torch.set_num_threads(1)

N = 37
STEPS = 20
ATOL = 2e-4


def _actions(i, n=N):
    rng = np.random.default_rng(1000 + i)
    a = rng.uniform(-0.6, 0.6, size=(n, 4)).astype(np.float32)
    a[:, 3] = np.abs(a[:, 3]) + 0.2
    a[: n // 2] = 0.0  # zero rates + zero thrust: a clean vertical fall
    return a


@pytest.fixture(scope="module")
def reference():
    env = JHoverEnv(noisy_motors=False)
    st, obs0 = vec_reset(env, jax.random.split(jax.random.PRNGKey(0), N))
    vstep = jax.jit(jax.vmap(env.step))
    traj = []
    for i in range(STEPS):
        st, out = vstep(st, _actions(i))
        traj.append({
            "obs": np.asarray(out.obs), "reward": np.asarray(out.reward),
            "termination": np.asarray(out.termination),
            "truncation": np.asarray(out.truncation),
            "collision": np.asarray(out.info["collision"]),
            "out_of_bounds": np.asarray(out.info["out_of_bounds"]),
        })
    return np.asarray(obs0), traj


def _port_env(kind, **kw):
    base = QuadXHoverEnv(noisy_motors=False, device="cpu", **kw)
    return base if kind == "plain" else PackedQuadXHoverEnv(base=base)


@pytest.mark.parametrize("kind", ["plain", "packed"])
def test_reset_obs_matches_jax(reference, kind):
    _, obs = _port_env(kind).reset(N)
    np.testing.assert_allclose(obs.numpy(), reference[0], atol=1e-6)


@pytest.mark.parametrize("kind", ["plain", "packed"])
def test_trajectory_matches_jax(reference, kind):
    env = _port_env(kind)
    st, _ = env.reset(N)
    some_done = False
    for i, ref in enumerate(reference[1]):
        st, out = env.step(st, torch.from_numpy(_actions(i)))
        np.testing.assert_allclose(out.obs.numpy(), ref["obs"], atol=ATOL, err_msg=f"step {i} obs")
        np.testing.assert_allclose(out.reward.numpy(), ref["reward"], atol=ATOL, err_msg=f"step {i} reward")
        for k in ("termination", "truncation"):
            np.testing.assert_array_equal(getattr(out, k).numpy(), ref[k], err_msg=f"step {i} {k}")
        for k in ("collision", "out_of_bounds"):
            np.testing.assert_array_equal(out.info[k].numpy(), ref[k], err_msg=f"step {i} {k}")
        some_done |= bool(ref["termination"].any())
    assert some_done, "the termination/freeze path must be exercised"


def _crash_until_done(env, step_fn, ars, max_steps=30):
    """Steps the half-crashing fleet until some lane finishes; returns the
    pre-step state, the step's outputs and the post-step auto-reset state."""
    for i in range(max_steps):
        a = torch.from_numpy(_actions(i))
        pre = ars
        ars, out = step_fn(env, ars, a)
        done = out.termination | out.truncation
        if done.any():
            return pre, a, out, ars, done
    raise AssertionError("no lane finished")


def test_packed_cached_autoreset_replaces_exactly_the_done_lanes():
    env = _port_env("packed")
    ars, _ = packed_autoreset_init(env, N)
    pre, a, out, post, done = _crash_until_done(
        env, lambda e, s, x: packed_cached_autoreset_step(e, s, x, refresh=1000), ars
    )
    stepped, ref_out = env.step(
        dataclasses.replace(pre.env_state, packed=pre.env_state.packed.clone()), a
    )
    assert done.any() and (~done).any()
    p = post.env_state.packed
    np.testing.assert_array_equal(p[:, done].numpy(), pre.cache_packed[:, done].numpy())
    np.testing.assert_array_equal(p[:, ~done].numpy(), stepped.packed[:, ~done].numpy())
    np.testing.assert_array_equal(out.obs[done].numpy(), pre.cache_obs[done].numpy())
    np.testing.assert_array_equal(out.obs[~done].numpy(), ref_out.obs[~done].numpy())
    np.testing.assert_array_equal(out.info["terminal_observation"].numpy(), ref_out.obs.numpy())


def test_cached_autoreset_replaces_exactly_the_done_lanes():
    env = _port_env("plain")
    ars, _ = autoreset_init(env, N, None)
    pre, a, out, post, done = _crash_until_done(
        env, lambda e, s, x: cached_autoreset_step(e, s, x, refresh=1000), ars
    )
    stepped, ref_out = env.step(pre.env_state, a)
    assert done.any() and (~done).any()
    pos = post.env_state.drone.body.pos
    np.testing.assert_array_equal(pos[done].numpy(), pre.cache_state.drone.body.pos[done].numpy())
    np.testing.assert_array_equal(pos[~done].numpy(), stepped.drone.body.pos[~done].numpy())
    assert not post.env_state.termination.any()
    np.testing.assert_array_equal(out.obs[done].numpy(), pre.cache_obs[done].numpy())
    np.testing.assert_array_equal(out.obs[~done].numpy(), ref_out.obs[~done].numpy())


def test_cache_refreshes_every_period():
    env = _port_env("packed")
    ars, _ = packed_autoreset_init(env, 4)
    caches = []
    for _ in range(6):
        ars, _ = packed_cached_autoreset_step(env, ars, torch.zeros(4, 4), refresh=3)
        caches.append(ars.cache_packed)
    assert caches[0] is caches[1] and caches[1] is not caches[2]
    assert caches[2] is caches[3] is caches[4] and caches[4] is not caches[5]
    assert ars.step_idx == 6


# ---------------------------------------------------------------------------
# the fused step's semantics, on its plain twin
# ---------------------------------------------------------------------------


def _packed(n=8, **kw):
    env = _port_env("packed", **kw)
    st, _ = env.reset(n)
    return env, st


def test_frozen_lanes_keep_their_snapshot_and_rearm_the_reward():
    """A lane done before the step keeps every drone and flag row; its
    reward is re-armed to -0.1 and its step count still advances."""
    env, st = _packed()
    st.packed[cq._TERM, :3] = 1.0
    st.packed[cq._RWD, :3] = -100.0
    before = st.packed.clone()
    a = torch.full((8, 4), 0.3)
    st2, out = env.step(st, a)
    keep = [r for r in range(cq.ROWS) if r not in (*range(cq._SP, cq._SP + 4), cq._RWD, cq._STEP)]
    np.testing.assert_array_equal(st2.packed[keep, :3].numpy(), before[keep, :3].numpy())
    np.testing.assert_array_equal(out.reward[:3].numpy(), np.full(3, -0.1, np.float32))
    np.testing.assert_array_equal(st2.packed[cq._STEP, :3].numpy(), before[cq._STEP, :3].numpy() + 1)
    assert not torch.equal(st2.packed[cq._POS:cq._POS + 3, 3:], before[cq._POS:cq._POS + 3, 3:])


def test_freeze_is_a_select_not_a_blend():
    """A frozen lane whose candidate step overflows (the drag of a 1e20 m/s
    air speed is inf) keeps its finite snapshot; the blend
    ``keep*old + (1-keep)*new`` would give it 0 * inf = NaN."""
    env, st = _packed(4)
    st.packed[cq._TERM, :2] = 1.0
    st.packed[cq._DRG:cq._DRG + 3, :2] = 1e20
    before = st.packed.clone()
    st2, _ = env.step(st, torch.full((4, 4), 0.3))
    assert torch.isfinite(st2.packed[:, :2]).all()
    np.testing.assert_array_equal(st2.packed[cq._DRG:cq._DRG + 3, :2].numpy(),
                                  before[cq._DRG:cq._DRG + 3, :2].numpy())


def test_fatal_event_sets_reward_to_minus_100():
    """A drone placed on the ground collides in the first aviary step:
    sparse reward is exactly -100 (-0.1 re-armed, then overwritten)."""
    env, st = _packed(sparse_reward=True)
    st.packed[cq._POS + 2, :4] = 0.005
    st.packed[cq._LVEL + 2, :4] = -0.5
    _, out = env.step(st, torch.zeros(8, 4))
    np.testing.assert_array_equal(out.reward[:4].numpy(), np.full(4, -100.0, np.float32))
    assert out.termination[:4].all() and out.info["collision"][:4].all()
    np.testing.assert_array_equal(out.reward[4:].numpy(), np.full(4, -0.1, np.float32))


def test_contact_is_detection_grade():
    """Contact lifts the box onto the plane and stops its downward speed,
    and nothing else (no impulse, no spin)."""
    env, st = _packed()
    st.packed[cq._POS + 2, :4] = 0.0
    st.packed[cq._LVEL + 2, :4] = -1.0
    st2, out = env.step(st, torch.zeros(8, 4))
    hz = env.consts.half_ext[2]
    np.testing.assert_allclose(st2.packed[cq._POS + 2, :4].numpy(), hz, atol=1e-7)
    np.testing.assert_array_equal(st2.packed[cq._LVEL + 2, :4].numpy(), np.zeros(4, np.float32))
    np.testing.assert_array_equal(st2.packed[cq._AVEL:cq._AVEL + 3, :4].numpy(), np.zeros((3, 4), np.float32))
    assert (st2.packed[cq._CON, :4] == 1.0).all()


@pytest.mark.parametrize("kind", ["plain", "packed"])
def test_truncation_uses_the_count_before_the_increment(kind):
    env = _port_env(kind)
    st, _ = env.reset(2)
    m = env.max_steps if kind == "plain" else env.base.max_steps
    if kind == "plain":
        st = dataclasses.replace(st, step_count=torch.full((2,), m, dtype=torch.int32))
    else:
        st.packed[cq._STEP] = float(m)
    hover = torch.tensor([[0.0, 0.0, 0.0, 0.33]] * 2)
    st, out = env.step(st, hover)
    assert not out.truncation.any()  # count m is not > m
    st, out = env.step(st, hover)
    assert out.truncation.all()  # count m + 1 > m


def test_step_count_row_is_f32_and_exact():
    env, st = _packed(2)
    assert st.packed.dtype == torch.float32
    st.packed[cq._STEP] = torch.tensor([0.0, 2.0**23])
    st2, _ = env.step(st, torch.zeros(2, 4))
    np.testing.assert_array_equal(st2.packed[cq._STEP].numpy(), np.array([1.0, 2.0**23 + 1], np.float32))
    template, _ = env.base.reset(2)
    assert env.unpack_env_state(st2.packed, template).step_count.tolist() == [1, 2**23 + 1]


def test_noisy_twin_draws_from_its_seed():
    env, st = _packed(256)
    packed = st.packed.clone()
    packed[cq._SP:cq._SP + 4] = torch.tensor([0.0, 0.0, 0.0, 0.35])[:, None]
    seed = torch.tensor([7])
    a = cq.packed_hover_step(packed, seed, env.consts, 0, True)
    b = cq.packed_hover_step(packed, seed, env.consts, 0, True)
    c = cq.packed_hover_step(packed, torch.tensor([8]), env.consts, 0, True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    spread = a[cq._THR:cq._THR + 4].std(1)
    assert (spread > 1e-3).all()


def test_noisy_packed_env_steps_with_its_generator():
    base = QuadXHoverEnv(device="cpu")
    env = PackedQuadXHoverEnv(base=base)
    st, _ = env.reset(16, torch.Generator().manual_seed(0))
    st, out = env.step(st, torch.full((16, 4), 0.2))
    assert torch.isfinite(out.obs).all() and out.obs.shape == (16, env.obs_size)
    with pytest.raises(ValueError, match="Generator"):
        env.reset(4, None)


@pytest.mark.parametrize("mode", [0, 8])
def test_packed_env_modes_match_plain_env(mode):
    """Modes 0 and 8 (direct PWM): the fused step's twin follows the plain
    env (detection-grade contact aside, which only differs after a lane's
    termination freezes it)."""
    plain = _port_env("plain", flight_mode=mode)
    packed = PackedQuadXHoverEnv(base=plain)
    sp, _ = plain.reset(N)
    sk, _ = packed.reset(N)
    for i in range(6):
        a = torch.from_numpy(np.abs(_actions(i)) if mode == 8 else _actions(i))
        sp, op = plain.step(sp, a)
        sk, ok = packed.step(sk, a)
        np.testing.assert_allclose(ok.obs.numpy(), op.obs.numpy(), atol=ATOL)
        np.testing.assert_allclose(ok.reward.numpy(), op.reward.numpy(), atol=ATOL)
        np.testing.assert_array_equal(ok.termination.numpy(), op.termination.numpy())
