"""Mode 7 and the fused waypoints step against the JAX package.

- ``models.quadx.step`` in mode 7 (the position cascade) against the JAX
  model: the hold and step-response scenarios of tests/test_quadx.py
  (one batch of two drones, 960 steps), and seeded random states over 10
  steps, ENU and NED. Tolerance 1e-4 on the state over the random steps
  (f32 rounding of the chained banks and the native ``atan2``/``asin``);
  1e-3 on the positions after 960 steps of closed-loop flight.
- The generic kernel's twin in mode 7 (80 rows) and the ``cuda_quadx.step``
  drop-in against the same JAX steps (1e-4), and ``pack_state`` against
  ``pallas_quadx.pack_state`` row by row (exact).
- ``PackedQuadXWaypointsEnv.pack_env_state`` against the JAX env's, row by
  row (exact), and the row-4 twin against the JAX plain env in modes 7, 0
  and 8 from carried JAX resets, the port's plain env beside it. Lanes
  are held by tests/test_packed_waypoints.py's rule: at most 4 of 64
  beyond ``5e-4 + 4e-4·i`` in the mode-7 chase (reaches sit on a
  threshold), every lane within ``5e-4 + 2e-4·i`` in mode 0, and in mode
  8, where a third of the fleet hits the ground, the obs of the lanes
  still flying (the kernel's contact is detection-grade) and every
  reward. Flags match exactly. Four lanes of the chase start past their
  last target (truncated, env_complete): they stay frozen in all three.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyflyt_tpu.envs.base import vec_reset
from pyflyt_tpu.envs.packed_quadx_waypoints import PackedQuadXWaypointsEnv as JPackedEnv
from pyflyt_tpu.envs.quadx_waypoints import QuadXWaypointsEnv as JWaypointsEnv
from pyflyt_tpu.models import quadx as jq
from pyflyt_tpu.ops import pallas_quadx
from pyflyt_tpu_torch.convert import packed_waypoints_from_jax, quadx_state_from_jax, waypoints_state_from_jax
from pyflyt_tpu_torch.envs import PackedQuadXWaypointsEnv, PackedWaypointsState, QuadXWaypointsEnv
from pyflyt_tpu_torch.models import quadx as tq
from pyflyt_tpu_torch.ops import cuda_build
from pyflyt_tpu_torch.ops import cuda_quadx as cq

torch.set_num_threads(1)

N_RAND = 24
N = 64
NT = 4
ATOL = 1e-4


# ---------------------------------------------------------------------------
# mode 7 in the model and the generic kernel's twin
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model(conv):
    kw = dict(orn_conv=conv, noisy_motors=False)
    jc, tc = jq.QuadXConfig(**kw), tq.QuadXConfig(**kw)
    return jc, jq.build_params(jc), tc, tq.build_params(tc, "cpu")


def test_mode7_hold_and_step_response_match_jax():
    """tests/test_quadx.py's scenarios as one batch: drone 0 holds [0, 0, 1]
    (its criteria at 4 s), drone 1 steps to [1, -1, 1.5] (at 8 s)."""
    jc, jp, tc, tp = _model("ENU_FLU")
    start = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    sp = np.array([[0.0, 0.0, 0.0, 1.0], [1.0, -1.0, 0.0, 1.5]], np.float32)
    js = jq.set_mode(jq.init_state(jp, jc, jnp.asarray(start), jnp.zeros((2, 3))), 7, jc).replace(
        setpoint=jnp.asarray(sp))

    def body(st, _):
        st = jq.step(st, jp, jc, mode=7)[0]
        return st, st.body.pos

    _, jpos = jax.jit(lambda s: jax.lax.scan(body, s, None, length=960))(js)
    jpos = np.asarray(jpos)
    ts = tq.set_mode(tq.init_state(tp, tc, torch.from_numpy(start), torch.zeros(2, 3)), 7, tc)
    ts = dataclasses.replace(ts, setpoint=torch.from_numpy(sp))
    tpos = []
    for _ in range(960):
        ts = tq.step(ts, tp, tc, 7)[0]
        tpos.append(ts.body.pos)
    tpos = torch.stack(tpos).numpy()
    np.testing.assert_allclose(tpos, jpos, atol=1e-3)
    assert np.abs(tpos[479, 0] - [0.0, 0.0, 1.0]).max() < 0.1
    assert np.abs(tpos[959, 1] - [1.0, -1.0, 1.5]).max() < 0.3
    np.testing.assert_array_equal(ts.setpoint.numpy(), sp)


def _random_state(conv, seed=0):
    jc, jp, _, _ = _model(conv)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2.0, 2.0, size=(N_RAND, 3)).astype(np.float32)
    pos[:, 2] = rng.uniform(1.0, 5.0, size=N_RAND) * (-1.0 if conv == "NED_FRD" else 1.0)
    orn = rng.uniform(-0.3, 0.3, size=(N_RAND, 3)).astype(np.float32)
    st = jq.set_mode(jq.init_state(jp, jc, jnp.asarray(pos), jnp.asarray(orn)), 7, jc)
    body = st.body.replace(lin_vel=jnp.asarray(rng.uniform(-1, 1, size=(N_RAND, 3)).astype(np.float32)),
                           ang_vel=jnp.asarray(rng.uniform(-1, 1, size=(N_RAND, 3)).astype(np.float32)))
    return st.replace(body=body)


def _setpoint(conv, step):
    rng = np.random.default_rng(200 + step)
    sp = rng.uniform(-2.0, 2.0, size=(N_RAND, 4)).astype(np.float32)
    sp[:, 2] = rng.uniform(-np.pi, np.pi, size=N_RAND)
    sp[:, 3] = rng.uniform(1.0, 4.0, size=N_RAND) * (-1.0 if conv == "NED_FRD" else 1.0)
    return sp


@functools.lru_cache(maxsize=None)
def _reference(conv):
    jc, jp, _, _ = _model(conv)
    step = jax.jit(lambda s: jq.step(s, jp, jc, 7))
    st = _random_state(conv)
    traj = []
    for i in range(10):
        st, contact = step(st.replace(setpoint=jnp.asarray(_setpoint(conv, i))))
        traj.append((jax.tree.map(np.asarray, st), np.asarray(contact)))
    return jax.tree.map(np.asarray, _random_state(conv)), traj


def _assert_close(got, ref, msg):
    p = got.pids
    for name, a, b in (
        ("view", got.read.view, ref.read.view), ("pos", got.body.pos, ref.body.pos),
        ("quat", got.body.quat, ref.body.quat), ("lin_vel", got.body.lin_vel, ref.body.lin_vel),
        ("ang_vel", got.body.ang_vel, ref.body.ang_vel), ("pwm", got.pwm, ref.pwm),
        ("lin_pos", p.lin_pos.integral, ref.pids.lin_pos.integral),
        ("lin_vel_pid", p.lin_vel.prev_error, ref.pids.lin_vel.prev_error),
        ("ang_pos", p.ang_pos.integral, ref.pids.ang_pos.integral),
        ("z_pos", p.z_pos.prev_error, ref.pids.z_pos.prev_error),
        ("z_vel", p.z_vel.integral, ref.pids.z_vel.integral),
    ):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, err_msg=f"{msg} {name}")


@pytest.mark.parametrize("conv", ["ENU_FLU", "NED_FRD"])
def test_mode7_model_step_matches_jax(conv):
    _, _, tc, tp = _model(conv)
    jstate0, traj = _reference(conv)
    st = quadx_state_from_jax(jstate0, "cpu")
    np.testing.assert_allclose(tq.mode_default_setpoint(st, 7, tc).numpy(),
                               np.asarray(jq.mode_default_setpoint(jax.tree.map(jnp.asarray, jstate0), 7, None)))
    for i, (ref, contact) in enumerate(traj):
        st = dataclasses.replace(st, setpoint=torch.from_numpy(_setpoint(conv, i)))
        st, c = tq.step(st, tp, tc, 7)
        _assert_close(st, ref, f"step {i}")
        np.testing.assert_array_equal(c.numpy(), contact)


@pytest.mark.parametrize("path", ["packed_twin", "step_drop_in"])
def test_generic_twin_mode7_matches_jax(path):
    """The generic kernel's twin on the 80-row layout, and ``cuda_quadx.step``
    (pack → twin → unpack, ``physics_steps`` advanced), ENU."""
    _, _, tc, tp = _model("ENU_FLU")
    jstate0, traj = _reference("ENU_FLU")
    template = quadx_state_from_jax(jstate0, "cpu")
    consts = cq.generic_consts(tp, tc)
    seed = torch.zeros(1, dtype=torch.int64)
    packed, st = cq.pack_state(template, 7), template
    for i, (ref, contact) in enumerate(traj):
        sp = torch.from_numpy(_setpoint("ENU_FLU", i))
        if path == "packed_twin":
            packed[cq._SP : cq._SP + 4] = sp.T
            packed = cq.packed_step(packed, seed, consts, 7, False)
            st, c = cq.unpack_state(packed, template), packed[cq._ANY] > 0.5
            assert packed.shape == (cq.ROWS_MODE7, N_RAND) and not packed[cq._ZV_PRV + 1 :].any()
        else:
            st, c = cq.step(dataclasses.replace(st, setpoint=sp), tp, tc, 7, consts=consts)
            np.testing.assert_array_equal(st.physics_steps.numpy(), ref.physics_steps)
        _assert_close(st, ref, f"step {i}")
        np.testing.assert_array_equal(c.numpy(), contact)


def test_pack_state_mode7_matches_pallas_layout():
    jstate0, traj = _reference("ENU_FLU")
    for jst in (jstate0, traj[-1][0]):  # zero and live cascade banks
        ref = np.asarray(pallas_quadx.pack_state(jax.tree.map(jnp.asarray, jst), 7)).reshape(pallas_quadx.ROWS_MODE7, -1)
        got = cq.pack_state(quadx_state_from_jax(jst, "cpu"), 7)
        np.testing.assert_array_equal(got.numpy(), ref)
    assert (cq._LP_INT, cq._ZV_PRV, cq.ROWS_MODE7) == (pallas_quadx._LP_INT, pallas_quadx._ZV_PRV, pallas_quadx.ROWS_MODE7)
    back = cq.unpack_state(got, quadx_state_from_jax(jstate0, "cpu"))
    np.testing.assert_array_equal(back.pids.ang_pos.prev_error.numpy(), traj[-1][0].pids.ang_pos.prev_error)


# ---------------------------------------------------------------------------
# the fused waypoints step
# ---------------------------------------------------------------------------


def _chase(st):  # command the current target's world position (mode 7)
    cur = jnp.take_along_axis(st.wp.targets, jnp.minimum(st.wp.idx, NT - 1)[:, None, None], axis=1)[:, 0]
    return jnp.concatenate([cur[:, :2], jnp.zeros((N, 1)), cur[:, 2:]], axis=-1)


def _rates(i):
    a = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(5), i), (N, 4), minval=-0.6, maxval=0.6)
    return a.at[:, 3].set(jnp.abs(a[:, 3]) * 0.3)


def _pwm(i):
    a = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(6), i), (N, 4), minval=0.1, maxval=0.6)
    return a.at[: N // 3].set(0.0)  # a third of the fleet falls onto the ground plane


CASES = {  # mode: (env kwargs, reset key, steps, action(step, state))
    7: (dict(goal_reach_distance=0.6), 1, 32, lambda i, st: _chase(st)),
    0: (dict(max_duration_seconds=0.3), 2, 12, lambda i, st: _rates(i)),
    8: (dict(), 3, 20, lambda i, st: _pwm(i)),
}


def _trap(st):
    """Lanes 0-3 past their last target: truncated, env_complete."""
    flag = jnp.arange(N) < 4
    return st.replace(wp=st.wp.replace(idx=jnp.where(flag, NT, st.wp.idx)),
                      truncation=st.truncation | flag, env_complete=st.env_complete | flag)


@functools.lru_cache(maxsize=None)
def _env_reference(mode):
    kw, key, steps, action = CASES[mode]
    base = JWaypointsEnv(noisy_motors=False, flight_mode=mode, **kw)
    st, _ = vec_reset(base, jax.random.split(jax.random.PRNGKey(key), N))
    if mode == 7:
        st = _trap(st)
    st0 = st
    step = jax.jit(jax.vmap(base.step))
    traj = []
    for i in range(steps):
        act = action(i, st)
        st, out = step(st, act)
        traj.append((np.asarray(act), jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, st)))
    return base, st0, traj


@pytest.mark.parametrize("mode", [7, 0])
def test_pack_env_state_matches_jax(mode):
    """Row by row, at the reset and after the run (targets advanced: the
    rolled rows)."""
    base, st0, traj = _env_reference(mode)
    jenv = JPackedEnv(base=base)
    env = PackedQuadXWaypointsEnv(QuadXWaypointsEnv(noisy_motors=False, flight_mode=mode, **CASES[mode][0],
                                                    device="cpu"))
    for jst in (st0, jax.tree.map(jnp.asarray, traj[-1][2])):
        ref = packed_waypoints_from_jax(jenv.pack_env_state(jst), "cpu")
        got = env.pack_env_state(waypoints_state_from_jax(jax.tree.map(np.asarray, jst), device="cpu"))
        assert got.shape == (cq.rows_for_waypoints(mode), N) == ref.shape
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert int(jnp.max(traj[-1][2].wp.idx)) > 0 or mode == 0
    ref_obs = jenv._obs(jenv.pack_env_state(st0).reshape(ref.shape[0], -1))
    obs = env._obs(env.pack_env_state(waypoints_state_from_jax(jax.tree.map(np.asarray, st0), device="cpu")))
    for k in ("attitude", "target_deltas"):
        np.testing.assert_allclose(obs[k].numpy(), np.asarray(ref_obs[k]), atol=1e-6)


@pytest.mark.parametrize("mode", [7, 0, 8])
def test_packed_twin_matches_the_jax_env(mode):
    kw, _, _, _ = CASES[mode]
    _, st0, traj = _env_reference(mode)
    plain = QuadXWaypointsEnv(noisy_motors=False, flight_mode=mode, **kw, device="cpu")
    env = PackedQuadXWaypointsEnv(plain)
    carried = waypoints_state_from_jax(jax.tree.map(np.asarray, st0), device="cpu")
    ps = PackedWaypointsState(packed=env.pack_env_state(carried), generator=None)
    ts = carried
    launches = cq.WAYPOINTS_KERNEL.launches
    reaches = 0
    for i, (act, ref, _) in enumerate(traj):
        a = torch.from_numpy(act)
        ps, out = env.step(ps, a)
        ts, tout = plain.step(ts, a)
        for got in (out, tout):
            for name, x, y in (("termination", got.termination, ref.termination),
                               ("truncation", got.truncation, ref.truncation),
                               *((k, got.info[k], ref.info[k]) for k in
                                 ("collision", "out_of_bounds", "env_complete", "num_targets_reached"))):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f"step {i} {name}")
        err = np.abs(out.reward.numpy() - ref.reward)
        live = ~np.asarray(ref.termination) if mode == 8 else np.ones(N, bool)
        for part in ("attitude", "target_deltas"):
            d = np.abs(out.obs[part].numpy() - ref.obs[part]).reshape(N, -1).max(-1)
            err = np.maximum(err, np.where(live, d, 0.0))
        if mode == 7:
            assert int((err > 5e-4 + 4e-4 * i).sum()) <= 4, f"step {i}: lanes diverged"
            frozen = (ps.packed[:, :4] - env.pack_env_state(carried)[:, :4])  # the trap lanes
            assert not frozen[cq._POS : cq._SP].any() and not frozen[cq._RWD + 1 : cq._STEP].any()
        else:
            assert err.max() <= 5e-4 + 2e-4 * i, f"step {i}: error {err.max()}"
        reaches += int((ref.reward >= 99.0).sum())
    if mode == 7:
        assert reaches > 0
    if mode == 8:
        assert out.termination.any() and (~out.termination).any()
    assert out.info["num_targets_reached"].dtype == torch.int32
    assert cq.WAYPOINTS_KERNEL.launches == launches  # CPU tensors: the twin, no launch


def test_waypoints_consts_layout_matches_the_c_struct():
    import ctypes
    import re

    src = (cuda_build.CSRC / cq.WAYPOINTS_KERNEL.source).read_text()
    body = re.search(r"struct WaypointsConsts \{(.*?)\};", src, re.S).group(1)
    c_fields = [(name, ctype, int(n or 1))
                for ctype, name, n in re.findall(r"^\s*(float|int) (\w+)(?:\[(\d+)\])?;", body, re.M)]
    py_fields = []
    for name, t in cq._WaypointsConstsC._fields_:
        n, base = (t._length_, t._type_) if issubclass(t, ctypes.Array) else (1, t)
        py_fields.append((name, {ctypes.c_float: "float", ctypes.c_int: "int"}[base], n))
    assert py_fields == c_fields and len(c_fields) == len(dataclasses.fields(cq.WaypointsConsts))


def test_waypoints_envelope_raises():
    _, _, tc, tp = _model("ENU_FLU")
    with pytest.raises(NotImplementedError, match="1..4 targets"):
        cq.waypoints_consts(tp, tc, 4, 5.0, 300, 5, 0.2)
    _, _, tc_ned, tp_ned = _model("NED_FRD")
    with pytest.raises(NotImplementedError, match="ENU"):
        cq.waypoints_consts(tp_ned, tc_ned, 4, 5.0, 300, 4, 0.2)
    c = cq.waypoints_consts(tp, tc, 4, 5.0, 300, 4, 0.2)
    seed = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="modes 0, 7 and 8"):
        cq.packed_waypoints_step(torch.zeros(88, 4), seed, c, 9, False)
    with pytest.raises(ValueError, match="112, N"):
        cq.packed_waypoints_step(torch.zeros(88, 4), seed, c, 7, False)
    for kw in (dict(use_yaw_targets=True), dict(flight_mode=9), dict(num_targets=5)):
        with pytest.raises(NotImplementedError):
            PackedQuadXWaypointsEnv(QuadXWaypointsEnv(device="cpu", **kw))


def test_twin_motor_noise_spreads_the_throttle():
    """Noise on: the throttle spreads across identical lanes; one seed gives
    one draw, another seed another."""
    env = PackedQuadXWaypointsEnv(QuadXWaypointsEnv(flight_mode=7, noisy_motors=False, device="cpu"))
    st, _ = env.reset(256, torch.Generator().manual_seed(2))
    packed = st.packed.clone()
    packed[:, :] = packed[:, :1]  # 256 copies of lane 0
    c = env.consts
    quiet = cq.packed_waypoints_step_plain(packed, torch.tensor([1]), c, 7, False)
    noisy = cq.packed_waypoints_step_plain(packed, torch.tensor([1]), c, 7, True)
    assert quiet[cq._THR : cq._THR + 4].std(1).max() == 0
    assert (noisy[cq._THR : cq._THR + 4].std(1) > 1e-4).all()
    assert torch.equal(noisy, cq.packed_waypoints_step_plain(packed, torch.tensor([1]), c, 7, True))
    assert not torch.equal(noisy, cq.packed_waypoints_step_plain(packed, torch.tensor([2]), c, 7, True))
