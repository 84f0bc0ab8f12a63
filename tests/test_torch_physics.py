"""The port's physics chain against the JAX package on the same seeded
inputs: core/math, ops/pid, ops/motors, core/integrator, models/quadx
(modes 0, 8, 9; -1, 1, 2 and 10 for a step) and the kernel helpers of ops/cuda_math.

Tolerance: f32 on both sides, atol 1e-5 unless a case states otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyflyt_tpu.core import integrator as jint
from pyflyt_tpu.core import math as jm
from pyflyt_tpu.core.state import Body6DoF as JBody
from pyflyt_tpu.models import quadx as jq
from pyflyt_tpu.ops import motors as jmot
from pyflyt_tpu.ops import pallas_math as jpm
from pyflyt_tpu.ops import pid as jpid
from pyflyt_tpu_torch.convert import quadx_params_from_jax
from pyflyt_tpu_torch.core import integrator as tint
from pyflyt_tpu_torch.core import math as tm
from pyflyt_tpu_torch.core.state import Body6DoF as TBody
from pyflyt_tpu_torch.models import quadx as tq
from pyflyt_tpu_torch.ops import cuda_math as tcm
from pyflyt_tpu_torch.ops import motors as tmot
from pyflyt_tpu_torch.ops import pid as tpid

torch.set_num_threads(1)

ATOL = 1e-5
N = 64
RNG = np.random.default_rng(20261016)


def _f32(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _unit_quats(n):
    q = _f32(n, 4)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _close(t, j, atol=ATOL, rtol=0.0, msg=""):
    np.testing.assert_allclose(
        np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t),
        np.asarray(j), atol=atol, rtol=rtol, err_msg=msg,
    )


T = torch.from_numpy

# ---------------------------------------------------------------------------
# core/math
# ---------------------------------------------------------------------------

Q1, Q2 = _unit_quats(N), _unit_quats(N)
V3 = _f32(N, 3)
RPY = (RNG.uniform(-1.4, 1.4, size=(N, 3))).astype(np.float32)
OMEGA = _f32(N, 3, scale=3.0)
OMEGA[:4] = 0.0  # the Taylor branch of quat_integrate

MATH_CASES = {
    "quat_mul": (lambda m: m.quat_mul, (Q1, Q2)),
    "quat_conj": (lambda m: m.quat_conj, (Q1,)),
    "quat_rotate": (lambda m: m.quat_rotate, (Q1, V3)),
    "quat_rotate_inv": (lambda m: m.quat_rotate_inv, (Q1, V3)),
    "quat_to_rotmat": (lambda m: m.quat_to_rotmat, (Q1,)),
    "euler_to_quat": (lambda m: m.euler_to_quat, (RPY,)),
    "quat_to_euler": (lambda m: m.quat_to_euler, (Q1,)),
    "euler_to_rotmat": (lambda m: m.euler_to_rotmat, (RPY,)),
    "quat_integrate": (lambda m: (lambda q, w: m.quat_integrate(q, w, 1.0 / 240.0)), (Q1, OMEGA)),
    "normalize": (lambda m: m.normalize, (V3,)),
    "safe_norm": (lambda m: m.safe_norm, (np.concatenate([V3[:-1], np.zeros((1, 3), np.float32)]),)),
    "enu_pos_to_ned": (lambda m: m.enu_pos_to_ned, (V3,)),
    "flu_vec_to_frd": (lambda m: m.flu_vec_to_frd, (V3,)),
    "enu_euler_to_ned": (lambda m: m.enu_euler_to_ned, (RPY,)),
}


@pytest.mark.parametrize("name", sorted(MATH_CASES))
def test_math_matches_jax(name):
    pick, args = MATH_CASES[name]
    out_t = pick(tm)(*[T(a) for a in args])
    out_j = pick(jm)(*[jnp.asarray(a) for a in args])
    _close(out_t, out_j, atol=ATOL)


def test_quat_identity():
    q = tm.quat_identity((2, 3), device="cpu")
    _close(q, jm.quat_identity((2, 3)))


# ---------------------------------------------------------------------------
# ops/cuda_math: the tensor twins of the kernel helpers
# ---------------------------------------------------------------------------


def test_cuda_math_rotmat_and_integrate_match_jax_kernel_helpers():
    q = list(T(Q1).unbind(-1))
    jq_ = list(jnp.asarray(Q1).T)
    for a, b in zip(tcm.quat_rotmat(q), jpm.quat_rotmat(jq_)):
        _close(a, b)
    w = list(T(OMEGA).unbind(-1))
    jw = list(jnp.asarray(OMEGA).T)
    for a, b in zip(tcm.quat_integrate(q, w, 1.0 / 240.0), jpm.quat_integrate(jq_, jw, 1.0 / 240.0)):
        _close(a, b)


def test_cuda_math_euler_native_vs_polynomial_and_exact():
    """Native atan2/asin agree with core/math exactly (f32) and with the
    Pallas module's minimax polynomials to their stated 2e-5 rad."""
    q = list(T(Q1).unbind(-1))
    ours = torch.stack(tcm.quat_to_euler(q), -1)
    _close(ours, jm.quat_to_euler(jnp.asarray(Q1)), atol=1e-6)
    poly = jnp.stack(jpm.quat_to_euler(list(jnp.asarray(Q1).T)), -1)
    _close(ours, poly, atol=2e-5)


# ---------------------------------------------------------------------------
# ops/pid, ops/motors
# ---------------------------------------------------------------------------


def test_pid_step_matches_jax():
    gains = [np.abs(_f32(3)) for _ in range(4)]
    jp = jpid.PIDParams(*[jnp.asarray(g) for g in gains], period=1.0 / 120.0)
    tp = tpid.PIDParams(*[T(g) for g in gains], period=1.0 / 120.0)
    integ, prev, meas, sp = _f32(N, 3), _f32(N, 3), _f32(N, 3), _f32(N, 3)
    js, jo = jpid.step(jpid.PIDState(jnp.asarray(integ), jnp.asarray(prev)), jp, meas, sp)
    ts, to = tpid.step(tpid.PIDState(T(integ), T(prev)), tp, T(meas), T(sp))
    _close(to, jo, atol=1e-4, rtol=1e-6)  # kd/period amplifies f32 rounding
    _close(ts.integral, js.integral)
    _close(ts.prev_error, js.prev_error)
    z = tpid.init(tp, (5,))
    assert z.integral.shape == (5, 3) and not z.integral.any()


@pytest.fixture(scope="module")
def params():
    cfg = jq.QuadXConfig(noisy_motors=False)
    jp = jq.build_params(cfg)
    return cfg, jp, quadx_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def test_build_params_matches_jax_and_converter(params):
    _, jp, conv = params
    built = tq.build_params(tq.QuadXConfig(noisy_motors=False), device="cpu")
    for a, b in zip(_leaves(built), _leaves(conv)):
        _close(a, b, atol=0.0)
    _close(built.motor.max_rpm, jp.motor.max_rpm, atol=0.0)


def _leaves(x):
    if dataclasses.is_dataclass(x):
        out = []
        for f in dataclasses.fields(x):
            out += _leaves(getattr(x, f.name))
        return out
    return [x] if isinstance(x, torch.Tensor) else []


def test_motors_match_jax(params):
    _, jp, tp = params
    thr, pwm = np.abs(_f32(N, 4)) * 0.5, np.abs(_f32(N, 4)) * 0.5
    j_thr = jmot.throttle_update(jnp.asarray(thr), jnp.asarray(pwm), jp.motor, 1.0 / 240.0)
    t_thr = tmot.throttle_update(T(thr), T(pwm), tp.motor, 1.0 / 240.0)
    _close(t_thr, j_thr, atol=1e-6)
    jf, jt = jmot.wrench(jnp.asarray(thr), jp.motor)
    tf, tt = tmot.wrench(T(thr), tp.motor)
    _close(tf, jf, rtol=1e-5, atol=1e-9)
    _close(tt, jt, rtol=1e-5, atol=1e-11)


def test_motor_noise_draws_from_the_generator(params):
    _, _, tp = params
    thr = torch.full((4096, 4), 0.4)
    g = torch.Generator().manual_seed(3)
    a = tmot.throttle_update(thr, thr, tp.motor, 1.0 / 240.0, g)
    b = tmot.throttle_update(thr, thr, tp.motor, 1.0 / 240.0, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    rel = ((a - 0.4) / 0.4).std().item()
    assert abs(rel - 0.02) < 0.002  # noise_ratio of cf2x


# ---------------------------------------------------------------------------
# core/integrator
# ---------------------------------------------------------------------------


def _bodies(n, z_scale=1.0, z_off=1.0):
    pos = _f32(n, 3) * z_scale
    pos[:, 2] = np.abs(pos[:, 2]) * 0.05 + z_off
    arrs = dict(pos=pos, quat=_unit_quats(n), lin_vel=_f32(n, 3), ang_vel=_f32(n, 3, scale=2.0))
    return (JBody(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            TBody(**{k: T(v) for k, v in arrs.items()}))


@pytest.mark.parametrize("full", [False, True])
def test_integrator_step_matches_jax(full):
    jb, tb = _bodies(N)
    mass = np.float32(0.027)
    if full:
        a = _f32(3, 3) * 1e-6
        inertia = (a @ a.T + np.diag([1.4e-5, 1.4e-5, 2.2e-5])).astype(np.float32)
    else:
        inertia = np.array([1.4e-5, 1.4e-5, 2.17e-5], np.float32)
    fb, tb_ = _f32(N, 3, scale=0.3), _f32(N, 3, scale=1e-6)
    jr = jint.step(jb, jint.RigidBodyParams(jnp.asarray(mass), jnp.asarray(inertia), full),
                   jnp.asarray(fb), jnp.asarray(tb_), 1.0 / 240.0)
    tr = tint.step(tb, tint.RigidBodyParams(T(np.asarray(mass)), T(inertia), full),
                   T(fb), T(tb_), 1.0 / 240.0)
    for name in ("pos", "quat", "lin_vel", "ang_vel"):
        # ang_vel: torque / 1e-5 inertia scales f32 rounding by ~1e5
        _close(getattr(tr, name), getattr(jr, name), atol=1e-5, rtol=1e-5, msg=name)


def test_ground_contact_matches_jax():
    # half the bodies straddle the ground plane (corners 1-5 cm below it)
    jb, tb = _bodies(N, z_off=0.0)
    h = np.array([0.045, 0.045, 0.01], np.float32)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32) * h
    rb_j = jint.RigidBodyParams(jnp.asarray(np.float32(0.027)), jnp.asarray([1.4e-5, 1.4e-5, 2.17e-5]))
    rb_t = tint.RigidBodyParams(torch.tensor(0.027), torch.tensor([1.4e-5, 1.4e-5, 2.17e-5]))
    jr, jc = jint.ground_contact(jb, rb_j, jint.ContactGeom(points=jnp.asarray(corners)))
    tr, tc = tint.ground_contact(tb, rb_t, tint.ContactGeom(points=T(corners)))
    assert tc.any() and (~tc).any()
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for name in ("pos", "quat", "lin_vel", "ang_vel"):
        _close(getattr(tr, name), getattr(jr, name), atol=1e-4, rtol=1e-5, msg=name)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tint.ground_contact(tb, rb_t, tint.ContactGeom(points=T(corners)), per_point_iters=2)


# ---------------------------------------------------------------------------
# models/quadx
# ---------------------------------------------------------------------------


def _drone_states(params, mode, n=N):
    cfg, jp, tp = params
    pos = _f32(n, 3, scale=0.5)
    pos[:, 2] = np.abs(pos[:, 2]) + 0.3
    pos[: n // 8, 2] = 0.005  # a few drones touch the ground
    orn = RNG.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    js = jq.init_state(jp, cfg, jnp.asarray(pos), jnp.asarray(orn))
    ts = tq.init_state(tp, tq.QuadXConfig(noisy_motors=False), T(pos), T(orn))
    js = jq.set_mode(js, mode, cfg)
    ts = tq.set_mode(ts, mode, tq.QuadXConfig(noisy_motors=False))
    vel, avel = _f32(n, 3, scale=0.5), _f32(n, 3, scale=1.0)
    js = js.replace(body=js.body.replace(lin_vel=jnp.asarray(vel), ang_vel=jnp.asarray(avel)))
    ts = dataclasses.replace(ts, body=dataclasses.replace(ts.body, lin_vel=T(vel), ang_vel=T(avel)))
    sp = (RNG.uniform(-0.5, 0.5, size=(n, 4)) + np.array([0, 0, 0, 0.5])).astype(np.float32)
    js = js.replace(setpoint=jnp.asarray(sp))
    ts = dataclasses.replace(ts, setpoint=T(sp))
    return js, ts


@pytest.mark.parametrize("mode", [0, 8, 9])
def test_quadx_step_matches_jax(params, mode):
    """Five aviary steps from seeded states, some in ground contact."""
    cfg, jp, tp = params
    js, ts = _drone_states(params, mode)
    tcfg = tq.QuadXConfig(noisy_motors=False)
    jstep = jax.jit(lambda s: jq.step(s, jp, cfg, mode))
    for i in range(5):
        js, jc = jstep(js)
        ts, tc = tq.step(ts, tp, tcfg, mode)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc), err_msg=f"contact step {i}")
        _close(ts.pwm, js.pwm, atol=1e-5, msg=f"pwm step {i}")
        _close(ts.throttle, js.throttle, atol=1e-5, msg=f"throttle step {i}")
        _close(ts.read.view, js.read.view, atol=1e-4, msg=f"view step {i}")
        _close(ts.body.pos, js.body.pos, atol=1e-5, msg=f"pos step {i}")
        _close(ts.body.quat, js.body.quat, atol=1e-5, msg=f"quat step {i}")
        _close(ts.pids.ang_vel.integral, js.pids.ang_vel.integral, atol=1e-5)
    assert tc.any()
    np.testing.assert_array_equal(ts.physics_steps.numpy(), np.asarray(js.physics_steps))


@pytest.mark.parametrize("mode", [-1, 1, 2, 10])
def test_unported_modes_raise_with_roadmap_item(params, mode):
    """Modes -1, 1, 2 and 10 once raised naming their ROADMAP.md item; they
    are ported: one aviary step from the seeded states matches JAX, and only
    a mode outside -1..10 raises, naming no item."""
    cfg, jp, tp = params
    js, ts = _drone_states(params, mode)
    tcfg = tq.QuadXConfig(noisy_motors=False)
    js, jc = jax.jit(lambda s: jq.step(s, jp, cfg, mode))(js)
    ts, tc = tq.step(ts, tp, tcfg, mode)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _close(ts.pwm, js.pwm, atol=1e-4, msg="pwm")
    _close(ts.read.view, js.read.view, atol=1e-4, msg="view")
    _close(ts.body.pos, js.body.pos, atol=1e-5, msg="pos")
    with pytest.raises(ValueError, match="-1..10") as err:
        tq.step(ts, tp, tcfg, 11)
    assert "ROADMAP" not in str(err.value)


def test_update_state_ned_matches_jax(params):
    _, jp, tp = params
    jb, tb = _bodies(N)
    cfg_j = jq.QuadXConfig(orn_conv="NED_FRD")
    cfg_t = tq.QuadXConfig(orn_conv="NED_FRD")
    jr, tr = jq.update_state(jb, cfg_j), tq.update_state(tb, cfg_t)
    _close(tr.view, jr.view, atol=1e-5)
    _close(tr.drag_local_vel, jr.drag_local_vel, atol=1e-5)


def test_saturation_rescale_matches_jax():
    pwm = _f32(N, 4, scale=0.8)
    pwm[0] = 0.5  # high == low
    pwm[1] = [1.5, 1.0, 1.0, 1.0]  # pmax - low == 0 with high != low
    _close(tq.saturation_rescale(T(pwm), 0.05, 1.0), jq.saturation_rescale(jnp.asarray(pwm), 0.05, 1.0))
