"""The QuadX flight modes -1..10, the gain-scheduled mode 10 (``ops/ga_pid``),
custom controllers and ``ops/boring_bodies`` of the port against the JAX
package on the same numpy-seeded inputs, f32 on both sides, noise off.

Tolerances: ``ga_pid_step`` atol 1e-6; ``update_control`` atol 1e-5 on the
PWM and every PID register, 1e-4 on the registers and PWM of the paths
where a derivative term (kd / control period) amplifies f32 rounding;
the default setpoints of ``set_mode`` exactly; the closed loops below hold
the view to ``1e-4 + 5e-5 * step`` and the PWM to ``2e-4 + 1e-4 * step``:
the rounding of two f32 programs, grown by the loop where the derivative
terms and the motor saturation amplify it (worst seen over 60 steps:
2.3e-3 on the view and 4.4e-3 on the PWM, on a NED mode-5 lane whose
thrust swings between 0.15 and 0.7 from one step to the next).

The JAX programs are few: one jitted function computes every mode's
control of one convention, and one steps every mode's fleet of one
convention.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyflyt_tpu.models import quadx as jq
from pyflyt_tpu.ops import boring_bodies as jbb
from pyflyt_tpu.ops import ga_pid as jga
from pyflyt_tpu_torch.convert import quadx_params_from_jax, quadx_state_from_jax
from pyflyt_tpu_torch.core.math import wrap_angle
from pyflyt_tpu_torch.models import quadx as tq
from pyflyt_tpu_torch.ops import boring_bodies as tbb
from pyflyt_tpu_torch.ops import ga_pid as tga

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

MODES = tuple(range(-1, 11))
CONVS = ("ENU_FLU", "NED_FRD")
CASCADE_MODES = (1, 2, 3, 4, 5, 6, 10)  # the closed loops: the modes this slice adds that fly a cascade
N_CONTROL = 256
N_LOOP = 64
LOOP_STEPS = 60
Q = np.float32(0.785398)

T = torch.from_numpy


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _close(t, j, atol, msg=""):
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=atol, rtol=0.0, err_msg=msg)


# ---------------------------------------------------------------------------
# ops/ga_pid
# ---------------------------------------------------------------------------


def _boundary_yaws() -> np.ndarray:
    """The quadrant ends and their f32 neighbours, and yaws past ±pi."""
    ends = np.array([Q, -Q, 3 * Q, -3 * Q, np.float32(2.356194), np.float32(-2.356194)], np.float32)
    near = np.concatenate([ends, np.nextafter(ends, np.float32(9)), np.nextafter(ends, np.float32(-9))])
    past = np.array([3.3, -3.3, 4.0, -4.0, 7.0, -7.0, 2 * np.pi + Q, -2 * np.pi - Q, np.pi, -np.pi], np.float32)
    return np.concatenate([near, past]).astype(np.float32)


def test_yaw_quadrant_keeps_the_reference_ends():
    """The ``where`` chain's closed and open ends, on exact f32 yaws."""
    yaw = _boundary_yaws()
    want = np.where((yaw >= -Q) & (yaw <= Q), 0,
                    np.where((yaw > Q) & (yaw <= 3 * Q), 1, np.where((yaw < -Q) & (yaw >= -3 * Q), 2, 3)))
    got = tga.yaw_quadrant(T(yaw)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got[1] == 0 and got[2] == 1 and got[3] == 2  # ±Q closed; +3Q, -3Q closed
    assert set(got.tolist()) == {0, 1, 2, 3}


def test_ga_pid_step_matches_jax():
    """4096 seeded states, among them yaws on every quadrant end, yaws past
    ±pi that need the wrap, and psi setpoints past ±pi; atol 1e-6."""
    rng = np.random.default_rng(6)
    n = 4096
    state = rng.normal(size=(n, 4, 3)).astype(np.float32)
    state[:, 3] *= 3.0  # positions
    state[:, 1, 2] = rng.uniform(-4.0, 4.0, size=n)  # yaw, past ±pi too
    b = _boundary_yaws()
    state[: len(b), 1, 2] = b
    state[len(b) : 2 * len(b), 1, 0] = b  # roll past ±pi: wrapped as well
    sp = rng.normal(size=(n, 4)).astype(np.float32) * 3.0
    sp[:, 2] = rng.uniform(-7.0, 7.0, size=n)  # psi setpoints past ±pi
    sp[: len(b), 2] = b[::-1]
    want = np.asarray(jax.jit(jga.ga_pid_step)(jnp.asarray(state), jnp.asarray(sp)))
    got = tga.ga_pid_step(T(state), T(sp))
    _close(got, want, atol=1e-6)
    quad = tga.yaw_quadrant(wrap_angle(T(state[:, 1, 2]))).numpy()
    assert set(quad.tolist()) == {0, 1, 2, 3}


def test_ga_pid_gains_are_the_reference_matrices():
    np.testing.assert_array_equal(tga._K, jga._K)
    np.testing.assert_array_equal(tga._USS, jga._USS)
    assert tga._QUARTER == jga._QUARTER


# ---------------------------------------------------------------------------
# ops/boring_bodies
# ---------------------------------------------------------------------------


def test_drag_wrench_matches_jax():
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(3, 3)).astype(np.float32)
    const = rng.uniform(0.01, 0.2, size=(3, 3)).astype(np.float32)
    vel = rng.normal(size=(512, 3, 3)).astype(np.float32) * 5.0
    vel[:8] = 0.0  # sign(0) = 0 on both sides
    jf, jt = jax.jit(jbb.drag_wrench)(jnp.asarray(vel), jbb.BoringBodyParams(jnp.asarray(pos), jnp.asarray(const)))
    tf, tt = tbb.drag_wrench(T(vel), tbb.BoringBodyParams(T(pos), T(const)))
    _close(tf, jf, atol=1e-5)
    _close(tt, jt, atol=1e-5)


# ---------------------------------------------------------------------------
# models/quadx: update_control and set_mode in every mode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=CONVS)
def conv(request):
    cfg = jq.QuadXConfig(orn_conv=request.param, noisy_motors=False)
    jp = jq.build_params(cfg)
    tp = quadx_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tq.QuadXConfig(orn_conv=request.param, noisy_motors=False), tp


def _airborne(cfg, jp, n, rng, spread=1.0):
    """JAX states of ``n`` drones 2-6 m up (down in NED), tilted and moving."""
    sign = -1.0 if cfg.orn_conv == "NED_FRD" else 1.0
    pos = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    pos[:, 2] = sign * rng.uniform(2, 6, size=n)
    orn = (rng.uniform(-0.3, 0.3, size=(n, 3)) * spread).astype(np.float32)
    orn[:, 2] = rng.uniform(-3.0, 3.0, size=n)
    st = jq.init_state(jp, cfg, jnp.asarray(pos), jnp.asarray(orn))
    vel = (rng.uniform(-1, 1, size=(n, 3)) * spread).astype(np.float32)
    avel = (rng.uniform(-1, 1, size=(n, 3)) * spread).astype(np.float32)
    body = st.body.replace(lin_vel=jnp.asarray(vel), ang_vel=jnp.asarray(avel))
    return st.replace(body=body, read=jq.update_state(body, cfg))


def _random_pids(st, rng):
    return jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32) * 0.1), st.pids)


def _setpoints(mode, cfg, view, rng, n):
    """Per-mode setpoints in each mode's units."""
    ned = cfg.orn_conv == "NED_FRD"
    u = lambda lo, hi: rng.uniform(lo, hi, size=n).astype(np.float32)  # noqa: E731
    if mode in (-1, 8):
        return np.stack([u(0, 1) for _ in range(4)], -1)
    if mode == 9:
        return np.stack([u(-0.1, 0.1), u(-0.1, 0.1), u(-0.1, 0.1), u(0.2, 0.5)], -1)
    pos = np.asarray(view[:, 3])
    if mode in (7, 10):
        return np.stack([pos[:, 0] + u(-1, 1), pos[:, 1] + u(-1, 1), u(-3.5, 3.5), pos[:, 2] + u(-0.5, 0.5)], -1)
    thrust = u(0.2, 0.6) * (-1.0 if ned else 1.0)
    if mode == 0:
        return np.stack([u(-0.5, 0.5), u(-0.5, 0.5), u(-0.5, 0.5), thrust], -1)
    z = pos[:, 2] + u(-0.5, 0.5) if mode in (2, 3, 4) else u(-0.5, 0.5)  # height or climb rate
    if mode in (1, 3):  # angles
        return np.stack([u(-0.2, 0.2), u(-0.2, 0.2), u(-3, 3), z], -1)
    return np.stack([u(-0.5, 0.5), u(-0.5, 0.5), u(-0.3, 0.3), z], -1)  # rates or velocities


@pytest.fixture(scope="module")
def control_ref(conv):
    """256 random airborne states with random PID registers and setpoints
    in each mode -1..10, and JAX's control and default setpoint of each,
    from one jitted function."""
    cfg, jp, _, _ = conv
    rng = np.random.default_rng(11 if cfg.orn_conv == "ENU_FLU" else 12)
    base = _airborne(cfg, jp, N_CONTROL, rng)
    states = []
    for mode in MODES:
        sp = _setpoints(mode, cfg, base.read.view, rng, N_CONTROL)
        states.append(base.replace(setpoint=jnp.asarray(sp), pids=_random_pids(base, rng)))

    @jax.jit
    def control_all(states):
        return tuple(jq.update_control(s, jp, cfg, m) for s, m in zip(states, MODES)), tuple(
            jq.mode_default_setpoint(s, m, cfg) for s, m in zip(states, MODES)
        )

    out, default = control_all(tuple(states))
    return dict(zip(MODES, zip(states, out, default)))


@pytest.mark.parametrize("mode", MODES)
def test_update_control_matches_jax(conv, control_ref, mode):
    """The PWM and every PID register, and ``set_mode``'s default setpoint
    exactly."""
    cfg, _, tcfg, tp = conv
    js, jo, jd = control_ref[mode]
    ts = quadx_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    to = tq.update_control(ts, tp, tcfg, mode)
    # the cascades' derivative paths: kd / period on the ang-vel, lin-vel and z-vel banks
    atol = 1e-4 if mode in range(8) else 1e-5
    _close(to.pwm, jo.pwm, atol, msg=f"{cfg.orn_conv} mode {mode} pwm")
    for bank in ("ang_vel", "ang_pos", "lin_vel", "lin_pos", "z_pos", "z_vel"):
        for reg in ("integral", "prev_error"):
            got = getattr(getattr(to.pids, bank), reg)
            want = getattr(getattr(jo.pids, bank), reg)
            _close(got, want, 1e-5, msg=f"{cfg.orn_conv} mode {mode} {bank}.{reg}")
    np.testing.assert_array_equal(_np(to.setpoint), np.asarray(jo.setpoint))
    td = tq.set_mode(ts, mode, tcfg)
    np.testing.assert_array_equal(_np(td.setpoint), np.asarray(jd), err_msg=f"mode {mode} default setpoint")
    assert not any(getattr(td.pids, b).integral.any() for b in ("ang_vel", "ang_pos", "z_vel"))
    if mode == -1:  # raw PWM before the saturation step
        np.testing.assert_array_equal(_np(to.pwm), np.asarray(js.setpoint))
    with pytest.raises(ValueError, match="-1..10"):
        tq.update_control(ts, tp, tcfg, 11)


# ---------------------------------------------------------------------------
# models/quadx.step: closed loops
# ---------------------------------------------------------------------------


def _loop_setpoints(mode, cfg, view, rng, n):
    """Setpoints a loop can hold for 60 steps without tumbling."""
    sp = _setpoints(mode, cfg, view, rng, n)
    if mode == 2:
        sp[:, :3] *= 0.2  # body rates
    if mode == 10:
        sp[:, 2] = rng.uniform(-3.0, 3.0, size=n)
    return sp


@pytest.fixture(scope="module")
def loop_ref(conv):
    """The seven fleets (modes 1-6 and 10, 64 lanes each) and JAX's view
    and PWM after each of 60 steps, from one jitted step of all seven."""
    cfg, jp, _, _ = conv
    rng = np.random.default_rng(21 if cfg.orn_conv == "ENU_FLU" else 22)
    fleets = []
    for mode in CASCADE_MODES:
        st = jq.set_mode(_airborne(cfg, jp, N_LOOP, rng, spread=0.3), mode, cfg)
        sp = _loop_setpoints(mode, cfg, st.read.view, rng, N_LOOP)
        fleets.append(st.replace(setpoint=jnp.asarray(sp)))

    @jax.jit
    def step_all(states):
        return tuple(jq.step(s, jp, cfg, m)[0] for s, m in zip(states, CASCADE_MODES))

    js, traj = tuple(fleets), []
    for _ in range(LOOP_STEPS):
        js = step_all(js)
        traj.append([(np.asarray(s.read.view), np.asarray(s.pwm)) for s in js])
    return {m: (fleets[k], [t[k] for t in traj]) for k, m in enumerate(CASCADE_MODES)}


@pytest.mark.parametrize("mode", CASCADE_MODES)
def test_closed_loop_matches_jax(conv, loop_ref, mode):
    """60 steps of ``quadx.step`` from the JAX state carried across, lane
    by lane against the jitted JAX step."""
    cfg, _, tcfg, tp = conv
    start, traj = loop_ref[mode]
    ours = quadx_state_from_jax(jax.tree.map(np.asarray, start), device="cpu")
    for i, (view, pwm) in enumerate(traj):
        ours, _ = tq.step(ours, tp, tcfg, mode)
        where = f"{cfg.orn_conv} mode {mode} step {i}"
        _close(ours.read.view, view, 1e-4 + 5e-5 * i, msg=f"{where} view")
        _close(ours.pwm, pwm, 2e-4 + 1e-4 * i, msg=f"{where} pwm")
    assert np.isfinite(_np(ours.read.view)).all()
    assert not ours.contact.any(), f"mode {mode}: a lane fell"


# ---------------------------------------------------------------------------
# custom controllers
# ---------------------------------------------------------------------------


def _orbit_jax(view, setpoint):
    """examples/core/05_custom_controller.py's orbit controller."""
    pos = view[..., 3, :]
    angle = jnp.arctan2(pos[..., 1], pos[..., 0]) + 0.3
    return jnp.stack([2.0 * jnp.cos(angle), 2.0 * jnp.sin(angle), setpoint[..., 2], setpoint[..., 3]], axis=-1)


def _orbit_torch(view, setpoint):
    pos = view[..., 3, :]
    angle = torch.atan2(pos[..., 1], pos[..., 0]) + 0.3
    return torch.stack([2.0 * torch.cos(angle), 2.0 * torch.sin(angle), setpoint[..., 2], setpoint[..., 3]], dim=-1)


def test_orbit_custom_controller_in_modes_7_and_10():
    """The orbit controller over mode 7 (ENU, the example's) and mode 10
    (NED, the convention its gains were tuned for), 40 steps on 16 lanes,
    lane by lane against JAX; the controller's output is what the mode
    flies, the state's setpoint untouched."""
    rng = np.random.default_rng(31)
    cases = []
    for mode, conv_name in ((7, "ENU_FLU"), (10, "NED_FRD")):
        cfg = jq.QuadXConfig(orn_conv=conv_name, noisy_motors=False)
        jp = jq.build_params(cfg)
        st = jq.set_mode(_airborne(cfg, jp, 16, rng, spread=0.2), mode, cfg)
        z = -1.5 if conv_name == "NED_FRD" else 1.5
        st = st.replace(setpoint=jnp.tile(jnp.asarray([0.0, 0.0, 0.0, z], jnp.float32), (16, 1)))
        cases.append((mode, cfg, jp, st))

    @jax.jit
    def step_both(states):
        return tuple(jq.step(s, jp, cfg, m, custom_controller=_orbit_jax)[0]
                     for s, (m, cfg, jp, _) in zip(states, cases))

    js = tuple(c[3] for c in cases)
    ours = [quadx_state_from_jax(jax.tree.map(np.asarray, s), device="cpu") for s in js]
    tps = [quadx_params_from_jax(jax.tree.map(np.asarray, c[2]), device="cpu") for c in cases]
    tcfgs = [tq.QuadXConfig(orn_conv=c[1].orn_conv, noisy_motors=False) for c in cases]
    for i in range(40):
        js = step_both(js)
        for k, (mode, *_rest) in enumerate(cases):
            ours[k], _ = tq.step(ours[k], tps[k], tcfgs[k], mode, custom_controller=_orbit_torch)
            _close(ours[k].read.view, js[k].read.view, 1e-4 + 5e-5 * i, msg=f"mode {mode} step {i} view")
            _close(ours[k].pwm, js[k].pwm, 2e-4 + 1e-4 * i, msg=f"mode {mode} step {i} pwm")
    for k, (mode, *_rest) in enumerate(cases):
        # the state keeps the user's setpoint; the controller's output is the
        # setpoint the mode's controller sees
        np.testing.assert_array_equal(_np(ours[k].setpoint), np.asarray(cases[k][3].setpoint))
        steered = dataclasses.replace(ours[k], setpoint=_orbit_torch(ours[k].read.view, ours[k].setpoint))
        a = tq.update_control(ours[k], tps[k], tcfgs[k], mode, custom_controller=_orbit_torch)
        b = tq.update_control(steered, tps[k], tcfgs[k], mode)
        assert torch.equal(a.pwm, b.pwm) and torch.equal(a.pids.lin_pos.prev_error, b.pids.lin_pos.prev_error)
        assert not torch.equal(a.pwm, tq.update_control(ours[k], tps[k], tcfgs[k], mode).pwm)
