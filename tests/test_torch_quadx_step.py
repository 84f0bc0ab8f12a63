"""The generic QuadX step (``ops/cuda_quadx.packed_step``, its plain twin
on CPU tensors, and the ``cuda_quadx.step`` drop-in) against the JAX
package's ``models.quadx.step`` with a wind field (XLA).

Each case carries one seeded JAX state (drones in the air, so the
detection-grade contact of the kernel is not reached) into the port with
``convert.quadx_state_from_jax`` and steps both packages 6 aviary steps,
noise off, ``max_gust=0``, over modes 0/8/9 × ENU/NED × wind none, a
baked base and a per-env base. Tolerance: 1e-4 on the read, position,
velocities and quaternion (f32 rounding of both the 6 chained steps and
the native ``atan2``/``asin``), 1e-5 on the PWM; contact flags exact. The
layouts (``pack_state``, the C constants struct) are held exactly. The
gusts and the motor noise of the twin are held by their distribution.
"""

import ctypes
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyflyt_tpu.core import wind as jwind
from pyflyt_tpu.models import quadx as jq
from pyflyt_tpu.ops import pallas_quadx
from pyflyt_tpu_torch.convert import quadx_state_from_jax
from pyflyt_tpu_torch.core import wind as twind
from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
from pyflyt_tpu_torch.models import quadx as tq
from pyflyt_tpu_torch.ops import cuda_build
from pyflyt_tpu_torch.ops import cuda_quadx as cq

torch.set_num_threads(1)

N = 24
STEPS = 6
ATOL = 1e-4
CONVS = ["ENU_FLU", "NED_FRD"]
MODES = [0, 8, 9]
WINDS = ["none", "baked", "env"]


def _cfgs(conv):
    kw = dict(orn_conv=conv, control_hz=80, noisy_motors=False)
    return jq.QuadXConfig(**kw), tq.QuadXConfig(**kw)


@functools.lru_cache(maxsize=None)
def _params(conv):
    jc, tc = _cfgs(conv)
    return jq.build_params(jc), tq.build_params(tc, "cpu")


def _setpoints(mode, conv, step):
    rng = np.random.default_rng(100 + step)
    sp = rng.uniform(-0.5, 0.5, size=(N, 4)).astype(np.float32)
    if mode == 0:
        sp[:, 3] = rng.uniform(0.2, 0.6, size=N) * (-1.0 if conv == "NED_FRD" else 1.0)
    elif mode == 8:
        sp = rng.uniform(0.1, 0.6, size=(N, 4)).astype(np.float32)
    else:
        sp[:, :3] *= 0.1
        sp[:, 3] = rng.uniform(0.3, 0.5, size=N)
    return sp


def _bases(kind):
    rng = np.random.default_rng(7)
    if kind == "none":
        return np.zeros((N, 3), np.float32)
    if kind == "baked":
        return np.tile(np.array([[3.0, -2.0, 0.5]], np.float32), (N, 1))
    return rng.uniform(-4.0, 4.0, size=(N, 3)).astype(np.float32)


def _jax_state(conv, mode, seed=0):
    """Seeded drones 1-5 m up (down in NED), tilted and moving."""
    jp, _ = _params(conv)
    jc, _ = _cfgs(conv)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2.0, 2.0, size=(N, 3)).astype(np.float32)
    pos[:, 2] = rng.uniform(1.0, 5.0, size=N) * (-1.0 if conv == "NED_FRD" else 1.0)
    orn = rng.uniform(-0.3, 0.3, size=(N, 3)).astype(np.float32)
    st = jq.set_mode(jq.init_state(jp, jc, jnp.asarray(pos), jnp.asarray(orn)), mode, jc)
    body = st.body.replace(
        lin_vel=jnp.asarray(rng.uniform(-1, 1, size=(N, 3)).astype(np.float32)),
        ang_vel=jnp.asarray(rng.uniform(-1, 1, size=(N, 3)).astype(np.float32)),
    )
    return st.replace(body=body)


@functools.lru_cache(maxsize=None)
def _jax_step_fn(conv, mode):
    """One jitted XLA aviary step per (convention, mode), the wind's base
    an argument; zero base = no wind (R^T (v - 0) is R^T v exactly)."""
    jp, _ = _params(conv)
    jc, _ = _cfgs(conv)

    def f(st, base):
        def field(b, step, pos):  # one env's field, as the vmapped JAX envs hold it
            return jwind.GaussianWind(base_wind=b, key=jax.random.PRNGKey(0), max_gust=jnp.float32(0.0),
                                      orn_conv=conv)(step, pos)

        return jq.step(st, jp, jc, mode, None, wind_fn=lambda step, pos: jax.vmap(field)(base, step, pos))

    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _reference(conv, mode, kind):
    st = _jax_state(conv, mode)
    step = _jax_step_fn(conv, mode)
    base = jnp.asarray(_bases(kind))
    traj = []
    for i in range(STEPS):
        st = st.replace(setpoint=jnp.asarray(_setpoints(mode, conv, i)))
        st, contact = step(st, base)
        traj.append((jax.tree.map(np.asarray, st), np.asarray(contact)))
    return jax.tree.map(np.asarray, _jax_state(conv, mode)), traj


def _assert_close(got: tq.QuadXState, ref, msg):
    pairs = (
        ("view", got.read.view, ref.read.view, ATOL),
        ("drag_local_vel", got.read.drag_local_vel, ref.read.drag_local_vel, ATOL),
        ("pos", got.body.pos, ref.body.pos, ATOL),
        ("quat", got.body.quat, ref.body.quat, ATOL),
        ("lin_vel", got.body.lin_vel, ref.body.lin_vel, ATOL),
        ("ang_vel", got.body.ang_vel, ref.body.ang_vel, ATOL),
        ("pwm", got.pwm, ref.pwm, 1e-5),
        ("throttle", got.throttle, ref.throttle, 1e-5),
        ("pid", got.pids.ang_vel.integral, ref.pids.ang_vel.integral, 1e-5),
    )
    for name, a, b, tol in pairs:
        np.testing.assert_allclose(a.numpy(), b, atol=tol, err_msg=f"{msg} {name}")


def _wind_spec(conv, kind):
    """The kernel's wind for a case (bases in the env convention)."""
    if kind == "none":
        return None
    if kind == "baked":
        base = torch.from_numpy(_bases(kind)[0])
        if conv == "NED_FRD":
            base = twind.ned_to_enu(base)
        return {"kind": "gaussian", "base": tuple(base.tolist()), "max_gust": 0.0}
    return {"kind": "gaussian", "per_env_base": True, "max_gust": 0.0}


@pytest.mark.parametrize("kind", WINDS)
@pytest.mark.parametrize("conv", CONVS)
@pytest.mark.parametrize("mode", MODES)
def test_packed_step_twin_matches_xla_step(mode, conv, kind):
    """The plain twin on packed rows, the wind in the launch's constants
    (a per-env base in rows 51-53, in ENU)."""
    jstate0, traj = _reference(conv, mode, kind)
    _, tp = _params(conv)
    _, tc = _cfgs(conv)
    template = quadx_state_from_jax(jstate0, "cpu")
    packed = cq.pack_state(template)
    base_enu = torch.from_numpy(_bases(kind))
    if conv == "NED_FRD":
        base_enu = twind.ned_to_enu(base_enu)
    if kind == "env":
        packed[cq._WBASE : cq._WBASE + 3] = base_enu.T
    consts = cq.generic_consts(tp, tc)
    seed = torch.zeros(1, dtype=torch.int64)
    for i, (ref, ref_contact) in enumerate(traj):
        packed[cq._SP : cq._SP + 4] = torch.from_numpy(_setpoints(mode, conv, i)).T
        packed = cq.packed_step(packed, seed, consts, mode, False, _wind_spec(conv, kind))
        _assert_close(cq.unpack_state(packed, template), ref, f"step {i}")
        np.testing.assert_array_equal((packed[cq._ANY] > 0.5).numpy(), ref_contact)
    if kind == "env":  # the per-env base is written through
        np.testing.assert_array_equal(packed[cq._WBASE : cq._WBASE + 3].numpy(), base_enu.T.numpy())
    else:
        assert not packed[cq._WBASE:].any()


@pytest.mark.parametrize("conv", CONVS)
@pytest.mark.parametrize("mode", MODES)
def test_step_drop_in_matches_xla_step(mode, conv):
    """``cuda_quadx.step`` with the port's ``GaussianWind`` (per-env base)
    against the XLA step with the JAX field: pack → kernel twin → unpack,
    ``physics_steps`` advanced by the ratio."""
    jstate0, traj = _reference(conv, mode, "env")
    _, tp = _params(conv)
    _, tc = _cfgs(conv)
    st = quadx_state_from_jax(jstate0, "cpu")
    wind = twind.GaussianWind.init(None, N, base_wind=torch.from_numpy(_bases("env")), max_gust=0.0,
                                   orn_conv=conv, device="cpu")
    for i, (ref, ref_contact) in enumerate(traj):
        st = dataclasses.replace(st, setpoint=torch.from_numpy(_setpoints(mode, conv, i)))
        st, contact = cq.step(st, tp, tc, mode, None, wind=wind)
        _assert_close(st, ref, f"step {i}")
        np.testing.assert_array_equal(contact.numpy(), ref_contact)
        np.testing.assert_array_equal(st.physics_steps.numpy(), ref.physics_steps)


@pytest.mark.parametrize("conv", CONVS)
def test_models_step_with_wind_matches_xla_step(conv):
    """The port's ``models.quadx.step(wind_fn=GaussianWind)``, per-env base,
    mode 9: the plain path the mod-hovering env steps."""
    jstate0, traj = _reference(conv, 9, "env")
    _, tp = _params(conv)
    _, tc = _cfgs(conv)
    st = quadx_state_from_jax(jstate0, "cpu")
    wind = twind.GaussianWind.init(None, N, base_wind=torch.from_numpy(_bases("env")), max_gust=0.0,
                                   orn_conv=conv, device="cpu")
    for i, (ref, ref_contact) in enumerate(traj):
        st = dataclasses.replace(st, setpoint=torch.from_numpy(_setpoints(9, conv, i)))
        st, contact = tq.step(st, tp, tc, 9, None, wind_fn=wind)
        _assert_close(st, ref, f"step {i}")
        np.testing.assert_array_equal(contact.numpy(), ref_contact)


def test_pack_state_matches_pallas_layout():
    """``pack_state`` against ``pallas_quadx.pack_state`` with the TPU's
    (56, 8, N/8) fold undone."""
    jstate0, _ = _reference("NED_FRD", 9, "env")
    ref = pallas_quadx.pack_state(jax.tree.map(jnp.asarray, jstate0), 9)
    ref = np.asarray(ref).reshape(pallas_quadx.ROWS, N)
    got = cq.pack_state(quadx_state_from_jax(jstate0, "cpu"))
    assert got.shape == (cq.ROWS, N) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (cq._ANY, cq._WBASE) == (pallas_quadx._CON + 1, pallas_quadx._WBASE)


def test_generic_consts_layout_matches_the_c_struct():
    """The kernel reads its constants as ``struct GenericConsts``: the
    ctypes mirror must list the same fields, types and array lengths in
    order."""
    src = (cuda_build.CSRC / cq.GENERIC_KERNEL.source).read_text()
    body = re.search(r"struct GenericConsts \{(.*?)\};", src, re.S).group(1)
    c_fields = [
        (name, ctype, int(n or 1))
        for ctype, name, n in re.findall(r"^\s*(float|int) (\w+)(?:\[(\d+)\])?;", body, re.M)
    ]
    py_fields = []
    for name, t in cq._GenericConstsC._fields_:
        n, base = (t._length_, t._type_) if issubclass(t, ctypes.Array) else (1, t)
        py_fields.append((name, {ctypes.c_float: "float", ctypes.c_int: "int"}[base], n))
    assert len(c_fields) == len(dataclasses.fields(cq.GenericConsts))
    assert py_fields == c_fields
    # the wind kinds are the header's enum
    hdr = (cuda_build.CSRC / "quadx_lane.cuh").read_text()
    for name in ("WIND_NONE", "WIND_GAUSSIAN", "WIND_GAUSSIAN_ENV", "WIND_SIMPLE"):
        assert re.search(rf"{name} = {getattr(cq, name)},", hdr), name


def test_consts_struct_carries_the_values():
    _, tp = _params("NED_FRD")
    _, tc = _cfgs("NED_FRD")
    c = cq.generic_consts(tp, tc, {"kind": "gaussian", "base": (1.0, 2.0, 3.0), "max_gust": 7.0})
    s = cq._GenericConstsC.of(c)
    assert (s.ned, s.ratio, s.wind_kind) == (1, 3, cq.WIND_GAUSSIAN)
    assert list(s.wind_base) == [1.0, 2.0, 3.0] and s.max_gust == 7.0
    np.testing.assert_allclose(list(s.motor_map), tp.motor_map.reshape(-1).numpy())
    assert cq.with_wind(c, None) is c
    assert cq.with_wind(c, {"kind": "simple", "strength": 2.0}).wind_kind == cq.WIND_SIMPLE


def test_mode_7_and_other_modes_raise():
    """Mode 7 takes its 80-row layout and the ENU cascade only (NED mode 7
    runs on models/quadx.step); modes outside 0/7/8/9 raise."""
    packed = torch.zeros(cq.ROWS, 4)
    seed = torch.zeros(1, dtype=torch.int64)
    _, tp = _params("ENU_FLU")
    _, tc = _cfgs("ENU_FLU")
    c = cq.generic_consts(tp, tc)
    with pytest.raises(ValueError, match="80, N"):
        cq.packed_step(packed, seed, c, 7, False)
    assert cq.packed_step(torch.zeros(cq.ROWS_MODE7, 4), seed, c, 7, False).shape == (cq.ROWS_MODE7, 4)
    _, tp_ned = _params("NED_FRD")
    _, tc_ned = _cfgs("NED_FRD")
    with pytest.raises(NotImplementedError, match="ENU cascade only"):
        cq.packed_step(torch.zeros(cq.ROWS_MODE7, 4), seed, cq.generic_consts(tp_ned, tc_ned), 7, False)
    with pytest.raises(NotImplementedError, match="modes 0, 7, 8 and 9"):
        cq.packed_step_plain(packed, seed, c, 1, False)
    with pytest.raises(ValueError):
        cq.packed_step(packed.double(), seed, c, 9, False)
    with pytest.raises(ValueError, match="wind kind"):
        cq.generic_consts(tp, tc, {"kind": "tornado"})


def _hovering_rows(conv, n, base):
    """Level drones at rest 5 m up with a per-env wind base (ENU), at one
    physics iteration per step (control at 240 Hz), so the new drag read is
    R^T (0 - wind) = -wind exactly."""
    tc = tq.QuadXConfig(orn_conv=conv, control_hz=240, noisy_motors=False)
    tp = tq.build_params(tc, "cpu")
    z = -5.0 if conv == "NED_FRD" else 5.0
    st = tq.init_state(tp, tc, torch.tensor([0.0, 0.0, z]).expand(n, 3), torch.zeros(n, 3))
    packed = cq.pack_state(st)
    packed[cq._WBASE : cq._WBASE + 3] = torch.tensor(base, dtype=torch.float32)[:, None]
    return tp, tc, packed


def test_twin_gusts_are_clipped_unit_normals():
    """Gusts on drones at rest: the drag read is minus base minus gust; over
    4096 x 3 draws the gust has mean 0 (5 standard errors) and std 1 (5%),
    clipped at max_gust; one seed gives one draw, another seed another."""
    n = 4096
    base = torch.tensor([1.0, -2.0, 0.5])[:, None]
    tp, tc, packed = _hovering_rows("ENU_FLU", n, [1.0, -2.0, 0.5])
    c = cq.generic_consts(tp, tc, {"kind": "gaussian", "per_env_base": True, "max_gust": 7.0})
    seed = torch.tensor([5])
    out = cq.packed_step_plain(packed, seed, c, 9, False)
    gust = -out[cq._DRG : cq._DRG + 3] - base
    assert (gust.abs() <= 7.0 + 1e-5).all()
    assert (gust.mean(1).abs() < 5 / np.sqrt(n)).all()
    np.testing.assert_allclose(gust.std(1).numpy(), 1.0, rtol=0.05)
    assert torch.equal(out, cq.packed_step_plain(packed, seed, c, 9, False))
    assert not torch.equal(out, cq.packed_step_plain(packed, torch.tensor([6]), c, 9, False))
    tight = cq.with_wind(c, {"kind": "gaussian", "per_env_base": True, "max_gust": 0.25})
    g2 = -cq.packed_step_plain(packed, seed, tight, 9, False)[cq._DRG : cq._DRG + 3] - base
    assert g2.abs().max() <= 0.25 + 1e-5 and (g2.abs() > 0.2499).float().mean() > 0.5


def test_twin_simple_wind_thermal_mean():
    """The simple field at 5 m (ENU): the upward thermal ln(6)·strength on
    top of unit noise (means within 5 standard errors); the drag read is
    minus the wind."""
    n = 4096
    tp, tc, packed = _hovering_rows("ENU_FLU", n, [0.0, 0.0, 0.0])
    out = cq.packed_step_plain(packed, torch.tensor([9]), cq.generic_consts(tp, tc), 8, False,
                               {"kind": "simple", "strength": 2.0})
    w = -out[cq._DRG : cq._DRG + 3]
    se = 5 / np.sqrt(n)
    assert abs(float(w[2].mean()) - np.log(6.0) * 2.0) < se
    assert w[:2].mean(1).abs().max() < se
    np.testing.assert_allclose(w.std(1).numpy(), 1.0, rtol=0.05)


def test_twin_motor_noise_spreads_the_throttle():
    n = 1024
    tp, tc, packed = _hovering_rows("ENU_FLU", n, [0.0, 0.0, 0.0])
    packed[cq._SP : cq._SP + 4] = 0.4
    c = cq.generic_consts(tp, tc)
    quiet = cq.packed_step_plain(packed, torch.tensor([1]), c, 8, False)
    noisy = cq.packed_step_plain(packed, torch.tensor([1]), c, 8, True)
    assert quiet[cq._THR : cq._THR + 4].std(1).max() == 0
    assert (noisy[cq._THR : cq._THR + 4].std(1) > 1e-4).all()


def test_ned_mode_0_clips_the_thrust_command():
    """NED mode 0 takes thrust commands in [-1, 0]: a positive command is
    clipped to zero thrust, a negative one is thrust (ENU the mirror)."""
    outs = {}
    for conv, z in (("NED_FRD", -0.6), ("NED_FRD", 0.6), ("ENU_FLU", 0.6)):
        tp, tc, packed = _hovering_rows(conv, 2, [0.0, 0.0, 0.0])
        packed[cq._SP : cq._SP + 4] = torch.tensor([0.0, 0.0, 0.0, z])[:, None]
        out = cq.packed_step_plain(packed, torch.zeros(1, dtype=torch.int64), cq.generic_consts(tp, tc), 0, False)
        outs[(conv, z)] = out[cq._PWM : cq._PWM + 4, 0]
    np.testing.assert_allclose(outs[("NED_FRD", -0.6)].numpy(), outs[("ENU_FLU", 0.6)].numpy(), atol=1e-7)
    np.testing.assert_allclose(outs[("NED_FRD", 0.6)].numpy(), tc.min_pwm, atol=1e-7)


def test_use_kernel_env_matches_plain_env():
    """``QuadXHoverEnv(use_kernel=True)`` (each aviary step through the
    generic kernel, here its twin) follows the plain env; lanes that hit
    the ground differ after the contact (detection-grade), where they
    terminate with -100 in both."""
    plain = QuadXHoverEnv(noisy_motors=False, device="cpu")
    kern = dataclasses.replace(plain, use_kernel=True)
    sp, _ = plain.reset(N)
    sk, _ = kern.reset(N)
    launches = cq.GENERIC_KERNEL.launches
    rng = np.random.default_rng(3)
    for i in range(20):
        a = rng.uniform(-0.6, 0.6, size=(N, 4)).astype(np.float32)
        a[:, 3] = np.abs(a[:, 3]) + 0.2
        a[: N // 3] = 0.0
        a = torch.from_numpy(a)
        sp, op = plain.step(sp, a)
        sk, ok = kern.step(sk, a)
        live = ~op.termination
        np.testing.assert_allclose(ok.obs[live].numpy(), op.obs[live].numpy(), atol=2e-4)
        np.testing.assert_allclose(ok.reward.numpy(), op.reward.numpy(), atol=2e-4)
        np.testing.assert_array_equal(ok.termination.numpy(), op.termination.numpy())
    assert op.termination.any() and (~op.termination).any()
    assert cq.GENERIC_KERNEL.launches == launches  # CPU tensors: the twin, no launch
