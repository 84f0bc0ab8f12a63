"""The Fixedwing model and kernel K5's twins against the JAX package.

- ``ops/lifting_surfaces``: ``build`` field by field, the coefficients
  over an angle-of-attack sweep through both stall branches and the
  wrench, fixedwing (flapless main wing) and acrowing (every surface
  flapped). Tolerance 1e-5 (f32 rounding of the same formulas).
- ``models/fixedwing``: ``build_params``, ``init_state``, ``update_state``
  and ``step`` in modes -1 and 0 for both vehicles, from numpy-seeded
  airborne states: 1e-4 on each of 30 steps' state, and 2e-3 on the
  position after 30 steps.
- The row-5 twin (``cuda_fixedwing.packed_step_plain``) and the row-7
  drop-in (``cuda_fixedwing.step``) against the XLA
  ``models.fixedwing.step`` at tests/test_pallas_fixedwing.py's
  tolerances (position 3e-5 for one step, 2e-3 after 30), contact flags
  exact; ``pack_state`` against ``pallas_fixedwing.pack_state`` row by
  row, exact; the constants against ``pallas_fixedwing._bake`` and the C
  struct; the twin's motor noise by its statistics.
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

from pyflyt_tpu.models import fixedwing as jf
from pyflyt_tpu.ops import lifting_surfaces as jls
from pyflyt_tpu.ops import pallas_fixedwing
from pyflyt_tpu_torch.convert import fixedwing_state_from_jax
from pyflyt_tpu_torch.models import fixedwing as tf
from pyflyt_tpu_torch.ops import cuda_build
from pyflyt_tpu_torch.ops import cuda_fixedwing as cf
from pyflyt_tpu_torch.ops import lifting_surfaces as tls

torch.set_num_threads(1)

MODELS = ("fixedwing", "acrowing")
N = 32
STEPS = 30


@functools.lru_cache(maxsize=None)
def _model(model):
    jc = jf.FixedwingConfig(drone_model=model, noisy_motors=False)
    tc = tf.FixedwingConfig(drone_model=model, noisy_motors=False)
    return jc, jf.build_params(jc), tc, tf.build_params(tc, "cpu")


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# lifting surfaces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", MODELS)
def test_surface_params_match_jax(model):
    _, jp, _, tp = _model(model)
    for f in dataclasses.fields(tls.SurfaceParams):
        np.testing.assert_array_equal(_np(getattr(tp.surfaces, f.name)), _np(getattr(jp.surfaces, f.name)), f.name)
    flapped = _np(tp.surfaces.deflection_limit) != 0
    assert flapped.all() if model == "acrowing" else flapped.tolist() == [True] * 4 + [False]


@pytest.mark.parametrize("model", MODELS)
def test_aero_coefficients_and_wrench_match_jax(model):
    """An angle sweep over (-pi, pi] at several deflections, so both stall
    branches and the flap algebra run on every surface; then the wrench
    from random surface velocities (slow ones post-stall) and a zero
    airspeed (the grad-safe norm)."""
    _, jp, _, tp = _model(model)
    rng = np.random.default_rng(0)
    alpha = np.linspace(-np.pi, np.pi, 181, dtype=np.float32)[1:, None].repeat(5, 1)
    act = rng.uniform(-1, 1, size=alpha.shape).astype(np.float32)
    ref = jls.aero_coefficients(jnp.asarray(alpha), jnp.asarray(act), jp.surfaces)
    got = tls.aero_coefficients(torch.from_numpy(alpha), torch.from_numpy(act), tp.surfaces)
    stall_p = _np(tp.surfaces.alpha_stall_P_base)
    assert (alpha > stall_p).any(axis=0).all() and (np.abs(alpha) < 0.05).any()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)

    vel = (rng.normal(size=(64, 5, 3)) * np.array([8.0, 3.0, 3.0]) + np.array([10.0, 0, 0])).astype(np.float32)
    vel[0] = 0.0
    act = rng.uniform(-1, 1, size=(64, 5)).astype(np.float32)
    jfo, jto = jls.wrench(jnp.asarray(act), jnp.asarray(vel), jp.surfaces, jp.com_offset)
    tfo, tto = tls.wrench(torch.from_numpy(act), torch.from_numpy(vel), tp.surfaces, tp.com_offset)
    np.testing.assert_allclose(tfo.numpy(), np.asarray(jfo), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tto.numpy(), np.asarray(jto), atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(tfo[0].numpy(), 0.0)
    alpha_j, fs_j = jls.aoa_freestream(jnp.asarray(vel), jp.surfaces)
    alpha_t, fs_t = tls.aoa_freestream(torch.from_numpy(vel), tp.surfaces)
    np.testing.assert_allclose(alpha_t.numpy(), np.asarray(alpha_j), atol=1e-6)
    np.testing.assert_allclose(fs_t.numpy(), np.asarray(fs_j), rtol=1e-6)
    np.testing.assert_allclose(
        tls.actuation_update(torch.from_numpy(act), torch.zeros(64, 5), tp.surfaces, 1 / 240).numpy(),
        np.asarray(jls.actuation_update(jnp.asarray(act), jnp.zeros((64, 5)), jp.surfaces, 1 / 240)), atol=1e-7)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", MODELS)
def test_build_params_matches_jax(model):
    _, jp, _, tp = _model(model)
    for name in ("mass", "inertia", "com_offset", "contact_points", "assist_ids", "assist_signs"):
        np.testing.assert_array_equal(_np(getattr(tp, name)), _np(getattr(jp, name)), name)
    for f in ("positions", "thrust_unit", "thrust_coef", "torque_coef", "tau", "max_rpm", "noise_ratio"):
        np.testing.assert_array_equal(_np(getattr(tp.motor, f)), _np(getattr(jp.motor, f)), f)
    inertia = _np(tp.inertia)
    assert inertia[0, 2] != 0.0 and np.allclose(inertia, inertia.T)  # the raised tail's xz term


def _random_state(model, mode, seed=0, alt=50.0, n=N):
    """tests/test_pallas_fixedwing.py's states from a numpy seed: cruise,
    slow (post-stall) and climbing, tilted and spinning, surfaces and
    throttle away from rest; the setpoint held."""
    jc, jp, _, _ = _model(model)
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(-5, 5, size=(n, 3)) + [0.0, 0.0, alt]).astype(np.float32)
    orn = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    st = jf.init_state(jp, jc, jnp.asarray(pos), jnp.asarray(orn), mode)
    st = st.replace(
        body=st.body.replace(
            lin_vel=jnp.asarray((np.array([15.0, 0.0, 0.0]) + 6.0 * rng.normal(size=(n, 3))).astype(np.float32)),
            ang_vel=jnp.asarray((0.6 * rng.normal(size=(n, 3))).astype(np.float32)),
        ),
        actuation=jnp.asarray((0.4 * rng.normal(size=(n, 5))).astype(np.float32)),
        throttle=jnp.asarray(np.abs(0.5 * rng.normal(size=(n, 1))).astype(np.float32)),
    )
    sp = rng.uniform(-0.6, 0.6, size=(n, 6 if mode == -1 else 4)).astype(np.float32)
    sp[:, -1] = np.abs(sp[:, -1])
    st = st.replace(setpoint=jnp.asarray(sp), read=jf.update_state(st.body, jp, jc, st.physics_steps))
    return jax.tree.map(np.asarray, st)


@functools.lru_cache(maxsize=None)
def _trajectory(model, mode):
    """STEPS chained XLA steps from ``_random_state``: (state0, [(state,
    contact)])."""
    jc, jp, _, _ = _model(model)
    st0 = _random_state(model, mode)

    def body(st, _):
        st, contact = jf.step(st, jp, jc, mode)
        return st, (st, contact)

    _, traj = jax.jit(lambda s: jax.lax.scan(body, s, None, length=STEPS))(jax.tree.map(jnp.asarray, st0))
    traj = jax.tree.map(np.asarray, traj)
    return st0, [(jax.tree.map(lambda a: a[i], traj[0]), traj[1][i]) for i in range(STEPS)]


def _assert_state_close(out, ref, atol_pos=3e-5, prefix="", scale=1.0):
    """tests/test_pallas_fixedwing.py:59-93's tolerances, each times
    ``scale``."""
    for name, got, want, tol in (
        ("pos", out.body.pos, ref.body.pos, atol_pos), ("quat", out.body.quat, ref.body.quat, 1e-5),
        ("lin_vel", out.body.lin_vel, ref.body.lin_vel, 1e-3), ("ang_vel", out.body.ang_vel, ref.body.ang_vel, 2e-3),
        ("view", out.read.view, ref.read.view, 1e-3),
        ("surface_local_vel", out.read.surface_local_vel, ref.read.surface_local_vel, 1e-3),
        ("actuation", out.actuation, ref.actuation, 1e-5), ("throttle", out.throttle, ref.throttle, 1e-5),
    ):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol * scale, err_msg=f"{prefix}{name}")


@pytest.mark.parametrize("model", MODELS)
def test_init_and_update_state_match_jax(model):
    jc, jp, tc, tp = _model(model)
    rng = np.random.default_rng(1)
    pos = rng.uniform(-3, 3, size=(8, 3)).astype(np.float32)
    orn = rng.uniform(-1, 1, size=(8, 3)).astype(np.float32)
    for mode in (-1, 0):
        js = jf.init_state(jp, jc, jnp.asarray(pos), jnp.asarray(orn), mode)
        ts = tf.init_state(tp, tc, torch.from_numpy(pos), torch.from_numpy(orn), mode)
        assert ts.setpoint.shape == (8, 6 if mode == -1 else 4)
        _assert_state_close(ts, js, atol_pos=1e-6, scale=1e-2)
    st = _random_state(model, 0)
    carried = fixedwing_state_from_jax(st, "cpu")
    wind = lambda steps, p: torch.ones_like(p) * torch.tensor([3.0, -1.0, 0.5])  # noqa: E731
    jwind = lambda steps, p: jnp.ones_like(p) * jnp.asarray([3.0, -1.0, 0.5])  # noqa: E731
    for tw, jw in ((None, None), (wind, jwind)):
        got = tf.update_state(carried.body, tp, tc, carried.physics_steps, tw)
        ref = jf.update_state(jax.tree.map(jnp.asarray, st).body, jp, jc, jnp.asarray(st.physics_steps), jw)
        np.testing.assert_allclose(got.view.numpy(), np.asarray(ref.view), atol=1e-5)
        np.testing.assert_allclose(got.surface_local_vel.numpy(), np.asarray(ref.surface_local_vel), atol=1e-5)
    np.testing.assert_array_equal(tf.aux_state(carried).numpy(), np.asarray(jf.aux_state(jax.tree.map(jnp.asarray, st))))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mode", [0, -1])
def test_model_step_matches_jax(model, mode):
    """30 chained steps: 1e-4 on every step's state (f32 rounding of the
    same formulas), the test_pallas_fixedwing tolerances on the last with
    2e-3 on the position; contact flags exact (all airborne)."""
    _, _, tc, tp = _model(model)
    st0, traj = _trajectory(model, mode)
    st = fixedwing_state_from_jax(st0, "cpu")
    for i, (ref, contact) in enumerate(traj):
        st, c = tf.step(st, tp, tc, mode)
        np.testing.assert_array_equal(c.numpy(), contact)
        np.testing.assert_array_equal(st.physics_steps.numpy(), ref.physics_steps)
        for a, b in ((st.body.pos, ref.body.pos), (st.body.quat, ref.body.quat),
                     (st.body.lin_vel, ref.body.lin_vel), (st.read.view, ref.read.view),
                     (st.cmd, ref.cmd), (st.actuation, ref.actuation)):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-4, err_msg=f"step {i}")
    _assert_state_close(st, traj[-1][0], atol_pos=2e-3, prefix="t30 ")


# ---------------------------------------------------------------------------
# the row-5 twin and the row-7 drop-in
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mode", [0, -1])
@pytest.mark.parametrize("path", ["packed_twin", "step_drop_in"])
def test_twin_matches_xla_step(model, mode, path):
    """One step at tests/test_pallas_fixedwing.py's tolerances, then the
    trajectory: 2e-3 on the position after 30 steps. The packed twin keeps
    rows 54-87 zero and flags the any-contact in row 53; the drop-in
    advances ``physics_steps`` and recomputes ``cmd``."""
    _, _, tc, tp = _model(model)
    st0, traj = _trajectory(model, mode)
    template = fixedwing_state_from_jax(st0, "cpu")
    consts = cf.fixedwing_consts(tp, tc)
    seed = torch.zeros(1, dtype=torch.int64)
    launches = cf.STEP_KERNEL.launches
    packed, st = cf.pack_state(template), template
    for i, (ref, contact) in enumerate(traj):
        if path == "packed_twin":
            packed = cf.packed_step(packed, seed, consts, mode, False)
            st, c = cf.unpack_state(packed, template), packed[cf._RWD] > 0.5
            assert packed.shape == (cf.ROWS, N) and not packed[cf._RWD + 1 :].any()
        else:
            st, c = cf.step(st, tp, tc, mode, consts=consts)
            np.testing.assert_array_equal(st.physics_steps.numpy(), ref.physics_steps)
            np.testing.assert_allclose(st.cmd.numpy(), ref.cmd, atol=0.0)
        np.testing.assert_array_equal(c.numpy(), contact)
        if i == 0:
            _assert_state_close(st, ref, prefix="step 0 ")
    _assert_state_close(st, traj[-1][0], atol_pos=2e-3, prefix="t30 ")
    assert cf.STEP_KERNEL.launches == launches  # CPU tensors: the twin, no launch


def test_twin_flags_ground_contact_like_xla():
    """Half the fleet starts 5 cm above the ground, falling: the any-contact
    row matches the XLA step's flag exactly (the kernel's contact is
    detection-grade, so only the flag is held)."""
    jc, jp, tc, tp = _model("fixedwing")
    st = _random_state("fixedwing", 0, seed=4, alt=30.0)
    pos, vel = st.body.pos.copy(), st.body.lin_vel.copy()
    pos[: N // 2, 2] = 0.35
    vel[: N // 2, 2] = -3.0
    st = st.replace(body=st.body.replace(pos=pos, lin_vel=vel))
    _, ref = jf.step(jax.tree.map(jnp.asarray, st), jp, jc, 0)
    out = cf.packed_step(cf.pack_state(fixedwing_state_from_jax(st, "cpu")), torch.zeros(1, dtype=torch.int64),
                         cf.fixedwing_consts(tp, tc), 0, False)
    np.testing.assert_array_equal((out[cf._RWD] > 0.5).numpy(), np.asarray(ref))
    assert np.asarray(ref)[: N // 2].any() and not np.asarray(ref)[N // 2 :].any()


@pytest.mark.parametrize("mode", [0, -1])
def test_pack_state_matches_pallas_layout(mode):
    _, traj = _trajectory("acrowing", mode)
    for jst in (_random_state("acrowing", mode), traj[-1][0]):
        ref = np.asarray(pallas_fixedwing.pack_state(jax.tree.map(jnp.asarray, jst))).reshape(pallas_fixedwing.ROWS, -1)
        got = cf.pack_state(fixedwing_state_from_jax(jst, "cpu"))
        np.testing.assert_array_equal(got.numpy(), ref)
    names = ("_POS", "_QUAT", "_LVEL", "_AVEL", "_VIEW", "_SLV", "_ACT", "_THR", "_SP", "_CON", "_RWD", "_TERM",
             "_TRUNC", "_COLL", "_OOB", "_STEP", "_CPLT", "_TGT", "_REM", "_NDIST", "_ODIST", "_TDLT", "ROWS")
    assert [getattr(cf, k) for k in names] == [getattr(pallas_fixedwing, k) for k in names]
    back = cf.unpack_state(got, fixedwing_state_from_jax(jst, "cpu"))
    np.testing.assert_array_equal(back.read.surface_local_vel.numpy(), jst.read.surface_local_vel)
    np.testing.assert_array_equal(back.setpoint.numpy(), jst.setpoint)


@pytest.mark.parametrize("model", MODELS)
def test_consts_match_pallas_bake(model):
    """The constants hold the values ``pallas_fixedwing._bake`` computes."""
    jc, jp, tc, tp = _model(model)
    B = pallas_fixedwing._bake(jp, jc)
    c = cf.fixedwing_consts(tp, tc)
    f32 = lambda v: np.asarray(v, np.float64).astype(np.float32)  # noqa: E731
    for key, name in (("qa", "qa"), ("chord", "chord"), ("piAR_inv", "piar_inv"), ("cl3d", "cl3d"), ("cd0", "cd0"),
                      ("a0b", "a0b"), ("asPb", "asp_b"), ("asNb", "asn_b"), ("dlim_rad", "dlim_rad"),
                      ("f2c", "f2c"), ("stall_c", "stall_c")):
        np.testing.assert_allclose(f32(getattr(c, name)), f32([s[key] for s in B["surf"]]), rtol=1e-6, err_msg=name)
    for key, name in (("lu", "lu"), ("du", "du"), ("tu", "tu"), ("r_s", "r_s")):
        np.testing.assert_allclose(f32(getattr(c, name)), f32([s[key] for s in B["surf"]]).reshape(-1), atol=1e-7)
    np.testing.assert_allclose(f32(c.lag), f32([B["dt"] / t for t in B["surf_tau"]]), rtol=1e-6)
    for key, name in (("inertia", "inertia"), ("inv_inertia", "inv_inertia"), ("com", "com"), ("mot_f", "mot_f"),
                      ("mot_t", "mot_t"), ("assist_signs", "assist_signs")):
        np.testing.assert_allclose(f32(getattr(c, name)), f32(B[key]).reshape(-1), rtol=1e-6, atol=1e-12)
    assert c.assist_ids == tuple(int(v) for v in B["assist_ids"])
    np.testing.assert_allclose(f32(c.contact_pts[: 3 * len(B["contact_pts"])]), f32(B["contact_pts"]).reshape(-1))
    assert (c.inv_mass, c.mot_max_rpm, c.mot_noise, c.dt, c.ratio) == pytest.approx(
        (B["inv_mass"], B["mot_max_rpm"], B["mot_noise"], B["dt"], B["ratio"]), rel=1e-6)
    assert c.mot_lag == pytest.approx(B["dt"] / B["mot_tau"], rel=1e-6)


def test_consts_layout_matches_the_c_struct():
    src = (cuda_build.CSRC / cf.STEP_KERNEL.source).read_text()
    body = re.search(r"struct FixedwingConsts \{(.*?)\};", src, re.S).group(1)
    c_fields = [(name, ctype, int(n or 1))
                for ctype, name, n in re.findall(r"^\s*(float|int) (\w+)(?:\[(\d+)\])?;", body, re.M)]
    py_fields = []
    for name, t in cf._FixedwingConstsC._fields_:
        n, base = (t._length_, t._type_) if issubclass(t, ctypes.Array) else (1, t)
        py_fields.append((name, {ctypes.c_float: "float", ctypes.c_int: "int"}[base], n))
    assert py_fields == c_fields and len(c_fields) == len(dataclasses.fields(cf.FixedwingConsts))
    assert cf.WAYPOINTS_KERNEL.source == cf.STEP_KERNEL.source == "fixedwing_step.cu"


def test_twin_motor_noise_statistics():
    """Noise on, identical lanes: the throttle spreads with the motor's
    noise ratio (one draw per physics iteration, so the spread of two
    iterations), mean unbiased; one seed gives one draw, another seed
    another."""
    _, _, tc, tp = _model("fixedwing")
    c = cf.fixedwing_consts(tp, tc)
    st = fixedwing_state_from_jax(_random_state("fixedwing", 0, n=8), "cpu")
    packed = cf.pack_state(st)[:, :1].expand(-1, 4096).contiguous()
    quiet = cf.packed_step_plain(packed, torch.tensor([1]), c, 0, False)[cf._THR]
    noisy = cf.packed_step_plain(packed, torch.tensor([1]), c, 0, True)[cf._THR]
    assert bool((quiet == quiet[0]).all())
    rel = (noisy - quiet) / quiet
    se = 5.0 * c.mot_noise * np.sqrt(2.0) / np.sqrt(4096)
    assert abs(float(rel.mean())) < se
    assert 0.8 * c.mot_noise < float(rel.std()) < 2.0 * c.mot_noise
    assert torch.equal(noisy, cf.packed_step_plain(packed, torch.tensor([1]), c, 0, True)[cf._THR])
    assert not torch.equal(noisy, cf.packed_step_plain(packed, torch.tensor([2]), c, 0, True)[cf._THR])


@pytest.mark.parametrize("bad", ["rows", "dtype", "seed", "mode", "consts"])
def test_wrappers_reject_bad_arguments(bad):
    _, _, tc, tp = _model("fixedwing")
    c = cf.fixedwing_consts(tp, tc)
    packed, seed, mode = torch.zeros(cf.ROWS, 3), torch.zeros(1, dtype=torch.int64), 0
    if bad == "rows":
        packed = torch.zeros(cf.ROWS - 1, 3)
    elif bad == "dtype":
        packed = packed.double()
    elif bad == "seed":
        seed = seed.int()
    elif bad == "mode":
        mode = 1
    fn = cf.packed_waypoints_step if bad == "consts" else cf.packed_step
    with pytest.raises(ValueError):
        fn(packed, seed, c, mode, False)
    with pytest.raises(NotImplementedError, match="1..4 targets"):
        cf.waypoints_consts(tp, tc, 4, 100.0, 3600, 2.0, 5)
