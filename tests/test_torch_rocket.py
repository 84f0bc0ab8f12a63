"""The rocket model and K6's row-8 twin against the JAX package, noise off.

- ``ops/boosters`` (the latch of an engine that cannot reignite, the
  throttle floor and lag, the dry tank, the burn), ``ops/gimbals`` and
  ``models.rocket.mass_properties`` against the JAX functions on
  numpy-seeded inputs.
- ``core/integrator.ground_contact`` with a per-point ground height and
  batched contact points, and ``lifting_surfaces.wrench`` with a batched
  CoM, against the JAX functions.
- ``models.rocket.step`` and the row-8 twin (``cuda_rocket.packed_step``
  on CPU tensors, chained through ``pack_state``/``unpack_state``) against
  the XLA ``rocket.step`` in tests/_rocket_reference.py's cases at
  tests/test_pallas_rocket.py's bounds: one active step (:84-115), the
  12-step burn and a fuel-out burn (:119-150), the settle on the ground
  and on a pad (:213-248); the step's contact flags exact.
- ``pack_state`` against ``pallas_rocket.pack_state`` and the round trip;
  ``RocketConsts`` against ``pallas_rocket._bake`` and its C struct field
  by field; the twins' noise by its statistics; the wrappers' checks;
  ``convert.rocket_state_from_jax``.
"""

import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _rocket_reference import FAR_PAD, N, model_case, model_cfg

from pyflyt_tpu.core import integrator as jint
from pyflyt_tpu.core.state import Body6DoF as JBody
from pyflyt_tpu.models import rocket as jrocket
from pyflyt_tpu.ops import boosters as jboosters
from pyflyt_tpu.ops import gimbals as jgimbals
from pyflyt_tpu.ops import lifting_surfaces as jls
from pyflyt_tpu.ops import pallas_rocket
from pyflyt_tpu_torch.convert import rocket_state_from_jax
from pyflyt_tpu_torch.core import integrator as tint
from pyflyt_tpu_torch.core.state import Body6DoF
from pyflyt_tpu_torch.models import rocket
from pyflyt_tpu_torch.ops import boosters, cuda_build, gimbals, lifting_surfaces
from pyflyt_tpu_torch.ops import cuda_rocket as cr

torch.set_num_threads(1)

T = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
JCFG = model_cfg()
JPARAMS = jrocket.build_params(JCFG)


def _params(fuel: float = 0.30):
    cfg = rocket.RocketConfig(noisy_boosters=False, starting_fuel_ratio=fuel)
    return cfg, rocket.build_params(cfg, "cpu")


# ---------------------------------------------------------------------------
# boosters, gimbals, the composite
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reignitable", [True, False])
def test_boosters_match_jax(reignitable):
    """Ignition on, off and back on, the throttle swept, a near-dry tank:
    the latch, the floor, the lag, the dry-tank cut and the burn track the
    JAX op step by step; ``get_states`` too."""
    _, tp = _params()
    jb = JPARAMS.booster.replace(reignitable=jnp.asarray([reignitable]))
    tb = dataclasses.replace(tp.booster, reignitable=torch.tensor([reignitable]))
    fuel = np.float32([[0.3], [2e-5], [1.0], [0.0]])
    js = jboosters.init(jb, (4,), 1.0)
    js = js.replace(ratio_fuel_remaining=jnp.asarray(fuel))
    ts = boosters.init(tb, (4,), 1.0)
    ts.ratio_fuel_remaining = T(fuel)
    rng = np.random.default_rng(0)
    for i in range(40):
        ign = np.float32([[1.0], [1.0], [0.0 if 10 <= i < 20 else 1.0], [1.0]])
        pwm = rng.uniform(0.0, 1.0, (4, 1)).astype(np.float32)
        js, jt, jfm, jfi = jboosters.update(js, jb, jnp.asarray(ign), jnp.asarray(pwm), JCFG.physics_period)
        ts, tt, tfm, tfi = boosters.update(ts, tb, T(ign), T(pwm), JCFG.physics_period)
        for a, b in ((tt, jt), (tfm, jfm), (tfi, jfi), (ts.throttle, js.throttle)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6, err_msg=f"step {i}")
        np.testing.assert_array_equal(ts.ignition_state.numpy(), np.asarray(js.ignition_state))
        np.testing.assert_allclose(boosters.get_states(ts).numpy(), np.asarray(jboosters.get_states(js)), atol=1e-6)
        if i == 15:  # the ignition command is off on lane 2: only a latched engine stays lit
            assert bool(ts.ignition_state[2]) == (not reignitable)
    assert float(ts.ratio_fuel_remaining[1]) == 0.0 and float(tt[1]) == 0.0  # ran dry: no thrust
    assert float(tt[3]) == 0.0  # dry from the start


def test_gimbals_and_mass_properties_match_jax():
    _, tp = _params()
    rng = np.random.default_rng(1)
    js, ts = jgimbals.init(JPARAMS.gimbal, (6,)), gimbals.init(tp.gimbal, (6,))
    for i in range(20):
        cmd = rng.uniform(-1.5, 1.5, (6, 1, 2)).astype(np.float32)  # out-of-range commands clip
        js, jr = jgimbals.compute_rotation(js, jnp.asarray(cmd), JPARAMS.gimbal, JCFG.physics_period)
        ts, tr = gimbals.compute_rotation(ts, T(cmd), tp.gimbal, JCFG.physics_period)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-7, err_msg=f"step {i}")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-7, err_msg=f"step {i}")
    for w in ("w1", "w2", "w1_squared", "w2_squared", "range_radians"):
        np.testing.assert_array_equal(getattr(tp.gimbal, w).numpy(), np.asarray(getattr(JPARAMS.gimbal, w)))

    ratio = np.float32([[1.0], [0.5], [0.02], [0.0]])
    fm, fi = ratio * 410.9, ratio[..., None] * np.float32([1678.0, 1678.0, 7.01])
    jm, jc, ji = jrocket.mass_properties(JPARAMS, jnp.asarray(fm), jnp.asarray(fi))
    tm, tc, ti = rocket.mass_properties(tp, T(fm), T(fi))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-6, atol=1e-4)
    assert float(tm[0]) == pytest.approx(549.1, rel=1e-4) and float(tm[3]) == pytest.approx(138.2, rel=1e-3)


def test_ground_contact_with_point_heights_and_batched_points():
    """Per-point ground heights (a raised pad under some points) and
    per-body contact points, as the rocket passes them."""
    rng = np.random.default_rng(2)
    n, k = 32, 12
    pos = np.float32(rng.uniform(-1, 1, (n, 3)))
    pos[:, 2] = rng.uniform(2.3, 2.6, n)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat[:, 3] += 6.0
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    lv = np.float32(rng.normal(0, 2, (n, 3)))
    av = np.float32(rng.normal(0, 1, (n, 3)))
    pts = np.float32(np.asarray(JPARAMS.contact_points)[None] - rng.uniform(-0.05, 0.05, (n, 1, 3)))
    heights = np.float32(np.where(rng.uniform(size=(n, k)) < 0.5, 0.15, 0.0))
    inertia = np.float32(np.tile(np.diag([380.0, 380.0, 3.0]), (n, 1, 1)) + rng.normal(0, 1, (n, 3, 3)) * 0.1)
    mass = np.float32(rng.uniform(140.0, 260.0, n))
    jb, jc = jint.ground_contact(
        JBody(pos=jnp.asarray(pos), quat=jnp.asarray(quat), lin_vel=jnp.asarray(lv), ang_vel=jnp.asarray(av)),
        jint.RigidBodyParams(mass=jnp.asarray(mass), inertia=jnp.asarray(inertia), full_inertia=True),
        jint.ContactGeom(points=jnp.asarray(pts)), ground_z=jnp.asarray(heights))
    tb, tc = tint.ground_contact(
        Body6DoF(pos=T(pos), quat=T(quat), lin_vel=T(lv), ang_vel=T(av)),
        tint.RigidBodyParams(mass=T(mass), inertia=T(inertia), full_inertia=True),
        tint.ContactGeom(points=T(pts)), ground_z=T(heights))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert 0 < int(tc.sum()) < n
    for a, b in ((tb.pos, jb.pos), (tb.lin_vel, jb.lin_vel), (tb.ang_vel, jb.ang_vel)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_surface_wrench_takes_a_batched_com():
    """``lifting_surfaces.wrench`` with one CoM per body (the rocket's moves
    with its fuel), as the JAX function takes it."""
    _, tp = _params()
    rng = np.random.default_rng(3)
    act = np.float32(rng.uniform(-1, 1, (8, 4)))
    lv = np.float32(rng.normal(0, 20, (8, 4, 3)))
    com = np.float32(rng.uniform(-0.3, 0.1, (8, 3)))
    jf, jt = jls.wrench(jnp.asarray(act), jnp.asarray(lv), JPARAMS.finlets, jnp.asarray(com))
    tf, tt = lifting_surfaces.wrench(T(act), T(lv), tp.finlets, T(com))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# the model and the row-8 twin against the XLA step
# ---------------------------------------------------------------------------

# the bounds of tests/test_pallas_rocket.py per case: (pos, quat, lin_vel,
# ang_vel, view/finlet velocities, fuel, throttle) at step i
BOUNDS = {
    "active": lambda i: dict(pos=2e-4, quat=2e-5, lin_vel=2e-3, ang_vel=2e-3, view=2e-3, fuel=1e-6, throttle=1e-6),
    "burn": lambda i: dict(pos=3e-3 + 1e-3 * i, ang_vel=3e-3 + 1e-3 * i, fuel=1e-5),
    "fuel_out": lambda i: dict(pos=3e-3 + 1e-3 * i, ang_vel=3e-3 + 1e-3 * i, fuel=1e-5),
    "rest_ground": lambda i: dict(pos=2e-3, lin_vel=5e-3, ang_vel=5e-3),
    "rest_pad": lambda i: dict(pos=2e-3, lin_vel=5e-3, ang_vel=5e-3),
}


def _fields(st):
    return {"pos": st.body.pos, "quat": st.body.quat, "lin_vel": st.body.lin_vel, "ang_vel": st.body.ang_vel,
            "view": st.read.view, "finlet_local_vel": st.read.finlet_local_vel,
            "fuel": st.booster.ratio_fuel_remaining, "throttle": st.booster.throttle}


def _assert_close(got, ref, bounds: dict, where: str) -> None:
    g, r = _fields(got), _fields(ref)
    for k, tol in bounds.items():
        np.testing.assert_allclose(g[k].numpy(), np.asarray(r[k]), atol=tol, err_msg=f"{where} {k}")
        if k == "view":
            np.testing.assert_allclose(g["finlet_local_vel"].numpy(), np.asarray(r["finlet_local_vel"]), atol=tol,
                                       err_msg=f"{where} finlet_local_vel")


def _case_facts(name, traj):
    """Each case shows what it is for."""
    if name == "fuel_out":
        assert float(traj[-1][0].booster.ratio_fuel_remaining.max()) == 0.0  # the tank ran dry in flight
        assert float(traj[0][0].booster.throttle.min()) > 0.0
    if name.startswith("rest"):
        flags = np.stack([p if name == "rest_pad" else g for _, g, p in traj])
        assert flags.any(axis=0).all(), "every rocket must touch down"
        assert not np.stack([g if name == "rest_pad" else p for _, g, p in traj]).any()
        assert np.abs(traj[-1][0].body.lin_vel).max() < 0.5  # settled


@pytest.mark.parametrize("name", ["active", "burn", "fuel_out", "rest_ground", "rest_pad"])
def test_model_step_matches_xla(name):
    fuel, st0, pad, traj = model_case(name)
    _case_facts(name, traj)
    cfg, params = _params(fuel)
    st = rocket_state_from_jax(st0, device="cpu")
    pad_t = None if pad[0, 0] == FAR_PAD[0] else T(pad)
    for i, (ref, g, p) in enumerate(traj):
        st, tg, tp = rocket.step(st, params, cfg, pad_position=pad_t)
        _assert_close(st, ref, BOUNDS[name](i), f"{name} step {i}")
        np.testing.assert_array_equal(tg.numpy(), g, err_msg=f"{name} step {i} ground")
        np.testing.assert_array_equal(tp.numpy(), p, err_msg=f"{name} step {i} pad")
        np.testing.assert_array_equal(st.physics_steps.numpy(), ref.physics_steps)


@pytest.mark.parametrize("name", ["active", "burn", "fuel_out", "rest_ground", "rest_pad"])
def test_row8_twin_matches_xla(name):
    """``packed_step`` on CPU tensors (its twin, no launch) chained from
    the packed reset state; rows 59-60 carry the step's contact ORs."""
    fuel, st0, pad, traj = model_case(name)
    cfg, params = _params(fuel)
    c = cr.rocket_consts(params, cfg)
    template = rocket_state_from_jax(st0, device="cpu")
    packed = cr.pack_state(template)
    if pad[0, 0] != FAR_PAD[0]:
        packed[cr._PADP : cr._PADP + 3] = T(pad).T
    seed = torch.zeros(1, dtype=torch.int64)
    launches = cr.STEP_KERNEL.launches
    for i, (ref, g, p) in enumerate(traj):
        packed = cr.packed_step(packed, seed, c, False)
        _assert_close(cr.unpack_state(packed, template), ref, BOUNDS[name](i), f"row 8 {name} step {i}")
        np.testing.assert_array_equal(packed[cr._RWD].numpy() > 0.5, g, err_msg=f"{name} step {i} ground")
        np.testing.assert_array_equal(packed[cr._TERM].numpy() > 0.5, p, err_msg=f"{name} step {i} pad")
        got = cr.unpack_state(packed, template)
        for k in ("contact", "ground_contact", "pad_contact"):
            np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(ref, k), err_msg=f"{name} step {i} {k}")
        np.testing.assert_array_equal(got.booster.ignition_state.numpy(), ref.booster.ignition_state)
        np.testing.assert_allclose(got.gimbal_state.numpy(), ref.gimbal_state, atol=1e-6)
        assert not bool(packed[cr._TRUNC : cr._PADP].any()) and not bool(packed[cr._PFLAG :].any())
    assert cr.STEP_KERNEL.launches == launches  # CPU tensors: the twin


# ---------------------------------------------------------------------------
# layout, constants, noise, checks, convert
# ---------------------------------------------------------------------------


def test_pack_state_matches_pallas_and_round_trips():
    _, st0, _, traj = model_case("active")
    for jst in (st0, traj[-1][0]):
        got = cr.pack_state(rocket_state_from_jax(jst, device="cpu"))
        ref = np.asarray(pallas_rocket.pack_state(jax.tree.map(jnp.asarray, jst))).reshape(cr.ROWS, -1)
        assert got.shape == (cr.ROWS, N)
        np.testing.assert_array_equal(got.numpy(), ref)
    st = rocket_state_from_jax(traj[-1][0], device="cpu")
    back = cr.unpack_state(cr.pack_state(st), st)
    for a, b in zip(jax.tree.leaves(dataclasses.asdict(back)), jax.tree.leaves(dataclasses.asdict(st))):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    # the rows of the port are the Pallas module's
    for name in ("ROWS", "_POS", "_QUAT", "_VIEW", "_FLV", "_DLV", "_ACT", "_FUEL", "_BTHR", "_IGN", "_GBL", "_SP",
                 "_CON", "_GCON", "_PCON", "_RWD", "_TERM", "_TRUNC", "_FATC", "_OOB", "_CPLT", "_STEP", "_PADP",
                 "_PFLAG", "_AV", "_LV", "_DIST", "_PAV", "_PLV", "_PDIST"):
        assert getattr(cr, name) == getattr(pallas_rocket, name), name


def test_convert_carries_every_field():
    _, _, _, traj = model_case("rest_pad")
    jst = traj[-1][0]
    st = rocket_state_from_jax(jst, device="cpu")
    for f in ("contact", "ground_contact", "pad_contact"):
        assert getattr(st, f).dtype == torch.bool
        np.testing.assert_array_equal(getattr(st, f).numpy(), getattr(jst, f))
    assert bool(st.pad_contact.any())
    np.testing.assert_array_equal(st.cmd.numpy(), jst.cmd)
    np.testing.assert_array_equal(st.physics_steps.numpy(), jst.physics_steps)
    assert st.physics_steps.dtype == torch.int32 and st.booster.ignition_state.dtype == torch.bool


def test_consts_match_bake_and_the_c_struct():
    cfg, params = _params()
    B = pallas_rocket._bake(JPARAMS, JCFG)
    c = cr.rocket_consts(params, cfg)
    f32 = lambda v: np.asarray(v, np.float64).astype(np.float32)  # noqa: E731
    surf = lambda key: f32([s[key] for s in B["surf"]])  # noqa: E731
    for mine, theirs in (("cl3d", "cl3d"), ("qa", "qa"), ("piar_inv", "piAR_inv"), ("stall_c", "stall_c"),
                         ("dlim_rad", "dlim_rad"), ("chord", "chord"), ("cd0", "cd0")):
        np.testing.assert_allclose(f32(getattr(c, mine)), surf(theirs), rtol=1e-6, err_msg=mine)
    np.testing.assert_allclose(f32(c.spos).reshape(4, 3), surf("pos"), rtol=1e-6)
    np.testing.assert_allclose(f32(c.lag), f32(B["dt"] / np.asarray(B["surf_tau"])), rtol=1e-6)
    np.testing.assert_allclose(f32(c.contact_pts).reshape(-1, 3), f32(B["contact_pts"]))
    np.testing.assert_allclose(f32(c.p_dry), f32(B["P_dry"]), rtol=1e-6)
    np.testing.assert_allclose(f32(c.pt_pos).reshape(7, 3), f32(B["pt_positions"]))
    np.testing.assert_allclose(f32(c.i_dry), f32(B["base_inertia"] + B["booster_inertia"]), rtol=1e-6)
    for w in ("g_w1", "g_w2", "g_w1sq", "g_w2sq"):
        np.testing.assert_allclose(f32(getattr(c, w)), f32(B[w]).reshape(-1), atol=1e-7)
    assert (c.m_dry, c.b_total_fuel, c.b_fuel_rate, c.b_min_ratio, c.b_max_thrust, c.b_noise, c.dt, c.ratio) == \
        pytest.approx((B["m_dry"], B["b_total_fuel"], B["b_fuel_rate"], B["b_min_ratio"], B["b_max_thrust"],
                       B["b_noise"], B["dt"], B["ratio"]), rel=1e-6)
    assert c.b_lag == pytest.approx(B["dt"] / B["b_tau"]) and c.g_lag == pytest.approx(B["dt"] / B["g_tau"])
    assert bool(c.b_reignitable) == B["b_reignitable"]
    landing = cr.landing_consts(params, cfg, 3, 1200, 200.0, 500.0)
    assert (landing.inner_steps, landing.max_steps, landing.max_displacement, landing.ceiling) == (3, 1200, 200, 500)

    src = (cuda_build.CSRC / cr.STEP_KERNEL.source).read_text()
    body = re.search(r"struct RocketConsts \{(.*?)\};", src, re.S).group(1)
    c_fields = [(name, ctype, int(n or 1))
                for ctype, name, n in re.findall(r"^\s*(float|int) (\w+)(?:\[(\d+)\])?;", body, re.M)]
    py_fields = []
    for name, t in cr._RocketConstsC._fields_:
        n, base_t = (t._length_, t._type_) if issubclass(t, ctypes.Array) else (1, t)
        py_fields.append((name, {ctypes.c_float: "float", ctypes.c_int: "int"}[base_t], n))
    assert py_fields == c_fields and len(c_fields) == len(dataclasses.fields(cr.RocketConsts))
    assert cr.STEP_KERNEL.source == cr.LANDING_KERNEL.source == "rocket_step.cu"
    assert re.search(r"constexpr int THREADS = 64;", src) and '#include "fixedwing_lane.cuh"' in src
    assert cr.rows_moved(True) == (87, 88) and cr.rows_moved(False) == (47, 88)
    assert cr.ops_per_env(landing, True) == cr.OPS_PER_CONTROL + 3 * (2 * cr.OPS_PER_PHYSICS_ITER
                                                                       + cr.OPS_PER_LANDING_TASK)


def test_twin_noise_statistics_and_argument_checks():
    """Noise on, identical lit lanes: the throttle spreads with the
    booster's noise ratio, its mean unbiased; one seed gives one draw,
    another another. Then the wrappers' checks."""
    cfg, params = _params()
    c = cr.rocket_consts(params, cfg)
    _, st0, _, _ = model_case("active")
    packed = cr.pack_state(rocket_state_from_jax(st0, device="cpu"))[:, :1].expand(-1, 2048).contiguous()
    s1 = torch.tensor([1])
    quiet = cr.packed_step_plain(packed, s1, c, False)[cr._BTHR]
    noisy = cr.packed_step_plain(packed, s1, c, True)[cr._BTHR]
    assert bool((quiet == quiet[0]).all()) and float(quiet[0]) > 0.0
    rel = (noisy - quiet) / quiet
    assert abs(float(rel.mean())) < 5.0 * c.b_noise * np.sqrt(2.0) / np.sqrt(2048)
    assert 0.5 * c.b_noise < float(rel.std()) < 4.0 * c.b_noise
    assert torch.equal(noisy, cr.packed_step_plain(packed, s1, c, True)[cr._BTHR])
    assert not torch.equal(noisy, cr.packed_step_plain(packed, torch.tensor([2]), c, True)[cr._BTHR])
    seed = torch.zeros(1, dtype=torch.int64)
    for bad in (torch.zeros(cr.ROWS - 1, 4), torch.zeros(cr.ROWS, 4, dtype=torch.float64), torch.zeros(cr.ROWS)):
        with pytest.raises(ValueError):
            cr.packed_step(bad, seed, c, False)
    with pytest.raises(ValueError, match="seed"):
        cr.packed_step(torch.zeros(cr.ROWS, 4), seed.int(), c, False)
    with pytest.raises(ValueError, match="landing_consts"):
        cr.packed_landing_step(torch.zeros(cr.ROWS, 4), seed, c, False)
