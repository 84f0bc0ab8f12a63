"""The port's ``core/aviary`` against the JAX ``Aviary`` on the eleven
scenarios of tests/test_aviary.py (at most 50 aviary steps each), its
batched ``reset(batch=B)`` / ``step`` against ``jax.vmap`` of the JAX ones,
``describe()`` and the device default.

Noise off on both sides, test-side only: the JAX fixedwing and rocket
handles draw their noise always, so each vehicle gets a handle subclass
with its noise off, registered through ``register_drone_type`` in both
packages under the same name. Both sides reset from the same spawns and
step on their own; each step is one jitted JAX program per scenario.

Tolerances: views within ``1e-5 + 2e-5 * step`` (f32 rounding of two
programs, grown by the closed loops), the mixed fleet's within
``1e-4 + 1e-4 * step`` (the rocket's and fixedwing's aerodynamics sum
larger terms); contact flags, matrices and step counts exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyflyt_tpu.core import aviary as jav
from pyflyt_tpu.core import camera as jcam
from pyflyt_tpu.core.state import Body6DoF as JBody
from pyflyt_tpu.core.wind import ConstantWind as JConstantWind
from pyflyt_tpu_torch.core import Aviary, AviaryState, DroneSpec, register_drone_type
from pyflyt_tpu_torch.core import aviary as tav
from pyflyt_tpu_torch.core import camera as tcam
from pyflyt_tpu_torch.core.state import Body6DoF as TBody
from pyflyt_tpu_torch.core.wind import ConstantWind

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the noise-off handles, registered on both sides
# ---------------------------------------------------------------------------


def _quiet_jax(base, field):
    class Quiet(base):
        def __init__(self, spec, physics_hz):
            super().__init__(spec, physics_hz)
            self.cfg = dataclasses.replace(self.cfg, **{field: False})

    return Quiet


def _quiet_torch(base, field):
    class Quiet(base):
        def __init__(self, spec, physics_hz, device):
            super().__init__(spec, physics_hz, device)
            self.cfg = dataclasses.replace(self.cfg, **{field: False})

    return Quiet


for _name, _field in (("quadx", "noisy_motors"), ("fixedwing", "noisy_motors"), ("rocket", "noisy_boosters")):
    jav.register_drone_type(f"{_name}_quiet", _quiet_jax(jav._HANDLE_TYPES[_name], _field))
    register_drone_type(f"{_name}_quiet", _quiet_torch(tav._HANDLE_TYPES[_name], _field))


def _wall(m, **kw):
    return m.Boxes(centers=kw["c"]([[1.0, 0.0, 1.0]]), half_extents=kw["c"]([[0.2, 2.0, 2.0]]),
                   rotations=kw["eye"], colors=kw["c"]([[0.5, 0.5, 0.5, 1.0]]), visible=kw["ones"])


JWALL = _wall(jcam, c=lambda v: jnp.asarray(v, jnp.float32), eye=jnp.eye(3)[None], ones=jnp.ones((1,), bool))
TWALL = _wall(tcam, c=lambda v: torch.tensor(v), eye=torch.eye(3)[None], ones=torch.ones(1, dtype=torch.bool))


def _pair(start_pos, start_orn, specs, jax_kw=None, torch_kw=None, **kw):
    """The JAX and the port aviary of one fleet (``specs``: DroneSpec
    keyword dicts), with their reset states."""
    specs = tuple(DroneSpec(**s) for s in specs)
    jspecs = tuple(jav.DroneSpec(**dataclasses.asdict(s)) for s in specs)
    jav_ = jav.Aviary(start_pos, start_orn, specs=jspecs, **kw, **(jax_kw or {}))
    tav_ = Aviary(start_pos, start_orn, specs=specs, device="cpu", **kw, **(torch_kw or {}))
    return jav_, jav_.reset(jax.random.PRNGKey(0)), tav_, tav_.reset()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check(jav_, js, tav_, ts, atol, where):
    for i in range(jav_.num_drones):
        np.testing.assert_allclose(_np(tav_.state(ts, i)), np.asarray(jav_.state(js, i)), atol=atol, rtol=0,
                                   err_msg=f"{where} drone {i} view")
        np.testing.assert_allclose(_np(ts.drones[i].body.pos), np.asarray(js.drones[i].body.pos), atol=atol,
                                   rtol=0, err_msg=f"{where} drone {i} pos")
    np.testing.assert_array_equal(_np(ts.contact), np.asarray(js.contact), err_msg=f"{where} contact")
    np.testing.assert_array_equal(_np(ts.contact_matrix), np.asarray(js.contact_matrix), err_msg=f"{where} matrix")
    assert int(ts.aviary_steps) == int(js.aviary_steps) and int(ts.physics_steps) == int(js.physics_steps)


def _compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` without LLVM's expensive passes:
    the same results on these programs (checked bit for bit on the
    heterogeneous-rates step) in half the compile time."""
    return jax.jit(fn).lower(*args).compile({"xla_llvm_disable_expensive_passes": True})


def _fly(jav_, js, tav_, ts, steps, atol=(1e-5, 2e-5), where=""):
    jstep = _compiled(jav_.step, js)
    for k in range(steps):
        js, ts = jstep(js), tav_.step(ts)
        _check(jav_, js, tav_, ts, atol[0] + atol[1] * k, f"{where} step {k}")
    return js, ts


Q7 = dict(drone_type="quadx_quiet", mode=7)


def test_simple_spawn_and_steps():
    jav_, js, tav_, ts = _pair([[0.0, 0.0, 1.0]], [[0.0, 0.0, 0.0]], (Q7,))
    js = jav_.set_setpoint(js, 0, jnp.asarray([0.0, 0.0, 0.0, 1.0]))
    ts = tav_.set_setpoint(ts, 0, torch.tensor([0.0, 0.0, 0.0, 1.0]))
    js, ts = _fly(jav_, js, tav_, ts, 50, where="single")
    assert int(ts.aviary_steps) == 50 and abs(float(tav_.state(ts, 0)[3, 2]) - 1.0) < 0.5


def test_multi_drone_heterogeneous_rates():
    specs = tuple(dict(Q7, control_hz=hz) for hz in (60, 120, 240))
    jav_, js, tav_, ts = _pair([[0.0, 0.0, 1.0], [2.0, 0.0, 1.0], [4.0, 0.0, 1.0]], [[0.0, 0.0, 0.0]] * 3, specs)
    assert tav_.updates_per_step == jav_.updates_per_step == 4 and tav_.control_ratios == [4, 2, 1]
    for i, x in enumerate((0.0, 2.0, 4.0)):
        js = jav_.set_setpoint(js, i, jnp.asarray([x, 0.0, 0.0, 1.0]))
        ts = tav_.set_setpoint(ts, i, torch.tensor([x, 0.0, 0.0, 1.0]))
    _fly(jav_, js, tav_, ts, 50, where="rates")
    with pytest.raises(ValueError, match="multiples of the lowest"):
        Aviary([[0.0, 0.0, 1.0]] * 2, [[0.0, 0.0, 0.0]] * 2, device="cpu",
               specs=(DroneSpec(control_hz=80), DroneSpec(control_hz=120)))


def test_setpoint_sequence():
    jav_, js, tav_, ts = _pair([[0.0, 0.0, 1.0]], [[0.0, 0.0, 0.0]], (Q7,))
    for target in ([1.0, 0.0, 0.0, 1.0], [1.0, 1.0, 0.0, 2.0], [0.0, 0.0, 0.0, 1.0]):
        js = jav_.set_setpoint(js, 0, jnp.asarray(target))
        ts = tav_.set_setpoint(ts, 0, torch.tensor(target))
        js, ts = _fly(jav_, js, tav_, ts, 16, where=f"target {target}")


def test_custom_controller():
    spec = dict(Q7, custom_controller=None)
    jspec = dict(spec, custom_controller=lambda view, sp: sp + jnp.asarray([1.0, 0.0, 0.0, 0.0]))
    tspec = dict(spec, custom_controller=lambda view, sp: sp + torch.tensor([1.0, 0.0, 0.0, 0.0]))
    jav_ = jav.Aviary([[0.0, 0.0, 1.0]], [[0.0, 0.0, 0.0]], specs=(jav.DroneSpec(**jspec),))
    tav_ = Aviary([[0.0, 0.0, 1.0]], [[0.0, 0.0, 0.0]], specs=(DroneSpec(**tspec),), device="cpu")
    js = jav_.set_setpoint(jav_.reset(jax.random.PRNGKey(2)), 0, jnp.asarray([0.0, 0.0, 0.0, 1.0]))
    ts = tav_.set_setpoint(tav_.reset(), 0, torch.tensor([0.0, 0.0, 0.0, 1.0]))
    js, ts = _fly(jav_, js, tav_, ts, 50, where="custom")
    assert float(tav_.state(ts, 0)[3, 0]) > 0.03  # heading for the offset target (the setpoint holds x = 0)


MIXED = dict(
    start_pos=[[0.0, 0.0, 100.0], [5.0, 0.0, 1.0], [10.0, 0.0, 50.0]],
    start_orn=[[0.0, 0.0, 0.0]] * 3,
    specs=(dict(drone_type="rocket_quiet", mode=0), Q7, dict(drone_type="fixedwing_quiet", mode=0)),
)
MIXED_SP = ([0.0] * 7, [5.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 0.7])


B = 4  # the JAX mixed fleet is stepped under jax.vmap, one program for both mixed-fleet tests


@pytest.fixture(scope="module")
def mixed():
    """The mixed fleet's two aviaries, ``jax.vmap`` of the JAX reset over
    B keys and the vmapped JAX step compiled once."""
    jav_, _, tav_, _ = _pair(**MIXED)
    js = jax.vmap(jav_.reset)(jax.random.split(jax.random.PRNGKey(0), B))
    return jav_, tav_, js, _compiled(jax.vmap(jav_.step), js)


def test_mixed_fleet(mixed):
    """Rocket + quadx + fixedwing for 50 steps: the port's unbatched aviary
    against copy 0 of the vmapped JAX one (every copy the same fleet)."""
    jav_, tav_, js, vstep = mixed
    js = jax.vmap(lambda s: jav_.set_all_setpoints(s, [jnp.asarray(x) for x in MIXED_SP]))(js)
    ts = tav_.set_all_setpoints(tav_.reset(), [torch.tensor(x) for x in MIXED_SP])
    for k in range(50):
        js, ts = vstep(js), tav_.step(ts)
        _check(jav_, jax.tree.map(lambda a: a[0], js), tav_, ts, 1e-4 + 1e-4 * k, f"mixed step {k}")
    j0 = jax.tree.map(lambda a: a[0], js)
    for i, size in enumerate((9, 4, 6)):
        assert tav_.aux_state(ts, i).shape == (size,)
        np.testing.assert_allclose(_np(tav_.aux_state(ts, i)), np.asarray(jav_.aux_state(j0, i)), atol=1e-3)
    assert float(tav_.state(ts, 0)[3, 2]) < 100.0 and float(tav_.state(ts, 2)[3, 0]) > 11.0


def test_set_armed_ballistic():
    jav_, js, tav_, ts = _pair([[0.0, 0.0, 10.0]], [[0.0, 0.0, 0.0]], (Q7,))
    js = jav_.set_armed(jav_.set_setpoint(js, 0, jnp.asarray([0.0, 0.0, 0.0, 10.0])), [False])
    ts = tav_.set_armed(tav_.set_setpoint(ts, 0, torch.tensor([0.0, 0.0, 0.0, 10.0])), [False])
    pre_view = tav_.state(ts, 0).clone()
    js, ts = _fly(jav_, js, tav_, ts, 50, where="disarmed")
    body = ts.drones[0].body
    t = 50 / 120
    np.testing.assert_allclose(float(body.pos[2]), 10.0 - 0.5 * 9.81 * t * t, atol=0.05)
    assert torch.equal(tav_.state(ts, 0), pre_view)  # the read snapshot stays frozen


def test_wind_field_hook():
    jav_, js, tav_, ts = _pair([[0.0, 0.0, 5.0]], [[0.0, 0.0, 0.0]], (dict(drone_type="quadx_quiet", mode=0),),
                               jax_kw=dict(wind_fn=JConstantWind(jnp.asarray([10.0, 0.0, 0.0]))),
                               torch_kw=dict(wind_fn=ConstantWind(torch.tensor([10.0, 0.0, 0.0]))))
    js = jav_.set_setpoint(js, 0, jnp.asarray([0.0, 0.0, 0.0, 0.37]))
    ts = tav_.set_setpoint(ts, 0, torch.tensor([0.0, 0.0, 0.0, 0.37]))
    js, ts = _fly(jav_, js, tav_, ts, 50, where="wind")
    assert float(tav_.state(ts, 0)[3, 0]) > 0.01  # blown downwind


def test_drone_drone_collision_matrix():
    jav_, js, tav_, ts = _pair([[0.0, 0.0, 1.0], [0.05, 0.0, 1.0]], [[0.0, 0.0, 0.0]] * 2,
                               (dict(drone_type="quadx_quiet"),) * 2)
    js, ts = _fly(jav_, js, tav_, ts, 1, where="collision")
    m = ts.contact_matrix.numpy()
    assert m[0, 1] and m[1, 0] and not m[0, 0] and ts.contact.all()


def _fly_at_wall(steps, **kw):
    jav_, js, tav_, ts = _pair([[0.4, 0.0, 1.0]], [[0.0, 0.0, 0.0]], (Q7,),
                               jax_kw=dict(obstacles=JWALL), torch_kw=dict(obstacles=TWALL), **kw)
    js = jav_.set_setpoint(js, 0, jnp.asarray([2.0, 0.0, 0.0, 1.0]))
    ts = tav_.set_setpoint(ts, 0, torch.tensor([2.0, 0.0, 0.0, 1.0]))
    # launched at the wall at 2 m/s, so it arrives within the 50 steps
    jd, td = js.drones[0], ts.drones[0]
    js = js.replace(drones=(jd.replace(body=jd.body.replace(lin_vel=jnp.asarray([2.0, 0.0, 0.0]))),))
    ts = dataclasses.replace(ts, drones=(dataclasses.replace(
        td, body=dataclasses.replace(td.body, lin_vel=torch.tensor([2.0, 0.0, 0.0]))),))
    jstep = _compiled(jav_.step, js)
    xs, hits = [], []
    for k in range(steps):
        js, ts = jstep(js), tav_.step(ts)
        _check(jav_, js, tav_, ts, 1e-5 + 2e-5 * k, f"wall step {k}")
        xs.append(float(tav_.state(ts, 0)[3, 0]))
        hits.append(bool(ts.contact[0]))
    return np.array(xs), np.array(hits)


def test_obstacle_contact():
    """A drone launched at a wall: the contact flags fire, as in JAX, and
    (detection only) it flies into the slab."""
    xs, hits = _fly_at_wall(50)
    assert hits.any() and xs.max() > 0.85


def test_obstacle_response_blocks_drone():
    xs, hits = _fly_at_wall(50, obstacle_response=True)
    assert hits.any() and xs.max() < 0.85 and xs[-1] < 0.85


def test_obstacle_impulse_cancels_normal_velocity():
    jbox = jcam.Boxes(centers=jnp.zeros((1, 3)), half_extents=jnp.ones((1, 3)), rotations=jnp.eye(3)[None],
                      colors=jnp.ones((1, 4)), visible=jnp.ones((1,), bool))
    tbox = tcam.Boxes(centers=torch.zeros(1, 3), half_extents=torch.ones(1, 3), rotations=torch.eye(3)[None],
                      colors=torch.ones(1, 4), visible=torch.ones(1, dtype=torch.bool))
    jav_ = jav.Aviary([[0.0, 0.0, 1.0]], [[0.0, 0.0, 0.0]], obstacles=jbox, obstacle_response=True)
    tav_ = Aviary([[0.0, 0.0, 1.0]], [[0.0, 0.0, 0.0]], obstacles=tbox, obstacle_response=True, device="cpu")
    rng = np.random.default_rng(4)
    # a face overlap, a centre inside, a separating body, an edge, and random ones
    pos = np.concatenate([[[1.05, 0.0, 0.0], [0.3, 0.9, 0.0], [1.2, 0.0, 0.0], [1.03, 1.03, 0.5]],
                          rng.uniform(-1.3, 1.3, size=(60, 3))]).astype(np.float32)
    vel = rng.normal(size=(64, 3)).astype(np.float32)
    vel[0] = [-1.0, 0.3, 0.0]
    quat = np.tile(np.float32([0.0, 0.0, 0.0, 1.0]), (64, 1))
    jb = JBody(pos=jnp.asarray(pos), quat=jnp.asarray(quat), lin_vel=jnp.asarray(vel), ang_vel=jnp.zeros((64, 3)))
    tb = TBody(pos=torch.from_numpy(pos), quat=torch.from_numpy(quat), lin_vel=torch.from_numpy(vel),
               ang_vel=torch.zeros(64, 3))
    jout = jax.jit(jax.vmap(lambda b: jav_._obstacle_impulse(b, 0.065)))(jb)
    tout = tav_._obstacle_impulse(tb, 0.065)
    np.testing.assert_allclose(tout.pos.numpy(), np.asarray(jout.pos), atol=1e-6)
    np.testing.assert_allclose(tout.lin_vel.numpy(), np.asarray(jout.lin_vel), atol=1e-6)
    np.testing.assert_allclose(tout.pos[0, 0].item(), 1.065, atol=1e-6)
    np.testing.assert_allclose(tout.lin_vel[0].numpy(), [0.0, 0.3, 0.0], atol=1e-6)
    assert torch.equal(tout.pos[2], tb.pos[2]) and torch.equal(tout.lin_vel[2], tb.lin_vel[2])


# ---------------------------------------------------------------------------
# batching, describe, the device
# ---------------------------------------------------------------------------


def _set_body(js, ts, i, copy, **fields):
    """Drone ``i``'s body fields in copy ``copy`` of both batched states."""
    jd, td = js.drones[i], ts.drones[i]
    jb = jd.body.replace(**{k: getattr(jd.body, k).at[copy].set(jnp.asarray(v, jnp.float32)) for k, v in fields.items()})
    tb = dataclasses.replace(td.body)
    for k, v in fields.items():
        getattr(tb, k)[copy] = torch.tensor(v)
    jdrones, tdrones = list(js.drones), list(ts.drones)
    jdrones[i], tdrones[i] = jd.replace(body=jb), dataclasses.replace(td, body=tb)
    return js.replace(drones=tuple(jdrones)), dataclasses.replace(ts, drones=tuple(tdrones))


def test_batched_reset_and_step_match_jax_vmap(mixed):
    """``reset(batch=4)`` and 12 steps of the mixed fleet with per-copy
    setpoints against ``jax.vmap`` of the JAX ``reset`` and ``step``, copy
    by copy, every drone's view and body. Each vehicle is disarmed in two
    copies: the quadx in 1-2; the rocket in 2-3 with its fuel partly burnt
    (a CoM and inertia off the spawn's), in copy 3 tilted and falling onto
    the ground; the fixedwing in 1 and 3, in copy 3 tumbling onto the
    ground."""
    b = B
    jav_, tav_, js, vstep = mixed
    ts = tav_.reset(batch=b)
    assert isinstance(ts, AviaryState) and ts.armed.shape == (b, 3) and ts.contact_matrix.shape == (b, 3, 3)
    rng = np.random.default_rng(9)
    sps = [np.tile(np.float32(s), (b, 1)) for s in MIXED_SP]
    sps[1][:, :2] += rng.uniform(-1, 1, size=(b, 2)).astype(np.float32)
    sps[2][:, 3] = rng.uniform(0.3, 0.9, size=b)
    armed = np.ones((b, 3), bool)
    armed[1:3, 1] = False
    armed[2:4, 0] = False
    armed[[1, 3], 2] = False
    js = jax.vmap(lambda s, a, p, q, r: jav_.set_armed(jav_.set_all_setpoints(s, [p, q, r]), a))(
        js, jnp.asarray(armed), *map(jnp.asarray, sps))
    ts = tav_.set_armed(tav_.set_all_setpoints(ts, [torch.from_numpy(s) for s in sps]), torch.from_numpy(armed))
    fuel = np.float32([[0.05], [0.04], [0.02], [0.011]])
    jr, tr = js.drones[0], ts.drones[0]
    jr = jr.replace(booster=jr.booster.replace(ratio_fuel_remaining=jnp.asarray(fuel)))
    tr = dataclasses.replace(tr, booster=dataclasses.replace(tr.booster, ratio_fuel_remaining=torch.from_numpy(fuel)))
    js = js.replace(drones=(jr,) + tuple(js.drones[1:]))
    ts = dataclasses.replace(ts, drones=(tr,) + tuple(ts.drones[1:]))
    tilt = [np.sin(0.15), 0.0, 0.0, np.cos(0.15)]
    js, ts = _set_body(js, ts, 0, 3, pos=[0.0, 0.0, 2.05], quat=tilt, lin_vel=[0.5, 0.0, -3.0], ang_vel=[0.4, 0.2, 0.0])
    js, ts = _set_body(js, ts, 2, 3, pos=[10.0, 0.0, 0.7], quat=tilt, lin_vel=[3.0, 0.0, -5.0],
                       ang_vel=[1.0, -0.5, 0.3])
    landed = torch.zeros(3, dtype=torch.bool)
    for k in range(12):
        js, ts = vstep(js), tav_.step(ts)
        landed |= ts.contact[3]
        atol = 1e-4 + 1e-4 * k
        for i in range(3):
            np.testing.assert_allclose(_np(tav_.state(ts, i)), np.asarray(jav_.state(js, i)), atol=atol,
                                       rtol=0, err_msg=f"step {k} drone {i}")
            for f in ("pos", "quat", "lin_vel", "ang_vel"):
                np.testing.assert_allclose(_np(getattr(ts.drones[i].body, f)), np.asarray(getattr(js.drones[i].body, f)),
                                           atol=atol, rtol=0, err_msg=f"step {k} drone {i} body {f}")
        np.testing.assert_array_equal(ts.contact.numpy(), np.asarray(js.contact))
        np.testing.assert_array_equal(ts.contact_matrix.numpy(), np.asarray(js.contact_matrix))
        if k == 0:
            assert not ts.contact[3, 0] and not ts.contact[3, 2]
    np.testing.assert_array_equal(ts.aviary_steps.numpy(), np.asarray(js.aviary_steps))
    # the disarmed rocket and fixedwing of copy 3 reached the ground
    assert landed[0] and landed[2]
    # the disarmed copies' quadx froze its read snapshot; the armed ones flew on
    assert not torch.equal(tav_.state(ts, 1)[0], tav_.state(ts, 1)[1])


@pytest.mark.parametrize("batch", [None, 3])
def test_gaussian_wind_fits_unbatched_and_batched_fleets(batch):
    """A per-env ``GaussianWind`` (no gusts) drives the mixed fleet, one
    aviary or a batch of them (the quadx's ``(..., 3)``, the rocket's
    ``(..., 4, 3)`` and the fixedwing's ``(..., 5, 3)`` positions), exactly
    as the constant field of the same velocity."""
    from pyflyt_tpu_torch.core.wind import GaussianWind

    base = (3.0, -2.0, 0.5)
    views = []
    for wind in (GaussianWind.init(None, batch or 1, base_wind=base, max_gust=0.0, device="cpu"),
                 ConstantWind(torch.tensor(base))):
        av = Aviary(MIXED["start_pos"], MIXED["start_orn"], specs=tuple(DroneSpec(**d) for d in MIXED["specs"]),
                    wind_fn=wind, device="cpu")
        st = av.set_all_setpoints(av.reset(batch=batch), [torch.tensor(x) for x in MIXED_SP])
        for _ in range(3):
            st = av.step(st)
        views.append(av.all_states(st))
    for a, b in zip(*views):
        assert torch.equal(a, b)


def test_describe_matches_jax():
    kw = dict(obstacles=None, physics_hz=240)
    jav_, _, tav_, _ = _pair(**MIXED, **kw)
    assert tav_.describe() == jav_.describe()
    jw, _, tw, _ = _pair([[0.0, 0.0, 1.0]], [[0.0, 0.0, 0.0]], (Q7,), jax_kw=dict(obstacles=JWALL),
                         torch_kw=dict(obstacles=TWALL))
    assert tw.describe() == jw.describe() and "obstacles=1" in tw.describe()


def test_set_mode_returns_a_new_aviary():
    av = Aviary([[0.0, 0.0, 1.0]] * 2, [[0.0, 0.0, 0.0]] * 2, device="cpu",
                drone_options={"noisy_motors": False}, obstacles=TWALL, obstacle_response=True)
    st = av.reset()
    av2, st2 = av.set_mode(st, [7, 10])
    assert [s.mode for s in av2.specs] == [7, 10] and [s.mode for s in av.specs] == [0, 0]
    assert av2.obstacle_response
    np.testing.assert_array_equal(st2.drones[0].setpoint.numpy(), [0.0, 0.0, 0.0, 1.0])  # mode 7 holds
    st2 = av2.step(st2)
    assert torch.isfinite(av2.state(st2, 1)).all()
    with pytest.raises(ValueError, match="a drone has its noise on"):
        Aviary([[0.0, 0.0, 1.0]], [[0.0, 0.0, 0.0]], device="cpu").reset()


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Aviary([[0.0, 0.0, 1.0]], [[0.0, 0.0, 0.0]])
