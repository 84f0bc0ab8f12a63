"""The JAX rocket runs shared by the port's rocket test files
(tests/test_torch_rocket.py, tests/test_torch_rocket_env.py), noise off.

``model_case(name)`` runs the XLA ``models.rocket.step`` (one jitted
program, the pad always given: a pad at 1e9 is out of reach, as
``pallas_rocket.pack_state`` parks it) from a batched ``init_state``:

- ``active``: tests/test_pallas_rocket.py:64-115's one step, 16 rockets
  30 m up, tilted and moving, the booster lit at 60%, finlets deflected
  and the gimbal swung;
- ``burn``: its 12-step burn (:119-150), 80 m up, 30% fuel;
- ``fuel_out``: the same burn from 0.02% fuel, which runs dry within the
  first 7 aviary steps (the throttle cut, the mass, CoM and inertia at
  the dry composite);
- ``rest_ground`` / ``rest_pad``: :213-248's settle, 8 upright rockets
  dropped from 2.6 m onto the ground or onto a pad at (0.3, -0.2, 0.1), 30
  steps.

``env_case(name)`` runs ``jax.vmap(RocketLandingEnv.step)`` (XLA) of
tests/test_pallas_rocket.py:155-165's low env (an 8 m drop, 30% fuel,
ceiling 30, displacement 20) from a ``vmap``-ed reset of ``N`` envs, one
reset and one step program for both cases:

- ``drop``: idle actions for 60 steps, every rocket falling onto the
  ground or its pad (:168-210);
- ``traps``: numpy-seeded actions (free lanes burning), 8 steps, with
  ``TRAPS``' lanes preset: a soft pad touchdown that completes (+500), a
  hard pad touchdown, a ground hit, below ground (over a pad sunk 5 m
  into a pit, so no contact point touches), out of bounds by displacement
  and by the ceiling, truncation at and one step before the time limit,
  and lanes done before the first step (the freeze).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pyflyt_tpu.envs.base import vec_reset
from pyflyt_tpu.envs.rocket_landing import RocketLandingEnv
from pyflyt_tpu.models import rocket

N = 16
FAR_PAD = (1e9, 1e9, 0.0)
ACTIVE_SP = (0.3, -0.2, 0.1, 1.0, 0.6, 0.25, -0.15)
LOW_ENV = dict(ceiling=30.0, max_displacement=20.0, start_pos=((0.0, 0.0, 8.0),), randomize_drop=False,
               accelerate_drop=False, starting_fuel_ratio=0.30, noisy_boosters=False)
# trap -> the lanes it is preset on (the rest of the 16 fly free)
TRAPS = {"soft_complete": (0, 1), "hard_touchdown": (2, 3), "ground_hit": (4,), "below_ground": (5, 6),
         "displacement": (7,), "ceiling": (8,), "truncation": (9, 10), "frozen": (11, 12)}
FREE = tuple(range(13, N))
LEG_Z = 2.425  # the landing legs' tips below the base origin (rocket.json contact_points)


def model_cfg(fuel: float = 0.30) -> rocket.RocketConfig:
    return rocket.RocketConfig(noisy_boosters=False, starting_fuel_ratio=fuel)


@functools.lru_cache(maxsize=None)
def model_step():
    """The jitted XLA ``rocket.step`` (the fuel load at reset plays no part
    in a step)."""
    cfg = model_cfg()
    params = rocket.build_params(cfg)
    return jax.jit(lambda st, pad: rocket.step(st, params, cfg, None, pad_position=pad))


@functools.lru_cache(maxsize=None)
def _model_init(fuel: float):
    cfg = model_cfg(fuel)
    params = rocket.build_params(cfg)
    return jax.jit(lambda pos, orn, vel: rocket.init_state(params, cfg, pos, orn, vel))


@functools.lru_cache(maxsize=None)
def model_case(name: str):
    """``(fuel ratio, initial state, pad (n, 3), [(state, any_ground,
    any_pad)] per step)``, numpy leaves."""
    rng = np.random.default_rng({"active": 0, "burn": 3, "fuel_out": 4}.get(name, 5))
    if name.startswith("rest"):
        n, steps, fuel = 8, 30, 0.30
        pos = np.tile(np.float32([0.0, 0.0, 2.6]), (n, 1))
        orn = np.zeros((n, 3), np.float32)  # upright: a tilted rocket rocks, and its contact set flips chaotically
        vel = np.zeros((n, 3), np.float32)
        sp = np.zeros((n, 7), np.float32)
        pad = np.tile(np.float32([0.3, -0.2, 0.1] if name == "rest_pad" else FAR_PAD), (n, 1))
    else:
        n, steps = N, {"active": 1, "burn": 12, "fuel_out": 12}[name]
        fuel = 2e-4 if name == "fuel_out" else 0.30
        pos = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
        pos[:, 2] = 30.0 if name == "active" else 80.0
        orn = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
        vel = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
        sp = np.tile(np.float32(ACTIVE_SP), (n, 1))
        pad = np.tile(np.float32(FAR_PAD), (n, 1))
    init, step = _model_init(fuel), model_step()
    st = init(jnp.asarray(pos), jnp.asarray(orn), jnp.asarray(vel)).replace(setpoint=jnp.asarray(sp))
    st0 = jax.tree.map(np.asarray, st)
    traj = []
    for _ in range(steps):
        st, g, p = step(st, jnp.asarray(pad))
        traj.append((jax.tree.map(np.asarray, st), np.asarray(g), np.asarray(p)))
    return fuel, st0, pad, traj


def env_actions(i: int, case: str) -> np.ndarray:
    """Idle for ``drop``; for ``traps`` the free lanes burn at 50-100%
    with random finlets and gimbal, the trap lanes idle."""
    a = np.zeros((N, 7), np.float32)
    if case == "traps":
        rng = np.random.default_rng(700 + i)
        free = list(FREE)
        a[free] = rng.uniform(-0.4, 0.4, (len(free), 7))
        a[free, 3] = 1.0
        a[free, 4] = rng.uniform(0.5, 1.0, len(free))
    return a


def _preset_traps(st, env: RocketLandingEnv):
    """Presets ``TRAPS`` on a batched reset state (numpy leaves)."""
    cfg, params = env.cfg, env.params
    pad = np.array(st.pad_position)
    pos = np.array(st.drone.read.view[:, 3])  # base origins
    vel = np.zeros((N, 3), np.float32)
    top = pad[:, 2] + 0.05
    lanes = lambda k: list(TRAPS[k])  # noqa: E731
    for i in lanes("soft_complete"):  # legs 2 mm into the pad, at rest
        pos[i] = [pad[i, 0], pad[i, 1], top[i] + LEG_Z - 0.002]
    for i in lanes("hard_touchdown"):  # 2 cm above the pad at 3 m/s
        pos[i] = [pad[i, 0], pad[i, 1], top[i] + LEG_Z + 0.02]
        vel[i] = [0.0, 0.0, -3.0]
    for i in lanes("ground_hit"):  # 6 m off the pad, 2 cm above the ground at 3 m/s
        pos[i] = [pad[i, 0] + 6.0, pad[i, 1], LEG_Z + 0.02]
        vel[i] = [0.0, 0.0, -3.0]
    for i in lanes("below_ground"):  # over a pad sunk into a pit
        pad[i, 2] = -5.0
        pos[i] = [pad[i, 0], pad[i, 1], 0.1]
        vel[i] = [0.0, 0.0, -8.0]
    for i in lanes("displacement"):
        pos[i] = [env.max_displacement - 0.05, 0.0, 10.0]
        vel[i] = [10.0, 0.0, 0.0]
    for i in lanes("ceiling"):
        pos[i] = [0.0, 0.0, env.ceiling - 0.05]
        vel[i] = [0.0, 0.0, 10.0]
    orn = np.array(st.drone.read.view[:, 1])
    preset = lanes("soft_complete") + lanes("hard_touchdown") + lanes("ground_hit") + lanes("below_ground")
    orn[preset] = 0.0
    fresh = jax.tree.map(np.asarray, jax.jit(lambda p, o, v: rocket.init_state(params, cfg, p, o, v))(
        jnp.asarray(pos), jnp.asarray(orn), jnp.asarray(vel)))
    moved = np.zeros(N, bool)
    moved[[i for k in ("soft_complete", "hard_touchdown", "ground_hit", "below_ground", "displacement", "ceiling")
           for i in TRAPS[k]]] = True

    def pick(a, b):
        m = moved.reshape((N,) + (1,) * (a.ndim - 1))
        return np.where(m, b, a)

    drone = jax.tree.map(pick, st.drone, fresh)
    lin_vel = np.array(st.lin_vel)
    lin_vel[lanes("hard_touchdown") + lanes("ground_hit")] = [0.0, 0.0, -3.0]  # the previous step's memo
    lin_vel[lanes("soft_complete")] = 0.0
    ang_vel = np.array(st.ang_vel)
    ang_vel[preset] = 0.0
    step_count = np.array(st.step_count)
    step_count[TRAPS["truncation"][0]] = env.max_steps + 1
    step_count[TRAPS["truncation"][1]] = env.max_steps - 1
    term = np.array(st.termination)
    fatal = np.array(st.fatal_collision)
    term[lanes("frozen")] = True
    fatal[lanes("frozen")] = True
    return st.replace(drone=drone, pad_position=pad, lin_vel=lin_vel, ang_vel=ang_vel, step_count=step_count,
                      termination=term, fatal_collision=fatal)


@functools.lru_cache(maxsize=None)
def _env_programs():
    env = RocketLandingEnv(**LOW_ENV)
    reset = jax.jit(lambda keys: vec_reset(env, keys))
    return env, reset, jax.jit(jax.vmap(env.step))


@functools.lru_cache(maxsize=None)
def env_case(name: str):
    """``(initial state, initial obs, [(actions, out, state)])``, numpy
    leaves."""
    env, reset, step = _env_programs()
    st, obs = reset(jax.random.split(jax.random.PRNGKey(5), N))
    if name == "traps":
        st = _preset_traps(jax.tree.map(np.asarray, st), env)
        obs = env._obs(jax.tree.map(jnp.asarray, st))
    st = jax.tree.map(jnp.asarray, st)
    st0, obs0 = jax.tree.map(np.asarray, st), np.asarray(obs)
    traj = []
    for i in range({"drop": 60, "traps": 8}[name]):
        a = env_actions(i, name)
        st, out = step(st, jnp.asarray(a))
        traj.append((a, jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, st)))
    return st0, obs0, traj


def assert_step_parity(out, ref, i: int, where: str) -> None:
    """tests/test_pallas_rocket.py:175-194's bounds: obs 5e-3 + 1e-3 i,
    reward 1e-3 + 2e-4 i with rtol 1e-3, the flags exact."""
    msg = f"{where} step {i}"
    np.testing.assert_allclose(out.obs.numpy(), ref.obs, atol=5e-3 + 1e-3 * i, err_msg=f"{msg} obs")
    np.testing.assert_allclose(out.reward.numpy(), ref.reward, atol=1e-3 + 2e-4 * i, rtol=1e-3,
                               err_msg=f"{msg} reward")
    np.testing.assert_array_equal(out.termination.numpy(), ref.termination, err_msg=f"{msg} termination")
    np.testing.assert_array_equal(out.truncation.numpy(), ref.truncation, err_msg=f"{msg} truncation")
    for k in ("fatal_collision", "out_of_bounds", "env_complete"):
        np.testing.assert_array_equal(out.info[k].numpy(), ref.info[k], err_msg=f"{msg} info[{k}]")
