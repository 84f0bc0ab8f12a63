"""The JAX dogfight env's reference runs shared by the port's dogfight test
files (tests/test_torch_ma_envs.py, tests/test_torch_dogfight.py).

``reference(case)`` runs ``jax.vmap(MAFixedwingDogfightEnv.step)`` (XLA,
noise off, stock 30 Hz) from a ``vmap``-ed reset of ``N`` arenas, one
reset and one step program per case, with numpy-seeded actions:

- ``engage``: the stock env, the first half of the arenas set up for a
  hit (drone 1 8 m ahead of drone 0's nose and 0.4 m to its left, same
  attitude and velocity: 0.05 rad off its axis, where the cone angle is
  well conditioned), 12 random steps, then the dead-agent step (drone 1
  of every arena marked dead: its actions zeroed, the arena terminated by
  the other-dead rule);
- ``dome10``: a 10 m dome below the 15 m spawn height: out-of-dome on the
  first step;
- ``unassisted``: 6-dim actions through the mode-0 assist map.

``assert_step_parity`` holds a port transition to the reference with
tests/test_pallas_dogfight.py:48-75's bounds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pyflyt_tpu.envs.ma_fixedwing_dogfight import MAFixedwingDogfightEnv

N = 16
CASES = {  # name: (env kwargs, reset seed, steps, action width)
    "engage": (dict(), 1, 12, 4),
    "dome10": (dict(flight_dome_size=10.0), 4, 2, 4),
    "unassisted": (dict(assisted_flight=False), 2, 4, 6),
}


def actions(i: int, dim: int = 4) -> np.ndarray:
    """Engagement-heavy random actions, thrust 0.75 (numpy-seeded)."""
    a = np.random.default_rng(1000 + i).uniform(-0.4, 0.4, (N, 2, dim)).astype(np.float32)
    a[..., -1] = 0.75
    return a


def hit_trap(st):
    """Arenas 0..N/2-1: drone 1 flies 8 m ahead of drone 0, 0.4 m to its left."""
    b = st.drones.body
    e = st.drones.read.view[:, 0, 1]
    fwd = jnp.stack([jnp.cos(e[:, 2]) * jnp.cos(e[:, 1]), jnp.sin(e[:, 2]) * jnp.cos(e[:, 1]), -jnp.sin(e[:, 1])], -1)
    left = jnp.stack([-jnp.sin(e[:, 2]), jnp.cos(e[:, 2]), jnp.zeros_like(e[:, 2])], -1)
    lane = (jnp.arange(N) < N // 2)[:, None]

    def follow(x, lead):
        return x.at[:, 1].set(jnp.where(lane, lead, x[:, 1]))

    body = b.replace(pos=follow(b.pos, b.pos[:, 0] + 8.0 * fwd + 0.4 * left), quat=follow(b.quat, b.quat[:, 0]),
                     lin_vel=follow(b.lin_vel, b.lin_vel[:, 0]), ang_vel=follow(b.ang_vel, b.ang_vel[:, 0]))
    return st.replace(drones=st.drones.replace(body=body))


@functools.lru_cache(maxsize=None)
def reference(case: str):
    """``(env kwargs, reset state, [(actions, out, state)], dead step)``,
    numpy leaves; the dead step ``(alive, actions, out)`` only for
    ``engage``."""
    kw, seed, steps, dim = CASES[case]
    base = MAFixedwingDogfightEnv(noisy_motors=False, **kw)
    st, _ = jax.jit(jax.vmap(base.reset))(jax.random.split(jax.random.PRNGKey(seed), N))
    if case == "engage":
        st = hit_trap(st)
    st0 = jax.tree.map(np.asarray, st)
    step = jax.jit(jax.vmap(base.step))
    traj = []
    for i in range(steps):
        a = actions(i, dim)
        st, out = step(st, jnp.asarray(a))
        traj.append((a, jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, st)))
    dead = None
    if case == "engage":
        alive = np.ones((N, 2), bool)
        alive[:, 1] = False
        a = actions(99, dim)
        _, out = step(st.replace(alive=jnp.asarray(alive)), jnp.asarray(a))
        dead = (alive, a, jax.tree.map(np.asarray, out))
    return kw, st0, traj, dead


def assert_step_parity(out, ref, i: int, tol: float, where: str) -> None:
    """obs within ``tol``, reward within ``tol`` + 1e-4 relative, healths
    1e-5, termination/truncation/collision/out-of-bounds/wins exact."""
    msg = f"{where} step {i}"
    np.testing.assert_allclose(out.obs.numpy(), ref.obs, atol=tol, err_msg=f"{msg} obs")
    np.testing.assert_allclose(out.reward.numpy(), ref.reward, atol=tol, rtol=1e-4, err_msg=f"{msg} reward")
    np.testing.assert_array_equal(out.termination.numpy(), ref.termination, err_msg=f"{msg} termination")
    np.testing.assert_array_equal(out.truncation.numpy(), ref.truncation, err_msg=f"{msg} truncation")
    for k in ("collision", "out_of_bounds", "wins"):
        np.testing.assert_array_equal(out.info[k].numpy(), ref.info[k], err_msg=f"{msg} info[{k}]")
    np.testing.assert_allclose(out.info["healths"].numpy(), ref.info["healths"], atol=1e-5, err_msg=f"{msg} healths")
