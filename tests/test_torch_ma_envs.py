"""The port's multi-agent envs against the JAX package's XLA envs.

- ``MAQuadXHoverEnv`` against ``jax.vmap(MAQuadXHoverEnv.step)`` from a
  carried JAX reset (``convert.ma_quadx_state_from_jax``, no generator:
  quiet motors), noise off (the JAX env draws motor noise unconditionally:
  the test swaps its cached config for one with ``noisy_motors=False``):
  euler attitudes, and
  quaternions with two drones on top of each other (collision) in a 1.75 m
  dome (out-of-dome).
- The plain ``MAFixedwingDogfightEnv`` against ``jax.vmap(
  MAFixedwingDogfightEnv.step)`` at the stock 30 Hz from carried resets
  (``convert.dogfight_state_from_jax``), tests/_dogfight_reference.py's
  cases: 12 engagement-heavy steps with half the arenas set up to score
  hits, the dead-agent (other-dead) step, out-of-dome in a 10 m dome, and
  6-dim unassisted actions; tests/test_pallas_dogfight.py:48-75's bounds
  (obs 2e-3 + 1e-3·step, reward 1e-4 relative, healths 1e-5, flags exact).
- The port's own reset: spawn separation, shapes, and ``scene_boxes``
  (the gunsight markers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _dogfight_reference import CASES, assert_step_parity, reference

from pyflyt_tpu.envs.ma_quadx_hover import MAQuadXHoverEnv as JMAQuadX
from pyflyt_tpu_torch.convert import dogfight_state_from_jax, ma_quadx_state_from_jax
from pyflyt_tpu_torch.envs import MAFixedwingDogfightEnv, MAQuadXHoverEnv

torch.set_num_threads(1)

QUADX_CASES = {  # name: env kwargs
    "euler": dict(),
    "quaternion_collide": dict(angle_representation="quaternion", flight_dome_size=1.75,
                               start_pos=((-1.0, -1.0, 1.0), (-1.0, -1.0, 1.05), (-1.0, 1.0, 1.0), (1.0, 1.0, 1.0))),
}
QUADX_ARENAS = 8
QUADX_STEPS = 10


@pytest.mark.parametrize("case", list(QUADX_CASES))
def test_ma_quadx_hover_matches_jax(case):
    kw = QUADX_CASES[case]
    jenv = JMAQuadX(**kw)
    jenv.__dict__["cfg"] = dataclasses.replace(jenv.cfg, noisy_motors=False)  # the cached config, noise off
    st, jobs = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(3), QUADX_ARENAS))
    env = MAQuadXHoverEnv(device="cpu", **kw)
    ts = ma_quadx_state_from_jax(jax.tree.map(np.asarray, st), device="cpu")
    np.testing.assert_allclose(env._obs(ts).numpy(), np.asarray(jobs), atol=1e-6)
    step = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(7)
    events = dict(collision=0, out_of_bounds=0, termination=0)
    for i in range(QUADX_STEPS):
        a = rng.uniform(-0.5, 0.5, (QUADX_ARENAS, 4, 4)).astype(np.float32)
        a[..., 3] = rng.uniform(0.3, 0.7, (QUADX_ARENAS, 4))
        st, ref = step(st, jnp.asarray(a))
        ts, out = env.step(ts, torch.tensor(a))
        tol = 1e-4 + 1e-4 * i
        np.testing.assert_allclose(out.obs.numpy(), np.asarray(ref.obs), atol=tol, err_msg=f"{case} step {i} obs")
        np.testing.assert_allclose(out.reward.numpy(), np.asarray(ref.reward), atol=tol, rtol=1e-5,
                                   err_msg=f"{case} step {i} reward")
        for k, x, y in (("termination", out.termination, ref.termination), ("truncation", out.truncation,
                        ref.truncation), ("agents_mask", out.agents_mask, ref.agents_mask),
                        ("collision", out.info["collision"], ref.info["collision"]),
                        ("out_of_bounds", out.info["out_of_bounds"], ref.info["out_of_bounds"])):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f"{case} step {i} {k}")
        np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(st.alive))
        for k in events:
            events[k] += int(np.asarray(ref.info[k] if k != "termination" else ref.termination).sum())
    assert out.obs.shape == (QUADX_ARENAS, 4, env.obs_size)
    if case == "quaternion_collide":
        assert events["collision"] > 0 and events["out_of_bounds"] > 0, events
        assert not ts.alive[:, :2].any()  # the colliding pair is culled


@pytest.mark.parametrize("case", list(CASES))
def test_dogfight_env_matches_jax(case):
    kw, st0, traj, dead = reference(case)
    env = MAFixedwingDogfightEnv(noisy_motors=False, device="cpu", **kw)
    ts = dogfight_state_from_jax(st0, device="cpu")
    for i, (a, ref, _) in enumerate(traj):
        ts, out = env.step(ts, torch.tensor(a))
        assert_step_parity(out, ref, i, 2e-3 + 1e-3 * i, f"plain {case}")
    if case == "engage":
        hits = sum(int(s.current_hits.sum()) for _, _, s in traj)
        assert hits > 0 and float(traj[-1][2].health.min()) < 1.0, "the hit trap scored no hit"
        alive, a, ref = dead
        ts = dataclasses.replace(ts, alive=torch.tensor(alive))
        _, out = env.step(ts, torch.tensor(a))
        assert_step_parity(out, ref, len(traj), 2e-3 + 1e-3 * len(traj), "plain dead-agent")
        assert bool(out.termination.all()), "other_dead must terminate every arena"
        np.testing.assert_array_equal(out.agents_mask.numpy(), ref.agents_mask)
    if case == "dome10":
        assert bool(traj[0][1].info["out_of_bounds"].all()) and bool(traj[0][1].termination.all())


def test_dogfight_reset_spawns_and_raises():
    env = MAFixedwingDogfightEnv(device="cpu")
    st, obs = env.reset(64, torch.Generator().manual_seed(0))
    assert obs.shape == (64, 2, 30) and env.obs_size == 30
    sep = (st.drones.read.view[:, 0, 3] - st.drones.read.view[:, 1, 3]).norm(dim=-1)
    assert float(sep.min()) > 0.2 * env.flight_dome_size - 1.0  # 10 stabilization steps of drift
    assert bool((st.health == 1.0).all()) and bool(st.alive.all())
    six = MAFixedwingDogfightEnv(assisted_flight=False, device="cpu")
    st6, obs6 = six.reset(4, torch.Generator().manual_seed(0))
    assert obs6.shape == (4, 2, 32) and st6.drones.setpoint.shape == (4, 2, 6)
    # the gunsight markers (the camera came with ROADMAP item 21): one a
    # drone, 0.65 m ahead of its nose, black while no hit is scored
    boxes = env.scene_boxes(st)
    assert boxes.centers.shape == (64, 2, 3) and boxes.rotations.shape == (64, 2, 3, 3)
    ahead = (boxes.centers - st.drones.read.view[:, :, 3]).norm(dim=-1)
    torch.testing.assert_close(ahead, torch.full_like(ahead, 0.65), rtol=0, atol=1e-5)
    assert bool(boxes.visible.all()) and bool((boxes.colors[..., :3] == 0).all())
    with pytest.raises(ValueError, match="Generator"):
        env.reset(2, None)
