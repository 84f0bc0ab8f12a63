"""Row 1 (the fused hover step) in flight mode 7: the port's
``PackedQuadXHoverEnv(QuadXHoverEnv(flight_mode=7))``, on CPU tensors the
kernel's plain twin, against the JAX package's plain ``QuadXHoverEnv`` in
mode 7 stepped under ``jax.vmap``.

From a JAX reset carried across, 16 envs fly tests/test_packed_hover.py's
mode-7 setpoints for 48 agent steps, noise off, in a 1.5 m dome: half hold
a position near the spawn, half are sent 2.5 m up, out of the dome. Obs
and reward are held to that test's 5e-4 + 1e-4 * step, termination,
truncation, collision and out-of-bounds exactly, and the cascade's 18 rows
(rows 56-73) to the JAX PID banks at the same curve. Then the 80-row pack
and unpack row by row against the JAX packed env's, the cached auto-reset
in mode 7, and one PPO iteration at 64 envs on the slice's 3 x 256 trunk.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyflyt_tpu.envs.base import vec_reset
from pyflyt_tpu.envs.packed_hover import PackedQuadXHoverEnv as JPackedHoverEnv
from pyflyt_tpu.envs.quadx_hover import QuadXHoverEnv as JHoverEnv
from pyflyt_tpu_torch.convert import quadx_state_from_jax
from pyflyt_tpu_torch.envs.packed_hover import (
    PackedHoverState,
    PackedQuadXHoverEnv,
    packed_autoreset_init,
    packed_cached_autoreset_step,
)
from pyflyt_tpu_torch.envs.quadx_base import QuadXEnvState
from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
from pyflyt_tpu_torch.ops import cuda_quadx as cq
from pyflyt_tpu_torch.rl import PPO, PPOConfig

torch.set_num_threads(1)

N = 16
STEPS = 48
DOME = 1.5
KW = dict(flight_mode=7, flight_dome_size=DOME, noisy_motors=False)
# the cascade's banks in rows 56-73: (JAX bank, first row, lanes)
BANKS = (("lin_pos", cq._LP_INT, 2), ("lin_vel", cq._LV_INT, 2), ("ang_pos", cq._AP_INT, 3),
         ("z_pos", cq._ZP_INT, 1), ("z_vel", cq._ZV_INT, 1))


def _setpoints(n=N):
    """[x, y, yaw, z]: half the fleet holds near the spawn, half climbs out."""
    sp = np.tile(np.asarray([0.1, -0.1, 0.2, 1.2], np.float32), (n, 1))
    sp[: n // 2, 3] = 2.5
    return sp


def _carry(st) -> QuadXEnvState:
    """The port's ``QuadXEnvState`` from a JAX one's numpy leaves."""
    f = lambda a, dt=torch.float32: torch.tensor(np.array(a), dtype=dt)  # noqa: E731
    return QuadXEnvState(
        drone=quadx_state_from_jax(jax.tree.map(np.asarray, st.drone), device="cpu"),
        step_count=f(st.step_count, torch.int32), termination=f(st.termination, torch.bool),
        truncation=f(st.truncation, torch.bool), reward=f(st.reward), action=f(st.action),
        collision=f(st.collision, torch.bool), out_of_bounds=f(st.out_of_bounds, torch.bool),
        env_complete=f(st.env_complete, torch.bool), generator=None,
    )


@pytest.fixture(scope="module")
def reference():
    """The JAX reset and 48 vmapped plain steps: per step the outputs and
    the cascade's PID banks."""
    env = JHoverEnv(**KW)
    st0, _ = vec_reset(env, jax.random.split(jax.random.PRNGKey(21), N))
    vstep = jax.jit(jax.vmap(env.step))
    sp = jnp.asarray(_setpoints())
    st, traj = st0, []
    for _ in range(STEPS):
        st, out = vstep(st, sp)
        pids = st.drone.pids
        traj.append({
            "obs": np.asarray(out.obs), "reward": np.asarray(out.reward),
            "termination": np.asarray(out.termination), "truncation": np.asarray(out.truncation),
            "collision": np.asarray(out.info["collision"]), "out_of_bounds": np.asarray(out.info["out_of_bounds"]),
            "setpoint": np.asarray(st.drone.setpoint),
            "banks": {b: (np.asarray(getattr(pids, b).integral), np.asarray(getattr(pids, b).prev_error))
                      for b, _, _ in BANKS},
        })
    return env, st0, traj


def _env():
    return PackedQuadXHoverEnv(base=QuadXHoverEnv(device="cpu", **KW))


def test_the_mode7_twin_follows_the_jax_env(reference):
    """Row 1's twin in mode 7 against the JAX plain env over 48 steps: obs,
    reward and the cascade's 18 rows within 5e-4 + 1e-4 * step, the flags
    exact, the position setpoint in the setpoint rows as in the JAX env;
    the dome and the freeze fire."""
    _, st0, traj = reference
    env = _env()
    state = PackedHoverState(packed=env.pack_env_state(_carry(st0)), generator=None)
    sp = torch.from_numpy(_setpoints())
    done_any = False
    for i, ref in enumerate(traj):
        state, out = env.step(state, sp)
        tol = 5e-4 + 1e-4 * i
        p = state.packed
        assert p.shape == (cq.ROWS_MODE7, N)
        np.testing.assert_allclose(out.obs.numpy(), ref["obs"], atol=tol, err_msg=f"step {i} obs")
        np.testing.assert_allclose(out.reward.numpy(), ref["reward"], atol=tol, err_msg=f"step {i} reward")
        for k in ("termination", "truncation"):
            np.testing.assert_array_equal(getattr(out, k).numpy(), ref[k], err_msg=f"step {i} {k}")
        for k in ("collision", "out_of_bounds"):
            np.testing.assert_array_equal(out.info[k].numpy(), ref[k], err_msg=f"step {i} {k}")
        np.testing.assert_array_equal(p[cq._SP : cq._SP + 4].T.numpy(), ref["setpoint"])
        np.testing.assert_array_equal(out.obs[:, 13:17].numpy(), ref["setpoint"])  # the action in the obs
        for bank, row, k in BANKS:
            integral, prev = ref["banks"][bank]
            np.testing.assert_allclose(p[row : row + k].T.numpy(), integral, atol=tol, err_msg=f"step {i} {bank}")
            np.testing.assert_allclose(p[row + k : row + 2 * k].T.numpy(), prev, atol=tol, err_msg=f"step {i} {bank}")
        assert not bool(p[cq._ZV_PRV + 1 :].any())  # rows 74-79
        done_any |= bool(ref["termination"].any())
    assert done_any and bool(ref["out_of_bounds"][: N // 2].all()) and not ref["termination"][N // 2 :].any()


def test_pack_and_unpack_at_80_rows_match_the_jax_packed_env(reference):
    """The port's 80-row pack of a carried JAX state equals the JAX packed
    env's, row by row, bit for bit; unpacking gives the state back."""
    _, st0, _ = reference
    jenv = JPackedHoverEnv(base=JHoverEnv(**KW))
    want = np.asarray(jenv.pack_env_state(st0)).reshape(cq.ROWS_MODE7, -1)
    env = _env()
    carried = _carry(st0)
    got = env.pack_env_state(carried)
    assert got.shape == (cq.ROWS_MODE7, N)
    for r in range(cq.ROWS_MODE7):
        np.testing.assert_array_equal(got[r].numpy(), want[r], err_msg=f"row {r}")
    back = env.unpack_env_state(got, dataclasses.replace(carried, reward=carried.reward * 0))
    for bank, _, _ in BANKS:
        for field in ("integral", "prev_error"):
            assert torch.equal(getattr(getattr(back.drone.pids, bank), field),
                               getattr(getattr(carried.drone.pids, bank), field))
    assert torch.equal(back.drone.body.pos, carried.drone.body.pos)
    assert torch.equal(back.reward, carried.reward) and torch.equal(back.step_count, carried.step_count)


def test_the_cached_autoreset_carries_80_rows():
    """Finished lanes take their cached 80-row column (the cascade's banks
    included), the others the step's; the terminal observation is the
    step's."""
    env = _env()
    ars, _ = packed_autoreset_init(env, N)
    assert ars.env_state.packed.shape == ars.cache_packed.shape == (cq.ROWS_MODE7, N)
    sp = torch.from_numpy(_setpoints())
    for _ in range(STEPS):
        pre = ars
        ars, out = packed_cached_autoreset_step(env, ars, sp, refresh=1000)
        done = out.termination | out.truncation
        if done.any():
            break
    assert done.any() and (~done).any()
    stepped, ref_out = env.step(dataclasses.replace(pre.env_state, packed=pre.env_state.packed.clone()), sp)
    p = ars.env_state.packed
    np.testing.assert_array_equal(p[:, done].numpy(), pre.cache_packed[:, done].numpy())
    np.testing.assert_array_equal(p[:, ~done].numpy(), stepped.packed[:, ~done].numpy())
    assert bool(p[cq._LP_INT : cq._ZV_PRV + 1, ~done].abs().sum() > 0)  # the stepping lanes' cascade moved
    np.testing.assert_array_equal(out.obs[done].numpy(), pre.cache_obs[done].numpy())
    np.testing.assert_array_equal(out.info["terminal_observation"].numpy(), ref_out.obs.numpy())


def test_ppo_iteration_in_mode7_at_3x256():
    """One ``fused_sgd`` iteration with the fused rollout forward on 64
    mode-7 envs at the hovering CLI's 3 x 256 trunk (on the card: row 1,
    K4g, K3g and K2g)."""
    env = PackedQuadXHoverEnv(base=QuadXHoverEnv(flight_mode=7, device="cpu"))
    cfg = PPOConfig(num_envs=64, rollout_steps=8, num_epochs=2, num_minibatches=2, cached_reset_refresh=64,
                    fused_sgd=True, fused_rollout_forward=True, feature_sizes=(256, 256, 256))
    tp = PPO(env, cfg)
    runner = tp.init(0)
    assert runner.env_state.env_state.packed.shape == (cq.ROWS_MODE7, 64)
    before = [p.detach().clone() for p in runner.network.parameters()]
    runner, metrics = tp.train_iteration(runner)
    assert int(runner.opt_state.count) == cfg.num_epochs * cfg.num_minibatches
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert any(not torch.equal(a, b) for a, b in zip(before, runner.network.parameters()))
