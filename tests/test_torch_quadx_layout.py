"""Rows 2 and 4, K1 generic (``csrc/quadx_step.cu``) and the waypoints step
(``csrc/quadx_waypoints_step.cu``), torch only: what their shorter chain
relies on.

Both run one thread an env on ``quadx_lane.cuh``'s control and physics
iteration, as K1-hover does: the view only on an aviary step's last
physics iteration (``read``), reciprocals of the mass, the inertia and the
control period taken once a launch (``rcp``, the mode-7 cascade's banks
included), the constants a ``__grid_constant__``; the waypoints step leaves
the aviary loop when its env is done and updates the lane in place. No card
here, so the source lines are checked as written, and the plain twins show
what they rely on: a physics iteration reads no view row, so the view of
every iteration but an aviary step's last is never read (mode 7's
controller reads it, at iteration 0, from the last one); termination and
truncation never clear, and a done lane keeps its rows.
"""

from __future__ import annotations

import math

import pytest
import torch

from _lane_layout import csrc_text
from pyflyt_tpu_torch.envs import PackedQuadXWaypointsEnv, QuadXWaypointsEnv
from pyflyt_tpu_torch.models import quadx
from pyflyt_tpu_torch.ops import cuda_quadx as cq

N = 64
VIEW = slice(cq._VIEW, cq._VIEW + 12)
WINDS = {"none": None, "baked": {"kind": "gaussian", "base": (3.0, -2.0, 0.5), "max_gust": 0.0},
         "per_env": {"kind": "gaussian", "per_env_base": True, "max_gust": 0.0},
         "simple": {"kind": "simple", "strength": 2.0}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("source, lines", [
    ("quadx_step.cu", (
        "const __grid_constant__ GenericConsts c",
        "const quadx_lane::Recip rcp = quadx_lane::reciprocals(c);",
        "if (it == 0) quadx_lane::control<MODE, NED>(s, sp, c, &cas, &rcp);  // probe: recip",
        "const bool read = it == c.ratio - 1;  // probe: read",
        "quadx_lane::physics<NOISY, NED, WIND != quadx_lane::WIND_NONE>(s, c, &rng, w, read, &rcp);",
    )),
    ("quadx_waypoints_step.cu", (
        "const __grid_constant__ WaypointsConsts c",
        "const quadx_lane::Recip rcp = quadx_lane::reciprocals(c);",
        "if (fminf(fmaxf(s.term, s.trunc), 1.f) > 0.f) break;  // probe: freeze",
        "if (it == 0) quadx_lane::control<MODE, false>(s.d, sp, c, &s.cas, &rcp);  // probe: recip",
        "const bool read = it == c.ratio - 1;  // probe: read",
        "      if (read)\n        for (int k = 0; k < 4; ++k) q_pre[k] = s.d.quat[k];",
        "quadx_lane::physics<NOISY, false, false>(s.d, c, &rng, no_wind, read, &rcp);  // probe: recip",
    )),
    ("quadx_lane.cuh", (
        "const float deriv = rcp ? kd[i] * (err - r[K + i]) * rcp->period : kd[i] * (err - r[K + i]) / period;",
        "sincosf(s.view[5], &sy, &cy);",
        "const float wind[3], bool read, const Recip* rcp) {",
    )),
    ("quadx_math.cuh", (
        "const bool last = k == nt - 1;",
        "for (int i = 0; i < 3; ++i) tgt[3 * k + i] = last ? first[i] : tgt[3 * k + i];",
    )),
])
def test_the_redesign_lines_are_the_source(source, lines):
    """The lines the twins below stand for, as the sources write them; the
    waypoints step keeps no second copy of the lane and no select, and
    the target roll stores no slot under ``k == nt - 1`` (the compiler
    turned that into a store at a runtime index, which sent the whole lane
    to local memory)."""
    text = csrc_text(source)
    for line in lines:
        assert line in text, line
    if source == "quadx_waypoints_step.cu":
        assert "WaypointsLane nw" not in text and "s = nw" not in text
    if source == "quadx_math.cuh":
        assert "if (k == nt - 1)" not in text
    if source == "quadx_lane.cuh":  # every cascade bank multiplies where the kernel passes rcp
        assert text.count("c.period, rcp, &s.view[") == 5


def _generic_state(conv: str, seed: int):
    cfg = quadx.QuadXConfig(orn_conv=conv, control_hz=80, noisy_motors=False)
    params = quadx.build_params(cfg, "cpu")
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand(N, 3, generator=g) * 4 - 2
    pos[:, 2] = (torch.rand(N, generator=g) * 4 + 2) * (-1.0 if conv == "NED_FRD" else 1.0)
    st = quadx.init_state(params, cfg, pos, torch.rand(N, 3, generator=g) * 0.6 - 0.3)
    st.body.lin_vel = torch.rand(N, 3, generator=g) * 2 - 1
    st.body.ang_vel = torch.rand(N, 3, generator=g) * 2 - 1
    st.body.pos[::8, 2] = 0.005  # these hit the ground
    st.body.lin_vel[::8, 2] = -1.0
    packed = cq.pack_state(st)
    packed[cq._WBASE : cq._WBASE + 3] = torch.rand(3, N, generator=g) * 8 - 4
    packed[cq._SP : cq._SP + 4] = torch.rand(4, N, generator=g) * 0.5 + 0.1
    packed[cq._PWM : cq._PWM + 4] = torch.rand(4, N, generator=g) * 0.6 + 0.2
    return cfg, params, packed


def _one_iteration(packed, c, ned: bool, seed: int) -> torch.Tensor:
    """The twin's physics iteration (``_wind_plain`` then ``_physics_plain``)
    on the drone rows of ``packed``, repacked."""
    S = list(packed.unbind(0))
    st = cq._unpack_rows(S)
    gen = torch.Generator().manual_seed(seed)
    wbase = S[cq._WBASE : cq._WBASE + 3] if c.wind_kind == cq.WIND_GAUSSIAN_ENV else None
    cq._physics_plain(st, c, gen, False, ned, cq._wind_plain(st, wbase, c, gen))
    out = list(S)
    cq._pack_rows(out, st, S[cq._SP : cq._SP + 4])
    return torch.stack(out)


@pytest.mark.parametrize("wind", list(WINDS))
@pytest.mark.parametrize("conv", ["ENU_FLU", "NED_FRD"])
def test_a_physics_iteration_reads_no_view_row(conv, wind):
    """One physics iteration of the twin from a state whose view rows 0-11
    are scrambled gives the same bits in every other row, in either
    convention and each wind kind, noise off (the simple field draws the
    same numbers from the same seed): so a view the kernel does not compute
    (``read`` false) is never read before an aviary step's last iteration
    writes it."""
    cfg, params, packed = _generic_state(conv, seed=40)
    c = cq.with_wind(cq.generic_consts(params, cfg), WINDS[wind])
    ref = _one_iteration(packed, c, conv == "NED_FRD", seed=41)
    scrambled = packed.clone()
    scrambled[VIEW] = torch.randn(12, N, generator=torch.Generator().manual_seed(42)) * 3
    got = _one_iteration(scrambled, c, conv == "NED_FRD", seed=41)
    rest = torch.ones(packed.shape[0], dtype=torch.bool)
    rest[VIEW] = False
    assert torch.equal(got[rest], ref[rest])
    assert bool((ref[cq._CON] > 0.5).any())  # the contact branch ran


@pytest.mark.parametrize("mode, rows", [(0, slice(0, 3)), (7, slice(3, 12))])
def test_the_controller_reads_the_view_at_iteration_0(mode, rows):
    """The other side: the controller, which runs at iteration 0 only,
    reads the view (mode 0 its body rates, mode 7's cascade the angles,
    the body velocity and the lagged position), so the generic step from a
    scrambled view differs. That view is the previous aviary step's last,
    which every kernel computes."""
    cfg, params, packed = _generic_state("ENU_FLU", seed=43)
    c = cq.generic_consts(params, cfg)
    if mode == 7:
        packed = torch.cat([packed, torch.zeros(cq.ROWS_MODE7 - cq.ROWS, N)])
    zero = torch.zeros(1, dtype=torch.int64)
    ref = cq.packed_step_plain(packed, zero, c, mode, False)
    scrambled = packed.clone()
    scrambled[cq._VIEW + rows.start : cq._VIEW + rows.stop] += 0.25
    assert not torch.equal(cq.packed_step_plain(scrambled, zero, c, mode, False)[cq._PWM : cq._PWM + 4],
                           ref[cq._PWM : cq._PWM + 4])


WP_CASES = {7: dict(goal_reach_distance=1.2), 0: dict(max_duration_seconds=0.5),
            8: dict(flight_dome_size=2.0, max_duration_seconds=0.5)}


def _wp_actions(mode: int, packed, step: int):
    if mode == 7:  # chase the current target
        cur = packed[cq.rows_for(7) + cq._WP_TGT : cq.rows_for(7) + cq._WP_TGT + 3]
        a = torch.stack([cur[0], cur[1], torch.zeros_like(cur[0]), cur[2]])
        a[3, : N // 2] = -5.0  # these descend into the ground
        return a
    a = torch.rand(4, N, generator=torch.Generator().manual_seed(300 + step))
    if mode == 0:
        a[:3] = (a[:3] - 0.5) * 1.2
        a[3] = 0.3 + 0.4 * a[3]
    else:
        a = 0.1 + 0.5 * a
    a[:, : N // 2] = 0.0  # no thrust: these fall
    return a


@pytest.mark.parametrize("mode", list(WP_CASES))
def test_waypoints_flags_never_clear_and_a_done_lane_keeps_its_rows(mode):
    """Over 40 agent steps of the row-4 twin, half the fleet falling and the
    other half's time limits staggered by column mod 8: a lane's termination
    and truncation flags, once set, stay set, and a lane done before a step
    keeps every row but the setpoint, the re-armed reward and the step
    count. So the kernel may leave the aviary loop (``break``) where the
    twin selects, and update the lane in place."""
    env = PackedQuadXWaypointsEnv(QuadXWaypointsEnv(flight_mode=mode, noisy_motors=False, device="cpu",
                                                    **WP_CASES[mode]))
    state, _ = env.reset(N, torch.Generator().manual_seed(50 + mode))
    packed = state.packed.clone()
    packed[cq._POS + 2, : N // 4] = 0.05
    packed[cq._LVEL + 2, : N // 4] = -1.0
    cols = torch.arange(N // 2, N)
    packed[cq._STEP, cols] = env.consts.max_steps - (cols % 8).float() - 2.0
    zero = torch.zeros(1, dtype=torch.int64)
    keep = torch.ones(cq.rows_for_waypoints(mode), dtype=torch.bool)
    keep[cq._SP : cq._SP + 4] = False
    keep[cq._RWD] = False
    keep[cq._STEP] = False
    first = torch.full((N,), -1)
    for i in range(40):
        packed[cq._SP : cq._SP + 4] = _wp_actions(mode, packed, i)
        done = (packed[cq._TERM] > 0.5) | (packed[cq._TRUNC] > 0.5)
        nxt = cq.packed_waypoints_step_plain(packed, zero, env.consts, mode, False)
        assert bool((nxt[cq._TERM] >= packed[cq._TERM]).all() and (nxt[cq._TRUNC] >= packed[cq._TRUNC]).all())
        assert torch.equal(nxt[keep][:, done], packed[keep][:, done])
        assert bool((nxt[cq._STEP] == packed[cq._STEP] + 1.0).all())
        assert bool((nxt[cq._RWD][done] == -0.1).all())  # re-armed, frozen or not
        first[((nxt[cq._TERM] > 0.5) | (nxt[cq._TRUNC] > 0.5)) & (first < 0)] = i
        packed = nxt
    assert bool((first[: N // 4] >= 0).all()) and bool((first[N // 2 :] >= 0).all())
    assert len(set(first[N // 2 :].tolist())) > 1  # neighbours freeze at different agent steps
    assert math.isfinite(float(packed.abs().max()))
