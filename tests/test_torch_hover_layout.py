"""Row 1, K1-hover (``csrc/quadx_hover_step.cu``), torch only: what its
shorter chain relies on.

The kernel runs one thread an env on ``quadx_lane.cuh``'s control and
physics iteration. It computes the view only on an aviary step's last
physics iteration (the shared iteration's ``read`` argument, which the
generic and waypoints kernels pass the same way) and leaves the aviary
loop when the env is done. No card here, so the source lines that
do this are checked as written, and the plain twin shows what they rely
on: no physics iteration reads a view row and the controller reads only
the body-rate rows, so the view of every iteration but an aviary step's
last is never read; termination and truncation never clear.
"""

from __future__ import annotations

import pytest
import torch

from _lane_layout import csrc_text
from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv
from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
from pyflyt_tpu_torch.ops import cuda_quadx as cq

SRC = "quadx_hover_step.cu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_view_and_freeze_lines_are_the_source():
    """The lines the twin checks below stand for, as the sources write
    them: the view only on an aviary step's last iteration, the freeze an
    exit from the aviary loop, and the view's guard in the shared
    iteration, which the generic and waypoints kernels call with ``read``
    and reciprocals too (tests/test_torch_quadx_layout.py)."""
    text = csrc_text(SRC)
    for line in (
        "const bool read = it == c.ratio - 1;  // probe: read",
        "quadx_lane::physics<NOISY, false, false>(s.d, c, &rng, no_wind, read, &rcp);  // probe: recip",
        "if (fminf(fmaxf(s.term, s.trunc), 1.f) > 0.f) break;",
    ):
        assert line in text, line
    shared = csrc_text("quadx_lane.cuh")
    for line in ("const float wind[3], bool read, const Recip* rcp) {\n",
                 "if (read) quadx_math::quat_to_euler(s.quat, eul);", "  if (read) {\n    if (NED) {"):
        assert line in shared, line
    generic, waypoints = csrc_text("quadx_step.cu"), csrc_text("quadx_waypoints_step.cu")
    assert "quadx_lane::control<MODE, NED>(s, sp, c, &cas, &rcp);  // probe: recip" in generic
    assert ("quadx_lane::physics<NOISY, NED, WIND != quadx_lane::WIND_NONE>(s, c, &rng, w, read, &rcp);"
            "  // probe: recip") in generic
    assert "quadx_lane::control<MODE, false>(s.d, sp, c, &s.cas, &rcp);  // probe: recip" in waypoints
    assert "quadx_lane::physics<NOISY, false, false>(s.d, c, &rng, no_wind, read, &rcp);  // probe: recip" in waypoints


def _hover_state(n: int, seed: int):
    env = PackedQuadXHoverEnv(base=QuadXHoverEnv(device="cpu"))
    state, _ = env.reset(n, torch.Generator().manual_seed(seed))
    packed = state.packed.clone()
    g = torch.Generator().manual_seed(seed + 1)
    packed[cq._SP : cq._SP + 4] = torch.rand(4, n, generator=g) * 0.8 - 0.4
    packed[cq._SP + 3] = packed[cq._SP + 3].abs() + 0.2
    return env, packed


def test_the_view_of_an_earlier_iteration_is_never_read():
    """The twin's agent step from states whose view rows 3-11 (angles, body
    velocity, lagged position) are scrambled gives the same bits in every
    row: neither a physics iteration nor the controller reads them, so the
    kernel computes them only on the last iteration. Scrambling the body
    rates (rows 0-2, the PID's input) changes the step."""
    env, packed = _hover_state(64, seed=16)
    zero = torch.zeros(1, dtype=torch.int64)
    ref = cq.packed_hover_step_plain(packed, zero, env.consts, 0, False)
    assert not bool(((ref[cq._TERM] > 0.5) | (ref[cq._TRUNC] > 0.5)).any())
    scrambled = packed.clone()
    scrambled[cq._VIEW + 3 : cq._VIEW + 12] = torch.randn(9, 64, generator=torch.Generator().manual_seed(17))
    assert torch.equal(cq.packed_hover_step_plain(scrambled, zero, env.consts, 0, False), ref)
    rates = packed.clone()
    rates[cq._VIEW : cq._VIEW + 3] += 0.5
    assert not torch.equal(cq.packed_hover_step_plain(rates, zero, env.consts, 0, False), ref)


def test_termination_and_truncation_never_clear():
    """Over 40 agent steps of the twin with half the fleet falling and a
    short time limit, a lane's termination and truncation flags, once set,
    stay set, and a lane done before a step keeps every row but the
    setpoint, the re-armed reward and the step count: a lane done before an
    aviary step can leave the loop."""
    env, packed = _hover_state(64, seed=18)
    packed[cq._SP : cq._SP + 4, :32] = 0.0  # these fall onto the ground
    packed[cq._STEP, 32:] = float(env.base.max_steps) - torch.arange(32, dtype=torch.float32) % 8
    zero = torch.zeros(1, dtype=torch.int64)
    keep = torch.ones(cq.ROWS, dtype=torch.bool)
    keep[cq._SP : cq._SP + 4] = False
    keep[cq._RWD] = False
    keep[cq._STEP] = False
    fired = torch.zeros(64, dtype=torch.bool)
    for _ in range(40):
        done = (packed[cq._TERM] > 0.5) | (packed[cq._TRUNC] > 0.5)
        nxt = cq.packed_hover_step_plain(packed, zero, env.consts, 0, False)
        assert bool((nxt[cq._TERM] >= packed[cq._TERM]).all() and (nxt[cq._TRUNC] >= packed[cq._TRUNC]).all())
        assert torch.equal(nxt[keep][:, done], packed[keep][:, done])
        fired |= done
        packed = nxt
    assert bool(fired[:32].any()) and bool(fired[32:].all())
