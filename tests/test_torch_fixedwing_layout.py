"""The lane groups of K5 (``csrc/fixedwing_step.cu``) and K7
(``csrc/dogfight_step.cu``) on ``csrc/fixedwing_lane.cuh``, torch only.

Each kernel spreads a drone over a group of GROUP lanes: lane k < 5 owns
surface k, the surfaces' 6-float wrench is summed by a ``__shfl_xor_sync``
butterfly on the group's mask, and every lane adds the motor's wrench to
the sum and integrates the rigid body itself. No card here, so a
Python mirror of the kernels' thread map, group mask, row ownership and
butterfly is held to the conditions the CUDA code relies on, and tied to
the sources by the lines it mirrors: the group and block sizes, the
column -> (block, warp, group, lane) map at the stock, ragged and mid-warp
widths, the partner group of K7's pairs, one store per row and column,
and the butterfly's sum order on the twin's per-surface wrenches.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _lane_layout import butterfly, const, csrc_text, thread_map
from pyflyt_tpu_torch.models import fixedwing
from pyflyt_tpu_torch.ops import cuda_dogfight as cd
from pyflyt_tpu_torch.ops import cuda_fixedwing as cf

K5, K7 = "fixedwing_step.cu", "dogfight_step.cu"
ROWS = {K5: cf.ROWS, K7: cd.ROWS}
WIDTHS = {K5: (1, 1000, 4093, 4096), K7: (2, 1998, 2002, 8192)}
HEADER = "fixedwing_lane.cuh"


def _sizes(source: str) -> tuple[int, int]:
    return const(source, "GROUP"), const(source, "THREADS")


@pytest.mark.parametrize("source", [K5, K7])
def test_group_and_block_sizes(source):
    group, threads = _sizes(source)
    assert 32 % group == 0 and 2 * group <= 32 and group & (group - 1) == 0
    assert threads % 32 == 0  # blocks of whole warps: no group straddles two


def test_the_mirrored_lines_are_the_sources():
    """The lines the mirrors below copy, as the sources write them."""
    header = csrc_text(HEADER)
    assert "return ((1u << G) - 1u) << ((threadIdx.x & 31u) & ~static_cast<unsigned>(G - 1));" in header
    assert "for (int o = 1; o < G; o <<= 1) x += __shfl_xor_sync(mask, x, o);" in header
    assert "const int k = lane + G * j;" in header
    assert "if (lane == row % G) O[row * ld] = v;" in header
    assert "put<G>(O, ld, lane, THR, s.thr);" in header
    # the surfaces' partial wrenches go into the butterfly, the motor's after it
    sums = header.index("f[i] = group_sum<G>(f[i], mask);")
    assert header.index("add_surface_wrench(o.S[j]") < sums < header.index("f[i] += rc * c.mot_f[i];")
    for source in (K5, K7):
        text = csrc_text(source)
        assert "const int tid = blockIdx.x * THREADS + threadIdx.x;" in text
        assert "const int i = tid / GROUP, lane = tid % GROUP;" in text
        assert "(n * GROUP + THREADS - 1) / THREADS" in text
    assert "__shfl_xor_sync(FULL_MASK, x, GROUP)" in csrc_text(K7)


def row_owner(row: int, group: int) -> int:
    """The lane of a group that writes ``row``: a surface's rows its
    surface's lane, any other row (held by every lane) row % G."""
    if cf._SLV <= row < cf._SLV + 3 * cf.NUM_SURFACES:
        return ((row - cf._SLV) // 3) % group
    if cf._ACT <= row < cf._ACT + cf.NUM_SURFACES:
        return (row - cf._ACT) % group
    return row % group


@pytest.mark.parametrize("source,n", [(s, n) for s in (K5, K7) for n in WIDTHS[s]])
def test_every_column_has_one_group_and_every_row_one_store(source, n):
    group, threads = _sizes(source)
    m = thread_map(n, group, threads)
    live = m["col"] < n
    # one group of `group` lanes a column, its lanes 0..G-1 in one warp
    cols, counts = np.unique(m["col"][live], return_counts=True)
    assert np.array_equal(cols, np.arange(n)) and (counts == group).all()
    for lane in range(group):
        assert np.array_equal(np.sort(m["col"][live & (m["lane"] == lane)]), np.arange(n))
    warp_of = m["warp"][live].reshape(n, group)
    assert (warp_of == warp_of[:, :1]).all()
    # each group's mask is exactly its lanes (a group's threads are
    # consecutive: col = tid // G)
    wl = m["wl"].reshape(-1, group)
    bits = (1 << wl).sum(1)
    assert (m["mask"].reshape(-1, group) == bits[:, None]).all()
    assert (np.unique(m["col"].reshape(-1, group), axis=1).shape[1] == 1)
    assert all(bin(int(b)).count("1") == group for b in np.unique(bits))
    # every row of every live column written by exactly one lane
    owners = np.array([row_owner(r, group) for r in range(ROWS[source])])
    stores = np.zeros((ROWS[source], n), dtype=np.int64)
    for lane in range(group):
        c = m["col"][live & (m["lane"] == lane)]
        stores[np.ix_(owners == lane, c)] += 1
    assert (stores == 1).all()
    assert m["blocks"] == -(-n * group // threads)


@pytest.mark.parametrize("n", WIDTHS[K7])
def test_k7_partner_group_is_in_the_same_warp(n):
    """Drone 2a's partner is 2a + 1: thread tid ^ GROUP, in tid's warp, and
    a group past the edge has its partner past it too (n is even)."""
    group, threads = _sizes(K7)
    m = thread_map(n, group, threads)
    partner = np.arange(m["col"].size) ^ group
    assert (m["col"][partner] == m["col"] ^ 1).all()
    assert (m["warp"][partner] == m["warp"]).all()
    assert (m["lane"][partner] == m["lane"]).all()
    assert ((m["col"] < n) == (m["col"][partner] < n)).all()


@pytest.mark.parametrize("source", [K5, K7])
def test_surfaces_own_distinct_lanes(source):
    """One surface a lane, so a lane's chain is one surface long."""
    group, _ = _sizes(source)
    assert len({k % group for k in range(cf.NUM_SURFACES)}) == cf.NUM_SURFACES


def _wrench_partials(group: int, n: int, seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each lane's 6-float partial wrench (force, torque) as the grouped
    iteration computes it from the twin's per-surface forces, the motor's
    wrench, and the one-thread serial sum: (G, 6, n), (6, n), (6, n)."""
    cfg = fixedwing.FixedwingConfig()
    c = cf.fixedwing_consts(fixedwing.build_params(cfg, "cpu"), cfg)
    rng = np.random.default_rng(seed)
    lv = torch.from_numpy((np.array([15.0, 0.0, 0.0])[:, None] + 8.0 * rng.standard_normal((3, n)))
                          .astype(np.float32))
    act = torch.from_numpy((0.5 * rng.standard_normal(n)).astype(np.float32))
    thr = torch.from_numpy(np.abs(0.6 * rng.standard_normal(n)).astype(np.float32))
    f32 = lambda v: np.float32(v)  # noqa: E731
    parts, serial = [], np.zeros((6, n), np.float32)
    for k in range(cf.NUM_SURFACES):
        fn, fp, qcm = (v.numpy() for v in cf._surface_plain(c, k, act, list(lv.unbind(0))))
        lu, du, tu, r = (np.array(getattr(c, a)[3 * k : 3 * k + 3], np.float32) for a in ("lu", "du", "tu", "r_s"))
        fs = [fn * lu[i] + fp * du[i] for i in range(3)]
        w = np.stack([*fs, qcm * tu[0] + (r[1] * fs[2] - r[2] * fs[1]),
                      qcm * tu[1] + (r[2] * fs[0] - r[0] * fs[2]), qcm * tu[2] + (r[0] * fs[1] - r[1] * fs[0])])
        parts.append(w.astype(np.float32))
        serial = serial + parts[-1]
    rpm = thr.numpy() * f32(c.mot_max_rpm)
    rc = rpm * rpm * np.sign(rpm)
    motor = np.stack([rc * f32(v) for v in (*c.mot_f, *c.mot_t)]).astype(np.float32)
    serial = serial + motor
    lanes = np.zeros((group, 6, n), np.float32)
    for k, w in enumerate(parts):
        lanes[k % group] = lanes[k % group] + w
    return lanes, motor, serial


@pytest.mark.parametrize("source", [K5, K7])
def test_butterfly_sums_the_wrench_with_the_same_bits_in_every_lane(source):
    group, _ = _sizes(source)
    lanes, motor, serial = _wrench_partials(group, 4096, seed=11)
    out = butterfly(lanes) + motor  # every lane adds the motor's wrench to the sum
    assert out.dtype == np.float32
    assert (out == out[:1]).all()  # bit-identical in every lane of the group
    scale = np.abs(lanes).sum(0) + np.abs(motor) + 1.0
    assert (np.abs(out[0] - serial) <= 4 * np.finfo(np.float32).eps * scale).all()
