"""The lane groups of K6 (``csrc/rocket_step.cu``, rows 8 and 9), torch only.

Each rocket is a group of GROUP lanes: lane k < 4 owns finlet k and lane 4
the drag link (their lags, read rows and wrenches about the pre-burn CoM);
the 7 point masses' inertia terms and the 12 contact points go to lanes
lane + GROUP j. The 6-float wrench, the 6 inertia entries and the contact's
depth and centroid sums are summed by ``fixedwing_lane.cuh``'s
``__shfl_xor_sync`` butterfly, the deepest point by a max butterfly and
the on/off-pad flags by a ballot; every lane then takes the impulse and
integrates the rigid body itself. No card here, so a Python mirror of the
kernel's thread map, row ownership and butterflies is held to the
conditions the CUDA code relies on, and tied to the sources by the lines
it mirrors: the group and block sizes and the residency they give, the
column -> (block, warp, group, lane) map at the stock, ragged and mid-warp
widths, one store per row and column, the spread of the links, point
masses and contact points, and the butterflies on the twin's per-finlet
wrenches, per-point inertia terms and contact sums.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _lane_layout import butterfly, check_groups, const, csrc_text, stores_per_row, thread_map
from pyflyt_tpu_torch.models import rocket
from pyflyt_tpu_torch.ops import cuda_fixedwing as cf
from pyflyt_tpu_torch.ops import cuda_rocket as cr

SRC = "rocket_step.cu"
WIDTHS = (1, 1000, 8191, 8192)
NUM_LINKS = rocket.NUM_FINLETS + 1  # the finlets and the drag link
EPS = np.finfo(np.float32).eps
SM_COUNT, REGS_PER_SM = 132, 65536  # one H100


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sizes() -> tuple[int, int]:
    return const(SRC, "GROUP"), const(SRC, "THREADS")


def test_group_and_block_sizes():
    group, threads = _sizes()
    assert group & (group - 1) == 0 and 2 <= group and 2 * group <= 32
    assert threads % 32 == 0  # blocks of whole warps: no group straddles two
    assert group >= rocket.NUM_FINLETS  # one finlet a lane: a lane's surface chain is one finlet long
    # the serving width's blocks (8192 envs) all resident at once on one
    # H100, whatever registers ptxas takes under the plain launch bound
    per_sm = -(-(8192 * group // threads) // SM_COUNT)
    assert per_sm * threads * 255 <= REGS_PER_SM


def test_the_mirrored_lines_are_the_sources():
    """The lines the mirrors below copy, as the source writes them."""
    text = csrc_text(SRC)
    for line in (
        "const int tid = blockIdx.x * THREADS + threadIdx.x;",
        "const int i = tid / GROUP, lane = tid % GROUP;",
        "if (i >= n) return;  // ragged edge: whole groups leave",
        "(n * GROUP + THREADS - 1) / THREADS",
        "__global__ void __launch_bounds__(THREADS)\n",
        "const int k = lane + GROUP * j;",
        "if (k < NUM_FINLETS) {",
        "} else if (k < NUM_LINKS) {",
        "if (k < NUM_POINTS) {",
        "const float m = (k == 1) ? fm : sc.pt_mass[k];",
        "if (k < NUM_CONTACT) {",
        "const int row = (k < NUM_FINLETS) ? FLV + 3 * k : DLV;",
        "if (k < NUM_FINLETS) O[(ACT + k) * ld] = s.act[j];",
        "for (int r = TERM + 1; r < PADP; ++r) fl::put<GROUP>(O, ld, lane, r, 0.f);",
        "for (int r = PFLAG; r < ROWS; ++r) fl::put<GROUP>(O, ld, lane, r, 0.f);",
        "x = fmaxf(x, __shfl_xor_sync(mask, x, o));",
        "return (__ballot_sync(mask, p) & mask) != 0u;",
        "pi[k] = fl::group_sum<GROUP>(pi[k], mask);",
        "depth_sum = fl::group_sum<GROUP>(depth_sum, mask);",
        "max_depth = group_max(max_depth, mask);",
        "on_pad_pen = group_any(on_pad_pen, mask);",
    ):
        assert line in text, line
    # the links' partial wrenches go into the butterfly, the boost after it;
    # the point masses' terms into theirs, the dry and fuel-tank diagonal after
    sums = text.index("f[i] = fl::group_sum<GROUP>(f[i], mask);")
    assert text.index("fl::add_surface_wrench(S, &sc.tu[3 * k]") < sums < text.index("for (int i = 0; i < 3; ++i) f[i] += fb[i];")
    assert text.index("pi[k] = fl::group_sum<GROUP>") < text.index("c.i_dry[0] + s.fuel * c.fuel_inertia[0] + pi[0]")
    header = csrc_text("fixedwing_lane.cuh")
    assert "for (int o = 1; o < G; o <<= 1) x += __shfl_xor_sync(mask, x, o);" in header
    assert "if (lane == row % G) O[row * ld] = v;" in header


def row_owner(row: int, group: int) -> int:
    """The lane of a group that writes ``row``: a link's rows its link's
    lane, any other row (held by every lane) row % G."""
    if cr._FLV <= row < cr._FLV + 3 * rocket.NUM_FINLETS:
        return ((row - cr._FLV) // 3) % group
    if cr._DLV <= row < cr._DLV + 3:
        return rocket.NUM_FINLETS % group
    if cr._ACT <= row < cr._ACT + rocket.NUM_FINLETS:
        return (row - cr._ACT) % group
    return row % group


def rows_written(landing: bool) -> list[int]:
    """The rows each entry writes, as the source lists them: store_lane's
    (0-58 but the setpoint), the setpoint and the pad at the start, then
    the landing step's env rows, step count, memos and pad flag, or the
    aviary step's two contact ORs and zeros."""
    rows = [r for r in range(cr._PCON + 1) if not cr._SP <= r < cr._SP + 7]
    rows += list(range(cr._SP, cr._SP + 7)) + list(range(cr._PADP, cr._PADP + 3))
    if landing:
        rows += [cr._STEP, cr._RWD, cr._TERM, cr._TRUNC, cr._FATC, cr._OOB, cr._CPLT, cr._PFLAG]
        rows += [r + k for r in (cr._AV, cr._LV, cr._DIST, cr._PAV, cr._PLV, cr._PDIST) for k in range(3)]
    else:
        rows += [cr._RWD, cr._TERM, *range(cr._TERM + 1, cr._PADP), *range(cr._PFLAG, cr.ROWS)]
    return rows


@pytest.mark.parametrize("landing", [False, True])
def test_each_entry_writes_every_row_once(landing):
    rows = rows_written(landing)
    assert sorted(rows) == list(range(cr.ROWS))


@pytest.mark.parametrize("n", WIDTHS)
def test_every_column_has_one_group_and_every_row_one_store(n):
    group, threads = _sizes()
    m = thread_map(n, group, threads)
    check_groups(m, n, group)
    owners = np.array([row_owner(r, group) for r in range(cr.ROWS)])
    assert (stores_per_row(m, n, group, owners) == 1).all()
    assert m["blocks"] == -(-n * group // threads)


@pytest.mark.parametrize("count", [NUM_LINKS, cr.NUM_POINTS, cr.NUM_CONTACT], ids=["links", "points", "contacts"])
def test_links_points_and_contacts_spread_over_the_lanes(count):
    """Item k on lane k % G: the finlets on distinct lanes; the links, the
    point masses and the contact points as evenly as they go, at most
    ceil(count / G) a lane and at least one on every lane."""
    group, _ = _sizes()
    assert len({k % group for k in range(rocket.NUM_FINLETS)}) == rocket.NUM_FINLETS
    per_lane = np.bincount([k % group for k in range(count)], minlength=group)
    assert per_lane.max() == -(-count // group) and per_lane.min() >= 1


def _consts():
    cfg = rocket.RocketConfig()
    return cr.rocket_consts(rocket.build_params(cfg, "cpu"), cfg)


def _cross(r, f):
    return np.stack([r[1] * f[2] - r[2] * f[1], r[2] * f[0] - r[0] * f[2], r[0] * f[1] - r[1] * f[0]])


def _lanes(parts: list[np.ndarray], group: int) -> np.ndarray:
    """Item k's partial added, in item order, to lane k % G's sum, from 0."""
    lanes = np.zeros((group, *parts[0].shape), np.float32)
    for k, w in enumerate(parts):
        lanes[k % group] = lanes[k % group] + w
    return lanes


def _assert_butterfly(parts: list[np.ndarray], serial: np.ndarray, group: int, base=0.0) -> np.ndarray:
    out = base + butterfly(_lanes(parts, group))
    assert out.dtype == np.float32
    assert (out == out[:1]).all()  # bit-identical in every lane of the group
    scale = np.abs(np.stack(parts)).sum(0) + np.abs(base) + 1.0
    assert (np.abs(out[0] - serial) <= 4 * EPS * scale).all()
    return out[0]


def test_butterfly_sums_the_link_wrench_with_the_same_bits_in_every_lane():
    """The drag link's and the 4 finlets' wrenches (the twin's surface
    model) about a CoM off the base origin, against the twin's order: the
    drag first, then finlets 0-3."""
    group, _ = _sizes()
    c = _consts()
    rng = np.random.default_rng(12)
    n = 4096
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    com = f32(np.array(c.p_dry) / c.m_dry)[:, None] + f32(0.1 * rng.standard_normal((3, n)))
    lv = [f32(np.array([0.0, 0.0, -30.0])[:, None] + 10.0 * rng.standard_normal((3, n))) for _ in range(NUM_LINKS)]
    act = f32(0.5 * rng.standard_normal((rocket.NUM_FINLETS, n)))
    v = lv[rocket.NUM_FINLETS]
    fd = f32(-np.sign(v) * f32(c.drag_const)[:, None] * v * v)
    parts = [None] * NUM_LINKS
    parts[rocket.NUM_FINLETS] = np.concatenate([fd, _cross(f32(c.drag_pos)[:, None] - com, fd)]).astype(np.float32)
    for k in range(rocket.NUM_FINLETS):
        fn, fp, qcm = (t.numpy() for t in cf._surface_plain(c, k, torch.from_numpy(act[k]),
                                                            list(torch.from_numpy(lv[k]).unbind(0))))
        lu, du, tu, pos = (f32(getattr(c, a)[3 * k : 3 * k + 3])[:, None] for a in ("lu", "du", "tu", "spos"))
        fs = fn * lu + fp * du
        parts[k] = np.concatenate([fs, qcm * tu + _cross(pos - com, fs)]).astype(np.float32)
    serial = parts[rocket.NUM_FINLETS].copy()
    for k in range(rocket.NUM_FINLETS):
        serial = serial + parts[k]
    _assert_butterfly(parts, serial, group)


def test_butterfly_sums_the_inertia_with_the_same_bits_in_every_lane():
    """The 7 point masses' terms about the post-burn CoM, the dry and
    fuel-tank diagonal added after the butterfly, against the twin's order
    (the diagonal, then points 0-6); 0 to 100% fuel."""
    group, _ = _sizes()
    c = _consts()
    rng = np.random.default_rng(13)
    n = 4096
    fuel = rng.uniform(0.0, 1.0, n).astype(np.float32)
    fm = fuel * np.float32(c.b_total_fuel)
    inv_mass = np.float32(1.0) / (np.float32(c.m_dry) + fm)
    pt = np.asarray(c.pt_pos, np.float32).reshape(-1, 3)
    com = np.stack([(np.float32(c.p_dry[i]) + fm * pt[1, i]) * inv_mass for i in range(3)])
    parts = []
    for k in range(cr.NUM_POINTS):
        dx, dy, dz = (pt[k, i] - com[i] for i in range(3))
        m = fm if k == 1 else np.float32(c.pt_mass[k])
        parts.append(np.stack([m * (dy * dy + dz * dz), m * (dx * dx + dz * dz), m * (dx * dx + dy * dy),
                               -(m * dx * dy), -(m * dx * dz), -(m * dy * dz)]).astype(np.float32))
    base = np.zeros((6, n), np.float32)
    base[:3] = np.stack([np.float32(c.i_dry[i]) + fuel * np.float32(c.fuel_inertia[i]) for i in range(3)])
    serial = base.copy()
    for w in parts:
        serial = serial + w
    out = _assert_butterfly(parts, serial, group, base)
    assert (np.abs(out[:3] / serial[:3] - 1.0) <= 1e-6).all()


def test_butterfly_sums_the_contact_with_the_same_bits_in_every_lane():
    """The 12 contact points' depth and centroid sums, the deepest point
    (a max butterfly) and the flags (a ballot): the sums within the bound,
    the depth-weighted centroid within 1e-5 m (chip_smoke.py holds the
    position to 2e-4), the max and the flags exact."""
    group, _ = _sizes()
    rng = np.random.default_rng(14)
    n = 4096
    w = rng.uniform(-3.0, 3.0, (cr.NUM_CONTACT, 3, n)).astype(np.float32)
    depth = rng.uniform(-0.05, 0.05, (cr.NUM_CONTACT, n)).astype(np.float32)
    wgt = np.maximum(depth, np.float32(0.0))
    parts = [np.concatenate([wgt[j][None], wgt[j] * w[j]]).astype(np.float32) for j in range(cr.NUM_CONTACT)]
    serial = np.zeros((4, n), np.float32)
    for p in parts:
        serial = serial + p
    out = _assert_butterfly(parts, serial, group)
    hit = serial[0] > 0
    assert (np.abs(out[1:, hit] / out[0, hit] - serial[1:, hit] / serial[0, hit]) <= 1e-5).all()
    lane_max = np.zeros((group, n), np.float32)
    for j in range(cr.NUM_CONTACT):
        lane_max[j % group] = np.maximum(lane_max[j % group], depth[j])
    x, o = lane_max, 1
    while o < group:
        x = np.maximum(x, x[np.arange(group) ^ o])
        o <<= 1
    assert (x == x[:1]).all() and np.array_equal(x[0], np.maximum(depth.max(0), 0.0))
    lane_pen = np.zeros((group, n), bool)
    for j in range(cr.NUM_CONTACT):
        lane_pen[j % group] |= depth[j] > 0
    assert np.array_equal(lane_pen.any(0), (depth > 0).any(0))
