"""Python mirrors of the lane groups that the vehicle kernels spread a
vehicle over (``csrc/fixedwing_lane.cuh``, ``csrc/rocket_step.cu``), for
the torch-only layout tests: the sources' text and constants, the map of
every launched thread and the butterfly.
"""

from __future__ import annotations

import re

import numpy as np

from pyflyt_tpu_torch.ops import cuda_build


def csrc_text(name: str) -> str:
    return (cuda_build.CSRC / name).read_text()


def const(name: str, key: str) -> int:
    """``constexpr int <key> = <value>;`` of source ``name``."""
    return int(re.search(rf"constexpr int {key} = (\d+);", csrc_text(name)).group(1))


def thread_map(n: int, group: int, threads: int) -> dict:
    """The kernels' map of every launched thread: block, warp, lane of the
    warp, column (vehicle), lane of the group, group mask."""
    blocks = -(-n * group // threads)
    tid = np.arange(blocks * threads)
    local = tid % threads
    wl = local % 32
    return {"block": tid // threads, "warp": tid // 32, "wl": wl, "col": tid // group, "lane": tid % group,
            "mask": ((1 << group) - 1) << (wl & ~(group - 1)), "blocks": blocks}


def butterfly(lanes: np.ndarray) -> np.ndarray:
    """group_sum on every lane: x += shfl_xor(x, o) for o = 1, 2, ..., G / 2
    (``lanes`` is (G, ...); none at G = 1)."""
    group = lanes.shape[0]
    x, o = lanes.copy(), 1
    while o < group:
        x = x + x[np.arange(group) ^ o]
        o <<= 1
    return x


def check_groups(m: dict, n: int, group: int) -> np.ndarray:
    """Every column has one group of ``group`` lanes in one warp, each
    group's mask is exactly its lanes; returns the live threads."""
    live = m["col"] < n
    cols, counts = np.unique(m["col"][live], return_counts=True)
    assert np.array_equal(cols, np.arange(n)) and (counts == group).all()
    for lane in range(group):
        assert np.array_equal(np.sort(m["col"][live & (m["lane"] == lane)]), np.arange(n))
    warp_of = m["warp"][live].reshape(n, group)
    assert (warp_of == warp_of[:, :1]).all()
    bits = (1 << m["wl"].reshape(-1, group)).sum(1)
    assert (m["mask"].reshape(-1, group) == bits[:, None]).all()
    return live


def stores_per_row(m: dict, n: int, group: int, owners: np.ndarray) -> np.ndarray:
    """(rows, n): how many lanes of each column write each row, when row r
    is written by lane owners[r] of the group."""
    live = m["col"] < n
    stores = np.zeros((owners.size, n), dtype=np.int64)
    for lane in range(group):
        c = m["col"][live & (m["lane"] == lane)]
        stores[np.ix_(owners == lane, c)] += 1
    return stores
