"""The render's tolerance, shared by the port's vision tests: images of
the same scene from the JAX package and the port may differ only where an
f32 rounding of a ray flips a pixel across an edge."""

import numpy as np

EDGE_SHARE = 0.005  # of the pixels


def _label(rgba, seg):
    """One int64 label a pixel: its segment and its four bytes."""
    packed = rgba.astype(np.int64) @ np.array([1 << 24, 1 << 16, 1 << 8, 1], dtype=np.int64)
    return (seg.astype(np.int64) + 2) << 32 | packed


def assert_edge_flips_only(j_rgba, t_rgba, j_seg=None, t_seg=None, share=EDGE_SHARE):
    """At most ``share`` of the pixels differ (bytes or segment), and every
    differing pixel has a JAX 8-neighbour with another label."""
    j_seg = np.zeros(j_rgba.shape[:-1], np.int32) if j_seg is None else j_seg
    t_seg = np.zeros(t_rgba.shape[:-1], np.int32) if t_seg is None else t_seg
    lab_j, lab_t = _label(j_rgba, j_seg), _label(t_rgba, t_seg)
    diff = lab_j != lab_t
    assert diff.mean() <= share, f"{diff.mean():.4f} of the pixels differ"
    lead = lab_j.ndim - 2
    padded = np.pad(lab_j, [(0, 0)] * lead + [(1, 1), (1, 1)], mode="edge")
    h, w = lab_j.shape[-2:]
    edge = np.zeros_like(diff)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            edge |= padded[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] != lab_j
    assert not (diff & ~edge).any(), f"{int((diff & ~edge).sum())} differing pixels away from any edge"
    return int(diff.sum())
