"""OBJ scene loading (port of ``pyflyt_tpu/core/load_objs.py``): the
analogue of the reference's ``loadOBJ`` / ``obj_visual`` /
``obj_collision``.

A mesh is decomposed once at load time, on the host with numpy, into a
static set of boxes: a solid voxelization (surface rasterization and an
outside flood fill) and a greedy box merge, so the box union covers the
mesh volume to voxel resolution and a watertight cube collapses back to
one box. The boxes are the camera's ``Boxes`` (``core/camera.py``).
``resolution`` trades fidelity for the boxes' count. Static scene geometry
only (the reference's ``baseMass=0`` default).

The host code is the JAX module's, copied: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pyflyt_tpu_torch.core.camera import Boxes
from pyflyt_tpu_torch.device import resolve_device


# ---------------------------------------------------------------------------
# OBJ parsing
# ---------------------------------------------------------------------------
def load_obj_mesh(
    file_name: str, mesh_scale=(1.0, 1.0, 1.0)
) -> tuple[np.ndarray, np.ndarray]:
    """Parses a Wavefront OBJ into (vertices (V, 3) f64, faces (F, 3) i64).

    Handles ``v x y z`` and ``f`` records (``a``, ``a/b``, ``a/b/c``,
    ``a//c`` forms; negative indices; polygons fan-triangulated) — the
    subset PyBullet's own OBJ importer consumes for collision shapes.
    """
    scale = np.asarray(mesh_scale, dtype=np.float64)
    if scale.ndim == 0:
        scale = np.full(3, float(scale))
    verts: list[list[float]] = []
    faces: list[tuple[int, int, int]] = []
    with open(file_name) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
    if not verts or not faces:
        raise ValueError(f"no triangles in OBJ file {file_name!r}")
    v = np.asarray(verts, dtype=np.float64) * scale
    return v, np.asarray(faces, dtype=np.int64)


# ---------------------------------------------------------------------------
# solid voxelization + greedy box merge
# ---------------------------------------------------------------------------
def _rasterize_surface(verts, faces, origin, h, dims):
    """Marks every voxel a triangle passes through (point-sampled at ~h/2)."""
    occ = np.zeros(dims, dtype=bool)
    tri = verts[faces]  # (F, 3, 3)
    for a, b, c in tri:
        # sample density from the longest edge
        n = max(
            2,
            int(
                math.ceil(
                    max(
                        np.linalg.norm(b - a),
                        np.linalg.norm(c - a),
                        np.linalg.norm(c - b),
                    )
                    / (0.5 * h)
                )
            )
            + 1,
        )
        u = np.linspace(0.0, 1.0, n)
        uu, vv = np.meshgrid(u, u, indexing="ij")
        mask = uu + vv <= 1.0
        uu, vv = uu[mask], vv[mask]
        pts = (
            a[None, :]
            + uu[:, None] * (b - a)[None, :]
            + vv[:, None] * (c - a)[None, :]
        )
        ijk = np.floor((pts - origin) / h).astype(np.int64)
        np.clip(ijk, 0, np.asarray(dims) - 1, out=ijk)
        occ[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True
    return occ


def _fill_interior(surface: np.ndarray) -> np.ndarray:
    """occupied = surface | (cells unreachable from outside): 6-connected
    flood fill over a 1-voxel padded grid."""
    padded = np.pad(surface, 1)
    outside = np.zeros_like(padded)
    outside[0, 0, 0] = True
    # iterative dilation-style BFS (numpy roll sweeps; grid is small)
    while True:
        grow = outside.copy()
        for axis in range(3):
            for shift in (1, -1):
                grow |= np.roll(outside, shift, axis=axis)
        # rolls wrap around, but wrapped cells land on the padding ring,
        # which is all-outside anyway once the fill reaches it
        grow &= ~padded
        if (grow == outside).all():
            break
        outside = grow
    inside = ~outside[1:-1, 1:-1, 1:-1]
    return surface | inside


def _greedy_merge(occ: np.ndarray) -> list[tuple]:
    """Greedy maximal-box cover of an occupancy grid (x-run, then widen in
    y, then deepen in z). Returns [(i0, j0, k0, di, dj, dk), ...]."""
    todo = occ.copy()
    nx, ny, nz = occ.shape
    out = []
    for i0, j0, k0 in zip(*np.nonzero(todo)):
        if not todo[i0, j0, k0]:
            continue
        di = 1
        while i0 + di < nx and todo[i0 + di, j0, k0]:
            di += 1
        dj = 1
        while j0 + dj < ny and todo[i0 : i0 + di, j0 + dj, k0].all():
            dj += 1
        dk = 1
        while k0 + dk < nz and todo[i0 : i0 + di, j0 : j0 + dj, k0 + dk].all():
            dk += 1
        todo[i0 : i0 + di, j0 : j0 + dj, k0 : k0 + dk] = False
        out.append((int(i0), int(j0), int(k0), di, dj, dk))
    return out


def boxes_from_mesh(
    verts: np.ndarray, faces: np.ndarray, resolution: int = 24
) -> tuple[np.ndarray, np.ndarray]:
    """Solid-voxelizes a triangle mesh and returns the greedy box cover as
    (centers (k, 3), half_extents (k, 3)) in mesh-local coordinates.

    ``resolution`` = voxels along the longest AABB axis. The cover is
    conservative: every point of the mesh volume lies inside some box.
    """
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    extent = hi - lo
    h = float(extent.max()) / resolution
    if h <= 0.0:
        raise ValueError("degenerate mesh (zero extent)")
    # half-voxel pad so boundary triangles don't fall out of the grid
    origin = lo - 0.5 * h
    dims = tuple(int(math.ceil(e / h)) + 1 for e in extent)
    occ = _rasterize_surface(verts, faces, origin, h, dims)
    occ = _fill_interior(occ)
    runs = _greedy_merge(occ)
    centers = np.array(
        [
            origin + h * np.array([i + di / 2.0, j + dj / 2.0, k + dk / 2.0])
            for (i, j, k, di, dj, dk) in runs
        ]
    )
    half = np.array(
        [0.5 * h * np.array([di, dj, dk]) for (_, _, _, di, dj, dk) in runs]
    )
    return centers, half


# ---------------------------------------------------------------------------
# the loadOBJ-shaped entry point
# ---------------------------------------------------------------------------
def _orientation_matrix(base_orientation) -> np.ndarray:
    """Euler (3,) [PyBullet getQuaternionFromEuler convention,
    R = Rz Ry Rx] or quaternion xyzw (4,) -> rotation matrix."""
    o = np.asarray(base_orientation, dtype=np.float64)
    if o.shape == (4,):
        x, y, z, w = o / np.linalg.norm(o)
    elif o.shape == (3,):
        r, p, yw = o
        cr, sr = math.cos(r / 2), math.sin(r / 2)
        cp, sp = math.cos(p / 2), math.sin(p / 2)
        cy, sy = math.cos(yw / 2), math.sin(yw / 2)
        w = cr * cp * cy + sr * sp * sy
        x = sr * cp * cy - cr * sp * sy
        y = cr * sp * cy + sr * cp * sy
        z = cr * cp * sy - sr * sp * cy
    else:
        raise ValueError(f"orientation must be euler (3,) or xyzw (4,), got {o.shape}")
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def loadOBJ(
    file_name: str,
    mesh_scale=(1.0, 1.0, 1.0),
    base_position=(0.0, 0.0, 0.0),
    base_orientation=(0.0, 0.0, 0.0),
    base_mass: float = 0.0,
    color=(0.7, 0.7, 0.7, 1.0),
    resolution: int = 24,
    existing=None,
    device: str | torch.device = "cuda",
) -> Boxes:
    """Loads an OBJ as static scene geometry: ``Boxes`` (f32, one scene for
    any batch) on ``device``.

    Args mirror the reference: ``mesh_scale``, ``base_position``,
    ``base_orientation`` (euler, PyBullet convention, or quaternion xyzw).
    ``base_mass`` must be 0. ``existing`` concatenates onto earlier
    ``Boxes`` (the reference's repeated loadOBJ calls).
    """
    if float(base_mass) != 0.0:
        raise ValueError(
            "dynamic scene bodies are not supported (static scenes only, "
            "the reference's baseMass=0 default); got "
            f"base_mass={base_mass}"
        )
    dev = resolve_device(device)
    verts, faces = load_obj_mesh(file_name, mesh_scale)
    centers_l, half = boxes_from_mesh(verts, faces, resolution)
    R = _orientation_matrix(base_orientation)
    centers = np.asarray(base_position, dtype=np.float64) + centers_l @ R.T
    k = centers.shape[0]
    rotations = np.broadcast_to(R, (k, 3, 3)).copy()
    colors = np.broadcast_to(np.asarray(color, dtype=np.float64), (k, 4)).copy()
    f32 = lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=dev)  # noqa: E731
    boxes = Boxes(
        centers=f32(centers),
        half_extents=f32(half),
        rotations=f32(rotations),
        colors=f32(colors),
        visible=torch.ones((k,), dtype=torch.bool, device=dev),
    )
    if existing is not None:
        boxes = merge_boxes(existing, boxes)
    return boxes


def merge_boxes(*boxes: Boxes) -> Boxes:
    """Concatenates ``Boxes`` sets (a scene composed of several loads)."""
    return Boxes(
        centers=torch.cat([b.centers for b in boxes]),
        half_extents=torch.cat([b.half_extents for b in boxes]),
        rotations=torch.cat([b.rotations for b in boxes]),
        colors=torch.cat([b.colors for b in boxes]),
        visible=torch.cat([b.visible for b in boxes]),
    )


__all__ = [
    "load_obj_mesh",
    "boxes_from_mesh",
    "loadOBJ",
    "merge_boxes",
]
