"""Ray-cast camera (port of ``pyflyt_tpu/core/camera.py``), batched over
envs: a link-attached FPV, gimbal or tracking camera over a ground plane
with a 1 m checkerboard and oriented boxes (race gates, pads, markers),
rendered by ray-box slab tests.

Shapes carry the env batch in front: an eye ``(B, 3)``, rays ``(B, H, W,
3)``, images ``(B, H, W[, 4])``. A ``Boxes`` field may hold one scene for
the whole batch (``centers (n, 3)``) or one per env (``(B, n, 3)``); the
renderer broadcasts the first to the second.

The JAX module slab-tests every ray against every box at once, an
``(H, W, n, 3)`` tensor an env; the port loops over the ``n`` boxes (a
small, static count) and carries the nearest hit, so no tensor has a box
axis and the peak is a few ``(B, H, W, 3)`` tensors. A box replaces the
running hit only on a strict ``<``, which is the JAX module's ``argmin``
(first index on ties) followed by its strict test against the ground.
Colours are a per-env palette (sky, two ground shades, the boxes'
colours) cast to bytes once and gathered by each pixel's index: the same
truncating cast of ``clip(rgba) * 255`` as the JAX module's, on the same
f32 values.

View and projection follow the reference camera (vertical FOV in degrees,
near 0.1 / far 255): FPV pitches the view by ``camera_angle_degrees``, the
gimbal locks roll and pitches down by it; depth is the OpenGL-style
z-buffer value over eye-space z when the view axis is given;
segmentation is −1 for the sky, 0 for the ground and 1 + i for box i.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import Tensor

from pyflyt_tpu_torch.core import math as pm

NEAR, FAR = 0.1, 255.0
SKY_RGBA = (178, 204, 255, 255)
GROUND_A = (153, 153, 153, 255)
GROUND_B = (102, 102, 102, 255)
_TINY = 1e-9  # |d| below this becomes +1e-9 (the JAX module's where, negatives included)


@dataclasses.dataclass
class Boxes:
    """Oriented boxes: the renderable scene objects, one scene for the
    batch (``(n, ...)``) or one per env (``(B, n, ...)``).

    ``rot_index`` (one ``(n,)`` index for the batch, or None) shares
    rotations: ``rotations`` then holds ``r`` unique ones and box i uses
    ``rotations[..., rot_index[i], :, :]``; the renderer rotates the rays
    once per unique rotation. ``hole_half`` (``(..., n, 2)`` or None) gives
    a rectangular through-hole along each box's x axis by its local (y, z)
    half-extents; a box renders as the exact difference outer box minus
    hole prism, and entries ``<= 0`` are solid."""

    centers: Tensor  # (..., n, 3)
    half_extents: Tensor  # (..., n, 3)
    rotations: Tensor  # (..., n, 3, 3) box->world, or (..., r, 3, 3) with rot_index
    colors: Tensor  # (..., n, 4) RGBA in [0, 1]
    visible: Tensor  # (..., n) bool
    rot_index: Tensor | None = None  # (n,) int
    hole_half: Tensor | None = None  # (..., n, 2)

    @property
    def count(self) -> int:
        return self.centers.shape[-2]


def _view_euler(euler: Tensor, camera_angle_degrees: float, use_gimbal: bool) -> Tensor:
    """FPV tilts the view by ``camera_angle_degrees`` about the body pitch
    axis; the gimbal locks roll and pitches down by the same angle."""
    tilt = math.radians(camera_angle_degrees)
    if use_gimbal:
        return torch.stack(
            [torch.zeros_like(euler[..., 0]), torch.full_like(euler[..., 1], -tilt), euler[..., 2]], dim=-1
        )
    return torch.stack([euler[..., 0], euler[..., 1] + tilt, euler[..., 2]], dim=-1)


def _frustum_rays(
    forward: Tensor, left: Tensor, up: Tensor, resolution: tuple[int, int], fov_degrees: float
) -> Tensor:
    """``(..., H, W, 3)`` unit ray directions through the image plane of
    an orthonormal FLU camera basis ``(..., 3)`` each."""
    h, w = resolution
    dt, dev = forward.dtype, forward.device
    tan_half = torch.tan(torch.tensor(math.radians(fov_degrees) / 2.0, dtype=dt))
    v = (torch.linspace(1.0, -1.0, h, dtype=dt) * tan_half).to(dev)
    u = (torch.linspace(1.0, -1.0, w, dtype=dt) * tan_half * (w / h)).to(dev)  # +u = left
    dirs = (
        forward[..., None, None, :]
        + u[:, None] * left[..., None, None, :]
        + v[:, None, None] * up[..., None, None, :]
    )
    return dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)


def camera_rays(
    position: Tensor,
    euler: Tensor,
    resolution: tuple[int, int],
    fov_degrees: float,
    camera_angle_degrees: float = 0.0,
    use_gimbal: bool = False,
) -> tuple[Tensor, Tensor]:
    """``(origin (B, 3), directions (B, H, W, 3))`` of the drone-mounted
    camera."""
    R = pm.euler_to_rotmat(_view_euler(euler, camera_angle_degrees, use_gimbal))
    dirs = _frustum_rays(R[..., :, 0], R[..., :, 1], R[..., :, 2], resolution, fov_degrees)
    return position, dirs


def camera_rays_tracking(
    eye: Tensor, target: Tensor, up_hint: Tensor, resolution: tuple[int, int], fov_degrees: float
) -> tuple[Tensor, Tensor]:
    """Look-at rays: the view aims from ``eye`` at ``target`` (the vehicle
    body), its roll set by ``up_hint``."""
    norm = lambda x: torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-9)  # noqa: E731
    f = target - eye
    f = f / norm(f)
    left = torch.linalg.cross(up_hint, f, dim=-1)
    left = left / norm(left)
    up = torch.linalg.cross(f, left, dim=-1)
    return eye, _frustum_rays(f, left, up, resolution, fov_degrees)


def _batched(x: Tensor | None, batch: int, rank: int) -> Tensor | None:
    """``x`` with a leading batch axis (a view where the scene is shared)."""
    if x is None or x.dim() > rank:
        return x
    return x.expand(batch, *x.shape)


def _box_frame_inv(dirs: Tensor, R: Tensor) -> Tensor:
    """``1 / d`` for the rays ``(B, P, 3)`` rotated into the frame of the
    rotations ``R`` ``(B, 3, 3)`` (box -> world): ``d = R^T dir``."""
    d = torch.bmm(dirs, R)
    d = torch.where(torch.abs(d) < _TINY, _TINY, d)
    return 1.0 / d


def _ray_box(o: Tensor, inv: Tensor, half: Tensor, visible: Tensor, hole: Tensor | None) -> tuple[Tensor, Tensor]:
    """Slab test of one box for every ray of every env.

    ``o`` ``(B, 3)`` is the eye in the box frame, ``inv`` ``(B, P, 3)`` the
    reciprocal ray directions there, ``half`` ``(B, 3)``, ``visible``
    ``(B,)``, ``hole`` ``(B, 2)`` or None. Returns ``(t, hit)``, each
    ``(B, P)``, ``t`` infinite where nothing is hit."""
    t1 = (-half - o)[:, None, :] * inv
    t2 = (half - o)[:, None, :] * inv
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    vis = visible[:, None]
    if hole is None:
        hit = (tmax >= torch.clamp_min(tmin, NEAR)) & vis & (tmin < FAR)
        t = torch.where(tmin > NEAR, tmin, tmax)
        return torch.where(hit, t, math.inf), hit
    # the ray's solid span [tmin, tmax] less the open interval (h_lo, h_hi)
    # where it runs inside the through-hole prism (a 2D slab test on the
    # same reciprocals); each remaining sub-interval resolved as a solid
    # box is, nearest first
    h1 = (-hole - o[:, 1:])[:, None, :] * inv[..., 1:]
    h2 = (hole - o[:, 1:])[:, None, :] * inv[..., 1:]
    h_lo = torch.amax(torch.minimum(h1, h2), dim=-1)
    h_hi = torch.amin(torch.maximum(h1, h2), dim=-1)
    no_hole = torch.all(hole <= 0.0, dim=-1)[:, None]
    h_lo = torch.where(no_hole, math.inf, h_lo)
    h_hi = torch.where(no_hole, -math.inf, h_hi)
    ta, tb = tmin, torch.minimum(tmax, h_lo)  # the front solid sub-interval
    ua, ub = torch.maximum(tmin, h_hi), tmax  # the back one
    va = (tb >= torch.clamp_min(ta, NEAR)) & (ta < FAR)
    vb = (ub >= torch.clamp_min(ua, NEAR)) & (ua < FAR)
    t_a = torch.where(ta > NEAR, ta, tb)
    t_b = torch.where(ua > NEAR, ua, ub)
    hit = (va | vb) & vis
    t = torch.where(va, t_a, t_b)
    return torch.where(hit, t, math.inf), hit


def _rgba(values, dtype, device) -> Tensor:
    return torch.tensor(values, dtype=dtype, device=device) / 255.0


def render(
    origin: Tensor,
    dirs: Tensor,
    boxes: Boxes | None = None,
    ground_z: float = 0.0,
    forward: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Renders ``(rgba uint8 (B, H, W, 4), depth (B, H, W), seg int32 (B,
    H, W))`` for eyes ``origin`` ``(B, 3)`` and rays ``dirs`` ``(B, H, W,
    3)``.

    ``forward`` ``(B, 3)``, the view axis: when given, depth is over
    eye-space z (``t · (dir · forward)``), as an OpenGL rasterizer's is;
    without it, over the ray length."""
    bsz, h, w = dirs.shape[:3]
    dt, dev = dirs.dtype, dirs.device
    flat = dirs.reshape(bsz, h * w, 3)
    ox, oy, oz = (origin[:, k, None] for k in range(3))

    # the ground plane with a 1 m checkerboard
    dz = flat[..., 2]
    dz = torch.where(torch.abs(dz) < _TINY, _TINY, dz)
    t_g = (ground_z - oz) / dz
    hit_g = (t_g > NEAR) & (t_g < FAR)
    gx = ox + t_g * flat[..., 0]
    gy = oy + t_g * flat[..., 1]
    checker = torch.remainder(torch.floor(gx) + torch.floor(gy), 2.0) < 1.0
    t_best = torch.where(hit_g, t_g, math.inf)
    seg = torch.where(hit_g, 0, -1).to(torch.int32)

    n = 0 if boxes is None else boxes.count
    if n:
        centers = _batched(boxes.centers, bsz, 2)
        half = _batched(boxes.half_extents, bsz, 2)
        rots = _batched(boxes.rotations, bsz, 3)
        visible = _batched(boxes.visible, bsz, 1)
        holes = _batched(boxes.hole_half, bsz, 2)
        rot_of = list(range(n)) if boxes.rot_index is None else [int(i) for i in boxes.rot_index.tolist()]
        shared = boxes.rot_index is not None
        inv_of: dict[int, Tensor] = {}
        for i in range(n):
            r = rot_of[i]
            R = rots[:, r]
            if r not in inv_of:
                inv = _box_frame_inv(flat, R)
                if not shared:
                    inv_of.clear()  # a rotation of its own: never read again
                inv_of[r] = inv
            o = torch.bmm((origin - centers[:, i])[:, None, :], R)[:, 0]  # R^T (eye - center)
            t, hit = _ray_box(o, inv_of[r], half[:, i], visible[:, i], None if holes is None else holes[:, i])
            better = hit & (t < t_best)
            t_best = torch.where(better, t, t_best)
            seg = torch.where(better, i + 1, seg)
        inv_of.clear()

    # the palette: sky, the two ground shades, the boxes' colours, each
    # cast to bytes as the JAX module casts a pixel
    pal = [_rgba(c, dt, dev).expand(bsz, 1, 4) for c in (SKY_RGBA, GROUND_A, GROUND_B)]
    if n:
        pal.append(_batched(boxes.colors, bsz, 2).to(dt))
    pal = (torch.clamp(torch.cat(pal, dim=1), 0.0, 1.0) * 255.0).to(torch.uint8)
    ground = torch.where(checker, 1, 2)
    pick = torch.where(seg > 0, seg.to(torch.int64) + 2, torch.where(seg == 0, ground, 0))
    rgba = torch.gather(pal, 1, pick[..., None].expand(-1, -1, 4))

    # OpenGL-style nonlinear z-buffer over eye-space z when the view axis is known
    z_best = t_best
    if forward is not None:
        z_best = t_best * torch.sum(flat * forward[:, None, :], dim=-1)
    z_clip = torch.clamp(z_best, NEAR, FAR)
    depth = (FAR / (FAR - NEAR)) * (1.0 - NEAR / z_clip)
    depth = torch.where(torch.isinf(t_best), 1.0, depth)
    return rgba.reshape(bsz, h, w, 4), depth.reshape(bsz, h, w), seg.reshape(bsz, h, w)


def capture_image(
    position: Tensor,
    euler: Tensor,
    boxes: Boxes | None,
    resolution: tuple[int, int] = (128, 128),
    fov_degrees: float = 90.0,
    camera_angle_degrees: float = 0.0,
    use_gimbal: bool = False,
    position_offset: Tensor | None = None,
    is_tracking: bool = False,
    cinematic: bool = False,
) -> tuple[Tensor, Tensor, Tensor]:
    """The camera's ``(rgba, depth, seg)`` for links at ``position`` ``(B,
    3)`` with attitude ``euler`` ``(B, 3)``.

    ``position_offset`` (``(3,)`` or ``(B, 3)``) moves the eye by the
    link-frame offset rotated into the world (by the transpose when
    ``cinematic``); ``is_tracking`` aims the view at the link position
    instead of out along the view axis (the gimbal then only shapes the
    up vector)."""
    eye = position
    if position_offset is not None:
        R_link = pm.euler_to_rotmat(euler)
        R_off = R_link.transpose(-1, -2) if cinematic else R_link
        off = torch.as_tensor(position_offset, dtype=position.dtype, device=position.device)
        eye = position + torch.einsum("bij,bj->bi", R_off, off.expand_as(position))
    if is_tracking:
        R_view = pm.euler_to_rotmat(_view_euler(euler, camera_angle_degrees, use_gimbal))
        origin, dirs = camera_rays_tracking(eye, position, R_view[..., :, 2], resolution, fov_degrees)
    else:
        origin, dirs = camera_rays(eye, euler, resolution, fov_degrees, camera_angle_degrees, use_gimbal)
    # the view axis: the central ray, normalized
    h, w = dirs.shape[-3:-1]
    forward = dirs[:, h // 2, w // 2]
    forward = forward / torch.linalg.vector_norm(forward, dim=-1, keepdim=True)
    return render(origin, dirs, boxes, forward=forward)


def materialize_rotations(boxes: Boxes) -> Boxes:
    """One rotation per box, ``rot_index`` dropped, so that any two
    ``Boxes`` concatenate."""
    if boxes.rot_index is None:
        return boxes
    idx = boxes.rot_index.to(device=boxes.rotations.device, dtype=torch.int64)
    return dataclasses.replace(boxes, rotations=boxes.rotations.index_select(-3, idx), rot_index=None)


def concat_boxes(*all_boxes: Boxes) -> Boxes:
    """One scene of several ``Boxes`` (rotations materialized first; a
    scene shared by the batch is broadcast where another is per env;
    boxes without a hole get a zero, solid ``hole_half``)."""
    mats = [materialize_rotations(b) for b in all_boxes]
    per_env = [b.centers.shape[0] for b in mats if b.centers.dim() == 3]
    if per_env:
        bsz = per_env[0]
        mats = [
            dataclasses.replace(
                b, centers=_batched(b.centers, bsz, 2), half_extents=_batched(b.half_extents, bsz, 2),
                rotations=_batched(b.rotations, bsz, 3), colors=_batched(b.colors, bsz, 2),
                visible=_batched(b.visible, bsz, 1), hole_half=_batched(b.hole_half, bsz, 2),
            )
            for b in mats
        ]
    cat = lambda xs: torch.cat(xs, dim=-2)  # noqa: E731
    hole = None
    if any(b.hole_half is not None for b in mats):
        hole = cat([b.hole_half if b.hole_half is not None else b.centers.new_zeros(*b.centers.shape[:-1], 2)
                    for b in mats])
    return Boxes(
        centers=cat([b.centers for b in mats]),
        half_extents=cat([b.half_extents for b in mats]),
        rotations=torch.cat([b.rotations for b in mats], dim=-3),
        colors=cat([b.colors for b in mats]),
        visible=torch.cat([b.visible for b in mats], dim=-1),
        rot_index=None,
        hole_half=hole,
    )


def gate_boxes(gate_positions: Tensor, gate_eulers: Tensor, colors: Tensor) -> Boxes:
    """The race gate frame as one holed box a gate: the 0.05 × 0.5 × 0.5
    outer box less the 0.4 × 0.4 through-hole, exactly the union of the
    frame's four bars (``gate_boxes_segments``).

    ``gate_positions``, ``gate_eulers`` ``(..., g, 3)``, ``colors`` ``(...,
    g, 4)``."""
    shape, dt, dev = gate_positions.shape[:-1], gate_positions.dtype, gate_positions.device
    return Boxes(
        centers=gate_positions,
        half_extents=torch.tensor([0.025, 0.25, 0.25], dtype=dt, device=dev).expand(*shape, 3),
        rotations=pm.euler_to_rotmat(gate_eulers),
        colors=colors,
        visible=torch.ones(shape, dtype=torch.bool, device=dev),
        hole_half=torch.tensor([0.2, 0.2], dtype=dt, device=dev).expand(*shape, 2),
    )


_SEG_OFFSETS = ((0.0, 0.0, -0.225), (0.0, 0.0, 0.225), (0.0, -0.225, 0.0), (0.0, 0.225, 0.0))
_SEG_HALVES = ((0.025, 0.25, 0.025), (0.025, 0.25, 0.025), (0.025, 0.025, 0.2), (0.025, 0.025, 0.2))


def gate_boxes_segments(gate_positions: Tensor, gate_eulers: Tensor, colors: Tensor) -> Boxes:
    """The race gate's four frame bars as plain boxes (race_gate.urdf:
    bottom/top 0.05 × 0.5 × 0.05 at z ∓ 0.225, left/right 0.05 × 0.05 ×
    0.4 at y ∓ 0.225), the four of a gate sharing its rotation through
    ``rot_index``: the ground truth ``gate_boxes`` is held to."""
    dt, dev = gate_positions.dtype, gate_positions.device
    lead, g = gate_positions.shape[:-2], gate_positions.shape[-2]
    offsets = torch.tensor(_SEG_OFFSETS, dtype=dt, device=dev)
    R = pm.euler_to_rotmat(gate_eulers)  # (..., g, 3, 3)
    centers = gate_positions[..., :, None, :] + torch.einsum("...gij,sj->...gsi", R, offsets)
    return Boxes(
        centers=centers.reshape(*lead, g * 4, 3),
        half_extents=torch.tensor(_SEG_HALVES, dtype=dt, device=dev).repeat(g, 1).expand(*lead, g * 4, 3),
        rotations=R,
        colors=torch.repeat_interleave(colors, 4, dim=-2),
        visible=torch.ones((*lead, g * 4), dtype=torch.bool, device=dev),
        rot_index=torch.repeat_interleave(torch.arange(g, dtype=torch.int32), 4),
    )
