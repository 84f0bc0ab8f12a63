"""Quaternion / Euler / rotation math (port of ``pyflyt_tpu/core/math.py``).

Same conventions as the JAX module: quaternions are ``(x, y, z, w)`` and
rotate body-frame vectors into the world frame; euler angles are
``(roll, pitch, yaw)`` about the fixed world X, Y, Z axes
(``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)``). Every function takes leading
batch dimensions.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from pyflyt_tpu_torch.device import resolve_device


def safe_norm(v: Tensor, dim: int = -1, keepdim: bool = False) -> Tensor:
    """Euclidean norm that is exactly 0 at the origin (NaN-free gradient)."""
    sq = torch.sum(v * v, dim=dim, keepdim=keepdim)
    nonzero = sq > 0.0
    return torch.where(
        nonzero, torch.sqrt(torch.where(nonzero, sq, torch.ones_like(sq))), 0.0
    )


def normalize(v: Tensor, eps: float = 1e-12) -> Tensor:
    """Normalizes the last axis of ``v`` to unit length."""
    return v / torch.clamp(safe_norm(v, keepdim=True), min=eps)


# ---------------------------------------------------------------------------
# quaternion algebra (xyzw)
# ---------------------------------------------------------------------------


def quat_identity(
    batch_shape: tuple[int, ...] = (),
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> Tensor:
    q = torch.zeros((*batch_shape, 4), dtype=dtype, device=resolve_device(device))
    q[..., 3] = 1.0
    return q


def quat_mul(q1: Tensor, q2: Tensor) -> Tensor:
    """Hamilton product ``q1 ⊗ q2`` (rotate by ``q2`` then ``q1``)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q: Tensor) -> Tensor:
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotates ``v`` by ``q`` (body → world), expanded Rodrigues form."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def quat_rotate_inv(q: Tensor, v: Tensor) -> Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_to_rotmat(q: Tensor) -> Tensor:
    """Body→world rotation matrix, shape ``(..., 3, 3)``."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1.0 - 2.0 * (yy + zz),
            2.0 * (xy - wz),
            2.0 * (xz + wy),
            2.0 * (xy + wz),
            1.0 - 2.0 * (xx + zz),
            2.0 * (yz - wx),
            2.0 * (xz - wy),
            2.0 * (yz + wx),
            1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(*q.shape[:-1], 3, 3)


# ---------------------------------------------------------------------------
# euler <-> quaternion (PyBullet fixed-axis XYZ convention)
# ---------------------------------------------------------------------------


def euler_to_quat(rpy: Tensor) -> Tensor:
    half = rpy * 0.5
    cr, cp, cy = torch.cos(half).unbind(-1)
    sr, sp, sy = torch.sin(half).unbind(-1)
    return torch.stack(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ],
        dim=-1,
    )


def quat_to_euler(q: Tensor) -> Tensor:
    """Quaternion → roll-pitch-yaw, PyBullet's extraction."""
    x, y, z, w = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def euler_to_rotmat(rpy: Tensor) -> Tensor:
    return quat_to_rotmat(euler_to_quat(rpy))


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------


def quat_integrate(q: Tensor, omega_world: Tensor, dt: float) -> Tensor:
    """Exact exponential-map step ``q' = exp(ω dt / 2) ⊗ q`` with the Taylor
    branch near ‖ω‖ = 0."""
    theta = omega_world * dt
    sq = torch.sum(theta * theta, dim=-1, keepdim=True)
    small = sq < 1e-16
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = 0.5 * angle
    sinc_half = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angle)
    cos_half = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    dq = torch.cat([theta * sinc_half, cos_half], dim=-1)
    return normalize(quat_mul(dq, q))


def wrap_angle(a: Tensor) -> Tensor:
    """Wraps angle(s) into ``[-pi, pi)``."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


# ---------------------------------------------------------------------------
# orientation-convention remaps (the integrator always runs ENU)
# ---------------------------------------------------------------------------


def enu_pos_to_ned(pos: Tensor) -> Tensor:
    """(x, y, z) → (y, x, -z)."""
    return torch.stack([pos[..., 1], pos[..., 0], -pos[..., 2]], dim=-1)


def ned_pos_to_enu(pos: Tensor) -> Tensor:
    return enu_pos_to_ned(pos)


def flu_vec_to_frd(v: Tensor) -> Tensor:
    """(x, y, z) → (x, -y, -z)."""
    return v * v.new_tensor([1.0, -1.0, -1.0])


def enu_euler_to_ned(rpy: Tensor) -> Tensor:
    """(r, p, y) → (r, -p, pi/2 - y)."""
    return torch.stack(
        [rpy[..., 0], -rpy[..., 1], (math.pi / 2) - rpy[..., 2]], dim=-1
    )


def ned_euler_to_enu(rpy: Tensor) -> Tensor:
    return enu_euler_to_ned(rpy)
