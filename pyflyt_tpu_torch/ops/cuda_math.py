"""Tensor twins of the per-thread helpers in ``csrc/quadx_math.cuh`` (port
of ``pyflyt_tpu/ops/pallas_math.py``'s quaternion helpers).

Each function works on unpacked "register" values: a list of same-shape
tensors, one per component, as the plain twins of the vehicle kernels
hold a packed state row by row. Native ``atan2``/``asin`` replace the
Mosaic polynomials of the Pallas module.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import Tensor

HALF_PI = math.pi / 2  # the NED yaw offset (quadx_lane.cuh::HALF_PI)


def quat_rotmat(quat: Sequence[Tensor]) -> tuple[Tensor, ...]:
    """[x, y, z, w] → the 9 entries of the body→world matrix, row-major."""
    x, y, z, w = quat
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )


def quat_to_euler(quat: Sequence[Tensor]) -> tuple[Tensor, Tensor, Tensor]:
    """[x, y, z, w] → (roll, pitch, yaw), PyBullet's extraction."""
    x, y, z, w = quat
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def quat_integrate(
    quat: Sequence[Tensor], avel: Sequence[Tensor], dt: float
) -> list[Tensor]:
    """Exact exponential-map step under world angular velocity."""
    x, y, z, w = quat
    thx, thy, thz = avel[0] * dt, avel[1] * dt, avel[2] * dt
    sq = thx * thx + thy * thy + thz * thz
    small = sq < 1e-16
    ang = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = 0.5 * ang
    sinc = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / ang)
    ch = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    dx, dy, dz, dw = thx * sinc, thy * sinc, thz * sinc, ch
    nx = dw * x + dx * w + dy * z - dz * y
    ny = dw * y - dx * z + dy * w + dz * x
    nz = dw * z + dx * y - dy * x + dz * w
    nw = dw * w - dx * x - dy * y - dz * z
    inv = 1.0 / torch.clamp(torch.sqrt(nx * nx + ny * ny + nz * nz + nw * nw), min=1e-12)
    return [nx * inv, ny * inv, nz * inv, nw * inv]
