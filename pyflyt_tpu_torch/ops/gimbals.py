"""Two-axis servo gimbals: a first-order lag, then the Rodrigues rotations
``R = I + sin(θ)·W + 2 sin²(θ/2)·W²`` about each gimbal's two unit axes,
composed (port of ``pyflyt_tpu/ops/gimbals.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.device import resolve_device


def _skew(units: np.ndarray) -> np.ndarray:
    """(n, 3) axis vectors → (n, 3, 3) skew matrices."""
    w = np.zeros((units.shape[0], 3, 3))
    w[:, 2, 1] = units[:, 0]
    w[:, 1, 2] = -units[:, 0]
    w[:, 0, 2] = units[:, 1]
    w[:, 2, 0] = -units[:, 1]
    w[:, 1, 0] = units[:, 2]
    w[:, 0, 1] = -units[:, 2]
    return w


@dataclasses.dataclass
class GimbalParams:
    w1: Tensor  # (n, 3, 3)
    w2: Tensor  # (n, 3, 3)
    w1_squared: Tensor  # (n, 3, 3)
    w2_squared: Tensor  # (n, 3, 3)
    tau: Tensor  # (n,)
    range_radians: Tensor  # (n, 2)


def build(
    gimbal_unit_1: np.ndarray,
    gimbal_unit_2: np.ndarray,
    gimbal_tau: np.ndarray,
    gimbal_range_degrees: np.ndarray,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> GimbalParams:
    """The axis skews and their squares, computed in float64, on ``device``."""
    dev = resolve_device(device)
    u1 = np.asarray(gimbal_unit_1, dtype=np.float64)
    u2 = np.asarray(gimbal_unit_2, dtype=np.float64)
    u1 = u1 / np.linalg.norm(u1, axis=-1, keepdims=True)
    u2 = u2 / np.linalg.norm(u2, axis=-1, keepdims=True)
    w1, w2 = _skew(u1), _skew(u2)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=dev)  # noqa: E731
    return GimbalParams(
        w1=t(w1), w2=t(w2), w1_squared=t(w1 @ w1), w2_squared=t(w2 @ w2), tau=t(gimbal_tau),
        range_radians=t(np.deg2rad(gimbal_range_degrees)),
    )


def init(params: GimbalParams, batch_shape: tuple[int, ...] = (), dtype: torch.dtype = torch.float32) -> Tensor:
    """The zero gimbal state, ``(..., n, 2)``, on the parameters' device."""
    n = params.tau.shape[-1]
    return torch.zeros((*batch_shape, n, 2), dtype=dtype, device=params.tau.device)


def compute_rotation(
    gimbal_state: Tensor, cmd: Tensor, params: GimbalParams, physics_period: float
) -> tuple[Tensor, Tensor]:
    """The lag toward ``cmd`` (``(..., n, 2)``, clipped to [-1, 1]), then
    the composed axis rotations. Returns ``(new_state, rotation)`` with the
    rotation ``(..., n, 3, 3)``."""
    cmd = torch.clamp(cmd, -1.0, 1.0)
    state = gimbal_state + (physics_period / params.tau[..., None]) * (cmd - gimbal_state)
    angles = state * params.range_radians
    a1 = angles[..., 0, None, None]
    a2 = angles[..., 1, None, None]
    eye = torch.eye(3, dtype=state.dtype, device=state.device)
    r1 = eye + torch.sin(a1) * params.w1 + 2.0 * torch.sin(a1 / 2.0) ** 2 * params.w1_squared
    r2 = eye + torch.sin(a2) * params.w2 + 2.0 * torch.sin(a2 / 2.0) ** 2 * params.w2_squared
    return state, r1 @ r2
