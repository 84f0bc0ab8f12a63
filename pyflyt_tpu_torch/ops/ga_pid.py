"""Gain-scheduled state-feedback controller, QuadX mode 10 (port of
``pyflyt_tpu/ops/ga_pid.py``).

``u = -K[q] (x - x_ss) + u_ss`` with ``K[q]`` one of four 4 x 12 gain
matrices picked by the yaw quadrant ``q``, the output reordered to RPYT.
Stateless. The gains were tuned for the NED_FRD convention.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.core.math import wrap_angle

_USS = np.array([0.365, 0.0, 0.0, 0.0], dtype=np.float32)

# gain matrices over the state ordering [lin_pos(3), ang_pos(3), lin_vel(3),
# ang_vel(3)]; rows [thrust, roll, pitch, yaw]; indexed by yaw quadrant
_K = np.zeros((4, 4, 12), dtype=np.float32)
for _i in range(4):  # the rows common to every quadrant
    _K[_i, 0, 2] = -0.05
    _K[_i, 0, 8] = -0.08
    _K[_i, 1, 3] = 0.2
    _K[_i, 1, 7] = 0.04
    _K[_i, 1, 9] = 0.01
    _K[_i, 2, 4] = 0.2
    _K[_i, 2, 6] = -0.04
    _K[_i, 2, 10] = 0.01
    _K[_i, 3, 5] = 0.07
    _K[_i, 3, 11] = 0.08
# the quadrant-dependent coupling of the position error into roll and pitch
_K[0, 1, 1] = 0.02  # quadrant 0: yaw in [-45, 45] deg
_K[0, 2, 0] = -0.02
_K[1, 1, 0] = -0.02  # quadrant 1: yaw in (45, 135]
_K[1, 2, 1] = -0.02
_K[2, 1, 0] = 0.02  # quadrant 2: yaw in [-135, -45)
_K[2, 2, 1] = 0.02
_K[3, 1, 1] = -0.02  # quadrant 3: |yaw| > 135
_K[3, 2, 0] = 0.02

_QUARTER = 0.785398  # ~45 deg: the reference's constant, not pi / 4


@functools.cache
def _consts(device: torch.device, dtype: torch.dtype) -> tuple[Tensor, Tensor]:
    """``(K (4, 4, 12), u_ss (4,))`` on ``device`` in ``dtype``, built once."""
    return torch.as_tensor(_K, dtype=dtype, device=device), torch.as_tensor(_USS, dtype=dtype, device=device)


def yaw_quadrant(yaw: Tensor) -> Tensor:
    """The gain index of a wrapped yaw: the reference's ``where`` chain,
    closed at ±_QUARTER for quadrant 0 and at +3·_QUARTER and -3·_QUARTER
    for quadrants 1 and 2."""
    q = torch.tensor(_QUARTER, dtype=yaw.dtype, device=yaw.device)
    return torch.where(
        (yaw >= -q) & (yaw <= q),
        0,
        torch.where((yaw > q) & (yaw <= 3 * q), 1, torch.where((yaw < -q) & (yaw >= -3 * q), 2, 3)),
    )


def ga_pid_step(state: Tensor, setpoint: Tensor) -> Tensor:
    """The RPYT command from the drone state and an ``[x, y, psi, z]``
    setpoint.

    Args:
        state: (..., 4, 3) drone state [ang_vel, ang_pos, lin_vel, lin_pos].
        setpoint: (..., 4) [x, y, psi, z] target.

    Returns:
        (..., 4) RPYT command for the motor mixer.
    """
    k_all, u_ss = _consts(state.device, state.dtype)
    ang_pos = wrap_angle(state[..., 1, :])
    x = torch.cat([state[..., 3, :], ang_pos, state[..., 2, :], state[..., 0, :]], dim=-1)
    # x_ss holds [x, y, z] at rows 0-2 and the wrapped psi at row 5
    zero = torch.zeros_like(setpoint[..., 0])
    x_ss = torch.stack(
        [setpoint[..., 0], setpoint[..., 1], setpoint[..., 3], zero, zero, wrap_angle(setpoint[..., 2])]
        + [zero] * 6,
        dim=-1,
    )
    k = k_all[yaw_quadrant(ang_pos[..., 2])]  # (..., 4, 12)
    out = -torch.einsum("...ij,...j->...i", k, x - x_ss) + u_ss
    return torch.stack([out[..., 1], out[..., 2], out[..., 3], out[..., 0]], dim=-1)
