"""Quadratic drag bodies, "boring bodies" (port of
``pyflyt_tpu/ops/boring_bodies.py``).

``F = -sign(v_local) · ½ρ·Cd·A · v_local²`` per body-frame axis, where
``v_local`` is the body-frame air-relative velocity of each drag body; the
torque is ``Σ r × F`` over the bodies' positions. The vehicle models keep
their drag inlined, as the JAX models do, and do not call this module.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor


@dataclasses.dataclass
class BoringBodyParams:
    positions: Tensor  # (n, 3) body-frame positions of the drag bodies
    drag_const: Tensor  # (n, 3) = ½ · 1.225 · Cd · A per axis


def drag_wrench(local_velocities: Tensor, params: BoringBodyParams) -> tuple[Tensor, Tensor]:
    """Body-frame ``(force, torque)`` from the ``(..., n, 3)`` body-frame
    air-relative velocity of each drag body."""
    forces = -torch.sign(local_velocities) * params.drag_const * local_velocities**2
    torque = torch.linalg.cross(params.positions.expand_as(forces), forces, dim=-1)
    return torch.sum(forces, dim=-2), torch.sum(torque, dim=-2)
