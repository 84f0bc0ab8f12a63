"""Fixed-shape waypoint handler (port of
``pyflyt_tpu/envs/utils/waypoints.py``), batched by construction.

Targets live in a fixed ``(N, num_targets, 3)`` buffer with an int32
cursor ``idx`` per env; the remaining targets are the suffix from the
cursor. Where the JAX handler rolls the delta buffer per env, the port
gathers rows ``(arange + idx) % num_targets``.

A lane that has reached every target has ``idx == num_targets``. The JAX
handler's ``take_along_axis`` then reads past the buffer and returns NaN,
which the env's done-freeze throws away; ``torch.gather`` would raise (or
trip a device assert), so the port clamps the index and keeps the same
select: such a lane's distances are finite and equally discarded.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import Tensor

from pyflyt_tpu_torch.core import camera as cam
from pyflyt_tpu_torch.core import math as pm


@dataclasses.dataclass
class WaypointState:
    targets: Tensor  # (N, n, 3) sampled waypoint positions
    yaw_targets: Tensor  # (N, n) sampled yaw targets (zeros if unused)
    idx: Tensor  # (N,) int32 cursor: index of the current target
    old_distance: Tensor  # (N,) previous distance to the current target
    new_distance: Tensor  # (N,) latest distance to the current target
    yaw_error: Tensor  # (N,) |yaw error| to the current target


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """``x[b, idx[b]]`` over the second axis, the index clamped into range
    (see the module note)."""
    i = torch.clamp(idx.to(torch.int64), max=x.shape[1] - 1)
    i = i.reshape(-1, *([1] * (x.dim() - 1))).expand(-1, 1, *x.shape[2:])
    return torch.gather(x, 1, i)[:, 0]


@dataclasses.dataclass(frozen=True)
class WaypointHandler:
    """Static configuration and batched helpers."""

    num_targets: int = 4
    use_yaw_targets: bool = False
    goal_reach_distance: float = 0.2
    goal_reach_angle: float = 0.1
    flight_dome_size: float = 5.0
    min_height: float = 0.1

    @property
    def delta_size(self) -> int:
        return 4 if self.use_yaw_targets else 3

    def reset(
        self, num_envs: int, generator: torch.Generator | None, dtype=torch.float32,
        device: str | torch.device = "cuda",
    ) -> WaypointState:
        """Polar-coordinate target sampling: θ, φ ~ U(0, 2π), dist ~ U(1,
        0.9·dome), z = |d cos φ| floored at ``min_height``; yaw targets ~
        U(−π, π) when used."""
        if generator is None:
            raise ValueError("WaypointHandler.reset needs a torch.Generator")
        shape = (num_envs, self.num_targets)
        u = lambda lo, hi: lo + torch.rand(shape, generator=generator, dtype=dtype, device=device) * (hi - lo)  # noqa: E731
        theta = u(0.0, 2.0 * math.pi)
        phi = u(0.0, 2.0 * math.pi)
        dist = u(1.0, 0.9 * self.flight_dome_size)
        yaw_targets = u(-math.pi, math.pi)
        x = dist * torch.sin(phi) * torch.cos(theta)
        y = dist * torch.sin(phi) * torch.sin(theta)
        z = torch.abs(dist * torch.cos(phi))
        z = torch.where(z > self.min_height, z, self.min_height)
        if not self.use_yaw_targets:
            yaw_targets = torch.zeros_like(yaw_targets)
        zero = torch.zeros(num_envs, dtype=dtype, device=device)
        return WaypointState(
            targets=torch.stack([x, y, z], dim=-1),
            yaw_targets=yaw_targets,
            idx=torch.zeros(num_envs, dtype=torch.int32, device=device),
            old_distance=zero,
            new_distance=zero.clone(),
            yaw_error=zero.clone(),
        )

    def update_distances(
        self, ws: WaypointState, ang_pos: Tensor, lin_pos: Tensor, quat: Tensor
    ) -> tuple[WaypointState, Tensor]:
        """Returns ``(state, deltas)``: ``deltas`` is the full ``(N, n,
        3|4)`` body-frame delta buffer in original target order; the old and
        new distances to the current target and the yaw error are updated."""
        R = pm.quat_to_rotmat(quat)
        # (targets - lin_pos) @ R_body2world == the world->body rotation
        deltas = torch.einsum("bnj,bji->bni", ws.targets - lin_pos[:, None, :], R)
        if self.use_yaw_targets:
            yaw_err = pm.wrap_angle(ws.yaw_targets - ang_pos[:, 2:3])
            deltas = torch.cat([deltas, yaw_err[..., None]], dim=-1)
            yaw_error = torch.abs(_take(yaw_err, ws.idx))
        else:
            yaw_error = ws.yaw_error
        new_distance = torch.linalg.vector_norm(_take(deltas[..., :3], ws.idx), dim=-1)
        ws = dataclasses.replace(
            ws, old_distance=ws.new_distance, new_distance=new_distance, yaw_error=yaw_error
        )
        return ws, deltas

    def remaining_deltas(self, ws: WaypointState, deltas: Tensor) -> Tensor:
        """The remaining targets as a fixed ``(N, n, 3|4)`` array: row k is
        target ``idx + k`` (mod n), rows past the remaining count zeroed."""
        n = deltas.shape[1]
        ar = torch.arange(n, device=deltas.device)
        rows = (ar[None, :] + ws.idx[:, None].to(torch.int64)) % n
        rolled = torch.gather(deltas, 1, rows[..., None].expand(-1, -1, deltas.shape[2]))
        mask = ar[None, :] < (n - ws.idx[:, None])
        return torch.where(mask[..., None], rolled, 0.0)

    def immediate_distance(self, ws: WaypointState, deltas: Tensor) -> Tensor:
        """``norm`` of the current target's full 3/4-dim delta (the yaw
        component included)."""
        return torch.linalg.vector_norm(_take(deltas, ws.idx), dim=-1)

    def progress_to_target(self, ws: WaypointState) -> Tensor:
        return ws.old_distance - ws.new_distance

    def target_reached(self, ws: WaypointState) -> Tensor:
        reached = ws.new_distance < self.goal_reach_distance
        if self.use_yaw_targets:
            reached = reached & (ws.yaw_error < self.goal_reach_angle)
        return reached

    def advance_targets(self, ws: WaypointState) -> WaypointState:
        """Bumps the cursor (the reference pops the list head)."""
        return dataclasses.replace(ws, idx=torch.clamp(ws.idx + 1, max=self.num_targets))

    def num_targets_reached(self, ws: WaypointState) -> Tensor:
        return ws.idx

    def all_targets_reached(self, ws: WaypointState) -> Tensor:
        return ws.idx >= self.num_targets

    def marker_boxes(self, ws: WaypointState) -> cam.Boxes:
        """Waypoint markers for third-person renders: one box a target,
        ``goal_reach_distance / 4`` a side from the centre, coloured (0, 1 −
        i/n, 0, 1) by its index, hidden once passed."""
        n, dt, dev = self.num_targets, ws.targets.dtype, ws.targets.device
        order = torch.arange(n, device=dev)
        green = 1.0 - order.to(dt) / n
        colors = torch.stack([torch.zeros_like(green), green, torch.zeros_like(green), torch.ones_like(green)], dim=-1)
        return cam.Boxes(
            centers=ws.targets,
            half_extents=torch.full((n, 3), self.goal_reach_distance / 4.0, dtype=dt, device=dev),
            rotations=torch.eye(3, dtype=dt, device=dev).expand(n, 3, 3),
            colors=colors,
            visible=order[None, :] >= ws.idx[:, None],
        )
