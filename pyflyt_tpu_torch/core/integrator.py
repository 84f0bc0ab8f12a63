"""Batched 6-DoF semi-implicit Euler integrator with ground contact (port of
``pyflyt_tpu/core/integrator.py``).

Same scheme as the JAX module: velocities first, then positions, at the
physics rate, with the gyroscopic term in the body-frame Euler equations.
Every function takes leading batch dimensions.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.core.state import Body6DoF

GRAVITY = 9.81  # m/s^2, world -z


def _solve3x3(A: Tensor, b: Tensor) -> Tensor:
    """x = A⁻¹ b for batched 3×3 systems via the adjugate."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    inv_det = 1.0 / det
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [
            (c00 * b0 + c01 * b1 + c02 * b2) * inv_det,
            (c10 * b0 + c11 * b1 + c12 * b2) * inv_det,
            (c20 * b0 + c21 * b1 + c22 * b2) * inv_det,
        ],
        dim=-1,
    )


@dataclasses.dataclass
class RigidBodyParams:
    """Inertial parameters: ``inertia`` is a ``(..., 3)`` diagonal, or a full
    ``(..., 3, 3)`` body-frame tensor when ``full_inertia`` is set."""

    mass: Tensor
    inertia: Tensor
    full_inertia: bool = False

    def inertia_diag(self) -> Tensor:
        if self.full_inertia:
            return torch.diagonal(self.inertia, dim1=-2, dim2=-1)
        return self.inertia


def step(
    body: Body6DoF,
    params: RigidBodyParams,
    force_body: Tensor,
    torque_body: Tensor,
    dt: float,
) -> Body6DoF:
    """One semi-implicit Euler step under a body-frame wrench plus gravity.
    (The JAX module's extra world-frame force comes with wind, later.)"""
    mass = torch.as_tensor(params.mass, dtype=body.pos.dtype, device=body.pos.device)
    R = pm.quat_to_rotmat(body.quat)

    force_w = torch.einsum("...ij,...j->...i", R, force_body)
    accel = force_w / mass[..., None]
    accel = accel - body.pos.new_tensor([0.0, 0.0, GRAVITY])
    lin_vel = body.lin_vel + dt * accel

    # body-frame Euler equations: ω̇_b = I⁻¹ (τ_b − ω_b × I ω_b)
    omega_b = torch.einsum("...ji,...j->...i", R, body.ang_vel)  # R^T ω_w
    inertia = params.inertia
    if params.full_inertia:
        I_omega = torch.einsum("...ij,...j->...i", inertia, omega_b)
        gyro = torch.linalg.cross(omega_b, I_omega)
        omega_b_dot = _solve3x3(inertia, torque_body - gyro)
    else:
        gyro = torch.linalg.cross(omega_b, inertia * omega_b)
        omega_b_dot = (torque_body - gyro) / inertia
    omega_b_new = omega_b + dt * omega_b_dot
    ang_vel = torch.einsum("...ij,...j->...i", R, omega_b_new)

    pos = body.pos + dt * lin_vel
    quat = pm.quat_integrate(body.quat, ang_vel, dt)
    return Body6DoF(pos=pos, quat=quat, lin_vel=lin_vel, ang_vel=ang_vel)


# ---------------------------------------------------------------------------
# ground contact
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ContactGeom:
    """Collision sample points of the vehicle in the body frame."""

    points: Tensor  # (n_pts, 3), or (..., n_pts, 3) where the points move (the rocket's CoM)
    friction: float = 0.5
    restitution: float = 0.0


def ground_contact(
    body: Body6DoF,
    params: RigidBodyParams,
    geom: ContactGeom,
    ground_z: float | Tensor = 0.0,
    per_point_iters: int | None = None,
) -> tuple[Body6DoF, Tensor]:
    """Detects and resolves contact of body-frame sample points with the
    ground ``z = ground_z`` (a float, or a ``(..., n_pts)`` height per
    point, as the rocket's landing pad raises it): one normal + friction
    impulse at the depth-weighted centroid of the penetrating points, then
    positional projection. Returns ``(state, contact)``."""
    if per_point_iters is not None:
        raise NotImplementedError(
            "per-point Gauss-Seidel contact: ROADMAP.md, open item 4 "
            "(core/integrator per_point_iters, with the MuJoCo contact traces)"
        )
    R = pm.quat_to_rotmat(body.quat)
    pts_w = body.pos[..., None, :] + torch.einsum("...ij,...nj->...ni", R, geom.points)
    depth = ground_z - pts_w[..., 2]
    contact = torch.any(depth > 0.0, dim=-1)

    w = torch.clamp(depth, min=0.0)
    w_sum = torch.sum(w, dim=-1, keepdim=True)
    w_norm = w / torch.clamp(w_sum, min=1e-12)
    r_w = torch.sum((pts_w - body.pos[..., None, :]) * w_norm[..., None], dim=-2)
    max_depth = torch.amax(depth, dim=-1)

    mass = torch.as_tensor(params.mass, dtype=body.pos.dtype, device=body.pos.device)
    inertia_w_inv = 1.0 / torch.einsum("...ij,...j->...i", R * R, params.inertia_diag())

    v_pt = body.lin_vel + torch.linalg.cross(body.ang_vel, r_w)

    n = body.pos.new_tensor([0.0, 0.0, 1.0]).expand_as(r_w)
    v_n = v_pt[..., 2]
    rxn = torch.linalg.cross(r_w, n)
    k_n = 1.0 / mass + torch.sum(rxn * rxn * inertia_w_inv, dim=-1)
    j_n = torch.clamp(-(1.0 + geom.restitution) * v_n / k_n, min=0.0)
    j_n = torch.where(contact & (v_n < 0.0), j_n, 0.0)
    impulse = j_n[..., None] * n

    v_t = v_pt * body.pos.new_tensor([1.0, 1.0, 0.0])
    v_t_norm = pm.safe_norm(v_t, keepdim=True)
    t_dir = v_t / torch.clamp(v_t_norm, min=1e-9)
    rxt = torch.linalg.cross(r_w, t_dir)
    k_t = 1.0 / mass + torch.sum(rxt * rxt * inertia_w_inv, dim=-1)
    j_t = torch.minimum(v_t_norm[..., 0] / k_t, geom.friction * j_n)
    impulse = impulse - torch.where(contact[..., None], j_t[..., None] * t_dir, 0.0)

    lin_vel = body.lin_vel + impulse / mass[..., None]
    ang_vel = body.ang_vel + torch.linalg.cross(r_w, impulse) * inertia_w_inv

    zero = torch.zeros_like(max_depth)
    lift = torch.stack([zero, zero, torch.clamp(max_depth, min=0.0)], dim=-1)
    pos = body.pos + torch.where(contact[..., None], lift, 0.0)

    lin_vel = torch.where(contact[..., None], lin_vel, body.lin_vel)
    ang_vel = torch.where(contact[..., None], ang_vel, body.ang_vel)
    return Body6DoF(pos=pos, quat=body.quat, lin_vel=lin_vel, ang_vel=ang_vel), contact
