"""Batched lifting-surface aerodynamics, the Khan agile fixed-wing model
(port of ``pyflyt_tpu/ops/lifting_surfaces.py``).

Every surface of every vehicle in the batch in one call, over a stacked
surface axis: the no-stall linear regime and the post-stall flat-plate
model are both computed and one is picked per surface with
``torch.where``. Forces come back as one body-frame wrench about the
vehicle's centre of mass, the lever-arm torque ``(r - r_com) × F``
standing in for a per-link force.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.device import resolve_device

HALF_RHO = 0.5 * 1.225


@dataclasses.dataclass
class SurfaceParams:
    """Static parameters of n stacked lifting surfaces; the derived fields
    (area, aspect, Cl_alpha_3D, aero_tau) are computed in float64 by
    ``build``."""

    positions: Tensor  # (n, 3) body-frame application points
    lift_unit: Tensor  # (n, 3)
    drag_unit: Tensor  # (n, 3) forward/travel direction
    torque_unit: Tensor  # (n, 3) = lift × forward
    chord: Tensor  # (n,)
    span: Tensor  # (n,)
    area: Tensor  # (n,)
    aspect: Tensor  # (n,)
    flap_to_chord: Tensor  # (n,)
    eta: Tensor  # (n,)
    alpha_0_base: Tensor  # (n,) radians
    alpha_stall_P_base: Tensor  # (n,) radians
    alpha_stall_N_base: Tensor  # (n,) radians
    Cl_alpha_3D: Tensor  # (n,)
    Cd_0: Tensor  # (n,)
    deflection_limit: Tensor  # (n,) degrees
    aero_tau: Tensor  # (n,) flap effectiveness
    tau: Tensor  # (n,) actuation ramp time constant


def build(
    surface_dicts: list[dict], dtype: torch.dtype = torch.float32, device: str | torch.device = "cuda"
) -> SurfaceParams:
    """Stacks per-surface dicts (position, lifting_unit, forward_unit and
    the Khan-model coefficients) into ``SurfaceParams`` on ``device``."""
    dev = resolve_device(device)

    def col(key):
        return np.asarray([s[key] for s in surface_dicts], dtype=np.float64)

    lift_unit = col("lifting_unit")
    fwd_unit = col("forward_unit")
    lift_unit = lift_unit / np.linalg.norm(lift_unit, axis=-1, keepdims=True)
    fwd_unit = fwd_unit / np.linalg.norm(fwd_unit, axis=-1, keepdims=True)
    chord = col("chord")
    span = col("span")
    aspect = span / chord
    cl2d = col("Cl_alpha_2D")
    cl3d = cl2d * (aspect / (aspect + ((2.0 * (aspect + 4.0)) / (aspect + 2.0))))
    flap_to_chord = col("flap_to_chord")
    theta_f = np.arccos(2.0 * flap_to_chord - 1.0)
    aero_tau = 1.0 - ((theta_f - np.sin(theta_f)) / np.pi)
    a = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=dev)  # noqa: E731
    return SurfaceParams(
        positions=a(col("position")),
        lift_unit=a(lift_unit),
        drag_unit=a(fwd_unit),
        torque_unit=a(np.cross(lift_unit, fwd_unit)),
        chord=a(chord),
        span=a(span),
        area=a(chord * span),
        aspect=a(aspect),
        flap_to_chord=a(flap_to_chord),
        eta=a(col("eta")),
        alpha_0_base=a(np.deg2rad(col("alpha_0_base"))),
        alpha_stall_P_base=a(np.deg2rad(col("alpha_stall_P_base"))),
        alpha_stall_N_base=a(np.deg2rad(col("alpha_stall_N_base"))),
        Cl_alpha_3D=a(cl3d),
        Cd_0=a(col("Cd_0")),
        deflection_limit=a(col("deflection_limit")),
        aero_tau=a(aero_tau),
        tau=a(col("tau")),
    )


def actuation_update(actuation: Tensor, cmd: Tensor, params: SurfaceParams, physics_period: float) -> Tensor:
    """First-order flap deflection lag."""
    return actuation + (physics_period / params.tau) * (cmd - actuation)


def aoa_freestream(local_velocity: Tensor, params: SurfaceParams) -> tuple[Tensor, Tensor]:
    """Angle of attack and freestream speed from each surface's body-frame
    velocity; the norm is grad-safe at zero airspeed (``safe_norm``)."""
    freestream = pm.safe_norm(local_velocity)
    lifting = torch.sum(local_velocity * params.lift_unit, dim=-1)
    forward = torch.sum(local_velocity * params.drag_unit, dim=-1)
    return torch.atan2(-lifting, forward), freestream


def _interp(x: Tensor, x0, x1, y0, y1) -> Tensor:
    """``np.interp`` over one ``[x0, x1]`` segment, clamped at the edges."""
    t = torch.clamp((x - x0) / (x1 - x0), 0.0, 1.0)
    return y0 + t * (y1 - y0)


def aero_coefficients(alpha: Tensor, actuation: Tensor, params: SurfaceParams) -> tuple[Tensor, Tensor, Tensor]:
    """(Cl, Cd, CM): the no-stall linear regime, or the post-stall
    flat-plate model outside the stall angles."""
    p = params
    deflection = torch.deg2rad(actuation * p.deflection_limit)

    delta_Cl = p.Cl_alpha_3D * p.aero_tau * p.eta * deflection
    delta_Cl_max = p.flap_to_chord * delta_Cl
    Cl_max_P = p.Cl_alpha_3D * (p.alpha_stall_P_base - p.alpha_0_base) + delta_Cl_max
    Cl_max_N = p.Cl_alpha_3D * (p.alpha_stall_N_base - p.alpha_0_base) + delta_Cl_max
    alpha_0 = p.alpha_0_base - (delta_Cl / p.Cl_alpha_3D)
    alpha_stall_P = alpha_0 + (Cl_max_P / p.Cl_alpha_3D)
    alpha_stall_N = alpha_0 + (Cl_max_N / p.Cl_alpha_3D)

    # no-stall linear regime
    Cl_lin = p.Cl_alpha_3D * (alpha - alpha_0)
    alpha_i_lin = Cl_lin / (math.pi * p.aspect)
    ae_lin = alpha - alpha_0 - alpha_i_lin
    CT_lin = p.Cd_0 * torch.cos(ae_lin)
    CN_lin = (Cl_lin + (CT_lin * torch.sin(ae_lin))) / torch.cos(ae_lin)
    Cd_lin = (CN_lin * torch.sin(ae_lin)) + (CT_lin * torch.cos(ae_lin))
    CM_lin = -CN_lin * (0.25 - (0.175 * (1.0 - ((2.0 * ae_lin) / math.pi))))

    # post-stall flat-plate model
    Cl_stall_P = p.Cl_alpha_3D * (alpha_stall_P - alpha_0)
    Cl_stall_N = p.Cl_alpha_3D * (alpha_stall_N - alpha_0)
    ai_stall_P = Cl_stall_P / (math.pi * p.aspect)
    ai_stall_N = Cl_stall_N / (math.pi * p.aspect)
    alpha_i_pos = _interp(alpha, alpha_stall_P, math.pi / 2.0, ai_stall_P, 0.0)
    alpha_i_neg = _interp(alpha, -math.pi / 2.0, alpha_stall_N, 0.0, ai_stall_N)
    alpha_i_stall = torch.where(alpha > 0.0, alpha_i_pos, alpha_i_neg)
    ae_st = alpha - alpha_0 - alpha_i_stall

    Cd_90 = (-4.26e-2 * deflection * deflection) + (2.1e-1 * deflection) + 1.98
    CN_st = (
        Cd_90
        * torch.sin(ae_st)
        * (1.0 / (0.56 + 0.44 * torch.abs(torch.sin(ae_st))) - 0.41 * (1.0 - torch.exp(-17.0 / p.aspect)))
    )
    CT_st = 0.5 * p.Cd_0 * torch.cos(ae_st)
    Cl_st = (CN_st * torch.cos(ae_st)) - (CT_st * torch.sin(ae_st))
    Cd_st = (CN_st * torch.sin(ae_st)) + (CT_st * torch.cos(ae_st))
    CM_st = -CN_st * (0.25 - (0.175 * (1.0 - ((2.0 * torch.abs(ae_st)) / math.pi))))

    no_stall = (alpha_stall_N < alpha) & (alpha < alpha_stall_P)
    Cl = torch.where(no_stall, Cl_lin, Cl_st)
    Cd = torch.where(no_stall, Cd_lin, Cd_st)
    CM = torch.where(no_stall, CM_lin, CM_st)
    return Cl, Cd, CM


def wrench(
    actuation: Tensor, local_velocities: Tensor, params: SurfaceParams, com_offset: Tensor
) -> tuple[Tensor, Tensor]:
    """Total body-frame (force, torque about the CoM) over all surfaces.

    ``actuation`` is ``(..., n)``, ``local_velocities`` ``(..., n, 3)`` (the
    body-frame air-relative velocity at each surface), ``com_offset`` the
    ``(3,)`` or batched ``(..., 3)`` body-frame vector from the base origin
    to the CoM (the rocket's moves with its fuel)."""
    alpha, freestream = aoa_freestream(local_velocities, params)
    Cl, Cd, CM = aero_coefficients(alpha, actuation, params)

    Q_area = HALF_RHO * freestream * freestream * params.area
    lift = Cl * Q_area
    drag = Cd * Q_area
    force_normal = (lift * torch.cos(alpha)) + (drag * torch.sin(alpha))
    force_parallel = (lift * torch.sin(alpha)) - (drag * torch.cos(alpha))

    force = params.lift_unit * force_normal[..., None] + params.drag_unit * force_parallel[..., None]
    torque = (Q_area * CM * params.chord)[..., None] * params.torque_unit
    lever = torch.linalg.cross((params.positions - com_offset[..., None, :]).expand_as(force), force)
    return torch.sum(force, dim=-2), torch.sum(torque + lever, dim=-2)
