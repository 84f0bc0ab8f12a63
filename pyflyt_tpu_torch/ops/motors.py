"""Propeller motor array: first-order throttle lag and quadratic
thrust/torque (port of ``pyflyt_tpu/ops/motors.py``).

Motor noise draws from an explicit ``torch.Generator`` where the JAX module
takes a PRNG key; the two streams differ, the distribution is the same.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor


@dataclasses.dataclass
class MotorParams:
    """Parameters for n motors; per-motor tensors have shape (n, ...)."""

    positions: Tensor  # (n, 3) body-frame thrust application points
    thrust_unit: Tensor  # (n, 3) unit thrust directions in the body frame
    thrust_coef: Tensor  # (n,)
    torque_coef: Tensor  # (n,) signed
    tau: Tensor  # (n,) first-order ramp time constant
    max_rpm: Tensor  # (n,)
    noise_ratio: Tensor  # (n,)


def throttle_update(
    throttle: Tensor,
    pwm: Tensor,
    params: MotorParams,
    physics_period: float,
    generator: torch.Generator | None = None,
) -> Tensor:
    """First-order lag, then multiplicative Gaussian noise when a generator
    is given (no generator: noise off)."""
    throttle = throttle + (physics_period / params.tau) * (pwm - throttle)
    if generator is not None:
        noise = torch.randn(
            throttle.shape, generator=generator, dtype=throttle.dtype,
            device=throttle.device,
        )
        throttle = throttle + noise * throttle * params.noise_ratio
    return throttle


def wrench(throttle: Tensor, params: MotorParams) -> tuple[Tensor, Tensor]:
    """Body-frame (force, torque) totals: ``rpm = throttle·max_rpm``,
    ``F = rpm²·sign(rpm)·unit·Ct``, ``τ = rpm²·sign(rpm)·unit·Cq`` plus the
    lever-arm torque ``r × F``."""
    rpm = throttle * params.max_rpm
    rpm_const = (rpm * rpm) * torch.sign(rpm)  # (..., n)
    thrust = rpm_const[..., None] * params.thrust_unit * params.thrust_coef[..., None]
    axis_torque = (
        rpm_const[..., None] * params.thrust_unit * params.torque_coef[..., None]
    )
    lever_torque = torch.linalg.cross(params.positions.expand_as(thrust), thrust)
    return torch.sum(thrust, dim=-2), torch.sum(axis_torque + lever_torque, dim=-2)
