"""Functional batched PID controller (port of ``pyflyt_tpu/ops/pid.py``):
clipped integral, derivative on error, clipped output."""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor


@dataclasses.dataclass
class PIDParams:
    kp: Tensor
    ki: Tensor
    kd: Tensor
    lim: Tensor
    period: float


@dataclasses.dataclass
class PIDState:
    integral: Tensor
    prev_error: Tensor


def init(params: PIDParams, batch_shape: tuple[int, ...] = ()) -> PIDState:
    """Zero controller state shaped like the gains, plus the batch dims."""
    z = params.kp.new_zeros((*batch_shape, *params.kp.shape))
    return PIDState(integral=z, prev_error=z.clone())


def reset(state: PIDState) -> PIDState:
    return PIDState(
        integral=torch.zeros_like(state.integral),
        prev_error=torch.zeros_like(state.prev_error),
    )


def step(
    state: PIDState, params: PIDParams, measurement: Tensor, setpoint: Tensor
) -> tuple[PIDState, Tensor]:
    """``i' = clip(i + ki e T, ±lim);  out = clip(kp e + i' + kd (e - e_prev)/T, ±lim)``"""
    error = setpoint - measurement
    integral = torch.clamp(
        state.integral + params.ki * error * params.period, -params.lim, params.lim
    )
    derivative = params.kd * (error - state.prev_error) / params.period
    out = torch.clamp(
        params.kp * error + integral + derivative, -params.lim, params.lim
    )
    return PIDState(integral=integral, prev_error=error), out
