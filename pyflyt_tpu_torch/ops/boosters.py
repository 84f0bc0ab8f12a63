"""Fueled booster: ignition latch, throttle floor and lag, fuel burn (port
of ``pyflyt_tpu/ops/boosters.py``).

The op returns the fuel mass and inertia, and the vehicle model rebuilds
its composite mass properties from them every physics step. Booster noise
draws from an explicit ``torch.Generator`` where the JAX module takes a
PRNG key: the streams differ, the distribution is the same.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor


@dataclasses.dataclass
class BoosterParams:
    """Parameters of n boosters; per-booster tensors have shape (n, ...)."""

    positions: Tensor  # (n, 3) body-frame thrust application points
    thrust_unit: Tensor  # (n, 3) unit thrust directions before gimballing
    tau: Tensor  # (n,) throttle ramp time constant
    total_fuel_mass: Tensor  # (n,)
    max_fuel_rate: Tensor  # (n,) kg/s at full throttle
    max_inertia: Tensor  # (n, 3) fuel-tank inertia at full fuel
    min_thrust: Tensor  # (n,)
    max_thrust: Tensor  # (n,)
    reignitable: Tensor  # (n,) bool
    noise_ratio: Tensor  # (n,)

    @property
    def ratio_min_throttle(self) -> Tensor:
        return self.min_thrust / self.max_thrust

    @property
    def ratio_throttleable(self) -> Tensor:
        return 1.0 - self.ratio_min_throttle

    @property
    def ratio_fuel_rate(self) -> Tensor:
        return self.max_fuel_rate / self.total_fuel_mass


@dataclasses.dataclass
class BoosterState:
    ratio_fuel_remaining: Tensor  # (..., n)
    throttle: Tensor  # (..., n)
    ignition_state: Tensor  # (..., n) bool


def init(
    params: BoosterParams,
    batch_shape: tuple[int, ...] = (),
    starting_fuel_ratio: float = 1.0,
    dtype: torch.dtype = torch.float32,
) -> BoosterState:
    """The reset state: ``starting_fuel_ratio`` of the fuel, throttle 0,
    unlit; on the parameters' device."""
    n = params.tau.shape[-1]
    dev = params.tau.device
    return BoosterState(
        ratio_fuel_remaining=torch.full((*batch_shape, n), float(starting_fuel_ratio), dtype=dtype, device=dev),
        throttle=torch.zeros((*batch_shape, n), dtype=dtype, device=dev),
        ignition_state=torch.zeros((*batch_shape, n), dtype=torch.bool, device=dev),
    )


def update(
    state: BoosterState,
    params: BoosterParams,
    ignition: Tensor,
    pwm: Tensor,
    physics_period: float,
    generator: torch.Generator | None = None,
) -> tuple[BoosterState, Tensor, Tensor, Tensor]:
    """One physics step. Returns ``(state, thrust, fuel_mass,
    fuel_inertia)``: thrust ``(..., n)`` magnitudes, fuel mass ``(..., n)``
    and fuel inertia ``(..., n, 3)``. Multiplicative throttle noise when a
    generator is given (no generator: noise off)."""
    # an engine that cannot reignite stays lit once lit
    ignition_state = (~params.reignitable & state.ignition_state) | (ignition > 0.5)
    # the throttle floor when lit, then the first-order lag
    target = ignition_state * (pwm * params.ratio_throttleable + params.ratio_min_throttle)
    throttle = state.throttle + (physics_period / params.tau) * (target - state.throttle)
    if generator is not None:
        noise = torch.randn(throttle.shape, generator=generator, dtype=throttle.dtype, device=throttle.device)
        throttle = throttle + noise * throttle * params.noise_ratio
    throttle = throttle * (state.ratio_fuel_remaining > 0.0)  # no thrust from a dry tank
    fuel = torch.clamp(
        state.ratio_fuel_remaining - throttle * params.ratio_fuel_rate * physics_period, 0.0, 1.0
    )
    new_state = BoosterState(ratio_fuel_remaining=fuel, throttle=throttle, ignition_state=ignition_state)
    return new_state, throttle * params.max_thrust, fuel * params.total_fuel_mass, fuel[..., None] * params.max_inertia


def get_states(state: BoosterState) -> Tensor:
    """``[ignition..., fuel ratio..., throttle...]``."""
    return torch.cat(
        [state.ignition_state.to(state.throttle.dtype), state.ratio_fuel_remaining, state.throttle], dim=-1
    )
