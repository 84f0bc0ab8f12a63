"""Wind-field models (port of ``pyflyt_tpu/core/wind.py``).

A wind field maps ``(physics_step, position)`` to wind velocities in the
world ENU frame the integrator runs in (``models/quadx.step`` calls it
before each physics iteration, with the pre-integration positions).

The fields are dataclasses of tensors, batched by construction: a
``GaussianWind`` holds one base vector per env, ``(N, 3)``, and draws one
``(N, 3)`` gust per call. Random draws come from an explicit
``torch.Generator`` carried in the field, one fresh draw per call, where
the JAX package folds the physics step into a PRNG key: same
resample-per-physics-step semantics and distribution, a different stream
(threefry and Philox give other numbers from one seed). ``physics_step``
is accepted for the protocol and not read.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from pyflyt_tpu_torch.device import resolve_device

# the base-wind draw of the fork's GaussianWind (gaussian_wind.py:17-21)
BASE_LOW = (-7.0, -7.0, -2.0)
BASE_HIGH = (7.0, 7.0, 2.0)


def ned_to_enu(wind: Tensor) -> Tensor:
    """NED components → the ENU frame: x↔y swap, z negated."""
    return torch.stack([wind[..., 1], wind[..., 0], -wind[..., 2]], dim=-1)


def _normal(shape, generator: torch.Generator | None, like: Tensor) -> Tensor:
    if generator is None:
        raise ValueError("a stochastic wind field needs a torch.Generator")
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def _per_env(wind: Tensor, position: Tensor) -> Tensor:
    """An ``(N, 3)`` per-env wind broadcast to the positions: ``(N, 3)``,
    or ``(N, k, 3)`` points an env; a one-env field also fits one
    unbatched ``(3,)`` or ``(k, 3)``."""
    if wind.dim() > position.dim():
        wind = wind.reshape(position.shape[-1:])
    elif wind.dim() < position.dim():
        wind = wind.reshape(wind.shape[:-1] + (1,) * (position.dim() - wind.dim()) + wind.shape[-1:])
    return wind.expand_as(position)


@dataclasses.dataclass
class ConstantWind:
    """Uniform constant wind."""

    velocity: Tensor  # (3,) ENU

    def __call__(self, physics_step: Tensor, position: Tensor) -> Tensor:
        return self.velocity.expand_as(position)


@dataclasses.dataclass
class SimpleWind:
    """Thermal demo field: zero xy wind, ``log(clip(z + 1, 0, ∞)) ·
    strength`` upward, plus a unit normal on every component."""

    generator: torch.Generator | None
    strength: float = 1.0

    def __call__(self, physics_step: Tensor, position: Tensor) -> Tensor:
        height = torch.clamp(position[..., 2] + 1.0, min=0.0)
        thermal = torch.log(torch.clamp(height, min=1e-12)) * self.strength
        thermal = torch.where(height > 0.0, thermal, 0.0)
        wind = torch.zeros_like(position)
        wind[..., 2] = thermal
        return wind + _normal(position.shape, self.generator, position)


@dataclasses.dataclass
class GaussianWind:
    """The fork's wind model: ``base + clip(N(0, 1), ±max_gust)`` per axis,
    resampled every call (every physics step). With
    ``orn_conv="NED_FRD"`` base and gust are NED components and the field
    emits their ENU equivalent."""

    base_wind: Tensor  # (N, 3) in the configured convention
    generator: torch.Generator | None  # gust stream (unused at max_gust=0)
    max_gust: float = 7.0
    orn_conv: str = "ENU_FLU"

    @classmethod
    def init(
        cls,
        generator: torch.Generator | None,
        num_envs: int,
        base_wind: Tensor | None = None,
        max_gust: float = 7.0,
        orn_conv: str = "ENU_FLU",
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ) -> "GaussianWind":
        """One field for ``num_envs`` envs. Each env's base is drawn from
        U([-7, -7, -2], [7, 7, 2]) when ``base_wind`` is not given, else the
        given ``(3,)`` or ``(N, 3)`` base is broadcast to ``(N, 3)``."""
        dev = resolve_device(device)
        if base_wind is None:
            if generator is None:
                raise ValueError("drawing the base wind needs a torch.Generator")
            low = torch.tensor(BASE_LOW, dtype=dtype, device=dev)
            high = torch.tensor(BASE_HIGH, dtype=dtype, device=dev)
            u = torch.rand((num_envs, 3), generator=generator, dtype=dtype, device=dev)
            base = low + u * (high - low)
        else:
            base = torch.as_tensor(base_wind, dtype=dtype, device=dev).expand(num_envs, 3).clone()
        return cls(base_wind=base, generator=generator, max_gust=float(max_gust), orn_conv=orn_conv)

    def base_enu(self) -> Tensor:
        """The ``(N, 3)`` base in the ENU frame (the field's output at zero
        gust)."""
        return ned_to_enu(self.base_wind) if self.orn_conv == "NED_FRD" else self.base_wind

    def __call__(self, physics_step: Tensor, position: Tensor) -> Tensor:
        wind = self.base_wind
        if self.max_gust > 0.0:
            gust = _normal(wind.shape, self.generator, wind)
            wind = wind + torch.clamp(gust, -self.max_gust, self.max_gust)
        if self.orn_conv == "NED_FRD":
            wind = ned_to_enu(wind)
        return _per_env(wind, position)
