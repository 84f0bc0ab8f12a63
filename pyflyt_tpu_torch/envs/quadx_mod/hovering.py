"""The fork's modified QuadX Hovering env, its RL training workhorse (port
of ``pyflyt_tpu/envs/quadx_mod/hovering.py``), batched by construction.

Departures from the stock hover env that the fork introduced, all kept:

- the agent acts at the drone's ``control_hz``: exactly one aviary step
  per env step, no inner loop;
- observations have physical bounds and are optionally normalized to
  [−1, 1]; actions optionally likewise;
- the observation (16): [lin_pos, lin_vel, ang_pos (wrapped), ang_vel,
  lin_pos_error, psi_error], rounded to 3 decimals;
- reward ``35 − α·‖pos_err‖ − β·‖vel‖ − γ·|psi_err| − δ·‖ω‖`` (defaults
  α=2, β=0.1, γ=4, δ=0.1), overwritten with −1000 on collision;
- a random target position and yaw in the dome; spawn = target +
  U(−10, 10) with ±10° roll/pitch and a random yaw; no stabilization
  steps at reset;
- an optional ``GaussianWind`` with a random base per env;
- flight modes restricted to {−1, 7, 8, 9, 10}, all flown by
  ``models/quadx`` (10 is the fork's gain-scheduled ``ops/ga_pid``).

Reference quirks kept: the 20 m position-error termination is dead code
in the reference (``np.any(...) > 20`` compares a bool to 20), so only a
collision and the step limit end an episode; the constructor's default
``flight_mode=0`` is outside the modes it admits, so ``flight_mode`` must
always be given.

The batch's random stream is one ``torch.Generator`` carried in the state
(the resets' draws, the motor noise and the wind gusts), where the JAX env
carries a PRNG key per instance.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.core.wind import GaussianWind
from pyflyt_tpu_torch.device import resolve_device
from pyflyt_tpu_torch.envs.base import StepOut, tree_select
from pyflyt_tpu_torch.models import quadx

ROLL_PITCH_SPAWN = 0.174533  # ±10° of initial roll and pitch


@dataclasses.dataclass
class ModHoverState:
    drone: quadx.QuadXState
    wind: GaussianWind  # zero base and gusts when simulate_wind=False
    generator: torch.Generator | None
    step_count: Tensor  # (N,) int32
    termination: Tensor  # (N,) bool
    truncation: Tensor  # (N,) bool
    reward: Tensor  # (N,)
    action: Tensor  # (N, 4) raw (denormalized) action
    target_pos: Tensor  # (N, 3)
    target_psi: Tensor  # (N,)
    state16: Tensor  # (N, 16) the unnormalized observation
    collision: Tensor  # (N,) bool
    env_complete: Tensor  # (N,) bool


@dataclasses.dataclass(frozen=True)
class QuadXModHoveringEnv:
    control_hz: int = 40
    orn_conv: str = "ENU_FLU"
    start_pos: tuple = ((0.0, 0.0, 1.0),)
    start_orn: tuple = ((0.0, 0.0, 0.0),)
    noisy_motors: bool = True
    min_pwm: float = 0.0
    max_pwm: float = 1.0
    drone_model: str = "cf2x"
    simulate_wind: bool = False
    base_wind_velocities: tuple | None = None
    max_gust_strength: float = 7.0
    flight_mode: int = 0  # reference default, outside the admitted modes
    flight_dome_size: float = 100.0
    max_duration_seconds: float = 10.0
    normalize_obs: bool = True
    normalize_actions: bool = True
    randomize_start: bool = True
    target_pos: tuple = (0.0, 0.0, 1.0)
    target_psi: float = 0.0
    alpha: float = 2.0
    beta: float = 0.1
    gamma: float = 4.0
    delta: float = 0.1
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if 240 % self.control_hz != 0:
            raise ValueError("`control_hz` must be a round denominator of 240.")
        if self.flight_mode not in (-1, 7, 8, 9, 10):
            raise ValueError(
                f"Invalid flight mode {self.flight_mode}, only -1, 7, 8, 9, 10 allowed."
            )
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def max_steps(self) -> int:
        return int(self.control_hz * self.max_duration_seconds)

    @functools.cached_property
    def cfg(self) -> quadx.QuadXConfig:
        return quadx.QuadXConfig(
            drone_model=self.drone_model,
            control_hz=self.control_hz,
            orn_conv=self.orn_conv,
            noisy_motors=self.noisy_motors,
            min_pwm=self.min_pwm,
            max_pwm=self.max_pwm,
        )

    @functools.cached_property
    def params(self) -> quadx.QuadXParams:
        return quadx.build_params(self.cfg, self.device)

    # ----- spaces ---------------------------------------------------------
    @functools.cached_property
    def obs_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        d = self.flight_dome_size + 25
        z_lo, z_hi = (0.0, d) if self.orn_conv == "ENU_FLU" else (-d, 0.0)
        low = np.array(
            [-d, -d, z_lo, -50, -50, -50, -np.pi, -np.pi, -np.pi,
             -130, -130, -130, -20, -20, -20, -np.pi]
        )
        high = np.array(
            [d, d, z_hi, 50, 50, 50, np.pi, np.pi, np.pi,
             130, 130, 130, 20, 20, 20, np.pi]
        )
        return low, high

    @functools.cached_property
    def raw_action_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        if self.flight_mode in (-1, 8):
            return np.zeros(4), np.ones(4)
        if self.flight_mode == 9:
            return np.array([-1.0, -1.0, -1.0, 0.0]), np.ones(4)
        return np.full(4, -np.inf), np.full(4, np.inf)  # modes 7 / 10

    def action_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """The agent-facing bounds ([−1, 1] when normalized)."""
        low, high = self.raw_action_bounds
        if self.normalize_actions and self.flight_mode not in (7, 10):
            return -np.ones(4), np.ones(4)
        return low, high

    @property
    def obs_size(self) -> int:
        return 16

    @property
    def action_size(self) -> int:
        return 4

    # ----- internals --------------------------------------------------------
    @staticmethod
    def round3(x: Tensor) -> Tensor:
        """The reference rounds states to 3 decimals (``np.round(x, 3)``)."""
        return torch.round(x * 1000.0) / 1000.0

    def _bounds_t(self, bounds, like: Tensor) -> tuple[Tensor, Tensor]:
        return tuple(torch.as_tensor(b, dtype=like.dtype, device=like.device) for b in bounds)

    def compute_state16(self, view: Tensor, target_pos: Tensor, target_psi: Tensor) -> Tensor:
        """The rounded 16-dim state from the read's ``(N, 4, 3)`` view."""
        ang_vel = view[..., 0, :]
        ang_pos = pm.wrap_angle(view[..., 1, :])
        lin_vel = view[..., 2, :]
        lin_pos = view[..., 3, :]
        psi_err = pm.wrap_angle(target_psi - ang_pos[..., 2])
        pos_err = target_pos - lin_pos
        return self.round3(
            torch.cat([lin_pos, lin_vel, ang_pos, ang_vel, pos_err, psi_err[..., None]], dim=-1)
        )

    def normalize_state16(self, state16: Tensor) -> Tensor:
        if not self.normalize_obs:
            return state16
        low, high = self._bounds_t(self.obs_bounds, state16)
        clipped = torch.clamp(state16, low, high)
        return ((clipped - low) / (high - low)) * 2.0 - 1.0

    def denormalize_action(self, action: Tensor) -> Tensor:
        if not self.normalize_actions or self.flight_mode in (7, 10):
            return action
        low, high = self._bounds_t(self.raw_action_bounds, action)
        return ((action + 1.0) / 2.0) * (high - low) + low

    def reward_of(self, state16: Tensor, collision: Tensor) -> Tensor:
        """``35 − α‖pos_err‖ − β‖vel‖ − γ|psi_err| − δ‖ω‖``, −1000 on a
        collision."""
        norm = torch.linalg.vector_norm
        reward = 35.0 + (
            -self.alpha * norm(state16[..., 12:15], dim=-1)
            - self.beta * norm(state16[..., 3:6], dim=-1)
            - self.gamma * torch.abs(state16[..., 15])
            - self.delta * norm(state16[..., 9:12], dim=-1)
        )
        return torch.where(collision, -1000.0, reward).to(self.cfg.dtype)

    def make_wind(self, num_envs: int, generator: torch.Generator | None) -> GaussianWind:
        """The env's wind field: a random (or the configured) base per env
        and gusts, or an inactive field (zero base, no gusts)."""
        kw = dict(orn_conv=self.orn_conv, dtype=self.cfg.dtype, device=self.device)
        if self.simulate_wind:
            return GaussianWind.init(
                generator, num_envs, base_wind=self.base_wind_velocities,
                max_gust=self.max_gust_strength, **kw,
            )
        return GaussianWind.init(generator, num_envs, base_wind=(0.0, 0.0, 0.0), max_gust=0.0, **kw)

    def _uniform(self, shape, lo, hi, generator) -> Tensor:
        u = torch.rand(shape, generator=generator, dtype=self.cfg.dtype, device=self.device)
        return lo + u * (hi - lo)

    # ----- API --------------------------------------------------------------
    def reset(
        self, num_envs: int, generator: torch.Generator | None = None
    ) -> tuple[ModHoverState, Tensor]:
        """A fresh batch; ``generator`` draws the targets, spawns and wind
        bases, and stays the batch's stream (motor noise, gusts)."""
        if generator is None and (self.randomize_start or self.noisy_motors or self.simulate_wind):
            raise ValueError("QuadXModHoveringEnv.reset needs a torch.Generator")
        n, dtype, dev = num_envs, self.cfg.dtype, self.device
        if self.randomize_start:
            dome = self.flight_dome_size
            xy = self._uniform((n, 2), -dome, dome, generator)
            if self.orn_conv == "ENU_FLU":
                z = self._uniform((n, 1), 1.0, dome, generator)
            else:
                z = self._uniform((n, 1), -dome, -1.0, generator)
            target_pos = self.round3(torch.cat([xy, z], dim=-1))
            target_psi = self.round3(self._uniform((n,), -np.pi, np.pi, generator))
            start_pos = self.round3(target_pos + self._uniform((n, 3), -10.0, 10.0, generator))
            rp = self._uniform((n, 2), -ROLL_PITCH_SPAWN, ROLL_PITCH_SPAWN, generator)
            psi0 = self._uniform((n, 1), -np.pi, np.pi, generator)
            start_orn = self.round3(torch.cat([rp, psi0], dim=-1))
        else:
            t = lambda v: torch.tensor(v, dtype=dtype, device=dev)  # noqa: E731
            target_pos = t(self.target_pos).expand(n, 3).clone()
            target_psi = t(self.target_psi).expand(n).clone()
            start_pos = t(self.start_pos[0]).expand(n, 3).clone()
            start_orn = t(self.start_orn[0]).expand(n, 3).clone()

        wind = self.make_wind(n, generator)
        drone = quadx.init_state(self.params, self.cfg, start_pos, start_orn)
        drone = quadx.set_mode(drone, self.flight_mode, self.cfg)
        state16 = self.compute_state16(drone.read.view, target_pos, target_psi)
        false = torch.zeros(n, dtype=torch.bool, device=dev)
        state = ModHoverState(
            drone=drone,
            wind=wind,
            generator=generator,
            step_count=torch.zeros(n, dtype=torch.int32, device=dev),
            termination=false,
            truncation=false.clone(),
            reward=torch.zeros(n, dtype=dtype, device=dev),
            action=torch.zeros(n, 4, dtype=dtype, device=dev),
            target_pos=target_pos,
            target_psi=target_psi,
            state16=state16,
            collision=false.clone(),
            env_complete=false.clone(),
        )
        return state, self.normalize_state16(state16)

    def step(self, state: ModHoverState, action: Tensor) -> tuple[ModHoverState, StepOut]:
        """One env step = one aviary step; a finished env keeps its state."""
        action = self.denormalize_action(action.to(self.cfg.dtype))
        done_before = state.termination | state.truncation
        drone = dataclasses.replace(state.drone, setpoint=action)
        drone, contact = quadx.step(
            drone, self.params, self.cfg, self.flight_mode, state.generator, wind_fn=state.wind
        )
        state16 = self.compute_state16(drone.read.view, state.target_pos, state.target_psi)
        # the reference checks the count BEFORE the end-of-step increment
        truncation = state.step_count >= self.max_steps
        new_state = dataclasses.replace(
            state,
            drone=drone,
            step_count=state.step_count + 1,
            termination=state.termination | contact,
            truncation=state.truncation | truncation,
            reward=self.reward_of(state16, contact),
            action=action,
            state16=state16,
            collision=state.collision | contact,
        )
        new_state = tree_select(done_before, state, new_state)  # the done-freeze
        out = StepOut(
            obs=self.normalize_state16(new_state.state16),
            reward=torch.where(done_before, 0.0, new_state.reward),
            termination=new_state.termination,
            truncation=new_state.truncation,
            info={
                "collision": new_state.collision,
                "out_of_bounds": torch.zeros_like(new_state.collision),  # dead code in the reference
                "env_complete": new_state.env_complete,
            },
        )
        return new_state, out
