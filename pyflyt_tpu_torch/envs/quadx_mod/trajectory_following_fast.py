"""The fork's fast trajectory-following env (port of
``pyflyt_tpu/envs/quadx_mod/trajectory_following_fast.py``), batched by
construction: chase a chain of random waypoints as fast as possible (reach
at 1 m, no hover dwell).

Semantics kept from the JAX env, all of them:

- one aviary step per env step at ``control_hz`` (default 80, NED_FRD,
  mode 9); flight modes -1, 7, 8, 9 and 10, flown by ``models/quadx``;
- the observation (19): [lin_pos, lin_vel, ang_pos (wrapped), ang_vel,
  lin_pos_error, delta_pos (next − current target), angle_diff between the
  velocity and the leg], rounded to 3 decimals; ``angle_diff`` refreshes
  only at ‖v‖ ≥ 0.01 and is 0 for a zero leg;
- the waypoint chain: ``ceil(max_duration_seconds)`` targets (at least 2),
  each a U(−10, 10)³ offset from the previous with components pushed out
  of (−1, 1) and a per-axis reflection at the dome (the z condition is
  written for NED and kept literally); ``chain_waypoints`` takes the
  offsets, so a test can feed it the JAX env's own draws;
- the target and next pointers advance on a reach and clamp to the last
  waypoint, the error baseline resets;
- reward ``β·(1000 − steps since the last reach)`` when the count
  advanced, plus ``α·100·progress / leg length − γ·‖ω‖``; −1000 on a
  collision; truncation from the count before the step's increment; a
  finished env keeps its state (the done-freeze);
- the reference's 20 m out-of-bounds check is dead code (a bool compared
  to 20) and is reproduced by omission: ``out_of_bounds`` is always False.

The batch's random stream is one ``torch.Generator`` carried in the state
(the resets' draws, the motor noise, the wind gusts), where the JAX env
carries a PRNG key per instance. ``native_batch`` and the auto-reset
methods let ``rl/ppo`` step the batch as it is.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.core.wind import GaussianWind
from pyflyt_tpu_torch.device import resolve_device
from pyflyt_tpu_torch.envs import base as env_base
from pyflyt_tpu_torch.envs.base import StepOut, tree_select
from pyflyt_tpu_torch.models import quadx

ROLL_PITCH_SPAWN = 0.174533  # ±10° of initial roll and pitch
OFFSET = 10.0  # a waypoint's offset from the previous: U(-OFFSET, OFFSET) per axis


@dataclasses.dataclass
class TrajFastState:
    drone: quadx.QuadXState
    wind: GaussianWind  # zero base and gusts when simulate_wind=False
    generator: torch.Generator | None
    step_count: Tensor  # (N,) int32
    termination: Tensor  # (N,) bool
    truncation: Tensor  # (N,) bool
    reward: Tensor  # (N,)
    action: Tensor  # (N, 4) raw (denormalized) action
    waypoints: Tensor  # (N, n_targets, 3)
    num_targets_reached: Tensor  # (N,) int32
    prev_step_count_reached: Tensor  # (N,) int32
    target_pos: Tensor  # (N, 3)
    next_pos: Tensor  # (N, 3)
    delta_pos: Tensor  # (N, 3)
    lin_pos_error: Tensor  # (N, 3)
    prev_lin_pos_error: Tensor  # (N, 3)
    lin_pos_error_fixed: Tensor  # (N,) the leg length baseline
    angle_diff: Tensor  # (N,)
    state19: Tensor  # (N, 19) the unnormalized observation
    collision: Tensor  # (N,) bool
    env_complete: Tensor  # (N,) bool


def push_out_of_unit(s: Tensor) -> Tensor:
    """Offsets in (−1, 0) become −1, in [0, 1) become 1."""
    s = torch.where((s < 0.0) & (s > -1.0), -1.0, s)
    s = torch.where((s > 0.0) & (s < 1.0), 1.0, s)
    return torch.where(s == 0.0, 1.0, s)


def next_waypoint(base: Tensor, s: Tensor, dome: float) -> Tensor:
    """One waypoint of the chain from ``base`` (..., 3) and a raw offset
    ``s`` (..., 3) drawn from U(−10, 10): each axis reflected back
    (``base − s``) where it would leave the dome, z also where it would
    rise above −1 (the reference's NED-literal condition)."""
    s = push_out_of_unit(s)
    new = base + s
    out_xy = torch.abs(new[..., :2]) > dome
    out_z = (torch.abs(new[..., 2]) > dome) | (new[..., 2] > -1.0)
    back = base - s
    return torch.cat([torch.where(out_xy, back[..., :2], new[..., :2]),
                      torch.where(out_z, back[..., 2], new[..., 2])[..., None]], dim=-1)


def chain_waypoints(start: Tensor, offsets: Tensor, dome: float) -> Tensor:
    """The chained sampler: ``offsets`` (N, n, 3) raw U(−10, 10) draws →
    the (N, n, 3) waypoints, each from the one before (the first from
    ``start`` (N, 3))."""
    out, base = [], start
    for i in range(offsets.shape[-2]):
        base = next_waypoint(base, offsets[..., i, :], dome)
        out.append(base)
    return torch.stack(out, dim=-2)


@dataclasses.dataclass(frozen=True)
class QuadXTrajectoryFollowingFastEnv:
    control_hz: int = 80
    orn_conv: str = "NED_FRD"
    randomize_start: bool = True
    start_pos: tuple = ((0.0, 0.0, -1.0),)
    start_orn: tuple = ((0.0, 0.0, 0.0),)
    random_trajectory: bool = True
    waypoints: tuple | None = None
    goal_reach_distance: float = 1.0
    min_pwm: float = 0.0
    max_pwm: float = 1.0
    noisy_motors: bool = False
    drone_model: str = "cf2x"
    flight_mode: int = 9
    simulate_wind: bool = False
    base_wind_velocities: tuple | None = None
    max_gust_strength: float = 7.0
    flight_dome_size: float = 100.0
    max_duration_seconds: float = 30.0
    normalize_obs: bool = True
    normalize_actions: bool = True
    alpha: float = 10.0
    beta: float = 1.0
    gamma: float = 0.2
    device: str | torch.device = "cuda"

    native_batch = True  # PPO: the env steps and auto-resets the batch itself
    time_limit_truncation_only = True  # PPO may take the one-slot truncation bootstrap

    def __post_init__(self):
        if 240 % self.control_hz != 0:
            raise ValueError("`control_hz` must be a round denominator of 240.")
        if self.flight_mode not in (-1, 7, 8, 9, 10):
            raise ValueError(f"Invalid flight mode {self.flight_mode}, only -1, 7, 8, 9, 10 allowed.")
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def num_of_targets(self) -> int:
        if not self.random_trajectory and self.waypoints is not None:
            return len(self.waypoints)
        return max(2, int(math.ceil(self.max_duration_seconds)))

    @property
    def max_steps(self) -> int:
        return int(self.control_hz * self.max_duration_seconds)

    @functools.cached_property
    def cfg(self) -> quadx.QuadXConfig:
        return quadx.QuadXConfig(
            drone_model=self.drone_model, control_hz=self.control_hz, orn_conv=self.orn_conv,
            noisy_motors=self.noisy_motors, min_pwm=self.min_pwm, max_pwm=self.max_pwm,
        )

    @functools.cached_property
    def params(self) -> quadx.QuadXParams:
        return quadx.build_params(self.cfg, self.device)

    # ----- spaces ---------------------------------------------------------
    @functools.cached_property
    def obs_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        d = self.flight_dome_size + 30
        z_lo, z_hi = (0.0, d) if self.orn_conv == "ENU_FLU" else (-d, 0.0)
        low = np.array([-d, -d, z_lo, -50, -50, -50, -np.pi, -np.pi, -np.pi,
                        -130, -130, -130, -20, -20, -20, -10, -10, -10, 0])
        high = np.array([d, d, z_hi, 50, 50, 50, np.pi, np.pi, np.pi,
                         130, 130, 130, 20, 20, 20, 10, 10, 10, np.pi])
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
        if self.normalize_actions and self.flight_mode not in (7, 10):
            return -np.ones(4), np.ones(4)
        return self.raw_action_bounds

    @property
    def obs_size(self) -> int:
        return 19

    @property
    def action_size(self) -> int:
        return 4

    # ----- helpers --------------------------------------------------------
    @staticmethod
    def round3(x: Tensor) -> Tensor:
        """The reference rounds states to 3 decimals (``np.round(x, 3)``)."""
        return torch.round(x * 1000.0) / 1000.0

    def normalize_state(self, state: Tensor) -> Tensor:
        if not self.normalize_obs:
            return state
        low, high = (torch.as_tensor(b, dtype=state.dtype, device=state.device) for b in self.obs_bounds)
        return ((torch.clamp(state, low, high) - low) / (high - low)) * 2.0 - 1.0

    def denormalize_action(self, action: Tensor) -> Tensor:
        if not self.normalize_actions or self.flight_mode in (7, 10):
            return action
        low, high = (torch.as_tensor(b, dtype=action.dtype, device=action.device) for b in self.raw_action_bounds)
        return ((action + 1.0) / 2.0) * (high - low) + low

    def make_wind(self, num_envs: int, generator: torch.Generator | None) -> GaussianWind:
        """A random (or the configured) base per env and gusts, or an
        inactive field (zero base, no gusts)."""
        kw = dict(orn_conv=self.orn_conv, dtype=self.cfg.dtype, device=self.device)
        if self.simulate_wind:
            return GaussianWind.init(generator, num_envs, base_wind=self.base_wind_velocities,
                                     max_gust=self.max_gust_strength, **kw)
        return GaussianWind.init(generator, num_envs, base_wind=(0.0, 0.0, 0.0), max_gust=0.0, **kw)

    def uniform(self, shape, lo, hi, generator) -> Tensor:
        u = torch.rand(shape, generator=generator, dtype=self.cfg.dtype, device=self.device)
        return lo + u * (hi - lo)

    def draw_start(self, n: int, generator) -> tuple[Tensor, Tensor]:
        """Spawn positions and orientations (N, 3): random in the dome
        (z in [1, dome] above the ground) with ±10° roll and pitch and any
        yaw, or the configured pose."""
        if not self.randomize_start:
            t = lambda v: torch.tensor(v, dtype=self.cfg.dtype, device=self.device).expand(n, 3).clone()  # noqa: E731
            return t(self.start_pos[0]), t(self.start_orn[0])
        dome = self.flight_dome_size
        xy = self.uniform((n, 2), -dome, dome, generator)
        z = self.uniform((n, 1), 1.0, dome, generator) if self.orn_conv == "ENU_FLU" else self.uniform(
            (n, 1), -dome, -1.0, generator)
        rp = self.uniform((n, 2), -ROLL_PITCH_SPAWN, ROLL_PITCH_SPAWN, generator)
        psi = self.uniform((n, 1), -math.pi, math.pi, generator)
        return torch.cat([xy, z], dim=-1), torch.cat([rp, psi], dim=-1)

    def new_drone(self, start_pos: Tensor, start_orn: Tensor) -> quadx.QuadXState:
        drone = quadx.init_state(self.params, self.cfg, start_pos, start_orn)
        return quadx.set_mode(drone, self.flight_mode, self.cfg)

    # ----- tracking (compute_state) ----------------------------------------
    def update_tracking(self, state: TrajFastState) -> tuple[TrajFastState, Tensor]:
        """The reach test, the pointers, the errors, ``angle_diff`` and
        state19 from the drone's view; returns the state and the count of
        targets reached before this update."""
        norm = torch.linalg.vector_norm
        view = state.drone.read.view
        ang_vel, ang_pos = view[:, 0], pm.wrap_angle(view[:, 1])
        lin_vel, lin_pos = view[:, 2], view[:, 3]
        err = state.target_pos - lin_pos
        prev_reached = state.num_targets_reached
        reached = norm(err, dim=-1) < self.goal_reach_distance
        n = self.num_of_targets
        ntr = torch.where(reached & (prev_reached < n), prev_reached + 1, prev_reached)
        lanes = torch.arange(ntr.shape[0], device=ntr.device)
        target_idx = torch.clamp(ntr, max=n - 1).long()
        next_idx = torch.clamp(ntr + 1, max=n - 1).long()
        col = reached[:, None]
        target_pos = torch.where(col, state.waypoints[lanes, target_idx], state.target_pos)
        next_pos = torch.where(col, state.waypoints[lanes, next_idx], state.next_pos)
        delta_pos = next_pos - target_pos
        err_new = torch.where(col, target_pos - lin_pos, err)
        prev_err = torch.where(col, err_new, state.lin_pos_error)
        err_fixed = torch.where(reached, norm(err_new, dim=-1), state.lin_pos_error_fixed)
        speed = norm(lin_vel, dim=-1)
        leg = norm(delta_pos, dim=-1)
        cos = torch.sum(lin_vel * delta_pos, dim=-1) / torch.clamp(speed * leg, min=1e-12)
        angle_new = torch.where(leg == 0.0, 0.0, torch.arccos(torch.clamp(cos, -1.0, 1.0)))
        angle_diff = torch.where(speed >= 0.01, angle_new, state.angle_diff)
        state19 = self.round3(torch.cat([lin_pos, lin_vel, ang_pos, ang_vel, err_new, delta_pos,
                                         angle_diff[:, None]], dim=-1))
        return dataclasses.replace(
            state, num_targets_reached=ntr, target_pos=target_pos, next_pos=next_pos, delta_pos=delta_pos,
            lin_pos_error=err_new, prev_lin_pos_error=prev_err, lin_pos_error_fixed=err_fixed,
            angle_diff=angle_diff, state19=state19,
        ), prev_reached

    # ----- API ----------------------------------------------------------------
    def reset(self, num_envs: int, generator: torch.Generator | None = None) -> tuple[TrajFastState, Tensor]:
        """A fresh batch; ``generator`` draws the spawns, the waypoints and
        the wind bases, and stays the batch's stream."""
        if generator is None and (self.randomize_start or self.random_trajectory or self.noisy_motors
                                  or self.simulate_wind):
            raise ValueError(f"{type(self).__name__}.reset needs a torch.Generator")
        n, dtype, dev = num_envs, self.cfg.dtype, self.device
        start_pos, start_orn = self.draw_start(n, generator)
        if self.random_trajectory:
            offsets = self.uniform((n, self.num_of_targets, 3), -OFFSET, OFFSET, generator)
            waypoints = chain_waypoints(start_pos, offsets, self.flight_dome_size)
        else:
            waypoints = torch.tensor(self.waypoints, dtype=dtype, device=dev).expand(n, -1, 3).clone()
        wind = self.make_wind(n, generator)
        drone = self.new_drone(start_pos, start_orn)
        err = waypoints[:, 0] - start_pos
        false = torch.zeros(n, dtype=torch.bool, device=dev)
        zeros_i = torch.zeros(n, dtype=torch.int32, device=dev)
        state = TrajFastState(
            drone=drone, wind=wind, generator=generator, step_count=zeros_i, termination=false,
            truncation=false.clone(), reward=torch.zeros(n, dtype=dtype, device=dev),
            action=torch.zeros(n, 4, dtype=dtype, device=dev), waypoints=waypoints,
            num_targets_reached=zeros_i.clone(), prev_step_count_reached=zeros_i.clone(),
            target_pos=waypoints[:, 0], next_pos=waypoints[:, 1], delta_pos=waypoints[:, 1] - waypoints[:, 0],
            lin_pos_error=err, prev_lin_pos_error=err.clone(),
            lin_pos_error_fixed=torch.linalg.vector_norm(err, dim=-1),
            angle_diff=torch.zeros(n, dtype=dtype, device=dev),
            state19=torch.zeros(n, 19, dtype=dtype, device=dev), collision=false.clone(),
            env_complete=false.clone(),
        )
        state, _ = self.update_tracking(state)
        return state, self.normalize_state(state.state19)

    def step(self, state: TrajFastState, action: Tensor) -> tuple[TrajFastState, StepOut]:
        """One env step = one aviary step; a finished env keeps its state."""
        norm = torch.linalg.vector_norm
        action = self.denormalize_action(action.to(self.cfg.dtype))
        done_before = state.termination | state.truncation
        drone = dataclasses.replace(state.drone, setpoint=action)
        drone, contact = quadx.step(drone, self.params, self.cfg, self.flight_mode, state.generator,
                                    wind_fn=state.wind)
        st, prev_reached = self.update_tracking(dataclasses.replace(state, drone=drone, action=action))
        truncation = st.step_count >= self.max_steps  # the count before this step's increment
        err_prev = norm(st.prev_lin_pos_error, dim=-1)
        err_now = norm(st.lin_pos_error, dim=-1)
        advanced = st.num_targets_reached > prev_reached
        bonus = self.beta * (1000.0 - (st.step_count - st.prev_step_count_reached).to(self.cfg.dtype))
        reward = torch.where(advanced, bonus, 0.0)
        reward = reward + (self.alpha * (100.0 * (err_prev - err_now) / torch.clamp(st.lin_pos_error_fixed,
                                                                                     min=1e-12))) - (
            self.gamma * norm(st.state19[:, 9:12], dim=-1))
        reward = torch.where(contact, -1000.0, reward).to(self.cfg.dtype)
        new_state = dataclasses.replace(
            st,
            step_count=st.step_count + 1,
            termination=st.termination | contact,
            truncation=st.truncation | truncation,
            reward=reward,
            prev_step_count_reached=torch.where(advanced, st.step_count, st.prev_step_count_reached),
            collision=st.collision | contact,
        )
        new_state = tree_select(done_before, state, new_state)  # the done-freeze
        return new_state, StepOut(
            obs=self.normalize_state(new_state.state19),
            reward=torch.where(done_before, 0.0, new_state.reward),
            termination=new_state.termination,
            truncation=new_state.truncation,
            info={
                "collision": new_state.collision,
                "out_of_bounds": torch.zeros_like(new_state.collision),  # dead code in the reference
                "env_complete": new_state.env_complete,
                "num_targets_reached": new_state.num_targets_reached,
            },
        )

    # ----- PPO's auto-reset (rl/ppo.env_init, env_step) ---------------------
    def autoreset_step(self, state, action: Tensor):
        """Exact auto-reset: the whole batch is reset every step from the
        state's generator and finished lanes take it (``envs/base``)."""
        return env_base.autoreset_step(self, state, action)

    def cached_autoreset_init(self, num_envs: int, generator: torch.Generator | None = None):
        return env_base.autoreset_init(self, num_envs, generator)

    def cached_autoreset_step(self, ars, action: Tensor, refresh: int = 64):
        return env_base.cached_autoreset_step(self, ars, action, refresh)
