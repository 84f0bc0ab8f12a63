"""Packed-state Rocket-Landing env: the whole agent step is one kernel
launch (port of ``pyflyt_tpu/envs/packed_rocket_landing.py``).

``N`` envs live in the ``(88, N)`` layout of ``ops/cuda_rocket.py``.
``step`` writes the action into the setpoint rows and launches
``cuda_rocket.packed_landing_step`` once: ``env_step_ratio`` aviary steps
of 2 physics iterations with the fuel-tracked composite inertia and the
impulse contact on the ground and the pad, the shaped reward with the
memo-lagged touchdown checks, termination, truncation and the done-freeze.
The observation (attitude, previous action, auxiliary state, pad flag,
rotated pad-relative distance) is built from the packed rows in torch
ops, as the JAX env builds it in XLA. Reset is the plain env's batched
reset, packed.

Like the JAX env it has no auto-reset: it serves a policy over whole
episodes (finished lanes stay frozen). Quaternion attitude only, as the
JAX env asserts. Semantics match ``RocketLandingEnv`` with noise off, up
to f32 rounding.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import Tensor

from pyflyt_tpu_torch.core import math as pm
from pyflyt_tpu_torch.envs.base import StepOut
from pyflyt_tpu_torch.envs.rocket_landing import RocketLandingEnv, RocketLandingState
from pyflyt_tpu_torch.ops import cuda_rocket as cr


@dataclasses.dataclass
class PackedRocketEnvState:
    packed: Tensor  # (88, N)
    generator: torch.Generator | None  # draws each step's booster-noise seed


@dataclasses.dataclass(frozen=True)
class PackedRocketLandingEnv:
    """Batch-level env on the packed layout; ``base`` holds the task
    configuration and the device."""

    base: RocketLandingEnv = dataclasses.field(default_factory=RocketLandingEnv)

    def __post_init__(self):
        if self.base.angle_representation != "quaternion":
            raise ValueError("the packed rocket env takes the quaternion attitude only, as the JAX env does")

    @property
    def action_size(self) -> int:
        return 7

    @property
    def max_steps(self) -> int:
        return self.base.max_steps

    def action_bounds(self):
        return self.base.action_bounds()

    @functools.cached_property
    def consts(self) -> cr.RocketConsts:
        b = self.base
        return cr.landing_consts(b.params, b.cfg, inner_steps=b.env_step_ratio, max_steps=b.max_steps,
                                 max_displacement=b.max_displacement, ceiling=b.ceiling)

    # ----- layout conversions ---------------------------------------------
    def pack_env_state(self, st: RocketLandingState) -> Tensor:
        """Batched ``RocketLandingState`` → packed rows."""
        packed = cr.pack_state(st.drone)
        packed[cr._RWD : cr._STEP + 1] = torch.stack([
            st.reward, st.termination, st.truncation, st.fatal_collision, st.out_of_bounds, st.env_complete,
            st.step_count,
        ]).to(torch.float32)
        packed[cr._PADP : cr._PADP + 3] = st.pad_position.T
        packed[cr._PFLAG] = st.pad_contact_flag
        for row, memo in ((cr._AV, st.ang_vel), (cr._LV, st.lin_vel), (cr._DIST, st.distance),
                          (cr._PAV, st.prev_ang_vel), (cr._PLV, st.prev_lin_vel), (cr._PDIST, st.prev_distance)):
            packed[row : row + 3] = memo.T
        return packed

    def _obs(self, packed: Tensor) -> Tensor:
        """The observation from packed rows."""
        rows = lambda r, k: packed[r : r + k].T  # noqa: E731
        quat = pm.euler_to_quat(rows(cr._VIEW + 3, 3))
        rotated_distance = torch.einsum("...j,...ji->...i", rows(cr._DIST, 3), pm.quat_to_rotmat(quat))
        return torch.cat([
            rows(cr._VIEW, 3), quat, rows(cr._VIEW + 6, 3), rows(cr._VIEW + 9, 3), rows(cr._SP, 7),
            rows(cr._ACT, 4), rows(cr._IGN, 1), rows(cr._FUEL, 1), rows(cr._BTHR, 1), rows(cr._GBL, 2),
            rows(cr._PFLAG, 1), rotated_distance,
        ], dim=-1)

    # ----- env API ----------------------------------------------------------
    def reset(self, num_envs: int, generator: torch.Generator | None = None) -> tuple[PackedRocketEnvState, Tensor]:
        """The plain env's batched reset, packed."""
        st, obs = self.base.reset(num_envs, generator)
        return PackedRocketEnvState(packed=self.pack_env_state(st), generator=generator), obs

    def step(self, state: PackedRocketEnvState, action: Tensor) -> tuple[PackedRocketEnvState, StepOut]:
        """One agent step: one kernel launch. The action is written into the
        state's setpoint rows in place (frozen lanes included, as in the
        plain env); the kernel returns the next state as a new tensor."""
        b = self.base
        packed = state.packed
        if b.noisy_boosters:
            seed = torch.randint(
                0, 2**31 - 1, (1,), generator=state.generator, device=packed.device, dtype=torch.int64
            )
        else:
            seed = torch.zeros(1, dtype=torch.int64, device=packed.device)
        packed[cr._SP : cr._SP + 7] = action.to(packed.dtype).T
        out = cr.packed_landing_step(packed, seed, self.consts, b.noisy_boosters, b.sparse_reward)
        step_out = StepOut(
            obs=self._obs(out),
            reward=out[cr._RWD],
            termination=out[cr._TERM] > 0.5,
            truncation=out[cr._TRUNC] > 0.5,
            info={
                "fatal_collision": out[cr._FATC] > 0.5,
                "out_of_bounds": out[cr._OOB] > 0.5,
                "env_complete": out[cr._CPLT] > 0.5,
            },
        )
        return PackedRocketEnvState(packed=out, generator=state.generator), step_out
