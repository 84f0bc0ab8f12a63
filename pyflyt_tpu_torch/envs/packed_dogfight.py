"""Packed-state MA Fixedwing Dogfight: the whole agent step of every arena
is one kernel launch (port of ``pyflyt_tpu/envs/packed_dogfight.py``).

``N`` arenas, ``2N`` drones, live in the ``(72, 2N)`` layout of
``ops/cuda_dogfight.py`` (column ``2a + m`` is drone ``m`` of arena
``a``). ``step`` masks the actions by ``alive``, writes them into the
setpoint rows (zero-padded to 6) with the other-dead flag, launches
``cuda_dogfight.packed_dogfight_step`` once (4 aviary steps x 2 physics
iterations at the stock 30 Hz, the engagement rewards with the
reference's memo lag, termination and truncation), and assembles the
``(N, 2, 30)`` observation pair from the final packed state in torch ops:
the reference recomputes it every aviary step, but only the last one is
ever observed. Reset is the plain env's batched reset, packed.

Semantics match ``MAFixedwingDogfightEnv`` with noise off, up to f32
rounding; the contact is detection-grade, as in K5, which only shows
after a collision has ended the arena.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import Tensor

from pyflyt_tpu_torch.envs.ma_fixedwing_dogfight import DogfightState, MAFixedwingDogfightEnv, observation_pair
from pyflyt_tpu_torch.envs.ma_quadx_hover import MAStepOut
from pyflyt_tpu_torch.ops import cuda_dogfight as cd
from pyflyt_tpu_torch.ops import cuda_fixedwing as cf


@dataclasses.dataclass
class PackedDogfightEnvState:
    packed: Tensor  # (cd.ROWS, 2N)
    generator: torch.Generator | None  # the kernel's noise seeds
    alive: Tensor  # (N, 2) bool
    current_actions: Tensor  # (N, 2, A)
    past_actions: Tensor  # (N, 2, A)


@dataclasses.dataclass(frozen=True)
class PackedMAFixedwingDogfightEnv:
    """Batch-level env on the packed layout; ``base`` holds the task
    configuration and the device."""

    base: MAFixedwingDogfightEnv = dataclasses.field(default_factory=MAFixedwingDogfightEnv)

    @property
    def num_agents(self) -> int:
        return 2

    @functools.cached_property
    def consts(self) -> cd.DogfightConsts:
        b = self.base
        return cd.dogfight_consts(
            b.params, b.cfg, inner_steps=b.env_step_ratio, dome=b.flight_dome_size, max_steps=b.max_steps,
            lethal_angle=b.lethal_angle_radians, lethal_distance=b.lethal_distance,
            damage_per_hit=b.damage_per_hit, collision_radius=b.collision_radius,
        )

    # ----- layout conversions ---------------------------------------------
    def pack_env_state(self, st: DogfightState) -> Tensor:
        """Batched ``DogfightState`` → packed ``(72, 2N)``."""
        return cd.pack_env_state(st)

    def _obs(self, packed: Tensor, past_actions: Tensor) -> Tensor:
        """``(72, 2N)`` rows → the ``(N, 2, obs)`` observation pair, the
        plain env's ``observation_pair`` on the final aviary step."""
        n = packed.shape[1] // 2
        view = packed[cf._VIEW : cf._VIEW + 12].T.reshape(n, 2, 4, 3)
        return observation_pair(view, cd.pair(packed, cd._HP), past_actions)

    # ----- API --------------------------------------------------------------
    def reset(
        self, num_arenas: int, generator: torch.Generator | None = None
    ) -> tuple[PackedDogfightEnvState, Tensor]:
        """The plain env's batched reset, packed."""
        st, obs = self.base.reset(num_arenas, generator)
        return PackedDogfightEnvState(
            packed=self.pack_env_state(st), generator=generator, alive=st.alive,
            current_actions=st.current_actions, past_actions=st.past_actions,
        ), obs

    def step(self, state: PackedDogfightEnvState, actions: Tensor) -> tuple[PackedDogfightEnvState, MAStepOut]:
        """``actions``: (N, 2, action_size). One full agent step per arena,
        one kernel launch; the setpoint and other-dead rows are written into
        ``state.packed`` in place, and the kernel returns the next state as
        a new tensor."""
        b = self.base
        packed = state.packed
        n = packed.shape[1] // 2
        if b.noisy_motors:
            seed = torch.randint(0, 2**31 - 1, (1,), generator=state.generator, device=packed.device,
                                 dtype=torch.int64)
        else:
            seed = torch.zeros(1, dtype=torch.int64, device=packed.device)
        agents_mask = state.alive
        actions = torch.where(agents_mask[..., None], actions.to(packed.dtype), 0.0)
        a_dim = actions.shape[-1]
        packed[cf._SP : cf._SP + a_dim] = actions.reshape(2 * n, a_dim).T
        packed[cf._SP + a_dim : cf._SP + 6] = 0.0
        packed[cd._OTHD] = (agents_mask.sum(dim=1) < 2).to(packed.dtype).repeat_interleave(2)
        out = cd.packed_dogfight_step(packed, seed, self.consts, b.noisy_motors, b.sparse_reward)

        term = cd.pair(out, cd._TERM) > 0.5
        trunc = cd.pair(out, cd._TRUNC) > 0.5
        health = cd.pair(out, cd._HP)
        # the obs's past-action block is the PREVIOUS step's action
        obs = self._obs(out, state.current_actions)
        new_state = PackedDogfightEnvState(
            packed=out, generator=state.generator, alive=agents_mask & ~(term | trunc),
            current_actions=actions, past_actions=state.current_actions,
        )
        return new_state, MAStepOut(
            obs=obs,
            reward=cd.pair(out, cd._RWD),
            termination=term,
            truncation=trunc,
            agents_mask=agents_mask,
            info={
                "collision": cd.pair(out, cd._COLLF) > 0.5,
                "out_of_bounds": cd.pair(out, cd._OOBF) > 0.5,
                "wins": (health <= 0.0)[:, None, :].expand(n, 2, 2),
                "healths": health[:, None, :].expand(n, 2, 2),
            },
        )
