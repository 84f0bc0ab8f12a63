"""Hovering PID expert policy (port of
``pyflyt_tpu/envs/quadx_mod/pid_expert.py``): reads the unnormalized 16-dim
hovering observation and emits a mode-7/10 setpoint ``[x, y, psi, z]``
pointing at the target (position + error), the classical-control baseline
the fork compares RL policies against.
"""

from __future__ import annotations

import torch
from torch import Tensor

from pyflyt_tpu_torch.core import math as pm


def hovering_pid_expert(observation: Tensor) -> Tensor:
    """(…, 16) unnormalized hovering obs → (…, 4) mode-7/10 setpoint."""
    target_pos = observation[..., 0:3] + observation[..., 12:15]
    target_psi = pm.wrap_angle(observation[..., 8] + observation[..., 15])
    return torch.stack(
        [target_pos[..., 0], target_pos[..., 1], target_psi, target_pos[..., 2]], dim=-1
    )


def trajectory_pid_expert(observation: Tensor) -> Tensor:
    """(…, 16) unnormalized trajectory-following obs → (…, 4) mode-10
    setpoint: the slow variant's obs shares the hovering layout, so the
    expert is the same position-plus-error passthrough."""
    return hovering_pid_expert(observation)
