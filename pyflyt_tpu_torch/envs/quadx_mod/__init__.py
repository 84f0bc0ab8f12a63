"""The fork's modified QuadX envs (port of ``pyflyt_tpu/envs/quadx_mod``):
normalized obs and actions, shaped rewards. The trajectory-following envs
are ROADMAP.md item 17 (slice 5)."""

from pyflyt_tpu_torch.envs.quadx_mod.hovering import QuadXModHoveringEnv  # noqa: F401
from pyflyt_tpu_torch.envs.quadx_mod.packed_hovering import PackedQuadXModHoveringEnv  # noqa: F401
from pyflyt_tpu_torch.envs.quadx_mod.pid_expert import (  # noqa: F401
    hovering_pid_expert,
    trajectory_pid_expert,
)
