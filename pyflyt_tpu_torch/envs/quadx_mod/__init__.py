"""The fork's modified QuadX envs (port of ``pyflyt_tpu/envs/quadx_mod``):
normalized obs and actions, shaped rewards: hovering (plain and packed on
the generic QuadX kernel) and the two trajectory-following tasks."""

from pyflyt_tpu_torch.envs.quadx_mod.hovering import QuadXModHoveringEnv  # noqa: F401
from pyflyt_tpu_torch.envs.quadx_mod.packed_hovering import PackedQuadXModHoveringEnv  # noqa: F401
from pyflyt_tpu_torch.envs.quadx_mod.pid_expert import (  # noqa: F401
    hovering_pid_expert,
    trajectory_pid_expert,
)
from pyflyt_tpu_torch.envs.quadx_mod.trajectory_following_fast import (  # noqa: F401
    QuadXTrajectoryFollowingFastEnv,
)
from pyflyt_tpu_torch.envs.quadx_mod.trajectory_following_slow import (  # noqa: F401
    QuadXTrajectoryFollowingSlowEnv,
)
