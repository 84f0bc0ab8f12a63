"""Batched QuadX and Fixedwing task envs of the port
(``reset(num_envs, generator)`` and ``step(state, action)`` take the whole
batch)."""

from pyflyt_tpu_torch.envs.fixedwing_waypoints import FixedwingWaypointsEnv, FixedwingWaypointsState
from pyflyt_tpu_torch.envs.packed_fixedwing_waypoints import PackedFixedwingWaypointsEnv
from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv
from pyflyt_tpu_torch.envs.packed_quadx_waypoints import PackedQuadXWaypointsEnv, PackedWaypointsState
from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
from pyflyt_tpu_torch.envs.quadx_waypoints import QuadXWaypointsEnv, QuadXWaypointsState
from pyflyt_tpu_torch.envs.utils.flatten_waypoints import FlattenWaypointEnv, flatten_waypoint_obs
from pyflyt_tpu_torch.envs.utils.waypoints import WaypointHandler, WaypointState

__all__ = [
    "FixedwingWaypointsEnv",
    "FixedwingWaypointsState",
    "FlattenWaypointEnv",
    "PackedFixedwingWaypointsEnv",
    "PackedQuadXHoverEnv",
    "PackedQuadXWaypointsEnv",
    "PackedWaypointsState",
    "QuadXHoverEnv",
    "QuadXWaypointsEnv",
    "QuadXWaypointsState",
    "WaypointHandler",
    "WaypointState",
    "flatten_waypoint_obs",
]
