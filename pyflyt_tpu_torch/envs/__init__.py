"""Batched QuadX, Fixedwing and Rocket task envs of the port
(``reset(num_envs, generator)`` and ``step(state, action)`` take the whole
batch; the multi-agent envs take ``(N, n, ...)`` arenas)."""

from pyflyt_tpu_torch.envs.fixedwing_waypoints import FixedwingWaypointsEnv, FixedwingWaypointsState
from pyflyt_tpu_torch.envs.ma_fixedwing_dogfight import DogfightState, MAFixedwingDogfightEnv
from pyflyt_tpu_torch.envs.ma_quadx_hover import MAQuadXHoverEnv, MAQuadXState, MAStepOut
from pyflyt_tpu_torch.envs.packed_dogfight import PackedDogfightEnvState, PackedMAFixedwingDogfightEnv
from pyflyt_tpu_torch.envs.packed_fixedwing_waypoints import PackedFixedwingWaypointsEnv
from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv
from pyflyt_tpu_torch.envs.packed_quadx_waypoints import PackedQuadXWaypointsEnv, PackedWaypointsState
from pyflyt_tpu_torch.envs.packed_rocket_landing import PackedRocketEnvState, PackedRocketLandingEnv
from pyflyt_tpu_torch.envs.quadx_gates import QuadXGatesEnv, QuadXGatesState
from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
from pyflyt_tpu_torch.envs.quadx_waypoints import QuadXWaypointsEnv, QuadXWaypointsState
from pyflyt_tpu_torch.envs.rocket_landing import RocketLandingEnv, RocketLandingState
from pyflyt_tpu_torch.envs.selfplay_dogfight import SelfPlayDogfightEnv
from pyflyt_tpu_torch.envs.utils.flatten_waypoints import FlattenWaypointEnv, flatten_waypoint_obs
from pyflyt_tpu_torch.envs.utils.waypoints import WaypointHandler, WaypointState

__all__ = [
    "DogfightState",
    "FixedwingWaypointsEnv",
    "FixedwingWaypointsState",
    "FlattenWaypointEnv",
    "MAFixedwingDogfightEnv",
    "MAQuadXHoverEnv",
    "MAQuadXState",
    "MAStepOut",
    "PackedDogfightEnvState",
    "PackedFixedwingWaypointsEnv",
    "PackedMAFixedwingDogfightEnv",
    "PackedQuadXHoverEnv",
    "PackedQuadXWaypointsEnv",
    "PackedRocketEnvState",
    "PackedRocketLandingEnv",
    "PackedWaypointsState",
    "QuadXGatesEnv",
    "QuadXGatesState",
    "QuadXHoverEnv",
    "QuadXWaypointsEnv",
    "QuadXWaypointsState",
    "RocketLandingEnv",
    "RocketLandingState",
    "SelfPlayDogfightEnv",
    "WaypointHandler",
    "WaypointState",
    "flatten_waypoint_obs",
]
