"""Core simulation machinery: math, state dataclasses, integrator, wind,
camera and the aviary."""

from pyflyt_tpu_torch.core.aviary import Aviary, AviaryState, DroneSpec, register_drone_type  # noqa: F401
from pyflyt_tpu_torch.core.load_objs import boxes_from_mesh, loadOBJ, merge_boxes  # noqa: F401
