"""State dataclasses for the batched flight-dynamics core (port of
``pyflyt_tpu/core/state.py``).

Where the JAX package uses ``flax.struct`` pytrees, the port uses plain
dataclasses of tensors with the batch dimension written out in front.
``tree_map`` stands in for ``jax.tree.map`` over those dataclasses.

Frame conventions (see core/math.py): ``pos`` world ENU, ``quat`` body→world
xyzw, ``lin_vel`` and ``ang_vel`` in the world frame.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from torch import Tensor


@dataclasses.dataclass
class Body6DoF:
    """Rigid-body state integrated by the 6-DoF integrator."""

    pos: Tensor  # (..., 3) world ENU
    quat: Tensor  # (..., 4) xyzw, body -> world
    lin_vel: Tensor  # (..., 3) world frame
    ang_vel: Tensor  # (..., 3) world frame


def tree_map(fn: Callable[..., Tensor], first: Any, *rest: Any) -> Any:
    """Applies ``fn`` leaf by leaf over matching dataclasses/dicts of tensors.

    Tensor leaves are mapped; any other leaf (a generator, a Python number,
    None) is taken from ``first`` unchanged.
    """
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        kw = {
            f.name: tree_map(
                fn, getattr(first, f.name), *(getattr(r, f.name) for r in rest)
            )
            for f in dataclasses.fields(first)
        }
        return type(first)(**kw)
    if isinstance(first, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in first.items()}
    if isinstance(first, Tensor):
        return fn(first, *rest)
    return first
