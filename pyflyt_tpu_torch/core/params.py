"""Vehicle parameter loading (port of ``pyflyt_tpu/core/params.py``).

The port keeps its own copy of each vehicle file as JSON under
``pyflyt_tpu_torch/assets/vehicles/``, read with ``json``: the machine with
the card has no pyyaml. The values are those of the JAX package's YAML
files (a test holds the two equal).
"""

from __future__ import annotations

import json
import os

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")


def load_vehicle_json(name: str, model_dir: str | None = None) -> dict:
    """Loads ``<model_dir>/<name>.json`` (defaults to the bundled assets).
    Each call parses the file anew, so callers may edit the result."""
    directory = model_dir or os.path.join(ASSET_DIR, "vehicles")
    with open(os.path.join(directory, f"{name}.json"), encoding="utf-8") as f:
        return json.load(f)
