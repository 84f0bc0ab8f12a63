"""The PyTorch port's package boundary: what it imports, its own vehicle
file, its device rule and its kernel build failing loudly."""

import ctypes
import json
import os
import pkgutil
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import pyflyt_tpu_torch
from pyflyt_tpu.core.params import load_vehicle_yaml
from pyflyt_tpu_torch.core.params import load_vehicle_json
from pyflyt_tpu_torch.ops import cuda_build, cuda_policy, cuda_quadx

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_submodules():
    return sorted(
        m.name for m in pkgutil.walk_packages(pyflyt_tpu_torch.__path__, "pyflyt_tpu_torch.")
    )


def test_import_leaves_no_jax_flax_yaml_or_reference_package():
    """Importing the port and every submodule in a fresh interpreter loads
    no JAX, flax, optax, orbax, pyyaml or pyflyt_tpu module."""
    mods = _all_submodules()
    assert "pyflyt_tpu_torch.ops.cuda_quadx" in mods and "pyflyt_tpu_torch.convert" in mods
    assert "pyflyt_tpu_torch.rl.train" in mods and "pyflyt_tpu_torch.ops.cuda_sgd" in mods
    assert "pyflyt_tpu_torch.rl_training.hovering" in mods and "pyflyt_tpu_torch.core.wind" in mods
    assert "pyflyt_tpu_torch.ops.cuda_fixedwing" in mods and "pyflyt_tpu_torch.envs.packed_fixedwing_waypoints" in mods
    code = textwrap.dedent(f"""
        import importlib, json, sys
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "jaxlib", "flax", "yaml", "optax", "orbax", "pyflyt_tpu"))
        print(json.dumps(bad))
    """)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
        timeout=240, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("name", ["cf2x", "fixedwing", "acrowing", "rocket", "primitive_drone"])
def test_vehicle_json_equals_reference_yaml(name):
    assert load_vehicle_json(name) == load_vehicle_yaml(name)


def test_vehicle_json_is_a_fresh_copy():
    a = load_vehicle_json("cf2x")
    a["frame"]["mass"] = 1.0
    assert load_vehicle_json("cf2x")["frame"]["mass"] == 0.027


@pytest.mark.parametrize(
    "entry", ["hover_env", "packed_env", "actor_critic", "resolve", "build_params", "quat_identity",
              "mod_hover_env", "packed_mod_hover_env", "gaussian_wind", "cli_env", "fixedwing_params",
              "fixedwing_env", "packed_fixedwing_env", "archived_policy"]
)
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, entry):
    from pyflyt_tpu_torch.core import math as tm
    from pyflyt_tpu_torch.core.wind import GaussianWind
    from pyflyt_tpu_torch.envs import FixedwingWaypointsEnv, PackedFixedwingWaypointsEnv
    from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv
    from pyflyt_tpu_torch.envs.quadx_mod import PackedQuadXModHoveringEnv
    from pyflyt_tpu_torch.rl_training import hovering
    from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
    from pyflyt_tpu_torch.envs.quadx_mod import QuadXModHoveringEnv
    from pyflyt_tpu_torch.models import fixedwing, quadx
    from pyflyt_tpu_torch.rl import checkpoint
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = {
        "hover_env": lambda: QuadXHoverEnv(),
        "packed_env": lambda: PackedQuadXHoverEnv(),
        "actor_critic": lambda: ActorCritic(21, 4),
        "resolve": lambda: pyflyt_tpu_torch.resolve_device(),
        "build_params": lambda: quadx.build_params(quadx.QuadXConfig()),
        "quat_identity": lambda: tm.quat_identity((2,)),
        "mod_hover_env": lambda: QuadXModHoveringEnv(flight_mode=9),
        "packed_mod_hover_env": lambda: PackedQuadXModHoveringEnv.create(flight_mode=9),
        "gaussian_wind": lambda: GaussianWind.init(None, 2, base_wind=(0.0, 0.0, 0.0)),
        "cli_env": lambda: hovering.main(["eval", "--flight_mode", "9", "--checkpoint", "unused"]),
        "fixedwing_params": lambda: fixedwing.build_params(fixedwing.FixedwingConfig()),
        "fixedwing_env": lambda: FixedwingWaypointsEnv(),
        "packed_fixedwing_env": lambda: PackedFixedwingWaypointsEnv(),
        "archived_policy": lambda: checkpoint.load_policy_npz("fixedwing_r5_lr3e-4_seed0"),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    """A kernel whose nvcc fails raises at first use and leaves no library."""
    fake = tmp_path / "cuda" / "bin"
    fake.mkdir(parents=True)
    nvcc = fake / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: fake compiler refuses' >&2\nexit 3\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    kernel = cuda_build.Kernel(cuda_quadx.KERNEL.source, cuda_quadx.KERNEL.symbol, [])
    with pytest.raises(RuntimeError, match="fake compiler refuses"):
        kernel.fn()
    assert not list((tmp_path / "build").glob("*.so"))
    assert kernel.launches == 0


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.nvcc_path()


def test_library_name_tracks_source_digest():
    a = cuda_build.library_path("quadx_hover_step.cu")
    b = cuda_build.library_path("policy_value_forward.cu")
    assert a.parent == cuda_build.BUILD_DIR and a.suffix == ".so"
    assert a.name.startswith("quadx_hover_step-") and a != b
    assert a == cuda_build.library_path("quadx_hover_step.cu")


def test_cpu_tensors_run_the_plain_twins_and_count_no_launch():
    from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv
    from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    env = PackedQuadXHoverEnv(base=QuadXHoverEnv(noisy_motors=False, device="cpu"))
    st, obs = env.reset(5)
    before = (cuda_quadx.KERNEL.launches, cuda_policy.KERNEL.launches)
    env.step(st, torch.zeros(5, 4))
    net = ActorCritic(obs.shape[1], 4, feature_sizes=(8, 8), device="cpu")
    cuda_policy.policy_value_forward(obs, net.kernel_weights())
    assert (cuda_quadx.KERNEL.launches, cuda_policy.KERNEL.launches) == before


@pytest.mark.parametrize(
    "bad",
    ["rows", "dtype", "seed_dtype", "mode"],
)
def test_hover_wrapper_rejects_bad_arguments(bad):
    packed = torch.zeros(cuda_quadx.ROWS, 3)
    seed = torch.zeros(1, dtype=torch.int64)
    mode = 0
    if bad == "rows":
        packed = torch.zeros(cuda_quadx.ROWS - 1, 3)
    elif bad == "dtype":
        packed = packed.double()
    elif bad == "seed_dtype":
        seed = seed.int()
    else:
        mode = 9
    exc = NotImplementedError if bad == "mode" else ValueError
    with pytest.raises(exc):
        cuda_quadx.packed_hover_step(packed, seed, None, mode, False)


def test_hover_consts_layout_matches_the_c_struct():
    """The kernel reads its constants as ``struct HoverConsts``: the ctypes
    mirror must list the same fields, types and array lengths in order."""
    src = (cuda_build.CSRC / cuda_quadx.KERNEL.source).read_text()
    body = re.search(r"struct HoverConsts \{(.*?)\};", src, re.S).group(1)
    c_fields = [
        (name, ctype, int(n or 1))
        for ctype, name, n in re.findall(r"^\s*(float|int) (\w+)(?:\[(\d+)\])?;", body, re.M)
    ]
    py_fields = []
    for name, t in cuda_quadx._HoverConstsC._fields_:
        n, base = (t._length_, t._type_) if issubclass(t, ctypes.Array) else (1, t)
        py_fields.append((name, {ctypes.c_float: "float", ctypes.c_int: "int"}[base], n))
    assert len(c_fields) == len(cuda_quadx.dataclasses.fields(cuda_quadx.HoverConsts))
    assert py_fields == c_fields


def test_pack_unpack_round_trip():
    from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv

    env = QuadXHoverEnv(noisy_motors=False, device="cpu")
    st, _ = env.reset(6)
    drone = st.drone
    g = torch.Generator().manual_seed(0)
    drone.body.pos = torch.randn(6, 3, generator=g)
    drone.throttle = torch.rand(6, 4, generator=g)
    drone.contact = torch.tensor([True, False] * 3)
    packed = cuda_quadx.pack_state(drone)
    assert packed.shape == (cuda_quadx.ROWS, 6) and packed.is_contiguous()
    back = cuda_quadx.unpack_state(packed, drone)
    for a, b in ((back.body.pos, drone.body.pos), (back.throttle, drone.throttle),
                 (back.read.view, drone.read.view), (back.contact, drone.contact)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
