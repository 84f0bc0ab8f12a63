"""PyTorch/CUDA port of ``pyflyt_tpu`` for NVIDIA Hopper (H100).

Module paths mirror the JAX package: ``pyflyt_tpu_torch/core/math.py`` is
the counterpart of ``pyflyt_tpu/core/math.py``, and a Pallas module
``ops/pallas_X.py`` becomes ``ops/cuda_X.py`` with its CUDA C++ sources in
``csrc/``. The port imports ``torch`` and numpy only: never JAX, flax,
pyyaml or any module of ``pyflyt_tpu``.

Entry points (``QuadXHoverEnv``, ``PackedQuadXHoverEnv``, ``ActorCritic``,
the rollout and the kernel wrappers) run on the card unless the caller
passes ``device="cpu"``; without CUDA they raise instead of falling back.
Each kernel wrapper launches its hand-written kernel for CUDA tensors and
runs its plain PyTorch twin only for CPU tensors.
"""

from pyflyt_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
