"""Fused actor-critic forward (port of
``pyflyt_tpu/ops/pallas_policy.py::build_policy_value_forward``). The
parameter leaves (``leaf_specs``, ``params_to_leaves``) live in
``ops/cuda_sgd.py``, as in the JAX package, and are imported here.

``policy_value_forward`` launches the CUDA kernel
``csrc/policy_value_forward.cu`` for CUDA tensors and runs
``policy_value_forward_plain``, its plain PyTorch twin, for CPU tensors;
a CUDA tensor launches the kernel or raises. Arithmetic of the Pallas
kernel: bf16 matmul inputs with f32 accumulation, f32 bias and tanh.

Bound on an H100 at 8192 rows: about 2.34 GFLOP on the bf16 tensor cores
(about 2.4 µs at 989 TFLOP/s) against under 1.2 MB of traffic, so
operations bound it. The kernel supports the rollouts' shapes: obs width
at most 64 (padded to the next multiple of 32 inside the kernel: 21 and
16 to 32, the waypoints env's 33 to 64), two 256-wide tanh layers per
trunk, any number of rows and actions. The twin takes any widths.

Weights are converted to bf16 once (``prepare_weights``), which gives the
same values as the Pallas kernel's per-call cast: both round to nearest
even.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
from torch import Tensor

from pyflyt_tpu_torch.ops.cuda_build import Kernel
from pyflyt_tpu_torch.ops.cuda_sgd import leaf_specs, params_to_leaves  # noqa: F401

HIDDEN = 256
MAX_OBS_DIM = 64


@dataclasses.dataclass
class PolicyWeights:
    """The forward's weights: bf16 (in, out) matrices, f32 biases."""

    pi_w: list[Tensor]
    pi_b: list[Tensor]
    pi_head_w: Tensor
    pi_head_b: Tensor
    vf_w: list[Tensor]
    vf_b: list[Tensor]
    vf_head_w: Tensor
    vf_head_b: Tensor

    @property
    def obs_dim(self) -> int:
        return self.pi_w[0].shape[0]

    @property
    def act_dim(self) -> int:
        return self.pi_head_w.shape[1]


def prepare_weights(leaves: list[Tensor], n_pi: int, n_vf: int) -> PolicyWeights:
    """Ordered leaves → ``PolicyWeights`` (one bf16 cast, contiguous)."""
    # copies, never views of the parameters: the set stays as converted
    w = lambda t: t.detach().to(torch.bfloat16, copy=True).contiguous()  # noqa: E731
    b = lambda t: t.detach().to(torch.float32, copy=True).reshape(-1).contiguous()  # noqa: E731
    i_head = 2 * n_pi
    i_vf0 = i_head + 3  # skip pi_head w/b + log_std
    i_vf_head = i_vf0 + 2 * n_vf
    return PolicyWeights(
        pi_w=[w(leaves[2 * i]) for i in range(n_pi)],
        pi_b=[b(leaves[2 * i + 1]) for i in range(n_pi)],
        pi_head_w=w(leaves[i_head]),
        pi_head_b=b(leaves[i_head + 1]),
        vf_w=[w(leaves[i_vf0 + 2 * i]) for i in range(n_vf)],
        vf_b=[b(leaves[i_vf0 + 2 * i + 1]) for i in range(n_vf)],
        vf_head_w=w(leaves[i_vf_head]),
        vf_head_b=b(leaves[i_vf_head + 1]),
    )


def _mm(a: Tensor, w_bf16: Tensor) -> Tensor:
    """a @ w with bf16-rounded inputs and f32 accumulation."""
    return a.to(torch.bfloat16).to(torch.float32) @ w_bf16.to(torch.float32)


def policy_value_forward_plain(obs: Tensor, w: PolicyWeights) -> tuple[Tensor, Tensor]:
    """The kernel's arithmetic in plain PyTorch: ``(mean (n, act), value (n,))``."""
    a = obs
    for W, b in zip(w.pi_w, w.pi_b):
        a = torch.tanh(_mm(a, W) + b)
    mean = _mm(a, w.pi_head_w) + w.pi_head_b
    a = obs
    for W, b in zip(w.vf_w, w.vf_b):
        a = torch.tanh(_mm(a, W) + b)
    value = _mm(a, w.vf_head_w) + w.vf_head_b
    return mean, value[:, 0]


class _ForwardArgsC(ctypes.Structure):
    """Mirror of ``struct ForwardArgs`` in csrc/policy_value_forward.cu."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "obs", "pi_w0", "pi_b0", "pi_w1", "pi_b1", "pi_hw", "pi_hb",
            "vf_w0", "vf_b0", "vf_w1", "vf_b1", "vf_hw", "vf_hb", "mean", "value",
        )
    ] + [("n", ctypes.c_int), ("obs_dim", ctypes.c_int), ("act_dim", ctypes.c_int)]


KERNEL = Kernel(
    "policy_value_forward.cu",
    "policy_value_forward",
    [ctypes.c_void_p, ctypes.c_void_p],  # args (host struct), stream
)


def _check_kernel_shapes(obs: Tensor, w: PolicyWeights) -> None:
    tensors = [*w.pi_w, *w.pi_b, w.pi_head_w, w.pi_head_b,
               *w.vf_w, *w.vf_b, w.vf_head_w, w.vf_head_b]
    if any(t.device != obs.device for t in tensors):
        raise ValueError("weights and obs must be on one device")
    widths = [t.shape[1] for t in (*w.pi_w, *w.vf_w)]
    if len(w.pi_w) != 2 or len(w.vf_w) != 2 or any(h != HIDDEN for h in widths):
        raise NotImplementedError(
            f"the CUDA forward covers two {HIDDEN}-wide layers per trunk, got "
            f"pi {[t.shape[1] for t in w.pi_w]} vf {[t.shape[1] for t in w.vf_w]}"
        )
    if not 0 < w.obs_dim <= MAX_OBS_DIM or w.vf_w[0].shape[0] != w.obs_dim:
        raise NotImplementedError(f"obs width {w.obs_dim} outside 1..{MAX_OBS_DIM}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("weights must be contiguous and 16-byte aligned")
    if any(t.dtype != torch.bfloat16 for t in (*w.pi_w, *w.vf_w, w.pi_head_w, w.vf_head_w)):
        raise ValueError("weight matrices must be bf16 (prepare_weights)")


def policy_value_forward(obs: Tensor, w: PolicyWeights) -> tuple[Tensor, Tensor]:
    """Actor mean ``(n, act)`` and critic value ``(n,)`` of ``obs`` (n, obs_dim) f32."""
    if obs.dtype != torch.float32 or obs.dim() != 2 or obs.shape[1] != w.obs_dim:
        raise ValueError(f"obs must be (n, {w.obs_dim}) float32, got {tuple(obs.shape)} {obs.dtype}")
    if obs.device.type == "cpu":
        return policy_value_forward_plain(obs, w)
    if obs.device.type != "cuda":
        raise ValueError(f"unsupported device {obs.device}")
    _check_kernel_shapes(obs, w)
    obs = obs.contiguous()
    n = obs.shape[0]
    mean = torch.empty((n, w.act_dim), dtype=torch.float32, device=obs.device)
    value = torch.empty((n,), dtype=torch.float32, device=obs.device)
    args = _ForwardArgsC(
        obs.data_ptr(),
        w.pi_w[0].data_ptr(), w.pi_b[0].data_ptr(),
        w.pi_w[1].data_ptr(), w.pi_b[1].data_ptr(),
        w.pi_head_w.data_ptr(), w.pi_head_b.data_ptr(),
        w.vf_w[0].data_ptr(), w.vf_b[0].data_ptr(),
        w.vf_w[1].data_ptr(), w.vf_b[1].data_ptr(),
        w.vf_head_w.data_ptr(), w.vf_head_b.data_ptr(),
        mean.data_ptr(), value.data_ptr(),
        n, w.obs_dim, w.act_dim,
    )
    with torch.cuda.device(obs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.fn()(ctypes.addressof(args), stream)
    KERNEL.check(rc)
    KERNEL.launches += 1
    return mean, value


def forward_flops(n: int, w: PolicyWeights) -> int:
    """Operations the forward needs for ``n`` rows (2 per multiply-add,
    unpadded widths) — the operation side of the kernel's bound."""
    macs = 0
    for trunk, head in ((w.pi_w, w.pi_head_w), (w.vf_w, w.vf_head_w)):
        macs += sum(W.shape[0] * W.shape[1] for W in trunk) + head.shape[0] * head.shape[1]
    return 2 * n * macs
