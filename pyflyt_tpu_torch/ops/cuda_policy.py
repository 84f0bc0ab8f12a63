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
operations bound it. The kernel (``csrc/policy_mlp.cuh``: wgmma on
weights resident in shared memory) supports the rollouts' shapes: obs
width at most 64, two 256-wide tanh layers per trunk, at most 8 actions,
any number of rows; narrower trunks (1 to 4 layers of at most 128 units)
go to K4n (``ops/cuda_narrow.py``), every other network to K4g
(``ops/cuda_general.py``), and ``cuda_sgd._check_envelope`` decides
which. The twin takes any widths.

Weights are converted to bf16 once (``prepare_weights``), which gives the
same values as the Pallas kernel's per-call cast: both round to nearest
even. For the kernel each trunk is also packed into its shared-memory
image (``pack_trunk``): the bytes the kernel's bulk copies land and its
wgmma descriptors read, so no thread of the kernel rearranges a weight.
``unpack_trunk`` is its plain inverse.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
from torch import Tensor

from pyflyt_tpu_torch.ops import cuda_general, cuda_narrow, cuda_sgd
from pyflyt_tpu_torch.ops.cuda_build import Kernel
from pyflyt_tpu_torch.ops.cuda_sgd import leaf_specs, params_to_leaves  # noqa: F401

HIDDEN = 256
MAX_OBS_DIM = 64
HEAD_N = 8  # head outputs in the image: the actions (<= 8) or the value, zero-padded

# One trunk's image (csrc/policy_mlp.cuh's Smem regions, in this order):
# bf16 matrices W (in, out) stored K-major, as out rows of in, in 64-deep
# K-chunks with the 128-byte swizzle (``swizzle_offset``), then the f32
# biases. Every region starts 16-byte aligned and is a multiple of 16
# bytes, as the bulk copies need.
KC = 64  # K a chunk: one 128-byte row of bf16
W0_BYTES = HIDDEN * KC * 2  # layer 0: K zero-padded to one chunk
W1_BYTES = HIDDEN * HIDDEN * 2  # layer 1: 4 chunks
HW_BYTES = HEAD_N * HIDDEN * 2  # the head: 8 rows, 4 chunks
W1_OFF = W0_BYTES
HW_OFF = W1_OFF + W1_BYTES
B0_OFF = HW_OFF + HW_BYTES
B1_OFF = B0_OFF + HIDDEN * 4
HB_OFF = B1_OFF + HIDDEN * 4
TRUNK_BYTES = HB_OFF + HEAD_N * 4


def swizzle_offset(k, n, rows: int):
    """Byte offset of entry ``(k, n)`` of a weight ``W (K, rows)`` in its
    image: chunk ``k // 64`` of ``rows`` 128-byte rows, row ``n``, the
    16-byte group ``(k % 64) // 8`` swizzled by ``n % 8``. Ints or integer
    tensors. The kernel's copy of this formula is the top comment of
    ``csrc/policy_mlp.cuh``, which its ``sw128_desc`` descriptors address;
    the two must agree."""
    return (k // KC) * rows * 128 + n * 128 + ((((k % KC) // 8) ^ (n % 8)) * 16) + (k % 8) * 2


@functools.lru_cache(maxsize=16)
def _image_index(obs_dim: int, outs: int, device: str) -> Tensor:
    """bf16 slot of each entry of ``cat([w0, w1, hw])`` (row-major) in a
    trunk's image."""
    def slots(k_dim, n_dim, rows, base):
        k, n = torch.meshgrid(torch.arange(k_dim), torch.arange(n_dim), indexing="ij")
        return (base + swizzle_offset(k, n, rows)).reshape(-1) // 2

    return torch.cat([slots(obs_dim, HIDDEN, HIDDEN, 0), slots(HIDDEN, HIDDEN, HIDDEN, W1_OFF),
                      slots(HIDDEN, outs, HEAD_N, HW_OFF)]).to(device)


@functools.lru_cache(maxsize=16)
def _gather_index(obs_dim: int, outs: int, device: str) -> Tensor:
    """For each 16-bit word of a trunk's image, the word ``pack_trunk``
    copies into it from ``[bf16(src) | src's f32 words | 0]``, where
    ``src`` is ``cat([w0, w1, hw, b0, b1, hb])`` in f32: a matrix entry's
    bf16, a bias's two f32 halves, and the zero word for the padding."""
    n_mats = (obs_dim + HIDDEN + outs) * HIDDEN
    n_src = n_mats + 2 * HIDDEN + outs
    g = torch.full((TRUNK_BYTES // 2,), 3 * n_src, dtype=torch.int64)
    g[_image_index(obs_dim, outs, "cpu")] = torch.arange(n_mats)
    bias_words = 2 * (2 * HIDDEN + outs)
    g[B0_OFF // 2 : B0_OFF // 2 + bias_words] = n_src + 2 * n_mats + torch.arange(bias_words)
    return g.to(device)


def pack_trunk(w0: Tensor, b0: Tensor, w1: Tensor, b1: Tensor, hw: Tensor, hb: Tensor) -> Tensor:
    """One trunk's weights (flax layout: ``w0 (obs, 256)``, ``w1 (256,
    256)``, ``hw (256, outs)``, biases of any shape) → its image, a
    ``(TRUNK_BYTES,)`` uint8 tensor on their device: the matrices rounded
    to bf16 (nearest even), the biases f32, the padding zero. One gather
    (``_gather_index``), so a few small ops in all."""
    obs_dim, outs = w0.shape[0], hw.shape[1]
    if w0.shape[1] != HIDDEN or w1.shape != (HIDDEN, HIDDEN) or hw.shape[0] != HIDDEN:
        raise NotImplementedError(f"the kernel's image holds two {HIDDEN}-wide layers")
    if not 0 < obs_dim <= MAX_OBS_DIM or not 0 < outs <= HEAD_N:
        raise NotImplementedError(f"obs width {obs_dim} outside 1..{MAX_OBS_DIM} or {outs} outputs outside 1..{HEAD_N}")
    src = torch.cat([t.detach().reshape(-1).float() for t in (w0, w1, hw, b0, b1, hb)])
    words = torch.cat([src.to(torch.bfloat16).view(torch.int16), src.view(torch.int16),
                       src.new_zeros(1, dtype=torch.int16)])
    return words[_gather_index(obs_dim, outs, str(src.device))].view(torch.uint8)


def unpack_trunk(image: Tensor, obs_dim: int, outs: int) -> tuple[Tensor, ...]:
    """``pack_trunk``'s inverse: ``(w0, b0, w1, b1, hw, hb)`` with the
    matrices bf16 ``(in, out)`` and the biases f32 ``(out,)``."""
    mats = image[:B0_OFF].view(torch.bfloat16)[_image_index(obs_dim, outs, str(image.device))]
    n0, n1 = obs_dim * HIDDEN, HIDDEN * HIDDEN
    biases = image[B0_OFF:].view(torch.float32)
    return (mats[:n0].reshape(obs_dim, HIDDEN), biases[:HIDDEN].clone(),
            mats[n0 : n0 + n1].reshape(HIDDEN, HIDDEN), biases[HIDDEN : 2 * HIDDEN].clone(),
            mats[n0 + n1 :].reshape(HIDDEN, outs), biases[2 * HIDDEN : 2 * HIDDEN + outs].clone())


def image_pointers(image: Tensor) -> list[int]:
    """The kernel's six weight pointers into a trunk's image: w0, b0, w1,
    b1, hw, hb."""
    base = image.data_ptr()
    return [base + off for off in (0, B0_OFF, W1_OFF, B1_OFF, HW_OFF, HB_OFF)]


@dataclasses.dataclass
class PolicyWeights:
    """The forward's weights: bf16 (in, out) matrices, f32 biases (the
    twin's), and each trunk's image (its kernel family's, ``prepare_weights``;
    None where the two trunks read different obs widths)."""

    pi_w: list[Tensor]
    pi_b: list[Tensor]
    pi_head_w: Tensor
    pi_head_b: Tensor
    vf_w: list[Tensor]
    vf_b: list[Tensor]
    vf_head_w: Tensor
    vf_head_b: Tensor
    pi_image: Tensor | None = None
    vf_image: Tensor | None = None

    @property
    def obs_dim(self) -> int:
        return (self.pi_w[0] if self.pi_w else self.pi_head_w).shape[0]

    @property
    def act_dim(self) -> int:
        return self.pi_head_w.shape[1]


def _kernel_family(w: PolicyWeights) -> str:
    """The kernel family of ``w``'s shapes (``cuda_sgd._check_envelope``);
    raises ``NotImplementedError`` where the trunks read different obs
    widths."""
    if (w.vf_w[0] if w.vf_w else w.vf_head_w).shape[0] != w.obs_dim:
        raise NotImplementedError("actor and critic read different obs widths")
    return cuda_sgd._check_envelope(w.obs_dim, w.act_dim, [t.shape[1] for t in w.pi_w],
                                    [t.shape[1] for t in w.vf_w])


def prepare_weights(leaves: list[Tensor], n_pi: int, n_vf: int) -> PolicyWeights:
    """Ordered leaves → ``PolicyWeights`` (one bf16 cast, contiguous), with
    the trunks' images for their kernel family."""
    # copies, never views of the parameters: the set stays as converted
    w = lambda t: t.detach().to(torch.bfloat16, copy=True).contiguous()  # noqa: E731
    b = lambda t: t.detach().to(torch.float32, copy=True).reshape(-1).contiguous()  # noqa: E731
    i_head = 2 * n_pi
    i_vf0 = i_head + 3  # skip pi_head w/b + log_std
    i_vf_head = i_vf0 + 2 * n_vf
    out = PolicyWeights(
        pi_w=[w(leaves[2 * i]) for i in range(n_pi)],
        pi_b=[b(leaves[2 * i + 1]) for i in range(n_pi)],
        pi_head_w=w(leaves[i_head]),
        pi_head_b=b(leaves[i_head + 1]),
        vf_w=[w(leaves[i_vf0 + 2 * i]) for i in range(n_vf)],
        vf_b=[b(leaves[i_vf0 + 2 * i + 1]) for i in range(n_vf)],
        vf_head_w=w(leaves[i_vf_head]),
        vf_head_b=b(leaves[i_vf_head + 1]),
    )
    try:
        family = _kernel_family(out)
    except NotImplementedError:
        return out
    if family == "wide":
        out.pi_image = pack_trunk(out.pi_w[0], out.pi_b[0], out.pi_w[1], out.pi_b[1], out.pi_head_w, out.pi_head_b)
        out.vf_image = pack_trunk(out.vf_w[0], out.vf_b[0], out.vf_w[1], out.vf_b[1], out.vf_head_w, out.vf_head_b)
    elif family == "general":  # the images of K4g's route (cuda_general.forward_route)
        out.pi_image, out.vf_image = cuda_general.trunk_images(out, leaves, n_pi)
    else:
        out.pi_image = cuda_narrow.pack_trunk(out.pi_w, out.pi_b, out.pi_head_w, out.pi_head_b)
        out.vf_image = cuda_narrow.pack_trunk(out.vf_w, out.vf_b, out.vf_head_w, out.vf_head_b)
    return out


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


def _check_kernel_shapes(obs: Tensor, w: PolicyWeights) -> str:
    """Raises unless the kernel can run ``w`` on ``obs``; returns the
    kernel family."""
    family = _kernel_family(w)
    images = (w.pi_image, w.vf_image)
    if family == "wide":
        sizes = [(TRUNK_BYTES,)] * 2
    elif family == "general":
        sizes = cuda_general.image_sizes(w)
    else:
        sizes = [(lay.bytes,) for lay in cuda_narrow.weight_layouts(w)]
    if any(t is None or t.dtype != torch.uint8 for t in images) or [tuple(t.shape) for t in images] != sizes:
        raise ValueError("the kernel reads the trunks' images (prepare_weights)")
    if any(t.device != obs.device for t in images):
        raise ValueError("weights and obs must be on one device")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in images):
        raise ValueError("weight images must be contiguous and 16-byte aligned")
    return family


def policy_value_forward(obs: Tensor, w: PolicyWeights) -> tuple[Tensor, Tensor]:
    """Actor mean ``(n, act)`` and critic value ``(n,)`` of ``obs`` (n, obs_dim) f32."""
    if obs.dtype != torch.float32 or obs.dim() != 2 or obs.shape[1] != w.obs_dim:
        raise ValueError(f"obs must be (n, {w.obs_dim}) float32, got {tuple(obs.shape)} {obs.dtype}")
    if obs.device.type == "cpu":
        return policy_value_forward_plain(obs, w)
    if obs.device.type != "cuda":
        raise ValueError(f"unsupported device {obs.device}")
    family = _check_kernel_shapes(obs, w)
    obs = obs.contiguous()
    if family == "general":
        return cuda_general.forward(obs, w)
    if family == "narrow":
        return cuda_narrow.forward(obs, w)
    n = obs.shape[0]
    mean = torch.empty((n, w.act_dim), dtype=torch.float32, device=obs.device)
    value = torch.empty((n,), dtype=torch.float32, device=obs.device)
    args = _ForwardArgsC(
        obs.data_ptr(), *image_pointers(w.pi_image), *image_pointers(w.vf_image),
        mean.data_ptr(), value.data_ptr(), n, w.obs_dim, w.act_dim,
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
