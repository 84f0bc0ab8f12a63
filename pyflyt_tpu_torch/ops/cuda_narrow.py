"""The narrow trunks' kernels: K4n, K3n and K2n (ports of
``pyflyt_tpu/ops/pallas_policy.py::build_policy_value_forward`` and
``pyflyt_tpu/ops/pallas_sgd.py::build_logp_forward`` / ``build_fused_epoch``
at the trunks the 2 x 256 wgmma kernels do not take).

The family covers every actor-critic with 1 to ``MAX_DEPTH`` tanh layers a
trunk, each at most ``MAX_WIDTH`` wide, obs widths up to ``MAX_OBS_DIM`` and
at most ``MAX_ACT_DIM`` actions (``cuda_sgd``'s limits), actor and critic trunks that may differ: the
trajectory-following network ``(64, 64, 32, 32)``, the ``(32, 32)`` of the
mesh curves, ``(128,)``. ``cuda_sgd._check_envelope`` routes a network here
(``"narrow"``), to the 2 x 256 kernels (``"wide"``) or to every other
trunk's (``"general"``, ``ops/cuda_general.py``). The arithmetic is the Pallas kernels': bf16 matmul inputs rounded to
nearest even, f32 accumulation, bias, tanh, loss, clip and Adam in f32.

Each trunk reaches its kernel as one image (``pack_trunk``; the layout is
``csrc/policy_narrow.cuh``'s top comment): per layer and the head, ``W^T``
as bf16 rows of the padded input width plus 8, every width padded to a
multiple of 16 with zeros, then the f32 biases. K2n's Adam writes the next
minibatch's images itself (``image_slots`` is its rule, written once more
in ``csrc/fused_epoch_narrow.cu::write_image``).

The wrappers launch their kernel for CUDA tensors only; ``cuda_policy``
and ``cuda_sgd`` call them after their CPU branch, where the plain twins
run. Nothing here is built or loaded at import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
from torch import Tensor

from pyflyt_tpu_torch.ops import cuda_sgd
from pyflyt_tpu_torch.ops.cuda_build import Kernel
from pyflyt_tpu_torch.ops.cuda_sgd import MAX_DEPTH

HEAD_PAD = 16  # the head's outputs in the image
TILE_ROWS = 64  # rows a block tile (4 warps of 16)
WARPS = 4
LAYERS = MAX_DEPTH + 1  # the C arrays: the tanh layers and the head
NPART = 4  # K2n's per-tile partial sums: pg_min, verr^2, old - logp, unused
KERNELS_PER_MINIBATCH = 3  # fwd_bwd, reduce, adam
KERNELS_PER_CALL = 1  # the first minibatch's images
_THREADS = 256  # K2n's reduce and Adam blocks


def _pad16(x: int) -> int:
    return -(-x // 16) * 16


@dataclasses.dataclass(frozen=True)
class Layout:
    """One trunk's image: per layer and the head (index ``depth``), padded
    (``k``, ``n``) and real (``kr``, ``nr``) widths, the byte offsets of
    ``W^T`` (``n`` rows of ``k + 8`` bf16) and of the f32 bias, and the
    image's size."""

    depth: int
    k: tuple
    n: tuple
    kr: tuple
    nr: tuple
    w_off: tuple
    b_off: tuple
    bytes: int

    def c(self) -> "_TrunkC":
        pad = lambda v: list(v) + [0] * (LAYERS - len(v))  # noqa: E731
        return _TrunkC(self.depth, *[(ctypes.c_int * LAYERS)(*pad(getattr(self, f)))
                                     for f in ("k", "n", "kr", "nr", "w_off", "b_off")], self.bytes)


def layout(obs_dim: int, sizes, outs: int) -> Layout:
    """The image layout of a trunk ``sizes`` on ``obs_dim`` inputs with a
    head of ``outs`` outputs."""
    return _layout(int(obs_dim), tuple(int(s) for s in sizes), int(outs))


def weight_layouts(w) -> tuple[Layout, Layout]:
    """The (actor, critic) image layouts of ``cuda_policy.PolicyWeights``
    ``w``, from its shapes."""
    return (layout(w.obs_dim, [t.shape[1] for t in w.pi_w], w.act_dim),
            layout(w.obs_dim, [t.shape[1] for t in w.vf_w], 1))


@functools.lru_cache(maxsize=64)
def _layout(obs_dim: int, sizes: tuple, outs: int) -> Layout:
    kr = (obs_dim, *sizes)
    nr = (*sizes, outs)
    k = tuple(_pad16(v) for v in kr)
    n = tuple(_pad16(v) for v in sizes) + (HEAD_PAD,)
    w_off, p = [], 0
    for kk, nn in zip(k, n):
        w_off.append(p)
        p += nn * (kk + 8) * 2
    b_off = []
    for nn in n:
        b_off.append(p)
        p += nn * 4
    return Layout(len(sizes), k, n, kr, nr, tuple(w_off), tuple(b_off), p)


class _TrunkC(ctypes.Structure):
    """Mirror of ``struct NarrowTrunk`` in csrc/policy_narrow.cuh."""

    _fields_ = [("depth", ctypes.c_int)] + [
        (name, ctypes.c_int * LAYERS) for name in ("k", "n", "kr", "nr", "w_off", "b_off")
    ] + [("bytes", ctypes.c_int)]


@functools.lru_cache(maxsize=32)
def _gather_index(obs_dim: int, sizes: tuple, outs: int, device: str) -> Tensor:
    """For each 16-bit word of a trunk's image, the word ``pack_trunk``
    copies into it from ``[bf16(src) | src's f32 words | 0]``, where
    ``src`` is the matrices (row-major ``(in, out)``, the head last) and
    then the biases, in f32: a matrix entry's bf16 at its ``W^T`` slot, a
    bias's two f32 halves, and the zero word for the padding."""
    lay = layout(obs_dim, sizes, outs)
    n_mats = sum(k * n for k, n in zip(lay.kr, lay.nr))
    n_src = n_mats + sum(lay.nr)
    g = torch.full((lay.bytes // 2,), 3 * n_src, dtype=torch.int64)
    p, q = 0, n_src + 2 * n_mats
    for i in range(lay.depth + 1):
        k, n = torch.meshgrid(torch.arange(lay.kr[i]), torch.arange(lay.nr[i]), indexing="ij")
        g[(lay.w_off[i] // 2 + n * (lay.k[i] + 8) + k).reshape(-1)] = p + (k * lay.nr[i] + n).reshape(-1)
        g[lay.b_off[i] // 2 : lay.b_off[i] // 2 + 2 * lay.nr[i]] = q + torch.arange(2 * lay.nr[i])
        p, q = p + k.numel(), q + 2 * lay.nr[i]
    return g.to(device)


def pack_trunk(weights, biases, head_w: Tensor, head_b: Tensor) -> Tensor:
    """One trunk (flax layout: ``weights[i] (in, out)``, biases of any
    shape, ``head_w (in, outs)``) → its image, a uint8 tensor on their
    device: the matrices transposed and rounded to bf16 (nearest even), the
    biases f32, the padding zero. One gather (``_gather_index``), so a few
    small ops in all."""
    mats = [*weights, head_w]
    src = torch.cat([t.detach().reshape(-1).float() for t in (*mats, *biases, head_b)])
    words = torch.cat([src.to(torch.bfloat16).view(torch.int16), src.view(torch.int16),
                       src.new_zeros(1, dtype=torch.int16)])
    index = _gather_index(mats[0].shape[0], tuple(w.shape[1] for w in weights), head_w.shape[1], str(src.device))
    return words[index].view(torch.uint8)


def unpack_trunk(image: Tensor, lay: Layout) -> tuple[list[Tensor], list[Tensor]]:
    """``pack_trunk``'s inverse: the matrices bf16 ``(in, out)`` (the head
    last) and the biases f32 ``(out,)``."""
    mats, biases = [], []
    for i in range(lay.depth + 1):
        wt = image[lay.w_off[i] : lay.w_off[i] + lay.n[i] * (lay.k[i] + 8) * 2].view(torch.bfloat16)
        mats.append(wt.view(lay.n[i], lay.k[i] + 8)[: lay.nr[i], : lay.kr[i]].T.contiguous())
        biases.append(image[lay.b_off[i] : lay.b_off[i] + lay.n[i] * 4].view(torch.float32)[: lay.nr[i]].clone())
    return mats, biases


def trunk_leaves(leaves: list[Tensor], n_pi: int, n_vf: int) -> tuple[tuple, tuple]:
    """The ordered leaves (``cuda_sgd.leaf_specs``) → ``(weights, biases,
    head_w, head_b)`` of the actor and of the critic."""
    def trunk(first: int, n: int):
        return ([leaves[first + 2 * i] for i in range(n)], [leaves[first + 2 * i + 1] for i in range(n)],
                leaves[first + 2 * n], leaves[first + 2 * n + 1])

    return trunk(0, n_pi), trunk(2 * n_pi + 3, n_vf)


def image_stride(pi: Layout, vf: Layout) -> int:
    """Bytes from the actor's image to the critic's in K2n's buffer."""
    return max(pi.bytes, vf.bytes)


def image_slots(obs_dim: int, act_dim: int, pi_sizes, vf_sizes) -> tuple[Tensor, Tensor]:
    """For each entry of K2n's flat parameter vector (``cuda_sgd.flat_layout``
    of ``leaf_specs``): its byte offset in the two images (actor at 0, the
    critic at ``image_stride``), where the kernel writes it after every Adam
    step (-1 for log_std and the padding), and whether it goes there as f32
    (a bias) rather than bf16 (a matrix entry). Scattering a flat vector
    through it gives ``pack_trunk`` of its leaves."""
    net = dict(obs_dim=obs_dim, act_dim=act_dim, pi_sizes=tuple(pi_sizes), vf_sizes=tuple(vf_sizes))
    shapes = [sh for _, sh in cuda_sgd.leaf_specs(net)]
    offsets, P = cuda_sgd.flat_layout(shapes)
    lays = (layout(obs_dim, pi_sizes, act_dim), layout(obs_dim, vf_sizes, 1))
    stride = image_stride(*lays)
    slot = torch.full((P,), -1, dtype=torch.int64)
    is_f32 = torch.zeros(P, dtype=torch.bool)
    firsts = (0, 2 * len(pi_sizes) + 3)
    for tr, (lay, first) in enumerate(zip(lays, firsts)):
        for i in range(lay.depth + 1):
            w_leaf, b_leaf = first + 2 * i, first + 2 * i + 1
            kk, nn = torch.meshgrid(torch.arange(lay.kr[i]), torch.arange(lay.nr[i]), indexing="ij")
            off = offsets[w_leaf]
            slot[off : off + kk.numel()] = tr * stride + lay.w_off[i] + 2 * (nn * (lay.k[i] + 8) + kk).reshape(-1)
            off = offsets[b_leaf]
            slot[off : off + lay.nr[i]] = tr * stride + lay.b_off[i] + 4 * torch.arange(lay.nr[i])
            is_f32[off : off + lay.nr[i]] = True
    return slot, is_f32


# ---------------------------------------------------------------------------
# K4n: the actor-critic forward
# ---------------------------------------------------------------------------


class _ForwardArgsC(ctypes.Structure):
    """Mirror of ``struct NarrowForwardArgs`` in csrc/policy_narrow.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("obs", "pi_image", "vf_image", "mean", "value")] + [
        ("pi", _TrunkC), ("vf", _TrunkC),
        ("n", ctypes.c_int), ("obs_dim", ctypes.c_int), ("act_dim", ctypes.c_int),
    ]


FORWARD_KERNEL = Kernel("policy_narrow.cu", "narrow_policy_value_forward", [ctypes.c_void_p, ctypes.c_void_p])


def forward(obs: Tensor, w) -> tuple[Tensor, Tensor]:
    """K4n on CUDA ``obs`` (n, obs_dim) f32 with ``cuda_policy.PolicyWeights``
    holding narrow images (``cuda_policy._check_kernel_shapes`` has
    checked them): ``(mean (n, act), value (n,))``."""
    n = obs.shape[0]
    mean = torch.empty((n, w.act_dim), dtype=torch.float32, device=obs.device)
    value = torch.empty((n,), dtype=torch.float32, device=obs.device)
    if n == 0:
        return mean, value
    pi, vf = weight_layouts(w)
    args = _ForwardArgsC(obs.data_ptr(), w.pi_image.data_ptr(), w.vf_image.data_ptr(), mean.data_ptr(),
                         value.data_ptr(), pi.c(), vf.c(), n, w.obs_dim, w.act_dim)
    with torch.cuda.device(obs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = FORWARD_KERNEL.fn()(ctypes.addressof(args), stream)
    FORWARD_KERNEL.check(rc)
    FORWARD_KERNEL.launches += 1
    return mean, value


# ---------------------------------------------------------------------------
# K3n: log-prob of the stored actions
# ---------------------------------------------------------------------------


class _LogpArgsC(ctypes.Structure):
    """Mirror of ``struct NarrowLogpArgs`` in csrc/policy_narrow.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("rows", "image", "log_std", "out")] + [
        ("pi", _TrunkC), ("n", ctypes.c_int), ("feat", ctypes.c_int), ("obs_dim", ctypes.c_int),
        ("act_dim", ctypes.c_int), ("has_range", ctypes.c_int), ("ls_lo", ctypes.c_float),
        ("ls_hi", ctypes.c_float),
    ]


LOGP_KERNEL = Kernel("policy_narrow.cu", "narrow_logp_forward", [ctypes.c_void_p, ctypes.c_void_p])


def logp(packed: Tensor, pi_leaves: list[Tensor], obs_dim: int, log_std_range=None) -> Tensor:
    """K3n on CUDA packed rows (``cuda_sgd.logp_forward`` has checked them):
    the actor's image is packed from ``pi_leaves`` on each call."""
    n_pi = (len(pi_leaves) - 3) // 2
    weights = [pi_leaves[2 * i] for i in range(n_pi)]
    image = pack_trunk(weights, [pi_leaves[2 * i + 1] for i in range(n_pi)], pi_leaves[2 * n_pi],
                       pi_leaves[2 * n_pi + 1])
    lay = layout(obs_dim, [t.shape[1] for t in weights], pi_leaves[-1].shape[-1])
    return launch_logp(packed, image, lay, pi_leaves[-1], obs_dim, log_std_range)


def launch_logp(packed: Tensor, image: Tensor, lay: Layout, log_std: Tensor, obs_dim: int,
                log_std_range=None) -> Tensor:
    """K3n's launch on the actor's image (``pack_trunk``, layout ``lay``)."""
    n = packed.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=packed.device)
    if n == 0:
        return out
    log_std = log_std.detach().to(torch.float32).reshape(-1).contiguous()
    has_range, lo, hi = cuda_sgd._range_args(log_std_range)
    args = _LogpArgsC(packed.data_ptr(), image.data_ptr(), log_std.data_ptr(), out.data_ptr(), lay.c(), n,
                      packed.shape[1], obs_dim, log_std.numel(), has_range, lo, hi)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = LOGP_KERNEL.fn()(ctypes.addressof(args), stream)
    LOGP_KERNEL.check(rc)
    LOGP_KERNEL.launches += 1
    return out


# ---------------------------------------------------------------------------
# K2n: a whole PPO epoch
# ---------------------------------------------------------------------------


class _EpochArgsC(ctypes.Structure):
    """Mirror of ``struct NarrowEpochArgs`` in csrc/fused_epoch_narrow.cu."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("mbs", "adv_stats", "t0", "params", "mu", "nu", "metrics", "image", "spill", "slab",
                     "tile_part", "grad", "block_sq")
    ] + [("pi", _TrunkC), ("vf", _TrunkC), ("w_leaf", (ctypes.c_int * LAYERS) * 2),
         ("b_leaf", (ctypes.c_int * LAYERS) * 2)] + [
        (name, ctypes.c_int)
        for name in ("ls_off", "img_stride", "spill_nt", "P", "n_mb", "mb", "feat", "obs_dim", "act_dim")
    ] + [
        (name, ctypes.c_float) for name in ("lr", "clip_eps", "ent_coef", "vf_coef", "max_grad_norm")
    ] + [("has_range", ctypes.c_int), ("ls_lo", ctypes.c_float), ("ls_hi", ctypes.c_float)]


EPOCH_KERNEL = Kernel("fused_epoch_narrow.cu", "fused_epoch_narrow", [ctypes.c_void_p, ctypes.c_void_p])


def spill_tiles(lay: Layout) -> int:
    """n8 tiles of f32 activations a warp spills in K2n's forward."""
    return sum(lay.n[i] // 8 for i in range(lay.depth))


def launch_epoch(mbs, adv_stats, t0, leaves, mu, nu, cfg):
    """K2n's launch, after ``cuda_sgd.fused_epoch``'s checks: ``((leaves, mu,
    nu, metrics), images)``, ``images`` (2, ``image_stride``) uint8 the
    actor's and the critic's images as the last Adam step wrote them
    (``pack_trunk`` of the returned leaves, each zero-padded to the
    stride)."""
    cuda_sgd.check_family("narrow", cfg.obs_dim, cfg.act_dim, cfg.pi_sizes, cfg.vf_sizes)
    dev = mbs.device
    n_mb, mb_size, feat = mbs.shape
    net = dict(obs_dim=cfg.obs_dim, act_dim=cfg.act_dim, pi_sizes=cfg.pi_sizes, vf_sizes=cfg.vf_sizes)
    shapes = [s for _, s in cuda_sgd.leaf_specs(net)]
    offsets, P = cuda_sgd.flat_layout(shapes)
    params, m1, m2 = (cuda_sgd._to_flat(g, offsets, P) for g in (leaves, mu, nu))
    mbs = mbs.contiguous()
    adv_stats = adv_stats.to(torch.float32).contiguous()
    t0 = t0.to(torch.int32).reshape(1).contiguous()
    metrics = torch.empty((n_mb, len(cuda_sgd.METRICS)), dtype=torch.float32, device=dev)
    lays = (layout(cfg.obs_dim, cfg.pi_sizes, cfg.act_dim), layout(cfg.obs_dim, cfg.vf_sizes, 1))
    stride = image_stride(*lays)
    tiles = -(-mb_size // TILE_ROWS)
    spill_nt = max(spill_tiles(lay) for lay in lays)
    images = torch.zeros((2, stride), dtype=torch.uint8, device=dev)
    ws = dict(
        spill=torch.empty((2, tiles, WARPS, spill_nt, 32, 4), dtype=torch.float32, device=dev),
        slab=torch.zeros((tiles, P), dtype=torch.float32, device=dev),
        tile_part=torch.zeros((tiles, NPART), dtype=torch.float32, device=dev),
        grad=torch.empty((P,), dtype=torch.float32, device=dev),
        block_sq=torch.empty((-(-P // _THREADS),), dtype=torch.float32, device=dev),
    )
    firsts = (0, 2 * len(cfg.pi_sizes) + 3)
    leaf_offs = lambda k: ((ctypes.c_int * LAYERS) * 2)(*[  # noqa: E731
        (ctypes.c_int * LAYERS)(*[offsets[f + 2 * i + k] for i in range(lay.depth + 1)])
        for lay, f in zip(lays, firsts)])
    has_range, lo, hi = cuda_sgd._range_args(cfg.log_std_range)
    args = _EpochArgsC(
        mbs.data_ptr(), adv_stats.data_ptr(), t0.data_ptr(), params.data_ptr(), m1.data_ptr(), m2.data_ptr(),
        metrics.data_ptr(), images.data_ptr(), *[ws[k].data_ptr() for k in ("spill", "slab", "tile_part", "grad",
                                                                              "block_sq")],
        lays[0].c(), lays[1].c(), leaf_offs(0), leaf_offs(1), offsets[firsts[1] - 1], stride, spill_nt, P, n_mb,
        mb_size, feat, cfg.obs_dim, cfg.act_dim, cfg.learning_rate, cfg.clip_eps, cfg.entropy_coef,
        cfg.value_coef, cfg.max_grad_norm, has_range, lo, hi,
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = EPOCH_KERNEL.fn()(ctypes.addressof(args), stream)
    EPOCH_KERNEL.check(rc)
    EPOCH_KERNEL.launches += 1
    out = (cuda_sgd._from_flat(params, shapes, offsets), cuda_sgd._from_flat(m1, shapes, offsets),
           cuda_sgd._from_flat(m2, shapes, offsets), metrics)
    return out, images

