"""The general trunks' kernels: K4g, K3g and K2g (ports of
``pyflyt_tpu/ops/pallas_policy.py::build_policy_value_forward`` and
``pyflyt_tpu/ops/pallas_sgd.py::build_logp_forward`` / ``build_fused_epoch``
at every trunk the wide and narrow families do not take).

The family takes whatever the Pallas builders take: any number of tanh
layers a trunk (none: a linear policy), any widths, any obs and action
widths, actor and critic trunks that may differ. ``cuda_sgd._check_envelope``
routes a network here (``"general"``) when it is neither two 256-wide
layers a trunk (``"wide"``) nor 1-4 layers of at most 128 units with obs
<= 64 and act <= 8 (``"narrow"``). The arithmetic is the Pallas kernels':
bf16 matmul inputs rounded to nearest even, f32 accumulation, bias, tanh,
loss, clip and Adam in f32. The twins are the family-agnostic ones:
``cuda_policy.policy_value_forward_plain``, ``cuda_sgd.logp_forward_plain``
and ``cuda_sgd.fused_epoch_plain`` take any trunk.

Each layer of each trunk is one launch of ``csrc/policy_general.cuh``'s
GEMM on f32 weights in device memory: a trunk reaches K4g as one flat f32
vector (``pack_trunk``: ``W_0 (in, out)`` row-major, ``b_0``, ..., the head
last, each at a multiple of 4 floats), K3g as the actor's leaves packed the
same way on each call, K2g as its flat parameter vector
(``cuda_sgd.flat_layout`` of ``leaf_specs``), which its Adam updates in
place. Activations go through a device workspace the wrappers size per
call from the shapes. K3g runs the same GEMM launches as K2g's actor
forward, so a row's log-prob from K3g equals K2g's bit for bit.

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

# csrc/policy_general.cuh's GEMM
BM, BN, BK = 128, 64, 32  # output tile, k step
GEMM_THREADS = 256
CHUNK = 512  # rows a weight-gradient partial of K2g sums (a multiple of BK)
_THREADS = 256  # K2g's loss, reduce and Adam blocks; K3g's log-prob block


def kernels_per_minibatch(pi_depth: int, vf_depth: int) -> int:
    """CUDA kernels K2g enqueues a minibatch: a forward GEMM a layer (the
    heads included), the loss, a weight-gradient GEMM a layer, a
    data-gradient GEMM a layer but the first, the reduce and Adam."""
    return 3 * (pi_depth + vf_depth) + 7


KERNELS_PER_CALL = 0  # and nothing once a call


@dataclasses.dataclass(frozen=True)
class Trunk:
    """One trunk: its widths (the input, each tanh layer's, the head's
    outputs) and where each layer's ``W (in, out)`` and bias start, in
    floats, in the vector that holds them."""

    dims: tuple
    w: tuple
    b: tuple

    @property
    def depth(self) -> int:
        return len(self.dims) - 2


def layout(obs_dim: int, sizes, outs: int) -> tuple[Trunk, int]:
    """A trunk ``sizes`` on ``obs_dim`` inputs with a head of ``outs``
    outputs as ``pack_trunk`` lays it out: ``(Trunk, floats)``."""
    return _layout(int(obs_dim), tuple(int(s) for s in sizes), int(outs))


@functools.lru_cache(maxsize=64)
def _layout(obs_dim: int, sizes: tuple, outs: int) -> tuple[Trunk, int]:
    dims = (obs_dim, *sizes, outs)
    shapes = [s for i, o in zip(dims[:-1], dims[1:]) for s in ((i, o), (o,))]
    offsets, floats = cuda_sgd.flat_layout(shapes)
    return Trunk(dims, tuple(offsets[0::2]), tuple(offsets[1::2])), floats


def pack_trunk(weights, biases, head_w: Tensor, head_b: Tensor) -> Tensor:
    """One trunk (flax layout: ``weights[i] (in, out)``, biases of any
    shape, ``head_w (in, outs)``) → its flat f32 vector as a uint8 tensor on
    their device (K4g's image): the values as given, f32; the kernel rounds
    the matrices to bf16 as it reads them."""
    mats = [*weights, head_w]
    _, floats = layout(mats[0].shape[0], [w.shape[1] for w in weights], head_w.shape[1])
    leaves = [t for pair in zip(mats, [*biases, head_b]) for t in pair]
    offsets, _ = cuda_sgd.flat_layout([tuple(t.shape) for t in leaves])
    flat = cuda_sgd._to_flat([t.detach().float() for t in leaves], offsets, floats)
    return flat.view(torch.uint8)


def weight_layouts(w) -> tuple[tuple[Trunk, int], tuple[Trunk, int]]:
    """The (actor, critic) layouts of ``cuda_policy.PolicyWeights`` ``w``."""
    return (layout(w.obs_dim, [t.shape[1] for t in w.pi_w], w.act_dim),
            layout(w.obs_dim, [t.shape[1] for t in w.vf_w], 1))


def forward_outputs(n: int, *trunks: Trunk) -> tuple[list[tuple[int, ...]], int]:
    """Where K4g and K3g put each tanh layer's outputs for ``n`` rows: two
    buffers of the widest layer, in turn, shared by the trunks (run one
    after the other); per trunk the offsets (the head's, unused, 0) and the
    workspace's floats."""
    widest = max([max(t.dims[1:-1], default=0) for t in trunks])
    outs = [tuple((l % 2) * n * widest for l in range(t.depth)) + (0,) for t in trunks]
    return outs, max(1, 2 * n * widest)


@dataclasses.dataclass(frozen=True)
class EpochWorkspace:
    """K2g's workspace for minibatches of ``mb`` rows, in floats: each
    layer's outputs of each trunk (the heads' last: the mean and the value),
    two dz buffers of the widest output, the critic's dvalue and each row's
    d loss / d logp."""

    out: tuple  # (actor, critic): per layer, the head last
    dz0: int
    dz1: int
    dv: int
    glogp: int
    floats: int


def epoch_workspace(mb: int, pi: Trunk, vf: Trunk) -> EpochWorkspace:
    p = 0
    outs = []
    for t in (pi, vf):
        offs = []
        for n in t.dims[1:]:
            offs.append(p)
            p += mb * n
        outs.append(tuple(offs))
    widest = max(max(t.dims[1:]) for t in (pi, vf))
    dz0, dz1, dv, glogp = p, p + mb * widest, p + 2 * mb * widest, p + 2 * mb * widest + mb
    return EpochWorkspace(tuple(outs), dz0, dz1, dv, glogp, glogp + mb)


class _TrunkC(ctypes.Structure):
    """Mirror of ``struct GeneralTrunk`` in csrc/policy_general.cuh."""

    _fields_ = [("depth", ctypes.c_int), ("dims", ctypes.POINTER(ctypes.c_int)),
                ("w", ctypes.POINTER(ctypes.c_longlong)), ("b", ctypes.POINTER(ctypes.c_longlong)),
                ("out", ctypes.POINTER(ctypes.c_longlong))]


def _trunk_c(t: Trunk, w: tuple, b: tuple, out: tuple, keep: list) -> _TrunkC:
    """``t``'s C struct with ``w``/``b`` offsets and ``out`` offsets; the
    host arrays go to ``keep``, which the caller holds over the launch."""
    arrays = [(ctypes.c_int * len(t.dims))(*t.dims)] + [(ctypes.c_longlong * len(v))(*v) for v in (w, b, out)]
    keep.extend(arrays)
    return _TrunkC(t.depth, *arrays)


# ---------------------------------------------------------------------------
# K4g: the actor-critic forward
# ---------------------------------------------------------------------------


class _ForwardArgsC(ctypes.Structure):
    """Mirror of ``struct GeneralForwardArgs`` in csrc/policy_general.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("obs", "pi_base", "vf_base", "ws", "mean", "value")] + [
        ("pi", _TrunkC), ("vf", _TrunkC)] + [
        (name, ctypes.c_longlong) for name in ("pi_floats", "vf_floats", "ws_floats")] + [
        (name, ctypes.c_int) for name in ("n", "obs_dim", "act_dim")]


FORWARD_KERNEL = Kernel("policy_general.cu", "general_policy_value_forward", [ctypes.c_void_p, ctypes.c_void_p])


def _launch(kernel: Kernel, args: ctypes.Structure, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel.fn()(ctypes.addressof(args), stream)
    kernel.check(rc)
    kernel.launches += 1


def forward(obs: Tensor, w) -> tuple[Tensor, Tensor]:
    """K4g on CUDA ``obs`` (n, obs_dim) f32 with ``cuda_policy.PolicyWeights``
    holding general images (``cuda_policy._check_kernel_shapes`` has
    checked them): ``(mean (n, act), value (n,))``."""
    n = obs.shape[0]
    mean = torch.empty((n, w.act_dim), dtype=torch.float32, device=obs.device)
    value = torch.empty((n,), dtype=torch.float32, device=obs.device)
    if n == 0:
        return mean, value
    (pi, pi_floats), (vf, vf_floats) = weight_layouts(w)
    (pi_out, vf_out), ws_floats = forward_outputs(n, pi, vf)
    ws = torch.empty((ws_floats,), dtype=torch.float32, device=obs.device)
    keep: list = []
    args = _ForwardArgsC(
        obs.data_ptr(), w.pi_image.data_ptr(), w.vf_image.data_ptr(), ws.data_ptr(), mean.data_ptr(),
        value.data_ptr(), _trunk_c(pi, pi.w, pi.b, pi_out, keep), _trunk_c(vf, vf.w, vf.b, vf_out, keep),
        pi_floats, vf_floats, ws_floats, n, w.obs_dim, w.act_dim,
    )
    _launch(FORWARD_KERNEL, args, obs.device)
    return mean, value


# ---------------------------------------------------------------------------
# K3g: log-prob of the stored actions
# ---------------------------------------------------------------------------


class _LogpArgsC(ctypes.Structure):
    """Mirror of ``struct GeneralLogpArgs`` in csrc/policy_general.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("rows", "base", "log_std", "ws", "mean", "out")] + [
        ("pi", _TrunkC), ("base_floats", ctypes.c_longlong), ("ws_floats", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in ("n", "feat", "obs_dim", "act_dim", "has_range")] + [
        ("ls_lo", ctypes.c_float), ("ls_hi", ctypes.c_float)]


LOGP_KERNEL = Kernel("policy_general.cu", "general_logp_forward", [ctypes.c_void_p, ctypes.c_void_p])


def logp(packed: Tensor, pi_leaves: list[Tensor], obs_dim: int, log_std_range=None) -> Tensor:
    """K3g on CUDA packed rows (``cuda_sgd.logp_forward`` has checked them):
    the actor's leaves are packed into one f32 vector on each call."""
    n = packed.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=packed.device)
    if n == 0:
        return out
    n_pi = (len(pi_leaves) - 3) // 2
    act_dim = pi_leaves[-1].shape[-1]
    pi, floats = layout(obs_dim, [pi_leaves[2 * i].shape[1] for i in range(n_pi)], act_dim)
    base = pack_trunk(pi_leaves[:2 * n_pi:2], pi_leaves[1:2 * n_pi:2], pi_leaves[2 * n_pi],
                      pi_leaves[2 * n_pi + 1]).view(torch.float32)
    (pi_out,), ws_floats = forward_outputs(n, pi)
    ws = torch.empty((ws_floats,), dtype=torch.float32, device=packed.device)
    mean = torch.empty((n, act_dim), dtype=torch.float32, device=packed.device)
    log_std = pi_leaves[-1].detach().to(torch.float32).reshape(-1).contiguous()
    has_range, lo, hi = cuda_sgd._range_args(log_std_range)
    keep: list = []
    args = _LogpArgsC(
        packed.data_ptr(), base.data_ptr(), log_std.data_ptr(), ws.data_ptr(), mean.data_ptr(), out.data_ptr(),
        _trunk_c(pi, pi.w, pi.b, pi_out, keep), floats, ws_floats, n, packed.shape[1], obs_dim, act_dim,
        has_range, lo, hi,
    )
    _launch(LOGP_KERNEL, args, packed.device)
    return out


# ---------------------------------------------------------------------------
# K2g: a whole PPO epoch
# ---------------------------------------------------------------------------


class _EpochArgsC(ctypes.Structure):
    """Mirror of ``struct GeneralEpochArgs`` in csrc/fused_epoch_general.cu."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("mbs", "adv_stats", "t0", "params", "mu", "nu", "metrics", "ws", "slab", "chunk_part", "grad",
                     "block_sq")
    ] + [("pi", _TrunkC), ("vf", _TrunkC)] + [
        (name, ctypes.c_longlong) for name in ("mean", "value", "dz0", "dz1", "dv", "glogp", "ws_floats")
    ] + [
        (name, ctypes.c_int) for name in ("ls_off", "P", "n_mb", "mb", "feat", "obs_dim", "act_dim", "chunk")
    ] + [
        (name, ctypes.c_float) for name in ("lr", "clip_eps", "ent_coef", "vf_coef", "max_grad_norm")
    ] + [("has_range", ctypes.c_int), ("ls_lo", ctypes.c_float), ("ls_hi", ctypes.c_float)]


EPOCH_KERNEL = Kernel("fused_epoch_general.cu", "fused_epoch_general", [ctypes.c_void_p, ctypes.c_void_p])


def leaf_trunks(cfg) -> tuple[Trunk, Trunk, int]:
    """The actor's and the critic's layers at their offsets in K2g's flat
    parameter vector (``cuda_sgd.flat_layout`` of ``leaf_specs``), and
    log_std's offset."""
    net = dict(obs_dim=cfg.obs_dim, act_dim=cfg.act_dim, pi_sizes=cfg.pi_sizes, vf_sizes=cfg.vf_sizes)
    offsets, _ = cuda_sgd.flat_layout([s for _, s in cuda_sgd.leaf_specs(net)])
    n_pi, n_vf = len(cfg.pi_sizes), len(cfg.vf_sizes)
    vf0 = 2 * n_pi + 3
    pi = Trunk((cfg.obs_dim, *cfg.pi_sizes, cfg.act_dim), tuple(offsets[0 : 2 * n_pi + 2 : 2]),
               tuple(offsets[1 : 2 * n_pi + 2 : 2]))
    vf = Trunk((cfg.obs_dim, *cfg.vf_sizes, 1), tuple(offsets[vf0 : vf0 + 2 * n_vf + 2 : 2]),
               tuple(offsets[vf0 + 1 : vf0 + 2 * n_vf + 2 : 2]))
    return pi, vf, offsets[2 * n_pi + 2]


def launch_epoch(mbs, adv_stats, t0, leaves, mu, nu, cfg):
    """K2g's launch, after ``cuda_sgd.fused_epoch``'s checks: ``(leaves, mu,
    nu, metrics)``."""
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
    pi, vf, ls_off = leaf_trunks(cfg)
    ws_lay = epoch_workspace(mb_size, pi, vf)
    chunks = -(-mb_size // CHUNK)
    ws = dict(
        ws=torch.empty((ws_lay.floats,), dtype=torch.float32, device=dev),
        slab=torch.zeros((chunks, P), dtype=torch.float32, device=dev),
        chunk_part=torch.empty((chunks, 3), dtype=torch.float32, device=dev),
        grad=torch.empty((P,), dtype=torch.float32, device=dev),
        block_sq=torch.empty((-(-P // _THREADS),), dtype=torch.float32, device=dev),
    )
    keep: list = []
    has_range, lo, hi = cuda_sgd._range_args(cfg.log_std_range)
    args = _EpochArgsC(
        mbs.data_ptr(), adv_stats.data_ptr(), t0.data_ptr(), params.data_ptr(), m1.data_ptr(), m2.data_ptr(),
        metrics.data_ptr(), *[ws[k].data_ptr() for k in ("ws", "slab", "chunk_part", "grad", "block_sq")],
        _trunk_c(pi, pi.w, pi.b, ws_lay.out[0], keep), _trunk_c(vf, vf.w, vf.b, ws_lay.out[1], keep),
        ws_lay.out[0][-1], ws_lay.out[1][-1], ws_lay.dz0, ws_lay.dz1, ws_lay.dv, ws_lay.glogp, ws_lay.floats, ls_off, P, n_mb, mb_size, feat, cfg.obs_dim,
        cfg.act_dim, CHUNK, cfg.learning_rate, cfg.clip_eps, cfg.entropy_coef, cfg.value_coef, cfg.max_grad_norm,
        has_range, lo, hi,
    )
    _launch(EPOCH_KERNEL, args, dev)
    return (cuda_sgd._from_flat(params, shapes, offsets), cuda_sgd._from_flat(m1, shapes, offsets),
            cuda_sgd._from_flat(m2, shapes, offsets), metrics)
