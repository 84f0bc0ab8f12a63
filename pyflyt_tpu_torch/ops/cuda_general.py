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

K4g and K3g have three routes, chosen from the widths (``resident_tile``,
then ``cluster_plan``):

- resident (``csrc/policy_resident.cuh``): one launch a call, every layer
  of a trunk over a tile of rows with the activations in shared memory
  and the weights streamed from a bf16 image (``pack_resident``; K4g's is
  built once with the ``PolicyWeights``, K3g's from the actor's leaves on
  each call). It takes every trunk of at most ``RES_MAX_LAYERS`` layers
  (the head included) whose widest input width, padded to ``RES_KC``,
  fits a block's shared memory (``resident_smem``) beside the weight ring
  and, for K3g, the staged means: 128 rows a block where that fits, else
  64. At 4 actions that is a width of 288 at 128 rows and 608 at 64;
- cluster (``csrc/policy_cluster.cuh``): the same launch and image with a
  64-row tile shared by a thread-block cluster of C blocks, rank c holding
  the c-th run of ceil(chunks / C) of each tanh layer's output chunks
  (``cluster_width`` columns a block) and reading its peers' through
  distributed shared memory. It takes every wider trunk of at most ``RES_MAX_LAYERS`` layers
  whose share fits a block at C = 2, 4 or 8 (``cluster_plan``: at 4
  actions from 640 units, C = 2 to 1024, 4 to 2048, 8 to 4096);
- per layer (``csrc/policy_general.cuh``'s GEMM: TMA-fed bf16 stages,
  wgmma, one launch a layer a trunk after one rounding the obs to bf16):
  every deeper trunk, and every trunk past 4096 units at 4 actions.
  A trunk reaches K4g as one image (``pack_trunk``: each ``W_l (in, out)``
  bf16 as the parameters hold it, its rows padded to KPAD outputs, then the
  f32 biases, every region at a multiple of 128 bytes), K3g as the actor's
  leaves packed the same way on each call. Activations go through a bf16
  device workspace the wrapper sizes per call (``forward_outputs``).

K2g takes its flat parameter vector (``cuda_sgd.flat_layout`` of
``leaf_specs``), which its Adam updates in place, on two routes chosen from
the widths (``epoch_route``):

- resident (``csrc/fused_epoch_general.cu``'s ``rep::`` kernels on
  ``csrc/policy_resident.cuh``): an image kernel a call, then four kernels
  a minibatch: a tile of rows of one trunk through the resident forward,
  the loss and the data gradient back through the layers (the weights
  from a forward and a backward image, ``epoch_layouts``), the weight
  gradient from the bf16 tiles it wrote, a fixed-order reduce, and Adam,
  which writes the next minibatch's images. It takes every trunk pair
  whose widest width fits a block (``epoch_tile``): at 4 actions a width
  of 288 at 128 rows a block and 576 at 64;
- per layer: past that, the obs rounded to bf16 and the weights' bf16
  image written once a call, then one launch of ``csrc/policy_general.cuh``'s
  GEMM a layer and pass on bf16 operands, a loss, a reduce and an Adam
  kernel a minibatch (``epoch_workspace``, ``wgrad_plan``, ``epoch_slots``).

Every route runs each output's forward k16 steps in order on the same bf16
inputs (wgmma's chain gives mma.sync's bits), so a row's log-prob from K3g
equals K2g's forward bit for bit on any. Each route has its own launch
counter.

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
BM, BN, BK = 128, 128, 64  # output tile, k a stage
GEMM_THREADS = 384  # two consumer warpgroups and the producer warpgroup
GEMM_STAGES = 4
KPAD = 32  # every bf16 operand row is padded to a multiple of it
# the weight gradient's split plan (wgrad_plan), in units of one tile's 64-row k block (about 0.44 us of
# wgmma on an H100 at 2 x 1024, tools/general_gemm_probe.py):
WGRAD_TILE_COST = 2  # a tile's fill and epilogue
WGRAD_BLOCK_FLOATS = 160_000  # slab floats written and read back (8 bytes each, about 3 TB/s)
CRITIC_LD = 32  # the critic head's dz row: KPAD
_ALIGN = 128  # bytes: every region of an image or workspace starts at a multiple
_THREADS = 256  # K2g's loss, reduce and Adam blocks; K3g's log-prob block


def kernels_per_minibatch(pi_depth: int, vf_depth: int, route: str = "per_layer") -> int:
    """CUDA kernels K2g enqueues a minibatch. Per layer: a forward GEMM a
    layer (the heads included), the loss, a weight-gradient GEMM a layer, a
    data-gradient GEMM a layer but the first, the reduce and Adam.
    Resident: the forward and backward, the weight gradient, the reduce and
    Adam, whatever the depths."""
    return 4 if route == "resident" else 3 * (pi_depth + vf_depth) + 7


def kernels_per_call(route: str) -> int:
    """CUDA kernels K2g enqueues once a call beside its minibatches': the
    resident route's first images; per layer the obs rounded to bf16 and
    the first image."""
    return 1 if route == "resident" else 2


@dataclasses.dataclass(frozen=True)
class Trunk:
    """One trunk: its widths (the input, each tanh layer's, the head's
    outputs) and where each layer's weight and bias start in the buffer
    that holds them (``layout``: bytes of the image; ``leaf_trunks``:
    floats of K2g's flat parameters)."""

    dims: tuple
    w: tuple
    b: tuple

    @property
    def depth(self) -> int:
        return len(self.dims) - 2


def _kpad(x: int) -> int:
    return -(-int(x) // KPAD) * KPAD


def _up(x: int, unit: int) -> int:
    return -(-int(x) // unit) * unit


def layout(obs_dim: int, sizes, outs: int) -> tuple[Trunk, int]:
    """A trunk ``sizes`` on ``obs_dim`` inputs with a head of ``outs``
    outputs as ``pack_trunk`` lays it out: ``(Trunk, bytes)``, ``w[l]`` the
    byte offset of ``W_l`` (``dims[l]`` rows of ``_kpad(dims[l + 1])``
    bf16: the forward's B MN-major, the data gradient's B^T K-major), then
    every bias (f32) from ``b[l]``, each region at a multiple of 128
    bytes."""
    return _layout(int(obs_dim), tuple(int(s) for s in sizes), int(outs))


@functools.lru_cache(maxsize=64)
def _layout(obs_dim: int, sizes: tuple, outs: int) -> tuple[Trunk, int]:
    dims = (obs_dim, *sizes, outs)
    w, b, at = [], [], 0
    for k, n in zip(dims[:-1], dims[1:]):
        w.append(at)
        at = _up(at + 2 * k * _kpad(n), _ALIGN)
    for n in dims[1:]:
        b.append(at)
        at = _up(at + 4 * n, _ALIGN)
    return Trunk(dims, tuple(w), tuple(b)), at


def pack_trunk(weights, biases, head_w: Tensor, head_b: Tensor) -> Tensor:
    """One trunk (flax layout: ``weights[i] (in, out)``, biases of any
    shape, ``head_w (in, outs)``) → its per-layer image, a uint8 tensor on
    their device: each ``W`` rounded to bf16 (nearest even), the f32
    biases, zero padding (``layout``)."""
    mats = [*weights, head_w]
    lay, nbytes = layout(mats[0].shape[0], [w.shape[1] for w in weights], head_w.shape[1])
    image = torch.zeros((nbytes,), dtype=torch.uint8, device=mats[0].device)
    for l, (m, b) in enumerate(zip(mats, [*biases, head_b])):
        k, n = m.shape
        rows = image[lay.w[l] : lay.w[l] + 2 * k * _kpad(n)].view(torch.bfloat16).view(k, _kpad(n))
        rows[:, :n] = m.detach().float().to(torch.bfloat16)
        image[lay.b[l] : lay.b[l] + 4 * n].view(torch.float32).copy_(b.detach().reshape(-1).float())
    return image


def unpack_trunk(image: Tensor, lay: Trunk) -> tuple[list[Tensor], list[Tensor]]:
    """``pack_trunk``'s inverse: the matrices bf16 ``(in, out)`` and the
    biases f32 ``(out,)``, head last."""
    mats, biases = [], []
    for l, (k, n) in enumerate(zip(lay.dims[:-1], lay.dims[1:])):
        rows = image[lay.w[l] : lay.w[l] + 2 * k * _kpad(n)].view(torch.bfloat16).view(k, _kpad(n))
        mats.append(rows[:, :n])
        biases.append(image[lay.b[l] : lay.b[l] + 4 * n].view(torch.float32).clone())
    return mats, biases


def weight_layouts(w) -> tuple[tuple[Trunk, int], tuple[Trunk, int]]:
    """The (actor, critic) layouts of ``cuda_policy.PolicyWeights`` ``w``."""
    return (layout(w.obs_dim, [t.shape[1] for t in w.pi_w], w.act_dim),
            layout(w.obs_dim, [t.shape[1] for t in w.vf_w], 1))


def forward_outputs(n: int, obs_dim: int, *trunks: Trunk) -> tuple[list[tuple[int, ...]], int]:
    """Where K4g and K3g put the obs rounded to bf16 (``n`` x
    ``_kpad(obs_dim)`` from element 0) and each tanh layer's bf16 outputs:
    two buffers of the widest padded layer after it, in turn, shared by the
    trunks (run one after the other); per trunk the offsets (the head's,
    unused, 0) and the workspace's bf16 elements."""
    at = n * _kpad(obs_dim)
    buf = n * max([_kpad(d) for t in trunks for d in t.dims[1:-1]], default=0)
    outs = [tuple(at + (l % 2) * buf for l in range(t.depth)) + (0,) for t in trunks]
    return outs, at + 2 * buf


@dataclasses.dataclass(frozen=True)
class EpochWorkspace:
    """K2g's per-layer buffers for minibatches of ``mb`` rows, per trunk
    and layer: ``out`` the f32 outputs' offset in ``ws`` (``floats``; the
    heads' last: the mean and the value), ``act`` a tanh layer's bf16
    outputs' in ``acts`` (``acts`` elements, row stride ``_kpad`` of the
    width), ``img`` ``W_l``'s in the bf16 image (``image`` elements, rows
    of ``_kpad(dims[l + 1])``), ``cs`` dz_l's first column in a colsum row
    (``cs_width`` floats); ``dz_width`` a dz buffer's row stride bound."""

    out: tuple
    act: tuple
    img: tuple
    cs: tuple
    floats: int
    acts: int
    image: int
    dz_width: int
    cs_width: int


def epoch_workspace(mb: int, pi: Trunk, vf: Trunk) -> EpochWorkspace:
    out, act, img, cs = [], [], [], []
    f_at = a_at = i_at = c_at = 0
    el = _ALIGN // 2  # bf16 elements a region is aligned to
    for t in (pi, vf):
        to, ta, ti, tc = [], [], [], []
        for l, (k, n) in enumerate(zip(t.dims[:-1], t.dims[1:])):
            to.append(f_at)
            f_at += mb * n
            if l < t.depth:
                ta.append(a_at)
                a_at = _up(a_at + mb * _kpad(n), el)
            ti.append(i_at)
            i_at = _up(i_at + k * _kpad(n), el)
            tc.append(c_at)
            c_at += n
        out.append(tuple(to))
        act.append(tuple(ta))
        img.append(tuple(ti))
        cs.append(tuple(tc))
    dz_width = max(_kpad(d) for t in (pi, vf) for d in t.dims[1:])
    return EpochWorkspace(tuple(out), tuple(act), tuple(img), tuple(cs), f_at, max(a_at, el), i_at, dz_width, c_at)


def wgrad_tiles(pi: Trunk, vf: Trunk) -> tuple[int, ...]:
    """Each layer's weight-gradient output tiles (units x outputs in BM x
    BN tiles), in launch order."""
    return tuple(-(-k // BM) * -(-n // BN) for t in (pi, vf) for k, n in zip(t.dims[:-1], t.dims[1:]))


def wgrad_plan(rows: int, tiles, sms: int, P: int = 0) -> tuple[int, int]:
    """(splits, rows a split) of K2g's per-layer weight gradients over
    ``rows`` rows, one split for every layer (``tiles``: each layer's
    output tiles) on a card of ``sms`` SMs: the chunks of whole BK blocks
    that minimise the layers' persistent rounds times a chunk's blocks
    (with WGRAD_TILE_COST blocks of fill and epilogue each) plus the slab
    of ``P`` floats a chunk writes and the reduce reads back, the fewest
    chunks among equals."""
    blocks = -(-_kpad(rows) // BK)
    best = None
    for s in range(1, blocks + 1):
        per = -(-blocks // s)
        splits = -(-blocks // per)
        rounds = sum(-(-int(t) * splits // int(sms)) for t in tiles)
        cost = rounds * (per + WGRAD_TILE_COST) + splits * P / WGRAD_BLOCK_FLOATS
        if best is None or cost < best[0]:
            best = (cost, splits, per * BK)
    return best[1], best[2]


def epoch_slots(cfg, device) -> Tensor:
    """What each flat parameter of K2g's per-layer route is, an int32 per
    parameter: a weight ``W_l[k, n]``'s slot in the bf16 image (``img[l] +
    k _kpad(dims[l + 1]) + n``, so Adam's writes of consecutive parameters
    land side by side), ``-2 - c`` for a bias whose gradient is column
    ``c`` of a colsum row, -1 else (log_std, padding)."""
    return _epoch_slots(int(cfg.obs_dim), int(cfg.act_dim), tuple(cfg.pi_sizes), tuple(cfg.vf_sizes), str(device))


@functools.lru_cache(maxsize=16)
def _epoch_slots(obs_dim: int, act_dim: int, pi_sizes: tuple, vf_sizes: tuple, device: str) -> Tensor:
    cfg = cuda_sgd.EpochConfig(obs_dim, act_dim, pi_sizes, vf_sizes, 0.0, 0.0, 0.0, 0.0, 0.0)
    pi, vf, _ = leaf_trunks(cfg)
    net = dict(obs_dim=obs_dim, act_dim=act_dim, pi_sizes=pi_sizes, vf_sizes=vf_sizes)
    _, P = cuda_sgd.flat_layout([s for _, s in cuda_sgd.leaf_specs(net)])
    ws = epoch_workspace(1, pi, vf)
    slot = torch.full((P,), -1, dtype=torch.int64)
    for i, t in enumerate((pi, vf)):
        for l, (k, n) in enumerate(zip(t.dims[:-1], t.dims[1:])):
            kk, nn = torch.meshgrid(torch.arange(k), torch.arange(n), indexing="ij")
            slot[t.w[l] + kk * n + nn] = ws.img[i][l] + kk * _kpad(n) + nn
            slot[t.b[l] : t.b[l] + n] = -2 - (ws.cs[i][l] + torch.arange(n))
    return slot.to(torch.int32).to(device)


class _TrunkC(ctypes.Structure):
    """Mirror of ``struct GeneralTrunk`` in csrc/policy_general.cuh."""

    _fields_ = [("depth", ctypes.c_int), ("dims", ctypes.POINTER(ctypes.c_int)),
                ("w", ctypes.POINTER(ctypes.c_longlong)), ("b", ctypes.POINTER(ctypes.c_longlong)),
                ("out", ctypes.POINTER(ctypes.c_longlong))]


def _arrays(keep: list, *values, ctype=ctypes.c_longlong) -> list:
    """Host arrays of ``values`` (tuples), kept alive in ``keep``, which the
    caller holds over the launch."""
    arrays = [(ctype * max(1, len(v)))(*v) for v in values]
    keep.extend(arrays)
    return arrays


def _trunk_c(t: Trunk, out: tuple, keep: list) -> _TrunkC:
    """``t``'s C struct with its image offsets and the workspace's ``out``."""
    return _TrunkC(t.depth, *_arrays(keep, t.dims, ctype=ctypes.c_int), *_arrays(keep, t.w, t.b, out))


# ---------------------------------------------------------------------------
# The resident route's image and plan (csrc/policy_resident.cuh)
# ---------------------------------------------------------------------------

RES_NC = 256  # output units a chunk: a weight block's lines
RES_KC = 32  # a block's depth; every width is padded to it
RES_STAGES = 4  # weight blocks in flight
RES_STAGE_BYTES = RES_NC * RES_KC * 2
RES_WN = 64  # a warp's columns of a chunk; 16 warps a block at 128-row tiles
RES_MAX_LAYERS = 16  # tanh layers and the head
RES_ACT_PAD = 8  # bf16 past an activation row in shared memory
RES_SMEM_LIMIT = 232_448  # the dynamic shared memory a block may opt into
RES_TILES = (128, 64)  # rows a block, the first that fits


def _pad(x: int) -> int:
    return -(-int(x) // RES_KC) * RES_KC


@dataclasses.dataclass(frozen=True)
class ResidentLayout:
    """One trunk's resident image: the real widths (the input, each tanh
    layer's, the head's), each layer's padded input and output widths, and
    the byte offsets of its first weight block and of its f32 bias."""

    dims: tuple
    k: tuple
    n: tuple
    w: tuple
    b: tuple
    bytes: int

    @property
    def layers(self) -> int:
        return len(self.k)


def resident_layout(obs_dim: int, sizes, outs: int) -> ResidentLayout:
    """A trunk ``sizes`` on ``obs_dim`` inputs with a head of ``outs``
    outputs as ``pack_resident`` lays it out: each layer's blocks from byte
    ``w[l]`` (``2 k n`` bytes), in layer order, then the biases (``4 n``
    bytes each)."""
    return _resident_layout((int(obs_dim), *(int(s) for s in sizes), int(outs)))


@functools.lru_cache(maxsize=64)
def _resident_layout(dims: tuple) -> ResidentLayout:
    k = tuple(_pad(d) for d in dims[:-1])
    n = tuple(_pad(d) for d in dims[1:])
    w, at = [], 0
    for kl, nl in zip(k, n):
        w.append(at)
        at += 2 * kl * nl
    b = []
    for nl in n:
        b.append(at)
        at += 4 * nl
    return ResidentLayout(dims, k, n, tuple(w), tuple(b), at)


def swizzle(r, k):
    """Byte offset of entry (line ``r``, input ``k`` < RES_KC) in a weight
    block: 64 bytes a line, the 16-byte group ``k // 8`` at group ``(k //
    8) ^ (r // 2) % 4``. Ints or integer tensors; csrc/policy_resident.cuh's
    ``swizzle`` is the same formula."""
    return r * RES_KC * 2 + ((((k >> 3) ^ (r >> 1)) & 3) << 4) + (k & 7) * 2


def resident_offset(r, k, k_pad: int, n_pad: int):
    """Byte offset of ``W^T`` entry (unit ``r``, input ``k``) from a layer's
    first block (padded widths ``k_pad`` x ``n_pad``): chunk ``r // RES_NC``
    after the chunks before it, its block ``k // RES_KC`` of ``min(RES_NC,
    n_pad - chunk RES_NC)`` lines, the entry swizzled in it."""
    c = r // RES_NC
    rest = n_pad - c * RES_NC
    lines = torch.clamp(rest, max=RES_NC) if isinstance(rest, Tensor) else min(rest, RES_NC)
    return c * RES_NC * k_pad * 2 + (k // RES_KC) * lines * RES_KC * 2 + swizzle(r % RES_NC, k % RES_KC)


def _matrix_slots(lay: ResidentLayout, l: int) -> Tensor:
    """The bf16 slot of each entry of ``W_l (in, out)``, row-major."""
    kk, rr = torch.meshgrid(torch.arange(lay.dims[l]), torch.arange(lay.dims[l + 1]), indexing="ij")
    return ((lay.w[l] + resident_offset(rr, kk, lay.k[l], lay.n[l])) // 2).reshape(-1)


@functools.lru_cache(maxsize=32)
def _resident_index(lay: ResidentLayout, device: str, transposed: tuple = ()) -> Tensor:
    """For each 16-bit word of the image, the word ``pack_resident`` copies
    into it from ``[bf16(src) | src's f32 words | 0]``, where ``src`` is the
    matrices ``W_l (in, out)`` row-major (``W_l^T`` row-major where
    ``transposed[l]``), then the biases, in layer order: a matrix entry's
    bf16, a bias's two f32 halves, the zero word for the padding."""
    dims = lay.dims
    n_mats = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    n_src = n_mats + sum(dims[1:])
    g = torch.full((lay.bytes // 2,), 3 * n_src, dtype=torch.int64)
    at = 0
    for l in range(lay.layers):
        size = dims[l] * dims[l + 1]
        order = torch.arange(size)
        if l < len(transposed) and transposed[l]:  # entry (k, r) at r in + k
            order = order.reshape(dims[l + 1], dims[l]).T.reshape(-1)
        g[_matrix_slots(lay, l)] = at + order
        at += size
    for l in range(lay.layers):
        g[lay.b[l] // 2 : lay.b[l] // 2 + 2 * dims[l + 1]] = n_src + 2 * at + torch.arange(2 * dims[l + 1])
        at += dims[l + 1]
    return g.to(device)


def pack_resident(weights, biases, head_w: Tensor, head_b: Tensor) -> Tensor:
    """One trunk (``weights[i] (in, out)``, biases of any shape, ``head_w
    (in, outs)``) → its resident image, a uint8 tensor on their device: the
    matrices rounded to bf16 (nearest even, the values the per-layer GEMM
    rounds them to as it reads them), the biases f32, the padding zero.
    One gather (``_resident_index``); a matrix given as the transpose of a
    contiguous tensor (``nn.Linear.weight.T``) is read in that order, with
    no copy."""
    mats = [t.detach() for t in (*weights, head_w)]
    lay = resident_layout(mats[0].shape[0], [t.shape[1] for t in weights], head_w.shape[1])
    transposed = tuple(not t.is_contiguous() and t.T.is_contiguous() for t in mats)
    flat = [(t.T if tr else t).reshape(-1) for t, tr in zip(mats, transposed)]
    src = torch.cat([t.float() for t in (*flat, *(b.detach().reshape(-1) for b in (*biases, head_b)))])
    words = torch.cat([src.to(torch.bfloat16).view(torch.int16), src.view(torch.int16), _zero_word(str(src.device))])
    return words[_resident_index(lay, str(src.device), transposed if any(transposed) else ())].view(torch.uint8)


@functools.lru_cache(maxsize=8)
def _zero_word(device: str) -> Tensor:
    """The image's padding word, made once a device (a fill kernel fewer a pack)."""
    return torch.zeros(1, dtype=torch.int16, device=device)


def unpack_resident(image: Tensor, lay: ResidentLayout) -> tuple[list[Tensor], list[Tensor]]:
    """``pack_resident``'s inverse: the matrices bf16 ``(in, out)`` and the
    biases f32 ``(out,)``, head last."""
    half = image.view(torch.bfloat16)
    mats = [half[_matrix_slots(lay, l).to(image.device)].reshape(lay.dims[l], lay.dims[l + 1])
            for l in range(lay.layers)]
    biases = [image[lay.b[l] : lay.b[l] + 4 * lay.dims[l + 1]].view(torch.float32).clone() for l in range(lay.layers)]
    return mats, biases


def resident_width(layouts) -> int:
    """The activation buffers' width: the widest padded input of the trunks."""
    return max(max(lay.k) for lay in layouts)


def resident_smem(tile: int, width: int, act_dim: int, logp: bool = False) -> int:
    """Dynamic shared memory of a resident launch (csrc's ``smem_bytes``):
    the ring, two bf16 activation buffers of ``width`` + RES_ACT_PAD
    columns, two f32 bias buffers (a layer's and the next one's) of the
    widest padded output (``width`` or the head's), K3g's staged means
    (``logp``, an odd stride) and the ring's full and empty barriers."""
    bias = max(width, _pad(act_dim))
    means = tile * (act_dim | 1) * 4 if logp else 0
    return RES_STAGES * RES_STAGE_BYTES + 2 * tile * (width + RES_ACT_PAD) * 2 + 2 * bias * 4 + means + RES_STAGES * 16


def resident_tile(layouts, act_dim: int, logp: bool = False) -> int | None:
    """Rows a block of the resident route takes for trunks launched together
    (K4g: actor and critic; K3g, ``logp``: the actor), or None for the
    per-layer route: at most RES_MAX_LAYERS layers each, and the first of
    RES_TILES whose ``resident_smem`` fits RES_SMEM_LIMIT."""
    if any(lay.layers > RES_MAX_LAYERS or lay.bytes >= 2**31 for lay in layouts):
        return None
    width = resident_width(layouts)
    return next((t for t in RES_TILES if resident_smem(t, width, act_dim, logp) <= RES_SMEM_LIMIT), None)


RES_CLUSTERS = (2, 4, 8)  # blocks a cluster
CLUSTER_TILE = 64  # rows a cluster's tile


def cluster_width(layouts, cluster: int) -> int:
    """The columns of a cluster block's activation buffers: each trunk's
    whole padded input and rank 0's share of each tanh layer's output, the
    largest (a run of ceil(chunks / C) chunks of RES_NC units)."""
    share = lambda n: -(-(-(-n // RES_NC)) // cluster) * RES_NC  # noqa: E731
    return max(max(lay.k[0], *(share(n) for n in lay.n[:-1])) for lay in layouts)


def cluster_smem(tile: int, width: int, act_dim: int, logp: bool = False) -> int:
    """Dynamic shared memory of a cluster launch (csrc's
    ``cluster::smem_bytes``): ``resident_smem``'s ring, biases, means and
    barriers, two activation buffers of ``width`` columns in k blocks (no
    row padding) and two stages of a peer's k block (``tile`` x RES_KC
    bf16)."""
    bias = max(width, _pad(act_dim))
    means = tile * (act_dim | 1) * 4 if logp else 0
    return (RES_STAGES * RES_STAGE_BYTES + 2 * tile * width * 2 + 2 * tile * RES_KC * 2 + 2 * bias * 4 + means
            + RES_STAGES * 16)


def cluster_plan(layouts, act_dim: int, logp: bool = False, rows: int | None = None,
                 sms: int | None = None) -> tuple[int, int] | None:
    """(rows a tile, blocks a cluster) of the cluster route for trunks
    launched together, or None: at most RES_MAX_LAYERS layers each and a
    ``cluster_smem`` at ``cluster_width`` within RES_SMEM_LIMIT at some C of
    RES_CLUSTERS, at CLUSTER_TILE rows. The smallest such C (the fewest
    peer loads; the route's envelope), unless ``rows`` on a card of ``sms``
    SMs give one block a tile for every SM or fewer at a larger C: then the
    largest such C up to the widest tanh layer's chunks (the fewest chunks a
    rank, so the shortest tile)."""
    if any(lay.layers > RES_MAX_LAYERS or lay.bytes >= 2**31 for lay in layouts):
        return None
    fits = [c for c in RES_CLUSTERS
            if cluster_smem(CLUSTER_TILE, cluster_width(layouts, c), act_dim, logp) <= RES_SMEM_LIMIT]
    if not fits:
        return None
    if rows is not None and sms is not None:
        chunks = max([-(-n // RES_NC) for lay in layouts for n in lay.n[:-1]], default=1)
        clusters = -(-int(rows) // CLUSTER_TILE) * len(layouts)
        one_round = [c for c in fits if c <= chunks and clusters * c <= sms]
        if one_round:
            return CLUSTER_TILE, max(one_round)
    return CLUSTER_TILE, fits[0]


def _sms(device: torch.device) -> int | None:
    """The SMs of a CUDA ``device`` (None for another device)."""
    return _cuda_sms(device.index) if device.type == "cuda" else None


@functools.lru_cache(maxsize=8)
def _cuda_sms(index: int | None) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _route(layouts, act_dim: int, logp: bool) -> str:
    if resident_tile(layouts, act_dim, logp) is not None:
        return "resident"
    return "cluster" if cluster_plan(layouts, act_dim, logp) is not None else "per_layer"


def resident_layouts(w) -> tuple[ResidentLayout, ResidentLayout]:
    """The (actor, critic) resident layouts of ``cuda_policy.PolicyWeights`` ``w``."""
    return (resident_layout(w.obs_dim, [t.shape[1] for t in w.pi_w], w.act_dim),
            resident_layout(w.obs_dim, [t.shape[1] for t in w.vf_w], 1))


def forward_route(w) -> str:
    """K4g's route for ``w``'s widths: ``"resident"``, ``"cluster"`` or
    ``"per_layer"``."""
    return _route(resident_layouts(w), w.act_dim, False)


def trunk_images(w, leaves, n_pi: int) -> tuple[Tensor, Tensor]:
    """K4g's (actor, critic) images for ``cuda_policy.prepare_weights``: the
    resident and cluster routes' bf16 images of ``w``'s weights, or the
    per-layer route's (``pack_trunk``) of the ordered ``leaves``."""
    if forward_route(w) != "per_layer":
        return (pack_resident(w.pi_w, w.pi_b, w.pi_head_w, w.pi_head_b),
                pack_resident(w.vf_w, w.vf_b, w.vf_head_w, w.vf_head_b))
    i_head, i_vf0 = 2 * n_pi, 2 * n_pi + 3
    i_vf_head = i_vf0 + 2 * len(w.vf_w)
    return (pack_trunk(leaves[:i_head:2], leaves[1:i_head:2], leaves[i_head], leaves[i_head + 1]),
            pack_trunk(leaves[i_vf0:i_vf_head:2], leaves[i_vf0 + 1:i_vf_head:2], leaves[i_vf_head],
                       leaves[i_vf_head + 1]))


def image_sizes(w) -> list[tuple[int]]:
    """The shapes of ``w``'s two images on K4g's route."""
    if forward_route(w) != "per_layer":
        return [(lay.bytes,) for lay in resident_layouts(w)]
    return [(nbytes,) for _, nbytes in weight_layouts(w)]


class _ResidentTrunkC(ctypes.Structure):
    """Mirror of ``struct ResidentTrunk`` in csrc/policy_resident.cuh."""

    _fields_ = [("layers", ctypes.c_int)] + [(name, ctypes.c_int * RES_MAX_LAYERS) for name in ("k", "n", "w", "b")] + [
        ("bytes", ctypes.c_int)]


class _ResidentArgsC(ctypes.Structure):
    """Mirror of ``struct ResidentArgs`` in csrc/policy_resident.cuh."""

    _fields_ = [("x", ctypes.c_void_p), ("image", ctypes.c_void_p * 2), ("out", ctypes.c_void_p * 2),
                ("log_std", ctypes.c_void_p), ("trunk", _ResidentTrunkC * 2)] + [
        (name, ctypes.c_int) for name in ("n", "ld", "obs_dim", "act_dim", "has_range")] + [
        ("ls_lo", ctypes.c_float), ("ls_hi", ctypes.c_float)] + [
        (name, ctypes.c_int) for name in ("tile", "width")]


def _resident_trunk_c(lay: ResidentLayout) -> _ResidentTrunkC:
    t = _ResidentTrunkC(layers=lay.layers, bytes=lay.bytes)
    for name in ("k", "n", "w", "b"):
        getattr(t, name)[: lay.layers] = getattr(lay, name)
    return t


def resident_args(x: Tensor, images, outs, lays, tile: int, obs_dim: int, act_dim: int, log_std=None,
                  log_std_range=None, width: int | None = None) -> _ResidentArgsC:
    """A resident (or, with ``width`` the ``cluster_width``, a cluster)
    launch's arguments: ``images``, ``outs`` and ``lays`` one or two each
    (K3g, K4g)."""
    ptr = lambda ts: [t.data_ptr() for t in ts] + [0] * (2 - len(ts))  # noqa: E731
    has_range, lo, hi = cuda_sgd._range_args(log_std_range)
    args = _ResidentArgsC(x=x.data_ptr(), log_std=0 if log_std is None else log_std.data_ptr(), n=x.shape[0],
                          ld=x.shape[1], obs_dim=obs_dim, act_dim=act_dim, has_range=has_range, ls_lo=lo, ls_hi=hi,
                          tile=tile, width=resident_width(lays) if width is None else width)
    args.image[:] = ptr(images)
    args.out[:] = ptr(outs)
    for i, lay in enumerate(lays):
        args.trunk[i] = _resident_trunk_c(lay)
    return args


# ---------------------------------------------------------------------------
# K4g: the actor-critic forward
# ---------------------------------------------------------------------------


class _ForwardArgsC(ctypes.Structure):
    """Mirror of ``struct GeneralForwardArgs`` in csrc/policy_general.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("obs", "pi_image", "vf_image", "ws", "mean", "value")] + [
        ("pi", _TrunkC), ("vf", _TrunkC)] + [
        (name, ctypes.c_longlong) for name in ("pi_bytes", "vf_bytes", "ws_elems")] + [
        (name, ctypes.c_int) for name in ("n", "obs_dim", "act_dim")]


FORWARD_KERNEL = Kernel("policy_general.cu", "general_policy_value_forward", [ctypes.c_void_p, ctypes.c_void_p])
RESIDENT_FORWARD_KERNEL = Kernel("policy_general.cu", "general_resident_forward", [ctypes.c_void_p, ctypes.c_void_p])
CLUSTER_FORWARD_KERNEL = Kernel("policy_general.cu", "general_cluster_forward",
                                [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def _launch(kernel: Kernel, args: ctypes.Structure, device, *extra) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel.fn()(ctypes.addressof(args), *extra, stream)
    kernel.check(rc)
    kernel.launches += 1


def forward(obs: Tensor, w) -> tuple[Tensor, Tensor]:
    """K4g on CUDA ``obs`` (n, obs_dim) f32 with ``cuda_policy.PolicyWeights``
    holding general images (``cuda_policy._check_kernel_shapes`` has
    checked them) on the route of its widths (``forward_route``): ``(mean
    (n, act), value (n,))``."""
    route = forward_route(w)
    if route == "per_layer":
        return forward_per_layer(obs, w, w.pi_image, w.vf_image)
    n = obs.shape[0]
    mean = torch.empty((n, w.act_dim), dtype=torch.float32, device=obs.device)
    value = torch.empty((n,), dtype=torch.float32, device=obs.device)
    if n == 0:
        return mean, value
    lays = resident_layouts(w)
    if route == "cluster":
        tile, c = cluster_plan(lays, w.act_dim, rows=n, sms=_sms(obs.device))
        args = resident_args(obs, (w.pi_image, w.vf_image), (mean, value), lays, tile, w.obs_dim, w.act_dim,
                             width=cluster_width(lays, c))
        _launch(CLUSTER_FORWARD_KERNEL, args, obs.device, c)
        return mean, value
    args = resident_args(obs, (w.pi_image, w.vf_image), (mean, value), lays, resident_tile(lays, w.act_dim), w.obs_dim,
                         w.act_dim)
    _launch(RESIDENT_FORWARD_KERNEL, args, obs.device)
    return mean, value


def _check_images(layouts, *images: Tensor) -> None:
    for (_, nbytes), image in zip(layouts, images):
        if image.dtype != torch.uint8 or tuple(image.shape) != (nbytes,) or image.data_ptr() % 16:
            raise ValueError("the per-layer route reads a 16-byte aligned image of pack_trunk's layout")


def forward_per_layer(obs: Tensor, w, pi_image: Tensor, vf_image: Tensor) -> tuple[Tensor, Tensor]:
    """K4g's per-layer route on the trunks' images (``pack_trunk``)."""
    n = obs.shape[0]
    mean = torch.empty((n, w.act_dim), dtype=torch.float32, device=obs.device)
    value = torch.empty((n,), dtype=torch.float32, device=obs.device)
    if n == 0:
        return mean, value
    lays = weight_layouts(w)
    _check_images(lays, pi_image, vf_image)
    (pi, pi_bytes), (vf, vf_bytes) = lays
    (pi_out, vf_out), ws_elems = forward_outputs(n, w.obs_dim, pi, vf)
    ws = torch.empty((ws_elems,), dtype=torch.bfloat16, device=obs.device)
    keep: list = []
    args = _ForwardArgsC(
        obs.data_ptr(), pi_image.data_ptr(), vf_image.data_ptr(), ws.data_ptr(), mean.data_ptr(),
        value.data_ptr(), _trunk_c(pi, pi_out, keep), _trunk_c(vf, vf_out, keep),
        pi_bytes, vf_bytes, ws_elems, n, w.obs_dim, w.act_dim,
    )
    _launch(FORWARD_KERNEL, args, obs.device)
    return mean, value


# ---------------------------------------------------------------------------
# K3g: log-prob of the stored actions
# ---------------------------------------------------------------------------


class _LogpArgsC(ctypes.Structure):
    """Mirror of ``struct GeneralLogpArgs`` in csrc/policy_general.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("rows", "image", "log_std", "ws", "mean", "out")] + [
        ("pi", _TrunkC), ("image_bytes", ctypes.c_longlong), ("ws_elems", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in ("n", "feat", "obs_dim", "act_dim", "has_range")] + [
        ("ls_lo", ctypes.c_float), ("ls_hi", ctypes.c_float)]


LOGP_KERNEL = Kernel("policy_general.cu", "general_logp_forward", [ctypes.c_void_p, ctypes.c_void_p])
RESIDENT_LOGP_KERNEL = Kernel("policy_general.cu", "general_resident_logp", [ctypes.c_void_p, ctypes.c_void_p])
CLUSTER_LOGP_KERNEL = Kernel("policy_general.cu", "general_cluster_logp",
                             [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def logp_route(obs_dim: int, act_dim: int, sizes) -> str:
    """K3g's route for the actor's widths: ``"resident"``, ``"cluster"`` or
    ``"per_layer"``."""
    return _route((resident_layout(obs_dim, sizes, act_dim),), act_dim, True)


def _actor(pi_leaves: list[Tensor]) -> tuple[list[Tensor], list[Tensor], Tensor, Tensor]:
    """The actor's leaves ``[W_0, b_0, ..., W_head, b_head, log_std]`` as
    (matrices, biases, head_w, head_b)."""
    n_pi = (len(pi_leaves) - 3) // 2
    return pi_leaves[:2 * n_pi:2], pi_leaves[1:2 * n_pi:2], pi_leaves[2 * n_pi], pi_leaves[2 * n_pi + 1]


def logp(packed: Tensor, pi_leaves: list[Tensor], obs_dim: int, log_std_range=None) -> Tensor:
    """K3g on CUDA packed rows (``cuda_sgd.logp_forward`` has checked them)
    on the route of the actor's widths (``logp_route``): the actor's leaves
    are packed into its image on each call."""
    mats, biases, head_w, head_b = _actor(pi_leaves)
    act_dim = head_w.shape[1]
    sizes = [t.shape[1] for t in mats]
    route = logp_route(obs_dim, act_dim, sizes)
    if route == "per_layer":
        return logp_per_layer(packed, pi_leaves, obs_dim, log_std_range)
    image = pack_resident(mats, biases, head_w, head_b)
    launch = launch_resident_logp if route == "resident" else launch_cluster_logp
    return launch(packed, image, resident_layout(obs_dim, sizes, act_dim), pi_leaves[-1], obs_dim, log_std_range)


def logp_per_layer(packed: Tensor, pi_leaves: list[Tensor], obs_dim: int, log_std_range=None) -> Tensor:
    """K3g's per-layer route on the actor's image (``pack_trunk``), packed
    from the leaves on each call."""
    mats, biases, head_w, head_b = _actor(pi_leaves)
    act_dim = head_w.shape[1]
    sizes = [t.shape[1] for t in mats]
    n = packed.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=packed.device)
    if n == 0:
        return out
    pi, nbytes = layout(obs_dim, sizes, act_dim)
    image = pack_trunk(mats, biases, head_w, head_b)
    (pi_out,), ws_elems = forward_outputs(n, obs_dim, pi)
    ws = torch.empty((ws_elems,), dtype=torch.bfloat16, device=packed.device)
    mean = torch.empty((n, act_dim), dtype=torch.float32, device=packed.device)
    log_std = pi_leaves[-1].detach().to(torch.float32).reshape(-1).contiguous()
    has_range, lo, hi = cuda_sgd._range_args(log_std_range)
    keep: list = []
    args = _LogpArgsC(
        packed.data_ptr(), image.data_ptr(), log_std.data_ptr(), ws.data_ptr(), mean.data_ptr(), out.data_ptr(),
        _trunk_c(pi, pi_out, keep), nbytes, ws_elems, n, packed.shape[1], obs_dim, act_dim,
        has_range, lo, hi,
    )
    _launch(LOGP_KERNEL, args, packed.device)
    return out


def launch_resident_logp(packed: Tensor, image: Tensor, lay: ResidentLayout, log_std: Tensor, obs_dim: int,
                         log_std_range=None) -> Tensor:
    """K3g's resident launch on the actor's image (``pack_resident``), which
    ``logp`` packs from the leaves on each call."""
    tile = resident_tile((lay,), lay.dims[-1], True)
    if tile is None:
        raise NotImplementedError(f"trunk {lay.dims} outside the resident route (logp_route)")
    return _launch_logp(RESIDENT_LOGP_KERNEL, packed, image, lay, log_std, obs_dim, log_std_range, tile)


def launch_cluster_logp(packed: Tensor, image: Tensor, lay: ResidentLayout, log_std: Tensor, obs_dim: int,
                        log_std_range=None) -> Tensor:
    """K3g's cluster launch on the actor's image (``pack_resident``, as the
    resident route's)."""
    plan = cluster_plan((lay,), lay.dims[-1], True, rows=packed.shape[0], sms=_sms(packed.device))
    if resident_tile((lay,), lay.dims[-1], True) is not None or plan is None:
        raise NotImplementedError(f"trunk {lay.dims} outside the cluster route (logp_route)")
    tile, c = plan
    return _launch_logp(CLUSTER_LOGP_KERNEL, packed, image, lay, log_std, obs_dim, log_std_range, tile,
                        cluster_width((lay,), c), c)


def _launch_logp(kernel: Kernel, packed: Tensor, image: Tensor, lay: ResidentLayout, log_std: Tensor, obs_dim: int,
                 log_std_range, tile: int, width: int | None = None, *extra) -> Tensor:
    if image.dtype != torch.uint8 or tuple(image.shape) != (lay.bytes,) or image.data_ptr() % 16:
        raise ValueError("K3g reads a 16-byte aligned image of pack_resident's layout")
    n = packed.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=packed.device)
    if n == 0:
        return out
    log_std = log_std.detach().to(torch.float32).reshape(-1).contiguous()
    args = resident_args(packed, (image,), (out,), (lay,), tile, obs_dim, lay.dims[-1], log_std, log_std_range,
                         width)
    _launch(kernel, args, packed.device, *extra)
    return out


# ---------------------------------------------------------------------------
# K2g: a whole PPO epoch
# ---------------------------------------------------------------------------


class _GeneralEpochTrunkC(ctypes.Structure):
    """Mirror of ``struct GeneralEpochTrunk`` in csrc/fused_epoch_general.cu."""

    _fields_ = [("depth", ctypes.c_int), ("dims", ctypes.POINTER(ctypes.c_int))] + [
        (name, ctypes.POINTER(ctypes.c_longlong)) for name in ("w", "b", "img", "out", "act")] + [
        ("cs", ctypes.POINTER(ctypes.c_int))]


class _EpochArgsC(ctypes.Structure):
    """Mirror of ``struct GeneralEpochArgs`` in csrc/fused_epoch_general.cu."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("mbs", "adv_stats", "t0", "params", "mu", "nu", "metrics", "ws", "obs", "acts", "dz", "image",
                     "slot", "slab", "colsum", "part", "grad", "block_sq")
    ] + [("pi", _GeneralEpochTrunkC), ("vf", _GeneralEpochTrunkC)] + [
        (name, ctypes.c_longlong) for name in ("ws_floats", "acts_elems", "image_elems", "mean", "value")
    ] + [
        (name, ctypes.c_int) for name in ("ls_off", "P", "n_mb", "mb", "feat", "obs_dim", "act_dim", "dz_width",
                                          "cs_width", "cs_mean", "cs_value", "splits", "split_rows")
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


def _general_epoch_trunk_c(t: Trunk, ws: EpochWorkspace, i: int, keep: list) -> _GeneralEpochTrunkC:
    dims, cs = _arrays(keep, t.dims, ws.cs[i], ctype=ctypes.c_int)
    return _GeneralEpochTrunkC(t.depth, dims, *_arrays(keep, t.w, t.b, ws.img[i], ws.out[i], ws.act[i]), cs)


def launch_epoch(mbs, adv_stats, t0, leaves, mu, nu, cfg, route: str | None = None):
    """K2g's launch, after ``cuda_sgd.fused_epoch``'s checks, on the route of
    the widths (``epoch_route``) or on ``route`` when given (a timing of the
    per-layer route at widths the resident one takes): ``(leaves, mu, nu,
    metrics)``."""
    route = epoch_route(cfg) if route is None else route
    if route == "resident":
        return launch_resident_epoch(mbs, adv_stats, t0, leaves, mu, nu, cfg)
    if route != "per_layer":
        raise ValueError(f"unknown K2g route {route!r}")
    dev = mbs.device
    n_mb, mb_size, feat = mbs.shape
    net = dict(obs_dim=cfg.obs_dim, act_dim=cfg.act_dim, pi_sizes=cfg.pi_sizes, vf_sizes=cfg.vf_sizes)
    shapes = [s for _, s in cuda_sgd.leaf_specs(net)]
    offsets, P = cuda_sgd.flat_layout(shapes)
    params, m1, m2 = (cuda_sgd._to_flat(g, offsets, P) for g in (leaves, mu, nu))
    pi, vf, ls_off = leaf_trunks(cfg)
    ws = epoch_workspace(mb_size, pi, vf)
    splits, split_rows = wgrad_plan(mb_size, wgrad_tiles(pi, vf), _cuda_sms(dev.index), P)
    tiles = -(-mb_size // BM)
    empty = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device=dev)  # noqa: E731
    bf16 = torch.bfloat16
    bufs = dict(
        mbs=mbs.contiguous(), adv_stats=adv_stats.to(torch.float32).contiguous(),
        t0=t0.to(torch.int32).reshape(1).contiguous(), params=params, mu=m1, nu=m2,
        metrics=empty(n_mb, len(cuda_sgd.METRICS)), ws=empty(ws.floats),
        obs=empty(n_mb * mb_size * _kpad(cfg.obs_dim), dtype=bf16), acts=empty(ws.acts, dtype=bf16),
        dz=empty(4 * mb_size * ws.dz_width + mb_size * CRITIC_LD, dtype=bf16),
        image=torch.zeros((ws.image,), dtype=bf16, device=dev), slot=epoch_slots(cfg, dev),
        slab=empty(splits, P), colsum=empty(tiles, ws.cs_width), part=empty(tiles, 3 + cfg.act_dim),
        grad=empty(P), block_sq=empty(-(-P // _THREADS)),
    )
    keep: list = []
    has_range, lo, hi = cuda_sgd._range_args(cfg.log_std_range)
    args = _EpochArgsC(
        pi=_general_epoch_trunk_c(pi, ws, 0, keep), vf=_general_epoch_trunk_c(vf, ws, 1, keep), ws_floats=ws.floats,
        acts_elems=ws.acts, image_elems=ws.image, mean=ws.out[0][-1], value=ws.out[1][-1], ls_off=ls_off, P=P,
        n_mb=n_mb, mb=mb_size, feat=feat, obs_dim=cfg.obs_dim, act_dim=cfg.act_dim, dz_width=ws.dz_width,
        cs_width=ws.cs_width, cs_mean=ws.cs[0][-1], cs_value=ws.cs[1][-1], splits=splits, split_rows=split_rows,
        lr=cfg.learning_rate, clip_eps=cfg.clip_eps, ent_coef=cfg.entropy_coef, vf_coef=cfg.value_coef,
        max_grad_norm=cfg.max_grad_norm, has_range=has_range, ls_lo=lo, ls_hi=hi)
    for name, _ in _EpochArgsC._fields_[:18]:
        setattr(args, name, bufs[name].data_ptr())
    _launch(EPOCH_KERNEL, args, dev)
    return (cuda_sgd._from_flat(params, shapes, offsets), cuda_sgd._from_flat(m1, shapes, offsets),
            cuda_sgd._from_flat(m2, shapes, offsets), bufs["metrics"])


# ---------------------------------------------------------------------------
# K2g's resident route (csrc/fused_epoch_general.cu, namespace rep)
# ---------------------------------------------------------------------------

EPOCH_WG_BM = 128  # a weight-gradient block's units (rows of W_l) and outputs
EPOCH_WG_BK = 32  # rows a stage; a chunk of rows is a multiple of it
EPOCH_WG_WAVES = 2  # weight-gradient blocks about twice the card's SMs (the rows split to get there)
EPOCH_MAX_LOSS_SUMS = 256  # a 64-row block's threads: the loss's sums a tile, 2 + 2 act_dim


@dataclasses.dataclass(frozen=True)
class EpochTrunkLayout:
    """One trunk on the resident epoch: its forward image (``W_0 .. W_L``,
    the head last, as K4g's) and its backward image (``W_L^T .. W_1^T`` laid
    out as a trunk of their own from the head's outputs to the first tanh
    layer's, zero biases; None for a linear trunk)."""

    fwd: ResidentLayout
    bwd: ResidentLayout | None

    @property
    def depth(self) -> int:
        return self.fwd.layers - 1


def epoch_trunk_layout(obs_dim: int, sizes, outs: int) -> EpochTrunkLayout:
    dims = (int(obs_dim), *(int(s) for s in sizes), int(outs))
    bwd = _resident_layout(dims[:0:-1]) if len(dims) > 2 else None
    return EpochTrunkLayout(_resident_layout(dims), bwd)


def epoch_layouts(obs_dim: int, act_dim: int, pi_sizes, vf_sizes) -> tuple[EpochTrunkLayout, EpochTrunkLayout]:
    """The (actor, critic) images of the resident epoch."""
    return epoch_trunk_layout(obs_dim, pi_sizes, act_dim), epoch_trunk_layout(obs_dim, vf_sizes, 1)


def epoch_width(lays) -> int:
    """The activation buffers' width: the widest padded input of the four
    images and the heads' padded outputs (the data gradient's first input)."""
    widths = [w for lay in lays for w in (*lay.fwd.k, lay.fwd.n[-1], *(lay.bwd.k if lay.bwd else ()))]
    return max(widths)


def epoch_smem(tile: int, width: int, act_dim: int) -> int:
    """Dynamic shared memory of a resident fwd_bwd block (csrc's
    ``rep::smem_bytes``): ``resident_smem``'s ring, activation and bias
    buffers and barriers, the staged head outputs (then their dz), and the
    per-warp sums (the loss's, then the data gradient's column sums)."""
    sums = tile // 32 * max(width, 2 + 2 * act_dim) * 4
    return resident_smem(tile, width, act_dim, logp=True) + sums


def epoch_tile(lays, act_dim: int) -> int | None:
    """Rows a fwd_bwd block of the resident epoch takes, or None for the
    per-layer route: both trunks of at most RES_MAX_LAYERS layers, at most
    EPOCH_MAX_LOSS_SUMS loss sums a tile, and the first of RES_TILES whose
    ``epoch_smem`` fits RES_SMEM_LIMIT."""
    images = [im for lay in lays for im in (lay.fwd, lay.bwd) if im is not None]
    if any(im.layers > RES_MAX_LAYERS or im.bytes >= 2**31 for im in images):
        return None
    if 2 + 2 * act_dim > EPOCH_MAX_LOSS_SUMS:
        return None
    width = epoch_width(lays)
    return next((t for t in RES_TILES if epoch_smem(t, width, act_dim) <= RES_SMEM_LIMIT), None)


def epoch_route(cfg) -> str:
    """K2g's route for an ``EpochConfig``'s widths: ``"resident"`` or
    ``"per_layer"``."""
    lays = epoch_layouts(cfg.obs_dim, cfg.act_dim, cfg.pi_sizes, cfg.vf_sizes)
    return "resident" if epoch_tile(lays, cfg.act_dim) is not None else "per_layer"


@dataclasses.dataclass(frozen=True)
class ResidentWorkspace:
    """The resident epoch's buffers for minibatches of ``mb`` rows in
    ``tiles`` tiles of ``tile`` rows (``rows`` = tiles x tile): per trunk
    and layer the offsets of its bf16 input tiles (``act``, rows x
    fwd.k[l], in ``acts`` elements), its bf16 dz tiles (``dz``, rows x
    fwd.n[l]), a tanh layer's f32 outputs (``fac``, rows x fwd.n[l]; the
    head's 0, unused) and its column sums' first column in a colsum row
    (``cs``); the weight gradient's row chunks."""

    tile: int
    tiles: int
    rows: int
    act: tuple
    dz: tuple
    fac: tuple
    cs: tuple
    acts: int
    dzs: int
    factor: int
    cs_width: int
    splits: int
    split_rows: int


def wgrad_jobs(lays) -> int:
    """The weight gradient's blocks a row chunk: each layer's outputs in
    EPOCH_WG_BM x EPOCH_WG_BM tiles (csrc's ``rep::wgrad_jobs``)."""
    up = lambda x: -(-x // EPOCH_WG_BM)  # noqa: E731
    return sum(up(k) * up(n) for lay in lays for k, n in zip(lay.fwd.k, lay.fwd.n))


def resident_workspace(mb: int, tile: int, lays, sms: int) -> ResidentWorkspace:
    """The buffers' layout for ``mb`` rows a minibatch on a card of ``sms``
    SMs: the weight gradient's rows split into chunks of a multiple of
    EPOCH_WG_BK rows, enough for about EPOCH_WG_WAVES blocks an SM."""
    tiles = -(-int(mb) // tile)
    rows = tiles * tile
    act, dz, fac, cs = [], [], [], []
    a_at = d_at = f_at = 0
    cs_width = 0
    for lay in lays:
        ta, td, tf, tc = [], [], [], []
        c_at = 0
        for l in range(lay.fwd.layers):
            ta.append(a_at)
            a_at += rows * lay.fwd.k[l]
            td.append(d_at)
            d_at += rows * lay.fwd.n[l]
            if l < lay.depth:
                tf.append(f_at)
                f_at += rows * lay.fwd.n[l]
            else:
                tf.append(0)
            tc.append(c_at)
            c_at += lay.fwd.n[l]
        cs_width = max(cs_width, c_at)
        act.append(tuple(ta))
        dz.append(tuple(td))
        fac.append(tuple(tf))
        cs.append(tuple(tc))
    jobs = wgrad_jobs(lays)
    splits = max(1, min(rows // EPOCH_WG_BK, -(-EPOCH_WG_WAVES * int(sms) // jobs)))
    split_rows = -(-(-(-rows // splits)) // EPOCH_WG_BK) * EPOCH_WG_BK
    splits = -(-rows // split_rows)
    return ResidentWorkspace(tile, tiles, rows, tuple(act), tuple(dz), tuple(fac), tuple(cs), max(a_at, 8),
                             max(d_at, 8), max(f_at, 2), cs_width, splits, split_rows)


class _EpochTrunkC(ctypes.Structure):
    """Mirror of ``struct EpochTrunk`` in csrc/fused_epoch_general.cu."""

    _fields_ = [("dims", ctypes.c_int * (RES_MAX_LAYERS + 1))] + [
        (name, ctypes.c_int * RES_MAX_LAYERS) for name in ("w_off", "b_off")] + [
        (name, ctypes.c_longlong * RES_MAX_LAYERS) for name in ("act", "dz", "fac")] + [
        ("cs", ctypes.c_int * RES_MAX_LAYERS), ("fwd", _ResidentTrunkC), ("bwd", _ResidentTrunkC)]


class _ResidentEpochArgsC(ctypes.Structure):
    """Mirror of ``struct ResidentEpochArgs`` in csrc/fused_epoch_general.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("mbs", "adv_stats", "t0", "params", "mu", "nu", "metrics")] + [
        ("image", ctypes.c_void_p * 4)] + [
        (name, ctypes.c_void_p) for name in ("acts", "dzs", "factor", "colsum", "part", "slab", "grad",
                                             "block_sq")] + [
        ("trunk", _EpochTrunkC * 2)] + [
        (name, ctypes.c_int) for name in ("ls_off", "P", "n_mb", "mb", "feat", "obs_dim", "act_dim", "tile", "width",
                                          "cs_width", "splits", "split_rows")] + [
        (name, ctypes.c_float) for name in ("lr", "clip_eps", "ent_coef", "vf_coef", "max_grad_norm")] + [
        ("has_range", ctypes.c_int), ("ls_lo", ctypes.c_float), ("ls_hi", ctypes.c_float)]


RESIDENT_EPOCH_KERNEL = Kernel("fused_epoch_general.cu", "fused_epoch_general_resident",
                               [ctypes.c_void_p, ctypes.c_void_p])


def _epoch_trunk_c(lay: EpochTrunkLayout, t: Trunk, ws: ResidentWorkspace, i: int) -> _EpochTrunkC:
    c = _EpochTrunkC(fwd=_resident_trunk_c(lay.fwd))
    if lay.bwd is not None:
        c.bwd = _resident_trunk_c(lay.bwd)
    c.dims[: len(t.dims)] = t.dims
    for name, values in (("w_off", t.w), ("b_off", t.b), ("act", ws.act[i]), ("dz", ws.dz[i]), ("fac", ws.fac[i]),
                         ("cs", ws.cs[i])):
        getattr(c, name)[: len(values)] = values
    return c


def resident_epoch_args(bufs: dict, cfg, n_mb: int, mb: int, feat: int, P: int, ls_off: int, trunks,
                        lays, ws: ResidentWorkspace) -> _ResidentEpochArgsC:
    """The resident epoch's launch arguments on the tensors of ``bufs``."""
    has_range, lo, hi = cuda_sgd._range_args(cfg.log_std_range)
    args = _ResidentEpochArgsC(
        ls_off=ls_off, P=P, n_mb=n_mb, mb=mb, feat=feat, obs_dim=cfg.obs_dim, act_dim=cfg.act_dim, tile=ws.tile,
        width=epoch_width(lays), cs_width=ws.cs_width, splits=ws.splits, split_rows=ws.split_rows,
        lr=cfg.learning_rate, clip_eps=cfg.clip_eps, ent_coef=cfg.entropy_coef, vf_coef=cfg.value_coef,
        max_grad_norm=cfg.max_grad_norm, has_range=has_range, ls_lo=lo, ls_hi=hi)
    for name in ("mbs", "adv_stats", "t0", "params", "mu", "nu", "metrics", "acts", "dzs", "factor", "colsum",
                 "part", "slab", "grad", "block_sq"):
        setattr(args, name, bufs[name].data_ptr())
    args.image[:] = [im.data_ptr() for im in bufs["images"]]
    for i in range(2):
        args.trunk[i] = _epoch_trunk_c(lays[i], trunks[i], ws, i)
    return args


def launch_resident_epoch(mbs, adv_stats, t0, leaves, mu, nu, cfg):
    """K2g's resident launch (``launch_epoch`` on ``epoch_route``'s
    ``"resident"``): ``(leaves, mu, nu, metrics)``."""
    lays = epoch_layouts(cfg.obs_dim, cfg.act_dim, cfg.pi_sizes, cfg.vf_sizes)
    tile = epoch_tile(lays, cfg.act_dim)
    if tile is None:
        raise NotImplementedError(f"trunks {cfg.pi_sizes} / {cfg.vf_sizes} outside K2g's resident route (epoch_route)")
    dev = mbs.device
    n_mb, mb_size, feat = mbs.shape
    net = dict(obs_dim=cfg.obs_dim, act_dim=cfg.act_dim, pi_sizes=cfg.pi_sizes, vf_sizes=cfg.vf_sizes)
    shapes = [s for _, s in cuda_sgd.leaf_specs(net)]
    offsets, P = cuda_sgd.flat_layout(shapes)
    params, m1, m2 = (cuda_sgd._to_flat(g, offsets, P) for g in (leaves, mu, nu))
    pi, vf, ls_off = leaf_trunks(cfg)
    ws = resident_workspace(mb_size, tile, lays, torch.cuda.get_device_properties(dev).multi_processor_count)
    empty = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device=dev)  # noqa: E731
    bufs = dict(
        mbs=mbs.contiguous(), adv_stats=adv_stats.to(torch.float32).contiguous(),
        t0=t0.to(torch.int32).reshape(1).contiguous(), params=params, mu=m1, nu=m2,
        metrics=empty(n_mb, len(cuda_sgd.METRICS)),
        images=[torch.zeros((im.bytes if im is not None else 16,), dtype=torch.uint8, device=dev)
                for lay in lays for im in (lay.fwd, lay.bwd)],
        acts=empty(ws.acts, dtype=torch.bfloat16), dzs=empty(ws.dzs, dtype=torch.bfloat16), factor=empty(ws.factor),
        colsum=empty(2, ws.tiles, ws.cs_width), part=empty(ws.tiles, 3 + cfg.act_dim), slab=empty(ws.splits, P),
        grad=empty(P), block_sq=empty(-(-P // _THREADS)),
    )
    args = resident_epoch_args(bufs, cfg, n_mb, mb_size, feat, P, ls_off, (pi, vf), lays, ws)
    _launch(RESIDENT_EPOCH_KERNEL, args, dev)
    return (cuda_sgd._from_flat(params, shapes, offsets), cuda_sgd._from_flat(m1, shapes, offsets),
            cuda_sgd._from_flat(m2, shapes, offsets), bufs["metrics"])
