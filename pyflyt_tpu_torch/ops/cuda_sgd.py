"""PPO's SGD kernels (port of ``pyflyt_tpu/ops/pallas_sgd.py``).

- ``logp_forward`` (K3): the policy log-prob of the stored actions over the
  packed PPO rows ``[obs | action | ...]``, with the epoch kernel's own
  arithmetic. CUDA entry ``logp_forward`` of ``csrc/policy_value_forward.cu``;
  the actor's weights reach it as K4's do, packed into their shared-memory
  image (``cuda_policy.pack_trunk``) on each call.
- ``fused_epoch`` (K2): a whole PPO epoch, per minibatch in order: forward,
  clipped-surrogate + value loss, backward by hand, global-norm clip, Adam,
  one metrics row. ``csrc/fused_epoch.cu`` on ``csrc/policy_mlp.cuh``: each
  trunk's weights reach it as the same image (``cuda_policy.pack_trunk``),
  which the kernel writes itself after every Adam step (``image_slots``).

Both compute the Pallas kernels' arithmetic: every matmul takes bf16-rounded
inputs (round to nearest even) and accumulates in f32; everything
elementwise, the reductions, the clip and Adam are f32. The f32
exact-semantics path is ``PPOConfig(fused_sgd=False)`` (autograd on the f32
``ActorCritic``), as the XLA scan is in the JAX package. Each wrapper
launches its kernel for CUDA tensors and runs its plain twin
(``*_plain``) for CPU tensors; the twins' matmuls are the module-level
``_mm``, ``_mm_tn`` and ``_mm_nt``, which a test may replace with f32
products. The twins take any widths, and so do the kernels, in three
families that ``_check_envelope`` chooses between: two 256-wide tanh
layers per trunk (``csrc/policy_mlp.cuh``, layer 0's K one 64-wide chunk)
here, 1 to 4 layers of at most 128 units each through
``ops/cuda_narrow.py`` (both at obs widths up to 64 and at most 8
actions), and every other network through ``ops/cuda_general.py``.

Parameters travel as the ordered leaf list of ``leaf_specs`` (flax layout:
weights ``(in, out)``, biases and log_std ``(1, n)``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
from torch import Tensor

from pyflyt_tpu_torch.ops.cuda_build import Kernel

HIDDEN = 256
MAX_OBS_DIM = 64  # K3 and K2 (csrc/policy_mlp.cuh: layer 0's K is one 64-wide chunk), and the narrow family
MAX_ACT_DIM = 8
MAX_DEPTH = 4  # the narrow family's tanh layers a trunk (csrc/policy_narrow.cuh)
MAX_WIDTH = 128  # and its widest layer

# Adam constants (optax.adam defaults; eps as rl/ppo.py)
B1 = 0.9
B2 = 0.999
ADAM_EPS = 1e-5
LOG2PI = math.log(2.0 * math.pi)
ENT_C = 0.5 * math.log(2.0 * math.pi * math.e)

METRICS = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl")

# the parts of csrc/fused_epoch.cu the wrapper sizes
TILE_M = 64  # rows a tile
BLOCK_BYTES = TILE_M * 64 * 2  # a 64 x 64 bf16 workspace block
TILE_BYTES = HIDDEN // 64 * BLOCK_BYTES  # a 64 x 256 activation tile
HEAD_TILE_BYTES = 8 * TILE_M * 2  # dmean / dvalue of a tile, K-major (8 x 64)
ACTS = 4  # workspace tiles a trunk and row tile: h1, h2, dz1, dz2
COLS = 2 * HIDDEN + 8  # column sums of a tile: dz1, dz2, dhead
_NPART = 3 + MAX_ACT_DIM
_THREADS = 256
WGRAD_JOBS = 12  # weight-gradient blocks a row split: per trunk W0, W1 x 4, head
CONSUMERS = 2  # consumer warpgroups a block of the forward/backward kernel
KERNELS_PER_MINIBATCH = 4  # CUDA kernels fused_epoch enqueues per minibatch
KERNELS_PER_CALL = 1  # and once per call: the first minibatch's weight images


# ---------------------------------------------------------------------------
# parameter leaves
# ---------------------------------------------------------------------------


def leaf_specs(net: dict) -> list[tuple[str, tuple[int, int]]]:
    """Ordered (name, shape) list of the parameter leaves (flax layout):
    pi trunk, pi_head, log_std, vf trunk, vf_head; biases and log_std as
    (1, n)."""
    leaves = []
    d = net["obs_dim"]
    for i, h in enumerate(net["pi_sizes"]):
        leaves.append((f"pi_{i}_w", (d, h)))
        leaves.append((f"pi_{i}_b", (1, h)))
        d = h
    leaves.append(("pi_head_w", (d, net["act_dim"])))
    leaves.append(("pi_head_b", (1, net["act_dim"])))
    leaves.append(("log_std", (1, net["act_dim"])))
    d = net["obs_dim"]
    for i, h in enumerate(net["vf_sizes"]):
        leaves.append((f"vf_{i}_w", (d, h)))
        leaves.append((f"vf_{i}_b", (1, h)))
        d = h
    leaves.append(("vf_head_w", (d, 1)))
    leaves.append(("vf_head_b", (1, 1)))
    return leaves


def params_to_leaves(network) -> list[Tensor]:
    """``rl.networks.ActorCritic`` → the ordered leaf list of ``leaf_specs``
    (weights as (in, out), as flax's ``Dense.kernel``). The leaves are views
    of the parameters."""
    out = []
    for lin in network.pi_trunk.layers:
        out += [lin.weight.T, lin.bias[None, :]]
    out += [network.pi_head.weight.T, network.pi_head.bias[None, :], network.log_std[None, :]]
    for lin in network.vf_trunk.layers:
        out += [lin.weight.T, lin.bias[None, :]]
    out += [network.vf_head.weight.T, network.vf_head.bias[None, :]]
    return out


def leaves_to_params(leaves: list[Tensor], network) -> None:
    """Writes an ordered leaf list into ``network``'s parameters, in place."""
    dst = params_to_leaves(network)
    if len(dst) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a network of {len(dst)}")
    with torch.no_grad():
        for d, s in zip(dst, leaves):
            d.copy_(s)


# ---------------------------------------------------------------------------
# the twins' matmuls: bf16-rounded inputs, f32 accumulation
# ---------------------------------------------------------------------------


def _bf(x: Tensor) -> Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _mm(a: Tensor, b: Tensor) -> Tensor:
    """a @ b with bf16 inputs, f32 accumulation."""
    return _bf(a) @ _bf(b)


def _mm_tn(a: Tensor, b: Tensor) -> Tensor:
    """a.T @ b with bf16 inputs, f32 accumulation (weight-gradient shape)."""
    return _bf(a).T @ _bf(b)


def _mm_nt(a: Tensor, b: Tensor) -> Tensor:
    """a @ b.T with bf16 inputs, f32 accumulation (data-gradient shape)."""
    return _bf(a) @ _bf(b).T


def _clip(x: Tensor, rng) -> Tensor:
    return x if rng is None else torch.clamp(x, rng[0], rng[1])


# ---------------------------------------------------------------------------
# K3: log-prob of the stored actions
# ---------------------------------------------------------------------------


def logp_forward_plain(
    packed: Tensor, pi_leaves: list[Tensor], obs_dim: int, log_std_range=None
) -> Tensor:
    """The kernel's arithmetic in plain PyTorch: ``(rows,)`` f32 log-probs of
    ``packed[:, obs_dim:obs_dim + act_dim]`` under the policy ``pi_leaves``
    (trunk w/b pairs, head w/b, log_std)."""
    n_pi = (len(pi_leaves) - 3) // 2
    act_dim = pi_leaves[-1].shape[-1]
    x = packed[:, :obs_dim]
    action = packed[:, obs_dim : obs_dim + act_dim]
    a = x
    for i in range(n_pi):
        a = torch.tanh(_mm(a, pi_leaves[2 * i]) + pi_leaves[2 * i + 1])
    mean = _mm(a, pi_leaves[2 * n_pi]) + pi_leaves[2 * n_pi + 1]
    log_std = _clip(pi_leaves[2 * n_pi + 2], log_std_range)
    var = torch.exp(2.0 * log_std)
    diff = action - mean
    lp = -0.5 * (diff * diff / var + 2.0 * log_std + LOG2PI)
    return torch.sum(lp, dim=-1)


class _LogpArgsC(ctypes.Structure):
    """Mirror of ``struct LogpArgs`` in csrc/policy_value_forward.cu."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("rows", "w0", "b0", "w1", "b1", "hw", "hb", "log_std", "out")
    ] + [
        ("n", ctypes.c_int), ("feat", ctypes.c_int), ("obs_dim", ctypes.c_int),
        ("act_dim", ctypes.c_int), ("has_range", ctypes.c_int),
        ("ls_lo", ctypes.c_float), ("ls_hi", ctypes.c_float),
    ]


LOGP_KERNEL = Kernel("policy_value_forward.cu", "logp_forward", [ctypes.c_void_p, ctypes.c_void_p])


def in_envelope(sizes) -> bool:
    """Whether a trunk's widths are the narrow family's: 1..MAX_DEPTH
    layers, each 1..MAX_WIDTH wide."""
    sizes = tuple(sizes)
    return 0 < len(sizes) <= MAX_DEPTH and all(0 < s <= MAX_WIDTH for s in sizes)


FAMILIES = ("wide", "narrow", "general")


def _misfit(family: str, obs_dim: int, act_dim: int, trunks: list) -> str | None:
    """Why ``family``'s kernels do not take these widths, or None."""
    if family == "general":
        return None
    got = f"got pi {trunks[0]} vf {trunks[1]}"
    if family == "wide" and not all(t == (HIDDEN, HIDDEN) for t in trunks):
        return f"the wide kernels take two {HIDDEN}-wide layers per trunk; {got}"
    if family == "narrow" and not all(in_envelope(t) for t in trunks):
        return f"the narrow kernels take 1 to {MAX_DEPTH} layers of at most {MAX_WIDTH} units each; {got}"
    if not 0 < obs_dim <= MAX_OBS_DIM:
        return f"obs width {obs_dim} outside 1..{MAX_OBS_DIM} (the {family} kernels)"
    if not 0 < act_dim <= MAX_ACT_DIM:
        return f"action width {act_dim} outside 1..{MAX_ACT_DIM} (the {family} kernels)"
    return None


def check_family(family: str, obs_dim: int, act_dim: int, pi_sizes, vf_sizes) -> None:
    """Raises ``NotImplementedError`` unless ``family``'s kernels take both
    trunks: the wide ones two 256-wide layers a trunk, the narrow ones 1 to
    4 layers of at most 128 units, both obs widths up to 64 and at most 8
    actions; the general ones any."""
    why = _misfit(family, obs_dim, act_dim, [tuple(pi_sizes), tuple(vf_sizes)])
    if why is not None:
        raise NotImplementedError(why)


def _check_envelope(obs_dim: int, act_dim: int, pi_sizes, vf_sizes) -> str:
    """The router in front of the card's policy kernels (K4, K3, K2 and
    their narrow and general families): the family that takes both trunks,
    one for all three, so that K3's log-probs are K2's forward. ``"wide"``
    for two 256-wide layers a trunk (``csrc/policy_value_forward.cu``,
    ``csrc/fused_epoch.cu``), ``"narrow"`` for 1 to 4 layers of at most 128
    units (``csrc/policy_narrow.cu``, ``csrc/fused_epoch_narrow.cu``), both
    at obs widths up to 64 and at most 8 actions, ``"general"``
    (``csrc/policy_general.cu``, ``csrc/fused_epoch_general.cu``) for every
    other network the Pallas builders take: any depth (0 included), any
    positive widths. Raises ``ValueError`` on a zero or negative width."""
    trunks = [tuple(pi_sizes), tuple(vf_sizes)]
    if obs_dim < 1 or act_dim < 1 or any(s < 1 for t in trunks for s in t):
        raise ValueError(f"obs {obs_dim}, act {act_dim}, trunks {trunks}: every width must be positive")
    return next(f for f in FAMILIES if _misfit(f, obs_dim, act_dim, trunks) is None)


def _range_args(log_std_range) -> tuple[int, float, float]:
    if log_std_range is None:
        return 0, 0.0, 0.0
    return 1, float(log_std_range[0]), float(log_std_range[1])


def logp_forward(
    packed: Tensor, pi_leaves: list[Tensor], obs_dim: int, log_std_range=None, *, vf_sizes
) -> Tensor:
    """Log-probs ``(rows,)`` of the stored actions in ``packed`` (rows,
    feat) f32 under ``pi_leaves``: the kernel for a CUDA tensor, the twin
    for a CPU one. The critic's widths ``vf_sizes`` choose the kernel: the
    family K2 takes for the pair (``_check_envelope``), so its log-probs
    are K2's forward bit for bit (PPO's ``fused_sgd_consistent_logp``)."""
    if packed.dtype != torch.float32 or packed.dim() != 2:
        raise ValueError(f"packed must be (rows, feat) float32, got {tuple(packed.shape)} {packed.dtype}")
    act_dim = pi_leaves[-1].shape[-1]
    if obs_dim + act_dim > packed.shape[1] or pi_leaves[0].shape[0] != obs_dim:
        raise ValueError(f"packed width {packed.shape[1]} does not hold obs {obs_dim} + actions {act_dim}")
    if packed.device.type == "cpu":
        return logp_forward_plain(packed, pi_leaves, obs_dim, log_std_range)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    n_pi = (len(pi_leaves) - 3) // 2
    family = _check_envelope(obs_dim, act_dim, [pi_leaves[2 * i].shape[1] for i in range(n_pi)], vf_sizes)
    if any(t.device != packed.device for t in pi_leaves):
        raise ValueError("leaves and rows must be on one device")
    from pyflyt_tpu_torch.ops import cuda_general, cuda_narrow, cuda_policy  # they import this module

    if family == "general":
        return cuda_general.logp(packed.contiguous(), pi_leaves, obs_dim, log_std_range)
    if family == "narrow":
        return cuda_narrow.logp(packed.contiguous(), pi_leaves, obs_dim, log_std_range)
    return _launch_logp(packed.contiguous(), cuda_policy.pack_trunk(*pi_leaves[:6]), pi_leaves[6], obs_dim,
                        log_std_range)


def _launch_logp(packed: Tensor, image: Tensor, log_std: Tensor, obs_dim: int, log_std_range=None) -> Tensor:
    """K3's launch on the actor's image (``cuda_policy.pack_trunk``), which
    ``logp_forward`` packs from the leaves on each call."""
    from pyflyt_tpu_torch.ops import cuda_policy

    n = packed.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=packed.device)
    if n == 0:
        return out
    log_std = log_std.detach().to(torch.float32).reshape(-1).contiguous()
    has_range, lo, hi = _range_args(log_std_range)
    args = _LogpArgsC(
        packed.data_ptr(), *cuda_policy.image_pointers(image), log_std.data_ptr(), out.data_ptr(),
        n, packed.shape[1], obs_dim, log_std.numel(), has_range, lo, hi,
    )
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = LOGP_KERNEL.fn()(ctypes.addressof(args), stream)
    LOGP_KERNEL.check(rc)
    LOGP_KERNEL.launches += 1
    return out


def trunk_macs(in_dim: int, sizes, outs: int) -> tuple[int, int]:
    """Multiply-adds a row of one trunk and its head needs, unpadded
    widths: ``(forward, data gradient)``, the data gradient through every
    layer but the first (the head included)."""
    dims = (in_dim, *sizes, outs)
    fwd = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return fwd, fwd - dims[0] * dims[1]


def logp_flops(n: int, obs_dim: int, act_dim: int, hidden: int = HIDDEN, sizes=None) -> int:
    """Matmul operations K3 (or K3n) needs for ``n`` rows (2 per
    multiply-add, unpadded widths): the actor trunk (``sizes``, two
    ``hidden``-wide layers by default) and its head."""
    return 2 * n * trunk_macs(obs_dim, (hidden, hidden) if sizes is None else sizes, act_dim)[0]


# ---------------------------------------------------------------------------
# K2: a whole PPO epoch
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EpochConfig:
    """What ``build_fused_epoch`` bakes in, besides the shapes of ``mbs``."""

    obs_dim: int
    act_dim: int
    pi_sizes: tuple
    vf_sizes: tuple
    learning_rate: float
    clip_eps: float
    entropy_coef: float
    value_coef: float
    max_grad_norm: float
    log_std_range: tuple | None = None


def fused_epoch_plain(
    mbs: Tensor,
    adv_stats: Tensor,
    t0: Tensor,
    leaves: list[Tensor],
    mu: list[Tensor],
    nu: list[Tensor],
    cfg: EpochConfig,
) -> tuple[list[Tensor], list[Tensor], list[Tensor], Tensor]:
    """The kernel's arithmetic in plain PyTorch (``pallas_sgd.py:357-512``
    over whole minibatches). Returns ``(leaves, mu, nu, metrics (n_mb, 5))``;
    the inputs are not modified."""
    n_mb, mb_size, _ = mbs.shape
    o, a_dim = cfg.obs_dim, cfg.act_dim
    n_pi, n_vf = len(cfg.pi_sizes), len(cfg.vf_sizes)
    i_pi_head = 2 * n_pi
    i_log_std = i_pi_head + 2
    i_vf0 = i_log_std + 1
    i_vf_head = i_vf0 + 2 * n_vf
    inv_mb = 1.0 / float(mb_size)
    lo_c, hi_c = 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps
    rng = cfg.log_std_range
    L = [t.detach().to(torch.float32).clone() for t in leaves]
    M = [t.detach().to(torch.float32).clone() for t in mu]
    V = [t.detach().to(torch.float32).clone() for t in nu]
    rows_metrics = []
    t_base = t0.reshape(-1)[0].to(torch.float32)
    for m in range(n_mb):
        rows = mbs[m]
        x = rows[:, :o]
        action = rows[:, o : o + a_dim]
        c0 = o + a_dim
        old_logp = rows[:, c0 : c0 + 1]
        adv = rows[:, c0 + 1 : c0 + 2]
        ret = rows[:, c0 + 2 : c0 + 3]

        a_pi = [x]
        for i in range(n_pi):
            a_pi.append(torch.tanh(_mm(a_pi[-1], L[2 * i]) + L[2 * i + 1]))
        mean = _mm(a_pi[-1], L[i_pi_head]) + L[i_pi_head + 1]
        log_std = _clip(L[i_log_std], rng)
        a_vf = [x]
        for i in range(n_vf):
            a_vf.append(torch.tanh(_mm(a_vf[-1], L[i_vf0 + 2 * i]) + L[i_vf0 + 2 * i + 1]))
        value = _mm(a_vf[-1], L[i_vf_head]) + L[i_vf_head + 1]

        var = torch.exp(2.0 * log_std)
        diff = action - mean
        lp = -0.5 * (diff * diff / var + 2.0 * log_std + LOG2PI)
        logp = torch.sum(lp, dim=-1, keepdim=True)
        ratio = torch.exp(logp - old_logp)
        adv_n = (adv - adv_stats[m, 0]) / (adv_stats[m, 1] + 1e-8)
        clipped = torch.clamp(ratio, lo_c, hi_c)
        pg1 = ratio * adv_n
        pg2 = clipped * adv_n
        pg_min = torch.minimum(pg1, pg2)
        verr = value - ret
        s_pg, s_v, s_kl = torch.sum(pg_min), torch.sum(verr * verr), torch.sum(old_logp - logp)

        # backward: inside the clip band pg1 == pg2 and lax.min splits the
        # cotangent 50/50; outside, the smaller branch takes it all
        inband = ((ratio >= lo_c) & (ratio <= hi_c)).to(torch.float32)
        d1 = adv_n
        d2 = adv_n * inband
        dmin_dr = torch.where(pg1 == pg2, 0.5 * (d1 + d2), torch.where(pg1 < pg2, d1, d2))
        g_logp = (-inv_mb) * dmin_dr * ratio
        dmean = g_logp * (diff / var)
        g_logstd = torch.sum(g_logp * (diff * diff / var - 1.0), dim=0, keepdim=True) - cfg.entropy_coef
        if rng is not None:
            ls_p = L[i_log_std]
            g_logstd = g_logstd * ((ls_p > rng[0]) & (ls_p < rng[1])).to(torch.float32)
        dvalue = (cfg.value_coef * inv_mb) * verr

        g = [None] * len(L)
        g[i_pi_head] = _mm_tn(a_pi[-1], dmean)
        g[i_pi_head + 1] = torch.sum(dmean, dim=0, keepdim=True)
        g[i_log_std] = g_logstd
        da = _mm_nt(dmean, L[i_pi_head])
        for i in range(n_pi - 1, -1, -1):
            a_i = a_pi[i + 1]
            dz = da * (1.0 - a_i * a_i)
            g[2 * i] = _mm_tn(a_pi[i], dz)
            g[2 * i + 1] = torch.sum(dz, dim=0, keepdim=True)
            if i > 0:
                da = _mm_nt(dz, L[2 * i])
        g[i_vf_head] = _mm_tn(a_vf[-1], dvalue)
        g[i_vf_head + 1] = torch.sum(dvalue, dim=0, keepdim=True)
        da = _mm_nt(dvalue, L[i_vf_head])
        for i in range(n_vf - 1, -1, -1):
            a_i = a_vf[i + 1]
            dz = da * (1.0 - a_i * a_i)
            g[i_vf0 + 2 * i] = _mm_tn(a_vf[i], dz)
            g[i_vf0 + 2 * i + 1] = torch.sum(dz, dim=0, keepdim=True)
            if i > 0:
                da = _mm_nt(dz, L[i_vf0 + 2 * i])

        # global-norm clip + Adam, bias correction 1 - exp(t ln b)
        gnorm = torch.sqrt(sum(torch.sum(gi * gi) for gi in g))
        scale = torch.where(gnorm < cfg.max_grad_norm, torch.ones_like(gnorm), cfg.max_grad_norm / gnorm)
        t = t_base + float(m + 1)
        c1 = 1.0 - torch.exp(t * math.log(B1))
        c2 = 1.0 - torch.exp(t * math.log(B2))
        for i in range(len(L)):
            gi = g[i] * scale
            M[i] = B1 * M[i] + (1.0 - B1) * gi
            V[i] = B2 * V[i] + (1.0 - B2) * (gi * gi)
            upd = (M[i] / c1) / (torch.sqrt(V[i] / c2) + ADAM_EPS)
            L[i] = L[i] - cfg.learning_rate * upd

        pg_loss = -s_pg * inv_mb
        v_loss = 0.5 * s_v * inv_mb
        kl = s_kl * inv_mb
        ent_m = torch.sum(log_std + ENT_C)  # the pre-update (clipped) log_std
        total = pg_loss + cfg.value_coef * v_loss - cfg.entropy_coef * ent_m
        rows_metrics.append(torch.stack([total, pg_loss, v_loss, ent_m, kl]))
    return L, M, V, torch.stack(rows_metrics)


def flat_layout(shapes: list[tuple[int, ...]]) -> tuple[list[int], int]:
    """Offsets of the leaves in the kernel's flat vectors (each at a
    multiple of 4 floats, so the kernel reads weight rows as float4) and
    the vector's length."""
    offsets, p = [], 0
    for s in shapes:
        offsets.append(p)
        p += -(-math.prod(s) // 4) * 4
    return offsets, p


def _to_flat(leaves: list[Tensor], offsets: list[int], P: int) -> Tensor:
    """A fresh flat f32 vector holding ``leaves`` at ``offsets``; a copy of
    the vector the leaves already view when they came from ``_from_flat``."""
    base = leaves[0]._base
    if (
        base is not None and base.dim() == 1 and base.numel() == P and base.dtype == torch.float32
        and all(t._base is base and t.storage_offset() - base.storage_offset() == off
                and t.is_contiguous() for t, off in zip(leaves, offsets))
    ):
        return base.clone()
    flat = torch.zeros(P, dtype=torch.float32, device=leaves[0].device)
    for t, off in zip(leaves, offsets):
        flat[off : off + t.numel()] = t.detach().reshape(-1)
    return flat


def _from_flat(flat: Tensor, shapes, offsets) -> list[Tensor]:
    return [flat[off : off + math.prod(s)].view(s) for s, off in zip(shapes, offsets)]


def workspace_offset(r, c):
    """Byte offset of (row ``r``, column ``c``) in a workspace tile of K2
    (64 rows, 64-wide blocks of ``BLOCK_BYTES``, each row 128 bytes with
    the 128-byte swizzle): where the forward/backward kernel writes a bf16
    activation or dz, and what the weight-gradient kernel's bulk copies
    land for its MN-major wgmma reads. Ints or integer tensors; the
    kernel writes the layout through ``store_rows`` in csrc/fused_epoch.cu
    (its comment states this formula)."""
    return (c // 64) * BLOCK_BYTES + r * 128 + ((((c % 64) // 8) ^ (r % 8)) * 16) + (c % 8) * 2


def image_slots(obs_dim: int, act_dim: int) -> tuple[Tensor, Tensor]:
    """For each entry of K2's flat parameter vector (``flat_layout`` of
    ``leaf_specs`` at two 256-wide layers per trunk): its byte offset in
    the two trunks' images, actor then critic, ``cuda_policy.TRUNK_BYTES``
    each, where the kernel writes it after every Adam step (-1 for log_std
    and the padding), and whether it goes there as f32 (a bias) rather
    than bf16 (a matrix entry). The kernel's copy of this rule is
    ``write_image`` in csrc/fused_epoch.cu; scattering a flat vector
    through it gives ``cuda_policy.pack_trunk`` of its leaves."""
    from pyflyt_tpu_torch.ops import cuda_policy as cp

    net = dict(obs_dim=obs_dim, act_dim=act_dim, pi_sizes=(HIDDEN, HIDDEN), vf_sizes=(HIDDEN, HIDDEN))
    shapes = [sh for _, sh in leaf_specs(net)]
    offsets, P = flat_layout(shapes)
    slot = torch.full((P,), -1, dtype=torch.int64)
    is_f32 = torch.zeros(P, dtype=torch.bool)
    for leaf, (shape, off) in enumerate(zip(shapes, offsets)):
        if leaf == 6:  # log_std: not in the images
            continue
        trunk, kind = (0, leaf) if leaf < 6 else (1, leaf - 7)
        base = trunk * cp.TRUNK_BYTES
        n = math.prod(shape)
        if kind in (0, 2, 4):  # w0, w1, head: (in, out) row-major
            k, o = torch.meshgrid(torch.arange(shape[0]), torch.arange(shape[1]), indexing="ij")
            region, rows = {0: (0, HIDDEN), 2: (cp.W1_OFF, HIDDEN), 4: (cp.HW_OFF, cp.HEAD_N)}[kind]
            slot[off : off + n] = base + region + cp.swizzle_offset(k, o, rows).reshape(-1)
        else:  # b0, b1, head bias
            region = {1: cp.B0_OFF, 3: cp.B1_OFF, 5: cp.HB_OFF}[kind]
            slot[off : off + n] = base + region + 4 * torch.arange(n)
            is_f32[off : off + n] = True
    return slot, is_f32


class _EpochArgsC(ctypes.Structure):
    """Mirror of ``struct EpochArgs`` in csrc/fused_epoch.cu."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "mbs", "adv_stats", "t0", "params", "mu", "nu", "metrics", "image", "ws_x", "ws_act",
            "ws_head", "spill", "colsum", "tile_part", "gpart", "grad", "block_sq",
        )
    ] + [("off", ctypes.c_int * 13)] + [
        (name, ctypes.c_int)
        for name in ("P", "n_mb", "mb", "feat", "obs_dim", "act_dim", "splits", "spill_slots")
    ] + [
        (name, ctypes.c_float)
        for name in ("lr", "clip_eps", "ent_coef", "vf_coef", "max_grad_norm")
    ] + [("has_range", ctypes.c_int), ("ls_lo", ctypes.c_float), ("ls_hi", ctypes.c_float)]


EPOCH_KERNEL = Kernel("fused_epoch.cu", "fused_epoch", [ctypes.c_void_p, ctypes.c_void_p])


def fused_epoch(
    mbs: Tensor,
    adv_stats: Tensor,
    t0: Tensor,
    leaves: list[Tensor],
    mu: list[Tensor],
    nu: list[Tensor],
    cfg: EpochConfig,
) -> tuple[list[Tensor], list[Tensor], list[Tensor], Tensor]:
    """One PPO epoch over ``mbs`` (n_mb, mb, feat) f32 packed rows
    ``[obs | action | old_logp | adv | ret]``, with per-minibatch advantage
    ``adv_stats`` (n_mb, 2) (mean, population std) and Adam's count ``t0``
    (1,) int32 before the epoch. Returns ``(leaves, mu, nu, metrics)``,
    metrics ``(n_mb, len(METRICS))``; the inputs are not modified (Adam's
    count afterwards is ``t0 + n_mb``). The kernel for CUDA tensors (one
    launch per call: ``KERNELS_PER_MINIBATCH`` CUDA kernels per minibatch
    and ``KERNELS_PER_CALL`` more), the twin for CPU ones."""
    if mbs.dtype != torch.float32 or mbs.dim() != 3:
        raise ValueError(f"mbs must be (n_mb, mb, feat) float32, got {tuple(mbs.shape)} {mbs.dtype}")
    n_mb, mb_size, feat = mbs.shape
    if feat < cfg.obs_dim + cfg.act_dim + 3:
        raise ValueError(f"row width {feat} < obs {cfg.obs_dim} + actions {cfg.act_dim} + 3")
    net = dict(obs_dim=cfg.obs_dim, act_dim=cfg.act_dim, pi_sizes=cfg.pi_sizes, vf_sizes=cfg.vf_sizes)
    shapes = [s for _, s in leaf_specs(net)]
    for name, group in (("leaves", leaves), ("mu", mu), ("nu", nu)):
        if [tuple(t.shape) for t in group] != shapes:
            raise ValueError(f"{name} do not have the shapes of leaf_specs")
    if tuple(adv_stats.shape) != (n_mb, 2) or t0.numel() != 1:
        raise ValueError("adv_stats must be (n_mb, 2) and t0 hold one count")
    if mbs.device.type == "cpu":
        return fused_epoch_plain(mbs, adv_stats, t0, leaves, mu, nu, cfg)
    if mbs.device.type != "cuda":
        raise ValueError(f"unsupported device {mbs.device}")
    family = _check_envelope(cfg.obs_dim, cfg.act_dim, cfg.pi_sizes, cfg.vf_sizes)
    if any(t.device != mbs.device for t in (adv_stats, t0, *leaves, *mu, *nu)):
        raise ValueError("every input must be on the device of mbs")
    if family == "general":
        from pyflyt_tpu_torch.ops import cuda_general

        out = cuda_general.launch_epoch(mbs, adv_stats, t0, leaves, mu, nu, cfg)
    elif family == "narrow":
        from pyflyt_tpu_torch.ops import cuda_narrow

        out, _ = cuda_narrow.launch_epoch(mbs, adv_stats, t0, leaves, mu, nu, cfg)
    else:
        out, _ = launch_epoch(mbs, adv_stats, t0, leaves, mu, nu, cfg)
    return out


def launch_epoch(mbs, adv_stats, t0, leaves, mu, nu, cfg: EpochConfig):
    """K2's launch, after ``fused_epoch``'s checks: ``((leaves, mu, nu,
    metrics), images)``, where ``images`` (2, ``cuda_policy.TRUNK_BYTES``)
    uint8 are the actor's and the critic's weight images as the last Adam
    step wrote them (``cuda_policy.pack_trunk`` of the returned leaves)."""
    from pyflyt_tpu_torch.ops import cuda_policy

    check_family("wide", cfg.obs_dim, cfg.act_dim, cfg.pi_sizes, cfg.vf_sizes)
    dev = mbs.device
    n_mb, mb_size, feat = mbs.shape
    net = dict(obs_dim=cfg.obs_dim, act_dim=cfg.act_dim, pi_sizes=cfg.pi_sizes, vf_sizes=cfg.vf_sizes)
    shapes = [s for _, s in leaf_specs(net)]
    offsets, P = flat_layout(shapes)
    params, m1, m2 = (_to_flat(g, offsets, P) for g in (leaves, mu, nu))
    mbs = mbs.contiguous()
    adv_stats = adv_stats.to(torch.float32).contiguous()
    t0 = t0.to(torch.int32).reshape(1).contiguous()
    metrics = torch.empty((n_mb, len(METRICS)), dtype=torch.float32, device=dev)
    tiles = -(-mb_size // TILE_M)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, sms // WGRAD_JOBS)  # about one wave of weight-gradient blocks
    spill_slots = 2 * min(tiles, max(1, sms // 2)) * CONSUMERS  # the forward/backward's consumers
    empty = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device=dev)  # noqa: E731
    images = torch.zeros((2, cuda_policy.TRUNK_BYTES), dtype=torch.uint8, device=dev)
    ws = dict(
        ws_x=empty(tiles, BLOCK_BYTES, dtype=torch.uint8),
        ws_act=empty(2, ACTS, tiles, TILE_BYTES, dtype=torch.uint8),
        ws_head=empty(2, tiles, HEAD_TILE_BYTES, dtype=torch.uint8),
        spill=empty(spill_slots, TILE_M * HIDDEN),
        colsum=empty(2, tiles, COLS),
        tile_part=empty(tiles, _NPART),
        gpart=empty(splits, P),
        grad=empty(P),
        block_sq=empty(-(-P // _THREADS)),
    )
    has_range, lo, hi = _range_args(cfg.log_std_range)
    args = _EpochArgsC(
        mbs.data_ptr(), adv_stats.data_ptr(), t0.data_ptr(), params.data_ptr(),
        m1.data_ptr(), m2.data_ptr(), metrics.data_ptr(), images.data_ptr(),
        *[ws[k].data_ptr() for k in ("ws_x", "ws_act", "ws_head", "spill", "colsum", "tile_part", "gpart",
                                      "grad", "block_sq")],
        (ctypes.c_int * 13)(*offsets), P, n_mb, mb_size, feat, cfg.obs_dim, cfg.act_dim, splits, spill_slots,
        cfg.learning_rate, cfg.clip_eps, cfg.entropy_coef, cfg.value_coef, cfg.max_grad_norm,
        has_range, lo, hi,
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = EPOCH_KERNEL.fn()(ctypes.addressof(args), stream)
    EPOCH_KERNEL.check(rc)
    EPOCH_KERNEL.launches += 1
    out = (
        _from_flat(params, shapes, offsets), _from_flat(m1, shapes, offsets),
        _from_flat(m2, shapes, offsets), metrics,
    )
    return out, images


def epoch_flops(n_rows: int, obs_dim: int, act_dim: int, hidden: int = HIDDEN, pi_sizes=None,
                vf_sizes=None) -> int:
    """Matmul operations K2 (or K2n) needs for ``n_rows`` rows of
    minibatches (2 per multiply-add, unpadded widths): the forward and the
    weight gradient of every layer of both trunks, and the data gradient of
    every layer but the first (the heads included). The trunks default to
    two ``hidden``-wide layers."""
    wide = (hidden, hidden)
    pi_f, pi_d = trunk_macs(obs_dim, wide if pi_sizes is None else pi_sizes, act_dim)
    vf_f, vf_d = trunk_macs(obs_dim, wide if vf_sizes is None else vf_sizes, 1)
    return 2 * n_rows * (2 * (pi_f + vf_f) + pi_d + vf_d)
