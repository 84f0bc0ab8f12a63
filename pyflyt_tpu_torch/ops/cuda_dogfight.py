"""The dogfight kernel K7 on a packed ``(ROWS, 2N)`` state (port of
``pyflyt_tpu/ops/pallas_dogfight.py``).

One CUDA source, ``csrc/dogfight_step.cu`` on ``csrc/fixedwing_lane.cuh``,
with one entry: ``packed_dogfight_step`` (replaces
``pallas_dogfight.packed_dogfight_step``), the whole 2-agent dogfight agent
step of ``N`` arenas: ``inner_steps`` aviary steps, each the engagement
reward from the previous aviary step's memos, K5's physics per drone, the
gun-cone geometry and hits, health, the memo shift, mutual-sphere and
ground collision, out-of-dome and the flag accumulation; then the step
count + 1.

The wrapper launches the kernel for a CUDA tensor and runs the plain
PyTorch twin (``packed_dogfight_step_plain``) for a CPU tensor, with no
fallback between the two. With noise on the twin draws from a
``torch.Generator`` seeded with the kernel's seed, where the kernel draws
Philox normals: same distribution, other numbers.

Layout: SoA ``(72, 2N)`` f32 with the Pallas module's row numbers (the
fixedwing drone bank in rows 0-52, then the per-drone engagement and
episode rows 53-65, arena-shared values stored in both drones), one
column per drone. Columns are arena-interleaved: column ``2a + m`` is
drone ``m`` of arena ``a``, so a drone's partner is the adjacent column
(the kernel exchanges with the adjacent group of lanes of its warp) and
the columns are the self-play env's flat row order. The TPU's
``(72, 8, 2N/8)`` sublane fold with drone order ``[d0s..., d1s...]`` is
dropped (``convert.packed_dogfight_from_jax`` reorders it).

Bound on an H100 at the league's 4096 arenas (8192 drones): 48 rows read
and 72 written (3.9 MB, 1.17 µs at 3.35 TB/s) against ~9.5 kFLOP per drone
(1.16 µs at 67 TFLOP/s): the two are even (see the source note).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
from torch import Tensor

from pyflyt_tpu_torch.core.state import tree_map
from pyflyt_tpu_torch.models import fixedwing
from pyflyt_tpu_torch.ops import cuda_build
from pyflyt_tpu_torch.ops import cuda_fixedwing as cf
from pyflyt_tpu_torch.ops.cuda_build import Kernel

ROWS = 72  # 66 used, padded to a multiple of 8 as the Pallas layout is
D_ROWS = 53  # the fixedwing drone bank: cuda_fixedwing rows _POS.._CON

# per-drone engagement and episode rows (pallas_dogfight.py:63-76)
_HP = D_ROWS  # own health
_ANG = _HP + 1  # own current-angle memo
_PANG = _ANG + 1  # own previous-angle memo (one aviary step older)
_HIT = _PANG + 1  # own current-hit memo (0/1)
_DIST = _HIT + 1  # arena distance memo (the same value in both drones)
_PDIST = _DIST + 1
_TERM = _PDIST + 1
_TRUNC = _TERM + 1
_RWD = _TRUNC + 1  # reward accumulated over the agent step
_COLLF = _RWD + 1  # any-collision flag of this step
_OOBF = _COLLF + 1  # any-out-of-bounds flag of this step
_OTHD = _OOBF + 1  # other-dead flag (the env writes it at step start)
_STEPC = _OTHD + 1  # agent step count (before this step's increment)
assert _STEPC + 1 <= ROWS

GUN_OFFSET = 0.35  # m behind the CG along the forward vector

# f32 operations per drone and aviary step beyond K5's physics, counted from
# csrc/dogfight_step.cu as cuda_fixedwing's counts are (adds, multiplies,
# divides, compares, selects, transcendentals each 1): the memo reward
# (20), the forward vector, gun, separation, distance, cone angle and hit
# (40), health and the memo shift (2), mutual sphere, out-of-dome, the
# penalties and the five flag accumulations (28)
OPS_PER_ENGAGEMENT = 90


@dataclasses.dataclass(frozen=True)
class DogfightConsts(cf.FixedwingConsts):
    """K5's ``FixedwingConsts`` (the acrowing's values; ``dome2``,
    ``max_steps``, ``inner_steps`` and ``ratio`` read as the dogfight's)
    plus the engagement constants. The kernel gets them as one POD struct
    by value (``_DogfightConstsC``, these fields in this order)."""

    lethal_angle: float  # rad
    lethal_distance: float  # m
    damage_per_hit: float
    crad2: float  # (2 collision_radius)^2, the mutual-sphere threshold


def dogfight_consts(
    params: fixedwing.FixedwingParams,
    cfg: fixedwing.FixedwingConfig,
    inner_steps: int,
    dome: float,
    max_steps: int,
    lethal_angle: float,
    lethal_distance: float,
    damage_per_hit: float,
    collision_radius: float,
) -> DogfightConsts:
    """Reads the parameter tensors once into ``DogfightConsts``."""
    base = dataclasses.asdict(cf.fixedwing_consts(params, cfg))
    base.update(dome2=float(dome) ** 2, max_steps=float(max_steps), inner_steps=int(inner_steps))
    return DogfightConsts(
        **base, lethal_angle=float(lethal_angle), lethal_distance=float(lethal_distance),
        damage_per_hit=float(damage_per_hit), crad2=(2.0 * float(collision_radius)) ** 2,
    )


def ops_per_drone(c: DogfightConsts) -> int:
    """f32 operations one launch does per drone (for the bound): the
    control map once, then per aviary step ``ratio`` physics iterations and
    the engagement."""
    return cf.OPS_PER_CONTROL + c.inner_steps * (c.ratio * cf.OPS_PER_PHYSICS_ITER + OPS_PER_ENGAGEMENT)


def rows_moved() -> tuple[int, int]:
    """(rows read, rows written) per drone: the 40 drone rows the physics
    reads (the view and the contact flag are overwritten unread) and the 8
    memo/episode rows it carries (health, the angle, hit and distance
    memos, other-dead, the step count); all 72 are written."""
    return 3 + 4 + 3 + 3 + 15 + 5 + 1 + 6 + (_PDIST - _HP + 1) + 2, ROWS


class _DogfightConstsC(cuda_build.ConstsStruct):
    """Mirror of ``struct DogfightConsts`` in csrc/dogfight_step.cu, field
    by field from ``DogfightConsts`` (a test holds the C struct to it)."""

    _fields_ = cuda_build.struct_fields(DogfightConsts)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


def pack_env_state(st) -> Tensor:
    """A batched ``DogfightState`` ``(N, 2)`` → packed ``(ROWS, 2N)``: the
    drone bank, the memos, the step count; term/trunc/reward/flags and
    other-dead zero (the step re-arms or writes them), padding zero."""
    n = st.health.shape[0]
    drones = tree_map(lambda x: x.reshape((2 * n,) + tuple(x.shape[2:])), st.drones)  # column 2a + m
    bank = cf.pack_state(drones)[:D_ROWS]
    per_drone = lambda x: x.reshape(2 * n).to(torch.float32)  # noqa: E731
    both = lambda x: x[:, None].expand(n, 2).reshape(2 * n).to(torch.float32)  # noqa: E731
    zeros = bank.new_zeros(2 * n)
    env_rows = torch.stack([
        per_drone(st.health), per_drone(st.current_angles), per_drone(st.prev_angles),
        per_drone(st.current_hits), both(st.current_distance), both(st.prev_distance),
        zeros, zeros, zeros, zeros, zeros, zeros,  # term, trunc, reward, collf, oobf, other-dead
        both(st.step_count),
    ])
    return torch.cat([bank, env_rows, bank.new_zeros((ROWS - _STEPC - 1, 2 * n))]).contiguous()


def pair(packed: Tensor, row: int) -> Tensor:
    """One packed row ``(2N,)`` → ``(N, 2)``."""
    return packed[row].reshape(-1, 2)


def partner(x: Tensor) -> Tensor:
    """Each drone's partner's value of a ``(2N,)`` row (the kernel's lane
    exchange)."""
    return x.reshape(-1, 2).flip(1).reshape(-1)


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

_ARGS = [
    ctypes.c_void_p,  # in
    ctypes.c_void_p,  # out
    ctypes.c_int,  # n drones (even)
    ctypes.c_void_p,  # seed (device int64)
    ctypes.c_void_p,  # consts (host struct)
    ctypes.c_int,  # noisy
    ctypes.c_int,  # sparse
    ctypes.c_void_p,  # stream
]
KERNEL = Kernel("dogfight_step.cu", "dogfight_step", _ARGS)


def _check(packed: Tensor, seed: Tensor, consts: DogfightConsts) -> None:
    if packed.dtype != torch.float32 or packed.dim() != 2 or packed.shape[0] != ROWS:
        raise ValueError(f"packed must be ({ROWS}, 2N) float32, got {tuple(packed.shape)} {packed.dtype}")
    if packed.shape[1] == 0 or packed.shape[1] % 2:
        raise ValueError(f"packed needs an even, non-zero number of drone columns, got {packed.shape[1]}")
    if seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != packed.device:
        raise ValueError("seed must be one int64 on the packed state's device")
    if not isinstance(consts, DogfightConsts) or consts.inner_steps < 1 or consts.ratio < 1:
        raise ValueError("the dogfight step needs dogfight_consts (inner_steps >= 1)")


def packed_dogfight_step(
    packed: Tensor, seed: Tensor, consts: DogfightConsts, noisy: bool, sparse: bool = False
) -> Tensor:
    """One whole dogfight agent step on the packed ``(ROWS, 2N)`` state:
    returns the new state, a new tensor. ``seed`` is a one-element int64
    tensor on the state's device (the motor-noise key of this step)."""
    _check(packed, seed, consts)
    if packed.device.type == "cpu":
        return packed_dogfight_step_plain(packed, seed, consts, noisy, sparse)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    out = torch.empty_like(packed)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.fn()(
            packed.data_ptr(), out.data_ptr(), packed.shape[1], seed.data_ptr(),
            ctypes.addressof(_DogfightConstsC.of(consts)), int(noisy), int(sparse), stream,
        )
    KERNEL.check(rc)
    KERNEL.launches += 1
    return out


def packed_dogfight_step_plain(
    packed: Tensor, seed: Tensor, consts: DogfightConsts, noisy: bool, sparse: bool = False
) -> Tensor:
    """``packed_dogfight_step``'s arithmetic in plain PyTorch (any device),
    row by row, on ``cuda_fixedwing``'s physics twin."""
    _check(packed, seed, consts)
    c = consts
    S = list(packed.unbind(0))
    gen = cf._twin_generator(seed, packed.device) if noisy else None
    s = cf._unpack_rows(S)
    sp = S[cf._SP : cf._SP + 6]
    hp, ang, pang, hit, dist, pdist = (S[r] for r in (_HP, _ANG, _PANG, _HIT, _DIST, _PDIST))
    othd, stepc = S[_OTHD], S[_STEPC]
    zero = torch.zeros_like(stepc)
    term = trunc = rwd = collf = oobf = zero
    f = lambda b: b.to(stepc.dtype)  # noqa: E731
    trunc_hit = f(stepc > c.max_steps)  # the count before this step's increment
    cmd = cf._control_plain(c, 0, sp)  # the mode-0 assist map, once per agent step
    for _ in range(c.inner_steps):
        # the engagement reward from the previous aviary step's memos
        r = zero
        if not sparse:
            in_range = f(dist < c.lethal_distance)
            closing = torch.clamp(pdist - dist, min=0.0)
            chasing = f(torch.abs(ang) < math.pi / 2.0)
            r = closing * (1.0 - in_range) * chasing + (pang - ang) * in_range * 10.0 + 3.0 / (ang + 0.1) * in_range
        r = r + 30.0 * hit - 20.0 * partner(hit)
        contact = zero
        for _ in range(c.ratio):
            cf._physics_plain(s, c, cmd, gen, noisy)
            contact = torch.maximum(contact, s["contact"])
        # the gun cone from the lagged euler read
        v = s["view"]
        cp = torch.cos(v[4])
        fwd = [torch.cos(v[5]) * cp, torch.sin(v[5]) * cp, -torch.sin(v[4])]
        gun = [v[9 + k] - GUN_OFFSET * fwd[k] for k in range(3)]
        sep = [partner(gun[k]) - gun[k] for k in range(3)]
        dist_new = torch.sqrt(sep[0] * sep[0] + sep[1] * sep[1] + sep[2] * sep[2])
        dot = sep[0] * fwd[0] + sep[1] * fwd[1] + sep[2] * fwd[2]
        ang_new = torch.arccos(torch.clamp(dot / torch.clamp(dist_new, min=1e-8), -1.0, 1.0))
        hit_new = f((ang_new < c.lethal_angle) & (dist_new < c.lethal_distance) & (torch.abs(ang_new) < math.pi / 2.0))
        hp = hp - c.damage_per_hit * partner(hit_new)
        pang, ang, pdist, dist, hit = ang, ang_new, dist, dist_new, hit_new
        # collisions and bounds
        d = [s["pos"][k] - partner(s["pos"][k]) for k in range(3)]
        coll = torch.maximum(contact, f(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] < c.crad2))
        oob = f(v[9] * v[9] + v[10] * v[10] + v[11] * v[11] > c.dome2)
        r = r - 3000.0 * oob - 3000.0 * coll
        term = torch.clamp(term + coll + oob + othd, max=1.0)
        trunc = torch.clamp(trunc + trunc_hit, max=1.0)
        rwd = rwd + r
        collf = torch.clamp(collf + coll, max=1.0)
        oobf = torch.clamp(oobf + oob, max=1.0)

    out = [zero] * ROWS
    cf._pack_rows(out, s, sp)
    for row, val in ((_HP, hp), (_ANG, ang), (_PANG, pang), (_HIT, hit), (_DIST, dist), (_PDIST, pdist),
                     (_TERM, term), (_TRUNC, trunc), (_RWD, rwd), (_COLLF, collf), (_OOBF, oobf), (_OTHD, othd),
                     (_STEPC, stepc + 1.0)):
        out[row] = val
    return torch.stack(out, dim=0)
