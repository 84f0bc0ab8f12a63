"""The Fixedwing kernel K5 on a packed ``(ROWS, N)`` state (port of
``pyflyt_tpu/ops/pallas_fixedwing.py``).

One CUDA source, ``csrc/fixedwing_step.cu``, on the shared header
``csrc/fixedwing_lane.cuh``, with two entries:

- ``packed_step`` (replaces ``pallas_fixedwing.packed_step``): one aviary
  step, the any-contact flag in row 53 and rows 54-87 zero;
- ``packed_waypoints_step`` (replaces
  ``pallas_fixedwing.packed_waypoints_step``): the whole
  Fixedwing-Waypoints agent step, ``inner_steps`` aviary steps each
  followed by the waypoint tracking, the shaped reward, termination,
  truncation and the done-freeze.

``step`` (replaces ``pallas_fixedwing.step``) is the drop-in for
``models.fixedwing.step``: pack → ``packed_step`` → unpack. Flight modes -1
and 0, noise on or off, any N.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch twin (``*_plain``) for a CPU tensor, with no fallback between the
two. The twins repeat the kernel's arithmetic row by row; with noise on
they draw from a ``torch.Generator`` seeded with the kernel's seed, where
the kernel draws Philox normals: same distribution, other numbers.

Layout: SoA ``(88, N)`` f32, one column per env, with the Pallas module's
row indices so packed states compare row by row; the TPU's
``(ROWS, 8, N/8)`` sublane fold is dropped.

Bound on an H100 at the stock 4096 envs: the waypoints step reads 86 rows
and writes 88 (2.85 MB, 0.85 µs at 3.35 TB/s) and does ~10 kFLOP per env
(8 physics iterations), 0.60 µs at 67 TFLOP/s: bytes bound it, and each
thread's dependent chain costs more (see the source note).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.core.state import Body6DoF
from pyflyt_tpu_torch.models import fixedwing
from pyflyt_tpu_torch.ops import cuda_build
from pyflyt_tpu_torch.ops import cuda_math as cm
from pyflyt_tpu_torch.ops.cuda_build import Kernel

ROWS = 88  # 87 used, padded to a multiple of 8 as the Pallas layout is

# drone rows (pallas_fixedwing.py:57-67)
_POS = 0     # 3: world ENU CoM position
_QUAT = 3    # 4: xyzw body->world
_LVEL = 7    # 3: world linear velocity (CoM)
_AVEL = 10   # 3: world angular velocity
_VIEW = 13   # 12: lagged [ang_vel_b, euler, lin_vel_b, base_pos]
_SLV = 25    # 15: lagged body-frame surface velocities (5 x 3)
_ACT = 40    # 5: surface deflections
_THR = 45    # 1: motor throttle
_SP = 46     # 6: setpoint (rows 50-51 zero in mode 0)
_CON = 52    # 1: contact flag (0/1)
# env rows (pallas_fixedwing.py:69-76); row 53 is the any-contact flag of
# packed_step's output
_RWD = 53
_TERM = 54
_TRUNC = 55
_COLL = 56
_OOB = 57
_STEP = 58   # agent step count (exact as f32 below 2^24)
_CPLT = 59   # env_complete
# waypoint rows (pallas_fixedwing.py:78-86): the targets rolled so the
# current one is first, idx = num_targets - remaining
_TGT = 60    # 12: world-frame targets (4 x 3)
_REM = 72    # remaining target count
_NDIST = 73  # new-distance memo
_ODIST = 74  # old-distance memo
_TDLT = 75   # 12: the target_deltas observation (body frame, masked)

NUM_SURFACES = fixedwing.NUM_SURFACES
MAX_TARGETS = 4
MAX_CONTACT = 8
MODES = (-1, 0)
GRAVITY = 9.81
HALF_RHO = 0.5 * 1.225

# f32 operations per env, counted from csrc/fixedwing_lane.cuh and
# csrc/fixedwing_step.cu (adds, multiplies, divides, compares, selects,
# transcendentals each 1) — the operation side of the bounds: one
# surface's aero and wrench (the flap algebra and the no-stall branch,
# which most lanes take), the rest of a physics iteration (lags, noise,
# motor, the read with its 5 surface velocities, integration, contact),
# the mode-0 control map, the waypoints task update
OPS_PER_SURFACE = 110
OPS_PER_PHYSICS_BODY = 590
OPS_PER_CONTROL = 36
OPS_PER_WAYPOINT_TASK = 145
OPS_PER_PHYSICS_ITER = NUM_SURFACES * OPS_PER_SURFACE + OPS_PER_PHYSICS_BODY


def pack_state(state: fixedwing.FixedwingState) -> Tensor:
    """Batched ``FixedwingState`` (N,) → ``(ROWS, N)`` f32; the setpoint
    padded to 6 rows, env rows zero."""
    n = state.body.pos.shape[0]
    sp = state.setpoint
    if sp.shape[-1] < 6:
        sp = torch.cat([sp, sp.new_zeros((n, 6 - sp.shape[-1]))], dim=-1)
    rows = [
        state.body.pos.T,
        state.body.quat.T,
        state.body.lin_vel.T,
        state.body.ang_vel.T,
        state.read.view.reshape(n, 12).T,
        state.read.surface_local_vel.reshape(n, 15).T,
        state.actuation.T,
        state.throttle.T,
        sp.T,
        state.contact.to(torch.float32)[None, :],
    ]
    packed = torch.cat([r.to(torch.float32) for r in rows], dim=0)
    return torch.cat([packed, packed.new_zeros((ROWS - packed.shape[0], n))], dim=0).contiguous()


def unpack_state(packed: Tensor, template: fixedwing.FixedwingState) -> fixedwing.FixedwingState:
    """``(ROWS, N)`` → ``FixedwingState``; ``cmd`` and ``physics_steps``
    keep the template's values."""
    g = lambda r, k: packed[r : r + k].T  # noqa: E731
    n = packed.shape[1]
    return dataclasses.replace(
        template,
        body=Body6DoF(pos=g(_POS, 3), quat=g(_QUAT, 4), lin_vel=g(_LVEL, 3), ang_vel=g(_AVEL, 3)),
        read=fixedwing.FixedwingRead(view=g(_VIEW, 12).reshape(n, 4, 3),
                                     surface_local_vel=g(_SLV, 15).reshape(n, 5, 3)),
        actuation=g(_ACT, 5),
        throttle=g(_THR, 1),
        setpoint=g(_SP, template.setpoint.shape[-1]),
        contact=packed[_CON] > 0.5,
    )


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------


_arr = cuda_build.array_field


@dataclasses.dataclass(frozen=True)
class FixedwingConsts:
    """Vehicle and task constants of K5 as Python values: the numbers
    ``pallas_fixedwing._bake`` computes, in float64 from the f32
    parameters. The kernel gets them as one POD struct by value
    (``_FixedwingConstsC``, these fields in this order); the twins read the
    same values. Per-surface vectors are 5 × 3, row-major."""

    lu: tuple = _arr(15)  # lift units
    du: tuple = _arr(15)  # forward (drag) units
    tu: tuple = _arr(15)  # pitch-moment units, lift × forward
    r_s: tuple = _arr(15)  # surface position - CoM: the read's offset and the lever arm
    qa: tuple = _arr(5)  # HALF_RHO * area
    chord: tuple = _arr(5)
    piar_inv: tuple = _arr(5)  # 1 / (pi * aspect)
    cl3d: tuple = _arr(5)
    cd0: tuple = _arr(5)
    a0b: tuple = _arr(5)  # alpha_0_base, rad
    asp_b: tuple = _arr(5)  # alpha_stall_P_base, rad
    asn_b: tuple = _arr(5)  # alpha_stall_N_base, rad
    dlim_rad: tuple = _arr(5)  # deflection limit, rad (0: the surface has no flap)
    dcl_gain: tuple = _arr(5)  # Cl_alpha_3D * aero_tau * eta
    f2c: tuple = _arr(5)  # flap_to_chord
    clmax_p: tuple = _arr(5)  # Cl_alpha_3D * (alpha_stall_P_base - alpha_0_base)
    clmax_n: tuple = _arr(5)  # Cl_alpha_3D * (alpha_stall_N_base - alpha_0_base)
    stall_c: tuple = _arr(5)  # 0.41 * (1 - exp(-17 / aspect))
    lag: tuple = _arr(5)  # physics_period / surface tau
    inertia: tuple = _arr(9)  # row-major, about the CoM
    inv_inertia: tuple = _arr(9)
    com: tuple = _arr(3)  # base origin -> CoM, body frame
    contact_pts: tuple = _arr(3 * MAX_CONTACT)  # CoM-relative, padded with the first point
    mot_f: tuple = _arr(3)  # thrust per rpm^2, body frame
    mot_t: tuple = _arr(3)  # torque per rpm^2 (axis torque and lever arm)
    assist_signs: tuple = _arr(6)
    assist_ids: tuple = _arr(6, "int")
    inv_mass: float
    mot_lag: float  # physics_period / motor tau
    mot_max_rpm: float
    mot_noise: float
    dt: float
    dome2: float  # flight_dome_size^2 (waypoints entry)
    max_steps: float  # step-count truncation threshold (waypoints entry)
    goal: float  # goal_reach_distance (waypoints entry)
    ratio: int  # physics iterations per aviary step
    inner_steps: int  # aviary steps per agent step (waypoints entry)
    num_targets: int  # 1..4 (waypoints entry)


def fixedwing_consts(params: fixedwing.FixedwingParams, cfg: fixedwing.FixedwingConfig) -> FixedwingConsts:
    """Reads the parameter tensors once into ``FixedwingConsts`` (the task
    fields zero: ``waypoints_consts`` fills them)."""
    p = lambda t: np.asarray(t.detach().cpu(), dtype=np.float64)  # noqa: E731
    flat = lambda a: tuple(float(v) for v in np.asarray(a, np.float64).reshape(-1))  # noqa: E731
    s = params.surfaces
    com = p(params.com_offset)
    aspect = p(s.aspect)
    cl3d, a0b = p(s.Cl_alpha_3D), p(s.alpha_0_base)
    pts = p(params.contact_points) - com
    if len(pts) > MAX_CONTACT:
        raise NotImplementedError(f"K5 carries at most {MAX_CONTACT} contact points, not {len(pts)}")
    pts = np.concatenate([pts, np.repeat(pts[:1], MAX_CONTACT - len(pts), axis=0)])
    m = params.motor
    mu, mr = p(m.thrust_unit)[0], p(m.positions)[0]  # motor position already CoM-relative
    ct, cq = float(p(m.thrust_coef)[0]), float(p(m.torque_coef)[0])
    inertia = p(params.inertia)
    dt = float(cfg.physics_period)
    return FixedwingConsts(
        lu=flat(p(s.lift_unit)), du=flat(p(s.drag_unit)), tu=flat(p(s.torque_unit)),
        r_s=flat(p(s.positions) - com),
        qa=flat(HALF_RHO * p(s.area)), chord=flat(p(s.chord)), piar_inv=flat(1.0 / (np.pi * aspect)),
        cl3d=flat(cl3d), cd0=flat(p(s.Cd_0)), a0b=flat(a0b), asp_b=flat(p(s.alpha_stall_P_base)),
        asn_b=flat(p(s.alpha_stall_N_base)), dlim_rad=flat(np.deg2rad(p(s.deflection_limit))),
        dcl_gain=flat(cl3d * p(s.aero_tau) * p(s.eta)), f2c=flat(p(s.flap_to_chord)),
        clmax_p=flat(cl3d * (p(s.alpha_stall_P_base) - a0b)), clmax_n=flat(cl3d * (p(s.alpha_stall_N_base) - a0b)),
        stall_c=flat(0.41 * (1.0 - np.exp(-17.0 / aspect))), lag=flat(dt / p(s.tau)),
        inertia=flat(inertia), inv_inertia=flat(np.linalg.inv(inertia)), com=flat(com), contact_pts=flat(pts),
        mot_f=flat(mu * ct), mot_t=flat(mu * cq + np.cross(mr, mu) * ct),
        assist_signs=flat(p(params.assist_signs)),
        assist_ids=tuple(int(v) for v in np.asarray(params.assist_ids.cpu()).reshape(-1)),
        inv_mass=1.0 / float(p(params.mass)), mot_lag=dt / float(p(m.tau)[0]),
        mot_max_rpm=float(p(m.max_rpm)[0]), mot_noise=float(p(m.noise_ratio)[0]), dt=dt,
        dome2=0.0, max_steps=0.0, goal=0.0, ratio=int(cfg.physics_control_ratio), inner_steps=0, num_targets=0,
    )


def waypoints_consts(
    params: fixedwing.FixedwingParams,
    cfg: fixedwing.FixedwingConfig,
    inner_steps: int,
    dome: float,
    max_steps: int,
    goal: float,
    num_targets: int,
) -> FixedwingConsts:
    """``fixedwing_consts`` with the waypoints task's fields."""
    if not 1 <= num_targets <= MAX_TARGETS:
        raise NotImplementedError(f"the waypoints layout carries 1..{MAX_TARGETS} targets, not {num_targets}")
    return dataclasses.replace(
        fixedwing_consts(params, cfg), dome2=float(dome) ** 2, max_steps=float(max_steps), goal=float(goal),
        inner_steps=int(inner_steps), num_targets=int(num_targets),
    )


def ops_per_env(c: FixedwingConsts, waypoints: bool) -> int:
    """f32 operations one launch does per env (for the bound): a full agent
    step of ``inner_steps`` aviary steps, or one aviary step."""
    per_aviary = OPS_PER_CONTROL + c.ratio * OPS_PER_PHYSICS_ITER
    if waypoints:
        return c.inner_steps * (per_aviary + OPS_PER_WAYPOINT_TASK)
    return per_aviary


def rows_moved(waypoints: bool) -> tuple[int, int]:
    """(rows read, rows written) per env. ``packed_step`` reads the 40 rows
    its step uses (the view and the contact flag are overwritten unread);
    the waypoints step reads the drone's 53, the 6 env rows but the reward
    (re-armed) and the 27 waypoint rows. Both write all 88."""
    if waypoints:
        return _CON + 1 + (_CPLT - _RWD) + (_TDLT + 12 - _TGT), ROWS
    return 3 + 4 + 3 + 3 + 15 + 5 + 1 + 6, ROWS


class _FixedwingConstsC(cuda_build.ConstsStruct):
    """Mirror of ``struct FixedwingConsts`` in csrc/fixedwing_step.cu, field
    by field from ``FixedwingConsts`` (a test holds the C struct to it)."""

    _fields_ = cuda_build.struct_fields(FixedwingConsts)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

_ARGS = [
    ctypes.c_void_p,  # in
    ctypes.c_void_p,  # out
    ctypes.c_int,  # n
    ctypes.c_void_p,  # seed (device int64)
    ctypes.c_void_p,  # consts (host struct)
    ctypes.c_int,  # mode
    ctypes.c_int,  # noisy
    ctypes.c_int,  # sparse (waypoints entry; ignored by the step)
    ctypes.c_void_p,  # stream
]
STEP_KERNEL = Kernel("fixedwing_step.cu", "fixedwing_step", _ARGS)
WAYPOINTS_KERNEL = Kernel("fixedwing_step.cu", "fixedwing_waypoints_step", _ARGS)


def _check(packed: Tensor, seed: Tensor, mode: int) -> None:
    if mode not in MODES:
        raise ValueError(f"fixedwing flight mode must be -1 or 0, got {mode}")
    if packed.dtype != torch.float32 or packed.dim() != 2 or packed.shape[0] != ROWS:
        raise ValueError(f"packed must be ({ROWS}, N) float32, got {tuple(packed.shape)} {packed.dtype}")
    if seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != packed.device:
        raise ValueError("seed must be one int64 on the packed state's device")


def _launch(kernel: Kernel, packed: Tensor, seed: Tensor, c: FixedwingConsts, mode: int, noisy: bool,
            sparse: bool) -> Tensor:
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    out = torch.empty_like(packed)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel.fn()(
            packed.data_ptr(), out.data_ptr(), packed.shape[1], seed.data_ptr(),
            ctypes.addressof(_FixedwingConstsC.of(c)), mode, int(noisy), int(sparse), stream,
        )
    kernel.check(rc)
    kernel.launches += 1
    return out


def packed_step(packed: Tensor, seed: Tensor, consts: FixedwingConsts, mode: int, noisy: bool) -> Tensor:
    """One aviary step on the packed ``(ROWS, N)`` state: returns the new
    state (a new tensor), its row 53 the step's any-contact flag and rows
    54-87 zero. ``seed`` is a one-element int64 tensor on the state's
    device (the motor-noise key of this step)."""
    _check(packed, seed, mode)
    if packed.device.type == "cpu":
        return packed_step_plain(packed, seed, consts, mode, noisy)
    return _launch(STEP_KERNEL, packed, seed, consts, mode, noisy, False)


def packed_waypoints_step(
    packed: Tensor,
    seed: Tensor,
    consts: FixedwingConsts,
    mode: int,
    noisy: bool,
    sparse: bool = False,
) -> Tensor:
    """One whole Fixedwing-Waypoints agent step on the packed ``(ROWS, N)``
    state (``consts`` from ``waypoints_consts``): returns the new state, a
    new tensor."""
    _check(packed, seed, mode)
    if not 1 <= consts.num_targets <= MAX_TARGETS or consts.inner_steps < 1:
        raise ValueError("the waypoints step needs waypoints_consts (1..4 targets, inner_steps >= 1)")
    if packed.device.type == "cpu":
        return packed_waypoints_step_plain(packed, seed, consts, mode, noisy, sparse)
    return _launch(WAYPOINTS_KERNEL, packed, seed, consts, mode, noisy, sparse)


def step(
    state: fixedwing.FixedwingState,
    params: fixedwing.FixedwingParams,
    cfg: fixedwing.FixedwingConfig,
    mode: int,
    generator: torch.Generator | None = None,
    consts: FixedwingConsts | None = None,
) -> tuple[fixedwing.FixedwingState, Tensor]:
    """Drop-in for ``models.fixedwing.step`` (no wind) through
    ``packed_step``: pack → one launch → unpack; returns ``(state,
    any_contact)``. Motor noise is on when ``cfg.noisy_motors`` and a
    ``generator`` is given (it draws the launch's seed). ``consts`` saves
    re-reading ``params`` on every call. The contact is detection-grade:
    it stops the fall where the model's impulse also pushes back, which
    only shows after a contact."""
    c = consts if consts is not None else fixedwing_consts(params, cfg)
    packed = pack_state(state)
    if generator is not None:
        seed = torch.randint(0, 2**31 - 1, (1,), generator=generator, device=packed.device, dtype=torch.int64)
    else:
        seed = torch.zeros(1, dtype=torch.int64, device=packed.device)
    out = packed_step(packed, seed, c, mode, noisy=cfg.noisy_motors and generator is not None)
    new = fixedwing.update_control(unpack_state(out, state), params, cfg, mode)
    new = dataclasses.replace(new, physics_steps=state.physics_steps + cfg.physics_control_ratio)
    return new, out[_RWD] > 0.5


# ---------------------------------------------------------------------------
# the plain twins: the kernel's arithmetic in PyTorch, row by row
# ---------------------------------------------------------------------------


def _control_plain(c: FixedwingConsts, mode: int, sp: list[Tensor]) -> list[Tensor]:
    """fixedwing_lane.cuh::control_cmd: raw commands (mode -1) or the
    surface-assist map (mode 0)."""
    if mode == -1:
        return list(sp)
    return [c.assist_signs[j] * sp[c.assist_ids[j]] for j in range(6)]


def _surface_plain(c: FixedwingConsts, k: int, act: Tensor, lv: list[Tensor]):
    """fixedwing_lane.cuh::surface_normal_forward: one surface's (normal
    force, forward force, pitch moment) from its lagged velocity."""
    lu, du = c.lu[3 * k : 3 * k + 3], c.du[3 * k : 3 * k + 3]
    cl3d, cd0, piar = c.cl3d[k], c.cd0[k], c.piar_inv[k]
    lifting = lv[0] * lu[0] + lv[1] * lu[1] + lv[2] * lu[2]
    forward = lv[0] * du[0] + lv[1] * du[1] + lv[2] * du[2]
    alpha = torch.atan2(-lifting, forward)
    if c.dlim_rad[k] != 0.0:  # the flap branch
        defl = act * c.dlim_rad[k]
        dcl = c.dcl_gain[k] * defl
        dclmax = c.f2c[k] * dcl
        a0 = c.a0b[k] - dcl / cl3d
        asp = a0 + (c.clmax_p[k] + dclmax) / cl3d
        asn = a0 + (c.clmax_n[k] + dclmax) / cl3d
        cd90 = (-4.26e-2 * defl * defl) + (2.1e-1 * defl) + 1.98
    else:
        a0 = torch.full_like(alpha, c.a0b[k])
        asp = torch.full_like(alpha, c.asp_b[k])
        asn = torch.full_like(alpha, c.asn_b[k])
        cd90 = 1.98
    # the no-stall linear regime
    cl_lin = cl3d * (alpha - a0)
    ae = alpha - a0 - cl_lin * piar
    sae, cae = torch.sin(ae), torch.cos(ae)
    ct = cd0 * cae
    cn = (cl_lin + ct * sae) / cae
    cd_lin = cn * sae + ct * cae
    cm_lin = -cn * (0.25 - 0.175 * (1.0 - (2.0 / math.pi) * ae))
    # the post-stall flat plate
    aisp = (cl3d * (asp - a0)) * piar
    aisn = (cl3d * (asn - a0)) * piar
    tp = torch.clamp((alpha - asp) / (math.pi / 2.0 - asp), 0.0, 1.0)
    tn = torch.clamp((alpha + math.pi / 2.0) / (asn + math.pi / 2.0), 0.0, 1.0)
    ai_st = torch.where(alpha > 0.0, aisp * (1.0 - tp), tn * aisn)
    ae_st = alpha - a0 - ai_st
    s_st, c_st = torch.sin(ae_st), torch.cos(ae_st)
    cn_st = cd90 * s_st * (1.0 / (0.56 + 0.44 * torch.abs(s_st)) - c.stall_c[k])
    ct_st = 0.5 * cd0 * c_st
    cl_st = cn_st * c_st - ct_st * s_st
    cd_st = cn_st * s_st + ct_st * c_st
    cm_st = -cn_st * (0.25 - 0.175 * (1.0 - (2.0 / math.pi) * torch.abs(ae_st)))
    no_stall = (asn < alpha) & (alpha < asp)
    cl = torch.where(no_stall, cl_lin, cl_st)
    cd = torch.where(no_stall, cd_lin, cd_st)
    cmo = torch.where(no_stall, cm_lin, cm_st)
    # sin/cos(alpha) from the velocity components
    free2 = lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2]
    hyp2 = lifting * lifting + forward * forward
    degen = hyp2 < 1e-16
    r_inv = torch.rsqrt(torch.where(degen, 1.0, hyp2))
    sina = torch.where(degen, 0.0, -lifting * r_inv)
    cosa = torch.where(degen, 1.0, forward * r_inv)
    q = c.qa[k] * free2
    lift, drag = cl * q, cd * q
    return lift * cosa + drag * sina, lift * sina - drag * cosa, q * cmo * c.chord[k]


def _physics_plain(s: dict, c: FixedwingConsts, cmd: list[Tensor], gen, noisy: bool) -> tuple:
    """fixedwing_lane.cuh::physics_iter: one physics iteration in place on
    ``s``; returns the pre-integration rotation (9 row-major entries)."""
    dt = c.dt
    act = [s["act"][k] + c.lag[k] * (cmd[k] - s["act"][k]) for k in range(NUM_SURFACES)]
    thr = s["thr"] + c.mot_lag * (cmd[5] - s["thr"])
    if noisy:
        thr = thr + torch.randn(thr.shape, generator=gen, device=thr.device) * thr * c.mot_noise
    f = [torch.zeros_like(thr) for _ in range(3)]
    t = [torch.zeros_like(thr) for _ in range(3)]
    for k in range(NUM_SURFACES):
        fn, fp, qcm = _surface_plain(c, k, act[k], s["slv"][3 * k : 3 * k + 3])
        lu, du, tu = c.lu[3 * k : 3 * k + 3], c.du[3 * k : 3 * k + 3], c.tu[3 * k : 3 * k + 3]
        r = c.r_s[3 * k : 3 * k + 3]
        fs = [fn * lu[i] + fp * du[i] for i in range(3)]
        f = [f[i] + fs[i] for i in range(3)]
        t = [t[0] + qcm * tu[0] + (r[1] * fs[2] - r[2] * fs[1]),
             t[1] + qcm * tu[1] + (r[2] * fs[0] - r[0] * fs[2]),
             t[2] + qcm * tu[2] + (r[0] * fs[1] - r[1] * fs[0])]
    rpm = thr * c.mot_max_rpm
    rc = rpm * rpm * torch.sign(rpm)
    f = [f[i] + rc * c.mot_f[i] for i in range(3)]
    t = [t[i] + rc * c.mot_t[i] for i in range(3)]

    pos, quat, lvel, avel = s["pos"], s["quat"], s["lvel"], s["avel"]
    R = cm.quat_rotmat(quat)
    # the new read from the pre-integration state
    rcom = [R[3 * i] * c.com[0] + R[3 * i + 1] * c.com[1] + R[3 * i + 2] * c.com[2] for i in range(3)]
    bv = [lvel[0] - (avel[1] * rcom[2] - avel[2] * rcom[1]),
          lvel[1] - (avel[2] * rcom[0] - avel[0] * rcom[2]),
          lvel[2] - (avel[0] * rcom[1] - avel[1] * rcom[0])]
    lvb = [R[i] * bv[0] + R[3 + i] * bv[1] + R[6 + i] * bv[2] for i in range(3)]
    avb = [R[i] * avel[0] + R[3 + i] * avel[1] + R[6 + i] * avel[2] for i in range(3)]
    view = [*avb, *cm.quat_to_euler(quat), *lvb, *(pos[i] - rcom[i] for i in range(3))]
    slv = []
    for k in range(NUM_SURFACES):
        r = c.r_s[3 * k : 3 * k + 3]
        rw = [R[3 * i] * r[0] + R[3 * i + 1] * r[1] + R[3 * i + 2] * r[2] for i in range(3)]
        vs = [lvel[0] + (avel[1] * rw[2] - avel[2] * rw[1]),
              lvel[1] + (avel[2] * rw[0] - avel[0] * rw[2]),
              lvel[2] + (avel[0] * rw[1] - avel[1] * rw[0])]
        slv += [R[i] * vs[0] + R[3 + i] * vs[1] + R[6 + i] * vs[2] for i in range(3)]

    # semi-implicit Euler, the full inertia in the body frame
    fw = [R[3 * i] * f[0] + R[3 * i + 1] * f[1] + R[3 * i + 2] * f[2] for i in range(3)]
    lvel = [lvel[0] + dt * (fw[0] * c.inv_mass), lvel[1] + dt * (fw[1] * c.inv_mass),
            lvel[2] + dt * (fw[2] * c.inv_mass - GRAVITY)]
    I, Iinv = c.inertia, c.inv_inertia
    ob = avb
    iw = [I[3 * i] * ob[0] + I[3 * i + 1] * ob[1] + I[3 * i + 2] * ob[2] for i in range(3)]
    rhs = [t[0] - (ob[1] * iw[2] - ob[2] * iw[1]), t[1] - (ob[2] * iw[0] - ob[0] * iw[2]),
           t[2] - (ob[0] * iw[1] - ob[1] * iw[0])]
    ob = [ob[i] + dt * (Iinv[3 * i] * rhs[0] + Iinv[3 * i + 1] * rhs[1] + Iinv[3 * i + 2] * rhs[2])
          for i in range(3)]
    avel = [R[3 * i] * ob[0] + R[3 * i + 1] * ob[1] + R[3 * i + 2] * ob[2] for i in range(3)]
    pos = [pos[i] + dt * lvel[i] for i in range(3)]
    quat = cm.quat_integrate(quat, avel, dt)

    # detection-grade ground contact: the lowest contact point, projection
    # to the ground, an inelastic vertical stop
    x, y, z, w = quat
    c20, c21, c22 = 2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)
    pts = c.contact_pts
    zmin = c20 * pts[0] + c21 * pts[1] + c22 * pts[2]
    for j in range(1, MAX_CONTACT):
        zmin = torch.minimum(zmin, c20 * pts[3 * j] + c21 * pts[3 * j + 1] + c22 * pts[3 * j + 2])
    depth = -(pos[2] + zmin)
    hit = depth > 0.0
    pos[2] = torch.where(hit, pos[2] + depth, pos[2])
    lvel[2] = torch.where(hit & (lvel[2] < 0.0), 0.0, lvel[2])
    s.update(pos=pos, quat=quat, lvel=lvel, avel=avel, view=view, slv=slv, act=act, thr=thr,
             contact=hit.to(thr.dtype))
    return R


def _unpack_rows(S: list[Tensor]) -> dict:
    return {"pos": S[_POS:_POS + 3], "quat": S[_QUAT:_QUAT + 4], "lvel": S[_LVEL:_LVEL + 3],
            "avel": S[_AVEL:_AVEL + 3], "view": S[_VIEW:_VIEW + 12], "slv": S[_SLV:_SLV + 15],
            "act": S[_ACT:_ACT + 5], "thr": S[_THR], "contact": S[_CON]}


def _pack_rows(out: list, s: dict, sp: list[Tensor]) -> None:
    for base, key in ((_POS, "pos"), (_QUAT, "quat"), (_LVEL, "lvel"), (_AVEL, "avel"), (_VIEW, "view"),
                      (_SLV, "slv"), (_ACT, "act")):
        out[base : base + len(s[key])] = s[key]
    out[_THR] = s["thr"]
    out[_SP : _SP + 6] = sp
    out[_CON] = s["contact"]


def _twin_generator(seed: Tensor, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed.reshape(()).item()))
    return gen


def packed_step_plain(packed: Tensor, seed: Tensor, consts: FixedwingConsts, mode: int, noisy: bool) -> Tensor:
    """``packed_step``'s arithmetic in plain PyTorch (any device)."""
    _check(packed, seed, mode)
    c = consts
    S = list(packed.unbind(0))
    gen = _twin_generator(seed, packed.device) if noisy else None
    s = _unpack_rows(S)
    sp = S[_SP : _SP + 6]
    cmd = _control_plain(c, mode, sp)
    any_contact = torch.zeros_like(S[_CON])
    for _ in range(c.ratio):
        _physics_plain(s, c, cmd, gen, noisy)
        any_contact = torch.maximum(any_contact, s["contact"])
    out = [torch.zeros_like(any_contact)] * ROWS
    _pack_rows(out, s, sp)
    out[_RWD] = any_contact
    return torch.stack(out, dim=0)


def _waypoint_track_plain(R, lp, tgt, rem, ndist, nt: int, goal: float):
    """quadx_math.cuh::waypoint_track: body-frame deltas of the rolled
    targets, the distance to the current one, the masked delta
    observation, the reach and the cyclic advance. Returns ``(tgt, rem,
    ndist, odist, progress, tdlt, reached, all_reached)``."""
    deltas = []
    for k in range(nt):
        d = [tgt[3 * k + i] - lp[i] for i in range(3)]
        deltas.append([R[i] * d[0] + R[3 + i] * d[1] + R[6 + i] * d[2] for i in range(3)])
    d0 = deltas[0]
    ndist_new = torch.sqrt(d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2])
    zero = torch.zeros_like(rem)
    tdlt = []
    for k in range(MAX_TARGETS):
        keep = (rem > k + 0.5).to(rem.dtype) if k < nt else None
        tdlt += [deltas[k][i] * keep if k < nt else zero for i in range(3)]
    reached = (ndist_new < goal) & (rem > 0.5)
    n3 = 3 * nt
    tgt = [torch.where(reached, tgt[(j + 3) % n3], tgt[j]) for j in range(n3)] + list(tgt[n3:])
    rem = rem - reached.to(rem.dtype)
    return tgt, rem, ndist_new, ndist, ndist - ndist_new, tdlt, reached, rem < 0.5


def packed_waypoints_step_plain(
    packed: Tensor, seed: Tensor, consts: FixedwingConsts, mode: int, noisy: bool, sparse: bool = False
) -> Tensor:
    """``packed_waypoints_step``'s arithmetic in plain PyTorch (any
    device). The kernel leaves a done lane's inner loop; the twin computes
    every lane and selects, which gives the same state."""
    _check(packed, seed, mode)
    c = consts
    S = list(packed.unbind(0))
    gen = _twin_generator(seed, packed.device) if noisy else None
    st = _unpack_rows(S)
    st.update(term=S[_TERM], trunc=S[_TRUNC], coll=S[_COLL], oob=S[_OOB], cplt=S[_CPLT],
              tgt=S[_TGT : _TGT + 12], rem=S[_REM], ndist=S[_NDIST], odist=S[_ODIST], tdlt=S[_TDLT : _TDLT + 12])
    sp = S[_SP : _SP + 6]
    stepc = S[_STEP]
    st["rwd"] = torch.full_like(stepc, -0.1)  # re-armed every agent step
    trunc_hit = (stepc > c.max_steps).to(stepc.dtype)  # the count before this step's increment
    one = torch.ones_like(stepc)
    cmd = _control_plain(c, mode, sp)

    for _ in range(c.inner_steps):
        done = (st["term"] + st["trunc"]) > 0.0
        nw = dict(st)
        any_contact = torch.zeros_like(stepc)
        for _ in range(c.ratio):
            R = _physics_plain(nw, c, cmd, gen, noisy)
            any_contact = torch.maximum(any_contact, nw["contact"])
        lp = nw["view"][9:12]
        oob_i = ((lp[0] * lp[0] + lp[1] * lp[1] + lp[2] * lp[2]) > c.dome2).to(stepc.dtype)
        fatal = torch.maximum(any_contact, oob_i)
        (nw["tgt"], nw["rem"], nw["ndist"], nw["odist"], progress, nw["tdlt"], reached,
         all_reached) = _waypoint_track_plain(R, lp, nw["tgt"], nw["rem"], nw["ndist"], c.num_targets, c.goal)
        rwd = torch.where(fatal > 0.0, -100.0, nw["rwd"])
        if not sparse:
            rwd = rwd + torch.clamp(3.0 * progress, min=0.0) + 1.0 / nw["ndist"]
        nw["rwd"] = torch.where(reached, 100.0, rwd)
        nw["trunc"] = torch.where(all_reached, one, torch.clamp(nw["trunc"] + trunc_hit, max=1.0))
        nw["cplt"] = torch.where(all_reached, one, nw["cplt"])
        nw["term"] = torch.clamp(nw["term"] + fatal, max=1.0)
        nw["coll"] = torch.clamp(nw["coll"] + any_contact, max=1.0)
        nw["oob"] = torch.clamp(nw["oob"] + oob_i, max=1.0)
        for key, old in st.items():  # the done-freeze
            st[key] = ([torch.where(done, o, v) for o, v in zip(old, nw[key])] if isinstance(old, list)
                       else torch.where(done, old, nw[key]))

    out = [torch.zeros_like(stepc)] * ROWS
    _pack_rows(out, st, sp)
    out[_RWD] = st["rwd"]
    out[_TERM] = st["term"]
    out[_TRUNC] = st["trunc"]
    out[_COLL] = st["coll"]
    out[_OOB] = st["oob"]
    out[_STEP] = stepc + 1.0  # unconditional, after the inner loop
    out[_CPLT] = st["cplt"]
    out[_TGT : _TGT + 12] = st["tgt"]
    out[_REM] = st["rem"]
    out[_NDIST] = st["ndist"]
    out[_ODIST] = st["odist"]
    out[_TDLT : _TDLT + 12] = st["tdlt"]
    return torch.stack(out, dim=0)
