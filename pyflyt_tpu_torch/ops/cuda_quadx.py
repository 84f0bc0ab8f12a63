"""Fused QuadX-Hover agent step on a packed ``(ROWS, N)`` state (port of
``pyflyt_tpu/ops/pallas_quadx.py::packed_hover_step``).

``packed_hover_step`` launches the CUDA kernel ``csrc/quadx_hover_step.cu``
for a CUDA tensor and runs ``packed_hover_step_plain``, its plain PyTorch
twin, for a CPU tensor. There is no fallback between the two: a CUDA
tensor launches the kernel or raises.

Layout: SoA ``(ROWS, N)`` f32, one column per env, with the row indices of
the Pallas module so packed rows compare one to one. The TPU's
``(ROWS, 8, N/8)`` sublane fold is dropped: on the card one thread owns one
env and a warp's load of a row is one coalesced transaction. Any N works.

Bound on an H100 at N=8192: the kernel reads 55 of the 56 f32 rows (not
the reward row, which it re-arms) and writes all 56, 444 B per env
(3.64 MB, about 1.09 µs at 3.35 TB/s) and does about 2 kFLOP of f32 work
per env (about 0.3 µs at 67 TFLOP/s), so bytes bound it and launch latency
costs more than both. See the source note in the .cu file for the design.

With noise on, the kernel draws Philox normals keyed by (seed, env index,
draw index) and the twin draws from a ``torch.Generator`` seeded with the
same seed: same distribution, different numbers.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
from torch import Tensor

from pyflyt_tpu_torch.models import quadx
from pyflyt_tpu_torch.ops import cuda_math as cm
from pyflyt_tpu_torch.ops.cuda_build import Kernel

ROWS = 56

# row layout (pallas_quadx.py:52-67)
_POS = 0       # 3: world ENU position
_QUAT = 3      # 4: xyzw body->world
_LVEL = 7      # 3: world linear velocity
_AVEL = 10     # 3: world angular velocity
_VIEW = 13     # 12: [ang_vel_b, euler, lin_vel_b, lin_pos] (lagged)
_AVB = 25      # 3: lagged body rates
_DRG = 28      # 3: lagged body-frame air velocity
_THR = 31      # 4: motor throttle
_PWM = 35      # 4: motor pwm
_SP = 39       # 4: setpoint
_PINT = 43     # 3: ang_vel PID integral
_PPRV = 46     # 3: ang_vel PID prev error
_CON = 49      # 1: contact flag (0/1)
# env rows of the hover-fused layout (pallas_quadx.py:207-213)
_RWD = 50      # running reward of the agent step
_TERM = 51     # termination flag
_TRUNC = 52    # truncation flag
_COLL = 53     # collision info flag
_OOB = 54      # out-of-bounds info flag
_STEP = 55     # agent step count, f32 (exact below 2^24)

GRAVITY = 9.81
# f32 operations per env in one physics iteration, control and task update,
# counted from the kernel source (adds, multiplies, divides, compares,
# transcendentals each 1) — the operation side of the kernel's bound
OPS_PER_PHYSICS_ITER = 330
OPS_PER_CONTROL = 75
OPS_PER_TASK_UPDATE = 30


def pack_state(state: quadx.QuadXState) -> Tensor:
    """Batched ``QuadXState`` (N,) → ``(ROWS, N)`` f32; env rows zero."""
    n = state.body.pos.shape[0]
    rows = [
        state.body.pos.T,
        state.body.quat.T,
        state.body.lin_vel.T,
        state.body.ang_vel.T,
        state.read.view.reshape(n, 12).T,
        state.read.ang_vel_body.T,
        state.read.drag_local_vel.T,
        state.throttle.T,
        state.pwm.T,
        state.setpoint.T,
        state.pids.ang_vel.integral.T,
        state.pids.ang_vel.prev_error.T,
        state.contact.to(torch.float32)[None, :],
    ]
    packed = torch.cat([r.to(torch.float32) for r in rows], dim=0)
    pad = packed.new_zeros((ROWS - packed.shape[0], n))
    return torch.cat([packed, pad], dim=0).contiguous()


def unpack_state(packed: Tensor, template: quadx.QuadXState) -> quadx.QuadXState:
    """``(ROWS, N)`` → ``QuadXState``; PID banks outside the layout keep the
    template's values."""
    g = lambda r, k: packed[r : r + k].T  # noqa: E731
    n = packed.shape[1]
    pids = dataclasses.replace(
        template.pids,
        ang_vel=dataclasses.replace(
            template.pids.ang_vel, integral=g(_PINT, 3), prev_error=g(_PPRV, 3)
        ),
    )
    return dataclasses.replace(
        template,
        body=dataclasses.replace(
            template.body, pos=g(_POS, 3), quat=g(_QUAT, 4), lin_vel=g(_LVEL, 3),
            ang_vel=g(_AVEL, 3),
        ),
        read=dataclasses.replace(
            template.read, view=g(_VIEW, 12).reshape(n, 4, 3),
            ang_vel_body=g(_AVB, 3), drag_local_vel=g(_DRG, 3),
        ),
        throttle=g(_THR, 4),
        pwm=g(_PWM, 4),
        setpoint=g(_SP, 4),
        pids=pids,
        contact=packed[_CON] > 0.5,
    )


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------


def _floats(n: int):
    """A dataclass field of ``n`` floats (a ``float[n]`` in the C struct)."""
    return dataclasses.field(metadata={"len": n})


@dataclasses.dataclass(frozen=True)
class HoverConsts:
    """Vehicle and task constants of one hover env, as Python floats.

    The kernel gets them as one POD struct by value (``_HoverConstsC``,
    whose fields are these, in this order); the twin reads the same values,
    so both round them identically.
    """

    mass: float
    inertia: tuple = _floats(3)
    motor_map: tuple = _floats(16)  # row-major (4, 4)
    mpos_x: tuple = _floats(4)
    mpos_y: tuple = _floats(4)
    thrust_coef: tuple = _floats(4)
    torque_coef: tuple = _floats(4)
    lag: tuple = _floats(4)  # physics_period / tau
    max_rpm: tuple = _floats(4)
    noise_ratio: tuple = _floats(4)
    drag_xyz: tuple = _floats(3)
    drag_pqr: float
    kp: tuple = _floats(3)
    ki: tuple = _floats(3)
    kd: tuple = _floats(3)
    lim: tuple = _floats(3)
    period: float
    dt: float
    min_pwm: float
    max_pwm: float
    half_ext: tuple = _floats(3)
    dome2: float
    max_steps: float
    inner_steps: int
    ratio: int


def hover_consts(
    params: quadx.QuadXParams,
    cfg: quadx.QuadXConfig,
    inner_steps: int,
    dome: float,
    max_steps: int,
) -> HoverConsts:
    """Reads the parameter tensors once into ``HoverConsts``."""
    if cfg.orn_conv != "ENU_FLU":
        raise NotImplementedError("the fused hover step is ENU only")
    f = lambda t: tuple(float(v) for v in np.asarray(t.detach().cpu(), np.float64).reshape(-1))  # noqa: E731
    if not np.allclose(np.asarray(params.motor.thrust_unit.cpu()), [0.0, 0.0, 1.0]):
        raise NotImplementedError(
            "the fused hover step assumes +z thrust for every motor"
        )
    pos = np.asarray(params.motor.positions.cpu(), np.float64)
    tau = np.asarray(params.motor.tau.cpu(), np.float64)
    return HoverConsts(
        mass=float(params.mass),
        inertia=f(params.inertia),
        motor_map=f(params.motor_map),
        mpos_x=tuple(float(v) for v in pos[:, 0]),
        mpos_y=tuple(float(v) for v in pos[:, 1]),
        thrust_coef=f(params.motor.thrust_coef),
        torque_coef=f(params.motor.torque_coef),
        lag=tuple(float(cfg.physics_period / t) for t in tau),
        max_rpm=f(params.motor.max_rpm),
        noise_ratio=f(params.motor.noise_ratio),
        drag_xyz=f(params.drag_const_xyz),
        drag_pqr=float(params.drag_coef_pqr),
        kp=f(params.pid_ang_vel.kp),
        ki=f(params.pid_ang_vel.ki),
        kd=f(params.pid_ang_vel.kd),
        lim=f(params.pid_ang_vel.lim),
        period=float(params.pid_ang_vel.period),
        dt=float(cfg.physics_period),
        min_pwm=float(cfg.min_pwm),
        max_pwm=float(cfg.max_pwm),
        half_ext=f(params.collision_half_extents),
        dome2=float(dome) ** 2,
        max_steps=float(max_steps),
        inner_steps=int(inner_steps),
        ratio=int(cfg.physics_control_ratio),
    )


def ops_per_env(c: HoverConsts) -> int:
    """f32 operations one agent step does per env (for the bound)."""
    per_aviary = OPS_PER_CONTROL + c.ratio * OPS_PER_PHYSICS_ITER + OPS_PER_TASK_UPDATE
    return c.inner_steps * per_aviary


def _ctype(f: dataclasses.Field):
    if "len" in f.metadata:
        return ctypes.c_float * f.metadata["len"]
    return {"float": ctypes.c_float, "int": ctypes.c_int}[f.type]


class _HoverConstsC(ctypes.Structure):
    """Mirror of ``struct HoverConsts`` in csrc/quadx_hover_step.cu, field
    by field from ``HoverConsts`` (a test holds the C struct to it)."""

    _fields_ = [(f.name, _ctype(f)) for f in dataclasses.fields(HoverConsts)]

    @classmethod
    @functools.lru_cache(maxsize=8)  # one per env config; saves host time per launch
    def of(cls, c: HoverConsts) -> "_HoverConstsC":
        s = cls()
        for name, ctype in cls._fields_:
            v = getattr(c, name)
            if isinstance(v, tuple):
                getattr(s, name)[:] = v
            else:
                setattr(s, name, v)
        return s


# ---------------------------------------------------------------------------
# the kernel wrapper and its plain twin
# ---------------------------------------------------------------------------

KERNEL = Kernel(
    "quadx_hover_step.cu",
    "quadx_hover_step",
    [
        ctypes.c_void_p,  # in
        ctypes.c_void_p,  # out
        ctypes.c_int,  # n
        ctypes.c_void_p,  # seed (device int64)
        ctypes.c_void_p,  # consts (host struct)
        ctypes.c_int,  # mode
        ctypes.c_int,  # noisy
        ctypes.c_int,  # sparse
        ctypes.c_void_p,  # stream
    ],
)


def _check_args(packed: Tensor, seed: Tensor, mode: int) -> None:
    if mode not in (0, 8):
        raise NotImplementedError(
            f"the fused hover step covers modes 0 and 8, not {mode}: ROADMAP.md, "
            "kernel queue row 2 (pallas_quadx.packed_step)"
        )
    if packed.dtype != torch.float32 or packed.dim() != 2 or packed.shape[0] != ROWS:
        raise ValueError(f"packed must be ({ROWS}, N) float32, got {tuple(packed.shape)} {packed.dtype}")
    if seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != packed.device:
        raise ValueError("seed must be one int64 on the packed state's device")


def packed_hover_step(
    packed: Tensor,
    seed: Tensor,
    consts: HoverConsts,
    mode: int,
    noisy: bool,
    sparse: bool = False,
) -> Tensor:
    """One full hover agent step on the packed ``(ROWS, N)`` state: returns
    the new packed state (a new tensor). ``seed`` is a one-element int64
    tensor on the state's device (the motor-noise key of this step)."""
    _check_args(packed, seed, mode)
    if packed.device.type == "cpu":
        return packed_hover_step_plain(packed, seed, consts, mode, noisy, sparse)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    n = packed.shape[1]
    out = torch.empty_like(packed)
    cstruct = _HoverConstsC.of(consts)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.fn()(
            packed.data_ptr(), out.data_ptr(), n, seed.data_ptr(),
            ctypes.addressof(cstruct), mode, int(noisy), int(sparse), stream,
        )
    KERNEL.check(rc)
    KERNEL.launches += 1
    return out


def packed_hover_step_plain(
    packed: Tensor,
    seed: Tensor,
    consts: HoverConsts,
    mode: int,
    noisy: bool,
    sparse: bool = False,
) -> Tensor:
    """The kernel's arithmetic in plain PyTorch, row by row (any device)."""
    _check_args(packed, seed, mode)
    c = consts
    S = list(packed.unbind(0))
    gen = None
    if noisy:
        gen = torch.Generator(device=packed.device)
        gen.manual_seed(int(seed.reshape(()).item()))

    def clip(v, lo, hi):
        return torch.clamp(v, lo, hi)

    st = {
        "pos": S[_POS:_POS + 3], "quat": S[_QUAT:_QUAT + 4],
        "lvel": S[_LVEL:_LVEL + 3], "avel": S[_AVEL:_AVEL + 3],
        "view": S[_VIEW:_VIEW + 12], "avb": S[_AVB:_AVB + 3],
        "drg": S[_DRG:_DRG + 3], "thr": S[_THR:_THR + 4],
        "pwm": S[_PWM:_PWM + 4], "pint": S[_PINT:_PINT + 3],
        "pprv": S[_PPRV:_PPRV + 3], "contact": S[_CON],
        "term": S[_TERM], "trunc": S[_TRUNC], "coll": S[_COLL], "oob": S[_OOB],
    }
    sp = S[_SP:_SP + 4]
    stepc = S[_STEP]
    st["rwd"] = torch.full_like(stepc, -0.1)
    trunc_hit = (stepc > c.max_steps).to(stepc.dtype)
    mm = c.motor_map

    def control(s):
        if mode == 8:
            raw = list(sp)
        else:
            cmd = []
            pint, pprv = list(s["pint"]), list(s["pprv"])
            for k in range(3):
                err = sp[k] - s["view"][k]
                pint[k] = clip(pint[k] + c.ki[k] * err * c.period, -c.lim[k], c.lim[k])
                deriv = c.kd[k] * (err - pprv[k]) / c.period
                pprv[k] = err
                cmd.append(clip(c.kp[k] * err + pint[k] + deriv, -c.lim[k], c.lim[k]))
            cmd.append(clip(sp[3], 0.0, 1.0))
            s["pint"], s["pprv"] = pint, pprv
            raw = [
                mm[4 * m] * cmd[0] + mm[4 * m + 1] * cmd[1]
                + mm[4 * m + 2] * cmd[2] + mm[4 * m + 3] * cmd[3]
                for m in range(4)
            ]
        high = torch.maximum(torch.maximum(raw[0], raw[1]), torch.maximum(raw[2], raw[3]))
        low = torch.minimum(torch.minimum(raw[0], raw[1]), torch.minimum(raw[2], raw[3]))
        pmax = torch.clamp(high, max=c.max_pwm)
        pmin = torch.clamp(low, min=c.min_pwm)
        d_add, d_sub = pmax - low, high - pmin
        f_add = torch.where(d_add != 0, (pmin - low) / torch.where(d_add != 0, d_add, 1.0), 0.0)
        f_sub = torch.where(d_sub != 0, (high - pmax) / torch.where(d_sub != 0, d_sub, 1.0), 0.0)
        s["pwm"] = [
            clip(torch.where(high != low, r + f_add * (pmax - r) - f_sub * (r - pmin), r),
                 c.min_pwm, c.max_pwm)
            for r in raw
        ]

    def physics(s):
        thr = list(s["thr"])
        nrm = torch.randn(4, stepc.shape[0], generator=gen, device=stepc.device) if noisy else None
        for m in range(4):
            thr[m] = thr[m] + c.lag[m] * (s["pwm"][m] - thr[m])
            if noisy:
                thr[m] = thr[m] + nrm[m] * thr[m] * c.noise_ratio[m]
        s["thr"] = thr
        fz = tx = ty = tz = torch.zeros_like(stepc)
        for m in range(4):
            rpm = thr[m] * c.max_rpm[m]
            rc = rpm * rpm * torch.sign(rpm)
            f = rc * c.thrust_coef[m]
            fz = fz + f
            tx = tx + c.mpos_y[m] * f
            ty = ty - c.mpos_x[m] * f
            tz = tz + rc * c.torque_coef[m]
        drg, avb = s["drg"], s["avb"]
        fd = [-torch.sign(drg[k]) * c.drag_xyz[k] * drg[k] * drg[k] for k in range(3)]
        nc = 1.0 - s["contact"]
        tx = tx - nc * torch.sign(avb[0]) * c.drag_pqr * avb[0] * avb[0]
        ty = ty - nc * torch.sign(avb[1]) * c.drag_pqr * avb[1] * avb[1]
        tz = tz - nc * torch.sign(avb[2]) * c.drag_pqr * avb[2] * avb[2]
        fx, fy, fz = fd[0], fd[1], fz + fd[2]

        r = cm.quat_rotmat(s["quat"])
        lvel, avel, pos = s["lvel"], s["avel"], s["pos"]
        lvb = [r[k] * lvel[0] + r[3 + k] * lvel[1] + r[6 + k] * lvel[2] for k in range(3)]
        avb_new = [r[k] * avel[0] + r[3 + k] * avel[1] + r[6 + k] * avel[2] for k in range(3)]
        eul = cm.quat_to_euler(s["quat"])
        new_view = [*avb_new, *eul, *lvb, *pos]

        fw = [r[3 * k] * fx + r[3 * k + 1] * fy + r[3 * k + 2] * fz for k in range(3)]
        lvel = [lvel[0] + c.dt * (fw[0] / c.mass),
                lvel[1] + c.dt * (fw[1] / c.mass),
                lvel[2] + c.dt * (fw[2] / c.mass - GRAVITY)]
        I = c.inertia
        ob = avb_new
        gyro = [ob[1] * I[2] * ob[2] - ob[2] * I[1] * ob[1],
                ob[2] * I[0] * ob[0] - ob[0] * I[2] * ob[2],
                ob[0] * I[1] * ob[1] - ob[1] * I[0] * ob[0]]
        tq = [tx, ty, tz]
        obn = [ob[k] + c.dt * ((tq[k] - gyro[k]) / I[k]) for k in range(3)]
        avel = [r[3 * k] * obn[0] + r[3 * k + 1] * obn[1] + r[3 * k + 2] * obn[2] for k in range(3)]
        pos = [pos[k] + c.dt * lvel[k] for k in range(3)]
        quat = cm.quat_integrate(s["quat"], avel, c.dt)

        x, y, z, w = quat
        extent = (torch.abs(2 * (x * z - w * y)) * c.half_ext[0]
                  + torch.abs(2 * (y * z + w * x)) * c.half_ext[1]
                  + torch.abs(1 - 2 * (x * x + y * y)) * c.half_ext[2])
        depth = extent - pos[2]
        hit = depth > 0.0
        pos[2] = torch.where(hit, pos[2] + depth, pos[2])
        lvel[2] = torch.where(hit & (lvel[2] < 0.0), 0.0, lvel[2])
        s.update(pos=pos, quat=quat, lvel=lvel, avel=avel, view=new_view,
                 avb=avb_new, drg=lvb, contact=hit.to(stepc.dtype))

    for _ in range(c.inner_steps):
        frozen = torch.clamp(torch.maximum(st["term"], st["trunc"]), max=1.0) > 0.0
        nw = dict(st)
        any_contact = torch.zeros_like(stepc)
        for it in range(c.ratio):
            if it == 0:
                control(nw)
            physics(nw)
            any_contact = torch.maximum(any_contact, nw["contact"])
        vx, vy, vz = nw["view"][9], nw["view"][10], nw["view"][11]
        oob_i = ((vx * vx + vy * vy + vz * vz) > c.dome2).to(stepc.dtype)
        fatal = torch.maximum(any_contact, oob_i)
        nw["trunc"] = torch.clamp(nw["trunc"] + trunc_hit, max=1.0)
        rwd = torch.where(fatal > 0.0, -100.0, nw["rwd"])
        if not sparse:
            dz = vz - 1.0
            v3, v4 = nw["view"][3], nw["view"][4]
            rwd = rwd - torch.sqrt(vx * vx + vy * vy + dz * dz) - torch.sqrt(v3 * v3 + v4 * v4) + 1.0
        nw["rwd"] = rwd
        nw["term"] = torch.clamp(nw["term"] + fatal, max=1.0)
        nw["coll"] = torch.clamp(nw["coll"] + any_contact, max=1.0)
        nw["oob"] = torch.clamp(nw["oob"] + oob_i, max=1.0)
        # done-freeze as a select
        for key, old in st.items():
            if isinstance(old, list):
                st[key] = [torch.where(frozen, o, v) for o, v in zip(old, nw[key])]
            else:
                st[key] = torch.where(frozen, old, nw[key])

    out = [None] * ROWS
    for base, key in ((_POS, "pos"), (_QUAT, "quat"), (_LVEL, "lvel"),
                      (_AVEL, "avel"), (_VIEW, "view"), (_AVB, "avb"),
                      (_DRG, "drg"), (_THR, "thr"), (_PWM, "pwm"),
                      (_PINT, "pint"), (_PPRV, "pprv")):
        for k, v in enumerate(st[key]):
            out[base + k] = v
    out[_SP:_SP + 4] = sp
    out[_CON] = st["contact"]
    out[_RWD] = st["rwd"]
    out[_TERM] = st["term"]
    out[_TRUNC] = st["trunc"]
    out[_COLL] = st["coll"]
    out[_OOB] = st["oob"]
    out[_STEP] = stepc + 1.0
    return torch.stack(out, dim=0)
