"""The narrow trunks' kernel family (K4n, K3n, K2n: ``ops/cuda_narrow.py``,
``csrc/policy_narrow.cuh``), torch only: the weight image against its
inverse, its zero padding exact through the twins, the one envelope
function's routing, K2n's device-written image rule, the ctypes mirrors
against the C structs, the generalised flop counts, and the addresses the
kernels' ``ldmatrix`` and ``mma.sync`` fragments read, emulated lane by
lane on the image and on the staging buffers."""

from __future__ import annotations

import ctypes
import re

import numpy as np
import pytest
import torch

from pyflyt_tpu_torch.ops import cuda_build, cuda_narrow, cuda_policy, cuda_sgd
from pyflyt_tpu_torch.rl.networks import ActorCritic

torch.set_num_threads(1)

TRUNKS = [(64, 64, 32, 32), (32, 32), (128,), (48, 24), (128, 64, 32, 16)]


def _trunk(obs: int, sizes, outs: int, seed: int):
    g = np.random.default_rng(seed)
    dims = (obs, *sizes, outs)
    mats = [torch.from_numpy(g.normal(size=(a, b)).astype(np.float32)) for a, b in zip(dims[:-1], dims[1:])]
    biases = [torch.from_numpy(g.normal(size=(b,)).astype(np.float32)) for b in dims[1:]]
    return mats[:-1], biases[:-1], mats[-1], biases[-1]


@pytest.mark.parametrize("sizes", TRUNKS)
@pytest.mark.parametrize("obs,outs", [(16, 4), (19, 1), (21, 8), (64, 4)])
def test_image_round_trip_and_zero_padding(sizes, obs, outs):
    w, b, hw, hb = _trunk(obs, sizes, outs, seed=obs + outs)
    image = cuda_narrow.pack_trunk(w, b, hw, hb)
    lay = cuda_narrow.layout(obs, sizes, outs)
    assert image.shape == (lay.bytes,) and lay.bytes % 16 == 0
    assert all(off % 16 == 0 for off in (*lay.w_off, *lay.b_off))
    assert all((2 * (k + 8)) % 32 == 16 for k in lay.k)  # odd multiples of 16 bytes: no ldmatrix conflict
    mats, biases = cuda_narrow.unpack_trunk(image, lay)
    for got, want in zip(mats, [*w, hw]):
        assert torch.equal(got, want.to(torch.bfloat16))
    for got, want in zip(biases, [*b, hb]):
        assert torch.equal(got, want)
    # everything outside the real entries is zero
    mask = torch.zeros(lay.bytes, dtype=torch.bool)
    for i in range(lay.depth + 1):
        rows = torch.arange(lay.nr[i])[:, None] * (lay.k[i] + 8) + torch.arange(lay.kr[i])[None, :]
        words = lay.w_off[i] + 2 * rows.reshape(-1)
        mask[words] = mask[words + 1] = True
        mask[lay.b_off[i] : lay.b_off[i] + 4 * lay.nr[i]] = True
    assert int(image[~mask].abs().sum()) == 0


def _padded(w):
    """The twin's weights with every width padded to the image's (zeros)."""
    def pad(t, rows, cols):
        out = torch.zeros((rows, cols), dtype=t.dtype) if t.dim() == 2 else torch.zeros(cols, dtype=t.dtype)
        if t.dim() == 2:
            out[: t.shape[0], : t.shape[1]] = t
        else:
            out[: t.shape[0]] = t
        return out

    def trunk(ws, bs, hw, hb, lay):
        n = [*lay.n[:-1], hw.shape[1]]  # the head keeps its real outputs
        k = [ws[0].shape[0], *lay.k[1:]]  # the obs keeps its real width
        return ([pad(t, k[i], n[i]) for i, t in enumerate(ws)], [pad(t, 0, n[i]) for i, t in enumerate(bs)],
                pad(hw, k[-1], n[-1]), pad(hb, 0, n[-1]))

    pi = trunk(w.pi_w, w.pi_b, w.pi_head_w, w.pi_head_b, cuda_narrow.weight_layouts(w)[0])
    vf = trunk(w.vf_w, w.vf_b, w.vf_head_w, w.vf_head_b, cuda_narrow.weight_layouts(w)[1])
    return cuda_policy.PolicyWeights(*pi, *vf)


@pytest.mark.parametrize("sizes", TRUNKS)
def test_zero_padding_is_exact_through_the_forward_twin(sizes):
    net = ActorCritic(19, 4, feature_sizes=(), pi_sizes=sizes, vf_sizes=sizes, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    w = net.kernel_weights()
    obs = torch.from_numpy(np.random.default_rng(0).normal(size=(33, 19)).astype(np.float32))
    m1, v1 = cuda_policy.policy_value_forward_plain(obs, w)
    m2, v2 = cuda_policy.policy_value_forward_plain(obs, _padded(w))
    assert torch.allclose(m1, m2, rtol=0, atol=1e-6) and torch.allclose(v1, v2, rtol=0, atol=1e-6)


def test_zero_padding_stays_zero_through_the_epoch_twin():
    """Padded units get exactly zero gradients, so Adam leaves them at zero,
    and the real entries move as without the padding."""
    obs, act, sizes, padded = 19, 4, (24, 8), (32, 16)
    g = np.random.default_rng(5)
    net = dict(obs_dim=obs, act_dim=act, pi_sizes=padded, vf_sizes=padded)
    small = dict(net, pi_sizes=sizes, vf_sizes=sizes)
    leaves_p = []
    for name, shape in cuda_sgd.leaf_specs(net):
        t = torch.zeros(shape)
        real = dict(cuda_sgd.leaf_specs(small))[name]
        t[: real[0], : real[1]] = torch.from_numpy(g.normal(size=real).astype(np.float32)) * 0.3
        leaves_p.append(t)
    leaves_s = [t[: s[0], : s[1]].clone() for t, (_, s) in zip(leaves_p, cuda_sgd.leaf_specs(small))]
    rows = torch.from_numpy(g.normal(size=(2, 96, obs + act + 3)).astype(np.float32))
    stats = torch.stack([rows[:, :, obs + act + 1].mean(1), rows[:, :, obs + act + 1].std(1, correction=0)], 1)
    t0 = torch.tensor([3], dtype=torch.int32)

    def run(leaves, pi):
        cfg = cuda_sgd.EpochConfig(obs, act, pi, pi, 3e-4, 0.2, 0.01, 0.5, 0.5, (-1.0, 0.5))
        zeros = [torch.zeros_like(t) for t in leaves]
        return cuda_sgd.fused_epoch_plain(rows, stats, t0, leaves, zeros, [z.clone() for z in zeros], cfg)

    lp, mp, _, metp = run(leaves_p, padded)
    ls, _, _, mets = run(leaves_s, sizes)
    for a, b, (_, s) in zip(lp, ls, cuda_sgd.leaf_specs(small)):
        assert torch.allclose(a[: s[0], : s[1]], b, rtol=0, atol=1e-6)
        pad = a.clone()
        pad[: s[0], : s[1]] = 0
        assert int((pad != 0).sum()) == 0
    for m, (_, s) in zip(mp, cuda_sgd.leaf_specs(small)):
        pad = m.clone()
        pad[: s[0], : s[1]] = 0
        assert int((pad != 0).sum()) == 0
    assert torch.allclose(metp, mets, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pi,vf,want", [
    ((256, 256), (256, 256), "wide"),
    ((64, 64, 32, 32), (64, 64, 32, 32), "narrow"),
    ((32, 32), (32, 32), "narrow"),
    ((128,), (128,), "narrow"),
    ((64, 64, 32, 32), (128, 16), "narrow"),
    ((256, 256), (64, 64), None),
    ((256,), (256,), None),
    ((256, 256, 256), (256, 256, 256), None),
    ((64, 64, 32, 32, 32), (64,), None),
    ((), (), None),
])
def test_one_envelope_routes_every_kernel(pi, vf, want):
    """``cuda_sgd._check_envelope`` decides for K4 (via the weights), K3
    and K2 alike, by both trunks; ``want`` None: neither the wide nor the
    narrow family takes the pair, so the general family does, with its
    images; the actor beside a critic of its own widths takes its own."""
    net = ActorCritic(19, 4, feature_sizes=(), pi_sizes=pi, vf_sizes=vf, device="cpu")
    w = net.kernel_weights()
    family = want or "general"
    assert cuda_sgd._check_envelope(19, 4, pi, vf) == family
    assert cuda_policy._kernel_family(w) == family and cuda_policy._check_kernel_shapes(torch.zeros(2, 19), w) == family
    assert w.pi_image is not None and w.vf_image is not None
    own = "wide" if tuple(pi) == (256, 256) else "narrow" if cuda_sgd.in_envelope(pi) else "general"
    assert cuda_sgd._check_envelope(19, 4, pi, pi) == own
    if want is None:
        for other in ("wide", "narrow"):
            with pytest.raises(NotImplementedError, match="got pi"):
                cuda_sgd.check_family(other, 19, 4, pi, vf)


@pytest.mark.parametrize("pi,vf", [((64, 64, 32, 32), (64, 64, 32, 32)), ((128, 64, 32, 16), (48, 24))])
@pytest.mark.parametrize("obs,act", [(16, 4), (21, 1), (64, 8)])
def test_image_slots_scatter_is_pack_trunk(pi, vf, obs, act):
    """K2n's Adam writes each flat entry at ``image_slots``: scattering the
    flat parameters through it gives ``pack_trunk`` of both trunks."""
    net = ActorCritic(obs, act, feature_sizes=(), pi_sizes=pi, vf_sizes=vf, device="cpu",
                      generator=torch.Generator().manual_seed(obs))
    leaves = [t.detach() for t in cuda_sgd.params_to_leaves(net)]
    shapes = [tuple(t.shape) for t in leaves]
    offsets, P = cuda_sgd.flat_layout(shapes)
    flat = cuda_sgd._to_flat(leaves, offsets, P)
    slot, is_f32 = cuda_narrow.image_slots(obs, act, pi, vf)
    lays = (cuda_narrow.layout(obs, pi, act), cuda_narrow.layout(obs, vf, 1))
    stride = cuda_narrow.image_stride(*lays)
    images = torch.zeros(2 * stride, dtype=torch.uint8)
    wmask, fmask = (slot >= 0) & ~is_f32, (slot >= 0) & is_f32
    bf = flat[wmask].to(torch.bfloat16).view(torch.uint8).view(-1, 2)
    images[slot[wmask]], images[slot[wmask] + 1] = bf[:, 0], bf[:, 1]
    f4 = flat[fmask].view(torch.uint8).view(-1, 4)
    for c in range(4):
        images[slot[fmask] + c] = f4[:, c]
    (pw, pb, phw, phb), (vw, vb, vhw, vhb) = cuda_narrow.trunk_leaves(leaves, len(pi), len(vf))
    want = torch.zeros(2 * stride, dtype=torch.uint8)
    want[: lays[0].bytes] = cuda_narrow.pack_trunk(pw, pb, phw, phb)
    want[stride : stride + lays[1].bytes] = cuda_narrow.pack_trunk(vw, vb, vhw, vhb)
    assert torch.equal(images, want)
    # log_std and the flat padding have no slot
    assert int((slot >= 0).sum()) == sum(t.numel() for i, t in enumerate(leaves) if i != 2 * len(pi) + 2)


def _c_struct(source: str, struct: str):
    body = re.search(rf"struct {struct} \{{(.*?)\}};", (cuda_build.CSRC / source).read_text(), re.S).group(1)
    out = []
    for ctype, ptr, name, dims in re.findall(r"^\s*(?:const )?(\w+)(\*?) (\w+)((?:\[[\w:]+\])*);", body, re.M):
        n = 1
        for d in re.findall(r"\[([\w:]+)\]", dims):
            n *= {"narrow::LAYERS": cuda_narrow.LAYERS, "LAYERS": cuda_narrow.LAYERS}.get(d) or int(d)
        kind = "ptr" if ptr else ctype
        out.append((name, kind, n))
    return out


def _py_struct(cls):
    out = []
    for name, t in cls._fields_:
        n = 1
        while issubclass(t, ctypes.Array):
            n, t = n * t._length_, t._type_
        kind = {ctypes.c_void_p: "ptr", ctypes.c_float: "float", ctypes.c_int: "int",
                cuda_narrow._TrunkC: "NarrowTrunk"}[t]
        out.append((name, kind, n))
    return out


@pytest.mark.parametrize("source,struct,cls", [
    ("policy_narrow.cuh", "NarrowTrunk", cuda_narrow._TrunkC),
    ("policy_narrow.cu", "NarrowForwardArgs", cuda_narrow._ForwardArgsC),
    ("policy_narrow.cu", "NarrowLogpArgs", cuda_narrow._LogpArgsC),
    ("fused_epoch_narrow.cu", "NarrowEpochArgs", cuda_narrow._EpochArgsC),
])
def test_ctypes_mirrors_match_the_c_structs(source, struct, cls):
    assert _py_struct(cls) == _c_struct(source, struct)


def test_header_constants_match_the_wrapper():
    text = (cuda_build.CSRC / "policy_narrow.cuh").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))  # noqa: E731
    assert const("MAX_DEPTH") == cuda_sgd.MAX_DEPTH and const("MAX_WIDTH") == cuda_sgd.MAX_WIDTH
    assert const("MAX_OBS") == cuda_sgd.MAX_OBS_DIM and const("MAX_ACT") == cuda_sgd.MAX_ACT_DIM
    assert const("HEAD_PAD") == cuda_narrow.HEAD_PAD and const("WARPS") == cuda_narrow.WARPS
    assert 16 * cuda_narrow.WARPS == cuda_narrow.TILE_ROWS


def test_generalised_flop_counts():
    h, o, a = 256, 21, 4
    # the 2 x 256 formulas of PRs 2-10
    assert cuda_sgd.logp_flops(10, o, a) == 2 * 10 * (o * h + h * h + h * a)
    fwd = 2 * (o * h + h * h) + h * a + h
    dgrad = h * a + h * h + h + h * h
    assert cuda_sgd.epoch_flops(10, o, a) == 2 * 10 * (2 * fwd + dgrad)
    # the trajectory network, by hand: a trunk's forward, its data gradient
    t = (64, 64, 32, 32)
    pi_f = 19 * 64 + 64 * 64 + 64 * 32 + 32 * 32 + 32 * 4
    vf_f = 19 * 64 + 64 * 64 + 64 * 32 + 32 * 32 + 32 * 1
    assert cuda_sgd.trunk_macs(19, t, 4) == (pi_f, pi_f - 19 * 64)
    assert cuda_sgd.logp_flops(7, 19, 4, sizes=t) == 2 * 7 * pi_f
    assert cuda_sgd.epoch_flops(7, 19, 4, pi_sizes=t, vf_sizes=t) == 2 * 7 * (
        2 * (pi_f + vf_f) + (pi_f - 19 * 64) + (vf_f - 19 * 64))
    net = ActorCritic(19, 4, feature_sizes=(), pi_sizes=t, vf_sizes=t, device="cpu")
    assert cuda_policy.forward_flops(5, net.kernel_weights()) == 2 * 5 * (pi_f + vf_f)


# ---------------------------------------------------------------------------
# the fragments, lane by lane (PTX ISA: mma.m16n8k16 .bf16, ldmatrix .m8n8)
# ---------------------------------------------------------------------------


def _ldsm(buf: torch.Tensor, addr, trans: bool):
    """ldmatrix.x4 on a bf16 buffer (``buf`` float values, byte addresses
    per lane): (32 lanes, 4 registers, 2 halves)."""
    out = torch.zeros((32, 4, 2))
    for q in range(4):
        m = torch.stack([buf[addr[8 * q + j] // 2 : addr[8 * q + j] // 2 + 8] for j in range(8)])
        if trans:
            m = m.T
        for lane in range(32):
            out[lane, q] = m[lane >> 2, 2 * (lane & 3) : 2 * (lane & 3) + 2]
    return out


def _b_matrix(r0, r1):
    """B (16 x 8) from a lane's two registers: (k = 2t, 2t+1 | 2t+8, 2t+9; n = g)."""
    b = torch.zeros((16, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        b[2 * t : 2 * t + 2, g] = r0[lane]
        b[2 * t + 8 : 2 * t + 10, g] = r1[lane]
    return b


def _a_matrix(regs):
    """A (16 x 16) from a lane's four registers."""
    a = torch.zeros((16, 16))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        a[g, 2 * t : 2 * t + 2] = regs[lane, 0]
        a[g + 8, 2 * t : 2 * t + 2] = regs[lane, 1]
        a[g, 2 * t + 8 : 2 * t + 10] = regs[lane, 2]
        a[g + 8, 2 * t + 8 : 2 * t + 10] = regs[lane, 3]
    return a


def _lanes(fn):
    return [fn(lane >> 3, lane & 7) for lane in range(32)]


def test_accumulator_is_the_next_a_fragment():
    """``to_fragments``: registers (c0, c1), (c2, c3) of n8 tiles 2kc and
    2kc + 1 are A's (a0, a1) ... (a6, a7) of k16 chunk kc."""
    d = torch.arange(16 * 16, dtype=torch.float32).view(16, 16)
    regs = torch.zeros((32, 4, 2))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        acc = [[d[g, nt * 8 + 2 * t], d[g, nt * 8 + 2 * t + 1], d[g + 8, nt * 8 + 2 * t],
                d[g + 8, nt * 8 + 2 * t + 1]] for nt in (0, 1)]
        regs[lane] = torch.tensor([[acc[0][0], acc[0][1]], [acc[0][2], acc[0][3]],
                                   [acc[1][0], acc[1][1]], [acc[1][2], acc[1][3]]])
    assert torch.equal(_a_matrix(regs), d)


@pytest.mark.parametrize("sizes", [(64, 64, 32, 32), (48, 24), (128, 16)])
def test_ldmatrix_reads_of_the_image(sizes):
    """The forward's B (``layer_product``: Wt rows as B columns) and the
    backward's (``layer_product_t``: Wt read transposed) give W and W^T."""
    obs, outs = 19, 4
    w, b, hw, hb = _trunk(obs, sizes, outs, seed=len(sizes))
    image = cuda_narrow.pack_trunk(w, b, hw, hb)
    lay = cuda_narrow.layout(obs, sizes, outs)
    buf = image[: lay.b_off[0]].view(torch.bfloat16).float()
    for i, mat in enumerate([*w, hw]):
        k, n, stride = lay.k[i], lay.n[i], 2 * (lay.k[i] + 8)
        full = torch.zeros((k, n))
        full[: mat.shape[0], : mat.shape[1]] = mat.to(torch.bfloat16).float()
        got = torch.zeros((k, n))
        for np_ in range(n // 16):
            for kc in range(k // 16):
                r = _ldsm(buf, _lanes(lambda q, j: lay.w_off[i] + (np_ * 16 + (q >> 1) * 8 + j) * stride  # noqa: B023
                                      + (kc * 16 + (q & 1) * 8) * 2), trans=False)
                for h in (0, 1):
                    got[kc * 16 : kc * 16 + 16, (2 * np_ + h) * 8 : (2 * np_ + h) * 8 + 8] = _b_matrix(
                        r[:, 2 * h], r[:, 2 * h + 1])
        assert torch.equal(got, full)
        got_t = torch.zeros((n, k))  # B' = W^T: k' over the outputs, n' over the inputs
        for np_ in range(k // 16):
            for kc in range(n // 16):
                r = _ldsm(buf, _lanes(lambda q, j: lay.w_off[i] + (kc * 16 + (q & 1) * 8 + j) * stride  # noqa: B023
                                      + (np_ * 16 + (q >> 1) * 8) * 2), trans=True)
                for h in (0, 1):
                    got_t[kc * 16 : kc * 16 + 16, (2 * np_ + h) * 8 : (2 * np_ + h) * 8 + 8] = _b_matrix(
                        r[:, 2 * h], r[:, 2 * h + 1])
        assert torch.equal(got_t, full.T)


@pytest.mark.parametrize("kp,np_", [(32, 64), (64, 16), (128, 128), (16, 32)])
def test_weight_gradient_reads_of_the_staging_buffers(kp, np_):
    """``weight_grad``: A = the staged inputs transposed, B = the staged dz,
    both by ldmatrix .trans, over the tile's 64 rows: A^T dZ."""
    g = np.random.default_rng(kp + np_)
    act = torch.from_numpy(g.normal(size=(64, kp)).astype(np.float32)).to(torch.bfloat16).float()
    dz = torch.from_numpy(g.normal(size=(64, np_)).astype(np.float32)).to(torch.bfloat16).float()
    sa, sd = kp + 8, np_ + 8  # bf16 a staged row
    act_s = torch.zeros(64 * sa)
    act_s.view(64, sa)[:, :kp] = act
    dz_s = torch.zeros(64 * sd)
    dz_s.view(64, sd)[:, :np_] = dz
    got = torch.zeros((kp, np_))
    for mt in range(kp // 16):
        for kc in range(4):
            a = _a_matrix(_ldsm(act_s, _lanes(lambda q, j: (kc * 16 + (q >> 1) * 8 + j) * 2 * sa  # noqa: B023
                                              + (mt * 16 + (q & 1) * 8) * 2), trans=True))
            for n2 in range(np_ // 16):
                r = _ldsm(dz_s, _lanes(lambda q, j: (kc * 16 + (q & 1) * 8 + j) * 2 * sd  # noqa: B023
                                       + (n2 * 16 + (q >> 1) * 8) * 2), trans=True)
                for h in (0, 1):
                    got[mt * 16 : mt * 16 + 16, (2 * n2 + h) * 8 : (2 * n2 + h) * 8 + 8] += a @ _b_matrix(
                        r[:, 2 * h], r[:, 2 * h + 1])
    assert torch.allclose(got, act.T @ dz, rtol=1e-5, atol=1e-4)
