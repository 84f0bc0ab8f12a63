"""The general family's per-layer GEMM (``csrc/policy_general.cuh`` on
``csrc/gemm_sm90.cuh``; ``ops/cuda_general.py``) on the CPU, torch only:
the bf16 operand buffers' offsets, padding and alignment (K4g's and K3g's
image and workspace, K2g's workspace, image and slot map); each operand
mode's stage as a TMA box with the 128-byte swizzle lands it and as the
wgmma descriptors of the kernel read it back, emulated byte for byte and
run through the kernel's tile, stage and k16 schedule against the plain
product; the weight gradient's split plan and its chunk-order sum against
the twin's gradient; the C mirrors and the header constants; the kernel
counts.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from pyflyt_tpu_torch.ops import cuda_build, cuda_general, cuda_sgd

torch.set_num_threads(1)

T = torch.from_numpy
HEADER = cuda_build.CSRC / "policy_general.cuh"
PTX = cuda_build.CSRC / "gemm_sm90.cuh"
EPOCH = cuda_build.CSRC / "fused_epoch_general.cu"
BM, BN, BK = cuda_general.BM, cuda_general.BN, cuda_general.BK
LBO, SBO = 8192, 1024  # gemm_sm90.cuh's MN_LBO, MN_SBO


def _cfg(obs, act, pi, vf):
    return cuda_sgd.EpochConfig(obs, act, pi, vf, learning_rate=1e-3, clip_eps=0.2, entropy_coef=0.01,
                                value_coef=0.5, max_grad_norm=0.5)


def _pad(x: int) -> int:
    return -(-x // 32) * 32


# ---------------------------------------------------------------------------
# the operand buffers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("obs,act,pi,vf", [(21, 4, (1024, 1024), (1024, 1024)), (72, 10, (48,) * 6, (160, 72)),
                                           (21, 4, (), ()), (33, 1, (4128,), (100, 3))])
def test_the_operand_buffers_are_padded_and_aligned(obs, act, pi, vf):
    """K2g's workspace: every bf16 region (a tanh layer's outputs, a W of
    the image) at a multiple of 128 bytes, row strides padded to 32, the
    regions apart; the slot map sends each weight W_l[k, n] to
    ``img[l] + k pad32(out) + n`` and each bias to its colsum column; the
    images Adam and the image kernel write through it hold W bf16 with
    zeros past every width."""
    cfg = _cfg(obs, act, pi, vf)
    trunks = cuda_general.leaf_trunks(cfg)[:2]
    mb = 100
    ws = cuda_general.epoch_workspace(mb, *trunks)
    assert all(o % 64 == 0 for offs in (*ws.act, *ws.img) for o in offs)
    assert ws.dz_width == max(_pad(d) for t in trunks for d in t.dims[1:]) and ws.dz_width % 8 == 0
    regions = sorted((o, o + k * _pad(n)) for t, img in zip(trunks, ws.img)
                     for o, k, n in zip(img, t.dims[:-1], t.dims[1:]))
    assert all(a[1] <= b[0] for a, b in zip(regions, regions[1:])) and regions[-1][1] <= ws.image
    slot = cuda_general.epoch_slots(cfg, "cpu")
    _, P = cuda_sgd.flat_layout([s for _, s in cuda_sgd.leaf_specs(
        dict(obs_dim=obs, act_dim=act, pi_sizes=pi, vf_sizes=vf))])
    assert slot.dtype == torch.int32 and slot.shape == (P,)
    rng = np.random.default_rng(1)
    params = T(rng.normal(size=P).astype(np.float32))
    image = torch.zeros(ws.image, dtype=torch.bfloat16)
    weights = slot >= 0
    image[slot[weights].long()] = params[weights].to(torch.bfloat16)  # image_kernel and adam_kernel
    assert int(weights.sum()) == sum(k * n for t in trunks for k, n in zip(t.dims[:-1], t.dims[1:]))
    covered = torch.zeros(ws.image, dtype=torch.bool)
    for i, t in enumerate(trunks):
        for l, (k, n) in enumerate(zip(t.dims[:-1], t.dims[1:])):
            w = params[t.w[l] : t.w[l] + k * n].view(k, n)
            rows = image[ws.img[i][l] : ws.img[i][l] + k * _pad(n)].view(k, _pad(n))
            assert torch.equal(rows[:, :n], w.to(torch.bfloat16)) and not rows[:, n:].float().any()
            covered[ws.img[i][l] : ws.img[i][l] + k * _pad(n)] = True
            cols = -2 - slot[t.b[l] : t.b[l] + n].long()
            assert torch.equal(cols, ws.cs[i][l] + torch.arange(n))
    assert not image[~covered].float().any()
    assert set(slot[~weights].tolist()) <= {-1, *range(-2 - ws.cs_width + 1, -1)}
    assert int((slot <= -2).sum()) == sum(t.dims[-1] + sum(t.dims[1:-1]) for t in trunks) == ws.cs_width


def test_k4g_and_k3g_read_the_image_and_the_rounded_obs():
    """``pack_trunk``: each W bf16 (nearest even) in rows of pad32(out)
    with zeros past ``out``, the f32 biases, every region 128-byte aligned;
    ``forward_outputs``: the rounded obs first, then two buffers of the
    widest padded tanh layer, in turn, at multiples of 8 elements."""
    rng = np.random.default_rng(0)
    dims = (21, 1000, 40, 4)
    mats = [T(rng.normal(size=(k, n)).astype(np.float32)) for k, n in zip(dims[:-1], dims[1:])]
    biases = [T(rng.normal(size=(n,)).astype(np.float32)) for n in dims[1:]]
    image = cuda_general.pack_trunk(mats[:-1], biases[:-1], mats[-1], biases[-1])
    lay, nbytes = cuda_general.layout(dims[0], dims[1:-1], dims[-1])
    assert image.shape == (nbytes,) and nbytes % 128 == 0
    for l, (m, b) in enumerate(zip(mats, biases)):
        k, n = m.shape
        assert lay.w[l] % 128 == 0 and lay.b[l] % 128 == 0
        rows = image[lay.w[l] : lay.w[l] + 2 * k * _pad(n)].view(torch.bfloat16).view(k, _pad(n))
        assert torch.equal(rows[:, :n], m.to(torch.bfloat16)) and not rows[:, n:].float().any()
        assert torch.equal(image[lay.b[l] : lay.b[l] + 4 * n].view(torch.float32), b)
    ends = sorted([(w, w + 2 * k * _pad(n)) for w, k, n in zip(lay.w, dims[:-1], dims[1:])] +
                  [(b, b + 4 * n) for b, n in zip(lay.b, dims[1:])])
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:])) and ends[-1][1] <= nbytes
    (outs,), elems = cuda_general.forward_outputs(7, 21, lay)
    assert outs == (7 * 32, 7 * 32 + 7 * 1024, 0) and elems == 7 * 32 + 2 * 7 * 1024
    assert all(o % 8 == 0 for o in outs)


# ---------------------------------------------------------------------------
# the stages and descriptors, emulated
# ---------------------------------------------------------------------------


def _swizzle(addr: torch.Tensor) -> torch.Tensor:
    """The 128-byte swizzle on a byte address (1024-byte aligned atoms): the
    16-byte group bits 4-6 XOR the row bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _box(op: torch.Tensor, extent: tuple, c_inner: int, c_row: int, rows: int) -> torch.Tensor:
    """A TMA box of 64 x ``rows`` bf16 from ``op`` (rows x inner, the
    tensor's ``extent`` (inner, rows); zeros past it), as the 128-byte
    swizzle lands it: ``rows`` x 64 elements, element (r, c) at byte r 128 +
    c 2, swizzled."""
    r, c = torch.meshgrid(torch.arange(rows), torch.arange(64), indexing="ij")
    src_r, src_c = c_row + r, c_inner + c
    inside = (src_r < extent[1]) & (src_c < extent[0])
    vals = torch.where(inside, op[src_r.clamp(max=op.shape[0] - 1), src_c.clamp(max=op.shape[1] - 1)],
                       torch.zeros((), dtype=op.dtype))
    out = torch.zeros(rows * 64, dtype=op.dtype)
    out[_swizzle(r * 128 + c * 2) // 2] = vals
    return out


def _k_read(stage: torch.Tensor, start: int, rows: int) -> torch.Tensor:
    """What a K-major descriptor (k_desc: 8-row groups SBO apart) at byte
    ``start`` reads: rows x 16, element (r, c) at start + (r / 8) SBO + (r %
    8) 128 + 2 c, swizzled."""
    r, c = torch.meshgrid(torch.arange(rows), torch.arange(16), indexing="ij")
    return stage[_swizzle(start + (r // 8) * SBO + (r % 8) * 128 + 2 * c) // 2]


def _mn_read(stage: torch.Tensor, start: int, cols: int) -> torch.Tensor:
    """What an MN-major descriptor (mn_desc: 64-wide atoms LBO apart, 8-row
    k groups SBO apart) at byte ``start`` reads: 16 x cols, element (k, j)
    at start + (j / 64) LBO + (k / 8) SBO + (k % 8) 128 + 2 (j % 64),
    swizzled."""
    k, j = torch.meshgrid(torch.arange(16), torch.arange(cols), indexing="ij")
    return stage[_swizzle(start + (j // 64) * LBO + (k // 8) * SBO + (k % 8) * 128 + 2 * (j % 64)) // 2]


def _emulate(a_op, a_ext, b_op, b_ext, ta: int, tb: int, m: int, n: int, k: int, k_split: int, splits: int):
    """The kernel's schedule on the emulated stages: per tile (z, m0, n0) and
    k block, the producer's boxes at their coordinates, each consumer
    warpgroup's k16 steps (min(BK, k1 - kb) / 16 of them) through the
    descriptors the kernel builds; each chunk's float64 partial (splits, m,
    n). ``a_op`` is A (m x k) or, with ``ta``, A^T (k x m) as stored; ``b_op``
    B^T (n x k) or, with ``tb``, B (k x n)."""
    out = torch.zeros((splits, -(-m // BM) * BM, -(-n // BN) * BN), dtype=torch.float64)
    kpad = _pad(k)
    for z in range(splits):
        for m0 in range(0, m, BM):
            for n0 in range(0, n, BN):
                for kb in range(z * k_split, min(kpad, (z + 1) * k_split), BK):
                    if ta:  # two MN-major boxes of 64 m x 64 k, 8192 bytes apart
                        sa = torch.cat([_box(a_op, a_ext, m0 + 64 * i, kb, 64) for i in range(2)])
                    else:  # one K-major box of 64 k x BM rows
                        sa = _box(a_op, a_ext, kb, m0, BM)
                    if tb:
                        sb = torch.cat([_box(b_op, b_ext, n0 + 64 * i, kb, 64) for i in range(2)])
                    else:
                        sb = _box(b_op, b_ext, kb, n0, BN)
                    steps = min(BK, min(kpad, (z + 1) * k_split) - kb) // 16
                    for wg in range(2):
                        for st in range(steps):
                            da = (_mn_read(sa, wg * 8192 + st * 2048, 64).T if ta
                                  else _k_read(sa, wg * 8192 + 32 * st, 64))
                            db = _mn_read(sb, st * 2048, BN) if tb else _k_read(sb, 32 * st, BN).T
                            out[z, m0 + 64 * wg : m0 + 64 * wg + 64, n0 : n0 + BN] += da.double() @ db.double()
    return out[:, :m, :n]


def _source_has(*snippets):
    text = HEADER.read_text()
    for s in snippets:
        assert s in text, s


@pytest.mark.parametrize("mode,m,n,k", [("forward", 150, 70, 21), ("forward", 130, 200, 200),
                                        ("data_gradient", 140, 100, 4), ("data_gradient", 64, 72, 150),
                                        ("weight_gradient", 72, 10, 300), ("weight_gradient", 21, 140, 130)])
def test_each_operand_mode_through_its_stages_is_the_product(mode, m, n, k):
    """Each mode as the kernel runs it: A and B stored as the route stores
    them (bf16, rows padded to 32), the TMA boxes at the producer's
    coordinates (zeros past the real extents), the wgmma descriptors of the
    consumers (the source's own offsets), the k16 steps of each stage: the
    product, whole or as the weight gradient's chunk partials summed."""
    _source_has("sm90::mn_desc(sa + wg * 8192 + st * 2048) : sm90::k_desc(sa + wg * 8192 + 32 * st)",
                "sm90::mn_desc(sb + st * 2048) : sm90::k_desc(sb + 32 * st)",
                "sm90::tma_load(sa + 8192, &g.a, bar, m0 + 64, kb, g.a_z)",
                "sm90::tma_load(sb + 8192, &g.b, bar, n0 + 64, kb, 0)",
                "sm90::tma_load(sa, &g.a, bar, kb, m0, g.a_z)", "sm90::tma_load(sb, &g.b, bar, kb, n0, 0)")
    rng = np.random.default_rng(m + n + k)
    a = T(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    b = T(rng.normal(size=(k, n)).astype(np.float32)).to(torch.bfloat16)
    garbage = lambda r, c: T(rng.normal(size=(r, c)).astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    # stored with their row strides padded to 32, garbage past the real width
    # (the maps' extents keep it out)
    if mode == "forward":  # a layer's input (rows x k), the image's W (k x n)
        a_op, b_op, ta, tb = torch.cat([a, garbage(m, _pad(k) - k)], 1), torch.cat([b, garbage(k, _pad(n) - n)], 1), 0, 1
        a_ext, b_ext = (k, m), (n, k)
    elif mode == "data_gradient":  # dz (rows x k), the image's W (n x k) read as B^T
        a_op, b_op, ta, tb = torch.cat([a, garbage(m, _pad(k) - k)], 1), torch.cat([b.T, garbage(n, _pad(k) - k)], 1), 0, 0
        a_ext, b_ext = (k, m), (k, n)
    else:  # a layer's input (rows x m) read as A^T, dz (rows x n)
        a_op, b_op, ta, tb = torch.cat([a.T, garbage(k, _pad(m) - m)], 1), torch.cat([b, garbage(k, _pad(n) - n)], 1), 1, 1
        a_ext, b_ext = (m, k), (n, k)
    if mode == "weight_gradient":
        splits, rows = cuda_general.wgrad_plan(k, (-(-m // BM) * -(-n // BN),), 4)
    else:
        splits, rows = 1, _pad(k)
    got = _emulate(a_op, a_ext, b_op, b_ext, ta, tb, m, n, k, rows, splits)
    want = a.double() @ b.double()
    assert splits >= 1 and (splits == 1 or mode == "weight_gradient")
    assert torch.allclose(got.sum(0), want, rtol=1e-12, atol=1e-12)


def test_the_obs_planes_read_one_minibatch_and_zeros_past_it():
    """K2g's obs map is 3-D (pad32(obs), mb, n_mb): a box at plane m reads
    minibatch m's rows and zeros past its mb rows, never the next one's."""
    n_mb, mb, obs = 3, 100, 21
    rng = np.random.default_rng(3)
    rows = T(rng.normal(size=(n_mb, mb, _pad(obs))).astype(np.float32)).to(torch.bfloat16)
    for plane in range(n_mb):
        box = _box(rows[plane], (obs, mb), 0, 64, 128)
        read = torch.cat([_k_read(box, wg * 8192 + 32 * st, 64) for st in range(2) for wg in range(2)])
        got = torch.cat([_k_read(box, wg * 8192, 64) for wg in range(2)])  # k 0..15 of the 128 rows
        want = torch.zeros(128, 16, dtype=torch.bfloat16)
        want[: mb - 64] = rows[plane, 64:, :16]
        assert torch.equal(got, want) and read.shape == (256, 16)


@pytest.mark.parametrize("rows,tiles,sms,P,want", [
    (8192, (8, 64, 8, 8, 64, 8), 132, 2_149_385, (6, 1408)),  # 2 x 1024: the slab's cost stops at 6
    (8192, (8, 64, 8, 8, 64, 8), 132, 0, (16, 512)), (1024, (8, 8, 8, 8), 132, 53_000, (16, 64)),
    (1000, (8, 8, 8, 8), 132, 53_000, (16, 64)), (100, (1,), 132, 0, (2, 64)), (8192, (1,), 1, 0, (1, 8192)),
    (262_144, (64,), 132, 0, (33, 8000))])
def test_the_weight_gradient_split_plan(rows, tiles, sms, P, want):
    """Chunks of whole 64-row blocks covering the rows, one split for every
    layer, chosen by the layers' persistent rounds times a chunk's blocks
    plus their fill, and the slab's floats."""
    splits, per = cuda_general.wgrad_plan(rows, tiles, sms, P)
    assert (splits, per) == want and per % BK == 0 and splits * per >= _pad(rows) > (splits - 1) * per


def test_the_chunk_order_gradient_sum_is_the_twins_gradient():
    """A layer's weight gradient as the route sums it (each chunk's partial
    in f32 from the bf16 input and dz, the partials in chunk order) against
    the twin's (the whole minibatch's product of the same bf16 values), at
    GENERAL_MU_REL of its largest; the bias gradient as the tiles' f32
    column sums in tile order."""
    rng = np.random.default_rng(5)
    mb, k, n = 1000, 48, 72
    x = T(rng.normal(size=(mb, k)).astype(np.float32))
    dz = T((rng.normal(size=(mb, n)) * np.exp(rng.normal(size=(1, n)))).astype(np.float32))
    xb, dzb = x.to(torch.bfloat16).float(), dz.to(torch.bfloat16).float()
    splits, per = cuda_general.wgrad_plan(mb, (1,), 132)
    parts = [xb[z * per : (z + 1) * per].T @ dzb[z * per : (z + 1) * per] for z in range(splits)]
    got = torch.zeros(k, n)
    for p in parts:
        got = got + p
    want = xb.T @ dzb
    assert splits > 1 and float((got - want).abs().max() / want.abs().max()) <= 2.5e-3
    tiles = [dz[t : t + BM].sum(0) for t in range(0, mb, BM)]
    bias = torch.zeros(n)
    for s in tiles:
        bias = bias + s
    assert torch.allclose(bias, dz.sum(0), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the sources
# ---------------------------------------------------------------------------


def test_the_header_constants_and_the_mirror():
    text = HEADER.read_text()
    assert re.search(r"constexpr int BM = (\d+), BN = (\d+), BK = (\d+);", text).groups() == tuple(
        str(v) for v in (BM, BN, BK))
    for name, value in (("STAGES", cuda_general.GEMM_STAGES), ("THREADS", cuda_general.GEMM_THREADS),
                        ("KPAD", cuda_general.KPAD)):
        assert f"constexpr int {name} = {value};" in text
    ptx = PTX.read_text()
    assert f"constexpr uint32_t MN_LBO = {LBO};" in ptx and f"constexpr uint32_t MN_SBO = {SBO};" in ptx
    epoch = EPOCH.read_text()
    assert f"constexpr int CRITIC_LD = {cuda_general.CRITIC_LD};" in epoch
    body = re.search(r"struct GeneralEpochTrunk \{(.*?)\n\};", epoch, re.S).group(1)
    fields = re.findall(r"^\s*(?:const )?(\w+(?: \w+)*\*?) (\w+);", body, re.M)
    assert [f for _, f in fields] == [f for f, _ in cuda_general._GeneralEpochTrunkC._fields_]
    for (typ, _), (_, ctype) in zip(fields, cuda_general._GeneralEpochTrunkC._fields_):
        assert ctypes.sizeof(ctype) == (8 if typ.endswith("*") else 4)
    # the mma.sync GEMM and its f32-operand loader are gone
    assert "struct Operand {\n  const __nv_bfloat16* base;" in text and "float4 v[RUNS]" not in text
    assert "wgmma.mma_async" not in text and "Wgmma<BN, TA, TB>::mma" in text


def test_the_kernel_counts():
    """Per minibatch a forward GEMM a layer (heads included), the loss, a
    weight-gradient GEMM a layer and a data-gradient GEMM a layer but the
    first, the reduce and Adam; per call the obs rounded and the image."""
    for d in (0, 2, 3, 17):
        assert cuda_general.kernels_per_minibatch(d, d) == 3 * 2 * d + 7
        assert cuda_general.kernels_per_minibatch(d, 1) == 3 * (d + 1) + 7
    assert cuda_general.kernels_per_call("per_layer") == 2
