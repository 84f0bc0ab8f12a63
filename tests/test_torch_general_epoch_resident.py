"""K2g's resident route (``csrc/fused_epoch_general.cu``'s ``rep::`` kernels
on ``csrc/policy_resident.cuh``, ``ops/cuda_general.py``) on the CPU, torch
only: the images Adam and the image kernel write (a mirror of the kernels'
flat index -> image slot map) against ``cuda_general.pack_resident`` of the
leaves and of the transposed layers; the workspace (bf16 input and dz
tiles, the f32 tanh outputs, the column sums, the weight gradient's row
chunks); the route at its boundaries beside K4g's and K3g's; the kernel
counts of both routes; the C mirrors and the host constants against the
source.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from pyflyt_tpu_torch.ops import cuda_build, cuda_general, cuda_sgd

torch.set_num_threads(1)

T = torch.from_numpy
# the general family's trunk pairs held on the card (chip_smoke.GENERAL_PAIRS)
PAIRS = (((), ()), ((48,) * 6, (48,) * 6), ((160, 72), (160, 72)), ((256, 256), (32, 32)), ((256,), (256,)),
         ((256, 256, 256), (256, 256, 256)), ((512, 512), (512, 512)), ((256, 256, 64), (256, 256, 64)))
PAIR_IDS = ["linear", "six48", "160-72", "2x256-32-32", "256", "3x256", "2x512", "256-256-64"]
WIDTHS = ((21, 4), (72, 10))
SOURCE = cuda_build.CSRC / "fused_epoch_general.cu"
HEADER = cuda_build.CSRC / "policy_resident.cuh"


def _cfg(obs, act, pi, vf, log_std_range=None):
    return cuda_sgd.EpochConfig(obs, act, pi, vf, learning_rate=1e-3, clip_eps=0.2, entropy_coef=0.01,
                                value_coef=0.5, max_grad_norm=0.5, log_std_range=log_std_range)


def _flat(cfg, seed):
    """Random leaves in ``leaf_specs`` order and their flat vector."""
    rng = np.random.default_rng(seed)
    net = dict(obs_dim=cfg.obs_dim, act_dim=cfg.act_dim, pi_sizes=cfg.pi_sizes, vf_sizes=cfg.vf_sizes)
    shapes = [s for _, s in cuda_sgd.leaf_specs(net)]
    leaves = [T(rng.normal(size=s).astype(np.float32) * 0.3) for s in shapes]
    offsets, P = cuda_sgd.flat_layout(shapes)
    return leaves, cuda_sgd._to_flat(leaves, offsets, P)


def _write_images(params, cfg, lays):
    """``rep::write_images`` of every flat parameter (the image kernel's
    pass; Adam's on its updated values): a weight's bf16 at
    ``resident_offset(unit, input)`` of its layer in the forward image and,
    but for the first layer's, at ``(input, unit)`` of its transposed layer
    in the backward one; a bias f32 in the forward image."""
    pi, vf, _ = cuda_general.leaf_trunks(cfg)
    images = [torch.zeros(im.bytes if im is not None else 16, dtype=torch.uint8)
              for lay in lays for im in (lay.fwd, lay.bwd)]
    for t, (trunk, lay) in enumerate(zip((pi, vf), lays)):
        F, B = lay.fwd, lay.bwd
        for l in range(F.layers):
            k, n = trunk.dims[l], trunk.dims[l + 1]
            e = torch.arange(k * n)
            kk, nn = e // n, e % n
            w = params[trunk.w[l] + e].to(torch.bfloat16).view(torch.int16)
            images[2 * t].view(torch.int16)[(F.w[l] + cuda_general.resident_offset(nn, kk, F.k[l], F.n[l])) // 2] = w
            if l > 0:
                j = lay.depth - l
                slot = B.w[j] + cuda_general.resident_offset(kk, nn, B.k[j], B.n[j])
                images[2 * t + 1].view(torch.int16)[slot // 2] = w
            images[2 * t][F.b[l] : F.b[l] + 4 * n].view(torch.float32)[:] = params[trunk.b[l] : trunk.b[l] + n]
    return images


def _trunk_leaves(leaves, cfg):
    """(matrices, biases) of the actor (head last) and of the critic."""
    n_pi, n_vf = len(cfg.pi_sizes), len(cfg.vf_sizes)
    pi = leaves[: 2 * n_pi + 2]
    vf = leaves[2 * n_pi + 3 : 2 * n_pi + 3 + 2 * n_vf + 2]
    return [(list(tr[0::2]), list(tr[1::2])) for tr in (pi, vf)]


@pytest.mark.parametrize("obs,act", WIDTHS, ids=["obs21-act4", "obs72-act10"])
@pytest.mark.parametrize("pi,vf", PAIRS, ids=PAIR_IDS)
def test_the_images_adam_writes_are_pack_resident(pi, vf, obs, act):
    """Each trunk's forward image, written from the flat parameters, is
    ``pack_resident`` of its leaves (K4g's and K3g's image, so K2g's
    forward reads the same bf16 weights); its backward image is
    ``pack_resident`` of ``W_L^T .. W_1^T`` with zero biases, laid out as
    ``epoch_layouts`` says (none for a linear trunk); padding stays 0."""
    cfg = _cfg(obs, act, pi, vf)
    leaves, params = _flat(cfg, obs + act + len(pi))
    lays = cuda_general.epoch_layouts(obs, act, pi, vf)
    images = _write_images(params, cfg, lays)
    for t, ((mats, biases), lay) in enumerate(zip(_trunk_leaves(leaves, cfg), lays)):
        assert torch.equal(images[2 * t], cuda_general.pack_resident(mats[:-1], biases[:-1], mats[-1], biases[-1]))
        if lay.bwd is None:
            assert len(mats) == 1 and not images[2 * t + 1].any()
            continue
        back = [m.T for m in reversed(mats[1:])]
        zeros = [torch.zeros(m.shape[1]) for m in back]
        assert lay.bwd == cuda_general.resident_layout(back[0].shape[0], [m.shape[1] for m in back[:-1]],
                                                       back[-1].shape[1])
        assert lay.bwd.dims == tuple(reversed(lay.fwd.dims[1:]))
        assert torch.equal(images[2 * t + 1], cuda_general.pack_resident(back[:-1], zeros[:-1], back[-1], zeros[-1]))
        for j in range(lay.bwd.layers):  # backward layer j is forward layer L - j, transposed
            l = lay.depth - j
            assert (lay.bwd.k[j], lay.bwd.n[j]) == (lay.fwd.n[l], lay.fwd.k[l])


@pytest.mark.parametrize("mb,pair", [(8192, 5), (1000, 2), (64, 0), (4093, 6), (129, 3)])
def test_the_workspace_layout(mb, pair):
    """Per trunk and layer: the bf16 input tiles (rows x fwd.k), the bf16
    dz tiles (rows x fwd.n), a tanh layer's f32 outputs (rows x fwd.n; the
    head none) lie back to back, 16- and 8-byte aligned, without overlap;
    each layer's column sums its own columns of a colsum row; the weight
    gradient's chunks of rows cover the padded rows, each a multiple of 32
    rows, none empty."""
    pi, vf = PAIRS[pair]
    lays = cuda_general.epoch_layouts(72, 10, pi, vf)
    tile = cuda_general.epoch_tile(lays, 10)
    ws = cuda_general.resident_workspace(mb, tile, lays, sms=132)
    assert ws.tile == tile and ws.tiles == -(-mb // tile) and ws.rows == ws.tiles * tile
    for name, total, width in (("act", ws.acts, "k"), ("dz", ws.dzs, "n"), ("fac", ws.factor, "n")):
        regions = []
        for t, lay in enumerate(lays):
            for l in range(lay.fwd.layers):
                if name == "fac" and l == lay.depth:
                    assert ws.fac[t][l] == 0  # the head: no tanh
                    continue
                off = getattr(ws, name)[t][l]
                assert off % (2 if name == "fac" else 8) == 0
                regions.append((off, off + ws.rows * getattr(lay.fwd, width)[l]))
        regions.sort()
        assert all(a[1] == b[0] for a, b in zip(regions, regions[1:]))
        assert (regions[0][0] if regions else 0) == 0 and (regions[-1][1] if regions else 0) <= total
    for t, lay in enumerate(lays):
        cols = [(ws.cs[t][l], ws.cs[t][l] + lay.fwd.n[l]) for l in range(lay.fwd.layers)]
        assert cols[0][0] == 0 and all(a[1] == b[0] for a, b in zip(cols, cols[1:])) and cols[-1][1] <= ws.cs_width
    assert ws.split_rows % cuda_general.EPOCH_WG_BK == 0
    assert (ws.splits - 1) * ws.split_rows < ws.rows <= ws.splits * ws.split_rows
    jobs = cuda_general.wgrad_jobs(lays)
    assert jobs == sum(-(-k // 128) * -(-n // 128) for lay in lays for k, n in zip(lay.fwd.k, lay.fwd.n))
    assert jobs * ws.splits <= 2 * cuda_general.EPOCH_WG_WAVES * 132 or ws.splits == 1


@pytest.mark.parametrize("width,act,tile", [
    (256, 4, 128), (288, 4, 128), (320, 4, 64), (512, 4, 64), (576, 4, 64), (608, 4, None), (1024, 4, None),
    (288, 64, 64), (256, 127, 64), (256, 128, None)])
def test_the_route_at_its_boundaries(width, act, tile):
    """One tanh layer of ``width`` units a trunk (obs 21): 128 rows a block
    while the activation buffers, the staged head and the per-warp sums fit
    beside the ring, then 64, then the per-layer route; at most 127
    actions (the loss's 2 + 2 act sums, a thread each). Where K2g is
    resident, K4g and K3g are too, with tiles no smaller; past it they may
    still be: every route gives the same forward bits."""
    cfg = _cfg(21, act, (width,), (width,))
    lays = cuda_general.epoch_layouts(21, act, (width,), (width,))
    assert cuda_general.epoch_tile(lays, act) == tile
    assert cuda_general.epoch_route(cfg) == ("resident" if tile else "per_layer")
    k4g = cuda_general.resident_tile((lays[0].fwd, lays[1].fwd), act)
    k3g = cuda_general.resident_tile((lays[0].fwd,), act, True)
    if tile is not None:
        assert k4g is not None and k3g is not None and k4g >= tile and k3g >= tile
    for t in cuda_general.RES_TILES:
        fits = cuda_general.epoch_smem(t, cuda_general.epoch_width(lays), act) <= cuda_general.RES_SMEM_LIMIT
        assert fits == (tile is not None and t <= tile) or act > 127


def test_the_route_by_depth_and_pair():
    """Every GENERAL_PAIRS pair at both widths takes the resident route, the
    (1024,) pair the per-layer one; at most RES_MAX_LAYERS layers a trunk
    (the head included)."""
    for pi, vf in PAIRS:
        for obs, act in WIDTHS:
            assert cuda_general.epoch_route(_cfg(obs, act, pi, vf)) == "resident", (pi, vf, obs, act)
    assert cuda_general.epoch_route(_cfg(21, 4, (1024,), (1024,))) == "per_layer"
    deep = (64,) * (cuda_general.RES_MAX_LAYERS - 1)
    assert cuda_general.epoch_route(_cfg(21, 4, deep, (64,))) == "resident"
    assert cuda_general.epoch_route(_cfg(21, 4, (64,), deep + (64,))) == "per_layer"


def test_the_kernel_counts():
    """Four kernels a minibatch and one a call on the resident route, at any
    depth; 3 (depth_pi + depth_vf) + 7 and two (the obs rounded to bf16,
    the first image) per layer."""
    for d in (0, 1, 3, 15):
        assert cuda_general.kernels_per_minibatch(d, d, "resident") == 4
        assert cuda_general.kernels_per_minibatch(d, d, "per_layer") == 3 * 2 * d + 7
    assert cuda_general.kernels_per_minibatch(3, 3) == 25
    assert cuda_general.kernels_per_call("resident") == 1 and cuda_general.kernels_per_call("per_layer") == 2


def _constant(name: str) -> int:
    for path in (SOURCE, HEADER):
        m = re.search(rf"constexpr int {name} = (\d+);", path.read_text())
        if m:
            return int(m.group(1))
    raise KeyError(name)


def _c_struct(name: str) -> list[tuple[str, str, int]]:
    """(type, field, count) of ``struct <name>`` in the source, comments
    out; an array's count a number or a ``constexpr int`` of the source or
    the header."""
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", SOURCE.read_text(), re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            typ, field, count = re.match(r"(.*?\W)(\w+)(?:\[([\w:]+)\])?$", decl).groups()
            n = 1 if count is None else int(count) if count.isdigit() else _constant(count.split("::")[-1])
            out.append((typ.replace(" ", ""), field, n))
    return out


@pytest.mark.parametrize("struct,mirror", [("EpochTrunk", cuda_general._EpochTrunkC),
                                           ("ResidentEpochArgs", cuda_general._ResidentEpochArgsC)])
def test_the_c_mirrors_are_the_sources_structs(struct, mirror):
    """Each ctypes mirror holds the C struct's fields in order, with the C
    type's size (an array's: its count times it)."""
    size = {"int": 4, "float": 4, "longlong": 8, "ResidentTrunk": ctypes.sizeof(cuda_general._ResidentTrunkC),
            "EpochTrunk": ctypes.sizeof(cuda_general._EpochTrunkC)}
    fields = _c_struct(struct)
    assert [f for _, f, _ in fields] == [f for f, _ in mirror._fields_]
    for (typ, _, count), (_, ctype) in zip(fields, mirror._fields_):
        assert ctypes.sizeof(ctype) == count * (8 if "*" in typ else size[typ.replace("const", "")]), typ


def test_the_host_constants_are_the_sources():
    """The weight gradient's tile and stage, the dims' count, the loss's
    sums bound and the shared-memory sum are the source's."""
    text = SOURCE.read_text()
    assert re.search(r"constexpr int WG_BM = (\d+), WG_BN = (\d+), WG_BK = (\d+);", text).groups() == (
        str(cuda_general.EPOCH_WG_BM), str(cuda_general.EPOCH_WG_BM), str(cuda_general.EPOCH_WG_BK))
    assert _constant("MAX_DIMS") == cuda_general.RES_MAX_LAYERS + 1
    assert "rep::loss_sums(p.act_dim) > resident::Warps<64>::THREADS" in text
    assert cuda_general.EPOCH_MAX_LOSS_SUMS == 64 // 32 * (cuda_general.RES_NC // cuda_general.RES_WN) * 32
    assert "tile / 32 * (width > 2 + 2 * act_dim ? width : 2 + 2 * act_dim)" in text
    ring = cuda_general.RES_STAGES * cuda_general.RES_STAGE_BYTES
    assert cuda_general.epoch_smem(128, 256, 4) == ring + 2 * 128 * 264 * 2 + 2 * 256 * 4 + 128 * 5 * 4 + \
        4 * 256 * 4 + 64
    assert cuda_general.epoch_smem(64, 512, 10) == ring + 2 * 64 * 520 * 2 + 2 * 512 * 4 + 64 * 11 * 4 + \
        2 * 512 * 4 + 64
    assert cuda_general.epoch_smem(64, 96, 60) == ring + 2 * 64 * 104 * 2 + 2 * 96 * 4 + 64 * 61 * 4 + \
        2 * 122 * 4 + 64


def test_the_launch_arguments():
    """``resident_epoch_args``: each trunk's real widths, leaf offsets,
    workspace offsets and both images' layouts, zero past its layers; a
    linear trunk's backward image of no layer."""
    cfg = _cfg(72, 10, (160, 72), ())
    lays = cuda_general.epoch_layouts(72, 10, cfg.pi_sizes, cfg.vf_sizes)
    ws = cuda_general.resident_workspace(1000, cuda_general.epoch_tile(lays, 10), lays, sms=132)
    pi, vf, ls_off = cuda_general.leaf_trunks(cfg)
    bufs = {name: torch.zeros(4) for name in ("mbs", "adv_stats", "t0", "params", "mu", "nu", "metrics", "acts",
                                              "dzs", "factor", "colsum", "part", "slab", "grad", "block_sq")}
    bufs["images"] = [torch.zeros(16, dtype=torch.uint8) for _ in range(4)]
    args = cuda_general.resident_epoch_args(bufs, cfg, 2, 1000, 85, 999, ls_off, (pi, vf), lays, ws)
    a, c = args.trunk[0], args.trunk[1]
    assert list(a.dims)[:4] == [72, 160, 72, 10] and list(a.dims)[4:] == [0] * 13 and list(c.dims)[:2] == [72, 1]
    assert list(a.w_off)[:3] == list(pi.w) and list(c.b_off)[:1] == list(vf.b) and args.ls_off == ls_off
    assert a.fwd.layers == 3 and a.bwd.layers == 2 and c.fwd.layers == 1 and c.bwd.layers == 0
    assert list(a.bwd.k)[:2] == [32, 96] and list(a.bwd.n)[:2] == [96, 160]
    assert list(a.act)[:3] == list(ws.act[0]) and list(c.dz)[:1] == list(ws.dz[1]) and list(a.cs)[:3] == [0, 160, 256]
    assert (args.tile, args.width, args.splits, args.split_rows) == (128, 160, ws.splits, ws.split_rows)
    assert (args.mb, args.feat, args.P, args.act_dim) == (1000, 85, 999, 10)
