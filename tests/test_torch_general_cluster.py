"""The general family's cluster route (K4g and K3g on
``csrc/policy_cluster.cuh``, ``ops/cuda_general.py``) on the CPU, torch
only: the route at its boundaries (block, cluster, per layer; the tile and
the cluster's size); the cluster's shared memory against the headers'
constants; the activation buffers' k-block layout; the C entry points and the launch arguments against the
sources; the wrappers refusing what the kernel does not take; and the
kernel's schedule, emulated rank by rank on the unchanged resident image
(which rank owns which chunk, warp 0's walk over a rank's weight blocks,
each k range read from the rank that owns it, in k order), against the
twins and bit for bit against the same schedule on one block.
"""

import re

import numpy as np
import pytest
import torch

from pyflyt_tpu_torch.ops import cuda_build, cuda_general, cuda_policy, cuda_sgd
from pyflyt_tpu_torch.rl.networks import ActorCritic

torch.set_num_threads(1)

T = torch.from_numpy
NC, KC = cuda_general.RES_NC, cuda_general.RES_KC
CLUSTER_HEADER = cuda_build.CSRC / "policy_cluster.cuh"
ENTRIES = cuda_build.CSRC / "policy_general.cu"
DEEP = (64,) * cuda_general.RES_MAX_LAYERS  # 17 layers with the head


def _lays(sizes, act, obs=21):
    return cuda_general.resident_layout(obs, sizes, act), cuda_general.resident_layout(obs, sizes, 1)


@pytest.mark.parametrize("act", (4, 10))
@pytest.mark.parametrize("sizes,route,plan", [
    ((576,), "resident", None), ((608,), "resident", None), ((640,), "cluster", (64, 2)),
    ((1000,), "cluster", (64, 2)), ((1024,), "cluster", (64, 2)), ((1024, 1024), "cluster", (64, 2)),
    ((2048,), "cluster", (64, 4)), ((4096,), "cluster", (64, 8)), ((4128,), "per_layer", None),
    (DEEP, "per_layer", None)], ids=["576", "608", "640", "1000", "1024", "2x1024", "2048", "4096", "4128", "deep17"])
def test_the_route_at_its_boundaries(sizes, route, plan, act):
    """Block, then cluster, then per layer, for K4g (actor and critic) and
    K3g (the actor, its staged means): 64-row blocks to 608 units, then
    64-row tiles on clusters of 2 to 1024, of 4 to 2048, of 8 to 4096; a
    trunk deeper than RES_MAX_LAYERS or wider stays per layer."""
    lays = _lays(sizes, act)
    net = ActorCritic(21, act, feature_sizes=(), pi_sizes=sizes, vf_sizes=sizes, device="cpu")
    w = net.kernel_weights()
    assert cuda_general.forward_route(w) == route
    assert cuda_general.logp_route(21, act, sizes) == route
    if route == "resident":
        assert cuda_general.resident_tile(lays, act) == 64 and cuda_general.resident_tile(lays[:1], act, True) == 64
    else:
        assert cuda_general.resident_tile(lays, act) is None
        assert cuda_general.cluster_plan(lays, act) == plan
        assert cuda_general.cluster_plan(lays[:1], act, True) == plan
        assert cuda_general.cluster_plan(lays, act, rows=10**6, sms=132) == plan  # no round fills the card
    # the cluster route reads the resident route's image, unchanged
    assert [s[0] for s in cuda_general.image_sizes(w)] == (
        [lay.bytes for lay in lays] if route != "per_layer" else [b for _, b in cuda_general.weight_layouts(w)])


@pytest.mark.parametrize("sizes,rows,trunks,c", [
    ((1024,), 256, 2, 4), ((1024,), 4096, 1, 2), ((1024,), 8192, 2, 2), ((1024,), 1000, 2, 4),
    ((1024,), 2112, 1, 4), ((1024,), 2113, 1, 2), ((2048,), 256, 2, 8), ((2048,), 4096, 1, 4),
    ((640,), 256, 2, 2), ((1504, 1504), 1000, 2, 4), ((1504, 1504), 8192, 2, 4), ((3040, 3040), 1000, 2, 8),
    ((3040, 3040), 8192, 1, 8)], ids=["1024-256", "1024-4096-k3g", "1024-8192", "1024-1000", "2112-k3g", "2113-k3g",
                                      "2048-256", "2048-4096-k3g", "640-256", "2x1504-1000", "2x1504-8192",
                                      "2x3040-1000", "2x3040-8192-k3g"])
def test_the_cluster_size_from_the_rows(sizes, rows, trunks, c):
    """Where a 64-row tile a cluster of C blocks leaves no more blocks than
    the card's 132 SMs, the largest such C up to the widest layer's chunks
    (640 units: 3 chunks, so no 4 at 256 rows); else the smallest that
    fits (2 at 1024 units, 4 at 2048, 4 at 2 x 1504 whose 6 chunks stop
    the 8; 8, the one that fits, at 2 x 3040)."""
    lays = _lays(sizes, 4)[:trunks]
    assert cuda_general.cluster_plan(lays, 4, trunks == 1, rows=rows, sms=132) == (64, c)


def _header_int(path, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = ([\d]+);", path.read_text()).group(1))


A_STAGES = _header_int(CLUSTER_HEADER, "A_STAGES")  # a rank's stages of a peer's k block


def test_the_cluster_budget_is_the_headers():
    """A cluster block's shared memory (``cluster_smem``, the header's
    ``smem_bytes``: the ring, two activation buffers of ``cluster_width``
    columns in k blocks, two stages of a peer's k block, two bias buffers,
    K3g's means, the barriers), ``cluster_width`` itself (each trunk's
    padded input and rank 0's share, a run of ceil(chunks / C) chunks,
    of each tanh layer), the clusters the entries take, and the first
    fitting (tile, C)."""
    res = cuda_build.CSRC / "policy_resident.cuh"
    assert _header_int(res, "NC") == NC and _header_int(res, "KC") == KC
    assert _header_int(CLUSTER_HEADER, "MAX_CLUSTER") == max(cuda_general.RES_CLUSTERS) == 8
    assert _header_int(CLUSTER_HEADER, "A_STAGES") == 2 and _header_int(CLUSTER_HEADER, "RELAY_UNITS") == 32
    assert _header_int(CLUSTER_HEADER, "TILE_ROWS") == cuda_general.CLUSTER_TILE == 64
    # a relayed head's sums (32 floats a thread of the first TILE) fill the two stages exactly
    assert cuda_general.CLUSTER_TILE * 32 * 4 == 2 * cuda_general.CLUSTER_TILE * KC * 2
    src = CLUSTER_HEADER.read_text()
    body = re.search(r"constexpr int smem_bytes\(int tile, int width, int act_dim, bool logp\) \{\s*return (.*?);\n\}",
                     src, re.S).group(1)
    assert " ".join(body.split()) == (
        "STAGES * STAGE_BYTES + 2 * tile * width * 2 + A_STAGES * kblock_bytes(tile) + "
        "2 * resident::bias_floats(width, act_dim) * 4 + (logp ? tile * resident::stage_stride(act_dim) * 4 : 0) + "
        "STAGES * 16")
    assert "const int smem = smem_bytes(TILE, p.width, p.act_dim, LOGP);" in src
    assert "cluster::smem_bytes(p.tile, p.width, p.act_dim, logp) > resident::SMEM_LIMIT" in ENTRIES.read_text()
    assert "C != 2 && C != 4 && C != cluster::MAX_CLUSTER" in ENTRIES.read_text()
    for sizes, obs, c, width in (((1024,), 21, 4, 256), ((640,), 21, 4, 256), ((640,), 21, 2, 512),
                                 ((2048,), 21, 8, 256), ((1024, 1024), 21, 4, 256), ((4096,), 21, 8, 512),
                                 ((1024,), 300, 4, 320), ((1000,), 72, 8, 256)):
        assert cuda_general.cluster_width(_lays(sizes, 4, obs), c) == width
    # (1024,) at 64 rows: C = 2 holds 512 columns; (2048,) needs C = 4 (1024 columns is over the limit)
    assert cuda_general.cluster_smem(64, 512, 10, True) <= cuda_general.RES_SMEM_LIMIT
    assert cuda_general.cluster_smem(64, 1024, 4) > cuda_general.RES_SMEM_LIMIT
    assert cuda_general.cluster_smem(128, 256, 4, True) == (4 * 16384 + 2 * 128 * 256 * 2 + 2 * 128 * 64
                                                             + 2 * 256 * 4 + 128 * 5 * 4 + 64)
    assert cuda_general.cluster_smem(128, 256, 10, True) <= cuda_general.RES_SMEM_LIMIT
    assert cuda_general.cluster_smem(64, 512, 4, True) <= cuda_general.RES_SMEM_LIMIT
    for c in cuda_general.RES_CLUSTERS:  # the runs: each chunk once, in order, rank 0's the longest
        for n in (32, 256, 288, 640, 1024, 2080):
            runs = [_run(n, r, c) for r in range(c)]
            assert [j for run in runs for j in run] == list(range(-(-n // NC)))
            assert max(len(run) for run in runs) == len(runs[0]) == -(-(-(-n // NC)) // c)


@pytest.mark.parametrize("tile", (64,))
def test_the_activation_blocks(tile):
    """The header's ``act_offset``: a buffer of ``width`` columns is its k
    blocks in order, each ``tile`` rows of 64 bytes swizzled as the weight
    blocks (every byte once; a peer's k block one contiguous run of 64 tile
    bytes, one 16-byte load a thread of the block); the 8 rows of an
    ldmatrix matrix and a warp's 32 epilogue stores (8 rows x 4 column
    pairs) fall in distinct banks."""
    src = CLUSTER_HEADER.read_text()
    assert "return (c / KC) * kblock_bytes(TILE) + swizzle(r, c % KC);" in src
    assert "constexpr int kblock_bytes(int tile) { return tile * KC * 2; }" in src
    act = lambda r, c: (c // KC) * tile * KC * 2 + cuda_general.swizzle(r, c % KC)  # noqa: E731
    width = 256
    offs = sorted(act(r, c) for r in range(tile) for c in range(width))
    assert offs == list(range(0, tile * width * 2, 2))
    for kb in range(width // KC):
        block = {act(r, c) for r in range(tile) for c in range(kb * KC, (kb + 1) * KC)}
        assert min(block) == kb * tile * 64 and max(block) == (kb + 1) * tile * 64 - 2
    assert 4 * tile * 16 == tile * KC * 2  # THREADS = 4 TILE: one 16-byte load a thread
    for r0 in range(0, tile, 8):
        for k in range(0, KC, 8):
            assert len({(act(r0 + j, k) % 128) // 16 for j in range(8)}) == 8
        for col in range(0, KC, 8):
            banks = {(act(r0 + gr, col + 2 * t4) // 4) % 32 for gr in range(8) for t4 in range(4)}
            assert len(banks) == 32


def test_the_image_from_transposed_weights():
    """``pack_resident`` reads a matrix given as the transpose of a
    contiguous tensor (K3g's leaves, ``nn.Linear.weight.T``) in that order,
    copying nothing first: the same image as from contiguous matrices."""
    rng = np.random.default_rng(9)
    lin = [T(rng.normal(size=(o, i)).astype(np.float32)) for i, o in ((21, 640), (640, 640), (640, 10))]
    biases = [T(rng.normal(size=(o,)).astype(np.float32)) for o in (640, 640, 10)]
    views = cuda_general.pack_resident([lin[0].T, lin[1].T], biases[:2], lin[2].T, biases[2])
    copies = cuda_general.pack_resident([lin[0].T.contiguous(), lin[1].T.contiguous()], biases[:2],
                                        lin[2].T.contiguous(), biases[2])
    assert torch.equal(views, copies)


def test_the_entry_points_and_the_launch_arguments():
    """The C entries take ``(const ResidentArgs*, int C, void* stream)`` as
    the ctypes bindings do; ``_ResidentArgsC`` mirrors ``struct
    ResidentArgs`` field for field; a cluster launch's arguments are the
    resident ones with ``width`` the cluster's."""
    text = ENTRIES.read_text()
    for kernel in (cuda_general.CLUSTER_FORWARD_KERNEL, cuda_general.CLUSTER_LOGP_KERNEL):
        assert re.search(rf'extern "C" int {kernel.symbol}\(const ResidentArgs\* args, int C, void\* stream\)', text)
        assert kernel.source == "policy_general.cu"
        assert kernel.argtypes == [cuda_build.ctypes.c_void_p, cuda_build.ctypes.c_int, cuda_build.ctypes.c_void_p]
    body = re.search(r"struct ResidentArgs \{(.*?)\n\};", (cuda_build.CSRC / "policy_resident.cuh").read_text(),
                     re.S).group(1)
    c_names = [re.sub(r"\[\d\]", "", m) for m in re.findall(r"\s(\w+(?:\[\d\])?);", body)]
    assert c_names == [f[0] for f in cuda_general._ResidentArgsC._fields_]
    w = ActorCritic(72, 10, feature_sizes=(), pi_sizes=(1024,), vf_sizes=(32, 32), device="cpu").kernel_weights()
    lays = cuda_general.resident_layouts(w)
    tile, c = cuda_general.cluster_plan(lays, 10)
    obs, mean, value = torch.zeros(5, 72), torch.zeros(5, 10), torch.zeros(5)
    args = cuda_general.resident_args(obs, (w.pi_image, w.vf_image), (mean, value), lays, tile, 72, 10,
                                      width=cuda_general.cluster_width(lays, c))
    assert (args.tile, args.width, c) == (64, 512, 2) and list(args.trunk[0].k)[:3] == [96, 1024, 0]
    assert list(args.trunk[1].n)[:4] == [32, 32, 32, 0] and args.trunk[0].bytes == lays[0].bytes


def test_the_wrappers_refuse_what_the_kernel_does_not_take():
    """``launch_cluster_logp`` raises for a trunk the block takes, one
    deeper than RES_MAX_LAYERS and an image that is not ``pack_resident``'s
    (short or misaligned); the per-layer route stays the only route past
    the cluster."""
    rows, ls = torch.zeros(3, 28), torch.zeros(4)
    block = cuda_general.resident_layout(21, (256,), 4)
    with pytest.raises(NotImplementedError, match="cluster"):
        cuda_general.launch_cluster_logp(rows, torch.zeros(block.bytes, dtype=torch.uint8), block, ls, 21)
    deep = cuda_general.resident_layout(21, DEEP, 4)
    with pytest.raises(NotImplementedError, match="cluster"):
        cuda_general.launch_cluster_logp(rows, torch.zeros(deep.bytes, dtype=torch.uint8), deep, ls, 21)
    wide = cuda_general.resident_layout(21, (1024,), 4)
    image = torch.zeros(wide.bytes + 16, dtype=torch.uint8)
    with pytest.raises(ValueError, match="image"):
        cuda_general.launch_cluster_logp(rows, image[:-32], wide, ls, 21)
    with pytest.raises(ValueError, match="image"):
        cuda_general.launch_cluster_logp(rows, image[8:-8], wide, ls, 21)
    with pytest.raises(NotImplementedError, match="resident"):
        cuda_general.launch_resident_logp(rows, image[:-16], wide, ls, 21)


def _relay(lay) -> bool:
    """``Share::relay``: the head's sums go across the ranks in k order."""
    return lay.layers > 1 and lay.n[-1] <= 32


def _run(units: int, rank: int, c: int) -> range:
    """The chunks of ``units`` that rank ``rank`` of ``c`` owns: a run of
    ceil(chunks / c), rank 0's first."""
    chunks = -(-units // NC)
    per = -(-chunks // c)
    return range(min(chunks, rank * per), min(chunks, (rank + 1) * per))


def _walk(lay, rank: int, c: int):
    """Warp 0's ``Walk`` of rank ``rank`` over one tile: each ring stage's
    layer, output chunk, byte offset and blocks (``span``: as many
    consecutive blocks of the chunk as fit a stage), in order, over the
    rank's items (``Share``): its run of a tanh layer's chunks over every
    input; its run of a relayed head's input chunks; another head's every
    chunk on rank 0."""
    head, relay = lay.layers - 1, _relay(lay)
    out = []
    for l in range(lay.layers):
        if l == head and relay:
            items = [(0, kc * NC, min(lay.k[l], (kc + 1) * NC)) for kc in _run(lay.k[l], rank, c)]
        elif l == head:
            items = [(j, 0, lay.k[l]) for j in range(-(-lay.n[l] // NC))] if rank == 0 else []
        else:
            items = [(j, 0, lay.k[l]) for j in _run(lay.n[l], rank, c)]
        for j, k0, k1 in items:
            lines = min(NC, lay.n[l] - j * NC)
            off = lay.w[l] + j * NC * lay.k[l] * 2 + k0 // KC * lines * KC * 2
            while k0 < k1:
                span = min(cuda_general.RES_STAGE_BYTES // (lines * KC * 2), (k1 - k0) // KC)
                out.append((l, j, off, span))
                off += span * lines * KC * 2
                k0 += span * KC
    return out


def _emulate(x: torch.Tensor, image: torch.Tensor, lay, tile: int, c: int, cols: int, width: int) -> torch.Tensor:
    """The cluster kernel on the image, tile by tile: every rank's two bf16
    buffers of ``width`` columns (the obs in each), rank r's run of each
    tanh layer's chunks computed from the blocks its walk copies, the A
    columns of input chunk kc read from the rank whose run holds it, at its
    place in that run (the first layer's from the rank itself), a stage's
    blocks one after another in k order, the output stored at the chunk's
    place in the rank's run; a narrow head relayed, each rank's run of
    input chunks summed from its own buffer in k order; the head returned
    f32 with its bias, (rows, padded head width). A peer's k block is read
    through the rank's A_STAGES stages, in turn over the layer's chunks:
    its stage must not be the one of the peer block before it, which the
    warps may still read (only the block barrier after the store holds
    them), whatever the chunks' counts of peer blocks."""
    half = image.view(torch.int16)
    bias = lambda l: image[lay.b[l] : lay.b[l] + 4 * lay.n[l]].view(torch.float32)  # noqa: E731
    bf = lambda t: t.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    lines, ks = torch.arange(NC)[:, None], torch.arange(KC)[None, :]
    outs = []
    for row0 in range(0, x.shape[0], tile):
        walks = [iter(_walk(lay, r, c)) for r in range(c)]
        bufs = [[torch.zeros(tile, width), torch.zeros(tile, width)] for _ in range(c)]
        stages = [[torch.zeros(tile, KC) for _ in range(A_STAGES)] for _ in range(c)]
        chunk = x[row0 : row0 + tile, :cols]
        for r in range(c):
            bufs[r][0][: chunk.shape[0], :cols] = bf(chunk)
        for l in range(lay.layers):
            head = l == lay.layers - 1
            out = torch.zeros(tile, lay.n[l])
            if head and _relay(lay):  # each rank's run of input chunks from its own buffer, the sums handed on
                rows = lay.n[l]
                acc = torch.zeros(tile, rows, dtype=torch.float64)
                for kc in range(-(-lay.k[l] // NC)):
                    r = next(q for q in range(c) if kc in _run(lay.k[l], q, c))
                    k0, k1 = kc * NC, min(lay.k[l], (kc + 1) * NC)
                    while k0 < k1:
                        wl, wj, off, span = next(walks[r])
                        assert (wl, wj) == (l, 0) and span * rows * KC * 2 <= 16384
                        for b in range(span):
                            col = (kc - _run(lay.k[l], r, c).start) * NC + k0 % NC
                            block = half[(off + b * rows * KC * 2 + cuda_general.swizzle(lines[:rows], ks)) // 2]
                            acc += bufs[r][l % 2][:, col : col + KC].double() @ block.view(torch.bfloat16).double().T
                            k0 += KC
                outs.append(acc.float() + bias(l)[:rows])
                continue
            for r in range(c):
                js = range(0, -(-lay.n[l] // NC)) if head and r == 0 else [] if head else _run(lay.n[l], r, c)
                staged, last = 0, None  # the layer's peer blocks so far and the last one's stage
                for j in js:
                    rows = min(NC, lay.n[l] - j * NC)
                    acc = torch.zeros(tile, rows, dtype=torch.float64)
                    k0 = 0
                    while k0 < lay.k[l]:
                        wl, wj, off, span = next(walks[r])
                        assert (wl, wj) == (l, j) and span >= 1 and span * rows * KC * 2 <= 16384
                        for b in range(span):
                            kc = k0 // NC
                            owner = next(q for q in range(c) if kc in _run(lay.k[l], q, c)) if l > 0 else r
                            col = (kc - _run(lay.k[l], owner, c).start) * NC + k0 % NC if l > 0 else k0
                            a = bufs[owner][l % 2][:, col : col + KC]
                            if owner != r:  # into the next stage, then a block barrier
                                slot = staged % A_STAGES
                                assert slot != last, f"layer {l} rank {r} chunk {j}: a stage still read"
                                stages[r][slot] = a.clone()
                                a, staged, last = stages[r][slot], staged + 1, slot
                            at = off + b * rows * KC * 2
                            block = half[(at + cuda_general.swizzle(lines[:rows], ks)) // 2].view(torch.bfloat16)
                            acc += a.double() @ block.double().T
                            k0 += KC
                    v = acc.float() + bias(l)[j * NC : j * NC + rows]
                    if head:
                        out[:, j * NC : j * NC + rows] = v
                    else:
                        at = (j - _run(lay.n[l], r, c).start) * NC
                        bufs[r][(l + 1) % 2][:, at : at + rows] = bf(torch.tanh(v))
            if head:
                outs.append(out)
        assert all(next(wk, None) is None for wk in walks)  # each rank's walk ends with the tile
    return torch.cat(outs)[: x.shape[0]]


@pytest.mark.parametrize("pi,vf,act", [((640,), (640,), 10), ((1024,), (1024,), 10), ((640, 1024), (32, 32), 10),
                                        ((1024,), (1024,), 40), ((1504, 1504), (32, 32), 10),
                                        ((3040, 3040), (32, 32), 10)],
                         ids=["640", "1024", "640-1024-32-32", "1024-act40", "2x1504", "2x3040"])
def test_the_schedule_emulated_on_the_image_is_the_twin(pi, vf, act):
    """The emulated cluster kernel on K4g's images against
    ``policy_value_forward_plain`` and, with K3g's means and the log-prob
    summed in action order, against ``logp_forward_plain``, at a ragged 37
    rows (obs 72, act 10); the twins sum in another order, so a bf16 flip
    of an activation is allowed (2e-3), while a wrong owner, column, block
    or k order reads O(1) off. The same schedule on one block (C = 1, the
    resident kernel's) gives the same bits. At 40 actions the head is too
    wide to relay: rank 0's, with its peers' blocks."""
    rng = np.random.default_rng(len(pi) + pi[0] + act)
    obs = 72
    net = ActorCritic(obs, act, feature_sizes=(), pi_sizes=pi, vf_sizes=vf, device="cpu",
                      generator=torch.Generator().manual_seed(5))
    w = net.kernel_weights()
    assert cuda_general.forward_route(w) == "cluster"
    lays = cuda_general.resident_layouts(w)
    tile, c = cuda_general.cluster_plan(lays, act)
    width = cuda_general.cluster_width(lays, c)
    x = T(rng.normal(size=(37, obs)).astype(np.float32))
    mean = _emulate(x, w.pi_image, lays[0], tile, c, obs, width)[:, :act]
    value = _emulate(x, w.vf_image, lays[1], tile, c, obs, width)[:, 0]
    mt, vt = cuda_policy.policy_value_forward_plain(x, w)
    np.testing.assert_allclose(mean.numpy(), mt.numpy(), atol=2e-3, rtol=0)
    np.testing.assert_allclose(value.numpy(), vt.numpy(), atol=2e-3, rtol=0)
    one = _emulate(x, w.pi_image, lays[0], tile, 1, obs, max(lays[0].k))[:, :act]
    assert torch.equal(mean, one)
    leaves = [t.detach() for t in cuda_sgd.params_to_leaves(net)[: 2 * len(pi) + 3]]
    rows = torch.cat([x, T(rng.normal(size=(37, act)).astype(np.float32)), torch.zeros(37, 3)], 1)
    lay = cuda_general.resident_layout(obs, pi, act)
    tile3, c3 = cuda_general.cluster_plan((lay,), act, True)
    means = _emulate(rows, w.pi_image, lay, tile3, c3, obs, cuda_general.cluster_width((lay,), c3))[:, :act]
    ls = leaves[-1].reshape(-1)
    logp = torch.zeros(37)
    for j in range(act):  # general::row_logp, in the action order
        d = rows[:, obs + j] - means[:, j]
        logp += -0.5 * (d * d / torch.exp(2 * ls[j]) + 2 * ls[j] + 1.8378770664093453)
    np.testing.assert_allclose(logp.numpy(), cuda_sgd.logp_forward_plain(rows, leaves, obs).numpy(), atol=2e-2, rtol=0)
