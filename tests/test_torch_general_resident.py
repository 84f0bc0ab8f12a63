"""The general family's resident route (K4g and K3g on
``csrc/policy_resident.cuh``, ``ops/cuda_general.py``) on the CPU, torch
only: the bf16 image (``pack_resident``) against the weights rounded to
bf16, its zero padding, offsets and 16-byte alignment; the route at its
boundaries; the shared-memory budget and the swizzle against the header;
the launch arguments (the C mirrors are held in
``tests/test_torch_general_trunks.py``); and the kernel's schedule, emulated step by step on
the image (the producer's walk over the weight blocks, the two bf16
activation buffers, the staged means), against the twins.
"""

import re

import numpy as np
import pytest
import torch

from pyflyt_tpu_torch.ops import cuda_build, cuda_general, cuda_policy, cuda_sgd
from pyflyt_tpu_torch.rl.networks import ActorCritic

torch.set_num_threads(1)

T = torch.from_numpy
# the general family's trunk pairs held on the card (chip_smoke.GENERAL_PAIRS)
PAIRS = (((), ()), ((48,) * 6, (48,) * 6), ((160, 72), (160, 72)), ((256, 256), (32, 32)), ((256,), (256,)),
         ((256, 256, 256), (256, 256, 256)), ((512, 512), (512, 512)), ((256, 256, 64), (256, 256, 64)))
PAIR_IDS = ["linear", "six48", "160-72", "2x256-32-32", "256", "3x256", "2x512", "256-256-64"]
WIDTHS = ((21, 4), (72, 10))
HEADER = cuda_build.CSRC / "policy_resident.cuh"


def _trunk(rng, obs, sizes, outs):
    dims = (obs, *sizes, outs)
    mats = [T(rng.normal(size=(a, b)).astype(np.float32) * 0.3) for a, b in zip(dims[:-1], dims[1:])]
    biases = [T(rng.normal(size=(1, b)).astype(np.float32) * 0.3) for b in dims[1:]]
    return mats, biases


@pytest.mark.parametrize("obs,act", WIDTHS, ids=["obs21-act4", "obs72-act10"])
@pytest.mark.parametrize("pi,vf", PAIRS, ids=PAIR_IDS)
def test_the_image_is_the_weights_in_bf16(pi, vf, obs, act):
    """Each trunk's image unpacks to its matrices rounded to bf16 (nearest
    even) and its f32 biases; every word no weight or bias lands in is 0;
    each layer's blocks and bias start 16-byte aligned, the layers' regions
    in order without gaps, and each block's lines hold a padded unit's
    inputs at ``resident_offset``."""
    rng = np.random.default_rng(obs + act + len(pi))
    for sizes, outs in ((pi, act), (vf, 1)):
        mats, biases = _trunk(rng, obs, sizes, outs)
        image = cuda_general.pack_resident(mats[:-1], biases[:-1], mats[-1], biases[-1])
        lay = cuda_general.resident_layout(obs, sizes, outs)
        assert image.dtype == torch.uint8 and tuple(image.shape) == (lay.bytes,) and lay.bytes % 16 == 0
        got_m, got_b = cuda_general.unpack_resident(image, lay)
        for g, m in zip(got_m, mats):
            assert g.dtype == torch.bfloat16 and torch.equal(g, m.to(torch.bfloat16))
        for g, b in zip(got_b, biases):
            assert torch.equal(g, b.reshape(-1))
        index = cuda_general._resident_index(lay, "cpu")
        pad = index == index.max()
        assert int(pad.sum()) == lay.bytes // 2 - sum(a * b for a, b in zip(lay.dims[:-1], lay.dims[1:])) - 2 * sum(
            lay.dims[1:])
        assert not image.view(torch.int16)[pad].any()
        ends = [lay.w[0]]
        for l in range(lay.layers):
            assert lay.k[l] % 32 == 0 and lay.n[l] % 32 == 0 and lay.k[l] >= lay.dims[l] and lay.n[l] >= lay.dims[l + 1]
            assert lay.w[l] == ends[-1] and lay.w[l] % 16 == 0 and lay.b[l] % 16 == 0
            ends.append(lay.w[l] + 2 * lay.k[l] * lay.n[l])
            blocks = [lay.w[l] + cuda_general.resident_offset(c, k, lay.k[l], lay.n[l])
                      for c in range(0, lay.n[l], 256) for k in range(0, lay.k[l], 32)]
            assert all(b % 16 == 0 for b in blocks) and blocks == sorted(blocks)
        assert lay.b[0] == ends[-1] and lay.b[-1] + 4 * lay.n[-1] == lay.bytes
        k, r = lay.dims[0] - 1, lay.dims[1] - 1  # the last real entry of layer 0, read where the kernel reads it
        at = lay.w[0] + cuda_general.resident_offset(r, k, lay.k[0], lay.n[0])
        assert image[at : at + 2].view(torch.bfloat16).item() == mats[0][k, r].to(torch.bfloat16).item()


@pytest.mark.parametrize("width,act,k4g_tile,k3g_tile", [
    (256, 4, 128, 128), (288, 4, 128, 128), (320, 4, 64, 64), (512, 4, 64, 64), (608, 4, 64, 64), (640, 4, None, None),
    (1024, 4, None, None), (288, 64, 128, 64), (256, 300, 128, 64)])
def test_the_route_at_its_boundaries(width, act, k4g_tile, k3g_tile):
    """One tanh layer of ``width`` units (obs 21): 128 rows a block while
    the two activation buffers and the bias buffers fit beside the ring,
    then 64, then the cluster route; K3g's staged means (a row of act
    floats) push a wide head to 64 rows."""
    lays = (cuda_general.resident_layout(21, (width,), act), cuda_general.resident_layout(21, (width,), 1))
    assert cuda_general.resident_tile(lays, act) == k4g_tile
    assert cuda_general.resident_tile(lays[:1], act, True) == k3g_tile
    assert cuda_general.logp_route(21, act, (width,)) == ("resident" if k3g_tile else "cluster")
    for tile in cuda_general.RES_TILES:
        fits = cuda_general.resident_smem(tile, width, act) <= cuda_general.RES_SMEM_LIMIT
        assert fits == (k4g_tile is not None and tile <= k4g_tile)


def test_the_route_by_depth_and_through_the_weights():
    """At most RES_MAX_LAYERS layers (the head included) a trunk; the
    ``PolicyWeights`` of a resident (or cluster) network carry its bf16
    images, of a per-layer one its f32 vectors, and ``_check_kernel_shapes``
    holds each to its route's size."""
    deep = (64,) * (cuda_general.RES_MAX_LAYERS - 1)
    assert cuda_general.logp_route(21, 4, deep) == "resident"
    assert cuda_general.logp_route(21, 4, deep + (64,)) == "per_layer"
    for sizes, route in (((256, 256, 256), "resident"), ((1024,), "cluster"), ((), "resident"),
                         (deep + (64,), "per_layer")):
        net = ActorCritic(21, 4, feature_sizes=(), pi_sizes=sizes, vf_sizes=sizes, device="cpu",
                          generator=torch.Generator().manual_seed(len(sizes)))
        w = net.kernel_weights()
        assert cuda_policy._check_kernel_shapes(torch.zeros(2, 21), w) == "general"
        assert cuda_general.forward_route(w) == route
        if route != "per_layer":
            assert torch.equal(w.pi_image, cuda_general.pack_resident(w.pi_w, w.pi_b, w.pi_head_w, w.pi_head_b))
            assert torch.equal(w.vf_image, cuda_general.pack_resident(w.vf_w, w.vf_b, w.vf_head_w, w.vf_head_b))
        else:
            assert w.pi_image.numel() == cuda_general.weight_layouts(w)[0][1]


def _header_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = ([\d]+);", HEADER.read_text()).group(1))


def test_the_budget_and_the_swizzle_are_the_headers():
    """The wrapper's constants, its shared-memory sum and the swizzle are
    the header's; the swizzle puts the 8 lines of every ldmatrix matrix in
    8 distinct 16-byte bank groups, and covers each block's bytes once."""
    for name, value in (("NC", cuda_general.RES_NC), ("KC", cuda_general.RES_KC), ("STAGES", cuda_general.RES_STAGES),
                        ("WN", cuda_general.RES_WN), ("MAX_LAYERS", cuda_general.RES_MAX_LAYERS),
                        ("ACT_PAD", cuda_general.RES_ACT_PAD), ("SMEM_LIMIT", cuda_general.RES_SMEM_LIMIT)):
        assert _header_int(name) == value, name
    assert cuda_general.resident_smem(128, 256, 4) == 4 * 16384 + 2 * 128 * 264 * 2 + 2 * 256 * 4 + 64
    assert cuda_general.resident_smem(128, 256, 4, True) == cuda_general.resident_smem(128, 256, 4) + 128 * 5 * 4
    assert cuda_general.resident_smem(64, 512, 10, True) == 4 * 16384 + 2 * 64 * 520 * 2 + 2 * 512 * 4 + 64 * 11 * 4 + 64
    assert cuda_general.resident_smem(64, 64, 300) == 4 * 16384 + 2 * 64 * 72 * 2 + 2 * 320 * 4 + 64
    for r0 in range(0, 256, 8):
        for k in range(0, 32, 8):
            slots = {(cuda_general.swizzle(r0 + j, k) % 128) // 16 for j in range(8)}
            assert len(slots) == 8
    offs = sorted(cuda_general.swizzle(r, k) for r in range(256) for k in range(32))
    assert offs == list(range(0, 256 * 64, 2))
    for width in (32, 96, 256, 288, 512):  # activation rows: 8 consecutive rows in 8 bank groups
        stride = 2 * (width + cuda_general.RES_ACT_PAD)
        assert len({(j * stride % 128) // 16 for j in range(8)}) == 8


def test_the_launch_arguments():
    """``resident_args``: both trunks' layouts zero-padded to
    RES_MAX_LAYERS, the width the widest padded input; a
    K3g launch leaves the second image and output null."""
    w = ActorCritic(72, 10, feature_sizes=(), pi_sizes=(160, 72), vf_sizes=(48,), device="cpu").kernel_weights()
    lays = cuda_general.resident_layouts(w)
    obs, mean, value = torch.zeros(5, 72), torch.zeros(5, 10), torch.zeros(5)
    args = cuda_general.resident_args(obs, (w.pi_image, w.vf_image), (mean, value), lays, 128, 72, 10)
    assert (args.n, args.ld, args.obs_dim, args.act_dim, args.tile) == (5, 72, 72, 10, 128)
    assert args.width == 160 and list(args.trunk[0].k)[:4] == [96, 160, 96, 0] and args.trunk[1].layers == 2
    assert list(args.trunk[1].n) == [64, 32] + [0] * 14 and args.trunk[0].bytes == lays[0].bytes
    assert list(args.image) == [w.pi_image.data_ptr(), w.vf_image.data_ptr()] and args.log_std is None
    rows = torch.zeros(5, 85)
    one = cuda_general.resident_args(rows, (w.pi_image,), (value,), lays[:1], 64, 72, 10, torch.zeros(10), (-1.0, 0.5))
    assert list(one.image)[1] is None and list(one.out)[1] is None and one.ld == 85 and one.has_range == 1
    assert (one.ls_lo, one.ls_hi) == (-1.0, 0.5)


def test_the_wrappers_refuse_what_the_kernel_does_not_take():
    lay = cuda_general.resident_layout(21, (256,), 4)
    image = torch.zeros(lay.bytes, dtype=torch.uint8)
    with pytest.raises(ValueError, match="image"):
        cuda_general.launch_resident_logp(torch.zeros(3, 28), image[:-16], lay, torch.zeros(4), 21)
    wide = cuda_general.resident_layout(21, (1024,), 4)
    with pytest.raises(NotImplementedError, match="resident"):
        cuda_general.launch_resident_logp(torch.zeros(3, 28), torch.zeros(wide.bytes, dtype=torch.uint8), wide,
                                          torch.zeros(4), 21)


def _emulate(x: torch.Tensor, image: torch.Tensor, lay, tile: int, cols: int) -> torch.Tensor:
    """The kernel's schedule on the image, tile by tile: the producer's walk
    over the weight blocks (``Cursor``), each step's block decoded through
    the swizzle and multiplied into the chunk's f32 accumulator, the tanh
    layers' outputs rounded to bf16 into the other activation buffer, the
    head's f32 outputs (bias added) returned, (rows, padded head width)."""
    half = image.view(torch.int16)
    bias = lambda l: image[lay.b[l] : lay.b[l] + 4 * lay.n[l]].view(torch.float32)  # noqa: E731
    bf = lambda t: t.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    lines = torch.arange(cuda_general.RES_NC)[:, None]
    ks = torch.arange(cuda_general.RES_KC)[None, :]
    outs = []
    for row0 in range(0, x.shape[0], tile):
        width = max(lay.k)
        act = [torch.zeros(tile, width), torch.zeros(tile, width)]
        chunk = x[row0 : row0 + tile, :cols]
        act[0][: chunk.shape[0], :cols] = bf(chunk)
        off = lay.w[0]  # Cursor.off
        for l in range(lay.layers):
            assert off == lay.w[l]
            src, head = act[l % 2], l == lay.layers - 1
            out = torch.zeros(tile, lay.n[l])
            for c0 in range(0, lay.n[l], cuda_general.RES_NC):
                rows = min(cuda_general.RES_NC, lay.n[l] - c0)
                acc = torch.zeros(tile, rows, dtype=torch.float64)
                for k0 in range(0, lay.k[l], cuda_general.RES_KC):
                    words = half[(off + cuda_general.swizzle(lines[:rows], ks)) // 2]
                    block = words.view(torch.bfloat16).to(torch.float64)  # (rows, KC): W^T
                    acc += src[:, k0 : k0 + cuda_general.RES_KC].double() @ block.T
                    off += rows * cuda_general.RES_KC * 2  # Cursor.next
                v = acc.float() + bias(l)[c0 : c0 + rows]
                out[:, c0 : c0 + rows] = v if head else bf(torch.tanh(v))
            if head:
                outs.append(out)
            else:
                act[(l + 1) % 2][:, : lay.n[l]] = out
    return torch.cat(outs)[: x.shape[0]]


@pytest.mark.parametrize("pi,vf", [PAIRS[1], PAIRS[2], PAIRS[3], PAIRS[0]], ids=["six48", "160-72", "2x256-32-32",
                                                                                  "linear"])
def test_the_schedule_emulated_on_the_image_is_the_twin(pi, vf):
    """The emulated kernel on K4g's images against
    ``policy_value_forward_plain`` and, with K3g's staged means and the
    log-prob summed in action order, against ``logp_forward_plain``, at a
    ragged 37 rows (two tiles of 64 or one of 128): the twins sum in
    another order, so a bf16 flip of an activation is allowed (2e-3);
    a wrong block, line or k order reads O(1) off."""
    rng = np.random.default_rng(len(pi))
    obs, act = 72, 10
    net = ActorCritic(obs, act, feature_sizes=(), pi_sizes=pi, vf_sizes=vf, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    w = net.kernel_weights()
    lays = cuda_general.resident_layouts(w)
    x = T(rng.normal(size=(37, obs)).astype(np.float32))
    tile = cuda_general.resident_tile(lays, act)
    mean = _emulate(x, w.pi_image, lays[0], tile, obs)[:, :act]
    value = _emulate(x, w.vf_image, lays[1], tile, obs)[:, 0]
    mt, vt = cuda_policy.policy_value_forward_plain(x, w)
    np.testing.assert_allclose(mean.numpy(), mt.numpy(), atol=2e-3, rtol=0)
    np.testing.assert_allclose(value.numpy(), vt.numpy(), atol=2e-3, rtol=0)
    leaves = [t.detach() for t in cuda_sgd.params_to_leaves(net)[: 2 * len(pi) + 3]]
    rows = torch.cat([x, T(rng.normal(size=(37, act)).astype(np.float32)), torch.zeros(37, 3)], 1)
    image = cuda_general.pack_resident(leaves[: 2 * len(pi) : 2], leaves[1 : 2 * len(pi) : 2], leaves[2 * len(pi)],
                                       leaves[2 * len(pi) + 1])
    lay = cuda_general.resident_layout(obs, pi, act)
    means = _emulate(rows, image, lay, cuda_general.resident_tile((lay,), act, True), obs)[:, :act]
    ls = leaves[-1].reshape(-1)
    logp = torch.zeros(37)
    for j in range(act):  # general::row_logp, in the action order
        d = rows[:, obs + j] - means[:, j]
        logp += -0.5 * (d * d / torch.exp(2 * ls[j]) + 2 * ls[j] + 1.8378770664093453)
    np.testing.assert_allclose(logp.numpy(), cuda_sgd.logp_forward_plain(rows, leaves, obs).numpy(), atol=2e-2, rtol=0)
