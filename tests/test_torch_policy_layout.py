"""The host side of the wgmma forward kernels (K4 ``policy_value_forward``,
K3 ``logp_forward``): each trunk's shared-memory weight image
(``cuda_policy.pack_trunk``) against its inverse, its padding, its
alignment, the swizzle formula and the byte addresses a wgmma descriptor
of ``csrc/policy_mlp.cuh`` reads; the plain forward on the weights read
back from the image; the C mirrors and constants; and the wrappers' checks
of what the kernels do not take. Torch only."""

import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch

from pyflyt_tpu_torch.ops import cuda_build, cuda_general, cuda_narrow, cuda_policy, cuda_sgd
from pyflyt_tpu_torch.rl.networks import ActorCritic

torch.set_num_threads(1)

H = cuda_policy.HIDDEN
OBS_WIDTHS = (16, 21, 30, 33, 35, 64)
ACT_WIDTHS = (1, 4, 7, 8)


def _trunk(obs_dim: int, outs: int, seed: int):
    """Seeded f32 trunk weights in flax layout: w0, b0, w1, b1, hw, hb."""
    rng = np.random.default_rng(seed)
    shapes = [(obs_dim, H), (H,), (H, H), (H,), (H, outs), (outs,)]
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16)


@pytest.mark.parametrize("act", ACT_WIDTHS)
@pytest.mark.parametrize("obs", OBS_WIDTHS)
def test_image_round_trips_exactly(obs, act):
    w = _trunk(obs, act, seed=obs * 10 + act)
    image = cuda_policy.pack_trunk(*w)
    assert image.dtype == torch.uint8 and image.shape == (cuda_policy.TRUNK_BYTES,)
    back = cuda_policy.unpack_trunk(image, obs, act)
    want = [_bf16(w[0]), w[1], _bf16(w[2]), w[3], _bf16(w[4]), w[5]]
    for got, ref in zip(back, want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.equal(got, ref)


@pytest.mark.parametrize("act", ACT_WIDTHS)
@pytest.mark.parametrize("obs", OBS_WIDTHS)
def test_image_padding_is_zero(obs, act):
    """Every bf16 slot that holds no weight is zero (layer 0's K past
    obs_dim, the head's rows past act), and so is the head bias past act."""
    w = [t.abs() + 1.0 for t in _trunk(obs, act, seed=7 + obs + act)]  # no weight is zero
    image = cuda_policy.pack_trunk(*w)
    mats = image[: cuda_policy.B0_OFF].view(torch.bfloat16)
    used = torch.zeros(mats.numel(), dtype=torch.bool)
    used[cuda_policy._image_index(obs, act, "cpu")] = True
    assert int(used.sum()) == obs * H + H * H + H * act
    assert bool((mats[used] != 0).all())
    assert bool((mats[~used] == 0).all())
    hb = image[cuda_policy.HB_OFF :].view(torch.float32)
    assert torch.equal(hb[:act], w[5]) and bool((hb[act:] == 0).all())


def test_regions_are_16_byte_aligned_multiples_of_16():
    offsets = [0, cuda_policy.W1_OFF, cuda_policy.HW_OFF, cuda_policy.B0_OFF, cuda_policy.B1_OFF,
               cuda_policy.HB_OFF, cuda_policy.TRUNK_BYTES]
    assert offsets == sorted(offsets)
    assert all(o % 16 == 0 for o in offsets)
    # the matrices' chunks sit on the swizzle's 1024-byte period
    assert cuda_policy.W1_OFF % 1024 == 0 and cuda_policy.HW_OFF % 1024 == 0
    image = cuda_policy.pack_trunk(*_trunk(21, 4, seed=1))
    assert all(p % 16 == 0 for p in cuda_policy.image_pointers(image))
    assert cuda_policy.image_pointers(image)[0] == image.data_ptr()


@pytest.mark.parametrize("region", ["w0", "w1", "head"])
def test_sampled_entries_sit_at_the_swizzle_formula(region):
    """Byte offset of entry (k, n) of a (K, rows) matrix: chunk k // 64 of
    rows x 128 bytes, row n, the 16-byte group (k % 64) // 8 XOR n % 8,
    then (k % 8) x 2 — restated here, checked on the image's bytes."""
    obs, act = 35, 7
    w = _trunk(obs, act, seed=3)
    image = cuda_policy.pack_trunk(*w)
    mat, base, rows = {"w0": (w[0], 0, H), "w1": (w[2], cuda_policy.W1_OFF, H),
                       "head": (w[4], cuda_policy.HW_OFF, 8)}[region]
    rng = np.random.default_rng(5)
    for k, n in zip(rng.integers(0, mat.shape[0], 64), rng.integers(0, mat.shape[1], 64)):
        k, n = int(k), int(n)
        off = base + (k // 64) * rows * 128 + n * 128 + (((k % 64) // 8) ^ (n % 8)) * 16 + (k % 8) * 2
        assert off == base + cuda_policy.swizzle_offset(k, n, rows)
        want = _bf16(mat[k, n]).reshape(1).view(torch.uint8)
        assert torch.equal(image[off : off + 2], want), (k, n)


def _wgmma_b_operand(image: torch.Tensor, chunk_base: int, row0: int, rows: int, step: int) -> torch.Tensor:
    """What wgmma reads as B (K-major, 128-byte swizzle, SBO 1024) from a
    descriptor at chunk_base + row0 x 128 + 32 x step: element (kk, r) of
    the 16 x rows operand at logical byte start + (r // 8) x 1024 + (r % 8)
    x 128 + (kk // 8) x 16 + (kk % 8) x 2, whose bits 4-6 the swizzle XORs
    with bits 7-9 (the image's chunks sit at multiples of 1024, as in
    shared memory)."""
    kk, r = torch.meshgrid(torch.arange(16), torch.arange(rows), indexing="ij")
    start = chunk_base + row0 * 128 + 32 * step
    logical = start + (r // 8) * 1024 + (r % 8) * 128 + (kk // 8) * 16 + (kk % 8) * 2
    physical = logical ^ (((logical >> 7) & 7) << 4)
    return image.view(torch.bfloat16)[physical // 2]


@pytest.mark.parametrize("obs,act", [(21, 4), (35, 7), (64, 8)])
def test_wgmma_descriptors_read_the_weights(obs, act):
    """Each consumer warpgroup's n128 slice of layers 0 and 1 and the n8
    head, k16 step by k16 step, as the kernel's descriptors address them."""
    w = _trunk(obs, act, seed=obs + act)
    image = cuda_policy.pack_trunk(*w)
    w0 = torch.zeros(64, H, dtype=torch.bfloat16)
    w0[:obs] = _bf16(w[0])  # layer 0's K padded with zeros to one chunk
    for g in range(2):
        cols = slice(128 * g, 128 * g + 128)
        for s in range(4):
            got = _wgmma_b_operand(image, 0, 128 * g, 128, s)
            assert torch.equal(got, w0[16 * s : 16 * s + 16, cols])
        for c in range(4):
            for s in range(4):
                got = _wgmma_b_operand(image, cuda_policy.W1_OFF + c * H * 128, 128 * g, 128, s)
                assert torch.equal(got, _bf16(w[2])[64 * c + 16 * s : 64 * c + 16 * s + 16, cols])
    hw = torch.zeros(H, 8, dtype=torch.bfloat16)
    hw[:, :act] = _bf16(w[4])
    for c in range(4):
        for s in range(4):
            got = _wgmma_b_operand(image, cuda_policy.HW_OFF + c * 8 * 128, 0, 8, s)
            assert torch.equal(got, hw[64 * c + 16 * s : 64 * c + 16 * s + 16])


@pytest.mark.parametrize("obs,act", [(21, 4), (33, 7), (64, 1)])
def test_plain_forward_on_the_image_is_exact(obs, act):
    net = ActorCritic(obs, act, device="cpu", generator=torch.Generator().manual_seed(obs))
    w = net.kernel_weights()
    pi = cuda_policy.unpack_trunk(w.pi_image, obs, act)
    vf = cuda_policy.unpack_trunk(w.vf_image, obs, 1)
    back = cuda_policy.PolicyWeights(
        pi_w=[pi[0], pi[2]], pi_b=[pi[1], pi[3]], pi_head_w=pi[4], pi_head_b=pi[5],
        vf_w=[vf[0], vf[2]], vf_b=[vf[1], vf[3]], vf_head_w=vf[4], vf_head_b=vf[5],
    )
    obs_t = torch.from_numpy(np.random.default_rng(obs).normal(size=(65, obs)).astype(np.float32))
    m1, v1 = cuda_policy.policy_value_forward_plain(obs_t, w)
    m2, v2 = cuda_policy.policy_value_forward_plain(obs_t, back)
    assert torch.equal(m1, m2) and torch.equal(v1, v2)


def test_prepare_weights_packs_only_what_the_kernel_takes():
    inside = ActorCritic(21, 4, device="cpu", generator=torch.Generator().manual_seed(0)).kernel_weights()
    assert torch.equal(inside.pi_image, cuda_policy.pack_trunk(
        inside.pi_w[0], inside.pi_b[0], inside.pi_w[1], inside.pi_b[1], inside.pi_head_w, inside.pi_head_b))
    assert torch.equal(inside.vf_image, cuda_policy.pack_trunk(
        inside.vf_w[0], inside.vf_b[0], inside.vf_w[1], inside.vf_b[1], inside.vf_head_w, inside.vf_head_b))
    narrow = ActorCritic(21, 4, feature_sizes=(16,), device="cpu").kernel_weights()  # the narrow family's
    assert cuda_policy._kernel_family(narrow) == "narrow" and torch.equal(narrow.pi_image, cuda_narrow.pack_trunk(
        narrow.pi_w, narrow.pi_b, narrow.pi_head_w, narrow.pi_head_b))
    for net in (ActorCritic(21, 4, feature_sizes=(256,), device="cpu"), ActorCritic(65, 4, device="cpu"),
                ActorCritic(21, 9, device="cpu"), ActorCritic(21, 4, feature_sizes=(1024,), device="cpu")):
        # the general family's: the resident and cluster routes' bf16 images, the per-layer route's f32 leaves
        w = net.kernel_weights()
        assert cuda_policy._kernel_family(w) == "general"
        pack = cuda_general.pack_trunk if cuda_general.forward_route(w) == "per_layer" else cuda_general.pack_resident
        assert (cuda_general.forward_route(w) == "cluster") == (net.pi_trunk.layers[0].out_features == 1024)
        assert torch.equal(w.pi_image, pack(
            [lin.weight.T for lin in net.pi_trunk.layers], [lin.bias for lin in net.pi_trunk.layers],
            net.pi_head.weight.T, net.pi_head.bias))
        obs = torch.zeros(3, net.obs_dim)
        mean, value = cuda_policy.policy_value_forward(obs, w)  # the twin takes any widths
        assert mean.shape == (3, net.action_dim) and value.shape == (3,)


def _weights(obs=21, act=4, **kw):
    return ActorCritic(obs, act, device="cpu", generator=torch.Generator().manual_seed(1), **kw).kernel_weights()


def _misaligned(w):
    buf = torch.zeros(cuda_policy.TRUNK_BYTES + 16, dtype=torch.uint8)
    buf[1 : 1 + cuda_policy.TRUNK_BYTES] = w.pi_image
    return dataclasses.replace(w, pi_image=buf[1 : 1 + cuda_policy.TRUNK_BYTES])


@pytest.mark.parametrize(
    "case,err,match",
    [
        ("obs 65", NotImplementedError, "obs width 65"),
        ("act 9", NotImplementedError, "action width 9"),
        ("3-layer trunk", NotImplementedError, "two 256-wide"),
        ("128-wide trunk", None, None),  # the narrow family's (cuda_narrow)
        ("256-wide single layer", NotImplementedError, "two 256-wide"),
        ("misaligned weights", ValueError, "16-byte aligned"),
        ("no image", ValueError, "images"),
    ],
)
def test_forward_kernel_rejects_what_it_does_not_take(case, err, match):
    """K4's image refuses what it does not take (``match``); obs 65, 9
    actions, three layers and a single 256-wide layer route to the general
    family (K4g), while the wide family's own check still names why; the
    wide images must be aligned and present."""
    w = {
        "obs 65": lambda: _weights(obs=65),
        "act 9": lambda: _weights(act=9),
        "3-layer trunk": lambda: _weights(feature_sizes=(256, 256, 256)),
        "128-wide trunk": lambda: _weights(feature_sizes=(128, 128)),
        "256-wide single layer": lambda: _weights(feature_sizes=(256,)),
        "misaligned weights": lambda: _misaligned(_weights()),
        "no image": lambda: dataclasses.replace(_weights(), vf_image=None),
    }[case]()
    if err is None:
        assert cuda_policy._check_kernel_shapes(torch.zeros(2, w.obs_dim), w) == "narrow"
        return
    if err is NotImplementedError:
        assert cuda_policy._check_kernel_shapes(torch.zeros(2, w.obs_dim), w) == "general"
        pi, vf = [t.shape[1] for t in w.pi_w], [t.shape[1] for t in w.vf_w]
        with pytest.raises(err, match=match):
            cuda_sgd.check_family("wide", w.obs_dim, w.act_dim, pi, vf)
        return
    with pytest.raises(err, match=match):
        cuda_policy._check_kernel_shapes(torch.zeros(2, w.obs_dim), w)


def test_forward_kernel_takes_the_main_paths_shapes():
    for obs, act in ((21, 4), (30, 4), (33, 7), (35, 4), (64, 8), (1, 1)):
        w = _weights(obs=obs, act=act)
        cuda_policy._check_kernel_shapes(torch.zeros(2, obs), w)


@pytest.mark.parametrize(
    "obs,act,pi,match",
    [(65, 4, (256, 256), "obs width"), (21, 9, (256, 256), "action width"),
     (21, 4, (256, 256, 256), "two 256-wide")],
)
def test_logp_kernel_rejects_what_it_does_not_take(obs, act, pi, match):
    """K3 refuses these actors (the wide family's check names why); the
    router sends them to K3g."""
    assert cuda_sgd._check_envelope(obs, act, pi, pi) == "general"
    with pytest.raises(NotImplementedError, match=match):
        cuda_sgd.check_family("wide", obs, act, pi, pi)


def test_pack_trunk_rejects_shapes_outside_the_image():
    w = _trunk(21, 4, seed=0)
    with pytest.raises(NotImplementedError):
        cuda_policy.pack_trunk(*_trunk(65, 4, seed=0))
    with pytest.raises(NotImplementedError):
        cuda_policy.pack_trunk(*_trunk(21, 9, seed=0))
    with pytest.raises(NotImplementedError):
        cuda_policy.pack_trunk(w[0][:, :128], w[1], w[2], w[3], w[4], w[5])


def _header_int(name: str) -> int:
    text = (cuda_build.CSRC / "policy_mlp.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_header_constants_match_the_image():
    assert _header_int("HID") == H
    assert _header_int("KC") == cuda_policy.KC
    assert _header_int("HEAD_N") == cuda_policy.HEAD_N
    assert cuda_policy.MAX_OBS_DIM == cuda_policy.KC == cuda_sgd.MAX_OBS_DIM
    assert cuda_sgd.MAX_ACT_DIM == cuda_policy.HEAD_N


def _c_fields(struct: str):
    body = re.search(rf"struct {struct} \{{(.*?)\}};", (cuda_build.CSRC / "policy_value_forward.cu").read_text(),
                     re.S).group(1)
    return [(name, "ptr" if ptr else ctype)
            for ctype, ptr, name in re.findall(r"^\s*(?:const )?(\w+)(\*?) (\w+);", body, re.M)]


def test_forward_args_mirror_matches_the_c_struct():
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int", ctypes.c_float: "float"}
    py = [(name, kinds[t]) for name, t in cuda_policy._ForwardArgsC._fields_]
    assert py == _c_fields("ForwardArgs")
