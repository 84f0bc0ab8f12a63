"""The host side of K2's wgmma design (``cuda_sgd.fused_epoch``,
csrc/fused_epoch.cu): the weight images the kernel writes after every Adam
step (``cuda_sgd.image_slots``) against ``cuda_policy.pack_trunk``; the
workspace tiles (``cuda_sgd.workspace_offset``) as the forward/backward
kernel's staged stores lay them out and as the weight-gradient kernel's
transposed-A and MN-major-B descriptors read them, k16 step by k16 step;
W1^T and W_head^T read from the forward's image through the MN-major
descriptor; the warp reduction's column mapping; and the descriptor
offsets written in the source. Every read goes through the hardware's
address rule for the 128-byte swizzle (bits 4-6 XOR bits 7-9). Torch only."""

import re

import numpy as np
import pytest
import torch

from pyflyt_tpu_torch.ops import cuda_build, cuda_policy, cuda_sgd

torch.set_num_threads(1)

H = cuda_sgd.HIDDEN
SOURCE = (cuda_build.CSRC / "fused_epoch.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _physical(logical: torch.Tensor) -> torch.Tensor:
    """The 128-byte swizzle: bits 4-6 of a byte address XOR bits 7-9 (every
    operand base sits on the 1024-byte period)."""
    return logical ^ (((logical >> 7) & 7) << 4)


def _mn_major(buf: torch.Tensor, start: int, lbo: int, sbo: int, k: int, mn: int) -> torch.Tensor:
    """A (k x mn) operand read MN-major from the bytes ``buf``: element
    (kk, n) at start + (kk // 8) sbo + (kk % 8) 128 + (n // 64) lbo +
    (n % 64) 2 (CUTLASS's ((8,n),(8,k)):((1,LBO),(8,SBO)) in 16-byte
    units), swizzled."""
    kk, n = torch.meshgrid(torch.arange(k), torch.arange(mn), indexing="ij")
    logical = start + (kk // 8) * sbo + (kk % 8) * 128 + (n // 64) * lbo + (n % 64) * 2
    return buf.view(torch.bfloat16)[_physical(logical) // 2]


def _k_major(buf: torch.Tensor, start: int, rows: int) -> torch.Tensor:
    """A (16 x rows) operand read K-major (policy_mlp.cuh::sw128_desc, SBO
    1024): element (kk, n) at start + (n // 8) 1024 + (n % 8) 128 +
    (kk // 8) 16 + (kk % 8) 2, swizzled."""
    kk, n = torch.meshgrid(torch.arange(16), torch.arange(rows), indexing="ij")
    logical = start + (n // 8) * 1024 + (n % 8) * 128 + (kk // 8) * 16 + (kk % 8) * 2
    return buf.view(torch.bfloat16)[_physical(logical) // 2]


def _bf16(rng, *shape) -> torch.Tensor:
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)


def _tile(values: torch.Tensor) -> torch.Tensor:
    """A (64, 256) bf16 tile as its workspace bytes (``workspace_offset``)."""
    r, c = torch.meshgrid(torch.arange(64), torch.arange(H), indexing="ij")
    buf = torch.zeros(cuda_sgd.TILE_BYTES // 2, dtype=torch.bfloat16)
    buf[cuda_sgd.workspace_offset(r, c).reshape(-1) // 2] = values.reshape(-1)
    return buf.view(torch.uint8)


# ---------------------------------------------------------------------------
# the weight images Adam writes
# ---------------------------------------------------------------------------


def _leaves(obs: int, act: int, seed: int):
    rng = np.random.default_rng(seed)
    net = dict(obs_dim=obs, act_dim=act, pi_sizes=(H, H), vf_sizes=(H, H))
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for _, s in cuda_sgd.leaf_specs(net)]


@pytest.mark.parametrize("act", (1, 4, 8))
@pytest.mark.parametrize("obs", (21, 33, 35, 64))
def test_image_slots_write_pack_trunk(obs, act):
    """The flat parameters scattered through ``image_slots`` (bf16 for the
    matrices, f32 for the biases) into a zeroed buffer are, byte for byte,
    the actor's and the critic's ``pack_trunk`` images."""
    leaves = _leaves(obs, act, seed=obs * 10 + act)
    offsets, P = cuda_sgd.flat_layout([tuple(t.shape) for t in leaves])
    flat = cuda_sgd._to_flat(leaves, offsets, P)
    slot, is_f32 = cuda_sgd.image_slots(obs, act)
    assert slot.shape == (P,) and is_f32.shape == (P,)
    buf = torch.zeros(2 * cuda_policy.TRUNK_BYTES, dtype=torch.uint8)
    mat = (slot >= 0) & ~is_f32
    buf.view(torch.bfloat16)[slot[mat] // 2] = flat[mat].to(torch.bfloat16)
    bias = (slot >= 0) & is_f32
    assert bool((slot[bias] % 4 == 0).all())
    buf.view(torch.float32)[slot[bias] // 4] = flat[bias]
    want = torch.cat([cuda_policy.pack_trunk(*leaves[:6]), cuda_policy.pack_trunk(*leaves[7:])])
    assert torch.equal(buf, want)


@pytest.mark.parametrize("obs,act", [(21, 4), (35, 1), (64, 8)])
def test_image_slots_leave_log_std_and_padding_out(obs, act):
    leaves = _leaves(obs, act, seed=1)
    offsets, P = cuda_sgd.flat_layout([tuple(t.shape) for t in leaves])
    slot, is_f32 = cuda_sgd.image_slots(obs, act)
    written = slot >= 0
    assert int(written.sum()) == sum(t.numel() for t in leaves) - act  # all but log_std
    assert bool((slot[offsets[6] : offsets[6] + act] == -1).all())
    assert len(set(slot[written].tolist())) == int(written.sum())  # no two entries share a slot
    assert int(slot.max()) < 2 * cuda_policy.TRUNK_BYTES


# ---------------------------------------------------------------------------
# the workspace: the forward/backward's stores, the weight gradient's reads
# ---------------------------------------------------------------------------


def test_workspace_offset_is_a_bijection_onto_the_tile():
    r, c = torch.meshgrid(torch.arange(64), torch.arange(H), indexing="ij")
    off = cuda_sgd.workspace_offset(r, c).reshape(-1)
    assert bool((off % 2 == 0).all()) and int(off.min()) == 0 and int(off.max()) == cuda_sgd.TILE_BYTES - 2
    assert off.unique().numel() == 64 * H
    assert cuda_sgd.workspace_offset(5, 70) == cuda_sgd.BLOCK_BYTES + 5 * 128 + ((0 ^ 5) * 16) + 6 * 2


@pytest.mark.parametrize("block", range(4))
def test_staged_stores_write_the_workspace_layout(block):
    """``store_rows``: lane L gives stmatrix the row address of matrix L / 8
    (column group 8 b + 4 h + L / 8), row L % 8: stage + 128 rho + (((4 h +
    L / 8) ^ rho) 16); the 1 KB stage then goes whole to rows rbase ..
    rbase + 7 of block b. The bytes land where ``workspace_offset`` says."""
    values = _bf16(np.random.default_rng(block), 64, H)
    got = torch.zeros(cuda_sgd.TILE_BYTES, dtype=torch.uint8)
    for rbase in range(0, 64, 8):
        stage = torch.zeros(1024, dtype=torch.uint8)
        for h in range(2):
            for lane in range(32):
                rho, jm = lane % 8, lane // 8
                group = 8 * block + 4 * h + jm  # the matrix's 8 columns, in its 8 x 8 fragment
                at = rho * 128 + (((4 * h + jm) ^ rho) * 16)
                stage[at : at + 16] = values[rbase + rho, 8 * group : 8 * group + 8].view(torch.uint8)
        dst = block * cuda_sgd.BLOCK_BYTES + rbase * 128
        got[dst : dst + 1024] = stage
    want = _tile(values)
    lo, hi = block * cuda_sgd.BLOCK_BYTES, (block + 1) * cuda_sgd.BLOCK_BYTES
    assert torch.equal(got[lo:hi], want[lo:hi])


@pytest.mark.parametrize("step", range(4))
def test_transposed_a_reads_x_transposed(step):
    """The weight gradient's A = X^T (64 features x 16 rows a k16 step),
    MN-major from one 64 x 64 block: descriptor at block + 16 x 128 x step,
    LBO ``WS_LBO``, SBO ``WS_SBO``."""
    x = _bf16(np.random.default_rng(10 + step), 64, H)
    buf = _tile(x)
    for blk in range(4):
        got = _mn_major(buf, blk * cuda_sgd.BLOCK_BYTES + 2048 * step, _const("WS_LBO"), _const("WS_SBO"), 16, 64)
        assert torch.equal(got.T, x[16 * step : 16 * step + 16, 64 * blk : 64 * blk + 64].T)


@pytest.mark.parametrize("step", range(4))
def test_mn_major_b_reads_dz(step):
    """The weight gradient's B = dZ (16 rows x 256 outputs a k16 step),
    MN-major over the tile's four blocks."""
    dz = _bf16(np.random.default_rng(20 + step), 64, H)
    got = _mn_major(_tile(dz), 2048 * step, _const("WS_LBO"), _const("WS_SBO"), 16, H)
    assert torch.equal(got, dz[16 * step : 16 * step + 16])


@pytest.mark.parametrize("step", range(4))
def test_dhead_block_is_the_head_jobs_k_major_b(step):
    """dmean / dvalue of a tile as the (8 outputs x 64 rows) K-major block
    the forward/backward writes (``swizzle_offset(row, output, 8)``), read
    by the head job's ``sw128_desc`` at block + 32 x step."""
    dhead = _bf16(np.random.default_rng(30 + step), 64, 8)
    r, j = torch.meshgrid(torch.arange(64), torch.arange(8), indexing="ij")
    buf = torch.zeros(cuda_sgd.HEAD_TILE_BYTES // 2, dtype=torch.bfloat16)
    buf[cuda_policy.swizzle_offset(r, j, 8).reshape(-1) // 2] = dhead.reshape(-1)
    got = _k_major(buf.view(torch.uint8), 32 * step, 8)
    assert torch.equal(got, dhead[16 * step : 16 * step + 16])


# ---------------------------------------------------------------------------
# the data gradient's transposed weights from the forward's image
# ---------------------------------------------------------------------------


def _trunk(obs: int, outs: int, seed: int):
    rng = np.random.default_rng(seed)
    shapes = [(obs, H), (H,), (H, H), (H,), (H, outs), (outs,)]
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes]


@pytest.mark.parametrize("obs", (21, 64))
def test_w1_transpose_through_the_image(obs):
    """dz1 = dz2 W1^T: B[k = output o][n = input] = W1[input, o], read
    MN-major from the resident image at W1 + 16 x 128 x kb, the image's
    K-chunks as the 64-wide atoms (LBO ``W1T_LBO``, SBO ``W1T_SBO``), every
    k16 step."""
    w = _trunk(obs, 4, seed=obs)
    image = cuda_policy.pack_trunk(*w)
    w1 = w[2].to(torch.bfloat16)
    for kb in range(H // 16):
        got = _mn_major(image, cuda_policy.W1_OFF + 2048 * kb, _const("W1T_LBO"), _const("W1T_SBO"), 16, H)
        assert torch.equal(got, w1[:, 16 * kb : 16 * kb + 16].T), kb


@pytest.mark.parametrize("outs", (1, 4, 8))
def test_head_transpose_through_the_image(outs):
    """da2 = dhead W_head^T, 64 columns a piece: B[k = output j][n] =
    W_head[64 pc + n, j], MN-major from head chunk pc; rows 8-15 (SBO
    ``HWT_SBO`` = 0) read rows 0-7 again, which the zero A columns 8-15
    cancel; rows past the outputs are the image's zero padding."""
    w = _trunk(21, outs, seed=outs)
    image = cuda_policy.pack_trunk(*w)
    hw = torch.zeros(H, 8, dtype=torch.bfloat16)
    hw[:, :outs] = w[4].to(torch.bfloat16)
    for pc in range(4):
        got = _mn_major(image, cuda_policy.HW_OFF + 1024 * pc, 1024, _const("HWT_SBO"), 16, 64)
        want = hw[64 * pc : 64 * pc + 64].T
        assert torch.equal(got[:8], want) and torch.equal(got[8:], want)


# ---------------------------------------------------------------------------
# the column sums and the source's constants
# ---------------------------------------------------------------------------


def _lane_sums(v: np.ndarray) -> np.ndarray:
    """``lane_sums<N>`` over a warp: v (32 lanes, N) -> (32 lanes, N / 8),
    three exchanges with the lanes 16, 8 and 4 apart, each lane keeping the
    upper half where its lane bit is set."""
    v = v.copy()
    for st in range(3):
        msk, half = 16 >> st, v.shape[1] // 2
        out = np.empty((32, half), v.dtype)
        for lane in range(32):
            up, partner = bool(lane & msk), lane ^ msk
            keep = v[lane, half : 2 * half] if up else v[lane, :half]
            give = v[partner, half : 2 * half] if up else v[partner, :half]  # what the partner sends
            out[lane] = keep + give
        v = out
    return v


@pytest.mark.parametrize("n", (16, 64))
def test_lane_sums_column_mapping(n):
    """Entry idx of a lane's two-row sums is column 8 (idx / 2) + 2 q + idx
    % 2 of its fragment; after ``lane_sums`` lane L's entry k is the warp's
    sum of entry (n / 8) (L / 4) + k over the 8 lanes of its q: the column
    the kernel writes it to (64 pc + 8 g + 2 q + k for n 16, 32 g + 8 (k /
    2) + 2 q + k % 2 for n 64)."""
    rng = np.random.default_rng(n)
    v = rng.integers(-1000, 1000, size=(32, n)).astype(np.float64)
    col_sums = {}
    for lane in range(32):
        q = lane % 4
        for idx in range(n):
            col = 8 * (idx // 2) + 2 * q + idx % 2
            col_sums[col] = col_sums.get(col, 0.0) + v[lane, idx]
    out = _lane_sums(v)
    seen = set()
    for lane in range(32):
        g, q = lane // 4, lane % 4
        for k in range(n // 8):
            col = 8 * g + 2 * q + k if n == 16 else 32 * g + 8 * (k // 2) + 2 * q + k % 2
            assert out[lane, k] == col_sums[col], (lane, k)
            seen.add(col)
    assert seen == set(range(8 * n // 2))  # every column once


def test_source_constants_match_the_host():
    assert _const("W1T_LBO") == cuda_policy.W1_BYTES // 4  # one K-chunk of the image's W1
    assert _const("W1T_SBO") == _const("WS_SBO") == 1024
    assert _const("WS_LBO") == cuda_sgd.BLOCK_BYTES
    assert _const("HWT_SBO") == 0
    assert _const("JOBS") * 2 == cuda_sgd.WGRAD_JOBS
    assert cuda_sgd.COLS == 2 * H + cuda_policy.HEAD_N
    assert cuda_sgd.MAX_OBS_DIM == cuda_policy.MAX_OBS_DIM == 64
    # the image's regions as the kernel computes them from policy_mlp.cuh
    assert cuda_policy.W1_OFF == 256 * 64 * 2 and cuda_policy.HW_OFF == cuda_policy.W1_OFF + 4 * 256 * 64 * 2
    assert cuda_policy.B0_OFF == cuda_policy.HW_OFF + 4 * 8 * 64 * 2
    assert cuda_policy.TRUNK_BYTES == cuda_policy.B0_OFF + 2 * H * 4 + 8 * 4


@pytest.mark.parametrize("obs,act,ok", [(64, 8, True), (33, 1, True), (65, 4, False), (21, 9, False)])
def test_epoch_envelope_is_k4s(obs, act, ok):
    """K2's envelope is K4's (obs up to 64, at most 8 actions at 2 x 256);
    past it the router sends the same trunks to the general family, and
    the wide family's own check still refuses them."""
    if ok:
        assert cuda_sgd._check_envelope(obs, act, (H, H), (H, H)) == "wide"
        cuda_sgd.check_family("wide", obs, act, (H, H), (H, H))
    else:
        assert cuda_sgd._check_envelope(obs, act, (H, H), (H, H)) == "general"
        with pytest.raises(NotImplementedError):
            cuda_sgd.check_family("wide", obs, act, (H, H), (H, H))


def test_ppo_fused_sgd_raises_past_the_envelope():
    """Past the wide and narrow kernels' obs width 64, ``PPO(fused_sgd=True)``
    no longer raises on the CPU (the twins take any width) and the card's
    router sends the network to the general family; only the wide family's
    own check still refuses obs 65, naming its envelope."""
    from pyflyt_tpu_torch.rl import PPO, PPOConfig

    ppo = PPO(_cuda_env(4, obs=65, device="cpu"), PPOConfig(fused_sgd=True))
    assert ppo.config.fused_sgd and ppo.action_dim == 4
    cfg = PPOConfig()
    assert cuda_sgd._check_envelope(65, 4, cfg.feature_sizes + cfg.pi_sizes, cfg.feature_sizes + cfg.vf_sizes) == "general"
    with pytest.raises(NotImplementedError, match="outside 1..64"):
        cuda_sgd.check_family("wide", 65, 4, cfg.feature_sizes + cfg.pi_sizes, cfg.feature_sizes + cfg.vf_sizes)


def _cuda_env(act: int, obs: int = 21, device: str = "cuda"):
    """An env as far as ``PPO.__init__``'s envelope check reads it, on the
    card by name only (or on ``device``)."""
    from types import SimpleNamespace

    return SimpleNamespace(obs_size=obs, device=torch.device(device),
                           action_bounds=lambda: (-np.ones(act, np.float32), np.ones(act, np.float32)))


@pytest.mark.parametrize("act,kw,what", [
    (4, dict(fused_sgd=True, pi_sizes=(64, 64, 32, 32), vf_sizes=(64, 64, 32, 32)), "got pi"),
    (4, dict(fused_sgd=True, feature_sizes=(), pi_sizes=(64, 64, 32, 32), vf_sizes=(64, 64, 32, 32)), None),
    (4, dict(fused_rollout_forward=True, feature_sizes=(256, 256, 256)), "got pi"),
    (9, dict(fused_sgd=True), "action width 9"),
    (4, dict(fused_sgd=True, obs=65), "obs width 65"),
    (4, dict(fused_sgd=True, feature_sizes=(), pi_sizes=(64, 64, 32, 32, 32), vf_sizes=(64, 64, 32, 32)), "got pi"),
    (4, dict(fused_rollout_forward=True, feature_sizes=(256, 256), pi_sizes=(64,)), "got pi"),
])
def test_ppo_raises_outside_the_kernel_envelope_on_the_card(act, kw, what):
    """On a CUDA env, ``PPO``'s router takes every network the Pallas
    builders take: those the wide kernels and their narrow family do not
    (64-64-32-32 behind the default 2 x 256 feature trunk, a three-layer
    256-wide trunk, 9 actions, obs 65, a 5-layer actor, 2 x 256 plus one
    more layer) go to the general family, and the wide and narrow
    families' own checks still refuse them, saying why (``what``); the
    20 M search's SMALL arm (``what`` None: no feature trunk) stays the
    narrow family's. Only a non-positive width raises, before anything
    is put on the card."""
    from pyflyt_tpu_torch.rl import PPO, PPOConfig

    kw = dict(kw)
    obs = kw.pop("obs", 21)
    cfg = PPOConfig(**kw)
    pi, vf = cfg.feature_sizes + cfg.pi_sizes, cfg.feature_sizes + cfg.vf_sizes
    if what is None:  # PPO's own check on the trunks it builds
        assert cuda_sgd._check_envelope(obs, act, pi, vf) == "narrow"
        return
    assert cuda_sgd._check_envelope(obs, act, pi, vf) == "general"
    with pytest.raises(NotImplementedError, match=what):
        cuda_sgd.check_family("wide", obs, act, pi, vf)
    with pytest.raises(NotImplementedError):
        cuda_sgd.check_family("narrow", obs, act, pi, vf)
    with pytest.raises(ValueError, match="positive"):
        PPO(_cuda_env(act, obs), PPOConfig(**{**kw, "feature_sizes": (0,)}))