"""The general policy family (K4g, K3g, K2g: ``ops/cuda_general.py``) on
the CPU, where its kernels run their twins: the family-agnostic
``policy_value_forward_plain``, ``logp_forward_plain`` and
``fused_epoch_plain``.

With every matmul an f32 product (as ``tests/test_torch_sgd.py`` sets
them), the twins are held against the JAX package's plain ``ActorCritic``
and its XLA epoch (``jax.value_and_grad(PPO._loss)`` and optax's clip and
Adam, scanned over the minibatches) at trunks the wide and narrow kernels
refuse: a linear policy, six 48-wide layers, widths that are no multiple
of 16, a 2 x 256 actor beside a 32-32 critic, obs 72 and 10 actions. Then
the router's three answers, the general layouts and C mirrors against the
sources, and ``PPO(fused_sgd=True)`` on the CPU at obs 72.
"""

import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pyflyt_tpu.envs.quadx_hover import QuadXHoverEnv as JHoverEnv
from pyflyt_tpu.rl import networks as jnet
from pyflyt_tpu.rl import ppo as jppo
from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv
from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
from pyflyt_tpu_torch.ops import cuda_build, cuda_general, cuda_policy, cuda_sgd
from pyflyt_tpu_torch.rl import PPO, PPOConfig

torch.set_num_threads(1)

T = torch.from_numpy
# (pi, vf, obs, act): the trunks of the check
CASES = [((), (), 72, 10), ((48,) * 6, (48,) * 6, 21, 4), ((160, 72), (160, 72), 72, 10), ((256, 256), (32, 32), 21, 4)]
IDS = ["linear-obs72-act10", "six48", "160-72-obs72-act10", "2x256-actor-32-32-critic"]
N_MB, MB = 2, 64
HYPER = dict(learning_rate=1e-3, clip_eps=0.2, entropy_coef=0.01, value_coef=0.5, max_grad_norm=0.5)


@pytest.fixture
def f32_matmuls(monkeypatch):
    """The twins' matmuls as plain f32 products."""
    monkeypatch.setattr(cuda_sgd, "_mm", lambda a, b: a @ b)
    monkeypatch.setattr(cuda_sgd, "_mm_tn", lambda a, b: a.T @ b)
    monkeypatch.setattr(cuda_sgd, "_mm_nt", lambda a, b: a @ b.T)
    monkeypatch.setattr(cuda_policy, "_mm", lambda a, w: a @ w.to(torch.float32))


def _jax_net(pi, vf, act):
    return jnet.ActorCritic(action_dim=act, feature_sizes=(), pi_sizes=pi, vf_sizes=vf, init_log_std=-0.5)


def _params(pi, vf, obs, act, seed):
    """Flax parameters with non-zero biases and heads large enough to matter."""
    params = _jax_net(pi, vf, act).init(jax.random.PRNGKey(seed), jnp.zeros((1, obs)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 0.2), params)


def _leaves(params) -> list[np.ndarray]:
    """Flax parameters → the ordered leaves of ``cuda_sgd.leaf_specs``, as
    ``pallas_sgd.params_to_leaves`` orders them; a trunk without a layer has
    no entry in the tree (a linear policy)."""
    p = params["params"]
    out = []
    for trunk, head, extra in (("pi_trunk", "pi_head", ("log_std",)), ("vf_trunk", "vf_head", ())):
        layers = p.get(trunk, {})
        for i in range(len(layers)):
            out += [layers[f"Dense_{i}"]["kernel"], layers[f"Dense_{i}"]["bias"][None, :]]
        out += [p[head]["kernel"], p[head]["bias"][None, :]] + [p[k][None, :] for k in extra]
    return [np.array(x) for x in out]


def _f32_weights(leaves, n_pi, n_vf) -> cuda_policy.PolicyWeights:
    """``PolicyWeights`` holding the f32 leaves themselves (the f32 twin's)."""
    i_vf0 = 2 * n_pi + 3
    return cuda_policy.PolicyWeights(
        pi_w=leaves[0 : 2 * n_pi : 2], pi_b=[b.reshape(-1) for b in leaves[1 : 2 * n_pi : 2]],
        pi_head_w=leaves[2 * n_pi], pi_head_b=leaves[2 * n_pi + 1].reshape(-1),
        vf_w=leaves[i_vf0 : i_vf0 + 2 * n_vf : 2], vf_b=[b.reshape(-1) for b in leaves[i_vf0 + 1 : i_vf0 + 2 * n_vf : 2]],
        vf_head_w=leaves[i_vf0 + 2 * n_vf], vf_head_b=leaves[i_vf0 + 2 * n_vf + 1].reshape(-1),
    )


@pytest.mark.parametrize("pi,vf,obs,act", CASES, ids=IDS)
def test_forward_and_logp_twins_match_the_jax_network(pi, vf, obs, act, f32_matmuls):
    """K4g's and K3g's twins at f32 against ``ActorCritic.apply`` and
    ``gaussian_log_prob``: f32 sums in another order, 2e-5 on the mean and
    value, 1e-4 on the log-probs (|logp| ~ 30 at 10 actions)."""
    params = _params(pi, vf, obs, act, seed=len(pi) + obs)
    leaves = [T(x) for x in _leaves(params)]
    rng = np.random.default_rng(obs)
    x = rng.normal(size=(37, obs)).astype(np.float32)
    action = rng.normal(size=(37, act)).astype(np.float32) * 0.5
    mean_j, log_std_j, value_j = _jax_net(pi, vf, act).apply(params, jnp.asarray(x))
    mean, value = cuda_policy.policy_value_forward_plain(T(x), _f32_weights(leaves, len(pi), len(vf)))
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(value.numpy(), np.asarray(value_j), atol=2e-5, rtol=0)
    rows = np.concatenate([x, action, np.zeros((37, 3), np.float32)], axis=1)
    got = cuda_sgd.logp_forward(T(rows), leaves[: 2 * len(pi) + 3], obs, vf_sizes=vf)
    want = jnet.gaussian_log_prob(mean_j, log_std_j, jnp.asarray(action))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _xla_epoch(pi, vf, obs, act, params, mbs):
    """The JAX package's XLA epoch: ``value_and_grad(PPO._loss)`` and the
    clip + Adam chain, scanned over the minibatches."""
    cfg = jppo.PPOConfig(feature_sizes=(), pi_sizes=pi, vf_sizes=vf, init_log_std=-0.5, **HYPER)
    jp = jppo.PPO(JHoverEnv(), cfg, network=_jax_net(pi, vf, act))
    c0 = obs + act

    def minibatch(carry, mb):
        p, opt_state = carry
        (_, metrics), grads = jax.value_and_grad(jp._loss, has_aux=True)(
            p, mb[:, :obs], mb[:, obs:c0], mb[:, c0], mb[:, c0 + 1], mb[:, c0 + 2]
        )
        updates, opt_state = jp.optimizer.update(grads, opt_state, p)
        return (optax.apply_updates(p, updates), opt_state), metrics

    (out, _), metrics = jax.jit(lambda p, s, m: jax.lax.scan(minibatch, (p, s), m))(
        params, jp.optimizer.init(params), jnp.asarray(mbs)
    )
    return _leaves(out), metrics


@pytest.mark.parametrize("pi,vf,obs,act", CASES, ids=IDS)
def test_epoch_twin_matches_the_jax_xla_epoch(pi, vf, obs, act, f32_matmuls):
    """K2g's twin (``fused_epoch_plain``) at f32 over two 64-row minibatches
    from zero moments against the XLA epoch: the metrics to 1e-4 relative,
    the params within 1e-5, 1% of an lr-1e-3 Adam step, after two steps
    (Adam's bias correction 1 - exp(t ln b) against optax's 1 - b**t, and
    f32 sums in another order: an entry whose 64 terms cancel to about
    Adam's eps moves its step with the order, seen at 3.5e-6 at 2 x 256)."""
    params = _params(pi, vf, obs, act, seed=3 + len(vf))
    leaves = _leaves(params)
    rng = np.random.default_rng(5)
    feat = obs + act + 3
    mbs = rng.normal(size=(N_MB, MB, feat)).astype(np.float32)
    flat = mbs.reshape(-1, feat)
    own = cuda_sgd.logp_forward_plain(T(flat), [T(x) for x in leaves[: 2 * len(pi) + 3]], obs)
    flat[:, obs + act] = own.numpy() + rng.normal(size=flat.shape[0]).astype(np.float32) * 0.3
    flat[:, obs + act + 2] *= 3.0
    adv = mbs[:, :, obs + act + 1]
    stats = np.stack([adv.mean(1), adv.std(1)], axis=1).astype(np.float32)
    want, jmet = _xla_epoch(pi, vf, obs, act, params, mbs)
    cfg = cuda_sgd.EpochConfig(obs, act, pi, vf, **HYPER)
    zeros = [torch.zeros(x.shape) for x in leaves]
    got, _, _, met = cuda_sgd.fused_epoch(T(mbs), T(stats), torch.zeros(1, dtype=torch.int32),
                                          [T(x.copy()) for x in leaves], zeros, zeros, cfg)
    for i, k in enumerate(cuda_sgd.METRICS):
        np.testing.assert_allclose(met[:, i].numpy(), np.asarray(jmet[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0, err_msg=f"leaf {i}")
    assert max(np.abs(a.numpy() - b).max() for a, b in zip(got, leaves)) > 1e-3  # the params moved


@pytest.mark.parametrize("obs,act,pi,vf,want", [
    (21, 4, (256, 256), (256, 256), "wide"),
    (64, 8, (256, 256), (256, 256), "wide"),
    (21, 4, (64, 64, 32, 32), (128, 16), "narrow"),
    (21, 4, (), (), "general"),
    (21, 4, (48,) * 6, (48,) * 6, "general"),
    (21, 4, (160, 72), (160, 72), "general"),
    (21, 4, (256, 256), (32, 32), "general"),
    (72, 10, (256, 256), (256, 256), "general"),
    (21, 4, (256, 256, 256), (256, 256, 256), "general"),
    (21, 4, (512, 512), (512, 512), "general"),
])
def test_the_router_answers_wide_narrow_or_general(obs, act, pi, vf, want):
    """Two 256-wide layers a trunk (obs <= 64, act <= 8): the wide kernels;
    1-4 layers of at most 128: the narrow ones; everything else the Pallas
    builders take: the general ones, whose images the weights then carry."""
    assert cuda_sgd._check_envelope(obs, act, pi, vf) == want
    net = dict(obs_dim=obs, act_dim=act, pi_sizes=pi, vf_sizes=vf)
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    w = ActorCritic(obs, act, feature_sizes=(), pi_sizes=pi, vf_sizes=vf, device="cpu").kernel_weights()
    assert cuda_policy._check_kernel_shapes(torch.zeros(2, obs), w) == want
    if want == "general":
        (pt, pf), (vt, vf_floats) = cuda_general.weight_layouts(w)
        lays = cuda_general.resident_layouts(w)
        assert cuda_general.forward_route(w) == "resident"  # every pair here fits a block
        assert w.pi_image.numel() == lays[0].bytes and w.vf_image.numel() == lays[1].bytes
        assert pt.dims == lays[0].dims == (obs, *pi, act) and vt.dims == lays[1].dims == (obs, *vf, 1)
        assert len(cuda_sgd.leaf_specs(net)) == 2 * (len(pi) + len(vf)) + 5


def test_the_router_refuses_a_non_positive_width():
    for args in ((0, 4, (256, 256), (256, 256)), (21, 0, (256, 256), (256, 256)), (21, 4, (256, 0), (256, 256)),
                 (21, 4, (64,), (0,))):
        with pytest.raises(ValueError, match="positive"):
            cuda_sgd._check_envelope(*args)


def test_the_general_images_and_epoch_layout():
    """K4g's and K3g's resident image holds each matrix rounded to bf16 in
    blocks of W^T at ``resident_layout``'s offsets (widths padded to 32,
    16-byte aligned) and the f32 biases after them; the per-layer route's
    image holds each W rounded to bf16, rows padded to 32 outputs with
    zeros, and the f32 biases, at ``layout``'s 128-byte aligned offsets;
    K2g's trunks sit at ``leaf_specs``' offsets; its workspace keeps every
    layer's f32 outputs, the tanh layers' bf16 outputs and the image's
    matrices apart, the bf16 ones 128-byte aligned."""
    rng = np.random.default_rng(0)
    sizes = (48, 20, 33)
    mats = [T(rng.normal(size=s).astype(np.float32)) for s in ((72, 48), (48, 20), (20, 33), (33, 10))]
    biases = [T(rng.normal(size=(1, s)).astype(np.float32)) for s in (48, 20, 33, 10)]
    res = cuda_general.pack_resident(mats[:3], biases[:3], mats[3], biases[3])
    rlay = cuda_general.resident_layout(72, sizes, 10)
    assert rlay.k == (96, 64, 32, 64) and rlay.n == (64, 32, 64, 32) and res.numel() == rlay.bytes
    assert rlay.w == (0, 2 * 96 * 64, 2 * (96 * 64 + 64 * 32), 2 * (96 * 64 + 64 * 32 + 32 * 64))
    got_m, got_b = cuda_general.unpack_resident(res, rlay)
    for l, (m, b) in enumerate(zip(mats, biases)):
        assert rlay.w[l] % 16 == 0 and rlay.b[l] % 16 == 0
        assert torch.equal(got_m[l], m.to(torch.bfloat16)) and torch.equal(got_b[l], b.reshape(-1))
        assert not res[rlay.b[l] + 4 * b.numel() : rlay.b[l] + 4 * rlay.n[l]].any()
    image = cuda_general.pack_trunk(mats[:3], biases[:3], mats[3], biases[3])
    lay, nbytes = cuda_general.layout(72, sizes, 10)
    assert image.numel() == nbytes and lay.dims == (72, 48, 20, 33, 10)
    got_m, got_b = cuda_general.unpack_trunk(image, lay)
    for l, (m, b) in enumerate(zip(mats, biases)):
        k, n = m.shape
        assert lay.w[l] % 128 == 0 and lay.b[l] % 128 == 0
        assert torch.equal(got_m[l], m.to(torch.bfloat16)) and torch.equal(got_b[l], b.reshape(-1))
        rows = image[lay.w[l] : lay.w[l] + 2 * k * -(-n // 32) * 32].view(torch.bfloat16).view(k, -1)
        assert rows.shape[1] % 32 == 0 and not rows[:, n:].float().any()  # zero past every width
    cfg = cuda_sgd.EpochConfig(72, 10, sizes, (16,), **HYPER)
    pi, vf, ls_off = cuda_general.leaf_trunks(cfg)
    offsets, _ = cuda_sgd.flat_layout([s for _, s in cuda_sgd.leaf_specs(
        dict(obs_dim=72, act_dim=10, pi_sizes=sizes, vf_sizes=(16,)))])
    assert pi.w == tuple(offsets[0:8:2]) and pi.b == tuple(offsets[1:8:2]) and ls_off == offsets[8]
    assert vf.w == (offsets[9], offsets[11]) and vf.b == (offsets[10], offsets[12])
    ws = cuda_general.epoch_workspace(100, pi, vf)
    pad = lambda x: -(-x // 32) * 32  # noqa: E731
    for regions, end in (
        ([(o, 100 * n) for t, outs in zip((pi, vf), ws.out) for o, n in zip(outs, t.dims[1:])], ws.floats),
        ([(o, 100 * pad(n)) for t, acts in zip((pi, vf), ws.act) for o, n in zip(acts, t.dims[1:-1])], ws.acts),
        ([(o, k * pad(n)) for t, img in zip((pi, vf), ws.img) for o, k, n in zip(img, t.dims[:-1], t.dims[1:])],
         ws.image),
    ):
        ends = sorted((o, o + k) for o, k in regions)
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:])) and ends[-1][1] <= end
    assert all(o % 64 == 0 for offs in (*ws.act, *ws.img) for o in offs)  # 128-byte aligned bf16
    assert ws.cs == ((0, 48, 68, 101), (111, 127)) and ws.cs_width == 128 and ws.dz_width == 64
    outs, ws_elems = cuda_general.forward_outputs(7, 72, pi, vf)
    assert ws_elems == 7 * 96 + 2 * 7 * 64 and outs[0] == (7 * 96, 7 * 96 + 7 * 64, 7 * 96, 0)
    assert outs[1] == (7 * 96, 0)
    assert cuda_general.kernels_per_minibatch(3, 3) == 25 and cuda_general.kernels_per_minibatch(0, 0) == 7


def _c_struct(source: str, name: str) -> list[tuple[str, str, int]]:
    """(type, field, count) of ``struct <name>`` in a source, comments out;
    an array's count a number or a ``constexpr int`` of the source."""
    text = (cuda_build.CSRC / source).read_text()
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        typ, names, count = re.match(r"(.*?\W)(\w+(?:\s*,\s*\w+)*)(?:\[([\w:]+)\])?$", decl).groups()
        if count is None:
            n = 1
        elif count.isdigit():
            n = int(count)
        else:
            n = int(re.search(rf"constexpr int {count.split('::')[-1]} = (\d+);", text).group(1))
        out += [(typ.strip().replace(" ", ""), f.strip(), n) for f in names.split(",")]
    return out


@pytest.mark.parametrize("source,struct,mirror", [
    ("policy_general.cuh", "GeneralTrunk", cuda_general._TrunkC),
    ("policy_general.cu", "GeneralForwardArgs", cuda_general._ForwardArgsC),
    ("policy_general.cu", "GeneralLogpArgs", cuda_general._LogpArgsC),
    ("fused_epoch_general.cu", "GeneralEpochArgs", cuda_general._EpochArgsC),
    ("policy_resident.cuh", "ResidentTrunk", cuda_general._ResidentTrunkC),
    ("policy_resident.cuh", "ResidentArgs", cuda_general._ResidentArgsC),
])
def test_the_c_mirrors_are_the_sources_structs(source, struct, mirror):
    """Each ctypes mirror holds the C struct's fields in order, with the
    C type's size (an array's: its count times it)."""
    size = {"int": 4, "float": 4, "longlong": 8, "GeneralTrunk": ctypes.sizeof(cuda_general._TrunkC),
            "ResidentTrunk": ctypes.sizeof(cuda_general._ResidentTrunkC),
            "GeneralEpochTrunk": ctypes.sizeof(cuda_general._GeneralEpochTrunkC)}
    fields = _c_struct(source, struct)
    assert [n for _, n, _ in fields] == [n for n, _ in mirror._fields_]
    for (typ, _, count), (_, ctype) in zip(fields, mirror._fields_):
        assert ctypes.sizeof(ctype) == count * (8 if "*" in typ else size[typ.replace("const", "")])


def test_the_host_constants_are_the_headers():
    text = (cuda_build.CSRC / "policy_general.cuh").read_text()
    assert re.search(r"constexpr int BM = (\d+), BN = (\d+), BK = (\d+);", text).groups() == tuple(
        str(v) for v in (cuda_general.BM, cuda_general.BN, cuda_general.BK))
    assert f"constexpr int THREADS = {cuda_general.GEMM_THREADS};" in text
    assert all(cuda_general.wgrad_plan(rows, (64,), 132)[1] % cuda_general.BK == 0 for rows in (1, 1000, 8192))
    epoch = (cuda_build.CSRC / "fused_epoch_general.cu").read_text()
    assert f"constexpr int THREADS = {cuda_general._THREADS};" in epoch
    assert f"constexpr int LOGP_THREADS = {cuda_general._THREADS};" in (cuda_build.CSRC / "policy_general.cu").read_text()


@dataclasses.dataclass(frozen=True)
class _PaddedObs:
    """The packed hover env with its observation zero-padded to ``width``
    columns: a natively batched env past the wide and narrow kernels' obs
    width 64."""

    env: PackedQuadXHoverEnv
    width: int
    native_batch = True

    def __getattr__(self, name):
        return getattr(self.env, name)

    @property
    def obs_size(self) -> int:
        return self.width

    def _pad(self, obs):
        return torch.nn.functional.pad(obs, (0, self.width - obs.shape[-1]))

    def cached_autoreset_init(self, num_envs, generator=None):
        ars, obs = self.env.cached_autoreset_init(num_envs, generator)
        return ars, self._pad(obs)

    def cached_autoreset_step(self, ars, action, refresh=64):
        ars, out = self.env.cached_autoreset_step(ars, action, refresh)
        info = {**out.info, "terminal_observation": self._pad(out.info["terminal_observation"])}
        return ars, dataclasses.replace(out, obs=self._pad(out.obs), info=info)


def test_ppo_fused_sgd_on_the_cpu_at_obs_72():
    """``PPO(fused_sgd=True, fused_rollout_forward=True)`` trains at obs 72
    on the CPU (the twins), a general network on the card."""
    env = _PaddedObs(PackedQuadXHoverEnv(base=QuadXHoverEnv(device="cpu")), 72)
    cfg = PPOConfig(num_envs=16, rollout_steps=8, num_epochs=2, num_minibatches=2, cached_reset_refresh=64,
                    fused_sgd=True, fused_rollout_forward=True, feature_sizes=(48, 48))
    assert cuda_sgd._check_envelope(72, 4, cfg.feature_sizes, cfg.feature_sizes) == "general"
    tp = PPO(env, cfg)
    runner = tp.init(0)
    before = [p.detach().clone() for p in runner.network.parameters()]
    runner, metrics = tp.train_iteration(runner)
    assert runner.network.obs_dim == 72 and int(runner.opt_state.count) == 4
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert any(not torch.equal(a, b) for a, b in zip(before, runner.network.parameters()))
