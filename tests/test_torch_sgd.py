"""The port's SGD kernels' twins against the JAX package's Pallas kernels
(interpret mode) on the same numpy-seeded inputs: K3 ``logp_forward`` and
K2 ``fused_epoch``, in the kernels' bf16-input arithmetic and with every
matmul replaced by an f32 product on both sides; the flop counts, the C
struct mirrors, and Adam's state carried over from optax."""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pyflyt_tpu.ops import pallas_sgd
from pyflyt_tpu.rl import networks as jnet
from pyflyt_tpu_torch.convert import actor_critic_from_flax, adam_state_from_optax
from pyflyt_tpu_torch.ops import cuda_build, cuda_sgd

torch.set_num_threads(1)

OBS, ACT = 21, 4
FEAT = OBS + ACT + 3
H = (32, 32)
N_MB, MB = 2, 128  # two minibatches, two 64-row chunks each on the JAX side
HYPER = dict(learning_rate=1e-3, clip_eps=0.2, entropy_coef=0.01, value_coef=0.5, max_grad_norm=0.5)
T = torch.from_numpy


def _leaves(rng, pi_sizes=H, vf_sizes=H, obs=OBS):
    net = dict(obs_dim=obs, act_dim=ACT, pi_sizes=pi_sizes, vf_sizes=vf_sizes)
    shapes = [s for _, s in pallas_sgd._leaf_specs(net)]
    leaves = [(rng.normal(size=s) * 0.3).astype(np.float32) for s in shapes]
    mu = [(rng.normal(size=s) * 1e-3).astype(np.float32) for s in shapes]
    nu = [(np.abs(rng.normal(size=s)) * 1e-5).astype(np.float32) for s in shapes]
    return leaves, mu, nu


def _minibatches(rng, leaves, log_std_range, obs=OBS):
    """Rows whose stored log-probs sit near the policy's own, so ratios
    fall inside and outside the clip band."""
    feat = obs + ACT + 3
    mbs = rng.normal(size=(N_MB, MB, feat)).astype(np.float32)
    flat = mbs.reshape(-1, feat)
    n_pi = 2 * len(H) + 3
    own = cuda_sgd.logp_forward_plain(T(flat), [T(x) for x in leaves[:n_pi]], obs, log_std_range)
    flat[:, obs + ACT] = own.numpy() + rng.normal(size=flat.shape[0]).astype(np.float32) * 0.3
    adv = mbs[:, :, obs + ACT + 1]
    stats = np.stack([adv.mean(1), adv.std(1)], axis=1).astype(np.float32)  # ddof 0
    return mbs, stats


@pytest.fixture
def f32_matmuls(monkeypatch):
    """Both sides' kernel matmuls as plain f32 products."""
    dot = lambda dims: lambda a, b: jax.lax.dot_general(  # noqa: E731
        a, b, (dims, ((), ())), preferred_element_type=jnp.float32
    )
    monkeypatch.setattr(pallas_sgd, "_mm", dot(((1,), (0,))))
    monkeypatch.setattr(pallas_sgd, "_mm_tn", dot(((0,), (0,))))
    monkeypatch.setattr(pallas_sgd, "_mm_nt", dot(((1,), (1,))))
    monkeypatch.setattr(cuda_sgd, "_mm", lambda a, b: a @ b)
    monkeypatch.setattr(cuda_sgd, "_mm_tn", lambda a, b: a.T @ b)
    monkeypatch.setattr(cuda_sgd, "_mm_nt", lambda a, b: a @ b.T)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arith", ["bf16", "f32"])
@pytest.mark.parametrize("log_std_range", [None, (-0.4, 0.1)])
def test_logp_twin_matches_pallas_kernel(arith, log_std_range, request):
    """Both round the same bf16 inputs and sum in f32 in another order; a
    sum on a bf16 rounding boundary moves one activation by one bf16 ulp,
    which reaches the log-prob (|logp| ~ 10) far below 1e-4. With f32
    matmuls on both sides the rest is f32 rounding: 2e-5."""
    if arith == "f32":
        request.getfixturevalue("f32_matmuls")
    rng = np.random.default_rng(1)
    leaves, _, _ = _leaves(rng)
    leaves[6] = np.array([[-0.5, -0.2, 0.0, 0.3]], np.float32)  # two outside the range
    packed = rng.normal(size=(256, FEAT)).astype(np.float32)
    pi = leaves[: 2 * len(H) + 3]
    run = pallas_sgd.build_logp_forward(
        obs_dim=OBS, act_dim=ACT, pi_sizes=H, log_std_range=log_std_range, feat=FEAT,
        chunk=128, interpret=True,
    )
    want = np.asarray(run(jnp.asarray(packed), [jnp.asarray(x) for x in pi]))
    got = cuda_sgd.logp_forward(T(packed), [T(x) for x in pi], OBS, log_std_range, vf_sizes=H)
    assert got.shape == (256,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 if arith == "bf16" else 2e-5, rtol=0)


def test_logp_rejects_a_row_too_narrow():
    rng = np.random.default_rng(2)
    leaves, _, _ = _leaves(rng)
    with pytest.raises(ValueError, match="does not hold"):
        cuda_sgd.logp_forward(torch.zeros(4, OBS + 2), [T(x) for x in leaves[:7]], OBS, vf_sizes=H)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


def _run_both(rng, log_std_range, pi_sizes=H, vf_sizes=H, t0=7, leaves=None, obs=OBS):
    if leaves is None:
        leaves, mu, nu = _leaves(rng, pi_sizes, vf_sizes, obs)
    else:  # given leaves: log_std's moments start at 0, so a zero gradient keeps it still
        _, mu, nu = _leaves(rng, pi_sizes, vf_sizes, obs)
        mu[6][:] = 0.0
        nu[6][:] = 0.0
    mbs, stats = _minibatches(rng, leaves, log_std_range, obs) if pi_sizes == H else (None, None)
    if mbs is None:
        mbs = rng.normal(size=(N_MB, MB, FEAT)).astype(np.float32)
        adv = mbs[:, :, OBS + ACT + 1]
        stats = np.stack([adv.mean(1), adv.std(1)], axis=1).astype(np.float32)
    t0a = np.array([t0], np.int32)
    run = pallas_sgd.build_fused_epoch(
        obs_dim=obs, act_dim=ACT, pi_sizes=pi_sizes, vf_sizes=vf_sizes, log_std_range=log_std_range,
        num_minibatches=N_MB, minibatch_size=MB, feat=mbs.shape[-1], chunk=MB // 2, interpret=True, **HYPER,
    )
    J = lambda xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    jl, jm, jn, jmet = run(jnp.asarray(mbs), jnp.asarray(stats), jnp.asarray(t0a), J(leaves), J(mu), J(nu))
    cfg = cuda_sgd.EpochConfig(obs, ACT, pi_sizes, vf_sizes, log_std_range=log_std_range, **HYPER)
    P = lambda xs: [T(x.copy()) for x in xs]  # noqa: E731
    tl, tm, tn, tmet = cuda_sgd.fused_epoch(T(mbs), T(stats), T(t0a), P(leaves), P(mu), P(nu), cfg)
    return (leaves, mu, nu), (jl, jm, jn, np.asarray(jmet)), (tl, tm, tn, tmet.numpy())


@pytest.mark.parametrize(
    "arith,obs",
    [pytest.param("bf16", OBS, id="bf16"), pytest.param("f32", OBS, id="f32"),
     pytest.param("bf16", 33, id="bf16-obs33")],  # obs 33: the waypoints and rocket width
)
def test_fused_epoch_twin_matches_pallas_kernel(arith, obs, request):
    """Two minibatches with log_std_range and entropy_coef > 0 from seeded
    non-zero moments. ``mu_new - b1^2 mu`` carries the gradients
    themselves, so mu is held relative to the gradients' own size; params
    move by lr-scaled Adam steps. bf16: both sides round the same inputs
    and differ in f32 summation order, which can flip one bf16 rounding of
    an activation or a dz and move a gradient entry by ~1e-4 of the
    largest (hence 1e-3 on mu, 2e-3 relative on nu, and 2 steps x lr 1e-3
    x 2e-3 ~ 5e-6 on params). f32 matmuls: f32 rounding only."""
    if arith == "f32":
        request.getfixturevalue("f32_matmuls")
    rng = np.random.default_rng(3)
    (l0, mu0, _), (jl, jm, jn, jmet), (tl, tm, tn, tmet) = _run_both(rng, (-1.0, 0.2), obs=obs)
    tol = dict(bf16=dict(met=1e-4, mu=1e-3, nu=2e-3, p=5e-6), f32=dict(met=1e-5, mu=1e-5, nu=1e-4, p=1e-7))[arith]
    np.testing.assert_allclose(tmet, jmet, rtol=tol["met"], atol=tol["met"])
    for i, (a, b, m0) in enumerate(zip(tm, jm, mu0)):
        grad_part = np.asarray(b) - cuda_sgd.B1**N_MB * m0
        scale = np.abs(grad_part).max()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol["mu"] * scale, rtol=0, err_msg=f"mu {i}")
    for i, (a, b) in enumerate(zip(tn, jn)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol["nu"], atol=1e-12, err_msg=f"nu {i}")
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol["p"], rtol=0, err_msg=f"param {i}")
    assert any(np.abs(a.numpy() - p).max() > 1e-4 for a, p in zip(tl, l0)), "the params should move"


def test_fused_epoch_twin_takes_head_layers():
    """The twin takes any widths, as the Pallas kernel does: a 32-wide
    feature layer with (16, 8) policy and value head layers."""
    rng = np.random.default_rng(4)
    pi = vf = (32, 16, 8)
    _, (jl, _, _, jmet), (tl, _, _, tmet) = _run_both(rng, None, pi_sizes=pi, vf_sizes=vf)
    np.testing.assert_allclose(tmet, jmet, rtol=1e-4, atol=1e-4)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def test_fused_epoch_log_std_on_a_bound_gets_no_gradient():
    """Trap: the Pallas kernel masks the log_std gradient with strict
    inequalities, so a log_std exactly on a bound of its range gets none
    (jnp.clip would give it half) and, from zero moments, stays there for
    the whole epoch. Entries 0 and 3 sit on the bounds."""
    rng = np.random.default_rng(5)
    leaves, _, _ = _leaves(rng)
    leaves[6] = np.array([[-1.0, -0.3, 0.1, 0.2]], np.float32)
    (_, mu0, _), (jl, jm, _, _), (tl, tm, _, _) = _run_both(rng, (-1.0, 0.2), leaves=leaves)
    g_t = tm[6].numpy() - cuda_sgd.B1**N_MB * np.asarray(mu0[6])
    g_j = np.asarray(jm[6]) - cuda_sgd.B1**N_MB * np.asarray(mu0[6])
    np.testing.assert_allclose(g_t, g_j, atol=1e-6)
    assert g_t[0, 0] == 0.0 and g_t[0, 3] == 0.0 and abs(g_t[0, 1]) > 1e-5
    np.testing.assert_allclose(tl[6].numpy(), np.asarray(jl[6]), atol=1e-7)
    assert tl[6][0, 0] == -1.0 and tl[6][0, 3] == 0.2


def test_fused_epoch_returns_fresh_tensors():
    rng = np.random.default_rng(6)
    leaves, mu, nu = _leaves(rng)
    mbs, stats = _minibatches(rng, leaves, None)
    cfg = cuda_sgd.EpochConfig(OBS, ACT, H, H, **HYPER)
    tl = [T(x.copy()) for x in leaves]
    out = cuda_sgd.fused_epoch(T(mbs), T(stats), torch.tensor([0], dtype=torch.int32), tl,
                               [T(x) for x in mu], [T(x) for x in nu], cfg)
    for a, b in zip(tl, leaves):
        np.testing.assert_array_equal(a.numpy(), b)
    assert out[3].shape == (N_MB, len(cuda_sgd.METRICS))
    with pytest.raises(ValueError, match="shapes of leaf_specs"):
        cuda_sgd.fused_epoch(T(mbs), T(stats), torch.zeros(1, dtype=torch.int32), tl[:-1], tl, tl, cfg)


def test_flat_layout_aligns_each_leaf():
    shapes = [(21, 256), (1, 256), (256, 3), (1, 3), (1, 3), (256, 1), (1, 1)]
    offsets, P = cuda_sgd.flat_layout(shapes)
    assert offsets == [0, 5376, 5632, 6400, 6404, 6408, 6664] and P == 6668
    leaves = [torch.randn(s) for s in shapes]
    flat = cuda_sgd._to_flat(leaves, offsets, P)
    back = cuda_sgd._from_flat(flat, shapes, offsets)
    for a, b in zip(leaves, back):
        assert torch.equal(a, b)
    again = cuda_sgd._to_flat(back, offsets, P)
    assert torch.equal(again, flat) and again.data_ptr() != flat.data_ptr()


# ---------------------------------------------------------------------------
# counts, structs, envelope
# ---------------------------------------------------------------------------


def test_flop_counts_at_8192_rows():
    """Hand count at the main path's shapes (obs 21, act 4, 2 x 256): the
    actor forward is 21*256 + 256*256 + 256*4 = 71,936 MACs a row; the
    epoch does forward (143,104 MACs: both trunks and heads) twice over
    (forward and weight gradient) plus the data gradients of the heads and
    the second layers (1,024 + 65,536 + 256 + 65,536 = 132,352)."""
    assert cuda_sgd.logp_flops(8192, 21, 4) == 2 * 8192 * 71_936 == 1_178_599_424
    assert cuda_sgd.epoch_flops(8192, 21, 4) == 2 * 8192 * (2 * 143_104 + 132_352) == 6_857_687_040


def _c_fields(source: str, struct: str):
    body = re.search(rf"struct {struct} \{{(.*?)\}};", (cuda_build.CSRC / source).read_text(), re.S).group(1)
    fields = []
    for ctype, ptr, name, n in re.findall(r"^\s*(?:const )?(\w+)(\*?) (\w+)(?:\[(\w+)\])?;", body, re.M):
        kind = "ptr" if ptr else {"float": "float", "int": "int"}[ctype]
        fields.append((name, kind, 13 if n == "N_LEAVES" else int(n or 1)))
    return fields


def _py_fields(cls):
    out = []
    for name, t in cls._fields_:
        n, base = (t._length_, t._type_) if issubclass(t, ctypes.Array) else (1, t)
        kind = {ctypes.c_void_p: "ptr", ctypes.c_float: "float", ctypes.c_int: "int"}[base]
        out.append((name, kind, n))
    return out


@pytest.mark.parametrize(
    "source,struct,cls",
    [
        ("policy_value_forward.cu", "LogpArgs", cuda_sgd._LogpArgsC),
        ("fused_epoch.cu", "EpochArgs", cuda_sgd._EpochArgsC),
    ],
)
def test_ctypes_mirrors_match_the_c_structs(source, struct, cls):
    assert _py_fields(cls) == _c_fields(source, struct)


@pytest.mark.parametrize(
    "obs,act,pi,err",
    [(21, 4, (256, 256), None), (65, 4, (256, 256), "obs width"), (21, 9, (256, 256), "action width"),
     (21, 4, (256,), "two 256-wide"), (21, 4, (128, 128), None), (21, 4, (160, 160), "two 256-wide"),
     (19, 4, (64, 64, 32, 32, 16), "two 256-wide")],
)
def test_kernel_envelope(obs, act, pi, err):
    """Two 256-wide layers route to the wgmma kernels, 1-4 layers of at most
    128 units to the narrow family; anything else to the general family,
    which the wide family's own check refuses, naming why (``err``)."""
    if err is None:
        want = "wide" if tuple(pi) == (256, 256) else "narrow"
        assert cuda_sgd._check_envelope(obs, act, pi, pi) == want
    else:
        assert cuda_sgd._check_envelope(obs, act, pi, pi) == "general"
        with pytest.raises(NotImplementedError, match=err):
            cuda_sgd.check_family("wide", obs, act, pi, pi)


def test_cpu_tensors_count_no_launch():
    rng = np.random.default_rng(7)
    leaves, mu, nu = _leaves(rng)
    mbs, stats = _minibatches(rng, leaves, None)
    before = (cuda_sgd.LOGP_KERNEL.launches, cuda_sgd.EPOCH_KERNEL.launches)
    cfg = cuda_sgd.EpochConfig(OBS, ACT, H, H, **HYPER)
    cuda_sgd.fused_epoch(T(mbs), T(stats), torch.zeros(1, dtype=torch.int32),
                         [T(x) for x in leaves], [T(x) for x in mu], [T(x) for x in nu], cfg)
    assert (cuda_sgd.LOGP_KERNEL.launches, cuda_sgd.EPOCH_KERNEL.launches) == before


# ---------------------------------------------------------------------------
# leaves and Adam's state from the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flax_net():
    net = jnet.ActorCritic(action_dim=ACT, feature_sizes=(16, 8), pi_sizes=(4,), init_log_std=-0.5)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    return params, actor_critic_from_flax(jax.tree.map(np.asarray, params), device="cpu")


def test_leaves_round_trip_through_the_network(flax_net):
    params, tp = flax_net
    want = [np.asarray(x) for x in pallas_sgd.params_to_leaves(params)]
    got = cuda_sgd.params_to_leaves(tp)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    shifted = [t.detach() + 1.0 for t in got]
    cuda_sgd.leaves_to_params(shifted, tp)
    try:
        for a, b in zip(cuda_sgd.params_to_leaves(tp), want):
            np.testing.assert_allclose(a.detach().numpy(), b + 1.0)
    finally:
        cuda_sgd.leaves_to_params([torch.tensor(b) for b in want], tp)


@pytest.mark.parametrize("layout", ["per_leaf", "flat"])
def test_adam_state_from_optax(flax_net, layout):
    """optax's Adam state in both layouts the JAX PPO builds: per param
    leaf (fused_sgd) and one ``optax.flatten`` vector (default path)."""
    params, tp = flax_net
    base = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4, eps=1e-5))
    rng = np.random.default_rng(8)
    rand = lambda tree: jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), tree)  # noqa: E731
    mu, nu = rand(params), rand(params)
    state = base.init(params)
    adam = state[1][0]._replace(count=jnp.asarray(37, jnp.int32), mu=mu, nu=nu)
    if layout == "flat":
        state = optax.flatten(base).init(params)
        adam = state[1][0]._replace(count=jnp.asarray(37, jnp.int32), mu=ravel_pytree(mu)[0], nu=ravel_pytree(nu)[0])
    state = (state[0], (adam, state[1][1]))
    got = adam_state_from_optax(jax.tree.map(np.asarray, state), tp, device="cpu")
    assert int(got.count) == 37 and got.count.dtype == torch.int32
    for a, b in zip(got.mu, pallas_sgd.params_to_leaves(mu)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got.nu, pallas_sgd.params_to_leaves(nu)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
