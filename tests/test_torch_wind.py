"""The port's wind fields (``pyflyt_tpu_torch/core/wind.py``) against the JAX
package's ``pyflyt_tpu.core.wind``.

Deterministic parts are held exactly or to f32 rounding: a given base with
``max_gust=0`` (ENU and NED), the NED→ENU remap, the thermal of
``SimpleWind``. The random streams differ by design (threefry against a
``torch.Generator``), so the base draw and the gusts are held by their
distribution: bounds, means within 5 standard errors, standard deviations
within 5%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyflyt_tpu.core import wind as jwind
from pyflyt_tpu_torch.core import wind as twind

torch.set_num_threads(1)

N = 64
RNG = np.random.default_rng(0)


def _pos(n=N):
    p = RNG.uniform(-5.0, 5.0, size=(n, 3)).astype(np.float32)
    p[:, 2] = RNG.uniform(-2.0, 30.0, size=n)  # some below z = -1: no thermal
    return p


@pytest.mark.parametrize("conv", ["ENU_FLU", "NED_FRD"])
def test_given_base_without_gusts_matches_jax(conv):
    """Per-env bases, max_gust=0: the field is the base, remapped to ENU for
    a NED env, exactly as the JAX field (which draws a gust and clips it to
    zero)."""
    base = RNG.uniform(-7.0, 7.0, size=(N, 3)).astype(np.float32)
    pos = _pos()
    jw = jwind.GaussianWind.init(jax.random.PRNGKey(1), base_wind=jnp.asarray(base), max_gust=0.0, orn_conv=conv)
    tw = twind.GaussianWind.init(None, N, base_wind=torch.from_numpy(base), max_gust=0.0, orn_conv=conv, device="cpu")
    ref = np.asarray(jw(jnp.int32(3), jnp.asarray(pos)))
    got = tw(torch.tensor(3), torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tw.base_enu().numpy(), ref)


def test_ned_remap_swaps_xy_and_negates_z():
    w = torch.tensor([[1.0, 2.0, 3.0]])
    np.testing.assert_array_equal(twind.ned_to_enu(w).numpy(), [[2.0, 1.0, -3.0]])
    tw = twind.GaussianWind.init(None, 2, base_wind=(1.0, 2.0, 3.0), max_gust=0.0, orn_conv="NED_FRD", device="cpu")
    np.testing.assert_array_equal(tw(torch.tensor(0), torch.zeros(2, 3)).numpy(), [[2.0, 1.0, -3.0]] * 2)


def test_a_single_base_broadcasts_to_every_env():
    tw = twind.GaussianWind.init(None, 5, base_wind=(5.0, -5.0, -1.0), max_gust=0.0, device="cpu")
    assert tw.base_wind.shape == (5, 3)
    np.testing.assert_array_equal(tw.base_wind.numpy(), np.tile([5.0, -5.0, -1.0], (5, 1)).astype(np.float32))


def test_base_draw_follows_the_jax_distribution():
    """U([-7,-7,-2], [7,7,2]) per env: the port's draws and the JAX
    package's (one key per env, as its vmapped reset) share bounds and
    moments."""
    n = 4096
    tw = twind.GaussianWind.init(torch.Generator().manual_seed(0), n, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jb = np.asarray(jax.vmap(lambda k: jwind.GaussianWind.init(k).base_wind)(keys))
    tb = tw.base_wind.numpy()
    hi = np.array(twind.BASE_HIGH)
    for b in (tb, jb):
        assert (b >= -hi).all() and (b <= hi).all()
    se = hi / np.sqrt(3.0) / np.sqrt(n)  # std of U(-h, h) is h/sqrt(3)
    assert (np.abs(tb.mean(0)) < 5 * se).all() and (np.abs(jb.mean(0)) < 5 * se).all()
    np.testing.assert_allclose(tb.std(0), jb.std(0), rtol=0.05)
    np.testing.assert_allclose(tb.std(0), hi / np.sqrt(3.0), rtol=0.05)
    assert np.abs(np.corrcoef(tb.T) - np.eye(3)).max() < 0.1


@pytest.mark.parametrize("max_gust", [7.0, 0.5])
def test_gusts_follow_the_jax_distribution(max_gust):
    """base + clip(N(0, 1), ±max_gust), a fresh draw per call: over 4096 x 3
    draws the port's gusts and the JAX field's share bounds, a zero mean and
    the clipped normal's std; two calls differ."""
    n = 4096
    base = np.zeros((n, 3), np.float32)
    tw = twind.GaussianWind.init(torch.Generator().manual_seed(1), n, base_wind=torch.from_numpy(base),
                                 max_gust=max_gust, device="cpu")
    jw = jwind.GaussianWind.init(jax.random.PRNGKey(2), base_wind=jnp.asarray(base), max_gust=max_gust)
    pos = torch.zeros(n, 3)
    tg = tw(torch.tensor(0), pos).numpy()
    jg = np.asarray(jw(jnp.int32(0), jnp.zeros((n, 3))))
    for g in (tg, jg):
        assert np.abs(g).max() <= max_gust
        assert np.abs(g.mean()) < 5 * g.std() / np.sqrt(g.size)
    np.testing.assert_allclose(tg.std(), jg.std(), rtol=0.05)
    if max_gust > 5:
        np.testing.assert_allclose(tg.std(), 1.0, rtol=0.05)
    assert not np.array_equal(tg, tw(torch.tensor(1), pos).numpy())


def test_simple_wind_thermal_matches_jax():
    """The log-height thermal (zero below z = -1) is the JAX field's; the
    unit noise on top is subtracted with each side's own draw."""
    pos = _pos()
    gen = torch.Generator().manual_seed(3)
    tw = twind.SimpleWind(generator=gen, strength=1.5)
    replay = torch.Generator().manual_seed(3)
    t_thermal = tw(torch.tensor(0), torch.from_numpy(pos)) - torch.randn(pos.shape, generator=replay)
    key = jax.random.PRNGKey(4)
    jw = jwind.SimpleWind(key=key, strength=jnp.asarray(1.5))
    j_thermal = jw(jnp.int32(5), jnp.asarray(pos)) - jax.random.normal(jax.random.fold_in(key, 5), pos.shape)
    np.testing.assert_allclose(t_thermal.numpy(), np.asarray(j_thermal), atol=1e-5)
    assert (t_thermal[:, 2] != 0).any() and (np.asarray(j_thermal)[:, :2] == 0).all()


def test_constant_wind_broadcasts():
    v = torch.tensor([1.0, -2.0, 0.5])
    got = twind.ConstantWind(v)(torch.tensor(0), torch.zeros(4, 3))
    ref = jwind.ConstantWind(jnp.asarray(v.numpy()))(jnp.int32(0), jnp.zeros((4, 3)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_stochastic_fields_need_a_generator():
    with pytest.raises(ValueError, match="Generator"):
        twind.GaussianWind.init(None, 4, device="cpu")  # the base draw
    tw = twind.GaussianWind.init(None, 4, base_wind=(0.0, 0.0, 0.0), max_gust=1.0, device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        tw(torch.tensor(0), torch.zeros(4, 3))
