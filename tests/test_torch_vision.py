"""The port's ray-cast camera, OBJ loader, render boxes and
``VisionActorCritic`` against the JAX package's (``pyflyt_tpu.core.camera``,
``core/load_objs``, the envs' ``scene_boxes``, ``rl/networks``).

Inputs come from numpy seeds. The JAX side runs three jitted programs: the
render cases (one program, all batched by ``vmap``), the networks' forward
passes (two image sizes and the archived r4 policy) and one minibatch's
``jax.grad`` of the PPO loss.

Tolerances:
- the render: the segmentation and the bytes differ on at most 0.5% of the
  pixels, each a pixel with a JAX neighbour of another segment or colour
  (an edge flipped by f32 rounding of a ray, not a shift); where the
  segmentation agrees, depth within 1e-5;
- the networks: mean and value within 1e-5 (f32 convs and matmuls summed
  in other orders);
- the gradient: rtol 1e-4, and an absolute 1e-4 of the leaf's largest
  entry for entries near zero;
- the OBJ boxes, the npz and the render boxes: equal.
"""

import dataclasses
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _render_check import assert_edge_flips_only

from pyflyt_tpu.core import camera as jcam
from pyflyt_tpu.core import load_objs as jlo
from pyflyt_tpu.envs.fixedwing_waypoints import FixedwingWaypointsEnv as JFixedwingWaypoints
from pyflyt_tpu.envs.ma_fixedwing_dogfight import MAFixedwingDogfightEnv as JDogfight
from pyflyt_tpu.envs.quadx_gates import QuadXGatesEnv as JGates
from pyflyt_tpu.envs.quadx_waypoints import QuadXWaypointsEnv as JWaypoints
from pyflyt_tpu.envs.rocket_landing import RocketLandingEnv as JRocket
from pyflyt_tpu.rl import PPO as JPPO
from pyflyt_tpu.rl import PPOConfig as JPPOConfig
from pyflyt_tpu.rl import checkpoint as jckpt
from pyflyt_tpu.rl.networks import VisionActorCritic as JVision
from pyflyt_tpu_torch.convert import vision_actor_critic_from_flax
from pyflyt_tpu_torch.core import camera as tcam
from pyflyt_tpu_torch.core import load_objs as tlo
from pyflyt_tpu_torch.core import math as tpm
from pyflyt_tpu_torch.envs import (
    FixedwingWaypointsEnv,
    MAFixedwingDogfightEnv,
    QuadXGatesEnv,
    QuadXWaypointsEnv,
    RocketLandingEnv,
)
from pyflyt_tpu_torch.rl import PPO, PPOConfig
from pyflyt_tpu_torch.rl import checkpoint as tckpt
from pyflyt_tpu_torch.rl.networks import VisionActorCritic, same_pads

torch.set_num_threads(1)

B = 8  # envs a render case
RES = (20, 20)
GATES = 3
OFFSET = (-2.0, 0.0, 1.0)  # the tracking / cinematic eye, in the link frame
DEPTH_ATOL = 1e-5
NET_ATOL = 1e-5
GRAD_RTOL = 1e-4
ARCHIVE = "docs/artifacts/policies_gates_vision_r4/best_model_800_149_25_485_2"


def _f32(a):
    return np.asarray(a, dtype=np.float32)


# ---------------------------------------------------------------------------
# the render
# ---------------------------------------------------------------------------


def _scene(seed: int, b: int = B):
    """Eyes with random attitudes and, per env, GATES gates 1-3 m ahead of
    each eye in its view, turned so their openings roughly face it; two
    shared, rotated solid boxes."""
    rng = np.random.default_rng(seed)
    eye = rng.uniform(-3, 3, (b, 3))
    eye[:, 2] += 3.0
    look = rng.uniform(-0.5, 0.5, (b, 3))
    R = tpm.euler_to_rotmat(torch.tensor(_f32(look))).numpy()
    local = np.stack([rng.uniform(1.0, 3.0, (b, GATES)), rng.uniform(-1, 1, (b, GATES)),
                      rng.uniform(-1, 1, (b, GATES))], -1)
    gpos = eye[:, None, :] + np.einsum("bij,bgj->bgi", R, local)
    geul = look[:, None, :] + rng.uniform(-0.6, 0.6, (b, GATES, 3))
    geul[..., 2] += np.pi / 2
    gcol = rng.uniform(0, 1, (b, GATES, 4))
    solid = dict(centers=rng.uniform(-2, 2, (2, 3)) + [0, 0, 2], half_extents=rng.uniform(0.2, 0.8, (2, 3)),
                 rotations=tpm.euler_to_rotmat(torch.tensor(_f32(rng.uniform(-1, 1, (2, 3))))).numpy(),
                 colors=rng.uniform(0, 1, (2, 4)))
    return {k: _f32(v) for k, v in dict(eye=eye, look=look, gpos=gpos, geul=geul, gcol=gcol).items()}, \
        {k: _f32(v) for k, v in solid.items()}


CASES = ("fpv_holed", "gimbal_bars", "tracking_offset_mixed", "cinematic_offset_solid_holed")


def _cases(cam, solid, s, batched):
    """The four render cases of ``cam`` (either package's camera module):
    (FPV tilted 20°, holed gates), (gimbal 30°, the gates' bars, which share
    rotations), (tracking from the link-frame offset, ``concat_boxes`` of
    the shared solid boxes, the holed gates and the bars), (FPV from the
    cinematic offset, the solid boxes and the holed gates)."""
    holed = cam.gate_boxes(s["gpos"], s["geul"], s["gcol"])
    bars = cam.gate_boxes_segments(s["gpos"], s["geul"], s["gcol"])
    eye, look = s["eye"], s["look"]
    off = OFFSET if batched else jnp.asarray(OFFSET)
    return (
        cam.capture_image(eye, look, holed, RES, camera_angle_degrees=20.0),
        cam.capture_image(eye, look, bars, RES, camera_angle_degrees=30.0, use_gimbal=True),
        cam.capture_image(eye, look, cam.concat_boxes(solid, holed, bars), RES, position_offset=off,
                          is_tracking=True),
        cam.capture_image(eye, look, cam.concat_boxes(solid, holed), RES, position_offset=off, cinematic=True),
    )


@pytest.fixture(scope="module")
def renders():
    s, solid = _scene(1)
    jsolid = jcam.Boxes(**{k: jnp.asarray(v) for k, v in solid.items()}, visible=jnp.ones((2,), bool))
    ref = jax.jit(jax.vmap(lambda e, lk, p, u, c: _cases(
        jcam, jsolid, dict(eye=e, look=lk, gpos=p, geul=u, gcol=c), False)))(
        *(jnp.asarray(s[k]) for k in ("eye", "look", "gpos", "geul", "gcol")))
    tsolid = tcam.Boxes(**{k: torch.tensor(v) for k, v in solid.items()}, visible=torch.ones(2, dtype=torch.bool))
    got = _cases(tcam, tsolid, {k: torch.tensor(v) for k, v in s.items()}, True)
    return [tuple(np.asarray(x) for x in r) for r in ref], [tuple(x.numpy() for x in g) for g in got]


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASES)
def test_render_matches_jax(renders, case):
    (jr, jd, js), (tr, td, ts) = renders[0][case], renders[1][case]
    assert tr.shape == (B, *RES, 4) and tr.dtype == np.uint8 and ts.dtype == np.int32 and td.shape == (B, *RES)
    assert_edge_flips_only(jr, tr, js, ts)
    same = js == ts
    np.testing.assert_allclose(td[same], jd[same], atol=DEPTH_ATOL, rtol=0)
    # the scene is seen: sky, ground and boxes all in the image
    assert (js == -1).any() and (js == 0).any() and (js > 0).sum() > B * 5


def test_sky_and_gate_colours_byte_for_byte(renders):
    """178/255·255 rounds to 177.99998 in f32 and truncates to 177, as the
    JAX module's cast does; the palette's bytes are JAX's."""
    (jr, _, js), (tr, _, ts) = renders[0][0], renders[1][0]
    sky = (js == -1) & (ts == -1)
    np.testing.assert_array_equal(tr[sky], jr[sky])
    assert set(map(tuple, tr[sky].tolist())) == set(map(tuple, jr[sky].tolist()))
    gates = (js > 0) & (js == ts)
    np.testing.assert_array_equal(tr[gates], jr[gates])


def test_holed_gate_renders_as_its_four_bars():
    """``gate_boxes`` (one holed box a gate) against ``gate_boxes_segments``
    (four bars sharing a rotation), 6 views of their own gates, in the port alone:
    the same bytes, depth within 1e-5, the bars' segments mapped to their
    gate's."""
    s, _ = _scene(7, b=6)
    pos, eul, colors, eye, look = (torch.tensor(s[k]) for k in ("gpos", "geul", "gcol", "eye", "look"))
    rh, dh, sh = tcam.capture_image(eye, look, tcam.gate_boxes(pos, eul, colors), resolution=(48, 48))
    rb, db, sb = tcam.capture_image(eye, look, tcam.gate_boxes_segments(pos, eul, colors), resolution=(48, 48))
    assert (sh > 0).sum() > 200
    torch.testing.assert_close(rh, rb, rtol=0, atol=0)
    torch.testing.assert_close(dh, db, rtol=0, atol=1e-5)
    torch.testing.assert_close(sh, torch.where(sb > 0, (sb - 1) // 4 + 1, sb))


def test_materialize_and_concat_shapes():
    """Rotations expand by ``rot_index``; a shared scene broadcasts over a
    per-env one; solid boxes get a zero hole."""
    s, solid = _scene(3, b=2)
    bars = tcam.gate_boxes_segments(*(torch.tensor(s[k]) for k in ("gpos", "geul", "gcol")))
    mat = tcam.materialize_rotations(bars)
    assert mat.rot_index is None and mat.rotations.shape == (2, 4 * GATES, 3, 3)
    torch.testing.assert_close(mat.rotations[:, 5], bars.rotations[:, 1])
    shared = tcam.Boxes(**{k: torch.tensor(v) for k, v in solid.items()}, visible=torch.ones(2, dtype=torch.bool))
    cat = tcam.concat_boxes(shared, tcam.gate_boxes(*(torch.tensor(s[k]) for k in ("gpos", "geul", "gcol"))))
    assert cat.centers.shape == (2, 2 + GATES, 3) and cat.hole_half.shape == (2, 2 + GATES, 2)
    assert (cat.hole_half[:, :2] == 0).all() and (cat.hole_half[:, 2:] == 0.2).all()


# ---------------------------------------------------------------------------
# load_objs
# ---------------------------------------------------------------------------

CUBE_OBJ = textwrap.dedent(
    """
    v 0 0 0
    v 1 0 0
    v 1 1 0
    v 0 1 0
    v 0 0 1
    v 1 0 1
    v 1 1 1
    v 0 1 1
    f 1 4 3 2
    f 5 6 7 8
    f 1 2 6 5
    f 2 3 7 6
    f 3 4 8 7
    f 4 1 5 8
    """
)


def _l_shape_obj() -> str:
    """A 2x1x1 slab with a 1x1x1 cube on its first half (tests/test_load_objs.py's L)."""
    verts, faces = [], []
    for lo, hi in (((0, 0, 0), (2, 1, 1)), ((0, 0, 1), (1, 1, 2))):
        base = len(verts)
        for sx in (0, 1):
            for sy in (0, 1):
                for sz in (0, 1):
                    verts.append(tuple(lo[k] + s * (hi[k] - lo[k]) for k, s in enumerate((sx, sy, sz))))
        for tri in [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),
                    (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]:
            faces.append(tuple(base + t for t in tri))
    return "\n".join([f"v {x} {y} {z}" for x, y, z in verts] + [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in faces])


@pytest.mark.parametrize("mesh", ["cube", "l_shape", "multi_object"])
def test_load_obj_boxes_match_jax(tmp_path, mesh):
    cube, lshape = tmp_path / "cube.obj", tmp_path / "l.obj"
    cube.write_text(CUBE_OBJ)
    lshape.write_text(_l_shape_obj())

    def load(mod, **dev):
        if mesh == "cube":
            return mod.loadOBJ(str(cube), resolution=16, **dev)
        if mesh == "l_shape":
            return mod.loadOBJ(str(lshape), base_position=(1.0, -0.5, 0.0), resolution=12, **dev)
        a = mod.loadOBJ(str(cube), base_position=(5.0, 0.0, 0.0), base_orientation=(0.0, 0.0, np.pi / 2),
                        resolution=8, color=(0.1, 0.2, 0.3, 1.0), **dev)
        b = mod.loadOBJ(str(lshape), base_position=(0.0, 5.0, 0.0), base_orientation=(0.0, 0.0, 0.3826834, 0.9238795),
                        resolution=10, existing=a, **dev)
        return mod.merge_boxes(b, mod.loadOBJ(str(cube), mesh_scale=2.0, resolution=6, **dev))

    want, got = load(jlo), load(tlo, device="cpu")
    for f in ("centers", "half_extents", "rotations", "colors", "visible"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    assert got.rot_index is None and got.hole_half is None and got.centers.dtype == torch.float32
    with pytest.raises(ValueError, match="static"):
        tlo.loadOBJ(str(cube), base_mass=1.0, device="cpu")


# ---------------------------------------------------------------------------
# the envs' render boxes
# ---------------------------------------------------------------------------


def _waypoint_inputs(rng, n_env, n):
    return dict(targets=rng.uniform(-4, 4, (n_env, n, 3)), idx=rng.integers(0, n + 1, n_env).astype(np.int32))


SCENES = {
    # name: (JAX env, port env, the state fields it reads, how to reach the method)
    "quadx_waypoints": (JWaypoints, QuadXWaypointsEnv, lambda rng: {"wp": _waypoint_inputs(rng, 5, 4)}),
    "fixedwing_waypoints": (JFixedwingWaypoints, FixedwingWaypointsEnv,
                            lambda rng: {"wp": _waypoint_inputs(rng, 5, 4)}),
    "rocket_landing": (JRocket, RocketLandingEnv, lambda rng: {"pad_position": rng.uniform(-3, 3, (5, 3))}),
    "dogfight": (JDogfight, MAFixedwingDogfightEnv, lambda rng: {
        "drones": {"read": {"view": rng.uniform(-2, 2, (5, 2, 4, 3))}},
        "current_hits": rng.uniform(size=(5, 2)) < 0.5, "alive": rng.uniform(size=(5, 2)) < 0.7}),
    "gates": (JGates, QuadXGatesEnv, lambda rng: {
        "gate_positions": rng.uniform(-4, 4, (5, GATES, 3)), "gate_eulers": rng.uniform(-1, 1, (5, GATES, 3)),
        "idx": rng.integers(0, GATES, 5).astype(np.int32)}),
}


def _ns(tree, leaf):
    return types.SimpleNamespace(**{k: _ns(v, leaf) if isinstance(v, dict) else leaf(v) for k, v in tree.items()})


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_boxes_match_jax(name):
    """Each env's ``scene_boxes`` (the waypoint markers, the landing pad,
    the gunsight markers, the gates) field by field against the JAX env's
    on the same state fields, each JAX env ``vmap``-ed over 5 envs."""
    jenv_cls, tenv_cls, make = SCENES[name]
    fields = make(np.random.default_rng(11))
    kw = {"num_targets": GATES} if name == "gates" else {}
    jenv, tenv = jenv_cls(**kw), tenv_cls(device="cpu", **kw)
    to_j = lambda v: jnp.asarray(_f32(v) if np.asarray(v).dtype == np.float64 else v)  # noqa: E731
    to_t = lambda v: torch.tensor(_f32(v) if np.asarray(v).dtype == np.float64 else v)  # noqa: E731
    want = jax.vmap(lambda tree: jenv.scene_boxes(_ns(tree, lambda x: x)))(jax.tree.map(to_j, fields))
    got = tenv.scene_boxes(_ns(fields, to_t))
    for f in dataclasses.fields(tcam.Boxes):
        w, g = getattr(want, f.name), getattr(got, f.name)
        assert (w is None) == (g is None), f.name
        if g is None:
            continue
        g = g.expand(np.shape(w)) if g.dim() < np.ndim(w) else g  # a field the port shares over the batch
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0, err_msg=f"{name}: {f.name}")


# ---------------------------------------------------------------------------
# VisionActorCritic
# ---------------------------------------------------------------------------

VEC = (21, 15)  # the gates obs' attitude before the image and deltas after it
NETS = {
    "odd_15px": dict(image_shape=(4, 15, 15), conv_features=(8, 16), feature_sizes=(32,), pi_sizes=(16,)),
    "even_16px": dict(image_shape=(4, 16, 16), conv_features=(8, 16, 16), feature_sizes=(24,)),
}


def _net_obs(image_shape, n, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, int(np.prod(image_shape)))).astype(np.float32)
    return np.concatenate([rng.normal(size=(n, VEC[0])), img, rng.normal(size=(n, VEC[1]))], 1).astype(np.float32)


def _jax_net(spec):
    return JVision(action_dim=4, image_offset=VEC[0], init_log_std=-0.5, **spec)


def _param_shapes(net, width):
    """The flax param tree's shapes, traced without compiling an init."""
    return jax.eval_shape(net.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, width), jnp.float32))


def _random_params(net, width, seed):
    """Flax params of ``net`` drawn with numpy: kernels N(0, 1/fan_in),
    biases N(0, 0.1²), ``log_std`` N(−0.5, 0.1²)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return _f32(rng.normal(scale=np.prod(leaf.shape[:-1]) ** -0.5, size=leaf.shape))
        return _f32(rng.normal(loc=-0.5 if "log_std" in name else 0.0, scale=0.1, size=leaf.shape))

    return jax.tree_util.tree_map_with_path(draw, _param_shapes(net, width))


def _archive_net():
    net = _jax_net(dict(image_shape=(4, 32, 32), conv_features=(16, 32, 32), feature_sizes=(128,)))
    shapes = _param_shapes(net, VEC[0] + 4 * 32 * 32 + 5 * 3)
    return net, jax.tree.map(np.asarray, jckpt.restore_params(ARCHIVE, shapes))


@pytest.fixture(scope="module")
def nets():
    """Flax params (random for NETS, the archived r4 policy's), the obs, and
    the JAX outputs of all three in one jitted program."""
    out = {}
    for i, (name, spec) in enumerate(NETS.items()):
        obs = _net_obs(spec["image_shape"], 9, seed=20 + i)
        out[name] = (_jax_net(spec), _random_params(_jax_net(spec), obs.shape[1], seed=40 + i), obs)
    net, params = _archive_net()
    env = QuadXGatesEnv(device="cpu", camera_resolution=(32, 32), noisy_motors=False)
    state, obs = env.reset(6, torch.Generator().manual_seed(5))
    from pyflyt_tpu_torch.rl.ppo import _flat_obs

    obs = _flat_obs(obs).numpy()
    obs[3:, VEC[0] : VEC[0] + 4096] = _net_obs((4, 32, 32), 3, seed=29)[:, VEC[0] : VEC[0] + 4096]
    out["r4"] = (net, params, obs)
    applied = jax.jit(lambda ps, xs: [out[k][0].apply(p, x) for k, p, x in zip(out, ps, xs)])(
        [out[k][1] for k in out], [jnp.asarray(out[k][2]) for k in out])
    return {k: (*out[k], [np.asarray(a) for a in applied[i]]) for i, k in enumerate(out)}


def test_same_padding_is_xla_s():
    """Even sizes pad 0 before and 1 after, odd ones 1 and 1."""
    assert [same_pads(s) for s in (32, 16, 8, 4, 2, 15, 9, 7, 1)] == [(0, 1)] * 5 + [(1, 1)] * 3 + [(1, 1)]


@pytest.mark.parametrize("name", list(NETS))
def test_vision_net_matches_flax(nets, name):
    """The padding trap: at an even size torch's ``padding=1`` would shift
    the output a pixel; at an odd size both pad 1 and 1."""
    _, params, obs, (mean, log_std, value) = nets[name]
    spec = NETS[name]
    net = vision_actor_critic_from_flax(params, VEC[0], spec["image_shape"], device="cpu")
    assert [c.out_channels for c in net.convs] == list(spec["conv_features"]) and net.obs_dim == obs.shape[1]
    with torch.no_grad():
        m, s, v = net(torch.tensor(obs))
    np.testing.assert_allclose(m.numpy(), mean, atol=NET_ATOL, rtol=0)
    np.testing.assert_allclose(v.numpy(), value, atol=NET_ATOL, rtol=0)
    np.testing.assert_array_equal(s.detach().numpy(), log_std)
    # rank generic: a (3, 3, obs) batch as the flat (9, obs) one
    with torch.no_grad():
        m2, _, v2 = net(torch.tensor(obs).reshape(3, 3, -1))
    torch.testing.assert_close(m2.reshape(9, -1), m, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(v2.reshape(9), v, rtol=1e-6, atol=1e-6)


def test_conv_impls_run_one_function(nets):
    _, params, obs, _ = nets["even_16px"]
    ref = vision_actor_critic_from_flax(params, VEC[0], (4, 16, 16), device="cpu")
    spec = {k: v for k, v in NETS["even_16px"].items() if k != "image_shape"}
    outs = []
    for impl in ("conv", "im2col", "s2d"):
        net = VisionActorCritic(ref.obs_dim, 4, VEC[0], (4, 16, 16), conv_impl=impl, device="cpu", **spec)
        net.load_state_dict(ref.state_dict())
        outs.append(net(torch.tensor(obs))[0])
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    torch.testing.assert_close(outs[2], outs[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="conv impl"):
        VisionActorCritic(30 + 4 * 64, 4, 30, (4, 8, 8), conv_impl="winograd", device="cpu")


def test_init_follows_flax_and_is_seeded():
    """lecun-normal kernels truncated at ±2σ, orthogonal dense layers with
    the heads' gains, zero biases; the same generator seed, the same net."""
    make = lambda s: VisionActorCritic(21 + 4 * 256 + 15, 4, 21, (4, 16, 16), conv_features=(32, 64),  # noqa: E731
                                       init_log_std=-0.5, device="cpu", generator=torch.Generator().manual_seed(s))
    a, b, c = make(0), make(0), make(1)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    assert not torch.equal(a.convs[0].weight, c.convs[0].weight)
    for conv in a.convs:
        std = (1.0 / (conv.in_channels * 9)) ** 0.5 / 0.87962566103423978
        w = conv.weight.detach()
        assert w.abs().max() <= 2 * std + 1e-7 and abs(float(w.std()) - (1.0 / (conv.in_channels * 9)) ** 0.5) < 0.1 * std
        assert (conv.bias == 0).all()
    w = a.pi_head.weight.detach()
    torch.testing.assert_close(w @ w.T, 1e-4 * torch.eye(4), rtol=0, atol=1e-6)
    assert (a.log_std == -0.5).all()


def test_minibatch_gradient_matches_jax_grad(nets):
    """One minibatch's f32 loss and gradient, autograd against ``jax.grad``
    of the JAX PPO's loss on the same params and rows."""
    jnet, params, obs, _ = nets["odd_15px"]
    rng = np.random.default_rng(31)
    n = obs.shape[0]
    action = _f32(rng.normal(scale=0.5, size=(n, 4)))
    old_logp = _f32(rng.normal(loc=-3.0, size=n))
    adv, ret = _f32(rng.normal(size=n)), _f32(rng.normal(size=n))
    env = JGates(camera_resolution=(15, 15), num_targets=5)
    jppo = JPPO(env, JPPOConfig(entropy_coef=0.01), network=jnet)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: jppo._loss(p, *map(jnp.asarray, (
        obs, action, old_logp, adv, ret)))[0]))(jax.tree.map(jnp.asarray, params))

    net = vision_actor_critic_from_flax(params, VEC[0], NETS["odd_15px"]["image_shape"], device="cpu")
    ppo = PPO(QuadXGatesEnv(device="cpu", camera_resolution=(15, 15)), PPOConfig(entropy_coef=0.01), network=net)
    loss_t, _ = ppo._loss(net, *map(torch.tensor, (obs, action, old_logp, adv, ret)))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=GRAD_RTOL)
    ref = vision_actor_critic_from_flax(jax.tree.map(np.asarray, grads_j), VEC[0], NETS["odd_15px"]["image_shape"],
                                        device="cpu")
    for (k, p), g in zip(net.named_parameters(), ref.parameters()):
        g = g.detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=GRAD_RTOL, atol=1e-4 * np.abs(g).max(), err_msg=k)
    assert float(net.convs[0].weight.grad.abs().max()) > 0


def test_r4_npz_equals_its_orbax_source_and_acts_as_jax(nets):
    """The shipped npz leaf for leaf against the orbax archive, and the
    deterministic actions (the clipped mean) against JAX's on rendered gate
    frames and random images."""
    _, params, obs, (mean, _, value) = nets["r4"]
    npz = tckpt.load_policy_npz("gates_vision_r4", device="cpu")
    ref = vision_actor_critic_from_flax(params, VEC[0], (4, 32, 32), device="cpu")
    assert isinstance(npz, VisionActorCritic) and npz.image_shape == (4, 32, 32) and npz.image_offset == VEC[0]
    assert npz.conv_features == (16, 32, 32) and npz.obs_dim == obs.shape[1]
    for (k, a), (k2, b) in zip(npz.state_dict().items(), ref.state_dict().items()):
        assert k == k2
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    env = QuadXGatesEnv(device="cpu", camera_resolution=(32, 32))
    low, high = (torch.tensor(_f32(v)) for v in env.action_bounds())
    from pyflyt_tpu_torch.rl.ppo import act_deterministic

    got = act_deterministic(npz, torch.tensor(obs), low, high)
    np.testing.assert_allclose(got.numpy(), np.clip(mean, low.numpy(), high.numpy()), atol=NET_ATOL)
    with torch.no_grad():
        np.testing.assert_allclose(npz.value(torch.tensor(obs)).numpy(), value, atol=1e-4, rtol=1e-6)
    assert np.abs(mean).max() > 0.05  # a trained policy, not the 0.01-gain init


def test_npz_round_trip_keeps_the_vision_layout(tmp_path):
    net = VisionActorCritic(21 + 4 * 81 + 15, 4, 21, (4, 9, 9), conv_features=(8, 8), feature_sizes=(16,),
                            pi_sizes=(8,), log_std_range=(-3.0, 0.5), device="cpu",
                            generator=torch.Generator().manual_seed(2))
    tckpt.save_policy_npz(str(tmp_path / "v.npz"), net)
    back = tckpt.load_policy_npz(str(tmp_path / "v.npz"), device="cpu")
    assert (back.image_offset, back.image_shape, back.conv_features) == (21, (4, 9, 9), (8, 8))
    assert back.log_std_range == (-3.0, 0.5) and back.obs_dim == net.obs_dim
    for (k, a), b in zip(net.state_dict().items(), back.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
