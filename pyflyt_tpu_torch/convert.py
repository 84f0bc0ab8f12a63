"""Carries parameters, optimizer state and env states from the JAX package
into the port.

The functions take plain numpy trees (``jax.tree.map(np.asarray, tree)``
on the JAX side) and read them by attribute or key name only, so the port
imports nothing of JAX or of ``pyflyt_tpu``.

Layouts differ in two places: a flax ``Dense.kernel`` is ``(in, out)`` and
a ``torch.nn.Linear.weight`` is ``(out, in)``, so weights are transposed;
a flax ``Conv.kernel`` is HWIO and a ``torch.nn.Conv2d.weight`` OIHW.
"""

from __future__ import annotations

import numpy as np
import torch

from pyflyt_tpu_torch.core.state import Body6DoF
from pyflyt_tpu_torch.core.wind import GaussianWind
from pyflyt_tpu_torch.device import resolve_device
from pyflyt_tpu_torch.envs.fixedwing_waypoints import FixedwingWaypointsState
from pyflyt_tpu_torch.envs.ma_fixedwing_dogfight import DogfightState
from pyflyt_tpu_torch.envs.ma_quadx_hover import MAQuadXState
from pyflyt_tpu_torch.envs.quadx_mod.hovering import ModHoverState
from pyflyt_tpu_torch.envs.quadx_mod.trajectory_following_fast import TrajFastState
from pyflyt_tpu_torch.envs.quadx_gates import QuadXGatesState
from pyflyt_tpu_torch.envs.quadx_mod.trajectory_following_slow import TrajSlowState
from pyflyt_tpu_torch.envs.quadx_waypoints import QuadXWaypointsState
from pyflyt_tpu_torch.envs.rocket_landing import RocketLandingState
from pyflyt_tpu_torch.envs.utils.waypoints import WaypointState
from pyflyt_tpu_torch.models import fixedwing, quadx, rocket
from pyflyt_tpu_torch.ops import boosters, motors, pid
from pyflyt_tpu_torch.ops.cuda_sgd import params_to_leaves
from pyflyt_tpu_torch.rl.networks import ActorCritic, VisionActorCritic, encoded_size
from pyflyt_tpu_torch.rl.ppo import AdamState


def quadx_params_from_jax(tree, device: str | torch.device = "cuda") -> quadx.QuadXParams:
    """The port's ``QuadXParams`` from the leaves of a JAX ``QuadXParams``."""
    dev = resolve_device(device)
    t = lambda a: torch.tensor(np.array(a, dtype=np.float32), device=dev)  # noqa: E731

    def bank(b):
        return pid.PIDParams(kp=t(b.kp), ki=t(b.ki), kd=t(b.kd), lim=t(b.lim), period=float(b.period))

    m = tree.motor
    return quadx.QuadXParams(
        mass=t(tree.mass),
        inertia=t(tree.inertia),
        collision_half_extents=t(tree.collision_half_extents),
        motor=motors.MotorParams(
            positions=t(m.positions), thrust_unit=t(m.thrust_unit),
            thrust_coef=t(m.thrust_coef), torque_coef=t(m.torque_coef),
            tau=t(m.tau), max_rpm=t(m.max_rpm), noise_ratio=t(m.noise_ratio),
        ),
        motor_map=t(tree.motor_map),
        drag_const_xyz=t(tree.drag_const_xyz),
        drag_coef_pqr=t(tree.drag_coef_pqr),
        pid_ang_vel=bank(tree.pid_ang_vel),
        pid_ang_pos=bank(tree.pid_ang_pos),
        pid_lin_vel=bank(tree.pid_lin_vel),
        pid_lin_pos=bank(tree.pid_lin_pos),
        pid_z_pos=bank(tree.pid_z_pos),
        pid_z_vel=bank(tree.pid_z_vel),
    )


def quadx_state_from_jax(tree, device: str | torch.device = "cuda") -> quadx.QuadXState:
    """The port's batched ``QuadXState`` from the numpy leaves of a JAX
    ``QuadXState`` (batch ``(N,)``; floats as f32, the contact flag as
    bool, the physics step count as int32)."""
    dev = resolve_device(device)
    f = lambda a: torch.tensor(np.array(a, dtype=np.float32), device=dev)  # noqa: E731

    def bank(b):
        return pid.PIDState(integral=f(b.integral), prev_error=f(b.prev_error))

    p = tree.pids
    return quadx.QuadXState(
        body=Body6DoF(pos=f(tree.body.pos), quat=f(tree.body.quat),
                      lin_vel=f(tree.body.lin_vel), ang_vel=f(tree.body.ang_vel)),
        read=quadx.QuadXRead(view=f(tree.read.view), ang_vel_body=f(tree.read.ang_vel_body),
                             drag_local_vel=f(tree.read.drag_local_vel)),
        throttle=f(tree.throttle),
        pwm=f(tree.pwm),
        setpoint=f(tree.setpoint),
        pids=quadx.QuadXPIDState(
            ang_vel=bank(p.ang_vel), ang_pos=bank(p.ang_pos), lin_vel=bank(p.lin_vel),
            lin_pos=bank(p.lin_pos), z_pos=bank(p.z_pos), z_vel=bank(p.z_vel),
        ),
        contact=torch.tensor(np.array(tree.contact, dtype=bool), device=dev),
        physics_steps=torch.tensor(np.array(tree.physics_steps, dtype=np.int32), device=dev),
    )


def _gaussian_wind_from_jax(wind, generator, f) -> GaussianWind:
    """A JAX ``GaussianWind`` (batched numpy leaves) as the port's: the
    per-env base, the gust clip and the convention; ``generator`` draws
    the gusts."""
    base = np.array(wind.base_wind, dtype=np.float32).reshape(-1, 3)
    gust = float(np.asarray(wind.max_gust, dtype=np.float32).reshape(-1)[0])
    return GaussianWind(base_wind=f(base), generator=generator, max_gust=gust, orn_conv=wind.orn_conv)


def mod_hover_state_from_jax(
    tree, generator: torch.Generator | None = None, device: str | torch.device = "cuda"
) -> ModHoverState:
    """The port's ``ModHoverState`` from the numpy leaves of a batched JAX
    ``ModHoverState`` (a ``vmap``-ed reset or step). The wind keeps its
    per-env base, gust clip and convention; the JAX PRNG keys become the
    one ``generator`` of the batch (its stream differs from threefry)."""
    dev = resolve_device(device)
    f = lambda a: torch.tensor(np.array(a, dtype=np.float32), device=dev)  # noqa: E731
    b = lambda a: torch.tensor(np.array(a, dtype=bool), device=dev)  # noqa: E731
    return ModHoverState(
        drone=quadx_state_from_jax(tree.drone, dev),
        wind=_gaussian_wind_from_jax(tree.wind, generator, f),
        generator=generator,
        step_count=torch.tensor(np.array(tree.step_count, dtype=np.int32), device=dev),
        termination=b(tree.termination),
        truncation=b(tree.truncation),
        reward=f(tree.reward),
        action=f(tree.action),
        target_pos=f(tree.target_pos),
        target_psi=f(tree.target_psi),
        state16=f(tree.state16),
        collision=b(tree.collision),
        env_complete=b(tree.env_complete),
    )


def traj_fast_state_from_jax(
    tree, generator: torch.Generator | None = None, device: str | torch.device = "cuda"
) -> TrajFastState:
    """The port's ``TrajFastState`` from the numpy leaves of a batched JAX
    ``TrajFastState`` (a ``vmap``-ed reset or step); the JAX PRNG keys
    become the one ``generator`` of the batch."""
    dev = resolve_device(device)
    f = lambda a: torch.tensor(np.array(a, dtype=np.float32), device=dev)  # noqa: E731
    b = lambda a: torch.tensor(np.array(a, dtype=bool), device=dev)  # noqa: E731
    i32 = lambda a: torch.tensor(np.array(a, dtype=np.int32), device=dev)  # noqa: E731
    return TrajFastState(
        drone=quadx_state_from_jax(tree.drone, dev),
        wind=_gaussian_wind_from_jax(tree.wind, generator, f),
        generator=generator,
        step_count=i32(tree.step_count), termination=b(tree.termination), truncation=b(tree.truncation),
        reward=f(tree.reward), action=f(tree.action), waypoints=f(tree.waypoints),
        num_targets_reached=i32(tree.num_targets_reached),
        prev_step_count_reached=i32(tree.prev_step_count_reached),
        target_pos=f(tree.target_pos), next_pos=f(tree.next_pos), delta_pos=f(tree.delta_pos),
        lin_pos_error=f(tree.lin_pos_error), prev_lin_pos_error=f(tree.prev_lin_pos_error),
        lin_pos_error_fixed=f(tree.lin_pos_error_fixed), angle_diff=f(tree.angle_diff),
        state19=f(tree.state19), collision=b(tree.collision), env_complete=b(tree.env_complete),
    )


def traj_slow_state_from_jax(
    tree, generator: torch.Generator | None = None, device: str | torch.device = "cuda"
) -> TrajSlowState:
    """The port's ``TrajSlowState`` from the numpy leaves of a batched JAX
    ``TrajSlowState``; the JAX PRNG keys become the one ``generator`` of
    the batch."""
    dev = resolve_device(device)
    f = lambda a: torch.tensor(np.array(a, dtype=np.float32), device=dev)  # noqa: E731
    b = lambda a: torch.tensor(np.array(a, dtype=bool), device=dev)  # noqa: E731
    i32 = lambda a: torch.tensor(np.array(a, dtype=np.int32), device=dev)  # noqa: E731
    return TrajSlowState(
        drone=quadx_state_from_jax(tree.drone, dev),
        wind=_gaussian_wind_from_jax(tree.wind, generator, f),
        generator=generator,
        step_count=i32(tree.step_count), termination=b(tree.termination), truncation=b(tree.truncation),
        reward=f(tree.reward), action=f(tree.action), current_target_index=i32(tree.current_target_index),
        target_pos=f(tree.target_pos), target_psi=f(tree.target_psi), fixed_waypoints=f(tree.fixed_waypoints),
        state16=f(tree.state16), collision=b(tree.collision), env_complete=b(tree.env_complete),
    )


def waypoints_state_from_jax(
    tree, generator: torch.Generator | None = None, device: str | torch.device = "cuda"
) -> QuadXWaypointsState:
    """The port's ``QuadXWaypointsState`` from the numpy leaves of a batched
    JAX ``QuadXWaypointsState`` (a ``vmap``-ed reset or step). The JAX PRNG
    keys become the one ``generator`` of the batch."""
    dev = resolve_device(device)
    f = lambda a: torch.tensor(np.array(a, dtype=np.float32), device=dev)  # noqa: E731
    b = lambda a: torch.tensor(np.array(a, dtype=bool), device=dev)  # noqa: E731
    i32 = lambda a: torch.tensor(np.array(a, dtype=np.int32), device=dev)  # noqa: E731
    wp = tree.wp
    return QuadXWaypointsState(
        drone=quadx_state_from_jax(tree.drone, dev),
        step_count=i32(tree.step_count),
        termination=b(tree.termination),
        truncation=b(tree.truncation),
        reward=f(tree.reward),
        action=f(tree.action),
        collision=b(tree.collision),
        out_of_bounds=b(tree.out_of_bounds),
        env_complete=b(tree.env_complete),
        generator=generator,
        wp=WaypointState(
            targets=f(wp.targets), yaw_targets=f(wp.yaw_targets), idx=i32(wp.idx),
            old_distance=f(wp.old_distance), new_distance=f(wp.new_distance), yaw_error=f(wp.yaw_error),
        ),
        target_deltas=f(tree.target_deltas),
    )


def gates_state_from_jax(
    tree, generator: torch.Generator | None = None, device: str | torch.device = "cuda"
) -> QuadXGatesState:
    """The port's ``QuadXGatesState`` from the numpy leaves of a batched
    JAX ``QuadXGatesState`` (a ``vmap``-ed reset or step). The JAX PRNG
    keys become the one ``generator`` of the batch."""
    dev = resolve_device(device)
    f = lambda a: torch.tensor(np.array(a, dtype=np.float32), device=dev)  # noqa: E731
    b = lambda a: torch.tensor(np.array(a, dtype=bool), device=dev)  # noqa: E731
    i32 = lambda a: torch.tensor(np.array(a, dtype=np.int32), device=dev)  # noqa: E731
    return QuadXGatesState(
        drone=quadx_state_from_jax(tree.drone, dev),
        step_count=i32(tree.step_count),
        termination=b(tree.termination),
        truncation=b(tree.truncation),
        reward=f(tree.reward),
        action=f(tree.action),
        collision=b(tree.collision),
        out_of_bounds=b(tree.out_of_bounds),
        env_complete=b(tree.env_complete),
        generator=generator,
        gate_positions=f(tree.gate_positions),
        gate_eulers=f(tree.gate_eulers),
        idx=i32(tree.idx),
        dis_error_scalar=f(tree.dis_error_scalar),
        target_deltas=f(tree.target_deltas),
    )


def packed_waypoints_from_jax(packed, device: str | torch.device = "cuda") -> torch.Tensor:
    """The port's ``(rows, N)`` packed waypoints state from a JAX
    ``PackedWaypointsState.packed`` (``(rows, 8, N/8)``, the TPU's sublane
    fold; the row layout is the same)."""
    a = np.asarray(packed, dtype=np.float32)
    return torch.tensor(a.reshape(a.shape[0], -1), device=resolve_device(device))


def fixedwing_state_from_jax(tree, device: str | torch.device = "cuda") -> fixedwing.FixedwingState:
    """The port's batched ``FixedwingState`` from the numpy leaves of a JAX
    ``FixedwingState`` (batch ``(N,)``; floats as f32, the contact flag as
    bool, the physics step count as int32)."""
    dev = resolve_device(device)
    f = lambda a: torch.tensor(np.array(a, dtype=np.float32), device=dev)  # noqa: E731
    return fixedwing.FixedwingState(
        body=Body6DoF(pos=f(tree.body.pos), quat=f(tree.body.quat),
                      lin_vel=f(tree.body.lin_vel), ang_vel=f(tree.body.ang_vel)),
        read=fixedwing.FixedwingRead(view=f(tree.read.view), surface_local_vel=f(tree.read.surface_local_vel)),
        actuation=f(tree.actuation),
        throttle=f(tree.throttle),
        cmd=f(tree.cmd),
        setpoint=f(tree.setpoint),
        contact=torch.tensor(np.array(tree.contact, dtype=bool), device=dev),
        physics_steps=torch.tensor(np.array(tree.physics_steps, dtype=np.int32), device=dev),
    )


def fixedwing_waypoints_state_from_jax(
    tree, generator: torch.Generator | None = None, device: str | torch.device = "cuda"
) -> FixedwingWaypointsState:
    """The port's ``FixedwingWaypointsState`` from the numpy leaves of a
    batched JAX ``FixedwingWaypointsState`` (a ``vmap``-ed reset or step).
    The JAX PRNG keys become the one ``generator`` of the batch."""
    dev = resolve_device(device)
    f = lambda a: torch.tensor(np.array(a, dtype=np.float32), device=dev)  # noqa: E731
    b = lambda a: torch.tensor(np.array(a, dtype=bool), device=dev)  # noqa: E731
    i32 = lambda a: torch.tensor(np.array(a, dtype=np.int32), device=dev)  # noqa: E731
    wp = tree.wp
    return FixedwingWaypointsState(
        drone=fixedwing_state_from_jax(tree.drone, dev),
        step_count=i32(tree.step_count),
        termination=b(tree.termination),
        truncation=b(tree.truncation),
        reward=f(tree.reward),
        action=f(tree.action),
        collision=b(tree.collision),
        out_of_bounds=b(tree.out_of_bounds),
        env_complete=b(tree.env_complete),
        generator=generator,
        wp=WaypointState(
            targets=f(wp.targets), yaw_targets=f(wp.yaw_targets), idx=i32(wp.idx),
            old_distance=f(wp.old_distance), new_distance=f(wp.new_distance), yaw_error=f(wp.yaw_error),
        ),
        target_deltas=f(tree.target_deltas),
    )


def packed_fixedwing_waypoints_from_jax(packed, device: str | torch.device = "cuda") -> torch.Tensor:
    """The port's ``(88, N)`` packed Fixedwing-Waypoints state from a JAX
    ``PackedWaypointsState.packed`` of ``envs/packed_fixedwing_waypoints``
    (``(88, 8, N/8)``, the TPU's sublane fold; the row layout is the
    same). It is ``packed_waypoints_from_jax`` under the fixedwing env's
    name, kept beside the other ``*_from_jax`` converters of this env."""
    return packed_waypoints_from_jax(packed, device)


def ma_quadx_state_from_jax(
    tree, generator: torch.Generator | None = None, device: str | torch.device = "cuda"
) -> MAQuadXState:
    """The port's ``MAQuadXState`` from the numpy leaves of a batched JAX
    ``MAQuadXState`` (a ``vmap``-ed reset or step over arenas: drones
    ``(N, n)``). The JAX PRNG keys become the one ``generator`` of the
    batch."""
    dev = resolve_device(device)
    f = lambda a: torch.tensor(np.array(a, dtype=np.float32), device=dev)  # noqa: E731
    return MAQuadXState(
        drones=quadx_state_from_jax(tree.drones, dev),
        generator=generator,
        step_count=torch.tensor(np.array(tree.step_count, dtype=np.int32), device=dev),
        alive=torch.tensor(np.array(tree.alive, dtype=bool), device=dev),
        current_actions=f(tree.current_actions),
        past_actions=f(tree.past_actions),
    )


def dogfight_state_from_jax(
    tree, generator: torch.Generator | None = None, device: str | torch.device = "cuda"
) -> DogfightState:
    """The port's ``DogfightState`` from the numpy leaves of a batched JAX
    ``DogfightState`` (a ``vmap``-ed reset or step over arenas: drones
    ``(N, 2)``). The JAX PRNG keys become the one ``generator`` of the
    batch."""
    dev = resolve_device(device)
    f = lambda a: torch.tensor(np.array(a, dtype=np.float32), device=dev)  # noqa: E731
    b = lambda a: torch.tensor(np.array(a, dtype=bool), device=dev)  # noqa: E731
    return DogfightState(
        drones=fixedwing_state_from_jax(tree.drones, dev),
        generator=generator,
        step_count=torch.tensor(np.array(tree.step_count, dtype=np.int32), device=dev),
        alive=b(tree.alive),
        current_actions=f(tree.current_actions),
        past_actions=f(tree.past_actions),
        health=f(tree.health),
        current_hits=b(tree.current_hits),
        current_angles=f(tree.current_angles),
        current_offsets=f(tree.current_offsets),
        current_distance=f(tree.current_distance),
        prev_angles=f(tree.prev_angles),
        prev_distance=f(tree.prev_distance),
        observations=f(tree.observations),
    )


def packed_dogfight_from_jax(packed, device: str | torch.device = "cuda") -> torch.Tensor:
    """The port's ``(72, 2N)`` packed dogfight state from a JAX
    ``PackedDogfightEnvState.packed``: ``(72, 8, 2N/8)``, the TPU's sublane
    fold of the drone order ``[d0 of every arena..., d1 of every
    arena...]``, reordered into the port's arena-interleaved columns
    (column ``2a + m`` is drone ``m`` of arena ``a``). The row layout is
    the same."""
    a = np.asarray(packed, dtype=np.float32)
    rows = a.shape[0]
    a = a.reshape(rows, 2, -1).transpose(0, 2, 1).reshape(rows, -1)
    return torch.tensor(np.ascontiguousarray(a), device=resolve_device(device))


def rocket_state_from_jax(tree, device: str | torch.device = "cuda") -> rocket.RocketState:
    """The port's batched ``RocketState`` from the numpy leaves of a JAX
    ``RocketState`` (batch ``(N,)``; floats as f32, the ignition latch and
    the contact flags as bool, the physics step count as int32)."""
    dev = resolve_device(device)
    f = lambda a: torch.tensor(np.array(a, dtype=np.float32), device=dev)  # noqa: E731
    b = lambda a: torch.tensor(np.array(a, dtype=bool), device=dev)  # noqa: E731
    return rocket.RocketState(
        body=Body6DoF(pos=f(tree.body.pos), quat=f(tree.body.quat),
                      lin_vel=f(tree.body.lin_vel), ang_vel=f(tree.body.ang_vel)),
        read=rocket.RocketRead(view=f(tree.read.view), finlet_local_vel=f(tree.read.finlet_local_vel),
                               drag_local_vel=f(tree.read.drag_local_vel)),
        actuation=f(tree.actuation),
        booster=boosters.BoosterState(ratio_fuel_remaining=f(tree.booster.ratio_fuel_remaining),
                                      throttle=f(tree.booster.throttle),
                                      ignition_state=b(tree.booster.ignition_state)),
        gimbal_state=f(tree.gimbal_state),
        cmd=f(tree.cmd),
        setpoint=f(tree.setpoint),
        contact=b(tree.contact),
        ground_contact=b(tree.ground_contact),
        pad_contact=b(tree.pad_contact),
        physics_steps=torch.tensor(np.array(tree.physics_steps, dtype=np.int32), device=dev),
    )


def rocket_landing_state_from_jax(
    tree, generator: torch.Generator | None = None, device: str | torch.device = "cuda"
) -> RocketLandingState:
    """The port's ``RocketLandingState`` from the numpy leaves of a batched
    JAX ``RocketLandingState`` (a ``vmap``-ed reset or step). The JAX PRNG
    keys become the one ``generator`` of the batch."""
    dev = resolve_device(device)
    f = lambda a: torch.tensor(np.array(a, dtype=np.float32), device=dev)  # noqa: E731
    b = lambda a: torch.tensor(np.array(a, dtype=bool), device=dev)  # noqa: E731
    return RocketLandingState(
        drone=rocket_state_from_jax(tree.drone, dev),
        generator=generator,
        step_count=torch.tensor(np.array(tree.step_count, dtype=np.int32), device=dev),
        termination=b(tree.termination),
        truncation=b(tree.truncation),
        reward=f(tree.reward),
        action=f(tree.action),
        fatal_collision=b(tree.fatal_collision),
        out_of_bounds=b(tree.out_of_bounds),
        env_complete=b(tree.env_complete),
        **{k: f(getattr(tree, k)) for k in ("pad_position", "pad_contact_flag", "ang_vel", "lin_vel", "distance",
                                            "prev_ang_vel", "prev_lin_vel", "prev_distance")},
    )


def packed_rocket_landing_from_jax(packed, device: str | torch.device = "cuda") -> torch.Tensor:
    """The port's ``(88, N)`` packed Rocket-Landing state from a JAX
    ``PackedRocketEnvState.packed``: ``(88, 8, N/8)``, the TPU's sublane
    fold, which keeps the column order; the row layout is the same."""
    a = np.asarray(packed, dtype=np.float32)
    return torch.tensor(a.reshape(a.shape[0], -1), device=resolve_device(device))


def _dense_layers(trunk: dict) -> list[dict]:
    layers = []
    while f"Dense_{len(layers)}" in trunk:
        layers.append(trunk[f"Dense_{len(layers)}"])
    return layers


def _load_dense(lin: torch.nn.Linear, dense: dict) -> None:
    kernel = np.asarray(dense["kernel"], dtype=np.float32)
    lin.weight.copy_(torch.tensor(kernel.T))  # (in, out) -> (out, in)
    lin.bias.copy_(torch.tensor(np.asarray(dense["bias"], dtype=np.float32)))


def actor_critic_from_flax(
    params,
    log_std_range: tuple[float, float] | None = None,
    device: str | torch.device = "cuda",
) -> ActorCritic:
    """The port's ``ActorCritic`` from a flax ``ActorCritic`` param dict
    (``{"params": {"pi_trunk": {"Dense_0": {"kernel", "bias"}, ...},
    "pi_head", "log_std", "vf_trunk", "vf_head"}}``). Widths are read from
    the kernels; ``log_std_range`` is not part of the params and is passed
    as in the flax module."""
    p = params["params"]
    pi_layers = _dense_layers(p["pi_trunk"])
    vf_layers = _dense_layers(p["vf_trunk"])
    obs_dim = np.asarray(pi_layers[0]["kernel"]).shape[0]
    act_dim = np.asarray(p["pi_head"]["kernel"]).shape[1]
    pi_w = [np.asarray(d["kernel"]).shape[1] for d in pi_layers]
    vf_w = [np.asarray(d["kernel"]).shape[1] for d in vf_layers]
    # shared feature sizes are the common prefix; the rest are head layers
    n_common = 0
    while n_common < min(len(pi_w), len(vf_w)) and pi_w[n_common] == vf_w[n_common]:
        n_common += 1
    net = ActorCritic(
        obs_dim, act_dim, feature_sizes=pi_w[:n_common], pi_sizes=pi_w[n_common:],
        vf_sizes=vf_w[n_common:], log_std_range=log_std_range, device="cpu",
    )

    with torch.no_grad():
        for lin, dense in zip(net.pi_trunk.layers, pi_layers):
            _load_dense(lin, dense)
        _load_dense(net.pi_head, p["pi_head"])
        net.log_std.copy_(torch.tensor(np.asarray(p["log_std"], dtype=np.float32)))
        for lin, dense in zip(net.vf_trunk.layers, vf_layers):
            _load_dense(lin, dense)
        _load_dense(net.vf_head, p["vf_head"])
    return net.to(resolve_device(device))


def vision_actor_critic_from_flax(
    params,
    image_offset: int,
    image_shape: tuple,
    log_std_range: tuple[float, float] | None = None,
    device: str | torch.device = "cuda",
) -> VisionActorCritic:
    """The port's ``VisionActorCritic`` from a flax ``VisionActorCritic``
    param dict (``{"params": {"Conv_i": {"kernel" (3, 3, Cin, F), "bias"},
    "pi_trunk", "pi_head", "log_std", "vf_trunk", "vf_head"}}``). Widths
    and conv features are read from the kernels; ``image_offset``,
    ``image_shape`` and ``log_std_range`` are not part of the params and are
    passed as in the flax module. The conv kernels go HWIO -> OIHW; the
    first dense layer needs no permutation, since the port flattens the
    encoder's output in flax's NHWC order."""
    p = params["params"]
    convs = []
    while f"Conv_{len(convs)}" in p:
        convs.append(p[f"Conv_{len(convs)}"])
    pi_layers = _dense_layers(p["pi_trunk"])
    vf_layers = _dense_layers(p["vf_trunk"])
    act_dim = np.asarray(p["pi_head"]["kernel"]).shape[1]
    pi_w = [np.asarray(d["kernel"]).shape[1] for d in pi_layers]
    vf_w = [np.asarray(d["kernel"]).shape[1] for d in vf_layers]
    n_common = 0
    while n_common < min(len(pi_w), len(vf_w)) and pi_w[n_common] == vf_w[n_common]:
        n_common += 1
    features = [np.asarray(c["kernel"]).shape[3] for c in convs]
    # the flat obs width: the image and the vector features, the latter the
    # first dense layer's input less the encoder's output
    feat_in = np.asarray((pi_layers[0] if pi_layers else p["pi_head"])["kernel"]).shape[0]
    net = VisionActorCritic(
        int(np.prod(image_shape)) + feat_in - encoded_size(tuple(image_shape), features), act_dim, image_offset, image_shape, conv_features=features,
        feature_sizes=pi_w[:n_common], pi_sizes=pi_w[n_common:], vf_sizes=vf_w[n_common:],
        log_std_range=log_std_range, device="cpu",
    )

    with torch.no_grad():
        for conv, c in zip(net.convs, convs):
            conv.weight.copy_(torch.tensor(np.asarray(c["kernel"], dtype=np.float32).transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.tensor(np.asarray(c["bias"], dtype=np.float32)))
        for lin, dense in zip(net.pi_trunk.layers, pi_layers):
            _load_dense(lin, dense)
        _load_dense(net.pi_head, p["pi_head"])
        net.log_std.copy_(torch.tensor(np.asarray(p["log_std"], dtype=np.float32)))
        for lin, dense in zip(net.vf_trunk.layers, vf_layers):
            _load_dense(lin, dense)
        _load_dense(net.vf_head, p["vf_head"])
    return net.to(resolve_device(device))


def _flax_leaf_tree(network: ActorCritic) -> dict:
    """The flax param tree of ``network`` with, at each leaf, its index in
    the port's leaf order (``cuda_sgd.leaf_specs``) and its flax shape."""
    leaves = params_to_leaves(network)
    idx = iter(range(len(leaves)))

    def dense(lin):
        w, b = next(idx), next(idx)
        return {"kernel": (w, (lin.in_features, lin.out_features)), "bias": (b, (lin.out_features,))}

    p = {"pi_trunk": {f"Dense_{i}": dense(lin) for i, lin in enumerate(network.pi_trunk.layers)}}
    p["pi_head"] = dense(network.pi_head)
    p["log_std"] = (next(idx), (network.action_dim,))
    p["vf_trunk"] = {f"Dense_{i}": dense(lin) for i, lin in enumerate(network.vf_trunk.layers)}
    p["vf_head"] = dense(network.vf_head)
    return {"params": p}


def _sorted_leaves(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k])
    else:
        yield tree


def _find_adam(state):
    if all(hasattr(state, f) for f in ("count", "mu", "nu")):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find_adam(s)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state, network: ActorCritic, device: str | torch.device = "cuda") -> AdamState:
    """The port's ``AdamState`` from the numpy leaves of a JAX ``PPO``'s
    optimizer state (``jax.tree.map(np.asarray, opt_state)``), in either
    layout the JAX ``PPO`` builds: moments per param leaf (``fused_sgd``,
    ``chain(clip_by_global_norm, adam)``) or one flat vector in
    ``jax.tree.leaves`` order of the flax params (``optax.flatten`` of that
    chain, the default path). ``network`` gives the widths."""
    dev = resolve_device(device)
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the optimizer state")
    spec = list(_sorted_leaves(_flax_leaf_tree(network)))
    n = len(spec)

    def leaves_of(moment) -> list[torch.Tensor]:
        out = [None] * n
        if isinstance(moment, dict):
            for (i, shape), a in zip(spec, _sorted_leaves(moment)):
                out[i] = np.asarray(a, dtype=np.float32).reshape(shape)
        else:
            flat = np.asarray(moment, dtype=np.float32).reshape(-1)
            sizes = [int(np.prod(shape)) for _, shape in spec]
            if flat.size != sum(sizes):
                raise ValueError(f"flat moment of {flat.size} values for a network of {sum(sizes)}")
            pos = 0
            for (i, shape), size in zip(spec, sizes):
                out[i] = flat[pos : pos + size].reshape(shape)
                pos += size
        # flax (n,) biases and log_std are (1, n) leaves in the port
        return [torch.tensor(a[None, :] if a.ndim == 1 else a, device=dev) for a in out]

    return AdamState(
        count=torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32, device=dev),
        mu=leaves_of(adam.mu),
        nu=leaves_of(adam.nu),
    )
