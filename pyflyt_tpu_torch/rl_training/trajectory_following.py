"""Trajectory-following PPO training and evaluation CLI (port of
``pyflyt_tpu/rl_training/trajectory_following.py``): the same subcommands,
flags and defaults, on the port's trajectory envs, ``PPO`` and ``train``,
with the reference's ``net_arch pi/vf=[64, 64, 32, 32]`` directly on the
observation (no feature trunk unless ``--feature_sizes`` gives one).

Usage::

    python -m pyflyt_tpu_torch.rl_training.trajectory_following train --variant fast \\
        --num_envs 2048 --log_dir runs/traj_fast
    python -m pyflyt_tpu_torch.rl_training.trajectory_following eval \\
        --variant slow --checkpoint runs/traj_slow/best_model_*
    python -m pyflyt_tpu_torch.rl_training.trajectory_following eval-pid-expert --scenario 3

Everything runs on the card; ``main(argv, device="cpu")`` runs it on the
CPU. The PPO kernels (K4n, K3n, K2n) are reached through ``PPOConfig``'s
``fused_rollout_forward`` and ``fused_sgd``, which the CLI leaves off, as
the JAX CLI does. ``eval-pid-expert`` flies mode 10 (``ops/ga_pid``).
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

REFERENCE_NET = (64, 64, 32, 32)  # trajectory_following_{fast,slow}/training.py: net_arch pi/vf


def build_env(args):
    from pyflyt_tpu_torch.envs.quadx_mod import QuadXTrajectoryFollowingFastEnv, QuadXTrajectoryFollowingSlowEnv

    cls = QuadXTrajectoryFollowingFastEnv if args.variant == "fast" else QuadXTrajectoryFollowingSlowEnv
    return cls(
        control_hz=args.control_hz,
        flight_mode=args.flight_mode,
        noisy_motors=args.noisy_motors,
        simulate_wind=args.simulate_wind,
        flight_dome_size=args.flight_dome_size,
        max_duration_seconds=args.max_duration_seconds,
        device=getattr(args, "device", "cuda"),
    )


def _make_ppo(args, env):
    from pyflyt_tpu_torch.rl import PPO, PPOConfig

    lo = getattr(args, "log_std_min", None)
    hi = getattr(args, "log_std_max", None)
    log_std_range = None if lo is None and hi is None else (-20.0 if lo is None else lo, 20.0 if hi is None else hi)
    return PPO(
        env,
        PPOConfig(
            num_envs=getattr(args, "num_envs", 16),
            rollout_steps=getattr(args, "rollout_steps", 32),
            num_epochs=getattr(args, "n_epochs", 15),
            num_minibatches=getattr(args, "num_minibatches", 32),
            learning_rate=getattr(args, "learning_rate", 3e-4),
            clip_eps=getattr(args, "clip_eps", 0.2),
            init_log_std=getattr(args, "init_log_std", 0.0),
            log_std_range=log_std_range,
            cached_reset_refresh=getattr(args, "cached_reset_refresh", 0),
            # the reference's MlpPolicy: net_arch pi/vf directly on the
            # observation, its feature extractor commented out
            feature_sizes=tuple(getattr(args, "feature_sizes", ()) or ()),
            pi_sizes=REFERENCE_NET,
            vf_sizes=REFERENCE_NET,
        ),
    )


def cmd_train(args):
    from pyflyt_tpu_torch.rl import TrainConfig, train

    env = build_env(args)
    ppo = _make_ppo(args, env)
    return train(
        ppo,
        TrainConfig(
            total_timesteps=args.total_timesteps,
            eval_every_updates=args.eval_every_updates,
            eval_episodes=args.eval_episodes,
            log_dir=args.log_dir,
            use_mesh=args.use_mesh,
            seed=args.seed,
            init_from=args.init_from,
            param_ema=args.param_ema,
            early_stop_patience=args.early_stop_patience,
        ),
        on_metrics=lambda u, row: print(json.dumps(row)),
    )


def restore_network(args, ppo):
    """The checkpointed network (``rl/checkpoint.save``), or the average of
    several checkpoints' parameters, on a template of the CLI's
    architecture."""
    from pyflyt_tpu_torch.rl import checkpoint
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    cfg = ppo.config
    template = ActorCritic(
        ppo.env.obs_size, ppo.action_dim, feature_sizes=cfg.feature_sizes, pi_sizes=cfg.pi_sizes,
        vf_sizes=cfg.vf_sizes, init_log_std=cfg.init_log_std, log_std_range=cfg.log_std_range, device=ppo.device,
    )
    if len(args.checkpoint) == 1:
        return checkpoint.restore_params(args.checkpoint[0], template)
    return checkpoint.average_params(args.checkpoint, template)


def cmd_eval(args):
    env = build_env(args)
    ppo = _make_ppo(args, env)
    network = restore_network(args, ppo)
    gen = torch.Generator(device=ppo.device).manual_seed(args.seed)
    stats = {k: float(v) for k, v in ppo.evaluate(network, gen, args.episodes).items()}
    print(json.dumps(stats))

    if args.log_dir:
        # one logged deterministic episode with the reference's CSV/plot
        # logger (rl_training/trajectory_following_*/evaluation.py)
        from pyflyt_tpu_torch.utils.trajectory_logger import TrajectoryFastLogger, TrajectorySlowLogger

        fast = args.variant == "fast"
        logger = TrajectoryFastLogger(args.log_dir) if fast else TrajectorySlowLogger(args.log_dir)
        state, obs = env.reset(1, torch.Generator(device=ppo.device).manual_seed(args.seed))
        i = 0
        while True:
            action = ppo.act_deterministic(network, obs)
            if fast:
                raw = state.state19[0].cpu().numpy()
            else:
                raw = state.state16[0].cpu().numpy()
                tgt, psi = state.target_pos[0].cpu().numpy(), float(state.target_psi[0])
            state, out = env.step(state, action)
            pwm = state.drone.pwm[0].cpu().numpy()
            if fast:
                logger.add(i, raw, pwm, float(out.reward[0]))
            else:
                logger.add(i, tgt, psi, raw, pwm, float(out.reward[0]))
            i += 1
            obs = out.obs
            if bool(out.termination[0]) or bool(out.truncation[0]):
                break
        logger.log_episode()
    return stats


# The three fixed scenarios of the reference's slow-variant PID-expert
# evaluation (rl_training/trajectory_following_slow/evaluation_pid_expert.py:
# 27-83): NED start pose, (n, 4) [x, y, z, psi] waypoint list, base wind.
_EXPERT_SCENARIOS = {
    1: dict(
        start_pos=((5.0, 0.0, -5.0),),
        start_orn=((0.0, 0.0, 0.0),),
        waypoints=tuple(
            (x, y, z, math.radians(psi))
            for x, y, z, psi in [
                (4.05, 2.94, -6.0, 0), (1.55, 4.76, -7.0, 20),
                (-1.55, 4.76, -8.0, 40), (-4.05, 2.94, -9.0, 60),
                (-5.0, 0.0, -10.0, 80), (-4.05, -2.94, -9.0, 100),
                (-1.55, -4.76, -8.0, 120), (1.55, -4.76, -7.0, 140),
                (4.05, -2.94, -6.0, 160), (5.0, 0.0, -5.0, 175),
            ]
        ),
        base_wind_velocities=(-2.0, -2.0, 0.5),
    ),
    2: dict(
        start_pos=((0.0, 0.0, -5.0),),
        start_orn=((0.0, 0.0, 0.0),),
        waypoints=tuple(
            (x, y, z, math.radians(psi))
            for x, y, z, psi in [
                (0.0, 5.0, -5.0, 35), (5.0, 5.0, -5.0, 70),
                (5.0, 0.0, -5.0, 105), (0.0, 0.0, -5.0, 140),
                (0.0, 0.0, -10.0, 175), (0.0, 5.0, -10.0, 140),
                (5.0, 5.0, -10.0, 105), (5.0, 0.0, -10.0, 70),
                (0.0, 0.0, -10.0, 35), (0.0, 0.0, -5.0, 0),
            ]
        ),
        base_wind_velocities=(2.0, 2.0, -0.5),
    ),
    3: dict(
        start_pos=((5.0, 5.0, -10.0),),
        start_orn=((0.0, 0.0, 0.0),),
        waypoints=tuple(
            (x, y, z, math.radians(psi))
            for x, y, z, psi in [
                (-5.0, -5.0, -10.0, 25), (5.0, 5.0, -10.0, 50),
                (-5.0, -5.0, -10.0, 75), (5.0, 5.0, -10.0, 100),
                (-5.0, -5.0, -10.0, 125), (5.0, 5.0, -10.0, 150),
                (-5.0, -5.0, -10.0, 175), (5.0, 5.0, -10.0, 150),
                (-5.0, -5.0, -10.0, 125), (5.0, 5.0, -10.0, 100),
            ]
        ),
        base_wind_velocities=(0.0, 0.0, 0.0),
    ),
}


def cmd_eval_pid_expert(args):
    """The PID-expert baseline on the reference's fixed slow-variant
    scenario (trajectory_following_slow/evaluation_pid_expert.py:85-138):
    mode 10, unnormalized obs and actions, the fixed waypoint list, gusty
    wind."""
    from pyflyt_tpu_torch.envs.quadx_mod import QuadXTrajectoryFollowingSlowEnv, trajectory_pid_expert
    from pyflyt_tpu_torch.utils.trajectory_logger import TrajectorySlowLogger

    env = QuadXTrajectoryFollowingSlowEnv(
        control_hz=80,
        orn_conv="NED_FRD",
        randomize_start=False,
        random_trajectory=False,
        goal_reach_distance=0.3,
        goal_reach_angle=float(np.deg2rad(5)),
        noisy_motors=True,
        drone_model="cf2x",
        flight_mode=10,
        simulate_wind=True,
        max_gust_strength=7.0,
        flight_dome_size=100,
        max_duration_seconds=args.max_duration_seconds,
        normalize_obs=False,
        normalize_actions=False,
        device=getattr(args, "device", "cuda"),
        **_EXPERT_SCENARIOS[args.scenario],
    )
    logger = TrajectorySlowLogger(args.log_dir) if args.log_dir else None
    state, _ = env.reset(1, torch.Generator(device=env.device).manual_seed(args.seed))
    total, length = 0.0, 0
    while True:
        action = trajectory_pid_expert(state.state16)
        old16 = state.state16[0].cpu().numpy()
        state, out = env.step(state, action)
        total += float(out.reward[0])
        length += 1
        if logger:
            logger.add(length - 1, state.target_pos[0].cpu().numpy(), float(state.target_psi[0]), old16,
                       state.drone.pwm[0].cpu().numpy(), float(out.reward[0]))
        if bool(out.termination[0]) or bool(out.truncation[0]):
            break
    if logger:
        logger.log_episode()
    result = {"episode_reward": total, "episode_length": length,
              "targets_reached": int(state.current_target_index[0])}
    print(json.dumps(result))
    return result


def main(argv=None, device: str = "cuda"):
    """The CLI; ``device`` places every env and network (the JAX CLI's
    flags, none added)."""
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add_common(p):
        p.add_argument("--variant", choices=("fast", "slow"), default="fast")
        p.add_argument("--control_hz", type=int, default=80)
        p.add_argument("--flight_mode", type=int, default=9)
        p.add_argument("--noisy_motors", type=lambda v: v != "False", default=False)
        p.add_argument("--simulate_wind", type=lambda v: v != "False", default=False)
        p.add_argument("--flight_dome_size", type=float, default=100)
        p.add_argument("--max_duration_seconds", type=float, default=30.0)
        p.add_argument("--seed", type=int, default=0)

    t = sub.add_parser("train")
    add_common(t)
    t.add_argument("--num_envs", type=int, default=2048)
    t.add_argument("--rollout_steps", type=int, default=32)
    t.add_argument("--n_epochs", type=int, default=15)
    t.add_argument("--num_minibatches", type=int, default=32)
    t.add_argument("--learning_rate", type=float, default=3e-4)
    t.add_argument("--clip_eps", type=float, default=0.2)
    # exploration scale; -1.6 is the solved mode-8/9 recipe
    t.add_argument("--init_log_std", type=float, default=0.0)
    # a hard clamp on the learned log_std (unset: free, the SB3 behavior)
    t.add_argument("--log_std_min", type=float, default=None)
    t.add_argument("--log_std_max", type=float, default=None)
    # amortized auto-reset period in steps (0 = exact per-step resets)
    t.add_argument("--cached_reset_refresh", type=int, default=0)
    # warm start from a saved checkpoint (the reference's PPO.load curriculum)
    t.add_argument("--init_from", type=str, default=None)
    # optional extra trunk widths before the reference heads (empty = the
    # reference-exact MlpPolicy)
    t.add_argument("--feature_sizes", type=int, nargs="*", default=[])
    t.add_argument("--total_timesteps", type=int, default=100_000_000)
    t.add_argument("--eval_every_updates", type=int, default=20)
    t.add_argument("--eval_episodes", type=int, default=16)
    # Polyak-averaged parameter shadow (0 = off), see rl/train.py
    t.add_argument("--param_ema", type=float, default=0.0)
    # stop after this many evals without a new best (0 = the full budget)
    t.add_argument("--early_stop_patience", type=int, default=0)
    t.add_argument("--log_dir", type=str, default=None)
    t.add_argument("--use_mesh", action="store_true")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval")
    add_common(e)
    # one checkpoint, or several to evaluate their parameter average
    e.add_argument("--checkpoint", type=str, nargs="+", required=True)
    e.add_argument("--feature_sizes", type=int, nargs="*", default=[])
    e.add_argument("--episodes", type=int, default=16)
    e.add_argument("--log_dir", type=str, default=None)
    e.set_defaults(fn=cmd_eval)

    x = sub.add_parser("eval-pid-expert")
    x.add_argument("--scenario", type=int, default=3, choices=(1, 2, 3))
    x.add_argument("--max_duration_seconds", type=float, default=30.0)
    x.add_argument("--seed", type=int, default=0)
    x.add_argument("--log_dir", type=str, default=None)
    x.set_defaults(fn=cmd_eval_pid_expert)

    args = parser.parse_args(argv)
    args.device = device
    return args.fn(args)


if __name__ == "__main__":
    main()
