"""Hovering PPO training and evaluation CLI (port of
``pyflyt_tpu/rl_training/hovering.py``): the same subcommands, flags and
defaults, on the port's ``QuadXModHoveringEnv``, ``PPO`` and ``train``,
with checkpoints from ``rl/checkpoint``. ``--device`` (default ``cuda``)
is the port's own flag.

Usage::

    python -m pyflyt_tpu_torch.rl_training.hovering train --flight_mode 9 \\
        --num_envs 2048 --total_timesteps 100000000 --log_dir runs/hover
    python -m pyflyt_tpu_torch.rl_training.hovering eval --checkpoint runs/hover/best_model_*
    python -m pyflyt_tpu_torch.rl_training.hovering eval-pid-expert

``eval-pid-expert`` flies the PID expert on the same scenario, in mode 7
(the default: the position cascade) or 10 (the gain-scheduled
``ops/ga_pid``), both through ``models/quadx``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def build_env(args, eval_scenario: bool = False):
    from pyflyt_tpu_torch.envs.quadx_mod import QuadXModHoveringEnv

    kwargs = dict(
        control_hz=args.control_hz,
        orn_conv=args.orn_conv,
        noisy_motors=args.noisy_motors,
        min_pwm=args.min_pwm,
        max_pwm=args.max_pwm,
        drone_model=args.drone_model,
        simulate_wind=args.simulate_wind,
        flight_mode=args.flight_mode,
        flight_dome_size=args.flight_dome_size,
        max_duration_seconds=args.max_duration_seconds,
        normalize_obs=args.normalize_obs,
        normalize_actions=args.normalize_actions,
        alpha=args.alpha,
        beta=args.beta,
        gamma=args.gamma,
        delta=args.delta,
        device=args.device,
    )
    if eval_scenario:
        # the fork's fixed eval scenario (rl_training/hovering/evaluation.py:42-68)
        kwargs.update(
            randomize_start=False,
            target_pos=(10.0, -10.0, -5.0),
            target_psi=float(np.deg2rad(-90)),
            start_pos=((19.0, -19.0, -14.0),),
            start_orn=(tuple(np.deg2rad([-10.0, 10.0, 90.0])),),
            simulate_wind=True,
            base_wind_velocities=(5.0, -5.0, -1.0),
            max_gust_strength=7.0,
            orn_conv="NED_FRD",
            control_hz=80,
        )
    return QuadXModHoveringEnv(**kwargs)


def add_env_args(p: argparse.ArgumentParser):
    """The defaults of the reference's rl_training/hovering/training.py."""
    p.add_argument("--control_hz", type=int, default=80)
    p.add_argument("--orn_conv", type=str, default="NED_FRD")
    p.add_argument("--min_pwm", type=float, default=0.0)
    p.add_argument("--max_pwm", type=float, default=1.0)
    p.add_argument("--noisy_motors", type=lambda v: v != "False", default=True)
    p.add_argument("--drone_model", type=str, default="cf2x")
    p.add_argument("--flight_mode", type=int, default=8)
    p.add_argument("--simulate_wind", type=lambda v: v != "False", default=True)
    p.add_argument("--flight_dome_size", type=float, default=100)
    p.add_argument("--max_duration_seconds", type=float, default=10.0)
    p.add_argument("--normalize_obs", type=lambda v: v != "False", default=True)
    p.add_argument("--normalize_actions", type=lambda v: v != "False", default=True)
    p.add_argument("--alpha", type=float, default=2.0)
    p.add_argument("--beta", type=float, default=0.1)
    p.add_argument("--gamma", type=float, default=4.0)
    p.add_argument("--delta", type=float, default=0.1)
    p.add_argument("--device", type=str, default="cuda")


def ppo_config(args):
    """The ``train`` command's PPOConfig from its parsed arguments."""
    from pyflyt_tpu_torch.rl import PPOConfig

    return PPOConfig(
        num_envs=args.num_envs,
        rollout_steps=args.rollout_steps,
        num_epochs=args.n_epochs,
        num_minibatches=args.num_minibatches,
        learning_rate=args.learning_rate,
        feature_sizes=tuple([args.layer_size] * args.num_of_layers),
        clip_eps=args.clip_eps,
        init_log_std=args.init_log_std,
        log_std_range=(
            None
            if args.log_std_min is None and args.log_std_max is None
            else (
                -20.0 if args.log_std_min is None else args.log_std_min,
                20.0 if args.log_std_max is None else args.log_std_max,
            )
        ),
        entropy_coef=args.entropy_coef,
        cached_reset_refresh=args.cached_reset_refresh,
    )


def cmd_train(args):
    from pyflyt_tpu_torch.rl import PPO, TrainConfig, train

    ppo = PPO(build_env(args), ppo_config(args))
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


def run_eval_episode(env, policy_fn, log_dir=None) -> tuple[float, int]:
    """One deterministic episode of one env on the fixed eval scenario,
    with the episode logger attached; returns (return, length)."""
    from pyflyt_tpu_torch.utils.hovering_logger import HoveringLogger

    logger = HoveringLogger(log_dir) if log_dir else None
    gen = torch.Generator(device=env.device).manual_seed(0)
    state, obs = env.reset(1, gen)
    total, length = 0.0, 0
    while True:
        action = policy_fn(state, obs)
        old16 = state.state16[0].cpu().numpy()
        state, out = env.step(state, action)
        total += float(out.reward[0])
        length += 1
        if logger:
            logger.add(length - 1, state.target_pos[0].cpu().numpy(), float(state.target_psi[0]),
                       old16, state.drone.pwm[0].cpu().numpy(), float(out.reward[0]))
        if bool(out.termination[0]) or bool(out.truncation[0]):
            break
    if logger:
        logger.log_episode()
    return total, length


def cmd_eval(args):
    from pyflyt_tpu_torch.rl import checkpoint
    from pyflyt_tpu_torch.rl.networks import ActorCritic
    from pyflyt_tpu_torch.rl.ppo import act_deterministic, action_bounds

    env = build_env(args, eval_scenario=True)
    template = ActorCritic(
        env.obs_size, env.action_size, feature_sizes=tuple([args.layer_size] * args.num_of_layers),
        device=env.device,
    )
    network = checkpoint.restore_params(args.checkpoint, template)
    low, high = action_bounds(env, env.device)

    def policy(state, obs):
        return act_deterministic(network, obs, low, high)

    total, length = run_eval_episode(env, policy, args.log_dir)
    print(json.dumps({"episode_reward": total, "episode_length": length}))
    return total, length


def cmd_eval_pid_expert(args):
    """The PID-expert baseline on the same scenario, in mode 7 or 10."""
    from pyflyt_tpu_torch.envs.quadx_mod import hovering_pid_expert

    args.flight_mode = args.expert_mode
    args.normalize_obs = False
    args.normalize_actions = False
    env = build_env(args, eval_scenario=True)

    def policy(state, obs):
        return hovering_pid_expert(state.state16)

    total, length = run_eval_episode(env, policy, args.log_dir)
    print(json.dumps({"episode_reward": total, "episode_length": length}))
    return total, length


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    add_env_args(t)
    t.add_argument("--num_envs", type=int, default=2048)
    t.add_argument("--rollout_steps", type=int, default=32)
    t.add_argument("--n_epochs", type=int, default=15)
    t.add_argument("--num_minibatches", type=int, default=32)
    t.add_argument("--learning_rate", type=float, default=3e-4)
    t.add_argument("--clip_eps", type=float, default=0.2)
    # the decisive exploration knob of the raw-mix modes 8/9: useful actions
    # live in a ~±0.05 band, so a unit std never leaves the tumble regime
    t.add_argument("--init_log_std", type=float, default=0.0)
    # SB3's ent_coef; negative values penalize entropy
    t.add_argument("--entropy_coef", type=float, default=0.0)
    # a hard clamp on the learned log_std (unset: free)
    t.add_argument("--log_std_min", type=float, default=None)
    t.add_argument("--log_std_max", type=float, default=None)
    # amortized auto-reset period in steps (0 = exact per-step resets)
    t.add_argument("--cached_reset_refresh", type=int, default=0)
    t.add_argument("--num_of_layers", type=int, default=2)
    t.add_argument("--layer_size", type=int, default=256)
    # warm start from a saved checkpoint
    t.add_argument("--init_from", type=str, default=None)
    t.add_argument("--total_timesteps", type=int, default=100_000_000)
    t.add_argument("--eval_every_updates", type=int, default=20)
    t.add_argument("--eval_episodes", type=int, default=16)
    # Polyak-averaged parameter shadow (0 = off), see rl/train.py
    t.add_argument("--param_ema", type=float, default=0.0)
    # stop after this many evals without a new best (0 = the full budget)
    t.add_argument("--early_stop_patience", type=int, default=0)
    t.add_argument("--log_dir", type=str, default=None)
    t.add_argument("--use_mesh", action="store_true")
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval")
    add_env_args(e)
    e.add_argument("--checkpoint", type=str, required=True)
    e.add_argument("--num_of_layers", type=int, default=2)
    e.add_argument("--layer_size", type=int, default=256)
    e.add_argument("--log_dir", type=str, default=None)
    e.set_defaults(fn=cmd_eval)

    x = sub.add_parser("eval-pid-expert")
    add_env_args(x)
    x.add_argument("--expert_mode", type=int, default=7, choices=(7, 10))
    x.add_argument("--log_dir", type=str, default=None)
    x.set_defaults(fn=cmd_eval_pid_expert)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
