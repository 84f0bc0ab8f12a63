"""Vision-based Gates PPO training and evaluation CLI (port of
``pyflyt_tpu/rl_training/gates_vision.py``): the same subcommands, flags
and defaults, on the port's ``QuadXGatesEnv`` (the ray-cast render inside
the env step), ``VisionActorCritic``, ``PPO`` and ``train``.

Usage::

    python -m pyflyt_tpu_torch.rl_training.gates_vision train \\
        --num_envs 256 --camera_res 32 --total_timesteps 150000000 \\
        --log_dir runs/gates
    python -m pyflyt_tpu_torch.rl_training.gates_vision eval \\
        --checkpoint runs/gates/best_model_*
    python -m pyflyt_tpu_torch.rl_training.gates_vision eval \\
        --checkpoint pyflyt_tpu_torch/assets/policies/gates_vision_r4.npz

Everything runs on the card; ``main(argv, device="cpu")`` runs it on the
CPU. ``eval --checkpoint`` takes a checkpoint of ``rl/checkpoint.save`` or
a ``.npz`` of ``save_policy_npz`` (a path, or a name in
``assets/policies/``). ``--cached_reset_refresh`` defaults to 0, the exact
per-step auto-reset, as in the JAX CLI; 64 amortizes the resets.
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def build_env(args):
    from pyflyt_tpu_torch.envs.quadx_gates import QuadXGatesEnv

    return QuadXGatesEnv(
        num_targets=args.num_targets,
        camera_resolution=(args.camera_res, args.camera_res),
        camera_fov_degrees=args.camera_fov,
        agent_hz=args.agent_hz,
        device=args.device,
    )


def build_net(args, env):
    from pyflyt_tpu_torch.rl.networks import VisionActorCritic

    return VisionActorCritic(
        env.flat_obs_size,
        4,
        image_offset=env.combined_size,
        image_shape=(4, args.camera_res, args.camera_res),
        conv_features=tuple(args.conv_features),
        feature_sizes=tuple([args.layer_size] * args.num_of_layers),
        init_log_std=args.init_log_std,
        device=env.device,
    )


def add_env_args(p: argparse.ArgumentParser):
    p.add_argument("--num_targets", type=int, default=5)
    p.add_argument("--camera_res", type=int, default=32)
    p.add_argument("--camera_fov", type=float, default=90.0)
    p.add_argument("--agent_hz", type=int, default=40)
    p.add_argument("--conv_features", type=int, nargs="+", default=[16, 32, 32])
    p.add_argument("--layer_size", type=int, default=128)
    p.add_argument("--num_of_layers", type=int, default=1)
    p.add_argument("--init_log_std", type=float, default=-0.5)


def cmd_train(args):
    from pyflyt_tpu_torch.rl import PPO, PPOConfig, TrainConfig, train

    env = build_env(args)
    ppo = PPO(
        env,
        PPOConfig(
            num_envs=args.num_envs,
            rollout_steps=args.rollout_steps,
            num_epochs=args.n_epochs,
            num_minibatches=args.num_minibatches,
            learning_rate=args.learning_rate,
            clip_eps=args.clip_eps,
            init_log_std=args.init_log_std,
            entropy_coef=args.entropy_coef,
            cached_reset_refresh=args.cached_reset_refresh,
        ),
        network=build_net(args, env),
    )
    return train(
        ppo,
        TrainConfig(
            total_timesteps=args.total_timesteps,
            eval_every_updates=args.eval_every_updates,
            eval_episodes=args.eval_episodes,
            log_dir=args.log_dir,
            seed=args.seed,
            init_from=args.init_from,
        ),
        on_metrics=lambda u, row: print(json.dumps(row)),
    )


def restore_network(path: str, template: torch.nn.Module) -> torch.nn.Module:
    """The policy in ``path``: a ``.npz`` of ``save_policy_npz`` (a file, or
    a name in ``assets/policies/``), else a checkpoint of
    ``rl/checkpoint.save`` restored onto ``template``."""
    from pyflyt_tpu_torch.rl import checkpoint

    device = next(template.parameters()).device
    if path.endswith(".npz") or os.path.isfile(os.path.join(checkpoint.POLICY_DIR, f"{path}.npz")):
        return checkpoint.load_policy_npz(path, device=device)
    return checkpoint.restore_params(path, template)


def cmd_eval(args):
    from pyflyt_tpu_torch.rl import PPO, PPOConfig

    env = build_env(args)
    template = build_net(args, env)
    ppo = PPO(env, PPOConfig(), network=template)
    network = restore_network(args.checkpoint, template)
    gen = torch.Generator(device=ppo.device).manual_seed(args.seed)
    stats = {k: float(v) for k, v in ppo.evaluate(network, gen, args.eval_episodes).items()}
    print(json.dumps(stats))
    return stats


def main(argv=None, device: str = "cuda"):
    """The CLI; ``device`` places the env and the network (the JAX CLI's
    flags, none added)."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    add_env_args(t)
    t.add_argument("--num_envs", type=int, default=256)
    t.add_argument("--rollout_steps", type=int, default=128)
    # 0 = exact per-step resets (the repo's convention); 64 amortizes them
    t.add_argument("--cached_reset_refresh", type=int, default=0,
                   help="reset-pool refresh period; 0 = exact per-step resets (default)")
    t.add_argument("--n_epochs", type=int, default=4)
    t.add_argument("--num_minibatches", type=int, default=8)
    t.add_argument("--learning_rate", type=float, default=3e-4)
    t.add_argument("--clip_eps", type=float, default=0.2)
    t.add_argument("--entropy_coef", type=float, default=0.0)
    t.add_argument("--total_timesteps", type=int, default=150_000_000)
    t.add_argument("--eval_every_updates", type=int, default=40)
    t.add_argument("--eval_episodes", type=int, default=8)
    t.add_argument("--log_dir", type=str, default=None)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--init_from", type=str, default=None)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval")
    add_env_args(e)
    e.add_argument("--checkpoint", type=str, required=True)
    e.add_argument("--eval_episodes", type=int, default=8)
    e.add_argument("--seed", type=int, default=0)
    e.set_defaults(fn=cmd_eval)

    args = parser.parse_args(argv)
    args.device = device
    return args.fn(args)


if __name__ == "__main__":
    main()
