"""Self-play dogfight PPO training and evaluation CLI (port of
``pyflyt_tpu/rl_training/dogfight_selfplay.py``): the same subcommands,
flags and defaults, on the port's ``SelfPlayDogfightEnv`` (one K7 launch
per agent step), ``PPO`` and ``train``. ``--device`` (default ``cuda``)
is the port's own flag.

Usage::

    python -m pyflyt_tpu_torch.rl_training.dogfight_selfplay train \\
        --num_envs 8192 --cached_reset_refresh 64 --log_dir runs/dogfight
    python -m pyflyt_tpu_torch.rl_training.dogfight_selfplay eval-vs \\
        --checkpoint dogfight_league_r5_s100 [--opponent dogfight_league_r5_init]

``eval-vs`` pits the checkpoint (drone 0) against an opponent policy
(drone 1): another checkpoint if given, else an untrained network from
``--seed`` (the port's initialisation), and reports win, loss and draw
rates by death-based scoring and the mean health margin over full
matches. A checkpoint is a ``train`` checkpoint (``rl/checkpoint``) or a
policy ``.npz`` (``rl.checkpoint.load_policy_npz``: a path, or a name
under ``assets/policies/``).
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def build_env(args):
    from pyflyt_tpu_torch.envs import (
        MAFixedwingDogfightEnv,
        PackedMAFixedwingDogfightEnv,
        SelfPlayDogfightEnv,
    )

    base = MAFixedwingDogfightEnv(
        sparse_reward=args.sparse_reward,
        damage_per_hit=args.damage_per_hit,
        max_duration_seconds=args.max_duration_seconds,
        agent_hz=args.agent_hz,
        noisy_motors=args.noisy_motors,
        device=args.device,
    )
    return SelfPlayDogfightEnv(penv=PackedMAFixedwingDogfightEnv(base=base))


def add_env_args(p: argparse.ArgumentParser):
    p.add_argument("--sparse_reward", type=lambda v: v != "False", default=False)
    p.add_argument("--noisy_motors", type=lambda v: v != "False", default=True)
    p.add_argument("--damage_per_hit", type=float, default=0.02)
    p.add_argument("--max_duration_seconds", type=float, default=60.0)
    p.add_argument("--agent_hz", type=int, default=30)
    # 0 = exact per-step arena resets (exact semantics by default); the
    # league's recipe uses the amortized arena-spawn pool, 64
    p.add_argument("--cached_reset_refresh", type=int, default=0,
                   help="reset-pool refresh period; 0 = exact per-step resets (default)")
    p.add_argument("--layer_size", type=int, default=256)
    p.add_argument("--num_of_layers", type=int, default=2)
    p.add_argument("--init_log_std", type=float, default=-1.0)
    p.add_argument("--device", type=str, default="cuda")


def mk_ppo(args, env):
    from pyflyt_tpu_torch.rl import PPO, PPOConfig

    return PPO(
        env,
        PPOConfig(
            num_envs=args.num_envs,
            rollout_steps=args.rollout_steps,
            num_epochs=args.n_epochs,
            num_minibatches=args.num_minibatches,
            learning_rate=args.learning_rate,
            clip_eps=args.clip_eps,
            entropy_coef=args.entropy_coef,
            init_log_std=args.init_log_std,
            feature_sizes=tuple([args.layer_size] * args.num_of_layers),
            # arenas reset mid-rollout many times early on: the slot
            # bootstrap's one-truncation invariant does not hold here
            slot_bootstrap=False,
            cached_reset_refresh=args.cached_reset_refresh,
        ),
    )


def cmd_train(args):
    from pyflyt_tpu_torch.rl import TrainConfig, train

    env = build_env(args)
    ppo = mk_ppo(args, env)
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


@torch.no_grad()
def evaluate_versus(env, apply_a, apply_b, generator: torch.Generator, num_matches: int) -> dict:
    """Full matches of policy A (drone 0) against policy B (drone 1) on the
    packed kernel, ``max_steps + 2`` agent steps (or until every match has
    ended: later steps change no result). Returns win/loss/draw rates by
    who died at the match's end (shot down, collided or out of the dome;
    not the termination flag, which the other-dead rule also raises for
    the survivor), the health margin breaking survivor ties."""
    penv = env.penv
    st, obs = penv.reset(num_matches, generator)
    dev = obs.device
    done = torch.zeros(num_matches, dtype=torch.bool, device=dev)
    health_end = torch.ones(num_matches, 2, device=dev)
    dead_end = torch.zeros(num_matches, 2, dtype=torch.bool, device=dev)
    for t in range(env.max_steps + 2):
        act = torch.stack([apply_a(obs[:, 0]), apply_b(obs[:, 1])], dim=1)
        st, out = penv.step(st, act)
        now = (out.termination | out.truncation).any(dim=1)
        fresh = (now & ~done)[:, None]
        healths = out.info["healths"][:, 0, :]
        health_end = torch.where(fresh, healths, health_end)
        dead_now = (healths <= 0.0) | out.info["collision"] | out.info["out_of_bounds"]
        dead_end = torch.where(fresh, dead_now, dead_end)
        done = done | now
        obs = out.obs
        if t % 32 == 31 and bool(done.all()):
            break
    h, dead = health_end.cpu(), dead_end.cpu()
    margin = h[:, 0] - h[:, 1]
    wins = (dead[:, 1] & ~dead[:, 0]) | ((dead[:, 1] == dead[:, 0]) & (margin > 1e-6))
    losses = (dead[:, 0] & ~dead[:, 1]) | ((dead[:, 0] == dead[:, 1]) & (margin < -1e-6))
    return {
        "matches": int(num_matches),
        "finished": int(done.sum()),
        "win_rate_a": float(wins.float().mean()),
        "loss_rate_a": float(losses.float().mean()),
        "draw_rate": float((~wins & ~losses).float().mean()),
        "mean_health_margin_a": float(margin.mean()),
        "a_died": int(dead[:, 0].sum()),
        "b_died": int(dead[:, 1].sum()),
    }


def load_policy(path: str, template):
    """A policy network: a ``.npz`` file or policy name
    (``load_policy_npz``), else a ``train`` checkpoint restored into
    ``template``'s shape."""
    from pyflyt_tpu_torch.rl import checkpoint

    if path.endswith(".npz") or os.path.exists(os.path.join(checkpoint.POLICY_DIR, f"{path}.npz")):
        return checkpoint.load_policy_npz(path, device=template.log_std.device)
    return checkpoint.restore_params(path, template)


def cmd_eval_vs(args):
    from pyflyt_tpu_torch.rl.networks import ActorCritic
    from pyflyt_tpu_torch.rl.ppo import act_deterministic, action_bounds

    env = build_env(args)
    template = ActorCritic(
        env.obs_size, env.action_size, feature_sizes=tuple([args.layer_size] * args.num_of_layers),
        init_log_std=args.init_log_std, device=env.device, generator=torch.Generator().manual_seed(args.seed),
    )
    net_a = load_policy(args.checkpoint, template)
    net_b = load_policy(args.opponent, template) if args.opponent else template  # else the untrained init
    low, high = action_bounds(env, env.device)
    out = evaluate_versus(
        env, lambda o: act_deterministic(net_a, o, low, high), lambda o: act_deterministic(net_b, o, low, high),
        torch.Generator(device=env.device).manual_seed(args.seed), args.num_matches,
    )
    print(json.dumps(out))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    add_env_args(t)
    t.add_argument("--num_envs", type=int, default=4096, help="agent ROWS (= 2x arenas)")
    t.add_argument("--rollout_steps", type=int, default=128)
    t.add_argument("--n_epochs", type=int, default=4)
    t.add_argument("--num_minibatches", type=int, default=16)
    t.add_argument("--learning_rate", type=float, default=3e-4)
    t.add_argument("--clip_eps", type=float, default=0.2)
    t.add_argument("--entropy_coef", type=float, default=0.0)
    t.add_argument("--total_timesteps", type=int, default=500_000_000)
    t.add_argument("--eval_every_updates", type=int, default=50)
    t.add_argument("--eval_episodes", type=int, default=16)
    t.add_argument("--log_dir", type=str, default=None)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--init_from", type=str, default=None)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval-vs")
    add_env_args(e)
    e.add_argument("--checkpoint", type=str, required=True)
    e.add_argument("--opponent", type=str, default=None)
    e.add_argument("--num_matches", type=int, default=64)
    e.add_argument("--seed", type=int, default=0)
    e.set_defaults(fn=cmd_eval_vs)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
