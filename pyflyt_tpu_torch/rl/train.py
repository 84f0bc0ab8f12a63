"""High-level training loop (port of ``pyflyt_tpu/rl/train.py``): PPO
iterations until the step budget is spent, periodic deterministic eval,
metrics to ``metrics.jsonl``, best-model and periodic checkpoints, an
optional Polyak-averaged parameter shadow, early stopping, and warm starts
from a checkpoint. One card; ``use_mesh=True`` raises (ROADMAP.md, open
item 24).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from typing import Callable

import numpy as np
import torch

from pyflyt_tpu_torch.rl import checkpoint
from pyflyt_tpu_torch.rl.ppo import PPO, RunnerState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_timesteps: int = 100_000_000
    eval_every_updates: int = 20
    eval_episodes: int = 16
    log_dir: str | None = None
    checkpoint_every_updates: int = 0  # 0 = only best-model checkpoints
    use_mesh: bool = False
    seed: int = 0
    # warm start: a checkpoint whose network seeds this run (fresh
    # optimizer and env states)
    init_from: str | None = None
    # Polyak-averaged parameter shadow (0.0 = off): ema = d*ema + (1-d)*params
    # after each update; both are evaluated (`eval_*`, `eval_ema_*`) and each
    # keeps its own best-model checkpoint
    param_ema: float = 0.0
    # stop after this many evals without a new best (0 = never)
    early_stop_patience: int = 0


def _eval_generator(device: torch.device, seed: int, update: int) -> torch.Generator:
    """The eval stream of one update: a fixed function of (seed, update),
    as the JAX package folds the update into the seed's key."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + update)


def train(
    ppo: PPO,
    tcfg: TrainConfig = TrainConfig(),
    on_metrics: Callable[[int, dict], None] | None = None,
) -> RunnerState:
    """Runs PPO until ``total_timesteps`` env steps are consumed."""
    if tcfg.use_mesh:
        raise NotImplementedError("train(use_mesh=True): ROADMAP.md, open item 24 (parallel/mesh)")
    runner = ppo.init(tcfg.seed)
    if tcfg.init_from:
        runner.network = checkpoint.restore_params(tcfg.init_from, runner.network)
        runner.opt_state = type(runner.opt_state).zeros(runner.network)

    ema = None
    if tcfg.param_ema:
        if not 0.0 < tcfg.param_ema < 1.0:
            raise ValueError("param_ema must be in (0, 1)")
        ema = copy.deepcopy(runner.network)

    steps_per_update = ppo.config.batch_size
    num_updates = max(1, tcfg.total_timesteps // steps_per_update)
    log_f = None
    if tcfg.log_dir:
        os.makedirs(tcfg.log_dir, exist_ok=True)
        log_f = open(os.path.join(tcfg.log_dir, "metrics.jsonl"), "a")

    best_reward = -np.inf
    best_ema_reward = -np.inf
    evals_since_improvement = 0
    eval_history: list[dict] = []
    t_start = time.perf_counter()
    try:
        for update in range(num_updates):
            runner, metrics = ppo.train_iteration(runner)
            if ema is not None:
                with torch.no_grad():
                    e, p = list(ema.parameters()), list(runner.network.parameters())
                    torch._foreach_mul_(e, tcfg.param_ema)
                    torch._foreach_add_(e, p, alpha=1.0 - tcfg.param_ema)

            if (update + 1) % tcfg.eval_every_updates == 0 or update == num_updates - 1:
                gen = lambda: _eval_generator(ppo.device, tcfg.seed, update)  # noqa: E731
                stats = {k: float(v) for k, v in ppo.evaluate(runner.network, gen(), tcfg.eval_episodes).items()}
                ema_stats = None
                if ema is not None:
                    ema_stats = {k: float(v) for k, v in ppo.evaluate(ema, gen(), tcfg.eval_episodes).items()}
                elapsed = time.perf_counter() - t_start
                row = {
                    "update": update + 1,
                    "env_steps": (update + 1) * steps_per_update,
                    "steps_per_s": (update + 1) * steps_per_update / elapsed,
                    **{k: float(v) for k, v in metrics.items()},
                    **{f"eval_{k}": v for k, v in stats.items()},
                    **({f"eval_ema_{k}": v for k, v in ema_stats.items()} if ema_stats else {}),
                }
                eval_history.append(row)
                if on_metrics is not None:
                    on_metrics(update + 1, row)
                if log_f:
                    log_f.write(json.dumps(row) + "\n")
                    log_f.flush()

                improved = False
                if stats["mean_reward"] > best_reward:
                    best_reward = stats["mean_reward"]
                    improved = True
                    if tcfg.log_dir:
                        name = checkpoint.best_model_name(
                            update + 1, stats["mean_length"], stats["std_length"],
                            stats["mean_reward"], stats["std_reward"],
                        )
                        checkpoint.save(os.path.join(tcfg.log_dir, name), runner)
                if ema_stats is not None and ema_stats["mean_reward"] > best_ema_reward:
                    best_ema_reward = ema_stats["mean_reward"]
                    improved = True
                    if tcfg.log_dir:
                        name = "best_model_ema" + checkpoint.best_model_name(
                            update + 1, ema_stats["mean_length"], ema_stats["std_length"],
                            ema_stats["mean_reward"], ema_stats["std_reward"],
                        ).removeprefix("best_model")
                        checkpoint.save(
                            os.path.join(tcfg.log_dir, name), dataclasses.replace(runner, network=ema)
                        )
                evals_since_improvement = 0 if improved else evals_since_improvement + 1
                if tcfg.early_stop_patience and evals_since_improvement >= tcfg.early_stop_patience:
                    break

            if tcfg.checkpoint_every_updates and tcfg.log_dir and (update + 1) % tcfg.checkpoint_every_updates == 0:
                checkpoint.save(os.path.join(tcfg.log_dir, f"ckpt_{update + 1}"), runner)
    finally:
        if log_f:
            log_f.close()
        if tcfg.log_dir:
            np.savez(
                os.path.join(tcfg.log_dir, "evaluations.npz"),
                history=np.asarray([json.dumps(r) for r in eval_history], dtype=object),
            )
    return runner
