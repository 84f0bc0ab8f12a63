"""The archived r4 gate policy's reference figures and its port copy.

Two jobs, both on the CPU, both from the repo's own orbax checkpoint
``policies_gates_vision_r4/best_model_800_149_25_485_2`` (the r4 recipe of
``gates_vision_r4.py``: 32 x 32 px, conv (16, 32, 32), trunk (128,)):

``eval``  runs the JAX package's deterministic eval of that policy
          (``PPO.evaluate`` under ``jit``, key ``PRNGKey(seed)``) over
          ``--episodes`` episodes and writes its mean/std reward and length
          and the standard errors to ``gates_vision_r4_jax_cpu_eval.json``
          beside this file. The PyTorch port's on-card eval of the same
          policy is held to ``mean_reward - 3 * sem_reward`` from there.
``npz``   writes ``pyflyt_tpu_torch/assets/policies/gates_vision_r4.npz``:
          the checkpoint's params through
          ``convert.vision_actor_critic_from_flax`` and
          ``rl.checkpoint.save_policy_npz``.
``port-eval`` runs the PyTorch port's ``PPO.evaluate`` of that npz on the
          CPU (plain physics, ``torch.Generator().manual_seed(seed)``) and
          prints its mean/std reward and length.

Run from the repo root::

    python docs/artifacts/gates_vision_r4_reference.py eval --episodes 256
    python docs/artifacts/gates_vision_r4_reference.py npz
    python docs/artifacts/gates_vision_r4_reference.py port-eval --episodes 256 --seed 1500
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ARCHIVE = os.path.join(ROOT, "docs/artifacts/policies_gates_vision_r4/best_model_800_149_25_485_2")
OUT = os.path.join(ROOT, "docs/artifacts/gates_vision_r4_jax_cpu_eval.json")
NPZ = os.path.join(ROOT, "pyflyt_tpu_torch/assets/policies/gates_vision_r4.npz")
RES = 32


def archived_params():
    """(ppo, params): the r4 env and net, and the checkpoint's params as
    numpy."""
    from pyflyt_tpu.envs.quadx_gates import QuadXGatesEnv
    from pyflyt_tpu.rl import PPO, PPOConfig
    from pyflyt_tpu.rl import checkpoint as jckpt
    from pyflyt_tpu.rl.networks import VisionActorCritic

    env = QuadXGatesEnv(camera_resolution=(RES, RES))
    net = VisionActorCritic(
        action_dim=4, image_offset=env.combined_size, image_shape=(4, RES, RES),
        conv_features=(16, 32, 32), feature_sizes=(128,), init_log_std=-0.5,
    )
    ppo = PPO(env, PPOConfig(), network=net)
    width = env.combined_size + 4 * RES * RES + 3 * env.num_targets
    init = net.init(jax.random.PRNGKey(0), jnp.zeros((1, width)))
    return ppo, jax.tree.map(np.asarray, jckpt.restore_params(ARCHIVE, init))


def cmd_eval(args):
    ppo, params = archived_params()
    t0 = time.perf_counter()
    m = jax.jit(ppo.evaluate, static_argnums=2)(
        jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(args.seed), args.episodes
    )
    m = {k: float(np.asarray(v)) for k, v in m.items()}
    n = args.episodes
    row = {
        "policy": os.path.relpath(ARCHIVE, ROOT), "episodes": n, "seed": args.seed, "res": RES,
        "backend": jax.default_backend(), **m,
        "sem_reward": m["std_reward"] / math.sqrt(n), "sem_length": m["std_length"] / math.sqrt(n),
        "floor_reward": m["mean_reward"] - 3.0 * m["std_reward"] / math.sqrt(n),
        "seconds": time.perf_counter() - t0,
    }
    with open(OUT, "w") as f:
        json.dump(row, f, indent=1)
        f.write("\n")
    print(json.dumps(row))


def cmd_npz(args):
    from pyflyt_tpu_torch.convert import vision_actor_critic_from_flax
    from pyflyt_tpu_torch.rl.checkpoint import save_policy_npz

    ppo, params = archived_params()
    net = vision_actor_critic_from_flax(params, ppo.env.combined_size, (4, RES, RES), device="cpu")
    save_policy_npz(NPZ, net)
    print(NPZ)


def cmd_port_eval(args):
    import torch

    from pyflyt_tpu_torch.envs.quadx_gates import QuadXGatesEnv
    from pyflyt_tpu_torch.rl import PPO, PPOConfig, checkpoint

    net = checkpoint.load_policy_npz(NPZ, device="cpu")
    env = QuadXGatesEnv(device="cpu", camera_resolution=(RES, RES))
    m = PPO(env, PPOConfig(), network=net).evaluate(net, torch.Generator().manual_seed(args.seed), args.episodes)
    print(json.dumps({"episodes": args.episodes, "seed": args.seed, **{k: float(v) for k, v in m.items()}}))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("eval")
    e.add_argument("--episodes", type=int, default=256)
    e.add_argument("--seed", type=int, default=0)
    e.set_defaults(fn=cmd_eval)
    sub.add_parser("npz").set_defaults(fn=cmd_npz)
    e = sub.add_parser("port-eval")
    e.add_argument("--episodes", type=int, default=256)
    e.add_argument("--seed", type=int, default=0)
    e.set_defaults(fn=cmd_port_eval)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
