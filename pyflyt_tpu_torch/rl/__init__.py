"""On-device RL training (PPO) for the port's batched envs (port of
``pyflyt_tpu/rl``)::

    from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv
    from pyflyt_tpu_torch.rl import PPO, PPOConfig, TrainConfig, train

    ppo = PPO(PackedQuadXHoverEnv(), PPOConfig(num_envs=8192, cached_reset_refresh=64))
    runner = train(ppo, TrainConfig(total_timesteps=10_000_000))
"""

from pyflyt_tpu_torch.rl import checkpoint  # noqa: F401
from pyflyt_tpu_torch.rl.ppo import PPO, PPOConfig, RunnerState  # noqa: F401
from pyflyt_tpu_torch.rl.train import TrainConfig, train  # noqa: F401
