"""Per-episode CSV loggers for the trajectory-following envs (port of
``pyflyt_tpu/utils/trajectory_logger.py``).

- Fast variant: 33 columns over the 19-dim state. The reference's ``add``
  emits 32 values against 33 headers (the ``maximum_velocity (m/s)``
  column has none); as in the JAX logger, the header is kept for schema
  parity and 0.0 is written in that column so rows stay aligned.
- Slow variant: the hovering logger's 34 columns, so it is the hovering
  logger.

The PNG dashboard is drawn only where matplotlib is installed and
``make_plots`` is not False.
"""

from __future__ import annotations

import csv
import importlib.util
import os

import numpy as np

from pyflyt_tpu_torch.utils.hovering_logger import HoveringLogger

TrajectorySlowLogger = HoveringLogger

FAST_COLUMNS = [
    "timestep",
    "x (m)", "y (m)", "z (m)",
    "x_dot (m/s)", "y_dot (m/s)", "z_dot (m/s)",
    "phi (rad)", "theta (rad)", "psi (rad)",
    "phi (deg)", "theta (deg)", "psi (deg)",
    "p (rad/s)", "q (rad/s)", "r (rad/s)",
    "p (deg/s)", "q (deg/s)", "r (deg/s)",
    "error_x (m)", "error_y (m)", "error_z (m)",
    "delta_x (m)", "delta_y (m)", "delta_z (m)",
    "angle_diff (rad)", "angle_diff (deg)",
    "maximum_velocity (m/s)",
    "motor_1_input (PWM [0-1])", "motor_2_input (PWM [0-1])",
    "motor_3_input (PWM [0-1])", "motor_4_input (PWM [0-1])",
    "reward",
]


class TrajectoryFastLogger:
    """Buffers rows from the fast env's 19-dim state; writes a CSV (and
    optionally a PNG) per episode."""

    def __init__(self, log_dir: str | None = None, make_plots: bool | None = None):
        self.log_dir = log_dir
        if make_plots is None:  # the dashboard only where matplotlib exists
            make_plots = importlib.util.find_spec("matplotlib") is not None
        self.make_plots = make_plots
        self.buffer: list[list[float]] = []
        self.episode_idx = 0
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)

    def add(self, timestep, state, action, reward):
        """One row from the unnormalized 19-dim state and the 4-dim PWM."""
        state = np.asarray(state, dtype=np.float64)
        action = np.asarray(action, dtype=np.float64)
        row = np.concatenate([
            [float(timestep)],
            state[0:9],
            np.rad2deg(state[6:9]),
            state[9:12],
            np.rad2deg(state[9:12]),
            state[12:19],
            [np.rad2deg(state[18])],
            [0.0],  # maximum_velocity: the reference writes no value (module docstring)
            action,
            [float(reward)],
        ]).round(3)
        self.buffer.append(row.tolist())

    def log_episode(self) -> str | None:
        """Flushes the buffer to the episode's CSV (and PNG); returns the
        CSV's path."""
        if not self.buffer or not self.log_dir:
            self.buffer = []
            return None
        path = os.path.join(self.log_dir, f"evaluation_results_{self.episode_idx}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(FAST_COLUMNS)
            w.writerows(self.buffer)
        if self.make_plots:
            self._plot(np.asarray(self.buffer), path.replace(".csv", ".png"))
        self.buffer = []
        self.episode_idx += 1
        return path

    def _plot(self, data: np.ndarray, png_path: str) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        t = data[:, 0]
        fig, ax = plt.subplots(2, 3, figsize=(15, 7), layout="constrained")
        actual = data[:, 1:4]
        target = actual + data[:, 19:22]
        for i, name in enumerate("xyz"):
            ax[0, i].plot(t, target[:, i], label="Reference")
            ax[0, i].plot(t, actual[:, i], label="Actual")
            ax[0, i].set_title(f"{name} (m)")
            ax[0, i].legend()
        ax[1, 0].plot(t, data[:, 25])
        ax[1, 0].set_title("angle_diff (rad)")
        for c in range(28, 32):
            ax[1, 1].plot(t, data[:, c], label=f"m{c - 27}")
        ax[1, 1].set_title("motors (PWM)")
        ax[1, 1].legend()
        ax[1, 2].plot(t, data[:, 32])
        ax[1, 2].set_title("reward")
        for a in ax.flat:
            a.grid(True)
        fig.savefig(png_path, dpi=80)
        plt.close(fig)
