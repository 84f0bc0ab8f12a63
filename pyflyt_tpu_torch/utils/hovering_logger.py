"""Per-episode CSV logger for the hovering envs (port of
``pyflyt_tpu/utils/hovering_logger.py``).

It buffers one 34-column row per step and, at the end of an episode,
writes ``evaluation_results_{i}.csv``. The column schema is the JAX
package's verbatim (the reference's ``quadx_hovering_logger.py``), so the
fork's offline tooling reads these CSVs unchanged. The trajectory
dashboard PNG is optional: it is drawn only where matplotlib is installed
and ``make_plots`` is not False.
"""

from __future__ import annotations

import csv
import importlib.util
import os

import numpy as np

COLUMNS = [
    "timestep",
    "target_x (m)", "target_y (m)", "target_z (m)",
    "target_psi (rad)", "target_psi (deg)",
    "x (m)", "y (m)", "z (m)",
    "x_dot (m/s)", "y_dot (m/s)", "z_dot (m/s)",
    "phi (rad)", "phi (deg)",
    "theta (rad)", "theta (deg)",
    "psi (rad)", "psi (deg)",
    "p (rad/s)", "p (deg/s)",
    "q (rad/s)", "q (deg/s)",
    "r (rad/s)", "r (deg/s)",
    "error_x (m)", "error_y (m)", "error_z (m)",
    "error_psi (rad)", "error_psi (deg)",
    "motor_1_input (PWM [0-1])", "motor_2_input (PWM [0-1])",
    "motor_3_input (PWM [0-1])", "motor_4_input (PWM [0-1])",
    "reward",
]


class HoveringLogger:
    """Buffers per-step rows; writes a CSV (and optionally a PNG) per
    episode."""

    def __init__(self, log_dir: str | None = None, make_plots: bool | None = None):
        self.log_dir = log_dir
        if make_plots is None:  # the dashboard only where matplotlib exists
            make_plots = importlib.util.find_spec("matplotlib") is not None
        self.make_plots = make_plots
        self.buffer: list[list[float]] = []
        self.episode_idx = 0
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)

    def add(self, timestep, target_pos, target_psi, state, action, reward):
        """One row from the unnormalized 16-dim state and the 4-dim PWM."""
        state = np.asarray(state, dtype=np.float64)
        action = np.asarray(action, dtype=np.float64)
        lin_pos, lin_vel = state[0:3], state[3:6]
        ang_pos, ang_vel = state[6:9], state[9:12]
        pos_err, psi_err = state[12:15], state[15]
        row = [
            float(timestep),
            *np.asarray(target_pos, dtype=np.float64),
            float(target_psi), float(np.rad2deg(target_psi)),
            *lin_pos,
            *lin_vel,
            ang_pos[0], np.rad2deg(ang_pos[0]),
            ang_pos[1], np.rad2deg(ang_pos[1]),
            ang_pos[2], np.rad2deg(ang_pos[2]),
            ang_vel[0], np.rad2deg(ang_vel[0]),
            ang_vel[1], np.rad2deg(ang_vel[1]),
            ang_vel[2], np.rad2deg(ang_vel[2]),
            *pos_err,
            float(psi_err), float(np.rad2deg(psi_err)),
            *action,
            float(reward),
        ]
        self.buffer.append([float(v) for v in row])

    def log_episode(self) -> str | None:
        """Flushes the buffer to the episode's CSV (and PNG); returns the
        CSV's path."""
        if not self.buffer or not self.log_dir:
            self.buffer = []
            return None
        csv_path = os.path.join(self.log_dir, f"evaluation_results_{self.episode_idx}.csv")
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(COLUMNS)
            w.writerows(self.buffer)
        if self.make_plots:
            self._plot(np.asarray(self.buffer), csv_path.replace(".csv", ".png"))
        self.buffer = []
        self.episode_idx += 1
        return csv_path

    def _plot(self, data: np.ndarray, png_path: str) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        t = data[:, 0]
        fig, axes = plt.subplots(3, 3, figsize=(15, 10))
        panels = [
            ("x (m)", 6, 1), ("y (m)", 7, 2), ("z (m)", 8, 3),
            ("phi (deg)", 13, None), ("theta (deg)", 15, None), ("psi (deg)", 17, 5),
            ("error_x/y/z (m)", None, None), ("motors (PWM)", None, None), ("reward", 33, None),
        ]
        for ax, (title, col, target_col) in zip(axes.flat, panels):
            if title == "error_x/y/z (m)":
                for c, lbl in ((24, "ex"), (25, "ey"), (26, "ez")):
                    ax.plot(t, data[:, c], label=lbl)
                ax.legend()
            elif title == "motors (PWM)":
                for c in range(29, 33):
                    ax.plot(t, data[:, c], label=f"m{c - 28}")
                ax.legend()
            else:
                ax.plot(t, data[:, col])
                if target_col is not None:
                    ax.plot(t, data[:, target_col], "--")
            ax.set_title(title)
            ax.grid(True)
        fig.tight_layout()
        fig.savefig(png_path, dpi=80)
        plt.close(fig)
