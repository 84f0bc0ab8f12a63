#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pyflyt_tpu_torch``) on one card.

Run from the root of a checkout on a machine with an NVIDIA H100, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA:

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, each of which fails the script on a failed check:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds every kernel of the main path from pyflyt_tpu_torch/csrc, one
     nvcc process per source, all started together; then, in a child
     process on those libraries, traces one launch of rows 1, 2, 4, 5, 6,
     8, 9 and 10 with torch.profiler and checks its grid, block and
     registers a thread (CUPTI's kernel record) against the source's
     THREADS and GROUP (the lanes an env; rows 1, 2 and 4 are one thread an
     env), and counts K2g's own CUDA kernels in a 4-minibatch call and the
     resident K4g's and K3g's in one call each (one kernel);
  3. holds the hover-step kernel against its plain twin on the card: noise
     off, N=8192, a ragged N=1000 and a mid-warp N=4093 (its envs
     truncating at staggered agent steps), 20 agent steps with half the
     fleet at zero thrust; then noise on, the per-lane throttle spread, and
     two noisy calls bit-identical;
  4. holds the policy/value forward kernel against its plain twin at
     n=8192 and n=1000 with TF32 off;
  5. drives the main path: a 2x256 ActorCritic acting in 8192
     PackedQuadXHoverEnv envs with cached auto-reset (refresh 64) for 256
     agent steps, checking that each kernel was launched once per step;
  6. times each kernel against its bound, its plain twin and (where one
     exists) one PyTorch library call, times single rollout steps
     (steady and cache-refresh steps apart);
  7. holds the log-prob kernel (K3) against its plain twin over the PPO
     batch's 262,144 packed rows and a ragged 1000, with TF32 off;
  8. holds the epoch kernel (K2) against its plain twin for one epoch of
     4 minibatches of 8192 rows and one of 2 minibatches of 1000 rows,
     from seeded weights and seeded non-zero Adam moments, then at obs
     33, 35, 64 and 21 with 1 and 8 actions, with and without a log_std
     range, at 8192 and 1000 rows, and at more row tiles than its
     forward/backward has consumers (the dogfight recipe's 65,536 rows at
     obs 30, and 20,000 rows at obs 64); checks that two calls give
     bit-identical outputs and that the weight images the last Adam step
     wrote equal ``pack_trunk`` of the returned leaves, byte for byte (at
     the hover and the dogfight shapes); times K2 at obs 21 and 33 (8192
     rows) and 30 (65,536 rows);
  9. drives the training path: PPO with ``fused_sgd`` and the fused
     rollout forward on 8192 PackedQuadXHoverEnv envs at PPOConfig's
     defaults (32 steps, 15 epochs x 32 minibatches), 3 iterations (the
     first a warm-up), checking the launches of every kernel per iteration
     and Adam's count, and prints the ``train`` line (phase split); then
     ``train`` itself on 512 envs (one iteration, deterministic eval,
     metrics and best-model checkpoint under build/) and a checkpoint
     round trip whose resumed iteration must equal the uninterrupted one;
 10. times K3 and K2 at the training path's shapes against their bounds,
     their plain twins and a library yardstick, and counts the CUDA
     kernels of one K2 call (torch.profiler);
 11-16. the generic QuadX kernel (K1 generic) against its twin over modes
     0/8/9 x ENU/NED x wind at N=8192, a ragged 1000 and a mid-warp 4093,
     its draws by their statistics and two noisy calls bit-identical, the
     ``cuda_quadx.step`` drop-in and the ``use_kernel`` env, the 8192-env
     mod-hovering rollout and training (``ppo_solve_r5``'s recipe), the
     hovering CLI (``train``, ``eval``, ``eval-pid-expert`` in modes 7 and
     10), the trajectory CLI's ``eval-pid-expert`` (mode 10) on scenarios
     1-3, and ``hovering train --flight_mode -1 --num_envs 2048`` for one
     iteration, then one fused iteration on that env (K4, K3, K2 counted);
 17. K1 generic in mode 7 (80 rows, ENU) against its twin at N=8192 and
     1000 for three winds, and the mode-7 ``cuda_quadx.step`` drop-in
     against ``models.quadx.step``;
 18. the waypoints kernel (row 4) against its twin in modes 7, 0 and 8 at
     N=8192, 1000 and a mid-warp 4093 (there truncating at staggered agent
     steps) over 20 agent steps, reach, advance, all-reached, termination,
     truncation and the freeze all firing, its noise by the throttle spread
     and two noisy calls bit-identical;
 19. K4 at the waypoints env's observation width 33 against its twin;
 20. the waypoints serving path: K4 acting in 8192 stock mode-7
     PackedQuadXWaypointsEnv envs for 128 steps, one launch of each per
     step, and the per-step split (``wp_rollout``);
 21. PPOConfig's defaults at 8192 envs on QuadXWaypointsEnv(flight_mode=7,
     use_kernel=True), a warm-up and a timed iteration, env_step_ratio K1
     launches per env step (``wp_train``); then one ``fused_sgd`` iteration
     there, K3 and K2 at obs 33, with its launch counts
     (``wp_fused_train``);
 22. times and bounds at the waypoints shapes (row 4, K1 generic mode 7,
     K4 and K3 at obs 33), then K4, K3 and K2 at the recipe's shapes;
 23. ``fw_checks``: K5's row 5 against its twin on 4096 and 1000 random
     airborne states, modes -1/0 x fixedwing/acrowing, per row group;
     the main path of rows 7 -> 5 (``cuda_fixedwing.step`` against
     ``models.fixedwing.step``, 30 steps per case) and the noise;
 24. ``fw_waypoints_checks``: row 6 against its twin at 4096 stock envs
     and with a 25 m reach, reach, all-reached, termination, truncation,
     out-of-dome, collision and the freeze all firing;
 25. ``fw_rollout``: the archived r5 policy acting (sampled) through K4 at
     obs 35 in 4096 stock PackedFixedwingWaypointsEnv envs for 128 steps,
     one row-6 and one K4 launch per step, the per-step split and the
     device's busy share;
 26. ``fw_eval``: that policy flown deterministically for 256 full
     episodes, against the archive's numbers (fails under 3.0 targets);
 27. ``fw_train``: fixedwing_rl_r5.py's lr3e-4 recipe on the plain env, a
     warm-up and a timed iteration;
 28. ``fw_kernel_times``: rows 5 and 6 against their bounds, ptxas
     registers per variant, K4 at obs 35 (their launch records: phase 2);
 29. ``df_checks``: K7 (the dogfight agent step) against its twin, noise
     off, stock 30 Hz, 20 agent steps at 4096 and a ragged 999 arenas,
     with preset lanes that fire hits, mutual collision, ground contact,
     out-of-dome, time-limit truncation and other-dead, the lanes beyond
     tolerance counted per trap; then its noise by its statistics;
 30. ``df_rollout``: the league's s100 policy (K4 at obs 30, checked
     against its twin first) acting, sampled, in SelfPlayDogfightEnv at
     8192 rows with cached arena auto-reset 64 for 128 steps, one K7 and
     one K4 launch per step, the per-step split and the device's busy
     share; a short plain MAQuadXHoverEnv run;
 31. ``df_duel``: ``evaluate_versus`` of s100 against init and init
     against s100, 256 matches each, deterministic actions, noise on,
     beside the archive's rates (fails under 0.95 for s100 in either
     seat);
 32. ``df_train``: the league recipe at 8192 rows, a warm-up and a timed
     iteration on the default f32 path, then with ``fused_sgd``;
 33. ``df_kernel_times``: K7 against its bound and its twin, its ptxas
     report;
 34. ``rk_checks``: K6's row 8 (one rocket aviary step) against its twin,
     noise off, on 8192 and a ragged 1000 random airborne states with the
     booster lit and the finlets and gimbal swung, then with a fuel-out
     burn, and at a mid-warp 1001; row 8's main path, 30 chained steps
     settling 8192 rockets on the ground and 8192 on pads, each step held
     against its twin per lane; row 9 (the Rocket-Landing agent step)
     against its twin over 30 steps in the L0 env at 8192, 1000 and a
     mid-warp 1001 envs (there the free envs truncating at staggered agent
     steps) with preset lanes that fire a soft touchdown that completes, a
     hard touchdown, a ground hit, below ground, out of bounds by
     displacement and by the ceiling, truncation and the freeze, the lanes
     beyond tolerance counted per trap; then the noise of both by the
     throttle's spread, and two noisy calls bit-identical;
 35. ``k4_rocket_policy``: K4 at obs 33 with the archived L0 weights
     against its twin;
 36. ``rk_rollout``: L0 acting (sampled, through K4) in 8192 stock
     PackedRocketLandingEnv() envs for 128 steps, one row-9 and one K4
     launch per step, the per-step split and the device's busy share;
 37. ``rk_eval``: L0 flown deterministically for 256 episodes in its env
     with make_landing_eval's accounting, beside the archive's receipt
     (fails under a 0.90 pad rate);
 38. ``rk_kernel_times``: rows 8 and 9 against their bounds and their
     twins, their ptxas report;
 39. ``narrow_grid``, ``narrow_epochs``: the narrow trunks' kernels (K4n,
     K3n: csrc/policy_narrow.cu; K2n: csrc/fused_epoch_narrow.cu) against
     their twins: K4n over 6 trunk pairs (64-64-32-32, 32-32, 128, 48-24,
     128-64-32-16, and a 64-64-32-32 actor with a 128-16 critic) x obs 16,
     19, 21, 64 x act 1, 4, 8 x 64, 2048, 8192, 1000 and 16384 rows at
     ``policy_atol``, K3n at the same rows and at the SMALL arm's
     1,048,576-row batch, with and without a log_std range, at a tolerance
     from the data (``logp_atol``), K2n at 8 shapes
     (the r4 slow recipe's, the fast CLI's and the SMALL arm's minibatches,
     the other trunks, ragged ones) at K2's epoch tolerances, and two K2n
     calls bit-identical with the images its Adam wrote equal to
     ``pack_trunk``;
 40. ``k4n_traj_policy``, ``traj_serving``: the archived r4 slow policy
     (assets/policies/traj_slow_r4_seed0.npz) through K4n against its
     twin, and through K3n at the r4 slow recipe's 262,144-row batch,
     then acting (sampled) in 2048 r4 slow envs under the exact
     auto-reset for 128 steps, one K4n launch a step, the env's step and
     reset split;
 41. ``traj_eval``: that policy flown deterministically through K4n for
     256 episodes, against floors from the archive's 32-episode eval (its
     means less 3 standard errors of the difference of means);
 42. ``traj_train``: one timed iteration (after a warm-up) of the
     trajectory CLI's ``train`` defaults (fast env, f32) and of the r4 slow
     recipe with the fused forward and fused_sgd (K4n a step, K3n once,
     K2n an epoch), and small fused iterations at the (32, 32) and (128,)
     trunks (the narrow family's) and at (256,) (the general family's);
 43. ``small_arm_train``: ppo_20m_r4.py's SMALL fused arm (8192
     mod-hovering envs: row 2 a step, K3n once, K2n an epoch);
 44. ``narrow_kernel_times``: K4n, K3n and K2n at those shapes against
     their bounds, their twins and their library calls;
 45. ``vision_render``: the ray-cast camera (``core/camera``, no kernel of
     its own: the JAX module is plain JAX) on 256 r4 gates views at 32 and
     128 px, the card against the CPU running the same code (at most 0.5%
     of the pixels differing, each on an edge; depth within 1e-5 where the
     segmentation agrees), its wall and device time, peak memory and bound;
 46. ``vision_net``: the archived r4 gates policy's ``VisionActorCritic``
     (assets/policies/gates_vision_r4.npz) on the card against the CPU at
     256 and 4096 rows (TF32 off), its forward and forward + backward times;
 47. ``gates_eval``: that policy flown deterministically for 256 episodes
     at 32 px, with plain physics (no kernel) and with ``use_kernel`` (K1
     generic, row 2: 3 launches an agent step, counted), each against the
     JAX package's CPU eval of the same checkpoint (fails under its mean
     less 3 standard errors), beside the archive's 8-episode receipt;
 48. ``gates_train``: one timed iteration of the r4 recipe (256 × 128, 4 ×
     8) with the cached auto-reset (64) and the exact one (0);
 49. ``gates_cli``: the ``gates_vision`` CLI's ``train`` for one iteration
     at its defaults and ``eval`` on the npz;
 50. ``gates_profile``: one gates rollout step and its parts (policy,
     render, physics, the env step, the reset, the auto-reset step), wall
     and device time;
 51. ``hover7_checks``: row 1 in mode 7 (80 rows, the position cascade)
     against its twin at 8192, a ragged 1000 and a mid-warp 4093 envs
     (there truncating at staggered agent steps) over 48 agent steps of
     tests/test_packed_hover.py's setpoints, half the fleet climbing out of
     a 1.5 m dome, lane by lane; its noise and a noisy repeat;
 52. ``general_grid``: the general family's K4g and K3g
     (csrc/policy_general.cu) against their twins over 10 trunk pairs (a
     linear policy, six 48-wide layers, 160-72, a 2 x 256 actor beside a
     32-32 critic, (256,), 3 x 256, 2 x 512, 2 x 256 + 64 on the resident
     route, (1024,) past a block's width on the cluster route, (4128,)
     past a cluster's on the per-layer route) x (obs 21, act 4), (obs
     72, act 10) x 1, 1000 and 8192 rows, each launch counted on its
     route; where a pair is resident, its K4g and K3g bit for bit the
     per-layer route's at 1000 and 8192 rows;
 53. ``general_epochs``: K2g (csrc/fused_epoch_general.cu) against its
     twin at each pair on the route of its widths (the resident epoch,
     four kernels a minibatch, at every pair but (1024,) and the hovering
     CLI's 2 x 1024, which keep the per-layer route: the TMA-fed wgmma GEMM
     of csrc/policy_general.cuh a layer and pass), each launch counted on
     its route, two calls bit-identical, and K3g's log-probs equal to K2g's
     forward bit for bit (approx_kl exactly 0 on the first minibatch when
     the stored log-probs are K3g's) at the resident pairs, (1024,), 2 x
     1024 and (4128,);
 54. ``hover7_serving``: 8192 PackedQuadXHoverEnv(QuadXHoverEnv(
     flight_mode=7)) envs, a 3 x 256 ActorCritic through K4g, cached
     auto-reset 64, 256 steps (one row-1 and one K4g launch a step), and
     single steps' latency; then 64 steps at the hovering CLI's 2 x 1024
     (``--num_of_layers 2 --layer_size 1024``: one row-1 and one cluster
     K4g launch a step);
 55. ``hover7_train``: one timed PPO iteration (after a warm-up) of the
     hover fused_sgd recipe (8192 x 32, 15 x 32) on that env and trunk
     (row 1, K4g, K3g, K2g), and one at the default 2 x 256 trunk (row 1,
     K4, K3, K2) and one at 2 x 1024 (row 1, K4g and K3g on the cluster
     route, K2g per layer);
 56. ``general_kernel_times``: row 1 in mode 7, K4g, K3g and K2g at those
     shapes against their bounds, their twins and their library calls; K4g,
     K3g and K2g on the resident route, the per-layer route forced at the
     same shapes and the library call in turns (K3g also its kernel and its
     image build alone), with the resident kernels' ptxas registers and
     spills; the cluster route, the per-layer route forced and the
     library call in turns at the (1024,) trunk of ``traj_train``'s
     ``other_trunks`` (its rows; K2g per layer) and at the 2 x 1024
     training path's shapes (8192 and 262,144 rows; K2g per layer over an
     epoch of 32 x 8192 on the trained network, in turns with the
     library's 32 updates), with the cluster kernels' and the per-layer
     GEMM's ptxas (no spills);
 57. ``general_main_path_checks``: K3g over the training path's batch and
     K2g over two of its minibatches on its trained 3 x 256 network, and
     its 32 x 8192 epoch bit for bit as 32 chained one-minibatch calls;
     at 2 x 1024, on that path's trained network, a 4 x 8192 epoch bit for
     bit as 4 chained calls and on repeat (approx_kl 0);
     then the ``kernels`` line for all twenty-two kernels (rows 1, 2, 4,
     5, 6, 8, 9 and 10 with phase 2's launch records; the general
     family's routes of K4g and K3g (resident, cluster, per layer) and of
     K2g (resident, per layer) each a kernel);
 58. ``general_cluster``: K4g and K3g on the cluster route
     (csrc/policy_cluster.cuh) against their twins over 6 trunk pairs
     ((640,), (1000,), (1024,), 2 x 1024, (2048,), (1024,) beside a 32-32
     critic) x (obs 21, act 4), (obs 72, act 10), and (1024,) at obs 21,
     act 40 (a head too wide to relay) x 1000, 4093 and 8192 rows, each
     bit for bit the per-layer route forced, each launch counted; K3g's log-probs K2g's per-layer forward (approx_kl exactly
     0) at (1024,) and 2 x 1024. Its results print before the
     ``kernels`` line, which lists the cluster route's entries.
 59. ``mode10_expert``: 2048 mod-hovering envs at the fork's settings
     (NED, 80 Hz, wind and gusts, random starts) flown by
     ``hovering_pid_expert`` for one full 10 s episode in mode 10 (ga_pid)
     and in mode 7: return, collision share, distance to target,
     env-steps/s;
 60. ``quadx_modes``: ``models/quadx.step`` (plain PyTorch, no kernel) in
     every flight mode -1..10, ENU and NED, 8192 drones from airborne
     spawns with per-mode setpoints for 120 control steps (ENU mode 10,
     whose gains are NED's, for 40), the first 256 lanes held lane by lane
     against the same code on the CPU (every lane within the closed-loop
     curves for 15 steps, at most an eighth beyond them over the run, where
     the cascades' saturations part the two roundings); the height modes
     hold z, mode 6 tracks its ground
     velocity and NED mode 10 closes on its [x, y, psi, z]; ms per step;
 61. ``aviary``: ``core/aviary`` on the card with the fleets of
     examples/core 02, 05 (the orbit controller over modes 7 and 10), 08
     and 09 (two wind fields), 1 s each; then 4096 batched copies of the
     02 fleet (noise off, per-copy setpoints, a third disarmed halfway,
     obstacle response against three boxes) for 240 steps, the first 64
     copies held drone by drone against the CPU; aviary- and
     drone-steps/s.
     Phases 60 and 61 time the card's run first, then fly its CPU twin on
     the same states; the lanes of phase 60 that part from the CPU are
     flown again in float64 as a witness that rounding parts them.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Without CUDA the script exits non-zero before printing any result. It
imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_BF16_FLOPS = 989e12  # dense bf16 tensor cores
SPIN_CYCLES = 100_000_000  # ~50 ms at the H100's ~1.98 GHz boost clock

N_ENVS = 8192
N_RAGGED = 1000
BATCH = N_ENVS * 32  # PPOConfig.rollout_steps: the PPO batch
PARITY_STEPS = 20
ROLLOUT_STEPS = 256
OBS_ATOL = 2e-4  # as tests/test_packed_hover.py: FMA contraction + native atan2/asin
HOVER_MIDWARP = 4093  # a width whose last warp is part full (one thread an env)
# bf16 forward: kernel and twin round the same bf16 inputs and sum in
# f32 in another order; a sum that lands on a bf16 rounding boundary can
# move one trunk activation by one bf16 ulp (<= 2^-8), which reaches the
# mean through the 0.01-gain head and the value through the 1.0-gain head
POLICY_MEAN_ATOL = 1e-4
POLICY_VALUE_ATOL = 1e-3
# K3: the same bf16 rounding boundaries as K4 move the mean by <= 1e-4
# (POLICY_MEAN_ATOL), which moves a log-prob by |a - mean| / var times
# that: <= 5e-4 for the |a - mean| / var <= 5 of these rows
LOGP_ATOL = 5e-4
# K2, per minibatch: a boundary flip moves one bf16 activation or dz by one
# ulp (2^-8 relative) in one row of 8192, so each gradient entry moves by
# far less than 1e-3 of the leaf's largest; mu_new - b1^n mu carries the
# gradients themselves and is held at that, nu (squares) at 2e-3 of its
# largest; a 2e-3 relative change of each lr-scaled Adam step moves the
# params by <= n_mb x lr x 2e-3 (< 5e-6); the metrics are f32 sums of the
# same per-row values in another order (1e-4 relative)
EPOCH_MU_REL = 1e-3
EPOCH_NU_REL = 2e-3
EPOCH_PARAM_ATOL = 5e-6
EPOCH_METRIC_RTOL = 1e-4
TRAIN_ITERS = 3  # the first a warm-up
# K1 generic vs its twin over 10 chained aviary steps: FMA contraction and
# native atan2/asin move the state by ~3e-5 at most (a first probe on the
# card saw 2.8e-5); 1e-4 leaves room without hiding a wrong term (a wrong
# sign or wind term moves it by > 1e-2)
GENERIC_STEPS = 10
GENERIC_ATOL = 1e-4
MOD_ROLLOUT_STEPS = 128  # ppo_solve_r5's rollout length
MOD_TRAIN_ITERS = 3  # default-path iterations, the first a warm-up


def mod_ppo_config():
    """ppo_solve_r5's small recipe (docs/artifacts/ppo_solve_r5.py:55-57)."""
    from pyflyt_tpu_torch.rl import PPOConfig

    return PPOConfig(num_envs=8192, rollout_steps=128, num_epochs=3, num_minibatches=128,
                     learning_rate=2e-4, clip_eps=0.1, init_log_std=-1.6)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, repeats: int = 5, device_timed: bool = True) -> tuple[float, float]:
    """(device ms per call, host ms per call), medians over ``repeats``.

    Each repeat first queues a ~50 ms spin on the stream, so the host has
    enqueued the calls before the device reaches the start event: the
    events then see the calls back to back on the device, not the host's
    enqueue rate. With ``device_timed`` the script fails unless the device
    is still spinning when the host has enqueued every call (the launches
    must also stay under the ~1000 a stream queues before a launch blocks).
    The host clock around the enqueue gives the wrapper's own cost per
    call. A call that enqueues slower than the device runs it (the plain
    twins, ``device_timed=False``) is timed at its host rate. The garbage
    collector waits while the calls are enqueued: late in a long run one of
    its passes can outlast the spin.
    """
    import torch

    fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        gc.disable()
        try:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            enqueue_ms = 1e3 * (time.perf_counter() - t0)
        finally:
            gc.enable()
        host.append(enqueue_ms / iters)
        check(not device_timed or not start.query(),
              f"time_ms: the device caught up with the host's enqueue of {iters} calls ({enqueue_ms:.1f} ms)")
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end) / iters)
    return statistics.median(dev), statistics.median(host)


# ---------------------------------------------------------------------------
# phase 3: hover step
# ---------------------------------------------------------------------------


def hover_actions(n: int, step: int, device):
    import torch

    g = torch.Generator().manual_seed(1000 + step)
    a = torch.rand((n, 4), generator=g) * 1.2 - 0.6
    a[:, 3] = a[:, 3].abs() + 0.2
    a[: n // 2] = 0.0  # half the fleet falls straight onto the ground plane
    return a.to(device)


def check_hover_step(n: int, staggered: bool = False) -> float:
    """Kernel vs twin over PARITY_STEPS agent steps; returns the max error.
    ``staggered``: the envs of the upper half 0-4 agent steps short of the
    time limit by their column mod 5, so envs of one warp freeze at
    different agent steps (checked)."""
    import torch
    from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv
    from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
    from pyflyt_tpu_torch.ops import cuda_quadx as cq

    env = PackedQuadXHoverEnv(base=QuadXHoverEnv(noisy_motors=False, device="cuda"))
    state, _ = env.reset(n)
    seed = torch.zeros(1, dtype=torch.int64, device="cuda")
    if staggered:
        cols = torch.arange(n // 2, n, device="cuda")
        state.packed[cq._STEP, cols] = float(env.base.max_steps) - (cols % 5).float()
    kern, plain = state.packed.clone(), state.packed.clone()
    err = 0.0
    done_any = False
    first_frozen = torch.full((n,), -1, dtype=torch.long, device="cuda")
    for i in range(PARITY_STEPS):
        a = hover_actions(n, i, "cuda").T
        kern[cq._SP : cq._SP + 4] = a
        plain[cq._SP : cq._SP + 4] = a
        kern = cq.packed_hover_step(kern, seed, env.consts, mode=0, noisy=False)
        plain = cq.packed_hover_step_plain(plain, seed, env.consts, mode=0, noisy=False)
        torch.cuda.synchronize()
        e_obs = (env._obs(kern) - env._obs(plain)).abs().max().item()
        e_rwd = (kern[cq._RWD] - plain[cq._RWD]).abs().max().item()
        check(e_obs <= OBS_ATOL, f"hover N={n} step {i}: obs error {e_obs}")
        check(e_rwd <= OBS_ATOL, f"hover N={n} step {i}: reward error {e_rwd}")
        for row, name in ((cq._TERM, "termination"), (cq._TRUNC, "truncation"),
                          (cq._COLL, "collision"), (cq._OOB, "out_of_bounds")):
            check(torch.equal(kern[row], plain[row]), f"hover N={n} step {i}: {name} differs")
        check(bool(torch.isfinite(kern).all()), f"hover N={n} step {i}: non-finite state")
        done_any |= bool((kern[cq._TERM] > 0.5).any())
        first_frozen[((kern[cq._TERM] > 0.5) | (kern[cq._TRUNC] > 0.5)) & (first_frozen < 0)] = i
        err = max(err, e_obs, e_rwd)
    check(done_any, f"hover N={n}: no lane terminated, the freeze path was not exercised")
    if staggered:  # warps whose envs froze at different steps
        per_warp = 32 // _source_group("quadx_hover_step.cu")
        ff = first_frozen[: n - n % per_warp].view(-1, per_warp)
        check(bool(((ff.amax(1) != ff.amin(1)) & (ff.amin(1) >= 0)).any()),
              f"hover N={n}: no warp froze at two agent steps")
    return err


def _source_const(source: str, name: str) -> int:
    """``constexpr int <name> = <value>;`` of a kernel source."""
    import re

    from pyflyt_tpu_torch.ops import cuda_build

    return int(re.search(rf"constexpr int {name} = (\d+);", (cuda_build.CSRC / source).read_text()).group(1))


def _source_group(source: str) -> int:
    """The lanes an env of a kernel source: its GROUP, or 1 (one thread an
    env) where it defines none."""
    from pyflyt_tpu_torch.ops import cuda_build

    return _source_const(source, "GROUP") if "constexpr int GROUP = " in (cuda_build.CSRC / source).read_text() else 1


def check_hover_noise(mode: int = 0) -> dict:
    """Noise on, identical start states: the spread of the throttle across
    lanes after one agent step, kernel (Philox) vs twin (torch.Generator);
    mode 7 holds a position 1 m up."""
    import torch
    from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv
    from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
    from pyflyt_tpu_torch.ops import cuda_quadx as cq

    env = PackedQuadXHoverEnv(base=QuadXHoverEnv(flight_mode=mode, noisy_motors=False, device="cuda"))
    state, _ = env.reset(N_ENVS)
    packed = state.packed.clone()
    sp = [0.0, 0.0, 0.0, 1.0] if mode == 7 else [0.0, 0.0, 0.0, 0.35]
    packed[cq._SP : cq._SP + 4] = torch.tensor(sp, device="cuda")[:, None]
    seed = torch.tensor([12345], dtype=torch.int64, device="cuda")
    kern = cq.packed_hover_step(packed, seed, env.consts, mode=mode, noisy=True)
    check(torch.equal(kern, cq.packed_hover_step(packed, seed, env.consts, mode=mode, noisy=True)),
          f"noisy hover step mode {mode}: two calls differ")
    plain = cq.packed_hover_step_plain(packed, seed, env.consts, mode=mode, noisy=True)
    tk, tp = kern[cq._THR : cq._THR + 4], plain[cq._THR : cq._THR + 4]
    mk, mp = tk.mean(1), tp.mean(1)
    sk, sp_ = tk.std(1), tp.std(1)
    # std of a sample std is ~s/sqrt(2N) (0.8% at N=8192): 5% is > 6 sigma;
    # the means agree to 6 standard errors of their difference
    se = torch.sqrt((sk**2 + sp_**2) / N_ENVS)
    check(bool((sk > 0).all()), "noisy kernel: no spread across lanes")
    check(bool(((mk - mp).abs() <= 6 * se).all()), f"noisy throttle means {mk.tolist()} vs {mp.tolist()}")
    check(bool(((sk / sp_ - 1).abs() <= 0.05).all()), f"noisy throttle std {sk.tolist()} vs {sp_.tolist()}")
    # independent draws per motor and per lane: sample correlations of
    # independent series have a standard error of 1/sqrt(N) (0.011), so
    # |r| <= 0.1 is > 9 sigma and a shared draw (r ~ 1) fails
    corr_motor = torch.corrcoef(tk)
    off = corr_motor[~torch.eye(4, dtype=torch.bool, device=tk.device)]
    corr_lane = torch.corrcoef(torch.stack([tk[0, 0::2], tk[0, 1::2]]))[0, 1]
    check(bool((off.abs() <= 0.1).all()), f"noisy kernel: motors correlated {corr_motor.tolist()}")
    check(abs(float(corr_lane)) <= 0.1, f"noisy kernel: neighbouring lanes correlated ({float(corr_lane)})")
    return {"throttle_std_kernel": sk.tolist(), "throttle_std_plain": sp_.tolist(),
            "throttle_mean_kernel": mk.tolist(), "throttle_mean_plain": mp.tolist(),
            "max_motor_corr_kernel": float(off.abs().max()), "lane_corr_kernel": float(corr_lane)}


# ---------------------------------------------------------------------------
# phase 4: policy forward
# ---------------------------------------------------------------------------


def check_policy(net, n: int, atol: tuple[float, float] = (POLICY_MEAN_ATOL, POLICY_VALUE_ATOL)) -> tuple[float, float]:
    """K4 against its twin on ``n`` rows of seeded normal observations;
    ``atol`` is (mean, value)."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_policy

    g = torch.Generator().manual_seed(7 + n)
    obs = torch.randn((n, net.obs_dim), generator=g).cuda()
    w = net.kernel_weights()
    mk, vk = cuda_policy.policy_value_forward(obs, w)
    mp, vp = cuda_policy.policy_value_forward_plain(obs, w)
    torch.cuda.synchronize()
    e_m = (mk - mp).abs().max().item()
    e_v = (vk - vp).abs().max().item()
    check(mk.shape == (n, net.action_dim) and vk.shape == (n,), "policy: output shapes")
    check(e_m <= atol[0], f"policy n={n}: mean error {e_m}")
    check(e_v <= atol[1], f"policy n={n}: value error {e_v}")
    return e_m, e_v


def policy_atol(net) -> tuple[float, float]:
    """(mean, value) tolerance of K4 against its twin from ``net``'s own
    weights: POLICY_MEAN_ATOL's bf16 boundary argument with the actual
    heads (trained, or a 1.0-gain value head over a wider trunk input,
    where the fixed 1e-3 is no bound). One trunk activation moved by
    one bf16 ulp (<= 2^-8) moves an output by at most 2^-8 x the largest
    head weight (a last-layer activation) or 2^-8 x max_j sum_k
    |head[o, k] W[k, j]| (one layer before, through tanh' <= 1); allow one
    of each, and never less than the random-weight tolerances. The
    earlier layer's term is needed: on an H100 the r5 policy's value is
    0.133 off its twin, above the 0.052 that a last-layer flip alone
    allows (PERF.md)."""
    def bound(trunk, head):
        h = head.weight.detach().abs()
        deeper = (h @ trunk.layers[-1].weight.detach().abs()).max().item() if len(trunk.layers) > 1 else 0.0
        return 2.0**-8 * (h.max().item() + deeper)

    return (max(POLICY_MEAN_ATOL, bound(net.pi_trunk, net.pi_head)),
            max(POLICY_VALUE_ATOL, bound(net.vf_trunk, net.vf_head)))


GRID_OBS = (16, 21, 30, 33, 35, 64)  # mod-hovering, hover, dogfight, waypoints/rocket, fixedwing, the widest
GRID_ACT = (1, 4, 7, 8)
GRID_ROWS = (1, 63, 65, N_RAGGED, 4096, N_ENVS)
K3_WIDE_ROWS = 1_048_576  # the mod-hovering and dogfight recipes' PPO batch


def check_policy_grid(seed: int) -> dict:
    """K4 against its twin over every obs width x action width x row count
    of the grid (random weights from ``seed``), at ``policy_atol``."""
    import torch
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    worst = {"mean": 0.0, "value": 0.0}
    for o in GRID_OBS:
        for a in GRID_ACT:
            net = ActorCritic(o, a, device="cuda", generator=torch.Generator().manual_seed(seed + 100 * o + a))
            atol = policy_atol(net)
            for n in GRID_ROWS:
                e_m, e_v = check_policy(net, n, atol)
                worst["mean"], worst["value"] = max(worst["mean"], e_m), max(worst["value"], e_v)
    return {"cases": len(GRID_OBS) * len(GRID_ACT) * len(GRID_ROWS), "obs": GRID_OBS, "act": GRID_ACT,
            "rows": GRID_ROWS, "max_mean_err": worst["mean"], "max_value_err": worst["value"]}


def check_logp_shapes(seed: int) -> dict:
    """K3 against its twin at the dogfight's row width (obs 30, act 4: 37
    floats, not 16-byte aligned), at act 7 with the L0 landing policy's
    log_std range, and over the 1,048,576-row batch."""
    import torch
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    gen = lambda k: torch.Generator().manual_seed(seed + k)  # noqa: E731
    df = ActorCritic(30, 4, device="cuda", generator=gen(30))
    rk = ActorCritic(33, 7, device="cuda", generator=gen(33), log_std_range=(-3.5, -1.0))
    hover = ActorCritic(21, 4, device="cuda", generator=gen(21))
    return {
        "obs30_act4_feat37": check_logp(df, BATCH),
        "obs33_act7_l0_range": check_logp(rk, BATCH, ranges=(rk.log_std_range,)),
        "rows_1048576": check_logp(hover, K3_WIDE_ROWS),
    }


def policy_mlp_record() -> dict:
    """K4's and K3's build as ptxas reports it, entry by entry, and the
    launch's shape (csrc/policy_value_forward.cu::policy_mlp_launch_info)."""
    import ctypes
    import re

    from pyflyt_tpu_torch.ops import cuda_build

    lib = cuda_build.library_path("policy_value_forward.cu")
    text = lib.with_suffix(".log").read_text()
    entries = {}
    for m in re.finditer(r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads\n.*?Used (\d+) registers", text):
        name = "logp_forward" if "logp_kernel" in m.group(1) else "policy_value_forward"
        entries[name] = {"registers_at_launch": int(m.group(5)), "stack_frame_bytes": int(m.group(2)),
                         "spill_store_bytes": int(m.group(3)), "spill_load_bytes": int(m.group(4))}
    info = (ctypes.c_int * 4)()
    fn = ctypes.CDLL(str(lib)).policy_mlp_launch_info
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], None
    fn(info)
    check(set(entries) == {"policy_value_forward", "logp_forward"}, f"ptxas report: entries {sorted(entries)}")
    return {"entries": entries, "threads": info[0], "dynamic_smem_bytes": info[1],
            "consumer_registers": info[2], "producer_registers": info[3],
            "wgmma_serialized": "C7511" in text}


# ---------------------------------------------------------------------------
# phases 7-8: the SGD kernels against their twins
# ---------------------------------------------------------------------------


def packed_rows(net, n: int, seed: int):
    """Seeded PPO rows ``[obs | action | old_logp | adv | ret]`` on the
    card: stored log-probs are the policy's own (the twin's) plus noise, so
    ratios fall inside and outside the clip band."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_sgd

    g = torch.Generator(device="cuda").manual_seed(seed)
    o, a = net.obs_dim, net.action_dim
    rows = torch.randn((n, o + a + 3), generator=g, device="cuda")
    lp = cuda_sgd.logp_forward_plain(rows, pi_leaves(net), o)
    rows[:, o + a] = lp + 0.3 * torch.randn((n,), generator=g, device="cuda")
    rows[:, o + a + 2] *= 3.0
    return rows


def adv_stats(adv):
    """Per-minibatch advantage mean and population std, as PPO.sgd."""
    import torch

    return torch.stack([adv.mean(1), adv.std(1, correction=0)], 1)


def pi_leaves(net):
    from pyflyt_tpu_torch.ops import cuda_sgd

    return [t.detach() for t in cuda_sgd.params_to_leaves(net)[: 2 * len(net.pi_trunk.layers) + 3]]


def check_logp(net, n: int, ranges=(None, (-1.0, -0.2)), atol=None) -> float:
    """K3 (or K3n, K3g: the family of the network's two trunks) vs its twin
    over n packed rows, without and with a log_std range that clips
    (``ranges``), at LOGP_ATOL or ``atol(net, rows, range)``; returns the
    max error."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_sgd

    rows = packed_rows(net, n, seed=11 + n)
    err = 0.0
    for rng in ranges:
        k = cuda_sgd.logp_forward(rows, pi_leaves(net), net.obs_dim, rng, vf_sizes=trunk_sizes(net.vf_trunk))
        p = cuda_sgd.logp_forward_plain(rows, pi_leaves(net), net.obs_dim, rng)
        torch.cuda.synchronize()
        check(k.shape == (n,) and bool(torch.isfinite(k).all()), f"logp n={n}: shape or non-finite")
        e = (k - p).abs().max().item()
        tol = LOGP_ATOL if atol is None else atol(net, rows, rng)
        check(e <= tol, f"logp n={n} obs {net.obs_dim} act {net.action_dim} range={rng}: error {e} > {tol}")
        err = max(err, e)
    return err


EPOCH_RANGE = (-1.0, 0.5)  # a log_std range that clips
EPOCH_DF_ROWS = 65536  # the dogfight recipe's minibatch (8192 rows x 128 steps / 16), as df_train gives K2
EPOCH_MULTI_ROWS = 20000  # 313 row tiles, the last ragged: 2-3 tiles for each of the 132 consumers
# K2's shapes beyond the hover path's: the envs' obs widths (waypoints and
# rocket 33, fixedwing 35, the widest 64, hover 21), both action extremes,
# with and without a log_std range, full and ragged minibatches; and
# minibatches of more tiles than K2's fwd_bwd has consumers (each then
# runs several tiles): the dogfight recipe's, and a ragged one
EPOCH_SHAPES = ((33, 1, None, N_ENVS), (33, 8, EPOCH_RANGE, N_RAGGED), (35, 1, EPOCH_RANGE, N_ENVS),
                (35, 8, None, N_RAGGED), (64, 1, None, N_RAGGED), (64, 8, EPOCH_RANGE, N_ENVS),
                (21, 1, EPOCH_RANGE, N_RAGGED), (21, 8, None, N_ENVS),
                (30, 4, None, EPOCH_DF_ROWS), (64, 8, EPOCH_RANGE, EPOCH_MULTI_ROWS))
# K2's time per minibatch at the hover, waypoints and dogfight widths: (obs, act, minibatches, rows)
EPOCH_TIMED = ((21, 4, 8, N_ENVS), (33, 4, 8, N_ENVS), (30, 4, 2, EPOCH_DF_ROWS))


def trunk_sizes(trunk) -> tuple:
    """A trunk's layer widths."""
    return tuple(lin.out_features for lin in trunk.layers)


def epoch_inputs(net, n_mb: int, mb: int, log_std_range=EPOCH_RANGE, opt=None):
    """One epoch's K2 inputs from the network's weights: n_mb minibatches of
    mb packed rows, their advantage stats, Adam's count 7 and seeded
    non-zero moments (or the count and moments of the optimizer state
    ``opt``), an entropy term."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_sgd

    g = torch.Generator(device="cuda").manual_seed(100 + mb)
    leaves = [t.detach().contiguous() for t in cuda_sgd.params_to_leaves(net)]
    mu = [torch.randn(t.shape, generator=g, device="cuda") * 1e-3 for t in leaves]
    nu = [torch.rand(t.shape, generator=g, device="cuda") * 1e-5 for t in leaves]
    mbs = packed_rows(net, n_mb * mb, seed=200 + mb).reshape(n_mb, mb, -1)
    c0 = net.obs_dim + net.action_dim
    stats = adv_stats(mbs[:, :, c0 + 1])
    t0 = torch.tensor([7], dtype=torch.int32, device="cuda")
    if opt is not None:
        t0, mu, nu = opt.count.reshape(1), [m.detach() for m in opt.mu], [v.detach() for v in opt.nu]
    cfg = cuda_sgd.EpochConfig(
        net.obs_dim, net.action_dim, trunk_sizes(net.pi_trunk), trunk_sizes(net.vf_trunk), learning_rate=3e-4,
        clip_eps=0.2,
        entropy_coef=0.01, value_coef=0.5, max_grad_norm=0.5, log_std_range=log_std_range,
    )
    return mbs, stats, t0, leaves, mu, nu, cfg


def epoch_errors(inputs, got, want) -> dict:
    """One epoch's outputs ``got`` against ``want`` (each ``(leaves, mu,
    nu, metrics)``) on ``inputs`` (``epoch_inputs``): the first moment's
    error of each leaf's largest (the part the epoch added), the second
    moment's, the parameters' and the metrics'."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_sgd

    mbs, _, _, leaves, mu, _, _ = inputs
    (kl, km, kn, kmet), (pl, pm, pn, pmet) = got, want
    decay = cuda_sgd.B1 ** mbs.shape[0]
    mu_leaf = [((a - decay * m) - (b - decay * m)).abs().max().item() / (b - decay * m).abs().max().item()
               for a, b, m in zip(km, pm, mu)]
    mu_rel = max(mu_leaf)
    return {"finite": all(bool(torch.isfinite(t).all()) for t in (*kl, *km, *kn, kmet)), "mu_rel": mu_rel,
            "mu_leaf": mu_leaf, "worst": mu_leaf.index(mu_rel),
            "nu_rel": max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(kn, pn)),
            "p_err": max((a - b).abs().max().item() for a, b in zip(kl, pl)),
            "moved": max((b - t).abs().max().item() for b, t in zip(pl, leaves)),
            "met_rel": ((kmet - pmet).abs() / (pmet.abs() + 1e-3)).max().item()}


def check_epoch(net, n_mb: int, mb: int, log_std_range=EPOCH_RANGE, mu_rel_tol: float = EPOCH_MU_REL,
                opt=None) -> dict:
    """K2 vs its twin for one epoch of n_mb minibatches of mb rows
    (``epoch_inputs``, with ``opt``'s moments if given); the first moment
    at ``mu_rel_tol`` of each leaf's largest."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_sgd

    inputs = epoch_inputs(net, n_mb, mb, log_std_range, opt)
    got = cuda_sgd.fused_epoch(*inputs)
    want = cuda_sgd.fused_epoch_plain(*inputs)
    torch.cuda.synchronize()
    e = epoch_errors(inputs, got, want)
    mu_rel, mu_leaf, worst, pm = e["mu_rel"], e["mu_leaf"], e["worst"], want[1]
    nu_rel, p_err, moved, met_rel = e["nu_rel"], e["p_err"], e["moved"], e["met_rel"]
    where = f"epoch {n_mb}x{mb} obs {net.obs_dim} act {net.action_dim} range {log_std_range}"
    check(e["finite"], f"{where}: non-finite output")
    check(mu_rel <= mu_rel_tol, f"{where}: gradient (mu) error {mu_rel} of its largest, in leaf {worst} "
                                f"{tuple(pm[worst].shape)} (per leaf {[round(v, 6) for v in mu_leaf]})")
    check(nu_rel <= EPOCH_NU_REL, f"{where}: nu error {nu_rel} of its largest")
    check(p_err <= EPOCH_PARAM_ATOL, f"{where}: param error {p_err}")
    check(met_rel <= EPOCH_METRIC_RTOL, f"{where}: metrics error {met_rel}")
    check(moved > 1e-4, f"{where}: the params did not move")
    return {"n_mb": n_mb, "mb": mb, "obs_dim": net.obs_dim, "act_dim": net.action_dim,
            "log_std_range": log_std_range, "mu_rel_err": mu_rel, "nu_rel_err": nu_rel, "max_abs_err": p_err,
            "metric_rel_err": met_rel, "max_param_step": moved, "mu_rel_worst_leaf": worst}


def epoch_net(seed: int, obs: int, act: int):
    """A random actor-critic of the given widths for K2's checks."""
    import torch
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    return ActorCritic(obs, act, device="cuda", generator=torch.Generator().manual_seed(seed + 100 * obs + act))


def check_epoch_shapes(seed: int) -> list:
    """K2 vs its twin at ``EPOCH_SHAPES``, two minibatches each."""
    return [check_epoch(epoch_net(seed, obs, act), 2, mb, rng) for obs, act, rng, mb in EPOCH_SHAPES]


def time_epoch_shapes(seed: int) -> list:
    """K2's device time at ``EPOCH_TIMED`` (``epoch_inputs``), per call
    and per minibatch."""
    from pyflyt_tpu_torch.ops import cuda_sgd

    out = []
    for obs, act, n_mb, mb in EPOCH_TIMED:
        inputs = epoch_inputs(epoch_net(seed, obs, act), n_mb, mb, None)
        ms, _ = time_ms(lambda: cuda_sgd.fused_epoch(*inputs), iters=4, repeats=3)  # noqa: B023
        out.append({"obs_dim": obs, "act_dim": act, "n_mb": n_mb, "mb": mb, "ms": ms, "ms_per_minibatch": ms / n_mb})
    return out


def check_epoch_repeat(net, n_mb: int, mb: int) -> dict:
    """Two K2 calls on the same inputs give bit-identical parameters,
    moments and metrics (fixed summation orders, no atomics), and the
    weight images the last Adam step wrote are ``pack_trunk`` of the
    returned leaves, byte for byte."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_policy, cuda_sgd

    inputs = epoch_inputs(net, n_mb, mb)
    (a, images), (b, _) = cuda_sgd.launch_epoch(*inputs), cuda_sgd.launch_epoch(*inputs)
    leaves = a[0]
    want = torch.stack([cuda_policy.pack_trunk(*leaves[:6]), cuda_policy.pack_trunk(*leaves[7:])])
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip([*a[0], *a[1], *a[2], a[3]], [*b[0], *b[1], *b[2], b[3]]))
    check(same, f"epoch {n_mb}x{mb}: two calls on the same inputs differ")
    mismatched = int((images != want).sum())
    check(mismatched == 0, f"epoch {n_mb}x{mb}: {mismatched} bytes of the device-written images differ from pack_trunk")
    return {"n_mb": n_mb, "mb": mb, "bit_identical": same, "image_bytes": int(images.numel()),
            "image_bytes_differing": mismatched}


# ---------------------------------------------------------------------------
# phase 9: the training path
# ---------------------------------------------------------------------------


def train_path(seed: int, card: str):
    """3 PPO iterations with fused_sgd on 8192 packed hover envs. Every
    iteration zeroes the launch counts just before it and reads them just
    after; the last runs the phases one by one, each ended by a
    synchronize, for the split."""
    import torch
    from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv
    from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
    from pyflyt_tpu_torch.rl import PPO, PPOConfig, ppo

    cfg = PPOConfig(num_envs=N_ENVS, cached_reset_refresh=64, fused_sgd=True, fused_rollout_forward=True)
    tp = PPO(PackedQuadXHoverEnv(base=QuadXHoverEnv(device="cuda")), cfg)
    check(ppo.shuffle_block_size(cfg) == 32, "shuffle block")
    t0 = time.perf_counter()
    runner = tp.init(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    before = [p.detach().clone() for p in runner.network.parameters()]
    kernels = all_kernels()
    want = {**dict.fromkeys(kernels, 0), "quadx_hover_step": cfg.rollout_steps,
            "policy_value_forward": cfg.rollout_steps, "logp_forward": 1, "fused_epoch": cfg.num_epochs}
    per_update = cfg.num_epochs * cfg.num_minibatches
    walls, split = [], None
    for it in range(TRAIN_ITERS):
        count0 = int(runner.opt_state.count)
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if it < TRAIN_ITERS - 1:
            runner, metrics = tp.train_iteration(runner)
            torch.cuda.synchronize()
        else:
            marks = [time.perf_counter()]
            runner, traj = tp._rollout(runner)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            adv, ret = tp._gae(runner.network, traj, runner.obs)
            packed = tp.pack(traj, adv, ret)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            obs_dim = traj.obs.shape[-1]
            tp.rewrite_old_logp(runner.network, packed, obs_dim)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            stacked = tp.sgd(runner, packed, obs_dim)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            runner.update_idx += 1
            metrics = {k: v.mean() for k, v in stacked.items()}
            metrics["mean_reward"] = traj.reward.mean()
            metrics["mean_episode_done"] = traj.done.float().mean()
            split = dict(zip(("rollout_s", "gae_pack_s", "logp_k3_s", "sgd_k2_s"),
                             [b - a for a, b in zip(marks, marks[1:])]))
        walls.append(time.perf_counter() - t0)
        launches = {n: k.launches for n, k in kernels.items()}
        check(launches == want, f"iteration {it}: launches {launches}, expected {want}")
        check(int(runner.opt_state.count) - count0 == per_update, f"iteration {it}: Adam count")
        check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"iteration {it}: non-finite metrics")
    moved = max((a - b.detach()).abs().max().item() for a, b in zip(before, runner.network.parameters()))
    check(moved > 1e-4, "training did not move the params")
    check(all(bool(torch.isfinite(p).all()) for p in runner.network.parameters()), "non-finite params")
    wall = statistics.mean(walls[1:])
    out = {
        "card": card, "num_envs": N_ENVS, "batch": cfg.batch_size, "epochs": cfg.num_epochs,
        "minibatches": cfg.num_minibatches, "minibatch_size": cfg.minibatch_size,
        "shuffle_block": ppo.shuffle_block_size(cfg), "init_s": init_s, "warmup_s": walls[0],
        "wall_s_per_iteration": wall, "walls_s": walls, "samples_per_s": cfg.batch_size / wall,
        "split_s": split, "adam_count": int(runner.opt_state.count),
        "launches_per_iteration": launches, "max_param_change": moved,  # the last iteration's, checked
        "metrics": {k: float(v) for k, v in metrics.items()},
    }
    return out, tp, runner


def train_loop_smoke(seed: int) -> dict:
    """``train`` on the card for one iteration at 512 envs (eval, logs and a
    best-model checkpoint in a scratch directory under build/), then a
    checkpoint round trip: the iteration after a restore must give the
    uninterrupted run's parameters and metrics. K2 sums in a fixed order,
    so the two agree to the last bit unless a library op does not."""
    import shutil
    import tempfile

    import torch
    from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv
    from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
    from pyflyt_tpu_torch.rl import PPO, PPOConfig, TrainConfig, checkpoint, train

    cfg = PPOConfig(num_envs=512, cached_reset_refresh=64, fused_sgd=True, fused_rollout_forward=True,
                    num_epochs=2, num_minibatches=4)
    tp = PPO(PackedQuadXHoverEnv(base=QuadXHoverEnv(device="cuda")), cfg)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=os.path.join(HERE, "build"))
    try:
        t0 = time.perf_counter()
        runner = train(tp, TrainConfig(total_timesteps=cfg.batch_size, eval_every_updates=1,
                                       eval_episodes=4, log_dir=work, seed=seed))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        names = os.listdir(work)
        check(runner.update_idx == 1, "train: one iteration")
        check({"metrics.jsonl", "evaluations.npz"} <= set(names), f"train wrote {names}")
        best = [n for n in names if n.startswith("best_model_")]
        check(len(best) == 1, f"train: best-model checkpoints {best}")
        with open(os.path.join(work, "metrics.jsonl")) as f:
            row = json.loads(f.readline())
        check(all(isinstance(v, (int, float)) and v == v for v in row.values()), "train: metrics row")
        path = os.path.join(work, "resume")
        checkpoint.save(path, runner)
        runner, m_a = tp.train_iteration(runner)
        restored = checkpoint.restore(path, tp.init(seed + 7))
        restored, m_b = tp.train_iteration(restored)
        torch.cuda.synchronize()
        p_err = max((a - b).abs().max().item()
                    for a, b in zip(runner.network.parameters(), restored.network.parameters()))
        m_err = max(abs(float(m_a[k]) - float(m_b[k])) for k in m_a)
        check(p_err == 0.0 and m_err == 0.0, f"resumed iteration differs: params {p_err}, metrics {m_err}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"num_envs": cfg.num_envs, "train_s": train_s, "eval_mean_reward": row["eval_mean_reward"],
            "eval_mean_length": row["eval_mean_length"], "resume_param_err": p_err, "resume_metric_err": m_err}


# ---------------------------------------------------------------------------
# phase 10: times and bounds of the SGD kernels
# ---------------------------------------------------------------------------


def time_sgd_kernels(tp, runner, label: str = "sgd_times") -> dict:
    """K3 and K2 at the shapes of ``tp``'s training path (its batch, its
    minibatches, the runner's network and Adam state): device time, host
    time, the plain twin, the library yardstick and the bound."""
    from pyflyt_tpu_torch.ops import cuda_sgd

    net = runner.network
    batch = tp.config.batch_size
    o, a = net.obs_dim, net.action_dim
    bound = lambda b, f: (1e3 * max(b / H100_BYTES_PER_S, f / H100_BF16_FLOPS),  # noqa: E731
                          "bytes" if b / H100_BYTES_PER_S >= f / H100_BF16_FLOPS else "operations")
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    out = {}

    rows = packed_rows(net, batch, seed=300)
    pl_ = pi_leaves(net)
    ms, host = time_ms(lambda: cuda_sgd.logp_forward(rows, pl_, o, vf_sizes=trunk_sizes(net.vf_trunk)),
                       iters=max(1, 20 * BATCH // batch))
    plain, _ = time_ms(lambda: cuda_sgd.logp_forward_plain(rows, pl_, o), iters=3, repeats=3, device_timed=False)
    lib, _ = time_ms(library_logp(net, rows), iters=max(1, 20 * BATCH // batch))
    b_ms, by = bound(nbytes([rows, *pl_]) + batch * 4, cuda_sgd.logp_flops(batch, o, a))
    out["logp_forward"] = {"ms": ms, "host_ms": host, "plain_ms": plain, "library_ms": lib,
                           "bound_ms": b_ms, "bound_by": by, "rows": batch, **logp_kernel_only(rows, pl_, o)}

    cfg = tp.config
    mbs = packed_rows(net, batch, seed=301).reshape(cfg.num_minibatches, cfg.minibatch_size, -1)
    c0 = o + a
    stats = adv_stats(mbs[:, :, c0 + 1])
    leaves = [t.detach() for t in cuda_sgd.params_to_leaves(net)]
    opt = runner.opt_state
    t0 = opt.count.reshape(1)
    ecfg = tp.epoch_config(o)
    run = lambda: cuda_sgd.fused_epoch(mbs, stats, t0, leaves, opt.mu, opt.nu, ecfg)  # noqa: E731
    ms, host = time_ms(run, iters=max(1, 96 // cfg.num_minibatches), repeats=3)
    plain, _ = time_ms(lambda: cuda_sgd.fused_epoch_plain(mbs, stats, t0, leaves, opt.mu, opt.nu, ecfg),
                       iters=1, repeats=2, device_timed=False)
    # the autograd + Adam step makes the host wait on the card within a call
    # (time_ms's guard trips even behind a ~0.5 s spin), so its yardstick is
    # the summed device time of its kernels (torch.profiler), and its host
    # wall per update is kept beside it
    lib_fn = library_update(net, mbs[0], stats[0], cfg)
    lib_mb = profiled_device_ms(lib_fn, iters=8)
    lib_wall = host_wall_ms(lib_fn, iters=8)
    state = nbytes(leaves) + nbytes(opt.mu) + nbytes(opt.nu)
    b_ms, by = bound(nbytes([mbs, stats, t0]) + 2 * state + cfg.num_minibatches * 5 * 4,
                     cuda_sgd.epoch_flops(batch, o, a))
    out["fused_epoch"] = {
        "ms": ms, "host_ms": host, "ms_per_minibatch": ms / cfg.num_minibatches, "plain_ms": plain,
        "library_ms": lib_mb * cfg.num_minibatches, "library_ms_per_minibatch": lib_mb,
        "library_ms_source": "torch.profiler kernel time", "library_host_wall_ms_per_minibatch": lib_wall,
        "bound_ms": b_ms, "bound_by": by, "minibatches": cfg.num_minibatches,
        "minibatch_size": cfg.minibatch_size, **epoch_kernel_count(run, cfg.num_minibatches),
    }
    print(json.dumps({label: out}), flush=True)
    return out


def epoch_kernel_count(run, n_mb: int, per_mb: int | None = None, per_call: int | None = None) -> dict:
    """The CUDA kernels of one K2 (or K2n, K2g) call (torch.profiler): its
    own (they take ``EpochArgs``, ``NarrowEpochArgs``, ``GeneralEpochArgs``
    or K2g's GEMM's ``GemmArgs``, or round its obs, ``round_rows_kernel``),
    checked against
    ``per_mb`` (K2's ``KERNELS_PER_MINIBATCH``) per minibatch plus
    ``per_call`` (``KERNELS_PER_CALL``), and any other device operations
    the call queued."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pyflyt_tpu_torch.ops import cuda_sgd

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    counts = [(evt.key, evt.count) for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA]
    mine = lambda k: "EpochArgs" in k or "GemmArgs" in k or "round_rows_kernel" in k  # noqa: E731
    own = sum(c for k, c in counts if mine(k))
    per_mb = cuda_sgd.KERNELS_PER_MINIBATCH if per_mb is None else per_mb
    per_call = cuda_sgd.KERNELS_PER_CALL if per_call is None else per_call
    want = per_mb * n_mb + per_call
    check(own == want, f"fused_epoch: {own} CUDA kernels of its own in one call, expected {want}")
    return {"cuda_kernels_per_call": own, "other_device_ops_per_call": sum(c for k, c in counts if not mine(k))}


def logp_kernel_only(rows, leaves, obs_dim: int) -> dict:
    """K3's launch alone on an image packed once (the wrapper packs the
    actor's image from the leaves on every call), and the packing alone."""
    from pyflyt_tpu_torch.ops import cuda_policy, cuda_sgd

    image = cuda_policy.pack_trunk(*leaves[:6])
    it = max(1, 20 * BATCH // rows.shape[0])
    kernel, _ = time_ms(lambda: cuda_sgd._launch_logp(rows, image, leaves[6], obs_dim), iters=it)
    pack, _ = time_ms(lambda: cuda_policy.pack_trunk(*leaves[:6]), iters=20)
    return {"kernel_ms": kernel, "pack_ms": pack}


def profiled_device_ms(fn, iters: int) -> float:
    """Summed device time of the CUDA kernels of one call, in ms
    (torch.profiler over ``iters`` calls after a warm-up)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us += getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)
    check(us > 0, "profiler: no device time recorded")
    return us / 1e3 / iters


def host_wall_ms(fn, iters: int) -> float:
    """Host wall per call, synchronized at the end, in ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def library_logp(net, rows):
    """A bf16 F.linear + tanh chain of the actor trunk and the Gaussian
    log-prob: the yardstick for K3 (the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from pyflyt_tpu_torch.rl.networks import gaussian_log_prob

    layers = [(lin.weight.detach().bfloat16(), lin.bias.detach().bfloat16())
              for lin in (*net.pi_trunk.layers, net.pi_head)]
    log_std = net.clamped_log_std().detach()
    o, a = net.obs_dim, net.action_dim

    def run():
        h = rows[:, :o].bfloat16()
        for W, b in layers[:-1]:
            h = torch.tanh(F.linear(h, W, b))
        mean = F.linear(h, *layers[-1]).float()
        return gaussian_log_prob(mean, log_std.expand_as(mean), rows[:, o : o + a])

    return run


def library_update(net, mb, stat, cfg):
    """One minibatch update through bf16 autograd and
    ``torch.optim.Adam(fused=True)``: the yardstick for K2 per minibatch
    (the port never calls it)."""
    import copy

    import torch
    from pyflyt_tpu_torch.rl.networks import gaussian_entropy, gaussian_log_prob

    model = copy.deepcopy(net).to(torch.bfloat16)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate, eps=1e-5, fused=True)
    o, a = net.obs_dim, net.action_dim
    c0 = o + a
    x = mb[:, :o].bfloat16().contiguous()
    act, old, adv, ret = mb[:, o:c0], mb[:, c0], mb[:, c0 + 1], mb[:, c0 + 2]
    adv_n = (adv - stat[0]) / (stat[1] + 1e-8)

    def run():
        mean, log_std, value = model(x)
        logp = gaussian_log_prob(mean.float(), log_std.float(), act)
        ratio = torch.exp(logp - old)
        pg = -torch.minimum(ratio * adv_n, torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n).mean()
        v = 0.5 * ((value.float() - ret) ** 2).mean()
        loss = pg + cfg.value_coef * v - cfg.entropy_coef * gaussian_entropy(log_std.float()).mean()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(model.parameters(), cfg.max_grad_norm, foreach=True)
        opt.step()
        opt.zero_grad(set_to_none=True)

    return run


# ---------------------------------------------------------------------------
# phases 11-12: the generic QuadX step (K1 generic) against its twin
# ---------------------------------------------------------------------------


ROW_GROUPS = {"pos": (0, 3), "quat": (3, 7), "lin_vel": (7, 10), "ang_vel": (10, 13), "view": (13, 25),
              "ang_vel_body": (25, 28), "drag": (28, 31), "throttle": (31, 35), "pwm": (35, 39), "pid": (43, 49)}


def airborne_state(conv: str, n: int, seed: int, grounded: bool):
    """Seeded QuadX states on the card: drones 2-6 m up (down in NED),
    tilted and moving; with ``grounded`` every 8th starts 5 mm above the
    ground falling at 1 m/s, so it hits the ground in the first step."""
    import torch
    from pyflyt_tpu_torch.models import quadx

    cfg = quadx.QuadXConfig(orn_conv=conv, control_hz=80, noisy_motors=False)
    params = quadx.build_params(cfg, "cuda")
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand(n, 3, generator=g) * 4 - 2
    pos[:, 2] = (torch.rand(n, generator=g) * 4 + 2) * (-1.0 if conv == "NED_FRD" else 1.0)
    orn = torch.rand(n, 3, generator=g) * 0.6 - 0.3
    st = quadx.init_state(params, cfg, pos.cuda(), orn.cuda())
    st.body.lin_vel = (torch.rand(n, 3, generator=g) * 2 - 1).cuda()
    st.body.ang_vel = (torch.rand(n, 3, generator=g) * 2 - 1).cuda()
    if grounded:
        st.body.pos[::8, 2] = 0.005
        st.body.lin_vel[::8, 2] = -1.0
    return cfg, params, st


def generic_setpoints(mode: int, conv: str, n: int, step: int):
    import torch

    g = torch.Generator().manual_seed(2000 + step)
    sp = torch.rand(4, n, generator=g)
    if mode == 0:
        sp[:3] -= 0.5
        sp[3] = (0.2 + 0.4 * sp[3]) * (-1.0 if conv == "NED_FRD" else 1.0)
    elif mode == 9:
        sp[:3] = (sp[:3] - 0.5) * 0.1
        sp[3] = 0.3 + 0.2 * sp[3]
    else:
        sp = 0.1 + 0.5 * sp
    return sp.cuda()


def check_generic_step() -> dict:
    """K1 generic vs its twin, noise and gusts off, at N=8192, a ragged 1000
    and a mid-warp 4093 over GENERIC_STEPS aviary steps, in every mode x
    convention x wind of its envelope (an eighth of the fleet grounded);
    the worst error per row group of each case, contact and wind rows
    exact."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_quadx as cq

    cases = {}
    for conv, n in itertools.product(("ENU_FLU", "NED_FRD"), (N_ENVS, N_RAGGED, HOVER_MIDWARP)):
        cfg, params, st = airborne_state(conv, n, seed=31, grounded=True)
        consts = cq.generic_consts(params, cfg)
        base = (torch.rand(3, n, generator=torch.Generator().manual_seed(32)) * 8 - 4).cuda()
        for mode in (0, 8, 9):
            for kind, wind in (("none", None),
                               ("baked", {"kind": "gaussian", "base": (3.0, -2.0, 0.5), "max_gust": 0.0}),
                               ("per_env", {"kind": "gaussian", "per_env_base": True, "max_gust": 0.0})):
                packed = cq.pack_state(st)
                if kind == "per_env":
                    packed[cq._WBASE : cq._WBASE + 3] = base
                seed = torch.zeros(1, dtype=torch.int64, device="cuda")
                kern, plain = packed.clone(), packed.clone()
                errs = dict.fromkeys(ROW_GROUPS, 0.0)
                hits = 0
                for i in range(GENERIC_STEPS):
                    sp = generic_setpoints(mode, conv, n, i)
                    kern[cq._SP : cq._SP + 4] = sp
                    plain[cq._SP : cq._SP + 4] = sp
                    kern = cq.packed_step(kern, seed, consts, mode, False, wind)
                    plain = cq.packed_step_plain(plain, seed, consts, mode, False, wind)
                    torch.cuda.synchronize()
                    where = f"generic {conv} N={n} mode {mode} wind {kind} step {i}"
                    check(bool(torch.isfinite(kern).all()), f"{where}: non-finite state")
                    for name, (a, b) in ROW_GROUPS.items():
                        errs[name] = max(errs[name], (kern[a:b] - plain[a:b]).abs().max().item())
                    check(torch.equal(kern[cq._CON : cq._ANY + 1], plain[cq._CON : cq._ANY + 1]),
                          f"{where}: contact rows differ")
                    check(torch.equal(kern[cq._WBASE:], plain[cq._WBASE:]), f"{where}: wind rows differ")
                    hits += int((kern[cq._ANY] > 0.5).sum())
                worst = max(errs.values())
                check(worst <= GENERIC_ATOL, f"generic {conv} N={n} mode {mode} wind {kind}: error {errs}")
                check(hits > 0, f"generic {conv} N={n} mode {mode} wind {kind}: no contact")
                cases[f"{conv}/N{n}/mode{mode}/{kind}"] = {"max_abs_err": worst, "per_group": errs}
    return cases


def check_generic_draws() -> dict:
    """The kernel's Philox draws by their statistics, read where the motion
    is known: drones at rest 5 m up, one physics iteration per launch
    (control at 240 Hz), so the new drag read is minus the wind exactly.
    Gusts (max_gust 7, per-env base): mean 0 within 5 standard errors and
    std 1 within 4% (5 standard errors) over 8192 x 3 draws, |gust| <= 7, the twin's std within
    5%, axes uncorrelated; motor noise on at the same time, throttle spread
    against the twin's, and two noisy calls bit-identical; the simple
    field's thermal mean ln(6)·strength."""
    import torch
    from pyflyt_tpu_torch.models import quadx
    from pyflyt_tpu_torch.ops import cuda_quadx as cq

    n = N_ENVS
    cfg = quadx.QuadXConfig(control_hz=240)
    params = quadx.build_params(cfg, "cuda")
    st = quadx.init_state(params, cfg, torch.tensor([0.0, 0.0, 5.0], device="cuda").expand(n, 3),
                          torch.zeros(n, 3, device="cuda"))
    packed = cq.pack_state(st)
    packed[cq._SP : cq._SP + 4] = torch.tensor([0.0, 0.0, 0.0, 0.4], device="cuda")[:, None]
    base = (torch.rand(3, n, generator=torch.Generator().manual_seed(33)) * 8 - 4).cuda()
    packed[cq._WBASE : cq._WBASE + 3] = base
    seed = torch.tensor([4242], dtype=torch.int64, device="cuda")
    c = cq.generic_consts(params, cfg, {"kind": "gaussian", "per_env_base": True, "max_gust": 7.0})
    kern = cq.packed_step(packed, seed, c, 9, True)
    check(torch.equal(kern, cq.packed_step(packed, seed, c, 9, True)), "noisy generic step: two calls differ")
    plain = cq.packed_step_plain(packed, seed, c, 9, True)
    torch.cuda.synchronize()
    gk = -kern[cq._DRG : cq._DRG + 3] - base
    gp = -plain[cq._DRG : cq._DRG + 3] - base
    se = 5.0 / n**0.5
    check(float(gk.abs().max()) <= 7.0 + 1e-4, "gusts: not clipped at 7")
    check(bool((gk.mean(1).abs() < se).all()), f"gust means {gk.mean(1).tolist()}")
    check(bool(((gk.std(1) - 1.0).abs() < 0.04).all()), f"gust std {gk.std(1).tolist()}")
    check(bool(((gk.std(1) / gp.std(1) - 1.0).abs() < 0.05).all()), f"gust std {gk.std(1).tolist()} vs twin")
    corr = torch.corrcoef(gk)
    off = corr[~torch.eye(3, dtype=torch.bool, device="cuda")]
    check(float(off.abs().max()) < 0.1, f"gust axes correlated {corr.tolist()}")
    tk, tp = kern[cq._THR : cq._THR + 4], plain[cq._THR : cq._THR + 4]
    check(bool((tk.std(1) > 0).all()), "motor noise: no spread")
    check(bool(((tk.std(1) / tp.std(1) - 1.0).abs() < 0.05).all()),
          f"motor noise std {tk.std(1).tolist()} vs twin {tp.std(1).tolist()}")
    strength = 2.0
    simple = cq.packed_step(packed, seed, c, 9, False, {"kind": "simple", "strength": strength})
    torch.cuda.synchronize()
    w = -simple[cq._DRG : cq._DRG + 3]
    thermal = float(w[2].mean())
    expected = math.log(6.0) * strength
    check(abs(thermal - expected) < se, f"simple wind thermal mean {thermal} vs {expected}")
    check(float(w[:2].mean(1).abs().max()) < se, f"simple wind xy means {w[:2].mean(1).tolist()}")
    return {"gust_mean": gk.mean(1).tolist(), "gust_std": gk.std(1).tolist(), "gust_std_plain": gp.std(1).tolist(),
            "gust_max_abs": float(gk.abs().max()), "gust_max_axis_corr": float(off.abs().max()),
            "throttle_std": tk.std(1).tolist(), "throttle_std_plain": tp.std(1).tolist(),
            "simple_thermal_mean": thermal, "simple_thermal_expected": expected}


def check_step_dropin() -> dict:
    """``cuda_quadx.step`` (pack → K1 generic → unpack) against
    ``models.quadx.step`` with the same ``GaussianWind`` (per-env base,
    max_gust 0) at N=8192 over 6 aviary steps, airborne (the reference's
    full contact is not the kernel's): mode 9 NED and mode 0 ENU. Then the
    ``use_kernel`` hover env against the plain one over 20 steps, half the
    fleet falling: obs on the live lanes, rewards and flags on all."""
    import dataclasses

    import torch
    from pyflyt_tpu_torch.core.wind import GaussianWind
    from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
    from pyflyt_tpu_torch.models import quadx
    from pyflyt_tpu_torch.ops import cuda_quadx as cq

    out = {}
    for mode, conv in ((9, "NED_FRD"), (0, "ENU_FLU")):
        cfg, params, st = airborne_state(conv, N_ENVS, seed=41, grounded=False)
        base = torch.rand(N_ENVS, 3, generator=torch.Generator().manual_seed(42)) * 8 - 4
        wind = GaussianWind.init(None, N_ENVS, base_wind=base.cuda(), max_gust=0.0, orn_conv=conv, device="cuda")
        consts = cq.generic_consts(params, cfg)
        ref, got = st, st
        launches = cq.GENERIC_KERNEL.launches
        err = 0.0
        for i in range(6):
            sp = generic_setpoints(mode, conv, N_ENVS, i).T.contiguous()
            ref = dataclasses.replace(ref, setpoint=sp)
            got = dataclasses.replace(got, setpoint=sp)
            ref, rc = quadx.step(ref, params, cfg, mode, None, wind_fn=wind)
            got, gc = cq.step(got, params, cfg, mode, None, wind=wind, consts=consts)
            torch.cuda.synchronize()
            for a, b in ((got.read.view, ref.read.view), (got.read.drag_local_vel, ref.read.drag_local_vel),
                         (got.body.pos, ref.body.pos), (got.body.quat, ref.body.quat),
                         (got.body.lin_vel, ref.body.lin_vel), (got.body.ang_vel, ref.body.ang_vel)):
                err = max(err, (a - b).abs().max().item())
            check(torch.equal(gc, rc), f"step drop-in mode {mode} {conv} step {i}: contact differs")
        check(err <= GENERIC_ATOL, f"step drop-in mode {mode} {conv}: error {err}")
        check(cq.GENERIC_KERNEL.launches - launches == 6, "step drop-in: one launch per aviary step")
        check(torch.equal(got.physics_steps, ref.physics_steps), "step drop-in: physics_steps")
        out[f"mode{mode}/{conv}"] = err

    plain = QuadXHoverEnv(noisy_motors=False, device="cuda")
    kern = dataclasses.replace(plain, use_kernel=True)
    sp_, _ = plain.reset(N_ENVS)
    sk, _ = kern.reset(N_ENVS)
    launches = cq.GENERIC_KERNEL.launches
    err = 0.0
    for i in range(PARITY_STEPS):
        a = hover_actions(N_ENVS, i, "cuda")
        sp_, op = plain.step(sp_, a)
        sk, ok = kern.step(sk, a)
        torch.cuda.synchronize()
        live = ~op.termination
        err = max(err, (ok.obs[live] - op.obs[live]).abs().max().item(), (ok.reward - op.reward).abs().max().item())
        check(torch.equal(ok.termination, op.termination), f"use_kernel env step {i}: termination differs")
    check(err <= OBS_ATOL, f"use_kernel env: error {err}")
    check(bool(op.termination.any()), "use_kernel env: no lane terminated")
    check(cq.GENERIC_KERNEL.launches - launches == PARITY_STEPS * plain.env_step_ratio, "use_kernel env launches")
    out["use_kernel_env"] = err
    return out


# ---------------------------------------------------------------------------
# phases 13-15: the mod-hovering recipe
# ---------------------------------------------------------------------------


def recipe_env():
    """The ppo_solve_r5 env: mode 9, NED, 80 Hz, a random wind base per env,
    gusts of up to 7 m/s and motor noise on, on the packed fast path."""
    from pyflyt_tpu_torch.envs.quadx_mod import PackedQuadXModHoveringEnv, QuadXModHoveringEnv

    return PackedQuadXModHoveringEnv(QuadXModHoveringEnv(
        flight_mode=9, orn_conv="NED_FRD", control_hz=80, simulate_wind=True, device="cuda"))


def all_kernels():
    from pyflyt_tpu_torch.ops import cuda_general, cuda_narrow, cuda_policy, cuda_sgd
    from pyflyt_tpu_torch.ops import cuda_quadx as cq

    from pyflyt_tpu_torch.ops import cuda_dogfight as cd
    from pyflyt_tpu_torch.ops import cuda_fixedwing as cf
    from pyflyt_tpu_torch.ops import cuda_rocket as cr

    return {"quadx_hover_step": cq.KERNEL, "quadx_step": cq.GENERIC_KERNEL,
            "quadx_waypoints_step": cq.WAYPOINTS_KERNEL, "policy_value_forward": cuda_policy.KERNEL,
            "logp_forward": cuda_sgd.LOGP_KERNEL, "fused_epoch": cuda_sgd.EPOCH_KERNEL,
            "fixedwing_step": cf.STEP_KERNEL, "fixedwing_waypoints_step": cf.WAYPOINTS_KERNEL,
            "dogfight_step": cd.KERNEL, "rocket_step": cr.STEP_KERNEL, "rocket_landing_step": cr.LANDING_KERNEL,
            "narrow_policy_value_forward": cuda_narrow.FORWARD_KERNEL, "narrow_logp_forward": cuda_narrow.LOGP_KERNEL,
            "fused_epoch_narrow": cuda_narrow.EPOCH_KERNEL,
            "general_policy_value_forward": cuda_general.FORWARD_KERNEL,
            "general_logp_forward": cuda_general.LOGP_KERNEL, "fused_epoch_general": cuda_general.EPOCH_KERNEL,
            "general_resident_forward": cuda_general.RESIDENT_FORWARD_KERNEL,
            "general_resident_logp": cuda_general.RESIDENT_LOGP_KERNEL,
            "general_resident_epoch": cuda_general.RESIDENT_EPOCH_KERNEL,
            "general_cluster_forward": cuda_general.CLUSTER_FORWARD_KERNEL,
            "general_cluster_logp": cuda_general.CLUSTER_LOGP_KERNEL}


def zero_launches() -> None:
    for k in all_kernels().values():
        k.launches = 0


def read_launches() -> dict:
    return {name: k.launches for name, k in all_kernels().items()}


def mod_rollout(seed: int, card: str):
    """8192 recipe envs x MOD_ROLLOUT_STEPS steps under the exact
    auto-reset, acting through the 2x256 tanh ActorCritic (obs 16, seeded
    random weights, log_std -1.6, the f32 forward of PPO's default path):
    one K1-generic launch per step and no other kernel. Then the per-step
    split: K1 generic's device time, the plain obs/reward half
    (``finish``) and the per-step batch reset, each on its own."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_quadx as cq
    from pyflyt_tpu_torch.rl import ppo
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    env = recipe_env()
    net = ActorCritic(env.obs_size, 4, init_log_std=-1.6, device="cuda",
                      generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    state, obs = env.reset(N_ENVS, gen)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    state, obs, _ = ppo.rollout(net, env, state, obs, 4, gen, refresh=0, fused=False)  # warm-up
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    state, obs, traj = ppo.rollout(net, env, state, obs, MOD_ROLLOUT_STEPS, gen, refresh=0, fused=False,
                                   gamma=0.99, slot=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "quadx_step": MOD_ROLLOUT_STEPS}
    check(launches == want, f"mod rollout launches {launches}, expected {want}")
    check(obs.shape == (N_ENVS, 16) and bool(torch.isfinite(obs).all()), "mod rollout: final obs")
    check(bool(torch.isfinite(traj.reward).all()), "mod rollout: non-finite rewards")
    n_done = int(traj.done.sum())
    check(n_done > 0, "mod rollout: no episode ended")
    check(bool((state.packed[cq._WBASE : cq._WBASE + 3].abs().amax(1) > 1.0).all()), "mod rollout: wind rows")

    # the per-step split, each part on its own, synchronized
    out = env.advance(state, torch.zeros(N_ENVS, 4, device="cuda"))
    seed_t = torch.tensor([7], dtype=torch.int64, device="cuda")
    packed = state.packed.contiguous()
    kernel_ms, kernel_host_ms = time_ms(lambda: cq.packed_step(packed, seed_t, env.consts, 9, True), iters=200)
    finish_ms = host_wall_ms(lambda: env.finish(state, out), iters=20)
    reset_ms = host_wall_ms(lambda: env.reset(N_ENVS, gen), iters=10)
    action = torch.zeros(N_ENVS, 4, device="cuda")
    step_ms = host_wall_ms(lambda: env.autoreset_step(state, action), iters=20)
    policy_ms = host_wall_ms(lambda: ppo.act(net, obs, gen, fused=False), iters=20)
    zero_launches()  # the split's launches are not the main path's
    return {
        "card": card, "num_envs": N_ENVS, "steps": MOD_ROLLOUT_STEPS, "wall_s": wall,
        "env_steps_per_s": N_ENVS * MOD_ROLLOUT_STEPS / wall, "ms_per_step": 1e3 * wall / MOD_ROLLOUT_STEPS,
        "episodes_done": n_done, "reset_s": reset_s, "mean_reward": float(traj.reward.mean()),
        "launches": launches,
        "split_ms": {"kernel_device": kernel_ms, "kernel_wrapper_host": kernel_host_ms,
                     "obs_reward_ops": finish_ms, "batch_reset": reset_ms,
                     "autoreset_step_total": step_ms, "policy_f32_forward_and_sample": policy_ms},
    }, state


def mod_train(seed: int, card: str):
    """The ppo_solve_r5 small recipe at full size: MOD_TRAIN_ITERS
    iterations on the default path (the first a warm-up; exact auto-reset,
    f32 autograd epochs), then one with fused_sgd and the fused rollout
    forward (K4, K3, K2 at obs 16 and 128 minibatches), from the same
    runner. Launches and Adam's count are checked per iteration; the last
    iteration of each path runs its phases one by one for the split."""
    import dataclasses

    import torch
    from pyflyt_tpu_torch.rl import PPO

    cfg = mod_ppo_config()
    env = recipe_env()
    tp = PPO(env, cfg)
    fused = PPO(env, dataclasses.replace(cfg, fused_sgd=True, fused_rollout_forward=True))
    t0 = time.perf_counter()
    runner = tp.init(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    per_update = cfg.num_epochs * cfg.num_minibatches
    rows = []
    for it in range(MOD_TRAIN_ITERS + 1):
        path = tp if it < MOD_TRAIN_ITERS else fused
        split_it = it in (MOD_TRAIN_ITERS - 1, MOD_TRAIN_ITERS)
        count0 = int(runner.opt_state.count)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner, metrics, split = run_iteration(path, runner, split_it)
        wall = time.perf_counter() - t0
        launches = read_launches()
        want = {**dict.fromkeys(launches, 0), "quadx_step": cfg.rollout_steps}
        if path is fused:
            want.update(policy_value_forward=cfg.rollout_steps, logp_forward=1, fused_epoch=cfg.num_epochs)
        check(launches == want, f"mod train iteration {it}: launches {launches}, expected {want}")
        check(int(runner.opt_state.count) - count0 == per_update, f"mod train iteration {it}: Adam count")
        check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"mod train iteration {it}: metrics")
        rows.append({"path": "fused" if path is fused else "default", "wall_s": wall, "split_s": split,
                     "launches": launches, "metrics": {k: float(v) for k, v in metrics.items()}})
    check(all(bool(torch.isfinite(p).all()) for p in runner.network.parameters()), "mod train: non-finite params")
    default_walls = [r["wall_s"] for r in rows[1:MOD_TRAIN_ITERS]]
    wall = statistics.mean(default_walls)
    return {
        "card": card, "num_envs": cfg.num_envs, "rollout_steps": cfg.rollout_steps, "batch": cfg.batch_size,
        "epochs": cfg.num_epochs, "minibatches": cfg.num_minibatches, "minibatch_size": cfg.minibatch_size,
        "init_s": init_s, "warmup_s": rows[0]["wall_s"], "default_wall_s_per_iteration": wall,
        "default_samples_per_s": cfg.batch_size / wall, "fused_wall_s": rows[-1]["wall_s"],
        "fused_samples_per_s": cfg.batch_size / rows[-1]["wall_s"], "adam_count": int(runner.opt_state.count),
        "iterations": rows,
    }, fused, runner


def run_iteration(tp, runner, split: bool):
    """One PPO iteration; with ``split`` its phases one by one, each ended
    by a synchronize: (runner, metrics, split seconds or None)."""
    import torch

    if not split:
        runner, metrics = tp.train_iteration(runner)
        torch.cuda.synchronize()
        return runner, metrics, None
    marks = [time.perf_counter()]
    runner, traj = tp._rollout(runner)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    adv, ret = tp._gae(runner.network, traj, runner.obs)
    packed = tp.pack(traj, adv, ret)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    obs_dim = traj.obs.shape[-1]
    if tp.config.fused_sgd and tp.config.fused_sgd_consistent_logp:
        tp.rewrite_old_logp(runner.network, packed, obs_dim)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    stacked = tp.sgd(runner, packed, obs_dim)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    runner.update_idx += 1
    metrics = {k: v.mean() for k, v in stacked.items()}
    metrics["mean_reward"] = traj.reward.mean()
    metrics["mean_episode_done"] = traj.done.float().mean()
    split_s = dict(zip(("rollout_s", "gae_pack_s", "logp_k3_s", "sgd_s"), [b - a for a, b in zip(marks, marks[1:])]))
    return runner, metrics, split_s


def cli_smoke(card: str) -> dict:
    """The CLI on the card: ``train`` for one iteration at 512 envs (the
    plain env at the CLI's defaults, mode 9, a 4-episode eval, checkpoints
    in a scratch directory under build/), ``eval --checkpoint`` on the fixed
    NED scenario (return, length, a 34-column CSV), ``eval-pid-expert`` in
    mode 7 (the NED position cascade of models/quadx) and in mode 10
    (ga_pid) for a 2 s episode each, the trajectory CLI's
    ``eval-pid-expert`` (mode 10) on scenarios 1-3 for 1 s each, and
    ``mode_minus1_train``."""
    import csv
    import io
    import shutil
    import tempfile
    from contextlib import redirect_stdout

    import torch
    from pyflyt_tpu_torch.rl_training import hovering, trajectory_following
    from pyflyt_tpu_torch.utils.hovering_logger import COLUMNS

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=os.path.join(HERE, "build"))
    try:
        run_dir = os.path.join(work, "run")
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()) as printed:
            runner = hovering.main(["train", "--flight_mode", "9", "--num_envs", "512",
                                    "--total_timesteps", str(512 * 32), "--eval_every_updates", "1",
                                    "--eval_episodes", "4", "--init_log_std", "-1.6", "--log_dir", run_dir])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        row = json.loads(printed.getvalue().strip().splitlines()[-1])
        check(runner.update_idx == 1, "cli train: one iteration")
        best = [n for n in os.listdir(run_dir) if n.startswith("best_model_")]
        check(len(best) == 1 and "metrics.jsonl" in os.listdir(run_dir), f"cli train wrote {os.listdir(run_dir)}")
        eval_dir = os.path.join(work, "eval")
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()) as printed:
            total, length = hovering.main(["eval", "--flight_mode", "9", "--checkpoint",
                                           os.path.join(run_dir, best[0]), "--log_dir", eval_dir])
        eval_s = time.perf_counter() - t0
        printed_eval = json.loads(printed.getvalue().strip().splitlines()[-1])
        check(printed_eval == {"episode_reward": total, "episode_length": length}, "cli eval: printed line")
        check(math.isfinite(total) and 1 <= length <= 802, f"cli eval: return {total}, length {length}")
        with open(os.path.join(eval_dir, "evaluation_results_0.csv")) as f:
            rows = list(csv.reader(f))
        check(rows[0] == COLUMNS and len(rows) == length + 1 and all(len(r) == 34 for r in rows),
              "cli eval: the 34-column CSV")
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()):
            pid_total, pid_length = hovering.main(["eval-pid-expert", "--max_duration_seconds", "2.0"])
        pid_s = time.perf_counter() - t0
        check(math.isfinite(pid_total) and 1 <= pid_length <= 162, f"cli eval-pid-expert: {pid_total}, {pid_length}")
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()):
            pid10_total, pid10_length = hovering.main(["eval-pid-expert", "--expert_mode", "10",
                                                       "--max_duration_seconds", "2.0"])
        pid10_s = time.perf_counter() - t0
        check(math.isfinite(pid10_total) and 1 <= pid10_length <= 162,
              f"cli eval-pid-expert mode 10: {pid10_total}, {pid10_length}")
        traj = {}
        for scenario in (1, 2, 3):
            t0 = time.perf_counter()
            with redirect_stdout(io.StringIO()):
                r = trajectory_following.main(["eval-pid-expert", "--scenario", str(scenario),
                                               "--max_duration_seconds", "1.0"])
            traj[scenario] = {**r, "s": time.perf_counter() - t0}
            check(math.isfinite(r["episode_reward"]) and 1 <= r["episode_length"] <= 82,
                  f"cli trajectory eval-pid-expert scenario {scenario}: {r}")
        minus1 = mode_minus1_train(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"card": card, "train_s": train_s, "train_eval_mean_reward": row["eval_mean_reward"],
            "train_eval_mean_length": row["eval_mean_length"], "eval_s": eval_s, "eval_episode_reward": total,
            "eval_episode_length": length, "csv_rows": len(rows) - 1,
            "eval_pid_expert": {"episode_reward": pid_total, "episode_length": pid_length, "s": pid_s},
            "eval_pid_expert_mode10": {"episode_reward": pid10_total, "episode_length": pid10_length, "s": pid10_s},
            "trajectory_eval_pid_expert": traj, "mode_minus1_train": minus1}


def mode_minus1_train(work: str) -> dict:
    """``hovering train --flight_mode -1 --num_envs 2048``: one iteration of
    the CLI (its PPOConfig leaves the fused paths off, as the JAX CLI does,
    so no kernel launches), then one iteration with the fused rollout
    forward and fused_sgd on the same env and trunk (the 2 x 256 default):
    K4 a rollout step, K3 once and K2 an epoch on the raw-PWM mode's data."""
    import io
    from contextlib import redirect_stdout

    import torch
    from pyflyt_tpu_torch.rl import PPO
    from pyflyt_tpu_torch.rl_training import hovering

    argv = ["train", "--flight_mode", "-1", "--num_envs", "2048", "--total_timesteps", str(2048 * 32),
            "--eval_every_updates", "1", "--eval_episodes", "1", "--log_dir", os.path.join(work, "run_minus1")]
    zero_launches()
    t0 = time.perf_counter()
    with redirect_stdout(io.StringIO()) as printed:
        runner = hovering.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    check(runner.update_idx == 1, "cli train --flight_mode -1: one iteration")
    check(not any(read_launches().values()), "cli train --flight_mode -1: a kernel launched on the default path")
    row = json.loads(printed.getvalue().strip().splitlines()[-1])
    # the CLI's own env and PPOConfig from the same arguments, fused
    args = hovering.build_parser().parse_args(argv)
    cfg = dataclasses.replace(hovering.ppo_config(args), fused_sgd=True, fused_rollout_forward=True)
    tp = PPO(hovering.build_env(args), cfg)
    runner = tp.init(0)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner, metrics, _ = run_iteration(tp, runner, split=False)
    fused_s = time.perf_counter() - t0
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "policy_value_forward": cfg.rollout_steps, "logp_forward": 1,
            "fused_epoch": cfg.num_epochs}
    check(launches == want, f"mode -1 fused iteration: launches {launches}, expected {want}")
    check(all(bool(torch.isfinite(v)) for v in metrics.values()), "mode -1 fused iteration: metrics")
    return {"cli_s": cli_s, "cli_eval_mean_reward": row["eval_mean_reward"], "fused_s": fused_s,
            "fused_launches": launches, "fused_metrics": {k: float(v) for k, v in metrics.items()}}


# ---------------------------------------------------------------------------
# phases 17-22: QuadX-Waypoints (mode 7 in K1 generic, the row-4 kernel)
# ---------------------------------------------------------------------------


WP_STEPS = 20  # agent steps of the row-4 checks
WP_ROLLOUT_STEPS = 128  # bench_suite.py's waypoints rollout (8192 envs x 128 steps)
# the row-4 checks' envs: mode 7 with a reach distance that lets some lanes
# reach all four targets in 20 steps; modes 0 and 8 with a 15-step limit
# (and in mode 8 a 2 m dome) so truncation and leaving the dome fire
WP_CHECKS = {7: dict(goal_reach_distance=1.2), 0: dict(max_duration_seconds=0.5),
             8: dict(flight_dome_size=2.0, max_duration_seconds=0.5)}
# tests/test_packed_waypoints.py's rule: a reach sits on a threshold and a
# chaotic lane drifts, so at most 4 lanes in 64 may leave the curve
# 5e-4 + 4e-4 * step; the flags of the other lanes match exactly
WP_DIVERGED_SHARE = 4 / 64
CASCADE_GROUP = {"cascade": (56, 74)}


def mode7_setpoints(n: int, step: int):
    """Position setpoints [x, y, yaw, z] on the card: x, y within 2 m, any
    yaw, 1-4 m up."""
    import torch

    g = torch.Generator().manual_seed(4000 + step)
    sp = torch.rand(4, n, generator=g)
    sp[:2] = (sp[:2] - 0.5) * 4.0
    sp[2] = (sp[2] - 0.5) * 2 * math.pi
    sp[3] = 1.0 + 3.0 * sp[3]
    return sp.cuda()


def check_generic_mode7() -> dict:
    """K1 generic in mode 7 (80 rows, ENU) vs its twin, noise and gusts off,
    at N=8192 and 1000 over GENERIC_STEPS aviary steps, wind none, baked and
    per-env (an eighth of the fleet grounded); the cascade's rows are a row
    group of their own, contact and wind rows exact, rows 74-79 zero. Then
    ``cuda_quadx.step`` mode 7 against ``models.quadx.step`` (per-env
    GaussianWind, 6 steps, airborne)."""
    import dataclasses

    import torch
    from pyflyt_tpu_torch.core.wind import GaussianWind
    from pyflyt_tpu_torch.models import quadx
    from pyflyt_tpu_torch.ops import cuda_quadx as cq

    cases = {}
    groups = {**ROW_GROUPS, **CASCADE_GROUP}
    for n in (N_ENVS, N_RAGGED):
        cfg, params, st = airborne_state("ENU_FLU", n, seed=51, grounded=True)
        consts = cq.generic_consts(params, cfg)
        base = (torch.rand(3, n, generator=torch.Generator().manual_seed(52)) * 8 - 4).cuda()
        for kind, wind in (("none", None),
                           ("baked", {"kind": "gaussian", "base": (3.0, -2.0, 0.5), "max_gust": 0.0}),
                           ("per_env", {"kind": "gaussian", "per_env_base": True, "max_gust": 0.0})):
            packed = cq.pack_state(st, 7)
            if kind == "per_env":
                packed[cq._WBASE : cq._WBASE + 3] = base
            seed = torch.zeros(1, dtype=torch.int64, device="cuda")
            kern, plain = packed.clone(), packed.clone()
            errs = dict.fromkeys(groups, 0.0)
            hits = 0
            for i in range(GENERIC_STEPS):
                sp = mode7_setpoints(n, i)
                kern[cq._SP : cq._SP + 4] = sp
                plain[cq._SP : cq._SP + 4] = sp
                kern = cq.packed_step(kern, seed, consts, 7, False, wind)
                plain = cq.packed_step_plain(plain, seed, consts, 7, False, wind)
                torch.cuda.synchronize()
                where = f"generic mode 7 N={n} wind {kind} step {i}"
                check(kern.shape == (cq.ROWS_MODE7, n) and bool(torch.isfinite(kern).all()), f"{where}: state")
                for name, (a, b) in groups.items():
                    errs[name] = max(errs[name], (kern[a:b] - plain[a:b]).abs().max().item())
                check(torch.equal(kern[cq._CON : cq._ANY + 1], plain[cq._CON : cq._ANY + 1]), f"{where}: contact")
                check(torch.equal(kern[cq._WBASE : cq._LP_INT], plain[cq._WBASE : cq._LP_INT]), f"{where}: wind rows")
                check(not bool(kern[cq._ZV_PRV + 1 :].any()), f"{where}: rows 74-79 not zero")
                hits += int((kern[cq._ANY] > 0.5).sum())
            worst = max(errs.values())
            check(worst <= GENERIC_ATOL, f"generic mode 7 N={n} wind {kind}: error {errs}")
            check(hits > 0, f"generic mode 7 N={n} wind {kind}: no contact")
            cases[f"mode7/N{n}/{kind}"] = {"max_abs_err": worst, "per_group": errs}

    cfg, params, st = airborne_state("ENU_FLU", N_ENVS, seed=53, grounded=False)
    base = torch.rand(N_ENVS, 3, generator=torch.Generator().manual_seed(54)) * 8 - 4
    wind = GaussianWind.init(None, N_ENVS, base_wind=base.cuda(), max_gust=0.0, orn_conv="ENU_FLU", device="cuda")
    consts = cq.generic_consts(params, cfg)
    ref, got = st, st
    launches = cq.GENERIC_KERNEL.launches
    err = 0.0
    for i in range(6):
        sp = mode7_setpoints(N_ENVS, i).T.contiguous()
        ref, rc = quadx.step(dataclasses.replace(ref, setpoint=sp), params, cfg, 7, None, wind_fn=wind)
        got, gc = cq.step(dataclasses.replace(got, setpoint=sp), params, cfg, 7, None, wind=wind, consts=consts)
        torch.cuda.synchronize()
        for a, b in ((got.read.view, ref.read.view), (got.body.pos, ref.body.pos), (got.body.quat, ref.body.quat),
                     (got.body.lin_vel, ref.body.lin_vel), (got.body.ang_vel, ref.body.ang_vel),
                     (got.pids.lin_pos.integral, ref.pids.lin_pos.integral),
                     (got.pids.z_vel.prev_error, ref.pids.z_vel.prev_error)):
            err = max(err, (a - b).abs().max().item())
        check(torch.equal(gc, rc), f"mode-7 step drop-in step {i}: contact differs")
    check(err <= GENERIC_ATOL, f"mode-7 step drop-in: error {err}")
    check(cq.GENERIC_KERNEL.launches - launches == 6, "mode-7 step drop-in: one launch per aviary step")
    cases["mode7/step_dropin"] = {"max_abs_err": err}
    return cases


def wp_env(mode: int, **kw):
    from pyflyt_tpu_torch.envs import PackedQuadXWaypointsEnv, QuadXWaypointsEnv

    return PackedQuadXWaypointsEnv(QuadXWaypointsEnv(flight_mode=mode, device="cuda", **kw))


def wp_actions(mode: int, packed, step: int, n: int):
    """Agent actions on the card: mode 7 chases each lane's current target
    (the first waypoint rows hold it, in world coordinates); mode 0 random
    rates, weak thrust on half the fleet; mode 8 random PWM, a third of the
    fleet at zero and a sixth at 0.9."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_quadx as cq

    if mode == 7:
        cur = packed[cq.rows_for(7) + cq._WP_TGT : cq.rows_for(7) + cq._WP_TGT + 3]
        return torch.stack([cur[0], cur[1], torch.zeros_like(cur[0]), cur[2]])
    g = torch.Generator().manual_seed(3000 + step)
    a = torch.rand(4, n, generator=g)
    if mode == 0:
        a[:3] = (a[:3] - 0.5) * 1.2
        a[3] = 0.3 * a[3]
        a[3, n // 2 :] += 0.35
    else:
        a = 0.1 + 0.5 * a
        a[:, : n // 3] = 0.0
        a[:, n // 3 : n // 2] = 0.9
    return a.cuda()


def check_waypoints_step() -> dict:
    """The row-4 kernel vs its twin in modes 7, 0 and 8 at N=8192, 1000 and
    a mid-warp 4093 over WP_STEPS agent steps from the env's reset (noise
    off), an eighth of the fleet started 2 cm above the ground falling and
    an eighth at the dome's edge flying out; at 4093 the upper half 0-4
    agent steps short of the time limit by their column mod 5, so lanes of
    one warp truncate, and leave the aviary loop, at different agent steps
    (checked): reach, advance, all-reached, termination, truncation and the
    freeze all fire (each is checked to). Per lane, the largest difference
    over all rows; at most WP_DIVERGED_SHARE of the lanes beyond 5e-4 +
    4e-4 * step, every row of the others (flags included) within it. A
    frozen lane keeps every row but the setpoint, the step count and the
    re-armed reward. Then the noise: identical lanes, one noisy agent step,
    the throttle spread against the twin's, two noisy calls bit-identical."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_quadx as cq

    out = {}
    for mode, kw in WP_CHECKS.items():
        env = wp_env(mode, noisy_motors=False, **kw)
        wb = cq.rows_for(mode)
        for n in (N_ENVS, N_RAGGED, HOVER_MIDWARP):
            staggered = n == HOVER_MIDWARP
            state, _ = env.reset(n, torch.Generator(device="cuda").manual_seed(60 + mode))
            packed = state.packed.clone()
            packed[cq._POS + 2, : n // 8] = 0.02
            packed[cq._LVEL + 2, : n // 8] = -1.0
            packed[cq._POS, n // 8 : n // 4] = 0.99 * math.sqrt(env.consts.dome2)
            packed[cq._LVEL, n // 8 : n // 4] = 3.0
            if staggered:
                cols = torch.arange(n // 2, n, device="cuda")
                packed[cq._STEP, cols] = env.consts.max_steps - (cols % 5).float()
            first_frozen = torch.full((n,), -1, dtype=torch.long, device="cuda")
            seed = torch.zeros(1, dtype=torch.int64, device="cuda")
            kern, plain = packed.clone(), packed.clone()
            ev = dict.fromkeys(("reach", "all_reached", "termination", "truncation", "out_of_bounds",
                                "collision", "frozen"), 0)
            err, diverged = 0.0, 0
            keep = torch.ones(cq.rows_for_waypoints(mode), dtype=torch.bool, device="cuda")
            keep[cq._SP : cq._SP + 4] = False
            keep[cq._RWD] = False  # re-armed to -0.1 every agent step, frozen or not
            keep[cq._STEP] = False
            for i in range(WP_STEPS):
                a = wp_actions(mode, kern, i, n)
                kern[cq._SP : cq._SP + 4] = a
                plain[cq._SP : cq._SP + 4] = a
                before = kern.clone()
                kern = cq.packed_waypoints_step(kern, seed, env.consts, mode, False)
                plain = cq.packed_waypoints_step_plain(plain, seed, env.consts, mode, False)
                torch.cuda.synchronize()
                where = f"waypoints mode {mode} N={n} step {i}"
                check(bool(torch.isfinite(kern).all()), f"{where}: non-finite state")
                lane = (kern - plain).abs().amax(0)
                bad = lane > 5e-4 + 4e-4 * i
                diverged = max(diverged, int(bad.sum()))
                check(int(bad.sum()) <= WP_DIVERGED_SHARE * n, f"{where}: {int(bad.sum())} lanes diverged")
                err = max(err, lane[~bad].max().item())
                done0 = (before[cq._TERM] > 0.5) | (before[cq._TRUNC] > 0.5)
                check(torch.equal(kern[keep][:, done0], before[keep][:, done0]), f"{where}: a frozen lane moved")
                ev["frozen"] += int(done0.sum())
                ev["reach"] += int((kern[wb + cq._WP_REM] < before[wb + cq._WP_REM] - 0.5).sum())
                first_frozen[((kern[cq._TERM] > 0.5) | (kern[cq._TRUNC] > 0.5)) & (first_frozen < 0)] = i
            for name, row in (("all_reached", wb + cq._WP_CPLT), ("termination", cq._TERM),
                              ("truncation", cq._TRUNC), ("out_of_bounds", cq._OOB), ("collision", cq._COLL)):
                ev[name] = int((kern[row] > 0.5).sum())
            need = {7: ("reach", "all_reached", "termination", "out_of_bounds", "collision", "frozen"),
                    0: ("termination", "truncation", "frozen"), 8: ("termination", "truncation", "out_of_bounds")}[mode]
            check(all(ev[k] > 0 for k in need), f"waypoints mode {mode} N={n}: events {ev}")
            if staggered:  # warps whose lanes froze at different agent steps
                ff = first_frozen[: n - n % 32].view(-1, 32)
                mixed = int(((ff.amax(1) != ff.amin(1)) & (ff.amin(1) >= 0)).sum())
                check(mixed > 0, f"waypoints mode {mode} N={n}: no warp froze at two agent steps")
                ev["warps_frozen_at_two_steps"] = mixed
            out[f"mode{mode}/N{n}"] = {"max_abs_err": err, "max_diverged_lanes": diverged, "events": ev}

    env = wp_env(7, noisy_motors=False)
    state, _ = env.reset(N_ENVS, torch.Generator(device="cuda").manual_seed(70))
    packed = state.packed[:, :1].expand(-1, N_ENVS).contiguous()  # identical lanes
    seed = torch.tensor([9876], dtype=torch.int64, device="cuda")
    noisy = cq.packed_waypoints_step(packed, seed, env.consts, 7, True)
    check(torch.equal(noisy, cq.packed_waypoints_step(packed, seed, env.consts, 7, True)),
          "noisy waypoints step: two calls differ")
    tk = noisy[cq._THR : cq._THR + 4]
    tp = cq.packed_waypoints_step_plain(packed, seed, env.consts, 7, True)[cq._THR : cq._THR + 4]
    sk, sp_ = tk.std(1), tp.std(1)
    se = torch.sqrt((sk**2 + sp_**2) / N_ENVS)
    check(bool((sk > 0).all()), "noisy waypoints kernel: no spread")
    check(bool(((tk.mean(1) - tp.mean(1)).abs() <= 6 * se).all()), "noisy waypoints kernel: throttle means")
    check(bool(((sk / sp_ - 1).abs() <= 0.05).all()), f"noisy waypoints throttle std {sk.tolist()} vs {sp_.tolist()}")
    out["noise"] = {"throttle_std_kernel": sk.tolist(), "throttle_std_plain": sp_.tolist()}
    return out


def wp_rollout(seed: int, card: str):
    """The serving path: a 2x256 tanh ActorCritic (obs 33, seeded random
    weights) acting through K4 in 8192 stock PackedQuadXWaypointsEnv(
    QuadXWaypointsEnv(flight_mode=7)) envs (noise on) for WP_ROLLOUT_STEPS
    steps, without resets (finished lanes stay frozen, as in an
    evaluation): one row-4 and one K4 launch per step, nothing else. Then
    the per-step split, each part on its own."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_policy
    from pyflyt_tpu_torch.ops import cuda_quadx as cq
    from pyflyt_tpu_torch.rl import ppo
    from pyflyt_tpu_torch.rl.networks import ActorCritic, gaussian_log_prob

    env = wp_env(7)
    net = ActorCritic(env.flat_obs_size, 4, device="cuda", generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    low, high = ppo.action_bounds(env, torch.device("cuda"))

    def run(state, obs, steps):
        rewards = []
        for _ in range(steps):
            action, _, _ = ppo.act(net, obs, gen, fused=True)
            state, out = env.step(state, torch.clamp(action, low, high))
            obs = ppo._flat_obs(out.obs)
            rewards.append(out.reward)
        return state, obs, out, torch.stack(rewards)

    t0 = time.perf_counter()
    state, obs = env.reset(N_ENVS, gen)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    obs = ppo._flat_obs(obs)
    state, obs, _, _ = run(state, obs, 4)  # warm-up
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    state, obs, out, rewards = run(state, obs, WP_ROLLOUT_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "quadx_waypoints_step": WP_ROLLOUT_STEPS,
            "policy_value_forward": WP_ROLLOUT_STEPS}
    check(launches == want, f"waypoints rollout launches {launches}, expected {want}")
    check(obs.shape == (N_ENVS, 33) and bool(torch.isfinite(obs).all()), "waypoints rollout: final obs")
    check(bool(torch.isfinite(rewards).all()), "waypoints rollout: non-finite rewards")
    reached = out.info["num_targets_reached"]
    check(bool(((reached >= 0) & (reached <= 4)).all()), "waypoints rollout: num_targets_reached")

    # the per-step split, each part on its own
    w = net.kernel_weights()
    k4_ms, k4_host = time_ms(lambda: cuda_policy.policy_value_forward(obs, w), iters=200)
    mean, value = cuda_policy.policy_value_forward(obs, w)
    log_std = net.clamped_log_std().detach().expand_as(mean)

    def sample():
        a = mean + torch.exp(log_std) * torch.randn(mean.shape, generator=gen, device="cuda")
        return a, gaussian_log_prob(mean, log_std, a)

    sample_ms = host_wall_ms(sample, iters=50)
    packed = state.packed.contiguous()
    seed_t = torch.tensor([5], dtype=torch.int64, device="cuda")
    kernel_ms, kernel_host = time_ms(lambda: cq.packed_waypoints_step(packed, seed_t, env.consts, 7, True), iters=200)
    obs_ms = host_wall_ms(lambda: ppo._flat_obs(env._obs(packed)), iters=50)
    action = torch.zeros(N_ENVS, 4, device="cuda")
    step_ms = host_wall_ms(lambda: env.step(state, action), iters=50)
    act_ms = host_wall_ms(lambda: ppo.act(net, obs, gen, fused=True), iters=50)
    zero_launches()  # the split's launches are not the main path's
    done = out.termination | out.truncation
    return {
        "card": card, "num_envs": N_ENVS, "steps": WP_ROLLOUT_STEPS, "wall_s": wall,
        "env_steps_per_s": N_ENVS * WP_ROLLOUT_STEPS / wall, "ms_per_step": 1e3 * wall / WP_ROLLOUT_STEPS,
        "reset_s": reset_s, "lanes_done": int(done.sum()), "targets_reached": int(reached.sum()),
        "mean_reward": float(rewards.mean()), "launches": launches,
        "split_ms": {"k4_device": k4_ms, "k4_wrapper_host": k4_host, "sample_host": sample_ms,
                     "act_total_host": act_ms, "kernel_device": kernel_ms, "kernel_wrapper_host": kernel_host,
                     "obs_assembly_host": obs_ms, "env_step_total_host": step_ms},
    }, state, net, obs


def wp_train(seed: int, card: str) -> dict:
    """PPOConfig's defaults at 8192 envs (32 steps, 15 epochs x 32
    minibatches, exact auto-reset, f32 autograd) on the plain
    QuadXWaypointsEnv(flight_mode=7, use_kernel=True): a warm-up iteration
    and one timed, split iteration. Each inner aviary step is one K1
    generic launch in mode 7 (env_step_ratio per env step); nothing else
    launches. Adam's count advances by 15 x 32 per iteration."""
    import torch
    from pyflyt_tpu_torch.envs import QuadXWaypointsEnv
    from pyflyt_tpu_torch.rl import PPO, PPOConfig

    env = QuadXWaypointsEnv(flight_mode=7, use_kernel=True, device="cuda")
    cfg = PPOConfig(num_envs=N_ENVS)
    tp = PPO(env, cfg)
    t0 = time.perf_counter()
    runner = tp.init(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(runner.obs.shape == (N_ENVS, 33), "waypoints training: flat obs width")
    rows = []
    for it in range(2):
        count0 = int(runner.opt_state.count)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner, metrics, split = run_iteration(tp, runner, split=it == 1)
        wall = time.perf_counter() - t0
        launches = read_launches()
        want = {**dict.fromkeys(launches, 0), "quadx_step": cfg.rollout_steps * env.env_step_ratio}
        check(launches == want, f"waypoints training iteration {it}: launches {launches}, expected {want}")
        check(int(runner.opt_state.count) - count0 == cfg.num_epochs * cfg.num_minibatches,
              f"waypoints training iteration {it}: Adam count")
        check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"waypoints training iteration {it}: metrics")
        rows.append({"wall_s": wall, "split_s": split, "launches": launches,
                     "metrics": {k: float(v) for k, v in metrics.items()}})
    check(all(bool(torch.isfinite(p).all()) for p in runner.network.parameters()), "waypoints training: params")
    wall = rows[-1]["wall_s"]
    zero_launches()
    return {"card": card, "num_envs": cfg.num_envs, "rollout_steps": cfg.rollout_steps, "batch": cfg.batch_size,
            "epochs": cfg.num_epochs, "minibatches": cfg.num_minibatches, "init_s": init_s,
            "warmup_s": rows[0]["wall_s"], "wall_s": wall, "samples_per_s": cfg.batch_size / wall,
            "split_s": rows[-1]["split_s"], "launches_per_iteration": rows[-1]["launches"],
            "metrics": rows[-1]["metrics"]}


def wp_fused_train(seed: int, card: str) -> dict:
    """One ``fused_sgd`` PPO iteration at obs 33, built as ``wp_train`` builds
    its PPO (PPOConfig's defaults at 8192 envs on QuadXWaypointsEnv(
    flight_mode=7, use_kernel=True)) with ``fused_sgd``: the counts are
    zeroed just before the iteration and read just after: env_step_ratio
    K1 launches per env step, one K3 and num_epochs K2 launches, nothing
    else; Adam's count advances by 15 x 32."""
    import torch
    from pyflyt_tpu_torch.envs import QuadXWaypointsEnv
    from pyflyt_tpu_torch.rl import PPO, PPOConfig

    env = QuadXWaypointsEnv(flight_mode=7, use_kernel=True, device="cuda")
    cfg = PPOConfig(num_envs=N_ENVS, fused_sgd=True)
    tp = PPO(env, cfg)
    runner = tp.init(seed)
    check(runner.obs.shape == (N_ENVS, 33), "waypoints fused training: flat obs width")
    before = [p.detach().clone() for p in runner.network.parameters()]
    count0 = int(runner.opt_state.count)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner, metrics, split = run_iteration(tp, runner, split=True)
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "quadx_step": cfg.rollout_steps * env.env_step_ratio,
            "logp_forward": 1, "fused_epoch": cfg.num_epochs}
    check(launches == want, f"waypoints fused training: launches {launches}, expected {want}")
    check(int(runner.opt_state.count) - count0 == cfg.num_epochs * cfg.num_minibatches,
          "waypoints fused training: Adam count")
    check(all(bool(torch.isfinite(v)) for v in metrics.values()), "waypoints fused training: metrics")
    check(all(bool(torch.isfinite(p).all()) for p in runner.network.parameters()), "waypoints fused training: params")
    moved = max((a - b.detach()).abs().max().item() for a, b in zip(before, runner.network.parameters()))
    check(moved > 1e-4, "waypoints fused training did not move the params")
    zero_launches()
    return {"card": card, "num_envs": cfg.num_envs, "obs_dim": 33, "batch": cfg.batch_size,
            "epochs": cfg.num_epochs, "minibatches": cfg.num_minibatches, "wall_s": wall,
            "samples_per_s": cfg.batch_size / wall, "split_s": split, "launches_per_iteration": launches,
            "max_param_change": moved, "metrics": {k: float(v) for k, v in metrics.items()}}


def ptxas_usage(source: str) -> dict:
    """The most registers and stack bytes any instantiation of ``source``
    uses, and its spill bytes summed over the instantiations (the build's
    ``-Xptxas -v`` report)."""
    import re

    from pyflyt_tpu_torch.ops import cuda_build

    log = cuda_build.library_path(source).with_suffix(".log")
    text = log.read_text() if log.exists() else ""
    num = lambda pat: [int(v) for v in re.findall(pat, text)]  # noqa: E731
    return {"max_registers": max(num(r"Used (\d+) registers"), default=None),
            "max_stack_frame_bytes": max(num(r"(\d+) bytes stack frame"), default=None),
            "spill_store_bytes": sum(num(r"(\d+) bytes spill stores")),
            "spill_load_bytes": sum(num(r"(\d+) bytes spill loads")),
            "instantiations": len(num(r"Used (\d+) registers"))}


def bound_of(nbytes: float, ops: float, flops_rate: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / flops_rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_waypoint_kernels(wp_state, net33, obs33) -> dict:
    """At the waypoints path's shapes (8192 envs, mode 7, noise on): the
    row-4 kernel, K1 generic in mode 7 (80 rows, no wind, as the
    ``use_kernel`` env runs it), K4 at obs 33 and K3 over a 262,144-row PPO
    batch at obs 33: device time, the plain twin, the library yardstick
    where one exists, and the bound."""
    import torch
    from pyflyt_tpu_torch.models import quadx
    from pyflyt_tpu_torch.ops import cuda_quadx as cq
    from pyflyt_tpu_torch.ops import cuda_sgd

    out = {}
    env = wp_env(7)
    c = env.consts
    packed = wp_state.packed.contiguous()
    seed = torch.tensor([13], dtype=torch.int64, device="cuda")
    ms, host = time_ms(lambda: cq.packed_waypoints_step(packed, seed, c, 7, True), iters=200)
    plain, _ = time_ms(lambda: cq.packed_waypoints_step_plain(packed, seed, c, 7, True), iters=2, repeats=3,
                       device_timed=False)
    rd, wr = cq.waypoints_rows_moved(7)
    b_ms, by = bound_of((rd + wr) * 4 * N_ENVS + 8, N_ENVS * cq.waypoints_ops_per_env(c, 7), H100_F32_FLOPS)
    out["quadx_waypoints_step"] = {"ms": ms, "host_ms": host, "plain_ms": plain, "bound_ms": b_ms, "bound_by": by,
                                   "rows_read": rd, "rows_written": wr}

    cfg = quadx.QuadXConfig(control_hz=120)
    params = quadx.build_params(cfg, "cuda")
    gc = cq.generic_consts(params, cfg)
    g7 = torch.cat([packed[: cq.ROWS_MODE7 - 6], torch.zeros(6, N_ENVS, device="cuda")]).contiguous()
    g7[cq._ANY : cq._LP_INT] = 0.0  # the generic layout's rows 50-55
    ms, host = time_ms(lambda: cq.packed_step(g7, seed, gc, 7, True), iters=200)
    plain, _ = time_ms(lambda: cq.packed_step_plain(g7, seed, gc, 7, True), iters=3, repeats=3, device_timed=False)
    b_ms, by = bound_of((cq.generic_rows_read(gc, 7) + cq.ROWS_MODE7) * 4 * N_ENVS + 8,
                        N_ENVS * cq.generic_ops_per_env(gc, 7), H100_F32_FLOPS)
    out["quadx_step_mode7"] = {"ms": ms, "host_ms": host, "plain_ms": plain, "bound_ms": b_ms, "bound_by": by}

    out["policy_value_forward_obs33"] = time_policy_forward(net33, obs33)

    rows = packed_rows(net33, BATCH, seed=310)
    pl_ = pi_leaves(net33)
    ms, host = time_ms(lambda: cuda_sgd.logp_forward(rows, pl_, 33, vf_sizes=trunk_sizes(net33.vf_trunk)),
                       iters=20)
    plain, _ = time_ms(lambda: cuda_sgd.logp_forward_plain(rows, pl_, 33), iters=3, repeats=3, device_timed=False)
    lib, _ = time_ms(library_logp(net33, rows), iters=20)
    nb = sum(t.numel() * t.element_size() for t in (rows, *pl_)) + BATCH * 4
    b_ms, by = bound_of(nb, cuda_sgd.logp_flops(BATCH, 33, 4), H100_BF16_FLOPS)
    out["logp_forward_obs33"] = {"ms": ms, "host_ms": host, "plain_ms": plain, "library_ms": lib,
                                 "bound_ms": b_ms, "bound_by": by, "rows": BATCH,
                                 **logp_kernel_only(rows, pl_, 33)}
    print(json.dumps({"wp_kernel_times": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 23-28: Fixedwing-Waypoints (kernel K5: rows 5-7)
# ---------------------------------------------------------------------------


FW_ENVS = 4096  # fixedwing_rl_r5.py's num_envs, bench_suite.py's fixedwing width
FW_MIDWARP = 4093  # a width whose last warp holds one group of lanes (K5: 8 lanes an env)
FW_STEPS = 20  # agent steps of the row-6 checks
FW_DROPIN_STEPS = 30  # tests/test_pallas_fixedwing.py's trajectory
FW_ROLLOUT_STEPS = 128
FW_EVAL_EPISODES = 256
FW_EVAL_MIN_TARGETS = 3.0
FW_POLICY = "fixedwing_r5_lr3e-4_seed0"
FW_ARCHIVE_LOG = "docs/artifacts/fixedwing_rl_r5_tpu.jsonl"
# row groups of the fixedwing layout, held at tests/test_pallas_fixedwing.py:59-93's
# tolerances for one aviary step against the twin
FW_GROUPS = {"pos": (0, 3, 3e-5), "quat": (3, 7, 1e-5), "lin_vel": (7, 10, 1e-3), "ang_vel": (10, 13, 2e-3),
             "view": (13, 25, 1e-3), "surface_local_vel": (25, 40, 1e-3), "actuation": (40, 45, 1e-5),
             "throttle": (45, 46, 1e-5)}


def fw_ppo_config():
    """fixedwing_rl_r5.py's lr3e-4 recipe (docs/artifacts/fixedwing_rl_r5.py:89-92)."""
    from pyflyt_tpu_torch.rl import PPOConfig

    return PPOConfig(num_envs=FW_ENVS, rollout_steps=128, num_epochs=4, num_minibatches=16, learning_rate=3e-4,
                     clip_eps=0.2, init_log_std=-0.5, cached_reset_refresh=64)


def fw_airborne(model: str, mode: int, n: int, seed: int):
    """tests/test_pallas_fixedwing.py's states on the card: 45-55 m up,
    tilted and spinning, cruise, slow (post-stall) and climbing speeds,
    surfaces and throttle away from rest, a held setpoint."""
    import torch
    from pyflyt_tpu_torch.models import fixedwing

    cfg = fixedwing.FixedwingConfig(drone_model=model, noisy_motors=False)
    params = fixedwing.build_params(cfg, "cuda")
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand(n, 3, generator=g) * 10 - 5
    pos[:, 2] += 50.0
    st = fixedwing.init_state(params, cfg, pos.cuda(), (torch.rand(n, 3, generator=g) - 0.5).cuda(), mode)
    st.body.lin_vel = (torch.tensor([15.0, 0.0, 0.0]) + 6.0 * torch.randn(n, 3, generator=g)).cuda()
    st.body.ang_vel = (0.6 * torch.randn(n, 3, generator=g)).cuda()
    st.actuation = (0.4 * torch.randn(n, 5, generator=g)).cuda()
    st.throttle = (0.5 * torch.randn(n, 1, generator=g)).abs().cuda()
    st.read = fixedwing.update_state(st.body, params, cfg, st.physics_steps)
    sp = torch.rand(n, 6 if mode == -1 else 4, generator=g) * 1.2 - 0.6
    sp[:, -1] = sp[:, -1].abs()
    st.setpoint = sp.cuda()
    return cfg, params, st


def check_fw_step() -> tuple[dict, dict]:
    """Row 5 against its twin (noise off) on 4096, a ragged 1000 and a
    mid-warp 4093 random airborne states, modes -1 and 0 x fixedwing and
    acrowing: the worst
    error per row group of one aviary step at the test tolerances, the
    any-contact row exact and rows 54-87 zero. Then the main path of rows
    7 -> 5: ``cuda_fixedwing.step`` against the card's
    ``models.fixedwing.step`` over 30 steps per case (position 2e-3 at the
    end, as tests/test_pallas_fixedwing.py:118-132), its launches counted
    from all kernels at zero. Then the noise: identical lanes, one noisy
    step, the throttle's relative spread against the twin's and the motor's
    noise ratio, and a second noisy call bit-identical to the first."""
    import torch
    from pyflyt_tpu_torch.models import fixedwing
    from pyflyt_tpu_torch.ops import cuda_fixedwing as cf

    out = {}
    zero = torch.zeros(1, dtype=torch.int64, device="cuda")
    for model in ("fixedwing", "acrowing"):
        for mode in (-1, 0):
            for n in (FW_ENVS, N_RAGGED, FW_MIDWARP):
                cfg, params, st = fw_airborne(model, mode, n, seed=80 + n + mode)
                c = cf.fixedwing_consts(params, cfg)
                packed = cf.pack_state(st)
                kern = cf.packed_step(packed, zero, c, mode, False)
                plain = cf.packed_step_plain(packed, zero, c, mode, False)
                torch.cuda.synchronize()
                where = f"fixedwing step {model} mode {mode} N={n}"
                check(bool(torch.isfinite(kern).all()), f"{where}: non-finite state")
                errs = {name: (kern[a:b] - plain[a:b]).abs().max().item() for name, (a, b, _) in FW_GROUPS.items()}
                bad = {k: v for k, v in errs.items() if v > FW_GROUPS[k][2]}
                check(not bad, f"{where}: beyond tolerance {bad}")
                check(torch.equal(kern[cf._CON : cf._RWD + 1], plain[cf._CON : cf._RWD + 1]), f"{where}: contact rows")
                check(not bool(kern[cf._RWD + 1 :].any()), f"{where}: rows 54-87 not zero")
                out[f"{model}/mode{mode}/N{n}"] = {"max_abs_err": max(errs.values()), "per_group": errs}

    zero_launches()  # the main path of rows 7 -> 5
    dropin = {}
    for model in ("fixedwing", "acrowing"):
        for mode in (-1, 0):
            cfg, params, st = fw_airborne(model, mode, FW_ENVS, seed=90 + mode)
            c = cf.fixedwing_consts(params, cfg)
            ref, got = st, st
            err = 0.0
            for i in range(FW_DROPIN_STEPS):
                ref, rc = fixedwing.step(ref, params, cfg, mode)
                got, gc = cf.step(got, params, cfg, mode, consts=c)
                check(torch.equal(gc, rc), f"step drop-in {model} mode {mode} step {i}: contact differs")
                if i == 0:
                    err = max((a - b).abs().max().item() for a, b in (
                        (got.body.pos, ref.body.pos), (got.body.quat, ref.body.quat), (got.read.view, ref.read.view)))
            torch.cuda.synchronize()
            check(err <= 1e-3, f"step drop-in {model} mode {mode}: first-step error {err}")
            pos_err = (got.body.pos - ref.body.pos).abs().max().item()
            check(pos_err <= 2e-3, f"step drop-in {model} mode {mode}: position error {pos_err} after 30 steps")
            check(torch.equal(got.physics_steps, ref.physics_steps), "step drop-in: physics_steps")
            dropin[f"{model}/mode{mode}"] = {"first_step_max_abs_err": err, "pos_err_after_30": pos_err}
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "fixedwing_step": 4 * FW_DROPIN_STEPS}
    check(launches == want, f"fixedwing step drop-in launches {launches}, expected {want}")
    out["step_dropin"] = dropin

    cfg, params, st = fw_airborne("fixedwing", 0, 8, seed=95)
    c = cf.fixedwing_consts(params, fixedwing.FixedwingConfig())
    packed = cf.pack_state(st)[:, :1].expand(-1, FW_ENVS).contiguous()  # identical lanes
    seed = torch.tensor([2468], dtype=torch.int64, device="cuda")
    quiet = cf.packed_step(packed, seed, c, 0, False)[cf._THR]
    noisy = cf.packed_step(packed, seed, c, 0, True)
    check(torch.equal(noisy, cf.packed_step(packed, seed, c, 0, True)), "noisy fixedwing step: two calls differ")
    rk = noisy[cf._THR] / quiet - 1.0
    rp = cf.packed_step_plain(packed, seed, c, 0, True)[cf._THR] / quiet - 1.0
    torch.cuda.synchronize()
    se = float(rk.std()) * 6 / FW_ENVS**0.5
    check(float(rk.std()) > 0, "noisy fixedwing step: no spread")
    check(abs(float(rk.mean()) - float(rp.mean())) <= 2 * se, f"noisy fixedwing step: means {rk.mean()} {rp.mean()}")
    check(abs(float(rk.std()) / float(rp.std()) - 1.0) <= 0.1, f"noisy fixedwing step: std {rk.std()} vs {rp.std()}")
    out["noise"] = {"throttle_rel_std_kernel": float(rk.std()), "throttle_rel_std_plain": float(rp.std()),
                    "noise_ratio": c.mot_noise}
    return out, launches


def fw_env(**kw):
    from pyflyt_tpu_torch.envs import FixedwingWaypointsEnv, PackedFixedwingWaypointsEnv

    return PackedFixedwingWaypointsEnv(FixedwingWaypointsEnv(device="cuda", **kw))


def check_fw_waypoints() -> dict:
    """Row 6 against its twin (noise off) over FW_STEPS agent steps at 4096
    stock envs, then with a 25 m reach, then staggered at the mid-warp
    4093, from the env's reset with traps: an eighth of the fleet 0.4 m
    up falling (collision), an eighth at the dome's edge flying out
    (out-of-dome), a sixteenth one step short of the time limit
    (truncation), a sixteenth with its last target at its own position
    (reach and all-reached); staggered, the envs from the fourth eighth on
    0-4 agent steps short of the time limit by their column mod 5, so the
    envs of one warp freeze at different agent steps. Per lane, the
    largest difference over all rows: at most WP_DIVERGED_SHARE of the
    lanes beyond 5e-4 + 4e-4 * step, every row of the others (flags
    included) within it. A frozen lane keeps every row but the setpoint,
    the re-armed reward and the step count. Then two noisy calls of the
    stock fleet bit-identical."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_fixedwing as cf

    out = {}
    for name, n, kw in (("stock", FW_ENVS, {}), ("reach25", FW_ENVS, dict(goal_reach_distance=25.0)),
                        ("staggered", FW_MIDWARP, {})):
        env = fw_env(noisy_motors=False, **kw)
        state, _ = env.reset(n, torch.Generator(device="cuda").manual_seed(100))
        packed = state.packed.clone()
        e, s = n // 8, n // 16
        packed[cf._POS + 2, :e] = 0.4
        packed[cf._LVEL + 2, :e] = -8.0
        packed[cf._POS, e : 2 * e] = 99.5
        packed[cf._STEP, 2 * e : 2 * e + s] = float(env.base.max_steps + 1)
        t = slice(2 * e + s, 2 * e + 2 * s)
        packed[cf._TGT : cf._TGT + 3, t] = packed[cf._VIEW + 9 : cf._VIEW + 12, t]
        packed[cf._REM, t] = 1.0
        if name == "staggered":
            cols = torch.arange(3 * e, n, device="cuda")
            packed[cf._STEP, cols] = float(env.base.max_steps) - (cols % 5).float()
        seed = torch.zeros(1, dtype=torch.int64, device="cuda")
        kern, plain = packed.clone(), packed.clone()
        first_frozen = torch.full((n,), -1, dtype=torch.long, device="cuda")
        ev = dict.fromkeys(("reach", "all_reached", "termination", "truncation", "out_of_bounds", "collision",
                            "frozen"), 0)
        err, diverged = 0.0, 0
        keep = torch.ones(cf.ROWS, dtype=torch.bool, device="cuda")
        keep[cf._SP : cf._SP + 6] = False
        keep[cf._RWD] = False
        keep[cf._STEP] = False
        g = torch.Generator().manual_seed(110)
        for i in range(FW_STEPS):
            a = torch.rand(4, n, generator=g) * 0.8 - 0.4
            a[3] = a[3].abs() + 0.3
            a = a.cuda()
            kern[cf._SP : cf._SP + 4] = a
            plain[cf._SP : cf._SP + 4] = a
            before = kern.clone()
            kern = cf.packed_waypoints_step(kern, seed, env.consts, 0, False)
            plain = cf.packed_waypoints_step_plain(plain, seed, env.consts, 0, False)
            torch.cuda.synchronize()
            where = f"fixedwing waypoints {name} step {i}"
            check(bool(torch.isfinite(kern).all()), f"{where}: non-finite state")
            lane = (kern - plain).abs().amax(0)
            bad = lane > 5e-4 + 4e-4 * i
            diverged = max(diverged, int(bad.sum()))
            check(int(bad.sum()) <= WP_DIVERGED_SHARE * n, f"{where}: {int(bad.sum())} lanes diverged")
            err = max(err, lane[~bad].max().item())
            done0 = (before[cf._TERM] > 0.5) | (before[cf._TRUNC] > 0.5)
            check(torch.equal(kern[keep][:, done0], before[keep][:, done0]), f"{where}: a frozen lane moved")
            check(torch.equal(kern[cf._STEP], before[cf._STEP] + 1.0), f"{where}: step count")
            first_frozen[done0 & (first_frozen < 0)] = i
            ev["frozen"] += int(done0.sum())
            ev["reach"] += int((kern[cf._REM] < before[cf._REM] - 0.5).sum())
        for key, row in (("all_reached", cf._CPLT), ("termination", cf._TERM), ("truncation", cf._TRUNC),
                         ("out_of_bounds", cf._OOB), ("collision", cf._COLL)):
            ev[key] = int((kern[row] > 0.5).sum())
        check(all(v > 0 for v in ev.values()), f"fixedwing waypoints {name}: events {ev}")
        out[name] = {"max_abs_err": err, "max_diverged_lanes": diverged, "events": ev}
        if name == "staggered":  # warps (4 envs at 8 lanes an env) whose envs froze at different steps
            per_warp = first_frozen[: n - n % 4].view(-1, 4)
            mixed = int(((per_warp.amax(1) != per_warp.amin(1)) & (per_warp.amin(1) >= 0)).sum())
            check(mixed > 0, "fixedwing waypoints staggered: no warp froze at two agent steps")
            out[name]["warps_frozen_at_two_or_more_steps"] = mixed
    env = fw_env()
    state, _ = env.reset(FW_ENVS, torch.Generator(device="cuda").manual_seed(101))
    seed = torch.tensor([2468], dtype=torch.int64, device="cuda")
    first = cf.packed_waypoints_step(state.packed, seed, env.consts, 0, True)
    check(torch.equal(first, cf.packed_waypoints_step(state.packed, seed, env.consts, 0, True)),
          "noisy fixedwing waypoints step: two calls differ")
    return out


def fw_rollout(net, seed: int, card: str):
    """The serving path: ``net`` (obs 35) acting through K4 in 4096 stock
    PackedFixedwingWaypointsEnv envs (noise on) for FW_ROLLOUT_STEPS steps,
    sampled actions, no resets: one row-6 and one K4 launch per step,
    nothing else. Then the per-step split, each part on its own, and the
    device's busy share over 16 profiled steps."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_fixedwing as cf
    from pyflyt_tpu_torch.ops import cuda_policy
    from pyflyt_tpu_torch.rl import ppo

    env = fw_env()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    low, high = ppo.action_bounds(env, torch.device("cuda"))

    def run(state, obs, steps):
        rewards = []
        for _ in range(steps):
            action, _, _ = ppo.act(net, obs, gen, fused=True)
            state, out = env.step(state, torch.clamp(action, low, high))
            obs = ppo._flat_obs(out.obs)
            rewards.append(out.reward)
        return state, obs, out, torch.stack(rewards)

    t0 = time.perf_counter()
    state, obs = env.reset(FW_ENVS, gen)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    obs = ppo._flat_obs(obs)
    state, obs, _, _ = run(state, obs, 4)  # warm-up
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    state, obs, out, rewards = run(state, obs, FW_ROLLOUT_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "fixedwing_waypoints_step": FW_ROLLOUT_STEPS,
            "policy_value_forward": FW_ROLLOUT_STEPS}
    check(launches == want, f"fixedwing rollout launches {launches}, expected {want}")
    check(obs.shape == (FW_ENVS, 35) and bool(torch.isfinite(obs).all()), "fixedwing rollout: final obs")
    check(bool(torch.isfinite(rewards).all()), "fixedwing rollout: non-finite rewards")
    reached = out.info["num_targets_reached"]
    check(bool(((reached >= 0) & (reached <= 4)).all()), "fixedwing rollout: num_targets_reached")

    w = net.kernel_weights()
    k4_ms, k4_host = time_ms(lambda: cuda_policy.policy_value_forward(obs, w), iters=200)
    packed = state.packed.contiguous()
    seed_t = torch.tensor([5], dtype=torch.int64, device="cuda")
    kernel_ms, kernel_host = time_ms(lambda: cf.packed_waypoints_step(packed, seed_t, env.consts, 0, True), iters=200)
    obs_ms = host_wall_ms(lambda: ppo._flat_obs(env._obs(packed)), iters=50)
    action = torch.zeros(FW_ENVS, 4, device="cuda")
    step_ms = host_wall_ms(lambda: env.step(state, action), iters=50)
    act_ms = host_wall_ms(lambda: ppo.act(net, obs, gen, fused=True), iters=50)
    prof = profiled(lambda: run(state, obs, 16), "fw_rollout_profile_16_steps")
    zero_launches()  # the split's launches are not the main path's
    done = out.termination | out.truncation
    return {
        "card": card, "num_envs": FW_ENVS, "steps": FW_ROLLOUT_STEPS, "wall_s": wall,
        "env_steps_per_s": FW_ENVS * FW_ROLLOUT_STEPS / wall, "ms_per_step": 1e3 * wall / FW_ROLLOUT_STEPS,
        "reset_s": reset_s, "lanes_done": int(done.sum()), "targets_reached": int(reached.sum()),
        "mean_reward": float(rewards.mean()), "launches": launches,
        "split_ms": {"k4_device": k4_ms, "k4_wrapper_host": k4_host, "act_total_host": act_ms,
                     "kernel_device": kernel_ms, "kernel_wrapper_host": kernel_host,
                     "obs_assembly_host": obs_ms, "env_step_total_host": step_ms},
        "profiled_16_steps": {"wall_ms": prof["wall_ms"], "device_busy_ms": prof["device_busy_ms"],
                              "device_busy_share": prof["device_busy_ms"] / prof["wall_ms"]},
    }, state, obs


def fw_archive_eval() -> dict:
    """The JAX package's 256-episode evals of FW_POLICY from its training
    log (recipe lr3e-4, seed 0): the archived parameters are the best
    ones, so ``best_eval_256`` is theirs; ``final_eval_256`` is the last
    iteration's."""
    with open(os.path.join(HERE, FW_ARCHIVE_LOG)) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    row = next(r for r in rows if r.get("recipe") == "lr3e-4" and r.get("seed") == 0)
    keys = ("targets_mean", "complete_rate", "collision_rate", "oob_rate")
    return {k: {m: row[k][m] for m in keys} for k in ("best_eval_256", "final_eval_256")}


def fw_eval(net, seed: int, card: str) -> dict:
    """The archived r5 policy flown deterministically (K4's mean, clipped)
    in FW_EVAL_EPISODES stock packed envs (noise on) for max_steps + 2
    steps, with fixedwing_rl_r5.py:48-84's accounting: finished lanes stay
    frozen, so the last state carries each episode's targets reached,
    completion, collision and out-of-dome flags. Fails under
    FW_EVAL_MIN_TARGETS targets on average."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_fixedwing as cf
    from pyflyt_tpu_torch.ops import cuda_policy
    from pyflyt_tpu_torch.rl import ppo

    env = fw_env()
    n = FW_EVAL_EPISODES
    low, high = ppo.action_bounds(env, torch.device("cuda"))
    w = net.kernel_weights()
    zero_launches()
    t0 = time.perf_counter()
    state, obs = env.reset(n, torch.Generator(device="cuda").manual_seed(seed + 999))
    obs = ppo._flat_obs(obs)
    done = torch.zeros(n, dtype=torch.bool, device="cuda")
    ep_rew = torch.zeros(n, device="cuda")
    steps = env.base.max_steps + 2
    for _ in range(steps):
        mean, _ = cuda_policy.policy_value_forward(obs, w)
        state, out = env.step(state, torch.clamp(mean, low, high))
        ep_rew = ep_rew + out.reward * ~done
        done = done | out.termination | out.truncation
        obs = ppo._flat_obs(out.obs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "fixedwing_waypoints_step": steps, "policy_value_forward": steps}
    check(launches == want, f"fixedwing eval launches {launches}, expected {want}")
    p = state.packed
    targets = (env.base.num_targets - p[cf._REM]).round()
    res = {
        "card": card, "episodes": n, "steps": steps, "wall_s": wall, "all_done": bool(done.all()),
        "targets_mean": float(targets.mean()), "complete_rate": float((p[cf._CPLT] > 0.5).float().mean()),
        "collision_rate": float((p[cf._COLL] > 0.5).float().mean()),
        "oob_rate": float((p[cf._OOB] > 0.5).float().mean()), "mean_ep_reward": float(ep_rew.mean()),
        "archive": fw_archive_eval(), "policy": FW_POLICY, "launches": launches,
    }
    check(res["all_done"], "fixedwing eval: an episode did not end")
    check(res["targets_mean"] >= FW_EVAL_MIN_TARGETS, f"fixedwing eval: targets_mean {res['targets_mean']}")
    zero_launches()
    return res


def fw_train(seed: int, card: str) -> dict:
    """fixedwing_rl_r5.py's lr3e-4 recipe on the plain FixedwingWaypointsEnv()
    (cached auto-reset, refresh 64; the f32 module acts and the f32
    autograd step learns, as in the JAX recipe, so no kernel of the port
    launches): a warm-up iteration and one timed, split iteration. Adam's
    count advances by 4 x 16 per iteration."""
    import torch
    from pyflyt_tpu_torch.envs import FixedwingWaypointsEnv
    from pyflyt_tpu_torch.rl import PPO

    cfg = fw_ppo_config()
    tp = PPO(FixedwingWaypointsEnv(device="cuda"), cfg)
    t0 = time.perf_counter()
    runner = tp.init(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(runner.obs.shape == (FW_ENVS, 35), "fixedwing training: flat obs width")
    rows = []
    for it in range(2):
        count0 = int(runner.opt_state.count)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner, metrics, split = run_iteration(tp, runner, split=it == 1)
        wall = time.perf_counter() - t0
        launches = read_launches()
        check(launches == dict.fromkeys(launches, 0), f"fixedwing training iteration {it}: launches {launches}")
        check(int(runner.opt_state.count) - count0 == cfg.num_epochs * cfg.num_minibatches,
              f"fixedwing training iteration {it}: Adam count")
        check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"fixedwing training iteration {it}: metrics")
        rows.append({"wall_s": wall, "split_s": split, "metrics": {k: float(v) for k, v in metrics.items()}})
    check(all(bool(torch.isfinite(p).all()) for p in runner.network.parameters()), "fixedwing training: params")
    wall = rows[-1]["wall_s"]
    return {"card": card, "num_envs": cfg.num_envs, "rollout_steps": cfg.rollout_steps, "batch": cfg.batch_size,
            "epochs": cfg.num_epochs, "minibatches": cfg.num_minibatches, "init_s": init_s,
            "warmup_s": rows[0]["wall_s"], "wall_s": wall, "samples_per_s": cfg.batch_size / wall,
            "split_s": rows[-1]["split_s"], "metrics": rows[-1]["metrics"]}


def time_fw_kernels(fw_state, net35, obs35) -> dict:
    """At the slice's shapes (4096 envs, noise on, mode 0): row 5 (one
    aviary step of the fixedwing) and row 6 (the stock agent step), each
    against the bound, the twin and the ptxas report (per variant:
    registers; summed: stack and spills); K4 at obs 35 (the archived
    policy) with its cuBLAS yardstick."""
    import re

    import torch
    from pyflyt_tpu_torch.models import fixedwing
    from pyflyt_tpu_torch.ops import cuda_build
    from pyflyt_tpu_torch.ops import cuda_fixedwing as cf

    out = {}
    env = fw_env()
    c = env.consts
    packed = fw_state.packed.contiguous()
    seed = torch.tensor([17], dtype=torch.int64, device="cuda")
    cfg = fixedwing.FixedwingConfig()
    c5 = cf.fixedwing_consts(fixedwing.build_params(cfg, "cuda"), cfg)
    for name, kernel, plain_fn, consts, waypoints in (
        ("fixedwing_step", cf.packed_step, cf.packed_step_plain, c5, False),
        ("fixedwing_waypoints_step", cf.packed_waypoints_step, cf.packed_waypoints_step_plain, c, True),
    ):
        ms, host_ms = time_ms(lambda: kernel(packed, seed, consts, 0, True), iters=200)
        plain, _ = time_ms(lambda: plain_fn(packed, seed, consts, 0, True), iters=2, repeats=3, device_timed=False)
        rd, wr = cf.rows_moved(waypoints)
        b_ms, by = bound_of((rd + wr) * 4 * FW_ENVS + 8, FW_ENVS * cf.ops_per_env(consts, waypoints), H100_F32_FLOPS)
        out[name] = {"ms": ms, "host_ms": host_ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": by,
                     "rows_read": rd, "rows_written": wr, "ops_per_env": cf.ops_per_env(consts, waypoints),
                     "physics_iterations": consts.ratio * (consts.inner_steps if waypoints else 1)}
    out["ptxas"] = ptxas_usage("fixedwing_step.cu")
    log = cuda_build.library_path("fixedwing_step.cu").with_suffix(".log")
    variants = re.findall(r"entry function '_Z\w*?(step_kernel|waypoints_kernel)I(\w+?)EEv\w*'.*?Used (\d+) registers",
                          log.read_text() if log.exists() else "", re.S)
    out["ptxas_variants"] = [{"kernel": k, "template": t, "registers": int(r)} for k, t, r in variants]
    out["policy_value_forward_obs35"] = time_policy_forward(net35, obs35)
    print(json.dumps({"fw_kernel_times": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 29-33: the dogfight (K7)
# ---------------------------------------------------------------------------

DF_ARENAS = 4096  # the league's 8192 agent rows (dogfight_league_r5.py:47)
DF_RAGGED = 999  # 1998 drones: a partial last warp
DF_MIDWARP = 1001  # 2002 drones: the last warp holds one pair of groups (K7: 8 lanes a drone)
DF_STEPS = 20  # agent steps of the K7 checks
DF_ROLLOUT_STEPS = 128  # the league recipe's rollout length
DF_MATCHES = 256  # the league's duels (dogfight_league_r5.py:90)
DF_MIN_WIN = 0.95  # s100 against init, either seat (archive 0.992 / 0.996)
DF_POLICY = "dogfight_league_r5_s100"
DF_INIT = "dogfight_league_r5_init"
DF_ARCHIVE_LOG = "docs/artifacts/dogfight_league_r5_tpu.jsonl"
DF_DIVERGED_SHARE = 4 / 64  # of a trap's lanes, as WP_DIVERGED_SHARE
# the traps of the K7 checks, by arena mod 8 (the rest fly free)
DF_TRAPS = ("hit", "mutual", "ground", "out_of_dome", "time_limit", "other_dead")


def df_env(**kw):
    """The league's env (dogfight_league_r5.py:48-50: stock 30 Hz, 60 s,
    noise on) as the self-play view over the packed env."""
    from pyflyt_tpu_torch.envs import MAFixedwingDogfightEnv, PackedMAFixedwingDogfightEnv, SelfPlayDogfightEnv

    return SelfPlayDogfightEnv(PackedMAFixedwingDogfightEnv(MAFixedwingDogfightEnv(device="cuda", **kw)))


def df_traps(packed, arenas: int, max_steps: int):
    """Presets the traps on a reset's packed state, in place, by arena
    mod 8: drone 1 flying 8 m ahead of drone 0's nose and 0.4 m to its left
    (hits), drone 1 0.5 m from drone 0 (mutual collision), drone 0 0.4 m up
    falling at 8 m/s (ground), drone 0 at the dome's edge flying out,
    the step count 5 short of the time limit; other-dead is a row the
    caller writes every step. Returns the drone columns of each trap."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_dogfight as cd
    from pyflyt_tpu_torch.ops import cuda_fixedwing as cf

    a = torch.arange(arenas, device=packed.device)
    d0 = {name: 2 * a[a % 8 == k] for k, name in enumerate(DF_TRAPS)}
    e = packed[cf._VIEW + 3 : cf._VIEW + 6]  # drone 0's euler
    for name in ("hit", "mutual"):
        c0 = d0[name]
        c1 = c0 + 1
        for base in (cf._QUAT, cf._LVEL, cf._AVEL):
            width = 4 if base == cf._QUAT else 3
            packed[base : base + width, c1] = packed[base : base + width, c0]
        roll, pitch, yaw = e[0, c0], e[1, c0], e[2, c0]
        fwd = torch.stack([torch.cos(yaw) * torch.cos(pitch), torch.sin(yaw) * torch.cos(pitch), -torch.sin(pitch)])
        left = torch.stack([-torch.sin(yaw), torch.cos(yaw), torch.zeros_like(yaw)])
        shift = 8.0 * fwd + 0.4 * left if name == "hit" else 0.5 * left
        packed[cf._POS : cf._POS + 3, c1] = packed[cf._POS : cf._POS + 3, c0] + shift
    g = d0["ground"]
    packed[cf._POS + 2, g] = 0.4
    packed[cf._LVEL + 2, g] = -8.0
    o = d0["out_of_dome"]
    packed[cf._POS, o] = 149.0
    packed[cf._LVEL, o] = 20.0
    t = d0["time_limit"]
    packed[cd._STEPC, torch.cat([t, t + 1])] = float(max_steps - 5)
    return {name: torch.cat([c, c + 1]) for name, c in d0.items()}


def check_df_step() -> dict:
    """K7 against its twin (noise off, stock 30 Hz) over DF_STEPS agent
    steps at 4096, a ragged 999 and a mid-warp 1001 arenas, from the env's reset with the
    traps of ``df_traps``, each chained on its own. Per lane, the largest
    difference over the rows (the reward row relative to 1 + |reward|):
    at most DF_DIVERGED_SHARE of a trap's lanes beyond 5e-4 + 4e-4 * step,
    every trap firing. Then the noise: identical lanes, the throttle's
    relative spread and mean against the twin's, and a second noisy call
    bit-identical to the first."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_dogfight as cd
    from pyflyt_tpu_torch.ops import cuda_fixedwing as cf

    out = {}
    for arenas in (DF_ARENAS, DF_RAGGED, DF_MIDWARP):
        env = df_env(noisy_motors=False).penv
        st, _ = env.reset(arenas, torch.Generator(device="cuda").manual_seed(290))
        packed = st.packed.clone()
        lanes = df_traps(packed, arenas, env.base.max_steps)
        othd = torch.zeros(2 * arenas, device="cuda")
        othd[lanes["other_dead"]] = 1.0
        seed = torch.zeros(1, dtype=torch.int64, device="cuda")
        kern, plain = packed, packed.clone()
        g = torch.Generator().manual_seed(291)
        err, diverged = 0.0, dict.fromkeys(DF_TRAPS + ("free",), 0)
        free = torch.ones(2 * arenas, dtype=torch.bool, device="cuda")
        for c in lanes.values():
            free[c] = False
        groups = {**lanes, "free": free.nonzero().flatten()}
        ev = dict.fromkeys(DF_TRAPS, 0)
        for i in range(DF_STEPS):
            a = torch.rand(4, 2 * arenas, generator=g) * 0.8 - 0.4
            a[3] = 0.75
            for p in (kern, plain):
                p[cf._SP : cf._SP + 4] = a.to(p.device)
                p[cd._OTHD] = othd
            kern = cd.packed_dogfight_step(kern, seed, env.consts, False)
            plain = cd.packed_dogfight_step_plain(plain, seed, env.consts, False)
            torch.cuda.synchronize()
            where = f"dogfight step N={arenas} step {i}"
            check(bool(torch.isfinite(kern).all()), f"{where}: non-finite state")
            diff = (kern - plain).abs()
            diff[cd._RWD] = diff[cd._RWD] / (1.0 + plain[cd._RWD].abs())
            lane = diff.amax(0)
            bad = lane > 5e-4 + 4e-4 * i
            for name, cols in groups.items():
                nbad = int(bad[cols].sum())
                diverged[name] = max(diverged[name], nbad)
                check(nbad <= DF_DIVERGED_SHARE * len(cols), f"{where}: {nbad} of {len(cols)} {name} lanes diverged")
            err = max(err, lane[~bad].max().item())
            check(torch.equal(kern[cd._STEPC], plain[cd._STEPC]), f"{where}: step count")
            check(not bool(kern[cd._STEPC + 1 :].any()), f"{where}: padding rows not zero")
            ev["hit"] += int(kern[cd._HIT, lanes["hit"]].sum())
            ev["mutual"] += int((kern[cd._COLLF, lanes["mutual"]] > 0.5).sum())
            ev["ground"] += int((kern[cd._COLLF, lanes["ground"]] > 0.5).sum())
            ev["out_of_dome"] += int((kern[cd._OOBF, lanes["out_of_dome"]] > 0.5).sum())
            ev["time_limit"] += int((kern[cd._TRUNC, lanes["time_limit"]] > 0.5).sum())
            ev["other_dead"] += int((kern[cd._TERM, lanes["other_dead"]] > 0.5).sum())
        check(all(v > 0 for v in ev.values()), f"dogfight step N={arenas}: traps {ev}")
        check(float(kern[cd._HP, lanes["hit"]].min()) < 1.0, f"dogfight step N={arenas}: no health lost to hits")
        out[f"N{arenas}"] = {"max_abs_err": err, "max_diverged_lanes": diverged, "events": ev}

    env = df_env().penv
    st, _ = env.reset(2, torch.Generator(device="cuda").manual_seed(292))
    packed = st.packed[:, :1].expand(-1, 2 * DF_ARENAS).contiguous()  # identical lanes
    packed[cf._SP + 3] = 0.75
    seed = torch.tensor([2468], dtype=torch.int64, device="cuda")
    quiet = cd.packed_dogfight_step(packed, seed, env.consts, False)[cf._THR]
    noisy = cd.packed_dogfight_step(packed, seed, env.consts, True)
    check(torch.equal(noisy, cd.packed_dogfight_step(packed, seed, env.consts, True)),
          "noisy dogfight step: two calls differ")
    rk = noisy[cf._THR] / quiet - 1.0
    rp = cd.packed_dogfight_step_plain(packed, seed, env.consts, True)[cf._THR] / quiet - 1.0
    torch.cuda.synchronize()
    se = float(rk.std()) * 6 / (2 * DF_ARENAS) ** 0.5
    check(float(rk.std()) > 0, "noisy dogfight step: no spread")
    check(abs(float(rk.mean()) - float(rp.mean())) <= 2 * se, f"noisy dogfight step: means {rk.mean()} {rp.mean()}")
    check(abs(float(rk.std()) / float(rp.std()) - 1.0) <= 0.1, f"noisy dogfight step: std {rk.std()} vs {rp.std()}")
    out["noise"] = {"throttle_rel_std_kernel": float(rk.std()), "throttle_rel_std_plain": float(rp.std()),
                    "noise_ratio": env.consts.mot_noise}
    return out


def df_rollout(net, seed: int, card: str):
    """The serving path: ``net`` (s100, obs 30) acting, sampled, through K4
    in SelfPlayDogfightEnv at 8192 rows with the cached arena auto-reset
    (refresh 64) for DF_ROLLOUT_STEPS steps: one K7 and one K4 launch per
    step, nothing else. Then the per-step split, each part on its own,
    the device's busy share over 16 profiled steps, and a short plain
    MAQuadXHoverEnv run on the card."""
    import torch
    from pyflyt_tpu_torch.envs import MAQuadXHoverEnv
    from pyflyt_tpu_torch.ops import cuda_dogfight as cd
    from pyflyt_tpu_torch.ops import cuda_policy
    from pyflyt_tpu_torch.rl import ppo

    env = df_env()
    rows = 2 * DF_ARENAS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    ars, obs = env.cached_autoreset_init(rows, gen)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    ars, obs, _ = ppo.rollout(net, env, ars, obs, 4, gen, refresh=64)  # warm-up
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    ars, obs, traj = ppo.rollout(net, env, ars, obs, DF_ROLLOUT_STEPS, gen, refresh=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "dogfight_step": DF_ROLLOUT_STEPS, "policy_value_forward": DF_ROLLOUT_STEPS}
    check(launches == want, f"dogfight rollout launches {launches}, expected {want}")
    check(obs.shape == (rows, 30) and bool(torch.isfinite(obs).all()), "dogfight rollout: final obs")
    check(bool(torch.isfinite(traj.reward).all()), "dogfight rollout: non-finite rewards")
    n_done = int(traj.done.sum())  # arenas ended and respawned from the pool (recorded, not required)
    check(ars.step_idx == DF_ROLLOUT_STEPS + 4, "dogfight rollout: the cached auto-reset's step count")

    w = net.kernel_weights()
    k4_ms, k4_host = time_ms(lambda: cuda_policy.policy_value_forward(obs, w), iters=200)
    inner = ars.env_state.inner
    packed = inner.packed.contiguous()
    seed_t = torch.tensor([5], dtype=torch.int64, device="cuda")
    consts = env.penv.consts
    kernel_ms, kernel_host = time_ms(lambda: cd.packed_dogfight_step(packed, seed_t, consts, True), iters=200)
    obs_ms = host_wall_ms(lambda: env.penv._obs(packed, inner.current_actions), iters=50)
    action = torch.zeros(rows, 4, device="cuda")
    step_ms = host_wall_ms(lambda: env.step(ars.env_state, action), iters=50)
    auto_ms = host_wall_ms(lambda: env.cached_autoreset_step(ars, action, refresh=10**9), iters=50)
    refresh_ms = host_wall_ms(lambda: env.penv.reset(DF_ARENAS, gen), iters=3)
    act_ms = host_wall_ms(lambda: ppo.act(net, obs, gen, fused=True), iters=50)
    prof = profiled(lambda: ppo.rollout(net, env, ars, obs, 16, gen, refresh=64), "df_rollout_profile_16_steps")

    quad = MAQuadXHoverEnv(device="cuda")  # the plain MA QuadX env: 1024 arenas x 4 drones, 40 steps
    qgen = torch.Generator(device="cuda").manual_seed(seed + 1)
    qs, qobs = quad.reset(1024, qgen)
    t0 = time.perf_counter()
    for _ in range(40):
        qs, qout = quad.step(qs, torch.tensor([0.0, 0.0, 0.0, 0.6], device="cuda").expand(1024, 4, 4))
    torch.cuda.synchronize()
    quad_wall = time.perf_counter() - t0
    check(qout.obs.shape == (1024, 4, quad.obs_size) and bool(torch.isfinite(qout.obs).all()), "MA QuadX obs")
    check(bool(torch.isfinite(qout.reward).all()), "MA QuadX rewards")
    zero_launches()  # the split's launches are not the main path's
    return {
        "card": card, "agent_rows": rows, "arenas": DF_ARENAS, "steps": DF_ROLLOUT_STEPS, "wall_s": wall,
        "agent_steps_per_s": rows * DF_ROLLOUT_STEPS / wall, "ms_per_step": 1e3 * wall / DF_ROLLOUT_STEPS,
        "reset_s": reset_s, "rows_done": n_done, "mean_reward": float(traj.reward.mean()), "launches": launches,
        "split_ms": {"k4_device": k4_ms, "k4_wrapper_host": k4_host, "act_total_host": act_ms,
                     "kernel_device": kernel_ms, "kernel_wrapper_host": kernel_host,
                     "obs_assembly_host": obs_ms, "selfplay_step_host": step_ms,
                     "cached_autoreset_step_host": auto_ms, "pool_refresh_host": refresh_ms},
        "profiled_16_steps": {"wall_ms": prof["wall_ms"], "device_busy_ms": prof["device_busy_ms"],
                              "device_busy_share": prof["device_busy_ms"] / prof["wall_ms"]},
        "ma_quadx": {"arenas": 1024, "steps": 40, "wall_s": quad_wall, "agent_steps_per_s": 4 * 1024 * 40 / quad_wall,
                     "alive_share": float(qs.alive.float().mean())},
    }, packed


def df_archive_duels() -> dict:
    """The league's s100/init duels from its log (256 matches each)."""
    with open(os.path.join(HERE, DF_ARCHIVE_LOG)) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    m = next(r for r in rows if r.get("stage") == "league")["matrix"]
    return {k: m[k] for k in ("s100_vs_init", "init_vs_s100")}


def df_duel(s100, init, seed: int, card: str) -> dict:
    """``evaluate_versus`` on the league's env (noise on, deterministic
    actions), DF_MATCHES matches of s100 against init and of init against
    s100; fails if s100 wins under DF_MIN_WIN of either."""
    import torch
    from pyflyt_tpu_torch.rl.ppo import act_deterministic, action_bounds
    from pyflyt_tpu_torch.rl_training.dogfight_selfplay import evaluate_versus

    env = df_env()
    low, high = action_bounds(env, torch.device("cuda"))
    pol = {"s100": lambda o: act_deterministic(s100, o, low, high), "init": lambda o: act_deterministic(init, o, low, high)}
    out = {"card": card, "archive": df_archive_duels()}
    for i, (a, b) in enumerate((("s100", "init"), ("init", "s100"))):
        zero_launches()
        t0 = time.perf_counter()
        res = evaluate_versus(env, pol[a], pol[b], torch.Generator(device="cuda").manual_seed(seed + 31 + i), DF_MATCHES)
        torch.cuda.synchronize()
        res.update(wall_s=time.perf_counter() - t0, launches=read_launches()["dogfight_step"])
        out[f"{a}_vs_{b}"] = res
        check(res["finished"] == DF_MATCHES, f"duel {a} vs {b}: {res['finished']} of {DF_MATCHES} matches ended")
    out["s100_win_rate"] = {"seat_0": out["s100_vs_init"]["win_rate_a"], "seat_1": out["init_vs_s100"]["loss_rate_a"]}
    check(min(out["s100_win_rate"].values()) >= DF_MIN_WIN, f"duel: s100's win rates {out['s100_win_rate']}")
    zero_launches()
    return out


def df_train(seed: int, card: str) -> dict:
    """The league recipe (dogfight_league_r5.py:47-55) at 8192 rows: a
    warm-up and one timed, split iteration on the default f32 path, then a
    warm-up and one timed iteration with ``fused_sgd`` (K2 at obs 30,
    its 65,536-row minibatches held against the twin in phase 8 as
    ``EPOCH_DF_ROWS``). One K7 launch per rollout step on both paths, plus K3 once
    and K2 once per epoch with ``fused_sgd``; Adam's count advances by 4 x
    16 per iteration."""
    import torch
    from pyflyt_tpu_torch.rl import PPO
    from pyflyt_tpu_torch.rl_training import dogfight_selfplay

    args = argparse.Namespace(sparse_reward=False, noisy_motors=True, damage_per_hit=0.02, max_duration_seconds=60.0,
                        agent_hz=30, layer_size=256, num_of_layers=2, init_log_std=-1.0, num_envs=2 * DF_ARENAS,
                        rollout_steps=DF_ROLLOUT_STEPS, n_epochs=4, num_minibatches=16, learning_rate=3e-4,
                        clip_eps=0.2, entropy_coef=0.0, cached_reset_refresh=64, device="cuda")
    env = dogfight_selfplay.build_env(args)
    out = {"card": card}
    for path in ("default", "fused_sgd"):
        tp = dogfight_selfplay.mk_ppo(args, env)
        if path == "fused_sgd":
            tp = PPO(env, dataclasses.replace(tp.config, fused_sgd=True))
        cfg = tp.config
        t0 = time.perf_counter()
        runner = tp.init(seed)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        check(runner.obs.shape == (cfg.num_envs, 30), "dogfight training: obs width")
        check(cfg.minibatch_size == EPOCH_DF_ROWS, "dogfight training: K2's minibatch is not phase 8's")
        rows = []
        for it in range(2):
            count0 = int(runner.opt_state.count)
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner, metrics, split = run_iteration(tp, runner, split=it == 1)
            wall = time.perf_counter() - t0
            launches = read_launches()
            want = {**dict.fromkeys(launches, 0), "dogfight_step": cfg.rollout_steps}
            if cfg.fused_sgd:
                want.update(logp_forward=1, fused_epoch=cfg.num_epochs)
            check(launches == want, f"dogfight training {path} iteration {it}: launches {launches}, expected {want}")
            check(int(runner.opt_state.count) - count0 == cfg.num_epochs * cfg.num_minibatches,
                  f"dogfight training {path} iteration {it}: Adam count")
            check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"dogfight training {path}: metrics")
            rows.append({"wall_s": wall, "split_s": split, "launches": launches,
                         "metrics": {k: float(v) for k, v in metrics.items()}})
        check(all(bool(torch.isfinite(p).all()) for p in runner.network.parameters()), "dogfight training: params")
        wall = rows[-1]["wall_s"]
        out[path] = {"agent_rows": cfg.num_envs, "rollout_steps": cfg.rollout_steps, "batch": cfg.batch_size,
                     "epochs": cfg.num_epochs, "minibatches": cfg.num_minibatches, "init_s": init_s,
                     "warmup_s": rows[0]["wall_s"], "wall_s": wall, "samples_per_s": cfg.batch_size / wall,
                     "split_s": rows[-1]["split_s"], "launches_per_iteration": rows[-1]["launches"],
                     "metrics": rows[-1]["metrics"]}
    zero_launches()
    return out


def measured_launch(fn, kernel: str, source: str, n: int, calls: int = 3) -> dict:
    """The launches of the CUDA kernel whose name holds ``kernel`` over
    ``calls`` calls of ``fn``, as torch.profiler's trace records them
    (grid, block, registers a thread: CUPTI's kernel record); fails unless
    each call launched it once, each as ``source``'s GROUP lanes a column
    (1 where it defines none) over ``n`` columns in blocks of its THREADS
    (the constants read from the source)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pyflyt_tpu_torch.ops import cuda_build

    group, threads = _source_group(source), _source_const(source, "THREADS")
    fn()
    torch.cuda.synchronize()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    trace = cuda_build.BUILD_DIR / f"launch_trace.{os.getpid()}.json"
    # a profiling run has been seen to keep fewer kernel records than
    # launches (none late in a long process, hence the child process of
    # launch_records); the calls are profiled again, with more host time
    # around them, until each launch is recorded
    tried = []
    for margin_s in (0.05, 0.5, 2.0):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(margin_s)
            for _ in range(calls):
                fn()
                torch.cuda.synchronize()
            time.sleep(margin_s)
        try:
            prof.export_chrome_trace(str(trace))
            events = json.loads(trace.read_text())["traceEvents"]
        finally:
            trace.unlink(missing_ok=True)
        kernels = [e for e in events if e.get("cat") == "kernel"]
        found = [e.get("args", {}) for e in kernels if kernel in e.get("name", "")]
        tried.append({"margin_s": margin_s, "recorded": len(found),
                      "kernels": sorted({e.get("name", "")[:60] for e in kernels})})
        if len(found) == calls:
            break
    check(len(found) == calls, f"{kernel}: launches recorded over {calls} calls: {tried}")
    check(all("grid" in a and "block" in a for a in found), f"{kernel}: the profiler records no grid or block")
    blocks = -(-n * group // threads)
    for a in found:
        check(list(a["block"]) == [threads, 1, 1] and list(a["grid"]) == [blocks, 1, 1],
              f"{kernel}: launched grid {a['grid']} block {a['block']}, the source says {blocks} blocks of {threads}")
    grid, block = found[0]["grid"], found[0]["block"]
    lanes = grid[0] * grid[1] * grid[2] * block[0] * block[1] * block[2]
    return {"grid": grid, "block": block, "threads": lanes, "lanes_per_column": lanes / n,
            "registers_per_thread": found[0].get("registers per thread")}


def measure_launches() -> dict:
    """``measured_launch`` of each vehicle kernel whose launch its source
    sizes by THREADS and GROUP (rows 1, 2, 4, 5, 6, 8, 9 and 10), at its
    main path's width and variant (row 1: modes 0 and 7; row 2: the
    recipe's mode 9, NED, per-env wind with gusts and noise; row 4: mode
    7), on a state fresh from its
    env's reset: a launch's grid, block and registers do not hang on the
    state's values."""
    import torch
    from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv
    from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
    from pyflyt_tpu_torch.models import fixedwing, rocket
    from pyflyt_tpu_torch.ops import cuda_dogfight as cd
    from pyflyt_tpu_torch.ops import cuda_fixedwing as cf
    from pyflyt_tpu_torch.ops import cuda_quadx as cq
    from pyflyt_tpu_torch.ops import cuda_rocket as cr

    g = torch.Generator(device="cuda").manual_seed(0)
    seed = torch.tensor([17], dtype=torch.int64, device="cuda")
    henv = PackedQuadXHoverEnv(base=QuadXHoverEnv(device="cuda"))
    hover = henv.reset(N_ENVS, g)[0].packed.contiguous()
    henv7 = hover7_env()
    hover7 = henv7.reset(N_ENVS, g)[0].packed.contiguous()
    genv = recipe_env()
    gpacked = genv.reset(N_ENVS, g)[0].packed.contiguous()
    wenv = wp_env(7)
    wpacked = wenv.reset(N_ENVS, g)[0].packed.contiguous()
    fenv = fw_env()
    fw = fenv.reset(FW_ENVS, g)[0].packed.contiguous()
    fcfg = fixedwing.FixedwingConfig()
    c5 = cf.fixedwing_consts(fixedwing.build_params(fcfg, "cuda"), fcfg)
    denv = df_env().penv
    df = denv.reset(DF_ARENAS, g)[0].packed.contiguous()
    renv = rk_env()
    rk = renv.reset(RK_ENVS, g)[0].packed.contiguous()
    rcfg = rocket.RocketConfig()
    c8 = cr.rocket_consts(rocket.build_params(rcfg, "cuda"), rcfg)
    calls = {
        "quadx_hover_step": (lambda: cq.packed_hover_step(hover, seed, henv.consts, 0, True), "hover_step_kernel",
                             "quadx_hover_step.cu", N_ENVS),
        "quadx_hover_step_mode7": (lambda: cq.packed_hover_step(hover7, seed, henv7.consts, 7, True),
                                   "hover_step_kernel", "quadx_hover_step.cu", N_ENVS),
        "quadx_step": (lambda: cq.packed_step(gpacked, seed, genv.consts, 9, True), "quadx_step_kernel",
                       "quadx_step.cu", N_ENVS),
        "quadx_waypoints_step": (lambda: cq.packed_waypoints_step(wpacked, seed, wenv.consts, 7, True),
                                 "waypoints_step_kernel", "quadx_waypoints_step.cu", N_ENVS),
        "fixedwing_step": (lambda: cf.packed_step(fw, seed, c5, 0, True), "step_kernel", "fixedwing_step.cu",
                           FW_ENVS),
        "fixedwing_waypoints_step": (lambda: cf.packed_waypoints_step(fw, seed, fenv.consts, 0, True),
                                     "waypoints_kernel", "fixedwing_step.cu", FW_ENVS),
        "dogfight_step": (lambda: cd.packed_dogfight_step(df, seed, denv.consts, True), "dogfight_kernel",
                          "dogfight_step.cu", df.shape[1]),
        "rocket_step": (lambda: cr.packed_step(rk, seed, c8, True), "rocket_kernel", "rocket_step.cu", RK_ENVS),
        "rocket_landing_step": (lambda: cr.packed_landing_step(rk, seed, renv.consts, True), "rocket_kernel",
                                "rocket_step.cu", RK_ENVS),
    }
    out = {"fused_epoch_general": general_epoch_kernels(), "general_resident": general_resident_kernels()}  # first:
    # profiles late in a process drop records
    out.update({name: measured_launch(fn, kernel, source, n) for name, (fn, kernel, source, n) in calls.items()})
    return out


def general_epoch_kernels() -> dict:
    """K2g's own CUDA kernels in one call of 4 minibatches of 8192 rows at
    the slice's 3 x 256 trunk, on its route (resident) and on the per-layer
    route forced at the same shapes, counted by torch.profiler against
    ``cuda_general.kernels_per_minibatch`` and ``kernels_per_call`` (in the
    launch records' child process: a profile late in the long run has been
    seen to keep fewer records than launches)."""
    from pyflyt_tpu_torch.ops import cuda_general, cuda_sgd

    inputs = epoch_inputs(general_net(0, 21, 4, GENERAL_TRUNK, GENERAL_TRUNK), 4, N_ENVS, None)
    check(cuda_general.epoch_route(inputs[-1]) == "resident", "K2g at the slice's trunk: the resident route")
    out = {}
    for route, run in (("resident", lambda: cuda_sgd.fused_epoch(*inputs)),
                       ("per_layer", lambda: cuda_general.launch_epoch(*inputs, route="per_layer"))):
        per_mb = cuda_general.kernels_per_minibatch(len(GENERAL_TRUNK), len(GENERAL_TRUNK), route)
        out[route] = {"cuda_kernels_per_minibatch": per_mb,
                      **epoch_kernel_count(run, 4, per_mb, cuda_general.kernels_per_call(route))}
    check(out["resident"]["cuda_kernels_per_minibatch"] <= 6, f"resident K2g: kernels a minibatch {out['resident']}")
    return out


def general_resident_kernels() -> dict:
    """The CUDA kernels of one K4g call (8192 rows) and one K3g call
    (262,144 rows) at the slice's 3 x 256 trunk on the resident route, and
    of each on the cluster route and on the per-layer route (forced) at the
    (1024,) trunk of ``other_trunks`` (256 and 4096 rows), counted by
    torch.profiler (in the launch records' child process): the resident
    and the cluster K4g one kernel and nothing else, the resident and the
    cluster K3g one kernel of its own beside its image build's, the
    per-layer K4g the obs rounded to bf16 and a GEMM a layer a trunk, the
    per-layer K3g the rounded obs and a GEMM a layer beside its log-prob
    kernel and its image build's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pyflyt_tpu_torch.ops import cuda_general, cuda_policy, cuda_sgd

    net = general_net(0, 21, 4, GENERAL_TRUNK, GENERAL_TRUNK)
    w = net.kernel_weights()
    obs = torch.randn((N_ENVS, 21), generator=torch.Generator().manual_seed(3)).cuda()
    rows = packed_rows(net, BATCH, seed=305)
    wide_net = general_net(0, 21, 4, (1024,), (1024,))
    wide_w = wide_net.kernel_weights()
    wide_obs, wide_rows = obs[:256].contiguous(), packed_rows(wide_net, 4096, seed=307)

    def count(fn, own: str) -> dict:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts = [(e.key, e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        return {"own": sum(c for k, c in counts if own in k), "other": sum(c for k, c in counts if own not in k)}

    wide_images = per_layer_images(wide_net)
    out = {"k4g": count(lambda: cuda_policy.policy_value_forward(obs, w), "resident_kernel"),
           "k3g": count(lambda: cuda_sgd.logp_forward(rows, pi_leaves(net), 21, vf_sizes=GENERAL_TRUNK),
                        "resident_kernel"),
           "k4g_cluster": count(lambda: cuda_policy.policy_value_forward(wide_obs, wide_w), "cluster_kernel"),
           "k3g_cluster": count(lambda: cuda_sgd.logp_forward(wide_rows, pi_leaves(wide_net), 21, vf_sizes=(1024,)),
                                "cluster_kernel"),
           "k4g_per_layer": count(lambda: cuda_general.forward_per_layer(wide_obs, wide_w, *wide_images), "general::"),
           "k3g_per_layer": count(lambda: cuda_general.logp_per_layer(wide_rows, pi_leaves(wide_net), 21),
                                  "general::")}
    check(out["k4g"] == {"own": 1, "other": 0}, f"resident K4g: CUDA kernels a call {out['k4g']}")
    check(out["k3g"]["own"] == 1, f"resident K3g: CUDA kernels a call {out['k3g']}")
    check(cuda_general.forward_route(wide_w) == "cluster" and out["k4g_cluster"] == {"own": 1, "other": 0},
          f"cluster K4g: CUDA kernels a call {out['k4g_cluster']}")
    check(cuda_general.logp_route(21, 4, (1024,)) == "cluster" and out["k3g_cluster"]["own"] == 1,
          f"cluster K3g: CUDA kernels a call {out['k3g_cluster']}")
    check(out["k4g_per_layer"] == {"own": 5, "other": 0}, f"per-layer K4g: CUDA kernels a call {out['k4g_per_layer']}")
    check(out["k3g_per_layer"]["own"] == 3, f"per-layer K3g: CUDA kernels a call {out['k3g_per_layer']}")
    return out


def launch_records() -> dict:
    """``measure_launches`` in a process of its own (this script with
    ``--launch-records``), on the libraries this run built: the profiler
    keeps fewer kernel records than launches once a process has launched
    many kernels, and late in a long run none at all."""
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--launch-records"], capture_output=True,
                       text=True, timeout=600, cwd=HERE)
    check(p.returncode == 0, f"launch records: rc {p.returncode}\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def time_df_kernel(packed) -> dict:
    """K7 at the league's shape (8192 drones, noise on): device time
    against the bound and its twin's time, and the ptxas report (summed,
    and registers per variant)."""
    import re

    import torch
    from pyflyt_tpu_torch.ops import cuda_build
    from pyflyt_tpu_torch.ops import cuda_dogfight as cd

    consts = df_env().penv.consts
    packed = packed.contiguous()
    seed = torch.tensor([17], dtype=torch.int64, device="cuda")
    ms, host_ms = time_ms(lambda: cd.packed_dogfight_step(packed, seed, consts, True), iters=200)
    plain, _ = time_ms(lambda: cd.packed_dogfight_step_plain(packed, seed, consts, True), iters=2, repeats=3,
                       device_timed=False)
    drones = packed.shape[1]
    rd, wr = cd.rows_moved()
    b_ms, by = bound_of((rd + wr) * 4 * drones + 8, drones * cd.ops_per_drone(consts), H100_F32_FLOPS)
    out = {"ms": ms, "host_ms": host_ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": by, "drones": drones,
           "rows_read": rd, "rows_written": wr, "ops_per_drone": cd.ops_per_drone(consts),
           "physics_iterations": consts.ratio * consts.inner_steps, "ptxas": ptxas_usage("dogfight_step.cu")}
    log = cuda_build.library_path("dogfight_step.cu").with_suffix(".log")
    variants = re.findall(r"entry function '_Z\w*?dogfight_kernelI(\w+?)EEv\w*'.*?Used (\d+) registers",
                          log.read_text() if log.exists() else "", re.S)
    out["ptxas_variants"] = [{"template": t, "registers": int(r)} for t, r in variants]
    print(json.dumps({"df_kernel_times": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 34-38: the rocket (K6)
# ---------------------------------------------------------------------------

RK_ENVS = 8192  # rocket_rl_r5h.py's num_envs (:85)
RK_STEPS = 30  # steps of the row-8 settle chains and the row-9 checks
RK_ROLLOUT_STEPS = 128  # the r5h recipe's rollout length
RK_TIMING_STEP = 32  # the rollout step whose state times rows 8 and 9: every lane airborne and live
RK_EVAL_EPISODES = 256  # make_landing_eval's 256 (rocket_rl_r5h.py:171)
RK_MIN_PAD_RATE = 0.90  # archive 0.945; its binomial sigma at 256 episodes is ~0.014
RK_POLICY = "rocket_landing_L0"
RK_ARCHIVE_LOG = "docs/artifacts/rocket_rl_r5h_tpu.jsonl"
RK_L0_ENV = dict(starting_fuel_ratio=0.02, ceiling=15.0, max_displacement=15.0, accelerate_drop=False)
RK_DIVERGED_SHARE = 4 / 64  # of a trap's lanes, as WP_DIVERGED_SHARE
RK_MIDWARP = 1001  # a width whose last warp holds one group of lanes (K6: 4 lanes an env, 8 envs a warp)
# row groups of the rocket layout for one aviary step against the twin, at
# tests/test_pallas_rocket.py:84-115's bounds (the finlet and drag-link
# velocities as the view)
RK_GROUPS = {"pos": (0, 3, 2e-4), "quat": (3, 7, 2e-5), "lin_vel": (7, 10, 2e-3), "ang_vel": (10, 13, 2e-3),
             "view": (13, 25, 2e-3), "local_vel": (25, 40, 2e-3), "actuation": (40, 44, 1e-6),
             "fuel": (44, 45, 1e-6), "throttle": (45, 46, 1e-6), "ignition": (46, 47, 0.0),
             "gimbal": (47, 49, 1e-6)}
# the traps of the row-9 checks, by env mod 16 (the rest fly free, burning)
RK_TRAPS = ("soft_complete", "hard_touchdown", "ground_hit", "below_ground", "displacement", "ceiling",
            "truncation", "frozen")
RK_LEG_Z = 2.425  # the landing legs' tips below the base origin (rocket.json)


def rk_env(**kw):
    from pyflyt_tpu_torch.envs import PackedRocketLandingEnv, RocketLandingEnv

    return PackedRocketLandingEnv(RocketLandingEnv(device="cuda", **kw))


def rk_airborne(n: int, seed: int, fuel=(0.3, 0.3), z=(30.0, 80.0)):
    """tests/test_pallas_rocket.py's states on the card: tilted, moving and
    spinning rockets, finlets, gimbal and throttle away from rest, a lit
    booster at 30-100% with finlets and gimbal swung (the setpoint)."""
    import torch
    from pyflyt_tpu_torch.models import rocket

    cfg = rocket.RocketConfig(noisy_boosters=False)
    params = rocket.build_params(cfg, "cuda")
    g = torch.Generator().manual_seed(seed)
    u = lambda lo, hi, *s: (lo + (hi - lo) * torch.rand(s, generator=g)).cuda()  # noqa: E731
    pos = u(-2.0, 2.0, n, 3)
    pos[:, 2] = u(z[0], z[1], n)
    st = rocket.init_state(params, cfg, pos, u(-0.3, 0.3, n, 3), u(-3.0, 3.0, n, 3), u(-0.5, 0.5, n, 3))
    st.booster.ratio_fuel_remaining = u(fuel[0], fuel[1], n, 1)
    st.booster.throttle = u(0.2, 0.8, n, 1)
    st.booster.ignition_state = torch.ones(n, 1, dtype=torch.bool, device="cuda")
    st.actuation = u(-0.5, 0.5, n, 4)
    st.gimbal_state = u(-0.5, 0.5, n, 1, 2)
    fuel_ratio = st.booster.ratio_fuel_remaining
    com = rocket.mass_properties(params, fuel_ratio * params.booster.total_fuel_mass,
                                 fuel_ratio[..., None] * params.booster.max_inertia)[1]
    st.read = rocket.update_state(st.body, params, cfg, com, st.physics_steps)
    sp = u(-1.0, 1.0, n, 7)
    sp[:, 3] = 1.0
    sp[:, 4] = u(0.3, 1.0, n)
    st.setpoint = sp
    return cfg, params, st


def rk_settle(n: int, seed: int, on_pad: bool):
    """Rockets upright or tilted by up to 0.05 rad, their legs between 1 cm
    in and 2 cm above the ground (or a pad under each at z = 0.1, off
    their centre by up to 1 m), drifting at up to 0.3 m/s, unlit."""
    import torch
    from pyflyt_tpu_torch.models import rocket
    from pyflyt_tpu_torch.ops import cuda_rocket as cr

    cfg = rocket.RocketConfig(noisy_boosters=False, starting_fuel_ratio=0.3)
    params = rocket.build_params(cfg, "cuda")
    g = torch.Generator().manual_seed(seed)
    u = lambda lo, hi, *s: (lo + (hi - lo) * torch.rand(s, generator=g)).cuda()  # noqa: E731
    pos = u(-50.0, 50.0, n, 3)
    ground = 0.15 if on_pad else 0.0
    pos[:, 2] = ground + RK_LEG_Z + u(-0.01, 0.02, n)
    orn = u(-0.05, 0.05, n, 3)
    vel = u(-0.3, 0.3, n, 3)
    vel[:, 2] = u(-1.0, 0.0, n)
    st = rocket.init_state(params, cfg, pos, orn, vel)
    packed = cr.pack_state(st)
    if on_pad:
        packed[cr._PADP : cr._PADP + 2] = pos[:, :2].T + u(-0.7, 0.7, 2, n)
        packed[cr._PADP + 2] = 0.1
    return cfg, params, packed


def rk_traps(st, env) -> dict:
    """Presets the traps on a reset ``RocketLandingState``, in place, by
    env mod 16 (tests/_rocket_reference.py's presets): legs 2 mm into the
    pad at rest (a soft touchdown that completes), 2 cm above the pad at 3
    m/s with a 3 m/s memo (hard), the same 6 m off the pad (a ground hit),
    over a pad sunk 5 m into a pit at 8 m/s (below ground, no contact),
    at the displacement bound and under the ceiling flying out, the step
    count at the time limit, done before the first step (the freeze).
    Returns the env columns of each trap."""
    import torch
    from pyflyt_tpu_torch.envs.base import tree_select
    from pyflyt_tpu_torch.models import rocket

    b = env.base
    n = st.reward.shape[0]
    idx = torch.arange(n, device="cuda")
    lanes = {name: idx[idx % 16 == k] for k, name in enumerate(RK_TRAPS)}
    pad = st.pad_position
    st.ang_vel, st.lin_vel = st.ang_vel.clone(), st.lin_vel.clone()  # the memos may view the drone's read
    pos = st.drone.read.view[:, 3].clone()
    orn = st.drone.read.view[:, 1].clone()
    vel = torch.zeros_like(pos)
    top = pad[:, 2] + 0.05
    for name, dz, dx, vz in (("soft_complete", -0.002, 0.0, 0.0), ("hard_touchdown", 0.02, 0.0, -3.0),
                             ("ground_hit", 0.02, 6.0, -3.0)):
        c = lanes[name]
        ground = top[c] if name != "ground_hit" else torch.zeros_like(top[c])
        pos[c] = torch.stack([pad[c, 0] + dx, pad[c, 1], ground + RK_LEG_Z + dz], dim=-1)
        vel[c, 2] = vz
        orn[c] = 0.0
    c = lanes["below_ground"]
    pad[c, 2] = -5.0
    pos[c] = torch.stack([pad[c, 0], pad[c, 1], torch.full_like(pad[c, 0], 0.1)], dim=-1)
    vel[c, 2] = -8.0
    orn[c] = 0.0
    c = lanes["displacement"]
    pos[c] = torch.tensor([b.max_displacement - 0.05, 0.0, 0.8 * b.ceiling], device="cuda")
    vel[c, 0] = 10.0
    c = lanes["ceiling"]
    pos[c] = torch.tensor([0.0, 0.0, b.ceiling - 0.05], device="cuda")
    vel[c, 2] = 10.0
    moved = torch.zeros(n, dtype=torch.bool, device="cuda")
    for name in RK_TRAPS[:6]:
        moved[lanes[name]] = True
    fresh = rocket.init_state(b.params, b.cfg, pos, orn, vel)
    st.drone = tree_select(moved, fresh, st.drone)
    for name in ("soft_complete", "hard_touchdown", "ground_hit", "below_ground"):
        st.ang_vel[lanes[name]] = 0.0
    st.lin_vel[lanes["soft_complete"]] = 0.0
    st.lin_vel[lanes["hard_touchdown"], 2] = -3.0
    st.lin_vel[lanes["ground_hit"], 2] = -3.0
    st.step_count[lanes["truncation"]] = b.max_steps + 1
    st.termination[lanes["frozen"]] = True
    st.fatal_collision[lanes["frozen"]] = True
    return lanes


def check_rk_step() -> tuple[dict, dict]:
    """Row 8 against its twin (noise off): one aviary step on 8192, a
    ragged 1000 and a mid-warp 1001 random airborne states with the
    booster lit, the finlets and gimbal swung, then with a fuel-out burn
    (0-20 ppm of fuel, most tanks dry within the step), the worst error
    per row group at the test
    bounds, the contact rows exact, the env rows zero and the pad rows
    kept. Then row 8's main path: RK_STEPS chained steps settling 8192
    rockets on the ground and 8192 on pads (the pad rows set), each step
    held against its twin from the same state, per lane (position 2e-3,
    velocities 5e-3, tests/test_pallas_rocket.py:213-248's bounds) with at
    most RK_DIVERGED_SHARE of the lanes beyond them (a contact point at
    zero depth flips the contact set), the flags of the rest exact; its
    launches counted from all kernels at zero. Then the noise: identical
    lit lanes, one noisy step, the throttle's relative spread against the
    twin's, and a second noisy call bit-identical to the first."""
    import torch
    from pyflyt_tpu_torch.models import rocket
    from pyflyt_tpu_torch.ops import cuda_rocket as cr

    out = {}
    zero = torch.zeros(1, dtype=torch.int64, device="cuda")
    for case, fuel in (("burn", (0.3, 0.3)), ("fuel_out", (0.0, 2e-5))):
        for n in (RK_ENVS, N_RAGGED, RK_MIDWARP):
            cfg, params, st = rk_airborne(n, seed=340 + n + len(case), fuel=fuel)
            c = cr.rocket_consts(params, cfg)
            packed = cr.pack_state(st)
            kern = cr.packed_step(packed, zero, c, False)
            plain = cr.packed_step_plain(packed, zero, c, False)
            torch.cuda.synchronize()
            where = f"rocket step {case} N={n}"
            check(bool(torch.isfinite(kern).all()), f"{where}: non-finite state")
            errs = {name: (kern[a:b] - plain[a:b]).abs().max().item() for name, (a, b, _) in RK_GROUPS.items()}
            bad = {k: v for k, v in errs.items() if v > RK_GROUPS[k][2]}
            check(not bad, f"{where}: beyond tolerance {bad}")
            check(torch.equal(kern[cr._CON : cr._TERM + 1], plain[cr._CON : cr._TERM + 1]), f"{where}: contact rows")
            check(not bool(kern[cr._TRUNC : cr._PADP].any()) and not bool(kern[cr._PFLAG :].any()),
                  f"{where}: env rows not zero")
            check(torch.equal(kern[cr._PADP : cr._PADP + 3], packed[cr._PADP : cr._PADP + 3]), f"{where}: pad rows")
            dry = int((kern[cr._FUEL] == 0.0).sum())
            check(case == "burn" or dry > n // 2, f"{where}: only {dry} tanks ran dry")
            out[f"{case}/N{n}"] = {"max_abs_err": max(errs.values()), "per_group": errs, "dry_tanks": dry}

    zero_launches()  # row 8's main path: the settle chains
    for case in ("ground", "pad"):
        cfg, params, packed = rk_settle(RK_ENVS, seed=350 + len(case), on_pad=case == "pad")
        c = cr.rocket_consts(params, cfg)
        err, diverged, touched = 0.0, 0, torch.zeros(RK_ENVS, dtype=torch.bool, device="cuda")
        flag_row = cr._RWD if case == "ground" else cr._TERM
        for i in range(RK_STEPS):
            plain = cr.packed_step_plain(packed, zero, c, False)
            packed = cr.packed_step(packed, zero, c, False)
            torch.cuda.synchronize()
            where = f"rocket settle on the {case} step {i}"
            check(bool(torch.isfinite(packed).all()), f"{where}: non-finite state")
            d = (packed - plain).abs()
            bad = ((d[cr._POS : cr._POS + 3].amax(0) > 2e-3) | (d[cr._LVEL : cr._AVEL + 3].amax(0) > 5e-3)
                   | (d[cr._CON : cr._TERM + 1].amax(0) > 0.0))
            diverged = max(diverged, int(bad.sum()))
            check(int(bad.sum()) <= RK_DIVERGED_SHARE * RK_ENVS, f"{where}: {int(bad.sum())} lanes diverged")
            err = max(err, d[:, ~bad].max().item())
            touched |= packed[flag_row] > 0.5
        check(not bool((packed[cr._TERM if case == "ground" else cr._RWD] > 0.5).any()), f"settle {case}: other flag")
        check(int(touched.sum()) > 0.99 * RK_ENVS, f"settle on the {case}: {int(touched.sum())} rockets touched")
        speed = packed[cr._LVEL : cr._LVEL + 3].norm(dim=0)
        out[f"settle_{case}"] = {"max_abs_err": err, "max_diverged_lanes": diverged, "touched": int(touched.sum()),
                                 "final_speed_median": float(speed.median())}
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "rocket_step": 2 * RK_STEPS}
    check(launches == want, f"rocket settle launches {launches}, expected {want}")

    cfg, params, st = rk_airborne(8, seed=359)
    c = cr.rocket_consts(params, rocket.RocketConfig())
    packed = cr.pack_state(st)[:, :1].expand(-1, RK_ENVS).contiguous()  # identical lanes
    seed = torch.tensor([2468], dtype=torch.int64, device="cuda")
    quiet = cr.packed_step(packed, seed, c, False)[cr._BTHR]
    noisy = cr.packed_step(packed, seed, c, True)
    check(torch.equal(noisy, cr.packed_step(packed, seed, c, True)), "noisy rocket step: two calls differ")
    rk = noisy[cr._BTHR] / quiet - 1.0
    rp = cr.packed_step_plain(packed, seed, c, True)[cr._BTHR] / quiet - 1.0
    torch.cuda.synchronize()
    se = float(rk.std()) * 6 / RK_ENVS**0.5
    check(float(rk.std()) > 0, "noisy rocket step: no spread")
    check(abs(float(rk.mean()) - float(rp.mean())) <= 2 * se, f"noisy rocket step: means {rk.mean()} {rp.mean()}")
    check(abs(float(rk.std()) / float(rp.std()) - 1.0) <= 0.1, f"noisy rocket step: std {rk.std()} vs {rp.std()}")
    out["noise"] = {"throttle_rel_std_kernel": float(rk.std()), "throttle_rel_std_plain": float(rp.std()),
                    "noise_ratio": c.b_noise}
    return out, launches


def check_rk_landing() -> dict:
    """Row 9 against its twin (noise off) over RK_STEPS agent steps in the
    L0 env (rocket_rl_r5h.py:90-93) at 8192, a ragged 1000 and a mid-warp
    1001 envs, from the env's reset with ``rk_traps``' presets, the free
    lanes burning with random finlets and gimbal; at the mid-warp width
    the free lanes 0-4 agent steps short of the time limit by their column
    mod 5, so envs of one warp freeze at different agent steps (checked).
    Per lane, the largest difference over the rows (the reward row
    relative to 1 + |reward|): at most
    RK_DIVERGED_SHARE of a trap's lanes beyond 5e-4 + 4e-4 * step, every
    trap firing; a frozen lane keeps every row but the setpoint, the
    re-armed reward and the step count. Then the noise, by the throttle's
    spread on identical lit lanes, and two noisy calls bit-identical."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_rocket as cr

    out = {}
    for n in (RK_ENVS, N_RAGGED, RK_MIDWARP):
        env = rk_env(noisy_boosters=False, **RK_L0_ENV)
        st, _ = env.base.reset(n, torch.Generator(device="cuda").manual_seed(360 + n))
        lanes = rk_traps(st, env)
        packed = env.pack_env_state(st)
        seed = torch.zeros(1, dtype=torch.int64, device="cuda")
        kern, plain = packed, packed.clone()
        g = torch.Generator().manual_seed(361)
        free = torch.ones(n, dtype=torch.bool, device="cuda")
        for cols in lanes.values():
            free[cols] = False
        groups = {**lanes, "free": free.nonzero().flatten()}
        if n == RK_MIDWARP:
            kern[cr._STEP, groups["free"]] = float(env.base.max_steps) - (groups["free"] % 5).float()
            plain[cr._STEP] = kern[cr._STEP]
        first_frozen = torch.full((n,), -1, dtype=torch.long, device="cuda")
        keep = torch.ones(cr.ROWS, dtype=torch.bool, device="cuda")
        keep[cr._SP : cr._SP + 7] = False
        keep[cr._RWD] = False
        keep[cr._STEP] = False
        err, diverged = 0.0, dict.fromkeys(groups, 0)
        ev = dict.fromkeys(RK_TRAPS, 0)
        first_rwd = None
        for i in range(RK_STEPS):
            a = (torch.rand(7, n, generator=g) * 0.8 - 0.4).cuda()
            a[3] = 1.0
            a[4] = (0.5 + 0.5 * torch.rand(n, generator=g)).cuda()
            a[:, ~free] = 0.0
            kern[cr._SP : cr._SP + 7] = a
            plain[cr._SP : cr._SP + 7] = a
            before = kern.clone()
            kern = cr.packed_landing_step(kern, seed, env.consts, False)
            plain = cr.packed_landing_step_plain(plain, seed, env.consts, False)
            torch.cuda.synchronize()
            where = f"rocket landing N={n} step {i}"
            check(bool(torch.isfinite(kern).all()), f"{where}: non-finite state")
            diff = (kern - plain).abs()
            diff[cr._RWD] = diff[cr._RWD] / (1.0 + plain[cr._RWD].abs())
            lane = diff.amax(0)
            bad = lane > 5e-4 + 4e-4 * i
            for name, cols in groups.items():
                nbad = int(bad[cols].sum())
                diverged[name] = max(diverged[name], nbad)
                check(nbad <= RK_DIVERGED_SHARE * len(cols), f"{where}: {nbad} of {len(cols)} {name} lanes diverged")
            err = max(err, lane[~bad].max().item())
            check(torch.equal(kern[cr._STEP], before[cr._STEP] + 1.0), f"{where}: step count")
            done0 = (before[cr._TERM] > 0.5) | (before[cr._TRUNC] > 0.5)
            check(torch.equal(kern[keep][:, done0], before[keep][:, done0]), f"{where}: a frozen lane moved")
            check(not bool(kern[cr._RWD, done0].any()), f"{where}: a frozen lane's reward")
            if first_rwd is None:
                first_rwd = kern[cr._RWD].clone()
            ev["frozen"] += int(done0[lanes["frozen"]].sum())
            first_frozen[done0 & (first_frozen < 0)] = i
        f = lambda row, name: int((kern[row, lanes[name]] > 0.5).sum())  # noqa: E731
        ev.update(soft_complete=min(f(cr._CPLT, "soft_complete"),
                                    int((first_rwd[lanes["soft_complete"]] > 500.0).sum())),
                  hard_touchdown=f(cr._FATC, "hard_touchdown"), ground_hit=f(cr._FATC, "ground_hit"),
                  below_ground=f(cr._FATC, "below_ground"), displacement=f(cr._OOB, "displacement"),
                  ceiling=f(cr._OOB, "ceiling"), truncation=f(cr._TRUNC, "truncation"))
        check(all(v > 0 for v in ev.values()), f"rocket landing N={n}: traps {ev}")
        out[f"N{n}"] = {"max_abs_err": err, "max_diverged_lanes": diverged, "events": ev,
                        "lanes_done": int(((kern[cr._TERM] > 0.5) | (kern[cr._TRUNC] > 0.5)).sum())}
        if n == RK_MIDWARP:  # warps (32 lanes, GROUP of them an env) whose envs froze at different steps
            per_warp = 32 // _source_const("rocket_step.cu", "GROUP")
            ff = first_frozen[: n - n % per_warp].view(-1, per_warp)
            mixed = int(((ff.amax(1) != ff.amin(1)) & (ff.amin(1) >= 0)).sum())
            check(mixed > 0, f"rocket landing N={n}: no warp froze at two agent steps")
            out[f"N{n}"]["warps_frozen_at_two_or_more_steps"] = mixed

    env = rk_env(**RK_L0_ENV)
    st, _ = env.reset(2, torch.Generator(device="cuda").manual_seed(362))
    packed = st.packed[:, :1].expand(-1, RK_ENVS).contiguous()  # identical lanes
    packed[cr._SP + 3] = 1.0  # lit at 60%
    packed[cr._SP + 4] = 0.6
    seed = torch.tensor([2468], dtype=torch.int64, device="cuda")
    quiet = cr.packed_landing_step(packed, seed, env.consts, False)[cr._BTHR]
    noisy = cr.packed_landing_step(packed, seed, env.consts, True)
    check(torch.equal(noisy, cr.packed_landing_step(packed, seed, env.consts, True)),
          "noisy rocket landing step: two calls differ")
    rk = noisy[cr._BTHR] / quiet - 1.0
    rp = cr.packed_landing_step_plain(packed, seed, env.consts, True)[cr._BTHR] / quiet - 1.0
    torch.cuda.synchronize()
    se = float(rk.std()) * 6 / RK_ENVS**0.5
    check(float(rk.std()) > 0, "noisy rocket landing step: no spread")
    check(abs(float(rk.mean()) - float(rp.mean())) <= 2 * se, f"noisy landing step: means {rk.mean()} {rp.mean()}")
    check(abs(float(rk.std()) / float(rp.std()) - 1.0) <= 0.1, f"noisy landing step: std {rk.std()} vs {rp.std()}")
    out["noise"] = {"throttle_rel_std_kernel": float(rk.std()), "throttle_rel_std_plain": float(rp.std()),
                    "noise_ratio": env.consts.b_noise}
    return out


def rk_rollout(net, seed: int, card: str):
    """The serving path: ``net`` (L0, obs 33) acting, sampled, through K4
    in 8192 stock PackedRocketLandingEnv() envs (noise on) for 4 warm-up
    and RK_ROLLOUT_STEPS timed steps, no resets: one row-9 and one K4
    launch per timed step, nothing else. Keeps the state of step RK_TIMING_STEP for the
    kernel times. Then the per-step split, each part on its own, and the
    device's busy share over 16 profiled steps."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_policy
    from pyflyt_tpu_torch.ops import cuda_rocket as cr
    from pyflyt_tpu_torch.rl import ppo

    env = rk_env()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    low, high = ppo.action_bounds(env, torch.device("cuda"))
    t0 = time.perf_counter()
    state, obs = env.reset(RK_ENVS, gen)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    for _ in range(4):  # warm-up
        state, out = env.step(state, torch.clamp(ppo.act(net, obs, gen, fused=True)[0], low, high))
        obs = out.obs
    torch.cuda.synchronize()
    zero_launches()
    rewards, timing_state = [], None
    t0 = time.perf_counter()
    for i in range(RK_ROLLOUT_STEPS):
        if i == RK_TIMING_STEP:
            timing_state = state.packed.clone()
        action, _, _ = ppo.act(net, obs, gen, fused=True)
        state, out = env.step(state, torch.clamp(action, low, high))
        obs = out.obs
        rewards.append(out.reward)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "rocket_landing_step": RK_ROLLOUT_STEPS,
            "policy_value_forward": RK_ROLLOUT_STEPS}
    check(launches == want, f"rocket rollout launches {launches}, expected {want}")
    rewards = torch.stack(rewards)
    check(obs.shape == (RK_ENVS, 33) and bool(torch.isfinite(obs).all()), "rocket rollout: final obs")
    check(bool(torch.isfinite(rewards).all()), "rocket rollout: non-finite rewards")
    done = out.termination | out.truncation

    w = net.kernel_weights()
    k4_ms, k4_host = time_ms(lambda: cuda_policy.policy_value_forward(obs, w), iters=200)
    packed = timing_state
    seed_t = torch.tensor([5], dtype=torch.int64, device="cuda")
    kernel_ms, kernel_host = time_ms(lambda: cr.packed_landing_step(packed, seed_t, env.consts, True), iters=200)
    obs_ms = host_wall_ms(lambda: env._obs(packed), iters=50)
    action = torch.zeros(RK_ENVS, 7, device="cuda")
    step_ms = host_wall_ms(lambda: env.step(state, action), iters=50)
    act_ms = host_wall_ms(lambda: ppo.act(net, obs, gen, fused=True), iters=50)

    def run16():
        s, o = state, obs
        for _ in range(16):
            a, _, _ = ppo.act(net, o, gen, fused=True)
            s, r = env.step(s, torch.clamp(a, low, high))
            o = r.obs

    prof = profiled(run16, "rk_rollout_profile_16_steps")
    zero_launches()  # the split's launches are not the main path's
    return {
        "card": card, "num_envs": RK_ENVS, "steps": RK_ROLLOUT_STEPS, "wall_s": wall,
        "env_steps_per_s": RK_ENVS * RK_ROLLOUT_STEPS / wall, "ms_per_step": 1e3 * wall / RK_ROLLOUT_STEPS,
        "reset_s": reset_s, "lanes_done": int(done.sum()),
        "fatal": int(out.info["fatal_collision"].sum()), "complete": int(out.info["env_complete"].sum()),
        "mean_reward": float(rewards.mean()), "launches": launches,
        "split_ms": {"k4_device": k4_ms, "k4_wrapper_host": k4_host, "act_total_host": act_ms,
                     "kernel_device": kernel_ms, "kernel_wrapper_host": kernel_host,
                     "obs_assembly_host": obs_ms, "env_step_total_host": step_ms},
        "profiled_16_steps": {"wall_ms": prof["wall_ms"], "device_busy_ms": prof["device_busy_ms"],
                              "device_busy_share": prof["device_busy_ms"] / prof["wall_ms"]},
    }, timing_state


def rk_archive_eval() -> dict:
    """The JAX package's 256-episode eval of the archived L0 params
    (rocket_rl_r5h_tpu.jsonl, stage L0)."""
    with open(os.path.join(HERE, RK_ARCHIVE_LOG)) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return next(r for r in rows if r.get("stage") == "L0")["eval_256_of_archived_params"]


def rk_eval(net, seed: int, card: str) -> dict:
    """The archived L0 policy flown deterministically (K4's mean, clipped)
    for RK_EVAL_EPISODES episodes in its env (noise on) for max_steps + 2
    steps with make_landing_eval's accounting (rocket_rl_r5h.py:98-146):
    complete, pad touch, fatal and the episode reward over the live steps;
    the touchdown speed is ``‖prev_lin_vel‖`` (rows _PLV) at the first pad
    flag. Fails under RK_MIN_PAD_RATE pad touches."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_policy
    from pyflyt_tpu_torch.ops import cuda_rocket as cr
    from pyflyt_tpu_torch.rl import ppo

    env = rk_env(**RK_L0_ENV)
    n = RK_EVAL_EPISODES
    low, high = ppo.action_bounds(env, torch.device("cuda"))
    w = net.kernel_weights()
    zero_launches()
    t0 = time.perf_counter()
    state, obs = env.reset(n, torch.Generator(device="cuda").manual_seed(seed + 999))
    z = lambda: torch.zeros(n, dtype=torch.bool, device="cuda")  # noqa: E731
    done, complete, pad, fatal = z(), z(), z(), z()
    ep_rew = torch.zeros(n, device="cuda")
    tspeed = torch.full((n,), -1.0, device="cuda")
    steps = env.max_steps + 2
    all_done_at = []  # the step after which every episode had ended (read at the end: no sync in the loop)
    for i in range(steps):
        mean, _ = cuda_policy.policy_value_forward(obs, w)
        state, out = env.step(state, torch.clamp(mean, low, high))
        live = ~done
        p = state.packed
        complete |= out.info["env_complete"] & live
        padn = (p[cr._PFLAG] > 0.5) & live
        tspeed = torch.where(padn & ~pad, p[cr._PLV : cr._PLV + 3].norm(dim=0), tspeed)
        pad |= padn
        fatal |= out.info["fatal_collision"] & live
        ep_rew += out.reward * live
        done |= out.termination | out.truncation
        all_done_at.append(done.all())
        obs = out.obs
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "rocket_landing_step": steps, "policy_value_forward": steps}
    check(launches == want, f"rocket eval launches {launches}, expected {want}")
    ts = tspeed[pad] if bool(pad.any()) else torch.tensor([-1.0], device="cuda")
    res = {
        "card": card, "episodes": n, "steps": steps, "wall_s": wall, "all_done": bool(done.all()),
        "steps_until_all_done": int(torch.stack(all_done_at).float().argmax()) + 1,
        "pad_rate": float(pad.float().mean()), "soft_rate": float((pad & ~fatal).float().mean()),
        "complete_rate": float(complete.float().mean()), "fatal_rate": float(fatal.float().mean()),
        "mean_ep_reward": float(ep_rew.mean()), "touchdown_speed_med": float(torch.quantile(ts, 0.5)),
        "touchdown_speed_p10": float(torch.quantile(ts, 0.1)), "archive": rk_archive_eval(),
        "policy": RK_POLICY, "launches": launches,
    }
    check(res["all_done"], "rocket eval: an episode did not end")
    check(res["pad_rate"] >= RK_MIN_PAD_RATE, f"rocket eval: pad rate {res['pad_rate']}")
    zero_launches()
    return res


def time_rk_kernels(packed) -> dict:
    """Rows 8 and 9 at the serving path's shape (8192 envs, noise on) on
    the rollout's state of step RK_TIMING_STEP, each against its bound, its
    twin's time and the ptxas report. The bound counts what this state
    needs: the script checks that every lane is live before and after the
    timed step and that no lane touches the ground, so every lane runs
    ``inner_steps`` airborne aviary steps (``cuda_rocket.ops_per_env``)."""
    import re

    import torch
    from pyflyt_tpu_torch.models import rocket
    from pyflyt_tpu_torch.ops import cuda_build
    from pyflyt_tpu_torch.ops import cuda_rocket as cr

    env = rk_env()
    c9 = env.consts
    cfg = rocket.RocketConfig()
    c8 = cr.rocket_consts(rocket.build_params(cfg, "cuda"), cfg)
    packed = packed.contiguous()
    seed = torch.tensor([17], dtype=torch.int64, device="cuda")
    after = cr.packed_landing_step(packed, seed, c9, True)
    live = lambda p: not bool(((p[cr._TERM] > 0.5) | (p[cr._TRUNC] > 0.5)).any())  # noqa: E731
    check(live(packed) and live(after), "rocket kernel times: a lane is done, so the bound's count is off")
    check(not bool((after[cr._CON] > 0.5).any() | (after[cr._PFLAG] > 0.5).any()), "rocket kernel times: a contact")
    out = {}
    for name, kernel, plain_fn, consts, landing in (
        ("rocket_step", cr.packed_step, cr.packed_step_plain, c8, False),
        ("rocket_landing_step", cr.packed_landing_step, cr.packed_landing_step_plain, c9, True),
    ):
        ms, host_ms = time_ms(lambda: kernel(packed, seed, consts, True), iters=200)
        plain, _ = time_ms(lambda: plain_fn(packed, seed, consts, True), iters=2, repeats=3, device_timed=False)
        rd, wr = cr.rows_moved(landing)
        b_ms, by = bound_of((rd + wr) * 4 * RK_ENVS + 8, RK_ENVS * cr.ops_per_env(consts, landing), H100_F32_FLOPS)
        out[name] = {"ms": ms, "host_ms": host_ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": by,
                     "rows_read": rd, "rows_written": wr, "ops_per_env": cr.ops_per_env(consts, landing),
                     "physics_iterations": consts.ratio * (consts.inner_steps if landing else 1)}
    out["ptxas"] = ptxas_usage("rocket_step.cu")
    log = cuda_build.library_path("rocket_step.cu").with_suffix(".log")
    variants = re.findall(r"entry function '_Z\w*?rocket_kernelI(\w+?)EEv\w*'.*?(\d+) bytes stack frame.*?"
                          r"Used (\d+) registers", log.read_text() if log.exists() else "", re.S)
    out["ptxas_variants"] = [{"template": t, "stack_bytes": int(s), "registers": int(r)} for t, s, r in variants]
    print(json.dumps({"rk_kernel_times": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 39: the narrow trunks' kernels (K4n, K3n, K2n) against their twins
# ---------------------------------------------------------------------------

TRAJ_TRUNK = (64, 64, 32, 32)  # the trajectory network's actor and critic (the reference's net_arch)
# trunks of the narrow family: the trajectory network, the mesh curves'
# (32, 32), one 128-wide layer, widths that pad (48, 24), a 4-deep funnel,
# and an actor and a critic that differ
NARROW_PAIRS = ((TRAJ_TRUNK, TRAJ_TRUNK), ((32, 32), (32, 32)), ((128,), (128,)), ((48, 24), (48, 24)),
                ((128, 64, 32, 16), (128, 64, 32, 16)), (TRAJ_TRUNK, (128, 16)))
NARROW_OBS = (16, 19, 21, 64)  # slow trajectory / mod-hovering, fast trajectory, hover, the widest
NARROW_ACT = (1, 4, 8)
# 16384 rows are 256 tiles, more than K4n's grid of one block an SM (132 on an
# H100), so its blocks step through a second tile
NARROW_ROWS = (64, 2048, N_ENVS, N_RAGGED, 16384)
TRAJ_ENVS = 2048  # the trajectory CLI's and the r4 slow recipe's num_envs
# K2n against its twin, two minibatches each: (pi, vf, obs, act, rows, log_std range): the r4 slow
# recipe's minibatch (2048 x 128 / 64), the fast CLI's (2048 x 32 / 32), the SMALL arm's (8192 x 128 /
# 64), then the other trunks, ragged minibatches and a clipping log_std range
NARROW_EPOCHS = ((TRAJ_TRUNK, TRAJ_TRUNK, 16, 4, 4096, None), (TRAJ_TRUNK, TRAJ_TRUNK, 19, 4, 2048, EPOCH_RANGE),
                 (TRAJ_TRUNK, TRAJ_TRUNK, 16, 4, 16384, None), ((32, 32), (32, 32), 21, 8, N_RAGGED, EPOCH_RANGE),
                 ((128,), (128,), 64, 1, 4096, None), (TRAJ_TRUNK, (128, 16), 33, 4, N_RAGGED, EPOCH_RANGE),
                 ((128, 64, 32, 16), (128, 64, 32, 16), 19, 4, 4096, EPOCH_RANGE),
                 ((48, 24), (48, 24), 16, 4, N_RAGGED, None))


def narrow_net(seed: int, obs: int, act: int, pi=TRAJ_TRUNK, vf=TRAJ_TRUNK, **kw):
    """A random actor-critic of the narrow family (no feature trunk)."""
    import torch
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    return ActorCritic(obs, act, feature_sizes=(), pi_sizes=pi, vf_sizes=vf, device="cuda",
                       generator=torch.Generator().manual_seed(seed), **kw)


def logp_atol(net, rows, log_std_range) -> float:
    """K3n's tolerance from the data: a mean moved by ``policy_atol``'s
    mean bound moves a row's log-prob by at most that times
    sum_j |a_j - mean_j| / var_j; never less than LOGP_ATOL."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_policy

    o, a = net.obs_dim, net.action_dim
    mean, _ = cuda_policy.policy_value_forward_plain(rows[:, :o].contiguous(), net.kernel_weights())
    ls = net.log_std.detach()
    if log_std_range is not None:
        ls = torch.clamp(ls, *log_std_range)
    scale = ((rows[:, o : o + a] - mean).abs() / torch.exp(2.0 * ls)).sum(1).max().item()
    return max(LOGP_ATOL, policy_atol(net)[0] * scale)


def check_narrow_grid(seed: int) -> dict:
    """K4n over every trunk pair x obs x action width x row count of the
    grid at ``policy_atol``, and K3n (the actor) at every row count with
    and without a log_std range; each launch counted. Then K3n at its main
    paths' batches, where each of its 4 x SM-count blocks steps through many
    tiles: the SMALL arm's 1,048,576 rows (obs 16, act 4, the reference
    network); phase 40 adds the r4 slow recipe's batch on the archived
    policy."""
    from pyflyt_tpu_torch.ops import cuda_narrow

    worst = {"mean": 0.0, "value": 0.0, "logp": 0.0}
    fwd0, logp0 = cuda_narrow.FORWARD_KERNEL.launches, cuda_narrow.LOGP_KERNEL.launches
    cases = 0
    for pi, vf in NARROW_PAIRS:
        for o in NARROW_OBS:
            for a in NARROW_ACT:
                net = narrow_net(seed + 100 * o + a + 7 * len(pi) + len(vf), o, a, pi, vf)
                atol = policy_atol(net)
                for n in NARROW_ROWS:
                    e_m, e_v = check_policy(net, n, atol)
                    worst["mean"], worst["value"] = max(worst["mean"], e_m), max(worst["value"], e_v)
                    cases += 1
                    if pi == vf:
                        worst["logp"] = max(worst["logp"], check_logp(net, n, atol=logp_atol))
    small = check_logp(narrow_net(seed + 16, 16, 4), K3_WIDE_ROWS, atol=logp_atol)
    worst["logp"] = max(worst["logp"], small)
    launches = {"narrow_policy_value_forward": cuda_narrow.FORWARD_KERNEL.launches - fwd0,
                "narrow_logp_forward": cuda_narrow.LOGP_KERNEL.launches - logp0}
    check(launches["narrow_policy_value_forward"] == cases, f"narrow grid: K4n launches {launches}, expected {cases}")
    return {"cases": cases, "trunks": NARROW_PAIRS, "obs": NARROW_OBS, "act": NARROW_ACT, "rows": NARROW_ROWS,
            "max_mean_err": worst["mean"], "max_value_err": worst["value"], "max_logp_err": worst["logp"],
            "logp_small_arm_rows_1048576": small, "launches": launches}


def check_narrow_epoch_repeat(net, n_mb: int, mb: int) -> dict:
    """Two K2n calls on the same inputs give bit-identical parameters,
    moments and metrics, and the images its last Adam step wrote are
    ``cuda_narrow.pack_trunk`` of the returned leaves, byte for byte."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_narrow

    inputs = epoch_inputs(net, n_mb, mb)
    (a, images), (b, _) = cuda_narrow.launch_epoch(*inputs), cuda_narrow.launch_epoch(*inputs)
    pi, vf = cuda_narrow.trunk_leaves(a[0], len(net.pi_trunk.layers), len(net.vf_trunk.layers))
    want = torch.zeros_like(images)
    for row, trunk in zip(want, (pi, vf)):
        img = cuda_narrow.pack_trunk(*trunk)
        row[: img.numel()] = img
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip([*a[0], *a[1], *a[2], a[3]], [*b[0], *b[1], *b[2], b[3]]))
    check(same, f"narrow epoch {n_mb}x{mb}: two calls on the same inputs differ")
    mismatched = int((images != want).sum())
    check(mismatched == 0, f"narrow epoch {n_mb}x{mb}: {mismatched} image bytes differ from pack_trunk")
    return {"n_mb": n_mb, "mb": mb, "bit_identical": same, "image_bytes": int(images.numel()),
            "image_bytes_differing": mismatched}


def check_narrow_epochs(seed: int) -> dict:
    """K2n against its twin at ``NARROW_EPOCHS`` (two minibatches each, at
    K2's epoch tolerance), then its repeat at the r4 slow recipe's shape."""
    from pyflyt_tpu_torch.ops import cuda_narrow

    launches0 = cuda_narrow.EPOCH_KERNEL.launches
    checks = []
    for pi, vf, o, a, mb, rng in NARROW_EPOCHS:
        c = check_epoch(narrow_net(seed + 1000 + o + mb, o, a, pi, vf), 2, mb, rng)
        checks.append({**c, "pi": pi, "vf": vf})
    check(cuda_narrow.EPOCH_KERNEL.launches - launches0 == len(NARROW_EPOCHS), "narrow epochs: K2n not launched")
    repeat = check_narrow_epoch_repeat(narrow_net(seed + 2000, 16, 4), 4, 4096)
    return {"checks": checks, "repeat": repeat, "max_abs_err": max(c["max_abs_err"] for c in checks),
            "max_mu_rel_err": max(c["mu_rel_err"] for c in checks),
            "max_nu_rel_err": max(c["nu_rel_err"] for c in checks)}


def time_narrow_kernels(net, obs, rows, mbs_cfg) -> dict:
    """K4n on ``obs``, K3n on the PPO batch ``rows`` and K2n over one epoch
    (``mbs_cfg`` = (num_minibatches, minibatch_size, PPOConfig)) at the
    trajectory network: device time, host time, the plain twin, the
    library yardstick and the bound."""
    from pyflyt_tpu_torch.ops import cuda_narrow, cuda_sgd

    bound = lambda b, f: (1e3 * max(b / H100_BYTES_PER_S, f / H100_BF16_FLOPS),  # noqa: E731
                          "bytes" if b / H100_BYTES_PER_S >= f / H100_BF16_FLOPS else "operations")
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    o, a = net.obs_dim, net.action_dim
    pi, vf = trunk_sizes(net.pi_trunk), trunk_sizes(net.vf_trunk)
    out = {"narrow_policy_value_forward": time_policy_forward(net, obs, lib_iters=20)}  # ~21 launches a call

    batch = rows.shape[0]
    pl_ = pi_leaves(net)
    # the wrapper packs the actor's image on each call: ~18 launches a call,
    # the library chain ~20; 20 calls stay under the ~1000 a stream holds
    ms, host = time_ms(lambda: cuda_sgd.logp_forward(rows, pl_, o, vf_sizes=vf), iters=20)
    plain, _ = time_ms(lambda: cuda_sgd.logp_forward_plain(rows, pl_, o), iters=3, repeats=3, device_timed=False)
    lib, _ = time_ms(library_logp(net, rows), iters=20)
    b_ms, by = bound(nbytes([rows, *pl_]) + batch * 4, cuda_sgd.logp_flops(batch, o, a, sizes=pi))
    # the kernel alone on an image packed once, and the pack alone
    n_pi = len(pi)
    pack = lambda: cuda_narrow.pack_trunk(pl_[:2 * n_pi:2], pl_[1:2 * n_pi:2], pl_[2 * n_pi],  # noqa: E731
                                          pl_[2 * n_pi + 1])
    image, lay = pack(), cuda_narrow.layout(o, pi, a)
    kernel, _ = time_ms(lambda: cuda_narrow.launch_logp(rows, image, lay, pl_[-1], o), iters=100)
    pack_ms, _ = time_ms(pack, iters=40)
    out["narrow_logp_forward"] = {"ms": ms, "host_ms": host, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                                  "bound_by": by, "rows": batch, "kernel_ms": kernel, "pack_ms": pack_ms}

    n_mb, mb, cfg = mbs_cfg
    mbs = packed_rows(net, n_mb * mb, seed=301).reshape(n_mb, mb, -1)
    stats = adv_stats(mbs[:, :, o + a + 1])
    inputs = epoch_inputs(net, n_mb, mb, cfg.log_std_range)
    _, _, t0, leaves, mu, nu, _ = inputs
    ecfg = cuda_sgd.EpochConfig(o, a, pi, vf, cfg.learning_rate, cfg.clip_eps, cfg.entropy_coef, cfg.value_coef,
                                cfg.max_grad_norm, cfg.log_std_range)
    run = lambda: cuda_sgd.fused_epoch(mbs, stats, t0, leaves, mu, nu, ecfg)  # noqa: E731
    ms, host = time_ms(run, iters=max(1, 192 // (cuda_narrow.KERNELS_PER_MINIBATCH * n_mb)), repeats=3)
    plain, _ = time_ms(lambda: cuda_sgd.fused_epoch_plain(mbs, stats, t0, leaves, mu, nu, ecfg), iters=1, repeats=2,
                       device_timed=False)
    lib_fn = library_update(net, mbs[0], stats[0], cfg)
    lib_mb = profiled_device_ms(lib_fn, iters=8)
    lib_wall = host_wall_ms(lib_fn, iters=8)
    state = nbytes(leaves) + nbytes(mu) + nbytes(nu)
    b_ms, by = bound(nbytes([mbs, stats, t0]) + 2 * state + n_mb * 5 * 4,
                     cuda_sgd.epoch_flops(n_mb * mb, o, a, pi_sizes=pi, vf_sizes=vf))
    out["fused_epoch_narrow"] = {
        "ms": ms, "host_ms": host, "ms_per_minibatch": ms / n_mb, "plain_ms": plain,
        "library_ms": lib_mb * n_mb, "library_ms_per_minibatch": lib_mb,
        "library_ms_source": "torch.profiler kernel time", "library_host_wall_ms_per_minibatch": lib_wall,
        "bound_ms": b_ms, "bound_by": by, "minibatches": n_mb, "minibatch_size": mb,
        **epoch_kernel_count(run, n_mb, cuda_narrow.KERNELS_PER_MINIBATCH, cuda_narrow.KERNELS_PER_CALL),
    }
    return out


# ---------------------------------------------------------------------------
# phases 40-44: trajectory following on the narrow kernels
# ---------------------------------------------------------------------------

TRAJ_POLICY = "traj_slow_r4_seed0"
TRAJ_ARCHIVE_LOG = "docs/artifacts/traj_slow_stable_tpu.jsonl"
TRAJ_ARCHIVE_EPISODES = 32  # the archive's independent eval (traj_slow_stable_r4.py:103)
TRAJ_EVAL_EPISODES = 256
TRAJ_ROLLOUT_STEPS = 128
# the r4 campaign's slow env and recipe (docs/artifacts/traj_slow_stable_r4.py:55-59, 120-123)
TRAJ_R4_ENV = dict(flight_mode=9, control_hz=80, simulate_wind=True, noisy_motors=True, flight_dome_size=100,
                   max_duration_seconds=10.0)
TRAJ_ARCH = dict(feature_sizes=(), pi_sizes=TRAJ_TRUNK, vf_sizes=TRAJ_TRUNK)


def traj_r4_config(**kw):
    """The r4 slow recipe (traj_slow_stable_r4.py:56-59) on the reference
    network; ``num_envs`` 8192 with the mod-hovering env is ppo_20m_r4.py's
    SMALL arm (:66-77)."""
    from pyflyt_tpu_torch.rl import PPOConfig

    return PPOConfig(**{**dict(num_envs=TRAJ_ENVS, rollout_steps=128, num_epochs=10, num_minibatches=64,
                               learning_rate=1e-4, clip_eps=0.1, init_log_std=-1.6), **TRAJ_ARCH, **kw})


def traj_archive_eval() -> dict:
    """The JAX package's independent 32-episode eval of the archived slow
    policy (traj_slow_stable_tpu.jsonl, stage E-seed0, the winning
    best_raw checkpoint)."""
    with open(os.path.join(HERE, TRAJ_ARCHIVE_LOG)) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return next(r for r in rows if r.get("stage") == "E-seed0")["independent_eval_32ep"]["best_raw"]


def traj_floors(archive: dict) -> dict:
    """Floors on the card's 256-episode means: the archive's mean less three
    standard errors of the difference of two means, the archive's standard
    deviation standing for both (32 and 256 episodes)."""
    se = math.sqrt(1.0 / TRAJ_ARCHIVE_EPISODES + 1.0 / TRAJ_EVAL_EPISODES)
    return {"mean_length": archive["mean_length"] - 3.0 * archive["std_length"] * se,
            "mean_reward": archive["mean_reward"] - 3.0 * archive["std_reward"] * se}


def traj_slow_env():
    from pyflyt_tpu_torch.envs.quadx_mod import QuadXTrajectoryFollowingSlowEnv

    return QuadXTrajectoryFollowingSlowEnv(device="cuda", **TRAJ_R4_ENV)


def traj_serving(net, seed: int, card: str):
    """The archived slow policy acting (sampled, through K4n) in TRAJ_ENVS
    r4 slow envs under the exact auto-reset for TRAJ_ROLLOUT_STEPS steps,
    one K4n launch per step and nothing else; then the same env stepped
    alone and with its whole-batch reset, for the reset's share."""
    import torch
    from pyflyt_tpu_torch.rl import ppo

    env = traj_slow_env()
    gen = torch.Generator(device="cuda").manual_seed(seed + 40)
    ars, obs = ppo.env_init(env, TRAJ_ENVS, gen, 0)
    ars, obs, _ = ppo.rollout(net, env, ars, obs, 4, gen, refresh=0)  # warm-up
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    ars, obs, traj = ppo.rollout(net, env, ars, obs, TRAJ_ROLLOUT_STEPS, gen, refresh=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "narrow_policy_value_forward": TRAJ_ROLLOUT_STEPS}
    check(launches == want, f"trajectory serving launches {launches}, expected {want}")
    check(bool(torch.isfinite(traj.reward).all() and torch.isfinite(traj.value).all()), "trajectory serving: non-finite")
    action = torch.zeros((TRAJ_ENVS, 4), device="cuda")
    step_ms = host_wall_ms(lambda: env.step(ars, action), iters=20)
    reset_ms = host_wall_ms(lambda: env.reset(TRAJ_ENVS, gen), iters=20)
    auto_ms = host_wall_ms(lambda: env.autoreset_step(ars, action), iters=20)
    fwd_ms = host_wall_ms(lambda: ppo.act(net, obs, gen), iters=20)
    zero_launches()
    return {"card": card, "num_envs": TRAJ_ENVS, "steps": TRAJ_ROLLOUT_STEPS, "wall_s": wall,
            "env_steps_per_s": TRAJ_ENVS * TRAJ_ROLLOUT_STEPS / wall, "ms_per_step": 1e3 * wall / TRAJ_ROLLOUT_STEPS,
            "episodes_done": int(traj.done.sum()), "mean_reward": float(traj.reward.mean()), "launches": launches,
            "split_ms": {"env_step": step_ms, "env_reset": reset_ms, "autoreset_step": auto_ms, "act_k4n": fwd_ms},
            "reset_share_of_autoreset_step": (auto_ms - step_ms) / auto_ms}, obs


def traj_eval(net, seed: int, card: str) -> dict:
    """The archived slow policy flown deterministically (K4n's mean,
    clipped) for TRAJ_EVAL_EPISODES fresh r4 slow episodes (noise and
    gusts on) for max_steps + 2 steps, as ``PPO.evaluate`` counts them;
    fails under ``traj_floors`` of the archive's eval."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_policy
    from pyflyt_tpu_torch.rl import ppo

    env = traj_slow_env()
    n = TRAJ_EVAL_EPISODES
    low, high = ppo.action_bounds(env, torch.device("cuda"))
    w = net.kernel_weights()
    zero_launches()
    t0 = time.perf_counter()
    state, obs = env.reset(n, torch.Generator(device="cuda").manual_seed(seed + 1234))
    zeros = lambda: torch.zeros(n, device="cuda")  # noqa: E731
    done, ep_rew, ep_len = zeros(), zeros(), zeros()
    steps = env.max_steps + 2
    for _ in range(steps):
        mean, _ = cuda_policy.policy_value_forward(obs, w)
        state, out = env.step(state, torch.clamp(mean, low, high))
        ep_rew += out.reward * (1.0 - done)
        ep_len += 1.0 - done
        done = torch.maximum(done, (out.termination | out.truncation).float())
        obs = out.obs
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "narrow_policy_value_forward": steps}
    check(launches == want, f"trajectory eval launches {launches}, expected {want}")
    archive = traj_archive_eval()
    floors = traj_floors(archive)
    std = lambda x: float(x.std(correction=0))  # noqa: E731
    res = {"card": card, "episodes": n, "steps": steps, "wall_s": wall, "all_done": bool(done.all()),
           "mean_length": float(ep_len.mean()), "std_length": std(ep_len), "mean_reward": float(ep_rew.mean()),
           "std_reward": std(ep_rew), "targets_reached_mean": float(state.current_target_index.float().mean()),
           "archive": archive, "floors": floors, "policy": TRAJ_POLICY, "launches": launches}
    check(res["all_done"], "trajectory eval: an episode did not end")
    check(res["mean_length"] >= floors["mean_length"], f"trajectory eval: mean length {res['mean_length']} "
                                                        f"under its floor {floors['mean_length']}")
    check(res["mean_reward"] >= floors["mean_reward"], f"trajectory eval: mean reward {res['mean_reward']} "
                                                        f"under its floor {floors['mean_reward']}")
    zero_launches()
    return res


def timed_iterations(tp, want: dict, label: str, seed: int, card: str, warm_up: bool = True) -> tuple[dict, object]:
    """A warm-up and a timed, split iteration of ``tp`` from a fresh
    runner (the timed one alone without ``warm_up``), each with its
    launches held to ``want`` (the rest 0) and Adam's count to epochs x
    minibatches."""
    import torch

    cfg = tp.config
    t0 = time.perf_counter()
    runner = tp.init(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rows = []
    for it in range(2 if warm_up else 1):
        count0 = int(runner.opt_state.count)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner, metrics, split = run_iteration(tp, runner, split=it == 1 or not warm_up)
        wall = time.perf_counter() - t0
        launches = read_launches()
        full = {**dict.fromkeys(launches, 0), **want}
        check(launches == full, f"{label} iteration {it}: launches {launches}, expected {full}")
        check(int(runner.opt_state.count) - count0 == cfg.num_epochs * cfg.num_minibatches,
              f"{label} iteration {it}: Adam count")
        check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"{label} iteration {it}: metrics")
        rows.append({"wall_s": wall, "split_s": split, "launches": launches,
                     "metrics": {k: float(v) for k, v in metrics.items()}})
    check(all(bool(torch.isfinite(p).all()) for p in runner.network.parameters()), f"{label}: non-finite params")
    zero_launches()
    wall = rows[-1]["wall_s"]
    return {"card": card, "num_envs": cfg.num_envs, "rollout_steps": cfg.rollout_steps, "batch": cfg.batch_size,
            "epochs": cfg.num_epochs, "minibatches": cfg.num_minibatches, "minibatch_size": cfg.minibatch_size,
            "fused_sgd": cfg.fused_sgd, "fused_rollout_forward": cfg.fused_rollout_forward, "init_s": init_s,
            "warmup_s": rows[0]["wall_s"], "wall_s": wall, "samples_per_s": cfg.batch_size / wall,
            "split_s": rows[-1]["split_s"], "launches_per_iteration": rows[-1]["launches"],
            "metrics": rows[-1]["metrics"]}, runner


def traj_train(seed: int, card: str) -> dict:
    """(a) The JAX CLI's ``train`` defaults on the fast env (2048 envs, 32
    steps, 15 epochs x 32 minibatches, the f32 path: nothing launches);
    (b) the r4 slow recipe with the fused rollout forward and fused_sgd
    (K4n a step, K3n once, K2n an epoch)."""
    from pyflyt_tpu_torch.envs.quadx_mod import QuadXTrajectoryFollowingFastEnv
    from pyflyt_tpu_torch.rl import PPO, PPOConfig

    fast = PPO(QuadXTrajectoryFollowingFastEnv(device="cuda"), PPOConfig(num_envs=TRAJ_ENVS, **TRAJ_ARCH))
    a, _ = timed_iterations(fast, {}, "trajectory fast CLI defaults", seed, card)
    cfg = traj_r4_config(fused_rollout_forward=True, fused_sgd=True)
    slow = PPO(traj_slow_env(), cfg)
    b, runner = timed_iterations(slow, {"narrow_policy_value_forward": cfg.rollout_steps, "narrow_logp_forward": 1,
                                        "fused_epoch_narrow": cfg.num_epochs}, "trajectory r4 slow recipe", seed, card)
    return {"fast_cli_defaults": a, "r4_slow_fused": b, "other_trunks": other_trunks(seed, card)}, slow, runner


def other_trunks(seed: int, card: str) -> dict:
    """The fused PPO path on the mesh curves' (32, 32) and on (128,) (the
    narrow family's), on (256,) (the general family's resident route), on
    (1024,) (K4g and K3g on its cluster route, K2g per layer) and on
    (4128,) (past a cluster of 8: every kernel per layer), 256 r4 slow envs
    x 16 steps, 2 epochs x 4 minibatches."""
    from pyflyt_tpu_torch.rl import PPO

    names = {"narrow": ("narrow_policy_value_forward", "narrow_logp_forward", "fused_epoch_narrow"),
             "resident": ("general_resident_forward", "general_resident_logp", "general_resident_epoch"),
             "cluster": ("general_cluster_forward", "general_cluster_logp", "fused_epoch_general"),
             "per_layer": ("general_policy_value_forward", "general_logp_forward", "fused_epoch_general")}
    out = {}
    for sizes, kind in (((32, 32), "narrow"), ((128,), "narrow"), ((256,), "resident"), ((1024,), "cluster"),
                        (GENERAL_PAST, "per_layer")):
        cfg = traj_r4_config(num_envs=256, rollout_steps=16, num_epochs=2, num_minibatches=4, pi_sizes=sizes,
                             vf_sizes=sizes, fused_rollout_forward=True, fused_sgd=True)
        fwd, logp, epoch = names[kind]
        res, runner = timed_iterations(PPO(traj_slow_env(), cfg), {fwd: cfg.rollout_steps, logp: 1, epoch: 2},
                                       f"trunk {sizes}", seed, card)
        out[str(sizes)] = {k: res[k] for k in ("wall_s", "samples_per_s", "launches_per_iteration")}
        out[str(sizes)]["shapes"] = {"obs_dim": runner.network.obs_dim, "act_dim": runner.network.action_dim,
                                     "sizes": sizes, "forward_rows": cfg.num_envs, "logp_rows": cfg.batch_size,
                                     "minibatches": cfg.num_minibatches}
    return out


def small_arm_train(seed: int, card: str) -> dict:
    """ppo_20m_r4.py's SMALL fused arm: 8192 PackedQuadXModHoveringEnv
    (mode 9, NED, 80 Hz, wind) under the exact auto-reset, the reference
    network, fused_sgd (the rollout's forward f32, as the JAX arm's): row 2
    a step, K3n once, K2n an epoch."""
    from pyflyt_tpu_torch.rl import PPO

    cfg = traj_r4_config(num_envs=N_ENVS, fused_sgd=True)
    res, _ = timed_iterations(PPO(recipe_env(), cfg), {"quadx_step": cfg.rollout_steps, "narrow_logp_forward": 1,
                                                      "fused_epoch_narrow": cfg.num_epochs}, "SMALL arm", seed, card)
    return res


# ---------------------------------------------------------------------------
# phases 45-50: vision (the ray-cast camera, QuadX-Gates, VisionActorCritic)
# ---------------------------------------------------------------------------


GATES_ENVS = 256  # the r4 recipe's num_envs (docs/artifacts/gates_vision_r4.py)
GATES_RES = 32  # its camera; the env's default is 128
RENDER_EDGE_SHARE = 0.005  # of the pixels: f32 rounding of a ray flips a pixel across an edge
RENDER_DEPTH_ATOL = 1e-5  # where the segmentation agrees
# the card's f32 convs (cuDNN, TF32 off) and matmuls against the CPU's sum
# in other orders: 1e-5 of the output's scale (at least 1)
NET_REL = 1e-5
NET_ROWS = (GATES_ENVS, 4096)
GATES_POLICY = "gates_vision_r4"
GATES_ARCHIVE_LOG = "docs/artifacts/policies_gates_vision_r4/metrics.jsonl"
GATES_ARCHIVE_UPDATE = 800  # best_model_800_149_25_485_2
GATES_JAX_EVAL = "docs/artifacts/gates_vision_r4_jax_cpu_eval.json"  # gates_vision_r4_reference.py eval
GATES_EVAL_EPISODES = 256
GATES_R4 = dict(num_envs=GATES_ENVS, rollout_steps=128, num_epochs=4, num_minibatches=8, learning_rate=3e-4,
                clip_eps=0.2, init_log_std=-0.5)  # gates_vision_r4.py's PPOConfig
GATES_R4_NET = dict(conv_features=(16, 32, 32), feature_sizes=(128,), init_log_std=-0.5)
# f32 operations of one ray against one box in core/camera._ray_box and the
# rotation before it: the ray into the box frame (9 mul, 6 add), its
# guarded reciprocal (3 compares, 3 selects, 3 divides), the two slab
# planes (6 mul, 6 sub shared per box), min/max of each pair (6), the
# entry/exit reductions (4), the hit test and pick (5) and the running
# nearest hit (3); a holed box adds the hole's 2D slab (4 mul, 4 min/max,
# 2 reductions, 2 selects) and the two sub-intervals' tests (14)
RAY_BOX_OPS = 9 + 6 + 9 + 6 + 6 + 4 + 5 + 3
RAY_HOLED_BOX_OPS = RAY_BOX_OPS + 12 + 14
RENDER_BYTES_PER_PIXEL = 4 + 4 + 4  # rgba bytes, f32 depth, int32 segment written


def gates_env(res: int = GATES_RES, **kw):
    from pyflyt_tpu_torch.envs.quadx_gates import QuadXGatesEnv

    return QuadXGatesEnv(device="cuda", camera_resolution=(res, res), **kw)


def gates_archive() -> dict:
    """The archive's own 8-episode eval of the checkpoint the npz holds."""
    with open(os.path.join(HERE, GATES_ARCHIVE_LOG)) as f:
        row = next(r for r in map(json.loads, f) if r.get("update") == GATES_ARCHIVE_UPDATE)
    return {k: row[f"eval_{k}"] for k in ("mean_reward", "std_reward", "mean_length", "std_length")} | {"episodes": 8}


def gates_jax_eval() -> dict:
    """The JAX package's 256-episode CPU eval of the same policy (written
    once by docs/artifacts/gates_vision_r4_reference.py eval)."""
    with open(os.path.join(HERE, GATES_JAX_EVAL)) as f:
        return json.load(f)


def edge_flips(j_rgba, t_rgba, j_seg, t_seg) -> tuple[float, int]:
    """(share of the pixels whose bytes or segment differ, how many of
    those have no 8-neighbour of another label in the reference image)."""
    import numpy as np

    pack = np.array([1 << 24, 1 << 16, 1 << 8, 1], dtype=np.int64)
    lab_j = (j_seg.astype(np.int64) + 2) << 32 | j_rgba.astype(np.int64) @ pack
    lab_t = (t_seg.astype(np.int64) + 2) << 32 | t_rgba.astype(np.int64) @ pack
    diff = lab_j != lab_t
    padded = np.pad(lab_j, ((0, 0), (1, 1), (1, 1)), mode="edge")
    h, w = lab_j.shape[-2:]
    edge = np.zeros_like(diff)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            edge |= padded[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] != lab_j
    return float(diff.mean()), int((diff & ~edge).sum())


def gates_views(n: int, seed: int):
    """``n`` r4 gates-env resets on the card, each drone turned to face its
    first gate (so the gates fill part of the frame): (positions, eulers,
    the gates' render boxes)."""
    import torch

    env = gates_env()
    st, _ = env.reset(n, torch.Generator(device="cuda").manual_seed(seed))
    view = st.drone.read.view
    to_gate = st.gate_positions[:, 0] - view[:, 3]
    euler = view[:, 1].clone()
    euler[:, 2] = torch.atan2(to_gate[:, 1], to_gate[:, 0])
    return view[:, 3].contiguous(), euler, env.scene_boxes(st)


def check_render(res: int, seed: int, card: str) -> dict:
    """The camera at ``res`` × ``res`` on GATES_ENVS views: the card against
    the CPU running the same code (the edge rule, depth where the
    segmentation agrees), its wall and device time, its peak memory and
    its bound."""
    import numpy as np
    import torch
    from pyflyt_tpu_torch.core import camera as cam

    pos, euler, boxes = gates_views(GATES_ENVS, seed)
    fn = lambda: cam.capture_image(pos, euler, boxes, resolution=(res, res))  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rgba, depth, seg = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    cpu_boxes = cam.Boxes(**{f.name: None if getattr(boxes, f.name) is None else getattr(boxes, f.name).cpu()
                             for f in dataclasses.fields(cam.Boxes)})
    r_c, d_c, s_c = cam.capture_image(pos.cpu(), euler.cpu(), cpu_boxes, resolution=(res, res))
    r_g, d_g, s_g = (x.cpu().numpy() for x in (rgba, depth, seg))
    share, away = edge_flips(r_c.numpy(), r_g, s_c.numpy(), s_g)
    same = s_c.numpy() == s_g
    depth_err = float(np.abs(d_c.numpy() - d_g)[same].max())
    check(share <= RENDER_EDGE_SHARE and away == 0, f"render {res}px: {share} of the pixels differ, {away} off edges")
    check(depth_err <= RENDER_DEPTH_ATOL, f"render {res}px: depth error {depth_err}")
    gate_px = int((s_c.numpy() > 0).sum())
    check(gate_px > GATES_ENVS, f"render {res}px: the gates cover {gate_px} pixels")
    wall = host_wall_ms(fn, iters=10)
    dev = profiled_device_ms(fn, iters=3)
    pixels = GATES_ENVS * res * res
    holed = boxes.hole_half is not None
    t_bytes = pixels * RENDER_BYTES_PER_PIXEL / H100_BYTES_PER_S
    t_ops = pixels * boxes.count * (RAY_HOLED_BOX_OPS if holed else RAY_BOX_OPS) / H100_F32_FLOPS
    return {"card": card, "envs": GATES_ENVS, "res": res, "boxes": boxes.count, "pixels": pixels,
            "differing_share": share, "depth_err": depth_err, "gate_pixels": gate_px, "wall_ms": wall,
            "device_ms": dev, "peak_bytes": int(peak), "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def vision_obs(net, rows: int, seed: int):
    """Flat gates observations on the card: normal vector features and
    random image bytes."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    i0, n = net.image_offset, net.image_size
    return torch.cat([torch.randn((rows, i0), generator=g, device="cuda"),
                      torch.randint(0, 256, (rows, n), generator=g, device="cuda").float(),
                      torch.randn((rows, net.obs_dim - i0 - n), generator=g, device="cuda")], dim=1)


def check_vision_net(net, seed: int, card: str) -> dict:
    """``VisionActorCritic`` on the card (TF32 off for cuDNN and matmul)
    against the same module on the CPU at NET_ROWS rows; its forward and
    forward + backward, wall and device time."""
    import copy

    import torch

    cpu = copy.deepcopy(net).cpu()
    out = {"card": card}
    for rows in NET_ROWS:
        obs = vision_obs(net, rows, seed + rows)
        with torch.no_grad():
            m, _, v = net(obs)
            mc, _, vc = cpu(obs.cpu())
        scale_m, scale_v = max(1.0, float(mc.abs().max())), max(1.0, float(vc.abs().max()))
        e_m, e_v = float((m.cpu() - mc).abs().max()), float((v.cpu() - vc).abs().max())
        check(e_m <= NET_REL * scale_m and e_v <= NET_REL * scale_v,
              f"vision net at {rows} rows: mean error {e_m} (scale {scale_m}), value error {e_v} (scale {scale_v})")

        def fwd():
            with torch.no_grad():
                return net(obs)

        def fwd_bwd():
            net.zero_grad(set_to_none=True)
            mean, _, value = net(obs)
            (mean.sum() + value.sum()).backward()

        out[str(rows)] = {"mean_err": e_m, "value_err": e_v, "mean_scale": scale_m, "value_scale": scale_v,
                          "forward_wall_ms": host_wall_ms(fwd, iters=20), "forward_ms": profiled_device_ms(fwd, 5),
                          "forward_backward_wall_ms": host_wall_ms(fwd_bwd, iters=10),
                          "forward_backward_ms": profiled_device_ms(fwd_bwd, 3)}
    net.zero_grad(set_to_none=True)
    return out


def gates_eval(net, use_kernel: bool, seed: int, card: str) -> dict:
    """The archived r4 policy flown deterministically (``PPO.evaluate``: the
    f32 module's clipped mean) for GATES_EVAL_EPISODES fresh 32 px episodes
    of max_steps + 2 agent steps; fails under the JAX CPU eval's mean less 3
    standard errors. ``use_kernel`` steps the physics through K1 generic
    (row 2): env_step_ratio launches an agent step."""
    import torch
    from pyflyt_tpu_torch.rl import PPO, PPOConfig

    env = gates_env(use_kernel=use_kernel)
    ppo = PPO(env, PPOConfig(), network=net)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1500)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    stats = {k: float(v) for k, v in ppo.evaluate(net, gen, GATES_EVAL_EPISODES).items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = env.max_steps + 2
    want = {**dict.fromkeys(launches, 0), "quadx_step": steps * env.env_step_ratio if use_kernel else 0}
    check(launches == want, f"gates eval (use_kernel={use_kernel}) launches {launches}, expected {want}")
    jax_eval = gates_jax_eval()
    floor = jax_eval["mean_reward"] - 3.0 * jax_eval["std_reward"] / math.sqrt(jax_eval["episodes"])
    check(math.isfinite(stats["mean_reward"]) and stats["mean_reward"] >= floor,
          f"gates eval (use_kernel={use_kernel}): mean reward {stats['mean_reward']} under its floor {floor}")
    zero_launches()
    return {"card": card, "use_kernel": use_kernel, "episodes": GATES_EVAL_EPISODES, "steps": steps, "wall_s": wall,
            "ms_per_step": 1e3 * wall / steps, **stats, "floor_reward": floor, "jax_cpu_eval": jax_eval,
            "archive": gates_archive(), "policy": GATES_POLICY, "launches": launches}


def gates_r4_ppo(refresh: int):
    from pyflyt_tpu_torch.rl import PPO, PPOConfig
    from pyflyt_tpu_torch.rl.networks import VisionActorCritic

    env = gates_env()
    net = VisionActorCritic(env.flat_obs_size, 4, env.combined_size, env.image_shape, device="cuda", **GATES_R4_NET)
    return PPO(env, PPOConfig(**GATES_R4, cached_reset_refresh=refresh), network=net)


def gates_train(seed: int, card: str) -> dict:
    """One timed, split iteration of the r4 recipe at 256 envs × 128
    steps, 4 epochs × 8 minibatches, with the cached auto-reset at refresh
    64 (the r5b value; after a warm-up iteration) and with the exact one
    (0, the CLI's default; its shapes already warm); no kernel launches
    (plain physics, the f32 module); finite metrics and parameters that
    moved."""
    out = {}
    for refresh in (64, 0):
        tp = gates_r4_ppo(refresh)
        start = [p.detach().clone() for p in tp.init(seed).network.parameters()]
        res, runner = timed_iterations(tp, {}, f"gates r4 refresh {refresh}", seed, card, warm_up=refresh > 0)
        moved = sum(not bool((p == q).all()) for p, q in zip(runner.network.parameters(), start))
        check(moved == len(start), f"gates r4 refresh {refresh}: {len(start) - moved} parameter tensors did not move")
        out[f"refresh_{refresh}"] = res
    return out


def gates_cli(card: str) -> dict:
    """The CLI on the card with the JAX CLI's defaults: ``train`` for one
    iteration (256 envs × 128 steps, exact auto-reset, its 8-episode eval
    and best-model checkpoint under build/) and ``eval --checkpoint`` on
    the shipped npz (8 episodes)."""
    import io
    import shutil
    import tempfile
    from contextlib import redirect_stdout

    import torch
    from pyflyt_tpu_torch.rl_training import gates_vision

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_gates_", dir=os.path.join(HERE, "build"))
    try:
        run_dir = os.path.join(work, "run")
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()) as printed:
            runner = gates_vision.main(["train", "--total_timesteps", str(256 * 128), "--log_dir", run_dir])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        row = json.loads(printed.getvalue().strip().splitlines()[-1])
        check(runner.update_idx == 1, "gates cli train: one iteration")
        best = [n for n in os.listdir(run_dir) if n.startswith("best_model_")]
        check(len(best) == 1 and "metrics.jsonl" in os.listdir(run_dir), f"gates cli train wrote {os.listdir(run_dir)}")
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()) as printed:
            npz = gates_vision.main(["eval", "--checkpoint", GATES_POLICY])
        npz_s = time.perf_counter() - t0
        check(json.loads(printed.getvalue().strip().splitlines()[-1]) == npz, "gates cli eval: printed line")
        check(all(math.isfinite(v) for v in (*row.values(), *npz.values())), "gates cli: non-finite metrics")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"card": card, "train_s": train_s, "train_eval_mean_reward": row["eval_mean_reward"],
            "train_eval_mean_length": row["eval_mean_length"], "eval_npz_s": npz_s, "eval_npz": npz}


PROFILE_SESSIONS = 3  # device_busy_ms's sessions at most for one reading


def device_busy_ms(fn, label: str) -> float:
    """The summed device time of the CUDA kernels of one call of ``fn``
    (after a warm-up), from one torch.profiler session over host and
    device activities, as ``profiled`` takes it. A session that records no
    CUDA kernel at all is taken again (an H100 run once lost a short
    session's whole device record late in the script), at most
    PROFILE_SESSIONS times, each empty one said on stderr; fails if none
    records one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for k in range(PROFILE_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = sum((getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3
        print(f"chip_smoke: profiler session {k + 1} recorded no device time for {label}", file=sys.stderr)
    check(False, f"profiler: no device time recorded for {label} in {PROFILE_SESSIONS} sessions")


def gates_profile(net, seed: int, card: str) -> dict:
    """One 256-env gates rollout step (the r4 env, the archived policy
    sampling through the f32 module, the exact auto-reset) and its parts,
    each timed alone on the same state: wall (synchronized, over 10 calls)
    and device time (one call under torch.profiler). ``host_ms`` is the
    step's wall less its device time."""
    import torch
    from pyflyt_tpu_torch.rl import ppo

    env = gates_env()
    gen = torch.Generator(device="cuda").manual_seed(seed + 1600)
    ars, obs = ppo.env_init(env, GATES_ENVS, gen, 0)
    ars, obs, _ = ppo.rollout(net, env, ars, obs, 8, gen, refresh=0, fused=False)
    action, _, _ = ppo.act(net, obs, gen, fused=False)
    low, high = ppo.action_bounds(env, torch.device("cuda"))
    action = torch.clamp(action, low, high)

    def physics():
        drone = ars.drone
        for _ in range(env.env_step_ratio):
            drone, _ = env.aviary_step(drone, ars.generator)
        return drone

    parts = {
        "rollout_step": lambda: ppo.rollout(net, env, ars, obs, 1, gen, refresh=0, fused=False),
        "policy": lambda: ppo.act(net, obs, gen, fused=False),
        "env_step": lambda: env.step(ars, action),
        "render": lambda: env._render_camera(ars),
        "physics": physics,
        "reset": lambda: env.reset(GATES_ENVS, gen),
        "autoreset_step": lambda: env.autoreset_step(ars, action),
    }
    out = {name: {"wall_ms": host_wall_ms(fn, iters=10), "device_ms": device_busy_ms(fn, name)}
           for name, fn in parts.items()}
    step = out["rollout_step"]
    out["host_ms"] = step["wall_ms"] - step["device_ms"]
    out["device_busy_share"] = step["device_ms"] / step["wall_ms"]
    out["task_and_obs_ms"] = out["env_step"]["wall_ms"] - out["render"]["wall_ms"] - out["physics"]["wall_ms"]
    out["card"] = card
    return out


# ---------------------------------------------------------------------------
# phases 51-56: every Pallas configuration (row 1 in mode 7, the general family)
# ---------------------------------------------------------------------------

HOVER7_STEPS = 48  # tests/test_packed_hover.py's mode-7 horizon
HOVER7_DOME = 1.5  # and its dome: the climbing half leaves it within the horizon
GENERAL_TRUNK = (256, 256, 256)  # the hovering CLI's --num_of_layers 3 --layer_size 256
# trunk pairs of the general family: a linear policy, six 48-wide layers,
# widths that are no multiple of 16, a 2 x 256 actor beside a narrow critic,
# one and three 256-wide layers, two 512-wide, and the default 2 x 256
# feature trunk with a 64-wide head layer a side
GENERAL_PAIRS = (((), ()), ((48,) * 6, (48,) * 6), ((160, 72), (160, 72)), ((256, 256), (32, 32)),
                 ((256,), (256,)), (GENERAL_TRUNK, GENERAL_TRUNK), ((512, 512), (512, 512)),
                 ((256, 256, 64), (256, 256, 64)))
# the per-layer route's trunk for K4g and K3g: one layer past what a cluster of 8 holds
GENERAL_PAST = (4128,)
# the grid's pairs: those, one past a block's width (K4g and K3g on the
# cluster route, K2g per layer) and one past a cluster's (every kernel per layer)
GENERAL_WIDE = ((1024,), (1024,))
GENERAL_GRID_PAIRS = GENERAL_PAIRS + (GENERAL_WIDE, (GENERAL_PAST, GENERAL_PAST))
# the cluster route's pairs (phase 58): 640 (three chunks), 1000 (padded),
# 1024 units and the hovering CLI's --num_of_layers 2 --layer_size 1024 (2
# or 4 blocks a cluster by the rows), 2048 (4 or 8), a wide actor beside a
# narrow critic, and two layers of 1504 (C = 4) and of 3040 units (C = 8):
# an odd count of 32-deep k steps and two chunks a rank, so that a middle
# rank's peer blocks lie at both ends of each chunk's k range, an odd
# number of them
HOVER7_WIDE = (1024, 1024)
CLUSTER_PAIRS = (((640,), (640,)), ((1000,), (1000,)), ((1024,), (1024,)), (HOVER7_WIDE, HOVER7_WIDE),
                 ((2048,), (2048,)), ((1024,), (32, 32)), ((1504, 1504), (1504, 1504)),
                 ((3040, 3040), (3040, 3040)))
CLUSTER_ROWS = (N_RAGGED, HOVER_MIDWARP, N_ENVS)
HOVER7_WIDE_STEPS = 64  # the 2 x 1024 serving rollout's timed steps
GENERAL_WIDTHS = ((21, 4), (72, 10))
# K2g's first moment against the twin's, of each leaf's largest (K2 and K2n
# are held at EPOCH_MU_REL at 2 x 256 and narrow trunks): about twice what
# two correct orders of the same sums read. On an H100
# (tools/general_epoch_probe.py, 4 seeds of check_general_epochs' 16
# cases): the twin against itself with each product summed over two
# halves of k up to 1.27e-3, K2g up to 2.33e-3 (six 48-wide layers, obs
# 72, 1000 rows); the twin with its products' sums rounded to bf16 from
# 1.6e-3 to 0.145, and it fails this or the other epoch limits in 62 of
# the 64 cases; missing 64 or 512 rows of the weight gradients 0.11 to 1.24
GENERAL_MU_REL = 2.5e-3
GENERAL_ROWS = (1, N_RAGGED, N_ENVS)
HOVER7_ROLLOUT_STEPS = 256
# the serving rollout's warm-up: with it the stock env's 400-step time limit
# falls inside the timed steps, so every lane ends an episode and takes its
# cached reset there (no random setpoint in the action bounds leaves the
# stock 3 m dome or lands the drone: on an H100 0 and 1 of 8192 episodes
# ended within 264 and 312 steps)
HOVER7_WARMUP_STEPS = 150


def hover7_env(**kw):
    from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv
    from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv

    return PackedQuadXHoverEnv(base=QuadXHoverEnv(flight_mode=7, device="cuda", **kw))


def hover7_setpoints(n: int):
    """tests/test_packed_hover.py's mode-7 setpoints [x, y, yaw, z]: half
    the fleet holds near the spawn, half is sent 2.5 m up, out of the dome."""
    import torch

    sp = torch.tensor([0.1, -0.1, 0.2, 1.2], device="cuda")[:, None].repeat(1, n)
    sp[3, : n // 2] = 2.5
    return sp


def check_hover_mode7(n: int, staggered: bool = False) -> dict:
    """Row 1 in mode 7 vs its twin over HOVER7_STEPS agent steps (noise
    off), lane by lane over all 80 rows: every row of every lane (flags,
    the cascade's 18 included) within tests/test_packed_hover.py's mode-7
    curve 5e-4 + 1e-4 * step, no lane excepted; rows 74-79 zero; a frozen lane
    keeps every row but the setpoint, the step count and the re-armed
    reward. ``staggered``: the upper half 0-4 agent steps short of the time
    limit by column mod 5, so lanes of one warp freeze at different agent
    steps (checked)."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_quadx as cq

    env = hover7_env(noisy_motors=False, flight_dome_size=HOVER7_DOME)
    state, _ = env.reset(n)
    packed = state.packed.clone()
    if staggered:
        cols = torch.arange(n // 2, n, device="cuda")
        packed[cq._STEP, cols] = float(env.base.max_steps) - (cols % 5).float()
    seed = torch.zeros(1, dtype=torch.int64, device="cuda")
    kern, plain = packed.clone(), packed.clone()
    sp = hover7_setpoints(n)
    keep = torch.ones(cq.ROWS_MODE7, dtype=torch.bool, device="cuda")
    keep[cq._SP : cq._SP + 4] = False
    keep[cq._RWD] = False
    keep[cq._STEP] = False
    first_frozen = torch.full((n,), -1, dtype=torch.long, device="cuda")
    err, diverged, frozen = 0.0, 0, 0
    for i in range(HOVER7_STEPS):
        kern[cq._SP : cq._SP + 4] = sp
        plain[cq._SP : cq._SP + 4] = sp
        before = kern.clone()
        kern = cq.packed_hover_step(kern, seed, env.consts, 7, False)
        plain = cq.packed_hover_step_plain(plain, seed, env.consts, 7, False)
        torch.cuda.synchronize()
        where = f"hover mode 7 N={n} step {i}"
        check(kern.shape == (cq.ROWS_MODE7, n) and bool(torch.isfinite(kern).all()), f"{where}: state")
        check(not bool(kern[cq._ZV_PRV + 1 :].any()), f"{where}: rows 74-79 not zero")
        lane = (kern - plain).abs().amax(0)
        bad = int((lane > 5e-4 + 1e-4 * i).sum())
        diverged = max(diverged, bad)
        check(bad == 0, f"{where}: {bad} lanes beyond 5e-4 + 1e-4 * step")
        err = max(err, lane.max().item())
        done0 = (before[cq._TERM] > 0.5) | (before[cq._TRUNC] > 0.5)
        check(torch.equal(kern[keep][:, done0], before[keep][:, done0]), f"{where}: a frozen lane moved")
        frozen += int(done0.sum())
        first_frozen[((kern[cq._TERM] > 0.5) | (kern[cq._TRUNC] > 0.5)) & (first_frozen < 0)] = i
    ev = {name: int((kern[row] > 0.5).sum()) for name, row in (("termination", cq._TERM), ("truncation", cq._TRUNC),
                                                               ("out_of_bounds", cq._OOB), ("collision", cq._COLL))}
    ev["frozen"] = frozen
    need = ("termination", "out_of_bounds", "frozen") + (("truncation",) if staggered else ())
    check(all(ev[k] > 0 for k in need), f"hover mode 7 N={n}: events {ev}")
    if staggered:
        ff = first_frozen[: n - n % 32].view(-1, 32)
        ev["warps_frozen_at_two_steps"] = int(((ff.amax(1) != ff.amin(1)) & (ff.amin(1) >= 0)).sum())
        check(ev["warps_frozen_at_two_steps"] > 0, f"hover mode 7 N={n}: no warp froze at two agent steps")
    return {"max_abs_err": err, "max_diverged_lanes": diverged, "events": ev}


def general_net(seed: int, obs: int, act: int, pi, vf, **kw):
    """A random actor-critic of the given trunks (no feature trunk)."""
    import torch
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    return ActorCritic(obs, act, feature_sizes=(), pi_sizes=pi, vf_sizes=vf, device="cuda",
                       generator=torch.Generator().manual_seed(seed), **kw)


def per_layer_images(net):
    """The per-layer route's images (``cuda_general.pack_trunk``) of
    ``net``'s actor and critic."""
    from pyflyt_tpu_torch.ops import cuda_general

    def one(trunk, head):
        return cuda_general.pack_trunk([lin.weight.detach().T for lin in trunk.layers],
                                       [lin.bias.detach() for lin in trunk.layers], head.weight.detach().T,
                                       head.bias.detach())

    return one(net.pi_trunk, net.pi_head), one(net.vf_trunk, net.vf_head)


def check_routes_equal(net, n: int) -> bool:
    """K4g's and K3g's route (resident or cluster) against the per-layer
    route forced on the same inputs: the mean, value and log-probs equal
    bit for bit (every route runs each output's k16 steps in order on the
    same bf16 inputs, and wgmma's chain gives mma.sync's bits)."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_general, cuda_policy

    w = net.kernel_weights()
    g = torch.Generator().manual_seed(7 + n)
    obs = torch.randn((n, net.obs_dim), generator=g).cuda()
    rows = packed_rows(net, n, seed=11 + n)
    mp, vp = cuda_general.forward_per_layer(obs, w, *per_layer_images(net))
    lp = cuda_general.logp_per_layer(rows, pi_leaves(net), net.obs_dim, (-1.0, -0.2))
    mr, vr = cuda_policy.policy_value_forward(obs, w)
    lr = cuda_general.logp(rows, pi_leaves(net), net.obs_dim, (-1.0, -0.2))
    torch.cuda.synchronize()
    return bool(torch.equal(mr, mp) and torch.equal(vr, vp) and torch.equal(lr, lp))


K4G_ROUTES = {"resident": "general_resident_forward", "cluster": "general_cluster_forward",
              "per_layer": "general_policy_value_forward"}
K3G_ROUTES = {"resident": "general_resident_logp", "cluster": "general_cluster_logp",
              "per_layer": "general_logp_forward"}


def check_general_grid(seed: int) -> dict:
    """K4g over every trunk pair x (obs, act) x rows of the grid at
    ``policy_atol``, and K3g (the pair's family) at the same rows, with and
    without a log_std range, at ``logp_atol``; each launch counted on the
    route of the pair's widths (the resident one, the cluster one at
    (1024,), the per-layer one at (4128,)), each error counted on
    the route that gave it. Where both trunks take
    the resident route, it is also held bit for bit against the per-layer
    route at 1000 and 8192 rows."""
    from pyflyt_tpu_torch.ops import cuda_general, cuda_policy

    routes = {name: all_kernels()[name] for name in (*K4G_ROUTES.values(), *K3G_ROUTES.values())}
    worst = {route: {"mean": 0.0, "value": 0.0, "logp": 0.0} for route in K4G_ROUTES}
    start = {k: v.launches for k, v in routes.items()}
    want = dict.fromkeys(routes, 0)
    cases, equal = 0, []
    for k, (pi, vf) in enumerate(GENERAL_GRID_PAIRS):
        for o, a in GENERAL_WIDTHS:
            net = general_net(seed + 31 * k + o + a, o, a, pi, vf)
            w = net.kernel_weights()
            check(cuda_policy._kernel_family(w) == "general", f"general grid: {pi} {vf} family")
            fwd = cuda_general.forward_route(w)
            lp = cuda_general.logp_route(o, a, pi)
            atol = policy_atol(net)
            for n in GENERAL_ROWS:
                e_m, e_v = check_policy(net, n, atol)
                worst[fwd]["mean"], worst[fwd]["value"] = max(worst[fwd]["mean"], e_m), max(worst[fwd]["value"], e_v)
                worst[lp]["logp"] = max(worst[lp]["logp"], check_logp(net, n, atol=logp_atol))
                want[K4G_ROUTES[fwd]] += 1
                want[K3G_ROUTES[lp]] += 2
                cases += 1
            if fwd == lp == "resident":
                for n in (N_RAGGED, N_ENVS):
                    same = check_routes_equal(net, n)
                    check(same, f"general grid: {pi} {vf} obs {o} act {a} n={n}: resident != per-layer route")
                    equal.append(same)
                    for name in (K4G_ROUTES["resident"], K4G_ROUTES["per_layer"], K3G_ROUTES["resident"],
                                 K3G_ROUTES["per_layer"]):
                        want[name] += 1
    launches = {k: v.launches - start[k] for k, v in routes.items()}
    check(launches == want, f"general grid: launches {launches}, expected {want}")
    check(all(want[name] > 0 for name in K4G_ROUTES.values()), "general grid: every route")
    return {"cases": cases, "pairs": GENERAL_GRID_PAIRS, "widths": GENERAL_WIDTHS, "rows": GENERAL_ROWS,
            **{f"max_{k}_err": max(v[k] for v in worst.values()) for k in ("mean", "value", "logp")},
            "by_route": worst, "launches": launches, "routes_bit_equal_cases": len(equal)}


def check_general_consistency(net, n_mb: int, mb: int) -> dict:
    """Two K2g calls on the same inputs give bit-identical parameters,
    moments and metrics; and with the stored log-probs K3g's (the pair's
    family, as PPO's ``fused_sgd_consistent_logp`` writes them), the first
    minibatch's approx_kl is exactly 0: K3g's log-probs are K2g's forward
    bit for bit, row for row."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_general, cuda_sgd

    mbs, stats, t0, leaves, mu, nu, cfg = epoch_inputs(net, n_mb, mb, None)
    o, a = cfg.obs_dim, cfg.act_dim
    n_pi = 2 * len(cfg.pi_sizes) + 3
    mbs = mbs.clone()
    mbs[0, :, o + a] = cuda_sgd.logp_forward(mbs[0], leaves[:n_pi], o, cfg.log_std_range, vf_sizes=cfg.vf_sizes)
    first = cuda_general.launch_epoch(mbs, stats, t0, leaves, mu, nu, cfg)
    second = cuda_general.launch_epoch(mbs, stats, t0, leaves, mu, nu, cfg)
    torch.cuda.synchronize()
    flat = lambda r: [*r[0], *r[1], *r[2], r[3]]  # noqa: E731
    same = all(torch.equal(x, y) for x, y in zip(flat(first), flat(second)))
    check(same, f"general epoch {n_mb}x{mb}: two calls on the same inputs differ")
    kl0 = float(first[3][0, 4])
    check(kl0 == 0.0, f"general epoch {n_mb}x{mb}: K3g's log-probs are not K2g's forward (approx_kl {kl0})")
    return {"n_mb": n_mb, "mb": mb, "pi": cfg.pi_sizes, "vf": cfg.vf_sizes, "route": cuda_general.epoch_route(cfg),
            "bit_identical": same, "first_minibatch_approx_kl": kl0}


def check_general_chained(net, n_mb: int, mb: int, log_std_range) -> dict:
    """One K2g epoch of n_mb minibatches of mb rows equals, bit for bit,
    n_mb K2g calls of one minibatch each, chained through the parameters,
    the moments and Adam's count: the whole epoch is the one-minibatch step
    that ``check_general_epochs`` holds against the twin, repeated. (Over 32
    Adam steps two correct orders of the same sums drift apart past the
    epoch limits, so the twin cannot judge a long epoch itself.)"""
    import torch
    from pyflyt_tpu_torch.ops import cuda_sgd

    mbs, stats, t0, leaves, mu, nu, cfg = epoch_inputs(net, n_mb, mb, log_std_range)
    whole = cuda_sgd.fused_epoch(mbs, stats, t0, leaves, mu, nu, cfg)
    step, metrics = (leaves, mu, nu), []
    for m in range(n_mb):
        *step, met = cuda_sgd.fused_epoch(mbs[m : m + 1], stats[m : m + 1], t0 + m, *step, cfg)
        metrics.append(met)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip([*whole[0], *whole[1], *whole[2], whole[3]],
                                                 [*step[0], *step[1], *step[2], torch.cat(metrics)]))
    check(same, f"general epoch {n_mb}x{mb}: not the {n_mb} one-minibatch steps chained")
    return {"n_mb": n_mb, "mb": mb, "bit_identical": same}


def epoch_route_of(obs: int, act: int, pi, vf) -> str:
    """K2g's route at these widths (``cuda_general.epoch_route``)."""
    from types import SimpleNamespace

    from pyflyt_tpu_torch.ops import cuda_general

    return cuda_general.epoch_route(SimpleNamespace(obs_dim=obs, act_dim=act, pi_sizes=pi, vf_sizes=vf))


def check_general_epochs(seed: int) -> dict:
    """K2g against its twin at every trunk pair of the grid on the route of
    its widths (resident at every GENERAL_PAIRS pair, per layer at
    (1024,)), two minibatches of 8192 rows at obs 21 / act 4 and of 1000
    rows at obs 72 / act 10 with a clipping log_std range, and at the
    hovering CLI's 2 x 1024 (per layer) two of 8192 at obs 21 / act 4, the
    first moment at GENERAL_MU_REL, each launch counted on its route and
    each error on the route that gave it; then ``check_general_consistency``
    at the slice's trunk, at 2 x 512 and at the linear policy (resident)
    and at (1024,), 2 x 1024 and (4128,) (per layer; K3g's log-probs from
    the cluster route at the first two, the per-layer one at the last)."""
    from pyflyt_tpu_torch.ops import cuda_general

    kernels = {"resident": cuda_general.RESIDENT_EPOCH_KERNEL, "per_layer": cuda_general.EPOCH_KERNEL}
    start = {route: k.launches for route, k in kernels.items()}
    want = dict.fromkeys(kernels, 0)
    worst = dict.fromkeys(kernels, 0.0)
    checks = []
    shapes = [(pi, vf, 21, 4, N_ENVS, None) for pi, vf in GENERAL_PAIRS]
    shapes += [(pi, vf, 72, 10, N_RAGGED, EPOCH_RANGE) for pi, vf in GENERAL_PAIRS]
    wide, hover7 = GENERAL_WIDE, (HOVER7_WIDE, HOVER7_WIDE)
    shapes += [(*wide, 21, 4, N_ENVS, None), (*wide, 72, 10, N_RAGGED, EPOCH_RANGE), (*hover7, 21, 4, N_ENVS, None)]
    for k, (pi, vf, o, a, mb, rng) in enumerate(shapes):
        route = epoch_route_of(o, a, pi, vf)
        check(route == ("per_layer" if (pi, vf) in (wide, hover7) else "resident"),
              f"general epochs: {pi} {vf} on {route}")
        c = check_epoch(general_net(seed + 2000 + k, o, a, pi, vf), 2, mb, rng, GENERAL_MU_REL)
        checks.append({**c, "pi": pi, "vf": vf, "route": route})
        want[route] += 1
        worst[route] = max(worst[route], c["max_abs_err"])
    launches = {route: k.launches - start[route] for route, k in kernels.items()}
    check(launches == want, f"general epochs: launches {launches}, expected {want}")
    consistency = [check_general_consistency(general_net(seed + 3000 + k, 21, 4, pi, vf), 4, N_ENVS)
                   for k, (pi, vf) in enumerate(((GENERAL_TRUNK, GENERAL_TRUNK), ((512, 512), (512, 512)), ((), ()),
                                                 wide, hover7, (GENERAL_PAST, GENERAL_PAST)))]
    return {"checks": checks, "consistency": consistency, "launches": launches, "by_route": worst,
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "max_mu_rel_err": max(c["mu_rel_err"] for c in checks),
            "max_nu_rel_err": max(c["nu_rel_err"] for c in checks)}


def hover7_serving(seed: int, card: str):
    """The slice's serving path: a 3 x 256 ActorCritic (obs 21, seeded
    random weights) acting, sampled, through K4g in 8192 stock
    PackedQuadXHoverEnv(QuadXHoverEnv(flight_mode=7)) envs (noise on) with
    the cached auto-reset at refresh 64 for HOVER7_ROLLOUT_STEPS steps after
    HOVER7_WARMUP_STEPS: one row-1 and one K4g launch a step, nothing else,
    every lane's episode ending at the time limit. Then single steps'
    latency (``step_latency``)."""
    import torch
    from pyflyt_tpu_torch.envs.packed_hover import packed_autoreset_init
    from pyflyt_tpu_torch.ops import cuda_quadx as cq
    from pyflyt_tpu_torch.rl import ppo
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    env = hover7_env()
    net = ActorCritic(env.obs_size, 4, feature_sizes=GENERAL_TRUNK, device="cuda",
                      generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    ars, obs = packed_autoreset_init(env, N_ENVS, gen)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    ars, obs, _ = ppo.rollout(net, env, ars, obs, HOVER7_WARMUP_STEPS, gen, refresh=64)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    ars, obs, traj = ppo.rollout(net, env, ars, obs, HOVER7_ROLLOUT_STEPS, gen, refresh=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "quadx_hover_step": HOVER7_ROLLOUT_STEPS,
            "general_resident_forward": HOVER7_ROLLOUT_STEPS}
    check(launches == want, f"mode-7 hover serving launches {launches}, expected {want}")
    check(ars.env_state.packed.shape == (cq.ROWS_MODE7, N_ENVS), "mode-7 hover serving: state rows")
    check(obs.shape == (N_ENVS, env.obs_size) and bool(torch.isfinite(obs).all()), "mode-7 hover serving: obs")
    check(bool(torch.isfinite(traj.reward).all() and torch.isfinite(traj.value).all()
               and torch.isfinite(traj.log_prob).all()), "mode-7 hover serving: non-finite outputs")
    n_done = int(traj.done.sum())
    check(n_done >= N_ENVS, f"mode-7 hover serving: {n_done} episodes ended, not every lane's")
    lat = step_latency(net, env, ars, obs, gen)
    zero_launches()
    return {"card": card, "num_envs": N_ENVS, "steps": HOVER7_ROLLOUT_STEPS, "wall_s": wall,
            "env_steps_per_s": N_ENVS * HOVER7_ROLLOUT_STEPS / wall, "ms_per_step": 1e3 * wall / HOVER7_ROLLOUT_STEPS,
            "episodes_done": n_done, "reset_s": reset_s, "mean_reward": float(traj.reward.mean()),
            "launches": launches, "step_latency": lat}, ars, obs, net


def hover7_train(seed: int, card: str) -> tuple[dict, object, object]:
    """The slice's training path: the hover fused_sgd recipe (8192 envs x
    32 steps, 15 epochs x 32 minibatches, cached auto-reset 64, the fused
    rollout forward) on 8192 mode-7 hover envs at the 3 x 256 trunk (row 1
    a step, K4g a step, K3g once, K2g an epoch), a warm-up and a timed,
    split iteration; then one iteration at the default 2 x 256 trunk (row
    1, K4, K3, K2: mode 7 drives the wide family too) and one at the
    hovering CLI's 2 x 1024 (row 1, K4g and K3g on the cluster route, K2g
    per layer)."""
    from pyflyt_tpu_torch.rl import PPO, PPOConfig

    cfg = PPOConfig(num_envs=N_ENVS, cached_reset_refresh=64, fused_sgd=True, fused_rollout_forward=True,
                    feature_sizes=GENERAL_TRUNK)
    tp = PPO(hover7_env(), cfg)
    general, runner = timed_iterations(tp, {"quadx_hover_step": cfg.rollout_steps,
                                            "general_resident_forward": cfg.rollout_steps,
                                            "general_resident_logp": 1, "general_resident_epoch": cfg.num_epochs},
                                       "mode-7 hover at 3 x 256", seed, card)
    wide_cfg = PPOConfig(num_envs=N_ENVS, cached_reset_refresh=64, fused_sgd=True, fused_rollout_forward=True)
    wide, _ = timed_iterations(PPO(hover7_env(), wide_cfg), {"quadx_hover_step": cfg.rollout_steps,
                                                            "policy_value_forward": cfg.rollout_steps,
                                                            "logp_forward": 1, "fused_epoch": cfg.num_epochs},
                               "mode-7 hover at 2 x 256", seed, card, warm_up=False)
    big_cfg = PPOConfig(num_envs=N_ENVS, cached_reset_refresh=64, fused_sgd=True, fused_rollout_forward=True,
                        feature_sizes=HOVER7_WIDE)
    big_tp = PPO(hover7_env(), big_cfg)
    big, big_runner = timed_iterations(big_tp, {"quadx_hover_step": cfg.rollout_steps,
                                                "general_cluster_forward": cfg.rollout_steps,
                                                "general_cluster_logp": 1, "fused_epoch_general": cfg.num_epochs},
                                       "mode-7 hover at 2 x 1024", seed, card, warm_up=False)
    return {"general_3x256": general, "wide_2x256": wide, "general_2x1024": big}, tp, runner, big_tp, big_runner


def hover7_serving_wide(seed: int, card: str) -> dict:
    """The serving path at the hovering CLI's widest trunk (``--num_of_layers
    2 --layer_size 1024``): a seeded 2 x 1024 ActorCritic acting, sampled,
    through K4g on its cluster route in 8192 mode-7 hover envs (cached
    auto-reset 64) for HOVER7_WIDE_STEPS steps after 8: one row-1 and one
    K4g launch a step, nothing else."""
    import torch
    from pyflyt_tpu_torch.envs.packed_hover import packed_autoreset_init
    from pyflyt_tpu_torch.ops import cuda_general
    from pyflyt_tpu_torch.rl import ppo
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    env = hover7_env()
    net = ActorCritic(env.obs_size, 4, feature_sizes=HOVER7_WIDE, device="cuda",
                      generator=torch.Generator().manual_seed(seed))
    check(cuda_general.forward_route(net.kernel_weights()) == "cluster", "2 x 1024 serving: not the cluster route")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ars, obs = packed_autoreset_init(env, N_ENVS, gen)
    ars, obs, _ = ppo.rollout(net, env, ars, obs, 8, gen, refresh=64)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    ars, obs, traj = ppo.rollout(net, env, ars, obs, HOVER7_WIDE_STEPS, gen, refresh=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "quadx_hover_step": HOVER7_WIDE_STEPS,
            "general_cluster_forward": HOVER7_WIDE_STEPS}
    check(launches == want, f"2 x 1024 serving launches {launches}, expected {want}")
    check(bool(torch.isfinite(traj.reward).all() and torch.isfinite(traj.value).all()
               and torch.isfinite(traj.log_prob).all()), "2 x 1024 serving: non-finite outputs")
    zero_launches()
    return {"card": card, "num_envs": N_ENVS, "steps": HOVER7_WIDE_STEPS, "sizes": HOVER7_WIDE, "wall_s": wall,
            "env_steps_per_s": N_ENVS * HOVER7_WIDE_STEPS / wall, "ms_per_step": 1e3 * wall / HOVER7_WIDE_STEPS,
            "launches": launches}


def check_general_cluster(seed: int) -> dict:
    """The cluster route (phase 58): K4g against its twin at ``policy_atol``
    and K3g (with and without a log_std range) at ``logp_atol`` over
    CLUSTER_PAIRS x GENERAL_WIDTHS x CLUSTER_ROWS, and at (1024,) with 40
    actions (a head too wide to relay: rank 0's, the peers' blocks
    staged), each launch counted on the cluster route; at every shape both
    bit for bit the per-layer route forced (``check_routes_equal``); and
    K3g's log-probs K2g's per-layer forward (approx_kl exactly 0) at (1024,)
    and 2 x 1024."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_general, cuda_policy

    names = (K4G_ROUTES["cluster"], K3G_ROUTES["cluster"], K4G_ROUTES["per_layer"], K3G_ROUTES["per_layer"])
    kernels = {name: all_kernels()[name] for name in names}
    start = {k: v.launches for k, v in kernels.items()}
    want = dict.fromkeys(names, 0)
    worst = {"mean": 0.0, "value": 0.0, "logp": 0.0}
    cases = equal = 0
    plans = {}
    shapes = [(k, pi, vf, o, a) for k, (pi, vf) in enumerate(CLUSTER_PAIRS) for o, a in GENERAL_WIDTHS]
    shapes.append((len(CLUSTER_PAIRS), *GENERAL_WIDE, 21, 40))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k, pi, vf, o, a in shapes:
        net = general_net(seed + 58 * k + o + a, o, a, pi, vf)
        w = net.kernel_weights()
        check(cuda_policy._kernel_family(w) == "general" and cuda_general.forward_route(w) == "cluster"
              and cuda_general.logp_route(o, a, pi) == "cluster", f"cluster pairs: {pi} {vf} not on the route")
        plans[f"{pi} {vf} obs {o} act {a}"] = {n: {
            "k4g": cuda_general.cluster_plan(cuda_general.resident_layouts(w), a, rows=n, sms=sms),
            "k3g": cuda_general.cluster_plan((cuda_general.resident_layout(o, pi, a),), a, True, rows=n, sms=sms)}
            for n in CLUSTER_ROWS}
        atol = policy_atol(net)
        for n in CLUSTER_ROWS:
            e_m, e_v = check_policy(net, n, atol)
            worst["mean"], worst["value"] = max(worst["mean"], e_m), max(worst["value"], e_v)
            worst["logp"] = max(worst["logp"], check_logp(net, n, atol=logp_atol))
            same = check_routes_equal(net, n)
            check(same, f"cluster route: {pi} {vf} obs {o} act {a} n={n}: not the per-layer route's bits")
            equal += same
            cases += 1
            want[names[0]] += 2
            want[names[1]] += 3
            want[names[2]] += 1
            want[names[3]] += 1
    launches = {k: v.launches - start[k] for k, v in kernels.items()}
    check(launches == want, f"cluster route: launches {launches}, expected {want}")
    consistency = [check_general_consistency(general_net(seed + 5800 + k, 21, 4, sizes, sizes), 2, 4096)
                   for k, sizes in enumerate(((1024,), HOVER7_WIDE))]
    return {"cases": cases, "shapes": [sh[1:] for sh in shapes], "rows": CLUSTER_ROWS, "plans": plans,
            **{f"max_{k}_err": v for k, v in worst.items()}, "bit_equal_to_per_layer_cases": equal,
            "launches": launches, "consistency": consistency}


def time_in_turns(calls: dict) -> dict:
    """``time_ms`` of each ``{name: (fn, iters)}`` in turns: in that order,
    then reversed; per name both rounds and their mean."""
    rounds = {name: [] for name in calls}
    for order in (list(calls), list(reversed(list(calls)))):
        for name in order:
            fn, iters = calls[name]
            rounds[name].append(time_ms(fn, iters=iters))
    return {name: {"ms_rounds": [r[0] for r in v], "ms": statistics.mean(r[0] for r in v),
                   "host_ms": statistics.mean(r[1] for r in v)} for name, v in rounds.items()}


def epoch_turns(calls: dict, library, n_mb: int) -> dict:
    """K2g's epoch on each route of ``calls`` (``{name: (fn, iters)}``,
    ``time_ms``) and the library's ``n_mb`` minibatch updates (``library``:
    one update; torch.profiler's summed kernel time, its chain of small
    kernels enqueues slower than the card runs it), in turns: that order
    with the library last, then reversed; per name both rounds and their
    mean, the library's host wall beside."""
    rounds = {name: [] for name in (*calls, "library")}
    for order in (list(rounds), list(reversed(list(rounds)))):
        for name in order:
            if name == "library":
                rounds[name].append((n_mb * profiled_device_ms(library, iters=8), n_mb * host_wall_ms(library, 8)))
            else:
                fn, iters = calls[name]
                rounds[name].append(time_ms(fn, iters=iters, repeats=3))
    return {name: {"ms_rounds": [r[0] for r in v], "ms": statistics.mean(r[0] for r in v),
                   "host_ms": statistics.mean(r[1] for r in v)} for name, v in rounds.items()}


def resident_epoch_ptxas(text: str | None = None) -> dict:
    """Registers, stack frame and spills of each kernel of K2g's resident
    route (``fused_epoch_general.cu``'s namespace ``rep``, fwd_bwd at both
    tiles) from an ``-Xptxas -v`` report (``text``; by default this
    checkout's build's)."""
    import re

    from pyflyt_tpu_torch.ops import cuda_build

    if text is None:
        text = cuda_build.library_path("fused_epoch_general.cu").with_suffix(".log").read_text()
    out = {}
    for m in re.finditer(r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads\n.*?Used (\d+) registers", text):
        k = re.search(r"3rep\d+(\w+?_kernel)(?:ILi(\d+))?", m.group(1))
        if k:
            out[k.group(1) + (f"_tile{k.group(2)}" if k.group(2) else "")] = {
                "registers": int(m.group(5)), "stack_frame_bytes": int(m.group(2)),
                "spill_store_bytes": int(m.group(3)), "spill_load_bytes": int(m.group(4))}
    check(len(out) == 6, f"resident epoch ptxas report: {sorted(out)}")
    return out


def resident_ptxas() -> dict:
    """Registers, stack frame and spills of each resident instantiation
    (K4g or K3g x tile 128/64) from policy_general.cu's ``-Xptxas -v``
    report."""
    import re

    from pyflyt_tpu_torch.ops import cuda_build

    text = cuda_build.library_path("policy_general.cu").with_suffix(".log").read_text()
    out = {}
    for m in re.finditer(r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads\n.*?Used (\d+) registers", text):
        t = re.search(r"resident_kernelILi(\d+)ELb([01])E", m.group(1))
        if t:
            out[f"{'k3g' if t.group(2) == '1' else 'k4g'}_tile{t.group(1)}"] = {
                "registers": int(m.group(5)), "stack_frame_bytes": int(m.group(2)),
                "spill_store_bytes": int(m.group(3)), "spill_load_bytes": int(m.group(4))}
    check(len(out) == 4, f"resident ptxas report: {sorted(out)}")
    return out


def roofline(b: float, f: float, rate: float = H100_BF16_FLOPS) -> tuple[float, str]:
    """The bound of moving ``b`` bytes and doing ``f`` operations at
    ``rate``: (ms, what bounds it)."""
    return (1e3 * max(b / H100_BYTES_PER_S, f / rate),
            "bytes" if b / H100_BYTES_PER_S >= f / rate else "operations")


def tensor_bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def cluster_ptxas() -> dict:
    """Registers, stack frame and spills of each cluster instantiation (K4g
    and K3g, 64-row tiles) from policy_general.cu's ``-Xptxas -v`` report."""
    import re

    from pyflyt_tpu_torch.ops import cuda_build

    text = cuda_build.library_path("policy_general.cu").with_suffix(".log").read_text()
    out = {}
    for m in re.finditer(r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads\n.*?Used (\d+) registers", text):
        t = re.search(r"cluster_kernelILi(\d+)ELb([01])E", m.group(1))
        if t:
            out[f"{'k3g' if t.group(2) == '1' else 'k4g'}_tile{t.group(1)}"] = {
                "registers": int(m.group(5)), "stack_frame_bytes": int(m.group(2)),
                "spill_store_bytes": int(m.group(3)), "spill_load_bytes": int(m.group(4))}
    check(len(out) == 2, f"cluster ptxas report: {sorted(out)}")
    return out


def time_wide_routes(net, obs, rows, k4_iters: int = 60, k3_iters: int = 20) -> dict:
    """K4g on ``obs`` and K3g on ``rows`` at a trunk past a block's width
    (``net``): each on the cluster route, on the per-layer route forced
    and as the library call, in turns (K3g also the cluster kernel and its
    image build alone); the twins; the bounds."""
    from pyflyt_tpu_torch.ops import cuda_general, cuda_policy, cuda_sgd

    o, a = net.obs_dim, net.action_dim
    pi, vf = trunk_sizes(net.pi_trunk), trunk_sizes(net.vf_trunk)
    w = net.kernel_weights()
    check(cuda_general.forward_route(w) == "cluster" and cuda_general.logp_route(o, a, pi) == "cluster",
          f"trunk {pi}: not the cluster route")
    images = per_layer_images(net)
    k4 = time_in_turns({"cluster": (lambda: cuda_policy.policy_value_forward(obs, w), k4_iters),
                        "per_layer": (lambda: cuda_general.forward_per_layer(obs, w, *images), k4_iters),
                        "library": (library_forward(net, obs), 20)})
    plain, _ = time_ms(lambda: cuda_policy.policy_value_forward_plain(obs, w), iters=20, device_timed=False)
    b_ms, by = policy_bound(w, obs)
    out = {"general_cluster_forward": {
        "ms": k4["cluster"]["ms"], "host_ms": k4["cluster"]["host_ms"], "plain_ms": plain,
        "library_ms": k4["library"]["ms"], "bound_ms": b_ms, "bound_by": by, "rows": obs.shape[0], "obs_dim": o,
        "sizes": pi, "per_layer_ms": k4["per_layer"]["ms"], "per_layer_host_ms": k4["per_layer"]["host_ms"],
        "turns": k4}}
    batch = rows.shape[0]
    pl_ = pi_leaves(net)
    n_pi = len(pi)
    lay = cuda_general.resident_layout(o, pi, a)
    pack = lambda: cuda_general.pack_resident(pl_[: 2 * n_pi : 2], pl_[1 : 2 * n_pi : 2], pl_[2 * n_pi],  # noqa: E731
                                              pl_[2 * n_pi + 1])
    image = pack()
    k3 = time_in_turns({
        "cluster": (lambda: cuda_sgd.logp_forward(rows, pl_, o, vf_sizes=vf), k3_iters),
        "per_layer": (lambda: cuda_general.logp_per_layer(rows, pl_, o), k3_iters),
        "library": (library_logp(net, rows), k3_iters),
        "kernel": (lambda: cuda_general.launch_cluster_logp(rows, image, lay, pl_[-1], o), k3_iters),
        "pack": (pack, 20)})
    plain, _ = time_ms(lambda: cuda_sgd.logp_forward_plain(rows, pl_, o), iters=3, repeats=3, device_timed=False)
    b_ms, by = roofline(tensor_bytes([rows, *pl_]) + batch * 4, cuda_sgd.logp_flops(batch, o, a, sizes=pi))
    out["general_cluster_logp"] = {
        "ms": k3["cluster"]["ms"], "host_ms": k3["cluster"]["host_ms"], "plain_ms": plain,
        "library_ms": k3["library"]["ms"], "bound_ms": b_ms, "bound_by": by, "rows": batch, "obs_dim": o,
        "sizes": pi, "kernel_ms": k3["kernel"]["ms"], "pack_ms": k3["pack"]["ms"],
        "per_layer_ms": k3["per_layer"]["ms"], "per_layer_host_ms": k3["per_layer"]["host_ms"], "turns": k3}
    return out


def time_1024_routes(shapes: dict) -> dict:
    """``other_trunks``' (1024,) iteration (``shapes``: its network's
    widths, here with random weights from a seed): K4g over a rollout
    step's rows and K3g over the iteration's batch on the cluster route,
    the per-layer route forced and the library call (``time_wide_routes``;
    the per-layer times also under the per-layer kernels' names), and K2g
    on its per-layer route against its library call, the twin and the
    bound."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_general, cuda_sgd

    o, a, sizes = shapes["obs_dim"], shapes["act_dim"], tuple(shapes["sizes"])
    net = general_net(41, o, a, sizes, sizes)
    obs = torch.randn((shapes["forward_rows"], o), generator=torch.Generator().manual_seed(43)).cuda()
    batch = shapes["logp_rows"]
    out = time_wide_routes(net, obs, packed_rows(net, batch, seed=306))
    for name, per_layer in (("general_cluster_forward", "general_policy_value_forward"),
                            ("general_cluster_logp", "general_logp_forward")):
        t = out[name]
        out[per_layer] = {"ms": t["per_layer_ms"], "host_ms": t["per_layer_host_ms"], "cluster_ms": t["ms"],
                          **{k: t[k] for k in ("plain_ms", "library_ms", "bound_ms", "bound_by", "rows", "obs_dim",
                                               "sizes")}}
    n_mb = shapes["minibatches"]
    inputs = epoch_inputs(net, n_mb, batch // n_mb, None)
    mbs, stats, t0, leaves, mu, nu, ecfg = inputs
    check(cuda_general.epoch_route(ecfg) == "per_layer", f"trunk {sizes}: K2g not on the per-layer route")
    k2 = epoch_turns({"per_layer": (lambda: cuda_sgd.fused_epoch(*inputs), 5)}, library_update(net, mbs[0], stats[0],
                                                                                               ecfg), n_mb)
    plain, _ = time_ms(lambda: cuda_sgd.fused_epoch_plain(*inputs), iters=1, repeats=2, device_timed=False)
    state = tensor_bytes(leaves) + tensor_bytes(mu) + tensor_bytes(nu)
    b_ms, by = roofline(tensor_bytes([mbs, stats, t0]) + 2 * state + n_mb * 5 * 4,
                        cuda_sgd.epoch_flops(batch, o, a, pi_sizes=sizes, vf_sizes=sizes))
    out["fused_epoch_general"] = {
        "ms": k2["per_layer"]["ms"], "host_ms": k2["per_layer"]["host_ms"], "plain_ms": plain,
        "library_ms": k2["library"]["ms"], "library_ms_source": "torch.profiler kernel time", "bound_ms": b_ms,
        "bound_by": by, "minibatches": n_mb, "minibatch_size": batch // n_mb, "obs_dim": o, "sizes": sizes,
        "turns": k2}
    out["cluster_ptxas"] = cluster_ptxas()
    return out


def gemm_ptxas() -> dict:
    """Registers, stack frame and spills of each instantiation of the
    per-layer GEMM (``csrc/policy_general.cuh``) in the two sources that
    build it."""
    import re

    from pyflyt_tpu_torch.ops import cuda_build

    out = {}
    for source in ("policy_general.cu", "fused_epoch_general.cu"):
        log = cuda_build.library_path(source).with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        for m in re.finditer(r"Function properties for \S*gemm_kernelILi(\d)ELi(\d)ELi(\d)E\S*\n\s*(\d+) bytes stack "
                             r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads.*?Used (\d+) registers", text, re.S):
            epi, ta, tb, stack, st, ld, regs = (int(v) for v in m.groups())
            out[f"{source}:epi{epi}_ta{ta}_tb{tb}"] = {"registers": regs, "stack_frame_bytes": stack,
                                                       "spill_store_bytes": st, "spill_load_bytes": ld}
    check(bool(out) and all(v["spill_store_bytes"] == 0 for v in out.values()), f"the per-layer GEMM's ptxas: {out}")
    return out


def time_wide_epoch(big_tp, big_runner) -> dict:
    """K2g on its per-layer route at the 2 x 1024 training path's shapes:
    one epoch of 32 minibatches of 8192 rows of packed rows on
    ``big_runner``'s trained network and Adam state, in turns with the
    library's 32 updates (bf16 autograd + ``Adam(fused=True)``, profiler
    kernel time), the plain twin and the bound."""
    from pyflyt_tpu_torch.ops import cuda_general, cuda_sgd

    net, cfg = big_runner.network, big_tp.config
    o, a = net.obs_dim, net.action_dim
    pi, vf = trunk_sizes(net.pi_trunk), trunk_sizes(net.vf_trunk)
    mbs = packed_rows(net, cfg.batch_size, seed=309).reshape(cfg.num_minibatches, cfg.minibatch_size, -1)
    stats = adv_stats(mbs[:, :, o + a + 1])
    leaves = [t.detach() for t in cuda_sgd.params_to_leaves(net)]
    opt = big_runner.opt_state
    ecfg = big_tp.epoch_config(o)
    check(cuda_general.epoch_route(ecfg) == "per_layer", "K2g at 2 x 1024: the per-layer route")
    epoch = (mbs, stats, opt.count.reshape(1), leaves, opt.mu, opt.nu, ecfg)
    # one call 2 + 25 x 32 kernels: under the ~1000 a stream holds
    k2 = epoch_turns({"per_layer": (lambda: cuda_sgd.fused_epoch(*epoch), 1)},
                     library_update(net, mbs[0], stats[0], cfg), cfg.num_minibatches)
    plain, _ = time_ms(lambda: cuda_sgd.fused_epoch_plain(*epoch), iters=1, repeats=2, device_timed=False)
    state = tensor_bytes(leaves) + tensor_bytes(opt.mu) + tensor_bytes(opt.nu)
    b_ms, by = roofline(tensor_bytes(epoch[:3]) + 2 * state + cfg.num_minibatches * 5 * 4,
                        cuda_sgd.epoch_flops(cfg.batch_size, o, a, pi_sizes=pi, vf_sizes=vf))
    ms = k2["per_layer"]["ms"]
    return {"ms": ms, "host_ms": k2["per_layer"]["host_ms"], "ms_per_minibatch": ms / cfg.num_minibatches,
            "plain_ms": plain, "library_ms": k2["library"]["ms"], "library_ms_source": "torch.profiler kernel time",
            "library_host_wall_ms": k2["library"]["host_ms"], "bound_ms": b_ms, "bound_by": by,
            "minibatches": cfg.num_minibatches, "minibatch_size": cfg.minibatch_size, "sizes": pi, "obs_dim": o,
            "turns": k2}


def time_general_kernels(tp, runner, obs, packed7, per_layer_shapes: dict, big_tp, big_runner) -> dict:
    """Row 1 in mode 7 on the serving rollout's state, and K4g, K3g and
    K2g at the slice's shapes (the trained 3 x 256 network; 8192 rows; the
    262,144-row batch; one epoch of 32 minibatches of 8192): device time,
    host time, the plain twin, the library call and the bound; K4g and K3g
    on the resident route, the per-layer route forced at the same shapes
    and the library call in turns (K3g also its kernel and its image build
    alone), and the resident kernels' ptxas; then the cluster route, the
    per-layer route forced and the library call at ``per_layer_shapes``
    (``time_1024_routes``, with K2g per layer) and at the 2 x 1024
    training path's shapes (``big_runner``'s trained network: K4g over 8192
    rows, K3g over its 262,144-row batch, K2g per layer over its epoch of
    32 x 8192, ``time_wide_epoch``), and the per-layer GEMM's ptxas."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_general, cuda_policy, cuda_sgd
    from pyflyt_tpu_torch.ops import cuda_quadx as cq

    bound, nbytes = roofline, tensor_bytes
    out = {}
    seed = torch.tensor([5], dtype=torch.int64, device="cuda")
    c7 = hover7_env().consts
    ms, host = time_ms(lambda: cq.packed_hover_step(packed7, seed, c7, 7, True), iters=200)
    plain, _ = time_ms(lambda: cq.packed_hover_step_plain(packed7, seed, c7, 7, True), iters=3, repeats=3,
                       device_timed=False)
    read, written = cq.hover_rows_moved(7)
    b_ms, by = bound((read + written) * 4 * N_ENVS + seed.numel() * 8, N_ENVS * cq.ops_per_env(c7, 7),
                     H100_F32_FLOPS)
    out["quadx_hover_step_mode7"] = {"ms": ms, "host_ms": host, "plain_ms": plain, "library_ms": None,
                                     "bound_ms": b_ms, "bound_by": by, "envs": N_ENVS}

    net = runner.network
    o, a = net.obs_dim, net.action_dim
    pi, vf = trunk_sizes(net.pi_trunk), trunk_sizes(net.vf_trunk)
    w = net.kernel_weights()
    obs = obs.contiguous()
    images = per_layer_images(net)
    check(cuda_general.forward_route(w) == "resident", "K4g at the slice's trunk: the resident route")
    # K4g on each route (a resident call 1 launch, a per-layer one 8, the library chain ~16: every turn stays
    # under the ~1000 a stream holds), in turns
    k4 = time_in_turns({
        "resident": (lambda: cuda_policy.policy_value_forward(obs, w), 60),
        "per_layer": (lambda: cuda_general.forward_per_layer(obs, w, *images), 60),
        "library": (library_forward(net, obs), 20)})
    plain, _ = time_ms(lambda: cuda_policy.policy_value_forward_plain(obs, w), iters=20, device_timed=False)
    b_ms, by = policy_bound(w, obs)
    common = {"plain_ms": plain, "library_ms": k4["library"]["ms"], "bound_ms": b_ms, "bound_by": by,
              "rows": obs.shape[0], "obs_dim": o}
    out["general_resident_forward"] = {"ms": k4["resident"]["ms"], "host_ms": k4["resident"]["host_ms"], **common,
                                       "per_layer_ms": k4["per_layer"]["ms"], "turns": k4}

    cfg = tp.config
    batch = cfg.batch_size
    rows = packed_rows(net, batch, seed=303)
    pl_ = pi_leaves(net)
    n_pi = len(pi)
    lay = cuda_general.resident_layout(o, pi, a)
    pack = lambda: cuda_general.pack_resident(pl_[: 2 * n_pi : 2], pl_[1 : 2 * n_pi : 2], pl_[2 * n_pi],  # noqa: E731
                                              pl_[2 * n_pi + 1])
    image = pack()
    kernel = lambda: cuda_general.launch_resident_logp(rows, image, lay, pl_[-1], o)  # noqa: E731
    check(cuda_general.logp_route(o, a, pi) == "resident", "K3g at the slice's trunk: the resident route")
    k3 = time_in_turns({
        "resident": (lambda: cuda_sgd.logp_forward(rows, pl_, o, vf_sizes=vf), 20),
        "per_layer": (lambda: cuda_general.logp_per_layer(rows, pl_, o), 20),
        "library": (library_logp(net, rows), 20),
        "kernel": (kernel, 20), "pack": (pack, 20)})
    plain, _ = time_ms(lambda: cuda_sgd.logp_forward_plain(rows, pl_, o), iters=3, repeats=3, device_timed=False)
    b_ms, by = bound(nbytes([rows, *pl_]) + batch * 4, cuda_sgd.logp_flops(batch, o, a, sizes=pi))
    common = {"plain_ms": plain, "library_ms": k3["library"]["ms"], "bound_ms": b_ms, "bound_by": by, "rows": batch}
    out["general_resident_logp"] = {"ms": k3["resident"]["ms"], "host_ms": k3["resident"]["host_ms"], **common,
                                    "kernel_ms": k3["kernel"]["ms"], "pack_ms": k3["pack"]["ms"],
                                    "per_layer_ms": k3["per_layer"]["ms"], "turns": k3}
    out["resident_ptxas"] = resident_ptxas()
    out.update(time_1024_routes(per_layer_shapes))
    big_net = big_runner.network
    big_rows = packed_rows(big_net, big_tp.config.batch_size, seed=308)
    out["cluster_2x1024"] = time_wide_routes(big_net, obs, big_rows, k4_iters=20, k3_iters=8)
    del big_rows
    out["fused_epoch_general_2x1024"] = time_wide_epoch(big_tp, big_runner)
    out["gemm_ptxas"] = gemm_ptxas()

    mbs = packed_rows(net, batch, seed=304).reshape(cfg.num_minibatches, cfg.minibatch_size, -1)
    stats = adv_stats(mbs[:, :, o + a + 1])
    leaves = [t.detach() for t in cuda_sgd.params_to_leaves(net)]
    opt = runner.opt_state
    t0 = opt.count.reshape(1)
    ecfg = tp.epoch_config(o)
    check(cuda_general.epoch_route(ecfg) == "resident", "K2g at the slice's trunk: the resident route")
    epoch = (mbs, stats, t0, leaves, opt.mu, opt.nu, ecfg)
    # K2g on each route (a resident call 129 kernels, a per-layer one 800) and the library's 32 updates, in turns
    k2 = epoch_turns({"resident": (lambda: cuda_sgd.fused_epoch(*epoch), 3),
                      "per_layer": (lambda: cuda_general.launch_epoch(*epoch, route="per_layer"), 1)},
                     library_update(net, mbs[0], stats[0], cfg), cfg.num_minibatches)
    plain, _ = time_ms(lambda: cuda_sgd.fused_epoch_plain(*epoch), iters=1, repeats=2, device_timed=False)
    state = nbytes(leaves) + nbytes(opt.mu) + nbytes(opt.nu)
    b_ms, by = bound(nbytes([mbs, stats, t0]) + 2 * state + cfg.num_minibatches * 5 * 4,
                     cuda_sgd.epoch_flops(batch, o, a, pi_sizes=pi, vf_sizes=vf))
    ms = k2["resident"]["ms"]
    out["general_resident_epoch"] = {
        "ms": ms, "host_ms": k2["resident"]["host_ms"], "ms_per_minibatch": ms / cfg.num_minibatches,
        "plain_ms": plain, "library_ms": k2["library"]["ms"], "library_ms_source": "torch.profiler kernel time",
        "library_host_wall_ms": k2["library"]["host_ms"], "per_layer_ms": k2["per_layer"]["ms"],
        "bound_ms": b_ms, "bound_by": by, "minibatches": cfg.num_minibatches, "minibatch_size": cfg.minibatch_size,
        "turns": k2, "ptxas": resident_epoch_ptxas(),
    }
    return out


# ---------------------------------------------------------------------------
# phases 59-61: the QuadX flight modes -1..10 and custom controllers, the
# mode-10 PID expert, the aviary (plain PyTorch on the card: no kernel of
# their own, so no launch counted)
# ---------------------------------------------------------------------------


QM_DRONES = 8192  # drones a mode and convention
QM_CPU_LANES = 256  # held lane by lane against the CPU
QM_STEPS = 120  # control steps: 1 s at the default 120 Hz
QM_ENU10_STEPS = 40  # ENU mode 10 (its gains were tuned for NED) is flown over a horizon where no lane diverges
# the view and the PWM against the CPU: atol + slope * step, the closed-loop
# curves of tests/test_torch_quadx_modes.py. The cascades' clips and
# saturations make some lanes chaotic (a thrust that swings from step to
# step), where the card's and the CPU's roundings part ways: every lane
# stays within the curves for QM_STRICT_STEPS, and the lanes beyond them
# over the whole run are counted and bounded, and flown again on the CPU in
# float64 as a witness: over those lanes the CPU's own f32 run must part
# from the f64 one by at least QM_WITNESS times the card-CPU gap (its median
# over the lanes), and the card's gap to the f64 run must stay within
# 1 / QM_WITNESS of the CPU's. Rounding alone parts them so; a fault of the
# card's that fires on saturated lanes would leave the CPU's f32 run near
# the f64 one and the card far from both
QM_VIEW_ATOL = (1e-4, 5e-5)
QM_PWM_ATOL = (2e-4, 1e-4)
QM_STRICT_STEPS = 15
QM_DIVERGED_SHARE = 1 / 8  # of the held lanes
QM_WITNESS = 1 / 8
QM_HEIGHT_TOL = 0.25  # m: the median |z - z_sp| of a height mode after 1 s
QM_VEL_TOL = 0.25  # m/s: mode 6's median ground-velocity error after 1 s
QM_CLOSE_RATIO = 0.9  # mode 10 (NED): the median distance to its target shrinks by a tenth in 1 s at least
EXPERT_ENVS = 2048  # the hovering CLI's --num_envs default
AV_COPIES = 4096  # batched copies of examples/core/02's fleet
AV_CPU_COPIES = 64
AV_STEPS = 240  # aviary steps (4 s: the fleet's lowest control rate is 60 Hz, 4 physics iterations a step)
AV_ATOL = (1e-3, 1e-4)  # view against the CPU: atol + slope * step
AV_DIVERGED_SHARE = 4 / 64
# the quadx's 60 Hz mode-7 loop oscillates (body rates of a few rad/s), so
# a rounding difference grows to the oscillation's size within the run: the
# quadx is held over its first steps, the rocket and fixedwing over all
AV_QUADX_HELD = 30


def qm_fleet(conv: str, n: int, seed: int):
    """``n`` airborne QuadX drones on the CPU, 2-6 m up (down in NED),
    tilted, yawed anywhere and moving, noise off."""
    import torch
    from pyflyt_tpu_torch.models import quadx

    cfg = quadx.QuadXConfig(orn_conv=conv, noisy_motors=False)
    g = torch.Generator().manual_seed(seed)
    sign = -1.0 if conv == "NED_FRD" else 1.0
    pos = torch.rand(n, 3, generator=g) * 4 - 2
    pos[:, 2] = sign * (2 + 4 * torch.rand(n, generator=g))
    orn = torch.rand(n, 3, generator=g) * 0.4 - 0.2
    orn[:, 2] = torch.rand(n, generator=g) * 6 - 3
    st = quadx.init_state(quadx.build_params(cfg, "cpu"), cfg, pos, orn)
    st.body.lin_vel = torch.rand(n, 3, generator=g) * 0.6 - 0.3
    st.body.ang_vel = torch.rand(n, 3, generator=g) * 0.6 - 0.3
    return cfg, st, g


def qm_setpoints(mode: int, conv: str, view, g):
    """Per-mode setpoints in each mode's units: raw PWM (-1, 8) and the
    mix's thrust (9) and mode 0's near the cf2x's hover PWM (0.364), the
    motors a few thousandths apart; rates (0, 2), angles (1, 3), body or
    ground velocities (4-6), a position and yaw near the spawn (7, 10);
    heights near the current one (2, 3, 4), climb rates (1, 5, 6). The
    open-loop modes stay near a hover because a drone that hits the ground
    at speed spins past the pqr drag's stable step and goes non-finite, in
    the JAX model as in the port (ROADMAP.md, item 35)."""
    import torch

    n = view.shape[0]
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=g)  # noqa: E731
    pos = view[:, 3]
    hover = u(0.34, 0.39)
    if mode in (-1, 8):
        return torch.stack([hover + u(-0.005, 0.005) for _ in range(4)], -1)
    if mode == 9:
        return torch.stack([u(-0.005, 0.005), u(-0.005, 0.005), u(-0.005, 0.005), hover], -1)
    if mode == 0:
        return torch.stack([u(-0.3, 0.3), u(-0.3, 0.3), u(-0.3, 0.3), hover * (-1.0 if conv == "NED_FRD" else 1.0)], -1)
    if mode in (7, 10):
        return torch.stack([pos[:, 0] + u(-1, 1), pos[:, 1] + u(-1, 1), u(-3, 3), pos[:, 2] + u(-0.5, 0.5)], -1)
    z = pos[:, 2] + u(-0.5, 0.5) if mode in (2, 3, 4) else u(-0.5, 0.5)
    if mode in (1, 3):
        return torch.stack([u(-0.1, 0.1), u(-0.1, 0.1), u(-3, 3), z], -1)
    if mode == 2:
        return torch.stack([u(-0.1, 0.1), u(-0.1, 0.1), u(-0.1, 0.1), z], -1)
    return torch.stack([u(-0.5, 0.5), u(-0.5, 0.5), u(-0.3, 0.3), z], -1)


def qm_commanded(mode: int, conv: str, st, sp, d0=None) -> dict:
    """What the mode commands, read off the final state of the whole fleet:
    the height error of the height modes, mode 6's ground-velocity error
    and mode 10's closing distance (NED)."""
    import torch

    out = {}
    view = st.read.view
    if mode in (2, 3, 4, 7, 10):
        out["median_height_err_m"] = float((view[:, 3, 2] - sp[:, 3]).abs().median())
    if mode == 6:
        v = st.body.lin_vel[:, :2]  # world ENU; NED's ground frame swaps x and y
        v = v.flip(-1) if conv == "NED_FRD" else v
        out["median_ground_vel_err_m_s"] = float(torch.linalg.vector_norm(v - sp[:, :2], dim=-1).median())
    if mode in (7, 10):
        d = torch.linalg.vector_norm(torch.stack([view[:, 3, 0] - sp[:, 0], view[:, 3, 1] - sp[:, 1],
                                                  view[:, 3, 2] - sp[:, 3]], -1), dim=-1)
        out["median_dist_m"], out["median_dist_start_m"] = float(d.median()), float(d0.median())
        yaw_err = torch.remainder(view[:, 1, 2] - sp[:, 2] + math.pi, 2 * math.pi) - math.pi
        out["median_yaw_err_rad"] = float(yaw_err.abs().median())
    return out


QM_CASES = tuple((conv, mode) for conv in ("ENU_FLU", "NED_FRD") for mode in range(-1, 11))


def qm_case(conv: str, mode: int, n: int):
    """One ``quadx_modes`` case on the CPU: its config, the fleet after
    ``set_mode`` with its setpoints, and the number of steps it flies (ENU
    mode 10 tips over within ~100 steps, its gains being NED's)."""
    from pyflyt_tpu_torch.models import quadx

    cfg, st, g = qm_fleet(conv, n, seed=5900 + mode)
    st = quadx.set_mode(st, mode, cfg)
    st.setpoint = qm_setpoints(mode, conv, st.read.view, g)
    steps = min(QM_ENU10_STEPS, QM_STEPS) if (mode == 10 and conv == "ENU_FLU") else QM_STEPS
    return cfg, st, steps


def qm_trail(cfg, st, mode: int, steps: int, dtype=None):
    """The view and PWM ``(steps, lanes, ...)`` after each of ``steps``
    control steps of ``st`` on the CPU: in the case's f32, or in ``dtype``
    (the float64 witness), returned as f32."""
    import torch
    from pyflyt_tpu_torch.core.state import tree_map
    from pyflyt_tpu_torch.models import quadx

    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        st = tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, st)
    params = quadx.build_params(cfg, "cpu")
    views, pwms = [], []
    for _ in range(steps):
        st, _ = quadx.step(st, params, cfg, mode)
        views.append(st.read.view.float())
        pwms.append(st.pwm.float())
    return torch.stack(views), torch.stack(pwms)


def sync(device: str) -> None:
    import torch

    if device != "cpu":
        torch.cuda.synchronize()


def check_quadx_modes(card: str, n: int = QM_DRONES, device: str = "cuda") -> dict:
    """``models/quadx.step`` in every mode -1..10, ENU and NED: ``n`` drones
    on ``device`` for QM_STEPS control steps from airborne spawns with
    per-mode setpoints (ENU mode 10 for QM_ENU10_STEPS), timed; then the
    first QM_CPU_LANES flown from the same states by the same code on the
    CPU (``qm_trail``) and held lane by lane: every lane within the
    closed-loop curves for QM_STRICT_STEPS, the lanes beyond them over the
    run counted and held against a float64 run of theirs (QM_WITNESS); then
    each mode's command checked on the whole fleet."""
    import torch
    from pyflyt_tpu_torch.core.state import tree_map
    from pyflyt_tpu_torch.models import quadx

    out = {}
    lanes = min(QM_CPU_LANES, n)
    for conv, mode in QM_CASES:
        cfg, st, held = qm_case(conv, mode, n)
        cpu_st = tree_map(lambda t: t[:lanes].clone(), st)
        sp = st.setpoint.to(device)
        d0 = torch.linalg.vector_norm(st.read.view[:, 3] - st.setpoint[:, [0, 1, 3]], dim=-1).to(device)
        st = tree_map(lambda t: t.to(device), st)
        params = quadx.build_params(cfg, device)
        zero_launches()
        trail = []
        sync(device)
        t0 = time.perf_counter()
        for _ in range(held):
            st, _ = quadx.step(st, params, cfg, mode)
            trail.append((st.read.view[:lanes].clone(), st.pwm[:lanes].clone()))
        sync(device)
        wall = time.perf_counter() - t0
        launches = read_launches()
        check(not any(launches.values()), f"quadx mode {mode}: a kernel launched {launches}")
        where = f"quadx_modes {conv} mode {mode}"
        check(bool(torch.isfinite(st.read.view).all() and torch.isfinite(st.pwm).all()), f"{where}: non-finite state")
        views = torch.stack([v for v, _ in trail]).cpu()
        pwms = torch.stack([p for _, p in trail]).cpu()
        cpu_views, cpu_pwms = qm_trail(cfg, cpu_st, mode, held)
        e_view = (views - cpu_views).abs().amax((2, 3))  # (steps, lanes)
        e_pwm = (pwms - cpu_pwms).abs().amax(2)
        k = torch.arange(held)[:, None]
        beyond = (e_view > QM_VIEW_ATOL[0] + QM_VIEW_ATOL[1] * k) | (e_pwm > QM_PWM_ATOL[0] + QM_PWM_ATOL[1] * k)
        parted = beyond.any(0).nonzero()[:, 0]
        n_div = len(parted)
        first_div = int(beyond.any(1).nonzero()[0]) if n_div else None
        check(first_div is None or first_div >= QM_STRICT_STEPS, f"{where}: a lane beyond the curves at step {first_div}")
        check(n_div <= QM_DIVERGED_SHARE * lanes, f"{where}: {n_div} of {lanes} lanes beyond the curves")
        check(n_div == 0 or held == QM_STEPS, f"{where}: a lane beyond the curves within its {held} steps")
        rec = {"max_abs_err_view": float(e_view.max()), "max_abs_err_pwm": float(e_pwm.max()),
               "diverged_lanes": n_div, "first_diverged_step": first_div, "steps": held,
               "ms_per_step": 1e3 * wall / held, "ground_contacts": int(st.contact.sum()),
               **qm_commanded(mode, conv, st, sp, d0)}
        if n_div:
            w_views, _ = qm_trail(cfg, tree_map(lambda t: t[parted].clone(), cpu_st), mode, held, torch.float64)
            gap = lambda a: float((a[:, parted] - w_views).abs().amax((0, 2, 3)).median())  # noqa: E731
            w = {"median_gap_card_cpu": float(e_view[:, parted].amax(0).median()),
                 "median_gap_cpu_f64": gap(cpu_views), "median_gap_card_f64": gap(views)}
            rec["f64_witness"] = w
            check(w["median_gap_cpu_f64"] >= QM_WITNESS * w["median_gap_card_cpu"],
                  f"{where}: the CPU's f32 run stays near the f64 one on the parted lanes {w}")
            check(w["median_gap_card_f64"] * QM_WITNESS <= w["median_gap_cpu_f64"],
                  f"{where}: the card far from the f64 run on the parted lanes {w}")
        if mode in (2, 3, 4, 7) or (mode == 10 and conv == "NED_FRD"):
            check(rec["median_height_err_m"] < QM_HEIGHT_TOL, f"{where}: height not held {rec}")
        if mode == 6:
            check(rec["median_ground_vel_err_m_s"] < QM_VEL_TOL, f"{where}: ground velocity not tracked {rec}")
        if mode == 10 and conv == "NED_FRD":
            check(rec["median_dist_m"] < QM_CLOSE_RATIO * rec["median_dist_start_m"],
                  f"{where}: does not close on its [x, y, psi, z] {rec}")
        out[f"{conv}/mode{mode}"] = rec
    return {"card": card, "drones": n, "cpu_lanes": lanes, "steps": QM_STEPS, "modes": out}


def mode10_expert(card: str, seed: int) -> dict:
    """The mod-hovering env at the fork's settings (NED, 80 Hz, wind and
    gusts on, noisy motors, random starts, unnormalized obs and actions)
    at EXPERT_ENVS envs flown by ``hovering_pid_expert`` for one full 10 s
    episode, in mode 10 (ga_pid) and in mode 7 (the position cascade)."""
    import torch
    from pyflyt_tpu_torch.envs.quadx_mod import QuadXModHoveringEnv, hovering_pid_expert

    n, device = EXPERT_ENVS, "cuda"
    out = {"card": card, "num_envs": n}
    for mode in (10, 7):
        env = QuadXModHoveringEnv(control_hz=80, orn_conv="NED_FRD", flight_mode=mode, simulate_wind=True,
                                  noisy_motors=True, normalize_obs=False, normalize_actions=False, device=device)
        gen = torch.Generator(device=device).manual_seed(seed + mode)
        st, _ = env.reset(n, gen)
        d0 = torch.linalg.vector_norm(st.state16[:, 12:15], dim=-1)
        total = torch.zeros(n, device=device)
        steps = env.max_steps + 1  # the truncation fires on the count before the step's increment
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            st, step_out = env.step(st, hovering_pid_expert(st.state16))
            total += step_out.reward
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        check(not any(launches.values()), f"mode{mode}_expert: a kernel launched {launches}")
        where = f"mode{mode}_expert"
        check(bool((st.termination | st.truncation).all()), f"{where}: an episode did not end")
        check(bool(torch.isfinite(total).all()), f"{where}: non-finite returns")
        d = torch.linalg.vector_norm(st.state16[:, 12:15], dim=-1)
        flown = ~st.collision
        check(bool(flown.any()), f"{where}: every env collided")
        rec = {
            "steps": steps, "mean_return": float(total.mean()),
            "collision_share": float(st.collision.float().mean()),
            "out_of_bounds_share": float(step_out.info["out_of_bounds"].float().mean()),
            "median_start_dist_m": float(d0.median()), "median_final_dist_m": float(d[flown].median()),
            "mean_final_dist_m": float(d[flown].mean()), "wall_s": wall, "env_steps_per_s": n * steps / wall,
        }
        check(rec["median_final_dist_m"] < rec["median_start_dist_m"], f"{where}: does not close on the target {rec}")
        out[f"mode{mode}"] = rec
    return out


def orbit_controller(view, setpoint):
    """examples/core/05_custom_controller.py: circles the origin by steering
    the position target along a 2 m ring."""
    import torch

    pos = view[..., 3, :]
    angle = torch.atan2(pos[..., 1], pos[..., 0]) + 0.3
    return torch.stack([2.0 * torch.cos(angle), 2.0 * torch.sin(angle), setpoint[..., 2], setpoint[..., 3]], dim=-1)


@dataclasses.dataclass
class ShearWind:
    """examples/core/09_wind.py's custom field: a crosswind growing with
    height."""

    strength: float

    def __call__(self, physics_step, position):
        import torch

        wind_x = self.strength * torch.log1p(torch.clamp(position[..., 2], min=0.0))
        return torch.stack([wind_x, torch.zeros_like(wind_x), torch.zeros_like(wind_x)], dim=-1)


def fly_for(av, st, seconds: float):
    steps = int(round(seconds * av.physics_hz / av.updates_per_step))
    for _ in range(steps):
        st = av.step(st)
    return st, steps


def aviary_examples(seed: int) -> dict:
    """The fleets of examples/core 02 (rocket, quadx at 60 Hz in mode 7,
    fixedwing), 05 (the orbit controller over mode 7, ENU, and over mode
    10, NED), 08 (rocket, primitive_drone quadx, fixedwing from rest) and
    09 (Gaussian gusts, and the shear field), one aviary each on the card
    with its noise on, for 1 s each."""
    import torch
    from pyflyt_tpu_torch.core import Aviary, DroneSpec
    from pyflyt_tpu_torch.core.wind import GaussianWind

    device = "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    t = lambda v: torch.tensor(v, device=device)  # noqa: E731
    out = {}

    def run(name, av, setpoints, seconds=1.0):
        st = av.set_all_setpoints(av.reset(gen), [t(s) for s in setpoints])
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, steps = fly_for(av, st, seconds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(not any(read_launches().values()), f"aviary {name}: a kernel launched")
        views = av.all_states(st)
        check(all(bool(torch.isfinite(v).all()) for v in views), f"aviary {name}: non-finite view")
        out[name] = {"steps": steps, "wall_s": wall, "aviary_steps_per_s": steps / wall,
                     "positions": [[round(x, 4) for x in v[3].tolist()] for v in views]}
        return st, views

    av = Aviary([[0.0, 0.0, 100.0], [3.0, 0.0, 1.0], [6.0, 0.0, 30.0]], [[0.0, 0.0, 0.0]] * 3, device=device,
                specs=(DroneSpec("rocket", 120), DroneSpec("quadx", 60, 7), DroneSpec("fixedwing", 120, 0)))
    _, v = run("02_multi_drone", av, [[0.0] * 7, [3.0, 0.0, 0.0, 1.5], [0.0, 0.0, 0.0, 0.6]])
    check(float(v[0][3, 2]) < 100.0 and float(v[2][3, 0]) > 16.0, "aviary 02: rocket falls, fixedwing cruises")
    check(float(torch.linalg.vector_norm(v[1][3] - t([3.0, 0.0, 1.5]))) < 0.6, "aviary 02: the quadx holds")
    for mode, conv, z in ((7, "ENU_FLU", 1.5), (10, "NED_FRD", -1.5)):
        av = Aviary([[2.0, 0.0, z]], [[0.0, 0.0, 0.0]], device=device,
                    specs=(DroneSpec("quadx", 120, mode, {"orn_conv": conv}, orbit_controller),))
        _, v = run(f"05_custom_controller_mode{mode}", av, [[0.0, 0.0, 0.0, z]])
        swept = math.atan2(float(v[0][3, 1]), float(v[0][3, 0]))
        out[f"05_custom_controller_mode{mode}"]["swept_rad"] = swept
        check(abs(swept) > 0.02, f"aviary 05 mode {mode}: no orbit ({swept})")
    av = Aviary([[0.0, 5.0, 5.0], [3.0, 3.0, 1.0], [5.0, 0.0, 1.0]], [[0.0, 0.0, 0.0]] * 3, device=device,
                specs=(DroneSpec("rocket"), DroneSpec("quadx", mode=7, options={"drone_model": "primitive_drone"}),
                       DroneSpec("fixedwing", mode=0, options={"starting_velocity": (0.0, 0.0, 0.0)})))
    st, _ = run("08_mixed_drones", av, [[0.0] * 7, [3.0, 3.0, 0.0, 1.5], [0.0, 0.0, 0.0, 0.0]])
    check([tuple(av.aux_state(st, i).shape) for i in range(3)] == [(9,), (4,), (6,)], "aviary 08: aux sizes")
    for name, wind in (("09_wind_gaussian", GaussianWind.init(gen, 1, device=device)), ("09_wind_shear", ShearWind(3.0))):
        av = Aviary([[0.0, 0.0, 5.0]], [[0.0, 0.0, 0.0]], device=device, specs=(DroneSpec("quadx", mode=7),),
                    wind_fn=wind)
        _, v = run(name, av, [[0.0, 0.0, 0.0, 5.0]])
        out[name]["drift_m"] = float(torch.linalg.vector_norm(v[0][3, :2]))
    check(out["09_wind_shear"]["drift_m"] > 0.01, "aviary 09: the shear field does not push the drone")
    return out


def register_quiet_handles() -> None:
    """Fixedwing and rocket handles with their noise off (the built-in
    ones draw it always), for the lane-by-lane check."""
    from pyflyt_tpu_torch.core import aviary as av_mod

    for name, field in (("fixedwing", "noisy_motors"), ("rocket", "noisy_boosters")):
        base = av_mod._HANDLE_TYPES[name]

        def init(self, spec, physics_hz, device, _base=base, _field=field):
            _base.__init__(self, spec, physics_hz, device)
            self.cfg = dataclasses.replace(self.cfg, **{_field: False})

        av_mod.register_drone_type(f"{name}_quiet", type(f"Quiet{name}", (base,), {"__init__": init}))


def aviary_fleet(device: str, copies: int):
    """examples/core/02's fleet (rocket, quadx at 60 Hz in mode 7,
    fixedwing) with the noise off, obstacle response on against three
    boxes: a plinth under the quadx (a disarmed one drops onto it), a deck
    under the fixedwing's glide (a descending plane slides along it) and a
    platform under the rocket."""
    import torch
    from pyflyt_tpu_torch.core import Aviary, DroneSpec
    from pyflyt_tpu_torch.core.camera import Boxes

    t = lambda v: torch.tensor(v, device=device)  # noqa: E731
    boxes = Boxes(centers=t([[3.5, 0.0, 0.25], [70.0, 0.0, 19.5], [0.0, 0.0, 70.0]]),
                  half_extents=t([[2.0, 1.5, 0.25], [60.0, 25.0, 0.5], [3.0, 3.0, 0.5]]),
                  rotations=torch.eye(3, device=device).expand(3, 3, 3).clone(),
                  colors=torch.ones(3, 4, device=device), visible=torch.ones(3, dtype=torch.bool, device=device))
    av = Aviary([[0.0, 0.0, 100.0], [3.0, 0.0, 1.0], [6.0, 0.0, 30.0]], [[0.0, 0.0, 0.0]] * 3, device=device,
                specs=(DroneSpec("rocket_quiet", 120), DroneSpec("quadx", 60, 7, {"noisy_motors": False}),
                       DroneSpec("fixedwing_quiet", 120, 0)),
                obstacles=boxes, obstacle_response=True)
    return av, av.reset(batch=copies)


def aviary_setpoints(copies: int, seed: int):
    """Per-copy setpoints on the CPU: the rocket's finlets, ignition (half
    the copies), throttle and gimbal; the quadx's [x, y, yaw, z]; the
    fixedwing's surfaces and throttle."""
    import torch

    g = torch.Generator().manual_seed(seed)
    u = lambda lo, hi, k=1: lo + (hi - lo) * torch.rand(copies, k, generator=g)  # noqa: E731
    rocket = torch.cat([u(-0.3, 0.3, 3), (u(0, 1) < 0.5).float(), u(0.2, 0.8), u(-0.3, 0.3, 2)], -1)
    quad = torch.cat([u(2.0, 5.0), u(-1.0, 1.0), u(-1.0, 1.0), u(1.0, 2.0)], -1)
    wing = torch.cat([u(-0.02, 0.02, 3), u(0.4, 0.9)], -1)
    return [rocket, quad, wing]


def aviary_run(device: str, copies: int, seed: int, held: int):
    """The batched 02 fleet for AV_STEPS steps on ``device``: per-copy
    setpoints, a third of the copies disarmed halfway. Returns the final
    state with the aviary, the wall seconds, and after each step the first
    ``held`` copies' views ``(steps, 3 drones, held, 4, 3)`` and contact
    flags ``(steps, held, 3)``."""
    import torch

    register_quiet_handles()
    sps = [s[:copies] for s in aviary_setpoints(AV_COPIES, seed)]  # the CPU's copies are the card's first
    armed = torch.ones(copies, 3, dtype=torch.bool)
    armed[::3] = False
    av, st = aviary_fleet(device, copies)
    st = av.set_all_setpoints(st, [s.to(device) for s in sps])
    views, contacts = [], []
    sync(device)
    t0 = time.perf_counter()
    for k in range(AV_STEPS):
        if k == AV_STEPS // 2:
            st = av.set_armed(st, armed.to(device))
        st = av.step(st)
        views.append(torch.stack([v[:held] for v in av.all_states(st)]))
        contacts.append(st.contact[:held].clone())
    sync(device)
    return av, st, time.perf_counter() - t0, torch.stack(views), torch.stack(contacts)


def aviary_batched(card: str, seed: int, copies: int = AV_COPIES, device: str = "cuda") -> dict:
    """``copies`` batched copies of the 02 fleet for AV_STEPS aviary steps,
    every copy with its own setpoints, a third of the copies disarmed
    halfway, obstacle response on, timed; then the first AV_CPU_COPIES
    flown by the same code on the CPU and held drone by drone: the rocket
    and the fixedwing over every step, the quadx over AV_QUADX_HELD."""
    import torch

    held, steps = min(AV_CPU_COPIES, copies), AV_STEPS
    zero_launches()
    av, st, wall, views, contacts = aviary_run(device, copies, seed, held)
    check(not any(read_launches().values()), "aviary batched: a kernel launched")
    check(all(bool(torch.isfinite(v).all()) for v in av.all_states(st)), "aviary batched: non-finite view")
    _, _, cpu_wall, cpu_views, cpu_contacts = aviary_run("cpu", held, seed, held)
    e = (views.cpu() - cpu_views).abs().amax((3, 4))  # (steps, 3 drones, held)
    e[AV_QUADX_HELD:, 1] = 0.0
    k = torch.arange(steps)[:, None, None]
    beyond = (e > AV_ATOL[0] + AV_ATOL[1] * k) | (contacts.cpu() != cpu_contacts).transpose(1, 2)
    beyond[AV_QUADX_HELD:, 1] = False
    n_div = int(beyond.any(0).any(0).sum())
    check(n_div <= AV_DIVERGED_SHARE * held, f"aviary batched: {n_div} of {held} copies beyond the curve")
    check(bool(cpu_contacts.any()), "aviary batched: no contact on the held copies")
    # a disarmed quadx keeps the read of its last armed step
    check(torch.equal(views[-1, 1, ::3], views[steps // 2 - 1, 1, ::3]), "aviary batched: a disarmed copy's read moved")
    return {"card": card, "copies": copies, "drones": 3 * copies, "steps": steps, "wall_s": wall,
            "aviary_steps_per_s": copies * steps / wall, "drone_steps_per_s": 3 * copies * steps / wall,
            "ms_per_step": 1e3 * wall / steps, "cpu_held_copies": held, "cpu_wall_s": cpu_wall,
            "quadx_held_steps": AV_QUADX_HELD,
            "max_abs_err_view": dict(zip(("rocket", "quadx", "fixedwing"), e.amax((0, 2)).tolist())),
            "diverged_copies": n_div, "contacts_last_step": int(st.contact.sum()),
            "held_contacts": int(cpu_contacts.sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write every result to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler tables of 32 rollout steps, a training iteration and a K2 call")
    ap.add_argument("--launch-records", action="store_true",
                    help="only print the grouped vehicle kernels' launch records (grid, block, registers, as "
                         "torch.profiler traces them) as one JSON line; the full run does this in a child process")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "pyflyt_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout: pyflyt_tpu_torch/ is not beside it", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if args.launch_records:
        print(json.dumps(measure_launches()), flush=True)
        return 0
    from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv, packed_autoreset_init
    from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
    from pyflyt_tpu_torch.ops import cuda_build, cuda_policy
    from pyflyt_tpu_torch.ops import cuda_quadx as cq
    from pyflyt_tpu_torch.rl import ppo
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: dict = {}

    # 1. the card
    card = card_line()
    print(card, flush=True)
    results["card"] = card
    results["device"] = torch.cuda.get_device_name(0)

    # 2. build every kernel of the path at once
    t0 = time.perf_counter()
    sources = {k.source for k in all_kernels().values()}
    libs = cuda_build.build(sorted(sources))
    results["build_s"] = time.perf_counter() - t0
    for src, lib in libs.items():
        log = lib.with_suffix(".log")
        usage = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln or "spill" in ln] if log.exists() else []
        print(f"built {src}: {lib.name}; ptxas: {' | '.join(usage) or 'cached build'}", flush=True)
    print(f"build_s {results['build_s']:.1f}", flush=True)
    # the launches of the vehicle kernels sized by GROUP and THREADS, as the
    # profiler traces them, from a child process on these libraries
    records = launch_records()
    results["launch_records"] = records
    print(json.dumps({"launch_records": records}), flush=True)

    # 3. hover step vs its twin
    err_a = max(check_hover_step(N_ENVS), check_hover_step(N_RAGGED), check_hover_step(HOVER_MIDWARP, staggered=True))
    results["hover_noise"] = check_hover_noise()
    print(f"hover step: max |kernel - twin| {err_a:.3g} (N={N_ENVS}, {N_RAGGED}, {HOVER_MIDWARP} staggered); "
          "noise spread ok, noisy repeat bit-identical", flush=True)

    # 4. policy forward vs its twin, then over the shape grid
    net = ActorCritic(21, 4, device="cuda", generator=torch.Generator().manual_seed(args.seed))
    err_b = max(*check_policy(net, N_ENVS), *check_policy(net, N_RAGGED))
    print(f"policy forward: max |kernel - twin| {err_b:.3g} (n={N_ENVS}, {N_RAGGED})", flush=True)
    results["policy_grid"] = check_policy_grid(args.seed)
    results["policy_mlp"] = policy_mlp_record()
    print(json.dumps({"policy_grid": results["policy_grid"], "policy_mlp": results["policy_mlp"]}), flush=True)

    # 5. the main path
    env = PackedQuadXHoverEnv(base=QuadXHoverEnv(device="cuda"))
    check(env.obs_size == net.obs_dim, "obs width")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    ars, obs = packed_autoreset_init(env, N_ENVS, gen)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    ars, obs, _ = ppo.rollout(net, env, ars, obs, 8, gen)  # warm-up
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    ars, obs, traj = ppo.rollout(net, env, ars, obs, ROLLOUT_STEPS, gen, refresh=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "quadx_hover_step": ROLLOUT_STEPS, "policy_value_forward": ROLLOUT_STEPS}
    check(launches == want, f"hover rollout launches {launches}, expected {want}")
    check(obs.shape == (N_ENVS, env.obs_size) and bool(torch.isfinite(obs).all()), "final obs")
    check(bool(torch.isfinite(traj.reward).all()), "non-finite rewards")
    check(bool(torch.isfinite(traj.value).all() and torch.isfinite(traj.log_prob).all()), "non-finite policy outputs")
    n_done = int(traj.done.sum())
    check(n_done > 0, "no lane finished an episode")
    reset_lanes = int((ars.env_state.packed[cq._STEP] < ROLLOUT_STEPS + 8).sum())
    check(reset_lanes > 0, "no lane was reset")
    rollout = {
        "card": card, "num_envs": N_ENVS, "steps": ROLLOUT_STEPS, "wall_s": wall,
        "env_steps_per_s": N_ENVS * ROLLOUT_STEPS / wall, "ms_per_step": 1e3 * wall / ROLLOUT_STEPS,
        "episodes_done": n_done, "lanes_reset": reset_lanes, "reset_s": reset_s,
        "mean_reward": float(traj.reward.mean()),
    }
    results["rollout"] = rollout
    print(json.dumps({"rollout": rollout}), flush=True)

    # 6. times and bounds at the main path's shapes
    packed = ars.env_state.packed.contiguous()
    seed = torch.zeros(1, dtype=torch.int64, device="cuda")
    c = env.consts
    ms_a, host_a = time_ms(lambda: cq.packed_hover_step(packed, seed, c, 0, True), iters=200)
    plain_a, _ = time_ms(lambda: cq.packed_hover_step_plain(packed, seed, c, 0, True), iters=3, repeats=3,
                         device_timed=False)
    # every row is read once and written once, except the reward row (re-armed
    # by the kernel, never read); plus the 8-byte seed
    bytes_a = (2 * cq.ROWS - 1) * 4 * N_ENVS + seed.numel() * 8
    ops_a = N_ENVS * cq.ops_per_env(c)
    t_bytes_a, t_ops_a = bytes_a / H100_BYTES_PER_S, ops_a / H100_F32_FLOPS

    forward = time_policy_forward(net, obs)
    kernels = [
        {
            "name": "quadx_hover_step", "route": "cuda",
            "source": "pyflyt_tpu_torch/csrc/quadx_hover_step.cu",
            "replaces": "pyflyt_tpu/ops/pallas_quadx.py:837",
            "launches": launches["quadx_hover_step"], "max_abs_err": err_a,
            "ms": ms_a, "plain_ms": plain_a, "bound_ms": 1e3 * max(t_bytes_a, t_ops_a),
            "bound_by": "bytes" if t_bytes_a >= t_ops_a else "operations",
            "library_ms": None, "host_ms": host_a, "ptxas": ptxas_usage("quadx_hover_step.cu"),
            "launch": records["quadx_hover_step"],
        },
        {
            "name": "policy_value_forward", "route": "cuda",
            "source": "pyflyt_tpu_torch/csrc/policy_value_forward.cu",
            "replaces": "pyflyt_tpu/ops/pallas_policy.py:35",
            "launches": launches["policy_value_forward"], "max_abs_err": err_b,
            **{k: forward[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        },
    ]
    # single steps, each ended by a synchronize: the steady steps and the
    # steps that refresh the reset cache (a plain-PyTorch reset of 8192
    # envs with 10 stabilization aviary steps, every 64th step)
    lat = step_latency(net, env, ars, obs, gen)
    results["step_latency"] = lat
    print(json.dumps({"step_latency": lat, "card": card}), flush=True)
    results["breakdown"] = {
        "ms_per_step": rollout["ms_per_step"],
        "steady_step_median_ms": lat["steady_median_ms"],
        "refresh_step_median_ms": lat["refresh_median_ms"],
        "kernel_device_ms_per_step": ms_a + forward["ms"],
        "wrapper_host_ms_per_step": host_a + forward["host_ms"],
        "kernel_device_share_of_steady_step": (ms_a + forward["ms"]) / lat["steady_median_ms"],
    }
    print(json.dumps({"breakdown": results["breakdown"], "card": card}), flush=True)
    if args.profile:
        results["profile"] = profile_rollout(net, env, ars, obs, gen)

    # 7. K3 vs its twin, then at the dogfight's row width, act 7 with the
    # L0's log_std range and 1,048,576 rows
    err_c = max(check_logp(net, n) for n in (BATCH, N_RAGGED))
    print(f"logp forward: max |kernel - twin| {err_c:.3g} (rows={BATCH}, {N_RAGGED})", flush=True)
    results["logp_shapes"] = check_logp_shapes(args.seed)
    err_c = max(err_c, *results["logp_shapes"].values())
    print(json.dumps({"logp_shapes": results["logp_shapes"]}), flush=True)

    # 8. K2 vs its twin at the hover shapes and EPOCH_SHAPES; two calls
    # bit-identical and the images Adam wrote against pack_trunk, at the
    # hover and the dogfight shapes; K2's time at EPOCH_TIMED
    epoch_checks = [check_epoch(net, n_mb, mb) for n_mb, mb in ((4, N_ENVS), (2, N_RAGGED))]
    epoch_checks += check_epoch_shapes(args.seed)
    results["epoch_checks"] = epoch_checks
    results["epoch_repeat"] = [check_epoch_repeat(net, 4, N_ENVS),
                               check_epoch_repeat(epoch_net(args.seed, 30, 4), 2, EPOCH_DF_ROWS)]
    results["epoch_times"] = time_epoch_shapes(args.seed)
    err_d = max(c["max_abs_err"] for c in epoch_checks)
    print(json.dumps({"epoch_checks": epoch_checks, "epoch_repeat": results["epoch_repeat"],
                      "epoch_times": results["epoch_times"]}), flush=True)

    # 9. the training path
    train, tp, runner = train_path(args.seed, card)
    results["train"] = train
    print(json.dumps({"train": train}), flush=True)
    results["train_loop"] = train_loop_smoke(args.seed)
    print(json.dumps({"train_loop": results["train_loop"]}), flush=True)

    # 10. times and bounds of K3 and K2 at the training path's shapes
    timed = time_sgd_kernels(tp, runner)
    results["sgd_times"] = timed
    if args.profile:
        results["profile_training"] = profile_training(tp, runner)
    for name, src, line, err in (
        ("logp_forward", "policy_value_forward.cu", "pyflyt_tpu/ops/pallas_sgd.py:173", err_c),
        ("fused_epoch", "fused_epoch.cu", "pyflyt_tpu/ops/pallas_sgd.py:269", err_d),
    ):
        t = timed[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"pyflyt_tpu_torch/csrc/{src}", "replaces": line,
            "launches": train["launches_per_iteration"][name], "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{k: t[k] for k in ("kernel_ms", "pack_ms", "ms_per_minibatch", "cuda_kernels_per_call") if k in t},
        })
    by_name = {k["name"]: k for k in kernels}
    by_name["fused_epoch"]["ptxas"] = ptxas_usage("fused_epoch.cu")
    for k in kernels:
        k["launches_per_train_iteration"] = train["launches_per_iteration"][k["name"]]

    # 11. K1 generic vs its twin: the envelope, then the draws
    results["generic_checks"] = check_generic_step()
    err_g = max(c["max_abs_err"] for c in results["generic_checks"].values())
    results["generic_draws"] = check_generic_draws()
    worst = {g: max(c["per_group"][g] for c in results["generic_checks"].values()) for g in ROW_GROUPS}
    print(json.dumps({"generic_checks": {k: v["max_abs_err"] for k, v in results["generic_checks"].items()},
                      "generic_worst_per_row_group": worst, "generic_draws": results["generic_draws"]}), flush=True)
    # 12. the step drop-in and the use_kernel env
    results["step_dropin"] = check_step_dropin()
    err_g = max(err_g, *results["step_dropin"].values())
    print(json.dumps({"step_dropin": results["step_dropin"]}), flush=True)
    # 13. the flagship rollout (main path of K1 generic)
    mod_roll, mod_state = mod_rollout(args.seed, card)
    results["mod_rollout"] = mod_roll
    print(json.dumps({"mod_rollout": mod_roll}), flush=True)
    # 14. the flagship training
    results["mod_train"], mod_tp, mod_runner = mod_train(args.seed, card)
    print(json.dumps({"mod_train": {k: v for k, v in results["mod_train"].items() if k != "iterations"}}), flush=True)
    print(json.dumps({"mod_train_iterations": results["mod_train"]["iterations"]}), flush=True)
    # 15. the CLI
    results["cli"] = cli_smoke(card)
    print(json.dumps({"cli": results["cli"]}), flush=True)

    # 16. K1 generic's time and bound at the recipe's shape (noise, gusts,
    # per-env base, mode 9, NED)
    genv = recipe_env()
    gc = genv.consts
    gpacked = mod_state.packed.contiguous()
    gseed = torch.tensor([11], dtype=torch.int64, device="cuda")
    check(torch.equal(cq.packed_step(gpacked, gseed, gc, 9, True), cq.packed_step(gpacked, gseed, gc, 9, True)),
          "noisy generic step at the recipe's variant: two calls differ")
    ms_g, host_g = time_ms(lambda: cq.packed_step(gpacked, gseed, gc, 9, True), iters=200)
    plain_g, _ = time_ms(lambda: cq.packed_step_plain(gpacked, gseed, gc, 9, True), iters=3, repeats=3,
                         device_timed=False)
    bytes_g = (cq.generic_rows_read(gc) + cq.ROWS) * 4 * N_ENVS + gseed.numel() * 8
    ops_g = N_ENVS * cq.generic_ops_per_env(gc)
    t_bytes_g, t_ops_g = bytes_g / H100_BYTES_PER_S, ops_g / H100_F32_FLOPS
    kernels.insert(1, {
        "name": "quadx_step", "route": "cuda", "source": "pyflyt_tpu_torch/csrc/quadx_step.cu",
        "replaces": "pyflyt_tpu/ops/pallas_quadx.py:816", "launches": mod_roll["launches"]["quadx_step"],
        "max_abs_err": err_g, "ms": ms_g, "plain_ms": plain_g, "bound_ms": 1e3 * max(t_bytes_g, t_ops_g),
        "bound_by": "bytes" if t_bytes_g >= t_ops_g else "operations", "library_ms": None,
        "host_ms": host_g, "launches_per_train_iteration": train["launches_per_iteration"]["quadx_step"],
        "launch": records["quadx_step"],
    })
    # 17. K1 generic in mode 7 vs its twin, and the mode-7 drop-in
    results["generic_mode7_checks"] = check_generic_mode7()
    err_g = max(err_g, *(c["max_abs_err"] for c in results["generic_mode7_checks"].values()))
    print(json.dumps({"generic_mode7_checks": {k: v["max_abs_err"] for k, v in
                                               results["generic_mode7_checks"].items()}}), flush=True)
    # 18. the row-4 kernel vs its twin (modes 7, 0, 8; N=8192 and 1000)
    results["waypoints_checks"] = check_waypoints_step()
    err_w = max(c["max_abs_err"] for k, c in results["waypoints_checks"].items() if k != "noise")
    print(json.dumps({"waypoints_checks": results["waypoints_checks"]}), flush=True)
    # 19. K4 at the waypoints env's obs width 33 vs its twin
    net33 = ActorCritic(33, 4, device="cuda", generator=torch.Generator().manual_seed(args.seed + 33))
    err_b = max(err_b, *check_policy(net33, N_ENVS), *check_policy(net33, N_RAGGED))
    print(f"policy forward at obs 33: max |kernel - twin| {err_b:.3g}", flush=True)
    # 20. the waypoints serving path (row 4 + K4, one launch each per step)
    wp_roll, wp_state, wp_net, wp_obs = wp_rollout(args.seed, card)
    results["wp_rollout"] = wp_roll
    print(json.dumps({"wp_rollout": wp_roll}), flush=True)
    # 21. PPO on the plain waypoints env (K1 generic in mode 7), then one
    # fused_sgd iteration there (K3 and K2 at obs 33)
    results["wp_train"] = wp_train(args.seed, card)
    print(json.dumps({"wp_train": results["wp_train"]}), flush=True)
    results["wp_fused_train"] = wp_fused_train(args.seed, card)
    print(json.dumps({"wp_fused_train": results["wp_fused_train"]}), flush=True)
    # 22. times and bounds at the waypoints path's shapes
    wt = time_waypoint_kernels(wp_state, wp_net, wp_obs)
    results["wp_kernel_times"] = wt
    kernels.insert(2, {
        "name": "quadx_waypoints_step", "route": "cuda", "source": "pyflyt_tpu_torch/csrc/quadx_waypoints_step.cu",
        "replaces": "pyflyt_tpu/ops/pallas_quadx.py:864", "launches": wp_roll["launches"]["quadx_waypoints_step"],
        "max_abs_err": err_w, **{k: wt["quadx_waypoints_step"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "host_ms": wt["quadx_waypoints_step"]["host_ms"],
        "ptxas": ptxas_usage("quadx_waypoints_step.cu"), "launch": records["quadx_waypoints_step"],
        "max_diverged_lanes": max(c["max_diverged_lanes"] for k, c in results["waypoints_checks"].items()
                                  if k != "noise"),
    })
    wp_launches = results["wp_train"]["launches_per_iteration"]
    for k in kernels:
        k["launches_per_wp_train_iteration"] = wp_launches[k["name"]]
        k["launches_per_wp_rollout"] = wp_roll["launches"][k["name"]]
        extra = {"quadx_step": "quadx_step_mode7", "policy_value_forward": "policy_value_forward_obs33",
                 "logp_forward": "logp_forward_obs33"}.get(k["name"])
        if extra:
            k["mode7" if k["name"] == "quadx_step" else "obs33"] = {
                f: wt[extra].get(f) for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    by_name = {k["name"]: k for k in kernels}
    by_name["quadx_step"].update(max_abs_err=err_g, ptxas=ptxas_usage("quadx_step.cu"))
    by_name["policy_value_forward"]["max_abs_err"] = err_b

    # K4, K3 and K2 at the recipe's shapes (obs 16; 8192 rows; 1,048,576
    # rows; 128 minibatches of 8192)
    recipe_times = {"policy_value_forward": time_policy_forward(mod_runner.network, mod_runner.obs),
                    **time_sgd_kernels(mod_tp, mod_runner, "recipe_sgd_times")}
    results["recipe_kernel_times"] = recipe_times
    mod_iters = results["mod_train"]["iterations"]
    for k in kernels:  # per iteration of the recipe's training, both paths
        k["launches_per_mod_default_iteration"] = mod_iters[1]["launches"][k["name"]]
        k["launches_per_mod_fused_iteration"] = mod_iters[-1]["launches"][k["name"]]
        if k["name"] in recipe_times:
            k["recipe"] = {f: recipe_times[k["name"]][f]
                           for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    # 23. row 5 vs its twin, the main path of rows 7 -> 5 (the drop-in), the noise
    results["fw_checks"], fw_step_launches = check_fw_step()
    err_fw5 = max(c["max_abs_err"] for k, c in results["fw_checks"].items() if k not in ("noise", "step_dropin"))
    print(json.dumps({"fw_checks": results["fw_checks"]}), flush=True)
    # 24. row 6 vs its twin (stock and a 25 m reach), every event firing
    results["fw_waypoints_checks"] = check_fw_waypoints()
    err_fw6 = max(c["max_abs_err"] for c in results["fw_waypoints_checks"].values())
    print(json.dumps({"fw_waypoints_checks": results["fw_waypoints_checks"]}), flush=True)
    # 25. the serving path: the archived policy (obs 35) through K4 and row 6
    from pyflyt_tpu_torch.rl import checkpoint

    rand35 = ActorCritic(35, 4, device="cuda", generator=torch.Generator().manual_seed(args.seed + 35))
    err_b = max(err_b, *(e for n in (FW_ENVS, N_RAGGED) for e in check_policy(rand35, n, policy_atol(rand35))))
    net35 = checkpoint.load_policy_npz(FW_POLICY, device="cuda")
    check(net35.obs_dim == 35, "archived fixedwing policy: obs width")
    atol35 = policy_atol(net35)
    e35 = [check_policy(net35, n, atol35) for n in (FW_ENVS, N_RAGGED)]
    mean_err35, value_err35 = max(e[0] for e in e35), max(e[1] for e in e35)
    err_35 = max(mean_err35, value_err35)
    results["k4_archived_policy"] = {"max_abs_err": err_35, "mean_err": mean_err35, "value_err": value_err35,
                                     "atol": atol35}
    print(f"policy forward at obs 35: max |kernel - twin| {err_b:.3g} (random weights); {err_35:.3g} "
          f"(the archived policy: mean {mean_err35:.3g}, value {value_err35:.3g}; tolerance {atol35})", flush=True)
    fw_roll, fw_state, fw_obs = fw_rollout(net35, args.seed, card)
    results["fw_rollout"] = fw_roll
    print(json.dumps({"fw_rollout": fw_roll}), flush=True)
    # 26. the archived policy's 256-episode evaluation
    results["fw_eval"] = fw_eval(net35, args.seed, card)
    print(json.dumps({"fw_eval": results["fw_eval"]}), flush=True)
    # 27. the r5 recipe on the plain env
    results["fw_train"] = fw_train(args.seed, card)
    print(json.dumps({"fw_train": results["fw_train"]}), flush=True)
    # 28. times and bounds at the slice's shapes
    ft = time_fw_kernels(fw_state, net35, fw_obs)
    results["fw_kernel_times"] = ft
    for name, line, launches_, err, extra in (
        ("fixedwing_step", "pyflyt_tpu/ops/pallas_fixedwing.py:647", fw_step_launches["fixedwing_step"], err_fw5,
         {"also_replaces": "pyflyt_tpu/ops/pallas_fixedwing.py:692 (step: pack -> this kernel -> unpack)",
          "main_path": f"cuda_fixedwing.step, {FW_DROPIN_STEPS} steps x 2 vehicles x 2 modes"}),
        ("fixedwing_waypoints_step", "pyflyt_tpu/ops/pallas_fixedwing.py:663",
         fw_roll["launches"]["fixedwing_waypoints_step"], err_fw6,
         {"main_path": f"fw_rollout, {FW_ROLLOUT_STEPS} steps x {FW_ENVS} envs",
          "max_diverged_lanes": max(c["max_diverged_lanes"] for c in results["fw_waypoints_checks"].values())}),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": "pyflyt_tpu_torch/csrc/fixedwing_step.cu", "replaces": line,
            "launches": launches_, "max_abs_err": err,
            **{k: ft[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
            "host_ms": ft[name]["host_ms"], "ptxas": ft["ptxas"], "launch": records[name], **extra,
        })
    by_name["policy_value_forward"].update(max_abs_err=err_b, obs35={
        f: ft["policy_value_forward_obs35"].get(f) for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    for k in kernels:
        k["launches_per_fw_rollout"] = fw_roll["launches"][k["name"]]
        k["launches_per_fw_eval"] = results["fw_eval"]["launches"][k["name"]]
        k["launches_per_fw_step_dropin"] = fw_step_launches[k["name"]]

    # 29. K7 vs its twin (4096 and 999 arenas, every trap firing), its noise
    results["df_checks"] = check_df_step()
    err_df = max(c["max_abs_err"] for k, c in results["df_checks"].items() if k != "noise")
    print(json.dumps({"df_checks": results["df_checks"]}), flush=True)
    # 30. the serving path: the league's s100 (obs 30) through K4 and K7 in
    # the self-play env, cached arena auto-reset; the plain MA QuadX env
    s100 = checkpoint.load_policy_npz(DF_POLICY, device="cuda")
    init = checkpoint.load_policy_npz(DF_INIT, device="cuda")
    check(s100.obs_dim == 30 and init.obs_dim == 30, "league policies: obs width")
    atol30 = policy_atol(s100)
    e30 = [check_policy(s100, n, atol30) for n in (2 * DF_ARENAS, N_RAGGED)]
    results["k4_league_policy"] = {"mean_err": max(e[0] for e in e30), "value_err": max(e[1] for e in e30),
                                   "atol": atol30}
    err_b = max(err_b, *(max(e) for e in e30))
    print(json.dumps({"k4_league_policy": results["k4_league_policy"]}), flush=True)
    df_roll, df_packed = df_rollout(s100, args.seed, card)
    results["df_rollout"] = df_roll
    print(json.dumps({"df_rollout": df_roll}), flush=True)
    # 31. the league's duels on the card
    results["df_duel"] = df_duel(s100, init, args.seed, card)
    print(json.dumps({"df_duel": results["df_duel"]}), flush=True)
    # 32. the league recipe, default and fused_sgd
    results["df_train"] = df_train(args.seed, card)
    print(json.dumps({"df_train": results["df_train"]}), flush=True)
    # 33. K7's time and bound at the league's shape
    dt = time_df_kernel(df_packed)
    results["df_kernel_times"] = dt
    kernels.append({
        "name": "dogfight_step", "route": "cuda", "source": "pyflyt_tpu_torch/csrc/dogfight_step.cu",
        "replaces": "pyflyt_tpu/ops/pallas_dogfight.py:259", "launches": df_roll["launches"]["dogfight_step"],
        "max_abs_err": err_df, **{k: dt[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
        "host_ms": dt["host_ms"], "ptxas": dt["ptxas"], "launch": records["dogfight_step"],
        "main_path": f"df_rollout, {DF_ROLLOUT_STEPS} steps x {2 * DF_ARENAS} agent rows",
        "max_diverged_lanes": {k: c["max_diverged_lanes"] for k, c in results["df_checks"].items() if k != "noise"},
    })
    by_name["policy_value_forward"]["max_abs_err"] = err_b
    for k in kernels:
        k["launches_per_df_rollout"] = df_roll["launches"][k["name"]]
        for path in ("default", "fused_sgd"):
            k[f"launches_per_df_train_{path}_iteration"] = results["df_train"][path]["launches_per_iteration"][k["name"]]

    # 34. row 8 vs its twin (a lit burn, a fuel-out burn; its main path, the
    # settle chains on the ground and on pads) and row 9 with every trap firing
    rk8, rk_step_launches = check_rk_step()
    results["rk_checks"] = {"row8": rk8, "row9": check_rk_landing()}
    err_rk8 = max(c["max_abs_err"] for k, c in rk8.items() if k != "noise")
    err_rk9 = max(c["max_abs_err"] for k, c in results["rk_checks"]["row9"].items() if k != "noise")
    print(json.dumps({"rk_checks": results["rk_checks"]}), flush=True)
    # 35. K4 at obs 33 with the archived L0 weights
    l0 = checkpoint.load_policy_npz(RK_POLICY, device="cuda")
    check(l0.obs_dim == 33 and l0.action_dim == 7 and l0.log_std_range == (-3.5, -1.0), "the L0 policy's widths")
    atol33 = policy_atol(l0)
    e33 = [check_policy(l0, n, atol33) for n in (RK_ENVS, N_RAGGED)]
    results["k4_rocket_policy"] = {"mean_err": max(e[0] for e in e33), "value_err": max(e[1] for e in e33),
                                   "atol": atol33}
    err_b = max(err_b, *(max(e) for e in e33))
    print(json.dumps({"k4_rocket_policy": results["k4_rocket_policy"]}), flush=True)
    # 36. the serving path: L0 through K4 and row 9 in 8192 stock envs
    rk_roll, rk_state = rk_rollout(l0, args.seed, card)
    results["rk_rollout"] = rk_roll
    print(json.dumps({"rk_rollout": rk_roll}), flush=True)
    # 37. the L0 policy's 256-episode landing eval
    results["rk_eval"] = rk_eval(l0, args.seed, card)
    print(json.dumps({"rk_eval": results["rk_eval"]}), flush=True)
    # 38. rows 8 and 9 against their bounds
    rt = time_rk_kernels(rk_state)
    results["rk_kernel_times"] = rt
    for name, line, launches_, err, extra in (
        ("rocket_step", "pyflyt_tpu/ops/pallas_rocket.py:836", rk_step_launches["rocket_step"], err_rk8,
         {"main_path": f"the settle chains of rk_checks, {RK_STEPS} steps x 2 x {RK_ENVS} envs",
          "max_diverged_lanes": {k: rk8[k]["max_diverged_lanes"] for k in ("settle_ground", "settle_pad")}}),
        ("rocket_landing_step", "pyflyt_tpu/ops/pallas_rocket.py:851", rk_roll["launches"]["rocket_landing_step"],
         err_rk9, {"main_path": f"rk_rollout, {RK_ROLLOUT_STEPS} steps x {RK_ENVS} envs",
                   "max_diverged_lanes": {k: c["max_diverged_lanes"] for k, c in results["rk_checks"]["row9"].items()
                                          if k != "noise"}}),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": "pyflyt_tpu_torch/csrc/rocket_step.cu", "replaces": line,
            "launches": launches_, "max_abs_err": err,
            **{k: rt[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
            "host_ms": rt[name]["host_ms"], "ptxas": rt["ptxas"], "launch": records[name], **extra,
        })
    by_name["policy_value_forward"]["max_abs_err"] = err_b
    for k in kernels:
        k["launches_per_rk_rollout"] = rk_roll["launches"][k["name"]]
        k["launches_per_rk_eval"] = results["rk_eval"]["launches"][k["name"]]
        k["launches_per_rk_settle"] = rk_step_launches[k["name"]]
    # 39. the narrow trunks' kernels against their twins: K4n and K3n over
    # the grid, K2n at the trajectory recipes' minibatches and on repeat
    results["narrow_grid"] = check_narrow_grid(args.seed)
    print(json.dumps({"narrow_grid": results["narrow_grid"]}), flush=True)
    results["narrow_epochs"] = check_narrow_epochs(args.seed)
    print(json.dumps({"narrow_epochs": results["narrow_epochs"]}), flush=True)
    # 40. the archived slow policy: K4n at its weights, then its serving rollout
    traj_net = checkpoint.load_policy_npz(TRAJ_POLICY, device="cuda")
    check(trunk_sizes(traj_net.pi_trunk) == TRAJ_TRUNK and traj_net.obs_dim == 16 and
          cuda_policy._kernel_family(traj_net.kernel_weights()) == "narrow", "the archived slow policy's widths")
    atol_t = policy_atol(traj_net)
    e_t = [check_policy(traj_net, n, atol_t) for n in (TRAJ_ENVS, N_RAGGED)]
    r4 = traj_r4_config()
    results["k4n_traj_policy"] = {"mean_err": max(e[0] for e in e_t), "value_err": max(e[1] for e in e_t),
                                  "atol": atol_t,
                                  "k3n_logp_err_rows_262144": check_logp(traj_net, r4.batch_size, atol=logp_atol)}
    print(json.dumps({"k4n_traj_policy": results["k4n_traj_policy"]}), flush=True)
    results["traj_serving"], traj_obs = traj_serving(traj_net, args.seed, card)
    print(json.dumps({"traj_serving": results["traj_serving"]}), flush=True)
    # 41. its 256-episode deterministic eval against the archive's floors
    results["traj_eval"] = traj_eval(traj_net, args.seed, card)
    print(json.dumps({"traj_eval": results["traj_eval"]}), flush=True)
    # 42. training: the fast CLI's defaults (f32) and the r4 slow recipe (fused)
    results["traj_train"], _, _ = traj_train(args.seed, card)
    print(json.dumps({"traj_train": results["traj_train"]}), flush=True)
    # 43. ppo_20m_r4.py's SMALL fused arm: row 2, K3n and K2n
    results["small_arm_train"] = small_arm_train(args.seed, card)
    print(json.dumps({"small_arm_train": results["small_arm_train"]}), flush=True)
    # 44. K4n, K3n and K2n against their bounds at the trajectory shapes
    nt = time_narrow_kernels(traj_net, traj_obs, packed_rows(traj_net, r4.batch_size, seed=302),
                             (r4.num_minibatches, r4.minibatch_size, r4))
    nt["narrow_policy_value_forward_obs19"] = time_policy_forward(
        narrow_net(args.seed + 19, 19, 4), traj_obs.new_zeros((TRAJ_ENVS, 19)).normal_(), lib_iters=20)
    results["narrow_kernel_times"] = nt
    print(json.dumps({"narrow_kernel_times": nt, "card": card}), flush=True)
    ng, ne = results["narrow_grid"], results["narrow_epochs"]
    r4_launches = results["traj_train"]["r4_slow_fused"]["launches_per_iteration"]
    for name, src, line, launches_, err, extra in (
        ("narrow_policy_value_forward", "policy_narrow.cu", "pyflyt_tpu/ops/pallas_policy.py:35",
         results["traj_serving"]["launches"]["narrow_policy_value_forward"],
         max(ng["max_mean_err"], ng["max_value_err"], results["k4n_traj_policy"]["mean_err"],
             results["k4n_traj_policy"]["value_err"]),
         {"main_path": f"traj_serving, {TRAJ_ROLLOUT_STEPS} steps x {TRAJ_ENVS} envs, obs 16",
          "obs19": {f: nt["narrow_policy_value_forward_obs19"][f] for f in
                    ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}),
        ("narrow_logp_forward", "policy_narrow.cu", "pyflyt_tpu/ops/pallas_sgd.py:173",
         r4_launches["narrow_logp_forward"],
         max(ng["max_logp_err"], results["k4n_traj_policy"]["k3n_logp_err_rows_262144"]),
         {"main_path": f"traj_train r4_slow_fused, {r4.batch_size} rows",
          **{k: nt["narrow_logp_forward"][k] for k in ("kernel_ms", "pack_ms")}}),
        ("fused_epoch_narrow", "fused_epoch_narrow.cu", "pyflyt_tpu/ops/pallas_sgd.py:269",
         r4_launches["fused_epoch_narrow"], ne["max_abs_err"],
         {"main_path": f"traj_train r4_slow_fused, {r4.num_minibatches} x {r4.minibatch_size} rows an epoch",
          "ptxas": ptxas_usage("fused_epoch_narrow.cu"),
          **{k: nt["fused_epoch_narrow"][k] for k in ("ms_per_minibatch", "cuda_kernels_per_call")}}),
    ):
        t = nt[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"pyflyt_tpu_torch/csrc/{src}", "replaces": line,
            "launches": launches_, "max_abs_err": err,
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}, "host_ms": t["host_ms"],
            **extra,
        })
    by_name = {k["name"]: k for k in kernels}
    by_name["narrow_policy_value_forward"]["ptxas"] = ptxas_usage("policy_narrow.cu")
    for k in kernels:
        k["launches_per_traj_serving"] = results["traj_serving"]["launches"][k["name"]]
        k["launches_per_traj_eval"] = results["traj_eval"]["launches"][k["name"]]
        k["launches_per_traj_r4_iteration"] = r4_launches[k["name"]]
        k["launches_per_small_arm_iteration"] = results["small_arm_train"]["launches_per_iteration"][k["name"]]
    # 45. the camera on the card against the CPU, at the recipe's 32 px and the env's default 128 px
    results["vision_render"] = {f"{res}px": check_render(res, args.seed + 45, card) for res in (GATES_RES, 128)}
    print(json.dumps({"vision_render": results["vision_render"]}), flush=True)
    # 46. the archived r4 policy's VisionActorCritic on the card against the CPU
    gates_net = checkpoint.load_policy_npz(GATES_POLICY, device="cuda")
    check(gates_net.image_shape == (4, GATES_RES, GATES_RES) and gates_net.conv_features == (16, 32, 32),
          "the archived gates policy's layout")
    results["vision_net"] = check_vision_net(gates_net, args.seed + 46, card)
    print(json.dumps({"vision_net": results["vision_net"]}), flush=True)
    # 47. its 256-episode eval, plain physics and through K1 generic (row 2)
    results["gates_eval"] = {"plain": gates_eval(gates_net, False, args.seed, card),
                             "use_kernel": gates_eval(gates_net, True, args.seed, card)}
    print(json.dumps({"gates_eval": results["gates_eval"]}), flush=True)
    # 48. one r4-recipe iteration, cached (64) and exact (0) resets
    results["gates_train"] = gates_train(args.seed, card)
    print(json.dumps({"gates_train": results["gates_train"]}), flush=True)
    # 49. the gates_vision CLI
    results["gates_cli"] = gates_cli(card)
    print(json.dumps({"gates_cli": results["gates_cli"]}), flush=True)
    # 50. one gates rollout step split
    results["gates_profile"] = gates_profile(gates_net, args.seed, card)
    print(json.dumps({"gates_profile": results["gates_profile"]}), flush=True)
    # 51. row 1 in mode 7 vs its twin (8192, 1000, a mid-warp 4093 truncating at staggered steps), its noise
    h7 = {f"N{n}": check_hover_mode7(n, staggered=n == HOVER_MIDWARP) for n in (N_ENVS, N_RAGGED, HOVER_MIDWARP)}
    err_h7 = max(c["max_abs_err"] for c in h7.values())
    h7["noise"] = check_hover_noise(7)
    results["hover7_checks"] = h7
    print(json.dumps({"hover7_checks": h7}), flush=True)
    # 52-53. the general family (K4g, K3g, K2g) against its twins, K2g on repeat, K3g = K2g's forward
    results["general_grid"] = check_general_grid(args.seed)
    print(json.dumps({"general_grid": results["general_grid"]}), flush=True)
    results["general_epochs"] = check_general_epochs(args.seed)
    print(json.dumps({"general_epochs": results["general_epochs"]}), flush=True)
    # 54. the slice's serving path: row 1 in mode 7 and K4g at 3 x 256
    results["hover7_serving"], h7_ars, h7_obs, _ = hover7_serving(args.seed, card)
    results["hover7_serving"]["wide_2x1024"] = hover7_serving_wide(args.seed, card)
    print(json.dumps({"hover7_serving": results["hover7_serving"]}), flush=True)
    # 55. the slice's training path at 3 x 256 (row 1, K4g, K3g, K2g), at 2 x 256 (the wide family) and at
    # 2 x 1024 (K4g and K3g on the cluster route, K2g per layer)
    results["hover7_train"], h7_tp, h7_runner, h7_big_tp, h7_big_runner = hover7_train(args.seed, card)
    print(json.dumps({"hover7_train": results["hover7_train"]}), flush=True)
    # 56. row 1 in mode 7, K4g, K3g and K2g against their bounds at the slice's shapes
    gt = time_general_kernels(h7_tp, h7_runner, h7_obs, h7_ars.env_state.packed.contiguous(),
                              results["traj_train"]["other_trunks"]["(1024,)"]["shapes"], h7_big_tp, h7_big_runner)
    results["general_kernel_times"] = gt
    print(json.dumps({"general_kernel_times": gt, "card": card}), flush=True)
    # 57. K3g and K2g at the training path's own shapes, on its trained 3 x 256 network (and K2g on the 2 x 1024
    # one): K3g against its twin
    # over the 262,144-row batch, K2g against its twin over two minibatches of 8192 rows from the training's
    # own Adam state (the seeded 1e-3 moments would dwarf this network's small gradients: the epoch's share of
    # a moment is then one f32 ulp, 2.5e-3 of it, whatever computes it), and its epoch of 32 such minibatches
    # bit for bit as 32 chained one-minibatch calls
    h7_net, h7_cfg = h7_runner.network, h7_tp.config
    gm = {"k3g_logp_err_rows_262144": check_logp(h7_net, h7_cfg.batch_size, atol=logp_atol),
          "k2g_epoch_2x8192": check_epoch(h7_net, 2, h7_cfg.minibatch_size, h7_cfg.log_std_range, GENERAL_MU_REL,
                                          opt=h7_runner.opt_state),
          "k2g_epoch_32x8192_chained": check_general_chained(h7_net, h7_cfg.num_minibatches, h7_cfg.minibatch_size,
                                                             h7_cfg.log_std_range),
          # the 2 x 1024 path's K2g (per layer) on its own trained network: 4 x 8192 rows as 4 chained
          # one-minibatch calls, and on repeat (with K3g's log-probs, approx_kl 0)
          "k2g_2x1024_epoch_4x8192_chained": check_general_chained(
              h7_big_runner.network, 4, h7_cfg.minibatch_size, h7_big_tp.config.log_std_range),
          "k2g_2x1024_repeat": check_general_consistency(h7_big_runner.network, 4, h7_cfg.minibatch_size)}
    results["general_main_path_checks"] = gm
    print(json.dumps({"general_main_path_checks": gm}), flush=True)
    # 58. K4g and K3g on the cluster route against their twins and bit for bit the per-layer route's
    results["general_cluster"] = check_general_cluster(args.seed)
    print(json.dumps({"general_cluster": results["general_cluster"]}), flush=True)
    # 59-61: each card run is timed alone, its CPU twin computed after it
    t_new = time.perf_counter()
    # 59. the PID experts over full mod-hovering episodes, mode 10 and mode 7
    results["mode10_expert"] = mode10_expert(card, args.seed)
    print(json.dumps({"mode10_expert": results["mode10_expert"]}), flush=True)
    # 60. models/quadx in every flight mode, ENU and NED, against the CPU
    results["quadx_modes"] = check_quadx_modes(card)
    print(json.dumps({"quadx_modes": results["quadx_modes"]}), flush=True)
    # 61. the aviary: the examples' fleets, then the batched 02 fleet against the CPU
    results["aviary"] = {"examples": aviary_examples(args.seed), "batched": aviary_batched(card, args.seed)}
    print(json.dumps({"aviary": results["aviary"]}), flush=True)
    results["phases_59_61_s"] = time.perf_counter() - t_new
    print(json.dumps({"phases_59_61_s": results["phases_59_61_s"]}), flush=True)
    serving = results["hover7_serving"]["launches"]
    training = results["hover7_train"]["general_3x256"]["launches_per_iteration"]
    by_name["quadx_hover_step"]["mode7"] = {
        **{f: gt["quadx_hover_step_mode7"][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                         "host_ms")},
        "max_abs_err": err_h7, "launches": serving["quadx_hover_step"], "launch": records["quadx_hover_step_mode7"],
        "main_path": f"hover7_serving, {HOVER7_ROLLOUT_STEPS} steps x {N_ENVS} envs"}
    gg, ge, gc = results["general_grid"], results["general_epochs"], results["general_cluster"]
    wide_trunk = results["traj_train"]["other_trunks"]["(1024,)"]["launches_per_iteration"]
    past_trunk = results["traj_train"]["other_trunks"][str(GENERAL_PAST)]["launches_per_iteration"]
    big = results["hover7_train"]["general_2x1024"]["launches_per_iteration"]
    big_serving = results["hover7_serving"]["wide_2x1024"]["launches"]
    rptx, cptx = gt["resident_ptxas"], gt["cluster_ptxas"]
    for name, src, line, launches_, err, extra in (
        ("general_resident_forward", "policy_general.cu", "pyflyt_tpu/ops/pallas_policy.py:35",
         serving["general_resident_forward"],
         max(gg["by_route"]["resident"]["mean"], gg["by_route"]["resident"]["value"]),
         {"main_path": f"hover7_serving, {HOVER7_ROLLOUT_STEPS} steps x {N_ENVS} envs, obs 21, 3 x 256",
          "per_layer_ms": gt["general_resident_forward"]["per_layer_ms"],
          "kernels_per_call": records["general_resident"]["k4g"],
          "resident_ptxas": {k: v for k, v in rptx.items() if k.startswith("k4g")}}),
        ("general_resident_logp", "policy_general.cu", "pyflyt_tpu/ops/pallas_sgd.py:173",
         training["general_resident_logp"], max(gg["by_route"]["resident"]["logp"], gm["k3g_logp_err_rows_262144"]),
         {"main_path": f"hover7_train general_3x256, {gt['general_resident_logp']['rows']} rows",
          **{f: gt["general_resident_logp"][f] for f in ("kernel_ms", "pack_ms", "per_layer_ms")},
          "kernels_per_call": records["general_resident"]["k3g"],
          "resident_ptxas": {k: v for k, v in rptx.items() if k.startswith("k3g")}}),
        ("general_cluster_forward", "policy_general.cu", "pyflyt_tpu/ops/pallas_policy.py:35",
         big_serving["general_cluster_forward"], max(gg["by_route"]["cluster"]["mean"],
                                                     gg["by_route"]["cluster"]["value"], gc["max_mean_err"],
                                                     gc["max_value_err"]),
         {"main_path": f"hover7_serving wide_2x1024, {HOVER7_WIDE_STEPS} steps x {N_ENVS} envs, obs 21, 2 x 1024",
          "per_layer_ms": gt["cluster_2x1024"]["general_cluster_forward"]["per_layer_ms"],
          "at_1024": {k: gt["general_cluster_forward"][k]
                      for k in ("ms", "per_layer_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "rows")},
          "launches_per_other_trunks_1024_iteration": wide_trunk["general_cluster_forward"],
          "kernels_per_call": records["general_resident"]["k4g_cluster"],
          "cluster_ptxas": {k: v for k, v in cptx.items() if k.startswith("k4g")}}),
        ("general_cluster_logp", "policy_general.cu", "pyflyt_tpu/ops/pallas_sgd.py:173",
         big["general_cluster_logp"], max(gg["by_route"]["cluster"]["logp"], gc["max_logp_err"]),
         {"main_path": f"hover7_train general_2x1024, {gt['cluster_2x1024']['general_cluster_logp']['rows']} rows",
          **{f: gt["cluster_2x1024"]["general_cluster_logp"][f] for f in ("kernel_ms", "pack_ms", "per_layer_ms")},
          "at_1024": {k: gt["general_cluster_logp"][k]
                      for k in ("ms", "kernel_ms", "pack_ms", "per_layer_ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by", "rows")},
          "launches_per_other_trunks_1024_iteration": wide_trunk["general_cluster_logp"],
          "kernels_per_call": records["general_resident"]["k3g_cluster"],
          "cluster_ptxas": {k: v for k, v in cptx.items() if k.startswith("k3g")}}),
        ("general_policy_value_forward", "policy_general.cu", "pyflyt_tpu/ops/pallas_policy.py:35",
         past_trunk["general_policy_value_forward"],
         max(gg["by_route"]["per_layer"]["mean"], gg["by_route"]["per_layer"]["value"]),
         {"main_path": "traj_train other_trunks (4128,), past a cluster of 8; ms forced at (1024,), "
                       f"{gt['general_policy_value_forward']['rows']} rows",
          "at_2x1024": {"ms": gt["cluster_2x1024"]["general_cluster_forward"]["per_layer_ms"],
                        "cluster_ms": gt["cluster_2x1024"]["general_cluster_forward"]["ms"],
                        "library_ms": gt["cluster_2x1024"]["general_cluster_forward"]["library_ms"]},
          "kernels_per_call": records["general_resident"]["k4g_per_layer"]}),
        ("general_logp_forward", "policy_general.cu", "pyflyt_tpu/ops/pallas_sgd.py:173",
         past_trunk["general_logp_forward"], gg["by_route"]["per_layer"]["logp"],
         {"main_path": "traj_train other_trunks (4128,), past a cluster of 8; ms forced at (1024,), "
                       f"{gt['general_logp_forward']['rows']} rows",
          "at_2x1024": {"ms": gt["cluster_2x1024"]["general_cluster_logp"]["per_layer_ms"],
                        "cluster_ms": gt["cluster_2x1024"]["general_cluster_logp"]["ms"],
                        "library_ms": gt["cluster_2x1024"]["general_cluster_logp"]["library_ms"]},
          "kernels_per_call": records["general_resident"]["k3g_per_layer"]}),
        ("general_resident_epoch", "fused_epoch_general.cu", "pyflyt_tpu/ops/pallas_sgd.py:269",
         training["general_resident_epoch"],
         max(ge["by_route"]["resident"], gm["k2g_epoch_2x8192"]["max_abs_err"]),
         {"main_path": "hover7_train general_3x256, 32 x 8192 rows an epoch",
          **{f: gt["general_resident_epoch"][f] for f in ("ms_per_minibatch", "per_layer_ms", "ptxas")},
          "kernels_of_a_4_minibatch_call": records["fused_epoch_general"]["resident"],
          "per_layer_kernels_of_a_4_minibatch_call": records["fused_epoch_general"]["per_layer"]}),
        ("fused_epoch_general", "fused_epoch_general.cu", "pyflyt_tpu/ops/pallas_sgd.py:269",
         big["fused_epoch_general"], ge["by_route"]["per_layer"],
         {"main_path": "hover7_train general_2x1024: the per-layer route past the resident envelope, "
                       f"{gt['fused_epoch_general_2x1024']['minibatches']} x "
                       f"{gt['fused_epoch_general_2x1024']['minibatch_size']} rows an epoch",
          "ms_per_minibatch": gt["fused_epoch_general_2x1024"]["ms_per_minibatch"],
          "gemm_ptxas": gt["gemm_ptxas"],
          "at_1024": {**{k: gt["fused_epoch_general"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                                 "bound_by", "minibatches", "minibatch_size")},
                      "launches_per_other_trunks_1024_iteration": wide_trunk["fused_epoch_general"]}}),
    ):
        # the main path's shapes: the cluster rows and K2g per layer at 2 x 1024
        t = gt["cluster_2x1024"].get(name, gt["fused_epoch_general_2x1024"] if name == "fused_epoch_general"
                                     else gt[name])
        kernels.append({
            "name": name, "route": "cuda", "source": f"pyflyt_tpu_torch/csrc/{src}", "replaces": line,
            "launches": launches_, "max_abs_err": err,
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}, "host_ms": t["host_ms"],
            "ptxas": ptxas_usage(src), **extra,
        })
        check(launches_ > 0, f"{name}: not launched on its main path")
    for k in kernels:
        k["launches_per_hover7_serving"] = serving[k["name"]]
        k["launches_per_hover7_train_iteration"] = training[k["name"]]
        k["launches_per_hover7_wide_iteration"] = results["hover7_train"]["wide_2x256"]["launches_per_iteration"][
            k["name"]]
        k["launches_per_hover7_2x1024_iteration"] = big[k["name"]]
        k["launches_per_hover7_2x1024_serving"] = big_serving[k["name"]]
    for k in kernels:
        k["launches_per_gates_eval_use_kernel"] = results["gates_eval"]["use_kernel"]["launches"][k["name"]]
    results["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels, "card": card}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


def time_policy_forward(net, obs, lib_iters: int = 50, iters: int = 200) -> dict:
    """K4 (or K4n, K4g) on ``obs``: device time, host time, the plain twin,
    the cuBLAS chain (``lib_iters`` calls queued, and ``iters`` of the
    kernel: keep them under the ~1000 launches a stream holds) and the bound
    (bf16 matmul operations, weights and I/O bytes)."""
    from pyflyt_tpu_torch.ops import cuda_policy

    w = net.kernel_weights()
    obs = obs.contiguous()
    n = obs.shape[0]
    ms, host = time_ms(lambda: cuda_policy.policy_value_forward(obs, w), iters=iters)
    plain, _ = time_ms(lambda: cuda_policy.policy_value_forward_plain(obs, w), iters=20, device_timed=False)
    lib, _ = time_ms(library_forward(net, obs), iters=lib_iters)  # 11 launches a call at 2 x 256
    b_ms, by = policy_bound(w, obs)
    return {"ms": ms, "host_ms": host, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms, "bound_by": by,
            "rows": n, "obs_dim": obs.shape[1]}


def policy_bound(w, obs) -> tuple[float, str]:
    """The forward's bound on ``obs``: bf16 matmul operations against the
    obs, the weights (bf16 matrices, f32 biases) and the outputs."""
    from pyflyt_tpu_torch.ops import cuda_policy

    n = obs.shape[0]
    w_bytes = sum(t.numel() * t.element_size() for t in (
        *w.pi_w, *w.pi_b, w.pi_head_w, w.pi_head_b, *w.vf_w, *w.vf_b, w.vf_head_w, w.vf_head_b))
    t_bytes = (obs.numel() * 4 + w_bytes + n * (w.act_dim + 1) * 4) / H100_BYTES_PER_S
    t_ops = cuda_policy.forward_flops(n, w) / H100_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def library_forward(net, obs):
    """One cuBLAS bf16 F.linear + tanh chain computing the same function:
    the yardstick for the fused forward (the port never calls it)."""
    import torch
    import torch.nn.functional as F

    def bf(lin):
        return lin.weight.detach().bfloat16(), lin.bias.detach().bfloat16()

    pi = [bf(lin) for lin in net.pi_trunk.layers] + [bf(net.pi_head)]
    vf = [bf(lin) for lin in net.vf_trunk.layers] + [bf(net.vf_head)]

    def run():
        x = obs.bfloat16()
        outs = []
        for layers in (pi, vf):
            a = x
            for W, b in layers[:-1]:
                a = torch.tanh(F.linear(a, W, b))
            outs.append(F.linear(a, *layers[-1]))
        return outs

    return run


def step_latency(net, env, ars, obs, gen, steps: int = 256) -> dict:
    """Wall time of single rollout steps, each ended by a synchronize, in
    ms: median, p95 (12 samples beyond it) and max over all steps, and the
    medians of the steady steps and of the steps that refresh the reset
    cache (every 64th)."""
    import torch

    from pyflyt_tpu_torch.rl import ppo

    steady, refresh = [], []
    for _ in range(steps):
        refreshes = ars.step_idx % 64 == 63
        t0 = time.perf_counter()
        ars, obs, _ = ppo.rollout(net, env, ars, obs, 1, gen, refresh=64)
        torch.cuda.synchronize()
        (refresh if refreshes else steady).append(1e3 * (time.perf_counter() - t0))
    times = sorted(steady + refresh)
    q = lambda f: times[min(len(times) - 1, int(f * len(times)))]  # noqa: E731
    return {
        "samples": steps, "median_ms": q(0.5), "p95_ms": q(0.95), "max_ms": times[-1],
        "steady_median_ms": statistics.median(steady),
        "refresh_median_ms": statistics.median(refresh), "refresh_samples": len(refresh),
    }


def profiled(fn, label: str) -> dict:
    """Wall time and device time by kernel name of one call of ``fn``
    (torch.profiler); prints a summary line under ``label``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:  # ops' CPU rows repeat their kernels' time
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        rows.append({"name": evt.key[:80], "device_us": dev_us, "count": evt.count})
    rows.sort(key=lambda r: -r["device_us"])
    total = sum(r["device_us"] for r in rows)
    table = {"wall_ms": 1e3 * wall, "device_busy_ms": total / 1e3, "top": rows[:25]}
    print(json.dumps({label: {"wall_ms": table["wall_ms"], "device_busy_ms": table["device_busy_ms"],
                              "kernels": len(rows), "top5": rows[:5]}}), flush=True)
    return table


def profile_rollout(net, env, ars, obs, gen) -> dict:
    """Device time by kernel over 32 rollout steps."""
    from pyflyt_tpu_torch.rl import ppo

    return profiled(lambda: ppo.rollout(net, env, ars, obs, 32, gen), "profile_32_steps")


def profile_training(tp, runner) -> dict:
    """Device time by kernel over one training iteration, and over one K2
    call alone (its four kernels by name)."""
    from pyflyt_tpu_torch.ops import cuda_sgd

    it = profiled(lambda: tp.train_iteration(runner), "profile_train_iteration")
    net, opt = runner.network, runner.opt_state
    mbs = packed_rows(net, BATCH, seed=302).reshape(tp.config.num_minibatches, tp.config.minibatch_size, -1)
    c0 = net.obs_dim + net.action_dim
    stats = adv_stats(mbs[:, :, c0 + 1])
    leaves = [t.detach() for t in cuda_sgd.params_to_leaves(net)]
    ep = profiled(lambda: cuda_sgd.fused_epoch(mbs, stats, opt.count.reshape(1), leaves, opt.mu, opt.nu,
                                               tp.epoch_config(net.obs_dim)), "profile_fused_epoch")
    return {"train_iteration": it, "fused_epoch": ep}


if __name__ == "__main__":
    sys.exit(main())
