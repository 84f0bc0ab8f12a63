#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pyflyt_tpu_torch``) on one card.

Run from the root of a checkout on a machine with an NVIDIA H100, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA:

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, each of which fails the script on a failed check:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds every kernel of the main path from pyflyt_tpu_torch/csrc, one
     nvcc process per source, all started together;
  3. holds the hover-step kernel against its plain twin on the card: noise
     off, N=8192 and a ragged N=1000, 20 agent steps with half the fleet at
     zero thrust; then noise on, the per-lane throttle spread;
  4. holds the policy/value forward kernel against its plain twin at
     n=8192 and n=1000 with TF32 off;
  5. drives the main path: a 2x256 ActorCritic acting in 8192
     PackedQuadXHoverEnv envs with cached auto-reset (refresh 64) for 256
     agent steps, checking that each kernel was launched once per step;
  6. times each kernel against its bound, its plain twin and (where one
     exists) one PyTorch library call, times single rollout steps (steady
     and cache-refresh steps apart);
  7. holds the log-prob kernel (K3) against its plain twin over the PPO
     batch's 262,144 packed rows and a ragged 1000, with TF32 off;
  8. holds the epoch kernel (K2) against its plain twin for one epoch of
     4 minibatches of 8192 rows and one of 2 minibatches of 1000 rows,
     from seeded weights and seeded non-zero Adam moments;
  9. drives the training path: PPO with ``fused_sgd`` and the fused
     rollout forward on 8192 PackedQuadXHoverEnv envs at PPOConfig's
     defaults (32 steps, 15 epochs x 32 minibatches), 3 iterations (the
     first a warm-up), checking the launches of every kernel per iteration
     and Adam's count, and prints the ``train`` line (phase split); then
     ``train`` itself on 512 envs (one iteration, deterministic eval,
     metrics and best-model checkpoint under build/) and a checkpoint
     round trip whose resumed iteration must equal the uninterrupted one;
 10. times K3 and K2 at the training path's shapes against their bounds,
     their plain twins and a library yardstick, and prints the ``kernels``
     line for all four kernels.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Without CUDA the script exits non-zero before printing any result. It
imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
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
    twins, ``device_timed=False``) is timed at its host rate.
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
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host.append(1e3 * (time.perf_counter() - t0) / iters)
        check(not device_timed or not start.query(),
              f"time_ms: the device caught up with the host's enqueue of {iters} calls")
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


def check_hover_step(n: int) -> float:
    """Kernel vs twin over PARITY_STEPS agent steps; returns the max error."""
    import torch
    from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv
    from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
    from pyflyt_tpu_torch.ops import cuda_quadx as cq

    env = PackedQuadXHoverEnv(base=QuadXHoverEnv(noisy_motors=False, device="cuda"))
    state, _ = env.reset(n)
    seed = torch.zeros(1, dtype=torch.int64, device="cuda")
    kern, plain = state.packed.clone(), state.packed.clone()
    err = 0.0
    done_any = False
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
        err = max(err, e_obs, e_rwd)
    check(done_any, f"hover N={n}: no lane terminated, the freeze path was not exercised")
    return err


def check_hover_noise() -> dict:
    """Noise on, identical start states: the spread of the throttle across
    lanes after one agent step, kernel (Philox) vs twin (torch.Generator)."""
    import torch
    from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv
    from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
    from pyflyt_tpu_torch.ops import cuda_quadx as cq

    env = PackedQuadXHoverEnv(base=QuadXHoverEnv(noisy_motors=False, device="cuda"))
    state, _ = env.reset(N_ENVS)
    packed = state.packed.clone()
    packed[cq._SP : cq._SP + 4] = torch.tensor([0.0, 0.0, 0.0, 0.35], device="cuda")[:, None]
    seed = torch.tensor([12345], dtype=torch.int64, device="cuda")
    kern = cq.packed_hover_step(packed, seed, env.consts, mode=0, noisy=True)
    plain = cq.packed_hover_step_plain(packed, seed, env.consts, mode=0, noisy=True)
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


def check_policy(net, n: int) -> float:
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
    check(e_m <= POLICY_MEAN_ATOL, f"policy n={n}: mean error {e_m}")
    check(e_v <= POLICY_VALUE_ATOL, f"policy n={n}: value error {e_v}")
    return max(e_m, e_v)


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


def check_logp(net, n: int) -> float:
    """K3 vs its twin over n packed rows, without and with a log_std range
    that clips; returns the max error."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_sgd

    rows = packed_rows(net, n, seed=11 + n)
    err = 0.0
    for rng in (None, (-1.0, -0.2)):
        k = cuda_sgd.logp_forward(rows, pi_leaves(net), net.obs_dim, rng)
        p = cuda_sgd.logp_forward_plain(rows, pi_leaves(net), net.obs_dim, rng)
        torch.cuda.synchronize()
        check(k.shape == (n,) and bool(torch.isfinite(k).all()), f"logp n={n}: shape or non-finite")
        e = (k - p).abs().max().item()
        check(e <= LOGP_ATOL, f"logp n={n} range={rng}: error {e}")
        err = max(err, e)
    return err


def check_epoch(net, n_mb: int, mb: int) -> dict:
    """K2 vs its twin for one epoch of n_mb minibatches of mb rows, from the
    network's weights and seeded non-zero moments, with a log_std range and
    an entropy term."""
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
    cfg = cuda_sgd.EpochConfig(
        net.obs_dim, net.action_dim, (256, 256), (256, 256), learning_rate=3e-4, clip_eps=0.2,
        entropy_coef=0.01, value_coef=0.5, max_grad_norm=0.5, log_std_range=(-1.0, 0.5),
    )
    kl, km, kn, kmet = cuda_sgd.fused_epoch(mbs, stats, t0, leaves, mu, nu, cfg)
    pl, pm, pn, pmet = cuda_sgd.fused_epoch_plain(mbs, stats, t0, leaves, mu, nu, cfg)
    torch.cuda.synchronize()
    where = f"epoch {n_mb}x{mb}"
    check(all(bool(torch.isfinite(t).all()) for t in (*kl, *km, *kn, kmet)), f"{where}: non-finite output")
    decay = cuda_sgd.B1**n_mb
    mu_rel = max(((a - decay * m) - (b - decay * m)).abs().max().item() / (b - decay * m).abs().max().item()
                 for a, b, m in zip(km, pm, mu))
    nu_rel = max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(kn, pn))
    p_err = max((a - b).abs().max().item() for a, b in zip(kl, pl))
    moved = max((b - t).abs().max().item() for b, t in zip(pl, leaves))
    met_rel = ((kmet - pmet).abs() / (pmet.abs() + 1e-3)).max().item()
    check(mu_rel <= EPOCH_MU_REL, f"{where}: gradient (mu) error {mu_rel} of its largest")
    check(nu_rel <= EPOCH_NU_REL, f"{where}: nu error {nu_rel} of its largest")
    check(p_err <= EPOCH_PARAM_ATOL, f"{where}: param error {p_err}")
    check(met_rel <= EPOCH_METRIC_RTOL, f"{where}: metrics error {met_rel}")
    check(moved > 1e-4, f"{where}: the params did not move")
    return {"n_mb": n_mb, "mb": mb, "mu_rel_err": mu_rel, "nu_rel_err": nu_rel, "max_abs_err": p_err,
            "metric_rel_err": met_rel, "max_param_step": moved}


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
    from pyflyt_tpu_torch.ops import cuda_policy, cuda_sgd
    from pyflyt_tpu_torch.ops import cuda_quadx as cq
    from pyflyt_tpu_torch.rl import PPO, PPOConfig, ppo

    cfg = PPOConfig(num_envs=N_ENVS, cached_reset_refresh=64, fused_sgd=True, fused_rollout_forward=True)
    tp = PPO(PackedQuadXHoverEnv(base=QuadXHoverEnv(device="cuda")), cfg)
    check(ppo.shuffle_block_size(cfg) == 32, "shuffle block")
    t0 = time.perf_counter()
    runner = tp.init(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    before = [p.detach().clone() for p in runner.network.parameters()]
    kernels = {"quadx_hover_step": cq.KERNEL, "policy_value_forward": cuda_policy.KERNEL,
               "logp_forward": cuda_sgd.LOGP_KERNEL, "fused_epoch": cuda_sgd.EPOCH_KERNEL}
    want = {"quadx_hover_step": cfg.rollout_steps, "policy_value_forward": cfg.rollout_steps,
            "logp_forward": 1, "fused_epoch": cfg.num_epochs}
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


def time_sgd_kernels(tp, runner) -> dict:
    import torch
    from pyflyt_tpu_torch.ops import cuda_sgd

    net = runner.network
    o, a = net.obs_dim, net.action_dim
    bound = lambda b, f: (1e3 * max(b / H100_BYTES_PER_S, f / H100_BF16_FLOPS),  # noqa: E731
                          "bytes" if b / H100_BYTES_PER_S >= f / H100_BF16_FLOPS else "operations")
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    out = {}

    rows = packed_rows(net, BATCH, seed=300)
    pl_ = pi_leaves(net)
    ms, host = time_ms(lambda: cuda_sgd.logp_forward(rows, pl_, o), iters=20)
    plain, _ = time_ms(lambda: cuda_sgd.logp_forward_plain(rows, pl_, o), iters=3, repeats=3, device_timed=False)
    lib, _ = time_ms(library_logp(net, rows), iters=20)
    b_ms, by = bound(nbytes([rows, *pl_]) + BATCH * 4, cuda_sgd.logp_flops(BATCH, o, a))
    out["logp_forward"] = {"ms": ms, "host_ms": host, "plain_ms": plain, "library_ms": lib,
                           "bound_ms": b_ms, "bound_by": by, "rows": BATCH}

    cfg = tp.config
    mbs = packed_rows(net, BATCH, seed=301).reshape(cfg.num_minibatches, cfg.minibatch_size, -1)
    c0 = o + a
    stats = adv_stats(mbs[:, :, c0 + 1])
    leaves = [t.detach() for t in cuda_sgd.params_to_leaves(net)]
    opt = runner.opt_state
    t0 = opt.count.reshape(1)
    ecfg = tp.epoch_config(o)
    run = lambda: cuda_sgd.fused_epoch(mbs, stats, t0, leaves, opt.mu, opt.nu, ecfg)  # noqa: E731
    ms, host = time_ms(run, iters=3, repeats=3)
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
                     cuda_sgd.epoch_flops(BATCH, o, a))
    out["fused_epoch"] = {
        "ms": ms, "host_ms": host, "ms_per_minibatch": ms / cfg.num_minibatches, "plain_ms": plain,
        "library_ms": lib_mb * cfg.num_minibatches, "library_ms_per_minibatch": lib_mb,
        "library_ms_source": "torch.profiler kernel time", "library_host_wall_ms_per_minibatch": lib_wall,
        "bound_ms": b_ms, "bound_by": by, "minibatches": cfg.num_minibatches,
        "minibatch_size": cfg.minibatch_size,
        "cuda_kernels_per_call": cuda_sgd.KERNELS_PER_MINIBATCH * cfg.num_minibatches,
    }
    print(json.dumps({"sgd_times": out}), flush=True)
    return out


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
# main
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write every result to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler tables of 32 rollout steps, a training iteration and a K2 call")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "pyflyt_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout: pyflyt_tpu_torch/ is not beside it", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv, packed_autoreset_init
    from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
    from pyflyt_tpu_torch.ops import cuda_build, cuda_policy, cuda_sgd
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
    sources = {cq.KERNEL.source, cuda_policy.KERNEL.source, cuda_sgd.LOGP_KERNEL.source,
               cuda_sgd.EPOCH_KERNEL.source}
    libs = cuda_build.build(sorted(sources))
    results["build_s"] = time.perf_counter() - t0
    for src, lib in libs.items():
        log = lib.with_suffix(".log")
        usage = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln or "spill" in ln] if log.exists() else []
        print(f"built {src}: {lib.name}; ptxas: {' | '.join(usage) or 'cached build'}", flush=True)
    print(f"build_s {results['build_s']:.1f}", flush=True)

    # 3. hover step vs its twin
    err_a = max(check_hover_step(N_ENVS), check_hover_step(N_RAGGED))
    results["hover_noise"] = check_hover_noise()
    print(f"hover step: max |kernel - twin| {err_a:.3g} (N={N_ENVS}, {N_RAGGED}); noise spread ok", flush=True)

    # 4. policy forward vs its twin
    net = ActorCritic(21, 4, device="cuda", generator=torch.Generator().manual_seed(args.seed))
    err_b = max(check_policy(net, N_ENVS), check_policy(net, N_RAGGED))
    print(f"policy forward: max |kernel - twin| {err_b:.3g} (n={N_ENVS}, {N_RAGGED})", flush=True)

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
    cq.KERNEL.launches = 0
    cuda_policy.KERNEL.launches = 0
    t0 = time.perf_counter()
    ars, obs, traj = ppo.rollout(net, env, ars, obs, ROLLOUT_STEPS, gen, refresh=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"quadx_hover_step": cq.KERNEL.launches, "policy_value_forward": cuda_policy.KERNEL.launches}
    for name, count in launches.items():
        check(count == ROLLOUT_STEPS, f"{name} launched {count} times in {ROLLOUT_STEPS} rollout steps")
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

    w = net.kernel_weights()
    obs_b = obs.contiguous()
    ms_b, host_b = time_ms(lambda: cuda_policy.policy_value_forward(obs_b, w), iters=200)
    plain_b, _ = time_ms(lambda: cuda_policy.policy_value_forward_plain(obs_b, w), iters=20,
                         device_timed=False)
    lib_b, _ = time_ms(library_forward(net, obs_b), iters=50)  # 11 launches a call
    w_bytes = sum(t.numel() * t.element_size() for t in (
        *w.pi_w, *w.pi_b, w.pi_head_w, w.pi_head_b, *w.vf_w, *w.vf_b, w.vf_head_w, w.vf_head_b))
    bytes_b = obs_b.numel() * 4 + w_bytes + N_ENVS * (w.act_dim + 1) * 4
    ops_b = cuda_policy.forward_flops(N_ENVS, w)
    t_bytes_b, t_ops_b = bytes_b / H100_BYTES_PER_S, ops_b / H100_BF16_FLOPS

    kernels = [
        {
            "name": "quadx_hover_step", "route": "cuda",
            "source": "pyflyt_tpu_torch/csrc/quadx_hover_step.cu",
            "replaces": "pyflyt_tpu/ops/pallas_quadx.py:837",
            "launches": launches["quadx_hover_step"], "max_abs_err": err_a,
            "ms": ms_a, "plain_ms": plain_a, "bound_ms": 1e3 * max(t_bytes_a, t_ops_a),
            "bound_by": "bytes" if t_bytes_a >= t_ops_a else "operations",
            "library_ms": None,
        },
        {
            "name": "policy_value_forward", "route": "cuda",
            "source": "pyflyt_tpu_torch/csrc/policy_value_forward.cu",
            "replaces": "pyflyt_tpu/ops/pallas_policy.py:35",
            "launches": launches["policy_value_forward"], "max_abs_err": err_b,
            "ms": ms_b, "plain_ms": plain_b, "bound_ms": 1e3 * max(t_bytes_b, t_ops_b),
            "bound_by": "bytes" if t_bytes_b >= t_ops_b else "operations",
            "library_ms": lib_b,
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
        "kernel_device_ms_per_step": ms_a + ms_b,
        "wrapper_host_ms_per_step": host_a + host_b,
        "kernel_device_share_of_steady_step": (ms_a + ms_b) / lat["steady_median_ms"],
    }
    print(json.dumps({"breakdown": results["breakdown"], "card": card}), flush=True)
    if args.profile:
        results["profile"] = profile_rollout(net, env, ars, obs, gen)

    # 7. K3 vs its twin
    err_c = max(check_logp(net, n) for n in (BATCH, N_RAGGED))
    print(f"logp forward: max |kernel - twin| {err_c:.3g} (rows={BATCH}, {N_RAGGED})", flush=True)

    # 8. K2 vs its twin
    epoch_checks = [check_epoch(net, n_mb, mb) for n_mb, mb in ((4, N_ENVS), (2, N_RAGGED))]
    results["epoch_checks"] = epoch_checks
    err_d = max(c["max_abs_err"] for c in epoch_checks)
    print(json.dumps({"epoch_checks": epoch_checks}), flush=True)

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
        })
    for k in kernels:
        k["launches_per_train_iteration"] = train["launches_per_iteration"][k["name"]]
    results["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"kernels": kernels, "card": card}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


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
