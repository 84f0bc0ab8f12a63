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
     and cache-refresh steps apart), and prints the ``kernels`` line.

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
PARITY_STEPS = 20
ROLLOUT_STEPS = 256
OBS_ATOL = 2e-4  # as tests/test_packed_hover.py: FMA contraction + native atan2/asin
# bf16 forward: kernel and twin round the same bf16 inputs and sum in
# f32 in another order; a sum that lands on a bf16 rounding boundary can
# move one trunk activation by one bf16 ulp (<= 2^-8), which reaches the
# mean through the 0.01-gain head and the value through the 1.0-gain head
POLICY_MEAN_ATOL = 1e-4
POLICY_VALUE_ATOL = 1e-3


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
# main
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write every result to this JSON file")
    ap.add_argument("--profile", action="store_true", help="add a torch.profiler table of 32 rollout steps")
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
    libs = cuda_build.build([cq.KERNEL.source, cuda_policy.KERNEL.source])
    results["build_s"] = time.perf_counter() - t0
    for src, lib in libs.items():
        log = lib.with_suffix(".log")
        usage = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln] if log.exists() else []
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
    results["kernels"] = kernels
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


def profile_rollout(net, env, ars, obs, gen) -> dict:
    """Device time by kernel over 32 rollout steps (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pyflyt_tpu_torch.rl import ppo

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ppo.rollout(net, env, ars, obs, 32, gen)
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
    print(json.dumps({"profile_32_steps": {"wall_ms": table["wall_ms"],
                                           "device_busy_ms": table["device_busy_ms"],
                                           "kernels": len(rows), "top5": rows[:5]}}), flush=True)
    return table


if __name__ == "__main__":
    sys.exit(main())
