"""Splits the narrow kernels' time on one card (K4n, K3n and K2n:
``csrc/policy_narrow.cu``, ``csrc/fused_epoch_narrow.cu``) and, with
``--parent``, holds the 2 x 256 kernels' SASS against another checkout's.

    python3 tools/narrow_probe.py [--parent DIR] [--out FILE]

- K4n with the archived slow policy (obs 16) at 64, 2048 and 8192 rows,
  and at 2048 rows on trunks of 1 to 4 layers of 64 (a layer's cost);
- K3n over the r4 slow recipe's batch (262,144 rows): the wrapper, the
  kernel alone on an image packed once, and the pack alone;
- K2n over the r4 slow epoch (64 x 4096 rows) and the SMALL arm's (64 x
  16,384): each of its CUDA kernels by name (torch.profiler device time);
- with ``--parent DIR`` (e.g. ``git archive <commit> pyflyt_tpu_torch/csrc
  | tar -x -C DIR``): ``policy_value_forward.cu`` and ``fused_epoch.cu``
  built from DIR's ``pyflyt_tpu_torch/csrc`` beside this checkout's, and
  the lines of their SASS that differ (``cuobjdump -sass``).

Needs a CUDA card and ``nvcc``. Prints the card line and one JSON line per
measurement; ``--out`` also writes them all to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

K4N_ROWS = (64, 2048, 8192)
K4N_DEPTHS = (1, 2, 3, 4)
WIDE_SOURCES = ("policy_value_forward.cu", "fused_epoch.cu")


def epoch_split(cs, net, n_mb: int, mb: int) -> dict:
    """Device µs a minibatch of each of K2n's CUDA kernels over one epoch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pyflyt_tpu_torch.ops import cuda_narrow

    inputs = cs.epoch_inputs(net, n_mb, mb, None)
    cuda_narrow.launch_epoch(*inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cuda_narrow.launch_epoch(*inputs)
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and "NarrowEpochArgs" in evt.key:
            us = getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)
            name = evt.key.replace("(anonymous namespace)::", "").split("(")[0]
            out[name] = {"us_per_minibatch": us / n_mb, "count": evt.count}
    return out


def build_parent(cuda_build, parent: str, source: str) -> str:
    """``source`` built from the parent checkout's csrc (the same flags)."""
    out = os.path.join(HERE, "build", "narrow_probe")
    os.makedirs(out, exist_ok=True)
    csrc = os.path.join(parent, "pyflyt_tpu_torch", "csrc")
    lib = os.path.join(out, f"parent_{source[:-3]}.so")
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", csrc, "-o", lib,
                    os.path.join(csrc, source)], check=True, capture_output=True, text=True)
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a checkout whose 2 x 256 kernels' SASS to compare")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("narrow_probe: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pyflyt_tpu_torch.ops import cuda_build, cuda_narrow, cuda_sgd
    from pyflyt_tpu_torch.rl import checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    results = {"card": cs.card_line()}
    print(results["card"], flush=True)
    cuda_build.build(["policy_narrow.cu", "fused_epoch_narrow.cu", *WIDE_SOURCES])

    def emit(key, value):
        results[key] = value
        print(json.dumps({key: value}), flush=True)

    net = checkpoint.load_policy_npz(cs.TRAJ_POLICY, device="cuda")
    w = net.kernel_weights()
    k4n = {}
    for n in K4N_ROWS:
        obs = torch.randn((n, 16), device="cuda")
        k4n[f"rows_{n}"], _ = cs.time_ms(lambda: cuda_policy_forward(obs, w), iters=200)  # noqa: B023
    obs = torch.randn((2048, 16), device="cuda")
    for d in K4N_DEPTHS:
        wd = cs.narrow_net(d, 16, 4, (64,) * d, (64,) * d).kernel_weights()
        k4n[f"depth_{d}_rows_2048"], _ = cs.time_ms(lambda: cuda_policy_forward(obs, wd), iters=200)  # noqa: B023
    emit("k4n_ms", k4n)

    r4 = cs.traj_r4_config()
    rows = cs.packed_rows(net, r4.batch_size, seed=302)
    leaves = cs.pi_leaves(net)
    n_pi = len(net.pi_trunk.layers)
    pack = lambda: cuda_narrow.pack_trunk([leaves[2 * i] for i in range(n_pi)],  # noqa: E731
                                          [leaves[2 * i + 1] for i in range(n_pi)], leaves[2 * n_pi],
                                          leaves[2 * n_pi + 1])
    image = pack()
    lay = cuda_narrow.layout(16, cs.trunk_sizes(net.pi_trunk), 4)
    wrapper, _ = cs.time_ms(lambda: cuda_sgd.logp_forward(rows, leaves, 16, vf_sizes=cs.trunk_sizes(net.vf_trunk)),
                             iters=20)
    kernel, _ = cs.time_ms(lambda: cuda_narrow.launch_logp(rows, image, lay, leaves[-1], 16), iters=100)
    packed_ms, _ = cs.time_ms(pack, iters=40)
    emit("k3n_ms", {"wrapper": wrapper, "kernel": kernel, "pack": packed_ms, "rows": r4.batch_size})

    emit("k2n_split_r4", epoch_split(cs, net, r4.num_minibatches, r4.minibatch_size))
    emit("k2n_split_small_arm", epoch_split(cs, net, r4.num_minibatches, 16384))

    if args.parent:
        from fixedwing_lane_probe import sass_diff

        ours = cuda_build.build(list(WIDE_SOURCES))
        emit("wide_sass_lines_differing", {src: sass_diff(cuda_build, str(ours[src]),
                                                          build_parent(cuda_build, args.parent, src))
                                           for src in WIDE_SOURCES})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


def cuda_policy_forward(obs, w):
    from pyflyt_tpu_torch.ops import cuda_policy

    return cuda_policy.policy_value_forward(obs, w)


if __name__ == "__main__":
    sys.exit(main())
