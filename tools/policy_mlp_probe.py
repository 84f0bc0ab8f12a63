"""Times K4 (``policy_value_forward``) and K3 (``logp_forward``) on one card
and splits their time: each kernel as built, beside the same source built
with the epilogue's ``tanhf`` taken out (bias add only), in one process.

    python3 tools/policy_mlp_probe.py [--out FILE]

Needs a CUDA card and ``nvcc``; the variant is built under
``build/policy_mlp_probe/``. Prints the card line, one JSON line per
measurement and, with ``--out``, writes them all to FILE. The variant's
outputs are wrong by design: it is timed, never checked.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

K4_SHAPES = ((21, 8192), (21, 4096), (21, 256), (35, 4096), (33, 8192), (21, 65536))
K3_SHAPES = ((21, 262_144), (33, 262_144), (21, 1_048_576))
TANH = "pack_bf16(tanhf(d[4 * i + 2 * h] + b.x), tanhf(d[4 * i + 2 * h + 1] + b.y))"
NO_TANH = "pack_bf16(d[4 * i + 2 * h] + b.x, d[4 * i + 2 * h + 1] + b.y)"


def build_variant(cuda_build) -> ctypes.CDLL:
    """csrc/policy_value_forward.cu with the epilogue's tanhf taken out."""
    out = os.path.join(HERE, "build", "policy_mlp_probe")
    os.makedirs(out, exist_ok=True)
    header = (cuda_build.CSRC / "policy_mlp.cuh").read_text()
    if TANH not in header:
        raise SystemExit("policy_mlp_probe: the epilogue's tanhf line is not in csrc/policy_mlp.cuh")
    with open(os.path.join(out, "policy_mlp.cuh"), "w") as f:
        f.write(header.replace(TANH, NO_TANH))
    src = os.path.join(out, "policy_value_forward.cu")
    with open(src, "w") as f:
        f.write((cuda_build.CSRC / "policy_value_forward.cu").read_text())
    lib = os.path.join(out, "policy_value_forward_no_tanh.so")
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", out, "-o", lib, src], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(lib)


def bind(lib: ctypes.CDLL, symbol: str):
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("policy_mlp_probe: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pyflyt_tpu_torch.ops import cuda_build, cuda_policy, cuda_sgd
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    torch.backends.cuda.matmul.allow_tf32 = False
    results = {"card": cs.card_line()}
    print(results["card"], flush=True)
    cuda_build.build(["policy_value_forward.cu"])

    # the wrappers at the main paths' shapes, beside the library chains
    for obs_dim, n in K4_SHAPES:
        net = ActorCritic(obs_dim, 4, device="cuda", generator=torch.Generator().manual_seed(obs_dim))
        obs = torch.randn((n, obs_dim), generator=torch.Generator().manual_seed(n)).cuda()
        cs.check_policy(net, n, cs.policy_atol(net))
        results[f"k4_{n}x{obs_dim}"] = cs.time_policy_forward(net, obs)
    for obs_dim, n in K3_SHAPES:
        net = ActorCritic(obs_dim, 4, device="cuda", generator=torch.Generator().manual_seed(obs_dim))
        cs.check_logp(net, n)
        rows = cs.packed_rows(net, n, seed=300)
        leaves = cs.pi_leaves(net)
        it = max(1, 20 * cs.BATCH // n)
        ms, host = cs.time_ms(lambda: cuda_sgd.logp_forward(rows, leaves, obs_dim, vf_sizes=(256, 256)), iters=it)
        lib, _ = cs.time_ms(cs.library_logp(net, rows), iters=it)
        results[f"k3_{n}x{obs_dim}"] = {"ms": ms, "host_ms": host, "library_ms": lib,
                                        **cs.logp_kernel_only(rows, leaves, obs_dim)}
    for k, v in results.items():
        if k != "card":
            print(json.dumps({k: v}), flush=True)

    # the split: as built, without tanhf, as built again
    variant = build_variant(cuda_build)
    built = (cuda_policy.KERNEL.fn(), cuda_sgd.LOGP_KERNEL.fn())
    swapped = (bind(variant, "policy_value_forward"), bind(variant, "logp_forward"))
    net = ActorCritic(21, 4, device="cuda", generator=torch.Generator().manual_seed(0))
    w = net.kernel_weights()
    rows = cs.packed_rows(net, cs.BATCH, seed=3)
    leaves = cs.pi_leaves(net)
    image = cuda_policy.pack_trunk(*leaves[:6])
    obs = {n: torch.randn((n, 21), device="cuda") for n in (4096, 8192, 65536)}
    split = []
    try:
        for name, (k4, k3) in (("built", built), ("no_tanh", swapped), ("built", built)):
            cuda_policy.KERNEL._fn, cuda_sgd.LOGP_KERNEL._fn = k4, k3
            r = {"variant": name}
            for n, o in obs.items():
                r[f"k4_{n}x21"] = cs.time_ms(lambda: cuda_policy.policy_value_forward(o, w), iters=200)[0]
            r["k3_kernel_262144x21"] = cs.time_ms(lambda: cuda_sgd._launch_logp(rows, image, leaves[6], 21),
                                                   iters=20)[0]
            split.append(r)
            print(json.dumps({"tanh_split": r}), flush=True)
    finally:
        cuda_policy.KERNEL._fn, cuda_sgd.LOGP_KERNEL._fn = built
    results["tanh_split"] = split
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
