"""Times K2 (``cuda_sgd.fused_epoch``) at the hover training shapes (32
minibatches x 8192 rows, obs 21, 4 actions) in one or more checkouts of
this repository, each in a process of its own, in the order given (for
example parent, change, change, parent), on one card: the epoch's device
time (``chip_smoke.time_ms``), its device time by kernel (torch.profiler,
one call) and the library yardstick of the same inputs (bf16 autograd and
``Adam(fused=True)``, summed kernel time, ``chip_smoke.library_update``).

    python3 tools/epoch_ab.py ROOT [ROOT ...] [--out FILE]

Each ROOT is a checkout (``git archive`` of a commit unpacked somewhere
``.gitignore`` lists); its kernels are built under ROOT/build/. Needs a
CUDA card and ``nvcc``. Prints the card line and one JSON line per ROOT.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

N_MB, MB, OBS, ACT = 32, 8192, 21, 4


def child(root: str) -> dict:
    """K2 at the hover shapes in checkout ``root``, its modules imported
    from there."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    from pyflyt_tpu_torch.ops import cuda_build, cuda_sgd
    from pyflyt_tpu_torch.rl import PPOConfig
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build(["fused_epoch.cu"])
    net = ActorCritic(OBS, ACT, device="cuda", generator=torch.Generator().manual_seed(0))
    leaves = [t.detach().contiguous() for t in cuda_sgd.params_to_leaves(net)]
    g = torch.Generator(device="cuda").manual_seed(1)
    mu = [torch.randn(t.shape, generator=g, device="cuda") * 1e-3 for t in leaves]
    nu = [torch.rand(t.shape, generator=g, device="cuda") * 1e-5 for t in leaves]
    mbs = cs.packed_rows(net, N_MB * MB, seed=2).reshape(N_MB, MB, -1)
    stats = cs.adv_stats(mbs[:, :, OBS + ACT + 1])
    t0 = torch.tensor([3], dtype=torch.int32, device="cuda")
    cfg = PPOConfig()
    ecfg = cuda_sgd.EpochConfig(OBS, ACT, (256, 256), (256, 256), learning_rate=cfg.learning_rate,
                                clip_eps=cfg.clip_eps, entropy_coef=cfg.entropy_coef, value_coef=cfg.value_coef,
                                max_grad_norm=cfg.max_grad_norm)
    run = lambda: cuda_sgd.fused_epoch(mbs, stats, t0, leaves, mu, nu, ecfg)  # noqa: E731
    ms, host = cs.time_ms(run, iters=3, repeats=5)
    prof = cs.profiled(run, "profile_fused_epoch")
    by_kernel = {r["name"]: r["device_us"] / N_MB for r in prof["top"] if "EpochArgs" in r["name"]}
    lib = cs.profiled_device_ms(cs.library_update(net, mbs[0], stats[0], cfg), iters=8)
    return {"root": root, "card": cs.card_line(), "ms": ms, "host_ms": host, "us_per_minibatch_by_kernel": by_kernel,
            "library_ms": lib * N_MB, "minibatches": N_MB, "minibatch_size": MB}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("epoch_ab: CUDA is not available", file=sys.stderr)
        return 1
    rows = []
    for root in args.roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root], capture_output=True,
                             text=True, check=False)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
