#!/usr/bin/env python3
"""Where K2g's per-layer route spends its time on the card, by kernel:
one epoch (``cuda_general.launch_epoch(..., route="per_layer")``) at the
hovering CLI's 2 x 1024 trunk (obs 21, act 4, 32 minibatches of 8192
rows) and at ``other_trunks``' (1024,) (4 minibatches of 1024 rows), each
CUDA kernel's summed device time and count under torch.profiler (a
minibatch's share: the sum over the call's minibatches; kernels on two
streams overlap, so the span from the call's first kernel to its last is
given beside), the call's host wall, and the per-layer GEMM's ptxas report (registers, spills and any
line on serialised wgmma) from the build's log.

    python3 tools/general_gemm_probe.py [--repo DIR ...] [--out FILE]

``--repo DIR`` reads another checkout (e.g. the parent's, unpacked with
``git archive`` into a directory that ``.gitignore`` lists) in a child
process of its own, its kernels built from its own sources, before this
checkout's: a split before and after a change, on one card. ``--csrc
NAME=DIR`` reads this checkout with ``fused_epoch_general.cu`` built from
another csrc directory (an edited copy in a directory that ``.gitignore``
lists): a design variant. Each split also lists the first minibatch's
kernels in launch order with their device times and, for the GEMMs, the
rate their bf16 operations reach.

Needs a CUDA card and ``nvcc``. Prints the card line and one JSON line a
checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"2x1024": dict(sizes=(1024, 1024), n_mb=32, mb=8192), "(1024,)": dict(sizes=(1024,), n_mb=4, mb=1024)}


def ptxas_notes(source: str) -> dict:
    """The GEMM kernels' registers and spills, and every ptxas line that
    names wgmma, from ``source``'s build log."""
    from pyflyt_tpu_torch.ops import cuda_build

    log = cuda_build.library_path(source).with_suffix(".log").read_text()
    regs = {m.group(1)[-40:]: {"stack": int(m.group(2)), "spill_stores": int(m.group(3)), "registers": int(m.group(4))}
            for m in re.finditer(r"Function properties for (\S*gemm_kernel\S*)\n\s*(\d+) bytes stack frame, "
                                 r"(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S)}
    return {"gemm_kernels": regs, "wgmma_notes": [ln.strip() for ln in log.splitlines() if "wgmma" in ln][:20]}


def gemm_flops(sizes, mb: int, obs: int = 21, act: int = 4) -> list:
    """The bf16 operations of each GEMM of a minibatch in launch order: the
    actor's forward, the critic's, then each trunk's backward from its head
    (weight gradient, then but for layer 0 the data gradient)."""
    out = []
    for outs in (act, 1):
        dims = (obs, *sizes, outs)
        out += [2 * mb * k * n for k, n in zip(dims[:-1], dims[1:])]
    for outs in (act, 1):
        dims = (obs, *sizes, outs)
        for l in range(len(dims) - 2, -1, -1):
            out.append(2 * mb * dims[l] * dims[l + 1])
            if l:
                out.append(2 * mb * dims[l] * dims[l + 1])
    return out


def split(seed: int, csrc: str | None = None) -> dict:
    import pathlib
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from pyflyt_tpu_torch.ops import cuda_build, cuda_general

    if csrc:  # a variant's sources, built beside this checkout's
        cuda_build.CSRC = pathlib.Path(csrc).resolve()
        cuda_build.BUILD_DIR = pathlib.Path(HERE, "build", "gemm_probe", cuda_build.CSRC.name)
    cuda_build.build(["fused_epoch_general.cu"])
    out = {"card": cs.card_line()}
    for name, s in SHAPES.items():
        net = cs.general_net(seed, 21, 4, s["sizes"], s["sizes"])
        inputs = cs.epoch_inputs(net, s["n_mb"], s["mb"], None)
        run = lambda: cuda_general.launch_epoch(*inputs, route="per_layer")  # noqa: E731
        run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        rows = [(e.key, e.count, e.device_time_total / 1e3) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        total = sum(ms for _, _, ms in rows)
        mine = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA and "Args" in e.name),
                      key=lambda e: e.time_range.start)
        per_mb = cuda_general.kernels_per_minibatch(len(s["sizes"]), len(s["sizes"]))
        first = mine[len(mine) - s["n_mb"] * per_mb:][:per_mb]
        flops = gemm_flops(s["sizes"], s["mb"])
        seq = []
        for e in first:
            us = e.time_range.elapsed_us()
            entry = {"kernel": e.name[:40], "us": us}
            if "gemm_kernel" in e.name and flops:
                f = flops.pop(0)
                entry.update(gflop=f / 1e9, tflops=f / us / 1e6)
            seq.append(entry)
        span = (max(e.time_range.end for e in mine) - min(e.time_range.start for e in mine)) / 1e3
        out[name] = {"minibatches": s["n_mb"], "minibatch_rows": s["mb"], "host_wall_ms": walls,
                     "device_ms": total, "device_ms_per_minibatch": total / s["n_mb"], "device_span_ms": span,
                     "first_minibatch_span_us": first[-1].time_range.end - first[0].time_range.start,
                     "kernels": sorted(({"kernel": k[:90], "count": c, "ms": ms, "share": ms / total}
                                        for k, c, ms in rows), key=lambda r: -r["ms"]),
                     "first_minibatch": seq}
    try:
        out["ptxas"] = ptxas_notes("fused_epoch_general.cu")
    except (OSError, AttributeError) as e:
        out["ptxas"] = repr(e)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", action="append", default=[], help="another checkout, read before this one")
    ap.add_argument("--csrc", action="append", default=[], metavar="NAME=DIR",
                    help="this checkout with fused_epoch_general.cu built from another csrc directory")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--child-csrc", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.child:
        sys.path.insert(0, os.getcwd())
        print(json.dumps(split(args.seed, args.child_csrc)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    results = {}
    runs = [(os.path.relpath(os.path.abspath(r), HERE), r, None) for r in args.repo]
    runs += [(name, HERE, os.path.abspath(d)) for name, d in (c.split("=", 1) for c in args.csrc)] + [(".", HERE, None)]
    for name, repo, csrc in runs:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", "--seed", str(args.seed)]
        proc = subprocess.run(cmd + (["--child-csrc", csrc] if csrc else []), cwd=os.path.abspath(repo),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        results[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({name: results[name]}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
