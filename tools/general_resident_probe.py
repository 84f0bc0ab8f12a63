#!/usr/bin/env python3
"""A/B builds of the general family's resident route (K4g and K3g on
``csrc/policy_resident.cuh``) on the card: ``policy_general.cu`` built from
each other csrc directory given (``--other NAME=CSRC``, one nvcc each, all
at once), each with its ptxas registers and spills, held bit for bit
against the per-layer route of this checkout, and timed in turns (that
order, then reversed) beside this checkout's build at the slice's 3 x 256
trunk (obs 21, act 4): K4g over 8192 rows and K3g's kernel over 262,144.
A directory must keep this checkout's ``struct ResidentArgs``.

    python3 tools/general_resident_probe.py --other NAME=CSRC [--other ...] [--out FILE]

For a design variant, copy ``pyflyt_tpu_torch/csrc`` to a directory that
``.gitignore`` lists, edit its ``policy_resident.cuh`` and pass the copy.
Needs a CUDA card and ``nvcc``. Prints the card line and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def build(others: dict) -> dict:
    """``{name: (forward fn, logp fn, ptxas)}`` of ``policy_general.cu`` in
    each directory of ``others`` (name -> directory)."""
    import chip_smoke as cs
    from pyflyt_tpu_torch.ops import cuda_build

    procs = {}
    for name, src in others.items():
        work = os.path.join(HERE, "build", "resident_probe", name)
        os.makedirs(work, exist_ok=True)
        lib = os.path.join(work, "policy_general.so")
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", os.path.abspath(src), "-o", lib,
               os.path.join(os.path.abspath(src), "policy_general.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"{name}: nvcc failed:\n{log}")
        regs = {m.group(1)[-40:]: int(m.group(2)) for m in re.finditer(
            r"Function properties for (\S*resident_kernel\S*)\n.*?Used (\d+) registers", log, re.S)}
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores", log))
        fns = []
        for sym in ("general_resident_forward", "general_resident_logp"):
            f = getattr(ctypes.CDLL(lib), sym)
            f.argtypes, f.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
            fns.append(f)
        out[name] = (*fns, {"registers": regs, "spill_store_bytes": spills})
    return out


def compare(others: dict, seed: int) -> dict:
    import torch

    import chip_smoke as cs
    from pyflyt_tpu_torch.ops import cuda_general as cg
    from pyflyt_tpu_torch.ops import cuda_policy

    libs = {"built": (cg.RESIDENT_FORWARD_KERNEL.fn(), cg.RESIDENT_LOGP_KERNEL.fn(), cs.resident_ptxas()),
            **build(others)}
    net = cs.general_net(seed, 21, 4, cs.GENERAL_TRUNK, cs.GENERAL_TRUNK)
    w = net.kernel_weights()
    obs = torch.randn((cs.N_ENVS, 21), generator=torch.Generator().manual_seed(seed)).cuda()
    rows = cs.packed_rows(net, cs.BATCH, seed=303)
    leaves = cs.pi_leaves(net)
    lay = cg.resident_layout(21, cs.GENERAL_TRUNK, 4)
    image = cg.pack_resident(leaves[0:6:2], leaves[1:6:2], leaves[6], leaves[7])
    built = cg.RESIDENT_FORWARD_KERNEL._fn, cg.RESIDENT_LOGP_KERNEL._fn

    def on(name, fn):
        def run():
            cg.RESIDENT_FORWARD_KERNEL._fn, cg.RESIDENT_LOGP_KERNEL._fn = libs[name][:2]
            try:
                return fn()
            finally:
                cg.RESIDENT_FORWARD_KERNEL._fn, cg.RESIDENT_LOGP_KERNEL._fn = built
        return run

    k4 = lambda: cuda_policy.policy_value_forward(obs, w)  # noqa: E731
    k3 = lambda: cg.launch_resident_logp(rows, image, lay, leaves[-1], 21)  # noqa: E731
    want = cg.forward_per_layer(obs, w, *cs.per_layer_images(net)), cg.logp_per_layer(rows, leaves, 21)
    out = {}
    for name in libs:
        m, v = on(name, k4)()
        lp = on(name, k3)()
        torch.cuda.synchronize()
        same = bool(torch.equal(m, want[0][0]) and torch.equal(v, want[0][1]) and torch.equal(lp, want[1]))
        out[name] = {"ptxas": libs[name][2], "equal_to_per_layer": same}
    calls = {}
    for name in libs:
        calls[f"{name}/k4g"] = (on(name, k4), 60)
        calls[f"{name}/k3g_kernel"] = (on(name, k3), 20)
    for key, v in cs.time_in_turns(calls).items():
        name, part = key.split("/")
        out[name][f"{part}_ms"] = v["ms"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=CSRC", required=True,
                    help="policy_general.cu built from another csrc directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from pyflyt_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    cuda_build.build(["policy_general.cu"])
    results = compare(dict(o.split("=", 1) for o in args.other), args.seed)
    print(json.dumps({"builds": results}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0 if all(r["equal_to_per_layer"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
