#!/usr/bin/env python3
"""Measurements behind the general family's cluster route (K4g and K3g
past a block's width) on the card:

- ``times``: K4g and K3g at ``chip_smoke``'s wide shapes, the (1024,) trunk
  of ``other_trunks`` (obs 16, act 4: K4g over 256 rows, K3g over 4096)
  and the 2 x 1024 trunk of the mode-7 hover (obs 21, act 4: K4g over 8192
  rows, K3g over 262,144), each on the per-layer route (forced), on the
  route the wrapper picks and as the library call, in turns: device time
  behind a queued spin (``chip_smoke.time_ms``), the summed kernel time of
  one call and its CUDA kernels (torch.profiler), and the host wall of a
  synchronised call;
- ``wgmma_bits``: whether a chain of ``wgmma`` k16 steps in order gives
  ``mma.sync m16n8k16``'s bits on the same bf16 fragments
  (``tools/cluster_probe.cu``), over random trials at k 64 and 1024: the
  premise of a ``wgmma`` layer loop that keeps K2g's bits; then (``modes``)
  the per-layer GEMM's operand modes, A and B both from shared memory, each
  K-major or MN-major, at N 64, 128 and 256, every k16 step under one
  commit, at k 32 and 1024, each against ``mma.sync``'s chain on the same
  inputs, with the differing outputs printed;
- ``check``: ``chip_smoke.check_general_cluster`` (phase 58: the cluster
  route against its twins and bit for bit against the per-layer route)
  and the ptxas report of its kernels; ``grid``: phase 52
  (``chip_smoke.check_general_grid``, every route over its pairs);
- ``builds``: the cluster K4g and K3g's kernel (its image packed once) of
  this checkout at its plan and at each ``--plans`` TILExC that fits, and of
  ``policy_general.cu`` built from each other csrc directory given (``--other NAME=CSRC``, e.g. an edited copy in a
  directory that ``.gitignore`` lists), each with its ptxas, held bit for
  bit against the per-layer route and timed in turns at both shapes of
  ``times``.

    python3 tools/cluster_probe.py [--only check|grid|times|builds|wgmma_bits] [--other NAME=CSRC] [--plans TILExC,...] [--out FILE]

Needs a CUDA card and ``nvcc``. Prints the card line and one JSON line a
part.
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

SHAPES = {"(1024,)": dict(obs=16, act=4, sizes=(1024,), k4_rows=256, k3_rows=4096),
          "2x1024": dict(obs=21, act=4, sizes=(1024, 1024), k4_rows=8192, k3_rows=262_144)}


def build_probe():
    import chip_smoke as cs
    from pyflyt_tpu_torch.ops import cuda_build

    work = os.path.join(HERE, "build", "cluster_probe")
    os.makedirs(work, exist_ok=True)
    lib = os.path.join(work, "cluster_probe.so")
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", lib, os.path.join(HERE, "tools", "cluster_probe.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cs.check(proc.returncode == 0, f"nvcc failed on tools/cluster_probe.cu:\n{proc.stdout}")
    so = ctypes.CDLL(lib)
    so.wgmma_bits.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    so.wgmma_modes.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    so.mma_chain.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return so


def build_others(others: dict) -> dict:
    """``{name: (forward fn, logp fn, ptxas)}`` of ``policy_general.cu`` in
    each directory of ``others`` (name -> directory), one nvcc each, at once."""
    import chip_smoke as cs
    from pyflyt_tpu_torch.ops import cuda_build

    procs = {}
    for name, src in others.items():
        work = os.path.join(HERE, "build", "cluster_probe", name)
        os.makedirs(work, exist_ok=True)
        lib = os.path.join(work, "policy_general.so")
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", os.path.abspath(src), "-o", lib,
               os.path.join(os.path.abspath(src), "policy_general.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"{name}: nvcc failed:\n{log}")
        regs = {m.group(1)[-40:]: (int(m.group(2)), int(m.group(3))) for m in re.finditer(
            r"Function properties for (\S*cluster_kernel\S*)\n\s*\d+ bytes stack frame, (\d+) bytes spill stores.*?"
            r"Used (\d+) registers", log, re.S)}
        fns = []
        for sym in ("general_cluster_forward", "general_cluster_logp"):
            f = getattr(ctypes.CDLL(lib), sym)
            f.argtypes, f.restype = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
            fns.append(f)
        out[name] = (*fns, {"spill_store_bytes_and_registers": regs})
    return out


def builds(others: dict, plans: list, seed: int) -> dict:
    import torch

    import chip_smoke as cs
    from pyflyt_tpu_torch.ops import cuda_general as cg

    libs = {"built": (cg.CLUSTER_FORWARD_KERNEL.fn(), cg.CLUSTER_LOGP_KERNEL.fn(), cs.cluster_ptxas()),
            **build_others(others)}
    variants = {name: (name, None) for name in libs}
    for plan in plans:
        t, c = (int(v) for v in plan.split("x"))
        variants[f"built_{plan}"] = ("built", (t, c))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    out = {}
    for shape, s in SHAPES.items():
        o, a, sizes = s["obs"], s["act"], s["sizes"]
        net = cs.general_net(seed, o, a, sizes, sizes)
        w = net.kernel_weights()
        lays = cg.resident_layouts(w)
        obs = torch.randn((s["k4_rows"], o), generator=torch.Generator().manual_seed(seed + 1)).cuda()
        rows = cs.packed_rows(net, s["k3_rows"], seed=seed + 2)
        leaves = cs.pi_leaves(net)
        lay = cg.resident_layout(o, sizes, a)
        image = cg.pack_resident(leaves[: 2 * len(sizes) : 2], leaves[1 : 2 * len(sizes) : 2], leaves[2 * len(sizes)],
                                 leaves[2 * len(sizes) + 1])
        log_std = leaves[-1].reshape(-1).contiguous()
        want = cg.forward_per_layer(obs, w, *cs.per_layer_images(net)), cg.logp_per_layer(rows, leaves, o)
        plan4, plan3 = cg.cluster_plan(lays, a), cg.cluster_plan((lay,), a, True)
        calls, res = {}, {}
        for name, (lib, plan) in variants.items():
            (t4, c4), (t3, c3) = (plan, plan) if plan else (plan4, plan3)
            if max(cg.cluster_smem(t4, cg.cluster_width(lays, c4), a), cg.cluster_smem(
                    t3, cg.cluster_width((lay,), c3), a, True)) > cg.RES_SMEM_LIMIT:
                continue
            mean = torch.empty((obs.shape[0], a), device="cuda")
            value = torch.empty((obs.shape[0],), device="cuda")
            lp = torch.empty((rows.shape[0],), device="cuda")
            a4 = cg.resident_args(obs, (w.pi_image, w.vf_image), (mean, value), lays, t4, o, a,
                                  width=cg.cluster_width(lays, c4))
            a3 = cg.resident_args(rows, (image,), (lp,), (lay,), t3, o, a, log_std,
                                  width=cg.cluster_width((lay,), c3))

            def k4(f=libs[lib][0], args=a4, c=c4):
                cs.check(f(ctypes.addressof(args), c, stream()) == 0, "cluster K4g launch")

            def k3(f=libs[lib][1], args=a3, c=c3):
                cs.check(f(ctypes.addressof(args), c, stream()) == 0, "cluster K3g launch")

            k4()
            k3()
            torch.cuda.synchronize()
            same = bool(torch.equal(mean, want[0][0]) and torch.equal(value, want[0][1]) and torch.equal(lp, want[1]))
            res[name] = {"plans": ((t4, c4), (t3, c3)), "equal_to_per_layer": same,
                         "ptxas": libs[lib][2] if name == lib else "as " + lib}
            big = s["k3_rows"] > 100_000
            calls[f"{name}/k4g"] = (k4, 20 if big else 60)
            calls[f"{name}/k3g_kernel"] = (k3, 8 if big else 40)
        for key, v in cs.time_in_turns(calls).items():
            name, part = key.split("/")
            res[name][f"{part}_ms"] = v["ms"]
        out[shape] = res
        print(json.dumps({"builds": {shape: res}}), flush=True)
    return out


def kernels_of_call(fn) -> dict:
    """The CUDA kernels of one call of ``fn`` by name (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def times(seed: int) -> dict:
    import torch

    import chip_smoke as cs
    from pyflyt_tpu_torch.ops import cuda_general as cg
    from pyflyt_tpu_torch.ops import cuda_policy, cuda_sgd

    out = {}
    for name, s in SHAPES.items():
        o, a, sizes = s["obs"], s["act"], s["sizes"]
        net = cs.general_net(seed, o, a, sizes, sizes)
        w = net.kernel_weights()
        obs = torch.randn((s["k4_rows"], o), generator=torch.Generator().manual_seed(seed + 1)).cuda()
        rows = cs.packed_rows(net, s["k3_rows"], seed=seed + 2)
        leaves = cs.pi_leaves(net)
        images = cs.per_layer_images(net)
        k4 = {"per_layer": lambda: cg.forward_per_layer(obs, w, *images),
              "routed": lambda: cuda_policy.policy_value_forward(obs, w),
              "library": cs.library_forward(net, obs)}
        k3 = {"per_layer": lambda: cg.logp_per_layer(rows, leaves, o),
              "routed": lambda: cuda_sgd.logp_forward(rows, leaves, o, vf_sizes=sizes),
              "library": cs.library_logp(net, rows)}
        big = s["k3_rows"] > 100_000
        res = {"rows": {"k4g": s["k4_rows"], "k3g": s["k3_rows"]},
               "routes": {"k4g": cg.forward_route(w), "k3g": cg.logp_route(o, a, sizes)}}
        for kernel, calls in (("k4g", k4), ("k3g", k3)):
            iters = 10 if big and kernel == "k3g" else 40
            turns = cs.time_in_turns({k: (fn, iters) for k, fn in calls.items()})
            res[kernel] = {k: {"ms": v["ms"], "ms_rounds": v["ms_rounds"], "host_enqueue_ms": v["host_ms"],
                               "device_ms_profiled": cs.profiled_device_ms(calls[k], iters=5),
                               "host_wall_ms": cs.host_wall_ms(calls[k], iters=10),
                               "kernels": kernels_of_call(calls[k])} for k, v in turns.items()}
        out[name] = res
        print(json.dumps({"times": {name: res}}), flush=True)
    return out


def wgmma_bits(so, seed: int) -> dict:
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for k in (64, 1024):
        trials = 512
        scale = lambda *s: torch.exp2(torch.randint(-6, 7, s, device="cuda", generator=g).float())  # noqa: E731
        a = (torch.randn((trials, 64, k), device="cuda", generator=g) * scale(trials, 64, 1)).bfloat16()
        b = (torch.randn((trials, 8, k), device="cuda", generator=g) * scale(trials, 1, k)).bfloat16()
        d_wg = torch.empty((trials, 64, 8), device="cuda")
        d_mma = torch.empty_like(d_wg)
        rc = so.wgmma_bits(a.data_ptr(), b.data_ptr(), d_wg.data_ptr(), d_mma.data_ptr(), trials, k,
                           torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"wgmma_bits: CUDA error {rc}")
        torch.cuda.synchronize()
        ref = torch.einsum("tmk,tnk->tmn", a.double(), b.double())
        mag = torch.einsum("tmk,tnk->tmn", a.double().abs(), b.double().abs())
        out[f"k{k}"] = {
            "trials": trials, "outputs": d_wg.numel(),
            "bit_equal": bool(torch.equal(d_wg, d_mma)),
            "outputs_differing": int((d_wg != d_mma).sum()),
            "max_rel_err_wgmma": float(((d_wg.double() - ref).abs() / mag.clamp_min(1e-30)).max()),
            "max_rel_err_mma_sync": float(((d_mma.double() - ref).abs() / mag.clamp_min(1e-30)).max()),
        }
    out["modes"] = wgmma_modes(so, g)
    print(json.dumps({"wgmma_bits": out}), flush=True)
    return out


def wgmma_modes(so, g) -> dict:
    """``wgmma_modes`` against ``mma_chain`` in every mode of the GEMM; the
    first differing outputs of a mode are printed."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for n in (64, 128, 256):
        trials = 256
        scale = lambda *s: torch.exp2(torch.randint(-6, 7, s, device="cuda", generator=g).float())  # noqa: E731
        a = (torch.randn((trials, 64, 256), device="cuda", generator=g) * scale(trials, 64, 1)).bfloat16()
        bt = (torch.randn((trials, n, 256), device="cuda", generator=g) * scale(trials, 1, 256)).bfloat16()
        for k in (32, 1024):
            ref = torch.empty((trials, 64, n), device="cuda")
            check_rc(so.mma_chain(a.data_ptr(), bt.data_ptr(), ref.data_ptr(), trials, k, n, stream), "mma_chain")
            for ta in (0, 1):
                for tb in (0, 1):
                    d = torch.empty_like(ref)
                    check_rc(so.wgmma_modes(a.data_ptr(), bt.data_ptr(), d.data_ptr(), trials, k, n, ta, tb, stream),
                             f"wgmma_modes n{n} k{k} ta{ta} tb{tb}")
                    torch.cuda.synchronize()
                    diff = (d != ref)
                    name = f"n{n}_k{k}_A{'mn' if ta else 'k'}_B{'mn' if tb else 'k'}"
                    idx = diff.nonzero()[:4].tolist()
                    out[name] = {"outputs": d.numel(), "outputs_differing": int(diff.sum()),
                                 "first": [(i, float(d[tuple(i)]), float(ref[tuple(i)])) for i in idx]}
                    print(json.dumps({"wgmma_mode": {name: out[name]}}), flush=True)
    return out


def check_rc(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("check", "grid", "times", "builds", "wgmma_bits"), action="append",
                    default=None)
    ap.add_argument("--other", action="append", default=[], metavar="NAME=CSRC",
                    help="policy_general.cu built from another csrc directory (builds)")
    ap.add_argument("--plans", default="", help="builds: this checkout's kernels also at these TILExC, comma-separated")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    parts = args.only or ["wgmma_bits", "check", "times"]
    results = {"card": cs.card_line()}
    if "check" in parts:
        from pyflyt_tpu_torch.ops import cuda_build

        cuda_build.build(["policy_general.cu"])
        results["ptxas"] = cs.cluster_ptxas()
        print(json.dumps({"ptxas": results["ptxas"]}), flush=True)
        results["check"] = cs.check_general_cluster(args.seed)
        print(json.dumps({"check": results["check"]}), flush=True)
    if "grid" in parts:
        results["grid"] = cs.check_general_grid(args.seed)
        print(json.dumps({"grid": results["grid"]}), flush=True)
    if "wgmma_bits" in parts:
        results["wgmma_bits"] = wgmma_bits(build_probe(), args.seed)
    if "builds" in parts:
        from pyflyt_tpu_torch.ops import cuda_build

        cuda_build.build(["policy_general.cu"])
        results["builds"] = builds(dict(o.split("=", 1) for o in args.other),
                                   [v for v in args.plans.split(",") if v], args.seed)
    if "times" in parts:
        results["times"] = times(args.seed)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
