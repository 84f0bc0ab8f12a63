#!/usr/bin/env python3
"""Reads how far K2g (``csrc/fused_epoch_general.cu``) lies from its twin
(``cuda_sgd.fused_epoch_plain``) beside what a sound and a faulty version
of the twin read on the same inputs, by ``chip_smoke.epoch_errors`` (the
first moment's error of each leaf's largest and the parameters' error):
what ``chip_smoke.py``'s GENERAL_MU_REL is set from.

- ``kernel``: K2g against the twin;
- ``k_order``: the twin with every product summed over two halves of its
  k range, added in f32 (another correct order), against the twin;
- ``tanh_f64``: the twin with its tanh taken in f64 and rounded to f32
  (another correct tanh, as the kernel's ``tanhf`` is one), against the
  twin;
- ``bf16_out``: the twin with every product's f32 sum rounded to bf16
  (a fault: a sum or an activation kept in bf16);
- ``tail_512``, ``tail_64``: the twin's weight gradients missing the last
  512 or 64 rows of each minibatch (a fault: a chunk or a row tile left
  out);

at ``chip_smoke.py``'s general epoch shapes (every GENERAL_PAIRS trunk
pair; two minibatches of 8192 rows at obs 21 / act 4, and of 1000 rows
at obs 72 / act 10 with a clipping log_std range) over ``--seeds`` seeds,
each case with the share of the actor's tanh units past |a| > 0.99 in the
twin's first forward (saturation); then ``kernel`` and ``k_order`` at the
slice's training shape (3 x 256, obs 21, act 4, 32 minibatches of 8192
rows); and K3g against its twin over 262,144 rows at 3 x 256. With
``--trained N``, every variant also over two 8192-row minibatches
(``epoch_inputs``) on the 3 x 256 network ``chip_smoke.hover7_train``
leaves trained, for its seeds 0..N-1 (seed 0: the network that
``chip_smoke.py``'s phase 57 checks), from the seeded moments and from
the training run's own Adam state.

    python3 tools/general_epoch_probe.py [--seeds 4] [--trained 0] [--skip-grid] [--out FILE]

With ``--resident`` it reads K2g's resident route instead (the route of
every trunk pair that fits a block): ``fused_epoch_general.cu`` built from
this checkout and from each other csrc directory given (``--other
NAME=CSRC``, one nvcc each, all at once; a directory must keep this
checkout's ``struct ResidentEpochArgs``), each with its ptxas registers and
spills per kernel; each build against the twin at every GENERAL_PAIRS pair
(two minibatches of 8192 rows at obs 21 / act 4, of 1000 rows at obs 72 /
act 10) at GENERAL_MU_REL, two calls bit-identical and, at the slice's
3 x 256 trunk, approx_kl exactly 0 on K3g's log-probs; then each build's
epoch of 32 x 8192 rows at 3 x 256 timed in turns (that order, then
reversed) beside the per-layer route forced at the same shapes:

    python3 tools/general_epoch_probe.py --resident [--other NAME=CSRC ...] [--out FILE]

For a design variant, copy ``pyflyt_tpu_torch/csrc`` to a directory that
``.gitignore`` lists, edit its ``fused_epoch_general.cu`` (or
``policy_resident.cuh``) and pass the copy. The repository's sources are
never edited.

Needs a CUDA card and ``nvcc``. Prints the card line and one JSON line a
part.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def products(kind: str):
    """The twin's three product shapes (``_mm``, ``_mm_tn``, ``_mm_nt``) of
    one variant: bf16 inputs, f32 sums, changed as ``kind`` says."""
    import torch
    from pyflyt_tpu_torch.ops.cuda_sgd import _bf

    def prod(a, b):
        if kind == "k_order" and a.shape[1] > 1:
            h = a.shape[1] // 2
            return _bf(a[:, :h]) @ _bf(b[:h]) + _bf(a[:, h:]) @ _bf(b[h:])
        out = _bf(a) @ _bf(b)
        return out.to(torch.bfloat16).to(torch.float32) if kind == "bf16_out" else out

    def prod_tn(a, b):
        if kind.startswith("tail_"):
            keep = a.shape[0] - int(kind[5:])
            return prod(a[:keep].T, b[:keep])
        return prod(a.T, b)

    return prod, prod_tn, lambda a, b: prod(a, b.T)


@contextlib.contextmanager
def twin_variant(kind: str):
    import torch
    from pyflyt_tpu_torch.ops import cuda_sgd

    saved = cuda_sgd._mm, cuda_sgd._mm_tn, cuda_sgd._mm_nt, torch.tanh
    cuda_sgd._mm, cuda_sgd._mm_tn, cuda_sgd._mm_nt = products(kind)
    if kind == "tanh_f64":
        tanh = torch.tanh
        torch.tanh = lambda x: tanh(x.double()).float()
    try:
        yield
    finally:
        cuda_sgd._mm, cuda_sgd._mm_tn, cuda_sgd._mm_nt, torch.tanh = saved


def saturation(inputs) -> list:
    """The share of each actor layer's tanh units past |a| > 0.99 over the
    first minibatch, in the twin's forward."""
    import torch
    from pyflyt_tpu_torch.ops import cuda_sgd

    mbs, _, _, leaves, _, _, cfg = inputs
    a = mbs[0, :, : cfg.obs_dim]
    out = []
    for i in range(len(cfg.pi_sizes)):
        a = torch.tanh(cuda_sgd._mm(a, leaves[2 * i]) + leaves[2 * i + 1])
        out.append((a.abs() > 0.99).float().mean().item())
    return out


def read_case(cs, net, n_mb: int, mb: int, rng, kinds, opt=None) -> dict:
    import torch
    from pyflyt_tpu_torch.ops import cuda_sgd

    inputs = cs.epoch_inputs(net, n_mb, mb, rng, opt)
    want = cuda_sgd.fused_epoch_plain(*inputs)
    out = {"saturated_share_by_layer": saturation(inputs)}
    for kind in kinds:
        if kind == "kernel":
            got = cuda_sgd.fused_epoch(*inputs)
        else:
            with twin_variant(kind):
                got = cuda_sgd.fused_epoch_plain(*inputs)
        torch.cuda.synchronize()
        e = cs.epoch_errors(inputs, got, want)
        out[kind] = {k: e[k] for k in ("mu_rel", "worst", "nu_rel", "p_err", "met_rel", "finite")}
    return out


def build_others(others: dict) -> dict:
    """``{name: (K2g's resident entry, ptxas)}`` of ``fused_epoch_general.cu``
    in each directory of ``others`` (name -> directory), this checkout's as
    ``built``."""
    import ctypes
    import subprocess

    import chip_smoke as cs
    from pyflyt_tpu_torch.ops import cuda_build
    from pyflyt_tpu_torch.ops import cuda_general as cg

    procs = {}
    for name, src in others.items():
        work = os.path.join(HERE, "build", "epoch_probe", name)
        os.makedirs(work, exist_ok=True)
        lib = os.path.join(work, "fused_epoch_general.so")
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", os.path.abspath(src), "-o", lib,
               os.path.join(os.path.abspath(src), "fused_epoch_general.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    out = {"built": (cg.RESIDENT_EPOCH_KERNEL.fn(), cs.resident_epoch_ptxas())}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"{name}: nvcc failed:\n{log}")
        f = ctypes.CDLL(lib).fused_epoch_general_resident
        f.argtypes, f.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
        out[name] = (f, cs.resident_epoch_ptxas(log))
    return out


def resident_part(others: dict, seed: int) -> dict:
    """K2g's resident route, this checkout's and each other build: against
    the twin at every GENERAL_PAIRS pair, bit-identical on repeat, approx_kl
    exactly 0 at 3 x 256; then the 32 x 8192 epoch at 3 x 256 timed in turns
    beside the per-layer route."""
    import torch

    import chip_smoke as cs
    from pyflyt_tpu_torch.ops import cuda_general as cg
    from pyflyt_tpu_torch.ops import cuda_sgd

    libs = build_others(others)
    built = cg.RESIDENT_EPOCH_KERNEL._fn

    def on(name, fn):
        def run():
            cg.RESIDENT_EPOCH_KERNEL._fn = libs[name][0]
            try:
                return fn()
            finally:
                cg.RESIDENT_EPOCH_KERNEL._fn = built
        return run

    shapes = [(pi, vf, 21, 4, cs.N_ENVS, None) for pi, vf in cs.GENERAL_PAIRS]
    shapes += [(pi, vf, 72, 10, cs.N_RAGGED, cs.EPOCH_RANGE) for pi, vf in cs.GENERAL_PAIRS]
    out = {name: {"ptxas": libs[name][1], "cases": []} for name in libs}
    for k, (pi, vf, o, a, mb, rng) in enumerate(shapes):
        net = cs.general_net(seed + 2000 + k, o, a, pi, vf)
        inputs = cs.epoch_inputs(net, 2, mb, rng)
        cs.check(cg.epoch_route(inputs[-1]) == "resident", f"{pi} {vf}: not the resident route")
        want = cuda_sgd.fused_epoch_plain(*inputs)
        for name in libs:
            got = on(name, lambda: cg.launch_epoch(*inputs))()
            again = on(name, lambda: cg.launch_epoch(*inputs))()
            torch.cuda.synchronize()
            e = cs.epoch_errors(inputs, got, want)
            flat = lambda r: [*r[0], *r[1], *r[2], r[3]]  # noqa: E731
            same = all(torch.equal(x, y) for x, y in zip(flat(got), flat(again)))
            ok = e["finite"] and e["mu_rel"] <= cs.GENERAL_MU_REL and same
            out[name]["cases"].append({"pi": pi, "vf": vf, "obs": o, "act": a, "mb": mb, "ok": ok,
                                       "bit_identical": same,
                                       **{f: e[f] for f in ("mu_rel", "nu_rel", "p_err", "met_rel", "finite")}})
        print(json.dumps({"case": {n: out[n]["cases"][-1] for n in libs}}), flush=True)
    net = cs.general_net(seed + 3000, 21, 4, cs.GENERAL_TRUNK, cs.GENERAL_TRUNK)
    for name in libs:
        out[name]["consistency"] = on(name, lambda: cs.check_general_consistency(net, 4, cs.N_ENVS))()
        out[name]["ok"] = all(c["ok"] for c in out[name]["cases"])
    inputs = cs.epoch_inputs(net, 32, cs.N_ENVS, None)
    calls = {f"{name}/resident": (on(name, lambda: cg.launch_epoch(*inputs)), 3) for name in libs}
    calls["per_layer"] = (lambda: cg.launch_epoch(*inputs, route="per_layer"), 1)
    for key, v in cs.time_in_turns(calls).items():
        name = key.split("/")[0]
        if key == "per_layer":
            out["per_layer_ms"] = v["ms"]
        else:
            out[name]["epoch_ms"] = v["ms"]
            out[name]["epoch_ms_rounds"] = v["ms_rounds"]
    for name in libs:
        out[name]["kernel_us_per_minibatch"] = kernel_split(on(name, lambda: cg.launch_epoch(*inputs)), 32)
    return out


def kernel_split(fn, n_mb: int) -> dict:
    """Device time by kernel of one call (torch.profiler after a warm-up),
    in us a minibatch: the epoch's kernels by their short names, the rest
    (the image kernel, the wrapper's copies) as they are named."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)
            m = re.search(r"rep::(\w+)", evt.key)
            name = m.group(1) if m else evt.key[:60]
            out[name] = out.get(name, 0.0) + us / n_mb
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--resident", action="store_true", help="K2g's resident route (and --other builds)")
    ap.add_argument("--other", action="append", default=[], metavar="NAME=CSRC",
                    help="with --resident: fused_epoch_general.cu built from another csrc directory")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--trained", type=int, default=0, help="seeds of chip_smoke.hover7_train's trained network")
    ap.add_argument("--skip-grid", action="store_true", help="only the --trained part")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("general_epoch_probe: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pyflyt_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    results = {"card": cs.card_line()}
    print(results["card"], flush=True)
    cuda_build.build(["policy_general.cu", "fused_epoch_general.cu"])
    if args.resident:
        results["resident"] = resident_part(dict(o.split("=", 1) for o in args.other), 0)
        print(json.dumps({"resident": results["resident"]}), flush=True)
        finish(results, args.out)
        return 0 if all(v["ok"] for k, v in results["resident"].items() if k != "per_layer_ms") else 1

    kinds = ("kernel", "k_order", "tanh_f64", "bf16_out", "tail_512", "tail_64")
    if args.skip_grid:
        args.seeds = 0
    shapes = [(pi, vf, 21, 4, cs.N_ENVS, None) for pi, vf in cs.GENERAL_PAIRS]
    shapes += [(pi, vf, 72, 10, cs.N_RAGGED, cs.EPOCH_RANGE) for pi, vf in cs.GENERAL_PAIRS]
    grid = []
    for s in range(args.seeds):
        for k, (pi, vf, o, a, mb, rng) in enumerate(shapes):
            net = cs.general_net(1000 * s + 2000 + k, o, a, pi, vf)
            case = {"seed": s, "pi": pi, "vf": vf, "obs": o, "act": a, "mb": mb,
                    **read_case(cs, net, 2, mb, rng, kinds)}
            grid.append(case)
            print(json.dumps({"case": case}), flush=True)
    results["grid"] = grid
    if grid:
        results["grid_max"] = {kind: {f: max(c[kind][f] for c in grid) for f in ("mu_rel", "nu_rel", "p_err",
                                                                                  "met_rel")}
                               for kind in kinds}
        print(json.dumps({"grid_max": results["grid_max"]}), flush=True)

    trained = []
    for s in range(args.trained):
        _, tp, runner = cs.hover7_train(s, results["card"])
        for moments, opt in (("seeded", None), ("runner", runner.opt_state)):
            trained.append({"seed": s, "moments": moments, **read_case(
                cs, runner.network, 2, tp.config.minibatch_size, tp.config.log_std_range, kinds, opt)})
        print(json.dumps({"trained": trained[-1]}), flush=True)
    results["trained"] = trained
    if args.skip_grid:
        return finish(results, args.out)

    main_path = []
    for s in range(2):
        net = cs.general_net(4000 + s, 21, 4, cs.GENERAL_TRUNK, cs.GENERAL_TRUNK)
        main_path.append({"seed": s, **read_case(cs, net, 32, cs.N_ENVS, None, ("kernel", "k_order"))})
    results["main_path_32x8192"] = main_path
    print(json.dumps({"main_path_32x8192": main_path}), flush=True)

    net = cs.general_net(5000, 21, 4, cs.GENERAL_TRUNK, cs.GENERAL_TRUNK)
    results["k3g_rows_262144"] = cs.check_logp(net, 262144, atol=cs.logp_atol)
    print(json.dumps({"k3g_rows_262144": results["k3g_rows_262144"]}), flush=True)
    return finish(results, args.out)


def finish(results: dict, out) -> int:
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
