"""Times K5 (``csrc/fixedwing_step.cu``: row 5 ``fixedwing_step``, row 6
``fixedwing_waypoints_step``) and K7 (``csrc/dogfight_step.cu``) on one
card at their stock shapes, as built and in variants of the same sources,
in one process and in turns:

- ``built``: the sources as they are (GROUP lanes a drone, the view read
  only on an aviary step's last physics iteration);
- ``g4``: GROUP = 4 in both sources (the lines marked ``probe: group``);
- ``g16``: GROUP = 16 in K5 (K5 only: K7's pairs of groups fill a warp);
- ``no_min_blocks``: K7 without its launch bound's minimum of blocks an
  SM (the line marked ``probe: min_blocks``): ptxas takes the registers
  it likes, where the bound caps them at the 128 that keep all 1024
  blocks of the league's width resident at once;
- ``no_hoist``: the view read on every physics iteration (the lines marked
  ``probe: read``);
- ``no_engage``: K7's gun cone stubbed (no ``sincosf``, ``sqrtf``,
  ``acosf``), to split K7's time from K5's;
- with ``--other NAME=ROOT`` (repeatable): ``NAME``, the two sources of
  another checkout (for example the one-thread-per-drone design, ``git
  archive`` of its commit unpacked under ``build/``), and
  ``NAME_no_engage``.

Shapes: row 5 and row 6 at 4096 envs of the stock Fixedwing-Waypoints env
(mode 0), K7 at 8192 drones of the league's env, each with motor noise on
and off, from states flown 16 agent steps from a reset with random
setpoints; K7 also (``k7_league``) on the state that ``chip_smoke.py``'s
serving rollout of the league's ``s100`` leaves, where ``chip_smoke.py``
times it. Beside each time:
the variant's registers (ptxas) and, noise off, its largest difference
from ``built`` over one call (``no_engage`` variants differ by design).

    python3 tools/fixedwing_lane_probe.py [--other NAME=ROOT ...] [--out FILE]

Needs a CUDA card and ``nvcc``; the variants are built under
``build/fixedwing_lane_probe/``. Prints the card line and one JSON line
per variant and round (two rounds, the second in reverse order).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SOURCES = ("fixedwing_step.cu", "dogfight_step.cu")
FW_ENVS, DF_ARENAS, WARM_STEPS, ROUNDS = 4096, 4096, 16, 2
# K7's gun cone as both designs write it, and its stub
ENGAGE = [
    ("sincosf(s.view[4], &sin_p, &cos_p);", "sin_p = 0.f, cos_p = 1.f;"),
    ("sincosf(s.view[5], &sin_y, &cos_y);", "sin_y = 0.f, cos_y = 1.f;"),
    ("const float dist_new = sqrtf(sep[0] * sep[0] + sep[1] * sep[1] + sep[2] * sep[2]);",
     "const float dist_new = sep[0] + sep[1] + sep[2];"),
    ("const float ang_new = acosf(fminf(fmaxf(__fdiv_rn(dot, fmaxf(dist_new, 1e-8f)), -1.f), 1.f));",
     "const float ang_new = dot;"),
]
# (variant, {source: [(marker or None, text, replacement), ...]}): on each
# line marked "probe: <marker>" (any line when None), `text` becomes
# `replacement`; every substitution must apply at least once
VARIANTS = {
    "g4": {s: [("group", "GROUP = 8;", "GROUP = 4;")] for s in SOURCES},
    "g16": {"fixedwing_step.cu": [("group", "GROUP = 8;", "GROUP = 16;")], "dogfight_step.cu": []},
    "no_min_blocks": {"fixedwing_step.cu": [],
                      "dogfight_step.cu": [("min_blocks", "__launch_bounds__(THREADS, MIN_BLOCKS)",
                                            "__launch_bounds__(THREADS)")]},
    "no_hoist": {s: [("read", "it == c.ratio - 1;", "true;")] for s in SOURCES},
    "no_engage": {"fixedwing_step.cu": [], "dogfight_step.cu": [(None, a, b) for a, b in ENGAGE]},
}
# the calls a variant is not timed on (by a part of its name)
SKIP = {"no_engage": ("row5", "row6"), "g16": ("k7", "k7_league"), "no_min_blocks": ("row5", "row6")}


def write_variant(name: str, csrc: str, subs: dict) -> str:
    """The sources of ``csrc`` with ``subs`` applied, and its headers, in
    the variant's directory; returns it."""
    out = os.path.join(HERE, "build", "fixedwing_lane_probe", name)
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith(".cuh"):
            with open(os.path.join(csrc, f)) as src, open(os.path.join(out, f), "w") as dst:
                dst.write(src.read())
    for source in SOURCES:
        with open(os.path.join(csrc, source)) as f:
            lines = f.read().split("\n")
        for marker, old, new in subs.get(source, []):
            hit = 0
            for i, line in enumerate(lines):
                if (marker is None or line.rstrip().endswith(f"probe: {marker})") or
                        line.rstrip().endswith(f"// probe: {marker}")) and old in line:
                    lines[i] = line.replace(old, new)
                    hit += 1
            if not hit:
                raise SystemExit(f"fixedwing_lane_probe: {name}: {old!r} (marker {marker}) not in {source}")
        with open(os.path.join(out, source), "w") as f:
            f.write("\n".join(lines))
    return out


def build_variant(cuda_build, name: str, src_dir: str) -> dict:
    """Both sources of ``src_dir`` compiled there: {source: (CDLL, ptxas log)}."""
    def one(source):
        lib = os.path.join(src_dir, source.replace(".cu", ".so"))
        p = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", src_dir, "-o", lib,
                            os.path.join(src_dir, source)], capture_output=True, text=True)
        if p.returncode != 0:
            raise SystemExit(f"fixedwing_lane_probe: {name}/{source} failed to build:\n{p.stdout}{p.stderr}")
        return source, (ctypes.CDLL(lib), p.stdout + p.stderr)

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(pool.map(one, SOURCES))


def registers(log: str) -> dict:
    """ptxas registers by kernel template (e.g. ``waypoints_kernel<0,1,0>``)."""
    found = re.findall(r"entry function '_Z\w*?(step_kernel|waypoints_kernel|dogfight_kernel)I(\w+?)EEv\w*'"
                       r".*?Used (\d+) registers", log, re.S)
    spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores", log))
    return {"by_template": {f"{k}<{t}>": int(r) for k, t, r in found}, "spill_store_bytes": spills}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=ROOT",
                    help="a checkout whose two sources to time beside these, under NAME")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fixedwing_lane_probe: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pyflyt_tpu_torch.models import fixedwing
    from pyflyt_tpu_torch.ops import cuda_build
    from pyflyt_tpu_torch.ops import cuda_dogfight as cd
    from pyflyt_tpu_torch.ops import cuda_fixedwing as cf

    results = {"card": cs.card_line()}
    print(results["card"], flush=True)
    csrc = str(cuda_build.CSRC)
    dirs = {name: write_variant(name, csrc, subs) for name, subs in VARIANTS.items()}
    dirs["built"] = write_variant("built", csrc, {})
    others = []
    for spec in args.other:
        name, root = spec.split("=", 1)
        src = os.path.join(os.path.abspath(root), "pyflyt_tpu_torch", "csrc")
        dirs[name] = write_variant(name, src, {})
        dirs[f"{name}_no_engage"] = write_variant(f"{name}_no_engage", src, VARIANTS["no_engage"])
        others += [name, f"{name}_no_engage"]
    with ThreadPoolExecutor(len(dirs)) as pool:
        libs = dict(zip(dirs, pool.map(lambda kv: build_variant(cuda_build, *kv), dirs.items())))
    results["registers"] = {name: {s: registers(log) for s, (_, log) in v.items()} for name, v in libs.items()}
    print(json.dumps({"registers": results["registers"]}), flush=True)

    kernels = {"row5": cf.STEP_KERNEL, "row6": cf.WAYPOINTS_KERNEL, "k7": cd.KERNEL}
    symbols = {"row5": ("fixedwing_step.cu", "fixedwing_step"),
               "row6": ("fixedwing_step.cu", "fixedwing_waypoints_step"),
               "k7": ("dogfight_step.cu", "dogfight_step")}

    def bind(name):
        fns = {}
        for key, (source, symbol) in symbols.items():
            fn = getattr(libs[name][source][0], symbol)
            fn.argtypes, fn.restype = kernels[key].argtypes, ctypes.c_int
            fns[key] = fn
        return fns

    bound = {name: bind(name) for name in libs}

    # the inputs: flown from a reset with the built kernels
    for key in kernels:
        kernels[key]._fn = bound["built"][key]
    g = torch.Generator(device="cuda").manual_seed(7)
    fenv = cs.fw_env()
    fst, _ = fenv.reset(FW_ENVS, g)
    fw = fst.packed.contiguous()
    denv = cs.df_env().penv
    dst, _ = denv.reset(DF_ARENAS, g)
    df = dst.packed.contiguous()
    seed = torch.tensor([17], dtype=torch.int64, device="cuda")
    for _ in range(WARM_STEPS):
        fw[cf._SP : cf._SP + 4] = torch.rand(4, FW_ENVS, device="cuda", generator=g) * 0.8 - 0.4
        fw[cf._SP + 3] = fw[cf._SP + 3].abs() + 0.3
        fw = cf.packed_waypoints_step(fw, seed, fenv.consts, 0, True)
        fw[cf._TERM : cf._TRUNC + 1] = 0.0  # keep every env flying
        df[cf._SP : cf._SP + 4] = torch.rand(4, 2 * DF_ARENAS, device="cuda", generator=g) * 0.8 - 0.4
        df[cf._SP + 3] = 0.75
        df = cd.packed_dogfight_step(df, seed, denv.consts, True)
    torch.cuda.synchronize()
    from pyflyt_tpu_torch.rl import checkpoint

    _, league = cs.df_rollout(checkpoint.load_policy_npz(cs.DF_POLICY, device="cuda"), 0, results["card"])
    league = league.contiguous()
    cfg = fixedwing.FixedwingConfig()
    c5 = cf.fixedwing_consts(fixedwing.build_params(cfg, "cuda"), cfg)
    calls = {
        "row5": lambda noisy: cf.packed_step(fw, seed, c5, 0, noisy),
        "row6": lambda noisy: cf.packed_waypoints_step(fw, seed, fenv.consts, 0, noisy),
        "k7": lambda noisy: cd.packed_dogfight_step(df, seed, denv.consts, noisy),
        "k7_league": lambda noisy: cd.packed_dogfight_step(league, seed, denv.consts, noisy),
    }
    reference = {key: call(False).clone() for key, call in calls.items()}

    order = ["built", "g4", "g16", "no_min_blocks", "no_hoist", "no_engage"] + others
    results["rounds"] = []
    try:
        for rnd in range(ROUNDS):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                for key in kernels:
                    kernels[key]._fn = bound[name][key]
                r = {"variant": name, "round": rnd}
                skip = [k for part, keys in SKIP.items() if part in name for k in keys]
                for key, call in calls.items():
                    if key in skip:
                        continue
                    if rnd == 0:
                        r[f"{key}_max_abs_diff_vs_built"] = (call(False) - reference[key]).abs().max().item()
                    for noisy in (True, False):
                        r[f"{key}_{'noise' if noisy else 'quiet'}_us"] = 1e3 * cs.time_ms(
                            lambda: call(noisy), iters=200)[0]
                results["rounds"].append(r)
                print(json.dumps({"probe": r}), flush=True)
    finally:
        for key in kernels:
            kernels[key]._fn = None
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
