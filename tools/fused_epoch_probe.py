"""Splits K2's time (``cuda_sgd.fused_epoch``, csrc/fused_epoch.cu) on one
card: the epoch at the hover shapes (32 minibatches x 8192 rows, obs 21)
by kernel (torch.profiler), as built and with one part of the
forward/backward kernel taken out at a time, in one process:

- ``no_tanh``: the epilogues' ``tanhf`` (both layers) replaced by the
  identity;
- ``no_ws_stores``: no bf16 workspace stores (x, h1, h2, dz1, dz2);
- ``no_spill``: the f32 ``1 - h1^2`` tile neither written nor read back;
- ``no_image_write``: Adam leaves the next minibatch's weight images
  unwritten;
- ``no_pdl``: every kernel launched after its predecessor has finished
  (no programmatic dependent launch). Under the launch, a kernel's
  profiler time includes its wait for its predecessor, so this variant
  gives the split by kernel.

    python3 tools/fused_epoch_probe.py [--out FILE]

Needs a CUDA card and ``nvcc``; the variants are built under
``build/fused_epoch_probe/``. Prints the card line and one JSON line per
variant. A variant's outputs are wrong by design: it is timed, never
checked.
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

# (variant, [(marker, text, replacement), ...]): on every line of
# csrc/fused_epoch.cu that ends in "// probe: <marker>", `text` becomes
# `replacement`; a text of None stands for the line's whole statement
VARIANTS = {
    "no_tanh": [("tanh", "tanhf(", "(")],
    "no_ws_stores": [("ws_store", None, "(void)dst;")],
    "no_spill": [("spill_store", None, "(void)gg;"),
                 ("spill_load", "spill[(i0 + u) * 128 + t]", "make_float4(1.f, 1.f, 1.f, 1.f)")],
    "no_image_write": [("image_write", None, "(void)w;")],
    "no_pdl": [("pdl", "= 1;", "= 0;")],
}
KERNELS = ("fwd_bwd_kernel", "wgrad_kernel", "reduce_kernel", "adam_kernel", "image_kernel")


def build_variant(cuda_build, name: str) -> tuple[str, str]:
    """csrc/fused_epoch.cu with the variant's substitutions: (source, library) paths."""
    out = os.path.join(HERE, "build", "fused_epoch_probe", name)
    os.makedirs(out, exist_ok=True)
    lines = (cuda_build.CSRC / "fused_epoch.cu").read_text().split("\n")
    for marker, old, new in VARIANTS[name]:
        tag = f"  // probe: {marker}"
        at = [i for i, line in enumerate(lines) if line.endswith(tag)]
        if not at:
            raise SystemExit(f"fused_epoch_probe: no line of csrc/fused_epoch.cu is marked {tag.strip()!r}")
        for i in at:
            code = lines[i][: -len(tag)]
            if old is None:
                code = code[: len(code) - len(code.lstrip())] + new
            elif old in code:
                code = code.replace(old, new)
            else:
                raise SystemExit(f"fused_epoch_probe: {old!r} is not on the line marked {tag.strip()!r}")
            lines[i] = code
    src = "\n".join(lines)
    path = os.path.join(out, "fused_epoch.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out, "fused_epoch.so")
    return path, lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fused_epoch_probe: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pyflyt_tpu_torch.ops import cuda_build, cuda_sgd
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    results = {"card": cs.card_line()}
    print(results["card"], flush=True)
    cuda_build.build(["fused_epoch.cu"])
    procs = {}
    for name in VARIANTS:  # every variant's nvcc at once
        path, lib = build_variant(cuda_build, name)
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC), "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"fused_epoch_probe: nvcc failed on {name}:\n{log}")
        fn = getattr(ctypes.CDLL(lib), "fused_epoch")
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
        libs[name] = fn

    net = ActorCritic(21, 4, device="cuda", generator=torch.Generator().manual_seed(0))
    leaves = [t.detach().contiguous() for t in cuda_sgd.params_to_leaves(net)]
    g = torch.Generator(device="cuda").manual_seed(1)
    mu = [torch.randn(t.shape, generator=g, device="cuda") * 1e-3 for t in leaves]
    nu = [torch.rand(t.shape, generator=g, device="cuda") * 1e-5 for t in leaves]
    mbs = cs.packed_rows(net, cs.BATCH, seed=2).reshape(32, cs.N_ENVS, -1)
    stats = cs.adv_stats(mbs[:, :, 21 + 4 + 1])
    t0 = torch.tensor([3], dtype=torch.int32, device="cuda")
    ecfg = cuda_sgd.EpochConfig(21, 4, (256, 256), (256, 256), learning_rate=3e-4, clip_eps=0.2,
                                entropy_coef=0.01, value_coef=0.5, max_grad_norm=0.5)
    run = lambda: cuda_sgd.fused_epoch(mbs, stats, t0, leaves, mu, nu, ecfg)  # noqa: E731
    built = cuda_sgd.EPOCH_KERNEL.fn()
    split = []
    try:
        for name in ("built", *VARIANTS, "built"):
            cuda_sgd.EPOCH_KERNEL._fn = built if name == "built" else libs[name]
            ms, _ = cs.time_ms(run, iters=3, repeats=3)
            prof = cs.profiled(run, f"profile_{name}")
            by = {k: sum(r["device_us"] for r in prof["top"] if k in r["name"]) / 32 for k in KERNELS}
            r = {"variant": name, "epoch_ms": ms, "us_per_minibatch": by}
            split.append(r)
            print(json.dumps({"fused_epoch_split": r}), flush=True)
    finally:
        cuda_sgd.EPOCH_KERNEL._fn = built
    results["fused_epoch_split"] = split
    results["ptxas"] = cs.ptxas_usage("fused_epoch.cu")
    print(json.dumps({"ptxas": results["ptxas"]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
