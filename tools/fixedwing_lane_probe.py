"""Times the vehicle kernels on one card at their stock shapes, as built
and in variants of the same sources, in one process and in turns: K5
(``csrc/fixedwing_step.cu``: row 5 ``fixedwing_step``, row 6
``fixedwing_waypoints_step``), K7 (``csrc/dogfight_step.cu``), K6
(``csrc/rocket_step.cu``: row 8 ``rocket_step``, row 9
``rocket_landing_step``), K1-hover (row 1, ``csrc/quadx_hover_step.cu``),
K1 generic (row 2, ``csrc/quadx_step.cu``) and the waypoints step (row 4,
``csrc/quadx_waypoints_step.cu``). The variants:

- ``built``: the sources as they are;
- ``g2``, ``g4``, ``g8``, ``g16``: GROUP lanes a vehicle (the lines
  marked ``probe: group``): K6 at 2 and 8 (at 8 with a launch bound of 8
  blocks an SM, 128 registers, so that 8192 envs' 1024 blocks are all
  resident at once); K5 and K7 at 4; K5 at 16 (K7's pairs of groups fill
  a warp at 8);
- ``no_min_blocks``: K7 without its launch bound's minimum of blocks an
  SM (the line marked ``probe: min_blocks``): ptxas takes the registers it
  likes, where the bound caps them at 128, which keeps all 1024 blocks of
  its stock width resident at once;
- ``no_hoist``: the view read on every physics iteration (the lines marked
  ``probe: read``; in rows 1, 2 and 4 the shared iteration's ``read``
  argument);
- ``no_recip``: rows 1, 2 and 4 dividing by the mass, the inertia and the
  control period (in mode 7 also the cascade's), where they multiply by
  reciprocals taken once a launch (the lines marked ``probe: recip``);
- ``select_freeze``: row 4's done-freeze as a copy of the lane and a
  select after each aviary step, where it leaves the aviary loop (the
  lines marked ``probe: freeze``);
- ``roll_branch``: the target roll (``quadx_math.cuh::waypoint_track``,
  rows 4 and 6) storing the first target under ``if (k == nt - 1)``, where
  it selects in every slot: the compiler addressed that store at slot
  nt - 1, a runtime index, and kept the caller's whole lane in local
  memory;
- ``staged``: row 4's design B (``STAGED_STEP``): the block's tile of the
  rows it reads lands in shared memory by one bulk copy a row, completing
  on one mbarrier, and the rows go back by one bulk copy each;
- ``no_engage``: K7's gun cone stubbed (no ``sincosf``, ``sqrtf``,
  ``acosf``), to split K7's time from K5's;
- with ``--other NAME=ROOT`` (repeatable): ``NAME``, the sources of
  another checkout (for example the parent commit, ``git archive`` of its
  ``pyflyt_tpu_torch/csrc`` unpacked under ``build/``), and
  ``NAME_no_engage``.

A variant is timed on the calls of the sources it changes (``NAME`` on
all). Shapes: row 5 and row 6 at 4096 envs of the stock
Fixedwing-Waypoints env (mode 0) and K7 at 8192 drones of the league's env,
from states flown 16 agent steps from a reset with random setpoints, K7
also (``k7_league``) on the state that ``chip_smoke.py``'s serving rollout
of the league's ``s100`` leaves; rows 8 and 9 at 8192 envs on the state of
step 32 of ``chip_smoke.py``'s rocket serving rollout (the archived L0
acting), where ``chip_smoke.py`` times them; row 1 at 8192 envs on the
state a 64-step hover rollout with auto-reset leaves (a seeded random
policy), and, as built and in the ``--other`` checkouts, with ``ratio``
1-4 physics iterations an aviary step (``row1_ratio<r>``), which prices
one iteration; row 2 at 8192 envs of the mod-hovering recipe (mode 9, NED,
per-env wind base, gusts) on the state ``chip_smoke.py``'s 128-step
rollout under the exact auto-reset leaves, also at ``ratio`` 1-4
(``row2_ratio<r>``); row 4 at 8192 stock mode-7 envs on the state
``chip_smoke.py``'s 128-step waypoints serving rollout leaves. Each with
noise on and off. Beside each time: the
variant's registers, stack frames and spill stores (ptxas) and its
largest difference from ``built`` over one call, noise off and on
(``no_engage`` differs by design; a changed GROUP sums in another order;
dividing moves the last bit); and for each ``--other`` checkout, the lines
of each source's SASS that differ from ``built``'s (``cuobjdump -sass``,
function by function, the anonymous namespace's hash taken out).

    python3 tools/fixedwing_lane_probe.py [--other NAME=ROOT ...] [--out FILE]
    python3 tools/fixedwing_lane_probe.py --locals quadx_waypoints_step.cu
    python3 tools/fixedwing_lane_probe.py --sass build/parent/pyflyt_tpu_torch/csrc/quadx_hover_step.cu \
        pyflyt_tpu_torch/csrc/quadx_hover_step.cu --match hover_step_kernelILi0E --match hover_step_kernelILi8E

Needs a CUDA card and ``nvcc``; the variants are built under
``build/fixedwing_lane_probe/``, each source only where the variant
changes it. Prints the card line and one JSON line per variant and round
(two rounds, the second in reverse order). With ``--locals SOURCE`` it
only compiles SOURCE to PTX with ``-lineinfo``, as built and in each
variant that changes it, and prints each kernel's local-memory bytes and
its local loads and stores by source line: where a frame that ptxas
reports comes from. With ``--sass BEFORE AFTER`` it only builds two
versions of a source (``nvcc``, no card needed) and compares the SASS of
the functions whose mangled names hold a ``--match`` string, instruction
for instruction: whether an edit left them as they were; it exits 1 if
one differs or is missing.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import difflib
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

K5, K7, K6, K1 = "fixedwing_step.cu", "dogfight_step.cu", "rocket_step.cu", "quadx_hover_step.cu"
K1G, K1W = "quadx_step.cu", "quadx_waypoints_step.cu"
SOURCES = (K5, K7, K6, K1, K1G, K1W)
FW_ENVS, DF_ARENAS, HOVER_ENVS, WARM_STEPS, HOVER_STEPS, ROUNDS = 4096, 4096, 8192, 16, 64, 2
RATIOS = (1, 2, 3, 4)
# row 4's design B: the block's tile staged through shared memory, one bulk
# copy a row in (completing on one mbarrier) and one a row out; the step
# runs on its column of the tile. Where n is not a multiple of 4 or an end
# is not 16-byte aligned, a row segment is not a whole number of 16 B, and
# each thread reads and writes its own column as in the kernel without it.
STAGED_STEP = r"""
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int MODE>
__device__ __forceinline__ bool row_read(int r) {  // all but the re-armed reward and the padding
  constexpr int WB = Layout<MODE>::WB;
  const int end = (MODE == 7) ? quadx_lane::CASCADE + quadx_lane::CASCADE_ROWS : STEP + 1;
  return r < RWD || (r > RWD && r < end) || (r >= WB && r < WB + WP_ROWS);
}

template <int MODE, bool NOISY, bool SPARSE>
__device__ __forceinline__ void staged_step(const float* __restrict__ in, float* __restrict__ out, int n, int i,
                                            const long long* __restrict__ seed, const WaypointsConsts& c) {
  constexpr int ROWS = Layout<MODE>::ROWS;
  const size_t ld = static_cast<size_t>(n);
  if (n % 4 != 0 || ((reinterpret_cast<unsigned long long>(in) | reinterpret_cast<unsigned long long>(out)) & 15)) {
    if (i < n) agent_step<MODE, NOISY, SPARSE>(in + i, out + i, ld, i, seed, c);
    return;
  }
  __shared__ __align__(128) float tile[ROWS * THREADS];
  __shared__ __align__(8) unsigned long long bar;
  const size_t col0 = static_cast<size_t>(blockIdx.x) * THREADS;
  const unsigned seg = 4u * static_cast<unsigned>(min(THREADS, n - static_cast<int>(col0)));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(&bar)), "r"(THREADS) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  unsigned mine = 0;
  for (int r = threadIdx.x; r < ROWS; r += THREADS) mine += row_read<MODE>(r) ? seg : 0u;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(&bar)), "r"(mine)
               : "memory");
  for (int r = threadIdx.x; r < ROWS; r += THREADS)
    if (row_read<MODE>(r))
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                   ::"r"(smem_u32(tile + r * THREADS)), "l"(in + r * ld + col0), "r"(seg), "r"(smem_u32(&bar))
                   : "memory");
  unsigned done = 0;
  do {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\nselp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(smem_u32(&bar)) : "memory");
  } while (!done);
  float* col = tile + threadIdx.x;
  if (i < n) agent_step<MODE, NOISY, SPARSE>(col, col, THREADS, i, seed, c);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  for (int r = threadIdx.x; r < ROWS; r += THREADS)
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(out + r * ld + col0), "r"(smem_u32(tile + r * THREADS)), "r"(seg) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
"""
WP_KERNEL_NOTE = "// One thread an env, the ragged tail masked."
WP_CALL = "if (i < n) agent_step<MODE, NOISY, SPARSE>(in + i, out + i, ld, i, seed, c);"
# K7's gun cone as both designs write it, and its stub
ENGAGE = [
    ("sincosf(s.view[4], &sin_p, &cos_p);", "sin_p = 0.f, cos_p = 1.f;"),
    ("sincosf(s.view[5], &sin_y, &cos_y);", "sin_y = 0.f, cos_y = 1.f;"),
    ("const float dist_new = sqrtf(sep[0] * sep[0] + sep[1] * sep[1] + sep[2] * sep[2]);",
     "const float dist_new = sep[0] + sep[1] + sep[2];"),
    ("const float ang_new = acosf(fminf(fmaxf(__fdiv_rn(dot, fmaxf(dist_new, 1e-8f)), -1.f), 1.f));",
     "const float ang_new = dot;"),
]


def group(g: int) -> tuple:
    return ("group", re.compile(r"GROUP = \d+;"), f"GROUP = {g};")


# (variant, {source: [(marker or None, text or regex, replacement), ...]}):
# on each line marked "probe: <marker>" (any line when None), `text`
# becomes `replacement`; every substitution must apply at least once
VARIANTS = {
    "g2": {K6: [group(2)]},
    "g4": {s: [group(4)] for s in (K5, K7)},
    "g8": {K6: [group(8), (None, re.compile(r"__launch_bounds__\(THREADS\)$"), "__launch_bounds__(THREADS, 8)")]},
    "g16": {K5: [group(16)]},
    "no_min_blocks": {K7: [("min_blocks", "__launch_bounds__(THREADS, MIN_BLOCKS)", "__launch_bounds__(THREADS)")]},
    "no_hoist": {s: [("read", "it == c.ratio - 1;", "true;")] for s in SOURCES},
    "no_recip": {s: [("recip", "&rcp)", "nullptr)")] for s in (K1, K1G, K1W)},
    "select_freeze": {K1W: [
        ("freeze", "if (fminf(fmaxf(s.term, s.trunc), 1.f) > 0.f) break;",
         "const bool frozen = fminf(fmaxf(s.term, s.trunc), 1.f) > 0.f; const WaypointsLane kept = s;"),
        ("freeze", "s.oob = fminf(s.oob + oob_i, 1.f);", "s.oob = fminf(s.oob + oob_i, 1.f); if (frozen) s = kept;"),
    ]},
    # the target roll's last slot stored under `k == nt - 1`, which the
    # compiler addresses at a runtime index (rows 4 and 6 call it)
    "roll_branch": {"quadx_math.cuh": [(None, "const bool last = k == nt - 1;", "if (k == nt - 1) {"),
                                       (None, "tgt[3 * k + i] = last ? first[i] : tgt[3 * k + i];",
                                        "tgt[3 * k + i] = first[i]; }")], K5: [], K1W: []},
    "staged": {K1W: [(None, WP_KERNEL_NOTE, STAGED_STEP + WP_KERNEL_NOTE),
                     ("staged", WP_CALL, "staged_step<MODE, NOISY, SPARSE>(in, out, n, i, seed, c);")]},
    "no_engage": {K7: [(None, a, b) for a, b in ENGAGE]},
}
CALL_SOURCE = {"row5": K5, "row6": K5, "k7": K7, "k7_league": K7, "row8": K6, "row9": K6, "row1": K1,
               "row2": K1G, "row4": K1W, **{f"row1_ratio{r}": K1 for r in RATIOS},
               **{f"row2_ratio{r}": K1G for r in RATIOS}}
SWEEPS = ("row1_ratio", "row2_ratio")


def write_variant(name: str, csrc: str, subs: dict) -> str:
    """The sources and headers of ``csrc`` with ``subs`` applied, in the
    variant's directory; returns it."""
    out = os.path.join(HERE, "build", "fixedwing_lane_probe", name)
    os.makedirs(out, exist_ok=True)
    headers = [f for f in os.listdir(csrc) if f.endswith(".cuh")]
    for source in [*headers, *SOURCES]:
        with open(os.path.join(csrc, source)) as f:
            lines = f.read().split("\n")
        for marker, old, new in subs.get(source, []):
            hit = 0
            for i, line in enumerate(lines):
                if not (marker is None or line.rstrip().endswith(f"probe: {marker})") or
                        line.rstrip().endswith(f"// probe: {marker}")):
                    continue
                if isinstance(old, re.Pattern) and old.search(line):
                    lines[i] = old.sub(new, line)
                    hit += 1
                elif isinstance(old, str) and old in line:
                    lines[i] = line.replace(old, new)
                    hit += 1
            if not hit:
                raise SystemExit(f"fixedwing_lane_probe: {name}: {old!r} (marker {marker}) not in {source}")
        with open(os.path.join(out, source), "w") as f:
            f.write("\n".join(lines))
    return out


def build_variant(cuda_build, name: str, src_dir: str, sources) -> dict:
    """``sources`` of ``src_dir`` compiled there: {source: (CDLL, ptxas log)}."""
    def one(source):
        lib = os.path.join(src_dir, source.replace(".cu", ".so"))
        p = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", src_dir, "-o", lib,
                            os.path.join(src_dir, source)], capture_output=True, text=True)
        if p.returncode != 0:
            raise SystemExit(f"fixedwing_lane_probe: {name}/{source} failed to build:\n{p.stdout}{p.stderr}")
        return source, (ctypes.CDLL(lib), p.stdout + p.stderr)

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, sources))


def local_accesses(cuda_build, src_dir: str, source: str) -> dict:
    """The local-memory traffic of ``source``'s PTX (built with
    ``-lineinfo``): each kernel's ``__local_depot`` bytes, and the
    ``ld.local``/``st.local`` instructions by the source line they come
    from, most first."""
    ptx = os.path.join(src_dir, source.replace(".cu", ".ptx"))
    p = subprocess.run([cuda_build.nvcc_path(), "-arch=sm_90a", "-std=c++17", "-O3", "-lineinfo", "--ptx",
                        "-I", src_dir, "-o", ptx, os.path.join(src_dir, source)], capture_output=True, text=True)
    if p.returncode != 0:
        raise SystemExit(f"fixedwing_lane_probe: {source} PTX failed:\n{p.stdout}{p.stderr}")
    text = open(ptx).read()
    files = {m.group(1): os.path.basename(m.group(2)) for m in re.finditer(r'\.file\s+(\d+)\s+"([^"]+)"', text)}
    loc, depots, lines, entry = "?", {}, {}, "?"
    for ln in text.splitlines():
        t = ln.strip()
        if m := re.search(r"\.entry (\w+)", t):
            entry = m.group(1)
        elif m := re.match(r"\.loc\s+(\d+)\s+(\d+)", t):
            loc = f"{files.get(m.group(1), m.group(1))}:{m.group(2)}"
        elif m := re.search(r"__local_depot\d+\[(\d+)\]", t):
            depots[entry] = int(m.group(1))
        elif re.match(r"(ld|st)\.local", t):
            lines[loc] = lines.get(loc, 0) + 1
    return {"depot_bytes": depots, "accesses_by_line": dict(sorted(lines.items(), key=lambda kv: -kv[1]))}


def registers(log: str) -> dict:
    """ptxas's report by kernel template (e.g. ``waypoints_kernel<0,1,0>``):
    [registers, stack frame bytes, spill store bytes]; the largest frame
    and the spill stores summed."""
    by = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        m = re.match(r"_Z\w*?(hover_step_kernel|rocket_kernel|step_kernel|waypoints_kernel|dogfight_kernel)"
                     r"I(\w+?)EEv", chunk)
        used = re.search(r"Used (\d+) registers", chunk)
        if not (m and used):
            continue
        frame = re.search(r"(\d+) bytes stack frame", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        by[f"{m.group(1)}<{m.group(2)}>"] = [int(used.group(1)), int(frame.group(1)) if frame else 0,
                                             int(spill.group(1)) if spill else 0]
    return {"by_template": by, "max_stack_frame": max((v[1] for v in by.values()), default=0),
            "spill_store_bytes": sum(v[2] for v in by.values())}


_FILE_HASH = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def sass_functions(cuda_build, lib: str) -> dict[str, list[str]]:
    """``{mangled name: SASS lines}`` of a built library (``cuobjdump
    -sass``), the anonymous namespace's per-file hash taken out and each
    line's tokens single-spaced (cuobjdump pads its columns to the widest
    line of the file)."""
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    out: dict[str, list[str]] = {}
    name = None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = _FILE_HASH.sub("", m.group(1))
            out[name] = []
        elif name is not None and ln.strip() and not ln.lstrip().startswith("Fatbin"):
            out[name].append(" ".join(_FILE_HASH.sub("", ln).split()))
    return out


def function_diffs(cuda_build, lib_a: str, lib_b: str, match=()) -> dict:
    """For each function of two builds whose mangled name holds one of
    ``match`` (every function if empty): the lines in which its SASS
    differs (a function missing from one build differs in all its lines),
    and the first differences."""
    a_fns, b_fns = sass_functions(cuda_build, lib_a), sass_functions(cuda_build, lib_b)
    out = {}
    for n in sorted(n for n in set(a_fns) | set(b_fns) if not match or any(m in n for m in match)):
        a, b = a_fns.get(n, []), b_fns.get(n, [])
        ops = [op for op in difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes() if op[0] != "equal"]
        out[n] = {"lines_before": len(a), "lines_after": len(b),
                  "lines_differing": sum(max(i2 - i1, j2 - j1) for _, i1, i2, j1, j2 in ops),
                  "first_differences": [[a[i1:i2][:4], b[j1:j2][:4]] for _, i1, i2, j1, j2 in ops[:4]]}
    return out


def sass_diff(cuda_build, lib_a: str, lib_b: str, match=()) -> int:
    """Lines in which two builds' SASS differs, over the functions that
    ``function_diffs`` compares."""
    return sum(d["lines_differing"] for d in function_diffs(cuda_build, lib_a, lib_b, match).values())


def sass_against(cuda_build, before: str, after: str, match) -> int:
    """``--sass``: both sources built with the port's flags (each with its
    own directory on the include path) under
    ``build/fixedwing_lane_probe/sass/<source>`` (so that several sources
    compare at once); prints ``function_diffs`` of the
    functions ``match`` names as one JSON line; 1 if one differs or is
    missing, or none matched."""
    work = os.path.join(HERE, "build", "fixedwing_lane_probe", "sass", os.path.basename(after).replace(".", "_"))
    os.makedirs(work, exist_ok=True)
    libs = []
    for tag, source in (("before", before), ("after", after)):
        lib = os.path.join(work, f"{tag}.so")
        subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", os.path.dirname(os.path.abspath(source)),
                        "-o", lib, source], check=True, capture_output=True, text=True)
        libs.append(lib)
    diffs = function_diffs(cuda_build, *libs, match)
    ok = bool(diffs) and all(d["lines_differing"] == 0 for d in diffs.values())
    print(json.dumps({"sass_functions": diffs, "unchanged": ok}), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=ROOT",
                    help="a checkout whose sources to time beside these, under NAME")
    ap.add_argument("--out", default=None)
    ap.add_argument("--locals", action="append", default=[], metavar="SOURCE",
                    help="only print SOURCE's local-memory accesses by source line (PTX with -lineinfo), "
                         "as built and in each variant that changes it, and exit")
    ap.add_argument("--sass", nargs=2, metavar=("BEFORE", "AFTER"),
                    help="only compare the SASS of the --match functions of two builds of a source, and exit")
    ap.add_argument("--match", action="append", default=[], help="with --sass: a substring of the mangled names")
    args = ap.parse_args(argv)
    if args.sass:
        from pyflyt_tpu_torch.ops import cuda_build

        return sass_against(cuda_build, *args.sass, args.match)
    import torch

    if not torch.cuda.is_available():
        print("fixedwing_lane_probe: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pyflyt_tpu_torch.envs.packed_hover import PackedQuadXHoverEnv, packed_autoreset_init
    from pyflyt_tpu_torch.envs.quadx_hover import QuadXHoverEnv
    from pyflyt_tpu_torch.models import fixedwing, rocket
    from pyflyt_tpu_torch.ops import cuda_build
    from pyflyt_tpu_torch.ops import cuda_dogfight as cd
    from pyflyt_tpu_torch.ops import cuda_fixedwing as cf
    from pyflyt_tpu_torch.ops import cuda_quadx as cq
    from pyflyt_tpu_torch.ops import cuda_rocket as cr
    from pyflyt_tpu_torch.rl import checkpoint, ppo
    from pyflyt_tpu_torch.rl.networks import ActorCritic

    results = {"card": cs.card_line()}
    print(results["card"], flush=True)
    csrc = str(cuda_build.CSRC)
    dirs = {name: write_variant(name, csrc, subs) for name, subs in VARIANTS.items()}
    dirs["built"] = write_variant("built", csrc, {})
    if args.locals:
        jobs = [(name, src) for src in args.locals for name in dirs if name == "built" or src in VARIANTS[name]]
        with ThreadPoolExecutor(len(jobs)) as pool:
            found = pool.map(lambda job: local_accesses(cuda_build, dirs[job[0]], job[1]), jobs)
        for (name, src), rec in zip(jobs, found):
            print(json.dumps({"locals": {"variant": name, "source": src, **rec}}), flush=True)
        return 0
    changed = {name: tuple(s for s in SOURCES if s in subs) for name, subs in VARIANTS.items()}
    changed["built"] = SOURCES
    others = []
    for spec in args.other:
        name, root = spec.split("=", 1)
        src = os.path.join(os.path.abspath(root), "pyflyt_tpu_torch", "csrc")
        dirs[name] = write_variant(name, src, {})
        dirs[f"{name}_no_engage"] = write_variant(f"{name}_no_engage", src, VARIANTS["no_engage"])
        changed[name], changed[f"{name}_no_engage"] = SOURCES, (K7,)
        others += [name, f"{name}_no_engage"]
    with ThreadPoolExecutor(len(dirs)) as pool:
        libs = dict(zip(dirs, pool.map(lambda name: build_variant(cuda_build, name, dirs[name], changed[name]),
                                       dirs)))
    results["registers"] = {name: {s: registers(log) for s, (_, log) in v.items()} for name, v in libs.items()}
    print(json.dumps({"registers": results["registers"]}), flush=True)
    results["sass_lines_differing_from_built"] = {
        name: {s: sass_diff(cuda_build, os.path.join(dirs["built"], s.replace(".cu", ".so")),
                            os.path.join(dirs[name], s.replace(".cu", ".so"))) for s in SOURCES}
        for name in others if not name.endswith("_no_engage")}
    print(json.dumps({"sass_lines_differing_from_built": results["sass_lines_differing_from_built"]}), flush=True)

    kernels = {"row5": cf.STEP_KERNEL, "row6": cf.WAYPOINTS_KERNEL, "k7": cd.KERNEL, "row8": cr.STEP_KERNEL,
               "row9": cr.LANDING_KERNEL, "row1": cq.KERNEL, "row2": cq.GENERIC_KERNEL, "row4": cq.WAYPOINTS_KERNEL}

    def bind(name):
        """The variant's entry points, the built ones for the sources it
        leaves as they are."""
        fns = {}
        for key, kernel in kernels.items():
            lib = libs[name] if kernel.source in libs[name] else libs["built"]
            fn = getattr(lib[kernel.source][0], kernel.symbol)
            fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
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
    _, league = cs.df_rollout(checkpoint.load_policy_npz(cs.DF_POLICY, device="cuda"), 0, results["card"])
    league = league.contiguous()
    _, rk = cs.rk_rollout(checkpoint.load_policy_npz(cs.RK_POLICY, device="cuda"), 0, results["card"])
    rk = rk.contiguous()
    henv = PackedQuadXHoverEnv(base=QuadXHoverEnv(device="cuda"))
    hnet = ActorCritic(henv.obs_size, 4, device="cuda", generator=torch.Generator().manual_seed(0))
    ars, hobs = packed_autoreset_init(henv, HOVER_ENVS, g)
    ars, _, _ = ppo.rollout(hnet, henv, ars, hobs, HOVER_STEPS, g, refresh=64)
    hover = ars.env_state.packed.contiguous()
    _, mod = cs.mod_rollout(0, results["card"])
    mod = mod.packed.contiguous()
    c2 = cs.recipe_env().consts
    _, wp, _, _ = cs.wp_rollout(0, results["card"])
    wp = wp.packed.contiguous()
    c4 = cs.wp_env(7).consts
    cfg = fixedwing.FixedwingConfig()
    c5 = cf.fixedwing_consts(fixedwing.build_params(cfg, "cuda"), cfg)
    rcfg = rocket.RocketConfig()
    c8 = cr.rocket_consts(rocket.build_params(rcfg, "cuda"), rcfg)
    c9 = cs.rk_env().consts
    c1 = henv.consts
    calls = {
        "row5": lambda noisy: cf.packed_step(fw, seed, c5, 0, noisy),
        "row6": lambda noisy: cf.packed_waypoints_step(fw, seed, fenv.consts, 0, noisy),
        "k7": lambda noisy: cd.packed_dogfight_step(df, seed, denv.consts, noisy),
        "k7_league": lambda noisy: cd.packed_dogfight_step(league, seed, denv.consts, noisy),
        "row8": lambda noisy: cr.packed_step(rk, seed, c8, noisy),
        "row9": lambda noisy: cr.packed_landing_step(rk, seed, c9, noisy),
        "row1": lambda noisy: cq.packed_hover_step(hover, seed, c1, 0, noisy),
        "row2": lambda noisy: cq.packed_step(mod, seed, c2, 9, noisy),
        "row4": lambda noisy: cq.packed_waypoints_step(wp, seed, c4, 7, noisy),
    }
    for r in RATIOS:
        cr_ = dataclasses.replace(c1, ratio=r)
        calls[f"row1_ratio{r}"] = lambda noisy, cr_=cr_: cq.packed_hover_step(hover, seed, cr_, 0, noisy)
        cg_ = dataclasses.replace(c2, ratio=r)
        calls[f"row2_ratio{r}"] = lambda noisy, cg_=cg_: cq.packed_step(mod, seed, cg_, 9, noisy)
    reference = {(key, noisy): call(noisy).clone() for key, call in calls.items() for noisy in (False, True)}

    order = ["built", *VARIANTS] + others
    results["rounds"] = []
    try:
        for rnd in range(ROUNDS):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                for key in kernels:
                    kernels[key]._fn = bound[name][key]
                r = {"variant": name, "round": rnd}
                for key, call in calls.items():
                    if CALL_SOURCE[key] not in changed[name]:
                        continue
                    if key.startswith(SWEEPS) and name != "built" and name not in others:
                        continue
                    if rnd == 0:
                        for noisy, tag in ((False, ""), (True, "noisy_")):
                            r[f"{key}_{tag}max_abs_diff_vs_built"] = (
                                call(noisy) - reference[key, noisy]).abs().max().item()
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
