"""Builds the port's CUDA sources with ``nvcc`` and binds them with ctypes.

Each source in ``pyflyt_tpu_torch/csrc/`` is compiled on its own, at first
use, into a shared library with a plain C interface under
``build/torch_kernels/`` beside the package (the repository's ``build/``
directory). The library's name carries a digest of the sources and flags,
so an edited source is rebuilt and a stale library is never loaded. Several
sources can be compiled at once (``build``), one ``nvcc`` process each.

Nothing is compiled or loaded at import: the CPU tests import every module
and this host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``. Raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's CUDA "
        "kernels are built from pyflyt_tpu_torch/csrc at first use"
    )


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` is built: ``<stem>-<digest>.so``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[str]) -> dict[str, Path]:
    """Builds every source not yet built, all ``nvcc`` processes at once.
    Returns ``{source: library path}``; raises with the compiler's output
    if any build fails. The ptxas report (registers, spills) of each build
    is kept beside its library as ``.log``."""
    out = {s: library_path(s) for s in sources}
    todo = {s: p for s, p in out.items() if not p.exists()}
    if not todo:
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        procs[src] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    failures = []
    for src, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        lib = todo[src]
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src} (rc={proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


class Kernel:
    """One CUDA source, its C entry point and its launch count.

    ``fn()`` builds the source on first use and returns the bound C
    function; the wrapper that launches it adds one to ``launches`` per
    launch, and nowhere else.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def fn(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build([self.source])[self.source]))
            f = getattr(lib, self.symbol)
            f.argtypes = self.argtypes
            f.restype = ctypes.c_int
            self._fn = f
        return self._fn

    def check(self, rc: int) -> None:
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol} ({self.source}) failed to launch: CUDA error {rc}"
            )


# ---------------------------------------------------------------------------
# constants structs passed to a kernel by value
# ---------------------------------------------------------------------------


def array_field(n: int, ctype: str = "float"):
    """A dataclass field of ``n`` values: a ``float[n]`` (or ``int[n]``) in
    the C struct that ``struct_fields`` mirrors."""
    return dataclasses.field(metadata={"len": n, "ctype": ctype})


def struct_fields(consts_class) -> list:
    """ctypes ``_fields_`` mirroring a constants dataclass field by field:
    ``array_field``s as arrays, ``float`` and ``int`` fields as scalars."""
    types = {"float": ctypes.c_float, "int": ctypes.c_int}
    return [
        (f.name, types[f.metadata["ctype"]] * f.metadata["len"] if "len" in f.metadata else types[f.type])
        for f in dataclasses.fields(consts_class)
    ]


class ConstsStruct(ctypes.Structure):
    """Base of the ctypes mirrors of the kernels' constants structs."""

    @classmethod
    @functools.lru_cache(maxsize=16)  # one per env config; saves host time per launch
    def of(cls, c) -> "ConstsStruct":
        s = cls()
        for name, _ in cls._fields_:
            v = getattr(c, name)
            if isinstance(v, tuple):
                getattr(s, name)[:] = v
            else:
                setattr(s, name, v)
        return s
