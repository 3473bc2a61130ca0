"""Build the CUDA kernels under ``csrc/`` with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers: a file that includes
them takes minutes to compile, one with a C interface seconds). Sources are
compiled in parallel, one ``nvcc`` each, into ``csrc/build/`` (git-ignored);
a library's file name carries a hash of its source, the shared headers and
the flags, so an edited kernel is rebuilt and a stale one never loaded.
``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills) is kept
beside each library as ``<name>-<hash>.log``.

Nothing here runs at import: the CPU tests import every module, and a
build only starts when a kernel is first launched on a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
# Seconds of each kernel's nvcc run in this process's builds.
BUILD_SECONDS: dict[str, float] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    one on ``PATH``; raises when there is none."""
    candidates = [
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
        if os.environ.get("CUDA_HOME") else None,
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> float:
    """Compile every named kernel (default: all of ``csrc/``) whose library
    is missing, all ``nvcc`` processes at once; returns the wall seconds and
    records each compile's own seconds in :data:`BUILD_SECONDS`. Raises with
    the compiler's output when one fails."""
    names = sources() if names is None else names
    todo = [(n, library_path(n)) for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()

    def compile_one(item):
        name, lib = item
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        t = time.perf_counter()
        res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return name, lib, tmp, res, time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(todo)) as pool:
        results = list(pool.map(compile_one, todo))
    failed = []
    for name, lib, tmp, res, seconds in results:
        BUILD_SECONDS[name] = seconds
        lib.with_suffix(".log").write_text(res.stdout)
        if res.returncode != 0:
            failed.append(f"{name}: nvcc exited {res.returncode}\n{res.stdout}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """``nvcc``'s report for the current build of ``name``."""
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
