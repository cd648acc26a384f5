"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` source with a plain C interface.  At first
use ``nvcc`` compiles it for ``sm_90a`` into a shared library under
``build/repro_torch/`` at the repository root, and ``ctypes`` loads it.
A library's name carries a hash of its source and of the flags, so an
edited source is rebuilt and a stale library is never loaded.
``build_many`` starts one ``nvcc`` per missing library, all at once, and
waits for them together.  Nothing here runs at import: the CPU tests
import every module of the port, and only a machine with the CUDA
toolkit can build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Sequence, Tuple

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
# Per kernel, what the build that produced its library reported: seconds
# (wall time of the parallel build it was part of), whether it was built
# now or found, the library's name, and ptxas' register / spill lines.
_info: Dict[str, Dict[str, object]] = {}


def info(name: str) -> Dict[str, object]:
    """The build report of kernel ``name`` (filled in place at build)."""
    return _info.setdefault(name, {})


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no nvcc on PATH and no CUDA toolkit found; the "
                           "port's CUDA kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str, source: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_many(kernels: Sequence[Tuple[str, pathlib.Path]]) -> None:
    """Build every ``(name, source)`` whose library is missing, one
    ``nvcc`` each, all started together.  Raises if any fails."""
    t0 = time.perf_counter()
    procs = []
    for name, source in kernels:
        target = _target(name, source)
        if target.exists():
            if not info(name):  # found, not built by this process
                info(name).update(seconds=0.0, built_now=False, ptxas=[],
                                  library=target.name)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, source, target, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, source, target, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {source}:\n"
                          f"{out}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half
        info(name).update(
            seconds=time.perf_counter() - t0, built_now=True,
            library=target.name,
            ptxas=[ln.strip() for ln in out.splitlines()
                   if "registers" in ln or "spill" in ln])
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, source: pathlib.Path,
         symbols: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built from ``source`` at
    first use; ``symbols`` maps each C entry point to its ``argtypes``
    (each returns a ``cudaError_t`` as an int).  Raises if ``nvcc``
    fails; there is no fallback."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_many([(name, source)])
    lib = ctypes.CDLL(str(_target(name, source)))
    for sym, argtypes in symbols.items():
        fn = getattr(lib, sym)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _libs[name] = lib
    return lib
