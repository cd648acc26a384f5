"""Build and load the ``cache_sim`` CUDA kernel.

At first use, ``nvcc`` compiles ``csrc/cache_sim.cu`` for ``sm_90a`` into
a shared library with a plain C interface under ``build/repro_torch/`` at
the repository root, and ``ctypes`` loads it.  The library's name carries
a hash of the source, so an edited source is rebuilt and a stale library
is never loaded.  Nothing here runs at import: the CPU tests import every
module of the port, and only a machine with the CUDA toolkit can build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Optional

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "cache_sim.cu"
BUILD_DIR = _HERE.parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
# What the build that loaded ``_lib`` reported: seconds, whether it built
# now or found the library, and ptxas' register / spill lines.
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no nvcc on PATH and no CUDA toolkit found; the "
                           "cache_sim kernel cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build(target: pathlib.Path) -> list:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half
    return [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln]


def load() -> ctypes.CDLL:
    """The loaded kernel library, built from the repository's source at
    first use.  Raises if ``nvcc`` fails; there is no fallback."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:16]
    target = BUILD_DIR / f"cache_sim-{digest}.so"
    t0 = time.perf_counter()
    built_now = not target.exists()
    ptxas = _build(target) if built_now else []
    build_info.update(seconds=time.perf_counter() - t0, built_now=built_now,
                      ptxas=ptxas, library=target.name)
    lib = ctypes.CDLL(str(target))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.cache_sim_launch.argtypes = (
        [p, i64, i64, p, p] + [p] * 17 + [i32, i32, i32, i32, i64, p])
    lib.cache_sim_launch.restype = ctypes.c_int
    _lib = lib
    return lib
