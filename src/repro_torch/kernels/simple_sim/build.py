"""Build and load the ``simple_sim`` CUDA kernels (FIFO, Clock, LRU).

``load()`` builds ``csrc/simple_sim.cu`` through the port's shared kernel
build (``repro_torch.kernels.build``: ``nvcc`` for ``sm_90a`` into
``build/repro_torch/`` at first use, ``ctypes`` to load) and binds its
three C entry points.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import pathlib

from repro_torch.kernels import build as _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "simple_sim.cu"
_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_HEAD = [_p, _i64, _i64, _p, _p]  # trace, trace_stride, T, hits, counts
_TAIL = [_i32, _i32, _i64, _i32]  # L, pC, U, K
SYMBOLS = {"fifo_sim_launch": _HEAD + [_p] * 5 + _TAIL + [_i32, _p],
           "clock_sim_launch": _HEAD + [_p] * 6 + _TAIL + [_i32, _p],
           "lru_sim_launch": _HEAD + [_p] * 8 + _TAIL + [_i64, _i32, _p]}

# What the build that loaded the library reported (``build.info``).
build_info = _build.info("simple_sim")


def load() -> ctypes.CDLL:
    """The loaded kernel library, built from the repository's source at
    first use.  Raises if ``nvcc`` fails; there is no fallback."""
    return _build.load("simple_sim", SOURCE, SYMBOLS)
