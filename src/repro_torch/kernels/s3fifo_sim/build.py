"""Build and load the ``s3fifo_sim`` CUDA kernel.

``load()`` builds ``csrc/s3fifo_sim.cu`` through the port's shared kernel
build (``repro_torch.kernels.build``: ``nvcc`` for ``sm_90a`` into
``build/repro_torch/`` at first use, ``ctypes`` to load) and binds its C
entry point.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import pathlib

from repro_torch.kernels import build as _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "s3fifo_sim.cu"
_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
SYMBOLS = {"s3fifo_sim_launch":
           [_p, _i64, _i64, _p, _p] + [_p] * 18 + [_i32] * 4
           + [_i64, _i32, _i32, _p]}

# What the build that loaded the library reported (``build.info``).
build_info = _build.info("s3fifo_sim")


def load() -> ctypes.CDLL:
    """The loaded kernel library, built from the repository's source at
    first use.  Raises if ``nvcc`` fails; there is no fallback."""
    return _build.load("s3fifo_sim", SOURCE, SYMBOLS)
