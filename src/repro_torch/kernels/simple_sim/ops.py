"""The ``simple_sim`` wrappers: lane-parallel FIFO, Clock and LRU trace
replay.

``fifo_sim``, ``clock_sim`` and ``lru_sim`` (each ``(state, trace,
out)``) replay ``trace`` through every lane of that family's engine state
(``repro_torch.core.engine.simple``), updating the state in place.  On
CUDA tensors each launches its entry point of the Hopper kernel source
(``csrc/simple_sim.cu``) or raises; on CPU tensors, and only there, it
runs the plain version (``ref.py``).

``launch_count`` counts kernel launches of all three families (a plain
integer; reset it by assigning 0), so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import lanes

# Number of kernel launches in this process.
launch_count = 0

FAMILIES = ("fifo", "clock", "lru")
# Each family's tensors after the trace, hits and counts, in the order of
# its C entry point, and its cursor.
_ARGS = dict(fifo=("keys", "resident", "pos", "cap"),
             clock=("keys", "ref", "hand", "loc", "cap"),
             lru=("keys", "last", "t", "loc", "cap"))
_CURSOR = dict(fifo="pos", clock="hand", lru="t")


def check_state(family: str, state: Dict[str, torch.Tensor]):
    """Hold a state to the ``family``'s layout: keys, dtypes, one device,
    contiguity and shapes.  Returns ``(L, widths)``, the lane count and
    the ring and table widths (``pC``, ``U``)."""
    # imported here: the engine package imports this module to register
    # the wrappers, so this module imports the engine only when called
    from repro_torch.core.engine.simple import DTYPES, RINGS

    if family not in FAMILIES:
        raise ValueError(f"simple_sim runs {FAMILIES}, not {family!r}")
    return lanes.check_state(state, DTYPES[family], RINGS, family)


def check_values(family: str, view, widths) -> None:
    """Hold a launch's ``lanes.host_view`` to what the kernel indexes
    with: keys in the universe, ``cap`` within the ring, the FIFO and
    Clock cursors within ``cap``."""
    cursors = {} if family == "lru" else {_CURSOR[family]: ("cap", 0)}
    lanes.check_values(view, widths["U"], dict(cap=widths["pC"]), cursors)


def simple_sim(family: str, state: Dict[str, torch.Tensor],
               trace: torch.Tensor, out: str = "hits") -> torch.Tensor:
    """Replay ``trace`` through every lane of the ``family`` state, in
    place.

    ``trace`` is (T,) int32 (one row shared by all lanes, as in a sweep)
    or (L, T) (one row per lane); keys < 0 are no-op padding.  Returns
    hits (L, T) bool for ``out="hits"``, or per-lane hit counts (L,)
    int64 for ``out="counts"`` (no L x T array is built)."""
    global launch_count
    L, widths = check_state(family, state)
    lanes.check_trace(trace, L, state["cap"].device, out)
    check_values(family, lanes.host_view(state, trace, ("keys",),
                                         ("cap", _CURSOR[family])), widths)
    if trace.device.type == "cpu":
        from repro_torch.kernels.simple_sim.ref import simple_sim_plain

        return simple_sim_plain(family, state, trace, out)
    if trace.device.type != "cuda":
        raise ValueError(f"simple_sim runs on cuda or cpu, not "
                         f"{trace.device}")
    from repro_torch.kernels.simple_sim.build import load

    result = launch(load(), family, state, trace, out, widths)
    launch_count += 1
    return result


def fifo_sim(state, trace, out: str = "hits") -> torch.Tensor:
    """``simple_sim`` for a FIFO state."""
    return simple_sim("fifo", state, trace, out)


def clock_sim(state, trace, out: str = "hits") -> torch.Tensor:
    """``simple_sim`` for a Clock state."""
    return simple_sim("clock", state, trace, out)


def lru_sim(state, trace, out: str = "hits") -> torch.Tensor:
    """``simple_sim`` for an LRU state."""
    return simple_sim("lru", state, trace, out)


def launch(lib, family: str, state: Dict[str, torch.Tensor],
           trace: torch.Tensor, out: str, widths) -> torch.Tensor:
    """One launch of library ``lib``'s ``family`` entry point on checked
    inputs (``widths`` from ``check_state``); returns what ``simple_sim``
    returns.  It does not count the launch."""
    L, T = state["cap"].shape[0], trace.shape[-1]
    dev = trace.device
    hits = torch.empty((L, T), dtype=torch.bool, device=dev) \
        if out == "hits" else None
    counts = torch.empty((L,), dtype=torch.int64, device=dev) \
        if out == "counts" else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"{family}_sim_launch")(
            trace.data_ptr(), T if trace.dim() == 2 else 0, T,
            hits.data_ptr() if hits is not None else None,
            counts.data_ptr() if counts is not None else None,
            *(state[k].data_ptr() for k in _ARGS[family]),
            L, widths["pC"], widths["U"], stream)
    if err != 0:
        raise RuntimeError(f"simple_sim ({family}) launch failed: CUDA "
                           f"error {err}")
    return hits if out == "hits" else counts
