"""The ``s3fifo_sim`` wrapper: lane-parallel S3-FIFO trace replay.

``s3fifo_sim(state, trace, out)`` replays ``trace`` through every lane of
an S3-FIFO engine state (``repro_torch.core.engine.s3fifo``), updating the
state in place.  On CUDA tensors it launches the Hopper kernel
(``csrc/s3fifo_sim.cu``) or raises; on CPU tensors, and only there, it
runs the plain version (``ref.py``).

``launch_count`` counts kernel launches (a plain integer; reset it by
assigning 0), so a run can show that its path went through the kernel.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import lanes

# Number of kernel launches in this process.
launch_count = 0

_SCALARS = ("scap", "mcap", "gcap", "spos", "mhead", "mcount", "gpos")


def check_state(state: Dict[str, torch.Tensor]):
    """Hold a state to the S3-FIFO layout the kernel takes: keys, dtypes,
    one device, contiguity and shapes.  Returns ``(L, widths)``, the lane
    count and the ring and table widths (``pS``, ``pM``, ``pG``, ``U``)."""
    # imported here: the engine package imports this module to register
    # the wrapper, so this module imports the engine only when called
    from repro_torch.core.engine.s3fifo import RINGS, STATE_DTYPES

    return lanes.check_state(state, STATE_DTYPES, RINGS, "S3-FIFO")


def check_values(view, widths) -> None:
    """Hold a launch's ``lanes.host_view`` to what the kernel indexes
    with: keys in the universe, logical sizes within the rings, cursors
    within the logical sizes (``mcount`` up to ``mcap``)."""
    lanes.check_values(
        view, widths["U"],
        dict(scap=widths["pS"], mcap=widths["pM"], gcap=widths["pG"]),
        dict(spos=("scap", 0), mhead=("mcap", 0), mcount=("mcap", 1),
             gpos=("gcap", 0)))


def s3fifo_sim(state: Dict[str, torch.Tensor], trace: torch.Tensor,
               out: str = "hits") -> torch.Tensor:
    """Replay ``trace`` through every lane of ``state``, in place.

    ``trace`` is (T,) int32 (one row shared by all lanes, as in a sweep)
    or (L, T) (one row per lane); keys < 0 are no-op padding.  Returns
    hits (L, T) bool for ``out="hits"``, or per-lane hit counts (L,)
    int64 for ``out="counts"`` (no L x T array is built)."""
    global launch_count
    L, widths = check_state(state)
    lanes.check_trace(trace, L, state["spos"].device, out)
    check_values(lanes.host_view(state, trace, ("skey", "mkey", "gkey"),
                                 _SCALARS), widths)
    if trace.device.type == "cpu":
        from repro_torch.kernels.s3fifo_sim.ref import s3fifo_sim_plain

        return s3fifo_sim_plain(state, trace, out)
    if trace.device.type != "cuda":
        raise ValueError(f"s3fifo_sim runs on cuda or cpu, not "
                         f"{trace.device}")
    from repro_torch.kernels.s3fifo_sim.build import load

    result = launch(load(), state, trace, out, widths)
    launch_count += 1
    return result


def launch(lib, state: Dict[str, torch.Tensor], trace: torch.Tensor,
           out: str, widths) -> torch.Tensor:
    """One launch of library ``lib``'s kernel on checked inputs
    (``widths`` from ``check_state``); returns what ``s3fifo_sim``
    returns.  It does not count the launch."""
    L, T = state["spos"].shape[0], trace.shape[-1]
    dev = trace.device
    hits = torch.empty((L, T), dtype=torch.bool, device=dev) \
        if out == "hits" else None
    counts = torch.empty((L,), dtype=torch.int64, device=dev) \
        if out == "counts" else None
    s = state
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.s3fifo_sim_launch(
            trace.data_ptr(), T if trace.dim() == 2 else 0, T,
            hits.data_ptr() if hits is not None else None,
            counts.data_ptr() if counts is not None else None,
            *(s[k].data_ptr() for k in (
                "skey", "sfreq", "spos", "mkey", "mfreq", "mhead", "mcount",
                "gkey", "gpos", "loc_w", "loc_s", "freq_cap", "promote_at",
                "scap", "mcap", "gcap", "skip_limit")),
            L, widths["pS"], widths["pM"], widths["pG"], widths["U"], stream)
    if err != 0:
        raise RuntimeError(f"s3fifo_sim launch failed: CUDA error {err}")
    return hits if out == "hits" else counts
