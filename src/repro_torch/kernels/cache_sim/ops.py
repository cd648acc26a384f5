"""The ``cache_sim`` wrapper: lane-parallel Clock2Q+ trace replay.

``cache_sim(state, trace, out)`` replays ``trace`` through every lane of
a Clock2Q+ engine state, updating the state in place.  On CUDA tensors it
launches the Hopper kernel (``csrc/cache_sim.cu``) or raises; on CPU
tensors, and only there, it runs the plain version (``ref.py``).

``launch_count`` counts kernel launches (a plain integer; reset it by
assigning 0), so a run can show that its path went through the kernel.

``plan_lane`` (plain Python) picks where the kernel keeps each lane: the
whole lane in one block's shared memory, its rings there, its Small and
Ghost rings there, or all of it in device memory; ``plan_launch`` plans a
whole grid (``tests/test_torch_kernel_plan.py`` holds both on the CPU).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.kernels import lanes
from repro_torch.kernels.lanes import (  # noqa: F401  (the planner's API)
    SMEM_BLOCK, TIER_GLOBAL, TIER_RINGS, TIER_SMALL, TIER_WHOLE, TRACE_BYTES,
    LanePlan, LaunchPlan, blocks_per_sm,
)

# Number of kernel launches in this process.
launch_count = 0

_RINGS = dict(skey="pS", sref="pS", sseq="pS", mkey="pM", mref="pM",
              gkey="pG", loc_w="U", loc_s="U")


def small_bytes(scap: int, gcap: int) -> int:
    """Bytes of a lane's Small and Ghost rings at their logical sizes:
    skey, sseq (int32) and sref (bool) per Small slot, gkey per Ghost
    slot."""
    return 9 * scap + 4 * gcap


def ring_bytes(scap: int, mcap: int, gcap: int) -> int:
    """Bytes of all a lane's rings: ``small_bytes`` and mkey (int32) and
    mref (bool) per Main slot."""
    return small_bytes(scap, gcap) + 5 * mcap


def table_bytes(K: int) -> int:
    """Bytes of ``loc_w`` (int8) and ``loc_s`` (int32) over keys [0, K)."""
    return 5 * K


def plan_lane(scap: int, mcap: int, gcap: int, K: int) -> LanePlan:
    """Where the kernel keeps a lane of logical sizes ``scap``/``mcap``/
    ``gcap`` over keys [0, K): the most of it, in this order, that fits
    one block's shared memory beside the trace ring (the whole lane, its
    rings, its Small and Ghost rings); the rest in device memory."""
    rings = ring_bytes(scap, mcap, gcap)
    return lanes.plan_tiers(((TIER_WHOLE, rings + table_bytes(K)),
                             (TIER_RINGS, rings),
                             (TIER_SMALL, small_bytes(scap, gcap)),
                             (TIER_GLOBAL, 0)))


def plan_launch(scap: Sequence[int], mcap: Sequence[int],
                gcap: Sequence[int], K: int) -> LaunchPlan:
    """``plan_lane`` for every lane of a grid; one launch serves them
    all, every block with the shared memory of the largest."""
    return lanes.plan_grid([plan_lane(int(s), int(m), int(g), K)
                            for s, m, g in zip(scap, mcap, gcap)])


def check_state(state: Dict[str, torch.Tensor]):
    """Hold a state to the layout the kernel takes: keys, dtypes, one
    device, contiguity and shapes.  Returns ``(L, widths)``, the lane
    count and the ring and table widths (``pS``, ``pM``, ``pG``, ``U``)."""
    # imported here: the engine package imports this module to register
    # the wrapper, so this module imports the engine only when called
    from repro_torch.core.engine.clock2qplus import STATE_DTYPES

    return lanes.check_state(state, STATE_DTYPES, _RINGS, "Clock2Q+")


def _check(state: Dict[str, torch.Tensor], trace: torch.Tensor, out: str):
    """Validate what the kernel takes; returns (L, T, widths)."""
    L, widths = check_state(state)
    T = lanes.check_trace(trace, L, state["spos"].device, out)
    return L, T, widths


def host_view(state, trace) -> Dict[str, np.ndarray]:
    """What the host needs of a launch, in one read from the device: the
    largest trace key, the largest ring key (-1 where there is none) and
    the per-lane logical sizes."""
    return lanes.host_view(state, trace, ("skey", "mkey", "gkey"),
                           ("scap", "mcap", "gcap"))


def key_range(state: Dict[str, torch.Tensor], trace: torch.Tensor) -> int:
    """K, the keys a launch can touch: 1 + the largest key of the trace
    and of the state's rings (a chunked replay's rings hold keys of
    earlier chunks).  Every index of ``loc_*`` a launch reads or writes is
    below it."""
    return lanes.key_range(host_view(state, trace))


def plan_view(view) -> LaunchPlan:
    """The launch plan of a ``host_view``: its lanes' tiers over K."""
    return plan_launch(view["scap"], view["mcap"], view["gcap"],
                       lanes.key_range(view))


def _check_values(view, widths) -> None:
    """The kernel indexes with these values: hold them to the layout."""
    lanes.check_values(view, widths["U"], dict(
        scap=widths["pS"], mcap=widths["pM"], gcap=widths["pG"]), {})


def cache_sim(state: Dict[str, torch.Tensor], trace: torch.Tensor,
              out: str = "hits") -> torch.Tensor:
    """Replay ``trace`` through every lane of ``state``, in place.

    ``trace`` is (T,) int32 (one row shared by all lanes, as in a sweep)
    or (L, T) (one row per lane); keys < 0 are no-op padding.  Returns
    hits (L, T) bool for ``out="hits"``, or per-lane hit counts (L,)
    int64 for ``out="counts"`` (no L x T array is built)."""
    global launch_count
    L, T, widths = _check(state, trace, out)
    view = host_view(state, trace)
    _check_values(view, widths)
    if trace.device.type == "cpu":
        from repro_torch.kernels.cache_sim.ref import cache_sim_plain

        return cache_sim_plain(state, trace, out)
    if trace.device.type != "cuda":
        raise ValueError(f"cache_sim runs on cuda or cpu, not {trace.device}")
    from repro_torch.kernels.cache_sim.build import load

    result = launch(load(), state, trace, out, view, widths)
    launch_count += 1
    return result


def launch(lib, state: Dict[str, torch.Tensor], trace: torch.Tensor,
           out: str, view, widths) -> torch.Tensor:
    """One launch of library ``lib``'s kernel on checked inputs (``view``
    from ``host_view``, ``widths`` from ``check_state``): plans the
    lanes' tiers and returns what ``cache_sim`` returns.  It does not
    count the launch."""
    L, T = state["spos"].shape[0], trace.shape[-1]
    dev = trace.device
    K = lanes.key_range(view)
    plan = plan_view(view)
    tiers = torch.tensor(plan.tiers, dtype=torch.int32).to(dev)
    hits = torch.empty((L, T), dtype=torch.bool, device=dev) \
        if out == "hits" else None
    counts = torch.empty((L,), dtype=torch.int64, device=dev) \
        if out == "counts" else None
    s = state
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cache_sim_launch(
            trace.data_ptr(), T if trace.dim() == 2 else 0, T,
            hits.data_ptr() if hits is not None else None,
            counts.data_ptr() if counts is not None else None,
            *(s[k].data_ptr() for k in (
                "skey", "sref", "sseq", "spos", "seqctr", "mkey", "mref",
                "hand", "gkey", "gpos", "loc_w", "loc_s", "scap", "mcap",
                "gcap", "window", "skip_limit")), tiers.data_ptr(),
            L, widths["pS"], widths["pM"], widths["pG"], widths["U"], K,
            plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"cache_sim launch failed: CUDA error {err}")
    return hits if out == "hits" else counts
