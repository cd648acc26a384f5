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

``plan_lane`` (plain Python) picks where the kernel keeps each lane: the
whole lane in one block's shared memory, its ring (and LRU's log) there,
or all of it in device memory; ``plan_launch`` plans a whole grid
(``tests/test_torch_policy_plan.py`` holds both on the CPU).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from repro_torch.kernels import lanes
from repro_torch.kernels.lanes import (
    TIER_GLOBAL, TIER_RINGS, TIER_WHOLE, LanePlan, LaunchPlan,
)

# Number of kernel launches in this process.
launch_count = 0

FAMILIES = ("fifo", "clock", "lru")
# Each family's tensors after the trace, hits and counts, in the order of
# its C entry point, and its cursor.
_ARGS = dict(fifo=("keys", "resident", "pos", "cap"),
             clock=("keys", "ref", "hand", "loc", "cap"),
             lru=("keys", "last", "t", "loc", "cap"))
_CURSOR = dict(fifo="pos", clock="hand", lru="t")
# LRU's log of accesses holds 2 cap + LOG_SLACK slot entries a lane
# (``csrc/simple_sim.cu``'s kLogSlack), beside qpos, one entry a slot.
LOG_SLACK = 64
_I32_MAX = 2**31 - 1


def log_entries(cap: int) -> int:
    """Entries of an LRU lane's log buffer (its start run and its log)."""
    return 2 * cap + LOG_SLACK


def ring_bytes(family: str, cap: int) -> int:
    """Bytes of a lane's ring at capacity ``cap``: keys (int32) per slot;
    Clock's ref (bool); LRU's last and the launch's workspace (qpos per
    slot and the log buffer, int32)."""
    if family == "fifo":
        return 4 * cap
    if family == "clock":
        return 5 * cap
    return 12 * cap + 4 * log_entries(cap)


def table_bytes(family: str, K: int) -> int:
    """Bytes of the location table over keys [0, K): FIFO's ``resident``
    (bool), Clock's and LRU's ``loc`` (int32)."""
    return K if family == "fifo" else 4 * K


def plan_lane(family: str, cap: int, K: int) -> LanePlan:
    """Where the ``family`` kernel keeps a lane of capacity ``cap`` over
    keys [0, K): the whole lane in one block's shared memory beside the
    trace ring, else its ring there, else all in device memory."""
    ring = ring_bytes(family, cap)
    return lanes.plan_tiers(((TIER_WHOLE, ring + table_bytes(family, K)),
                             (TIER_RINGS, ring), (TIER_GLOBAL, 0)))


def plan_launch(family: str, caps: Sequence[int], K: int) -> LaunchPlan:
    """``plan_lane`` for every lane of a grid; one launch serves them
    all, every block with the shared memory of the largest."""
    return lanes.plan_grid([plan_lane(family, int(c), K) for c in caps])


def host_view(family: str, state, trace) -> Dict[str, np.ndarray]:
    """What the host needs of a launch, in one read from the device: the
    largest trace and ring keys, each lane's ``cap`` and cursor."""
    return lanes.host_view(state, trace, ("keys",), ("cap", _CURSOR[family]))


def plan_view(family: str, view) -> LaunchPlan:
    """The launch plan of a ``host_view``: its lanes' tiers over K."""
    return plan_launch(family, view["cap"], lanes.key_range(view))


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


def check_values(family: str, view, widths, T: int) -> None:
    """Hold a launch's ``host_view`` to what the kernel indexes with:
    keys in the universe, ``cap`` within the ring, the FIFO and Clock
    cursors within ``cap``; and LRU's timestamps to int32: ``t + T`` at
    most 2^31 - 1 (the log keeps accesses in timestamp order, and the
    plain step's int32 ``t`` would wrap past it)."""
    cursors = {} if family == "lru" else {_CURSOR[family]: ("cap", 0)}
    lanes.check_values(view, widths["U"], dict(cap=widths["pC"]), cursors)
    if family == "lru" and view["t"].size and \
            int(view["t"].max()) + T > _I32_MAX:
        raise ValueError(f"LRU t {view['t'].tolist()} + {T} requests passes "
                         f"2^31 - 1: the timestamps would wrap")


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
    T = lanes.check_trace(trace, L, state["cap"].device, out)
    view = host_view(family, state, trace)
    check_values(family, view, widths, T)
    if trace.device.type == "cpu":
        from repro_torch.kernels.simple_sim.ref import simple_sim_plain

        return simple_sim_plain(family, state, trace, out)
    if trace.device.type != "cuda":
        raise ValueError(f"simple_sim runs on cuda or cpu, not "
                         f"{trace.device}")
    from repro_torch.kernels.simple_sim.build import load

    result = launch(load(), family, state, trace, out, view, widths)
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
           trace: torch.Tensor, out: str, view, widths) -> torch.Tensor:
    """One launch of library ``lib``'s ``family`` entry point on checked
    inputs (``view`` from ``host_view``, ``widths`` from ``check_state``):
    ``bind`` and its call; returns what ``simple_sim`` returns.  It does not count the
    launch."""
    return bind(lib, family, state, trace, out, view, widths)()


def bind(lib, family: str, state: Dict[str, torch.Tensor],
         trace: torch.Tensor, out: str, view, widths,
         plan: LaunchPlan = None) -> Callable[[], torch.Tensor]:
    """The host's part of one launch of library ``lib``'s ``family`` entry
    point on checked inputs (``view`` from ``host_view``, ``widths`` from
    ``check_state``): the lanes' tiers (``plan``, else ``plan_view``'s)
    copied to the card, LRU's workspace allocated in device memory where a
    lane lives there, and the outputs allocated.  Returns a call that
    launches the kernel alone and returns what ``simple_sim`` returns; it
    does not count the launch."""
    L, T = state["cap"].shape[0], trace.shape[-1]
    dev = trace.device
    K = lanes.key_range(view)
    if plan is None:
        plan = plan_view(family, view)
    tiers = torch.tensor(plan.tiers, dtype=torch.int32).to(dev)
    hits = torch.empty((L, T), dtype=torch.bool, device=dev) \
        if out == "hits" else None
    counts = torch.empty((L,), dtype=torch.int64, device=dev) \
        if out == "counts" else None
    pC = widths["pC"]
    extra = ()
    if family == "lru":
        ws = TIER_GLOBAL in plan.tiers
        qpos = torch.empty((L, pC) if ws else (0,), dtype=torch.int32,
                           device=dev)
        q = torch.empty((L, log_entries(pC)) if ws else (0,),
                        dtype=torch.int32, device=dev)
        extra = (qpos.data_ptr() if ws else None,
                 q.data_ptr() if ws else None)
    fn = getattr(lib, f"{family}_sim_launch")
    args = (trace.data_ptr(), T if trace.dim() == 2 else 0, T,
            hits.data_ptr() if hits is not None else None,
            counts.data_ptr() if counts is not None else None,
            *(state[k].data_ptr() for k in _ARGS[family]),
            tiers.data_ptr(), *extra, L, pC, widths["U"], K)
    if family == "lru":
        args += (log_entries(pC),)

    def go() -> torch.Tensor:
        with torch.cuda.device(dev):
            err = fn(*args, plan.smem_bytes,
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"simple_sim ({family}) launch failed: "
                               f"CUDA error {err}")
        return hits if out == "hits" else counts
    return go
