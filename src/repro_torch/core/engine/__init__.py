"""The capacity-masked policy core: the Clock2Q+ step behind a
``PolicyEngine`` registry, and the replay drivers over it.

The port of ``repro/core/engine/__init__.py``.  Registered here:
``clock2q+`` and ``clock2q`` (the same step with 2Q sizing and a window
covering the whole Small FIFO).  Every state carries a leading lane axis;
a single configuration is one lane.

Each engine names its plain step (``step_fn``) and the wrapper of its
kernel (``replay_fn``, which advances a state over a whole trace).  The
drivers (``replay``, ``replay_chunked``, ``grid_hit_counts``,
``grid_hit_arrays``) go through ``replay_fn``: on CUDA tensors that is
the Hopper ``cache_sim`` kernel, on CPU tensors its plain version.
States are advanced IN PLACE (the location tables dominate their size).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.engine import clock2qplus
from repro_torch.core.engine.layout import (  # noqa: F401  (package API)
    EMPTY, W_GHOST, W_MAIN, W_NONE, W_SMALL, SweepConfig, c2qp_sizes,
    seg, sq_sizes,
)
from repro_torch.kernels.cache_sim.ops import cache_sim, check_state

State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PolicyEngine:
    """One registered policy family.

    ``knobs`` are the ``SweepConfig`` fields this family reads (capacity
    is always read).  ``preset`` overrides the SweepConfig defaults when a
    config is built through ``config()``.  ``init_fn(configs, universe,
    phys, device)`` builds a lane-batched state, ``step_fn(state, key)``
    is the plain one-request step, and ``replay_fn(state, trace, out)``
    the kernel wrapper that replays a whole trace.
    """
    name: str
    knobs: Tuple[str, ...]
    sizes_fn: Callable[[SweepConfig], Tuple[int, ...]]
    init_fn: Callable[..., State]
    step_fn: Callable[[State, torch.Tensor], Tuple[State, torch.Tensor]]
    replay_fn: Callable[..., torch.Tensor]
    preset: Mapping[str, object] = dataclasses.field(default_factory=dict)

    def config(self, capacity: int, **kw) -> SweepConfig:
        """A ``SweepConfig`` for this policy with the engine's own
        defaults applied (explicit kwargs win over the preset)."""
        return SweepConfig(int(capacity), policy=self.name,
                           **{**dict(self.preset), **kw})

    def init_config(self, cfg: SweepConfig, universe: int,
                    phys: Optional[Tuple[int, ...]] = None,
                    device=None) -> State:
        """One-lane state for ``cfg``; ``phys`` pads to grid maxima."""
        return self.init_fn([cfg], int(universe), phys,
                            resolve_device(device))

    def init(self, capacity: int, universe: int, device=None, **kw) -> State:
        """Degenerate-mask one-lane state for a single configuration."""
        return self.init_config(self.config(capacity, **kw), universe,
                                device=device)


# -- registry ------------------------------------------------------------------

_REGISTRY: Dict[str, PolicyEngine] = {}


def register_engine(engine: PolicyEngine) -> PolicyEngine:
    """Register (or replace) a lane policy family by name."""
    _REGISTRY[engine.name] = engine
    return engine


def get_engine(name: str) -> PolicyEngine:
    """Look up a registered lane engine by policy name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no registered lane engine {name!r}; "
            f"known: {sorted(_REGISTRY)}") from None


def engine_names() -> List[str]:
    """Sorted names of every registered lane engine."""
    return sorted(_REGISTRY)


register_engine(PolicyEngine(
    "clock2q+",
    knobs=("window_frac", "small_frac", "ghost_frac", "skip_limit"),
    sizes_fn=clock2qplus.sizes, init_fn=clock2qplus.init_lanes,
    step_fn=clock2qplus.step, replay_fn=cache_sim))
# Clock2Q == Clock2Q+ with 2Q sizing and the window covering the whole
# Small FIFO (the ref bit is never set while resident there, §3.2) —
# the same masked step, preset-sized.
register_engine(PolicyEngine(
    "clock2q",
    knobs=("window_frac", "small_frac", "ghost_frac", "skip_limit"),
    sizes_fn=clock2qplus.sizes, init_fn=clock2qplus.init_lanes,
    step_fn=clock2qplus.step, replay_fn=cache_sim,
    preset=dict(small_frac=0.25, window_frac=10.0)))


# -- carrying a JAX engine state across ----------------------------------------

def _check_state_values(a: Mapping[str, np.ndarray], U: int) -> None:
    """The kernel indexes rings and tables with these values and checks
    none of them per request: a cursor, slot or key out of range would
    write past its lane's row."""
    rings = dict(scap="skey", mcap="mkey", gcap="gkey")
    for cap, ring in rings.items():
        c, keys = a[cap], a[ring]
        if c.min() < 1 or c.max() > keys.shape[1]:
            raise ValueError(f"{cap} {c.tolist()} outside [1, "
                             f"{keys.shape[1]}]")
        if ((keys < EMPTY) | (keys >= U)).any():
            raise ValueError(f"{ring} holds a key outside [{EMPTY}, {U})")
    for cur, cap in (("spos", "scap"), ("hand", "mcap"), ("gpos", "gcap")):
        if ((a[cur] < 0) | (a[cur] >= a[cap])).any():
            raise ValueError(f"{cur} {a[cur].tolist()} outside [0, {cap})")
    for k in ("window", "skip_limit"):
        if (a[k] < 0).any():
            raise ValueError(f"{k} {a[k].tolist()} is negative")
    where, slot = a["loc_w"], a["loc_s"]
    if ((where < W_NONE) | (where > W_GHOST)).any():
        raise ValueError("loc_w holds a code outside W_NONE..W_GHOST")
    for code, cap in ((W_SMALL, "scap"), (W_MAIN, "mcap"),
                      (W_GHOST, "gcap")):
        lanes, ids = np.nonzero(where == code)
        s = slot[lanes, ids]
        if ((s < 0) | (s >= a[cap][lanes])).any():
            raise ValueError(f"loc_s names a slot outside the ring of "
                             f"its {cap}")


def state_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> State:
    """A port state from a reference engine state given as numpy arrays
    (``{k: np.asarray(v)}`` of a JAX state).  An unbatched state (scalar
    cursors) gains a lane axis of 1; a grid state keeps its lanes.  The
    state is held to the layout here, once: keys, dtypes, shapes, and
    every cursor, slot and ring key within its ring or table."""
    dev = resolve_device(device)
    if set(arrays) != set(clock2qplus.STATE_DTYPES):
        raise ValueError(f"state keys {sorted(arrays)} are not the Clock2Q+ "
                         "layout")
    batched = np.ndim(arrays["spos"]) == 1
    # a copy: the port updates its state in place, and the arrays may be
    # read-only views of the caller's buffers
    host = {k: torch.tensor(np.asarray(v) if batched else np.asarray(v)[None])
            for k, v in arrays.items()}
    _, widths = check_state(host)
    _check_state_values({k: v.numpy() for k, v in host.items()}, widths["U"])
    return {k: v.to(dev) for k, v in host.items()}


def state_to_numpy(state: State) -> Dict[str, np.ndarray]:
    """The state as numpy arrays on the host, lane axis first (the layout
    of a reference grid state)."""
    return {k: v.cpu().numpy() for k, v in state.items()}


# -- replay drivers ------------------------------------------------------------

def _as_trace(trace, device: torch.device) -> torch.Tensor:
    if isinstance(trace, torch.Tensor):
        return trace.to(device=device, dtype=torch.int32).contiguous()
    return torch.as_tensor(np.ascontiguousarray(trace, dtype=np.int32),
                           device=device)


def replay(policy: str, state: State, trace) -> Tuple[State, torch.Tensor]:
    """Replay ``trace`` through every lane of ``state`` (advanced in
    place).  ``trace`` is (T,), shared by the lanes, or (L, T).  Returns
    ``(state, hits)``, hits (L, T) bool on the state's device."""
    tr = _as_trace(trace, state["spos"].device)
    return state, get_engine(policy).replay_fn(state, tr, "hits")


def _check_keys(arr: np.ndarray, universe: int) -> None:
    # negative keys appear when hashed obj_ids >= 2**63 wrap through an
    # int64 load: reject them, or they would be taken for padding
    if arr.size and (int(arr.max()) >= universe or int(arr.min()) < 0):
        bad = int(arr.max()) if int(arr.max()) >= universe \
            else int(arr.min())
        raise ValueError(
            f"chunk contains key {bad} outside [0, {universe}); relabel "
            "the trace (repro_torch.tuning.sweep.relabel) or pass a "
            "larger universe")


def replay_chunked(policy: str, chunks, capacity: int, universe: int,
                   state: Optional[State] = None, device=None, **kw):
    """Replay an iterable of key chunks, threading the state across chunk
    boundaries: bit-identical to the single-shot ``replay`` of the
    concatenated trace, with one chunk resident at a time.

    Returns ``(hits, n_requests, final_state)``; pass ``state`` back in
    to continue a stream.  With ``state`` given, it sets the device."""
    universe = int(universe)
    if not (0 < universe <= np.iinfo(np.int32).max):
        raise ValueError(
            f"universe {universe} does not fit the engine's dense int32 id "
            "space; relabel the trace to [0, n_unique) first "
            "(repro_torch.tuning.sweep.relabel)")
    eng = get_engine(policy)
    st = eng.init(capacity, universe, device=device, **kw) \
        if state is None else state
    dev = st["spos"].device
    hits = 0
    n = 0
    for chunk in chunks:
        arr = np.ascontiguousarray(chunk)
        _check_keys(arr, universe)
        counts = eng.replay_fn(st, _as_trace(arr, dev), "counts")
        hits += int(counts.sum())
        n += int(arr.shape[0])
    return hits, n, st


def grid_init(configs: Sequence[SweepConfig], universe: int,
              device=None) -> State:
    """Lane-batched state, one lane per config: rings padded to the grid
    maxima, logical sizes as per-lane scalars.  The configs' policies
    must share one step (clock2q+ and clock2q do)."""
    if len(configs) == 0:
        raise ValueError("empty sweep grid")
    engines = [get_engine(p) for p in sorted({c.policy for c in configs})]
    if len({(e.init_fn, e.step_fn) for e in engines}) != 1:
        raise ValueError(
            f"one grid_init call batches ONE step family, got "
            f"{[e.name for e in engines]} — partition the grid by "
            "config.policy first")
    eng = engines[0]
    sizes = np.asarray([get_engine(c.policy).sizes_fn(c) for c in configs],
                       dtype=np.int64)
    phys = tuple(int(x) for x in sizes.max(axis=0))
    return eng.init_fn(list(configs), int(universe), phys,
                       resolve_device(device))


def grid_hit_counts(policy: str, states: State, trace) -> torch.Tensor:
    """All lanes x the whole trace in one kernel launch; per-lane hit
    counts (L,) int64 (no lanes x T array is built).  ``states`` is
    advanced in place."""
    tr = _as_trace(trace, states["spos"].device)
    return get_engine(policy).replay_fn(states, tr, "counts")


def grid_hit_arrays(policy: str, states: State, trace) -> torch.Tensor:
    """Per-access hit arrays for every lane, (L, T) bool.  ``states`` is
    advanced in place."""
    tr = _as_trace(trace, states["spos"].device)
    return get_engine(policy).replay_fn(states, tr, "hits")


def lane_hits(trace: np.ndarray, config: SweepConfig,
              universe: Optional[int] = None, device=None) -> np.ndarray:
    """Per-request bool hit array for ONE grid configuration.  ``trace``
    must already be dense int ids in [0, universe)."""
    trace = np.asarray(trace)
    if universe is None:
        universe = int(trace.max()) + 1
    states = grid_init([config], int(universe), device=device)
    hits = grid_hit_arrays(config.policy, states, trace)
    return hits[0].cpu().numpy()
