"""The capacity-masked policy core: one masked step per policy family
behind a ``PolicyEngine`` registry, and the replay drivers over it.

The port of ``repro/core/engine/__init__.py``.  Registered here, as in
the reference: ``clock2q+`` and ``clock2q`` (the same step with 2Q
sizing and a window covering the whole Small FIFO), ``s3fifo``,
``fifo``, ``clock`` and ``lru``.  Every state carries a leading lane
axis; a single configuration is one lane.

Each engine names its plain step (``step_fn``) and the wrapper of its
kernel (``replay_fn``, which advances a state over a whole trace).  The
drivers (``replay``, ``replay_chunked``, ``grid_hit_counts``,
``grid_hit_arrays``) go through ``replay_fn``: on CUDA tensors that is a
Hopper kernel (``cache_sim`` for the Clock2Q+ family, ``s3fifo_sim``,
and ``simple_sim``'s FIFO, Clock and LRU entry points), on CPU tensors
its plain version.  States are advanced IN PLACE (the location tables
dominate their size).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import (
    Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple,
)

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.engine import clock2qplus, s3fifo, simple
from repro_torch.core.engine.layout import (  # noqa: F401  (package API)
    EMPTY, W_GHOST, W_MAIN, W_NONE, W_SMALL, SweepConfig, c2qp_sizes,
    seg, sq_sizes,
)
from repro_torch.kernels.cache_sim import ops as cache_sim_ops
from repro_torch.kernels.s3fifo_sim import ops as s3fifo_ops
from repro_torch.kernels.simple_sim import ops as simple_ops

State = Dict[str, torch.Tensor]

_FRAC_KNOBS = ("window_frac", "small_frac", "ghost_frac")


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

    # -- replay ---------------------------------------------------------------
    def replay(self, state: State, trace) -> Tuple[State, torch.Tensor]:
        """Replay ``trace`` from ``state`` (advanced in place): one launch
        of the family's kernel on CUDA."""
        return replay(self.name, state, trace)

    def replay_chunked(self, chunks, capacity: int, universe: int,
                       state: Optional[State] = None, **kw):
        """State-carry replay over an iterable of trace chunks
        (bit-identical to the single-shot ``replay``)."""
        return replay_chunked(self.name, chunks, capacity, universe,
                              state=state, **kw)


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
    step_fn=clock2qplus.step, replay_fn=cache_sim_ops.cache_sim))
# Clock2Q == Clock2Q+ with 2Q sizing and the window covering the whole
# Small FIFO (the ref bit is never set while resident there, §3.2) —
# the same masked step, preset-sized.
register_engine(PolicyEngine(
    "clock2q",
    knobs=("window_frac", "small_frac", "ghost_frac", "skip_limit"),
    sizes_fn=clock2qplus.sizes, init_fn=clock2qplus.init_lanes,
    step_fn=clock2qplus.step, replay_fn=cache_sim_ops.cache_sim,
    preset=dict(small_frac=0.25, window_frac=10.0)))
register_engine(PolicyEngine(
    "s3fifo",
    knobs=("small_frac", "ghost_frac", "skip_limit", "bits"),
    sizes_fn=s3fifo.sizes, init_fn=s3fifo.init_lanes, step_fn=s3fifo.step,
    replay_fn=s3fifo_ops.s3fifo_sim, preset=dict(ghost_frac=1.0)))
register_engine(PolicyEngine(
    "fifo", knobs=(), sizes_fn=simple.sizes, init_fn=simple.fifo_init_lanes,
    step_fn=simple.fifo_step, replay_fn=simple_ops.fifo_sim))
register_engine(PolicyEngine(
    "clock", knobs=(), sizes_fn=simple.sizes,
    init_fn=simple.clock_init_lanes, step_fn=simple.clock_step,
    replay_fn=simple_ops.clock_sim))
register_engine(PolicyEngine(
    "lru", knobs=(), sizes_fn=simple.sizes, init_fn=simple.lru_init_lanes,
    step_fn=simple.lru_step, replay_fn=simple_ops.lru_sim))


# -- carrying a JAX engine state across ----------------------------------------

def _check_rings(a: Mapping[str, np.ndarray], U: int,
                 rings: Mapping[str, str]) -> None:
    """Each logical size within its ring's width, each ring key in
    [EMPTY, U)."""
    for cap, ring in rings.items():
        c, keys = a[cap], a[ring]
        if c.min() < 1 or c.max() > keys.shape[1]:
            raise ValueError(f"{cap} {c.tolist()} outside [1, "
                             f"{keys.shape[1]}]")
        if ((keys < EMPTY) | (keys >= U)).any():
            raise ValueError(f"{ring} holds a key outside [{EMPTY}, {U})")


def _check_cursors(a: Mapping[str, np.ndarray],
                   cursors: Mapping[str, str], slack: int = 0) -> None:
    for cur, cap in cursors.items():
        if ((a[cur] < 0) | (a[cur] >= a[cap] + slack)).any():
            raise ValueError(f"{cur} {a[cur].tolist()} outside [0, {cap}"
                             f"{' + %d' % slack if slack else ''})")


def _check_nonnegative(a: Mapping[str, np.ndarray], names) -> None:
    for k in names:
        if (a[k] < 0).any():
            raise ValueError(f"{k} {a[k].tolist()} is negative")


def _check_segments(a: Mapping[str, np.ndarray],
                    caps: Mapping[int, str]) -> None:
    """``loc_w`` codes within W_NONE..W_GHOST, and ``loc_s`` of every key
    a segment holds within the logical ring of that segment."""
    where, slot = a["loc_w"], a["loc_s"]
    if ((where < W_NONE) | (where > W_GHOST)).any():
        raise ValueError("loc_w holds a code outside W_NONE..W_GHOST")
    for code, cap in caps.items():
        lanes, ids = np.nonzero(where == code)
        s = slot[lanes, ids]
        if ((s < 0) | (s >= a[cap][lanes])).any():
            raise ValueError(f"loc_s names a slot outside the ring of "
                             f"its {cap}")


def _check_clock2qplus(a: Mapping[str, np.ndarray], U: int) -> None:
    _check_rings(a, U, dict(scap="skey", mcap="mkey", gcap="gkey"))
    _check_cursors(a, dict(spos="scap", hand="mcap", gpos="gcap"))
    _check_nonnegative(a, ("window", "skip_limit"))
    _check_segments(a, {W_SMALL: "scap", W_MAIN: "mcap", W_GHOST: "gcap"})


def _check_s3fifo(a: Mapping[str, np.ndarray], U: int) -> None:
    _check_rings(a, U, dict(scap="skey", mcap="mkey", gcap="gkey"))
    _check_cursors(a, dict(spos="scap", mhead="mcap", gpos="gcap"))
    _check_cursors(a, dict(mcount="mcap"), slack=1)
    _check_nonnegative(a, ("skip_limit", "promote_at"))
    _check_segments(a, {W_SMALL: "scap", W_MAIN: "mcap", W_GHOST: "gcap"})
    # the kernel's reinsertion walk equals the reference's closed form for
    # freqs in [0, freq_cap], and freq_cap is the ``bits`` knob's 1 or 3
    if ((a["freq_cap"] < 1) | (a["freq_cap"] > 3)).any():
        raise ValueError(f"freq_cap {a['freq_cap'].tolist()} outside [1, 3]")
    for k in ("sfreq", "mfreq"):
        if ((a[k] < 0) | (a[k] > a["freq_cap"][:, None])).any():
            raise ValueError(f"{k} holds a freq outside [0, freq_cap]")


def _check_slot_table(a: Mapping[str, np.ndarray]) -> None:
    """``loc`` (Clock, LRU) holds EMPTY or a slot of the logical ring."""
    if ((a["loc"] < EMPTY) | (a["loc"] >= a["cap"][:, None])).any():
        raise ValueError("loc names a slot outside the ring of its cap")


def _check_fifo(a: Mapping[str, np.ndarray], U: int) -> None:
    _check_rings(a, U, dict(cap="keys"))
    _check_cursors(a, dict(pos="cap"))


def _check_clock(a: Mapping[str, np.ndarray], U: int) -> None:
    _check_rings(a, U, dict(cap="keys"))
    _check_cursors(a, dict(hand="cap"))
    _check_slot_table(a)


def _check_lru(a: Mapping[str, np.ndarray], U: int) -> None:
    _check_rings(a, U, dict(cap="keys"))
    _check_nonnegative(a, ("t",))
    _check_slot_table(a)


class _Family(NamedTuple):
    """A state layout: its tensors and dtypes, a per-lane scalar of it
    (0-d in an unbatched reference state), the kernel wrapper's layout
    check, and the check of the values the kernel indexes with."""
    dtypes: Mapping[str, torch.dtype]
    scalar: str
    check_state: Callable
    check_values: Callable


_FAMILIES = {
    "clock2q+": _Family(clock2qplus.STATE_DTYPES, "spos",
                        cache_sim_ops.check_state, _check_clock2qplus),
    "s3fifo": _Family(s3fifo.STATE_DTYPES, "spos", s3fifo_ops.check_state,
                      _check_s3fifo),
    **{name: _Family(simple.DTYPES[name], "cap",
                     functools.partial(simple_ops.check_state, name), check)
       for name, check in (("fifo", _check_fifo), ("clock", _check_clock),
                           ("lru", _check_lru))},
}


def step_family(policy: str) -> Tuple[Callable, Callable]:
    """What lanes of one launch must share: the engine's init and step
    (``clock2q+`` and ``clock2q`` share theirs)."""
    eng = get_engine(policy)
    return eng.init_fn, eng.step_fn


def state_family(keys) -> str:
    """The layout a state's tensor names belong to: ``clock2q+`` (which
    ``clock2q`` shares), ``s3fifo``, ``fifo``, ``clock`` or ``lru``."""
    for name, fam in _FAMILIES.items():
        if set(keys) == set(fam.dtypes):
            return name
    raise ValueError(f"state keys {sorted(keys)} are no engine's layout")


def state_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> State:
    """A port state from a reference engine state given as numpy arrays
    (``{k: np.asarray(v)}`` of a JAX state of any registered family).  An
    unbatched state (scalar cursors) gains a lane axis of 1; a grid state
    keeps its lanes.  The state is held to its family's layout here, once:
    keys, dtypes, shapes, and every cursor, slot and ring key within its
    ring or table."""
    dev = resolve_device(device)
    fam = _FAMILIES[state_family(arrays)]
    batched = np.ndim(arrays[fam.scalar]) == 1
    # a copy: the port updates its state in place, and the arrays may be
    # read-only views of the caller's buffers
    host = {k: torch.tensor(np.asarray(v) if batched else np.asarray(v)[None])
            for k, v in arrays.items()}
    _, widths = fam.check_state(host)
    fam.check_values({k: v.numpy() for k, v in host.items()}, widths["U"])
    return {k: v.to(dev) for k, v in host.items()}


def state_to_numpy(state: State) -> Dict[str, np.ndarray]:
    """The state as numpy arrays on the host, lane axis first (the layout
    of a reference grid state)."""
    return {k: v.cpu().numpy() for k, v in state.items()}


def _device(state: State) -> torch.device:
    return next(iter(state.values())).device


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
    tr = _as_trace(trace, _device(state))
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
                   state: Optional[State] = None, on_chunk=None,
                   device=None, **kw):
    """Replay an iterable of key chunks, threading the state across chunk
    boundaries: bit-identical to the single-shot ``replay`` of the
    concatenated trace, with one chunk resident at a time.

    Returns ``(hits, n_requests, final_state)``; pass ``state`` back in
    to continue a stream.  With ``state`` given, it sets the device.
    ``on_chunk(n, hits)`` (running totals) fires after each chunk — the
    progress hook callers hang telemetry on without this package
    importing any."""
    universe = int(universe)
    if not (0 < universe <= np.iinfo(np.int32).max):
        raise ValueError(
            f"universe {universe} does not fit the engine's dense int32 id "
            "space; relabel the trace to [0, n_unique) first "
            "(repro_torch.tuning.sweep.relabel)")
    eng = get_engine(policy)
    st = eng.init(capacity, universe, device=device, **kw) \
        if state is None else state
    dev = _device(st)
    hits = 0
    n = 0
    for chunk in chunks:
        arr = np.ascontiguousarray(chunk)
        _check_keys(arr, universe)
        counts = eng.replay_fn(st, _as_trace(arr, dev), "counts")
        hits += int(counts.sum())
        n += int(arr.shape[0])
        if on_chunk is not None:
            on_chunk(n, hits)
    return hits, n, st


def grid_init(configs: Sequence[SweepConfig], universe: int,
              device=None) -> State:
    """Lane-batched state, one lane per config: rings padded to the grid
    maxima, logical sizes as per-lane scalars.  The configs' policies
    must share one step (clock2q+ and clock2q do; ``sweep_hits``
    partitions a mixed grid by step family)."""
    if len(configs) == 0:
        raise ValueError("empty sweep grid")
    engines = [get_engine(p) for p in sorted({c.policy for c in configs})]
    if len({(e.init_fn, e.step_fn) for e in engines}) != 1:
        raise ValueError(
            f"one grid_init call batches ONE step family, got "
            f"{[e.name for e in engines]} — partition the grid by "
            "step_family(config.policy) first")
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
    tr = _as_trace(trace, _device(states))
    return get_engine(policy).replay_fn(states, tr, "counts")


def grid_hit_arrays(policy: str, states: State, trace) -> torch.Tensor:
    """Per-access hit arrays for every lane, (L, T) bool.  ``states`` is
    advanced in place."""
    tr = _as_trace(trace, _device(states))
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
