"""What the lane-replay kernels (``cache_sim``, ``s3fifo_sim``,
``simple_sim``) share around their launches: the checks of a state and a
trace against the layout a kernel takes, the one host read of a launch's
values, the planner of where a kernel keeps each lane, and the loop their
plain versions run.

A state is a dict of tensors with a leading lane axis: ``(L, width)``
rings and tables and ``(L,)`` per-lane scalars.  ``dtypes`` names every
tensor of a family and its dtype; ``rings`` names the ``(L, width)`` ones
and the width each is padded to (rings of one width name share it).

Each kernel runs a lane on one warp, one lane a block, and keeps as much
of the lane as fits in the block's shared memory, chosen per lane on the
host: a lane's *tier* names what lives there.  ``plan_tiers`` picks the
first of a family's tiers whose bytes fit beside the trace ring, and
``plan_grid`` plans a launch, whose blocks all take the largest lane's
shared memory.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch

OUTS = ("hits", "counts")
State = Dict[str, torch.Tensor]

# Shared memory on the card (H100, sm_90): the most one block may use, an
# SM's whole, the share the system keeps of each block, the blocks an SM
# may hold, and the granule of an allocation.
SMEM_BLOCK = 232_448
SMEM_SM = 233_472
SMEM_RESERVED = 1_024
MAX_BLOCKS_SM = 32
SMEM_GRANULE = 128
# Every block stages the trace through a ring of 16 windows of 32 keys.
TRACE_BYTES = 16 * 32 * 4
# Where a lane lives (the kernels' ``tier``): the whole lane in shared
# memory; the rings there and the location table in device memory; (for
# the two-queue families) the Small and Ghost rings there and the Main
# ring and the table in device memory; all in device memory.
TIER_WHOLE, TIER_RINGS, TIER_SMALL, TIER_GLOBAL = 0, 1, 2, 3
TIERS = (TIER_WHOLE, TIER_RINGS, TIER_SMALL, TIER_GLOBAL)


class LanePlan(NamedTuple):
    """One lane's tier, its shared-memory bytes, and how many blocks of
    that size an SM holds."""
    tier: int
    smem_bytes: int
    blocks_per_sm: int


class LaunchPlan(NamedTuple):
    """A launch's per-lane tiers, the shared memory of each of its blocks
    (the most any lane needs) and the blocks an SM holds."""
    tiers: List[int]
    smem_bytes: int
    blocks_per_sm: int


def blocks_per_sm(smem_bytes: int) -> int:
    """Blocks of ``smem_bytes`` of shared memory one SM holds at once."""
    need = -(-smem_bytes // SMEM_GRANULE) * SMEM_GRANULE + SMEM_RESERVED
    return min(MAX_BLOCKS_SM, SMEM_SM // need)


def plan_tiers(options: Sequence[Tuple[int, int]]) -> LanePlan:
    """The first ``(tier, bytes)`` of ``options`` (a family's tiers in
    order of preference, the last ``(TIER_GLOBAL, 0)``) whose bytes fit
    one block's shared memory beside the trace ring."""
    for tier, smem in options:
        if smem + TRACE_BYTES <= SMEM_BLOCK:
            break
    smem += TRACE_BYTES
    return LanePlan(tier, smem, blocks_per_sm(smem))


def plan_grid(lanes: Sequence[LanePlan]) -> LaunchPlan:
    """A launch of ``lanes``: every block with the shared memory of the
    largest."""
    smem = max((p.smem_bytes for p in lanes), default=0)
    return LaunchPlan([p.tier for p in lanes], smem, blocks_per_sm(smem))


def key_range(view: Mapping[str, np.ndarray]) -> int:
    """K of a ``host_view``: 1 + the largest key of the trace and of the
    state's rings (a chunked replay's rings hold keys of earlier chunks).
    Every index of a location table a launch reads or writes is below
    it."""
    return 1 + max(view["trace_max"], view["ring_max"], 0)


def tier_counts(tiers: Sequence[int]) -> List[int]:
    """How many lanes a plan keeps in each tier, in ``TIERS`` order."""
    return [list(tiers).count(t) for t in TIERS]


def check_state(state: State, dtypes: Mapping[str, torch.dtype],
                rings: Mapping[str, str], family: str):
    """Hold ``state`` to a family's layout: keys, dtypes, one device,
    contiguity and shapes.  Returns ``(L, widths)``: the lane count and
    each ring width by name."""
    if set(state) != set(dtypes):
        raise ValueError(f"state keys {sorted(state)} are not the {family} "
                         f"layout {sorted(dtypes)}")
    first = state[next(iter(dtypes))]
    L = first.shape[0] if first.dim() else -1
    widths: Dict[str, int] = {}
    for name, t in state.items():
        if t.dtype != dtypes[name]:
            raise TypeError(f"state[{name!r}] is {t.dtype}, "
                            f"expected {dtypes[name]}")
        if t.device != first.device:
            raise ValueError(f"state[{name!r}] on {t.device}, the state on "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError(f"state[{name!r}] is not contiguous")
        want = 2 if name in rings else 1
        if t.dim() != want or t.shape[0] != L:
            raise ValueError(f"state[{name!r}] has shape {tuple(t.shape)}, "
                             f"expected {want} dims with {L} lanes")
        if name in rings:
            w = widths.setdefault(rings[name], t.shape[1])
            if t.shape[1] != w or w < 1:
                raise ValueError(f"state[{name!r}] width {t.shape[1]} != {w}")
    return L, widths


def check_trace(trace: torch.Tensor, L: int, device: torch.device,
                out: str) -> int:
    """Hold ``trace`` to what a launch takes: int32, contiguous, on the
    state's device, (T,) or (L, T).  Returns T."""
    if out not in OUTS:
        raise ValueError(f"out must be one of {OUTS}, got {out!r}")
    if trace.device != device:
        raise ValueError(f"state on {device}, trace on {trace.device}")
    if trace.dtype != torch.int32:
        raise TypeError(f"trace is {trace.dtype}, expected torch.int32")
    if not trace.is_contiguous():
        raise ValueError("trace is not contiguous")
    if trace.dim() not in (1, 2) or (trace.dim() == 2 and trace.shape[0] != L):
        raise ValueError(f"trace must be (T,) or ({L}, T), got "
                         f"{tuple(trace.shape)}")
    return trace.shape[-1]


def host_view(state: State, trace: torch.Tensor, key_rings,
              scalars) -> Dict[str, np.ndarray]:
    """What the host needs of a launch, in one read from the device: the
    largest trace key, the largest key in the ``key_rings`` (-1 where
    there is none) and the per-lane ``scalars``."""
    none = torch.full((1,), -1, dtype=torch.int32, device=trace.device)
    peaks = [trace.max().view(1) if trace.numel() else none]
    peaks += [state[k].max().view(1) if state[k].numel() else none
              for k in key_rings]
    flat = torch.cat(peaks + [state[k] for k in scalars])
    host = flat.cpu().numpy().astype(np.int64)
    L, n = state[scalars[0]].shape[0], 1 + len(key_rings)
    view = dict(trace_max=int(host[0]), ring_max=int(host[1:n].max()))
    for i, k in enumerate(scalars):
        view[k] = host[n + i * L:n + (i + 1) * L]
    return view


def check_values(view: Mapping[str, np.ndarray], U: int,
                 caps: Mapping[str, int],
                 cursors: Mapping[str, Tuple[str, int]]) -> None:
    """The kernel indexes with these values and checks none of them per
    request: every trace and ring key below ``U``, each logical size in
    ``caps`` within ``[1, its physical width]`` and each cursor within
    ``[0, its size + slack)`` (``cursors``: name -> (size, slack))."""
    for what, peak in (("trace", view["trace_max"]),
                       ("ring", view["ring_max"])):
        if peak >= U:
            raise ValueError(f"{what} key {peak} outside the universe "
                             f"[0, {U})")
    for name, width in caps.items():
        row = view[name]
        if row.size and (int(row.min()) < 1 or int(row.max()) > width):
            raise ValueError(f"logical sizes {name} {row.tolist()} outside "
                             f"the physical ring width {width}")
    for name, (size, slack) in cursors.items():
        row, hi = view[name], view[size] + slack
        if ((row < 0) | (row >= hi)).any():
            raise ValueError(f"{name} {row.tolist()} outside [0, {size}"
                             f"{' + %d' % slack if slack else ''})")


def replay_steps(step: Callable, state: State, trace: torch.Tensor,
                 out: str = "hits") -> torch.Tensor:
    """The plain replay: a loop over the trace of the lane-batched
    ``step(state, key (L,)) -> (state, hit (L,))``, in place.  ``trace``
    is (T,) (one row shared by the lanes) or (L, T); returns hits (L, T)
    bool for ``out="hits"``, or per-lane hit counts (L,) int64."""
    L = next(iter(state.values())).shape[0]
    T = trace.shape[-1]
    hits = torch.zeros((L, T), dtype=torch.bool, device=trace.device)
    for t in range(T):
        key = trace[t].expand(L) if trace.dim() == 1 else trace[:, t]
        _, hits[:, t] = step(state, key)
    if out == "counts":
        return hits.sum(dim=1, dtype=torch.int64)
    return hits
