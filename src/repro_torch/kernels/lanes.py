"""What the lane-replay kernels (``cache_sim``, ``s3fifo_sim``,
``simple_sim``) share around their launches: the checks of a state and a
trace against the layout a kernel takes, the one host read of a launch's
values, and the loop their plain versions run.

A state is a dict of tensors with a leading lane axis: ``(L, width)``
rings and tables and ``(L,)`` per-lane scalars.  ``dtypes`` names every
tensor of a family and its dtype; ``rings`` names the ``(L, width)`` ones
and the width each is padded to (rings of one width name share it).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

OUTS = ("hits", "counts")
State = Dict[str, torch.Tensor]


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
