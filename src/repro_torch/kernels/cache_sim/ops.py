"""The ``cache_sim`` wrapper: lane-parallel Clock2Q+ trace replay.

``cache_sim(state, trace, out)`` replays ``trace`` through every lane of
a Clock2Q+ engine state, updating the state in place.  On CUDA tensors it
launches the Hopper kernel (``csrc/cache_sim.cu``) or raises; on CPU
tensors, and only there, it runs the plain version (``ref.py``).

``launch_count`` counts kernel launches (a plain integer; reset it by
assigning 0), so a run can show that its path went through the kernel.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.engine.clock2qplus import STATE_DTYPES
from repro_torch.kernels.cache_sim.ref import cache_sim_plain

# Number of kernel launches in this process.
launch_count = 0

_OUTS = ("hits", "counts")
_RINGS = dict(skey="pS", sref="pS", sseq="pS", mkey="pM", mref="pM",
              gkey="pG", loc_w="U", loc_s="U")


def check_state(state: Dict[str, torch.Tensor]):
    """Hold a state to the layout the kernel takes: keys, dtypes, one
    device, contiguity and shapes.  Returns ``(L, widths)``, the lane
    count and the ring and table widths (``pS``, ``pM``, ``pG``, ``U``)."""
    if set(state) != set(STATE_DTYPES):
        raise ValueError(f"state keys {sorted(state)} are not the Clock2Q+ "
                         f"layout {sorted(STATE_DTYPES)}")
    L = state["spos"].shape[0] if state["spos"].dim() else -1
    widths = {}
    for name, t in state.items():
        if t.dtype != STATE_DTYPES[name]:
            raise TypeError(f"state[{name!r}] is {t.dtype}, "
                            f"expected {STATE_DTYPES[name]}")
        if t.device != state["spos"].device:
            raise ValueError(f"state[{name!r}] on {t.device}, spos on "
                             f"{state['spos'].device}")
        if not t.is_contiguous():
            raise ValueError(f"state[{name!r}] is not contiguous")
        want = 2 if name in _RINGS else 1
        if t.dim() != want or t.shape[0] != L:
            raise ValueError(f"state[{name!r}] has shape {tuple(t.shape)}, "
                             f"expected {want} dims with {L} lanes")
        if name in _RINGS:
            w = widths.setdefault(_RINGS[name], t.shape[1])
            if t.shape[1] != w or w < 1:
                raise ValueError(f"state[{name!r}] width {t.shape[1]} != {w}")
    return L, widths


def _check(state: Dict[str, torch.Tensor], trace: torch.Tensor, out: str):
    """Validate what the kernel takes; returns (L, T, widths)."""
    if out not in _OUTS:
        raise ValueError(f"out must be one of {_OUTS}, got {out!r}")
    L, widths = check_state(state)
    if trace.device != state["spos"].device:
        raise ValueError(f"state on {state['spos'].device}, trace on "
                         f"{trace.device}")
    if trace.dtype != torch.int32:
        raise TypeError(f"trace is {trace.dtype}, expected torch.int32")
    if not trace.is_contiguous():
        raise ValueError("trace is not contiguous")
    if trace.dim() not in (1, 2) or (trace.dim() == 2
                                     and trace.shape[0] != L):
        raise ValueError(f"trace must be (T,) or ({L}, T), got "
                         f"{tuple(trace.shape)}")
    return L, trace.shape[-1], widths


def _check_values(state, trace, widths) -> None:
    """The kernel indexes with these values: hold them to the layout."""
    if trace.numel() and int(trace.max()) >= widths["U"]:
        raise ValueError(f"trace key {int(trace.max())} outside the "
                         f"universe [0, {widths['U']})")
    caps = torch.stack([state["scap"], state["mcap"], state["gcap"]]).cpu()
    for row, w in zip(caps, (widths["pS"], widths["pM"], widths["pG"])):
        if int(row.min()) < 1 or int(row.max()) > w:
            raise ValueError(f"logical sizes {row.tolist()} outside the "
                             f"physical ring width {w}")


def cache_sim(state: Dict[str, torch.Tensor], trace: torch.Tensor,
              out: str = "hits") -> torch.Tensor:
    """Replay ``trace`` through every lane of ``state``, in place.

    ``trace`` is (T,) int32 (one row shared by all lanes, as in a sweep)
    or (L, T) (one row per lane); keys < 0 are no-op padding.  Returns
    hits (L, T) bool for ``out="hits"``, or per-lane hit counts (L,)
    int64 for ``out="counts"`` (no L x T array is built)."""
    global launch_count
    L, T, widths = _check(state, trace, out)
    _check_values(state, trace, widths)
    if trace.device.type == "cpu":
        return cache_sim_plain(state, trace, out)
    if trace.device.type != "cuda":
        raise ValueError(f"cache_sim runs on cuda or cpu, not {trace.device}")
    from repro_torch.kernels.cache_sim.build import load

    lib = load()
    dev = trace.device
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
                "gcap", "window", "skip_limit")),
            L, widths["pS"], widths["pM"], widths["pG"], widths["U"], stream)
    if err != 0:
        raise RuntimeError(f"cache_sim launch failed: CUDA error {err}")
    launch_count += 1
    return hits if out == "hits" else counts
