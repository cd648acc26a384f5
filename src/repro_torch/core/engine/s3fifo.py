"""The capacity-masked S3-FIFO step (FIFO-with-reinsertion Main,
saturating freq counters, ghost tombstone ring), lane-batched in PyTorch.

The port of ``repro/core/engine/s3fifo.py``: the same state keys, dtypes
and padded layout, with a leading lane axis on every tensor, as
``engine.clock2qplus`` is for Clock2Q+.

State (``L`` lanes, physical ring sizes ``pS``/``pM``/``pG``, ``U`` the
key universe):

  * Small FIFO ``skey``/``sfreq`` (L, pS) int32, cursor ``spos`` (L,);
  * Main ring ``mkey``/``mfreq`` (L, pM) int32, ``mhead`` and ``mcount``;
  * Ghost ring ``gkey`` (L, pG) int32, cursor ``gpos``;
  * location tables ``loc_w`` (L, U) int8 and ``loc_s`` (L, U) int32;
  * per-lane ``freq_cap`` and ``promote_at`` (the ``bits`` knob: 1 and 1,
    or 3 and 2), logical sizes ``scap``/``mcap``/``gcap`` and
    ``skip_limit`` (0 = unlimited), (L,) int32.

The Main ring's evict-from-head-with-reinsertion walk is found in closed
form, as the reference does: a slot at cyclic distance ``d = (i - mhead)
mod mcap`` holding freq ``f`` first presents freq 0 at walk position
``d + f * mcap``, so the walk stops at ``p = min_i(d + f * mcap)``, capped
at ``skip_limit``; each slot loses one freq per visit before ``p``, the
victim is ``(mhead + p) mod mcap`` and the head moves past it.

``step`` updates the state IN PLACE, as ``engine.clock2qplus.step`` does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.engine.layout import (
    EMPTY, W_GHOST, W_MAIN, W_NONE, W_SMALL, SweepConfig, sq_sizes,
)
from repro_torch.core.engine.masked import mget, mset

# Every state tensor and its dtype: the reference's layout.
STATE_DTYPES = dict(
    skey=torch.int32, sfreq=torch.int32, spos=torch.int32,
    mkey=torch.int32, mfreq=torch.int32, mhead=torch.int32,
    mcount=torch.int32, gkey=torch.int32, gpos=torch.int32,
    loc_w=torch.int8, loc_s=torch.int32, freq_cap=torch.int32,
    promote_at=torch.int32, scap=torch.int32, mcap=torch.int32,
    gcap=torch.int32, skip_limit=torch.int32,
)
# The (L, width) tensors and the width each is padded to.
RINGS = dict(skey="pS", sfreq="pS", mkey="pM", mfreq="pM", gkey="pG",
             loc_w="U", loc_s="U")

_BIG = 2**30  # above any reachable walk position; far from int64 overflow


def sizes(cfg: SweepConfig) -> Tuple[int, int, int]:
    """Logical (small, main, ghost) ring sizes for ``cfg``."""
    return sq_sizes(cfg.capacity, cfg.small_frac, cfg.ghost_frac)


def init_lanes(configs: Sequence[SweepConfig], universe: int,
               phys: Optional[Tuple[int, int, int]] = None,
               device=None) -> Dict[str, torch.Tensor]:
    """Masked state for ``len(configs)`` lanes on ``device``; ``phys``
    pads the rings (None: the grid maxima)."""
    sz = [sizes(c) for c in configs]
    if phys is None:
        phys = tuple(max(s[i] for s in sz) for i in range(3))
    pS, pM, pG = phys
    L, U = len(configs), int(universe)

    def lane_scalar(vals):
        return torch.tensor(vals, dtype=torch.int32, device=device)

    def full(n, value, dtype=torch.int32):
        return torch.full((L, n), value, dtype=dtype, device=device)

    return dict(
        skey=full(pS, EMPTY), sfreq=full(pS, 0), spos=lane_scalar([0] * L),
        mkey=full(pM, EMPTY), mfreq=full(pM, 0), mhead=lane_scalar([0] * L),
        mcount=lane_scalar([0] * L),
        gkey=full(pG, EMPTY), gpos=lane_scalar([0] * L),
        loc_w=full(U, W_NONE, torch.int8), loc_s=full(U, 0),
        freq_cap=lane_scalar([1 if c.bits == 1 else 3 for c in configs]),
        promote_at=lane_scalar([1 if c.bits == 1 else 2 for c in configs]),
        scap=lane_scalar([s[0] for s in sz]),
        mcap=lane_scalar([s[1] for s in sz]),
        gcap=lane_scalar([s[2] for s in sz]),
        skip_limit=lane_scalar([c.skip_limit for c in configs]),
    )


def _main_insert(st: Dict[str, torch.Tensor], do_ins: torch.Tensor,
                 ins_key: torch.Tensor) -> None:
    """Insert ``ins_key`` into the Main ring of the ``do_ins`` lanes: at
    the tail while the ring fills, else in the closed-form victim's slot."""
    loc_w, loc_s = st["loc_w"], st["loc_s"]
    mkey, mfreq = st["mkey"], st["mfreq"]
    M = mkey.shape[1]  # physical (padded) ring size
    mcap, mhead = st["mcap"].long(), st["mhead"].long()
    mcount = st["mcount"].long()
    idx = torch.arange(M, device=mkey.device)
    valid = idx < mcap[:, None]
    full = mcount >= mcap
    need_evict = do_ins & full
    d = torch.where(valid, torch.remainder(idx - mhead[:, None],
                                           mcap[:, None]), 0)
    score = torch.where(valid, d + mfreq.long() * mcap[:, None], _BIG)
    p = score.amin(dim=1)
    skip = st["skip_limit"].long()
    p = torch.where(skip > 0, torch.minimum(p, skip), p)
    # every visit before position p was a reinsertion: one freq each
    visits = torch.where(valid, torch.clamp(-torch.div(
        d - p[:, None], mcap[:, None], rounding_mode="floor"), min=0), 0)
    mfreq.sub_(torch.where(need_evict[:, None], visits, 0).to(mfreq.dtype))
    ms = torch.where(full, (mhead + p) % mcap, (mhead + mcount) % mcap)
    victim = mget(mkey, ms).long()
    mset(loc_w, victim.clamp(min=0), W_NONE, need_evict & (victim >= 0))
    mset(loc_w, ins_key, W_MAIN, do_ins)
    mset(loc_s, ins_key, ms, do_ins)
    mset(mkey, ms, ins_key, do_ins)
    mset(mfreq, ms, 0, do_ins)
    st["mhead"].copy_(torch.where(need_evict, (mhead + p + 1) % mcap, mhead))
    st["mcount"].copy_(torch.where(do_ins & ~full, mcount + 1, mcount))


def step(st: Dict[str, torch.Tensor],
         key: torch.Tensor) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One S3-FIFO transition per lane: ``key`` is (L,), one request per
    lane.  Updates ``st`` in place and returns ``(st, hit)``, ``hit``
    (L,) bool.  ``key < 0`` is the no-op padding sentinel."""
    active = key >= 0
    if not bool(active.any()):
        return st, active
    key = key.long().clamp(min=0)
    loc_w, loc_s = st["loc_w"], st["loc_s"]
    where = mget(loc_w, key)
    slot = mget(loc_s, key).long()
    is_small = active & (where == W_SMALL)
    is_main = active & (where == W_MAIN)
    is_ghost = active & (where == W_GHOST)
    is_none = active & (where == W_NONE)
    hit = is_small | is_main

    # -- hits: saturating freq bumps ------------------------------------------
    # a lane in another case may carry a slot past this ring: clamp it
    sfreq, mfreq, gkey = st["sfreq"], st["mfreq"], st["gkey"]
    s_slot = slot.clamp(max=sfreq.shape[1] - 1)
    m_slot = slot.clamp(max=mfreq.shape[1] - 1)
    g_slot = slot.clamp(max=gkey.shape[1] - 1)
    freq_cap = st["freq_cap"]
    mset(sfreq, s_slot, torch.minimum(freq_cap, mget(sfreq, s_slot) + 1),
         is_small)
    mset(mfreq, m_slot, torch.minimum(freq_cap, mget(mfreq, m_slot) + 1),
         is_main)

    # -- ghost hit: leave the ghost ring, then insert into main ---------------
    mset(gkey, g_slot, EMPTY, is_ghost)
    mset(loc_w, key, W_NONE, is_ghost)

    # -- miss: displace the small-FIFO cursor slot ----------------------------
    spos = st["spos"].long()
    displaced = mget(st["skey"], spos).long()
    disp = is_none & (displaced >= 0)
    displaced = displaced.clamp(min=0)  # EMPTY: masked off from here on
    promote = mget(sfreq, spos) >= st["promote_at"]
    disp_promote = disp & promote
    disp_demote = disp & ~promote
    mset(loc_w, displaced, W_NONE, disp)

    # demote path: ghost-push the displaced key
    g = st["gpos"].long()
    gold = mget(gkey, g).long()
    mset(loc_w, gold.clamp(min=0), W_NONE, disp_demote & (gold >= 0))
    mset(gkey, g, displaced, disp_demote)
    mset(loc_w, displaced, W_GHOST, disp_demote)
    mset(loc_s, displaced, g, disp_demote)
    st["gpos"].copy_(torch.where(disp_demote, (g + 1) % st["gcap"], g))

    # -- main insert (ghost hit or promoted displacee) ------------------------
    # When no lane inserts, every write below is masked off: skip the
    # (L, M) walk (one host read of ``do_ins`` per request).
    do_ins = is_ghost | disp_promote
    if bool(do_ins.any()):
        _main_insert(st, do_ins, torch.where(is_ghost, key, displaced))

    # -- miss: the new key enters the small FIFO ------------------------------
    mset(st["skey"], spos, key, is_none)
    mset(sfreq, spos, 0, is_none)
    mset(loc_w, key, W_SMALL, is_none)
    mset(loc_s, key, spos, is_none)
    st["spos"].copy_(torch.where(is_none, (spos + 1) % st["scap"], spos))
    return st, hit
