"""The capacity-masked Clock2Q+ step (paper §3), lane-batched in PyTorch.

The port of ``repro/core/engine/clock2qplus.py``: the same state keys,
dtypes and padded layout, with a leading lane axis on every tensor.  A
state holds L independent simulations; a single configuration is L = 1
with physical sizes equal to the logical ones.

State (``L`` lanes, physical ring sizes ``pS``/``pM``/``pG``, ``U`` the
key universe):

  * Small FIFO ``skey`` (L, pS) int32, ``sref`` (L, pS) bool, ``sseq``
    (L, pS) int32, cursor ``spos`` and insert counter ``seqctr`` (L,);
  * Main clock ``mkey`` (L, pM) int32, ``mref`` (L, pM) bool, ``hand``;
  * Ghost ring ``gkey`` (L, pG) int32, cursor ``gpos``;
  * location tables ``loc_w`` (L, U) int8 (which segment, ``W_*``) and
    ``loc_s`` (L, U) int32 (slot within it);
  * per-lane logical sizes ``scap``/``mcap``/``gcap``, ``window`` and
    ``skip_limit`` (L,) int32.

Cursors wrap modulo the logical sizes; padded slots start EMPTY and are
never reached.  The step is masked, not branched, and finds the Main
clock's victim in closed form: with cyclic distance ``d = (slot - hand)
mod mcap`` and ``skippable = occupied & ref``, the hand stops at ``vd =
min(first non-skippable d, skip_limit)`` (a fruitless full lap takes the
hand slot, ``vd = mcap``) and clears the refs of the ``d < vd`` slots.

``step`` updates the state IN PLACE: the location tables are the bulk of
the state, and a functional update would copy them on every request.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.engine.layout import (
    EMPTY, W_GHOST, W_MAIN, W_NONE, W_SMALL, SweepConfig, c2qp_sizes,
)
from repro_torch.core.engine.masked import mget, mset

# Every state tensor and its dtype: the reference's layout (JAX's default
# 32-bit integers, bool ref bits, int8 "where" codes).
STATE_DTYPES = dict(
    skey=torch.int32, sref=torch.bool, sseq=torch.int32, spos=torch.int32,
    seqctr=torch.int32, mkey=torch.int32, mref=torch.bool, hand=torch.int32,
    gkey=torch.int32, gpos=torch.int32, loc_w=torch.int8, loc_s=torch.int32,
    scap=torch.int32, mcap=torch.int32, gcap=torch.int32,
    window=torch.int32, skip_limit=torch.int32,
)


def sizes(cfg: SweepConfig) -> Tuple[int, int, int]:
    """Logical queue-array sizes (small, main, ghost) for one config."""
    S, M, G, _ = c2qp_sizes(cfg.capacity, cfg.small_frac, cfg.ghost_frac,
                            cfg.window_frac)
    return S, M, G


def init_lanes(configs: Sequence[SweepConfig], universe: int,
               phys: Optional[Tuple[int, int, int]] = None,
               device=None) -> Dict[str, torch.Tensor]:
    """Masked state for ``len(configs)`` lanes on ``device``.  ``phys``
    pads the rings to shared physical sizes; None means the grid maxima
    (for one config: the degenerate mask, physical == logical)."""
    sz = [c2qp_sizes(c.capacity, c.small_frac, c.ghost_frac, c.window_frac)
          for c in configs]
    if phys is None:
        phys = tuple(max(s[i] for s in sz) for i in range(3))
    pS, pM, pG = phys
    L, U = len(configs), int(universe)

    def lane_scalar(vals):
        return torch.tensor(vals, dtype=torch.int32, device=device)

    def full(n, value, dtype):
        return torch.full((L, n), value, dtype=dtype, device=device)

    return dict(
        skey=full(pS, EMPTY, torch.int32), sref=full(pS, False, torch.bool),
        sseq=full(pS, 0, torch.int32), spos=lane_scalar([0] * L),
        seqctr=lane_scalar([0] * L),
        mkey=full(pM, EMPTY, torch.int32), mref=full(pM, False, torch.bool),
        hand=lane_scalar([0] * L),
        gkey=full(pG, EMPTY, torch.int32), gpos=lane_scalar([0] * L),
        loc_w=full(U, W_NONE, torch.int8), loc_s=full(U, 0, torch.int32),
        scap=lane_scalar([s[0] for s in sz]),
        mcap=lane_scalar([s[1] for s in sz]),
        gcap=lane_scalar([s[2] for s in sz]),
        window=lane_scalar([s[3] for s in sz]),
        skip_limit=lane_scalar([c.skip_limit for c in configs]),
    )


def init(cfg: SweepConfig, universe: int,
         phys: Optional[Tuple[int, int, int]] = None,
         device=None) -> Dict[str, torch.Tensor]:
    """Masked one-lane state for one configuration (L = 1)."""
    return init_lanes([cfg], universe, phys, device)


def _main_insert(st: Dict[str, torch.Tensor], do_ins: torch.Tensor,
                 ins_key: torch.Tensor) -> None:
    """Insert ``ins_key`` into the Main clock of the ``do_ins`` lanes, at
    the closed-form victim slot."""
    loc_w, loc_s, mkey, mref = st["loc_w"], st["loc_s"], st["mkey"], st["mref"]
    M = mkey.shape[1]  # physical (padded) ring size
    mcap, hand = st["mcap"].long(), st["hand"].long()
    idx = torch.arange(M, device=mkey.device)
    valid = idx < mcap[:, None]
    d = torch.where(valid, torch.remainder(idx - hand[:, None], mcap[:, None]),
                    M + 1)
    skippable = (mkey >= 0) & mref
    k = torch.where(valid & ~skippable, d, M + 1).amin(dim=1)
    k = torch.minimum(k, mcap)  # no non-skippable slot: full lap
    skip = st["skip_limit"].long()
    vd = torch.where(skip > 0, torch.minimum(k, skip), k)
    ms = (hand + vd) % mcap
    mref &= ~(do_ins[:, None] & valid & (d < vd[:, None]))
    victim = mget(mkey, ms).long()
    mset(loc_w, victim.clamp(min=0), W_NONE, do_ins & (victim >= 0))
    mset(loc_w, ins_key, W_MAIN, do_ins)
    mset(loc_s, ins_key, ms, do_ins)
    mset(mkey, ms, ins_key, do_ins)
    mset(mref, ms, False, do_ins)
    st["hand"].copy_(torch.where(do_ins, (ms + 1) % mcap, hand))


def step(st: Dict[str, torch.Tensor],
         key: torch.Tensor) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One Clock2Q+ transition per lane: ``key`` is (L,), one request per
    lane.  Updates ``st`` in place and returns ``(st, hit)``, ``hit``
    (L,) bool."""
    # key < 0 is a padding sentinel: every case mask goes False, so the
    # step is a no-op and the (non-)hit never counts (a step where every
    # lane pads returns at once).
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

    # -- hits: ref-bit updates (small obeys the correlation window) -----------
    # ``slot`` indexes the ring its key's segment names; a lane in another
    # case may carry a slot past this ring's width: clamp it (masked off)
    sref, mref, gkey = st["sref"], st["mref"], st["gkey"]
    s_slot = slot.clamp(max=sref.shape[1] - 1)
    m_slot = slot.clamp(max=mref.shape[1] - 1)
    g_slot = slot.clamp(max=gkey.shape[1] - 1)
    age_ok = (st["seqctr"] - mget(st["sseq"], s_slot)) >= st["window"]
    mset(sref, s_slot, mget(sref, s_slot) | age_ok, is_small)
    mset(mref, m_slot, True, is_main)

    # -- ghost hit: leave the ghost ring, then insert into main ---------------
    mset(gkey, g_slot, EMPTY, is_ghost)
    mset(loc_w, key, W_NONE, is_ghost)

    # -- miss: displace the small-FIFO cursor slot ----------------------------
    spos = st["spos"].long()
    displaced = mget(st["skey"], spos).long()
    disp = is_none & (displaced >= 0)
    displaced = displaced.clamp(min=0)  # EMPTY: masked off from here on
    disp_ref = mget(sref, spos)
    disp_promote = disp & disp_ref
    disp_demote = disp & ~disp_ref
    mset(loc_w, displaced, W_NONE, disp)

    # demote path: ghost-push the displaced key
    g = st["gpos"].long()
    gold = mget(gkey, g).long()
    mset(loc_w, gold.clamp(min=0), W_NONE, disp_demote & (gold >= 0))
    mset(gkey, g, displaced, disp_demote)
    mset(loc_w, displaced, W_GHOST, disp_demote)
    mset(loc_s, displaced, g, disp_demote)
    st["gpos"].copy_(torch.where(disp_demote, (g + 1) % st["gcap"], g))

    # -- main insert (ghost hit or promoted displacee): closed-form clock -----
    # When no lane inserts, every write below is masked off: skip the
    # (L, M) victim search (one host read of ``do_ins`` per request).
    do_ins = is_ghost | disp_promote
    if bool(do_ins.any()):
        _main_insert(st, do_ins, torch.where(is_ghost, key, displaced))

    # -- miss: the new key enters the small FIFO ------------------------------
    seqctr = st["seqctr"]
    mset(st["skey"], spos, key, is_none)
    mset(sref, spos, False, is_none)
    mset(st["sseq"], spos, seqctr, is_none)
    mset(loc_w, key, W_SMALL, is_none)
    mset(loc_s, key, spos, is_none)
    st["spos"].copy_(torch.where(is_none, (spos + 1) % st["scap"], spos))
    seqctr.add_(is_none.to(seqctr.dtype))
    return st, hit
