"""EngineCache — a host-side cache facade over any registered lane
engine (the port of ``repro/core/engine/host.py``).

``ProdClock2QPlus`` is the production-shaped Clock2Q+ (chained hash,
pin/IO states, live resize); this is the *thin* counterpart for every
OTHER registered policy: a stateful object with hit/miss counters and
the small tuning surface the ``OnlineTuner`` speaks (``capacity`` /
``tuning`` / ``retune`` / ``engine_policy``), backed by the exact
masked step the MRC sweep simulates.  The state lives on ``device``
(the card unless the caller passes ``device="cpu"``), and each
``access_many`` is one launch of the family's kernel.

Keys must be dense int ids in ``[0, universe)`` (relabel first, like
every lane consumer).  ``retune`` of the correlation window is a live
in-place update (the window is a per-lane scalar of the engine state);
changing queue FRACTIONS re-inits the state cold on the cache's device —
this facade has no live resize protocol, and a cold restart is the
honest semantics for a simulation-backed cache (not the §4.2
migration).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

import repro_torch.core.engine as engine
from repro_torch import resolve_device
from repro_torch.core.engine import _FRAC_KNOBS
from repro_torch.core.engine.layout import SweepConfig, c2qp_sizes


class EngineCache:
    """A live cache running a registered lane engine on ``device``."""

    def __init__(self, policy: str, capacity: int, universe: int,
                 device=None, **knobs):
        self.engine = engine.get_engine(policy)
        self.engine_policy = policy
        self.universe = int(universe)
        self.device = resolve_device(device)
        self.config: SweepConfig = self.engine.config(capacity, **knobs)
        self.state: Dict[str, torch.Tensor] = self.engine.init_config(
            self.config, self.universe, device=self.device)
        self.hits = 0
        self.misses = 0

    # -- identity / tuning surface (what OnlineTuner consumes) -----------------
    @property
    def capacity(self) -> int:
        """Current logical capacity (live-retunable)."""
        return self.config.capacity

    @property
    def tuning(self) -> Dict[str, float]:
        """Current fraction knobs — only the ones this engine reads."""
        return {k: getattr(self.config, k) for k in _FRAC_KNOBS
                if k in self.engine.knobs}

    @property
    def lane_skip_limit(self) -> int:
        """skip_limit already in the SweepConfig convention (0=unlimited)."""
        return int(self.config.skip_limit)

    # -- serving ---------------------------------------------------------------
    def access(self, key: int) -> bool:
        """Serve one access; returns hit?"""
        return bool(self.access_many(np.asarray([key]))[0])

    def access_many(self, keys) -> np.ndarray:
        """Serve a batch of accesses in order; returns the bool hit array
        on the host.  One kernel launch and one copy back per call —
        amortize by batching."""
        arr = np.ascontiguousarray(keys, dtype=np.int32)
        if arr.size and (int(arr.max()) >= self.universe
                         or int(arr.min()) < 0):
            raise ValueError(
                f"key outside [0, {self.universe}); relabel the trace first")
        self.state, h = self.engine.replay(self.state, arr)
        h = h[0].cpu().numpy()
        nh = int(h.sum())
        self.hits += nh
        self.misses += int(arr.size) - nh
        return h

    @property
    def miss_ratio(self) -> float:
        """Lifetime miss ratio (1.0 before any access)."""
        n = self.hits + self.misses
        return 1.0 if n == 0 else self.misses / n

    # -- retuning --------------------------------------------------------------
    def retune(self, *, small_frac: Optional[float] = None,
               ghost_frac: Optional[float] = None,
               window_frac: Optional[float] = None) -> None:
        """Retarget the knobs.  Window-only changes apply LIVE (the
        correlation window is a per-lane scalar in the masked state,
        updated in place); any queue-fraction change re-inits the state
        cold (no live resize here — see the module docstring)."""
        changes = {k: float(v) for k, v in (("small_frac", small_frac),
                                            ("ghost_frac", ghost_frac),
                                            ("window_frac", window_frac))
                   if v is not None and k in self.engine.knobs
                   and float(v) != getattr(self.config, k)}
        if not changes:
            return
        new_cfg = dataclasses.replace(self.config, **changes)
        if set(changes) == {"window_frac"} and "window" in self.state:
            _, _, _, W = c2qp_sizes(new_cfg.capacity, new_cfg.small_frac,
                                    new_cfg.ghost_frac, new_cfg.window_frac)
            self.state["window"].fill_(W)
        else:
            self.state = self.engine.init_config(new_cfg, self.universe,
                                                 device=self.device)
        self.config = new_cfg
