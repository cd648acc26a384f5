"""OnlineTuner — closes the loop from profiling to a live cache (the
port's own copy of ``repro/tuning/tuner.py``; every profiling round is
one ``sweep_grid`` launch on ``device``, the card unless the caller
passes ``device="cpu"``).

The paper tunes Clock2Q+ offline (fig13's window sweep); production
workloads drift, so the knobs must track the workload online.  The tuner
keeps a ring buffer of the most recent accesses, periodically profiles
that window with the spatially-sampled batched sweep (a full candidate
grid in one kernel launch on ~1/2**rate_shift of the stream), and — when a
candidate configuration beats the live one by at least ``min_gain`` miss
ratio — retargets the live cache through the ``retune`` runtime setter,
which moves segment boundaries via the live-resize protocol (no pause,
lookups stay exact mid-migration).

Works against ``ProdClock2QPlus``, ``ShardedClock2QPlus`` (one decision
from aggregated traffic, applied to every shard) and any cache exposing
the same small surface: ``capacity``, ``tuning``, ``retune``, and an
``engine_policy`` attribute naming its registered lane engine (e.g.
``core.engine.host.EngineCache`` running s3fifo).  The candidate grid
only spans the knobs that engine actually reads — for a knob-free
policy like clock the grid collapses to the live point and the tuner
simply never fires.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch import obs as obs_mod
from repro_torch.core.engine import _FRAC_KNOBS, get_engine
from repro_torch.obs import EV_RETUNE
from repro_torch.core.prodcache import drive_resize
from repro_torch.tuning import profiler
from repro_torch.tuning.sweep import SweepConfig, sweep_grid

DEFAULT_WINDOW_FRACS = (0.1, 0.3, 0.5, 1.0)


@dataclasses.dataclass
class TuneDecision:
    """One profiling round: the candidate grid, estimates, and outcome."""
    at_access: int
    configs: List[SweepConfig]
    est_miss_ratios: np.ndarray
    n_sampled: int
    rate_shift: int
    chosen: SweepConfig
    applied: bool


class OnlineTuner:
    """Periodic sampled re-profiling + live retargeting of a cache."""

    def __init__(self, cache, *, policy: Optional[str] = None,
                 window_fracs: Sequence[float] = DEFAULT_WINDOW_FRACS,
                 small_fracs: Optional[Sequence[float]] = None,
                 ghost_fracs: Optional[Sequence[float]] = None,
                 retune_every: int = 50_000, history: int = 0,
                 rate_shift: int = 6, min_samples: int = 1024,
                 min_scaled_cap: int = 64, min_gain: float = 0.005,
                 confirm_rounds: int = 2, drive_steps: int = 256,
                 max_decisions: int = 256, obs=None, device=None):
        self.cache = cache
        # where the profiling sweeps run (``sweep_grid`` resolves it:
        # cuda unless the caller names another device)
        self.device = device
        # which lane engine simulates this cache: explicit policy= wins,
        # else the cache declares it (engine_policy), else clock2q+
        self.policy = policy or getattr(cache, "engine_policy", "clock2q+")
        self.engine = get_engine(self.policy)
        self.window_fracs = tuple(window_fracs)
        # None = hold the cache's current fraction (window-only tuning);
        # pass explicit candidates to tune the queue fractions too.
        self.small_fracs = tuple(small_fracs) if small_fracs else None
        self.ghost_fracs = tuple(ghost_fracs) if ghost_fracs else None
        self.retune_every = retune_every
        self.history = history or retune_every
        self.rate_shift = rate_shift
        self.min_samples = min_samples
        # Sampling must not scale the mini-cache below this: the window
        # candidates are fractions of the scaled SMALL FIFO, and a
        # too-small mini-cache rounds them all to the same 0-2 slots —
        # the whole dimension being tuned disappears from the estimate.
        self.min_scaled_cap = min_scaled_cap
        self.min_gain = min_gain
        # debounce: a challenger must win this many CONSECUTIVE rounds
        # before it is applied (sampled estimates are noisy; one flip
        # must not whipsaw a live cache)
        self.confirm_rounds = confirm_rounds
        self.drive_steps = drive_steps
        self._buf = np.empty(self.history, dtype=np.int64)
        self._pos = 0
        self._streak: tuple = (None, 0)  # (challenger, consecutive wins)
        self.n_observed = 0
        # bounded: a long-lived service profiles forever, and each
        # decision retains its candidate grid + estimate arrays
        self.decisions: collections.deque = collections.deque(
            maxlen=max_decisions)
        # telemetry: profiling rounds / applied retunes as counters, the
        # sampled-MRC estimate of every grid point as a gauge family
        # (the profiler's what-if surface, scrapeable per round), and an
        # EV_RETUNE event per applied decision
        self.obs = obs_mod.ObsSink(src="tuner") if obs is None else obs
        self._c_rounds = self.obs.counter(
            "tuner_rounds_total", (), "profiling rounds run").labels()
        self._c_retunes = self.obs.counter(
            "tuner_retunes_total", (), "retunes applied to the live "
            "cache").labels()
        self._g_est = self.obs.gauge(
            "tuner_est_miss_ratio",
            ("window_frac", "small_frac", "ghost_frac"),
            "sampled-MRC estimate per candidate config (last round)")
        self._g_live = self.obs.gauge(
            "tuner_live_est_miss_ratio", (), "sampled-MRC estimate of "
            "the live config (last round)").labels()

    # -- observation -----------------------------------------------------------
    def observe(self, key: int) -> Optional[TuneDecision]:
        """Record one access; runs a profiling round every
        ``retune_every`` accesses.  Returns the decision when one ran."""
        self._buf[self._pos] = key
        self._pos = (self._pos + 1) % self.history
        self.n_observed += 1
        if self.n_observed % self.retune_every == 0:
            return self.retune_now()
        return None

    def observe_many(self, keys) -> List[TuneDecision]:
        """Batched ``observe`` (profiling rounds still fire on schedule,
        at batch granularity)."""
        keys = np.asarray(keys, dtype=np.int64)
        out = []
        before = self.n_observed
        for lo in range(0, keys.size,
                        max(1, self.retune_every)):
            chunk = keys[lo:lo + self.retune_every]
            n = chunk.size
            if n >= self.history:
                self._buf[:] = chunk[-self.history:]
                self._pos = 0
            else:
                end = self._pos + n
                if end <= self.history:
                    self._buf[self._pos:end] = chunk
                else:
                    cut = self.history - self._pos
                    self._buf[self._pos:] = chunk[:cut]
                    self._buf[:end - self.history] = chunk[cut:]
                self._pos = end % self.history
            self.n_observed += n
            if self.n_observed // self.retune_every \
                    > before // self.retune_every:
                d = self.retune_now()
                if d is not None:
                    out.append(d)
                before = self.n_observed
        return out

    def recent(self) -> np.ndarray:
        """The buffered access window, oldest first."""
        n = min(self.n_observed, self.history)
        if n < self.history:
            return self._buf[:self._pos].copy()
        return np.concatenate([self._buf[self._pos:], self._buf[:self._pos]])

    # -- the profiling + retargeting round --------------------------------------
    def _realizable(self, sf: float, gf: float) -> bool:
        """A fraction candidate is only worth estimating if the cache's
        preallocation can realize it — ``set_capacity`` clamps to the
        construction-time maxima (give ``max_small_frac``/
        ``min_small_frac``/``max_ghost_frac`` headroom to widen the
        search space).  A small fraction must fit the small maximum AND
        leave a main that fits the main maximum: a clamped segment would
        silently shrink the effective capacity, so the estimate (made at
        the unclamped shape) would not describe the applied cache.
        Caches without preallocation clamps (no ``max_small`` — e.g. an
        ``EngineCache`` that re-inits on retune) realize everything."""
        shards = getattr(self.cache, "shards", None) or [self.cache]
        for s in shards:
            if not hasattr(s, "max_small"):
                continue
            sc = max(1, int(round(s.capacity * sf)))
            if sc > s.max_small or s.capacity - sc > s.max_main:
                return False
            if int(round(s.capacity * gf)) > s.max_ghost:
                return False
        return True

    def _live_skip_limit(self) -> int:
        """The cache's clock skip limit, translated to the SweepConfig
        convention — every estimate must simulate the policy the cache
        actually runs.  ProdClock2QPlus uses None for unlimited and
        forces AFTER the skip counter reaches the limit, so its 0 and 1
        both allow exactly one ref-clearing skip; SweepConfig uses 0 for
        unlimited, hence None -> 0 and n -> max(1, n).  A cache already
        speaking the lane convention says so via ``lane_skip_limit``."""
        shards = getattr(self.cache, "shards", None) or [self.cache]
        lane = getattr(shards[0], "lane_skip_limit", None)
        if lane is not None:
            return int(lane)
        sk = getattr(shards[0], "skip_limit", None)
        return 0 if sk is None else max(1, int(sk))

    def _live_config(self) -> SweepConfig:
        """The configuration the cache runs right now, as a grid point.
        Starts from the engine's own base config (preset defaults for
        fields the cache does not report) and overlays the cache's
        current fraction knobs."""
        base = self.engine.config(self.cache.capacity,
                                  skip_limit=self._live_skip_limit())
        cur = self.cache.tuning
        fracs = {k: float(cur[k]) for k in _FRAC_KNOBS
                 if k in self.engine.knobs and cur.get(k) is not None}
        return dataclasses.replace(base, **fracs)

    def candidate_grid(self) -> List[SweepConfig]:
        """Current-capacity grid over the candidate knobs (candidates the
        preallocation cannot realize are dropped), with the LIVE
        configuration always included (so the gain comparison is against
        the cache as it runs today).  Dimensions the engine does not
        read (``engine.knobs``) collapse to the live value — a
        knob-free policy yields just the live point."""
        live = self._live_config()
        knobs = self.engine.knobs
        wfs = self.window_fracs if "window_frac" in knobs \
            else (live.window_frac,)
        sfs = (self.small_fracs or (live.small_frac,)) \
            if "small_frac" in knobs else (live.small_frac,)
        gfs = (self.ghost_fracs or (live.ghost_frac,)) \
            if "ghost_frac" in knobs else (live.ghost_frac,)
        grid = [dataclasses.replace(live, window_frac=float(wf),
                                    small_frac=float(sf),
                                    ghost_frac=float(gf))
                for wf in wfs for sf in sfs for gf in gfs
                if self._realizable(sf, gf)]
        if live not in grid:
            grid.append(live)
        return grid

    def retune_now(self) -> Optional[TuneDecision]:
        """Profile the recent window and retarget the cache if a
        candidate wins by ``min_gain``.

        Adaptive sampling rate: the shift is bounded by (a) the cache
        capacity, so the scaled mini-cache keeps window resolution
        (``min_scaled_cap``), and (b) the sample count, backing off
        toward exact (shift 0) mini-simulation when the hash sample of
        the window is too thin.  The sample always spans the WHOLE
        buffered window — spatial sampling preserves each surviving
        key's full access sequence, and cutting the horizon instead
        would hide exactly the long-run evictions being tuned for.  The
        sweep runs padded to a power-of-two length with no-op keys, as
        the reference's does."""
        recent = self.recent()
        if recent.size == 0:
            return None
        # rate bounded by capacity (window resolution) and sample count
        cap_bound = max(0, (self.cache.capacity
                            // max(1, self.min_scaled_cap)).bit_length() - 1)
        shift = min(self.rate_shift, cap_bound)
        sampled = profiler.sample_trace(recent, shift)
        while shift > 0 and sampled.size < self.min_samples:
            shift -= 1
            sampled = profiler.sample_trace(recent, shift)
        if sampled.size == 0:
            return None
        grid = self.candidate_grid()
        est = sweep_grid(sampled, profiler.scaled_configs(grid, shift),
                         pad_pow2=True, device=self.device)
        n_sampled = int(sampled.size)
        live = self._live_config()
        live_mr = est[grid.index(live)]
        best_i = int(np.nanargmin(est))
        chosen = grid[best_i]
        self._c_rounds.value += 1
        for cfg, e in zip(grid, est):
            self._g_est.labels(f"{cfg.window_frac:g}",
                               f"{cfg.small_frac:g}",
                               f"{cfg.ghost_frac:g}").set(float(e))
        self._g_live.set(float(live_mr))
        wins = (chosen != live
                and live_mr - est[best_i] >= self.min_gain)
        if wins:
            prev, streak = self._streak
            streak = streak + 1 if chosen == prev else 1
            self._streak = (chosen, streak)
        else:
            self._streak = (None, 0)
        applied = wins and self._streak[1] >= self.confirm_rounds
        if applied:
            self._streak = (None, 0)
            self.cache.retune(**{k: getattr(chosen, k) for k in _FRAC_KNOBS
                                 if k in self.engine.knobs})
            if hasattr(self.cache, "resize_step"):
                drive_resize(self.cache, self.drive_steps)
            self._c_retunes.value += 1
            # window fracs as per-mille ints (event a/b are int64),
            # estimated gain in c
            self.obs.emit(EV_RETUNE,
                          a=int(round(1000 * live.window_frac)),
                          b=int(round(1000 * chosen.window_frac)),
                          c=float(live_mr - est[best_i]))
        d = TuneDecision(self.n_observed, grid, est, n_sampled, shift,
                         chosen, applied)
        self.decisions.append(d)
        return d
