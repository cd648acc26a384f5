"""Host-block IO hardening: retries, backoff, deadlines, degraded mode.

The port's own copy of ``repro/faults/io.py``.

This is the *recovery* half that IO faults demand.  Every host-tier
block copy (swap-in / swap-out) runs through ``HostIO.run``, which

  * consults the ``FaultPlan`` for an injected decision,
  * retries transient ``IO_ERROR`` with exponential backoff up to
    ``RetryPolicy.max_retries`` attempts, abandoning the op when the
    accumulated virtual time would blow the per-op ``deadline_ticks``,
  * serves ``IO_DELAY`` spikes by advancing the clock (never a real
    ``time.sleep`` — the chaos suite must be fast and deterministic),
  * feeds a ``CircuitBreaker`` that sheds the pool to read-through mode
    under sustained failure and probes its way back to healthy,
  * emits one typed obs event per injected fault / retry / giveup /
    degraded-mode flip, so ``tools/obsreport.py --incidents`` can render
    the incident timeline from the ring alone.

Time is virtual: a ``Clock`` counts ticks.  Backoff "sleeps" advance the
clock, making deadline math exact and replay bit-identical across runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.obs import (
    EV_DEGRADED, EV_FAULT, EV_IO_ERROR, EV_IO_RETRY, NullSink,
)
from repro_torch.faults.plan import (
    IO_DELAY, IO_ERROR, PARTIAL_WRITE, SHARD_LOSS, FaultPlan, NullPlan,
)


class Clock:
    """Virtual monotonic clock: integer ticks, advanced explicitly.

    One tick is "one backoff quantum" — wall-clock-free so fault replays
    are deterministic and tests never sleep."""

    def __init__(self):
        self.now = 0

    def advance(self, ticks: int) -> None:
        """Advance time by ``ticks`` (the virtual sleep)."""
        self.now += int(ticks)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry/backoff/deadline knobs for one host-block IO operation.

    ``backoff(attempt)`` returns ``base_backoff * factor**attempt``
    capped at ``max_backoff`` — classic bounded exponential backoff.
    ``deadline_ticks`` bounds the total virtual time (delays + backoffs)
    one logical op may consume before it is abandoned.
    """

    max_retries: int = 3
    base_backoff: int = 1
    factor: int = 2
    max_backoff: int = 64
    deadline_ticks: int = 256

    def backoff(self, attempt: int) -> int:
        """Backoff ticks before retry number ``attempt`` (0-based)."""
        return min(self.max_backoff,
                   self.base_backoff * self.factor ** attempt)


class CircuitBreaker:
    """Sheds host IO under sustained failure (degraded read-through).

    Closed (healthy) -> ``threshold`` consecutive failed ops open it ->
    while open, every host swap is skipped outright (the pool serves
    read-through: misses fill from the origin, evictions drop) -> after
    ``probe_after`` skipped ops one probe op is let through; success
    closes the breaker, failure re-opens it.  State flips emit
    ``EV_DEGRADED`` (a=1 enter, a=0 exit).
    """

    def __init__(self, threshold: int = 8, probe_after: int = 64,
                 obs=None):
        self.threshold = threshold
        self.probe_after = probe_after
        self.obs = NullSink(src="breaker") if obs is None else obs
        self.consecutive_failures = 0
        self.open = False
        self._skipped = 0
        self.trips = 0

    def allow(self) -> bool:
        """Should this op attempt real IO?  False = shed (degraded)."""
        if not self.open:
            return True
        self._skipped += 1
        if self._skipped >= self.probe_after:
            self._skipped = 0
            return True  # half-open probe
        return False

    def record(self, ok: bool) -> None:
        """Feed one op outcome; may flip degraded mode."""
        if ok:
            self.consecutive_failures = 0
            if self.open:
                self.open = False
                if self.obs.ring.enabled:
                    self.obs.emit(EV_DEGRADED, a=0)
            return
        self.consecutive_failures += 1
        if not self.open and self.consecutive_failures >= self.threshold:
            self.open = True
            self.trips += 1
            self._skipped = 0
            if self.obs.ring.enabled:
                self.obs.emit(EV_DEGRADED, a=1)


@dataclasses.dataclass
class IOResult:
    """Outcome of one hardened host-block IO operation."""

    ok: bool
    attempts: int = 1
    ticks: int = 0        # virtual time consumed (delays + backoffs)
    corrupt: bool = False  # PARTIAL_WRITE fired: payload is torn
    shed: bool = False     # breaker open: IO skipped, not attempted


class HostIO:
    """The hardened host-block IO path (fault check + retry + breaker).

    ``run(op, key, fn)`` executes ``fn`` under the plan's decisions for
    sequential op numbers.  ``fn`` is the actual copy (or None for a
    pure simulation); injected IO_ERROR faults consume an attempt and
    are retried with backoff until success, ``max_retries`` exhausted,
    or the deadline is blown.
    """

    def __init__(self, plan: Optional[FaultPlan] = None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 clock: Optional[Clock] = None, obs=None):
        self.plan = NullPlan() if plan is None else plan
        self.retry = RetryPolicy() if retry is None else retry
        self.obs = NullSink(src="hostio") if obs is None else obs
        self.breaker = CircuitBreaker(obs=self.obs) if breaker is None \
            else breaker
        self.clock = Clock() if clock is None else clock
        self._c_fault = self.obs.counter(
            "io_faults_injected_total", ("kind",),
            "faults the plan injected, by kind")
        self._c_retry = self.obs.counter(
            "io_retries_total", (), "host-IO retry attempts").labels()
        self._c_error = self.obs.counter(
            "io_errors_total", ("op",),
            "host-IO ops abandoned (retries/deadline exhausted)")
        self._c_shed = self.obs.counter(
            "io_shed_total", (), "ops skipped while degraded "
            "(read-through)").labels()
        self._h_ticks = self.obs.histogram(
            "io_op_ticks", (), "virtual ticks consumed per op "
            "(delays + backoffs)", base=1.0, n_buckets=16)
        # SHARD_LOSS faults are not IO outcomes: the op they fired on
        # proceeds normally and the fault queues here for the owner (the
        # pool drains it into recovery.failover at its next lookup)
        self.pending_shard_loss = []

    @property
    def degraded(self) -> bool:
        """True while the breaker has shed the pool to read-through."""
        return self.breaker.open

    def run(self, op: str, key: int,
            fn: Optional[Callable[[], None]] = None) -> IOResult:
        """Execute one host-block IO op under the fault plan.

        Returns an ``IOResult``; ``fn`` (the real copy) runs exactly
        once, and only when the op ultimately succeeds — a faulted
        attempt never half-applies the copy (crash consistency at the
        op level; PARTIAL_WRITE models the torn-write case explicitly
        via ``corrupt=True``, and the caller quarantines the copy).
        """
        if not self.breaker.allow():
            self._c_shed.value += 1
            return IOResult(ok=False, attempts=0, shed=True)
        ticks = 0
        attempt = 0
        while True:
            fault = self.plan.next_op(op)
            if fault is not None:
                self._c_fault.labels(fault.name).value += 1
                if self.obs.ring.enabled:
                    self.obs.emit(EV_FAULT, a=fault.kind, b=fault.op_seq)
            if fault is not None and fault.kind == SHARD_LOSS:
                self.pending_shard_loss.append(fault)
                fault = None  # the IO op itself is unaffected
            if fault is not None and fault.kind == IO_DELAY:
                ticks += fault.ticks
                self.clock.advance(fault.ticks)
                if ticks > self.retry.deadline_ticks:
                    # the spike blew the per-op deadline: handled as a
                    # retryable error from here on
                    fault = dataclasses.replace(fault, kind=IO_ERROR)
                else:
                    fault = None  # delayed but healthy: proceed below
            if fault is None:
                if fn is not None:
                    fn()
                self.breaker.record(True)
                self._h_ticks.labels().observe(float(ticks))
                return IOResult(ok=True, attempts=attempt + 1, ticks=ticks)
            if fault.kind == PARTIAL_WRITE:
                # the write "succeeds" but the payload is torn; the
                # caller stores the quarantine bit and detection happens
                # on the next read (digest mismatch path)
                if fn is not None:
                    fn()
                self.breaker.record(True)
                self._h_ticks.labels().observe(float(ticks))
                return IOResult(ok=True, attempts=attempt + 1, ticks=ticks,
                                corrupt=True)
            # IO_ERROR (or a deadline-blown delay): retry with backoff
            backoff = self.retry.backoff(attempt)
            attempt += 1
            if attempt > self.retry.max_retries or \
                    ticks + backoff > self.retry.deadline_ticks:
                self._c_error.labels(op).value += 1
                if self.obs.ring.enabled:
                    self.obs.emit(EV_IO_ERROR, a=key, b=attempt)
                self.breaker.record(False)
                self._h_ticks.labels().observe(float(ticks))
                return IOResult(ok=False, attempts=attempt, ticks=ticks)
            ticks += backoff
            self.clock.advance(backoff)
            self._c_retry.value += 1
            if self.obs.ring.enabled:
                self.obs.emit(EV_IO_RETRY, a=attempt, b=backoff)
