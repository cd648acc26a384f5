"""Admission control for the continuous-batching serving scheduler.

This module is the *policy* half of the serving front door, and it is
deliberately JAX-free: the deterministic simulation-test harness
(tests/test_scheduler.py) and the SLO benchmark drive it with a pure
Python executor, so every admit/displace/shed/age decision here must be
a function of (request fields, virtual tick, seed) only.

Pieces:

  * ``SchedRequest`` — the scheduler's view of a request: token counts,
    priority class, absolute-tick SLO deadline, owning tenant, and an
    opaque ``payload`` the executor understands (the engine's ``Request``
    on the real path, anything on the sim path).
  * ``AdmissionConfig`` — the runbook knobs: queue bound, class count,
    tenant weights, anti-starvation aging, backpressure watermarks.
  * ``AdmissionQueue`` — a bounded priority queue with displacement
    (a full queue sheds its lowest-priority tail to admit a stricter
    class, never the other way around), deadline-based shedding (a
    request that can no longer meet its SLO is shed *before* the miss),
    waiting-time aging (sustained overload cannot starve the batch
    class), and deficit-style multi-tenant fair share (among equals,
    the least-served tenant per weight goes first).

Tie-breaks hash ``(seed, req_id)`` through splitmix64, so a schedule is
bit-reproducible per seed — the property the whole test harness of this
PR hangs on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.faults.plan import splitmix64

# priority classes, strongest SLO first.  ``priority`` is an index into
# this tuple: 0 = interactive (tight deadline), 1 = standard, 2 = batch
# (deadline-free backfill).  Configs may use fewer classes; labels for
# out-of-range indices degrade to "p<N>".
CLASS_NAMES: Tuple[str, ...] = ("interactive", "standard", "batch")

# terminal request states — every submitted request ends as exactly one
# of these (the hypothesis suite asserts the trichotomy)
ST_COMPLETED = "completed"
ST_SHED = "shed"
ST_REJECTED = "rejected"

# shed/reject reason codes (the `b` payload of EV_SHED / EV_REJECT)
R_QUEUE_FULL = 1    # bounded queue full of equal-or-better work
R_OVERSIZE = 2      # prompt + decode tail can never fit the pool
R_DEADLINE = 3      # SLO can no longer be met: shed before the miss
R_DISPLACED = 4     # pushed out of a full queue by a stricter class
R_DEGRADED = 5      # backpressure: pool in read-through, lowest class shed

SHED_REASONS: Dict[int, str] = {
    R_QUEUE_FULL: "queue_full",
    R_OVERSIZE: "oversize",
    R_DEADLINE: "deadline",
    R_DISPLACED: "displaced",
    R_DEGRADED: "degraded",
}


def class_label(priority: int) -> str:
    """Stable label for a priority class (metrics / event rendering)."""
    if 0 <= priority < len(CLASS_NAMES):
        return CLASS_NAMES[priority]
    return f"p{priority}"


@dataclasses.dataclass
class SchedRequest:
    """One request as the scheduler sees it.

    ``deadline`` is an *absolute* virtual tick (0 = no SLO).  ``payload``
    is opaque to the scheduler — the executor interprets it (the real
    engine stashes its ``Request`` there; the sim executor needs nothing).
    ``arrival`` is stamped by the scheduler at submit time.
    """

    req_id: int
    prompt_len: int
    max_new: int = 16
    priority: int = 1
    deadline: int = 0
    tenant: str = "default"
    payload: object = None
    arrival: int = 0

    def service_ticks(self) -> int:
        """Ticks from the prefill tick to the completion tick: the
        prefill tick yields the first token, then one decode tick per
        further token — exact, so deadline feasibility is not
        conservative (virtual time makes this arithmetic, not an
        estimate)."""
        return max(0, self.max_new - 1)


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Admission/backpressure knobs (see docs/operations.md "Serving").

    ``queue_bound``     — pending requests the front door will hold.
    ``n_classes``       — priority classes in use (0 is strictest).
    ``tenant_weights``  — fair-share weights; absent tenants weigh 1.0.
    ``age_ticks``       — waiting this long promotes a request one class
                          for *ordering* purposes (anti-starvation); 0
                          disables aging.
    ``low_watermark``   — free-block fraction below which only class-0
                          prefills are admitted (backpressure).
    ``shed_margin``     — extra slack ticks required on top of the
                          service estimate before a deadline is
                          considered met (0 = exact).
    """

    queue_bound: int = 64
    n_classes: int = 3
    tenant_weights: Optional[Dict[str, float]] = None
    age_ticks: int = 64
    low_watermark: float = 0.125
    shed_margin: int = 0

    def weight(self, tenant: str) -> float:
        """Fair-share weight of ``tenant`` (1.0 unless configured)."""
        if self.tenant_weights and tenant in self.tenant_weights:
            return max(1e-9, float(self.tenant_weights[tenant]))
        return 1.0


class AdmissionQueue:
    """Bounded multi-class admission queue with fair-share ordering.

    The queue never reorders storage (one insertion-ordered list); the
    *selection* order is computed per pop from the sort key

        (effective class, served-tokens/weight of tenant, arrival,
         splitmix64(seed ^ req_id))

    so admission is priority-first, then least-served-tenant-first, then
    FIFO, with a seeded deterministic tie-break.  ``served`` charges a
    tenant the full committed cost (prompt + max_new tokens) the moment
    its request is *dispatched*, which is what makes the fairness test's
    band assertion hold under saturating equal demand.
    """

    def __init__(self, config: AdmissionConfig, seed: int = 0):
        self.cfg = config
        self.seed = int(seed)
        self._q: List[SchedRequest] = []
        self.served: Dict[str, float] = {}

    def __len__(self) -> int:
        """Queued requests."""
        return len(self._q)

    def __iter__(self):
        """Iterate the queued requests."""
        return iter(self._q)

    def depth_by_class(self) -> Dict[int, int]:
        """Queued requests per priority class."""
        d: Dict[int, int] = {}
        for r in self._q:
            d[r.priority] = d.get(r.priority, 0) + 1
        return d

    # -- ordering -----------------------------------------------------------
    def effective_class(self, r: SchedRequest, now: int) -> int:
        """Priority class after anti-starvation aging: every
        ``age_ticks`` of waiting promotes one class (ordering only —
        metrics/labels keep the declared class)."""
        if self.cfg.age_ticks <= 0:
            return r.priority
        return max(0, r.priority - (now - r.arrival) // self.cfg.age_ticks)

    def _key(self, r: SchedRequest, now: int):
        return (self.effective_class(r, now),
                self.served.get(r.tenant, 0.0) / self.cfg.weight(r.tenant),
                r.arrival,
                splitmix64(self.seed ^ (r.req_id & 0xFFFFFFFFFFFFFFFF)))

    # -- admission ----------------------------------------------------------
    def offer(self, r: SchedRequest,
              now: int) -> Tuple[bool, int, Optional[SchedRequest]]:
        """Try to enqueue ``r``.  Returns (admitted, reason, displaced):
        a full queue displaces its worst strictly-lower-priority entry
        (returned so the scheduler can record the shed); if none exists
        the offer is rejected with ``R_QUEUE_FULL``."""
        if len(self._q) < self.cfg.queue_bound:
            self._q.append(r)
            return True, 0, None
        worst = None
        for q in self._q:
            if q.priority <= r.priority:
                continue  # equal-or-better work is never displaced
            if worst is None or self._key(q, now) > self._key(worst, now):
                worst = q
        if worst is None:
            return False, R_QUEUE_FULL, None
        self._q.remove(worst)
        self._q.append(r)
        return True, 0, worst

    def shed_expired(self, now: int) -> List[SchedRequest]:
        """Remove every queued request whose SLO can no longer be met
        even if dispatched *this* tick — shed-before-deadline-miss."""
        margin = self.cfg.shed_margin
        expired = [r for r in self._q
                   if r.deadline and now + r.service_ticks() + margin
                   > r.deadline]
        for r in expired:
            self._q.remove(r)
        return expired

    def shed_class(self, priority: int) -> List[SchedRequest]:
        """Remove every queued request of one declared class (degraded-
        mode backpressure sheds the lowest class first)."""
        victims = [r for r in self._q if r.priority == priority]
        for r in victims:
            self._q.remove(r)
        return victims

    def peek_best(self, now: int, *,
                  max_class: Optional[int] = None) -> Optional[SchedRequest]:
        """The next request by selection order, without dequeuing it
        (the scheduler peeks, checks budget/blocks, then ``remove``s);
        ``max_class`` restricts eligibility by *effective* class
        (backpressure admits only the strict classes)."""
        best = None
        for r in self._q:
            if max_class is not None and \
                    self.effective_class(r, now) > max_class:
                continue
            if best is None or self._key(r, now) < self._key(best, now):
                best = r
        return best

    def remove(self, r: SchedRequest) -> None:
        """Dequeue a specific request (after ``peek_best``)."""
        self._q.remove(r)

    def charge(self, r: SchedRequest) -> None:
        """Charge ``r``'s tenant the committed token cost (at dispatch)."""
        self.served[r.tenant] = self.served.get(r.tenant, 0.0) \
            + r.prompt_len + r.max_new
