"""Continuous-batching serving scheduler on a virtual integer-tick clock.

The scheduler closes the gap between the paper's claim (Clock2Q+ keeps
the hit path cheap enough to sit under a high-throughput serving stack)
and the engine's old single synchronous ``run(requests)`` loop: it adds
the front door a real serving system needs — bounded admission, priority
classes, per-request SLO deadlines with shed-before-miss, token-budgeted
batch formation (prefill/decode interleaving), multi-tenant fair share,
and backpressure tied to the KV pool's free-block watermark and the
faults layer's ``degraded`` flag.

Time is the ``repro.faults.io.Clock``: one tick = one batched decode
step.  Nothing here reads a wall clock or an unseeded RNG, so for a
fixed (requests, arrivals, seed, executor) the full decision stream —
``schedule_log`` and the EV_ADMIT/EV_SHED/EV_BATCH event ring — is
bit-identical across runs.  That property is what the deterministic
simulation-test harness (tests/test_scheduler.py) and the
``fig_sched_slo`` benchmark pin.

The scheduler drives an *executor* — anything with the small duck-typed
surface below — so the same decision code runs the real JAX engine
(``repro.serving.engine.EngineExecutor``) and the model-free
``SimExecutor`` the tests and SLO benchmark use:

    n_blocks, block_size      # capacity surface (oversize rejection)
    free_fraction() -> float  # evictable-block fraction (backpressure)
    degraded -> bool          # faults breaker open (read-through mode)
    prefill(req) -> int       # admit + prefill; returns the first token
    decode(ids) -> {id: tok}  # one batched decode step
    release(req_id)           # sequence finished; free its blocks
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import obs as obs_mod
from repro_torch.faults.io import Clock
from repro_torch.faults.plan import splitmix64
from repro_torch.serving.admission import (
    R_DEADLINE, R_DEGRADED, R_DISPLACED, R_OVERSIZE, ST_COMPLETED,
    ST_REJECTED, ST_SHED, AdmissionConfig, AdmissionQueue, SchedRequest,
    class_label,
)


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    """Scheduler knobs on top of the admission policy.

    ``token_budget`` — tokens one tick may commit (decode = 1/sequence,
    prefill = the full prompt).  Decodes are never throttled (an active
    sequence always advances — the no-starvation half of the SLO story);
    the budget gates how much *prefill* work may pile into one tick.  A
    prompt longer than the whole budget is still admitted when the tick
    is otherwise empty, so oversized-but-feasible prompts cannot
    livelock.
    ``max_batch`` — concurrent sequences (decode slots).
    """

    token_budget: int = 512
    max_batch: int = 8
    admission: AdmissionConfig = dataclasses.field(
        default_factory=AdmissionConfig)


@dataclasses.dataclass
class Outcome:
    """Terminal record for one submitted request (exactly one per
    request: completed, shed, or rejected)."""

    req_id: int
    status: str
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish: int = 0        # tick the terminal state was reached
    reason: int = 0        # shed/reject reason code (admission.SHED_REASONS)
    tenant: str = "default"
    priority: int = 1


class Scheduler:
    """Token-budgeted continuous batching with admission control."""

    def __init__(self, executor, *, config: Optional[SchedConfig] = None,
                 clock: Optional[Clock] = None, seed: int = 0, obs=None):
        self.x = executor
        self.cfg = config or SchedConfig()
        self.clock = Clock() if clock is None else clock
        self.seed = int(seed)
        self.queue = AdmissionQueue(self.cfg.admission, seed=seed)
        self.active: Dict[int, SchedRequest] = {}
        self.tokens: Dict[int, List[int]] = {}
        self.outcomes: Dict[int, Outcome] = {}
        self.order: List[int] = []  # req_ids in termination order
        # the full decision stream — the bit-reproducibility fixture
        self.schedule_log: List[Tuple] = []
        self.obs = obs_mod.NullSink(src="sched") if obs is None else obs
        self._c_admit = self.obs.counter(
            "sched_admitted_total", ("tenant", "class"),
            "requests admitted to the bounded queue")
        self._c_reject = self.obs.counter(
            "sched_rejected_total", ("tenant", "class", "reason"),
            "requests refused at the front door")
        self._c_shed = self.obs.counter(
            "sched_shed_total", ("tenant", "class", "reason"),
            "queued requests shed (deadline / displaced / degraded)")
        self._c_done = self.obs.counter(
            "sched_completed_total", ("tenant", "class"),
            "requests that ran to completion")
        self._c_batch = self.obs.counter(
            "sched_batches_total", (), "scheduler ticks that dispatched "
            "work").labels()
        self._c_tok = self.obs.counter(
            "sched_tokens_total", ("kind",),
            "tokens committed to batches, prefill vs decode")
        depth = self.obs.gauge("sched_queue_depth", ("class",),
                               "queued requests per priority class")
        self._g_depth = [depth.labels(class_label(p))
                         for p in range(self.cfg.admission.n_classes)]
        self._g_occ = self.obs.gauge(
            "sched_batch_occupancy", (),
            "active sequences / max_batch").labels()
        self._g_free = self.obs.gauge(
            "sched_free_frac", (), "executor free-block fraction seen at "
            "the last tick").labels()
        self._h_wait = self.obs.histogram(
            "sched_wait_ticks", (), "queue wait (submit -> prefill), "
            "virtual ticks", base=1.0, n_buckets=16).labels()

    # -- bookkeeping ----------------------------------------------------------
    def _terminal(self, r: SchedRequest, status: str, reason: int = 0,
                  toks: Optional[List[int]] = None) -> Outcome:
        out = Outcome(r.req_id, status, toks if toks is not None else [],
                      finish=self.clock.now, reason=reason,
                      tenant=r.tenant, priority=r.priority)
        self.outcomes[r.req_id] = out
        self.order.append(r.req_id)
        return out

    def _shed(self, r: SchedRequest, reason: int) -> None:
        self._c_shed.labels(r.tenant, class_label(r.priority),
                            str(reason)).value += 1
        if self.obs.ring.enabled:
            self.obs.emit(obs_mod.EV_SHED, shard=self.clock.now,
                          a=r.req_id, b=reason)
        self.schedule_log.append(("shed", self.clock.now, r.req_id, reason))
        self._terminal(r, ST_SHED, reason)

    # -- admission (the front door) -------------------------------------------
    def submit(self, r: SchedRequest) -> bool:
        """Offer one request.  Stamps the arrival tick; returns True if
        it entered the queue (it may still be shed later), False if it
        was rejected outright (queue full of equal-or-better work, or
        the prompt + decode tail can never fit the pool)."""
        now = self.clock.now
        r.arrival = now
        bs = getattr(self.x, "block_size", 0)
        if bs and -(-(r.prompt_len + r.max_new) // bs) > self.x.n_blocks:
            return self._reject(r, R_OVERSIZE)
        admitted, reason, displaced = self.queue.offer(r, now)
        if not admitted:
            return self._reject(r, reason)
        if displaced is not None:
            self._shed(displaced, R_DISPLACED)
        self._c_admit.labels(r.tenant, class_label(r.priority)).value += 1
        if self.obs.ring.enabled:
            self.obs.emit(obs_mod.EV_ADMIT, shard=now, a=r.req_id,
                          b=r.priority)
        self.schedule_log.append(("admit", now, r.req_id))
        return True

    def _reject(self, r: SchedRequest, reason: int) -> bool:
        self._c_reject.labels(r.tenant, class_label(r.priority),
                              str(reason)).value += 1
        if self.obs.ring.enabled:
            self.obs.emit(obs_mod.EV_REJECT, shard=self.clock.now,
                          a=r.req_id, b=reason)
        self.schedule_log.append(("reject", self.clock.now, r.req_id,
                                  reason))
        self._terminal(r, ST_REJECTED, reason)
        return False

    # -- one scheduling round -------------------------------------------------
    def tick(self) -> int:
        """One virtual tick: shed expired SLOs, apply backpressure, form
        a token-budgeted batch (prefills + one decode step for the
        previously-active sequences), dispatch it, advance the clock.
        Returns the number of sequences that completed this tick."""
        now = self.clock.now
        adm = self.cfg.admission
        # 1. SLO shedding: anything that cannot finish in time anymore
        #    is shed now, before it burns batch slots and misses anyway
        for r in self.queue.shed_expired(now):
            self._shed(r, R_DEADLINE)
        # 2. backpressure: degraded mode sheds the lowest class outright
        #    and narrows admission to class 0; a low free-block watermark
        #    narrows admission without shedding
        degraded = bool(self.x.degraded)
        if degraded and adm.n_classes > 1:
            for r in self.queue.shed_class(adm.n_classes - 1):
                self._shed(r, R_DEGRADED)
        free = float(self.x.free_fraction())
        max_class = 0 if (degraded or free < adm.low_watermark) else None
        # 3. batch formation under the token budget: decodes first (one
        #    token per active sequence, never throttled), then prefills
        #    from the queue while budget, decode slots, and blocks last
        budget = self.cfg.token_budget - len(self.active)
        decode_ids = sorted(self.active)
        n_blocks = max(1, getattr(self.x, "n_blocks", 1))
        bs = getattr(self.x, "block_size", 0)
        free_est = free
        prefills: List[SchedRequest] = []
        while len(self.active) + len(prefills) < self.cfg.max_batch:
            r = self.queue.peek_best(now, max_class=max_class)
            if r is None:
                break
            if r.prompt_len > budget and (prefills or decode_ids):
                break  # interleave: leftover prefill work waits a tick
            need = -(-(r.prompt_len + r.max_new) // bs) / n_blocks \
                if bs else 0.0
            if free_est - need < adm.low_watermark and \
                    (prefills or decode_ids):
                break  # block watermark: don't over-pin the pool
            self.queue.remove(r)
            self.queue.charge(r)
            prefills.append(r)
            budget -= r.prompt_len
            free_est -= need
        # 4. dispatch
        done = 0
        for r in prefills:
            self._h_wait.observe(float(now - r.arrival))
            self.schedule_log.append(("start", now, r.req_id))
            first = self.x.prefill(r)
            self.tokens[r.req_id] = [int(first)]
            if r.max_new <= 1:
                done += self._complete(r)
            else:
                self.active[r.req_id] = r
        if decode_ids:
            out = self.x.decode(decode_ids)
            for rid in decode_ids:
                self.tokens[rid].append(int(out[rid]))
                r = self.active[rid]
                if len(self.tokens[rid]) >= r.max_new:
                    del self.active[rid]
                    done += self._complete(r)
        if prefills or decode_ids:
            self._c_batch.value += 1
            used = sum(r.prompt_len for r in prefills) + len(decode_ids)
            self._c_tok.labels("prefill").value += \
                sum(r.prompt_len for r in prefills)
            self._c_tok.labels("decode").value += len(decode_ids)
            if self.obs.ring.enabled:
                self.obs.emit(obs_mod.EV_BATCH, shard=now, a=len(prefills),
                              b=len(decode_ids), c=float(used))
            self.schedule_log.append(("batch", now, len(prefills),
                                      len(decode_ids), used))
        # 5. gauges + clock
        depth = self.queue.depth_by_class()
        for p, g in enumerate(self._g_depth):
            g.set(float(depth.get(p, 0)))
        self._g_occ.set(len(self.active) / max(1, self.cfg.max_batch))
        self._g_free.set(free)
        self.clock.advance(1)
        return done

    def _complete(self, r: SchedRequest) -> int:
        self.x.release(r.req_id)
        self._c_done.labels(r.tenant, class_label(r.priority)).value += 1
        self.schedule_log.append(("done", self.clock.now, r.req_id))
        self._terminal(r, ST_COMPLETED, toks=self.tokens.pop(r.req_id))
        return 1

    # -- whole-trace loop -----------------------------------------------------
    def run(self, requests: Sequence[SchedRequest],
            arrivals: Optional[Sequence[int]] = None,
            max_idle_ticks: int = 10_000) -> List[Outcome]:
        """Replay a request stream to completion.  ``arrivals[i]`` is the
        absolute tick request i is submitted at (omitted = everything
        arrives at the current tick); requests sharing a tick are
        submitted in input order.  Returns outcomes in termination
        order.  ``max_idle_ticks`` guards the loop against a
        configuration that can never drain (e.g. aging disabled while
        permanently degraded)."""
        if arrivals is None:
            arrivals = [self.clock.now] * len(requests)
        if len(arrivals) != len(requests):
            raise ValueError("arrivals and requests length mismatch")
        pending = sorted(range(len(requests)),
                         key=lambda i: (int(arrivals[i]), i))
        pos, idle = 0, 0
        while pos < len(pending) or self.queue or self.active:
            while pos < len(pending) and \
                    int(arrivals[pending[pos]]) <= self.clock.now:
                self.submit(requests[pending[pos]])
                pos += 1
            before = len(self.order)
            self.tick()
            idle = idle + 1 if len(self.order) == before else 0
            if idle > max_idle_ticks:
                raise RuntimeError(
                    f"scheduler made no progress for {max_idle_ticks} "
                    f"ticks (queue={len(self.queue)}, "
                    f"active={len(self.active)})")
        return [self.outcomes[rid] for rid in self.order]


class SimExecutor:
    """Deterministic model-free executor for the simulation harness.

    Tokens are a pure hash of (req_id, position) — two runs, or the
    scheduler vs the synchronous reference below, produce identical
    "greedy" tokens for a request no matter how it was batched, which is
    exactly the property the real engine has (greedy decoding depends
    only on the sequence's own KV).  Block accounting mirrors the paged
    pool: a sequence reserves ceil((prompt+max_new)/block_size) blocks
    from prefill to release.  ``degraded`` is a plain attribute the
    chaos tests flip (or a ``degraded_ticks`` range drives from the
    clock).
    """

    def __init__(self, n_blocks: int = 256, block_size: int = 16,
                 vocab: int = 50_000, clock: Optional[Clock] = None,
                 degraded_ticks: Optional[range] = None):
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.vocab = vocab
        self.clock = clock
        self.degraded_ticks = degraded_ticks
        self._degraded = False
        self.used = 0
        self._blocks: Dict[int, int] = {}
        self._counts: Dict[int, int] = {}
        self.prefills = 0
        self.decode_steps = 0

    @property
    def degraded(self) -> bool:
        """The simulated faults breaker flag."""
        if self.degraded_ticks is not None and self.clock is not None:
            return self.clock.now in self.degraded_ticks
        return self._degraded

    @degraded.setter
    def degraded(self, v: bool) -> None:
        """The simulated faults breaker flag."""
        self._degraded = bool(v)

    def free_fraction(self) -> float:
        """Fraction of the simulated block budget not pinned."""
        return 1.0 - self.used / max(1, self.n_blocks)

    def token(self, req_id: int, i: int) -> int:
        """The deterministic token ``i`` of request ``req_id``."""
        return splitmix64(req_id * 0x9E3779B1 + i) % self.vocab

    def prefill(self, r: SchedRequest) -> int:
        """Admit and prefill ``r``; returns its first token."""
        nb = -(-(r.prompt_len + r.max_new) // self.block_size)
        self._blocks[r.req_id] = nb
        self._counts[r.req_id] = 1
        self.used += nb
        self.prefills += 1
        return self.token(r.req_id, 0)

    def decode(self, ids: List[int]) -> Dict[int, int]:
        """One decode step for ``ids``; returns {req_id: token}."""
        self.decode_steps += 1
        out = {}
        for rid in ids:
            i = self._counts[rid]
            self._counts[rid] = i + 1
            out[rid] = self.token(rid, i)
        return out

    def release(self, req_id: int) -> None:
        """Release a finished sequence's blocks."""
        self.used -= self._blocks.pop(req_id)
        self._counts.pop(req_id, None)


def simulate_sync(requests: Sequence[SchedRequest],
                  arrivals: Sequence[int], *, max_batch: int = 8,
                  executor: Optional[SimExecutor] = None) -> Dict[int, int]:
    """Tick-level model of the OLD synchronous ``ServingEngine.run``
    loop: FIFO admission up to ``max_batch``, no priorities, no
    deadlines, no shedding — the baseline ``fig_sched_slo`` compares
    the scheduler against.  Returns {req_id: completion tick}."""
    x = executor or SimExecutor(n_blocks=1 << 30, block_size=16)
    order = sorted(range(len(requests)),
                   key=lambda i: (int(arrivals[i]), i))
    finish: Dict[int, int] = {}
    pending: List[SchedRequest] = []
    active: Dict[int, SchedRequest] = {}
    produced: Dict[int, int] = {}
    now, pos = 0, 0
    while pos < len(order) or pending or active:
        while pos < len(order) and int(arrivals[order[pos]]) <= now:
            pending.append(requests[order[pos]])
            pos += 1
        decode_ids = sorted(active)
        while pending and len(active) < max_batch:
            r = pending.pop(0)  # FIFO: head-of-line blocking and all
            x.prefill(r)
            produced[r.req_id] = 1
            if r.max_new <= 1:
                finish[r.req_id] = now
                x.release(r.req_id)
            else:
                active[r.req_id] = r
        for rid in decode_ids:
            produced[rid] += 1
            if produced[rid] >= active[rid].max_new:
                finish[rid] = now
                x.release(rid)
                del active[rid]
        now += 1
    return finish
