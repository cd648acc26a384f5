"""Deterministic seeded fault schedules (``FaultPlan``).

The port's own copy of ``repro/faults/plan.py``: the same kinds, op
streams and splitmix64 decisions, so one seed and one spec list give
the same ``next_op`` sequence in both packages.

A plan is the *injection* half of the fault subsystem: a pure function
from (operation sequence number, op kind, key) to "which fault, if any,
fires here".  Determinism is the load-bearing property — a chaos run is
only debuggable if the same seed replays the same faults at the same
operations, bit for bit — so decisions come from a splitmix64 hash of
``(seed, op_seq)``, never from stateful RNG draws whose order could
drift with unrelated code motion.

Two trigger styles compose in one plan:

  * probabilistic — ``FaultSpec(kind, ops, prob=p)``: each matching
    operation independently faults with probability ``p`` (hash-derived
    uniform, so the decision stream is a pure function of the seed and
    the op sequence);
  * scheduled — ``FaultSpec(kind, ops, at=(100, 2048))``: fires exactly
    at those op sequence numbers (shard-loss drills, reproducing a
    specific incident).

``NullPlan`` is the production default: ``enabled`` is False and
``check`` always returns None, so the instrumented swap path costs one
attribute test per operation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# fault kinds (int codes; also the `a` payload of EV_FAULT events)
IO_ERROR = 1        # the host-block IO fails (retryable)
IO_DELAY = 2        # latency spike: the op stalls for `ticks`
PARTIAL_WRITE = 3   # swap-out persists a torn block (detected on read)
SHARD_LOSS = 4      # a whole shard's state vanishes (process/node death)
CRASH = 5           # the process dies mid-write (journal crash-point
                    # fuzzing: `ticks` is reused as the byte offset into
                    # the record that made it to disk before the kill)

FAULT_NAMES = {
    IO_ERROR: "io_error",
    IO_DELAY: "io_delay",
    PARTIAL_WRITE: "partial_write",
    SHARD_LOSS: "shard_loss",
    CRASH: "crash",
}

# op kinds a spec can target (the pool's host-block IO surface, plus the
# journal's append stream for CRASH_AT crash-point specs)
OP_SWAP_IN = "swap_in"
OP_SWAP_OUT = "swap_out"
OP_JOURNAL_APPEND = "journal_append"
OP_ANY = "*"

_MASK64 = 0xFFFFFFFFFFFFFFFF


def splitmix64(x: int) -> int:
    """One splitmix64 round — the hash behind every fault decision."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _uniform(seed: int, op_seq: int, salt: int) -> float:
    """Deterministic uniform in [0, 1) for one (plan, op, spec) triple."""
    h = splitmix64((seed ^ (salt * 0xD1B54A32D192ED03)) & _MASK64)
    return splitmix64((h ^ op_seq) & _MASK64) / float(1 << 64)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault source inside a plan.

    ``kind``   — IO_ERROR / IO_DELAY / PARTIAL_WRITE / SHARD_LOSS.
    ``ops``    — which operation kinds it targets (OP_ANY = all).
    ``prob``   — per-matching-op firing probability (hash-derived).
    ``at``     — exact op sequence numbers that fire (overrides prob).
    ``ticks``  — stall length for IO_DELAY (virtual clock ticks).
    ``shard``  — target shard for SHARD_LOSS (-1 = hash-picked).
    """

    kind: int
    ops: Tuple[str, ...] = (OP_ANY,)
    prob: float = 0.0
    at: Tuple[int, ...] = ()
    ticks: int = 1
    shard: int = -1

    def __post_init__(self):
        if self.kind not in FAULT_NAMES:
            raise ValueError(f"unknown fault kind {self.kind}")
        if not (0.0 <= self.prob <= 1.0):
            raise ValueError(f"prob {self.prob} not in [0, 1]")


@dataclasses.dataclass(frozen=True)
class Fault:
    """A fault decision for one concrete operation (what ``check`` returns)."""

    kind: int
    op_seq: int
    spec_index: int
    ticks: int = 0
    shard: int = -1

    @property
    def name(self) -> str:
        """Human-readable kind name (event/report rendering)."""
        return FAULT_NAMES[self.kind]


class FaultPlan:
    """Seeded deterministic fault schedule over an operation stream.

    The plan owns the operation sequence counter: callers route every
    host-block IO through ``next_op(op, key)`` and act on the returned
    ``Fault`` (or None).  Two plans with the same seed and specs served
    the same op sequence return the same decisions — the chaos suite
    asserts this bit-for-bit.
    """

    enabled = True

    def __init__(self, seed: int, specs: Sequence[FaultSpec] = ()):
        self.seed = int(seed) & _MASK64
        self.specs = tuple(specs)
        self.op_seq = 0  # ops examined so far == next sequence number
        self.injected = 0

    def _match(self, spec: FaultSpec, op: str, op_seq: int,
               idx: int) -> bool:
        if OP_ANY not in spec.ops and op not in spec.ops:
            return False
        if spec.at:
            return op_seq in spec.at
        return spec.prob > 0.0 and \
            _uniform(self.seed, op_seq, idx) < spec.prob

    def check(self, op: str, op_seq: int) -> Optional[Fault]:
        """Pure decision for a given (op kind, sequence number) — does
        NOT advance the counter (replay/inspection path).  First
        matching spec wins, in declaration order."""
        for idx, spec in enumerate(self.specs):
            if self._match(spec, op, op_seq, idx):
                return Fault(kind=spec.kind, op_seq=op_seq, spec_index=idx,
                             ticks=spec.ticks, shard=spec.shard)
        return None

    def next_op(self, op: str) -> Optional[Fault]:
        """Consume one operation slot and return its fault decision."""
        f = self.check(op, self.op_seq)
        self.op_seq += 1
        if f is not None:
            self.injected += 1
        return f

    def schedule(self, op: str, n_ops: int) -> list:
        """The full decision sequence for ``n_ops`` hypothetical ops of
        one kind, without consuming the counter — the chaos suite uses
        this to assert per-seed determinism directly."""
        return [self.check(op, i) for i in range(n_ops)]


class NullPlan(FaultPlan):
    """No faults, ever — the production default for the instrumented
    swap path.  ``enabled`` lets hot paths skip decision work entirely;
    ``next_op`` still advances the op counter so swapping a real plan in
    mid-run keeps sequence numbers meaningful."""

    enabled = False

    def __init__(self):
        super().__init__(seed=0, specs=())

    def check(self, op: str, op_seq: int) -> Optional[Fault]:
        """Always None (no specs can match)."""
        return None

    def next_op(self, op: str) -> Optional[Fault]:
        """Advance the op counter; never faults."""
        self.op_seq += 1
        return None
