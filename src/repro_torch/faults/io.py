"""The virtual clock of host-block IO.

A partial copy of ``repro.faults.io``: only ``Clock``, the tick clock
the serving scheduler runs on.  ``HostIO``, ``RetryPolicy`` and the
circuit breaker come with the faults slice (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations


class Clock:
    """Virtual monotonic clock: integer ticks, advanced explicitly.

    One tick is "one backoff quantum" — wall-clock-free so fault replays
    are deterministic and tests never sleep."""

    def __init__(self):
        self.now = 0

    def advance(self, ticks: int) -> None:
        """Advance time by ``ticks`` (the virtual sleep)."""
        self.now += int(ticks)
