"""Deterministic hashing behind seeded fault schedules.

A partial copy of ``repro.faults.plan``: only ``splitmix64``, which the
serving admission queue and scheduler use for their seeded tie-breaks.
``FaultPlan``, ``FaultSpec`` and the fault kinds come with the faults
slice (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

_MASK64 = 0xFFFFFFFFFFFFFFFF


def splitmix64(x: int) -> int:
    """One splitmix64 round — the hash behind every fault decision."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)
