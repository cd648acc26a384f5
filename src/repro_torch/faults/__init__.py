"""Fault injection and recovery, as far as the serving path needs it.

This slice carries only ``plan.splitmix64`` and ``io.Clock``, which the
serving scheduler and its admission queue use; the rest of
``repro.faults`` (``FaultPlan``, ``HostIO``, snapshots, journal,
replicas) comes with the faults slice (ROADMAP.md queue 1, item 7)."""
