"""Batched MRC sweeps + online autotuning — the tuning subsystem (the
port of ``repro.tuning``).

  * ``sweep`` — a whole tuning grid (capacities x correlation windows x
    small/ghost fractions x policies) as the lanes of one kernel launch
    per step family, each lane bit-for-bit the one-lane replay at that
    configuration.
  * ``profiler`` — spatially-sampled mini-simulation (hash-sample the
    key space to ~1/64 of the stream, scale capacities by the rate) so
    MRC estimation is cheap enough to run continuously.
  * ``tuner`` — ``OnlineTuner``: periodically re-profiles the recent
    access window and retargets a live ``ProdClock2QPlus`` /
    ``ShardedClock2QPlus`` / ``EngineCache`` through its ``retune``
    runtime setter.
"""

from repro_torch.tuning.sweep import (  # noqa: F401
    SweepConfig, grid_init, lane_hits, make_grid, mrc_grid, relabel,
    serial_sweep_hits, surface_shape, sweep_grid, sweep_hits,
)
from repro_torch.tuning.profiler import (  # noqa: F401
    estimate_mrc, estimate_sweep, estimate_sweep_store,
    estimate_sweep_stream, sample_mask, sample_stream, sample_trace,
)
from repro_torch.tuning.tuner import OnlineTuner, TuneDecision  # noqa: F401
