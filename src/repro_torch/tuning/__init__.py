"""Batched miss-ratio-curve sweeps on the PyTorch engine (``sweep``): a
whole tuning grid as the lanes of one kernel launch per step family."""

from repro_torch.tuning.sweep import (  # noqa: F401
    SweepConfig, grid_init, lane_hits, make_grid, mrc_grid, relabel,
    serial_sweep_hits, surface_shape, sweep_grid, sweep_hits,
)
