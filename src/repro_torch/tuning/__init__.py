"""Batched miss-ratio-curve sweeps on the PyTorch engine (``sweep``): a
whole tuning grid as the lanes of one ``cache_sim`` launch."""

from repro_torch.tuning.sweep import (  # noqa: F401
    SweepConfig, grid_init, make_grid, mrc_grid, relabel,
    serial_sweep_hits, surface_shape, sweep_grid, sweep_hits,
)
