"""Lane-parallel Clock2Q+ trace replay on the card (``ops.cache_sim``).

The port of the Pallas kernel ``repro/kernels/cache_sim``; ``build`` is
imported only at the first launch."""
