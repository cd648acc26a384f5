"""Lane-parallel FIFO, Clock and LRU trace replay on the card
(``ops.fifo_sim``, ``ops.clock_sim``, ``ops.lru_sim``).

The reference runs these families' steps as compiled XLA programs; the
port runs each as one hand-written kernel launch.  ``build`` is imported
only at the first launch."""
