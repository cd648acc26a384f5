"""Lane-parallel S3-FIFO trace replay on the card (``ops.s3fifo_sim``).

The reference runs this family's step as a compiled XLA program; the port
runs it as one hand-written kernel launch.  ``build`` is imported only at
the first launch."""
