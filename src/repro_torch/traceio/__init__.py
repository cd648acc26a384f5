"""Trace I/O for the port: so far only the dense relabelling the replay
engines need (``formats.relabel``)."""

from repro_torch.traceio.formats import relabel  # noqa: F401
