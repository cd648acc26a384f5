"""Serving runtime: admission, the continuous-batching scheduler and the engine."""
