"""Trace-format helpers the port needs: its own copy of ``relabel`` from
``repro/traceio/formats.py``."""

from __future__ import annotations

import numpy as np


def relabel(trace: np.ndarray) -> "tuple[np.ndarray, int]":
    """Dense relabelling: raw (possibly hashed 64-bit) keys ->
    ``[0, n_unique)`` int32 ids, preserving request order.  Replacement
    is label-invariant, so miss ratios are unchanged; the dense-table
    replay engines require it."""
    uniq, inv = np.unique(np.asarray(trace), return_inverse=True)
    return inv.astype(np.int32), int(uniq.size)
