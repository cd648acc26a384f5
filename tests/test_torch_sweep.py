"""The port's MRC sweep (``repro_torch.tuning.sweep``) against the
reference's (``repro.tuning.sweep``), exactly, on the CPU.

The grid is the tuning benchmark's (``benchmarks/tuning.py``
``perf_sweep_grid``): capacities at 0.5-50 % of the footprint x four
correlation windows, 32 lanes, over a 20k-request prefix of a SUITE
metadata trace.
"""

import numpy as np
import pytest

from repro.core import traces as jtraces
from repro.tuning import sweep as jsweep
from repro_torch.tuning import sweep as psweep

FRACS = (0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.35, 0.5)
WINDOWS = (0.1, 0.3, 0.5, 1.0)


@pytest.fixture(scope="module")
def meta_prefix():
    spec = jtraces.SUITE[1]  # w02-balanced
    return jtraces.derive_metadata(spec.data())[:20_000]


def _caps(tr):
    fp = jtraces.footprint(tr)
    return [max(8, int(fp * f)) for f in FRACS]


@pytest.mark.parametrize("pad_pow2", [False, True])
def test_sweep_hits_equal_reference(meta_prefix, pad_pow2):
    caps = _caps(meta_prefix)
    got = psweep.sweep_hits(meta_prefix, psweep.make_grid(caps, WINDOWS),
                            pad_pow2=pad_pow2, device="cpu")
    ref = jsweep.sweep_hits(meta_prefix, jsweep.make_grid(caps, WINDOWS),
                            pad_pow2=pad_pow2)
    assert got.shape == (32,) and got.dtype == ref.dtype
    assert np.array_equal(got, ref)


def test_mrc_grid_equals_reference(meta_prefix):
    tr = meta_prefix[:2000]
    caps = _caps(tr)[::2]
    got = psweep.mrc_grid(tr, caps, (0.1, 1.0), small_fracs=(0.1, 0.25),
                          device="cpu")
    ref = jsweep.mrc_grid(tr, caps, (0.1, 1.0), small_fracs=(0.1, 0.25))
    assert got.shape == ref.shape == (4, 2, 2)
    assert np.array_equal(got, ref)


def test_serial_sweep_and_mixed_policy_grid_equal_reference(meta_prefix):
    tr = meta_prefix[:1500]
    grid = [("clock2q+", 40, {}), ("clock2q", 40, {}),
            ("clock2q+", 120, dict(skip_limit=2)), ("clock2q", 9, {})]
    pg = [psweep.get_engine(p).config(c, **kw) for p, c, kw in grid]
    jg = [jsweep.get_engine(p).config(c, **kw) for p, c, kw in grid]
    ref = jsweep.sweep_hits(tr, jg)
    assert np.array_equal(psweep.sweep_hits(tr, pg, device="cpu"), ref)
    assert np.array_equal(psweep.serial_sweep_hits(tr, pg, device="cpu"),
                          ref)


def test_grid_helpers_match_reference():
    caps = [10, 20]
    kw = dict(small_fracs=(0.1, 0.2), ghost_fracs=(0.5,), skip_limit=3)
    assert [vars(c) for c in psweep.make_grid(caps, (0.5, 1.0), **kw)] == \
        [vars(c) for c in jsweep.make_grid(caps, (0.5, 1.0), **kw)]
    assert psweep.surface_shape(8, caps, (0.5, 1.0)) == \
        jsweep.surface_shape(8, caps, (0.5, 1.0))
    raw = np.array([2 ** 40, 7, 2 ** 40, 3, 7], dtype=np.int64)
    got, ref = psweep.relabel(raw), jsweep.relabel(raw)
    assert got[1] == ref[1] and np.array_equal(got[0], ref[0])
    assert got[0].dtype == np.int32
    with pytest.raises(ValueError):
        psweep.sweep_hits(raw, [], device="cpu")
