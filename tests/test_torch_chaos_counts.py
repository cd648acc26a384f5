"""The KV pool's counts under ``chip_smoke.py``'s chaos phases, on the CPU.

The pool's key stream depends only on the prompts' tokens and the
requests' lengths: full blocks are keyed by a hash of their prompt
tokens, decode tails by handles.  So ``granite-3-8b`` at its full
vocabulary but the reduced width (64) and depth replays here the pool
lookups, host IO operations, injected faults, failovers, tuner rounds
and journal bytes of ``serve_main``, ``chaos_path`` and
``chaos_consistency``, driven with the script's own requests and knobs.
The expected counts are those the script printed on an NVIDIA H100 80GB
HBM3 (700 W) at full width; the tuner's estimates, which the script
holds to the plain sweep on the CPU, are the plain sweep's.  Model
outputs differ at this width, so only the chaos engine's tokens against
its fault-free twin's are compared, as the script does.
"""

import dataclasses
import importlib.util
import pathlib

import pytest
import torch

from repro_torch import faults as F
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import build
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import SchedConfig

CPU = torch.device("cpu")
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    """``chip_smoke.py`` as a module (its requests, knobs and checks)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model(n_layers):
    full = get_config("granite-3-8b")
    cfg = dataclasses.replace(reduced(full), vocab=full.vocab,
                              n_layers=n_layers)
    api = build(cfg)
    return api, api.init(torch.Generator().manual_seed(0), CPU)


def _stats(pool):
    return dataclasses.asdict(pool.stats)


def _watch(pool):
    """Record (kind, result) of each failover of ``pool``."""
    seen, failover = [], pool.failover_shard

    def call(sid):
        rep = pool._replicator
        kind = "promote" if rep is not None and rep.should_promote(sid) \
            else "rewarm"
        out = failover(sid)
        seen.append((sid, kind, tuple(out)))
        return out
    pool.failover_shard = call
    return seen


def _run(cs, api, params, reqs, serve, knobs):
    eng = ServingEngine(api, params, device=CPU, **serve, **knobs)
    seen = _watch(eng.pool) if knobs.get("faults") is not None else None
    outs = eng.run(reqs, config=SchedConfig(max_batch=serve["max_batch"],
                                            token_budget=cs.TOKEN_BUDGET))
    assert all(c.status == "completed" and len(c.tokens) == cs.MAX_NEW
               for c in outs)
    return eng, {c.req_id: c.tokens for c in outs}, seen


def test_serve_main_and_chaos_path_counts(cs, tmp_path):
    api, params = _model(2)
    reqs = cs.make_requests(32, seed=0, vocab=api.cfg.vocab)
    lookups = cs.planned_lookups(reqs, cs.SERVE["block_size"])
    eng, _, _ = _run(cs, api, params, reqs, cs.SERVE, {})
    st = eng.pool.stats
    assert st.hits + st.misses == lookups == 3227
    assert (st.swap_in, st.swap_out) == (64, 1435)
    k = (st.swap_in + st.swap_out) // 2
    assert k == 749
    del eng

    jdir = str(tmp_path / "journal")
    knobs = cs.chaos_knobs(F, k, lookups, jdir)
    eng, _, seen = _run(cs, api, params, reqs, cs.SERVE, knobs)
    pool = eng.pool
    assert _stats(pool) == dict(hits=1738, misses=1489, swap_in=52,
                                swap_out=1437, drops=755)
    assert (pool._io.plan.injected, pool._io.plan.op_seq,
            pool._io.clock.now) == (576, 1846, 1265)
    assert (len(pool.host), len(pool._corrupt)) == (1435, 69)
    assert seen == [(1, "promote", (162, 5))]
    assert [d.at_access for d in pool.tuner.decisions] == [806, 1612, 2418,
                                                           3224]
    assert not any(d.applied for d in pool.tuner.decisions)
    mrc = eng.cache_mrc(rate_shift=cs.CHAOS_MRC_SHIFT)
    assert mrc == pytest.approx({512: 0.55119825708061,
                                 1024: 0.5163398692810457,
                                 2048: 0.49455337690631807}, abs=1e-12)
    keys = pool.tuner.recent()               # history == every lookup
    assert keys.size == lookups
    checked = cs.tuner_checks(pool.tuner, keys, "chaos_path", mrc=mrc,
                              mrc_shift=cs.CHAOS_MRC_SHIFT)
    assert [e["est_miss_ratios"][0] < 1.0
            for e in checked["tuner_estimates"]] == [True] * 4
    out = cs.chaos_checks(F, pool, jdir, "chaos_path")
    assert out["journal_bytes"] == 515749
    assert [r["lsn"] for r in out["recovered"]] == [2696, 1431, 2762, 2526]


def test_chaos_consistency_counts(cs, tmp_path):
    api, params = _model(cs.CONSISTENCY_LAYERS)
    reqs = cs.make_requests(8, seed=1, vocab=api.cfg.vocab)
    serve = dict(cs.SERVE, hbm_blocks=cs.CHAOS_HBM)
    lookups = cs.planned_lookups(reqs, serve["block_size"])
    assert lookups == 806
    twin_knobs = dict(cs.chaos_knobs(F, 0, lookups, None), faults=None,
                      io_retry=None, replicate=False)
    twin, twin_out, _ = _run(cs, api, params, reqs, serve, twin_knobs)
    assert _stats(twin.pool) == dict(hits=165, misses=641, swap_in=91,
                                     swap_out=512, drops=144)
    k = (twin.pool.stats.swap_in + twin.pool.stats.swap_out) // 2
    assert k == 301
    del twin

    jdir = str(tmp_path / "journal")
    eng, out, seen = _run(cs, api, params, reqs, serve,
                          cs.chaos_knobs(F, k, lookups, jdir))
    assert _stats(eng.pool) == dict(hits=165, misses=641, swap_in=89,
                                    swap_out=509, drops=143)
    assert eng.pool._io.plan.injected == 220
    assert seen == [(1, "promote", (75, 1))]
    assert out == twin_out
    assert cs.chaos_checks(F, eng.pool, jdir,
                           "chaos_consistency")["journal_bytes"] == 204915
    del eng

    # chip_smoke's chaos_rewarm: no standby, a ghost journal every 64
    # lookups, so the loss rebuilds shard 1 by the ghost rewarm
    knobs = dict(cs.chaos_knobs(F, k, lookups, None), replicate=False)
    eng = ServingEngine(api, params, device=CPU, **serve, **knobs)
    eng.pool.journal_every = cs.CHAOS_GHOST_EVERY
    seen = _watch(eng.pool)
    eng.run(reqs, config=SchedConfig(max_batch=serve["max_batch"],
                                     token_budget=cs.TOKEN_BUDGET))
    assert seen == [(1, "rewarm", (72, 17))]
    assert _stats(eng.pool) == dict(hits=179, misses=627, swap_in=75,
                                    swap_out=509, drops=129)
