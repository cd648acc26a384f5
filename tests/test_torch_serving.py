"""The port's serving stack against the reference, on the CPU.

The reduced ``granite-3-8b`` (fp32) with the reference's params carried
across: the port's ``ServingEngine(device="cpu")`` and
``repro.serving.engine.ServingEngine`` serve the same requests, and the
greedy tokens, ``pool.stats`` (hits, misses, swaps, drops) and the
Clock2Q+ flow counters must be equal.  A token may differ only at a
near tie of the reference's own logits (top-2 margin < 1e-4), which the
test checks; later tokens of that request are then not compared.

Also: the port's ``ProdClock2QPlus`` against the reference's, call for
call, on a seeded stream of accesses with pins and dirty marks, unpins,
io completions, cleans and a live resize.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.prodcache import ProdClock2QPlus as JProd
from repro.models.model import build as j_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.core.prodcache import ProdClock2QPlus as PProd
from repro_torch.models import transformer as PT
from repro_torch.models.model import build
from repro_torch.serving.engine import Request, ServingEngine

NEAR_TIE = 1e-4
CPU = "cpu"


@pytest.fixture(scope="module")
def models():
    """(reference api, reference params, port api, port params)."""
    japi = j_build(j_reduced(j_get_config("granite-3-8b")))
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("granite-3-8b"))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return japi, jparams, build(cfg), PT.params_from_numpy(cfg, tree,
                                                           device=CPU)


def _engines(models, **kw):
    japi, jparams, api, params = models
    return JEngine(japi, jparams, **kw), ServingEngine(api, params,
                                                       device=CPU, **kw)


def _margin(japi, jparams, tokens) -> float:
    """Top-2 margin of the reference's next-token logits after
    ``tokens``."""
    logits, _ = japi.prefill(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)[None]})
    top = np.sort(np.asarray(logits[0, -1], np.float64))[-2:]
    return float(top[1] - top[0])


def _same_tokens(models, prompts, want, got) -> None:
    """Equal greedy tokens per request, near ties of the reference's
    logits excepted (asserted); nothing after a tie is compared."""
    japi, jparams = models[:2]
    assert set(want) == set(got)
    for rid, w in want.items():
        g = got[rid]
        assert len(w) == len(g), rid
        diff = [i for i in range(len(w)) if w[i] != g[i]]
        if diff:
            i = diff[0]
            m = _margin(japi, jparams, list(prompts[rid]) + w[:i])
            assert m < NEAR_TIE, (rid, i, w, g, m)


def _same_pool(jeng, peng) -> None:
    (js, jf), (ps, pf) = jeng.stats, peng.stats
    assert dataclasses.asdict(ps) == dataclasses.asdict(js)
    assert pf == jf


def _serve(jeng, peng, reqs, **run_kw):
    jout = jeng.run([JRequest(**dataclasses.asdict(r)) for r in reqs],
                    **run_kw)
    pout = peng.run(reqs, **run_kw)
    assert [(c.req_id, c.status) for c in pout] == \
        [(c.req_id, c.status) for c in jout]
    return ({c.req_id: c.tokens for c in jout},
            {c.req_id: c.tokens for c in pout})


def test_prefix_sharing_equals_reference(models):
    rng = np.random.default_rng(1)
    prefix = [int(t) for t in rng.integers(0, 512, 32)]   # 4 full blocks
    reqs = [Request(i, prefix + [int(x)], max_new=2)
            for i, x in enumerate(rng.integers(0, 512, 5))]
    jeng, peng = _engines(models, block_size=8, hbm_blocks=32, max_batch=4)
    want, got = _serve(jeng, peng, reqs)
    _same_tokens(models, {r.req_id: r.prompt for r in reqs}, want, got)
    _same_pool(jeng, peng)
    assert peng.stats[0].hits >= 16


def test_eviction_equals_reference(models):
    rng = np.random.default_rng(2)
    reqs = [Request(i, [int(t) for t in rng.integers(0, 512, 24)],
                    max_new=3) for i in range(6)]
    jeng, peng = _engines(models, block_size=8, hbm_blocks=10, max_batch=1)
    want, got = _serve(jeng, peng, reqs)
    _same_tokens(models, {r.req_id: r.prompt for r in reqs}, want, got)
    _same_pool(jeng, peng)
    stats, flows = peng.stats
    assert stats.swap_out > 0 and stats.drops > 0
    snap = peng.obs_snapshot()
    assert snap.counters["serve_requests_total"] == 6
    assert snap.counters['pool_swaps_total{dir="out"}'] == stats.swap_out
    assert sum(v for k, v in snap.counters.items()
               if k.startswith("cache_flow_total")) == sum(flows.values())


def test_swap_in_equals_reference(models):
    # a prefix evicted to the host tier and asked for again comes back
    # by swap-in, not by a refill
    rng = np.random.default_rng(5)
    shared = [int(t) for t in rng.integers(0, 512, 16)]
    reqs = [Request(100 + k, shared + [k], max_new=2) for k in range(2)]
    reqs += [Request(i, [int(t) for t in rng.integers(0, 512, 24)],
                     max_new=2) for i in range(1, 5)]
    reqs += [Request(9, shared + [7], max_new=2)]
    jeng, peng = _engines(models, block_size=8, hbm_blocks=8, max_batch=1)
    want, got = _serve(jeng, peng, reqs)
    _same_tokens(models, {r.req_id: r.prompt for r in reqs}, want, got)
    _same_pool(jeng, peng)
    assert peng.stats[0].swap_in > 0 and peng.stats[0].hits > 0


def test_scheduler_run_equals_reference_and_run_sync(models):
    rng = np.random.default_rng(11)
    reqs = [Request(i, [int(t) for t in rng.integers(0, 512, 20)],
                    max_new=4, priority=i % 2, tenant=f"t{i % 2}")
            for i in range(5)]
    prompts = {r.req_id: r.prompt for r in reqs}
    jeng, peng = _engines(models, block_size=8, hbm_blocks=32, max_batch=2)
    want, got = _serve(jeng, peng, reqs, arrivals=[0, 0, 1, 2, 3], seed=5)
    _same_tokens(models, prompts, want, got)
    _same_pool(jeng, peng)
    _, sync_eng = _engines(models, block_size=8, hbm_blocks=32, max_batch=2)
    sync = {c.req_id: c.tokens for c in sync_eng.run_sync(
        [Request(r.req_id, list(r.prompt), max_new=r.max_new)
         for r in reqs])}
    _same_tokens(models, prompts, want, sync)
    snap = peng.obs_snapshot()
    assert sum(v for k, v in snap.counters.items()
               if k.startswith("sched_admitted_total")) == 5
    assert any(k.startswith("pool_tenant_lookups_total")
               for k in snap.counters)


def test_oversized_prompt_rejected_as_reference(models):
    rng = np.random.default_rng(4)
    big = Request(0, [int(t) for t in rng.integers(0, 512, 200)], max_new=4)
    ok = Request(1, [int(t) for t in rng.integers(0, 512, 16)], max_new=3)
    for mode in ("run", "run_sync"):
        jeng, peng = _engines(models, block_size=8, hbm_blocks=8,
                              max_batch=2)
        reqs = [big, ok]
        jout = {c.req_id: c for c in getattr(jeng, mode)(
            [JRequest(**dataclasses.asdict(r)) for r in reqs])}
        pout = {c.req_id: c for c in getattr(peng, mode)(reqs)}
        assert pout[0].status == "rejected" and pout[0].tokens == []
        assert pout[1].status == jout[1].status == "completed"
        _same_tokens(models, {1: ok.prompt}, {1: jout[1].tokens},
                     {1: pout[1].tokens})
        _same_pool(jeng, peng)


def test_engine_refuses_the_knobs_this_slice_does_not_take(models):
    api, params = models[2:]
    for kw in ({"n_shards": 2}, {"faults": None}, {"replicate": True},
               {"autotune": True}, {"journal_dir": None},
               {"io_retry": None}):
        with pytest.raises(TypeError):
            ServingEngine(api, params, device=CPU, **kw)


def test_prodcache_equals_reference_call_for_call():
    rng = np.random.default_rng(7)
    cap, universe, n = 48, 160, 6000
    kw = dict(track_io=True, window_frac=0.5, max_capacity=96)
    j, p = JProd(cap, **kw), PProd(cap, **kw)
    pins: dict = {}
    pending: list = []
    for i in range(n):
        if i == n // 3:
            j.begin_resize(80), p.begin_resize(80)
        if i == 2 * n // 3:
            j.begin_resize(32), p.begin_resize(32)
        op = rng.random()
        if op < 0.6:
            key = int(rng.integers(0, universe))
            dirty, pin = bool(rng.random() < 0.2), bool(rng.random() < 0.3)
            if sum(pins.values()) >= 8:
                pin = False
            a = j.access(key, dirty=dirty, pin=pin)
            b = p.access(key, dirty=dirty, pin=pin)
            assert dataclasses.asdict(a) == dataclasses.asdict(b), i
            if pin:
                pins[key] = pins.get(key, 0) + 1
            if a.io_pending:
                pending.append(key)
        elif op < 0.72 and pins:
            key = sorted(pins)[int(rng.integers(0, len(pins)))]
            j.unpin(key), p.unpin(key)
            pins[key] -= 1
            if not pins[key]:
                del pins[key]
        elif op < 0.84:
            key = pending.pop(0) if pending else int(rng.integers(0, universe))
            j.io_done(key), p.io_done(key)
        elif op < 0.92:
            key = int(rng.integers(0, universe))
            j.clean(key), p.clean(key)
        else:
            assert j.resize_step(8) == p.resize_step(8), i
        while len(pending) > 8:
            key = pending.pop(0)
            j.io_done(key), p.io_done(key)
        assert j.flows == p.flows, i
    assert (j.hits, j.misses, j.io_waits) == (p.hits, p.misses, p.io_waits)
    assert j.resident_keys() == p.resident_keys()
    assert j.ghost_keys() == p.ghost_keys()
    assert j.dirty_keys() == p.dirty_keys()
    assert j.capacity == p.capacity == 32
