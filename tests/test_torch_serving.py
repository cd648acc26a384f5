"""The port's serving stack against the reference, on the CPU.

The reduced ``granite-3-8b`` (fp32) with the reference's params carried
across: the port's ``ServingEngine(device="cpu")`` and
``repro.serving.engine.ServingEngine`` serve the same requests, and the
greedy tokens, ``pool.stats`` (hits, misses, swaps, drops) and the
Clock2Q+ flow counters must be equal.  So must the reduced moe
``olmoe-1b-7b`` and vlm ``llava-next-mistral-7b``, and the moe decode
batch padded as the reference pads it.  A token may differ only at a
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
from repro_torch.models.model import build, params_from_numpy
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
    return japi, jparams, build(cfg), params_from_numpy(cfg, tree,
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


def _family_models(arch: str, **kw):
    """``models`` of the reduced ``arch`` with config fields ``kw``."""
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), **kw)
    japi = j_build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return japi, jparams, build(cfg), params_from_numpy(cfg, tree,
                                                        device=CPU)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llava-next-mistral-7b"])
def test_family_engine_equals_reference(arch):
    """Prefix sharing, eviction to the host tier and batches of 1-4 rows
    (the moe decode is dropless at max_batch 4: capacity 4, top-2 of 8
    experts; its prefill drops at capacity in both packages alike)."""
    models = _family_models(arch)
    rng = np.random.default_rng(6)
    prefix = [int(t) for t in rng.integers(0, 512, 16)]
    reqs = [Request(i, prefix + [int(t) for t in rng.integers(
        0, 512, int(rng.integers(1, 10)))], max_new=4) for i in range(5)]
    reqs += [Request(5, [int(t) for t in rng.integers(0, 512, 27)],
                     max_new=3)]
    jeng, peng = _engines(models, block_size=8, hbm_blocks=14, max_batch=4)
    want, got = _serve(jeng, peng, reqs)
    _same_tokens(models, {r.req_id: r.prompt for r in reqs}, want, got)
    _same_pool(jeng, peng)
    stats = peng.stats[0]
    assert stats.hits > 0 and stats.swap_out > 0


def test_moe_decode_batch_padded_as_reference():
    """6 requests with one prompt at max_batch 16, on the reduced olmoe
    with 16 experts and top-2: every row routes alike, so the decode
    capacity binds.  Padded to 16 rows (the reference's T) it is 8 and
    keeps the 6 real rows; unpadded it would be 4 and drop rows 4 and 5.
    Requests 0-4 equal the reference's.  Request 5's KV slot is also the
    10 padded rows', of which rows 8-15 lose their experts: the
    reference's scatter lets the last of them overwrite row 5's k/v, so
    its request 5 leaves its siblings' tokens; the port writes the real
    row's k/v and all 6 requests agree (ROADMAP.md queue 3)."""
    models = _family_models("olmoe-1b-7b", n_experts=16)
    prompt = [int(t) for t in np.random.default_rng(5).integers(0, 512, 13)]
    reqs = [Request(i, list(prompt), max_new=6) for i in range(6)]
    jeng, peng = _engines(models, block_size=8, hbm_blocks=64, max_batch=16)
    want, got = _serve(jeng, peng, reqs)
    _same_pool(jeng, peng)
    for rid in range(5):
        assert got[rid] == want[rid], rid
    assert all(got[rid] == got[0] for rid in range(6)), got
    assert want[5] != want[0], "the reference's padded write did not show"


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


def _chaos(F, loss_at):
    """A shard loss at IO op ``loss_at`` under a mixed IO fault storm."""
    return dict(faults=F.FaultPlan(13, [
        F.FaultSpec(F.SHARD_LOSS, at=(loss_at,), shard=1),
        F.FaultSpec(F.IO_ERROR, prob=0.2),
        F.FaultSpec(F.PARTIAL_WRITE, prob=0.05),
        F.FaultSpec(F.IO_DELAY, prob=0.1, ticks=3)]),
        io_retry=F.RetryPolicy(max_retries=2))


TUNE = dict(window_fracs=(0.1, 0.5, 1.0), retune_every=16, rate_shift=2,
            min_gain=0.0, min_samples=8)

# knob cases: engine kwargs made from a faults package (the reference's or
# the port's), and the run's arrivals and scheduler seed.
KNOBS = {
    # tests/test_scheduler.py::test_engine_chaos_degraded_shed_and_recovery
    "sharded-chaos": (lambda F, tmp: dict(
        hbm_blocks=24, n_shards=2, faults=F.FaultPlan(7, [
            F.FaultSpec(F.SHARD_LOSS, at=(6,), shard=0),
            F.FaultSpec(F.IO_ERROR, prob=1.0)]),
        io_retry=F.RetryPolicy(max_retries=0)), list(range(8)), 2),
    "replicate-memory": (lambda F, tmp: dict(
        hbm_blocks=24, n_shards=2, replicate=True, **_chaos(F, 4)),
        [0, 0, 1, 1, 2, 2, 3, 3], 1),
    "replicate-disk": (lambda F, tmp: dict(
        hbm_blocks=24, n_shards=2, replicate=True,
        journal_dir=str(tmp / F.__name__.split(".")[0]), **_chaos(F, 4)),
        None, 0),
    # tests/test_tuning.py::test_blockpool_autotune_backend, at a
    # retune_every this short run reaches
    "autotune": (lambda F, tmp: dict(hbm_blocks=24, autotune=dict(
        TUNE, small_fracs=(0.05, 0.1, 0.2), ghost_fracs=(0.5, 1.0))),
        None, 0),
    "autotune-sharded": (lambda F, tmp: dict(
        hbm_blocks=32, n_shards=4, autotune=dict(TUNE)), None, 0),
}


def _decisions(tuner):
    return [(d.at_access, [dataclasses.asdict(c) for c in d.configs],
             d.est_miss_ratios.tolist(), d.n_sampled, d.rate_shift,
             dataclasses.asdict(d.chosen), d.applied)
            for d in tuner.decisions]


@pytest.mark.parametrize("case", sorted(KNOBS))
def test_engine_knobs_equal_reference(models, tmp_path, case):
    """The reference's pool knobs through both engines: statuses, tokens,
    pool stats and flows, host and quarantine sets, injected faults, the
    IO clock, the policy bytes, journals and tuner decisions equal, and
    ``cache_mrc`` within 1e-12."""
    from repro import faults as JF
    from repro_torch import faults as PF

    make, arrivals, seed = KNOBS[case]
    japi, jparams, api, params = models
    kw = dict(block_size=8, max_batch=2)
    jeng = JEngine(japi, jparams, **kw, **make(JF, tmp_path))
    peng = ServingEngine(api, params, device=CPU, **kw, **make(PF, tmp_path))
    rng = np.random.default_rng(13)
    prompts = [[int(t) for t in rng.integers(0, 512, 24)] for _ in range(8)]
    reqs = [Request(i, p, max_new=3, priority=2 if i >= 6 else 0)
            for i, p in enumerate(prompts)]
    want, got = _serve(jeng, peng, reqs, arrivals=arrivals, seed=seed)
    _same_tokens(models, dict(enumerate(prompts)), want, got)
    _same_pool(jeng, peng)
    jp, pp = jeng.pool, peng.pool
    assert sorted(pp.host) == sorted(jp.host) and pp._corrupt == jp._corrupt
    assert pp.io_clock().now == jp.io_clock().now
    assert peng.degraded == jeng.degraded
    assert PF.pack(PF.state_dict(pp.policy)) == \
        JF.pack(JF.state_dict(jp.policy))
    pevents = [(e["kind"], e["shard"], e["a"], e["b"])
               for e in pp.obs_snapshot().events]
    assert pevents == [(e["kind"], e["shard"], e["a"], e["b"])
                       for e in jp.obs_snapshot().events]
    if jp._io is not None:
        assert (pp._io.plan.injected, pp._io.plan.op_seq) == \
            (jp._io.plan.injected, jp._io.plan.op_seq)
        assert pp._io.plan.injected > 0
    if jp._replicator is not None:
        assert "promote" in {e[0] for e in pevents}
        n = pp.policy.n_shards
        assert [pp.replication_lag(i) for i in range(n)] == \
            [jp.replication_lag(i) for i in range(n)]
        if case == "replicate-disk":
            for pool in (jp, pp):
                for jr in pool._replicator.journals:
                    jr.close()
            ref = {p.relative_to(tmp_path / "repro"): p.read_bytes()
                   for p in (tmp_path / "repro").rglob("*") if p.is_file()}
            port = {p.relative_to(tmp_path / "repro_torch"): p.read_bytes()
                    for p in (tmp_path / "repro_torch").rglob("*")
                    if p.is_file()}
            assert port == ref and port
            for i in range(n):
                res = PF.recover(str(tmp_path / "repro_torch" / f"shard{i}"))
                assert PF.pack(PF.state_dict(res.policy)) == \
                    PF.pack(PF.state_dict(pp.policy.shards[i]))
    if jp.tuner is not None:
        assert _decisions(pp.tuner) == _decisions(jp.tuner)
        assert len(pp.tuner.decisions) >= 2
        caps = (12, 24, 48)
        for shift in (0, 1):  # this short stream's sample at 1/2**shift
            jm = jeng.cache_mrc(caps, rate_shift=shift)
            pm = peng.cache_mrc(caps, rate_shift=shift)
            assert list(pm) == list(jm) == list(caps)
            assert all(np.isfinite(pm[c]) and abs(pm[c] - jm[c]) <= 1e-12
                       for c in caps), (shift, pm, jm)
    else:
        with pytest.raises(RuntimeError):
            peng.cache_mrc()


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
