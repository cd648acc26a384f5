"""The port's ``repro_torch.faults`` and ``repro_torch.checkpoint`` against
the reference's ``repro.faults`` and ``repro.checkpoint``, on the CPU.

Every faults module is integer or bit-exact logic, so every equality
here is exact: the ``next_op`` streams of seeded plans, ``HostIO``
outcomes, clocks and breaker flips, the snapshot bytes (both goldens,
single-shard and sharded caches), snapshots and ``SnapshotManager``
steps crossing from one package to the other and replaying on hit for
hit, ghost-journal failover, and the port's ``BlockPool(device="cpu")``
under the reference's seeded plans of ``tests/test_faults.py`` (stats,
host keys, the quarantine set, injected faults, the IO clock, the policy
bytes and the incident events).
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as J
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.prodcache import ProdClock2QPlus as JProd
from repro.kvcache.pool import BlockPool as JPool
from repro.obs import NullSink as JNullSink
from repro.obs import ObsSink as JObsSink
from repro.shardcache import ShardedClock2QPlus as JSharded
from repro_torch import faults as P
from repro_torch.configs import get_config, reduced
from repro_torch.core.prodcache import ProdClock2QPlus as PProd
from repro_torch.kvcache.pool import BlockPool as PPool
from repro_torch.obs import NullSink as PNullSink
from repro_torch.obs import ObsSink as PObsSink
from repro_torch.shardcache import ShardedClock2QPlus as PSharded

GOLDEN = pathlib.Path(__file__).parent / "golden"
CPU = "cpu"


def _specs(pkg, specs):
    """``specs`` as ``pkg.FaultSpec``s (kind, keyword args)."""
    return [pkg.FaultSpec(kind, **kw) for kind, kw in specs]


def _plans(seed, specs):
    return (J.FaultPlan(seed, _specs(J, specs)),
            P.FaultPlan(seed, _specs(P, specs)))


def _fault(f):
    return None if f is None else dataclasses.astuple(f)


def _events(snap):
    return [(e["kind"], e["shard"], e["a"], e["b"]) for e in snap.events]


# =============================================================================
# plan: the same seed and specs give the same decisions
# =============================================================================

PLAN_CASES = {
    "probabilistic": (42, [(J.IO_ERROR, dict(prob=0.2)),
                           (J.IO_DELAY, dict(prob=0.05, ticks=9))]),
    "scheduled-and-filtered": (0, [
        (J.IO_ERROR, dict(ops=(J.OP_SWAP_OUT,), at=(3, 7))),
        (J.SHARD_LOSS, dict(at=(5, 11), shard=2)),
        (J.PARTIAL_WRITE, dict(ops=(J.OP_SWAP_OUT,), prob=0.3))]),
    "every-kind": (0xDEADBEEF, [
        (J.CRASH, dict(ops=(J.OP_JOURNAL_APPEND,), at=(17,), ticks=5)),
        (J.IO_DELAY, dict(prob=0.1, ticks=3)),
        (J.IO_ERROR, dict(prob=0.25)),
        (J.PARTIAL_WRITE, dict(prob=0.05)),
        (J.SHARD_LOSS, dict(prob=0.01))]),
    "wide-seed": ((1 << 64) + 77, [(J.IO_ERROR, dict(prob=0.5))]),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_next_op_stream_equals_reference(case):
    seed, specs = PLAN_CASES[case]
    jp, pp = _plans(seed, specs)
    ops = (J.OP_SWAP_IN, J.OP_SWAP_OUT, J.OP_JOURNAL_APPEND)
    for op in ops:
        assert [_fault(f) for f in jp.schedule(op, 600)] == \
            [_fault(f) for f in pp.schedule(op, 600)]
    rng = np.random.default_rng(3)
    for i in rng.integers(0, len(ops), 2000):
        assert _fault(jp.next_op(ops[i])) == _fault(pp.next_op(ops[i]))
    assert (jp.op_seq, jp.injected, jp.seed) == \
        (pp.op_seq, pp.injected, pp.seed)


def test_nullplan_and_constants_equal_reference():
    jn, pn = J.NullPlan(), P.NullPlan()
    assert [jn.next_op("swap_in") for _ in range(50)] == \
        [pn.next_op("swap_in") for _ in range(50)]
    assert (jn.op_seq, jn.injected, jn.enabled) == \
        (pn.op_seq, pn.injected, pn.enabled)
    for name in ("IO_ERROR", "IO_DELAY", "PARTIAL_WRITE", "SHARD_LOSS",
                 "CRASH", "FAULT_NAMES", "OP_SWAP_IN", "OP_SWAP_OUT",
                 "OP_JOURNAL_APPEND", "OP_ANY", "MAGIC", "VERSION"):
        assert getattr(P, name) == getattr(J, name), name
    assert sorted(P.__all__) == sorted(J.__all__)
    for x in np.random.default_rng(0).integers(0, 1 << 63, 100, np.int64):
        assert P.splitmix64(int(x)) == J.splitmix64(int(x))
    for bad in (dict(kind=99), dict(kind=P.IO_ERROR, prob=1.5)):
        with pytest.raises(ValueError):
            P.FaultSpec(**bad)


# =============================================================================
# io: outcomes, clock, breaker transitions, counters, events
# =============================================================================

IO_CASES = {
    "retry-storm": (5, [(J.IO_ERROR, dict(prob=0.7)),
                        (J.IO_DELAY, dict(prob=0.1, ticks=7))],
                    dict(max_retries=2), dict(threshold=4, probe_after=8)),
    "deadline": (9, [(J.IO_DELAY, dict(prob=0.3, ticks=40)),
                     (J.IO_ERROR, dict(prob=0.2))],
                 dict(max_retries=5, deadline_ticks=100), {}),
    "torn-and-lost": (13, [(J.SHARD_LOSS, dict(at=(3, 40))),
                           (J.PARTIAL_WRITE, dict(prob=0.2)),
                           (J.IO_ERROR, dict(prob=0.9))],
                      dict(max_retries=0), dict(threshold=3, probe_after=5)),
}


@pytest.mark.parametrize("case", sorted(IO_CASES))
def test_hostio_equals_reference(case):
    seed, specs, retry, breaker = IO_CASES[case]
    jp, pp = _plans(seed, specs)
    js, ps = JObsSink(src="io"), PObsSink(src="io")
    jio = J.HostIO(plan=jp, retry=J.RetryPolicy(**retry), obs=js,
                   breaker=J.CircuitBreaker(obs=js, **breaker))
    pio = P.HostIO(plan=pp, retry=P.RetryPolicy(**retry), obs=ps,
                   breaker=P.CircuitBreaker(obs=ps, **breaker))
    jran, pran = [], []
    rng = np.random.default_rng(seed)
    for i in range(1500):
        op = ("swap_in", "swap_out")[int(rng.integers(0, 2))]
        if i == 900:  # the fault source clears: the breaker probes back
            jio.plan, pio.plan = J.NullPlan(), P.NullPlan()
        a = jio.run(op, i, lambda: jran.append(i))
        b = pio.run(op, i, lambda: pran.append(i))
        assert dataclasses.astuple(a) == dataclasses.astuple(b), i
        assert (jio.clock.now, jio.degraded, jio.breaker.trips,
                jio.breaker.consecutive_failures) == \
            (pio.clock.now, pio.degraded, pio.breaker.trips,
             pio.breaker.consecutive_failures), i
    assert jran == pran
    assert [_fault(f) for f in jio.pending_shard_loss] == \
        [_fault(f) for f in pio.pending_shard_loss]
    jsn, psn = js.snapshot(), ps.snapshot()
    assert jsn.counters == psn.counters
    assert _events(jsn) == _events(psn)
    assert jio.breaker.trips > 0 or case == "deadline"
    assert [P.RetryPolicy().backoff(k) for k in range(10)] == \
        [J.RetryPolicy().backoff(k) for k in range(10)]


# =============================================================================
# snapshot: bytes, goldens, crossing packages
# =============================================================================

def _golden_ops(pol):
    """``tests/test_faults.py::_golden_policy``'s call stream."""
    for i in range(300):
        pol.access((i * 7) % 40, dirty=(i % 11 == 0))
    pol.access(1, pin=True)
    return pol


def _golden(mk):
    return _golden_ops(mk(24, max_capacity=32, track_io=False))


def test_pack_equals_both_goldens():
    jpol = _golden(lambda *a, **k: JProd(*a, obs=JNullSink(), **k))
    ppol = _golden(lambda *a, **k: PProd(*a, obs=PNullSink(), **k))
    v1 = (GOLDEN / "c2qp_snapshot_v1.bin").read_bytes()
    v2 = (GOLDEN / "c2qp_snapshot_v2.bin").read_bytes()
    assert P.pack(P.state_dict(ppol)) == J.pack(J.state_dict(jpol)) == v1
    assert P.pack(P.state_dict(ppol, journal_meta=(3, 1234))) == \
        J.pack(J.state_dict(jpol, journal_meta=(3, 1234))) == v2
    for golden in (v1, v2):
        d = P.unpack(golden)
        assert P.pack(d) == golden
        assert P.pack(P.state_dict(P.policy_from_snapshot(d))) == v1


def _mixed_stream(n, universe, seed):
    rng = np.random.default_rng(seed)
    return [(int(k), bool(d)) for k, d in
            zip(rng.integers(0, universe, n), rng.random(n) < 0.1)]


def _drive_prod(pol, stream, io=True):
    out = []
    for k, dirty in stream:
        r = pol.access(k, dirty=dirty)
        if io and not r.hit:
            pol.io_done(k)
        out.append((r.hit, int(r.block), int(r.evicted_key)))
    return out


@pytest.mark.parametrize("direction", ["reference-to-port",
                                       "port-to-reference"])
@pytest.mark.parametrize("mid_resize", [False, True])
def test_snapshot_crosses_packages_and_replays_hit_for_hit(direction,
                                                           mid_resize):
    kw = dict(max_capacity=64, track_io=True, window_frac=0.3)
    jpol = JProd(48, obs=JNullSink(), **kw)
    ppol = PProd(48, obs=PNullSink(), **kw)
    first = _mixed_stream(3000, 160, 4)
    assert _drive_prod(jpol, first) == _drive_prod(ppol, first)
    if mid_resize:  # leave a live resize half-done
        jpol.begin_resize(32), ppol.begin_resize(32)
        jpol.resize_step(4), ppol.resize_step(4)
        assert jpol.rehash_pending() or jpol.undrained_count()
    src, dst = (J, P) if direction == "reference-to-port" else (P, J)
    src_pol = jpol if src is J else ppol
    buf = src.pack(src.state_dict(src_pol))
    assert J.pack(J.state_dict(jpol)) == P.pack(P.state_dict(ppol)) == buf
    restored = dst.policy_from_snapshot(dst.unpack(buf))
    assert dst.pack(dst.state_dict(restored)) == buf
    second = _mixed_stream(3000, 160, 5)
    assert _drive_prod(restored, second) == _drive_prod(src_pol, second)


def test_sharded_snapshot_equals_reference_and_crosses():
    mk = dict(n_shards=4, max_capacity=512)
    jsvc = JSharded(256, obs=JNullSink(), **mk)
    psvc = PSharded(256, obs=PNullSink(), **mk)
    trace = np.random.default_rng(10).integers(0, 2000, 12000)
    first, second = trace[:6000], trace[6000:]
    assert np.array_equal(jsvc.access_many(first), psvc.access_many(first))
    jsvc.rebalance(), psvc.rebalance()
    jsvc.begin_resize(200), psvc.begin_resize(200)
    buf = J.pack(J.state_dict(jsvc, journal_meta=(1, 77)))
    assert P.pack(P.state_dict(psvc, journal_meta=(1, 77))) == buf
    assert P.pack(P.state_dict(psvc)) == J.pack(J.state_dict(jsvc))
    psvc2 = PSharded(256, obs=PNullSink(), **mk)
    P.load_state_dict(psvc2, P.unpack(buf))
    jsvc2 = JSharded(256, obs=JNullSink(), **mk)
    J.load_state_dict(jsvc2, J.unpack(P.pack(P.state_dict(psvc))))
    want = jsvc.access_many(second)
    assert np.array_equal(psvc2.access_many(second), want)
    assert np.array_equal(jsvc2.access_many(second), want)
    with pytest.raises(ValueError):
        P.load_state_dict(PSharded(256, n_shards=2, max_capacity=512,
                                   obs=PNullSink()), P.unpack(buf))
    with pytest.raises(ValueError):
        P.policy_from_snapshot(P.unpack(buf))


def test_snapshot_file_and_corruption_equal_reference(tmp_path):
    ppol = _golden(lambda *a, **k: PProd(*a, obs=PNullSink(), **k))
    buf = P.write_snapshot(str(tmp_path / "p.c2qsnap"), ppol)
    assert (tmp_path / "p.c2qsnap").read_bytes() == buf
    assert not list(tmp_path.glob("*.tmp.*"))
    assert J.pack(J.read_snapshot(str(tmp_path / "p.c2qsnap"))) == buf
    flipped = bytearray(buf)
    flipped[len(buf) // 2] ^= 0xFF
    for pkg in (J, P):
        with pytest.raises(IOError):
            pkg.unpack(bytes(flipped))
        with pytest.raises(ValueError):
            pkg.unpack(b"NOTASNAP" + buf[8:])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshot_manager_steps_cross_packages(tmp_path, writer):
    jpol = JProd(48, max_capacity=64, obs=JNullSink())
    ppol = PProd(48, max_capacity=64, obs=PNullSink())
    wpkg, wpol = (J, jpol) if writer == "reference" else (P, ppol)
    rpkg = P if writer == "reference" else J
    mgr = wpkg.SnapshotManager(str(tmp_path / "snaps"), keep=2)
    rng = np.random.default_rng(13)
    for step in (10, 20, 30):
        stream = _mixed_stream(500, 160, int(rng.integers(1 << 30)))
        assert _drive_prod(jpol, stream, io=False) == \
            _drive_prod(ppol, stream, io=False)
        mgr.save(wpol, step)
    reader = rpkg.SnapshotManager(str(tmp_path / "snaps"), keep=2)
    assert reader.steps() == mgr.steps() == [20, 30]
    d = reader.load(30)
    assert rpkg.pack(d) == wpkg.pack(wpkg.state_dict(wpol))
    restored = rpkg.policy_from_snapshot(d)
    second = _mixed_stream(2000, 160, 99)
    assert _drive_prod(restored, second, io=False) == \
        _drive_prod(wpol, second, io=False)
    # restore() into a live port cache emits the typed restore event
    sink = PObsSink(src="t")
    target = PProd(48, max_capacity=64, obs=sink)
    assert P.SnapshotManager(str(tmp_path / "snaps")).restore(target) == 30
    assert any(e["kind"] == "restore" and e["a"] == 30
               for e in sink.snapshot().events)


def test_checkpoint_store_tensor_leaves_and_device(tmp_path):
    import collections

    from repro.checkpoint.ckpt import CheckpointManager as JCkpt
    from repro_torch.checkpoint.ckpt import CheckpointManager as PCkpt

    NT = collections.namedtuple("NT", "w b")
    g = torch.Generator().manual_seed(0)
    state = {"layer": NT(torch.randn(4, 3, generator=g),
                         torch.arange(5, dtype=torch.int32)),
             "step": np.int64(7)}
    PCkpt(str(tmp_path)).save(3, state)
    host = {"layer": {"b": state["layer"].b.numpy(),
                      "w": state["layer"].w.numpy()},
            "step": np.int64(7)}
    got = JCkpt(str(tmp_path)).restore(3, host, verify=True)
    assert np.array_equal(got["layer"]["w"], host["layer"]["w"])
    JCkpt(str(tmp_path)).save(4, host)
    back = PCkpt(str(tmp_path)).restore(None, state, device=CPU, verify=True)
    assert isinstance(back["layer"], NT)
    assert torch.equal(back["layer"].w, state["layer"].w)
    assert back["layer"].b.dtype == torch.int32
    assert int(back["step"]) == 7
    m = PCkpt(str(tmp_path)).restore(4, host)
    assert isinstance(m["layer"]["w"], np.ndarray)


# =============================================================================
# recovery: ghost journal + failover
# =============================================================================

def test_ghost_journal_failover_equals_reference():
    mk = dict(n_shards=4, max_capacity=512, track_io=True)
    jsvc = JSharded(256, obs=JObsSink(src="svc"), **mk)
    psvc = PSharded(256, obs=PObsSink(src="svc"), **mk)
    rng = np.random.default_rng(22)
    for k in rng.integers(0, 600, 10_000):
        a, b = jsvc.access(int(k)), psvc.access(int(k))
        assert (a.hit, a.block) == (b.hit, b.block)
        if not a.hit:
            jsvc.io_done(int(k)), psvc.io_done(int(k))
    jj, pj = J.GhostJournal(jsvc), P.GhostJournal(psvc)
    assert jj.meta == pj.meta and jj.captures == pj.captures == 1
    # half the residents' payloads survive: those are refilled
    filled = {"j": [], "p": []}

    def fill(tag):
        def f(key):
            if key % 2:
                return None
            return lambda local: filled[tag].append((key, local))
        return f

    assert J.failover(jsvc, 1, jj, fill=fill("j")) == \
        P.failover(psvc, 1, pj, fill=fill("p"))
    assert filled["j"] == filled["p"] and filled["j"]
    assert P.failover(psvc, 2, pj) == J.failover(jsvc, 2, jj)
    assert pj.rewarm(psvc, 3) != (0, 0)
    jj.rewarm(jsvc, 3)
    assert P.pack(P.state_dict(psvc)) == J.pack(J.state_dict(jsvc))
    for i in range(4):
        assert psvc.shards[i].resident_keys() == \
            jsvc.shards[i].resident_keys()
        assert psvc.shards[i].ghost_keys() == jsvc.shards[i].ghost_keys()
    assert _events(psvc.obs.snapshot()) == _events(jsvc.obs.snapshot())
    assert P.GhostJournal().rewarm(psvc, 0) == (0, 0)


# =============================================================================
# BlockPool under the reference's seeded plans (tests/test_faults.py)
# =============================================================================

@pytest.fixture(scope="module")
def cfgs():
    return (j_reduced(j_get_config("granite-3-8b")),
            reduced(get_config("granite-3-8b")))


def _pools(cfgs, plan_fn, retry=None, **kw):
    """A reference pool and a port pool (``device="cpu"``), each with
    its own plan from ``plan_fn(package)`` and, when ``retry`` is given,
    its own ``RetryPolicy(max_retries=retry)``."""
    jcfg, pcfg = cfgs

    def io(F):
        return dict(faults=plan_fn(F), io_retry=None if retry is None
                    else F.RetryPolicy(max_retries=retry))
    return (JPool(jcfg, 32, 8, **io(J), **kw),
            PPool(pcfg, 32, 8, device=CPU, **io(P), **kw))


def _drive_pools(jpool, ppool, n=2500, keyspace=120, seed=0):
    """``tests/test_faults.py::_drive`` through two pools in step."""
    cfg = ppool.cfg
    shape = (cfg.n_layers, ppool.bs, cfg.n_kv_heads, cfg.hd)
    jz, pz = [torch.zeros(shape) if isinstance(p, PPool) else
              jnp.zeros(shape) for p in (jpool, ppool)]
    served = 0
    for k in np.random.default_rng(seed).integers(0, keyspace, n):
        a = jpool.lookup(int(k), pin=False)
        b = ppool.lookup(int(k), pin=False)
        assert a == b, int(k)
        if a[1]:
            jpool.write_block(a[0], jz, jz, key=int(k))
            ppool.write_block(b[0], pz, pz, key=int(k))
        else:
            served += 1
    return served


def _same_pools(jpool, ppool):
    assert dataclasses.asdict(ppool.stats) == dataclasses.asdict(jpool.stats)
    assert sorted(ppool.host) == sorted(jpool.host)
    assert ppool._corrupt == jpool._corrupt
    if jpool._io is not None:
        assert ppool._io.plan.injected == jpool._io.plan.injected
        assert ppool._io.plan.op_seq == jpool._io.plan.op_seq
    assert ppool.io_clock().now == jpool.io_clock().now
    assert ppool.degraded == jpool.degraded
    assert ppool.pinned_count() == jpool.pinned_count()
    assert dict(ppool.policy.flows) == dict(jpool.policy.flows)
    assert P.pack(P.state_dict(ppool.policy)) == \
        J.pack(J.state_dict(jpool.policy))
    jsn, psn = jpool.obs_snapshot(), ppool.obs_snapshot()
    assert psn.counters == jsn.counters
    assert _events(psn) == _events(jsn)


POOL_PLANS = {
    "mixed": (lambda F: F.FaultPlan(11, [
        F.FaultSpec(F.IO_ERROR, prob=0.3),
        F.FaultSpec(F.PARTIAL_WRITE, prob=0.1),
        F.FaultSpec(F.IO_DELAY, prob=0.1, ticks=3)]), {}),
    "nullplan": (lambda F: F.NullPlan(), {}),
    "torn": (lambda F: F.FaultPlan(5, [
        F.FaultSpec(F.PARTIAL_WRITE, ops=(F.OP_SWAP_OUT,), prob=1.0)]), {}),
    "loss-and-storm": (lambda F: F.FaultPlan(3, [
        F.FaultSpec(F.SHARD_LOSS, at=(30,), shard=0),
        F.FaultSpec(F.IO_ERROR, prob=1.0)]),
        dict(n_shards=4, journal_every=64, retry=1)),
    "auto-failover": (lambda F: F.FaultPlan(7, [
        F.FaultSpec(F.SHARD_LOSS, at=(50,), shard=2)]),
        dict(n_shards=4, journal_every=64)),
    "hashed-victim": (lambda F: F.FaultPlan(19, [
        F.FaultSpec(F.SHARD_LOSS, prob=0.02),
        F.FaultSpec(F.IO_ERROR, prob=0.2)]),
        dict(n_shards=4, journal_every=32)),
}


@pytest.mark.parametrize("case", sorted(POOL_PLANS))
def test_pool_under_seeded_plan_equals_reference(cfgs, case):
    plan_fn, kw = POOL_PLANS[case]
    jpool, ppool = _pools(cfgs, plan_fn, **kw)
    assert _drive_pools(jpool, ppool) > 0
    _same_pools(jpool, ppool)
    if case != "nullplan":
        assert ppool._io.plan.injected > 0
    if kw.get("n_shards"):
        kinds = {e[0] for e in _events(ppool.obs_snapshot())}
        assert {"shard_lost", "shard_rewarm"} <= kinds


def test_pool_degraded_read_through_and_recovery_equal_reference(cfgs):
    plan_fn = lambda F: F.FaultPlan(3, [F.FaultSpec(F.IO_ERROR, prob=1.0)])
    jpool, ppool = _pools(cfgs, plan_fn, retry=0)
    _drive_pools(jpool, ppool, n=1500)
    assert ppool.degraded and ppool.stats.swap_in == 0
    _same_pools(jpool, ppool)
    jpool._io.plan, ppool._io.plan = J.NullPlan(), P.NullPlan()
    _drive_pools(jpool, ppool, n=1500, seed=1)
    assert not ppool.degraded and ppool.stats.swap_in > 0
    _same_pools(jpool, ppool)


def test_pool_nullplan_equals_uninstrumented(cfgs):
    pcfg = cfgs[1]
    plain = PPool(pcfg, 32, 8, device=CPU)
    instr = PPool(pcfg, 32, 8, faults=P.NullPlan(), device=CPU)
    _drive_pools(plain, instr)   # lookups must agree call for call
    assert dataclasses.asdict(plain.stats) == dataclasses.asdict(instr.stats)


def test_pool_refuses_what_the_reference_refuses(cfgs):
    pcfg = cfgs[1]
    with pytest.raises(ValueError):
        PPool(pcfg, 32, 8, replicate=True, device=CPU)
    pool = PPool(pcfg, 32, 8, n_shards=4, device=CPU)
    with pytest.raises(RuntimeError):
        pool.failover_shard(1)
    with pytest.raises(RuntimeError):
        pool.estimate_mrc()
    assert pool.replication_lag(0) == 0 and not pool.degraded


def test_pool_failover_refills_device_slots_from_host(cfgs):
    """A promote refills every resident whose host copy survives into
    device slot ``sid * stride + local``; the reference's pool, driven
    alike, keeps the same keys in the same slots."""
    jcfg, pcfg = cfgs
    mk = lambda F: F.FaultPlan(13, [F.FaultSpec(F.SHARD_LOSS,
                                                ops=("swap_out",),
                                                at=(6,), shard=1)])
    kw = dict(n_shards=4, replicate=True, lag_threshold=1 << 30,
              replica_poll=64)
    jpool, ppool = _pools(cfgs, mk, **kw)
    shape = (pcfg.n_layers, ppool.bs, pcfg.n_kv_heads, pcfg.hd)
    rng = np.random.default_rng(2)
    for k in rng.integers(0, 120, 1200):
        a = jpool.lookup(int(k), pin=False)
        b = ppool.lookup(int(k), pin=False)
        assert a == b
        if a[1]:
            val = float(k % 97)
            jpool.write_block(a[0], jnp.full(shape, val),
                              jnp.full(shape, -val), key=int(k))
            ppool.write_block(b[0], torch.full(shape, val),
                              torch.full(shape, -val), key=int(k))
    _same_pools(jpool, ppool)
    kinds = [e[0] for e in _events(ppool.obs_snapshot())]
    assert "promote" in kinds and "shard_rewarm" not in kinds
    assert ppool.replication_lag(1) == jpool.replication_lag(1)
    # every resident's device block holds its own content again
    for sid, sh in enumerate(ppool.policy.shards):
        for key in sh.resident_keys():
            slot = ppool.policy.slot_of(key)
            assert slot == jpool.policy.slot_of(key)
            want = float(key % 97)
            assert torch.all(ppool.kpool[:, slot] == want), (sid, key)
            assert np.all(np.asarray(jpool.kpool[:, slot]) == want)


def test_promotion_keeps_a_block_newer_than_its_host_copy(cfgs):
    """The port's one departure from the reference: a block written in
    place after its host copy was taken (a live sequence's decode tail,
    ``note_write``) keeps its device content when its shard's standby is
    promoted.  The reference copies the older host copy over it; keys,
    slots and counters stay equal."""
    jcfg, pcfg = cfgs
    mk = lambda F: F.FaultPlan(1, [F.FaultSpec(F.SHARD_LOSS, at=(0,),
                                               shard=1)])
    jpool, ppool = _pools(cfgs, mk, n_shards=4, replicate=True,
                          lag_threshold=1 << 30)
    shape = (pcfg.n_layers, ppool.bs, pcfg.n_kv_heads, pcfg.hd)
    key = next(k for k in range(1000)
               if ppool.policy.shard_of(k) == 1)
    a, b = jpool.lookup(key), ppool.lookup(key)        # pinned: live
    assert a == b
    jpool.write_block(a[0], jnp.full(shape, 1.0), jnp.full(shape, 1.0),
                      key=key)
    ppool.write_block(b[0], torch.full(shape, 1.0), torch.full(shape, 1.0),
                      key=key)
    jpool.run_flusher(), ppool.run_flusher()   # the host copy: all 1.0
    assert key in jpool.host and key in ppool.host
    # a decoded token lands in the block after the copy
    jpool.write_token(a[0], 3, jnp.full(shape[:1] + shape[2:], 2.0),
                      jnp.full(shape[:1] + shape[2:], 2.0))
    ppool.write_token(b[0], 3, torch.full(shape[:1] + shape[2:], 2.0),
                      torch.full(shape[:1] + shape[2:], 2.0))
    ppool.note_write(key)
    other = next(k for k in range(1000, 2000)
                 if ppool.policy.shard_of(k) == 1)
    for p in (jpool, ppool):   # an eviction's swap-out fires the loss
        p._on_evict(other, p.policy.n_slots - 1)
        p.lookup(other + 1, pin=False)
    _same_pools(jpool, ppool)
    kinds = [e[0] for e in _events(ppool.obs_snapshot())]
    assert "promote" in kinds
    slot = ppool.policy.slot_of(key)
    assert slot == b[0] == jpool.policy.slot_of(key)
    assert float(ppool.kpool[0, slot, 3, 0, 0]) == 2.0   # kept
    assert float(np.asarray(jpool.kpool)[0, slot, 3, 0, 0]) == 1.0


@pytest.mark.parametrize("replicate", [False, True])
def test_decode_append_marks_the_host_copy_stale(cfgs, replicate):
    """``PagedKVManager.slot_for_pos`` resolves where each decoded token
    goes and reports the in-place write to the pool: a block with a host
    copy is then marked newer than it, on a pool with a standby to
    promote; a pool without one keeps no such record."""
    from repro_torch.kvcache.manager import PagedKVManager

    _, pcfg = cfgs
    kw = dict(n_shards=4, replicate=True) if replicate else {}
    pool = PPool(pcfg, 32, 8, device=CPU, **kw)
    mgr = PagedKVManager(pcfg, pool)
    st, fill = mgr.admit(0, list(range(12)))     # a full block, a tail
    assert fill == [0, 1] and len(st.block_keys) == 2
    z = torch.zeros((pcfg.n_layers, pool.bs, pcfg.n_kv_heads, pcfg.hd))
    for b in fill:                               # prefill writes both
        pool.write_block(st.slots[b], z, z, key=st.block_keys[b])
    pool.run_flusher(max_blocks=8)               # both mirrored to host
    tail = st.block_keys[1]
    assert tail in pool.host and st.block_keys[0] in pool.host
    assert mgr.slot_for_pos(0, 12) == (st.slots[1], 4)
    if not replicate:
        assert pool._stale is None
        return
    assert pool._stale == {tail}
    pool.flush(tail)                             # already mirrored: kept
    assert pool._stale == {tail}
    pool._copy_out(tail, st.slots[1])            # a fresh copy: current
    assert pool._stale == set()
    slot, off = mgr.slot_for_pos(0, 16)          # a new tail, no copy
    assert off == 0 and len(st.block_keys) == 3
    assert pool._stale == set()
