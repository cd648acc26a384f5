"""Serving runtime: continuous batching over the Clock2Q+-paged KV pool.

Flow per request:
  submit -> admission control (bounded queue, priority classes, SLO
  deadlines — repro_torch.serving.scheduler) -> prefix-cache lookup
  (shared full blocks hit; correlated references!) -> prefill only the
  blocks that missed -> decode loop with paged attention -> release
  (blocks stay cached, unpinned, for future prefix hits).

The port of ``repro.serving.engine``.  Prefill runs the model's
``forward_prefill`` (the ``flash_attention`` kernel) and decode its
``forward_decode_paged`` (the ``paged_attention`` kernel), on the card
unless the caller names another device, both under ``torch.no_grad()``:
params that come live out of a train step serve without building a
graph.  ``run()`` is a thin client of
the ``Scheduler``; ``run_sync`` is the old synchronous loop, kept as the
reference the scheduler's greedy tokens are held against.

Under device-memory pressure the Clock2Q+ policy evicts cold blocks to
the host tier; dirty (device-only) blocks are flushed by the watermark
flusher before they become evictable, exactly as §4.1.3 prescribes.
The reference's pool knobs pass through to the ``BlockPool``: sharding
(``n_shards``, ``rebalance_headroom``), fault injection (``faults``,
``io_retry``), hot-standby replication (``replicate``, ``journal_dir``)
and the online tuner (``autotune``; ``cache_mrc`` is its what-if MRC).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.kvcache.manager import PagedKVManager
from repro_torch.kvcache.pool import BlockPool
from repro_torch.models import layers as L
from repro_torch.models.model import ModelAPI
from repro_torch.models.transformer import FAMILIES
from repro_torch.serving.admission import ST_COMPLETED, SchedRequest
from repro_torch.serving.scheduler import SchedConfig, Scheduler


@dataclasses.dataclass
class Request:
    """One serving request.  ``priority``/``deadline``/``tenant`` feed
    the scheduler (deadline in virtual ticks from submission; 0 = no
    SLO); the defaults reproduce the pre-scheduler behaviour."""

    req_id: int
    prompt: List[int]
    max_new: int = 16
    priority: int = 1
    deadline: int = 0
    tenant: str = "default"


@dataclasses.dataclass
class Completion:
    """Terminal record: ``status`` is completed / shed / rejected (only
    completed carries tokens).  Oversized prompts — more blocks than the
    pool could ever pin — are an explicit ``rejected`` completion."""

    req_id: int
    tokens: List[int]
    status: str = ST_COMPLETED


class ServingEngine:
    """Single-host engine for the dense/vlm/moe families (the paged-KV
    families); greedy sampling.  A vlm model serves token prompts, as the
    reference's engine serves it.

    ``params`` must live on ``device`` (the card unless the caller names
    another), where the KV pool is allocated."""

    def __init__(self, api: ModelAPI, params, *, block_size: int = 16,
                 hbm_blocks: int = 64, max_batch: int = 8,
                 max_blocks_per_seq: int = 64, n_shards: int = 0,
                 max_hbm_blocks: int = 0, rebalance_headroom: float = 1.0,
                 autotune=False, faults=None, io_retry=None,
                 replicate: bool = False, journal_dir=None, obs=None,
                 device=None):
        if api.cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"paged serving targets the attention-KV families, not "
                f"{api.cfg.family!r}")
        self.api = api
        self.cfg = api.cfg
        self.params = params
        # rebalance_headroom > 1 (or max_hbm_blocks slack) is what lets
        # the sharded policy move capacity between shards, at the cost
        # of preallocating that many more device blocks.  autotune=
        # True/dict runs the OnlineTuner over the block-key stream.
        # faults= threads a FaultPlan through the pool's host-IO swap
        # path; under sustained IO failure the pool sheds to
        # read-through and the engine keeps answering (misses refill
        # from prefill).  replicate= arms per-shard write-ahead
        # journaling + hot-standby replication (journal_dir=None keeps
        # it in memory): shard loss then promotes the standby instead of
        # cold-rewarming.
        self.pool = BlockPool(api.cfg, hbm_blocks, block_size,
                              dtype=L.dtype_of(api.cfg), n_shards=n_shards,
                              max_hbm_blocks=max_hbm_blocks,
                              rebalance_headroom=rebalance_headroom,
                              autotune=autotune, faults=faults,
                              io_retry=io_retry, replicate=replicate,
                              journal_dir=journal_dir, device=device)
        self.device = self.pool.device
        self.mgr = PagedKVManager(api.cfg, self.pool)
        self.max_batch = max_batch
        self.max_blocks = max_blocks_per_seq
        # engine-tier telemetry (pool/policy keep their own sinks;
        # obs_snapshot() merges the whole stack)
        self.obs = obs_mod.ObsSink(src="serving") if obs is None else obs
        self._c_requests = self.obs.counter(
            "serve_requests_total", (), "requests completed").labels()
        self._c_tokens = self.obs.counter(
            "serve_tokens_total", (), "tokens generated (incl. the "
            "prefill token)").labels()
        self._h_latency = self.obs.histogram(
            "serve_request_latency_seconds", (),
            "admit -> completion wall time per request").labels()
        self._h_decode = self.obs.histogram(
            "serve_decode_step_seconds", (),
            "one batched decode step, wall time").labels()
        depth_fam = self.obs.gauge(
            "serve_queue_depth", ("stage",),
            "requests pending admission / actively decoding")
        self._g_pending = depth_fam.labels("pending")
        self._g_active = depth_fam.labels("active")
        self._admit_ts: Dict[int, float] = {}

    def _tensor(self, rows, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows), dtype=dtype,
                               device=self.device)

    # -- prefill ------------------------------------------------------------------
    def _prefill_into_pool(self, st, fill_blocks: List[int]) -> int:
        """Run the prefill, write the missing blocks' KV, and return
        the first generated token (greedy).  Prefix-cache hits avoid
        block writes and deduplicate device memory (two sequences share
        physical blocks); logits still require the full forward here."""
        n_real = len(st.tokens)
        bs = self.pool.bs
        pad = (-n_real) % bs  # length bucketing, as the reference
        toks = self._tensor([list(st.tokens) + [0] * pad], torch.long)
        with torch.no_grad():  # params live out of a train step need no graph
            logits, cache = self.api.prefill(self.params, toks,
                                             full_logits=True)
        k = cache.k[:, 0]  # (L, S, H, hd)
        v = cache.v[:, 0]
        for b in fill_blocks:
            lo, hi = b * bs, min((b + 1) * bs, n_real)
            kb = torch.zeros((self.cfg.n_layers, bs) + k.shape[2:],
                             dtype=k.dtype, device=k.device)
            vb = torch.zeros_like(kb)
            kb[:, :hi - lo] = k[:, lo:hi]
            vb[:, :hi - lo] = v[:, lo:hi]
            self.pool.write_block(st.slots[b], kb, vb, key=st.block_keys[b])
        return int(torch.argmax(logits[0, n_real - 1]))

    # -- execution primitives (what the scheduler drives) ------------------------
    def _max_seq_blocks(self) -> int:
        """Blocks one sequence may ever hold: pool capacity, bounded by
        the block-table width."""
        return min(self.pool.n_blocks, self.max_blocks)

    def _oversize(self, r: Request) -> bool:
        """A prompt + decode tail needing more blocks than the pool can
        pin can never be served; it is rejected explicitly."""
        need = -(-(len(r.prompt) + r.max_new) // self.pool.bs)
        return need > self._max_seq_blocks()

    def _start(self, r: Request, tenant: str = "default") -> int:
        """Admit + prefill one request; returns its first token."""
        self._admit_ts[r.req_id] = time.perf_counter()
        st, fill = self.mgr.admit(r.req_id, r.prompt, tenant=tenant)
        first = self._prefill_into_pool(st, fill)
        st.out_tokens.append(first)  # from prefill logits
        return first

    def _decode_step(self, ids: List[int]) -> Dict[int, int]:
        """One decode step for the sequences in ``ids`` (<= max_batch):
        each sequence's newest token (at position pos) writes its KV at
        pos and attends to [0, pos].  Returns {req_id: next token}.

        The moe family's batch is padded to ``max_batch`` by repeating
        the last row, as the reference pads every batch: the experts'
        capacity grows with the batch's token count, so an unpadded
        batch could drop assignments the reference keeps.  The padded
        rows come after the real rows in the routing order, so they take
        no real row's capacity, and name the last row's KV slot, where
        the model writes the real row's k/v (``forward_decode_paged``).
        A dense or vlm row's output does not depend on the other rows,
        so their batch is not padded."""
        toks, poss, bts, sids, soffs = [], [], [], [], []
        for rid in ids:
            st = self.mgr.seqs[rid]
            pos = st.length - 1           # position of the token processed
            toks.append(st.out_tokens[-1])
            poss.append(pos)
            slot, off = self.mgr.slot_for_pos(rid, pos)
            sids.append(slot)
            soffs.append(off)
            bts.append(self.mgr.block_table(rid, self.max_blocks))
        if self.cfg.family == "moe":
            for rows in (toks, poss, sids, soffs, bts):
                rows.extend(rows[-1:] * (self.max_batch - len(rows)))
        t_step = time.perf_counter()
        with torch.no_grad():
            logits, _, _ = self.api.decode_paged(
                self.params, self._tensor(toks, torch.long)[:, None],
                self.pool.kpool, self.pool.vpool, self._tensor(np.stack(bts)),
                self._tensor(poss), self._tensor(sids), self._tensor(soffs))
        nxt = torch.argmax(logits[:, 0], dim=-1).tolist()
        self._h_decode.observe(time.perf_counter() - t_step)
        out = {}
        for i, rid in enumerate(ids):
            tok = int(nxt[i])
            self.mgr.seqs[rid].out_tokens.append(tok)
            out[rid] = tok
        self.mgr.maintenance()
        return out

    def _finish(self, rid: int) -> Completion:
        """Release a completed sequence + engine-tier telemetry."""
        st = self.mgr.seqs[rid]
        done = Completion(rid, list(st.out_tokens))
        self._h_latency.observe(
            time.perf_counter() - self._admit_ts.pop(rid))
        self._c_requests.value += 1
        self._c_tokens.value += len(st.out_tokens)
        self.mgr.release(rid)
        return done

    # -- main loop: thin client of the continuous-batching scheduler -------------
    def run(self, requests: List[Request],
            arrivals: Optional[List[int]] = None, *,
            config: Optional[SchedConfig] = None,
            seed: int = 0) -> List[Completion]:
        """Serve ``requests`` through the admission-controlled scheduler.
        ``arrivals[i]`` staggers submission over virtual ticks (default:
        everything at once); ``Request.deadline`` is interpreted relative
        to submission.  Returns one Completion per request — completed,
        shed, or rejected — in termination order."""
        sched = self.make_scheduler(config=config, seed=seed)
        base = sched.clock.now
        sreqs = [SchedRequest(
            req_id=r.req_id, prompt_len=len(r.prompt), max_new=r.max_new,
            priority=r.priority,
            deadline=(base + int(a or 0) + r.deadline) if r.deadline else 0,
            tenant=r.tenant, payload=r)
            for r, a in zip(requests,
                            arrivals or [0] * len(requests))]
        abs_arrivals = None if arrivals is None \
            else [base + int(a) for a in arrivals]
        outs = sched.run(sreqs, abs_arrivals)
        self._g_pending.set(float(len(sched.queue)))
        self._g_active.set(float(len(sched.active)))
        self._last_scheduler = sched
        return [Completion(o.req_id, o.tokens, status=o.status)
                for o in outs]

    def make_scheduler(self, *, config: Optional[SchedConfig] = None,
                       seed: int = 0) -> Scheduler:
        """A scheduler wired to this engine: executes on the model,
        reads backpressure from the pool (free-block watermark), runs on
        the pool's virtual clock, and reports into the engine's obs sink
        (one merged stack snapshot)."""
        cfg = config or SchedConfig(max_batch=self.max_batch)
        return Scheduler(EngineExecutor(self), config=cfg,
                         clock=self.pool.io_clock(), seed=seed, obs=self.obs)

    # -- compat shim: the pre-scheduler synchronous loop --------------------------
    def run_sync(self, requests: List[Request]) -> List[Completion]:
        """The old synchronous loop: FIFO admission up to ``max_batch``,
        no priorities, no deadlines, no backpressure.  Kept as the
        reference path the scheduler's greedy tokens are held against."""
        pending, done = [], []
        for r in requests:
            if self._oversize(r):
                done.append(Completion(r.req_id, [], status="rejected"))
            else:
                pending.append(r)
        active: Dict[int, Request] = {}
        while pending or active:
            while pending and len(active) < self.max_batch:
                r = pending.pop(0)
                self._start(r)
                active[r.req_id] = r
            for rid in [rid for rid, r in active.items()
                        if len(self.mgr.seqs[rid].out_tokens) >= r.max_new]:
                done.append(self._finish(rid))
                del active[rid]
            self._g_pending.set(float(len(pending)))
            self._g_active.set(float(len(active)))
            if not active:
                continue
            self._decode_step(sorted(active))
        return done

    def cache_mrc(self, capacities=None, **kw):
        """What-if MRC of the KV block pool at alternative device budgets
        (requires ``autotune=``) — see ``BlockPool.estimate_mrc``."""
        return self.pool.estimate_mrc(capacities, **kw)

    def obs_snapshot(self) -> "obs_mod.Snapshot":
        """One merged snapshot of the whole serving stack: engine
        latencies/queue depths + pool swaps + policy hit/flow counters
        (+ tuner, when autotuning)."""
        return obs_mod.merge([self.obs.snapshot(), self.pool.obs_snapshot()])

    @property
    def stats(self):
        """(pool stats, Clock2Q+ flow counters)."""
        return self.pool.stats, dict(self.pool.policy.flows)

    @property
    def degraded(self) -> bool:
        """True while the pool serves read-through (host IO shed by the
        circuit breaker under sustained injected/real failure)."""
        return self.pool.degraded


class EngineExecutor:
    """The ``Scheduler``'s executor surface over a ``ServingEngine``:
    prefill/decode/release run the model against the paged pool, and the
    capacity/backpressure reads come straight from the pool."""

    def __init__(self, eng: ServingEngine):
        self.eng = eng
        self.block_size = eng.pool.bs
        self.n_blocks = eng._max_seq_blocks()

    @property
    def degraded(self) -> bool:
        """The pool's read-through flag."""
        return self.eng.pool.degraded

    def free_fraction(self) -> float:
        """Fraction of the device block budget not pinned."""
        return self.eng.pool.free_fraction()

    def prefill(self, r: SchedRequest) -> int:
        """Admit and prefill ``r``; returns its first token."""
        return self.eng._start(r.payload, tenant=r.tenant)

    def decode(self, ids: List[int]) -> Dict[int, int]:
        """One decode step for ``ids``; returns {req_id: token}."""
        return self.eng._decode_step(ids)

    def release(self, rid: int) -> None:
        """Release a finished sequence."""
        self.eng._finish(rid)
