#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's two paths on one CUDA card, through the hand-written
Hopper kernels, all built from the sources under
``src/repro_torch/kernels/*/csrc/`` at first use (one ``nvcc`` each,
started together):

* the Clock2Q+ replay and MRC-sweep path: block-key traces through the
  ``cache_sim`` kernel, as batched sweeps over the SUITE traces and as
  chunked replays, held with tolerance 0 against the kernel's plain
  PyTorch version and the pure-Python Clock2Q+ oracle;
* the paged serving path: ``granite-3-8b`` at full width and depth
  (random bf16 weights from a seeded generator) behind the
  continuous-batching ``ServingEngine``, prefill through the
  ``flash_attention`` kernel and decode through ``paged_attention``,
  with the KV pool under Clock2Q+ and a host tier.  Both kernels are
  held against their plain versions at granite's widths, and the decode
  path against a teacher-forced prefill on a 4-layer fp32 cut.

Each phase prints one JSON line.  Then come the ``kernels`` line, the
card's name and power limit as ``nvidia-smi`` gives them, and the result
line.  Any mismatch or error exits non-zero before the result line, and
so does a machine without CUDA.

    python3 chip_smoke.py            # from the repository root
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PREFIX = 8192               # kernel_vs_plain: requests per trace
CHUNK = 65_536              # main_path: replay_chunked chunk size
LONG_N = 4_000_000          # long_stream: data requests before derivation
LONG_CHUNK = 1 << 20        # long_stream: replay_chunked chunk size
SWEEP_FRACS = (0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.35, 0.5)
SWEEP_WINDOWS = (0.1, 0.3, 0.5, 1.0)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12    # H100 SXM 32-bit rate outside the tensor cores
STEP_OPS = 16               # integer ops of one step, clock scan excluded


def emit(obj) -> None:
    """Print one JSON line, flushed (the run's output is read at its end)."""
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    """Fail the run (non-zero exit, no result line) unless ``ok``."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, reps: int = 1, flush=None) -> list:
    """CUDA-event times of ``reps`` calls of ``fn`` (ms each).  With
    ``flush`` (a large device tensor), the L2 cache is flushed before
    each call by zeroing it, which also keeps the card busy while the
    host prepares the launch, so the host's overhead is not timed."""
    out = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def clone(state):
    """A deep copy of a state dict of tensors."""
    return {k: v.clone() for k, v in state.items()}


def state_err(a, b) -> int:
    """Largest absolute difference over every tensor of two states."""
    return max(int((a[k].long() - b[k].long()).abs().max()) for k in a)


def pow2(n: int) -> int:
    """The sweep's table size: the next power of two above ``n``."""
    return 1 << max(1, n - 1).bit_length()


# -- the serving path -----------------------------------------------------------


BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 3e-2)}  # flash, paged
SERVE = dict(block_size=16, hbm_blocks=1024, max_batch=8,
             max_blocks_per_seq=160)
TOKEN_BUDGET = 16_384       # prefill tokens one scheduler tick may commit
PREFIX_LEN, N_PREFIXES = 1024, 4
SUFFIX = (64, 960)          # unique suffix length range, inclusive
MAX_NEW = 32
CONSISTENCY_LAYERS = 4
NEAR_TIE = 1e-3             # top-2 logit margin below which a flip is a tie


def _err(got, want, tol: float):
    """(max |got - want|, whether every element is within tol + tol|want|)."""
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), bool((diff <= tol + tol * want.float().abs())
                                   .all())


def warm_ms(fn, flush, reps: int = 20) -> list:
    """``cuda_ms`` of ``reps`` calls after one warm-up call, each with the
    L2 cache flushed by a 1 GiB write."""
    fn()
    return cuda_ms(fn, reps, flush)


def paged_inputs(dev, dtype, lengths, rng, N=1024, nb=160, H=32, Hkv=8,
                 d=128, bs=16):
    """Decode-attention inputs at granite's widths: a random pool, block
    tables that are rows of random permutations of the pool."""
    B = len(lengths)
    g = lambda *s: torch.from_numpy(
        rng.normal(0, 1, s).astype(np.float32)).to(dev, dtype)
    q, kp, vp = g(B, H, d), g(N, bs, Hkv, d), g(N, bs, Hkv, d)
    bt = torch.from_numpy(np.stack([rng.permutation(N)[:nb]
                                    for _ in range(B)]).astype(np.int32))
    lens = torch.as_tensor(np.asarray(lengths, np.int32))
    return q, kp, vp, bt.to(dev), lens.to(dev)


def _bound(moved: int, ops: float):
    """(bound_ms, bound_by, bytes, ops): the larger of the bytes at the
    memory rate and the flops at the bf16 tensor-core rate."""
    bytes_ms, ops_ms = 1e3 * moved / HBM_BYTES_PER_S, 1e3 * ops / BF16_OPS_PER_S
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, moved, ops


def paged_bound(lengths, H=32, Hkv=8, d=128, bs=16, esize=2):
    """``_bound`` of one decode-attention call: K and V of every real
    position read once, q read, out written, the block-table entries the
    sequences use read; 4 flops per position, query head and dim (QK
    and PV)."""
    tot = int(sum(lengths))
    B = len(lengths)
    moved = (2 * tot * Hkv * d * esize + 2 * B * H * d * esize
             + 4 * sum(-(-n // bs) for n in lengths) + 4 * B)
    return _bound(moved, 4 * tot * H * d)


def flash_bound(B, S, H, Hkv, d, causal, esize=2):
    """``_bound`` of one prefill-attention call: q, k, v read once and
    out written; 4 * B * H * d * (S^2 / 2 causal, S^2 full) flops."""
    moved = esize * (2 * B * S * H * d + 2 * B * S * Hkv * d)
    return _bound(moved, 4 * B * H * d * (S * S / 2 if causal else S * S))


def attn_kernels_vs_plain(dev):
    """Each attention kernel against its plain version on the card, at
    granite's widths, fp32 and bf16; returns the phase record."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    rec = dict(phase="attn_kernels_vs_plain", paged=[], flash=[])
    lengths = [1, 16, 17, 1024, 2560] + [int(x) for x in
                                         rng.integers(2, 2561, 3)]
    for dt in ("float32", "bfloat16"):
        args = paged_inputs(dev, getattr(torch, dt), lengths, rng)
        got = pops.paged_attention(*args)
        want = paged_attention_plain(*args)
        err, ok = _err(got, want, ATTN_TOL[dt][1])
        require(ok, f"paged_attention {dt} != plain (max err {err})")
        rec["paged"].append(dict(dtype=dt, B=8, H=32, Hkv=8, d=128, bs=16,
                                 N=1024, nb=160, lengths=lengths,
                                 tol=ATTN_TOL[dt][1], max_abs_err=err))
    cases = [(S, True, 128) for S in (1, 17, 128, 1000, 2048)]
    cases += [(S, False, 128) for S in (1, 17, 128, 1000, 2048)]
    cases += [(1000, True, 80)]
    for dt in ("float32", "bfloat16"):
        for S, causal, hd in cases:
            g = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(
                np.float32)).to(dev, getattr(torch, dt))
            q, k, v = g(1, S, 32, hd), g(1, S, 8, hd), g(1, S, 8, hd)
            got = fops.flash_attention(q, k, v, causal=causal)
            want = flash_attention_plain(q, k, v, causal)
            err, ok = _err(got, want, ATTN_TOL[dt][0])
            require(ok, f"flash_attention {dt} S={S} causal={causal} "
                        f"hd={hd} != plain (max err {err})")
            rec["flash"].append(dict(dtype=dt, B=1, S=S, H=32, Hkv=8, hd=hd,
                                     causal=causal, tol=ATTN_TOL[dt][0],
                                     max_abs_err=err))
    torch.cuda.synchronize()

    # the plain versions' times, at the bf16 check shapes, beside the
    # kernels' at the same shapes
    flush = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    args = paged_inputs(dev, torch.bfloat16, lengths, rng)
    rec["paged_plain_ms"] = statistics.median(warm_ms(
        lambda: paged_attention_plain(*args), flush, 5))
    rec["paged_kernel_ms"] = statistics.median(warm_ms(
        lambda: pops.paged_attention(*args), flush, 5))
    g = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(
        np.float32)).to(dev, torch.bfloat16)
    q, k, v = g(1, 2048, 32, 128), g(1, 2048, 8, 128), g(1, 2048, 8, 128)
    rec["flash_plain_ms"] = statistics.median(warm_ms(
        lambda: flash_attention_plain(q, k, v, True), flush, 5))
    rec["flash_kernel_ms"] = statistics.median(warm_ms(
        lambda: fops.flash_attention(q, k, v, causal=True), flush, 5))
    rec["plain_shapes"] = dict(
        paged="bf16, B=8, H=32, Hkv=8, d=128, bs=16, N=1024, nb=160, "
              f"lengths {lengths}",
        flash="bf16, B=1, S=2048, H=32, Hkv=8, hd=128, causal")
    rec["max_abs_err"] = dict(
        paged=max(r["max_abs_err"] for r in rec["paged"]),
        flash=max(r["max_abs_err"] for r in rec["flash"]))
    rec["seconds"] = time.perf_counter() - t0
    return rec


def make_requests(n: int, seed: int, vocab: int):
    """``n`` requests: each prompt is one of ``N_PREFIXES`` shared
    1,024-token prefixes (a system prompt or few-shot template shared by
    tenants) plus a unique suffix of 64-960 tokens; ``MAX_NEW`` new
    tokens each."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab, PREFIX_LEN).tolist()
                for _ in range(N_PREFIXES)]
    return [Request(i, prefixes[i % N_PREFIXES] + rng.integers(
        0, vocab, int(rng.integers(SUFFIX[0], SUFFIX[1] + 1))).tolist(),
        max_new=MAX_NEW, tenant=f"t{i % N_PREFIXES}") for i in range(n)]


def _instrument(eng):
    """Time the engine's prefill and decode steps (host clock; both end
    in a device-to-host read of the chosen tokens, so the device work is
    inside) and record each decode step's context lengths."""
    rec = dict(prefill_s=[], prompt_lens=[], decode_s=[], decode_lens=[])
    prefill, decode = eng._prefill_into_pool, eng._decode_step

    def timed_prefill(st, fill):
        t0 = time.perf_counter()
        out = prefill(st, fill)
        rec["prefill_s"].append(time.perf_counter() - t0)
        rec["prompt_lens"].append(len(st.tokens))
        return out

    def timed_decode(ids):
        rec["decode_lens"].append([eng.mgr.seqs[r].length for r in ids])
        t0 = time.perf_counter()
        out = decode(ids)
        rec["decode_s"].append(time.perf_counter() - t0)
        return out

    eng._prefill_into_pool = timed_prefill
    eng._decode_step = timed_decode
    return rec


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def serve_main(dev):
    """Full-width, full-depth granite-3-8b behind the serving engine;
    returns (phase record, launches per kernel, the run's decode context
    lengths as 8 octile midpoints)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.cache_sim import ops as cops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.models.model import build
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedConfig

    t0 = time.perf_counter()
    cfg = get_config("granite-3-8b")
    api = build(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServingEngine(api, params, device=dev, **SERVE)
    reqs = make_requests(32, seed=0, vocab=cfg.vocab)
    api.prefill(params, torch.zeros((1, 64), dtype=torch.long, device=dev))
    torch.cuda.synchronize()                       # warm-up, off the pool
    rec = _instrument(eng)

    fops.launch_count = pops.launch_count = cops.launch_count = 0
    t1 = time.perf_counter()
    outs = eng.run(reqs, config=SchedConfig(max_batch=SERVE["max_batch"],
                                            token_budget=TOKEN_BUDGET))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(flash_attention=fops.launch_count,
                    paged_attention=pops.launch_count,
                    cache_sim=cops.launch_count)

    stats, flows = eng.stats
    done = [c for c in outs if c.status == "completed"]
    require(len(done) == 32 and all(len(c.tokens) == MAX_NEW for c in done),
            f"serve_main: {len(done)} of 32 completed "
            f"({[(c.req_id, c.status, len(c.tokens)) for c in outs]})")
    require(launches["flash_attention"] > 0 and
            launches["paged_attention"] > 0,
            f"serve_main: a kernel of the path was never launched "
            f"{launches}")
    require(stats.hits > 0, "serve_main: no prefix hit in the pool")
    require(stats.swap_out > 0, "serve_main: no swap to the host tier")
    vocab_ok = all(0 <= t < cfg.vocab for c in done for t in c.tokens)
    require(vocab_ok, "serve_main: a token outside the vocabulary")
    # the run's context lengths as 8 rows: the octile midpoints of every
    # decode row's length
    rows = np.concatenate([np.asarray(x) for x in rec["decode_lens"]])
    med = [int(np.percentile(rows, 100 * (2 * i + 1) / 16)) for i in range(8)]
    out_tokens = sum(len(c.tokens) for c in done)
    phase = dict(
        phase="serve_main", model=cfg.name, n_layers=cfg.n_layers,
        d_model=cfg.d_model, dtype=cfg.dtype, n_params=cfg.n_params(),
        weights="random, torch.Generator(cuda).manual_seed(0)",
        engine=SERVE, token_budget=TOKEN_BUDGET, requests=32,
        prefix_len=PREFIX_LEN, n_prefixes=N_PREFIXES, suffix=SUFFIX,
        max_new=MAX_NEW, completed=len(done), init_s=init_s,
        wall_s=wall, requests_per_s=32 / wall,
        output_tokens_per_s=out_tokens / wall,
        prefill_ms_p50=_pct(rec["prefill_s"], 50),
        prefill_ms_p99=_pct(rec["prefill_s"], 99),
        prefills=len(rec["prefill_s"]),
        prompt_len_range=[min(rec["prompt_lens"]), max(rec["prompt_lens"])],
        decode_step_ms_p50=_pct(rec["decode_s"], 50),
        decode_step_ms_p99=_pct(rec["decode_s"], 99),
        decode_steps=len(rec["decode_s"]),
        decode_batch_mean=float(np.mean([len(x) for x in
                                         rec["decode_lens"]])),
        decode_lengths_octiles=med,
        pool=dataclasses.asdict(stats), hit_ratio=stats.hit_ratio,
        flows=flows, host_blocks=len(eng.pool.host),
        peak_device_bytes=torch.cuda.max_memory_allocated(dev),
        launches=launches)
    del eng
    torch.cuda.empty_cache()
    phase["profile"] = serve_profile(dev, api, params)
    del params, api
    torch.cuda.empty_cache()
    return phase, launches, med


def serve_profile(dev, api, params):
    """A short serving run (4 requests of the same shape, 8 new tokens
    each, a fresh pool) under ``torch.profiler``: the device's busy share
    of the wall time (one stream, so kernel times add up without
    overlap), and device time by kernel.  The profiler's own host cost
    inflates the wall time, so the busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedConfig

    eng = ServingEngine(api, params, device=dev, **SERVE)
    reqs = make_requests(4, seed=3, vocab=api.cfg.vocab)
    for r in reqs:
        r.max_new = 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs, config=SchedConfig(max_batch=SERVE["max_batch"],
                                         token_budget=TOKEN_BUDGET))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    kernels = sorted((e for e in prof.key_averages() if dev_us(e) > 0 and
                      not e.key.startswith("aten::")),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    group = {"flash_attention": 0.0, "paged_attention": 0.0, "gemm": 0.0,
             "other": 0.0}
    for e in kernels:
        k = "flash_attention" if "flash_attention_kernel" in e.key else \
            "paged_attention" if "paged_attention_" in e.key else \
            "gemm" if any(w in e.key for w in ("gemm", "nvjet", "sm90_xmma")) \
            else "other"
        group[k] += dev_us(e) / 1e3
    cpu_launch = sum(e.self_cpu_time_total for e in prof.key_averages()
                     if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    del eng
    return dict(requests=4, max_new=8, wall_ms=1e3 * wall,
                device_busy_ms=busy_ms, device_busy_share=busy_ms / 1e3 / wall,
                device_ms_by_group=group,
                launch_api_cpu_ms=cpu_launch / 1e3,
                kernel_launches=sum(e.count for e in kernels),
                top=[dict(name=e.key[:70], ms=dev_us(e) / 1e3, calls=e.count)
                     for e in kernels[:8]])


def serve_consistency(dev):
    """The decode kernel's path against the prefill kernel's path on the
    whole model: granite-3-8b at full width in fp32, depth cut to 4
    layers, 8 requests; a teacher-forced ``forward_prefill`` over each
    prompt and its generated tokens must pick the engine's token at every
    generated position, near ties (top-2 margin < 1e-3) excepted and
    reported."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedConfig

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              n_layers=CONSISTENCY_LAYERS, dtype="float32",
                              param_dtype="float32")
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServingEngine(api, params, device=dev, **SERVE)
    reqs = make_requests(8, seed=1, vocab=cfg.vocab)
    outs = eng.run(reqs, config=SchedConfig(max_batch=SERVE["max_batch"],
                                            token_budget=TOKEN_BUDGET))
    by_id = {c.req_id: c for c in outs}
    require(all(by_id[r.req_id].status == "completed" and
                len(by_id[r.req_id].tokens) == MAX_NEW for r in reqs),
            "serve_consistency: a request did not complete")
    compared, mismatches, ties = 0, [], []
    for r in reqs:
        gen = by_id[r.req_id].tokens
        toks = torch.tensor([r.prompt + gen[:-1]], dtype=torch.long,
                            device=dev)
        logits, _ = api.prefill(params, toks, full_logits=True)
        lg = logits[0, len(r.prompt) - 1:].float()
        top2 = torch.topk(lg, 2, dim=-1)
        pick = top2.indices[:, 0].tolist()
        margin = (top2.values[:, 0] - top2.values[:, 1]).tolist()
        for i, (want, got) in enumerate(zip(pick, gen)):
            compared += 1
            if want == got:
                continue
            item = dict(req=r.req_id, pos=i, engine=got, prefill=want,
                        margin=margin[i])
            (ties if margin[i] < NEAR_TIE else mismatches).append(item)
    require(not mismatches, f"serve_consistency: decode-path tokens != "
                            f"teacher-forced prefill tokens: {mismatches}")
    stats, _ = eng.stats
    rec = dict(phase="serve_consistency", model=cfg.name, dtype=cfg.dtype,
               reduced=[f"n_layers 40 -> {CONSISTENCY_LAYERS}"],
               requests=len(reqs), positions_compared=compared,
               mismatches=0, near_ties=ties, near_tie_margin=NEAR_TIE,
               pool=dataclasses.asdict(stats),
               allow_tf32=torch.backends.cuda.matmul.allow_tf32,
               seconds=time.perf_counter() - t0)
    del eng, params, api
    torch.cuda.empty_cache()
    return rec


def attn_kernel_time(dev, lengths):
    """CUDA-event medians of each attention kernel at serve_main's
    shapes (paged: B = 8 rows at the run's decode context lengths), L2 flushed between launches, beside its bound and one
    ``scaled_dot_product_attention`` call as a yardstick (never called
    by the port)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops

    rng = np.random.default_rng(2)
    flush = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    q, kp, vp, bt, lens = paged_inputs(dev, torch.bfloat16, lengths, rng)
    before = pops.launch_count
    p_runs = warm_ms(lambda: pops.paged_attention(q, kp, vp, bt, lens),
                          flush)
    require(pops.launch_count == before + len(p_runs) + 1,
            "timed paged call not one launch each")
    p_bound, p_by, p_bytes, p_ops = paged_bound(lengths)
    # the yardstick: K/V gathered to contiguous (B, S, Hkv, d) storage
    # first (not timed), a boolean length mask
    B, S = len(lengths), max(lengths)
    nbk = -(-S // 16)
    kc = kp[bt[:, :nbk].long()].reshape(B, -1, 8, 128)[:, :S]
    vc = vp[bt[:, :nbk].long()].reshape(B, -1, 8, 128)[:, :S]
    kc, vc = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=dev)[None] < lens[:, None].long()
            )[:, None, None, :]
    qs = q[:, :, None, :]
    p_lib = warm_ms(lambda: F.scaled_dot_product_attention(
        qs, kc, vc, attn_mask=mask, enable_gqa=True), flush)
    ref = F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask,
                                         enable_gqa=True)[:, :, 0]
    lib_err = float((ref.float() - pops.paged_attention(
        q, kp, vp, bt, lens).float()).abs().max())

    g = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(
        np.float32)).to(dev, torch.bfloat16)
    S = 2048
    fq, fk, fv = g(1, S, 32, 128), g(1, S, 8, 128), g(1, S, 8, 128)
    before = fops.launch_count
    f_runs = warm_ms(lambda: fops.flash_attention(fq, fk, fv, True),
                          flush)
    require(fops.launch_count == before + len(f_runs) + 1,
            "timed flash call not one launch each")
    f_bound, f_by, f_bytes, f_ops = flash_bound(1, S, 32, 8, 128, True)
    tq, tk, tv = (t.transpose(1, 2) for t in (fq, fk, fv))
    f_lib = warm_ms(lambda: F.scaled_dot_product_attention(
        tq, tk, tv, is_causal=True, enable_gqa=True), flush)
    p_ms, f_ms = statistics.median(p_runs), statistics.median(f_runs)
    f_lib_ms = statistics.median(f_lib)
    return dict(
        phase="attn_kernel_time",
        paged=dict(shape=f"bf16, B={B}, H=32, Hkv=8, d=128, bs=16, "
                         f"lengths {lengths}", ms_runs=p_runs, ms=p_ms,
                   bytes=p_bytes, ops=p_ops, bound_ms=p_bound, bound_by=p_by,
                   roofline_share=p_bound / p_ms,
                   library_ms=statistics.median(p_lib),
                   library="scaled_dot_product_attention over K/V gathered "
                           "to contiguous storage (gather not timed), "
                           "boolean length mask, enable_gqa",
                   library_max_abs_err=lib_err),
        flash=dict(shape="bf16, B=1, S=2048, H=32, Hkv=8, hd=128, causal",
                   ms_runs=f_runs, ms=f_ms, bytes=f_bytes, ops=f_ops,
                   bound_ms=f_bound, bound_by=f_by,
                   roofline_share=f_bound / f_ms,
                   tflops=f_ops / f_ms / 1e9,
                   library_ms=f_lib_ms,
                   library="scaled_dot_product_attention, is_causal, "
                           "enable_gqa"),
        l2_flush_bytes=flush.numel() * 4)


def main() -> int:
    """Run every phase; returns the exit code."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import torch_engine as te
    from repro_torch.core import traces
    from repro_torch.core.engine import (
        get_engine, grid_hit_arrays, grid_hit_counts, grid_init, replay,
        replay_chunked,
    )
    from repro_torch.core.policies.clock2qplus import Clock2QPlus
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.cache_sim import build, ops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.cache_sim.ref import cache_sim_plain
    from repro_torch.tuning.sweep import make_grid, relabel, sweep_hits

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    # -- device: the card, the toolchain, the kernel builds --------------------
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kbuild.build_many([("cache_sim", build.SOURCE),
                       ("flash_attention", fops.SOURCE),
                       ("paged_attention", pops.SOURCE)])
    build_s = time.perf_counter() - t0
    build.load()
    emit(dict(phase="device", device=kind, count=torch.cuda.device_count(),
              nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
              build_s=build_s, builds={
                  k: kbuild.info(k) for k in
                  ("cache_sim", "flash_attention", "paged_attention")}))

    t0 = time.perf_counter()
    data = {s.name: s.data() for s in traces.SUITE}
    all_traces = []
    for s in traces.SUITE:
        all_traces.append((s.name, data[s.name]))
        all_traces.append((s.name + "/meta",
                           traces.derive_metadata(data[s.name])))
    gen_s = time.perf_counter() - t0

    # -- kernel_vs_plain: tolerance 0 on every hit and state tensor ------------
    phase_t0 = time.perf_counter()
    picks = ["w01-skewed", "w04-scans", "w02-balanced/meta",
             "w08-random/meta"]
    named = dict(all_traces)
    rows, configs = [], []
    for name in picks:
        d, u = relabel(named[name][:PREFIX])
        fp = len(np.unique(d))
        caps = [max(8, int(fp * f)) for f in (0.01, 0.1, 0.5)]
        cfgs = make_grid(caps, (0.1, 1.0))
        c10 = max(8, int(fp * 0.1))
        cfgs += [get_engine("clock2q+").config(c10, skip_limit=2),
                 get_engine("clock2q+").config(c10, skip_limit=16),
                 get_engine("clock2q").config(max(8, int(fp * 0.05))),
                 get_engine("clock2q").config(max(8, int(fp * 0.5)))]
        rows += [d] * len(cfgs)
        configs += cfgs
    universe = pow2(max(int(r.max()) + 1 for r in rows))
    per_lane = torch.as_tensor(np.stack(rows), device=dev)
    init = grid_init(configs, universe, device=dev)
    half = PREFIX // 2

    st_plain = clone(init)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h_a = cache_sim_plain(st_plain, per_lane[:, :half].contiguous())
    st_mid = clone(st_plain)
    h_b = cache_sim_plain(st_plain, per_lane[:, half:].contiguous())
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    h_plain = torch.cat([h_a, h_b], dim=1)

    launches0 = ops.launch_count
    st_k = clone(init)
    prefix_ms = cuda_ms(lambda: ops.cache_sim(st_k, per_lane, "hits"))[0]
    st_k = clone(init)
    h_k = ops.cache_sim(st_k, per_lane, "hits")
    err = max(int((h_k.long() - h_plain.long()).abs().max()),
              state_err(st_k, st_plain))
    require(err == 0, f"kernel != plain on the per-lane prefix (err {err})")
    # state round trip: plain for chunk 1, kernel for chunk 2
    h_rt = ops.cache_sim(st_mid, per_lane[:, half:].contiguous(), "hits")
    rt_err = max(int((h_rt.long() - h_k[:, half:].long()).abs().max()),
                 state_err(st_mid, st_k))
    require(rt_err == 0, f"plain->kernel state hand-over differs ({rt_err})")
    st_c = clone(init)
    counts = ops.cache_sim(st_c, per_lane, "counts")
    require(torch.equal(counts, h_k.sum(1)), "counts mode != hits mode")

    # the sweep's shape: one trace row shared by every lane
    d, u = relabel(named["w01-skewed"][:PREFIX])
    fp = len(np.unique(d))
    sgrid = make_grid([max(8, int(fp * f)) for f in SWEEP_FRACS],
                      SWEEP_WINDOWS)
    sinit = grid_init(sgrid, pow2(u), device=dev)
    shared = torch.as_tensor(d, device=dev)
    s_plain = clone(sinit)
    c_plain = cache_sim_plain(s_plain, shared, "counts")
    s_k = clone(sinit)
    c_k = ops.cache_sim(s_k, shared, "counts")
    s_err = max(int((c_k - c_plain).abs().max()), state_err(s_k, s_plain))
    require(s_err == 0, f"kernel != plain on the shared-trace sweep ({s_err})")
    max_abs_err = max(err, rt_err, s_err)
    emit(dict(phase="kernel_vs_plain", requests=PREFIX, lanes=len(configs),
              traces=picks, universe=universe,
              rings=[int(init[k].shape[1]) for k in ("skey", "mkey", "gkey")],
              skip_limit_lanes=sum(c.skip_limit > 0 for c in configs),
              clock2q_lanes=sum(c.policy == "clock2q" for c in configs),
              sweep_lanes=len(sgrid), tolerance=0, max_abs_err=max_abs_err,
              hits=int(h_k.sum()), kernel_ms=prefix_ms, plain_ms=plain_ms,
              compare_launches=ops.launch_count - launches0,
              trace_gen_s=gen_s, seconds=time.perf_counter() - phase_t0))

    # -- main_path: 16 full-length sweeps + oracle + chunked replays -----------
    # Sweep lanes held against the oracle on every trace: the smallest and
    # the largest capacity at the narrowest and the widest window.
    nw = len(SWEEP_WINDOWS)
    oracle_lanes = [ci * nw + wi for ci in (0, len(SWEEP_FRACS) - 1)
                    for wi in (0, nw - 1)]
    phase_t0 = time.perf_counter()
    ops.launch_count = 0
    per_trace = []
    for name, tr in all_traces:
        fp = traces.footprint(tr)
        grid = make_grid([max(8, int(fp * f)) for f in SWEEP_FRACS],
                         SWEEP_WINDOWS)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        hits = sweep_hits(tr, grid)
        sweep_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        mr = 1.0 - hits / len(tr)
        require(hits.shape == (len(grid),) and np.isfinite(mr).all()
                and ((mr >= 0) & (mr <= 1)).all(), f"{name}: bad sweep")

        # the same grid, per request: its sums are the sweep's counts, and
        # its oracle lanes equal the Python oracle request for request
        d, u = relabel(tr)
        t0 = time.perf_counter()
        lane_h = grid_hit_arrays(
            "clock2q+", grid_init(grid, pow2(u), device=dev),
            d).cpu().numpy()
        require(np.array_equal(lane_h.sum(1), hits),
                f"{name}: sweep counts != the grid's per-request hits")
        for i in oracle_lanes:
            c = grid[i]
            pol = Clock2QPlus(c.capacity, small_frac=c.small_frac,
                              ghost_frac=c.ghost_frac,
                              window_frac=c.window_frac,
                              skip_limit=c.skip_limit or None)
            oracle = np.fromiter((pol.access(k) for k in d.tolist()), bool,
                                 count=len(d))
            require(np.array_equal(lane_h[i], oracle),
                    f"{name}: sweep lane {i} ({c}) != oracle "
                    f"({int((lane_h[i] != oracle).sum())} requests differ)")
        lanes_oracle_s = time.perf_counter() - t0

        cap = traces.suite_capacity(d)
        t0 = time.perf_counter()
        st = te.init_state("clock2q+", cap, u)
        _, h = replay("clock2q+", st, d)
        h = h[0].cpu().numpy()
        replay_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pol = Clock2QPlus(cap)
        oracle = np.fromiter((pol.access(k) for k in d.tolist()), bool,
                             count=len(d))
        oracle_s = time.perf_counter() - t0
        require(np.array_equal(h, oracle),
                f"{name}: kernel != oracle at capacity {cap} "
                f"({int((h != oracle).sum())} requests differ)")
        t0 = time.perf_counter()
        ch, n, st_c = replay_chunked(
            "clock2q+", (d[i:i + CHUNK] for i in range(0, len(d), CHUNK)),
            cap, u)
        chunked_s = time.perf_counter() - t0
        require(ch == int(h.sum()) and n == len(d) and state_err(st_c, st) == 0,
                f"{name}: chunked replay != single shot")
        per_trace.append(dict(
            trace=name, requests=len(tr), unique=fp, lanes=len(grid),
            miss_ratios=[float(x) for x in mr], sweep_ms=1e3 * sweep_s,
            requests_x_lanes_per_s=len(tr) * len(grid) / sweep_s,
            peak_device_bytes=peak, suite_capacity=cap,
            suite_capacity_miss_ratio=1.0 - float(h.mean()),
            replay_s=replay_s, oracle_s=oracle_s, chunked_s=chunked_s,
            oracle_lanes=oracle_lanes, lanes_oracle_s=lanes_oracle_s,
            oracle_equal=True, chunked_equal=True))
    launches = ops.launch_count
    require(launches > 0, "the main path launched no cache_sim kernel")
    emit(dict(phase="main_path", launches=launches,
              seconds=time.perf_counter() - phase_t0, traces=per_trace))

    # -- long_stream: a day-scale metadata stream, chunked == single shot ------
    t0 = time.perf_counter()
    spec = dataclasses.replace(traces.SUITE[0], n=LONG_N)
    d, u = relabel(traces.derive_metadata(spec.data()))
    gen_s = time.perf_counter() - t0
    cap = traces.suite_capacity(d)
    st = te.init_state("clock2q+", cap, u)
    t0 = time.perf_counter()
    _, h = replay("clock2q+", st, d)
    single = int(h.sum())
    single_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ch, n, st_c = replay_chunked(
        "clock2q+", (d[i:i + LONG_CHUNK] for i in range(0, len(d), LONG_CHUNK)),
        cap, u)
    chunked_s = time.perf_counter() - t0
    require(ch == single and n == len(d) and state_err(st_c, st) == 0,
            "long stream: chunked replay != single shot")
    emit(dict(phase="long_stream", trace="w01-skewed/meta", seed=spec.seed,
              requests=len(d), unique=u, capacity=cap, chunk=LONG_CHUNK,
              miss_ratio=1.0 - single / len(d), single_shot_s=single_s,
              chunked_s=chunked_s, chunked_equal=True, trace_gen_s=gen_s))

    # -- kernel_time: the w01-skewed sweep, median of 3, with its bound --------
    tr = named["w01-skewed"]
    fp = traces.footprint(tr)
    grid = make_grid([max(8, int(fp * f)) for f in SWEEP_FRACS], SWEEP_WINDOWS)
    d, u = relabel(tr)
    shared = torch.as_tensor(d, device=dev)
    times = []
    for _ in range(3):
        states = grid_init(grid, pow2(u), device=dev)
        launches0 = ops.launch_count
        times += cuda_ms(lambda: grid_hit_counts("clock2q+", states, shared))
        require(ops.launch_count == launches0 + 1, "timed call not a launch")
    ms = statistics.median(times)
    L, T = len(grid), len(d)
    # The bytes the function touches: the shared trace once; per lane, the
    # u table entries the relabelled ids use (loc_w int8 + loc_s int32)
    # and each ring at its logical size (the padding is never touched),
    # read and written; the cursors read and written, the sizes read; the
    # counts written.
    ring_slots = {k: int(states[k].long().sum())
                  for k in ("scap", "mcap", "gcap")}
    touched = (L * u * (1 + 4) + ring_slots["scap"] * (4 + 1 + 4)
               + ring_slots["mcap"] * (4 + 1) + ring_slots["gcap"] * 4)
    moved = T * 4 + 2 * touched + L * 4 * (2 * 4 + 5) + L * 8
    bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
    ops_ms = 1e3 * T * L * STEP_OPS / SCALAR_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    emit(dict(phase="kernel_time", trace="w01-skewed", lanes=L, requests=T,
              universe=pow2(u), unique=u, ring_slots=ring_slots,
              ms_runs=times, ms=ms,
              ns_per_step=1e6 * ms / T, bytes_moved=moved, bytes_ms=bytes_ms,
              ops_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by,
              roofline_share=bound_ms / ms))

    # -- the serving path: kernels, full model, consistency, kernel times ------
    check = attn_kernels_vs_plain(dev)
    emit(check)
    serve, serve_launches, med_lengths = serve_main(dev)
    emit(serve)
    emit(serve_consistency(dev))
    timing = attn_kernel_time(dev, med_lengths)
    emit(timing)
    pt, ft = timing["paged"], timing["flash"]

    emit({"kernels": [dict(
        name="cache_sim", route="cuda",
        source="src/repro_torch/kernels/cache_sim/csrc/cache_sim.cu",
        replaces="src/repro/kernels/cache_sim/cache_sim.py:46",
        launches=launches, max_abs_err=max_abs_err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,
        ms_shape=f"w01-skewed sweep: {L} lanes x {T} requests",
        plain_shape=f"{len(configs)} lanes x {PREFIX} requests",
        kernel_ms_at_plain_shape=prefix_ms, ns_per_step=1e6 * ms / T),
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/kernels/paged_attention/csrc/"
                    "paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/paged_attention.py:30",
             launches=serve_launches["paged_attention"],
             max_abs_err=check["max_abs_err"]["paged"], ms=pt["ms"],
             plain_ms=check["paged_plain_ms"], bound_ms=pt["bound_ms"],
             bound_by=pt["bound_by"], library_ms=pt["library_ms"],
             ms_shape=pt["shape"],
             plain_shape=check["plain_shapes"]["paged"],
             kernel_ms_at_plain_shape=check["paged_kernel_ms"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/flash_attention.py:25",
             launches=serve_launches["flash_attention"],
             max_abs_err=check["max_abs_err"]["flash"], ms=ft["ms"],
             plain_ms=check["flash_plain_ms"], bound_ms=ft["bound_ms"],
             bound_by=ft["bound_by"], library_ms=ft["library_ms"],
             ms_shape=ft["shape"],
             plain_shape=check["plain_shapes"]["flash"],
             kernel_ms_at_plain_shape=check["flash_kernel_ms"])]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
