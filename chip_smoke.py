#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's paths on one CUDA card, through the hand-written
Hopper kernels, all built from the sources under
``src/repro_torch/kernels/*/csrc/`` at first use (one ``nvcc`` each,
started together):

* the Clock2Q+ replay and MRC-sweep path: block-key traces through the
  ``cache_sim`` kernel, as batched sweeps over the SUITE traces and as
  chunked replays, held with tolerance 0 against the kernel's plain
  PyTorch version and the pure-Python Clock2Q+ oracle;
* the paper's policy comparison: every SUITE trace through one mixed
  sweep of Clock2Q+, Clock2Q, S3-FIFO (2- and 1-bit), FIFO, Clock and
  LRU lanes, each step family one launch (``cache_sim``, ``s3fifo_sim``,
  ``simple_sim``'s FIFO, Clock and LRU entry points), with the new
  kernels held at tolerance 0 against their plain versions and, at one
  capacity a trace, against the port's pure-Python policy zoo; it prints
  the miss ratios, Eq. 1 against Clock and the headline gap to S3-FIFO;
* the paged serving path: ``granite-3-8b`` at full width, 10 of its 40
  layers (random bf16 weights from a seeded generator) behind the
  continuous-batching ``ServingEngine``, prefill through the
  ``flash_attention`` kernel and decode through ``paged_attention``,
  with the KV pool under Clock2Q+ and a host tier.  Both kernels are
  held against their plain versions at granite's widths, and the decode
  path against a teacher-forced prefill on a 4-layer fp32 cut;
* the same serving path under chaos: the pool sharded 4 ways with a
  hot standby a shard (its write-ahead journal on disk), a seeded storm
  of IO errors, torn writes and delays with a shard loss, and the
  online tuner, whose rounds and ``cache_mrc`` launch ``cache_sim``;
  each shard's journal, recovered, and a snapshot of the sharded policy
  are held to the live bytes, and on the 4-layer fp32 cut the chaos
  engine's tokens to a fault-free twin's and a teacher-forced prefill;
* the SSM and hybrid models through the model API (``prefill``, then
  greedy ``decode`` steps): ``falcon-mamba-7b`` and ``zamba2-2.7b`` at
  full width, 24 of their 64 and 54 layers for the script's time
  (random bf16 weights), Mamba1's selective scan
  through the ``mamba_scan`` kernel and the hybrid's shared attention
  block through ``flash_attention`` (prefill) and ``paged_attention``
  (decode, on its KV cache seen as one page a sequence).  The scan
  kernel is held against
  its plain version (B and C strided as the model hands them over),
  ``flash_attention`` against its plain version on the shared block's
  own q, k, v at the hybrid's prefill shape, and each model's decode
  path against a teacher-forced prefill on an fp32 cut;
* the moe and vlm families behind the serving engine:
  ``olmoe-1b-7b`` (64 experts, top-8) at full width and depth,
  ``kimi-k2-1t-a32b`` at full width (384 experts, head_dim 112) cut to
  one layer, and ``llava-next-mistral-7b`` at full width and depth with
  a patch prefill beside its served requests (random bf16 weights),
  prefill through ``flash_attention`` and decode through
  ``paged_attention``, which are also held against their plain versions
  at olmoe's 16/16 heads and kimi-k2's head_dim 112; olmoe's decode
  path against a teacher-forced prefill on a dropless fp32 cut, and
  llava's patch prefill on the card against the port on the CPU;
* the contiguous-cache decode and the encoder-decoder through the model
  API: ``granite-3-8b`` at full width, 20 of its 40 layers, one prefill
  and greedy ``decode`` steps over its contiguous KV cache
  (``paged_attention`` on the cache seen as one page a sequence), its
  decode and the buffered decode (a ring committed to a head-major base)
  held against a teacher-forced prefill and each other on a 4-layer fp32
  cut; and
  ``whisper-tiny`` at its published size on 8 clips of 1,500 stub frame
  embeddings, the encoder, the decoder's prompt and its cross-attention
  through ``flash_attention`` (Sq != Skv) and greedy decode through
  ``paged_attention``, held against a teacher-forced prefill in fp32 and
  the port on the CPU.  Both kernels are also held against their plain
  versions on the one-page views and at whisper's shapes;
* training: ``olmo-1b`` at full width and depth (random bf16 weights)
  trained through ``training.step.make_train_step`` on batches of 8 x
  4,096 tokens from ``TokenPipeline`` (2 microbatches), each block
  recomputed in the backward pass, attention's gradient the
  hand-written ``flash_attention_bwd`` kernel, which is held against
  its plain version given the plain lse (with planted faults that must
  fail the limit) and timed beside SDPA's backward; a step of six
  families on the card against the CPU; olmo-1b's bf16 gradients at 2
  layers against its fp32 ones; the launcher resumed from a checkpoint
  bit for bit;
* training the ssm: ``falcon-mamba-7b`` at full width cut to 8 of its 64
  layers, trained the same way, the selective scan's gradient the
  hand-written ``mamba_scan_bwd`` kernel, which is held against its plain
  version from the forward kernel's states every 16 steps (with planted
  faults that must fail the limit by 10x) and timed beside its bound, its
  launch one resident wave; its bf16 gradients at 2 layers against its
  fp32 ones, within 5 %, where a planted scan fault must fail;
* the sharded train step: a world-1 NCCL process group in this process
  and a (1, 1) ``DeviceMesh``, olmo-1b (4 of 16 layers) and
  falcon-mamba-7b (2 of 64) at published width, their params, moments
  and batches DTensors placed by the sharding rules, two steps each held
  to the plain-tensor steps from the same seed, the kernels launched on
  the local shards as ``train_run`` launches them, and olmo's mesh
  state checkpointed and restored into a plain state bit for bit;
* the serving launcher: ``launch.serve.main`` on olmo-1b at its
  published size, 8 requests and a live pool shrink, every completion
  held to a teacher-forced prefill;
* the example scripts and tools as a user runs them (``examples/torch/``,
  ``tools/obsreport_torch.py``): the policy explorer's Clock2Q+ cross-
  check through ``cache_sim``, ``serve_paged`` (every completion held to
  a teacher-forced prefill), ``quickstart --smoke``, ``train_100m`` at
  its published size with a resumed rerun, and the incident timelines of
  the chaos pools.

Each phase prints one JSON line.  Then come the ``kernels`` line, the
card's name and power limit as ``nvidia-smi`` gives them, and the result
line.  Any mismatch or error exits non-zero before the result line, and
so does a machine without CUDA.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --previous DIR   # the kernels of the
                                           # checkout DIR beside these
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import pathlib
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
    ``flush`` (a large device tensor), the L2 cache is emptied before
    each call by reading the tensor through it: that leaves clean lines,
    so the call does not pay for writing back another kernel's data (as
    it would after a flush by writing), and keeps the card busy while
    the host prepares the launch, so the host's overhead is not timed."""
    out = []
    for _ in range(reps):
        if flush is not None:
            flush.sum()
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
# bf16 limit of the contiguous caches' one-page views and whisper's full
# attention over 1,500 frames: |got - want| <= 1e-3 + 3e-2 |want|.  Outputs
# that average 1,500 to 2,080 positions are about 0.03, so ATTN_TOL's 2e-2
# to 3e-2 absolute would pass a kernel that lost a page's partial tail.
NEW_BF16_TOL = (1e-3, 3e-2)             # atol, rtol
WGMMA_KV_TILE = 128     # flash_attention.cu kBN: KV rows per bf16 tile
SERVE = dict(block_size=16, hbm_blocks=1024, max_batch=8,
             max_blocks_per_seq=160)
# serve_main (and chaos_path on its model): granite-3-8b at full width,
# 10 of its 40 layers, for the script's time; dense_generate runs 20
SERVE_LAYERS = 10
# the script's time: the depth of earlier paths cut, every kernel and
# gate kept (zamba2's shared block still runs 4 times a pass)
MOE_LAYERS = 4              # moe_main: olmoe-1b-7b, 16 layers -> 4
HYBRID_LAYERS = 24          # hybrid_main: zamba2-2.7b, 54 layers -> 24
SSM_LAYERS = 24             # ssm_main: falcon-mamba-7b, 64 layers -> 24
DENSE_LAYERS = 20           # dense_generate: granite-3-8b, 40 layers -> 20
TOKEN_BUDGET = 16_384       # prefill tokens one scheduler tick may commit
PREFIX_LEN, N_PREFIXES = 1024, 4
SUFFIX = (64, 960)          # unique suffix length range, inclusive
MAX_NEW = 32
CONSISTENCY_LAYERS = 4
NEAR_TIE = 1e-3             # top-2 logit margin below which a flip is a tie


def _err(got, want, tol: float, rtol: float | None = None):
    """(max |got - want|, whether every element is within tol + rtol|want|;
    ``rtol`` defaults to ``tol``)."""
    rtol = tol if rtol is None else rtol
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), bool((diff <= tol + rtol * want.float().abs())
                                   .all())


def limit_use(got, want, atol: float, rtol: float, slack=0.0) -> float:
    """max |got - want| / (atol + rtol|want| + slack): above 1 fails the
    check (``slack``: a tensor of per-element allowances, or 0)."""
    diff = (got.float() - want.float()).abs()
    return float((diff / (atol + rtol * want.float().abs() + slack)).max())


def new_shape_tol(dt: str, tol: float) -> tuple:
    """(atol, rtol) of a one-page or whisper case: ``NEW_BF16_TOL`` in
    bf16, ``tol`` for both in fp32."""
    return NEW_BF16_TOL if dt == "bfloat16" else (tol, tol)


def warm_ms(fn, flush, reps: int = 20) -> list:
    """``cuda_ms`` of ``reps`` calls after one warm-up call, each with the
    L2 cache emptied by a 1 GiB read."""
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


# The contiguous caches' one-page views (``layers.decode_attention``):
# B, S_max, H, Hkv, d and the lengths checked.  granite's dense_generate
# cache (2,080 positions, a multiple of the 16-position chunk) and one of
# 2,049 (no multiple); whisper's cross-attention over 1,500 frames (no
# multiple) and its 448-position decoder cache at its first step's 5;
# zamba2's shared block at head_dim 80 over hybrid_main's 2,080.
ONE_PAGE_CASES = [(4, 2080, 32, 8, 128, (1, 2049, 2080)),
                  (4, 2049, 32, 8, 128, (1, 2049)),
                  (8, 1500, 6, 6, 64, (1500, 1)),
                  (8, 448, 6, 6, 64, (5, 448)),
                  (4, 2080, 32, 32, 80, (1, 2049))]
# flash at Sq != Skv, full, and whisper's decoder prompt, causal: B, Sq,
# Skv, H, Hkv, causal, hd (whisper-tiny: 6 heads of 64, 1,500 frames)
CROSS_CASES = [(8, 1500, 1500, 6, 6, False, 64), (8, 4, 1500, 6, 6, False, 64),
               (8, 448, 1500, 6, 6, False, 64), (8, 4, 4, 6, 6, True, 64)]


def attn_kernels_vs_plain(dev):
    """Each attention kernel against its plain version on the card, fp32
    and bf16, at granite's widths, olmoe's 16/16 heads and kimi-k2's
    64/8 heads at head_dim 112; paged on the contiguous caches' one-page
    views (``ONE_PAGE_CASES``) and flash at whisper-tiny's shapes, Sq !=
    Skv (``CROSS_CASES``); returns the phase record."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain
    from repro_torch.models import layers as L

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    rec = dict(phase="attn_kernels_vs_plain", paged=[], flash=[])
    lengths = [1, 16, 17, 1024, 2560] + [int(x) for x in
                                         rng.integers(2, 2561, 3)]
    # a chunk, one split of a full table and one past each, the full table
    split = pops.split_range(0, 2560, pops.plan_splits(8, 8, 2560))[1]
    edges = [pops.CHUNK, pops.CHUNK + 1, split, split + 1, 2560, 2559, 15, 33]
    # (H, Hkv, lengths, d): groups 4, 4, 1, 16; olmoe's 16/16 heads;
    # kimi-k2's 64/8 at d 112 (7 k-steps of 16)
    paged_cases = [(32, 8, lengths, 128), (32, 8, edges, 128),
                   (8, 8, lengths, 128), (32, 2, edges, 128),
                   (16, 16, lengths, 128), (64, 8, lengths, 112),
                   (64, 8, edges, 112)]
    # 40 sequences of 8 KV heads fill the SMs with one split each: the
    # lse written without the splits' merge
    one_split = [int(x) for x in rng.integers(1, 2561, 40)]
    for dt in ("float32", "bfloat16"):
        for H, Hkv, lens, d in paged_cases + [(32, 8, one_split, 128)]:
            args = paged_inputs(dev, getattr(torch, dt), lens, rng, H=H,
                                Hkv=Hkv, d=d)
            got = pops.paged_attention(*args)
            want, want_lse = paged_attention_plain(*args, return_lse=True)
            err, ok = _err(got, want, ATTN_TOL[dt][1])
            require(ok, f"paged_attention {dt} H={H} Hkv={Hkv} d={d} "
                        f"lengths {lens} != plain (max err {err})")
            # the lse route (the sharded decode's): the same output, and
            # each head's log-sum-exp as the backward cases hold flash's
            got2, lse = pops.paged_attention_lse(*args)
            lse_err, lse_ok = _err(lse, want_lse, *LSE_TOL)
            require(torch.equal(got2, got) and lse_ok, f"paged_attention_lse "
                    f"{dt} H={H} Hkv={Hkv} d={d}: output equal "
                    f"{torch.equal(got2, got)}, lse max err {lse_err}")
            rec["paged"].append(dict(
                dtype=dt, B=len(lens), H=H, Hkv=Hkv, d=d, bs=16, N=1024,
                nb=160, lengths=lens,
                splits=pops.plan_splits(len(lens), Hkv, 160 * 16),
                tol=ATTN_TOL[dt][1], max_abs_err=err,
                lse_tol=list(LSE_TOL), lse_max_abs_err=lse_err))
        for B, S_max, H, Hkv, d, lens in ONE_PAGE_CASES:
            g = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(
                np.float32)).to(dev, getattr(torch, dt))
            q, kc, vc = g(B, 1, H, d), g(B, S_max, Hkv, d), g(B, S_max, Hkv, d)
            tables = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
            tol = new_shape_tol(dt, ATTN_TOL[dt][1])
            for n in lens:
                got = L.decode_attention(q, kc, vc, n)[:, 0]
                want = paged_attention_plain(
                    q[:, 0], kc, vc, tables,
                    torch.full((B,), n, dtype=torch.int32, device=dev))
                err, ok = _err(got, want, *tol)
                require(ok, f"paged_attention {dt} on a one-page view B={B} "
                            f"S_max={S_max} H={H} Hkv={Hkv} d={d} length {n} "
                            f"!= plain (max err {err})")
                # the planted fault: the kernel over the length cut to a
                # whole chunk is what a kernel that dropped the partial
                # last chunk returns; the check must reject it
                fault_err = fault_use = None
                if dt == "bfloat16" and n > pops.CHUNK and n % pops.CHUNK:
                    cut = n - n % pops.CHUNK
                    fault = L.decode_attention(q, kc, vc, cut)[:, 0]
                    fault_err, fault_ok = _err(fault, want, *tol)
                    fault_use = limit_use(fault, want, *tol)
                    require(not fault_ok, f"the one-page check at B={B} "
                            f"S_max={S_max} length {n} passes a kernel that "
                            f"drops positions {cut}..{n - 1} (err "
                            f"{fault_err})")
                rec["paged"].append(dict(
                    dtype=dt, B=B, H=H, Hkv=Hkv, d=d, bs=S_max, N=B, nb=1,
                    lengths=[n] * B, view="one_page",
                    splits=pops.plan_splits(B, Hkv, S_max),
                    tol=list(tol), max_abs_err=err,
                    limit_use=limit_use(got, want, *tol),
                    dropped_tail_max_abs_err=fault_err,
                    dropped_tail_limit_use=fault_use))
    # (B, S, H, Hkv, causal, hd): granite's 32/8 heads, the hybrid's hd 80,
    # olmoe's 16/16 heads, kimi-k2's 64/8 at hd 112 (TMA's zeros past 112)
    # (B, Sq, Skv, H, Hkv, causal, hd)
    cases = [(1, S, S, 32, 8, True, 128) for S in (1, 17, 128, 1000, 2048)]
    cases += [(1, S, S, 32, 8, False, 128) for S in (1, 17, 128, 1000, 2048)]
    cases += [(1, 1000, 1000, 32, 8, True, 80), (4, 1000, 1000, 32, 32, True, 64),
              (4, 1000, 1000, 32, 32, True, 80),
              (1, 1000, 1000, 16, 16, True, 128),
              (1, 1000, 1000, 64, 8, True, 112),
              (1, 2048, 2048, 64, 8, True, 112)] + CROSS_CASES
    for dt in ("float32", "bfloat16"):
        for B, S, Skv, H, Hkv, causal, hd in cases:
            g = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(
                np.float32)).to(dev, getattr(torch, dt))
            q, k, v = g(B, S, H, hd), g(B, Skv, Hkv, hd), g(B, Skv, Hkv, hd)
            got = fops.flash_attention(q, k, v, causal=causal)
            want = flash_attention_plain(q, k, v, causal)
            # whisper's attentions over 1,500 frames; its causal 4-token
            # prompt averages at most 4 positions and keeps ATTN_TOL
            whisper = (B, S, Skv, H, Hkv, causal, hd) in CROSS_CASES \
                and not causal
            tol = (new_shape_tol(dt, ATTN_TOL[dt][0]) if whisper
                   else (ATTN_TOL[dt][0],) * 2)
            err, ok = _err(got, want, *tol)
            require(ok, f"flash_attention {dt} B={B} S={S} Skv={Skv} H={H} "
                        f"Hkv={Hkv} causal={causal} hd={hd} != plain (max "
                        f"err {err})")
            # the planted fault: k/v cut to whole tiles is what a kernel
            # that dropped the partial last KV tile returns
            fault_err = fault_use = None
            if whisper and dt == "bfloat16" and Skv > WGMMA_KV_TILE \
                    and Skv % WGMMA_KV_TILE:
                cut = Skv - Skv % WGMMA_KV_TILE
                fault = fops.flash_attention(q, k[:, :cut].contiguous(),
                                             v[:, :cut].contiguous(),
                                             causal=False)
                fault_err, fault_ok = _err(fault, want, *tol)
                fault_use = limit_use(fault, want, *tol)
                require(not fault_ok, f"the whisper flash check at Sq={S} "
                        f"Skv={Skv} passes a kernel that drops positions "
                        f"{cut}..{Skv - 1} (err {fault_err})")
            rec["flash"].append(dict(dtype=dt, B=B, S=S, Skv=Skv, H=H,
                                     Hkv=Hkv, hd=hd, causal=causal,
                                     route=fops.route(q.dtype),
                                     tol=list(tol), max_abs_err=err,
                                     limit_use=limit_use(got, want, *tol),
                                     dropped_tail_max_abs_err=fault_err,
                                     dropped_tail_limit_use=fault_use))
    torch.cuda.synchronize()

    # the plain versions' times, at the bf16 check shapes, beside the
    # kernels' at the same shapes
    flush = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    args = paged_inputs(dev, torch.bfloat16, lengths, rng)
    rec["paged_plain_ms"] = statistics.median(warm_ms(
        lambda: paged_attention_plain(*args), flush, 5))
    rec["paged_kernel_ms"] = statistics.median(warm_ms(
        lambda: pops.paged_attention(*args, validate=False), flush, 5))
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
    rec["max_abs_err_hd112"] = dict(
        paged=max(r["max_abs_err"] for r in rec["paged"] if r["d"] == 112),
        flash=max(r["max_abs_err"] for r in rec["flash"] if r["hd"] == 112))
    rec["max_abs_err_new_shapes"] = dict(
        paged_one_page=max(r["max_abs_err"] for r in rec["paged"]
                           if r.get("view") == "one_page"),
        flash_whisper=max(r["max_abs_err"] for r in rec["flash"]
                          if r["H"] == 6))
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


def serve_run(dev, api, params, reqs, serve=SERVE):
    """Serve ``reqs`` on a fresh engine over ``params``, after a warm-up
    prefill off the counts; returns (engine, completions, the step
    record of ``_instrument``, wall seconds, launches per kernel in the
    run)."""
    from repro_torch.kernels.cache_sim import ops as cops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedConfig

    eng = ServingEngine(api, params, device=dev, **serve)
    api.prefill(params, torch.zeros((1, 64), dtype=torch.long, device=dev))
    torch.cuda.synchronize()                       # warm-up, off the pool
    rec = _instrument(eng)

    fops.launch_count = pops.launch_count = cops.launch_count = 0
    t1 = time.perf_counter()
    outs = eng.run(reqs, config=SchedConfig(max_batch=serve["max_batch"],
                                            token_budget=TOKEN_BUDGET))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    return eng, outs, rec, wall, dict(flash_attention=fops.launch_count,
                                      paged_attention=pops.launch_count,
                                      cache_sim=cops.launch_count)


def serve_metrics(dev, eng, outs, rec, wall) -> dict:
    """What a serving phase reports of ``serve_run``'s run: throughput,
    prefill and decode-step ms p50/p99 (host clock), the decode batch,
    the pool's counters and the peak device bytes."""
    stats, flows = eng.stats
    done = [c for c in outs if c.status == "completed"]
    out_tokens = sum(len(c.tokens) for c in done)
    return dict(
        completed=len(done), wall_s=wall, requests_per_s=len(outs) / wall,
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
        pool=dataclasses.asdict(stats), hit_ratio=stats.hit_ratio,
        flows=flows, host_blocks=len(eng.pool.host),
        pool_lookups=stats.hits + stats.misses,
        host_io_ops=stats.swap_in + stats.swap_out,
        peak_device_bytes=torch.cuda.max_memory_allocated(dev))


def serve_main(dev):
    """Full-width granite-3-8b cut to ``SERVE_LAYERS`` layers behind the
    serving engine;
    returns (phase record, launches per kernel, the run's decode context
    lengths as 8 octile midpoints, and what ``chaos_path`` reuses: the
    model, its params, the tokens per request, the pool's lookups and its
    host IO operations)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              n_layers=SERVE_LAYERS)
    api = build(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = make_requests(32, seed=0, vocab=cfg.vocab)
    eng, outs, rec, wall, launches = serve_run(dev, api, params, reqs)

    stats, _ = eng.stats
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
    phase = dict(
        phase="serve_main", model=cfg.name, n_layers=cfg.n_layers,
        reduced=f"layers 40 -> {SERVE_LAYERS} (the script's time)",
        d_model=cfg.d_model, dtype=cfg.dtype, n_params=cfg.n_params(),
        weights="random, torch.Generator(cuda).manual_seed(0)",
        engine=SERVE, token_budget=TOKEN_BUDGET, requests=32,
        prefix_len=PREFIX_LEN, n_prefixes=N_PREFIXES, suffix=SUFFIX,
        max_new=MAX_NEW, init_s=init_s,
        **serve_metrics(dev, eng, outs, rec, wall),
        decode_lengths_octiles=med, launches=launches)
    del eng
    torch.cuda.empty_cache()
    phase["profile"] = serve_profile(dev, api, params)
    served = dict(api=api, params=params, tokens={c.req_id: c.tokens
                                                  for c in done},
                  lookups=phase["pool_lookups"], io_ops=phase["host_io_ops"])
    return phase, launches, med, served


def serve_profile(dev, api, params):
    """A short serving run (4 requests of the same shape, 8 new tokens
    each, a fresh pool) under ``torch.profiler`` (``profile_summary``)."""
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
    del eng
    return dict(requests=4, max_new=8, **profile_summary(
        prof, wall, {"flash_attention": "flash_attention_kernel",
                     "paged_attention": "paged_attention_"}))


GEMM_KEYS = ("gemm", "nvjet", "sm90_xmma")


def profile_summary(prof, wall: float, groups: dict) -> dict:
    """What a ``torch.profiler`` window over ``wall`` seconds shows: the
    device's busy share of the wall time (one stream, so kernel times add
    up without overlap), device ms by group (``groups`` maps a group to
    a substring of its kernels' names; then GEMMs, then the rest), the
    launch API's host time and the top kernels.  The profiler's own host
    cost inflates the wall time, so the busy share is a lower bound."""
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    # "Command Buffer Full" is the tracer's mark of a full launch queue
    # (the host waiting on the device), not a kernel
    # a CPU op's self device time repeats its kernels' (the autograd
    # Functions launching through ctypes have one): count kernels only
    cpu = torch.autograd.DeviceType.CPU
    kernels = sorted((e for e in prof.key_averages() if dev_us(e) > 0 and
                      not e.key.startswith("aten::") and
                      getattr(e, "device_type", None) != cpu and
                      e.key != "Command Buffer Full"),
                     key=dev_us, reverse=True)
    queue_full = [e for e in prof.key_averages()
                  if e.key == "Command Buffer Full"]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    by_group = dict.fromkeys(list(groups) + ["gemm", "other"], 0.0)
    for e in kernels:
        k = next((g for g, key in groups.items() if key in e.key), None) or (
            "gemm" if any(w in e.key for w in GEMM_KEYS) else "other")
        by_group[k] += dev_us(e) / 1e3
    cpu_launch = sum(e.self_cpu_time_total for e in prof.key_averages()
                     if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    return dict(wall_ms=1e3 * wall, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / 1e3 / wall,
                device_ms_by_group=by_group,
                launch_api_cpu_ms=cpu_launch / 1e3,
                launch_queue_full=dict(
                    count=sum(e.count for e in queue_full),
                    ms=sum(dev_us(e) for e in queue_full) / 1e3),
                kernel_launches=sum(e.count for e in kernels),
                top=[dict(name=e.key[:70], ms=dev_us(e) / 1e3, calls=e.count)
                     for e in kernels[:8]])


def teacher_forced(api, params, reqs, by_id, dev, near_tie=NEAR_TIE,
                   margins=None):
    """Hold each request's generated tokens against a teacher-forced
    ``forward_prefill`` over its prompt and tokens: (positions compared,
    mismatches, near ties), a flip with a top-2 margin < ``near_tie``
    being a near tie.  ``margins``, a list where given, gets every
    compared position's top-2 margin."""
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
        if margins is not None:
            margins.extend(margin[:len(gen)])
        for i, (want, got) in enumerate(zip(pick, gen)):
            compared += 1
            if want == got:
                continue
            item = dict(req=r.req_id, pos=i, engine=got, prefill=want,
                        margin=margin[i])
            (ties if margin[i] < near_tie else mismatches).append(item)
    return compared, mismatches, ties


def consistency_run(dev, phase: str, cfg, reduced, serve=SERVE):
    """Serve 8 requests on ``cfg`` (an fp32 cut of a model at full
    width) and hold the engine's tokens to a teacher-forced
    ``forward_prefill`` over each prompt and its generated tokens: the
    prefill must pick the engine's token at every generated position,
    near ties (top-2 margin < 1e-3) excepted and reported."""
    from repro_torch.models.model import build
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedConfig

    t0 = time.perf_counter()
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServingEngine(api, params, device=dev, **serve)
    reqs = make_requests(8, seed=1, vocab=cfg.vocab)
    outs = eng.run(reqs, config=SchedConfig(max_batch=serve["max_batch"],
                                            token_budget=TOKEN_BUDGET))
    by_id = {c.req_id: c for c in outs}
    require(all(by_id[r.req_id].status == "completed" and
                len(by_id[r.req_id].tokens) == MAX_NEW for r in reqs),
            f"{phase}: a request did not complete")
    compared, mismatches, ties = teacher_forced(api, params, reqs, by_id,
                                                dev)
    require(not mismatches, f"{phase}: decode-path tokens != "
                            f"teacher-forced prefill tokens: {mismatches}")
    stats, _ = eng.stats
    rec = dict(phase=phase, model=cfg.name, dtype=cfg.dtype,
               reduced=reduced, engine=serve, requests=len(reqs),
               positions_compared=compared, mismatches=0, near_ties=ties,
               near_tie_margin=NEAR_TIE, pool=dataclasses.asdict(stats),
               allow_tf32=torch.backends.cuda.matmul.allow_tf32,
               seconds=time.perf_counter() - t0)
    del eng, params, api
    torch.cuda.empty_cache()
    return rec


def serve_consistency(dev):
    """The decode kernel's path against the prefill kernel's path on the
    whole model: granite-3-8b at full width in fp32, depth cut to 4
    layers (``consistency_run``)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              n_layers=CONSISTENCY_LAYERS, dtype="float32",
                              param_dtype="float32")
    return consistency_run(dev, "serve_consistency", cfg,
                           [f"n_layers 40 -> {CONSISTENCY_LAYERS}"])


# -- the moe and vlm families ----------------------------------------------------

MOE_CUT = dict(n_layers=4, capacity_factor=64.0)  # moe_consistency's cut
MOE_CUT_BATCH = 4           # ... and max_batch: decode capacity 4 covers it
MOE_STAGE_T = (8, 1536)     # moe stage times: a padded decode batch, a prefill
WIDE_LAYERS, WIDE_REQUESTS = 1, 4   # moe_wide: kimi-k2's 61 layers cut to 1
VLM_BATCH, VLM_TOKENS = 2, 512      # vlm_main: B x (576 patches + 512 tokens)
VLM_REQUESTS = 8
VLM_CUT_LAYERS, VLM_CUT_TOKENS = 2, 128   # vlm_consistency: depth, tokens
VLM_TOL = 1e-4              # vlm_consistency: logits, rel. to max |logit|


def expert_bytes(cfg) -> int:
    """Bytes of every routed expert's weights over all layers: what one
    moe forward reads, whatever its tokens (each expert runs on its whole
    capacity buffer)."""
    mult = 3 if cfg.act == "swiglu" else 2
    esize = torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    return (cfg.n_layers * cfg.n_experts * mult * cfg.d_model * cfg.moe_d_ff
            * esize)


def moe_stage_ms(dev, cfg, p, T: int, decode: bool) -> dict:
    """CUDA-event ms of each stage of one moe layer (params ``p``) on T
    random unit-variance tokens, as a block hands them over after its
    norm: route, dispatch, expert FFN, combine; median of 5 after a
    warm-up, the L2 not emptied."""
    from repro_torch.models import moe as M

    g = torch.Generator(device=dev).manual_seed(7)
    xf = torch.randn((T, cfg.d_model), generator=g, device=dev).to(
        getattr(torch, cfg.dtype))
    r = M.route(cfg, p, xf, decode)
    buf = M.dispatch(cfg, r, xf)
    out = M.expert_ffn(cfg, p, buf)
    stages = dict(route=lambda: M.route(cfg, p, xf, decode),
                  dispatch=lambda: M.dispatch(cfg, r, xf),
                  expert_ffn=lambda: M.expert_ffn(cfg, p, buf),
                  combine=lambda: M.combine(cfg, p, r, out, xf))
    rec = {k: statistics.median(warm_ms(fn, None, 5))
           for k, fn in stages.items()}
    rec.update(T=T, decode=decode, capacity=r.C,
               kept_share=float(r.keep.float().mean()),
               expert_ffn_bytes_floor_ms=1e3 * expert_bytes(cfg)
               / cfg.n_layers / HBM_BYTES_PER_S)
    return rec


def _init_model(dev, cfg):
    """(api, params, init seconds, weight bytes, init peak bytes): random
    weights from ``torch.Generator(cuda).manual_seed(0)``, after what
    earlier phases left is freed."""
    from repro_torch.models.model import build

    api = build(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    return (api, params, time.perf_counter() - t0,
            torch.cuda.memory_allocated(dev) - before,
            torch.cuda.max_memory_allocated(dev))


def _served(phase: str, cfg, outs, n: int, launches, m, extra_flash=0):
    """The gates of a served family phase: ``n`` of ``n`` complete with
    ``MAX_NEW`` tokens in the vocabulary, flash launched once a layer a
    prefill (``extra_flash`` prefills outside the engine besides) and
    paged once a layer a decode step, ``cache_sim`` never."""
    done = [c for c in outs if c.status == "completed"]
    require(len(done) == n and all(len(c.tokens) == MAX_NEW for c in done),
            f"{phase}: {len(done)} of {n} completed "
            f"({[(c.req_id, c.status, len(c.tokens)) for c in outs]})")
    require(all(0 <= t < cfg.vocab for c in done for t in c.tokens),
            f"{phase}: a token outside the vocabulary")
    want = dict(flash_attention=(m["prefills"] + extra_flash) * cfg.n_layers,
                paged_attention=m["decode_steps"] * cfg.n_layers,
                cache_sim=0)
    require(launches == want and m["decode_steps"] > 0,
            f"{phase}: launches {launches}, want {want} (one a layer a "
            f"prefill and a decode step)")


def moe_main(dev):
    """Full-width olmoe-1b-7b (64 experts, top-8) cut to ``MOE_LAYERS`` of
    its 16 layers behind the serving engine on ``serve_main``'s 32
    requests; returns (phase record, launches per kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=MOE_LAYERS)
    api, params, init_s, weight_bytes, _ = _init_model(dev, cfg)
    reqs = make_requests(32, seed=0, vocab=cfg.vocab)
    eng, outs, rec, wall, launches = serve_run(dev, api, params, reqs)
    m = serve_metrics(dev, eng, outs, rec, wall)
    _served("moe_main", cfg, outs, 32, launches, m)
    require(m["pool"]["hits"] > 0, "moe_main: no prefix hit in the pool")
    floor = expert_bytes(cfg)
    phase = dict(
        phase="moe_main", model=cfg.name, family=cfg.family,
        n_layers=cfg.n_layers,
        reduced=f"layers 16 -> {MOE_LAYERS} (the script's time)",
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, n_experts=cfg.n_experts,
        experts_per_tok=cfg.experts_per_tok, moe_d_ff=cfg.moe_d_ff,
        dtype=cfg.dtype, n_params=_n_params(params),
        n_params_analytic=cfg.n_params(), weight_bytes=weight_bytes,
        weights="random, torch.Generator(cuda).manual_seed(0)",
        engine=SERVE, token_budget=TOKEN_BUDGET, requests=32,
        prefix_len=PREFIX_LEN, n_prefixes=N_PREFIXES, suffix=SUFFIX,
        max_new=MAX_NEW, init_s=init_s, **m, launches=launches,
        expert_bytes_a_step=floor,
        decode_bytes_floor_ms=1e3 * floor / HBM_BYTES_PER_S)
    del eng
    torch.cuda.empty_cache()
    p0 = L.layer(params["blocks"], 0)["moe"]
    phase["moe_stage_ms"] = [moe_stage_ms(dev, cfg, p0, T, T <= SERVE[
        "max_batch"]) for T in MOE_STAGE_T]
    t1 = time.perf_counter()
    phase["profile"] = serve_profile(dev, api, params)
    phase.update(profile_s=time.perf_counter() - t1,
                 seconds=time.perf_counter() - t0)
    del params, api, p0
    torch.cuda.empty_cache()
    return phase, launches


def moe_consistency(dev):
    """olmoe-1b-7b at full width in fp32 against a teacher-forced prefill
    (``consistency_run``), cut so that no assignment drops: 4 layers,
    capacity factor 64 (a dropless prefill, as tests/test_models.py cuts
    it) and ``max_batch`` 4 (decode capacity 4 at T = 4: every row)."""
    from repro_torch.configs import get_config

    full = get_config("olmoe-1b-7b")
    cfg = dataclasses.replace(full, dtype="float32", param_dtype="float32",
                              **MOE_CUT)
    return consistency_run(
        dev, "moe_consistency", cfg,
        [f"n_layers {full.n_layers} -> {cfg.n_layers}",
         f"capacity_factor {full.capacity_factor} -> {cfg.capacity_factor}",
         f"max_batch {SERVE['max_batch']} -> {MOE_CUT_BATCH}"],
        dict(SERVE, max_batch=MOE_CUT_BATCH))


def moe_wide(dev):
    """kimi-k2-1t-a32b at published width (384 experts, top-8, a shared
    expert, d 7168, 64/8 heads at head_dim 112), depth cut to 1 layer,
    behind the serving engine on 4 requests of ``serve_main``'s shape;
    returns (phase record, launches per kernel)."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    full = get_config("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(full, n_layers=WIDE_LAYERS)
    require(cfg.hd == 112, f"moe_wide: head_dim {cfg.hd}, want 112")
    api, params, init_s, weight_bytes, init_peak = _init_model(dev, cfg)
    reqs = make_requests(WIDE_REQUESTS, seed=2, vocab=cfg.vocab)
    eng, outs, rec, wall, launches = serve_run(dev, api, params, reqs)
    m = serve_metrics(dev, eng, outs, rec, wall)
    _served("moe_wide", cfg, outs, WIDE_REQUESTS, launches, m)
    floor = expert_bytes(cfg)
    phase = dict(
        phase="moe_wide", model=cfg.name, family=cfg.family,
        reduced=[f"n_layers {full.n_layers} -> {cfg.n_layers}"],
        n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, n_experts=cfg.n_experts,
        experts_per_tok=cfg.experts_per_tok, moe_d_ff=cfg.moe_d_ff,
        n_shared_experts=cfg.n_shared_experts, vocab=cfg.vocab,
        dtype=cfg.dtype, n_params=_n_params(params),
        n_params_analytic=cfg.n_params(), weight_bytes=weight_bytes,
        init_peak_device_bytes=init_peak,
        weights="random, torch.Generator(cuda).manual_seed(0)",
        engine=SERVE, requests=WIDE_REQUESTS, max_new=MAX_NEW,
        init_s=init_s, **m, launches=launches, expert_bytes_a_step=floor,
        decode_bytes_floor_ms=1e3 * floor / HBM_BYTES_PER_S,
        seconds=time.perf_counter() - t0)
    del eng, params, api
    torch.cuda.empty_cache()
    return phase, launches


def vlm_main(dev):
    """Full-width, full-depth llava-next-mistral-7b: one patch prefill of
    ``VLM_BATCH`` x (576 numpy-seeded patch embeddings + ``VLM_TOKENS``
    tokens) through ``build().prefill``, timed, then 8 token-only
    requests behind the serving engine, as the reference's engine serves
    the vlm family; returns (phase record, launches per kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops

    t0 = time.perf_counter()
    cfg = get_config("llava-next-mistral-7b")
    api, params, init_s, weight_bytes, _ = _init_model(dev, cfg)
    rng = np.random.default_rng(0)
    pe = torch.from_numpy(rng.normal(0, 1, (
        VLM_BATCH, cfg.n_patches, cfg.d_model)).astype(np.float32)).to(dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab,
                                        (VLM_BATCH, VLM_TOKENS)), device=dev)
    api.prefill(params, toks[:, :16], patch_embeds=pe[:, :16])  # warm-up
    torch.cuda.synchronize()
    fops.launch_count = 0
    t1 = time.perf_counter()
    logits, cache = api.prefill(params, toks, patch_embeds=pe)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    patch_launches = fops.launch_count
    S = cfg.n_patches + VLM_TOKENS
    require(bool(torch.isfinite(logits).all()) and
            logits.shape == (VLM_BATCH, 1, cfg.vocab) and
            cache.k.shape[2] == S and
            patch_launches == cfg.n_layers,
            f"vlm_main: patch prefill logits {tuple(logits.shape)}, cache "
            f"{tuple(cache.k.shape)}, {patch_launches} flash launches")
    first = logits[:, 0].argmax(-1).tolist()
    del logits, cache
    reqs = make_requests(VLM_REQUESTS, seed=4, vocab=cfg.vocab)
    eng, outs, rec, wall, launches = serve_run(dev, api, params, reqs)
    launches["flash_attention"] += patch_launches
    m = serve_metrics(dev, eng, outs, rec, wall)
    _served("vlm_main", cfg, outs, VLM_REQUESTS, launches, m, extra_flash=1)
    phase = dict(
        phase="vlm_main", model=cfg.name, family=cfg.family,
        frontend=cfg.frontend, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, dtype=cfg.dtype,
        n_params=_n_params(params), n_params_analytic=cfg.n_params(),
        weight_bytes=weight_bytes,
        weights="random, torch.Generator(cuda).manual_seed(0)",
        patch_prefill=dict(
            batch=VLM_BATCH, patches=cfg.n_patches, tokens=VLM_TOKENS,
            positions=S, patch_embeds="numpy default_rng(0) normal(0, 1)",
            ms=1e3 * prefill_s,
            positions_per_s=VLM_BATCH * S / prefill_s,
            flash_shape=[VLM_BATCH, S, cfg.n_heads, cfg.n_kv_heads, cfg.hd],
            first_tokens=first),
        engine=SERVE, requests=VLM_REQUESTS, max_new=MAX_NEW,
        init_s=init_s, **m, launches=launches,
        seconds=time.perf_counter() - t0)
    del eng, params, api, pe
    torch.cuda.empty_cache()
    return phase, launches


def hidden_errors(cfg, params, host, toks, pe, dev) -> list:
    """The hidden state after the embedding and after each layer of a
    patch prefill (``transformer.forward_prefill``'s steps), ``params`` on
    ``dev`` against ``host`` on the CPU: each max |err| over max |x|."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    runs = []
    for p, d in ((params, dev), (host, torch.device("cpu"))):
        x = T.embed_inputs(cfg, p["embed"], torch.as_tensor(toks, device=d),
                           torch.from_numpy(pe).to(d))
        B, S, _ = x.shape
        rope = L.rope_tables(torch.arange(S, device=d).expand(B, S), cfg.hd,
                             cfg.rope_theta, cfg.rope_frac)
        xs = [x]
        for i in range(cfg.n_layers):
            xs.append(T._block(cfg, L.layer(p["blocks"], i), xs[-1],
                               rope)[0])
        runs.append(xs)
    return [_rel_err(a.cpu(), b) for a, b in zip(*runs)]


def vlm_consistency(dev):
    """llava-next-mistral-7b at full width in fp32, depth cut to 2: one
    prompt of 576 numpy-seeded patch embeddings + 128 tokens through the
    card's path (the flash kernel) and, with the same params carried
    through numpy, through the port on the CPU (plain attention); the
    logits within 1e-4 of max |logit|, the KV cache within 1e-4 of its
    max |x|.  Where they are not, each layer's hidden state on the card
    against the CPU's (``hidden_errors``) is printed first."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import (build, params_from_numpy,
                                          params_to_numpy)

    t0 = time.perf_counter()
    full = get_config("llava-next-mistral-7b")
    cfg = dataclasses.replace(full, n_layers=VLM_CUT_LAYERS, dtype="float32",
                              param_dtype="float32")
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    host = params_from_numpy(cfg, params_to_numpy(params), device="cpu")
    rng = np.random.default_rng(5)
    pe = rng.normal(0, 1, (1, cfg.n_patches, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (1, VLM_CUT_TOKENS))
    t1 = time.perf_counter()
    got, gcache = api.prefill(params, torch.as_tensor(toks, device=dev),
                              full_logits=True,
                              patch_embeds=torch.from_numpy(pe).to(dev))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    want, wcache = api.prefill(host, torch.from_numpy(toks),
                               full_logits=True,
                               patch_embeds=torch.from_numpy(pe))
    cpu_s = time.perf_counter() - t1
    err = _rel_err(got.cpu(), want)
    kv_err = max(_rel_err(gcache.k.cpu(), wcache.k),
                 _rel_err(gcache.v.cpu(), wcache.v))
    if not (err <= VLM_TOL and kv_err <= VLM_TOL):  # where it arose, first
        emit(dict(phase="vlm_consistency_layers", logit_rel_err=err,
                  kv_rel_err=kv_err, hidden_rel_err=hidden_errors(
                      cfg, params, host, toks, pe, dev)))
    require(err <= VLM_TOL and kv_err <= VLM_TOL,
            f"vlm_consistency: card != CPU (logits rel err {err}, KV "
            f"{kv_err}; tolerance {VLM_TOL})")
    picks = int((got.cpu().argmax(-1) == want.argmax(-1)).sum())
    rec = dict(phase="vlm_consistency", model=cfg.name, dtype=cfg.dtype,
               reduced=[f"n_layers {full.n_layers} -> {cfg.n_layers}"],
               patches=cfg.n_patches, tokens=VLM_CUT_TOKENS,
               positions=int(got.shape[1]), logit_rel_err=err,
               kv_rel_err=kv_err, tol=VLM_TOL, greedy_equal=picks,
               card_s=card_s, cpu_s=cpu_s, cpu_threads=torch.get_num_threads(),
               allow_tf32=torch.backends.cuda.matmul.allow_tf32,
               seconds=time.perf_counter() - t0)
    del params, host, api, got, gcache
    torch.cuda.empty_cache()
    return rec


# -- the chaos path: faults, snapshots, journal and replicas under serving ------

CHAOS_SHARDS = 4
CHAOS_SEED = 20
CHAOS_RETRY = 2             # io_retry: RetryPolicy(max_retries=2)
CHAOS_RATE_SHIFT = 3        # the tuner samples 1/8 of its window's keys
CHAOS_MIN_SAMPLES = 64      # ... backing off toward 1/1 below 64 samples
CHAOS_MRC_SHIFT = 2         # cache_mrc samples 1/4 of the window's keys
CHAOS_HBM = 640             # chaos_consistency's pool: blocks swap to host
CHAOS_GHOST_EVERY = 64      # chaos_rewarm: a ghost journal every 64 lookups


def chaos_knobs(F, k: int, lookups: int, journal_dir):
    """The engine knobs of both chaos phases: 4 shards with hot standbys
    journaled under ``journal_dir``, a loss of shard 1 at host IO op
    ``k`` in a storm of IO errors, torn writes and delays, and the online
    tuner profiling every quarter of ``lookups`` pool lookups over a
    history of all of them (a prefix block comes back a few hundred
    lookups later, through the Ghost ring: a shorter window sees only
    misses)."""
    return dict(
        n_shards=CHAOS_SHARDS, replicate=True, journal_dir=journal_dir,
        faults=F.FaultPlan(CHAOS_SEED, [
            F.FaultSpec(F.SHARD_LOSS, at=(k,), shard=1),
            F.FaultSpec(F.IO_ERROR, prob=0.2),
            F.FaultSpec(F.PARTIAL_WRITE, prob=0.05),
            F.FaultSpec(F.IO_DELAY, prob=0.1, ticks=3)]),
        io_retry=F.RetryPolicy(max_retries=CHAOS_RETRY),
        autotune=dict(retune_every=max(1, lookups // 4), history=lookups,
                      rate_shift=CHAOS_RATE_SHIFT,
                      min_samples=CHAOS_MIN_SAMPLES))


def planned_lookups(reqs, bs: int) -> int:
    """Pool lookups serving ``reqs`` to completion makes: one a block of
    KV each request writes (prompt and every decoded token but the
    last), whatever the policy or the faults."""
    return sum(-(-(len(r.prompt) + r.max_new - 1) // bs) for r in reqs)


def event_ms(fn):
    """(fn(), ms between CUDA events recorded around it); ``fn`` ends in
    a read of its device result, so the span covers its device work."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


class ChaosTimes:
    """What a chaos engine does beside serving, timed: every journal
    append and base snapshot (host clock, over every ``ShardJournal``,
    until ``stop``), each tuner round and each shard failover (CUDA
    events); and the block keys the tuner observed (``keys``)."""

    def __init__(self, fj):
        self.fj = fj
        self.orig = (fj.ShardJournal.append, fj.ShardJournal._write_base)
        self.journal_s, self.appends, self.bases = 0.0, 0, 0
        self.rounds_ms, self.failovers, self.keys = [], [], []
        times = self

        def timed(fn, count):
            def call(jr, *a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(jr, *a, **kw)
                finally:
                    times.journal_s += time.perf_counter() - t0
                    setattr(times, count, getattr(times, count) + 1)
            return call

        fj.ShardJournal.append = timed(self.orig[0], "appends")
        fj.ShardJournal._write_base = timed(self.orig[1], "bases")

    def stop(self) -> None:
        """Put the journal's own methods back."""
        self.fj.ShardJournal.append, self.fj.ShardJournal._write_base = \
            self.orig

    def watch(self, pool, mgr) -> None:
        """Time ``pool``'s tuner rounds and failovers, record the keys
        its tuner observes and, at each failover, how many of the live
        sequences' blocks (``mgr``'s) the lost shard held: in all, with a
        host copy older than the block, and with none."""
        observe, retune = pool.tuner.observe, pool.tuner.retune_now
        failover = pool.failover_shard

        def recorded(key):
            self.keys.append(key)
            return observe(key)

        def timed_retune():
            out, ms = event_ms(retune)
            self.rounds_ms.append(ms)
            return out

        def timed_failover(sid):
            rep = pool._replicator
            kind = "promote" if rep is not None and rep.should_promote(sid) \
                else "rewarm"
            lag = pool.replication_lag(sid)
            lost = set(pool.policy.shards[sid].resident_keys())
            live = {k for st in mgr.seqs.values() for k in st.block_keys
                    if k in lost}
            out, ms = event_ms(lambda: failover(sid))
            self.failovers.append(dict(
                shard=sid, kind=kind, ms=ms, lag_at_loss=lag,
                result=list(out), live_blocks=len(live),
                live_stale=None if pool._stale is None
                else len(live & pool._stale),
                live_no_host_copy=len(live - set(pool.host))))
            return out

        pool.tuner.observe = recorded
        pool.tuner.retune_now = timed_retune
        pool.failover_shard = timed_failover


def tuner_checks(tuner, keys, phase: str, rounds=None, mrc=None,
                 mrc_shift=None) -> dict:
    """Hold each of ``tuner``'s ``rounds`` (all of its decisions by
    default; each a ``cache_sim`` sweep on the card) to the plain sweep
    on the CPU over the same window of ``keys``, the keys it observed,
    and ``mrc`` (a pool's ``estimate_mrc``, one more sweep) to
    ``profiler.estimate_sweep`` on the CPU, all exactly.  The plain
    estimates must see hits somewhere, so that a kernel counting none
    would fail."""
    from repro_torch.tuning import profiler, sweep_grid

    keys = np.asarray(keys, dtype=np.int64)
    require(keys.size == tuner.n_observed,
            f"{phase}: {keys.size} keys recorded, the tuner saw "
            f"{tuner.n_observed}")
    rounds = list(tuner.decisions) if rounds is None else rounds
    below_one = False
    for r in rounds:
        window = keys[max(0, r.at_access - tuner.history):r.at_access]
        sampled = profiler.sample_trace(window, r.rate_shift)
        plain = sweep_grid(sampled, profiler.scaled_configs(
            r.configs, r.rate_shift), pad_pow2=True, device="cpu")
        require(sampled.size == r.n_sampled
                and np.array_equal(plain, r.est_miss_ratios),
                f"{phase}: tuner round at {r.at_access}: estimates "
                f"{r.est_miss_ratios} != the plain sweep's {plain}")
        below_one |= bool((plain < 1.0).any())
    out = dict(tuner_history=tuner.history, tuner_estimates=[
        dict(at=r.at_access, rate_shift=r.rate_shift, sampled=r.n_sampled,
             est_miss_ratios=[float(x) for x in r.est_miss_ratios])
        for r in rounds])
    if mrc is not None:
        live = tuner._live_config()
        caps = [int(c) for c in mrc]
        plain = profiler.estimate_sweep(
            tuner.recent(), [dataclasses.replace(live, capacity=c)
                             for c in caps], mrc_shift, device="cpu")
        got = np.array([mrc[c] for c in caps])
        require(np.array_equal(got, plain),
                f"{phase}: cache_mrc {got} != the plain sweep's {plain}")
        below_one |= bool((plain < 1.0).any())
    require(below_one, f"{phase}: every plain estimate is 1.0: no hit for "
                       f"the kernel to count")
    return out


def chaos_checks(F, pool, jdir: str, phase: str) -> dict:
    """Close the pool's journals, then hold each shard's on-disk journal,
    recovered, to the live shard byte for byte, and a
    ``write_snapshot`` / ``read_snapshot`` / ``policy_from_snapshot``
    round trip of the sharded policy to the same bytes."""
    for jr in pool._replicator.journals:
        jr.close()
    journal_bytes = sum(f.stat().st_size
                        for f in pathlib.Path(jdir).rglob("*.c2q*"))
    recovered = []
    for i, sh in enumerate(pool.policy.shards):
        t0 = time.perf_counter()
        res = F.recover(os.path.join(jdir, f"shard{i}"))
        s = time.perf_counter() - t0
        live = F.pack(F.state_dict(sh))
        require(F.pack(F.state_dict(res.policy)) == live,
                f"{phase}: shard {i}'s journal (epoch {res.epoch}, lsn "
                f"{res.lsn}) recovers to other bytes than the live shard")
        recovered.append(dict(shard=i, epoch=res.epoch, lsn=res.lsn,
                              applied=res.applied,
                              truncated_bytes=res.truncated_bytes,
                              state_bytes=len(live), recover_s=s))
    path = os.path.join(jdir, "policy.c2qsnap")
    t0 = time.perf_counter()
    buf = F.write_snapshot(path, pool.policy)
    d = F.read_snapshot(path)
    for i, sh in enumerate(pool.policy.shards):
        sub = {"meta": d["meta"][f"s{i}"],
               "arrays": {n[len(f"s{i}/"):]: a for n, a in d["arrays"].items()
                          if n.startswith(f"s{i}/")}}
        require(F.pack(F.state_dict(F.policy_from_snapshot(sub))) ==
                F.pack(F.state_dict(sh)),
                f"{phase}: shard {i} restored from the snapshot packs to "
                f"other bytes")
    F.load_state_dict(pool.policy, d)
    require(F.pack(d) == buf and F.pack(F.state_dict(pool.policy)) == buf,
            f"{phase}: the sharded snapshot does not round-trip")
    return dict(journal_bytes=journal_bytes, recovered=recovered,
                snapshot_bytes=len(buf),
                snapshot_round_trip_s=time.perf_counter() - t0)


def chaos_report(pool, times: ChaosTimes, mrc_ms=None) -> dict:
    """The pool's stats, fault counters, degraded transitions,
    replication lag, failovers, journal and tuner times."""
    snap = pool.obs_snapshot()
    stats = pool.stats
    io = pool._io
    return dict(
        pool=dataclasses.asdict(stats), hit_ratio=stats.hit_ratio,
        flows=dict(pool.policy.flows), host_blocks=len(pool.host),
        quarantined=len(pool._corrupt),
        injected=io.plan.injected, io_ops=io.plan.op_seq,
        io_clock_ticks=io.clock.now,
        faults={k: v for k, v in snap.counters.items() if k.startswith((
            "io_faults_injected_total", "io_retries", "io_errors", "io_shed",
            "pool_torn", "pool_corrupt", "pool_lost"))},
        degraded_now=pool.degraded, breaker_trips=io.breaker.trips,
        degraded_events=[e["a"] for e in snap.events
                         if e["kind"] == "degraded"],
        replication_lag=[pool.replication_lag(i)
                         for i in range(pool.policy.n_shards)],
        replica_polls=pool._replicator.clock.now
        if pool._replicator is not None else None,
        failovers=times.failovers,
        journal_appends=times.appends, journal_base_writes=times.bases,
        journal_s=times.journal_s,
        tuner_rounds=int(pool.tuner._c_rounds.value),
        tuner_retunes=int(pool.tuner._c_retunes.value),
        tuner_round_ms=times.rounds_ms, cache_mrc_ms=mrc_ms,
        window_frac=[sh._window_frac for sh in pool.policy.shards])


def chaos_path(dev, served):
    """serve_main's model and 32 requests again, behind an engine with
    every pool knob armed (``chaos_knobs``: the shard loss at half of
    serve_main's host IO operations, the tuner profiling every quarter of
    its lookups); then ``cache_mrc`` once, each shard's journal recovered
    and the sharded policy through a snapshot file.  Gates: every request
    completes with tokens in the vocabulary, IO errors and torn writes
    were injected, a failover ran, ``cache_sim`` launched once a tuner
    round plus once for ``cache_mrc``, both attention kernels launched,
    the journals and the snapshot give the live bytes back.  Reported:
    the requests whose tokens equal serve_main's, and at each first
    divergence the top-2 margin of a teacher-forced prefill.  Returns
    the record, the launches and the pool's obs snapshot (JSON), which
    ``examples_main`` renders."""
    import shutil
    import tempfile
    from repro_torch import faults as F
    from repro_torch.faults import journal as fj
    from repro_torch.kernels.cache_sim import ops as cops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedConfig

    t0 = time.perf_counter()
    api, params = served["api"], served["params"]
    cfg = api.cfg
    k = served["io_ops"] // 2
    jdir = tempfile.mkdtemp(prefix="chaos-journal-")
    times = ChaosTimes(fj)
    try:
        knobs = chaos_knobs(F, k, served["lookups"], jdir)
        eng = ServingEngine(api, params, device=dev, **SERVE, **knobs)
        pool = eng.pool
        times.watch(pool, eng.mgr)
        rec = _instrument(eng)
        reqs = make_requests(32, seed=0, vocab=cfg.vocab)
        fops.launch_count = pops.launch_count = cops.launch_count = 0
        t1 = time.perf_counter()
        outs = eng.run(reqs, config=SchedConfig(
            max_batch=SERVE["max_batch"], token_budget=TOKEN_BUDGET))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        mrc, mrc_ms = event_ms(lambda: eng.cache_mrc(
            rate_shift=CHAOS_MRC_SHIFT))
        launches = dict(flash_attention=fops.launch_count,
                        paged_attention=pops.launch_count,
                        cache_sim=cops.launch_count)
        times.stop()
        report = chaos_report(pool, times, mrc_ms)
        snap_json = pool.obs_snapshot().to_json()
        by_id = {c.req_id: c for c in outs}
        done = [c for c in outs if c.status == "completed"]
        require(len(done) == 32 and all(len(c.tokens) == MAX_NEW and all(
            0 <= t < cfg.vocab for t in c.tokens) for c in done),
            f"chaos_path: {len(done)} of 32 completed "
            f"({[(c.req_id, c.status, len(c.tokens)) for c in outs]})")
        kinds = report["faults"]
        for kind in ("io_error", "partial_write"):
            require(kinds.get(f'io_faults_injected_total{{kind="{kind}"}}',
                              0) > 0, f"chaos_path: no {kind} injected")
        require(report["failovers"], "chaos_path: the shard loss at IO op "
                                     f"{k} never failed a shard over")
        rounds = report["tuner_rounds"]
        require(rounds >= 3 and launches["cache_sim"] == rounds + 1,
                f"chaos_path: cache_sim launches {launches['cache_sim']}, "
                f"tuner rounds {rounds} (want >= 3, and one launch a round "
                f"plus cache_mrc's)")
        require(launches["flash_attention"] > 0 and
                launches["paged_attention"] > 0,
                f"chaos_path: an attention kernel never launched {launches}")
        report.update(tuner_checks(pool.tuner, times.keys, "chaos_path",
                                   mrc=mrc, mrc_shift=CHAOS_MRC_SHIFT))
        report.update(chaos_checks(F, pool, jdir, "chaos_path"))
        same, divergences = [], []
        for r in reqs:
            want, got = served["tokens"][r.req_id], by_id[r.req_id].tokens
            if want == got:
                same.append(r.req_id)
                continue
            i = next(j for j in range(MAX_NEW) if want[j] != got[j])
            toks = torch.tensor([r.prompt + want[:i]], dtype=torch.long,
                                device=dev)
            logits, _ = api.prefill(params, toks, full_logits=True)
            top2 = torch.topk(logits[0, -1].float(), 2)
            divergences.append(dict(
                req=r.req_id, pos=i, serve_main=want[i], chaos=got[i],
                prefill=int(top2.indices[0]),
                margin=float(top2.values[0] - top2.values[1])))
        out_tokens = sum(len(c.tokens) for c in done)
        phase = dict(
            phase="chaos_path", model=cfg.name, n_layers=cfg.n_layers,
            dtype=cfg.dtype, engine=SERVE, requests=32,
            knobs=dict(n_shards=CHAOS_SHARDS, replicate=True,
                       journal_dir="tempfile.mkdtemp()", seed=CHAOS_SEED,
                       shard_loss_at=k, specs=[
                           dict(kind=F.FAULT_NAMES[sp.kind], prob=sp.prob,
                                at=list(sp.at), ticks=sp.ticks,
                                shard=sp.shard)
                           for sp in knobs["faults"].specs],
                       io_retry=dataclasses.asdict(knobs["io_retry"]),
                       autotune=knobs["autotune"]),
            serve_main_lookups=served["lookups"],
            serve_main_io_ops=served["io_ops"],
            completed=len(done), wall_s=wall,
            output_tokens_per_s=out_tokens / wall,
            decode_step_ms_p50=_pct(rec["decode_s"], 50),
            decode_step_ms_p99=_pct(rec["decode_s"], 99),
            decode_steps=len(rec["decode_s"]),
            prefill_ms_p50=_pct(rec["prefill_s"], 50),
            tokens_equal_serve_main=len(same),
            first_divergences=divergences,
            cache_mrc={str(c): v for c, v in mrc.items()},
            launches=launches, **report,
            seconds=time.perf_counter() - t0)
    finally:
        times.stop()
        shutil.rmtree(jdir, ignore_errors=True)
    del eng
    torch.cuda.empty_cache()
    return phase, launches, snap_json


def chaos_consistency(dev):
    """The exact gate of the chaos path, on serve_consistency's cut
    (granite-3-8b at full width in fp32, 4 layers, 8 requests) and a
    pool of ``CHAOS_HBM`` blocks, small enough that blocks swap: a
    fault-free twin (the same knobs with ``faults=None``,
    ``replicate=False``) serves first, then the chaos engine with the
    shard loss at half the twin's host IO operations.  Tokens must be
    equal request for request, and every token must match a
    teacher-forced prefill, near ties excepted and reported; the tuner's
    rounds must equal the plain sweep's.  Then ``chaos_rewarm``: the
    same storm with no standby, reported under ``rewarm``.  Returns the
    record and the rewarmed pool's obs snapshot (JSON)."""
    import shutil
    import tempfile
    from repro_torch import faults as F
    from repro_torch.configs import get_config
    from repro_torch.faults import journal as fj
    from repro_torch.models.model import build
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedConfig

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              n_layers=CONSISTENCY_LAYERS, dtype="float32",
                              param_dtype="float32")
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    reqs = make_requests(8, seed=1, vocab=cfg.vocab)
    serve = dict(SERVE, hbm_blocks=CHAOS_HBM)
    sched = SchedConfig(max_batch=SERVE["max_batch"],
                        token_budget=TOKEN_BUDGET)
    lookups = planned_lookups(reqs, serve["block_size"])
    twin_knobs = dict(chaos_knobs(F, 0, lookups, None), faults=None,
                      io_retry=None, replicate=False)
    twin = ServingEngine(api, params, device=dev, **serve, **twin_knobs)
    twin_out = {c.req_id: c for c in twin.run(reqs, config=sched)}
    twin_stats = twin.pool.stats
    require(twin_stats.hits + twin_stats.misses == lookups,
            f"chaos_consistency: the twin made "
            f"{twin_stats.hits + twin_stats.misses} lookups, {lookups} "
            f"planned")
    require(twin_stats.swap_out > 0 and twin_stats.swap_in > 0,
            f"chaos_consistency: {CHAOS_HBM} blocks swap nothing "
            f"({twin_stats})")
    k = (twin_stats.swap_in + twin_stats.swap_out) // 2
    del twin
    jdir = tempfile.mkdtemp(prefix="chaos-journal-")
    times = ChaosTimes(fj)
    try:
        eng = ServingEngine(api, params, device=dev, **serve,
                            **chaos_knobs(F, k, lookups, jdir))
        times.watch(eng.pool, eng.mgr)
        by_id = {c.req_id: c for c in eng.run(reqs, config=sched)}
        times.stop()
        report = chaos_report(eng.pool, times)
        report.update(tuner_checks(eng.pool.tuner, times.keys,
                                   "chaos_consistency"))
        require(all(by_id[r.req_id].status == "completed" and
                    len(by_id[r.req_id].tokens) == MAX_NEW for r in reqs),
                "chaos_consistency: a request did not complete")
        require(report["failovers"], "chaos_consistency: the shard loss at "
                                     f"IO op {k} never failed a shard over")
        differ = [r.req_id for r in reqs
                  if by_id[r.req_id].tokens != twin_out[r.req_id].tokens]
        require(not differ, f"chaos_consistency: requests {differ} give "
                            f"other tokens than the fault-free twin")
        compared, mismatches, ties = teacher_forced(api, params, reqs, by_id,
                                                    dev)
        require(not mismatches, f"chaos_consistency: tokens != teacher-"
                                f"forced prefill tokens: {mismatches}")
        report.update(chaos_checks(F, eng.pool, jdir, "chaos_consistency"))
    finally:
        times.stop()
        shutil.rmtree(jdir, ignore_errors=True)
    del eng
    rewarm, rewarm_snap = chaos_rewarm(api, params, reqs, twin_out, dict(
        chaos_knobs(F, k, lookups, None), replicate=False), serve, sched,
        dev)
    rec = dict(phase="chaos_consistency", model=cfg.name, dtype=cfg.dtype,
               reduced=[f"n_layers 40 -> {CONSISTENCY_LAYERS}"],
               hbm_blocks=CHAOS_HBM, requests=len(reqs), lookups=lookups,
               twin_pool=dataclasses.asdict(twin_stats), shard_loss_at=k,
               tokens_equal_twin=len(reqs), positions_compared=compared,
               mismatches=0, near_ties=ties, near_tie_margin=NEAR_TIE,
               **report, rewarm=rewarm, seconds=time.perf_counter() - t0)
    del params, api
    torch.cuda.empty_cache()
    return rec, rewarm_snap


def chaos_rewarm(api, params, reqs, twin_out, knobs, serve, sched, dev):
    """The chaos engine of ``chaos_consistency`` with no standby
    (``replicate=False``): the shard loss rebuilds shard 1 by the ghost
    rewarm under live sequences, from a ghost journal captured every
    ``CHAOS_GHOST_EVERY`` lookups (the engine keeps the pool's default
    of 1,024, more than this cut makes).  Gates: every request
    completes with tokens in the vocabulary, the failover was a rewarm
    that readmitted residents.  Reported, not gated: the requests whose tokens equal the
    fault-free twin's, the first divergences, and the teacher-forced
    mismatches.  The rewarm gives readmitted keys new slots while the
    live sequences' block tables keep the old ones, as the reference's
    does, so tokens may leave the twin's (ROADMAP.md queue 3).  Returns
    the record and the pool's obs snapshot (JSON)."""
    from repro_torch.faults import journal as fj
    from repro_torch.serving.engine import ServingEngine

    times = ChaosTimes(fj)
    try:
        eng = ServingEngine(api, params, device=dev, **serve, **knobs)
        eng.pool.journal_every = CHAOS_GHOST_EVERY
        times.watch(eng.pool, eng.mgr)
        by_id = {c.req_id: c for c in eng.run(reqs, config=sched)}
    finally:
        times.stop()
    vocab = api.cfg.vocab
    require(all(by_id[r.req_id].status == "completed" and
                len(by_id[r.req_id].tokens) == MAX_NEW and
                all(0 <= t < vocab for t in by_id[r.req_id].tokens)
                for r in reqs),
            "chaos_rewarm: a request did not complete")
    require([f["kind"] for f in times.failovers] == ["rewarm"] and
            times.failovers[0]["result"][0] > 0,
            f"chaos_rewarm: failovers {times.failovers}, want one rewarm "
            f"that readmits residents")
    differ = []
    for r in reqs:
        want, got = twin_out[r.req_id].tokens, by_id[r.req_id].tokens
        if want != got:
            i = next(j for j in range(MAX_NEW) if want[j] != got[j])
            differ.append(dict(req=r.req_id, pos=i, twin=want[i],
                               rewarm=got[i]))
    compared, mismatches, ties = teacher_forced(api, params, reqs, by_id,
                                                dev)
    stats = eng.pool.stats
    rec = dict(journal_every=CHAOS_GHOST_EVERY,
               pool=dataclasses.asdict(stats),
               injected=eng.pool._io.plan.injected,
               failovers=times.failovers,
               tokens_equal_twin=len(reqs) - len(differ),
               first_divergences=differ, positions_compared=compared,
               mismatches=len(mismatches), near_ties=ties)
    snap_json = eng.pool.obs_snapshot().to_json()
    del eng
    return rec, snap_json


# bf16 flash_attention shapes timed: serve_main's prefill at S 2048, and
# hybrid_main's (zamba2-2.7b's shared block over 4 x 2,048 tokens)
FLASH_TIMED = {"main": (1, 2048, 32, 8, 128), "hybrid": (4, 2048, 32, 32, 80)}
# The CUDA-core versions of the two kernels, before their Hopper redesign,
# as PERF.md's figures of that time give them: reported beside the new
# times and never compared with them, since they were measured another
# way.  ``--previous`` times those kernels the way this script times the
# present ones.
PREVIOUS_MS = {"flash_main": 2.1745, "flash_hybrid": 5.57, "paged": 0.2488}
PREVIOUS_ORIGIN = {
    "flash_main": "PERF.md, before the redesign: CUDA events, L2 emptied "
                  "by a 1 GiB write",
    "flash_hybrid": "PERF.md, before the redesign: profiler mean of 9 "
                    "launches in hybrid_main (50.1 ms / 9), L2 not emptied",
    "paged": "PERF.md, before the redesign: CUDA events, L2 emptied by a "
             "1 GiB write, the wrapper's value check (a host read) in the "
             "timed window"}
# serve_main's decode-length octiles (its seeded requests reach the same
# ones every run): the paged kernel's timed rows for ``--previous``
SERVE_DECODE_LENGTHS = [1196, 1263, 1372, 1487, 1663, 1839, 1910, 1985]


def attn_kernel_time(dev, lengths):
    """CUDA-event medians of each attention kernel at its paths' shapes
    (paged: B = 8 rows at serve_main's decode context lengths; flash:
    ``FLASH_TIMED``), L2 flushed between launches, beside its bound, its
    time before the redesign and one ``scaled_dot_product_attention``
    call as a yardstick (never called by the port)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops

    rng = np.random.default_rng(2)
    flush = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    q, kp, vp, bt, lens = paged_inputs(dev, torch.bfloat16, lengths, rng)
    before = pops.launch_count
    p_runs = warm_ms(lambda: pops.paged_attention(q, kp, vp, bt, lens,
                                                  validate=False), flush)
    require(pops.launch_count == before + len(p_runs) + 1,
            "timed paged call not one launch each")
    # the same calls with the wrapper's value check (a host read), as the
    # model makes one a step and as the times before the redesign had it
    p_checked = statistics.median(warm_ms(
        lambda: pops.paged_attention(q, kp, vp, bt, lens), flush))
    p_bound, p_by, p_bytes, p_ops = paged_bound(lengths)
    # the yardstick: K/V gathered to contiguous (B, S, Hkv, d) storage
    # first (not timed), a boolean length mask
    B_p, S = len(lengths), max(lengths)
    nbk = -(-S // 16)
    kc = kp[bt[:, :nbk].long()].reshape(B_p, -1, 8, 128)[:, :S]
    vc = vp[bt[:, :nbk].long()].reshape(B_p, -1, 8, 128)[:, :S]
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
    del kc, vc, mask, ref

    g = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(
        np.float32)).to(dev, torch.bfloat16)
    flash = {}
    for name, (B, S, H, Hkv, hd) in FLASH_TIMED.items():
        fq, fk, fv = g(B, S, H, hd), g(B, S, Hkv, hd), g(B, S, Hkv, hd)
        before = fops.launch_count
        f_runs = warm_ms(lambda: fops.flash_attention(fq, fk, fv, True),
                         flush)
        require(fops.launch_count == before + len(f_runs) + 1,
                "timed flash call not one launch each")
        f_bound, f_by, f_bytes, f_ops = flash_bound(B, S, H, Hkv, hd, True)
        tq, tk, tv = (t.transpose(1, 2) for t in (fq, fk, fv))
        f_lib = statistics.median(warm_ms(
            lambda: F.scaled_dot_product_attention(
                tq, tk, tv, is_causal=True, enable_gqa=True), flush))
        f_ms = statistics.median(f_runs)
        flash[name] = dict(
            shape=f"bf16, B={B}, S={S}, H={H}, Hkv={Hkv}, hd={hd}, causal",
            route=fops.route(fq.dtype), ms_runs=f_runs, ms=f_ms,
            bytes=f_bytes, ops=f_ops, bound_ms=f_bound, bound_by=f_by,
            roofline_share=f_bound / f_ms, tflops=f_ops / f_ms / 1e9,
            previous_ms=PREVIOUS_MS["flash_" + name],
            previous_ms_origin=PREVIOUS_ORIGIN["flash_" + name],
            library_ms=f_lib, library_tflops=f_ops / f_lib / 1e9,
            library_roofline_share=f_bound / f_lib,
            library="scaled_dot_product_attention, is_causal, enable_gqa")
        del fq, fk, fv, tq, tk, tv
    p_ms, p_lib = statistics.median(p_runs), statistics.median(p_lib)
    return dict(
        phase="attn_kernel_time",
        paged=dict(shape=f"bf16, B={B_p}, H=32, Hkv=8, d=128, bs=16, "
                         f"lengths {lengths}", ms_runs=p_runs, ms=p_ms,
                   n_splits=pops.plan_splits(B_p, 8, 160 * 16),
                   bytes=p_bytes, ops=p_ops, bound_ms=p_bound, bound_by=p_by,
                   roofline_share=p_bound / p_ms,
                   gbytes_per_s=p_bytes / p_ms / 1e6,
                   ms_with_value_check=p_checked,
                   previous_ms=PREVIOUS_MS["paged"],
                   previous_ms_origin=PREVIOUS_ORIGIN["paged"],
                   library_ms=p_lib,
                   library_roofline_share=p_bound / p_lib,
                   library="scaled_dot_product_attention over K/V gathered "
                           "to contiguous storage (gather not timed), "
                           "boolean length mask, enable_gqa",
                   library_max_abs_err=lib_err),
        flash=flash["main"], flash_hybrid=flash["hybrid"],
        l2_flush_bytes=flush.numel() * 4)


def _load_module(path: str, name: str):
    """The module of file ``path``, imported under ``name``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_previous(path: str, name: str):
    """``_load_module`` for a module of an earlier checkout: its
    ``torch.library`` operators are registered as ``repro_torch_previous::``
    ones.  A second ``custom_op`` of one name takes the first one's place
    for every caller, so under the present names the present wrappers
    would launch the earlier tree's kernels."""
    real = torch.library.custom_op

    def renamed(qualname, *args, **kw):
        return real(qualname.replace("repro_torch::", "repro_torch_previous::",
                                     1), *args, **kw)
    torch.library.custom_op = renamed
    try:
        return _load_module(path, name)
    finally:
        torch.library.custom_op = real


def attn_previous(dev, tree: str):
    """The two attention kernels of another checkout ``tree`` (an earlier
    commit) timed beside the present ones in the same way as
    ``attn_kernel_time`` (CUDA events, L2 emptied by a 1 GiB read, medians
    of 20; paged without the value check), in the order earlier, present,
    present, earlier; and each kernel's max and mean |err| against its
    plain version on fp32 copies of the same inputs (no bf16 rounding of
    the reference's output).  Then the flash backward the same way at
    ``FLASH_TRAIN_SHAPE`` (bf16, causal, medians of 10, as
    ``flash_bwd_time``), its errors over dq, dk, dv against the unrounded
    plain backward; a tree whose flash ops name no ``BWD_SOURCE`` has
    none and is reported absent.
    Only ``tree``'s wrappers and CUDA sources are used; they build and
    load through this checkout's ``kernels/build``."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain, flash_attention_plain,
    )
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain

    kdir = os.path.join(os.path.abspath(tree), "src", "repro_torch",
                        "kernels")
    old_f = _load_previous(os.path.join(kdir, "flash_attention", "ops.py"),
                           "previous_flash_ops")
    old_p = _load_previous(os.path.join(kdir, "paged_attention", "ops.py"),
                           "previous_paged_ops")
    old_bwd = getattr(old_f, "BWD_SOURCE", None)
    t0 = time.perf_counter()
    kbuild.build_many([("flash_attention", fops.SOURCE),
                       ("paged_attention", pops.SOURCE),
                       ("flash_attention_bwd", fops.BWD_SOURCE),
                       ("flash_attention", old_f.SOURCE),
                       ("paged_attention", old_p.SOURCE)]
                      + ([("flash_attention_bwd", old_bwd)] if old_bwd else []))
    rec = dict(phase="attn_previous", tree=tree,
               build_s=time.perf_counter() - t0)
    rng = np.random.default_rng(2)
    flush = torch.empty(256 << 20, dtype=torch.float32, device=dev)

    def both(old, new, want):
        """[earlier, present, present, earlier] medians and the max and
        mean errors of ``old()`` and ``new()`` against ``want``."""
        ms = [statistics.median(warm_ms(f, flush))
              for f in (old, new, new, old)]
        err = [(f().float() - want).abs() for f in (old, new)]
        return dict(previous_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]],
                    previous_max_abs_err=float(err[0].max()),
                    max_abs_err=float(err[1].max()),
                    previous_mean_abs_err=float(err[0].mean()),
                    mean_abs_err=float(err[1].mean()))

    q, kp, vp, bt, lens = paged_inputs(dev, torch.bfloat16,
                                       SERVE_DECODE_LENGTHS, rng)
    want = paged_attention_plain(q.float(), kp.float(), vp.float(), bt, lens)
    rec["paged"] = dict(
        shape=f"bf16, B=8, H=32, Hkv=8, d=128, bs=16, lengths "
              f"{SERVE_DECODE_LENGTHS}",
        **both(lambda: old_p.paged_attention(q, kp, vp, bt, lens,
                                             validate=False),
               lambda: pops.paged_attention(q, kp, vp, bt, lens,
                                            validate=False), want))
    del q, kp, vp, bt, lens, want
    g = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(
        np.float32)).to(dev, torch.bfloat16)
    for name, (B, S, H, Hkv, hd) in FLASH_TIMED.items():
        q, k, v = g(B, S, H, hd), g(B, S, Hkv, hd), g(B, S, Hkv, hd)
        want = flash_attention_plain(q.float(), k.float(), v.float(), True)
        rec["flash_" + name] = dict(
            shape=f"bf16, B={B}, S={S}, H={H}, Hkv={Hkv}, hd={hd}, causal",
            **both(lambda: old_f.flash_attention(q, k, v, True),
                   lambda: fops.flash_attention(q, k, v, True), want))
        del q, k, v, want
    B, S, H, Hkv, hd = FLASH_TRAIN_SHAPE
    shape = f"bf16, B={B}, S={S}, H={H}, Hkv={Hkv}, hd={hd}, causal"
    if old_bwd is None:
        rec["flash_bwd"] = dict(shape=shape, previous="absent: the earlier "
                                "tree has no flash_attention_bwd")
    else:
        q, k, v, do = g(B, S, H, hd), g(B, S, Hkv, hd), g(B, S, Hkv, hd), \
            g(B, S, H, hd)
        o, lse = fops.flash_attention_fwd(q, k, v, True)
        calls = [lambda m=m: m.flash_attention_bwd(q, k, v, o, lse, do, True)
                 for m in (old_f, fops)]
        ms = [statistics.median(warm_ms(calls[i], flush, 10))
              for i in (0, 1, 1, 0)]
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, True)
        err = [torch.cat([(a.float() - w).abs().flatten()
                          for a, w in zip(f(), want)]) for f in calls]
        rec["flash_bwd"] = dict(
            shape=shape, previous_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]],
            previous_max_abs_err=float(err[0].max()),
            max_abs_err=float(err[1].max()),
            previous_mean_abs_err=float(err[0].mean()),
            mean_abs_err=float(err[1].mean()))
        del q, k, v, do, o, lse, want, err
    rec["l2_flush_bytes"] = flush.numel() * 4
    return rec


# -- the SSM and hybrid paths ------------------------------------------------------

SCAN_SHAPES = [(1, 1, 8192, 16), (2, 17, 8192, 16), (1, 255, 96, 8),
               (2, 256, 128, 4), (4, 2048, 8192, 16)]   # B, S, din, N
SCAN_MAIN = (4, 2048, 8192, 16)  # falcon-mamba-7b's prefill: 4 x 2,048 tokens
SCAN_DT_RANK = 256          # falcon-mamba-7b's dt_rank: x_proj's leading cols
GEN_BATCH, GEN_PROMPT, GEN_STEPS = 4, 2048, 32
PROFILE_STEPS = 8
TF_PROMPT, TF_STEPS = 512, 8     # consistency: prompt length, decoded tail
GEN_CONSISTENCY_LAYERS = {"falcon-mamba-7b": 4, "zamba2-2.7b": 12,
                          "granite-3-8b": CONSISTENCY_LAYERS}
BUF_RING, BUF_STEPS = 4, 9       # dense_consistency: ring, buffered steps
LOGIT_TOL, STATE_TOL = 2e-4, 1e-4  # relative to the reference's max |x|
SFU_PER_CLK_SM = 16         # exponentials a clock per SM (special-function units)
SM_CLOCK_HZ = 1.98e9        # H100 SXM maximum SM clock


def scan_inputs(dev, shape, dtype, rng, R: int = 0):
    """``mamba_scan`` inputs as tests/test_kernels.py makes them (dt =
    |randn| 0.1 in fp32, A_log = randn 0.5), u/B/C in ``dtype``.  With
    ``R``, B and C are views into one (B, S, R + 2N) tensor, as the
    model's x_proj output hands them over."""
    B, S, din, N = shape
    g = lambda *s: torch.from_numpy(
        rng.normal(0, 1, s).astype(np.float32)).to(dev)
    u, dt = g(B, S, din).to(dtype), g(B, S, din).abs() * 0.1
    dbc = g(B, S, R + 2 * N).to(dtype)
    return u, dt, dbc[..., R:R + N], dbc[..., R + N:], g(din, N) * 0.5


def mamba_scan_vs_plain(dev):
    """The scan kernel against its plain version on the card: fp32 y and
    h_last within 1e-4 (tests/test_kernels.py's bound); bf16 u/B/C (both
    versions on the same rounded inputs): y within 2e-2 of max |y| and,
    element by element, within one bf16 step (2^-7 |y|) plus 1e-4 of
    max |y|; h_last within 1e-3.  At falcon-mamba's width (din 8192) B
    and C are the strided views of x_proj's output (dt_rank 256) that
    the model hands over; at the other widths they are views into one
    (B, S, 2N) tensor."""
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_plain

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    cases = []
    for dt_name in ("float32", "bfloat16"):
        for shape in SCAN_SHAPES:
            R = SCAN_DT_RANK if shape[2] == SCAN_MAIN[2] else 0
            ins = scan_inputs(dev, shape, getattr(torch, dt_name), rng, R=R)
            y, h = sops.mamba_scan(*ins)
            torch.cuda.synchronize()
            y0, h0 = mamba_scan_plain(*ins)
            diff = (y.float() - y0.float()).abs()
            y_err = float(diff.max())
            h_err = float((h - h0).abs().max())
            y_max = float(y0.float().abs().max())
            if dt_name == "float32":
                y_tol, h_tol, elem_ok = 1e-4, 1e-4, True
            else:
                y_tol, h_tol = 2e-2 * y_max, 1e-3
                elem_ok = bool((diff <= 2.0 ** -7 * y0.float().abs()
                                + 1e-4 * y_max).all())
            require(y.dtype == y0.dtype and y_err <= y_tol and elem_ok
                    and h_err <= h_tol,
                    f"mamba_scan {dt_name} {shape} R={R} != plain (y err "
                    f"{y_err} of tol {y_tol}, within one bf16 step "
                    f"{elem_ok}, h_last err {h_err} of tol {h_tol})")
            cases.append(dict(dtype=dt_name, shape=shape,
                              bc_stride_t=int(ins[2].stride(1)), y_err=y_err,
                              y_tol=y_tol, y_max=y_max,
                              y_elementwise=None if dt_name == "float32"
                              else "2^-7 |y| + 1e-4 max |y|",
                              h_last_err=h_err, h_last_tol=h_tol))
    # both versions' times at the main path's shape and types
    flush = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    ins = scan_inputs(dev, SCAN_MAIN, torch.bfloat16, rng, R=SCAN_DT_RANK)
    plain_ms = statistics.median(warm_ms(lambda: mamba_scan_plain(*ins),
                                         flush, 3))
    kernel_ms = statistics.median(warm_ms(lambda: sops.mamba_scan(*ins),
                                          flush, 5))
    return dict(phase="mamba_scan_vs_plain", cases=cases,
                max_abs_err=max(max(c["y_err"], c["h_last_err"])
                                for c in cases),
                plain_ms=plain_ms, kernel_ms_at_plain_shape=kernel_ms,
                plain_shape=f"bf16 u/B/C (B/C views of x_proj's output), "
                            f"fp32 dt, (B, S, din, N) = {SCAN_MAIN}",
                seconds=time.perf_counter() - t0)


def hybrid_attn_vs_plain(dev):
    """``flash_attention`` against its plain version on the q, k, v the
    hybrid's shared block hands it in ``hybrid_main``'s prefill:
    zamba2-2.7b's width (H = Hkv = 32, hd 80, causal), ``GEN_BATCH`` x
    ``GEN_PROMPT`` positions, made by ``hybrid.shared_qkv`` from random
    shared-block weights and activations (seeded generator on the card);
    fp32 and bf16 at the attention tolerances."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.models import hybrid
    from repro_torch.models import layers as L

    t0 = time.perf_counter()
    cases = []
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config("zamba2-2.7b"), dtype=dt,
                                  param_dtype=dt)
        gen = torch.Generator(device=dev).manual_seed(0)
        p = {"ln1": L.norm_params(cfg, device=dev),
             "attn": L.attn_params(cfg, gen)}
        x = torch.randn((GEN_BATCH, GEN_PROMPT, cfg.d_model), generator=gen,
                        device=dev).to(L.dtype_of(cfg))
        positions = torch.arange(GEN_PROMPT, device=dev).expand(
            GEN_BATCH, GEN_PROMPT)
        rope = L.rope_tables(positions, cfg.hd, cfg.rope_theta, cfg.rope_frac)
        q, k, v = hybrid.shared_qkv(cfg, p, x, rope)
        got = fops.flash_attention(q, k, v, causal=True)
        want = flash_attention_plain(q, k, v, True)
        err, ok = _err(got, want, ATTN_TOL[dt][0])
        require(ok, f"flash_attention {dt} at the hybrid's shape "
                    f"{tuple(q.shape)} != plain (max err {err})")
        cases.append(dict(dtype=dt, B=q.shape[0], S=q.shape[1],
                          H=q.shape[2], Hkv=k.shape[2], hd=q.shape[3],
                          causal=True, q_strides=list(q.stride()),
                          k_strides=list(k.stride()),
                          v_strides=list(v.stride()), tol=ATTN_TOL[dt][0],
                          max_abs_err=err))
        del p, x, q, k, v, got, want
    torch.cuda.empty_cache()
    return dict(phase="hybrid_attn_vs_plain", model="zamba2-2.7b",
                inputs="hybrid.shared_qkv of random weights and activations",
                cases=cases, max_abs_err=max(c["max_abs_err"] for c in cases),
                seconds=time.perf_counter() - t0)


def _n_params(params) -> int:
    if isinstance(params, dict):
        return sum(_n_params(v) for v in params.values())
    return params.numel()


def _greedy(logits):
    return logits[:, -1].argmax(-1, keepdim=True)


def generate_main(dev, arch: str, phase: str, layers=None):
    """``arch`` at its published width and depth, or cut to ``layers``
    layers (random bf16 weights from a seeded generator on the card),
    through the model API: one ``prefill`` of ``GEN_BATCH`` prompts of
    ``GEN_PROMPT`` tokens, then ``GEN_STEPS`` greedy ``decode`` steps,
    batch long-context generation.  Returns the phase record
    (``launches``: per kernel, in that run)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.models.hybrid import n_shared_invocations
    from repro_torch.models.model import build

    cfg = get_config(arch)
    reduced = (f"layers {cfg.n_layers} -> {layers} (the script's time)"
               if layers else None)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    api = build(cfg)
    gc.collect()  # earlier phases' reference cycles may still hold tensors
    torch.cuda.empty_cache()
    before_bytes = torch.cuda.memory_allocated(dev)  # left by earlier phases
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = torch.cuda.memory_allocated(dev) - before_bytes
    init_peak = torch.cuda.max_memory_allocated(dev)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (GEN_BATCH, GEN_PROMPT)), device=dev)
    max_len = GEN_PROMPT + GEN_STEPS
    # warm-up off the counts: a short prefill and one step
    _, c = api.prefill(params, prompts[:, :64], max_len=65)
    api.decode(params, prompts[:, :1], c)
    del c
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(dev)
    sops.launch_count = fops.launch_count = pops.launch_count = 0
    t1 = time.perf_counter()
    logits, cache = api.prefill(params, prompts, max_len=max_len)
    tokens = [_greedy(logits)]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    prefill_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step_s = []
    for _ in range(GEN_STEPS):
        t1 = time.perf_counter()
        logits, cache = api.decode(params, tokens[-1], cache)
        tokens.append(_greedy(logits))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
    launches = dict(mamba_scan=sops.launch_count,
                    flash_attention=fops.launch_count,
                    paged_attention=pops.launch_count)
    out = torch.cat(tokens, dim=1)
    require(bool(torch.isfinite(logits).all()) and
            out.shape == (GEN_BATCH, GEN_STEPS + 1) and
            bool(((out >= 0) & (out < cfg.vocab)).all()),
            f"{phase}: non-finite logits or tokens outside the vocabulary")
    ssm = cfg.family in ("ssm", "hybrid")
    rec = dict(
        phase=phase, model=cfg.name, family=cfg.family,
        n_layers=cfg.n_layers, reduced=reduced, d_model=cfg.d_model,
        **(dict(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state) if ssm else
           dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.hd)), dtype=cfg.dtype,
        shared_invocations=(n_shared_invocations(cfg)
                            if cfg.family == "hybrid" else 0),
        n_params=_n_params(params), n_params_analytic=cfg.n_params(),
        weights="random, torch.Generator(cuda).manual_seed(0)",
        batch=GEN_BATCH, prompt_len=GEN_PROMPT, decode_steps=GEN_STEPS,
        init_s=init_s, prefill_ms=1e3 * prefill_s,
        prefill_tokens_per_s=GEN_BATCH * GEN_PROMPT / prefill_s,
        decode_step_ms_p50=_pct(step_s, 50),
        decode_step_ms_p99=_pct(step_s, 99),
        decode_tokens_per_s=GEN_BATCH * GEN_STEPS / sum(step_s),
        allocated_before_bytes=before_bytes, weight_bytes=weight_bytes,
        init_peak_device_bytes=init_peak,
        prefill_peak_device_bytes=prefill_peak,
        decode_peak_device_bytes=torch.cuda.max_memory_allocated(dev),
        launches=launches, first_tokens=out[0, :8].tolist())
    del cache, logits
    rec["profile"] = generate_profile(dev, api, params, prompts)
    del params, api
    torch.cuda.empty_cache()
    return rec


def generate_profile(dev, api, params, prompts):
    """One prefill and ``PROFILE_STEPS`` greedy decode steps under
    ``torch.profiler`` (``profile_summary``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, prompts,
                                    max_len=prompts.shape[1] + PROFILE_STEPS)
        tok = _greedy(logits)
        for _ in range(PROFILE_STEPS):
            logits, cache = api.decode(params, tok, cache)
            tok = _greedy(logits)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return dict(prefills=1, decode_steps=PROFILE_STEPS, **profile_summary(
        prof, wall, {"mamba_scan": "mamba_scan_kernel",
                     "flash_attention": "flash_attention_kernel",
                     "paged_attention": "paged_attention_kernel"}))


def _rel_err(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()) / (
        float(want.abs().max()) + 1e-30)


def greedy_picks(phase: str, got, want, pos0: int) -> list:
    """Greedy picks of decode logits ``got`` against teacher-forced
    logits ``want`` (B, T, V), positions from ``pos0``: fails on a
    differing pick unless its top-2 margin is below ``NEAR_TIE``; returns
    those near ties."""
    top2 = torch.topk(want.float(), 2, dim=-1)
    margin = top2.values[..., 0] - top2.values[..., 1]
    pick = got.argmax(-1)
    mismatches, ties = [], []
    for b, i in (pick != top2.indices[..., 0]).nonzero().tolist():
        item = dict(seq=b, pos=pos0 + i, decode=int(pick[b, i]),
                    prefill=int(top2.indices[b, i, 0]),
                    margin=float(margin[b, i]))
        (ties if item["margin"] < NEAR_TIE else mismatches).append(item)
    require(not mismatches, f"{phase}: greedy picks differ {mismatches}")
    return ties


def generate_consistency(dev, arch: str, phase: str, buffered: int = 0):
    """The decode path against the prefill path on the whole model:
    ``arch`` at full width in fp32, depth cut.  ``prefill`` of a prompt
    less its last ``TF_STEPS`` tokens, then ``TF_STEPS`` teacher-forced
    ``decode`` steps, against one ``prefill(prompt, full_logits=True)``
    at the same positions: logits within 2e-4 of max |logit|
    (tests/test_models.py's bound), the final states within 1e-4 of
    their max |x|, and greedy picks equal, near ties (top-2 margin <
    1e-3) reported apart.  ``buffered``: also the buffered decode with a
    ring of that many positions (``buffered_check``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build

    t0 = time.perf_counter()
    full_cfg = get_config(arch)
    n = GEN_CONSISTENCY_LAYERS[arch]
    cfg = dataclasses.replace(full_cfg, n_layers=n, dtype="float32",
                              param_dtype="float32")
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, TF_PROMPT)), device=dev)
    S = TF_PROMPT
    logits, cache = api.prefill(params, prompt[:, :S - TF_STEPS], max_len=S)
    got = [logits[:, -1]]
    for j in range(S - TF_STEPS, S):
        logits, cache = api.decode(params, prompt[:, j:j + 1], cache)
        got.append(logits[:, -1])
    got = torch.stack(got, dim=1)                # positions S-9 .. S-1
    full, fcache = api.prefill(params, prompt, full_logits=True, max_len=S)
    want = full[:, S - TF_STEPS - 1:]
    logit_err = _rel_err(got, want)
    state_err = {f: _rel_err(getattr(cache, f), getattr(fcache, f))
                 for f in cache._fields if f != "length"}
    require(logit_err <= LOGIT_TOL, f"{phase}: decode logits != prefill "
                                    f"logits (rel err {logit_err})")
    require(all(e <= STATE_TOL for e in state_err.values()),
            f"{phase}: decode states != prefill states {state_err}")
    ties = greedy_picks(phase, got, want, S - TF_STEPS - 1)
    rec = dict(phase=phase, model=cfg.name, dtype=cfg.dtype,
               reduced=[f"n_layers {full_cfg.n_layers} -> {n}"],
               batch=2, prompt_len=S, decode_steps=TF_STEPS,
               positions_compared=int(got.shape[0] * got.shape[1]),
               logit_rel_err=logit_err, logit_tol=LOGIT_TOL,
               state_rel_err=state_err, state_tol=STATE_TOL, mismatches=0,
               near_ties=ties, near_tie_margin=NEAR_TIE,
               allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    del cache, fcache
    if buffered:
        rec["buffered"] = buffered_check(cfg, api, params, prompt, buffered)
    rec["seconds"] = time.perf_counter() - t0
    del params, api
    torch.cuda.empty_cache()
    return rec


def buffered_check(cfg, api, params, prompt, R: int) -> dict:
    """``forward_decode_buffered`` against the contiguous decode: one
    prefill of the prompt less its last ``BUF_STEPS`` tokens, its cache
    also copied into a head-major base with a ring of ``R``; then both
    decodes teacher-forced over those tokens, the ring committed whenever
    full (twice at R = 4): logits within ``LOGIT_TOL`` of the contiguous
    decode's max |logit|."""
    from repro_torch.models import transformer as T

    S = prompt.shape[1]
    S0 = S - BUF_STEPS
    _, cache = api.prefill(params, prompt[:, :S0], max_len=S)
    buf = T.to_buffered(cache, R)
    want, got, commits = [], [], 0
    for j in range(S0, S):
        tok = prompt[:, j:j + 1]
        if buf.buf_len == R:
            buf = T.commit_buffer(cfg, buf)
            commits += 1
        logits, buf = T.forward_decode_buffered(cfg, params, tok, buf)
        got.append(logits[:, -1])
        logits, cache = api.decode(params, tok, cache)
        want.append(logits[:, -1])
    err = _rel_err(torch.stack(got, 1), torch.stack(want, 1))
    require(commits == 2 and err <= LOGIT_TOL,
            f"buffered decode != contiguous decode (rel err {err}, "
            f"{commits} commits)")
    return dict(ring=R, steps=BUF_STEPS, commits=commits,
                base_len=buf.base_len, buf_len=buf.buf_len,
                logit_rel_err=err, logit_tol=LOGIT_TOL)


# -- the encoder-decoder (whisper-tiny) -------------------------------------------

WHISPER = "whisper-tiny"
ENC_BATCH, ENC_FRAMES = 8, 1500   # 8 clips of whisper's 30 s window
ENC_MAX_LEN, ENC_STEPS = 448, 64  # whisper's text context; greedy steps
SOT = (50258, 50259, 50359, 50363)  # <|startoftranscript|><|en|>
#                                     <|transcribe|><|notimestamps|>
ENC_TF_CLIPS, ENC_TF_STEPS = 2, 8  # encdec_consistency: clips, decoded tail


def _audio(dev, B: int, cfg, dtype, seed: int):
    """Stub frontend output: (B, ENC_FRAMES, d_model) unit-variance frame
    embeddings from a seeded generator on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((B, ENC_FRAMES, cfg.d_model), generator=g,
                       device=dev).to(dtype)


def encdec_main(dev):
    """whisper-tiny at its published size (4 + 4 layers, d 384, 6 heads of
    64, vocab 51,865, bf16, random weights): ``ENC_BATCH`` clips of
    ``ENC_FRAMES`` stub frame embeddings and the 4-token
    start-of-transcript prompt through one ``prefill`` (the encoder, the
    decoder's prompt and its cross-attention on the flash kernel), then
    ``ENC_STEPS`` greedy ``decode`` steps over ``ENC_MAX_LEN`` positions
    (both attentions on the paged kernel's one-page views).  Returns
    (phase record, launches per kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.models import encdec as E

    t0 = time.perf_counter()
    cfg = get_config(WHISPER)
    api, params, init_s, weight_bytes, init_peak = _init_model(dev, cfg)
    audio = _audio(dev, ENC_BATCH, cfg, getattr(torch, cfg.dtype), 0)
    prompt = torch.tensor([SOT] * ENC_BATCH, device=dev)
    # warm-up, not counted: one clip, so the positions' tables are made
    _, c = api.prefill(params, prompt[:1], audio_embeds=audio[:1], max_len=8)
    api.decode(params, prompt[:1, :1], c)
    del c
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(dev)
    fops.launch_count = pops.launch_count = 0
    t1 = time.perf_counter()
    logits, cache = api.prefill(params, prompt, audio_embeds=audio,
                                max_len=ENC_MAX_LEN)
    tokens = [_greedy(logits)]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    prefill_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step_s = []
    for _ in range(ENC_STEPS):
        t1 = time.perf_counter()
        logits, cache = api.decode(params, tokens[-1], cache)
        tokens.append(_greedy(logits))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
    launches = dict(flash_attention=fops.launch_count,
                    paged_attention=pops.launch_count, cache_sim=0)
    want = dict(flash_attention=cfg.n_enc_layers + 2 * cfg.n_layers,
                paged_attention=ENC_STEPS * 2 * cfg.n_layers, cache_sim=0)
    require(launches == want, f"encdec_main: launches {launches}, want "
                              f"{want} (flash: each encoder layer, each "
                              f"decoder layer's self- and cross-attention "
                              f"once; paged: both a decoder layer a step)")
    out = torch.cat(tokens, dim=1)
    require(bool(torch.isfinite(logits).all()) and
            out.shape == (ENC_BATCH, ENC_STEPS + 1) and
            bool(((out >= 0) & (out < cfg.vocab)).all()) and
            cache.length == len(SOT) + ENC_STEPS,
            "encdec_main: non-finite logits, tokens outside the vocabulary "
            "or a cache of the wrong length")
    decode_peak = torch.cuda.max_memory_allocated(dev)
    enc_ms = statistics.median(warm_ms(
        lambda: E.encode(cfg, params, audio), None, 5))
    rec = dict(
        phase="encdec_main", model=cfg.name, family=cfg.family,
        n_enc_layers=cfg.n_enc_layers, n_layers=cfg.n_layers,
        d_model=cfg.d_model, n_heads=cfg.n_heads, head_dim=cfg.hd,
        vocab=cfg.vocab, dtype=cfg.dtype,
        n_params=_n_params(params), n_params_analytic=cfg.n_params(),
        weights="random, torch.Generator(cuda).manual_seed(0)",
        audio="stub frame embeddings, torch.Generator(cuda).manual_seed(0)",
        batch=ENC_BATCH, frames=ENC_FRAMES, prompt=list(SOT),
        max_len=ENC_MAX_LEN, decode_steps=ENC_STEPS, init_s=init_s,
        encode_prefill_ms=1e3 * prefill_s, encode_ms_alone=enc_ms,
        decode_step_ms_p50=_pct(step_s, 50),
        decode_step_ms_p99=_pct(step_s, 99),
        decode_tokens_per_s=ENC_BATCH * ENC_STEPS / sum(step_s),
        weight_bytes=weight_bytes, init_peak_device_bytes=init_peak,
        prefill_peak_device_bytes=prefill_peak,
        decode_peak_device_bytes=decode_peak, launches=launches,
        first_tokens=out[0, :8].tolist(), seconds=time.perf_counter() - t0)
    del params, api, cache, logits, audio
    torch.cuda.empty_cache()
    return rec, launches


def encdec_consistency(dev):
    """whisper-tiny at full size in fp32, ``ENC_TF_CLIPS`` clips: a prefill
    of the prompt less its last ``ENC_TF_STEPS`` tokens, then those tokens
    teacher-forced through ``decode``, each step's logits against a
    prefill of the same prefix (whose last position is that step's)
    within ``LOGIT_TOL`` of max |logit|, the final caches against the
    whole prompt's prefill within ``STATE_TOL``, greedy picks equal (near
    ties apart); then the whole prompt's prefill on the card against the
    port on the CPU (the same params through numpy), logits and caches
    within ``VLM_TOL``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import (build, params_from_numpy,
                                          params_to_numpy)

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(WHISPER), dtype="float32",
                              param_dtype="float32")
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(6)
    audio = torch.from_numpy(rng.normal(
        0, 1, (ENC_TF_CLIPS, ENC_FRAMES, cfg.d_model)).astype(np.float32))
    toks = np.concatenate([np.array([SOT] * ENC_TF_CLIPS), rng.integers(
        0, cfg.vocab, (ENC_TF_CLIPS, 2 * ENC_TF_STEPS))], axis=1)
    prompt, a = torch.as_tensor(toks, device=dev), audio.to(dev)
    S, S0 = prompt.shape[1], prompt.shape[1] - ENC_TF_STEPS
    logits, cache = api.prefill(params, prompt[:, :S0], audio_embeds=a,
                                max_len=S)
    got, want = [], []
    for j in range(S0, S):
        logits, cache = api.decode(params, prompt[:, j:j + 1], cache)
        got.append(logits[:, -1])
        ref, _ = api.prefill(params, prompt[:, :j + 1], audio_embeds=a)
        want.append(ref[:, -1])
    got, want = torch.stack(got, 1), torch.stack(want, 1)
    t1 = time.perf_counter()
    full, fcache = api.prefill(params, prompt, audio_embeds=a, max_len=S)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t1
    logit_err = _rel_err(got, want)
    state_err = {f: _rel_err(getattr(cache, f), getattr(fcache, f))
                 for f in ("k", "v", "xk", "xv")}
    require(logit_err <= LOGIT_TOL, f"encdec_consistency: decode logits != "
                                    f"prefill logits (rel err {logit_err})")
    require(all(e <= STATE_TOL for e in state_err.values()),
            f"encdec_consistency: decode caches != prefill caches "
            f"{state_err}")
    ties = greedy_picks("encdec_consistency", got, want, S0)
    host = params_from_numpy(cfg, params_to_numpy(params), device="cpu")
    t1 = time.perf_counter()
    cpu, ccache = api.prefill(host, torch.from_numpy(toks),
                              audio_embeds=audio, max_len=S)
    cpu_s = time.perf_counter() - t1
    cpu_err = _rel_err(full.cpu(), cpu)
    cpu_state = {f: _rel_err(getattr(fcache, f).cpu(), getattr(ccache, f))
                 for f in ("k", "v", "xk", "xv")}
    require(cpu_err <= VLM_TOL and max(cpu_state.values()) <= VLM_TOL,
            f"encdec_consistency: card != CPU (logits rel err {cpu_err}, "
            f"caches {cpu_state}; tolerance {VLM_TOL})")
    rec = dict(phase="encdec_consistency", model=cfg.name, dtype=cfg.dtype,
               clips=ENC_TF_CLIPS, frames=ENC_FRAMES, prompt_len=S,
               decode_steps=ENC_TF_STEPS,
               positions_compared=int(got.shape[0] * got.shape[1]),
               logit_rel_err=logit_err, logit_tol=LOGIT_TOL,
               state_rel_err=state_err, state_tol=STATE_TOL, mismatches=0,
               near_ties=ties, cpu_logit_rel_err=cpu_err, cpu_state_rel_err=cpu_state,
               cpu_tol=VLM_TOL, card_prefill_s=card_s, cpu_prefill_s=cpu_s,
               cpu_threads=torch.get_num_threads(),
               allow_tf32=torch.backends.cuda.matmul.allow_tf32,
               seconds=time.perf_counter() - t0)
    del params, host, api, cache, fcache
    torch.cuda.empty_cache()
    return rec


def scan_bound(shape, esize=2):
    """(bound_ms, bound_by, bytes, bytes_ms, exps, exps_ms) of one scan
    at ``shape``: u and y in ``esize`` bytes, dt in fp32 (read once
    each), B and C in ``esize``, A_log and h_last in fp32; B S din N
    exponentials at the special-function units' rate."""
    B, S, din, N = shape
    moved = (B * S * din * (2 * esize + 4) + 2 * B * S * N * esize
             + 4 * din * N + 4 * B * din * N)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exps = B * S * din * N
    bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
    exps_ms = 1e3 * exps / (SFU_PER_CLK_SM * sms * SM_CLOCK_HZ)
    by = "bytes" if bytes_ms >= exps_ms else "operations"
    return max(bytes_ms, exps_ms), by, moved, bytes_ms, exps, exps_ms


def mamba_scan_time(dev):
    """CUDA-event median of 20 scan launches at the main path's shape and
    types (B and C strided as the model hands them), L2 flushed, beside
    its bound.  No single PyTorch call computes the selective scan, so
    there is no library yardstick."""
    from repro_torch.kernels.mamba_scan import ops as sops

    flush = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    ins = scan_inputs(dev, SCAN_MAIN, torch.bfloat16,
                      np.random.default_rng(3), R=SCAN_DT_RANK)
    before = sops.launch_count
    runs = warm_ms(lambda: sops.mamba_scan(*ins), flush)
    require(sops.launch_count == before + len(runs) + 1,
            "timed scan call not one launch each")
    bound, by, moved, bytes_ms, exps, exps_ms = scan_bound(SCAN_MAIN)
    ms = statistics.median(runs)
    return dict(phase="mamba_scan_time",
                shape=f"bf16 u/B/C (B/C views of x_proj's output), fp32 dt, "
                      f"(B, S, din, N) = {SCAN_MAIN}",
                ms_runs=runs, ms=ms, bytes=moved, bytes_ms=bytes_ms,
                bytes_rate=f"{HBM_BYTES_PER_S:.3g} B/s",
                exps=exps, exps_ms=exps_ms,
                exps_rate=f"{SFU_PER_CLK_SM} a clock per SM x "
                          f"{torch.cuda.get_device_properties(0).multi_processor_count}"
                          f" SMs x {SM_CLOCK_HZ:.3g} Hz",
                bound_ms=bound, bound_by=by, roofline_share=bound / ms,
                library_ms=None, l2_flush_bytes=flush.numel() * 4)


# -- the sweep path: kernel times, and the kernels of an earlier checkout ------

TIMED_SWEEPS = ("w01-skewed", "w01-skewed/meta")  # tiers 1-2; tier 0
SMEM_LATENCY_CYCLES = 30    # assumed: one dependent shared-memory round trip


def sweep_inputs(tr, dev):
    """The MRC sweep of trace ``tr`` as ``sweep_hits`` runs it: the
    32-lane grid, the relabelled trace (and its unique count) on the card,
    and a fresh grid state at the power-of-two universe."""
    from repro_torch.core import traces
    from repro_torch.core.engine import grid_init
    from repro_torch.tuning.sweep import make_grid, relabel

    fp = traces.footprint(tr)
    grid = make_grid([max(8, int(fp * f)) for f in SWEEP_FRACS],
                     SWEEP_WINDOWS)
    d, u = relabel(tr)
    return grid, torch.as_tensor(d, device=dev), u, grid_init(
        grid, pow2(u), device=dev)


def sweep_time(dev, name, tr):
    """CUDA-event times of 3 launches of the 32-lane sweep of ``tr``, each
    on a fresh state, beside the bytes bound and a dependency floor."""
    from repro_torch.core.engine import grid_hit_counts
    from repro_torch.kernels.cache_sim import ops

    grid, shared, u, init = sweep_inputs(tr, dev)
    times, counts = [], []
    for _ in range(3):
        states = clone(init)
        launches0 = ops.launch_count
        times += cuda_ms(lambda: counts.append(
            grid_hit_counts("clock2q+", states, shared)))
        require(ops.launch_count == launches0 + 1, "timed call not a launch")
    ms = statistics.median(times)
    L, T = len(grid), shared.numel()
    # The bytes the function touches: the shared trace once; per lane, the
    # u table entries the relabelled ids use (loc_w int8 + loc_s int32)
    # and each ring at its logical size (the padding is never touched),
    # read and written; the cursors read and written, the sizes read; the
    # counts written.
    ring_slots = {k: int(init[k].long().sum())
                  for k in ("scap", "mcap", "gcap")}
    touched = (L * u * (1 + 4) + ring_slots["scap"] * (4 + 1 + 4)
               + ring_slots["mcap"] * (4 + 1) + ring_slots["gcap"] * 4)
    moved = T * 4 + 2 * touched + L * 4 * (2 * 4 + 5) + L * 8
    bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
    ops_ms = 1e3 * T * L * STEP_OPS / SCALAR_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    # The chain no lane can shorten: a miss or a Ghost hit reads the ring
    # slot the previous one wrote; a window of hits needs its entries.
    chain = int(T - int(counts[-1].min())) + -(-T // 32)
    plan = ops.plan_view(ops.host_view(init, shared))
    return dict(
        phase="kernel_time", trace=name, lanes=L, requests=T,
        universe=pow2(u), unique=u, ring_slots=ring_slots,
        tiers=[plan.tiers.count(t) for t in range(4)],
        smem_bytes=plan.smem_bytes, blocks_per_sm=plan.blocks_per_sm,
        ms_runs=times, ms=ms, ns_per_step=1e6 * ms / T, bytes_moved=moved,
        bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound_ms,
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        roofline_share=bound_ms / ms,
        dependency_floor_ms=1e3 * chain * SMEM_LATENCY_CYCLES / SM_CLOCK_HZ,
        dependency_floor=f"{chain} dependent round trips in the longest "
                         "lane (one per miss or Ghost hit, one per window of "
                         "32 requests), each assumed one shared-memory "
                         f"round trip of {SMEM_LATENCY_CYCLES} cycles at "
                         f"{SM_CLOCK_HZ:.3g} Hz",
        misses_max_lane=int(T - int(counts[-1].min())))


def _kernel_dir(tree: str) -> str:
    return os.path.join(os.path.abspath(tree), "src", "repro_torch",
                        "kernels")


def present_cache_sim():
    """The present ``cache_sim`` as ``prepare(state, trace)``: the
    wrapper's host work (checks, the host view) done at once, and a call
    that launches the kernel alone (and counts no launch), so that a timing
    window holds the kernel and not the host's read of the state."""
    from repro_torch.kernels.cache_sim import build, ops

    lib = build.load()

    def prepare(state, trace):
        _, widths = ops.check_state(state)
        view = ops.host_view(state, trace)
        return lambda: ops.launch(lib, state, trace, "counts", view, widths)
    return prepare


def previous_cache_sim(tree: str):
    """The ``cache_sim`` of checkout ``tree`` as ``present_cache_sim``'s
    ``prepare``: its source built and bound with its own ``SYMBOLS`` (its
    ``ops.py`` would load this checkout's build).  Before the redesign the
    C entry point took the state and the ring widths, with no tiers, key
    range or shared memory; a later layout calls through the present
    wrapper's argument list."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.cache_sim import build as cbuild

    old = _load_previous(os.path.join(_kernel_dir(tree), "cache_sim",
                                      "build.py"), "previous_cache_sim_build")
    lib = kbuild.load("cache_sim", old.SOURCE, old.SYMBOLS)
    n_args = len(old.SYMBOLS["cache_sim_launch"])
    require(n_args in (28, len(cbuild.SYMBOLS["cache_sim_launch"])),
            f"{tree}: cache_sim_launch takes {n_args} arguments")
    names = ("skey", "sref", "sseq", "spos", "seqctr", "mkey", "mref", "hand",
             "gkey", "gpos", "loc_w", "loc_s", "scap", "mcap", "gcap",
             "window", "skip_limit")

    def prepare(state, trace):
        """Per-lane hit counts of ``trace`` (one shared row), in place."""
        from repro_torch.kernels.cache_sim import ops

        _, widths = ops.check_state(state)
        if n_args != 28:
            view = ops.host_view(state, trace)
            return lambda: ops.launch(lib, state, trace, "counts", view,
                                      widths)
        L = state["spos"].shape[0]
        counts = torch.empty((L,), dtype=torch.int64, device=trace.device)
        stream = torch.cuda.current_stream().cuda_stream

        def go():
            err = lib.cache_sim_launch(
                trace.data_ptr(), 0, trace.numel(), None, counts.data_ptr(),
                *(state[k].data_ptr() for k in names), L, widths["pS"],
                widths["pM"], widths["pG"], widths["U"], stream)
            require(err == 0, f"previous cache_sim launch failed ({err})")
            return counts
        return go
    return old.SOURCE, prepare


PREVIOUS_SWEEPS = TIMED_SWEEPS + ("w04-scans",)  # + tier 3's lanes
PREVIOUS_REPLAYS = ("w01-skewed", "w04-scans")


def _run_launches(prepare, state, rows):
    """Replay ``rows`` (trace tensors, one launch each) through ``state``
    in place: (hit counts summed over the launches, the launches' summed
    CUDA-event ms)."""
    total, ms = 0, 0.0
    for row in rows:
        go = prepare(state, row)
        box = []
        ms += cuda_ms(lambda: box.append(go()))[0]
        total = total + box[0].long()
    return total, ms


def cache_sim_previous(dev, tree: str, named):
    """``tree``'s ``cache_sim`` beside the present one, each kind of call
    the main path makes: the 32-lane sweeps of ``PREVIOUS_SWEEPS`` (every
    tier of the planner among them), and at ``suite_capacity`` of each of
    ``PREVIOUS_REPLAYS`` a one-lane replay of the whole trace and one in
    chunks of ``CHUNK`` requests.  Each is run in the order earlier,
    present, present, earlier, on clones of one fresh state; the times are
    the kernel launches' alone (CUDA events, the host's work outside
    them); hits and states of the two must be equal."""
    from repro_torch.core import torch_engine as te
    from repro_torch.core import traces
    from repro_torch.kernels.cache_sim import ops
    from repro_torch.tuning.sweep import relabel

    source, old_prepare = previous_cache_sim(tree)
    new_prepare = present_cache_sim()
    cases = []
    for name in PREVIOUS_SWEEPS:
        grid, shared, u, init = sweep_inputs(named[name], dev)
        cases.append((name, "sweep", init, [shared]))
    for name in PREVIOUS_REPLAYS:
        d, u = relabel(named[name])
        cap = traces.suite_capacity(d)
        init = te.init_state("clock2q+", cap, u, device=dev)
        row = torch.as_tensor(d, device=dev)
        cases.append((name, "replay", init, [row]))
        cases.append((name, "replay_chunked", init,
                      [row[i:i + CHUNK] for i in range(0, len(d), CHUNK)]))
    rec = dict(phase="cache_sim_previous", tree=tree, source=str(source),
               order=["previous", "present", "present", "previous"],
               cases=[])
    for name, kind, init, rows in cases:
        outs, ms = {}, []
        for who in rec["order"]:
            st = clone(init)
            c, t = _run_launches(old_prepare if who == "previous"
                                 else new_prepare, st, rows)
            ms.append(t)
            outs.setdefault(who, (c, st))
        (c_old, s_old), (c_new, s_new) = outs["previous"], outs["present"]
        err = max(int((c_old - c_new).abs().max()), state_err(s_old, s_new))
        require(err == 0, f"cache_sim_previous {name} {kind}: present != "
                          f"previous ({err})")
        T = sum(r.numel() for r in rows)
        plan = ops.plan_view(ops.host_view(init, rows[0]))
        rec["cases"].append(dict(
            trace=name, kind=kind, lanes=int(init["spos"].shape[0]),
            requests=T, launches=len(rows),
            tiers=[plan.tiers.count(t) for t in range(4)],
            previous_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]],
            previous_ns_per_step=1e6 * ms[0] / T,
            ns_per_step=1e6 * ms[1] / T, max_abs_err=err))
        del outs
    return rec


POLICY_PREVIOUS = ("w01-skewed/meta", "w04-scans")


def policy_launchers(tree: str = None):
    """``prepare(family, state, trace, plan=None)`` of the present
    ``s3fifo_sim`` and ``simple_sim`` kernels (the lanes' tiers ``plan``'s,
    else the planner's), or of checkout ``tree``'s (its sources built and
    bound with its own ``SYMBOLS``, launched through its own wrappers'
    ``launch``, whose argument lists differ; no plan): the checks and the
    host's part of the launch done at once, and a call that launches one
    kernel alone (and counts no launch), as ``present_cache_sim`` does.
    Also returns the two sources."""
    import inspect
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.s3fifo_sim import build as s3b
    from repro_torch.kernels.s3fifo_sim import ops as s3o
    from repro_torch.kernels.simple_sim import build as smb
    from repro_torch.kernels.simple_sim import ops as smo

    if tree is None:
        libs = dict(s3fifo_sim=s3b.load(), simple_sim=smb.load())
        sources = [str(s3b.SOURCE), str(smb.SOURCE)]

        def prepare(family, state, trace, plan=None):
            if family == "s3fifo":
                _, w = s3o.check_state(state)
                return s3o.bind(libs["s3fifo_sim"], state, trace, "counts",
                                s3o.host_view(state, trace), w, plan)
            _, w = smo.check_state(family, state)
            return smo.bind(libs["simple_sim"], family, state, trace,
                            "counts", smo.host_view(family, state, trace), w,
                            plan)
        return sources, prepare

    mods, libs = {}, {}
    for name in ("s3fifo_sim", "simple_sim"):
        kdir = os.path.join(_kernel_dir(tree), name)
        old = _load_previous(os.path.join(kdir, "build.py"),
                             f"previous_{name}_build")
        libs[name] = kbuild.load(name, old.SOURCE, old.SYMBOLS)
        mods[name] = _load_previous(os.path.join(kdir, "ops.py"),
                                    f"previous_{name}_ops")
        mods[name + ".source"] = str(old.SOURCE)

    def prepare(family, state, trace):
        # later trees' launch takes the host view; the earliest do not
        name = "s3fifo_sim" if family == "s3fifo" else "simple_sim"
        mod = mods[name]
        fam = () if family == "s3fifo" else (family,)
        _, w = (s3o.check_state(state) if family == "s3fifo"
                else smo.check_state(family, state))
        view = (mod.host_view(*fam, state, trace),) if "view" in \
            inspect.signature(mod.launch).parameters else ()
        return lambda: mod.launch(libs[name], *fam, state, trace, "counts",
                                  *view, w)
    return [mods["s3fifo_sim.source"], mods["simple_sim.source"]], prepare


def policy_sweep_inputs(dev, tr, family):
    """``family``'s lanes of the comparison path's mixed sweep of ``tr``
    (its configs at the 8 sweep capacities; S3-FIFO 2- and 1-bit), the
    relabelled trace on the card, its unique count and a fresh state."""
    from repro_torch.core import traces
    from repro_torch.core.engine import get_engine, grid_init
    from repro_torch.tuning.sweep import relabel

    d, u = relabel(tr)
    caps = [max(8, int(traces.footprint(tr) * f)) for f in SWEEP_FRACS]
    cfgs = [get_engine(p).config(c, **kw) for _, p, kw in COMPARE
            for c in caps if p == family]
    return cfgs, torch.as_tensor(d, device=dev), u, grid_init(
        cfgs, pow2(u), device=dev)


def _abba(prepares, order, init, row):
    """One launch over ``row`` on a clone of ``init`` for each name of
    ``order`` (``prepares[name](state, row)`` as ``_run_launches`` takes
    it): the CUDA-event ms in that order, and each name's first (hit
    counts, state)."""
    outs, ms = {}, []
    for who in order:
        st = clone(init)
        c, t = _run_launches(prepares[who], st, [row])
        ms.append(t)
        outs.setdefault(who, (c, st))
    return ms, outs


def _outs_err(outs, a, b) -> int:
    """The largest difference of hit counts or state between ``a`` and
    ``b`` of ``_abba``'s ``outs``."""
    (c_a, s_a), (c_b, s_b) = outs[a], outs[b]
    return max(int((c_a - c_b).abs().max()), state_err(s_a, s_b))


def _warm_policy(dev, *prepares):
    """One small launch of every family through each of ``prepares``
    (``policy_launchers``'), so that no timed launch is a kernel's first
    in the process."""
    from repro_torch.core.engine import get_engine, grid_init

    warm = torch.arange(64, dtype=torch.int32, device=dev) % 20
    for fam in POLICY_FAMILIES:
        for prepare in prepares:
            prepare(fam, grid_init([get_engine(fam).config(8)], 64,
                                   device=dev), warm)()
    torch.cuda.synchronize()


def policy_previous(dev, tree: str, named):
    """``tree``'s ``s3fifo_sim`` and ``simple_sim`` beside the present ones
    at the comparison path's mixed sweeps of ``POLICY_PREVIOUS``: each new
    family's lanes at the 8 sweep capacities (S3-FIFO 2- and 1-bit), one
    launch each, in the order earlier, present, present, earlier, on clones
    of one fresh state; the times are the launches' alone (CUDA events, the
    host's work outside them); hit counts and states must be equal."""
    from repro_torch.kernels import lanes

    old_sources, old_prepare = policy_launchers(tree)
    _, new_prepare = policy_launchers()
    rec = dict(phase="policy_previous", tree=tree, sources=old_sources,
               order=["previous", "present", "present", "previous"],
               cases=[])
    _warm_policy(dev, old_prepare, new_prepare)
    for name in POLICY_PREVIOUS:
        for fam in POLICY_FAMILIES:
            cfgs, row, u, init = policy_sweep_inputs(dev, named[name], fam)
            ms, outs = _abba(dict(
                previous=lambda s, r, f=fam: old_prepare(f, s, r),
                present=lambda s, r, f=fam: new_prepare(f, s, r)),
                rec["order"], init, row)
            err = _outs_err(outs, "previous", "present")
            require(err == 0, f"policy_previous {name} {fam}: present != "
                              f"previous ({err})")
            T = row.numel()
            misses = int(T - int(outs["present"][0].min()))
            rec["cases"].append(dict(
                trace=name, family=fam, lanes=len(cfgs), requests=T,
                tiers=lanes.tier_counts(policy_plan(fam, cfgs, u).tiers),
                previous_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]],
                speedup=(ms[0] + ms[3]) / (ms[1] + ms[2]),
                previous_ns_per_step=1e6 * ms[0] / T,
                ns_per_step=1e6 * ms[1] / T,
                dependency_floor_ms=1e3 * (misses + -(-T // 32))
                * SMEM_LATENCY_CYCLES / SM_CLOCK_HZ,
                misses_max_lane=misses, max_abs_err=err))
            del outs
    return rec


POLICY_TIER_SWEEPS = ("w01-skewed", "w01-skewed/meta", "w04-scans")


def policy_tier_time(dev, named):
    """What the planner buys ``s3fifo_sim`` and ``simple_sim``: at the
    comparison path's mixed sweeps of ``POLICY_TIER_SWEEPS``, each new
    family's lanes launched once with the planner's tiers and once with
    every lane in device memory (tier 3), in the order planned, device,
    device, planned; one launch each, on clones of one fresh state,
    after a warm-up launch, the host's work outside the CUDA events; hit
    counts and states must be equal."""
    from repro_torch.kernels import lanes

    _, prepare = policy_launchers()
    _warm_policy(dev, prepare)
    rec = dict(phase="policy_tier_time",
               order=["planned", "device", "device", "planned"], cases=[])
    for name in POLICY_TIER_SWEEPS:
        for fam in POLICY_FAMILIES:
            cfgs, row, u, init = policy_sweep_inputs(dev, named[name], fam)
            device = lanes.plan_grid(
                [lanes.plan_tiers(((lanes.TIER_GLOBAL, 0),))] * len(cfgs))
            ms, outs = _abba(dict(
                planned=lambda s, r, f=fam: prepare(f, s, r),
                device=lambda s, r, f=fam: prepare(f, s, r, device)),
                rec["order"], init, row)
            err = _outs_err(outs, "planned", "device")
            require(err == 0, f"policy_tier_time {name} {fam}: device "
                              f"memory != planned ({err})")
            rec["cases"].append(dict(
                trace=name, family=fam, lanes=len(cfgs),
                requests=row.numel(),
                tiers=lanes.tier_counts(policy_plan(fam, cfgs, u).tiers),
                planned_ms=[ms[0], ms[3]], device_ms=[ms[1], ms[2]],
                device_over_planned=(ms[1] + ms[2]) / (ms[0] + ms[3]),
                max_abs_err=err))
            del outs, init
    return rec


TIER_SWEEPS = ("w01-skewed", "w04-scans")


def tier_time(dev, named):
    """What each partial tier buys: at the sweeps of ``TIER_SWEEPS``, the
    lanes the planner keeps partly in shared memory (tiers 1 and 2),
    each tier's lanes launched alone, and then the whole sweep, once with
    the planner's tiers and once with that tier's lanes in device memory
    (tier 3), in the order planned, device, device, planned; one launch
    each, on clones of one fresh state, hits and states held equal."""
    from repro_torch.kernels.cache_sim import ops

    prepare = present_cache_sim()
    planner = ops.plan_view
    rec = dict(phase="tier_time", order=["planned", "device", "device",
                                         "planned"], cases=[])
    for name in TIER_SWEEPS:
        grid, shared, u, init = sweep_inputs(named[name], dev)
        tiers = planner(ops.host_view(init, shared)).tiers
        for tier in sorted(set(tiers) & {ops.TIER_RINGS, ops.TIER_SMALL}):
            idx = [i for i, t in enumerate(tiers) if t == tier]
            sub = {k: v[idx].contiguous() for k, v in init.items()}
            for who, st0 in (("lanes", sub), ("sweep", init)):
                outs, ms = {}, []
                for how in rec["order"]:
                    def forced(view, how=how):
                        p = planner(view)
                        if how == "planned":
                            return p
                        return p._replace(tiers=[
                            ops.TIER_GLOBAL if t == tier else t
                            for t in p.tiers])
                    st = clone(st0)
                    ops.plan_view = forced
                    try:
                        c, t = _run_launches(prepare, st, [shared])
                    finally:
                        ops.plan_view = planner
                    ms.append(t)
                    outs.setdefault(how, (c, st))
                (c_a, s_a), (c_b, s_b) = outs["planned"], outs["device"]
                err = max(int((c_a - c_b).abs().max()), state_err(s_a, s_b))
                require(err == 0, f"tier_time {name} tier {tier}: device "
                                  f"memory != planned ({err})")
                rec["cases"].append(dict(
                    trace=name, tier=tier, launched=who,
                    lanes=int(st0["spos"].shape[0]),
                    capacities=[grid[i].capacity for i in idx],
                    requests=shared.numel(), planned_ms=[ms[0], ms[3]],
                    device_ms=[ms[1], ms[2]], max_abs_err=err))
        del init
    return rec


def previous_scan_ops(tree: str):
    """``tree``'s ``mamba_scan/ops.py``, imported with ``tree``'s own
    ``ref.py`` in the place of the present one (its states cadence and
    plain versions), which is put back after."""
    kdir = os.path.join(_kernel_dir(tree), "mamba_scan")
    name = "repro_torch.kernels.mamba_scan.ref"
    present = sys.modules.get(name)
    sys.modules[name] = _load_previous(os.path.join(kdir, "ref.py"),
                                       "previous_scan_ref")
    try:
        return _load_previous(os.path.join(kdir, "ops.py"),
                              "previous_scan_ops")
    finally:
        if present is None:
            del sys.modules[name]
        else:
            sys.modules[name] = present


def scan_previous(dev, tree: str):
    """``tree``'s ``mamba_scan`` beside the present one at ``SCAN_MAIN``
    (bf16 u/B/C as the model hands them, fp32 dt): medians of 20, L2
    emptied by a 1 GiB read, in the order earlier, present, present,
    earlier; max and mean |err| of y against the plain version on fp32
    copies of the inputs, and of h_last.  Then the backward the same way
    at ``SCAN_TRAIN_SHAPE`` (bf16 u/B/C/dy, fp32 dt; medians of 10): each
    tree runs its own forward with its states (the two trees' cadences may
    differ) and then its own backward, which alone is timed (the kernel
    and the wrapper's sums), and each tree's five gradients are held to
    the plain backward on fp32 copies (max and mean |err|).  ``bit_equal``:
    the two trees' outputs (the backward's: its states too) equal bit for
    bit.  A tree whose scan has no backward is timed on the forward
    alone; where it has the bf16 scan, ``scan_bf16_previous`` follows."""
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.mamba_scan.ref import (
        mamba_scan_bwd_plain, mamba_scan_plain,
    )

    old = previous_scan_ops(tree)
    flush = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    ins = scan_inputs(dev, SCAN_MAIN, torch.bfloat16,
                      np.random.default_rng(3), R=SCAN_DT_RANK)
    y0, h0 = mamba_scan_plain(*(t.float() for t in ins))
    fns = dict(previous=lambda: old.mamba_scan(*ins),
               present=lambda: sops.mamba_scan(*ins))
    order = ["previous", "present", "present", "previous"]
    ms = [statistics.median(warm_ms(fns[k], flush)) for k in order]
    rec = dict(phase="scan_previous", tree=tree,
               shape=f"bf16 u/B/C (B/C views of x_proj's output), fp32 dt, "
                     f"(B, S, din, N) = {SCAN_MAIN}", order=order,
               previous_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]],
               plan=sops.scan_plan(*SCAN_MAIN)._asdict(),
               l2_flush_bytes=flush.numel() * 4)
    outs = {k: fns[k]() for k in fns}
    for k, (y, h) in outs.items():
        dy = (y.float() - y0).abs()
        rec[k + "_err"] = dict(y_max=float(dy.max()), y_mean=float(dy.mean()),
                               h_last_max=float((h - h0).abs().max()))
    rec["bit_equal"] = all(torch.equal(a, b) for a, b in zip(
        outs["previous"], outs["present"]))
    del y0, h0, ins, outs
    if not hasattr(old, "mamba_scan_bwd"):
        return rec
    rng = np.random.default_rng(26)
    ins = scan_inputs(dev, SCAN_TRAIN_SHAPE, torch.bfloat16, rng,
                      R=SCAN_DT_RANK)
    dy = torch.from_numpy(rng.normal(0, 1, ins[0].shape).astype(
        np.float32)).to(dev, torch.bfloat16)
    trees = dict(previous=old, present=sops)
    states = {k: m.mamba_scan_fwd(*ins)[2] for k, m in trees.items()}
    bwd = {k: (lambda m=m, st=states[k]: m.mamba_scan_bwd(*ins, st, dy))
           for k, m in trees.items()}
    ms = [statistics.median(warm_ms(bwd[k], flush, 10)) for k in order]
    want = mamba_scan_bwd_plain(*(t.float() for t in ins),
                                states["present"], dy.float())
    rec["bwd"] = dict(
        shape=f"bf16 u/B/C/dy (B/C views of x_proj's output), fp32 dt, "
              f"(B, S, din, N) = {SCAN_TRAIN_SHAPE}", order=order,
        previous_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]],
        states_bytes={k: int(v.numel()) * 4 for k, v in states.items()},
        plan=sops.bwd_plan(*SCAN_TRAIN_SHAPE)._asdict())
    got = {k: bwd[k]() for k in trees}
    for k in trees:
        rec["bwd"][k + "_err"] = {
            name: dict(max=float((g.float() - w).abs().max()),
                       mean=float((g.float() - w).abs().mean()))
            for name, g, w in zip(SCAN_GRADS, got[k], want)}
    rec["bwd"]["bit_equal"] = all(torch.equal(a, b) for a, b in zip(
        got["previous"], got["present"])) and all(
        torch.equal(a, b) for a, b in zip(states["previous"],
                                          states["present"]))
    del ins, dy, states, got, want
    if hasattr(old, "bf16_launch_count"):
        rec["bf16"] = scan_bf16_previous(dev, old, flush)
    return rec


def scan_bf16_previous(dev, old, flush) -> dict:
    """The bf16 scan's kernels of an earlier tree (``old``: its
    ``mamba_scan/ops.py``) beside the present ones: the forward at
    ``SCAN_MAIN`` and the backward at ``SCAN_TRAIN_SHAPE`` (bf16 u/B/C as
    views of x_proj's output, fp32 dt, bf16 dy, C ``SCAN_BF16_CHUNK``),
    medians of 10 and 5, the L2 emptied by a 1 GiB read (``flush``),
    earlier, present, present, earlier, each tree's backward from its own
    forward's states; and whether the two trees' outputs are equal bit for
    bit (``unequal`` names any that are not): y, h_last and the states of
    the forward (and y, h_last of its kernel without states) at every
    ``SCAN_BF16_CASES`` case and the timed shape, the states and du, ddt,
    dB, dC and dA_log of the backward at every ``SCAN_BF16_BWD_CASES``
    case and the timed shape."""
    from repro_torch.kernels.mamba_scan import ops as sops

    trees = dict(previous=old, present=sops)
    order = ["previous", "present", "present", "previous"]
    gen = torch.Generator(device=dev).manual_seed(31)
    C = SCAN_BF16_CHUNK
    unequal = []

    def same(name, outs):
        a, b = outs["previous"], outs["present"]
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            unequal.append(name)

    def case_inputs(case):
        B, S, din, N, dt_name, dtd_name = case[:6]
        ins = list(scan_inputs_on(dev, (B, S, din, N),
                                  getattr(torch, dt_name), gen, R=case[7]))
        ins[1] = ins[1].to(getattr(torch, dtd_name))
        return ins

    for case in SCAN_BF16_CASES:
        ins, cc = case_inputs(case), case[6]
        same(f"forward {case}", {k: m.mamba_scan_fwd(*ins, cc)
                                 for k, m in trees.items()})
        same(f"forward, no states, {case}", {k: m.mamba_scan(*ins, cc)
                                             for k, m in trees.items()})
    for case in SCAN_BF16_BWD_CASES:
        ins, cc = case_inputs(case), case[6]
        B, S, din, N = case[:4]
        dy = torch.randn((B, S, din), generator=gen, device=dev).to(
            ins[0].dtype)
        dh = (torch.randn((B, din, N), generator=gen, device=dev)
              if case[8] else None)
        st = {k: m.mamba_scan_fwd(*ins, cc)[2] for k, m in trees.items()}
        same(f"states {case}", {k: [v] for k, v in st.items()})
        same(f"backward {case}", {k: m.mamba_scan_bwd(*ins, st[k], dy, dh, cc)
                                  for k, m in trees.items()})
    del ins, dy, dh, st
    shape = lambda s: (f"bf16 u/B/C (B/C views of x_proj's output), fp32 dt,"
                       f" (B, S, din, N) = {s}, C {C}")
    ins = scan_inputs_on(dev, SCAN_MAIN, torch.bfloat16, gen, R=SCAN_DT_RANK)
    fwd = {k: (lambda m=m: m.mamba_scan(*ins, C)) for k, m in trees.items()}
    ms = [statistics.median(warm_ms(fwd[k], flush, 10)) for k in order]
    same("forward, timed shape", {k: f() for k, f in fwd.items()})
    same("forward with states, timed shape",
         {k: m.mamba_scan_fwd(*ins, C) for k, m in trees.items()})
    rec = dict(fwd=dict(shape=shape(SCAN_MAIN), order=order,
                        previous_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]],
                        plan=sops.bf16_plan(*SCAN_MAIN, C)._asdict()))
    del ins, fwd
    ins = scan_inputs_on(dev, SCAN_TRAIN_SHAPE, torch.bfloat16, gen,
                         R=SCAN_DT_RANK)
    dy = torch.randn(ins[0].shape, generator=gen, device=dev).to(
        torch.bfloat16)
    st = {k: m.mamba_scan_fwd(*ins, C)[2] for k, m in trees.items()}
    same("states, timed shape", {k: [v] for k, v in st.items()})
    bwd = {k: (lambda m=m, s=st[k]: m.mamba_scan_bwd(*ins, s, dy, None, C))
           for k, m in trees.items()}
    ms = [statistics.median(warm_ms(bwd[k], flush, 5)) for k in order]
    same("backward, timed shape", {k: f() for k, f in bwd.items()})
    rec["bwd"] = dict(shape=shape(SCAN_TRAIN_SHAPE) + ", bf16 dy",
                      order=order, previous_ms=[ms[0], ms[3]],
                      ms=[ms[1], ms[2]],
                      plan=sops.bwd_plan(*SCAN_TRAIN_SHAPE)._asdict())
    rec.update(unequal=unequal, bit_equal=not unequal)
    del ins, dy, st, bwd
    torch.cuda.empty_cache()
    return rec


class LaunchTimes:
    """CUDA-event times of every kernel launch of a wrapper module
    (``cache_sim``'s by default) between ``start`` and ``stop``, summed
    by the kind of call set in ``kind``: it wraps the wrapper's
    ``ops.launch`` (the C call alone, after the wrapper's checks).  With
    ``label``, a function of the launch's arguments, the kind is
    ``(kind, label(args))``."""

    def __init__(self, ops, label=None):
        self.ops, self.kind, self.events, self.label = ops, None, [], label

    def start(self):
        launch = self.inner = self.ops.launch

        def timed(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = launch(*args, **kw)
            b.record()
            kind = self.kind if self.label is None \
                else (self.kind, self.label(args))
            self.events.append((kind, a, b))
            return out
        self.ops.launch = timed

    def stop(self):
        self.ops.launch = self.inner

    def by_kind(self):
        """{kind: {launches, ms}} over the recorded launches."""
        torch.cuda.synchronize()
        out = {}
        for kind, a, b in self.events:
            rec = out.setdefault(kind, dict(launches=0, ms=0.0))
            rec["launches"] += 1
            rec["ms"] += a.elapsed_time(b)
        return out


def suite_traces(traces):
    """The 16 SUITE traces by name: each data trace and its metadata
    trace (``name/meta``)."""
    out = []
    for spec in traces.SUITE:
        d = spec.data()
        out += [(spec.name, d), (spec.name + "/meta",
                                 traces.derive_metadata(d))]
    return out


# -- the policy-comparison path: S3-FIFO, FIFO, Clock and LRU lanes ------------

# The mixed sweep of every SUITE trace: (label, engine, knobs) x the 8
# SWEEP_FRACS capacities, 56 lanes (the paper's Fig. 8/9 comparison).
COMPARE = (("clock2q+", "clock2q+", {}), ("clock2q", "clock2q", {}),
           ("s3fifo", "s3fifo", {}), ("s3fifo-1bit", "s3fifo", dict(bits=1)),
           ("fifo", "fifo", {}), ("clock", "clock", {}), ("lru", "lru", {}))
POLICY_FAMILIES = ("s3fifo", "fifo", "clock", "lru")  # the two new kernels'
HEADLINE_FRACS = (0.05, 0.1)  # benchmarks/paper_figs.py::_headline_gap
VS_PLAIN_TRACES = ("w01-skewed", "w04-scans", "w02-balanced/meta",
                   "w08-random/meta")
# Bytes a lane's state holds per logical slot of each ring and per key of
# its location table, by family (the rings and table a kernel touches).
STATE_BYTES = {"s3fifo": dict(ring=(8, 8, 4), table=1 + 4),  # S, M, G
               "fifo": dict(ring=(4,), table=1),
               "clock": dict(ring=(4 + 1,), table=4),
               "lru": dict(ring=(4 + 4,), table=4)}
CURSORS = {"s3fifo": (4, 6), "fifo": (1, 1), "clock": (1, 1),
           "lru": (1, 1)}  # per lane: cursors read and written, sizes read


def policy_kernels():
    """The replay kernel of each new family: (wrapper module, kernel
    wrapper, plain version), the plain one ``fn(state, trace, out)``."""
    import functools

    from repro_torch.kernels.s3fifo_sim import ops as s3ops
    from repro_torch.kernels.s3fifo_sim.ref import s3fifo_sim_plain
    from repro_torch.kernels.simple_sim import ops as smops
    from repro_torch.kernels.simple_sim.ref import simple_sim_plain

    out = {"s3fifo": (s3ops, s3ops.s3fifo_sim, s3fifo_sim_plain)}
    for fam in ("fifo", "clock", "lru"):
        out[fam] = (smops, getattr(smops, f"{fam}_sim"),
                    functools.partial(simple_sim_plain, fam))
    return out


def policy_plan(family: str, cfgs, K: int):
    """The kernel's launch plan of ``family``'s lanes ``cfgs`` over keys
    [0, K): each lane's tier and the blocks' shared memory."""
    from repro_torch.core.engine import get_engine
    from repro_torch.kernels.s3fifo_sim import ops as s3ops
    from repro_torch.kernels.simple_sim import ops as smops

    sizes = [get_engine(family).sizes_fn(c) for c in cfgs]
    if family == "s3fifo":
        return s3ops.plan_launch(*zip(*sizes), K)
    return smops.plan_launch(family, [s[0] for s in sizes], K)


def policy_bound(family: str, cfgs, unique: int, T: int):
    """The least time of one launch of ``family`` over lanes ``cfgs``: the
    trace read once; per lane the table entries of the ``unique`` keys and
    each ring at its logical size, read and written; cursors read and
    written, sizes read; the counts written (bytes, at the card's memory
    rate); or STEP_OPS integer operations a request a lane (at the 32-bit
    rate), whichever is longer.  Returns (bytes, bytes_ms, ops_ms)."""
    from repro_torch.core.engine import get_engine

    b = STATE_BYTES[family]
    touched = sum(unique * b["table"] + sum(
        n * w for n, w in zip(get_engine(family).sizes_fn(c), b["ring"]))
        for c in cfgs)
    rw, ro = CURSORS[family]
    L = len(cfgs)
    moved = T * 4 + 2 * touched + L * 4 * (2 * rw + ro) + L * 8
    return (moved, 1e3 * moved / HBM_BYTES_PER_S,
            1e3 * T * L * STEP_OPS / SCALAR_OPS_PER_S)


def engines_vs_plain(dev, named):
    """Each new family's kernel against its plain version at tolerance 0,
    on every hit and state tensor: 8,192-request prefixes of four SUITE
    traces as per-lane rows of one padded grid a family (capacities at
    1/10/50 % of each prefix's footprint; S3-FIFO with bits 2 and 1 and
    skip limits 2 and 16), a plain-to-kernel hand-over at the half, and
    counts mode against hits mode."""
    from repro_torch.core.engine import get_engine, grid_init
    from repro_torch.tuning.sweep import relabel

    kernels = policy_kernels()
    cfgs = {f: [] for f in kernels}
    rows = {f: [] for f in kernels}
    for name in VS_PLAIN_TRACES:
        d, _ = relabel(named[name][:PREFIX])
        fp = len(np.unique(d))
        caps = [max(8, int(fp * f)) for f in (0.01, 0.1, 0.5)]
        for fam in kernels:
            eng = get_engine(fam)
            lanes = [eng.config(c) for c in caps]
            if fam == "s3fifo":
                lanes += [eng.config(c, bits=1) for c in caps]
                lanes += [eng.config(caps[1], skip_limit=k) for k in (2, 16)]
            cfgs[fam] += lanes
            rows[fam] += [d] * len(lanes)
    universe = pow2(max(int(r.max()) + 1 for r in rows["s3fifo"]))
    half = PREFIX // 2
    rec = dict(phase="engines_vs_plain", requests=PREFIX,
               traces=list(VS_PLAIN_TRACES), universe=universe, tolerance=0,
               families={})
    t_phase = time.perf_counter()
    for fam, (mod, kernel, plain) in kernels.items():
        per_lane = torch.as_tensor(np.stack(rows[fam]), device=dev)
        init = grid_init(cfgs[fam], universe, device=dev)
        st_plain = clone(init)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h_a = plain(st_plain, per_lane[:, :half].contiguous())
        st_mid = clone(st_plain)
        h_b = plain(st_plain, per_lane[:, half:].contiguous())
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        h_plain = torch.cat([h_a, h_b], dim=1)

        launches0 = mod.launch_count
        st_k = clone(init)
        kernel_ms = cuda_ms(lambda: kernel(st_k, per_lane, "hits"))[0]
        st_k = clone(init)
        h_k = kernel(st_k, per_lane, "hits")
        err = max(int((h_k.long() - h_plain.long()).abs().max()),
                  state_err(st_k, st_plain))
        require(err == 0, f"{fam}: kernel != plain on the per-lane prefix "
                          f"(err {err})")
        h_rt = kernel(st_mid, per_lane[:, half:].contiguous(), "hits")
        rt_err = max(int((h_rt.long() - h_k[:, half:].long()).abs().max()),
                     state_err(st_mid, st_k))
        require(rt_err == 0, f"{fam}: plain->kernel state hand-over differs "
                             f"({rt_err})")
        st_c = clone(init)
        counts = kernel(st_c, per_lane, "counts")
        require(torch.equal(counts, h_k.sum(1)) and state_err(st_c, st_k) == 0,
                f"{fam}: counts mode != hits mode")
        widths = {k: int(v.shape[1]) for k, v in init.items() if v.dim() == 2}
        rec["families"][fam] = dict(
            lanes=len(cfgs[fam]), widths=widths,
            bits1_lanes=sum(c.bits == 1 for c in cfgs[fam]),
            skip_limit_lanes=sum(c.skip_limit > 0 for c in cfgs[fam]),
            max_abs_err=max(err, rt_err), hits=int(h_k.sum()),
            kernel_ms=kernel_ms, plain_ms=plain_ms,
            compare_launches=mod.launch_count - launches0)
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def _zoo_kwargs(cfg) -> dict:
    """The zoo constructor's knobs for an engine config (skip_limit 0 =
    unlimited = None in the zoo)."""
    if cfg.policy != "s3fifo":
        return {}
    return dict(small_frac=cfg.small_frac, ghost_frac=cfg.ghost_frac,
                bits=cfg.bits, skip_limit=cfg.skip_limit or None)


def compare_path(dev, all_traces):
    """The paper's policy comparison on the card: for each SUITE trace one
    mixed ``sweep_hits`` over COMPARE x SWEEP_FRACS (56 lanes: one launch
    a step family), each new family's lane at ``suite_capacity`` held
    request for request against the port's zoo, Eq. 1 against Clock, and
    the headline gap over the metadata traces.  Returns the phase's
    record and each kernel's launches and per-launch CUDA-event times."""
    from repro_torch.core import make_policy, traces
    from repro_torch.core.engine import get_engine, grid_hit_arrays, grid_init
    from repro_torch.kernels import lanes
    from repro_torch.kernels.cache_sim import ops as cops
    from repro_torch.kernels.s3fifo_sim import ops as s3ops
    from repro_torch.kernels.simple_sim import ops as smops
    from repro_torch.tuning.sweep import relabel, sweep_hits

    t_phase = time.perf_counter()
    timers = dict(cache_sim=LaunchTimes(cops), s3fifo_sim=LaunchTimes(s3ops),
                  simple_sim=LaunchTimes(smops, label=lambda a: a[1]))
    mods = dict(cache_sim=cops, s3fifo_sim=s3ops, simple_sim=smops)
    for name, mod in mods.items():
        mod.launch_count = 0
        timers[name].start()
    labels = [c[0] for c in COMPARE]
    per_trace, headline = [], []
    try:
        for name, tr in all_traces:
            fp = traces.footprint(tr)
            caps = [max(8, int(fp * f)) for f in SWEEP_FRACS]
            grid = [get_engine(p).config(c, **kw) for _, p, kw in COMPARE
                    for c in caps]
            for t in timers.values():
                t.kind = (name, "sweep")
            t0 = time.perf_counter()
            hits = sweep_hits(tr, grid, device=dev)
            sweep_s = time.perf_counter() - t0
            # misses / requests, as the zoo's SimResult.miss_ratio: the
            # same float as the reference's for the same hits
            mr = ((len(tr) - hits) / len(tr)).reshape(len(COMPARE), len(caps))
            require(np.isfinite(mr).all() and ((mr >= 0) & (mr <= 1)).all(),
                    f"{name}: bad miss ratios")
            mrs = {lab: [float(x) for x in mr[i]]
                   for i, lab in enumerate(labels)}
            base = mr[labels.index("clock")]
            eq1 = {lab: [float(x) for x in (base - mr[i]) / np.maximum(
                       base, 1e-12)]
                   for i, lab in enumerate(labels) if lab != "clock"}
            if name.endswith("/meta"):
                for f in HEADLINE_FRACS:
                    i = SWEEP_FRACS.index(f)
                    require(caps[i] == max(10, int(f * fp)),
                            "headline capacity differs from the benchmark's")
                    s3, c2 = mrs["s3fifo"][i], mrs["clock2q+"][i]
                    if s3 > 0:
                        headline.append(((s3 - c2) / s3, name, f, caps[i]))

            # each new family at suite_capacity, request for request
            d, u = relabel(tr)
            cap = traces.suite_capacity(d)
            tiers = {fam: lanes.tier_counts(policy_plan(
                fam, [c for c in grid if c.policy == fam], u).tiers)
                for fam in POLICY_FAMILIES}
            # The chain no lane can shorten, as sweep_time counts it: a
            # miss (or a Ghost hit) reads what the one before wrote, and a
            # window of hits needs its entries; the longest lane of each
            # family's launch.
            chain = {fam: len(tr) - int(min(
                h for h, c in zip(hits, grid) if c.policy == fam))
                + -(-len(tr) // 32) for fam in POLICY_FAMILIES}
            keys = d.tolist()
            t0 = time.perf_counter()
            for t in timers.values():
                t.kind = (name, "oracle_lane")
            for fam in POLICY_FAMILIES:
                cfg = get_engine(fam).config(cap)
                h = grid_hit_arrays(fam, grid_init([cfg], pow2(u), device=dev),
                                    d)[0].cpu().numpy()
                pol = make_policy(fam, cap, **_zoo_kwargs(cfg))
                oracle = np.fromiter((pol.access(k) for k in keys), bool,
                                     count=len(keys))
                require(np.array_equal(h, oracle),
                        f"{name}: {fam} lane at {cap} != the zoo "
                        f"({int((h != oracle).sum())} requests differ)")
            per_trace.append(dict(
                trace=name, requests=len(tr), unique=fp, lanes=len(grid),
                capacities=caps, miss_ratios=mrs, improvement_vs_clock=eq1,
                sweep_ms=1e3 * sweep_s, tiers_by_family=tiers,
                dependency_chain=chain, dependency_floor_ms={
                    fam: 1e3 * n * SMEM_LATENCY_CYCLES / SM_CLOCK_HZ
                    for fam, n in chain.items()},
                suite_capacity=cap,
                oracle_families=list(POLICY_FAMILIES),
                oracle_s=time.perf_counter() - t0, oracle_equal=True))
    finally:
        for t in timers.values():
            t.stop()
    launches = {name: mod.launch_count for name, mod in mods.items()}
    for name, n in launches.items():
        require(n > 0, f"the comparison path launched no {name} kernel")
    times = {name: t.by_kind() for name, t in timers.items()}
    for name, n in launches.items():
        require(sum(k["launches"] for k in times[name].values()) == n,
                f"timed {name} launches != {n}")
    gap = max(headline)
    kernel_ms = {name: sum(k["ms"] for k in t.values())
                 for name, t in times.items()}
    rec = dict(phase="compare_path", traces=per_trace, policies=labels,
               fracs=list(SWEEP_FRACS), launches=launches,
               kernel_ms=kernel_ms,
               kernel_ms_by_family={
                   fam: sum(v["ms"] for k, v in times["simple_sim"].items()
                            if k[1] == fam) for fam in ("fifo", "clock",
                                                        "lru")},
               dependency_floor="per trace and family, the dependent "
                                "round trips of the longest lane of its "
                                "sweep launch (one per miss or Ghost hit, "
                                "one per window of 32 requests), each "
                                "assumed one shared-memory round trip of "
                                f"{SMEM_LATENCY_CYCLES} cycles at "
                                f"{SM_CLOCK_HZ:.3g} Hz",
               headline_gap=dict(gap=gap[0], trace=gap[1], frac=gap[2],
                                 capacity=gap[3], fracs=list(HEADLINE_FRACS),
                                 of="max (MR_s3fifo - MR_clock2q+) / "
                                    "MR_s3fifo over the 8 metadata traces"),
               seconds=time.perf_counter() - t_phase)
    return rec, times


def policy_kernel_row(name, times, cmp, evp, families, trace, all_traces,
                      **paths):
    """The ``kernels`` line's entry of the new kernel ``name`` (serving
    ``families``): ``ms`` the sum of its launches at ``trace``'s mixed
    sweep (CUDA events), its bound there, the plain version's time at
    ``engines_vs_plain``'s grids; ``paths`` are its launches on paths
    other than ``compare_path``, by path."""
    from repro_torch.core import traces
    from repro_torch.core.engine import get_engine

    tr = dict(all_traces)[trace]
    fp = traces.footprint(tr)
    caps = [max(8, int(fp * f)) for f in SWEEP_FRACS]
    ms_by_family, moved, bytes_ms, ops_ms, lanes = {}, 0, 0.0, 0.0, 0
    for fam in families:
        cfgs = [get_engine(p).config(c, **kw) for _, p, kw in COMPARE
                for c in caps if p == fam]
        b, bms, oms = policy_bound(fam, cfgs, fp, len(tr))
        moved, bytes_ms, ops_ms = moved + b, bytes_ms + bms, ops_ms + oms
        lanes += len(cfgs)
        key = (trace, "sweep") if name == "s3fifo_sim" \
            else ((trace, "sweep"), fam)
        ms_by_family[fam] = times[name][key]["ms"]
    fams = evp["families"]
    return dict(
        name=name, route="cuda",
        source=f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
        replaces=("src/repro/core/engine/s3fifo.py:64 step (jit lax.scan, "
                  "vmapped over lanes)" if name == "s3fifo_sim" else
                  "src/repro/core/engine/simple.py:43 fifo_step, :70 "
                  "clock_step, :113 lru_step (jit lax.scan, vmapped over "
                  "lanes)"),
        launches=cmp["launches"][name] + sum(paths.values()),
        launches_by_path=dict(compare_path=cmp["launches"][name], **paths),
        max_abs_err=max(fams[f]["max_abs_err"] for f in families),
        ms=sum(ms_by_family.values()), ms_by_family=ms_by_family,
        plain_ms=sum(fams[f]["plain_ms"] for f in families),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None,
        ms_shape=f"{trace} mixed sweep: {lanes} lanes x {len(tr)} requests"
                 + ("" if name == "s3fifo_sim" else
                    f", one launch each of {', '.join(families)}"),
        bytes_moved=moved,
        plain_shape=", ".join(f"{f}: {fams[f]['lanes']} lanes" for f in
                              families) + f" x {PREFIX} requests",
        kernel_ms_at_plain_shape=sum(fams[f]["kernel_ms"] for f in families))


# -- training: the flash backward kernel, olmo-1b, consistency, resume ---------

# flash_attention_bwd.cu's KV tile (the dQ kernel's streamed tile): rows
# dropped by the planted fault
BWD_KV_TILE = 64
# atol, rtol against the plain backward that rounds where the kernel rounds
# (bf16: P and dS to bf16 before their products, ref.py's round_to), each
# element's limit widened by one bf16 step of the largest term of its sum
# (ref.py's flash_attention_bwd_rounding_slack): the kernel and its oracle
# round the same fp32 values, summed in other orders, and where one lies
# at a tie they round a step apart, which on a short causal row's large dS
# alone exceeds 1e-3.  A bf16 case is also held to the unrounded fp32 plain
# backward at ATTN_TOL, the rounding's own size
# (tests/test_torch_bwd_rounding.py): NEW_BF16_TOL there would refuse the
# rounding on every causal case, and ATTN_TOL against the rounded oracle
# would blunt the planted faults
BWD_TOL = {"float32": (2e-5, 2e-5), "bfloat16": NEW_BF16_TOL}
# the forward kernel's lse in the backward cases at the card tests' limit
# (test_torch_cuda.py); its out as attn_kernels_vs_plain holds it
LSE_TOL = (1e-4, 1e-5)


def bwd_fwd_tol(dt: str, causal: bool):
    """The forward's out limit in a backward case: ``ATTN_TOL``, but
    ``NEW_BF16_TOL`` for full (not causal) bf16 attention, as in
    ``attn_kernels_vs_plain``.  A causal row over a few positions keeps
    the bf16 rounding of P (about 2^-9 |v|) whole, over the new limit
    (tests/test_torch_bwd_check.py)."""
    return NEW_BF16_TOL if dt == "bfloat16" and not causal else ATTN_TOL[dt]
# B, Sq, Skv, H, Hkv, hd, causal: olmo's training shape, granite's GQA,
# zamba2's hd 80, kimi-k2's hd 112, whisper's encoder and cross-attention,
# lengths off every tile
FLASH_BWD_CASES = [(4, 4096, 4096, 16, 16, 128, True),
                   (1, 2048, 2048, 32, 8, 128, True),
                   (1, 2048, 2048, 32, 32, 80, True),
                   (1, 1000, 1000, 64, 8, 112, True),
                   (2, 1500, 1500, 6, 6, 64, False),
                   (2, 448, 1500, 6, 6, 64, False),
                   (1, 1, 1, 32, 8, 128, True), (1, 65, 65, 32, 8, 128, True),
                   (1, 1000, 1000, 32, 8, 128, False)]
FLASH_TRAIN_SHAPE = (4, 4096, 16, 16, 128)   # train_main's attention call
TRAIN_ARCH = "olmo-1b"
TRAIN_SEQ = 4096            # the reference's train_4k ShapeCell
TRAIN_BATCH, TRAIN_MICRO = 8, 2   # train_4k's 256 cut to one card
TRAIN_TIMED, TRAIN_REPEAT = 4, 16
# AdamW's lr, near olmo-1b's published peak of 4e-4, and the 1-step warm-up
# of the reference's loss-falls test
TRAIN_LR, TRAIN_WARMUP = 5e-4, 1
CE_FIRST_TOL = 0.5          # the first loss within 0.5 of ln(vocab)
TRAIN_TOL = dict(loss=1e-5, grad=1e-4, grad_norm=1e-5)   # train_consistency
CONSISTENCY_ARCHS = ("olmoe-1b-7b", "llava-next-mistral-7b", "zamba2-2.7b",
                     "whisper-tiny", "falcon-mamba-7b")
# train_bf16_grad: olmo-1b's width at 2 layers on a 2 x 4,096 batch; each
# gradient leaf of the bf16 loss within 5 % (relative norm) of the fp32
# loss's (tests/test_torch_bwd_check.py holds a narrow cut to half of it)
BF16_GRAD_LAYERS, BF16_GRAD_BATCH = 2, 2
BF16_GRAD_TOL = 0.05
# ssm_train_main: falcon-mamba-7b at full width, 8 of its 64 layers (its
# training state at full depth is past one card's memory)
SSM_TRAIN_ARCH, SSM_TRAIN_LAYERS = "falcon-mamba-7b", 8


def flash_bwd_bound(B, Sq, Skv, H, Hkv, d, causal, esize=2):
    """``_bound`` of one backward call: q, k, v, o, dO and lse read once,
    dq, dk, dv written; 2.5 x the forward's 4 B H d (Sq Skv / 2 causal,
    Sq Skv full) flops."""
    moved = esize * (4 * B * Sq * H * d + 4 * B * Skv * Hkv * d) \
        + 4 * B * H * Sq
    return _bound(moved, 2.5 * 4 * B * H * d * Sq * Skv
                  / (2 if causal else 1))


def _bwd_case(dev, dt, case, rng):
    """One backward case's tensors: q, k, v, dO from ``rng``; the forward
    kernel's out and lse; the plain forward's out and lse on fp32 copies;
    the kernel's (dq, dk, dv) from its own out and lse, and the plain
    backward's from the kernel's out and the plain lse, so a wrong lse
    cannot give the kernel and its oracle the same wrong P: rounded as the
    kernel rounds (``ops.BWD_ROUNDING``), and unrounded."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain, flash_attention_lse_plain,
        flash_attention_plain,
    )

    B, Sq, Skv, H, Hkv, hd, causal = case
    g = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(
        np.float32)).to(dev, getattr(torch, dt))
    q, k, v, do = g(B, Sq, H, hd), g(B, Skv, Hkv, hd), g(B, Skv, Hkv, hd), \
        g(B, Sq, H, hd)
    o, lse = fops.flash_attention_fwd(q, k, v, causal)
    qf, kf, vf = q.float(), k.float(), v.float()
    plain = (flash_attention_plain(qf, kf, vf, causal),
             flash_attention_lse_plain(qf, kf, vf, causal))
    got = fops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    want, want32 = (flash_attention_bwd_plain(
        qf, kf, vf, o.float(), plain[1], do.float(), causal, round_to=r)
        for r in (fops.BWD_ROUNDING[q.dtype], None))
    return (q, k, v, o, lse, do), plain, got, want, want32


def bwd_case_check(dev, dt, case, rng) -> dict:
    """``_bwd_case``'s limit uses: the forward kernel's out against the
    plain forward (``bwd_fwd_tol``), its lse against the plain
    log-sum-exp (``LSE_TOL``), its dq, dk, dv against the plain backward
    that rounds as the kernel does (``BWD_TOL``) and against the
    unrounded one (``ATTN_TOL``, ``fp32_limit_use``); and for a bf16 case
    planted faults, each of which must use more than the rounded check's
    limit: the backward with D = rowsum(dO o O) left out (o given as
    zeros), with the last KV tile dropped, and an lse stored in base 2
    (lse log2 e), which fails the lse check and, given to the backward,
    the gradient check."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_rounding_slack,
    )

    B, Sq, Skv, H, Hkv, hd, causal = case
    (q, k, v, o, lse, do), (o_p, lse_p), got, want, want32 = _bwd_case(
        dev, dt, case, rng)
    tol, rnd = BWD_TOL[dt], fops.BWD_ROUNDING[q.dtype]
    slack = ((0.0,) * 3 if rnd is None else flash_attention_bwd_rounding_slack(
        *(t.float() for t in (q, k, v, o)), lse_p, do.float(), causal, rnd))
    grad_use = lambda gs: max(limit_use(a, w, *tol, sl)
                              for a, w, sl in zip(gs, want, slack))
    rec = dict(
        dtype=dt, B=B, Sq=Sq, Skv=Skv, H=H, Hkv=Hkv, hd=hd, causal=causal,
        tol=list(tol), lse_tol=list(LSE_TOL),
        out_tol=list(bwd_fwd_tol(dt, causal)),
        out_limit_use=limit_use(o, o_p, *bwd_fwd_tol(dt, causal)),
        lse_max_abs_err=float((lse - lse_p).abs().max()),
        lse_limit_use=limit_use(lse, lse_p, *LSE_TOL),
        max_abs_err=dict(zip(("dq", "dk", "dv"), (
            float((a.float() - w).abs().max()) for a, w in zip(got, want)))),
        limit_use=grad_use(got), round_to=str(rnd),
        max_slack=dict(zip(("dq", "dk", "dv"), (float(torch.as_tensor(
            sl).max()) for sl in slack))),
        fp32_tol=list(ATTN_TOL[dt]),
        fp32_limit_use=max(limit_use(a, w, *ATTN_TOL[dt])
                           for a, w in zip(got, want32)))
    faults = {}
    if dt == "bfloat16":
        faults["no_delta"] = grad_use(fops.flash_attention_bwd(
            q, k, v, torch.zeros_like(o), lse, do, causal))
        cut = (Skv - 1) // BWD_KV_TILE * BWD_KV_TILE
        if cut > 0:
            dq_, dk_, dv_ = fops.flash_attention_bwd(
                q, k[:, :cut].contiguous(), v[:, :cut].contiguous(), o, lse,
                do, causal)
            pad = lambda t: torch.cat([t, torch.zeros_like(k[:, cut:])], 1)
            faults["dropped_kv_tile"] = grad_use((dq_, pad(dk_), pad(dv_)))
        base2 = lse * math.log2(math.e)
        faults["base2_lse"] = limit_use(base2, lse_p, *LSE_TOL)
        faults["base2_lse_bwd"] = grad_use(fops.flash_attention_bwd(
            q, k, v, o, base2, do, causal))
    rec["fault_limit_use"] = faults
    return rec


def flash_bwd_vs_plain(dev):
    """``bwd_case_check`` at ``FLASH_BWD_CASES``, fp32 and bf16: every
    limit use (rounded oracle and fp32 one) at most 1, every planted
    fault's above 1.  Returns the record."""
    rng = np.random.default_rng(23)
    t0 = time.perf_counter()
    rec = dict(phase="flash_bwd_vs_plain", cases=[])
    for dt in ("float32", "bfloat16"):
        for case in FLASH_BWD_CASES:
            c = bwd_case_check(dev, dt, case, rng)
            require(c["out_limit_use"] <= 1.0 and c["lse_limit_use"] <= 1.0,
                    f"flash_attention_fwd {dt} {case} != plain (out limit "
                    f"use {c['out_limit_use']}, lse limit use "
                    f"{c['lse_limit_use']})")
            require(c["limit_use"] <= 1.0, f"flash_attention_bwd {dt} {case}"
                    f" != plain (limit use {c['limit_use']}, max err "
                    f"{c['max_abs_err']})")
            require(c["fp32_limit_use"] <= 1.0, f"flash_attention_bwd {dt} "
                    f"{case} != fp32 plain (limit use {c['fp32_limit_use']} "
                    f"at {c['fp32_tol']})")
            for name, use in c["fault_limit_use"].items():
                require(use > 1.0, f"the backward check at {case} passes a "
                        f"kernel with its {name} fault (limit use {use})")
            rec["cases"].append(c)
    torch.cuda.synchronize()
    cs = rec["cases"]
    rec["max_abs_err"] = max(max(c["max_abs_err"].values()) for c in cs)
    rec["max_limit_use"] = max(c["limit_use"] for c in cs)
    rec["max_fp32_limit_use"] = max(c["fp32_limit_use"] for c in cs)
    rec["max_lse_abs_err"] = max(c["lse_max_abs_err"] for c in cs)
    rec["max_lse_limit_use"] = max(c["lse_limit_use"] for c in cs)
    rec["max_out_limit_use"] = max(c["out_limit_use"] for c in cs)
    rec["min_fault_limit_use"] = {
        f: min(c["fault_limit_use"][f] for c in cs
               if f in c["fault_limit_use"])
        for f in ("no_delta", "dropped_kv_tile", "base2_lse", "base2_lse_bwd")}
    rec["seconds"] = time.perf_counter() - t0
    return rec


def flash_bwd_time(dev):
    """CUDA-event medians at train_main's attention shape (bf16, causal),
    L2 emptied by a 1 GiB read before each launch: the backward kernel
    beside its bound, the plain backward and the backward of one
    ``scaled_dot_product_attention`` call (the forward not timed; never
    called by the port); and the forward kernel at ``FLASH_TIMED``'s main
    shape with and without lse."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain,
    )

    rng = np.random.default_rng(24)
    flush = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    B, S, H, Hkv, hd = FLASH_TRAIN_SHAPE
    g = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(
        np.float32)).to(dev, torch.bfloat16)
    q, k, v, do = g(B, S, H, hd), g(B, S, Hkv, hd), g(B, S, Hkv, hd), \
        g(B, S, H, hd)
    o, lse = fops.flash_attention_fwd(q, k, v, True)
    before = fops.bwd_launch_count
    runs = warm_ms(lambda: fops.flash_attention_bwd(q, k, v, o, lse, do, True),
                   flush, 10)
    require(fops.bwd_launch_count == before + len(runs) + 1,
            "timed backward call not one launch each")
    bound, by, moved, ops_ = flash_bwd_bound(B, S, S, H, Hkv, hd, True)
    plain = statistics.median(warm_ms(
        lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, True),
        flush, 2))
    tq, tk, tv = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(tq, tk, tv, is_causal=True)
        tdo = do.transpose(1, 2)
        lib = statistics.median(warm_ms(lambda: torch.autograd.grad(
            out, (tq, tk, tv), tdo, retain_graph=True), flush, 10))
    del out, tq, tk, tv, q, k, v, do, o, lse
    gc.collect()
    torch.cuda.empty_cache()
    B, S, H, Hkv, hd = FLASH_TIMED["main"]
    q, k, v = g(B, S, H, hd), g(B, S, Hkv, hd), g(B, S, Hkv, hd)
    fwd = [statistics.median(warm_ms(f, flush)) for f in (
        lambda: fops.flash_attention(q, k, v, True),
        lambda: fops.flash_attention_fwd(q, k, v, True),
        lambda: fops.flash_attention_fwd(q, k, v, True),
        lambda: fops.flash_attention(q, k, v, True))]
    ms = statistics.median(runs)
    return dict(
        phase="flash_bwd_time",
        bwd=dict(shape=f"bf16, B={FLASH_TRAIN_SHAPE[0]}, S={TRAIN_SEQ}, "
                       f"H={FLASH_TRAIN_SHAPE[2]}, "
                       f"Hkv={FLASH_TRAIN_SHAPE[3]}, "
                       f"hd={FLASH_TRAIN_SHAPE[4]}, causal",
                 ms_runs=runs, ms=ms, bytes=moved, ops=ops_, bound_ms=bound,
                 bound_by=by, roofline_share=bound / ms,
                 tflops=ops_ / ms / 1e9, plain_ms=plain, library_ms=lib,
                 library="scaled_dot_product_attention(is_causal) backward "
                         "through torch.autograd.grad, forward not timed",
                 library_roofline_share=bound / lib),
        fwd=dict(shape=f"bf16, B={B}, S={S}, H={H}, Hkv={Hkv}, hd={hd}, "
                       f"causal",
                 order="no lse, lse, lse, no lse",
                 ms=[fwd[0], fwd[3]], ms_with_lse=[fwd[1], fwd[2]]),
        l2_flush_bytes=flush.numel() * 4)


def _train_batch(pipe, i: int, dev):
    """The pipeline's batch ``i`` on the card, and its host seconds."""
    t0 = time.perf_counter()
    b = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(i).items()}
    return b, time.perf_counter() - t0


def repeat_losses(api, oc, pipe, dev, n: int) -> list:
    """The losses of ``n`` steps (``TRAIN_MICRO`` microbatches, AdamW
    ``oc``) of a fresh train state from seed 0 on the pipeline's batches
    0 and 1 in turn: the model must fit them."""
    from repro_torch.training import step as step_lib

    step = step_lib.make_train_step(api, step_lib.RunConfig(
        microbatches=TRAIN_MICRO, adamw=oc))
    state = step_lib.init_train_state(
        api, torch.Generator(device=dev).manual_seed(0), oc, device=dev)
    out = []
    for i in range(n):
        batch, _ = _train_batch(pipe, i % 2, dev)
        state, m = step(state, batch)
        out.append(float(m["loss"]))
    torch.cuda.synchronize()
    return out


def _train_counts() -> dict:
    """The launch counts of the kernels a training step may run."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.paged_attention import ops as pops

    return dict(flash_attention=fops.launch_count,
                flash_attention_bwd=fops.bwd_launch_count,
                paged_attention=pops.launch_count,
                mamba_scan=sops.launch_count,
                mamba_scan_bwd=sops.bwd_launch_count,
                mamba_scan_bf16=sops.bf16_launch_count,
                mamba_scan_bf16_bwd=sops.bf16_bwd_launch_count)


def _reset_train_counts() -> None:
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.paged_attention import ops as pops

    fops.launch_count = fops.bwd_launch_count = pops.launch_count = 0
    sops.launch_count = sops.bwd_launch_count = 0
    sops.bf16_launch_count = sops.bf16_bwd_launch_count = 0


def train_run(dev, cfg, phase: str, a_layer: dict, groups: dict,
              reduced: str, ce_init: float):
    """``cfg`` (bf16, random weights) trained through the port's entry
    points: ``make_train_step`` with 2 microbatches of 4 x 4,096 tokens
    from ``TokenPipeline``; a warm-up step, ``TRAIN_TIMED`` timed steps
    and one profiled (``groups``: ``profile_summary``'s kernel groups);
    then ``repeat_losses``: ``TRAIN_REPEAT`` steps of a fresh state that
    repeat 2 batches, the last loss below 0.9x the first.  The first loss
    must lie within ``CE_FIRST_TOL`` of ``ce_init``, the cross-entropy
    the random init predicts.  Each kernel must launch ``a_layer[kernel]``
    times a layer a microbatch a step and no other kernel at all.
    Returns (record, launches per kernel)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.model import build
    from repro_torch.training import optim, step as step_lib

    t_phase = time.perf_counter()
    api = build(cfg)
    oc = optim.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    step = step_lib.make_train_step(api, step_lib.RunConfig(
        microbatches=TRAIN_MICRO, adamw=oc))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    state = step_lib.init_train_state(
        api, torch.Generator(device=dev).manual_seed(0), oc, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = _n_params(state.params)
    state_bytes = torch.cuda.memory_allocated(dev)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0))
    _reset_train_counts()
    steps, host_s = [], []
    for i in range(1 + TRAIN_TIMED):
        batch, hs = _train_batch(pipe, i, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        steps.append(dict(step=i, ms=1e3 * (time.perf_counter() - t0),
                          loss=float(m["loss"]),
                          grad_norm=float(m["grad_norm"]),
                          lr=float(m["lr"]), host_batch_ms=1e3 * hs))
    per_step = {k: n // len(steps) for k, n in _train_counts().items()
                if k in a_layer}
    batch, _ = _train_batch(pipe, 1 + TRAIN_TIMED, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof_rec = profile_summary(prof, wall, groups)
    peak = torch.cuda.max_memory_allocated(dev)
    hit_ratio, lookups = pipe.index_hit_ratio, pipe.lookups
    del prof

    del state, batch, m
    gc.collect()
    repeat = repeat_losses(api, oc, pipe, dev, TRAIN_REPEAT)
    n_steps = len(steps) + 1 + TRAIN_REPEAT
    launches = _train_counts()
    gc.collect()
    torch.cuda.empty_cache()

    losses = [s["loss"] for s in steps] + repeat
    ln_v = float(np.log(cfg.vocab))
    want = {k: TRAIN_MICRO * cfg.n_layers * n_steps * a_layer.get(k, 0)
            for k in launches}
    require(all(np.isfinite(losses)), f"{phase}: a loss is not finite "
                                      f"({losses})")
    require(abs(steps[0]["loss"] - ce_init) <= CE_FIRST_TOL,
            f"{phase}: first loss {steps[0]['loss']} not within "
            f"{CE_FIRST_TOL} of {ce_init} (ln {cfg.vocab} = {ln_v})")
    require(repeat[-1] < 0.9 * repeat[0], f"{phase}: the repeated "
            f"batches' loss did not fall below 0.9x its first ({repeat})")
    require(launches == want, f"{phase}: launches {launches}, want {want}"
            f" (a layer a microbatch a step: the forward twice, with the "
            f"remat's recompute, the backward once)")
    timed = [s["ms"] for s in steps[1:]]
    p50 = statistics.median(timed)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return dict(
        phase=phase, arch=cfg.name, family=cfg.family, n_params=n_params,
        n_layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
        vocab=cfg.vocab, dtype=cfg.dtype, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, microbatches=TRAIN_MICRO,
        tokens_per_step=tokens, lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
        reduced=f"{reduced}, {len(steps) + 1 + TRAIN_REPEAT} steps",
        init_s=init_s, state_bytes=state_bytes, steps=steps,
        step_ms_p50=p50, step_ms_timed=timed, tokens_per_s=tokens / p50 * 1e3,
        model_tflops=6 * n_params * tokens / (p50 / 1e3) / 1e12,
        peak_device_bytes=peak, index_cache=dict(
            hit_ratio=hit_ratio, lookups=lookups,
            blocks=pipe.dc.index_cache_blocks),
        first_loss=steps[0]["loss"], ln_vocab=ln_v, ce_init=ce_init,
        repeat_from="a fresh state (seed 0), batches 0 and 1 in turn",
        repeat_losses=repeat,
        repeat_ratio=repeat[-1] / repeat[0], launches=launches,
        launches_per_step=per_step, profile=prof_rec,
        seconds=time.perf_counter() - t_phase), launches


def train_main(dev):
    """Full-width, full-depth olmo-1b through ``train_run``: attention's
    forward kernel twice a layer a microbatch (with the remat's
    recompute) and its backward kernel once."""
    from repro_torch.configs import get_config

    return train_run(dev, get_config(TRAIN_ARCH), "train_main",
                     dict(flash_attention=2, flash_attention_bwd=1),
                     {"flash_bwd": "flash_bwd::",
                      "flash_fwd": "flash_attention_kernel"},
                     f"batch 256 -> {TRAIN_BATCH} (train_4k's global batch "
                     f"cut to one card)", math.log(get_config(TRAIN_ARCH).vocab))


def ssm_train_main(dev):
    """falcon-mamba-7b at full width cut to ``SSM_TRAIN_LAYERS`` of its 64
    layers through ``train_run`` on train_main's cell: the scan's forward
    kernel twice a layer a microbatch (with the remat's recompute) and its
    backward kernel once, no attention kernel.  Its first loss is held
    to ln V + 1/2, not ln V: the untied head (std 1/sqrt(d_model)) on the
    final norm's unit-RMS stream gives logits of variance 1, and the mean
    log-sum-exp of V such normals is about ln V + 1/2 (olmo-1b's tied
    0.02 embedding gives variance 0.82, its first loss ln V + 0.359)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(SSM_TRAIN_ARCH),
                              n_layers=SSM_TRAIN_LAYERS)
    return train_run(dev, cfg, "ssm_train_main",
                     dict(mamba_scan=2, mamba_scan_bwd=1),
                     {"scan_bwd": "mamba_scan_bwd_kernel",
                      "scan_fwd": "mamba_scan_kernel"},
                     f"layers 64 -> {SSM_TRAIN_LAYERS} (the 7.27B "
                     f"parameters' bf16 params, fp32 moments and "
                     f"accumulators are about 100 GB, past one card's 80; "
                     f"8 layers, 1.375B parameters, about 19 GB), batch 256 "
                     f"-> {TRAIN_BATCH} (train_4k's global batch cut to one "
                     f"card)", math.log(cfg.vocab) + 0.5)


def grad_rel_errors(got, want) -> dict:
    """{leaf path: |got - want| / |want|} (Frobenius norms, fp32) over two
    gradient trees; a leaf whose ``want`` is all zeros gives 0.0 if
    ``got``'s is too, else inf."""
    out = {}
    for (path, a), (_, w) in zip(_leaf_paths(got), _leaf_paths(want)):
        a, w = a.float(), w.float()
        n, d = float(w.norm()), float((a - w).norm())
        out[path] = d / n if n else (0.0 if d == 0 else math.inf)
    return out


def train_bf16_grad(dev):
    """The bf16 training gradient against the fp32 one: olmo-1b at full
    width cut to ``BF16_GRAD_LAYERS`` layers, random params made in bf16
    and the same values in fp32, one batch of ``BF16_GRAD_BATCH`` x
    4,096 tokens.  The bf16 loss runs the sm90 forward kernel with its
    lse and the backward kernel; the fp32 loss runs the CUDA-core
    kernels, which ``train_consistency`` holds to the CPU.  Each leaf's
    relative error must be within ``BF16_GRAD_TOL``; the bf16 gradients
    with the forward's lse stored in base 2 (lse log2 e, a planted fault
    in ``ops._launch``) must exceed it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.specs import make_batch
    from repro_torch.models.config import ShapeCell
    from repro_torch.models.model import (
        build, params_from_numpy, params_to_numpy,
    )
    from repro_torch.training import step as step_lib

    t0 = time.perf_counter()
    c16 = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=BF16_GRAD_LAYERS)
    c32 = dataclasses.replace(c16, dtype="float32", param_dtype="float32")
    a16, a32 = build(c16), build(c32)
    p16 = a16.init(torch.Generator(device=dev).manual_seed(0), dev)
    p32 = params_from_numpy(c32, params_to_numpy(p16), dev)
    batch = make_batch(c16, ShapeCell("t", TRAIN_SEQ, BF16_GRAD_BATCH,
                                      "train"), seed=6, device=dev)
    l32, _, g32 = step_lib.value_and_grad(a32, p32, batch)
    f0, b0 = fops.launch_count, fops.bwd_launch_count
    l16, _, g16 = step_lib.value_and_grad(a16, p16, batch)
    torch.cuda.synchronize()
    launches = [fops.launch_count - f0, fops.bwd_launch_count - b0]
    rel = grad_rel_errors(g16, g32)
    del g16
    launch = fops._launch

    def base2(q, k, v, causal, lse):
        o, lse_t = launch(q, k, v, causal, lse)
        return o, None if lse_t is None else lse_t * math.log2(math.e)

    fops._launch = base2
    try:
        _, _, gf = step_lib.value_and_grad(a16, p16, batch)
    finally:
        fops._launch = launch
    fault = grad_rel_errors(gf, g32)
    del gf, g32, p16, p32, a16, a32, batch
    gc.collect()
    torch.cuda.empty_cache()
    require(launches == [2 * BF16_GRAD_LAYERS, BF16_GRAD_LAYERS],
            f"train_bf16_grad: flash launches {launches}, want a forward "
            f"and its remat recompute and a backward a layer")
    require(max(rel.values()) <= BF16_GRAD_TOL, f"train_bf16_grad: bf16 "
            f"gradients != fp32 beyond {BF16_GRAD_TOL} ({rel})")
    require(max(fault.values()) > BF16_GRAD_TOL, f"train_bf16_grad: the "
            f"check passes a base-2 lse ({fault})")
    return dict(
        phase="train_bf16_grad", arch=c16.name, n_layers=c16.n_layers,
        d_model=c16.d_model, vocab=c16.vocab, batch=BF16_GRAD_BATCH,
        seq_len=TRAIN_SEQ, tol=BF16_GRAD_TOL, loss_bf16=float(l16),
        loss_fp32=float(l32), launches=launches, rel_err=rel,
        max_rel_err=max(rel.values()), fault_rel_err=fault,
        fault_max_rel_err=max(fault.values()),
        seconds=time.perf_counter() - t0)


def _consistency_cfg(arch: str):
    """olmo-1b's width cut to 2 layers, or the reduced config, in fp32,
    and its batch cell."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.config import ShapeCell

    if arch == TRAIN_ARCH:
        cfg = dataclasses.replace(get_config(arch), n_layers=2,
                                  dtype="float32", param_dtype="float32")
        return cfg, ShapeCell("t", 256, 2, "train")
    return reduced(get_config(arch)), ShapeCell("t", 32, 4, "train")


def train_consistency(dev):
    """One train step on the card against the same step of the port on
    the CPU (plain versions), from the same numpy state and batch, for
    olmo-1b's width cut to 2 layers and the reduced olmoe, llava, zamba2,
    whisper and falcon-mamba (fp32): loss, every gradient leaf and
    grad_norm held to ``TRAIN_TOL``.  The card's step must run the
    family's backward kernel: the scan's for the ssm, flash's for the
    others."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.launch.specs import make_batch
    from repro_torch.models.model import build
    from repro_torch.training import optim, step as step_lib

    t0 = time.perf_counter()
    oc = optim.AdamWConfig(lr=1e-3, warmup_steps=1)
    rec = dict(phase="train_consistency", tol=TRAIN_TOL, models=[])
    for arch in (TRAIN_ARCH,) + CONSISTENCY_ARCHS:
        cfg, cell = _consistency_cfg(arch)
        api = build(cfg)
        tree = step_lib.train_state_to_numpy(step_lib.init_train_state(
            api, torch.Generator().manual_seed(0), oc, device="cpu"))
        batch = make_batch(cfg, cell, seed=5, device="cpu")
        out = {}
        for d in ("cpu", dev):
            st = step_lib.train_state_from_numpy(cfg, tree, oc, device=d)
            bwd = sops if cfg.family == "ssm" else fops
            b0 = bwd.bwd_launch_count
            loss, _, grads = step_lib.value_and_grad(
                api, st.params, {k: v.to(d) for k, v in batch.items()})
            _, new_opt, om = optim.adamw_update(st.params, grads, st.opt, oc)
            out[str(d)] = (float(loss), {p: g.float().cpu() for p, g in
                                         _leaf_paths(grads)},
                           float(om["grad_norm"]))
            if d != "cpu":
                torch.cuda.synchronize()
                require(bwd.bwd_launch_count > b0, f"train_consistency "
                        f"{arch}: the card's step ran no backward kernel")
        (lc, gc_, nc), (lg, gg, ng) = out["cpu"], out[str(dev)]
        loss_rel = abs(lg - lc) / abs(lc)
        norm_rel = abs(ng - nc) / abs(nc)
        grad_use = max(float((gg[p] - g).abs().max())
                       / (TRAIN_TOL["grad"] * float(g.abs().max()) + 1e-30)
                       for p, g in gc_.items())
        require(loss_rel <= TRAIN_TOL["loss"] and grad_use <= 1.0
                and norm_rel <= TRAIN_TOL["grad_norm"],
                f"train_consistency {arch}: loss rel {loss_rel}, gradient "
                f"limit use {grad_use}, grad_norm rel {norm_rel}")
        rec["models"].append(dict(
            arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
            d_model=cfg.d_model, vocab=cfg.vocab, batch=cell.global_batch,
            seq_len=cell.seq_len, loss=lg, loss_rel_err=loss_rel,
            grad_limit_use=grad_use, grad_leaves=len(gc_),
            grad_norm=ng, grad_norm_rel_err=norm_rel))
        del api, out
    rec["seconds"] = time.perf_counter() - t0
    return rec


def train_resume(dev):
    """``launch.train.main`` with its defaults (the reduced olmo-1b, fp32,
    on the card) for 6 steps saving every 3, then again from the saved
    step 3 in a second directory: the resumed run's final parameters and
    moments equal the uninterrupted run's bit for bit.  And a bf16
    reduced train state through ``CheckpointManager`` and back, bit for
    bit."""
    import shutil
    import tempfile
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import build
    from repro_torch.training import optim, step as step_lib

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        whole = launch_train.main(["--steps", "6", "--ckpt-every", "3",
                                   "--ckpt", a])
        os.makedirs(b)
        shutil.copytree(os.path.join(a, "step_00000003"),
                        os.path.join(b, "step_00000003"))
        resumed = launch_train.main(["--steps", "6", "--ckpt-every", "3",
                                     "--ckpt", b])
        require(resumed["start"] == 3, f"train_resume: resumed from "
                                       f"{resumed['start']}, not 3")
        pairs = list(zip(_state_leaves(whole["state"]),
                         _state_leaves(resumed["state"])))
        diff = max(float((x.float() - y.float()).abs().max())
                   for x, y in pairs)
        equal = all(torch.equal(x, y) for x, y in pairs)
        require(equal, f"train_resume: the resumed state differs from the "
                       f"uninterrupted run's (max |diff| {diff})")
        require(np.allclose(whole["losses"][3:], resumed["losses"], rtol=0,
                            atol=0), "train_resume: losses of steps 3-5 "
                                     "differ")

        cfg = dataclasses.replace(reduced(get_config(TRAIN_ARCH)),
                                  dtype="bfloat16", param_dtype="bfloat16")
        oc = optim.AdamWConfig(moment_dtype="bfloat16")
        st = step_lib.init_train_state(build(cfg), torch.Generator(
            device=dev).manual_seed(1), oc, device=dev)
        mgr = CheckpointManager(os.path.join(tmp, "bf16"))
        mgr.save(1, st)
        back = mgr.restore(1, st, device=dev, verify=True)
        bf = list(zip(_state_leaves(st), _state_leaves(back)))
        require(all(x.dtype == y.dtype and torch.equal(x, y) for x, y in bf)
                and any(x.dtype == torch.bfloat16 for x, _ in bf),
                "train_resume: a bf16 train state does not round-trip")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(phase="train_resume", steps=6, ckpt_every=3,
                resumed_from=resumed["start"], losses=whole["losses"],
                resumed_losses=resumed["losses"], bit_equal=equal,
                max_abs_diff=diff, leaves=len(pairs),
                bf16_round_trip=dict(leaves=len(bf), bit_equal=True),
                seconds=time.perf_counter() - t0)


def _leaf_paths(tree, pre=""):
    """[(path, leaf)] of a tree of dicts (keys sorted) and namedtuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_paths(tree[k], f"{pre}/{k}")]
    if hasattr(tree, "_fields"):
        return [x for k in tree._fields
                for x in _leaf_paths(getattr(tree, k), f"{pre}/{k}")]
    return [(pre, tree)]


def _state_leaves(state):
    return [t for _, t in _leaf_paths(state)]


# -- training the ssm: the scan backward kernel -------------------------------

SCAN_GRADS = ("du", "ddt", "dB", "dC", "dA_log")
# B, S, din, N, u/B/C type, dt type, x_proj's dt_rank (B and C as views of
# its output; 0: views of one (B, S, 2N) tensor), dh_last given:
# falcon-mamba's training shape, fp32 at a mid size, the edges (one step,
# a ragged chunk and din off the 64-channel block, N = 64 and N = 1), dt in
# u's type, a final-state gradient; then the edges of the states every 16
# steps and the 4-step sub-chunks: S = 16 + 1 with din off the block (72),
# a ragged last sub-chunk (S = 22: 16 + 4 + 2) at N 8 with bf16 rows of 200
# bytes (din 100, which the wrapper pads for TMA), N 32 (4 threads a
# channel) with S = 37
SCAN_BWD_CASES = [(4, 4096, 8192, 16, "bfloat16", "float32", 256, False),
                  (2, 1000, 512, 16, "float32", "float32", 0, False),
                  (1, 1, 64, 16, "float32", "float32", 0, False),
                  (1, 65, 100, 4, "float32", "float32", 0, False),
                  (2, 130, 96, 64, "float32", "float32", 0, False),
                  (1, 64, 64, 1, "float32", "float32", 0, False),
                  (2, 130, 96, 64, "bfloat16", "bfloat16", 0, False),
                  (2, 300, 200, 16, "bfloat16", "float32", 0, True),
                  (2, 17, 72, 16, "bfloat16", "float32", 0, False),
                  (1, 22, 100, 8, "bfloat16", "bfloat16", 0, True),
                  (1, 37, 40, 32, "float32", "float32", 0, False)]
SCAN_TRAIN_SHAPE = SCAN_BWD_CASES[0][:4]   # ssm_train_main's microbatch
SCAN_FAULTS = ("lagged_state", "no_carry_decay", "dropped_block")
FAULT_MARGIN = 10.0         # each planted fault's limit use at least this


def bf16_half_step(w: torch.Tensor) -> torch.Tensor:
    """Half a bf16 step of each element of ``w`` (2^(e - 8) for |w| in
    [2^e, 2^(e+1)), 0 at 0): the most a correct rounding to bf16 moves
    it."""
    m, e = torch.frexp(w.float())
    return torch.ldexp(torch.ones_like(m), e - 9) * (w != 0)


def scan_grad_limit_use(got, want) -> dict:
    """{gradient: max |got - want| / limit} of the scan's five gradients
    against fp32 ``want``: the limit ``TRAIN_TOL["grad"]`` of the largest
    |want|, plus, for a bf16 output, half a bf16 step of each element
    (``bf16_half_step``).  Above 1 fails."""
    out = {}
    for name, g, w in zip(SCAN_GRADS, got, want):
        w = w.float()
        lim = TRAIN_TOL["grad"] * float(w.abs().max()) + 1e-30
        if g.dtype == torch.bfloat16:
            lim = lim + bf16_half_step(w)
        out[name] = float(((g.float() - w).abs() / lim).max())
    return out


def scan_bwd_fault(ins, states, dy, dh_last, fault: str, channels: int):
    """The scan's fp32 gradients with a planted fault, from the plain
    recurrence: ``lagged_state`` uses h_t where h_{t-1} belongs,
    ``no_carry_decay`` carries g_{t+1} without a_{t+1}, ``dropped_block``
    leaves the first ``channels`` channels' (one kernel block's) partial
    out of dB and dC."""
    from repro_torch.kernels.mamba_scan.ref import (
        STATE_CHUNK, mamba_scan_bwd_plain,
    )

    u, dt, Bc, Cc, A_log = (t.float() for t in ins)
    dy = dy.float()
    if fault == "dropped_block":
        c = slice(0, channels)
        full = mamba_scan_bwd_plain(u, dt, Bc, Cc, A_log, states, dy, dh_last)
        part = mamba_scan_bwd_plain(
            u[..., c], dt[..., c], Bc, Cc, A_log[c], states[..., c, :],
            dy[..., c], None if dh_last is None else dh_last[:, c])
        return full[:2] + (full[2] - part[2], full[3] - part[3], full[4])
    A = -torch.exp(A_log)
    S = u.shape[1]
    carry = torch.zeros_like(states[:, 0]) if dh_last is None else dh_last
    du, ddt, dB, dC = (torch.empty_like(t) for t in (u, dt, Bc, Cc))
    dA = torch.zeros_like(A)
    for t0 in reversed(range(0, S, STATE_CHUNK)):
        hs = [states[:, t0 // STATE_CHUNK]]
        for t in range(t0, min(S, t0 + STATE_CHUNK)):
            hs.append(torch.exp(dt[:, t, :, None] * A) * hs[-1]
                      + (dt[:, t] * u[:, t])[..., None] * Bc[:, t, None, :])
        for t in reversed(range(t0, min(S, t0 + STATE_CHUNK))):
            h = hs[t - t0 + 1]
            h_prev = h if fault == "lagged_state" else hs[t - t0]
            a = torch.exp(dt[:, t, :, None] * A)
            g = dy[:, t, :, None] * Cc[:, t, None, :] + carry
            dC[:, t] = torch.sum(dy[:, t, :, None] * h, dim=1)
            dB[:, t] = torch.sum(g * (dt[:, t] * u[:, t])[..., None], dim=1)
            gb = torch.sum(g * Bc[:, t, None, :], dim=-1)
            du[:, t] = dt[:, t] * gb
            gah = g * a * h_prev
            ddt[:, t] = u[:, t] * gb + torch.sum(gah * A, dim=-1)
            dA += torch.sum(gah * dt[:, t, :, None], dim=0)
            carry = g if fault == "no_carry_decay" else a * g
    return du, ddt, dB, dC, A * dA


def scan_bwd_case(dev, case, rng) -> dict:
    """One ``SCAN_BWD_CASES`` case on ``dev``: the forward kernel's y and
    h_last with and without its states (bit-equal), its states against
    the plain ``chunk_states`` (fp32 inputs: 1e-4, bf16: 1e-3, as
    ``mamba_scan_vs_plain`` holds h_last); the backward kernel's five
    gradients, from the kernel's states, against the plain backward on
    fp32 copies of the same inputs and states (``scan_grad_limit_use``),
    two calls bit-equal; and each planted fault's limit use
    (``scan_bwd_fault``; None where the fault leaves the gradients
    unchanged, as the carry at S = 1)."""
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.mamba_scan.ref import (
        mamba_scan_bwd_plain, mamba_scan_plain,
    )

    B, S, din, N, dt_name, dtd_name, R, with_dh = case
    dtype = getattr(torch, dt_name)
    ins = list(scan_inputs(dev, (B, S, din, N), dtype, rng, R=R))
    ins[1] = ins[1].to(getattr(torch, dtd_name))
    g = lambda *s: torch.from_numpy(
        rng.normal(0, 1, s).astype(np.float32)).to(dev)
    dy = g(B, S, din).to(dtype)
    dh = g(B, din, N) if with_dh else None
    y, h, states = sops.mamba_scan_fwd(*ins)
    y0, h0 = sops.mamba_scan(*ins)
    _, _, st_plain = mamba_scan_plain(*ins, chunk_states=True)
    st_tol = 1e-4 if dt_name == "float32" else 1e-3
    st_err = float((states - st_plain).abs().max())
    b0 = sops.bwd_launch_count
    got = sops.mamba_scan_bwd(*ins, states, dy, dh)
    again = sops.mamba_scan_bwd(*ins, states, dy, dh)
    launches = sops.bwd_launch_count - b0
    f32 = [t.float() for t in ins]
    want = mamba_scan_bwd_plain(*f32, states, dy.float(), dh)
    use = scan_grad_limit_use(got, want)
    channels = sops.bwd_plan(B, S, din, N).channels
    faults = {}
    for f in SCAN_FAULTS:
        bad = scan_bwd_fault(f32, states, dy, dh, f, channels)
        faults[f] = (None if all(torch.equal(a, w) for a, w in zip(bad, want))
                     else max(scan_grad_limit_use(
                         [a.to(x.dtype) for a, x in zip(bad, got)],
                         want).values()))
    return dict(
        B=B, S=S, din=din, N=N, dtype=dt_name, dt_dtype=dtd_name,
        bc_stride_t=int(ins[2].stride(1)), dh_last=with_dh,
        plan=sops.bwd_plan(B, S, din, N)._asdict(),
        fwd_states_bit_equal=bool(torch.equal(y, y0) and torch.equal(h, h0)),
        states_max_abs_err=st_err, states_tol=st_tol,
        tol=dict(rel=TRAIN_TOL["grad"],
                 bf16_elementwise="half a bf16 step of |want|"),
        out_dtypes=[str(t.dtype) for t in got],
        max_abs_err=dict(zip(SCAN_GRADS, (
            float((a.float() - w).abs().max()) for a, w in zip(got, want)))),
        want_max=dict(zip(SCAN_GRADS, (float(w.abs().max()) for w in want))),
        limit_use=use, max_limit_use=max(use.values()),
        bit_equal_calls=all(torch.equal(a, b) for a, b in zip(got, again)),
        launches=launches, fault_limit_use=faults)


def scan_bwd_vs_plain(dev):
    """``scan_bwd_case`` at every ``SCAN_BWD_CASES`` case: every limit use
    at most 1, the states within their limit, two calls bit-equal, one
    launch a call, and every planted fault that changes the gradients at
    ``FAULT_MARGIN`` x the limit or more.  Returns the record."""
    rng = np.random.default_rng(25)
    t0 = time.perf_counter()
    rec = dict(phase="scan_bwd_vs_plain", cases=[])
    for case in SCAN_BWD_CASES:
        c = scan_bwd_case(dev, case, rng)
        require(c["fwd_states_bit_equal"], f"mamba_scan {case}: y or h_last "
                f"differ with the states output")
        require(c["states_max_abs_err"] <= c["states_tol"], f"mamba_scan "
                f"{case}: states != plain ({c['states_max_abs_err']})")
        require(c["max_limit_use"] <= 1.0, f"mamba_scan_bwd {case} != plain"
                f" (limit use {c['limit_use']}, max err {c['max_abs_err']})")
        require(c["bit_equal_calls"], f"mamba_scan_bwd {case}: two calls "
                                      f"differ")
        require(c["launches"] == 2, f"mamba_scan_bwd {case}: "
                f"{c['launches']} launches for 2 calls")
        for f, use in c["fault_limit_use"].items():
            require(use is None or use >= FAULT_MARGIN, f"the scan's "
                    f"gradient check at {case} passes its {f} fault within "
                    f"{FAULT_MARGIN}x (limit use {use})")
        rec["cases"].append(c)
        gc.collect()
        torch.cuda.empty_cache()
    cs = rec["cases"]
    rec["max_abs_err"] = max(max(c["max_abs_err"].values()) for c in cs)
    rec["max_limit_use"] = max(c["max_limit_use"] for c in cs)
    rec["max_states_err"] = max(c["states_max_abs_err"] for c in cs)
    rec["min_fault_limit_use"] = {
        f: min(c["fault_limit_use"][f] for c in cs
               if c["fault_limit_use"][f] is not None) for f in SCAN_FAULTS}
    rec["seconds"] = time.perf_counter() - t0
    return rec


def scan_bwd_bound(shape, esize=2):
    """``scan_bound``'s terms for one backward call: u, dt (fp32), dy, B,
    C, A_log and the states read once, du, ddt (fp32), dB, dC and dA_log
    written once (u, dy, du, B, C, dB, dC in ``esize`` bytes); B S din N
    exponentials at the special-function units' rate."""
    B, S, din, N = shape
    nch = -(-S // 64)
    moved = (B * S * din * (3 * esize + 8) + 4 * B * S * N * esize
             + 4 * B * nch * din * N + 8 * din * N)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exps = B * S * din * N
    bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
    exps_ms = 1e3 * exps / (SFU_PER_CLK_SM * sms * SM_CLOCK_HZ)
    by = "bytes" if bytes_ms >= exps_ms else "operations"
    return max(bytes_ms, exps_ms), by, moved, bytes_ms, exps, exps_ms


def scan_bwd_time(dev):
    """CUDA-event medians at ``SCAN_TRAIN_SHAPE`` (bf16 u/B/C as views of
    x_proj's output, fp32 dt), L2 emptied by a 1 GiB read before each
    call: the backward (the kernel and the wrapper's sums of its
    partials) beside its bound and the plain backward; the forward with
    and without its states.  The launch's plan must be one resident wave,
    its blocks an SM what the CUDA runtime fits on this card
    (``ops.bwd_occupancy``).  No PyTorch call computes the scan's
    gradient, so there is no library yardstick."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_bwd_plain

    rng = np.random.default_rng(26)
    flush = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    ins = scan_inputs(dev, SCAN_TRAIN_SHAPE, torch.bfloat16, rng,
                      R=SCAN_DT_RANK)
    _, _, states = sops.mamba_scan_fwd(*ins)
    dy = torch.from_numpy(rng.normal(0, 1, ins[0].shape).astype(
        np.float32)).to(dev, torch.bfloat16)
    before = sops.bwd_launch_count
    runs = warm_ms(lambda: sops.mamba_scan_bwd(*ins, states, dy), flush, 10)
    require(sops.bwd_launch_count == before + len(runs) + 1,
            "timed scan backward call not one launch each")
    bound, by, moved, bytes_ms, exps, exps_ms = scan_bwd_bound(
        SCAN_TRAIN_SHAPE)
    plain = statistics.median(warm_ms(
        lambda: mamba_scan_bwd_plain(*ins, states, dy), flush, 1))
    fwd = [statistics.median(warm_ms(f, flush, 10)) for f in (
        lambda: sops.mamba_scan(*ins), lambda: sops.mamba_scan_fwd(*ins),
        lambda: sops.mamba_scan_fwd(*ins), lambda: sops.mamba_scan(*ins))]
    ms = statistics.median(runs)
    plan = sops.bwd_plan(*SCAN_TRAIN_SHAPE)
    occupancy = sops.bwd_occupancy(SCAN_TRAIN_SHAPE[3], torch.bfloat16,
                                   torch.float32)
    require(plan.one_wave and occupancy == plan.blocks_per_sm,
            f"scan backward: plan {plan}, the runtime fits {occupancy} "
            f"blocks an SM")
    shape = (f"bf16 u/B/C/dy (B/C views of x_proj's output), fp32 dt, "
             f"(B, S, din, N) = {SCAN_TRAIN_SHAPE}")
    return dict(
        phase="scan_bwd_time",
        bwd=dict(shape=shape, ms_runs=runs, ms=ms, bytes=moved,
                 bytes_ms=bytes_ms, exps=exps, exps_ms=exps_ms,
                 bound_ms=bound, bound_by=by, roofline_share=bound / ms,
                 plain_ms=plain, library_ms=None, plan=plan._asdict(),
                 runtime_blocks_per_sm=occupancy,
                 ptxas=kbuild.info("mamba_scan_bwd").get("ptxas")),
        fwd=dict(shape=shape, order="no states, states, states, no states",
                 ms=[fwd[0], fwd[3]], ms_with_states=[fwd[1], fwd[2]],
                 states_bytes=int(states.numel()) * 4),
        l2_flush_bytes=flush.numel() * 4)


def ssm_grad_check(dev, c16, batch):
    """falcon-mamba config ``c16`` (bf16) against the same random params in
    fp32 on ``batch``, on ``dev``: (bf16 loss, fp32 loss, the scan's
    [forward, backward] launches in the bf16 loss, each gradient leaf's
    relative error (``grad_rel_errors``), the same with the scan's backward
    replaced in one loss by the planted ``no_carry_decay`` fault
    (``scan_bwd_fault``, through a ``MambaScan.backward`` swapped in and
    restored in ``finally``))."""
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.models.model import (
        build, params_from_numpy, params_to_numpy,
    )
    from repro_torch.training import step as step_lib

    c32 = dataclasses.replace(c16, dtype="float32", param_dtype="float32")
    a16, a32 = build(c16), build(c32)
    p16 = a16.init(torch.Generator(device=dev).manual_seed(0), dev)
    p32 = params_from_numpy(c32, params_to_numpy(p16), dev)
    l32, _, g32 = step_lib.value_and_grad(a32, p32, batch)
    del p32
    s0, b0 = sops.launch_count, sops.bwd_launch_count
    l16, _, g16 = step_lib.value_and_grad(a16, p16, batch)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    launches = [sops.launch_count - s0, sops.bwd_launch_count - b0]
    rel = grad_rel_errors(g16, g32)
    del g16

    def no_carry_decay(ctx, dy, dh_last):
        u, dt, Bc, Cc, A_log, states = ctx.saved_tensors
        ins = (u, dt, Bc, Cc, A_log)
        grads = scan_bwd_fault(ins, states,
                               torch.zeros_like(u) if dy is None else dy,
                               dh_last, "no_carry_decay", 0)
        return tuple(g.to(x.dtype) if need else None for g, x, need in
                     zip(grads, ins, ctx.needs_input_grad))

    backward = sops.MambaScan.__dict__["backward"]
    sops.MambaScan.backward = staticmethod(no_carry_decay)
    try:
        _, _, gf = step_lib.value_and_grad(a16, p16, batch)
    finally:
        sops.MambaScan.backward = backward
    fault = grad_rel_errors(gf, g32)
    return float(l16), float(l32), launches, rel, fault


def ssm_bf16_grad(dev):
    """The bf16 training gradient of falcon-mamba against the fp32 one:
    its full width cut to ``BF16_GRAD_LAYERS`` layers, random params made
    in bf16 and the same values in fp32, one batch of ``BF16_GRAD_BATCH``
    x 4,096 tokens (``ssm_grad_check``); a scan forward and its remat
    recompute and a backward a layer in each loss.  Each leaf's relative
    error must be within ``BF16_GRAD_TOL``, and the same check with the
    scan's backward carrying g without its decay (a planted fault) must
    exceed it, as ``train_bf16_grad`` holds olmo-1b."""
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import make_batch
    from repro_torch.models.config import ShapeCell

    t0 = time.perf_counter()
    c16 = dataclasses.replace(get_config(SSM_TRAIN_ARCH),
                              n_layers=BF16_GRAD_LAYERS)
    batch = make_batch(c16, ShapeCell("t", TRAIN_SEQ, BF16_GRAD_BATCH,
                                      "train"), seed=6, device=dev)
    l16, l32, launches, rel, fault = ssm_grad_check(dev, c16, batch)
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    require(launches == [2 * BF16_GRAD_LAYERS, BF16_GRAD_LAYERS],
            f"ssm_bf16_grad: scan launches {launches}, want a forward and "
            f"its remat recompute and a backward a layer")
    require(max(rel.values()) <= BF16_GRAD_TOL, f"ssm_bf16_grad: bf16 "
            f"gradients != fp32 beyond {BF16_GRAD_TOL} ({rel})")
    require(max(fault.values()) > BF16_GRAD_TOL, f"ssm_bf16_grad: the "
            f"check passes a scan backward without the carry's decay "
            f"({fault})")
    return dict(
        phase="ssm_bf16_grad", arch=c16.name, n_layers=c16.n_layers,
        d_model=c16.d_model, d_inner=c16.d_inner, vocab=c16.vocab,
        batch=BF16_GRAD_BATCH, seq_len=TRAIN_SEQ, gated=True,
        tol=BF16_GRAD_TOL, loss_bf16=l16, loss_fp32=l32, launches=launches,
        rel_err=rel, max_rel_err=max(rel.values()), fault_rel_err=fault,
        fault_max_rel_err=max(fault.values()),
        seconds=time.perf_counter() - t0)


# -- the mamba_bf16_scan path: the bf16 kernels -------------------------------

# B, S, din, N, u/B/C type, dt type, chunk C, x_proj's dt_rank (B and C as
# views of its output; 0: of one (B, S, 2N) tensor): SCAN_SHAPES at C 256,
# 64 and 7 in both types (S = 1, 17, 255 ragged), falcon-mamba's prefill
# at C 256, 64 and 7 and its training shape at 256, its width in fp32 at a
# ragged S 600, C 300 (past 256) with S ragged, C 1, N 1, 3 and 64
SCAN_BF16_CASES = [(1, 1, 8192, 16, "bfloat16", "float32", 256, 256),
                   (2, 17, 8192, 16, "float32", "float32", 7, 256),
                   (1, 255, 96, 8, "bfloat16", "float32", 64, 0),
                   (2, 256, 128, 4, "float32", "float32", 7, 0),
                   (4, 2048, 8192, 16, "bfloat16", "float32", 256, 256),
                   (4, 2048, 8192, 16, "bfloat16", "float32", 64, 256),
                   (4, 2048, 8192, 16, "bfloat16", "float32", 7, 256),
                   (4, 4096, 8192, 16, "bfloat16", "float32", 256, 256),
                   (1, 600, 8192, 16, "float32", "float32", 256, 256),
                   (2, 1000, 512, 16, "bfloat16", "bfloat16", 300, 0),
                   (1, 100, 40, 1, "float32", "float32", 16, 0),
                   (1, 33, 24, 3, "float32", "float32", 1, 0),
                   (2, 70, 64, 64, "bfloat16", "float32", 7, 0)]
SCAN_BF16_CHUNK = 256       # falcon-mamba-7b's ssm_chunk
# the backward's edges (falcon-mamba's training shape is checked where it
# is timed): C 7 with a final-state gradient, C 16 at N 32, C 64 at N 64
# with dt in bf16, C past S, C 5 at N 4 with din off the block
SCAN_BF16_BWD_CASES = [(2, 300, 200, 16, "bfloat16", "float32", 7, 0, True),
                       (1, 37, 40, 32, "float32", "float32", 16, 0, False),
                       (2, 130, 96, 64, "bfloat16", "bfloat16", 64, 0, False),
                       (1, 22, 100, 8, "bfloat16", "bfloat16", 300, 0, True),
                       (2, 17, 72, 4, "float32", "float32", 5, 0, True)]
SCAN_BF16_FAULTS = ("sequential", "fp32", "unrounded_carry")
# the forward's limit: the kernel runs the plain version's bf16 operations,
# which round alike, so a bf16 output (y for bf16 u, h_last) may differ in
# at most this share of elements, each by at most one bf16 step of max
# |plain|; an fp32 y (fp32 u), an fp32 sum in another order, within 1e-5
# of max |plain|
SCAN_BF16_SHARE, SCAN_BF16_Y32 = 1e-3, 1e-5
SSM_BF16_LAYERS, SSM_BF16_STEPS = 8, 2
SSM_BF16_TOL = 2.5e-4       # ssm_bf16_main's card against the CPU: logits


def ptxas_entries(lines, marker: str) -> list:
    """ptxas' lines of the kernels whose mangled name holds ``marker``:
    each entry-function line and the lines after it up to the next
    (``-Xptxas -v`` names a kernel once, then its registers and spills)."""
    out, keep = [], False
    for ln in lines:
        if "entry function" in ln:
            keep = marker in ln
        if keep:
            out.append(ln)
    return out


def scan_bf16_fault(ins, chunk: int, fault: str):
    """(y, h_last) of the bf16 scan with a planted fault: ``sequential``
    walks h <- bf16(a h) + b step by step (not the reference's order),
    ``fp32`` is the fp32 function (the flag off), ``unrounded_carry``
    keeps hs and the carry in fp32 (b_cum + a_cum h unrounded)."""
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.mamba_scan.ref import associative_scan_bf16

    u, dt, Bc, Cc, A_log = ins
    if fault == "fp32":
        return sops.mamba_scan(*ins)
    bf = torch.bfloat16
    A = -torch.exp(A_log.float())
    B, S, din = u.shape
    h = torch.zeros((B, din, A.shape[1]), dtype=torch.float32,
                    device=u.device)
    cb = Cc.to(bf).float()
    ys = []
    if fault == "sequential":
        hb = h.to(bf)
        for t in range(S):
            a = torch.exp(dt[:, t].float()[..., None] * A).to(bf)
            b = ((dt[:, t].float() * u[:, t].float())[..., None]
                 * Bc[:, t].float()[:, None, :]).to(bf)
            hb = a * hb + b
            ys.append((hb.float() * cb[:, t, None, :]).sum(-1))
        return torch.stack(ys, dim=1).to(u.dtype), hb.float()
    for c0 in range(0, S, chunk):
        n = min(chunk, S - c0)
        dtc = dt[:, c0:c0 + n].float()
        dA = torch.exp(dtc[..., None] * A).to(bf)
        dBu = ((dtc * u[:, c0:c0 + n].float())[..., None]
               * Bc[:, c0:c0 + n].float()[:, :, None, :]).to(bf)
        if n < chunk:
            pad = (B, chunk - n, din, A.shape[1])
            dA = torch.cat([dA, dA.new_ones(pad)], dim=1)
            dBu = torch.cat([dBu, dBu.new_zeros(pad)], dim=1)
        a_cum, b_cum = associative_scan_bf16(dA, dBu, 1)
        hs = b_cum.float() + a_cum.float() * h[:, None]
        ys.append((hs[:, :n] * cb[:, c0:c0 + n, None, :]).sum(-1))
        h = hs[:, -1]
    return torch.cat(ys, dim=1).to(u.dtype), h


def scan_bf16_use(got, want, bf16_values: bool = True) -> dict:
    """One output of the bf16 scan against its plain version: max |err|
    over max |plain|, the share of unequal elements, and the limit use
    (above 1 fails): bf16 values (y for bf16 u, h_last, the states) at
    most ``SCAN_BF16_SHARE`` unequal and each within one bf16 step (2^-8)
    of max |plain|; an fp32 y (fp32 u) within ``SCAN_BF16_Y32`` of max
    |plain|."""
    diff = (got.float() - want.float()).abs()
    top = float(want.float().abs().max()) + 1e-30
    share = float((diff > 0).float().mean())
    rel = float(diff.max()) / top
    use = (max(rel / 2.0 ** -8, share / SCAN_BF16_SHARE) if bf16_values
           else rel / SCAN_BF16_Y32)
    return dict(rel_err=rel, unequal_share=share, limit_use=use)


def scan_inputs_on(dev, shape, dtype, gen, R: int = 0):
    """``scan_inputs``' distributions drawn on ``dev`` from the torch
    generator ``gen`` (at falcon-mamba's shapes numpy on the host takes
    seconds a call)."""
    B, S, din, N = shape
    g = lambda *s: torch.randn(s, generator=gen, device=dev)
    u, dt = g(B, S, din).to(dtype), g(B, S, din).abs() * 0.1
    dbc = g(B, S, R + 2 * N).to(dtype)
    return u, dt, dbc[..., R:R + N], dbc[..., R + N:], g(din, N) * 0.5


def scan_bf16_case(dev, case, gen, faults: bool = False) -> dict:
    """One ``SCAN_BF16_CASES`` case on ``dev``: the ``mamba_scan_bf16``
    kernel (through ``mamba_scan``) against ``mamba_scan_bf16_plain`` on
    the same inputs, y and h_last (``scan_bf16_use``), with and without
    states (bit-equal), the states against the plain ones; with
    ``faults``, each planted fault's limit use (``scan_bf16_fault``)."""
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_bf16_plain

    B, S, din, N, dt_name, dtd_name, C, R = case
    ins = list(scan_inputs_on(dev, (B, S, din, N), getattr(torch, dt_name),
                              gen, R=R))
    ins[1] = ins[1].to(getattr(torch, dtd_name))
    b0 = sops.bf16_launch_count
    y, h = sops.mamba_scan(*ins, C)
    y1, h1, st = sops.mamba_scan_fwd(*ins, C)
    launches = sops.bf16_launch_count - b0
    y0, h0, st0 = mamba_scan_bf16_plain(*ins, C, chunk_states=True)
    rec = dict(B=B, S=S, din=din, N=N, dtype=dt_name, dt_dtype=dtd_name,
               chunk=C, bc_stride_t=int(ins[2].stride(1)),
               plan=sops.bf16_plan(B, S, din, N, C)._asdict(),
               launches=launches,
               y=scan_bf16_use(y, y0, y0.dtype == torch.bfloat16),
               h_last=scan_bf16_use(h, h0),
               states=scan_bf16_use(st, st0),
               states_bit_equal=bool(torch.equal(y, y1)
                                     and torch.equal(h, h1)))
    rec["max_limit_use"] = max(rec[k]["limit_use"]
                               for k in ("y", "h_last", "states"))
    if faults:
        rec["fault_limit_use"] = {}
        for f in SCAN_BF16_FAULTS:
            fy, fh = scan_bf16_fault(ins, C, f)
            rec["fault_limit_use"][f] = max(
                scan_bf16_use(fy, y0, y0.dtype == torch.bfloat16)[
                    "limit_use"], scan_bf16_use(fh, h0)["limit_use"])
    return rec


def scan_bf16_bwd_case(dev, case, gen) -> dict:
    """One ``SCAN_BF16_BWD_CASES`` case: the backward kernel under its
    bf16 flag (``mamba_scan_bwd(..., bf16_chunk)``) against
    ``mamba_scan_bwd_plain(..., bf16_chunk)`` on fp32 copies of the same
    inputs from the bf16 forward kernel's states (``scan_grad_limit_use``),
    two calls bit-equal."""
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_bwd_plain

    B, S, din, N, dt_name, dtd_name, C, R, with_dh = case
    dtype = getattr(torch, dt_name)
    ins = list(scan_inputs_on(dev, (B, S, din, N), dtype, gen, R=R))
    ins[1] = ins[1].to(getattr(torch, dtd_name))
    g = lambda *s: torch.randn(s, generator=gen, device=dev)
    dy = g(B, S, din).to(dtype)
    dh = g(B, din, N) if with_dh else None
    _, _, states = sops.mamba_scan_fwd(*ins, C)
    b0 = sops.bf16_bwd_launch_count
    got = sops.mamba_scan_bwd(*ins, states, dy, dh, C)
    again = sops.mamba_scan_bwd(*ins, states, dy, dh, C)
    launches = sops.bf16_bwd_launch_count - b0
    want = mamba_scan_bwd_plain(*(t.float() for t in ins), states,
                                dy.float(), dh, bf16_chunk=C)
    use = scan_grad_limit_use(got, want)
    return dict(B=B, S=S, din=din, N=N, dtype=dt_name, dt_dtype=dtd_name,
                chunk=C, dh_last=with_dh, launches=launches,
                max_abs_err=dict(zip(SCAN_GRADS, (
                    float((a.float() - w).abs().max())
                    for a, w in zip(got, want)))),
                limit_use=use, max_limit_use=max(use.values()),
                bit_equal_calls=all(torch.equal(a, b)
                                    for a, b in zip(got, again)))


def scan_bf16_vs_plain(dev):
    """The bf16 scan's kernels on the card: ``scan_bf16_case`` at every
    ``SCAN_BF16_CASES`` case (the planted faults at falcon-mamba's prefill
    shape, C 256 and 7), ``scan_bf16_bwd_case`` at every
    ``SCAN_BF16_BWD_CASES`` case and at ``SCAN_TRAIN_SHAPE``, every limit
    use at most 1, each fault's above 1.  Then CUDA-event medians, L2
    emptied by a 1 GiB read before each call, of the forward at
    ``SCAN_MAIN`` (bf16 u/B/C as views of x_proj's output, fp32 dt, C 256)
    beside the fp32 scan's kernel, and of the backward at
    ``SCAN_TRAIN_SHAPE`` beside the fp32 backward, in the order fp32,
    bf16, bf16, fp32; each beside its bound (``scan_bound``,
    ``scan_bwd_bound``: the fp32 function's bytes and exponentials) and its
    plain version's time, one call (whose outputs are the oracle of the
    timed kernels' at these shapes)."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.mamba_scan.ref import (
        mamba_scan_bf16_plain, mamba_scan_bwd_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(29)
    t0 = time.perf_counter()
    rec = dict(phase="scan_bf16_vs_plain", cases=[], bwd_cases=[])
    for case in SCAN_BF16_CASES:
        t1 = time.perf_counter()
        faults = case[:4] == SCAN_MAIN and case[6] in (256, 7)
        c = scan_bf16_case(dev, case, gen, faults=faults)
        require(c["max_limit_use"] <= 1.0 and c["states_bit_equal"]
                and c["launches"] == 2, f"mamba_scan_bf16 {case} != plain "
                f"({c})")
        for f, use in c.get("fault_limit_use", {}).items():
            require(use > 1.0, f"the bf16 scan's check at {case} passes its "
                               f"{f} fault (limit use {use})")
        c["seconds"] = time.perf_counter() - t1
        rec["cases"].append(c)
        gc.collect()
        torch.cuda.empty_cache()
    for case in SCAN_BF16_BWD_CASES:
        t1 = time.perf_counter()
        c = scan_bf16_bwd_case(dev, case, gen)
        require(c["max_limit_use"] <= 1.0 and c["bit_equal_calls"]
                and c["launches"] == 2, f"mamba_scan_bwd (bf16) {case} != "
                f"plain ({c})")
        c["seconds"] = time.perf_counter() - t1
        rec["bwd_cases"].append(c)
    rec["check_s"] = time.perf_counter() - t0

    flush = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    C = SCAN_BF16_CHUNK
    ins = scan_inputs_on(dev, SCAN_MAIN, torch.bfloat16, gen, R=SCAN_DT_RANK)
    fwd = [statistics.median(warm_ms(f, flush, 10)) for f in (
        lambda: sops.mamba_scan(*ins), lambda: sops.mamba_scan(*ins, C),
        lambda: sops.mamba_scan(*ins, C), lambda: sops.mamba_scan(*ins))]
    want = []
    fwd_plain = cuda_ms(lambda: want.append(mamba_scan_bf16_plain(*ins, C)),
                        1, flush)[0]
    b0 = sops.bf16_launch_count
    y1, h1 = sops.mamba_scan(*ins, C)
    use = max(scan_bf16_use(y1, want[0][0])["limit_use"],
              scan_bf16_use(h1, want[0][1])["limit_use"])
    require(sops.bf16_launch_count == b0 + 1 and use <= 1.0,
            f"timed bf16 scan not one launch, or not its plain version "
            f"(limit use {use})")
    bound, by, moved, bytes_ms, exps, exps_ms = scan_bound(SCAN_MAIN)
    del ins, want, y1, h1
    ins = scan_inputs_on(dev, SCAN_TRAIN_SHAPE, torch.bfloat16, gen,
                         R=SCAN_DT_RANK)
    _, _, st32 = sops.mamba_scan_fwd(*ins)
    _, _, st16 = sops.mamba_scan_fwd(*ins, C)
    dy = torch.randn(ins[0].shape, generator=gen, device=dev).to(
        torch.bfloat16)
    bwd = [statistics.median(warm_ms(f, flush, 5)) for f in (
        lambda: sops.mamba_scan_bwd(*ins, st32, dy),
        lambda: sops.mamba_scan_bwd(*ins, st16, dy, None, C),
        lambda: sops.mamba_scan_bwd(*ins, st16, dy, None, C),
        lambda: sops.mamba_scan_bwd(*ins, st32, dy))]
    want = []
    bwd_plain = cuda_ms(lambda: want.append(mamba_scan_bwd_plain(
        *(t.float() for t in ins), st16, dy.float(), bf16_chunk=C)), 1,
        flush)[0]
    b0 = sops.bf16_bwd_launch_count
    guse = scan_grad_limit_use(sops.mamba_scan_bwd(*ins, st16, dy, None, C),
                               want[0])
    require(sops.bf16_bwd_launch_count == b0 + 1 and
            max(guse.values()) <= 1.0, f"timed bf16 scan backward not one "
            f"launch, or not its plain version ({guse})")
    rec["bwd_cases"].append(dict(
        B=SCAN_TRAIN_SHAPE[0], S=SCAN_TRAIN_SHAPE[1], din=SCAN_TRAIN_SHAPE[2],
        N=SCAN_TRAIN_SHAPE[3], dtype="bfloat16", dt_dtype="float32", chunk=C,
        dh_last=False, limit_use=guse, max_limit_use=max(guse.values())))
    bbound, bby, bmoved, bbytes_ms, bexps, bexps_ms = scan_bwd_bound(
        SCAN_TRAIN_SHAPE)
    cs = rec["cases"]
    rec["max_rel_err"] = max(max(c["y"]["rel_err"], c["h_last"]["rel_err"])
                             for c in cs)
    rec["max_unequal_share"] = max(max(c["y"]["unequal_share"],
                                       c["h_last"]["unequal_share"])
                                   for c in cs)
    rec["max_limit_use"] = max(max(c["max_limit_use"] for c in cs), use)
    rec["bwd_max_limit_use"] = max(c["max_limit_use"]
                                   for c in rec["bwd_cases"])
    rec["bwd_max_abs_err"] = max(float(max(c["max_abs_err"].values()))
                                 for c in rec["bwd_cases"]
                                 if "max_abs_err" in c)
    rec["min_fault_limit_use"] = {
        f: min(c["fault_limit_use"][f] for c in cs if "fault_limit_use" in c)
        for f in SCAN_BF16_FAULTS}
    shape = lambda s: (f"bf16 u/B/C (B/C views of x_proj's output), fp32 dt,"
                       f" (B, S, din, N) = {s}, C {C}")
    ms, bms = statistics.median(fwd[1:3]), statistics.median(bwd[1:3])
    rec.update(
        fwd=dict(shape=shape(SCAN_MAIN), order="fp32, bf16, bf16, fp32",
                 ms=ms, ms_runs=fwd[1:3], fp32_ms=[fwd[0], fwd[3]],
                 bytes=moved, bytes_ms=bytes_ms, exps=exps, exps_ms=exps_ms,
                 bound_ms=bound, bound_by=by, roofline_share=bound / ms,
                 plain_ms=fwd_plain, library_ms=None,
                 ptxas=kbuild.info("mamba_scan_bf16").get("ptxas")),
        bwd=dict(shape=shape(SCAN_TRAIN_SHAPE) + ", bf16 dy",
                 order="fp32, bf16, bf16, fp32", ms=bms, ms_runs=bwd[1:3],
                 fp32_ms=[bwd[0], bwd[3]], bytes=bmoved, bytes_ms=bbytes_ms,
                 exps=bexps, exps_ms=bexps_ms, bound_ms=bbound, bound_by=bby,
                 roofline_share=bbound / bms, plain_ms=bwd_plain,
                 plain_inputs="fp32 copies", library_ms=None,
                 ptxas=ptxas_entries(kbuild.info("mamba_scan_bwd").get(
                     "ptxas", []), "Lb1EEEvPKf")),
        l2_flush_bytes=flush.numel() * 4,
        seconds=time.perf_counter() - t0)
    del ins, st32, st16, dy, flush, want
    torch.cuda.empty_cache()
    return rec


def ssm_bf16_consistency(dev) -> dict:
    """falcon-mamba-7b at full width in fp32 cut to
    ``GEN_CONSISTENCY_LAYERS`` layers, under ``mamba_bf16_scan``: a
    prefill of 300 numpy-seeded tokens (a ragged second chunk) on the
    card (the bf16 scan kernel, fp32 u) against the port on the CPU (its
    plain version), with the same params carried through numpy.  The two
    compute the same bf16 operations on inputs that differ by the fp32
    rounding of the projections (cuBLAS against the CPU's), so a rare dA
    or dt u B rounds the other way (one bf16 step) and the scan carries
    it on: the logits differ by 8.0e-5 to 8.5e-5 (relative Frobenius norm,
    "NVIDIA H100 80GB HBM3, 700.00 W"), and are held within
    ``SSM_BF16_TOL``, 3x that; the fp32 function on the card, the same
    params, lies 1.38e-3 to 1.41e-3 from the CPU's and must lie at least
    4x the tolerance away, so the check tells the two functions apart."""
    from repro_torch.configs import get_config
    from repro_torch.models import opt_flags
    from repro_torch.models.model import (build, params_from_numpy,
                                          params_to_numpy)

    t0 = time.perf_counter()
    full = get_config("falcon-mamba-7b")
    cfg = dataclasses.replace(
        full, n_layers=GEN_CONSISTENCY_LAYERS["falcon-mamba-7b"],
        dtype="float32", param_dtype="float32")
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    host = params_from_numpy(cfg, params_to_numpy(params), device="cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (1, 300))
    rel = lambda a, b: float((a.float() - b.float()).norm()
                             / (b.float().norm() + 1e-30))
    with opt_flags.use_flags(mamba_bf16_scan=True):
        got, gcache = api.prefill(params, torch.as_tensor(toks, device=dev),
                                  full_logits=True)
        t1 = time.perf_counter()
        want, wcache = api.prefill(host, torch.from_numpy(toks),
                                   full_logits=True)
        cpu_s = time.perf_counter() - t1
    f32, _ = api.prefill(params, torch.as_tensor(toks, device=dev),
                         full_logits=True)
    err, err32 = rel(got.cpu(), want), rel(f32.cpu(), want)
    state = rel(gcache.ssm.cpu(), wcache.ssm)
    require(err <= SSM_BF16_TOL and err32 >= 4 * SSM_BF16_TOL,
            f"ssm_bf16_consistency: card != CPU under the flag (logits rel "
            f"err {err}, the fp32 function's {err32}; tolerance "
            f"{SSM_BF16_TOL})")
    rec = dict(model=cfg.name, dtype=cfg.dtype,
               reduced=[f"n_layers {full.n_layers} -> {cfg.n_layers}"],
               tokens=list(toks.shape), chunk=cfg.ssm_chunk,
               logit_rel_err=err, fp32_function_rel_err=err32,
               ssm_state_rel_err=state, tol=SSM_BF16_TOL, cpu_s=cpu_s,
               cpu_threads=torch.get_num_threads(),
               allow_tf32=torch.backends.cuda.matmul.allow_tf32,
               seconds=time.perf_counter() - t0)
    del params, host, api, got, want, f32, gcache, wcache
    torch.cuda.empty_cache()
    return rec


def ssm_bf16_main(dev, ssm: dict | None = None,
                  ssm_train: dict | None = None):
    """falcon-mamba-7b at full width cut to ``SSM_BF16_LAYERS`` layers under
    ``mamba_bf16_scan`` (random bf16 weights from a seeded generator):
    one prefill of ``GEN_BATCH`` x ``GEN_PROMPT`` tokens and ``GEN_STEPS``
    greedy decode steps (decode is the fp32 recurrence, as the
    reference's), then ``SSM_BF16_STEPS`` timed training steps after a
    warm-up on train_main's cell.  The bf16 scan kernels must launch (one
    forward a layer in the prefill; two forwards, with the remat's
    recompute, and a backward a layer a microbatch a step) and the fp32
    scan kernels not at all.  Beside it: the fp32 prefill on the same
    params, ``ssm_main``'s and ``ssm_train_main``'s times, and
    ``ssm_bf16_consistency``.  Returns (record, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import opt_flags
    from repro_torch.models.model import build
    from repro_torch.training import optim, step as step_lib

    t_phase = time.perf_counter()
    full = get_config("falcon-mamba-7b")
    cfg = dataclasses.replace(full, n_layers=SSM_BF16_LAYERS)
    api, params, init_s, weight_bytes, _ = _init_model(dev, cfg)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (GEN_BATCH, GEN_PROMPT)), device=dev)
    max_len = GEN_PROMPT + GEN_STEPS
    flag = lambda: opt_flags.use_flags(mamba_bf16_scan=True)
    with flag():                   # warm-up off the counts
        _, c = api.prefill(params, prompts[:, :64], max_len=65)
        api.decode(params, prompts[:, :1], c)
    api.prefill(params, prompts[:, :64], max_len=65)
    del c
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    api.prefill(params, prompts, max_len=max_len)
    torch.cuda.synchronize()
    prefill32_s = time.perf_counter() - t1

    _reset_train_counts()
    with flag():
        t1 = time.perf_counter()
        logits, cache = api.prefill(params, prompts, max_len=max_len)
        tokens = [_greedy(logits)]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        step_s = []
        for _ in range(GEN_STEPS):
            t1 = time.perf_counter()
            logits, cache = api.decode(params, tokens[-1], cache)
            tokens.append(_greedy(logits))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
    gen_launches = _train_counts()
    out = torch.cat(tokens, dim=1)
    require(bool(torch.isfinite(logits).all()) and
            out.shape == (GEN_BATCH, GEN_STEPS + 1) and
            bool(((out >= 0) & (out < cfg.vocab)).all()),
            "ssm_bf16_main: non-finite logits or tokens outside the "
            "vocabulary")
    del cache, logits, params, api
    gc.collect()
    torch.cuda.empty_cache()

    mapi = build(cfg)
    oc = optim.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    step = step_lib.make_train_step(mapi, step_lib.RunConfig(
        microbatches=TRAIN_MICRO, adamw=oc))
    state = step_lib.init_train_state(
        mapi, torch.Generator(device=dev).manual_seed(0), oc, device=dev)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0))
    steps = []
    with flag():
        for i in range(1 + SSM_BF16_STEPS):
            batch, _ = _train_batch(pipe, i, dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            steps.append(dict(step=i, ms=1e3 * (time.perf_counter() - t1),
                              loss=float(m["loss"]),
                              grad_norm=float(m["grad_norm"])))
    launches = _train_counts()
    del state, batch, m, step, mapi
    gc.collect()
    torch.cuda.empty_cache()
    n_steps = 1 + SSM_BF16_STEPS
    per_layer = TRAIN_MICRO * cfg.n_layers * n_steps
    want = dict(gen_launches, mamba_scan_bf16=cfg.n_layers + 2 * per_layer,
                mamba_scan_bf16_bwd=per_layer)
    require(gen_launches["mamba_scan_bf16"] == cfg.n_layers and
            launches == want and launches["mamba_scan"] == 0 and
            launches["mamba_scan_bwd"] == 0,
            f"ssm_bf16_main: launches {launches} (generation "
            f"{gen_launches}), want {want}: the bf16 kernels one a layer in "
            f"the prefill, two forwards and a backward a layer a microbatch "
            f"a step, the fp32 scan never")
    losses = [s["loss"] for s in steps]
    require(all(np.isfinite(losses)) and abs(losses[0] - (
        math.log(cfg.vocab) + 0.5)) <= CE_FIRST_TOL,
        f"ssm_bf16_main: losses {losses}, the first not within "
        f"{CE_FIRST_TOL} of ln V + 1/2")
    timed = [s["ms"] for s in steps[1:]]
    cons = ssm_bf16_consistency(dev)
    return dict(
        phase="ssm_bf16_main", model=cfg.name, n_layers=cfg.n_layers,
        d_model=cfg.d_model, d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
        chunk=cfg.ssm_chunk, dtype=cfg.dtype,
        flags=dict(mamba_bf16_scan=True),
        reduced=f"layers 64 -> {SSM_BF16_LAYERS} (the script's time; "
                f"ssm_train_main's cut), {n_steps} training steps",
        weights="random, torch.Generator(cuda).manual_seed(0)",
        init_s=init_s, weight_bytes=weight_bytes, batch=GEN_BATCH,
        prompt_len=GEN_PROMPT, decode_steps=GEN_STEPS,
        prefill_ms=1e3 * prefill_s, prefill_ms_fp32_same_params=1e3
        * prefill32_s, decode_step_ms_p50=_pct(step_s, 50),
        decode_step_ms_p99=_pct(step_s, 99),
        beside=dict(ssm_main=ssm and dict(
                        n_layers=ssm["n_layers"],
                        prefill_ms=ssm["prefill_ms"],
                        decode_step_ms_p50=ssm["decode_step_ms_p50"]),
                    ssm_train_main=ssm_train and dict(
                        n_layers=ssm_train["n_layers"],
                        step_ms_p50=ssm_train["step_ms_p50"])),
        train=dict(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                   microbatches=TRAIN_MICRO, steps=steps,
                   step_ms_p50=statistics.median(timed), step_ms_timed=timed),
        first_tokens=out[0, :8].tolist(), generation_launches=gen_launches,
        launches=launches, consistency=cons,
        seconds=time.perf_counter() - t_phase), launches


# -- the sharded service and the online tuner on the day-scale stream ---------

# -- the sharded train step and the serving launcher -----------------------------

MESH_TRAIN = (("olmo-1b", 4), ("falcon-mamba-7b", 2))   # arch, layers kept
MESH_STEPS = 2
MESH_TOL = dict(loss=1e-5, param=1e-4,   # param: of the leaf's max |value|
                logit=1e-4)              # logit: of the max |logit|
MESH_DECODE = dict(batch=8, prompt=1024, max_len=1040)
MESH_A_LAYER = {"olmo-1b": dict(flash_attention=2, flash_attention_bwd=1),
                "falcon-mamba-7b": dict(mamba_scan=2, mamba_scan_bwd=1)}
SERVE_LAUNCH_ARGS = ["--arch", "olmo-1b", "--full-config", "--requests", "8",
                     "--shrink-to", "14", "--device", "cuda"]
BF16_NEAR_TIE = 0.0625      # serve_launch: 4 bf16 ulps at a logit of 2 to 4


def _mesh_decode(dev, mesh, arch: str, layers: int) -> tuple:
    """One decode step of ``arch`` at published width cut to ``layers``
    layers (bf16, random weights from seed 0) on a KV cache placed as a
    DTensor by the rules' ``cache_specs`` on ``mesh`` (its sequence on
    "model"), params and tokens placed as well, against the same step on
    plain tensors: ``MESH_DECODE``'s batch after a prompt of its length.
    The sharded decode runs ``paged_attention_lse`` on the local cache
    and merges by the lse over the "model" dim; the logits within
    ``MESH_TOL["logit"]`` of the max |logit|, and ``paged_attention``
    launched once a layer.  Returns (record, launches of the mesh
    step)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build
    from repro_torch.sharding import dtensor as dt
    from repro_torch.sharding import rules
    from repro_torch.training import step as step_lib

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    B, P = MESH_DECODE["batch"], MESH_DECODE["prompt"]
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, P + 1), generator=g,
                           device=dev, dtype=torch.int32)
    _, cache = api.prefill(params, tokens[:, :P],
                           max_len=MESH_DECODE["max_len"])
    decode = step_lib.make_decode_step(api)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, _ = decode(params, tokens[:, P:], cache)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    cspecs = rules.cache_specs(cfg, mesh, cache)
    dcache = rules.distribute(cache, mesh, cspecs)
    dparams = rules.distribute(params, mesh,
                               rules.param_specs(cfg, mesh, params))
    dtok = rules.distribute(tokens[:, P:], mesh, rules.batch_specs(
        cfg, mesh, {"tokens": ((B, 1), torch.int32)})["tokens"])
    _reset_train_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with dt.implicit():
        got, _ = decode(dparams, dtok, dcache)
    got = dt.plain(got)
    torch.cuda.synchronize()
    mesh_ms = 1e3 * (time.perf_counter() - t0)
    launches = _train_counts()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max()) or 1.0
    require(launches["paged_attention"] == layers and sum(
        launches.values()) == layers, f"mesh_train {arch} decode: "
        f"launches {launches}, want paged_attention {layers} and no other")
    require(err <= MESH_TOL["logit"] * scale, f"mesh_train {arch} decode: "
            f"logits {err} from the plain decode's (max |logit| {scale})")
    rec = dict(arch=arch, layers=layers, batch=B, prompt=P,
               max_len=MESH_DECODE["max_len"],
               cache_placements=[str(p) for p in dcache.k.placements],
               logit_max_abs_err=err, logit_max=scale,
               logit_limit_use=err / (MESH_TOL["logit"] * scale),
               mesh_ms=mesh_ms, plain_ms=plain_ms, launches=launches)
    del params, dparams, cache, dcache, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def _mesh_train_one(dev, mesh, arch: str, layers: int, ckpt_dir) -> tuple:
    """``arch`` at published width cut to ``layers`` layers (bf16, random
    weights from seed 0): ``MESH_STEPS`` steps of ``make_train_step``
    on plain tensors, then the same steps from the same seed on a state
    and batches placed as DTensors on ``mesh`` by the sharding rules
    (``training.step.state_specs``, ``rules.batch_specs``), 2
    microbatches of 4 x 4,096 tokens from ``TokenPipeline``.  Each loss
    within ``MESH_TOL["loss"]`` of the plain one, each param leaf within
    ``MESH_TOL["param"]`` of its max |value|, the kernels launched as
    ``train_run`` launches them; with ``ckpt_dir``, the mesh state saved
    and restored into a plain state, bit for bit.  Returns (record,
    launches of the mesh steps)."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.model import build
    from repro_torch.sharding import rules
    from repro_torch.training import optim, step as step_lib

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    api = build(cfg)
    oc = optim.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    step = step_lib.make_train_step(api, step_lib.RunConfig(
        microbatches=TRAIN_MICRO, adamw=oc))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0))
    batches = [_train_batch(pipe, i, dev)[0] for i in range(MESH_STEPS)]

    def fresh():
        return step_lib.init_train_state(
            api, torch.Generator(device=dev).manual_seed(0), oc, device=dev)

    def run(state, place):
        out, ms = [], []
        for b in batches:
            b = place(b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            out.append(float(m["loss"]))
        return state, out, ms

    plain, plain_loss, plain_ms = run(fresh(), lambda b: b)
    state = fresh()
    specs = step_lib.state_specs(cfg, mesh, state.params)
    state = rules.distribute(state, mesh, specs)
    bspecs = rules.batch_specs(cfg, mesh, {
        k: (tuple(v.shape), v.dtype) for k, v in batches[0].items()})
    _reset_train_counts()
    state, mesh_loss, mesh_ms = run(
        state, lambda b: rules.distribute(b, mesh, bspecs))
    launches = _train_counts()
    a_layer = MESH_A_LAYER[arch]
    want = {k: TRAIN_MICRO * layers * MESH_STEPS * a_layer.get(k, 0)
            for k in launches}
    loss_err = max(abs(a - b) for a, b in zip(mesh_loss, plain_loss))
    param_use = 0.0
    for (path, got), (_, ref) in zip(_leaf_paths(state.params),
                                     _leaf_paths(plain.params)):
        full = got.full_tensor().float()
        scale = float(ref.float().abs().max()) or 1.0
        param_use = max(param_use, float((full - ref.float()).abs().max())
                        / scale / MESH_TOL["param"])
    require(launches == want, f"mesh_train {arch}: launches {launches}, "
                              f"want {want} (train_run's rule)")
    require(loss_err <= MESH_TOL["loss"], f"mesh_train {arch}: losses "
            f"{mesh_loss} vs plain {plain_loss}")
    require(param_use <= 1.0, f"mesh_train {arch}: a param leaf is "
            f"{param_use} x its limit from the plain step's")
    ckpt = None
    if ckpt_dir is not None:
        mgr = CheckpointManager(ckpt_dir, keep=1)
        t0 = time.perf_counter()
        mgr.save(MESH_STEPS, state, blocking=True)
        back = mgr.restore(MESH_STEPS, plain, device=dev)
        diff = [p for (p, a), (_, b) in zip(_leaf_paths(back),
                                            _leaf_paths(state))
                if not torch.equal(a, b.full_tensor() if hasattr(
                    b, "full_tensor") else b)]
        require(not diff, f"mesh_train {arch}: restored leaves differ "
                          f"from the saved mesh state: {diff[:5]}")
        ckpt = dict(bit_equal=True, leaves=len(_leaf_paths(back)),
                    seconds=time.perf_counter() - t0)
        del back
    placed = {p: [str(x) for x in leaf.placements]
              for p, leaf in _leaf_paths(state.params)[:3]}
    del state, plain, batches
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=arch, layers=layers, n_params=cfg.n_params(),
                dtype=cfg.dtype, steps=MESH_STEPS, microbatches=TRAIN_MICRO,
                batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, mesh_loss=mesh_loss,
                plain_loss=plain_loss, loss_abs_err=loss_err,
                param_limit_use=param_use, step_ms=mesh_ms,
                plain_step_ms=plain_ms, launches=launches,
                placements_sample=placed, checkpoint=ckpt), launches


def mesh_train(dev):
    """The sharded train step on the card: a world-1 NCCL process group
    in this process (a ``HashStore``: no network), a (1, 1)
    ``make_host_mesh`` on ``cuda``, and ``_mesh_train_one`` for each of
    ``MESH_TRAIN``: olmo-1b at published width cut to 4 of 16 layers
    (with the checkpoint round trip) and falcon-mamba-7b cut to 2 of 64;
    then ``_mesh_decode`` on olmo-1b's cut.  The group is destroyed at
    the end, whatever happens."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    ckpt_dir = tempfile.mkdtemp(prefix="mesh_train_ckpt_")
    try:
        mesh = make_host_mesh(1, 1, device_type="cuda")
        runs, launches = [], {}
        for i, (arch, layers) in enumerate(MESH_TRAIN):
            rec, n = _mesh_train_one(dev, mesh, arch, layers,
                                     ckpt_dir if i == 0 else None)
            runs.append(rec)
            launches = {k: launches.get(k, 0) + v for k, v in n.items()}
        dec, n = _mesh_decode(dev, mesh, *MESH_TRAIN[0])
        launches = {k: launches.get(k, 0) + v for k, v in n.items()}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return dict(phase="mesh_train", mesh="1x1 (data, model) over NCCL",
                runs=runs, decode=dec, launches=launches,
                tolerance=MESH_TOL,
                seconds=time.perf_counter() - t0), launches


def serve_launch(dev):
    """``launch.serve.main`` as a user runs it: olmo-1b at its published
    size (bf16, random weights from seed 0), 8 requests, the pool
    live-shrunk from 28 to 14 blocks halfway, prefill through
    ``flash_attention`` and decode through ``paged_attention``.  Every
    completion is held to ``teacher_forced``: the prefill must pick the
    served token at every generated position, except where its top-2
    margin is under ``BF16_NEAR_TIE`` (the two paths round their bf16
    activations differently)."""
    from repro_torch.launch import serve
    from repro_torch.models.model import build

    t0 = time.perf_counter()
    _reset_train_counts()
    out = serve.main(SERVE_LAUNCH_ARGS)
    launches = _train_counts()
    api = build(out["cfg"])
    by_id = {c.req_id: c for c in out["completions"]}
    reqs = out["requests"]
    require(len(by_id) == len(reqs) and all(
        c.status == "completed" and len(c.tokens) > 0
        for c in by_id.values()), "serve_launch: a request did not complete")
    require(launches["flash_attention"] > 0
            and launches["paged_attention"] > 0,
            f"serve_launch: launches {launches}")
    margins = []
    compared, mismatches, ties = teacher_forced(
        api, out["params"], reqs, by_id, dev, near_tie=BF16_NEAR_TIE,
        margins=margins)
    require(not mismatches, f"serve_launch: served tokens != teacher-"
                            f"forced prefill tokens: {mismatches}")
    require(len(margins) == compared, f"serve_launch: {len(margins)} "
                                      f"margins for {compared} positions")
    stats = out["stats"]
    del out, api
    gc.collect()
    torch.cuda.empty_cache()
    return dict(phase="serve_launch", argv=SERVE_LAUNCH_ARGS,
                requests=len(reqs), positions_compared=compared,
                mismatches=0, near_ties=len(ties),
                near_tie_margin=BF16_NEAR_TIE,
                # how much of the check the exemption could swallow: the
                # compared positions whose top-2 margin is under it
                positions_under_margin=sum(m < BF16_NEAR_TIE
                                           for m in margins),
                margin_min=min(margins), margin_p10=float(
                    np.percentile(margins, 10)),
                pool=dataclasses.asdict(stats), launches=launches,
                seconds=time.perf_counter() - t0), launches


TRAIN_100M_STEPS = (8, 12)  # examples_main: 8 steps, then a rerun to 12


def run_script(path: str, argv, **kw):
    """``main(argv, **kw)`` of the script at ``path`` (in the checkout),
    its standard output captured: (its return value, the text)."""
    import contextlib
    import io

    name = "script_" + pathlib.Path(path).stem
    mod = _load_module(os.path.join(ROOT, path), name)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv, **kw)
    return out, buf.getvalue()


def incident_check(snap_json: str, failovers, phase: str) -> dict:
    """``tools/obsreport_torch.py --incidents`` on a chaos pool's
    snapshot, every retained incident shown: the timeline must name each
    failover's shard loss and, by its kind, its promotion or its
    rewarm."""
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json", prefix="obs-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(snap_json)
        n_events = len(json.loads(snap_json)["events"])
        rc, text = run_script("tools/obsreport_torch.py",
                              [path, "--incidents", "--events",
                               str(n_events)])
    finally:
        os.unlink(path)
    require(rc == 0 and failovers, f"examples_main: obsreport_torch on "
                                   f"{phase} (rc {rc}, {failovers})")
    lines = text.splitlines()
    want = []
    for f in failovers:
        sid = f["shard"]
        want += [f"shard {sid} LOST", f"shard {sid} PROMOTED from standby"
                 if f["kind"] == "promote" else f"shard {sid} rewarmed"]
    shown = [next((ln.strip() for ln in lines if w in ln), None)
             for w in want]
    require(all(shown), f"examples_main: {phase}'s incident timeline lacks "
                        f"{[w for w, s in zip(want, shown) if not s]}")
    return dict(timeline_lines=len(lines), header=lines[0], shown=shown)


def examples_main(dev, incidents: dict):
    """The port's example scripts and ``tools/obsreport_torch.py`` as a
    user runs them, each on the card by default (their ``main(argv)``):
    ``cache_explorer --engine-check`` at its defaults (w01-skewed's
    metadata trace, four policies at 1, 5 and 10 %), Clock2Q+ replayed
    through ``cache_sim`` and held to the zoo; ``serve_paged`` (reduced
    granite-3-8b, 28 blocks shrunk to 14), every completion held to
    ``teacher_forced``; ``quickstart --smoke`` (reduced olmo-1b, three
    steps, a checkpoint restored with its digests verified);
    ``train_100m`` at its published size (124M-class, fp32, seq 128,
    batch 4), 8 steps into a temporary checkpoint directory and a rerun
    to 12 that must resume at step 8; and the incident timelines of the
    chaos pools (``incidents``: phase -> (snapshot JSON, failovers)).
    Each example's kernels must have launched."""
    import shutil
    import tempfile
    from repro_torch.kernels.cache_sim import ops as cops

    t0 = time.perf_counter()
    rec, launches = dict(phase="examples_main"), {}

    # cache_explorer: the zoo's table, the engine's replay on the card
    t1 = time.perf_counter()
    cops.launch_count = 0
    out, text = run_script("examples/torch/cache_explorer.py",
                           ["--engine-check"])
    launches["cache_explorer"] = dict(cache_sim=cops.launch_count)
    mrs = [v for _, _, row in out["rows"] for v in row.values()]
    require(len(out["rows"]) == 3 and len(mrs) == 12 and all(
        0.0 <= v <= 1.0 for v in mrs), f"cache_explorer: rows {out['rows']}")
    require(out["check"] == "MATCH" and text.rstrip().endswith("MATCH"),
            f"cache_explorer: engine cross-check {out['check']}")
    require(cops.launch_count > 0, "cache_explorer: cache_sim never launched")
    rec["cache_explorer"] = dict(
        argv=["--engine-check"], requests=len(out["trace"]),
        table=text.splitlines()[1:5], check=text.splitlines()[-1],
        seconds=time.perf_counter() - t1)

    # serve_paged: both phases, every token against a teacher-forced prefill
    t1 = time.perf_counter()
    _reset_train_counts()
    out, text = run_script("examples/torch/serve_paged.py", [])
    n = _train_counts()
    launches["serve_paged"] = {k: n[k] for k in ("flash_attention",
                                                 "paged_attention")}
    done = out["phase1"] + out["phase2"]
    by_id = {c.req_id: c for c in done}
    reqs = out["requests"]
    require(len(out["phase1"]) == len(out["phase2"]) == 4 and len(by_id) == 8
            and all(c.status == "completed" and len(c.tokens) == 8
                    for c in done), "serve_paged: a request did not complete")
    require(out["capacity2"] == 14, f"serve_paged: phase 2 ran on "
                                    f"{out['capacity2']} blocks, not 14")
    require(n["flash_attention"] > 0 and n["paged_attention"] > 0,
            f"serve_paged: launches {n}")
    compared, mismatches, ties = teacher_forced(out["api"], out["params"],
                                                reqs, by_id, dev)
    require(not mismatches, f"serve_paged: served tokens != teacher-forced "
                            f"prefill tokens: {mismatches}")
    rec["serve_paged"] = dict(
        completed=len(by_id), phase2_blocks=out["capacity2"],
        pool1=dataclasses.asdict(out["stats1"]),
        pool2=dataclasses.asdict(out["stats2"]), flows2=out["flows2"],
        positions_compared=compared, mismatches=0, near_ties=ties,
        near_tie_margin=NEAR_TIE, seconds=time.perf_counter() - t1)
    del out, done, by_id

    # quickstart --smoke: three steps on the flash kernels, a restore
    t1 = time.perf_counter()
    _reset_train_counts()
    out, text = run_script("examples/torch/quickstart.py", ["--smoke"])
    n = _train_counts()
    shutil.rmtree(out["ckpt_dir"], ignore_errors=True)
    launches["quickstart"] = {k: n[k] for k in ("flash_attention",
                                                "flash_attention_bwd")}
    require(len(out["losses"]) == 3 and all(
        math.isfinite(x) for x in out["losses"]),
        f"quickstart: losses {out['losses']}")
    require("restore+verify OK" in text, "quickstart: no restore+verify OK")
    require(n["flash_attention"] > 0 and n["flash_attention_bwd"] > 0,
            f"quickstart: launches {n}")
    rec["quickstart"] = dict(argv=["--smoke"], losses=out["losses"],
                             restore_verify=True,
                             seconds=time.perf_counter() - t1)
    del out

    # train_100m: 8 steps at its published size, then a resumed rerun
    t1 = time.perf_counter()
    ckpt = tempfile.mkdtemp(prefix="train-100m-")
    try:
        _reset_train_counts()
        first, _ = run_script("examples/torch/train_100m.py", [
            "--steps", str(TRAIN_100M_STEPS[0]), "--ckpt", ckpt])
        again, text = run_script("examples/torch/train_100m.py", [
            "--steps", str(TRAIN_100M_STEPS[1]), "--ckpt", ckpt])
        n = _train_counts()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    launches["train_100m"] = {k: n[k] for k in ("flash_attention",
                                                "flash_attention_bwd")}
    losses = first["losses"] + again["losses"]
    require(first["start"] == 0 and len(losses) == TRAIN_100M_STEPS[1]
            and all(math.isfinite(x) for x in losses),
            f"train_100m: start {first['start']}, losses {losses}")
    require(again["start"] == TRAIN_100M_STEPS[0] and
            f"resumed at step {TRAIN_100M_STEPS[0]}" in text,
            f"train_100m: the rerun started at {again['start']}")
    require(n["flash_attention"] > 0 and n["flash_attention_bwd"] > 0,
            f"train_100m: launches {n}")
    step_ms = [1e3 * s for s in first["step_s"]]
    p50 = statistics.median(step_ms[1:])   # the first step warms up
    rec["train_100m"] = dict(
        steps=TRAIN_100M_STEPS, seq=128, batch=4,
        tokens_per_step=first["tokens_per_step"], losses=losses,
        step_ms=step_ms, resumed_step_ms=[1e3 * s for s in again["step_s"]],
        step_ms_p50_after_first=p50,
        tokens_per_s=first["tokens_per_step"] / (p50 / 1e3),
        checkpoints=again["checkpoints"], seconds=time.perf_counter() - t1)
    del first, again
    gc.collect()
    torch.cuda.empty_cache()

    # obsreport_torch --incidents on the chaos pools' snapshots
    t1 = time.perf_counter()
    rec["obsreport_torch"] = {
        phase: incident_check(snap, fos, phase)
        for phase, (snap, fos) in incidents.items()}
    rec["obsreport_torch"]["seconds"] = time.perf_counter() - t1

    total = {}
    for per in launches.values():
        for k, v in per.items():
            total[k] = total.get(k, 0) + v
    rec.update(launches=total, launches_by_script=launches,
               seconds=time.perf_counter() - t0)
    return rec, total


SHARD_COUNTS = (2, 4, 8)    # benchmarks/shard.py::SHARD_COUNTS
THREADS = (1, 2, 4, 8)      # benchmarks/shard.py::THREADS
ORACLE_PREFIX = 1 << 18     # shard_path: requests held against the host service
TUNER_PREFIX = 1 << 20      # tuner_path: requests under the online tuner
SERVE_BATCH = 65_536        # tuner_path: requests an access_many batch
TUNER_CHECKED = 4           # tuner_path: rounds held against the plain sweep


def shard_path(dev, d, u, cap, long_mr, single):
    """The hash-sharded Clock2Q+ service on the card: ``sharded_replay``
    of the whole stream ``d`` (dense ids below ``u``) at 2, 4 and 8
    shards, one ``cache_sim`` launch each, and ``replay_store`` of the
    stream from an oracleGeneral file, one launch a chunk.  Checks, at
    tolerance 0: each shard count's merged hits equal one one-lane replay
    a shard; at 8 shards the first ``ORACLE_PREFIX`` requests equal the
    host ``ShardedClock2QPlus`` (an independent oracle at a capacity that
    8 divides); the streamed hits equal the single-shot ``single``, with
    one ``EV_SNAPSHOT`` row a chunk.  Returns (phase line, launches)."""
    import tempfile

    from repro_torch.core import torch_engine as te
    from repro_torch.core.engine import replay
    from repro_torch.kernels.cache_sim import ops
    from repro_torch.obs import ObsSink
    from repro_torch.shardcache import (
        ShardedClock2QPlus, replay_threaded, shard_of_np,
    )
    from repro_torch.traceio import TraceStore, save_trace

    cap8 = cap - cap % 8
    phase_t0 = time.perf_counter()
    timer = LaunchTimes(ops)
    ops.launch_count = 0
    timer.start()
    merged, wall = {}, {}
    for n in SHARD_COUNTS:
        timer.kind = n
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merged[n] = te.sharded_replay("clock2q+", d, cap8, n, universe=u,
                                      device=dev)
        wall[n] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.bin")
        t0 = time.perf_counter()
        save_trace(path, d)
        write_s = time.perf_counter() - t0
        sink = ObsSink(src="replay")
        timer.kind = "replay_store"
        t0 = time.perf_counter()
        store_hits, _ = te.replay_store("clock2q+", TraceStore(path), cap,
                                        chunk_size=LONG_CHUNK, obs=sink,
                                        device=dev)
        store_s = time.perf_counter() - t0
    timer.stop()
    launches = ops.launch_count
    by_kind = timer.by_kind()
    require(launches == len(SHARD_COUNTS) + -(-len(d) // LONG_CHUNK),
            f"shard_path: {launches} cache_sim launches")
    rows = [e for e in sink.snapshot().events if e["kind"] == "snapshot"]
    require(store_hits == single and len(rows) == -(-len(d) // LONG_CHUNK)
            and (rows[-1]["a"], rows[-1]["b"]) == (len(d), single),
            f"replay_store: {store_hits} hits, {len(rows)} snapshot rows; "
            f"single shot {single}")

    per_n = []
    for n in SHARD_COUNTS:
        sid = shard_of_np(d, n)
        sizes = np.bincount(sid, minlength=n)
        for s in range(n):
            ix = np.nonzero(sid == s)[0]
            _, h = replay("clock2q+", te.init_state(
                "clock2q+", cap8 // n, u, device=dev), d[ix])
            bad = int((h[0].cpu().numpy() != merged[n][ix]).sum())
            require(bad == 0, f"{n} shards: shard {s}'s lane differs from "
                              f"its one-lane replay in {bad} requests")
        mr = 1.0 - float(merged[n].mean())
        per_n.append(dict(
            n_shards=n, shard_capacity=cap8 // n, miss_ratio=mr,
            gap_pp=100.0 * (mr - long_mr),
            kernel_ms=by_kind[n]["ms"], wall_s=wall[n],
            requests_per_s=len(d) / wall[n], longest_lane=int(sizes.max()),
            shortest_lane=int(sizes.min()), per_shard_equal=True))

    prefix = d[:ORACLE_PREFIX]
    lanes = te.sharded_replay("clock2q+", prefix, cap8, 8, universe=u,
                              device=dev)
    t0 = time.perf_counter()
    host = ShardedClock2QPlus(cap8, n_shards=8).access_many(prefix)
    host_s = time.perf_counter() - t0
    bad = int((lanes != host).sum())
    require(bad == 0, f"8 lanes != the host ShardedClock2QPlus on the "
                      f"prefix ({bad} requests differ)")
    threaded = []
    for t in THREADS:
        rep = replay_threaded(ShardedClock2QPlus(cap8, n_shards=8), prefix,
                              n_threads=t)
        require(rep.n_requests == len(prefix)
                and (rep.hits == int(host.sum()) if t == 1 else
                     abs(rep.miss_ratio - (1.0 - host.mean())) < 0.01),
                f"replay_threaded at {t} threads: {rep}")
        threaded.append(dict(threads=t, requests_per_s=rep.throughput,
                             miss_ratio=rep.miss_ratio, seconds=rep.seconds))
    return dict(
        phase="shard_path", trace="w01-skewed/meta", requests=len(d),
        unique=u, capacity=cap8, unsharded_miss_ratio=long_mr,
        tolerance=0, launches=launches, shards=per_n,
        oracle=dict(requests=len(prefix), n_shards=8, equal=True,
                    host_s=host_s, host_requests_per_s=len(prefix) / host_s),
        threaded=threaded,
        replay_store=dict(chunk=LONG_CHUNK, launches=by_kind[
            "replay_store"]["launches"], kernel_ms=by_kind["replay_store"][
            "ms"], seconds=store_s, write_s=write_s, snapshot_rows=len(rows),
            equal=True),
        seconds=time.perf_counter() - phase_t0), launches


def tuner_path(dev, d, u, cap, single_h):
    """The online tuner and ``EngineCache`` on the card.  ``OnlineTuner``
    with its defaults over the host ``ShardedClock2QPlus`` (8 shards) on
    the first ``TUNER_PREFIX`` requests of ``d``, fed by ``observe_many``
    after each ``SERVE_BATCH`` batch: every profiling round one
    ``cache_sim`` launch, the first ``TUNER_CHECKED`` rounds' estimates
    equal to the same ``sweep_grid`` call on the CPU (the plain version).
    Then ``EngineCache`` of clock2q+ and s3fifo serves the whole stream in
    batches, each equal to one single-shot replay (``single_h`` for
    clock2q+).  Returns (phase line, launches by kernel)."""
    from repro_torch.core import torch_engine as te
    from repro_torch.core.engine import replay
    from repro_torch.core.engine.host import EngineCache
    from repro_torch.kernels.cache_sim import ops
    from repro_torch.kernels.s3fifo_sim import ops as s3ops
    from repro_torch.shardcache import ShardedClock2QPlus
    from repro_torch.tuning import OnlineTuner

    cap8 = cap - cap % 8
    prefix = d[:TUNER_PREFIX]
    batches = [prefix[i:i + SERVE_BATCH]
               for i in range(0, len(prefix), SERVE_BATCH)]
    phase_t0 = time.perf_counter()
    ops.launch_count = s3ops.launch_count = 0
    svc = ShardedClock2QPlus(cap8, n_shards=8)
    tuner = OnlineTuner(svc, device=dev)
    timers = dict(cache_sim=LaunchTimes(ops), s3fifo_sim=LaunchTimes(s3ops))
    timers["cache_sim"].kind = "round"
    timers["cache_sim"].start()
    t0 = time.perf_counter()
    for b in batches:
        svc.access_many(b)
        tuner.observe_many(b)
    tuned_s = time.perf_counter() - t0
    timers["cache_sim"].stop()
    round_ms = timers["cache_sim"].by_kind()["round"]["ms"]
    rounds = list(tuner.decisions)
    round_launches = ops.launch_count
    served = {}
    for policy, timer in zip(("clock2q+", "s3fifo"), timers.values()):
        cache = EngineCache(policy, cap, u, device=dev)
        timer.kind = policy
        timer.start()
        hits, ms = [], []
        for i in range(0, len(d), SERVE_BATCH):
            t0 = time.perf_counter()
            hits.append(cache.access_many(d[i:i + SERVE_BATCH]))
            ms.append(1e3 * (time.perf_counter() - t0))
        timer.stop()
        served[policy] = (np.concatenate(hits), ms,
                          timer.by_kind()[policy]["ms"])
    launches = dict(cache_sim=ops.launch_count,
                    s3fifo_sim=s3ops.launch_count)
    n_batches = -(-len(d) // SERVE_BATCH)
    require(round_launches == len(rounds) > TUNER_CHECKED
            and launches == dict(cache_sim=len(rounds) + n_batches,
                                 s3fifo_sim=n_batches),
            f"tuner_path: {len(rounds)} rounds, launches {launches}")

    tuner_checks(tuner, prefix, "tuner_path", rounds[:TUNER_CHECKED])
    plain_svc = ShardedClock2QPlus(cap8, n_shards=8)
    for b in batches:
        plain_svc.access_many(b)

    engine = {}
    for policy, (hits, ms, kernel_ms) in served.items():
        if policy == "clock2q+":
            want = single_h
        else:
            _, h = replay(policy, te.init_state(policy, cap, u, device=dev),
                          d)
            want = h[0].cpu().numpy()
        bad = int((hits != want).sum())
        require(bad == 0, f"EngineCache({policy}) differs from its "
                          f"single-shot replay in {bad} requests")
        engine[policy] = dict(
            batches=len(ms), miss_ratio=1.0 - float(hits.mean()),
            ms_per_batch_mean=statistics.fmean(ms),
            ms_per_batch_p50=statistics.median(ms),
            kernel_ms_per_batch=kernel_ms / len(ms), equal=True)
    return dict(
        phase="tuner_path", trace="w01-skewed/meta", capacity=cap8,
        tuner=dict(
            requests=len(prefix), n_shards=8, batch=SERVE_BATCH,
            retune_every=tuner.retune_every, rate_shift=tuner.rate_shift,
            rounds=len(rounds), launches=round_launches,
            kernel_ms_per_round=round_ms / len(rounds),
            rounds_checked=TUNER_CHECKED, tolerance=0,
            applied=sum(bool(r.applied) for r in rounds),
            chosen_windows=[r.chosen.window_frac for r in rounds],
            rate_shifts=sorted({r.rate_shift for r in rounds}),
            n_sampled=[r.n_sampled for r in rounds],
            miss_ratio=svc.misses / len(prefix),
            miss_ratio_without_tuner=plain_svc.misses / len(prefix),
            window_frac=svc.tuning["window_frac"], seconds=tuned_s),
        engine_cache=dict(requests=len(d), capacity=cap, batch=SERVE_BATCH,
                          **engine),
        launches=launches, seconds=time.perf_counter() - phase_t0), launches


def main() -> int:
    """Run every phase (or, with ``--previous``, only ``attn_previous``,
    ``scan_previous``, ``cache_sim_previous`` and ``policy_previous``);
    returns the exit code."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--previous", metavar="DIR",
                    help="only time the kernels of the checkout DIR "
                         "(an earlier commit) beside the present ones")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import torch_engine as te
    from repro_torch.core import traces
    from repro_torch.core.engine import (
        get_engine, grid_hit_arrays, grid_init, replay, replay_chunked,
    )
    from repro_torch.core.policies.clock2qplus import Clock2QPlus
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.cache_sim import build, ops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.cache_sim.ref import cache_sim_plain
    from repro_torch.kernels.s3fifo_sim import build as s3build
    from repro_torch.kernels.simple_sim import build as smbuild
    from repro_torch.tuning.sweep import make_grid, relabel, sweep_hits

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.previous:
        kdir = _kernel_dir(args.previous)
        prev_bwd = pathlib.Path(kdir, "mamba_scan", "csrc",
                                "mamba_scan_bwd.cu")
        kbuild.build_many(
            [("cache_sim", build.SOURCE), ("mamba_scan", sops.SOURCE),
             ("mamba_scan_bwd", sops.BWD_SOURCE),
             ("s3fifo_sim", s3build.SOURCE), ("simple_sim", smbuild.SOURCE)]
            + [(k, pathlib.Path(kdir, k, "csrc", f"{k}.cu")) for k in (
                "cache_sim", "mamba_scan", "flash_attention",
                "paged_attention", "s3fifo_sim", "simple_sim")]
            + ([("mamba_scan_bwd", prev_bwd)] if prev_bwd.exists() else [])
            + [("mamba_scan_bf16", p) for p in (
                sops.BF16_SOURCE, prev_bwd.with_name("mamba_scan_bf16.cu"))
               if p.exists()])
        emit(attn_previous(dev, args.previous))
        emit(scan_previous(dev, args.previous))
        named = {name: tr for name, tr in suite_traces(traces)
                 if name in PREVIOUS_SWEEPS + PREVIOUS_REPLAYS
                 + POLICY_PREVIOUS}
        emit(cache_sim_previous(dev, args.previous, named))
        emit(policy_previous(dev, args.previous, named))
        print(smi, flush=True)
        return 0

    # -- device: the card, the toolchain, the kernel builds --------------------
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    # inference builds no graph; the training phases' steps turn grad on
    torch.set_grad_enabled(False)
    t0 = time.perf_counter()
    kbuild.build_many([("cache_sim", build.SOURCE),
                       ("flash_attention", fops.SOURCE),
                       ("flash_attention_bwd", fops.BWD_SOURCE),
                       ("paged_attention", pops.SOURCE),
                       ("mamba_scan", sops.SOURCE),
                       ("mamba_scan_bwd", sops.BWD_SOURCE),
                       ("mamba_scan_bf16", sops.BF16_SOURCE),
                       ("s3fifo_sim", s3build.SOURCE),
                       ("simple_sim", smbuild.SOURCE)])
    build_s = time.perf_counter() - t0
    build.load()
    emit(dict(phase="device", device=kind, count=torch.cuda.device_count(),
              nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
              build_s=build_s, builds={
                  k: kbuild.info(k) for k in
                  ("cache_sim", "flash_attention", "flash_attention_bwd",
                   "paged_attention", "mamba_scan", "mamba_scan_bwd",
                   "mamba_scan_bf16", "s3fifo_sim", "simple_sim")}))

    t0 = time.perf_counter()
    all_traces = suite_traces(traces)
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
    timer = LaunchTimes(ops)
    timer.start()
    for name, tr in all_traces:
        fp = traces.footprint(tr)
        grid = make_grid([max(8, int(fp * f)) for f in SWEEP_FRACS],
                         SWEEP_WINDOWS)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        timer.kind = "sweep_hits"
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
        timer.kind = "grid_hit_arrays"
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
        timer.kind = "replay"
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
        timer.kind = "replay_chunked"
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
    timer.stop()
    by_kind = timer.by_kind()
    require(launches > 0, "the main path launched no cache_sim kernel")
    require(sum(k["launches"] for k in by_kind.values()) == launches,
            f"timed launches {by_kind} != {launches}")
    emit(dict(phase="main_path", launches=launches,
              kernel_ms_by_kind=by_kind,
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

    # -- shard_path, tuner_path: the same stream, sharded and tuned ------------
    shard, shard_launches = shard_path(dev, d, u, cap,
                                       1.0 - single / len(d), single)
    emit(shard)
    tuned, tuner_launches = tuner_path(dev, d, u, cap, h[0].cpu().numpy())
    emit(tuned)

    # -- kernel_time: the timed sweeps, median of 3, with their bounds ---------
    sweeps = {}
    for name in TIMED_SWEEPS:
        sweeps[name] = sweep_time(dev, name, named[name])
        emit(sweeps[name])
    kt, kt_meta = sweeps["w01-skewed"], sweeps["w01-skewed/meta"]
    emit(tier_time(dev, named))
    emit(policy_tier_time(dev, named))

    # -- the policy-comparison path: S3-FIFO, FIFO, Clock, LRU on the card -----
    evp = engines_vs_plain(dev, named)
    emit(evp)
    cmp, cmp_times = compare_path(dev, all_traces)
    emit(cmp)

    # -- the serving path: kernels, full model, consistency, kernel times ------
    check = attn_kernels_vs_plain(dev)
    emit(check)
    serve, serve_launches, med_lengths, served = serve_main(dev)
    emit(serve)
    chaos, chaos_launches, chaos_snap = chaos_path(dev, served)
    emit(chaos)
    del served
    torch.cuda.empty_cache()
    emit(serve_consistency(dev))
    consistency, rewarm_snap = chaos_consistency(dev)
    emit(consistency)
    incidents = dict(chaos_path=(chaos_snap, chaos["failovers"]),
                     chaos_rewarm=(rewarm_snap,
                                   consistency["rewarm"]["failovers"]))
    timing = attn_kernel_time(dev, med_lengths)
    emit(timing)
    pt, ft, fh = timing["paged"], timing["flash"], timing["flash_hybrid"]

    # -- the SSM and hybrid paths: scan kernel, both models, consistency -------
    scan_check = mamba_scan_vs_plain(dev)
    emit(scan_check)
    ssm = generate_main(dev, "falcon-mamba-7b", "ssm_main",
                        layers=SSM_LAYERS)
    ssm_launches = ssm["launches"]
    want = dict(mamba_scan=ssm["n_layers"], flash_attention=0,
                paged_attention=0)
    require(ssm_launches == want, f"ssm_main: launches {ssm_launches}, want "
                                  f"{want} (one per layer, one prefill)")
    emit(ssm)
    emit(generate_consistency(dev, "falcon-mamba-7b", "ssm_consistency"))
    hyb_check = hybrid_attn_vs_plain(dev)
    emit(hyb_check)
    hyb = generate_main(dev, "zamba2-2.7b", "hybrid_main",
                        layers=HYBRID_LAYERS)
    hyb_launches = hyb["launches"]
    want = dict(mamba_scan=0, flash_attention=hyb["shared_invocations"],
                paged_attention=GEN_STEPS * hyb["shared_invocations"])
    require(hyb_launches == want, f"hybrid_main: launches {hyb_launches}, "
                                  f"want {want} (one per shared-block "
                                  f"invocation, one prefill and each "
                                  f"decode step)")
    emit(hyb)
    emit(generate_consistency(dev, "zamba2-2.7b", "hybrid_consistency"))
    st = mamba_scan_time(dev)
    emit(st)

    # -- the moe and vlm families: olmoe, kimi-k2 (hd 112), llava ---------------
    moe, moe_launches = moe_main(dev)
    emit(moe)
    emit(moe_consistency(dev))
    wide, wide_launches = moe_wide(dev)
    emit(wide)
    vlm, vlm_launches = vlm_main(dev)
    emit(vlm)
    emit(vlm_consistency(dev))

    # -- the contiguous-cache decode and the encoder-decoder -------------------------
    dense = generate_main(dev, "granite-3-8b", "dense_generate",
                          layers=DENSE_LAYERS)
    want = dict(mamba_scan=0, flash_attention=dense["n_layers"],
                paged_attention=GEN_STEPS * dense["n_layers"])
    require(dense["launches"] == want,
            f"dense_generate: launches {dense['launches']}, want {want} (one "
            f"a layer, one prefill and each decode step)")
    emit(dense)
    emit(generate_consistency(dev, "granite-3-8b", "dense_consistency",
                              buffered=BUF_RING))
    enc, enc_launches = encdec_main(dev)
    emit(enc)
    emit(encdec_consistency(dev))
    # -- training: the flash backward kernel, olmo-1b, consistency ------------------
    gc.collect()
    torch.cuda.empty_cache()
    bwd_check = flash_bwd_vs_plain(dev)
    emit(bwd_check)
    bt = flash_bwd_time(dev)
    emit(bt)
    train, train_launches = train_main(dev)
    emit(train)
    emit(train_consistency(dev))
    emit(train_bf16_grad(dev))
    emit(train_resume(dev))
    # -- training the ssm: the scan backward kernel, falcon-mamba ------------
    gc.collect()
    torch.cuda.empty_cache()
    scan_bwd = scan_bwd_vs_plain(dev)
    emit(scan_bwd)
    sbt = scan_bwd_time(dev)
    emit(sbt)
    ssm_train, ssm_train_launches = ssm_train_main(dev)
    emit(ssm_train)
    emit(ssm_bf16_grad(dev))
    # -- the mamba_bf16_scan path: the bf16 kernels ---------------------------
    gc.collect()
    torch.cuda.empty_cache()
    sbf = scan_bf16_vs_plain(dev)
    emit(sbf)
    ssm_bf16, ssm_bf16_launches = ssm_bf16_main(dev, ssm, ssm_train)
    emit(ssm_bf16)
    # -- the sharded train step and the serving launcher ------------------------
    gc.collect()
    torch.cuda.empty_cache()
    meshed, mesh_launches = mesh_train(dev)
    emit(meshed)
    launched, launch_launches = serve_launch(dev)
    emit(launched)
    # -- the example scripts and the tools, as a user runs them ---------------
    gc.collect()
    torch.cuda.empty_cache()
    examples, example_launches = examples_main(dev, incidents)
    emit(examples)

    family_launches = dict(moe_main=moe_launches, moe_wide=wide_launches,
                           vlm_main=vlm_launches,
                           dense_generate=dense["launches"],
                           encdec_main=enc_launches,
                           train_main=train_launches,
                           ssm_train_main=ssm_train_launches,
                           mesh_train=mesh_launches,
                           serve_launch=launch_launches,
                           examples_main=example_launches)
    by_family = {k: {p: n[k] for p, n in family_launches.items()}
                 for k in ("flash_attention", "paged_attention")}

    emit({"kernels": [dict(
        name="cache_sim", route="cuda",
        source="src/repro_torch/kernels/cache_sim/csrc/cache_sim.cu",
        replaces="src/repro/kernels/cache_sim/cache_sim.py:46",
        launches=launches + cmp["launches"]["cache_sim"] + shard_launches
        + tuner_launches["cache_sim"] + chaos_launches["cache_sim"]
        + example_launches["cache_sim"],
        launches_by_path=dict(main_path=launches,
                              compare_path=cmp["launches"]["cache_sim"],
                              shard_path=shard_launches,
                              tuner_path=tuner_launches["cache_sim"],
                              chaos_path=chaos_launches["cache_sim"],
                              examples_main=example_launches["cache_sim"]),
        max_abs_err=max_abs_err, ms=kt["ms"],
        plain_ms=plain_ms, bound_ms=kt["bound_ms"], bound_by=kt["bound_by"],
        library_ms=None,
        ms_shape=f"w01-skewed sweep: {kt['lanes']} lanes x "
                 f"{kt['requests']} requests",
        plain_shape=f"{len(configs)} lanes x {PREFIX} requests",
        kernel_ms_at_plain_shape=prefix_ms, ns_per_step=kt["ns_per_step"],
        at_meta_sweep={k: kt_meta[k] for k in (
            "trace", "lanes", "requests", "ms", "ns_per_step", "bound_ms",
            "bound_by")}),
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/kernels/paged_attention/csrc/"
                    "paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/paged_attention.py:30",
             launches=serve_launches["paged_attention"]
             + chaos_launches["paged_attention"]
             + hyb_launches["paged_attention"]
             + sum(by_family["paged_attention"].values()),
             launches_by_path=dict(
                 serve_main=serve_launches["paged_attention"],
                 chaos_path=chaos_launches["paged_attention"],
                 hybrid_main=hyb_launches["paged_attention"],
                 **by_family["paged_attention"]),
             max_abs_err=check["max_abs_err"]["paged"],
             max_abs_err_hd112=check["max_abs_err_hd112"]["paged"],
             max_abs_err_one_page=check["max_abs_err_new_shapes"][
                 "paged_one_page"],
             ms=pt["ms"],
             plain_ms=check["paged_plain_ms"], bound_ms=pt["bound_ms"],
             bound_by=pt["bound_by"], library_ms=pt["library_ms"],
             ms_shape=pt["shape"],
             plain_shape=check["plain_shapes"]["paged"],
             kernel_ms_at_plain_shape=check["paged_kernel_ms"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/flash_attention.py:25",
             launches=serve_launches["flash_attention"]
             + chaos_launches["flash_attention"]
             + hyb_launches["flash_attention"]
             + sum(by_family["flash_attention"].values()),
             launches_by_path=dict(
                 serve_main=serve_launches["flash_attention"],
                 chaos_path=chaos_launches["flash_attention"],
                 hybrid_main=hyb_launches["flash_attention"],
                 **by_family["flash_attention"]),
             max_abs_err=max(check["max_abs_err"]["flash"],
                             hyb_check["max_abs_err"]),
             max_abs_err_by_path=dict(
                 serve_main=check["max_abs_err"]["flash"],
                 hybrid_main=hyb_check["max_abs_err"]),
             max_abs_err_hd112=check["max_abs_err_hd112"]["flash"],
             max_abs_err_whisper=check["max_abs_err_new_shapes"][
                 "flash_whisper"],
             ms=ft["ms"], ms_with_lse=bt["fwd"]["ms_with_lse"],
             ms_without_lse=bt["fwd"]["ms"],
             plain_ms=check["flash_plain_ms"], bound_ms=ft["bound_ms"],
             bound_by=ft["bound_by"], library_ms=ft["library_ms"],
             ms_shape=ft["shape"],
             at_hybrid_shape={k: fh[k] for k in (
                 "shape", "ms", "bound_ms", "bound_by", "library_ms")},
             plain_shape=check["plain_shapes"]["flash"],
             kernel_ms_at_plain_shape=check["flash_kernel_ms"]),
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention_bwd.cu",
             replaces="no Pallas kernel: XLA's autodiff of "
                      "src/repro/models/layers.py:128 attention",
             launches=train_launches["flash_attention_bwd"]
             + mesh_launches["flash_attention_bwd"]
             + example_launches["flash_attention_bwd"],
             launches_by_path=dict(
                 train_main=train_launches["flash_attention_bwd"],
                 mesh_train=mesh_launches["flash_attention_bwd"],
                 examples_main=example_launches["flash_attention_bwd"]),
             max_abs_err=bwd_check["max_abs_err"],
             max_limit_use=bwd_check["max_limit_use"],
             max_fp32_limit_use=bwd_check["max_fp32_limit_use"],
             routes={str(t): fops.BWD_ROUTES[t] for t in fops.BWD_ROUTES},
             max_lse_abs_err=bwd_check["max_lse_abs_err"],
             min_fault_limit_use=bwd_check["min_fault_limit_use"],
             ms=bt["bwd"]["ms"], plain_ms=bt["bwd"]["plain_ms"],
             bound_ms=bt["bwd"]["bound_ms"], bound_by=bt["bwd"]["bound_by"],
             library_ms=bt["bwd"]["library_ms"], ms_shape=bt["bwd"]["shape"],
             plain_shape=bt["bwd"]["shape"],
             ptxas=kbuild.info("flash_attention_bwd").get("ptxas")),
        dict(name="mamba_scan", route="cuda",
             source="src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
             replaces="src/repro/kernels/mamba_scan/mamba_scan.py:23",
             launches=ssm_launches["mamba_scan"]
             + ssm_train_launches["mamba_scan"]
             + mesh_launches["mamba_scan"],
             launches_by_path=dict(
                 ssm_main=ssm_launches["mamba_scan"],
                 ssm_train_main=ssm_train_launches["mamba_scan"],
                 mesh_train=mesh_launches["mamba_scan"]),
             max_abs_err=scan_check["max_abs_err"],
             max_states_abs_err=scan_bwd["max_states_err"],
             ms_with_states=sbt["fwd"]["ms_with_states"],
             ms_without_states=sbt["fwd"]["ms"],
             ms_states_shape=sbt["fwd"]["shape"], ms=st["ms"],
             plain_ms=scan_check["plain_ms"], bound_ms=st["bound_ms"],
             bound_by=st["bound_by"], library_ms=None, ms_shape=st["shape"],
             plain_shape=scan_check["plain_shape"],
             kernel_ms_at_plain_shape=scan_check[
                 "kernel_ms_at_plain_shape"]),
        dict(name="mamba_scan_bwd", route="cuda",
             source="src/repro_torch/kernels/mamba_scan/csrc/"
                    "mamba_scan_bwd.cu",
             replaces="no Pallas kernel: XLA's autodiff of "
                      "src/repro/models/mamba.py:128-144 (the chunked "
                      "associative scan)",
             launches=ssm_train_launches["mamba_scan_bwd"]
             + mesh_launches["mamba_scan_bwd"],
             launches_by_path=dict(
                 ssm_train_main=ssm_train_launches["mamba_scan_bwd"],
                 mesh_train=mesh_launches["mamba_scan_bwd"]),
             max_abs_err=scan_bwd["max_abs_err"],
             max_limit_use=scan_bwd["max_limit_use"],
             min_fault_limit_use=scan_bwd["min_fault_limit_use"],
             ms=sbt["bwd"]["ms"], plain_ms=sbt["bwd"]["plain_ms"],
             bound_ms=sbt["bwd"]["bound_ms"], bound_by=sbt["bwd"]["bound_by"],
             library_ms=None, ms_shape=sbt["bwd"]["shape"],
             plain_shape=sbt["bwd"]["shape"], plan=sbt["bwd"]["plan"],
             ptxas=kbuild.info("mamba_scan_bwd").get("ptxas")),
        dict(name="mamba_scan_bf16", route="cuda",
             source="src/repro_torch/kernels/mamba_scan/csrc/"
                    "mamba_scan_bf16.cu",
             replaces="no Pallas kernel: XLA's bf16 associative scan of "
                      "src/repro/models/mamba.py:128-142 chunk under "
                      "mamba_bf16_scan",
             launches=ssm_bf16_launches["mamba_scan_bf16"],
             launches_by_path=dict(
                 ssm_bf16_main=ssm_bf16_launches["mamba_scan_bf16"]),
             max_abs_err=sbf["max_rel_err"],
             max_abs_err_is="max |err| / max |plain| over y and h_last",
             max_unequal_share=sbf["max_unequal_share"],
             max_limit_use=sbf["max_limit_use"],
             min_fault_limit_use=sbf["min_fault_limit_use"],
             ms=sbf["fwd"]["ms"], fp32_scan_ms=sbf["fwd"]["fp32_ms"],
             plain_ms=sbf["fwd"]["plain_ms"], bound_ms=sbf["fwd"]["bound_ms"],
             bound_by=sbf["fwd"]["bound_by"], library_ms=None,
             ms_shape=sbf["fwd"]["shape"], plain_shape=sbf["fwd"]["shape"],
             ptxas=sbf["fwd"]["ptxas"]),
        dict(name="mamba_scan_bf16_bwd", route="cuda",
             source="src/repro_torch/kernels/mamba_scan/csrc/"
                    "mamba_scan_bwd.cu (kBf16)",
             replaces="no Pallas kernel: XLA's autodiff of the bf16 "
                      "associative scan of src/repro/models/mamba.py:128-142 "
                      "under mamba_bf16_scan",
             launches=ssm_bf16_launches["mamba_scan_bf16_bwd"],
             launches_by_path=dict(
                 ssm_bf16_main=ssm_bf16_launches["mamba_scan_bf16_bwd"]),
             max_abs_err=sbf["bwd_max_abs_err"],
             max_limit_use=sbf["bwd_max_limit_use"],
             ms=sbf["bwd"]["ms"], fp32_bwd_ms=sbf["bwd"]["fp32_ms"],
             plain_ms=sbf["bwd"]["plain_ms"], bound_ms=sbf["bwd"]["bound_ms"],
             bound_by=sbf["bwd"]["bound_by"], library_ms=None,
             ms_shape=sbf["bwd"]["shape"], plain_shape=sbf["bwd"]["shape"],
             ptxas=sbf["bwd"]["ptxas"]),
        policy_kernel_row("s3fifo_sim", cmp_times, cmp, evp, ("s3fifo",),
                          "w01-skewed/meta", all_traces,
                          tuner_path=tuner_launches["s3fifo_sim"]),
        policy_kernel_row("simple_sim", cmp_times, cmp, evp,
                          ("fifo", "clock", "lru"), "w01-skewed/meta",
                          all_traces)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
