#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main path on one CUDA card: block-key traces through
the Clock2Q+ state machine, as batched MRC sweeps over the SUITE traces
and as chunked replays, all through the hand-written ``cache_sim`` Hopper
kernel.  The kernel is built from ``src/repro_torch/kernels/cache_sim/
csrc/cache_sim.cu`` at first use and held, with tolerance 0, against its
plain PyTorch version and the pure-Python Clock2Q+ oracle.

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


def cuda_ms(fn, reps: int = 1) -> list:
    """CUDA-event times of ``reps`` calls of ``fn`` (ms each)."""
    out = []
    for _ in range(reps):
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
    from repro_torch.kernels.cache_sim import build, ops
    from repro_torch.kernels.cache_sim.ref import cache_sim_plain
    from repro_torch.tuning.sweep import make_grid, relabel, sweep_hits

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    # -- device: the card, the toolchain, the kernel build ---------------------
    build.load()
    emit(dict(phase="device", device=kind, count=torch.cuda.device_count(),
              nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
              build_s=build.build_info["seconds"],
              built_now=build.build_info["built_now"],
              ptxas=build.build_info["ptxas"]))

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

    emit({"kernels": [dict(
        name="cache_sim", route="cuda",
        source="src/repro_torch/kernels/cache_sim/csrc/cache_sim.cu",
        replaces="src/repro/kernels/cache_sim/cache_sim.py:46",
        launches=launches, max_abs_err=max_abs_err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,
        ms_shape=f"w01-skewed sweep: {L} lanes x {T} requests",
        plain_shape=f"{len(configs)} lanes x {PREFIX} requests",
        kernel_ms_at_plain_shape=prefix_ms, ns_per_step=1e6 * ms / T)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
