"""Roofline report over the dry-run's records.

The port of ``repro.launch.roofline``.  Reads the port's dry-run records
(``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json``), computes
MODEL_FLOPS (6·N·T for training, N the active params for MoE; 2·N_active
per prefilled or generated token for serving), the three roofline terms
at the H100's spec-sheet rates (``launch/cost.py``), the useful-compute
ratio and the dominant bottleneck per cell, and the whole sweep's tables
(``sweep_summary``: both meshes and variants); writes
``experiments/roofline_torch.md``.

    PYTHONPATH=src python -m repro_torch.launch.roofline
"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.launch.cost import HBM_BW, LINK_BW, LINKS, PEAK_FLOPS
from repro_torch.models.config import shape_by_name

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments"


def model_flops(arch: str, shape: str) -> float:
    cfg = get_config(arch)
    cell = shape_by_name(shape)
    n_act = cfg.n_active_params()
    if cell.kind == "train":
        return 6.0 * n_act * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_act * cell.global_batch * cell.seq_len
    return 2.0 * n_act * cell.global_batch  # decode: one token per seq


def mitigation(rec: dict) -> str:
    """The next move the record's dominant term and top byte category
    point at (the port's op names: aten ops, not HLO fusions)."""
    dom = rec["roofline"]["dominant"]
    cats = rec.get("byte_categories", {})
    top = max(cats, key=cats.get) if cats else ""
    if dom == "memory":
        if top in ("_to_copy", "copy_", "where", "index_put_"):
            if rec["kind"] == "decode":
                return ("paged cache writes avoid the full-shard "
                        "select/copy a sharded cache write costs")
            return ("the flash kernel / fused mixed precision removes "
                    "materialised fp32 score tensors")
        if top in ("transpose", "clone", "cat"):
            return "store KV pre-transposed in the attention's layout"
        if top in ("mm", "bmm", "addmm"):
            return "already matmul-dominated: raise arithmetic intensity"
        return "fuse the dominant op chain (see byte_categories)"
    if dom == "collective":
        return "overlap collectives with compute; reshard to cut volume"
    return "compute-bound: good; tune tile shapes for the tensor cores"


def load_records(variant: str = "dryrun_torch"):
    recs = {}
    for mesh_dir in sorted((OUT_DIR / variant).glob("*x*")):
        for f in sorted(mesh_dir.glob("*.json")):
            rec = json.loads(f.read_text())
            arch, shape = f.stem.split("__")
            rec.setdefault("arch", arch)
            rec.setdefault("shape", shape)
            recs[(mesh_dir.name, arch, shape)] = rec
    return recs


def _frac(rec, arch, shape):
    mf = model_flops(arch, shape) / rec["n_chips"]
    return (mf / PEAK_FLOPS) / max(rec["roofline"]["bound_s"], 1e-12)


MESHES = ("16x16", "2x16x16")   # the dry-run's production meshes
VARIANTS = {"base": "dryrun_torch", "opt": "dryrun_torch_opt"}


def _cell(rec, arch, shape) -> str:
    """One traced cell: flop, HBM bytes and collective wire bytes a
    device, the dominant term and its bound, the useful share (model
    flops a device over the counted flop) and, for training, argument
    plus peak live bytes a device (GB)."""
    r = rec["roofline"]
    mf = model_flops(arch, shape) / rec["n_chips"]
    out = (f"{rec['cost_flops']:.2e} / {rec['cost_bytes_accessed']:.2e} / "
           f"{rec['collective_wire_bytes']:.2e}; {r['dominant'][:4]} "
           f"{r['bound_s']:.4g} s; u {mf / rec['cost_flops']:.3f}")
    if rec["kind"] == "train":
        ma = rec["memory_analysis"]
        peak = ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
        out += f"; {peak / 1e9:.1f} GB"
    return out


def sweep_summary() -> str:
    """The whole sweep in two tables: the records' status counts for
    each mesh and variant, then every cell (arch x shape) in each mesh
    and variant: ``_cell`` where it traced, the status otherwise, "=
    base" where the opt variant counted the same as the base; the SKIP
    rows by reason."""
    recs = {v: load_records(d) for v, d in VARIANTS.items()}
    lines = ["| mesh | variant | OK | SKIP | FAIL | cells |",
             "|---|---|---|---|---|---|"]
    for v in VARIANTS:
        for m in MESHES:
            st = [r.get("status") for (mm, _, _), r in recs[v].items()
                  if mm == m]
            lines.append(f"| {m} | {v} | {st.count('OK')} | "
                         f"{st.count('SKIP')} | "
                         f"{len(st) - st.count('OK') - st.count('SKIP')} | "
                         f"{len(st)} |")
    cols = [(m, v) for m in MESHES for v in VARIANTS]
    lines += ["", "| arch | shape | " + " | ".join(
        f"{m} {v}" for m, v in cols) + " |",
        "|---|---|" + "---|" * len(cols)]
    cells = sorted({(a, s) for v in VARIANTS for (_, a, s) in recs[v]})
    skips = {}
    for a, s in cells:
        row = [recs[v].get((m, a, s), {}) for m, v in cols]
        if all(r.get("status") == "SKIP" for r in row):
            skips.setdefault(row[0]["reason"], []).append(f"{a} x {s}")
            continue
        text = []
        for (m, v), r in zip(cols, row):
            base = recs["base"].get((m, a, s), {})
            if r.get("status") != "OK":
                text.append(r.get("status", "missing"))
            elif v != "base" and base.get("status") == "OK" and all(
                    r[k] == base[k] for k in ("cost_flops",
                                              "cost_bytes_accessed",
                                              "collective_wire_bytes")):
                text.append("= base")
            else:
                text.append(_cell(r, a, s))
        lines.append(f"| {a} | {s} | " + " | ".join(text) + " |")
    for reason, names in skips.items():
        lines.append(f"\nSKIP in every mesh and variant ({reason}): "
                     + ", ".join(names) + ".")
    return "\n".join(lines) + "\n"


def build_report() -> str:
    recs = load_records()
    lines = [f"# Roofline analysis (per device; NVIDIA H100 80GB HBM3, "
             f"700.00 W spec sheet, not measured: "
             f"{PEAK_FLOPS / 1e12:.0f} TF/s dense bf16, "
             f"{HBM_BW / 1e12:.2f} TB/s HBM3, {LINKS}x"
             f"{LINK_BW / 1e9:.0f} GB/s NVLink)", ""]
    for mesh in sorted({m for m, _, _ in recs}):
        lines.append(f"\n## Mesh {mesh}\n")
        lines.append("| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) "
                     "| dominant | MODEL_FLOPS/dev | useful/counted | "
                     "roofline frac | peak live (GB) | top byte category | "
                     "next move |")
        lines.append("|---|---|---|---|---|---|---|---|---|---|---|---|")
        for (m, arch, shape), rec in sorted(recs.items()):
            if m != mesh:
                continue
            if rec.get("status") == "SKIP":
                lines.append(f"| {arch} | {shape} | — | — | — | SKIP | — | "
                             f"— | — | — | — | {rec['reason'][:60]} |")
                continue
            if rec.get("status") != "OK":
                lines.append(f"| {arch} | {shape} | — | — | — | FAIL | — | "
                             f"— | — | — | — | "
                             f"{rec.get('error', '')[:60]} |")
                continue
            r = rec["roofline"]
            mf = model_flops(arch, shape) / rec["n_chips"]
            ratio = mf / max(rec["cost_flops"], 1.0)
            cats = rec.get("byte_categories", {})
            top = max(cats, key=cats.get) if cats else "-"
            topv = cats.get(top, 0.0)
            peak = rec["memory_analysis"]["temp_size_in_bytes"] + \
                rec["memory_analysis"]["argument_size_in_bytes"]
            lines.append(
                f"| {arch} | {shape} | {r['t_compute_s']:.4f} | "
                f"{r['t_memory_s']:.4f} | {r['t_collective_s']:.5f} | "
                f"{r['dominant']} | {mf:.3e} | {ratio:.2f} | "
                f"{_frac(rec, arch, shape) * 100:.1f}% | {peak / 1e9:.1f} | "
                f"{top} ({topv / 1e9:.0f} GB) | {mitigation(rec)} |")
    singles = {k: v for k, v in recs.items()
               if k[0] == "16x16" and v.get("status") == "OK"}
    if singles:
        worst = min(singles, key=lambda k: _frac(singles[k], k[1], k[2]))
        coll = max(singles,
                   key=lambda k: singles[k]["roofline"]["t_collective_s"]
                   / max(singles[k]["roofline"]["bound_s"], 1e-12))
        lines.append("\n## Hillclimb candidates (single-pod)\n")
        lines.append(f"* worst roofline fraction: {worst[1]} x {worst[2]} "
                     f"({_frac(singles[worst], worst[1], worst[2]) * 100:.2f}%)")
        lines.append(f"* most collective-bound: {coll[1]} x {coll[2]}")
    lines.append("\n## The sweep (flop / HBM bytes / wire bytes a device; "
                 "dominant term, bound; useful share; train: argument + "
                 "peak live bytes, beside one H100's 80 GB)\n")
    lines.append(sweep_summary())
    opt = load_records("dryrun_torch_opt")
    if opt:
        lines.append("\n## Optimized variant (--variant opt) vs baseline\n")
        lines.append("| mesh | arch | shape | bound base (s) | bound opt "
                     "(s) | speedup |")
        lines.append("|---|---|---|---|---|---|")
        for key, rec in sorted(opt.items()):
            if rec.get("status") != "OK" or key not in recs:
                continue
            b = recs[key]
            if b.get("status") != "OK":
                continue
            b0 = b["roofline"]["bound_s"]
            b1 = rec["roofline"]["bound_s"]
            lines.append(f"| {key[0]} | {key[1]} | {key[2]} | {b0:.4f} | "
                         f"{b1:.4f} | {b0 / max(b1, 1e-12):.2f}x |")
    return "\n".join(lines) + "\n"


def main():
    report = build_report()
    out = OUT_DIR / "roofline_torch.md"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(report)
    print(report[:4000])
    print(f"... written to {out}")


if __name__ == "__main__":
    main()
