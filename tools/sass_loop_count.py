#!/usr/bin/env python3
"""Count the SASS instructions of a kernel's hottest loop.

    python3 tools/sass_loop_count.py LIBRARY.so NAME [--op MUFU.EX2]

Runs ``cuobjdump -sass`` on a built kernel library (``build/repro_torch/``),
takes the first function whose mangled name contains NAME, finds its loops
(a branch to an earlier address), and prints, for the innermost loop that
holds an ``--op`` instruction (the shortest), its instruction count, the
count of each opcode, and the instructions per ``--op`` (for the scan, per
exponential: one state-step of one thread).  Needs the CUDA toolkit's
``cuobjdump``.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess

LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"([^;]*);")


def functions(sass: str):
    """{mangled name: [(address, opcode, operands)]} of a cuobjdump -sass
    listing."""
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = LINE.search(ln)
        if m and name:
            out[name].append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def hottest_loop(code, op: str):
    """(start, end, instructions) of the shortest loop that holds an
    ``op``."""
    best = None
    for addr, opcode, args in code:
        m = re.search(r"0x([0-9a-f]+)", args)
        if opcode != "BRA" or not m or int(m.group(1), 16) >= addr:
            continue
        lo = int(m.group(1), 16)
        body = [c for c in code if lo <= c[0] <= addr]
        if any(c[1] == op for c in body) and (
                best is None or len(body) < len(best[2])):
            best = (lo, addr, body)
    if best is None:
        raise SystemExit(f"no loop holds {op}")
    return best


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("library")
    ap.add_argument("name")
    ap.add_argument("--op", default="MUFU.EX2")
    args = ap.parse_args()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", args.library], capture_output=True,
                          text=True, check=True).stdout
    code = functions(sass)
    fn = next(k for k in code if args.name in k)
    lo, hi, body = hottest_loop(code[fn], args.op)
    ops = collections.Counter(c[1] for c in body)
    n_op = ops.get(args.op, 0)
    print(json.dumps(dict(function=fn, loop=[hex(lo), hex(hi)],
                          instructions=len(body), op=args.op, op_count=n_op,
                          per_op=len(body) / n_op if n_op else None,
                          opcodes=dict(ops.most_common()))))


if __name__ == "__main__":
    main()
