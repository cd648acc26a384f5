#!/usr/bin/env python3
"""Seconds each phase of ``chip_smoke.py`` takes, for comparing checkouts.

    python3 tools/phase_seconds.py OUT.json DIR [DIR ...]

Runs ``python3 chip_smoke.py`` from each checkout DIR in turn, on the
card, stamping each line of its standard output with the seconds since
that run began.  A phase's seconds run from the line before its JSON
line to that line (the first phase's include the kernels' build).
Writes ``[{"dir", "rc", "seconds", "phases": [[name, seconds], ...]},
...]`` to OUT.json, and each run's output to ``OUT.json.<i>.out`` and
``.err``.  Give a checkout twice (``A B B A``) to see how far two runs
of one tree differ on the same machine.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def run(tree: str, out_path: str) -> dict:
    """One ``chip_smoke.py`` run from ``tree``: its exit code, seconds
    and (name, seconds) of each JSON line with a ``phase`` key, then the
    ``kernels`` line."""
    phases = []
    t0 = last = time.perf_counter()
    with open(out_path + ".out", "w") as out, \
            open(out_path + ".err", "w") as err:
        proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=tree,
                                stdout=subprocess.PIPE, stderr=err,
                                text=True)
        for line in proc.stdout:
            now = time.perf_counter()
            out.write(line)
            try:
                obj = json.loads(line)
            except ValueError:
                obj = None
            if isinstance(obj, dict) and ("phase" in obj or "kernels" in obj):
                phases.append([obj.get("phase", "kernels"), now - last])
                last = now
        rc = proc.wait()
    return dict(dir=tree, rc=rc, seconds=time.perf_counter() - t0,
                phases=phases)


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out, trees = argv[0], argv[1:]
    runs = []
    for i, tree in enumerate(trees):
        runs.append(run(tree, f"{out}.{i}"))
        print(json.dumps(dict(runs[-1], phases=len(runs[-1]["phases"]))),
              flush=True)
        with open(out, "w") as f:
            json.dump(runs, f, indent=1)
    return max(r["rc"] for r in runs)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
