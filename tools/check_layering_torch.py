#!/usr/bin/env python
"""Import-layering checker of the port: the dependency direction of
``src/repro_torch``.

The port's statement of ``tools/check_layering.py``'s contract, with its
sealed (``obs``) and restricted (``faults``) rules over
``repro_torch.*``.  One row differs: the reference's ``repro.kernels``
sits at layer 3, beside the pool that calls it, while the port's
``repro_torch.kernels`` is the lowest layer, because the port's policy
core (``core.engine``) drives the replay kernels (``cache_sim``,
``s3fifo_sim``, ``simple_sim``) itself.  The edge runs both ways: the
engine imports the kernels' ops at module level, and those kernels'
plain versions (``kernels/*/ref.py``) replay the engine's step, which
they import inside the call; the table states the first edge, the lazy
import the second.  Enforced order (lower number =
lower layer; module-level imports may only point DOWNWARD or sideways,
never upward):

   -1  repro_torch.kernels   the hand-written kernels, their wrappers and
                             plain versions (a plain version replays the
                             engine's step, imported inside the call)
    0  repro_torch.core.engine   the capacity-masked policy core
    0  repro_torch.obs       metrics/event telemetry (SEALED: imports
                             no other layered package, not even layer 0)
    1  repro_torch.core      reference zoo, prod cache, replay drivers
    2  repro_torch.traceio   trace storage/streaming
    2  repro_torch.faults    fault injection & recovery, journal and
                             hot-standby replication (RESTRICTED: it
                             may import ONLY repro_torch.core and
                             repro_torch.obs)
    3  repro_torch.tuning, repro_torch.shardcache, repro_torch.kvcache
    4  repro_torch.serving

Only MODULE-LEVEL imports count: a function-level (lazy) import is the
explicit escape hatch for same-layer or upward references on cold paths,
and is exempt.  Packages not listed (models, checkpoint, training,
sharding, launch, ...) are outside the cache subsystem and unconstrained.

Run from the repo root:  python tools/check_layering_torch.py
Exits non-zero listing every violation.  Also run by
tests/test_torch_layering.py.
"""

from __future__ import annotations

import ast
import pathlib
import sys

# longest prefix wins: repro_torch.core.engine is layer 0, the rest of
# repro_torch.core layer 1
LAYERS = {
    "repro_torch.kernels": -1,
    "repro_torch.core.engine": 0,
    "repro_torch.obs": 0,
    "repro_torch.core": 1,
    "repro_torch.traceio": 2,
    "repro_torch.faults": 2,
    "repro_torch.tuning": 3,
    "repro_torch.shardcache": 3,
    "repro_torch.kvcache": 3,
    "repro_torch.serving": 4,
}

# sealed packages may not import ANY other layered package, sideways
# included: obs is instrumented BY every layer
SEALED = {"repro_torch.obs"}

# restricted packages have an explicit allow-list of layered packages
# they may import (tighter than the downward rule): faults stays a leaf
# over the policy core
RESTRICTED = {
    "repro_torch.faults": ("repro_torch.core", "repro_torch.obs",
                           "repro_torch.faults"),
}


def _sealed_prefix(module: str) -> str | None:
    for prefix in SEALED:
        if module == prefix or module.startswith(prefix + "."):
            return prefix
    return None


def _restricted_prefix(module: str) -> str | None:
    for prefix in RESTRICTED:
        if module == prefix or module.startswith(prefix + "."):
            return prefix
    return None


def _in_allowed(imported: str, allowed: tuple) -> bool:
    return any(imported == p or imported.startswith(p + ".")
               for p in allowed)


def layer_of(module: str) -> int | None:
    best = None
    for prefix, layer in LAYERS.items():
        if module == prefix or module.startswith(prefix + "."):
            if best is None or len(prefix) > len(best[0]):
                best = (prefix, layer)
    return None if best is None else best[1]


def module_name(path: pathlib.Path, src: pathlib.Path) -> str:
    rel = path.relative_to(src).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def module_level_imports(tree: ast.Module):
    """(lineno, imported-module) for imports at module scope only —
    anything nested in a function/method body is a lazy import and
    exempt.  Class-body imports count as module level (they run at
    import time)."""
    out = []

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                out.extend((child.lineno, a.name) for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                if child.level == 0 and child.module:
                    out.append((child.lineno, child.module))
            else:
                walk(child)

    walk(tree)
    return out


def check(src: pathlib.Path):
    violations = []
    for path in sorted(src.rglob("*.py")):
        mod = module_name(path, src)
        mod_layer = layer_of(mod)
        if mod_layer is None:
            continue
        tree = ast.parse(path.read_text(), filename=str(path))
        sealed = _sealed_prefix(mod)
        restricted = _restricted_prefix(mod)
        for lineno, imported in module_level_imports(tree):
            imp_layer = layer_of(imported)
            if imp_layer is None:
                continue
            if sealed and _sealed_prefix(imported) != sealed:
                violations.append(
                    f"{path}:{lineno}: {mod} (sealed) imports layered "
                    f"package {imported}")
            elif restricted and not _in_allowed(imported,
                                                RESTRICTED[restricted]):
                violations.append(
                    f"{path}:{lineno}: {mod} (restricted) imports "
                    f"{imported} — allowed: "
                    f"{', '.join(RESTRICTED[restricted])}")
            elif imp_layer > mod_layer:
                violations.append(
                    f"{path}:{lineno}: {mod} (layer {mod_layer}) imports "
                    f"{imported} (layer {imp_layer}) at module level")
    return violations


def main() -> int:
    src = pathlib.Path(__file__).resolve().parent.parent / "src"
    # module names are taken relative to src/; the reference's modules
    # there have no row in this table and are skipped
    violations = check(src)
    for v in violations:
        print(v)
    if violations:
        print(f"\n{len(violations)} layering violation(s)")
        return 1
    print("layering OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
