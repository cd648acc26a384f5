"""The port's import boundary: ``repro_torch`` and ``chip_smoke.py``
import nothing of JAX and nothing of the ``repro`` package, not even a
module there that does not import JAX.  The port keeps its own copies,
held here to the reference's values."""

import ast
import dataclasses
import itertools
import pathlib
import subprocess
import sys

import pytest

from repro.core.engine import layout as jlayout
from repro_torch.core.engine import layout as playout

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _imports(path: pathlib.Path):
    """Every module an ``import`` anywhere in ``path`` names."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("repro", "jax", "jaxlib")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_repro_or_jax_import_in_the_source(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert bad == [], f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys, pkgutil, importlib\n"
        f"sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]\n"
        "import repro_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert int(out.stdout.strip()) >= 15  # every module was imported


def test_layout_constants_equal_reference():
    for name in ("EMPTY", "W_NONE", "W_SMALL", "W_MAIN", "W_GHOST"):
        assert getattr(playout, name) == getattr(jlayout, name), name
    assert [f.name for f in dataclasses.fields(playout.SweepConfig)] == \
        [f.name for f in dataclasses.fields(jlayout.SweepConfig)]
    assert dataclasses.asdict(playout.SweepConfig(77)) == \
        dataclasses.asdict(jlayout.SweepConfig(77))


def test_segment_sizes_equal_reference():
    caps = [1, 2, 3, 7, 8, 10, 19, 64, 100, 1000, 4093, 100_003]
    fracs = [0.0, 0.05, 0.1, 0.25, 0.5, 1.0, 10.0]
    for c, sf, gf, wf in itertools.product(caps, fracs[1:], fracs[1:],
                                           fracs):
        assert playout.c2qp_sizes(c, sf, gf, wf) == \
            jlayout.c2qp_sizes(c, sf, gf, wf), (c, sf, gf, wf)
    for c, sf, gf in itertools.product(caps, fracs, fracs):
        assert playout.sq_sizes(c, sf, gf) == jlayout.sq_sizes(c, sf, gf)
        assert playout.seg(c, sf) == jlayout.seg(c, sf)
