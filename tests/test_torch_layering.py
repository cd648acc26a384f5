"""The port's import-layering contract (tools/check_layering_torch.py)
as a test: the kernels at the bottom, ``serving`` at the top, ``obs``
sealed, ``faults`` restricted, no module-level import pointing upward."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import check_layering_torch as cl  # noqa: E402


def test_no_upward_module_level_imports():
    violations = cl.check(REPO / "src")
    assert violations == [], "\n".join(violations)


def test_main_prints_layering_ok():
    out = subprocess.run([sys.executable, "tools/check_layering_torch.py"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "layering OK"


@pytest.mark.parametrize("module,layer", [
    ("repro_torch.kernels", -1),
    ("repro_torch.kernels.cache_sim.ops", -1),
    ("repro_torch.kernels.flash_attention.ref", -1),
    ("repro_torch.core.engine.layout", 0),
    ("repro_torch.obs.metrics", 0),
    ("repro_torch.core.torch_engine", 1),
    ("repro_torch.traceio.store", 2),
    ("repro_torch.faults.plan", 2),
    ("repro_torch.tuning.sweep", 3),
    ("repro_torch.kvcache.pool", 3),
    ("repro_torch.shardcache", 3),
    ("repro_torch.serving.engine", 4),
    ("repro_torch.models.model", None),
    ("repro_torch.launch.train", None),
    # the reference's modules have no row in the port's table
    ("repro.core.engine", None),
    ("repro_torchx.core", None),
])
def test_layer_of_longest_prefix_wins(module, layer):
    assert cl.layer_of(module) == layer


def test_the_kernels_row_is_the_one_that_differs():
    """The reference's table with ``repro.`` read as ``repro_torch.``,
    but for the kernels' row: layer 3 there, the lowest layer here."""
    ref = {}
    tree = ast.parse((REPO / "tools" / "check_layering.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                node.targets[0].id in ("LAYERS", "SEALED", "RESTRICTED"):
            ref[node.targets[0].id] = ast.literal_eval(node.value)
    port = lambda p: "repro_torch" + p[len("repro"):]
    want = {port(k): v for k, v in ref["LAYERS"].items()}
    assert want.pop("repro_torch.kernels") == 3
    got = dict(cl.LAYERS)
    assert got.pop("repro_torch.kernels") == min(cl.LAYERS.values()) == -1
    assert got == want
    assert cl.SEALED == {port(p) for p in ref["SEALED"]}
    assert cl.RESTRICTED == {port(k): tuple(port(p) for p in v)
                             for k, v in ref["RESTRICTED"].items()}


def test_faults_layer_and_restriction():
    assert cl._restricted_prefix("repro_torch.faults.io") == \
        "repro_torch.faults"
    assert cl._restricted_prefix("repro_torch.traceio") is None
    allowed = cl.RESTRICTED["repro_torch.faults"]
    assert cl._in_allowed("repro_torch.core.prodcache", allowed)
    assert cl._in_allowed("repro_torch.obs.events", allowed)
    assert not cl._in_allowed("repro_torch.traceio.stream", allowed)
    assert not cl._in_allowed("repro_torch.kvcache.pool", allowed)
    assert not cl._in_allowed("repro_torch.kernels.cache_sim", allowed)


def test_obs_is_sealed():
    assert cl._sealed_prefix("repro_torch.obs.events") == "repro_torch.obs"
    assert cl._sealed_prefix("repro_torch.core.engine") is None
    for path in sorted((REPO / "src" / "repro_torch" / "obs").glob("*.py")):
        tree = ast.parse(path.read_text())
        for _, imported in cl.module_level_imports(tree):
            assert not re.match(r"repro_torch\.(?!obs)", imported + "."), \
                f"{path} imports {imported}"


def _tree(tmp_path, files: dict):
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    for d in {p.parent for p in tmp_path.rglob("*.py")}:
        (d / "__init__.py").touch()
    return tmp_path


@pytest.mark.parametrize("rel,text,rule", [
    # a kernel reaching up into the policy core at module level
    ("repro_torch/kernels/x/ref.py",
     "from repro_torch.core.engine.clock2qplus import step\n", "layer -1"),
    # the engine reaching up into the tuner
    ("repro_torch/core/engine/bad.py", "import repro_torch.tuning.sweep\n",
     "layer 0"),
    # obs importing the engine: sideways, but obs is sealed
    ("repro_torch/obs/bad.py", "import repro_torch.core.engine\n",
     "sealed"),
    # faults importing traceio: sideways, but faults is restricted
    ("repro_torch/faults/bad.py", "from repro_torch.traceio import store\n",
     "restricted"),
    # serving is the top: nothing may import it
    ("repro_torch/kvcache/bad.py", "import repro_torch.serving.engine\n",
     "layer 3"),
])
def test_planted_violation_is_reported(tmp_path, rel, text, rule):
    src = _tree(tmp_path, {rel: text})
    violations = cl.check(src)
    assert len(violations) == 1 and rule in violations[0], violations
    assert violations[0].startswith(str(src / rel) + ":1:")


def test_lazy_and_downward_imports_pass(tmp_path):
    src = _tree(tmp_path, {
        # the port's own edge: the engine drives the replay kernels
        "repro_torch/core/engine/__init__.py":
            "from repro_torch.kernels.cache_sim import ops\n",
        # a plain version imports the engine's step inside the call
        "repro_torch/kernels/x/ref.py":
            "def plain():\n    from repro_torch.core.engine import s\n",
        "repro_torch/faults/ok.py": "import repro_torch.core.prodcache\n",
        "repro_torch/serving/ok.py": "import repro_torch.kvcache.pool\n",
        "repro_torch/models/any.py": "import repro_torch.serving.engine\n",
    })
    assert cl.check(src) == []


def test_main_exits_nonzero_on_a_violation(tmp_path, monkeypatch, capsys):
    src = _tree(tmp_path / "src", {
        "repro_torch/kernels/bad.py": "import repro_torch.kvcache.pool\n"})
    monkeypatch.setattr(cl, "__file__", str(tmp_path / "tools" / "x.py"))
    assert cl.main() == 1
    out = capsys.readouterr().out
    assert "1 layering violation(s)" in out and str(src) in out
