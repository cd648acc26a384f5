"""The kernel build's bookkeeping, on the CPU (no ``nvcc`` runs here).

``build_many`` starts one compiler a missing library.  Two entries that
name the same library, as an earlier checkout's unchanged source beside
the present one does under ``chip_smoke.py --previous``, must start one:
two compilers writing one temporary file raced, and the second rename
failed.
"""

import pathlib

from repro_torch.kernels import build


class _FakeNvcc:
    """Stands in for ``subprocess.Popen`` of ``nvcc``: writes its ``-o``
    file when waited on."""

    started = []

    def __init__(self, args, **kw):
        self.out = pathlib.Path(args[args.index("-o") + 1])
        self.returncode = 0
        _FakeNvcc.started.append(self.out)

    def communicate(self):
        self.out.write_bytes(b"lib")
        return "ptxas info    : Used 8 registers", None


def test_one_compiler_a_library(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    other = tmp_path / "prev" / "k.cu"
    other.parent.mkdir()
    other.write_text("// a kernel\n")          # an unchanged earlier copy
    changed = tmp_path / "prev2" / "k.cu"
    changed.parent.mkdir()
    changed.write_text("// another kernel\n")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", _FakeNvcc)
    _FakeNvcc.started = []
    build.build_many([("k", src), ("k", other), ("k", changed)])
    assert len(_FakeNvcc.started) == 2
    assert build._target("k", src).exists()
    assert build._target("k", changed).exists()
    assert build._target("k", src) == build._target("k", other)
    build.build_many([("k", src)])              # found: nothing started
    assert len(_FakeNvcc.started) == 2
