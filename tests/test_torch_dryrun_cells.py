"""The port's dry-run on the cells that exercise the sharded-expert MoE
path, the other model families and the multi-pod mesh's axes, on the
CPU (no card, no device memory).

* kimi-k2-1t-a32b at its published width cut to 2 layers, ``train_4k``
  on a fake (16, 16) mesh: 384 experts split over "model" (24 a rank),
  the unpinned DTensor dispatch, whose gathered outputs must come back
  batch-split (a gather from an expert-split buffer left to DTensor
  gives tokens split over "model" too, and a strided layout whose
  backward reads shard offsets from a tensor's values);
* reduced kimi-k2 with 16 and 32 experts on (16, 16): one and two
  experts a rank;
* one reduced cell each of the ssm, hybrid, vlm and encdec families on
  (4, 2), and reduced olmoe-1b-7b's ``train_4k`` on a (2, 2, 2) mesh over
  ("pod", "data", "model"), the production multi-pod mesh's axes.

Each must give an ``OK`` record whose fallbacks equal the reference
rules' for the same config and mesh.  The fake process group runs in
subprocesses, so it never leaks into other tests of the worker; the
cells are split over three of them, which run at once.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import pytest

from test_torch_dryrun import SRC, _reference_fallbacks

KIMI = "kimi-k2-1t-a32b"
# name: (arch, reduced, config overrides, shape, mesh); cells of one
# group run in one subprocess
GROUPS = [
    {"kimi_2_layers": (KIMI, False, {"n_layers": 2}, "train_4k", (16, 16)),
     "kimi_32_experts": (KIMI, True, {"n_experts": 32}, "train_4k",
                         (16, 16))},
    {"kimi_16_experts": (KIMI, True, {"n_experts": 16}, "train_4k",
                         (16, 16)),
     "ssm": ("falcon-mamba-7b", True, {}, "train_4k", (4, 2)),
     "hybrid": ("zamba2-2.7b", True, {}, "decode_32k", (4, 2))},
    {"vlm": ("llava-next-mistral-7b", True, {}, "train_4k", (4, 2)),
     "encdec": ("whisper-tiny", True, {}, "train_4k", (4, 2)),
     "pod_mesh": ("olmoe-1b-7b", True, {}, "train_4k", (2, 2, 2))},
]
CELLS = {k: v for g in GROUPS for k, v in g.items()}

SCRIPT = r"""
import dataclasses, json, math, sys
from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun
out = {}
for name, (arch, red, over, shape, mesh) in json.loads(sys.argv[1]).items():
    cfg = get_config(arch)
    cfg = dataclasses.replace(reduced(cfg) if red else cfg, **over)
    dryrun.fake_process_group(math.prod(mesh))
    try:
        out[name] = dryrun.lower_cell(arch, shape, len(mesh) == 3, "base",
                                      cfg=cfg, mesh_shape=tuple(mesh))
    except Exception as e:  # the dry-run's own FAIL record
        out[name] = {"status": "FAIL", "error": repr(e)[:2000]}
import torch.distributed as dist
dist.destroy_process_group()
print("RESULT" + json.dumps(out, default=str))
"""


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, "-c", SCRIPT, json.dumps(g)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for g in GROUPS]
    out = {}
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, stderr[-3000:]
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT")]
            out.update(json.loads(line[-1][len("RESULT"):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _reference_cfg(arch, red, over):
    import dataclasses
    from repro.configs import get_config, reduced
    cfg = get_config(arch)
    return dataclasses.replace(reduced(cfg) if red else cfg, **over)


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_record_ok_with_reference_fallbacks(records, name):
    arch, red, over, shape, mesh = CELLS[name]
    rec = records[name]
    assert rec["status"] == "OK", rec
    assert rec["mesh"] == "x".join(map(str, mesh))
    assert rec["n_chips"] == math.prod(mesh)
    assert rec["cost_flops"] > 0 and rec["roofline"]["bound_s"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    if rec["kind"] == "train":   # gradients reduced over the batch axes
        assert rec["collective_wire_bytes"] > 0
    assert sorted(rec["sharding_fallbacks"]) == sorted(_reference_fallbacks(
        shape, "base", arch=arch, cfg=_reference_cfg(arch, red, over),
        mesh_shape=mesh))

