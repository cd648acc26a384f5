"""The bf16 scan's forward launch plan (``ops.bf16_plan``) at every shape
``chip_smoke.py`` checks, its constants against the kernel's, and the
plain-Python parts of the tools that measure the kernels, on the CPU.
Nothing here needs a card or imports JAX.
"""

from __future__ import annotations

import importlib.util
import pathlib
import re

import pytest

from repro_torch.kernels.mamba_scan import ops as sops

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "src" / "repro_torch" / "kernels" / "mamba_scan" / "csrc"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def test_plan_constants_are_the_kernels():
    """ops' plan constants are mamba_scan_bf16.cu's."""
    cu = (CSRC / "mamba_scan_bf16.cu").read_text()
    got = {k: int(re.search(rf"constexpr int {k} = (\d+);", cu).group(1))
           for k in ("kPairs", "kGroup", "kLow", "kStage", "kMinBlocks",
                     "kThreads")}
    assert got == dict(kPairs=sops.BF16_PAIRS, kGroup=sops.BF16_GROUP,
                       kLow=sops.BF16_LOW, kStage=sops.BF16_STAGE,
                       kMinBlocks=sops.BF16_MIN_BLOCKS, kThreads=sops.THREADS)


@pytest.mark.parametrize("case", CS.SCAN_BF16_CASES, ids=str)
def test_bf16_plan_at_every_checked_shape(case):
    """Threads a channel, pairs a thread, channels a block, the walk's
    levels and shared memory, within the card's limit, at each of
    ``chip_smoke.py``'s ``SCAN_BF16_CASES``."""
    B, S, din, N, _, _, C, _ = case
    p = sops.bf16_plan(B, S, din, N, C)
    NP = max(2, 1 << (N - 1).bit_length())
    assert p.split == (NP // 8 if NP >= 16 else 1)
    assert p.pairs == min(NP // 2, sops.BF16_PAIRS)
    assert 2 * p.pairs * p.split == NP >= N     # a channel's states, padded
    assert p.channels == sops.THREADS // p.split
    assert p.blocks == -(-din // p.channels) * B
    # every level a push can stop at below the top one, floor(log2 C),
    # but the three a whole group keeps in registers where 8 divides C
    assert p.levels == max(0, C.bit_length() - 1 - (3 if C % 8 == 0 else 0))
    assert p.smem_bytes == (16 * p.levels * sops.BF16_PAIRS * sops.THREADS
                            + 8 * sops.BF16_STAGE * p.channels
                            + 2 * 4 * sops.BF16_STAGE * p.split * 8)
    assert p.smem_bytes <= sops.SMEM_BLOCK
    assert 1 <= p.blocks_per_sm <= sops.BF16_MIN_BLOCKS
    assert p.blocks_per_sm * (p.smem_bytes + sops.SMEM_RESERVED) \
        <= sops.SMEM_SM
    assert p.waves == p.blocks / (sops.SMS * p.blocks_per_sm)
    assert p.one_wave == (p.waves <= 1)


@pytest.mark.parametrize("C", [256, 64, 7])
def test_bf16_plan_is_one_wave_at_falcon_mamba_prefill(C):
    """(4, 2048, 8192, 16): two threads a channel walking four pairs each,
    64 channels a block, 512 blocks of at most 50 KB, 4 an SM: 528 >= 512,
    so the grid is resident at once (a partial last wave would cost up to
    a third of the time at 1.3 waves)."""
    p = sops.bf16_plan(4, 2048, 8192, 16, C)
    assert (p.split, p.pairs, p.channels, p.blocks) == (2, 4, 64, 512)
    assert p.smem_bytes <= 51_200 and p.blocks_per_sm == 4
    assert p.one_wave and sops.SMS * p.blocks_per_sm >= p.blocks
    assert p.waves == 512 / 528


def test_bf16_plan_at_the_longest_chunk_fits_a_block():
    """The walk's levels grow with C's bit length: at the longest chunk
    every N still fits one block's shared memory."""
    for N in (1, 4, 8, 16, 33, 64):
        for C in (sops.MAX_BF16_CHUNK, sops.MAX_BF16_CHUNK - 1):
            assert sops.bf16_plan(1, 4, 64, N, C).smem_bytes \
                <= sops.SMEM_BLOCK


def test_previous_tree_ops_keep_the_present_operators():
    """``chip_smoke.py --previous`` loads an earlier tree's wrappers beside
    the present ones.  A second ``torch.library.custom_op`` of one name
    takes the first one's place for every caller, so the earlier tree's
    operators are registered under their own namespace: each wrapper
    still reaches its own tree's kernel."""
    from repro_torch.kernels.mamba_scan import ops

    path = REPO / "src" / "repro_torch" / "kernels" / "mamba_scan" / "ops.py"
    old = CS._load_previous(str(path), "previous_scan_ops_test")
    assert str(ops._bf16_op._opoverload) == \
        "repro_torch.mamba_scan_bf16.default"
    assert str(old._bf16_op._opoverload) == \
        "repro_torch_previous.mamba_scan_bf16.default"
    assert old._bf16_bwd_op._opoverload is not ops._bf16_bwd_op._opoverload


def test_sass_probe_cuts_only_the_ragged_walk():
    """``tools/scan_bf16_probe.py --sass`` counts a copy of the forward in
    which every group takes the whole-group path: its edit must find this
    tree's condition, and the earlier one-pair kernel's, so that the loop
    it counts is the one every whole group runs."""
    spec = importlib.util.spec_from_file_location(
        "scan_bf16_probe", REPO / "tools" / "scan_bf16_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    text = (CSRC / "mamba_scan_bf16.cu").read_text()
    found = [old in text for old, _ in probe.SASS_EDITS]
    assert found == [True, False]
    assert all(new == "      if (true) {\n" for _, new in probe.SASS_EDITS)
