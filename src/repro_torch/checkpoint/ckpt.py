"""Fault-tolerant checkpointing.

The port's own copy of ``repro/checkpoint/ckpt.py``.  The directory
layout, manifest keys, ``.npy`` leaves and digests are the reference's,
so a step written by either package restores in the other.  Trees are
dicts and namedtuples, walked here; a tensor leaf goes to the host with
``.detach().cpu().numpy()``.  A bf16 leaf is written as the reference
writes one (numpy has no bf16: ``ml_dtypes`` gives the reference's): an
``.npy`` of 2-byte void elements, descr ``'<V2'``, holding the bf16
bits, manifest dtype ``"bfloat16"``, the digest of those bytes; it
restores as a bf16 tensor.  ``restore`` returns numpy leaves (a bf16
leaf: a bf16 CPU tensor), or tensors on ``device=``, or, given the
reference's ``shardings=`` as ``(mesh, logical specs)``, DTensors
placed on that mesh (``sharding.rules.distribute``), whatever mesh the
step was saved from: the elastic restore.

A DTensor state (the sharded train step's) is saved whole: ``save``
gathers each leaf (``full_tensor()``, a collective, so every rank of
the mesh must call ``save``) in the caller's thread, and rank 0 alone
writes, on the save thread when ``blocking`` is False, which runs no
collective.  A blocking save, and ``wait`` after an asynchronous one,
end with a barrier, so that every rank may then restore the step.

Design for 1000+ nodes (DESIGN.md §6): every host writes only its
addressable shards, keyed by (step, leaf-path, shard-index), plus a
manifest with shapes/dtypes/content hashes; restore reshards to whatever
mesh the job restarts with (elastic).  In this single-process container
the host owns all shards, so leaves are saved whole — the manifest and
reshard-on-restore code paths are the same ones a multi-host deployment
exercises.

Features: atomic manifest commit (write + rename), async save thread,
retention of the last K checkpoints, corruption detection via xxhash-like
content digests, resume-from-latest.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding.dtensor import is_dtensor


def _leaf_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaf_paths(tree[k], f"{prefix}{k}/"))
        return out
    if hasattr(tree, "_fields"):
        out = []
        for k in tree._fields:
            out.extend(_leaf_paths(getattr(tree, k), f"{prefix}{k}/"))
        return out
    return [(prefix[:-1], tree)]


def _map_tree(fn, tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf (dict keys sorted, as
    ``_leaf_paths`` orders them)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, tree[k]) for k in sorted(tree)}
    if hasattr(tree, "_fields"):
        return type(tree)(*[_map_tree(fn, getattr(tree, k))
                            for k in tree._fields])
    return fn(tree)


# A bf16 leaf on the host: its bits as 2-byte void elements, the dtype
# numpy reads the reference's bf16 .npy files as.
BF16_HOST = np.dtype("V2")


def _to_host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if is_dtensor(x):
            x = x.full_tensor()
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(BF16_HOST)
        return x.numpy()
    return np.asarray(x)


def _save_leaf(path: Path, leaf: np.ndarray) -> str:
    """Write ``leaf`` as .npy; returns its manifest dtype.  A bf16 leaf
    gets the reference's header (descr '<V2'; numpy's own writer would
    give '|V2')."""
    if leaf.dtype != BF16_HOST:
        np.save(path, leaf)
        return str(leaf.dtype)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": leaf.shape})
        f.write(np.ascontiguousarray(leaf).tobytes())
    return "bfloat16"


def _from_host(arr: np.ndarray, dtype: str, device) -> Any:
    """A restored leaf: numpy, or a tensor on ``device``; a bf16 leaf is a
    bf16 tensor (on the CPU unless ``device``).  A tensor is always a copy
    in torch's own memory: one left on ``np.load``'s buffer has another
    alignment, and the CPU's matrix products may then sum in another
    order than on the tensors the state was saved from."""
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             ).view(torch.bfloat16)
        return t.clone() if device is None else t.to(device, copy=True)
    if device is None:
        return arr
    return torch.from_numpy(arr).to(device, copy=True)


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha1(arr.tobytes()).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._dist_pending = False

    # -- save ------------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = True) -> None:
        """Write ``step``; with ``blocking`` False on a thread.  Either way
        an earlier asynchronous save is finished first: the reference's
        blocking save does not wait, and a blocking save of the step an
        asynchronous one is still writing races it on the same files."""
        dist_save = any(is_dtensor(x) for _, x in _leaf_paths(state))
        host_state = _map_tree(_to_host, state)
        self.wait()
        writer = not dist_save or torch.distributed.get_rank() == 0
        if blocking:
            if writer:
                self._write(step, host_state)
            if dist_save:
                torch.distributed.barrier()
        else:
            if writer:
                self._thread = threading.Thread(
                    target=self._write, args=(step, host_state),
                    daemon=True)
                self._thread.start()
            self._dist_pending = dist_save

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._dist_pending:
            self._dist_pending = False
            torch.distributed.barrier()

    def _write(self, step: int, host_state: Any) -> None:
        tmp = self.dir / f".tmp_step_{step}"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "leaves": {}}
        for i, (path, leaf) in enumerate(_leaf_paths(host_state)):
            fn = f"leaf_{i:05d}.npy"
            manifest["leaves"][path] = {
                "file": fn, "shape": list(leaf.shape),
                "dtype": _save_leaf(tmp / fn, leaf), "digest": _digest(leaf)}
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore -----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.all_steps()
        return s[-1] if s else None

    def restore(self, step: Optional[int], like: Any,
                device=None, verify: bool = False, shardings=None) -> Any:
        """Restore into the structure of ``like``: numpy leaves (a bf16
        leaf a bf16 tensor), or tensors on ``device`` when one is
        named, or with ``shardings=(mesh, specs)`` DTensors on ``mesh``
        placed by the logical specs ``specs`` (a tree like ``like``'s;
        the leaves are read on ``device``, by default the mesh's device
        type)."""
        if shardings is not None:
            from repro_torch.sharding import rules
            mesh, specs = shardings
            tree = self.restore(step, like, device or mesh.device_type,
                                verify)
            return rules.distribute(tree, mesh, specs)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        with open(d / "manifest.json") as f:
            manifest = json.load(f)
        leaves = {}
        for path, meta in manifest["leaves"].items():
            arr = np.load(d / meta["file"])
            if verify and _digest(arr) != meta["digest"]:
                raise IOError(f"corrupt leaf {path} in step {step}")
            leaves[path] = arr
        flat_like = _leaf_paths(like)
        missing = [p for p, _ in flat_like if p not in leaves]
        if missing:
            raise KeyError(f"checkpoint step {step} missing leaves "
                           f"{missing[:5]}...")

        out_leaves = []
        for path, leaf_like in flat_like:
            arr = leaves[path]
            if list(arr.shape) != list(leaf_like.shape):
                raise ValueError(f"shape mismatch for {path}: "
                                 f"{arr.shape} vs {leaf_like.shape}")
            out_leaves.append(_from_host(
                arr, manifest["leaves"][path]["dtype"], device))
        return _unflatten_like(like, iter(out_leaves))


def _unflatten_like(tree: Any, leaves) -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], leaves) for k in sorted(tree)}
    if hasattr(tree, "_fields"):
        return type(tree)(*[_unflatten_like(getattr(tree, k), leaves)
                            for k in tree._fields])
    return next(leaves)
