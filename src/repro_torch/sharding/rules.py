"""Sharding-rule engine: maps every parameter / activation / cache leaf to
a logical spec, with divisibility fallback (a dim that does not divide the
mesh axis is replicated and the decision is recorded).

The port of ``repro.sharding.rules``, rule for rule.  A **logical spec**
is a tuple with one entry per tensor dim: ``None`` (replicated), a mesh
axis name, or a tuple of axis names (the dim split over all of them,
major first), the entries of the reference's ``PartitionSpec``.
``placements(mesh, spec)`` turns one into DTensor placements and
``distribute(tree, mesh, specs)`` places a tree by them, the
counterpart of ``jax.device_put(tree, NamedSharding(...))``.

The rules read only the mesh's axis names and sizes: a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, or a
``MeshShape`` (``MeshShape((16, 16), ("data", "model"))``), which needs
no process group, so the rules run for a 256-rank mesh in any process.

Logical policy (the reference's):
  * batch dims        -> ("pod", "data") [multi-pod] or ("data",)
  * TP ("model")      -> attention head projections, MLP hidden, expert
                         axis of MoE weights, mamba d_inner, vocab.
  * sequence dim of decode KV caches -> "model" (long caches divide
    across the pod without replicating GQA heads).
  * ZeRO-1: optimizer moments additionally sharded over "data" on the
    first free divisible dim.
  * 1T-class MoE: expert FFN dim additionally sharded over "data"
    (2-D expert sharding) so per-device weights fit HBM.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

# params above this count get expert-FFN FSDP over "data"
FSDP_EXPERT_THRESHOLD = 100_000_000_000

Spec = Tuple[Any, ...]


class MeshShape(NamedTuple):
    """A mesh's shape and axis names, with no devices behind it."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


class RuleLog:
    """Records divisibility fallbacks."""

    def __init__(self):
        self.fallbacks: List[str] = []

    def note(self, path: str, dim: int, size: int, axis: str, n: int):
        self.fallbacks.append(
            f"{path} dim{dim}={size} not divisible by {axis}({n}): replicated")


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        return int(np.prod([sizes[a] for a in axis]))
    return sizes[axis]


def _fit(mesh, path: str, shape: Tuple[int, ...], logical,
         log: Optional[RuleLog]) -> Spec:
    """Drop axes that do not divide their dim.  A one-axis tuple is
    written as its axis, as ``PartitionSpec`` normalises it."""
    out = []
    for d, ax in enumerate(logical):
        if ax is None:
            out.append(None)
            continue
        n = _axis_size(mesh, ax)
        if shape[d] % n == 0:
            out.append(ax[0] if isinstance(ax, tuple) and len(ax) == 1
                       else ax)
        else:
            if log is not None:
                log.note(path, d, shape[d], str(ax), n)
            out.append(None)
    return tuple(out)


def batch_axes(mesh):
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def _param_logical(cfg: ModelConfig, path: str, ndim: int,
                   shape: Tuple[int, ...], mesh) -> Tuple:
    mp = "model"
    leaf = path.split("/")[-1]
    stacked = path.startswith(("blocks/", "mamba/", "enc/", "dec/"))
    off = 1 if stacked else 0  # leading layer-stack dim

    def L(*spec):
        return (None,) * off + spec

    fsdp_ff = (cfg.family == "moe"
               and cfg.n_params() > FSDP_EXPERT_THRESHOLD)

    if leaf in ("tok",):                       # (V, D)
        return (mp, None)
    if leaf in ("lm_head", "mm_proj"):         # (D, V) / (D, D)
        return (None, mp)
    if leaf in ("w", "b", "_"):                # norms
        return (None,) * ndim
    if leaf in ("wq", "wk", "wv"):             # (D, H*hd)
        nh = cfg.n_kv_heads if leaf in ("wk", "wv") else cfg.n_heads
        n = _axis_size(mesh, mp)
        if nh % n == 0:
            return L(None, mp)
        return L(None, None)                   # replicate (GQA kv < mesh)
    if leaf == "wo":                           # (H*hd, D)
        n = _axis_size(mesh, mp)
        return L(mp, None) if cfg.n_heads % n == 0 else L(None, None)
    if leaf in ("bq", "bk", "bv"):
        return L(None)
    if leaf in ("w_gate", "w_up", "w_down"):
        if ndim - off == 3:                    # MoE experts (E, D, F)/(E, F, D)
            ff_ax = "data" if fsdp_ff else None
            if leaf == "w_down":
                return L(mp, ff_ax, None)
            return L(mp, None, ff_ax)
        if leaf == "w_down":                   # (F, D)
            return L(mp, None)
        return L(None, mp)                     # (D, F)
    if leaf == "router":                       # (D, E)
        return L(None, None)
    # mamba1 / mamba2
    if leaf in ("in_proj", "zx_proj"):         # (D, 2*din)
        return L(None, mp)
    if leaf in ("bc_proj", "dtp", "x_proj"):   # small projections
        return L(None, None) if leaf != "x_proj" else L(mp, None)
    if leaf == "dt_proj":                      # (R, din)
        return L(None, mp)
    if leaf == "conv_w":                       # (K, din)
        return L(None, mp)
    if leaf in ("conv_b", "dt_bias", "Dskip"): # (din,) or (nh,)
        dim = shape[-1]
        n = _axis_size(mesh, mp)
        return L(mp) if dim % n == 0 and dim >= n else L(None)
    if leaf == "A_log":
        if ndim - off == 2:                    # mamba1 (din, N)
            return L(mp, None)
        return L(None)                         # mamba2 (nh,)
    if leaf == "out_proj":                     # (din, D)
        return L(mp, None)
    return (None,) * ndim


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape)


def _map2(fn, a, b):
    """``fn`` over the leaves of two trees of one structure (dicts)."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def param_specs(cfg: ModelConfig, mesh, params_shape: Any,
                log: Optional[RuleLog] = None) -> Any:
    """params_shape: a tree of tensors (shape-only ones will do, e.g.
    ``training.step.abstract_train_state``'s) -> a tree of logical
    specs."""

    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in tree.items()}
        path = prefix[:-1]
        shape = _shape(tree)
        logical = _param_logical(cfg, path, len(shape), shape, mesh)
        return _fit(mesh, path, shape, logical, log)

    return build(params_shape)


def opt_state_specs(cfg: ModelConfig, mesh, params_shape: Any,
                    pspecs: Any, log: Optional[RuleLog] = None) -> Any:
    """ZeRO-1: moments get "data" added on the first free divisible dim."""
    n_data = _axis_size(mesh, "data")

    def build(shape_leaf, spec: Spec):
        shape = _shape(shape_leaf)
        spec_t = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
        used = set()
        for ax in spec_t:
            if isinstance(ax, tuple):
                used.update(ax)
            elif ax is not None:
                used.add(ax)
        if "data" in used:  # e.g. 2-D expert sharding already uses it
            return spec_t
        out = list(spec_t)
        for d, ax in enumerate(spec_t):
            if ax is None and shape[d] % n_data == 0 \
                    and shape[d] >= n_data:
                out[d] = "data"
                break
        return tuple(out)

    return _map2(build, params_shape, pspecs)


# ---------------------------------------------------------------------------
# activation / batch / cache rules
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, mesh, batch_shapes: Dict[str, tuple],
                log: Optional[RuleLog] = None) -> Dict[str, Spec]:
    """Shard batch dims over ("pod","data"); everything else replicated.
    ``batch_shapes``: {name: (shape, dtype)}, as
    ``launch.specs.batch_shapes`` gives it."""
    bax = batch_axes(mesh)
    out = {}
    for name, (shape, _) in batch_shapes.items():
        logical = (bax,) + (None,) * (len(shape) - 1)
        out[name] = _fit(mesh, f"batch/{name}", shape, logical, log)
    return out


def cache_specs(cfg: ModelConfig, mesh, cache_shape: Any,
                log: Optional[RuleLog] = None) -> Any:
    """KV caches: (L, B, S, H_kv, hd) -> (None, batch, "model", None, None);
    SSM states: shard d_inner / heads over "model".  A cache's Python
    int fields (lengths) get ``()``."""
    bax = batch_axes(mesh)

    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return type(tree)(*[build(getattr(tree, k), f"{prefix}{k}/")
                                for k in tree._fields])
        path = prefix[:-1]
        leaf = path.split("/")[-1]
        if not isinstance(tree, torch.Tensor):
            return ()
        shape = _shape(tree)
        if leaf in ("bk", "bv") and len(shape) == 5:
            # decode append ring: replicated along S
            logical = (None, bax, None, None, None)
        elif leaf in ("k", "v", "xk", "xv") and len(shape) == 5:
            # shard the sequence dim: (L,B,S,H,hd) or head-major
            # (L,B,H,S,hd) — S is the larger of dims 2/3
            if shape[3] > shape[2]:
                logical = (None, bax, None, "model", None)
            else:
                logical = (None, bax, "model", None, None)
        elif leaf == "conv":                      # (L, B, K-1, din)
            logical = (None, bax, None, "model")
        elif leaf == "ssm":
            if len(shape) == 4:                   # mamba1 (L, B, din, N)
                logical = (None, bax, "model", None)
            else:                                 # mamba2 (L, B, nh, N, P)
                logical = (None, bax, "model", None, None)
        elif leaf == "length" or len(shape) == 0:
            return ()
        else:
            logical = (None,) * len(shape)
        return _fit(mesh, path, shape, logical, log)

    return build(cache_shape)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(mesh, spec: Spec) -> tuple:
    """A logical spec as DTensor placements on ``mesh`` (a named
    ``DeviceMesh``): ``Shard(d)`` on each mesh dim that spec entry ``d``
    names (an axis tuple puts ``Shard(d)`` on each of its dims; DTensor
    splits the dims left to right, the reference's major-to-minor
    order), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dim = None
        for d, ax in enumerate(spec):
            if ax == name or (isinstance(ax, tuple) and name in ax):
                dim = d
                break
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def distribute(tree: Any, mesh, specs: Any) -> Any:
    """Every tensor leaf of ``tree`` as a DTensor on ``mesh`` placed by
    the logical spec at the same place in ``specs``; other leaves (a
    cache's lengths) pass through.  Each rank takes its shards of its
    own copy of the leaf (``src_data_rank=None``: no collective), so
    every rank must hold the same values."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def go(t, s):
        if isinstance(t, dict):
            return {k: go(t[k], s[k]) for k in t}
        if hasattr(t, "_fields"):
            return type(t)(*[go(getattr(t, k), getattr(s, k))
                             for k in t._fields])
        if not isinstance(t, torch.Tensor):
            return t
        pl = placements(mesh, s)
        if isinstance(t, DTensor):
            if t.device_mesh == mesh:
                return t.redistribute(mesh, pl)
            t = t.full_tensor()
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    return go(tree, specs)
