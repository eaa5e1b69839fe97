"""Sharding-rule derivation: tree → spec tree (counterpart of
``repro/dist/sharding.py``).

One rule set covers every architecture in ``configs.ARCH_IDS`` on the
production meshes (``launch/mesh.py``): tensor parallelism over ``"model"``,
FSDP-style parameter sharding over the data axes in training only, batch
sharding for inputs, and batch + KV-head sharding for decode caches.  Specs
are derived from the names in the parameter tree (``wq``/``down``/
``embed``/...) plus leaf shapes, with a hard divisibility guard: an axis is
only ever assigned to a dim the mesh divides evenly.  Stacked-layer
leading dims are never sharded.

A spec is :class:`P`, a tuple standing in for ``PartitionSpec``: one entry
a dim, each ``None``, an axis name or a tuple of axis names.  The rules
read only ``.shape`` of a leaf and ``.shape`` (axis → size) of a mesh, so
trees of shape stand-ins and stand-in meshes work: 256- and 512-shard specs
never allocate.  :func:`to_shardings` turns specs into
:class:`MeshSharding` objects that cut a tensor into its blocks on a
:class:`~repro_torch.dist.mesh.VirtualMesh` and join them back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

__all__ = ["P", "ShardingRules", "MeshSharding", "param_specs",
           "batch_specs", "cache_specs", "to_shardings"]


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``.  As
    ``PartitionSpec``, an entry of several axes is a tuple, of one axis
    that axis's name, of none ``None``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """How logical roles map onto a mesh.

    ``mesh`` only needs ``.shape`` (axis → size mapping); ``data_axes`` may
    span several mesh axes (``("pod", "data")`` on multi-pod meshes) and is
    always applied as the combined product.  ``train=True`` enables FSDP
    parameter sharding over the data axes; serving replicates parameters
    across them.
    """

    mesh: Any
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    train: bool = True

    @property
    def data_size(self) -> int:
        return math.prod(
            int(self.mesh.shape.get(a, 1)) for a in self.data_axes)

    @property
    def model_size(self) -> int:
        return int(self.mesh.shape.get(self.model_axis, 1))

    def data_entry(self):
        return self.data_axes[0] if len(self.data_axes) == 1 \
            else tuple(self.data_axes)


# --- name classification ----------------------------------------------------

# fan-out (column-parallel): shard the LAST dim on the model axis
_COL_PARALLEL = frozenset({
    "wq", "wk", "wv", "up", "gate", "in_proj", "wx", "wif", "wr",
    "vis_proj", "conv_w", "lm_head",
})
# fan-in (row-parallel): shard dim −2 on the model axis (the contraction
# dim of the preceding column-parallel matmul — output needs one reduce)
_ROW_PARALLEL = frozenset({"down", "wo", "out_proj", "out"})
# MoE expert tables (leading expert dim after the layer stack)
_EXPERT_TABLES = frozenset({"w_up", "w_gate", "w_down"})
_ROUTERS = frozenset({"w_router", "router"})


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists/tuples and
    dataclasses (a cache's ``KVCache``), keeping its structure; ``path``
    holds the dict keys on the way (as the reference's ``DictKey``s)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: _map_with_path(fn, getattr(tree, f.name), path + (i,))
            for i, f in enumerate(dataclasses.fields(tree))})
    return fn(path, tree)


def _path_names(path) -> list:
    return [k for k in path if isinstance(k, str)]


def _leaf_name(names: list) -> str:
    # weights live as {"w": array} under their role name; biases/norm
    # scales keep their own name
    for n in reversed(names):
        if n not in ("w", "b"):
            return n
    return names[-1] if names else ""


def _param_rule(path, leaf, rules: ShardingRules, expert_mode: str) -> P:
    shape = tuple(leaf.shape)
    ndim = len(shape)
    if ndim < 2:
        return P()
    names = _path_names(path)
    name = _leaf_name(names)
    model, msize = rules.model_axis, rules.model_size
    entries: list = [None] * ndim

    # --- tensor-parallel dim ------------------------------------------------
    tp: Optional[int] = None
    if "embed" in names:
        tp = ndim - 2            # (vocab_padded, d_model): vocab-parallel
    elif name in _EXPERT_TABLES:
        if expert_mode == "ep" and ndim >= 3 and shape[ndim - 3] % msize == 0:
            tp = ndim - 3        # expert-parallel: shard the expert dim
        else:                    # tp fallback: shard d_ff inside each expert
            tp = ndim - 1 if name != "w_down" else ndim - 2
    elif name in _ROUTERS:
        tp = ndim - 1
    elif name in _ROW_PARALLEL:
        tp = ndim - 2
    elif name in _COL_PARALLEL:
        tp = ndim - 1
    if tp is not None and (msize <= 1 or shape[tp] % msize != 0):
        tp = None
    if tp is not None:
        entries[tp] = model

    # --- FSDP dim (train only) ---------------------------------------------
    dsize = rules.data_size
    if rules.train and dsize > 1:
        cands = [d for d in (ndim - 2, ndim - 1) if d != tp]
        cands.sort(key=lambda d: -shape[d])
        for d in cands:
            if shape[d] % dsize == 0:
                entries[d] = rules.data_entry()
                break
    return P(*entries)


def param_specs(params: Any, rules: ShardingRules,
                expert_mode: str = "ep") -> Any:
    """Specs for a parameter tree (``transformer``/``encdec`` layout).
    ``expert_mode``: ``cfg.expert_mode`` — ``"ep"`` shards the expert dim
    of MoE tables, ``"tp"`` shards ``d_ff`` inside each expert.
    """
    return _map_with_path(
        lambda path, leaf: _param_rule(path, leaf, rules, expert_mode),
        params)


def batch_specs(batch: Any, rules: ShardingRules) -> Any:
    """Inputs: dim 0 (global batch) over the data axes when divisible."""
    dsize = rules.data_size

    def rule(_, leaf) -> P:
        shape = tuple(leaf.shape)
        entries: list = [None] * len(shape)
        if shape and dsize > 1 and shape[0] % dsize == 0:
            entries[0] = rules.data_entry()
        return P(*entries)

    return _map_with_path(rule, batch)


def cache_specs(cache: Any, rules: ShardingRules, batch: int) -> Any:
    """Decode caches: ``(layers, batch, ...)`` leaves — batch over the data
    axes, KV heads (dim −2 of 4D+ leaves) over the model axis, both guarded
    by divisibility.  The layer-stack dim stays replicated."""
    dsize, msize = rules.data_size, rules.model_size

    def rule(_, leaf) -> P:
        shape = tuple(leaf.shape)
        ndim = len(shape)
        entries: list = [None] * ndim
        if ndim >= 2 and dsize > 1 and shape[1] == batch and batch % dsize == 0:
            entries[1] = rules.data_entry()
        if ndim >= 4 and msize > 1 and shape[ndim - 2] % msize == 0:
            entries[ndim - 2] = rules.model_axis
        return P(*entries)

    return _map_with_path(rule, cache)


class MeshSharding:
    """A spec laid on a concrete mesh: :meth:`cut` a global tensor into its
    stacked blocks ``(*mesh, *block)`` (a view where the tensor's layout
    allows: a reshape, a permute and, over axes the spec does not name, an
    ``expand``), and :meth:`join` blocks back into the global tensor."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)
        seen = [a for i in range(len(self.spec)) for a in self._axes(i)]
        if len(set(seen)) != len(seen) or any(a not in mesh.shape
                                              for a in seen):
            raise ValueError(f"spec {self.spec} on mesh {mesh.shape}")

    def _axes(self, i: int) -> Tuple[str, ...]:
        e = self.spec[i] if i < len(self.spec) else None
        if e is None:
            return ()
        return (e,) if isinstance(e, str) else tuple(e)

    def cut(self, t):
        mesh = self.mesh
        if len(self.spec) > t.dim():
            raise ValueError(f"spec {self.spec} for a {t.dim()}-d tensor")
        shape, labels = [], []
        for i, size in enumerate(t.shape):
            axes = self._axes(i)
            k = math.prod(mesh.shape[a] for a in axes)
            if size % k:
                raise ValueError(f"dim {i} of extent {size} does not divide "
                                 f"over {axes} ({k} shards)")
            for a in axes:
                shape.append(mesh.shape[a])
                labels.append(a)
            shape.append(size // k)
            labels.append(i)
        v = t.reshape(shape)
        for a in mesh.axis_names:
            if a not in labels:
                v = v.unsqueeze(0)
                labels.insert(0, a)
        v = v.permute([labels.index(a) for a in mesh.axis_names]
                      + [labels.index(i) for i in range(t.dim())])
        return v.expand(tuple(mesh.shape[a] for a in mesh.axis_names)
                        + tuple(v.shape[mesh.ndim:]))

    def join(self, blocks):
        mesh = self.mesh
        nb = blocks.dim() - mesh.ndim
        used = [a for i in range(nb) for a in self._axes(i)]
        v = blocks
        for a in reversed(mesh.axis_names):   # a replicated axis: shard 0
            if a not in used:
                v = v.select(mesh.axis(a), 0)
        kept = [a for a in mesh.axis_names if a in used]
        order = []
        for i in range(nb):
            order += [kept.index(a) for a in self._axes(i)] + [len(kept) + i]
        v = v.permute(order)
        return v.reshape([blocks.shape[mesh.ndim + i] * math.prod(
            mesh.shape[a] for a in self._axes(i)) for i in range(nb)])


def to_shardings(specs: Any, mesh) -> Any:
    """Spec tree → :class:`MeshSharding` tree on a concrete mesh."""
    return _map_with_path(lambda _, s: MeshSharding(mesh, s), specs)
