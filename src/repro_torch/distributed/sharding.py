"""Sharding policy engine, the port of ``repro.distributed.sharding``:
param-path rules -> partition specs -> DTensor placements.

The mesh has a tensor axis (``model``) and batch axes (``data``, plus
``pod`` in the multi-pod mesh).  Rules map parameter path regexes to
*logical* specs written in axis names; the engine drops axis names that
the target mesh does not have (so the same rules drive the (16, 16)
single-pod and (2, 16, 16) multi-pod meshes) and falls back to
replication for dimensions that would not divide.

A spec is a :class:`PartitionSpec`, the port's own tuple of one entry a
dimension (None, an axis name, or a tuple of axis names), so it compares
entry by entry with the reference's ``jax.sharding.PartitionSpec``.
:func:`placements` translates a resolved spec into DTensor placements on
a ``DeviceMesh``: a dimension sharded over ``("pod", "data", "model")``
becomes ``Shard(d)`` on each of those mesh dimensions, in mesh order, as
JAX nests them.  A mesh is anything with ``axis_names`` and a ``shape``
mapping (the reference's tests' fake mesh) or a ``DeviceMesh`` with
named dimensions.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.tree import (
    flatten_with_path,
    leaves,
    path_name,
    tree_map,
    unflatten,
)

Rules = List[Tuple[str, Tuple]]

BATCH = ("pod", "data")  # logical batch axes, in mesh order


class PartitionSpec(tuple):
    """One entry a dimension: None (replicated), an axis name, or a tuple
    of axis names (sharded over their product, the first outermost)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the reference's ``NamedSharding``."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> Tuple:
        return placements(self.mesh, self.spec)


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dimensions have no names")
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {n: int(shape[n]) for n in names}
    return dict(zip(names, (int(s) for s in shape)))


def _mesh_axis_size(mesh: Any, names) -> int:
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    sizes = axis_sizes(mesh)
    size = 1
    for n in names:
        if n in sizes:
            size *= sizes[n]
    return size


def _fit_axes(mesh: Any, names: Tuple[str, ...], dim: int):
    """Largest usable subset of axis names whose product divides dim:
    try the full tuple, then prefixes, then each single axis."""
    sizes = axis_sizes(mesh)
    names = tuple(n for n in names if n in sizes)
    candidates = [names[:k] for k in range(len(names), 0, -1)]
    candidates += [(n,) for n in names]
    for cand in candidates:
        if not cand:
            continue
        if dim % _mesh_axis_size(mesh, cand) == 0:
            return cand[0] if len(cand) == 1 else cand
    return None


def resolve_spec(mesh: Any, spec: Sequence, shape: Tuple[int, ...]
                 ) -> PartitionSpec:
    """Filter a logical spec against a mesh: drop unknown axes and, where
    the axes do not divide a dimension exactly, degrade tuple -> prefix
    -> single axis -> replicated."""
    out = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            out.append(None)
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        out.append(_fit_axes(mesh, names, dim))
    return P(*out)


def sanitize_shardings(shard_tree: Any, abstract_tree: Any, mesh: Any) -> Any:
    """Re-validate a :class:`NamedSharding` tree against abstract shapes:
    a spec shorter than the rank is padded with None, and any dimension
    whose assigned axes do not divide it exactly is degraded."""

    def one(shard, leaf):
        if not isinstance(shard, NamedSharding):
            return shard
        shape = tuple(leaf.shape)
        spec = tuple(shard.spec) + (None,) * (len(shape) - len(shard.spec))
        return NamedSharding(mesh, resolve_spec(mesh, spec, shape))

    return tree_map(one, shard_tree, abstract_tree)


def shard_by_rules(params: Any, mesh: Any, rules: Rules,
                   default: Tuple = ()) -> Any:
    """A :class:`NamedSharding` tree matching ``params`` (tensors, meta
    tensors or anything with ``shape``) from path rules: the first rule
    whose regex matches the leaf's path wins; its spec is right-aligned
    to the leaf's rank (leading stacked-layer dims replicated)."""
    return unflatten(params, [
        NamedSharding(mesh, rule_spec(rules, path_name(path),
                                      tuple(leaf.shape), mesh, default))
        for path, leaf in flatten_with_path(params)])


def rule_spec(rules: Rules, name: str, shape: Tuple[int, ...], mesh: Any,
              default: Tuple = ()) -> PartitionSpec:
    """The resolved spec of a leaf named ``name`` (a path, as
    ``tree.path_name`` writes it) of ``shape`` under ``rules``, as
    :func:`shard_by_rules` gives it."""
    for pattern, spec in rules:
        if re.search(pattern, name):
            spec = tuple(spec)
            if len(spec) < len(shape):  # right-align (leading stack dims)
                spec = (None,) * (len(shape) - len(spec)) + spec
            return resolve_spec(mesh, spec[: len(shape)], shape)
    return resolve_spec(
        mesh, tuple(default)[: len(shape)] + (None,) * len(shape), shape)


# ------------------------------------------------------- family rule sets ---
# Transformer (dense + MoE).  Stacked layer params have a leading L dim,
# handled by right-alignment in shard_by_rules.
LM_RULES: Rules = [
    (r"embed/table", ("model", "data")),
    (r"unembed/w", ("data", "model")),
    (r"block/(wq|wk|wv)/w", ("data", "model")),
    (r"block/(wq|wk|wv)/b", ("model",)),
    (r"block/wo/w", ("model", "data")),
    (r"block/mlp/(wg|wu)/w", ("data", "model")),
    (r"block/mlp/wd/w", ("model", "data")),
    (r"block/moe/router", ("data", None)),
    (r"block/moe/(wg|wu)$", ("model", "data", None)),
    (r"block/moe/wd$", ("model", None, "data")),
    (r"block/moe/shared/(wg|wu)", ("data", "model")),
    (r"block/moe/shared/wd", ("model", "data")),
    (r"ln", (None,)),
]

# RecSys: embedding tables row-sharded over every axis (MLPerf-DLRM style
# table-wise+row-wise parallelism); MLPs tensor-sharded on their wide dim.
RECSYS_MLP_W = r"(bot|top|head|attn|user_tower|item_tower)/fc\d+/w"
RECSYS_RULES: Rules = [
    (r"tables/t\d+/table", (BATCH + ("model",), None)),
    (r"(item|cate|user|ctx|icat)/table", (BATCH + ("model",), None)),
    (RECSYS_MLP_W, (None, "model")),
    (r"pos/table", (None, None)),
    (r"blocks/.*", (None, None)),
]

# GNN: parameters are tiny (channel mixers) -> replicate everything.
GNN_RULES: Rules = [
    (r".*", ()),
]


def batch_spec(mesh: Any, *, extra: Tuple = ()) -> PartitionSpec:
    names = tuple(n for n in BATCH if n in axis_sizes(mesh))
    lead = names[0] if len(names) == 1 else names
    return P(lead, *extra)


def shard_batch(batch: Any, mesh: Any,
                leading_specs: Optional[Dict[str, PartitionSpec]] = None
                ) -> Any:
    """A :class:`NamedSharding` tree for a batch: dim 0 over the batch
    axes where their product divides it, else replicated; scalars
    replicated; a leaf named in ``leading_specs`` takes that spec."""
    leading_specs = leading_specs or {}
    sizes = axis_sizes(mesh)

    def one(path, leaf):
        name = path_name(path)
        if name in leading_specs:
            return NamedSharding(mesh, leading_specs[name])
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return NamedSharding(mesh, P())
        spec = batch_spec(mesh)
        bsz = _mesh_axis_size(mesh, tuple(n for n in BATCH if n in sizes))
        if shape[0] % bsz != 0:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P(*spec, *([None] * (len(shape) - 1))))

    return unflatten(batch, [one(p, leaf)
                             for p, leaf in flatten_with_path(batch)])


def replicated(mesh: Any, tree: Any) -> Any:
    return tree_map(lambda _: NamedSharding(mesh, P()), tree)


# ------------------------------------------------------------ placements ---
def placements(mesh: Any, spec: Sequence) -> Tuple:
    """DTensor placements of a resolved spec, one a mesh dimension:
    ``Shard(d)`` on each mesh dimension that dimension ``d``'s entry
    names, ``Replicate()`` on the others.  The names of a tuple entry
    must come in mesh order (DTensor nests them so)."""
    names = list(axis_sizes(mesh))
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {names[i]!r} shards two dimensions "
                                 f"in {tuple(spec)!r}")
            out[i] = Shard(d)
    return tuple(out)


def local_shard(full: torch.Tensor, mesh: Any, places: Sequence
                ) -> torch.Tensor:
    """This rank's block of ``full`` under ``places``: a view, no copy
    and no communication (every resolved spec divides exactly)."""
    coord = mesh.get_coordinate()
    x = full
    for i, pl in enumerate(places):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if x.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(full.shape)} does "
                                 f"not divide over {n} ranks")
            size = x.shape[pl.dim] // n
            x = x.narrow(pl.dim, coord[i] * size, size)
    return x


def sharding_of(x: DTensor) -> NamedSharding:
    """The :class:`NamedSharding` that lays ``x`` out (the inverse of
    :func:`placements`)."""
    mesh = x.device_mesh
    names = list(axis_sizes(mesh))
    entries: List[List[str]] = [[] for _ in range(x.dim())]
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(names[i])
    return NamedSharding(mesh, P(*(None if not e else e[0] if len(e) == 1
                                   else tuple(e) for e in entries)))


def place(full: torch.Tensor, sharding: Optional[NamedSharding]) -> Any:
    """``full`` (the same on every rank) as a DTensor under ``sharding``,
    from this rank's block: a view of ``full``, so on a one-rank mesh
    nothing is copied.  Without a mesh (``sharding`` or its mesh None),
    ``full`` itself."""
    if sharding is None or sharding.mesh is None:
        return full
    mesh = sharding.mesh
    places = sharding.placements
    return DTensor.from_local(local_shard(full, mesh, places), mesh, places,
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def rewrap(local: torch.Tensor, like: Any) -> Any:
    """``local`` as the block of a DTensor laid out as ``like``;
    ``local`` itself where ``like`` is no DTensor."""
    if not isinstance(like, DTensor):
        return local
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def is_sharded(x: Any) -> bool:
    return isinstance(x, DTensor)


def mesh_of(tree: Any) -> Optional[Any]:
    """The mesh of ``tree``'s first leaf where it is a DTensor, else
    None."""
    first = leaves(tree)
    return first[0].device_mesh if first and is_sharded(first[0]) else None


def gather_except(x: Any, axis: str) -> Any:
    """The local tensor of ``x`` gathered over every mesh dimension but
    ``axis``, along which it stays this rank's block; where those
    dimensions do not shard it or have one rank each, its local tensor
    itself (nothing is allocated).  Anything but a DTensor as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    keep = list(axis_sizes(mesh)).index(axis)
    if all(i == keep or not isinstance(pl, Shard) or mesh.size(i) == 1
           for i, pl in enumerate(x.placements)):
        return x.to_local()
    return x.redistribute(mesh, [pl if i == keep else Replicate()
                                 for i, pl in enumerate(x.placements)]
                          ).to_local()


def block_except(y: torch.Tensor, like: Any, axis: str) -> torch.Tensor:
    """This rank's block of ``y``, a tensor already cut along ``axis`` as
    the DTensor ``like`` is and whole along its other mesh dimensions,
    cut along those as ``like`` is (``y`` itself where ``like`` is no
    DTensor)."""
    if not isinstance(like, DTensor):
        return y
    mesh = like.device_mesh
    keep = list(axis_sizes(mesh)).index(axis)
    return local_shard(y, mesh, [Replicate() if i == keep else pl
                                 for i, pl in enumerate(like.placements)])


def full_tensor(x: Any) -> Any:
    """The whole tensor of ``x``, gathered over the mesh dimensions that
    shard it; where each of those has one rank, its local tensor itself
    (nothing is allocated).  Anything but a DTensor as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    if all(not isinstance(pl, Shard) or mesh.size(i) == 1
           for i, pl in enumerate(x.placements)):
        return x.to_local()
    return x.full_tensor()
