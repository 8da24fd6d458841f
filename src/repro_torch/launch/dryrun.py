"""Dry run of every (arch x shape x mesh) cell, the port of
``repro.launch.dryrun``: the port's own step traced at the published
widths on the production meshes, with no card and no data, and counted
against the H100.

For each cell:

  * a ``"fake"`` process group of the mesh's size is initialized at rank
    0 (no rank runs; a collective returns at once) and the mesh is built
    over it by ``launch.mesh``;
  * rank 0's tensors are made as the card would hold them, on the
    ``meta`` device (shapes and dtypes, no storage), inside
    ``device.dry_running``: every wrapper then takes the card's route and
    charges each hand kernel's launch to the count
    (``kernels.cuda_lib.CudaKernel.charged``, ``kernels.costs``);
  * the cell's step runs once under a counting ``TorchDispatchMode``
    (:class:`Count`; with ``flop_counter``, ``FlopCounterMode`` beside
    it, whose total the count's aten dot FLOPs must equal), and its dot
    FLOPs by dtype, bytes, collectives, kernel charges and memory are
    turned into the card's roofline terms (``launch.roofline``).

The steps.  A train cell (LM ``train_4k``, recsys ``train_batch``, every
GNN cell) is the bundle's train step on DTensor params and optimizer
state placed by the bundle's shardings.  An LM or recsys cell is given
the global batch as the port's trainer takes it: data-parallel over the
batch axes and, for the LM, tensor- and expert-parallel over ``model``
(the recsys tables where their rows lie).  A GNN cell is given its batch
placed by the cell's ``input_sharding``, as the reference lays it out,
and computes each rank's node rows and edge block
(``distributed.graph_parallel``): on (16, 16) Cora and ogbn-products
are whole on every rank, the sampled cell and the molecules split over
``data``; on (2, 16, 16) Cora, the sampled cell and the molecules split
over the batch axes or ``pod``, ogbn-products' edges over ``pod``.  A serve cell is the
bundle's serve step (``LMBundle.serve_step``, ``RecsysBundle
.serve_step``, which real runs call too) on the serving layout's
weights (``cfg.dtype``) placed by the rules and the batch placed by the
cell's ``input_sharding``, as the reference's GSPMD cells lay them out.
An LM serve cell (``prefill_32k``, ``decode_32k``, ``long_500k``)
gathers each weight over the batch axes and computes on its ``model``
shard, and a decode cell's cache is cut over the batch axes and over
``model`` on its sequence.  A recsys serve cell (``serve_p99``,
``serve_bulk``, ``retrieval_cand``) looks DLRM's and two-tower's tables
up where their rows lie and computes their MLPs on their ``model``
columns, gathers DIN's and SASRec's tables whole, scores a rank's rows
of the batch, and in ``retrieval_cand`` ranks a rank's block of the
candidates (split over the batch axes from 1,000,000 rows) and merges
the blocks' top 100 over those axes.

What is counted, for rank 0:

  * ``flops``: dot FLOPs, from ``FlopCounterMode``'s formulas
    (``torch.utils.flop_counter.flop_registry``) for each aten op (filed by its operands' dtype: bf16 runs on the
    tensor cores, f32 outside them) plus each kernel charge's operations
    (filed under its rate);
  * ``bytes_accessed``: each aten op's tensor inputs plus its outputs,
    views and allocations free (in eager mode every op is a launch, the
    counterpart of the reference's "one top-level instruction = one
    kernel"), plus each kernel charge's bytes;
  * ``collectives``: every c10d and functional collective, its kind, its
    group's size and ranks, its result bytes and ring wire bytes
    (``roofline.wire_bytes``); ``cross_node_bytes`` are the wire bytes
    of groups whose ranks sit on more than one node;
    ``model_collectives`` are the ``c10d`` collectives over the mesh's
    ``model`` group (``tensor_parallel``'s all-reduces, gathers and
    reduce-scatters, and the lookups' sums over ``model``), beside
    ``MODEL_COLLECTIVES``' count over the same trace, and the counts of
    ``row_parallel``'s lookups (``ROW_COLLECTIVES``) and retrieval merges
    (``MERGE_COLLECTIVES``) and of ``graph_parallel``'s route
    (``GRAPH_COLLECTIVES``);
  * ``memory``: ``argument_size`` (the rank's blocks of the params,
    optimizer state and batch, as the reference's in_shardings cut them;
    its params are f32 masters in every cell, where the port serves from
    ``cfg.dtype``, and a serve cell's are those it reads:
    ``serve_params``),
    ``batch_held`` (the batch as the port's step takes it), the peak of
    the bytes of live storages during the step (tracked through
    ``weakref.finalize`` on each storage, so the count holds none alive),
    ``temp_size`` = peak - the arguments held, ``output_size`` and
    whether the peak fits the card.

Results are written one JSON a cell under ``build/dryrun/``, which
``launch.roofline`` reads.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs.families import abstract
from repro_torch.configs.registry import ARCH_IDS, get_bundle, shape_cells
from repro_torch.device import dry_running
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.graph_parallel import GRAPH_COLLECTIVES
from repro_torch.distributed.row_parallel import (
    MERGE_COLLECTIVES,
    ROW_COLLECTIVES,
)
from repro_torch.distributed.tensor_parallel import MODEL, MODEL_COLLECTIVES
from repro_torch.launch import roofline
from repro_torch.launch.mesh import HW, make_mesh
from repro_torch.tree import leaves, tree_map

OUT_DIR = os.path.join(os.path.dirname(__file__), "../../../build/dryrun")

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "host": ((1, 1), ("data", "model"))}

# ops that move no data: views, allocations that write nothing, and the
# collectives' own bookkeeping
_FREE = {"aten::empty", "aten::empty_like", "aten::empty_strided",
         "aten::new_empty", "aten::new_empty_strided", "aten::detach",
         "aten::alias", "aten::lift_fresh", "aten::_unsafe_view",
         "_c10d_functional::wait_tensor",
         "_c10d_functional::_wrap_tensor_autograd"}

_KINDS = {"allreduce_": "all-reduce", "all_reduce": "all-reduce",
          "allgather_": "all-gather", "_allgather_base_": "all-gather",
          "allgather_into_tensor_coalesced_": "all-gather",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_out": "all-gather",
          "reduce_scatter_": "reduce-scatter",
          "_reduce_scatter_base_": "reduce-scatter",
          "reduce_scatter_tensor": "reduce-scatter",
          "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
          "all_to_all_single": "all-to-all",
          "broadcast_": "broadcast", "broadcast": "broadcast",
          "send": "send", "recv_": "send"}


def _tensors(x: Any):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _float_name(dtype: torch.dtype) -> str:
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


class Count:
    """What a traced step did on rank 0: see the module's docstring.
    ``charge`` is the dry run's side of ``CudaKernel.charged``."""

    def __init__(self, axis_of: Dict[str, str], model_group: Optional[str]):
        self.axis_of = dict(axis_of)    # group name -> its mesh axis
        self.model_group = model_group
        self.groups: Dict[str, Sequence[int]] = {}   # group name -> ranks
        self.flops: Dict[str, float] = {}
        self.aten_flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.coll: Dict[str, Dict[str, float]] = {}
        self.by_axis: Dict[str, Dict[str, float]] = {}
        self.node_wire = 0.0
        self.cross_node_wire = 0.0
        self.model_collectives = 0
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}

    # -- memory -----------------------------------------------------------
    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live until it is freed (once a storage)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    # -- kernels ----------------------------------------------------------
    def charge(self, name: str, cost) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += cost.flops
        k["bytes"] += cost.nbytes
        self.flops[cost.dtype] = self.flops.get(cost.dtype, 0.0) + cost.flops
        self.bytes += cost.nbytes

    # -- ops ----------------------------------------------------------------
    def op(self, func, args, kwargs, out) -> None:
        self.ops += 1
        name = func._schema.name
        outs = list(_tensors(out))
        for t in outs:
            self.hold(t)
        if func.namespace in ("c10d", "_c10d_functional"):
            kind = _KINDS.get(name.split("::")[1])
            if kind is not None:
                self._collective(func, kind, args, kwargs, outs)
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            ins = list(_tensors(args))
            dt = _float_name(ins[0].dtype if ins else torch.float32)
            self.flops[dt] = self.flops.get(dt, 0.0) + f
            self.aten_flops += f
        if func.is_view or name in _FREE:
            return
        self.bytes += sum(_nbytes(t) for t in _tensors(args)) \
            + sum(_nbytes(t) for t in _tensors(kwargs)) \
            + sum(_nbytes(t) for t in outs)

    def _collective(self, func, kind, args, kwargs, outs) -> None:
        group = None
        named = dict(zip((a.name for a in func._schema.arguments), args))
        named.update(kwargs)
        if "process_group" in named:
            group = dist.ProcessGroup.unbox(named["process_group"]).group_name
        elif "group_name" in named:
            group = named["group_name"]
        ranks = self.groups.get(group)
        if ranks is None:
            ranks = self.groups[group] = dist.get_process_group_ranks(
                dist.distributed_c10d._resolve_process_group(group))
        n = len(ranks)
        if kind == "all-gather" or kind == "all-to-all":
            result = sum(_nbytes(t) for t in outs)
        else:
            tensors = named.get("tensors", named.get("input"))
            result = sum(_nbytes(t) for t in _tensors(
                outs if tensors is None or kind == "reduce-scatter"
                else tensors))
        wire = roofline.wire_bytes(kind, n, result)
        c = self.coll.setdefault(kind, {"count": 0, "result_bytes": 0,
                                        "wire_bytes": 0.0})
        c["count"] += 1
        c["result_bytes"] += result
        c["wire_bytes"] += wire
        cross = roofline.spans_nodes(ranks)
        if cross:
            self.cross_node_wire += wire
        else:
            self.node_wire += wire
        axis = self.axis_of.get(group, f"ranks {ranks[0]}..{ranks[-1]} "
                                       f"({n})")
        a = self.by_axis.setdefault(axis, {"count": 0, "wire_bytes": 0.0,
                                           "ranks": n, "cross_node": cross})
        a["count"] += 1
        a["wire_bytes"] += wire
        if func.namespace == "c10d" and group == self.model_group:
            self.model_collectives += 1

    def collectives(self) -> Dict:
        return {
            "counts": {k: int(v["count"]) for k, v in self.coll.items()},
            "result_bytes": {k: int(v["result_bytes"])
                             for k, v in self.coll.items()},
            "wire_bytes": {k: int(v["wire_bytes"])
                           for k, v in self.coll.items()},
            "total_wire_bytes": int(self.node_wire + self.cross_node_wire),
            "by_axis": {k: {**v, "wire_bytes": int(v["wire_bytes"])}
                        for k, v in self.by_axis.items()},
        }


class Counting(TorchDispatchMode):
    """Feeds every dispatched op and its result to a :class:`Count`."""

    def __init__(self, count: Count):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.count.op(func, args, kwargs, out)
        return out


# ------------------------------------------------------------ the cells --
@dataclasses.dataclass
class Step:
    """One cell's step on rank 0: ``fn(*args)``, the arguments as the
    reference's in_shardings cut them (``argument_size``) and as the
    port's step holds them."""
    kind: str
    fn: Any
    args: Tuple
    argument_size: int
    held: Sequence[torch.Tensor]


def _local_shape(shape, placements, mesh) -> Tuple[int, ...]:
    out = list(shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, shd.Shard):
            n = mesh.size(i)
            if out[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                                 f"divide over {n} ranks")
            out[pl.dim] //= n
    return tuple(out)


def _placed(meta: torch.Tensor, sharding, mesh) -> Any:
    """A DTensor of ``meta``'s shape laid out by ``sharding``, rank 0's
    block on the meta device."""
    pl = sharding.placements
    local = torch.empty(_local_shape(meta.shape, pl, mesh), dtype=meta.dtype,
                        device="meta")
    return shd.DTensor.from_local(
        local, mesh, pl, run_check=False, shape=meta.shape,
        stride=torch.empty(meta.shape, device="meta").stride())


def _shard_bytes(meta_tree, shardings, mesh) -> int:
    return sum(
        torch.Size(_local_shape(m.shape, s.placements, mesh)).numel()
        * m.element_size()
        for m, s in zip(leaves(meta_tree), leaves(shardings)))


def _fresh(meta_tree) -> Any:
    return tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype,
                                          device="meta"), meta_tree)


def _train_step(bundle, cell: str):
    if bundle.family == "gnn":
        return bundle.cell_specs[cell].train_step()
    if bundle.family == "recsys":
        return bundle.training.train_step()
    return bundle.train_step()


def _train_params(bundle, cell: str):
    if bundle.family == "gnn":
        return abstract(bundle.cell_specs[cell].init)
    return bundle.abstract_params()


def cell_step(bundle, cell: str, mesh) -> Step:
    """Rank 0's step of ``cell`` on ``mesh``, its arguments on the meta
    device."""
    from repro_torch.train.trainer import opt_init

    inputs = bundle.abstract_inputs(cell)["batch"]
    ishard = bundle.input_sharding(cell, mesh)["batch"]
    ishard = shd.sanitize_shardings(ishard, inputs, mesh)
    batch_shard = _shard_bytes(inputs, ishard, mesh)
    if _is_train(bundle, cell):
        meta = _train_params(bundle, cell)
        pshard = shd.shard_by_rules(meta, mesh, bundle.rules)
        params = tree_map(lambda m, s: _placed(m, s, mesh), meta, pshard)
        opt = opt_init(params)
        # a GNN cell computes on the reference's layout of its batch (the
        # trainer keeps a placed batch as it lies); the LM's and the
        # recsys family's take the global batch, placed by the trainer
        batch = (tree_map(lambda m, s: _placed(m, s, mesh), inputs, ishard)
                 if bundle.family == "gnn" else _fresh(inputs))
        args = (params, opt, batch)
        # the params' blocks, AdamW's f32 mu and nu of each, its int32 step
        size = (_shard_bytes(meta, pshard, mesh)
                + 2 * _shard_bytes(tree_map(lambda m: m.float(), meta),
                                   pshard, mesh)
                + 4 + batch_shard)
        held = [t.to_local() if isinstance(t, shd.DTensor) else t
                for t in leaves((params, opt, batch))]
        return Step("train", _train_step(bundle, cell), args, size, held)
    # the reference's arguments are its f32 masters that the cell reads,
    # cut by the rules; the port's serve step holds the serving layout's
    # blocks
    meta = bundle.abstract_params()
    pshard = shd.shard_by_rules(meta, mesh, bundle.rules)
    serving = abstract(lambda g: bundle.init(g, masters=False))
    params = tree_map(lambda m, s: _placed(m, s, mesh), serving, pshard)
    batch = tree_map(lambda m, s: _placed(m, s, mesh), inputs, ishard)
    size = _shard_bytes(bundle.serve_params(cell, meta),
                        bundle.serve_params(cell, pshard), mesh) + batch_shard
    held = [t.to_local() for t in leaves((params, batch))]
    return Step("serve", bundle.serve_step(cell), (params, batch), size,
                held)


def _is_train(bundle, cell: str) -> bool:
    return bundle.family == "gnn" or cell in ("train_4k", "train_batch")


# ------------------------------------------------------------- the run --
def run(bundle, cell: str, mesh_shape: Tuple[int, ...],
        axes: Tuple[str, ...], flop_counter: bool = False) -> Dict:
    """Trace ``bundle``'s ``cell`` once on a ``mesh_shape`` mesh named
    ``axes`` over a fake process group (none may be initialized), and
    return its counts and roofline terms (the cell JSON's keys but the
    arch's and the mesh's names).  ``flop_counter`` runs
    ``FlopCounterMode`` beside the count (about 40% more trace time) and
    reports its total as ``flop_counter_total`` (else None)."""
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "one is already initialized")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 1
    for n in mesh_shape:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        return _traced(bundle, cell, mesh_shape, axes, world,
                       flop_counter)
    finally:
        dist.destroy_process_group()


def _traced(bundle, cell, mesh_shape, axes, world, flop_counter) -> Dict:
    # the mesh's groups are the fake group's; its blocks are meta tensors,
    # which a DeviceMesh of any device type takes as they are.  One of
    # type cuda would pick a card (set_device) on some PyTorch versions:
    # the dry run touches none.
    mesh = make_mesh(tuple(mesh_shape), tuple(axes), device="cpu")
    axis_of = {mesh.get_group(a).group_name: a for a in axes}
    count = Count(axis_of, next((g for g, a in axis_of.items()
                                 if a == MODEL), None))
    with dry_running(count):
        step = cell_step(bundle, cell, mesh)
        for t in step.held:
            count.hold(t)
        held = count.live
        for counter in (MODEL_COLLECTIVES, ROW_COLLECTIVES, MERGE_COLLECTIVES,
                        GRAPH_COLLECTIVES):
            counter.reset()
        fc = FlopCounterMode(display=False) if flop_counter else None
        t0 = time.time()
        with fc or contextlib.nullcontext(), Counting(count):
            out = step.fn(*step.args)
        trace_s = time.time() - t0
        out_bytes = sum(st.nbytes() for st in {
            t.untyped_storage()._cdata: t.untyped_storage()
            for t in _tensors(out) if not isinstance(t, shd.DTensor)
            and t.untyped_storage()._cdata in count._seen}.values())
        flops = dict(count.flops)
        terms = roofline.roofline_terms(flops, count.bytes, count.node_wire,
                                        count.cross_node_wire)
        result = {
            "n_chips": int(world),
            "mesh_shape": list(mesh_shape),
            "kind": step.kind,
            "trace_s": round(trace_s, 2),
            "ops": count.ops,
            "flops": sum(flops.values()),
            "flops_by_dtype": flops,
            "aten_dot_flops": count.aten_flops,
            "flop_counter_total": (None if fc is None
                                   else float(fc.get_total_flops())),
            "bytes_accessed": count.bytes,
            "cross_node_bytes": count.cross_node_wire,
            "collectives": count.collectives(),
            "model_collectives": count.model_collectives,
            "model_collectives_counted": MODEL_COLLECTIVES.count,
            "row_collectives_counted": ROW_COLLECTIVES.count,
            "merge_collectives_counted": MERGE_COLLECTIVES.count,
            "graph_collectives_counted": GRAPH_COLLECTIVES.count,
            "kernels": count.kernels,
            "memory": {
                "argument_size": int(step.argument_size),
                "held_size": int(held),
                "output_size": int(out_bytes),
                "peak_size": int(count.peak),
                "temp_size": int(count.peak - held),
                "fits": count.peak <= HW["hbm_bytes"],
                "over_bytes": int(max(0, count.peak - HW["hbm_bytes"])),
            },
            "roofline": terms,
            "ok": True,
        }
        del out, step
    return result


def cell_path(arch: str, shape: str, mesh_name: str) -> str:
    return os.path.abspath(
        os.path.join(OUT_DIR, f"{arch}__{shape}__{mesh_name}.json"))


def run_cell(arch: str, shape: str, multi_pod: bool,
             save: bool = True, flop_counter: bool = False) -> Dict:
    """The dry run of ``arch``'s ``shape`` cell on the (16, 16) mesh, or
    with ``multi_pod`` the (2, 16, 16) one; with ``save`` written to
    :func:`cell_path`."""
    mesh_name = "multi" if multi_pod else "single"
    mesh_shape, axes = MESHES[mesh_name]
    result = {"arch": arch, "shape": shape, "mesh": mesh_name,
              **run(get_bundle(arch), shape, mesh_shape, axes,
                    flop_counter)}
    if save:
        _write(cell_path(arch, shape, mesh_name), result)
    return result


def _write(path: str, result: Dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)


def lm_cell(arch: str, batch: int, seq: int,
            microbatches: Optional[int] = None, cell: str = "train_4k"):
    """``arch``'s LM bundle with ``cell`` at ``batch`` x ``seq`` (a
    decode cell's slots x S_max) and ``train_4k`` in ``microbatches``
    (the bundle's own where None): the card's cross-checks run their own
    shapes."""
    from repro_torch.configs.families import lm_bundle

    b = get_bundle(arch)
    shapes = dict(b.shapes, **{cell: (batch, seq)})
    return lm_bundle(arch, b.config, shapes=shapes, opt=b.opt,
                     microbatches=(b.microbatches if microbatches is None
                                   else microbatches))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="")
    ap.add_argument("--shape", type=str, default="")
    ap.add_argument("--mesh", choices=["single", "multi", "both", "host"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-cached", action="store_true")
    ap.add_argument("--lm-train", type=str, default="",
                    help="B,S,M: an LM arch's train_4k at B x S in M "
                    "microbatches (with --arch, --shape train_4k)")
    ap.add_argument("--lm-serve", type=str, default="",
                    help="B,S: an LM arch's serve cell (--shape) at B x S "
                    "(with --arch)")
    ap.add_argument("--out", type=str, default="",
                    help="write the one cell's JSON here")
    ap.add_argument("--flop-counter", action="store_true",
                    help="run FlopCounterMode beside the count")
    args = ap.parse_args(argv)

    if args.lm_train or args.lm_serve or args.mesh == "host":
        if not args.arch or not args.shape:
            ap.error("--lm-train, --lm-serve and --mesh host take one "
                     "--arch and --shape")
        bundle = get_bundle(args.arch)
        if args.lm_train:
            B, S, M = (int(x) for x in args.lm_train.split(","))
            bundle = lm_cell(args.arch, B, S, M)
        if args.lm_serve:
            B, S = (int(x) for x in args.lm_serve.split(","))
            bundle = lm_cell(args.arch, B, S, cell=args.shape)
        if args.mesh == "both":
            ap.error("one cell takes one mesh")
        mesh_shape, axes = MESHES[args.mesh]
        r = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
             **run(bundle, args.shape, mesh_shape, axes, args.flop_counter)}
        if args.out:
            _write(args.out, r)
        print(_line(r))
        return 0

    cells = []
    archs = ARCH_IDS if (args.all or not args.arch) \
        else args.arch.split(",")
    for a in archs:
        shapes = shape_cells(a) if (args.all or not args.shape) \
            else args.shape.split(",")
        for s in shapes:
            cells.append((a, s))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for a, s in cells:
        for mp in meshes:
            mesh_name = "multi" if mp else "single"
            path = cell_path(a, s, mesh_name)
            if args.skip_cached and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        print(f"[cached] {a} x {s} x {mesh_name}")
                        continue
            try:
                print(_line(run_cell(a, s, mp, flop_counter=args.flop_counter)),
                      flush=True)
            except Exception as e:
                failures.append((a, s, mesh_name, repr(e)))
                traceback.print_exc()
                _write(path, {"arch": a, "shape": s, "mesh": mesh_name,
                              "ok": False, "error": repr(e)})
    print(f"\n{len(cells) * len(meshes) - len(failures)} ok, "
          f"{len(failures)} failed")
    for f_ in failures:
        print("FAIL:", f_)
    return 1 if failures else 0


def _line(r: Dict) -> str:
    """One line a cell: each term in ms, the dominant one, the peak."""
    t, m = r["roofline"], r["memory"]
    return (f"[ok] {r['arch']} x {r['shape']} x {r['mesh']}: "
            f"trace={r['trace_s']}s compute={t['compute_s'] * 1e3:.3f}ms "
            f"memory={t['memory_s'] * 1e3:.3f}ms "
            f"collective={t['collective_s'] * 1e3:.3f}ms "
            f"dominant={t['dominant']} "
            f"peak={m['peak_size'] / 1e9:.2f}/{HW['hbm_bytes'] / 1e9:.0f}GB"
            + ("" if m["fits"] else " (does not fit)"))


if __name__ == "__main__":
    raise SystemExit(main())
