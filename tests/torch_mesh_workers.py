"""One rank of the port's multi-process mesh tests, on a CPU gloo group
set up from a file store in DIR (no network):

    python tests/torch_mesh_workers.py CASE RANK WORLD DIR [DATA]

``psum``   ``compressed_psum`` of row RANK of ``DIR/psum_in.npy``, to
           ``DIR/psum_out_RANK.npy``;
``train``  on a (DATA, WORLD / DATA) ``("data", "model")`` mesh (DATA
           defaults to WORLD), from ``DIR/inputs.pt``: a mesh save of the
           initial LM params (``DIR/ckpt_init``), two ``Trainer`` steps of
           granite-3-2b REDUCED in f32 with a checkpoint (``DIR/ckpt``),
           an elastic restore of it onto this mesh, two steps of
           moonshot-v1-16b-a3b REDUCED in f32 (MoE), one step of it on a
           global batch of 2 x 3 tokens whose one dispatch group spans
           the batch ranks (fault 3) and its first layer's ``moe_apply``
           on such rows, one step of DLRM's and two-tower's REDUCED
           cells in f32 and one of a masked GNN cell; rank 0 writes the
           gathered results to ``DIR/train_out.pt``.
``tp``     on the same mesh, from ``DIR/tp_inputs.pt``: for each case
           (an LM config, its initial params and batches), ``Trainer``
           steps computing on the ``model`` shards, with the count of
           ``model`` collectives, the shapes each rank computed with and
           every rank's MoE drops, and each rank's ``compress_tree`` and
           ``global_norm`` of its shard of ``reduction_tree()``; rank 0
           writes ``DIR/tp_out.pt``.
``rows``   on the same mesh, from ``DIR/rows_inputs.pt``: for each
           recsys case (an arch, its f32 params and batches),
           ``Trainer`` steps computing on the tables where their rows
           lie and on the MLPs' columns (``row_parallel``), with the
           counts of lookup and ``model`` collectives, the shapes each
           rank computed with, every rank's blocks of the final params,
           and DLRM's scores of a batch of out-of-range ids on the
           mesh; and the lookup of one table nested over ``("data",
           "model")`` with its block's gradient; rank 0 writes
           ``DIR/rows_out.pt``.
``serve``  on the same mesh, from ``DIR/serve_inputs.pt``: for each LM
           case (an arch, config changes, its serving params, a prompt, a
           decode cache and the tokens of its steps), the bundle's serve
           steps on the ``model`` shards (``LMBundle.serve_step``): the
           prompt's prefill, then the decode steps on the cache placed by
           the cell's sharding (its sequence split over ``model``); every
           rank's logits, prefill K/V, final cache blocks and MoE drops,
           and the count of ``model`` collectives; rank 0 writes
           ``DIR/serve_out.pt``.
``recsysserve``  on the same mesh, from ``DIR/recsysserve_inputs.pt``:
           for each recsys arch (its f32 serving params and its calls:
           a cell, a batch and whether the candidates are split over
           ``data``), the bundle's serve step (``RecsysBundle
           .serve_step``) on the params placed by the rules and the
           batch placed by the cell's sharding (:func:`serve_layout`);
           every rank's scores or ids and the counts of lookup,
           ``model`` and merge collectives; rank 0 writes
           ``DIR/recsysserve_out.pt``.
``gnn``    on the mesh of ``DIR/gnn_inputs.pt`` (its shape and axis
           names; DATA is unused), for each GNN case (a REDUCED cell, f32
           params, a batch, and whether the trainer places it or the
           cell's ``input_sharding`` does): one ``Trainer`` step on the
           node and edge blocks (``graph_parallel``) with the count of
           the route's collectives, the step's gradient (the ranks'
           shares summed over the batch axes) and where every rank's
           blocks lie,
           the same step without a mesh where the case asks, and
           ``gather_nodes`` / ``sum_to_owners`` of a test function on the
           case's blocks with its gradient; rank 0 writes
           ``DIR/gnn_out.pt``.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt.checkpoint import save_checkpoint
from repro_torch.configs.families import REDUCED_LM_CELL_SHAPES, lm_bundle
from repro_torch.configs.registry import get_bundle, get_config, get_training
from repro_torch.distributed.compression import compress_tree, compressed_psum
from repro_torch.distributed.sharding import (
    RECSYS_RULES,
    full_tensor,
    place,
    rewrap,
    shard_by_rules,
)
from repro_torch.distributed.hooks import batch_axes, use_mesh
from repro_torch.distributed.sharding import gather_except
from repro_torch.distributed.tensor_parallel import (
    MODEL_COLLECTIVES,
    model_group_of,
)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.moe import moe_apply
from repro_torch.models.transformer import lm_model_dims
from repro_torch.train.optim import global_norm
from repro_torch.train.trainer import (
    Trainer,
    TrainerConfig,
    opt_init,
    value_and_grad,
)
from repro_torch.tree import flatten_with_path, path_name, tree_map

LM_MICROBATCHES = 2
RECSYS_DP = ("dlrm-mlperf", "two-tower-retrieval")
MOE_ARCH = "moonshot-v1-16b-a3b"


def lm_bundle_f32(arch: str = "granite-3-2b", dispatch: str = "",
                  **changes):
    """The arch's REDUCED LM bundle computing in f32 (``changes`` to its
    config, e.g. ``n_kv_heads``; an MoE ``dispatch`` route)."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype=torch.float32, **changes)
    if dispatch:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    return lm_bundle(arch, cfg, shapes=REDUCED_LM_CELL_SHAPES)


def reduction_tree():
    """A gradient tree whose largest value lies in the first columns of
    its leaf ``a``, so that a shard's own int8 scale is not its leaf's."""
    g = torch.Generator().manual_seed(7)
    a = torch.randn(8, 6, generator=g)
    a[2, 0] = 40.0
    return {"a": a, "b": torch.randn(5, generator=g)}


def every_rank(value):
    """``value`` of every rank, in rank order (on every rank)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def recsys_f32(arch: str):
    """The arch's REDUCED training cell computing in f32."""
    tr = get_training(arch, reduced=True)
    return dataclasses.replace(
        tr, config=dataclasses.replace(tr.config, dtype=torch.float32))


def recsys_bundle_f32(arch: str):
    """The arch's REDUCED recsys bundle computing (and serving) in f32."""
    b = get_bundle(arch, reduced=True)
    cfg = dataclasses.replace(b.config, dtype=torch.float32)
    return dataclasses.replace(
        b, serving=dataclasses.replace(b.serving, config=cfg),
        training=dataclasses.replace(b.training, config=cfg))


def serve_layout(bundle, cell: str, batch: dict, mesh, split: bool) -> dict:
    """The shardings of a serve cell's ``batch`` on ``mesh``: the cell's
    own (``input_sharding``, fitted to the shapes), or with ``split`` its
    retrieval candidates (and every input of as many rows) over
    ``data``."""
    from repro_torch.distributed.sharding import (
        NamedSharding,
        P,
        sanitize_shardings,
    )

    own = sanitize_shardings(bundle.input_sharding(cell, mesh)["batch"],
                             batch, mesh)
    if not split:
        return own
    n = batch["candidates" if "candidates" in batch
              else "candidate_embs"].shape[0]
    return {k: NamedSharding(mesh, P("data", *([None] * (v.dim() - 1))))
            if v.dim() and v.shape[0] == n else own[k]
            for k, v in batch.items()}


def lm_trainer(bundle, params, mesh, ckpt_dir):
    placed = tree_map(place, params, bundle.param_shardings(mesh))
    cfg = TrainerConfig(opt=bundle.opt, microbatches=LM_MICROBATCHES,
                        ckpt_dir=ckpt_dir, ckpt_every=100, log_every=1)
    return Trainer(bundle.loss_fn(), placed, cfg, device="cpu")


def gathered(tree):
    return tree_map(lambda t: full_tensor(t).clone(), tree)


def train(rank: int, world: int, d: str, data: int) -> None:
    inputs = torch.load(os.path.join(d, "inputs.pt"))
    mesh = make_mesh((data, world // data), ("data", "model"), device="cpu")
    bundle = lm_bundle_f32()
    out = {}

    init = tree_map(place, inputs["lm_params"], bundle.param_shardings(mesh))
    save_checkpoint(os.path.join(d, "ckpt_init"), 0, init,
                    opt_init(init), data_cursor=0)

    tr = lm_trainer(bundle, inputs["lm_params"], mesh,
                    os.path.join(d, "ckpt"))
    batches = inputs["lm_batches"]
    tr.fit(lambda c: batches[c], len(batches))
    dist.barrier()
    out["lm_losses"] = [h["loss"] for h in tr.history]
    out["lm_params"] = gathered(tr.params)
    out["lm_mu"] = gathered(tr.opt_state["mu"])

    # elastic restore onto this mesh from other starting values
    fresh = tree_map(torch.zeros_like, inputs["lm_params"])
    again = lm_trainer(bundle, fresh, mesh, os.path.join(d, "ckpt"))
    assert again.try_resume(bundle.param_shardings(mesh),
                            bundle.opt_shardings(mesh))
    out["restored_step"] = again.step_num
    out["restored_params"] = gathered(again.params)
    # and as the trainer's own params are laid out (no shardings given)
    own = lm_trainer(bundle, fresh, mesh, os.path.join(d, "ckpt"))
    assert own.try_resume()
    out["restored_own"] = gathered(own.params)
    out["restored_own_mu"] = gathered(own.opt_state["mu"])

    moe = lm_bundle_f32(MOE_ARCH)
    tr = lm_trainer(moe, inputs["moe_params"], mesh, None)
    tr.fit(lambda c: inputs["moe_batches"][c], len(inputs["moe_batches"]))
    out["moe_losses"] = [h["loss"] for h in tr.history]
    out["moe_params"] = gathered(tr.params)

    # fault 3: 2 x 3 tokens, one dispatch group of 6 over the batch ranks
    span = inputs["span"]
    tr = Trainer(moe.loss_fn(), tree_map(place, span["params"],
                                         moe.param_shardings(mesh)),
                 TrainerConfig(opt=moe.opt, log_every=1), device="cpu")
    tr.fit(lambda c: span["batch"], 1)
    out["span_loss"] = tr.history[0]["loss"]
    out["span_params"] = gathered(tr.params)
    out["span_dropped"] = every_rank(
        (mesh.get_coordinate(), tr.loss_fn.take_dropped()))
    layer0 = tree_map(lambda t: t[0], span["params"]["block"]["moe"])
    rows = span["x"].shape[0] // mesh.size(0)
    r = mesh.get_coordinate()[0]
    with use_mesh(mesh):
        y, aux = moe_apply(layer0, span["x"][r * rows:(r + 1) * rows],
                           moe.config.moe, dtype=torch.float32,
                           batch=batch_axes())
    out["span_moe"] = torch.cat(every_rank(y)[::world // data])
    out["span_moe_dropped"] = every_rank(
        (mesh.get_coordinate(), float(aux["dropped_tokens"])))

    for arch in RECSYS_DP:
        tr = recsys_f32(arch)
        rp = tree_map(place, inputs[arch]["params"],
                      shard_by_rules(inputs[arch]["params"], mesh,
                                     RECSYS_RULES))
        rp, _, metrics = tr.train_step()(rp, opt_init(rp),
                                         inputs[arch]["batch"])
        out[arch] = {"loss": float(metrics["loss"]), "params": gathered(rp)}

    gnn = get_bundle("mace", reduced=True)
    cell = gnn.cell_specs["minibatch_lg"]
    gp = tree_map(place, inputs["gnn_params"], gnn.param_shardings(mesh))
    gp, _, metrics = cell.train_step()(gp, opt_init(gp),
                                       inputs["gnn_batch"])
    out["gnn_loss"] = float(metrics["loss"])
    out["gnn_params"] = gathered(gp)
    if rank == 0:
        torch.save(out, os.path.join(d, "train_out.pt"))


def tp(rank: int, world: int, d: str, data: int) -> None:
    """Each case of ``DIR/tp_inputs.pt`` (name -> arch, config changes,
    params, batches, microbatches) through ``Trainer`` on the mesh."""
    cases = torch.load(os.path.join(d, "tp_inputs.pt"))
    mesh = make_mesh((data, world // data), ("data", "model"), device="cpu")
    mg = model_group_of(mesh)
    out = {}
    for name, case in cases.items():
        bundle = lm_bundle_f32(case["arch"], **case["changes"])
        placed = tree_map(place, case["params"],
                          bundle.param_shardings(mesh))
        dims = lm_model_dims(bundle.config, placed, mg)
        shapes = {path_name(p): tuple(gather_except(t, "model").shape)
                  for (p, t), (_, dm) in zip(flatten_with_path(placed),
                                             flatten_with_path(dims))
                  if dm is not None}
        tr = Trainer(bundle.loss_fn(), placed,
                     TrainerConfig(opt=bundle.opt,
                                   microbatches=case["microbatches"],
                                   log_every=1), device="cpu")
        MODEL_COLLECTIVES.reset()
        with use_mesh(mesh):
            tr.fit(lambda c: case["batches"][c], len(case["batches"]))
        out[name] = {
            "losses": [h["loss"] for h in tr.history],
            "params": gathered(tr.params),
            "shapes": shapes,
            "collectives": MODEL_COLLECTIVES.count,
            "dropped": every_rank((mesh.get_coordinate(),
                                   tr.loss_fn.take_dropped())),
        }
    # the step's reductions over a tree of one model shard and one whole
    # leaf: each rank's columns of the 8 x 6 leaf of REDUCTION_TREE
    whole = reduction_tree()
    k = whole["a"].shape[1] // mg.size
    own = {"a": whole["a"][:, mg.rank * k:(mg.rank + 1) * k],
           "b": whole["b"]}
    dims = {"a": 1, "b": None}
    out[f"reductions_{data}x{world // data}"] = every_rank(
        (mg.rank, compress_tree(own, dims, mg), global_norm(own, dims, mg)))
    if rank == 0:
        torch.save(out, os.path.join(d, "tp_out.pt"))


def local_params(params, dims):
    """What a step computes with (the trainer's own rule)."""
    from repro_torch.train.trainer import _compute_leaf

    return tree_map(_compute_leaf, params, dims)


def declared(placed, loss, mg):
    """The loss's declaration of each leaf, a ``LOCAL`` filled in from the
    leaf as the train step fills it."""
    from repro_torch.distributed.leaf_kinds import Local, local_of

    return tree_map(lambda p, k: local_of(p) if isinstance(k, Local) else k,
                    placed, loss.model_dims(placed, mg))


def rows(rank: int, world: int, d: str, data: int) -> None:
    """Each recsys case of ``DIR/rows_inputs.pt`` through ``Trainer`` on
    the mesh, the out-of-range scores and the nested lookup."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed.hooks import local
    from repro_torch.distributed.leaf_kinds import local_of
    from repro_torch.distributed.row_parallel import (
        ROW_COLLECTIVES,
        block_rows,
        lookup_rows,
        row_shard,
    )
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.distributed.tensor_parallel import use_model_group
    from repro_torch.models import recsys as RS

    inputs = torch.load(os.path.join(d, "rows_inputs.pt"))
    mesh = make_mesh((data, world // data), ("data", "model"), device="cpu")
    mg = model_group_of(mesh)
    coord = tuple(mesh.get_coordinate())
    out = {}
    for name, case in inputs["cases"].items():
        tr = recsys_f32(case["arch"])
        placed = tree_map(place, case["params"],
                          shard_by_rules(case["params"], mesh, RECSYS_RULES))
        loss = tr.loss_fn()
        dims = declared(placed, loss, mg)
        shapes = {path_name(p): tuple(t.shape) for (p, t), (_, k) in zip(
            flatten_with_path(local_params(placed, dims)),
            flatten_with_path(dims)) if k is not None}
        trainer = Trainer(loss, placed, TrainerConfig(
            opt=tr.opt, log_every=1), device="cpu")
        ROW_COLLECTIVES.reset()
        MODEL_COLLECTIVES.reset()
        with use_mesh(mesh):
            trainer.fit(lambda c: case["batches"][c], len(case["batches"]))
        out[name] = {
            "losses": [h["loss"] for h in trainer.history],
            "params": gathered(trainer.params),
            "shapes": shapes,
            "axes": {path_name(p): local_of(t).axes
                     for p, t in flatten_with_path(trainer.params)},
            "locals": every_rank((coord, {
                path_name(p): t.to_local().clone()
                for p, t in flatten_with_path(trainer.params)})),
            "row_collectives": ROW_COLLECTIVES.count,
            "model_collectives": MODEL_COLLECTIVES.count,
        }

    # DLRM's scores of a batch with out-of-range ids, under fill
    bad = inputs["bad"]
    tr = recsys_f32("dlrm-mlperf")
    placed = tree_map(place, bad["params"],
                      shard_by_rules(bad["params"], mesh, RECSYS_RULES))
    loss = tr.loss_fn()
    dims = declared(placed, loss, mg)
    n = bad["batch"]["dense"].shape[0] // data
    mine = {k: v[coord[0] * n:(coord[0] + 1) * n]
            for k, v in bad["batch"].items()}
    with use_mesh(mesh), use_model_group(mg), torch.no_grad():
        scores = RS.dlrm_forward(tr.config, local_params(placed, dims), mine,
                                 RS.recsys_plan(tr.config))
    out["bad_scores"] = torch.cat([s for c, s in every_rank((coord, scores))
                                   if c[1] == 0])

    # one table nested over ("data", "model"): each rank's ids read every
    # block's rows, and out-of-range ones
    lk = inputs["lookup"]
    table = place(lk["table"], NamedSharding(mesh, P(("data", "model"),
                                                     None)))
    assert all(isinstance(pl, Shard) for pl in table.placements)
    shard = row_shard(mesh, ("data", "model"), lk["table"].shape[0])
    n = lk["ids"].shape[0] // data
    ids = lk["ids"][coord[0] * n:(coord[0] + 1) * n]
    block = local(table).clone().requires_grad_(True)
    rows_ = lookup_rows(ids, shard, lambda g: block_rows(
        block, g, shard.window, torch.float32))
    w = lk["weights"][coord[0] * n:(coord[0] + 1) * n]
    torch.where(torch.isnan(rows_), 0.0, rows_ * w).sum().backward()
    out["lookup"] = every_rank((coord, shard.first, rows_.detach(),
                                block.grad))
    if rank == 0:
        torch.save(out, os.path.join(d, "rows_out.pt"))


def blocks(full: torch.Tensor, sharding):
    """``full`` placed by ``sharding`` on blocks of their own: a rank's
    cache is its own contiguous memory, as the paged kernel reads it."""
    x = place(full, sharding)
    return rewrap(x.to_local().contiguous(), x)


def serve(rank: int, world: int, d: str, data: int) -> None:
    """Each case of ``DIR/serve_inputs.pt`` through the bundle's serve
    steps on the mesh."""
    cases = torch.load(os.path.join(d, "serve_inputs.pt"))
    mesh = make_mesh((data, world // data), ("data", "model"), device="cpu")
    coord = tuple(mesh.get_coordinate())
    out = {}
    for name, case in cases.items():
        bundle = lm_bundle_f32(case["arch"], **case["changes"])
        placed = tree_map(place, case["params"],
                          bundle.param_shardings(mesh))
        MODEL_COLLECTIVES.reset()
        pre = bundle.input_sharding("prefill_32k", mesh)["batch"]
        logits, kv = bundle.serve_step("prefill_32k")(
            placed, {"tokens": place(case["tokens"], pre["tokens"])})
        mine = {"prefill": logits, "prefill_k": kv["k"],
                "prefill_v": kv["v"],
                "prefill_dropped": float(kv.get("moe_dropped", 0.0))}
        shard = bundle.input_sharding("decode_32k", mesh)["batch"]
        cache = {k: blocks(v, shard["cache"][k])
                 for k, v in case["cache"].items()}
        step = bundle.serve_step("decode_32k")
        steps, dropped = [], []
        for tok in case["steps"]:
            logits, c = step(placed, {"token": place(tok, shard["token"]),
                                      "cache": cache})
            cache["len"] = rewrap(c["len"], cache["len"])
            steps.append(logits)
            dropped.append(float(c.get("moe_dropped", 0.0)))
        mine.update({"decode": torch.stack(steps), "dropped": dropped,
                     "k": cache["k"].to_local(), "v": cache["v"].to_local(),
                     "len": cache["len"].to_local(),
                     "collectives": MODEL_COLLECTIVES.count})
        out[name] = every_rank((coord, mine))
    if rank == 0:
        torch.save(out, os.path.join(d, "serve_out.pt"))


def recsysserve(rank: int, world: int, d: str, data: int) -> None:
    """Each arch of ``DIR/recsysserve_inputs.pt`` through its bundle's
    serve steps on the mesh."""
    from repro_torch.distributed.row_parallel import (
        MERGE_COLLECTIVES,
        ROW_COLLECTIVES,
    )

    inputs = torch.load(os.path.join(d, "recsysserve_inputs.pt"))
    mesh = make_mesh((data, world // data), ("data", "model"), device="cpu")
    coord = tuple(mesh.get_coordinate())
    counters = (ROW_COLLECTIVES, MODEL_COLLECTIVES, MERGE_COLLECTIVES)
    out = {}
    for arch, case in inputs.items():
        bundle = recsys_bundle_f32(arch)
        placed = tree_map(place, case["params"],
                          bundle.param_shardings(mesh))
        mine = {}
        for name, (cell, batch, split) in case["calls"].items():
            layout = serve_layout(bundle, cell, batch, mesh, split)
            for c in counters:
                c.reset()
            got = bundle.serve_step(cell)(
                placed, {k: place(v, layout[k]) for k, v in batch.items()})
            mine[name] = {"out": got, "rows": ROW_COLLECTIVES.count,
                          "model": MODEL_COLLECTIVES.count,
                          "merge": MERGE_COLLECTIVES.count}
        out[arch] = every_rank((coord, mine))
    if rank == 0:
        torch.save(out, os.path.join(d, "recsysserve_out.pt"))


def gnn(rank: int, world: int, d: str, data: int) -> None:
    """Each case of ``DIR/gnn_inputs.pt`` through ``Trainer`` on the node
    and edge blocks, and the route's two differentiable collectives."""
    from repro_torch.distributed.graph_parallel import (
        GRAPH_COLLECTIVES,
        gather_nodes,
        graph_shards,
        sum_to_owners,
    )
    from repro_torch.distributed.hooks import batch_sum_, local
    from repro_torch.distributed.sharding import (
        GNN_RULES,
        sanitize_shardings,
        shard_batch,
    )

    inputs = torch.load(os.path.join(d, "gnn_inputs.pt"))
    shape, axes = inputs["mesh"]
    mesh = make_mesh(tuple(shape), tuple(axes), device="cpu")
    coord = tuple(mesh.get_coordinate())
    bundle = get_bundle("mace", reduced=True)
    out = {}
    for name, case in inputs["cases"].items():
        cell = bundle.cell_specs[case["cell"]]
        batch = case["batch"]
        layout = (sanitize_shardings(cell.input_sharding(mesh)["batch"],
                                     batch, mesh)
                  if case["layout"] == "cell" else shard_batch(batch, mesh))
        placed = {k: place(v, layout[k]) for k, v in batch.items()}
        shards = graph_shards(placed)
        given = placed if case["layout"] == "cell" else batch
        params = tree_map(place, case["params"],
                          shard_by_rules(case["params"], mesh, GNN_RULES))
        tr = Trainer(cell.loss_fn(), params,
                     TrainerConfig(opt=cell.opt, log_every=1), device="cpu")
        GRAPH_COLLECTIVES.reset()
        tr.fit(lambda c: given, 1)
        count = GRAPH_COLLECTIVES.count
        # the step's gradient: every rank's share summed over the batch
        # axes, as the step sums it
        with use_mesh(mesh):
            _, grads = value_and_grad(cell.loss_fn(), gathered(params),
                                      placed)
            grads = tree_map(batch_sum_, grads)
        mine = {"loss": tr.history[0]["loss"], "params": gathered(tr.params),
                "grads": grads, "collectives": count,
                "axes": (shards.nodes.axes, shards.edges.axes),
                "blocks": every_rank((coord, (shards.nodes.first,
                                              shards.nodes.n),
                                      (shards.edges.first, shards.edges.n)))}
        if case.get("plain"):
            one = Trainer(cell.loss_fn(), case["params"],
                          TrainerConfig(opt=cell.opt, log_every=1),
                          device="cpu")
            one.fit(lambda c: batch, 1)
            mine["plain"] = {"loss": one.history[0]["loss"],
                             "params": one.params}
        f = case.get("function")
        if f is not None:
            # y = sum_to_owners(c * z * w), z = gather_nodes(h): c counts
            # the edges of this rank's block into each node, so y is the
            # in-degree times h times w on the owners' rows; each rank
            # holding a node row takes its share of sum(y * q)
            first, n = shards.nodes.first, shards.nodes.n
            h = f["h"][first:first + n].clone().requires_grad_(True)
            z = gather_nodes(h, shards)
            dst = local(placed["edges_dst"]).long()
            c = torch.zeros(f["h"].shape[0]).index_add_(
                0, dst, torch.ones(dst.shape[0]))
            y = sum_to_owners(c[:, None] * z * f["w"], shards)
            holders = world // (f["h"].shape[0] // n)
            ((y * f["q"][first:first + n]).sum() / holders).backward()
            mine["function"] = every_rank((first, z.detach(), y.detach(),
                                           h.grad))
        out[name] = mine
    if rank == 0:
        torch.save(out, os.path.join(d, "gnn_out.pt"))


def main() -> None:
    case, rank, world, d = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                            sys.argv[4])
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    try:
        if case == "psum":
            x = torch.from_numpy(np.load(os.path.join(d, "psum_in.npy"))[rank])
            np.save(os.path.join(d, f"psum_out_{rank}.npy"),
                    compressed_psum(x).numpy())
        else:
            run = {"train": train, "tp": tp, "rows": rows,
                   "serve": serve, "recsysserve": recsysserve,
                   "gnn": gnn}[case]
            run(rank, world, d,
                int(sys.argv[5]) if len(sys.argv) > 5 else world)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
