"""The reference's side of the port's mesh tests, run in a subprocess
whose XLA_FLAGS force enough host devices for the production meshes.

    XLA_FLAGS=--xla_force_host_platform_device_count=512 \\
        python tests/torch_mesh_ref.py specs OUT.json
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_mesh_ref.py psum N SEED OUT.npz
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_mesh_ref.py tpstep IN.npz OUT.npz
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_mesh_ref.py dryrun OUT.json
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_mesh_ref.py rowstep IN.npz OUT.npz
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_mesh_ref.py servestep IN.npz OUT.npz
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_mesh_ref.py recsysserve IN.npz OUT.npz
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_mesh_ref.py gnnstep IN.npz OUT.npz

``specs`` writes every bundle's param, opt and input specs, at REDUCED
and full sizes (abstract shapes), on the (16, 16) and (2, 16, 16)
meshes; ``psum`` writes ``compressed_psum`` over N devices under
``shard_map`` of :func:`psum_inputs` (``x``) and its result per device
(``out``).  ``tpstep`` takes granite-3-2b REDUCED in f32 from
``init_params`` at key 0 through the reference's jitted train step (two
microbatches, ``OptConfig()``) on a (2, 2) ``("data", "model")`` mesh,
params and optimizer state placed by the bundle's shardings and the
batch over ``data``, once for each batch of IN (``tokens``, ``labels``:
(steps, B, S)); it writes the initial params (``init/<path>``), the
losses (``losses``) and the final params (``final/<path>``).
``rowstep`` takes each arch of :data:`ROW_ARCHS` REDUCED in f32 from the
params of IN (``<arch>/init/<path>``) through the reference's jitted
train step (the recsys bundle's optimizer) on the same (2, 2) mesh,
params and optimizer state placed by the bundle's shardings and the
batch over ``data``, once for each batch (``<arch>/batch/<i>/<name>``);
it writes the losses (``<arch>/losses``) and the final params
(``<arch>/final/<path>``).  ``dryrun`` lowers and compiles each cell of :data:`DRYRUN_CELLS` at
REDUCED on a (2, 2) ``("data", "model")`` mesh as the reference's dry run
does its production cells (``repro.launch.dryrun.run_cell``; a serve
cell takes no optimizer state), and writes per cell the per-device dot
FLOPs of ``hlo_graph.analyze`` and
``memory_analysis().argument_size_in_bytes``.  ``servestep`` takes each
arch of :data:`SERVE_ARCHS` REDUCED in f32 from the params of IN
(``<arch>/init/<path>``) through the reference's ``prefill`` and
``decode_step``, jitted as its bundle's ``prefill_step`` and
``decode_step`` cells are, on the same (2, 2) mesh with the params
placed by the bundle's shardings and the inputs by the cells' own:
the prompt (``<arch>/tokens``, (B, S)) once, then from the cache
(``<arch>/k``, ``<arch>/v``: (L, B, S_max, n_kv, D); ``<arch>/len``)
one step for each row of ``<arch>/steps`` ((steps, B) tokens), each
step on the cache the last returned; it writes the prefill's logits
(``<arch>/prefill``) and each step's (``<arch>/decode``, (steps, B,
vocab)).  ``recsysserve`` takes each arch of :data:`RECSYS_SERVE_ARCHS`
REDUCED in f32 from the params of IN (``<arch>/init/<path>``) through
the reference's score and retrieval functions, jitted as its bundle's
``serve_step`` and ``retrieval_step`` cells are, on the same (2, 2)
mesh with the params placed by the bundle's shardings: for each call of
``<arch>/calls`` (JSON: name -> [cell, split]) on the batch
``<arch>/<name>/<input>``, placed by the cell's own ``input_sharding``,
or with ``split`` with the candidates (and every input of as many rows)
over ``data``; it writes each call's scores or ids (``<arch>/<name>``).
``gnnstep`` takes each MACE cell of IN REDUCED from its params
(``<cell>/init/<path>``) through the cell's own jitted train step on the
same (2, 2) mesh, params and optimizer state placed by the bundle's
rules and the batch (``<cell>/batch/<input>``) by the cell's
``input_sharding``, sanitized as the dry run sanitizes it, for one
step; it writes the loss (``<cell>/loss``) and the final params
(``<cell>/final/<path>``).
"""

from __future__ import annotations

import json
import sys

import numpy as np

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def psum_inputs(n: int, seed: int) -> np.ndarray:
    """(n, 4, 33) f32: one block a rank, of scales far apart, so that the
    common scale differs from most ranks' own."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, 4, 33)).astype(np.float32)
    return x * (4.0 ** np.arange(n, dtype=np.float32))[:, None, None]


def spec_json(spec) -> list:
    return [None if e is None else e if isinstance(e, str) else list(e)
            for e in tuple(spec)]


def _named(tree) -> dict:
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            spec_json(s.spec) for p, s in flat}


def dump_specs(out: str) -> None:
    import jax

    from repro.configs.registry import ARCH_IDS, get_bundle

    result = {}
    for name, (shape, axes) in MESHES.items():
        mesh = jax.make_mesh(shape, axes)
        for arch in ARCH_IDS:
            for size in ("reduced", "full"):
                b = get_bundle(arch, reduced=size == "reduced")
                result[f"{arch}|{size}|{name}"] = {
                    "params": _named(b.param_shardings(mesh)),
                    "opt": _named(b.opt_shardings(mesh)),
                    "inputs": {c: _named(cell.input_sharding(mesh))
                               for c, cell in b.cells.items()},
                }
    with open(out, "w") as f:
        json.dump(result, f)


def dump_psum(n: int, seed: int, out: str) -> None:
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.distributed.compression import compressed_psum

    try:
        from jax import shard_map
    except ImportError:  # older JAX
        from jax.experimental.shard_map import shard_map

    x = psum_inputs(n, seed)
    mesh = jax.make_mesh((n,), ("d",))
    f = shard_map(partial(compressed_psum, axis_name="d"), mesh=mesh,
                  in_specs=P("d"), out_specs=P("d"))
    got = np.asarray(jax.jit(f)(jnp.asarray(x.reshape(n * 4, 33))))
    np.savez(out, x=x, out=got.reshape(n, 4, 33))


def _flat(tree) -> dict:
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): np.asarray(v) for p, v in flat}


def dump_tp_step(inp: str, out: str) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs.registry import get_bundle
    from repro.models import transformer as tf
    from repro.train.optim import OptConfig, adamw_init
    from repro.train.trainer import TrainerConfig, build_train_step

    batches = np.load(inp)
    bundle = get_bundle("granite-3-2b", reduced=True)
    cfg = dataclasses.replace(bundle.config, dtype=jnp.float32)
    params = tf.init_params(cfg, jax.random.PRNGKey(0))
    # axes of automatic sharding (GSPMD), as the reference's launcher
    # builds its meshes
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    ps, os_ = bundle.param_shardings(mesh), bundle.opt_shardings(mesh)
    bs = {k: NamedSharding(mesh, P("data")) for k in ("tokens", "labels")}
    step = jax.jit(build_train_step(
        lambda p, b: tf.lm_loss(cfg, p, b["tokens"], b["labels"])[0],
        TrainerConfig(opt=OptConfig(), microbatches=2)),
        in_shardings=(ps, os_, bs), out_shardings=(ps, os_, None))
    result = {f"init/{k}": v for k, v in _flat(params).items()}
    losses = []
    with mesh:
        p = jax.device_put(params, ps)
        o = jax.device_put(adamw_init(params), os_)
        for i in range(batches["tokens"].shape[0]):
            b = {k: jnp.asarray(batches[k][i]) for k in bs}
            p, o, metrics = step(p, o, b)
            losses.append(float(metrics["loss"]))
    result.update({f"final/{k}": v for k, v in _flat(p).items()})
    np.savez(out, losses=np.asarray(losses), **result)


def _nested(flat: dict) -> dict:
    """``{"a/b/c": x}`` as ``{"a": {"b": {"c": x}}}``; a level whose keys
    are all indices (``"0"``, ``"1"``, ...) becomes a list."""
    out: dict = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(out)


# the recsys archs whose (2, 2) steps the port's route on their shards
# is held to
ROW_ARCHS = ("dlrm-mlperf", "two-tower-retrieval", "din")


def dump_row_step(inp: str, out: str) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs.registry import get_bundle
    from repro.models import recsys as rs
    from repro.train.optim import OptConfig, adamw_init
    from repro.train.trainer import TrainerConfig, build_train_step

    data = dict(np.load(inp))
    losses_of = {"dlrm-mlperf": rs.dlrm_loss,
                 "two-tower-retrieval": rs.twotower_loss, "din": rs.din_loss}
    # recsys_bundle's optimizer (repro/configs/families.py)
    opt = OptConfig(lr=1e-3, weight_decay=1e-5, schedule="const",
                    warmup_steps=100, total_steps=100_000)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    result = {}
    for arch in ROW_ARCHS:
        bundle = get_bundle(arch, reduced=True)
        cfg = dataclasses.replace(bundle.config, dtype=jnp.float32)
        head = f"{arch}/init/"
        params = _nested({k[len(head):]: v for k, v in data.items()
                          if k.startswith(head)})
        steps = sorted({int(k.split("/")[2]) for k in data
                        if k.startswith(f"{arch}/batch/")})
        names = sorted({k.split("/")[3] for k in data
                        if k.startswith(f"{arch}/batch/")})
        ps, os_ = bundle.param_shardings(mesh), bundle.opt_shardings(mesh)
        bs = {k: NamedSharding(mesh, P("data")) for k in names}
        loss = losses_of[arch]
        step = jax.jit(build_train_step(
            lambda p, b, loss=loss, cfg=cfg: loss(cfg, p, b),
            TrainerConfig(opt=opt)),
            in_shardings=(ps, os_, bs), out_shardings=(ps, os_, None))
        losses = []
        with mesh:
            p = jax.device_put(params, ps)
            o = jax.device_put(adamw_init(params), os_)
            for i in steps:
                b = {k: jnp.asarray(data[f"{arch}/batch/{i}/{k}"])
                     for k in names}
                p, o, metrics = step(p, o, b)
                losses.append(float(metrics["loss"]))
        result[f"{arch}/losses"] = np.asarray(losses)
        result.update({f"{arch}/final/{k}": v for k, v in _flat(p).items()})
    np.savez(out, **result)


# the LM archs whose (2, 2) serve steps the port's are held to
SERVE_ARCHS = ("granite-3-2b", "moonshot-v1-16b-a3b")


def dump_serve_step(inp: str, out: str) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_bundle
    from repro.distributed.sharding import sanitize_shardings
    from repro.models import transformer as tf

    data = dict(np.load(inp))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    result = {}
    for arch in SERVE_ARCHS:
        bundle = get_bundle(arch, reduced=True)
        cfg = dataclasses.replace(bundle.config, dtype=jnp.float32)
        head = f"{arch}/init/"
        params = _nested({k[len(head):]: v for k, v in data.items()
                          if k.startswith(head)})
        ps = bundle.param_shardings(mesh)
        tokens = jnp.asarray(data[f"{arch}/tokens"])
        cache = {"k": jnp.asarray(data[f"{arch}/k"]),
                 "v": jnp.asarray(data[f"{arch}/v"]),
                 "len": jnp.asarray(data[f"{arch}/len"])}
        pre_in = sanitize_shardings(
            bundle.cells["prefill_32k"].input_sharding(mesh)["batch"],
            {"tokens": tokens}, mesh)
        dec_in = sanitize_shardings(
            bundle.cells["decode_32k"].input_sharding(mesh)["batch"],
            {"token": cache["len"], "cache": cache}, mesh)
        prefill = jax.jit(
            lambda p, b, cfg=cfg: tf.prefill(cfg, p, b["tokens"])[0],
            in_shardings=(ps, pre_in))
        decode = jax.jit(
            lambda p, b, cfg=cfg: tf.decode_step(cfg, p, b["token"],
                                                 b["cache"]),
            in_shardings=(ps, dec_in), out_shardings=(None, dec_in["cache"]))
        steps = []
        with mesh:
            p = jax.device_put(params, ps)
            result[f"{arch}/prefill"] = np.asarray(
                prefill(p, {"tokens": tokens}))
            for tok in data[f"{arch}/steps"]:
                logits, cache = decode(p, {"token": jnp.asarray(tok),
                                           "cache": cache})
                steps.append(np.asarray(logits))
        result[f"{arch}/decode"] = np.stack(steps)
    np.savez(out, **result)


# the recsys archs whose (2, 2) serve calls the port's are held to
RECSYS_SERVE_ARCHS = ("dlrm-mlperf", "din", "sasrec", "two-tower-retrieval")


def dump_recsys_serve(inp: str, out: str) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs.registry import get_bundle
    from repro.distributed.sharding import sanitize_shardings
    from repro.models import recsys as rs

    fns = {"dlrm-mlperf": (rs.dlrm_forward, rs.dlrm_retrieval),
           "din": (rs.din_forward, rs.din_retrieval),
           "sasrec": (rs.sasrec_score, rs.sasrec_retrieval),
           "two-tower-retrieval": (rs.twotower_score,
                                   rs.twotower_retrieval)}
    data = dict(np.load(inp))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    result = {}
    for arch in RECSYS_SERVE_ARCHS:
        score, retrieval = fns[arch]
        bundle = get_bundle(arch, reduced=True)
        cfg = dataclasses.replace(bundle.config, dtype=jnp.float32)
        head = f"{arch}/init/"
        params = _nested({k[len(head):]: v for k, v in data.items()
                          if k.startswith(head)})
        ps = bundle.param_shardings(mesh)
        calls = json.loads(str(data[f"{arch}/calls"]))
        with mesh:
            p = jax.device_put(params, ps)
            for name, (cell, split) in calls.items():
                head = f"{arch}/{name}/"
                batch = {k[len(head):]: jnp.asarray(v)
                         for k, v in data.items() if k.startswith(head)}
                bs = sanitize_shardings(
                    bundle.cells[cell].input_sharding(mesh)["batch"], batch,
                    mesh)
                if split:
                    n = batch["candidates" if "candidates" in batch
                              else "candidate_embs"].shape[0]
                    bs = {k: NamedSharding(mesh, P("data", *([None] * (
                        v.ndim - 1)))) if v.ndim and v.shape[0] == n
                        else bs[k] for k, v in batch.items()}
                fn = retrieval if cell == "retrieval_cand" else score
                step = jax.jit(lambda p, b, fn=fn, cfg=cfg: fn(cfg, p, b),
                               in_shardings=(ps, bs))
                result[f"{arch}/{name}"] = np.asarray(step(p, batch))
    np.savez(out, **result)


# the cells the port's dry run is held to, (arch, cell) at REDUCED
DRYRUN_CELLS = (("granite-3-2b", "train_4k"),
                ("moonshot-v1-16b-a3b", "train_4k"),
                ("dlrm-mlperf", "train_batch"), ("mace", "molecule"),
                ("two-tower-retrieval", "train_batch"),
                ("granite-3-2b", "prefill_32k"),
                ("granite-3-2b", "decode_32k"),
                ("moonshot-v1-16b-a3b", "decode_32k"),
                ("dlrm-mlperf", "serve_bulk"),
                ("two-tower-retrieval", "retrieval_cand"))


def dump_gnn_step(inp: str, out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs.registry import get_bundle
    from repro.distributed.sharding import (
        sanitize_shardings,
        shard_by_rules,
    )
    from repro.train.optim import adamw_init

    data = dict(np.load(inp))
    bundle = get_bundle("mace", reduced=True)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    result = {}
    for name in sorted({k.split("/")[0] for k in data}):
        cell = bundle.cells[name]
        head = f"{name}/init/"
        params = _nested({k[len(head):]: v for k, v in data.items()
                          if k.startswith(head)})
        batch = {k.split("/")[2]: jnp.asarray(v) for k, v in data.items()
                 if k.startswith(f"{name}/batch/")}
        ps = shard_by_rules(params, mesh, bundle.rules)
        os_ = {"mu": ps, "nu": ps, "step": NamedSharding(mesh, P())}
        bs = sanitize_shardings(cell.input_sharding(mesh)["batch"], batch,
                                mesh)
        step = jax.jit(cell.fn, in_shardings=(ps, os_, bs),
                       out_shardings=(ps, os_, None))
        with mesh:
            p, _, metrics = step(jax.device_put(params, ps),
                                 jax.device_put(adamw_init(params), os_),
                                 jax.device_put(batch, bs))
        result[f"{name}/loss"] = np.asarray(float(metrics["loss"]))
        result.update({f"{name}/final/{k}": v for k, v in _flat(p).items()})
    np.savez(out, **result)


def dump_dryrun(out: str) -> None:
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs.registry import get_bundle
    from repro.distributed.sharding import (
        sanitize_shardings,
        shard_by_rules,
    )
    from repro.launch import hlo_graph
    from repro.train.optim import adamw_init

    # axes of automatic sharding (GSPMD), as in dump_tp_step
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    result = {}
    for arch, shape in DRYRUN_CELLS:
        bundle = get_bundle(arch, reduced=True)
        cell = bundle.cells[shape]
        with mesh:
            abstract = [bundle.abstract_params()]
            in_shardings = [bundle.param_shardings(mesh)]
            if hasattr(bundle, "cell_inits"):
                abstract = [jax.eval_shape(bundle.cell_inits[shape],
                                           jax.random.PRNGKey(0))]
                in_shardings = [shard_by_rules(abstract[0], mesh,
                                               bundle.rules)]
            if cell.kind == "train":   # a serve cell holds no optimizer
                abstract.append(jax.eval_shape(adamw_init, abstract[0]))
                in_shardings.append({"mu": in_shardings[0],
                                     "nu": in_shardings[0],
                                     "step": NamedSharding(mesh, P())})
            abstract.append(cell.inputs["batch"])
            in_shardings.append(cell.input_sharding(mesh)["batch"])
            in_shardings = [sanitize_shardings(s, a, mesh)
                            for s, a in zip(in_shardings, abstract)]
            compiled = jax.jit(cell.fn, in_shardings=tuple(in_shardings)
                               ).lower(*abstract).compile()
            graph = hlo_graph.analyze(compiled.as_text(), 4)
            result[f"{arch}|{shape}"] = {
                "dot_flops": graph["dot_flops"],
                "argument_size": int(
                    compiled.memory_analysis().argument_size_in_bytes)}
    with open(out, "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    if sys.argv[1] == "specs":
        dump_specs(sys.argv[2])
    elif sys.argv[1] == "tpstep":
        dump_tp_step(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "dryrun":
        dump_dryrun(sys.argv[2])
    elif sys.argv[1] == "rowstep":
        dump_row_step(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "servestep":
        dump_serve_step(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "recsysserve":
        dump_recsys_serve(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "gnnstep":
        dump_gnn_step(sys.argv[2], sys.argv[3])
    else:
        dump_psum(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
