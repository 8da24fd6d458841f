"""The reference's side of the port's mesh tests, run in a subprocess
whose XLA_FLAGS force enough host devices for the production meshes.

    XLA_FLAGS=--xla_force_host_platform_device_count=512 \\
        python tests/torch_mesh_ref.py specs OUT.json
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_mesh_ref.py psum N SEED OUT.npz

``specs`` writes every bundle's param, opt and input specs, at REDUCED
and full sizes (abstract shapes), on the (16, 16) and (2, 16, 16)
meshes; ``psum`` writes ``compressed_psum`` over N devices under
``shard_map`` of :func:`psum_inputs` (``x``) and its result per device
(``out``).
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


if __name__ == "__main__":
    if sys.argv[1] == "specs":
        dump_specs(sys.argv[2])
    else:
        dump_psum(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
