"""Shared inputs of the GNN tests (``test_torch_gnn.py`` and
``test_torch_gnn_train.py``): the two packages' MACE configs and
parameters from the reference's init, numpy graphs and batches, and the
tolerances, in f32:
  * ``real_sph_harm`` and ``bessel_rbf``: 1e-6;
  * ``mace_forward``: 1e-5 of the output's largest magnitude (REDUCED),
    1e-4 relative at Cora's published widths (k 128);
  * losses: 1e-5 relative; each gradient leaf: 1e-4 relative L2;
  * one train step of each REDUCED cell: loss 1e-5 relative, every
    parameter and optimizer leaf within 1e-5;
  * E(3) invariance: 1e-4 of the output's largest magnitude, as
    ``tests/test_models.py`` asks of the reference.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.models import mace as ref_mace

from repro_torch.convert import mace_params_from_jax
from repro_torch.models import gnn_common as port_gc
from repro_torch.models import mace as port_mace
from repro_torch.tree import flatten_with_path

CPU = "cpu"
BASIC_TOL = 1e-6
FWD_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
STATE_TOL = 1e-5
WIDE_RTOL = 1e-4
INVARIANCE_TOL = 1e-4


def to_t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def to_j(x):
    return None if x is None else jnp.asarray(x)


def cfgs(**kw):
    """(reference config, port config) with the same fields."""
    return ref_mace.MACEConfig(**kw), port_mace.MACEConfig(**kw)


def params(rcfg, pcfg, seed=0):
    rp = ref_mace.mace_init(rcfg, jax.random.PRNGKey(seed))
    return rp, mace_params_from_jax(
        pcfg, jax.tree_util.tree_map(np.asarray, rp), CPU)


def graph(n, e, d_feat, rng, n_species=32, loops=4, masked=False):
    """numpy inputs of one graph: features or species, positions, edges
    (the first ``loops`` are self loops, zero-length), an edge mask."""
    feat = (rng.randn(n, d_feat).astype(np.float32) if d_feat
            else rng.randint(0, n_species, n).astype(np.int32))
    src = rng.randint(0, n, e).astype(np.int32)
    dst = rng.randint(0, n, e).astype(np.int32)
    dst[:loops] = src[:loops]
    return {"feat": feat, "pos": rng.randn(n, 3).astype(np.float32),
            "edges_src": src, "edges_dst": dst,
            "edge_mask": ((rng.rand(e) > 0.3).astype(np.float32)
                          if masked else None)}


def forward_both(rcfg, pcfg, rp, pp, g):
    keys = ("feat", "pos", "edges_src", "edges_dst", "edge_mask")
    ref = np.asarray(ref_mace.mace_forward(rcfg, rp, *(to_j(g[k]) for k in keys)))
    with torch.no_grad():
        got = port_mace.mace_forward(pcfg, pp, *(to_t(g[k]) for k in keys))
    return ref, got.numpy()


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def grads_close(pgrads, rgrads, tol):
    rflat = jax.tree_util.tree_leaves(rgrads)
    pflat = flatten_with_path(pgrads)
    assert len(rflat) == len(pflat)
    errs = {path: rel_l2(g.numpy(), r) for (path, g), r in zip(pflat, rflat)}
    assert max(errs.values()) < tol, errs


def node_batch(n, e, d_feat, n_out, rng, masked):
    g = graph(n, e, d_feat, rng, masked=masked)
    g["labels"] = rng.randint(-1, n_out, n).astype(np.int32)  # -1 clamps to 0
    if masked:
        g["label_mask"] = (rng.rand(n) > 0.5).astype(np.float32)
    else:
        del g["edge_mask"]
    return g


def mol_batch(n_g, n_n, n_e, rng):
    b = port_gc.batch_small_graphs(n_g, n_n, n_e, seed=3)
    return {"species": rng.randint(0, 32, n_g * n_n).astype(np.int32),
            "pos": rng.randn(n_g * n_n, 3).astype(np.float32),
            "edges_src": b["edges_src"], "edges_dst": b["edges_dst"],
            "graph_of": b["graph_of"],
            "energy": rng.randn(n_g).astype(np.float32)}
