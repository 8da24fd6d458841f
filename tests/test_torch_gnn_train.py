"""The GNN bundle's train steps and Cora at its published widths, the
port against the JAX package on the CPU (tolerances and inputs in
``gnn_cases.py``)."""

import numpy as np
import pytest

import jax

from repro.configs.registry import get_bundle as ref_get_bundle
from repro.models import mace as ref_mace
from repro.train import optim as ref_optim

from repro_torch.configs.registry import get_bundle
from repro_torch.convert import mace_params_from_jax
from repro_torch.models import gnn_common as port_gc
from repro_torch.models import mace as port_mace
from repro_torch.train.optim import adamw_init
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import leaves

from gnn_cases import (
    CPU,
    LOSS_RTOL,
    STATE_TOL,
    WIDE_RTOL,
    forward_both,
    grads_close,
    mol_batch,
    node_batch,
    params,
    rel_l2,
    to_j,
    to_t,
)
from torch_threads import one_torch_thread  # noqa: F401,E402


def _cell_batch(cell, spec, sizes, rng):
    """numpy inputs of a REDUCED cell, as the card's phase draws them."""
    if cell == "molecule":
        return mol_batch(*sizes["mol"], rng)
    cfg = spec.config
    if cell == "minibatch_lg":
        n_seeds, fanout = sizes["mb_seeds"]
        graph = port_gc.synthetic_graph(500, 8, seed=2)
        sub = port_gc.NeighborSampler(graph, fanout).sample(
            rng.choice(500, n_seeds, replace=False), rng)
        n = sub["nodes"].shape[0]
        mask = np.zeros(n, np.float32)
        mask[: sub["n_seeds"]] = 1.0
        return {"feat": rng.randn(n, cfg.d_feat).astype(np.float32),
                "pos": rng.randn(n, 3).astype(np.float32),
                "edges_src": sub["edges_src"], "edges_dst": sub["edges_dst"],
                "labels": rng.randint(0, cfg.n_out, n).astype(np.int32),
                "edge_mask": sub["edge_mask"], "label_mask": mask}
    n, e = sizes["cora" if cell == "full_graph_sm" else "products"]
    return node_batch(n, e, cfg.d_feat, cfg.n_out, rng, masked=False)


@pytest.mark.parametrize("cell", ["full_graph_sm", "minibatch_lg",
                                  "ogb_products", "molecule"])
def test_train_step_matches_reference_cell(cell):
    """One step of the REDUCED cell: the reference bundle's cell fn
    against the port bundle's ``train_step()``, same masters and batch.
    The reference step runs op by op, as the port does: under ``jax.jit``
    XLA's fusion rounds the cutoff envelope of edges just inside r_cut
    otherwise, which flips the radial MLP's relu at an edge whose first
    layer is that rounding noise (its bias starts at 0); one element of a
    first-layer bias gradient then moves by about 7e-5 (REDUCED
    ogb_products), and Adam's first step, about lr times the gradient's
    sign, turns that into a 2e-4 parameter difference."""
    ref_b, b = ref_get_bundle("mace", reduced=True), get_bundle(
        "mace", reduced=True)
    spec = b.cell_specs[cell]
    rp = ref_b.cell_inits[cell](jax.random.PRNGKey(3))
    pp = mace_params_from_jax(spec.config,
                              jax.tree_util.tree_map(np.asarray, rp), CPU)
    batch = _cell_batch(cell, spec, b.sizes, np.random.RandomState(6))
    assert {k: v.shape for k, v in batch.items()} == {
        k: shape for k, (shape, _) in spec.inputs.items()}
    rp2, rs2, rm = ref_b.cells[cell].fn(
        rp, ref_optim.adamw_init(rp), {k: to_j(v) for k, v in batch.items()})
    pp2, ps2, pm = spec.train_step()(pp, adamw_init(pp),
                                     {k: to_t(v) for k, v in batch.items()})
    assert abs(float(pm["loss"]) / float(rm["loss"]) - 1) < LOSS_RTOL
    assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    for got, want in ((pp2, rp2), (ps2["mu"], rs2["mu"]),
                      (ps2["nu"], rs2["nu"])):
        for g, r in zip(leaves(got), jax.tree_util.tree_leaves(want)):
            assert np.abs(g.numpy() - np.asarray(r)).max() < STATE_TOL


def test_cora_at_published_widths_matches_reference():
    """k 128, 2,708 nodes, 10,556 edges, 1,433 features, 7 classes:
    outputs and every gradient leaf within 1e-4 relative."""
    bundle = get_bundle("mace")
    pcfg = bundle.cell_configs["full_graph_sm"]
    rcfg = ref_get_bundle("mace").cell_configs["full_graph_sm"]
    assert (pcfg.d_hidden, pcfg.d_feat, pcfg.n_out) == (128, 1433, 7)
    n, e = bundle.sizes["cora"]
    rp, pp = params(rcfg, pcfg, seed=5)
    batch = node_batch(n, e, 1433, 7, np.random.RandomState(21), False)
    ref, got = forward_both(rcfg, pcfg, rp, pp, {**batch, "edge_mask": None})
    assert rel_l2(got, ref) < WIDE_RTOL
    assert np.abs(got - ref).max() <= WIDE_RTOL * np.abs(ref).max()
    rl, rg = jax.value_and_grad(lambda p: ref_mace.mace_node_xent(
        rcfg, p, {k: to_j(v) for k, v in batch.items()}))(rp)
    pl, pg = value_and_grad(
        lambda p, b: port_mace.mace_node_xent(pcfg, p, b), pp,
        {k: to_t(v) for k, v in batch.items()})
    assert abs(float(pl) / float(rl) - 1) < WIDE_RTOL
    grads_close(pg, rg, WIDE_RTOL)
