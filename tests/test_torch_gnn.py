"""The port's GNN slice against the JAX package, on the CPU (the
bundle's train steps and Cora at its published widths are in
``test_torch_gnn_train.py``; tolerances and shared inputs in
``gnn_cases.py``).

Host substrate (``gnn_common``) and the Gaunt tensor: bit for bit under
the same seeds and ``RandomState``.  MACE's parameters come from the
reference's ``mace_init`` through ``convert.mace_params_from_jax``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs.registry import get_bundle as ref_get_bundle
from repro.models import gnn_common as ref_gc
from repro.models import mace as ref_mace
from repro.sparse import embedding as ref_sparse

from repro_torch.configs.registry import get_bundle
from repro_torch.models import gnn_common as port_gc
from repro_torch.models import mace as port_mace
from repro_torch.sparse import embedding as port_sparse
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import flatten_with_path, leaves

from gnn_cases import (
    BASIC_TOL,
    CPU,
    FWD_TOL,
    GRAD_REL_L2,
    INVARIANCE_TOL,
    LOSS_RTOL,
    cfgs,
    forward_both,
    grads_close,
    graph,
    mol_batch,
    node_batch,
    params,
    rel_l2,
    to_j,
    to_t,
)
from torch_threads import one_torch_thread  # noqa: F401,E402


# ------------------------------------------------------ segment_softmax --
def _softmax_cases():
    rng = np.random.RandomState(11)
    seeded = []
    for shape in ((60,), (60, 3)):
        logits = (rng.randn(*shape) * 4).astype(np.float32)
        ids = rng.randint(-2, 7 + 2, 60).astype(np.int32)
        ids[ids == 6] = 7        # segment 6 empty: ids 7 and 8 read it back
        seeded.append((logits, ids, 7))
    lg = np.arange(1, 6, dtype=np.float32)
    return {
        "past_the_end": (lg, np.array([0, 0, 1, 3, 3], np.int32), 3),
        "negative": (lg, np.array([0, 0, 1, -1, 2], np.int32), 3),
        "seeded": seeded[0],
        "seeded_heads": seeded[1],
    }


@pytest.mark.parametrize("case", list(_softmax_cases()))
def test_segment_softmax_out_of_range_ids_match_reference(case):
    """Ids past the end or negative: dropped from the max and the sum, read
    back clamped or wrapped, as JAX does; ``inf`` exactly where the
    reference has ``inf``.  Finite values are equal on the two small
    inputs; on the seeded ones within 1e-6 relative, since XLA's ``exp``
    and torch's differ in the last bit of about one value in ten."""
    logits, ids, n = _softmax_cases()[case]
    ref = np.asarray(ref_sparse.segment_softmax(to_j(logits), to_j(ids), n))
    got = port_sparse.segment_softmax(to_t(logits), to_t(ids), n).numpy()
    assert got.shape == ref.shape
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    assert not np.isnan(got).any()
    finite = np.isfinite(ref)
    if case.startswith("seeded"):
        assert np.isinf(ref).any() and finite.any()
        assert np.abs(got[finite] / ref[finite] - 1).max() < BASIC_TOL
    else:
        assert np.array_equal(got[finite], ref[finite])
    if case == "past_the_end":
        assert np.isinf(got[3:]).all() and np.isfinite(got[:3]).all()
    if case == "negative":
        assert np.allclose(got, [0.26894143, 0.7310586, 1, np.exp(-1), 1])


# ------------------------------------------------------------ host graphs --
@pytest.mark.parametrize("n,deg,seed", [(200, 5, 0), (2708, 4, 3),
                                        (1000, 40, 7)])
def test_synthetic_graph_is_bit_identical(n, deg, seed):
    ref, got = ref_gc.synthetic_graph(n, deg, seed), port_gc.synthetic_graph(
        n, deg, seed)
    assert got.n_nodes == ref.n_nodes and got.n_edges == ref.n_edges
    for f in ("indptr", "indices"):
        assert getattr(got, f).dtype == getattr(ref, f).dtype
        assert np.array_equal(getattr(got, f), getattr(ref, f))


@pytest.mark.parametrize("n_seeds,fanout", [(8, (3, 2)), (64, (15, 10)),
                                            (5, (4, 4, 2))])
def test_neighbor_sampler_is_bit_identical(n_seeds, fanout):
    assert port_gc.NeighborSampler.padded_sizes(n_seeds, fanout) == \
        ref_gc.NeighborSampler.padded_sizes(n_seeds, list(fanout))
    g = ref_gc.synthetic_graph(3000, 12, seed=1)
    pg = port_gc.CSRGraph(indptr=g.indptr.copy(), indices=g.indices.copy())
    ref_s = ref_gc.NeighborSampler(g, list(fanout))
    port_s = port_gc.NeighborSampler(pg, fanout)
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(3):
        seeds = r1.choice(3000, n_seeds, replace=False)
        assert np.array_equal(seeds, r2.choice(3000, n_seeds, replace=False))
        ref, got = ref_s.sample(seeds, r1), port_s.sample(seeds, r2)
        assert set(got) == set(ref)
        for k in ref:
            assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
            assert np.array_equal(got[k], ref[k]), k
    assert np.array_equal(r1.randint(0, 1 << 30, 4), r2.randint(0, 1 << 30, 4))


def test_batch_small_graphs_is_bit_identical():
    for args in ((4, 10, 16, 0), (128, 30, 64, 9)):
        ref, got = ref_gc.batch_small_graphs(*args), \
            port_gc.batch_small_graphs(*args)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype
            assert np.array_equal(got[k], ref[k])


def test_gaunt_tensor_is_bit_identical():
    got, ref = port_mace.gaunt_tensor(), ref_mace.gaunt_tensor()
    assert got.dtype == ref.dtype == np.float32 and got.shape == (9, 9, 9)
    assert np.array_equal(got, ref)
    assert np.count_nonzero(got) == 83


def test_sph_harm_and_bessel_rbf_match_reference():
    rng = np.random.RandomState(2)
    v = rng.randn(500, 3).astype(np.float32)
    u = v / np.linalg.norm(v, axis=1, keepdims=True)
    ref = np.asarray(ref_mace.real_sph_harm(to_j(u)))
    assert np.abs(port_mace.real_sph_harm(to_t(u)).numpy() - ref).max() < BASIC_TOL
    r = np.concatenate([[0.0, 1e-7, 2.5, 3.0], rng.rand(400) * 3]).astype(np.float32)
    for n_rbf, r_cut in ((8, 2.5), (4, 5.0)):
        ref = np.asarray(ref_mace.bessel_rbf(to_j(r), n_rbf, r_cut))
        got = port_mace.bessel_rbf(to_t(r), n_rbf, r_cut).numpy()
        assert np.abs(got - ref).max() < BASIC_TOL * max(1.0, np.abs(ref).max())


# ------------------------------------------------------------- forward --
@pytest.mark.parametrize("route", ["species", "feat"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("edges", ["whole", "chunked", "chunked_tail"])
def test_forward_matches_reference(route, masked, edges):
    """REDUCED widths; ``chunked``: 512 edges in chunks of 64 (no tail),
    ``chunked_tail``: 500 edges (a padded tail chunk of 52)."""
    d_feat = 12 if route == "feat" else 0
    n_edges = {"whole": 160, "chunked": 512, "chunked_tail": 500}[edges]
    chunk = 64 if edges != "whole" else 1 << 21
    rcfg, pcfg = cfgs(d_hidden=16, n_rbf=4, n_out=4, d_feat=d_feat,
                       edge_chunk=chunk)
    rp, pp = params(rcfg, pcfg)
    g = graph(40, n_edges, d_feat, np.random.RandomState(7), masked=masked)
    ref, got = forward_both(rcfg, pcfg, rp, pp, g)
    assert got.shape == ref.shape == (40, 4)
    assert np.abs(got - ref).max() <= FWD_TOL * np.abs(ref).max()


def test_blocks_split_edges_and_nodes_as_one_pass(monkeypatch):
    """Forward and gradients are the same sums whatever the edge and node
    blocks: EDGE_BLOCK 24 (blocks end at chunk ends) and NODE_BLOCK 7
    against one block each."""
    rcfg, pcfg = cfgs(d_hidden=8, n_rbf=4, n_out=3, d_feat=5, edge_chunk=64)
    _, pp = params(rcfg, pcfg)
    g = graph(30, 300, 5, np.random.RandomState(4), masked=True)
    batch = {k: to_t(v) for k, v in g.items()}
    batch["labels"] = torch.from_numpy(np.random.RandomState(1).randint(0, 3, 30))
    loss = lambda p, b: port_mace.mace_node_xent(pcfg, p, b)  # noqa: E731
    whole = value_and_grad(loss, pp, batch)
    monkeypatch.setattr(port_mace, "EDGE_BLOCK", 24)
    monkeypatch.setattr(port_mace, "NODE_BLOCK", 7)
    assert [b for b in port_mace._edge_blocks(320, 64)][:4] == [
        (0, 24), (24, 48), (48, 64), (64, 88)]
    split = value_and_grad(loss, pp, batch)
    assert abs(float(split[0]) - float(whole[0])) <= 1e-6 * abs(float(whole[0]))
    for a, b in zip(leaves(split[1]), leaves(whole[1])):
        assert rel_l2(a.numpy(), b.numpy()) < 1e-5


def test_explicit_contraction_matches_three_operand_einsum():
    """The fixed-order products against torch's own 3-operand einsum."""
    gen = torch.Generator().manual_seed(3)
    C = torch.from_numpy(port_mace.gaunt_tensor())
    A = torch.randn(50, 16, 9, generator=gen)
    B = torch.randn(50, 16, 9, generator=gen)
    want = torch.einsum("nka,nkb,abc->nkc", A, B, C)
    got = port_mace.gaunt_product(A, B, C)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    hs = torch.randn(70, 16, 9, generator=gen)
    Y = torch.randn(70, 9, generator=gen)
    want = torch.einsum("eka,eb,abc->ekc", hs, Y, C)
    got = torch.bmm(hs, port_mace.y_gaunt(Y, C))
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    # scalar states: only irrep 0 of h_s, as the first layer takes it
    h0 = torch.nn.functional.pad(hs[:, :, :1], (0, 8))
    lp = port_mace.mace_init(port_mace.MACEConfig(d_hidden=16, n_rbf=4),
                             gen)["layers"][0]
    rbf = torch.rand(70, 4, generator=gen)
    assert torch.allclose(port_mace.edge_message(lp, hs[:, :, 0], Y, rbf, C),
                          port_mace.edge_message(lp, h0, Y, rbf, C),
                          rtol=1e-6, atol=1e-6)


# ---------------------------------------------------- losses, gradients --
@pytest.mark.parametrize("loss", ["node_xent", "node_xent_masked",
                                  "energy_mse"])
def test_loss_and_gradients_match_reference(loss):
    rng = np.random.RandomState(12)
    if loss == "energy_mse":
        rcfg, pcfg = cfgs(d_hidden=16, n_rbf=4, n_out=1, edge_chunk=64)
        batch = mol_batch(4, 10, 40, rng)
        rloss, ploss = ref_mace.mace_energy_mse, port_mace.mace_energy_mse
    else:
        rcfg, pcfg = cfgs(d_hidden=16, n_rbf=4, n_out=5, d_feat=9)
        batch = node_batch(48, 200, 9, 5, rng, loss.endswith("masked"))
        rloss, ploss = ref_mace.mace_node_xent, port_mace.mace_node_xent
    rp, pp = params(rcfg, pcfg, seed=4)
    rl, rg = jax.value_and_grad(
        lambda p: rloss(rcfg, p, {k: to_j(v) for k, v in batch.items()}))(rp)
    pl, pg = value_and_grad(lambda p, b: ploss(pcfg, p, b), pp,
                            {k: to_t(v) for k, v in batch.items()})
    assert abs(float(pl) / float(rl) - 1) < LOSS_RTOL
    grads_close(pg, rg, GRAD_REL_L2)


def test_e3_invariance():
    """A rotation and translation of the positions leaves the port's
    outputs unchanged, as ``tests/test_models.py`` asks of the reference."""
    cfg = port_mace.MACEConfig(d_hidden=16, n_out=4, d_feat=12, n_layers=2)
    p = port_mace.mace_init(cfg, torch.Generator().manual_seed(0))
    g = graph(40, 160, 12, np.random.RandomState(8))
    th = 0.9
    c, s = np.cos(th), np.sin(th)
    R = (np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
         @ np.array([[1, 0, 0], [0, 0.6, -0.8], [0, 0.8, 0.6]])).astype(np.float32)
    args = [to_t(g[k]) for k in ("feat", "pos", "edges_src", "edges_dst")]
    with torch.no_grad():
        o1 = port_mace.mace_forward(cfg, p, *args)
        args[1] = args[1] @ torch.from_numpy(R).T + 2.5
        o2 = port_mace.mace_forward(cfg, p, *args)
    err = float((o1 - o2).abs().max() / (o1.abs().max() + 1e-9))
    assert err < INVARIANCE_TOL, err


def test_params_layout_and_positions_gradient():
    """``mace_params_from_jax`` keeps the reference's tree (``layers`` a
    list, f32 leaves); a gradient with respect to positions raises."""
    rcfg, pcfg = cfgs(d_hidden=8, n_rbf=4, n_out=2, d_feat=3)
    rp, pp = params(rcfg, pcfg)
    assert isinstance(pp["layers"], list) and len(pp["layers"]) == 2
    ref_paths = [jax.tree_util.keystr(k) for k, _ in
                 jax.tree_util.tree_flatten_with_path(rp)[0]]
    assert len(ref_paths) == len(leaves(pp))
    assert all(t.dtype == torch.float32 for t in leaves(pp))
    own = port_mace.mace_init(pcfg, torch.Generator().manual_seed(1))
    assert [p for p, _ in flatten_with_path(own)] == [
        p for p, _ in flatten_with_path(pp)]
    assert [tuple(t.shape) for t in leaves(own)] == [
        tuple(t.shape) for t in leaves(pp)]
    g = graph(10, 30, 3, np.random.RandomState(0))
    pos = to_t(g["pos"]).requires_grad_()
    with pytest.raises(NotImplementedError, match="positions"):
        port_mace.mace_forward(pcfg, pp, to_t(g["feat"]), pos,
                               to_t(g["edges_src"]), to_t(g["edges_dst"]))


def test_registry_config_and_bundle_cells():
    from repro_torch.configs.registry import get_config, shape_cells
    from repro_torch.configs import mace_cfg

    assert get_config("mace") is mace_cfg.CONFIG
    assert get_config("mace", reduced=True) is mace_cfg.REDUCED
    assert dataclasses.asdict(mace_cfg.CONFIG) == {
        **{f: v for f, v in dataclasses.asdict(
            ref_get_bundle("mace").config).items() if f != "dtype"},
        "dtype": torch.float32}
    for reduced in (False, True):
        b = get_bundle("mace", reduced=reduced)
        assert list(b.cell_specs) == list(b.cells) == shape_cells("mace")
        assert set(b.cell_inits) == set(b.cells)


# ------------------------------------------------ the card phase's helpers --
def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_gnn_batches_have_the_cells_shapes():
    """``chip_smoke``'s GNN data at the REDUCED sizes: each cell's batch
    has the shapes and dtypes of the bundle's inputs; the edge cut keeps
    the count asked for."""
    cs = _chip_smoke()
    b = get_bundle("mace", reduced=True)
    specs = b.cell_specs
    src, dst = cs.gnn_edges(2708, 10556, 0)
    assert src.shape == dst.shape == (10556,) and src.dtype == np.int32
    assert 0 <= src.min() and src.max() < 2708 and np.all(np.diff(dst) >= 0)
    n_seeds, fanout = b.sizes["mb_seeds"]
    sampled = cs.GNNSampled(specs["minibatch_lg"].config, 500, 8, n_seeds,
                            fanout, 0, CPU)
    batches = {
        "full_graph_sm": cs.gnn_node_batch(specs["full_graph_sm"].config,
                                           *b.sizes["cora"], 0, CPU),
        "minibatch_lg": sampled(0),
        "ogb_products": cs.gnn_node_batch(specs["ogb_products"].config,
                                          *b.sizes["products"], 0, CPU),
        "molecule": cs.gnn_mol_batch(specs["molecule"].config,
                                     b.sizes["mol"], 0, CPU),
    }
    for cell, batch in batches.items():
        assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == \
            specs[cell].inputs, cell
    mb = batches["minibatch_lg"]
    assert float(mb["label_mask"].sum()) == n_seeds
    assert len(sampled.host_s) == 1


def test_chip_gnn_checks_pass_on_the_cpu():
    """The phase's invariance, card-against-CPU and REDUCED checks, run
    with the CPU on both sides: no error and nothing flagged."""
    cs = _chip_smoke()
    b = get_bundle("mace", reduced=True)
    spec = b.cell_specs["molecule"]
    batch = cs.gnn_mol_batch(spec.config, b.sizes["mol"], 0, CPU)
    assert cs.gnn_invariance(spec, batch, 0, CPU) < INVARIANCE_TOL
    par = cs.gnn_grad_parity(spec, batch, 0, CPU)
    assert par["loss_rel_err"] == 0 and par["max_grad_rel_l2"] == 0
    checks = cs.gnn_reduced_checks(0, CPU)
    assert checks.pop("failures") == []
    assert set(checks) == set(b.cells)
    assert all(c["max_state_abs_err"] == 0 for c in checks.values())
