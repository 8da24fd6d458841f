"""Out-of-range ids in the port's sparse lookups against the JAX package,
on the CPU: ROADMAP §3 fault 2, pinned input by input.

The reference has two rules and the port keeps both:

  * **fill**, ``jnp.take``'s, in ``repro.sparse.embedding`` and so in
    the reference's ``dlrm_forward``: an id in ``[-V, 0)`` wraps, any
    other id outside the table reads a NaN row; ``segment_sum`` drops a
    segment id outside ``[0, num_segments)``;
  * **clip**, the Pallas ``embedding_bag_kernel``'s (interpret mode) and
    its oracle's: a negative id wraps once, then is clamped to
    ``[0, V)``.  Its gradient (``jax.grad`` of the oracle) does not
    clamp: an id still out of range after the wrap adds nothing to the
    table's gradient, as under ``take``.

Every comparison is exact, equal values and NaN in the same places,
except where a bag sums several rows: there the reference's tolerances
of ``tests/test_kernels.py`` hold (the sums' order differs).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_bundle as ref_bundle
from repro.kernels.embedding_bag.kernel import embedding_bag_kernel
from repro.kernels.embedding_bag.ref import embedding_bag_fixed_ref
from repro.models import recsys as ref_rs
from repro.sparse import embedding as ref_sparse

from repro_torch.configs.registry import get_serving
from repro_torch.convert import recsys_params_from_jax
from repro_torch.kernels.embedding_bag import (
    embedding_bag_fixed,
    embedding_bag_fixed_plain,
)
from repro_torch.kernels.embedding_bag.ref import resolve_ids
from repro_torch.sparse import embedding as port_sparse

TABLE = np.arange(12, dtype=np.float32).reshape(4, 3)   # V = 4, D = 3
BAD_IDS = [4, -1, 7, -5, -4, 2**31 - 1, -2**31, 0, 3]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BAG_TOL = {"f32": 1e-5, "bf16": 5e-2}   # tests/test_kernels.py's


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _same(got, want, tol: float = 0.0) -> None:
    """NaN in the same places, the other values equal (within ``tol``)."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    assert np.array_equal(np.isnan(g), np.isnan(w))
    assert np.abs(g[~np.isnan(g)] - w[~np.isnan(w)]).max(initial=0) <= tol


# ------------------------------------------------------- sparse.embedding --
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lookup_fills_like_take(dtype):
    """ids [0, 4, -1]: [[0,1,2], [nan]*3, [9,10,11]] in both packages."""
    jd, td = DTYPES[dtype]
    for ids in ([0, 4, -1], BAD_IDS):
        want = ref_sparse.embedding_lookup(jnp.asarray(TABLE),
                                           jnp.asarray(ids, jnp.int32), jd)
        got = port_sparse.embedding_lookup(torch.from_numpy(TABLE),
                                           torch.tensor(ids, dtype=torch.int32),
                                           td)
        assert got.dtype == td
        _same(got, want)
    row = _np(got)
    assert np.isnan(row[0]).all() and not np.isnan(row[1]).any()


@pytest.mark.parametrize("mode,segs", [
    ("sum", [0, 0, 1, 3]), ("mean", [0, 0, 1, -1]), ("mean", [0, 0, 1, 3]),
    ("sum", [-1, 5, 2, 2]),
])
def test_bag_drops_segments_outside_the_range(mode, segs):
    """segment ids [0,0,1,3] (sum): [[3,5,7],[6,7,8],[0,0,0]];
    [0,0,1,-1] (mean): [[1.5,2.5,3.5],[6,7,8],[0,0,0]]."""
    ids = [0, 1, 2, 3]
    want = ref_sparse.embedding_bag(
        jnp.asarray(TABLE), jnp.asarray(ids, jnp.int32),
        jnp.asarray(segs, jnp.int32), 3, mode=mode, dtype=jnp.float32)
    got = port_sparse.embedding_bag(
        torch.from_numpy(TABLE), torch.tensor(ids, dtype=torch.int32),
        torch.tensor(segs, dtype=torch.int32), 3, mode=mode,
        dtype=torch.float32)
    _same(got, want)


def test_bag_rows_come_through_the_fill_lookup():
    ids, segs, w = [0, 9, -2, 1], [0, 1, 1, 2], [1.0, 2.0, 0.5, -1.0]
    want = ref_sparse.embedding_bag(
        jnp.asarray(TABLE), jnp.asarray(ids, jnp.int32),
        jnp.asarray(segs, jnp.int32), 3, weights=jnp.asarray(w),
        dtype=jnp.float32)
    got = port_sparse.embedding_bag(
        torch.from_numpy(TABLE), torch.tensor(ids, dtype=torch.int32),
        torch.tensor(segs, dtype=torch.int32), 3, weights=torch.tensor(w),
        dtype=torch.float32)
    _same(got, want)
    assert np.isnan(_np(got)[1]).all()


# --------------------------------------------------------- the bag kernel --
def _bag(ids_list, K=1, seed=0):
    """(B, K) int32 ids, each bag its ids then in-range fillers, and
    weights."""
    rng = np.random.RandomState(seed)
    ids = np.asarray(ids_list, np.int64).reshape(-1, 1)
    if K > 1:
        ids = np.concatenate([ids, rng.randint(0, 4, (len(ids), K - 1))], 1)
    w = rng.uniform(-1, 1, ids.shape).astype(np.float32)
    return ids.astype(np.int32), w


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K", [1, 3])
def test_plain_clip_equals_the_pallas_kernel(dtype, K):
    """ids 4, -1, 7, -5 read rows 3, 3, 3, 0 in both; the oracle agrees."""
    jd, td = DTYPES[dtype]
    ids, w = _bag(BAD_IDS, K)
    table = jnp.asarray(TABLE, jd)
    want = embedding_bag_kernel(table, jnp.asarray(ids), jnp.asarray(w),
                                interpret=True)
    tt = torch.from_numpy(TABLE).to(td)
    got = embedding_bag_fixed_plain(tt, torch.from_numpy(ids),
                                    torch.from_numpy(w))
    _same(got, want, 0.0 if K == 1 else BAG_TOL[dtype])
    assert torch.equal(got, embedding_bag_fixed(tt, torch.from_numpy(ids),
                                                torch.from_numpy(w)))
    rows, ok = resolve_ids(torch.tensor([4, -1, 7, -5]), 4, "clip")
    assert rows.tolist() == [3, 3, 3, 0] and ok is None
    oracle = embedding_bag_fixed_ref(jnp.asarray(TABLE), jnp.asarray(ids),
                                     jnp.asarray(w))
    _same(embedding_bag_fixed_plain(torch.from_numpy(TABLE),
                                    torch.from_numpy(ids),
                                    torch.from_numpy(w)), oracle,
          0.0 if K == 1 else BAG_TOL["f32"])


def _take_bag(table, ids, w):
    """The fill rule's bag: ``take`` then the f32 weighted sum."""
    rows = jnp.take(table, ids, axis=0).astype(jnp.float32)
    return (rows * w[..., None]).sum(1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K", [1, 3])
def test_plain_fill_equals_take(dtype, K):
    jd, td = DTYPES[dtype]
    ids, w = _bag(BAD_IDS, K)
    want = _take_bag(jnp.asarray(TABLE, jd), jnp.asarray(ids),
                     jnp.asarray(w)).astype(jd)
    tt = torch.from_numpy(TABLE).to(td)
    got = embedding_bag_fixed(tt, torch.from_numpy(ids), torch.from_numpy(w),
                              id_rule="fill")
    assert got.dtype == td
    _same(got, want, 0.0 if K == 1 else BAG_TOL[dtype])
    bad = ~np.isin(np.asarray(ids)[:, 0], [-1, -4, 0, 3])
    assert np.array_equal(np.isnan(_np(got)).all(1), bad)
    with pytest.raises(ValueError, match="id_rule"):
        embedding_bag_fixed(tt, torch.from_numpy(ids), torch.from_numpy(w),
                            id_rule="wrap")


@pytest.mark.parametrize("rule", ["clip", "fill"])
def test_backward_matches_jax_grad(rule):
    """Table and weight gradients against ``jax.grad`` of the oracle
    (clip) and of ``take`` (fill): an id out of range after the wrap adds
    nothing to the table's gradient in both, its weight's gradient reads
    the clamped row (clip) or is NaN (fill); a wrapped negative id lands
    on its wrapped row in both."""
    ids, w = _bag(BAD_IDS, 3)
    G = np.random.RandomState(1).standard_normal((len(ids), 3)).astype(
        np.float32)
    fn = embedding_bag_fixed_ref if rule == "clip" else _take_bag

    def loss(t, ww):
        return jnp.sum(fn(t, jnp.asarray(ids), ww) * G)

    gt_want, gw_want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(TABLE),
                                                      jnp.asarray(w))
    t = torch.from_numpy(TABLE.copy()).requires_grad_(True)
    ww = torch.from_numpy(w.copy()).requires_grad_(True)
    out = embedding_bag_fixed(t, torch.from_numpy(ids), ww, id_rule=rule)
    out.backward(torch.from_numpy(G))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gt_want),
                               rtol=1e-6, atol=1e-6)
    assert np.isfinite(t.grad.numpy()).all()
    gw, gww = ww.grad.numpy(), np.asarray(gw_want)
    assert np.array_equal(np.isnan(gw), np.isnan(gww))
    np.testing.assert_allclose(gw[~np.isnan(gw)], gww[~np.isnan(gww)],
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------- DLRM --
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dlrm_scores_with_one_bad_id_a_row(dtype):
    """REDUCED DLRM, each row one id of V, -1, -V, -V-1 or 2^31-1 in one
    of its tables: the port's scores against the reference's
    ``dlrm_forward``, NaN rows in the same places (-1 and -V wrap)."""
    jd, td = DTYPES[dtype]
    rb = ref_bundle("dlrm-mlperf", reduced=True)
    rcfg = dataclasses.replace(rb.config, dtype=jd)
    rparams = rb.init(jax.random.PRNGKey(0))
    sv = get_serving("dlrm-mlperf", reduced=True)
    pcfg = dataclasses.replace(sv.config, dtype=td)
    pparams = recsys_params_from_jax(
        pcfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    rng = np.random.RandomState(4)
    n = 20
    sparse = np.stack([rng.randint(0, r, n) for r in rcfg.table_rows], 1)
    for i in range(n):
        col = rng.randint(0, rcfg.n_sparse)
        V = rcfg.table_rows[col]
        sparse[i, col] = (V, -1, -V, -V - 1, 2**31 - 1)[i % 5]
    dense = rng.rand(n, rcfg.n_dense).astype(np.float32)
    sparse = sparse.astype(np.int32)
    want = jax.jit(ref_rs.dlrm_forward, static_argnums=0)(
        rcfg, rparams, {"dense": jnp.asarray(dense),
                        "sparse": jnp.asarray(sparse)})
    got = port_rs_forward(pcfg, pparams, dense, sparse)
    g, w = _np(got), _np(want)
    assert np.array_equal(np.isnan(g), np.isnan(w))
    assert np.isnan(g).sum() == 12 and np.isfinite(g).sum() == 8
    tol = {"f32": 1e-5, "bf16": 5e-2}[dtype]   # test_torch_recsys.py's
    assert np.abs(g[~np.isnan(g)] - w[~np.isnan(w)]).max() < tol


def port_rs_forward(cfg, params, dense, sparse):
    from repro_torch.models import recsys as port_rs

    return port_rs.dlrm_forward(cfg, params, {
        "dense": torch.from_numpy(dense), "sparse": torch.from_numpy(sparse)})


# ------------------------------------------------ the card's id-rule check --
def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chip_bag_rule_case_on_the_cpu(dtype, monkeypatch):
    """``chip_smoke.bag_rule_case`` at a small serve launch (K = 1, w =
    1) on the CPU, its timers stubbed: both rules agree with the plain
    version, the clip rule makes no NaN, the fill rule one NaN bag for
    each of V, -V-1 and 2^31-1 (-1 and -V wrap); a plain version that
    clamps where it should fill is caught."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, reps=20: 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    gen = torch.Generator().manual_seed(3)
    V, B = 5000, 3 * cs.BAG_BAD_EVERY + 10
    table = (torch.randn(V, 16, generator=gen) * 0.02).to(dtype)
    ids = torch.randint(0, V, (B, 1), generator=gen, dtype=torch.int32)
    case = cs.bag_rule_case(table, ids, torch.ones(B, 1))
    assert case["within_tolerance"], case
    assert case["bad_ids"] == 4 and case["fill"]["nan_bags"] == 2
    assert case["clip"]["nan_bags"] == 0

    from repro_torch.kernels.embedding_bag import ref as bag_ref

    plain = bag_ref.embedding_bag_fixed_plain
    monkeypatch.setattr(
        bag_ref, "embedding_bag_fixed_plain",
        lambda t, i, w, mode="sum", id_rule="clip": plain(t, i, w, mode))
    assert not cs.bag_rule_case(table, ids, torch.ones(B, 1))[
        "within_tolerance"]
