"""The port's recsys serving slice against the JAX package, on the CPU.

Weights come from the reference's ``*_init`` and cross over as numpy
arrays (``recsys_params_from_jax``), so both packages serve the same
model; batches are drawn with numpy from a seed.  Tolerances: f32 scores
within 1e-5 (the two sides sum the same products in other orders, which
moves f32 scores of these sizes by about 1e-7) and retrieval ids
identical; bf16 within 5e-2, where the two sides also round to bf16 at
other places.
"""

import dataclasses
import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_bundle
from repro.launch import serve as ref_launch
from repro.models import recsys as ref_rs
from repro.nn import layers as ref_layers
from repro.sparse import embedding as ref_sparse

from repro_torch.configs.registry import (
    ARCH_IDS,
    RECSYS_ARCH_IDS,
    SERVE_ARCH_IDS,
    family,
    get_config,
    get_serving,
)
from repro_torch.convert import recsys_params_from_jax
from repro_torch.launch import serve as port_launch
from repro_torch.models import recsys as port_rs
from repro_torch.nn import layers as port_layers
from repro_torch.sparse import embedding as port_sparse
from torch_threads import one_torch_thread  # noqa: F401,E402

CPU = "cpu"
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
B = 16


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(j, t) -> float:
    return float(np.abs(_f32(j) - _f32(t)).max())


# ----------------------------------------------------------------- sparse --
def _bag_inputs(seed=0):
    rng = np.random.RandomState(seed)
    V, D, n, n_seg = 40, 12, 30, 7
    table = rng.randn(V, D).astype(np.float32)
    ids = rng.randint(0, V, n).astype(np.int32)
    seg = rng.randint(0, n_seg, n).astype(np.int32)
    seg[seg == 3] = 4          # segment 3 stays empty; ids stay unsorted
    w = rng.rand(n).astype(np.float32)
    return table, ids, seg, n_seg, w


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(mode, weighted, dtype):
    jd, td, tol = DTYPES[dtype]
    table, ids, seg, n_seg, w = _bag_inputs()
    ref = ref_sparse.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), n_seg,
        weights=jnp.asarray(w) if weighted else None, mode=mode, dtype=jd)
    got = port_sparse.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(seg),
        n_seg, weights=torch.from_numpy(w) if weighted else None, mode=mode,
        dtype=td)
    assert got.dtype == td and got.shape == (n_seg, table.shape[1])
    assert _err(ref, got) < tol
    assert np.all(_f32(got)[3] == 0.0)
    with pytest.raises(ValueError):
        port_sparse.embedding_bag(torch.from_numpy(table),
                                  torch.from_numpy(ids), torch.from_numpy(seg),
                                  n_seg, mode="max")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embedding_lookup_matches_reference(dtype):
    jd, td, _ = DTYPES[dtype]
    table, _, _, _, _ = _bag_inputs(1)
    ids = np.random.RandomState(2).randint(0, table.shape[0], (3, 5))
    ref = ref_sparse.embedding_lookup(jnp.asarray(table), jnp.asarray(ids), jd)
    got = port_sparse.embedding_lookup(torch.from_numpy(table),
                                       torch.from_numpy(ids), td)
    assert got.shape == (3, 5, table.shape[1]) and got.dtype == td
    assert np.array_equal(_f32(ref), _f32(got))


@pytest.mark.parametrize("heads", [None, 3])
def test_segment_softmax_matches_reference(heads):
    rng = np.random.RandomState(3)
    n, n_seg = 40, 9
    shape = (n,) if heads is None else (n, heads)
    logits = (rng.randn(*shape) * 5).astype(np.float32)
    seg = rng.randint(0, n_seg, n).astype(np.int32)
    seg[seg == 2] = 5          # an empty segment
    ref = ref_sparse.segment_softmax(jnp.asarray(logits), jnp.asarray(seg),
                                     n_seg)
    got = port_sparse.segment_softmax(torch.from_numpy(logits),
                                      torch.from_numpy(seg), n_seg)
    assert got.shape == shape
    assert _err(ref, got) < 1e-6
    sums = np.zeros((n_seg,) + shape[1:])
    np.add.at(sums, seg, _f32(got))
    assert np.allclose(sums[np.unique(seg)], 1.0, atol=1e-5)


# ------------------------------------------------------------------ dense --
@pytest.mark.parametrize("final_act", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_and_mlp_match_reference(dtype, final_act):
    jd, td, tol = DTYPES[dtype]
    params = ref_layers.mlp_init(jax.random.PRNGKey(1), (24, 40, 16, 5))
    pnp = jax.tree_util.tree_map(np.asarray, params)
    # non-zero biases, so the bias add is checked too
    for i, layer in enumerate(pnp.values()):
        layer["b"] = np.full(layer["b"].shape, 0.1 * (i + 1), np.float32)
    pt = {k: {n: torch.tensor(v) for n, v in layer.items()}
          for k, layer in pnp.items()}
    pj = jax.tree_util.tree_map(jnp.asarray, pnp)
    x = np.random.RandomState(4).randn(6, 24).astype(np.float32)
    y_ref = ref_layers.dense(pj["fc0"], jnp.asarray(x), dtype=jd)
    y = port_layers.dense(pt["fc0"], torch.from_numpy(x), dtype=td)
    assert y.dtype == td and _err(y_ref, y) < tol
    m_ref = ref_layers.mlp_apply(pj, jnp.asarray(x), dtype=jd,
                                 final_act=final_act)
    m = port_layers.mlp_apply(pt, torch.from_numpy(x), dtype=td,
                              final_act=final_act)
    assert m.shape == (6, 5) and _err(m_ref, m) < tol
    assert (_f32(m).min() >= 0) == final_act


def test_mlp_init_mirrors_reference_structure():
    gen = torch.Generator().manual_seed(0)
    port = port_layers.mlp_init(gen, (13, 8, 4))
    ref = ref_layers.mlp_init(jax.random.PRNGKey(0), (13, 8, 4))
    assert set(port) == set(ref) == {"fc0", "fc1"}
    for k in ref:
        for n in ref[k]:
            assert tuple(port[k][n].shape) == ref[k][n].shape
    assert float(port["fc1"]["b"].abs().max()) == 0.0


# ------------------------------------------------------------------ archs --
@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    return get_bundle(arch, reduced=True).init(jax.random.PRNGKey(0))


def _models(arch: str, dtype: str):
    """(reference cfg, reference params, port serving, port params)."""
    jd, td, _ = DTYPES[dtype]
    rcfg = dataclasses.replace(get_bundle(arch, reduced=True).config, dtype=jd)
    rparams = _ref_params(arch)
    sv = get_serving(arch, reduced=True)
    pcfg = dataclasses.replace(sv.config, dtype=td)
    pparams = recsys_params_from_jax(
        pcfg, jax.tree_util.tree_map(np.asarray, rparams), CPU)
    return rcfg, rparams, dataclasses.replace(sv, config=pcfg), pparams


def _typed(batch: dict) -> dict:
    """float arrays as f32, ids as int32, as the reference's specs say."""
    return {k: np.asarray(v, np.float32 if np.asarray(v).dtype.kind == "f"
                          else np.int32) for k, v in batch.items()}


def _serve_batch(arch: str, cfg, rng, n: int) -> dict:
    """A score batch of ``n`` rows with ids in every table's range."""
    return _typed(_serve_arrays(arch, cfg, rng, n))


def _serve_arrays(arch: str, cfg, rng, n: int) -> dict:
    if arch == "dlrm-mlperf":
        return {"dense": rng.rand(n, cfg.n_dense).astype(np.float32),
                "sparse": np.stack([rng.randint(0, r, n)
                                    for r in cfg.table_rows], 1).astype(np.int32)}
    if arch == "din":
        mask = (rng.rand(n, cfg.seq_len) < 0.7).astype(np.float32)
        mask[:, 0] = 1.0
        return {"hist_items": rng.randint(0, cfg.n_items, (n, cfg.seq_len)),
                "hist_cates": rng.randint(0, cfg.n_cates, (n, cfg.seq_len)),
                "hist_mask": mask,
                "target_item": rng.randint(0, cfg.n_items, n),
                "target_cate": rng.randint(0, cfg.n_cates, n)}
    if arch == "sasrec":
        return {"seq": rng.randint(0, cfg.n_items, (n, cfg.seq_len)),
                "candidates": rng.randint(0, cfg.n_items, (n, 200))}
    return {"user_id": rng.randint(0, cfg.n_users, n),
            "user_ctx": rng.randint(0, cfg.n_context, n),
            "item_id": rng.randint(0, cfg.n_items, n),
            "item_cat": rng.randint(0, cfg.n_context, n)}


def _retrieval_batch(arch: str, cfg, rng, n_cand: int) -> dict:
    if arch == "dlrm-mlperf":
        b = _serve_batch(arch, cfg, rng, 1)
        b["candidates"] = rng.randint(0, cfg.table_rows[0], n_cand)
    elif arch == "din":
        b = {k: v for k, v in _serve_batch(arch, cfg, rng, 1).items()
             if k.startswith("hist")}
        b["candidates"] = rng.randint(0, cfg.n_items, n_cand)
        b["candidate_cates"] = rng.randint(0, cfg.n_cates, n_cand)
    elif arch == "sasrec":
        b = {"seq": rng.randint(0, cfg.n_items, (1, cfg.seq_len)),
             "candidates": rng.randint(0, cfg.n_items, n_cand)}
    else:
        b = {"user_id": rng.randint(0, cfg.n_users, 1),
             "user_ctx": rng.randint(0, cfg.n_context, 1),
             "candidate_embs": rng.randn(n_cand, cfg.tower_mlp[-1])
             .astype(np.float32)}
    return _typed(b)


def _both(batch: dict):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", RECSYS_ARCH_IDS)
def test_score_matches_reference(arch, dtype):
    rcfg, rparams, sv, pparams = _models(arch, dtype)
    tol = DTYPES[dtype][2]
    bj, bt = _both(_serve_batch(arch, rcfg, np.random.RandomState(5), B))
    ref_score = {"dlrm-mlperf": ref_rs.dlrm_forward, "din": ref_rs.din_forward,
                 "sasrec": ref_rs.sasrec_score,
                 "two-tower-retrieval": ref_rs.twotower_score}[arch]
    want = jax.jit(ref_score, static_argnums=0)(rcfg, rparams, bj)
    got = sv.score(sv.config, pparams, bt)
    assert got.shape == want.shape and got.dtype == sv.config.dtype
    assert np.all(np.isfinite(_f32(got)))
    assert _err(want, got) < tol


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", RECSYS_ARCH_IDS)
def test_retrieval_matches_reference(arch, dtype):
    """f32: the top ids identical, order and ties included.  bf16: the
    candidates' scores within 5e-2 (ids may differ on near-ties)."""
    rcfg, rparams, sv, pparams = _models(arch, dtype)
    batch = _retrieval_batch(arch, rcfg, np.random.RandomState(6),
                             sv.n_candidates)
    bj, bt = _both(batch)
    ref_ret = {"dlrm-mlperf": ref_rs.dlrm_retrieval,
               "din": ref_rs.din_retrieval,
               "sasrec": ref_rs.sasrec_retrieval,
               "two-tower-retrieval": ref_rs.twotower_retrieval}[arch]
    want = np.asarray(jax.jit(ref_ret, static_argnums=0)(rcfg, rparams, bj))
    got = sv.retrieval(sv.config, pparams, bt)
    assert got.shape == want.shape == (100,)
    scores = sv.candidate_scores(sv.config, pparams, bt)
    assert scores.shape == (sv.n_candidates,)
    assert torch.equal(got, port_rs.top_ids(scores, 100))
    if dtype == "f32":
        assert np.array_equal(got.numpy(), want)
    else:
        s = _f32(scores)
        assert np.abs(s[got.numpy()] - s[want]).max() < DTYPES[dtype][2]


def test_top_ids_puts_lower_index_first():
    scores = [1.0, 3.0, 3.0, 2.0, 3.0]
    want = np.asarray(jax.lax.top_k(jnp.asarray(scores), 3)[1])
    assert want.tolist() == [1, 2, 4]
    for dt in (torch.float32, torch.bfloat16):
        assert port_rs.top_ids(torch.tensor(scores, dtype=dt), 3).tolist() == [1, 2, 4]


def test_dlrm_retrieval_scores_in_chunks(monkeypatch):
    """Candidates past one chunk are scored by several forwards; the
    scores are those of one forward over all of them."""
    _, _, sv, pparams = _models("dlrm-mlperf", "f32")
    batch = _retrieval_batch("dlrm-mlperf", sv.config,
                             np.random.RandomState(7), 700)
    bt = _both(batch)[1]
    whole = port_rs.dlrm_candidate_scores(sv.config, pparams, bt)
    calls = []
    forward = port_rs.dlrm_forward
    monkeypatch.setattr(port_rs, "DLRM_RETRIEVAL_CHUNK", 256)
    monkeypatch.setattr(port_rs, "dlrm_forward",
                        lambda *a: calls.append(1) or forward(*a))
    chunked = port_rs.dlrm_candidate_scores(sv.config, pparams, bt)
    assert len(calls) == 3
    assert float((chunked - whole).abs().max()) < 1e-6


def test_dlrm_forward_goes_through_embedding_bag(monkeypatch):
    """One ``embedding_bags`` call a forward for all 26 tables: (26, B,
    1) int32 ids with weight 1, read under the ``fill`` rule of the
    reference's ``embedding_lookup``, written beside the bottom MLP's
    output (``head``) into the interaction's f32 input."""
    _, _, sv, pparams = _models("dlrm-mlperf", "bf16")
    calls = []
    bags = port_rs.embedding_bags

    def spy(tables, ids, weights, id_rule="clip", **kw):
        calls.append((len(tables), tuple(ids.shape), ids.dtype,
                      bool((weights == 1).all()), id_rule, kw["dtype"],
                      tuple(kw["head"].shape)))
        return bags(tables, ids, weights, id_rule=id_rule, **kw)

    monkeypatch.setattr(port_rs, "embedding_bags", spy)
    batch = _both(_retrieval_batch("dlrm-mlperf", sv.config,
                                   np.random.RandomState(8), 1))[1]
    batch = {"dense": batch["dense"], "sparse": batch["sparse"]}
    port_rs.dlrm_forward(sv.config, pparams, batch)
    assert calls == [(26, (26, 1, 1), torch.int32, True, "fill",
                      torch.float32, (1, sv.config.embed_dim))]


# -------------------------------------------------------------- registry --
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", RECSYS_ARCH_IDS)
def test_registry_configs_equal_reference(arch, reduced):
    bundle = get_bundle(arch, reduced=reduced)
    ref, port = bundle.config, get_config(arch, reduced=reduced)
    assert family(arch) == bundle.family == "recsys"
    for f in dataclasses.fields(port):
        if f.name == "dtype":
            assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        else:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    sv = get_serving(arch, reduced=reduced)
    assert sv.config == port and sv.name == arch
    for cell in ("train_batch", "serve_p99", "serve_bulk"):
        leaves = jax.tree_util.tree_leaves(bundle.cells[cell].inputs)
        assert {leaf.shape[0] for leaf in leaves} == {sv.batch_sizes[cell]}
    ret = bundle.cells["retrieval_cand"].inputs["batch"]
    key = "candidate_embs" if arch == "two-tower-retrieval" else "candidates"
    assert ret[key].shape[0] == sv.n_candidates
    if arch == "sasrec":
        assert bundle.cells["serve_p99"].inputs["batch"]["candidates"].shape[1] \
            == sv.serve_candidates


def test_family_of_every_arch():
    assert {a: family(a) for a in ARCH_IDS} == {
        a: get_bundle(a, reduced=True).family for a in ARCH_IDS}
    assert all(family(a) == "lm" for a in SERVE_ARCH_IDS)
    with pytest.raises(KeyError):
        family("no-such-arch")
    with pytest.raises(ValueError, match="not a recsys arch"):
        get_serving("granite-3-2b")


@pytest.mark.parametrize("arch", RECSYS_ARCH_IDS + ["mace"])
def test_launcher_rejects_a_non_lm_arch_as_the_reference_does(arch, monkeypatch):
    with pytest.raises(SystemExit, match=f"{arch} is not an LM arch"):
        port_launch.main(["--arch", arch, "--device", "cpu"])
    if arch != "mace":   # the reference builds mace's bundle first: slow
        monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch])
        with pytest.raises(SystemExit, match=f"{arch} is not an LM arch"):
            ref_launch.main()


# ------------------------------------------------------------------ device --
def test_recsys_entry_points_raise_without_cuda(monkeypatch):
    """``device=None`` means the card: without one the converter raises,
    and a generator for the card cannot be had to draw weights there."""
    rcfg, rparams, sv, _ = _models("din", "f32")
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recsys_params_from_jax(sv.config, tree)
    with pytest.raises(RuntimeError):
        recsys_params_from_jax(sv.config, tree, "cuda")


@pytest.mark.parametrize("arch", RECSYS_ARCH_IDS)
def test_init_draws_in_the_config_dtype(arch):
    """Tables are drawn in ``cfg.dtype`` in place (N(0, 0.02^2)), dense
    weights held in it, SASRec's norm gains in f32; the tree mirrors the
    reference's."""
    sv = get_serving(arch, reduced=True)
    p = sv.init(sv.config, torch.Generator().manual_seed(0))
    ref = jax.tree_util.tree_map(np.asarray, _ref_params(arch))
    flat_p = jax.tree_util.tree_leaves_with_path(p)
    flat_r = jax.tree_util.tree_leaves_with_path(ref)
    assert [k for k, _ in flat_p] == [k for k, _ in flat_r]
    for (path, t), (_, r) in zip(flat_p, flat_r):
        name = getattr(path[-1], "key", None)
        assert tuple(t.shape) == r.shape
        want = torch.float32 if name in ("ln1", "ln2", "ln_f") else torch.bfloat16
        assert t.dtype == want, path
    table = (p["tables"]["t0"] if arch == "dlrm-mlperf" else p["item"])["table"]
    assert abs(float(table.float().std()) - 0.02) < 0.004
