"""The search parity matrix, widened: the reference ``SearchService``
against the port's over each backend pair (``numpy``/``numpy``,
``jax``/``torch``, ``pallas``/``cuda``) on 4 shards, under a posting
cache small enough to evict, across ``add_documents`` parts and a
compaction cycle at 1, 2 and 4 shards, on seeded draws of
``tests/oracles.py::QUERY_SPEC`` as exhaustive, doc-id top-k and ranked
top-k queries, and with the chunk pool and the prefetch worker off.
Results element by element, ``last_trace`` key for key (wall-clock keys
aside) and per-device ``IOStats`` must be equal.  Then the
``ProximityEngine`` facade: ``search`` and ``search_ordinary`` of both
packages, per join backend, over 2 shards.
"""

import dataclasses

import numpy as np
import pytest

from benchmarks.common import (
    build_index_set as ref_build_index_set,
    build_sharded_index_set as ref_build_sharded_index_set,
    make_world as ref_make_world,
)
from repro.core.proximity import ProximityEngine as RefEngine
from repro.search import SearchService as RefService
from repro.search.join import (
    jax_window_join,
    numpy_window_join as ref_numpy_window_join,
    pallas_window_join,
)
from tests._hypothesis_compat import given, settings, strategies as st
from tests.oracles import QUERY_SPEC, class_pools, mixed_queries, spec_to_query
from tests.test_torch_search import (
    BACKEND_PAIRS,
    _assert_same,
    _port_query,
    _port_world,
    _serve,
    _standard_queries,
)

from repro_torch.core.proximity import (
    ProximityEngine as PortEngine,
    cuda_window_join,
    numpy_window_join,
    torch_window_join,
)
from repro_torch.data import world as port_world
from repro_torch.search import SearchService as PortService

SCALE = 0.03
# tests/test_store.py's strategy geometry (the StrategyConfig defaults of
# em_limit and sr_block, TAG extraction at 512 B, 64 FL clusters): hot
# keys own scattered streams at this scale, so a compaction cycle folds
GEOMETRY = {"build_ordinary_all": True, "fl_area_clusters": 64,
            "em_limit": 64, "sr_block": 128, "tag_extract_bytes": 512}


def _build(world, build_set, build_sharded, n_shards, **kw):
    if n_shards == 1:
        return build_set(world, "set2", **kw)
    return build_sharded(world, "set2", n_shards, **kw)


def _both(ref_w, port_w, n_shards, **kw):
    return (_build(ref_w, ref_build_index_set, ref_build_sharded_index_set,
                   n_shards, **kw),
            _build(port_w, port_world.build_index_set,
                   port_world.build_sharded_index_set, n_shards, **kw))


def _services(ref_sub, port_sub, ref_backend, port_backend, **kw):
    return (RefService(ref_sub, window=3, backend=ref_backend, **kw),
            PortService(port_sub, window=3, backend=port_backend,
                        device="cpu", **kw))


def _check(ref_sub, port_sub, ref_svc, port_svc, queries, ctx):
    got = _serve(port_svc, port_sub, [_port_query(q) for q in queries])
    _assert_same(_serve(ref_svc, ref_sub, queries), got, ctx)
    return got


@pytest.fixture(scope="module")
def world():
    ref = ref_make_world(SCALE, seed=2, n_parts=3)
    return ref, _port_world(ref)


@pytest.fixture(scope="module")
def four_shards(world):
    return _both(*world, 4, build_ordinary_all=True)


# --------------------------------------------------------------- shards --
@pytest.mark.parametrize("ref_backend,port_backend", BACKEND_PAIRS)
def test_four_shards_match_reference(world, four_shards, ref_backend,
                                     port_backend):
    queries = _standard_queries(world[0])
    ref_svc, port_svc = _services(*four_shards, ref_backend, port_backend)
    got = _check(*four_shards, ref_svc, port_svc, queries,
                 (4, ref_backend, port_backend))
    assert {r.route for r in got[0]} == {"ordinary", "stopseq", "wv",
                                         "multi"}
    assert len(got[2]) == 4
    _check(*four_shards, ref_svc, port_svc, queries,
           (4, ref_backend, port_backend, "warm"))


# ---------------------------------------------------------------- cache --
@pytest.mark.parametrize("ref_backend,port_backend", BACKEND_PAIRS)
def test_evicting_cache_matches_reference(world, four_shards, ref_backend,
                                          port_backend):
    queries = _standard_queries(world[0])
    ref_svc, port_svc = _services(*four_shards, ref_backend, port_backend,
                                  cache_bytes=16 << 10)
    for ctx in ("cold", "warm"):
        got = _check(*four_shards, ref_svc, port_svc, queries,
                     ("evicting", ctx, ref_backend, port_backend))
    assert got[1]["cache"]["evictions"] > 0


# ------------------------------------------------- parts and compaction --
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_parts_and_compaction_match_reference(world, n_shards):
    """Live services of every backend pair over two parts, then a
    compaction cycle, a third part with ``add_documents`` and another
    cycle: each state is served and compared."""
    ref_w, port_w = world

    def head(w):
        return dataclasses.replace(w, parts=w.parts[:2],
                                   doc_starts=w.doc_starts[:2])

    ref_sub, port_sub = _both(head(ref_w), head(port_w), n_shards, **GEOMETRY)
    queries = _standard_queries(ref_w)
    svcs = [_services(ref_sub, port_sub, rb, pb) + ((n_shards, rb, pb),)
            for rb, pb in BACKEND_PAIRS]
    for step in ("two parts", "compact", "third part", "compact again"):
        if step.startswith("compact"):
            assert port_sub.compact() == ref_sub.compact(), step
        elif step == "third part":
            for w, sub in ((ref_w, ref_sub), (port_w, port_sub)):
                (toks, offs), doc0 = w.parts[2], w.doc_starts[2]
                sub.add_documents(toks, offs, doc0)
        for ref_svc, port_svc, ctx in svcs:
            got = _check(ref_sub, port_sub, ref_svc, port_svc, queries,
                         ctx + (step,))
    assert port_sub.compaction_stats() == ref_sub.compaction_stats()
    assert got[1]["compactions"]["compacted_streams"] > 0
    assert got[1]["cache"]["invalidations"] > 0


# ---------------------------------------------------- QUERY_SPEC draws --
@pytest.fixture(scope="module")
def two_shards(world):
    return _both(*world, 2, build_ordinary_all=True)


@pytest.mark.parametrize("ref_backend,port_backend", BACKEND_PAIRS)
@settings(max_examples=3, deadline=None, derandomize=True)
@given(specs=st.lists(QUERY_SPEC, min_size=8, max_size=8))
def test_query_spec_draws_match_reference(world, two_shards, ref_backend,
                                          port_backend, specs):
    ref_w = world[0]
    pools = class_pools(ref_w.lexicon)
    base = [spec_to_query(s, ref_w.parts[0][0], pools) for s in specs]
    queries = (base + [dataclasses.replace(q, top_k=4) for q in base]
               + [dataclasses.replace(q, top_k=4, rank="prox")
                  for q in base])
    _check(*two_shards, *_services(*two_shards, ref_backend, port_backend),
           queries, (ref_backend, port_backend, specs))


# ------------------------------------------------ no pool, no prefetch --
@pytest.mark.parametrize("ref_backend,port_backend", BACKEND_PAIRS)
def test_no_chunk_pool_no_prefetch_matches_reference(world, two_shards,
                                                     ref_backend,
                                                     port_backend):
    queries = _standard_queries(world[0])
    ref_svc, port_svc = _services(*two_shards, ref_backend, port_backend,
                                  share_chunks=False, prefetch=False)
    got = _check(*two_shards, ref_svc, port_svc, queries,
                 ("sequential", ref_backend, port_backend))
    assert got[1]["prefetched_waves"] == 0
    assert got[1]["topk"]["chunks_shared"] == 0


# --------------------------------------------------------------- facade --
def _facade_queries(lex):
    return [q for q in mixed_queries(lex, n=24, seed=11)
            if 2 <= len(q) <= 3]


@pytest.mark.parametrize("ref_join,port_join", [
    (ref_numpy_window_join, numpy_window_join),
    (jax_window_join, torch_window_join),
    (pallas_window_join, cuda_window_join),
    ("pallas", "cuda"),
], ids=["numpy", "jax-torch", "pallas-cuda", "by-name"])
def test_proximity_engine_matches_reference(world, two_shards, ref_join,
                                            port_join):
    ref_ts, port_ts = two_shards
    ref_eng = RefEngine(ref_ts, window=3, join=ref_join)
    port_eng = PortEngine(port_ts, window=3, join=port_join, device="cpu")
    assert port_eng.service.backend == (
        port_join if isinstance(port_join, str)
        else {"numpy_window_join": "numpy", "torch_window_join": "torch",
              "cuda_window_join": "cuda"}[port_join.__name__])
    for words in _facade_queries(world[0].lexicon):
        for method in ("search", "search_ordinary"):
            r = getattr(ref_eng, method)(words)
            g = getattr(port_eng, method)(words)
            ctx = (method, words)
            assert r.route == g.route, ctx
            assert np.array_equal(r.docs, g.docs), ctx
            assert np.array_equal(r.witnesses, g.witnesses), ctx
            assert r.lookups == g.lookups, ctx
            assert r.postings_scanned == g.postings_scanned, ctx
            assert np.array_equal(r.scores, g.scores), ctx
