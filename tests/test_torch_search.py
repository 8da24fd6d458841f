"""The slice end to end: the reference ``SearchService`` against the
port's, on the same data, on the CPU.

Both packages index byte-identical worlds (the reference world pulled
apart into numpy arrays and rebuilt by ``repro_torch.convert``).  For each
backend pair — reference ``numpy``/``jax``/``pallas`` against port
``numpy``/``torch``/``cuda`` — a batch over all four planner routes,
exhaustive, top-k and ranked, must give element-wise identical results,
the same ``last_trace`` key for key (wall-clock keys aside) and the same
per-device ``IOStats``, at 1 and 2 shards, on the standard and the hot
world, and again after an ``add_documents`` update between two batches.
"""

import dataclasses

import numpy as np
import pytest

from benchmarks.common import (
    HOT_GEOMETRY,
    build_index_set as ref_build_index_set,
    build_sharded_index_set as ref_build_sharded_index_set,
    make_hot_world as ref_make_hot_world,
    make_world as ref_make_world,
)
from repro.search import Query as RefQuery
from repro.search import SearchService as RefService
from tests.oracles import class_pools, core_queries, mixed_queries

from repro_torch.convert import world_from_arrays
from repro_torch.data import world as port_world
from repro_torch.search import Query as PortQuery
from repro_torch.search import SearchService as PortService

SCALE = 0.03
WALL_CLOCK_KEYS = ("shard_fetch_s", "query_s", "busy_s")
BACKEND_PAIRS = [("numpy", "numpy"), ("jax", "torch"), ("pallas", "cuda")]


def _port_world(ref):
    return world_from_arrays(dataclasses.asdict(ref.lexicon), ref.parts,
                             ref.doc_starts)


def _build(world, build_set, build_sharded, n_shards, **kw):
    if n_shards == 1:
        return build_set(world, "set2", **kw)
    return build_sharded(world, "set2", n_shards, **kw)


def _standard_queries(world):
    """All four routes, then the same words as doc-id and ranked top-k."""
    pools = class_pools(world.lexicon)
    base = core_queries(world.parts[0][0], pools) + [
        RefQuery(tuple(q)) for q in mixed_queries(world.lexicon, n=16)
    ]
    return (base
            + [dataclasses.replace(q, top_k=5) for q in base[:10]]
            + [dataclasses.replace(q, top_k=5, rank="prox")
               for q in base[::2]])


def _hot_queries(world):
    toks = world.parts[0][0]
    rng = np.random.RandomState(17)
    distinct = []
    while len(distinct) < 4:
        s = int(rng.randint(0, toks.shape[0] - 3))
        distinct.append(tuple(int(t) for t in toks[s:s + 3]))
    return [RefQuery(distinct[i % 4], phrase=True, top_k=5,
                     rank="prox" if i % 3 == 0 else None)
            for i in range(12)]


def _port_query(q):
    return PortQuery(q.words, q.window, phrase=q.phrase, top_k=q.top_k,
                     rank=q.rank)


def _device_io(substrate):
    per_shard = (substrate.search_io_per_shard()
                 if hasattr(substrate, "search_io_per_shard")
                 else [substrate.search_io()])
    return [{name: dataclasses.asdict(st) for name, st in shard.items()}
            for shard in per_shard]


def _io_delta(before, after):
    return [{name: {f: after[s][name][f] - before[s][name][f]
                    for f in after[s][name]} for name in after[s]}
            for s in range(len(after))]


def _strip(trace):
    if isinstance(trace, dict):
        return {k: _strip(v) for k, v in trace.items()
                if k not in WALL_CLOCK_KEYS}
    return trace


def _serve(svc, substrate, queries):
    before = _device_io(substrate)
    res = svc.search_batch(queries)
    return res, _strip(svc.last_trace), _io_delta(before, _device_io(substrate))


def _assert_same(ref, got, ctx):
    ref_res, ref_trace, ref_io = ref
    got_res, got_trace, got_io = got
    assert len(ref_res) == len(got_res), ctx
    for i, (r, g) in enumerate(zip(ref_res, got_res)):
        c = (ctx, i)
        assert r.route == g.route, c
        assert np.array_equal(r.docs, g.docs), c
        assert np.array_equal(r.witnesses, g.witnesses), c
        assert r.lookups == g.lookups, c
        assert r.postings_scanned == g.postings_scanned, c
        assert (r.scores is None) == (g.scores is None), c
        if r.scores is not None:
            assert np.array_equal(r.scores, g.scores), c
    assert ref_trace == got_trace, ctx
    assert ref_io == got_io, ctx


@pytest.fixture(scope="module")
def worlds():
    ref_std = ref_make_world(SCALE)
    ref_hot = ref_make_hot_world(SCALE)
    return {
        "standard": (ref_std, _port_world(ref_std), {"build_ordinary_all": True},
                     _standard_queries(ref_std)),
        "hot": (ref_hot, _port_world(ref_hot), HOT_GEOMETRY,
                _hot_queries(ref_hot)),
    }


@pytest.fixture(scope="module")
def substrates(worlds):
    """(reference, port) index sets per (world, shards), built once."""
    out = {}
    for name, (ref_w, port_w, kw, _) in worlds.items():
        for n_shards in (1, 2):
            out[(name, n_shards)] = (
                _build(ref_w, ref_build_index_set,
                       ref_build_sharded_index_set, n_shards, **kw),
                _build(port_w, port_world.build_index_set,
                       port_world.build_sharded_index_set, n_shards, **kw),
            )
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_world_builders_reproduce_reference_arrays(seed):
    for ref, port in ((ref_make_world(SCALE, seed=seed),
                       port_world.make_world(SCALE, seed=seed)),
                      (ref_make_hot_world(SCALE, seed=seed),
                       port_world.make_hot_world(SCALE, seed=seed))):
        assert dataclasses.asdict(ref.lexicon).keys() == \
            dataclasses.asdict(port.lexicon).keys()
        for f, v in dataclasses.asdict(ref.lexicon).items():
            assert np.array_equal(v, getattr(port.lexicon, f)), f
        assert ref.doc_starts == port.doc_starts
        for (rt, ro), (pt, po) in zip(ref.parts, port.parts):
            assert np.array_equal(rt, pt) and np.array_equal(ro, po)


def test_world_from_arrays_rejects_incomplete_lexicon():
    ref = ref_make_hot_world(SCALE)
    arrays = dataclasses.asdict(ref.lexicon)
    del arrays["lemma2"]
    with pytest.raises(ValueError):
        world_from_arrays(arrays, ref.parts, ref.doc_starts)


@pytest.mark.parametrize("ref_backend,port_backend", BACKEND_PAIRS)
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("world", ["standard", "hot"])
def test_search_batch_matches_reference(worlds, substrates, world, n_shards,
                                        ref_backend, port_backend):
    queries = worlds[world][3]
    ref_sub, port_sub = substrates[(world, n_shards)]
    ref_svc = RefService(ref_sub, window=3, backend=ref_backend)
    port_svc = PortService(port_sub, window=3, backend=port_backend,
                           device="cpu")
    assert port_svc.device_decode == ref_svc.device_decode
    ref = _serve(ref_svc, ref_sub, queries)
    got = _serve(port_svc, port_sub, [_port_query(q) for q in queries])
    routes = {r.route for r in ref[0]}
    if world == "standard":
        assert routes == {"ordinary", "stopseq", "wv", "multi"}
    _assert_same(ref, got, (world, n_shards, ref_backend, port_backend))
    # a warm second batch: cache hits, pooled replays, device-tier hits
    _assert_same(_serve(ref_svc, ref_sub, queries),
                 _serve(port_svc, port_sub,
                        [_port_query(q) for q in queries]),
                 (world, n_shards, ref_backend, port_backend, "warm"))


@pytest.mark.parametrize("n_shards", [1, 2])
def test_update_between_batches_matches_reference(n_shards):
    """Serve, apply one more collection part with ``add_documents``, serve
    again on the same live services (every backend pair): targeted cache
    invalidation and the new postings must match the reference byte for
    byte."""
    ref_w = ref_make_world(0.03, seed=2, n_parts=3)
    port_w = _port_world(ref_w)

    def head(w):
        return dataclasses.replace(w, parts=w.parts[:2],
                                   doc_starts=w.doc_starts[:2])

    ref_sub = _build(head(ref_w), ref_build_index_set,
                     ref_build_sharded_index_set, n_shards,
                     build_ordinary_all=True)
    port_sub = _build(head(port_w), port_world.build_index_set,
                      port_world.build_sharded_index_set, n_shards,
                      build_ordinary_all=True)
    queries = _standard_queries(ref_w)
    port_queries = [_port_query(q) for q in queries]
    svcs = [(RefService(ref_sub, window=3, backend=rb),
             PortService(port_sub, window=3, backend=pb, device="cpu"),
             (n_shards, rb, pb))
            for rb, pb in BACKEND_PAIRS]
    for ref_svc, port_svc, ctx in svcs:
        _assert_same(_serve(ref_svc, ref_sub, queries),
                     _serve(port_svc, port_sub, port_queries),
                     ctx + ("before",))
    (toks, offs), doc0 = ref_w.parts[2], ref_w.doc_starts[2]
    ref_sub.add_documents(toks, offs, doc0)
    (toks, offs), doc0 = port_w.parts[2], port_w.doc_starts[2]
    port_sub.add_documents(toks, offs, doc0)
    for ref_svc, port_svc, ctx in svcs:
        _assert_same(_serve(ref_svc, ref_sub, queries),
                     _serve(port_svc, port_sub, port_queries),
                     ctx + ("after",))
        assert port_svc.last_trace["cache"]["invalidations"] > 0
