"""The port's replica read fabric against the reference's, on the CPU.

Both packages build identical worlds from the same seeds (the lexicon and
parts generators are copies) and serve them through a
``ReplicaSetReader``: results, ``last_trace`` key for key (wall-clock
keys aside, the ``replicas`` block included) and every replica's
``IOStats`` must be equal, on the scenarios of ``tests/test_replica.py``:
fabric identity, wave routing, failover mid-batch at the same fault
point, targeted catch-up and revive, the full drop behind the digest
history.  Then what must raise, the staleness guard, and
``chip_smoke.replica_check``, the card's check of its "search replica"
cell, on two port runs.
"""

import contextlib
import dataclasses
import functools
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core.lexicon as ref_lexicon
import repro.core.sharded_set as ref_sharded
import repro.core.strategies as ref_strategies
import repro.core.text_index as ref_text_index
import repro.data.corpus as ref_corpus
import repro.search as ref_search
from tests.oracles import class_pools, core_queries
from tests.test_torch_search import _assert_same as assert_same_batch
from tests.test_torch_search import _port_query, _strip

import repro_torch.core.lexicon as port_lexicon
import repro_torch.core.sharded_set as port_sharded
import repro_torch.core.strategies as port_strategies
import repro_torch.core.text_index as port_text_index
import repro_torch.data.corpus as port_corpus
import repro_torch.search as port_search

def _package(lexicon, sharded, strategies, text_index, corpus, search,
             **svc_kw):
    return SimpleNamespace(
        make_lexicon=lexicon.make_lexicon,
        generate_part=corpus.generate_part,
        TextIndexSet=text_index.TextIndexSet,
        ShardedTextIndexSet=sharded.ShardedTextIndexSet,
        IndexSetConfig=text_index.IndexSetConfig,
        StrategyConfig=strategies.StrategyConfig,
        search=search,
        svc_kw=svc_kw,
    )


REF = _package(ref_lexicon, ref_sharded, ref_strategies, ref_text_index,
               ref_corpus, ref_search)
PORT = _package(port_lexicon, port_sharded, port_strategies, port_text_index,
                port_corpus, port_search, device="cpu")


# --------------------------------------------------------------- worlds --
@functools.lru_cache(maxsize=None)
def _world(pkg_name):
    """``tests/test_replica.py``'s world, built by one package."""
    pkg = REF if pkg_name == "ref" else PORT
    lex = pkg.make_lexicon(n_words=3000, n_lemmas=1300, n_stop=20,
                           n_frequent=120, seed=47)
    parts = [pkg.generate_part(lex, n_docs=40, avg_doc_len=110,
                               doc0=40 * i, seed=90 + i) for i in range(3)]
    return lex, parts


@functools.lru_cache(maxsize=None)
def _ref_queries():
    lex, parts = _world("ref")
    qs = core_queries(parts[0][0], class_pools(lex))
    return qs + [ref_search.Query(qs[0].words, top_k=3)]


def _queries(pkg):
    qs = _ref_queries()
    if pkg is REF:
        return qs
    return [_port_query(q) for q in qs]


def _build(pkg, n_shards, n_parts=2):
    lex, parts = _world("ref" if pkg is REF else "port")
    cfg = pkg.IndexSetConfig(
        strategy=pkg.StrategyConfig.set2(cluster_size=1024),
        fl_area_clusters=64)
    if n_shards == 1:
        sub = pkg.TextIndexSet(cfg, lex, seed=0)
    else:
        sub = pkg.ShardedTextIndexSet(cfg, lex, n_shards=n_shards, seed=0)
    for i, (toks, bounds) in enumerate(parts[:n_parts]):
        sub.add_documents(toks, bounds, 40 * i)
    return sub


def _fabric(pkg, sub, n_replicas, backend="numpy", **kw):
    fab = pkg.search.ReplicaSetReader(sub, n_replicas=n_replicas)
    svc = pkg.search.SearchService(fab, window=3, backend=backend,
                                   **pkg.svc_kw, **kw)
    return fab, svc


def _kill_after(pkg, n):
    """``tests/test_replica.py::_kill_after`` raising the package's own
    ``ReplicaDeadError``."""
    served = [0]

    def fault(rep, op):
        served[0] += 1
        if served[0] > n:
            raise pkg.search.ReplicaDeadError(f"injected after {n} ({op})")

    return fault


def _replica_io(fab):
    return [[{name: dataclasses.asdict(st) for name, st in rep.items()}
             for rep in row] for row in fab.io_stats_per_replica()]


def _serve(pkg, fab, svc):
    res = svc.search_batch(_queries(pkg))
    return res, _strip(svc.last_trace), _replica_io(fab)


def _assert_same(ref, got, ctx):
    assert "replicas" in ref[1] and "replicas" in got[1], ctx
    assert_same_batch(ref, got, ctx)


def _pair(n_shards, n_replicas, ref_backend="numpy", port_backend="numpy",
          n_parts=2):
    """(reference, port) fabrics and services over fresh substrates."""
    out = []
    for pkg, backend in ((REF, ref_backend), (PORT, port_backend)):
        sub = _build(pkg, n_shards, n_parts)
        out.append((pkg, sub) + _fabric(pkg, sub, n_replicas, backend))
    return out


# ------------------------------------------------------------- identity --
@pytest.mark.parametrize("n_replicas", (1, 3))
@pytest.mark.parametrize("n_shards", (1, 2, 4))
def test_fabric_matches_reference(n_shards, n_replicas):
    (rp, rsub, rfab, rsvc), (pp, psub, pfab, psvc) = _pair(n_shards,
                                                           n_replicas)
    _assert_same(_serve(rp, rfab, rsvc), _serve(pp, pfab, psvc),
                 ("cold", n_shards, n_replicas))
    # a warm second batch: cache hits decide routing by read bytes
    _assert_same(_serve(rp, rfab, rsvc), _serve(pp, pfab, psvc),
                 ("warm", n_shards, n_replicas))
    rb = psvc.last_trace["replicas"]
    assert rb["n_replicas"] == n_replicas and rb["failovers"] == 0
    # the fabric serves what the port's single reader serves
    plain = PORT.search.SearchService(psub, window=3, backend="numpy",
                                      device="cpu")
    for i, (a, b) in enumerate(zip(plain.search_batch(_queries(PORT)),
                                   psvc.search_batch(_queries(PORT)))):
        assert np.array_equal(a.docs, b.docs), i
        assert np.array_equal(a.witnesses, b.witnesses), i


@pytest.mark.parametrize("ref_backend,port_backend",
                         [("jax", "torch"), ("pallas", "cuda")])
def test_fabric_device_backends_match_reference(ref_backend, port_backend):
    (rp, _, rfab, rsvc), (pp, _, pfab, psvc) = _pair(
        2, 2, ref_backend, port_backend)
    assert psvc.device_decode == rsvc.device_decode
    _assert_same(_serve(rp, rfab, rsvc), _serve(pp, pfab, psvc),
                 (ref_backend, port_backend))
    _assert_same(_serve(rp, rfab, rsvc), _serve(pp, pfab, psvc),
                 (ref_backend, port_backend, "warm"))


# -------------------------------------------------------------- routing --
def test_wave_routing_matches_reference():
    (rp, _, rfab, rsvc), (pp, _, pfab, psvc) = _pair(2, 2)
    _serve(rp, rfab, rsvc)
    _serve(pp, pfab, psvc)
    ref_rt, port_rt = rfab.route_trace(), pfab.route_trace()
    for key in ("waves", "lookups", "cursors", "snapshot", "live"):
        assert ref_rt[key] == port_rt[key], key
    for row in pfab.replicas:
        assert all(rep.inflight == 0 for rep in row)
        assert all(rep.waves_served > 0 for rep in row)
    assert pfab.read_bytes_per_replica() == rfab.read_bytes_per_replica()


# ------------------------------------------------------------- failover --
@pytest.mark.parametrize("n_shards", (1, 2, 4))
def test_failover_mid_batch_matches_reference(n_shards):
    (rp, _, rfab, rsvc), (pp, _, pfab, psvc) = _pair(n_shards, 2)
    rfab.replicas[0][0].fault = _kill_after(rp, 2)
    pfab.replicas[0][0].fault = _kill_after(pp, 2)
    _assert_same(_serve(rp, rfab, rsvc), _serve(pp, pfab, psvc),
                 ("failover", n_shards))
    rb = psvc.last_trace["replicas"]
    assert rb["failovers_batch"] >= 1
    assert rb["live"][0] == [False, True]
    # the dead replica stays dead for the next batch
    _assert_same(_serve(rp, rfab, rsvc), _serve(pp, pfab, psvc),
                 ("post-failover", n_shards))
    assert psvc.last_trace["replicas"]["failovers_batch"] == 0


def test_all_replicas_dead_raises():
    sub = _build(PORT, 1)
    fab, svc = _fabric(PORT, sub, 2)
    for rep in fab.replicas[0]:
        rep.kill()
    with pytest.raises(port_search.AllReplicasDeadError):
        svc.search_batch(_queries(PORT)[:2])


def test_single_replica_hits_the_failover_floor():
    sub = _build(PORT, 1)
    fab, svc = _fabric(PORT, sub, 1)
    svc.search_batch(_queries(PORT))
    fab.replicas[0][0].fault = _kill_after(PORT, 1)
    with pytest.raises(port_search.AllReplicasDeadError):
        svc.search_batch(_queries(PORT))
    assert fab.failovers == 1


# ------------------------------------------------------------- catch-up --
@pytest.mark.parametrize("n_shards", (1, 2, 4))
def test_catch_up_and_revive_match_reference(n_shards):
    """Kill s0r0, land a part, serve (live replicas catch up targeted),
    revive it (it catches up), serve again: ledgers and everything served
    equal the reference's."""
    sides = _pair(n_shards, 2, n_parts=1)
    for pkg, sub, fab, svc in sides:
        _serve(pkg, fab, svc)  # warm every replica's cache
        fab.replicas[0][0].kill()
        toks, bounds = _world("ref" if pkg is REF else "port")[1][1]
        sub.add_documents(toks, bounds, 40)
    (rp, _, rfab, rsvc), (pp, _, pfab, psvc) = sides
    _assert_same(_serve(rp, rfab, rsvc), _serve(pp, pfab, psvc),
                 ("catch-up", n_shards))
    assert pfab.replicas[0][1].catch_ups["targeted"] > 0
    assert pfab.replicas[0][0].lag() == rfab.replicas[0][0].lag() > 0
    assert pfab.replicas[0][0].revive() == rfab.replicas[0][0].revive()
    assert pfab.replicas[0][0].lag() == 0
    _assert_same(_serve(rp, rfab, rsvc), _serve(pp, pfab, psvc),
                 ("post-revive", n_shards))
    assert pfab.route_trace()["catch_ups"] == rfab.route_trace()["catch_ups"]
    assert (pfab.cache_stats.full_drops == rfab.cache_stats.full_drops)


def test_full_drop_behind_the_history_matches_reference():
    sides = _pair(1, 1, n_parts=1)
    for pkg, sub, fab, svc in sides:
        _serve(pkg, fab, svc)
        toks, bounds = _world("ref" if pkg is REF else "port")[1][1]
        sub.add_documents(toks, bounds, 40)
        # the digest log no longer reaches back to the replica's position
        for idx in sub.indexes.values():
            idx._part_digests.clear()
    (rp, _, rfab, rsvc), (pp, _, pfab, psvc) = sides
    modes = pfab.replicas[0][0].catch_up()
    assert modes == rfab.replicas[0][0].catch_up()
    assert "full_drop" in modes
    port_rep, ref_rep = pfab.replicas[0][0], rfab.replicas[0][0]
    assert port_rep.catch_ups == ref_rep.catch_ups
    assert port_rep.cache.stats.full_drops == ref_rep.cache.stats.full_drops > 0
    _assert_same(_serve(rp, rfab, rsvc), _serve(pp, pfab, psvc), "full-drop")


# ------------------------------------------------------------ staleness --
def test_staleness_guard_raises_on_stale_and_ahead():
    sub = _build(PORT, 2)
    fab, svc = _fabric(PORT, sub, 2)
    svc.search_batch(_queries(PORT))
    svc.check_trace_complete()
    rb = svc.last_trace["replicas"]
    healthy = [list(gv) for gv in rb["snapshot"][0]]
    rb["snapshot"][0][0] = [g - 1 for g in healthy[0]]
    with pytest.raises(port_search.TraceIncompleteError, match="stale"):
        svc.check_trace_complete()
    rb["snapshot"][0][0] = [g + 1 for g in healthy[0]]
    with pytest.raises(port_search.TraceIncompleteError, match="AHEAD"):
        svc.check_trace_complete()
    # a dead replica may lag
    rb["snapshot"][0][0] = [g - 1 for g in healthy[0]]
    rb["live"][0][0] = False
    svc.check_trace_complete()


def test_fabric_generation_vector_is_writer_truth():
    sub = _build(PORT, 2, n_parts=1)
    fab = PORT.search.ReplicaSetReader(sub, n_replicas=2)
    toks, bounds = _world("port")[1][1]
    sub.add_documents(toks, bounds, 40)
    assert fab.generation_vector() == sub.generation_vector()
    assert fab.replica_generations() != [
        [gv] * 2 for gv in sub.generation_vector()]
    fab.refresh()
    assert fab.replica_generations() == [
        [gv] * 2 for gv in sub.generation_vector()]


def test_device_tier_passes_through():
    """``device_tier`` reaches the replica's reader unchanged: ``None``
    keeps every drained list on the host, a device pins it there too."""
    sub = _build(PORT, 1)
    fab = PORT.search.ReplicaSetReader(sub, n_replicas=1)
    cache = fab.replicas[0][0].cache
    keys = list(sub.indexes["known"].dict.entries)[:2]
    fab.open_cursor_shard(0, "known", keys[0]).read_all()
    assert len(cache._map) == 1 and not cache._device
    fab.open_cursor_shard(0, "known", keys[1],
                          device_tier=torch.device("cpu")).read_all()
    assert len(cache._map) == 2 and len(cache._device) == 1
    assert fab.replicas[0][0].cursors_served == 2


# ---------------------------------------------- the card's replica check --
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def replica_cell(tmp_path_factory):
    """The "search replica" cell's protocol run on the CPU at a small
    scale: the ``numpy`` and ``cuda`` fabrics (``cuda`` takes its
    kernels' plain versions on CPU tensors)."""
    from repro_torch.data.world import make_world

    cs = _chip_smoke()
    world = make_world(0.02)
    queries = cs.standard_queries(world, port_search.Query,
                                  np.random.RandomState(7))
    with contextlib.ExitStack() as stack:
        runs, info = cs.replica_runs(world, queries, torch.device("cpu"),
                                     tmp_path_factory.mktemp("replica"),
                                     stack)
        yield cs, runs, info


def test_card_replica_check_passes_a_clean_pair(replica_cell):
    cs, runs, info = replica_cell
    assert info["failures"] == []
    assert info["polled"] > 0
    assert cs.replica_check(runs["numpy"], runs["cuda"]) == []
    assert [b["stage"] for b in runs["cuda"]["batches"]] == [
        "failover", "poll", "revive"]
    assert runs["cuda"]["batches"][0]["trace"]["replicas"][
        "failovers_batch"] >= 1


def test_card_replica_check_catches_a_dropped_document(replica_cell):
    cs, runs, _ = replica_cell
    got = dict(runs["cuda"], batches=list(runs["cuda"]["batches"]))
    stage = dict(got["batches"][1])
    res = list(stage["results"])
    i = next(i for i, r in enumerate(res) if r.docs.size)
    r = res[i]
    keep = r.witnesses[:, 0] != r.docs[0]
    res[i] = dataclasses.replace(
        r, docs=r.docs[1:], witnesses=r.witnesses[keep],
        scores=None if r.scores is None else r.scores[1:])
    stage["results"] = res
    got["batches"][1] = stage
    bad = cs.replica_check(runs["numpy"], got)
    assert any(f"query {i}" in m for m in bad), bad


def test_card_replica_check_catches_a_replica_ahead(replica_cell):
    cs, runs, _ = replica_cell
    got = dict(runs["cuda"], batches=list(runs["cuda"]["batches"]))
    stage = dict(got["batches"][2])
    trace = _strip(stage["trace"])
    rb = trace["replicas"] = dict(trace["replicas"])
    rb["snapshot"] = [[list(gv) for gv in row] for row in rb["snapshot"]]
    rb["snapshot"][1][1] = [g + 1 for g in rb["snapshot"][1][1]]
    stage["trace"] = trace
    got["batches"][2] = stage
    assert cs.replica_check(runs["numpy"], got) == [
        "revive: last_trace differs"]
