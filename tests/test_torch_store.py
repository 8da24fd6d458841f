"""The port's durable store against the reference's, on the CPU.

``repro_torch.store`` is a copy of ``repro.store``, so its on-disk format
must be the reference's bit for bit: the codecs, the WAL frames and the
segment files produce equal bytes, and a store directory written by
either package reopens in the other (checkpoint and WAL tail) and serves
the same results with the same simulated ``IOStats``.  Then the storage
oracle (``recovery="replay"`` after compaction and a torn WAL tail),
crash recovery at seeded cut points, and the replica store's
``open_replica``/``poll``, each in both packages with equal results,
``IOStats`` and ``recovery_info``.  ``fsync=False`` throughout, as the
reference's tests run.
"""

import dataclasses
import functools
import shutil

import numpy as np
import pytest

import repro.core.lexicon as ref_lexicon
import repro.core.sharded_set as ref_sharded
import repro.core.strategies as ref_strategies
import repro.core.text_index as ref_text_index
import repro.data.corpus as ref_corpus
import repro.search as ref_search
import repro.store as ref_store
import repro.store.format as ref_format
from tests.oracles import class_pools, core_queries
from tests.test_torch_search import _assert_same, _port_query, _strip

import repro_torch.core.lexicon as port_lexicon
import repro_torch.core.sharded_set as port_sharded
import repro_torch.core.strategies as port_strategies
import repro_torch.core.text_index as port_text_index
import repro_torch.data.corpus as port_corpus
import repro_torch.search as port_search
import repro_torch.store as port_store
import repro_torch.store.format as port_format


@dataclasses.dataclass(frozen=True)
class _Pkg:
    name: str
    lexicon: object
    sharded: object
    strategies: object
    text_index: object
    corpus: object
    search: object
    store: object
    svc_kw: tuple = ()

    def cfg(self):
        # tests/test_store.py's: hot keys own dedicated streams at this
        # scale, so compaction really folds
        return self.text_index.IndexSetConfig(
            strategy=self.strategies.StrategyConfig.set2(
                cluster_size=1024, tag_extract_bytes=512),
            fl_area_clusters=64)

    def service(self, sub, backend="numpy"):
        return self.search.SearchService(sub, window=3, backend=backend,
                                         cache_bytes=1 << 20,
                                         **dict(self.svc_kw))

    def open(self, path, n_shards, **kw):
        lex, _ = _world(self.name)
        return self.store.DurableIndexStore(path, self.cfg(), lex,
                                            n_shards=n_shards, fsync=False,
                                            **kw)


REF = _Pkg("ref", ref_lexicon, ref_sharded, ref_strategies, ref_text_index,
           ref_corpus, ref_search, ref_store)
PORT = _Pkg("port", port_lexicon, port_sharded, port_strategies,
            port_text_index, port_corpus, port_search, port_store,
            (("device", "cpu"),))
PKGS = {"ref": REF, "port": PORT}
DOC_STARTS = [0, 40, 80, 120]


@functools.lru_cache(maxsize=None)
def _world(name):
    """``tests/test_store.py``'s world, built by one package."""
    pkg = PKGS[name]
    lex = pkg.lexicon.make_lexicon(n_words=3000, n_lemmas=1300, n_stop=20,
                                   n_frequent=120, seed=43)
    parts = [pkg.corpus.generate_part(lex, n_docs=40, avg_doc_len=110,
                                      doc0=d0, seed=80 + i)
             for i, d0 in enumerate(DOC_STARTS)]
    return lex, parts


@functools.lru_cache(maxsize=None)
def _ref_queries():
    lex, parts = _world("ref")
    qs = core_queries(parts[0][0], class_pools(lex))
    return qs + [ref_search.Query(qs[0].words, top_k=3)]


def _queries(pkg):
    if pkg is REF:
        return _ref_queries()
    return [_port_query(q) for q in _ref_queries()]


def _apply(pkg, sub, ops):
    _, parts = _world(pkg.name)
    for op in ops:
        if op[0] == "part":
            sub.add_documents(*parts[op[1]], DOC_STARTS[op[1]])
        else:
            sub.compact()
    return sub


def _io(report):
    return {name: dataclasses.asdict(st) for name, st in report.items()}


def _serve(pkg, sub, backend="numpy"):
    """One cold batch: results, trace and the search charges it made."""
    svc = pkg.service(sub, backend)
    before = _io(sub.search_io())
    res = svc.search_batch(_queries(pkg))
    after = _io(sub.search_io())
    charges = {n: {f: after[n][f] - before[n][f] for f in after[n]}
               for n in after}
    return res, _strip(svc.last_trace), charges


def _assert_same_substrate(ref_sub, port_sub, ctx):
    assert port_sub.generation_vector() == ref_sub.generation_vector(), ctx
    assert port_sub.census() == ref_sub.census(), ctx
    assert _io(port_sub.build_io()) == _io(ref_sub.build_io()), ctx


# ---------------------------------------------------------------- codecs --
KEYS = [0, 7, -3, 1 << 62, np.int64(12345), "word", b"\x00\xff raw",
        (1, 2, 3), ("mixed", 5, b"x"), ()]


@pytest.mark.parametrize("key", KEYS, ids=repr)
def test_key_codec_bytes_equal_reference(key):
    buf = ref_format.encode_key(key)
    assert port_format.encode_key(key) == buf
    assert port_format.decode_key(buf, 0) == ref_format.decode_key(buf, 0)


def test_part_and_run_codecs_bytes_equal_reference():
    a = np.array([[1, 4], [1, 9], [5, 0], [70_000, 3]], dtype=np.int64)
    b = np.array([[0, 2]], dtype=np.int64)
    maps = {"known": {5: a, (1, 2): b, "w": a[:2]}, "unknown": {}}
    buf = ref_format.encode_part_maps(maps)
    assert port_format.encode_part_maps(maps) == buf
    got = port_format.decode_part_maps(buf)
    assert set(got) == {"known", "unknown"}
    for key, arr in maps["known"].items():
        assert np.array_equal(got["known"][key], arr)

    for arr in (a, b, np.zeros((0, 2), np.int64)):
        run = ref_format.encode_run(arr)
        assert port_format.encode_run(arr) == run
        posts, off = port_format.decode_run(run, 0)
        assert off == len(run) and np.array_equal(posts.reshape(-1, 2),
                                                  arr.reshape(-1, 2))

    toks = np.arange(37, dtype=np.int64)
    offs = np.array([0, 10, 37], dtype=np.int64)
    buf = ref_format.encode_part_tokens(9, toks, offs)
    assert port_format.encode_part_tokens(9, toks, offs) == buf
    d0, t2, o2 = port_format.decode_part_tokens(buf)
    assert d0 == 9 and np.array_equal(t2, toks) and np.array_equal(o2, offs)
    assert port_format.encode_array(toks) == ref_format.encode_array(toks)


def test_wal_and_segment_bytes_equal_reference(tmp_path):
    """The same parts, compaction and checkpoint through each package
    leave byte-identical WAL, segment and manifest files."""
    ops = [("part", 0), ("part", 1), ("compact",), ("part", 2)]
    dirs = {}
    for pkg in (REF, PORT):
        store = _apply(pkg, pkg.open(tmp_path / pkg.name, 2), ops)
        store.checkpoint()
        store.close()
        dirs[pkg.name] = tmp_path / pkg.name
    for rel in ("wal.log", "MANIFEST"):
        assert (dirs["port"] / rel).read_bytes() == \
            (dirs["ref"] / rel).read_bytes(), rel
    segs = {n: sorted((d / "segments").glob("ckpt-*.seg"))
            for n, d in dirs.items()}
    assert [p.name for p in segs["port"]] == [p.name for p in segs["ref"]]
    for p, r in zip(segs["port"], segs["ref"]):
        assert p.read_bytes() == r.read_bytes(), p.name


# ------------------------------------------------------------ cross-open --
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_store_written_by_one_package_opens_in_the_other(tmp_path, writer):
    """A checkpoint of parts 0-1 (compacted) and a WAL tail of part 2:
    reopened by both packages, each on its own copy of the directory,
    the two serve equal results, traces and charges."""
    store = _apply(PKGS[writer], PKGS[writer].open(tmp_path / "w", 2),
                   [("part", 0), ("part", 1), ("compact",), ("part", 2)])
    store.close()
    opened = {}
    for pkg in (REF, PORT):
        shutil.copytree(tmp_path / "w", tmp_path / pkg.name)
        opened[pkg.name] = pkg.open(tmp_path / pkg.name, 2)
    ref, port = opened["ref"], opened["port"]
    assert port.recovery_info == ref.recovery_info
    assert port.recovery_info["from_checkpoint"]
    assert port.recovery_info["wal_records"] == 1
    assert port.generation_vector() == ref.generation_vector()
    _assert_same(_serve(REF, ref), _serve(PORT, port), ("cross-open", writer))
    ref.close()
    port.close()


# ------------------------------------------------------- storage oracle --
@pytest.mark.parametrize("n_shards", (1, 2, 4))
def test_storage_oracle_replay_matches_reference(tmp_path, n_shards):
    """``tests/test_store.py``'s storage oracle in both packages: parts, a
    compaction cycle and a crash that tears the last part's WAL record;
    replay recovery must land both on the same substrate, serving the
    same results, traces and charges as each other and as the io_sim
    substrate of the published ops."""
    script = [("part", 0), ("part", 1), ("compact",), ("part", 2),
              ("part", 3)]
    stores = {}
    for pkg in (REF, PORT):
        store = _apply(pkg, pkg.open(tmp_path / pkg.name, n_shards),
                       script[:-1])
        end_published = store.wal.tell()
        _apply(pkg, store, script[-1:])
        end_torn = store.wal.tell()
        store.close()
        with open(tmp_path / pkg.name / "wal.log", "rb+") as fh:
            fh.truncate(end_published + (end_torn - end_published) // 2)
        stores[pkg.name] = pkg.open(tmp_path / pkg.name, n_shards,
                                    recovery="replay")
    ref, port = stores["ref"], stores["port"]
    assert port.recovery_info == ref.recovery_info
    assert port.recovery_info["torn"]
    assert port.recovery_info["truncated_bytes"] > 0
    _assert_same_substrate(ref, port, ("oracle", n_shards))
    sim = _apply(PORT, port_sharded.ShardedTextIndexSet(
        PORT.cfg(), _world("port")[0], n_shards=n_shards, seed=0),
        script[:-1])
    _assert_same_substrate(sim, port, ("oracle-sim", n_shards))
    served = _serve(PORT, port)
    assert {"ordinary", "stopseq", "wv", "multi"} <= {
        r.route for r in served[0]}
    _assert_same(_serve(REF, ref), served, ("oracle", n_shards))
    _assert_same(_serve(PORT, sim), _serve(PORT, port),
                 ("oracle-sim", n_shards))
    ref.close()
    port.close()


# ------------------------------------------------------- crash recovery --
@pytest.mark.parametrize("trial", range(4))
def test_crash_recovery_at_seeded_cuts_matches_reference(tmp_path, trial):
    """Truncate the WAL at a seeded offset (odd trials compact, and so
    checkpoint, after part 1) and reopen in both packages: equal
    recovery info, substrate and service."""
    cut = None
    stores = {}
    for pkg in (REF, PORT):
        store = pkg.open(tmp_path / pkg.name, 2)
        _, parts = _world(pkg.name)
        for i, ((toks, offs), d0) in enumerate(zip(parts, DOC_STARTS)):
            store.add_documents(toks, offs, d0)
            if trial % 2 == 1 and i == 1:
                store.compact()
        size = store.wal.tell()
        store.close()
        if cut is None:
            cut = int(np.random.RandomState(900 + trial).randint(0, size + 1))
        with open(tmp_path / pkg.name / "wal.log", "rb+") as fh:
            fh.truncate(cut)
        stores[pkg.name] = pkg.open(tmp_path / pkg.name, 2)
    ref, port = stores["ref"], stores["port"]
    assert port.recovery_info == ref.recovery_info, cut
    assert port.n_checkpoints == ref.n_checkpoints
    _assert_same_substrate(ref, port, ("crash", trial, cut))
    _assert_same(_serve(REF, ref), _serve(PORT, port), ("crash", trial, cut))
    ref.close()
    port.close()


# ---------------------------------------------------------- replica store --
def test_replica_store_open_and_poll_match_reference(tmp_path):
    """``open_replica`` lands at the primary's published generation vector
    and ``poll`` tails the live WAL, in both packages alike; a fabric over
    each replica serves what the other's does."""
    sides = {}
    for pkg in (REF, PORT):
        primary = _apply(pkg, pkg.open(tmp_path / pkg.name, 2),
                         [("part", 0), ("compact",)])
        primary.checkpoint()
        lex, _ = _world(pkg.name)
        replica = pkg.store.DurableIndexStore.open_replica(
            tmp_path / pkg.name, pkg.cfg(), lex, n_shards=2)
        assert replica.generation_vector() == primary.generation_vector()
        sides[pkg.name] = (primary, replica)
    assert sides["port"][1].recovery_info == sides["ref"][1].recovery_info
    for name in ("ref", "port"):
        primary, replica = sides[name]
        _apply(PKGS[name], primary, [("part", 1)])
        assert replica.poll() == 1
        assert replica.poll() == 0
        assert replica.generation_vector() == primary.generation_vector()
        assert replica.wal.size() == primary.wal.tell()

    def fabric(pkg, sub):
        fab = pkg.search.ReplicaSetReader(sub, n_replicas=2)
        svc = pkg.search.SearchService(fab, window=3, backend="numpy",
                                       **dict(pkg.svc_kw))
        res = svc.search_batch(_queries(pkg))
        io = [[_io(rep) for rep in row] for row in fab.io_stats_per_replica()]
        return res, _strip(svc.last_trace), io

    _assert_same(fabric(REF, sides["ref"][1]), fabric(PORT, sides["port"][1]),
                 "replica-store")
    _assert_same_substrate(sides["ref"][1], sides["port"][1], "replica")
    for primary, replica in sides.values():
        primary.close()
        replica.close()


def test_replica_store_mutations_raise(tmp_path):
    primary = _apply(PORT, PORT.open(tmp_path / "s", 1), [("part", 0)])
    primary.checkpoint()
    lex, parts = _world("port")
    replica = port_store.DurableIndexStore.open_replica(
        tmp_path / "s", PORT.cfg(), lex)
    with pytest.raises(RuntimeError, match="replica"):
        replica.add_documents(*parts[1], DOC_STARTS[1])
    with pytest.raises(RuntimeError, match="replica"):
        replica.compact()
    with pytest.raises(RuntimeError, match="replica"):
        replica.checkpoint()
    with pytest.raises(RuntimeError, match="replica"):
        replica.apply_part_maps({})
    with pytest.raises(RuntimeError, match="poll"):
        primary.poll()
    primary.close()
    replica.close()
