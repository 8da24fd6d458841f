"""Standard and hot-vocabulary benchmark worlds, and their index sets.

A copy of the world builders in the reference benchmarks
(``benchmarks/common.py``), so that a run on the card needs nothing
outside the port.  Same seeds, same geometry: ``make_world(scale, seed)``
reproduces the reference arrays exactly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.lexicon import Lexicon, make_lexicon
from repro_torch.core.sharded_set import ShardedTextIndexSet
from repro_torch.core.strategies import StrategyConfig
from repro_torch.core.text_index import IndexSetConfig, TextIndexSet
from repro_torch.data.corpus import generate_part


@dataclasses.dataclass
class World:
    lexicon: Lexicon
    parts: List[Tuple[np.ndarray, np.ndarray]]  # (tokens, offsets) per part
    doc_starts: List[int]

    @property
    def total_tokens(self) -> int:
        return sum(t.shape[0] for t, _ in self.parts)


def _parts(lex: Lexicon, n_docs: int, avg_len: int, seed0: int,
           n_parts: int) -> World:
    parts = []
    doc_starts = []
    doc0 = 0
    for p in range(n_parts):
        parts.append(generate_part(lex, n_docs, avg_len, doc0, seed0 + p))
        doc_starts.append(doc0)
        doc0 += n_docs
    return World(lexicon=lex, parts=parts, doc_starts=doc_starts)


def make_world(scale: float = 1.0, seed: int = 0, n_parts: int = 2) -> World:
    """Multi-part collection (paper 6.4: build part 1, update in place with
    the following parts).  scale=1 is about 0.84M tokens over 2,400 docs
    and a 60k-word lexicon."""
    lex = make_lexicon(
        n_words=60_000,
        n_lemmas=26_000,
        n_stop=70,
        n_frequent=1_000,
        seed=1234 + seed,
    )
    return _parts(lex, max(40, int(1200 * scale)), 350, 100, n_parts)


# hot-regime index geometry for the streaming top-k and pooled path: small
# clusters and EM limit push the hot keys' lists into multi-chunk stream
# storage even at small corpus sizes
HOT_GEOMETRY = dict(cluster_size=256, em_limit=8, tag_extract_bytes=512)


def make_hot_world(scale: float = 1.0, seed: int = 0, n_parts: int = 2) -> World:
    """A hot-vocabulary collection: a tiny lexicon makes every k-word
    tuple recur across many documents, so multi-component keys carry long
    stream-backed posting lists — the regime where a best-k search stops
    far before the lists end."""
    lex = make_lexicon(
        n_words=8, n_lemmas=5, n_stop=1, n_frequent=2,
        unknown_fraction=0.15, seed=7 + seed,
    )
    return _parts(lex, max(80, int(800 * scale)), 250, 300, n_parts)


def bench_index_config(
    setname: str,
    cluster_size: int = 1024,
    build_ordinary_all: bool = False,
    fl_area_clusters: int = 4096,
    multi_k=3,
    **strategy_kw,
) -> IndexSetConfig:
    """Benchmark geometry: 1 KB clusters, 16 B EM limit, 64 B SR blocks,
    2 KB TAG extraction — the paper's 32 KB/64 B/128 B/8 KB settings
    scaled with the corpus.  The one config builder for sharded and
    unsharded substrates."""
    strategy_kw.setdefault("em_limit", 16)
    strategy_kw.setdefault("sr_block", 64)
    strategy_kw.setdefault("tag_extract_bytes", 2048)
    strategy = getattr(StrategyConfig, setname)(
        cluster_size=cluster_size, **strategy_kw
    )
    return IndexSetConfig(
        strategy=strategy,
        build_ordinary_all=build_ordinary_all,
        fl_area_clusters=fl_area_clusters,
        multi_k=multi_k,
    )


def build_index_set(world: World, setname: str, **cfg_kw) -> TextIndexSet:
    ts = TextIndexSet(bench_index_config(setname, **cfg_kw), world.lexicon,
                      seed=0)
    for (toks, offs), doc0 in zip(world.parts, world.doc_starts):
        ts.add_documents(toks, offs, doc0)
    return ts


def build_sharded_index_set(world: World, setname: str, n_shards: int,
                            **cfg_kw) -> ShardedTextIndexSet:
    """The :func:`build_index_set` geometry, partitioned by doc hash
    across ``n_shards`` full per-shard substrates."""
    sts = ShardedTextIndexSet(
        bench_index_config(setname, **cfg_kw), world.lexicon,
        n_shards=n_shards, seed=0,
    )
    for (toks, offs), doc0 in zip(world.parts, world.doc_starts):
        sts.add_documents(toks, offs, doc0)
    return sts
