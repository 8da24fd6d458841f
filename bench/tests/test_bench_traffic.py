"""The traffic generator and the weights: the same seed draws the same
data, another seed other data, a batch of a pool is the same whatever
the pool's size, and seeds past 2**31 work."""

import json
from pathlib import Path

import numpy as np
import torch

from bench.lib import traffic
from bench.lib import weights as W

BENCH = Path(__file__).resolve().parents[1]
BIG = 2 ** 31 + 977


def mix(name, **kw):
    return {**json.loads((BENCH / "traffic" / f"{name}.json").read_text()),
            **kw}


LM = mix("train-4k", batch=3, seq=32, pool=4)
LM_MODEL = {"vocab_size": 100}
RS = mix("train", batch=64, pool=3)
RS_MODEL = {"table_rows": [1000, 7, 1], "n_dense": 5}


def same(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def test_lm_tokens_are_seeded_sorted_and_shifted():
    a = traffic.pool(LM, LM_MODEL, BIG, "cpu")
    assert same(a, traffic.pool(LM, LM_MODEL, BIG, "cpu"))
    assert not same(a, traffic.pool(LM, LM_MODEL, BIG + 1, "cpu"))
    assert same(a[:2], traffic.pool(LM, LM_MODEL, BIG, "cpu", 2))
    for b in a:
        t, lab = b["tokens"], b["labels"]
        assert t.shape == (3, 32) and t.dtype == torch.int32
        assert bool((t[:, 1:] >= t[:, :-1]).all())
        assert torch.equal(lab[:, :-1], t[:, 1:])
        assert bool((lab[:, -1] == -1).all())
        assert 0 <= int(t.min()) and int(t.max()) < 100
    assert not torch.equal(a[0]["tokens"], a[1]["tokens"])


def test_recsys_rows_are_seeded_in_range_and_skewed():
    a = traffic.pool(RS, RS_MODEL, BIG, "cpu")
    assert same(a, traffic.pool(RS, RS_MODEL, BIG, "cpu"))
    assert not same(a, traffic.pool(RS, RS_MODEL, BIG + 1, "cpu"))
    assert same(a[:1], traffic.pool(RS, RS_MODEL, BIG, "cpu", 1))
    for b in a:
        ids = b["sparse"]
        assert ids.shape == (64, 3) and ids.dtype == torch.int32
        for t, rows in enumerate(RS_MODEL["table_rows"]):
            assert 0 <= int(ids[:, t].min()) and int(ids[:, t].max()) < rows
        assert b["dense"].shape == (64, 5)
        assert 0.0 <= float(b["dense"].min()) and float(b["dense"].max()) < 1
        assert set(b["label"].tolist()) <= {0.0, 1.0}
    # Zipf(1.05) over 1,000 rows: the hottest row takes about 13% of a
    # large draw, where uniform ids would give it 0.1%
    big = traffic.pool({**RS, "batch": 20_000}, RS_MODEL, BIG, "cpu", 1)[0]
    top = np.bincount(big["sparse"][:, 0].numpy()).max() / 20_000
    assert 0.08 < top < 0.2


def test_items_of_a_batch():
    assert traffic.items(LM) == {"samples": 3, "tokens": 96}
    assert traffic.items(RS) == {"samples": 64}


def test_weights_are_drawn_leaf_by_leaf_from_the_seed():
    specs = [("a/w", (4, 3), ("normal", 0.5)), ("a/g", (3,), ("ones",)),
             ("b", (2,), ("zeros",))]
    w = W.draw(specs, BIG, "cpu")
    for i, s in enumerate(specs):
        assert torch.equal(W.draw_leaf(s, i, BIG, "cpu"), w[s[0]])
    assert not torch.equal(W.draw(specs, BIG + 1, "cpu")["a/w"], w["a/w"])
    assert torch.equal(w["a/g"], torch.ones(3))
    assert W.flat(W.nest(w)).keys() == {"a/g", "a/w", "b"}
    assert 0.2 < float(W.draw([("x", (10_000,), ("normal", 0.5))], 3,
                              "cpu")["x"].std()) < 0.8
