"""The one traffic generator: a pool of batches, drawn from the run's
seed, for the mix that a ``traffic/<name>.json`` file describes.

A mix file holds ``kind`` and its parameters; a new mix of a known kind
is a new data file.  Kinds:

  * ``lm_tokens``: ``batch`` x ``seq`` next-token batches, tokens
    Zipf(``zipf_a``) modulo the vocabulary, sorted along each row, the
    next token as each label and -1 after the last (the port launcher's
    ``synth_lm_batches``, frozen here).  Drawn on the host.
  * ``recsys_rows``: ``batch`` rows of ``n_dense`` dense features uniform
    in [0, 1), one id a table drawn Zipf(``zipf_a``) over the table's
    ranks and mapped through a seeded permutation of its rows (the hot
    rows scattered over the table), labels Bernoulli(``ctr``).  Drawn on
    the device.

Every batch of a pool is distinct; the measured window cycles the pool.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from bench.lib.seeds import generator, numpy_rng

# stream numbers of lib.seeds.derive
TOKENS, PERMUTATION, ROWS = 1, 2, 3


def lm_tokens(mix: dict, vocab: int, seed: int, device, index: int
              ) -> Dict[str, torch.Tensor]:
    rng = numpy_rng(seed, TOKENS, index)
    toks = np.sort(rng.zipf(mix["zipf_a"], size=(mix["batch"], mix["seq"]))
                   % vocab, axis=1)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": torch.as_tensor(toks.astype(np.int32), device=device),
            "labels": torch.as_tensor(labels.astype(np.int32),
                                      device=device)}


def zipf_cdf(rows: int, a: float, device) -> torch.Tensor:
    """The f64 cumulative distribution of Zipf(``a``) over ranks 1..rows."""
    w = torch.arange(1, rows + 1, dtype=torch.float64, device=device).pow_(-a)
    cdf = torch.cumsum(w, 0)
    return cdf.div_(cdf[-1].item())


def recsys_pool(mix: dict, table_rows: Sequence[int], n_dense: int,
                seed: int, device, count: int
                ) -> List[Dict[str, torch.Tensor]]:
    """``count`` batches; batch ``i`` is the same whatever ``count``."""
    B, n = mix["batch"], len(table_rows)
    ids = torch.empty((count, B, n), dtype=torch.int32, device=device)
    for t, rows in enumerate(table_rows):
        perm = torch.randperm(rows, generator=generator(
            seed, PERMUTATION, t, device=device), device=device)
        cdf = zipf_cdf(rows, mix["zipf_a"], device)
        for i in range(count):
            u = torch.rand(B, dtype=torch.float64, generator=generator(
                seed, ROWS, t, i, device=device), device=device)
            rank = torch.searchsorted(cdf, u).clamp_(max=rows - 1)
            ids[i, :, t] = perm[rank].to(torch.int32)
        del perm, cdf
    out = []
    for i in range(count):
        gen = generator(seed, ROWS, n, i, device=device)
        out.append({"dense": torch.rand((B, n_dense), generator=gen,
                                        device=device),
                    "sparse": ids[i],
                    "label": (torch.rand(B, generator=gen, device=device)
                              < mix["ctr"]).float()})
    return out


def pool(mix: dict, model: dict, seed: int, device, count: int = 0
         ) -> List[Dict[str, torch.Tensor]]:
    """The first ``count`` (by default ``mix["pool"]``) distinct batches
    of the pool, on ``device``."""
    count = count or mix["pool"]
    if mix["kind"] == "lm_tokens":
        return [lm_tokens(mix, model["vocab_size"], seed, device, i)
                for i in range(count)]
    if mix["kind"] == "recsys_rows":
        return recsys_pool(mix, model["table_rows"], model["n_dense"], seed,
                           device, count)
    raise ValueError(f"unknown traffic kind {mix['kind']!r}")


def items(mix: dict) -> Dict[str, int]:
    """What one batch of the mix holds: its rows (``samples``) and, for
    token batches, its tokens."""
    out = {"samples": mix["batch"]}
    if mix["kind"] == "lm_tokens":
        out["tokens"] = mix["batch"] * mix["seq"]
    return out
