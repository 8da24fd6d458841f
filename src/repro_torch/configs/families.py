"""Serving bundles of the recsys archs, the port of the recsys part of
``repro.configs.families``: each arch's config with its score and
retrieval functions, the batch sizes of its cells and its candidate
count (the reference's ``recsys_bundle`` cells ``serve_p99``,
``serve_bulk`` and ``retrieval_cand``; ``train_batch`` is kept for the
training slice)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

# families.py:334-336 of the reference
RECSYS_BATCH_SIZES = {"train_batch": 65_536, "serve_p99": 512,
                      "serve_bulk": 262_144}


@dataclasses.dataclass(frozen=True)
class RecsysServing:
    name: str
    config: Any
    init: Callable          # (cfg, torch.Generator) -> params
    score: Callable         # (cfg, params, batch) -> scores
    candidate_scores: Callable  # (cfg, params, batch) -> the scores ranked
    retrieval: Callable     # (cfg, params, batch) -> top ids of those
    batch_sizes: Dict[str, int]
    n_candidates: int       # candidates of one retrieval call
    serve_candidates: Optional[int] = None  # per row, where scoring takes them
