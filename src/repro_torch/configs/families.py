"""Serving and training bundles of the recsys archs, the port of the
recsys part of ``repro.configs.families``: each arch's config with its
score and retrieval functions, the batch sizes of its cells and its
candidate count (the reference's ``recsys_bundle`` cells ``serve_p99``,
``serve_bulk`` and ``retrieval_cand``), and for its ``train_batch`` cell
the loss, the optimizer settings and the train step."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import TrainerConfig, build_train_step

# families.py:334-336 of the reference
RECSYS_BATCH_SIZES = {"train_batch": 65_536, "serve_p99": 512,
                      "serve_bulk": 262_144}
# families.py:337: the recsys bundle's optimizer
RECSYS_OPT = OptConfig(lr=1e-3, weight_decay=1e-5, schedule="const",
                       warmup_steps=100, total_steps=100_000)


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


def _train_fn(loss_fn: Callable, opt: OptConfig):
    return build_train_step(loss_fn, TrainerConfig(opt=opt))


@dataclasses.dataclass(frozen=True)
class RecsysTraining:
    """The ``train_batch`` cell: ``init(cfg, gen, masters=True)`` draws
    the f32 masters, ``loss(cfg, params, batch)`` is the objective."""
    name: str
    config: Any
    init: Callable
    loss: Callable
    batch_size: int
    opt: OptConfig = RECSYS_OPT

    def loss_fn(self) -> Callable:
        """``loss(params, batch)`` at this config."""
        return lambda p, b: self.loss(self.config, p, b)

    def train_step(self):
        """The cell's ``step(params, opt_state, batch)``; it donates
        ``params`` and ``opt_state`` (updates them in place)."""
        return _train_fn(self.loss_fn(), self.opt)


def recsys_training(sv: RecsysServing, loss: Callable) -> RecsysTraining:
    """The training cell of the arch that ``sv`` serves."""
    return RecsysTraining(name=sv.name, config=sv.config, init=sv.init,
                          loss=loss, batch_size=sv.batch_sizes["train_batch"])
