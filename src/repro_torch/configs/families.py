"""Family bundles, the port of ``repro.configs.families`` without its
sharding rules and abstract input specs (a mesh is ROADMAP.md queue 1,
item 12).

  * LM (:class:`LMBundle`, the reference's ``lm_bundle``): the config,
    its init, the ``train_4k`` loss and train step with the config's
    microbatches and optimizer, and the (batch, sequence) shapes of the
    four cells (``models.transformer.prefill`` and ``decode_step`` serve
    the other three).
  * RecSys (:class:`RecsysServing`, :class:`RecsysTraining`, gathered
    in :class:`RecsysBundle`; the reference's ``recsys_bundle``): each
    arch's config with its score and retrieval functions, the batch
    sizes of its cells and its candidate count (cells ``serve_p99``,
    ``serve_bulk`` and ``retrieval_cand``), and for its ``train_batch``
    cell the loss, the optimizer settings and the train step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import transformer as TF
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import TrainerConfig, build_train_step

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
# families.py:90-95 of the reference: (batch, sequence) of each LM cell
LM_CELL_SHAPES = {"train_4k": (256, 4096), "prefill_32k": (32, 32768),
                  "decode_32k": (128, 32768), "long_500k": (1, 524288)}
# the reference configs' bundles at REDUCED
REDUCED_LM_CELL_SHAPES = {"train_4k": (4, 64), "prefill_32k": (2, 64),
                          "decode_32k": (4, 64), "long_500k": (1, 128)}

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


def _train_fn(loss_fn: Callable, opt: OptConfig, microbatches: int = 1):
    return build_train_step(loss_fn, TrainerConfig(opt=opt,
                                                   microbatches=microbatches))


@dataclasses.dataclass(frozen=True)
class LMBundle:
    """An LM arch's cells.  ``shapes[cell]`` is the (batch, sequence) of
    ``train_4k`` and ``prefill_32k`` and the (slots, S_max) of the two
    decode cells; ``train_4k`` accumulates over ``microbatches``."""
    name: str
    config: TF.TransformerConfig
    shapes: Dict[str, Tuple[int, int]]
    microbatches: int = 1
    opt: OptConfig = OptConfig()
    family: str = "lm"

    @property
    def cells(self) -> Tuple[str, ...]:
        return LM_SHAPES

    def init(self, gen: torch.Generator, masters: bool = True):
        """Parameters drawn on ``gen``'s device: f32 masters (the
        reference bundle's init), or with ``masters=False`` the serving
        layout in ``config.dtype``."""
        return TF.init_params(self.config, gen, masters=masters)

    def loss_fn(self) -> Callable:
        """``loss(params, batch)``: ``lm_loss`` of ``batch["tokens"]``
        against ``batch["labels"]``."""
        cfg = self.config
        return lambda p, b: TF.lm_loss(cfg, p, b["tokens"], b["labels"])[0]

    def train_step(self):
        """The ``train_4k`` cell's ``step(params, opt_state, batch)``; it
        donates ``params`` and ``opt_state`` (updates them in place)."""
        return _train_fn(self.loss_fn(), self.opt, self.microbatches)


def lm_bundle(name: str, cfg: TF.TransformerConfig,
              shapes: Optional[Dict[str, Tuple[int, int]]] = None,
              opt: Optional[OptConfig] = None,
              microbatches: int = 1) -> LMBundle:
    return LMBundle(name=name, config=cfg,
                    shapes=dict(shapes or LM_CELL_SHAPES),
                    microbatches=microbatches, opt=opt or OptConfig())


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


@dataclasses.dataclass(frozen=True)
class RecsysBundle:
    """A recsys arch's four cells: ``serving`` has the three serve cells,
    ``training`` the ``train_batch`` cell."""
    name: str
    serving: RecsysServing
    training: RecsysTraining
    family: str = "recsys"

    @property
    def config(self) -> Any:
        return self.serving.config

    @property
    def cells(self) -> Tuple[str, ...]:
        return RECSYS_SHAPES
