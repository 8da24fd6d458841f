"""sasrec [arXiv:1808.09781]: embed_dim=50, 2 blocks, 1 head, seq_len=50,
causal self-attention over the behavior sequence."""

import torch

from repro_torch.configs.families import (
    RECSYS_BATCH_SIZES,
    RecsysServing,
    RecsysTraining,
    recsys_training,
)
from repro_torch.models import recsys as RS

F32, I32 = torch.float32, torch.int32

CONFIG = RS.SASRecConfig(n_items=60_000)
REDUCED = RS.SASRecConfig(n_items=500, seq_len=16)


def _train_inputs(cfg):
    def fn(B):
        return {"seq": ((B, cfg.seq_len), I32),
                "labels": ((B, cfg.seq_len), I32)}
    return fn


def _serve_inputs(cfg, n_cand=200):
    def fn(B):
        return {"seq": ((B, cfg.seq_len), I32),
                "candidates": ((B, n_cand), I32)}
    return fn


def _retrieval_inputs(cfg, n_cand):
    def fn():
        return {"seq": ((1, cfg.seq_len), I32),
                "candidates": ((n_cand,), I32)}
    return fn


def serving(reduced: bool = False) -> RecsysServing:
    cfg = REDUCED if reduced else CONFIG
    return RecsysServing(
        name="sasrec", config=cfg,
        init=RS.sasrec_init, score=RS.sasrec_score,
        candidate_scores=RS.sasrec_candidate_scores,
        retrieval=RS.sasrec_retrieval,
        batch_sizes=({"train_batch": 128, "serve_p99": 32, "serve_bulk": 256}
                     if reduced else RECSYS_BATCH_SIZES),
        n_candidates=500 if reduced else 1_000_000,
        serve_candidates=200,
        train_inputs=_train_inputs(cfg), serve_inputs=_serve_inputs(cfg),
        retrieval_inputs=_retrieval_inputs(cfg, 500 if reduced else 1_000_000),
    )


def training(reduced: bool = False) -> RecsysTraining:
    return recsys_training(serving(reduced), RS.sasrec_loss)
