"""din [arXiv:1706.06978]: embed_dim=18, behavior seq_len=100, target
attention MLP 80-40, head MLP 200-80."""

import torch

from repro_torch.configs.families import (
    RECSYS_BATCH_SIZES,
    RecsysServing,
    RecsysTraining,
    recsys_training,
)
from repro_torch.models import recsys as RS

F32, I32 = torch.float32, torch.int32

CONFIG = RS.DINConfig(n_items=1_000_000, n_cates=10_000)
REDUCED = RS.DINConfig(n_items=1000, n_cates=50, seq_len=20)


def _train_inputs(cfg):
    def fn(B):
        return {"hist_items": ((B, cfg.seq_len), I32),
                "hist_cates": ((B, cfg.seq_len), I32),
                "hist_mask": ((B, cfg.seq_len), F32),
                "target_item": ((B,), I32),
                "target_cate": ((B,), I32),
                "label": ((B,), F32)}
    return fn


def _serve_inputs(cfg):
    def fn(B):
        d = _train_inputs(cfg)(B)
        d.pop("label")
        return d
    return fn


def _retrieval_inputs(cfg, n_cand):
    def fn():
        return {"hist_items": ((1, cfg.seq_len), I32),
                "hist_cates": ((1, cfg.seq_len), I32),
                "hist_mask": ((1, cfg.seq_len), F32),
                "candidates": ((n_cand,), I32),
                "candidate_cates": ((n_cand,), I32)}
    return fn


def serving(reduced: bool = False) -> RecsysServing:
    cfg = REDUCED if reduced else CONFIG
    return RecsysServing(
        name="din", config=cfg,
        init=RS.din_init, score=RS.din_forward,
        candidate_scores=RS.din_candidate_scores, retrieval=RS.din_retrieval,
        batch_sizes=({"train_batch": 128, "serve_p99": 32, "serve_bulk": 256}
                     if reduced else RECSYS_BATCH_SIZES),
        n_candidates=500 if reduced else 1_000_000,
        train_inputs=_train_inputs(cfg), serve_inputs=_serve_inputs(cfg),
        retrieval_inputs=_retrieval_inputs(cfg, 500 if reduced else 1_000_000),
    )


def training(reduced: bool = False) -> RecsysTraining:
    return recsys_training(serving(reduced), RS.din_loss)
