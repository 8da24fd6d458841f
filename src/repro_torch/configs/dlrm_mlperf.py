"""dlrm-mlperf [arXiv:1906.00091, MLPerf]: 13 dense + 26 sparse features,
embed_dim=128, bottom MLP 13-512-256-128, top MLP 1024-1024-512-256-1,
dot interaction.  Table cardinalities: Criteo-1TB (MLPerf v1 setting)."""

import torch

from repro_torch.configs.families import (
    RECSYS_BATCH_SIZES,
    RecsysServing,
    RecsysTraining,
    recsys_training,
)
from repro_torch.models import recsys as RS

F32, I32 = torch.float32, torch.int32

# Criteo Terabyte per-feature cardinalities (MLPerf DLRM benchmark set)
CRITEO_1TB_ROWS = (
    45833138, 36746, 17245, 7413, 20243, 3, 7114, 1441, 62, 29275261,
    1572176, 345138, 10, 2209, 11267, 128, 4, 974, 14, 48937457,
    11316796, 40094537, 452104, 12606, 104, 35,
)

CONFIG = RS.DLRMConfig(table_rows=CRITEO_1TB_ROWS)
REDUCED = RS.DLRMConfig(
    table_rows=tuple(min(r, 1000) for r in CRITEO_1TB_ROWS),
    bot_mlp=(64, 32, 16), top_mlp=(64, 32, 1), embed_dim=16,
)


def _train_inputs(cfg):
    def fn(B):
        return {"dense": ((B, cfg.n_dense), F32),
                "sparse": ((B, cfg.n_sparse), I32),
                "label": ((B,), F32)}
    return fn


def _serve_inputs(cfg):
    def fn(B):
        return {"dense": ((B, cfg.n_dense), F32),
                "sparse": ((B, cfg.n_sparse), I32)}
    return fn


def _retrieval_inputs(cfg, n_cand):
    def fn():
        return {"dense": ((1, cfg.n_dense), F32),
                "sparse": ((1, cfg.n_sparse), I32),
                "candidates": ((n_cand,), I32)}
    return fn


def serving(reduced: bool = False) -> RecsysServing:
    cfg = REDUCED if reduced else CONFIG
    return RecsysServing(
        name="dlrm-mlperf", config=cfg,
        init=RS.dlrm_init, score=RS.dlrm_forward,
        candidate_scores=RS.dlrm_candidate_scores,
        retrieval=RS.dlrm_retrieval,
        batch_sizes=({"train_batch": 256, "serve_p99": 64, "serve_bulk": 512}
                     if reduced else RECSYS_BATCH_SIZES),
        n_candidates=1000 if reduced else 1_000_000,
        train_inputs=_train_inputs(cfg), serve_inputs=_serve_inputs(cfg),
        retrieval_inputs=_retrieval_inputs(cfg, 1000 if reduced else 1_000_000),
    )


def training(reduced: bool = False) -> RecsysTraining:
    return recsys_training(serving(reduced), RS.dlrm_loss)
