"""two-tower-retrieval [RecSys'19 YouTube-style]: embed_dim=256, tower MLP
1024-512-256, dot interaction, in-batch sampled softmax."""

import torch

from repro_torch.configs.families import (
    RECSYS_BATCH_SIZES,
    RecsysServing,
    RecsysTraining,
    recsys_training,
)
from repro_torch.models import recsys as RS

F32, I32 = torch.float32, torch.int32

CONFIG = RS.TwoTowerConfig()
REDUCED = RS.TwoTowerConfig(
    n_users=2000, n_items=1000, n_context=100, embed_dim=32,
    tower_mlp=(64, 32),
)


def _train_inputs(cfg):
    def fn(B):
        return {"user_id": ((B,), I32), "user_ctx": ((B,), I32),
                "item_id": ((B,), I32), "item_cat": ((B,), I32)}
    return fn


def _retrieval_inputs(cfg, n_cand):
    def fn():
        return {"user_id": ((1,), I32), "user_ctx": ((1,), I32),
                "candidate_embs": ((n_cand, cfg.tower_mlp[-1]), F32)}
    return fn


def serving(reduced: bool = False) -> RecsysServing:
    cfg = REDUCED if reduced else CONFIG
    return RecsysServing(
        name="two-tower-retrieval", config=cfg,
        init=RS.twotower_init, score=RS.twotower_score,
        candidate_scores=RS.twotower_candidate_scores,
        retrieval=RS.twotower_retrieval,
        batch_sizes=({"train_batch": 128, "serve_p99": 32, "serve_bulk": 256}
                     if reduced else RECSYS_BATCH_SIZES),
        n_candidates=1000 if reduced else 1_000_000,
        retrieval_reads=("user", "ctx", "user_tower"),
        train_inputs=_train_inputs(cfg), serve_inputs=_train_inputs(cfg),
        retrieval_inputs=_retrieval_inputs(cfg, 1000 if reduced else 1_000_000),
    )


def training(reduced: bool = False) -> RecsysTraining:
    return recsys_training(serving(reduced), RS.twotower_loss)
