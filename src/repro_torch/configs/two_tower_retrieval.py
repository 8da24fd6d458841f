"""two-tower-retrieval [RecSys'19 YouTube-style]: embed_dim=256, tower MLP
1024-512-256, dot interaction, in-batch sampled softmax."""

from repro_torch.configs.families import (
    RECSYS_BATCH_SIZES,
    RecsysServing,
    RecsysTraining,
    recsys_training,
)
from repro_torch.models import recsys as RS

CONFIG = RS.TwoTowerConfig()
REDUCED = RS.TwoTowerConfig(
    n_users=2000, n_items=1000, n_context=100, embed_dim=32,
    tower_mlp=(64, 32),
)


def serving(reduced: bool = False) -> RecsysServing:
    return RecsysServing(
        name="two-tower-retrieval", config=REDUCED if reduced else CONFIG,
        init=RS.twotower_init, score=RS.twotower_score,
        candidate_scores=RS.twotower_candidate_scores,
        retrieval=RS.twotower_retrieval,
        batch_sizes=({"train_batch": 128, "serve_p99": 32, "serve_bulk": 256}
                     if reduced else RECSYS_BATCH_SIZES),
        n_candidates=1000 if reduced else 1_000_000,
    )


def training(reduced: bool = False) -> RecsysTraining:
    return recsys_training(serving(reduced), RS.twotower_loss)
