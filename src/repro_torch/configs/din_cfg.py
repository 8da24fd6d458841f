"""din [arXiv:1706.06978]: embed_dim=18, behavior seq_len=100, target
attention MLP 80-40, head MLP 200-80."""

from repro_torch.configs.families import (
    RECSYS_BATCH_SIZES,
    RecsysServing,
    RecsysTraining,
    recsys_training,
)
from repro_torch.models import recsys as RS

CONFIG = RS.DINConfig(n_items=1_000_000, n_cates=10_000)
REDUCED = RS.DINConfig(n_items=1000, n_cates=50, seq_len=20)


def serving(reduced: bool = False) -> RecsysServing:
    return RecsysServing(
        name="din", config=REDUCED if reduced else CONFIG,
        init=RS.din_init, score=RS.din_forward,
        candidate_scores=RS.din_candidate_scores, retrieval=RS.din_retrieval,
        batch_sizes=({"train_batch": 128, "serve_p99": 32, "serve_bulk": 256}
                     if reduced else RECSYS_BATCH_SIZES),
        n_candidates=500 if reduced else 1_000_000,
    )


def training(reduced: bool = False) -> RecsysTraining:
    return recsys_training(serving(reduced), RS.din_loss)
