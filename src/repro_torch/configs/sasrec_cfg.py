"""sasrec [arXiv:1808.09781]: embed_dim=50, 2 blocks, 1 head, seq_len=50,
causal self-attention over the behavior sequence."""

from repro_torch.configs.families import (
    RECSYS_BATCH_SIZES,
    RecsysServing,
    RecsysTraining,
    recsys_training,
)
from repro_torch.models import recsys as RS

CONFIG = RS.SASRecConfig(n_items=60_000)
REDUCED = RS.SASRecConfig(n_items=500, seq_len=16)


def serving(reduced: bool = False) -> RecsysServing:
    return RecsysServing(
        name="sasrec", config=REDUCED if reduced else CONFIG,
        init=RS.sasrec_init, score=RS.sasrec_score,
        candidate_scores=RS.sasrec_candidate_scores,
        retrieval=RS.sasrec_retrieval,
        batch_sizes=({"train_batch": 128, "serve_p99": 32, "serve_bulk": 256}
                     if reduced else RECSYS_BATCH_SIZES),
        n_candidates=500 if reduced else 1_000_000,
        serve_candidates=200,
    )


def training(reduced: bool = False) -> RecsysTraining:
    return recsys_training(serving(reduced), RS.sasrec_loss)
