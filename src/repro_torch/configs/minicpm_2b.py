"""minicpm-2b [arXiv:2404.06395; hf]: 40L d_model=2304 36H (MHA kv=36)
d_ff=5760 vocab=122753, tied embeddings (MiniCPM ties), trained with the
WSD schedule."""

from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optim import OptConfig

CONFIG = TransformerConfig(
    name="minicpm-2b",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_head=64,
    d_ff=5760,
    vocab=122_753,
    qkv_bias=False,
    rope_theta=10_000.0,
    tie_embeddings=True,
)

REDUCED = TransformerConfig(
    name="minicpm-2b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=160, vocab=512, tie_embeddings=True, loss_chunk=32, flash_chunk=16,
)

# the reference bundle's train_4k microbatches
MICROBATCHES = 4

# the WSD (warmup-stable-decay) schedule is the arch's signature trainer
OPT = OptConfig(lr=1e-2 / 4, schedule="wsd", warmup_steps=500,
                total_steps=50_000, decay_fraction=0.1)
