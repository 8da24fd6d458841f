"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base]: 40L d_model=2048
32H GQA kv=8 d_ff=8192 vocab=49155, tied embeddings."""

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="granite-3-2b",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_head=64,
    d_ff=8192,
    vocab=49_155,
    qkv_bias=False,
    rope_theta=10_000.0,
    tie_embeddings=True,
)

REDUCED = TransformerConfig(
    name="granite-3-2b-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=256, vocab=512, tie_embeddings=True, loss_chunk=32, flash_chunk=16,
)

# the reference bundle's train_4k microbatches
MICROBATCHES = 4
