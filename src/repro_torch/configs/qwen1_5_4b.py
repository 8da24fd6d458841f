"""qwen1.5-4b [hf:Qwen/Qwen1.5 family]: 40L d_model=2560 20H (MHA kv=20)
d_ff=6912 vocab=151936, QKV bias (the Qwen1.5 signature), untied."""

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen1.5-4b",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_head=128,
    d_ff=6912,
    vocab=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

REDUCED = TransformerConfig(
    name="qwen1.5-4b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=192, vocab=512, qkv_bias=True, tie_embeddings=False,
    loss_chunk=32, flash_chunk=16,
)

# the reference bundle's train_4k microbatches
MICROBATCHES = 4
