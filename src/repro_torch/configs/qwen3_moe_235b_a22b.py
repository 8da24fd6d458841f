"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-235B-A22B family]: 94L d_model=4096
64H GQA kv=4 MoE 128 experts top-8 expert d_ff=1536, vocab 151936,
no shared experts, untied."""

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=1536,
    vocab=151_936,
    qkv_bias=False,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    moe=MoEConfig(
        n_experts=128, top_k=8, d_ff=1536, n_shared_experts=0,
        capacity_factor=1.25, group_tokens=4096,
    ),
)

REDUCED = TransformerConfig(
    name="qwen3-moe-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=64, vocab=512, tie_embeddings=False, loss_chunk=32, flash_chunk=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=48, n_shared_experts=0,
                  capacity_factor=2.0, group_tokens=128),
)

# the reference bundle's train_4k microbatches
MICROBATCHES = 16
