"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: 48L d_model=2048
16H kv=16 MoE 64 experts top-6 expert d_ff=1408, 2 shared experts
(DeepSeek-style), vocab 163840."""

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,  # expert hidden (unused for dense path)
    vocab=163_840,
    qkv_bias=False,
    rope_theta=50_000.0,
    tie_embeddings=True,
    moe=MoEConfig(
        n_experts=64, top_k=6, d_ff=1408, n_shared_experts=2,
        capacity_factor=1.25, group_tokens=4096,
    ),
)

REDUCED = TransformerConfig(
    name="moonshot-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=64, vocab=512, tie_embeddings=True, loss_chunk=32, flash_chunk=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=64, n_shared_experts=1,
                  capacity_factor=2.0, group_tokens=128),
)

# the reference bundle's train_4k microbatches
MICROBATCHES = 8
