"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M]: llama-arch small, tied embed.

Doubles as the paper's probe/edge SLM tier in the swarm prototype.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
        head_dim=64, d_ff=1536, vocab_size=49152,
        tie_embeddings=True, rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m-smoke", family="dense",
        num_layers=2, d_model=48, num_heads=3, num_kv_heads=1,
        head_dim=16, d_ff=96, vocab_size=128,
        tie_embeddings=True, attn_q_block=32, attn_kv_block=32,
    )
