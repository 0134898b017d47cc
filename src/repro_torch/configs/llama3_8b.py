"""Llama-3-8B [arXiv:2407.21783]: dense GQA, 128k vocab."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=128256,
        rope_theta=500_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=160, vocab_size=128,
        attn_q_block=32, attn_kv_block=32,
    )
