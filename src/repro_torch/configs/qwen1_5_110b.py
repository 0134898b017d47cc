"""Qwen1.5-110B-style dense GQA decoder [hf:Qwen/Qwen1.5-*]: QKV bias."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=49152, vocab_size=152064,
        attn_bias=True, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=128,
        attn_bias=True, attn_q_block=32, attn_kv_block=32,
    )
