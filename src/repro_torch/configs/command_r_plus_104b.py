"""Command-R+-104B-style dense GQA [hf:CohereForAI/c4ai-command-r-*]: no bias."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b", family="dense",
        num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
        head_dim=128, d_ff=33792, vocab_size=256000,
        rope_theta=75_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=128,
        attn_q_block=32, attn_kv_block=32,
    )
