"""RecurrentGemma-2B [arXiv:2402.19427]: RG-LRU + local attention, 1:2.

26 layers = 8 x (rglru, rglru, local-attn) + (rglru, rglru) remainder; the
KV footprint is bounded by the 2048-slot window.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256000,
        mixer_pattern=("rglru", "rglru", "attn_local"),
        window=2048, rnn_width=2560, rnn_conv_width=4,
        ffn_act="geglu", tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke", family="hybrid",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=128,
        mixer_pattern=("rglru", "rglru", "attn_local"),
        window=32, rnn_width=64, rnn_conv_width=4,
        ffn_act="geglu", tie_embeddings=True,
        attn_q_block=32, attn_kv_block=32,
    )
