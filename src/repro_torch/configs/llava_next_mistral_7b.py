"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Backbone only: the anyres vision tower is a stub; a batch carries
precomputed patch embeddings (576 tokens = one 24x24 tile) as
``frontend_embeds``, placed ahead of the text tokens
(``transformer.embed_inputs``).  The engine serves the token backbone.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b", family="vlm",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=32000,
        rope_theta=1_000_000.0,
        frontend="vision_patches", frontend_tokens=576,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llava-next-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=160, vocab_size=128,
        frontend="vision_patches", frontend_tokens=16,
        attn_q_block=32, attn_kv_block=32,
    )
