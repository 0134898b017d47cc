"""Llama-4-Scout-17B-16E-style MoE [hf:meta-llama/Llama-4-Scout-17B-16E].

16 routed experts, top-1, plus one always-on shared expert, every layer.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=202048,
        num_experts=16, num_shared_experts=1, top_k=1, expert_d_ff=8192,
        rope_theta=500_000.0, capacity_factor=1.25,
        # top-1 routing collides easily: serving dispatch stays drop-free
        # (None => per-position capacity = batch size, exact top-1)
        moe_serve_capacity_factor=None,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=96, vocab_size=128,
        num_experts=4, num_shared_experts=1, top_k=1, expert_d_ff=96,
        attn_q_block=32, attn_kv_block=32,
    )
