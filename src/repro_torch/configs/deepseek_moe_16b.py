"""DeepSeekMoE-16B [arXiv:2401.06066]: fine-grained 64 routed top-6 + 2 shared.

First layer dense (d_ff 10944), remaining 27 layers MoE with expert_d_ff 1408.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=10944, vocab_size=102400,
        num_experts=64, num_shared_experts=2, top_k=6, expert_d_ff=1408,
        first_k_dense=1, capacity_factor=1.25,
        # serving dispatch stays drop-free exact top-k (None): per-position
        # groups are batch-sized, so the buffer is small anyway
        moe_serve_capacity_factor=None,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-smoke", family="moe",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=160, vocab_size=128,
        num_experts=8, num_shared_experts=2, top_k=2, expert_d_ff=32,
        first_k_dense=1, attn_q_block=32, attn_kv_block=32,
    )
