"""Paper-prototype edge SLM tier (~1B, TinyLlama/Qwen2.5-1.5B class).

Used by the swarm serving examples as a heterogeneous peer alongside
smollm-135m (probe) and llama3-8b (gateway/on-prem FM).
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="swarm-edge-1b", family="dense",
        num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
        head_dim=64, d_ff=5632, vocab_size=32000,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="swarm-edge-1b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=128,
        attn_q_block=32, attn_kv_block=32,
    )
