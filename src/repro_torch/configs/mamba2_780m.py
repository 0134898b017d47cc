"""Mamba2-780M [arXiv:2405.21060]: attention-free SSD, O(1) decode state.

The long-context swarm member: its decode cost does not grow with the
context.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
        head_dim=0, d_ff=0, vocab_size=50280,
        mixer_pattern=("ssd",), tie_embeddings=True,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_ngroups=1,
        ssm_conv_width=4, ssm_chunk=256,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
        head_dim=0, d_ff=0, vocab_size=128,
        mixer_pattern=("ssd",), tie_embeddings=True,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_ngroups=1,
        ssm_conv_width=4, ssm_chunk=32,
    )
