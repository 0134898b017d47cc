"""HuBERT-XLarge [arXiv:2106.07447]: 48-layer encoder-only audio backbone.

The conv waveform frontend is a stub: a batch carries precomputed frame
embeddings at d_model as ``frontend_embeds``.  Vocabulary 504 is the
masked-unit (cluster) prediction head.  Encoder only: ``forward`` and
training run, the engine refuses it (no decode step).
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio",
        num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
        head_dim=80, d_ff=5120, vocab_size=504,
        causal=False, ffn_act="gelu", frontend="audio_frames",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke", family="audio",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=64,
        causal=False, ffn_act="gelu", frontend="audio_frames",
        attn_q_block=32, attn_kv_block=32,
    )
