"""Safety / policy risk classifier C_safety (paper Sec. IV-C, Eq. 5-6),
PyTorch.

Mirrors ``repro/core/safety.py``: token embeddings -> 2 bidirectional
encoder blocks (the dense ``Transformer`` body with ``causal=False`` and a
tanh-gelu MLP) -> masked mean-pool -> linear -> sigmoid risk score
s in [0, 1]; R(Q) = 1[s > sigma] (Eq. 6).  The encoder's attention is the
grid-offset flash op (``models/attention.attn_block``); its training
(``bce_loss``, ``make_trainer``, ``train_step``) runs the same encoder
through the training route (``attention.chunked_attention``, autograd), as
the reference trains through XLA.

As in the reference, the encoder has NO attention mask: PAD tokens (0) of
the right-aligned prompt attend and are attended to; only the mean-pool
excludes them.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import (ModelConfig, frozen_zeros,
                                       resolve_device)


def classifier_config(vocab_size: int = 2048, d_model: int = 128,
                      num_layers: int = 2) -> ModelConfig:
    return ModelConfig(
        name="c-safety", family="encoder",
        num_layers=num_layers, d_model=d_model,
        num_heads=4, num_kv_heads=4, head_dim=d_model // 4,
        d_ff=4 * d_model, vocab_size=vocab_size,
        causal=False, ffn_act="gelu",
        attn_q_block=64, attn_kv_block=64, scan_layers=True,
    )


class SafetyClassifier(T.Transformer):
    """The dense ``Transformer`` body without ``lm_head``, plus the linear
    head ``head_w`` (D, 1) and ``head_b`` (1,).  ``final_norm`` is kept (the
    JAX tree has it) but, as there, unused."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        if hasattr(self, "lm_head"):
            del self.lm_head
        self.head_w = frozen_zeros(cfg.d_model, 1, dtype=cfg.dtype,
                                   device=device)
        self.head_b = frozen_zeros(1, dtype=cfg.dtype, device=device)


def init_safety(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> SafetyClassifier:
    """Random weights with the JAX init distribution
    (``transformer.init_weights``; ``head_w`` normal(0.02), ``head_b`` 0),
    on ``device``: the card when None, as the engines are (no card raises
    unless the caller passes ``device="cpu"``)."""
    device = resolve_device(device, "init_safety")
    return T.init_weights(SafetyClassifier(cfg, device), cfg, generator)


def safety_score(params: SafetyClassifier, cfg: ModelConfig,
                 tokens: torch.Tensor,
                 mask: torch.Tensor | None = None, *,
                 train: bool = False) -> torch.Tensor:
    """tokens (B, S) -> s (B,) in [0, 1], f32.  Eq. 5.  PAD=0 is excluded
    from the pool and nowhere else.  ``train=True`` runs the encoder
    through the training route (autograd)."""
    if mask is None:
        mask = (tokens > 0).float()
    x = T.embed_inputs(params, cfg, {"tokens": tokens.clamp_min(0)})
    x = T.run_layers(params.layers, x, cfg, train=train)
    xf = x.float() * mask[..., None]
    pooled = xf.sum(1) / mask.sum(1, keepdim=True).clamp_min(1.0)
    logit = pooled @ params.head_w.float() + params.head_b.float()
    return torch.sigmoid(logit[..., 0])


def risk_flag(s: torch.Tensor, sigma: float) -> torch.Tensor:
    """Eq. 6: R(Q) = 1[s > sigma]."""
    return (s > sigma).to(torch.int32)


def bce_loss(params: SafetyClassifier, cfg: ModelConfig, tokens: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy of s (clipped to [1e-6, 1 - 1e-6]) against
    ``labels`` (B,), over the training route."""
    s = safety_score(params, cfg, tokens, train=True).clamp(1e-6, 1 - 1e-6)
    y = labels.float()
    return -(y * torch.log(s) + (1 - y) * torch.log(1 - s)).mean()


def make_trainer(cfg: ModelConfig, lr: float = 1e-2, steps: int = 200):
    """AdamW trainer for the classifier (tiny models need an adaptive lr):
    ``step(params, state, tokens, labels) -> (params, state, loss)``, the
    classifier and state updated in place."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train import value_and_grad
    ocfg = opt.AdamWConfig(lr=lr, total_steps=steps, warmup_steps=10,
                           weight_decay=0.0)

    def step(params, state, tokens, labels):
        loss, grads = value_and_grad(bce_loss, params, cfg, tokens, labels)
        params, state, _ = opt.apply(grads, params, state, ocfg)
        return params, state, loss

    return step


def train_step(params: SafetyClassifier, cfg: ModelConfig,
               tokens: torch.Tensor, labels: torch.Tensor,
               lr: float = 1e-3) -> tuple[SafetyClassifier, torch.Tensor]:
    """One plain-SGD step, in place: p = (p_f32 - lr * g_f32) cast back to
    p's dtype.  Returns (params, loss)."""
    from repro_torch.training.train import value_and_grad
    loss, grads = value_and_grad(bce_loss, params, cfg, tokens, labels)
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(p.float() - lr * grads[n].float())
    return params, loss
