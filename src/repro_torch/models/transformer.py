"""Dense GQA decoder: embeddings -> layers -> LM head (PyTorch).

Mirrors the dense path of ``repro/models/transformer.py``.  The JAX package
scans stacked stage parameters; here the layers are an ``nn.ModuleList`` in
layer order and each parameter keeps its JAX layout, so converting a JAX
parameter tree is a copy (``repro_torch.convert``).  Only the attention +
MLP block of the four gateway tiers is ported; other mixers raise.

The functions keep the JAX signatures with the model in the ``params``
slot.  ``forward`` runs the full-sequence path (``run_layers``, shared with
the safety encoder); ``prefill`` and ``decode_step`` write the KV cache in
place.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention, ffn
from repro_torch.models.common import ModelConfig, frozen_zeros, rmsnorm


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.mixer = attention.Attention(cfg, device)
        self.ffn = ffn.MLP(cfg, device)


class Transformer(nn.Module):
    """Zero-filled parameters; fill them with ``init_params`` or
    ``convert.from_jax_params``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        for kind in cfg.layer_plan():
            if kind not in (("attn", "mlp"), ("attn_local", "mlp")):
                raise NotImplementedError(
                    f"{cfg.name}: layer kind {kind} is not ported yet "
                    "(dense attention + MLP only)")
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab_size
        z = dict(dtype=cfg.dtype, device=device)
        self.embed = frozen_zeros(V, D, **z)
        self.final_norm = frozen_zeros(D, **z)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.num_layers))
        if not cfg.tie_embeddings:
            self.lm_head = frozen_zeros(D, V, **z)

    def head(self) -> torch.Tensor:
        """(D, V): the tied ``embed.T`` or the untied ``lm_head``."""
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """Random weights with the JAX init distribution (``init_weights``)
    for a fresh ``Transformer(cfg)`` on ``device``.  Draws on
    ``generator``'s device; the numbers differ from JAX's for the same seed
    (tests convert JAX's weights instead)."""
    return init_weights(Transformer(cfg, device), cfg, generator)


def init_weights(model: nn.Module, cfg: ModelConfig,
                 generator: torch.Generator) -> nn.Module:
    """Fill ``model`` in place with the JAX init distribution: normal(0.02)
    drawn in f32 then cast, ``wo``/``w_down`` at 0.02/sqrt(2L), norms and
    biases 0.  Shared by every module built on the ``Transformer`` body
    (the safety classifier too)."""
    std_o = 0.02 / (2 * cfg.num_layers) ** 0.5
    gdev = generator.device
    with torch.no_grad():
        for name, prm in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("norm", "final_norm", "bq", "bk", "bv", "head_b"):
                continue                                   # zeros
            std = std_o if leaf in ("wo", "w_down") else 0.02
            w = torch.randn(prm.shape, generator=generator, device=gdev,
                            dtype=torch.float32) * std
            prm.copy_(w.to(cfg.dtype))
    return model


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> list[attention.KVCache]:
    """One ``KVCache`` per layer: k/v zeros, pos -1."""
    return [attention.init_kv_cache(cfg, batch, max_len,
                                    local=(mixer == "attn_local"),
                                    device=device)
            for mixer, _ in cfg.layer_plan()]


def grow_cache(cfg: ModelConfig, cache: list, batch: int, new_len: int,
               device=None) -> list:
    """A copy of every layer cache at ``new_len`` slots (>= the current
    length): the old slots copied in, the new ones empty (k/v 0, pos -1).
    Window-clamped ring caches that keep their size pass through."""
    out = []
    for tmpl, c in zip(init_cache(cfg, batch, new_len, device=device),
                       cache):
        if tmpl.k.shape == c.k.shape:
            out.append(c)
            continue
        T = c.k.shape[1]
        for t, old in zip(tmpl, c):
            t[:, :T].copy_(old)
        out.append(tmpl)
    return out


def embed_inputs(params: Transformer, cfg: ModelConfig,
                 batch: dict) -> torch.Tensor:
    """batch["tokens"] (B,S) -> (B,S,D) in the compute dtype."""
    return params.embed[batch["tokens"].long()].to(cfg.comp_dtype)


def _logits(params: Transformer, cfg: ModelConfig,
            x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return x @ params.head().to(x.dtype)


def run_layers(layers: nn.ModuleList, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Every layer's full-sequence block over x (B,S,D), in layer order: the
    counterpart of the JAX ``_run_stage`` over all stages (attention at
    positions 0..S-1, no cache)."""
    for layer, (mixer, _) in zip(layers, cfg.layer_plan()):
        x = attention.attn_block(layer.mixer, x, cfg,
                                 local=(mixer == "attn_local"))
        x = ffn.mlp_block(layer.ffn, x, cfg)
    return x


def forward(params: Transformer, cfg: ModelConfig,
            batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B,S,V), moe_aux = 0)."""
    tokens = batch["tokens"]
    x = run_layers(params.layers, embed_inputs(params, cfg, batch), cfg)
    return (_logits(params, cfg, x),
            torch.zeros((), dtype=torch.float32, device=tokens.device))


def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            cache: list, positions: torch.Tensor, *,
            continuation: bool = False) -> tuple[torch.Tensor, list]:
    """Absorb a whole span in one pass, filling every layer cache in place.

    tokens (B,S); positions (B,S) int32 absolute positions (negative = inert
    bucket padding).  Cold only: a freshly initialised cache and a
    LEFT-padded span starting at position 0.  Returns (logits (B,S,V),
    cache)."""
    x = embed_inputs(params, cfg, {"tokens": tokens})
    for layer, c, (mixer, _) in zip(params.layers, cache, cfg.layer_plan()):
        x, _ = attention.attn_prefill(layer.mixer, x, c, positions, cfg,
                                      local=(mixer == "attn_local"),
                                      continuation=continuation)
        x = ffn.mlp_block(layer.ffn, x, cfg)
    return _logits(params, cfg, x), cache


def decode_step(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
                cache: list, index: torch.Tensor) -> tuple[torch.Tensor, list]:
    """tokens (B,1); index (B,) int32 positions -> (logits (B,1,V), cache),
    the cache updated in place."""
    x = embed_inputs(params, cfg, {"tokens": tokens})
    for layer, c, (mixer, _) in zip(params.layers, cache, cfg.layer_plan()):
        x, _ = attention.attn_decode(layer.mixer, x, c, index, cfg,
                                     local=(mixer == "attn_local"))
        x = ffn.mlp_block(layer.ffn, x, cfg)
    return _logits(params, cfg, x), cache
