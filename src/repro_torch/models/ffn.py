"""Dense gated MLP block (SwiGLU for the gateway tiers), PyTorch."""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import (ACTIVATIONS, ModelConfig,
                                       frozen_zeros, rmsnorm)


class MLP(nn.Module):
    """Parameters in the JAX layouts: w_up/w_gate (D,F), w_down (F,D)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, F = cfg.d_model, cfg.d_ff

        def p(*shape):
            return frozen_zeros(*shape, dtype=cfg.dtype, device=device)

        self.norm = p(D)
        self.w_up, self.w_down = p(D, F), p(F, D)
        if cfg.ffn_act in ("swiglu", "geglu"):
            self.w_gate = p(D, F)


def mlp_block(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    act = ACTIVATIONS[cfg.ffn_act]
    up = h @ p.w_up.to(h.dtype)
    if hasattr(p, "w_gate"):
        up = act(h @ p.w_gate.to(h.dtype)) * up
    else:
        up = act(up)
    return x + up @ p.w_down.to(h.dtype)
