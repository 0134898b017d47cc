"""Dense gated MLP block (SwiGLU for the gateway tiers), PyTorch."""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed.sharding import row_parallel
from repro_torch.models import quant as Q
from repro_torch.models.common import (ACTIVATIONS, ModelConfig,
                                       frozen_zeros, rmsnorm)


class MLP(nn.Module):
    """Parameters in the JAX layouts (``mlp_defs``): w_up/w_gate (D,F),
    w_down (F,D), and the block's ``norm`` unless ``norm=False`` (an MoE's
    shared expert shares the MoE block's norm).  ``d_ff`` defaults to
    ``cfg.d_ff``."""

    #: each parameter's logical axes, as the reference's ``mlp_defs`` tags
    #: them (``distributed/sharding.py``)
    AXES = {"norm": ("norm",), "w_up": ("embed", "ffn"),
            "w_gate": ("embed", "ffn"), "w_down": ("ffn", "embed")}

    def __init__(self, cfg: ModelConfig, d_ff: int | None = None,
                 norm: bool = True, device=None):
        super().__init__()
        D, F = cfg.d_model, d_ff or cfg.d_ff

        def p(*shape):
            return frozen_zeros(*shape, dtype=cfg.dtype, device=device)

        if norm:
            self.norm = p(D)
        self.w_up, self.w_down = p(D, F), p(F, D)
        if cfg.ffn_act in ("swiglu", "geglu"):
            self.w_gate = p(D, F)


def mlp_block(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    return x + mlp_body(p, h, cfg)


def mlp_body(p: MLP, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The MLP on normed activations h (..., D), in h's dtype (the JAX
    ``_mlp_body``)."""
    act = ACTIVATIONS[cfg.ffn_act]
    tp = getattr(p, "tp", None)
    if tp is not None:
        h = tp.enter(h)                  # into the rank's d_ff columns
    up = h @ Q.cast(p.w_up, h.dtype)
    if hasattr(p, "w_gate"):
        up = act(h @ Q.cast(p.w_gate, h.dtype)) * up
    else:
        up = act(up)
    # row-parallel on a mesh: summed over the axes d_ff was cut over
    return row_parallel(p, up, p.w_down)
