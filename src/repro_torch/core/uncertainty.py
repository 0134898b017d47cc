"""Difficulty / uncertainty quantification (paper Sec. IV-B, Eq. 2-4), PyTorch.

  Eq. 2  H_i(t)  = -(1/N) Σ_j P(t_j | t_<j, Q) · log P(t_j | t_<j, Q)
         (``mode="distribution"``: full softmax entropy normalised by log V)
  Eq. 3  V_i(Q) = (1/N) Σ_j Var(z_j^(k))      (top-k logits variance)
  Eq. 4  U_i(Q) = α · H_i(t) + (1-α) · V̂_i(Q),  V̂ = V / (V + v_scale)

Mirrors ``repro/core/uncertainty.py``.  The per-position terms of the
serving path always go through the fused op
(``kernels/swarm_uncertainty``): the CUDA kernel for CUDA logits, its plain
version for CPU logits — so the JAX config's ``use_kernel`` switch has no
counterpart here.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.swarm_uncertainty import ops as kops


@dataclasses.dataclass(frozen=True)
class UncertaintyConfig:
    alpha: float = 0.5          # Eq. 4 mixing weight
    top_k: int = 10             # Eq. 3 top-k logits
    v_scale: float = 25.0       # V̂ = V / (V + v_scale)
    mode: str = "token"         # "token" (paper Eq. 2) | "distribution"
    invert_variance: bool = False  # use (1 - V̂): see the JAX module


def token_nent(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """-p·log p of the chosen token. logits (..., N, V), tokens (..., N)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    lp = logp.gather(-1, tokens[..., None].long())[..., 0]
    return -lp.exp() * lp


def dist_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Full softmax entropy per position, normalised by log V to [0,1]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(logp.exp() * logp).sum(-1) / math.log(logits.shape[-1])


def topk_logit_variance(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Var over the top-k logits at each position (Eq. 3). (..., N)."""
    z = torch.topk(logits.float(), k, dim=-1).values
    return z.var(dim=-1, unbiased=False)


def normalise_variance(v, v_scale: float):
    return v / (v + v_scale)


def uncertainty_terms(logits: torch.Tensor, tokens: torch.Tensor,
                      cfg: UncertaintyConfig):
    """Per-position (entropy, variance) terms of Eq. 2-3, (..., N) each, from
    one fused pass over the logits."""
    return kops.uncertainty_terms(logits, tokens, k=cfg.top_k, mode=cfg.mode)


def combine_terms(h_mean, v_mean, cfg: UncertaintyConfig):
    """Eq. 4 from position-averaged terms -> U in [0,1].  Pure arithmetic:
    works on tensors and on host floats alike."""
    if cfg.mode == "token":
        h_mean = h_mean * math.e        # rescale [0, 1/e] -> [0, 1]
    v_hat = normalise_variance(v_mean, cfg.v_scale)
    if cfg.invert_variance:
        v_hat = 1.0 - v_hat
    return cfg.alpha * h_mean + (1.0 - cfg.alpha) * v_hat


def difficulty(logits: torch.Tensor, tokens: torch.Tensor,
               cfg: UncertaintyConfig,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 4 scalar difficulty score U in [0,1]. logits (..., N, V)."""
    h_per, v_per = uncertainty_terms(logits, tokens, cfg)
    if mask is None:
        h, v = h_per.mean(-1), v_per.mean(-1)
    else:
        m = mask.float()
        d = m.sum(-1).clamp_min(1.0)
        h, v = (h_per * m).sum(-1) / d, (v_per * m).sum(-1) / d
    return combine_terms(h, v, cfg)
