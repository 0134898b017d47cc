"""Plain PyTorch version of the fused uncertainty kernel (Eq. 2-3)."""

from __future__ import annotations

import math

import torch


def uncertainty_ref(logits, tokens, *, k: int = 10):
    """logits (..., V), tokens (...) -> (h_token, v_topk, h_dist), (...) f32.

    ``torch.topk`` keeps duplicate values, as ``lax.top_k`` does; h_dist is
    normalised by log V of the full vocabulary."""
    lf = logits.float()
    logp = torch.log_softmax(lf, dim=-1)
    lp = logp.gather(-1, tokens[..., None].long())[..., 0]
    p = lp.exp()
    h_token = -p * lp
    z = torch.topk(lf, k, dim=-1).values
    v_topk = z.var(dim=-1, unbiased=False)
    h_dist = -(logp.exp() * logp).sum(-1) / math.log(lf.shape[-1])
    return h_token, v_topk, h_dist
