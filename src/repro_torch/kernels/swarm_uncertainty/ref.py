"""Plain PyTorch version of the fused uncertainty kernel (Eq. 2-3)."""

from __future__ import annotations

import math

import torch

NEG = -1e30             # the reference's finite mask value


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


def uncertainty_partials_ref(logits, tokens, *, k: int = 10, col0: int = 0):
    """The state of each row over one cut of the vocabulary, for a merge
    with the other cuts' (``ops.merge_partials``): logits (..., V) columns
    [col0, col0 + V) of the whole rows, tokens (...) indices into the whole
    vocabulary -> (..., k + 4) f32: the row's max m, l = sum e^(z - m),
    s = sum z e^(z - m), the chosen token's logit (NEG where the cut does
    not hold it), then its k largest logits, descending (NEG past V)."""
    lf = logits.float()
    V = lf.shape[-1]
    m = lf.amax(-1)
    e = torch.exp(lf - m[..., None])
    loc = tokens.long() - col0
    own = (loc >= 0) & (loc < V)
    chosen = torch.where(own, lf.gather(-1, loc.clamp(0, V - 1)[..., None])
                         [..., 0], torch.full_like(m, NEG))
    top = torch.topk(lf, min(k, V), dim=-1).values
    top = torch.nn.functional.pad(top, (0, k - top.shape[-1]), value=NEG)
    return torch.cat([torch.stack([m, e.sum(-1), (e * lf).sum(-1), chosen],
                                  -1), top], -1)
