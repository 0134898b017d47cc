"""Plain PyTorch version of the monolithic decode-attention kernel."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, pos, index, *, window=None):
    """q (B,K,G,D); k,v (B,T,K,D); pos (B,T); index (B,) -> (B,K,G,D).

    A slot is valid when 0 <= pos <= index (and index - pos < window for
    windowed layers); invalid slots take the finite -1e30."""
    D = q.shape[-1]
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), k.float()) * D ** -0.5
    valid = (pos >= 0) & (pos <= index[:, None])
    if window is not None:
        valid = valid & (index[:, None] - pos < window)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return o.to(q.dtype)
