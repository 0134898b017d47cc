"""Plain PyTorch versions of the two flash-attention kernels."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q (B,S,H,D); k,v (B,T,K,D).  Grid-offset masks: query row i and key
    column j from 0.  f32 after loading, like the kernel; masked scores take
    the finite -1e30."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qr = q.reshape(B, S, K, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.float()) * D ** -0.5
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)


def flash_attention_positions_ref(q, k, v, *, q_positions, kv_positions,
                                  causal=True, window=None, lse=False):
    """q (B,S,H,D); k,v (B,T,K,D); q_positions (S,), kv_positions (T,)
    (negative = padding / empty slot).  f32 after loading, like the kernel.

    Masked scores take the finite -1e30, so a row with nothing valid (a
    bucket-padding query) is a uniform softmax: the mean of v, not NaN.
    ``lse=True`` returns (o, lse): o in f32 (not rounded to q's dtype) and
    lse (B,S,H) f32 the log-sum-exp of each row's scores over its valid
    keys; a row with none gets lse -inf and o 0 instead."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qr = q.reshape(B, S, K, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.float()) * D ** -0.5
    mask = (kv_positions >= 0)[None, :].expand(S, T)
    if causal:
        mask = mask & (q_positions[:, None] >= kv_positions[None, :])
    if window is not None:
        mask = mask & (q_positions[:, None] - kv_positions[None, :] < window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    if not lse:
        return o.reshape(B, S, H, D).to(q.dtype)
    seen = mask.any(-1)[None, :, None, None]                # (1,S,1,1)
    out = torch.logsumexp(s, -1).permute(0, 3, 1, 2)        # (B,S,K,G)
    out = torch.where(seen, out, float("-inf")).reshape(B, S, H)
    o = torch.where(seen[..., None], o, 0.0)
    return o.reshape(B, S, H, D), out
