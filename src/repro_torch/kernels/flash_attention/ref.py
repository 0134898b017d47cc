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
                                  causal=True, window=None):
    """q (B,S,H,D); k,v (B,T,K,D); q_positions (S,), kv_positions (T,)
    (negative = padding / empty slot).  f32 after loading, like the kernel.

    Masked scores take the finite -1e30, so a row with nothing valid (a
    bucket-padding query) is a uniform softmax: the mean of v, not NaN."""
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
    return o.reshape(B, S, H, D).to(q.dtype)
