"""Plain PyTorch versions of the decode-attention kernels: the monolithic
cache and the block-table pool."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, pos, index, *, window=None, lse=False):
    """q (B,K,G,D); k,v (B,T,K,D); pos (B,T); index (B,) -> (B,K,G,D).

    A slot is valid when 0 <= pos <= index (and index - pos < window for
    windowed layers); invalid slots take the finite -1e30.  ``lse=True``
    returns (o, lse): o in f32 (not rounded to q's dtype) and lse (B,K,G)
    f32 the log-sum-exp of each row's scores over its valid slots, and a
    row with no valid slot gets lse -inf and o 0 (it contributes nothing
    to a merge over slot sets, ``sharding.merge_attention``)."""
    D = q.shape[-1]
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), k.float()) * D ** -0.5
    valid = (pos >= 0) & (pos <= index[:, None])
    if window is not None:
        valid = valid & (index[:, None] - pos < window)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    if not lse:
        return o.to(q.dtype)
    seen = valid.any(-1)[:, None, None]
    out = torch.where(seen, torch.logsumexp(s, -1), float("-inf"))
    return torch.where(seen[..., None], o, 0.0), out


def paged_gathered_view(k_pool, v_pool, pos_pool, table, index, *,
                        window=None, k_scale=None, v_scale=None,
                        delta_k=None, delta_v=None, delta_pos=None, p0=None):
    """The keys ``paged_decode_attention_ref`` attends, as a monolithic
    (B, nb*L [+ S]) view -> (k, v, pos): the pool gathered through the table
    with ids clamped into [0, N), dequantized in f32 when scales are given,
    sentinel blocks (table >= N) and the slots the dispatch rewrote
    (linear [p0, index], ring slots mod nb*L for ``window`` layers) at
    pos -1, then the delta rows appended (unwritten, future and
    in-ring-superseded rows at pos -1)."""
    B, nb = table.shape
    N, L = k_pool.shape[0], k_pool.shape[1]
    flat = table.reshape(-1).long().clamp(0, N - 1)
    k = k_pool.index_select(0, flat).reshape(B, nb * L, *k_pool.shape[2:])
    v = v_pool.index_select(0, flat).reshape(B, nb * L, *v_pool.shape[2:])
    if k_scale is not None:
        ks = k_scale.index_select(0, flat).reshape(B, nb * L,
                                                   *k_scale.shape[2:])
        vs = v_scale.index_select(0, flat).reshape(B, nb * L,
                                                   *v_scale.shape[2:])
        k = k.float() * ks[..., None]
        v = v.float() * vs[..., None]
    pos = pos_pool.index_select(0, flat).reshape(B, nb * L)
    pos = torch.where((table < N).repeat_interleave(L, dim=1), pos, -1)
    if delta_k is not None:
        Tl = nb * L
        sl = torch.arange(Tl, dtype=torch.int32, device=pos.device)[None]
        if window is not None:
            covered = (sl - p0[:, None]) % Tl <= (index - p0)[:, None]
        else:
            covered = (sl >= p0[:, None]) & (sl <= index[:, None])
        pos = torch.where(covered, -1, pos)
        dvalid = delta_pos <= index[:, None]
        if window is not None:
            dvalid = dvalid & (delta_pos > index[:, None] - Tl)
        k = torch.cat([k, delta_k.to(k.dtype)], dim=1)
        v = torch.cat([v, delta_v.to(v.dtype)], dim=1)
        pos = torch.cat([pos, torch.where(dvalid, delta_pos, -1)], dim=1)
    return k, v, pos.to(torch.int32)


def paged_decode_attention_ref(q, k_pool, v_pool, pos_pool, table, index, *,
                               window=None, **kw):
    """Block-table oracle, line for line the reference's: the monolithic
    ``decode_attention_ref`` over ``paged_gathered_view`` (the same keyword
    operands: k_scale/v_scale (N,L,K) for an int8/fp8 pool; delta_k/delta_v
    (B,S,K,D), delta_pos (B,S) and p0 (B,) for the dispatch's own rows).  A
    row with no valid key comes out as the mean of V over every gathered
    slot, clamped sentinels included."""
    k, v, pos = paged_gathered_view(k_pool, v_pool, pos_pool, table, index,
                                    window=window, **kw)
    return decode_attention_ref(q, k, v, pos, index, window=window)
