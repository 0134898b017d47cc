"""GQA attention: the full-sequence forward, cold prefill and one-token
decode (PyTorch).

Mirrors the monolithic parts of ``repro/models/attention.py``.  The
full-sequence forward (``attn_block``: the safety encoder and
``transformer.forward``) runs the grid-offset flash op, prefill the
positions-mode flash op, decode the monolithic decode op (``kernels/``):
the CUDA kernels on the card, their plain versions on the CPU.  Unlike
JAX's functional ``.at[].set``, the KV cache is written IN PLACE
(``index_put_``): ``attn_prefill`` and ``attn_decode`` mutate the
``KVCache`` they are given and return it.

Masked scores use the finite -1e30 of the reference, never -inf: a
bucket-padding query (negative position, nothing to attend) then comes out
as the mean of v instead of NaN, and no NaN can reach real rows through a
0 * NaN in the next layer's products.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_positions)
from repro_torch.models.common import (ModelConfig, apply_rope,
                                       frozen_zeros, rmsnorm, rope_angles)


class Attention(nn.Module):
    """Parameters in the JAX layouts: wq (D,H,Dh), wk/wv (D,K,Dh),
    wo (H,Dh,D), zero-centred norm (D,), optional QKV bias."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, H, K, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

        def p(*shape):
            return frozen_zeros(*shape, dtype=cfg.dtype, device=device)

        self.norm = p(D)
        self.wq, self.wk, self.wv = p(D, H, Dh), p(D, K, Dh), p(D, K, Dh)
        self.wo = p(H, Dh, D)
        if cfg.attn_bias:
            self.bq, self.bk, self.bv = p(H, Dh), p(K, Dh), p(K, Dh)


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, T, K, Dh)
    v: torch.Tensor          # (B, T, K, Dh)
    pos: torch.Tensor        # (B, T) int32 absolute positions, -1 = empty


def init_kv_cache(cfg: ModelConfig, batch: int, length: int, local: bool,
                  device=None) -> KVCache:
    if local and cfg.window is not None:
        length = min(length, cfg.window)
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    return KVCache(
        k=torch.zeros((batch, length, K, Dh), dtype=cfg.dtype, device=device),
        v=torch.zeros((batch, length, K, Dh), dtype=cfg.dtype, device=device),
        pos=torch.full((batch, length), -1, dtype=torch.int32, device=device),
    )


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul."""
    D, H, Dh = w.shape
    return (x @ w.to(x.dtype).reshape(D, H * Dh)).unflatten(-1, (H, Dh))


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') as one matmul."""
    H, Dh, D = wo.shape
    return out.flatten(-2) @ wo.to(out.dtype).reshape(H * Dh, D)


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """x (B,S,D), positions (B,S) -> q (B,S,H,Dh), k/v (B,S,K,Dh), roped."""
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.attn_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos[..., None, :], sin[..., None, :])
    k = apply_rope(k, cos[..., None, :], sin[..., None, :])
    return q, k, v.contiguous()


def _scatter_kv(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                positions: torch.Tensor, cfg: ModelConfig,
                local: bool) -> KVCache:
    """Write roped span K/V into the cache at slot = position (ring slot =
    position % T for windowed layers), in place.  Negative positions (and,
    like JAX's dropped out-of-bounds scatter, positions past the cache) are
    not written."""
    B, S = positions.shape
    T = cache.k.shape[1]
    ring = local and cfg.window is not None
    if ring and S > T:
        # only the last T positions survive a stepwise ring fill
        pmax = positions.max(dim=1, keepdim=True).values
        positions = torch.where(positions > pmax - T, positions, -1)
    slot = positions % T if ring else positions
    b, s = torch.nonzero((positions >= 0) & (slot < T), as_tuple=True)
    sl = slot[b, s]
    cache.k.index_put_((b, sl), k[b, s].to(cache.k.dtype))
    cache.v.index_put_((b, sl), v[b, s].to(cache.v.dtype))
    cache.pos.index_put_((b, sl), positions[b, s].to(torch.int32))
    return cache


def _attn_forward(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, local: bool, *,
                  prefill: bool = False):
    """Shared full-sequence body -> (x + attn(x), k, v), for the forward
    and for prefill.  ``prefill=True`` attends through the positions-mode
    flash op (negative positions are inert padding); the default is the
    full-sequence forward over positions 0..S-1, through the grid-offset
    flash op, which skips the KV tiles a causal or windowed q tile cannot
    see."""
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    q, k, v = _project_qkv(p, h, cfg, positions)
    window = cfg.window if local else None
    if prefill:
        pos0 = positions[0].contiguous()
        out = flash_attention_positions(
            q, k, v, q_positions=pos0, kv_positions=pos0, causal=cfg.causal,
            window=window)
    else:
        out = flash_attention(q, k, v, causal=cfg.causal, window=window)
    return x + _out_proj(out, p.wo), k, v


def attn_block(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
               local: bool) -> torch.Tensor:
    """Pre-norm residual attention over a full sequence at positions
    0..S-1, no cache and no padding mask.  x (B,S,D)."""
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    out, _, _ = _attn_forward(p, x, cfg, positions, local)
    return out


def attn_prefill(p: Attention, x: torch.Tensor, cache: KVCache,
                 positions: torch.Tensor, cfg: ModelConfig, *, local: bool,
                 continuation: bool = False) -> tuple[torch.Tensor, KVCache]:
    """Cold prompt absorption: span attention + bulk KV-cache fill.

    x (B,S,D); positions (B,S) int32, identical across the batch, from a
    LEFT-padded span starting at position 0 and a freshly initialised
    cache.  Negative positions are inert bucket padding: their K/V never
    enter the cache and every key masks them out."""
    if continuation:
        raise NotImplementedError(
            "continuation prefill (warm sessions) is not ported yet")
    x, k, v = _attn_forward(p, x, cfg, positions, local, prefill=True)
    _scatter_kv(cache, k, v, positions, cfg, local)
    return x, cache


def _write_slot(t: torch.Tensor, b: torch.Tensor, slot: torch.Tensor,
                val: torch.Tensor, keep: torch.Tensor):
    """t[b, slot] = val where keep, in place, without a host sync: dropped
    rows rewrite the value already there."""
    T = t.shape[1]
    sl = slot.clamp(0, T - 1)
    keep = keep.view((-1,) + (1,) * (val.dim() - 1))
    t.index_put_((b, sl), torch.where(keep, val.to(t.dtype), t[b, sl]))


def attn_decode(p: Attention, x: torch.Tensor, cache: KVCache,
                index: torch.Tensor, cfg: ModelConfig, *,
                local: bool) -> tuple[torch.Tensor, KVCache]:
    """One-token decode.  x (B,1,D); index (B,) int32 absolute position of
    the new token.  The new K/V go into slot ``index`` BEFORE attending, so
    the token sees itself.  A slot past the cache (an idle serve slot that
    kept decoding) is not written, as JAX drops the out-of-bounds scatter."""
    B = x.shape[0]
    T = cache.k.shape[1]
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // K
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    q, k_new, v_new = _project_qkv(p, h, cfg, index[:, None])
    ring = local and cfg.window is not None
    slot = index % T if ring else index
    b = torch.arange(B, device=x.device)
    keep = (slot >= 0) & (slot < T)
    _write_slot(cache.k, b, slot, k_new[:, 0], keep)
    _write_slot(cache.v, b, slot, v_new[:, 0], keep)
    _write_slot(cache.pos, b, slot, index.to(torch.int32), keep)
    out = decode_attention(q.reshape(B, K, G, Dh), cache.k, cache.v,
                           cache.pos, index,
                           window=cfg.window if ring else None)
    out = out.reshape(B, 1, cfg.num_heads, Dh).to(x.dtype)
    return x + _out_proj(out, p.wo), cache
