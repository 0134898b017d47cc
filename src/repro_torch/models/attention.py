"""GQA attention: the full-sequence forward, cold and warm prefill,
one-token decode over a monolithic cache, and the paged block pool
(PyTorch).

Mirrors ``repro/models/attention.py``.  The full-sequence forward
(``attn_block``: the safety encoder and ``transformer.forward``) runs the
grid-offset flash op, prefill (cold and continuation) the positions-mode
flash op, decode the monolithic decode op, paged decode the block-table
decode op (``kernels/``): the CUDA kernels on the card, their plain
versions on the CPU.  Training (``attn_block(..., train=True)``) runs
``chunked_attention`` instead, plain PyTorch differentiated by autograd,
as the reference trains through XLA: the kernels have no backward and
refuse operands that require grad.  Unlike JAX's functional
``.at[].set``, caches and pools are written IN PLACE (``index_put_``):
``attn_prefill`` and ``attn_decode`` mutate the ``KVCache`` they are
given and return it, and the ``paged_*`` writers mutate the ``KVPool``.

**Paged pools and dropped writes.**  JAX drops out-of-range scatters
(``mode="drop"``) and clips gathers.  On CUDA an out-of-range index is a
device-side assert, so the port never forms one: every gather clamps its
block ids into [0, N), and every write goes through a SINK block.  A
``KVPool`` is allocated with N + 1 blocks; the last one, block N, serves
nobody, and a write through a sentinel table entry (>= N: an empty serve
slot), an untouched block or an unwritten delta row is sent there instead
of being masked out with a host sync.  ``KVPool.served()`` is the N-block
view the readers and the decode kernel see.  The sink's contents are
garbage and are never read: the kernel skips sentinel entries, and the
gathers clamp to a served block.

Masked scores use the finite -1e30 of the reference, never -inf: a
bucket-padding query (negative position, nothing to attend) then comes out
as the mean of v instead of NaN, and no NaN can reach real rows through a
0 * NaN in the next layer's products.

**Sequence-sharded caches on a mesh.**  A layer whose KV heads the model
axes cannot take (``transformer.shard_params`` attaches a
``sharding.SeqCut`` as ``.seq``) keeps every KV head on every rank, and
its cache's slots as the reference's ``act_kv_seq`` places them: a
``SeqKVCache`` holds rank r's run [r T/m, (r + 1) T/m) of a T-slot cache
where m divides T (route (s)), a ``KVCache`` all T slots where it does not
(route (w)).  Each rank writes the new K/V into its own slots only.  Where
its query heads are cut too (``.tp``), decode and the warm continuation
gather q over the model axes and attend every head, and the rank keeps its
heads' output for the row-parallel ``wo``; a cold prefill attends the
span's own K/V, which every rank holds, with its own heads only.  Over a
``SeqKVCache`` the decode and positions-mode kernels also return each
row's log-sum-exp, and the ranks merge their partial outputs
(``sharding.merge_attention``).  The paged pool has no sequence axis
(the reference's ``PAGED_KV_AXES``): such a layer attends the whole pool.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.distributed.sharding import merge_attention, row_parallel
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      paged_decode_attention)
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_positions)
from repro_torch.models import quant as Q
from repro_torch.models.common import (ModelConfig, apply_rope,
                                       frozen_zeros, rmsnorm, rope_angles)


class Attention(nn.Module):
    """Parameters in the JAX layouts: wq (D,H,Dh), wk/wv (D,K,Dh),
    wo (H,Dh,D), zero-centred norm (D,), optional QKV bias."""

    #: each parameter's logical axes, as the reference's ``attn_defs`` tags
    #: them (``distributed/sharding.py``)
    AXES = {"norm": ("norm",), "wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed"),
            "bq": ("bias_heads", "head_dim"), "bk": ("kv_heads", "head_dim"),
            "bv": ("kv_heads", "head_dim")}

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


class SeqKVCache(KVCache):
    """A rank's run of a sequence-sharded KV cache (module docstring): rank
    r of the m ranks of its layer's ``.seq`` holds slots [r T_l, (r + 1)
    T_l) of a cache of T = m T_l slots (a ring's window slots for a local
    layer), of every KV head."""
    __slots__ = ()


def init_kv_cache(cfg: ModelConfig, batch: int, length: int, local: bool,
                  device=None) -> KVCache:
    """k/v zeros and pos -1 over ``length`` slots (a local layer's ring: at
    most ``cfg.window``).  A rank config whose attention cuts its cache's
    slots (``kv_seq_shards`` m > 1, ``transformer.shard_params``) gives
    the rank's ``SeqKVCache`` of length / m slots where m divides the
    length, and the whole cache where it does not."""
    if local and cfg.window is not None:
        length = min(length, cfg.window)
    m = getattr(cfg, "kv_seq_shards", 1)
    kind = KVCache
    if m > 1 and length % m == 0:
        length, kind = length // m, SeqKVCache
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    return kind(
        k=torch.zeros((batch, length, K, Dh), dtype=cfg.dtype, device=device),
        v=torch.zeros((batch, length, K, Dh), dtype=cfg.dtype, device=device),
        pos=torch.full((batch, length), -1, dtype=torch.int32, device=device),
    )


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul."""
    D, H, Dh = w.shape
    return (x @ Q.cast(w, x.dtype).reshape(D, H * Dh)).unflatten(-1, (H, Dh))


def _attn_out(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """The output projection, einsum('bshk,hkd->bsd') as one matmul;
    row-parallel on a mesh, where it is summed over the axes the heads were
    cut over (``shard_params``)."""
    return row_parallel(p, out.flatten(-2), p.wo)


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """x (B,S,D), positions (B,S) -> q (B,S,H,Dh), k/v (B,S,K,Dh), roped.
    On a mesh (``.tp``) x enters the rank's cut projections
    (``sharding.enter``); a training shard in case (b) (``.kv_pick``, see
    ``transformer.shard_params``) projects every KV head whole and passes
    k and v into its query heads' cut, keeping the one KV head they read."""
    tp = getattr(p, "tp", None)
    pick = getattr(p, "kv_pick", None)
    xq = x if tp is None else tp.enter(x)
    xkv = x if pick is not None else xq
    q, k, v = _proj(xq, p.wq), _proj(xkv, p.wk), _proj(xkv, p.wv)
    if cfg.attn_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    if pick is not None:
        k, v = (tp.enter(t).narrow(2, pick, 1) for t in (k, v))
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos[..., None, :], sin[..., None, :])
    k = apply_rope(k, cos[..., None, :], sin[..., None, :])
    return q, k, v.contiguous()


def _slots(p: Attention, cache: KVCache) -> tuple[int, int]:
    """(the first slot ``cache`` holds, the whole cache's slot count T): a
    ``SeqKVCache`` is the rank's run of T / m slots (``p.seq``), any other
    cache all of them."""
    T = cache.k.shape[1]
    if not isinstance(cache, SeqKVCache):
        return 0, T
    return p.seq.index * T, p.seq.shards * T


def _scatter_kv(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                positions: torch.Tensor, cfg: ModelConfig, local: bool,
                first: int = 0, T: int | None = None) -> KVCache:
    """Write roped span K/V into the cache at slot = position (ring slot =
    position % T for windowed layers), in place.  Negative positions (and,
    like JAX's dropped out-of-bounds scatter, positions past the cache) are
    not written.  ``first`` / ``T`` (``_slots``): the cache holds slots
    [first, first + its length) of a T-slot cache, and writes no other.

    No host sync, so a captured prefill can run it: every column writes,
    and a dropped column repeats the write of its row's last kept column
    (the same value to the same slot, so the duplicate is harmless).  A row
    with no kept column rewrites one slot with the value already there."""
    B, S = positions.shape
    Tl = cache.k.shape[1]
    T = Tl if T is None else T
    ring = local and cfg.window is not None
    if ring and S > T:
        # only the last T positions survive a stepwise ring fill
        pmax = positions.max(dim=1, keepdim=True).values
        positions = torch.where(positions > pmax - T, positions, -1)
    slot = positions % T if ring else positions
    keep = (positions >= 0) & (slot >= first) & (slot < first + Tl)
    # each row's kept column with the highest position (column 0 if none)
    rep = torch.where(keep, positions, torch.iinfo(positions.dtype).min
                      ).argmax(dim=1, keepdim=True)
    col = torch.where(keep, torch.arange(S, device=positions.device), rep)
    any_keep = keep.any(dim=1)[:, None]
    b = torch.arange(B, device=positions.device)[:, None].expand(B, S)
    sl = (slot.gather(1, col) - first).clamp(0, Tl - 1)
    for t, val in ((cache.k, k), (cache.v, v), (cache.pos, positions)):
        new = val[b, col].to(t.dtype)
        old = t[b, sl]
        keep_b = any_keep.view(B, 1, *(1,) * (new.dim() - 2))
        t.index_put_((b, sl), torch.where(keep_b, new, old))
    return cache


NEG_INF = -1e30


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, kv_positions: torch.Tensor,
                      causal: bool, window: int | None, q_block: int,
                      kv_block: int) -> torch.Tensor:
    """q (B,S,H,Dh); k,v (B,T,K,Dh); positions (S,)/(T,).  Returns
    (B,S,H,Dh) in q's dtype.  The training attention, differentiated by
    autograd: the reference's XLA ``chunked_attention``, block for block.

    It rounds where the reference does, forward and backward: q, k and v
    to bf16, and P to bf16 before P.V; the products of those bf16 values
    and the streaming softmax run in f32.  Each block product reads its
    bf16 operand block afresh (``.float()`` per use), so the gradient of a
    block arrives in bf16 per use and sums in bf16 over the blocks that
    read it, as the reference's scans accumulate the cotangents of their
    bf16 operands.  The reference wraps each q block in ``jax.checkpoint``;
    at the sequence lengths trained here (S <= 128) the blocks' activations
    are kept instead."""
    B, S, H, Dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qb, kb = min(q_block, S), min(kv_block, T)
    if S % qb or T % kb:
        raise ValueError(f"S={S} and T={T} must be multiples of the blocks "
                         f"{qb} and {kb}")
    scale = Dh ** -0.5
    bf16 = torch.bfloat16
    qr = q.to(bf16).reshape(B, S, K, G, Dh)
    kr, vr = k.to(bf16), v.to(bf16)
    outs = []
    for i in range(0, S, qb):
        qp = q_positions[i:i + qb]
        acc = q.new_zeros((B, K, G, qb, Dh), dtype=torch.float32)
        m = torch.full((B, K, G, qb), NEG_INF, device=q.device)
        l = torch.zeros((B, K, G, qb), device=q.device)
        for j in range(0, T, kb):
            kp = kv_positions[j:j + kb]
            s = torch.einsum("bqkgd,bskd->bkgqs", qr[:, i:i + qb].float(),
                             kr[:, j:j + kb].float()) * scale
            mask = (kp >= 0)[None, :].expand(qb, -1)
            if causal:
                mask = mask & (qp[:, None] >= kp[None, :])
            if window is not None:
                mask = mask & (qp[:, None] - kp[None, :] < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(bf16).float(),
                              vr[:, j:j + kb].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).to(q.dtype))
    out = torch.cat(outs, dim=3)                       # (B,K,G,S,Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh)


def _attn_forward(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, local: bool, *,
                  prefill: bool = False, train: bool = False):
    """Shared full-sequence body -> (x + attn(x), k, v), for the forward,
    training and prefill.  ``prefill=True`` attends through the
    positions-mode flash op (negative positions are inert padding); the
    default is the full-sequence forward over positions 0..S-1, through the
    grid-offset flash op, which skips the KV tiles a causal or windowed q
    tile cannot see; ``train=True`` runs that forward through
    ``chunked_attention``."""
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    q, k, v = _project_qkv(p, h, cfg, positions)
    window = cfg.window if local else None
    if prefill:
        pos0 = positions[0].contiguous()
        out = flash_attention_positions(
            q, *_kv_of_heads(p, k, v), q_positions=pos0, kv_positions=pos0,
            causal=cfg.causal, window=window)
    elif train:
        out = chunked_attention(
            q, k, v, q_positions=positions[0], kv_positions=positions[0],
            causal=cfg.causal, window=window, q_block=cfg.attn_q_block,
            kv_block=cfg.attn_kv_block)
    else:
        out = flash_attention(q, *_kv_of_heads(p, k, v), causal=cfg.causal,
                              window=window)
    return x + _attn_out(p, out), k, v


def _cut_heads(p: Attention):
    """The ``Split`` of a layer's query heads where they are cut over the
    model axes while its KV heads stay whole (``p.seq`` and ``p.tp``),
    else None."""
    return getattr(p, "tp", None) if getattr(p, "seq", None) else None


def _kv_of_heads(p: Attention, k: torch.Tensor, v: torch.Tensor):
    """k, v (B,T,K,Dh) for the rank's query heads: where they are cut
    (``_cut_heads``) the KV head each of them reads, (B,T,H/m,Dh) with one
    query head per KV head; k, v themselves otherwise."""
    tp = _cut_heads(p)
    if tp is None:
        return k, v
    G = tp.size * tp.shards // k.shape[2]
    idx = torch.arange(tp.start, tp.start + tp.size, device=k.device) // G
    return k.index_select(2, idx), v.index_select(2, idx)


def _heads_whole(p: Attention, q: torch.Tensor) -> torch.Tensor:
    """q (B,S,H/m,Dh) of the rank's cut query heads gathered into every
    head's (B,S,H,Dh) (``_cut_heads``); q itself otherwise."""
    tp = _cut_heads(p)
    return q if tp is None else tp.gather(q.contiguous(), 2)


def _heads_mine(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """The rank's query heads of every head's attention output (B,S,H,Dh)
    (``_cut_heads``); ``out`` itself otherwise."""
    tp = _cut_heads(p)
    return out if tp is None else out.narrow(2, tp.start, tp.size)


def _merged(p: Attention, cache: KVCache, res):
    """A kernel's result over ``cache``: over a ``SeqKVCache`` its (o, lse)
    merged with the other ranks' over their slots, in the cache's dtype;
    else o."""
    if not isinstance(cache, SeqKVCache):
        return res
    return merge_attention(*res, p.seq.comm, p.seq.axes, cache.k.dtype)


def attn_block(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
               local: bool, train: bool = False) -> torch.Tensor:
    """Pre-norm residual attention over a full sequence at positions
    0..S-1, no cache and no padding mask.  x (B,S,D).  ``train=True``
    attends through ``chunked_attention`` (autograd), the default through
    the grid-offset flash op (inference)."""
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    out, _, _ = _attn_forward(p, x, cfg, positions, local, train=train)
    return out


def attn_prefill(p: Attention, x: torch.Tensor, cache: KVCache,
                 positions: torch.Tensor, cfg: ModelConfig, *, local: bool,
                 continuation: bool = False) -> tuple[torch.Tensor, KVCache]:
    """Prompt absorption: span attention + bulk KV-cache fill, in place.

    x (B,S,D); positions (B,S) int32, identical across the batch (the
    caller checks, ``transformer.prefill``).  Negative positions are inert
    bucket padding: their K/V never enter the cache and every key masks
    them out.

    ``continuation=False`` (cold): a freshly initialised cache and a
    LEFT-padded span starting at position 0; attention runs over the span's
    own K/V.  ``continuation=True`` (warm): the span, RIGHT-padded, goes
    into an already-filled cache at offset positions.  Its K/V are written
    first, then the span queries attend over the whole cache through the
    positions-mode flash op with ``kv_positions = cache.pos[0]`` (cache.pos
    rows are identical across the batch when positions are), so the warm
    span sees the cached context, itself, and no empty slot."""
    if not continuation:
        x, k, v = _attn_forward(p, x, cfg, positions, local, prefill=True)
        _scatter_kv(cache, k, v, positions, cfg, local, *_slots(p, cache))
        return x, cache
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    q, k, v = _project_qkv(p, h, cfg, positions)
    _scatter_kv(cache, k, v, positions, cfg, local, *_slots(p, cache))
    out = _merged(p, cache, flash_attention_positions(
        _heads_whole(p, q), cache.k, cache.v,
        q_positions=positions[0].contiguous(),
        kv_positions=cache.pos[0].contiguous(), causal=cfg.causal,
        window=cfg.window if local else None,
        lse=isinstance(cache, SeqKVCache)))
    return x + _attn_out(p, _heads_mine(p, out)), cache


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
    kept decoding) is not written, as JAX drops the out-of-bounds scatter;
    nor is one outside a ``SeqKVCache``'s run (another rank holds it)."""
    B = x.shape[0]
    Tl = cache.k.shape[1]
    first, T = _slots(p, cache)
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    q, k_new, v_new = _project_qkv(p, h, cfg, index[:, None])
    ring = local and cfg.window is not None
    slot = (index % T if ring else index) - first
    b = torch.arange(B, device=x.device)
    keep = (slot >= 0) & (slot < Tl)
    _write_slot(cache.k, b, slot, k_new[:, 0], keep)
    _write_slot(cache.v, b, slot, v_new[:, 0], keep)
    _write_slot(cache.pos, b, slot, index.to(torch.int32), keep)
    q = _heads_whole(p, q)
    H = q.shape[2]
    out = _merged(p, cache, decode_attention(
        q.reshape(B, K, H // K, Dh), cache.k, cache.v, cache.pos, index,
        window=cfg.window if ring else None,
        lse=isinstance(cache, SeqKVCache)))
    out = _heads_mine(p, out.reshape(B, 1, H, Dh)).to(x.dtype)
    return x + _attn_out(p, out), cache


# ---------------------------------------------------------------------------
# Paged (block-pool) variants: pool-shaped storage + per-slot block tables
# ---------------------------------------------------------------------------

class KVPool(NamedTuple):
    """One attention layer's block pool: k/v (N+1, L, K, Dh) in the cache
    dtype (int8 / float8_e4m3fn for a quantized pool, with per-row f32
    scales k_scale/v_scale (N+1, L, K)), pos (N+1, L) int32 (-1 = empty).
    Block N is the sink (module docstring)."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def n_blocks(self) -> int:
        """Blocks the pool serves (the sink not counted)."""
        return self.k.shape[0] - 1

    def served(self) -> "KVPool":
        """The N served blocks of every field, as views (no copy)."""
        n = self.n_blocks
        return KVPool(*(None if t is None else t[:n] for t in self))


def raw(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a uint8 view of an fp8 tensor: pool writes, copies
    and gathers move fp8 rows as bytes."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def init_paged_kv(cfg: ModelConfig, n_blocks: int, block_len: int,
                  cache_quant: str | None = None, device=None) -> KVPool:
    """A pool of ``n_blocks`` served blocks (+ the sink): k/v zero, pos -1,
    scales zero.  Local-window layers share the geometry: the window clamp
    happens at view time through the table slice."""
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    n = n_blocks + 1
    dt = cfg.dtype if cache_quant is None else Q.qdtype(cache_quant)

    def scale():
        return (None if cache_quant is None
                else torch.zeros((n, block_len, K), dtype=torch.float32,
                                 device=device))
    return KVPool(
        k=torch.zeros((n, block_len, K, Dh), dtype=dt, device=device),
        v=torch.zeros((n, block_len, K, Dh), dtype=dt, device=device),
        pos=torch.full((n, block_len), -1, dtype=torch.int32, device=device),
        k_scale=scale(), v_scale=scale())


def _gather_blocks(t: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    return raw(t).index_select(0, flat).view(t.dtype)


def paged_view(pool: KVPool, table: torch.Tensor,
               view_dtype: torch.dtype) -> KVCache:
    """Gather the slot-linear (B, nb*L, ...) view of the pool through the
    table: elementwise the monolithic cache of length nb*L with the same
    writes.  Sentinel entries clamp to the last served block (garbage that
    only feeds an empty serve slot's own row).  A quantized pool is
    dequantized to ``view_dtype`` here, so the view is always a plain
    monolithic cache — the gather oracle of the fused paths."""
    sv = pool.served()
    B, nb = table.shape
    L = sv.k.shape[1]
    flat = table.reshape(-1).long().clamp(0, sv.k.shape[0] - 1)
    k, v = _gather_blocks(sv.k, flat), _gather_blocks(sv.v, flat)
    if sv.k_scale is not None:
        k = Q.dequantize_rows(k, sv.k_scale.index_select(0, flat),
                              view_dtype)
        v = Q.dequantize_rows(v, sv.v_scale.index_select(0, flat),
                              view_dtype)
    return KVCache(k=k.reshape(B, nb * L, *k.shape[2:]),
                   v=v.reshape(B, nb * L, *v.shape[2:]),
                   pos=sv.pos.index_select(0, flat).reshape(B, nb * L))


def _put_rows(pool: KVPool, dst: torch.Tensor, k, v, pos,
              rows: bool) -> None:
    """Write k/v/pos (and, for a quantized pool, quantize them and write
    the scales) at ``dst``: block ids (rows=False, values (n, L, ...)) or
    flat row ids over (N+1)*L rows (rows=True, values (n, ...))."""
    if pool.k_scale is not None:
        quant = Q.quant_of(pool.k.dtype)
        k, ks = Q.quantize_rows(k, quant)
        v, vs = Q.quantize_rows(v, quant)
    fields = [(pool.k, k), (pool.v, v), (pool.pos, pos)]
    if pool.k_scale is not None:
        fields += [(pool.k_scale, ks), (pool.v_scale, vs)]
    for t, val in fields:
        tgt = raw(t)
        if rows:
            tgt = tgt.view(-1, *tgt.shape[2:])
        tgt.index_put_((dst,), raw(val.to(t.dtype)))


def paged_scatter_blocks(pool: KVPool, table: torch.Tensor, lin: KVCache,
                         lo: torch.Tensor, hi: torch.Tensor, *,
                         window: int | None = None) -> KVPool:
    """Write the blocks covering positions [lo, hi) (B,) of the slot-linear
    cache ``lin`` (B, nb*L) back into the pool through the table, in place.
    Only the covering blocks are written, so a refcount-shared prefix block
    (always below ``lo``) is never written through — the allocator's
    copy-on-write invariant.  ``window`` set = a ring layer: the write range
    maps to ring slots, with wrap.  Sentinel entries and untouched blocks
    write to the sink.  A quantized pool quantizes the written rows."""
    N, L = pool.n_blocks, pool.k.shape[1]
    B, T = lin.pos.shape
    nb = T // L
    tbl = table[:, :nb]
    jpos = torch.arange(nb, dtype=torch.int32, device=tbl.device)[None] * L
    lo, hi = lo[:, None], hi[:, None]
    if window is None:
        touched = (jpos < hi) & (jpos + L > lo)
    else:
        s0 = lo % T
        s1 = s0 + (hi - lo).clamp(max=T)
        touched = (((jpos < s1) & (jpos + L > s0))
                   | ((jpos + T < s1) & (jpos + T + L > s0)))  # ring wrap
    dst = torch.where(touched & (tbl >= 0) & (tbl < N), tbl, N)
    dst = dst.reshape(-1).long()
    _put_rows(pool, dst, lin.k.reshape(B * nb, L, *lin.k.shape[2:]),
              lin.v.reshape(B * nb, L, *lin.v.shape[2:]),
              lin.pos.reshape(B * nb, L), rows=False)
    return pool


def paged_scatter_delta(pool: KVPool, table: torch.Tensor, delta: KVCache,
                        p0: torch.Tensor, *,
                        window: int | None = None) -> KVPool:
    """Scatter a dispatch's decode delta buffer (``init_decode_delta``)
    into the pool through the table, in place: O(steps) row writes per
    batch row.  Ring layers wrap slots mod the view length nb*L; when the
    dispatch ran more steps than that, only the LAST nb*L delta rows are
    written (the earlier ones were superseded in the ring, and a
    duplicate-index write has no defined order).  Rows past the table,
    through sentinel entries or unwritten (pos -1) go to the sink.  The
    result equals the gather path's ``paged_scatter_blocks`` writeback."""
    N, L = pool.n_blocks, pool.k.shape[1]
    B, steps = delta.pos.shape
    nb = table.shape[1]
    Tl = nb * L
    k, v, pos = delta.k, delta.v, delta.pos
    off = torch.arange(steps, dtype=torch.int32, device=pos.device)
    if window is not None and steps > Tl:
        k, v, pos, off = k[:, -Tl:], v[:, -Tl:], pos[:, -Tl:], off[-Tl:]
        steps = Tl
    slot = p0[:, None] + off[None]
    if window is not None:
        slot = slot % Tl
    col = slot // L
    blk = table.gather(1, col.clamp(0, nb - 1).long())
    keep = (col < nb) & (blk >= 0) & (blk < N) & (pos >= 0)
    flat = torch.where(keep, blk.long() * L + (slot % L).long(), N * L)
    _put_rows(pool, flat.reshape(-1), k.reshape(B * steps, *k.shape[2:]),
              v.reshape(B * steps, *v.shape[2:]), pos.reshape(-1), rows=True)
    return pool


def init_decode_delta(cfg: ModelConfig, batch: int, steps: int,
                      device=None) -> KVCache:
    """Per-dispatch decode write buffer: row ``t`` holds the K/V the
    dispatch's step ``t`` produced (pos -1 = unwritten), in the cache dtype
    even when the pool is quantized — the dispatch attends its own rows
    unquantized, and ``paged_scatter_delta`` quantizes them once at the
    end."""
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    return KVCache(
        k=torch.zeros((batch, steps, K, Dh), dtype=cfg.dtype, device=device),
        v=torch.zeros((batch, steps, K, Dh), dtype=cfg.dtype, device=device),
        pos=torch.full((batch, steps), -1, dtype=torch.int32, device=device))


def attn_decode_paged(p: Attention, x: torch.Tensor, pool: KVPool,
                      table: torch.Tensor, delta: KVCache,
                      index: torch.Tensor, t: int, p0: torch.Tensor,
                      cfg: ModelConfig, *,
                      local: bool) -> tuple[torch.Tensor, KVCache]:
    """One-token decode reading the pool IN PLACE through the block table.

    ``pool`` is never written here; ``table`` (B, nb) is contiguous and
    already cut to the window for local layers; ``delta`` holds this
    dispatch's decode writes; ``t`` is the step within the dispatch and
    ``p0`` (B,) the dispatch's first position (index == p0 + t).  The new
    token's K/V go into delta row ``t`` first, then the block-table decode
    op attends the pool (minus the slots this dispatch rewrote) and the
    delta rows — the kernel on the card, its plain version on the CPU.  A
    quantized pool's scales are folded into the kernel's softmax."""
    B = x.shape[0]
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    q, k_new, v_new = _project_qkv(p, h, cfg, index[:, None])
    delta.k[:, t] = k_new[:, 0].to(delta.k.dtype)
    delta.v[:, t] = v_new[:, 0].to(delta.v.dtype)
    delta.pos[:, t] = index
    sv = pool.served()
    q = _heads_whole(p, q)
    H = q.shape[2]
    out = paged_decode_attention(
        q.reshape(B, K, H // K, Dh).to(delta.k.dtype), sv.k, sv.v, sv.pos,
        table, index, window=cfg.window if local else None,
        k_scale=sv.k_scale, v_scale=sv.v_scale, delta_k=delta.k,
        delta_v=delta.v, delta_pos=delta.pos, p0=p0)
    out = _heads_mine(p, out.reshape(B, 1, H, Dh)).to(x.dtype)
    return x + _attn_out(p, out), delta
