"""Decode attention, two entry points: over a monolithic cache
(``decode_attention``) and through a block table over a block pool
(``paged_decode_attention``).  The CUDA kernels for CUDA tensors, the plain
versions (``ref.py``) for CPU tensors.  No fallback: a CUDA tensor the
kernels cannot take raises.

Each entry point keeps its own launch count: ``counts`` for
``decode_attention``, ``paged_counts`` for ``paged_decode_attention``."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ref as R

counts = build.LaunchCounts()          # decode_attention
paged_counts = build.LaunchCounts()    # paged_decode_attention

_DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 16          # query heads per KV head the kernel keeps resident


def decode_attention(q, k, v, pos, index, *, window=None):
    """q (B,K,G,D); k,v (B,T,K,D); pos (B,T) int32 absolute positions of the
    cached keys (-1 = empty); index (B,) int32 current position.
    Returns (B,K,G,D) in q's dtype."""
    B, K, G, D = q.shape
    T = k.shape[1]
    if k.shape != (B, T, K, D) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}: need k,v (B,T,K,D)")
    if pos.shape != (B, T) or index.shape != (B,):
        raise ValueError("pos must be (B,T) and index (B,)")
    if pos.dtype != torch.int32 or index.dtype != torch.int32:
        raise TypeError("pos and index must be int32")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    tensors = (q, k, v, pos, index)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all operands must be on one device")
    if q.device.type == "cpu":
        counts.plain += 1
        return R.decode_attention_ref(q, k, v, pos, index, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if G > MAX_GROUP or D > 256:
        raise ValueError(f"G={G} > {MAX_GROUP} or head_dim {D} > 256 is not "
                         "supported by the kernel")
    out = torch.empty_like(q)
    fn = build.kernel("decode_attention")
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                   index.data_ptr(), out.data_ptr(), B, T, K, G, D,
                   int(window or 0), float(D ** -0.5), build.dtype_code(q),
                   build.stream_ptr(q)), "decode_attention")
    counts.launches += 1
    return out


_QUANT = (torch.int8, torch.float8_e4m3fn)


def paged_decode_attention(q, k_pool, v_pool, pos_pool, table, index, *,
                           window=None, k_scale=None, v_scale=None,
                           delta_k=None, delta_v=None, delta_pos=None,
                           p0=None):
    """One-token decode through a block table.  q (B,K,G,D); k_pool,
    v_pool (N,L,K,D); pos_pool (N,L) int32; table (B,nb) int32 pool block
    ids (>= N: a sentinel, the whole block masked); index (B,) int32.

    ``window`` set = a ring layer: the table is already cut to the window,
    and the ring is its nb*L slots.  ``k_scale``/``v_scale`` (N,L,K) f32 =
    an int8/fp8 pool.  ``delta_k``/``delta_v`` (B,S,K,D) in q's dtype,
    ``delta_pos`` (B,S) int32 and ``p0`` (B,) int32 = the dispatch's own
    decode writes: pool slots it rewrote are masked and the delta rows
    attended instead.  Returns (B,K,G,D) in q's dtype."""
    B, K, G, D = q.shape
    N, L = k_pool.shape[0], k_pool.shape[1]
    nb = table.shape[1]
    if k_pool.shape != (N, L, K, D) or v_pool.shape != k_pool.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k_pool "
                         f"{tuple(k_pool.shape)} v_pool "
                         f"{tuple(v_pool.shape)}: need pools (N,L,K,D)")
    if (pos_pool.shape != (N, L) or table.shape != (B, nb)
            or index.shape != (B,)):
        raise ValueError("pos_pool must be (N,L), table (B,nb) and index "
                         "(B,)")
    ints = [pos_pool, table, index]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if quantized:
        if k_pool.dtype not in _QUANT or v_pool.dtype != k_pool.dtype:
            raise TypeError(f"a pool with scales is int8 or float8_e4m3fn, "
                            f"got {k_pool.dtype}/{v_pool.dtype}")
        if (k_scale.shape != (N, L, K) or v_scale.shape != k_scale.shape
                or k_scale.dtype != torch.float32
                or v_scale.dtype != torch.float32):
            raise ValueError("k_scale/v_scale must be (N,L,K) float32")
    elif not (k_pool.dtype == v_pool.dtype == q.dtype):
        raise TypeError(f"q and the pools must share float32 or bfloat16, "
                        f"got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    delta = (delta_k, delta_v, delta_pos, p0)
    if any(t is None for t in delta) != all(t is None for t in delta):
        raise ValueError("pass all of delta_k, delta_v, delta_pos and p0 or "
                         "none")
    S = 0
    if delta_k is not None:
        S = delta_pos.shape[-1]
        if (delta_k.shape != (B, S, K, D) or delta_v.shape != delta_k.shape
                or delta_pos.shape != (B, S) or p0.shape != (B,)):
            raise ValueError("delta_k/delta_v must be (B,S,K,D), delta_pos "
                             "(B,S) and p0 (B,)")
        if delta_k.dtype != q.dtype or delta_v.dtype != q.dtype:
            raise TypeError(f"delta rows must be in q's dtype {q.dtype}, "
                            f"got {delta_k.dtype}/{delta_v.dtype}")
        ints += [delta_pos, p0]
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("pos_pool, table, index, delta_pos and p0 must be "
                        "int32")
    tensors = [t for t in (q, k_pool, v_pool, k_scale, v_scale, pos_pool,
                           table, index, delta_k, delta_v, delta_pos, p0)
               if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all operands must be on one device")
    kw = dict(window=window, k_scale=k_scale, v_scale=v_scale,
              delta_k=delta_k, delta_v=delta_v, delta_pos=delta_pos, p0=p0)
    if q.device.type == "cpu":
        paged_counts.plain += 1
        return R.paged_decode_attention_ref(q, k_pool, v_pool, pos_pool,
                                            table, index, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if G > MAX_GROUP or D > 256:
        raise ValueError(f"G={G} > {MAX_GROUP} or head_dim {D} > 256 is not "
                         "supported by the kernel")
    out = torch.empty_like(q)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = build.kernel("paged_decode_attention")
    build.check(fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                   ptr(k_scale), ptr(v_scale), pos_pool.data_ptr(),
                   table.data_ptr(), index.data_ptr(),
                   ptr(p0), ptr(delta_k),
                   ptr(delta_v), ptr(delta_pos), out.data_ptr(), B, N, L, nb,
                   S, K, G, D, int(window or 0), int(window is not None),
                   float(D ** -0.5), build.dtype_code(q),
                   build.pool_dtype_code(k_pool), build.stream_ptr(q)),
                "paged_decode_attention")
    paged_counts.launches += 1
    return out
