"""Monolithic decode attention: the CUDA kernel for CUDA tensors, the plain
version (``ref.py``) for CPU tensors.  No fallback: a CUDA tensor the kernel
cannot take raises."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ref as R

counts = build.LaunchCounts()

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
