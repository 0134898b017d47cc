"""Positions-mode flash attention: the CUDA kernel for CUDA tensors, the
plain version (``ref.py``) for CPU tensors.  No fallback: a CUDA tensor the
kernel cannot take raises."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref as R

counts = build.LaunchCounts()

_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_positions(q, k, v, *, q_positions, kv_positions,
                              causal=True, window=None):
    """q (B,S,H,D); k,v (B,T,K,D), H a multiple of K; q_positions (S,) and
    kv_positions (T,) int32 shared across the batch (negative = padding /
    empty slot).  Returns (B,S,H,D) in q's dtype."""
    B, S, H, D = q.shape
    _, T, K, _ = k.shape
    if k.shape != (B, T, K, D) or v.shape != k.shape or H % K:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}: need k,v (B,T,K,D), H % K == 0")
    if q_positions.shape != (S,) or kv_positions.shape != (T,):
        raise ValueError("q_positions must be (S,) and kv_positions (T,)")
    if q_positions.dtype != torch.int32 or kv_positions.dtype != torch.int32:
        raise TypeError("positions must be int32")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    tensors = (q, k, v, q_positions, kv_positions)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all operands must be on one device")
    if q.device.type == "cpu":
        counts.plain += 1
        return R.flash_attention_positions_ref(
            q, k, v, q_positions=q_positions, kv_positions=kv_positions,
            causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if D > 256:
        raise ValueError(f"head_dim {D} > 256 is not supported by the kernel")
    out = torch.empty_like(q)
    fn = build.kernel("flash_attention")
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   q_positions.data_ptr(), kv_positions.data_ptr(),
                   out.data_ptr(), B, S, T, H, K, D, int(causal),
                   int(window or 0), float(D ** -0.5), build.dtype_code(q),
                   build.stream_ptr(q)), "flash_attention_positions")
    counts.launches += 1
    return out
