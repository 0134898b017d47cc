"""Flash attention, two entry points: positions mode (serving prefill) and
grid-offset mode (the full-sequence forward).  The CUDA kernels for CUDA
tensors, the plain versions (``ref.py``) for CPU tensors.  No fallback: a
CUDA tensor the kernels cannot take raises.

Each entry point keeps its own launch count, so a run can tell them apart:
``counts`` for ``flash_attention_positions``, ``grid_counts`` for
``flash_attention``."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref as R

counts = build.LaunchCounts()          # flash_attention_positions
grid_counts = build.LaunchCounts()     # flash_attention

_DTYPES = (torch.float32, torch.bfloat16)


def _check_qkv(q, k, v):
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape != (B, T, K, D) or v.shape != k.shape or H % K:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}: need k,v (B,T,K,D), H % K == 0")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")


def _check_launch(tensors, D: int):
    """What the CUDA kernels take beyond the plain versions."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"unsupported device {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if D > 256:
        raise ValueError(f"head_dim {D} > 256 is not supported by the kernel")


def flash_attention_positions(q, k, v, *, q_positions, kv_positions,
                              causal=True, window=None):
    """q (B,S,H,D); k,v (B,T,K,D), H a multiple of K; q_positions (S,) and
    kv_positions (T,) int32 shared across the batch (negative = padding /
    empty slot).  Returns (B,S,H,D) in q's dtype."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    _check_qkv(q, k, v)
    if q_positions.shape != (S,) or kv_positions.shape != (T,):
        raise ValueError("q_positions must be (S,) and kv_positions (T,)")
    if q_positions.dtype != torch.int32 or kv_positions.dtype != torch.int32:
        raise TypeError("positions must be int32")
    tensors = (q, k, v, q_positions, kv_positions)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all operands must be on one device")
    if q.device.type == "cpu":
        counts.plain += 1
        return R.flash_attention_positions_ref(
            q, k, v, q_positions=q_positions, kv_positions=kv_positions,
            causal=causal, window=window)
    _check_launch(tensors, D)
    out = torch.empty_like(q)
    fn = build.kernel("flash_attention_positions")
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   q_positions.data_ptr(), kv_positions.data_ptr(),
                   out.data_ptr(), B, S, T, H, K, D, int(causal),
                   int(window or 0), float(D ** -0.5), build.dtype_code(q),
                   build.stream_ptr(q)), "flash_attention_positions")
    counts.launches += 1
    return out


def flash_attention(q, k, v, *, causal=True, window=None):
    """q (B,S,H,D); k,v (B,T,K,D), H a multiple of K.  Masks from grid
    offsets: query row i and key column j count from 0 (causal: i >= j;
    window: i - j < window), with no padding mask.  Returns (B,S,H,D) in
    q's dtype.  The kernel skips the KV tiles no row of a q tile can see.

    Shapes where a query row sees no key (a window with S - T >= window)
    raise: the plain version would give that row the mean of V over all T,
    the kernel a mean over the tiles it visits."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    _check_qkv(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if window is not None and S - T >= window:
        raise ValueError(f"S={S}, T={T}, window={window}: query rows from "
                         f"T + window - 1 on see no key")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("all operands must be on one device")
    if q.device.type == "cpu":
        grid_counts.plain += 1
        return R.flash_attention_ref(q, k, v, causal=causal, window=window)
    _check_launch((q, k, v), D)
    out = torch.empty_like(q)
    fn = build.kernel("flash_attention")
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, S, T, H, K, D, int(causal), int(window or 0),
                   float(D ** -0.5), build.dtype_code(q),
                   build.stream_ptr(q)), "flash_attention")
    grid_counts.launches += 1
    return out
