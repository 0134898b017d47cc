"""Fused uncertainty probe: the CUDA kernel for CUDA tensors, the plain
version (``ref.py``) for CPU tensors.  No fallback: a CUDA tensor the kernel
cannot take raises."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.swarm_uncertainty import ref as R

counts = build.LaunchCounts()

_DTYPES = (torch.float32, torch.bfloat16)
MAX_K = 16              # largest top-k the kernel keeps in registers


def uncertainty(logits, tokens, *, k: int = 10):
    """logits (..., V), tokens (...) -> (h_token, v_topk, h_dist), each (...)
    f32: Eq. 2's chosen-token -p log p, Eq. 3's top-k logit variance and the
    full-distribution entropy normalised by log V."""
    V = logits.shape[-1]
    if tokens.shape != logits.shape[:-1]:
        raise ValueError(f"tokens {tuple(tokens.shape)} must match logits "
                         f"{tuple(logits.shape)} without the vocab dim")
    if tokens.dtype != torch.int32 or logits.dtype not in _DTYPES:
        raise TypeError("logits must be float32/bfloat16 and tokens int32")
    if not 1 <= k <= V:
        raise ValueError(f"top-k {k} outside [1, V={V}]")
    if logits.device != tokens.device:
        raise ValueError("logits and tokens must be on one device")
    if logits.device.type == "cpu":
        counts.plain += 1
        return R.uncertainty_ref(logits, tokens, k=k)
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    if not (logits.is_contiguous() and tokens.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if k > MAX_K:
        raise ValueError(f"top-k {k} > {MAX_K} is not supported by the kernel")
    lead = tokens.shape
    rows = tokens.numel()
    h, v, hd = (torch.empty(lead, dtype=torch.float32, device=logits.device)
                for _ in range(3))
    fn = build.kernel("swarm_uncertainty")
    build.check(fn(logits.data_ptr(), tokens.data_ptr(), h.data_ptr(),
                   v.data_ptr(), hd.data_ptr(), rows, V, k,
                   build.dtype_code(logits), math.log(V),
                   build.stream_ptr(logits)), "swarm_uncertainty")
    counts.launches += 1
    return h, v, hd


def uncertainty_terms(logits, tokens, *, k: int = 10, mode: str = "token"):
    """Per-position (entropy_term, topk_variance); logits (..., N, V).
    ``mode="token"`` gives Eq. 2's chosen-token term, ``"distribution"``
    the full-softmax entropy."""
    h, v, hd = uncertainty(logits, tokens, k=k)
    return (h if mode == "token" else hd), v
