"""Per-row scaled int8/fp8 storage for the paged KV block pools (PyTorch).

Mirrors the row part of ``repro/models/quant.py``: each cache row — one
(slot, kv-head) pair, ``head_dim`` wide — is stored as int8 or
float8_e4m3fn plus one float32 scale ``amax(row) / qmax``.  The scales live
beside the pool (``attention.KVPool.k_scale`` / ``.v_scale``); the paged
decode kernel folds them into its softmax instead of materialising the
dequantized pool.

Quantizing a zero row gives ``(0, scale=0)`` and dequantizing with a zero
scale gives zeros, so a reset block and a quantized scatter of zeros agree.
"""

from __future__ import annotations

import torch

# largest magnitude per storage format: int8 symmetric (+-127, -128 unused),
# float8 e4m3fn (+-448, the largest normal)
QMAX = {"int8": 127.0, "fp8": 448.0}
CACHE_QUANTS = (None, "int8", "fp8")


def qdtype(quant: str) -> torch.dtype:
    """Storage dtype for a quantization mode name."""
    if quant == "int8":
        return torch.int8
    if quant == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown quantization mode {quant!r}; "
                     f"expected one of {CACHE_QUANTS[1:]}")


def check_quant(quant):
    if quant not in CACHE_QUANTS:
        raise ValueError(f"unknown quantization mode {quant!r}; "
                         f"expected one of {CACHE_QUANTS}")
    return quant


def quant_of(dtype: torch.dtype) -> str:
    """The mode name of a quantized storage dtype."""
    return "int8" if dtype == torch.int8 else "fp8"


def quantize_rows(x: torch.Tensor, quant: str):
    """``x (..., D) -> (q (..., D), scale (...))``: symmetric per-row
    quantization with the scale over the trailing dim, in f32."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / QMAX[quant]
    y = xf / torch.where(scale > 0, scale, torch.ones_like(scale))[..., None]
    if quant == "int8":
        q = torch.round(y).clamp(-127.0, 127.0).to(torch.int8)
    else:
        q = y.to(torch.float8_e4m3fn)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """Materialised per-row dequant: the gathered-view oracle path only
    (``attention.paged_view``); the kernel applies the scales inside its
    softmax instead."""
    return (q.float() * scale[..., None]).to(dtype)
