"""Gradient compression for the cross-pod hop (PyTorch port of
``repro/training/compression.py``).

Pods are the paper's "edge sites": links inside a pod are fast, while the
pod axis crosses slower links, where SWARM-LLM's cost model charges
c_comm per byte (Eq. 8).  The cross-pod gradient all-reduce is compressed
to int8 with a per-tensor scale and *error feedback* (the quantisation
residual is carried to the next step), which preserves convergence
(Karimireddy et al., 2019) while cutting pod-link bytes 4x against f32 and
2x against bf16.

Function for function the reference's; ``compressed_psum`` takes a
``sharding.Comm`` and mesh axes where the reference takes a ``shard_map``
axis name.  Not wired into the train step or ``launch/train.py``: the
reference's training CLI has no flag for it either, so the port adds none.
"""

from __future__ import annotations

from typing import Any

import torch


def quantise_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32/bf16 -> (int8, scale): symmetric, per tensor, in f32."""
    xf = x.float()
    scale = xf.abs().max().clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantise_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(int8 payload, scale, the new error residual) of ``g`` plus the
    carried residual ``err``."""
    corrected = g.float() + err
    q, scale = quantise_int8(corrected)
    return q, scale, corrected - dequantise_int8(q, scale)


def compressed_psum(g: torch.Tensor, err: torch.Tensor, comm, axes
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 error-feedback all-reduce of ``g`` over the mesh ``axes``: each
    rank quantises its contribution; the int8 payloads are summed exactly
    in int32, then dequantised once by the largest scale of the ranks
    (which keeps the sum bounded) over their count.  Returns (the reduced
    mean, f32; the new error residual)."""
    q, scale, new_err = compress_with_feedback(g, err)
    total = comm.all_reduce(q.to(torch.int32), axes)
    scale_max = comm.all_reduce(scale, axes, op="max")
    n = comm.all_reduce(torch.ones((), device=g.device), axes)
    return total.float() * scale_max / n, new_err


def init_error_state(params: Any) -> dict:
    """A zero f32 residual per tensor: ``params`` a module (keyed by
    parameter name) or a dict of tensors."""
    named = (dict(params.named_parameters())
             if isinstance(params, torch.nn.Module) else params)
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named.items()}
