"""Privacy exposure metrics CER / TER / SER (paper Sec. VII-C, Eq. 15-17),
PyTorch.

Mirrors ``repro/core/privacy.py``: computed from gateway decision logs and
normalised so the cloud-only architecture equals 1.0 (lower is better).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.router import CLOUD, CLOUD_SAFETY


class PrivacyMetrics(NamedTuple):
    cer: torch.Tensor   # Eq. 15, normalised to cloud-only
    ter: torch.Tensor   # Eq. 16
    ser: torch.Tensor   # Eq. 17


def privacy_metrics(decision: torch.Tensor, prompt_len: torch.Tensor,
                    is_safety: torch.Tensor) -> PrivacyMetrics:
    """decision (Q,) codes; prompt_len (Q,) (the paper's token proxy);
    is_safety (Q,) bool marks the safety subset (SER proxy, Eq. 17)."""
    exposed = ((decision == CLOUD) | (decision == CLOUD_SAFETY)).float()
    cer = exposed.mean()                                          # Eq. 15
    plen = prompt_len.float()
    ter = (plen * exposed).sum() / plen.sum().clamp_min(1.0)      # Eq. 16
    saf = is_safety.float()
    ser = (saf * exposed).sum() / saf.sum().clamp_min(1.0)        # Eq. 17
    return PrivacyMetrics(cer=cer, ter=ter, ser=ser)


def reductions(m: PrivacyMetrics) -> dict:
    """Table V 'Reduction vs. Cloud-Only' column (%)."""
    return {
        "CER": float((1.0 - m.cer) * 100.0),
        "TER": float((1.0 - m.ter) * 100.0),
        "SER": float((1.0 - m.ser) * 100.0),
    }
