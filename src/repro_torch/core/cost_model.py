"""Cost and latency models (paper Sec. IV-D, Eq. 7-9) + Table I defaults,
PyTorch.

Mirrors ``repro/core/cost_model.py``.  Every function but
``latency_swarm`` is arithmetic and takes numbers, numpy arrays or tensors
alike; ``latency_swarm`` takes tensors (it sorts over the member axis).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CostParams:
    # Table I / Sec. V-A: Together.ai list price US$0.88 per 1M tokens
    c_cloud_per_token: float = 0.88e-6   # input == output price
    c_edge_per_token: float = 0.0        # energy-dominated, ~0 monetary
    c_comm_per_byte: float = 1e-12       # proxy cost for swarm traffic
    bytes_per_token: float = 4.0         # answer-exchange encoding


def cost_cloud(t_prompt, t_completion, p: CostParams):
    """Eq. 7: c_cloud * (T_cloud + T_prompt)."""
    return p.c_cloud_per_token * (t_prompt + t_completion)


def cost_swarm(t_edge, bytes_exchanged, p: CostParams):
    """Eq. 8: c_edge * T_edge + c_comm * B(Q)."""
    return p.c_edge_per_token * t_edge + p.c_comm_per_byte * bytes_exchanged


def swarm_bytes(t_prompt, t_answers, p: CostParams):
    """B(Q): request broadcast + collected answers, in bytes."""
    return p.bytes_per_token * (t_prompt + t_answers)


@dataclasses.dataclass(frozen=True)
class LatencyParams:
    """Calibrated against the paper's Table III measurements (seconds):
    edge-only mean 1.05 / p95 2.28; cloud-only mean 4.47 / p95 11.33, at
    ~14-token exchanges (short factoid prompts + answers)."""
    edge_per_token: float = 0.075        # SLM decode, desktop-class GPU
    edge_prefill: float = 0.080          # probe/prefill fixed part
    edge_jitter_sigma: float = 0.45      # lognormal multiplicative jitter
    cloud_per_token: float = 0.230       # 70B API decode incl. queueing
    wan_rtt_mean: float = 1.500          # WAN round-trip + API overhead
    wan_rtt_std: float = 4.500           # heavy-tail variability (p95 tail)
    comm_peer_mean: float = 0.150        # local wireless link, per message
    comm_peer_std: float = 0.080
    agg_overhead: float = 0.005          # L_agg at the gateway


def latency_edge(t_tokens, p: LatencyParams):
    return p.edge_prefill + p.edge_per_token * t_tokens


def latency_cloud(t_tokens, wan_rtt, p: LatencyParams):
    return wan_rtt + p.cloud_per_token * t_tokens


def latency_retries(n_failed, timeout_s: float, backoff_s):
    """Realized latency of a retried cloud summon's FAILED attempts: each
    burns its full per-attempt deadline ``timeout_s``, plus the backoff
    sleeps drawn between attempts (``backoff_s`` in total)."""
    return n_failed * timeout_s + backoff_s


def latency_swarm(edge_lats: torch.Tensor, comm_lats: torch.Tensor,
                  p: LatencyParams, quorum: int | None = None
                  ) -> torch.Tensor:
    """Eq. 9: max over self+peers of (L_edge^j + L_comm_j) + L_agg.

    ``quorum`` (straggler mitigation): wait only for the fastest ``quorum``
    members, so the max becomes the quorum-th order statistic."""
    per = edge_lats + comm_lats                   # (..., n_members)
    if quorum is None or quorum >= per.shape[-1]:
        tail = per.max(dim=-1).values
    else:
        tail = torch.sort(per, dim=-1).values[..., quorum - 1]
    return tail + p.agg_overhead
