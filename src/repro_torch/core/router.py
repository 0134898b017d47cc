"""Threshold routing: Phase A of Algorithm 1 (paper Sec. IV-F/IV-G), PyTorch.

Mirrors ``route`` and ``summoning_rate`` of ``repro/core/router.py``: from
the probe's difficulty U, the safety risk, the WAN state, latency estimates
and the hard cloud budget, each query is assigned LOCAL / SWARM / CLOUD /
CLOUD_SAFETY / REFUSE.  Cloud admission is budget-sequential (Eq. 13, via
``budget.charge_batch``).  Phase B (``post_consensus``): after the swarm
round, queries whose best cluster score S(a*) < gamma escalate to the cloud
(budget and WAN permitting) or keep the best-effort swarm answer
(Algorithm 1 lines 15-23).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.budget import BudgetState, charge_batch

LOCAL, SWARM, CLOUD, CLOUD_SAFETY, REFUSE = 0, 1, 2, 3, 4
DECISION_NAMES = ("local", "swarm", "cloud", "cloud_safety", "refuse")


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    # Table I defaults
    tau_low: float = 0.35
    tau_high: float = 0.65
    sigma: float = 0.7
    peers_k: int = 3
    gamma: float = 0.6
    l_max: float = 0.5                # seconds

    @staticmethod
    def final() -> "RouterConfig":
        """Sec. V-C "final experiments" preset."""
        return RouterConfig(tau_low=0.08, tau_high=0.22, peers_k=2,
                            gamma=0.3, l_max=4.0)


class RouteResult(NamedTuple):
    decision: torch.Tensor   # (B,) int32 decision codes
    risk: torch.Tensor       # (B,) int32 R(Q)
    budget: BudgetState


def route(u: torch.Tensor, safety_s: torch.Tensor, *, cfg: RouterConfig,
          budget: BudgetState, wan_ok, est_cloud_cost: torch.Tensor,
          l_edge: torch.Tensor | None = None,
          l_cloud: torch.Tensor | None = None) -> RouteResult:
    """Phase A of Algorithm 1.  All inputs (B,); wan_ok () or (B,) bool."""
    B = u.shape[0]
    wan_ok = torch.as_tensor(wan_ok, dtype=torch.bool,
                             device=u.device).expand(B)
    risk = (safety_s > cfg.sigma).to(torch.int32)                   # Eq. 6

    wants_cloud = (risk == 1) | (u >= cfg.tau_high)
    # latency gating: a local path violating L_max prefers the cloud when the
    # cloud meets the deadline (objective O1)
    if l_edge is not None and l_cloud is not None:
        wants_cloud = wants_cloud | ((l_edge > cfg.l_max)
                                     & (l_cloud <= cfg.l_max))

    admitted, budget = charge_batch(budget, est_cloud_cost,
                                    wants_cloud & wan_ok)
    is_cloud = wants_cloud & admitted & wan_ok

    # risk-flagged but cloud unavailable -> best-effort refusal (Alg.1 l.6)
    refuse = (risk == 1) & ~is_cloud
    # denied non-risk cloud aspirants fall back to swarm (O5 chain)
    fallback_swarm = wants_cloud & ~is_cloud & (risk == 0)
    is_swarm = (((u >= cfg.tau_low) & (u < cfg.tau_high) & (risk == 0))
                | fallback_swarm)

    decision = torch.full((B,), LOCAL, dtype=torch.int32, device=u.device)
    decision = torch.where(is_swarm, SWARM, decision)
    decision = torch.where(is_cloud & (risk == 0), CLOUD, decision)
    decision = torch.where(is_cloud & (risk == 1), CLOUD_SAFETY, decision)
    decision = torch.where(refuse, REFUSE, decision)
    return RouteResult(decision=decision.to(torch.int32), risk=risk,
                       budget=budget)


class PostConsensusResult(NamedTuple):
    decision: torch.Tensor          # (B,) final decision codes
    use_swarm_answer: torch.Tensor  # (B,) bool: keep best-effort swarm answer
    budget: BudgetState


def post_consensus(decision: torch.Tensor, consensus_score: torch.Tensor, *,
                   cfg: RouterConfig, budget: BudgetState, wan_ok,
                   est_cloud_cost: torch.Tensor) -> PostConsensusResult:
    """Phase B: escalate under-consensus swarm queries (Alg. 1 l.15-23)."""
    B = decision.shape[0]
    wan_ok = torch.as_tensor(wan_ok, dtype=torch.bool,
                             device=decision.device).expand(B)
    was_swarm = decision == SWARM
    weak = was_swarm & (consensus_score < cfg.gamma)
    admitted, budget = charge_batch(budget, est_cloud_cost, weak & wan_ok)
    escalate = weak & admitted & wan_ok
    new_decision = torch.where(escalate, CLOUD, decision).to(torch.int32)
    return PostConsensusResult(decision=new_decision,
                               use_swarm_answer=was_swarm & ~escalate,
                               budget=budget)


def summoning_rate(decision: torch.Tensor) -> torch.Tensor:
    """Fraction escalated to the FM (metric 3, Sec. VI-B)."""
    cloud = (decision == CLOUD) | (decision == CLOUD_SAFETY)
    return cloud.float().mean()
