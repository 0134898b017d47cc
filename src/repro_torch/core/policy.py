"""State-action-environment view of routing (paper Sec. IV-A, Eq. 1),
PyTorch.

Mirrors ``repro/core/policy.py``: the paper implements a threshold policy
and leaves learned policies to future work; this is the reward signal
(Eq. 1) and the historical accuracy statistics that approximate
E[Acc(Q,d)] (Eq. 11) by difficulty and risk.  The statistics are values,
as in the reference: ``update`` returns new tensors and leaves its input
untouched.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class RewardWeights:
    acc: float = 1.0
    lat: float = 0.05       # per second
    cost: float = 1e4       # per dollar
    pol: float = 2.0        # policy-violation penalty


def reward(acc_hat: torch.Tensor, latency: torch.Tensor, cost: torch.Tensor,
           violation: torch.Tensor, w: RewardWeights) -> torch.Tensor:
    """Eq. 1: r_t = λacc·Acc − λlat·Lat − λcost·Cost − λpol·1[violation]."""
    return (w.acc * acc_hat - w.lat * latency - w.cost * cost
            - w.pol * violation.to(torch.float32))


class AccuracyStats(NamedTuple):
    """Historical P(correct | difficulty bin, risk, action) (Eq. 11 approx)."""
    counts: torch.Tensor    # (bins, 2, actions)
    correct: torch.Tensor   # (bins, 2, actions)

    @staticmethod
    def init(bins: int = 8, actions: int = 5,
             device=None) -> "AccuracyStats":
        z = torch.zeros((bins, 2, actions), dtype=torch.float32,
                        device=device)
        return AccuracyStats(counts=z, correct=z.clone())

    def _index(self, u, risk, action):
        bins = self.counts.shape[0]
        b = torch.clamp((u * bins).to(torch.int32), 0, bins - 1)
        return (b.long(), risk.to(torch.int32).long(),
                action.to(torch.int32).long())

    def update(self, u: torch.Tensor, risk: torch.Tensor,
               action: torch.Tensor,
               was_correct: torch.Tensor) -> "AccuracyStats":
        """Add one observation per element; repeated cells accumulate."""
        idx = self._index(u, risk, action)
        ones = torch.ones(idx[0].shape, dtype=torch.float32,
                          device=self.counts.device)
        return AccuracyStats(
            counts=self.counts.index_put(idx, ones, accumulate=True),
            correct=self.correct.index_put(
                idx, was_correct.to(torch.float32), accumulate=True))

    def estimate(self, u: torch.Tensor, risk: torch.Tensor,
                 action: torch.Tensor, prior: float = 0.5,
                 strength: float = 2.0) -> torch.Tensor:
        idx = self._index(u, risk, action)
        c, k = self.correct[idx], self.counts[idx]
        return (c + prior * strength) / (k + strength)
