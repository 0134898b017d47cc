"""Uncertainty-weighted swarm consensus (paper Sec. IV-G, Eq. 14), PyTorch.

Mirrors ``repro/core/consensus.py``, with the peer dimension and the batch
written out instead of ``vmap``.  Answers are token-id sequences padded with
``PAD = -1`` (prompts pad with 0, answers with -1).  Clustering is exact
match in token space; node j weighs w_j = clip(1 - U_j, w_min, 1) and a
cluster scores S(a) = sum_{j in a} w_j / sum_k w_k.  The representative of
the winning cluster is its longest member, the first such on ties.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PAD = -1
W_MIN_DEFAULT = 0.05  # paper's w_min


class ConsensusResult(NamedTuple):
    rep_index: torch.Tensor   # (...,) int32: index of representative answer
    best_score: torch.Tensor  # (...,) f32: S(a*) in [0, 1]
    cluster_id: torch.Tensor  # (..., n) int32: cluster of each answer
    scores: torch.Tensor      # (..., n) f32: S(cluster_of_j) per answer
    weights: torch.Tensor     # (..., n) f32: w_j


def batched_consensus(answers: torch.Tensor, u: torch.Tensor,
                      w_min: float = W_MIN_DEFAULT) -> ConsensusResult:
    """Eq. 14 per row.  answers (B, n, T) integer, u (B, n) in [0, 1]."""
    n = answers.shape[-2]
    eq = (answers[..., :, None, :] == answers[..., None, :, :]).all(-1)
    # cluster id = smallest index of an equal answer (exact match is
    # transitive, so this is a partition)
    idx = torch.arange(n, device=answers.device)
    cluster = torch.where(eq, idx, n).min(dim=-1).values
    w = (1.0 - u.float()).clamp(w_min, 1.0)                     # (B, n)
    total = w.sum(-1, keepdim=True)
    member_w = torch.where(eq, w[..., None, :], 0.0)
    scores = member_w.sum(-1) / total.clamp_min(1e-9)
    best = scores.max(dim=-1).values
    lengths = (answers != PAD).sum(-1)
    in_best = scores >= best[..., None] - 1e-9
    rep = torch.where(in_best, lengths, -1).argmax(dim=-1)      # first max
    return ConsensusResult(rep_index=rep.to(torch.int32), best_score=best,
                           cluster_id=cluster.to(torch.int32),
                           scores=scores, weights=w)


def weighted_consensus(answers: torch.Tensor, u: torch.Tensor,
                       w_min: float = W_MIN_DEFAULT) -> ConsensusResult:
    """Eq. 14 over n peer answers.  answers (n, T), u (n,)."""
    res = batched_consensus(answers[None], u[None], w_min)
    return ConsensusResult(*(t[0] for t in res))


def consensus_decision(result: ConsensusResult, gamma: float) -> torch.Tensor:
    """1 if the swarm answer is accepted (S(a*) >= gamma), else escalate."""
    return (result.best_score >= gamma).to(torch.int32)
