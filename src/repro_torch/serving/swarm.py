"""Swarm executor: heterogeneous peer collaboration + weighted consensus
(PyTorch port of ``repro/serving/swarm.py``).

Runs up to k peer engines on the same query batch, clusters answers by
exact token sequence, and applies the Eq. 14 uncertainty-weighted consensus
(core/consensus.py).  Quorum mode (beyond-paper straggler mitigation) takes
the fastest `quorum` members' answers — under the simulator this turns
Eq. 9's max() into an order statistic and bounds swarm tail latency.

Answers, u and the consensus inputs are host numpy arrays, as in the
reference; a member's logits stay a tensor on its engine's device, and the
Eq. 2-4 terms over them run there (the fused uncertainty op).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import uncertainty as U
from repro_torch.core.consensus import PAD, batched_consensus
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.faults import FaultPlan, MemberDownError
from repro_torch.serving.scheduler import Request


def pad_prompts(prompts: Sequence[Sequence[int]], length: int | None = None,
                align: str = "left") -> np.ndarray:
    """Pad variable-length prompts with PAD=0 into (B, S).

    align="left" (left-pad, HF batched-decode convention) for generation;
    align="right" (right-pad) for the safety classifier, matching its
    training layout."""
    length = length or max(len(p) for p in prompts)
    out = np.zeros((len(prompts), length), np.int32)
    for i, p in enumerate(prompts):
        p = list(p)[-length:]
        if align == "left":
            out[i, length - len(p):] = p
        else:
            out[i, :len(p)] = p
    return out


def truncate_at_stop(tokens: np.ndarray, stop_token: int | None) -> np.ndarray:
    """Answer normalisation (paper's lowercase/collapse analogue): keep
    tokens up to and excluding the first stop token, PAD the rest — so
    cross-model clustering compares *answers*, not trailing continuations."""
    if stop_token is None:
        return tokens
    out = tokens.copy()
    hit = np.cumsum(tokens == stop_token, axis=-1) > 0
    out[hit] = PAD
    return out


def answer_mask(tokens: np.ndarray, stop_token: int | None) -> np.ndarray:
    """Bool mask of the *answer* span: positions up to and INCLUDING the
    first stop token (everything a request would have decoded before
    retiring).  Eq. 2-4 difficulty restricted to this span matches the
    streaming serve path's accumulation — post-answer entropy is not
    folded into u."""
    if stop_token is None:
        return np.ones(tokens.shape, bool)
    eq = tokens == stop_token
    hit = np.cumsum(eq, axis=-1)
    return (hit == 0) | ((hit == 1) & eq)


@dataclasses.dataclass
class SwarmExecutor:
    members: list[InferenceEngine]
    w_min: float = 0.05
    stop_token: int | None = None
    streaming: bool = False      # route rounds through each member's serve()
    serve_slots: int = 4         # decode slots when streaming
    # execution-level fault injection (serving/faults.py): member calls
    # run through plan sites "member:<j>" — a crash/timeout drops that
    # member's candidates for the round (quorum salvage: consensus
    # renormalizes over survivors), a straggle reports its delay for the
    # gateway's Eq. 9 accounting.  Streaming members forward the plan
    # into serve() (famine/evict/slot sites) with overload="shed" so a
    # member-side famine degrades to PAD answers instead of crashing
    # the round.  None (default) leaves execution bitwise untouched.
    faults: FaultPlan | None = None

    def collaborate(self, prompts: np.ndarray, max_new: int, *,
                    member_mask: np.ndarray | None = None,
                    seed: int = 0,
                    precomputed: dict[int, tuple] | None = None,
                    states: dict[int, object] | None = None) -> dict:
        """prompts (B, S). member_mask (n,) bool marks *available* members
        (node-failure injection / quorum selection excludes the rest).

        Each member answers the whole round in ONE batched engine invocation
        (prefill + decode loop).  ``streaming=True`` instead feeds
        the round through the member's continuous-batching ``serve`` path —
        same greedy tokens, but sized for requests that arrive over time,
        not for a round that is known upfront.  Requests retire at
        ``stop_token``, so streamed and batched rounds agree on answers
        AND on u: the batched path masks its Eq. 2-4 difficulty to the
        answer span (up to and including the stop token — ``answer_mask``),
        matching what the streaming path accumulates before retirement.

        ``precomputed`` maps member index -> (tokens (B, N), u (B,)[,
        (h_mean, v_mean)]) for members whose generations the caller already
        has (the gateway's probe), so they are not re-run — the round
        issues ZERO prefill dispatches for them.  ``states`` maps member
        index -> the matching ``SessionState`` warm-cache handle; when the
        round wants a longer answer than the precomputed one (escalation
        deepening), the member *extends* its generation decode-only from
        the live cache instead of re-prefilling the prompt, and u is
        re-averaged over the full span from the provided raw Eq. 2-3 means.
        The handoff the gateway builds (``state_select``) is a copy of the
        selected cache rows, which the extension then writes in place.

        Returns ``{"answers": (B, n, N) per-member tokens, "u": (B, n)
        Eq. 4 difficulties, "winner_tokens": (B, N), "winner_member":
        (B,), "consensus_score": (B,) best Eq. 14 cluster score,
        "scores": (B, n)}``.
        """
        n = len(self.members)
        B = prompts.shape[0]
        if member_mask is None:
            member_mask = np.ones((n,), bool)

        answers = np.full((B, n, max_new), PAD, np.int32)
        u = np.ones((B, n), np.float32)            # unavailable => weight w_min
        casualties: list[int] = []
        straggle: dict[int, float] = {}
        for j, eng in enumerate(self.members):
            if not member_mask[j]:
                continue

            def run(j=j, eng=eng):
                if precomputed is not None and j in precomputed:
                    toks, uj = precomputed[j][0], precomputed[j][1]
                    toks = np.asarray(toks, np.int32)
                    n_pre = toks.shape[1]
                    if n_pre < max_new:
                        if states is None or j not in states:
                            raise ValueError(
                                f"member {j}: precomputed answer covers "
                                f"{n_pre} < {max_new} tokens and no session"
                                " state was provided to extend it from")
                        # decode-only continuation off the warm cache: the
                        # extension emits exactly the tokens a longer
                        # original generation would have produced next —
                        # zero prefills
                        ext = eng.generate(None, max_new - n_pre,
                                           state=states[j], seed=seed + j)
                        pre_toks = toks
                        toks = np.concatenate([toks, ext["tokens"]], axis=1)
                        if len(precomputed[j]) > 2:
                            uj = self._deepened_u(eng, pre_toks, ext,
                                                  precomputed[j][2], uj)
                    return toks, uj
                if self.streaming:
                    # the padded row (incl. leading PADs) is the request
                    # prompt, so per-request absorption matches batched
                    # generation
                    reqs = [Request(rid=i, prompt=prompts[i].tolist(),
                                    max_new=max_new) for i in range(B)]
                    fin = eng.serve(reqs, n_slots=min(B, self.serve_slots),
                                    stop_token=self.stop_token, seed=seed + j,
                                    faults=self.faults, overload="shed")
                    toks = np.zeros((B, max_new), np.int32)
                    uj = np.ones((B,), np.float32)
                    for r in fin:
                        if r.get("shed"):
                            continue   # PAD answer + u=1 => w_min sentinel
                        toks[r["rid"], :len(r["tokens"])] = r["tokens"]
                        uj[r["rid"]] = r["u"]
                    return toks, uj
                res = eng.generate(prompts, max_new, seed=seed + j)
                # mask u to the answer span so batched and streaming
                # rounds score identically (no post-answer entropy)
                return res["tokens"], self.member_u(eng, res)

            if self.faults is None:
                toks, uj = run()
            else:
                try:
                    (toks, uj), delay = self.faults.call(f"member:{j}", run)
                except MemberDownError:
                    # casualty: keep PAD answers + u=1.0, the same
                    # sentinel-cluster/w_min floor an unavailable member
                    # gets — consensus renormalizes over survivors and
                    # quorum is satisfied by whoever returned
                    casualties.append(j)
                    continue
                if delay:
                    straggle[j] = delay
            answers[:, j, :] = truncate_at_stop(np.asarray(toks, np.int32),
                                                self.stop_token)
            u[:, j] = uj

        # unavailable members keep PAD answers; give them zero support by
        # grouping them into a sentinel cluster with weight w_min (paper's
        # floor) — exact-match keeps them away from real clusters.
        res = batched_consensus(torch.from_numpy(answers),
                                torch.from_numpy(u), w_min=self.w_min)
        rep = res.rep_index.numpy()
        winners = answers[np.arange(B), rep]
        return {
            "answers": answers,                       # (B, n, N)
            "u": u,                                   # (B, n)
            "winner_tokens": winners,                 # (B, N)
            "winner_member": rep,                     # (B,)
            "consensus_score": res.best_score.numpy(),  # (B,)
            "scores": res.scores.numpy(),             # (B, n)
            # failure-domain report: members that crashed mid-round (the
            # gateway refunds their Eq. 9 edge-latency term and records
            # the failure in its health registry) and injected straggler
            # delays in seconds (added to that member's comm term)
            "casualties": casualties,                 # list[int]
            "straggle_s": straggle,                   # {member: seconds}
        }

    def _deepened_u(self, eng: InferenceEngine, pre_toks: np.ndarray,
                    ext: dict, pre_terms: tuple,
                    uj: np.ndarray) -> np.ndarray:
        """u for a member whose precomputed answer was extended decode-only.

        Scored over the same answer span ``member_u`` uses for everyone
        else: with no stop token, the caller's raw Eq. 2-3 means re-average
        over the full span; with one, extension terms are masked to the
        answer and rows whose answer already ended inside the prefix keep
        the caller's (answer-span) u untouched.
        """
        h1, v1 = pre_terms
        n_pre = pre_toks.shape[1]
        k = ext["tokens"].shape[1]
        if self.stop_token is None:
            h = (h1 * n_pre + ext["h_mean"] * k) / (n_pre + k)
            v = (v1 * n_pre + ext["v_mean"] * k) / (n_pre + k)
            return np.asarray(U.combine_terms(h, v, eng.ucfg))
        if ext.get("logits") is None:
            return uj            # can't mask the extension terms: keep the
                                 # caller's answer-span u (conservative)
        full_mask = answer_mask(
            np.concatenate([pre_toks, ext["tokens"]], axis=1),
            self.stop_token)
        prefix_clean = full_mask[:, :n_pre].all(axis=1)
        ext_mask = full_mask[:, n_pre:]
        h2, v2 = U.uncertainty_terms(
            ext["logits"], _tokens(ext["tokens"], ext["logits"]), eng.ucfg)
        n2 = ext_mask.sum(axis=1)
        d = n_pre + n2
        h = (h1 * n_pre + (h2.cpu().numpy() * ext_mask).sum(axis=1)) / d
        v = (v1 * n_pre + (v2.cpu().numpy() * ext_mask).sum(axis=1)) / d
        return np.where(prefix_clean,
                        np.asarray(U.combine_terms(h, v, eng.ucfg)), uj)

    def member_u(self, eng: InferenceEngine, res: dict) -> np.ndarray:
        """Eq. 2-4 difficulty of a member generation restricted to the
        answer span (``answer_mask``).  This is the u the streaming serve
        path reports — a request retires at the stop token, so its
        accumulated terms never include post-answer steps — and the
        batched path must score the same way for the two to agree."""
        if self.stop_token is None or res.get("logits") is None:
            return res["u"]
        lg = res["logits"]
        mask = answer_mask(np.asarray(res["tokens"], np.int32),
                           self.stop_token)
        return U.difficulty(lg, _tokens(res["tokens"], lg), eng.ucfg,
                            mask=torch.from_numpy(mask).to(lg.device)
                            ).cpu().numpy()


def _tokens(tokens: np.ndarray, logits: torch.Tensor) -> torch.Tensor:
    """Host tokens as an int32 tensor beside their logits."""
    return torch.as_tensor(np.asarray(tokens, np.int32), device=logits.device)
