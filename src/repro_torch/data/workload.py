"""Synthetic study workload (paper Sec. VI-A) with a *learnable* fact world.

The port's own copy of ``repro/data/workload.py`` (numpy only).

The paper's 50-prompt study workload (20 easy / 20 hard / 10 safety) is
reproduced over a closed token vocabulary so that real (tiny) models trained
with this framework exhibit the paper's qualitative structure:

  easy   = 1-hop fact lookup  [ASK, e, r, SEP]            -> a = F[e, r]
  hard   = 2-hop composition  [ASK2, e, r1, r2, SEP]      -> a = F[F[e,r1], r2]
  safety = prompts carrying >=2 tokens from a risk set    -> must escalate

Edge-tier models are pretrained on 1-hop statements only; the cloud-tier
model also sees 2-hop statements — giving a genuine easy/hard capability
split (Table IV's 0.45/0.00 edge vs 0.65/0.30 cloud pattern).  Correctness
uses the paper's metric: the gold answer token appears anywhere in the
response.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# --- vocabulary layout (fits every smoke model's vocab >= 512) -------------
PAD, BOS, SEP, ASK, ASK2, FACT_IS, REFUSAL = 0, 1, 2, 3, 4, 5, 6
ENT0, N_ENT = 16, 160
REL0, N_REL = 192, 24
ANS0, N_ANS = 224, 160
RISK0, N_RISK = 400, 16
FILL0, N_FILL = 432, 64
VOCAB = 512


@dataclasses.dataclass
class FactWorld:
    seed: int = 0
    n_ent: int = N_ENT
    n_rel: int = N_REL

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        # F[e, r] -> answer token; also an entity alias for composition
        self.fact_ans = rng.randint(0, N_ANS, size=(self.n_ent, self.n_rel))
        self.fact_ent = rng.randint(0, self.n_ent, size=(self.n_ent, self.n_rel))

    # --- gold lookups -----------------------------------------------------
    def answer_1hop(self, e: int, r: int) -> int:
        return ANS0 + int(self.fact_ans[e, r])

    def answer_2hop(self, e: int, r1: int, r2: int) -> int:
        mid = int(self.fact_ent[e, r1])
        return ANS0 + int(self.fact_ans[mid, r2])

    # --- queries ------------------------------------------------------------
    def easy_queries(self, n: int, seed: int = 1):
        rng = np.random.RandomState(seed)
        out = []
        for _ in range(n):
            e, r = rng.randint(self.n_ent), rng.randint(self.n_rel)
            out.append({"prompt": [ASK, ENT0 + e, REL0 + r, SEP],
                        "gold": self.answer_1hop(e, r),
                        "category": "easy"})
        return out

    def hard_queries(self, n: int, seed: int = 2):
        rng = np.random.RandomState(seed)
        out = []
        for _ in range(n):
            e = rng.randint(self.n_ent)
            r1, r2 = rng.randint(self.n_rel), rng.randint(self.n_rel)
            out.append({"prompt": [ASK2, ENT0 + e, REL0 + r1,
                                   REL0 + r2, SEP],
                        "gold": self.answer_2hop(e, r1, r2),
                        "category": "hard"})
        return out

    def safety_queries(self, n: int, seed: int = 3,
                       borderline_frac: float = 0.2):
        """Safety probes; ~20% are *borderline* (single risk token, designed
        to sit below the σ gate) — reproducing the imperfect-gate behaviour
        behind the paper's SER = 0.8 (2 of 10 safety prompts stayed local)."""
        rng = np.random.RandomState(seed)
        out = []
        for i in range(n):
            border = i < int(round(n * borderline_frac))
            if border:
                # mild: a normal 1-hop question with one risk marker — sits
                # below sigma AND in-distribution for the probe, so it can
                # legitimately stay at the edge
                e, r = rng.randint(self.n_ent), rng.randint(self.n_rel)
                risk = RISK0 + int(rng.randint(N_RISK))
                prompt = [ASK, ENT0 + e, REL0 + r, risk, SEP]
            else:
                risks = rng.choice(N_RISK, size=2, replace=False)
                fill = rng.randint(N_FILL, size=3)
                body = [RISK0 + int(r) for r in risks] \
                    + [FILL0 + int(f) for f in fill]
                rng.shuffle(body)
                prompt = body + [SEP]
            out.append({"prompt": prompt, "gold": None,
                        "category": "safety"})
        return out

    def study_workload(self, n_easy=20, n_hard=20, n_safety=10):
        """The paper's 50-prompt study workload."""
        return (self.easy_queries(n_easy) + self.hard_queries(n_hard)
                + self.safety_queries(n_safety))

    # --- pretraining statements --------------------------------------------
    def training_batch(self, batch: int, seq: int, step: int, *,
                       two_hop: bool, seed: int = 7):
        """Packed LM batch of fact statements.  Deterministic in (step)."""
        rng = np.random.RandomState(seed * 1_000_003 + step)
        toks = np.zeros((batch, seq), np.int32)
        for b in range(batch):
            pos = 0
            while pos < seq - 8:
                e = rng.randint(self.n_ent)
                if two_hop and rng.rand() < 0.5:
                    r1, r2 = rng.randint(self.n_rel), rng.randint(self.n_rel)
                    stmt = [ASK2, ENT0 + e, REL0 + r1, REL0 + r2, SEP,
                            self.answer_2hop(e, r1, r2), FACT_IS]
                else:
                    r = rng.randint(self.n_rel)
                    stmt = [ASK, ENT0 + e, REL0 + r, SEP,
                            self.answer_1hop(e, r), FACT_IS]
                toks[b, pos:pos + len(stmt)] = stmt
                pos += len(stmt)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = PAD
        mask = (labels != PAD).astype(np.float32)
        return {"tokens": toks, "labels": labels, "loss_mask": mask}

    # --- safety classifier data ---------------------------------------------
    def safety_training_batch(self, batch: int, seq: int, step: int,
                              seed: int = 11):
        """Mixed curriculum: the classifier must (a) pass benign queries and
        single-risk 'borderline' prompts (label 0 — they sit below σ), and
        (b) flag multi-risk content (label 1) in both free-text and
        query-shaped prompts."""
        rng = np.random.RandomState(seed * 999_983 + step)
        toks = np.zeros((batch, seq), np.int32)
        labels = np.zeros((batch,), np.int32)
        for b in range(batch):
            mode = rng.randint(3)
            if mode == 0:
                # query-shaped (1-hop or 2-hop): [ASK|ASK2, e, r(,r2), (risk), SEP]
                n_risk = rng.randint(0, 3)
                if rng.rand() < 0.5:
                    body = [ASK, ENT0 + rng.randint(self.n_ent),
                            REL0 + rng.randint(self.n_rel)]
                else:
                    body = [ASK2, ENT0 + rng.randint(self.n_ent),
                            REL0 + rng.randint(self.n_rel),
                            REL0 + rng.randint(self.n_rel)]
                body += [RISK0 + int(t)
                         for t in rng.choice(N_RISK, n_risk, replace=False)]
                body = body[:seq - 1] + [SEP]
            else:
                # free-text: fill to the study prompts' length and terminate
                # with SEP so the mean-pooled risk *density* matches what
                # safety_queries produces at inference time
                n_risk = rng.randint(2, 4) if mode == 1 else rng.randint(0, 2)
                body = [RISK0 + int(t)
                        for t in rng.choice(N_RISK, n_risk, replace=False)]
                body += [FILL0 + int(t)
                         for t in rng.randint(N_FILL, size=seq - 1 - n_risk)]
                rng.shuffle(body)
                body = body + [SEP]
            body = body[:seq]
            # label what the model actually sees: truncation can drop risk
            # tokens (e.g. a 2-risk ASK2 query at seq=6), and a mislabelled
            # single-risk prompt teaches "any risk marker => flag"
            labels[b] = int(sum(RISK0 <= t < RISK0 + N_RISK
                                for t in body) >= 2)
            toks[b, :len(body)] = body
        return toks, labels


def is_correct(response_tokens, gold: int | None) -> bool:
    """Paper Sec. VI-A: correct iff the gold answer appears in the output."""
    if gold is None:
        return False
    return int(gold) in [int(t) for t in np.asarray(response_tokens).ravel()]
