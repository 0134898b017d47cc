"""The SWARM-LLM gateway: Algorithm 1 end-to-end over query batches
(PyTorch port of ``repro/serving/gateway.py``).

Wires together every core component — safety gate (Eq. 5-6), probe
uncertainty (Eq. 2-4), threshold routing + hard budget (Sec. IV-F, Eq. 13),
swarm collaboration + weighted consensus (Eq. 14), cloud escalation with
the O5 degradation chain, privacy logging (Eq. 15-17) and the distillation
buffer (Sec. IV-H).  Model execution is real; link timings come from the
simulator (see serving/simulator.py docstring).

The probe SLM *is* the local SLM (paper Sec. IV-A): its generation doubles
as the local answer, so Level-0 queries cost exactly one SLM pass.

The models (safety encoder, probe, peers, cloud) run on their engines'
device, the card unless the caller built them on the CPU.  The control
plane — router, budget, consensus, cost and latency formulas — runs on
host tensors of a few dozen entries, as the reference's host-side numpy
bookkeeping around it does; the formulas take f32 where the reference's
``jnp`` arrays are f32, so the logs agree number for number.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import budget as budget_lib
from repro_torch.core import cost_model as cm
from repro_torch.core import router as router_lib
from repro_torch.core.distill import DistillBuffer
from repro_torch.core.privacy import privacy_metrics
from repro_torch.core.router import (CLOUD, CLOUD_SAFETY, LOCAL, REFUSE,
                                     SWARM, RouterConfig)
from repro_torch.core.safety import safety_score
from repro_torch.data.workload import REFUSAL, is_correct
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.faults import (CircuitBreaker, CloudUnavailableError,
                                        FaultPlan, HealthRegistry,
                                        RetryPolicy)
from repro_torch.serving.simulator import NetworkSimulator
from repro_torch.serving.swarm import (SwarmExecutor, pad_prompts,
                                       truncate_at_stop)


def _f32(a) -> torch.Tensor:
    """A host f32 tensor: where the reference hands ``jnp`` f32 arrays to
    the control plane."""
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)

#: engine-side failure counters the gateway folds into GatewayLog.faults
#: (per-batch deltas summed over swarm members)
_ENGINE_FAULT_KEYS = ("famine_deferred", "shed", "requeued",
                      "reprefill_cold", "expired")


@dataclasses.dataclass
class GatewayLog:
    decision: np.ndarray        # (Q,) router codes
    u: np.ndarray               # (Q,) difficulty
    safety: np.ndarray          # (Q,) safety score s
    latency: np.ndarray         # (Q,) end-to-end seconds
    cost: np.ndarray            # (Q,) dollars
    prompt_len: np.ndarray      # (Q,) prompt length (chars proxy = tokens)
    category: list              # (Q,) easy|hard|safety
    correct: np.ndarray         # (Q,) bool (False where no gold)
    answers: np.ndarray         # (Q, N) final answer tokens
    consensus: np.ndarray       # (Q,) best cluster score (NaN if no swarm)
    # failure-domain record (docs/RUNTIME.md "Failure semantics"): retry/
    # degradation/shed counters for this batch — cloud summon attempts and
    # failures, circuit-breaker transitions, member casualties/straggle,
    # and the swarm engines' famine/shed/requeue/re-prefill deltas.
    faults: dict = dataclasses.field(default_factory=dict)
    # (Q,) bool: the query got a *served* response (a safety-policy refusal
    # counts as served; a degradation-forced refusal — cloud required but
    # unreachable after retries — does not)
    answered: np.ndarray | None = None

    def availability(self) -> float:
        """Fraction of queries that received a served answer (Table V-style
        robustness metric: accuracy tells how good the answers were,
        availability tells how many queries got one at all)."""
        return 1.0 if self.answered is None else float(self.answered.mean())

    def cloud_usage(self) -> float:
        return float(np.mean((self.decision == CLOUD)
                             | (self.decision == CLOUD_SAFETY)))

    def accuracy(self, category: str | None = None) -> float:
        sel = np.array([c != "safety" and (category is None or c == category)
                        for c in self.category])
        return float(self.correct[sel].mean()) if sel.any() else float("nan")

    def privacy(self):
        is_saf = np.array([c == "safety" for c in self.category])
        return privacy_metrics(torch.as_tensor(self.decision),
                               torch.as_tensor(self.prompt_len),
                               torch.as_tensor(is_saf))


@dataclasses.dataclass
class Gateway:
    probe: InferenceEngine                  # local SLM / probe (Tier 1)
    swarm: SwarmExecutor                    # peers (includes probe or not)
    cloud: InferenceEngine | None           # Foundation Nexus (Tier 2)
    safety_params: Any
    safety_cfg: Any
    router_cfg: RouterConfig
    sim: NetworkSimulator
    cost_params: cm.CostParams = dataclasses.field(default_factory=cm.CostParams)
    lat_params: cm.LatencyParams = dataclasses.field(default_factory=cm.LatencyParams)
    budget_total: float = 1.0
    max_new: int = 8
    quorum: int | None = None               # beyond-paper straggler mitigation
    distill_buffer: DistillBuffer = dataclasses.field(default_factory=DistillBuffer)
    # failure-domain runtime (serving/faults.py).  ``faults=None`` (or an
    # empty plan) leaves every code path bitwise-identical to the pre-
    # fault-injection gateway: the retry loop's first attempt is the old
    # single call, backoff jitter draws only from the PLAN's rng (never
    # the simulator's), and the breaker/health registry only change
    # routing after an actual failure.
    faults: FaultPlan | None = None
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    breaker: CircuitBreaker = dataclasses.field(default_factory=CircuitBreaker)

    def __post_init__(self):
        self.budget = budget_lib.init_budget(self.budget_total)
        self._tick = 0
        self.health = HealthRegistry(len(self.swarm.members))
        if self.faults is not None and self.swarm.faults is None:
            self.swarm.faults = self.faults

    def reset_fault_state(self):
        """Rewind everything a determinism re-run needs fresh: budget,
        batch tick, breaker, health registry, the fault plan's schedule
        and rng, and the network simulator's seeded state.  Two identical
        workload runs bracketed by this produce identical winners and
        identical fault/retry/shed counters."""
        self.budget = budget_lib.init_budget(self.budget_total)
        self._tick = 0
        self.breaker.reset()
        self.health = HealthRegistry(len(self.swarm.members))
        self.sim.reset()
        if self.faults is not None:
            self.faults.reset()

    # ------------------------------------------------------------------
    def answer_batch(self, queries: list[dict], seed: int = 0) -> GatewayLog:
        """Algorithm 1 over one query batch.

        queries: list of ``{"prompt": [tokens], "gold": int|None,
        "category": "easy"|"hard"|"safety"}`` (see data/workload.py).
        Returns a :class:`GatewayLog` with per-query routing decisions,
        Eq. 2-4 difficulty, Eq. 5 safety scores, Eq. 7-12 latency/cost,
        Eq. 14 consensus scores, final answers and correctness — the
        record the Table III/IV/V metrics and Eq. 15-17 privacy terms are
        computed from.
        """
        B = len(queries)
        prompts = pad_prompts([q["prompt"] for q in queries])
        plen = (prompts != 0).sum(axis=1)
        self.sim.tick()
        self._tick += 1
        self.health.tick()
        if self.faults is not None:
            self.faults.tick()
        fc = {"cloud_attempts": 0, "cloud_retries": 0, "cloud_failures": 0,
              "cloud_exhausted": 0, "breaker_opened": 0,
              "breaker_open_skips": 0, "degraded_to_swarm": 0,
              "degraded_to_local": 0, "degraded_refused": 0,
              "member_casualties": 0, "member_straggle_s": 0.0}
        fc.update({k: 0 for k in _ENGINE_FAULT_KEYS})
        eng0 = self._member_counters()
        brk0 = self.breaker.opened_count
        answered = np.ones((B,), bool)
        wan_ok = bool(self.sim.wan_up)
        # the WAN gate is one input to the cloud-availability signal; the
        # circuit breaker (opened by exhausted summon retries, half-open
        # after cooldown_ticks) is the other.  An open breaker degrades
        # routing exactly like an outage: the O5 chain sends non-risk
        # cloud aspirants to the swarm and risk queries to REFUSE.
        breaker_ok = self.breaker.allow(self._tick)
        if wan_ok and not breaker_ok:
            fc["breaker_open_skips"] += 1
        cloud_ok = wan_ok and breaker_ok

        # --- safety gate (Eq. 5); right-aligned to match classifier training
        rp = pad_prompts([q["prompt"] for q in queries], align="right")
        sdev = self.safety_params.embed.device
        with torch.inference_mode():
            s = safety_score(self.safety_params, self.safety_cfg,
                             torch.as_tensor(rp, device=sdev)).cpu().numpy()

        # --- probe = local answer + difficulty (Eq. 2-4) ---
        # return_state hands back the probe's filled cache: the swarm round
        # and any escalation deepening continue from it instead of paying
        # the probe's prefill a second time
        probe_res = self.probe.generate(prompts, self.max_new, seed=seed,
                                        return_state=True)
        u = probe_res["u"]
        probe_lat = self.sim.edge_latency(plen + self.max_new)

        # --- phase A routing (Alg. 1 l.1-12, budget Eq. 13) ---
        est_cost = cm.cost_cloud(_f32(plen), float(self.max_new),
                                 self.cost_params).numpy()
        l_cloud_est = self.lat_params.wan_rtt_mean \
            + self.lat_params.cloud_per_token * (plen + self.max_new)
        phase_a = router_lib.route(
            _f32(u), _f32(s), cfg=self.router_cfg,
            budget=self.budget, wan_ok=cloud_ok,
            est_cloud_cost=_f32(est_cost),
            l_edge=_f32(probe_lat),
            l_cloud=_f32(l_cloud_est))
        decision = phase_a.decision.numpy()
        self.budget = phase_a.budget

        # --- swarm round for Level-1 queries (Alg. 1 l.13-14) ---
        # answer normalisation (truncate_at_stop) is applied uniformly:
        # local, swarm and cloud answers are clustered/graded the same way
        stop = self.swarm.stop_token
        latency = probe_lat.copy()
        cost = np.zeros((B,))
        answers = truncate_at_stop(probe_res["tokens"].copy(), stop)
        consensus = np.full((B,), np.nan)
        swarm_mask = decision == SWARM
        if swarm_mask.any():
            # the probe is usually a swarm member: reuse its generation —
            # tokens, answer-span difficulty AND the warm cache handle — so
            # the round issues zero prefill dispatches for the probe member,
            # and any escalation deepening extends decode-only from the
            # live cache instead of re-prefilling the prompt
            idx = np.where(swarm_mask)[0]
            u_ans = self.swarm.member_u(self.probe, probe_res)
            pre = {j: (probe_res["tokens"][swarm_mask], u_ans[swarm_mask],
                       (probe_res["h_mean"][swarm_mask],
                        probe_res["v_mean"][swarm_mask]))
                   for j, m in enumerate(self.swarm.members)
                   if m is self.probe}
            states = {j: self.probe.state_select(probe_res["state"], idx)
                      for j in pre}
            # membership = simulator availability AND health: a member
            # past its consecutive-failure threshold is skipped until its
            # next half-open recovery probe (faults.HealthRegistry)
            up = (np.asarray(self.sim.member_up, bool)
                  & self.health.available())
            sw = self.swarm.collaborate(prompts[swarm_mask], self.max_new,
                                        member_mask=up,
                                        seed=seed, precomputed=pre,
                                        states=states)
            consensus[swarm_mask] = sw["consensus_score"]
            cas = sw.get("casualties", [])
            strag = sw.get("straggle_s", {})
            for j in cas:
                self.health.record_failure(j)
                fc["member_casualties"] += 1
            # Eq. 9 waits only on members that actually returned — down
            # peers AND mid-round casualties must not contribute an
            # edge-latency term (the crashed member's work is refunded;
            # quorum is satisfied by the survivors)
            live = up.copy()
            live[list(cas)] = False
            n_up = int(live.sum())
            if n_up > 0:
                edge_l = self.sim.edge_latency(
                    np.tile((plen[swarm_mask] + self.max_new)[:, None],
                            (1, n_up)))
                comm_l = self.sim.peer_comm(int(swarm_mask.sum()), n_up)
                # an injected straggler's delay rides on its comm term
                live_idx = np.where(live)[0]
                for c, j in enumerate(live_idx):
                    if j in strag:
                        comm_l[:, c] = comm_l[:, c] + strag[j]
                        fc["member_straggle_s"] += float(strag[j])
                sw_lat = cm.latency_swarm(
                    _f32(edge_l), _f32(comm_l), self.lat_params,
                    quorum=self.quorum).numpy()
                # survivors feed the health registry's EWMA latency prior
                for c, j in enumerate(live_idx):
                    self.health.record_success(
                        j, float(edge_l[:, c].mean() + comm_l[:, c].mean()))
            else:
                sw_lat = np.full((int(swarm_mask.sum()),),
                                 self.lat_params.agg_overhead)
            latency[swarm_mask] += sw_lat
            b = cm.swarm_bytes(plen[swarm_mask].astype(float),
                               float(self.max_new * n_up),
                               self.cost_params)
            cost[swarm_mask] += cm.cost_swarm(
                (plen[swarm_mask] + self.max_new).astype(float) * n_up,
                b, self.cost_params)
            answers[swarm_mask] = sw["winner_tokens"]

        # --- phase B: consensus gate -> escalate (Alg. 1 l.15-23) ---
        cons_arr = np.where(np.isnan(consensus), 1.0, consensus)
        phase_b = router_lib.post_consensus(
            torch.as_tensor(decision), _f32(cons_arr),
            cfg=self.router_cfg, budget=self.budget, wan_ok=cloud_ok,
            est_cloud_cost=_f32(est_cost))
        # a copy: the degraded-summon path rewrites decisions in place
        decision = phase_b.decision.numpy().copy()
        self.budget = phase_b.budget

        # --- cloud execution (Tier 2): retrying summon ---
        # bounded attempts with a per-attempt deadline and jittered
        # exponential backoff (faults.RetryPolicy).  The first attempt IS
        # the old single call — with no injected fault nothing below adds
        # latency, cost or rng draws.  Exhausted retries trip the circuit
        # breaker and degrade the batch: cloud -> swarm (queries that went
        # through a round keep their consensus winner) -> local (probe
        # answer); risk queries that *required* the cloud are refused,
        # mirroring the router's O5 outage chain.
        cloud_mask = (decision == CLOUD) | (decision == CLOUD_SAFETY)
        if cloud_mask.any() and self.cloud is not None:
            cl = None
            attempts = 0
            backoff_total = 0.0
            while True:
                attempts += 1
                fc["cloud_attempts"] += 1
                try:
                    if self.faults is None:
                        cl = self.cloud.generate(prompts[cloud_mask],
                                                 self.max_new, seed=seed)
                    else:
                        cl, _ = self.faults.call(
                            "cloud",
                            lambda: self.cloud.generate(
                                prompts[cloud_mask], self.max_new,
                                seed=seed))
                    break
                except CloudUnavailableError:
                    fc["cloud_failures"] += 1
                    if attempts >= self.retry.max_attempts:
                        break
                    fc["cloud_retries"] += 1
                    backoff_total += self.retry.backoff(
                        attempts - 1,
                        self.faults.rng if self.faults is not None else None)
            failed = attempts - (1 if cl is not None else 0)
            if failed:
                # realized retry time: every failed attempt burns its
                # deadline, plus the backoff sleeps between attempts —
                # and each failed summon still shipped the prompt
                # (Eq. 7 prompt-token cost, charged against the budget)
                extra = float(cm.latency_retries(
                    float(failed), self.retry.timeout_s, backoff_total))
                latency[cloud_mask] += extra
                retry_cost = failed * cm.cost_cloud(
                    _f32(plen[cloud_mask]), 0.0, self.cost_params).numpy()
                cost[cloud_mask] += retry_cost
                self.budget = self.budget._replace(
                    used=self.budget.used + float(retry_cost.sum()))
            if cl is not None:
                self.breaker.record_success()
                answers[cloud_mask] = truncate_at_stop(cl["tokens"], stop)
                latency[cloud_mask] += self.sim.cloud_latency(
                    plen[cloud_mask] + self.max_new)
                cost[cloud_mask] += est_cost[cloud_mask]
                # distillation feedback loop (Sec. IV-H)
                for qi in np.where(cloud_mask)[0]:
                    self.distill_buffer.log(queries[qi]["prompt"],
                                            answers[qi].tolist(),
                                            meta={"u": float(u[qi])})
            else:
                fc["cloud_exhausted"] += 1
                self.breaker.record_failure(self._tick)
                # refund the completion cost the batch never incurred
                self.budget = self.budget._replace(
                    used=(self.budget.used
                          - float(est_cost[cloud_mask].sum())).clamp_min(0.0))
                # graceful degradation: answers[] still holds each query's
                # best pre-cloud candidate (swarm winner for escalations,
                # probe answer otherwise) — reroute instead of failing
                had_swarm = ~np.isnan(consensus)
                was_safety = decision == CLOUD_SAFETY
                to_swarm = cloud_mask & had_swarm & ~was_safety
                to_local = cloud_mask & ~had_swarm & ~was_safety
                to_refuse = cloud_mask & was_safety
                decision[to_swarm] = SWARM
                decision[to_local] = LOCAL
                decision[to_refuse] = REFUSE
                answered[to_refuse] = False
                fc["degraded_to_swarm"] += int(to_swarm.sum())
                fc["degraded_to_local"] += int(to_local.sum())
                fc["degraded_refused"] += int(to_refuse.sum())

        # --- refusals ---
        refuse_mask = decision == REFUSE
        answers[refuse_mask] = REFUSAL

        fc["breaker_opened"] = self.breaker.opened_count - brk0
        eng1 = self._member_counters()
        for k in _ENGINE_FAULT_KEYS:
            fc[k] = eng1[k] - eng0[k]
        correct = np.array([is_correct(answers[i], queries[i].get("gold"))
                            for i in range(B)])
        return GatewayLog(
            decision=decision, u=u, safety=s, latency=latency, cost=cost,
            prompt_len=plen,
            category=[q.get("category", "easy") for q in queries],
            correct=correct, answers=answers, consensus=consensus,
            faults=fc, answered=answered)

    def _member_counters(self) -> dict:
        """Sum of the swarm engines' failure counters (delta-tracked per
        batch so GatewayLog.faults reports this batch's events only)."""
        tot = dict.fromkeys(_ENGINE_FAULT_KEYS, 0)
        for m in self.swarm.members:
            for k in _ENGINE_FAULT_KEYS:
                tot[k] += m.counters.get(k, 0)
        return tot


# ---------------------------------------------------------------------------
# Baseline architectures (Sec. VI-B)
# ---------------------------------------------------------------------------

def run_edge_only(queries, engine: InferenceEngine, sim: NetworkSimulator,
                  max_new: int = 8, seed: int = 0,
                  stop_token: int | None = None) -> GatewayLog:
    """Edge-only baseline (Table III/IV row 1).

    ``stop_token`` must be the same stop token the gateway's swarm uses so
    the baseline is graded on *identically normalised* answers: the gateway
    truncates every answer at the first stop token before clustering and
    grading, and a baseline graded on raw tokens would count (or miss) gold
    entities in the post-answer continuation — a different metric, not a
    different architecture.
    """
    prompts = pad_prompts([q["prompt"] for q in queries])
    plen = (prompts != 0).sum(axis=1)
    res = engine.generate(prompts, max_new, seed=seed)
    answers = truncate_at_stop(res["tokens"], stop_token)
    lat = sim.edge_latency(plen + max_new)
    correct = np.array([is_correct(answers[i], q.get("gold"))
                        for i, q in enumerate(queries)])
    B = len(queries)
    return GatewayLog(
        decision=np.full((B,), LOCAL), u=res["u"],
        safety=np.zeros((B,)), latency=lat, cost=np.zeros((B,)),
        prompt_len=plen, category=[q.get("category", "easy") for q in queries],
        correct=correct, answers=answers,
        consensus=np.full((B,), np.nan))


def run_cloud_only(queries, cloud: InferenceEngine, sim: NetworkSimulator,
                   cost_params: cm.CostParams | None = None,
                   max_new: int = 8, seed: int = 0,
                   stop_token: int | None = None) -> GatewayLog:
    """Cloud-only baseline — answers normalised exactly like the gateway's
    (see ``run_edge_only`` on why grading raw tokens would skew Table IV)."""
    cost_params = cost_params or cm.CostParams()
    prompts = pad_prompts([q["prompt"] for q in queries])
    plen = (prompts != 0).sum(axis=1)
    res = cloud.generate(prompts, max_new, seed=seed)
    answers = truncate_at_stop(res["tokens"], stop_token)
    lat = sim.cloud_latency(plen + max_new)
    cost = cm.cost_cloud(_f32(plen), float(max_new), cost_params).numpy()
    correct = np.array([is_correct(answers[i], q.get("gold"))
                        for i, q in enumerate(queries)])
    B = len(queries)
    return GatewayLog(
        decision=np.full((B,), CLOUD), u=res["u"],
        safety=np.zeros((B,)), latency=lat, cost=cost,
        prompt_len=plen, category=[q.get("category", "easy") for q in queries],
        correct=correct, answers=answers,
        consensus=np.full((B,), np.nan))
