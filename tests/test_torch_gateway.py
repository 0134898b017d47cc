"""The port's gateway (Algorithm 1, ``Gateway.answer_batch``) against the
JAX package's on the study workload, and the port's swarm round.

Setup: the four tiers at their smoke widths in f32 (vocabulary 512, the
cloud tier at the 4 layers the reference's gateway gives it) and the safety
classifier, with weights from the JAX ``init_params`` / ``init_safety``
converted by ``convert.from_jax_params``.  Two gains are set on both sides
before converting, because on the bare init weights routing is degenerate:
the probe's u spans 1e-4 (near-uniform softmax over 512 tokens) and s spans
9e-3, so no threshold could sit 1e-3 from every value.  Every tier's
``final_norm`` is set to 5 (an RMSNorm gain of 6: peaked logits, u spread
over ~0.07 with gaps of several 1e-3), and the classifier's embedding is
scaled by 30 (the pooled embedding then outweighs the attention and MLP
terms, and s spreads over ~0.05; the error of s, which comes from those
terms, does not grow).  tau_low, tau_high and sigma sit at the midpoints of
the widest gaps of the JAX u and s inside quantile windows, and the test
asserts that no value lies within 1e-3 of a threshold, so the f32 decisions
compare exactly.

Budgets (f32): u 1e-4, s 1e-5 (the JAX encoder rounds its attention to
bf16, tests/test_torch_safety.py), latency and cost 1e-6 relative (the
simulator draws the same numbers), consensus 1e-6; decisions, answers and
fault counters equal.  The bf16 variant compares tie-aware.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_engine import assert_greedy_match_modulo_ties

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as C  # noqa: E402
from repro.core import budget as JB  # noqa: E402
from repro.core import safety as JS  # noqa: E402
from repro.core.cost_model import LatencyParams as JLP  # noqa: E402
from repro.core.router import RouterConfig as JRC  # noqa: E402
from repro.core.uncertainty import UncertaintyConfig as JU  # noqa: E402
from repro.data.workload import FACT_IS, FactWorld  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import faults as JF  # noqa: E402
from repro.serving import gateway as JG  # noqa: E402
from repro.serving.engine import InferenceEngine as JE  # noqa: E402
from repro.serving.simulator import NetworkSimulator as JNS  # noqa: E402
from repro.serving.simulator import SimConfig as JSC  # noqa: E402
from repro.serving.swarm import SwarmExecutor as JSX  # noqa: E402
from repro.serving.swarm import pad_prompts  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import budget as TB  # noqa: E402
from repro_torch.core import safety as TS  # noqa: E402
from repro_torch.core.cost_model import LatencyParams as TLP  # noqa: E402
from repro_torch.core.router import (CLOUD, CLOUD_SAFETY, LOCAL,  # noqa: E402
                                     REFUSE, SWARM)
from repro_torch.core.router import RouterConfig as TRC  # noqa: E402
from repro_torch.launch.serve import \
    gateway_from_weights as build_gateway  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import faults as TF  # noqa: E402
from repro_torch.serving import gateway as TG  # noqa: E402
from repro_torch.serving.simulator import NetworkSimulator as TNS  # noqa: E402
from repro_torch.serving.simulator import SimConfig as TSC  # noqa: E402
from repro_torch.serving.swarm import SwarmExecutor as TSX  # noqa: E402

TIERS = {"probe": ("smollm-135m", None), "edge_1b": ("swarm-edge-1b", None),
         "edge_qwen": ("qwen1.5-110b", None), "cloud": ("llama3-8b", 4)}
NAMES = {"probe": "probe-smollm", "edge_1b": "edge-1b",
         "edge_qwen": "edge-qwen", "cloud": "cloud-fm"}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MARGIN = 1e-3
WORLD = FactWorld(n_ent=16, n_rel=6)
QUERIES = WORLD.study_workload()


def _gap_mid(x, lo, hi):
    """Midpoint of the widest gap between sorted values lo..hi, and its
    half-width (the distance to the nearest value)."""
    xs = np.sort(np.asarray(x, np.float64))
    g = np.diff(xs)
    i = lo + int(np.argmax(g[lo:hi]))
    return float((xs[i] + xs[i + 1]) / 2), float(g[i] / 2)


def _build(dtype: str):
    jd, td = DT[dtype]
    jt, tt = {}, {}
    for i, (k, (arch, layers)) in enumerate(TIERS.items()):
        over = dict(vocab_size=512, **({"num_layers": layers}
                                       if layers else {}))
        jc = dataclasses.replace(C.get_smoke(arch), dtype=jd,
                                 attn_prefill_impl="flash", **over)
        tc = dataclasses.replace(TC.get_smoke(arch), dtype=td, **over)
        p = dict(jax.jit(JT.init_params, static_argnums=0)(
            jc, jax.random.PRNGKey(i)))
        p["final_norm"] = jnp.full_like(p["final_norm"], 5.0)
        jt[k] = (jc, p)
        tt[k] = (tc, from_jax_params(jax.tree.map(np.asarray, p), tc))
    jsc = dataclasses.replace(JS.classifier_config(vocab_size=512), dtype=jd)
    tsc = dataclasses.replace(TS.classifier_config(vocab_size=512), dtype=td)
    sp = dict(JS.init_safety(jsc, jax.random.PRNGKey(5)))
    sp["embed"] = (sp["embed"].astype(jnp.float32) * 30).astype(jd)
    ucfg = JU(alpha=1.0, mode="distribution")
    eng = {k: JE(NAMES[k], *jt[k], ucfg) for k in jt}
    # thresholds from the JAX probe's u and classifier's s on the workload
    s = np.asarray(JS.safety_score(sp, jsc, jnp.asarray(pad_prompts(
        [q["prompt"] for q in QUERIES], align="right"))))
    u = eng["probe"].generate(pad_prompts([q["prompt"] for q in QUERIES]),
                              8)["u"]
    tau_low, m_low = _gap_mid(u, 10, 30)
    tau_high, m_high = _gap_mid(u, 32, 47)
    sigma, m_s = _gap_mid(s, 15, 35)
    rcfg = JRC(tau_low=tau_low, tau_high=tau_high, sigma=sigma, peers_k=2,
               gamma=0.3, l_max=4.0)
    jgw = JG.Gateway(
        probe=eng["probe"],
        swarm=JSX([eng["probe"], eng["edge_1b"], eng["edge_qwen"]],
                  stop_token=FACT_IS),
        cloud=eng["cloud"], safety_params=sp, safety_cfg=jsc,
        router_cfg=rcfg, sim=JNS(JSC(), JLP(), 3), budget_total=1.0)
    tgw, tprobe, tcloud, _ = build_gateway(
        **tt, safety=(tsc, from_jax_params(jax.tree.map(np.asarray, sp),
                                           tsc)),
        router_cfg=TRC(**dataclasses.asdict(rcfg)), device="cpu")
    return {"jax": jgw, "port": tgw, "margins": (m_low, m_high, m_s),
            "engines": (eng["probe"], eng["cloud"], tprobe, tcloud)}


@pytest.fixture(scope="module")
def f32():
    return _build("float32")


def _run_both(sys_, queries=QUERIES, sim=None, budget=None, faults=None):
    """One batch through both gateways from the same fresh state: budget,
    breaker, health and simulator rewound; optional simulator config,
    budget total and fault plan (built fresh on each side)."""
    out = []
    for gw, Sim, SC, LP, Budget, F in (
            (sys_["jax"], JNS, JSC, JLP, JB, JF),
            (sys_["port"], TNS, TSC, TLP, TB, TF)):
        gw.sim = Sim(SC(**(sim or {})), LP(), n_members=3)
        gw.faults = None if faults is None else F.FaultPlan(
            [F.FaultEvent(*e) for e in faults], seed=1)
        gw.swarm.faults = gw.faults
        gw.reset_fault_state()
        if budget is not None:
            gw.budget = Budget.init_budget(budget)
        out.append(gw.answer_batch(queries))
        gw.faults = gw.swarm.faults = None
    return out


def _assert_logs_equal(j, t, u_tol=1e-4, s_tol=1e-5):
    np.testing.assert_array_equal(t.decision, j.decision)
    np.testing.assert_allclose(t.u, j.u, rtol=0, atol=u_tol)
    np.testing.assert_allclose(t.safety, j.safety, rtol=0, atol=s_tol)
    np.testing.assert_allclose(t.latency, j.latency, rtol=1e-6)
    np.testing.assert_allclose(t.cost, j.cost, rtol=1e-6, atol=1e-15)
    np.testing.assert_array_equal(np.isnan(t.consensus), np.isnan(j.consensus))
    np.testing.assert_allclose(t.consensus, j.consensus, rtol=1e-6)
    np.testing.assert_array_equal(t.answers, j.answers)
    np.testing.assert_array_equal(t.correct, j.correct)
    np.testing.assert_array_equal(t.prompt_len, j.prompt_len)
    assert t.category == j.category
    assert t.faults == j.faults
    np.testing.assert_array_equal(t.answered, j.answered)
    assert t.availability() == j.availability()
    assert t.cloud_usage() == j.cloud_usage()
    for cat in (None, "easy", "hard"):
        np.testing.assert_equal(t.accuracy(cat), j.accuracy(cat))
    for a, b in zip(t.privacy(), j.privacy()):
        assert float(a) == pytest.approx(float(b), rel=1e-6)


def test_thresholds_are_clear_of_every_value(f32):
    assert min(f32["margins"]) > MARGIN, f32["margins"]


def test_answer_batch_matches_jax(f32):
    j, t = _run_both(f32)
    _assert_logs_equal(j, t)
    dec = set(t.decision.tolist())
    assert {LOCAL, SWARM} <= dec and dec & {CLOUD, CLOUD_SAFETY}
    assert np.isin(t.decision, (LOCAL, SWARM, CLOUD, CLOUD_SAFETY,
                                REFUSE)).all()
    assert ((t.u >= 0) & (t.u <= 1)).all() and np.isfinite(t.safety).all()
    assert len(f32["port"].distill_buffer.items) == \
        len(f32["jax"].distill_buffer.items)


def test_wan_outage_batch_matches_jax(f32):
    """O5: with the WAN down, risk queries are refused and non-risk cloud
    aspirants fall back to the swarm; nothing reaches the cloud."""
    j, t = _run_both(f32, sim=dict(wan_outage_p=1.0, wan_recover_p=0.0))
    _assert_logs_equal(j, t)
    assert (t.decision == REFUSE).any()
    assert not np.isin(t.decision, (CLOUD, CLOUD_SAFETY)).any()
    assert t.availability() < 1.0 or not (~t.answered).any()


def test_budget_capped_batch_matches_jax(f32):
    j, t = _run_both(f32, budget=0.0)
    _assert_logs_equal(j, t)
    assert not np.isin(t.decision, (CLOUD, CLOUD_SAFETY)).any()


def test_faulted_batch_matches_jax(f32):
    """Every cloud attempt times out (retries, breaker, the O5 degradation
    chain) and member 1 crashes (casualty salvage): the same counters,
    latencies and degraded decisions on both sides."""
    j, t = _run_both(f32, faults=[("cloud", "timeout", None, 3, 8.0),
                                  ("member:1", "crash", None, 1, 0.0)])
    _assert_logs_equal(j, t)
    f = t.faults
    assert f["cloud_exhausted"] == 1 and f["cloud_retries"] == 2
    assert f["breaker_opened"] == 1 and f["member_casualties"] == 1
    assert f["degraded_refused"] + f["degraded_to_swarm"] \
        + f["degraded_to_local"] > 0


def test_baselines_match_jax(f32):
    jprobe, jcloud, tprobe, tcloud = f32["engines"]
    for run, je, te, kw in (
            ((JG.run_edge_only, TG.run_edge_only), jprobe, tprobe, {}),
            ((JG.run_cloud_only, TG.run_cloud_only), jcloud, tcloud, {})):
        logs = [fn(QUERIES, eng, sim(sc(), lp(), 3), stop_token=FACT_IS)
                for fn, eng, sim, sc, lp in (
                    (run[0], je, JNS, JSC, JLP), (run[1], te, TNS, TSC, TLP))]
        _assert_logs_equal(*logs)


def test_swarm_round_issues_zero_probe_prefill(f32):
    """One answer_batch prefills the probe exactly once, even with every
    non-risk query forced into the swarm round: the round reuses the
    probe's tokens, u and state (tests/test_gateway_integration.py)."""
    gw = f32["port"]
    probe = gw.probe
    old = gw.router_cfg
    gw.router_cfg = dataclasses.replace(old, tau_low=-1.0, tau_high=2.0)
    try:
        gw.reset_fault_state()
        before = dict(probe.counters)
        log = gw.answer_batch(QUERIES[:30])
    finally:
        gw.router_cfg = old
    # every query the safety gate passes goes to the swarm round
    assert (log.decision == SWARM).sum() >= 10
    assert probe.counters["prefill"] == before["prefill"] + 1
    assert probe.counters["decode_only"] == before["decode_only"]


def test_build_gateway_puts_the_classifier_with_the_engines():
    """The safety gate scores on the classifier's device, so
    ``build_gateway`` moves the classifier to the engines' device (here
    ``meta``, which no caller builds on) instead of leaving it where the
    caller made it."""
    tiers = {}
    for i, (k, (arch, layers)) in enumerate(TIERS.items()):
        tc = dataclasses.replace(TC.get_smoke(arch), dtype=torch.float32,
                                 vocab_size=512,
                                 **({"num_layers": layers} if layers else {}))
        tiers[k] = (tc, TT.init_params(tc, torch.Generator().manual_seed(i)))
    tsc = dataclasses.replace(TS.classifier_config(vocab_size=512),
                              dtype=torch.float32)
    sp = TS.init_safety(tsc, torch.Generator().manual_seed(5), device="cpu")
    gw, probe, cloud, _ = build_gateway(
        **tiers, safety=(tsc, sp), device="meta",
        router_cfg=TRC(tau_low=0.1, tau_high=0.2, sigma=0.5))
    assert probe.device.type == cloud.device.type == "meta"
    assert {p.device.type for p in gw.safety_params.parameters()} == {"meta"}


def test_deepened_swarm_round_matches_jax(f32):
    """A round longer than the probe's precomputed answer extends the
    probe decode-only from the selected state (no prefill) and re-scores u
    over the whole answer span (``_deepened_u``), as the reference does."""
    prompts = pad_prompts([q["prompt"] for q in QUERIES[:12]])
    idx = np.arange(0, 12, 2)
    outs = []
    for gw in (f32["jax"], f32["port"]):
        probe = gw.probe
        res = probe.generate(prompts, 4, return_state=True)
        u_ans = gw.swarm.member_u(probe, res)
        pre = {0: (res["tokens"][idx], u_ans[idx],
                   (res["h_mean"][idx], res["v_mean"][idx]))}
        states = {0: probe.state_select(res["state"], idx)}
        before = dict(probe.counters)
        out = gw.swarm.collaborate(prompts[idx], 8, precomputed=pre,
                                   states=states)
        assert probe.counters["prefill"] == before["prefill"]
        assert probe.counters["decode_only"] == before["decode_only"] + 1
        outs.append(out)
    j, t = outs
    np.testing.assert_array_equal(t["answers"], j["answers"])
    np.testing.assert_allclose(t["u"], j["u"], atol=1e-4)
    np.testing.assert_array_equal(t["winner_member"], j["winner_member"])
    np.testing.assert_allclose(t["consensus_score"], j["consensus_score"],
                               rtol=1e-5)


def test_streaming_round_equals_batched(f32):
    """``streaming=True`` feeds the round through each member's serve():
    the same answers and u as the batched round."""
    gw = f32["port"]
    prompts = pad_prompts([q["prompt"] for q in QUERIES[:10]])
    batched = gw.swarm.collaborate(prompts, 8)
    stream = TSX(gw.swarm.members, stop_token=FACT_IS, streaming=True,
                 serve_slots=4).collaborate(prompts, 8)
    np.testing.assert_array_equal(stream["answers"], batched["answers"])
    np.testing.assert_allclose(stream["u"], batched["u"], atol=1e-5)
    np.testing.assert_array_equal(stream["winner_member"],
                                  batched["winner_member"])


def test_bf16_gateway_tie_aware():
    """In bf16 the two packages round at other sites: the probe's answers
    agree tie-aware, and u (on rows whose tokens agree) and s within 2e-3
    (tests/test_torch_engine.py holds bf16 u to 1e-3 + 1e-3 relative); every
    query whose u and s lie farther than that from the thresholds is routed
    alike.  The logits are ~6 here (the gain of 6): their budget is two bf16
    ulps at that size, 0.0625 (the reference's 0.01 on logits of ~1,
    scaled)."""
    sys_ = _build("bfloat16")
    j, t = _run_both(sys_, queries=QUERIES[:24])
    jprobe, _, tprobe, _ = sys_["engines"]
    prompts = pad_prompts([q["prompt"] for q in QUERIES[:24]])
    jr, tr = jprobe.generate(prompts, 8), tprobe.generate(prompts, 8)
    assert_greedy_match_modulo_ties(
        {**tr, "logits": tr["logits"].float().numpy()},
        {**jr, "logits": np.asarray(jr["logits"], np.float32)},
        atol=0.0625)
    tol = 2e-3
    np.testing.assert_allclose(t.safety, j.safety, atol=tol)
    same = (tr["tokens"] == jr["tokens"]).all(axis=1)
    np.testing.assert_allclose(t.u[same], j.u[same], atol=tol)
    rc = sys_["port"].router_cfg
    clear = (same & (np.abs(j.safety - rc.sigma) > tol)
             & (np.abs(j.u - rc.tau_low) > tol)
             & (np.abs(j.u - rc.tau_high) > tol))
    assert clear.sum() >= 12
    np.testing.assert_array_equal(t.decision[clear], j.decision[clear])
