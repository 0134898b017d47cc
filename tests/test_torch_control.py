"""The port's control plane against the JAX package on the same arrays:
Eq. 14 consensus, the Eq. 7-9 cost and latency model (quorum included),
Eq. 15-17 privacy, Phase B (``post_consensus``) and the budget window, the
network simulator (identical numpy draws), the fault primitives
(``RetryPolicy``, ``CircuitBreaker``, ``HealthRegistry``, ``FaultPlan``),
the study workload and the distillation buffer.

Float results agree to f32 rounding (1e-6 relative); decisions, clusters,
representatives, draws and counters agree exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import budget as JB  # noqa: E402
from repro.core import consensus as JC  # noqa: E402
from repro.core import cost_model as JCM  # noqa: E402
from repro.core import privacy as JP  # noqa: E402
from repro.core import router as JR  # noqa: E402
from repro.core.distill import DistillBuffer as JDB  # noqa: E402
from repro.data import workload as JW  # noqa: E402
from repro.serving import faults as JF  # noqa: E402
from repro.serving import simulator as JS  # noqa: E402
from repro_torch.core import budget as TB  # noqa: E402
from repro_torch.core import consensus as TCO  # noqa: E402
from repro_torch.core import cost_model as TCM  # noqa: E402
from repro_torch.core import privacy as TP  # noqa: E402
from repro_torch.core import router as TR  # noqa: E402
from repro_torch.core.distill import DistillBuffer as TDB  # noqa: E402
from repro_torch.data import workload as TW  # noqa: E402
from repro_torch.serving import faults as TF  # noqa: E402
from repro_torch.serving import simulator as TS  # noqa: E402


def _answers(seed: int, B: int = 24, n: int = 4, N: int = 5):
    """Answers drawn from a tiny alphabet so that clusters, ties and whole
    PAD rows (an unavailable member) all occur."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 3, (3, N)).astype(np.int32)
    pool[2, 3:] = JC.PAD                                     # a short answer
    a = pool[rng.integers(0, 3, (B, n))]
    a[rng.random((B, n)) < 0.2] = JC.PAD                     # member down
    u = rng.random((B, n)).astype(np.float32)
    u[rng.random((B, n)) < 0.2] = 1.0                        # w_min floor
    u[0] = 0.5                                               # equal weights
    return a, u


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("w_min", [0.05, 0.3])
def test_consensus_matches_jax(seed, w_min):
    a, u = _answers(seed)
    j = JC.batched_consensus(jnp.asarray(a), jnp.asarray(u), w_min=w_min)
    t = TCO.batched_consensus(torch.from_numpy(a), torch.from_numpy(u),
                              w_min=w_min)
    for f in ("rep_index", "cluster_id"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("best_score", "scores", "weights"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-6,
                                   err_msg=f)
    for gamma in (0.3, 0.6):
        np.testing.assert_array_equal(
            TCO.consensus_decision(t, gamma).numpy(),
            np.asarray(JC.consensus_decision(j, gamma)))
    one_j = JC.weighted_consensus(jnp.asarray(a[3]), jnp.asarray(u[3]), w_min)
    one_t = TCO.weighted_consensus(torch.from_numpy(a[3]),
                                   torch.from_numpy(u[3]), w_min)
    assert int(one_t.rep_index) == int(one_j.rep_index)
    assert float(one_t.best_score) == pytest.approx(float(one_j.best_score))


def test_consensus_ties_and_all_pad():
    """Equal-score clusters: the longest answer of the best cluster wins,
    the first on a tie; a round where every member is down is one PAD
    cluster of score 1."""
    a = np.array([[[1, 2, -1], [3, -1, -1], [1, 2, -1], [3, -1, -1]],
                  [[-1, -1, -1]] * 4,
                  [[5, 6, 7], [5, 6, 8], [5, 6, 9], [5, 6, 7]]], np.int32)
    u = np.full((3, 4), 0.5, np.float32)
    for pkg, arr in ((JC, jnp.asarray), (TCO, torch.from_numpy)):
        r = pkg.batched_consensus(arr(a), arr(u))
        assert np.asarray(r.rep_index).tolist() == [0, 0, 0]
        np.testing.assert_allclose(np.asarray(r.best_score), [0.5, 1.0, 0.5])
    assert TCO.PAD == JC.PAD == -1


@pytest.mark.parametrize("quorum", [None, 1, 2, 3, 5])
def test_cost_and_latency_match_jax(quorum):
    rng = np.random.default_rng(7)
    edge = rng.random((20, 3)) + 0.5
    comm = rng.random((20, 3)) * 0.2
    lp = JCM.LatencyParams(agg_overhead=0.01)
    tp = TCM.LatencyParams(**dataclasses.asdict(lp))
    j = JCM.latency_swarm(jnp.asarray(edge), jnp.asarray(comm), lp,
                          quorum=quorum)
    t = TCM.latency_swarm(torch.tensor(edge, dtype=torch.float32),
                          torch.tensor(comm, dtype=torch.float32), tp,
                          quorum=quorum)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    cp = JCM.CostParams()
    tcp = TCM.CostParams(**dataclasses.asdict(cp))
    plen = rng.integers(3, 9, 20).astype(np.float32)
    np.testing.assert_allclose(
        TCM.cost_cloud(torch.from_numpy(plen), 8.0, tcp).numpy(),
        np.asarray(JCM.cost_cloud(jnp.asarray(plen), 8.0, cp)), rtol=1e-6)
    b = TCM.swarm_bytes(plen.astype(float), 24.0, tcp)
    np.testing.assert_allclose(b, JCM.swarm_bytes(plen.astype(float), 24.0,
                                                  cp))
    np.testing.assert_allclose(TCM.cost_swarm(plen * 3.0, b, tcp),
                               JCM.cost_swarm(plen * 3.0, b, cp))
    for f, args in ((TCM.latency_edge, (plen, tp)),
                    (TCM.latency_cloud, (plen, 1.5, tp))):
        jf = getattr(JCM, f.__name__)
        jargs = tuple(lp if a is tp else a for a in args)
        np.testing.assert_allclose(f(*args), np.asarray(jf(*jargs)),
                                   rtol=1e-6)
    assert TCM.latency_retries(2.0, 8.0, 0.7) == pytest.approx(
        float(JCM.latency_retries(2.0, 8.0, 0.7)))


def test_privacy_matches_jax():
    rng = np.random.default_rng(3)
    dec = rng.integers(0, 5, 40).astype(np.int32)
    plen = rng.integers(3, 9, 40).astype(np.int32)
    saf = rng.random(40) < 0.25
    j = JP.privacy_metrics(jnp.asarray(dec), jnp.asarray(plen),
                           jnp.asarray(saf))
    t = TP.privacy_metrics(torch.from_numpy(dec), torch.from_numpy(plen),
                           torch.from_numpy(saf))
    for a, b in zip(t, j):
        assert float(a) == pytest.approx(float(b), rel=1e-6)
    assert TP.reductions(t) == pytest.approx(JP.reductions(j), rel=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_post_consensus_and_window_match_jax(seed):
    rng = np.random.default_rng(seed)
    B = 32
    dec = rng.integers(0, 5, B).astype(np.int32)
    cons = rng.random(B).astype(np.float32)
    cost = (rng.random(B) * 0.1).astype(np.float32)
    for wan in (True, False, rng.random(B) > 0.3):
        rcfg = JR.RouterConfig.final()
        j = JR.post_consensus(jnp.asarray(dec), jnp.asarray(cons), cfg=rcfg,
                              budget=JB.init_budget(0.4), wan_ok=wan,
                              est_cloud_cost=jnp.asarray(cost))
        t = TR.post_consensus(torch.from_numpy(dec), torch.from_numpy(cons),
                              cfg=TR.RouterConfig(**dataclasses.asdict(rcfg)),
                              budget=TB.init_budget(0.4),
                              wan_ok=torch.as_tensor(wan),
                              est_cloud_cost=torch.from_numpy(cost))
        np.testing.assert_array_equal(t.decision.numpy(),
                                      np.asarray(j.decision))
        np.testing.assert_array_equal(t.use_swarm_answer.numpy(),
                                      np.asarray(j.use_swarm_answer))
        assert float(t.budget.used) == pytest.approx(float(j.budget.used),
                                                     rel=1e-6)
    jb = JB.init_budget(1.0, window_id=3)._replace(used=jnp.float32(0.4))
    tb = TB.init_budget(1.0, window_id=3)._replace(used=torch.tensor(0.4))
    for w in (3, 4):
        jr = JB.roll_window(jb, jnp.int32(w))
        tr = TB.roll_window(tb, w)
        assert float(tr.used) == pytest.approx(float(jr.used))
        assert int(tr.window_id) == int(jr.window_id)


def test_simulator_draws_identically():
    cfg = dict(seed=4, wan_outage_p=0.3, wan_recover_p=0.5, node_fail_p=0.2,
               node_recover_p=0.5, straggler_p=0.3)
    js = JS.NetworkSimulator(JS.SimConfig(**cfg), JCM.LatencyParams(), 3)
    ts = TS.NetworkSimulator(TS.SimConfig(**cfg), TCM.LatencyParams(), 3)
    for step in range(6):
        js.tick()
        ts.tick()
        assert js.wan_up == ts.wan_up
        np.testing.assert_array_equal(js.member_up, ts.member_up)
        toks = np.arange(5) + step
        for f, args in (("edge_latency", (toks,)), ("cloud_latency", (toks,)),
                        ("peer_comm", (4, 3)), ("wan_rtt", (2,))):
            np.testing.assert_array_equal(getattr(ts, f)(*args),
                                          getattr(js, f)(*args), err_msg=f)
    js.reset()
    ts.reset()
    np.testing.assert_array_equal(ts.edge_latency(np.arange(4)),
                                  js.edge_latency(np.arange(4)))
    assert TS.SimConfig().mean_ticks_to_recover("wan") == \
        JS.SimConfig().mean_ticks_to_recover("wan")


def test_fault_primitives_match_jax():
    jr, tr = JF.RetryPolicy(), TF.RetryPolicy()
    jrng, trng = np.random.RandomState(1), np.random.RandomState(1)
    assert [tr.backoff(a, trng) for a in range(4)] == \
        [jr.backoff(a, jrng) for a in range(4)]
    assert tr.backoff(2) == jr.backoff(2)
    jb, tb = JF.CircuitBreaker(2, 2), TF.CircuitBreaker(2, 2)
    script = ["f", "f", "a", "a", "a", "s", "f", "f", "a", "a", "f"]
    for tick, op in enumerate(script):
        for b in (jb, tb):
            if op == "f":
                b.record_failure(tick)
            elif op == "s":
                b.record_success()
        if op == "a":
            assert tb.allow(tick) == jb.allow(tick)
        assert (tb.state, tb.opened_count) == (jb.state, jb.opened_count)
    jh, th = JF.HealthRegistry(3), TF.HealthRegistry(3)
    for tick in range(8):
        for h in (jh, th):
            h.tick()
            h.record_failure(tick % 3)
            if tick % 4 == 0:
                h.record_success((tick + 1) % 3, 0.1 * tick)
        np.testing.assert_array_equal(th.available(), jh.available())
        np.testing.assert_array_equal(th.ewma, jh.ewma)
    ev = [("cloud", "timeout", 1, 2, 8.0), ("member:1", "crash", None, 1, 0),
          ("member:2", "straggle", 2, 1, 1.5)]
    plans = [mod.FaultPlan([mod.FaultEvent(*e) for e in ev], seed=3)
             for mod in (JF, TF)]
    for tick in range(3):
        outs = []
        for mod, plan in zip((JF, TF), plans):
            plan.tick()
            got = []
            for site in ("cloud", "member:1", "member:2"):
                try:
                    got.append(plan.call(site, lambda: "ok"))
                except mod.ServingFault as e:
                    got.append((type(e).__name__, e.delay_s))
            outs.append((got, dict(plan.counters)))
        assert outs[0] == outs[1]
    rj = JF.FaultPlan.random(7, 3, 5, p_famine=0.2)
    rt = TF.FaultPlan.random(7, 3, 5, p_famine=0.2)
    assert [dataclasses.astuple(e) for e in rt.events] == \
        [dataclasses.astuple(e) for e in rj.events]


def test_workload_and_distill_buffer_match_jax():
    jw, tw = JW.FactWorld(n_ent=16, n_rel=6), TW.FactWorld(n_ent=16, n_rel=6)
    assert tw.study_workload() == jw.study_workload()
    np.testing.assert_array_equal(tw.safety_training_batch(8, 6, 3)[0],
                                  jw.safety_training_batch(8, 6, 3)[0])
    for k, v in tw.training_batch(2, 32, 1, two_hop=True).items():
        np.testing.assert_array_equal(
            v, jw.training_batch(2, 32, 1, two_hop=True)[k])
    assert (TW.PAD, TW.FACT_IS, TW.REFUSAL, TW.VOCAB) == \
        (JW.PAD, JW.FACT_IS, JW.REFUSAL, JW.VOCAB)
    assert TW.is_correct([5, 230, 7], 230) and not TW.is_correct([1], None)
    jb, tb = JDB(capacity=3), TDB(capacity=3)
    for i in range(5):
        for b in (jb, tb):
            b.log([i], [i + 1], meta={"u": 0.1 * i},
                  scrub=lambda q, t: (q, t[:1]))
    assert tb.items == jb.items
    assert tb.sample(np.random.RandomState(0), 2) == \
        jb.sample(np.random.RandomState(0), 2)
