"""The port's failure domain in ``serve()`` and the swarm round against the
JAX engine's (``tests/test_faults.py``), and ``core/policy.py``.

Each scenario runs the same requests and the same ``FaultPlan`` through
the JAX ``InferenceEngine.serve`` and the port's, on the f32 smoke
``smollm-135m`` (vocabulary 512) with converted weights and the JAX flash
prefill, where the two engines compute the same math (logits to 1e-4,
``test_torch_engine.py::test_f32_generate_is_tight``): tokens compare
exactly, ``u`` to 1e-4, and the ``shed`` flags, the completion order and
the fault counters (``famine_deferred``, ``requeued``, ``expired``,
``reprefill_cold``, ``shed``, the plan's own) equal.

* ``TestServeFaults``: injected famine, an empty plan, slot failure,
  forced eviction, real famine (typed raise, then shed), deadline expiry
  and priority under an injected decode straggle (``step_time_ms``);
* ``TestFamineTTLEvictRetry``: the TTL sweep spares queued warm handles;
* ``TestSwarmCasualties``: crash salvage, straggle reported, empty plan,
  batched and streaming (the streaming round passes the plan to serve());
* ``core/policy.py``: ``reward`` and ``AccuracyStats`` against the JAX
  module.

The reference's ``TestSessionDurability`` waits for the port of session
checkpoints.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as C  # noqa: E402
from repro.core import policy as JP  # noqa: E402
from repro.core.uncertainty import UncertaintyConfig as JU  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import faults as JF  # noqa: E402
from repro.serving.engine import InferenceEngine as JE  # noqa: E402
from repro.serving.scheduler import Request as JR  # noqa: E402
from repro.serving.swarm import SwarmExecutor as JSX  # noqa: E402
from repro.serving.swarm import pad_prompts  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import policy as TP  # noqa: E402
from repro_torch.core.uncertainty import UncertaintyConfig as TU  # noqa: E402
from repro_torch.serving import faults as TF  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TE  # noqa: E402
from repro_torch.serving.scheduler import Request as TR  # noqa: E402
from repro_torch.serving.swarm import SwarmExecutor as TSX  # noqa: E402

BLOCK = 16
PROMPTS = [[3, 20, 195, 2], [3, 21, 196, 199, 2], [7, 9, 2]]
FAULT_COUNTERS = ("famine_deferred", "shed", "expired", "requeued",
                  "reprefill_cold", "prefill", "prefill_continue",
                  "decode_only")
SIDES = {"jax": (JE, JR, JF, JSX), "port": (TE, TR, TF, TSX)}


@pytest.fixture(scope="module")
def base():
    jc = dataclasses.replace(C.get_smoke("smollm-135m"), vocab_size=512,
                             dtype=jnp.float32, attn_prefill_impl="flash")
    tc = dataclasses.replace(TC.get_smoke("smollm-135m"), vocab_size=512,
                             dtype=torch.float32)
    p = jax.jit(JT.init_params, static_argnums=0)(jc, jax.random.PRNGKey(0))
    return {"jax": (jc, p), "port": (tc, from_jax_params(
        jax.tree.map(np.asarray, p), tc))}


def _engine(base, side, paged=True, **kw):
    cfg, params = base[side]
    if paged:
        kw.setdefault("block_len", BLOCK)
    if side == "port":
        kw["device"] = "cpu"
    ucfg = (JU if side == "jax" else TU)(mode="distribution")
    return SIDES[side][0]("t", cfg, params, ucfg, paged=paged, **kw)


def _plan(side, *events):
    F = SIDES[side][2]
    return F.FaultPlan([F.FaultEvent(*e) for e in events])


def _reqs(side, max_new=6, **kw):
    R = SIDES[side][1]
    return [R(rid=i, prompt=list(PROMPTS[i]), max_new=max_new, **kw)
            for i in range(len(PROMPTS))]


def _assert_fins_equal(j, t):
    """Completion order, tokens, shed flags and u of two serve() results."""
    assert [r["rid"] for r in t] == [r["rid"] for r in j]
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b["tokens"], a["tokens"])
        assert bool(b.get("shed")) == bool(a.get("shed"))
        assert b["u"] == pytest.approx(a["u"], abs=1e-4)


def _assert_counters_equal(je, te):
    for k in FAULT_COUNTERS:
        assert te.counters[k] == je.counters[k], k


def _both(fn):
    """``fn(side)`` on each side -> (jax result, port result)."""
    return fn("jax"), fn("port")


class TestServeFaults:
    def test_famine_backpressure_still_answers(self, base):
        def run(side):
            e = _engine(base, side)
            plan = _plan(side, ("pool", "famine", None, 3))
            fin = e.serve(_reqs(side), n_slots=2, decode_chunk=4,
                          faults=plan)
            ref = e.generate(pad_prompts(PROMPTS), 6)
            return e, plan, fin, ref
        (je, jplan, jfin, _), (te, tplan, tfin, tref) = _both(run)
        _assert_fins_equal(jfin, tfin)
        _assert_counters_equal(je, te)
        assert te.counters["famine_deferred"] > 0
        assert tplan.counters == jplan.counters == {"pool:famine": 3}
        for r in tfin:                  # still the healthy generation
            np.testing.assert_array_equal(r["tokens"],
                                          tref["tokens"][r["rid"]])

    def test_empty_plan_is_bitwise_noop(self, base):
        def run(side):
            e = _engine(base, side)
            fin0 = e.serve(_reqs(side), n_slots=2, decode_chunk=4)
            c0 = dict(e.counters)
            fin1 = e.serve(_reqs(side), n_slots=2, decode_chunk=4,
                           faults=_plan(side))
            return e, c0, fin0, fin1
        (je, _, jfin, _), (te, c0, tfin0, tfin1) = _both(run)
        _assert_fins_equal(tfin0, tfin1)
        assert [r["u"] for r in tfin0] == [r["u"] for r in tfin1]
        _assert_fins_equal(jfin, tfin0)
        for k in ("famine_deferred", "shed", "expired", "requeued",
                  "reprefill_cold"):
            assert te.counters[k] == c0[k] == je.counters[k] == 0

    def test_slot_failure_requeues(self, base):
        def run(side):
            e = _engine(base, side)
            fin = e.serve(_reqs(side), n_slots=2, decode_chunk=4,
                          faults=_plan(side, ("slot", "fail", None, 1)))
            return e, fin, e.generate(pad_prompts(PROMPTS), 6)
        (je, jfin, _), (te, tfin, tref) = _both(run)
        _assert_fins_equal(jfin, tfin)
        _assert_counters_equal(je, te)
        assert te.counters["requeued"] == 1
        assert not any(r.get("shed") for r in tfin)
        for r in tfin:              # the requeued request re-runs whole
            np.testing.assert_array_equal(r["tokens"],
                                          tref["tokens"][r["rid"]])

    def test_forced_eviction_cold_reprefill(self, base):
        full = list(PROMPTS[0]) + [11, 12, 2]

        def run(side):
            e = _engine(base, side)
            st = e.absorb(pad_prompts(PROMPTS[:1]))
            fin = e.serve([SIDES[side][1](rid=0, prompt=[11, 12, 2],
                                          state=st, cold_prompt=full,
                                          max_new=6)],
                          n_slots=1, decode_chunk=6,
                          faults=_plan(side, ("session", "evict", None, 1)))
            return e, fin, e.generate(pad_prompts([full]), 6)
        (je, jfin, _), (te, tfin, tcold) = _both(run)
        _assert_fins_equal(jfin, tfin)
        _assert_counters_equal(je, te)
        assert te.counters["reprefill_cold"] == 1
        np.testing.assert_array_equal(tfin[0]["tokens"], tcold["tokens"][0])
        assert te.pool.live_sessions == je.pool.live_sessions

    def test_real_famine_typed_raise_and_shed(self, base):
        for side in SIDES:
            F = SIDES[side][2]
            e = _engine(base, side, pool_blocks=4)   # absorb alone needs 8
            with pytest.raises(F.PoolExhaustedError):
                e.serve(_reqs(side)[:1], n_slots=1)
            fin = e.serve(_reqs(side)[:1], n_slots=1, overload="shed")
            assert fin[0]["shed"] and e.counters["shed"] == 1

    def test_deadline_expiry_under_straggler(self, base):
        """A decode straggle stalls the clock past rid 0's deadline: it
        retires shed and counted expired; rid 1 rides the stall out."""
        def run(side):
            R = SIDES[side][1]
            e = _engine(base, side)
            reqs = [R(rid=0, prompt=list(PROMPTS[0]), max_new=20,
                      deadline_ms=5000.0),
                    R(rid=1, prompt=list(PROMPTS[1]), max_new=20)]
            fin = e.serve(reqs, n_slots=2, decode_chunk=4,
                          faults=_plan(side, ("decode", "straggle", None, 1,
                                              10.0)),
                          step_time_ms=10.0)
            return e, fin
        (je, jfin), (te, tfin) = _both(run)
        _assert_fins_equal(jfin, tfin)
        _assert_counters_equal(je, te)
        assert {r["rid"]: bool(r.get("shed")) for r in tfin} == {
            0: True, 1: False}
        assert te.counters["expired"] == 1

    def test_priority_preemption_under_straggler(self, base):
        def run(side):
            R = SIDES[side][1]
            e = _engine(base, side)
            reqs = [R(rid=0, prompt=list(PROMPTS[0]), max_new=4),
                    R(rid=1, prompt=list(PROMPTS[1]), max_new=4, priority=5),
                    R(rid=2, prompt=list(PROMPTS[2]), max_new=4, priority=0)]
            fin = e.serve(reqs, n_slots=1, decode_chunk=4,
                          faults=_plan(side, ("decode", "straggle", None, 1,
                                              1.0)),
                          step_time_ms=1.0)
            return e, fin
        (je, jfin), (te, tfin) = _both(run)
        _assert_fins_equal(jfin, tfin)
        order = [r["rid"] for r in tfin]
        assert order.index(2) < order.index(1)
        assert len(tfin) == 3 and not any(r.get("shed") for r in tfin)

    def test_monolithic_engine_takes_the_same_faults(self, base):
        """Famine, slot failure and the clock do not need a pool: on
        monolithic engines too the port matches the reference."""
        def run(side):
            R = SIDES[side][1]
            e = _engine(base, side, paged=False)
            reqs = _reqs(side, max_new=9) + [
                R(rid=3, prompt=[5, 6, 2], max_new=9, deadline_ms=30.0)]
            fin = e.serve(reqs, n_slots=2, decode_chunk=3,
                          faults=_plan(side, ("pool", "famine", None, 2),
                                       ("slot", "fail", None, 2),
                                       ("decode", "straggle", None, 1, 0.01)),
                          step_time_ms=2.0)
            return e, fin
        (je, jfin), (te, tfin) = _both(run)
        _assert_fins_equal(jfin, tfin)
        _assert_counters_equal(je, te)
        assert te.counters["requeued"] == 2
        assert te.counters["famine_deferred"] > 0
        assert te.counters["expired"] == 1


class TestFamineTTLEvictRetry:
    def test_ttl_sweep_spares_queued_warm_handles(self, base):
        """Two absorbed sessions wedge admission: without a TTL serve()
        raises; with one, the idle session goes, the retry admits, and the
        queued warm request's handle survives (served warm)."""
        full_b = list(PROMPTS[1]) + [11, 2]

        def scenario(side, **kw):
            R = SIDES[side][1]
            e = _engine(base, side, pool_blocks=9)
            e.absorb(pad_prompts(PROMPTS[:1]))          # idle -> evictable
            st_b = e.absorb(pad_prompts(PROMPTS[1:2]))  # queued warm ref
            reqs = [R(rid=0, prompt=[11, 2], state=st_b, cold_prompt=full_b,
                      max_new=5),
                    R(rid=1, prompt=list(PROMPTS[0]), max_new=5)]
            return e, e.serve(reqs, n_slots=2, decode_chunk=5, **kw)

        for side in SIDES:
            with pytest.raises(SIDES[side][2].PoolExhaustedError):
                scenario(side)
        (je, jfin), (te, tfin) = _both(
            lambda side: scenario(side, session_ttl_s=0.0))
        _assert_fins_equal(jfin, tfin)
        _assert_counters_equal(je, te)
        assert te.counters["reprefill_cold"] == 0     # handle NOT swept
        assert te.counters["prefill_continue"] >= 1
        warm_ref = te.generate(pad_prompts([full_b]), 5)
        np.testing.assert_array_equal(
            next(r for r in tfin if r["rid"] == 0)["tokens"],
            warm_ref["tokens"][0])


class TestSwarmCasualties:
    @pytest.fixture(scope="class")
    def mono(self, base):
        return {side: _engine(base, side, paged=False) for side in SIDES}

    def _collab(self, mono, side, prompts, events, streaming=False):
        sx = SIDES[side][3]
        plan = None if events is None else _plan(side, *events)
        return sx([mono[side]] * 3, stop_token=2, faults=plan,
                  streaming=streaming).collaborate(prompts, 4)

    def _assert_rounds_equal(self, j, t):
        np.testing.assert_array_equal(t["answers"], j["answers"])
        np.testing.assert_allclose(t["u"], j["u"], atol=1e-4)
        np.testing.assert_array_equal(t["winner_tokens"], j["winner_tokens"])
        assert t["casualties"] == j["casualties"]
        assert t["straggle_s"] == j["straggle_s"]

    @pytest.mark.parametrize("streaming", [False, True],
                             ids=["batched", "streaming"])
    def test_crash_salvage(self, mono, streaming):
        prompts = pad_prompts(PROMPTS[:1])
        ev = [("member:1", "crash", None, 1, 0.0)]
        j, t = _both(lambda s: self._collab(mono, s, prompts, ev, streaming))
        self._assert_rounds_equal(j, t)
        assert t["casualties"] == [1]
        assert (t["u"][:, 1] == 1.0).all() and (t["answers"][:, 1] < 0).all()
        healthy = self._collab(mono, "port", prompts, None, streaming)
        np.testing.assert_array_equal(t["winner_tokens"],
                                      healthy["winner_tokens"])

    @pytest.mark.parametrize("streaming", [False, True],
                             ids=["batched", "streaming"])
    def test_straggle_reported_not_dropped(self, mono, streaming):
        prompts = pad_prompts(PROMPTS[:1])
        ev = [("member:2", "straggle", None, 1, 3.0)]
        j, t = _both(lambda s: self._collab(mono, s, prompts, ev, streaming))
        self._assert_rounds_equal(j, t)
        assert t["straggle_s"] == {2: 3.0}
        healthy = self._collab(mono, "port", prompts, None, streaming)
        np.testing.assert_array_equal(t["answers"], healthy["answers"])

    @pytest.mark.parametrize("streaming", [False, True],
                             ids=["batched", "streaming"])
    def test_empty_plan_parity(self, mono, streaming):
        prompts = pad_prompts(PROMPTS)
        j, t = _both(lambda s: self._collab(mono, s, prompts, [], streaming))
        self._assert_rounds_equal(j, t)
        a = self._collab(mono, "port", prompts, None, streaming)
        np.testing.assert_array_equal(a["answers"], t["answers"])
        np.testing.assert_array_equal(a["u"], t["u"])
        assert t["casualties"] == [] and t["straggle_s"] == {}


class TestPolicy:
    def test_reward_matches_jax(self):
        rng = np.random.default_rng(0)
        acc, lat, cost = (rng.random(16).astype(np.float32)
                          for _ in range(3))
        viol = rng.random(16) < 0.3
        w = dict(acc=0.9, lat=0.1, cost=2e3, pol=1.5)
        j = JP.reward(jnp.asarray(acc), jnp.asarray(lat), jnp.asarray(cost),
                      jnp.asarray(viol), JP.RewardWeights(**w))
        t = TP.reward(torch.as_tensor(acc), torch.as_tensor(lat),
                      torch.as_tensor(cost), torch.as_tensor(viol),
                      TP.RewardWeights(**w))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
        assert TP.RewardWeights() == TP.RewardWeights(
            **dataclasses.asdict(JP.RewardWeights()))

    def test_accuracy_stats_match_jax(self):
        """Repeated cells accumulate, u outside [0, 1] clips to the end
        bins, the estimate shrinks to the prior; update leaves its input
        as it was (the statistics are values)."""
        rng = np.random.default_rng(1)
        n = 64
        u = np.concatenate([rng.random(n - 2), [-0.2, 1.3]]).astype(
            np.float32)
        risk = rng.integers(0, 2, n)
        act = rng.integers(0, 5, n)
        ok = rng.random(n) < 0.6
        js, ts = JP.AccuracyStats.init(), TP.AccuracyStats.init()
        for lo in (0, 32):
            sl = slice(lo, lo + 32)
            js = js.update(jnp.asarray(u[sl]), jnp.asarray(risk[sl]),
                           jnp.asarray(act[sl]), jnp.asarray(ok[sl]))
            prev, t0 = ts, ts.counts.clone()
            ts = ts.update(torch.as_tensor(u[sl]), torch.as_tensor(risk[sl]),
                           torch.as_tensor(act[sl]), torch.as_tensor(ok[sl]))
            assert torch.equal(prev.counts, t0)
        np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
        np.testing.assert_array_equal(ts.correct.numpy(),
                                      np.asarray(js.correct))
        assert float(ts.counts.sum()) == n
        q = rng.random(10).astype(np.float32)
        qr, qa = rng.integers(0, 2, 10), rng.integers(0, 5, 10)
        je = js.estimate(jnp.asarray(q), jnp.asarray(qr), jnp.asarray(qa),
                         prior=0.4, strength=3.0)
        te = ts.estimate(torch.as_tensor(q), torch.as_tensor(qr),
                         torch.as_tensor(qa), prior=0.4, strength=3.0)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)
