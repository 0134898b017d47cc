"""The port's session API (``SessionState``, ``generate(return_state=)``,
decode-only extension, ``state_select``) on its own contracts and against
the JAX engine's.

* extension: ``generate(p, n, return_state=True)`` then ``generate(None, k,
  state=...)`` emits, bitwise, what one ``generate(p, n + k)`` emits —
  tokens and logits, greedy and sampled (the sampling generator rides in
  the state), with and without cache growth;
* against JAX's ``_extend`` on converted weights, tie-aware
  (``test_torch_engine.assert_greedy_match_modulo_ties``), in f32 with the
  JAX flash prefill;
* ``state_select`` with repeated indices, and extending a selected copy
  leaves the source state untouched (the port writes caches in place);
* the engine's ``counters`` as the gateway reads them.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from test_torch_engine import assert_greedy_match_modulo_ties

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as C  # noqa: E402
from repro.core.uncertainty import UncertaintyConfig as JU  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.uncertainty import UncertaintyConfig as TU  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.serving.faults import FaultEvent, FaultPlan  # noqa: E402
from repro_torch.serving.scheduler import Request  # noqa: E402

PROMPTS = np.array([[0, 0, 3, 20, 195, 2], [3, 21, 196, 199, 2, 7],
                    [0, 0, 0, 7, 9, 2]], np.int32)


@pytest.fixture(scope="module", params=["smollm-135m", "qwen1.5-110b"])
def engines(request):
    arch = request.param
    jc = dataclasses.replace(C.get_smoke(arch), vocab_size=512,
                             dtype=jnp.float32, attn_prefill_impl="flash")
    tc = dataclasses.replace(TC.get_smoke(arch), vocab_size=512,
                             dtype=torch.float32)
    p = jax.jit(T.init_params, static_argnums=0)(jc, jax.random.PRNGKey(3))
    ucfg = dict(alpha=0.7, mode="distribution")
    model = from_jax_params(jax.tree.map(np.asarray, p), tc)
    # max_len 16: the 8-column bucket + 6 new tokens fits, + 6 more grows
    return (JEngine(arch, jc, p, JU(**ucfg), max_len=16),
            TEngine(arch, tc, model, TU(**ucfg), max_len=16, device="cpu"))


def _np(res):
    return {**res, "logits": np.asarray(res["logits"])}


@pytest.mark.parametrize("greedy", [True, False])
def test_extension_equals_longer_generate(engines, greedy):
    _, te = engines
    full = te.generate(PROMPTS, 14, greedy=greedy, seed=5)
    before = dict(te.counters)
    a = te.generate(PROMPTS, 6, greedy=greedy, seed=5, return_state=True)
    st = a["state"]
    assert (st.batch, st.offset, st.max_len) == (3, 6 + 6, 16)
    b = te.generate(None, 8, state=st, greedy=greedy, seed=99)
    np.testing.assert_array_equal(
        np.concatenate([a["tokens"], b["tokens"]], 1), full["tokens"])
    assert torch.equal(torch.cat([a["logits"], b["logits"]], 1),
                       full["logits"])
    c = te.counters
    assert c["prefill"] == before["prefill"] + 1
    assert c["decode_only"] == before["decode_only"] + 1
    assert c["grow_copy"] == before["grow_copy"] + 1     # 12 + 8 > 16
    np.testing.assert_array_equal(b["prompt_lengths"], np.zeros(3))


def test_extension_chain_without_growth(engines):
    _, te = engines
    full = te.generate(PROMPTS, 8)
    a = te.generate(PROMPTS, 3, return_state=True)
    b = te.generate(None, 2, state=a["state"], return_state=True)
    grow = te.counters["grow_copy"]
    c = te.generate(None, 3, state=b["state"])
    assert te.counters["grow_copy"] == grow
    np.testing.assert_array_equal(
        np.concatenate([a["tokens"], b["tokens"], c["tokens"]], 1),
        full["tokens"])


def test_extension_matches_jax(engines):
    je, te = engines
    ja = je.generate(PROMPTS, 6, return_state=True)
    jb = je.generate(None, 8, state=ja["state"])
    ta = te.generate(PROMPTS, 6, return_state=True)
    tb = te.generate(None, 8, state=ta["state"])
    for t, j in ((ta, ja), (tb, jb)):
        assert_greedy_match_modulo_ties(_np(t), _np(j), atol=1e-4)
        if (t["tokens"] == j["tokens"]).all():
            for k in ("u", "h_mean", "v_mean"):
                np.testing.assert_allclose(t[k], j[k], atol=1e-5, err_msg=k)
    assert te.counters["decode_only"] >= 1


def test_state_select_repeated_rows_and_source_untouched(engines):
    _, te = engines
    full = te.generate(PROMPTS, 14)
    a = te.generate(PROMPTS, 6, return_state=True)
    src = a["state"]
    snap = [[t.clone() for t in c] for c in src.cache]
    scal = [t.clone() for t in (src.pos, src.cur, src.last)]
    idx = [2, 0, 0, 1]
    sel = te.state_select(src, idx)
    assert sel.batch == 4 and sel.offset == src.offset
    ext = te.generate(None, 8, state=sel)
    np.testing.assert_array_equal(ext["tokens"], full["tokens"][idx, 6:])
    # the selection was extended in place; the source was not
    for c, s in zip(src.cache, snap):
        for t, t0 in zip(c, s):
            assert torch.equal(t, t0)
    for t, t0 in zip((src.pos, src.cur, src.last), scal):
        assert torch.equal(t, t0)
    # ... so the source still extends to the longer generation
    rest = te.generate(None, 8, state=src)
    np.testing.assert_array_equal(rest["tokens"], full["tokens"][:, 6:])


def test_sampled_selection_forks_the_generator(engines):
    _, te = engines
    a = te.generate(PROMPTS, 4, greedy=False, seed=1, return_state=True)
    s1 = te.state_select(a["state"], [0, 1, 2])
    s2 = te.state_select(a["state"], [0, 1, 2])
    e1 = te.generate(None, 5, state=s1, greedy=False)
    e2 = te.generate(None, 5, state=s2, greedy=False)
    np.testing.assert_array_equal(e1["tokens"], e2["tokens"])


def test_serve_overload_and_counters(engines):
    _, te = engines
    reqs = [Request(rid=i, prompt=PROMPTS[i].tolist(), max_new=4)
            for i in range(3)]
    n0 = te.counters["prefill"]
    fin = te.serve(reqs, n_slots=2, overload="shed")
    assert sorted(r["rid"] for r in fin) == [0, 1, 2]
    assert te.counters["prefill"] == n0 + 3          # one per admission
    assert all(te.counters[k] == 0 for k in ("famine_deferred", "shed",
                                             "expired", "requeued",
                                             "reprefill_cold"))
    with pytest.raises(ValueError):
        te.serve(reqs, overload="drop")
    # injected faults move their counters (tests/test_torch_faults.py
    # holds them to the reference): a famine round defers the queue, a
    # slot failure requeues its request, and every request still retires
    plan = FaultPlan([FaultEvent("pool", "famine"), FaultEvent("slot", "fail")])
    fin = te.serve([Request(rid=i, prompt=PROMPTS[i].tolist(), max_new=4)
                    for i in range(3)], n_slots=2, decode_chunk=2,
                   faults=plan)
    assert sorted(r["rid"] for r in fin) == [0, 1, 2]
    assert te.counters["famine_deferred"] == 3
    assert te.counters["requeued"] == 1
    assert plan.counters == {"pool:famine": 1, "slot:fail": 1}
