"""Warm sessions in the port (continuation prefill, ``absorb``, multi-turn
``generate``, warm ``serve()``) on their own contracts and against the JAX
engine's, mirroring tests/test_continuation.py.

Setup: the smoke llama3-8b in f32, vocabulary 512, with weights from the
JAX ``init_params`` converted by ``convert.from_jax_params`` (an untied
head: the tied smoke tiers' greedy streams repeat the last token, which
would make every token comparison vacuous).  The JAX engine runs its flash
prefill, as in tests/test_torch_sessions.py.

* a warm continuation (``absorb`` then ``generate(span, state=)``) equals a
  cold prefill of the concatenation, tie-aware at 1e-4: in f32 the two
  differ in summation order only;
* ``absorb`` then a decode-only extension equals ``generate`` bitwise (the
  same prefill and decode steps);
* multi-turn sessions equal cold re-prefills of the conversation,
  tie-aware;
* a continuation span longer than a local window keeps the last window
  (a dense smoke variant with ``mixer_pattern=("attn", "attn_local")`` and
  ``window=16``);
* warm ``serve()`` admissions and ``return_state`` round trips equal the
  batched session, and a mid-chunk stop gives an inexact handle;
* against JAX's ``_prefill_continue`` / ``_generate_continue`` on converted
  weights: tie-aware at 1e-4, the probe terms to 1e-5 where the streams
  agree (tests/test_torch_sessions.py's tolerances).
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
from repro.serving.swarm import pad_prompts  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.uncertainty import UncertaintyConfig as TU  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.serving.scheduler import Request  # noqa: E402

CTX = [[3, 20, 195, 2, 9, 31], [3, 21, 196, 199, 2, 7], [7, 9, 2, 44, 45, 2]]
SPAN = [[11, 12, 2], [13, 2], [14, 15, 16, 2]]
SPAN2 = [[33, 2], [34, 35, 2], [36, 2]]
ATOL = 1e-4


def pair(arch="llama3-8b", seed=0, **over):
    """(JAX config, JAX params, port config, port model) of a smoke arch in
    f32 at vocabulary 512, ``over`` replacing config fields on both
    sides."""
    over = dict(vocab_size=512, **over)
    jc = dataclasses.replace(C.get_smoke(arch), dtype=jnp.float32,
                             attn_prefill_impl="flash", **over)
    tc = dataclasses.replace(TC.get_smoke(arch), dtype=torch.float32, **over)
    p = jax.jit(T.init_params, static_argnums=0)(jc,
                                                 jax.random.PRNGKey(seed))
    return jc, p, tc, from_jax_params(jax.tree.map(np.asarray, p), tc)


def _np(res):
    return {**res, "logits": np.asarray(res["logits"])}


def _tie(warm, cold, atol=ATOL):
    assert_greedy_match_modulo_ties(_np(warm), _np(cold), atol=atol)


@pytest.fixture(scope="module")
def models():
    return pair()


@pytest.fixture
def engine(models):
    _, _, tc, model = models
    return TEngine("t", tc, model, TU(mode="distribution"), device="cpu")


def test_streams_are_not_degenerate(engine):
    out = engine.generate(pad_prompts(CTX), 6)["tokens"]
    assert len(np.unique(out)) >= 6, out


def test_warm_continuation_matches_cold_concat(engine):
    ctx, span = pad_prompts(CTX), pad_prompts(SPAN)
    st = engine.absorb(ctx)
    assert engine.counters == {**engine.counters, "prefill": 1,
                               "prefill_continue": 0}
    warm = engine.generate(span, 6, state=st)
    assert engine.counters["prefill_continue"] == 1
    cold = engine.generate(np.concatenate([ctx, span], axis=1), 6)
    _tie(warm, cold)
    if (warm["tokens"] == cold["tokens"]).all():
        np.testing.assert_allclose(warm["u"], cold["u"], atol=1e-5)


def test_absorb_then_extend_matches_generate(engine):
    ctx = pad_prompts(CTX)
    st = engine.absorb(ctx)
    assert st.offset == ctx.shape[1] and st.max_len == engine.max_len
    ext = engine.generate(None, 6, state=st)
    base = engine.generate(ctx, 6)
    np.testing.assert_array_equal(ext["tokens"], base["tokens"])
    assert torch.equal(ext["logits"], base["logits"])


def test_multiturn_sessions_match_cold_reprefill(engine):
    ctx = pad_prompts(CTX)
    hist = ctx
    r = engine.generate(ctx, 4, return_state=True)
    for span_toks in (SPAN, SPAN2):
        span = pad_prompts(span_toks)
        hist = np.concatenate([hist, r["tokens"], span], axis=1)
        r = engine.generate(span, 4, state=r["state"], return_state=True)
        assert r["state"].offset == hist.shape[1] + 4
        _tie(r, engine.generate(hist, 4))


def test_session_cache_growth(models):
    _, _, tc, model = models
    eng = TEngine("t", tc, model, TU(mode="distribution"), max_len=16,
                  device="cpu")
    ctx, span = pad_prompts(CTX), pad_prompts(SPAN)
    st = eng.absorb(ctx)
    assert st.max_len == 16
    warm = eng.generate(span, 8, state=st, return_state=True)
    assert warm["state"].max_len > 16 and eng.counters["grow_copy"] == 1
    _tie(warm, eng.generate(np.concatenate([ctx, span], axis=1), 8))


def test_positions_must_agree_across_the_batch(engine):
    """One position row serves the whole batch: a batch of sessions at
    different positions raises instead of reading row 0's."""
    a = engine.absorb(pad_prompts(CTX)[:1])
    b = engine.absorb(pad_prompts([CTX[0][:4]]))
    st = engine.state_select(a, [0, 0])
    st.pos = torch.cat([a.pos, b.pos])
    with pytest.raises(ValueError, match="same positions"):
        engine.generate(pad_prompts(SPAN[:2]), 2, state=st)


def test_continuation_span_longer_than_window():
    """A span overflowing a local window keeps the LAST window of real K/V:
    spans are right-padded, so the ring trim goes by position, not by
    column."""
    _, _, tc, model = pair(mixer_pattern=("attn", "attn_local"), window=16)
    eng = TEngine("t", tc, model, TU(mode="distribution"), device="cpu")
    ctx = pad_prompts(CTX)
    span = pad_prompts([list(range(50, 90))] * 3)     # 40 real > window
    warm = eng.generate(span, 6, state=eng.absorb(ctx))
    _tie(warm, eng.generate(np.concatenate([ctx, span], axis=1), 6))


def test_warm_admission_matches_generate(engine):
    """serve() with ``Request.state`` continuation-prefills only the new
    span: zero cold prefills, tokens those of the batched warm generate."""
    prompts = pad_prompts(CTX)
    r1 = engine.generate(prompts, 6, return_state=True)
    reqs = [Request(rid=i, prompt=SPAN[i], max_new=6,
                    state=engine.state_select(r1["state"], [i]))
            for i in range(3)]
    before = dict(engine.counters)
    fin = engine.serve(reqs, n_slots=2, decode_chunk=4)
    assert engine.counters["prefill"] == before["prefill"]
    assert engine.counters["prefill_continue"] == \
        before["prefill_continue"] + 3
    ref = engine.generate(pad_prompts(SPAN), 6, state=r1["state"])
    for r in fin:
        np.testing.assert_array_equal(r["tokens"], ref["tokens"][r["rid"]])


def test_return_state_roundtrip_through_serve(engine):
    prompts = pad_prompts(CTX)
    fin1 = engine.serve([Request(rid=i, prompt=prompts[i].tolist(),
                                 max_new=6, return_state=True)
                         for i in range(3)], n_slots=2, decode_chunk=4)
    states = {r["rid"]: r["state"] for r in fin1}
    assert len(states) == 3 and all(s.exact for s in states.values())
    fin2 = engine.serve([Request(rid=i, prompt=SPAN[i], max_new=6,
                                 state=states[i]) for i in range(3)],
                        n_slots=2, decode_chunk=4)
    r1 = engine.generate(prompts, 6, return_state=True)
    r2 = engine.generate(pad_prompts(SPAN), 6, state=r1["state"])
    for r in fin1:
        np.testing.assert_array_equal(r["tokens"], r1["tokens"][r["rid"]])
    for r in fin2:
        np.testing.assert_array_equal(r["tokens"], r2["tokens"][r["rid"]])


def test_serve_decode_resume(engine):
    """A warm request with an empty prompt resumes decode-only from the
    handle's pending token: the tokens the batched extension emits."""
    prompts = pad_prompts(CTX)
    r1 = engine.generate(prompts, 3, return_state=True)
    reqs = [Request(rid=i, prompt=[], max_new=5,
                    state=engine.state_select(r1["state"], [i]))
            for i in range(3)]
    fin = engine.serve(reqs, n_slots=3, decode_chunk=2)
    ext = engine.generate(None, 5, state=r1["state"])
    for r in fin:
        np.testing.assert_array_equal(r["tokens"], ext["tokens"][r["rid"]])


def test_midchunk_stop_retirement_marks_state_inexact(engine):
    prompts = pad_prompts(CTX)
    stop = int(engine.generate(prompts, 6)["tokens"][0, 1])
    fin = engine.serve([Request(rid=0, prompt=prompts[0].tolist(),
                                max_new=6, return_state=True)],
                       n_slots=1, decode_chunk=6, stop_token=stop)
    st = fin[0]["state"]
    assert len(fin[0]["tokens"]) == 2 and not st.exact
    with pytest.raises(ValueError, match="inexact"):
        engine.generate(None, 4, state=st)
    with pytest.raises(ValueError, match="inexact"):
        engine.serve([Request(rid=1, prompt=[], max_new=2, state=st)],
                     n_slots=1)
    out = engine.generate(pad_prompts([SPAN[0]]), 4, state=st)
    assert out["tokens"].shape == (1, 4)


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-110b"])
def test_continuation_matches_jax(arch):
    """The port's warm continuation and multi-turn chain against JAX's on
    the same converted weights (both monolithic, f32)."""
    jc, p, tc, model = pair(arch)
    je = JEngine(arch, jc, p, JU(mode="distribution"))
    te = TEngine(arch, tc, model, TU(mode="distribution"), device="cpu")
    ctx = pad_prompts(CTX)
    runs = []
    for eng in (je, te):
        st = eng.absorb(ctx)
        a = eng.generate(pad_prompts(SPAN), 5, state=st, return_state=True)
        b = eng.generate(pad_prompts(SPAN2), 4, state=a["state"])
        runs.append((a, b))
    for t, j in zip(runs[1], runs[0]):
        _tie(t, j)
        same = (t["tokens"] == j["tokens"]).all(axis=1)
        for k in ("u", "h_mean", "v_mean"):
            np.testing.assert_allclose(t[k][same], j[k][same], atol=1e-5,
                                       err_msg=k)
    assert (te.counters["prefill"], te.counters["prefill_continue"]) == \
        (je.counters["prefill"], je.counters["prefill_continue"]) == (1, 2)
