"""The port's engines on the two recurrent families (``recurrentgemma-2b``:
RG-LRU + windowed attention; ``mamba2-780m``: SSD only) against the JAX
engines, and the port's own engine contracts on them: monolithic and paged
``generate`` (cold, warm, extended), ``generate_stepwise``, ``serve()``
with and without a ``FaultPlan``, fan-out and ``state_select`` copying
state rows, admission on rows, the graph route and the swarm's SSD peer.

Setup: the smoke configs in f32 (the JAX engine with its flash prefill),
vocabulary 512, weights from the JAX ``init_params`` with every matrix but
the embedding and the convs scaled by 6, so the tied smoke models' greedy
streams vary (at the init scale every stream repeats its last prompt
token), converted by ``convert.from_jax_params``.  Budgets:

* tokens tie-aware against the JAX engine (the reference's rule, at 1e-4
  on f32 logits), logits to 1e-4 and u / h_mean / v_mean to 1e-5: the same
  math in another summation order;
* the port's own contracts at the reference's budgets
  (tests/test_prefill_parity.py): ``generate`` equals
  ``generate_stepwise`` tie-aware with u within 1e-4, ``serve()`` equals
  ``generate`` with u within 1e-5; warm continuation equals the cold
  concatenation tie-aware (tests/test_continuation.py);
* the paged engine's gather route is bitwise the monolithic engine, its
  kernel route within 1e-5 (the block-table op attends the same keys in
  another order; the SSD model has no attention, so there it is bitwise);
* pools against JAX's after the same calls (``from_jax_paged_pool``):
  block tables, row ids, refcounts and positions exactly, k/v and state
  rows to 1e-4;
* the graph route (``DecodeGraphs(Rerun())``) bitwise the eager loop.

After every path the pool is back at its blocks and rows in use.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from test_torch_engine import assert_greedy_match_modulo_ties

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as C  # noqa: E402
from repro.core.uncertainty import UncertaintyConfig as JU  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import faults as JF  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro.serving.swarm import SwarmExecutor as JSX  # noqa: E402
from repro.serving.swarm import pad_prompts  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import (from_jax_paged_pool,  # noqa: E402
                                 from_jax_params)
from repro_torch.core.uncertainty import UncertaintyConfig as TU  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import faults as TF  # noqa: E402
from repro_torch.serving import graphs  # noqa: E402
from repro_torch.serving.cache_manager import CachePool  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.serving.scheduler import Request  # noqa: E402
from repro_torch.serving.swarm import SwarmExecutor as TSX  # noqa: E402

ARCHS = {"rglru": "recurrentgemma-2b", "ssd": "mamba2-780m"}
BLOCK = 16          # divides the hybrid smoke's window (32)
UC = dict(mode="distribution")
ATOL = 1e-4
CTX = [[3, 20, 195, 2, 9, 31], [3, 21, 196, 199, 2, 7], [7, 9, 2, 44, 45, 2]]
SPAN = [[11, 12, 2], [13, 2], [14, 15, 16, 2]]
SPAN2 = [[33, 2], [34, 35, 2], [36, 2]]
ROUTES = {"mono": {}, "kernel": dict(paged=True, block_len=BLOCK),
          "gather": dict(paged=True, block_len=BLOCK,
                         attn_decode_impl="gather")}


@functools.lru_cache(maxsize=None)
def _weights(arch: str, seed: int = 0):
    jc = dataclasses.replace(C.get_smoke(arch), vocab_size=512,
                             dtype=jnp.float32, attn_prefill_impl="flash")
    tc = dataclasses.replace(TC.get_smoke(arch), vocab_size=512,
                             dtype=torch.float32)
    p = jax.jit(JT.init_params, static_argnums=0)(jc,
                                                 jax.random.PRNGKey(seed))

    def scale(path, a):
        name = jax.tree_util.keystr(path)
        big = a.ndim >= 2 and "embed" not in name and "conv" not in name
        return a * 6 if big else a

    p = jax.tree_util.tree_map_with_path(scale, p)
    return jc, tc, p, from_jax_params(jax.tree.map(np.asarray, p), tc)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def pair(request):
    """(JAX config, port config, JAX params, port model); shared, never
    written (the engines write caches and pools, not weights)."""
    return _weights(ARCHS[request.param])


def _port(pair, route="mono", **kw):
    _, tc, _, model = pair
    return TEngine("t", tc, model, TU(**UC), device="cpu",
                   **{**ROUTES[route], **kw})


def _jax(pair, route="mono", **kw):
    jc, _, p, _ = pair
    return JEngine("j", jc, p, JU(**UC), **{**ROUTES[route], **kw})


def _np(res):
    return {**res, "logits": np.asarray(res["logits"])}


def _tie(out, ref, atol=ATOL):
    assert_greedy_match_modulo_ties(_np(out), _np(ref), atol=atol)


def _assert_pool_idle(eng):
    """No block or row in use, every row refcount back at 0."""
    pool = eng.pool
    assert pool.blocks_in_use == 0
    assert pool.rows_in_use == 0
    assert int(pool.row_ref.sum()) == 0


def _rows_of(eng, handle):
    """Copies of a paged handle's state rows in every state pool."""
    ids = torch.as_tensor(handle.rows, dtype=torch.long)
    return [t.index_select(0, ids).clone()
            for p in TT._state_pools(eng.pool.arrays) for t in p]


# ---------------------------------------------------------------------------
# against the JAX engine
# ---------------------------------------------------------------------------

def test_generate_matches_jax(pair):
    """Monolithic ``generate`` against JAX's; the paged routes against the
    port's monolithic engine (gather bitwise, kernel 1e-5)."""
    prompts = pad_prompts(CTX)
    jres = _jax(pair).generate(prompts, 8)
    tres = _port(pair).generate(prompts, 8)
    _tie(tres, jres)
    np.testing.assert_array_equal(tres["tokens"], jres["tokens"])
    np.testing.assert_allclose(tres["logits"].numpy(),
                               np.asarray(jres["logits"]), atol=ATOL)
    for key in ("u", "h_mean", "v_mean"):
        np.testing.assert_allclose(tres[key], jres[key], atol=1e-5)
    assert len(set(tres["tokens"].ravel().tolist())) > 6   # not degenerate
    for route in ("gather", "kernel"):
        eng = _port(pair, route)
        res = eng.generate(prompts, 8)
        np.testing.assert_array_equal(res["tokens"], tres["tokens"])
        if route == "gather":
            assert torch.equal(res["logits"], tres["logits"])
        else:
            torch.testing.assert_close(res["logits"], tres["logits"],
                                       atol=1e-5, rtol=0)
        _assert_pool_idle(eng)


def test_paged_pools_match_jax(pair):
    """The same generate, continuation, absorb, fan-out, warm generate and
    decode-resume ``serve()`` on the JAX paged engine and the port's:
    tokens, the handles' tables and rows, refcounts, counters, and the
    pools (KV blocks and state rows) through ``from_jax_paged_pool``."""
    jc, tc, _, _ = pair
    kw = dict(pool_blocks=64, pool_rows=24)
    je, te = _jax(pair, "kernel", **kw), _port(pair, "kernel", **kw)
    ctx, span = pad_prompts(CTX), pad_prompts(SPAN)
    outs, handles = [], []
    for eng, R in ((je, JRequest), (te, Request)):
        g = eng.generate(ctx, 5, return_state=True)
        c = eng.generate(span, 4, state=g["state"], return_state=True)
        st = eng.absorb(ctx[:1])
        fan = eng.fanout(st, 3)
        f = eng.generate(pad_prompts(SPAN2), 4, state=fan,
                         return_state=True)
        s = eng.serve([R(rid=k, prompt=[], max_new=5, state=st,
                         return_state=True) for k in range(2)],
                      n_slots=2, decode_chunk=3)
        s = sorted(s, key=lambda r: r["rid"])
        outs.append([g, c, f] + [{"tokens": r["tokens"][None]} for r in s])
        handles.append([g["state"], c["state"], st, f["state"]]
                       + [r["state"] for r in s])
    for t, j in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(t["tokens"], j["tokens"])
    for ht, hj in zip(handles[1], handles[0]):
        np.testing.assert_array_equal(ht.cache.tables, hj.cache.tables)
        np.testing.assert_array_equal(ht.cache.rows, hj.cache.rows)
        assert ht.offset == hj.offset
    np.testing.assert_array_equal(te.pool.ref, je.pool.ref)
    np.testing.assert_array_equal(te.pool.row_ref, je.pool.row_ref)
    assert te.pool.counters == je.pool.counters
    jpool = from_jax_paged_pool(jax.tree.map(np.asarray, je.pool.arrays), tc)
    n_rows = te.pool.n_rows
    for pj, pt, (mixer, _) in zip(jpool, te.pool.arrays, tc.layer_plan()):
        if mixer in TT.ATTN:
            sj, st_ = pj.served(), pt.served()
            assert torch.equal(st_.pos, sj.pos)
            for a, b in ((st_.k, sj.k), (st_.v, sj.v)):
                torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
        else:
            assert type(pt) is type(pj)
            for a, b in zip(pt, pj):
                assert a.dtype == b.dtype
                torch.testing.assert_close(a[:n_rows], b[:n_rows],
                                           atol=ATOL, rtol=0)
    for eng, hs in ((je, handles[0]), (te, handles[1])):
        for h in {h.cache.sid: h for h in hs}.values():   # a continuation
            eng.release(h)                              # keeps its handle
    _assert_pool_idle(te)
    assert int(je.pool.row_ref.sum()) == 0


def test_warm_continuation_matches_cold_and_jax(pair):
    """absorb(ctx) then generate(span, state) against a cold generate of
    the concatenation (tie-aware), on both routes of the port, and against
    the JAX engine's warm continuation."""
    ctx, span = pad_prompts(CTX), pad_prompts(SPAN)
    cold = _port(pair).generate(np.concatenate([ctx, span], axis=1), 6)
    jwarm = None
    for route in ("mono", "kernel"):
        eng = _port(pair, route)
        warm = eng.generate(span, 6, state=eng.absorb(ctx))
        _tie(warm, cold)
        if (warm["tokens"] == cold["tokens"]).all():
            np.testing.assert_allclose(warm["u"], cold["u"], atol=1e-4)
        if jwarm is None:
            je = _jax(pair)
            jwarm = je.generate(span, 6, state=je.absorb(ctx))
        _tie(warm, jwarm)
        if eng.paged:
            eng.release(eng.absorb(ctx))
            assert eng.pool.live_sessions == 1    # the warm state's handle


def test_continuation_span_longer_than_window():
    """A continuation span of 40 real tokens over the hybrid's 32-slot
    attention window keeps the last window of K/V (the ring trim goes by
    position), monolithic and paged (ring tables), as the JAX engine does.
    The span's early queries attend a ring that already dropped their
    oldest keys, in the reference too, and the RG-LRU layers carry those
    positions' outputs forward: such a warm continuation is held to the
    JAX engine's warm continuation, not to a cold prefill of the
    concatenation."""
    pair = _weights(ARCHS["rglru"])
    ctx = pad_prompts(CTX)
    span = pad_prompts([list(range(50, 90))] * 3)
    assert span.shape[1] > pair[1].window
    je = _jax(pair)
    jwarm = je.generate(span, 6, state=je.absorb(ctx))
    for route in ("mono", "kernel", "gather"):
        eng = _port(pair, route)
        warm = eng.generate(span, 6, state=eng.absorb(ctx))
        _tie(warm, jwarm)


def test_swarm_ssd_peer():
    """The reference's ``TestSwarmStateReuse``: a smollm probe whose answer
    is precomputed issues no dispatch beside an SSD peer that really runs;
    a deeper round extends the probe decode-only.  Answers and u equal the
    JAX swarm's on the same weights."""
    from test_torch_continuation import pair as dense_pair
    ssd = _weights(ARCHS["ssd"])
    djc, dp, dtc, dmodel = dense_pair("smollm-135m")
    prompts = pad_prompts(CTX)
    out = {}
    for side in ("jax", "port"):
        if side == "jax":
            probe = JEngine("p", djc, dp, JU(**UC))
            peer, sx = _jax(ssd), JSX
        else:
            probe = TEngine("p", dtc, dmodel, TU(**UC), device="cpu")
            peer, sx = _port(ssd), TSX
        res = probe.generate(prompts, 4, return_state=True, seed=3)
        before = dict(probe.counters)
        sw = sx([probe, peer]).collaborate(
            prompts, 4, seed=3,
            precomputed={0: (res["tokens"], res["u"],
                             (res["h_mean"], res["v_mean"]))},
            states={0: res["state"]})
        assert probe.counters == before
        assert peer.counters["prefill"] >= 1
        np.testing.assert_array_equal(sw["answers"][:, 0], res["tokens"])
        deep = sx([probe, peer]).collaborate(
            prompts, 8, seed=3,
            precomputed={0: (res["tokens"], res["u"],
                             (res["h_mean"], res["v_mean"]))},
            states={0: res["state"]})
        assert probe.counters["decode_only"] == before["decode_only"] + 1
        assert probe.counters["prefill"] == before["prefill"]
        out[side] = (sw, deep)
    for (jsw, jdeep), (tsw, tdeep) in [(out["jax"], out["port"])]:
        for j, t in ((jsw, tsw), (jdeep, tdeep)):
            np.testing.assert_array_equal(t["answers"], j["answers"])
            np.testing.assert_allclose(t["u"], j["u"], atol=1e-4)


def _fault_run(pair, side, events, reqs_kw=None):
    eng = (_jax if side == "jax" else _port)(pair, "kernel", pool_rows=16)
    F, R = (JF, JRequest) if side == "jax" else (TF, Request)
    prompts = [[3, 20, 195, 2], [3, 21, 196, 199, 2], [7, 9, 2]]
    reqs = [R(rid=i, prompt=list(prompts[i]), max_new=6,
              **(reqs_kw or {}).get(i, {})) for i in range(3)]
    plan = F.FaultPlan([F.FaultEvent(*e) for e in events])
    fin = eng.serve(reqs, n_slots=2, decode_chunk=4, faults=plan,
                    step_time_ms=1.0)
    return eng, sorted(fin, key=lambda r: r["rid"])


@pytest.mark.parametrize("events", [
    [("pool", "famine", None, 2), ("slot", "fail", None, 2)],
    [("decode", "straggle", None, 1, 0.05)],
], ids=["famine_slot", "expiry"])
def test_serve_faults_free_each_row_once(pair, events):
    """``serve()`` under a ``FaultPlan`` (slot failure, famine, a straggle
    past request 2's deadline) against the JAX engine's: results and
    counters; every slot's row is freed exactly once (the allocator
    asserts on a double free), so the pool ends with no row in use."""
    kw = {2: {"deadline_ms": 3.0}} if events[0][0] == "decode" else None
    je, jfin = _fault_run(pair, "jax", events, kw)
    te, tfin = _fault_run(pair, "port", events, kw)
    assert [r["rid"] for r in tfin] == [r["rid"] for r in jfin]
    for a, b in zip(jfin, tfin):
        np.testing.assert_array_equal(b["tokens"], a["tokens"])
        assert bool(b.get("shed")) == bool(a.get("shed"))
        assert b["u"] == pytest.approx(a["u"], abs=1e-4)
    for k in ("famine_deferred", "shed", "expired", "requeued", "prefill"):
        assert te.counters[k] == je.counters[k], k
    assert te.counters["requeued"] + te.counters["expired"] >= 1
    np.testing.assert_array_equal(te.pool.row_ref, je.pool.row_ref)
    _assert_pool_idle(te)


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def test_generate_matches_stepwise(pair):
    prompts = pad_prompts(CTX)
    eng = _port(pair)
    res = eng.generate(prompts, 6)
    step = eng.generate_stepwise(prompts, 6)
    _tie(step, res)
    if (step["tokens"] == res["tokens"]).all():
        np.testing.assert_allclose(step["u"], res["u"], atol=1e-4)


@pytest.mark.parametrize("route", list(ROUTES))
def test_serve_matches_generate(pair, route):
    """Each row served through 2 slots equals its row of ``generate``
    (tokens; u within 1e-5), and a paged pool ends idle."""
    prompts = pad_prompts(CTX)
    eng = _port(pair, route)
    res = eng.generate(prompts, 6)
    fin = eng.serve([Request(rid=i, prompt=prompts[i].tolist(), max_new=6)
                     for i in range(len(CTX))], n_slots=2, decode_chunk=4)
    assert sorted(r["rid"] for r in fin) == list(range(len(CTX)))
    for r in fin:
        np.testing.assert_array_equal(r["tokens"], res["tokens"][r["rid"]])
        np.testing.assert_allclose(r["u"], res["u"][r["rid"]], atol=1e-5)
    if eng.paged:
        _assert_pool_idle(eng)


def test_bucket_padding_is_inert(pair):
    """``generate`` (the 6-token prompts bucketed to 8 columns) against the
    same prefill and decode without bucket columns: tokens equal, logits
    within 1e-6 (the padding adds exact zeros; an attention or SSD product
    over 8 columns sums in another order than over 6)."""
    prompts = pad_prompts(CTX)
    B, S = prompts.shape
    eng = _port(pair)
    res = eng.generate(prompts, 6)
    cur, last, cache = eng._prefill_absorb(prompts, S,
                                           eng._cache_len(eng._bucket(
                                               prompts)[0].shape[1], 6))
    toks, lgs, *_ = eng._dispatch("mono", cur, last, cache,
                                  eng._full(B, S), 6, True, None)
    np.testing.assert_array_equal(res["tokens"], toks.numpy())
    torch.testing.assert_close(res["logits"], lgs, atol=1e-6, rtol=0)


@pytest.mark.parametrize("route", ["mono", "kernel"])
def test_extension_resumes_bitwise(pair, route):
    """generate(4) + extend(4) == generate(8), and absorb + extend ==
    generate."""
    ctx = pad_prompts(CTX)
    eng = _port(pair, route)
    r1 = eng.generate(ctx, 4, return_state=True)
    ext = eng.generate(None, 4, state=r1["state"], return_state=True)
    long = eng.generate(ctx, 8)
    np.testing.assert_array_equal(
        np.concatenate([r1["tokens"], ext["tokens"]], axis=1),
        long["tokens"])
    ab = eng.generate(None, 6, state=eng.absorb(ctx), return_state=True)
    np.testing.assert_array_equal(ab["tokens"], long["tokens"][:, :6])
    if eng.paged:
        for st in (ext["state"], ab["state"]):
            eng.release(st)
        _assert_pool_idle(eng)


def test_reset_and_copy_rows_write_in_place():
    """``transformer.reset_rows`` / ``copy_rows`` through the pool: values
    moved, every state tensor keeps its address (captured dispatches hold
    it), KV blocks untouched."""
    tc = dataclasses.replace(TC.get_smoke(ARCHS["rglru"]), vocab_size=512,
                             dtype=torch.float32)
    pool = CachePool(tc, BLOCK, 8, 6)
    gen = torch.Generator().manual_seed(0)
    for p in TT._state_pools(pool.arrays):
        for t in p:
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    kv0 = [t.clone() for p in TT._kv_pools(pool.arrays) for t in p
           if t is not None]
    ptrs = [t.data_ptr() for p in pool.arrays for t in p if t is not None]
    before = [t.clone() for p in TT._state_pools(pool.arrays) for t in p]
    TT.copy_rows(tc, pool.arrays, [1, 4], [3, 0])
    after = [t for p in TT._state_pools(pool.arrays) for t in p]
    for b, a in zip(before, after):
        assert torch.equal(a[3], b[1]) and torch.equal(a[0], b[4])
        assert torch.equal(a[[1, 2, 4, 5, 6]], b[[1, 2, 4, 5, 6]])
    ids = pool.alloc_rows(2)                 # the lowest free rows, zeroed
    np.testing.assert_array_equal(ids, [0, 1])
    for b, a in zip(before, after):
        assert not a[[0, 1]].any() and torch.equal(a[3], b[1])
    assert [t.data_ptr() for p in pool.arrays for t in p
            if t is not None] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(
        [t for p in TT._kv_pools(pool.arrays) for t in p if t is not None],
        kv0))
    pool.free_rows(ids)
    assert pool.rows_in_use == 0
    with pytest.raises(AssertionError, match="double free"):
        pool.free_rows(ids[:1])


@pytest.mark.parametrize("route", ["mono", "kernel"])
def test_fanout_and_state_select_copy_rows(pair, route):
    """Fan a batch-1 session out to 3 rows and continue each with its own
    span: the source session stays untouched (its recurrent state too),
    each fork continues as a cold generate of its concatenation would
    (tie-aware), and on a paged engine each fork got its own row
    (``row_copies`` 3) while sharing the prefix blocks."""
    ctx = pad_prompts(CTX[:1])
    eng = _port(pair, route)
    st = eng.absorb(ctx)
    src = (_rows_of(eng, st.cache) if eng.paged
           else [t.clone() for c in st.cache for t in c])
    rc0 = eng.pool.counters["row_copies"] if eng.paged else 0
    fan = eng.fanout(st, 3)
    spans = pad_prompts(SPAN)
    res = eng.generate(spans, 5, state=fan, return_state=True)
    if eng.paged:
        assert eng.pool.counters["row_copies"] == rc0 + 3
        assert len(set(fan.cache.rows.tolist()) | {int(st.cache.rows[0])}) \
            == 4
        now = _rows_of(eng, st.cache)
    else:
        now = [t for c in st.cache for t in c]
    assert all(torch.equal(a, b) for a, b in zip(now, src))
    cold = _port(pair).generate(
        np.concatenate([np.repeat(ctx, 3, 0), spans], 1), 5)
    _tie(res, cold)
    sel = eng.state_select(st, [0])            # the source still serves
    np.testing.assert_array_equal(
        eng.generate(None, 4, state=sel)["tokens"],
        eng.generate(ctx, 4)["tokens"])
    if eng.paged:
        for h in (st, res["state"], sel):
            eng.release(h)
        _assert_pool_idle(eng)


def test_admission_waits_for_rows(pair):
    """A pool with blocks for many slots but 2 state rows admits 2 requests
    at a time: the rest wait (backpressure), every request still answers
    as ``generate`` does, and the rows all come back."""
    prompts = pad_prompts(CTX + [[5, 6, 7, 8]])
    eng = _port(pair, "kernel", pool_blocks=256, pool_rows=2)
    assert eng.pool.can_alloc(8, 2) and not eng.pool.can_alloc(8, 3)
    res = eng.generate(prompts[:2], 6)
    fin = eng.serve([Request(rid=i, prompt=prompts[i].tolist(), max_new=6)
                     for i in range(4)], n_slots=4, decode_chunk=3)
    assert eng.counters["backpressure_deferred"] > 0
    ref = _port(pair).generate(prompts, 6)
    for r in fin:
        np.testing.assert_array_equal(r["tokens"], ref["tokens"][r["rid"]])
    np.testing.assert_array_equal(res["tokens"], ref["tokens"][:2])
    _assert_pool_idle(eng)


def test_inexact_recurrent_state_is_refused(pair):
    """A handle captured after a mid-chunk stop retirement holds a state
    that absorbed the steps past the stop: a recurrent engine refuses to
    continue it, even with a prompt (the reference's rule)."""
    prompts = pad_prompts(CTX[:1])
    eng = _port(pair)
    stop = int(eng.generate(prompts, 6)["tokens"][0, 1])
    fin = eng.serve([Request(rid=0, prompt=prompts[0].tolist(), max_new=6,
                             return_state=True)],
                    n_slots=1, decode_chunk=4, stop_token=stop)
    st = fin[0]["state"]
    assert not st.exact
    with pytest.raises(ValueError, match="recurrent"):
        eng.generate(pad_prompts(SPAN[:1]), 3, state=st)


def _graph_engine(pair, route):
    eng = _port(pair, route, max_len=16)
    eng._graphs = graphs.DecodeGraphs(graphs.Rerun())
    return eng


@pytest.mark.parametrize("route", list(ROUTES))
def test_graph_route_is_bitwise_eager(pair, route):
    """Cold, continuation (which grows the 16-slot cache) and
    decode-only dispatches, then ``serve()``, through the graph layer
    (``Rerun``): the monolithic arena carries the recurrent states, a
    paged dispatch stages its row ids; tokens, logits, the returned
    states and the pools are bitwise the eager loop's."""
    outs, engines = [], []
    for graphed in (False, True):
        eng = (_graph_engine(pair, route) if graphed
               else _port(pair, route, max_len=16))
        st, res = None, []
        for prompts, n in ((pad_prompts(CTX), 6), (pad_prompts(SPAN), 4),
                           (None, 5)):
            r = eng.generate(prompts, n, state=st, return_state=True)
            st = r["state"]
            res.append((r["tokens"], r["logits"].clone(),
                        [t.clone() for c in st.cache for t in c]
                        if isinstance(st.cache, list)
                        else _rows_of(eng, st.cache)))
        fin = eng.serve([Request(rid=i, prompt=list(CTX[i]), max_new=5)
                         for i in range(3)], n_slots=2, decode_chunk=2)
        res.append(sorted((r["rid"], r["tokens"].tolist(), r["u"])
                          for r in fin))
        outs.append(res)
        engines.append(eng)
    for a, b in zip(outs[0][:3], outs[1][:3]):
        np.testing.assert_array_equal(a[0], b[0])
        assert torch.equal(a[1], b[1])
        assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
    assert outs[0][3] == outs[1][3]
    assert engines[1]._graphs.stats["replays"] >= 5
    if engines[0].paged:
        n = engines[0].pool.n_rows              # the sinks hold garbage
        for pa, pb in zip(engines[0].pool.arrays, engines[1].pool.arrays):
            served = ((pa.served(), pb.served()) if hasattr(pa, "served")
                      else ([t[:n] for t in pa], [t[:n] for t in pb]))
            for x, y in zip(*served):
                assert (x is None) == (y is None)
                if x is not None:
                    assert torch.equal(x, y)
