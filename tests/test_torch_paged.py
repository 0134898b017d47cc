"""The port's paged block-pool engine (``InferenceEngine(paged=True)``,
``serving/cache_manager.py``), mirroring tests/test_paged_cache.py,
test_kernel_decode.py and test_quantized.py.

Setup: the smoke llama3-8b (an untied head, whose greedy streams vary) in
f32, vocabulary 512, blocks of 16 slots, weights from the JAX
``init_params`` converted by ``convert.from_jax_params``.

* ``attn_decode_impl="gather"`` equals the port's monolithic engine
  bitwise, tokens and logits: the gathered view is the monolithic cache
  elementwise, and the same code runs on it;
* ``"kernel"`` (the block-table op, its plain version here) equals
  ``"gather"`` to 1e-5 in f32, tie-aware: the same keys in another order,
  the covered slots masked and the delta rows appended;
* growth appends blocks (``grow_copy`` stays 0), trimming bounds the pool,
  fan-out costs one prefill, shared blocks are never written through (their
  bytes before and after), a ring layer's shared blocks are COW-copied,
  released or evicted handles raise, TTL eviction spares excluded handles,
  famine defers admission and ``overload="shed"`` sheds;
* int8/fp8 pools keep logits within 0.02 of the bf16 paged engine (the
  reference's budget for attention archs);
* against the JAX paged engine on the same weights: tokens tie-aware at
  1e-4, and after the same calls the pools agree — block tables and
  positions exactly, k/v to 1e-5 — through ``convert.from_jax_paged_pool``.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from test_torch_continuation import CTX, SPAN, SPAN2, pair
from test_torch_engine import assert_greedy_match_modulo_ties

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.uncertainty import UncertaintyConfig as JU  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.swarm import pad_prompts  # noqa: E402
from repro_torch.convert import (from_jax_paged_pool,  # noqa: E402
                                 from_jax_params)
from repro_torch.core.uncertainty import UncertaintyConfig as TU  # noqa: E402
from repro_torch.serving.cache_manager import \
    EvictedSessionError  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.serving.faults import PoolExhaustedError  # noqa: E402
from repro_torch.serving.scheduler import Request  # noqa: E402
from repro_torch.serving.swarm import SwarmExecutor as TSX  # noqa: E402

BLOCK = 16
UC = dict(mode="distribution")


@pytest.fixture(scope="module")
def models():
    return pair()


def _eng(model_tuple, name="e", **kw):
    _, _, tc, model = model_tuple
    return TEngine(name, tc, model, TU(**UC), device="cpu", **kw)


def _paged(models, **kw):
    return _eng(models, "paged", paged=True, block_len=BLOCK, **kw)


def _np(res):
    return {**res, "logits": np.asarray(res["logits"])}


def _bitwise(a, b):
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert torch.equal(a["logits"], b["logits"])


def _block_bytes(eng, ids):
    """Every pool field's bytes at blocks ``ids``, across all layers."""
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.long)
    return [t.view(torch.uint8).index_select(0, ids).clone()
            if t.dtype == torch.float8_e4m3fn else t.index_select(0, ids)
            .clone() for pool in eng.pool.arrays for t in pool
            if t is not None]


def _same_bytes(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


class TestParity:
    @pytest.mark.parametrize("impl", ["gather", "kernel"])
    def test_generate(self, models, impl):
        mono = _eng(models)
        paged = _paged(models, attn_decode_impl=impl)
        prompts = pad_prompts(CTX)
        r0, r1 = mono.generate(prompts, 8), paged.generate(prompts, 8)
        if impl == "gather":
            _bitwise(r0, r1)
        else:
            assert_greedy_match_modulo_ties(_np(r1), _np(r0), atol=1e-5)
        assert paged.pool.blocks_in_use == 0            # one-shot: freed

    @pytest.mark.parametrize("impl", ["gather", "kernel"])
    def test_warm_continuation_and_extension(self, models, impl):
        mono = _eng(models)
        paged = _paged(models, attn_decode_impl=impl)
        ctx, span = pad_prompts(CTX), pad_prompts(SPAN)
        outs = []
        for eng in (mono, paged):
            a = eng.generate(ctx, 5, return_state=True)
            b = eng.generate(span, 6, state=a["state"], return_state=True)
            c = eng.generate(None, 7, state=b["state"])
            outs.append((a, b, c))
        for r0, r1 in zip(*outs):
            if impl == "gather":
                _bitwise(r0, r1)
            else:
                assert_greedy_match_modulo_ties(_np(r1), _np(r0), atol=1e-5)
        assert paged.counters["grow_copy"] == 0

    @pytest.mark.parametrize("impl", ["gather", "kernel"])
    def test_serve(self, models, impl):
        mono = _eng(models)
        paged = _paged(models, attn_decode_impl=impl)
        prompts = pad_prompts(CTX + SPAN)
        reqs = lambda: [Request(rid=i, prompt=prompts[i].tolist(),  # noqa
                                max_new=7) for i in range(len(prompts))]
        f0 = {r["rid"]: r for r in mono.serve(reqs(), n_slots=2,
                                               decode_chunk=3)}
        f1 = {r["rid"]: r for r in paged.serve(reqs(), n_slots=2,
                                                decode_chunk=3)}
        for rid in f0:
            np.testing.assert_array_equal(f1[rid]["tokens"],
                                          f0[rid]["tokens"])
            assert f1[rid]["u"] == pytest.approx(f0[rid]["u"], abs=1e-5)
        assert paged.pool.blocks_in_use == 0

    def test_paged_engine_checks(self, models):
        with pytest.raises(ValueError, match="paged"):
            _eng(models, cache_quant="int8")
        with pytest.raises(ValueError, match="quantization mode"):
            _paged(models, cache_quant="int4")
        with pytest.raises(ValueError, match="attn_decode_impl"):
            _paged(models, attn_decode_impl="scan")
        local = pair(mixer_pattern=("attn", "attn_local"), window=24)
        with pytest.raises(ValueError, match="must divide"):
            _paged(local)
        assert _paged(models).attn_decode_impl == "kernel"


class TestGrowthAndSharing:
    def test_multiturn_growth_appends_blocks(self, models):
        mono, paged = _eng(models), _paged(models)
        rng = np.random.RandomState(0)
        ctx = rng.randint(7, 512, size=(2, 56)).astype(np.int32)
        turn = rng.randint(7, 512, size=(2, 32)).astype(np.int32)
        r0 = mono.generate(ctx, 8, return_state=True)
        r1 = paged.generate(ctx, 8, return_state=True)
        allocs = [paged.pool.counters["blocks_alloc"]]
        for _ in range(4):                      # outgrows max_len=128
            r0 = mono.generate(turn, 8, state=r0["state"], return_state=True)
            r1 = paged.generate(turn, 8, state=r1["state"],
                                return_state=True)
            assert_greedy_match_modulo_ties(_np(r1), _np(r0), atol=1e-5)
            allocs.append(paged.pool.counters["blocks_alloc"])
        assert mono.counters["grow_copy"] > 0
        assert paged.counters["grow_copy"] == 0
        assert (np.diff(allocs) <= 2 * 2 * (64 // BLOCK)).all(), allocs

    def test_session_trim_bounds_pool_usage(self, models):
        paged = _paged(models)
        st = paged.absorb(pad_prompts(CTX)[:1])
        covered = st.cache.tables.shape[1]
        assert covered == -(-st.offset // BLOCK)
        assert covered * BLOCK < st.max_len
        paged.release(st)
        assert paged.pool.blocks_in_use == 0

    def test_fanout_issues_exactly_one_prefill(self, models):
        mono, paged = _eng(models), _paged(models, attn_decode_impl="gather")
        ctx = pad_prompts(CTX)[:1]
        out = paged.generate(None, 6, state=paged.fanout(paged.absorb(ctx),
                                                         8))
        assert paged.counters["prefill"] == 1
        assert paged.counters["prefill_continue"] == 0
        ref = mono.generate(None, 6, state=mono.fanout(mono.absorb(ctx), 8))
        _bitwise(out, ref)

    def test_fanout_continuation_matches_cold_concat(self, models):
        mono, paged = _eng(models), _paged(models)
        ctx = pad_prompts(CTX)[:1]
        n = 4
        spans = pad_prompts([[30 + k, 31 + k, 2] for k in range(n)],
                            align="right")
        warm = paged.generate(spans, 5, state=paged.fanout(
            paged.absorb(ctx), n))
        assert paged.counters["prefill"] == 1
        cold = mono.generate(
            np.concatenate([np.tile(ctx, (n, 1)), spans], axis=1), 5)
        assert_greedy_match_modulo_ties(_np(warm), _np(cold), atol=1e-4)

    def test_shared_blocks_never_written_through(self, models):
        paged = _paged(models)
        st = paged.absorb(pad_prompts(CTX)[:1])
        shared = st.cache.tables[0].copy()
        before = _block_bytes(paged, shared)
        fan = paged.fanout(st, 4)
        spans = pad_prompts([[40 + k, 2] for k in range(4)], align="right")
        r = paged.generate(spans, 6, state=fan, return_state=True)
        paged.generate(None, 5, state=r["state"])
        _same_bytes(before, _block_bytes(paged, shared))
        assert paged.pool.counters["cow_copies"] >= 1
        assert (paged.pool.ref[shared] >= 1).all()      # st still holds them

    def test_state_select_cows_the_tail_and_keeps_the_source(self, models):
        """On a paged engine ``state_select`` is a refcounted table copy;
        extending the selection COW-copies the shared tail block, so the
        source handle's blocks keep their bytes and the source extends as
        if the selection never ran."""
        paged = _paged(models)
        ref = _paged(models)
        a = paged.generate(pad_prompts(CTX), 5, return_state=True)["state"]
        src = a.cache.tables.copy()
        before = _block_bytes(paged, src.ravel())
        sel = paged.state_select(a, [2, 0, 0])
        assert (paged.pool.ref[src[0]] == 3).all()
        paged.generate(None, 9, state=sel)
        _same_bytes(before, _block_bytes(paged, src.ravel()))
        b = ref.generate(pad_prompts(CTX), 5, return_state=True)["state"]
        _bitwise(paged.generate(None, 4, state=a),
                 ref.generate(None, 4, state=b))

    def test_fanout_ring_wrap_cows_local_blocks(self):
        """A fork writing past the local window wraps into the ring's FIRST
        blocks, below the linear write position: COW must copy them per fork
        (``CachePool.ring_blocks``) or the forks write through each other.
        Dense smoke variant: every other layer local with window 32."""
        local = pair(mixer_pattern=("attn", "attn_local"), window=32)
        mono, paged = _eng(local), _paged(local)
        assert paged.pool.ring_blocks == 2
        rng = np.random.RandomState(3)
        ctx = rng.randint(7, 512, size=(1, 40)).astype(np.int32)
        n = 3
        spans = pad_prompts([[60 + 7 * k, 61 + 7 * k, 2] for k in range(n)],
                            align="right")
        out = paged.generate(spans, 8, state=paged.fanout(paged.absorb(ctx),
                                                          n),
                             return_state=True)
        ref = mono.generate(spans, 8, state=mono.fanout(mono.absorb(ctx), n),
                            return_state=True)
        assert_greedy_match_modulo_ties(_np(out), _np(ref), atol=1e-5)
        out2 = paged.generate(None, 8, state=out["state"])
        ref2 = mono.generate(None, 8, state=ref["state"])
        assert_greedy_match_modulo_ties(_np(out2), _np(ref2), atol=1e-5)

    def test_serve_fans_shared_handle_across_requests(self, models):
        paged = _paged(models)
        st = paged.absorb(pad_prompts(CTX)[:1])
        oracle = paged.generate(None, 6, state=paged.fanout(st, 1))
        assert paged.counters["prefill"] == 1
        fin = paged.serve([Request(rid=k, prompt=[], max_new=6, state=st)
                           for k in range(6)], n_slots=3, decode_chunk=3)
        assert paged.counters["prefill"] == 1
        assert len(fin) == 6
        for r in fin:
            np.testing.assert_array_equal(r["tokens"], oracle["tokens"][0])

    def test_serve_handback_and_warm_readmission(self, models):
        mono, paged = _eng(models), _paged(models, attn_decode_impl="gather")
        prompts = pad_prompts(CTX)

        def two_turns(eng):
            fin = eng.serve([Request(rid=i, prompt=prompts[i].tolist(),
                                     max_new=4, return_state=True)
                             for i in range(3)], n_slots=3, decode_chunk=4)
            states = {r["rid"]: r["state"] for r in fin}
            fin2 = eng.serve([Request(rid=i, prompt=SPAN[i], max_new=4,
                                      state=states[i]) for i in range(3)],
                             n_slots=3, decode_chunk=4)
            return ({r["rid"]: r["tokens"] for r in fin},
                    {r["rid"]: r["tokens"] for r in fin2})
        for m, p in zip(two_turns(mono), two_turns(paged)):
            for rid in m:
                np.testing.assert_array_equal(p[rid], m[rid])

    def test_swarm_deepening_off_paged_probe(self, models):
        """The gateway handoff on a paged probe: ``state_select`` is a
        table copy and deepening extends decode-only — no prefill beyond the
        probe's own, the deepened answers those of a monolithic probe."""
        mono, paged = _eng(models), _paged(models, attn_decode_impl="gather")
        prompts = pad_prompts(CTX)
        idx = np.arange(len(CTX))

        def deepen(probe):
            res = probe.generate(prompts, 4, return_state=True)
            pre = {0: (res["tokens"], res["u"],
                       (res["h_mean"], res["v_mean"]))}
            return TSX([probe, mono]).collaborate(
                prompts, 8, precomputed=pre,
                states={0: probe.state_select(res["state"], idx)})
        out_m, out_p = deepen(mono), deepen(paged)
        assert paged.counters["prefill"] == 1
        np.testing.assert_array_equal(out_m["answers"], out_p["answers"])


class TestEviction:
    def test_released_handle_raises(self, models):
        paged = _paged(models)
        st = paged.absorb(pad_prompts(CTX)[:1])
        paged.release(st)
        with pytest.raises(EvictedSessionError):
            paged.generate(None, 2, state=st)
        with pytest.raises(ValueError, match="monolithic"):
            _eng(models).generate(None, 2, state=st)

    def test_ttl_eviction_invalidates_and_frees(self, models):
        paged = _paged(models)
        clock = [0.0]
        paged.pool._clock = lambda: clock[0]
        st = paged.absorb(pad_prompts(CTX)[:1])
        assert paged.pool.blocks_in_use > 0
        clock[0] = 100.0
        assert paged.evict_idle_sessions(ttl_s=50.0) == 1
        assert paged.pool.blocks_in_use == 0
        with pytest.raises(EvictedSessionError):
            paged.generate(None, 2, state=st)

    def test_evict_idle_spares_excluded_handles(self, models):
        paged = _paged(models)
        clock = [0.0]
        paged.pool._clock = lambda: clock[0]
        st = paged.absorb(pad_prompts(CTX)[:1])
        clock[0] = 100.0
        assert paged.pool.evict_idle(1.0, exclude={st.cache.sid}) == 0
        paged.pool.check(st.cache)
        clock[0] = 200.0
        assert paged.pool.evict_idle(1.0) == 1

    def test_churn_keeps_high_water_bounded(self, models):
        paged = _paged(models, pool_blocks=64)
        clock = [0.0]
        paged.pool._clock = lambda: clock[0]
        prompts = pad_prompts(CTX)
        for _ in range(12):
            paged.generate(prompts, 6, return_state=True)   # leaked session
            clock[0] += 10.0
            paged.evict_idle_sessions(ttl_s=5.0)
        one_gen = 3 * (128 // BLOCK)
        assert paged.pool.counters["high_water"] <= 2 * one_gen
        assert paged.pool.blocks_in_use == 0

    def test_evicted_warm_request_reprefills_cold(self, models):
        paged = _paged(models)
        prompts = pad_prompts(CTX)
        st = paged.absorb(prompts[:1])
        paged.release(st)
        fin = paged.serve([Request(rid=0, prompt=SPAN[0], max_new=4,
                                   state=st,
                                   cold_prompt=prompts[0].tolist())],
                          n_slots=1)
        assert paged.counters["reprefill_cold"] == 1
        np.testing.assert_array_equal(fin[0]["tokens"],
                                      paged.generate(prompts[:1],
                                                     4)["tokens"][0])


class TestFamine:
    def test_serve_pool_famine_defers_admission(self, models):
        """A pool sized for ~two slots serves a deeper queue: vetoed
        admissions wait for retirements (counted per round) instead of
        failing."""
        paged = _paged(models, pool_blocks=2 * (128 // BLOCK))
        prompts = pad_prompts(CTX)
        res = paged.serve([Request(rid=i, prompt=prompts[i % 3].tolist(),
                                   max_new=4) for i in range(5)],
                          n_slots=4, decode_chunk=4)
        assert len(res) == 5 and not any(r.get("shed") for r in res)
        assert paged.counters["backpressure_deferred"] > 0
        assert paged.counters["famine_deferred"] == 0   # injected only
        assert paged.pool.blocks_in_use == 0

    def test_wedged_pool_sheds_or_raises(self, models):
        """Nothing decoding and nothing admissible: ``overload="shed"``
        retires queued requests shed=True, ``"raise"`` raises."""
        paged = _paged(models, pool_blocks=16)
        held = paged.pool.alloc_blocks(10)     # a slot needs 128/16 = 8
        reqs = lambda: [Request(rid=i, prompt=[3, 4, 5], max_new=2)  # noqa
                        for i in range(2)]
        fin = paged.serve(reqs(), n_slots=2, overload="shed")
        assert [r.get("shed") for r in fin] == [True, True]
        assert paged.counters["shed"] == 2
        with pytest.raises(PoolExhaustedError, match="exhausted"):
            paged.serve(reqs(), n_slots=2)
        paged.pool.free_blocks(held)
        assert len(paged.serve(reqs(), n_slots=2)) == 2


class TestQuantizedPools:
    @pytest.fixture(scope="class")
    def bf16(self, models):
        _, p, tc, _ = models
        tcb = dataclasses.replace(tc, dtype=torch.bfloat16)
        return None, None, tcb, from_jax_params(jax.tree.map(np.asarray, p),
                                                tcb)

    @pytest.mark.parametrize("quant", ["int8", "fp8"])
    def test_generate_within_budget(self, bf16, quant):
        base, qeng = _paged(bf16), _paged(bf16, cache_quant=quant)
        prompts = pad_prompts(CTX)
        r0, r1 = base.generate(prompts, 6), qeng.generate(prompts, 6)
        np.testing.assert_array_equal(r0["tokens"], r1["tokens"])
        np.testing.assert_allclose(r1["logits"].float().numpy(),
                                   r0["logits"].float().numpy(), atol=0.02,
                                   rtol=0)
        assert qeng.pool.arrays[0].k.dtype == (
            torch.int8 if quant == "int8" else torch.float8_e4m3fn)
        assert qeng.pool.block_bytes < base.pool.block_bytes

    def test_warm_continuation_within_budget(self, bf16):
        base, qeng = _paged(bf16), _paged(bf16, cache_quant="int8")
        prompts, span = pad_prompts(CTX), pad_prompts(SPAN)
        w = [e.generate(span, 6, state=e.absorb(prompts), return_state=True)
             for e in (base, qeng)]
        np.testing.assert_array_equal(w[0]["tokens"], w[1]["tokens"])
        np.testing.assert_allclose(w[1]["logits"].float().numpy(),
                                   w[0]["logits"].float().numpy(), atol=0.02,
                                   rtol=0)
        e = [eng.generate(None, 4, state=r["state"])
             for eng, r in zip((base, qeng), w)]
        np.testing.assert_array_equal(e[0]["tokens"], e[1]["tokens"])

    @pytest.mark.parametrize("quant", ["int8", "fp8"])
    def test_kernel_vs_gathered_oracle(self, bf16, quant):
        """On a quantized pool the two decode paths are not bitwise: the
        gather path dequantizes the view to bf16 before the monolithic
        decode, the kernel path scales f32 scores and weights.  They agree
        within the quantized budget, with the same tokens."""
        ker = _paged(bf16, cache_quant=quant)
        gat = _paged(bf16, cache_quant=quant, attn_decode_impl="gather")
        prompts = pad_prompts(CTX)
        r0, r1 = gat.generate(prompts, 6), ker.generate(prompts, 6)
        np.testing.assert_array_equal(r0["tokens"], r1["tokens"])
        d = (r1["logits"].float() - r0["logits"].float()).abs().max()
        assert 0.0 < float(d) <= 0.02

    def test_quantized_shared_blocks_and_scales_untouched(self, bf16):
        qeng = _paged(bf16, cache_quant="fp8")
        st = qeng.absorb(pad_prompts(CTX)[:1])
        shared = st.cache.tables[0].copy()
        before = _block_bytes(qeng, shared)
        qeng.generate(pad_prompts([[40 + k, 2] for k in range(3)],
                                  align="right"), 5,
                      state=qeng.fanout(st, 3))
        _same_bytes(before, _block_bytes(qeng, shared))


class TestAgainstJax:
    def test_pools_and_tokens_after_the_same_calls(self, models):
        """The same sequence of generate, absorb, fanout, continuation and
        serve on the JAX paged engine and the port's: tokens tie-aware;
        the allocator is deterministic, so the handles' tables and the
        position pools are equal exactly, and k/v agree to 1e-5."""
        jc, p, tc, model = models
        kw = dict(paged=True, block_len=BLOCK, pool_blocks=96)
        je = JEngine("j", jc, p, JU(**UC), **kw)
        te = TEngine("t", tc, model, TU(**UC), device="cpu", **kw)
        ctx, span = pad_prompts(CTX), pad_prompts(SPAN)
        outs, handles = [], []
        for eng in (je, te):
            g = eng.generate(ctx, 5, return_state=True)
            c = eng.generate(span, 4, state=g["state"], return_state=True)
            st = eng.absorb(ctx[:1])
            fan = eng.fanout(st, 3)
            f = eng.generate(pad_prompts(SPAN2), 4, state=fan,
                             return_state=True)
            s = eng.serve([Request(rid=k, prompt=[], max_new=5, state=st,
                                   return_state=True) for k in range(2)],
                          n_slots=2, decode_chunk=3)
            s = sorted(s, key=lambda r: r["rid"])
            outs.append((g, c, f))
            handles.append([g["state"], c["state"], st, f["state"]]
                           + [r["state"] for r in s])
            outs[-1] += tuple({"tokens": r["tokens"][None]} for r in s)
        for t, j in zip(outs[1][:3], outs[0][:3]):
            assert_greedy_match_modulo_ties(_np(t), _np(j), atol=1e-4)
            np.testing.assert_array_equal(t["tokens"], j["tokens"])
        for t, j in zip(outs[1][3:], outs[0][3:]):
            np.testing.assert_array_equal(t["tokens"], j["tokens"])
        for ht, hj in zip(handles[1], handles[0]):
            np.testing.assert_array_equal(ht.cache.tables, hj.cache.tables)
            assert ht.offset == hj.offset
            np.testing.assert_array_equal(ht.pos.numpy(), np.asarray(hj.pos))
        np.testing.assert_array_equal(te.pool.ref, je.pool.ref)
        assert te.pool.counters == je.pool.counters
        jpool = from_jax_paged_pool(
            jax.tree.map(np.asarray, je.pool.arrays), tc)
        for pj, pt in zip(jpool, te.pool.arrays):
            sj, st_ = pj.served(), pt.served()
            assert torch.equal(st_.pos, sj.pos)
            for a, b in ((st_.k, sj.k), (st_.v, sj.v)):
                torch.testing.assert_close(a, b, atol=1e-5, rtol=0)

    @pytest.mark.parametrize("quant", ["int8", "fp8"])
    def test_quantized_pools_against_jax(self, models, quant):
        """A quantized pool after the same generate: positions and
        scales-and-payload shape exactly, payload bytes equal where the
        rows agree to the quantization step."""
        jc, p, tc, model = models
        jcb = dataclasses.replace(jc, dtype=jnp.bfloat16)
        tcb = dataclasses.replace(tc, dtype=torch.bfloat16)
        kw = dict(paged=True, block_len=BLOCK, pool_blocks=32,
                  cache_quant=quant)
        je = JEngine("j", jcb, p, JU(**UC), **kw)
        te = TEngine("t", tcb, from_jax_params(jax.tree.map(np.asarray, p),
                                               tcb), TU(**UC), device="cpu",
                     **kw)
        ctx = pad_prompts(CTX)
        rj = je.generate(ctx, 6, return_state=True)
        rt = te.generate(ctx, 6, return_state=True)
        np.testing.assert_array_equal(rt["tokens"], rj["tokens"])
        np.testing.assert_array_equal(rt["state"].cache.tables,
                                      rj["state"].cache.tables)
        arrays = jax.tree.map(
            lambda a: np.asarray(a.view(jnp.uint8)
                                 if a.dtype == jnp.float8_e4m3fn else a),
            je.pool.arrays)
        for pj, pt in zip(from_jax_paged_pool(arrays, tcb), te.pool.arrays):
            sj, st_ = pj.served(), pt.served()
            assert st_.k.dtype == sj.k.dtype
            assert torch.equal(st_.pos, sj.pos)
            # dequantized rows agree to the storage format's step: the
            # bf16 activations that were quantized differ by an ulp
            for q, s, qj, sj_ in ((st_.k, st_.k_scale, sj.k, sj.k_scale),
                                  (st_.v, st_.v_scale, sj.v, sj.v_scale)):
                a = q.float() * s[..., None]
                b = qj.float() * sj_[..., None]
                step = 2 * torch.maximum(s, sj_)[..., None] * (
                    1.0 if quant == "int8" else 32.0)
                assert bool(((a - b).abs() <= step + 1e-6).all())


def test_sentinel_writes_land_in_the_sink(models):
    """Writes through a sentinel table entry, past the table or from an
    unwritten delta row go to the pool's sink block (block N), never to a
    served block; a ring dispatch longer than its ring writes only its last
    ring-length rows."""
    from repro_torch.models import attention as A
    _, _, tc, _ = models
    pool = A.init_paged_kv(tc, 4, BLOCK)
    table = torch.tensor([[0, 1], [4, 4]], dtype=torch.int32)  # row 1 empty
    delta = A.init_decode_delta(tc, 2, 3)
    delta.k.fill_(1.0)
    delta.v.fill_(2.0)
    delta.pos[0] = torch.tensor([5, 6, -1], dtype=torch.int32)
    delta.pos[1] = torch.tensor([40, 41, 42], dtype=torch.int32)
    A.paged_scatter_delta(pool, table, delta,
                          torch.tensor([5, 40], dtype=torch.int32))
    served = pool.served()
    assert served.pos[0, 5:7].tolist() == [5, 6]
    assert int((served.pos >= 0).sum()) == 2            # nothing else
    assert float(served.k.abs().sum()) == 2 * tc.num_kv_heads * tc.head_dim
    assert int(pool.pos[4, 0]) in (-1, 40, 41, 42)      # the sink's row 0
    assert (pool.pos[4, 1:] == -1).all()
    ring = A.init_paged_kv(tc, 4, BLOCK)
    long = A.init_decode_delta(tc, 1, 3 * BLOCK)
    long.pos[0] = torch.arange(3 * BLOCK, dtype=torch.int32)
    long.k[0] = long.pos[0].float()[:, None, None]
    A.paged_scatter_delta(ring, torch.tensor([[2]], dtype=torch.int32), long,
                          torch.tensor([0], dtype=torch.int32), window=BLOCK)
    assert ring.pos[2].tolist() == list(range(2 * BLOCK, 3 * BLOCK))
    assert ring.k[2, :, 0, 0].tolist() == list(range(2 * BLOCK, 3 * BLOCK))
