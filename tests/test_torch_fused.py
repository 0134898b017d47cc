"""Whole generation in one dispatch: the port of the reference's
``_generate_fused`` / ``_generate_continue`` and their paged siblings.

On the CPU the graph layer runs with its ``Rerun`` backend (a capture runs
the closure, each replay re-runs it into the capture's outputs), so the
staging of the span, its length and a continuation's start, the arena of a
warm monolithic cache and the cold cache made inside the dispatch are all
exercised without a card.  Each ``generate`` must be exactly one replay
(no decode dispatch of its own) and bitwise the eager route (the same
bodies run eagerly): tokens, logits, the Eq. 2-4 outputs, the returned
session and the pools.  A prompt set of other lengths in the same bucket
reuses the graph; the dispatch counters count as they did.

``attention._scatter_kv`` writes a span with no host sync; it is held
bitwise to the previous ``torch.nonzero`` version on cold, ring-wrapped
and out-of-range spans.  The ``gpu`` twins run the real CUDA graphs.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from repro_torch import configs as TC
from repro_torch.core.uncertainty import UncertaintyConfig
from repro_torch.kernels import build
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.models.common import ModelConfig
from repro_torch.serving import graphs
from repro_torch.serving.engine import InferenceEngine

PROMPTS = np.array([[0, 0, 3, 20, 195, 2], [3, 21, 196, 199, 2, 7],
                    [0, 0, 0, 7, 9, 2]], np.int32)
SHORTER = np.array([[0, 5, 40, 11, 2], [8, 1, 16, 99, 2],
                    [0, 0, 4, 3, 2]], np.int32)        # the same bucket (8)
SPAN = np.array([[11, 12, 0], [13, 14, 9], [15, 16, 17]], np.int32)
SPAN2 = np.array([[21, 22], [23, 24], [25, 26]], np.int32)   # bucket 8 too
ROUTES = {"mono": {}, "kernel": dict(paged=True, block_len=16),
          "gather": dict(paged=True, block_len=16,
                         attn_decode_impl="gather")}
ARCHS = ("llama3-8b", "recurrentgemma-2b", "deepseek-moe-16b")


def _model(device, arch="llama3-8b", dtype=torch.float32):
    cfg = dataclasses.replace(TC.get_smoke(arch), vocab_size=512,
                              dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    model = TT.init_params(cfg, gen, device=device)
    if arch == "recurrentgemma-2b":
        # varied greedy streams (tests/test_torch_recurrent_engine.py)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if p.ndim >= 2 and "embed" not in n and "conv" not in n:
                    p.mul_(6)
    return cfg, model


def _engine(route, device, model, graphed, **kw):
    cfg, params = model
    eng = InferenceEngine(route, cfg, params,
                          UncertaintyConfig(alpha=0.7, mode="distribution"),
                          max_len=32, device=device, **ROUTES[route], **kw)
    if not graphed:
        eng._graphs = None
    elif eng.device.type == "cpu":
        eng._graphs = graphs.DecodeGraphs(graphs.Rerun())
    return eng


def _no_decode_dispatch(eng):
    """A generate must not reach the decode dispatch: it is one fused
    replay."""
    def refuse(*a, **k):
        raise AssertionError("generate ran a separate decode dispatch")
    eng._dispatch = refuse


def _state(st):
    ts = [st.pos, st.cur, st.last]
    if isinstance(st.cache, list):
        ts += [t for c in st.cache for t in c]
    return [t.clone() for t in ts]


def _assert_res(a, b):
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert torch.equal(a["logits"], b["logits"])
    for k in ("u", "h_mean", "v_mean", "prompt_lengths"):
        np.testing.assert_array_equal(a[k], b[k])


def _pools_equal(a, b):
    if a.pool is None:
        return
    for pa, pb in zip(a.pool.arrays, b.pool.arrays):
        if not isinstance(pa, TA.KVPool):    # state rows: the sink row last
            pa, pb = [type(p)(*(t[:-1] for t in p)) for p in (pa, pb)]
        else:
            pa, pb = pa.served(), pb.served()
        for x, y in zip(pa, pb):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)


def _run(eng, greedy):
    """Cold (kept), a continuation, a second continuation of another
    length in the same bucket, a one-shot cold generate, a cold generate of
    shorter prompts in the cold bucket: per call the result and the
    session it returned."""
    out, st = [], None
    for prompts, n, keep in ((PROMPTS, 5, True), (SPAN, 4, True),
                             (SPAN2, 4, True), (PROMPTS, 5, False),
                             (SHORTER, 5, False)):
        cont = st if prompts is SPAN or prompts is SPAN2 else None
        res = eng.generate(prompts, n, greedy=greedy, seed=7, state=cont,
                           return_state=keep)
        if keep:
            st = res["state"]
        out.append((res, _state(res["state"]) if keep else None))
    return out


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("arch", ARCHS)
def test_fused_generate_is_one_replay_and_bitwise_eager(arch, route, greedy):
    model = _model("cpu", arch)
    eager = _engine(route, "cpu", model, graphed=False)
    fused = _engine(route, "cpu", model, graphed=True)
    _no_decode_dispatch(fused)
    a, b = _run(fused, greedy), _run(eager, greedy)
    for (ra, sa), (rb, sb) in zip(a, b):
        _assert_res(ra, rb)
        assert (sa is None) == (sb is None)
        if sa is not None:
            assert all(torch.equal(x, y) for x, y in zip(sa, sb))
    _pools_equal(fused, eager)
    st = fused._graphs.stats
    # five generates, one replay each; the cold bucket's graph serves the
    # one-shot and the shorter prompts (kept and one-shot monolithic
    # caches are two keys), both continuations share one graph
    assert st["replays"] == 5
    assert st["captures"] == (3 if route == "mono" else 2)
    assert fused.counters == eager.counters
    assert fused.counters["prefill"] == 3
    assert fused.counters["prefill_continue"] == 2


@pytest.mark.parametrize("route", list(ROUTES))
def test_counts_credited_per_fused_replay(route):
    """The kernels' (here: plain versions') launch counts of a replayed
    generate equal the eager route's, on the capture and on a replay."""
    model = _model("cpu")

    def counted(eng, prompts):
        before = build.snapshot()
        eng.generate(prompts, 5)
        return build.since(before)
    want = counted(_engine(route, "cpu", model, graphed=False), PROMPTS)
    fused = _engine(route, "cpu", model, graphed=True)
    assert counted(fused, PROMPTS) == want
    assert counted(fused, SHORTER) == want
    assert fused._graphs.stats["captures"] == 1


def test_one_shot_cold_generate_copies_no_cache():
    """A cold monolithic generate that keeps no session makes its cache
    inside the dispatch and copies none of it out; keeping the session
    copies it out once."""
    model = _model("cpu")
    eng = _engine("mono", "cpu", model, graphed=True)
    eng.generate(PROMPTS, 5)
    assert eng._graphs.stats["io_bytes"] == 0
    r = eng.generate(PROMPTS, 5, return_state=True)
    cache_bytes = sum(t.nbytes for c in r["state"].cache for t in c)
    assert eng._graphs.stats["io_bytes"] == cache_bytes
    # the continuation copies the session's cache in and out of the arena
    eng.generate(SPAN, 4, state=r["state"])
    assert eng._graphs.stats["io_bytes"] == 3 * cache_bytes


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "fused"])
def test_positions_must_agree_before_the_dispatch(graphed):
    """Sessions at different positions are refused before the dispatch
    (the check reads the positions on the host, outside the capture)."""
    eng = _engine("mono", "cpu", _model("cpu"), graphed=graphed)
    a = eng.generate(PROMPTS[:1], 3, return_state=True)["state"]
    b = eng.generate(PROMPTS[1:2, 2:], 3, return_state=True)["state"]
    st = eng.state_select(a, [0, 0])
    st.pos = torch.cat([a.pos, b.pos])
    with pytest.raises(ValueError, match="same positions"):
        eng.generate(SPAN[:2], 2, state=st)
    with pytest.raises(ValueError, match="same positions"):
        eng.absorb(SPAN[:2], state=st)
    with pytest.raises(ValueError, match="same positions"):
        TT.prefill(eng.params, eng.cfg, torch.as_tensor(SPAN[:2]),
                   st.cache, torch.stack([st.pos, st.pos + 1], 1).int(),
                   continuation=True)


# ---------------------------------------------------------------------------
# _scatter_kv without a host sync, against the nonzero version
# ---------------------------------------------------------------------------

def _scatter_kv_nonzero(cache, k, v, positions, cfg, local):
    """The previous implementation (``torch.nonzero`` over the kept
    columns), the oracle."""
    B, S = positions.shape
    T = cache.k.shape[1]
    ring = local and cfg.window is not None
    if ring and S > T:
        pmax = positions.max(dim=1, keepdim=True).values
        positions = torch.where(positions > pmax - T, positions, -1)
    slot = positions % T if ring else positions
    b, s = torch.nonzero((positions >= 0) & (slot < T), as_tuple=True)
    sl = slot[b, s]
    cache.k.index_put_((b, sl), k[b, s].to(cache.k.dtype))
    cache.v.index_put_((b, sl), v[b, s].to(cache.v.dtype))
    cache.pos.index_put_((b, sl), positions[b, s].to(torch.int32))
    return cache


SPANS = {
    # cold: left-padded, positions -2, -1, 0..5 on a 16-slot cache
    "cold": (16, None, lambda B, S: torch.arange(S) - 2),
    # warm: right-padded continuation at 9.., padding negative
    "warm": (16, None, lambda B, S: torch.where(
        torch.arange(S) < 5, 9 + torch.arange(S), torch.arange(S) - S)),
    # positions past the cache are dropped (JAX's out-of-bounds scatter)
    "past_end": (8, None, lambda B, S: torch.arange(S) + 4),
    # a ring of 8 slots (window 8) taking 12 positions: only the last 8
    "ring_wrapped": (8, 8, lambda B, S: torch.arange(S) + 3),
    # a ring continuation that wraps part-way
    "ring_partial": (8, 8, lambda B, S: torch.where(
        torch.arange(S) < 6, 5 + torch.arange(S), torch.arange(S) - S)),
    # nothing kept in the span: every column is padding
    "all_padding": (8, None, lambda B, S: torch.arange(S) - S),
}


@pytest.mark.parametrize("case", list(SPANS))
def test_scatter_kv_is_bitwise_the_nonzero_version(case):
    T, window, pos_fn = SPANS[case]
    B, S, K, D = 3, 12, 2, 8
    cfg = ModelConfig(name="t", vocab_size=16, d_model=16, num_layers=1,
                      num_heads=2, num_kv_heads=K, head_dim=D, d_ff=32,
                      window=window, dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    k = torch.randn((B, S, K, D), generator=g)
    v = torch.randn((B, S, K, D), generator=g)
    positions = pos_fn(B, S).to(torch.int32)[None].expand(B, S).clone()
    if case == "warm":                 # one row at other positions
        positions[1] = torch.where(positions[1] >= 0, positions[1] + 1,
                                   positions[1])
    caches = []
    for _ in range(2):
        c = TA.KVCache(torch.randn((B, T, K, D), generator=torch.Generator(
            ).manual_seed(9)), torch.randn((B, T, K, D),
                                           generator=torch.Generator(
                                           ).manual_seed(10)),
            torch.full((B, T), -1, dtype=torch.int32))
        caches.append(c)
    local = window is not None
    TA._scatter_kv(caches[0], k, v, positions, cfg, local)
    _scatter_kv_nonzero(caches[1], k, v, positions, cfg, local)
    for x, y in zip(*caches):
        assert torch.equal(x, y)
    if case != "all_padding":
        assert (caches[0].pos >= 0).any()


# ---------------------------------------------------------------------------
# the card: the real CUDAGraph route
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_fused_generate_is_bitwise_eager(cuda, arch, route, greedy):
    """On the card, bf16 (f32 for the recurrent smoke, whose bf16 prefill
    is the least likely to hide nothing): the whole generate captured
    (rows 1, 2 or 5 and 3 inside the graph), one replay per call, bitwise
    the eager route."""
    dtype = torch.float32 if arch == "recurrentgemma-2b" else torch.bfloat16
    model = _model(cuda, arch, dtype)
    eager = _engine(route, cuda, model, graphed=False)
    fused = _engine(route, cuda, model, graphed=True)
    assert isinstance(fused._graphs.backend, graphs.CudaGraphs)
    _no_decode_dispatch(fused)
    a, b = _run(fused, greedy), _run(eager, greedy)
    for (ra, sa), (rb, sb) in zip(a, b):
        _assert_res(ra, rb)
        if sa is not None:
            assert all(torch.equal(x, y) for x, y in zip(sa, sb))
    _pools_equal(fused, eager)
    assert fused._graphs.stats["replays"] == 5
    assert fused.counters == eager.counters


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(ROUTES))
def test_cuda_fused_counts_and_no_sync(cuda, route):
    """On the card: the eager route's body syncs nothing (``set_sync_debug_
    mode("error")`` around it), and a replayed generate credits the eager
    route's launches."""
    model = _model(cuda, dtype=torch.bfloat16)
    eager = _engine(route, cuda, model, graphed=False)
    body = eager._generate_body

    def checked(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return body(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    eager._generate_body = checked

    def counted(eng, prompts):
        before = build.snapshot()
        eng.generate(prompts, 5)
        torch.cuda.synchronize()
        return build.since(before)
    want = counted(eager, PROMPTS)
    fused = _engine(route, cuda, model, graphed=True)
    assert counted(fused, PROMPTS) == want
    assert counted(fused, SHORTER) == want
    assert fused._graphs.stats["captures"] == 1
