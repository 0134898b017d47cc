"""Captured decode dispatches (``repro_torch.serving.graphs``) against the
engine's eager decode loop, the oracle.

On the CPU the graph layer runs with its ``Rerun`` backend (each replay
re-runs the captured closure into the capture's outputs), so the plumbing
is exercised without a card: staging buffers, the monolithic arena, the
sentinel table a capture sees, the generator hand-off of a sampling graph,
clones out of the static outputs, launch (here: plain-version) counts
credited per replay, the bounded cache and the chunk-length keys of a
``serve()`` loop.  The ``gpu``-marked cases hold the real
``torch.cuda.CUDAGraph`` route to the eager loop on the card, bitwise.

Every comparison is bitwise: the two routes run the same operations on the
same values (tokens, logits, Eq. 2-3 means, the returned ``SessionState``,
and the caches or pools the dispatches wrote).
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from repro_torch import configs as TC
from repro_torch.core.uncertainty import UncertaintyConfig
from repro_torch.kernels import build
from repro_torch.models import transformer as TT
from repro_torch.serving import graphs
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.scheduler import Request

PROMPTS = np.array([[0, 0, 3, 20, 195, 2], [3, 21, 196, 199, 2, 7],
                    [0, 0, 0, 7, 9, 2]], np.int32)
OTHER = np.array([[0, 0, 5, 40, 11, 2], [8, 1, 16, 99, 2, 7],
                  [0, 0, 0, 4, 3, 2]], np.int32)
SPAN = np.array([[11, 12], [13, 14], [15, 16]], np.int32)
ROUTES = {"mono": {}, "kernel": dict(paged=True),
          "gather": dict(paged=True, attn_decode_impl="gather")}


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    return torch.device("cuda")


MOE_ARCHS = ("deepseek-moe-16b", "llama4-scout-17b-a16e")


def _model(device, dtype=torch.float32, arch="llama3-8b"):
    cfg = dataclasses.replace(TC.get_smoke(arch), vocab_size=512,
                              dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, TT.init_params(cfg, gen, device=device)


def _engine(route, device, model, graphed, max_graphs=16, **kw):
    cfg, params = model
    eng = InferenceEngine(route, cfg, params,
                          UncertaintyConfig(alpha=0.7, mode="distribution"),
                          max_len=16, device=device, **ROUTES[route], **kw)
    if not graphed:
        eng._graphs = None
    elif eng.device.type == "cpu":
        eng._graphs = graphs.DecodeGraphs(graphs.Rerun(), max_graphs)
    return eng


def _state(st):
    """A SessionState's tensors (a monolithic cache's too), cloned."""
    ts = [st.pos, st.cur, st.last]
    if isinstance(st.cache, list):
        ts += [t for c in st.cache for t in c]
    return [t.clone() for t in ts]


def _session(eng, greedy):
    """Cold generate, a continuation, a decode-only extension: per step
    the results and the state it returned (cloned before the next step
    writes the session in place)."""
    out, st = [], None
    for prompts, n in ((PROMPTS, 6), (SPAN, 4), (None, 5)):
        res = eng.generate(prompts, n, greedy=greedy, seed=7, state=st,
                           return_state=True)
        st = res["state"]
        out.append((res, _state(st)))
    return out


def _assert_same(a, b):
    for (ra, sa), (rb, sb) in zip(a, b):
        np.testing.assert_array_equal(ra["tokens"], rb["tokens"])
        assert torch.equal(ra["logits"], rb["logits"])
        for k in ("u", "h_mean", "v_mean"):
            np.testing.assert_array_equal(ra[k], rb[k])
        assert len(sa) == len(sb)
        assert all(torch.equal(x, y) for x, y in zip(sa, sb))


def _pools_equal(a, b):
    """The served blocks of two engines' pools (the sink's garbage is
    never read)."""
    if a.pool is None:
        return
    for pa, pb in zip(a.pool.arrays, b.pool.arrays):
        for x, y in zip(pa.served(), pb.served()):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_session_through_graphs_is_bitwise_eager(route, greedy):
    """Cold, continuation and ``_extend`` dispatches, with logits, through
    the graph layer: bitwise the eager loop's, the written pools too."""
    model = _model("cpu")
    eager = _engine(route, "cpu", model, graphed=False)
    graph = _engine(route, "cpu", model, graphed=True)
    _assert_same(_session(graph, greedy), _session(eager, greedy))
    _pools_equal(graph, eager)
    # cold (6 steps), continuation (4; it grows the 16-slot cache) and
    # extension (5): three keys, one replay each
    assert graph._graphs.stats["replays"] == 3
    assert len(graph._graphs) == 3


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_serve_through_graphs_is_bitwise_eager(route, greedy):
    """``serve()`` (no logits stacked) with chunks clamped by
    ``return_state`` budgets: every chunk length is its own key, at most
    ``decode_chunk`` of them; tokens, u and handed-back states bitwise."""
    model = _model("cpu")
    outs = []
    for graphed in (False, True):
        eng = _engine(route, "cpu", model, graphed=graphed)
        reqs = [Request(rid=i, prompt=PROMPTS[i].tolist(), max_new=n,
                        return_state=True) for i, n in enumerate((5, 7, 3))]
        fin = sorted(eng.serve(reqs, n_slots=2, decode_chunk=4,
                               greedy=greedy, seed=3),
                     key=lambda r: r["rid"])
        outs.append((eng, fin))
        if graphed:
            steps = sorted({k[3] for k in eng._graphs.graphs})
            assert len(steps) <= 4 and max(steps) <= 4
            assert all(not k[5] for k in eng._graphs.graphs)   # no logits
    (_, fa), (gr, fb) = outs
    for a, b in zip(fa, fb):
        assert a["rid"] == b["rid"]
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert a["u"] == b["u"]
        assert all(torch.equal(x, y) for x, y in zip(_state(a["state"]),
                                                     _state(b["state"])))
    _pools_equal(outs[0][0], gr)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dispatches_through_graphs_are_bitwise_eager(arch, route):
    """The MoE smoke models (the decode dispatch's argsort, topk, cummax,
    scatter into the capacity buffer and expert bmm inside the captured
    closure): sessions and ``serve()`` bitwise the eager loop."""
    model = _model("cpu", arch=arch)
    eager = _engine(route, "cpu", model, graphed=False)
    graph = _engine(route, "cpu", model, graphed=True)
    _assert_same(_session(graph, True), _session(eager, True))
    _pools_equal(graph, eager)
    fins = []
    for eng in (eager, graph):
        reqs = [Request(rid=i, prompt=PROMPTS[i].tolist(), max_new=n)
                for i, n in enumerate((5, 7, 3))]
        fins.append(sorted(eng.serve(reqs, n_slots=2, decode_chunk=4),
                           key=lambda r: r["rid"]))
    for a, b in zip(*fins):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert a["u"] == b["u"]


@pytest.mark.parametrize("route", list(ROUTES))
def test_second_dispatch_leaves_the_first_alone(route):
    """A replay overwrites the graph's outputs: what a dispatch returned
    (tokens, logits, the state's cur/last/pos) must be clones."""
    eng = _engine(route, "cpu", _model("cpu"), graphed=True)
    a = eng.generate(PROMPTS, 6, return_state=True)
    keep = (a["tokens"].copy(), a["logits"].clone(), _state(a["state"]))
    b = eng.generate(OTHER, 6, return_state=True)       # the same key
    assert eng._graphs.stats["captures"] == 1
    assert eng._graphs.stats["replays"] == 2
    assert not torch.equal(a["logits"], b["logits"])
    np.testing.assert_array_equal(a["tokens"], keep[0])
    assert torch.equal(a["logits"], keep[1])
    assert all(torch.equal(x, y) for x, y in zip(_state(a["state"]),
                                                 keep[2]))
    assert a["logits"].data_ptr() != b["logits"].data_ptr()


@pytest.mark.parametrize("route", list(ROUTES))
def test_counts_are_credited_per_replay(route):
    """The capture's wrapper calls are taken back and credited on each
    replay: a graphed generate counts what the eager one counts, on its
    capturing call and on a replay of a cached graph."""
    model = _model("cpu")

    def counted(eng):
        before = build.snapshot()
        eng.generate(PROMPTS, 6)
        return build.since(before)
    want = counted(_engine(route, "cpu", model, graphed=False))
    assert sum(p for _, p in want) > 0
    graph = _engine(route, "cpu", model, graphed=True)
    assert counted(graph) == want                   # capture + one replay
    assert counted(graph) == want                   # replay only
    assert graph._graphs.stats["captures"] == 1


def test_graph_cache_is_bounded():
    """Least recently used graphs go first; a re-used key is kept."""
    eng = _engine("mono", "cpu", _model("cpu"), graphed=True, max_graphs=2)
    for n in (2, 3, 2, 4):
        eng.generate(PROMPTS, n)
    assert [k[3] for k in eng._graphs.graphs] == [2, 4]
    assert eng._graphs.stats["captures"] == 3


def test_capture_sees_the_sentinel_table():
    """A capture runs on staging buffers of zeros and a block table full of
    sentinels, so the (CPU) capture's own run writes only the sink: the
    served blocks equal an eager engine's after the same dispatches."""
    model = _model("cpu")
    eng = _engine("kernel", "cpu", model, graphed=True)
    ref = _engine("kernel", "cpu", model, graphed=False)
    for e in (eng, ref):
        e.generate(PROMPTS, 6, return_state=True)
    _pools_equal(eng, ref)
    assert eng._graphs.stats["captures"] == 1


# ---------------------------------------------------------------------------
# the card: the real CUDAGraph route
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_cuda_graphs_are_bitwise_eager(cuda, route, greedy):
    """On the card: cold, continuation and ``_extend`` dispatches replayed
    from captured CUDA graphs equal the eager loop bitwise (bf16 model,
    the kernels of rows 2/3/5 inside the graph), and serve() too."""
    model = _model(cuda, torch.bfloat16)
    eager = _engine(route, cuda, model, graphed=False)
    graph = _engine(route, cuda, model, graphed=True)
    assert isinstance(graph._graphs.backend, graphs.CudaGraphs)
    _assert_same(_session(graph, greedy), _session(eager, greedy))
    _pools_equal(graph, eager)
    fins = []
    for eng in (eager, graph):
        reqs = [Request(rid=i, prompt=PROMPTS[i].tolist(), max_new=n)
                for i, n in enumerate((5, 7, 3))]
        fins.append(sorted(eng.serve(reqs, n_slots=2, decode_chunk=4,
                                     greedy=greedy, seed=3),
                           key=lambda r: r["rid"]))
    for a, b in zip(*fins):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert a["u"] == b["u"]


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(ROUTES))
def test_cuda_graph_counts_and_clones(cuda, route):
    """On the card: launches credited per replay equal the eager loop's,
    and a second replay leaves the first dispatch's results alone."""
    model = _model(cuda, torch.bfloat16)

    def counted(eng, prompts=PROMPTS):
        before = build.snapshot()
        res = eng.generate(prompts, 6, return_state=True)
        torch.cuda.synchronize()
        return build.since(before), res
    want, _ = counted(_engine(route, cuda, model, graphed=False))
    graph = _engine(route, cuda, model, graphed=True)
    got1, a = counted(graph)
    keep = (a["logits"].clone(), _state(a["state"]))
    got2, b = counted(graph, OTHER)
    assert got1 == want and got2 == want
    assert graph._graphs.stats["captures"] == 1
    assert torch.equal(a["logits"], keep[0])
    assert all(torch.equal(x, y) for x, y in zip(_state(a["state"]),
                                                 keep[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cuda_moe_graphs_are_bitwise_eager(cuda, arch, route):
    """On the card: an MoE decode dispatch (argsort, topk, cummax, the
    capacity buffer's ``index_put_`` and the expert bmm) captured into a
    CUDA graph, replayed bitwise the eager loop: cold, continuation and
    ``_extend`` dispatches, the pools, and ``serve()``."""
    model = _model(cuda, torch.bfloat16, arch=arch)
    eager = _engine(route, cuda, model, graphed=False)
    graph = _engine(route, cuda, model, graphed=True)
    assert isinstance(graph._graphs.backend, graphs.CudaGraphs)
    _assert_same(_session(graph, True), _session(eager, True))
    _pools_equal(graph, eager)
    assert graph._graphs.stats["captures"] >= 3
    fins = []
    for eng in (eager, graph):
        reqs = [Request(rid=i, prompt=PROMPTS[i].tolist(), max_new=n)
                for i, n in enumerate((5, 7, 3))]
        fins.append(sorted(eng.serve(reqs, n_slots=2, decode_chunk=4),
                           key=lambda r: r["rid"]))
    for a, b in zip(*fins):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert a["u"] == b["u"]
