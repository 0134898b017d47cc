"""The port's engines on the two MoE families (``deepseek-moe-16b``: 8
experts top-2 + 2 shared after a dense layer; ``llama4-scout-17b-a16e``: 4
experts top-1 + 1 shared) against the JAX engines, and the port's own
engine contracts on them: monolithic and paged ``generate``,
``generate_stepwise``, ``serve()``, bucket padding, the gather decode, an
MoE peer in a swarm and the train CLI.

Setup: the smoke configs at vocabulary 512 with the reference's seeds
(``tests/test_moe_serving.py``: deepseek 1, llama4 0), weights from the JAX
``init_params`` converted by ``convert.from_jax_params``.  Budgets:

* bf16 against the JAX engine: tokens tie-aware at 0.01 on logits of
  size ~1, as the dense tiers (``test_torch_engine.py``: the port's
  attention keeps q, k, v and p in f32 where the JAX CPU path rounds them
  to bf16); u, h_mean and v_mean within 1e-3 on the rows whose streams
  agree;
* f32 against the JAX engine (its flash prefill): tokens exactly, logits
  1e-4, u 1e-5;
* the port's own contracts at the reference's budgets
  (``tests/test_moe_serving.py``, ``tests/test_prefill_parity.py``):
  ``generate`` equals ``generate_stepwise`` tie-aware (bitwise on the CPU,
  asserted), ``serve()`` equals ``generate`` with u within 1e-5, bucket
  padding inert; the paged gather route bitwise the monolithic engine and
  the kernel route within 1e-5 (the block-table op attends the same keys
  in another order);
* the pools against JAX's after the same ``generate`` (``from_jax_paged_pool``):
  tables, rows, refcounts and positions exactly, the k/v of the rows whose
  streams agree to 2e-2 (bf16 activations one ulp apart).

After every paged path the pool is back at its blocks and rows in use.
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
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.swarm import SwarmExecutor as JSX  # noqa: E402
from repro.serving.swarm import pad_prompts  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import (from_jax_paged_pool,  # noqa: E402
                                 from_jax_params)
from repro_torch.core.uncertainty import UncertaintyConfig as TU  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.serving.scheduler import Request  # noqa: E402
from repro_torch.serving.swarm import SwarmExecutor as TSX  # noqa: E402

MOE_ARCHS = {"deepseek-moe-16b": 1, "llama4-scout-17b-a16e": 0}
PROMPTS = [[3, 20, 195, 2], [3, 21, 196, 199, 2], [7, 9, 2]]
RAGGED = PROMPTS + [[5] * 35]      # a length no attention-block bucket divides
BLOCK = 16
UC = dict(mode="distribution")
ROUTES = {"mono": {}, "kernel": dict(paged=True, block_len=BLOCK),
          "gather": dict(paged=True, block_len=BLOCK,
                         attn_decode_impl="gather")}
DT = {"bf16": (jnp.bfloat16, torch.bfloat16),
      "f32": (jnp.float32, torch.float32)}


@functools.lru_cache(maxsize=None)
def _weights(arch: str, dtype: str = "bf16", **over):
    """(JAX config, port config, JAX params, port model) from the same
    weights; shared, never written (engines write caches, not weights)."""
    jd, td = DT[dtype]
    extra = dict(attn_prefill_impl="flash") if dtype == "f32" else {}
    jc = dataclasses.replace(C.get_smoke(arch), vocab_size=512, dtype=jd,
                             **extra, **over)
    tc = dataclasses.replace(TC.get_smoke(arch), vocab_size=512, dtype=td,
                             **over)
    p = jax.jit(JT.init_params, static_argnums=0)(
        jc, jax.random.PRNGKey(MOE_ARCHS[arch]))
    return jc, tc, p, from_jax_params(jax.tree.map(np.asarray, p), tc)


@pytest.fixture(scope="module", params=sorted(MOE_ARCHS))
def arch(request):
    return request.param


def _port(w, route="mono", **kw):
    _, tc, _, model = w
    return TEngine("t", tc, model, TU(**UC), device="cpu",
                   **{**ROUTES[route], **kw})


def _jax(w, route="mono", **kw):
    jc, _, p, _ = w
    return JEngine("j", jc, p, JU(**UC), **{**ROUTES[route], **kw})


@functools.lru_cache(maxsize=None)
def _jax_engine(arch: str, dtype: str = "bf16"):
    """One monolithic JAX engine per weights, built and compiled once per
    module run (its compiles dominate these tests)."""
    return _jax(_weights(arch, dtype))


@functools.lru_cache(maxsize=None)
def _jax_result(arch: str, dtype: str = "bf16"):
    """The JAX engine's ``generate`` of the ragged prompts, 6 tokens."""
    return _np(_jax_engine(arch, dtype).generate(pad_prompts(RAGGED), 6))


def _np(res):
    return {**res, "logits": np.asarray(res["logits"], np.float32)}


def _tie(out, ref, atol=0.01):
    out = {**out, "logits": torch.as_tensor(out["logits"]).float().numpy()}
    assert_greedy_match_modulo_ties(out, _np(ref), atol=atol)


def _assert_pool_idle(eng):
    pool = eng.pool
    assert pool.blocks_in_use == 0 and pool.rows_in_use == 0
    assert int(pool.row_ref.sum()) == 0


# ---------------------------------------------------------------------------
# against the JAX engine
# ---------------------------------------------------------------------------

def test_generate_matches_jax(arch):
    """bf16 ``generate`` tie-aware against JAX's; the probe terms on the
    rows whose streams agree."""
    tres = _port(_weights(arch)).generate(pad_prompts(RAGGED), 6)
    jres = _jax_result(arch)
    _tie(tres, jres)
    same = (tres["tokens"] == jres["tokens"]).all(axis=1)
    assert same.sum() >= 2
    for key in ("u", "h_mean", "v_mean"):
        np.testing.assert_allclose(tres[key][same], jres[key][same],
                                   rtol=1e-3, atol=1e-3, err_msg=key)


def test_f32_generate_is_tight(arch):
    """In f32 the two engines compute the same math: tokens exactly,
    logits to 1e-4, the probe terms to 1e-5."""
    jres = _jax_result(arch, "f32")
    tres = _port(_weights(arch, "f32")).generate(pad_prompts(RAGGED), 6)
    np.testing.assert_array_equal(tres["tokens"], jres["tokens"])
    np.testing.assert_allclose(tres["logits"].numpy(),
                               np.asarray(jres["logits"]), atol=1e-4)
    for key in ("u", "h_mean", "v_mean"):
        np.testing.assert_allclose(tres[key], jres[key], atol=1e-5)


def test_paged_routes_match_jax(arch):
    """The same paged ``generate`` (kept as a session) and ``serve()`` on
    the JAX paged engine and the port's kernel route: tokens tie-aware,
    the handle's tables and rows, refcounts and the session's KV blocks
    through ``from_jax_paged_pool``; the port's gather route tie-aware
    against the JAX paged ``generate``."""
    w = _weights(arch)
    kw = dict(pool_blocks=48, pool_rows=16)
    je, te = _jax(w, "kernel", **kw), _port(w, "kernel", **kw)
    prompts = pad_prompts(RAGGED)
    jres = je.generate(prompts, 6, return_state=True)
    tres = te.generate(prompts, 6, return_state=True)
    _tie(tres, jres)
    hj, ht = jres["state"].cache, tres["state"].cache
    np.testing.assert_array_equal(ht.tables, hj.tables)
    np.testing.assert_array_equal(ht.rows, hj.rows)
    np.testing.assert_array_equal(te.pool.ref, je.pool.ref)
    np.testing.assert_array_equal(te.pool.row_ref, je.pool.row_ref)
    # the blocks of the rows whose streams agree
    same = (tres["tokens"] == jres["tokens"]).all(axis=1)
    live = np.unique(ht.tables[same])
    live = torch.as_tensor(live[live < te.pool.n_blocks])
    jpool = from_jax_paged_pool(jax.tree.map(np.asarray, je.pool.arrays),
                                w[1])
    for pj, pt in zip(jpool, te.pool.arrays):
        sj, st_ = pj.served(), pt.served()
        assert torch.equal(st_.pos, sj.pos)
        for a, b in ((st_.k, sj.k), (st_.v, sj.v)):
            torch.testing.assert_close(a[live].float(), b[live].float(),
                                       atol=2e-2, rtol=0)
    te.release(tres["state"])
    _assert_pool_idle(te)
    gather = _port(w, "gather", **kw)
    _tie(gather.generate(prompts, 6), jres)
    _assert_pool_idle(gather)


def test_gather_decode_serves_end_to_end(arch):
    """``moe_decode_impl="gather"``: the engine serves through it, tie-aware
    against the port's dispatch engine (the reference's 2e-2 block bound;
    the block against the reference's gather: ``test_torch_moe.py``), and
    ``serve()`` equals its ``generate``."""
    _, tc, _, model = _weights(arch)
    eng = TEngine("g", dataclasses.replace(tc, moe_decode_impl="gather"),
                  model, TU(**UC), device="cpu")
    prompts = pad_prompts(RAGGED)
    res = eng.generate(prompts, 6)
    assert res["tokens"].shape == (len(RAGGED), 6)
    assert np.isfinite(res["u"]).all()
    _tie(res, _port(_weights(arch)).generate(prompts, 6), atol=2e-2)
    fin = eng.serve([Request(rid=i, prompt=prompts[i].tolist(), max_new=6)
                     for i in range(len(RAGGED))], n_slots=2, decode_chunk=4)
    for r in fin:
        np.testing.assert_array_equal(r["tokens"], res["tokens"][r["rid"]])


def test_swarm_with_an_moe_peer(arch):
    """A smollm probe whose answer is precomputed issues no dispatch beside
    an MoE peer that runs; answers and u equal the JAX swarm's (f32)."""
    from test_torch_continuation import pair as dense_pair
    moe = _weights(arch, "f32")
    djc, dp, dtc, dmodel = dense_pair("smollm-135m")
    prompts = pad_prompts(RAGGED)        # the peer's compiled shapes
    out = {}
    for side in ("jax", "port"):
        if side == "jax":
            probe = JEngine("p", djc, dp, JU(**UC))
            peer, sx = _jax_engine(arch, "f32"), JSX
        else:
            probe = TEngine("p", dtc, dmodel, TU(**UC), device="cpu")
            peer, sx = _port(moe), TSX
        res = probe.generate(prompts, 6, return_state=True, seed=3)
        before = dict(probe.counters)
        sw = sx([probe, peer]).collaborate(
            prompts, 6, seed=3,
            precomputed={0: (res["tokens"], res["u"],
                             (res["h_mean"], res["v_mean"]))},
            states={0: res["state"]})
        assert probe.counters == before
        assert peer.counters["prefill"] >= 1
        np.testing.assert_array_equal(sw["answers"][:, 0], res["tokens"])
        out[side] = sw
    np.testing.assert_array_equal(out["port"]["answers"],
                                  out["jax"]["answers"])
    np.testing.assert_allclose(out["port"]["u"], out["jax"]["u"], atol=1e-4)


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def test_generate_matches_stepwise(arch):
    """Fused prefill + decode equals token-by-token absorption: tie-aware
    (the contract), and bitwise on the CPU."""
    prompts = pad_prompts(RAGGED)
    eng = _port(_weights(arch))
    res = eng.generate(prompts, 6)
    step = eng.generate_stepwise(prompts, 6)
    _tie(step, res)
    np.testing.assert_array_equal(step["tokens"], res["tokens"])
    assert torch.equal(step["logits"], res["logits"])


@pytest.mark.parametrize("route", list(ROUTES))
def test_serve_matches_generate(arch, route):
    """Each ragged row served through 2 slots (empty slots decode garbage,
    which drop-free routing keeps away from the others) equals its row of
    ``generate``: tokens, u within 1e-5; the paged routes against the
    monolithic ``generate`` (gather bitwise, kernel 1e-5)."""
    prompts = pad_prompts(RAGGED)
    eng = _port(_weights(arch), route)
    res = eng.generate(prompts, 6)
    mono = _port(_weights(arch)).generate(prompts, 6)
    np.testing.assert_array_equal(res["tokens"], mono["tokens"])
    if route == "gather":
        assert torch.equal(res["logits"], mono["logits"])
    else:
        torch.testing.assert_close(res["logits"].float(),
                                   mono["logits"].float(), atol=1e-5, rtol=0)
    fin = eng.serve([Request(rid=i, prompt=prompts[i].tolist(), max_new=6)
                     for i in range(len(RAGGED))], n_slots=2, decode_chunk=4)
    assert sorted(r["rid"] for r in fin) == list(range(len(RAGGED)))
    for r in fin:
        np.testing.assert_array_equal(r["tokens"], res["tokens"][r["rid"]])
        np.testing.assert_allclose(r["u"], res["u"][r["rid"]], atol=1e-5)
    if eng.paged:
        _assert_pool_idle(eng)


def test_bucket_padding_is_bitwise_neutral(arch):
    """``generate`` (5-token prompts bucketed to 8 columns) against the
    same prefill and decode without bucket columns: tokens and logits
    bitwise (masked routing keeps padding out of every capacity count)."""
    prompts = pad_prompts(PROMPTS)
    B, S = prompts.shape
    eng = _port(_weights(arch))
    res = eng.generate(prompts, 6)
    assert eng._bucket(prompts)[0].shape[1] > S
    cur, last, cache = eng._prefill_absorb(prompts, S, eng._cache_len(
        eng._bucket(prompts)[0].shape[1], 6))
    toks, lgs, *_ = eng._dispatch("mono", cur, last, cache, eng._full(B, S),
                                  6, True, None)
    np.testing.assert_array_equal(res["tokens"], toks.numpy())
    assert torch.equal(res["logits"], lgs)


def test_train_cli_smoke(monkeypatch, capsys):
    """``python -m repro_torch.launch.train --arch deepseek-moe-16b
    --smoke`` trains (vocabulary 512: the smoke's 128 does not cover the
    fact world's tokens): the loss is finite and falls."""
    smoke = TC.get_smoke
    monkeypatch.setattr(LT.C, "get_smoke", lambda a: dataclasses.replace(
        smoke(a), vocab_size=512))
    model = LT.main(["--arch", "deepseek-moe-16b", "--smoke", "--steps", "6",
                     "--batch", "4", "--seq", "32", "--lr", "3e-3"],
                    device="cpu")
    out = capsys.readouterr().out
    losses = [float(ln.split("loss ")[1].split()[0])
              for ln in out.splitlines() if ln.startswith("[train] step")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert any(isinstance(layer.ffn, TT.moe.MoE) for layer in model.layers)
