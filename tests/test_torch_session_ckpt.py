"""Session checkpoints in the port (``InferenceEngine.checkpoint_session`` /
``restore_session``), mirroring tests/test_faults.py::TestSessionDurability
and tests/test_quantized.py::TestQuantizedCheckpoint.

Setup: the smoke llama3-8b in f32, vocabulary 512, weights from the JAX
``init_params`` converted by ``convert.from_jax_params``; paged engines in
blocks of 16.  A paged engine that is held bitwise to a monolithic one
decodes through the gathered view (``attn_decode_impl="gather"``, bitwise
the monolithic engine); the block-table route is held against itself.

* a session checkpointed, then continued on its engine (the uninterrupted
  chat) and restored on a fresh engine and continued there: tokens and
  logits bitwise, for the four pairs of paged and monolithic engines; the
  restored session keeps ``max_len`` (a monolithic engine grows a paged
  session's covered blocks back to it, so its dispatches keep the
  source's shapes), and a checkpoint of the restored session holds the
  same leaves as the first;
* the block-table route restored onto itself, bitwise;
* the recurrent smoke (``recurrentgemma-2b``): its state rows and a
  local-attention ring that has wrapped round-trip, the resumed chat
  bitwise;
* a sampled session resumes its stream (the generator's state is saved);
* the resumed chat against the JAX engine's own checkpoint round trip,
  tie-aware at 1e-4;
* no checkpoint raises ``FileNotFoundError``, a training checkpoint
  ``ValueError``; an int8 checkpoint restores on an int8 engine with its
  tokens and logits within 0.02 (bf16 weights), and any other
  representation raises ``QuantMismatchError``, both ways.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from test_torch_continuation import CTX, SPAN, pair
from test_torch_engine import assert_greedy_match_modulo_ties
from test_torch_recurrent_engine import _weights

jax = pytest.importorskip("jax")

from repro.core.uncertainty import UncertaintyConfig as JU  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.swarm import pad_prompts  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.uncertainty import UncertaintyConfig as TU  # noqa: E402
from repro_torch.serving.cache_manager import \
    QuantMismatchError  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.training import checkpoint as ck  # noqa: E402

BLOCK = 16
UC = dict(mode="distribution")
KINDS = {"mono": {},
         "paged": dict(paged=True, block_len=BLOCK, attn_decode_impl="gather"),
         "kernel": dict(paged=True, block_len=BLOCK)}


@pytest.fixture(scope="module")
def models():
    return pair()


def _eng(cfg, model, kind, name="e", **kw):
    return TEngine(name, cfg, model, TU(**UC), device="cpu",
                   **{**KINDS[kind], **kw})


def _bitwise(a, b):
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert torch.equal(a["logits"], b["logits"])
    np.testing.assert_array_equal(a["u"], b["u"])


def _resume(cfg, model, src, dst, tmp_path, prompts, span, n=4, **kw):
    """(uninterrupted, resumed, first checkpoint's leaves, leaves of a
    checkpoint of the restored session) of a chat: ``generate`` with
    ``return_state``, a checkpoint, then ``span`` on the source engine and,
    after a restore on a fresh ``dst`` engine, there."""
    e1 = _eng(cfg, model, src, "src", **kw)
    st = e1.generate(prompts, n, return_state=True)["state"]
    e1.checkpoint_session(st, str(tmp_path / "a"))
    ref = e1.generate(span, n, state=st)
    e2 = _eng(cfg, model, dst, "dst", **kw)
    st2 = e2.restore_session(str(tmp_path / "a"))
    assert (st2.max_len, st2.offset) == (st.max_len, st.offset)
    if dst == "mono":       # as long as its max_len, as the source's view
        assert all(c.pos.shape[1] in (st.max_len, cfg.window)
                   for c in st2.cache if hasattr(c, "pos"))
    e2.checkpoint_session(st2, str(tmp_path / "b"))
    got = e2.generate(span, n, state=st2)
    return (ref, got, ck.load_leaves(str(tmp_path / "a"), 0)[0],
            ck.load_leaves(str(tmp_path / "b"), 0)[0])


def _same_leaves(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("src,dst", [("paged", "paged"), ("paged", "mono"),
                                     ("mono", "paged"), ("mono", "mono")])
def test_kill_rebuild_resume_bitwise(models, src, dst, tmp_path):
    _, _, tc, model = models
    ref, got, a, b = _resume(tc, model, src, dst, tmp_path,
                             pad_prompts(CTX), pad_prompts(SPAN))
    _bitwise(got, ref)
    if src == dst:
        _same_leaves(a, b)
    else:           # a paged session is saved trimmed to its blocks
        assert {k for k in a if not k.startswith("cache")} == \
            {k for k in b if not k.startswith("cache")}


def test_block_table_route_resumes_bitwise(models, tmp_path):
    _, _, tc, model = models
    ref, got, a, b = _resume(tc, model, "kernel", "kernel", tmp_path,
                             pad_prompts(CTX), pad_prompts(SPAN))
    _bitwise(got, ref)
    _same_leaves(a, b)


@pytest.mark.parametrize("src,dst", [("paged", "mono"), ("mono", "paged")])
def test_recurrent_rows_and_wrapped_ring_round_trip(src, dst, tmp_path):
    """recurrentgemma's smoke (window 32): a 40-token prompt and 8 steps
    wrap its local layers' rings; the RG-LRU state rows, the ring and the
    continuation come back bitwise."""
    _, tc, _, model = _weights("recurrentgemma-2b")
    prompts = np.random.default_rng(0).integers(1, 512, (2, 40)).astype(
        np.int32)
    ref, got, a, b = _resume(tc, model, src, dst, tmp_path, prompts,
                             pad_prompts(SPAN[:2]), n=8)
    _bitwise(got, ref)
    assert any(".h" in k or "/h" in k for k in a), sorted(a)[:8]
    for k in a:
        if k.startswith("cache") and a[k].shape == b[k].shape:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", ["mono", "kernel"])
def test_sampled_session_resumes_its_stream(models, kind, tmp_path):
    _, _, tc, model = models
    e1 = _eng(tc, model, kind)
    st = e1.generate(pad_prompts(CTX), 4, greedy=False, seed=3,
                     return_state=True)["state"]
    assert st.gen is not None
    e1.checkpoint_session(st, str(tmp_path))
    ref = e1.generate(None, 8, state=st, greedy=False)
    e2 = _eng(tc, model, kind, "fresh")
    got = e2.generate(None, 8, state=e2.restore_session(str(tmp_path)),
                      greedy=False)
    _bitwise(got, ref)


def test_resumed_chat_matches_jax(models, tmp_path):
    jc, p, tc, model = models
    prompts, span = pad_prompts(CTX), pad_prompts(SPAN)
    out = {}
    for side, eng in (("jax", JEngine("j", jc, p, JU(**UC))),
                      ("port", _eng(tc, model, "mono"))):
        st = eng.generate(prompts, 4, return_state=True)["state"]
        eng.checkpoint_session(st, str(tmp_path / side))
        res = eng.generate(span, 4, state=eng.restore_session(
            str(tmp_path / side)))
        out[side] = {**res, "logits": np.asarray(res["logits"])}
    assert_greedy_match_modulo_ties(out["port"], out["jax"], atol=1e-4)


def test_restore_missing_and_wrong_kind(models, tmp_path):
    _, _, tc, model = models
    e = _eng(tc, model, "mono")
    with pytest.raises(FileNotFoundError):
        e.restore_session(str(tmp_path / "none"))
    ck.save(str(tmp_path / "train"), 1, {"params": model})
    with pytest.raises(ValueError, match="not a session"):
        e.restore_session(str(tmp_path / "train"))


@pytest.fixture(scope="module")
def bf16(models):
    _, p, tc, _ = models
    tcb = dataclasses.replace(tc, dtype=torch.bfloat16)
    return tcb, from_jax_params(jax.tree.map(np.asarray, p), tcb)


def test_int8_checkpoint_resumes_in_budget(bf16, tmp_path):
    """The saved view is dequantized; the restore quantizes it again into
    fresh blocks: the resumed stream equals the unbroken one, its logits
    within the quantized pools' budget."""
    tc, model = bf16
    q = _eng(tc, model, "kernel", cache_quant="int8")
    r = q.generate(pad_prompts(CTX), 4, return_state=True)
    q.checkpoint_session(r["state"], str(tmp_path), step=1)
    unbroken = q.generate(None, 4, state=r["state"])
    fresh = _eng(tc, model, "kernel", "fresh", cache_quant="int8")
    resumed = fresh.generate(None, 4, state=fresh.restore_session(
        str(tmp_path)))
    np.testing.assert_array_equal(resumed["tokens"], unbroken["tokens"])
    np.testing.assert_allclose(resumed["logits"].float().numpy(),
                               unbroken["logits"].float().numpy(),
                               atol=0.02, rtol=0)


@pytest.mark.parametrize("dst", ["mono", "bf16_paged", "fp8"])
def test_quantized_checkpoint_refused_elsewhere(bf16, dst, tmp_path):
    tc, model = bf16
    q = _eng(tc, model, "kernel", cache_quant="int8")
    r = q.generate(pad_prompts(CTX), 3, return_state=True)
    q.checkpoint_session(r["state"], str(tmp_path), step=1)
    other = {"mono": ("mono", {}), "bf16_paged": ("kernel", {}),
             "fp8": ("kernel", dict(cache_quant="fp8"))}[dst]
    eng = _eng(tc, model, other[0], dst, **other[1])
    with pytest.raises(QuantMismatchError, match="cache_quant='int8'"):
        eng.restore_session(str(tmp_path))


def test_bf16_checkpoint_refused_by_quantized_engine(bf16, tmp_path):
    tc, model = bf16
    paged = _eng(tc, model, "kernel")
    r = paged.generate(pad_prompts(CTX), 3, return_state=True)
    paged.checkpoint_session(r["state"], str(tmp_path), step=1)
    q = _eng(tc, model, "kernel", "q", cache_quant="int8")
    with pytest.raises(QuantMismatchError, match="cache_quant=None"):
        q.restore_session(str(tmp_path))
    assert q.pool.blocks_in_use == 0
