"""The last three architectures of the port against the JAX package:
``command-r-plus-104b`` (dense GQA, G=12 at full width), ``llava-next``
(vision-patch embeddings ahead of its text) and ``hubert`` (audio-frame
embeddings into a bidirectional gelu encoder).

Weights come from the JAX ``init_params`` (smoke configs, vocabulary 512)
through ``convert.from_jax_params``; batches are built as
tests/test_arch_smoke.py::_batch builds them (frontend embeddings plus
text), from a numpy seed, the embeddings rounded to bf16 so that both
packages read the same numbers.

Budgets.  The port's training forward (``train=True``, attention through
``chunked_attention``) rounds where the JAX forward does: logits 1e-4 in
f32, 2e-2 in bf16.  Its inference forward attends through row 4's plain
version, which keeps q, k, v and P in f32 where the JAX CPU path rounds
them to bf16: 5e-3 in f32 (as tests/test_torch_model.py::
test_forward_logits).  ``loss_fn`` 2e-5 and its gradients 1e-4 of their
norm (tests/test_torch_training.py's budgets); one f32 AdamW step with the
batch split into two microbatches: the loss 1e-4 relative, the weights
5e-3.  The smoke engines' greedy tokens tie-aware at 1e-4; hubert's engine
is refused.
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
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train as JTR  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import _named_leaves, from_jax_params  # noqa: E402
from repro_torch.core.uncertainty import UncertaintyConfig as TU  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train as TTR  # noqa: E402

ARCHS = ("command-r-plus-104b", "llava-next-mistral-7b", "hubert-xlarge")
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
PROMPTS = np.array([[0, 0, 3, 20, 195, 2], [3, 21, 196, 199, 2, 7],
                    [0, 0, 0, 7, 9, 2]], np.int32)
j_forward = jax.jit(JT.forward, static_argnums=1)


def _pair(arch, dtype="float32", seed=0):
    """(JAX cfg, port cfg, JAX params, port model) of a smoke arch at
    vocabulary 512."""
    jd, td = DT[dtype]
    jc = dataclasses.replace(C.get_smoke(arch), vocab_size=512, dtype=jd)
    tc = dataclasses.replace(TC.get_smoke(arch), vocab_size=512, dtype=td)
    if dtype == "float32":
        jc = dataclasses.replace(jc, attn_prefill_impl="flash")
    p = jax.jit(JT.init_params, static_argnums=0)(jc,
                                                 jax.random.PRNGKey(seed))
    return jc, tc, p, from_jax_params(jax.tree.map(np.asarray, p), tc)


def _batch(cfg, B=2, S=32, seed=0):
    """numpy batch as tests/test_arch_smoke.py::_batch lays it out: an
    encoder's frames at every position, llava's ``frontend_tokens``
    patches then S - F text tokens, else S tokens; labels over the text
    (every frame for an encoder)."""
    rng = np.random.default_rng(seed)

    def embeds(n):
        a = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                          .astype(jnp.float32))

    b = {}
    if cfg.family in ("encoder", "audio"):
        b["frontend_embeds"] = embeds(S)
        s_text = S
    elif cfg.frontend == "vision_patches":
        F = cfg.frontend_tokens
        b["frontend_embeds"] = embeds(F)
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S - F)).astype(
            np.int32)
        s_text = S - F
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
        s_text = S
    b["labels"] = rng.integers(0, cfg.vocab_size, (B, s_text)).astype(
        np.int32)
    b["loss_mask"] = np.ones((B, s_text), np.float32)
    b["loss_mask"][:, -1] = 0
    return b


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_configs_and_layouts():
    """The published widths the port builds (hubert's head_dim 80, G=12
    for command-r), and the frontend configs build as models."""
    cr = TC.get_config("command-r-plus-104b")
    assert (cr.q_per_kv, cr.head_dim, cr.vocab_size) == (12, 128, 256000)
    hb, lv = TC.get_config("hubert-xlarge"), TC.get_config(
        "llava-next-mistral-7b")
    assert (hb.head_dim, hb.causal, hb.ffn_act, hb.frontend) == (
        80, False, "gelu", "audio_frames")
    assert (lv.frontend, lv.frontend_tokens, lv.causal) == (
        "vision_patches", 576, True)
    for arch in ARCHS:
        TT.Transformer(TC.get_smoke(arch))


def test_embed_inputs_places_frontend_first():
    _, tc, _, model = _pair("llava-next-mistral-7b")
    b = _tb(_batch(tc))
    x = TT.embed_inputs(model, tc, b)
    F = tc.frontend_tokens
    assert x.shape == (2, 32, tc.d_model) and x.dtype == tc.comp_dtype
    assert torch.equal(x[:, :F], b["frontend_embeds"])
    assert torch.equal(x[:, F:], model.embed[b["tokens"].long()])
    enc = TT.embed_inputs(model, tc, {"frontend_embeds":
                                      b["frontend_embeds"]})
    assert torch.equal(enc, b["frontend_embeds"])


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, dtype):
    jc, tc, p, model = _pair(arch, dtype)
    b = _batch(tc)
    ref, jaux = j_forward(p, jc, _jb(b))
    fops.grid_counts.reset()
    tr, aux = TT.forward(model, tc, _tb(b), train=True)
    assert fops.grid_counts.plain == 0           # autograd's route
    inf, _ = TT.forward(model, tc, _tb(b))
    assert fops.grid_counts.plain == tc.num_layers   # row 4, plain here
    assert ref.shape == tr.shape == inf.shape == (2, 32, 512)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(tr), _np(ref), rtol=tol, atol=tol)
    tol = 5e-3 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(inf), _np(ref), rtol=tol, atol=tol)
    assert float(aux) == float(jaux) == 0.0


def _hubert_causality(model, tc):
    """An encoder's first position reads its last frame: changing that
    frame moves the first logits (a causal model's would stay)."""
    b = _tb(_batch(tc))
    x0, _ = TT.forward(model, tc, b)
    b["frontend_embeds"][:, -1] += 1.0
    x1, _ = TT.forward(model, tc, b)
    return float((x1[:, 0] - x0[:, 0]).abs().max())


def test_hubert_attends_both_ways():
    _, tc, _, model = _pair("hubert-xlarge")
    assert _hubert_causality(model, tc) > 1e-5
    causal = dataclasses.replace(tc, causal=True)
    assert _hubert_causality(model, causal) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jc, tc, p, model = _pair(arch)
    b = _batch(tc)
    (jl, jm), jg = jax.value_and_grad(
        lambda pp: JT.loss_fn(pp, jc, _jb(b)), has_aux=True)(p)
    tb = _tb(b)
    (tl, tm), tg = TTR.value_and_grad(TT.loss_fn, model, tc, tb,
                                      has_aux=True)
    assert abs(float(jl) - float(tl)) < 2e-5
    assert abs(float(jm["nll"]) - float(tm["nll"])) < 2e-5
    assert float(jm["tokens"]) == float(tm["tokens"]) == 2 * (
        b["labels"].shape[1] - 1)
    leaves = list(_named_leaves(jax.tree.map(np.asarray, jg), tc))
    assert sorted(n for n, _ in leaves) == sorted(tg)
    num = sum(np.sum((a - tg[n].numpy().astype(np.float64)) ** 2)
              for n, a in leaves)
    den = sum(np.sum(a.astype(np.float64) ** 2) for _, a in leaves)
    assert np.sqrt(num / den) < 1e-4
    # the embeddings are inputs: no gradient reaches them
    if "frontend_embeds" in tb:
        assert not tb["frontend_embeds"].requires_grad
        assert tb["frontend_embeds"].grad is None
    if "tokens" not in b:                   # hubert: the table is unused
        assert not tg["embed"].any()


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "hubert-xlarge"])
def test_microbatched_train_step_matches_jax(arch):
    """One AdamW step of a frontend batch of 4 split into 2 microbatches,
    against the reference's step on the same split."""
    jc, tc, p, model = _pair(arch)
    b = _batch(tc, B=4, seed=1)
    ocfg = dict(lr=1e-3, total_steps=5, warmup_steps=1)
    jstep = JTR.build_train_step(jc, jopt.AdamWConfig(**ocfg), None,
                                 microbatches=2, donate=False)
    tstep = TTR.build_train_step(tc, topt.AdamWConfig(**ocfg),
                                 microbatches=2)
    p, _, jm = jstep(p, jopt.init(p), _jb(b))
    model, _, tm = tstep(model, topt.init(model), _tb(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    named = dict(model.named_parameters())
    for n, a in _named_leaves(jax.tree.map(np.asarray, p), tc):
        np.testing.assert_allclose(named[n].numpy(), a, atol=5e-3, rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize("arch", ["command-r-plus-104b",
                                  "llava-next-mistral-7b"])
def test_smoke_engine_generate_matches_jax(arch):
    """The token backbone served (llava's engine reads tokens only, as the
    reference's does): greedy tokens tie-aware, the probe terms where the
    streams agree."""
    jc, tc, p, model = _pair(arch)
    ref = JEngine("j", jc, p, JU(mode="distribution")).generate(PROMPTS, 8)
    out = TEngine("t", tc, model, TU(mode="distribution"),
                  device="cpu").generate(PROMPTS, 8)
    assert_greedy_match_modulo_ties(
        {**out, "logits": out["logits"].numpy()},
        {**ref, "logits": np.asarray(ref["logits"])}, atol=1e-4)
    same = (out["tokens"] == ref["tokens"]).all(axis=1)
    assert same.any()
    np.testing.assert_allclose(out["u"][same], np.asarray(ref["u"])[same],
                               atol=1e-5, rtol=0)
    assert len(np.unique(out["tokens"])) > 3     # the streams vary


def test_hubert_engine_is_refused_and_the_encoder_still_runs():
    """The engine refuses an encoder (the reference never decodes one:
    its cells skip "encoder-only: no decode step"); ``forward`` and the
    safety classifier, which runs the same bidirectional body without an
    engine, are unaffected."""
    from repro_torch.core import safety as TS
    _, tc, _, model = _pair("hubert-xlarge")
    with pytest.raises(NotImplementedError, match="encoder-only"):
        TEngine("hubert", tc, model, device="cpu")
    logits, _ = TT.forward(model, tc, _tb(_batch(tc)))
    assert torch.isfinite(logits).all()
    scfg = TS.classifier_config(vocab_size=64, d_model=32)
    sp = TS.init_safety(scfg, torch.Generator().manual_seed(0),
                        device="cpu")
    s = TS.safety_score(sp, scfg, torch.ones((2, 6), dtype=torch.int32))
    assert s.shape == (2,) and torch.isfinite(s).all()
