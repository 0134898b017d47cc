"""The port's training path (``repro_torch.training``, the training route
of ``models/attention.py`` and ``models/transformer.py``, the safety
trainer, ``launch/train.py`` and ``launch/serve.py``) against the JAX
package's, and the cases of the reference's
``tests/test_training_and_checkpoint.py`` that concern training.

Weights come from the JAX ``init_params`` / ``init_safety`` and are
converted with ``repro_torch.convert``; batches are the JAX pipeline's
numpy arrays, given to both packages.

Budgets, and why:
- ``chunked_attention``: forward 2e-5 (f32 summation order); gradients
  1e-4 in relative norm.  Both packages round q, k, v, P and the
  cotangents of their bf16 copies to bf16 at the same sites, so what is
  left is f32 summation order flipping a rare bf16 rounding (5e-5 seen).
- ``loss_fn`` (f32 model): loss 2e-5; the whole gradient 1e-4 in relative
  norm, and each leaf 1e-3: a flipped bf16 rounding of an activation or a
  cotangent weighs more in a small leaf (the attention weights read up to
  4e-4, the rest below 1e-4).
- AdamW ``apply`` on the same gradients: master, m and v 1e-6 (f32 ops in
  the same order); ``schedule`` equal to the last f32 ulp.
- 5 f32 AdamW steps from the same weights: losses 1e-4 relative, parameters
  5e-3 (the gradient noise above, moved by Adam's normalised steps).
- 20 bf16 steps at ``train_lm``'s settings: the final loss within 5% (bf16
  roundings of activations and gradients decorrelate the runs).
- The safety trainer, 5 AdamW steps: BCE 2e-4 relative per step (1e-7 at
  the first step, 8e-5 by the fifth); 99% of the parameter elements
  within 2e-4, and every element within twice the sum of the step sizes:
  Adam's normalised step turns an element whose tiny gradient changes
  sign between the packages into a move of ~2 lr the other way (one
  rarely seen token's embedding reads 1e-2).  The plain-SGD ``train_step``
  from the same weights tracks the same loss to 1e-5 over 2 steps.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as C  # noqa: E402
from repro.core import safety as JS  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline as JPipe  # noqa: E402
from repro.data.workload import FactWorld as JWorld  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train as JTR  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    _named_leaves, from_jax_opt_state, from_jax_params)
from repro_torch.core import safety as TS  # noqa: E402
from repro_torch.data.pipeline import (SyntheticLMPipeline,  # noqa: E402
                                       device_put_batch)
from repro_torch.data.workload import FactWorld  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.swarm_uncertainty import ops as uops  # noqa: E402
from repro_torch.launch import serve as LS  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train as TR  # noqa: E402

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(arch="smollm-135m", dtype="float32", seed=0, **over):
    """(JAX cfg, port cfg, JAX params, port model) from the same weights,
    vocabulary 512 (the fact world's tokens)."""
    jd, td = DT[dtype]
    jc = dataclasses.replace(C.get_smoke(arch), vocab_size=512, dtype=jd,
                             **over)
    tc = dataclasses.replace(TC.get_smoke(arch), vocab_size=512, dtype=td,
                             **over)
    p = JT.init_params(jc, jax.random.PRNGKey(seed))
    return jc, tc, p, from_jax_params(jax.tree.map(np.asarray, p), tc)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return device_put_batch(b, "cpu")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


# ---------------------------------------------------------------------------
# the training forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,K,D,causal,window,qb,kb,n_empty", [
    (2, 64, 4, 2, 16, True, None, 32, 32, 0),     # smoke blocks, GQA
    (2, 64, 4, 1, 16, True, 24, 32, 16, 0),       # windowed, G=4
    (2, 32, 4, 4, 32, False, None, 16, 32, 0),    # bidirectional (encoder)
    (1, 48, 6, 2, 16, True, None, 16, 16, 5),     # empty kv slots (-1)
])
def test_chunked_attention_matches_jax(B, S, H, K, D, causal, window, qb, kb,
                                       n_empty):
    rng = np.random.default_rng(S + H)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    ct = rng.standard_normal((B, S, H, D)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    kvpos = np.where(pos < n_empty, -1, pos).astype(np.int32)
    kw = dict(causal=causal, window=window, q_block=qb, kv_block=kb)

    def jf(a, b, c):
        return JA.chunked_attention(
            a, b, c, q_positions=jnp.asarray(pos),
            kv_positions=jnp.asarray(kvpos), **kw)
    jo, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = vjp(jnp.asarray(ct))
    tq = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    to = TA.chunked_attention(*tq, q_positions=torch.tensor(pos),
                              kv_positions=torch.tensor(kvpos), **kw)
    to.backward(torch.tensor(ct))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               atol=2e-5, rtol=0)
    for name, a, b in zip("qkv", jg, tq):
        assert _rel(a, b.grad.numpy()) < 1e-4, name


def test_training_route_launches_no_kernel_and_serving_refuses_grad():
    """``forward(train=True)`` reaches no kernel wrapper (their counts do
    not move); the inference route on weights that require grad raises
    instead of returning logits without a graph."""
    _, tc, _, model = _pair("llama3-8b")
    tok = {"tokens": torch.as_tensor(np.arange(64, dtype=np.int32)[None]
                                     % 512)}
    cs = (fops.counts, fops.grid_counts, dops.counts, dops.paged_counts,
          uops.counts)
    for c in cs:
        c.reset()
    model.requires_grad_(True)
    logits, _ = TT.forward(model, tc, tok, train=True)
    logits.float().sum().backward()
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in model.parameters())
    assert all(c.plain == c.launches == 0 for c in cs)
    with pytest.raises(RuntimeError, match="has no backward"):
        TT.forward(model, tc, tok)
    model.requires_grad_(False)
    TT.forward(model, tc, tok)                       # frozen: serves


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen1.5-110b"])
def test_loss_fn_matches_jax(arch):
    jc, tc, p, model = _pair(arch)
    b = JPipe(4, 64).get_batch(0)
    (jl, jm), jg = jax.value_and_grad(
        lambda pp: JT.loss_fn(pp, jc, _jbatch(b)), has_aux=True)(p)
    (tl, tm), tg = TR.value_and_grad(TT.loss_fn, model, tc, _tbatch(b),
                                     has_aux=True)
    assert abs(float(jl) - float(tl)) < 2e-5
    assert abs(float(jm["nll"]) - float(tm["nll"])) < 2e-5
    assert float(jm["tokens"]) == float(tm["tokens"])
    leaves = list(_named_leaves(jax.tree.map(np.asarray, jg), tc))
    assert sorted(n for n, _ in leaves) == sorted(tg)
    num = sum(np.sum((a - tg[n].numpy().astype(np.float64)) ** 2)
              for n, a in leaves)
    den = sum(np.sum(a.astype(np.float64) ** 2) for _, a in leaves)
    assert np.sqrt(num / den) < 1e-4
    for n, a in leaves:
        assert _rel(a, tg[n].numpy()) < 1e-3, n
    assert not any(q.requires_grad for q in model.parameters())


def test_eval_step_matches_jax():
    jc, tc, p, model = _pair("llama3-8b")
    b = JPipe(4, 64, two_hop=True).get_batch(3)
    jm = JTR.build_eval_step(jc)(p, _jbatch(b))
    tm = TR.build_eval_step(tc)(model, _tbatch(b))
    assert abs(float(jm["nll"]) - float(tm["nll"])) < 2e-5
    assert float(jm["tokens"]) == float(tm["tokens"])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ocfg", [
    dict(lr=1e-3, warmup_steps=10, total_steps=50),
    dict(),                                     # the reference's defaults
    dict(lr=1e-2, warmup_steps=1, total_steps=3, min_lr_ratio=0.0)])
def test_schedule_matches_jax(ocfg):
    jc, tc = jopt.AdamWConfig(**ocfg), opt.AdamWConfig(**ocfg)
    steps = sorted({0, 1, 2, 3, 9, 10, 11, 49, 50, 51, 99, 100, 101, 5000,
                    9999, 10000, 10001})
    want = np.asarray(jax.vmap(lambda s: jopt.schedule(s, jc))(
        jnp.asarray(steps, jnp.int32)))
    got = np.array([opt.schedule(s, tc) for s in steps], np.float32)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_apply_matches_jax():
    """Three updates on the same random gradients (the second clipped, the
    third in bf16), weight decay on: master, m, v within 1e-6, the step
    and the parameters' dtypes kept."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 16), "b": (16,), "e": (4, 3, 5)}
    dtypes = {"w": jnp.bfloat16, "b": jnp.float32, "e": jnp.bfloat16}
    jp = {n: jnp.asarray(rng.standard_normal(s), jnp.float32).astype(
        dtypes[n]) for n, s in shapes.items()}
    tp = torch.nn.ParameterDict({
        n: torch.nn.Parameter(torch.from_numpy(np.array(
            a.astype(jnp.float32))).to(DT[str(a.dtype)][1]),
            requires_grad=False) for n, a in jp.items()})
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.1)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), opt.AdamWConfig(**cfg)
    js, ts = jopt.init(jp), opt.init(tp)
    for step, (gscale, gdt) in enumerate([(0.01, jnp.float32),
                                          (10.0, jnp.float32),
                                          (0.1, jnp.bfloat16)]):
        jg = {n: (jnp.asarray(rng.standard_normal(s), jnp.float32)
                  * gscale).astype(gdt) for n, s in shapes.items()}
        tg = {n: torch.from_numpy(np.array(g.astype(jnp.float32))).to(
            DT[str(g.dtype)][1]) for n, g in jg.items()}
        jp, js, jm = jopt.apply(jg, jp, js, jcfg)
        tp, ts, tm = opt.apply(tg, tp, ts, tcfg)
        assert ts.step == int(js.step) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-7)
        for n in shapes:
            for tree_j, tree_t in ((js.master, ts.master), (js.m, ts.m),
                                   (js.v, ts.v)):
                np.testing.assert_allclose(tree_t[n].numpy(),
                                           np.asarray(tree_j[n]), atol=1e-6,
                                           rtol=0)
            assert tp[n].dtype == DT[str(jp[n].dtype)][1]
            assert ts.master[n].dtype == torch.float32


def test_optimizer_state_matches_jax_init():
    """``init``: an f32 master equal to the parameters and zero moments,
    shaped like each parameter: the reference's ``init`` converted leaf for
    leaf, bitwise."""
    jc, tc, p, model = _pair("qwen1.5-110b", "bfloat16")
    ts = opt.init(model)
    js = from_jax_opt_state(jax.tree.map(np.asarray, jopt.init(p)), tc)
    assert ts.step == js.step == 0
    named = dict(model.named_parameters())
    assert list(ts.master) == list(named)
    for tree_t, tree_j in ((ts.master, js.master), (ts.m, js.m),
                           (ts.v, js.v)):
        assert sorted(tree_t) == sorted(tree_j)
        for n, t in tree_t.items():
            assert t.dtype == torch.float32 and t.shape == named[n].shape
            assert torch.equal(t, tree_j[n]), n
            assert t.data_ptr() != named[n].data_ptr()


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _run_steps(jc, tc, p, model, ocfg, batches):
    jstep = JTR.build_train_step(jc, jopt.AdamWConfig(**ocfg), None,
                                 donate=False)
    tstep = TR.build_train_step(tc, opt.AdamWConfig(**ocfg))
    js, ts = jopt.init(p), opt.init(model)
    jl, tl = [], []
    for b in batches:
        p, js, jm = jstep(p, js, _jbatch(b))
        model, ts, tm = tstep(model, ts, _tbatch(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return p, model, np.array(jl), np.array(tl)


def test_f32_adamw_steps_match_jax():
    jc, tc, p, model = _pair()
    pipe = JPipe(8, 64, world=JWorld(n_ent=16, n_rel=6))
    p, model, jl, tl = _run_steps(
        jc, tc, p, model, dict(lr=1e-3, total_steps=5, warmup_steps=1),
        [pipe.get_batch(s) for s in range(5)])
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert jl[-1] < jl[0]
    for n, a in _named_leaves(jax.tree.map(np.asarray, p), tc):
        np.testing.assert_allclose(dict(model.named_parameters())[n].numpy(),
                                   a, atol=5e-3, rtol=0, err_msg=n)


def test_bf16_train_lm_settings_match_jax():
    """``launch/serve.train_lm``'s settings (AdamW lr 1e-2, warm-up a tenth,
    no decay, batch 16, seq 64) for 20 bf16 steps from the same weights."""
    jc, tc, p, model = _pair(dtype="bfloat16")
    pipe = JPipe(16, 64, world=JWorld(n_ent=16, n_rel=6), seed=0)
    _, _, jl, tl = _run_steps(
        jc, tc, p, model, dict(lr=1e-2, total_steps=20, warmup_steps=2,
                               weight_decay=0.0),
        [pipe.get_batch(s) for s in range(20)])
    assert abs(tl[-1] / jl[-1] - 1) < 0.05, (jl[-5:], tl[-5:])
    assert tl[-1] < 0.6 * tl[0]


def test_loss_decreases():
    tc = dataclasses.replace(TC.get_smoke("smollm-135m"), vocab_size=512)
    model = TT.init_params(tc, torch.Generator().manual_seed(0))
    step = TR.build_train_step(tc, opt.AdamWConfig(lr=5e-3, total_steps=40))
    state = opt.init(model)
    pipe = SyntheticLMPipeline(8, 64, world=FactWorld(n_ent=8, n_rel=4))
    losses = []
    for s in range(40):
        model, state, m = step(model, state, _tbatch(pipe.get_batch(s)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::8]


def test_grad_accumulation_equivalence():
    """2 microbatches against 1 from the same weights (the reference's
    bounds), and the port's 2-microbatch step against JAX's."""
    jc, tc, p, model = _pair("swarm-edge-1b")
    b = JPipe(8, 32).get_batch(0)
    ocfg = opt.AdamWConfig(lr=1e-3)
    out = {}
    for mb in (1, 2):
        m = from_jax_params(jax.tree.map(np.asarray, p), tc)
        m, _, met = TR.build_train_step(tc, ocfg, microbatches=mb)(
            m, opt.init(m), _tbatch(b))
        out[mb] = (m, float(met["loss"]))
    np.testing.assert_allclose(out[1][1], out[2][1], rtol=5e-2)
    for (n, a), q in zip(out[1][0].named_parameters(),
                         out[2][0].parameters()):
        assert float((a - q).abs().max()) < 5e-2, n
    jp, _, jm = JTR.build_train_step(jc, jopt.AdamWConfig(lr=1e-3), None,
                                     microbatches=2, donate=False)(
        p, jopt.init(p), _jbatch(b))
    assert abs(float(jm["loss"]) - out[2][1]) < 2e-5
    for n, a in _named_leaves(jax.tree.map(np.asarray, jp), tc):
        np.testing.assert_allclose(
            dict(out[2][0].named_parameters())[n].numpy(), a, atol=5e-3,
            rtol=0, err_msg=n)


def test_train_step_leaves_the_model_frozen():
    """A step updates the model in place and returns it; afterwards no
    parameter requires grad, so the engines' inference route serves it."""
    _, tc, _, model = _pair()
    state = opt.init(model)
    step = TR.build_train_step(tc, opt.AdamWConfig(lr=1e-3))
    b = _tbatch(JPipe(2, 32).get_batch(0))
    before = [q.clone() for q in model.parameters()]
    m2, s2, met = step(model, state, b)
    assert m2 is model and s2 is state and state.step == 1
    assert set(met) >= {"loss", "nll", "moe_aux", "tokens", "grad_norm",
                        "lr"}
    assert all(not torch.equal(a, q) for a, q in zip(before,
                                                     model.parameters()))
    assert not any(q.requires_grad for q in model.parameters())
    TT.forward(model, tc, b)                        # the kernel route
    # a mesh is a DeviceMesh: anything else raises, the (1, 1) one builds
    # (tests/test_torch_mesh_training.py trains on meshes)
    with pytest.raises((TypeError, ValueError)):
        TR.build_train_step(tc, opt.AdamWConfig(), mesh=object())
    from repro_torch.launch.mesh import serving_mesh
    assert callable(TR.build_train_step(tc, opt.AdamWConfig(),
                                        mesh=serving_mesh(device="cpu")))


def test_pipeline_replays_the_reference_stream():
    for kw in (dict(two_hop=False, seed=3), dict(two_hop=True, seed=0)):
        a = SyntheticLMPipeline(4, 32, **kw).get_batch(5)
        b = JPipe(4, 32, **kw).get_batch(5)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        t = device_put_batch(a, "cpu")
        assert t["tokens"].dtype == torch.int32
        assert t["loss_mask"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the safety classifier's trainer
# ---------------------------------------------------------------------------

def _safety_pair(seed=5):
    jc = dataclasses.replace(JS.classifier_config(vocab_size=512),
                             dtype=jnp.float32)
    tc = dataclasses.replace(TS.classifier_config(vocab_size=512),
                             dtype=torch.float32)
    p = JS.init_safety(jc, jax.random.PRNGKey(seed))
    return jc, tc, p, from_jax_params(jax.tree.map(np.asarray, p), tc)


def test_safety_trainers_match_jax():
    """``bce_loss``/``make_trainer`` (AdamW) for 5 steps and the plain-SGD
    ``train_step`` for 2, from the same weights and batches."""
    jc, tc, p, model = _safety_pair()
    world = JWorld()
    jtr = JS.make_trainer(jc, lr=1e-2, steps=5)
    ttr = TS.make_trainer(tc, lr=1e-2, steps=5)
    ttr_cfg = opt.AdamWConfig(lr=1e-2, total_steps=5, warmup_steps=10,
                              weight_decay=0.0)
    js, ts = jopt.init(p), opt.init(model)
    for step in range(5):
        toks, labels = world.safety_training_batch(32, 6, step)
        p, js, jl = jtr(p, js, jnp.asarray(toks), jnp.asarray(labels))
        model, ts, tl = ttr(model, ts, torch.as_tensor(toks),
                            torch.as_tensor(labels))
        assert abs(float(tl) / float(jl) - 1) < 2e-4, step
    named = dict(model.named_parameters())
    d = np.concatenate([np.abs(named[n].numpy() - a).ravel() for n, a in
                        _named_leaves(jax.tree.map(np.asarray, p), tc)])
    assert np.quantile(d, 0.99) < 2e-4
    lrs = [opt.schedule(k, ttr_cfg) for k in range(1, 6)]
    assert d.max() < 2 * sum(lrs)
    jc, tc, p, model = _safety_pair(seed=6)
    toks, labels = world.safety_training_batch(32, 6, 7)
    for _ in range(2):
        p, jl = JS.train_step(p, jc, jnp.asarray(toks), jnp.asarray(labels),
                              lr=1e-1)
        model, tl = TS.train_step(model, tc, torch.as_tensor(toks),
                                  torch.as_tensor(labels), lr=1e-1)
        assert abs(float(tl) / float(jl) - 1) < 1e-5
    assert not any(q.requires_grad for q in model.parameters())


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------

def test_serve_main_on_the_cpu(capsys):
    """``launch/serve.py main()`` trains the gateway (2 steps), routes the
    study workload and prints Tables III-V; the paged CLI flags reach the
    engines."""
    log, edge, cl = LS.main(["--train-steps", "2", "--paged"], device="cpu")
    out = capsys.readouterr().out
    for head in ("Table III", "Table IV", "Table V", "SWARM-LLM  CER"):
        assert head in out
    assert len(log.decision) == len(edge.decision) == len(cl.decision) == 50
    assert out.count("[serve] trained") == 4
    assert "[serve] safety classifier BCE" in out


def test_entry_points_need_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LT.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LS.main(["--train-steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LS.train_lm("smollm-135m", 1, two_hop=False, seed=0)


def test_smoke_cli_refuses_tokens_outside_the_vocabulary():
    """The smoke configs' vocabulary (128) does not cover the fact world's
    tokens.  The reference's ``--smoke`` run reads its embedding out of
    range (filled with NaN: loss nan); the port's lookup raises."""
    with pytest.raises(IndexError):
        LT.main(["--smoke", "--steps", "1", "--batch", "2", "--seq", "32"],
                device="cpu")
