"""The port's dense model (``repro_torch.models``) against the JAX model.

Weights come from the JAX package's ``init_params`` and are converted with
``repro_torch.convert.from_jax_params``, for the four gateway tiers' smoke
configs and for ``smollm-135m`` at its full widths cut to 2 layers.

Budgets.  In f32 the cached paths (prefill with bucket padding, then
decode steps) are compared with the JAX package's flash prefill and its f32
decode chunk: the same math in another summation order, held to 1e-4.  The
full-sequence ``forward`` of the JAX package runs its chunked attention,
which rounds q, k, v and p to bf16 before each product even in an f32
model, so it is held to 5e-3.  In bf16 every activation is rounded at the
same sites in both packages, but accumulation order and the kernels' f32
products differ: 2e-2 on logits of size ~1.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

# the JAX reference; a CUDA machine without JAX skips this file
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as C  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import common as TCM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

# the JAX entry points, jitted: one compile per shape, not an op-by-op trace
j_forward = jax.jit(T.forward, static_argnums=1)
j_prefill = jax.jit(T.prefill, static_argnums=1)
j_decode_step = jax.jit(T.decode_step, static_argnums=1)
j_init_params = jax.jit(T.init_params, static_argnums=0)

ARCHS = ("smollm-135m", "swarm-edge-1b", "qwen1.5-110b", "llama3-8b")
PROMPTS = np.array([[0, 0, 3, 20, 195, 2], [3, 21, 196, 199, 2, 7],
                    [0, 0, 0, 7, 9, 2]], np.int32)


def _cfgs(arch: str, dtype: str, **over):
    jc = dataclasses.replace(C.get_smoke(arch), vocab_size=512, **over)
    tc = dataclasses.replace(TC.get_smoke(arch), vocab_size=512, **over)
    if dtype == "float32":
        jc = dataclasses.replace(jc, dtype=jnp.float32,
                                 attn_prefill_impl="flash")
        tc = dataclasses.replace(tc, dtype=torch.float32)
    return jc, tc


def _params(jc, seed: int = 0):
    """JAX ``init_params``, with its all-zero leaves (norms, QKV bias)
    perturbed so that converting every leaf is exercised."""
    rng = np.random.default_rng(seed)

    def perturb(a):
        if np.any(np.asarray(a, np.float32)):
            return a
        return jnp.asarray(rng.standard_normal(a.shape) * 0.1,
                           jnp.float32).astype(a.dtype)

    return jax.tree.map(perturb, j_init_params(jc, jax.random.PRNGKey(seed)))


# every tier in f32; bf16 for the tied-head and the QKV-bias tier
PAIRS = [(a, "float32") for a in ARCHS] + [("smollm-135m", "bfloat16"),
                                           ("qwen1.5-110b", "bfloat16")]


@pytest.fixture(scope="module", params=PAIRS, ids=lambda x: f"{x[0]}-{x[1]}")
def pair(request):
    arch, dtype = request.param
    jc, tc = _cfgs(arch, dtype)
    p = _params(jc)
    return jc, tc, p, from_jax_params(jax.tree.map(np.asarray, p), tc)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tol(tc):
    return 1e-4 if tc.dtype == torch.float32 else 2e-2


def test_config_mirrors_reference():
    assert sorted(TC.ARCH_IDS) == sorted(C.ARCH_IDS)
    for arch in C.ARCH_IDS:
        for get, tget in ((C.get_config, TC.get_config),
                          (C.get_smoke, TC.get_smoke)):
            jc, tc = get(arch), tget(arch)
            for f in dataclasses.fields(tc):
                if f.name not in ("dtype", "compute_dtype"):
                    assert getattr(tc, f.name) == getattr(jc, f.name), f.name
            assert tc.layer_plan() == jc.layer_plan()
            assert [(s.blocks, s.repeat) for s in tc.stage_plan()] == \
                [(s.blocks, s.repeat) for s in jc.stage_plan()]
    with pytest.raises(ValueError):        # an unknown arch id
        TC.get_config("gpt-2-xl")


def test_common_ops_match_reference():
    from repro.models import common as JCM
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal((16,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        TCM.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(JCM.rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-6, atol=1e-6)
    pos = np.array([[-3, 0, 1, 7, 4095]], np.int32)
    for theta in (10_000.0, 500_000.0, 1_000_000.0):
        ct, st = TCM.rope_angles(torch.from_numpy(pos), 16, theta)
        cj, sj = JCM.rope_angles(jnp.asarray(pos), 16, theta)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-6)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-6)
        xr = x[:1]
        np.testing.assert_allclose(
            TCM.apply_rope(torch.from_numpy(xr), ct[..., None, :],
                           st[..., None, :]).numpy(),
            np.asarray(JCM.apply_rope(jnp.asarray(xr), cj[..., None, :],
                                      sj[..., None, :])), atol=1e-5)
    for act in ("swiglu", "gelu"):
        np.testing.assert_allclose(
            TCM.ACTIVATIONS[act](torch.from_numpy(x)).numpy(),
            np.asarray(JCM.ACTIVATIONS[act](jnp.asarray(x))), atol=1e-6)


def test_conversion_copies_every_leaf(pair):
    jc, tc, p, model = pair
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    n_jax = sum(int(np.prod(a.shape)) for _, a in flat)
    assert n_jax == sum(t.numel() for t in model.parameters())
    layer = 1                                 # second slice of the stack
    np.testing.assert_array_equal(
        _np(model.layers[layer].mixer.wq),
        _np(p["stages"][0]["b0"]["mixer"]["wq"][layer]))
    np.testing.assert_array_equal(
        _np(model.layers[layer].ffn.w_down),
        _np(p["stages"][0]["b0"]["ffn"]["w_down"][layer]))
    assert hasattr(model, "lm_head") == (not tc.tie_embeddings)
    assert hasattr(model.layers[0].mixer, "bq") == tc.attn_bias


def test_embed_inputs(pair):
    jc, tc, p, model = pair
    out = TT.embed_inputs(model, tc, {"tokens": torch.from_numpy(PROMPTS)})
    ref = T.embed_inputs(p, jc, {"tokens": jnp.asarray(PROMPTS)})
    np.testing.assert_array_equal(_np(out), _np(ref))


def test_forward_logits(pair):
    jc, tc, p, model = pair
    out, _ = TT.forward(model, tc, {"tokens": torch.from_numpy(PROMPTS)})
    ref, _ = j_forward(p, jc, {"tokens": jnp.asarray(PROMPTS)})
    tol = 5e-3 if tc.dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)


def test_bucketed_prefill_then_decode(pair):
    """Left-padded bucket columns at negative positions, then three decode
    steps: logits and the written cache match the JAX package."""
    jc, tc, p, model = pair
    B, S, Sb, L = PROMPTS.shape[0], PROMPTS.shape[1], 8, 16
    toks = np.zeros((B, Sb), np.int32)
    toks[:, Sb - S:] = PROMPTS
    pos = np.broadcast_to(np.arange(Sb, dtype=np.int32) - (Sb - S), (B, Sb))
    jcache = T.init_cache(jc, B, L)
    lj, jcache = j_prefill(p, jc, jnp.asarray(toks), jcache, jnp.asarray(pos))
    tcache = TT.init_cache(tc, B, L)
    lt, _ = TT.prefill(model, tc, torch.from_numpy(toks), tcache,
                       torch.from_numpy(pos.copy()))
    tol = _tol(tc)
    # padding rows are inert and finite; real rows match the reference
    assert np.isfinite(_np(lt)).all()
    np.testing.assert_allclose(_np(lt)[:, Sb - S:], _np(lj)[:, Sb - S:],
                               rtol=tol, atol=tol)
    jkv = jcache[0]["b0"].kv
    np.testing.assert_array_equal(tcache[0].pos.numpy(),
                                  np.asarray(jkv.pos[0]))
    np.testing.assert_allclose(_np(tcache[-1].k), _np(jkv.k[-1]),
                               rtol=tol, atol=tol)
    cur = np.asarray(jnp.argmax(lj[:, -1], -1), np.int32)
    for step in range(3):
        idx = np.full((B,), S + step, np.int32)
        lj, jcache = j_decode_step(p, jc, jnp.asarray(cur[:, None]), jcache,
                                   jnp.asarray(idx))
        lt, _ = TT.decode_step(model, tc, torch.from_numpy(cur[:, None]),
                               tcache, torch.from_numpy(idx))
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=tol, atol=tol)
        cur = np.asarray(jnp.argmax(lj[:, -1], -1), np.int32)
    assert (tcache[0].pos.numpy() == np.asarray(
        jcache[0]["b0"].kv.pos[0])).all()


def test_smollm_full_width_two_layers():
    """Published smollm-135m widths (d=576, 9 heads / 3 KV heads, head_dim
    64, vocab 49152), depth cut to 2 layers, f32."""
    jc = dataclasses.replace(C.get_config("smollm-135m"), num_layers=2,
                             dtype=jnp.float32, attn_prefill_impl="flash")
    tc = dataclasses.replace(TC.get_config("smollm-135m"), num_layers=2,
                             dtype=torch.float32)
    p = j_init_params(jc, jax.random.PRNGKey(1))
    model = from_jax_params(jax.tree.map(np.asarray, p), tc)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 49152, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    lj, jcache = j_prefill(p, jc, jnp.asarray(toks), T.init_cache(jc, 2, 16),
                           jnp.asarray(pos))
    tcache = TT.init_cache(tc, 2, 16)
    lt, _ = TT.prefill(model, tc, torch.from_numpy(toks), tcache,
                       torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-4, atol=1e-4)
    idx = np.full((2,), 12, np.int32)
    nxt = np.asarray(jnp.argmax(lj[:, -1], -1), np.int32)[:, None]
    lj, _ = j_decode_step(p, jc, jnp.asarray(nxt), jcache, jnp.asarray(idx))
    lt, _ = TT.decode_step(model, tc, torch.from_numpy(nxt), tcache,
                           torch.from_numpy(idx))
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-4, atol=1e-4)


def test_init_params_distribution():
    tc = dataclasses.replace(TC.get_smoke("llama3-8b"), dtype=torch.float32)
    m = TT.init_params(tc, torch.Generator().manual_seed(0))
    m2 = TT.init_params(tc, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 m2.parameters()))
    assert float(m.embed.std()) == pytest.approx(0.02, rel=0.1)
    std_o = 0.02 / (2 * tc.num_layers) ** 0.5
    assert float(m.layers[0].mixer.wo.std()) == pytest.approx(std_o, rel=0.2)
    assert float(m.final_norm.abs().max()) == 0.0
    assert m.head().shape == (tc.d_model, tc.vocab_size)


def test_other_mixers_are_refused():
    """What the port does not run is refused instead of run wrong: a layer
    kind the port does not know, and an engine over an encoder-only config
    (``causal=False``: no decode step), which still builds as a model.
    RG-LRU, SSD (``test_torch_recurrent.py``), MoE (``test_torch_moe.py``)
    and frontend configs (``test_torch_archs.py``) are ported."""
    from repro_torch.serving.engine import InferenceEngine
    base = TC.get_smoke("smollm-135m")
    enc = dataclasses.replace(base, causal=False)
    model = TT.Transformer(enc)
    with pytest.raises(NotImplementedError, match="encoder-only"):
        InferenceEngine("enc", enc, model, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        TT.Transformer(dataclasses.replace(base, mixer_pattern=("conv",)))
    moe = dataclasses.replace(base, num_experts=4, top_k=2, expert_d_ff=32)
    assert any(f == "moe" for _, f in moe.layer_plan())
    TT.Transformer(moe)
