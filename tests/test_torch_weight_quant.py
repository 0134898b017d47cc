"""Quantized serving weights (``weight_quant``, ``quant.QTensor``) against
the JAX package's, on the CPU.

* ``quant.quantize_params`` against the reference's, leaf for leaf: the
  same set of quantized weights (by name, anywhere in the tree: a hybrid's
  local-attention projections and FFNs, an MoE's expert stacks and shared
  expert, the untied head; never an embedding, norm, bias, router or
  recurrent-mixer weight), payload bits and scales equal, int8 and fp8;
  the caller's model is left as it was.
* ``InferenceEngine(weight_quant="int8")`` against the JAX engine with the
  same setting: tie-aware, f32 and bf16, monolithic and paged, with and
  without ``cache_quant``; the port's own contract (quantized against the
  bf16 engine within 2 * max(budget, 0.01), the reference's
  ``tests/test_quantized.py`` budget); MoE gather decode against dispatch
  decode under quantized weights (0.02).
* the f32 smoke gateway on quantized engines, decision for decision
  against the JAX gateway's.
* a quantized model refuses training, LoRA and the checkpoint writer, and
  refuses to be cast as a whole.
* ``gpu``: the card's quantized engine against the CPU's.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from test_torch_engine import assert_greedy_match_modulo_ties

from repro_torch import configs as TC
from repro_torch.core.uncertainty import UncertaintyConfig as TU
from repro_torch.models import lora as TL
from repro_torch.models import quant as TQ
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.training import checkpoint as TCK
from repro_torch.training import train as TTR

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as C  # noqa: E402
from repro.core.uncertainty import UncertaintyConfig as JU  # noqa: E402
from repro.models import quant as JQ  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.swarm import pad_prompts  # noqa: E402
from repro_torch.convert import _named_leaves, from_jax_params  # noqa: E402

ARCHS = ("llama3-8b", "recurrentgemma-2b", "mamba2-780m", "deepseek-moe-16b")
# the reference's per-arch logit budgets against the unquantized engine
BUDGET = {"llama3-8b": 0.02, "recurrentgemma-2b": 0.02, "mamba2-780m": 0.0,
          "deepseek-moe-16b": 0.05}
PROMPTS = [[3, 20, 195, 2], [3, 21, 196, 199, 2], [7, 9, 2]]
BLOCK = 16
UC = dict(mode="distribution")
DT = {"bf16": (jnp.bfloat16, torch.bfloat16),
      "f32": (jnp.float32, torch.float32)}
LAYOUTS = {"mono": {}, "paged": dict(paged=True, block_len=BLOCK),
           "paged-cq": dict(paged=True, block_len=BLOCK, cache_quant="int8"),
           "gather": dict(paged=True, block_len=BLOCK,
                          attn_decode_impl="gather")}


@functools.lru_cache(maxsize=None)
def _weights(arch: str, dtype: str = "bf16", scaled: bool = True):
    """(JAX config, port config, JAX params, port model) from one draw; the
    recurrent smokes' matrices scaled by 6 unless ``scaled`` is False
    (their greedy streams repeat a token at the init scale,
    tests/test_torch_recurrent_engine.py)."""
    jd, td = DT[dtype]
    extra = dict(attn_prefill_impl="flash") if dtype == "f32" else {}
    jc = dataclasses.replace(C.get_smoke(arch), vocab_size=512, dtype=jd,
                             **extra)
    tc = dataclasses.replace(TC.get_smoke(arch), vocab_size=512, dtype=td)
    p = jax.jit(JT.init_params, static_argnums=0)(jc, jax.random.PRNGKey(0))
    if scaled and arch in ("recurrentgemma-2b", "mamba2-780m"):
        def scale(path, a):
            name = jax.tree_util.keystr(path)
            big = a.ndim >= 2 and "embed" not in name and "conv" not in name
            return a * 6 if big else a
        p = jax.tree_util.tree_map_with_path(scale, p)
    return jc, tc, p, from_jax_params(jax.tree.map(np.asarray, p), tc)


def _np(res):
    lg = res["logits"]
    lg = (lg.float().numpy() if isinstance(lg, torch.Tensor)
          else np.asarray(lg, np.float32))
    return {**res, "logits": lg}


def _tie(out, ref, atol=0.01):
    assert_greedy_match_modulo_ties(_np(out), _np(ref), atol=atol)


def _port(w, layout="mono", **kw):
    _, tc, _, model = w
    return TEngine("t", tc, model, TU(**UC), device="cpu",
                   **{**LAYOUTS[layout], **kw})


def _jax(w, layout="mono", **kw):
    jc, _, p, _ = w
    return JEngine("j", jc, p, JU(**UC), **{**LAYOUTS[layout], **kw})


def _bits(t):
    """A payload's bytes as numpy (fp8 through a uint8 view)."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn
                else t).numpy()
    return np.asarray(t.view(jnp.uint8) if t.dtype == jnp.float8_e4m3fn
                      else t)


def _jax_quantized_leaves(jq, cfg):
    """{port name: numpy array} of a quantized JAX tree: a QTensor leaf
    becomes ``<name>.q`` (its bytes) and ``<name>.scale``, named through
    ``convert._named_leaves``'s mapping."""
    def leaf(x):
        if isinstance(x, JQ.QTensor):
            return {"q": _bits(x.q), "scale": np.asarray(x.scale)}
        return np.asarray(x.astype(jnp.float32))
    tree = jax.tree.map(leaf, jq, is_leaf=lambda x: isinstance(x, JQ.QTensor))
    out = {}
    head = tree.pop("lm_head", None)
    if isinstance(head, dict):
        out["lm_head.q"], out["lm_head.scale"] = head["q"], head["scale"]
    cfg = dataclasses.replace(cfg, tie_embeddings=True)   # head handled
    for name, a in _named_leaves(tree, cfg):
        out[name] = a
    return out


# ---------------------------------------------------------------------------
# quantize_params, leaf for leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["int8", "fp8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_matches_jax_leaf_for_leaf(arch, quant):
    jc, tc, p, model = _weights(arch)
    before = {n: t.clone() for n, t in model.named_parameters()}
    qm = TQ.quantize_params(model, quant)
    want = _jax_quantized_leaves(JQ.quantize_params(p, quant), tc)
    got = {**{n: t for n, t in qm.named_parameters()},
           **{n: t for n, t in qm.named_buffers()}}
    assert set(got) == set(want)
    wq = {n[:-2] for n in want if n.endswith(".q")}
    assert wq == set(TQ.quantized_names(qm))
    # the SSD smoke ties its head and has no attention or MLP: nothing
    assert bool(wq) == (arch != "mamba2-780m")
    for name, t in got.items():
        if name.endswith(".q"):
            assert t.dtype == TQ.qdtype(quant)
            np.testing.assert_array_equal(_bits(t), want[name],
                                          err_msg=name)
        elif name.endswith(".scale") and name[:-6] in wq:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), want[name],
                                          err_msg=name)
        else:                                 # shared with the source model
            assert t is dict(model.named_parameters())[name]
    # what stays unquantized, by the reference's reasons
    leaves = {n.rsplit(".", 1)[-1] for n in wq}
    assert leaves <= TQ._QUANT_KEYS
    assert not any(k in n for n in wq for k in (
        "embed", "norm", "router", "mixer.w_in", "in_proj", "conv"))
    # the source model is untouched: same parameters, same values
    assert set(dict(model.named_parameters())) == set(before)
    for n, t in model.named_parameters():
        assert type(t) is torch.nn.Parameter and torch.equal(t, before[n])
    assert not TQ.quantized_names(model)


def test_quantized_model_is_for_serving_only():
    """Training, LoRA and the checkpoint writer refuse a quantized model;
    casting the module raises instead of rewriting its storage; moving it
    keeps the payload's dtype."""
    _, tc, _, model = _weights("llama3-8b")
    qm = TQ.quantize_params(model, "int8")
    with pytest.raises(TypeError, match="serving only"):
        TTR.value_and_grad(lambda m: torch.zeros(()), qm)
    with pytest.raises(TypeError, match="serving only"):
        TL.lora_defs(qm)
    with pytest.raises(TypeError, match="serving only"):
        TCK.save("/nonexistent", 0, {"params": qm})
    with pytest.raises(TypeError, match="QTensor keeps"):
        qm.to(torch.bfloat16)             # would round the f32 scales
    moved = qm.to("cpu")
    assert moved.layers[0].mixer.wq.q.dtype == torch.int8
    with pytest.raises(ValueError, match="quantization mode"):
        TQ.quantize_params(model, "int4")


def test_engine_reports_weight_bytes():
    w = _weights("llama3-8b")
    full = _port(w)
    q = _port(w, weight_quant="int8")
    n_q = sum(t.q.numel() for t in q.params.modules()
              if isinstance(t, TQ.QTensor))
    assert n_q > 0
    # bf16 -> int8 halves the quantized weights' bytes; scales add 4/row
    scales = sum(t.scale.nbytes for t in q.params.modules()
                 if isinstance(t, TQ.QTensor))
    assert full.weight_bytes() - q.weight_bytes() == n_q - scales


# ---------------------------------------------------------------------------
# engines against the JAX engine with the same setting
# ---------------------------------------------------------------------------

CASES = [("llama3-8b", "bf16", "mono"), ("llama3-8b", "bf16", "paged-cq"),
         ("llama3-8b", "f32", "paged"), ("recurrentgemma-2b", "f32",
                                        "paged-cq"),
         ("recurrentgemma-2b", "f32", "mono"), ("mamba2-780m", "bf16",
                                                 "mono"),
         ("mamba2-780m", "f32", "paged-cq"), ("deepseek-moe-16b", "f32",
                                               "mono"),
         ("deepseek-moe-16b", "bf16", "paged-cq")]


@pytest.mark.parametrize("arch,dtype,layout", CASES,
                         ids=["-".join(c) for c in CASES])
def test_generate_matches_jax(arch, dtype, layout):
    """Tie-aware against the JAX engine with ``weight_quant="int8"``: the
    dequantized weights are bitwise the reference's, so the budgets are
    those of the unquantized comparisons (f32 1e-4 on the smokes, bf16
    0.01).  The recurrent smokes compare in f32, as their unquantized
    engines do (tests/test_torch_recurrent_engine.py)."""
    w = _weights(arch, dtype)
    prompts = pad_prompts(PROMPTS)
    jres = _jax(w, layout, weight_quant="int8").generate(prompts, 6)
    tres = _port(w, layout, weight_quant="int8").generate(prompts, 6)
    _tie(tres, jres, atol=1e-4 if dtype == "f32" else 0.01)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_within_budget_of_bf16(arch, quant):
    """The port's own contract, as the reference's
    ``test_dense_weight_quant_greedy_parity``: paged, int8 pool, quantized
    weights against the bf16 paged engine, greedy tokens tie-aware and
    logits within 2 * max(budget, 0.01); at the init scale, where the
    reference sets that budget."""
    w = _weights(arch, scaled=False)
    prompts = pad_prompts(PROMPTS)
    base = _port(w, "paged").generate(prompts, 6)
    q = _port(w, "paged-cq", weight_quant=quant).generate(prompts, 6)
    budget = 2 * max(BUDGET[arch], 0.01)
    _tie(q, base, atol=budget / 2)
    same = (q["tokens"] == base["tokens"]).all(axis=1)
    assert same.any()
    np.testing.assert_allclose(q["logits"][same].float().numpy(),
                               base["logits"][same].float().numpy(),
                               atol=budget, rtol=0)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-moe-16b"])
def test_quantized_engine_is_its_dequantized_twin(arch, quant):
    """A quantized engine computes exactly what an unquantized engine over
    the dequantized weights computes: tokens and logits bitwise."""
    w = _weights(arch)
    jc, tc, p, model = w
    q = _port(w, weight_quant=quant)
    twin = TQ.dequantize_params(q.params, tc.dtype)
    assert not TQ.quantized_names(twin) and TQ.quantized_names(q.params)
    prompts = pad_prompts(PROMPTS)
    a = q.generate(prompts, 6)
    b = _port((jc, tc, p, twin)).generate(prompts, 6)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert torch.equal(a["logits"], b["logits"])


@pytest.mark.parametrize("layout", ["mono", "paged-cq"])
def test_moe_gather_matches_dispatch_quantized(layout):
    """Gather decode takes the k experts' quantized rows and dequantizes
    them after the gather, to the values the dispatch's dequantized stack
    holds: the two decodes agree within 0.02 (the reference's
    ``test_moe_gather_impl_matches_dispatch_quantized``)."""
    jc, tc, p, model = _weights("deepseek-moe-16b")
    prompts = pad_prompts(PROMPTS)
    tg = dataclasses.replace(tc, moe_decode_impl="gather")
    disp = _port((jc, tc, p, model), layout, weight_quant="int8")
    gath = _port((jc, tg, p, model), layout, weight_quant="int8")
    r0, r1 = disp.generate(prompts, 6), gath.generate(prompts, 6)
    torch.testing.assert_close(r1["logits"].float(), r0["logits"].float(),
                               atol=0.02, rtol=0)


def test_weight_quant_leaves_other_engines_alone():
    """Two engines over one model, one quantized: the unquantized one
    still serves the caller's weights bitwise."""
    w = _weights("llama3-8b")
    prompts = pad_prompts(PROMPTS)
    ref = _port(w).generate(prompts, 4)
    _port(w, weight_quant="fp8").generate(prompts, 4)
    again = _port(w).generate(prompts, 4)
    np.testing.assert_array_equal(ref["tokens"], again["tokens"])
    assert torch.equal(ref["logits"], again["logits"])


# ---------------------------------------------------------------------------
# the gateway on quantized engines
# ---------------------------------------------------------------------------

def test_quantized_gateway_matches_jax(monkeypatch):
    """The f32 smoke gateway (tests/test_torch_gateway.py's) with
    ``weight_quant="int8"`` on every tier, decision for decision against
    the JAX gateway whose engines quantize the same weights."""
    import test_torch_gateway as G
    monkeypatch.setattr(G, "JE", functools.partial(G.JE,
                                                   weight_quant="int8"))
    real = G.build_gateway
    monkeypatch.setattr(G, "build_gateway", functools.partial(
        real, engine_kw={"weight_quant": "int8"}))
    sys_ = G._build("float32")
    assert min(sys_["margins"]) > G.MARGIN, sys_["margins"]
    port_probe = sys_["engines"][2]
    assert TQ.quantized_names(port_probe.params)
    j, t = G._run_both(sys_)
    G._assert_logs_equal(j, t)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["mono", "paged-cq"])
@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_cuda_quantized_engine_matches_cpu(layout, quant):
    """On the card: the quantized f32 engine (graph route) against the
    CPU's: tokens equal and logits within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    cfg = dataclasses.replace(TC.get_smoke("llama3-8b"), vocab_size=512,
                              dtype=torch.float32)
    model = TT.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = pad_prompts(PROMPTS)
    outs = []
    for dev in ("cpu", "cuda"):
        eng = TEngine("q", cfg, TT.init_params(
            cfg, torch.Generator().manual_seed(0)) if dev == "cuda"
            else model, TU(**UC), device=dev, weight_quant=quant,
            **LAYOUTS[layout])
        outs.append(eng.generate(prompts, 6))
    cpu, gpu = outs
    np.testing.assert_array_equal(gpu["tokens"], cpu["tokens"])
    torch.testing.assert_close(gpu["logits"].cpu(), cpu["logits"],
                               atol=1e-4, rtol=0)
