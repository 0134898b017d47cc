"""The port's safety gate (``repro_torch.core.safety``, Eq. 5-6) against
the JAX package's, and the full-sequence path it shares with
``transformer.forward``.

Weights come from the JAX ``init_safety`` and are converted with
``convert.from_jax_params``.  Prompts are the study workload's, right-padded
with PAD=0 as the gateway feeds them, plus longer rows that are mostly PAD.
The encoder has no attention mask in either package: PAD tokens attend and
are attended to, and only the mean-pool skips them.

Budgets: f32 1e-5 on s in [0, 1] — the JAX encoder's chunked attention
rounds q, k, v and p to bf16 even in an f32 model (ROADMAP section C), the
port's flash op keeps them in f32, and on these weights that moves s by at
most ~8e-6; bf16 2e-2, the reference's bf16 budget.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import safety as JS  # noqa: E402
from repro.data.workload import FactWorld  # noqa: E402
from repro.serving.swarm import pad_prompts  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import safety as TS  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

j_score = jax.jit(JS.safety_score, static_argnums=1)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _prompts() -> np.ndarray:
    qs = FactWorld(n_ent=16, n_rel=6).study_workload()
    rows = [q["prompt"] for q in qs] + [[3, 20, 195, 2], [411, 2]]
    rp = pad_prompts(rows, align="right")
    wide = np.zeros((rp.shape[0], rp.shape[1] + 10), np.int32)
    wide[:, :rp.shape[1]] = rp               # a batch that is mostly PAD
    return rp, wide


def _pair(dtype: str, seed: int):
    jd, td, _ = DTYPES[dtype]
    jc = dataclasses.replace(JS.classifier_config(vocab_size=512), dtype=jd)
    tc = dataclasses.replace(TS.classifier_config(vocab_size=512), dtype=td)
    p = JS.init_safety(jc, jax.random.PRNGKey(seed))
    return jc, tc, p, from_jax_params(jax.tree.map(np.asarray, p), tc)


def test_config_mirrors_reference():
    for kw in ({}, dict(vocab_size=512, d_model=64, num_layers=3)):
        jc, tc = JS.classifier_config(**kw), TS.classifier_config(**kw)
        for f in dataclasses.fields(tc):
            if f.name not in ("dtype", "compute_dtype"):
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.layer_plan() == jc.layer_plan()


def test_conversion_copies_every_leaf():
    _, tc, p, model = _pair("float32", 0)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(p))
    assert n_jax == sum(t.numel() for t in model.parameters())
    assert not hasattr(model, "lm_head")
    assert not hasattr(model.layers[0].ffn, "w_gate")        # gelu MLP
    np.testing.assert_array_equal(model.head_w.numpy(),
                                  np.asarray(p["head_w"]))
    np.testing.assert_array_equal(
        model.layers[1].ffn.w_up.numpy(),
        np.asarray(p["stages"][0]["b0"]["ffn"]["w_up"][1]))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_safety_score_matches_jax(dtype, seed):
    jc, tc, p, model = _pair(dtype, seed)
    tol = DTYPES[dtype][2]
    for toks in _prompts():
        fops.grid_counts.reset()
        fops.counts.reset()
        s_t = TS.safety_score(model, tc, torch.from_numpy(toks))
        # the encoder runs the grid-offset op once per layer, never the
        # positions-mode op
        assert fops.grid_counts.plain == tc.num_layers
        assert fops.counts.plain == 0
        s_j = np.asarray(j_score(p, jc, jnp.asarray(toks)))
        assert s_t.dtype == torch.float32 and s_t.shape == (toks.shape[0],)
        assert bool(((s_t >= 0) & (s_t <= 1)).all())
        np.testing.assert_allclose(s_t.numpy(), s_j, rtol=0, atol=tol)
        sigma = float(np.median(s_j))
        far = np.abs(s_j - sigma) > tol
        np.testing.assert_array_equal(
            TS.risk_flag(s_t, sigma).numpy()[far],
            np.asarray(JS.risk_flag(jnp.asarray(s_j), sigma))[far])


def test_pads_attend():
    """Right-padding a batch with more PAD columns changes s (PADs take
    part in attention), in the port as in the reference."""
    jc, tc, p, model = _pair("float32", 2)
    rp, wide = _prompts()
    s_t = TS.safety_score(model, tc, torch.from_numpy(rp)).numpy()
    s_w = TS.safety_score(model, tc, torch.from_numpy(wide)).numpy()
    assert np.abs(s_t - s_w).max() > 1e-4
    np.testing.assert_allclose(
        s_w - s_t, np.asarray(j_score(p, jc, jnp.asarray(wide)))
        - np.asarray(j_score(p, jc, jnp.asarray(rp))), atol=2e-5)


def test_init_safety_distribution():
    tc = dataclasses.replace(TS.classifier_config(vocab_size=512),
                             dtype=torch.float32)
    m = TS.init_safety(tc, torch.Generator().manual_seed(0), device="cpu")
    assert float(m.head_w.std()) == pytest.approx(0.02, rel=0.2)
    assert float(m.head_b.abs().max()) == 0.0
    assert float(m.embed.std()) == pytest.approx(0.02, rel=0.1)
    s = TS.safety_score(m, tc, torch.randint(0, 512, (4, 6)))
    assert torch.isfinite(s).all()


def test_init_safety_without_device_refuses_cpu():
    """Like the engines, the classifier goes to the card unless the caller
    asks for the CPU; with no card it raises instead of building there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None selects it")
    tc = TS.classifier_config(vocab_size=512)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.init_safety(tc, torch.Generator().manual_seed(0))


def test_forward_runs_the_grid_op():
    """``transformer.forward`` attends through the grid-offset op (causal),
    once per layer; the positions-mode op belongs to prefill."""
    from repro_torch import configs as TC
    tc = dataclasses.replace(TC.get_smoke("llama3-8b"), dtype=torch.float32)
    m = TT.init_params(tc, torch.Generator().manual_seed(0))
    toks = torch.randint(0, tc.vocab_size, (2, 12))
    fops.grid_counts.reset()
    fops.counts.reset()
    logits, _ = TT.forward(m, tc, {"tokens": toks})
    assert fops.grid_counts.plain == tc.num_layers and fops.counts.plain == 0
    # causal: the first 5 positions do not see the later ones
    logits5, _ = TT.forward(m, tc, {"tokens": toks[:, :5]})
    torch.testing.assert_close(logits[:, :5], logits5, rtol=1e-5, atol=1e-5)
