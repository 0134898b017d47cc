"""The port's LoRA adapters (``repro_torch.models.lora``) and the Sec. IV-H
distillation step (``repro_torch.core.distill``) against the JAX
package's, and the reference's LoRA distillation case.

Adapters come from the JAX ``init_lora`` (B then drawn at random, so the
merge is not a no-op) and are converted with ``convert.from_jax_lora``;
base weights from ``init_params`` through ``convert.from_jax_params``.

Budgets (f32 models): the merged weights 1e-6 (one f32 product and add);
``distill_loss`` 2e-5 relative (the training forward rounds q, k, v and P
to bf16 at the reference's sites, the rest is f32 summation order);
three ``distill_step``s at lr 0.1: the losses 2e-5 relative, the adapters
1e-6 (the SGD step moves them by lr times a gradient that agrees to ~1e-4
of its norm).
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as C  # noqa: E402
from repro.core import distill as JD  # noqa: E402
from repro.models import lora as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import from_jax_lora, from_jax_params  # noqa: E402
from repro_torch.core import distill as TD  # noqa: E402
from repro_torch.models import lora as TL  # noqa: E402


def _setup(arch="smollm-135m", seed=0, rank=4):
    jc = dataclasses.replace(C.get_smoke(arch), vocab_size=512,
                             dtype=jnp.float32)
    tc = dataclasses.replace(TC.get_smoke(arch), vocab_size=512,
                             dtype=torch.float32)
    p = JT.init_params(jc, jax.random.PRNGKey(seed))
    lora = JL.init_lora(p, jax.random.PRNGKey(seed + 1), rank=rank)
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 2), 64))
    lora = jax.tree.map(
        lambda x: x if float(jnp.abs(x).max()) > 0 else
        0.02 * jax.random.normal(next(keys), x.shape, x.dtype), lora)
    model = from_jax_params(jax.tree.map(np.asarray, p), tc)
    tl = from_jax_lora(jax.tree.map(np.asarray, lora), tc)
    return jc, tc, p, lora, model, tl


def _batch(vocab=512, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0
    teacher = rng.standard_normal((B, S, vocab)).astype(np.float32) * 3
    return {"tokens": toks, "labels": labels, "loss_mask": mask}, teacher


@pytest.mark.parametrize("arch", ["smollm-135m", "llama3-8b"])
def test_lora_defs_and_init_match_jax(arch):
    jc, tc, p, lora, model, tl = _setup(arch)
    defs = TL.lora_defs(model, rank=4)
    assert sorted(defs) == sorted(tl)
    assert {n.rsplit(".", 1)[-1] for n in defs} == {"wq", "wv", "w_up"}
    for n, ab in tl.items():
        assert tuple(ab["a"].shape) == defs[n]["a"]
        assert tuple(ab["b"].shape) == defs[n]["b"]
    fresh = TL.init_lora(model, torch.Generator().manual_seed(0), rank=4)
    assert sorted(fresh) == sorted(defs)
    a = torch.cat([ab["a"].flatten() for ab in fresh.values()])
    assert all(not ab["b"].any() and ab["a"].dtype == torch.float32
               for ab in fresh.values())
    assert abs(float(a.std()) / 0.02 - 1) < 0.1


def test_merge_matches_jax():
    jc, tc, p, lora, model, tl = _setup()
    want = JL.merge(p, lora, scale=0.5)
    got = TL.merge(model, tl, scale=0.5)
    jm = from_jax_params(jax.tree.map(np.asarray, want), tc)
    for n, t in jm.named_parameters():
        np.testing.assert_allclose(got[n].detach().numpy(), t.numpy(),
                                   atol=1e-6, rtol=0, err_msg=n)
    assert not any(t.requires_grad for t in got.values())


def test_distill_loss_and_step_match_jax():
    jc, tc, p, lora, model, tl = _setup()
    b, teacher = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    jl = JD.distill_loss(lora, p, jc, jb, jnp.asarray(teacher))
    tloss = TD.distill_loss(tl, model, tc, tb, torch.as_tensor(teacher))
    assert abs(float(tloss) / float(jl) - 1) < 2e-5
    before = {n: q.clone() for n, q in model.named_parameters()}
    for _ in range(3):
        lora, jl = JD.distill_step(lora, p, jc, jb, jnp.asarray(teacher),
                                   lr=0.1)
        tl, tloss = TD.distill_step(tl, model, tc, tb,
                                    torch.as_tensor(teacher), lr=0.1)
        assert abs(float(tloss) / float(jl) - 1) < 2e-5
    for n, ab in from_jax_lora(jax.tree.map(np.asarray, lora), tc).items():
        for k in "ab":
            np.testing.assert_allclose(tl[n][k].numpy(), ab[k].numpy(),
                                       atol=1e-6, rtol=0, err_msg=(n, k))
    for n, q in model.named_parameters():
        assert torch.equal(q, before[n]) and not q.requires_grad, n


def test_lora_distillation_moves_student():
    """The reference's case, from its own bf16 weights, adapters (B = 0)
    and teacher, converted: 5 steps at lr 1e-2 lower the loss (as in the
    reference, by ~1e-3: the adapters' product is near bf16's resolution
    of the weights), the base stays as it was, the adapters move and the
    tree handed in is left as it was."""
    jc = dataclasses.replace(C.get_smoke("smollm-135m"), vocab_size=512)
    tc = dataclasses.replace(TC.get_smoke("smollm-135m"), vocab_size=512)
    p = JT.init_params(jc, jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree.map(np.asarray, p), tc)
    lora = from_jax_lora(jax.tree.map(np.asarray, JL.init_lora(
        p, jax.random.PRNGKey(1), rank=4)), tc)
    first = lora
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
             "labels": torch.ones((2, 8), dtype=torch.int32),
             "loss_mask": torch.ones((2, 8))}
    teacher = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(2), (2, 8, jc.vocab_size))))
    base = {n: q.clone() for n, q in model.named_parameters()}
    l0 = None
    for _ in range(5):
        lora, loss = TD.distill_step(lora, model, tc, batch, teacher,
                                     lr=1e-2)
        l0 = l0 or float(loss)
    assert float(loss) < l0
    assert any(float(ab["b"].abs().max()) > 0 for ab in lora.values())
    assert all(not ab["b"].any() for ab in first.values())
    for n, q in model.named_parameters():
        assert torch.equal(q, base[n]), n
