"""The port's mixture of experts (``repro_torch.models.moe``) against the
JAX package's ``repro/models/moe.py``, function by function, and the two
MoE smoke models' ``loss_fn`` and train steps.

Inputs come from a numpy seed.  A layer's JAX weights are the JAX
``init_tree(moe_defs)``, rescaled so that every product is of size ~1
(the router and the up/gate stacks to std 1/sqrt(D), the down stacks to
std 1/sqrt(2 F), norms perturbed), and copied into the port's ``MoE``;
the residual inputs have std 0.5.  Budgets:

* f32: 1e-5 on the block outputs (the same products in the same order up
  to summation inside a product); routing, ranks and capacity integers
  exactly;
* bf16: 2e-2, the reference's bf16 budget (both round the dispatched
  rows, the expert activations and outputs to bf16 at the same sites; a
  product accumulates in another order and rounds an ulp apart);
* aux losses 1e-6 (f32 means of the same numbers);
* ``loss_fn`` (f32 models): loss 2e-5, the whole gradient 1e-4 in relative
  norm and each leaf 1e-3, as the dense models
  (``test_torch_training.py``: both packages' chunked attention round q,
  k, v and P to bf16, and a flipped rounding weighs more in a small leaf);
  the MoE block's own gradients, without attention, 1e-5 in relative
  norm and each leaf 1e-4 (a top-1 gate renormalises to exactly 1, so the
  router's gradient there is the aux term plus the cancellation of two
  f32 terms: 1e-4 relative seen);
* 3 f32 AdamW steps: losses 1e-4 relative, parameters 5e-3.

Capacity binds where it is asked to (``capacity_factor=0.5``: every
expert is offered about twice its slots), so the drops are held too.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as C  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline as JPipe  # noqa: E402
from repro.data.workload import FactWorld as JWorld  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train as JTR  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import _named_leaves, _walk  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.data.pipeline import device_put_batch  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train as TR  # noqa: E402

ARCHS = ("deepseek-moe-16b", "llama4-scout-17b-a16e")
DT = {"float32": (jnp.float32, torch.float32, 1e-5),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

J = {name: jax.jit(getattr(JM, name), static_argnums=2,
                   static_argnames=("groups",) if name == "moe_block"
                   else ())
     for name in ("moe_block", "moe_prefill_block", "moe_decode_block")}


def _cfgs(arch, dtype="float32", **over):
    jd, td, _ = DT[dtype]
    return (dataclasses.replace(C.get_smoke(arch), dtype=jd, **over),
            dataclasses.replace(TC.get_smoke(arch), dtype=td, **over))


def _layer(jc, tc, seed=0):
    """(JAX layer params, port ``MoE``) holding the same rescaled weights."""
    p = init_tree(JM.moe_defs(jc), jax.random.PRNGKey(seed), jnp.float32)
    rng = np.random.default_rng(seed)

    def rescale(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a, np.float32)
        if a.ndim == 1:                                  # norms
            return 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        fan_in = a.shape[-2]
        std = 1 / np.sqrt(2 * fan_in if "w_down" in name else fan_in)
        return a / a.std() * std
    p = jax.tree_util.tree_map_with_path(rescale, p)
    port = TM.MoE(tc)
    named = dict(port.named_parameters())
    with torch.no_grad():
        for name, a in _walk("", p):
            named[name[1:]].copy_(torch.from_numpy(np.asarray(a)).to(
                tc.dtype))
    return jax.tree.map(lambda a: jnp.asarray(a, jc.dtype), p), port


def _x(shape, dtype, seed=1):
    a = 0.5 * np.random.default_rng(seed).standard_normal(shape)
    a = np.asarray(a, np.float32)
    jd, td, _ = DT[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _close(t, j, atol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# capacity, routing and ranking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25, 2.0])
@pytest.mark.parametrize("serve", [None, 0.01, 0.1, 1.25, 4.0])
def test_capacity_integers_match_jax(arch, factor, serve):
    jc, tc = _cfgs(arch, capacity_factor=factor,
                   moe_serve_capacity_factor=serve)
    for n in (1, 3, 4, 8, 16, 50, 64, 200, 512, 2048):
        assert TM.moe_capacity(tc, n) == JM.moe_capacity(jc, n)
        assert TM.moe_serve_capacity(tc, n) == JM.moe_serve_capacity(jc, n)


def test_serve_capacity_knob():
    """The reference's ``test_serve_capacity_knob`` values."""
    cfg = TC.get_smoke("deepseek-moe-16b")
    assert cfg.moe_serve_capacity_factor is None
    assert TM.moe_serve_capacity(cfg, 16) == 16         # drop-free default
    bounded = dataclasses.replace(cfg, moe_serve_capacity_factor=1.25)
    assert TM.moe_serve_capacity(bounded, 64) == 24     # round8(64*2/8*1.25)
    tiny = dataclasses.replace(cfg, moe_serve_capacity_factor=0.01)
    assert TM.moe_serve_capacity(tiny, 4) == 1          # floor at 1


@pytest.mark.parametrize("g,A,E", [(1, 12, 4), (3, 96, 8), (5, 200, 3),
                                   (2, 1024, 64)])
def test_rank_in_expert_matches_jax(g, A, E):
    """Ids with many duplicates and the sentinel E: the same integers as
    the reference's ranking."""
    ids = np.random.default_rng(A).integers(0, E + 1, (g, A))
    want = np.asarray(JM._rank_in_expert(jnp.asarray(ids, jnp.int32)))
    got = TM._rank_in_expert(torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_topk_matches_jax(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _layer(jc, tc)
    jx, tx = _x((3, 10, jc.d_model), "float32")
    valid = np.random.default_rng(0).random((3, 10)) > 0.3
    jg, ji, jpr = JM._route_topk(jp["router"], jx, jc, jnp.asarray(valid))
    tg, ti, tpr = TM._route_topk(tp.router, tx, tc, torch.from_numpy(valid))
    np.testing.assert_array_equal(ti.numpy()[valid], np.asarray(ji)[valid])
    _close(tg, jg, 1e-6)
    _close(tpr, jpr, 1e-6)


# ---------------------------------------------------------------------------
# the three dispatches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["sort", "cumsum"])
def test_moe_block_matches_jax(arch, dtype, impl):
    """A binding capacity (factor 0.5) in 2 groups: outputs, the drops and
    the aux loss against the reference's ``moe_impl``.  The port ranks by
    sort only: it refuses ``"cumsum"``, and its sort path reproduces the
    reference's cumsum path."""
    jc, tc = _cfgs(arch, dtype, capacity_factor=0.5, moe_impl=impl)
    jp, tp = _layer(jc, tc)
    jx, tx = _x((4, 16, jc.d_model), dtype)
    jy, ja = J["moe_block"](jp, jx, jc, groups=2)
    if impl == "cumsum":
        with pytest.raises(NotImplementedError, match="moe_impl"):
            TM.moe_block(tp, tx, tc, groups=2)
        tc = dataclasses.replace(tc, moe_impl="sort")
    ty, ta = TM.moe_block(tp, tx, tc, groups=2)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    _close(ty, jy, DT[dtype][2])
    assert abs(float(ta) - float(ja)) < 1e-6
    # the capacity binds: some assignment was dropped
    h = TM.rmsnorm(tx, tp.norm, tc.norm_eps).reshape(2, 32, -1)
    _, idx, _ = TM._route_topk(tp.router, h, tc)
    pos = TM._rank_in_expert(idx.reshape(2, -1))
    assert bool((pos >= TM.moe_capacity(tc, 32)).any())


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_block_matches_jax(arch, dtype):
    """Left bucket padding (negative positions) in 2 of 4 rows: outputs and
    the masked aux against the reference."""
    jc, tc = _cfgs(arch, dtype)
    jp, tp = _layer(jc, tc)
    B, S = 4, 12
    jx, tx = _x((B, S, jc.d_model), dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    pos[1:3] -= 5
    jy, ja = J["moe_prefill_block"](jp, jx, jc, jnp.asarray(pos))
    ty, ta = TM.moe_prefill_block(tp, tx, tc, torch.from_numpy(pos))
    _close(ty, jy, DT[dtype][2])
    assert abs(float(ta) - float(ja)) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_padding_never_consumes_capacity_slots(arch):
    """The reference's scenario: serve capacity bounded to 1 slot per
    expert (binding), padding embeddings x10 so an unmasked router would
    route them.  The padded prefill equals the unpadded one at the real
    columns bitwise, in the port, and both equal the reference's."""
    jc, tc = _cfgs(arch, "bfloat16", moe_serve_capacity_factor=0.1)
    B, S, P = 4, 8, 5
    assert TM.moe_serve_capacity(tc, B) == 1
    jp, tp = _layer(jc, tc)
    jx, tx = _x((B, S, jc.d_model), "bfloat16", seed=3)
    jpad, tpad = _x((B, P, jc.d_model), "bfloat16", seed=4)
    jpad, tpad = 10 * jpad, 10 * tpad
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    pos_p = np.broadcast_to(np.arange(S + P, dtype=np.int32) - P, (B, S + P))
    ty, _ = TM.moe_prefill_block(tp, tx, tc, torch.from_numpy(pos.copy()))
    typ, ta = TM.moe_prefill_block(tp, torch.cat([tpad, tx], 1), tc,
                                   torch.from_numpy(pos_p.copy()))
    assert torch.equal(typ[:, P:], ty)
    assert bool(torch.isfinite(typ).all()) and np.isfinite(float(ta))
    jyp, _ = J["moe_prefill_block"](jp, jnp.concatenate([jpad, jx], 1), jc,
                                    jnp.asarray(pos_p))
    _close(typ[:, P:], jyp[:, P:], 2e-2)


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_dispatch_matches_decode_per_position(arch, dtype):
    """The per-position prefill dispatch is the decode dispatch at every
    position: bitwise in the port on the CPU (the prefill's expert products
    have S*C rows, the decode's C); the decode against the reference's."""
    jc, tc = _cfgs(arch, dtype)
    jp, tp = _layer(jc, tc)
    B, S = 4, 8
    jx, tx = _x((B, S, jc.d_model), dtype, seed=7)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    full, _ = TM.moe_prefill_block(tp, tx, tc, pos)
    steps = [TM.moe_decode_block(tp, tx[:, s:s + 1], tc) for s in range(S)]
    assert torch.equal(full, torch.cat([y for y, _ in steps], 1))
    jy, _ = J["moe_decode_block"](jp, jx[:, 3:4], jc)
    _close(steps[3][0], jy, DT[dtype][2])


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("arch", ARCHS)
def test_gather_decode_matches_jax_and_dispatch(arch, dtype):
    """``moe_decode_impl="gather"`` against the reference's gather, and
    within 2e-2 of the dispatch (the reference's own bound)."""
    jc, tc = _cfgs(arch, dtype, moe_decode_impl="gather")
    jp, tp = _layer(jc, tc)
    jx, tx = _x((5, 1, jc.d_model), dtype, seed=5)
    jy, _ = J["moe_decode_block"](jp, jx, jc)
    ty, ta = TM.moe_decode_block(tp, tx, tc)
    _close(ty, jy, DT[dtype][2])
    assert float(ta) == 0.0
    dy, _ = TM.moe_decode_block(tp, tx, dataclasses.replace(
        tc, moe_decode_impl="dispatch"))
    torch.testing.assert_close(ty.float(), dy.float(), atol=2e-2, rtol=2e-2)


def test_quantized_expert_weights_are_refused():
    _, tc = _cfgs("deepseek-moe-16b")

    class QT:                       # stands in for a quantized weight
        pass
    with pytest.raises(NotImplementedError, match="weight_quant"):
        TM._take_expert_rows(QT(), torch.zeros(2, 1, dtype=torch.long),
                             torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_grads_match_jax(arch):
    """Gradients of a loss over ``moe_block``'s output and aux with respect
    to the input and every parameter (the scatter, the gather and the
    dropped assignments included), f32, 1e-5 relative."""
    jc, tc = _cfgs(arch, capacity_factor=0.5)
    jp, tp = _layer(jc, tc)
    jx, tx = _x((4, 16, jc.d_model), "float32")
    wgt = np.random.default_rng(9).standard_normal(
        (4, 16, jc.d_model)).astype(np.float32)

    def jloss(p, x):
        y, a = JM.moe_block(p, x, jc, groups=2)
        return jnp.sum(y * wgt) + 3.0 * a

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jx)
    tx = tx.clone().requires_grad_(True)
    prms = dict(tp.named_parameters())
    for q in prms.values():
        q.requires_grad_(True)
    y, a = TM.moe_block(tp, tx, tc, groups=2)
    loss = (y * torch.from_numpy(wgt)).sum() + 3.0 * a
    grads = torch.autograd.grad(loss, [tx, *prms.values()])
    tg = dict(zip(prms, grads[1:]))
    assert _rel(np.asarray(jg[1]), grads[0].numpy()) < 1e-5
    leaves = [(n[1:], np.asarray(a)) for n, a in _walk("", jg[0])]
    num = sum(np.sum((a - tg[n].numpy().astype(np.float64)) ** 2)
              for n, a in leaves)
    den = sum(np.sum(a.astype(np.float64) ** 2) for _, a in leaves)
    assert np.sqrt(num / den) < 1e-5
    for n, a in leaves:
        assert _rel(a, tg[n].numpy()) < 1e-4, n


# ---------------------------------------------------------------------------
# the MoE smoke models: loss, gradients, train steps
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _pair(arch, seed=0, **over):
    jc = dataclasses.replace(C.get_smoke(arch), vocab_size=512,
                             dtype=jnp.float32, **over)
    tc = dataclasses.replace(TC.get_smoke(arch), vocab_size=512,
                             dtype=torch.float32, **over)
    p = JT.init_params(jc, jax.random.PRNGKey(seed))
    return jc, tc, p, from_jax_params(jax.tree.map(np.asarray, p), tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_jax(arch):
    """``loss_fn`` with the MoE aux (coefficient 0.01) and its gradient
    against ``jax.value_and_grad``, on a batch whose capacity binds."""
    jc, tc, p, model = _pair(arch, capacity_factor=0.5)
    b = JPipe(4, 64).get_batch(0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda pp, bb: JT.loss_fn(pp, jc, bb), has_aux=True))(
            p, {k: jnp.asarray(v) for k, v in b.items()})
    (tl, tm), tg = TR.value_and_grad(TT.loss_fn, model, tc,
                                     device_put_batch(b, "cpu"),
                                     has_aux=True)
    assert float(tm["moe_aux"]) > 0
    assert abs(float(jm["moe_aux"]) - float(tm["moe_aux"])) < 1e-6
    assert abs(float(jl) - float(tl)) < 2e-5
    leaves = list(_named_leaves(jax.tree.map(np.asarray, jg), tc))
    assert sorted(n for n, _ in leaves) == sorted(tg)
    num = sum(np.sum((a - tg[n].numpy().astype(np.float64)) ** 2)
              for n, a in leaves)
    den = sum(np.sum(a.astype(np.float64) ** 2) for _, a in leaves)
    assert np.sqrt(num / den) < 1e-4
    for n, a in leaves:
        assert _rel(a, tg[n].numpy()) < 1e-3, n
    assert any("ffn.shared" in n for n, _ in leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_steps_match_jax(arch):
    """3 f32 AdamW steps from the same weights: losses, parameters, and
    each parameter's change (an Adam step moves a weight by ~lr, so the
    change is held to the reference's in relative norm)."""
    jc, tc, p, model = _pair(arch)
    p0 = dict(_named_leaves(jax.tree.map(np.asarray, p), tc))
    ocfg = dict(lr=1e-3, total_steps=3, warmup_steps=1)
    jstep = JTR.build_train_step(jc, jopt.AdamWConfig(**ocfg), None,
                                 donate=False)
    tstep = TR.build_train_step(tc, opt.AdamWConfig(**ocfg), moe_groups=1)
    js, ts = jopt.init(p), opt.init(model)
    pipe = JPipe(4, 64, world=JWorld(n_ent=16, n_rel=6))
    jl, tl = [], []
    for s in range(3):
        b = pipe.get_batch(s)
        p, js, jm = jstep(p, js, {k: jnp.asarray(v) for k, v in b.items()})
        model, ts, tm = tstep(model, ts, device_put_batch(b, "cpu"))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        assert abs(float(jm["moe_aux"]) - float(tm["moe_aux"])) < 1e-5
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    named = dict(model.named_parameters())
    rels = {}
    for n, a in _named_leaves(jax.tree.map(np.asarray, p), tc):
        np.testing.assert_allclose(named[n].numpy(), a, atol=5e-3, rtol=0,
                                   err_msg=n)
        want = a.astype(np.float64) - p0[n]
        assert np.linalg.norm(want) > 0, n
        rels[n] = _rel(want, named[n].detach().numpy() - p0[n])
    assert any("ffn.w_gate" in n for n in rels)
    assert any("ffn.router" in n for n in rels)
    assert any("ffn.shared" in n for n in rels)
    # a leaf left in place, or moved by another gradient, reads ~1; Adam's
    # sign-like step on near-zero gradients reads up to ~1e-2 (attention wo)
    for n, r in rels.items():
        assert r < 5e-2, (n, r)
