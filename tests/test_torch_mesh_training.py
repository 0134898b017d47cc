"""Training on a (pod, data, model) mesh (``repro_torch.training.train``
with a ``mesh``, ``transformer.shard_params`` under ``DEFAULT_RULES``, the
differentiable collectives of ``distributed/sharding.py``, remat, the mesh
checkpoints and ``launch/train.py --mesh``) against one device and the JAX
package.

* Specs: ``param_shardings`` / ``opt_shardings`` / ``batch_shardings`` and
  ``data.pipeline.batch_sharding`` equal the reference's functions' specs
  (on ``jax.sharding.AbstractMesh`` meshes: no devices) for every arch id,
  full and smoke, under the default and sp rules, on
  ``test_torch_sharding``'s mesh shapes; a stacked reference leaf is
  compared without its leading "layers" entry, as there.
* The (1, 1) mesh, in process: 2 steps of ``build_train_step(mesh=...)``
  on the shard of every arch's smoke are bitwise the one-device step
  (metrics, every parameter, every ``OptState`` tensor) and issue no
  collective; so is ``build_eval_step``.
* Remat: ``cfg.remat`` gives the gradients and steps of ``remat=False``
  bit for bit (f32 and bf16), and the port's remat steps match JAX's.
* The MoE eval with ``moe_groups=2`` against JAX's.

The gloo ranks' tests are ``tests/test_torch_mesh_training_ranks.py``.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from test_torch_archs import _batch as arch_batch
from test_torch_sharding import MESHES, _configs, _unstacked

from repro_torch import configs as TC
from repro_torch.convert import _named_leaves, from_jax_params
from repro_torch.data.pipeline import (SyntheticLMPipeline, batch_sharding,
                                       device_put_batch)
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import serving_mesh
from repro_torch.models import transformer as TT
from repro_torch.training import optimizer as opt
from repro_torch.training import train as TR

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as C  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline as JPipe  # noqa: E402
from repro.data.pipeline import batch_sharding as j_batch_sharding  # noqa
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train as JTR  # noqa: E402

ARCHS = [(a, size) for a in C.ARCH_IDS for size in ("full", "smoke")]


@pytest.fixture(scope="module")
def mesh11():
    return serving_mesh(device="cpu")


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _abstract(shape: dict):
    return jax.sharding.AbstractMesh(tuple(shape.values()),
                                     tuple(shape.keys()))


def _ref_specs(tree, jc) -> dict:
    """{port name: spec} of the reference's ``param_shardings`` tree (its
    NamedShardings' specs, a stacked leaf's without its repeat entry)."""
    shapes, axes = JT.abstract_params(jc), JT.param_axes(jc)

    def box(s, sd, ax):
        stacked = ax[0] == "layers"
        one = _unstacked(s.spec, len(sd.shape), stacked)
        a = np.empty((sd.shape[0],) if stacked else (), dtype=object)
        for i in np.ndindex(a.shape):
            a[i] = one
        return a

    boxed = jax.tree.map(box, tree, shapes, axes, is_leaf=lambda x:
                         isinstance(x, jax.sharding.NamedSharding))
    return {n: a.item() if isinstance(a, np.ndarray) else a
            for n, a in _named_leaves(boxed, jc)}


@pytest.mark.parametrize("arch,size", ARCHS,
                         ids=[f"{a}-{s}" for a, s in ARCHS])
def test_shardings_match_reference(arch, size):
    jc, tc = _configs(arch, size)
    n = 0
    for shape in MESHES:
        mesh = _abstract(shape)
        assert batch_sharding(mesh) == tuple(j_batch_sharding(mesh).spec)
        for r in ("default", "sp"):
            jr, tr = jsh.RULE_SETS[r], sh.RULE_SETS[r]
            got = TR.param_shardings(tc, mesh, tr)
            assert got == _ref_specs(JTR.param_shardings(jc, mesh, jr), jc)
            os_ = TR.opt_shardings(tc, mesh, tr)
            assert os_.step == () and os_.master is os_.m is os_.v
            assert os_.master == got
            spec = {"tokens": (16, 64), "labels": (16, 64),
                    "frontend_embeds": (16, 8, tc.d_model),
                    "loss_mask": (4, 64)}
            want = JTR.batch_shardings(
                {k: jax.ShapeDtypeStruct(v, jnp.float32)
                 for k, v in spec.items()}, mesh, jr)
            assert TR.batch_shardings(
                {k: torch.empty(v, device="meta") for k, v in spec.items()},
                mesh, tr) == {k: _unstacked(v.spec, len(spec[k]), False)
                              for k, v in want.items()}
            n += len(got)
    assert n > 0


def test_default_rules_are_the_reference_default():
    tc = TC.get_smoke("llama3-8b")
    mesh = _abstract({"data": 2, "model": 2})
    assert TR.param_shardings(tc, mesh) == TR.param_shardings(
        tc, mesh, sh.DEFAULT_RULES)
    assert TR.param_shardings(tc, mesh)["layers.0.mixer.wq"] == (
        "data", "model")


# ---------------------------------------------------------------------------
# the (1, 1) mesh in process
# ---------------------------------------------------------------------------

def _smoke(arch: str):
    cfg = dataclasses.replace(TC.get_smoke(arch), vocab_size=512)
    return cfg, TT.init_params(cfg, torch.Generator().manual_seed(5),
                               device="cpu")


def _host_batches(cfg, n: int, B: int = 4, S: int = 32):
    if cfg.frontend is not None or cfg.family in ("encoder", "audio"):
        return [arch_batch(cfg, B=B, S=S, seed=i) for i in range(n)]
    pipe = SyntheticLMPipeline(B, S, seed=1)
    return [pipe.get_batch(i) for i in range(n)]


def _equal(a, b) -> bool:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_mesh11_step_is_one_device_bitwise(mesh11, arch):
    cfg, model = _smoke(arch)
    twin = copy.deepcopy(model)
    comm = sh.Comm(mesh11)
    shard = TT.shard_params(twin, cfg, mesh11, comm, rules=sh.DEFAULT_RULES)
    assert all(not (c.tp_axes or c.dp_axes) for c in shard.cuts.values())
    oc = opt.AdamWConfig(lr=1e-3, warmup_steps=1)
    one, sstate = opt.init(model), opt.init(shard)
    step, mstep = TR.build_train_step(cfg, oc), TR.build_train_step(
        cfg, oc, mesh11)
    host = _host_batches(cfg, 3)
    for b in host[:2]:
        _, _, a = step(model, one, device_put_batch(b, "cpu"))
        _, _, m = mstep(shard, sstate, device_put_batch(b, mesh11, "cpu"))
        assert sorted(a) == sorted(m)
        for k in a:
            assert _equal(a[k], m[k]), (arch, k, a[k], m[k])
    for (n, p), q in zip(model.named_parameters(), shard.parameters()):
        assert _equal(p, q), n
    assert sstate.step == one.step == 2
    for f in ("master", "m", "v"):
        for n, t in getattr(one, f).items():
            assert _equal(t, getattr(sstate, f)[n]), (f, n)
    ev, mev = TR.build_eval_step(cfg), TR.build_eval_step(cfg, mesh11)
    a = ev(model, device_put_batch(host[2], "cpu"))
    m = mev(shard, device_put_batch(host[2], mesh11, "cpu"))
    assert all(_equal(a[k], m[k]) for k in a)
    assert comm.stats == sh.Comm(mesh11).stats      # nothing issued


def test_steps_take_a_mesh_and_its_shard(mesh11):
    cfg, model = _smoke("llama3-8b")
    oc = opt.AdamWConfig()
    for bad in (object(), {"data": 1, "model": 1}):
        with pytest.raises(TypeError):
            TR.build_train_step(cfg, oc, mesh=bad)
        with pytest.raises(TypeError):
            TR.build_eval_step(cfg, mesh=bad)
    step = TR.build_train_step(cfg, oc, mesh11)
    b = device_put_batch(_host_batches(cfg, 1)[0], mesh11, "cpu")
    with pytest.raises(ValueError, match="shard"):
        step(model, opt.init(model), b)            # the whole model
    serve = TT.shard_params(model, cfg, mesh11)     # SERVE_RULES
    with pytest.raises(ValueError, match="rules"):
        step(serve, opt.init(serve), b)


def test_device_put_batch_hands_out_rows(mesh11):
    b = {"tokens": np.arange(12, dtype=np.int32).reshape(6, 2)}
    got = device_put_batch(b, mesh11, "cpu")["tokens"]
    assert torch.equal(got, torch.as_tensor(b["tokens"]))
    one = device_put_batch(b, "cpu")["tokens"]
    assert torch.equal(one, got)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-moe-16b",
                                  "recurrentgemma-2b"])
def test_remat_is_bitwise(arch, dtype):
    """``cfg.remat`` recomputes each layer in the backward
    (``transformer._Remat``): the loss, the metrics and every
    gradient are those of ``remat=False``, and so are 2 AdamW steps."""
    base = dataclasses.replace(TC.get_smoke(arch), vocab_size=512,
                               dtype=getattr(torch, dtype))
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(base, remat=remat)
        model = TT.init_params(cfg, torch.Generator().manual_seed(2),
                               device="cpu")
        host = _host_batches(cfg, 2)
        (loss, met), g = TR.value_and_grad(
            lambda m, b: TT.loss_fn(m, cfg, b, moe_groups=2), model,
            device_put_batch(host[0], "cpu"), has_aux=True)
        state = opt.init(model)
        step = TR.build_train_step(cfg, opt.AdamWConfig(lr=1e-3),
                                   moe_groups=2)
        ms = [step(model, state, device_put_batch(b, "cpu"))[2]
              for b in host]
        out.append((loss, met, g, ms, dict(model.named_parameters())))
    (l1, m1, g1, s1, p1), (l0, m0, g0, s0, p0) = out
    assert _equal(l1, l0) and all(_equal(m1[k], m0[k]) for k in m1)
    assert all(_equal(g1[n], g0[n]) for n in g1)
    assert all(_equal(a[k], b[k]) for a, b in zip(s1, s0) for k in a)
    assert all(_equal(p1[n], p0[n]) for n in p1)


def test_remat_recomputes_in_the_backward(monkeypatch):
    """Each layer's forward runs twice in a remat step (once more in the
    backward), once without remat."""
    from repro_torch.models import ffn
    calls = []
    real = ffn.mlp_block
    monkeypatch.setattr(ffn, "mlp_block",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for remat, want in ((True, 2), (False, 1)):
        cfg = dataclasses.replace(TC.get_smoke("llama3-8b"), vocab_size=512,
                                  remat=remat)
        model = TT.init_params(cfg, torch.Generator().manual_seed(2),
                               device="cpu")
        calls.clear()
        TR.value_and_grad(lambda m, b: TT.loss_fn(m, cfg, b), model,
                          device_put_batch(_host_batches(cfg, 1)[0], "cpu"),
                          has_aux=True)
        assert len(calls) == want * cfg.num_layers, (remat, len(calls))


@pytest.mark.parametrize("remat", [True, False])
def test_remat_steps_match_jax(remat):
    """3 f32 AdamW steps with and without remat in both packages, from the
    same weights: losses 1e-4 relative, parameters 5e-3
    (``test_f32_adamw_steps_match_jax``'s budget)."""
    jc = dataclasses.replace(C.get_smoke("llama3-8b"), vocab_size=512,
                             dtype=jnp.float32, remat=remat)
    tc = dataclasses.replace(TC.get_smoke("llama3-8b"), vocab_size=512,
                             dtype=torch.float32, remat=remat)
    p = JT.init_params(jc, jax.random.PRNGKey(4))
    model = from_jax_params(jax.tree.map(np.asarray, p), tc)
    oc, joc = opt.AdamWConfig(lr=1e-3), jopt.AdamWConfig(lr=1e-3)
    jstep = JTR.build_train_step(jc, joc, None, donate=False)
    tstep = TR.build_train_step(tc, oc)
    js, ts = jopt.init(p), opt.init(model)
    pipe = JPipe(4, 32, seed=2)
    for i in range(3):
        b = pipe.get_batch(i)
        p, js, jm = jstep(p, js, {k: jnp.asarray(v) for k, v in b.items()})
        _, _, tm = tstep(model, ts, device_put_batch(b, "cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    named = dict(model.named_parameters())
    for n, a in _named_leaves(jax.tree.map(np.asarray, p), jc):
        np.testing.assert_allclose(named[n].numpy(), a, atol=5e-3, rtol=0,
                                   err_msg=n)


# ---------------------------------------------------------------------------
# the MoE eval's groups
# ---------------------------------------------------------------------------

def test_moe_eval_with_groups_matches_jax():
    """``build_eval_step(cfg, moe_groups=2)`` (the reference's signature:
    ``rules`` and ``moe_groups``) against the JAX package's, f32 smoke
    deepseek-moe-16b on a batch whose capacity binds."""
    jc = dataclasses.replace(C.get_smoke("deepseek-moe-16b"), vocab_size=512,
                             dtype=jnp.float32, capacity_factor=0.5)
    tc = dataclasses.replace(TC.get_smoke("deepseek-moe-16b"),
                             vocab_size=512, dtype=torch.float32,
                             capacity_factor=0.5)
    p = JT.init_params(jc, jax.random.PRNGKey(6))
    model = from_jax_params(jax.tree.map(np.asarray, p), tc)
    b = JPipe(4, 32, seed=3).get_batch(0)
    jm = JTR.build_eval_step(jc, None, None, moe_groups=2)(
        p, {k: jnp.asarray(v) for k, v in b.items()})
    tm = TR.build_eval_step(tc, None, None, moe_groups=2)(
        model, device_put_batch(b, "cpu"))
    t1 = TR.build_eval_step(tc, moe_groups=1)(model,
                                             device_put_batch(b, "cpu"))
    for k in ("nll", "moe_aux", "tokens"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   err_msg=k)
    assert float(tm["moe_aux"]) != float(t1["moe_aux"])   # groups matter
