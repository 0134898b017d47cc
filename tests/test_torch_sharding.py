"""The port's mesh placement (``repro_torch.distributed.sharding``,
``repro_torch.launch.mesh``) against the reference's.

* ``spec_for`` / ``tree_specs`` equal the reference's on every parameter
  leaf (the reference's ``param_axes``, matched to the port's names through
  ``convert._named_leaves``, which unstacks the repeat axis: a stacked
  leaf's spec is compared without its leading "layers" entry, which no
  rule shards) and every cache leaf (``cache_axes``), for all 11 arch ids,
  full and smoke, under the ``default``, ``sp`` and ``serve`` rule sets, on
  mesh shapes (1,1) (4,2) (2,4) (8,1) (1,8) (16,16) (2,2,2) (2,16,16).  The
  reference's ``spec_for`` reads only ``mesh.shape``: both sides get a stub
  with a ``shape`` dict, so no fake devices are needed.
* ``serving_mesh`` / ``elastic_mesh`` / ``make_production_mesh`` /
  ``data_shards`` shapes equal the reference's for 1-16 devices
  (``jax.devices`` and ``jax.make_mesh`` monkeypatched, and the port's
  world size and mesh constructor).
* The port's own pieces: rule-set hashing, ``local_slices`` / ``shard``,
  ``constrain`` and a ``Comm`` on a world of one (no collective issued).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from repro_torch import configs as TC
from repro_torch.convert import _layer_blocks, _named_leaves
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as TT

jax = pytest.importorskip("jax")

from repro import configs as C  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

MESHES = [{"data": 1, "model": 1}, {"data": 4, "model": 2},
          {"data": 2, "model": 4}, {"data": 8, "model": 1},
          {"data": 1, "model": 8}, {"data": 16, "model": 16},
          {"pod": 2, "data": 2, "model": 2},
          {"pod": 2, "data": 16, "model": 16}]
RULES = ("default", "sp", "serve")
ARCHS = [(a, size) for a in C.ARCH_IDS for size in ("full", "smoke")]


def _stub(shape: dict):
    return SimpleNamespace(shape=dict(shape))


def _configs(arch, size):
    get = (C.get_config, TC.get_config) if size == "full" else (
        C.get_smoke, TC.get_smoke)
    return get[0](arch), get[1](arch)


def _full(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def _unstacked(spec, ndim: int, stacked: bool) -> tuple:
    """A reference spec without its leading repeat entry (stacked leaves),
    trimmed as spec_for trims."""
    parts = list(_full(spec, ndim))
    if stacked:
        assert parts[0] is None
        parts = parts[1:]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _ref_param_specs(jc, mesh, rules):
    """{port name: the reference's spec} over the reference's tree."""
    shapes = JT.abstract_params(jc)
    axes = JT.param_axes(jc)
    specs = jsh.tree_specs(shapes, axes, mesh, rules.param_rules)

    def box(s, sd, ax):
        stacked = ax[0] == "layers"
        one = _unstacked(s, len(sd.shape), stacked)
        a = np.empty((sd.shape[0],) if stacked else (), dtype=object)
        a[...] = None
        for i in np.ndindex(a.shape):
            a[i] = one
        return a

    boxed = jax.tree.map(box, specs, shapes, axes,
                         is_leaf=lambda x: isinstance(x, jax.sharding
                                                      .PartitionSpec))
    out = {}
    for name, a in _named_leaves(boxed, jc):
        out[name] = a.item() if isinstance(a, np.ndarray) else a
    return out


@pytest.mark.parametrize("arch,size", ARCHS,
                         ids=[f"{a}-{s}" for a, s in ARCHS])
def test_param_specs_match_reference(arch, size):
    jc, tc = _configs(arch, size)
    model = TT.Transformer(tc, device="meta")
    axes = TT.param_axes(model)
    shapes = {n: p.shape for n, p in model.named_parameters()}
    n_checked = 0
    for shape in MESHES:
        mesh = _stub(shape)
        for r in RULES:
            ref = _ref_param_specs(jc, mesh, jsh.RULE_SETS[r])
            got = sh.tree_specs(shapes, axes, mesh,
                                sh.RULE_SETS[r].param_rules)
            assert got.keys() == ref.keys()
            for n in got:
                assert got[n] == ref[n], (n, shape, r, got[n], ref[n])
            n_checked += len(got)
    assert n_checked == len(shapes) * len(MESHES) * len(RULES)


@pytest.mark.parametrize("arch,size", ARCHS,
                         ids=[f"{a}-{s}" for a, s in ARCHS])
def test_cache_specs_match_reference(arch, size):
    jc, tc = _configs(arch, size)
    for B, Tn in ((16, 256), (3, 100)):
        jshapes = jax.eval_shape(lambda: JT.init_cache(jc, B, Tn))
        tshapes = TT.init_cache(tc, B, Tn, device="meta")
        for shape in MESHES:
            mesh = _stub(shape)
            for r in RULES:
                rules = sh.RULE_SETS[r].act_rules
                ref = jsh.tree_specs(jshapes, JT.cache_axes(jc), mesh,
                                     jsh.RULE_SETS[r].act_rules)
                got = sh.tree_specs(tshapes, TT.cache_axes(tc), mesh, rules)
                jc_axes = JT.cache_axes(jc)
                for (layer, blk, rep), (_, blk_ax, _), (_, blk_sd, _) in zip(
                        _layer_blocks(ref, tc), _layer_blocks(jc_axes, tc),
                        _layer_blocks(jshapes, tc)):
                    entry = next(x for x in blk if x is not None)
                    ent_ax = next(x for x in blk_ax if x is not None)
                    ent_sd = next(x for x in blk_sd if x is not None)
                    mine = got[layer]
                    assert type(mine).__name__ == type(entry).__name__
                    for f in mine._fields:
                        want = _unstacked(getattr(entry, f),
                                          len(getattr(ent_sd, f).shape),
                                          rep is not None)
                        assert getattr(mine, f) == want, \
                            (layer, f, shape, r, getattr(mine, f), want)
                        assert len(getattr(ent_ax, f)) == len(
                            getattr(ent_sd, f).shape)


def test_rule_sets_hash_and_override():
    assert sh.SERVE_RULES == sh.DEFAULT_RULES.with_overrides(
        params={"embed": (), "vocab": (("model",),)})
    assert hash(sh.SERVE_RULES) == hash(sh.DEFAULT_RULES.with_overrides(
        params={"embed": (), "vocab": (("model",),)}))
    assert sh.SP_RULES != sh.DEFAULT_RULES
    assert len({sh.DEFAULT_RULES, sh.SP_RULES, sh.SERVE_RULES,
                sh.ShardingRules()}) == 3
    for r in RULES:
        ref = jsh.RULE_SETS[r]
        assert dict(sh.RULE_SETS[r].param_rules) == dict(ref.param_rules)
        assert dict(sh.RULE_SETS[r].act_rules) == dict(ref.act_rules)
    assert sh.AXIS_PRIORITY == jsh.AXIS_PRIORITY


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_shapes_match_reference(n, monkeypatch):
    """The builders' arithmetic, the reference's over ``n`` devices and the
    port's over ``n`` ranks."""
    monkeypatch.setattr(jax, "devices", lambda *a: list(range(n)))
    monkeypatch.setattr(jax, "make_mesh",
                        lambda shape, axes: _stub(dict(zip(axes, shape))))
    monkeypatch.setattr(tmesh, "ensure_world", lambda device=None: n)
    monkeypatch.setattr(tmesh, "_device_mesh",
                        lambda shape, names: _stub(dict(zip(names, shape))))
    for mp in range(1, 18):
        ref = jmesh.serving_mesh(model_parallel=mp)
        got = tmesh.serving_mesh(model_parallel=mp)
        assert got.shape == dict(ref.shape), (n, mp)
        assert list(got.shape) == list(ref.shape)
        assert tmesh.data_shards(got) == jmesh.data_shards(ref)
        for pods in (1, 2, 3, 4):
            ref = jmesh.elastic_mesh(model_parallel=mp, pods=pods)
            got = tmesh.elastic_mesh(model_parallel=mp, pods=pods)
            assert list(got.shape.items()) == list(dict(ref.shape).items())
            assert tmesh.data_shards(got) == jmesh.data_shards(ref)
    for multi in (False, True):
        ref = jmesh.make_production_mesh(multi_pod=multi)
        got = tmesh.make_production_mesh(multi_pod=multi)
        assert list(got.shape.items()) == list(dict(ref.shape).items())


@pytest.fixture(scope="module")
def mesh11():
    return tmesh.serving_mesh(device="cpu")


def test_world_of_one_mesh(mesh11):
    from torch.distributed.device_mesh import DeviceMesh
    assert isinstance(mesh11, DeviceMesh)
    assert mesh11.mesh_dim_names == ("data", "model")
    assert sh.axis_sizes(mesh11) == {"data": 1, "model": 1}
    assert tmesh.data_shards(mesh11) == 1
    assert tmesh.serving_mesh(model_parallel=4, device="cpu").shape == (1, 1)
    with pytest.raises(ValueError, match="ranks"):
        tmesh.make_production_mesh(device="cpu")


def test_local_slices_shard_and_constrain(mesh11):
    x = torch.arange(24.0).reshape(4, 6)
    spec = sh.spec_for(x.shape, ("act_batch", "act_vocab"), mesh11,
                       sh.SERVE_RULES.act_rules)
    assert spec == ("data", "model")
    assert sh.local_slices(x.shape, spec, mesh11) == (slice(0, 4),
                                                      slice(0, 6))
    assert sh.shard(x, spec, mesh11) is x
    assert sh.constrain(x, ("act_batch", None), None) is x
    assert torch.equal(sh.constrain(x, ("act_batch", None), mesh11), x)
    # shard indices are major to minor over a tuple of axes
    stub = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                           shape=(2, 3, 2), get_coordinate=lambda: (1, 2, 0))
    assert sh.shard_index(("pod", "data"), stub) == (5, 6)
    assert sh.local_slices((12, 4), (("pod", "data"), "model"), stub) == (
        slice(10, 12), slice(0, 2))
    with pytest.raises(ValueError, match="rank"):
        sh.spec_for((4,), ("act_batch", None), mesh11, sh.ACT_RULES)


def test_comm_issues_nothing_on_a_world_of_one(mesh11):
    comm = sh.Comm(mesh11)
    x = torch.randn(3, 5, dtype=torch.bfloat16)
    assert comm.all_reduce(x, ("model",)) is x
    assert comm.all_gather(x, ("data",), 0) is x
    assert comm.all_gather(x, None, 0) is x
    assert comm.stats["all_reduce"] == comm.stats["all_gather"] == 0
    with pytest.raises(TypeError, match="DeviceMesh"):
        sh.Comm(_stub({"data": 1, "model": 1}))


def test_param_axes_cover_every_parameter():
    from repro_torch.core import safety as TS
    for arch in C.ARCH_IDS:
        m = TT.Transformer(TC.get_smoke(arch), device="meta")
        axes = TT.param_axes(m)
        assert axes.keys() == dict(m.named_parameters()).keys()
        for n, p in m.named_parameters():
            assert len(axes[n]) == p.ndim, n
    scfg = TS.classifier_config(vocab_size=512)
    sm = TS.SafetyClassifier(dataclasses.replace(scfg), device="meta")
    assert TT.param_axes(sm)["head_w"] == ("embed", None)
