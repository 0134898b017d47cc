"""The recurrent mixers and MoE expert parallelism on a mesh:
``InferenceEngine(mesh=...)`` serving the RG-LRU (its width over 'model'),
the SSD (its heads, in_proj cut segment by segment) and the MoE (its
experts, the router logits gathered, the routed rows joined by one
all-reduce).

* On the (1, 1) mesh, in process (a gloo world of one), for the
  ``recurrentgemma-2b``, ``mamba2-780m``, ``deepseek-moe-16b`` and
  ``llama4-scout-17b-a16e`` smokes, monolithic and paged: cold
  ``generate``, ``absorb`` + a warm continuation, a decode-only extension,
  ``state_select``, ``fanout`` (paged) and ``serve()`` are BITWISE the
  single-device port engine, with the graph layer's CPU backend as
  without it (one replay per ``generate``); and tie-aware equal to the
  JAX single-device engine on f32 copies (the recurrent smokes' matrices
  scaled by 6, as the recurrent engine tests hold them), within 1e-4.
* Multi-rank (``tests/torch_mesh_ranks.py``, each job a subprocess under
  its own timeout): 4 gloo ranks on (1, 4), (2, 2) and (4, 1), each rank's
  leaves the placements' slices bitwise (the SSD's segment cut written out
  by hand, the RG-LRU's columns, E/m experts, ``QTensor`` experts the
  slices of the whole quantized tree), its states and pool rows of its
  width or heads, every entry point tie-aware one device's (a paged
  deepseek with int8 weights on (2, 2)), and MoE's combine bitwise one
  device's (``mixers``); recurrent sessions saved on (1, 2) and restored
  on (1, 2) bitwise, on one device and on (2, 1) tie-aware, and saved on
  (2, 1) and restored on (1, 2) (``mixers_ckpt``), then here on the
  (1, 1) mesh.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from repro_torch.core.uncertainty import UncertaintyConfig as TU
from repro_torch.launch.mesh import serving_mesh
from repro_torch.models import transformer as TT
from repro_torch.serving import graphs
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.serving.scheduler import Request
from repro_torch.training import train as TTR

from test_torch_engine import PROMPTS, assert_greedy_match_modulo_ties
from test_torch_mesh_paged import _bitwise, _run
from torch_mesh_ranks import (MIX_CKPT, MIXERS, RECURRENT, SPAN,
                              check_state_shapes, mixer_ckpt_reference,
                              mixer_model, tie_aware)

ROOT = Path(__file__).resolve().parents[1]
PAGED = dict(paged=True, block_len=8, pool_blocks=256, pool_rows=32)
LAYOUTS = {"mono": {}, "paged": PAGED}
UC = dict(mode="distribution")


@pytest.fixture(scope="module")
def mesh11():
    return serving_mesh(device="cpu")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", MIXERS)
def test_degenerate_mesh_is_bitwise_single_device(mesh11, arch, layout):
    """The (1, 1) mesh is the single-device engine: every entry point
    bitwise, nothing crosses the mesh or is cut (no module carries a
    ``Split``; the config and the pool are one device's), and with the
    graph layer each generate is one replay, as on one device."""
    cfg, m = mixer_model(arch, torch.bfloat16, 1)
    kw = LAYOUTS[layout]
    one = TEngine(arch, cfg, m, TU(**UC), device="cpu", **kw)
    me = TEngine(arch, cfg, m, TU(**UC), device="cpu", mesh=mesh11, **kw)
    for a, b in zip(_run(me), _run(one)):
        _bitwise(a, b, f"{arch} {layout}")
    st = me.comm.stats
    assert st["all_reduce"] == st["all_gather"] == st["agree"] == 0, st
    assert me.counters == one.counters
    assert me._mcfg == cfg and not me._state_cut
    assert not any(hasattr(x, "tp") for x in me.params.modules())
    full = dict(m.named_parameters())
    assert all(p is full[n] for n, p in me.params.named_parameters())
    if me.paged:
        assert me.pool.row_bytes == one.pool.row_bytes
        assert me.pool.counters == one.pool.counters
    for eng in (one, me):
        eng._graphs = graphs.DecodeGraphs(graphs.Rerun())
    r0, r1 = one.generate(PROMPTS, 4), me.generate(PROMPTS, 4)
    _bitwise(r1, r0, f"{arch} {layout} graphed")
    counts = [{k: e._graphs.stats[k] for k in ("captures", "replays")}
              for e in (one, me)]
    assert counts[0] == counts[1] == {"captures": 1, "replays": 1}, counts


@pytest.fixture(scope="module")
def jax_pairs():
    """{arch: (JAX config, port config, JAX params, port model)}, f32 at
    vocabulary 512 from one JAX draw each (the recurrent smokes' matrices
    but the embedding and the convs scaled by 6), built on first use."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as C
    from repro.models import transformer as JT
    from repro_torch import configs as TC
    from repro_torch.convert import from_jax_params
    cache = {}

    def get(arch):
        if arch not in cache:
            jc = dataclasses.replace(C.get_smoke(arch), vocab_size=512,
                                     dtype=jnp.float32,
                                     attn_prefill_impl="flash")
            tc = dataclasses.replace(TC.get_smoke(arch), vocab_size=512,
                                     dtype=torch.float32)
            p = jax.jit(JT.init_params, static_argnums=0)(
                jc, jax.random.PRNGKey(MIXERS.index(arch)))
            if arch in RECURRENT:
                def scale(path, a):
                    name = jax.tree_util.keystr(path)
                    big = (a.ndim >= 2 and "embed" not in name
                           and "conv" not in name)
                    return a * 6 if big else a
                p = jax.tree_util.tree_map_with_path(scale, p)
            cache[arch] = (jc, tc, p,
                           from_jax_params(jax.tree.map(np.asarray, p), tc))
        return cache[arch]
    return get


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", MIXERS)
def test_degenerate_mesh_matches_jax_tie_aware(mesh11, jax_pairs, arch,
                                               layout):
    """Against the JAX single-device engine of the same layout, on f32
    copies: cold ``generate``, its decode-only extension, ``state_select``
    of it, ``absorb`` + a warm continuation and ``serve()``, tokens
    tie-aware and logits within 1e-4."""
    from repro.core.uncertainty import UncertaintyConfig as JU
    from repro.serving.engine import InferenceEngine as JEngine
    jc, tc, p, m = jax_pairs(arch)
    kw = LAYOUTS[layout]
    je = JEngine("j", jc, p, JU(**UC), **kw)
    me = TEngine("t", tc, m, TU(**UC), device="cpu", mesh=mesh11, **kw)

    def np_(res):
        lg = res["logits"]
        return {**res, "logits": lg.float().numpy()
                if isinstance(lg, torch.Tensor) else np.asarray(lg,
                                                                np.float32)}

    def tie(a, b):
        assert_greedy_match_modulo_ties(np_(a), np_(b), atol=1e-4)
    r1 = me.generate(PROMPTS, 6, return_state=True)
    r0 = je.generate(PROMPTS, 6, return_state=True)
    tie(r1, r0)
    same = [b for b in range(len(PROMPTS))
            if np.array_equal(r1["tokens"][b], r0["tokens"][b])]
    pick = [same[-1], same[0]]
    e1 = me.generate(None, 4, state=r1["state"], return_state=True)
    e0 = je.generate(None, 4, state=r0["state"], return_state=True)
    tie(e1, e0)
    tie(me.generate(None, 3, state=me.state_select(e1["state"], pick)),
        je.generate(None, 3, state=je.state_select(e0["state"], pick)))
    tie(me.generate(SPAN, 4, state=me.absorb(PROMPTS)),
        je.generate(SPAN, 4, state=je.absorb(PROMPTS)))
    fin = {f["rid"]: f["tokens"] for f in me.serve(
        [Request(rid=i, prompt=PROMPTS[i].tolist(), max_new=5)
         for i in range(len(PROMPTS))], n_slots=2, decode_chunk=2)}
    g = je.generate(PROMPTS, 5)
    tie_aware({"tokens": [fin[i] for i in range(len(PROMPTS))]},
              {"tokens": np.asarray(g["tokens"]), "logits": torch.from_numpy(
                  np.array(g["logits"], np.float32))},
              f"{arch} {layout} serve", atol=1e-4)


def test_unported_layouts_on_a_mixer_raise(mesh11):
    """A mesh shard of an MoE, which once refused the full-sequence
    dispatch (training and ``forward`` on a mesh), runs it: on the (1, 1)
    mesh its loss, metrics and gradients are the single-device model's,
    bit for bit (tests/test_torch_mesh_training.py trains on meshes)."""
    cfg, m = mixer_model("deepseek-moe-16b", torch.float32, 0)
    eng = TEngine("x", cfg, m, device="cpu", mesh=mesh11)
    assert eng.generate(PROMPTS, 2)["tokens"].shape == (len(PROMPTS), 2)
    batch = {"tokens": torch.as_tensor(PROMPTS), "labels":
             torch.as_tensor(PROMPTS)}
    (loss, met), grads = TTR.value_and_grad(
        lambda p, b: TT.loss_fn(p, eng._mcfg, b), eng.params, batch,
        has_aux=True)
    (one, one_met), one_grads = TTR.value_and_grad(
        lambda p, b: TT.loss_fn(p, cfg, b), m, batch, has_aux=True)
    assert torch.isfinite(loss) and torch.equal(loss, one)
    assert all(torch.equal(met[k], one_met[k]) for k in met)
    assert all(torch.equal(grads[n], one_grads[n]) for n in one_grads)


def _ranks(job: str, *args, timeout: int = 300) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "tests" /
                                               "torch_mesh_ranks.py"), job,
                           *map(str, args)],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    assert "RESULT ok" in proc.stdout, proc.stdout
    return proc.stdout


def test_four_ranks_mixers_match_single_device():
    out = _ranks("mixers")
    for shape in ("{'data': 1, 'model': 4}", "{'data': 2, 'model': 2}",
                  "{'data': 4, 'model': 1}"):
        assert f"mixers mesh {shape} ok" in out, out
    assert "moe combine bitwise ok" in out, out


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_sessions_restore_across_meshes(mesh11, tmp_path_factory,
                                                  arch):
    """Saved on (1, 2) paged (two ranks), restored here on the (1, 1) mesh,
    paged and monolithic, and on one device: tie-aware the (1, 2) run's
    uninterrupted continuation.  Saved on the (1, 1) mesh and restored on
    it and on one device, paged: bitwise the uninterrupted continuation,
    which is itself bitwise one device's."""
    tmp = _ckpt_dir(tmp_path_factory)
    cfg, m, r0, c0 = mixer_ckpt_reference(arch)
    d12 = str(tmp / (arch + "12"))
    z = np.load(d12 + ".npz")
    c12 = {"tokens": z["tokens"], "logits": torch.from_numpy(z["logits"])}
    for kw in (dict(mesh=mesh11), dict(mesh=mesh11, **MIX_CKPT), {}):
        e = TEngine("e", cfg, m, TU(**UC), device="cpu", **kw)
        st = e.restore_session(d12)
        if not e.paged:
            check_state_shapes(cfg, st.cache, mesh11)
        x = e.generate(None, 5, state=st)
        tie_aware(x, c12, f"{arch} (1,2) -> {kw}")
    me = TEngine("e", cfg, m, TU(**UC), device="cpu", mesh=mesh11,
                 **MIX_CKPT)
    r = me.generate(PROMPTS, 6, return_state=True)
    d11 = str(tmp / (arch + "11"))
    me.checkpoint_session(r["state"], d11)
    c11 = me.generate(None, 5, state=r["state"])
    _bitwise(c11, c0, f"{arch} (1,1) uninterrupted")
    for kw in (dict(mesh=mesh11, **MIX_CKPT), MIX_CKPT):
        e = TEngine("e", cfg, m, TU(**UC), device="cpu", **kw)
        x = e.generate(None, 5, state=e.restore_session(d11))
        _bitwise(x, c11, f"{arch} (1,1) -> {kw}")


_CKPT = {}


def _ckpt_dir(factory) -> Path:
    """The ``mixers_ckpt`` job's directory, run once per module."""
    if "dir" not in _CKPT:
        d = factory.mktemp("mixers_ckpt")
        out = _ranks("mixers_ckpt", d, timeout=180)
        for arch in RECURRENT:
            assert f"{arch} ckpt ok" in out, out
        _CKPT["dir"] = d
    return _CKPT["dir"]


def test_serve_returns_rank_width_states(mesh11):
    """A paged recurrent engine on the (1, 1) mesh hands ``serve()``'s
    sessions back as one device does: its pool rows hold the whole width,
    and a returned session extends bitwise."""
    cfg, m = mixer_model("recurrentgemma-2b", torch.bfloat16, 2)
    one = TEngine("a", cfg, m, TU(**UC), device="cpu", **PAGED)
    me = TEngine("b", cfg, m, TU(**UC), device="cpu", mesh=mesh11, **PAGED)
    check_state_shapes(cfg, me.pool.arrays, mesh11)
    outs = []
    for e in (one, me):
        fin = e.serve([Request(rid=0, prompt=PROMPTS[0].tolist(), max_new=4,
                               return_state=True)], n_slots=2)
        outs.append(e.generate(None, 3, state=fin[0]["state"]))
    _bitwise(outs[1], outs[0], "serve() session on the (1, 1) mesh")


@pytest.mark.parametrize("G,m", [(1, 2), (1, 4), (2, 2), (2, 4), (4, 2)])
def test_ssd_rank_columns_cut_each_segment(G, m):
    """``ssm.rank_columns``: each rank's in_proj columns are its z, x, B,
    C and dt segments in that order (the B/C of the groups its heads read:
    one group per rank where m is a multiple of G, G/m where G is), the
    conv's its x, B and C; together the ranks cover every column, and
    the shared B/C columns are the same on the ranks that read a group."""
    from repro_torch import configs as TC
    from repro_torch.models import ssm
    cfg = dataclasses.replace(TC.get_smoke("mamba2-780m"), ssm_ngroups=G)
    di, H, P, _, N, conv_dim, d_in = ssm._dims(cfg)
    cols = [ssm.rank_columns(cfg, r, m) for r in range(m)]
    assert sorted({c for rc in cols for c in rc.in_proj}) == list(range(d_in))
    assert sorted({c for rc in cols for c in rc.conv}) == list(range(conv_dim))
    for r, rc in enumerate(cols):
        hl, dl = H // m, di // m
        assert (rc.h0, rc.heads) == (r * hl, hl)
        # the groups its heads read: head h reads group h // (H // G)
        assert {h // (H // G) for h in range(rc.h0, rc.h0 + hl)} == set(
            range(rc.g0, rc.g0 + rc.groups))
        bc = list(range(rc.g0 * N, (rc.g0 + rc.groups) * N))
        x = list(range(r * dl, (r + 1) * dl))
        assert rc.conv == x + [di + c for c in bc] + [di + G * N + c
                                                     for c in bc]
        assert rc.in_proj == (x + [di + c for c in rc.conv]
                              + [di + conv_dim + h
                                 for h in range(rc.h0, rc.h0 + hl)])


def test_ssd_groups_that_neither_divide_raise():
    """2 groups over 3 ranks: neither divides the other."""
    from repro_torch import configs as TC
    from repro_torch.models import ssm
    cfg = dataclasses.replace(TC.get_smoke("mamba2-780m"), ssm_ngroups=2,
                              ssm_head_dim=8)                  # 16 heads
    with pytest.raises(NotImplementedError, match="SSD groups"):
        ssm.rank_columns(cfg, 0, 3)


class _GatherComm:
    """A ``Comm`` stand-in whose all-gather joins given per-rank parts."""

    def __init__(self, parts):
        self.parts = parts

    def all_gather(self, x, axes, dim):
        return torch.cat(self.parts, dim)


def test_gather_cols_takes_each_column_once():
    """``sharding.gather_cols`` rebuilds the whole dim from ranks whose
    columns overlap (an SSD conv tail's shared B/C, case (b)'s repeated KV
    head): each whole column from the first rank holding it, in the
    whole's order; ``take_cols`` is its inverse on each rank; columns that
    leave a gap raise."""
    from repro_torch.distributed import sharding as sh
    whole = torch.arange(2 * 7, dtype=torch.float32).reshape(2, 7)
    per = [[0, 1, 5, 6], [2, 3, 4, 5, 6]]
    parts = [sh.take_cols(whole, 1, c) for c in per]
    got = sh.gather_cols(_GatherComm(parts), parts[0], ("model",), 1, per)
    assert torch.equal(got, whole)
    with pytest.raises(ValueError, match="do not cover"):
        sh.gather_cols(_GatherComm(parts), parts[0], ("model",), 1,
                       [[0, 1], [3]])
