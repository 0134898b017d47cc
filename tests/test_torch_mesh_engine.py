"""The port's mesh-sharded serving path: ``InferenceEngine(mesh=...)``,
``transformer.shard_params`` and the gateway on a mesh.

* On the (1, 1) mesh, in process (a gloo world of one): cold ``generate``,
  ``absorb`` then a warm continuation, a decode-only extension,
  ``state_select`` and ``serve()`` are BITWISE the single-device port
  engine (tokens, logits, u, h/v means) on the ``smollm-135m``,
  ``swarm-edge-1b``, ``qwen1.5-110b`` (QKV bias) and ``llama3-8b`` smokes,
  and tie-aware equal to the JAX engine within the reference's budget.
* Multi-rank (one subprocess, ``tests/torch_mesh_ranks.py``): 4 gloo ranks
  over a ``FileStore`` on meshes (data=2, model=2), (1, 4) and (4, 1) —
  attention cases (a), (b) and (s) of ``shard_params`` (the smollm smoke's
  H3/K1 takes the sequence-sharded cache at model=2 and 4) — against the
  single-device engine: tokens tie-aware (logits within 0.01 before a
  flip), ``u`` within 1e-4 on f32 copies, ``serve()`` with 2 slots over
  data=4 (the batch replicated) and 4 slots, each rank's shapes (weights
  and KV caches) the full ones divided as the specs say; then the gateway
  on a (data=1, model=2) mesh: the same routing decisions and tokens as
  the single-device one.
* The sequence-sharded cache and the vocabulary-parallel probe
  (``torch_mesh_ranks.py seq2`` and ``seq4`` on the JAX package's
  weights): H6/K3 on (2, 2) at 128 and 31 slots (routes (s) and (w)), the
  smollm smoke on (1, 2) and (1, 4), greedy and sampled, the
  recurrentgemma smoke at H6/K1 on (1, 4) with a wrapped ring, sessions
  saved on those layouts restored on one device, (2, 1), (1, 4) and
  (2, 2) — against one device in the ranks, and their cold generates
  against the JAX engine on one device here (its own mesh path fails
  under jax 0.9.0).
* Paged pools, quantized weights and pools and session checkpoints build
  and run on the (1, 1) mesh here (``tests/test_torch_mesh_paged.py``
  holds them to one device and to JAX), and so do the recurrent and MoE
  decoders (``tests/test_torch_mesh_mixers.py`` holds them); what the mesh
  path does not serve yet raises ``NotImplementedError`` naming it (the
  training rules' head counts that only the sequence-sharded cache
  serves, graph capture over more than one rank); a mesh that is not a
  ``DeviceMesh`` raises ``TypeError``.
* The serve CLI with ``--model-parallel 2 --paged --cache-quant int8`` on
  two gloo ranks routes the study workload as one device does.
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

from repro_torch import configs as TC
from repro_torch.launch.mesh import serving_mesh
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.serving.scheduler import Request

from test_torch_engine import (PROMPTS, _engines, _logits_np,
                               assert_greedy_match_modulo_ties)

jax = pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
TIERS = ("smollm-135m", "swarm-edge-1b", "qwen1.5-110b", "llama3-8b")
SPAN = np.array([[11, 12, 2], [13, 2, 0], [14, 15, 16], [17, 2, 0]],
                np.int32)


@pytest.fixture(scope="module")
def mesh11():
    return serving_mesh(device="cpu")


@pytest.fixture(scope="module", params=TIERS)
def tier(request, mesh11):
    je, te = _engines(request.param, "distribution")
    me = TEngine(request.param, te.cfg, te.params, te.ucfg, device="cpu",
                 mesh=mesh11)
    return je, te, me


def _bitwise(a, b, what):
    np.testing.assert_array_equal(a["tokens"], b["tokens"], err_msg=what)
    assert torch.equal(a["logits"], b["logits"]), what
    for k in ("u", "h_mean", "v_mean"):
        if k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def test_degenerate_mesh_is_bitwise_single_device(tier):
    _, te, me = tier
    r0 = te.generate(PROMPTS, 8, return_state=True)
    r1 = me.generate(PROMPTS, 8, return_state=True)
    _bitwise(r1, r0, "cold generate")
    e0 = te.generate(None, 5, state=r0["state"], return_state=True)
    e1 = me.generate(None, 5, state=r1["state"], return_state=True)
    _bitwise(e1, e0, "decode-only extension")
    s0 = te.generate(None, 4, state=te.state_select(e0["state"], [3, 0, 0]))
    s1 = me.generate(None, 4, state=me.state_select(e1["state"], [3, 0, 0]))
    _bitwise(s1, s0, "state_select")
    w0 = te.generate(SPAN, 6, state=te.absorb(PROMPTS))
    w1 = me.generate(SPAN, 6, state=me.absorb(PROMPTS))
    _bitwise(w1, w0, "absorb + warm continuation")
    reqs = [Request(rid=i, prompt=PROMPTS[i].tolist(), max_new=8)
            for i in range(len(PROMPTS))]
    f0 = {r["rid"]: r for r in te.serve(reqs, n_slots=2, decode_chunk=3)}
    reqs = [Request(rid=i, prompt=PROMPTS[i].tolist(), max_new=8)
            for i in range(len(PROMPTS))]
    f1 = {r["rid"]: r for r in me.serve(reqs, n_slots=2, decode_chunk=3)}
    for i in f0:
        np.testing.assert_array_equal(f1[i]["tokens"], f0[i]["tokens"])
        assert f1[i]["u"] == f0[i]["u"]
    # nothing crossed the mesh, and nothing was cut
    assert me.comm.stats["all_reduce"] == me.comm.stats["all_gather"] == 0
    assert me.counters["mesh_eager"] == 0
    assert me._mcfg == me.cfg
    full = dict(te.params.named_parameters())
    assert all(p is full[n] for n, p in me.params.named_parameters())
    # and nothing would: no module of the shard carries a Split
    assert not any(hasattr(m, "tp") for m in me.params.modules())


def test_degenerate_mesh_matches_jax_tie_aware(tier):
    je, _, me = tier
    assert_greedy_match_modulo_ties(_logits_np(me.generate(PROMPTS, 8)),
                                    _logits_np(je.generate(PROMPTS, 8)))


def _ranks(job: str, *args, timeout: int = 300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "tests" /
                                               "torch_mesh_ranks.py"), job,
                           *map(str, args)],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    assert "RESULT ok" in proc.stdout, proc.stdout
    return proc.stdout


def test_four_ranks_match_single_device():
    out = _ranks("engines")
    for shape in ("{'data': 2, 'model': 2}", "{'data': 1, 'model': 4}",
                  "{'data': 4, 'model': 1}"):
        assert f"mesh {shape} ok" in out, out
    assert "refusals ok" in out, out


def test_gateway_on_a_model_parallel_mesh():
    out = _ranks("gateway")
    assert "gateway decisions" in out, out


@pytest.mark.parametrize("kw", [
    dict(paged=True), dict(paged=True, cache_quant="int8"),
    dict(weight_quant="int8")],
    ids=["paged", "cache_quant", "weight_quant"])
def test_unported_mesh_paths_raise(mesh11, kw):
    """Paged pools and quantized weights and pools are served on a mesh
    (the engine builds and generates), an MoE model's too; the
    full-sequence dispatch of the engine's MoE shard, once refused (MoE
    training on a mesh), gives the one device's loss (``loss_fn`` on the
    shard; quantized weights read as the engine serves them)."""
    tc = dataclasses.replace(TC.get_smoke("llama3-8b"), vocab_size=512)
    eng = TEngine("x", tc, TT.Transformer(tc), device="cpu", mesh=mesh11,
                  **kw)
    assert eng.generate(PROMPTS, 2)["tokens"].shape == (len(PROMPTS), 2)
    mc = dataclasses.replace(TC.get_smoke("deepseek-moe-16b"),
                             vocab_size=512)
    w = TT.init_params(mc, torch.Generator().manual_seed(0), device="cpu")
    moe = TEngine("x", mc, w, device="cpu", mesh=mesh11, **kw)
    assert moe.generate(PROMPTS, 2)["tokens"].shape == (len(PROMPTS), 2)
    tokens = torch.as_tensor(PROMPTS)
    batch = {"tokens": tokens, "labels": tokens}
    base = TEngine("x", mc, w, device="cpu", **kw)
    loss, met = TT.loss_fn(moe.params, moe._mcfg, batch)
    one, one_met = TT.loss_fn(base.params, base._mcfg, batch)
    assert torch.isfinite(loss) and torch.equal(loss, one)
    assert all(torch.equal(met[k], one_met[k]) for k in met)


@pytest.mark.parametrize("arch,what", [
    ("recurrentgemma-2b", "rglru"), ("mamba2-780m", "ssd"),
    ("deepseek-moe-16b", "moe"), ("llama4-scout-17b-a16e", "moe")])
def test_other_mixers_on_a_mesh_raise(mesh11, arch, what):
    """The recurrent and MoE decoders, which the mesh path once refused,
    build and generate on the (1, 1) mesh: their layer plans hold the
    ``what`` kind, the engine's shard is the whole model and its tokens
    one device's (``tests/test_torch_mesh_mixers.py`` holds them to one
    device bitwise and across ranks)."""
    tc = dataclasses.replace(TC.get_smoke(arch), vocab_size=512)
    assert what in {k for kind in tc.layer_plan() for k in kind}
    m = TT.init_params(tc, torch.Generator().manual_seed(1), device="cpu")
    eng = TEngine("x", tc, m, device="cpu", mesh=mesh11)
    one = TEngine("x", tc, m, device="cpu")
    got = eng.generate(PROMPTS, 3)
    assert got["tokens"].shape == (len(PROMPTS), 3)
    np.testing.assert_array_equal(got["tokens"],
                                  one.generate(PROMPTS, 3)["tokens"])
    assert eng._mcfg == tc


def test_session_checkpoints_on_a_mesh_raise(mesh11, tmp_path):
    """A session checkpoint round-trips on the mesh (bitwise on one
    layout); restoring it where the cache representation differs raises
    ``QuantMismatchError``, as off a mesh; a mesh that is not a
    ``DeviceMesh`` raises ``TypeError``."""
    from repro_torch.serving.cache_manager import QuantMismatchError
    tc = dataclasses.replace(TC.get_smoke("llama3-8b"), vocab_size=512)
    model = TT.init_params(tc, torch.Generator().manual_seed(2),
                           device="cpu")
    eng = TEngine("x", tc, model, device="cpu", mesh=mesh11)
    st = eng.absorb(PROMPTS[:1])
    eng.checkpoint_session(st, str(tmp_path))
    ref = eng.generate(None, 4, state=st)
    got = eng.generate(None, 4, state=eng.restore_session(str(tmp_path)))
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    assert torch.equal(got["logits"], ref["logits"])
    q = TEngine("x", tc, model, device="cpu", mesh=mesh11, paged=True,
                cache_quant="int8")
    with pytest.raises(QuantMismatchError):
        q.restore_session(str(tmp_path))
    with pytest.raises(TypeError, match="DeviceMesh"):
        TEngine("x", tc, TT.Transformer(tc), device="cpu", mesh=object())


def test_serve_cli_paged_int8_on_two_ranks():
    """``python -m repro_torch.launch.serve --device cpu --model-parallel 2
    --paged --cache-quant int8`` (40 train steps) on two gloo ranks: the
    routing decisions and answers of the same command on one device."""
    assert "cli routes" in _ranks("cli", timeout=600)


def _seq_weights(path: Path) -> dict:
    """{name: (JAX config, JAX params)} of ``torch_mesh_ranks.SEQ``'s
    smokes in f32 at vocabulary 512 (a recurrent smoke's matrices but the
    embedding and the convs scaled by 6, as ``mixer_model`` scales them),
    each converted into ``path``/<name>.pt for the ranks."""
    import jax.numpy as jnp
    from repro import configs as C
    from repro.models import transformer as JT
    from repro_torch.convert import from_jax_params
    from torch_mesh_ranks import SEQ, seq_config
    out = {}
    for i, (name, (arch, heads)) in enumerate(SEQ.items()):
        jc = dataclasses.replace(C.get_smoke(arch), vocab_size=512,
                                 dtype=jnp.float32,
                                 attn_prefill_impl="flash", **heads)
        p = jax.jit(JT.init_params, static_argnums=0)(
            jc, jax.random.PRNGKey(20 + i))
        if arch == "recurrentgemma-2b":
            def scale(path, a):
                key = jax.tree_util.keystr(path)
                big = a.ndim >= 2 and "embed" not in key and "conv" not in key
                return a * 6 if big else a
            p = jax.tree_util.tree_map_with_path(scale, p)
        tc = seq_config(name, torch.float32)
        torch.save(from_jax_params(jax.tree.map(np.asarray, p),
                                   tc).state_dict(), path / f"{name}.pt")
        out[name] = (jc, p)
    return out


def test_sequence_sharded_cache_matches_one_device_and_jax(tmp_path):
    """The ``seq2`` then ``seq4`` rank jobs (2 and 4 gloo ranks) on the
    JAX package's weights; every mesh generate they wrote (f32, tokens
    and logits, ``u``, h and v means) against the JAX engine's on one
    device: tokens tie-aware with logits within 1e-4 before a flip, h
    within 1e-4 and v within 5e-3."""
    from repro.core.uncertainty import UncertaintyConfig as JU
    from repro.serving.engine import InferenceEngine as JEngine
    pairs = _seq_weights(tmp_path)
    out2 = _ranks("seq2", tmp_path, timeout=400)
    out4 = _ranks("seq4", tmp_path, timeout=600)
    for want in ("seq smollm 1x2", "ckpt smollm12 ok"):
        assert want in out2, out2
    for want in ("seq odd 2x2 {} T=128 cut=2/2", "seq odd 2x2 {'max_len': 31}"
                 " T=31 cut=0/2", "seq odd 2x2 paged ok", "seq smollm 1x4",
                 "seq rg 1x4",
                 "ckpt rg14 ok", "ckpt odd22 ok",
                 "ckpt smollm12 -> (1,4) ok"):
        assert want in out4, out4
    files = sorted(tmp_path.glob("out_*.npz"))
    assert len(files) == 5, files
    for f in files:
        name = f.stem.split("_")[1]
        jc, p = pairs[name]
        with np.load(f) as z:
            got = dict(z)
        max_new = got["tokens"].shape[1]
        ref = JEngine(name, jc, p, JU(mode="distribution")).generate(
            PROMPTS, max_new)
        assert_greedy_match_modulo_ties(
            got, {"tokens": np.asarray(ref["tokens"]),
                  "logits": np.asarray(ref["logits"], np.float32)},
            atol=1e-4)
        same = np.all(got["tokens"] == np.asarray(ref["tokens"]), axis=1)
        np.testing.assert_allclose(got["h"][same],
                                   np.asarray(ref["h_mean"])[same],
                                   atol=1e-4, rtol=0, err_msg=f.name)
        np.testing.assert_allclose(got["v"][same],
                                   np.asarray(ref["v_mean"])[same],
                                   atol=5e-3, rtol=0, err_msg=f.name)
