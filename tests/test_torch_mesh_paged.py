"""The paged block pool, quantized weights and pools, and session
checkpoints on a mesh: ``InferenceEngine(mesh=..., paged=True)``,
``cache_quant`` and ``weight_quant`` there, ``checkpoint_session`` /
``restore_session`` across layouts.

* On the (1, 1) mesh, in process (a gloo world of one), for each of the
  gateway's tiers (``smollm-135m``, ``swarm-edge-1b``, ``qwen1.5-110b``,
  ``llama3-8b`` smokes) and each layout (paged ``"kernel"`` and
  ``"gather"``, int8 and fp8 pools, int8 weights monolithic and fp8
  weights paged): cold ``generate``, ``absorb`` + a warm continuation, a
  decode-only extension, ``state_select``, ``fanout`` and ``serve()`` are
  BITWISE the single-device port engine, with the graph layer's CPU
  backend as without it (one replay per ``generate``); and tie-aware
  equal to the JAX single-device engine of the same layout within the
  reference's budgets (0.01 in bf16, 0.02 for a quantized pool).
* Multi-rank (``tests/torch_mesh_ranks.py``, each job a subprocess under
  its own timeout: a hang fails it, it does not stall the suite): 4 gloo
  ranks on (2, 2), (1, 4), (4, 1) and a (pod, data, model) (2, 2, 1)
  mesh through the same entry points, tie-aware against one device, each rank's pool, tables and ``QTensor``
  payload the full ones divided as the specs say and bitwise the slices of
  the whole quantized tree (``paged``); two data ranks whose pools differ
  raise, defer and evict together (``lockstep``); sessions saved on one
  layout restore on another (``ckpt``); the int8-pool gateway on (1, 2)
  decides as one device does (``paged_gateway``).
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

from repro_torch.launch.mesh import serving_mesh
from repro_torch.core.uncertainty import UncertaintyConfig as TU
from repro_torch.serving import graphs
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.serving.scheduler import Request

from test_torch_engine import PROMPTS, assert_greedy_match_modulo_ties
from torch_mesh_ranks import SPAN, ckpt_reference, model, tie_aware

ROOT = Path(__file__).resolve().parents[1]
TIERS = ("smollm-135m", "swarm-edge-1b", "qwen1.5-110b", "llama3-8b")
PAGED = dict(paged=True, block_len=8, pool_blocks=256, pool_rows=32)
LAYOUTS = {"kernel": PAGED,
           "gather": dict(PAGED, attn_decode_impl="gather"),
           "cache-int8": dict(PAGED, cache_quant="int8"),
           "cache-fp8": dict(PAGED, cache_quant="fp8"),
           "weight-int8": dict(weight_quant="int8"),
           "weight-fp8": dict(PAGED, weight_quant="fp8")}
UC = dict(mode="distribution")


@pytest.fixture(scope="module")
def mesh11():
    return serving_mesh(device="cpu")


def _bitwise(a, b, what):
    np.testing.assert_array_equal(a["tokens"], b["tokens"], err_msg=what)
    assert torch.equal(a["logits"], b["logits"]), what
    for k in ("u", "h_mean", "v_mean"):
        if k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def _run(eng) -> list:
    """Every entry point on ``eng``, in one order: results to compare."""
    out = []
    r = eng.generate(PROMPTS, 6, return_state=True)
    out.append(r)
    e = eng.generate(None, 4, state=r["state"], return_state=True)
    out.append(e)
    out.append(eng.generate(None, 3, state=eng.state_select(
        e["state"], [3, 0, 0])))
    out.append(eng.generate(SPAN, 5, state=eng.absorb(PROMPTS)))
    if eng.paged:
        one = eng.generate(PROMPTS[1:2], 3, return_state=True)
        out.append(eng.generate(None, 3, state=eng.fanout(one["state"], 3)))
    fin = eng.serve([Request(rid=i, prompt=PROMPTS[i].tolist(), max_new=5,
                             return_state=(i == 2)) for i in range(4)],
                    n_slots=2, decode_chunk=2)
    fin = {f["rid"]: f for f in fin}
    out.append({"tokens": np.stack([fin[i]["tokens"] for i in range(4)]),
                "logits": torch.zeros(()),
                "u": np.array([fin[i]["u"] for i in range(4)])})
    out.append(eng.generate(None, 3, state=fin[2]["state"]))
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", TIERS)
def test_degenerate_mesh_is_bitwise_single_device(mesh11, arch, layout):
    """The (1, 1) mesh is the single-device engine: every entry point
    bitwise, nothing crosses the mesh, the pool and the quantized weights
    are the single-device ones, and with the graph layer (its CPU backend)
    each generate is one replay, as on one device."""
    cfg, m = model(arch, torch.bfloat16, 1)
    kw = LAYOUTS[layout]
    one = TEngine(arch, cfg, m, TU(**UC), device="cpu", **kw)
    me = TEngine(arch, cfg, m, TU(**UC), device="cpu", mesh=mesh11, **kw)
    for a, b in zip(_run(me), _run(one)):
        _bitwise(a, b, f"{arch} {layout}")
    assert me.comm.stats["all_reduce"] == me.comm.stats["all_gather"] == 0
    assert me.comm.stats["agree"] == me.comm.stats["barrier"] == 0
    assert me.counters == one.counters
    assert me.weight_bytes() == one.weight_bytes()
    if me.paged:
        assert me.pool.n_blocks == one.pool.n_blocks == kw["pool_blocks"]
        assert me.pool.counters == one.pool.counters
    for eng in (one, me):
        eng._graphs = graphs.DecodeGraphs(graphs.Rerun())
    r0, r1 = one.generate(PROMPTS, 4), me.generate(PROMPTS, 4)
    _bitwise(r1, r0, f"{arch} {layout} graphed")
    counts = [{k: e._graphs.stats[k] for k in ("captures", "replays")}
              for e in (one, me)]
    assert counts[0] == counts[1] == {"captures": 1, "replays": 1}, counts


@pytest.fixture(scope="module")
def jax_weights():
    """(JAX config, port config, JAX params, port model) of the
    ``llama3-8b`` smoke in bf16 at vocabulary 512, from one draw."""
    jax = pytest.importorskip("jax")
    from repro import configs as C
    from repro.models import transformer as JT
    from repro_torch import configs as TC
    from repro_torch.convert import from_jax_params
    jc = dataclasses.replace(C.get_smoke("llama3-8b"), vocab_size=512)
    tc = dataclasses.replace(TC.get_smoke("llama3-8b"), vocab_size=512)
    p = jax.jit(JT.init_params, static_argnums=0)(jc, jax.random.PRNGKey(0))
    return jc, tc, p, from_jax_params(jax.tree.map(np.asarray, p), tc)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_degenerate_mesh_matches_jax_tie_aware(mesh11, jax_weights, layout):
    """Against the JAX single-device engine of the same layout, cold and
    warm: tokens tie-aware, logits within the reference's budget (0.01 in
    bf16; 0.02 for a quantized pool, ``TestQuantizedPools``)."""
    from repro.core.uncertainty import UncertaintyConfig as JU
    from repro.serving.engine import InferenceEngine as JEngine
    jc, tc, p, m = jax_weights
    kw = LAYOUTS[layout]
    atol = 0.02 if kw.get("cache_quant") else 0.01
    je = JEngine("j", jc, p, JU(**UC), **kw)
    me = TEngine("t", tc, m, TU(**UC), device="cpu", mesh=mesh11, **kw)

    def np_(res):
        return {**res, "logits": np.asarray(res["logits"], np.float32)
                if not isinstance(res["logits"], torch.Tensor)
                else res["logits"].float().numpy()}
    assert_greedy_match_modulo_ties(np_(me.generate(PROMPTS, 6)),
                                    np_(je.generate(PROMPTS, 6)), atol=atol)
    assert_greedy_match_modulo_ties(
        np_(me.generate(SPAN, 4, state=me.absorb(PROMPTS))),
        np_(je.generate(SPAN, 4, state=je.absorb(PROMPTS))), atol=atol)


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


def test_four_ranks_paged_and_quantized_match_single_device():
    out = _ranks("paged")
    for shape in ("{'data': 2, 'model': 2}", "{'data': 1, 'model': 4}",
                  "{'data': 4, 'model': 1}",
                  "{'pod': 2, 'data': 2, 'model': 1}"):
        assert f"paged mesh {shape} ok" in out, out


def test_pool_decisions_are_taken_in_lockstep():
    assert "lockstep ok" in _ranks("lockstep", timeout=120)


def test_paged_int8_gateway_on_a_model_parallel_mesh():
    assert "paged gateway decisions" in _ranks("paged_gateway")


def test_sessions_restore_across_meshes(mesh11, tmp_path):
    """Saved on (2, 2) paged (four ranks), restored here on the (1, 1)
    mesh, paged and monolithic, and on one device: tie-aware the (2, 2)
    run's uninterrupted continuation of the same session.  Saved and
    restored on the
    (1, 1) mesh, and saved there and restored on one device (the same
    engine), bitwise."""
    assert "ckpt ok" in _ranks("ckpt", tmp_path)
    cfg, m, r0, c0 = ckpt_reference()
    d22 = str(tmp_path / "mesh22")
    z = np.load(tmp_path / "c22.npz")
    c22 = {"tokens": z["tokens"], "logits": torch.from_numpy(z["logits"])}
    for kw in (dict(mesh=mesh11), dict(mesh=mesh11, **PAGED), {}):
        e = TEngine("e", cfg, m, TU(**UC), device="cpu", **kw)
        x = e.generate(None, 5, state=e.restore_session(d22))
        tie_aware(x, c22, f"(2,2) -> {kw}")
    me = TEngine("e", cfg, m, TU(**UC), device="cpu", mesh=mesh11, **PAGED)
    r = me.generate(PROMPTS, 6, return_state=True)
    me.checkpoint_session(r["state"], str(tmp_path / "mesh11"))
    c11 = me.generate(None, 5, state=r["state"])
    _bitwise(c11, c0, "(1,1) uninterrupted")
    for kw in (dict(mesh=mesh11, **PAGED), PAGED):
        e = TEngine("e", cfg, m, TU(**UC), device="cpu", **kw)
        x = e.generate(None, 5, state=e.restore_session(
            str(tmp_path / "mesh11")))
        _bitwise(x, c11, f"(1,1) -> {kw}")
